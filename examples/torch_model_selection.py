"""Model selection demo on the PyTorch/CUDA port: simulate under HKY+G,
recover it by AICc.  Counterpart of ``examples/model_selection.py``.

The ModelTest step production users run before any PLF workload
(models/selection.py): every candidate is fitted with the device-side
optimisers and ranked by information criterion, then the winner drives
the usual inference.

    python examples/torch_model_selection.py [--taxa 8] [--sites 2000] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from plf_tpu_torch.config import PLFConfig  # noqa: E402
from plf_tpu_torch.io.alignment import compress_patterns  # noqa: E402
from plf_tpu_torch.models import (hky85, model_select,  # noqa: E402
                                  random_tree, simulate_alignment)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--taxa", type=int, default=8)
    ap.add_argument("--sites", type=int, default=2000)
    ap.add_argument("--criterion", default="AICc",
                    choices=["AIC", "AICc", "BIC"])
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the kernels) or "cpu" (their plain '
                         'versions)')
    args = ap.parse_args(argv)

    true_tree = random_tree(args.taxa, seed=7)
    true_model = hky85(6.0, np.array([0.3, 0.2, 0.3, 0.2]))
    aln = simulate_alignment(true_tree, true_model, args.sites,
                             alpha=0.6, seed=11)
    patterns, wgt = compress_patterns(aln)
    print(f"simulated {args.taxa} taxa x {args.sites} sites under HKY+G "
          f"(kappa=6, alpha=0.6); {patterns.shape[1]} patterns")

    res = model_select(true_tree, patterns, wgt=wgt,
                       criterion=args.criterion,
                       config=PLFConfig(block_sites=128), verbose=True,
                       device=args.device)
    print()
    print(res.table())
    print(f"\nselected by {args.criterion}: {res.best.name} "
          f"(alpha={res.best.alpha})")
    return res


if __name__ == "__main__":
    main()
