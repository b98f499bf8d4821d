"""Codon-model demo on the PyTorch/CUDA port: estimate dN/dS (omega) by
maximum likelihood.  Counterpart of ``examples/codon_dnds.py``.

The workflow codon models exist for: simulate an in-frame alignment
under GY94 with a known selection regime, estimate F3x4 frequencies
from the data, and recover omega/kappa on the 2-D profile likelihood
with the 61-state kernels (models/optimize.fit_codon) — the host-side
model step above the PLF the reference accelerates
(ref: app/src/plf.cpp:8-68 consumes the operators this fit produces).

    python examples/torch_codon_dnds.py [--taxa 8] [--codons 600] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from plf_tpu_torch.config import PLFConfig  # noqa: E402
from plf_tpu_torch.models import (codon_gy94, fit_codon,  # noqa: E402
                                  random_tree, simulate_alignment)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--taxa", type=int, default=8)
    ap.add_argument("--codons", type=int, default=600)
    ap.add_argument("--omega", type=float, default=0.2,
                    help="simulated dN/dS (purifying < 1 < positive)")
    ap.add_argument("--kappa", type=float, default=4.0)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the kernels) or "cpu" (their plain '
                         'versions)')
    args = ap.parse_args(argv)

    print(f"simulating {args.taxa} taxa x {args.codons} codons under "
          f"GY94(kappa={args.kappa}, omega={args.omega})")
    tree = random_tree(args.taxa, seed=5, mean_branch=0.2)
    m_true = codon_gy94(args.kappa, args.omega)
    tips = simulate_alignment(tree, m_true, args.codons, seed=3)

    cfg = PLFConfig(states=61, block_sites=128,
                    kernel_variant="auto")   # auto -> mxu_3x at S=61
    model, info = fit_codon(tree, tips, config=cfg, rounds=2, iters=8,
                            length_steps=30, verbose=True,
                            device=args.device)
    print(f"\nfitted: kappa={info['kappa']:.3f} "
          f"omega={info['omega']:.4f} (true {args.kappa}/{args.omega}) "
          f"ll={info['ll']:.3f}")
    regime = ("purifying selection" if info["omega"] < 0.8
              else "neutral/positive")
    print(f"inference: {regime} (omega "
          f"{'<' if info['omega'] < 1 else '>='} 1)")
    return info


if __name__ == "__main__":
    main()
