"""End-to-end demo on the PyTorch/CUDA port: simulate -> compress ->
likelihood -> optimise.  Counterpart of ``examples/quickstart.py``.

Run on the card:  python examples/torch_quickstart.py               (1,000,000 sites)
Run on the CPU:   python examples/torch_quickstart.py --device cpu  (2,000 sites)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import torch  # noqa: E402

from plf_tpu_torch.config import PLFConfig  # noqa: E402
from plf_tpu_torch.io.alignment import compress_patterns  # noqa: E402
from plf_tpu_torch.models import (PhyloModel, hky85,  # noqa: E402
                                  optimize_branch_lengths, random_tree,
                                  simulate_alignment)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the kernels) or "cpu" (their plain '
                         'versions)')
    ap.add_argument("--tpu", action="store_true",
                    help="the accelerator sizes on any device (the card's "
                         "default; the flag of examples/quickstart.py)")
    ap.add_argument("--taxa", type=int, default=12)
    ap.add_argument("--sites", type=int, default=None)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    big = args.tpu or device.type == "cuda"
    sites = args.sites or (1_000_000 if big else 2_000)
    block = 4096 if big else 128

    print(f"backend={device.type}  taxa={args.taxa}  sites={sites}")

    # 1. simulate an alignment under HKY85 + gamma
    tree = random_tree(args.taxa, seed=42, mean_branch=0.15)
    model = hky85(kappa=2.5, pi=[0.30, 0.20, 0.25, 0.25])
    tips = simulate_alignment(tree, model, sites, alpha=0.7, seed=1)

    # 2. compress duplicate site patterns (the RAxML wgt mechanism)
    patterns, wgt = compress_patterns(tips)
    print(f"site patterns: {sites} sites -> {patterns.shape[1]} patterns")

    # 3. whole-tree likelihood on the fused kernel
    cfg = PLFConfig(block_sites=block)
    pm = PhyloModel(tree, model, patterns, wgt=wgt, alpha=0.7, config=cfg,
                    device=device)
    t0 = time.perf_counter()
    out = pm.log_likelihood()
    dt = time.perf_counter() - t0
    print(f"log-likelihood = {out.log_likelihood:.3f}  "
          f"(scalers={out.scaler_total}, {dt*1e3:.0f} ms incl. library "
          f"load)")

    # 4. optimise branch lengths on the device (gradients through the PLF)
    t_opt, ll0, ll1 = optimize_branch_lengths(pm, steps=40,
                                              learning_rate=0.05)
    print(f"branch-length optimisation: {ll0:.3f} -> {ll1:.3f} "
          f"(+{ll1 - ll0:.3f})")
    return dict(log_likelihood=out.log_likelihood,
                scaler_total=out.scaler_total, ll0=ll0, ll1=ll1,
                lengths=t_opt)


if __name__ == "__main__":
    main()
