"""Full ML inference demo on the PyTorch/CUDA port: simulate, infer, and
compare to the truth.  Counterpart of ``examples/full_inference.py``.

Exercises the complete RAxML-shaped workflow on the card
(models/pipeline.run_inference): pattern compression, JC distances + NJ
starting tree, NNI topology search on the fused whole-tree kernel,
branch-length/alpha fitting, distance-bootstrap support, and SH-like aLRT
branch support.

    python examples/torch_full_inference.py [--taxa 12] [--sites 5000] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from plf_tpu_torch.models import (alrt_support, annotate_alrt,  # noqa: E402
                                  hky85, random_tree, rf_distance,
                                  run_inference, simulate_alignment)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--taxa", type=int, default=12)
    ap.add_argument("--sites", type=int, default=5000)
    ap.add_argument("--bootstrap", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the kernels) or "cpu" (their plain '
                         'versions)')
    args = ap.parse_args(argv)

    true_tree = random_tree(args.taxa, seed=7, mean_branch=0.1)
    model = hky85(2.0)
    codes = simulate_alignment(true_tree, model, args.sites, alpha=0.6,
                               seed=8)
    print(f"simulated {args.taxa} taxa x {args.sites} sites "
          f"(HKY85+G, true tree hidden)")

    res = run_inference(codes, names=true_tree.leaf_names(), model=model,
                        alpha=0.6, search="nni", fit="lengths+alpha",
                        bootstrap=args.bootstrap, progress=print,
                        device=args.device)
    rf = rf_distance(res.tree, true_tree)
    print(f"\ninferred ll = {res.log_likelihood:.3f}, "
          f"alpha = {res.alpha:.3f}, {res.elapsed_s:.1f}s")
    print(f"RF distance to true tree: {rf}")

    # SH-like branch support on the inferred topology.
    order = {nm: i for i, nm in enumerate(true_tree.leaf_names())}
    tips = codes[[order[nm] for nm in res.tree.leaf_names()]]
    sup = alrt_support(res.tree, model, tips, alpha=res.alpha,
                       rell_replicates=500, device=args.device)
    ann = annotate_alrt(res.tree, sup)
    print("\nSH-aLRT annotated tree:")
    print(ann.to_newick())
    return dict(result=res, rf=rf, support=sup, newick=ann.to_newick())


if __name__ == "__main__":
    main()
