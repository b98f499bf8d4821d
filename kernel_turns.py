"""Time kernel 4m of two checkouts in turns on one NVIDIA GPU.

    python3 kernel_turns.py PARENT_DIR CHANGE_DIR

Each directory is the root of a checkout (for the parent commit, unpack
``git archive <commit>`` into a directory that ``.gitignore`` lists, such
as ``build/``).  The script runs parent, change, change, parent, each in a
process of its own with that checkout's ``plf_tpu_torch`` (its kernels
built from its own sources into its own ``build/``), and prints one JSON
line per turn: kernel 4m's mean device time in ms (CUDA events around
three launches after one warm-up) on the protein workload of
``chip_smoke.py`` (64 taxa x 131,072 sites, LG + Gamma4, a step's
cotangent) in each matrix-form variant.  Compare two versions only within
one call: two calls may land on two cards.
"""

import json
import os
import subprocess
import sys

TURN = r'''
import json
import numpy as np
import torch
from plf_tpu_torch import PLFConfig
from plf_tpu_torch.models import PhyloModel, empirical_protein, random_tree
from plf_tpu_torch.ops import plf_tree as TT, plf_tree_grad as TG

assert torch.cuda.is_available(), "needs an NVIDIA GPU"
tree = random_tree(64, seed=1)
p = np.concatenate([[0.04], np.full(20, 0.0475), np.full(3, 0.01)])
tips = np.random.default_rng(64).choice(
    np.arange(-1, 23, dtype=np.int8), size=(64, 1 << 17), p=p / p.sum())
out = {}
for v in ("mxu", "mxu_3x", "mxu_bf16"):
    pm = PhyloModel(tree, empirical_protein("lg"), tips, alpha=0.5,
                    config=PLFConfig(states=20, kernel_variant=v))
    sched = TT.reorder_schedule(pm.schedule, 64)
    bs = torch.as_tensor(TG.backward_schedule(sched, 64), device="cuda")
    lik, _ = TT.plf_tree_mxu(
        pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
        pm.root_rows[0], pm.n_sites, n_slots=pm.n_slots,
        root_slot=pm.root_slot, states=20, categories=4, variant=v,
        planes=pm._planes())
    glik = torch.where(lik > 1.1754944e-38, pm.wgt_pad.float()[None] / lik,
                       0.0).contiguous()

    def bwd():
        TG.plf_tree_bwd_mxu(pm.codes, bs, pm.lcs, pm.rcs, pm.ec,
                            pm.fused_tip_table, pm.root_rows[0], glik,
                            pm.n_sites, states=20, categories=4, variant=v,
                            planes=pm._planes())

    bwd()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        bwd()
    stop.record()
    stop.synchronize()
    out[v] = start.elapsed_time(stop) / 3
print(json.dumps(out))
'''


def main():
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    dirs = {"parent": sys.argv[1], "change": sys.argv[2]}
    for name in ("parent", "change", "change", "parent"):
        root = os.path.abspath(dirs[name])
        run = subprocess.run([sys.executable, "-c", TURN], cwd=root,
                             env=dict(os.environ, PYTHONPATH=root),
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            sys.exit(f"{name} turn failed:\n{run.stderr[-3000:]}")
        print(json.dumps({"turn": name, "kernel4m_ms": json.loads(
            run.stdout.strip().splitlines()[-1])}), flush=True)


if __name__ == "__main__":
    main()
