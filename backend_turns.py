"""Time the "kernel" and "tree" gradient backends in turns on one NVIDIA GPU.

    python3 backend_turns.py [OUT.jsonl]

For "vpu" models at S != 4 (kernels 1m in fp32 mode + 3m once per node,
against kernels 2m + 4m once per step) over a grid of alignments: LG +
Gamma4 protein models at 16, 64 and 256 taxa and GY94 + Gamma4 codon
models at 16, 32 and 128 taxa, each from 1,500 to 131,072 (65,536 codon)
random site patterns.  A shape whose per-node residuals (the "kernel"
backend's ``3 * E * S*C * n_pad * 4`` bytes) exceed half the card's
memory is left out: "auto" never takes "kernel" there.  Each shape prints
one JSON line: the median wall time of a value-and-gradient step
(``tree_loglik_fn``, the device synchronised around each step; 5 steps
after one warm-up) in turns kernel, tree, tree, kernel, and the backend
"auto" takes.  The lines also go to OUT.jsonl when it is given.  The
rule in ``plf_tpu_torch/models/optimize.py::_kernel_wins`` is read from
these lines.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from plf_tpu_torch import PLFConfig
from plf_tpu_torch.models import (PhyloModel, codon_gy94, empirical_protein,
                                  random_tree, tree_loglik_fn)
from plf_tpu_torch.ops._build import build_libraries

PROTEIN = [(t, n) for t in (16, 64, 256)
           for n in (1500, 4096, 16384, 65536, 131072)]
CODON = [(t, n) for t in (16, 32, 128) for n in (1500, 4096, 16384, 65536)]


def step_ms(fn, t0, reps=5):
    """Median wall time in ms of ``reps`` value-and-gradient steps."""
    times = []
    for _ in range(reps):
        t = torch.tensor(t0, device="cuda", requires_grad=True)
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn(t).backward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return float(np.median(times))


def tips_of(states, taxa, sites, seed):
    rng = np.random.default_rng(seed)
    if states == 20:         # amino acids, gaps and the B/Z/J codes
        p = np.concatenate([[0.04], np.full(20, 0.0475), np.full(3, 0.01)])
        return rng.choice(np.arange(-1, 23, dtype=np.int8),
                          size=(taxa, sites), p=p / p.sum())
    tips = rng.integers(0, 61, size=(taxa, sites))
    tips[rng.random(tips.shape) < 0.02] = 61          # 2% gap codons
    return tips


def main():
    assert torch.cuda.is_available(), "needs an NVIDIA GPU"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build_libraries(["plf_node_mxu", "plf_node_bwd_mxu", "plf_tree_mxu",
                     "plf_tree_bwd_mxu"])
    out = open(sys.argv[1], "w") if len(sys.argv) > 1 else None
    total = torch.cuda.get_device_properties(0).total_memory
    models = {20: (empirical_protein("lg"), 0.5),
              61: (codon_gy94(kappa=2.0, omega=0.3), 0.7)}
    for states, grid in ((20, PROTEIN), (61, CODON)):
        model, alpha = models[states]
        for taxa, sites in grid:
            resid = 3 * (taxa - 1) * states * 4 * sites * 4
            if resid > total // 2:
                continue
            pm = PhyloModel(random_tree(taxa, seed=1), model,
                            tips_of(states, taxa, sites, taxa + sites),
                            alpha=alpha, device="cuda",
                            config=PLFConfig(states=states,
                                             kernel_variant="vpu"))
            fns = {b: tree_loglik_fn(pm, backend=b)
                   for b in ("kernel", "tree")}
            ms = {b: [] for b in fns}
            for b in fns:
                step_ms(*fns[b], reps=1)                     # warm-up
            for b in ("kernel", "tree", "tree", "kernel"):
                ms[b].append(step_ms(*fns[b]))
            row = dict(states=states, taxa=taxa, sites=sites,
                       n_pad=pm.n_pad, nodes=len(pm.schedule),
                       resid_gb=3 * len(pm.schedule) * pm.config.rows
                       * pm.n_pad * 4 / 1e9,
                       kernel_ms=ms["kernel"], tree_ms=ms["tree"],
                       auto=tree_loglik_fn(pm)[0].engine)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            del pm, fns
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
