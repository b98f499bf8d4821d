"""Time gradient backends in turns on one NVIDIA GPU.

    python3 backend_turns.py [--dna] [OUT.jsonl]

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

``--dna``: "segmented" (kernels 7 + 8) against "tree" (kernels 2 + 4) for
DNA "vpu" models (HKY85 kappa=2 + Gamma4 alpha=0.5, random codes with
gaps and IUPAC codes, as ``chip_smoke.py``'s tree workload) at 20, 64,
160 and 256 taxa x 4,096, 65,536 and 2^20 site patterns, in turns
segmented, tree, tree, segmented, with the backend "auto" takes and
whether kernel 4's checkpoint runs in chunks.  The rule in
``_segmented_wins`` is read from these lines.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from plf_tpu_torch import PLFConfig
from plf_tpu_torch.models import (PhyloModel, codon_gy94, empirical_protein,
                                  hky85, random_tree, tree_loglik_fn)
from plf_tpu_torch.ops._build import build_libraries
from plf_tpu_torch.ops.plf_tree_grad import plf_tree_bwd

PROTEIN = [(t, n) for t in (16, 64, 256)
           for n in (1500, 4096, 16384, 65536, 131072)]
CODON = [(t, n) for t in (16, 32, 128) for n in (1500, 4096, 16384, 65536)]
DNA = [(t, n) for t in (20, 64, 160, 256) for n in (4096, 65536, 1 << 20)]


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


def turns(pm, backends):
    """Medians of ``step_ms`` of each backend, in turns a, b, b, a."""
    fns = {b: tree_loglik_fn(pm, backend=b) for b in backends}
    ms = {b: [] for b in fns}
    for b in fns:
        step_ms(*fns[b], reps=1)                     # warm-up
    for b in backends + backends[::-1]:
        ms[b].append(step_ms(*fns[b]))
    return ms


def emit(row, out):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


def dna(out):
    """The --dna grid: "segmented" against "tree" for DNA models."""
    build_libraries(["plf_tree", "plf_tree_bwd", "plf_tree_seg",
                     "plf_tree_seg_bwd"])
    p = np.concatenate([[0.04], np.full(4, 0.22), np.full(10, 0.008)])
    for taxa, sites in DNA:
        tips = np.random.default_rng(taxa + sites).choice(
            np.arange(-1, 14, dtype=np.int8), size=(taxa, sites),
            p=p / p.sum())
        pm = PhyloModel(random_tree(taxa, seed=1), hky85(2.0), tips,
                        alpha=0.5, device="cuda")
        ms = turns(pm, ["segmented", "tree"])
        plan = pm._segmented_inputs()[0]
        emit(dict(taxa=taxa, sites=sites, n_pad=pm.n_pad,
                  nodes=len(pm.schedule), boundaries=plan.n_boundaries,
                  segmented_ms=ms["segmented"], tree_ms=ms["tree"],
                  kernel4_chunks=plf_tree_bwd.last_scratch["chunks"],
                  auto=tree_loglik_fn(pm)[0].engine), out)
        del pm
        torch.cuda.empty_cache()


def main():
    assert torch.cuda.is_available(), "needs an NVIDIA GPU"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    args = sys.argv[1:]
    if args[:1] == ["--dna"]:
        dna(open(args[1], "w") if len(args) > 1 else None)
        return
    build_libraries(["plf_node_mxu", "plf_node_bwd_mxu", "plf_tree_mxu",
                     "plf_tree_bwd_mxu"])
    out = open(args[0], "w") if args else None
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
            ms = turns(pm, ["kernel", "tree"])
            emit(dict(states=states, taxa=taxa, sites=sites,
                      n_pad=pm.n_pad, nodes=len(pm.schedule),
                      resid_gb=3 * len(pm.schedule) * pm.config.rows
                      * pm.n_pad * 4 / 1e9,
                      kernel_ms=ms["kernel"], tree_ms=ms["tree"],
                      auto=tree_loglik_fn(pm)[0].engine), out)
            del pm
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
