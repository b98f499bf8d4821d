"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the thirteen CUDA kernels of ``plf_tpu_torch`` from
``plf_tpu_torch/csrc`` (into ``build/plf_tpu_torch/``, one nvcc per
source, all started together) and holds each against its plain PyTorch
version on the card (kernels 1 and 1m also against the numpy golden
model).  Then it drives the DNA main paths at 160 taxa x 2^20 site
patterns, HKY85 + Gamma4, fp32:

* serving: ``PhyloModel.log_likelihood`` (kernel 2; the per-node path,
  kernel 1), checked against each other and a float64 brute force;
* training: ``tree_loglik_fn`` value and gradient on the "tree" backend
  (kernels 2 + 4) and the "kernel" backend (kernels 1 + 3, once per
  node), checked against each other, the forward, and float64 central
  differences of the brute force; then ``optimize_branch_lengths`` and
  ``optimize_alpha``;

and the protein serving path at 64 taxa x 131,072 sites, LG + Gamma4:
``PhyloModel(...).log_likelihood()`` with the default config (on the card,
"mxu_3x": kernel 2m; the per-node path, kernel 1m), checked against each
other and a float64 brute force, and kernels 1m and 2m in each MXU variant
against their plain versions (kernel 1m also at its edge shapes: a
site past a tile, odd row lengths and ones not a multiple of 4 or 8,
S = 13 with C = 3 and S = 61, in place over either child; each launch's
plan printed).  Then the protein and
codon training path:

* kernel 4m (the checkpointed tree backward in the matrix forms) against
  its plain version in each variant on the protein workload and at S=61;
* protein training: ``tree_loglik_fn`` on the default protein model
  (kernels 2m + 4m, one launch each per step), checked against
  ``log_likelihood()``, the "mxu" model, float64 central differences of
  the brute force and the "torch" backend; ``optimize_branch_lengths``
  and ``optimize_alpha``;
* codons at 32 taxa x 65,536 codons, GY94 + Gamma4: fused vs per-node,
  one training step per variant, and ``fit_codon`` on a simulated
  alignment, which must recover the omega and kappa it was simulated
  under.

The segmented engine (DNA): kernel 7 on the model's carried program
(with its launch plan and the mean of 20 launches beside kernel 2's)
against its plain version and kernel 2 at 160 taxa x 2^20 and 512 x
262,144, kernel 8 against its plain
version at 160 x 2^20, ``log_likelihood(method="segmented")`` (kernel 7
once) and a "segmented" training step (kernels 7 + 8 once each) against
"tree", timed, with both backends' checkpoints, at 160 x 2^20 and 256 x
2^22 with int8 tips.

The segmented engine's matrix forms (protein and codon): kernel 7m
against kernel 2m and its plain version in each variant at 64 taxa x
131,072 sites, at S = 61 and at S = 4 (160 x 2^20; plain on 8,192 sites),
with its block (kernel 2m's job shape) and blocks per SM printed, kernel
8m against its plain version (and on
plans cut at three caps), ``log_likelihood(method="segmented")`` (kernel
7m once), "segmented" training steps (kernels 7m + 8m once each) against
"tree" at 64 x 131,072 and at 1,024 x 131,072 with int8 tips, where
kernel 4m's checkpoint runs in chunks, with the auto rule's choice there,
and a ``Backend.TORCH`` model on the card against the kernel path.

bf16 CLV storage (``PLFConfig(dtype="bfloat16")``, phase ``bf16``): each
bf16 storage form through its main path (``PLFEngine.plf`` for kernels 1
and 1m; ``log_likelihood(method="segmented")`` and a "segmented" step for
kernels 7 + 8 at 160 x 2^20 and 7m + 8m at 64 x 131,072) and against its
plain version bit for bit (kernel 1 at 2^24 sites, 1m at 2^21 and at its
edge shapes, S = 61 at 8,192 codons), its results against the fp32
model's within the JAX
package's bf16 classes, timed beside its fp32 form.

The last two kernels' paths: kernel 9, the compute-only probe, at
bench_gen's shape (phase ``kernel9``) and behind ``python -m plf_tpu_torch
--gen``; kernel 3m, the node backward at S != 4, against its plain version
(``kernel3s``) and through the "kernel" gradient backend on "vpu" twins of
the protein and codon models (``kernel_train``: one kernel-1m and one
kernel-3m launch per node, against "tree" and float64 differences, both
steps timed in turns, kernel 3m against its plain version on one node's
residuals at each model's own size); last ``cli`` runs ``python -m
plf_tpu_torch`` as a user does, in a subprocess that loads the libraries
built here: DNA at 2^24 sites (``--roundtrip`` at 2^21), 20 states at
2^21, ``--gen`` at S = 4 and 20, each checked exactly against the golden
oracle where it verifies.

The three axes (phases ``axes`` and ``sharded``, after ``analyses``):
``PLFEngine.plf_batch`` on 9 instances (the reference's
NUM_ACCELERATORS) of 2^20 DNA sites and of 2^18 sites at S = 20 in each
MXU variant, one launch of kernel 1 or 1m with an instance axis, each
instance == its own ``plf`` and the batched kernel == plain, timed beside
nine single launches; ``batch_log_likelihood_segmented`` on an NNI round
of 256 DNA taxa x 16,384 sites (kernel 7, fp32 and bf16 boundaries) and of
64 protein taxa x 4,096 ("mxu_3x", kernel 7m), one launch a chunk of
candidates under the boundary-buffer cap, every row == the single-tree
launch, fp32 rows == the batched fused kernel, lls within 1e-6 of
``log_likelihood(method="segmented")``; site sharding: README.md's
second route (``initialize_distributed("localhost:<port>", 2, r)``, no
torchrun environment) under NCCL, both ranks refused on the one card
within 30 s, a one-rank mesh == the unsharded paths, two ranks on the
one card in processes of their own joined by that route (NCCL if it
takes two ranks on one card, else gloo; rank 0 names "cuda:0", rank 1
passes "cuda", and every entry point resolves both to the card) on the
DNA and protein models and ``plf_sharded`` at 2^24 sites, README.md's
multi-card snippet under ``torchrun`` on NCCL (one rank == the unsharded
ll and gradient, on cuda:0; one rank more than the cards refused before
any group), and the whole-tree golden oracle == kernel 2 on 2^16 sites.

The last entry points (phase ``graft``, after ``sharded``):
``__graft_entry_torch__.py``'s ``entry()`` (kernel 1 == golden and
plain), its ``dryrun_multichip`` on one rank a card and on two gloo ranks
sharing the card (the JAX twin's ten checks, the ranks agreeing), and the
four ``examples/torch_*.py`` at their default sizes, each in a process of
its own, checked on what they print.

A profile phase breaks one ``log_likelihood()`` into its steps, traces the
fused and the per-node evaluation with ``torch.profiler`` (device time,
idle share, the top kernels) and times kernel 2 at the occupancy its
arena allows and at lower ones.  Prints one line per phase, a JSON line
with each kernel's launches, error, times and bound (the larger of its
bytes over the card's memory rate and its operations over the peak rate
of their type), and last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA device it fails at once and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from plf_tpu_torch import PLFConfig, PLFEngine
from plf_tpu_torch.config import Backend
from plf_tpu_torch.io.alignment import compress_patterns
from plf_tpu_torch.models import (SENSE_CODONS, PhyloModel, codon_gy94,
                                  empirical_protein, fit_codon, gtr, hky85,
                                  optimize_alpha, optimize_branch_lengths,
                                  parse_newick, random_tree, rf_distance,
                                  run_inference, simulate_alignment,
                                  tree_loglik_fn)
from plf_tpu_torch.models import phylo as phylo_mod, search as search_mod
from plf_tpu_torch.models.phylo import (LIK_FLOOR, batch_inputs,
                                        batch_log_likelihood)
from plf_tpu_torch.ops import layout as L
from plf_tpu_torch.ops import plf_grad, plf_mxu, plf_tree_grad
from plf_tpu_torch.ops import plf_node as node_mod, plf_tree as tree_mod
from plf_tpu_torch.ops._build import (BUILD_DIR, build_libraries,
                                      build_log, storage_library)
from plf_tpu_torch.ops.plf_grad import (plf_node_bwd, plf_node_bwd_torch,
                                        transpose_lane_constants)
from plf_tpu_torch.ops.plf_mxu import (node_mxu_plan, plf_node_mxu,
                                       plf_node_mxu_torch)
from plf_tpu_torch.ops.plf_node import (gen_flops, gen_plan, plf_node,
                                        plf_node_gen, plf_node_gen_torch,
                                        plf_node_torch)
from plf_tpu_torch.ops.plf_tree import (plf_tree, plf_tree_mxu,
                                        plf_tree_mxu_occupancy,
                                        plf_tree_occupancy, plf_tree_torch,
                                        reorder_schedule, TREE_MXU_SITES,
                                        tree_mxu_block, tree_plan)
from plf_tpu_torch.ops.plf_tree_grad import (backward_schedule,
                                             plf_tree_bwd,
                                             plf_tree_bwd_mxu,
                                             plf_tree_bwd_mxu_torch,
                                             plf_tree_bwd_torch,
                                             tree_bwd_scratch_bytes)
from plf_tpu_torch.ops import plf_tree_seg as seg_mod
from plf_tpu_torch.ops.plf_tree_seg import (plf_tree_seg, plf_tree_seg_bwd,
                                            plf_tree_seg_bwd_mxu,
                                            plf_tree_seg_bwd_torch,
                                            plf_tree_seg_mxu,
                                            plf_tree_seg_mxu_occupancy,
                                            plf_tree_seg_torch,
                                            segment_program,
                                            carry_segment_program,
                                            tree_seg_mxu_block)
from plf_tpu_torch.reference import plf_reference

N_TAXA = 160
TREE_SITES = 1 << 20          # site patterns of the whole-tree workload
NODE_SITES_GOLDEN = (1 << 20) - 37   # kernel 1 vs the numpy golden model
NODE_SITES_BIG = (1 << 24) - 123     # kernel 1 vs its plain version
BRUTE_SITES = 1 << 16         # sub-alignment for the float64 brute force
FD_SITES = 4096               # sub-alignment for the gradient's differences
UNIT = 128                    # site padding unit
#: Op-gradient site sums (kernels 3 and 4) against their plain versions:
#: within this share of the largest magnitude of each (S*C, S) matrix.
#: The sums run in another order (fp32, 10^3-10^6 terms), which moves them
#: by ~1e-6 of that scale; the per-site outputs are held bit for bit.
SUM_RTOL = 1e-4

# The protein workload (benchmarks/protein4.py:36-40: 64 taxa x 131,072
# sites, LG + Gamma4) and kernel 1m's shapes (r03_protein.csv: 2^21 sites).
PROT_TAXA = 64
PROT_SITES = 1 << 17
PROT_BRUTE_SITES = 4096
NODE_MXU_SITES = (1 << 21) - 77
NODE_MXU_GOLDEN = 1 << 16     # kernel 1m's fp32 mode vs the golden model
NODE_MXU_S61 = (1 << 18) - 5  # one S = 61 case at 244 rows
MXU_VARIANTS = ("mxu", "mxu_3x", "mxu_bf16")
#: Edge shapes of kernel 1m: (S, C, n, n_pad): n one site past a 32-site
#: tile; n_pad % 4 != 0, % 8 != 0 and odd (rows not 16- or 4-byte
#: aligned); S = 61 and S = 13 with C = 3 (five-row jobs).
NODE_MXU_EDGES = ((20, 4, 33, 128), (20, 4, 4001, 4002), (20, 4, 4001, 4001),
                  (61, 4, 33, 36), (61, 4, 3001, 3003), (13, 3, 4097, 4100),
                  (13, 3, 4097, 4099))
DNA_SEG_SLICE = 8192          # kernel 7m vs its plain version at S = 4

# The codon workload (benchmarks/r05_bwd2.py:103-116: 32 taxa x 65,536
# codons, GY94 kappa=2 omega=0.3 + Gamma4 alpha=0.7, random codes), kernel
# 4m's S = 61 shape, and fit_codon's simulated alignment (tests/
# test_codon.py:93-121 at 32 taxa x 4,096 codons).
CODON_TAXA = 32
CODON_SITES = 1 << 16
CODON_K4_SITES = 1 << 13
CODON_BRUTE_SITES = 1024
FIT_CODONS = 4096
#: The port's own distances on the first CODON_BRUTE_SITES codons of the
#: random-codon workload, from its plain versions on the CPU (elementwise
#: fp32 in the kernels' order, so the same on every machine): its "mxu" and
#: "mxu_3x" log_likelihood() from the float64 brute force, its "mxu_3x"
#: fused path from its per-node path, and its "tree" training value from
#: its "mxu" log_likelihood().  Random codons are improbable data whose
#: eigen-coordinate sums cancel below fp32 rounding, so the JAX package
#: lands this far from exact too, within a factor of two of these on every
#: CPU tried (tests/test_torch_codon.py::test_random_codon_witness
#: recomputes both); the card is held within twice these.
RANDOM_CODON_DISTANCES = dict(bf_mxu=3.027e-3, bf_mxu_3x=7.013e-2,
                              per_node_mxu_3x=2.654e-4, step=1.827e-3)

# The segmented engine's shapes (benchmarks/seg_bench.py:8-12, :130): the
# forward at 512 taxa x 262,144 sites, the gradient at 160 taxa x 2^20
# (the tree workload) and at 256 taxa x 2^22 with int8 tips.
SEG_FWD_TAXA, SEG_FWD_SITES = 512, 1 << 18
SEG_BIG_TAXA, SEG_BIG_SITES = 256, 1 << 22
#: Kernel 8's site sums against its plain version, and the "segmented"
#: gradient against the "tree" one: within this share of scale.
SEG_SUM_RTOL = 1e-6
SEG_GRAD_RTOL = 3e-6
#: The matrix forms (kernels 7m, 8m): kernel 8m's site sums against its
#: plain version, and a protein "segmented" step's gradient against the
#: "tree" step's, within these shares of scale; the big-tree protein step
#: at BIG_PROT_TAXA x PROT_SITES, where kernel 4m's checkpoint (43.0 GB)
#: runs in chunks.
SEG_MXU_SUM_RTOL = 3e-6
SEG_MXU_GRAD_RTOL = 1e-5
BIG_PROT_TAXA = 1024

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W
# power limit): each kernel's bound is the larger of its bytes over the
# memory rate and its operations over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12            # outside the tensor cores
BF16_FLOPS = 989e12           # tensor cores: bf16 products, fp32 sums


def bound(n_bytes, flops, rate):
    """The least time the card could take: bytes each read or written
    once over the memory rate, or operations over their peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def node_work(S, C, variant="vpu"):
    """(flops, peak rate) of one PLF node at one site: three stages of
    S*C rows x S multiply-adds (2 flops each) and the S*C products; the
    bf16x3 mode does each product three times, in bf16."""
    stages = 3 * 2 * S * S * C
    if variant == "mxu_3x":
        return 3 * stages, BF16_FLOPS
    if variant == "mxu_bf16":
        return stages, BF16_FLOPS
    return stages + S * C, FP32_FLOPS


def node_bwd_flops(S, C):
    """flops of one node's VJP at one site: the two stage-1 products and
    the stage-3 adjoint recomputed, the two stage-1 adjoints, three
    elementwise products, and the three operator gradients (S*C x S
    multiply-adds each)."""
    return 5 * 2 * S * S * C + 3 * S * C + 3 * 2 * S * S * C


def tree_bwd_work(S, C, E, variant="vpu"):
    """(flops, peak rate) of the whole-tree VJP (kernels 4 and 4m) at one
    site, counting what the function needs: the forward of every node;
    per node the stage-3 adjoint g_p, the two products g_u1 and g_u2 and
    the three operator gradients; and one adjoint stage per internal
    child (E - 1 of them: a tip child needs none).  The kernels' second
    computation of the stage-1 products in the reverse sweep is their own
    choice, not counted.  In bf16x3 mode the stages and operator
    gradients take three passes, the elementwise products one."""
    fwd, rate = node_work(S, C, variant)
    stage = 2 * S * S * C
    passes = 3 if variant == "mxu_3x" else 1
    return (E * (fwd + 4 * stage * passes + 2 * S * C)
            + (E - 1) * stage * passes), rate


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


#: Seconds of the run by phase: the time since the previous phase line
#: goes to the phase of the next.
PHASE_SECONDS = {}
_last_line = [time.perf_counter()]


def phase(name, msg):
    now = time.perf_counter()
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + now - _last_line[0]
    _last_line[0] = now
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of ``fn`` in ms, by CUDA events around ``reps``
    back-to-back runs after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def forced_underflow_case(rng, n, states=4, categories=4):
    """Random PLF inputs with the reference generator's forced-underflow
    pattern (every 4th site of x1 scaled by 1e-12, host_mem.cpp:179-209)."""
    S, C = states, categories
    e = S * C
    ev = rng.random((S, S), dtype=np.float32)
    left = rng.random((C, S, S), dtype=np.float32)
    right = rng.random((C, S, S), dtype=np.float32)
    x1 = rng.random((n * e,), dtype=np.float32)
    x2 = rng.random((n * e,), dtype=np.float32)
    j = np.arange(n * e)
    x1 = np.where(j % (4 * e) < e, x1 * np.float32(1e-12), x1)
    return x1.reshape(n, C, S), x2.reshape(n, C, S), left, right, ev


def lane_constants(left, right, ev, dev, states=4, categories=4):
    S, C = states, categories
    return [torch.as_tensor(a, device=dev) for a in (
        L.branch_to_lane_constants(left, S, C),
        L.branch_to_lane_constants(right, S, C),
        L.ev_to_lane_constants(ev, S, C))]


def device_phase():
    check(torch.cuda.is_available(), "no CUDA device: this script runs "
          "the port on the GPU and has no CPU mode")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", f"{name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    print(smi, flush=True)
    return name


#: The kernels with a bf16 CLV storage form, each built into a second
#: library of its own (plf_tpu_torch/ops/_build.py).
BF16_STORAGE = ("plf_node", "plf_node_mxu", "plf_tree_seg",
                "plf_tree_seg_bwd", "plf_tree_seg_mxu", "plf_tree_seg_bwd_mxu")


def build_phase():
    mods = {"plf_node": node_mod._lib, "plf_tree": tree_mod._lib,
            "plf_node_bwd": plf_grad._lib, "plf_tree_bwd": plf_tree_grad._lib,
            "plf_node_mxu": plf_mxu._lib, "plf_tree_mxu": tree_mod._lib_mxu,
            "plf_tree_bwd_mxu": plf_tree_grad._lib_mxu,
            "plf_tree_seg": seg_mod._lib, "plf_tree_seg_bwd": seg_mod._lib_bwd,
            "plf_tree_seg_mxu": seg_mod._lib_mxu,
            "plf_tree_seg_bwd_mxu": seg_mod._lib_bwd_mxu,
            "plf_gen": node_mod._lib_gen,
            "plf_node_bwd_mxu": plf_grad._lib_mxu}
    for name in BF16_STORAGE:
        mods[storage_library(name, True)] = functools.partial(mods[name],
                                                              True)
    t0 = time.perf_counter()
    build_libraries(list(mods))
    phase("build", f"{len(mods)} libraries, one nvcc each in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    for lib_name, load in mods.items():
        load()
        log = build_log(lib_name).read_text()
        secs = re.search(r"^# ([0-9.]+) s", log, re.M).group(1)
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", log))
        phase("build", f"{lib_name}: nvcc {secs} s; {len(regs)} instances, "
              f"at most {max(regs)} registers per thread, {spills} bytes "
              f"of spills")


def kernel1_phase(dev):
    """Kernel 1 against the numpy golden model at 2^20 sites and against
    its plain version at 2^24 sites, out of place and in place."""
    rng = np.random.default_rng(2024)
    x1, x2, left, right, ev = forced_underflow_case(rng, NODE_SITES_GOLDEN)
    n = NODE_SITES_GOLDEN
    n_pad = L.sites_padding(n, UNIT)
    x1l = torch.as_tensor(L.pad_to_multiple(L.to_lane_major(x1), UNIT),
                          device=dev).contiguous()
    x2l = torch.as_tensor(L.pad_to_multiple(L.to_lane_major(x2), UNIT),
                          device=dev).contiguous()
    lc, rc, ec = lane_constants(left, right, ev, dev)
    x3, sc = plf_node(x1l, x2l, lc, rc, ec, n)
    torch.cuda.synchronize()
    x3_ref, sv_ref, _ = plf_reference(x1, x2, left, right, ev)
    got = L.from_lane_major(x3.cpu().numpy(), n=n)
    flags = sc.cpu().numpy()[0]
    check(np.array_equal(got, x3_ref), "kernel 1 x3 != golden model")
    check(np.array_equal(flags[:n], sv_ref.astype(np.int32)),
          "kernel 1 scaler flags != golden model")
    check(not flags[n:].any(), "kernel 1 flagged a padding site")
    n_flag = int(flags.sum())
    check(n_flag > 0, "the forced-underflow case rescaled no site")
    max_err = 0.0

    def against_plain(a, b, lc, rc, ec, n, label):
        nonlocal max_err
        x3p, scp = plf_node_torch(a, b, lc, rc, ec, n)
        x3k, sck = plf_node(a, b, lc, rc, ec, n)
        outs = [("out of place", x3k, sck)]
        for which in (1, 2):
            a2, b2 = a.clone(), b.clone()
            x3i, sci = plf_node(a2, b2, lc, rc, ec, n,
                                out=a2 if which == 1 else b2)
            check(x3i.data_ptr() == (a2 if which == 1 else b2).data_ptr(),
                  "in-place form did not write over its child")
            outs.append((f"in place over x{which}", x3i, sci))
        for form, x3k_, sck_ in outs:
            max_err = max(max_err, float((x3k_ - x3p).abs().max()))
            check(torch.equal(x3k_, x3p) and torch.equal(sck_, scp),
                  f"kernel 1 ({form}) != plain version at {label}")
        ms_k = cuda_ms(lambda: plf_node(a, b, lc, rc, ec, n), reps=20)
        ms_p = cuda_ms(lambda: plf_node_torch(a, b, lc, rc, ec, n), reps=3,
                       warmup=1)
        return ms_k, ms_p

    ms_k, ms_p = against_plain(x1l, x2l, lc, rc, ec, n, "2^20")
    gbs = 196 * n_pad / (ms_k * 1e-3) / 1e9
    phase("kernel1", f"{n} sites: == golden (x3 and {n_flag} flags, "
          f"padding clear), == plain out of place and in place; kernel "
          f"{ms_k:.4f} ms ({n / ms_k / 1e6:.3f} Gsites/s, {gbs:.0f} GB/s "
          f"at 196 B/site), plain {ms_p:.3f} ms")
    res = dict(ms=ms_k, plain_ms=ms_p)
    del x1l, x2l, x3, sc

    nb = NODE_SITES_BIG
    nb_pad = L.sites_padding(nb, UNIT)
    g = torch.Generator(device=dev).manual_seed(7)
    a = torch.rand((16, nb_pad), generator=g, device=dev)
    b = torch.rand((16, nb_pad), generator=g, device=dev)
    a[:, 0::4] *= 1e-12
    a[:, nb:] = 0.0
    b[:, nb:] = 0.0
    ms_kb, ms_pb = against_plain(a, b, lc, rc, ec, nb, "2^24")
    gbs = 196 * nb_pad / (ms_kb * 1e-3) / 1e9
    # Same-run ceiling: a 2-read 1-write elementwise pass over the same
    # arrays (192 of the kernel's 196 bytes per site).
    c = torch.empty_like(a)
    ms_probe = cuda_ms(lambda: torch.add(a, b, out=c), reps=20)
    probe_gbs = 3 * a.numel() * 4 / (ms_probe * 1e-3) / 1e9
    phase("kernel1", f"{nb} sites: == plain out of place and in place; "
          f"kernel {ms_kb:.4f} ms ({nb / ms_kb / 1e6:.3f} Gsites/s, "
          f"{gbs:.0f} GB/s at 196 B/site, {100 * gbs / probe_gbs:.1f}% of "
          f"a same-run 2R+1W torch.add probe at {probe_gbs:.0f} GB/s), "
          f"plain {ms_pb:.3f} ms")
    del a, b, c
    torch.cuda.empty_cache()
    res.update(max_abs_err=max_err, ms_2p24=ms_kb, plain_ms_2p24=ms_pb,
               probe_gbs=probe_gbs)
    return res, (x1, x2, left, right, ev)


def sums_err(got, want):
    """Largest error of site sums (..., S*C, S) as a share of the largest
    magnitude of each (S*C, S) matrix (floored at 1e-6 of the overall
    largest, for matrices that are all but zero)."""
    w = want.reshape(-1, *want.shape[-2:])
    scale = w.abs().amax(dim=(1, 2), keepdim=True)
    scale = torch.clamp_min(scale, 1e-6 * float(scale.max()))
    return float(((got.reshape(w.shape) - w).abs() / scale).max())


def kernel3_phase(dev, node_case, probe_gbs):
    """Kernel 3 against its plain version: the forced-underflow node at
    2^20 sites, random operands at 2^24."""
    x1, x2, left, right, ev = node_case
    n = NODE_SITES_GOLDEN
    lane = lambda x: torch.as_tensor(
        L.pad_to_multiple(L.to_lane_major(x), UNIT), device=dev).contiguous()
    lc, rc, ec = lane_constants(left, right, ev, dev)
    consts = [lc, rc] + [transpose_lane_constants(t) for t in (lc, rc, ec)]
    gen = torch.Generator(device=dev).manual_seed(11)
    res = {}

    def against_plain(a, b, n, label):
        _, sc = plf_node(a, b, lc, rc, ec, n)
        g = torch.randn(a.shape, generator=gen, device=dev)
        k1 = plf_node_bwd(a, b, g, sc, *consts, n)
        k2 = plf_node_bwd(a, b, g, sc, *consts, n)
        p = plf_node_bwd_torch(a, b, g, sc, *consts, n)
        torch.cuda.synchronize()
        check(torch.equal(k1[0], p[0]) and torch.equal(k1[1], p[1]),
              f"kernel 3 gx1/gx2 != plain at {label}")
        check(all(torch.equal(u, v) for u, v in zip(k1, k2)),
              f"kernel 3 differs between two runs at {label}")
        errs = [sums_err(k1[i], p[i]) for i in (2, 3, 4)]
        check(max(errs) <= SUM_RTOL, f"kernel 3 op grads at {label}: "
              f"{errs} of scale > {SUM_RTOL}")
        abs_err = max(float((u - v).abs().max()) for u, v in zip(k1, p))
        ms_k = cuda_ms(lambda: plf_node_bwd(a, b, g, sc, *consts, n), reps=20)
        ms_p = cuda_ms(lambda: plf_node_bwd_torch(a, b, g, sc, *consts, n),
                       reps=2, warmup=1)
        n_pad = a.shape[1]
        gbs = 324 * n_pad / (ms_k * 1e-3) / 1e9
        phase("kernel3", f"{n} sites ({int(sc.sum())} rescued): gx1/gx2 == "
              f"plain; gl/gr/ge within {max(errs):.2e} of scale of plain "
              f"(max abs {abs_err:.3g}), bit-identical run to run; kernel "
              f"{ms_k:.4f} ms ({gbs:.0f} GB/s at 324 B/site, "
              f"{100 * gbs / probe_gbs:.1f}% of kernel 1's same-run probe "
              f"at {probe_gbs:.0f} GB/s), plain {ms_p:.3f} ms")
        return dict(ms=ms_k, plain_ms=ms_p, max_abs_err=abs_err)

    res["2p20"] = against_plain(lane(x1), lane(x2), n, "2^20")
    nb = NODE_SITES_BIG
    nb_pad = L.sites_padding(nb, UNIT)
    a = torch.rand((16, nb_pad), generator=gen, device=dev)
    b = torch.rand((16, nb_pad), generator=gen, device=dev)
    a[:, 0::4] *= 1e-12
    res["2p24"] = against_plain(a, b, nb, "2^24")
    del a, b
    torch.cuda.empty_cache()
    return res


def tree_workload(dev):
    """160 taxa x 2^20 patterns, HKY85 kappa=2 + Gamma4 alpha=0.5, random
    codes with gaps and IUPAC ambiguity codes."""
    tree = random_tree(N_TAXA, seed=1)
    rng = np.random.default_rng(1)
    p = np.concatenate([[0.04], np.full(4, 0.22), np.full(10, 0.008)])
    tips = rng.choice(np.arange(-1, 14, dtype=np.int8),
                      size=(N_TAXA, TREE_SITES), p=p / p.sum())
    t0 = time.perf_counter()
    pm = PhyloModel(tree, hky85(2.0), tips, alpha=0.5, device=dev)
    torch.cuda.synchronize()
    phase("data", f"{N_TAXA} taxa x {TREE_SITES} patterns, "
          f"{len(pm.schedule)} PLF nodes, {pm.n_slots} arena slots, "
          f"{pm.tip_table.shape[1]} tip codes; model built in "
          f"{time.perf_counter() - t0:.1f} s")
    return tree, tips, pm


def kernel2_phase(pm):
    """Kernel 2 on the model's carried program against the plain tree
    forward on the card, with its plan and its share of the uncontracted
    fp32 ceiling."""
    cfg = pm.config
    args = (pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
            pm.root_rows[0], pm.n_sites)
    kw = dict(n_slots=pm.n_slots, root_slot=pm.root_slot,
              states=cfg.states, categories=cfg.categories)
    prog = pm.tree_program
    lik_k, sc_k = plf_tree(*args, **kw, program=prog)
    lik_p, sc_p = plf_tree_torch(*args, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lik_k).all()) and bool((lik_k > 0).all()),
          "kernel 2 gave non-finite or non-positive site likelihoods")
    max_err = float((lik_k - lik_p).abs().max())
    check(torch.equal(sc_k, sc_p), "kernel 2 scaler counts != plain")
    check(torch.equal(lik_k, lik_p), "kernel 2 site likelihoods != plain "
          f"(max abs diff {max_err:g})")
    ms_k = cuda_ms(lambda: plf_tree(*args, **kw, program=prog), reps=10)
    ms_p = cuda_ms(lambda: plf_tree_torch(*args, **kw), reps=2, warmup=1)
    plan = tree_plan(pm.codes.dtype, cfg.categories, pm.tip_table.shape[1],
                     pm.carry_slots)
    fwd, _ = node_work(cfg.states, cfg.categories)
    ceiling = 2 * len(pm.schedule) * fwd * pm.n_pad / FP32_FLOPS * 1e3
    phase("kernel2", f"{len(pm.schedule)} nodes x {pm.n_sites} sites: "
          f"== plain (site likelihoods and {int(sc_k.sum())} rescales); "
          f"kernel {ms_k:.3f} ms ({1e3 / ms_k:.1f} tree evals/s, "
          f"{100 * ceiling / ms_k:.1f}% of the uncontracted fp32 ceiling "
          f"{ceiling:.4f} ms, twice the 67 TFLOP/s bound), plain "
          f"{ms_p:.3f} ms; plan: {plan['threads']} threads x "
          f"{plan['sites_per_thread']} site(s) a block, {plan['slots']} "
          f"arena slots carried ({pm.n_slots} uncarried), "
          f"{plan['blocks_per_sm']} blocks per SM")
    return dict(ms=ms_k, plain_ms=ms_p, max_abs_err=max_err)


def model_bsched(pm):
    """The (3, E) int32 schedule that kernels 4 and 4m take, on the card."""
    sched = reorder_schedule(pm.schedule, pm.tree.n_leaves)
    return torch.as_tensor(backward_schedule(sched, pm.tree.n_leaves),
                           device=pm.device)


def kernel4_phase(pm):
    """Kernel 4 against its plain version at the tree workload, with the
    site-likelihood cotangent of a real gradient step (w / lik)."""
    cfg = pm.config
    torch.cuda.reset_peak_memory_stats()
    bsched = model_bsched(pm)
    T = transpose_lane_constants
    args = (pm.codes, bsched, pm.lcs, pm.rcs, T(pm.lcs), T(pm.rcs), pm.ec,
            T(pm.ec), pm.tip_table, pm.root_rows[0])
    lik, _ = plf_tree(pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec,
                      pm.tip_table, pm.root_rows[0], pm.n_sites,
                      n_slots=pm.n_slots, root_slot=pm.root_slot,
                      program=pm.tree_program)
    glik = (pm.wgt_pad.to(torch.float32) / lik).contiguous()
    n = pm.n_sites
    k1 = plf_tree_bwd(*args, glik, n)
    chunking = dict(plf_tree_bwd.last_scratch)
    k2 = plf_tree_bwd(*args, glik, n)
    budget = chunking["bytes"] // 4
    k3 = plf_tree_bwd(*args, glik, n, max_scratch_bytes=budget)
    small = dict(plf_tree_bwd.last_scratch)
    p = plf_tree_bwd_torch(*args, glik, n)
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(k1, k2)),
          "kernel 4 differs between two runs")
    errs = [max(sums_err(k[i], p[i]) for i in range(3))
            for k in (k1, k3)]
    errs_rr = [sums_err(k[3].reshape(1, -1, 1), p[3].reshape(1, -1, 1))
               for k in (k1, k3)]
    check(max(errs + errs_rr) <= SUM_RTOL,
          f"kernel 4 gradients vs plain: {errs} {errs_rr} of scale > "
          f"{SUM_RTOL}")
    check(small["chunks"] > 1, f"budget {budget} gave one chunk")
    abs_err = max(float((u - v).abs().max()) for u, v in zip(k1, p))
    ms_k = cuda_ms(lambda: plf_tree_bwd(*args, glik, n), reps=5, warmup=1)
    ms_p = cuda_ms(lambda: plf_tree_bwd_torch(*args, glik, n), reps=1,
                   warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sms = torch.cuda.get_device_properties(pm.device).multi_processor_count
    bpsm = plf_tree_grad.tree_bwd_resident_blocks(
        pm.device, pm.codes.element_size(), cfg.categories,
        pm.tip_table.shape[1]) // sms
    phase("kernel4", f"{len(pm.schedule)} nodes x {n} sites: gl/gr/gec/grr within "
          f"{max(errs + errs_rr):.2e} of scale of plain (max abs "
          f"{abs_err:.3g}), bit-identical run to run; {chunking['chunks']} "
          f"chunk of {chunking['chunk_sites']} sites, "
          f"{chunking['bytes'] / 1e9:.2f} GB scratch (and {small['chunks']} "
          f"chunks of {small['chunk_sites']} sites under a "
          f"{budget / 1e9:.2f} GB budget, within {errs[1]:.2e}); "
          f"{bpsm} blocks of 128 threads per SM; kernel "
          f"{ms_k:.3f} ms, plain {ms_p:.3f} ms; peak {peak:.2f} GiB")
    del k1, k2, k3, p
    torch.cuda.empty_cache()
    return dict(ms=ms_k, plain_ms=ms_p, max_abs_err=abs_err, **chunking)


def _grad_step(fn, t0, dev):
    t = torch.tensor(t0, device=dev, requires_grad=True)
    v = fn(t)
    v.backward()
    return float(v.detach()), t.grad


COUNTED = (plf_node, plf_tree, plf_node_bwd, plf_tree_bwd, plf_node_mxu,
           plf_tree_mxu, plf_tree_bwd_mxu, plf_tree_seg, plf_tree_seg_bwd,
           plf_tree_seg_mxu, plf_tree_seg_bwd_mxu, plf_node_gen,
           plf_grad.plf_node_bwd_mxu, tree_mod.plf_tree_batch,
           tree_mod.plf_tree_mxu_batch, node_mod.plf_node_batch,
           plf_mxu.plf_node_mxu_batch, seg_mod.plf_tree_seg_batch,
           seg_mod.plf_tree_seg_mxu_batch)


#: The wrappers with a bf16 CLV storage form, which count its launches in
#: ``bf16_launches`` too.
BF16_COUNTED = (plf_node, plf_node_mxu, plf_tree_seg, plf_tree_seg_bwd,
                plf_tree_seg_mxu, plf_tree_seg_bwd_mxu)


def _reset_counts():
    for f in COUNTED:
        f.launches = 0
    for f in BF16_COUNTED:
        f.bf16_launches = 0


def _counts():
    return {f.__name__: f.launches for f in COUNTED}


def _bf16_counts():
    return {f.__name__: f.bf16_launches for f in BF16_COUNTED}


def train_phase(dev, tree, tips, pm):
    """The training main path: tree_loglik_fn value and gradient on the
    "tree" and "kernel" backends, checked against each other, the forward
    and float64 differences of the brute force; then the fitters."""
    E = len(pm.schedule)
    ref = pm.log_likelihood().log_likelihood
    out, launches = {}, {}
    for backend in ("tree", "kernel"):
        torch.cuda.reset_peak_memory_stats()
        fn, t0 = tree_loglik_fn(pm, backend=backend)
        _reset_counts()
        v, g = _grad_step(fn, t0, dev)
        counts = _counts()
        want = dict({k: 0 for k in counts},
                    **({"plf_tree": 1, "plf_tree_bwd": 1} if backend == "tree"
                       else {"plf_node": E, "plf_node_bwd": E}))
        check(counts == want, f"{backend} step launched {counts}, "
              f"not {want}")
        launches.update({k: c for k, c in counts.items() if c})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = _median_ms(lambda: _grad_step(fn, t0, dev), reps=3)
        rel = abs(v - ref) / abs(ref)
        check(rel < 1e-5, f"{backend} value {v} vs log_likelihood() {ref}")
        out[backend] = (v, g.cpu().numpy(), ms)
        phase("train", f"{backend}: value {v:.3f} (rel {rel:.2e} to "
              f"log_likelihood()), one value+gradient step {ms:.2f} ms "
              f"wall (median of 3), launches {counts}, peak {peak:.2f} GiB")
        del fn, g
        torch.cuda.empty_cache()
    g_t, g_k = out["tree"][1], out["kernel"][1]
    scale = float(np.abs(g_k).max())
    err = float(np.max(np.abs(g_t - g_k) / (2e-4 * np.abs(g_k)
                                            + 1e-4 * scale)))
    check(err <= 1.0, f"tree vs kernel gradient: {err} of the bar")
    fn_auto, _ = tree_loglik_fn(pm)
    check(fn_auto.engine == ("segmented" if pm.can_fuse() else "kernel"),
          f"auto took {fn_auto.engine!r} on the card")
    phase("train", f"tree vs kernel gradient within {err:.3f} of the "
          f"rtol 2e-4 / atol 1e-4 x max|g| bar (max|g| {scale:.4g}); auto "
          f"takes {fn_auto.engine!r}")

    sub_tips = tips[:, :FD_SITES]
    sub = PhyloModel(tree, hky85(2.0), sub_tips, alpha=0.5, device=dev)
    fn, t0 = tree_loglik_fn(sub, backend="tree")
    _, g = _grad_step(fn, t0, dev)
    g = g.cpu().numpy()
    h = 1e-4
    fds = []
    for i in (0, 1, tree.n_leaves):
        ll = []
        for d in (h, -h):
            tr = copy.deepcopy(tree)
            tr.nodes[i].length += d
            ll.append(PhyloModel(tr, hky85(2.0), sub_tips, alpha=0.5)
                      .log_likelihood_bruteforce())
        fd = (ll[0] - ll[1]) / (2 * h)
        fds.append(f"branch {i}: {g[i]:.6g} vs {fd:.6g}")
        check(abs(g[i] - fd) <= 1e-3 * abs(fd),
              f"tree gradient vs float64 differences, {fds[-1]}")
    phase("train", f"{FD_SITES}-site sub-alignment, tree gradient vs float64 "
          f"central differences (h {h}) of the brute force, within rel 1e-3: "
          + "; ".join(fds))

    for n_taxa, sites in ((160, 1 << 16), (20, 1 << 20)):
        rng = np.random.default_rng(n_taxa)
        other = PhyloModel(random_tree(n_taxa, seed=2), hky85(2.0),
                           rng.integers(0, 4, size=(n_taxa, sites)),
                           alpha=0.5, device=dev)
        ms = {}
        for backend in ("tree", "kernel"):
            f, t0 = tree_loglik_fn(other, backend=backend)
            _grad_step(f, t0, dev)
            ms[backend] = _median_ms(lambda: _grad_step(f, t0, dev), reps=3)
        phase("train", f"routing at {n_taxa} taxa x {sites} sites: one "
              f"value+gradient step tree {ms['tree']:.2f} ms, kernel "
              f"{ms['kernel']:.2f} ms (medians of 3); auto takes "
              f"{tree_loglik_fn(other)[0].engine!r}")
        del other, f
        torch.cuda.empty_cache()

    t_opt, ll0, ll1 = optimize_branch_lengths(pm, steps=5)
    check(ll1 > ll0 and np.all(t_opt > 0),
          f"optimize_branch_lengths: {ll0} -> {ll1}")
    alpha, a0, a1 = optimize_alpha(pm, iters=8)
    check(np.isfinite(alpha) and 0.02 <= alpha <= 100.0 and a1 >= a0,
          f"optimize_alpha: {alpha} ({a0} -> {a1})")
    phase("train", f"optimize_branch_lengths(steps=5): {ll0:.3f} -> "
          f"{ll1:.3f}; optimize_alpha(iters=8): alpha {alpha:.4f}, "
          f"{a0:.3f} -> {a1:.3f}")
    return launches, {b: out[b][2] for b in out}


def main_path_phase(dev, tree, tips, pm, node_case):
    """PhyloModel.log_likelihood: auto must take kernel 2, per-node kernel
    1; both agree, and agree with a float64 brute force."""
    n_auto = 3
    plf_node.launches = 0
    plf_tree.launches = 0
    walls = []
    for _ in range(n_auto):
        t0 = time.perf_counter()
        fused = pm.log_likelihood()
        walls.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    pernode = pm.log_likelihood(method="per-node")
    wall_pn = (time.perf_counter() - t0) * 1e3
    launches = {"plf_tree": plf_tree.launches, "plf_node": plf_node.launches}
    check(launches["plf_tree"] == n_auto,
          f"auto did not take the fused kernel: {launches}")
    check(launches["plf_node"] == len(pm.schedule),
          f"per-node did not run kernel 1 once per node: {launches}")
    check(np.isfinite(fused.log_likelihood), "non-finite log-likelihood")
    check(fused.scaler_total == pernode.scaler_total,
          f"scaler totals differ: {fused.scaler_total} vs "
          f"{pernode.scaler_total}")
    np.testing.assert_allclose(fused.site_log_likelihood,
                               pernode.site_log_likelihood, rtol=1e-6)
    check(abs(fused.log_likelihood - pernode.log_likelihood)
          < 1e-6 * abs(pernode.log_likelihood) + 1e-6,
          f"fused {fused.log_likelihood} != per-node "
          f"{pernode.log_likelihood}")
    wall = float(np.median(walls))
    phase("main", f"log_likelihood() = {fused.log_likelihood:.6f} "
          f"(scaler total {fused.scaler_total}) via kernel 2, "
          f"{wall:.2f} ms/eval wall (median of {n_auto}); per-node via "
          f"kernel 1 = {pernode.log_likelihood:.6f} in {wall_pn:.1f} ms")

    sub = PhyloModel(tree, hky85(2.0), tips[:, :BRUTE_SITES], alpha=0.5,
                     device=dev)
    ll = sub.log_likelihood().log_likelihood
    bf = sub.log_likelihood_bruteforce()
    rel = abs(ll - bf) / abs(bf)
    check(rel < 1e-5, f"fused {ll} vs float64 brute force {bf}: rel {rel}")
    phase("main", f"{BRUTE_SITES}-site sub-alignment: fused {ll:.6f} vs "
          f"float64 brute force {bf:.6f} (rel {rel:.2e})")

    x1, x2, left, right, ev = node_case
    eng = PLFEngine(PLFConfig(), device=dev)
    out = eng.plf(x1, x2, left, right, ev)
    ok, n_err, msgs = eng.verify(out, x1, x2, left, right, ev, exact=True)
    check(ok and n_err == 0, f"PLFEngine.verify: {n_err} errors {msgs[:3]}")
    phase("main", f"PLFEngine.plf + verify(exact=True) on {len(x1)} sites: "
          f"0 errors, scaler increment {int(out.scaler_increment)}")
    return launches


# ----------------------------------------------------- the protein path --


def _mxu_case(dev, n, S, C, seed):
    """Random lane-major PLF inputs on the card, every 4th site of x1
    scaled by 1e-16 (at S = 20 and 61 the sums grow past what 1e-12 of the
    DNA generator would rescale), and random positive operators."""
    rng = np.random.default_rng(seed)
    left = rng.random((C, S, S), dtype=np.float32)
    right = rng.random((C, S, S), dtype=np.float32)
    ev = rng.random((S, S), dtype=np.float32)
    n_pad = L.sites_padding(n, UNIT)
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand((S * C, n_pad), generator=g, device=dev)
    b = torch.rand((S * C, n_pad), generator=g, device=dev)
    a[:, 0::4] *= 1e-16
    a[:, n:] = 0.0
    b[:, n:] = 0.0
    return a, b, (left, right, ev), lane_constants(left, right, ev, dev, S, C)


def node_plan_text(S, C, variant, bf16, n_pad):
    """Kernel 1m's launch shape as its library plans it, in words."""
    ts, threads, blocks = node_mxu_plan(S, C, variant, bf16)
    return (f"{ts}-site tiles, {threads} threads, {blocks} blocks per SM, "
            f"grid {-(-n_pad // ts)}")


def kernel1m_edges(dev, dtype, name):
    """Kernel 1m at NODE_MXU_EDGES in every MXU variant and ``dtype``
    storage: == the plain version bit for bit, out of place and in place
    over x1 and over x2; prints under phase ``name``."""
    for S, C, n, n_pad in NODE_MXU_EDGES:
        rng = np.random.default_rng(S * 1000 + n_pad)
        left, right = (rng.random((C, S, S), dtype=np.float32)
                       for _ in range(2))
        ev = rng.random((S, S), dtype=np.float32)
        lc, rc, ec = lane_constants(left, right, ev, dev, S, C)
        g = torch.Generator(device=dev).manual_seed(n_pad)
        a, b = (torch.rand((S * C, n_pad), generator=g, device=dev)
                for _ in range(2))
        a[:, 0::4] *= 1e-16
        a, b = a.to(dtype), b.to(dtype)
        flags = []
        for variant in MXU_VARIANTS:
            kw = dict(states=S, categories=C, variant=variant)
            x3p, scp = plf_node_mxu_torch(a, b, lc, rc, ec, n, **kw)
            runs = [plf_node_mxu(a, b, lc, rc, ec, n, **kw)]
            for which in (1, 2):
                a2, b2 = a.clone(), b.clone()
                dst = a2 if which == 1 else b2
                runs.append(plf_node_mxu(a2, b2, lc, rc, ec, n, out=dst,
                                         **kw))
                check(runs[-1][0].data_ptr() == dst.data_ptr(),
                      f"kernel 1m in place over x{which} wrote elsewhere")
            torch.cuda.synchronize()
            check(all(torch.equal(x, x3p) and torch.equal(f, scp)
                      for x, f in runs) and int(scp.sum()) > 0
                  and not scp[0, n:].any(),
                  f"kernel 1m ({variant}, {dtype}) != plain at S={S} C={C}"
                  f" n={n} n_pad={n_pad}")
            flags.append(int(scp.sum()))
        phase(name, f"edge S={S} C={C}, n={n}, n_pad={n_pad} "
              f"({node_plan_text(S, C, 'mxu', dtype == BF16, n_pad)}"
              f"): == plain in {', '.join(MXU_VARIANTS)}, out of place "
              f"and in place over x1 and x2 ({flags} rescaled)")
        del a, b


def kernel1m_phase(dev):
    """Kernel 1m in each MXU variant at S = 20, C = 4 on 2^21 sites:
    equal to its plain version (out of place and in place), fp32 mode also
    to the golden model on a 65,536-site slice; timed against a same-run
    2R+1W probe; then each variant at S = 61, C = 4 on 2^18 sites; then
    the edge shapes.  Prints each launch's plan."""
    S, C = 20, 4
    n = NODE_MXU_SITES
    a, b, ops, (lc, rc, ec) = _mxu_case(dev, n, S, C, 21)
    n_pad = a.shape[1]
    site_bytes = 3 * S * C * 4 + 4
    c = torch.empty_like(a)
    ms_probe = cuda_ms(lambda: torch.add(a, b, out=c), reps=20)
    probe_gbs = 3 * a.numel() * 4 / (ms_probe * 1e-3) / 1e9
    del c
    res = {}
    for variant in MXU_VARIANTS:
        kw = dict(states=S, categories=C, variant=variant)
        x3k, sck = plf_node_mxu(a, b, lc, rc, ec, n, **kw)
        x3p, scp = plf_node_mxu_torch(a, b, lc, rc, ec, n, **kw)
        torch.cuda.synchronize()
        err = float((x3k - x3p).abs().max())
        check(torch.equal(x3k, x3p) and torch.equal(sck, scp),
              f"kernel 1m ({variant}) != plain version (max abs {err:g})")
        n_flag = int(sck.sum())
        check(n_flag > 0 and not sck[0, n:].any(),
              f"kernel 1m ({variant}): {n_flag} flags, or a padding flag")
        del x3p, scp
        for which in (1, 2):
            a2, b2 = a.clone(), b.clone()
            dst = a2 if which == 1 else b2
            x3i, sci = plf_node_mxu(a2, b2, lc, rc, ec, n, out=dst, **kw)
            check(x3i.data_ptr() == dst.data_ptr() and torch.equal(x3i, x3k)
                  and torch.equal(sci, sck),
                  f"kernel 1m ({variant}) in place over x{which}")
            del a2, b2, dst, x3i, sci
        golden = ""
        if variant == "mxu":
            m = NODE_MXU_GOLDEN
            site_major = lambda t: np.ascontiguousarray(
                L.from_lane_major(t[:, :m].cpu().numpy(), S, C))
            x3_ref, sv_ref, _ = plf_reference(
                site_major(a), site_major(b), *ops, states=S, categories=C)
            check(np.array_equal(site_major(x3k), x3_ref)
                  and np.array_equal(sck[0, :m].cpu().numpy(),
                                     sv_ref.astype(np.int32)),
                  "kernel 1m (mxu) != golden model")
            golden = f", == golden on {m} sites"
        torch.cuda.empty_cache()
        ms_k = cuda_ms(lambda: plf_node_mxu(a, b, lc, rc, ec, n, **kw),
                       reps=10)
        ms_p = cuda_ms(lambda: plf_node_mxu_torch(a, b, lc, rc, ec, n, **kw),
                       reps=2, warmup=1)
        gbs = site_bytes * n_pad / (ms_k * 1e-3) / 1e9
        flops, rate = node_work(S, C, variant)
        bd = bound(site_bytes * n_pad, flops * n_pad, rate)
        phase("kernel1m", f"{variant}, S={S} C={C}, {n} sites "
              f"({node_plan_text(S, C, variant, False, n_pad)}): == plain "
              f"out of place and in place ({n_flag} rescaled){golden}; kernel "
              f"{ms_k:.4f} ms ({gbs:.0f} GB/s at {site_bytes} B/site, "
              f"{100 * gbs / probe_gbs:.1f}% of a same-run 2R+1W probe at "
              f"{probe_gbs:.0f} GB/s; bound {bd['bound_ms']:.4f} ms by "
              f"{bd['bound_by']}), plain {ms_p:.3f} ms")
        res[variant] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=err, **bd)
        del x3k, sck
    del a, b
    torch.cuda.empty_cache()

    S = 61
    a, b, _, (lc, rc, ec) = _mxu_case(dev, NODE_MXU_S61, S, C, 22)
    for variant in MXU_VARIANTS:
        kw = dict(states=S, categories=C, variant=variant)
        x3k, sck = plf_node_mxu(a, b, lc, rc, ec, NODE_MXU_S61, **kw)
        x3p, scp = plf_node_mxu_torch(a, b, lc, rc, ec, NODE_MXU_S61, **kw)
        torch.cuda.synchronize()
        check(torch.equal(x3k, x3p) and torch.equal(sck, scp)
              and int(sck.sum()) > 0,
              f"kernel 1m ({variant}) at S=61 != plain version")
        ms_k = cuda_ms(lambda: plf_node_mxu(a, b, lc, rc, ec, NODE_MXU_S61,
                                            **kw), reps=5)
        phase("kernel1m", f"{variant}, S={S} C={C}, {NODE_MXU_S61} sites "
              f"({S * C} rows; "
              f"{node_plan_text(S, C, variant, False, a.shape[1])}): == "
              f"plain ({int(sck.sum())} rescaled); kernel {ms_k:.4f} ms")
    del a, b, x3k, x3p
    torch.cuda.empty_cache()
    kernel1m_edges(dev, torch.float32, "kernel1m")
    return res


def protein_workload(dev):
    """64 taxa x 131,072 sites, LG + Gamma4 alpha=0.5, random codes (the
    20 amino acids, gaps and the B/Z/J ambiguity codes).  The default
    model is built as a user would, with no device and no config; the
    "mxu" and "mxu_bf16" models beside it share its tips."""
    tree = random_tree(PROT_TAXA, seed=1)
    rng = np.random.default_rng(64)
    p = np.concatenate([[0.04], np.full(20, 0.0475), np.full(3, 0.01)])
    tips = rng.choice(np.arange(-1, 23, dtype=np.int8),
                      size=(PROT_TAXA, PROT_SITES), p=p / p.sum())
    lg = empirical_protein("lg")
    t0 = time.perf_counter()
    pm = PhyloModel(tree, lg, tips, alpha=0.5)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    check(pm.device.type == "cuda" and
          pm.config.resolved_kernel_variant == "mxu_3x",
          f"default protein model on {pm.device} under "
          f"{pm.config.resolved_kernel_variant}")
    models = {"mxu_3x": pm}
    for v in ("mxu", "mxu_bf16"):
        models[v] = PhyloModel(tree, lg, tips, alpha=0.5, device=dev,
                               config=PLFConfig(states=20, kernel_variant=v))
    phase("data", f"protein: {PROT_TAXA} taxa x {PROT_SITES} sites, LG+G4, "
          f"{len(pm.schedule)} PLF nodes, {pm.n_slots} arena slots, "
          f"{pm.tip_table.shape[1]} tip codes; default model on "
          f"{pm.device} ({pm.config.resolved_kernel_variant}) built in "
          f"{built:.1f} s")
    return tree, tips, models


def kernel2m_phase(models):
    """Kernel 2m against its plain version on the protein workload, in
    each MXU variant: site likelihoods and rescale counts equal."""
    res = {}
    for variant in MXU_VARIANTS:
        pm = models[variant]
        cfg = pm.config
        S, C = cfg.states, cfg.categories
        args = (pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
                pm.root_rows[0], pm.n_sites)
        kw = dict(n_slots=pm.n_slots, root_slot=pm.root_slot, states=S,
                  categories=C, variant=variant, planes=pm._planes())
        lik_k, sc_k = plf_tree_mxu(*args, **kw)
        lik_p, sc_p = plf_tree_torch(*args, **kw)
        torch.cuda.synchronize()
        err = float((lik_k - lik_p).abs().max())
        check(torch.equal(lik_k, lik_p) and torch.equal(sc_k, sc_p),
              f"kernel 2m ({variant}) != plain version (max abs {err:g})")
        ms_k = cuda_ms(lambda: plf_tree_mxu(*args, **kw), reps=5, warmup=1)
        ms_p = cuda_ms(lambda: plf_tree_torch(*args, **kw), reps=1,
                       warmup=0)
        n_codes = pm.tip_table.shape[1]
        blocks = plf_tree_mxu_occupancy(pm.codes.dtype, S, C, n_codes,
                                        pm.n_slots, variant)
        n_pad, E = pm.n_pad, len(pm.schedule)
        flops, rate = node_work(S, C, variant)
        bd = bound((pm.codes.element_size() * pm.tree.n_leaves + 8) * n_pad,
                   E * flops * n_pad, rate)
        # the same operations one at a time on the CUDA cores (-fmad=false:
        # a multiply and an add are two instructions), the bit-exact form
        ceiling_ms = E * flops * n_pad / (FP32_FLOPS / 2) * 1e3
        phase("kernel2m", f"{variant}: {E} nodes x {pm.n_sites} sites: == "
              f"plain (site likelihoods and {int(sc_k.sum())} rescales); "
              f"{pm.n_slots} arena slots, tiles of {TREE_MXU_SITES} sites, "
              f"{blocks} blocks of {tree_mxu_block(S, C)[0]} threads per SM; "
              f"kernel {ms_k:.3f} ms "
              f"({1e3 / ms_k:.1f} tree evals/s; bound {bd['bound_ms']:.3f} "
              f"ms by {bd['bound_by']}; uncontracted fp32 ceiling "
              f"{ceiling_ms:.3f} ms, {ceiling_ms / ms_k:.1%} of it), plain "
              f"{ms_p:.3f} ms")
        res[variant] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=err, **bd)
    return res


def protein_phase(tree, tips, models, dev):
    """The protein main path: the default model's log_likelihood() runs
    kernel 2m once and kernel 1m never; per-node runs kernel 1m once per
    node; the two agree, and each variant stands against a float64 brute
    force on a sub-alignment."""
    pm = models["mxu_3x"]
    E = len(pm.schedule)
    n_eval = 5
    _reset_counts()
    walls = []
    for _ in range(n_eval):
        t0 = time.perf_counter()
        fused = pm.log_likelihood()
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = _counts()
    check(counts["plf_tree_mxu"] == n_eval
          and sum(counts.values()) == n_eval,
          f"log_likelihood() launched {counts}, not kernel 2m x {n_eval}")
    _reset_counts()
    t0 = time.perf_counter()
    pernode = pm.log_likelihood(method="per-node")
    wall_pn = (time.perf_counter() - t0) * 1e3
    counts_pn = _counts()
    check(counts_pn["plf_node_mxu"] == E and sum(counts_pn.values()) == E,
          f"per-node launched {counts_pn}, not kernel 1m x {E}")
    launches = {"plf_tree_mxu": counts["plf_tree_mxu"],
                "plf_node_mxu": counts_pn["plf_node_mxu"]}
    rel = abs(fused.log_likelihood - pernode.log_likelihood) / abs(
        pernode.log_likelihood)
    check(np.isfinite(fused.log_likelihood)
          and fused.scaler_total == pernode.scaler_total and rel < 1e-5,
          f"mxu_3x fused {fused.log_likelihood} vs per-node "
          f"{pernode.log_likelihood} (rel {rel}, scalers "
          f"{fused.scaler_total}/{pernode.scaler_total})")
    wall = float(np.median(walls))
    phase("protein", f"log_likelihood() = {fused.log_likelihood:.6f} "
          f"(mxu_3x, scaler total {fused.scaler_total}) via kernel 2m, "
          f"{wall:.2f} ms/eval wall (median of {n_eval}); per-node via "
          f"kernel 1m x {E} = {pernode.log_likelihood:.6f} (rel {rel:.2e}) "
          f"in {wall_pn:.1f} ms")
    mx = models["mxu"]
    f32, pn32 = mx.log_likelihood(), mx.log_likelihood(method="per-node")
    rel32 = abs(f32.log_likelihood - pn32.log_likelihood) / abs(
        pn32.log_likelihood)
    check(rel32 < 1e-12 and f32.scaler_total == pn32.scaler_total,
          f"mxu fused {f32.log_likelihood} vs per-node "
          f"{pn32.log_likelihood}")
    b16 = models["mxu_bf16"].log_likelihood()
    phase("protein", f"full alignment: mxu {f32.log_likelihood:.6f} "
          f"(fused vs per-node rel {rel32:.2e}); mxu_3x drift from mxu "
          f"{abs(fused.log_likelihood / f32.log_likelihood - 1):.2e}; "
          f"mxu_bf16 {b16.log_likelihood:.6f}, drift "
          f"{abs(b16.log_likelihood / f32.log_likelihood - 1):.2e}")

    sub_tips = tips[:, :PROT_BRUTE_SITES]
    lg = empirical_protein("lg")
    bf, out = None, []
    for variant, bar in (("mxu", 1e-5), ("mxu_3x", 1e-4), ("mxu_bf16", None)):
        sub = PhyloModel(tree, lg, sub_tips, alpha=0.5, device=dev,
                         config=PLFConfig(states=20, kernel_variant=variant))
        if bf is None:
            bf = sub.log_likelihood_bruteforce()
        ll = sub.log_likelihood().log_likelihood
        r = abs(ll - bf) / abs(bf)
        check(bar is None or r < bar,
              f"{variant} {ll} vs float64 brute force {bf}: rel {r}")
        out.append(f"{variant} {ll:.6f} (rel {r:.2e}"
                   + ("" if bar is None else f" < {bar:g}") + ")")
    phase("protein", f"{PROT_BRUTE_SITES}-site sub-alignment vs float64 "
          f"brute force {bf:.6f}: " + "; ".join(out))
    return launches, wall


# ------------------------------------------- the training path, S != 4 --


def timed(fn):
    """``(fn(), device ms)`` by CUDA events around one run."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def step_cotangent(pm):
    """The site-likelihood cotangent of a real value-and-gradient step:
    w / lik where the likelihood clears the log's floor, else 0 (the
    gradient of sum w * log(max(lik, floor)), as tree_loglik_fn takes it),
    from the model's own kernel-2m forward."""
    cfg = pm.config
    lik, _ = plf_tree_mxu(
        pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
        pm.root_rows[0], pm.n_sites, n_slots=pm.n_slots,
        root_slot=pm.root_slot, states=cfg.states,
        categories=cfg.categories, variant=cfg.resolved_kernel_variant,
        planes=pm._planes())
    w = pm.wgt_pad.to(torch.float32)[None, :]
    return torch.where(lik > LIK_FLOOR, w / lik, 0.0).contiguous()


def tree_bwd_bound(pm, variant="vpu"):
    """Kernel 4's or 4m's bound: the tip codes and the cotangent read once
    against the whole-tree VJP's operations (tree_bwd_work) at the mode's
    rate."""
    flops, rate = tree_bwd_work(pm.config.states, pm.config.categories,
                                len(pm.schedule), variant)
    return bound((pm.codes.element_size() * pm.tree.n_leaves + 4) * pm.n_pad,
                 flops * pm.n_pad, rate)


def kernel4m_against_plain(pm, glik, label, chunks=False):
    """Kernel 4m against its plain version on one model in its own
    variant: bit-identical run to run, site sums within SUM_RTOL of scale
    (with ``chunks``, also under a quarter of the one-chunk scratch)."""
    cfg = pm.config
    variant = cfg.resolved_kernel_variant
    args = (pm.codes, model_bsched(pm), pm.lcs, pm.rcs, pm.ec,
            pm.fused_tip_table, pm.root_rows[0], glik, pm.n_sites)
    kw = dict(states=cfg.states, categories=cfg.categories, variant=variant,
              planes=pm._planes())
    torch.cuda.reset_peak_memory_stats()
    k1 = plf_tree_bwd_mxu(*args, **kw)
    chunking = dict(plf_tree_bwd_mxu.last_scratch)
    k2 = plf_tree_bwd_mxu(*args, **kw)
    ks, note = [k1], ""
    if chunks:
        budget = chunking["bytes"] // 4
        ks.append(plf_tree_bwd_mxu(*args, max_scratch_bytes=budget, **kw))
        small = dict(plf_tree_bwd_mxu.last_scratch)
        check(small["chunks"] > 1, f"budget {budget} gave one chunk")
        note = (f" and {small['chunks']} chunks of {small['chunk_sites']} "
                f"sites under a {budget / 1e9:.2f} GB budget")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    p, plain_ms = timed(lambda: plf_tree_bwd_mxu_torch(*args, **kw))
    check(all(torch.equal(u, v) for u, v in zip(k1, k2)),
          f"kernel 4m ({label}) differs between two runs")
    errs = [max([sums_err(k[i], p[i]) for i in range(3)]
                + [sums_err(k[3].reshape(1, -1, 1), p[3].reshape(1, -1, 1))])
            for k in ks]
    check(max(errs) <= SUM_RTOL, f"kernel 4m ({label}) vs plain: {errs} of "
          f"scale > {SUM_RTOL}")
    abs_err = max(float((u - v).abs().max()) for u, v in zip(k1, p))
    del k1, k2, ks, p
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: plf_tree_bwd_mxu(*args, **kw), reps=3, warmup=1)
    bd = tree_bwd_bound(pm, variant)
    phase("kernel4m", f"{label}, {variant}: {len(pm.schedule)} nodes x "
          f"{pm.n_sites} sites, S={cfg.states}: gl/gr/gec/grr within "
          f"{max(errs):.2e} of scale of plain (max abs {abs_err:.3g}), "
          f"bit-identical run to run; {chunking['chunks']} chunk of "
          f"{chunking['chunk_sites']} sites, {chunking['blocks']} blocks "
          f"on {chunking['tile_sites']}-site tiles, "
          f"{chunking['bytes'] / 1e9:.2f} GB scratch{note}, accumulators "
          f"in {'shared' if chunking['acc_shared'] else 'device'} memory; "
          f"kernel {ms:.3f} ms (bound {bd['bound_ms']:.3f} ms by "
          f"{bd['bound_by']}), plain {plain_ms:.1f} ms; peak {peak:.2f} GiB")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=abs_err, **bd)


def random_codon_tips():
    """The codon workload's tips: random sense codons with 2% gap codes."""
    rng = np.random.default_rng(7)
    tips = rng.integers(0, 61, size=(CODON_TAXA, CODON_SITES))
    tips[rng.random(tips.shape) < 0.02] = 61
    return tips


def codon_workload(dev):
    """32 taxa x 65,536 codons, GY94 kappa=2 omega=0.3 + Gamma4 alpha=0.7,
    random sense codons with 2% gap codes; one model per variant."""
    tree = random_tree(CODON_TAXA, seed=3)
    tips = random_codon_tips()
    gy = codon_gy94(kappa=2.0, omega=0.3)
    t0 = time.perf_counter()
    models = {v: PhyloModel(tree, gy, tips, alpha=0.7, device=dev,
                            config=PLFConfig(states=61, kernel_variant=v))
              for v in ("mxu", "mxu_3x")}
    torch.cuda.synchronize()
    pm = models["mxu"]
    phase("data", f"codon: {CODON_TAXA} taxa x {CODON_SITES} codons, "
          f"GY94+G4, {len(pm.schedule)} PLF nodes, {pm.n_slots} arena "
          f"slots, {pm.tip_table.shape[1]} tip codes; two models built in "
          f"{time.perf_counter() - t0:.1f} s")
    return tree, tips, gy, models


def kernel4m_phase(models, codon, dev):
    """Kernel 4m against its plain version: each variant on the protein
    workload with the default model's step cotangent ("mxu_3x" also in
    several chunks), then "mxu" and "mxu_3x" at S = 61 on the first 8,192
    codons of the codon workload."""
    glik = step_cotangent(models["mxu_3x"])
    res = {}
    for variant in ("mxu_3x", "mxu", "mxu_bf16"):
        res[variant] = kernel4m_against_plain(
            models[variant], glik, "protein", chunks=variant == "mxu_3x")
    tree, tips, gy, _ = codon
    for variant in ("mxu", "mxu_3x"):
        pm = PhyloModel(tree, gy, tips[:, :CODON_K4_SITES], alpha=0.7,
                        device=dev,
                        config=PLFConfig(states=61, kernel_variant=variant))
        res[f"s61_{variant}"] = kernel4m_against_plain(
            pm, step_cotangent(pm), "codon", chunks=variant == "mxu")
        del pm
    torch.cuda.empty_cache()
    return res


def _step_launches(fn, t0, dev):
    """One value-and-gradient step and the kernel launches it made."""
    _reset_counts()
    v, g = _grad_step(fn, t0, dev)
    return v, g, {k: c for k, c in _counts().items() if c}


def _grad_bar(g, ref):
    """|g - ref| against rtol 2e-4 + atol 1e-4 x max|ref| (1.0 = at the
    bar), the JAX package's gradient tolerance."""
    return float(np.max(np.abs(g - ref) / (2e-4 * np.abs(ref)
                                           + 1e-4 * np.abs(ref).max())))


def protein_train_phase(tree, tips, models, dev):
    """The protein training main path on the default model: "tree" (kernel
    2m once, kernel 4m once per step), checked against log_likelihood(),
    the "mxu" model, float64 central differences and the "torch" backend;
    then optimize_branch_lengths and optimize_alpha."""
    out, launches = {}, None
    want = {"plf_tree_mxu": 1, "plf_tree_bwd_mxu": 1}
    for variant in ("mxu_3x", "mxu"):
        pm = models[variant]
        fn, t0 = tree_loglik_fn(pm)
        check((fn.engine, fn.variant) == ("tree", variant),
              f"auto took {fn.engine!r} / {fn.variant!r} for {variant}")
        v, g, counts = _step_launches(fn, t0, dev)
        check(counts == want, f"{variant} step launched {counts}, not {want}")
        if launches is None:
            launches = counts
        ref = pm.log_likelihood().log_likelihood
        rel = abs(v - ref) / abs(ref)
        check(rel < 1e-5, f"{variant} value {v} vs log_likelihood() {ref}")
        ms = _median_ms(lambda: _grad_step(fn, t0, dev), reps=3)
        out[variant] = g.cpu().numpy()
        phase("protein_train", f"{variant}: auto takes 'tree'; value {v:.3f} "
              f"(rel {rel:.2e} to log_likelihood()), one value+gradient step "
              f"{ms:.2f} ms wall (median of 3), launches {counts}")
        out[f"{variant}_ms"] = ms
    err = _grad_bar(out["mxu_3x"], out["mxu"])
    phase("protein_train", f"mxu_3x gradient vs mxu: {err:.3f} of the rtol "
          f"2e-4 / atol 1e-4 x max|g| bar (max|g| "
          f"{np.abs(out['mxu']).max():.4g}; printed, not checked: the two "
          f"variants differ in arithmetic)")

    lg = empirical_protein("lg")
    sub_tips = tips[:, :FD_SITES]
    cfg = PLFConfig(states=20, kernel_variant="mxu")
    sub = PhyloModel(tree, lg, sub_tips, alpha=0.5, device=dev, config=cfg)
    grads = {}
    for backend in ("tree", "torch"):
        fn, t0 = tree_loglik_fn(sub, backend=backend)
        grads[backend] = _grad_step(fn, t0, dev)[1].cpu().numpy()
    g = grads["tree"]
    err = _grad_bar(g, grads["torch"])
    check(err <= 1.0, f"mxu tree vs torch gradient: {err} of the bar")
    h = 1e-4
    fds = []
    for i in (0, 1, tree.n_leaves):
        ll = []
        for d in (h, -h):
            tr = copy.deepcopy(tree)
            tr.nodes[i].length += d
            ll.append(PhyloModel(tr, lg, sub_tips, alpha=0.5, device=dev,
                                 config=cfg).log_likelihood_bruteforce())
        fd = (ll[0] - ll[1]) / (2 * h)
        fds.append(f"branch {i}: {g[i]:.6g} vs {fd:.6g}")
        check(abs(g[i] - fd) <= 1e-3 * abs(fd),
              f"mxu tree gradient vs float64 differences, {fds[-1]}")
    phase("protein_train", f"{FD_SITES}-site sub-alignment, mxu: tree vs "
          f"torch gradient within {err:.3f} of the rtol 2e-4 / atol 1e-4 x "
          f"max|g| bar; vs float64 central differences (h {h}) of the "
          f"brute force within rel 1e-3: " + "; ".join(fds))

    pm = models["mxu_3x"]
    t_opt, ll0, ll1 = optimize_branch_lengths(pm, steps=5)
    check(ll1 > ll0 and np.all(t_opt > 0),
          f"optimize_branch_lengths: {ll0} -> {ll1}")
    alpha, a0, a1 = optimize_alpha(pm, iters=8)
    check(np.isfinite(alpha) and 0.02 <= alpha <= 100.0 and a1 >= a0,
          f"optimize_alpha: {alpha} ({a0} -> {a1})")
    phase("protein_train", f"mxu_3x optimize_branch_lengths(steps=5): "
          f"{ll0:.3f} -> {ll1:.3f}; optimize_alpha(iters=8): alpha "
          f"{alpha:.4f}, {a0:.3f} -> {a1:.3f}")
    return launches, {v: out[f"{v}_ms"] for v in ("mxu_3x", "mxu")}


def _fused_vs_per_node(pm):
    """(fused result, its wall ms, rel distance from the per-node path,
    whether the two rescale totals are equal)."""
    t0 = time.perf_counter()
    fused = pm.log_likelihood()
    wall = (time.perf_counter() - t0) * 1e3
    pernode = pm.log_likelihood(method="per-node")
    rel = abs(fused.log_likelihood - pernode.log_likelihood) / abs(
        pernode.log_likelihood)
    return fused, wall, rel, fused.scaler_total == pernode.scaler_total


def codon_phase(codon, dev):
    """The codon paths on the random-codon workload, then on an alignment
    simulated under GY94.  Random codons: fused vs per-node, one "tree"
    step per variant (kernel 2m once, kernel 4m once) and its value, the
    "mxu_3x" drift from "mxu" (printed); on the first 1,024 codons each
    path equals the port's plain versions on the CPU site for site (which
    equal the JAX package's in "mxu_3x", tests/test_torch_codon.py), and
    the distances from the float64 brute force, which the JAX package
    shows too, are held within twice the plain versions' own
    (RANDOM_CODON_DISTANCES).
    Simulated codons: fused vs per-node with equal rescale totals, the
    brute force and one step's value in both variants, and fit_codon,
    which must recover the omega and kappa it was simulated under."""
    tree, tips, gy, models = codon
    lls, want = {}, {"plf_tree_mxu": 1, "plf_tree_bwd_mxu": 1}
    dist = RANDOM_CODON_DISTANCES
    for variant in ("mxu", "mxu_3x"):
        pm = models[variant]
        fused, wall, rel, same_sc = _fused_vs_per_node(pm)
        bar = 1e-12 if variant == "mxu" else 2 * dist["per_node_mxu_3x"]
        check(np.isfinite(fused.log_likelihood) and rel < bar
              and (variant != "mxu" or same_sc),
              f"codon {variant} fused vs per-node: rel {rel}, equal "
              f"rescale totals {same_sc}")
        fn, t_0 = tree_loglik_fn(pm)
        v, _, counts = _step_launches(fn, t_0, dev)
        ref = fused.log_likelihood
        rs = abs(v / ref - 1)
        check(fn.engine == "tree" and counts == want
              and rs < 2 * dist["step"],
              f"codon {variant} step ({fn.engine}) launched {counts}, "
              f"value rel {rs} to log_likelihood()")
        ms = _median_ms(lambda: _grad_step(fn, t_0, dev), reps=3)
        floored = int((fused.site_log_likelihood
                       <= np.log(LIK_FLOOR) + 1e-6).sum())
        lls[variant] = ref
        phase("codon", f"random codons, {variant}: log_likelihood() "
              f"{ref:.3f} in {wall:.2f} ms wall, {floored} sites at the "
              f"log's floor; fused vs per-node rel {rel:.2e} < {bar:.3g} "
              f"(equal rescale totals: {same_sc}); one 'tree' step "
              f"{ms:.2f} ms wall (median of 3), value {v:.3f} (rel "
              f"{rs:.2e} < {2 * dist['step']:.3g}), launches {counts}")
    drift = abs(lls["mxu_3x"] / lls["mxu"] - 1)
    sub_tips = tips[:, :CODON_BRUTE_SITES]
    bf, out = None, []
    for v in ("mxu", "mxu_3x"):
        cfg = PLFConfig(states=61, kernel_variant=v)
        res = {}
        for where in (dev, "cpu"):
            m = PhyloModel(tree, gy, sub_tips, alpha=0.7, device=where,
                           config=cfg)
            res[where] = [m.log_likelihood(method=k)
                          for k in ("fused", "per-node")]
        if bf is None:
            bf = m.log_likelihood_bruteforce()
        same = all(np.array_equal(a.site_log_likelihood, b.site_log_likelihood)
                   and a.scaler_total == b.scaler_total
                   for a, b in zip(res[dev], res["cpu"]))
        r = abs(res[dev][0].log_likelihood - bf) / abs(bf)
        bf_bar = 2 * dist[f"bf_{v}"]
        check(same and r < bf_bar,
              f"random codons, {CODON_BRUTE_SITES}-codon slice, {v}: card "
              f"== CPU plain versions {same}; vs float64 brute force rel "
              f"{r} (bar {bf_bar})")
        out.append(f"{v} fused and per-node == CPU plain versions site for "
                   f"site; vs brute force rel {r:.2e} < {bf_bar:.3g}")
    phase("codon", f"random codons: mxu_3x drift from mxu {drift:.3e} "
          f"(printed); {CODON_BRUTE_SITES}-codon slice, float64 brute force "
          f"{bf:.3f}: " + "; ".join(out))

    ftree = random_tree(CODON_TAXA, seed=5, mean_branch=0.2)
    truth = codon_gy94(4.0, 0.2)
    ftips = simulate_alignment(ftree, truth, FIT_CODONS, seed=3)
    out = []
    for v, bar, bf_bar in (("mxu", 1e-12, 1e-5), ("mxu_3x", 1e-5, 1e-4)):
        cfg = PLFConfig(states=61, kernel_variant=v)
        pm = PhyloModel(ftree, truth, ftips, device=dev, config=cfg)
        fused, _, rel, same_sc = _fused_vs_per_node(pm)
        fn, t_0 = tree_loglik_fn(pm)
        step, _, counts = _step_launches(fn, t_0, dev)
        rs = abs(step / fused.log_likelihood - 1)
        brute = PhyloModel(ftree, truth, ftips[:, :CODON_BRUTE_SITES],
                           device=dev, config=cfg)
        if v == "mxu":
            bf = brute.log_likelihood_bruteforce()
        r = abs(brute.log_likelihood().log_likelihood - bf) / abs(bf)
        check(rel < bar and same_sc and r < bf_bar and rs < 1e-5
              and counts == want,
              f"simulated codons, {v}: fused vs per-node rel {rel}, vs "
              f"float64 brute force rel {r}, step value rel {rs}, step "
              f"launches {counts}")
        out.append(f"{v} fused {fused.log_likelihood:.3f} vs per-node rel "
                   f"{rel:.2e} < {bar:g}, vs brute force rel {r:.2e} < "
                   f"{bf_bar:g}, one step's value rel {rs:.2e} < 1e-5")
    phase("codon", f"simulated codons ({CODON_TAXA} x {FIT_CODONS}, omega "
          f"0.2, kappa 4; brute force on {CODON_BRUTE_SITES}): "
          + "; ".join(out))
    cfg = PLFConfig(states=61, kernel_variant="mxu")
    t0 = time.perf_counter()
    _, info = fit_codon(ftree, ftips, config=cfg, rounds=2, iters=8,
                        length_steps=30)
    wall = time.perf_counter() - t0
    null = PhyloModel(info["tree"], codon_gy94(info["kappa"], 1.0,
                                               info["pi"]),
                      ftips, device=dev, config=cfg).log_likelihood()
    check(0.08 < info["omega"] < 0.45 and 2.0 < info["kappa"] < 8.0,
          f"fit_codon: omega {info['omega']}, kappa {info['kappa']}")
    check(info["ll"] > null.log_likelihood,
          f"fit_codon ll {info['ll']} <= omega=1 null {null.log_likelihood}")
    phase("codon", f"fit_codon (mxu; rounds 2, iters 8, 30 length steps): "
          f"omega {info['omega']:.4f}, kappa {info['kappa']:.3f}, ll "
          f"{info['ll']:.3f} > omega=1 null {null.log_likelihood:.3f}; "
          f"{wall:.1f} s wall")
    return drift


# ----------------------------------------------------------------- infer --

INFER_TAXA = 128
INFER_SITES = 1 << 14
INFER_SEED = 17
INFER_BOOTSTRAP = 10
INFER_PROT_TAXA, INFER_PROT_SITES = 32, 4096
INFER_CODON_TAXA, INFER_CODONS = 16, 512
INFER_GTR_TAXA, INFER_GTR_SITES = 32, 4096
#: A batch row against the candidate's own log_likelihood(): fp32 chunk
#: sums of the per-site logs against the host's float64 sum.
BATCH_LL_RTOL = 1e-6


class RoundClock:
    """Times the rounds of the searches run inside it, from this script
    (the package is untouched): a round's wall runs from the generation of
    its neighbourhood (``search.nni_neighbors``) to the return of its
    scores (``search.batch_log_likelihood``, which reads them back to the
    host), and CUDA events around the batched launch and its epilogue
    (``phylo.batched_tree_loglik_parts``) give its device time.  The first
    round's models are kept for the checks."""

    def __init__(self):
        self.starts, self.walls, self.sizes, self.events = [], [], [], []
        self.first = None

    def __enter__(self):
        real = (search_mod.nni_neighbors, search_mod.batch_log_likelihood,
                phylo_mod.batched_tree_loglik_parts)
        self._real = real

        def neighbours(*a, **k):
            self.starts.append(time.perf_counter())
            return real[0](*a, **k)

        def score(pms):
            if self.first is None:
                self.first = list(pms)
            out = real[1](pms)
            self.walls.append(1e3 * (time.perf_counter() - self.starts[-1]))
            self.sizes.append(len(pms))
            return out

        def device(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = real[2](*a, **k)
            ev[1].record()
            self.events.append(ev)
            return out

        search_mod.nni_neighbors = neighbours
        search_mod.batch_log_likelihood = score
        phylo_mod.batched_tree_loglik_parts = device
        return self

    def __exit__(self, *exc):
        (search_mod.nni_neighbors, search_mod.batch_log_likelihood,
         phylo_mod.batched_tree_loglik_parts) = self._real
        torch.cuda.synchronize()

    def rounds(self):
        """``(walls, device ms, host ms)`` of the rounds, in ms."""
        dev_ms = [a.elapsed_time(b) for a, b in self.events]
        return (self.walls, dev_ms,
                [w - d for w, d in zip(self.walls, dev_ms)])


def _batch_args(pms):
    """``(args, kw)`` of one batched launch (plf_tree_batch) over
    ``pms``."""
    pm0 = pms[0]
    cfg = pm0.config
    progs, lcs, rcs, planes, n_slots = batch_inputs(pms)
    kw = dict(n_slots=n_slots, states=cfg.states, categories=cfg.categories,
              variant=cfg.resolved_kernel_variant, planes=planes)
    return (pm0.codes, progs, lcs, rcs, pm0.ec, pm0.fused_tip_table,
            pm0.root_rows[0], pm0.n_sites), kw


def _batch_bound(pms):
    """The bound of one batched launch over ``pms``: the codes read once,
    B output rows written, B trees' operations."""
    pm0 = pms[0]
    cfg = pm0.config
    flops, rate = node_work(cfg.states, cfg.categories,
                            cfg.resolved_kernel_variant)
    B, E, n_pad = len(pms), len(pm0.schedule), pm0.n_pad
    code_bytes = pm0.codes.element_size() * pm0.tree.n_leaves
    return bound((code_bytes + 8 * B) * n_pad, B * E * flops * n_pad, rate)


def _batched_against(pms, counter, label, plain):
    """One round's candidates in one batched launch (kernel 2 or 2m) ==
    each candidate's single-tree launch bit for bit (likelihoods and
    scaler counts), and batch_log_likelihood's rows within BATCH_LL_RTOL
    of each candidate's own log_likelihood(); the round's first ``plain``
    candidates in one batched launch == the same rows of the round's
    launch and == the plain batch, bit for bit (the plain version takes
    ~0.15-0.5 s a candidate here, so not all 253).  Returns the kernels
    line's dict, measured on that batch of ``plain`` candidates (launch ms
    of 5 back to back, the plain batch's ms, their bound), with the whole
    round's launch ms and bound beside it, and its text."""
    pm0 = pms[0]
    S, C = pm0.config.states, pm0.config.categories
    variant = pm0.config.resolved_kernel_variant
    args, kw = _batch_args(pms)
    lik, sc = tree_mod.plf_tree_batch(*args, **kw)
    check(bool(torch.isfinite(lik).all()), f"{label}: non-finite rows")
    for b, pm in enumerate(pms):
        one, one_sc = plf_tree(
            pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
            pm.root_rows[0], pm.n_sites, n_slots=pm.n_slots,
            root_slot=pm.root_slot, states=S, categories=C, variant=variant,
            planes=pm._planes(),
            program=None if pm._matrix_form else pm.tree_program)
        check(torch.equal(lik[b], one[0]) and torch.equal(sc[b], one_sc[0]),
              f"{label}: batched row {b} != the single-tree kernel")
    lls = batch_log_likelihood(pms)
    own = np.array([pm.log_likelihood().log_likelihood for pm in pms])
    rel = float(np.max(np.abs(lls / own - 1)))
    check(rel < BATCH_LL_RTOL, f"{label}: batch lls vs log_likelihood() "
          f"rel {rel} >= {BATCH_LL_RTOL}")
    round_ms = cuda_ms(lambda: tree_mod.plf_tree_batch(*args, **kw), reps=5,
                       warmup=1)
    round_bd = _batch_bound(pms)
    sub = pms[:plain]
    sargs, skw = _batch_args(sub)
    lik_s, sc_s = tree_mod.plf_tree_batch(*sargs, **skw)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    lik_p, sc_p = tree_mod.plf_tree_batch_torch(*sargs, **skw)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    err = float((lik_s - lik_p).abs().max())
    check(torch.equal(lik_s, lik[:plain]) and torch.equal(sc_s, sc[:plain]),
          f"{label}: a batch of {plain} != the round's first rows")
    check(torch.equal(lik_s, lik_p) and torch.equal(sc_s, sc_p),
          f"{label}: batched {counter.__name__} != plain (max abs {err:g})")
    ms = cuda_ms(lambda: tree_mod.plf_tree_batch(*sargs, **skw), reps=5,
                 warmup=1)
    bd = _batch_bound(sub)
    B, E = len(pms), len(pm0.schedule)
    n_codes = pm0.tip_table.shape[1]
    n_slots = kw["n_slots"]
    if pm0._matrix_form:
        plan = tree_mod.tree_mxu_plan(pm0.codes.dtype, S, C, n_codes,
                                      n_slots, variant, pm0.n_pad, B)
    else:
        plan = tree_mod.tree_plan(pm0.codes.dtype, C, n_codes, n_slots,
                                  pm0.n_pad, B)
    text = (f"{B} candidates x {E} nodes x {pm0.n_sites} sites in one "
            f"launch == {B} single-tree launches bit for bit "
            f"({int(sc.sum())} rescales); batch lls within rel {rel:.1e} of "
            f"each log_likelihood(); {args[2].shape[0]} operator pairs for "
            f"{B * E} ops; grid {plan['grid']}, {plan['threads']} threads, "
            f"{plan['slots']} slots, {plan['blocks_per_sm']} blocks per SM; "
            f"the round's launch {round_ms:.3f} ms (bound "
            f"{round_bd['bound_ms']:.4f} ms by {round_bd['bound_by']}, "
            f"{round_bd['bound_ms'] / round_ms:.1%}); its first {plain} "
            f"candidates in one launch == those rows == plain: kernel "
            f"{ms:.3f} ms (bound {bd['bound_ms']:.4f} ms), plain batch "
            f"{plain_ms:.1f} ms")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                round_ms=round_ms, round_bound_ms=round_bd["bound_ms"],
                **bd), text


def _variant_batch(pms, variant, dev):
    """The same candidates as ``pms`` under another kernel variant."""
    pm0 = pms[0]
    cfg = PLFConfig(states=pm0.config.states, kernel_variant=variant)
    kw = dict(wgt=pm0.wgt, rates=pm0.rates, config=cfg, device=dev)
    first = PhyloModel(pm0.tree, pm0.model, pm0.tip_states, **kw)
    return [first] + [PhyloModel(pm.tree, pm0.model, pm0.tip_states,
                                 share_device_from=first, **kw)
                      for pm in pms[1:]]


def _cli_infer(argv, label):
    """``python -m plf_tpu_torch infer`` through ``main()`` in this process
    (so its launches count), its output kept: ``(exit code, output, wall
    s, launches)``."""
    from plf_tpu_torch.__main__ import main as cli_main
    buf = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["infer", *argv])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    check(rc == 0, f"{label}: infer exited {rc}:\n{text[-2000:]}")
    return text, wall, {k: v for k, v in _counts().items() if v}


def _fasta(path, rows, alphabet):
    with open(path, "w") as f:
        for i, row in enumerate(rows):
            f.write(f">t{i}\n" + "".join(alphabet[c] for c in row) + "\n")


def _codon_fasta(path):
    """The GY94 codon FASTA of phases ``infer`` and ``analyses`` (16 taxa
    x 512 codons, kappa 3, omega 0.3); returns the true tree."""
    ctrue = random_tree(INFER_CODON_TAXA, seed=INFER_SEED, mean_branch=0.2)
    _fasta(path, simulate_alignment(ctrue, codon_gy94(3.0, 0.3),
                                    INFER_CODONS, seed=INFER_SEED),
           SENSE_CODONS)
    return ctrue


def infer_phase(dev):
    """The inference workflow (``run_inference``, ``python -m
    plf_tpu_torch infer``), each run with every count set to 0 just
    before it and read just after.

    DNA at full width: HKY85+G4 (alpha 0.5) simulated on random_tree(128),
    16,384 sites; NJ start, lengths, NNI search (each round one launch of
    kernel 2 with a candidate axis: 253 candidates), alpha, lengths,
    bootstrap 10.  One round's batched rows == single-tree kernel 2 bit
    for bit (its first 16 candidates == the plain version too), its batch
    lls within BATCH_LL_RTOL of
    each log_likelihood(); the final ll within 1e-6 of the float64 brute
    force and at least the NJ start's; RF to the true tree, rounds, host
    and device ms a round, launches.  Protein: LG+G4 on 32 taxa x 4,096
    sites, default config ("mxu_3x"): kernel 2m batched, its first round
    == single 2m (and its first 8 candidates == plain) in every variant.  Codon and GTR through the
    CLI: GY94 on 16 taxa x 512 codons (--model gy94: fit_codon, kernel 2m
    at S = 61), GTR on 32 x 4,096 with --bootstrap 10 (fit_model on the
    card), each newick parsed back."""
    out = {}
    true = random_tree(INFER_TAXA, seed=INFER_SEED)
    model = hky85(2.0)
    codes = simulate_alignment(true, model, INFER_SITES, alpha=0.5,
                               seed=INFER_SEED)
    names = true.leaf_names()
    msgs = []
    _reset_counts()
    t0 = time.perf_counter()
    with RoundClock() as clock:
        res = run_inference(codes, names=names, model=model, alpha=0.5,
                            search="nni", fit="lengths+alpha",
                            bootstrap=INFER_BOOTSTRAP,
                            progress=msgs.append, device=dev)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in _counts().items() if v}
    walls, dev_ms, host_ms = clock.rounds()
    rounds = len(walls)
    check(rounds >= 1 and counts.get("plf_tree_batch") == rounds,
          f"DNA infer: {rounds} rounds, launches {counts}")
    start = float(re.search(r"starting ll = (-?[0-9.]+)",
                            "\n".join(msgs)).group(1))
    pats, wgt = compress_patterns(codes)
    order = [names.index(nm) for nm in res.tree.leaf_names()]
    final = PhyloModel(res.tree, model, pats[order], wgt=wgt,
                       alpha=res.alpha, device=dev)
    ll = final.log_likelihood().log_likelihood
    bf = final.log_likelihood_bruteforce()
    rel_bf = abs(ll - bf) / abs(bf)
    rf = rf_distance(res.tree, true)
    check(abs(ll / res.log_likelihood - 1) < 1e-12 and rel_bf < 1e-6
          and res.log_likelihood >= start,
          f"DNA infer: final ll {res.log_likelihood} (model {ll}) vs "
          f"float64 brute force {bf} (rel {rel_bf}), NJ start {start}")
    parse_newick(res.newick)
    phase("infer", f"DNA {INFER_TAXA} taxa x {INFER_SITES} sites "
          f"({final.n_sites} patterns), HKY85+G4: run_inference (nni, "
          f"lengths+alpha, bootstrap {INFER_BOOTSTRAP}) {wall:.1f} s wall; "
          f"NJ start ll {start:.3f} -> final {res.log_likelihood:.3f} "
          f"(alpha {res.alpha:.4f}; float64 brute force rel "
          f"{rel_bf:.1e}); RF to the true tree {rf}; {rounds} rounds, "
          f"{sum(clock.sizes)} candidates ({clock.sizes[0]} a round); a "
          f"round's wall {np.median(walls):.1f} ms = host "
          f"{np.median(host_ms):.1f} + device (kernel 2 batched and its "
          f"epilogue) {np.median(dev_ms):.2f} ms (medians; host "
          f"{min(host_ms):.1f}-{max(host_ms):.1f}); launches {counts}")
    out["plf_tree_batch"], text = _batched_against(
        clock.first, tree_mod.plf_tree_batch, "DNA round 1", plain=16)
    out["plf_tree_batch"]["launches"] = counts["plf_tree_batch"]
    out["dna"] = dict(wall_s=wall, rounds=rounds, rf=rf,
                      host_ms=float(np.median(host_ms)),
                      device_ms=float(np.median(dev_ms)), counts=counts)
    phase("infer", f"DNA round 1: {text}")
    del clock, final
    torch.cuda.empty_cache()

    ptrue = random_tree(INFER_PROT_TAXA, seed=INFER_SEED)
    lg = empirical_protein("lg")
    pcodes = simulate_alignment(ptrue, lg, INFER_PROT_SITES, alpha=0.5,
                                seed=INFER_SEED)
    _reset_counts()
    t0 = time.perf_counter()
    with RoundClock() as clock:
        pres = run_inference(pcodes, names=ptrue.leaf_names(), model=lg,
                             alpha=0.5, search="nni", device=dev)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in _counts().items() if v}
    walls, dev_ms, host_ms = clock.rounds()
    check(counts.get("plf_tree_mxu_batch") == len(walls) >= 1
          and "plf_tree_batch" not in counts,
          f"protein infer: {len(walls)} rounds, launches {counts}")
    phase("infer", f"protein {INFER_PROT_TAXA} x {INFER_PROT_SITES}, LG+G4, "
          f"default config ({clock.first[0].config.resolved_kernel_variant})"
          f": {wall:.1f} s wall, ll {pres.log_likelihood:.3f}, RF to the "
          f"true tree {rf_distance(pres.tree, ptrue)}; {len(walls)} rounds "
          f"of {clock.sizes[0]}; a round's wall {np.median(walls):.1f} ms "
          f"= host {np.median(host_ms):.1f} + device "
          f"{np.median(dev_ms):.2f} ms (medians); launches {counts}")
    for variant in MXU_VARIANTS + ("vpu",):
        pms = (clock.first if variant == "mxu_3x"
               else _variant_batch(clock.first, variant, dev))
        r, text = _batched_against(pms, tree_mod.plf_tree_mxu_batch,
                                   f"protein round 1, {variant}", plain=8)
        phase("infer", f"protein round 1, {variant}: {text}")
        if variant == "mxu_3x":
            out["plf_tree_mxu_batch"] = dict(
                r, launches=counts["plf_tree_mxu_batch"])
        del pms
    del clock
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        fa, nwk = f"{tmp}/codon.fa", f"{tmp}/codon.nwk"
        ctrue = _codon_fasta(fa)
        text, wall, counts = _cli_infer(
            [fa, "--seq-type", "codon", "--model", "gy94", "--search",
             "nni", "--out", nwk], "codon")
        tree = parse_newick(open(nwk).read())
        fit = re.search(r"GY94 fit: kappa=([0-9.]+) omega=([0-9.]+)", text)
        check(sorted(tree.leaf_names()) == sorted(ctrue.leaf_names())
              and fit is not None and counts.get("plf_tree_mxu_batch", 0) > 0,
              f"codon infer: {fit}, launches {counts}")
        phase("infer", f"python -m plf_tpu_torch infer --seq-type codon "
              f"--model gy94 --search nni ({INFER_CODON_TAXA} taxa x "
              f"{INFER_CODONS} GY94 codons, kappa 3, omega 0.3): exit 0 in "
              f"{wall:.1f} s, kappa {fit.group(1)}, omega {fit.group(2)}, "
              f"RF to the true tree {rf_distance(tree, ctrue)}, "
              f"{re.search(r'final ll = (.*)', text).group(1).split()[0]}; "
              f"launches {counts}")
        out["codon"] = dict(wall_s=wall, counts=counts)

        gtrue = random_tree(INFER_GTR_TAXA, seed=INFER_SEED)
        gcodes = simulate_alignment(
            gtrue, gtr([1.0, 3.0, 0.8, 1.2, 3.5, 1.0],
                       [0.35, 0.15, 0.25, 0.25]),
            INFER_GTR_SITES, alpha=0.5, seed=INFER_SEED)
        fa, nwk = f"{tmp}/dna.fa", f"{tmp}/dna.nwk"
        _fasta(fa, gcodes, "ACGT")
        text, wall, counts = _cli_infer(
            [fa, "--model", "gtr", "--alpha", "0.5", "--bootstrap",
             str(INFER_BOOTSTRAP), "--out", nwk], "gtr")
        tree = parse_newick(open(nwk).read())
        labels = [int(n.name) for n in tree.nodes
                  if not n.is_leaf and n.name]
        check(sorted(tree.leaf_names()) == sorted(gtrue.leaf_names())
              and "GTR fit" in text and labels
              and all(0 <= x <= 100 for x in labels)
              and counts.get("plf_tree_batch", 0) > 0,
              f"gtr infer: labels {labels}, launches {counts}")
        phase("infer", f"python -m plf_tpu_torch infer --model gtr --alpha "
              f"0.5 --bootstrap {INFER_BOOTSTRAP} ({INFER_GTR_TAXA} x "
              f"{INFER_GTR_SITES} GTR+G4 sites): exit 0 in {wall:.1f} s, "
              f"{re.search(r'GTR fit: (.*)', text).group(1)}, "
              f"{len(labels)} support labels "
              f"({min(labels)}-{max(labels)}), RF to the true tree "
              f"{rf_distance(tree, gtrue)}; launches {counts}")
        out["gtr"] = dict(wall_s=wall, counts=counts)
    return out


# -------------------------------------------------------------- analyses --

ANALYSES_TAXA, ANALYSES_SITES = 128, 1 << 14
ANALYSES_SEED = 29
ANALYSES_PROT_TAXA, ANALYSES_PROT_SITES = 32, 4096
ALRT_REPLICATES = 1000
#: aLRT's first branches held to the float64 brute force, on a
#: sub-alignment of this many sites run through the same function.
ALRT_BRUTE_BRANCHES, ALRT_BRUTE_SITES = 4, 2048
ALRT_BRUTE_RTOL = 1e-6
#: Posteriors against the float64 pass of the same recursion, on the
#: first ANC_SITES sites: probabilities in fp32.  Site rates are held to
#: the CPU plain versions' run of the same model (kernels 1 and 1m equal
#: them bit for bit), and their distance from float64 is printed: the
#: root CLV's eigen-coordinate sums cancel, so a category's likelihood
#: carries fp32 rounding of the larger terms (3e-4 of a posterior in fp32
#: and 1e-2 in "mxu_3x" at 32 x 4,096 protein on the CPU).
ANC_SITES, ANC_ATOL = 512, 1e-5
PART_STEPS = 50


class Captured:
    """Keeps what ``model_select`` and ``run_inference`` return while the
    CLI runs inside it (``__main__`` imports both from
    ``plf_tpu_torch.models`` when it runs; the package is untouched)."""

    def __enter__(self):
        import plf_tpu_torch.models as M
        self._real = (M.model_select, M.run_inference)
        self.selection = self.inference = None

        def select(*a, **k):
            self.selection = self._real[0](*a, **k)
            return self.selection

        def infer(*a, **k):
            self.inference = self._real[1](*a, **k)
            return self.inference

        M.model_select, M.run_inference = select, infer
        return self

    def __exit__(self, *exc):
        import plf_tpu_torch.models as M
        M.model_select, M.run_inference = self._real


#: The port's examples (``examples/<name>.py``), run as a user runs them,
#: each in a process of its own at its default size on the card.
GRAFT_EXAMPLES = ("torch_quickstart", "torch_model_selection",
                  "torch_full_inference", "torch_codon_dnds")
#: The wrappers a rank of ``dryrun_multichip`` launches.
DRYRUN_KERNELS = ("plf_node", "plf_node_batch", "plf_tree", "plf_tree_bwd",
                  "plf_tree_mxu", "plf_tree_seg", "plf_tree_seg_bwd")

#: One example (argument: its path) run as ``__main__``, then the kernel
#: launches of its process, by wrapper, as the last line.
EXAMPLE_SCRIPT = """
import json, runpy, sys
from plf_tpu_torch.ops import launch_counts
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
print(json.dumps(launch_counts()), flush=True)
"""

#: ``dryrun_multichip(2, backend="gloo")`` (two ranks sharing the card) in
#: a process of its own: its lines, then its values as one JSON line.
GLOO_DRYRUN_SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
import __graft_entry_torch__ as g
print(json.dumps(g.dryrun_multichip(2, backend="gloo")), flush=True)
"""


def _example_checks(name, text):
    """What each example's output must show; returns the line to print."""
    if name == "torch_quickstart":
        ll = float(re.search(r"^log-likelihood = (\S+)", text, re.M).group(1))
        m = re.search(r"^branch-length optimisation: (\S+) -> (\S+)", text,
                      re.M)
        ll0, ll1 = float(m.group(1)), float(m.group(2))
        check(np.isfinite(ll) and ll1 > ll0, f"quickstart: ll {ll}, "
              f"optimisation {ll0} -> {ll1}")
        pats = re.search(r"^site patterns: .*$", text, re.M).group(0)
        return f"{pats}; ll {ll:.3f}, lengths {ll0:.3f} -> {ll1:.3f}"
    if name == "torch_model_selection":
        m = re.search(r"^selected by AICc: (\S+) \(alpha=(\S+)\)", text, re.M)
        best = m.group(1)
        check(best.split("+")[0] in ("HKY", "GTR") and "+G" in best,
              f"model selection chose {best} (simulated under HKY+G)")
        return f"selected {best} (alpha {float(m.group(2)):.3f}; the truth " \
               f"HKY+G, alpha 0.6)"
    if name == "torch_full_inference":
        newick = text.split("SH-aLRT annotated tree:\n")[1].splitlines()[0]
        tree = parse_newick(newick)
        rf = re.search(r"^RF distance to true tree: (\d+)", text, re.M)
        ll = re.search(r"^inferred ll = .*$", text, re.M).group(0)
        check(tree.n_leaves == 12 and rf is not None,
              f"full inference: {tree.n_leaves} taxa, rf {rf}")
        return f"{ll}; RF distance {rf.group(1)}; the newick parses back " \
               f"({tree.n_leaves} taxa)"
    m = re.search(r"^fitted: kappa=(\S+) omega=(\S+)", text, re.M)
    omega = float(m.group(2))
    check(omega < 1, f"codon example: omega {omega} (simulated at 0.2)")
    return f"kappa {float(m.group(1)):.3f}, omega {omega:.4f} (simulated " \
           f"4 / 0.2)"


def graft_phase(dev):
    """``__graft_entry_torch__.py`` and the port's examples on the card:

    * ``entry()``'s ``fn``: kernel 1 on 2,048 sites, == the golden model
      and == kernel 1's plain version bit for bit, one launch;
    * ``dryrun_multichip(cards)``: the ten checks of the JAX twin on one
      rank per card (one rank, in this process, on a one-card machine),
      launches counted;
    * ``dryrun_multichip(2, backend="gloo")``: two ranks sharing the card,
      every check held, the ranks agreeing; against the one-rank values
      (lls within rel 1e-6, scaler counts exact);
    * the four examples at their default sizes, each in a process of its
      own as a user runs it: quickstart's ll finite and raised by the
      length optimisation, model selection choosing HKY or GTR with +G
      (the truth: HKY+G, kappa 6), the full inference's newick parsing
      back with its RF distance printed, the codon fit's omega below 1
      (the truth: 0.2).
    The processes start together; this process runs ``entry()`` and the
    one-rank dry run meanwhile."""
    import os
    import __graft_entry_torch__ as graft
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    t0 = time.perf_counter()
    try:
        procs["gloo"] = subprocess.Popen(
            [sys.executable, "-c", GLOO_DRYRUN_SCRIPT, root],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in GRAFT_EXAMPLES:
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", EXAMPLE_SCRIPT,
                 os.path.join(root, "examples", f"{name}.py")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        _reset_counts()
        fn, args = graft.entry()
        x3, sc = fn(*args)
        torch.cuda.synchronize()
        counts = _counts()
        check(counts["plf_node"] == 1 and sum(counts.values()) == 1,
              f"entry() launched {counts}")
        x1, x2, left, right, ev = graft._example_case(2048)
        x3_ref, sv_ref, _ = plf_reference(x1, x2, left, right, ev)
        x3p, scp = plf_node_torch(*args)
        check(np.array_equal(L.from_lane_major(x3.cpu().numpy(), n=2048),
                             x3_ref)
              and np.array_equal(sc[0].cpu().numpy(), sv_ref.astype(np.int32)),
              "entry(): != golden model")
        check(torch.equal(x3, x3p) and torch.equal(sc, scp),
              "entry(): != kernel 1's plain version")
        phase("graft", f"entry(): kernel 1 on {tuple(x3.shape)}, launched "
              f"once, == golden model and == plain bit for bit "
              f"({int(sc.sum())} rescaled sites)")

        cards = torch.cuda.device_count()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            one = graft.dryrun_multichip(cards)
        for line in buf.getvalue().splitlines():
            phase("graft", line)
        _launched(one["launches"], DRYRUN_KERNELS,
                  f"dryrun_multichip({cards})")
        phase("graft", f"dryrun_multichip({cards}) launches: "
              f"{one['launches']}")

        outs = {}
        for name, p in procs.items():
            try:
                out, err = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            check(p.returncode == 0, f"{name} exited {p.returncode}:\n"
                  f"{out[-2000:]}\n{err[-3000:]}")
            outs[name] = out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0

    lines = outs["gloo"].strip().splitlines()
    two = json.loads(lines[-1])
    for line in lines[:-1]:
        phase("graft", line)
    for name in ("tree", "int8", "protein", "codon"):
        check(two[name]["scaler_total"] == one[name]["scaler_total"]
              and abs(two[name]["ll"] / one[name]["ll"] - 1) < 1e-6,
              f"gloo {name}: {two[name]} vs one rank {one[name]}")
    check(two["plf"]["scaler_inc"] == one["plf"]["scaler_inc"]
          and two["plf_batch"] == one["plf_batch"],
          "gloo plf / plf_batch differ from one rank")
    _launched(two["launches"], DRYRUN_KERNELS,
              "dryrun_multichip(2, gloo), rank 0")
    phase("graft", f"dryrun_multichip(2, backend='gloo'): both ranks "
          f"agree, every check held, == one rank (lls rel 1e-6, scaler "
          f"counts exact); rank 0 launches: {two['launches']}")
    total = {}
    for name in GRAFT_EXAMPLES:
        text = outs[name]
        counts = json.loads(text.strip().splitlines()[-1])
        launched = {k: v for k, v in counts.items() if v}
        check(launched, f"{name} launched no kernel")
        _merge(total, launched)
        phase("graft", f"examples/{name}.py: {_example_checks(name, text)}; "
              f"launches {launched}")
    phase("graft", f"examples' launches: {total}; the phase's processes "
          f"took {wall:.1f} s wall, started together")
    return dict(one=one, two=two, examples=total)


def _selection_table(text, label):
    """The AICc table, fit seconds and winner that ``infer --model auto``
    logs: ``(rows as (name, k, aicc), fit seconds text, winner, alpha)``."""
    table = text.split("model selection (AICc):\n")[1].split("\nfit ")[0]
    rows = [(r.split()[0], int(r.split()[2]), float(r.split()[4]))
            for r in table.splitlines()[1:]]
    secs = re.search(r"fit seconds: (.*)", text).group(1)
    sel = re.search(r"selected: (\S+) \(alpha=(\S+), p_inv", text)
    check(sel is not None, f"{label}: no 'selected:' line")
    alpha = None if sel.group(2) == "None" else float(sel.group(2))
    return rows, secs, sel.group(1), alpha


def _merge(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _launched(counts, names, label):
    check(all(counts.get(k, 0) > 0 for k in names),
          f"{label}: expected launches of {names}, got {counts}")


#: ``trace()`` of one model's ``log_likelihood()`` in a process of its own
#: (argument: a directory holding ``model.npz`` and ``model.json``).  On
#: the H100 machine a ``torch.profiler`` session late in this script's
#: process (after the kernels' libraries were built) recorded no device
#: activity, while one in a fresh process records every launch.
TRACE_SCRIPT = """
import json, sys
import numpy as np
from plf_tpu_torch import convert
from plf_tpu_torch.models import PhyloModel
from plf_tpu_torch.utils.profiling import trace
d = np.load(sys.argv[1] + "/model.npz")
meta = json.load(open(sys.argv[1] + "/model.json"))
pm = PhyloModel(convert.tree_from_nodes(meta["nodes"], meta["root"]),
                convert.substitution_model(d["pi"], d["eigenvalues"],
                                           d["u"], d["w"]),
                d["tips"], wgt=d["wgt"], alpha=meta["alpha"],
                p_inv=meta["p_inv"], device="cuda")
pm.log_likelihood()
with trace(sys.argv[1] + "/trace", device="cuda"):
    ll = pm.log_likelihood().log_likelihood
print(json.dumps({"ll": ll}))
"""


class TracedRun:
    """``TRACE_SCRIPT`` on a model passed by value, started at once in a
    process of its own; ``result()`` waits for it and returns the
    kernel-2 names in its ``trace.json``, the trace's event count and
    the model's ll there.  The process is killed if it is still running
    when the phase fails."""

    def __init__(self, path, tree, model, tips, wgt, alpha, p_inv):
        import os
        os.makedirs(path, exist_ok=True)
        np.savez(f"{path}/model.npz", pi=model.pi,
                 eigenvalues=model.eigenvalues, u=model.u, w=model.w,
                 tips=tips, wgt=wgt)
        with open(f"{path}/model.json", "w") as f:
            json.dump(dict(nodes=[(n.index, n.name, n.length, n.children)
                                  for n in tree.nodes], root=tree.root,
                           alpha=alpha, p_inv=p_inv), f)
        self.path = path
        self.proc = subprocess.Popen(
            [sys.executable, "-c", TRACE_SCRIPT, path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def result(self):
        try:
            out, err = self.proc.communicate(timeout=300)
        finally:
            self.stop()
        check(self.proc.returncode == 0, f"trace subprocess exited "
              f"{self.proc.returncode}:\n{err[-2000:]}")
        events = json.load(open(f"{self.path}/trace/trace.json")
                           )["traceEvents"]
        k2 = sorted({str(e.get("name"))[:80] for e in events
                     if "plf_tree_kernel" in str(e.get("name"))})
        return k2, len(events), json.loads(out.splitlines()[-1])["ll"]


def analyses_phase(dev):
    """The analyses around a tree, each run with every count set to 0
    just before it and read just after:

    * ``python -m plf_tpu_torch infer --model auto`` on 128 DNA taxa x
      16,384 sites (HKY85, kappa 4, pi 0.3/0.2/0.2/0.3, Gamma4 alpha
      0.5): the AICc table of all 10 DNA candidates, the winner HKY or GTR
      with +G and alpha in 0.35-0.7, each fit's seconds, the newick
      parsed back (kernels 2, 7, 8);
    * ``model_select`` over the 32-model protein ladder on 32 taxa x
      4,096 LG+G4 sites: LG with +G wins (kernels 2m, 4m);
    * ``infer --seq-type codon --model auto`` on phase infer's 16 x 512
      GY94 FASTA: GY94 and GY94+G in the table (kernels 2m, 4m);
    * SH-aLRT (``alrt_support``, 1,000 RELL replicates) on the DNA tree
      parsed back under the fitted model: 126 branches (every internal
      node but the root), kernel 2 a tree; the first
      branches' alternatives on a 2,048-site sub-alignment equal the
      float64 brute force;
    * ``ancestral_marginal`` and ``site_rates`` on that DNA model and on
      the default protein LG+G4 model: rows sum to 1, posteriors equal a
      float64 pass on the first 512 sites (with TF32 switched on around
      ``ancestral_marginal``), ``site_rates`` one launch of kernel 1 or 1m
      an internal node;
    * a partitioned model (the DNA alignment's three codon positions,
      HKY85+G4 each with its own alpha): ``log_likelihood()`` == the sum
      of the three PhyloModels bit for bit, ``loglik_fn`` at t0 within
      rel 1e-5 of it, ``optimize(steps=50)`` raises the ll.

    The phase runs under ``PhaseProfiler`` (its report printed), and a
    ``trace()`` of one aLRT alternative names kernel 2's launch."""
    from plf_tpu_torch.models import (DNA_CANDIDATES, PROTEIN_CANDIDATES,
                                      Partition, PartitionedModel,
                                      alrt_support, ancestral_marginal,
                                      model_select, nj_tree, site_rates)
    from plf_tpu_torch.models import support as support_mod
    from plf_tpu_torch.models.ancestral import ancestral_bruteforce
    from plf_tpu_torch.models.search import _rebuild
    from plf_tpu_torch.models.pipeline import _with_lengths
    from plf_tpu_torch.utils.profiling import PhaseProfiler

    prof = PhaseProfiler(device=dev)
    total = {}
    out = {}
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.ExitStack() as cleanup:
        # -- DNA: infer --model auto --------------------------------------
        true = random_tree(ANALYSES_TAXA, seed=ANALYSES_SEED)
        model = hky85(4.0, [0.3, 0.2, 0.2, 0.3])
        codes = simulate_alignment(true, model, ANALYSES_SITES, alpha=0.5,
                                   seed=ANALYSES_SEED)
        names = true.leaf_names()
        fa, nwk = f"{tmp}/dna.fa", f"{tmp}/dna.nwk"
        _fasta(fa, codes, "ACGT")
        with prof.range("select_dna"), Captured() as cap:
            text, wall, counts = _cli_infer([fa, "--model", "auto", "--out",
                                             nwk], "DNA auto")
        _merge(total, counts)
        rows, secs, best, alpha = _selection_table(text, "DNA auto")
        tree = parse_newick(open(nwk).read())
        base, *flags = best.split("+")
        check(sorted(r[0] for r in rows) == sorted(DNA_CANDIDATES)
              and base in ("HKY", "GTR") and "G" in flags
              and alpha is not None and 0.35 <= alpha <= 0.7
              and sorted(tree.leaf_names()) == sorted(names),
              f"DNA auto: winner {best}, alpha {alpha}, rows {rows}")
        _launched(counts, ("plf_tree", "plf_tree_seg", "plf_tree_seg_bwd"),
                  "DNA auto")
        sel_s = sum(f.seconds for f in cap.selection.fits)
        phase("analyses", f"python -m plf_tpu_torch infer --model auto "
              f"({ANALYSES_TAXA} taxa x {ANALYSES_SITES} HKY85+G4 sites): "
              f"exit 0 in {wall:.1f} s (selection {sel_s:.1f} s); winner "
              f"{best}, alpha {alpha:.4f}, final ll "
              f"{cap.inference.log_likelihood:.3f}, RF to the true tree "
              f"{rf_distance(tree, true)}; launches {counts}")
        print("AICc table (DNA):\n" + cap.selection.table(), flush=True)
        phase("analyses", f"DNA fit seconds: {secs}")
        out["dna"] = dict(wall_s=wall, select_s=sel_s, winner=best,
                          counts=counts)
        # one alternative that aLRT scores (the NNI around the first
        # internal branch), traced in a process of its own while the
        # phase goes on
        res = cap.inference
        pats, wgt = compress_patterns(codes)
        order = [names.index(nm) for nm in tree.leaf_names()]
        tips = pats[order]
        d = next(nd.index for nd in tree.nodes
                 if not nd.is_leaf and nd.index != tree.root)
        parent = next(nd for nd in tree.nodes if d in nd.children)
        s_ = next(c for c in parent.children if c != d)
        x, y = tree.nodes[d].children
        alt = _rebuild(tree, {parent.index: tuple(x if c == s_ else c
                                                  for c in parent.children),
                              d: (s_, y)})
        traced = TracedRun(f"{tmp}/alt", alt, res.model, tips, wgt,
                           res.alpha, res.p_inv)
        cleanup.callback(traced.stop)

        # -- protein: model_select over the 32-model ladder ---------------
        ptrue = random_tree(ANALYSES_PROT_TAXA, seed=ANALYSES_SEED)
        lg = empirical_protein("lg")
        pcodes = simulate_alignment(ptrue, lg, ANALYSES_PROT_SITES,
                                    alpha=0.5, seed=ANALYSES_SEED)
        ppats, pwgt = compress_patterns(pcodes)
        _reset_counts()
        t0 = time.perf_counter()
        with prof.range("select_protein"):
            pstart = nj_tree(ppats, pwgt, states=20, device=dev)
            psel = model_select(pstart, ppats, wgt=pwgt,
                                config=PLFConfig(states=20), device=dev)
        pwall = time.perf_counter() - t0
        counts = {k: v for k, v in _counts().items() if v}
        _merge(total, counts)
        pbest = psel.best
        check(sorted(f.name for f in psel.fits) == sorted(PROTEIN_CANDIDATES)
              and pbest.name.split("+")[0] == "LG"
              and "G" in pbest.name.split("+")[1:],
              f"protein selection: winner {pbest.name}")
        _launched(counts, ("plf_tree_mxu", "plf_tree_bwd_mxu"),
                  "protein selection")
        print("AICc table (protein):\n" + psel.table(), flush=True)
        phase("analyses", f"model_select, {len(psel.fits)} protein models "
              f"({ANALYSES_PROT_TAXA} x {ANALYSES_PROT_SITES} LG+G4 sites, "
              f"{ppats.shape[1]} patterns): {pwall:.1f} s; winner "
              f"{pbest.name} (alpha {pbest.alpha}); fit seconds "
              + ", ".join(f"{f.name} {f.seconds:.2f}" for f in psel.fits)
              + f"; launches {counts}")
        out["protein"] = dict(wall_s=pwall, winner=pbest.name,
                              counts=counts)

        # -- codon: infer --seq-type codon --model auto -------------------
        cfa = f"{tmp}/codon.fa"
        _codon_fasta(cfa)
        with prof.range("select_codon"):
            ctext, cwall, counts = _cli_infer(
                [cfa, "--seq-type", "codon", "--model", "auto"],
                "codon auto")
        _merge(total, counts)
        crows, csecs, cbest, _ = _selection_table(ctext, "codon auto")
        check(sorted(r[0] for r in crows) == ["GY94", "GY94+G"],
              f"codon auto: rows {crows}")
        _launched(counts, ("plf_tree_mxu", "plf_tree_bwd_mxu"), "codon auto")
        phase("analyses", f"python -m plf_tpu_torch infer --seq-type codon "
              f"--model auto ({INFER_CODON_TAXA} x {INFER_CODONS} GY94 "
              f"codons): exit 0 in {cwall:.1f} s; table "
              + ", ".join(f"{n} k={k} AICc={a:.2f}" for n, k, a in crows)
              + f"; winner {cbest}; fit seconds {csecs}; launches {counts}")
        out["codon"] = dict(wall_s=cwall, counts=counts)

        # -- SH-aLRT on the DNA tree under the fitted model ---------------
        _reset_counts()
        t0 = time.perf_counter()
        with prof.range("alrt"):
            sup = alrt_support(tree, res.model, tips, wgt=wgt,
                               alpha=res.alpha, p_inv=res.p_inv,
                               rell_replicates=ALRT_REPLICATES, seed=0,
                               device=dev)
        awall = time.perf_counter() - t0
        counts = {k: v for k, v in _counts().items() if v}
        _merge(total, counts)
        # every internal node but the root: the two root edges are one
        # unrooted branch, scored twice, as the JAX package scores it
        n_int = ANALYSES_TAXA - 2
        check(len(sup) == n_int and counts.get("plf_tree") == 1 + 2 * n_int,
              f"aLRT: {len(sup)} branches, launches {counts}")
        shs = np.array([sh for _, sh in sup.values()])
        alrts = np.array([a for a, _ in sup.values()])

        seen = []
        real = support_mod._site_ll

        def spy(t, *a, **kw):
            ll, s_ll, m = real(t, *a, **kw)
            seen.append((t, a, ll))
            return ll, s_ll, m

        support_mod._site_ll = spy
        try:
            alrt_support(tree, res.model, codes[order][:, :ALRT_BRUTE_SITES],
                         alpha=res.alpha, p_inv=res.p_inv,
                         rell_replicates=ALRT_REPLICATES, device=dev)
        finally:
            support_mod._site_ll = real
        worst = 0.0
        for t, (m, tp, w, al, pi_, cfg, d), ll in \
                seen[:1 + 2 * ALRT_BRUTE_BRANCHES]:
            bf = PhyloModel(t, m, tp, wgt=w, alpha=al, p_inv=pi_,
                            config=cfg, device=d).log_likelihood_bruteforce()
            worst = max(worst, abs(ll - bf) / abs(bf))
        check(worst < ALRT_BRUTE_RTOL,
              f"aLRT: alternatives vs float64 brute force rel {worst:.2e}")
        phase("analyses", f"alrt_support: {len(sup)} branches x 2 NNI "
              f"alternatives, {ALRT_REPLICATES} RELL replicates: "
              f"{awall:.2f} s; SH >= 0.9 on {np.mean(shs >= 0.9):.3f} of "
              f"branches; aLRT < 0 on {int((alrts < 0).sum())}; the first "
              f"{ALRT_BRUTE_BRANCHES} branches' "
              f"{2 * ALRT_BRUTE_BRANCHES} alternatives and the incumbent "
              f"on {ALRT_BRUTE_SITES} sites within rel {worst:.1e} of the "
              f"float64 brute force; launches {counts}")
        out["alrt"] = dict(wall_s=awall, counts=counts)

        # the aLRT alternative under the trace: its ll here == there
        alt_ll = PhyloModel(alt, res.model, tips, wgt=wgt, alpha=res.alpha,
                            p_inv=res.p_inv,
                            device=dev).log_likelihood().log_likelihood
        with prof.range("trace"):
            k2, n_events, sub_ll = traced.result()
        check(k2 and sub_ll == alt_ll,
              f"trace: kernel-2 launches named {k2}, ll {sub_ll} vs "
              f"{alt_ll} in this process")
        phase("analyses", f"trace() of one aLRT alternative (in a process "
              f"of its own, run beside the phase): {n_events} events, "
              f"kernel 2 named as {k2}; its ll == this process's bit for "
              f"bit")

        # -- ancestral states and site rates -------------------------------
        lg_fit = next(f for f in psel.fits if f.name == "LG+G")
        lg_tree = _with_lengths(pstart, lg_fit.lengths)
        out["ancestral"] = {}
        for label, make, kernel in (
                ("DNA", lambda d: PhyloModel(
                    tree, res.model, tips, wgt=wgt, alpha=res.alpha,
                    p_inv=res.p_inv, device=d), "plf_node"),
                ("protein", lambda d: PhyloModel(
                    lg_tree, lg, ppats, wgt=pwgt, alpha=lg_fit.alpha,
                    device=d), "plf_node_mxu")):
            m = make(dev)
            legacy = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with prof.range(f"ancestral_{label}"):
                    posts = ancestral_marginal(m)
                anc_ms = 1e3 * (time.perf_counter() - t0)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = legacy
            bf_posts, bf_lik = ancestral_bruteforce(m, ANC_SITES)
            row_err = max(float(np.abs(p.sum(axis=1) - 1).max())
                          for p in posts.values())
            post_err = max(float(np.abs(posts[v][:len(bf_lik)]
                                        - bf_posts[v]).max())
                           for v in posts)
            check(len(posts) == m.tree.n_leaves - 1 and row_err < ANC_ATOL
                  and post_err < ANC_ATOL,
                  f"ancestral {label}: rows {row_err:.2e}, posteriors vs "
                  f"float64 {post_err:.2e}")
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with prof.range(f"site_rates_{label}"):
                mean_rate, cat_post = site_rates(m)
            sr_ms = 1e3 * (time.perf_counter() - t0)
            counts = {k: v for k, v in _counts().items() if v}
            _merge(total, counts)
            w_bf = bf_lik * np.asarray(m.rate_weights)[None, :]
            w_bf = w_bf / w_bf.sum(axis=1, keepdims=True)
            sr_err = float(np.abs(cat_post[:len(w_bf)] - w_bf).max())
            plain_mean, plain_post = site_rates(make("cpu"))
            check(counts == {kernel: len(m.schedule)}
                  and np.array_equal(cat_post, plain_post)
                  and np.array_equal(mean_rate, plain_mean)
                  and np.all(np.isfinite(mean_rate)),
                  f"site_rates {label}: launches {counts}, vs the plain "
                  f"versions {np.abs(cat_post - plain_post).max():.2e}")
            phase("analyses", f"{label} ({m.tree.n_leaves} taxa x "
                  f"{m.n_sites} patterns, "
                  f"{m.config.resolved_kernel_variant}): ancestral_marginal "
                  f"{anc_ms:.1f} ms (TF32 on), {len(posts)} nodes, rows sum "
                  f"to 1 within {row_err:.1e}, first {ANC_SITES} sites within "
                  f"{post_err:.1e} of float64; site_rates {sr_ms:.1f} ms, == "
                  f"the plain versions' run, category posteriors "
                  f"{sr_err:.1e} from float64 on the first {ANC_SITES}, "
                  f"mean rate {float(np.average(mean_rate, weights=m.wgt)):.4f}"
                  f"; launches {counts}")
            out["ancestral"][label] = dict(ancestral_ms=anc_ms,
                                           site_rates_ms=sr_ms,
                                           counts=counts)

        # -- partitions: the three codon positions ------------------------
        raw = codes[order]
        sites = np.arange(ANALYSES_SITES)
        alphas = (0.4, 0.5, 0.6)
        parts = [Partition(f"pos{i + 1}", sites[sites % 3 == i], model,
                           alpha=a) for i, a in enumerate(alphas)]
        _reset_counts()
        with prof.range("partitions"):
            pmod = PartitionedModel(tree, parts, raw, device=dev)
            pres = pmod.log_likelihood()
            sep = [PhyloModel(tree, p.model, raw[:, p.sites], alpha=p.alpha,
                              device=dev).log_likelihood().log_likelihood
                   for p in parts]
            fn, t0v, _ = pmod.loglik_fn()
            with torch.no_grad():
                joint0 = float(fn(t0v, torch.zeros(3)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, scales, ll0, ll1 = pmod.optimize(steps=PART_STEPS)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0) / PART_STEPS
        counts = {k: v for k, v in _counts().items() if v}
        _merge(total, counts)
        rel = abs(joint0 - pres.log_likelihood) / abs(pres.log_likelihood)
        check(pres.log_likelihood == float(sum(sep)) and rel < 1e-5
              and ll1 > ll0, f"partitions: {pres.log_likelihood} vs sum "
              f"{float(sum(sep))}, loglik_fn rel {rel:.2e}, optimize "
              f"{ll0} -> {ll1}")
        _launched(counts, ("plf_tree", "plf_tree_seg", "plf_tree_seg_bwd"),
                  "partitions")
        phase("analyses", f"PartitionedModel, 3 codon positions x "
              f"HKY85+G4 (alpha {alphas}): log_likelihood() "
              f"{pres.log_likelihood:.3f} == the sum of the three "
              f"PhyloModels bit for bit; loglik_fn at t0 within rel "
              f"{rel:.1e}; optimize(steps={PART_STEPS}) {ll0:.3f} -> "
              f"{ll1:.3f}, {step_ms:.2f} ms a joint step, scales "
              f"{np.round(scales, 4).tolist()}; launches {counts}")
        out["partitions"] = dict(step_ms=step_ms, counts=counts)

    phase("analyses", "PhaseProfiler report:\n" + prof.report())
    phase("analyses", f"launches over the phase: {total}")
    out["launches"] = total
    return out


# -------------------------------------------- the three axes (PR phases) --

#: The instance axis at the reference's NUM_ACCELERATORS=9: nine node
#: pairs of 2^20 DNA sites (kernel 1) and of 2^18 sites at S = 20 (kernel
#: 1m) in one launch.
AXES_INSTANCES = 9
AXES_DNA_SITES, AXES_S20_SITES = 1 << 20, 1 << 18
#: The segmented engine's candidate axis: an NNI round of 256 DNA taxa x
#: 16,384 sites (kernel 7) and of 64 protein taxa x 4,096 sites (kernel
#: 7m, "mxu_3x"); the plain batch and its kernel timing take the round's
#: first AXES_PLAIN candidates.
AXES_SEG_TAXA, AXES_SEG_SITES = 256, 1 << 14
AXES_PROT_TAXA, AXES_PROT_SITES = 64, 1 << 12
AXES_PLAIN = 8
#: The sharded phase: kernel 1 on 2 ranks at 2^24 sites, the golden
#: oracle on the first 2^16 sites of the DNA model.
SHARD_NODE_SITES = 1 << 24
GOLDEN_SITES = 1 << 16


def _instances(dev, S, n, seed):
    """AXES_INSTANCES node pairs of ``n`` sites made on the card from a
    seed: site-major children (every 4th site of x1 scaled by 1e-15, so
    it rescales), branches and EV from numpy."""
    g = torch.Generator(device=dev).manual_seed(seed)
    I = AXES_INSTANCES
    x1 = torch.rand((I, n, 4, S), generator=g, device=dev)
    x2 = torch.rand((I, n, 4, S), generator=g, device=dev)
    x1[:, ::4] *= 1e-15
    rng = np.random.default_rng(seed)
    left, right = (rng.random((I, 4, S, S), dtype=np.float32)
                   for _ in range(2))
    ev = rng.random((I, S, S), dtype=np.float32)
    return x1, x2, left, right, ev


def _lane_batch(x1, x2, left, right, ev, dev):
    """The lane-major batch that PLFEngine.plf_batch hands the kernel."""
    I, n, C, S = x1.shape
    lane = lambda x: x.permute(0, 3, 2, 1).reshape(I, S * C, n).contiguous()
    lc, rc = (torch.as_tensor(np.stack([L.branch_to_lane_constants(b, S, C)
                                        for b in m]), device=dev)
              for m in (left, right))
    ec = torch.as_tensor(np.stack([L.ev_to_lane_constants(e, S, C)
                                   for e in ev]), device=dev)
    return lane(x1), lane(x2), lc, rc, ec


def axes_node(dev, S, variant):
    """``PLFEngine.plf_batch`` on AXES_INSTANCES node pairs: one launch of
    kernel 1 (S = 4) or 1m, each instance == its own ``plf`` bit for bit;
    the batched kernel == its plain version bit for bit; timed against
    nine single launches on the same lane-major inputs."""
    n = AXES_DNA_SITES if S == 4 else AXES_S20_SITES
    args = _instances(dev, S, n, 90 + S)
    eng = PLFEngine(PLFConfig(states=S, kernel_variant=variant), device=dev)
    counter = (node_mod.plf_node_batch if S == 4
               else plf_mxu.plf_node_mxu_batch)
    _reset_counts()
    out = eng.plf_batch(*args)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _counts().items() if v}
    check(counts == {counter.__name__: 1}, f"plf_batch S={S} {variant}: "
          f"launches {counts}")
    rescued = int(out.scaler_increment.sum())
    for i in range(AXES_INSTANCES):
        one = eng.plf(*(a[i] for a in args))
        check(torch.equal(out.x3[i], one.x3)
              and torch.equal(out.scaler_vector[i], one.scaler_vector)
              and int(out.scaler_increment[i]) == int(one.scaler_increment),
              f"plf_batch S={S} {variant}: instance {i} != plf")
    lane = _lane_batch(*args, dev)
    kw = dict(states=S, categories=4, variant=variant)
    x3, sc = node_mod.plf_node_batch(*lane, n, **kw)
    plain_fn = (functools.partial(node_mod.plf_node_batch_torch, states=S)
                if S == 4 else functools.partial(
                    plf_mxu.plf_node_mxu_batch_torch, **kw))
    (x3p, scp), plain_ms = timed(lambda: plain_fn(*lane, n))
    check(torch.equal(x3, x3p) and torch.equal(sc, scp),
          f"batched kernel {counter.__name__} S={S} {variant} != plain")
    del x3p, scp
    ms = cuda_ms(lambda: node_mod.plf_node_batch(*lane, n, **kw), reps=5)

    def singles():
        for i in range(AXES_INSTANCES):
            plf_node(*(t[i] for t in lane), n, **kw)
    single_ms = cuda_ms(singles, reps=5)
    flops, rate = node_work(S, 4, variant)
    bd = bound(AXES_INSTANCES * (3 * S * 4 * 4 + 4) * n,
               AXES_INSTANCES * flops * n, rate)
    phase("axes", f"PLFEngine.plf_batch, {AXES_INSTANCES} instances x {n} "
          f"sites, S={S} {variant}: one launch of {counter.__name__} "
          f"({rescued} rescues), each instance == its own plf() and the "
          f"batched kernel == plain, bit for bit; batched {ms:.3f} ms vs "
          f"{AXES_INSTANCES} single launches {single_ms:.3f} ms (means of "
          f"5), bound {bd['bound_ms']:.3f} ms by {bd['bound_by']} "
          f"({bd['bound_ms'] / ms:.1%}); plain {plain_ms:.1f} ms")
    del out, lane, x3, sc, args
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=0.0, single_ms=single_ms,
                launches=counts.get(counter.__name__, 0), **bd)


def _round(tree, model, tips, cfg, dev):
    """The incumbent and its NNI neighbours as models sharing its device
    tensors (a search round's batch)."""
    pm0 = PhyloModel(tree, model, tips, alpha=0.5, config=cfg, device=dev)
    return [pm0] + [PhyloModel(t, model, tips, alpha=0.5, config=cfg,
                               share_device_from=pm0, device=dev)
                    for t in search_mod.nni_neighbors(tree)]


def _seg_batch_args(pms):
    """``(args, kw)`` of the round's batched segmented launches, as
    ``batch_log_likelihood_segmented`` builds them."""
    progs, segs, lcs, rcs, planes, n_slots, n_bnd = \
        phylo_mod.segmented_batch_inputs(pms)
    pm0 = pms[0]
    cfg = pm0.config
    args = (pm0.codes, progs, segs, lcs, rcs, pm0.ec, pm0.fused_tip_table,
            pm0.root_rows[0], pm0.n_sites)
    kw = dict(n_boundaries=n_bnd, n_slots=n_slots, states=cfg.states,
              categories=cfg.categories, variant=cfg.resolved_kernel_variant,
              planes=planes, dtype=getattr(torch, cfg.dtype))
    return args, kw


def axes_segmented(pms, label):
    """``batch_log_likelihood_segmented`` on a round: its launches (one a
    chunk of candidates whose boundary buffers fit the cap), every row ==
    the candidate's single-tree kernel 7 (7m) bit for bit, fp32 rows ==
    the batched fused kernel (2 or 2m) too, and the lls within
    BATCH_LL_RTOL of each ``log_likelihood(method="segmented")``; the
    round's first AXES_PLAIN candidates in one launch == the plain batch
    (timed beside it)."""
    pm0 = pms[0]
    cfg = pm0.config
    mxu = pm0._matrix_form
    counter = (seg_mod.plf_tree_seg_mxu_batch if mxu
               else seg_mod.plf_tree_seg_batch)
    B = len(pms)
    t0 = time.perf_counter()
    for pm in pms:
        pm._segmented_inputs()
    plan_s = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    lls = phylo_mod.batch_log_likelihood_segmented(pms)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in _counts().items() if v}
    args, kw = _seg_batch_args(pms)
    rows, n_pad = cfg.rows, pm0.n_pad
    per = seg_mod.seg_batch_size(B, kw["n_boundaries"], rows, n_pad,
                                 kw["dtype"])
    chunks = -(-B // per)
    check(counts == {counter.__name__: chunks}, f"{label}: launches {counts}"
          f", {chunks} chunks expected")
    lik, sc = seg_mod.plf_tree_seg_batch(*args, **kw)
    for b, pm in enumerate(pms):
        plan, prog, segs, slots = pm._segmented_inputs()
        one, one_sc, _ = plf_tree_seg(
            pm.codes, prog, segs, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
            pm.root_rows[0], pm.n_sites, n_boundaries=plan.n_boundaries,
            n_slots=slots, states=cfg.states, categories=cfg.categories,
            variant=cfg.resolved_kernel_variant, planes=pm._planes(),
            dtype=kw["dtype"], program=pm.segmented_program)
        check(torch.equal(lik[b], one[0]) and torch.equal(sc[b], one_sc[0]),
              f"{label}: batched row {b} != the single-tree kernel")
    fused = "no fused batch (bf16 boundaries round)"
    if kw["dtype"] == torch.float32:
        check(phylo_mod.batch_fits(pms), f"{label}: the fused batch does "
              f"not fit, nothing to hold the rows to")
        bargs, bkw = _batch_args(pms)
        flik, fsc = tree_mod.plf_tree_batch(*bargs, **bkw)
        check(torch.equal(lik, flik) and torch.equal(sc, fsc),
              f"{label}: batched segmented rows != batched fused rows")
        fused = "== the batched fused kernel bit for bit"
    own = np.array([pm.log_likelihood(method="segmented").log_likelihood
                    for pm in pms])
    rel = float(np.max(np.abs(lls / own - 1)))
    check(rel < BATCH_LL_RTOL, f"{label}: batch lls vs log_likelihood("
          f"method='segmented') rel {rel} >= {BATCH_LL_RTOL}")
    round_ms = cuda_ms(lambda: seg_mod.plf_tree_seg_batch(*args, **kw),
                       reps=3, warmup=1)
    round_bd = _batch_bound(pms)
    sub = pms[:AXES_PLAIN]
    sargs, skw = _seg_batch_args(sub)
    lik_s, sc_s = seg_mod.plf_tree_seg_batch(*sargs, **skw)
    (lik_p, sc_p), plain_ms = timed(
        lambda: seg_mod.plf_tree_seg_batch_torch(*sargs, **skw))
    check(torch.equal(lik_s, lik_p) and torch.equal(sc_s, sc_p)
          and torch.equal(lik_s, lik[:AXES_PLAIN]),
          f"{label}: batch of {AXES_PLAIN} != plain or != the round's rows")
    ms = cuda_ms(lambda: seg_mod.plf_tree_seg_batch(*sargs, **skw), reps=5)
    bd = _batch_bound(sub)
    cap = seg_mod.SEG_BATCH_BBUF_BYTES
    text = (f"{B} candidates x {len(pm0.schedule)} nodes x {pm0.n_sites} "
            f"sites, {cfg.resolved_kernel_variant}, {cfg.dtype} boundaries: "
            f"{chunks} launches of {counter.__name__} (chunks of {per} "
            f"candidates: {kw['n_boundaries']} boundaries a candidate, "
            f"{kw['n_boundaries'] * rows * n_pad * storage_bytes(pm0)} "
            f"bytes, under the {cap} byte cap); segments "
            f"{min(len(pm._segmented_inputs()[0].segments) for pm in pms)}"
            f"-{max(len(pm._segmented_inputs()[0].segments) for pm in pms)}"
            f", {kw['n_slots']} arena slots, {args[3].shape[0]} operator "
            f"pairs; rows == single-tree launches bit for bit, {fused}; "
            f"lls within rel {rel:.1e} of log_likelihood(method="
            f"'segmented'); batch_log_likelihood_segmented {wall:.2f} s "
            f"wall (plans {plan_s:.2f} s before); the round's launches "
            f"{round_ms:.3f} ms (bound {round_bd['bound_ms']:.4f} ms by "
            f"{round_bd['bound_by']}); its first {AXES_PLAIN} in one launch "
            f"== plain: kernel {ms:.3f} ms (bound {bd['bound_ms']:.4f} ms), "
            f"plain {plain_ms:.1f} ms")
    phase("axes", f"{label}: {text}")
    del lik, sc, lik_s, lik_p
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=0.0, round_ms=round_ms,
                launches=counts.get(counter.__name__, 0), chunks=chunks, **bd)


def axes_phase(dev):
    """The instance and candidate axes: ``PLFEngine.plf_batch`` (kernels
    1 and 1m with an instance axis) and ``batch_log_likelihood_segmented``
    (kernels 7 and 7m with a candidate axis), each run with every count
    set to 0 just before it and read just after."""
    out = {"plf_node": axes_node(dev, 4, "vpu")}
    for variant in MXU_VARIANTS:
        out[f"plf_node_mxu:{variant}"] = axes_node(dev, 20, variant)
    rng = np.random.default_rng(AXES_SEG_TAXA)
    tree = random_tree(AXES_SEG_TAXA, seed=AXES_SEG_TAXA)
    tips = rng.integers(-1, 14, size=(AXES_SEG_TAXA, AXES_SEG_SITES))
    hky = hky85(2.0)
    for dtype in ("float32", "bfloat16"):
        pms = _round(tree, hky, tips, PLFConfig(dtype=dtype), dev)
        out[f"plf_tree_seg:{dtype}"] = axes_segmented(
            pms, f"DNA round ({dtype})")
        del pms
    ptree = random_tree(AXES_PROT_TAXA, seed=AXES_PROT_TAXA)
    ptips = rng.integers(-1, 23, size=(AXES_PROT_TAXA, AXES_PROT_SITES))
    lg = empirical_protein("lg")
    for dtype in ("float32", "bfloat16"):
        pms = _round(ptree, lg, ptips, PLFConfig(
            states=20, kernel_variant="mxu_3x", dtype=dtype), dev)
        out[f"plf_tree_seg_mxu:{dtype}"] = axes_segmented(
            pms, f"protein round ({dtype})")
        del pms
    torch.cuda.empty_cache()
    return out


#: One rank of the sharded phase, started as README's second route: no
#: torchrun environment, ``initialize_distributed("localhost:<port>",
#: num_processes=world, process_id=rank)`` (arguments: rank, world,
#: coordinator address, backend, data directory, device: "cuda:0" names
#: the card, "cuda" leaves it to the rule).  It loads the libraries this
#: script built, rebuilds the DNA and protein models from the tips saved
#: there on that device, and prints one JSON line with what "cuda"
#: resolved to for each entry point.
SHARD_SCRIPT = """
import json, sys, time
import numpy as np, torch
from plf_tpu_torch import PLFEngine
from plf_tpu_torch.devices import resolve_device
from plf_tpu_torch.models import PhyloModel, empirical_protein, hky85
from plf_tpu_torch.models import random_tree, tree_loglik_fn
from plf_tpu_torch.ops import layout as L
from plf_tpu_torch.parallel import (ShardedPLF, global_site_mesh,
                                    initialize_distributed, process_summary,
                                    shard_sites, validate_site_workload)
from plf_tpu_torch.parallel.sharding import shard_span
rank, world, address, backend, data, dev = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    sys.argv[5], sys.argv[6])
torch.backends.cuda.matmul.allow_tf32 = False
initialize_distributed(address, num_processes=world, process_id=rank,
                       backend=backend, device=dev)
mesh = global_site_mesh(device=dev)
out = dict(rank=rank, summary=process_summary(), backend=mesh.backend)
d = np.load(data + "/tips.npz")
meta = json.load(open(data + "/meta.json"))
dna = PhyloModel(random_tree(meta["taxa"], seed=1), hky85(2.0), d["dna"],
                 alpha=0.5, device=dev)
prot = PhyloModel(random_tree(meta["prot_taxa"], seed=1),
                  empirical_protein("lg"), d["prot"], alpha=0.5, device=dev)
validate_site_workload(mesh, dna.n_sites, dna.config.block_sites)
out["devices"] = dict(resolve_device=str(resolve_device("cuda")),
                      make_mesh=str(mesh.device), PhyloModel=str(dna.device),
                      PLFEngine=str(PLFEngine().device))
sync = torch.cuda.synchronize if mesh.device.type == "cuda" else lambda: None
for name, pm in (("dna", dna), ("protein", prot)):
    sync()
    t0 = time.perf_counter()
    r = pm.log_likelihood_sharded(mesh)
    out[name] = dict(ll=r.log_likelihood, scaler_total=r.scaler_total,
                     sites=len(r.site_log_likelihood),
                     s=time.perf_counter() - t0)
for name, pm in (("dna", dna), ("protein", prot)):
    fn, t0 = tree_loglik_fn(pm, mesh=mesh)
    t = torch.tensor(t0, device=dev, requires_grad=True)
    sync()
    s0 = time.perf_counter()
    v = fn(t)
    v.backward()
    sync()
    out[name + "_step"] = dict(value=float(v.detach()),
                               grad=t.grad.cpu().tolist(), engine=fn.engine,
                               s=time.perf_counter() - s0)
n = meta["node_sites"]
g = torch.Generator(device=dev).manual_seed(7)
x1 = torch.rand((16, n), generator=g, device=dev)
x2 = torch.rand((16, n), generator=g, device=dev)
x1[:, ::4] *= 1e-12
rng = np.random.default_rng(7)
left, right = (rng.random((4, 4, 4), dtype=np.float32) for _ in range(2))
ev = rng.random((4, 4), dtype=np.float32)
sp = ShardedPLF(mesh, block_sites=4096)
n_pad = sp.padded_sites(n)
lo, shard, n_local = shard_span(mesh, n, n_pad)
wgt = torch.ones((1, n), dtype=torch.int32, device=dev)
x3s, scs, inc = sp(shard_sites(mesh, x1, n_pad), shard_sites(mesh, x2, n_pad),
                   *sp.constants(left, right, ev),
                   shard_sites(mesh, wgt, n_pad), n)
ref = PLFEngine(device=dev).plf(L.from_lane_major(x1), L.from_lane_major(x2),
                                left, right, ev)
mine = L.from_lane_major(x3s, n=n_local)
ref_sv = ref.scaler_vector[lo:lo + n_local]
out["plf"] = dict(inc=int(inc), ref_inc=int(ref.scaler_increment),
                  exact=bool(torch.equal(mine, ref.x3[lo:lo + n_local])
                             and torch.equal(scs[0, :n_local], ref_sv)),
                  n_local=n_local)
print(json.dumps(out), flush=True)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""

#: README.md's multi-card snippet as a user's script under torchrun
#: (argument: data directory): ``initialize_distributed()``,
#: ``make_mesh()``, the 160 x 2^20 DNA model built alike on every rank
#: with the default device, ``log_likelihood_sharded`` and one
#: ``tree_loglik_fn(mesh=)`` step, then one all-reduce on the group; it
#: prints one JSON line.
TORCHRUN_SCRIPT = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from plf_tpu_torch.models import (PhyloModel, hky85, random_tree,
                                  tree_loglik_fn)
from plf_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                    process_summary)
torch.backends.cuda.matmul.allow_tf32 = False
initialize_distributed()            # under torchrun (MASTER_ADDR, RANK, ...)
mesh = make_mesh()                  # one rank a process, one card a rank
d = np.load(sys.argv[1] + "/tips.npz")
meta = json.load(open(sys.argv[1] + "/meta.json"))
pm = PhyloModel(random_tree(meta["taxa"], seed=1), hky85(2.0), d["dna"],
                alpha=0.5)
res = pm.log_likelihood_sharded(mesh)       # the same ll on every rank
fn, t0 = tree_loglik_fn(pm, mesh=mesh)      # gradients summed over ranks
t = torch.tensor(t0, device=pm.device, requires_grad=True)
v = fn(t)
v.backward()
one = torch.ones(1, device=mesh.device)
dist.all_reduce(one)
torch.cuda.synchronize()
print(json.dumps(dict(
    summary=process_summary(), backend=str(dist.get_backend()),
    devices=[str(pm.device), str(mesh.device),
             f"cuda:{torch.cuda.current_device()}"],
    ll=res.log_likelihood, scaler_total=res.scaler_total,
    value=float(v.detach()), grad=t.grad.cpu().tolist(), engine=fn.engine,
    all_reduce=float(one))), flush=True)
dist.destroy_process_group()
"""


def _torchrun(script, ranks, data):
    """``python -m torch.distributed.run --standalone`` of ``script`` over
    ``ranks`` processes on this machine, started now (the package from
    this checkout)."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={ranks}", script, data],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _stop(procs):
    """End every process of ``procs`` still running: SIGTERM first, which
    torchrun passes on to its ranks, then SIGKILL."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def torchrun_step(runs, want, steps):
    """The README's snippet under torchrun on NCCL: one rank == the
    unsharded ll (rel 1e-6, scaler totals exact) and gradient (within
    SEG_GRAD_RTOL of scale), model, mesh and current card all cuda:0; one
    rank more than the cards refused by ``initialize_distributed``'s
    ValueError within seconds, before any group (no NCCL "Duplicate GPU
    detected")."""
    (one, t_one), (more, t_more) = runs
    cards = torch.cuda.device_count()
    o2, e2 = more.communicate(timeout=300)     # the refusal ends first
    secs_more = time.perf_counter() - t_more
    o, e = one.communicate(timeout=300)
    secs_one = time.perf_counter() - t_one
    check(one.returncode == 0, f"torchrun, 1 rank, exited "
          f"{one.returncode}:\n{e[-3000:]}")
    r = json.loads([ln for ln in o.splitlines() if ln.startswith("{")][-1])
    check(r["devices"] == ["cuda:0"] * 3 and r["backend"] == "nccl"
          and r["all_reduce"] == 1.0, f"torchrun, 1 rank: {r['devices']}, "
          f"{r['backend']}, all_reduce {r['all_reduce']}")
    rel = abs(r["ll"] / want.log_likelihood - 1)
    check(rel < 1e-6 and r["scaler_total"] == want.scaler_total,
          f"torchrun, 1 rank: ll {r['ll']} vs {want.log_likelihood} (rel "
          f"{rel}), scalers {r['scaler_total']} vs {want.scaler_total}")
    g = steps[r["engine"]][0][1].cpu().numpy()
    err = float(np.abs(np.asarray(r["grad"]) - g).max() / np.abs(g).max())
    check(err <= SEG_GRAD_RTOL, f"torchrun, 1 rank: {r['engine']} gradient "
          f"{err} of scale")
    text = o2 + e2
    refusal = (f"{cards + 1} ranks asked for on 'cuda', but this machine "
               f"has {cards} card(s)")
    check(more.returncode != 0 and "ValueError" in text and refusal in text
          and "Duplicate GPU detected" not in text and secs_more < 60,
          f"torchrun, {cards + 1} ranks on {cards} card(s): exited "
          f"{more.returncode} after {secs_more:.1f} s:\n{text[-3000:]}")
    phase("sharded", f"torchrun --nproc_per_node=1 of README's snippet "
          f"({r['summary']}): model, mesh and current card cuda:0, "
          f"ll {r['ll']:.3f} (rel {rel:.1e} to log_likelihood()), "
          f"{r['scaler_total']} rescales exact, {r['engine']} step gradient "
          f"within {err:.1e} of scale, {secs_one:.1f} s wall with the "
          f"process start; --nproc_per_node={cards + 1}: refused, exit "
          f"{more.returncode} after {secs_more:.1f} s: {refusal}")


#: Two ranks of NCCL on one card: one all-reduce (argument: store file,
#: rank).  NCCL usually refuses two ranks on one device.
NCCL_PROBE = """
import sys, torch, torch.distributed as dist
dist.init_process_group("nccl", init_method="file://" + sys.argv[1],
                        world_size=2, rank=int(sys.argv[2]))
t = torch.ones(1, device="cuda")
dist.all_reduce(t)
torch.cuda.synchronize()
print(float(t))
dist.destroy_process_group()
"""


#: README's second route under NCCL (arguments: coordinator address,
#: rank): ``initialize_distributed("localhost:<port>", num_processes=2,
#: process_id=rank)``, no torchrun environment and no card named; with a
#: card a rank, one all-reduce on the card it pinned.
CALLER_NCCL = """
import json, sys, torch, torch.distributed as dist
from plf_tpu_torch.devices import resolve_device
from plf_tpu_torch.parallel import initialize_distributed, make_mesh
initialize_distributed(sys.argv[1], num_processes=2,
                       process_id=int(sys.argv[2]))
one = torch.ones(1, device="cuda")
dist.all_reduce(one)
torch.cuda.synchronize()
print(json.dumps(dict(devices=[str(resolve_device("cuda")),
                               str(make_mesh().device)],
                      all_reduce=float(one))), flush=True)
dist.destroy_process_group()
"""
#: Seconds within which both ranks of :data:`CALLER_NCCL` must end.
CALLER_SECONDS = 30


def _free_address():
    """``localhost:<port>`` of a port free now."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


def _caller_env():
    """This process's environment without torchrun's variables."""
    import os
    return {k: v for k, v in os.environ.items()
            if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                         "LOCAL_RANK", "LOCAL_WORLD_SIZE")}


def caller_nccl_pair(procs, t0):
    """README's second route under NCCL, two ranks started by this script
    at ``t0``: on fewer than two cards both exit 1 with
    ``initialize_distributed``'s ValueError before any group, within
    CALLER_SECONDS (no rank left waiting at the rendezvous, no NCCL
    "Duplicate GPU detected"); on two cards or more each pins its own
    card and the all-reduce gives 2."""
    cards = torch.cuda.device_count()
    res = []
    for p in procs:
        left = max(1.0, CALLER_SECONDS - (time.perf_counter() - t0))
        try:
            o, e = p.communicate(timeout=left)
            res.append((p.returncode, o, e))
        except subprocess.TimeoutExpired:
            p.kill()
            o, e = p.communicate()
            res.append((None, o, e + "\n(still running: killed)"))
    secs = time.perf_counter() - t0
    if cards >= 2:
        for r, (rc, o, e) in enumerate(res):
            got = json.loads(o.strip().splitlines()[-1]) if rc == 0 else {}
            check(got.get("devices") == [f"cuda:{r}"] * 2
                  and got.get("all_reduce") == 2.0,
                  f"caller-started NCCL rank {r}: exit {rc}, {got}\n"
                  f"{e[-3000:]}")
        why = "each rank on its own card, all_reduce 2"
    else:
        for r, (rc, o, e) in enumerate(res):
            refusal = (f"ValueError: rank {r} (card {r}): 2 ranks asked for "
                       f"on 'cuda', but this machine has {cards} card(s)")
            check(rc == 1 and refusal in e and not o.strip()
                  and "Duplicate GPU detected" not in e,
                  f"caller-started NCCL rank {r}: exit {rc}, wanted the "
                  f"refusal:\n{(o + e)[-3000:]}")
        why = (f"both ranks refused, exit 1: 2 ranks asked for on 'cuda', "
               f"but this machine has {cards} card(s)")
    check(secs < CALLER_SECONDS, f"caller-started NCCL pair took {secs:.1f} s")
    phase("sharded", f"README's second route under NCCL, "
          f"initialize_distributed('localhost:<port>', num_processes=2, "
          f"process_id=r), no torchrun environment: {why}, both ended "
          f"{secs:.1f} s after the start")


def _ranks(script, argv_of, timeout, env=None):
    """Run two ranks of ``script`` at once; ``[(returncode, stdout,
    stderr)]``, every process stopped by the end."""
    procs = [subprocess.Popen([sys.executable, "-c", script, *argv_of(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    res = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
                res.append((p.returncode, out, err))
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                res.append((None, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def sharded_phase(dev, tree, tips, pm, models):
    """Site sharding over torch.distributed on the card:

    * a one-rank mesh (no process group) on the 160 x 2^20 DNA model:
      ``log_likelihood_sharded()`` == ``log_likelihood()`` site for site,
      "tree" and "segmented" mesh steps == the unsharded steps within
      SEG_GRAD_RTOL of scale;
    * two ranks on the one card, processes of their own that load the
      libraries built here (NCCL if it takes two ranks on one card, else
      gloo, whose all-reduce copies through the host): the DNA model and
      the 64 x 131,072 protein "mxu_3x" model, ll within rel 1e-6 of the
      unsharded, scaler totals exact, a mesh step (auto: "tree") within
      SEG_GRAD_RTOL of the unsharded step's gradient scale
      (SEG_MXU_GRAD_RTOL for the protein model's matrix form), every rank
      the same; ``plf_sharded`` at 2^24 sites == ``PLFEngine.plf`` on
      each rank's shard, bit for bit, the increment exact;
    * README.md's multi-card snippet under ``torchrun`` on NCCL
      (:func:`torchrun_step`): one rank == the unsharded ll and gradient,
      all on cuda:0; one rank more than the cards refused before any
      group;
    * README.md's second route, ranks started here with no torchrun
      environment: under NCCL (:func:`caller_nccl_pair`) two ranks on
      the one card both refused within CALLER_SECONDS; the two ranks
      above join through it too (``localhost:<port>``), rank 0 naming
      "cuda:0" and rank 1 passing "cuda", and on every rank
      ``resolve_device``, ``make_mesh``, the models and ``PLFEngine()``
      are all on the card;
    * ``tree_golden_for_model`` on the first 2^16 sites of the DNA model
      == kernel 2 bit for bit."""
    from plf_tpu_torch.parallel import make_mesh
    from plf_tpu_torch.runtime.native import (golden_oracle,
                                              tree_golden_for_model)
    out = {}
    t0 = time.perf_counter()
    address = _free_address()
    caller_nccl_pair([subprocess.Popen(
        [sys.executable, "-c", CALLER_NCCL, address, str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_caller_env()) for r in range(2)], t0)
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.ExitStack() as started:
        probe = [subprocess.Popen(
            [sys.executable, "-c", NCCL_PROBE, f"{tmp}/nccl", str(r)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        np.savez(f"{tmp}/tips.npz", dna=tips, prot=models["mxu_3x"].tip_states)
        with open(f"{tmp}/meta.json", "w") as f:
            json.dump(dict(taxa=N_TAXA, prot_taxa=PROT_TAXA,
                           node_sites=SHARD_NODE_SITES), f)
        with open(f"{tmp}/fit.py", "w") as f:
            f.write(TORCHRUN_SCRIPT)
        runs = [(_torchrun(f"{tmp}/fit.py", k, tmp), time.perf_counter())
                for k in (1, torch.cuda.device_count() + 1)]
        started.callback(_stop, probe + [p for p, _ in runs])
        mesh = make_mesh(device=dev)
        check(mesh.size == 1 and mesh.group is None, f"one-rank mesh {mesh}")
        want = pm.log_likelihood()
        got = pm.log_likelihood_sharded(mesh)
        check(np.array_equal(got.site_log_likelihood, want.site_log_likelihood)
              and got.scaler_total == want.scaler_total,
              "one-rank log_likelihood_sharded != log_likelihood()")
        steps = {}
        for backend in ("tree", "segmented"):
            vals = []
            for m in (None, mesh):
                fn, t0 = tree_loglik_fn(pm, backend=backend, mesh=m)
                vals.append(_grad_step(fn, t0, dev))
            err = float((vals[0][1] - vals[1][1]).abs().max()
                        / vals[0][1].abs().max())
            check(err <= SEG_GRAD_RTOL and vals[0][0] == vals[1][0],
                  f"one-rank {backend} mesh step: gradient {err} of scale")
            steps[backend] = (vals[0], err)
        phase("sharded", f"one-rank mesh on {N_TAXA} x {TREE_SITES}: "
              f"log_likelihood_sharded() == log_likelihood() site for site "
              f"(ll {got.log_likelihood:.3f}, {got.scaler_total} rescales); "
              f"'tree' and 'segmented' mesh steps == unsharded (gradient "
              f"{steps['tree'][1]:.1e} and {steps['segmented'][1]:.1e} of "
              f"scale)")
        torchrun_step(runs, want, steps)
        nccl = []
        for p in probe:
            try:
                o, e = p.communicate(timeout=90)
                nccl.append((p.returncode, e))
            except subprocess.TimeoutExpired:
                p.kill()
                nccl.append((None, "timed out"))
        backend = "nccl" if all(rc == 0 for rc, _ in nccl) else "gloo"
        def reason(err):
            """NCCL's own words: the line after "Last error:", else the
            last line that names an error."""
            lines = [ln.strip() for ln in err.strip().splitlines()] or ["?"]
            last = [i for i, ln in enumerate(lines) if "Last error:" in ln]
            if last and last[-1] + 1 < len(lines):
                return lines[last[-1] + 1]
            return ([ln for ln in lines if "rror" in ln
                     or "timed out" in ln] or lines)[-1]
        why = "" if backend == "nccl" else " (NCCL refused: " + " / ".join(
            reason(e)[:200] for _, e in nccl) + ")"
        phase("sharded", f"two ranks on one card: backend {backend}{why}")
        # NCCL counts the cards of a rank that names none
        devs = [str(dev), str(dev) if backend == "nccl" else "cuda"]
        address = _free_address()
        t0 = time.perf_counter()
        ranks = _ranks(SHARD_SCRIPT, lambda r: [str(r), "2", address,
                                                backend, tmp, devs[r]], 600,
                       env=_caller_env())
        wall = time.perf_counter() - t0
        for r, (rc, o, e) in enumerate(ranks):
            check(rc == 0, f"sharded rank {r} exited {rc}:\n{e[-3000:]}")
        res = [json.loads(o.strip().splitlines()[-1]) for _, o, _ in ranks]
    for r, got in enumerate(res):
        check(set(got["devices"].values()) == {str(dev)},
              f"2 ranks, rank {r} given {devs[r]!r}: {got['devices']}")
    phase("sharded", f"2 ranks started as README's second route "
          f"(initialize_distributed('localhost:<port>', num_processes=2, "
          f"process_id=r), backend {backend}), rank 0 given {devs[0]!r} and "
          f"rank 1 {devs[1]!r}: resolve_device('cuda'), make_mesh(), the "
          f"models and PLFEngine() all on {dev} on both ranks")
    prot = models["mxu_3x"]
    ref = dict(dna=want, protein=prot.log_likelihood())
    for name in ("dna", "protein"):
        for r in res:
            rel = abs(r[name]["ll"] / ref[name].log_likelihood - 1)
            check(rel < 1e-6 and r[name]["scaler_total"]
                  == ref[name].scaler_total and r[name]["ll"]
                  == res[0][name]["ll"], f"2 ranks {name}: ll {r[name]} vs "
                  f"{ref[name].log_likelihood} (rel {rel})")
    errs = {}
    for name, model in (("dna", pm), ("protein", prot)):
        fn, t0 = tree_loglik_fn(model, backend=res[0][name + "_step"]
                                ["engine"])
        v, g = _grad_step(fn, t0, dev)
        g = g.cpu().numpy()
        for r in res:
            got = np.asarray(r[name + "_step"]["grad"])
            errs[name] = float(np.abs(got - g).max() / np.abs(g).max())
            rtol = SEG_GRAD_RTOL if name == "dna" else SEG_MXU_GRAD_RTOL
            check(errs[name] <= rtol and got.tolist()
                  == res[0][name + "_step"]["grad"],
                  f"2 ranks {name} step: gradient {errs[name]} of scale")
    for r in res:
        check(r["plf"]["exact"] and r["plf"]["inc"] == r["plf"]["ref_inc"]
              > 0, f"2 ranks plf_sharded: {r['plf']}")
    phase("sharded", f"2 ranks ({res[0]['summary']}; {res[1]['backend']}) "
          f"on one card, {wall:.1f} s wall: DNA ll {res[0]['dna']['ll']:.3f} "
          f"(unsharded {want.log_likelihood:.3f}), protein "
          f"{res[0]['protein']['ll']:.3f}, scaler totals exact, every rank "
          f"the same; mesh steps ({res[0]['dna_step']['engine']}/"
          f"{res[0]['protein_step']['engine']}) within {errs['dna']:.1e} / "
          f"{errs['protein']:.1e} of the unsharded gradients' scale; "
          f"sharded ll {res[0]['dna']['s']:.2f} / "
          f"{res[0]['protein']['s']:.2f} s and steps "
          f"{res[0]['dna_step']['s']:.2f} / {res[0]['protein_step']['s']:.2f}"
          f" s a rank (wall, shared card); plf_sharded at "
          f"{SHARD_NODE_SITES} sites == PLFEngine.plf on each shard "
          f"({res[0]['plf']['n_local']} + {res[1]['plf']['n_local']} "
          f"sites), increment {res[0]['plf']['inc']}")
    sub = PhyloModel(tree, hky85(2.0), tips[:, :GOLDEN_SITES], alpha=0.5,
                     device=dev)
    t0 = time.perf_counter()
    glik, gsc = tree_golden_for_model(sub)
    gsecs = time.perf_counter() - t0
    klik, ksc = plf_tree(sub.codes, sub.sched, sub.lcs, sub.rcs, sub.ec,
                         sub.fused_tip_table, sub.root_rows[0], sub.n_sites,
                         n_slots=sub.n_slots, root_slot=sub.root_slot,
                         program=sub.tree_program)
    check(np.array_equal(glik, klik[0, :GOLDEN_SITES].cpu().numpy())
          and np.array_equal(gsc, ksc[0, :GOLDEN_SITES].cpu().numpy()),
          "tree_golden_for_model != kernel 2")
    phase("sharded", f"tree_golden_for_model ({golden_oracle()}) on "
          f"{N_TAXA} x {GOLDEN_SITES} sites == kernel 2 bit for bit "
          f"({int(gsc.sum())} rescales), {gsecs:.2f} s on the host")
    out["backend"] = backend
    return out


def seg_inputs(pm):
    """The model's segment plan, the forward's program (cached on the
    model: kernel 7's carried one, ``carry_segment_program``, or kernel
    7m's) and kernel 8's (8m's), on the card."""
    plan, prog, segs, n_slots = pm._segmented_inputs()
    if pm.segmented_program is not None:
        prog, n_slots = pm.segmented_program
    sched = reorder_schedule(pm.schedule, pm.tree.n_leaves)
    bprog, bsegs, _ = segment_program(plan, sched, reuse_slots=False)
    bwd = tuple(torch.as_tensor(a, device=pm.device) for a in (bprog, bsegs))
    return plan, (prog, segs, n_slots), bwd


def storage_bytes(pm):
    """Bytes of one CLV element in the model's storage (``dtype``)."""
    return 2 if pm.config.dtype == "bfloat16" else 4


def seg_fwd_bound(pm, plan):
    """Kernel 7's (7m's) bound: the tip codes read, lik and sc and every
    boundary CLV written once (in the model's storage), against kernel
    2's (2m's) operations in the model's arithmetic."""
    S, C = pm.config.states, pm.config.categories
    fwd, rate = node_work(S, C, pm.config.resolved_kernel_variant)
    per_site = (pm.codes.element_size() * pm.tree.n_leaves + 8
                + storage_bytes(pm) * pm.config.rows * plan.n_boundaries)
    return bound(per_site * pm.n_pad, len(pm.schedule) * fwd * pm.n_pad, rate)


def seg_bwd_bound(pm, plan):
    """Kernel 8's (8m's) bound: the tip codes, the boundary CLVs (in the
    model's storage) and the cotangent read once, against the whole-tree
    VJP's operations in the model's arithmetic."""
    flops, rate = tree_bwd_work(pm.config.states, pm.config.categories,
                                len(pm.schedule),
                                pm.config.resolved_kernel_variant)
    per_site = (pm.codes.element_size() * pm.tree.n_leaves + 4
                + storage_bytes(pm) * pm.config.rows * plan.n_boundaries)
    return bound(per_site * pm.n_pad, flops * pm.n_pad, rate)


def _seg_args(pm, fwd):
    """Kernel 7's arguments on a model's carried program ``fwd``, for its
    plain version (which interprets the program) and for kernel7()."""
    prog, segs, n_slots = fwd
    return ((pm.codes, prog, segs, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
             pm.root_rows[0], pm.n_sites),
            dict(n_boundaries=pm._segmented_inputs()[0].n_boundaries,
                 n_slots=n_slots, categories=pm.config.categories,
                 dtype=getattr(torch, pm.config.dtype)))


def kernel7(*args, **kw):
    """plf_tree_seg on the carried program of ``_seg_args``: the program
    is passed as such, so kernel 7 runs it as the model does."""
    return plf_tree_seg(*args, program=(args[1], kw["n_slots"]), **kw)


def seg_late_reads(fwd):
    """Ops of kernel 7's program that read the boundary the op right
    before them exports: kernel 7 reads those rows at the op, not an op
    ahead (csrc/plf_tree_seg.cu, the ordering rule)."""
    prog, segs = (t.cpu().numpy() for t in fwd[:2])
    return sum(any(prog[2 * s + 1, end] == 2 and prog[2 * s, end] == gout
                   for s in range(2)) for end, gout in segs[:-1])


def kernel7_phase(dev, pm):
    """Kernel 7 against its plain version (lik, sc and every boundary CLV)
    and against kernel 2 (lik and sc) bit for bit, at 160 taxa x 2^20 (the
    tree workload) and at 512 taxa x 262,144."""
    rng = np.random.default_rng(SEG_FWD_TAXA)
    wide = PhyloModel(random_tree(SEG_FWD_TAXA, seed=3), hky85(2.0),
                      rng.integers(-1, 14, size=(SEG_FWD_TAXA, SEG_FWD_SITES)),
                      alpha=0.5, device=dev)
    res = None
    for m in (pm, wide):
        plan, fwd, _ = seg_inputs(m)
        args, kw = _seg_args(m, fwd)
        lik, sc, bbuf = kernel7(*args, **kw)
        kargs = (m.codes, m.sched, m.lcs, m.rcs, m.ec, m.fused_tip_table,
                 m.root_rows[0], m.n_sites)
        kkw = dict(n_slots=m.n_slots, root_slot=m.root_slot,
                   program=m.tree_program)
        ref = plf_tree(*kargs, **kkw)
        plain, plain_ms = timed(lambda: plf_tree_seg_torch(*args, **kw))
        check(torch.equal(lik, ref[0]) and torch.equal(sc, ref[1]),
              f"kernel 7 != kernel 2 at {m.tree.n_leaves} taxa")
        check(all(torch.equal(a, b) for a, b in zip((lik, sc, bbuf), plain)),
              f"kernel 7 != its plain version at {m.tree.n_leaves} taxa")
        del plain, bbuf
        ms = cuda_ms(lambda: kernel7(*args, **kw), reps=20)
        ms2 = cuda_ms(lambda: plf_tree(*kargs, **kkw), reps=20)
        bd = seg_fwd_bound(m, plan)
        gb = plan.n_boundaries * 4 * m.config.rows * m.n_pad / 1e9
        kp = seg_mod.plf_tree_seg_plan(m.codes.dtype, m.config.categories,
                                       m.fused_tip_table.shape[1], fwd[2])
        late = seg_late_reads(fwd)
        phase("kernel7", f"{m.tree.n_leaves} taxa x {m.n_sites} sites: "
              f"{len(plan.segments)} segments (at most {plan.seg_ops} ops), "
              f"{plan.n_boundaries} boundaries ({gb:.3f} GB), {late} read "
              f"right after their export; carried program: {fwd[2]} arena "
              f"slots; plan: {kp['threads']} threads, {kp['blocks_per_sm']} "
              f"blocks per SM, {kp['registers']} registers, "
              f"{kp['smem_bytes']} bytes of shared memory; lik and sc == "
              f"kernel 2 and lik, "
              f"sc, boundaries == plain, bit for bit ({int(sc.sum())} "
              f"rescales); kernel {ms:.3f} ms (kernel 2 {ms2:.3f} ms; means "
              f"of 20 back to back; bound "
              f"{bd['bound_ms']:.3f} ms by {bd['bound_by']}), plain "
              f"{plain_ms:.1f} ms")
        if res is None:
            res = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0.0, **bd)
        del lik, sc
    del wide
    torch.cuda.empty_cache()
    return res


def kernel8_phase(pm):
    """Kernel 8 against its plain version at the tree workload (160 taxa x
    2^20), kernel8_against, then the plans of seg_cap_probe."""
    res, glik = kernel8_against(pm)
    seg_cap_probe(pm, glik)
    return res


def kernel8_against(pm, name="kernel8"):
    """Kernel 8 against its plain version on the model's own plan and
    storage, with a real step's cotangent: the boundary adjoints bit for
    bit, the site sums within SEG_SUM_RTOL of scale, two runs
    bit-identical; its time and checkpoint beside kernel 4's.  Prints
    under phase ``name``; returns its entry and the cotangent."""
    plan, fwd, (bprog, bsegs) = seg_inputs(pm)
    args, kw = _seg_args(pm, fwd)
    lik, _, bbuf = kernel7(*args, **kw)
    glik = (pm.wgt_pad.to(torch.float32) / lik).contiguous()
    bargs = (pm.codes, bprog, bsegs, pm.lcs, pm.rcs, pm.ec,
             pm.fused_tip_table, pm.root_rows[0], glik, bbuf, pm.n_sites)
    gbufs = [torch.empty_like(bbuf) for _ in range(3)]
    k1 = plf_tree_seg_bwd(*bargs, seg_ops=plan.seg_ops, gbuf=gbufs[0])
    k2 = plf_tree_seg_bwd(*bargs, seg_ops=plan.seg_ops, gbuf=gbufs[1])
    p, plain_ms = timed(lambda: plf_tree_seg_bwd_torch(*bargs, gbuf=gbufs[2]))
    check(torch.equal(gbufs[0], gbufs[2]), "kernel 8 boundary adjoints != "
          "plain")
    check(torch.equal(gbufs[0], gbufs[1]) and all(
        torch.equal(u, v) for u, v in zip(k1, k2)),
        "kernel 8 differs between two runs")
    errs = [sums_err(k1[i], p[i]) for i in range(3)] + [
        sums_err(k1[3].reshape(1, -1, 1), p[3].reshape(1, -1, 1))]
    check(max(errs) <= SEG_SUM_RTOL, f"kernel 8 site sums vs plain: {errs} "
          f"of scale > {SEG_SUM_RTOL}")
    abs_err = max(float((u - v).abs().max()) for u, v in zip(k1, p))
    del k1, k2, p, gbufs
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: plf_tree_seg_bwd(*bargs, seg_ops=plan.seg_ops),
                 reps=3, warmup=1)
    bd = seg_bwd_bound(pm, plan)
    E, rows = len(pm.schedule), pm.config.rows
    ck4 = tree_bwd_scratch_bytes(E, rows, pm.n_pad)
    resident = seg_mod._resident_blocks(pm.device, pm.codes.element_size(),
                                        pm.config.categories,
                                        pm.fused_tip_table.shape[1],
                                        plan.seg_ops, bbuf.dtype == BF16)
    sms = torch.cuda.get_device_properties(pm.device).multi_processor_count
    phase(name, f"{E} nodes x {pm.n_sites} sites, {pm.config.dtype} "
          f"storage, {len(plan.segments)} "
          f"segments of at most {plan.seg_ops} ops: boundary adjoints == "
          f"plain bit for bit, gl/gr/gec/grr within {max(errs):.2e} of scale "
          f"(max abs {abs_err:.3g}), bit-identical run to run; "
          f"{resident // sms} blocks of {seg_mod.SEG_SITES} threads per SM; "
          f"device-memory checkpoint "
          f"{bbuf.numel() * bbuf.element_size() / 1e9:.3f} GB "
          f"({plan.n_boundaries} boundaries) against kernel 4's "
          f"{ck4 / 1e9:.2f} GB; kernel {ms:.3f} ms (bound "
          f"{bd['bound_ms']:.3f} ms by {bd['bound_by']}), plain "
          f"{plain_ms:.1f} ms")
    del bbuf, lik
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=abs_err, **bd), glik


def seg_cap_probe(pm, glik):
    """Kernels 7 and 8 on plans cut for 4, 6, 8 and 10 kernel-8 blocks per
    SM (the capacity rule's SEG_BLOCKS_PER_SM; 8 is the library's): the
    trade of segment size against occupancy the rule picks from."""
    keep = seg_mod.SEG_BLOCKS_PER_SM
    sched = reorder_schedule(pm.schedule, pm.tree.n_leaves)
    pos = [(p, l, r, 0.0, 0.0, i) for i, (p, l, r, *_x) in enumerate(sched)]
    try:
        for bpsm in (4, 6, 8, 10):
            seg_mod.SEG_BLOCKS_PER_SM = bpsm
            plan = seg_mod.plan_segments(pos, pm.tree.n_leaves,
                                         rows=pm.config.rows,
                                         n_codes=pm.fused_tip_table.shape[1])
            prog, segs, _ = segment_program(plan, sched, reuse_slots=True)
            cprog, n_slots = carry_segment_program(prog, segs)
            bprog, bsegs, _ = segment_program(plan, sched, reuse_slots=False)
            fp, fs, bp, bs = (torch.as_tensor(a, device=pm.device)
                              for a in (cprog, segs, bprog, bsegs))
            args = (pm.codes, fp, fs, pm.lcs, pm.rcs, pm.ec,
                    pm.fused_tip_table, pm.root_rows[0], pm.n_sites)
            kw = dict(n_boundaries=plan.n_boundaries, n_slots=n_slots)
            _, _, bbuf = kernel7(*args, **kw)
            bargs = (pm.codes, bp, bs, pm.lcs, pm.rcs, pm.ec,
                     pm.fused_tip_table, pm.root_rows[0], glik, bbuf,
                     pm.n_sites)
            ms7 = cuda_ms(lambda: kernel7(*args, **kw), reps=3)
            ms8 = cuda_ms(lambda: plf_tree_seg_bwd(*bargs,
                                                   seg_ops=plan.seg_ops),
                          reps=3, warmup=1)
            cap = seg_mod.seg_cap_ops(pm.config.rows,
                                      pm.fused_tip_table.shape[1])
            phase("kernel8", f"plan for {bpsm} blocks per SM: cap {cap} "
                  f"ops, {len(plan.segments)} segments (at most "
                  f"{plan.seg_ops} ops), {plan.n_boundaries} boundaries: "
                  f"kernel 7 {ms7:.3f} ms, kernel 8 {ms8:.3f} ms")
            del bbuf, bargs
            torch.cuda.empty_cache()
    finally:
        seg_mod.SEG_BLOCKS_PER_SM = keep


def _step_pair(pm, dev, reps=3):
    """One "tree" and one "segmented" value-and-gradient step on ``pm``:
    the launches of each, their values, gradients and the last launch's
    chunking of each backward that keeps a device-memory checkpoint
    (kernel 4 or 4m; kernel 8m), and their wall times (medians of
    ``reps``, in turns: tree, segmented x 2, tree)."""
    fns = {b: tree_loglik_fn(pm, backend=b) for b in ("tree", "segmented")}
    mxu = plf_mxu.uses_mxu_kernels(pm.config.resolved_kernel_variant,
                                   pm.config.states)
    ckpt = {"tree": plf_tree_bwd_mxu if mxu else plf_tree_bwd,
            "segmented": plf_tree_seg_bwd_mxu if mxu else None}
    out = {}
    for b, (fn, t0) in fns.items():
        v, g, counts = _step_launches(fn, t0, dev)
        out[b] = dict(v=v, g=g.cpu().numpy(), counts=counts,
                      engine=fn.engine, variant=fn.variant,
                      scratch=dict(getattr(ckpt[b], "last_scratch",
                                           None) or {}))
    times = {b: [] for b in fns}
    for b in ("tree", "segmented", "segmented", "tree"):
        fn, t0 = fns[b]
        times[b].append(_median_ms(lambda: _grad_step(fn, t0, dev),
                                   reps=reps))
    for b in fns:
        out[b]["ms"] = times[b]
    return out


def segmented_phase(dev, pm):
    """The segmented main paths: log_likelihood(method="segmented") with
    exactly one kernel-7 launch, equal to the fused path site for site; a
    "segmented" value-and-gradient step with exactly one launch each of
    kernels 7 and 8, against the "tree" step (values rel 1e-6, gradients
    within SEG_GRAD_RTOL of scale), with both step times and checkpoint
    sizes, at 160 taxa x 2^20 and at 256 taxa x 2^22 with int8 tips (where
    kernel 4's checkpoint runs in chunks); auto takes "segmented" at both,
    the faster step for DNA."""
    fused = pm.log_likelihood()
    _reset_counts()
    t0 = time.perf_counter()
    seg = pm.log_likelihood(method="segmented")
    wall = (time.perf_counter() - t0) * 1e3
    serve = {k: c for k, c in _counts().items() if c}
    check(serve == {"plf_tree_seg": 1}, f"method='segmented' launched "
          f"{serve}")
    check(np.array_equal(seg.site_log_likelihood, fused.site_log_likelihood)
          and seg.scaler_total == fused.scaler_total,
          "segmented log_likelihood != fused")
    phase("segmented", f"log_likelihood(method='segmented') = "
          f"{seg.log_likelihood:.6f} == fused site for site, launches "
          f"{serve}, {wall:.2f} ms wall")
    launches = dict(serve)
    rng = np.random.default_rng(SEG_BIG_TAXA)
    p = np.concatenate([[0.04], np.full(4, 0.22), np.full(10, 0.008)])
    for m in (pm, None):
        if m is None:
            t0 = time.perf_counter()
            tips = rng.choice(np.arange(-1, 14, dtype=np.int8),
                              size=(SEG_BIG_TAXA, SEG_BIG_SITES),
                              p=p / p.sum())
            m = PhyloModel(random_tree(SEG_BIG_TAXA, seed=4), hky85(2.0),
                           tips, alpha=0.5, device=dev,
                           config=PLFConfig(tip_dtype="int8"))
            del tips
            phase("segmented", f"{SEG_BIG_TAXA} taxa x {SEG_BIG_SITES} "
                  f"patterns, int8 tips: model built in "
                  f"{time.perf_counter() - t0:.1f} s")
        res = _step_pair(m, dev)
        want = {"tree": {"plf_tree": 1, "plf_tree_bwd": 1},
                "segmented": {"plf_tree_seg": 1, "plf_tree_seg_bwd": 1}}
        for b, r in res.items():
            check(r["counts"] == want[b] and r["engine"] == b
                  and r["variant"] == "vpu",
                  f"{b} step launched {r['counts']} ({r['engine']})")
        if m is pm:
            launches["plf_tree_seg_bwd"] = res["segmented"]["counts"].get(
                "plf_tree_seg_bwd", 0)
        g_t, g_s = res["tree"]["g"], res["segmented"]["g"]
        err = float(np.abs(g_s - g_t).max() / np.abs(g_t).max())
        rel = abs(res["segmented"]["v"] / res["tree"]["v"] - 1)
        check(rel < 1e-6 and err <= SEG_GRAD_RTOL,
              f"segmented vs tree step at {m.tree.n_leaves} taxa: value rel "
              f"{rel}, gradient {err} of scale")
        plan = m._segmented_inputs()[0]
        gb = plan.n_boundaries * 4 * m.config.rows * m.n_pad / 1e9
        sc4 = res["tree"]["scratch"]
        auto = tree_loglik_fn(m)[0].engine
        check(auto == "segmented",
              f"auto took {auto!r} at {m.tree.n_leaves} taxa")
        phase("segmented", f"{m.tree.n_leaves} taxa x {m.n_sites} sites: one "
              f"value+gradient step 'tree' {res['tree']['ms']} ms, "
              f"'segmented' {res['segmented']['ms']} ms wall (medians of 3, "
              f"in turns); launches {res['tree']['counts']} / "
              f"{res['segmented']['counts']}; checkpoint: kernel 4 "
              f"{sc4.get('bytes', 0) / 1e9:.2f} GB in {sc4.get('chunks')} "
              f"chunk(s), kernel 8 {gb:.3f} GB ({plan.n_boundaries} "
              f"boundaries, {len(plan.segments)} "
              f"segments); value rel {rel:.2e}, gradient within {err:.2e} of "
              f"scale (max|g| {np.abs(g_t).max():.4g}); auto takes {auto!r}")
        if m is not pm:
            plan_b, fwd, (bprog, bsegs) = seg_inputs(m)
            args, kw = _seg_args(m, fwd)
            lik, _, bbuf = kernel7(*args, **kw)
            glik = (m.wgt_pad.to(torch.float32) / lik).contiguous()
            bargs = (m.codes, bprog, bsegs, m.lcs, m.rcs, m.ec,
                     m.fused_tip_table, m.root_rows[0], glik, bbuf,
                     m.n_sites)
            ms7 = cuda_ms(lambda: kernel7(*args, **kw), reps=3)
            ms8 = cuda_ms(lambda: plf_tree_seg_bwd(*bargs,
                                                   seg_ops=plan_b.seg_ops),
                          reps=3, warmup=1)
            bd7, bd8 = seg_fwd_bound(m, plan_b), seg_bwd_bound(m, plan_b)
            phase("segmented", f"{m.tree.n_leaves} taxa x {m.n_sites} sites: "
                  f"kernel 7 {ms7:.3f} ms (bound {bd7['bound_ms']:.3f} ms), "
                  f"kernel 8 {ms8:.3f} ms (bound {bd8['bound_ms']:.3f} ms)")
            del lik, bbuf, glik, bargs, args, m
            torch.cuda.empty_cache()
    return launches


# ------------------------------ the segmented engine's matrix forms --


def _seg_mxu_args(pm, plan, fwd):
    """Kernel 7m's arguments on a model's plan (its program ``fwd`` =
    (prog, segs, n_slots))."""
    cfg = pm.config
    prog, segs, n_slots = fwd
    return ((pm.codes, prog, segs, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
             pm.root_rows[0], pm.n_sites),
            dict(n_boundaries=plan.n_boundaries, n_slots=n_slots,
                 states=cfg.states, categories=cfg.categories,
                 variant=cfg.resolved_kernel_variant, planes=pm._planes(),
                 dtype=getattr(torch, cfg.dtype)))


def kernel7m_against(pm, label, plain=True, name="kernel7m"):
    """Kernel 7m on the model's own plan against kernel 2m (lik and sc;
    with fp32 boundaries only) and, with ``plain``, its plain version
    (lik, sc and every boundary CLV), bit for bit; its time beside kernel
    2m's.  Prints under phase ``name``."""
    cfg = pm.config
    plan, fwd, _ = seg_inputs(pm)
    args, kw = _seg_mxu_args(pm, plan, fwd)
    lik, sc, bbuf = plf_tree_seg_mxu(*args, **kw)
    kargs = (pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
             pm.root_rows[0], pm.n_sites)
    kkw = dict(n_slots=pm.n_slots, root_slot=pm.root_slot, states=cfg.states,
               categories=cfg.categories,
               variant=cfg.resolved_kernel_variant, planes=pm._planes())
    ref = plf_tree_mxu(*kargs, **kkw)
    rounded = kw["dtype"] != torch.float32 and plan.n_boundaries > 0
    if rounded:
        check(not torch.equal(lik, ref[0]),
              f"kernel 7m with bf16 boundaries == kernel 2m ({label})")
    else:
        check(torch.equal(lik, ref[0]) and torch.equal(sc, ref[1]),
              f"kernel 7m != kernel 2m ({label}, {kw['variant']})")
    plain_ms, note = None, ""
    if plain:
        want, plain_ms = timed(lambda: plf_tree_seg_torch(*args, **kw))
        check(all(torch.equal(a, b) for a, b in zip((lik, sc, bbuf), want)),
              f"kernel 7m != its plain version ({label}, {kw['variant']})")
        note = f", lik, sc and {plan.n_boundaries} boundaries == plain"
        del want
    del bbuf
    ms = cuda_ms(lambda: plf_tree_seg_mxu(*args, **kw), reps=3, warmup=1)
    ms2 = cuda_ms(lambda: plf_tree_mxu(*kargs, **kkw), reps=3, warmup=1)
    bd = seg_fwd_bound(pm, plan)
    same = (f"{cfg.dtype} boundaries, lik != kernel 2m's" if rounded
            else "lik and sc == kernel 2m")
    threads, rows = tree_seg_mxu_block(cfg.states, cfg.categories,
                                       kw["dtype"])
    blocks = plf_tree_seg_mxu_occupancy(
        pm.codes.dtype, cfg.states, cfg.categories, pm.tip_table.shape[1],
        fwd[2], kw["variant"], kw["dtype"])
    phase(name, f"{label}, {kw['variant']}: {pm.tree.n_leaves} taxa x "
          f"{pm.n_sites} sites, S={cfg.states}: {len(plan.segments)} "
          f"segments (at most {plan.seg_ops} ops), {fwd[2]} arena slots; "
          f"blocks of {threads} threads ({rows}-row jobs), {blocks} per SM; "
          f"{same}{note}, bit for bit ({int(sc.sum())} "
          f"rescales); kernel {ms:.3f} ms (kernel 2m {ms2:.3f} ms; bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']})"
          + ("" if plain_ms is None else f", plain {plain_ms:.1f} ms"))
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=0.0, **bd)


def kernel7m_phase(models, codon, dna, dev):
    """Kernel 7m == kernel 2m == its plain version, bit for bit, on the
    protein workload in each variant; at S = 61 on the codon workload
    against kernel 2m, on its first 8,192 codons against the plain version
    too; and at S = 4 (DNA in the matrix forms, blocks of 32 threads) on
    the 160 x 2^20 workload in each variant against kernel 2m, on its
    first 8,192 sites against the plain version too."""
    res = {v: kernel7m_against(models[v], "protein")
           for v in ("mxu_3x", "mxu", "mxu_bf16")}
    tree, tips, gy, cmodels = codon
    for v in ("mxu", "mxu_3x"):
        kernel7m_against(cmodels[v], "codon", plain=False)
        pm = PhyloModel(tree, gy, tips[:, :CODON_K4_SITES], alpha=0.7,
                        device=dev, config=PLFConfig(states=61,
                                                     kernel_variant=v))
        kernel7m_against(pm, "codon")
        del pm
    torch.cuda.empty_cache()
    tree, tips = dna
    for v in MXU_VARIANTS:
        for label, t in (("dna", tips), ("dna", tips[:, :DNA_SEG_SLICE])):
            pm = PhyloModel(tree, hky85(2.0), t, alpha=0.5, device=dev,
                            config=PLFConfig(kernel_variant=v))
            kernel7m_against(pm, label, plain=t is not tips)
            del pm
            torch.cuda.empty_cache()
    return res


def kernel8m_against(pm, glik, label, chunks=False, name="kernel8m"):
    """Kernel 8m against its plain version on the model's own plan:
    boundary adjoints bit for bit, site sums within SEG_MXU_SUM_RTOL of
    scale (with ``chunks`` also under a quarter of the one-chunk
    checkpoint), bit-identical run to run; its time and memory beside
    kernel 4m's.  Prints under phase ``name``."""
    cfg = pm.config
    plan, fwd, (bprog, bsegs) = seg_inputs(pm)
    args, kw = _seg_mxu_args(pm, plan, fwd)
    _, _, bbuf = plf_tree_seg_mxu(*args, **kw)
    bargs = (pm.codes, bprog, bsegs, pm.lcs, pm.rcs, pm.ec,
             pm.fused_tip_table, pm.root_rows[0], glik, bbuf, pm.n_sites)
    bkw = dict(states=cfg.states, categories=cfg.categories,
               variant=kw["variant"], planes=kw["planes"])
    gbufs = [torch.empty_like(bbuf) for _ in range(3)]
    k1 = plf_tree_seg_bwd_mxu(*bargs, seg_ops=plan.seg_ops, gbuf=gbufs[0],
                              **bkw)
    chunking = dict(plf_tree_seg_bwd_mxu.last_scratch)
    k2 = plf_tree_seg_bwd_mxu(*bargs, seg_ops=plan.seg_ops, gbuf=gbufs[1],
                              **bkw)
    ks, note = [k1], ""
    if chunks:
        budget = chunking["bytes"] // 4
        ks.append(plf_tree_seg_bwd_mxu(*bargs, seg_ops=plan.seg_ops,
                                       max_scratch_bytes=budget, **bkw))
        small = dict(plf_tree_seg_bwd_mxu.last_scratch)
        check(small["chunks"] > 1, f"budget {budget} gave one chunk")
        note = (f" and in {small['chunks']} chunks of "
                f"{small['chunk_sites']} sites")
    p, plain_ms = timed(lambda: plf_tree_seg_bwd_torch(*bargs, gbuf=gbufs[2],
                                                       **bkw))
    check(torch.equal(gbufs[0], gbufs[2]),
          f"kernel 8m ({label}) boundary adjoints != plain")
    check(torch.equal(gbufs[0], gbufs[1]) and all(
        torch.equal(u, v) for u, v in zip(k1, k2)),
        f"kernel 8m ({label}) differs between two runs")
    errs = [max([sums_err(k[i], p[i]) for i in range(3)]
                + [sums_err(k[3].reshape(1, -1, 1), p[3].reshape(1, -1, 1))])
            for k in ks]
    check(max(errs) <= SEG_MXU_SUM_RTOL, f"kernel 8m ({label}) site sums vs "
          f"plain: {errs} of scale > {SEG_MXU_SUM_RTOL}")
    abs_err = max(float((u - v).abs().max()) for u, v in zip(k1, p))
    del k1, k2, ks, p, gbufs
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: plf_tree_seg_bwd_mxu(*bargs, seg_ops=plan.seg_ops,
                                              **bkw), reps=3, warmup=1)
    bd = seg_bwd_bound(pm, plan)
    ck4 = tree_bwd_scratch_bytes(len(pm.schedule), cfg.rows, pm.n_pad)
    phase(name, f"{label}, {kw['variant']}: {len(pm.schedule)} nodes x "
          f"{pm.n_sites} sites, S={cfg.states}, {len(plan.segments)} "
          f"segments of at most {plan.seg_ops} ops: boundary adjoints == "
          f"plain bit for bit, gl/gr/gec/grr within {max(errs):.2e} of scale "
          f"(max abs {abs_err:.3g}){note}, bit-identical run to run; "
          f"{chunking['blocks']} blocks on {chunking['tile_sites']}-site "
          f"tiles, accumulators in "
          f"{'shared' if chunking['acc_shared'] else 'device'} memory; "
          f"device memory: op checkpoint {chunking['bytes'] / 1e9:.3f} GB, "
          f"boundaries and adjoints "
          f"{2 * bbuf.numel() * bbuf.element_size() / 1e9:.3f} GB "
          f"({plan.n_boundaries} boundaries) against kernel 4m's "
          f"{ck4 / 1e9:.2f} GB; kernel {ms:.3f} ms (bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}), plain "
          f"{plain_ms:.1f} ms")
    del bbuf, bargs
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=abs_err, **bd)


def kernel8m_phase(models, codon, dev):
    """Kernel 8m against its plain version: each variant on the protein
    workload with the default model's step cotangent ("mxu_3x" also in
    several chunks), then "mxu" and "mxu_3x" at S = 61 on the first 8,192
    codons of the codon workload; then kernels 7m and 8m on plans cut at
    three caps."""
    glik = step_cotangent(models["mxu_3x"])
    res = {}
    for variant in ("mxu_3x", "mxu", "mxu_bf16"):
        res[variant] = kernel8m_against(models[variant], glik, "protein",
                                        chunks=variant == "mxu_3x")
    tree, tips, gy, _ = codon
    for variant in ("mxu", "mxu_3x"):
        pm = PhyloModel(tree, gy, tips[:, :CODON_K4_SITES], alpha=0.7,
                        device=dev,
                        config=PLFConfig(states=61, kernel_variant=variant))
        kernel8m_against(pm, step_cotangent(pm), "codon")
        del pm
    torch.cuda.empty_cache()
    mxu_cap_probe(models["mxu_3x"], glik)
    return res


def mxu_cap_probe(pm, glik):
    """Kernels 7m and 8m on plans cut at the matrix forms' rule's cap, half
    of it and twice it (seg_mxu_cap_ops): the device memory each needs
    per site against their times."""
    cfg = pm.config
    sched = reorder_schedule(pm.schedule, pm.tree.n_leaves)
    pos = [(p, l, r, 0.0, 0.0, i) for i, (p, l, r, *_x) in enumerate(sched)]
    n_codes = pm.tip_table.shape[1]
    rule = seg_mod.seg_mxu_cap_ops(pos, pm.tree.n_leaves, rows=cfg.rows,
                                   n_codes=n_codes)
    for cap in (max(2, rule // 2), rule, 2 * rule):
        plan = seg_mod.plan_segments(pos, pm.tree.n_leaves, rows=cfg.rows,
                                     cap_ops=cap, n_codes=n_codes,
                                     matrix_form=True)
        progs = [segment_program(plan, sched, reuse_slots=r)
                 for r in (True, False)]
        (fp, fs, n_slots), (bp, bs, _) = [
            (torch.as_tensor(a, device=pm.device),
             torch.as_tensor(b, device=pm.device), c) for a, b, c in progs]
        args, kw = _seg_mxu_args(pm, plan, (fp, fs, n_slots))
        _, _, bbuf = plf_tree_seg_mxu(*args, **kw)
        bargs = (pm.codes, bp, bs, pm.lcs, pm.rcs, pm.ec,
                 pm.fused_tip_table, pm.root_rows[0], glik, bbuf, pm.n_sites)
        bkw = dict(seg_ops=plan.seg_ops, states=cfg.states,
                   categories=cfg.categories, variant=kw["variant"],
                   planes=kw["planes"])
        ms7 = cuda_ms(lambda: plf_tree_seg_mxu(*args, **kw), reps=3)
        ms8 = cuda_ms(lambda: plf_tree_seg_bwd_mxu(*bargs, **bkw), reps=2,
                      warmup=1)
        per_site = seg_mod.seg_mxu_site_bytes(plan, cfg.rows)
        phase("kernel8m", f"cap {cap} ops{' (the rule)' if cap == rule else ''}"
              f": {len(plan.segments)} segments (at most {plan.seg_ops} ops), "
              f"{plan.n_boundaries} boundaries, {per_site} bytes per site "
              f"({per_site * pm.n_pad / 1e9:.3f} GB): kernel 7m {ms7:.3f} "
              f"ms, kernel 8m {ms8:.3f} ms")
        del bbuf, bargs
        torch.cuda.empty_cache()


def _check_step_pair(pm, res, label):
    """The launches of each step, the two values equal (kernel 7m ==
    kernel 2m), the gradients within SEG_MXU_GRAD_RTOL of scale; returns
    the gradient's distance and the pair's line."""
    variant = pm.config.resolved_kernel_variant
    want = {"tree": {"plf_tree_mxu": 1, "plf_tree_bwd_mxu": 1},
            "segmented": {"plf_tree_seg_mxu": 1, "plf_tree_seg_bwd_mxu": 1}}
    for b, r in res.items():
        check(r["counts"] == want[b] and r["engine"] == b
              and r["variant"] == variant,
              f"{label}: {b} step launched {r['counts']} ({r['engine']})")
    g_t, g_s = res["tree"]["g"], res["segmented"]["g"]
    err = float(np.abs(g_s - g_t).max() / np.abs(g_t).max())
    check(res["segmented"]["v"] == res["tree"]["v"]
          and err <= SEG_MXU_GRAD_RTOL,
          f"{label}: segmented vs tree step values {res['segmented']['v']} "
          f"/ {res['tree']['v']}, gradient {err} of scale")
    plan = pm._segmented_inputs()[0]
    sc4, sc8 = res["tree"]["scratch"], res["segmented"]["scratch"]
    bnd = 2 * plan.n_boundaries * 4 * pm.config.rows * pm.n_pad
    return (f"{label}, {variant}: one value+gradient step 'tree' "
            f"{res['tree']['ms']} ms, 'segmented' {res['segmented']['ms']} "
            f"ms wall (in turns); launches {res['tree']['counts']} / "
            f"{res['segmented']['counts']}; device memory: kernel 4m "
            f"{sc4['bytes'] / 1e9:.2f} GB in {sc4['chunks']} chunk(s), "
            f"kernel 8m {sc8['bytes'] / 1e9:.3f} GB in {sc8['chunks']} "
            f"chunk(s) + {bnd / 1e9:.3f} GB of boundaries and adjoints "
            f"({plan.n_boundaries} boundaries, {len(plan.segments)} "
            f"segments); values equal, gradient within {err:.2e} of scale "
            f"(max|g| {np.abs(g_t).max():.4g})")


def protein_segmented_phase(models, dev):
    """The protein segmented main paths: log_likelihood(method=
    "segmented") with exactly one kernel-7m launch, equal to the fused path
    site for site; a "segmented" value-and-gradient step with exactly one
    launch each of kernels 7m and 8m against the "tree" step (value equal,
    gradient within SEG_MXU_GRAD_RTOL of scale), "mxu_3x" and "mxu", at 64
    taxa x 131,072 sites, then the step pair at 1,024 taxa x 131,072 with
    int8 tips, where kernel 4m's checkpoint runs in chunks, timed with
    both backends' memory, "mxu_3x" and "mxu", and the auto rule's choice
    there ("tree" in both: _segmented_wins); last
    a Backend.TORCH model on the card against the kernel path."""
    pm = models["mxu_3x"]
    fused = pm.log_likelihood()
    _reset_counts()
    t0 = time.perf_counter()
    seg = pm.log_likelihood(method="segmented")
    wall = (time.perf_counter() - t0) * 1e3
    serve = {k: c for k, c in _counts().items() if c}
    check(serve == {"plf_tree_seg_mxu": 1}, f"method='segmented' launched "
          f"{serve}")
    check(np.array_equal(seg.site_log_likelihood, fused.site_log_likelihood)
          and seg.scaler_total == fused.scaler_total,
          "protein segmented log_likelihood != fused")
    phase("protein_segmented", f"log_likelihood(method='segmented') = "
          f"{seg.log_likelihood:.6f} (mxu_3x) == fused site for site, "
          f"launches {serve}, {wall:.2f} ms wall")
    launches = dict(serve)
    for variant in ("mxu_3x", "mxu"):
        m = models[variant]
        res = _step_pair(m, dev)
        if variant == "mxu_3x":
            launches["plf_tree_seg_bwd_mxu"] = res["segmented"]["counts"].get(
                "plf_tree_seg_bwd_mxu", 0)
        phase("protein_segmented", _check_step_pair(
            m, res, f"{m.tree.n_leaves} taxa x {m.n_sites} sites")
              + "; medians of 3")
    torch.cuda.empty_cache()

    rng = np.random.default_rng(BIG_PROT_TAXA)
    p = np.concatenate([[0.04], np.full(20, 0.0475), np.full(3, 0.01)])
    tips = rng.choice(np.arange(-1, 23, dtype=np.int8),
                      size=(BIG_PROT_TAXA, PROT_SITES), p=p / p.sum())
    for variant, rule in (("mxu_3x", "tree"), ("mxu", "tree")):
        t0 = time.perf_counter()
        big = PhyloModel(random_tree(BIG_PROT_TAXA, seed=1),
                         empirical_protein("lg"), tips, alpha=0.5,
                         device=dev,
                         config=PLFConfig(states=20, kernel_variant=variant,
                                          tip_dtype="int8"))
        torch.cuda.synchronize()
        ck4 = tree_bwd_scratch_bytes(len(big.schedule), big.config.rows,
                                     big.n_pad)
        phase("protein_segmented", f"{BIG_PROT_TAXA} taxa x {PROT_SITES} "
              f"sites, LG+G4, {variant}, int8 tips: model built in "
              f"{time.perf_counter() - t0:.1f} s; kernel 4m's checkpoint "
              f"{ck4 / 1e9:.1f} GB")
        res = _step_pair(big, dev, reps=1)
        line = _check_step_pair(big, res, f"{BIG_PROT_TAXA} taxa x "
                                f"{big.n_sites} sites")
        auto = tree_loglik_fn(big)[0].engine
        check(auto == rule, f"auto took {auto!r} for {variant} at "
              f"{BIG_PROT_TAXA} taxa, not {rule!r}")
        phase("protein_segmented", line + f"; one step per turn; auto "
              f"takes {auto!r}")
        del big, res
        torch.cuda.empty_cache()
    del tips

    tree = pm.tree
    ref = models["mxu"]
    torch_pm = PhyloModel(tree, ref.model, ref.tip_states, alpha=0.5,
                          device=dev, config=PLFConfig(
                              states=20, kernel_variant="mxu",
                              backend=Backend.TORCH))
    _reset_counts()
    t0 = time.perf_counter()
    out = torch_pm.log_likelihood()
    wall = (time.perf_counter() - t0) * 1e3
    ran = {k: c for k, c in _counts().items() if c}
    want = ref.log_likelihood()
    rel = abs(out.log_likelihood / want.log_likelihood - 1)
    check(not ran and not torch_pm.can_fuse() and not torch_pm.can_segment()
          and rel < 1e-5 and out.scaler_total == want.scaler_total,
          f"Backend.TORCH on the card: launches {ran}, rel {rel} to the "
          f"kernel path, rescale totals {out.scaler_total} / "
          f"{want.scaler_total}")
    phase("protein_segmented", f"Backend.TORCH model on the card: "
          f"log_likelihood() {out.log_likelihood:.6f} by the plain "
          f"site-major path, no kernel launched, rel {rel:.2e} to the "
          f"kernel path ('mxu'), {wall:.1f} ms wall")
    del torch_pm
    return launches


# ------------------------------------------------------ bf16 CLV storage --

BF16 = torch.bfloat16
#: A bf16-storage result against the fp32 model's: the value within this
#: share (tests/test_tree_seg.py:416), the gradient within BF16_GRAD_REL of
#: each entry with a BF16_GRAD_FLOOR floor (:449-450), the JAX package's
#: classes for its own bf16 storage.
BF16_LL_REL = 5e-3
BF16_GRAD_REL, BF16_GRAD_FLOOR = 0.05, 1e-2


def _main_path(run):
    """``run()`` with every launch count set to 0 just before; returns its
    result, the launches it made (either storage) and the bf16 ones."""
    _reset_counts()
    out = run()
    torch.cuda.synchronize()
    return (out, {k: c for k, c in _counts().items() if c},
            {k: c for k, c in _bf16_counts().items() if c})


def _bf16_grad_err(g16, g32):
    g16, g32 = np.asarray(g16, np.float64), np.asarray(g32, np.float64)
    return float(np.max(np.abs(g16 - g32) / (np.abs(g32) + BF16_GRAD_FLOOR)))


def bf16_kernel1(dev, node_case):
    """Kernel 1's bf16 form: PLFEngine(dtype="bfloat16").plf on the
    forced-underflow case (the main path: the bf16 kernel once), x3 the
    bf16 rounding of the fp32 kernel's (golden-exact) x3 on the rounded
    inputs; then at 2^24 sites == the plain version bit for bit, out of
    place and in place, timed beside the fp32 form and a same-run 2R+1W
    probe of the same bf16 bytes."""
    x1, x2, left, right, ev = node_case
    eng = PLFEngine(PLFConfig(dtype="bfloat16"), device=dev)
    out, ran, ran16 = _main_path(lambda: eng.plf(x1, x2, left, right, ev))
    check(ran == ran16 == {"plf_node": 1},
          f"PLFEngine.plf under bf16 launched {ran} ({ran16} bf16)")
    rnd = lambda a: torch.as_tensor(a).to(BF16).float().numpy()
    f32 = PLFEngine(PLFConfig(), device=dev).plf(rnd(x1), rnd(x2), left,
                                                 right, ev)
    n_flag = int(out.scaler_vector.sum())
    check(out.x3.dtype == BF16 and torch.equal(out.x3, f32.x3.to(BF16))
          and torch.equal(out.scaler_vector, f32.scaler_vector)
          and n_flag > 0, "PLFEngine.plf under bf16 != bf16 of the fp32 "
          "kernel on the rounded inputs")
    phase("bf16", f"PLFEngine(dtype='bfloat16').plf, forced-underflow "
          f"case, {len(x1)} sites: bf16 kernel 1 once ({ran16}); x3 bf16 == "
          f"bf16 of the fp32 kernel's x3 on the rounded inputs, flags equal "
          f"({n_flag} rescaled)")
    del out, f32
    nb = NODE_SITES_BIG
    nb_pad = L.sites_padding(nb, UNIT)
    g = torch.Generator(device=dev).manual_seed(7)
    a = torch.rand((16, nb_pad), generator=g, device=dev)
    b = torch.rand((16, nb_pad), generator=g, device=dev)
    a[:, 0::4] *= 1e-12
    a[:, nb:] = 0.0
    b[:, nb:] = 0.0
    a16, b16 = a.to(BF16), b.to(BF16)
    lc, rc, ec = lane_constants(left, right, ev, dev)
    x3k, sck = plf_node(a16, b16, lc, rc, ec, nb)
    x3p, scp = plf_node_torch(a16, b16, lc, rc, ec, nb)
    x3f, scf = plf_node(a16.float(), b16.float(), lc, rc, ec, nb)
    a2 = a16.clone()
    x3i, sci = plf_node(a2, b16, lc, rc, ec, nb, out=a2)
    torch.cuda.synchronize()
    check(torch.equal(x3k, x3p) and torch.equal(sck, scp)
          and x3i.data_ptr() == a2.data_ptr() and torch.equal(x3i, x3p)
          and torch.equal(sci, scp), "kernel 1 (bf16) != plain at 2^24")
    check(torch.equal(x3k, x3f.to(BF16)) and torch.equal(sck, scf),
          "kernel 1 (bf16) != bf16 of kernel 1 (fp32) on the widened inputs")
    n_flag = int(sck.sum())
    del x3p, scp, x3f, scf, a2, x3i, sci
    torch.cuda.empty_cache()
    ms16 = cuda_ms(lambda: plf_node(a16, b16, lc, rc, ec, nb), reps=20)
    ms32 = cuda_ms(lambda: plf_node(a, b, lc, rc, ec, nb), reps=20)
    c16 = torch.empty_like(a16)
    ms_probe = cuda_ms(lambda: torch.add(a16, b16, out=c16), reps=20)
    ms_plain = cuda_ms(lambda: plf_node_torch(a16, b16, lc, rc, ec, nb),
                       reps=3, warmup=1)
    fwd, _ = node_work(4, 4)
    bd = bound(100 * nb_pad, fwd * nb_pad, FP32_FLOPS)
    gbs = 100 * nb_pad / (ms16 * 1e-3) / 1e9
    probe_gbs = 3 * a16.numel() * 2 / (ms_probe * 1e-3) / 1e9
    phase("bf16", f"kernel 1, bf16 storage, {nb} sites: == plain out of "
          f"place and in place ({n_flag} rescaled); kernel {ms16:.4f} ms "
          f"({gbs:.0f} GB/s at 100 B/site, {100 * gbs / probe_gbs:.1f}% of a "
          f"same-run bf16 2R+1W torch.add probe at {probe_gbs:.0f} GB/s; "
          f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}); fp32 form "
          f"{ms32:.4f} ms; plain {ms_plain:.3f} ms")
    del a, b, a16, b16, c16, x3k, sck
    torch.cuda.empty_cache()
    return dict(launches=ran16["plf_node"], ms=ms16, plain_ms=ms_plain,
                max_abs_err=0.0, **bd)


def bf16_kernel1m(dev):
    """Kernel 1m's bf16 form in "mxu_3x" at S = 20 on 2^21 sites: == the
    plain version bit for bit, out of place and in place, timed beside the
    fp32 form; then PLFEngine(states=20, "mxu_3x", dtype="bfloat16").plf on
    its first 65,536 sites (the main path: the bf16 kernel once), equal
    to it site for site."""
    S, C, n = 20, 4, NODE_MXU_SITES
    a, b, (left, right, ev), (lc, rc, ec) = _mxu_case(dev, n, S, C, 21)
    a16, b16 = a.to(BF16), b.to(BF16)
    kw = dict(states=S, categories=C, variant="mxu_3x")
    x3k, sck = plf_node_mxu(a16, b16, lc, rc, ec, n, **kw)
    x3p, scp = plf_node_mxu_torch(a16, b16, lc, rc, ec, n, **kw)
    b2 = b16.clone()
    x3i, sci = plf_node_mxu(a16, b2, lc, rc, ec, n, out=b2, **kw)
    torch.cuda.synchronize()
    n_flag = int(sck.sum())
    check(torch.equal(x3k, x3p) and torch.equal(sck, scp)
          and torch.equal(x3i, x3p) and torch.equal(sci, scp) and n_flag > 0,
          "kernel 1m (bf16, mxu_3x) != plain version")
    del x3p, scp, b2, x3i, sci
    m = NODE_MXU_GOLDEN
    site_major = lambda t: np.ascontiguousarray(
        L.from_lane_major(t[:, :m].float().cpu().numpy(), S, C))
    eng = PLFEngine(PLFConfig(states=S, kernel_variant="mxu_3x",
                              dtype="bfloat16"), device=dev)
    out, ran, ran16 = _main_path(lambda: eng.plf(
        site_major(a16), site_major(b16), left, right, ev))
    check(ran == ran16 == {"plf_node_mxu": 1},
          f"PLFEngine.plf (S=20, bf16) launched {ran} ({ran16} bf16)")
    check(out.x3.dtype == BF16 and np.array_equal(
        out.x3.float().cpu().numpy(), site_major(x3k)),
        "PLFEngine.plf (S=20, bf16) != kernel 1m")
    torch.cuda.empty_cache()
    ms16 = cuda_ms(lambda: plf_node_mxu(a16, b16, lc, rc, ec, n, **kw),
                   reps=10)
    ms32 = cuda_ms(lambda: plf_node_mxu(a, b, lc, rc, ec, n, **kw), reps=10)
    ms_plain = cuda_ms(lambda: plf_node_mxu_torch(a16, b16, lc, rc, ec, n,
                                                  **kw), reps=2, warmup=1)
    n_pad = a.shape[1]
    site_bytes = 3 * S * C * 2 + 4
    flops, rate = node_work(S, C, "mxu_3x")
    bd = bound(site_bytes * n_pad, flops * n_pad, rate)
    phase("bf16", f"kernel 1m, bf16 storage, mxu_3x, S={S} C={C}, {n} "
          f"sites ({node_plan_text(S, C, 'mxu_3x', True, n_pad)}): == plain "
          f"out of place and in place ({n_flag} rescaled); "
          f"PLFEngine.plf on {m} sites: bf16 kernel 1m once ({ran16}), == "
          f"it; kernel {ms16:.4f} ms (bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']} at {site_bytes} B/site); fp32 form "
          f"{ms32:.4f} ms; plain {ms_plain:.3f} ms")
    del a, b, a16, b16, x3k, sck
    torch.cuda.empty_cache()
    kernel1m_edges(dev, BF16, "bf16")
    return dict(launches=ran16["plf_node_mxu"], ms=ms16, plain_ms=ms_plain,
                max_abs_err=0.0, **bd)


def bf16_step(pm16, pm32, dev, label):
    """The "segmented" value-and-gradient step of a bf16 model (the main
    path: the bf16 forms of the model's segmented kernels once each) and
    of its fp32 twin: the bf16 tree_loglik_fn warns naming bf16, the value
    differs from the fp32 step's within BF16_LL_REL, the gradient within
    BF16_GRAD_REL; both step times in turns (fp32, bf16, bf16, fp32)."""
    fn32, t0 = tree_loglik_fn(pm32, backend="segmented")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fn16, _ = tree_loglik_fn(pm16, backend="segmented")
    check(any("bf16" in str(x.message) for x in w),
          f"{label}: no bf16 warning from tree_loglik_fn")
    (v16, g16), ran, ran16 = _main_path(lambda: _grad_step(fn16, t0, dev))
    v32, g32 = _grad_step(fn32, t0, dev)
    g16, g32 = g16.cpu().numpy(), g32.cpu().numpy()
    rel = abs(v16 / v32 - 1)
    err = _bf16_grad_err(g16, g32)
    check(ran == ran16 and len(ran) == 2 and set(ran.values()) == {1}
          and fn16.engine == "segmented",
          f"{label}: the bf16 'segmented' step launched {ran} ({ran16} bf16)")
    check(v16 != v32 and rel < BF16_LL_REL and np.isfinite(g16).all()
          and err < BF16_GRAD_REL,
          f"{label}: bf16 step value rel {rel}, gradient {err}")
    times = {"fp32": [], "bf16": []}
    for d in ("fp32", "bf16", "bf16", "fp32"):
        fn = fn16 if d == "bf16" else fn32
        times[d].append(_median_ms(lambda: _grad_step(fn, t0, dev), reps=3))
    return ran16, (f"'segmented' step: bf16 kernels {ran16}, value rel "
                   f"{rel:.2e} to fp32's, gradient within {err:.3e} (floor "
                   f"{BF16_GRAD_FLOOR}); step {times['bf16']} ms against fp32 "
                   f"{times['fp32']} ms wall (medians of 3, in turns)")


def bf16_dna_segmented(dev, tree, tips, pm):
    """The DNA segmented paths under bf16 at 160 taxa x 2^20: log_likelihood
    (method="segmented") (the bf16 kernel 7 once) differs from the fp32
    model's within BF16_LL_REL; kernel 7's lik, sc and every bf16
    boundary == plain bit for bit; the "segmented" step (bf16_step);
    kernel 8 (kernel8_against).  The fp32 forms are timed on the same
    model in phases kernel7 and kernel8 of the same run."""
    t0 = time.perf_counter()
    pm16 = PhyloModel(tree, hky85(2.0), tips, alpha=0.5, device=dev,
                      config=PLFConfig(dtype="bfloat16"))
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    seg16, ran, ran16 = _main_path(
        lambda: pm16.log_likelihood(method="segmented"))
    check(ran == ran16 == {"plf_tree_seg": 1},
          f"method='segmented' under bf16 launched {ran} ({ran16} bf16)")
    ll32 = pm.log_likelihood(method="segmented").log_likelihood
    rel = abs(seg16.log_likelihood / ll32 - 1)
    check(seg16.log_likelihood != ll32 and rel < BF16_LL_REL,
          f"bf16 segmented ll {seg16.log_likelihood} vs fp32 {ll32}")
    plan, fwd, _ = seg_inputs(pm16)
    args, kw = _seg_args(pm16, fwd)
    lik, sc, bbuf = kernel7(*args, **kw)
    plain, plain_ms = timed(lambda: plf_tree_seg_torch(*args, **kw))
    check(bbuf.dtype == BF16 and all(
        torch.equal(a, b) for a, b in zip((lik, sc, bbuf), plain)),
        "kernel 7 (bf16) != its plain version")
    del plain, lik, sc
    ms = cuda_ms(lambda: kernel7(*args, **kw), reps=20)
    bd = seg_fwd_bound(pm16, plan)
    phase("bf16", f"{pm16.tree.n_leaves} taxa x {pm16.n_sites} sites (model "
          f"built in {built:.1f} s): log_likelihood(method='segmented') "
          f"{seg16.log_likelihood:.6f}, bf16 kernel 7 once ({ran16}), rel "
          f"{rel:.2e} to fp32's {ll32:.6f}; kernel 7 lik, sc and "
          f"{plan.n_boundaries} bf16 boundaries == plain bit for bit; "
          f"boundaries {bbuf.numel() * 2 / 1e9:.3f} GB against fp32's "
          f"{bbuf.numel() * 4 / 1e9:.3f} GB; kernel {ms:.3f} ms (bound "
          f"{bd['bound_ms']:.3f} ms by {bd['bound_by']}), plain "
          f"{plain_ms:.1f} ms")
    del bbuf
    step16, line = bf16_step(pm16, pm, dev, "DNA")
    phase("bf16", f"{pm16.tree.n_leaves} taxa x {pm16.n_sites} sites, "
          f"{line}")
    k8, _ = kernel8_against(pm16, name="bf16")
    del pm16
    torch.cuda.empty_cache()
    k8["launches"] = step16["plf_tree_seg_bwd"]
    return dict(launches=ran16["plf_tree_seg"], ms=ms, plain_ms=plain_ms,
                max_abs_err=0.0, **bd), k8


def bf16_protein_segmented(dev, models, codon):
    """The matrix forms under bf16: the default protein model's twin with
    dtype="bfloat16" at 64 x 131,072 ("mxu_3x"): log_likelihood(method=
    "segmented") (the bf16 kernel 7m once) against the fp32 model's, the
    "segmented" step (bf16_step), kernels 7m and 8m == plain bit for bit
    (kernel7m_against, kernel8m_against); then kernels 7m and 8m at S = 61
    on the first 8,192 codons of the codon workload."""
    ref = models["mxu_3x"]
    cfg16 = PLFConfig(states=20, kernel_variant="mxu_3x", dtype="bfloat16")
    pm16 = PhyloModel(ref.tree, ref.model, ref.tip_states, alpha=0.5,
                      device=dev, config=cfg16)
    seg16, ran, ran16 = _main_path(
        lambda: pm16.log_likelihood(method="segmented"))
    check(ran == ran16 == {"plf_tree_seg_mxu": 1},
          f"protein method='segmented' under bf16 launched {ran}")
    ll32 = ref.log_likelihood(method="segmented").log_likelihood
    rel = abs(seg16.log_likelihood / ll32 - 1)
    check(seg16.log_likelihood != ll32 and rel < BF16_LL_REL,
          f"protein bf16 segmented ll {seg16.log_likelihood} vs {ll32}")
    step16, line = bf16_step(pm16, ref, dev, "protein")
    phase("bf16", f"protein {PROT_TAXA} x {PROT_SITES}, mxu_3x: "
          f"log_likelihood(method='segmented') {seg16.log_likelihood:.6f}, "
          f"bf16 kernel 7m once ({ran16}), rel {rel:.2e} to fp32's; {line}")
    k7 = kernel7m_against(pm16, "protein, bf16 storage", name="bf16")
    k8 = kernel8m_against(pm16, step_cotangent(ref), "protein, bf16 storage",
                          name="bf16")
    del pm16
    tree, tips, gy, _ = codon
    cpm = PhyloModel(tree, gy, tips[:, :CODON_K4_SITES], alpha=0.7,
                     device=dev, config=PLFConfig(
                         states=61, kernel_variant="mxu_3x",
                         dtype="bfloat16"))
    kernel7m_against(cpm, "codon, bf16 storage", name="bf16")
    kernel8m_against(cpm, step_cotangent(cpm), "codon, bf16 storage",
                     name="bf16")
    del cpm
    torch.cuda.empty_cache()
    k7["launches"] = ran16["plf_tree_seg_mxu"]
    k8["launches"] = step16["plf_tree_seg_bwd_mxu"]
    return k7, k8


def bf16_phase(dev, tree, tips, pm, node_case, models, codon):
    """bf16 CLV storage (PLFConfig(dtype="bfloat16")) on the card, each of
    the six bf16 storage forms through its main path and against its plain
    version; returns their entries for the kernels line."""
    t0 = time.perf_counter()
    res = {"plf_node": bf16_kernel1(dev, node_case),
           "plf_node_mxu": bf16_kernel1m(dev)}
    res["plf_tree_seg"], res["plf_tree_seg_bwd"] = bf16_dna_segmented(
        dev, tree, tips, pm)
    res["plf_tree_seg_mxu"], res["plf_tree_seg_bwd_mxu"] = (
        bf16_protein_segmented(dev, models, codon))
    phase("bf16", f"phase took {time.perf_counter() - t0:.1f} s")
    return res


def _median_ms(fn, reps=5):
    """Median host-clock time of ``fn`` in ms, the device synchronised
    before and after each run."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _device_events(events):
    """The device-side rows of profiler ``key_averages()`` (kernels and
    copies; host operators would count their kernels twice), each with
    its device time in us, longest first."""
    rows = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        rows.append((e, us if us is not None else e.self_cuda_time_total))
    return sorted(rows, key=lambda r: -r[1])


def profile_phase(pm):
    """Where the time of one evaluation goes, at the main path's shape."""
    from torch.profiler import ProfilerActivity, profile

    cfg = pm.config
    state = {}

    def kernel():
        state["out"] = plf_tree(
            pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
            pm.root_rows[0], pm.n_sites, n_slots=pm.n_slots,
            root_slot=pm.root_slot, states=cfg.states,
            categories=cfg.categories,
            program=pm.tree_program)

    def copies():
        lik, sc = state["out"]
        state["host"] = (lik[0].cpu().numpy(), sc[0].cpu().numpy())

    def scaler_sum():
        state["total"] = pm._scaler_total(state["out"][1][0])

    def finalise():
        pm._finalise_ll(*state["host"], state["total"])

    pm.log_likelihood()
    wall = _median_ms(pm.log_likelihood)
    steps = [("kernel 2 launch + sync", kernel),
             ("2 device-to-host copies", copies),
             ("int64 scaler sum + .item()", scaler_sum),
             ("host fp64 finalisation", finalise)]
    for label, fn in steps:
        ms = _median_ms(fn)
        phase("profile", f"fused step {label}: {ms:.3f} ms "
              f"({100 * ms / wall:.1f}% of {wall:.3f} ms wall, medians of 5)")

    for method, n_eval in (("auto", 3), ("per-node", 1)):
        pm.log_likelihood(method=method)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_eval):
                pm.log_likelihood(method=method)
            torch.cuda.synchronize()
            traced = (time.perf_counter() - t0) * 1e3 / n_eval
        rows = _device_events(prof.key_averages())
        if not rows:
            phase("profile", f"{method}: the profiler saw no device time "
                  f"(device time and idle share not measured)")
            continue
        dev_ms = sum(us for _, us in rows) / 1e3 / n_eval
        phase("profile", f"{method}: {dev_ms:.3f} ms device time per "
              f"evaluation of {traced:.3f} ms wall under the profiler "
              f"(device idle {100 * (1 - dev_ms / traced):.1f}%); "
              f"{n_eval} evaluation(s) traced")
        for e, us in rows[:8]:
            phase("profile", f"  {method} device: {e.key[:60]}: "
                  f"{us / 1e3 / n_eval:.3f} ms/eval over {e.count} calls")

    # Occupancy probe: the same launch with a larger (unused) arena, so
    # fewer blocks fit an SM; the results must not change.
    ref = state["out"]
    n_codes = pm.tip_table.shape[1]
    fwd, _ = node_work(cfg.states, cfg.categories)
    ceiling = 2 * len(pm.schedule) * fwd * pm.n_pad / FP32_FLOPS * 1e3
    for n_slots in sorted({pm.carry_slots, 6, 9, 13, 28}):
        plan = tree_plan(pm.codes.dtype, cfg.categories, n_codes, n_slots)
        blocks = plan["blocks_per_sm"]
        args = (pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
                pm.root_rows[0], pm.n_sites)
        kw = dict(n_slots=pm.n_slots, root_slot=pm.root_slot,
                  states=cfg.states, categories=cfg.categories,
                  program=(pm.tree_program[0], n_slots))
        lik, sc = plf_tree(*args, **kw)
        check(torch.equal(lik, ref[0]) and torch.equal(sc, ref[1]),
              f"kernel 2 with a {n_slots}-slot arena changed its result")
        ms = cuda_ms(lambda: plf_tree(*args, **kw), reps=10)
        warps = blocks * plan["threads"] // 32
        phase("profile", f"kernel 2 with a {n_slots}-slot arena: {blocks} "
              f"blocks of {plan['threads']} threads x "
              f"{plan['sites_per_thread']} site(s) per SM ({warps} warps), "
              f"{ms:.3f} ms ({100 * ceiling / ms:.1f}% of the uncontracted "
              f"fp32 ceiling)")


# ---------------------------------- kernel 9 and kernel 3m (S != 4) --

GEN_BLOCK, GEN_BLOCKS, GEN_ITERS = 8192, 256, 8   # bench_gen, bench.py:272


def kernel9_phase(dev):
    """Kernel 9, the compute-only probe, at bench_gen's shape (block 8,192,
    256 blocks, 8 chained nodes: 2^24 node-sites) at S = 4 and S = 20:
    == its plain version bit for bit, timed against its operations
    bound."""
    res = {}
    for S in (4, 20):
        C = 4
        rng = np.random.default_rng(0)
        lc, rc, ec = lane_constants(
            rng.random((C, S, S), np.float32),
            rng.random((C, S, S), np.float32),
            rng.random((S, S), np.float32), dev, S, C)
        kw = dict(states=S, categories=C, block_sites=GEN_BLOCK,
                  n_blocks=GEN_BLOCKS, inner_iters=GEN_ITERS)
        k = plf_node_gen(lc, rc, ec, **kw)
        p = plf_node_gen_torch(lc, rc, ec, **kw)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        check(torch.equal(k, p), f"kernel 9 at S={S} != plain version")
        n_fin = int(torch.isfinite(k).sum())
        ms_k = cuda_ms(lambda: plf_node_gen(lc, rc, ec, **kw), reps=10)
        ms_p = cuda_ms(lambda: plf_node_gen_torch(lc, rc, ec, **kw), reps=1,
                       warmup=0)
        n = GEN_BLOCK * GEN_BLOCKS
        node_sites = n * GEN_ITERS
        flops = gen_flops(S, C) * node_sites
        bd = bound(4 * n, flops, FP32_FLOPS)
        plan = gen_plan(S, C)
        phase("kernel9", f"S={S} C={C}, {n} sites x {GEN_ITERS} nodes: == "
              f"plain ({n_fin} of {n} checksums finite); kernel {ms_k:.4f} "
              f"ms ({node_sites / ms_k / 1e6:.3f} Gnode-sites/s, "
              f"{flops / ms_k / 1e9:.2f} TFLOP/s at {gen_flops(S, C)} flops "
              f"per node-site; bound {bd['bound_ms']:.4f} ms by "
              f"{bd['bound_by']} at 67 TFLOP/s, which counts an FMA as two: "
              f"under -fmad=false the uncontracted ceiling is half, "
              f"{2 * bd['bound_ms']:.4f} ms, {200 * bd['bound_ms'] / ms_k:.1f}"
              f"% of it), plain {ms_p:.3f} ms; plan: {plan['threads']} "
              f"threads a block, {plan['tile_sites']}-site tiles, "
              f"{plan['job_rows']} rows x {plan['job_sites']} site(s) a "
              f"thread's job, operators in "
              f"{'shared' if plan['ops_shared'] else 'device'} memory, "
              f"{plan['smem_bytes']} bytes of dynamic shared memory, "
              f"{plan['blocks_per_sm']} blocks per SM")
        res[S] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=err, **bd)
        del k, p
    torch.cuda.empty_cache()
    return res


def kernel3m_against_plain(args, S, C, label):
    """Kernel 3m on ``args`` (x1, x2, g, sc, lc, rc, lcT, rcT, ecT, n)
    against its plain version: gx1/gx2 bit for bit, the operator sums
    within SUM_RTOL of scale and bit-identical run to run.  Returns the
    sums' error (share of scale) and the largest absolute difference."""
    kw = dict(states=S, categories=C)
    k1 = plf_node_bwd(*args, **kw)
    k2 = plf_node_bwd(*args, **kw)
    p = plf_node_bwd_torch(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(k1[0], p[0]) and torch.equal(k1[1], p[1]),
          f"kernel 3m gx1/gx2 != plain, {label}")
    check(all(torch.equal(u, v) for u, v in zip(k1, k2)),
          f"kernel 3m differs between two runs, {label}")
    err = max(sums_err(k1[i], p[i]) for i in (2, 3, 4))
    check(err <= SUM_RTOL, f"kernel 3m op grads, {label}: {err} of scale "
          f"> {SUM_RTOL}")
    return err, max(float((u - v).abs().max()) for u, v in zip(k1, p))


def kernel3s_phase(dev):
    """Kernel 3m (the node VJP at S != 4) against its plain version at
    kernel 1m's shapes: S = 20, C = 4 on 2^21 - 77 sites and S = 61 on
    2^18 - 5 (kernel3m_against_plain); timed against its bound.  Phase
    ``kernel_train`` holds it at its main path's shapes too."""
    res = {}
    for S, n in ((20, NODE_MXU_SITES), (61, NODE_MXU_S61)):
        C = 4
        rows = S * C
        a, b, _, (lc, rc, ec) = _mxu_case(dev, n, S, C, 30 + S)
        n_pad = a.shape[1]
        _, sc = plf_node(a, b, lc, rc, ec, n, states=S, categories=C)
        g = torch.randn(a.shape, generator=torch.Generator(device=dev)
                        .manual_seed(S), device=dev)
        consts = [lc, rc] + [transpose_lane_constants(t, S, C)
                             for t in (lc, rc, ec)]
        kw = dict(states=S, categories=C)
        err, abs_err = kernel3m_against_plain((a, b, g, sc, *consts, n), S,
                                              C, f"S={S}, {n} sites")
        ms_k = cuda_ms(lambda: plf_node_bwd(a, b, g, sc, *consts, n, **kw),
                       reps=5)
        ms_p = cuda_ms(lambda: plf_node_bwd_torch(a, b, g, sc, *consts, n,
                                                  **kw), reps=1, warmup=0)
        site_bytes = 5 * rows * 4 + 4
        bd = bound(site_bytes * n_pad, node_bwd_flops(S, C) * n_pad,
                   FP32_FLOPS)
        acc_shared, resident, ts = plf_grad._mxu_plan(dev, S, C)
        blocks, _ = plf_grad.node_bwd_mxu_blocks(n_pad, resident, ts)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        check((ts, acc_shared) == ((32, True) if S == 20 else (8, False)),
              f"kernel 3m planned {ts}-site tiles, accumulators "
              f"{'shared' if acc_shared else 'in device memory'} at S={S}")
        phase("kernel3s", f"S={S} C={C}, {n} sites ({int(sc.sum())} "
              f"rescued): gx1/gx2 == plain; gl/gr/ge within {err:.2e} "
              f"of scale of plain (max abs {abs_err:.3g}), bit-identical run "
              f"to run; {blocks} blocks ({resident // sms} per SM) of "
              f"{ts}-site tiles, accumulators in "
              f"{'shared' if acc_shared else 'device'} memory; kernel "
              f"{ms_k:.4f} ms ({site_bytes * n_pad / (ms_k * 1e-3) / 1e9:.0f}"
              f" GB/s at {site_bytes} B/site; bound {bd['bound_ms']:.4f} ms "
              f"by {bd['bound_by']}), plain {ms_p:.3f} ms")
        res[S] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=abs_err, **bd)
        del a, b, g, sc
        torch.cuda.empty_cache()
    return res


def node_residuals(fn, t0, dev):
    """One value-and-gradient step of a "kernel" backend, with kernel 3m's
    arguments kept (cloned) at the node whose forward rescued the most
    sites: ``(x1, x2, g, sc, lc, rc, lcT, rcT, ecT, n)``."""
    best = [None, -1]
    wrapped = plf_grad.plf_node_bwd

    def keep(*args, **kw):
        rescued = int(args[3].sum())
        if rescued > best[1]:
            best[:] = [tuple(a.clone() if torch.is_tensor(a) else a
                             for a in args), rescued]
        return wrapped(*args, **kw)

    plf_grad.plf_node_bwd = keep
    try:
        _grad_step(fn, t0, dev)
    finally:
        plf_grad.plf_node_bwd = wrapped
    return best[0]


def kernel3m_on_main_path(pm, fn, t0, dev, label):
    """Kernel 3m against its plain version (kernel3m_against_plain) on one
    node's residuals of ``pm``'s "kernel" step, at the model's own
    n_pad."""
    S, C = pm.config.states, pm.config.categories
    args = node_residuals(fn, t0, dev)
    err, abs_err = kernel3m_against_plain(args, S, C, label)
    acc_shared, resident, ts = plf_grad._mxu_plan(dev, S, C)
    blocks, per = plf_grad.node_bwd_mxu_blocks(pm.n_pad, resident, ts)
    phase("kernel_train", f"{label}: kernel 3m on the residuals of the node "
          f"with the most rescued sites ({int(args[3].sum())}), n_pad "
          f"{pm.n_pad}, {blocks} blocks of {per} {ts}-site tiles: gx1/gx2 "
          f"== plain, gl/gr/ge within {err:.2e} of scale (max abs "
          f"{abs_err:.3g}), bit-identical run to run")
    del args


def _turns(fns, reps=3):
    """Each ``fns[name]`` timed in turns a, b, b, a (median of ``reps``
    steps per turn): ``{name: [ms, ms]}``."""
    names = list(fns)
    out = {k: [] for k in names}
    for k in names + names[::-1]:
        out[k].append(_median_ms(fns[k], reps=reps))
    return out


def kernel_train_phase(ptree, ptips, codon, dev):
    """The "kernel" backend at S != 4 (kernels 1m in fp32 mode + 3m once
    per node): a "vpu" twin of the 64 x 131,072 LG+G4 protein model and
    one of the 32 x 65,536 codon model, each step against "tree" on the
    same model (values rel 1e-5, gradients within rtol 2e-4 / atol 1e-4 x
    max|g|); kernel 3m against its plain version on one node's residuals
    of each "kernel" step (kernel3m_on_main_path); the protein gradient
    against float64 central differences; both protein steps timed in
    turns; auto takes "tree" for the protein model and its 4,096-site
    sub-alignment and "kernel" for the codon model
    (optimize.KERNEL_MIN_NODES, KERNEL_MIN_NODE_SITES: the "kernel" step
    won from 255 nodes x 131,072 protein sites, and from 15 nodes and 31
    x 16,384 codon node-sites);
    optimize_branch_lengths on "kernel"."""
    lg = empirical_protein("lg")
    cfg = PLFConfig(states=20, kernel_variant="vpu")
    pm = PhyloModel(ptree, lg, ptips, alpha=0.5, device=dev, config=cfg)
    E = len(pm.schedule)
    want = {"plf_node_mxu": E, "plf_node_bwd_mxu": E}
    fns, out, launches = {}, {}, None
    for backend in ("kernel", "tree"):
        torch.cuda.reset_peak_memory_stats()
        fn, t0 = tree_loglik_fn(pm, backend=backend)
        check((fn.engine, fn.variant) == (backend, "vpu"),
              f"{backend}: {fn.engine!r} / {fn.variant!r}")
        v, g, counts = _step_launches(fn, t0, dev)
        if backend == "kernel":
            check(counts == want, f"kernel step launched {counts}, not "
                  f"{want}")
            launches = counts
            kstep = (fn, t0)
        out[backend] = (v, g.cpu().numpy(),
                        torch.cuda.max_memory_allocated() / 2 ** 30, counts)
        fns[backend] = functools.partial(_grad_step, fn, t0, dev)
    (v_k, g_k, mem_k, c_k), (v_t, g_t, mem_t, c_t) = out["kernel"], out["tree"]
    auto = tree_loglik_fn(pm)[0].engine
    check(auto == "tree", f"auto took {auto!r} for the vpu protein model")
    rel = abs(v_k - v_t) / abs(v_t)
    check(rel < 1e-5, f"protein kernel value {v_k} vs tree {v_t}")
    err = _grad_bar(g_k, g_t)
    check(err <= 1.0, f"protein kernel vs tree gradient: {err} of the bar")
    ms = _turns(fns)
    phase("kernel_train", f"protein {PROT_TAXA} x {PROT_SITES}, LG+G4, "
          f"\"vpu\": kernel step launched {c_k}, tree step {c_t}; value "
          f"rel {rel:.2e}, gradient within {err:.3f} of the bar; steps in "
          f"turns kernel/tree/tree/kernel: kernel {ms['kernel'][0]:.2f} / "
          f"{ms['kernel'][1]:.2f} ms, tree {ms['tree'][0]:.2f} / "
          f"{ms['tree'][1]:.2f} ms (medians of 3 each); peak {mem_k:.2f} "
          f"GiB (kernel) vs {mem_t:.2f} GiB (tree); auto takes {auto!r}")
    fns.clear()
    kernel3m_on_main_path(pm, *kstep, dev, f"protein {PROT_TAXA} x "
                          f"{PROT_SITES}")
    del kstep

    sub_tips = ptips[:, :FD_SITES]
    sub = PhyloModel(ptree, lg, sub_tips, alpha=0.5, device=dev, config=cfg)
    auto = tree_loglik_fn(sub)[0].engine
    check(auto == "tree", f"auto took {auto!r} for the {FD_SITES}-site "
          f"vpu protein model")
    fn, t0 = tree_loglik_fn(sub, backend="kernel")
    g = _grad_step(fn, t0, dev)[1].cpu().numpy()
    h, fds = 1e-4, []
    for i in (0, 1, ptree.n_leaves):
        ll = []
        for d in (h, -h):
            tr = copy.deepcopy(ptree)
            tr.nodes[i].length += d
            ll.append(PhyloModel(tr, lg, sub_tips, alpha=0.5, device=dev,
                                 config=cfg).log_likelihood_bruteforce())
        fd = (ll[0] - ll[1]) / (2 * h)
        fds.append(f"branch {i}: {g[i]:.6g} vs {fd:.6g}")
        check(abs(g[i] - fd) <= 1e-3 * abs(fd),
              f"kernel gradient vs float64 differences, {fds[-1]}")
    phase("kernel_train", f"{FD_SITES}-site sub-alignment (auto takes "
          f"{auto!r}), kernel gradient vs float64 central differences (h "
          f"{h}) of the brute force, within rel 1e-3: " + "; ".join(fds))

    t_opt, ll0, ll1 = optimize_branch_lengths(pm, steps=2, backend="kernel")
    check(ll1 > ll0 and np.all(t_opt > 0),
          f"optimize_branch_lengths(kernel): {ll0} -> {ll1}")
    phase("kernel_train", f"optimize_branch_lengths(steps=2, "
          f"backend='kernel'): {ll0:.3f} -> {ll1:.3f}")
    del pm, sub
    torch.cuda.empty_cache()

    tree, tips, gy, _ = codon
    cm = PhyloModel(tree, gy, tips, alpha=0.7, device=dev,
                    config=PLFConfig(states=61, kernel_variant="vpu"))
    res = {}
    for backend in ("kernel", "tree"):
        torch.cuda.reset_peak_memory_stats()
        fn, t0 = tree_loglik_fn(cm, backend=backend)
        v, g, counts = _step_launches(fn, t0, dev)
        if backend == "kernel":
            kernel3m_on_main_path(cm, fn, t0, dev, f"codon {CODON_TAXA} x "
                                  f"{CODON_SITES}")
        ms = _median_ms(functools.partial(_grad_step, fn, t0, dev), reps=1)
        res[backend] = (v, g.cpu().numpy(), ms, counts,
                        torch.cuda.max_memory_allocated() / 2 ** 30)
    (v_k, g_k, ms_k, c_k, m_k), (v_t, g_t, ms_t, c_t, m_t) = (
        res["kernel"], res["tree"])
    Ec = len(cm.schedule)
    check(c_k == {"plf_node_mxu": Ec, "plf_node_bwd_mxu": Ec},
          f"codon kernel step launched {c_k}")
    auto = tree_loglik_fn(cm)[0].engine
    check(auto == "kernel", f"auto took {auto!r} for the vpu codon model")
    rel = abs(v_k - v_t) / abs(v_t)
    check(rel < 1e-5, f"codon kernel value {v_k} vs tree {v_t}")
    err = _grad_bar(g_k, g_t)
    check(err <= 1.0, f"codon kernel vs tree gradient: {err} of the bar")
    phase("kernel_train", f"codon {CODON_TAXA} x {CODON_SITES}, GY94+G4, "
          f"\"vpu\" (S=61): kernel step launched {c_k}; value rel "
          f"{rel:.2e} to tree, gradient within {err:.3f} of the bar; one "
          f"step each after the counted one (wall ms): kernel {ms_k:.1f}, "
          f"tree {ms_t:.1f}; peak {m_k:.2f} vs {m_t:.2f} GiB; auto takes "
          f"{auto!r}")
    del cm
    torch.cuda.empty_cache()
    return launches, ms


#: The command-line runs of phase ``cli``: arguments, whether the run
#: verifies against the golden oracle.
CLI_RUNS = (
    (["--sites", "16777216", "--calls", "10"], True),
    (["--sites", "2097152", "--calls", "10", "--roundtrip"], True),
    (["20state", "--sites", "2097152", "--calls", "5"], True),
    (["--gen", "--sites", "2097152", "--block", "8192", "--calls", "10"],
     False),
    (["20state", "--gen", "--sites", "2097152", "--block", "8192",
      "--calls", "10"], False),
)


def cli_phase():
    """``python -m plf_tpu_torch`` as a user runs it, in a subprocess (the
    libraries of phase ``build`` are loaded, not rebuilt): the DNA default
    at 2^24 sites x 10 calls, --roundtrip at 2^21 x 10, 20state at 2^21 x
    5, --gen at S = 4 and 20.  Each exits 0 and, where it verifies, prints
    'Test result: Passed' (exact equality with the golden oracle); the
    msm rate and the kernel launches come from each run's own output."""
    from plf_tpu_torch.runtime.native import golden_oracle
    oracle = golden_oracle()       # builds the host oracle once
    libs = set(BUILD_DIR.glob("*.so"))
    torch.cuda.empty_cache()
    res = {"gen_launches": 0}
    for argv, verifies in CLI_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "plf_tpu_torch", *argv],
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        text = proc.stdout
        check(proc.returncode == 0, f"python -m plf_tpu_torch {argv} exited "
              f"{proc.returncode}:\n{text[-2000:]}\n{proc.stderr[-2000:]}")
        check(set(BUILD_DIR.glob("*.so")) == libs,
              f"{argv}: the CLI built a library")
        launches = re.search(r"^kernel launches: (.*)$", text, re.M).group(1)
        label = " ".join(argv)
        if verifies:
            check("Test result: Passed" in text, f"{argv}: no pass:\n"
                  f"{text[-2000:]}")
            row = re.search(r"^\| Device compute \(HBM->VPU->HBM\): +\| +"
                            r"([0-9.]+) \| +([0-9.]+) \| +([0-9.]+) \|$",
                            text, re.M)
            msm_ms, mbs, mas = (float(x) for x in row.groups())
            res[label] = dict(msm_ms=msm_ms, mas=mas)
            phase("cli", f"{label}: exit 0, Test result: Passed ({oracle} "
                  f"golden oracle, exact); msm {msm_ms:.3f} ms = "
                  f"{mas:.3f} MA/s, {mbs:.1f} MB/s; launches {launches}; "
                  f"{wall:.1f} s wall")
        else:
            rate = re.search(r"gen probe: ([0-9.]+) Gnode-sites/s", text)
            res["gen_launches"] += int(re.search(r"plf_node_gen (\d+)",
                                                 launches).group(1))
            res[label] = dict(gnode=float(rate.group(1)))
            phase("cli", f"{label}: exit 0, {rate.group(0)}; launches "
                  f"{launches}; {wall:.1f} s wall")
    return res


def main():
    name = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    k1, node_case = kernel1_phase(dev)
    k3 = kernel3_phase(dev, node_case, k1["probe_gbs"])
    k9 = kernel9_phase(dev)
    tree, tips, pm = tree_workload(dev)
    k2 = kernel2_phase(pm)
    k4 = kernel4_phase(pm)
    launches = main_path_phase(dev, tree, tips, pm, node_case)
    train_launches, _ = train_phase(dev, tree, tips, pm)
    launches.update({k: train_launches[k]
                     for k in ("plf_node_bwd", "plf_tree_bwd")})
    k7 = kernel7_phase(dev, pm)
    k8 = kernel8_phase(pm)
    launches.update(segmented_phase(dev, pm))
    profile_phase(pm)
    k1m = kernel1m_phase(dev)
    k3s = kernel3s_phase(dev)
    ptree, ptips, models = protein_workload(dev)
    k2m = kernel2m_phase(models)
    prot_launches, _ = protein_phase(ptree, ptips, models, dev)
    launches.update(prot_launches)
    codon = codon_workload(dev)
    k4m = kernel4m_phase(models, codon, dev)
    train_launches, _ = protein_train_phase(ptree, ptips, models, dev)
    launches["plf_tree_bwd_mxu"] = train_launches["plf_tree_bwd_mxu"]
    kt_launches, _ = kernel_train_phase(ptree, ptips, codon, dev)
    launches["plf_node_bwd_mxu"] = kt_launches["plf_node_bwd_mxu"]
    codon_phase(codon, dev)
    inf = infer_phase(dev)
    analyses_phase(dev)
    ax = axes_phase(dev)
    sharded_phase(dev, tree, tips, pm, models)
    graft_phase(dev)
    k7m = kernel7m_phase(models, codon, (tree, tips), dev)
    k8m = kernel8m_phase(models, codon, dev)
    launches.update(protein_segmented_phase(models, dev))
    k16 = bf16_phase(dev, tree, tips, pm, node_case, models, codon)
    cli = cli_phase()
    launches["plf_node_gen"] = cli["gen_launches"]

    # Bounds of the DNA kernels at the shapes their times were taken at:
    # kernels 1 and 3 at 2^20 sites, kernels 2 and 4 at 160 taxa x 2^20.
    S, C = 4, 4
    E, n_tree = len(pm.schedule), pm.n_pad
    n_node = L.sites_padding(NODE_SITES_GOLDEN, UNIT)
    code_bytes = pm.codes.element_size() * pm.tree.n_leaves
    fwd, _ = node_work(S, C)
    k1.update(bound(196 * n_node, fwd * n_node, FP32_FLOPS))
    k2.update(bound((code_bytes + 8) * n_tree, E * fwd * n_tree, FP32_FLOPS))
    k3["2p20"].update(bound(324 * n_node, node_bwd_flops(S, C) * n_node,
                            FP32_FLOPS))
    k4.update(tree_bwd_bound(pm))
    entry = lambda kname, src, replaces, r: dict(
        name=kname, route="cuda", source=f"plf_tpu_torch/csrc/{src}",
        replaces=replaces,
        launches=r["launches"] if "launches" in r else launches[kname],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None)
    kernels = [
        entry("plf_node", "plf_node.cu", "plf_tpu/ops/plf_pallas.py:78", k1),
        entry("plf_tree", "plf_tree.cu",
              "plf_tpu/ops/plf_tree_pallas.py:424", k2),
        entry("plf_node_bwd", "plf_node_bwd.cu",
              "plf_tpu/ops/plf_grad.py:120", k3["2p20"]),
        entry("plf_tree_bwd", "plf_tree_bwd.cu",
              "plf_tpu/ops/plf_tree_grad.py:110", k4),
        entry("plf_node_mxu", "plf_node_mxu.cu",
              "plf_tpu/ops/plf_pallas.py:233", k1m["mxu_3x"]),
        entry("plf_tree_mxu", "plf_tree_mxu.cu",
              "plf_tpu/ops/plf_tree_pallas.py:424", k2m["mxu_3x"]),
        entry("plf_tree_bwd_mxu", "plf_tree_bwd_mxu.cu",
              "plf_tpu/ops/plf_tree_grad.py:110", k4m["mxu_3x"]),
        entry("plf_tree_seg", "plf_tree_seg.cu",
              "plf_tpu/ops/plf_tree_seg.py:383", k7),
        entry("plf_tree_seg_bwd", "plf_tree_seg_bwd.cu",
              "plf_tpu/ops/plf_tree_seg.py:843", k8),
        entry("plf_tree_seg_mxu", "plf_tree_seg_mxu.cu",
              "plf_tpu/ops/plf_tree_seg.py:383", k7m["mxu_3x"]),
        entry("plf_tree_seg_bwd_mxu", "plf_tree_seg_bwd_mxu.cu",
              "plf_tpu/ops/plf_tree_seg.py:843", k8m["mxu_3x"]),
        entry("plf_gen", "plf_gen.cu", "plf_tpu/ops/plf_pallas.py:401",
              dict(k9[4], launches=launches["plf_node_gen"])),
        entry("plf_node_bwd_mxu", "plf_node_bwd_mxu.cu",
              "plf_tpu/ops/plf_grad.py:120", k3s[20]),
        entry("plf_tree:batched", "plf_tree.cu",
              "plf_tpu/ops/plf_tree_pallas.py:628", inf["plf_tree_batch"]),
        entry("plf_tree_mxu:batched", "plf_tree_mxu.cu",
              "plf_tpu/ops/plf_tree_pallas.py:628",
              inf["plf_tree_mxu_batch"]),
        entry("plf_node:batched", "plf_node.cu",
              "plf_tpu/ops/plf_pallas.py:78", ax["plf_node"]),
        entry("plf_node_mxu:batched", "plf_node_mxu.cu",
              "plf_tpu/ops/plf_pallas.py:233", ax["plf_node_mxu:mxu_3x"]),
        entry("plf_tree_seg:batched", "plf_tree_seg.cu",
              "plf_tpu/ops/plf_tree_seg.py:1376", ax["plf_tree_seg:float32"]),
        entry("plf_tree_seg:batched:bf16", "plf_tree_seg.cu",
              "plf_tpu/ops/plf_tree_seg.py:1376", ax["plf_tree_seg:bfloat16"]),
        entry("plf_tree_seg_mxu:batched", "plf_tree_seg_mxu.cu",
              "plf_tpu/ops/plf_tree_seg.py:1376",
              ax["plf_tree_seg_mxu:float32"]),
        entry("plf_tree_seg_mxu:batched:bf16", "plf_tree_seg_mxu.cu",
              "plf_tpu/ops/plf_tree_seg.py:1376",
              ax["plf_tree_seg_mxu:bfloat16"]),
    ]
    replaces = {"plf_node": "plf_pallas.py:78",
                "plf_node_mxu": "plf_pallas.py:233",
                "plf_tree_seg": "plf_tree_seg.py:383",
                "plf_tree_seg_bwd": "plf_tree_seg.py:843",
                "plf_tree_seg_mxu": "plf_tree_seg.py:383",
                "plf_tree_seg_bwd_mxu": "plf_tree_seg.py:843"}
    kernels += [entry(f"{k}:bf16_storage", f"{k}.cu",
                      f"plf_tpu/ops/{replaces[k]}", k16[k])
                for k in replaces]
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was not launched on its main path: {launches}")
    phase("peak", f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"device memory allocated at peak")
    phase("time", f"{sum(PHASE_SECONDS.values()):.1f} s in all: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
