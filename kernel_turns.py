"""Time backward kernels of two checkouts in turns on one NVIDIA GPU.

    python3 kernel_turns.py [--dna | --k3m2m] PARENT_DIR CHANGE_DIR [MORE ...]

Each directory is the root of a checkout (for the parent commit, unpack
``git archive <commit>`` into a directory that ``.gitignore`` lists, such
as ``build/``).  The script builds every checkout's libraries at once,
then runs parent, change, change, parent (with more directories, each in
the given order and then in reverse, named by the directory), each turn in
a process of its own with that checkout's ``plf_tpu_torch`` (its kernels
built from its own sources into its own ``build/``), and prints one JSON
line per turn of device times in ms.  Compare two versions only within
one call: two calls may land on two cards.

Default (protein): the median of five launches after one, each timed
alone by CUDA events, of kernel 4m in each matrix-form variant and of
kernel 8m (the segmented backward, fp32 boundaries, on the model's own
plan) in "mxu_3x" and "mxu", on the protein workload of
``chip_smoke.py`` (64 taxa x 131,072 sites, LG + Gamma4, a step's
cotangent), and of both in "mxu_3x" and "mxu" on its codon workload's
first 8,192 codons (32 taxa, GY94 + Gamma4, S = 61); and the wall time
of a "tree" and a "segmented" value-and-gradient step (median of five)
on the protein model in "mxu_3x" and "mxu".  The two kernels share
``csrc/plf_mxu_bwd.cuh``.  Each turn also gives every launch's device and
host time, the card's SM clock and power draw read right after each
kernel's five launches, each kernel's blocks per SM (and site tile, where
the library's plan gives one), and the registers and spills ptxas gave
each instance of kernels 4m and 8m (from the build logs).

``--dna``: the median of five launches after one, each timed alone, of
kernel 4 (``csrc/plf_tree_bwd.cu``) on the DNA workloads of
``chip_smoke.py`` with a step's cotangent (w / lik): 160 taxa x 2^20
patterns (HKY85 + Gamma4) and 256 taxa x 2^22 with int8 tips, where its
checkpoint runs in chunks; of kernel 8 (``csrc/plf_tree_seg_bwd.cu``) at
160 x 2^20 on the model's own plan, with fp32 and with bf16 boundaries;
and of kernel 3 (``csrc/plf_node_bwd.cu``, which shares the
operator-gradient sums of ``csrc/plf_grad.cuh``) at 2^20 and 2^24 sites
on random operands.  Each turn also gives kernel 4's chunking and its
five times, kernel 8's plan, the blocks per SM of each kernel where its
library reports them, and the registers and spills ptxas gave each
kernel's C = 4 instances (from the build logs).

``--k3m2m``: the median of five launches after one, each timed alone, of
kernel 3m (``csrc/plf_node_bwd_mxu.cu``, the node backward at S != 4) at
S = 20 on 2^21 - 77 sites and S = 61 on 2^18 - 5 (C = 4, random operands
as ``chip_smoke.py``'s phase ``kernel3s`` makes them), and of kernel 2m
(``csrc/plf_tree_mxu.cu``, the whole-tree forward of the matrix forms) in
"mxu_3x", "mxu" and "mxu_bf16" on the protein workload (64 x 131,072)
in "mxu_3x" and "mxu" on the codon workload (32 x 65,536, S = 61) and
in all three on the DNA workload (160 x 2^20, HKY85 + Gamma4, S = 4),
each with the model's own operator planes; the wall time (median of five
after one) of the "kernel" and "tree" value-and-gradient steps of the
"vpu" twins of both models, and of the default protein model's
``log_likelihood()``.  Each turn also gives each kernel's plan (kernel
3m: accumulators in shared memory, blocks per SM, site tile; kernel 2m:
blocks per SM, threads per block, rows per job) and the registers and
spills ptxas gave every instance of both kernels.
"""

import json
import os
import subprocess
import sys

TURN = r'''
import json
import re
import subprocess
import numpy as np
import torch
from plf_tpu_torch import PLFConfig
from plf_tpu_torch.models import (PhyloModel, codon_gy94, empirical_protein,
                                  random_tree, tree_loglik_fn)
from plf_tpu_torch.ops import plf_tree as TT, plf_tree_grad as TG
from plf_tpu_torch.ops import plf_tree_seg as SG
from plf_tpu_torch.ops._build import build_libraries, build_log
from plf_tpu_torch.ops.plf_mxu import MODES

assert torch.cuda.is_available(), "needs an NVIDIA GPU"
build_libraries(LIBS)
SMS = torch.cuda.get_device_properties(0).multi_processor_count


def smi():
    # the SM clock (MHz) and power draw (W) right after a kernel's launches
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.strip()


def ms(fn, samples):
    # median of 5 launches, each timed alone by CUDA events, after one;
    # host_ms: the host's time from the first event to the second, which
    # exceeds the device's only where the host held the launch up
    import time
    fn()
    times, host = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    samples.append(dict(ms=times, host_ms=host, smi=smi()))
    return float(np.median(times))


def ptxas(lib, kernel):
    # {template arguments: registers} of every instance of kernel, and
    # its bytes of spill stores where there are any
    out, name = {}, None
    for line in build_log(lib).read_text().splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        if not name or kernel + "I" not in name:
            continue
        key = name[name.index(kernel) + len(kernel):].split("EEv")[0]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and int(m.group(1)):
            out[key + ":spill"] = int(m.group(1))
    return out


def glik_of(pm, v):
    lik, _ = TT.plf_tree_mxu(
        pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
        pm.root_rows[0], pm.n_sites, n_slots=pm.n_slots,
        root_slot=pm.root_slot, states=pm.config.states,
        categories=pm.config.categories, variant=v, planes=pm._planes())
    return torch.where(lik > 1.1754944e-38, pm.wgt_pad.float()[None] / lik,
                       0.0).contiguous()


def plan_of(plan):
    # [accumulators in shared memory, blocks per SM, site tile (where the
    # library's plan gives one)]
    return [int(plan[0]), int(plan[1]) // SMS] + [int(x) for x in plan[2:]]


def kernels(pm, v, out, key, seg=True):
    # kernel 4m (and 8m, fp32 boundaries, on the model's own plan) in
    # variant v on pm, with each one's blocks per SM (and tile width,
    # where the library's plan gives one)
    S, C = pm.config.states, pm.config.categories
    n = pm.tree.n_leaves
    sched = TT.reorder_schedule(pm.schedule, n)
    bs = torch.as_tensor(TG.backward_schedule(sched, n), device="cuda")
    glik = glik_of(pm, v)
    kw = dict(states=S, categories=C, variant=v, planes=pm._planes())
    plan4 = TG._launch_plan(pm.device, pm.codes.element_size(), S, C,
                            MODES[v])
    out["plan"][f"kernel4m_{key}_{v}"] = plan_of(plan4)
    out["kernel4m_ms"][f"{key}_{v}"] = ms(lambda: TG.plf_tree_bwd_mxu(
        pm.codes, bs, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
        pm.root_rows[0], glik, pm.n_sites, **kw),
        out["samples"].setdefault(f"kernel4m_{key}_{v}", []))
    if not seg:
        return
    plan, prog, segs, n_slots = pm._segmented_inputs()
    bprog, bsegs, _ = SG.segment_program(plan, sched, reuse_slots=False)
    _, _, bbuf = SG.plf_tree_seg_mxu(
        pm.codes, prog, segs, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
        pm.root_rows[0], pm.n_sites, n_boundaries=plan.n_boundaries,
        n_slots=n_slots, **kw)
    bargs = (pm.codes, torch.as_tensor(bprog, device="cuda"),
             torch.as_tensor(bsegs, device="cuda"), pm.lcs, pm.rcs, pm.ec,
             pm.fused_tip_table, pm.root_rows[0], glik, bbuf, pm.n_sites)
    plan8 = SG._launch_plan_mxu(pm.device, pm.codes.element_size(), S, C,
                                MODES[v])
    out["plan"][f"kernel8m_{key}_{v}"] = plan_of(plan8)
    out["kernel8m_ms"][f"{key}_{v}"] = ms(lambda: SG.plf_tree_seg_bwd_mxu(
        *bargs, seg_ops=plan.seg_ops, **kw),
        out["samples"].setdefault(f"kernel8m_{key}_{v}", []))


def steps(pm, v, out):
    # one "tree" and one "segmented" value-and-gradient step (wall ms,
    # median of 5 after one)
    import time
    for backend in ("tree", "segmented"):
        fn, t0 = tree_loglik_fn(pm, backend=backend)

        def step():
            t = torch.tensor(t0, device="cuda", requires_grad=True)
            fn(t).backward()
            torch.cuda.synchronize()
        step()
        wall = []
        for _ in range(5):
            t1 = time.perf_counter()
            step()
            wall.append((time.perf_counter() - t1) * 1e3)
        out["step_ms"][f"{backend}_{v}"] = float(np.median(wall))
        out["samples"][f"step_{backend}_{v}"] = [dict(ms=wall, smi=smi())]


out = {"ptxas": {"kernel4m": ptxas("plf_tree_bwd_mxu",
                                   "plf_tree_bwd_mxu_kernel"),
                 "kernel8m": ptxas("plf_tree_seg_bwd_mxu",
                                   "plf_tree_seg_bwd_mxu_kernel")},
       "kernel4m_ms": {}, "kernel8m_ms": {}, "step_ms": {}, "plan": {},
       "samples": {}}
tree = random_tree(64, seed=1)
p = np.concatenate([[0.04], np.full(20, 0.0475), np.full(3, 0.01)])
tips = np.random.default_rng(64).choice(
    np.arange(-1, 23, dtype=np.int8), size=(64, 1 << 17), p=p / p.sum())
for v in ("mxu_3x", "mxu", "mxu_bf16"):
    pm = PhyloModel(tree, empirical_protein("lg"), tips, alpha=0.5,
                    config=PLFConfig(states=20, kernel_variant=v))
    kernels(pm, v, out, "protein", seg=v != "mxu_bf16")
    if v != "mxu_bf16":
        steps(pm, v, out)
    del pm
    torch.cuda.empty_cache()
# chip_smoke.py's codon workload (GY94 kappa 2, omega 0.3, Gamma4 alpha
# 0.7, random sense codons with 2% gaps), its first 8,192 codons
rng = np.random.default_rng(7)
codons = rng.integers(0, 61, size=(32, 1 << 16))
codons[rng.random(codons.shape) < 0.02] = 61
for v in ("mxu_3x", "mxu"):
    pm = PhyloModel(random_tree(32, seed=3), codon_gy94(kappa=2.0, omega=0.3),
                    codons[:, :1 << 13], alpha=0.7,
                    config=PLFConfig(states=61, kernel_variant=v))
    kernels(pm, v, out, "codon")
    del pm
    torch.cuda.empty_cache()
print(json.dumps(out))
'''

PROTEIN_LIBS = ["plf_tree_mxu", "plf_tree_bwd_mxu", "plf_tree_seg_mxu",
                "plf_tree_seg_bwd_mxu"]
DNA_LIBS = ["plf_node_bwd", "plf_tree", "plf_tree_bwd", "plf_tree_seg",
            "plf_tree_seg_bwd", "plf_tree_seg_bf16", "plf_tree_seg_bwd_bf16"]
DNA_TURN = r'''
import json
import re
import numpy as np
import torch
from plf_tpu_torch import PLFConfig
from plf_tpu_torch.models import PhyloModel, hky85, random_tree
from plf_tpu_torch.ops import plf_tree as TT, plf_tree_grad as TG
from plf_tpu_torch.ops import plf_tree_seg as SG
from plf_tpu_torch.ops._build import build_libraries, build_log
from plf_tpu_torch.ops import plf_grad as G
from plf_tpu_torch.ops.plf_grad import transpose_lane_constants as T

assert torch.cuda.is_available(), "needs an NVIDIA GPU"
build_libraries(LIBS)
P = np.concatenate([[0.04], np.full(4, 0.22), np.full(10, 0.008)])
SMS = torch.cuda.get_device_properties(0).multi_processor_count


def model(taxa, sites, seed, tree_seed, **kw):
    tips = np.random.default_rng(seed).choice(
        np.arange(-1, 14, dtype=np.int8), size=(taxa, sites), p=P / P.sum())
    return PhyloModel(random_tree(taxa, seed=tree_seed), hky85(2.0), tips,
                      alpha=0.5, device="cuda", **kw)


def ms(fn, samples=None):
    # median of 5 launches, each timed alone by CUDA events, after one
    fn()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    if samples is not None:
        samples.extend(times)
    return float(np.median(times))


def ptxas(lib, kernel):
    # {instance: "regs R, spill S"} of the C = 4 instances of kernel
    out, name = {}, None
    for line in build_log(lib).read_text().splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name and kernel in name and "ILi4E" in name:
            out[name[name.index(kernel):][:40]] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name and kernel in name and "ILi4E" in name and int(m.group(1)):
            out[name[name.index(kernel):][:40] + ":spill"] = int(m.group(1))
    return out


def kernel4(pm):
    sched = TT.reorder_schedule(pm.schedule, pm.tree.n_leaves)
    bs = torch.as_tensor(TG.backward_schedule(sched, pm.tree.n_leaves),
                         device="cuda")
    args = (pm.codes, bs, pm.lcs, pm.rcs, T(pm.lcs), T(pm.rcs), pm.ec,
            T(pm.ec), pm.tip_table, pm.root_rows[0])
    lik, _ = TT.plf_tree(pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec,
                         pm.tip_table, pm.root_rows[0], pm.n_sites,
                         n_slots=pm.n_slots, root_slot=pm.root_slot)
    glik = (pm.wgt_pad.to(torch.float32) / lik).contiguous()
    samples = []
    t = ms(lambda: TG.plf_tree_bwd(*args, glik, pm.n_sites), samples)
    return t, dict(TG.plf_tree_bwd.last_scratch, samples_ms=samples)


def kernel3(n):
    gen = torch.Generator(device="cuda").manual_seed(11)
    a, b, g = (torch.rand((16, n), generator=gen, device="cuda")
               for _ in range(3))
    a[:, 0::4] *= 1e-12
    sc = (torch.arange(n, device="cuda") % 4 == 0).to(torch.int32)[None]
    c = [torch.rand((16, 4), generator=gen, device="cuda") for _ in range(3)]
    consts = c[:2] + [T(t) for t in c]
    return ms(lambda: G.plf_node_bwd(a, b, g, sc, *consts, n))


out = {"ptxas": {"kernel3": ptxas("plf_node_bwd", "plf_node_bwd_kernel"),
                 "kernel4": ptxas("plf_tree_bwd", "plf_tree_bwd_kernel"),
                 "kernel8": ptxas("plf_tree_seg_bwd",
                                  "plf_tree_seg_bwd_kernel")}}
out["kernel3_ms"] = {"2^20": kernel3(1 << 20), "2^24": kernel3(1 << 24)}
pm = model(160, 1 << 20, 1, 1)
out["kernel4_ms"], out["kernel4_scratch"] = kernel4(pm)
resident = getattr(TG, "tree_bwd_resident_blocks", None)
if resident:
    out["kernel4_blocks_per_sm"] = resident(
        pm.device, pm.codes.element_size(), pm.config.categories,
        pm.tip_table.shape[1]) // SMS
plan, prog, segs, n_slots = pm._segmented_inputs()
sched = TT.reorder_schedule(pm.schedule, pm.tree.n_leaves)
bprog, bsegs, _ = SG.segment_program(plan, sched, reuse_slots=False)
bprog, bsegs = (torch.as_tensor(a, device="cuda") for a in (bprog, bsegs))
out["kernel8_plan"] = dict(segments=len(plan.segments),
                           seg_ops=plan.seg_ops,
                           boundaries=plan.n_boundaries)
out["kernel8_ms"], out["kernel8_blocks_per_sm"] = {}, {}
for dt in (torch.float32, torch.bfloat16):
    _, _, bbuf = SG.plf_tree_seg(
        pm.codes, prog, segs, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
        pm.root_rows[0], pm.n_sites, n_boundaries=plan.n_boundaries,
        n_slots=n_slots, dtype=dt)
    lik = TT.plf_tree(pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec,
                      pm.tip_table, pm.root_rows[0], pm.n_sites,
                      n_slots=pm.n_slots, root_slot=pm.root_slot)[0]
    glik = (pm.wgt_pad.to(torch.float32) / lik).contiguous()
    bargs = (pm.codes, bprog, bsegs, pm.lcs, pm.rcs, pm.ec,
             pm.fused_tip_table, pm.root_rows[0], glik, bbuf, pm.n_sites)
    key = str(dt).split(".")[-1]
    out["kernel8_ms"][key] = ms(lambda: SG.plf_tree_seg_bwd(
        *bargs, seg_ops=plan.seg_ops))
    out["kernel8_blocks_per_sm"][key] = SG._resident_blocks(
        pm.device, pm.codes.element_size(), pm.config.categories,
        pm.fused_tip_table.shape[1], plan.seg_ops,
        dt == torch.bfloat16) // SMS
    del bbuf, bargs, glik, lik
del pm
torch.cuda.empty_cache()
big = model(256, 1 << 22, 256, 4, config=PLFConfig(tip_dtype="int8"))
out["kernel4_big_ms"], out["kernel4_big_scratch"] = kernel4(big)
print(json.dumps(out))
'''


K3M2M_LIBS = ["plf_node_mxu", "plf_node_bwd_mxu", "plf_tree_mxu",
              "plf_tree_bwd_mxu"]
K3M2M_TURN = TURN[:TURN.index("def kernels(pm, v, out, key")] + r'''
import time
from plf_tpu_torch.models import hky85
from plf_tpu_torch.ops import plf_grad as G
from plf_tpu_torch.ops import layout as L
from plf_tpu_torch.ops.plf_grad import transpose_lane_constants as T


def kernel3m(S, n, out):
    # chip_smoke.py's kernel3s operands: every 4th site of x1 scaled by
    # 1e-16, random positive operators, a normal cotangent
    C = 4
    rng = np.random.default_rng(30 + S)
    consts = [torch.as_tensor(rng.random((S * C, S), dtype=np.float32),
                              device="cuda") for _ in range(3)]
    n_pad = L.sites_padding(n, 128)
    gen = torch.Generator(device="cuda").manual_seed(30 + S)
    a, b, g = (torch.rand((S * C, n_pad), generator=gen, device="cuda")
               for _ in range(3))
    a[:, 0::4] *= 1e-16
    a[:, n:] = 0.0
    b[:, n:] = 0.0
    sc = (torch.arange(n_pad, device="cuda") % 4 == 0).to(torch.int32)[None]
    args = (a, b, g - 0.5, sc, consts[0], consts[1],
            *(T(t, S, C) for t in consts), n)
    key = f"S{S}"
    out["kernel3m_ms"][key] = ms(
        lambda: G.plf_node_bwd(*args, states=S, categories=C),
        out["samples"].setdefault(f"kernel3m_{key}", []))
    plan = G._mxu_plan(torch.device("cuda"), S, C)
    out["plan"][f"kernel3m_{key}"] = plan_of(plan)


def kernel2m(pm, v, key, out):
    S, C = pm.config.states, pm.config.categories
    args = (pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
            pm.root_rows[0], pm.n_sites)
    kw = dict(n_slots=pm.n_slots, root_slot=pm.root_slot, states=S,
              categories=C, variant=v, planes=pm._planes())
    out["kernel2m_ms"][f"{key}_{v}"] = ms(
        lambda: TT.plf_tree_mxu(*args, **kw),
        out["samples"].setdefault(f"kernel2m_{key}_{v}", []))
    blocks = TT.plf_tree_mxu_occupancy(pm.codes.dtype, S, C,
                                       pm.tip_table.shape[1], pm.n_slots, v)
    # threads per block and rows per job: 128 and 4 before the library
    # reported them
    block = getattr(TT, "tree_mxu_block", lambda S, C: (128, 4))(S, C)
    out["plan"][f"kernel2m_{key}_{v}"] = [blocks, *block]


def wall(fn, out, key):
    # median of five after one, wall ms, the device synchronised
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    out["step_ms"][key] = float(np.median(times))
    out["samples"][f"step_{key}"] = [dict(ms=times, smi=smi())]


def steps(pm, key, out):
    for backend in ("kernel", "tree"):
        fn, t0 = tree_loglik_fn(pm, backend=backend)

        def step():
            t = torch.tensor(t0, device="cuda", requires_grad=True)
            fn(t).backward()
        wall(step, out, f"{key}_vpu_{backend}")


out = {"ptxas": {"kernel3m": ptxas("plf_node_bwd_mxu",
                                   "plf_node_bwd_mxu_kernel"),
                 "kernel2m": ptxas("plf_tree_mxu", "plf_tree_mxu_kernel")},
       "kernel3m_ms": {}, "kernel2m_ms": {}, "step_ms": {}, "plan": {},
       "samples": {}}
kernel3m(20, (1 << 21) - 77, out)
kernel3m(61, (1 << 18) - 5, out)
torch.cuda.empty_cache()
tree = random_tree(64, seed=1)
p = np.concatenate([[0.04], np.full(20, 0.0475), np.full(3, 0.01)])
tips = np.random.default_rng(64).choice(
    np.arange(-1, 23, dtype=np.int8), size=(64, 1 << 17), p=p / p.sum())
lg = empirical_protein("lg")
for v in ("mxu_3x", "mxu", "mxu_bf16"):
    pm = PhyloModel(tree, lg, tips, alpha=0.5,
                    config=PLFConfig(states=20, kernel_variant=v))
    kernel2m(pm, v, "protein", out)
    if v == "mxu_3x":
        wall(pm.log_likelihood, out, "protein_log_likelihood")
    del pm
pm = PhyloModel(tree, lg, tips, alpha=0.5,
                config=PLFConfig(states=20, kernel_variant="vpu"))
steps(pm, "protein", out)
del pm
torch.cuda.empty_cache()
rng = np.random.default_rng(7)
codons = rng.integers(0, 61, size=(32, 1 << 16))
codons[rng.random(codons.shape) < 0.02] = 61
gy = codon_gy94(kappa=2.0, omega=0.3)
for v in ("mxu_3x", "mxu", "vpu"):
    pm = PhyloModel(random_tree(32, seed=3), gy, codons, alpha=0.7,
                    config=PLFConfig(states=61, kernel_variant=v))
    if v == "vpu":
        steps(pm, "codon", out)
    else:
        kernel2m(pm, v, "codon", out)
    del pm
    torch.cuda.empty_cache()
# DNA in the matrix forms (S = 4): chip_smoke.py's 160 x 2^20 HKY85 + G4
# workload, random codes with gaps and IUPAC codes
del codons
p = np.concatenate([[0.04], np.full(4, 0.22), np.full(10, 0.008)])
tips = np.random.default_rng(1).choice(
    np.arange(-1, 14, dtype=np.int8), size=(160, 1 << 20), p=p / p.sum())
tree = random_tree(160, seed=1)
for v in ("mxu_3x", "mxu", "mxu_bf16"):
    pm = PhyloModel(tree, hky85(2.0), tips, alpha=0.5,
                    config=PLFConfig(kernel_variant=v))
    kernel2m(pm, v, "dna", out)
    del pm
    torch.cuda.empty_cache()
print(json.dumps(out))
'''


def smi():
    """The card's SM clock (MHz) and power draw (W), as nvidia-smi reads
    them, around a turn."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.strip()


def main():
    args = sys.argv[1:]
    turn, libs = TURN, PROTEIN_LIBS
    if args[:1] == ["--dna"]:
        args, turn, libs = args[1:], DNA_TURN, DNA_LIBS
    elif args[:1] == ["--k3m2m"]:
        args, turn, libs = args[1:], K3M2M_TURN, K3M2M_LIBS
    if len(args) < 2:
        sys.exit(__doc__)
    roots = [os.path.abspath(a) for a in args]
    if len(args) == 2:
        names = ["parent", "change"]
    else:
        names = [os.path.basename(r.rstrip("/")) or r for r in roots]
    # every checkout's libraries first, all nvcc processes at once
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from plf_tpu_torch.ops._build import "
         f"build_libraries; build_libraries({libs!r})"], cwd=root,
        env=dict(os.environ, PYTHONPATH=root)) for root in roots]
    if any(b.wait() for b in builds):
        sys.exit("a checkout's libraries failed to build")
    order = list(range(len(roots))) + list(range(len(roots)))[::-1]
    for i in order:
        before = smi()
        run = subprocess.run([sys.executable, "-c",
                              f"LIBS = {libs!r}\n" + turn], cwd=roots[i],
                             env=dict(os.environ, PYTHONPATH=roots[i]),
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            sys.exit(f"{names[i]} turn failed:\n{run.stderr[-3000:]}")
        print(json.dumps({"turn": names[i], "smi": [before, smi()],
                          **json.loads(run.stdout.strip().splitlines()[-1])}),
              flush=True)


if __name__ == "__main__":
    main()
