"""Time backward kernels of two checkouts in turns on one NVIDIA GPU.

    python3 kernel_turns.py [--dna] PARENT_DIR CHANGE_DIR

Each directory is the root of a checkout (for the parent commit, unpack
``git archive <commit>`` into a directory that ``.gitignore`` lists, such
as ``build/``).  The script runs parent, change, change, parent, each in a
process of its own with that checkout's ``plf_tpu_torch`` (its kernels
built from its own sources into its own ``build/``), and prints one JSON
line per turn of device times in ms.  Compare two versions only within
one call: two calls may land on two cards.

Default (protein): the mean of three launches after one warm-up (CUDA
events around the three) of kernel 4m in each matrix-form variant and of
kernel 8m (the segmented backward, fp32 boundaries, on the model's own
plan) in "mxu_3x" and "mxu", on the protein workload of
``chip_smoke.py`` (64 taxa x 131,072 sites, LG + Gamma4, a step's
cotangent).  The two share ``csrc/plf_mxu_bwd.cuh``.

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
from plf_tpu_torch.ops import plf_tree_seg as SG
from plf_tpu_torch.ops._build import build_libraries

assert torch.cuda.is_available(), "needs an NVIDIA GPU"
build_libraries(["plf_tree_mxu", "plf_tree_bwd_mxu", "plf_tree_seg_mxu",
                 "plf_tree_seg_bwd_mxu"])
tree = random_tree(64, seed=1)
p = np.concatenate([[0.04], np.full(20, 0.0475), np.full(3, 0.01)])
tips = np.random.default_rng(64).choice(
    np.arange(-1, 23, dtype=np.int8), size=(64, 1 << 17), p=p / p.sum())

def ms(fn):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 3


out = {"kernel4m_ms": {}, "kernel8m_ms": {}}
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

    out["kernel4m_ms"][v] = ms(bwd)
    if v == "mxu_bf16":
        continue
    plan, prog, segs, n_slots = pm._segmented_inputs()
    bprog, bsegs, _ = SG.segment_program(plan, sched, reuse_slots=False)
    kw = dict(states=20, categories=4, variant=v, planes=pm._planes())
    _, _, bbuf = SG.plf_tree_seg_mxu(
        pm.codes, prog, segs, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
        pm.root_rows[0], pm.n_sites, n_boundaries=plan.n_boundaries,
        n_slots=n_slots, **kw)
    bargs = (pm.codes, torch.as_tensor(bprog, device="cuda"),
             torch.as_tensor(bsegs, device="cuda"), pm.lcs, pm.rcs, pm.ec,
             pm.fused_tip_table, pm.root_rows[0], glik, bbuf, pm.n_sites)
    out["kernel8m_ms"][v] = ms(lambda: SG.plf_tree_seg_bwd_mxu(
        *bargs, seg_ops=plan.seg_ops, **kw))
print(json.dumps(out))
'''

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
build_libraries(["plf_node_bwd", "plf_tree", "plf_tree_bwd", "plf_tree_seg",
                 "plf_tree_seg_bwd", "plf_tree_seg_bf16",
                 "plf_tree_seg_bwd_bf16"])
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


def main():
    args = sys.argv[1:]
    turn = TURN
    if args[:1] == ["--dna"]:
        args, turn = args[1:], DNA_TURN
    if len(args) != 2:
        sys.exit(__doc__)
    dirs = {"parent": args[0], "change": args[1]}
    for name in ("parent", "change", "change", "parent"):
        root = os.path.abspath(dirs[name])
        run = subprocess.run([sys.executable, "-c", turn], cwd=root,
                             env=dict(os.environ, PYTHONPATH=root),
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            sys.exit(f"{name} turn failed:\n{run.stderr[-3000:]}")
        print(json.dumps({"turn": name, **json.loads(
            run.stdout.strip().splitlines()[-1])}), flush=True)


if __name__ == "__main__":
    main()
