"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds both CUDA kernels of ``plf_tpu_torch`` from ``plf_tpu_torch/csrc``
(into ``build/plf_tpu_torch/``), holds each against the numpy golden
model and its plain PyTorch version on the card, then runs the DNA
whole-tree log-likelihood (``PhyloModel.log_likelihood``) at 160 taxa x
2^20 site patterns, HKY85 + Gamma4, fp32, and checks it against the
per-node path and a float64 brute force.  A last phase breaks one
``log_likelihood()`` into its steps (host timers around synchronised
steps), traces the fused and the per-node evaluation with
``torch.profiler`` (device time, idle share, the top kernels) and times
kernel 2 at the occupancy its arena allows and at lower ones.  Prints one
line per phase, a JSON line with each kernel's launches, error and times,
and last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA device it fails at once and prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from plf_tpu_torch import PLFConfig, PLFEngine
from plf_tpu_torch.models import PhyloModel, hky85, random_tree
from plf_tpu_torch.ops import layout as L
from plf_tpu_torch.ops._build import build_log
from plf_tpu_torch.ops.plf_node import _lib as plf_node_lib
from plf_tpu_torch.ops.plf_node import plf_node, plf_node_torch
from plf_tpu_torch.ops.plf_tree import _lib as plf_tree_lib
from plf_tpu_torch.ops.plf_tree import (plf_tree, plf_tree_occupancy,
                                        plf_tree_torch)
from plf_tpu_torch.reference import plf_reference

N_TAXA = 160
TREE_SITES = 1 << 20          # site patterns of the whole-tree workload
NODE_SITES_GOLDEN = (1 << 20) - 37   # kernel 1 vs the numpy golden model
NODE_SITES_BIG = (1 << 24) - 123     # kernel 1 vs its plain version
BRUTE_SITES = 1 << 16         # sub-alignment for the float64 brute force
UNIT = 128                    # site padding unit


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase(name, msg):
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


def lane_constants(left, right, ev, dev):
    return [torch.as_tensor(a, device=dev) for a in (
        L.branch_to_lane_constants(left), L.branch_to_lane_constants(right),
        L.ev_to_lane_constants(ev))]


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


def build_phase():
    for lib_name, loader in (("plf_node", plf_node_lib),
                             ("plf_tree", plf_tree_lib)):
        t0 = time.perf_counter()
        loader()
        dt = time.perf_counter() - t0
        log = build_log(lib_name).read_text()
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", log))
        phase("build", f"{lib_name}: {dt:.1f} s; {len(regs)} instances, "
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
    res.update(max_abs_err=max_err, ms_2p24=ms_kb, plain_ms_2p24=ms_pb)
    return res, (x1, x2, left, right, ev)


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
    """Kernel 2 against the plain tree forward on the card."""
    cfg = pm.config
    args = (pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
            pm.root_rows[0], pm.n_sites)
    kw = dict(n_slots=pm.n_slots, root_slot=pm.root_slot,
              states=cfg.states, categories=cfg.categories)
    lik_k, sc_k = plf_tree(*args, **kw)
    lik_p, sc_p = plf_tree_torch(*args, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lik_k).all()) and bool((lik_k > 0).all()),
          "kernel 2 gave non-finite or non-positive site likelihoods")
    max_err = float((lik_k - lik_p).abs().max())
    check(torch.equal(sc_k, sc_p), "kernel 2 scaler counts != plain")
    check(torch.equal(lik_k, lik_p), "kernel 2 site likelihoods != plain "
          f"(max abs diff {max_err:g})")
    ms_k = cuda_ms(lambda: plf_tree(*args, **kw), reps=10)
    ms_p = cuda_ms(lambda: plf_tree_torch(*args, **kw), reps=2, warmup=1)
    phase("kernel2", f"{len(pm.schedule)} nodes x {pm.n_sites} sites: "
          f"== plain (site likelihoods and {int(sc_k.sum())} rescales); "
          f"kernel {ms_k:.3f} ms ({1e3 / ms_k:.1f} tree evals/s), plain "
          f"{ms_p:.3f} ms")
    return dict(ms=ms_k, plain_ms=ms_p, max_abs_err=max_err)


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
            categories=cfg.categories)

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
    for n_slots in sorted({pm.n_slots, 9, 13, 28}):
        blocks = plf_tree_occupancy(pm.codes.dtype, cfg.categories, n_codes,
                                    n_slots)
        args = (pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
                pm.root_rows[0], pm.n_sites)
        kw = dict(n_slots=n_slots, root_slot=pm.root_slot,
                  states=cfg.states, categories=cfg.categories)
        lik, sc = plf_tree(*args, **kw)
        check(torch.equal(lik, ref[0]) and torch.equal(sc, ref[1]),
              f"kernel 2 with a {n_slots}-slot arena changed its result")
        ms = cuda_ms(lambda: plf_tree(*args, **kw), reps=10)
        phase("profile", f"kernel 2 with a {n_slots}-slot arena: {blocks} "
              f"blocks of 128 threads per SM ({blocks * 4} warps), "
              f"{ms:.3f} ms")


def main():
    name = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    k1, node_case = kernel1_phase(dev)
    tree, tips, pm = tree_workload(dev)
    k2 = kernel2_phase(pm)
    launches = main_path_phase(dev, tree, tips, pm, node_case)
    profile_phase(pm)
    kernels = [
        dict(name="plf_node", route="cuda",
             source="plf_tpu_torch/csrc/plf_node.cu",
             replaces="plf_tpu/ops/plf_pallas.py:78",
             launches=launches["plf_node"], max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"]),
        dict(name="plf_tree", route="cuda",
             source="plf_tpu_torch/csrc/plf_tree.cu",
             replaces="plf_tpu/ops/plf_tree_pallas.py:424",
             launches=launches["plf_tree"], max_abs_err=k2["max_abs_err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"]),
    ]
    phase("peak", f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"device memory allocated at peak")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
