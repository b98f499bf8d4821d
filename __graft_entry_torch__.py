"""Entry points of the PyTorch/CUDA port: one kernel step on one card and
a dry run over N ranks.  Counterpart of ``__graft_entry__.py``.

``entry(device)``          -> (fn, example_args): kernel 1
                              (``plf_tpu_torch/ops/plf_node.py``) on
                              lane-major operands of the flagship DNA
                              shape; ``fn(*example_args)`` is
                              ``(x3, scaler)``.
``dryrun_multichip(n)``    -> the ten checks of the JAX twin on an n-rank
                              site mesh of ``plf_tpu_torch.parallel``, one
                              process per rank; returns rank 0's values
                              keyed by check.

The site axis is pointwise, so a rank holds its shard of the sites and
every rank the same branch and EV constants; the only traffic between
ranks is the all-reduce of the scaler counts, the log-likelihood partials
and, in a training step, the operator-stack gradients.

    python __graft_entry_torch__.py     # entry() on the card, then
                                        # dryrun_multichip(cards)

This file imports ``torch``, ``numpy`` and ``plf_tpu_torch`` only.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

#: The dry run's sites (not a multiple of ranks x block: the padding path)
#: and padding unit.
DRYRUN_SITES = 300
DRYRUN_BLOCK = 128
#: The libraries the ten checks load: built once before the ranks start.
DRYRUN_LIBRARIES = ("plf_node", "plf_tree", "plf_tree_bwd", "plf_tree_mxu",
                    "plf_tree_seg", "plf_tree_seg_bwd")

#: One rank: joins the group through a ``file://`` store, runs the checks
#: and prints ``{"values": ..., "launches": ...}`` as its last line.
#: Arguments: repo, rank, ranks, store file, device, backend.
RANK_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import __graft_entry_torch__ as g
g._rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
             sys.argv[6])
"""


def _example_case(n_sites, states=4, categories=4, seed=0):
    """``__graft_entry__.py``'s case, draw for draw: site-major children
    ``(n, S*C)`` with every fourth site of x1 scaled by 1e-12 (it
    rescales), branches ``(C, S, S)`` and EV ``(S, S)``."""
    rng = np.random.default_rng(seed)
    S, C = states, categories
    e = S * C
    x1 = rng.random((n_sites, e), dtype=np.float32)
    j = np.arange(n_sites * e).reshape(n_sites, e)
    x1 = np.where((j % (4 * e)) < e, x1 * np.float32(1e-12), x1)
    x2 = rng.random((n_sites, e), dtype=np.float32)
    left = rng.random((C, S, S), dtype=np.float32)
    right = rng.random((C, S, S), dtype=np.float32)
    ev = rng.random((S, S), dtype=np.float32)
    return x1, x2, left, right, ev


def entry(device="cuda"):
    """``(fn, example_args)``: kernel 1 on 2,048 DNA sites padded to 512,
    S = 4, C = 4; ``fn(*example_args)`` returns ``(x3, scaler)``, the
    ``(16, 2048)`` parent and ``(1, 2048)`` int32 rescale flags."""
    from plf_tpu_torch.devices import resolve_device
    from plf_tpu_torch.ops import layout as L
    from plf_tpu_torch.ops.plf_node import plf_node

    device = resolve_device(device)  # RuntimeError with no card
    states, categories, block = 4, 4, 512
    n = 2048
    x1, x2, left, right, ev = _example_case(n)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    args = (put(L.pad_to_multiple(L.to_lane_major(x1), block)),
            put(L.pad_to_multiple(L.to_lane_major(x2), block)),
            put(L.branch_to_lane_constants(left)),
            put(L.branch_to_lane_constants(right)),
            put(L.ev_to_lane_constants(ev)), n)

    def fn(x1l, x2l, lc, rc, ec, nn):
        return plf_node(x1l, x2l, lc, rc, ec, nn, states=states,
                        categories=categories)

    return fn, args


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _close(a, b, rtol, atol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    bad = np.abs(a - b) > atol + rtol * np.abs(b)
    _check(not bad.any(), f"{what}: {int(bad.sum())} of {a.size} beyond "
           f"rtol {rtol}, atol {atol} (max diff {np.abs(a - b).max(initial=0):.3e})")


def _step(fn, t0, device):
    """Value and gradient of ``fn`` at the lengths ``t0``."""
    t = torch.tensor(t0, device=device, requires_grad=True)
    v = fn(t)
    v.backward()
    return float(v.detach()), t.grad.detach().cpu().numpy()


def _checks(mesh):
    """The ten checks of ``__graft_entry__.py:94-347`` on this rank's
    shard of ``mesh``; ``{check: values}``, every value all-reduced or
    computed alike on every rank, so the ranks' dicts are equal."""
    from plf_tpu_torch import PLFConfig, PLFEngine, plf_reference
    from plf_tpu_torch.models import (Partition, PartitionedModel,
                                      PhyloModel, codon_gy94, hky85, jc69,
                                      random_gtr, random_tree)
    from plf_tpu_torch.models.optimize import tree_loglik_fn
    from plf_tpu_torch.parallel import ShardedPLF
    from plf_tpu_torch.parallel.sharding import shard_span

    dev = mesh.device
    n, block = DRYRUN_SITES, DRYRUN_BLOCK
    states, categories = 4, 4
    rows = states * categories
    cfg = PLFConfig(block_sites=block)
    out = {}

    # 1. Kernel 1 on the shard (the padding path), the weighted scaler
    # increment and the masked log of rv @ x3 all-reduced.
    sp = ShardedPLF(mesh, block_sites=block)
    x1, x2, left, right, ev = _example_case(n)
    n_pad = sp.padded_sites(n)
    _, shard, n_local = shard_span(mesh, n, n_pad)
    rv = np.abs(np.random.default_rng(1).random((1, rows))).astype(
        np.float32)
    x3, sc, inc = sp(sp.prepare(x1, n), sp.prepare(x2, n),
                     *sp.constants(left, right, ev),
                     sp.prepare_weights(np.ones(n, np.int32), n), n)
    _check(tuple(x3.shape) == (rows, shard), f"x3 shard {tuple(x3.shape)}")
    lik = (torch.as_tensor(rv, device=dev) @ x3)[0, :n_local]
    part = torch.log(torch.clamp(lik, min=1e-30)).double().sum().reshape(1)
    out["plf"] = dict(x3_shape=[rows, shard * mesh.size],
                      scaler_inc=int(inc), ll=float(mesh.all_reduce(part)[0]))

    # 2. The 6-taxon HKY85 tree: sharded == single-device, site for site.
    n_leaves = 6
    tree = random_tree(n_leaves, seed=2)
    tips = np.random.default_rng(3).integers(0, 4, size=(n_leaves, n))
    pm = PhyloModel(tree, hky85(2.0), tips, alpha=0.5, config=cfg,
                    device=dev)
    res = pm.log_likelihood_sharded(mesh)
    ref = pm.log_likelihood()
    lo = pm.site_shard(mesh)[2]
    site = res.site_log_likelihood
    _close(site, ref.site_log_likelihood[lo:lo + len(site)], 5e-6, 1e-7,
           "tree: per-site ll")
    _check(res.scaler_total == ref.scaler_total,
           f"tree: scalers {res.scaler_total} != {ref.scaler_total}")
    ll_ref = ref.log_likelihood
    _check(abs(res.log_likelihood - ll_ref) < 1e-5 * abs(ll_ref) + 1e-6,
           f"tree: ll {res.log_likelihood} vs {ll_ref}")
    out["tree"] = dict(taxa=n_leaves, ll=res.log_likelihood,
                       scaler_total=res.scaler_total, ll_single=ll_ref,
                       scaler_total_single=ref.scaler_total)

    # 3. A "tree" training step on the mesh (kernels 2 + 4 on the shard,
    # the operator-stack gradients summed over the ranks) and one update;
    # the gradient against the autodiff oracle ("torch").
    fn, t0 = tree_loglik_fn(pm, backend="tree", mesh=mesh)
    ll0, g = _step(fn, t0, dev)
    t1 = np.maximum(t0 + 1e-3 * g / (np.abs(g).max() + 1e-9), 1e-6)
    ll1 = float(fn(torch.tensor(t1, device=dev)))
    _check(np.isfinite(ll0) and np.isfinite(ll1) and np.isfinite(g).all(),
           f"train: ll {ll0} -> {ll1}, gradient finite "
           f"{bool(np.isfinite(g).all())}")
    _check(abs(ll0 - ll_ref) < 1e-5 * abs(ll_ref) + 1e-6,
           f"train: ll {ll0} vs {ll_ref}")
    fn_x, _ = tree_loglik_fn(pm, backend="torch")
    _close(g, _step(fn_x, t0, dev)[1], 5e-4, 1e-4, "train: gradient")
    out["train"] = dict(engine=fn.engine, ll0=ll0, ll1=ll1,
                        grad=g.tolist())

    # 4. Protein S=20 at "mxu_3x" (kernel 2m), sharded vs fused.
    tips_p = np.random.default_rng(6).integers(0, 20, size=(5, n))
    pm_p = PhyloModel(random_tree(5, seed=6), random_gtr(20, 6), tips_p,
                      alpha=0.5, config=PLFConfig(
                          states=20, block_sites=block,
                          kernel_variant="mxu_3x"), device=dev)
    res_p = pm_p.log_likelihood_sharded(mesh)
    ref_p = pm_p.log_likelihood_fused().log_likelihood
    _check(abs(res_p.log_likelihood - ref_p) < 1e-4 * abs(ref_p),
           f"protein: ll {res_p.log_likelihood} vs fused {ref_p}")
    out["protein"] = dict(ll=res_p.log_likelihood, ll_fused=ref_p,
                          scaler_total=res_p.scaler_total)

    # 5. int8 tip codes under the mesh: bit-equal to int32.
    pm_i8 = PhyloModel(tree, hky85(2.0), tips, alpha=0.5,
                       config=PLFConfig(block_sites=block,
                                        tip_dtype="int8"), device=dev)
    res_i8 = pm_i8.log_likelihood_sharded(mesh)
    _check(res_i8.scaler_total == ref.scaler_total,
           f"int8: scalers {res_i8.scaler_total} != {ref.scaler_total}")
    _check(np.array_equal(res_i8.site_log_likelihood,
                          res.site_log_likelihood),
           "int8: site ll differ from int32")
    out["int8"] = dict(ll=res_i8.log_likelihood,
                       scaler_total=res_i8.scaler_total)

    # 6. plf_batch: kernel 1 with an instance axis, one launch, against
    # the golden model bit for bit.
    eng = PLFEngine(cfg, device=dev)
    rngb = np.random.default_rng(8)
    ni, nb = 3, 160
    bx1 = rngb.random((ni, nb, rows), dtype=np.float32)
    bx2 = rngb.random((ni, nb, rows), dtype=np.float32)
    bl = rngb.random((ni, 4, 4, 4), dtype=np.float32)
    br = rngb.random((ni, 4, 4, 4), dtype=np.float32)
    bev = rngb.random((ni, 4, 4), dtype=np.float32)
    out_b = eng.plf_batch(bx1, bx2, bl, br, bev)
    incs = []
    for i in range(ni):
        x3r, svr, sir = plf_reference(bx1[i], bx2[i], bl[i], br[i], bev[i],
                                      np.ones(nb, np.int32))
        _check(np.array_equal(out_b.x3[i].cpu().numpy().reshape(x3r.shape),
                              x3r)
               and np.array_equal(out_b.scaler_vector[i].cpu().numpy(),
                                  svr.astype(np.int32)),
               f"plf_batch: instance {i} != the golden model")
        incs.append(int(out_b.scaler_increment[i]))
        _check(incs[-1] == int(sir), f"plf_batch: increment {incs[-1]} "
               f"!= {sir}")
    out["plf_batch"] = dict(instances=ni, sites=nb, scaler_increments=incs)

    # 7. The 16-taxon segmented VJP under the mesh (kernels 7 + 8) against
    # the autodiff oracle.
    tree_b = random_tree(16, seed=4)
    tips_b = np.random.default_rng(5).integers(0, 4, size=(16, n))
    pm_b = PhyloModel(tree_b, hky85(2.0), tips_b, alpha=0.5, config=cfg,
                      device=dev)
    fn_s, t0s = tree_loglik_fn(pm_b, backend="segmented", mesh=mesh)
    ll_s, g_s = _step(fn_s, t0s, dev)
    fn_sx, _ = tree_loglik_fn(pm_b, backend="torch")
    ll_x, g_x = _step(fn_sx, t0s, dev)
    _check(abs(ll_s - ll_x) < 1e-5 * abs(ll_x) + 1e-6,
           f"segmented: ll {ll_s} vs oracle {ll_x}")
    _close(g_s, g_x, 5e-4, 1e-4, "segmented: gradient")
    out["segmented"] = dict(engine=fn_s.engine,
                            segments=len(pm_b._segmented_inputs()[0]
                                         .segments),
                            ll=ll_s, ll_oracle=ll_x, grad=g_s.tolist())

    # 8. Two partitions under the mesh, sharded vs single.
    parts = [Partition("g1", np.arange(n // 2), hky85(2.0), alpha=0.5),
             Partition("g2", np.arange(n // 2, n), jc69())]
    tips_2 = np.random.default_rng(9).integers(0, 4, size=(6, n))
    pmod = PartitionedModel(tree, parts, tips_2, config=cfg, device=dev)
    res_pm = pmod.log_likelihood_sharded(mesh).log_likelihood
    ref_pm = pmod.log_likelihood().log_likelihood
    _check(abs(res_pm - ref_pm) < 1e-5 * abs(ref_pm),
           f"partition: ll {res_pm} vs {ref_pm}")
    out["partition"] = dict(parts=len(parts), ll=res_pm, ll_single=ref_pm)

    # 9. Codon S=61 GY94 at "mxu_3x" (kernel 2m), sharded vs fused.
    n_c = 160
    tips_c = np.random.default_rng(11).integers(0, 61, size=(4, n_c))
    pm_c = PhyloModel(random_tree(4, seed=11), codon_gy94(2.0, 0.3), tips_c,
                      alpha=0.6, config=PLFConfig(
                          states=61, block_sites=block,
                          kernel_variant="mxu_3x"), device=dev)
    res_c = pm_c.log_likelihood_sharded(mesh)
    ref_c = pm_c.log_likelihood_fused().log_likelihood
    _check(abs(res_c.log_likelihood - ref_c) < 1e-4 * abs(ref_c),
           f"codon: ll {res_c.log_likelihood} vs fused {ref_c}")
    out["codon"] = dict(ll=res_c.log_likelihood, ll_fused=ref_c,
                        scaler_total=res_c.scaler_total)

    # 10. bf16 boundary storage through the segmented VJP under the mesh.
    pm_b16 = PhyloModel(tree_b, hky85(2.0), tips_b, alpha=0.5,
                        config=PLFConfig(block_sites=block,
                                         dtype="bfloat16"), device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fn_b16, t0b = tree_loglik_fn(pm_b16, backend="segmented", mesh=mesh)
        ll_b16, g_b16 = _step(fn_b16, t0b, dev)
    _check(abs(ll_b16 - ll_x) < 5e-3 * abs(ll_x),
           f"bf16: ll {ll_b16} vs fp32 {ll_x}")
    _check(np.isfinite(g_b16).all(), "bf16: gradient not finite")
    out["bf16"] = dict(engine=fn_b16.engine, ll=ll_b16, ll_fp32=ll_x,
                       grad=g_b16.tolist())
    return out


def _run_checks(mesh):
    """``(values, launches)``: the checks and the kernel launches they
    made in this process, by wrapper."""
    from plf_tpu_torch.ops import launch_counts
    before = launch_counts()
    values = _checks(mesh)
    return values, {k: v - before[k] for k, v in launch_counts().items()
                    if v - before[k]}


def _rank_main(rank, ranks, store, device, backend):
    """One rank of :func:`dryrun_multichip` (``RANK_SCRIPT``)."""
    import torch.distributed as dist
    from plf_tpu_torch.parallel import initialize_distributed, make_mesh

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)     # the ranks share the host's cores
    initialize_distributed(f"file://{store}", ranks, rank, backend=backend,
                           device=device)
    mesh = make_mesh(ranks, device=device)
    values, launches = _run_checks(mesh)
    print(json.dumps(dict(rank=rank, backend=mesh.backend,
                          device=str(mesh.device), values=values,
                          launches=launches)), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def _tail(path, n=3000):
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def _start_ranks(n_devices, device, backend, tmp, timeout):
    """Every rank's JSON line.  Once a rank exits non-zero the others are
    stopped, and this raises naming the lowest rank that exited non-zero
    by itself (ranks stopped here do not count), every such rank with its
    exit code, and the end of the named rank's stderr.  A run past
    ``timeout`` seconds stops every rank and names the lowest."""
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        devs = [f"cuda:{r % cards}" for r in range(n_devices)]
    else:
        devs = ["cpu"] * n_devices
    procs, logs, stopped = [], [], set()
    try:
        for r in range(n_devices):
            o, e = (open(os.path.join(tmp, f"rank{r}.{s}"), "w")
                    for s in ("out", "err"))
            logs.append((o, e))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_SCRIPT, REPO, str(r),
                 str(n_devices), os.path.join(tmp, "store"), devs[r],
                 backend], stdout=o, stderr=e))
        deadline = time.monotonic() + timeout
        late = False
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes) or all(
                    c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                late = True
                break
            time.sleep(0.1)
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                if p.wait() == -signal.SIGKILL:   # not an exit of its own
                    stopped.add(r)
        for o, e in logs:
            o.close()
            e.close()
    if late:
        named = min(r for r, c in enumerate(codes) if c is None)
        how = f"ran past {timeout} s"
    else:
        failed = [r for r, p in enumerate(procs)
                  if p.returncode != 0 and r not in stopped]
        if not failed:
            out = []
            for r in range(n_devices):
                with open(os.path.join(tmp, f"rank{r}.out")) as f:
                    out.append(json.loads(f.read().strip().splitlines()[-1]))
            return out
        named = failed[0]
        how = (f"exited {procs[named].returncode}; ranks that exited "
               f"non-zero by themselves: " + ", ".join(
                   f"{r} (exit {procs[r].returncode})" for r in failed))
    raise RuntimeError(
        f"dryrun_multichip({n_devices}): rank {named} of {n_devices} {how} "
        f"({backend}, {devs[named]}); its stderr ends:\n"
        f"{_tail(os.path.join(tmp, f'rank{named}.err'))}")


def _report(n, v, backend):
    """The JAX twin's lines, from rank 0's values."""
    p = v["plf"]
    tag = f"dryrun_multichip({n})"
    print(f"{tag}: ok — x3{tuple(p['x3_shape'])} sharded over {n} ranks "
          f"({backend}), scaler_inc={p['scaler_inc']}, ll={p['ll']:.3f}")
    t = v["tree"]
    print(f"{tag}: tree kernel ok — {t['taxa']}-taxon tree, "
          f"ll={t['ll']:.3f} (single-device ref {t['ll_single']:.3f}, "
          f"scalers {t['scaler_total']}=={t['scaler_total_single']})")
    s = v["train"]
    print(f"{tag}: sharded training step ok — ll {s['ll0']:.3f} -> "
          f"{s['ll1']:.3f}, |g|max={np.abs(s['grad']).max():.3e}")
    print(f"{tag}: sharded protein mxu_3x ok — S=20 "
          f"ll={v['protein']['ll']:.3f} (fused {v['protein']['ll_fused']:.3f})")
    print(f"{tag}: int8 tip codes under mesh ok — site-ll bit-equal to "
          f"int32, scalers {v['int8']['scaler_total']}=="
          f"{t['scaler_total_single']}")
    print(f"{tag}: plf_batch ok — {v['plf_batch']['instances']} instances "
          f"vs golden model (bit for bit)")
    print(f"{tag}: sharded segmented VJP ok — {v['segmented']['segments']} "
          f"segments, ll={v['segmented']['ll']:.3f}")
    print(f"{tag}: sharded partitioned model ok — "
          f"{v['partition']['parts']} partitions, "
          f"ll={v['partition']['ll']:.3f} (single-device "
          f"{v['partition']['ll_single']:.3f})")
    print(f"{tag}: sharded codon mxu_3x ok — S=61 ll={v['codon']['ll']:.3f} "
          f"(fused {v['codon']['ll_fused']:.3f})")
    print(f"{tag}: sharded bf16-storage segmented VJP ok — "
          f"ll={v['bf16']['ll']:.3f} (fp32 {v['bf16']['ll_fp32']:.3f})")


def dryrun_multichip(n_devices: int, device="cuda", backend=None,
                     timeout: float = 600.0) -> dict:
    """The ten checks of ``__graft_entry__.py`` on an ``n_devices``-rank
    site mesh: the sharded PLF step, the whole-tree likelihood, a training
    step, protein and codon "mxu_3x", int8 tips, ``plf_batch``, the
    segmented VJP, a partitioned model and bf16 boundary storage.

    Each rank is a process of its own (``sys.executable``), joined by a
    ``file://`` store in a temporary directory, and must finish within
    ``timeout`` seconds.  On "cuda" rank r computes on ``cuda:r`` over
    NCCL, and more ranks than cards raise ValueError before any process
    starts, unless the caller names ``backend="gloo"``: then the ranks
    share the cards (rank r on card r modulo the cards).  On "cpu" the
    ranks join over gloo.  One rank runs in this process with no group.
    Once a rank exits non-zero the others are stopped and this raises,
    naming the lowest rank that exited non-zero by itself, with the end
    of its stderr.

    Prints the JAX twin's lines and returns rank 0's values keyed by
    check ("plf", "tree", "train", "protein", "int8", "plf_batch",
    "segmented", "partition", "codon", "bf16"), every rank's the same,
    and under "launches" rank 0's kernel launches by wrapper.
    """
    dev = torch.device(device)
    if n_devices < 1:
        raise ValueError(f"dryrun_multichip: {n_devices} ranks")
    if dev.type == "cuda":
        from plf_tpu_torch.devices import card_count, check_nccl_cards
        if backend != "gloo":
            check_nccl_cards(n_devices, torch.cuda.device_count(),
                             "dryrun_multichip")
        card_count()                 # RuntimeError with no card
        from plf_tpu_torch.ops._build import build_libraries, storage_library
        build_libraries(list(DRYRUN_LIBRARIES) + [
            storage_library(k, True)
            for k in ("plf_tree_seg", "plf_tree_seg_bwd")])
    if n_devices == 1:
        from plf_tpu_torch.parallel import make_mesh
        mesh = make_mesh(device=dev)
        values, launches = _run_checks(mesh)
        backend = "no group"
    else:
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        with tempfile.TemporaryDirectory() as tmp:
            ranks = _start_ranks(n_devices, dev, backend, tmp, timeout)
        values, launches = ranks[0]["values"], ranks[0]["launches"]
        for r, res in enumerate(ranks[1:], 1):
            for k, v in values.items():
                if res["values"][k] != v:
                    raise RuntimeError(
                        f"dryrun_multichip({n_devices}): rank {r} disagrees "
                        f"with rank 0 on {k}: {res['values'][k]} vs {v}")
    _report(n_devices, values, backend)
    return dict(values, launches=launches)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry(): ok", [tuple(o.shape) for o in out])
    dryrun_multichip(torch.cuda.device_count())
