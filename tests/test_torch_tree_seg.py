"""Kernels 7 and 8 (the segmented whole-tree forward and backward), their
planner and the segmented paths of PhyloModel and tree_loglik_fn, against
the JAX package's segmented engine (``plf_tpu/ops/plf_tree_seg.py``, in
interpret mode as ``tests/test_tree_seg.py`` runs it) and against the
port's own fused kernels.  Tolerances are stated per test.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.models import PhyloModel as JPM  # noqa: E402
from plf_tpu.models import hky85 as jhky  # noqa: E402
from plf_tpu.models import parse_newick as jparse  # noqa: E402
from plf_tpu.models import random_tree as jrt  # noqa: E402
from plf_tpu.models.optimize import tree_loglik_fn as j_tree_loglik_fn  # noqa: E402
from plf_tpu.ops import plf_tree_seg as JSG  # noqa: E402
from plf_tpu_torch import convert  # noqa: E402
from plf_tpu_torch.config import PLFConfig  # noqa: E402
from plf_tpu_torch.models import optimize as TO  # noqa: E402
from plf_tpu_torch.ops import plf_tree as TT  # noqa: E402
from plf_tpu_torch.ops import plf_tree_seg as SG  # noqa: E402

ROWS = 16


def _caterpillar(n_leaves):
    nwk = "A0:0.1"
    for i in range(1, n_leaves):
        nwk = f"({nwk},A{i}:0.1):0.1"
    return jparse(nwk + ";")


def _jax_model(tree, n_sites, seed, tip_dtype="int32", variant="vpu"):
    """A JAX HKY85+G4 model with gaps and IUPAC codes (interpret mode)."""
    rng = np.random.default_rng(seed)
    tips = rng.integers(-1, 14, size=(tree.n_leaves, n_sites))
    return JPM(tree, jhky(2.0, [0.3, 0.2, 0.3, 0.2]), tips, alpha=0.5,
               config=JCfg(block_sites=128, interpret=True,
                           tip_dtype=tip_dtype, kernel_variant=variant))


def _port_of(pm):
    return convert.phylo_model(
        pi=pm.model.pi, eigenvalues=pm.model.eigenvalues, u=pm.model.u,
        w=pm.model.w, nodes=[(n.index, n.name, n.length, n.children)
                             for n in pm.tree.nodes], root=pm.tree.root,
        rates=pm.rates, tip_states=pm.tip_states, wgt=pm.wgt,
        config=PLFConfig(block_sites=128, tip_dtype=pm.config.tip_dtype,
                         kernel_variant=pm.config.kernel_variant),
        device="cpu")


def _schedules(pm):
    """The reordered schedule (field 5 the original edge) and the same by
    position, as the JAX package plans it."""
    sched = TT.reorder_schedule(pm.schedule, pm.tree.n_leaves)
    pos = [(p, l, r, 0.0, 0.0, i) for i, (p, l, r, *_x) in enumerate(sched)]
    return sched, pos


def _jax_inputs(pm, sched):
    eidx = jnp.asarray([e[5] for e in sched])
    codes3 = pm._codes.reshape(pm.tree.n_leaves, 1, -1)
    return (codes3, jnp.take(pm._lcs, eidx, axis=0),
            jnp.take(pm._rcs, eidx, axis=0), pm._ec, pm._kernel_tip_table(),
            pm._root_rows)


def _programs(plan, sched):
    out = []
    for reuse in (True, False):
        prog, segs, n_slots = SG.segment_program(plan, sched,
                                                 reuse_slots=reuse)
        out.append((torch.as_tensor(prog), torch.as_tensor(segs), n_slots))
    return out


def _forward(pt, plan, sched):
    (prog, segs, n_slots), _ = _programs(plan, sched)
    return SG.plf_tree_seg_torch(
        pt.codes, prog, segs, pt.lcs, pt.rcs, pt.ec, pt.fused_tip_table,
        pt.root_rows[0], pt.n_sites, n_boundaries=plan.n_boundaries,
        n_slots=n_slots)


# ------------------------------------------------------------------ plan --


@pytest.mark.parametrize("n_leaves,cap", [(12, 6), (30, 4), (40, 3),
                                          (160, 6)])
def test_plan_equals_jax(n_leaves, cap):
    """The copied contraction cuts the same segments: every Segment array
    and count, the plan's counts and the stacked arrays equal the JAX
    package's for the same schedule, rows and cap_ops (both budgets admit
    these caps, so neither planner halves them)."""
    tree = jrt(n_leaves, seed=n_leaves)
    sched = TT.reorder_schedule(tree.schedule(), n_leaves)
    pos = [(p, l, r, 0.0, 0.0, i) for i, (p, l, r, *_x) in enumerate(sched)]
    got = SG.plan_segments(pos, n_leaves, rows=ROWS, cap_ops=cap)
    want = JSG.plan_segments(pos, n_leaves, rows=ROWS, block_sites=128,
                             cap_ops=cap)
    for k in ("n_leaves", "n_edges", "n_boundaries", "seg_tips", "seg_bnd",
              "seg_ops", "seg_out"):
        assert getattr(got, k) == getattr(want, k), k
    assert len(got.segments) == len(want.segments) > 1
    for a, b in zip(got.segments, want.segments):
        for f in ("tip_ids", "bnd_in_ids", "lsrc", "rsrc", "ovalid", "opos",
                  "out_slots", "bnd_out_ids"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for f in ("n_tips", "n_bnd_in", "n_ops", "n_bnd_out", "root_slot"):
            assert getattr(a, f) == getattr(b, f), f
    st_t, st_j = SG._stacked_plan(got), JSG._stacked_plan(want)
    assert st_t.keys() == st_j.keys()
    for k in st_t:
        np.testing.assert_array_equal(st_t[k], st_j[k])


def test_capacity_rule_and_program():
    """Kernel 8's shared-memory rule: at 32 sites a DNA op takes a 2 KB
    slot, 32 flag bytes and 512 bytes of gl/gr sums, and cap_ops 8 lets
    eight blocks share an SM (9 would not); a plan that does not fit at
    cap_ops=1 raises.  The programs cover every op once,
    in segments, with one slot per op for kernel 8 and reused slots for
    kernel 7."""
    assert SG.SEG_SITES == 32 and SG.SEG_BLOCKS_PER_SM == 8
    assert SG.seg_bwd_smem_bytes(1, ROWS, 16) - \
        SG.seg_bwd_smem_bytes(0, ROWS, 16) == 2048 + 32 + 512
    assert SG.seg_cap_ops(ROWS, 16) == 8
    per_block = SG.SM_SMEM_BYTES // 8 - SG.SMEM_RESERVED_PER_BLOCK
    assert SG.seg_bwd_smem_bytes(8, ROWS, 16) <= per_block \
        < SG.seg_bwd_smem_bytes(9, ROWS, 16)
    tree = jrt(160, seed=3)
    sched = TT.reorder_schedule(tree.schedule(), 160)
    pos = [(p, l, r, 0.0, 0.0, i) for i, (p, l, r, *_x) in enumerate(sched)]
    plan = SG.plan_segments(pos, 160, rows=ROWS)
    assert plan.seg_ops <= 8 and plan.n_boundaries == len(plan.segments) - 1
    fwd, bwd = (SG.segment_program(plan, sched, reuse_slots=r)
                for r in (True, False))
    for prog, segs, n_slots in (fwd, bwd):
        assert sorted(prog[5]) == list(range(len(sched)))
        assert segs[-1, 0] == len(sched) and segs[-1, 1] == -1
        assert sorted(segs[:-1, 1]) == list(range(plan.n_boundaries))
        assert prog[4].max() < n_slots
    assert fwd[2] < bwd[2] == plan.seg_ops
    with pytest.raises(ValueError, match="cap_ops=1"):
        SG.plan_segments(pos, 160, rows=4000, cap_ops=4)


# --------------------------------------------------------------- forward --


def _forward_case(name, tip_dtype="int32"):
    if name == "rescaling":
        return _jax_model(_caterpillar(40), 256, 7, tip_dtype), 10
    n_leaves, cap = {"12-6": (12, 6), "30-8": (30, 8)}[name]
    return _jax_model(jrt(n_leaves, seed=3), 300, n_leaves, tip_dtype), cap


@pytest.mark.parametrize("tip_dtype", ["int32", "int8"])
@pytest.mark.parametrize("name", ["12-6", "30-8", "rescaling"])
def test_plain_forward_matches_jax_and_kernel2(name, tip_dtype):
    """plf_tree_seg_torch against JAX's plf_tree_segmented (interpret
    mode) at the same cap_ops (the port's planner halves a cap whose
    segments kernel 8's arena cannot hold, so the cuts may differ; the
    function does not): rescale counts exactly, site likelihoods at
    rel 5e-5 (XLA:CPU contracts FMAs in the interpreted kernel, 1.2e-5
    measured against the golden chain, ROADMAP queue 3); against the
    port's plf_tree_torch (kernel 2's plain version) bit for bit, and the
    int8 codes give the int32 result bit for bit."""
    pm, cap = _forward_case(name, tip_dtype)
    pt = _port_of(pm)
    if name == "rescaling":
        assert pt.log_likelihood().scaler_total > 0, "case must rescale"
    sched, pos = _schedules(pm)
    plan = SG.plan_segments(pos, pm.tree.n_leaves, rows=ROWS, cap_ops=cap)
    assert len(plan.segments) >= 2
    lik, sc, bbuf = _forward(pt, plan, sched)
    jplan = JSG.plan_segments(pos, pm.tree.n_leaves, rows=ROWS,
                              block_sites=128, cap_ops=cap)
    lik_j, sc_j = JSG.plf_tree_segmented(jplan, *_jax_inputs(pm, sched),
                                         pm.n_sites, interpret=True)
    n = pm.n_sites
    np.testing.assert_array_equal(sc.numpy()[0, :n], np.asarray(sc_j)[0, :n])
    np.testing.assert_allclose(lik.numpy()[0, :n], np.asarray(lik_j)[0, :n],
                               rtol=5e-5)
    ref = TT.plf_tree_torch(pt.codes, pt.sched, pt.lcs, pt.rcs, pt.ec,
                            pt.fused_tip_table, pt.root_rows[0], n,
                            n_slots=pt.n_slots, root_slot=pt.root_slot)
    assert torch.equal(lik, ref[0]) and torch.equal(sc, ref[1])
    assert bbuf.shape == (plan.n_boundaries, ROWS, pt.n_pad)
    if tip_dtype == "int8":
        assert pt.codes.dtype == torch.int8
        p32 = _port_of(_forward_case(name)[0])
        lik32, sc32, _ = _forward(p32, plan, sched)
        assert torch.equal(lik, lik32) and torch.equal(sc, sc32)


def test_method_segmented_matches_jax_and_fused():
    """PhyloModel.log_likelihood(method="segmented") against JAX's
    log_likelihood_segmented (rel 1e-6 in the total, equal rescale totals)
    and the port's fused path (site for site, bit for bit); the plan is
    cached on the model and auto still takes the fused kernel."""
    pm = _jax_model(jrt(30, seed=5), 300, seed=5)
    pt = _port_of(pm)
    seg = pt.log_likelihood(method="segmented")
    fused = pt.log_likelihood(method="fused")
    np.testing.assert_array_equal(seg.site_log_likelihood,
                                  fused.site_log_likelihood)
    assert seg.scaler_total == fused.scaler_total
    assert pt._segmented_inputs() is pt._segmented_inputs()
    want = pm.log_likelihood(method="segmented")
    assert seg.scaler_total == want.scaler_total
    assert seg.log_likelihood == pytest.approx(want.log_likelihood, rel=1e-6)


# -------------------------------------------------------------- backward --


def _bwd_case(name):
    if name == "underflow":
        return _jax_model(_caterpillar(24), 256, seed=9), 6
    return _jax_model(jrt(12, seed=1), 384, seed=1), 4


@pytest.mark.parametrize("name", ["random", "underflow"])
def test_plain_backward_matches_jax_vjp(name):
    """gl, gr (per original edge), gec and grr of plf_tree_seg_bwd_torch
    against the VJP of JAX's make_tree_diff_segmented (interpret mode,
    operators by schedule position) on the same plan, within 2e-5 of each
    gradient's largest entry (the vpu tree VJP's bar: XLA:CPU's FMA
    contraction in the interpreted kernels, and the site sums run in
    another order).  The CPU wrapper gives the plain version's results,
    and make_tree_diff_segmented runs the forward and this backward."""
    pm, cap = _bwd_case(name)
    pt = _port_of(pm)
    if name == "underflow":
        assert pt.log_likelihood().scaler_total > 0, "case must rescale"
    n_leaves, n = pm.tree.n_leaves, pm.n_sites
    sched, pos = _schedules(pm)
    glik = np.random.default_rng(3).standard_normal(
        (1, pm.n_pad)).astype(np.float32)
    f = JSG.make_tree_diff_segmented(sched, n_leaves, block_sites=128,
                                     cap_ops=cap, interpret=True)
    codes3, lcs3, rcs3, ec, ttab, rr = _jax_inputs(pm, sched)

    def loss(lcs3, rcs3, ec, rr):
        lik, _ = f(codes3, lcs3, rcs3, ec, ttab, rr, n)
        return jnp.sum(lik * glik)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(lcs3, rcs3, ec, rr)
    plan = SG.plan_segments(pos, n_leaves, rows=ROWS, cap_ops=cap)
    assert len(plan.segments) == len(f.plan.segments) >= 2
    _, bbuf = _forward(pt, plan, sched)[1:]
    _, (prog, segs, _) = _programs(plan, sched)
    args = (pt.codes, prog, segs, pt.lcs, pt.rcs, pt.ec, pt.fused_tip_table,
            pt.root_rows[0], torch.as_tensor(glik), bbuf, n)
    got = SG.plf_tree_seg_bwd_torch(*args)
    eidx = np.asarray([e[5] for e in sched])
    pairs = (("gl", got[0].numpy()[eidx], want[0]),
             ("gr", got[1].numpy()[eidx], want[1]),
             ("gec", got[2].numpy(), want[2]),
             ("grr", got[3].numpy(), np.asarray(want[3])[0]))
    for label, a, b in pairs:
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=2e-5 * np.abs(np.asarray(b)).max(),
                                   err_msg=label)
    gbuf = torch.full_like(bbuf, np.nan)
    wrapped = SG.plf_tree_seg_bwd(*args, seg_ops=plan.seg_ops, gbuf=gbuf)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))
    assert torch.isfinite(gbuf).all()
    fn = SG.make_tree_diff_segmented(sched, n_leaves, cap_ops=cap)
    ops = [t.clone().requires_grad_()
           for t in (pt.lcs, pt.rcs, pt.ec, pt.root_rows[0])]
    lik, _ = fn(pt.codes, ops[0], ops[1], ops[2], pt.fused_tip_table,
                ops[3], n)
    lik.backward(torch.as_tensor(glik))
    assert all(torch.equal(t.grad, g) for t, g in zip(ops, got))


def test_tree_loglik_fn_segmented_matches_jax():
    """tree_loglik_fn(backend="segmented") on the CPU (kernels 7 + 8,
    plain) against JAX's "segmented" (interpret mode) and "xla" backends:
    values within rel 1e-5, gradients within rtol 5e-4 / atol 1e-4
    (tests/test_tree_seg.py's bars); against the port's "tree" backend the
    value and gradients are equal (the same site sums in the same order)."""
    pm = _jax_model(jrt(12, seed=1), 384, seed=1)
    pt = _port_of(pm)
    fn, t0 = TO.tree_loglik_fn(pt, backend="segmented")
    assert (fn.engine, fn.variant) == ("segmented", "vpu")
    got = {}
    for name, f in (("segmented", fn),
                    ("tree", TO.tree_loglik_fn(pt, backend="tree")[0])):
        t = torch.tensor(t0, requires_grad=True)
        v = f(t)
        v.backward()
        got[name] = (float(v.detach()), t.grad.numpy())
    assert got["segmented"][0] == got["tree"][0]
    np.testing.assert_array_equal(got["segmented"][1], got["tree"][1])
    for backend in ("segmented", "xla"):
        jf, jt0 = j_tree_loglik_fn(pm, backend=backend)
        val, g = jax.value_and_grad(jf)(jnp.asarray(jt0))
        assert got["segmented"][0] == pytest.approx(float(val), rel=1e-5)
        np.testing.assert_allclose(got["segmented"][1], np.asarray(g),
                                   rtol=5e-4, atol=1e-4)


def test_matrix_form_and_bf16_guards():
    """The segmented engine takes a matrix-form model ("mxu" at S = 4
    here): can_segment is True, method="segmented" equals the fused path
    site for site and backend="segmented" trains (kernels 7m + 8m, plain,
    on the CPU), its value equal to the "tree" backend's;
    make_tree_diff_segmented takes S = 20.  bf16 CLV storage now builds and
    its segmented path runs (kernel 7's plain version with bf16
    boundaries), and "mxu_bf16" still refuses every gradient backend."""
    pm = _jax_model(jrt(5, seed=2), 128, seed=2, variant="mxu")
    pt = _port_of(pm)
    assert pt.can_segment()
    seg = pt.log_likelihood(method="segmented")
    np.testing.assert_array_equal(
        seg.site_log_likelihood,
        pt.log_likelihood(method="fused").site_log_likelihood)
    values = {}
    for backend in ("segmented", "tree"):
        fn, t0 = TO.tree_loglik_fn(pt, backend=backend)
        assert (fn.engine, fn.variant) == (backend, "mxu")
        with torch.no_grad():
            values[backend] = float(fn(t0))
    assert values["segmented"] == values["tree"]
    b16 = convert.phylo_model(
        pi=pm.model.pi, eigenvalues=pm.model.eigenvalues, u=pm.model.u,
        w=pm.model.w, newick="((A,B),C);",
        tip_states=np.zeros((3, 10), np.int32), rates=[1.0],
        config=PLFConfig(dtype="bfloat16"), device="cpu")
    assert np.isfinite(b16.log_likelihood(method="segmented").log_likelihood)
    bf16 = convert.phylo_model(
        pi=pm.model.pi, eigenvalues=pm.model.eigenvalues, u=pm.model.u,
        w=pm.model.w, newick="((A,B),C);",
        tip_states=np.zeros((3, 10), np.int32), rates=[1.0],
        config=PLFConfig(kernel_variant="mxu_bf16"), device="cpu")
    with pytest.raises(ValueError, match="mxu_bf16"):
        TO.tree_loglik_fn(bf16, backend="segmented")
    fn = SG.make_tree_diff_segmented(_schedules(pm)[0], 5, states=20,
                                     variant="mxu_3x")
    assert fn.plan.n_edges == 4


def test_auto_takes_segmented_where_kernel4_would_chunk():
    """The card's auto rule, on the free device memory it is given: for a
    DNA "vpu" model stored in fp32, "segmented" wherever kernel 8's
    boundary buffers fit, chunked kernel 4 or not (kernels 7 + 8 were the
    faster step at every DNA shape timed on an H100, PERF.md), "tree"
    where they do not; with bf16 boundaries (DNA, or an "mxu_3x" model),
    "segmented" only where kernel 4's (4m's) checkpoint would be chunked
    (more than half the free memory) and the boundary buffers fit;
    never for a matrix-form model in fp32 storage ("mxu_3x", "mxu"), whose
    "tree" step was the faster one where kernel 4m chunks (PERF.md)."""
    pt = _port_of(_jax_model(jrt(40, seed=2), 300, seed=2))
    plan = pt._segmented_inputs()[0]
    ck4 = len(pt.schedule) * (pt.config.rows * 4 + 1) * pt.n_pad
    bufs = 2 * plan.n_boundaries * pt.config.rows * 4 * pt.n_pad
    assert bufs < ck4
    assert TO._segmented_wins(pt, free=2 * ck4)
    assert TO._segmented_wins(pt, free=2 * ck4 - 2)
    assert TO._segmented_wins(pt, free=bufs)
    assert not TO._segmented_wins(pt, free=bufs - 1)
    b16 = copy.copy(pt)
    b16.config = dataclasses.replace(pt.config, dtype="bfloat16")
    assert not TO._segmented_wins(b16, free=2 * ck4)
    assert TO._segmented_wins(b16, free=2 * ck4 - 2)
    assert TO._segmented_wins(b16, free=bufs // 2)
    assert not TO._segmented_wins(b16, free=bufs // 2 - 1)
    mxu_3x = _port_of(_jax_model(jrt(40, seed=2), 300, seed=2,
                                 variant="mxu_3x"))
    plan = mxu_3x._segmented_inputs()[0]
    assert plan.n_boundaries > 0
    ck4 = len(mxu_3x.schedule) * (mxu_3x.config.rows * 4 + 1) * mxu_3x.n_pad
    bufs = 2 * plan.n_boundaries * mxu_3x.config.rows * 4 * mxu_3x.n_pad
    for free in (2 * ck4, 2 * ck4 - 2, bufs, bufs - 1):
        assert not TO._segmented_wins(mxu_3x, free=free)
    m16 = copy.copy(mxu_3x)
    m16.config = dataclasses.replace(mxu_3x.config, dtype="bfloat16")
    assert not TO._segmented_wins(m16, free=2 * ck4)
    assert TO._segmented_wins(m16, free=2 * ck4 - 2)
    assert TO._segmented_wins(m16, free=bufs // 2)
    assert not TO._segmented_wins(m16, free=bufs // 2 - 1)
    mxu = _port_of(_jax_model(jrt(40, seed=2), 300, seed=2, variant="mxu"))
    assert not TO._segmented_wins(mxu, free=bufs)
