"""bf16 CLV storage (``PLFConfig(dtype="bfloat16")``) in the port, against
the JAX package's in interpret mode, as ``tests/test_io.py``,
``tests/test_ops.py`` and ``tests/test_tree_seg.py`` run it.

Routes: ``PLFEngine.plf`` (kernels 1 and 1m), the segmented forward
(kernels 7 and 7m) and the segmented VJP (kernels 7 + 8) store CLVs in
bf16; ``plf_batch``, the fused and per-node paths, ``Backend.TORCH`` and
the "tree", "kernel" and "torch" gradient backends ignore the dtype, as in
the JAX package.

Inside the port the rounding sits where JAX's does, so a bf16 result is
the bf16 rounding of the fp32 plain result of the same rounded inputs, bit
for bit.  Across the packages the fp32 values that get rounded already
differ (XLA:CPU contracts FMAs in the interpreted kernels; ROADMAP
caveats), so a bf16 value may land one ulp apart: each cross-package check
is held to one bf16 ulp, or to twice JAX's own bf16-vs-fp32 distance
measured in the same run on the same segment plan, never to bit equality
or a fixed bar.  Tolerances are stated per test.
"""

import warnings
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.engine import PLFEngine as JEngine  # noqa: E402
from plf_tpu.models import PhyloModel as JPM  # noqa: E402
from plf_tpu.models import hky85 as jhky  # noqa: E402
from plf_tpu.models import random_tree as jrt  # noqa: E402
from plf_tpu.models import substitution as JS  # noqa: E402
from plf_tpu.models.optimize import tree_loglik_fn as j_tree_loglik_fn  # noqa: E402
from plf_tpu.ops import plf_tree_seg as JSG  # noqa: E402
from plf_tpu_torch import convert  # noqa: E402
from plf_tpu_torch.config import Backend, PLFConfig  # noqa: E402
from plf_tpu_torch.engine import PLFEngine  # noqa: E402
from plf_tpu_torch.models import PhyloModel, hky85, random_tree  # noqa: E402
from plf_tpu_torch.models import optimize as TO  # noqa: E402
from plf_tpu_torch.models.phylo import LOG_MINLIK  # noqa: E402
from plf_tpu_torch.ops import plf_tree as TT  # noqa: E402
from plf_tpu_torch.ops import plf_tree_seg as SG  # noqa: E402
from tests.conftest import make_random_case  # noqa: E402

BF16 = torch.bfloat16


def _bf16(a):
    """fp32 ``a`` rounded to bf16 (nearest even), as fp32 numpy."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _lane_positions(g, S, C):
    """The lane-constant entries ``g[..., o*C+c, q*C+c]`` of JAX's dense
    ``(..., rows, rows)`` block gradients, as ``(..., rows, S)``."""
    rows = np.arange(S * C)
    cols = np.arange(S)[None, :] * C + (rows % C)[:, None]
    return np.asarray(g)[..., rows[:, None], cols]


def _ulp(m):
    """One bf16 ulp at fp32 magnitudes ``m`` (2^-133 below 2^-126)."""
    e = np.floor(np.log2(np.maximum(m, np.float32(2.0 ** -133))))
    return np.exp2(np.maximum(e, -126) - 7)


# ------------------------------------------------------------------ engine --


@pytest.mark.parametrize("variant,states", [("vpu", 4), ("mxu_3x", 20)])
def test_engine_bf16_matches_jax(variant, states):
    """PLFEngine.plf under bf16 (kernel 1 at S=4 "vpu", kernel 1m at S=20
    "mxu_3x"; plain versions here) on the forced-underflow generator
    (tests/test_io.py:186, tests/test_ops.py:187): x3 is bf16; no element
    is more than one bf16 ulp of the larger value from JAX's; the scaler
    flags are JAX's; and x3 is the bf16 rounding of the fp32 engine's x3
    on the bf16-rounded inputs, exactly."""
    n = 512
    x1, x2, left, right, ev, wgt = make_random_case(
        np.random.default_rng(11 + states), n, states=states)
    kw = dict(states=states, kernel_variant=variant, block_sites=128)
    out = PLFEngine(PLFConfig(dtype="bfloat16", **kw), device="cpu").plf(
        x1, x2, left, right, ev, wgt)
    ref = JEngine(JCfg(dtype="bfloat16", interpret=True, **kw)).plf(
        x1, x2, left, right, ev, wgt)
    assert out.x3.dtype == BF16 and ref.x3.dtype == jnp.bfloat16
    got = out.x3.float().numpy().reshape(n, -1)
    want = np.asarray(ref.x3, np.float32).reshape(n, -1)
    diff = np.abs(got - want)
    assert np.all(diff <= _ulp(np.maximum(np.abs(got), np.abs(want)))), (
        diff.max())
    print(f"{variant} S={states}: {np.mean(diff > 0):.2e} of the elements "
          f"one bf16 ulp from JAX's")
    np.testing.assert_array_equal(out.scaler_vector.numpy(),
                                  np.asarray(ref.scaler_vector))
    assert int(out.scaler_increment) == int(ref.scaler_increment)
    assert states != 4 or int(out.scaler_increment) > 0, "case must rescale"
    f32 = PLFEngine(PLFConfig(**kw), device="cpu").plf(
        _bf16(x1), _bf16(x2), left, right, ev, wgt)
    assert torch.equal(out.x3, f32.x3.to(BF16))
    assert torch.equal(out.scaler_vector, f32.scaler_vector)


def test_plf_batch_ignores_bf16():
    """plf_batch stays fp32 under bf16, as the JAX engine's batch does
    (engine.py:179-226): its result equals the fp32 config's bit for
    bit."""
    rng = np.random.default_rng(5)
    cases = [make_random_case(rng, 300) for _ in range(3)]
    args = [np.stack([c[i] for c in cases]) for i in range(6)]
    outs = [PLFEngine(PLFConfig(block_sites=128, dtype=d),
                      device="cpu").plf_batch(*args)
            for d in ("bfloat16", "float32")]
    assert outs[0].x3.dtype == torch.float32
    for f in ("x3", "scaler_vector", "scaler_increment"):
        assert torch.equal(getattr(outs[0], f), getattr(outs[1], f)), f
    jout = JEngine(JCfg(block_sites=128, dtype="bfloat16",
                        interpret=True)).plf_batch(*args)
    assert jout.x3.dtype == jnp.float32


# ---------------------------------------------------- routes that ignore it --


def _grad(fn, t0):
    t = torch.tensor(t0, requires_grad=True)
    v = fn(t)
    v.backward()
    return v.detach(), t.grad


@pytest.mark.parametrize("backend", [Backend.KERNEL, Backend.TORCH])
def test_dtype_ignored_off_the_segmented_path(backend):
    """The fused and per-node paths and Backend.TORCH's plain path under
    bf16 equal the fp32 model site for site, bit for bit; so do the
    "tree", "kernel" and "torch" gradient backends' values and gradients,
    with no bf16 warning."""
    tree = random_tree(12, seed=4)
    tips = np.random.default_rng(4).integers(-1, 14, size=(12, 300))
    pms = {d: PhyloModel(tree, hky85(2.0), tips, alpha=0.5, device="cpu",
                         config=PLFConfig(block_sites=128, backend=backend,
                                          dtype=d))
           for d in ("float32", "bfloat16")}
    methods = (("fused", "per-node") if backend is Backend.KERNEL
               else ("auto",))
    for method in methods:
        a, b = (pms[d].log_likelihood(method=method) for d in pms)
        np.testing.assert_array_equal(a.site_log_likelihood,
                                      b.site_log_likelihood)
        assert a.scaler_total == b.scaler_total
    grads = (("tree", "kernel", "torch") if backend is Backend.KERNEL
             else ("auto",))
    for name in grads:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            (v32, g32), (v16, g16) = (_grad(*TO.tree_loglik_fn(
                pms[d], backend=name)) for d in pms)
        assert torch.equal(v32, v16) and torch.equal(g32, g16), name


# --------------------------------------------------------------- segmented --


def _dna_jax(n_leaves, seed, n_sites, tip_seed):
    """tests/test_tree_seg.py's bf16 models: HKY85 k=2 + G4 a=0.6."""
    tips = np.random.default_rng(tip_seed).integers(
        0, 4, size=(n_leaves, n_sites))
    return JPM(jrt(n_leaves, seed=seed), jhky(2.0), tips, alpha=0.6,
               config=JCfg(block_sites=128, interpret=True))


def _s20_jax():
    """test_torch_tree_seg_mxu.py's S=20 case: 8 leaves x 256 sites, LG."""
    tree = jrt(8, seed=9)
    tips = np.random.default_rng(25).integers(-1, 23, size=(8, 256))
    return JPM(tree, JS.empirical_protein("lg"), tips, alpha=0.5,
               config=JCfg(states=20, block_sites=128, interpret=True,
                           kernel_variant="mxu"))


def _port_of(pm, dtype="float32"):
    cfg = pm.config
    return convert.phylo_model(
        pi=pm.model.pi, eigenvalues=pm.model.eigenvalues, u=pm.model.u,
        w=pm.model.w, nodes=[(n.index, n.name, n.length, n.children)
                             for n in pm.tree.nodes], root=pm.tree.root,
        rates=pm.rates, tip_states=pm.tip_states, wgt=pm.wgt,
        config=PLFConfig(states=cfg.states, block_sites=128, dtype=dtype,
                         kernel_variant=cfg.kernel_variant), device="cpu")


def _sched(pm_or_tree):
    tree = getattr(pm_or_tree, "tree", pm_or_tree)
    sched = TT.reorder_schedule(tree.schedule(), tree.n_leaves)
    pos = [(p, l, r, 0.0, 0.0, i) for i, (p, l, r, *_x) in enumerate(sched)]
    return sched, pos


def _jax_inputs(pm, sched):
    eidx = jnp.asarray([e[5] for e in sched])
    codes3 = pm._codes.reshape(pm.tree.n_leaves, 1, -1)
    return (codes3, jnp.take(pm._lcs, eidx, axis=0),
            jnp.take(pm._rcs, eidx, axis=0), pm._ec, pm._kernel_tip_table(),
            pm._root_rows)


def _site_lik(lik, sc, n):
    """Site likelihoods in float64 with the rescales folded in."""
    return (np.asarray(lik, np.float64)[0, :n]
            * np.exp(np.asarray(sc, np.float64)[0, :n] * LOG_MINLIK))


def _hold_to_jax_class(label, p16, p32, j16, j32):
    """The port's bf16-storage result ``p16`` against JAX's ``j16``, with
    both packages' fp32 results ``p32``/``j32`` of the same run: the two
    round the same values at the same points and share those errors, so
    ``p16`` is within a quarter of JAX's own bf16-vs-fp32 distance plus the
    fp32 class (twice the packages' fp32 distance, and 2e-5 of the largest
    entry); and that bar lies below the port's own bf16-vs-fp32 distance,
    so a port that rounded nowhere (or returned zeros) would fail."""
    dist = lambda a, b: float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
    bar = (dist(j16, j32) / 4 + 2 * dist(p32, j32)
           + 2e-5 * float(np.max(np.abs(j32))))
    print(f"{label}: port bf16 {dist(p16, j16):.3e} from JAX's, JAX bf16 "
          f"{dist(j16, j32):.3e} from its fp32, port bf16 "
          f"{dist(p16, p32):.3e} from its fp32, bar {bar:.3e}")
    assert dist(p16, j16) <= bar, label
    assert dist(p16, p32) > bar, label


@pytest.mark.parametrize("case", ["dna", "s20"])
def test_segmented_forward_bf16_matches_jax(case):
    """The segmented forward under bf16 (kernels 7 and 7m, plain here) on
    tests/test_tree_seg.py:398's tree and data and on an S=20 "mxu"
    protein model, against JAX's plf_tree_segmented on the same plan (cap
    6, and 4 at S=20): bf16 differs from the port's fp32 (the rounding is
    real); every site likelihood is within twice JAX's own largest
    bf16-vs-fp32 distance plus the fp32 bar (5e-5), as shares of JAX's fp32
    site likelihood; a boundary whose segment reads tips alone is the bf16
    rounding of the fp32 run's row, exactly.  Through PhyloModel the
    port's bf16 log-likelihood differs from its fp32 one and is within
    5e-3 of JAX's fp32 one (tests/test_tree_seg.py:416)."""
    pm = _dna_jax(40, 2, 1024, 3) if case == "dna" else _s20_jax()
    S, C = pm.config.states, pm.config.categories
    variant, cap = ("vpu", 6) if case == "dna" else ("mxu", 4)
    pt = _port_of(pm)
    n, n_leaves = pm.n_sites, pm.tree.n_leaves
    sched, pos = _sched(pm)
    plan = SG.plan_segments(pos, n_leaves, rows=S * C, cap_ops=cap,
                            matrix_form=case != "dna")
    jplan = JSG.plan_segments(pos, n_leaves, rows=S * C, block_sites=128,
                              cap_ops=cap,
                              op_width=0 if case == "dna" else S * C)
    assert len(plan.segments) == len(jplan.segments) >= 3
    prog, segs, n_slots = (torch.as_tensor(a) if i < 2 else a for i, a in
                           enumerate(SG.segment_program(plan, sched,
                                                        reuse_slots=True)))
    port, jax_ = {}, {}
    for dtype in (torch.float32, BF16):
        port[dtype] = SG.plf_tree_seg_torch(
            pt.codes, prog, segs, pt.lcs, pt.rcs, pt.ec, pt.fused_tip_table,
            pt.root_rows[0], n, n_boundaries=plan.n_boundaries,
            n_slots=n_slots, states=S, categories=C, variant=variant,
            planes=pt._planes(), dtype=dtype)
        jax_[dtype] = JSG.plf_tree_segmented(
            jplan, *_jax_inputs(pm, sched), n, states=S, categories=C,
            interpret=True, variant=variant,
            dtype=str(dtype).split(".")[1])
    (l32, s32, b32), (l16, s16, b16) = port[torch.float32], port[BF16]
    assert b16.dtype == BF16 and not torch.equal(l16, l32)
    j32, j16 = (_site_lik(*jax_[d], n) for d in (torch.float32, BF16))
    p16 = _site_lik(l16, s16, n)
    bar = 2 * np.max(np.abs(j16 - j32) / j32) + 5e-5
    dist = np.max(np.abs(p16 - j16) / j32)
    print(f"{case}: port bf16 {dist:.3e} from JAX's, bar {bar:.3e}")
    assert dist <= bar
    st = SG._stacked_plan(plan)
    tips_only = [int(st["gout"][s]) for s in range(len(plan.segments))
                 if st["counts"][s, 1] == 0
                 and st["gout"][s] < plan.n_boundaries]
    assert tips_only
    for b in tips_only:
        assert torch.equal(b16[b], b32[b].to(BF16)), b
    if case == "dna":
        r32, r16 = (_port_of(pm, d).log_likelihood(method="segmented")
                    .log_likelihood for d in ("float32", "bfloat16"))
        want = pm.log_likelihood(method="segmented").log_likelihood
        assert r16 != r32
        assert abs(r16 - want) / abs(want) < 5e-3


def test_segmented_vjp_bf16_matches_jax():
    """The segmented VJP under bf16 (kernels 7 + 8, plain here) on
    tests/test_tree_seg.py:420's tree and data.  tree_loglik_fn(backend=
    "segmented") warns naming bf16; its value is within rel 5e-3 of the
    fp32 step's and not equal to it, its gradient within 0.05 of it with a
    1e-2 floor (tests/test_tree_seg.py:445-450).  Against JAX's
    make_tree_diff_segmented on the same plan (cap 6) with a random
    cotangent: the value and each of gl, gr, gec and grr are held to JAX's
    class by _hold_to_jax_class."""
    pm = _dna_jax(24, 5, 512, 5)
    n, n_leaves = pm.n_sites, pm.tree.n_leaves
    pts = {d: _port_of(pm, d) for d in ("float32", "bfloat16")}
    fn32, t0 = TO.tree_loglik_fn(pts["float32"], backend="segmented")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fn16, _ = TO.tree_loglik_fn(pts["bfloat16"], backend="segmented")
    assert any("bf16" in str(x.message) for x in w)
    (v32, g32), (v16, g16) = (_grad(f, t0) for f in (fn32, fn16))
    assert v16 != v32 and abs(float(v16 - v32)) / abs(float(v32)) < 5e-3
    assert float(((g16 - g32).abs() / (g32.abs() + 1e-2)).max()) < 0.05

    sched, _ = _sched(pm)
    eidx = np.asarray([e[5] for e in sched])
    glik = np.random.default_rng(3).standard_normal(
        (1, pm.n_pad)).astype(np.float32)
    codes3, lcs3, rcs3, ec, ttab, rr = _jax_inputs(pm, sched)
    pt = pts["float32"]
    got, want = {}, {}
    for dtype in ("float32", "bfloat16"):
        f = JSG.make_tree_diff_segmented(sched, n_leaves, block_sites=128,
                                         cap_ops=6, interpret=True,
                                         dtype=dtype)

        def loss(lcs3, rcs3, ec, rr):
            lik, _ = f(codes3, lcs3, rcs3, ec, ttab, rr, n)
            return jnp.sum(lik * glik)

        val, g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
            lcs3, rcs3, ec, rr)
        want[dtype] = [float(val)] + [np.asarray(a) for a in g[:3]] + [
            np.asarray(g[3])[0]]
        fn = SG.make_tree_diff_segmented(sched, n_leaves, cap_ops=6,
                                         dtype=dtype)
        assert len(fn.plan.segments) == len(f.plan.segments) >= 3
        ops = [t.clone().requires_grad_()
               for t in (pt.lcs, pt.rcs, pt.ec, pt.root_rows[0])]
        lik, _ = fn(pt.codes, ops[0], ops[1], ops[2], pt.fused_tip_table,
                    ops[3], n)
        value = (lik * torch.as_tensor(glik)).sum()
        value.backward()
        got[dtype] = [float(value.detach())] + [ops[0].grad.numpy()[eidx],
                                       ops[1].grad.numpy()[eidx],
                                       ops[2].grad.numpy(),
                                       ops[3].grad.numpy()]
    for i, label in enumerate(("value", "gl", "gr", "gec", "grr")):
        _hold_to_jax_class(label, *(x[d][i] for x in (got, want)
                                    for d in ("bfloat16", "float32")))


@pytest.mark.parametrize("variant", ["mxu", "mxu_3x"])
def test_segmented_vjp_bf16_mxu_matches_jax(variant):
    """The matrix-form segmented VJP under bf16 (kernels 7m + 8m, plain
    here: bf16 boundaries exported and widened, adjoints narrowed into
    gbuf through the staging tiles, a segment's root seed widened) on the
    S = 20 LG case of test_torch_tree_seg_mxu.py (8 leaves x 256 sites,
    cap 4, several segments): make_tree_diff_segmented against JAX's on
    the same plan, with a random cotangent on lik (no 1/lik, so the check
    is well conditioned).  The value and each of gl, gr (per edge, JAX's
    at the lane-constant positions), gec and grr are held to JAX's class
    by _hold_to_jax_class."""
    tree = jrt(8, seed=9)
    tips = np.random.default_rng(25).integers(-1, 23, size=(8, 256))
    pm = JPM(tree, JS.empirical_protein("lg"), tips, alpha=0.5,
             config=JCfg(states=20, block_sites=128, interpret=True,
                         kernel_variant=variant))
    S, C = 20, pm.config.categories
    n, n_leaves = pm.n_sites, pm.tree.n_leaves
    sched, _ = _sched(pm)
    eidx = np.asarray([e[5] for e in sched])
    codes3, lcs3, rcs3, ec, ttab, rr = _jax_inputs(pm, sched)
    glik = np.random.default_rng(3).standard_normal(
        (1, pm.n_pad)).astype(np.float32)
    got, want = {}, {}
    for dtype in ("float32", "bfloat16"):
        f = JSG.make_tree_diff_segmented(sched, n_leaves, states=S,
                                         categories=C, block_sites=128,
                                         cap_ops=4, interpret=True,
                                         variant=variant, dtype=dtype)

        def loss(lcs3, rcs3, ec, rr):
            lik, _ = f(codes3, lcs3, rcs3, ec, ttab, rr, n)
            return jnp.sum(lik * glik)

        val, g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
            lcs3, rcs3, ec, rr)
        want[dtype] = [float(val)] + [_lane_positions(a, S, C)
                                      for a in g[:3]] + [np.asarray(g[3])[0]]
        pt = _port_of(pm, dtype)
        fn = SG.make_tree_diff_segmented(sched, n_leaves, states=S,
                                         categories=C, cap_ops=4,
                                         n_codes=pt.tip_table.shape[1],
                                         variant=variant, dtype=dtype)
        assert len(fn.plan.segments) == len(f.plan.segments) >= 3
        ops = [t.clone().requires_grad_()
               for t in (pt.lcs, pt.rcs, pt.ec, pt.root_rows[0])]
        lik, _ = fn(pt.codes, ops[0], ops[1], ops[2], pt.fused_tip_table,
                    ops[3], n)
        value = (lik * torch.as_tensor(glik)).sum()
        value.backward()
        got[dtype] = [float(value.detach()), ops[0].grad.numpy()[eidx],
                      ops[1].grad.numpy()[eidx], ops[2].grad.numpy(),
                      ops[3].grad.numpy()]
    for i, label in enumerate(("value", "gl", "gr", "gec", "grr")):
        _hold_to_jax_class(f"{variant} {label}",
                           *(x[d][i] for x in (got, want)
                             for d in ("bfloat16", "float32")))


def _protein_steps(taxa, sites):
    """Value and gradient of tree_loglik_fn(backend="segmented") of an
    LG+G4 "mxu_3x" model (random_tree(taxa, seed=8, mean_branch=0.2),
    random codes from seed 8, the models of test_torch_cuda.py::
    test_bf16_paths_on_the_card[20] at 40 x 1,500) in fp32 and bf16
    storage, in the port and in JAX, JAX's planner pinned to the port's
    cap so that both cut the tree alike: ``(port, jax)``, each
    ``{dtype: (value, gradient)}``."""
    tree = jrt(taxa, seed=8, mean_branch=0.2)
    tips = np.random.default_rng(8).integers(-1, 23, size=(taxa, sites))
    _, pos = _sched(tree)
    got, want = {}, {}
    for dtype in ("float32", "bfloat16"):
        pm = JPM(tree, JS.empirical_protein("lg"), tips, alpha=0.6,
                 config=JCfg(states=20, block_sites=128, interpret=True,
                             kernel_variant="mxu_3x", dtype=dtype))
        pt = _port_of(pm, dtype)
        cap = SG.seg_mxu_cap_ops(pos, taxa, rows=80,
                                 n_codes=pt.tip_table.shape[1])
        jplan = JSG.plan_segments(pos, taxa, rows=80, block_sites=128,
                                  cap_ops=cap, op_width=80)
        assert jplan.n_boundaries == pt._segmented_inputs()[0].n_boundaries
        assert jplan.n_boundaries > 0
        with mock.patch.object(JSG, "plan_segments",
                               lambda *a, **k: jplan), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fn, t0 = j_tree_loglik_fn(pm, backend="segmented")
            pt_fn, _ = TO.tree_loglik_fn(pt, backend="segmented")
        val, g = jax.value_and_grad(fn)(jnp.asarray(t0))
        want[dtype] = (float(val), np.asarray(g))
        v, gp = _grad(pt_fn, t0)
        got[dtype] = (float(v), gp.numpy())
    return got, want


def _gradient_readings(got, want):
    """The bf16-vs-fp32 gradient distance in JAX and in the port, as the
    largest share of |fp32| + 1e-2 (tests/test_tree_seg.py:449-450)."""
    rel = lambda x: float(np.max(np.abs(x["bfloat16"][1] - x["float32"][1])
                                 / (np.abs(x["float32"][1]) + 1e-2)))
    return (f"largest fp32 entry {np.max(np.abs(want['float32'][1])):.3e}; "
            f"bf16 vs fp32 {rel(want):.3e} in JAX, {rel(got):.3e} in the "
            f"port")


def test_segmented_vjp_bf16_protein_matches_jax():
    """tree_loglik_fn(backend="segmented") of an LG+G4 "mxu_3x" model
    (24 taxa x 256 sites, _protein_steps) under bf16 against JAX's on the
    same plan: the value is within 5e-3 of the fp32 one, not equal to it,
    and within twice JAX's own bf16-vs-fp32 distance plus twice the fp32
    cross-package distance (the value's fp32 distance is too large here
    for the tighter rule of _hold_to_jax_class).  The gradient is only
    reported, with both packages' bf16-vs-fp32 distances: rounded
    eigen-coordinate boundaries under adjoints scaled by 1/lik move it by
    up to several times its size, in the JAX package as in the port, so no
    bar on it could fail; test_segmented_vjp_bf16_mxu_matches_jax holds
    the matrix-form VJP itself to JAX's class with a well-conditioned
    cotangent.  ``python -m tests.test_torch_bf16 40 1500`` prints the
    readings of the on-card test's model."""
    got, want = _protein_steps(24, 256)
    (p16, g16), (p32, g32), (j16, _), (j32, _) = (
        x[d] for x in (got, want) for d in ("bfloat16", "float32"))
    bar = 2 * abs(j16 - j32) + 2 * abs(p32 - j32)
    print(f"protein value: port bf16 {abs(p16 - j16):.3e} from JAX's, JAX "
          f"bf16 {abs(j16 - j32):.3e} from its fp32, bar {bar:.3e}")
    assert abs(p16 - j16) <= bar
    assert p16 != p32 and abs(p16 / p32 - 1) < 5e-3
    assert np.isfinite(g16).all()
    print(f"protein gradient: {_gradient_readings(got, want)}")


if __name__ == "__main__":
    import sys
    taxa, sites = (int(a) for a in sys.argv[1:3])
    readings = _gradient_readings(*_protein_steps(taxa, sites))
    print(f"{taxa} x {sites}: {readings}")
