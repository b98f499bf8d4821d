"""Kernels 7m and 8m (the matrix forms of the segmented whole-tree forward
and backward): their plain versions, the matrix forms' capacity rule and
the segmented paths of protein and codon models, against the JAX
package's segmented engine (``plf_tpu/ops/plf_tree_seg.py``, its
``is_mxu`` branches, in interpret mode) and against the port's own fused
matrix-form kernels (2m and 4m).

JAX's gradients are dense ``(rows, rows)`` block gradients; only their
entries at the lane-constant positions reach a branch length, and those
are what the port returns, so only those are compared.  The reduced
variants ("mxu_3x", "mxu_bf16") are step functions of their fp32 inputs
and XLA:CPU's fp32 sums round differently from one CPU to another, so they
are held to their variant's error class measured in the same run, never
to a fixed bar (ROADMAP queue 3 caveats).  Tolerances are stated per test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.models import PhyloModel as JPM  # noqa: E402
from plf_tpu.models import parse_newick as jparse  # noqa: E402
from plf_tpu.models import random_tree as jrt  # noqa: E402
from plf_tpu.models import simulate_alignment  # noqa: E402
from plf_tpu.models import substitution as JS  # noqa: E402
from plf_tpu.ops import plf_tree_seg as JSG  # noqa: E402
from plf_tpu_torch import convert  # noqa: E402
from plf_tpu_torch.config import PLFConfig  # noqa: E402
from plf_tpu_torch.models import optimize as TO  # noqa: E402
from plf_tpu_torch.ops import plf_tree as TT  # noqa: E402
from plf_tpu_torch.ops import plf_tree_grad as TG  # noqa: E402
from plf_tpu_torch.ops import plf_tree_seg as SG  # noqa: E402
from test_torch_tree_grad_mxu import (_jax_grads,  # noqa: E402,F401
                                      _jax_protein, _lane_positions,
                                      tpu_bf16_pass)

VARIANTS = ("mxu", "mxu_3x", "mxu_bf16")


def _caterpillar(n_leaves):
    nwk = "A0:0.3"
    for i in range(1, n_leaves):
        nwk = f"({nwk},A{i}:0.3):0.3"
    return jparse(nwk + ";")


#: name -> (states, categories, tree, n_sites, cap_ops): S = 20 (8 leaves x
#: 256 sites, LG), S = 61 (5 leaves x 128 codons simulated under GY94, C =
#: 2: random codons cancel their eigen coordinates below the fp32 paths'
#: resolution), a 14-leaf caterpillar at S = 20 whose sites rescale (the
#: forced-underflow case), and S = 13 with C = 3 (a random GTR model; five-
#: row jobs in kernel 7m) on 129 sites, one past a tile.  Each cap cuts the
#: tree into several segments.
CASES = {
    "s20": (20, 4, lambda: jrt(8, seed=9), 256, 4),
    "s61": (61, 2, lambda: jrt(5, seed=0), 128, 2),
    "underflow": (20, 2, lambda: _caterpillar(14), 128, 4),
    "s13": (13, 3, lambda: jrt(7, seed=4), 129, 3),
}


def _tips(S, tree, n_sites, seed):
    if S == 61:
        return simulate_alignment(tree, JS.codon_gy94(2.0, 0.4), n_sites,
                                  alpha=0.5, seed=seed)
    tips = np.random.default_rng(seed).integers(
        -1, 23 if S == 20 else S, size=(tree.n_leaves, n_sites))
    tips[:, 4] = -1                                     # a gap column
    return tips


def _jax_model(case, variant):
    S, C, make_tree, n_sites, _ = CASES[case]
    tree = make_tree()
    model = (JS.empirical_protein("lg") if S == 20
             else JS.codon_gy94(2.0, 0.4) if S == 61
             else JS.random_gtr(S, seed=5))
    return JPM(tree, model, _tips(S, tree, n_sites, seed=S + len(case)),
               alpha=0.5, config=JCfg(states=S, categories=C,
                                      block_sites=128, interpret=True,
                                      kernel_variant=variant))


def _port_of(pm, variant):
    return convert.phylo_model(
        pi=pm.model.pi, eigenvalues=pm.model.eigenvalues, u=pm.model.u,
        w=pm.model.w, nodes=[(n.index, n.name, n.length, n.children)
                             for n in pm.tree.nodes], root=pm.tree.root,
        rates=pm.rates, tip_states=pm.tip_states, wgt=pm.wgt,
        config=PLFConfig(states=pm.config.states, block_sites=128,
                         kernel_variant=variant), device="cpu")


def _jax_arithmetic(variant, request):
    """"mxu_bf16" with JAX's one-pass dots as the TPU runs them (the
    ``tpu_bf16_pass`` fixture of test_torch_tree_grad_mxu.py)."""
    if variant == "mxu_bf16":
        request.getfixturevalue("tpu_bf16_pass")


def _plan(pm, cap):
    """The reordered schedule, and the plan of the matrix forms at
    ``cap`` ops (the JAX package's contraction)."""
    n_leaves = pm.tree.n_leaves
    sched = TT.reorder_schedule(pm.schedule, n_leaves)
    pos = [(p, l, r, 0.0, 0.0, i) for i, (p, l, r, *_x) in enumerate(sched)]
    plan = SG.plan_segments(pos, n_leaves, rows=pm.config.rows, cap_ops=cap,
                            matrix_form=True)
    assert len(plan.segments) >= 2
    return sched, pos, plan


def _program(plan, sched, reuse):
    prog, segs, n_slots = SG.segment_program(plan, sched, reuse_slots=reuse)
    return torch.as_tensor(prog), torch.as_tensor(segs), n_slots


def _forward(pt, plan, sched, variant):
    prog, segs, n_slots = _program(plan, sched, True)
    S, C = pt.config.states, pt.config.categories
    return SG.plf_tree_seg_torch(
        pt.codes, prog, segs, pt.lcs, pt.rcs, pt.ec, pt.fused_tip_table,
        pt.root_rows[0], pt.n_sites, n_boundaries=plan.n_boundaries,
        n_slots=n_slots, states=S, categories=C, variant=variant,
        planes=pt._planes())


def _jax_inputs(pm, sched):
    eidx = np.asarray([e[5] for e in sched])
    codes3 = jnp.asarray(pm._codes).reshape(pm.tree.n_leaves, 1, pm.n_pad)
    return (codes3, jnp.asarray(pm._lcs_np[eidx]),
            jnp.asarray(pm._rcs_np[eidx]), pm._ec, pm._kernel_tip_table(),
            pm._root_rows)


def _site_lik(lik, sc, n):
    """Site likelihoods with the rescales counted in (float64): continuous
    where a rescale flag flips, and defined where "mxu_bf16" rounds a
    likelihood below zero."""
    return (np.asarray(lik, np.float64)[0, :n]
            * np.exp2(-32.0 * np.asarray(sc, np.float64)[0, :n]))


# --------------------------------------------------------------- forward --


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_mxu_matches_jax(case, variant, request):
    """plf_tree_seg_torch in the matrix forms against JAX's
    plf_tree_segmented(variant=...) (interpret mode) on the same plan, and
    against the port's fused form.

    The port's segmented forward equals its fused one (kernel 2m's plain
    version) bit for bit in every variant: the same ops, the same
    sequential root reduction.  "mxu": rescale counts equal and site
    likelihoods within 5e-5 relative of JAX's (XLA:CPU's FMA-contracted,
    blocked fp32 dots, and the root reduced as a dot).  "mxu_3x" and
    "mxu_bf16": site log-likelihoods (rescales counted in, continuous
    where a flag flips) within the variant's class on this input, twice
    the largest distance of JAX's result from the port's fp32-grade "mxu"
    one, measured here, and never closer than the "mxu" bar; both as a
    share of each site's "mxu" likelihood, rescales counted in (so the
    measure is continuous where a flag flips, and defined where
    "mxu_bf16" rounds a likelihood below zero)."""
    _jax_arithmetic(variant, request)
    pm = _jax_model(case, variant)
    pt = _port_of(pm, variant)
    S, C, _, _, cap = CASES[case]
    n = pm.n_sites
    if case == "underflow":
        assert pt.log_likelihood().scaler_total > 0, "case must rescale"
    sched, pos, plan = _plan(pm, cap)
    lik, sc, bbuf = _forward(pt, plan, sched, variant)
    assert bbuf.shape == (plan.n_boundaries, S * C, pt.n_pad)
    ref = TT.plf_tree_torch(pt.codes, pt.sched, pt.lcs, pt.rcs, pt.ec,
                            pt.fused_tip_table, pt.root_rows[0], n,
                            n_slots=pt.n_slots, root_slot=pt.root_slot,
                            states=S, categories=C, variant=variant,
                            planes=pt._planes())
    assert torch.equal(lik, ref[0]) and torch.equal(sc, ref[1])
    jplan = JSG.plan_segments(pos, pm.tree.n_leaves, rows=S * C,
                              block_sites=128, cap_ops=cap, op_width=S * C)
    assert len(jplan.segments) == len(plan.segments)
    lik_j, sc_j = JSG.plf_tree_segmented(
        jplan, *_jax_inputs(pm, sched), n, states=S, categories=C,
        interpret=True, variant=variant)
    if variant == "mxu":
        np.testing.assert_array_equal(sc.numpy()[0, :n],
                                      np.asarray(sc_j)[0, :n])
        np.testing.assert_allclose(lik.numpy()[0, :n],
                                   np.asarray(lik_j)[0, :n], rtol=5e-5)
        return
    got, want = _site_lik(lik, sc, n), _site_lik(lik_j, sc_j, n)
    f32 = _site_lik(*_forward(_port_of(pm, "mxu"), plan, sched, "mxu")[:2], n)
    bar = max(5e-5, 2 * np.max(np.abs(want - f32) / np.abs(f32)))
    assert np.max(np.abs(got - want) / np.abs(f32)) <= bar


# -------------------------------------------------------------- backward --


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_mxu_matches_jax(case, variant, request):
    """gl, gr (per original edge, at the lane-constant positions), gec and
    grr of plf_tree_seg_bwd_torch in the matrix forms against the VJP of
    JAX's make_tree_diff_segmented(variant=...) (interpret mode, block
    operators by schedule position) on the same plan, as a share of each
    gradient's largest entry, by kernel 4m's test's rules
    (test_torch_tree_grad_mxu.py::test_plain_tree_vjp_mxu_matches_jax):
    "mxu" every entry within rtol 5e-4 / atol 1e-4; the reduced variants
    with the cotangent zeroed where the two packages' forward rescale
    flags differ (at most 1% of the sites), the median entry within 2e-5,
    and every entry within twice the largest distance of JAX's gradient
    from the port's "mxu" one (or 2e-5).  The CPU wrapper gives the plain
    version's results."""
    _jax_arithmetic(variant, request)
    pm = _jax_model(case, variant)
    pt = _port_of(pm, variant)
    S, C, _, _, cap = CASES[case]
    n, n_leaves = pm.n_sites, pm.tree.n_leaves
    sched, _, plan = _plan(pm, cap)
    glik = np.random.default_rng(S + cap).standard_normal(
        (1, pm.n_pad)).astype(np.float32)
    f = JSG.make_tree_diff_segmented(sched, n_leaves, states=S, categories=C,
                                     block_sites=128, cap_ops=cap,
                                     interpret=True, variant=variant)
    assert len(f.plan.segments) == len(plan.segments)
    codes3, *ops = _jax_inputs(pm, sched)
    ttab = ops.pop(3)
    lik_t, sc_t, bbuf = _forward(pt, plan, sched, variant)
    if variant != "mxu":
        _, sc_j = f(codes3, *ops[:3], ttab, ops[3], n)
        flipped = np.asarray(sc_j)[0] != sc_t.numpy()[0]
        assert flipped.sum() <= 0.01 * n, f"{flipped.sum()} flags flipped"
        glik = np.where(flipped, 0.0, glik).astype(np.float32)

    def loss(lcs3, rcs3, ec, rr):
        lik, _ = f(codes3, lcs3, rcs3, ec, ttab, rr, n)
        return jnp.sum(lik * glik)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*ops)
    eidx = np.asarray([e[5] for e in sched])
    prog, segs, _ = _program(plan, sched, False)

    def port(v, p):
        b = bbuf if v == variant else _forward(p, plan, sched, v)[2]
        args = (p.codes, prog, segs, p.lcs, p.rcs, p.ec, p.fused_tip_table,
                p.root_rows[0], torch.as_tensor(glik), b, n)
        kw = dict(states=S, categories=C, variant=v, planes=p._planes())
        got = SG.plf_tree_seg_bwd_torch(*args, **kw)
        wrapped = SG.plf_tree_seg_bwd(*args, seg_ops=plan.seg_ops, **kw)
        assert all(torch.equal(a, w) for a, w in zip(got, wrapped))
        gl, gr, gec, grr = (a.numpy() for a in got)
        return gl[eidx], gr[eidx], gec, grr

    wants = (_lane_positions(want[0], S, C), _lane_positions(want[1], S, C),
             _lane_positions(want[2], S, C), np.asarray(want[3])[0])
    fp32 = port("mxu", _port_of(pm, "mxu")) if variant != "mxu" else None
    for k, (name, a, b) in enumerate(zip(("gl", "gr", "gec", "grr"),
                                         port(variant, pt), wants)):
        scale = np.abs(b).max()
        if variant == "mxu":
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-4 * scale,
                                       err_msg=name)
            continue
        assert np.median(np.abs(a - b)) <= 2e-5 * scale, name
        bar = max(2e-5 * scale, 2 * np.abs(b - fp32[k]).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=bar, err_msg=name)


def test_make_tree_diff_segmented_mxu_is_kernel7m_forward_kernel8m_backward():
    """On an "mxu_3x" protein model: the differentiable segmented
    likelihood's forward equals kernel 2m's plain version bit for bit, its
    gradients equal kernel 8m's plain version's, and (every per-site
    value being the same, summed in the same order on the CPU) kernel
    4m's plain version's."""
    pm = _jax_model("s20", "mxu_3x")
    pt = _port_of(pm, "mxu_3x")
    sched = TT.reorder_schedule(pt.schedule, pt.tree.n_leaves)
    fn = SG.make_tree_diff_segmented(sched, pt.tree.n_leaves, states=20,
                                     cap_ops=4, n_codes=pt.tip_table.shape[1],
                                     variant="mxu_3x")
    assert len(fn.plan.segments) > 1
    planes = pt._planes()
    ops = [t.clone().requires_grad_()
           for t in (pt.lcs, pt.rcs, pt.ec, pt.root_rows[0])]
    lik, sc = fn(pt.codes, ops[0], ops[1], ops[2], pt.fused_tip_table,
                 ops[3], pt.n_sites, planes=planes)
    ref = TT.plf_tree(pt.codes, pt.sched, pt.lcs, pt.rcs, pt.ec,
                      pt.fused_tip_table, pt.root_rows[0], pt.n_sites,
                      n_slots=pt.n_slots, root_slot=pt.root_slot, states=20,
                      variant="mxu_3x", planes=planes)
    assert torch.equal(lik.detach(), ref[0]) and torch.equal(sc, ref[1])
    glik = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (1, pt.n_pad)).astype(np.float32))
    lik.backward(glik)
    bsched = torch.as_tensor(TG.backward_schedule(sched, pt.tree.n_leaves))
    want = TG.plf_tree_bwd_mxu_torch(
        pt.codes, bsched, pt.lcs, pt.rcs, pt.ec, pt.fused_tip_table,
        pt.root_rows[0], glik, pt.n_sites, states=20, variant="mxu_3x",
        planes=planes)
    for t, w in zip(ops, want):
        assert torch.equal(t.grad, w)


# --------------------------------------------------------- capacity rule --


def test_matrix_form_capacity_rule():
    """Kernel 8's shared-memory rule admits no op at S = 20 (24 tip
    codes) or S = 61 (64): its fixed part alone overflows an eighth of an
    SM.  The matrix forms' rule takes, of SEG_MXU_CAPS, the cap whose plan
    needs the least device memory per site (op checkpoint plus boundary
    rows and adjoints) among plans whose kernel-7m arena fits; at 1,024
    protein taxa that is a ninth of kernel 4m's checkpoint.  A plan whose
    kernel-7m arena fits at no cap raises."""
    assert SG.seg_cap_ops(80, 24) == 0 and SG.seg_cap_ops(244, 64) == 0
    tree = jrt(1024, seed=1)
    sched = TT.reorder_schedule(tree.schedule(), 1024)
    pos = [(p, l, r, 0.0, 0.0, i) for i, (p, l, r, *_x) in enumerate(sched)]
    cap = SG.seg_mxu_cap_ops(pos, 1024, rows=80, n_codes=24)
    assert cap in SG.SEG_MXU_CAPS
    plan = SG.plan_segments(pos, 1024, rows=80, n_codes=24, matrix_form=True)
    assert plan.seg_ops <= cap and len(plan.segments) > 1
    bytes_at = {c: SG.seg_mxu_site_bytes(SG._contract(pos, 1024, c), 80)
                for c in SG.SEG_MXU_CAPS}
    assert bytes_at[cap] == min(bytes_at.values())
    assert bytes_at[cap] * 8 < TG.tree_bwd_scratch_bytes(1023, 80, 1)
    prog, segs, n_slots = SG.segment_program(plan, sched, reuse_slots=True)
    assert TT.tree_mxu_fits(n_slots, 80, 24)
    assert sorted(prog[5]) == list(range(1023))
    with pytest.raises(ValueError, match="kernel-7m arena"):
        SG.plan_segments(pos, 1024, rows=244, n_codes=400, cap_ops=8,
                         matrix_form=True)


# ----------------------------------------------------- through the model --


@pytest.fixture
def two_op_caps(monkeypatch):
    """The matrix forms' rule choosing from a cap of 2 ops alone, so that
    a 5-leaf model's plan has several segments (the rule's own choice
    keeps such a small tree whole: one segment of four ops needs the least
    memory)."""
    monkeypatch.setattr(SG, "SEG_MXU_CAPS", (2,))


@pytest.mark.parametrize("states", [20, 61])
def test_method_segmented_mxu_matches_jax_and_fused(states, two_op_caps):
    """PhyloModel.log_likelihood(method="segmented") on an "mxu" protein
    and codon model (test_torch_tree_grad_mxu.py's models): equal to the
    port's fused path site for site, bit for bit, on a plan of several
    segments; against JAX's log_likelihood_segmented (interpret mode):
    equal rescale totals and totals within 1e-6 relative, as
    tests/test_tree_seg.py holds JAX's segmented path to its fused one
    (site by site the two packages' fp32 paths differ by up to 5.7e-5 on
    this protein model, fused or segmented alike; the site-level bar is
    test_plain_forward_mxu_matches_jax's); and within 1e-5 relative of the
    float64 brute force."""
    pm = _jax_protein("mxu", states=states)
    pt = _port_of(pm, "mxu")
    assert pt.can_segment()
    seg = pt.log_likelihood(method="segmented")
    fused = pt.log_likelihood(method="fused")
    np.testing.assert_array_equal(seg.site_log_likelihood,
                                  fused.site_log_likelihood)
    assert seg.scaler_total == fused.scaler_total
    assert len(pt._segmented_inputs()[0].segments) > 1
    want = pm.log_likelihood(method="segmented")
    assert seg.scaler_total == want.scaler_total
    assert seg.log_likelihood == pytest.approx(want.log_likelihood, rel=1e-6)
    bf = pm.log_likelihood_bruteforce()
    assert seg.log_likelihood == pytest.approx(bf, rel=1e-5)


def _grads(fn, t0):
    t = torch.tensor(t0, requires_grad=True)
    v = fn(t)
    v.backward()
    return float(v.detach()), t.grad.numpy()


@pytest.mark.parametrize("variant,states", [("mxu", 20), ("mxu_3x", 20),
                                            ("mxu", 61)])
def test_tree_loglik_fn_segmented_mxu_matches_jax(variant, states,
                                                  two_op_caps):
    """tree_loglik_fn(backend="segmented") on a protein or codon model on
    the CPU (kernels 7m + 8m, plain, on a plan of several segments): the
    value and gradient equal the port's "tree" backend's (the same
    per-site values summed in the same order); against JAX's
    "segmented" (interpret mode; not at S = 61, where it takes minutes)
    and "xla": test_torch_tree_grad_mxu.py's bars for the "tree" backend,
    values rel 1e-5 ("mxu") or 1e-4 ("mxu_3x"), gradients at rtol 5e-4 /
    atol 1e-4 ("mxu") or within "mxu_3x"'s class measured here, twice the
    largest distance of JAX's "segmented" gradient from its "xla" one."""
    pm = _jax_protein(variant, states=states)
    pt = _port_of(pm, variant)
    fn, t0 = TO.tree_loglik_fn(pt, backend="segmented")
    assert (fn.engine, fn.variant) == ("segmented", variant)
    assert len(pt._segmented_inputs()[0].segments) > 1
    v, g = _grads(fn, t0)
    v_t, g_t = _grads(TO.tree_loglik_fn(pt, backend="tree")[0], t0)
    assert v == v_t
    np.testing.assert_array_equal(g, g_t)
    rel = 1e-5 if variant == "mxu" else 1e-4
    ref = {b: _jax_grads(pm, b)
           for b in (("segmented", "xla") if states == 20 else ("xla",))}
    for v_j, g_j in ref.values():
        assert v == pytest.approx(v_j, rel=rel)
        if variant == "mxu":
            np.testing.assert_allclose(g, g_j, rtol=5e-4, atol=1e-4)
    if variant == "mxu_3x":
        bar = 2 * np.abs(ref["segmented"][1] - ref["xla"][1]).max()
        assert np.abs(g - ref["segmented"][1]).max() <= bar
        assert np.abs(g - ref["xla"][1]).max() <= bar


def test_segmented_mxu_wrappers_on_the_cpu():
    """The wrappers dispatch a matrix-form call to kernels 7m and 8m,
    whose CPU tensors take the plain versions (no launch counted); a
    device with no kernel, an unknown variant and mismatched shapes
    raise."""
    pm = _jax_protein("mxu_3x")
    pt = _port_of(pm, "mxu_3x")
    sched, _, plan = _plan(pt, 2)
    prog, segs, n_slots = _program(plan, sched, True)
    args = [pt.codes, prog, segs, pt.lcs, pt.rcs, pt.ec, pt.fused_tip_table,
            pt.root_rows[0]]
    kw = dict(n_boundaries=plan.n_boundaries, n_slots=n_slots, states=20,
              categories=2)
    before = (SG.plf_tree_seg_mxu.launches, SG.plf_tree_seg_bwd_mxu.launches)
    lik, sc, bbuf = SG.plf_tree_seg(*args, pt.n_sites, variant="mxu_3x",
                                    planes=pt._planes(), **kw)
    want = SG.plf_tree_seg_torch(*args, pt.n_sites, variant="mxu_3x", **kw)
    assert all(torch.equal(a, b) for a, b in zip((lik, sc, bbuf), want))
    bprog, bsegs, _ = _program(plan, sched, False)
    glik = torch.ones((1, pt.n_pad))
    SG.plf_tree_seg_bwd(pt.codes, bprog, bsegs, *args[3:], glik, bbuf,
                        pt.n_sites, seg_ops=plan.seg_ops, states=20,
                        categories=2, variant="mxu_3x")
    assert (SG.plf_tree_seg_mxu.launches,
            SG.plf_tree_seg_bwd_mxu.launches) == before
    with pytest.raises(ValueError, match="no kernel for device"):
        SG.plf_tree_seg(*(a.to("meta") for a in args), pt.n_sites,
                        variant="mxu", **kw)
    with pytest.raises(ValueError, match="variant"):
        SG.plf_tree_seg_mxu(*args, pt.n_sites, variant="tf32", **kw)
    with pytest.raises(ValueError, match="prog"):
        SG.plf_tree_seg(args[0], prog[:5], *args[2:], pt.n_sites,
                        variant="mxu", **kw)
    with pytest.raises(ValueError, match="glik"):
        SG.plf_tree_seg_bwd(pt.codes, bprog, bsegs, *args[3:], glik[:, :64],
                            bbuf, pt.n_sites, seg_ops=plan.seg_ops,
                            states=20, categories=2, variant="mxu")
