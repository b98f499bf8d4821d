"""Kernel 4m's plain version, the differentiable whole-tree likelihood in
the matrix forms and the training routing, against the JAX package:
``make_tree_diff(..., variant=v, interpret=True)``'s VJP (the MXU form of
``_tree_bwd_kernel``), ``make_mxu_bwd_ops``' block gradients and
``tree_loglik_fn`` on the "tree" and "xla" backends.

JAX's gradients are dense ``(rows, rows)`` block gradients; only their
entries at the lane-constant positions of ``layout.branch_to_block_matrix``
reach a branch length, and those are what the port returns, so only those
are compared.  Tolerances are stated per test.
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
from plf_tpu.models.optimize import tree_loglik_fn as j_tree_loglik_fn  # noqa: E402
from plf_tpu.ops import plf_tree_grad as JG  # noqa: E402
from plf_tpu.ops.plf_pallas import make_mxu_bwd_ops  # noqa: E402
from plf_tpu_torch import convert  # noqa: E402
from plf_tpu_torch.config import PLFConfig  # noqa: E402
from plf_tpu_torch.models import optimize as TO  # noqa: E402
from plf_tpu_torch.ops import layout as L  # noqa: E402
from plf_tpu_torch.ops import plf_mxu as M  # noqa: E402
from plf_tpu_torch.ops import plf_tree as TT  # noqa: E402
from plf_tpu_torch.ops import plf_tree_grad as TG  # noqa: E402
from plf_tpu_torch.ops.plf_grad import transpose_lane_constants  # noqa: E402

VARIANTS = ("mxu", "mxu_3x", "mxu_bf16")


def _lane_positions(g, S, C):
    """The lane-constant entries ``g[..., o*C+c, q*C+c]`` of dense
    ``(..., rows, rows)`` block gradients, as ``(..., rows, S)``."""
    rows = np.arange(S * C)
    cols = (np.arange(S)[None, :] * C + (rows % C)[:, None])
    return np.asarray(g)[..., rows[:, None], cols]


def _port_of(pm, S, variant):
    """The JAX model's port by value, on the CPU."""
    return convert.phylo_model(
        pi=pm.model.pi, eigenvalues=pm.model.eigenvalues, u=pm.model.u,
        w=pm.model.w, nodes=[(n.index, n.name, n.length, n.children)
                             for n in pm.tree.nodes], root=pm.tree.root,
        rates=pm.rates, tip_states=pm.tip_states, wgt=pm.wgt,
        config=PLFConfig(states=S, block_sites=128, kernel_variant=variant),
        device="cpu")


def _caterpillar(n_leaves):
    nwk = "A0:0.3"
    for i in range(1, n_leaves):
        nwk = f"({nwk},A{i}:0.3):0.3"
    return jparse(nwk + ";")


#: name -> (states, categories, tree, n_sites): S = 20 (6 leaves x 256
#: sites), S = 61 (4 leaves x 128 sites, C = 2) and a 14-leaf caterpillar
#: at S = 20 whose sites rescale (the forced-underflow case).
CASES = {
    "s20": (20, 4, lambda: jrt(6, seed=3), 256),
    "s61": (61, 2, lambda: jrt(4, seed=5, mean_branch=0.2), 128),
    "underflow": (20, 2, lambda: _caterpillar(14), 128),
}


def _case(name, variant):
    S, C, make_tree, n_sites = CASES[name]
    tree = make_tree()
    rng = np.random.default_rng(len(name) * 7 + S)
    tips = rng.integers(-1, S + 3 if S == 20 else S + 1,
                        size=(tree.n_leaves, n_sites))
    model = (JS.empirical_protein("lg") if S == 20
             else JS.codon_gy94(2.0, 0.3))
    pm = JPM(tree, model, tips, alpha=0.6,
             config=JCfg(states=S, categories=C, block_sites=128,
                         interpret=True, kernel_variant=variant))
    glik = rng.standard_normal((1, pm.n_pad)).astype(np.float32)
    return pm, _port_of(pm, S, variant), glik


def _bsched(sched, n_leaves):
    bsched = TG.backward_schedule(sched, n_leaves)
    return torch.as_tensor(bsched), bsched[2]


@pytest.mark.parametrize("variant", VARIANTS)
def test_transpose_planes_commute_with_the_split(variant):
    """The transposed planes of k equal the planes of k's transpose, bit
    for bit, for a stack and for one matrix."""
    rng = np.random.default_rng(1)
    k = torch.as_tensor(rng.standard_normal((3, 80, 20)).astype(np.float32))
    for x in (k, k[0]):
        got = M.transpose_planes(M.operator_planes(x, variant), 20, 4)
        want = M.operator_planes(transpose_lane_constants(x, 20, 4), variant)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.fixture
def tpu_bf16_pass(monkeypatch):
    """JAX's one-pass bf16 dots as the TPU runs them: on the CPU, XLA runs
    a ``Precision.DEFAULT`` dot of fp32 operands in fp32, so "mxu_bf16"
    would be held to fp32 arithmetic.  Here such a dot rounds both
    operands to bf16 first (the TPU's pass: exact products, fp32 sums).
    The package's files are untouched; JAX's trace caches are cleared on
    the way in and out, so no other test sees a patched trace."""
    H, D = jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT

    def one_pass(f):
        def dot(a, b, *args, precision=None, **kw):
            if precision in (None, D):
                a, b, precision = (a.astype(jnp.bfloat16),
                                   b.astype(jnp.bfloat16), H)
            return f(a, b, *args, precision=precision, **kw)
        return dot

    jax.clear_caches()
    monkeypatch.setattr(jax.lax, "dot", one_pass(jax.lax.dot))
    monkeypatch.setattr(jax.lax, "dot_general", one_pass(jax.lax.dot_general))
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _jax_arithmetic(variant, request):
    if variant == "mxu_bf16":
        request.getfixturevalue("tpu_bf16_pass")


@pytest.mark.parametrize("variant", VARIANTS)
def test_op_grad_matches_jax_block_gradient(variant, request):
    """mxu_op_grad against make_mxu_bwd_ops' dot_t_s(split(gout),
    split(inp)) at the lane-constant positions, within 1e-6 of the largest
    entry: bf16 products are exact in both, and XLA's fp32 dot sums in
    another order ("mxu_bf16" with JAX's pass as the TPU runs it)."""
    _jax_arithmetic(variant, request)
    S, C = 20, 4
    rng = np.random.default_rng(2)
    inp = rng.standard_normal((S * C, 256)).astype(np.float32)
    gout = rng.standard_normal((S * C, 256)).astype(np.float32)
    split, _, dot_t_s = make_mxu_bwd_ops(variant)
    want = _lane_positions(dot_t_s(split(jnp.asarray(gout)),
                                   split(jnp.asarray(inp))), S, C)
    got = M.mxu_op_grad(torch.as_tensor(inp), torch.as_tensor(gout),
                        variant, S, C).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_tree_vjp_mxu_matches_jax(case, variant, request):
    """gl, gr (per original edge, at the lane-constant positions), gec and
    grr of plf_tree_bwd_mxu_torch against the VJP of JAX's make_tree_diff
    (interpret=True, block operators by schedule position; "mxu_bf16"
    with JAX's pass as the TPU runs it), as a share of each gradient's
    largest entry.

    "mxu": every entry within 5e-4, since XLA:CPU's fp32 dots contract
    into FMAs and block their 20- and 61-term sums, which the
    eigen-coordinate cancellation of random codon data amplifies (3.1e-4
    measured at S = 61, 1.3e-5 at S = 20).

    "mxu_3x" and "mxu_bf16" are step functions of their fp32 inputs: the
    bf16 split or rounding, and the 2^-32 rescale test, jump where an fp32
    rounding difference crosses a boundary, and XLA:CPU's dot sums round
    differently from one CPU to another.  So they are held where that
    cannot reach: (1) the cotangent is zeroed at the sites whose forward
    rescale counts differ between the packages (a flipped flag scales a
    site's gradient by 2^32; at most 1% of the sites may flip); (2) the
    median entry within 2e-5 (the vpu tree VJP's bar; 3e-7 measured: bf16
    products are exact in both); (3) every entry within the variant's
    error class on this input, measured here: twice the largest distance
    of JAX's gradient from the port's fp32-grade "mxu" one (which is held
    to JAX's "mxu" above), or 2e-5 where that is smaller."""
    _jax_arithmetic(variant, request)
    pm, pt, glik = _case(case, variant)
    S, C = pm.config.states, pm.config.categories
    n_leaves, n = pm.tree.n_leaves, pm.n_sites
    if case == "underflow":
        assert pt.log_likelihood().scaler_total > 0, "case must rescale"
    sched = TT.reorder_schedule(pm.schedule, n_leaves)
    bsched, eidx = _bsched(sched, n_leaves)
    f = JG.make_tree_diff(sched, n_leaves, states=S, categories=C,
                          block_sites=128, interpret=True, variant=variant)
    codes3 = jnp.asarray(pm._codes).reshape(n_leaves, 1, pm.n_pad)
    ttab = pm._kernel_tip_table()
    ops = (jnp.asarray(pm._lcs_np[eidx]), jnp.asarray(pm._rcs_np[eidx]),
           pm._ec, pm._root_rows)
    if variant != "mxu":
        _, sc_j = f(codes3, *ops[:3], ttab, ops[3], n)
        sc_t = TT.plf_tree(pt.codes, pt.sched, pt.lcs, pt.rcs, pt.ec,
                           pt.fused_tip_table, pt.root_rows[0], n,
                           n_slots=pt.n_slots, root_slot=pt.root_slot,
                           states=S, categories=C, variant=variant,
                           planes=pt._planes())[1]
        flipped = np.asarray(sc_j)[0] != sc_t.numpy()[0]
        assert flipped.sum() <= 0.01 * n, f"{flipped.sum()} flags flipped"
        glik = np.where(flipped, 0.0, glik).astype(np.float32)

    def loss(lcs3, rcs3, ec, rr):
        lik, _ = f(codes3, lcs3, rcs3, ec, ttab, rr, n)
        return jnp.sum(lik * glik)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*ops)

    def port(v):
        p = pt if v == variant else _port_of(pm, S, v)
        got = TG.plf_tree_bwd_mxu_torch(
            p.codes, bsched, p.lcs, p.rcs, p.ec, p.fused_tip_table,
            p.root_rows[0], torch.as_tensor(glik), n, states=S,
            categories=C, variant=v, planes=p._planes())
        gl, gr, gec, grr = (a.numpy() for a in got)
        return gl[eidx], gr[eidx], gec, grr

    wants = (_lane_positions(want[0], S, C), _lane_positions(want[1], S, C),
             _lane_positions(want[2], S, C), np.asarray(want[3])[0])
    fp32 = port("mxu") if variant != "mxu" else None
    for k, (name, a, b) in enumerate(zip(("gl", "gr", "gec", "grr"),
                                         port(variant), wants)):
        scale = np.abs(b).max()
        if variant == "mxu":
            np.testing.assert_allclose(a, b, rtol=0, atol=5e-4 * scale,
                                       err_msg=name)
            continue
        assert np.median(np.abs(a - b)) <= 2e-5 * scale, name
        bar = max(2e-5 * scale, 2 * np.abs(b - fp32[k]).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=bar, err_msg=name)


def test_make_tree_diff_mxu_is_kernel2m_forward_kernel4m_backward():
    """On an "mxu_3x" protein model: the forward equals kernel 2m's plain
    version on the model's planes bit for bit, and the gradients equal
    kernel 4m's plain version's."""
    pm, pt, glik = _case("s20", "mxu_3x")
    sched = TT.reorder_schedule(pt.schedule, pt.tree.n_leaves)
    bsched, _ = _bsched(sched, pt.tree.n_leaves)
    lcs, rcs, ec, rr = (t.clone().requires_grad_()
                        for t in (pt.lcs, pt.rcs, pt.ec, pt.root_rows[0]))
    fn = TG.make_tree_diff(sched, pt.tree.n_leaves, states=20,
                           variant="mxu_3x")
    planes = pt._planes()
    lik, sc = fn(pt.codes, lcs, rcs, ec, pt.fused_tip_table, rr, pt.n_sites,
                 planes=planes)
    ref = TT.plf_tree(pt.codes, pt.sched, pt.lcs, pt.rcs, pt.ec,
                      pt.fused_tip_table, pt.root_rows[0], pt.n_sites,
                      n_slots=pt.n_slots, root_slot=pt.root_slot, states=20,
                      variant="mxu_3x", planes=planes)
    assert torch.equal(lik.detach(), ref[0]) and torch.equal(sc, ref[1])
    lik.backward(torch.as_tensor(glik))
    want = TG.plf_tree_bwd_mxu_torch(
        pt.codes, bsched, pt.lcs, pt.rcs, pt.ec, pt.fused_tip_table,
        pt.root_rows[0], torch.as_tensor(glik), pt.n_sites, states=20,
        variant="mxu_3x", planes=planes)
    for t, w in zip((lcs, rcs, ec, rr), want):
        assert torch.equal(t.grad, w)


def _jax_protein(variant, states=20, n_leaves=5, n=100, seed=0):
    """tests/test_variant_grad.py::_make_pm: a random GTR-class model at
    S = 20 (C = 2) with random states; at S = 61 the GY94 codon model with
    an alignment simulated under it (random codons make every fp32 path
    cancel its eigen coordinates below zero at most sites)."""
    tree = jrt(n_leaves, seed=seed)
    if states == 20:
        model = JS.random_gtr(states, seed)
        tips = np.random.default_rng(seed).integers(0, states,
                                                    size=(n_leaves, n))
    else:
        model = JS.codon_gy94(2.0, 0.4)
        tips = simulate_alignment(tree, model, n, alpha=0.5, seed=seed)
    cfg = JCfg(states=states, categories=2, block_sites=128, interpret=True,
               kernel_variant=variant)
    return JPM(tree, model, tips, alpha=0.5, config=cfg)


def _jax_grads(pm, backend):
    fn, t0 = j_tree_loglik_fn(pm, backend=backend)
    val, g = jax.value_and_grad(fn)(jnp.asarray(t0))
    return float(val), np.asarray(g)


@pytest.mark.parametrize("variant,states", [("mxu", 20), ("mxu_3x", 20),
                                            ("mxu", 61)])
def test_tree_loglik_fn_tree_matches_jax(variant, states):
    """The port's "tree" backend on the CPU (kernels 2m + 4m, plain)
    against JAX's "tree" (interpret mode; not at S = 61, where it takes
    minutes) and "xla".  Values rel 1e-5 ("mxu") or 1e-4 ("mxu_3x", which
    drops the lo*lo term).  Gradients: "mxu" at test_variant_grad.py:50-57's
    rtol 5e-4 / atol 1e-4; "mxu_3x" within the variant's own error class
    on this input, twice the largest distance of JAX's "tree" gradient
    from its "xla" one, measured here (the hi/lo split is a step function,
    so the two packages' fp32 rounding differences move a split operand
    by up to 2^-17 of itself, and XLA:CPU's rounding differs from one CPU
    to another: the port lands at 1.01 of the once-distance on some
    machines, ROADMAP queue 3)."""
    pm = _jax_protein(variant, states=states)
    pt = _port_of(pm, states, variant)
    fn, t0 = TO.tree_loglik_fn(pt, backend="tree")
    assert (fn.engine, fn.variant) == ("tree", variant)
    t = torch.tensor(t0, requires_grad=True)
    v = fn(t)
    v.backward()
    g = t.grad.numpy()
    rel = 1e-5 if variant == "mxu" else 1e-4
    ref = {b: _jax_grads(pm, b)
           for b in (("tree", "xla") if states == 20 else ("xla",))}
    for v_j, g_j in ref.values():
        assert float(v.detach()) == pytest.approx(v_j, rel=rel)
        if variant == "mxu":
            np.testing.assert_allclose(g, g_j, rtol=5e-4, atol=1e-4)
    if variant == "mxu_3x":
        bar = 2 * np.abs(ref["tree"][1] - ref["xla"][1]).max()
        assert np.abs(g - ref["tree"][1]).max() <= bar
        assert np.abs(g - ref["xla"][1]).max() <= bar


class _Stand:
    """What the auto rule reads of a PhyloModel (one whose checkpoint the
    segmented rule never chunks)."""

    def __init__(self, device, fits):
        self.device, self._fits = torch.device(device), fits

    def can_fuse(self):
        return self._fits

    def can_segment(self):
        return False


def test_routing_of_matrix_form_models():
    """auto: "torch" off the card; on the card "tree" when kernel 2m takes
    the tree, else "segmented" (kernels 7m + 8m, as the JAX package takes
    its segmented engine; a "vpu" DNA model keeps "kernel").  "kernel"
    runs in "vpu" arithmetic on every variant: at S = 20 kernels 1m (fp32
    mode) + 3m, its value within rel 1e-4 of an "mxu" model's
    log_likelihood() (the same fp32 golden order), on an MXU variant at
    S = 4 kernels 1 + 3; "segmented" runs at S = 20."""
    assert TO._auto_backend(_Stand("cpu", False), True) == "torch"
    assert TO._auto_backend(_Stand("cuda", True), True) == "tree"
    assert TO._auto_backend(_Stand("cuda", False), False) == "kernel"
    assert TO._auto_backend(_Stand("cuda", False), True) == "segmented"
    pt = _port_of(_jax_protein("mxu", n_leaves=4, n=128), 20, "mxu")
    fn, _ = TO.tree_loglik_fn(pt)
    assert (fn.engine, fn.variant) == ("torch", "mxu")
    fn, t0 = TO.tree_loglik_fn(pt, backend="kernel")
    assert (fn.engine, fn.variant) == ("kernel", "vpu")
    with torch.no_grad():
        assert float(fn(t0)) == pytest.approx(
            pt.log_likelihood().log_likelihood, rel=1e-4)
    fn, _ = TO.tree_loglik_fn(pt, backend="segmented")
    assert (fn.engine, fn.variant) == ("segmented", "mxu")
    dna = JPM(jrt(5, seed=2), JS.hky85(2.0),
              np.random.default_rng(2).integers(0, 4, size=(5, 128)),
              alpha=0.5, config=JCfg(block_sites=128, kernel_variant="mxu"))
    pd = _port_of(dna, 4, "mxu")
    vals = {}
    for backend in ("kernel", "torch", "tree"):
        fn, t0 = TO.tree_loglik_fn(pd, backend=backend)
        assert fn.engine == backend
        assert fn.variant == ("vpu" if backend == "kernel" else "mxu")
        with torch.no_grad():
            vals[backend] = float(fn(t0))
    assert vals["kernel"] == pytest.approx(vals["torch"], rel=1e-6)
    assert vals["tree"] == pytest.approx(vals["torch"], rel=1e-6)


def test_chunk_and_block_rules_at_protein_and_codon_rows():
    """The checkpoint rule at rows 80 (S = 20) and 244 (S = 61): E * (rows
    * 4 + 1) bytes per site, one chunk when it fits, whole 128-site tiles
    otherwise; and the block rule (one wave of resident blocks, partial rows
    capped) for the site tiles a library's plan gives (32 at S = 20, 8 at
    S = 61) and for 16; at the protein shape 8-site tiles, the old width,
    still count as before: 656 blocks of 25 tiles.  The tile and where the accumulators live
    are the kernel library's choice, held by the on-card tests."""
    assert TG.tree_bwd_scratch_bytes(63, 80, 1) == 63 * 321
    assert TG.tree_bwd_scratch_bytes(31, 244, 1) == 31 * 977
    assert TG.tree_bwd_chunk_sites(1 << 17, 63, 80, 4 << 30) == 1 << 17
    assert TG.tree_bwd_scratch_bytes(63, 80, 1 << 17) == 2_650_669_056
    assert TG.tree_bwd_scratch_bytes(31, 244, 1 << 16) == 1_984_888_832
    for E, rows in ((63, 80), (31, 244)):
        chunk = TG.tree_bwd_chunk_sites(1 << 17, E, rows, 1 << 29)
        assert chunk % 128 == 0 and chunk < 1 << 17
        assert TG.tree_bwd_scratch_bytes(E, rows, chunk) <= 1 << 29
        assert TG.tree_bwd_scratch_bytes(E, rows, chunk + 128) > 1 << 29
    cols = 2 * 31 * 244 * 61 + 244 * 61 + 244
    for resident in (4 * 132, 8 * 132):          # one wave, partials capped
        for ts in (8, 16, 32):
            n_blocks, per = TG.tree_bwd_mxu_blocks(1 << 16, cols, resident,
                                                   ts)
            assert n_blocks <= resident
            assert n_blocks * cols * 4 <= TG.TREE_BWD_MXU_PARTIAL_BYTES
            assert n_blocks * per * ts >= 1 << 16
            assert (n_blocks - 1) * per * ts < 1 << 16
    assert TG.tree_bwd_mxu_blocks(1 << 17, 203_280, 5 * 132, 8) == (656, 25)
    assert TG.tree_bwd_mxu_blocks(1 << 17, 203_280, 2 * 132, 32) == (256, 16)
    assert TG.tree_bwd_mxu_blocks(1024, 100, 1024, 8) == (128, 1)
    assert TG.tree_bwd_mxu_blocks(1024, 100, 1024, 32) == (32, 1)


def test_tree_bwd_mxu_wrapper_dispatch_and_checks():
    pm, pt, glik = _case("s61", "mxu")
    sched = TT.reorder_schedule(pt.schedule, pt.tree.n_leaves)
    bsched, _ = _bsched(sched, pt.tree.n_leaves)
    args = [pt.codes, bsched, pt.lcs, pt.rcs, pt.ec, pt.fused_tip_table,
            pt.root_rows[0], torch.as_tensor(glik)]
    kw = dict(states=61, categories=2)
    before = TG.plf_tree_bwd_mxu.launches
    TG.plf_tree_bwd_mxu(*args, pt.n_sites, variant="mxu", **kw)
    assert TG.plf_tree_bwd_mxu.launches == before     # CPU: plain version
    with pytest.raises(ValueError, match="no kernel for device"):
        TG.plf_tree_bwd_mxu(*(a.to("meta") for a in args), pt.n_sites,
                            variant="mxu", **kw)
    with pytest.raises(ValueError, match="variant"):
        TG.plf_tree_bwd_mxu(*args, pt.n_sites, variant="tf32", **kw)
    with pytest.raises(ValueError, match="bsched"):
        TG.plf_tree_bwd_mxu(*args[:1], bsched[:2], *args[2:], pt.n_sites,
                            **kw)
    with pytest.raises(ValueError, match="glik"):
        TG.plf_tree_bwd_mxu(*args[:-1], args[-1][:, :64], pt.n_sites, **kw)


def test_auto_takes_kernel_where_measured_faster(monkeypatch):
    """On the card "auto" takes "kernel" (kernels 1m + 3m per node) for a
    "vpu" model at S != 4 from the nodes and nodes x padded sites at which
    it was measured faster than "tree" (optimize.KERNEL_MIN_NODES and
    KERNEL_MIN_NODE_SITES: 255 nodes and 255 x 131,072 at S = 20, 15
    and 31 x 16,384 at S = 61, C = 4), while its per-node residuals, 3 * E *
    S*C * n_pad * 4 bytes, fit half the free memory; below that size, at
    an unmeasured (S, C), past the memory and for every MXU variant the
    rule stays "tree"."""
    from types import SimpleNamespace
    pt = _port_of(_jax_protein("vpu"), 20, "vpu")

    def stand(S, C, E, n_pad):
        return SimpleNamespace(
            device=torch.device("cuda"), schedule=[None] * E, n_pad=n_pad,
            config=SimpleNamespace(states=S, categories=C, rows=S * C),
            can_fuse=lambda: True, can_segment=lambda: False)

    big = 1 << 40
    for S, C, E, n_pad, want in (
            (20, 4, 63, 131_072, False), (20, 4, 255, 65_536, False),
            (20, 4, 255, 16_384, False), (20, 4, 63, 65_536, False),
            (20, 4, 15, 131_072, False), (61, 4, 31, 4_096, False),
            (61, 4, 15, 16_384, False), (61, 4, 15, 4_096, False),
            (20, 1, 255, 131_072, False), (2, 4, 255, 131_072, False),
            (20, 4, 255, 131_072, True), (20, 4, 63, 1 << 20, False),
            (61, 4, 31, 16_384, True), (61, 4, 127, 4_096, True),
            (61, 4, 15, 65_536, True), (61, 4, 31, 65_536, True),
            (61, 4, 127, 2_048, False), (61, 4, 7, 131_072, False)):
        assert TO._kernel_wins(stand(S, C, E, n_pad), free=big) is want
    card = stand(20, 4, 63, 131_072)
    resid = 3 * 63 * 80 * 131_072 * 4
    assert not TO._kernel_wins(card, free=2 * resid)
    assert not TO._kernel_wins(card, free=2 * resid - 2)
    for free, vpu, want in ((2 * resid, True, "tree"),
                            (2 * resid - 2, True, "tree"),
                            (2 * resid, False, "tree")):
        monkeypatch.setattr(TO, "_free_bytes", lambda dev, f=free: f)
        assert TO._auto_backend(card, True, vpu) == want
    card = stand(20, 4, 255, 131_072)          # the smallest winner
    resid = 3 * 255 * 80 * 131_072 * 4
    assert TO._kernel_wins(card, free=2 * resid)
    assert not TO._kernel_wins(card, free=2 * resid - 2)
    for free, vpu, want in ((2 * resid, True, "kernel"),
                            (2 * resid - 2, True, "tree"),
                            (2 * resid, False, "tree")):
        monkeypatch.setattr(TO, "_free_bytes", lambda dev, f=free: f)
        assert TO._auto_backend(card, True, vpu) == want
    fn, _ = TO.tree_loglik_fn(pt)              # off the card: "torch"
    assert (fn.engine, fn.variant) == ("torch", "vpu")
