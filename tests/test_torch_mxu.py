"""The port's matrix ("MXU") forms and protein serving path against the JAX
package: block-matrix layouts, the empirical protein models and
``encode_protein``, kernel 1m's plain version against
``plf_pallas_lane_major`` (interpret mode) in every variant at S = 20 and
at the kernel's edge shapes (S = 13 and 61, a site past a tile, odd row
lengths), models of the job shape (kernels 1m, 2m, 7m) and of kernel 1m's
grid of one block per tile, the
protein ``PhyloModel`` fused and per-node against JAX's, the tip-rounding
asymmetry of the two paths, the training guards, and the "cuda" default
device of the entry points.

Tolerances are the JAX package's (``tests/test_ops.py:250-301``), except
where stated: JAX's "mxu_bf16" runs as fp32 in interpret mode
(``Precision.DEFAULT`` on the CPU), so the port's plain "mxu_bf16" is held
to a numpy emulation of one bf16 pass and to JAX only at 2e-2.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.io import alignment as JA  # noqa: E402
from plf_tpu.models import PhyloModel as JPM  # noqa: E402
from plf_tpu.models import random_tree as jrt  # noqa: E402
from plf_tpu.models import substitution as JS  # noqa: E402
from plf_tpu.ops import layout as JL  # noqa: E402
from plf_tpu.ops.plf_pallas import _bf16_split as j_bf16_split  # noqa: E402
from plf_tpu.ops.plf_pallas import make_mxu_dots as j_make_mxu_dots  # noqa: E402
from plf_tpu.ops.plf_pallas import plf_pallas_lane_major  # noqa: E402
from plf_tpu.ops.plf_tree_pallas import _expand_tip  # noqa: E402
from plf_tpu.reference import plf_reference  # noqa: E402
from plf_tpu_torch import PLFEngine, convert  # noqa: E402
from plf_tpu_torch.config import PLFConfig  # noqa: E402
from plf_tpu_torch.io import alignment as TA  # noqa: E402
from plf_tpu_torch.models import PhyloModel, tree_loglik_fn  # noqa: E402
from plf_tpu_torch.models import random_tree as trt  # noqa: E402
from plf_tpu_torch.models import substitution as TS  # noqa: E402
from plf_tpu_torch.models import phylo as TP  # noqa: E402
from plf_tpu_torch.ops import layout as L  # noqa: E402
from plf_tpu_torch.ops import plf_mxu as M  # noqa: E402
from plf_tpu_torch.ops.plf_node import plf_node  # noqa: E402
from plf_tpu_torch.ops.plf_tree_seg import plf_tree_seg  # noqa: E402
from tests.conftest import make_random_case  # noqa: E402
from test_torch_tree_grad_mxu import tpu_bf16_pass  # noqa: E402,F401

S = 20
BLOCK = 128
VARIANTS = ("mxu", "mxu_3x", "mxu_bf16")


# ------------------------------------------------------------------ layout --

@pytest.mark.parametrize("states,C", [(20, 4), (20, 5), (4, 4)])
def test_block_matrices_equal_jax_and_hold_the_lane_constants(states, C):
    rng = np.random.default_rng(states * 10 + C)
    branch = rng.standard_normal((C, states, states)).astype(np.float32)
    ev = rng.standard_normal((states, states)).astype(np.float32)
    for mine, theirs, arg in (
            (L.branch_to_block_matrix, JL.branch_to_block_matrix, branch),
            (L.ev_to_block_matrix, JL.ev_to_block_matrix, ev)):
        m = mine(arg, states, C)
        np.testing.assert_array_equal(m, np.asarray(theirs(arg, states, C)))
        t = mine(torch.as_tensor(arg), states, C)
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), m)
    # the lane constants are exactly the non-zero (diagonal-block) entries
    rows = np.arange(states * C)
    c = rows % C
    mb = L.branch_to_block_matrix(branch, states, C)
    lc = L.branch_to_lane_constants(branch, states, C)
    me = L.ev_to_block_matrix(ev, states, C)
    ec = L.ev_to_lane_constants(ev, states, C)
    for q in range(states):
        np.testing.assert_array_equal(mb[rows, q * C + c], lc[:, q])
        np.testing.assert_array_equal(me[rows, q * C + c], ec[:, q])
    assert np.count_nonzero(mb) == np.count_nonzero(lc)
    assert np.count_nonzero(me) == np.count_nonzero(ec)


# ----------------------------------------------------- protein models, io --

@pytest.mark.parametrize("name", JS.BUILTIN_PROTEIN_MODELS)
def test_protein_models_equal_jax(name):
    assert TS.BUILTIN_PROTEIN_MODELS == JS.BUILTIN_PROTEIN_MODELS
    assert TS.AMINO_ACIDS == JS.AMINO_ACIDS
    with open(f"plf_tpu_torch/models/data/{name}.dat") as f:
        text = f.read()
    with open(f"plf_tpu/models/data/{name}.dat") as f:
        assert f.read() == text                     # the port's own copy
    for a, b in zip(TS.parse_paml_matrix(text), JS.parse_paml_matrix(text)):
        np.testing.assert_array_equal(a, b)
    mine, theirs = TS.empirical_protein(name), JS.empirical_protein(name)
    for field in ("pi", "eigenvalues", "u", "w"):
        np.testing.assert_array_equal(getattr(mine, field),
                                      getattr(theirs, field))
    pi = np.full(20, 0.05)
    np.testing.assert_array_equal(TS.empirical_protein(text, pi=pi).u,
                                  JS.empirical_protein(text, pi=pi).u)
    with pytest.raises(ValueError):
        TS.parse_paml_matrix("1 2 3")


def test_encode_protein_equals_jax():
    seqs = ["ARNDCQEGHILKMFPSTWYV", "bzjx-?.*arndcqeghil", "MKV" * 6 + "BZ"]
    seqs = [s.ljust(20, "-")[:20] for s in seqs]
    got = TA.encode_protein(seqs)
    np.testing.assert_array_equal(got, JA.encode_protein(seqs))
    assert got.dtype == np.int8 and got[0].tolist() == list(range(20))


# -------------------------------------------------------------- node level --

def _lane(x, C, n_pad):
    return L.pad_to_multiple(L.to_lane_major(x, S, C), n_pad)


def _jax_node(case, C, variant):
    """JAX's plf_pallas_lane_major in interpret mode: block matrices for
    the MXU variants, lane constants for "vpu"."""
    x1, x2, left, right, ev, _ = case
    n = len(x1)
    mxu = variant.startswith("mxu")
    br = JL.branch_to_block_matrix if mxu else JL.branch_to_lane_constants
    e = JL.ev_to_block_matrix if mxu else JL.ev_to_lane_constants
    x3, sc = plf_pallas_lane_major(
        _lane(x1, C, BLOCK), _lane(x2, C, BLOCK), br(left, S, C),
        br(right, S, C), e(ev, S, C), n, states=S, categories=C,
        block_sites=BLOCK, interpret=True, variant=variant)
    return np.asarray(x3), np.asarray(sc)


def _port_node(case, C, variant):
    x1, x2, left, right, ev, _ = case
    t = lambda a: torch.as_tensor(a)
    x3, sc = plf_node(t(_lane(x1, C, BLOCK)), t(_lane(x2, C, BLOCK)),
                      t(L.branch_to_lane_constants(left, S, C)),
                      t(L.branch_to_lane_constants(right, S, C)),
                      t(L.ev_to_lane_constants(ev, S, C)), len(x1),
                      states=S, categories=C, variant=variant)
    return x3.numpy(), sc.numpy()


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _bf16_emulation(case, C):
    """One bf16 pass per stage in numpy: operands rounded to bf16, sums in
    float64, each stage's result rounded to fp32 where the kernel holds it
    (so the bf16 rounding of the products sees the same fp32 value)."""
    x1, x2, left, right, ev, _ = case
    n = len(x1)

    def st(x, k):                       # x (rows, n), k (rows, S) lane consts
        xb, kb = _bf16(x).astype(np.float64), _bf16(k).astype(np.float64)
        out = np.zeros_like(xb)
        for q in range(S):
            out += np.tile(xb[q * C:(q + 1) * C], (S, 1)) * kb[:, q:q + 1]
        return out.astype(np.float32)

    a, b = (L.to_lane_major(x, S, C) for x in (x1, x2))
    p = (st(a, L.branch_to_lane_constants(left, S, C))
         * st(b, L.branch_to_lane_constants(right, S, C)))
    x3 = st(p, L.ev_to_lane_constants(ev, S, C))
    flag = (np.abs(x3) < np.float32(2.0 ** -32)).all(axis=0)
    x3 = np.where(flag, x3 * np.float32(2.0 ** 32), x3)
    return x3, flag.astype(np.int32)[None, :n]


def _node_case(C, seed, n=200):
    """make_random_case at S = 20, its forced-underflow sites scaled by a
    further 1e-4: at 20 states the sums grow enough that 1e-12 alone no
    longer reaches the 2^-32 rescale threshold."""
    case = list(make_random_case(np.random.default_rng(seed), n, states=S,
                                 categories=C))
    x1 = case[0].reshape(-1).copy()
    j = np.arange(x1.size)
    x1 = np.where(j % (4 * S * C) < S * C, x1 * np.float32(1e-4), x1)
    case[0] = x1.reshape(n, C, S)
    return tuple(case)


@pytest.mark.parametrize("C", [4, 5])
@pytest.mark.parametrize("variant", VARIANTS)
def test_node_plain_matches_jax(variant, C):
    case = _node_case(C, 20 + C)
    n = len(case[0])
    got, got_sc = _port_node(case, C, variant)
    ref, ref_sc = _jax_node(case, C, variant)
    np.testing.assert_array_equal(got_sc, ref_sc)          # flags, every case
    assert got_sc[0, :n].sum() > 0 and not got_sc[0, n:].any()
    golden, sv, _ = plf_reference(*case, states=S, categories=C)
    if variant == "mxu":
        np.testing.assert_allclose(got, ref, rtol=5e-7, atol=1e-37)
        np.testing.assert_array_equal(L.from_lane_major(got, S, C, n=n),
                                      golden)
    elif variant == "mxu_3x":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-37)
        vpu, _ = _jax_node(case, C, "vpu")
        np.testing.assert_allclose(got, vpu, rtol=1e-4, atol=1e-4)
    else:
        # Tight where both round the stage-2 products to the same bf16
        # value; where the fp32 sums (the port's S-term order, the
        # emulation's fp64) straddle a bf16 rounding boundary, one product
        # moves by 2^-8 of itself and its term by ~1/S of that.
        emu, emu_sc = _bf16_emulation(case, C)
        rel = np.abs(got[:, :n] - emu) / np.abs(emu)
        assert np.mean(rel <= 1e-5) >= 0.99 and rel.max() <= 1e-3
        np.testing.assert_array_equal(got_sc[:, :n], emu_sc)
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=1e-4)
    np.testing.assert_array_equal(got_sc[0, :n], sv)


#: Edge shapes of kernel 1m for its plain version: (S, C, n, n_pad): n one
#: site past a 32-site tile, and an odd n_pad (JAX's copy is padded to its
#: 128-site block).
NODE_EDGES = [(13, 3, 33, 35), (61, 4, 33, 37), (20, 4, 33, 35),
              (13, 3, 97, 99)]


def _edge_case(S, C, n, seed):
    """Random positive inputs, every 4th site of x1 scaled by 1e-16 so that
    they rescale at S = 13 to 61."""
    rng = np.random.default_rng(seed)
    left = rng.random((C, S, S), dtype=np.float32)
    right = rng.random((C, S, S), dtype=np.float32)
    ev = rng.random((S, S), dtype=np.float32)
    x1 = rng.random((n, C, S), dtype=np.float32)
    x2 = rng.random((n, C, S), dtype=np.float32)
    x1[0::4] *= np.float32(1e-16)
    return x1, x2, left, right, ev


def _rescaled(x3, sc, n):
    """x3 with its rescales counted in (float64): continuous where a flag
    flips between two arithmetics."""
    x3 = np.asarray(x3, np.float64)[:, :n]
    return x3 * np.exp2(-32.0 * np.asarray(sc, np.float64)[0, :n])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("S,C,n,n_pad", NODE_EDGES)
def test_node_plain_edges_match_jax(variant, S, C, n, n_pad, request):
    """Kernel 1m's plain version at the kernel's edge shapes
    (S = 13 with C = 3, S = 61, n one site past a tile, an odd n_pad)
    against plf_pallas_lane_major (interpret mode) in every variant.

    "mxu": x3 and the flags equal the golden model bit for bit, and JAX's
    x3 (rescales counted in) within S * 2^-23 relative, the bound of a sum
    of S positive fp32 terms taken in another order (XLA:CPU's blocked,
    FMA-contracted dots).  "mxu_3x" and "mxu_bf16" (JAX's one-pass dots as
    the TPU runs them): within the variant's class on this input, twice the
    largest distance of JAX's result from the port's "mxu" one, measured
    here, never closer than the "mxu" bar; both relative to the "mxu"
    result with the rescales counted in."""
    if variant == "mxu_bf16":
        request.getfixturevalue("tpu_bf16_pass")
    x1, x2, left, right, ev = _edge_case(S, C, n, 40 + S + n)
    t = torch.as_tensor
    lc = [t(L.branch_to_lane_constants(m, S, C)) for m in (left, right)]
    ec = t(L.ev_to_lane_constants(ev, S, C))
    pad = lambda x, w: np.pad(L.to_lane_major(x, S, C), ((0, 0), (0, w - n)))

    def port(v):
        x3, sc = plf_node(t(pad(x1, n_pad)), t(pad(x2, n_pad)), *lc, ec, n,
                          states=S, categories=C, variant=v)
        assert x3.shape == (S * C, n_pad) and not sc[0, n:].any()
        return x3.numpy(), sc.numpy()

    got, got_sc = port(variant)
    assert got_sc.sum() > 0
    f32 = _rescaled(*port("mxu"), n)
    x3j, scj = plf_pallas_lane_major(
        pad(x1, BLOCK), pad(x2, BLOCK), JL.branch_to_block_matrix(left, S, C),
        JL.branch_to_block_matrix(right, S, C), JL.ev_to_block_matrix(ev, S, C),
        n, states=S, categories=C, block_sites=BLOCK, interpret=True,
        variant=variant)
    want = _rescaled(x3j, scj, n)
    bar = S * 2.0 ** -23
    if variant == "mxu":
        golden, sv, _ = plf_reference(x1, x2, left, right, ev, states=S,
                                      categories=C)
        np.testing.assert_array_equal(L.from_lane_major(got, S, C, n=n),
                                      golden)
        np.testing.assert_array_equal(got_sc[0, :n], sv)
    else:
        bar = max(bar, 2 * np.max(np.abs(want - f32) / np.abs(f32)))
    assert np.max(np.abs(_rescaled(got, got_sc, n) - want)
                  / np.abs(f32)) <= bar


def test_dense_dots_match_jax():
    """The dense forms kept for exchange with the JAX package's block
    matrices, and kernel 1m's stage form, agree with JAX's dots."""
    rng = np.random.default_rng(3)
    C = 4
    m = L.branch_to_block_matrix(
        rng.random((C, S, S), dtype=np.float32), S, C)
    x = rng.random((S * C, 64), dtype=np.float32)
    for variant in ("mxu", "mxu_3x"):
        dot, dot_t = M.make_mxu_dots(variant)
        jdot, jdot_t = j_make_mxu_dots(variant)
        got = dot(torch.as_tensor(m), torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jdot(m, x)), rtol=1e-6)
        got_t = dot_t(torch.as_tensor(x), torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got_t, np.asarray(jdot_t(x, x)),
                                   rtol=1e-6)
        lc = torch.as_tensor(np.ascontiguousarray(
            m.reshape(S, C, S, C)[:, np.arange(C), :, np.arange(C)]
            .transpose(1, 0, 2).reshape(S * C, S)))
        stage = M.mxu_stage(torch.as_tensor(x), M.operator_planes(lc,
                                                                  variant),
                            variant, S, C).numpy()
        np.testing.assert_allclose(stage, got, rtol=1e-6)
    hi, lo = M.bf16_split(torch.as_tensor(x))
    jhi, jlo = j_bf16_split(jnp.asarray(x))
    np.testing.assert_array_equal(hi.float().numpy(),
                                  np.asarray(jhi.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.float().numpy(),
                                  np.asarray(jlo.astype(jnp.float32)))


# -------------------------------------------------------------- tree level --

def _tips(n_leaves, n_sites, seed):
    tips = np.random.default_rng(seed).integers(-1, 23,
                                                size=(n_leaves, n_sites))
    tips[:, 4] = -1                                     # a gap column
    return tips


def _jax_protein(variant, n_leaves=5, n_sites=200, seed=9):
    return JPM(jrt(n_leaves, seed=seed), JS.empirical_protein("lg"),
               _tips(n_leaves, n_sites, seed), alpha=0.5,
               config=JCfg(states=S, block_sites=BLOCK, interpret=True,
                           kernel_variant=variant))


def _port_of(pm, variant, device="cpu"):
    return convert.phylo_model(
        pi=pm.model.pi, eigenvalues=pm.model.eigenvalues, u=pm.model.u,
        w=pm.model.w, nodes=[(n.index, n.name, n.length, n.children)
                             for n in pm.tree.nodes], root=pm.tree.root,
        rates=pm.rates, tip_states=pm.tip_states, wgt=pm.wgt,
        config=PLFConfig(states=S, block_sites=BLOCK,
                         kernel_variant=variant), device=device)


@pytest.mark.parametrize("method", ["fused", "per-node"])
@pytest.mark.parametrize("variant", ["mxu", "mxu_3x"])
def test_protein_phylo_matches_jax(variant, method):
    """Scaler counts equal.  mxu: site likelihoods within 5e-5 relative
    (site log-likelihoods within 5e-5 absolute; the FMA drift of the JAX
    tree kernels on the CPU).  mxu_3x: within the variant's own error class
    on this input, i.e. the largest distance of JAX's mxu_3x from JAX's
    mxu over the sites (1.9e-3 here), and 1e-4 at the median site.  A
    per-site 1e-4 bar does not hold: the bf16 hi/lo split is a step
    function, so the fp32 rounding differences of two summation orders
    (JAX's dense product, the port's S-term sums) move a split operand by
    up to 2^-17 of itself, and the root sum's cancellation amplifies that
    (8.3e-4 at 3 of 200 sites).  Totals within 1e-5 relative of each
    other and of the float64 brute force."""
    pm = _jax_protein(variant)
    ref = pm.log_likelihood(method=method)
    out = _port_of(pm, variant).log_likelihood(method=method)
    assert out.scaler_total == ref.scaler_total > 0
    np.testing.assert_array_equal(out.scaler_sites, ref.scaler_sites)
    err = np.abs(out.site_log_likelihood - ref.site_log_likelihood)
    if variant == "mxu":
        assert err.max() <= 5e-5
    else:
        fp32 = _jax_protein("mxu").log_likelihood(method=method)
        bar = np.abs(ref.site_log_likelihood
                     - fp32.site_log_likelihood).max()
        assert err.max() <= bar and np.median(err) <= 1e-4
    assert abs(out.log_likelihood - ref.log_likelihood) \
        < 1e-5 * abs(ref.log_likelihood)
    bf = pm.log_likelihood_bruteforce()
    assert abs(out.log_likelihood - bf) / abs(bf) < 1e-5


def test_protein_default_is_mxu_3x_and_paths_agree():
    """The default config resolves to mxu_3x for S = 20 (as in JAX), the
    fused path fuses, and fused and per-node agree (bit for bit here: the
    stage-1 split of a rounded tip, fl(hi + lo), gives back hi and lo)."""
    tips = _tips(6, 256, 2)
    pt = PhyloModel(trt(6, seed=2), TS.empirical_protein("lg"), tips,
                    alpha=0.5, device="cpu")
    assert pt.config.resolved_kernel_variant == "mxu_3x" and pt.can_fuse()
    fused = pt.log_likelihood()
    pernode = pt.log_likelihood(method="per-node")
    assert fused.scaler_total == pernode.scaler_total
    np.testing.assert_allclose(fused.site_log_likelihood,
                               pernode.site_log_likelihood, rtol=1e-6)


@pytest.mark.parametrize("variant", VARIANTS + ("vpu",))
def test_tip_rounding_asymmetry(variant, monkeypatch):
    """The fused path expands tips from the table as the variant's tip
    product rounds it (JAX ``_expand_tip(dot=)``), the per-node path
    exactly (JAX's HIGHEST expansion)."""
    pm = _jax_protein(variant)
    pt = _port_of(pm, variant)
    ttab, fused = pt.tip_table.numpy(), pt.fused_tip_table.numpy()
    np.testing.assert_array_equal(ttab, np.asarray(pm._kernel_tip_table()))
    if variant == "mxu_3x":
        dot = j_make_mxu_dots(variant)[0]
        ncols = ttab.shape[1]
        want = np.asarray(_expand_tip(jnp.arange(ncols, dtype=jnp.int32)
                                      [None, :], jnp.asarray(ttab), dot=dot))
        np.testing.assert_array_equal(fused, want)
        assert not np.array_equal(fused, ttab)
    elif variant == "mxu_bf16":
        np.testing.assert_array_equal(fused, _bf16(ttab))
    else:
        assert pt.fused_tip_table is pt.tip_table
    seen = {}
    real_tree, real_node = TP.plf_tree, TP.plf_node

    def tree_spy(*a, **k):
        seen["ttab"] = a[5]
        return real_tree(*a, **k)

    def node_spy(x1, *a, **k):
        seen.setdefault("tips", []).append(x1)
        return real_node(x1, *a, **k)

    monkeypatch.setattr(TP, "plf_tree", tree_spy)
    monkeypatch.setattr(TP, "plf_node", node_spy)
    pt.log_likelihood(method="fused")
    assert seen["ttab"] is pt.fused_tip_table
    pt.log_likelihood(method="per-node")
    leaf = pt.schedule[0][1]
    if leaf < pt.tree.n_leaves:
        np.testing.assert_array_equal(
            seen["tips"][0].numpy(), ttab[:, pt.codes[leaf].long().numpy()])


@pytest.mark.parametrize("S,C,threads,rows,rounds", [
    (20, 4, 160, 4, 1), (20, 5, 200, 4, 1), (61, 4, 416, 5, 1),
    (13, 3, 72, 5, 1), (4, 4, 32, 4, 1), (61, 5, 264, 5, 2),
    (52, 5, 264, 4, 2), (61, 8, 416, 5, 2), (20, 1, 40, 4, 1)])
def test_kernel2m_job_slots_take_every_job_once(S, C, threads, rows, rounds):
    """Kernel 2m's block (``threads`` and ``rows`` per job, as its library
    reports them through tree_mxu_block; test_torch_cuda.py holds the
    library to these values on the card) has one job slot of 8 threads
    per job of a stage, in the fewest rounds of at most 64 slots.  Walking
    node_tile's loop as the card does (thread t: site t % 8, jobs t // 8,
    t // 8 + slots, ...) takes every (site, category, block of ``rows``
    output rows) exactly once, in ``rounds`` rounds, every round full but
    the last, which lacks fewer jobs than there are rounds."""
    TS = 8
    assert threads % TS == 0 and threads <= 512
    slots, blocks = threads // TS, -(-S // rows)
    jobs = C * blocks
    taken, most = {}, 0
    for t in range(threads):
        s, n_jobs = t % TS, 0
        for j in range(t // TS, jobs, slots):
            key = (s, j % C, (j // C) * rows)
            taken[key] = taken.get(key, 0) + 1
            n_jobs += 1
        most = max(most, n_jobs)
    want = {(s, c, rows * b) for s in range(TS) for c in range(C)
            for b in range(blocks)}
    assert set(taken) == want and set(taken.values()) == {1}
    assert most == rounds == -(-jobs // 64)
    assert 0 <= rounds * slots - jobs < rounds


def _block_threads(S, C, rows, ts):
    """csrc/plf_mxu.cuh's block_threads: one job slot of ``ts`` threads
    per job of a stage, in the fewest rounds of at most 512 / ``ts``
    slots, every round full but the last."""
    jobs = C * -(-S // rows)
    rounds = -(-jobs // (512 // ts))
    return ts * -(-jobs // rounds)


@pytest.mark.parametrize("kernel,S,C,TS,threads,rows,rounds", [
    ("7m", 4, 4, 8, 32, 4, 1), ("7m", 20, 4, 8, 160, 4, 1),
    ("7m", 61, 4, 8, 416, 5, 1), ("7m", 4, 1, 8, 8, 4, 1),
    ("1m", 20, 4, 32, 320, 4, 2), ("1m", 20, 5, 32, 416, 4, 2),
    ("1m", 61, 4, 32, 416, 5, 4), ("1m", 13, 3, 32, 288, 5, 1),
    ("1m", 4, 4, 32, 128, 4, 1)])
def test_job_shape_takes_every_job_once(kernel, S, C, TS, threads, rows,
                                        rounds):
    """Kernels 7m and 1m take kernel 2m's job shape (one rule,
    csrc/plf_mxu.cuh's block_threads and job_rows: 5-row jobs where S % 4
    != 0), 7m on 8-site tiles and 1m on its plan's tile (test_torch_cuda.py
    holds the libraries to these values on the card).  Walking node_tile's
    loop as the card does (thread t: site t % TS, jobs t // TS, t // TS +
    slots, ...) takes every (site, category, block of ``rows`` output rows)
    exactly once, in ``rounds`` rounds, every round full but the last,
    which lacks fewer jobs than there are rounds."""
    assert rows == (4 if S % 4 == 0 else 5)
    assert threads == _block_threads(S, C, rows, TS) <= 512
    slots, blocks = threads // TS, -(-S // rows)
    jobs = C * blocks
    taken, most = {}, 0
    for t in range(threads):
        s, n_jobs = t % TS, 0
        for j in range(t // TS, jobs, slots):
            key = (s, j % C, (j // C) * rows)
            taken[key] = taken.get(key, 0) + 1
            n_jobs += 1
        most = max(most, n_jobs)
    want = {(s, c, rows * b) for s in range(TS) for c in range(C)
            for b in range(blocks)}
    assert set(taken) == want and set(taken.values()) == {1}
    assert most == rounds == -(-jobs // (512 // TS))
    assert 0 <= rounds * slots - jobs < rounds


@pytest.mark.parametrize("S,C,n_pad", [
    (20, 4, 17), (20, 4, 128), (20, 4, 2000), (20, 4, 4001), (61, 4, 20),
    (61, 4, 701), (13, 3, 99), (13, 3, 300)])
def test_kernel1m_grid_takes_every_site_once(S, C, n_pad):
    """A model of kernel 1m's grid (csrc/plf_node_mxu.cu): one block per
    32-site tile, its threads (the job shape's) striding over the tile's
    rows x sites.  Each (row, site) below n_pad is read from both children
    and written to the parent exactly once, by one block, and each site's
    flag once; sites past n_pad are zero-filled and never read or written.
    A block writes only what it read itself, after its barrier, so in place
    over x1 or x2 no block reads a site that another has written."""
    ts, rows = 32, S * C
    threads = _block_threads(S, C, 4 if S % 4 == 0 else 5, ts)
    tile = rows * ts
    reads, writes, flags = {}, {}, {}
    for block in range(-(-n_pad // ts)):
        site0, own = block * ts, set()
        for tid in range(threads):
            for i in range(tid, tile, threads):
                site = site0 + i % ts
                if site < n_pad:   # else the tile's entry is zero-filled
                    key = (i // ts, site)
                    reads[key] = reads.get(key, 0) + 1
                    own.add(key)
        for tid in range(threads):   # after the barrier and node_tile
            for i in range(tid, tile, threads):
                key = (i // ts, site0 + i % ts)
                if key[1] < n_pad:
                    assert key in own
                    writes[key] = writes.get(key, 0) + 1
            if tid < ts and site0 + tid < n_pad:
                flags[site0 + tid] = flags.get(site0 + tid, 0) + 1
    want = {(r, s): 1 for r in range(rows) for s in range(n_pad)}
    assert reads == want and writes == want
    assert flags == {s: 1 for s in range(n_pad)}


def test_kernel2m_capacity_rule(monkeypatch):
    """Kernel 2m's rule: an arena of n_slots 8-site tiles plus three work
    tiles fits one block's shared memory; past it the model takes the
    segmented path (kernel 7m, as the JAX package takes its segmented
    engine), and the per-node path where that does not apply either."""
    from plf_tpu_torch.ops import plf_tree as TT
    assert TT.TREE_MXU_SITES == 8
    assert TT.tree_mxu_fits(4, 80, 24) and TT.tree_mxu_fits(84, 80, 24)
    assert not TT.tree_mxu_fits(85, 80, 24)
    assert TT.tree_mxu_smem_bytes(84, 80, 24) <= TT.SMEM_BLOCK_BYTES \
        < TT.tree_mxu_smem_bytes(85, 80, 24)
    assert M.uses_mxu_kernels("vpu", 20) and M.uses_mxu_kernels("mxu", 4)
    assert not M.uses_mxu_kernels("vpu", 4)
    pt = _port_of(_jax_protein("mxu_3x"), "mxu_3x")
    assert pt.can_fuse()
    calls, seg_calls = [], []
    monkeypatch.setattr(TP, "tree_mxu_fits", lambda *a: False)
    monkeypatch.setattr(TP, "plf_node", lambda *a, **k: calls.append(1)
                        or plf_node(*a, **k))
    monkeypatch.setattr(TP, "plf_tree_seg", lambda *a, **k: seg_calls.append(
        1) or plf_tree_seg(*a, **k))
    assert not pt.can_fuse() and pt.can_segment()
    pt.log_likelihood()
    assert (len(seg_calls), len(calls)) == (1, 0)
    monkeypatch.setattr(TP.PhyloModel, "can_segment", lambda self: False)
    pt.log_likelihood()
    assert (len(seg_calls), len(calls)) == (1, len(pt.schedule))


@pytest.mark.parametrize("variant", VARIANTS)
def test_operator_planes_split_once(variant, monkeypatch):
    """A protein model splits its operators for the variant once, at
    construction; its fused and per-node paths then split nothing and give
    what the kernels' wrappers give when they split the operators
    themselves.  Planes of the wrong shape, or for kernels 1 and 2, are
    refused."""
    from plf_tpu_torch.ops import plf_tree as TT
    pt = _port_of(_jax_protein(variant, n_leaves=4, n_sites=128), variant)
    for name, k in (("lcs_planes", pt.lcs), ("rcs_planes", pt.rcs),
                    ("ec_planes", pt.ec)):
        assert torch.equal(getattr(pt, name),
                           torch.stack(M.operator_planes(k, variant)))
    args = (pt.codes, pt.sched, pt.lcs, pt.rcs, pt.ec, pt.fused_tip_table,
            pt.root_rows[0], pt.n_sites)
    kw = dict(n_slots=pt.n_slots, root_slot=pt.root_slot, states=S,
              categories=4, variant=variant)
    want = TT.plf_tree(*args, **kw)
    ref = pt.log_likelihood(method="per-node")

    def no_split(*a, **k):
        raise AssertionError("operators split again")

    monkeypatch.setattr(M, "operator_planes", no_split)
    got = TT.plf_tree(*args, **kw, planes=pt._planes())
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    pt.log_likelihood(method="fused")
    again = pt.log_likelihood(method="per-node")
    np.testing.assert_array_equal(again.site_log_likelihood,
                                  ref.site_log_likelihood)
    x = torch.ones(S * 4, BLOCK)
    bad = pt._planes(0)[:5] + (pt.ec_planes[0][:, :4],)
    with pytest.raises(ValueError, match="planes"):
        plf_node(x, x, pt.lcs[0], pt.rcs[0], pt.ec, BLOCK, states=S,
                 variant=variant, planes=bad)
    with pytest.raises(ValueError, match="planes"):
        plf_node(x[:16], x[:16], pt.lcs[0][:16, :4], pt.rcs[0][:16, :4],
                 pt.ec[:16, :4], BLOCK, states=4, variant="vpu",
                 planes=pt._planes(0))


# ---------------------------------------------------------------- guards --

@pytest.mark.parametrize("variant", VARIANTS + ("vpu",))
def test_training_guards(variant):
    """Models on the matrix-form kernels (the MXU variants, and "vpu" at
    S = 20) on the CPU: "auto" takes "torch"; "tree" runs kernels 2m + 4m
    and "segmented" kernels 7m + 8m (their plain versions here) in the
    model's arithmetic; "kernel" runs kernels 1m + 3m (their plain
    versions) in "vpu" arithmetic whatever the variant, as JAX's "pallas"
    path does, so its value is held to an "mxu" twin's log_likelihood()
    (fp32 in the golden order); mxu_bf16 raises ValueError everywhere, as
    in JAX.  Values within rel 1e-4 of log_likelihood()."""
    pt = _port_of(_jax_protein(variant, n_leaves=4, n_sites=128), variant)
    if variant == "mxu_bf16":
        for backend in ("torch", "kernel", "tree", "auto"):
            with pytest.raises(ValueError, match="mxu_bf16"):
                tree_loglik_fn(pt, backend=backend)
        return
    ll = pt.log_likelihood().log_likelihood
    twin = pt if variant == "mxu" else _port_of(
        _jax_protein("mxu", n_leaves=4, n_sites=128), "mxu")
    ll_mxu = twin.log_likelihood().log_likelihood
    for backend, engine, arith, want in (
            ("auto", "torch", variant, ll), ("torch", "torch", variant, ll),
            ("tree", "tree", variant, ll),
            ("segmented", "segmented", variant, ll),
            ("kernel", "kernel", "vpu", ll_mxu)):
        fn, t0 = tree_loglik_fn(pt, backend=backend)
        assert (fn.engine, fn.variant) == (engine, arith)
        t = torch.tensor(t0, requires_grad=True)
        v = fn(t)
        v.backward()
        assert torch.isfinite(t.grad).all()
        assert float(v.detach()) == pytest.approx(want, rel=1e-4)


def test_entry_points_default_to_the_card():
    """PhyloModel, PLFEngine and convert.phylo_model run on the card
    unless the caller asks for the CPU; without a card the default fails
    at construction (``devices.card_count``'s RuntimeError), never
    landing on the CPU."""
    for fn in (PhyloModel.__init__, PLFEngine.__init__,
               convert.phylo_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert PLFEngine().device.type == "cuda"
        pytest.skip("a CUDA device is present: the default would succeed")
    with pytest.raises(RuntimeError, match="no CUDA card is visible"):
        PLFEngine()
    pm = _jax_protein("mxu_3x", n_leaves=4, n_sites=128)
    with pytest.raises(RuntimeError, match="no CUDA card is visible"):
        PhyloModel(pm.tree, TS.empirical_protein("lg"), pm.tip_states,
                   alpha=0.5)


def test_convert_carries_a_protein_model():
    """By value: the eigensystem, rates and tips of a JAX protein model
    give the port's own protein model's operators and likelihood bit for
    bit."""
    pm = _jax_protein("mxu_3x", n_leaves=6, n_sites=150, seed=3)
    pt = _port_of(pm, "mxu_3x")
    own = PhyloModel(trt(6, seed=3), TS.empirical_protein("lg"),
                     pm.tip_states, alpha=0.5,
                     config=PLFConfig(states=S, block_sites=BLOCK,
                                      kernel_variant="auto"),
                     device="cpu")
    assert own.config.resolved_kernel_variant == "mxu_3x"
    for name in ("lcs", "rcs", "ec", "tip_table", "fused_tip_table",
                 "root_rows", "codes"):
        assert torch.equal(getattr(pt, name), getattr(own, name)), name
    # the JAX model's block operators hold the port's lane constants
    np.testing.assert_array_equal(
        np.stack([L.branch_to_block_matrix(
            np.ascontiguousarray(
                pt.lcs[e].numpy().reshape(S, 4, S).transpose(1, 0, 2)),
            S, 4) for e in range(len(pt.schedule))]), pm._lcs_np)
    assert pt.log_likelihood().log_likelihood == \
        own.log_likelihood().log_likelihood
