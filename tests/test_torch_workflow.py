"""The port's inference workflow against the JAX package's: the tree
serialisation, ``Alignment``, the small gaps (``PLFConfig.exact``,
``tip_clv``, ``true_site_log_likelihood``), distances and NJ, consensus
and bootstrap support, the checkpoint, NNI/SPR search, ``fit_model`` and
``run_inference``.  The same numpy-seeded inputs go through both; the
port runs on the CPU (its plain versions).  Tolerances are stated per
test."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import plf_tpu.models as J  # noqa: E402
from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.config import Backend as JBackend  # noqa: E402
from plf_tpu.io import alignment as JA  # noqa: E402
import plf_tpu_torch.models as T  # noqa: E402
from plf_tpu_torch.config import Backend, PLFConfig  # noqa: E402
from plf_tpu_torch.io import alignment as TA  # noqa: E402
from plf_tpu_torch.models import search as TSearch  # noqa: E402
from plf_tpu_torch.utils import checkpoint as TC  # noqa: E402
from test_torch_batch import _one_torch_thread  # noqa: E402,F401


NEWICKS = ["((a:0.1,b:0.2):0.05,(c:0.3,(d:0.1,e:0.4)x:0.2):0.1,f:0.7);",
           "((:0.1,:0.2):0.3,(c:1e-7,d:2.5):0.25);",
           "(((a,b),(c,d)),((e,f),(g,h)));"]


def _caterpillar(pkg, n):
    nwk = "t0:0.1"
    for i in range(1, n):
        nwk = f"({nwk},t{i}:0.1):0.1"
    return pkg.parse_newick(nwk + ";")


def _sim(n_taxa, n_sites, seed, mean_branch=0.2, **kw):
    """A tree of both packages (same numbering) and an alignment
    simulated under HKY85 by the JAX package's simulator."""
    tj = J.random_tree(n_taxa, seed=seed, mean_branch=mean_branch)
    tt = T.random_tree(n_taxa, seed=seed, mean_branch=mean_branch)
    tips = J.simulate_alignment(tj, J.hky85(2.0), n_sites, seed=seed, **kw)
    return tj, tt, tips


# ------------------------------------------------------- partial copies --

@pytest.mark.parametrize("src", NEWICKS + ["random"])
def test_tree_serialisation_equals_jax(src):
    if src == "random":
        tj, tt = J.random_tree(9, seed=4), T.random_tree(9, seed=4)
    else:
        tj, tt = J.parse_newick(src), T.parse_newick(src)
    assert tt.leaf_names() == tj.leaf_names()
    assert tt.levels() == tj.levels()
    for root_len in (False, True):
        assert tt.to_newick(root_len) == tj.to_newick(root_len)
    back = T.parse_newick(tt.to_newick())
    assert back.to_newick() == tt.to_newick()


def test_alignment_equals_jax():
    rng = np.random.default_rng(3)
    codes = rng.integers(-1, 5, size=(5, 40)).astype(np.int8)
    codes[:, 20:] = codes[:, :20]                   # duplicate patterns
    names = [f"s{i}" for i in range(5)]
    at, aj = TA.Alignment(names, codes), JA.Alignment(names, codes)
    assert (at.n_sequences, at.n_sites) == (aj.n_sequences, aj.n_sites)
    ct, cj = at.compressed(), aj.compressed()
    np.testing.assert_array_equal(ct.codes, cj.codes)
    np.testing.assert_array_equal(ct.weights, cj.weights)
    order = ["s3", "s0", "s4", "s1", "s2"]
    rt, rj = ct.reorder(order), cj.reorder(order)
    assert rt.names == rj.names == order
    np.testing.assert_array_equal(rt.codes, rj.codes)


def test_small_gaps_equal_jax():
    """``PLFConfig.exact``, ``SubstitutionModel.tip_clv`` (bit for bit)
    and ``TreeLikelihoodResult.true_site_log_likelihood`` (scaler counts
    folded in; within rtol 5e-5 of JAX's, the tree kernels' bar)."""
    for dtype, backend, jbackend in (("float32", Backend.KERNEL,
                                      JBackend.PALLAS),
                                     ("bfloat16", Backend.KERNEL,
                                      JBackend.PALLAS),
                                     ("float32", Backend.TORCH,
                                      JBackend.XLA),
                                     ("float32", Backend.REFERENCE,
                                      JBackend.REFERENCE)):
        assert PLFConfig(dtype=dtype, backend=backend).exact == \
            JCfg(dtype=dtype, backend=jbackend).exact
    idx = np.array([0, 3, -1, 7, 2, 4])
    for m in ("hky", "lg"):
        mt = T.hky85(2.0) if m == "hky" else T.empirical_protein("lg")
        mj = J.hky85(2.0) if m == "hky" else J.empirical_protein("lg")
        np.testing.assert_array_equal(mt.tip_clv(idx, 3), mj.tip_clv(idx, 3))
    tj, tt, _ = _sim(16, 10, 2)
    tips = np.random.default_rng(5).integers(0, 4, size=(16, 300))
    rj = J.PhyloModel(tj, J.hky85(2.0), tips, alpha=0.5,
                      config=JCfg(block_sites=128, interpret=True)
                      ).log_likelihood(method="per-node")
    rt = T.PhyloModel(tt, T.hky85(2.0), tips, alpha=0.5,
                      device="cpu").log_likelihood()
    assert rt.scaler_total > 0
    np.testing.assert_array_equal(rt.scaler_sites, rj.scaler_sites)
    site = rt.true_site_log_likelihood()
    np.testing.assert_allclose(site, rj.true_site_log_likelihood(),
                               rtol=5e-5)
    assert np.isclose(site.sum(), rt.log_likelihood, rtol=1e-12)


def test_phylo_model_takes_a_column_selected_alignment():
    """A repair (ROADMAP queue 3): ``compress_patterns`` selects columns,
    which gives a Fortran-ordered tip matrix; the model's codes are C
    ordered whatever the input's order (the kernels take contiguous
    codes), with the same likelihood."""
    _, tt, tips = _sim(6, 300, 9)
    pats, wgt = TA.compress_patterns(tips)
    assert not pats.flags["C_CONTIGUOUS"]
    a = T.PhyloModel(tt, T.hky85(2.0), pats, wgt=wgt, device="cpu")
    b = T.PhyloModel(tt, T.hky85(2.0), np.ascontiguousarray(pats), wgt=wgt,
                     device="cpu")
    assert a.codes.is_contiguous() and torch.equal(a.codes, b.codes)
    assert a.log_likelihood().log_likelihood == \
        b.log_likelihood().log_likelihood


# ------------------------------------------------- distance, consensus --

def test_pairwise_mismatch_exact_and_equal_to_jax():
    """Integer counts, exact: against a brute-force count and JAX's
    HIGHEST-precision matmuls, with weights, gaps and ambiguity codes; in
    float64 past 2^24 weighted sites."""
    rng = np.random.default_rng(0)
    L, n, S = 7, 93, 4
    codes = rng.integers(-1, 14, size=(L, n)).astype(np.int32)
    wgt = rng.integers(1, 5, size=(n,)).astype(np.float32)
    diff, tot = T.pairwise_mismatch(codes, wgt, states=S, device="cpu")
    jd, jt = J.pairwise_mismatch(codes, wgt, states=S)
    np.testing.assert_array_equal(diff.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tot.numpy(), np.asarray(jt))
    valid = (codes >= 0) & (codes < S)
    both = valid[:, None, :] & valid[None, :, :]
    want = (both * wgt).sum(axis=-1)
    np.testing.assert_array_equal(tot.numpy(), want)
    assert diff.dtype == torch.float32
    big = np.full(n, 2.0 ** 20, np.float64)
    d64, t64 = T.pairwise_mismatch(codes, big, states=S, device="cpu")
    assert d64.dtype == torch.float64
    np.testing.assert_array_equal(t64.numpy(), both.sum(axis=-1) * 2.0 ** 20)
    np.testing.assert_array_equal(
        T.jc_distance_matrix(codes, wgt, device="cpu"),
        J.jc_distance_matrix(codes, wgt))


@pytest.mark.parametrize("states", [4, 20])
def test_nj_and_consensus_equal_jax(states):
    """nj_tree, bipartitions, rf_distance, majority_rule_consensus,
    annotate_support and bootstrap_nj_trees (same seed) give the JAX
    package's trees, newick for newick."""
    if states == 4:
        tj, tt, codes = _sim(9, 600, 1, mean_branch=0.15)
    else:
        tj = J.random_tree(9, seed=1, mean_branch=0.15)
        tt = T.random_tree(9, seed=1, mean_branch=0.15)
        codes = J.simulate_alignment(tj, J.empirical_protein("lg"), 300,
                                     seed=1)
    names = tj.leaf_names()
    comp = JA.Alignment(names, codes).compressed()
    nj_t = T.nj_tree(comp.codes, comp.weights, names=names, states=states,
                     device="cpu")
    nj_j = J.nj_tree(comp.codes, comp.weights, names=names, states=states)
    assert nj_t.to_newick() == nj_j.to_newick()
    assert T.bipartitions(nj_t) == J.bipartitions(nj_j)
    assert T.rf_distance(nj_t, tt) == J.rf_distance(nj_j, tj)
    reps_t = T.bootstrap_nj_trees(comp.codes, comp.weights, n_replicates=6,
                                  names=names, states=states, seed=3,
                                  device="cpu")
    reps_j = J.bootstrap_nj_trees(comp.codes, comp.weights, n_replicates=6,
                                  names=names, states=states, seed=3)
    assert [t.to_newick() for t in reps_t] == \
        [t.to_newick() for t in reps_j]
    assert T.split_support(reps_t) == J.split_support(reps_j)
    assert T.majority_rule_consensus(reps_t).to_newick() == \
        J.majority_rule_consensus(reps_j).to_newick()
    assert T.annotate_support(nj_t, reps_t).to_newick() == \
        J.annotate_support(nj_j, reps_j).to_newick()
    np.testing.assert_array_equal(
        T.neighbor_joining(np.arange(16.0).reshape(4, 4) % 5,
                           names=list("abcd")).to_newick(),
        J.neighbor_joining(np.arange(16.0).reshape(4, 4) % 5,
                           names=list("abcd")).to_newick())


def test_bootstrap_support_equals_jax():
    """bootstrap_weights bit for bit; replicate lls and RELL support from
    the port's site log-likelihoods within rtol 5e-5 (lls) and exactly
    (support fractions) of JAX's."""
    tj, tt, tips = _sim(5, 400, 81)
    wgt = np.array([3, 1, 4, 1, 5], np.int32)
    np.testing.assert_array_equal(T.bootstrap_weights(wgt, 20, seed=1),
                                  J.bootstrap_weights(wgt, 20, seed=1))
    cfg = JCfg(block_sites=128, interpret=True)
    pj = J.PhyloModel(tj, J.hky85(2.0), tips, config=cfg)
    pt = T.PhyloModel(tt, T.hky85(2.0), tips, device="cpu")
    np.testing.assert_allclose(
        T.bootstrap_log_likelihoods(pt, n_replicates=30, seed=2),
        J.bootstrap_log_likelihoods(pj, n_replicates=30, seed=2), rtol=5e-5)
    rj = [J.PhyloModel(t, J.hky85(2.0), tips, config=cfg)
          for t in [tj] + J.nni_neighbors(tj)[:2]]
    rt = [T.PhyloModel(t, T.hky85(2.0), tips, device="cpu")
          for t in [tt] + T.nni_neighbors(tt)[:2]]
    np.testing.assert_array_equal(
        T.rell_support(rt, n_replicates=200, seed=3),
        J.rell_support(rj, n_replicates=200, seed=3))
    with pytest.raises(ValueError):
        T.rell_support([rt[0], T.PhyloModel(tt, T.hky85(2.0), tips,
                                            wgt=np.full(400, 2),
                                            device="cpu")])


def test_checkpoint_round_trip(tmp_path):
    """NumPy and tensor arrays and JSON metadata round-trip; the file
    reads back in the JAX package's loader."""
    from plf_tpu.utils.checkpoint import load_checkpoint as j_load
    path = str(tmp_path / "state.npz")
    arrays = {"a": np.arange(6).reshape(2, 3), "t": torch.ones(4)}
    TC.save_checkpoint(path, arrays, meta={"round": 3, "newick": "(a,b);"})
    assert TC.checkpoint_exists(path)
    for loader in (TC.load_checkpoint, j_load):
        got, meta = loader(path)
        np.testing.assert_array_equal(got["a"], arrays["a"])
        np.testing.assert_array_equal(got["t"], np.ones(4, np.float32))
        assert meta == {"round": 3, "newick": "(a,b);"}
    with pytest.raises(ValueError, match="reserved"):
        TC.save_checkpoint(path, {"__manifest__": np.zeros(1)})


# ---------------------------------------------------------------- search --

def test_neighbourhoods_equal_jax():
    """nni_neighbors and spr_neighbors (whole, and subsampled with a
    seed) give JAX's newicks in JAX's order, with the same touched
    nodes."""
    tj, tt = J.random_tree(8, seed=6), T.random_tree(8, seed=6)
    for kw in ({}, {"max_neighbors": 9, "seed": 2}):
        for fn in ("nni_neighbors", "spr_neighbors"):
            if fn == "nni_neighbors" and kw:
                continue
            nt, mt = getattr(T, fn)(tt, with_moves=True, **kw)
            nj, mj = getattr(J, fn)(tj, with_moves=True, **kw)
            assert [t.to_newick() for t in nt] == \
                [t.to_newick() for t in nj]
            assert mt == mj and len(nt) > 8


def test_nni_search_equals_jax():
    """From a caterpillar over simulated data: the same moves, the same
    topology, ll within rtol 1e-5 (each round scores the neighbourhood in
    one batch in both packages); and with ``refine_top``."""
    tj, tt, tips = _sim(6, 500, 7)
    cfg = JCfg(block_sites=128, interpret=True)
    for refine in (0, 2):
        rj = J.nni_search(_caterpillar(J, 6), J.hky85(2.0), tips, config=cfg,
                          max_rounds=3, refine_top=refine)
        rt = T.nni_search(_caterpillar(T, 6), T.hky85(2.0), tips,
                          max_rounds=3, refine_top=refine, device="cpu")
        assert T.rf_distance(rt.tree, T.parse_newick(rj.tree.to_newick())) \
            == 0
        assert (rt.accepted_moves, rt.evaluations) == (rj.accepted_moves,
                                                       rj.evaluations)
        assert rt.log_likelihood == pytest.approx(rj.log_likelihood,
                                                  rel=1e-5)


def test_tree_search_checkpoint_resume_equals_jax(tmp_path):
    """tests/test_search.py:160 on the port: a checkpointed search resumed
    from round 1 reaches the uninterrupted run's tree, ll (rtol 1e-9) and
    accepted moves; both reach JAX's topology with ll within rtol 1e-5;
    a mixed round (SPR and NNI moves) too."""
    tj, tt, tips = _sim(5, 300, 13, mean_branch=0.25)
    cfg = JCfg(block_sites=128, interpret=True)
    full_j = J.tree_search(_caterpillar(J, 5), J.hky85(2.0), tips,
                           config=cfg, strategy="nni", max_rounds=4)
    model = T.hky85(2.0)
    full = T.tree_search(_caterpillar(T, 5), model, tips, strategy="nni",
                         max_rounds=4, device="cpu")
    ckpt = str(tmp_path / "search.npz")
    T.tree_search(_caterpillar(T, 5), model, tips, strategy="nni",
                  max_rounds=1, checkpoint_path=ckpt, device="cpu")
    resumed = T.tree_search(_caterpillar(T, 5), model, tips, strategy="nni",
                            max_rounds=4, checkpoint_path=ckpt,
                            device="cpu")
    assert np.isclose(resumed.log_likelihood, full.log_likelihood,
                      rtol=1e-9)
    assert resumed.accepted_moves == full.accepted_moves
    assert T.rf_distance(full.tree,
                         T.parse_newick(full_j.tree.to_newick())) == 0
    assert full.log_likelihood == pytest.approx(full_j.log_likelihood,
                                                rel=1e-5)
    rj = J.tree_search(_caterpillar(J, 5), J.hky85(2.0), tips, config=cfg,
                       strategy="mixed", max_rounds=1, max_neighbors=10)
    rt = T.tree_search(_caterpillar(T, 5), model, tips, strategy="mixed",
                       max_rounds=1, max_neighbors=10, device="cpu")
    assert rt.tree.to_newick().count(",") == 4
    assert T.rf_distance(rt.tree, T.parse_newick(rj.tree.to_newick())) == 0
    assert rt.log_likelihood == pytest.approx(rj.log_likelihood, rel=1e-5)
    with pytest.raises(ValueError, match="unknown strategy"):
        T.tree_search(tt, model, tips, strategy="tbr", device="cpu")


def test_search_scores_by_rule(monkeypatch):
    """score_all's rule, up front: one batch call a round where the batch
    fits; each candidate's own log_likelihood() where it does not (no
    exception decides), and under Backend.TORCH; the same result."""
    _, tt, tips = _sim(6, 200, 3)
    model = T.hky85(2.0)
    calls = []
    real = TSearch.batch_log_likelihood
    monkeypatch.setattr(TSearch, "batch_log_likelihood",
                        lambda pms: calls.append(len(pms)) or real(pms))
    fused = T.nni_search(_caterpillar(T, 6), model, tips, max_rounds=2,
                         device="cpu")
    assert len(calls) == 2 and calls[0] == 9
    calls.clear()
    monkeypatch.setattr(TSearch, "batch_fits", lambda pms: False)
    single = T.nni_search(_caterpillar(T, 6), model, tips, max_rounds=2,
                          device="cpu")
    assert not calls
    assert single.tree.to_newick() == fused.tree.to_newick()
    assert single.log_likelihood == pytest.approx(fused.log_likelihood,
                                                  rel=1e-6)
    torch_cfg = PLFConfig(backend=Backend.TORCH)
    plain = T.nni_search(_caterpillar(T, 6), model, tips, max_rounds=2,
                         config=torch_cfg, device="cpu")
    assert not calls
    assert plain.tree.to_newick() == fused.tree.to_newick()


# ----------------------------------------------------- fit_model, pipeline --

@pytest.mark.parametrize("shape", ["random", "caterpillar"])
def test_fit_model_waves_run_the_per_node_stage(shape):
    """fit_model's traversal by waves: every internal node once, after its
    internal children, the root alone last; a wave's batched stage gives
    each node's per-node stage bit for bit (values and rescale flags)."""
    from plf_tpu_torch.models.optimize import _plf_stage, _waves
    tree = (T.random_tree(13, seed=6) if shape == "random"
            else _caterpillar(T, 9))
    sched = [(p, l, r) for (p, l, r, _, _) in tree.schedule()]
    waves = _waves(sched)
    seen = set(range(tree.n_leaves))
    for parents, lefts, rights in waves:
        assert all(c in seen for c in lefts + rights)
        seen |= set(parents)
    assert sorted(p for w in waves for p in w[0]) == sorted(
        p for p, _, _ in sched)
    assert waves[-1][0] == [tree.root]
    if shape == "caterpillar":        # each internal node its own wave
        assert len(waves) == 8
    else:                             # 12 internal nodes in fewer waves
        assert len(waves) < 12
    rng = np.random.default_rng(6)
    m, n, C, S = 5, 64, 4, 4
    x1, x2 = (torch.tensor(rng.random((m, n, C, S)), dtype=torch.float32)
              for _ in range(2))
    x1[:, ::3] *= 1e-30
    left, right = (torch.tensor(rng.random((m, C, S, S)),
                                dtype=torch.float32) for _ in range(2))
    ev = torch.tensor(rng.random((S, S)), dtype=torch.float32)
    x3, sv = _plf_stage(x1, x2, left, right, ev, S)
    assert int(sv.sum()) > 0
    for j in range(m):
        y3, sj = _plf_stage(x1[j], x2[j], left[j], right[j], ev, S)
        assert torch.equal(x3[j], y3) and torch.equal(sv[j], sj)


@pytest.mark.parametrize("fit_alpha", [False, True])
def test_fit_model_equals_jax(fit_alpha):
    """fit_model at 5 taxa x 300 sites, 20 Adam steps from a near-JC GTR
    (the same seeded rate jitter): ll before and after within rtol 1e-5,
    frequencies and exchangeabilities within 1e-4, lengths within 1e-2.
    With ``fit_alpha`` the golden-section search after the first epoch
    lands 1.1e-3 (relative) from JAX's alpha on a flat profile (2.9742
    against 2.9709: the two fp32 likelihoods round differently), and the
    second epoch's Adam steps start from those rates: there the
    exchangeabilities were measured 1.6e-4 apart, so they are held to
    1e-3 and alpha to 1e-2 relative; ll and frequencies keep 1e-5 and
    1e-4."""
    true_model = J.gtr([1.0, 3.0, 0.8, 1.2, 3.5, 1.0],
                       [0.35, 0.15, 0.25, 0.25])
    tj = J.random_tree(5, seed=4, mean_branch=0.25)
    tt = T.random_tree(5, seed=4, mean_branch=0.25)
    tips = J.simulate_alignment(tj, true_model, 300, seed=5)
    rates, pi = [1.0, 1.01, 0.99, 1.0, 1.02, 0.98], [0.25] * 4
    alpha = 0.5 if fit_alpha else None
    oj = J.fit_model(J.PhyloModel(tj, J.gtr(rates, pi), tips, alpha=alpha,
                                  config=JCfg(block_sites=128,
                                              interpret=True)),
                     steps=20, learning_rate=0.05, fit_alpha=fit_alpha)
    ot = T.fit_model(T.PhyloModel(tt, T.gtr(rates, pi), tips, alpha=alpha,
                                  device="cpu"),
                     steps=20, learning_rate=0.05, fit_alpha=fit_alpha)
    assert len(ot) == len(oj) == (5 if fit_alpha else 4)
    assert ot[3] > ot[2] + 1.0
    for k in (2, 3):
        assert ot[k] == pytest.approx(oj[k], rel=1e-5)

    def exchangeabilities(m):
        q = (m.u * m.eigenvalues[None, :]) @ m.w
        iu = np.triu_indices(4, 1)
        return q[iu] / m.pi[iu[1]]

    np.testing.assert_allclose(ot[0].pi, np.asarray(oj[0].pi), atol=1e-4)
    np.testing.assert_allclose(exchangeabilities(ot[0]),
                               exchangeabilities(oj[0]),
                               atol=1e-3 if fit_alpha else 1e-4)
    np.testing.assert_allclose(ot[1], np.asarray(oj[1]), atol=1e-2)
    if fit_alpha:
        assert ot[4] == pytest.approx(oj[4], rel=1e-2)


def test_run_inference_equals_jax():
    """run_inference at 6 taxa x 1,200 simulated sites, NNI, lengths,
    bootstrap 5: RF 0 between the two results, ll within rtol 1e-5 and
    the same support labels."""
    true_j = J.random_tree(6, seed=11, mean_branch=0.12)
    codes = J.simulate_alignment(true_j, J.hky85(2.0), n_sites=1200,
                                 seed=12)
    kw = dict(names=true_j.leaf_names(), alpha=None, search="nni",
              fit="lengths", bootstrap=5)
    rj = J.run_inference(codes, model=J.hky85(2.0), **kw)
    msgs = []
    rt = T.run_inference(codes, model=T.hky85(2.0), progress=msgs.append,
                         device="cpu", **kw)
    assert T.rf_distance(rt.tree, T.parse_newick(rj.newick)) == 0
    assert rt.log_likelihood == pytest.approx(rj.log_likelihood, rel=1e-5)
    labels = lambda t: sorted((n.name, frozenset(
        T.bipartitions(t).get(n.index, (0,))[:1]))
        for n in t.nodes if not n.is_leaf and n.name)
    support = lambda nwk: {s: [n.name for n in t.nodes
                               if n.index == i][0]
                           for t in [T.parse_newick(nwk)]
                           for s, (i, _) in T.bipartitions(t).items()}
    assert support(rt.newick) == support(rj.newick)
    assert labels(rt.tree)
    assert rj.log == rt.log[:len(rj.log)] or len(rt.log) == len(rj.log)
    assert any("bootstrap" in m for m in msgs) and rt.elapsed_s > 0


def test_run_inference_reports_the_fitted_shape():
    """The port repairs a fault of the JAX pipeline (ROADMAP queue 3):
    there ``make_pm`` keeps the initial alpha, so the final length pass
    and the reported ll ignore the fitted one.  Here the reported ll is
    the final tree's under the reported alpha, exactly, and at least the
    fitted alpha's ll before the final lengths."""
    tt = T.random_tree(5, seed=13, mean_branch=0.1)
    model = T.jc69()
    codes = T.simulate_alignment(tt, model, n_sites=600, alpha=0.6, seed=14)
    res = T.run_inference(codes, names=tt.leaf_names(), model=model,
                          alpha=3.0, search="none", fit="lengths+alpha",
                          device="cpu")
    assert res.alpha != 3.0
    names = tt.leaf_names()
    comp = TA.Alignment(names, codes).compressed()
    tree = T.parse_newick(res.newick)
    order = [names.index(nm) for nm in tree.leaf_names()]
    pm = T.PhyloModel(tree, model, comp.codes[order], wgt=comp.weights,
                      alpha=res.alpha, device="cpu")
    assert pm.log_likelihood().log_likelihood == pytest.approx(
        res.log_likelihood, rel=1e-12)
