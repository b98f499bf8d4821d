"""The port's marginal ancestral states and per-site rates
(``models/ancestral.py``) against the JAX package's and a float64 brute
force, on the CPU.

Posteriors are probabilities in fp32 through a max-normalised two-pass
recursion in state space: within 1e-5 (absolute) of JAX's fp32 pass and
of the float64 pass (``ancestral_bruteforce``), on random codes rich in
ambiguity, and of an enumeration of every internal assignment on a
4-taxon tree.  ``site_rates`` finishes in float64 from the fp32 root CLV,
which holds eigen-coordinate sums: on simulated alignments (with gaps)
within 1e-5 of both; on random codes, whose eigen-coordinate sums cancel
below fp32 rounding (JAX lands up to ~2e-5 from float64 there, the port
up to 2.1 times JAX's distance: the sums run in another order), within
three times JAX's own distance from the float64 pass, measured in the
same run, and never looser than 1e-5."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import plf_tpu.models as J  # noqa: E402
from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.models.ancestral import ancestral_marginal as j_anc  # noqa: E402
from plf_tpu.models.ancestral import site_rates as j_rates  # noqa: E402
import plf_tpu_torch.models as T  # noqa: E402
from plf_tpu_torch.config import PLFConfig  # noqa: E402
from plf_tpu_torch.models.ancestral import ancestral_bruteforce  # noqa: E402
from test_torch_batch import _one_torch_thread  # noqa: E402,F401

ATOL = 1e-5


def _tips(n_taxa, n_sites, S, seed, n_codes):
    """Random codes with every IUPAC ambiguity code (DNA) or X/B/Z
    (protein) and gaps."""
    rng = np.random.default_rng(seed)
    tips = rng.integers(0, S, size=(n_taxa, n_sites))
    amb = rng.random(tips.shape) < 0.1
    tips[amb] = rng.integers(S, n_codes, size=int(amb.sum()))
    tips[rng.random(tips.shape) < 0.05] = -1
    return tips


CASES = {
    # name: (taxa, sites, tree seed, (model kw), pm kw)
    "dna": (6, 200, 71, dict(alpha=0.7)),
    "dna_pinv": (6, 160, 73, dict(alpha=0.5, p_inv=0.3)),
    "protein": (5, 128, 75, dict(alpha=0.6)),
}


def _models(name, simulated=False):
    """Both packages' models of one case, on random codes (with
    ambiguity and gaps) or on an alignment simulated under the model
    (with 5% gaps)."""
    n_taxa, n_sites, seed, kw = CASES[name]
    S = 20 if name == "protein" else 4
    if S == 4:
        mj, mt = J.hky85(2.0, [0.3, 0.2, 0.3, 0.2]), T.hky85(
            2.0, [0.3, 0.2, 0.3, 0.2])
    else:
        mj, mt = J.empirical_protein("lg"), T.empirical_protein("lg")
    tj = J.random_tree(n_taxa, seed=seed, mean_branch=0.3)
    tt = T.random_tree(n_taxa, seed=seed, mean_branch=0.3)
    if simulated:
        tips = J.simulate_alignment(tj, mj, n_sites, alpha=kw["alpha"],
                                    seed=seed)
        rng = np.random.default_rng(seed)
        tips[rng.random(tips.shape) < 0.05] = -1
    else:
        tips = _tips(n_taxa, n_sites, S, seed, 15 if S == 4 else 23)
    pmj = J.PhyloModel(tj, mj, tips, config=JCfg(
        states=S, block_sites=128, interpret=True), **kw)
    pmt = T.PhyloModel(tt, mt, tips, config=PLFConfig(
        states=S, block_sites=128), device="cpu", **kw)
    return pmj, pmt


@pytest.mark.parametrize("name", list(CASES))
def test_ancestral_marginal_equals_jax_and_float64(name):
    pmj, pmt = _models(name)
    got, want = T.ancestral_marginal(pmt), j_anc(pmj)
    bf, _ = ancestral_bruteforce(pmt)
    assert set(got) == set(want) == set(bf)
    assert len(got) == pmt.tree.n_leaves - 1
    for v in got:
        assert got[v].dtype == np.float32
        assert got[v].shape == (pmt.n_sites_obs, pmt.model.states)
        np.testing.assert_allclose(got[v], want[v], atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[v], bf[v], atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[v].sum(axis=1), 1.0, atol=ATOL)


def _site_rates_three_ways(name, simulated):
    pmj, pmt = _models(name, simulated)
    mean_t, post_t = T.site_rates(pmt)
    mean_j, post_j = j_rates(pmj)
    _, lik = ancestral_bruteforce(pmt)
    w = lik * np.asarray(pmt.rate_weights)[None, :]
    post_bf = w / w.sum(axis=1, keepdims=True)
    assert post_t.shape == (pmt.n_sites_obs, pmt.config.categories)
    assert mean_t.shape == (pmt.n_sites_obs,)
    return (mean_t, post_t), (mean_j, post_j), (post_bf @ pmt.rates,
                                                post_bf)


@pytest.mark.parametrize("name", list(CASES))
def test_site_rates_equals_jax_and_float64(name):
    port, jax_, bf = _site_rates_three_ways(name, simulated=True)
    for want in (jax_, bf):
        np.testing.assert_allclose(port[1], want[1], atol=ATOL, rtol=0)
        np.testing.assert_allclose(port[0], want[0], atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_site_rates_on_random_codes_within_jax_class(name):
    port, jax_, bf = _site_rates_three_ways(name, simulated=False)
    for i in (0, 1):
        jax_dist = float(np.abs(jax_[i] - bf[i]).max())
        bar = max(3 * jax_dist, ATOL)
        assert float(np.abs(port[i] - bf[i]).max()) <= bar


def _enumerated_posterior(pm):
    """Every internal-state assignment of a tiny tree, float64
    (tests/test_ancestral.py's oracle)."""
    S, C, n = pm.model.states, pm.config.categories, pm.n_sites_obs
    schedule = [(p, l, r) for (p, l, r, _, _) in pm.schedule]
    internals = [p for p, _, _ in schedule]
    root, n_leaves = pm.tree.root, pm.tree.n_leaves
    P = {nd.index: np.stack([pm.model.p_matrix(nd.length, r)
                             for r in pm.rates])
         for nd in pm.tree.nodes if nd.index != root}
    tipl = {}
    for leaf in range(n_leaves):
        si = pm.tip_states[leaf]
        oh = np.zeros((n, S))
        valid = (si >= 0) & (si < S)
        oh[np.arange(n)[valid], si[valid]] = 1.0
        oh[~valid] = 1.0
        tipl[leaf] = oh
    parent_of = {c: p for p, l, r in schedule for c in (l, r)}
    post = {v: np.zeros((n, S)) for v in internals}
    total = np.zeros(n)
    for assign in itertools.product(range(S), repeat=len(internals)):
        st = dict(zip(internals, assign))
        for c in range(C):
            w = np.full(n, pm.model.pi[st[root]] * pm.rate_weights[c])
            for v, p in parent_of.items():
                if v < n_leaves:
                    w = w * (P[v][c][st[p]] * tipl[v]).sum(axis=1)
                else:
                    w = w * P[v][c][st[p], st[v]]
            total += w
            for v in internals:
                post[v][:, st[v]] += w
    return {v: post[v] / total[:, None] for v in internals}


def test_ancestral_matches_enumeration():
    tree = T.random_tree(4, seed=71, mean_branch=0.3)
    rng = np.random.default_rng(71)
    tips = rng.integers(0, 4, size=(4, 30))
    tips[0, 5] = -1
    pm = T.PhyloModel(tree, T.hky85(2.0, [0.3, 0.2, 0.3, 0.2]), tips,
                      alpha=0.7, config=PLFConfig(block_sites=128),
                      device="cpu")
    got, want = T.ancestral_marginal(pm), _enumerated_posterior(pm)
    assert set(got) == set(want)
    for v in got:
        np.testing.assert_allclose(got[v], want[v], atol=ATOL, rtol=0)


def test_ancestral_chunks_and_no_data():
    """Sites split into chunks give the unsplit posteriors; with no data
    the root posterior is the stationary distribution; an ascertainment
    model drops its dummy columns."""
    from plf_tpu_torch.models import ancestral as TA
    tree = T.parse_newick("((A:0.1,B:0.1):0.1,(C:0.1,D:0.1):0.1);")
    model = T.hky85(2.0, [0.4, 0.1, 0.3, 0.2])
    pm = T.PhyloModel(tree, model, -np.ones((4, 8), np.int64),
                      config=PLFConfig(block_sites=128), device="cpu")
    np.testing.assert_allclose(T.ancestral_marginal(pm)[pm.tree.root],
                               np.broadcast_to(model.pi, (8, 4)), atol=ATOL)
    _, pmt = _models("dna")
    whole = T.ancestral_marginal(pmt)
    old = TA._CHUNK_ELEMENTS
    try:
        TA._CHUNK_ELEMENTS = 64 * 4 * 16       # 64-site chunks
        split = T.ancestral_marginal(pmt)
    finally:
        TA._CHUNK_ELEMENTS = old
    for v in whole:
        np.testing.assert_array_equal(split[v], whole[v])
    asc = T.PhyloModel(pmt.tree, pmt.model, pmt.tip_states, alpha=0.7,
                       ascertainment="lewis",
                       config=PLFConfig(block_sites=128), device="cpu")
    for v, p in T.ancestral_marginal(asc).items():
        np.testing.assert_array_equal(p, whole[v])
