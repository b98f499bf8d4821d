"""The port's model selection (``models/selection.py``) against the JAX
package's, on the CPU (the port's plain versions; JAX's XLA route).

The same numpy-seeded alignment goes through both ``model_select``s: the
same candidates, parameter counts, ranking and table rows.  Tolerances
are the port's fitter bars (tests/test_torch_workflow.py): lls within rel
1e-5 (the fits take the same steps in fp32 on both sides; their sums run
in other orders), alpha within rel 1e-2 (a golden-section optimum on a
flat profile moves by more than the ll does)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import plf_tpu.models as J  # noqa: E402
from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
import plf_tpu_torch.models as T  # noqa: E402
from plf_tpu_torch.config import PLFConfig  # noqa: E402
from plf_tpu_torch.models import selection as TS  # noqa: E402
from test_torch_batch import _one_torch_thread  # noqa: E402,F401

LL_RTOL = 1e-5
ALPHA_RTOL = 1e-2


def _case(n_taxa=6, n_sites=300, seed=2):
    tj = J.random_tree(n_taxa, seed=seed)
    tt = T.random_tree(n_taxa, seed=seed)
    aln = J.simulate_alignment(tj, J.hky85(6.0, np.array([0.3, 0.2, 0.3,
                                                          0.2])),
                               n_sites, alpha=0.6, seed=5)
    return tj, tt, aln


def _rows(table):
    """A table's rows as (name, k, [lnL, AIC, AICc, BIC])."""
    out = []
    for line in table.splitlines()[1:]:
        f = line.split()
        out.append((f[0], int(f[2]), [float(x) for x in (f[1], *f[3:])]))
    return out


def test_model_select_equals_jax():
    tj, tt, aln = _case()
    cands = ("JC", "JC+G", "HKY+G")
    rj = J.model_select(tj, aln, candidates=cands,
                        config=JCfg(block_sites=128), steps=10)
    rt = T.model_select(tt, aln, candidates=cands,
                        config=PLFConfig(block_sites=128), steps=10,
                        device="cpu")
    assert [f.name for f in rt.fits] == [f.name for f in rj.fits]
    assert rt.best.name == "HKY+G"
    for a, b in zip(rj.fits, rt.fits):
        assert b.k_params == a.k_params
        assert b.log_likelihood == pytest.approx(a.log_likelihood,
                                                 rel=LL_RTOL)
        for crit in ("aic", "aicc", "bic"):
            assert getattr(b, crit) == pytest.approx(getattr(a, crit),
                                                     rel=LL_RTOL)
        if a.alpha is None:
            assert b.alpha is None
        else:
            assert b.alpha == pytest.approx(a.alpha, rel=ALPHA_RTOL)
        assert b.seconds > 0
        np.testing.assert_allclose(b.lengths, a.lengths, rtol=2e-2,
                                   atol=1e-4)
    for (nj, kj, vj), (nt, kt, vt) in zip(_rows(rj.table()),
                                          _rows(rt.table())):
        assert (nt, kt) == (nj, kj)
        # the table prints 2 decimals: rel 1e-5 plus its rounding
        np.testing.assert_allclose(vt, vj, rtol=LL_RTOL, atol=0.01)
    assert rt.table().splitlines()[0] == rj.table().splitlines()[0]


@pytest.mark.parametrize("criterion", ["AIC", "AICc", "BIC"])
def test_criteria_and_param_counts_equal_jax(criterion):
    """ModelTest's counts and formulas (JC 0, +G 1, 2n-3 lengths), each
    criterion's ranking, on JC data (tests/test_selection.py's case)."""
    tj = J.random_tree(6, seed=1)
    tt = T.random_tree(6, seed=1)
    aln = J.simulate_alignment(tj, J.jc69(), 300, seed=3)
    rj = J.model_select(tj, aln, candidates=("JC", "JC+G"),
                        criterion=criterion, config=JCfg(block_sites=128),
                        steps=10)
    rt = T.model_select(tt, aln, candidates=("JC", "JC+G"),
                        criterion=criterion,
                        config=PLFConfig(block_sites=128), steps=10,
                        device="cpu")
    assert rt.criterion == criterion
    assert [f.name for f in rt.fits] == [f.name for f in rj.fits]
    fits = {f.name: f for f in rt.fits}
    assert fits["JC"].k_params == 2 * 6 - 3
    assert fits["JC+G"].k_params == 2 * 6 - 3 + 1
    n = aln.shape[1]
    for f in rt.fits:
        k, ll = f.k_params, f.log_likelihood
        assert f.aic == pytest.approx(2 * k - 2 * ll, rel=1e-12)
        assert f.aicc == pytest.approx(
            f.aic + 2 * k * (k + 1) / (n - k - 1), rel=1e-12)
        assert f.bic == pytest.approx(k * np.log(n) - 2 * ll, rel=1e-12)


def test_empirical_frequencies_and_ladders_equal_jax():
    from plf_tpu.models import selection as JS
    rng = np.random.default_rng(0)
    codes = rng.integers(-1, 25, size=(5, 200))
    for S in (4, 20, 61):
        np.testing.assert_array_equal(T.empirical_frequencies(codes, S),
                                      JS.empirical_frequencies(codes, S))
    assert T.DNA_CANDIDATES == JS.DNA_CANDIDATES
    assert T.PROTEIN_CANDIDATES == JS.PROTEIN_CANDIDATES
    assert T.CODON_CANDIDATES == JS.CODON_CANDIDATES
    assert TS._K_MODEL == JS._K_MODEL


@pytest.mark.parametrize("states,ladder", [(20, "PROTEIN_CANDIDATES"),
                                           (61, "CODON_CANDIDATES"),
                                           (4, "DNA_CANDIDATES")])
def test_default_ladder_by_states(monkeypatch, states, ladder):
    """``candidates=None`` takes the ladder of the config's states, and
    every candidate reaches its fitter with ``device`` (the fitters
    stubbed, as tests/test_selection.py stubs them)."""
    ran = []

    def stub(tree, model, codes, wgt, alpha0, config, steps, fit_alpha,
             fit_pinv=False, device=None):
        ran.append((model.states, fit_alpha, fit_pinv, device))
        t = np.full(tree.n_nodes - 1, 0.1, np.float32)
        return tree, (0.5 if fit_alpha else None), -100.0, t, (
            0.2 if fit_pinv else None)

    def codon_stub(tree, codes, wgt=None, config=None, fit_alpha=False,
                   device=None, **kw):
        ran.append((61, fit_alpha, False, device))
        return T.codon_gy94(2.0, 0.5), dict(
            tree=tree, lengths=np.full(tree.n_nodes - 1, 0.1), ll=-100.0,
            alpha=0.5 if fit_alpha else None)

    def gtr_stub(pm, steps=150, fit_alpha=False, **kw):
        ran.append((4, fit_alpha, False, str(pm.device)))
        t = np.full(pm.tree.n_nodes - 1, 0.1, np.float32)
        out = (pm.model, t, -110.0, -100.0)
        return out + (0.5,) if fit_alpha else out

    from plf_tpu_torch.models import optimize as TO
    monkeypatch.setattr(TS, "_fit_lengths_alpha", stub)
    monkeypatch.setattr(TS, "_fit_kappa", lambda *a, **k: 2.0)
    monkeypatch.setattr(TO, "fit_codon", codon_stub)
    monkeypatch.setattr(TO, "fit_model", gtr_stub)
    tree = T.random_tree(4, seed=3)
    codes = np.random.default_rng(0).integers(0, states, size=(4, 50))
    res = T.model_select(tree, codes, config=PLFConfig(states=states),
                         candidates=None, steps=2, device="cpu")
    assert sorted(f.name for f in res.fits) == sorted(getattr(T, ladder))
    assert all(s == states and d == "cpu" for (s, _, _, d) in ran)


def test_plus_f_only_on_protein_matrices():
    tree = T.random_tree(4, seed=3)
    codes = np.zeros((4, 20), np.int64)
    with pytest.raises(ValueError, match=r"\+F applies"):
        T.model_select(tree, codes, candidates=("HKY+F",), device="cpu")
    with pytest.raises(ValueError, match="unknown candidate"):
        T.model_select(tree, codes, candidates=("K80",), device="cpu")
