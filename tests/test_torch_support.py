"""The port's SH-aLRT branch support (``models/support.py``) against the
JAX package's, on the CPU.

Both draw the RELL weight matrix from ``np.random.default_rng(seed)``, so
the SH-like supports are equal exactly; the aLRT statistics (twice an ll
difference of ~1e3-magnitude lls, each within ~1e-5 of the other
package's in fp32) within abs 1e-3."""

import pytest

torch = pytest.importorskip("torch")

import plf_tpu.models as J  # noqa: E402
from plf_tpu.io.alignment import compress_patterns  # noqa: E402
import plf_tpu_torch.models as T  # noqa: E402
from plf_tpu_torch.models import support as TSup  # noqa: E402
from test_torch_batch import _one_torch_thread  # noqa: E402,F401

ALRT_ATOL = 1e-3


def _case(seed=21, n_taxa=6, n_sites=300):
    tj = J.random_tree(n_taxa, seed=seed, mean_branch=0.15)
    tt = T.random_tree(n_taxa, seed=seed, mean_branch=0.15)
    tips = J.simulate_alignment(tj, J.hky85(2.0), n_sites, alpha=0.5,
                                seed=seed + 1)
    return tj, tt, tips


@pytest.mark.parametrize("compressed", [False, True])
def test_alrt_support_equals_jax(compressed):
    tj, tt, tips = _case()
    wgt = None
    if compressed:
        tips, wgt = compress_patterns(tips)
    kw = dict(wgt=wgt, alpha=0.5, rell_replicates=200, seed=1)
    sj = J.alrt_support(tj, J.hky85(2.0), tips, **kw)
    st = T.alrt_support(tt, T.hky85(2.0), tips, device="cpu", **kw)
    assert set(st) == set(sj) and len(st) == tt.n_leaves - 2
    for d in sj:
        assert st[d][0] == pytest.approx(sj[d][0], abs=ALRT_ATOL)
        assert st[d][1] == sj[d][1]


def test_alrt_scores_the_two_nni_alternatives(monkeypatch):
    """Each branch scores the incumbent's two NNI neighbours around it,
    each through log_likelihood() and true_site_log_likelihood() on the
    incumbent's device tensors, and the statistic is twice the gap to the
    better one."""
    _, tt, tips = _case(seed=5, n_sites=200)
    seen = []
    real = TSup._site_ll

    def spy(tree, *a, **kw):
        ll, s, pm = real(tree, *a, **kw)
        seen.append((tree.to_newick(), ll))
        assert s.shape == (tips.shape[1],)
        # the alternatives share the incumbent's alignment on the device
        assert (kw.get("share") is None) == (len(seen) == 1)
        return ll, s, pm

    monkeypatch.setattr(TSup, "_site_ll", spy)
    sup = T.alrt_support(tt, T.jc69(), tips, rell_replicates=50,
                         device="cpu")
    assert len(seen) == 1 + 2 * len(sup)
    nni = {t.to_newick() for t in T.nni_neighbors(tt)}
    assert {nw for nw, _ in seen[1:]} <= nni
    ll0 = seen[0][1]
    for i, d in enumerate(sup):
        a, b = seen[1 + 2 * i][1], seen[2 + 2 * i][1]
        assert sup[d][0] == pytest.approx(2 * (ll0 - max(a, b)), abs=1e-9)


@pytest.mark.parametrize("which", ["sh", "alrt"])
def test_annotate_alrt_equals_jax(which):
    nwk = "((a:0.1,b:0.1):0.1,((c:0.1,d:0.2):0.1,e:0.3):0.1);"
    tj, tt = J.parse_newick(nwk), T.parse_newick(nwk)
    tips = J.simulate_alignment(tj, J.jc69(), 400, seed=3)
    sj = J.alrt_support(tj, J.jc69(), tips, rell_replicates=50)
    st = T.alrt_support(tt, T.jc69(), tips, rell_replicates=50,
                        device="cpu")
    # the labels print 3 significant digits of aLRT: feed both the same
    aj = J.annotate_alrt(tj, sj, which=which)
    at = T.annotate_alrt(tt, sj, which=which)
    assert at.to_newick() == aj.to_newick()
    assert T.annotate_alrt(tt, st, which="sh").to_newick() == \
        J.annotate_alrt(tj, sj, which="sh").to_newick()
