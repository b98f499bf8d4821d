"""The candidate axis of the segmented engine: ``batch_log_likelihood_
segmented`` (kernels 7 and 7m with a candidate axis, ``ops/plf_tree_seg.py::
plf_tree_seg_batch``; their plain versions here) against each candidate's
own ``log_likelihood(method="segmented")``, against the JAX package's
``batch_log_likelihood_segmented`` (its segmented kernel in interpret mode
under ``lax.map``), ``stack_programs`` on candidates whose segment counts
differ, and ``score_all`` taking the segmented batch when the fused batch
does not fit.

The port's cap is forced small (3 ops a segment) so that every candidate
cuts into several segments; JAX cuts by its own budget, which changes no
likelihood (fp32 boundaries round-trip exactly).  Tolerances: rows within
rtol 1e-6 of each candidate's ``log_likelihood(method="segmented")`` (fp32
chunk sums against the host's fp64 sum); against JAX rtol 5e-5
(tests/test_torch_batch.py's bar for the tree kernels), "mxu_3x" within
JAX's own "mxu_3x"-vs-"mxu" distance, and bf16 boundaries within twice
JAX's bf16-vs-fp32 distance plus 5e-5 of the ll (the packages round the
same boundaries; tests/test_torch_bf16.py's class), all measured in the
same run."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.models import PhyloModel as JPM  # noqa: E402
from plf_tpu.models import empirical_protein as jprot  # noqa: E402
from plf_tpu.models import hky85 as jhky  # noqa: E402
from plf_tpu.models import nni_neighbors as jnni  # noqa: E402
from plf_tpu.models import random_tree as jrt  # noqa: E402
from plf_tpu.models.phylo import \
    batch_log_likelihood_segmented as jbatch_seg  # noqa: E402
from plf_tpu_torch import PLFConfig  # noqa: E402
from plf_tpu_torch.models import (PhyloModel, empirical_protein,  # noqa: E402
                                  hky85, nni_neighbors, nni_search,
                                  random_tree)
from plf_tpu_torch.models import phylo as TP  # noqa: E402
from plf_tpu_torch.models import search as TS  # noqa: E402
from plf_tpu_torch.ops import plf_tree_seg as SG  # noqa: E402

CAP = 3
#: name -> (states, taxa, sites, highest tip code + 1, tree seed, neighbours)
CASES = {"dna": (4, 14, 300, 14, 7, 8), "protein": (20, 12, 128, 23, 7, 5)}


@pytest.fixture
def small_cap(monkeypatch):
    """Every plan of the port cut at CAP ops a segment."""
    monkeypatch.setattr(SG, "seg_cap_ops", lambda *a, **k: CAP)
    monkeypatch.setattr(SG, "seg_mxu_cap_ops", lambda *a, **k: CAP)


def _tips(name):
    S, taxa, sites, codes, seed, _ = CASES[name]
    tips = np.random.default_rng(seed).integers(-1, codes,
                                                size=(taxa, sites))
    tips[:, 2] = -1                                  # a gap column
    return tips


def _trees(name, jax_pkg):
    _, taxa, _, _, seed, k = CASES[name]
    tree = (jrt if jax_pkg else random_tree)(taxa, seed=seed)
    return [tree] + (jnni if jax_pkg else nni_neighbors)(tree)[:k]


def _port(name, variant, dtype="float32", trees=None):
    S = CASES[name][0]
    model = hky85(2.0) if S == 4 else empirical_protein("lg")
    cfg = PLFConfig(states=S, block_sites=128, kernel_variant=variant,
                    dtype=dtype)
    trees = _trees(name, False) if trees is None else trees
    tips = _tips(name)
    pm0 = PhyloModel(trees[0], model, tips, alpha=0.5, config=cfg,
                     device="cpu")
    return [pm0] + [PhyloModel(t, model, tips, alpha=0.5, config=cfg,
                               share_device_from=pm0, device="cpu")
                    for t in trees[1:]]


def _jax(name, variant, dtype="float32"):
    S = CASES[name][0]
    model = jhky(2.0) if S == 4 else jprot("lg")
    cfg = JCfg(states=S, block_sites=128, interpret=True,
               kernel_variant=variant, dtype=dtype)
    trees, tips = _trees(name, True), _tips(name)
    pm0 = JPM(trees[0], model, tips, alpha=0.5, config=cfg)
    pms = [pm0] + [JPM(t, model, tips, alpha=0.5, config=cfg,
                       share_device_from=pm0) for t in trees[1:]]
    return jbatch_seg(pms)


CONFIGS = [("dna", "vpu", "float32"), ("dna", "vpu", "bfloat16"),
           ("protein", "mxu_3x", "float32"), ("protein", "mxu", "float32")]


@pytest.mark.parametrize("name,variant,dtype", CONFIGS)
def test_seg_batch_rows_equal_each_log_likelihood(name, variant, dtype,
                                                  small_cap):
    pms = _port(name, variant, dtype)
    segs = [len(pm._segmented_inputs()[0].segments) for pm in pms]
    assert min(segs) >= 3
    got = TP.batch_log_likelihood_segmented(pms)
    assert got.shape == (len(pms),) and got.dtype == np.float64
    want = np.array([pm.log_likelihood(method="segmented").log_likelihood
                     for pm in pms])
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name,variant,dtype", CONFIGS)
def test_seg_batch_matches_jax(name, variant, dtype, small_cap):
    got = TP.batch_log_likelihood_segmented(_port(name, variant, dtype))
    want = _jax(name, variant, dtype)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        j32 = _jax(name, variant)
        p32 = TP.batch_log_likelihood_segmented(_port(name, variant))
        bar = 2 * np.abs(want - j32).max() + 5e-5 * np.abs(j32).max()
        assert np.abs(got - want).max() <= bar
        assert np.abs(got - p32).max() > 0, "bf16 boundaries must round"
    elif variant == "mxu_3x":
        bar = np.abs(want - _jax(name, "mxu")).max()
        assert np.abs(got - want).max() <= bar
    else:
        np.testing.assert_allclose(got, want, rtol=5e-5)


def test_stack_programs_pads_differing_segment_counts(small_cap):
    """Candidates (random trees over one alignment) cut into different
    numbers of segments stack to the
    batch's most, padded with rows (E, -1) past each candidate's last;
    the plain batch's rows equal the single-tree plain version on each
    candidate's own program bit for bit, likelihoods and scaler counts;
    the chunk size follows the cap on the boundary buffer."""
    taxa = CASES["dna"][1]
    pms = _port("dna", "vpu",
                trees=[random_tree(taxa, seed=s) for s in range(6)])
    plans = [pm._segmented_inputs()[0] for pm in pms]
    programs = [pm._seg_np + (plan.n_boundaries,)
                for pm, plan in zip(pms, plans)]
    counts = [len(p[1]) for p in programs]
    assert len(set(counts)) > 1, counts
    progs, segs, n_slots, n_bnd = SG.stack_programs(programs)
    E = len(pms[0].schedule)
    assert progs.shape == (len(pms), 6, E)
    assert segs.shape == (len(pms), max(counts), 2)
    assert n_slots == max(p[2] for p in programs)
    assert n_bnd == max(p[3] for p in programs)
    for b, c in enumerate(counts):
        np.testing.assert_array_equal(segs[b, :c], programs[b][1])
        assert (segs[b, c:] == (E, -1)).all()
    pm0 = pms[0]
    cfg = pm0.config
    kw = dict(n_boundaries=n_bnd, n_slots=n_slots, states=4, categories=4)
    progs, segs, lcs, rcs, planes, slots, bnd = \
        TP.segmented_batch_inputs(pms)
    assert planes is None and (slots, bnd) == (n_slots, n_bnd)
    assert lcs.shape[0] <= len(pms) * E
    args = (pm0.codes, progs, segs, lcs, rcs, pm0.ec, pm0.fused_tip_table,
            pm0.root_rows[0], pm0.n_sites)
    lik, sc = SG.plf_tree_seg_batch(*args, **kw)
    for b, pm in enumerate(pms):
        plan, prog, sg, slots = pm._segmented_inputs()
        l1, s1, _ = SG.plf_tree_seg(
            pm.codes, prog, sg, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
            pm.root_rows[0], pm.n_sites, n_boundaries=plan.n_boundaries,
            n_slots=slots, program=pm.segmented_program)
        assert torch.equal(lik[b], l1[0]) and torch.equal(sc[b], s1[0]), b
    rows, n_pad = cfg.rows, pm0.n_pad
    per = SG.seg_batch_size(len(pms), n_bnd, rows, n_pad,
                            bbuf_bytes=n_bnd * rows * n_pad * 4)
    assert per == 1
    assert SG.seg_batch_size(len(pms), n_bnd, rows, n_pad) == len(pms)
    assert SG.seg_batch_size(3, 0, rows, n_pad, bbuf_bytes=1) == 3


def test_score_all_takes_the_segmented_batch(monkeypatch, small_cap):
    """When the fused batch does not fit (``batch_fits`` False), a search
    round scores its neighbourhood with ``batch_log_likelihood_segmented``
    and lands where the fused batch does; candidate by candidate only on
    that scorer's ValueError."""
    S, taxa, sites, codes, seed, _ = CASES["dna"]
    tree = random_tree(taxa, seed=seed + 1)
    tips = _tips("dna")
    kw = dict(max_rounds=2, alpha=0.5,
              config=PLFConfig(block_sites=128), device="cpu")
    ref = nni_search(tree, hky85(2.0), tips, **kw)
    calls = []
    real = TS.batch_log_likelihood_segmented

    def spy(pms):
        calls.append(len(pms))
        return real(pms)

    monkeypatch.setattr(TS, "batch_fits", lambda pms: False)
    monkeypatch.setattr(TS, "batch_log_likelihood_segmented", spy)
    got = nni_search(tree, hky85(2.0), tips, **kw)
    assert calls and calls[0] == 1 + 2 * (taxa - 2)
    assert got.log_likelihood == pytest.approx(ref.log_likelihood,
                                               rel=1e-6)

    def refuse(pms):
        calls.append(-1)
        raise ValueError("no segment arena takes this tree")

    monkeypatch.setattr(TS, "batch_log_likelihood_segmented", refuse)
    got = nni_search(tree, hky85(2.0), tips, **kw)
    assert calls[-1] == -1
    assert got.log_likelihood == pytest.approx(ref.log_likelihood,
                                               rel=1e-6)
