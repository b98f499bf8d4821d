"""The port's batch scorer against the JAX package's.

``batch_log_likelihood`` scores a tree-search neighbourhood in one launch
of kernel 2 or 2m with a candidate axis (``ops/plf_tree.py::
plf_tree_batch``); on the CPU its plain version runs candidate by
candidate.  Held here against ``plf_tpu.models.phylo.batch_log_likelihood``
(its tree kernel in interpret mode under ``lax.map``) on an NNI
neighbourhood plus the incumbent, against the port's own single-model
``log_likelihood()``, and by its capacity rule."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.models import PhyloModel as JPM  # noqa: E402
from plf_tpu.models import codon_gy94 as jgy  # noqa: E402
from plf_tpu.models import empirical_protein as jprot  # noqa: E402
from plf_tpu.models import hky85 as jhky  # noqa: E402
from plf_tpu.models import nni_neighbors as jnni  # noqa: E402
from plf_tpu.models import random_tree as jrt  # noqa: E402
from plf_tpu.models.phylo import batch_log_likelihood as jbatch  # noqa: E402
from plf_tpu_torch import PLFConfig  # noqa: E402
from plf_tpu_torch.models import (PhyloModel, codon_gy94,  # noqa: E402
                                  empirical_protein, hky85, nni_neighbors,
                                  random_tree, simulate_alignment)
from plf_tpu_torch.models import phylo as TP  # noqa: E402
from plf_tpu_torch.ops import plf_tree as TT  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests chain many small torch ops on the CPU (the plain
    versions of the kernels); under the suite's parallel workers one
    intra-op thread per worker keeps them from oversubscribing the cores
    (the default, one thread per core in every worker, ran them up to 100
    times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

#: name -> (states, taxa, sites, highest tip code + 1, tree seed)
CASES = {"dna": (4, 8, 256, 14, 5), "protein": (20, 6, 128, 23, 5),
         "codon": (61, 5, 64, 61, 5)}


def _models(name, jax_pkg):
    S = CASES[name][0]
    if jax_pkg:
        return {4: lambda: jhky(2.0), 20: lambda: jprot("lg"),
                61: lambda: jgy(2.0, 0.5)}[S]()
    return {4: lambda: hky85(2.0), 20: lambda: empirical_protein("lg"),
            61: lambda: codon_gy94(2.0, 0.5)}[S]()


def _tips(name):
    """Random codes with IUPAC ambiguity and a gap column (DNA, protein);
    GY94-simulated codons (random codons cancel past fp32: ROADMAP queue
    3)."""
    S, taxa, sites, codes, seed = CASES[name]
    if S == 61:
        return simulate_alignment(random_tree(taxa, seed=seed),
                                  codon_gy94(2.0, 0.5), sites, alpha=0.6,
                                  seed=seed)
    tips = np.random.default_rng(seed).integers(-1, codes,
                                                size=(taxa, sites))
    tips[:, 3] = -1                                  # a gap column
    return tips


def _port_batch(name, variant, tip_dtype="int32"):
    """The incumbent (``random_tree``) and its NNI neighbours as port
    models sharing the incumbent's device tensors."""
    S, taxa, _, _, seed = CASES[name]
    tree = random_tree(taxa, seed=seed)
    model, tips = _models(name, False), _tips(name)
    cfg = PLFConfig(states=S, block_sites=128, kernel_variant=variant,
                    tip_dtype=tip_dtype)
    pm0 = PhyloModel(tree, model, tips, alpha=0.5, config=cfg, device="cpu")
    return [pm0] + [PhyloModel(t, model, tips, alpha=0.5, config=cfg,
                               share_device_from=pm0, device="cpu")
                    for t in nni_neighbors(tree)]


def _jax_batch(name, variant):
    S, taxa, _, _, seed = CASES[name]
    tree = jrt(taxa, seed=seed)
    model, tips = _models(name, True), _tips(name)
    cfg = JCfg(states=S, block_sites=128, interpret=True,
               kernel_variant=variant)
    pm0 = JPM(tree, model, tips, alpha=0.5, config=cfg)
    pms = [pm0] + [JPM(t, model, tips, alpha=0.5, config=cfg,
                       share_device_from=pm0) for t in jnni(tree)]
    return jbatch(pms)


@pytest.mark.parametrize("name,variant", [("dna", "vpu"),
                                          ("protein", "mxu"),
                                          ("protein", "mxu_3x"),
                                          ("codon", "mxu")])
def test_batch_matches_jax(name, variant):
    """rtol 5e-5, the bar tests/test_torch_tree.py holds the tree kernels
    to against JAX's interpret-mode tree kernels on the CPU (FMA drift of
    XLA:CPU).  "mxu_3x" is held to its own class measured in this run: the
    largest distance of JAX's "mxu_3x" batch from JAX's "mxu" batch (its
    bf16 split is a step function of fp32 inputs that the two packages
    round in different orders; ROADMAP queue 3).  Codons are held in
    "mxu" (ROADMAP queue 3: "mxu_3x" diverges on random codons)."""
    pms = _port_batch(name, variant)
    assert len(pms) > 4 and TP.batch_fits(pms)
    got = TP.batch_log_likelihood(pms)
    want = _jax_batch(name, variant)
    assert got.shape == want.shape == (len(pms),) and got.dtype == np.float64
    if variant == "mxu_3x":
        bar = np.abs(want - _jax_batch(name, "mxu")).max()
        assert np.abs(got - want).max() <= bar
    else:
        np.testing.assert_allclose(got, want, rtol=5e-5)


@pytest.mark.parametrize("name,variant,tip_dtype", [
    ("dna", "vpu", "int32"), ("dna", "vpu", "int8"), ("dna", "mxu_3x", "int32"),
    ("protein", "mxu", "int32"), ("protein", "mxu_3x", "int32"),
    ("protein", "mxu_bf16", "int32"), ("protein", "vpu", "int32"),
    ("codon", "mxu_3x", "int32")])
def test_batch_rows_equal_each_log_likelihood(name, variant, tip_dtype):
    """Each row equals the candidate's own ``log_likelihood()`` within rtol
    1e-6: the same site likelihoods (the plain batch runs each
    candidate's program on the operator table, which holds the same
    encodings bit for bit), summed as fp32 chunks of ``block_sites`` sites
    against the host's fp64 sum."""
    pms = _port_batch(name, variant, tip_dtype)
    got = TP.batch_log_likelihood(pms)
    want = np.array([pm.log_likelihood().log_likelihood for pm in pms])
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name,variant", [("dna", "vpu"),
                                          ("protein", "mxu_3x"),
                                          ("codon", "mxu")])
def test_batch_plain_rows_equal_single_tree_bit_for_bit(name, variant):
    """The plain batch's row b equals the single-tree plain version on
    candidate b's own operators and program, likelihoods and scaler
    counts bit for bit (the card's test: tests/test_torch_cuda.py); the
    operator table holds fewer entries than the candidates' edges."""
    pms = _port_batch(name, variant)
    progs, lcs, rcs, planes, n_slots = TP.batch_inputs(pms)
    pm0 = pms[0]
    cfg = pm0.config
    E = len(pm0.schedule)
    assert progs.shape == (len(pms), 6, E)
    assert lcs.shape[0] < len(pms) * E
    assert n_slots == max(pm.fused_slots for pm in pms)
    kw = dict(states=cfg.states, categories=cfg.categories,
              variant=variant)
    lik, sc = TT.plf_tree_batch(pm0.codes, progs, lcs, rcs, pm0.ec,
                                pm0.fused_tip_table, pm0.root_rows[0],
                                pm0.n_sites, n_slots=n_slots, planes=planes,
                                **kw)
    assert lik.shape == sc.shape == (len(pms), pm0.n_pad)
    for b, pm in enumerate(pms):
        one = TT.plf_tree(pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec,
                          pm.fused_tip_table, pm.root_rows[0], pm.n_sites,
                          n_slots=pm.n_slots, root_slot=pm.root_slot,
                          planes=pm._planes(), **kw)
        assert torch.equal(lik[b], one[0][0]) and torch.equal(sc[b],
                                                              one[1][0])


def test_batch_does_not_fit_by_rule(monkeypatch):
    """The batch fits where ``can_fuse()`` holds at its largest arena;
    past it ``batch_log_likelihood`` raises ValueError ("does not fit")
    before any launch, and a model whose config chose Backend.TORCH is
    refused (the batch runs a kernel)."""
    pms = _port_batch("dna", "vpu")
    slots = [pm.fused_slots for pm in pms]
    top = max(slots)
    monkeypatch.setattr(TP, "tree_fused_threads",
                        lambda s, *a: None if s >= top else 128)
    assert not TP.batch_fits(pms)
    assert any(pm.can_fuse() for pm in pms) == (min(slots) < top)
    calls = []
    monkeypatch.setattr(TP, "batched_tree_loglik_parts",
                        lambda *a, **k: calls.append(1))
    with pytest.raises(ValueError, match="does not fit"):
        TP.batch_log_likelihood(pms)
    assert not calls
    monkeypatch.undo()
    from plf_tpu_torch.config import Backend
    tree = random_tree(6, seed=1)
    cfg = PLFConfig(block_sites=128, backend=Backend.TORCH)
    pm = PhyloModel(tree, hky85(2.0), _tips("dna")[:6], config=cfg,
                    device="cpu")
    assert not TP.batch_fits([pm, pm])
    with pytest.raises(ValueError, match="Backend.TORCH"):
        TP.batch_log_likelihood([pm, pm])


def test_batch_rejects_mixed_alignments():
    """Same shape, different data: refused (JAX's
    ``_validate_batch_identity``), as is a mixed shape."""
    pms = _port_batch("dna", "vpu")
    other = PhyloModel(pms[1].tree, pms[0].model, _tips("dna")[::-1].copy(),
                       alpha=0.5, config=pms[0].config, device="cpu")
    with pytest.raises(ValueError, match="identical alignment"):
        TP.batch_log_likelihood([pms[0], other])
    small = PhyloModel(random_tree(5, seed=2), pms[0].model,
                       _tips("dna")[:5], alpha=0.5, config=pms[0].config,
                       device="cpu")
    with pytest.raises(ValueError, match="same-shape"):
        TP.batch_log_likelihood([pms[0], small])
    with pytest.raises(ValueError, match="identical alignment"):
        TP.batch_log_likelihood_segmented([pms[0], other])
    with pytest.raises(ValueError, match="same-shape"):
        TP.batch_log_likelihood_segmented([pms[0], small])
