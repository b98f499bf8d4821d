"""The codon (GY94, S = 61) part of the port against the JAX package: the
genetic code and codon tables, the model arrays, F3x4, codon encoding,
``simulate_alignment``, a codon model carried by value, the 61-state
likelihood against JAX's XLA backend and ``fit_codon`` against JAX's on the
same input.  Tolerances are stated per test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

from plf_tpu.config import Backend  # noqa: E402
from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.models import PhyloModel as JPM  # noqa: E402
from plf_tpu.models import random_tree as jrt  # noqa: E402
from plf_tpu.models import simulate as JSim  # noqa: E402
from plf_tpu.models import substitution as JS  # noqa: E402
from plf_tpu.models.optimize import fit_codon as j_fit_codon  # noqa: E402
from plf_tpu.models.optimize import tree_loglik_fn as j_tree_loglik_fn  # noqa: E402
from plf_tpu_torch import convert  # noqa: E402
from plf_tpu_torch.config import PLFConfig  # noqa: E402
from plf_tpu_torch.models import (PhyloModel, fit_codon,  # noqa: E402
                                  random_tree, simulate_alignment,
                                  tree_loglik_fn)
from plf_tpu_torch.models import substitution as TS  # noqa: E402

S = 61


def _model_arrays(m):
    return (m.pi, m.eigenvalues, m.u, m.w)


def test_genetic_code_and_sense_codons_equal_jax():
    assert TS.GENETIC_CODE == JS.GENETIC_CODE
    assert TS.SENSE_CODONS == JS.SENSE_CODONS and len(TS.SENSE_CODONS) == S
    assert not {"TAA", "TAG", "TGA"} & set(TS.SENSE_CODONS)


POS_FREQS = np.array([[.3, .2, .3, .2], [.25, .25, .25, .25],
                      [.2, .3, .2, .3]])


@pytest.mark.parametrize("kappa,omega,biased", [(2.0, 1.0, False),
                                                (2.5, 0.2, True),
                                                (4.0, 0.05, True)])
def test_gy94_arrays_equal_jax(kappa, omega, biased):
    """The same NumPy code on the same inputs: every array bit for bit,
    F3x4 frequencies included."""
    pi_t = TS.f3x4_frequencies(POS_FREQS) if biased else None
    pi_j = JS.f3x4_frequencies(POS_FREQS) if biased else None
    if biased:
        np.testing.assert_array_equal(pi_t, pi_j)
    mt, mj = TS.codon_gy94(kappa, omega, pi_t), JS.codon_gy94(kappa, omega,
                                                              pi_j)
    assert mt.states == S
    for a, b in zip(_model_arrays(mt), _model_arrays(mj)):
        np.testing.assert_array_equal(a, b)


def test_encoding_and_f3x4_from_codes_equal_jax():
    """encode_codon_alignment (stops and gap bases to 61) and
    f3x4_from_codes (gaps ignored, with and without site weights) equal
    the JAX functions exactly."""
    rng = np.random.default_rng(9)
    dna = rng.integers(-1, 4, size=(5, 3 * 200))
    dna[:, :12] = [0, 0, 0, 3, 2, 0, -1, 1, 2, 3, 0, 2]  # AAA TGA ?CG TAG
    ct, cj = TS.encode_codon_alignment(dna), JS.encode_codon_alignment(dna)
    np.testing.assert_array_equal(ct, cj)
    assert ct.dtype == cj.dtype and list(ct[0, :4]) == [0, 61, 61, 61]
    wgt = rng.integers(1, 4, size=200)
    for w in (None, wgt):
        np.testing.assert_array_equal(TS.f3x4_from_codes(ct, w),
                                      JS.f3x4_from_codes(cj, w))
    with pytest.raises(ValueError, match="codon multiple"):
        TS.encode_codon_alignment(dna[:, :7])


@pytest.mark.parametrize("states,kw", [(61, dict(alpha=0.5)),
                                       (4, dict(alpha=0.7, p_inv=0.3))])
def test_simulate_alignment_equals_jax(states, kw):
    """The same seed gives the JAX package's alignment, codon by codon."""
    tree_t, tree_j = random_tree(7, seed=4), jrt(7, seed=4)
    mt = TS.codon_gy94(3.0, 0.4) if states == 61 else TS.hky85(2.0)
    mj = JS.codon_gy94(3.0, 0.4) if states == 61 else JS.hky85(2.0)
    at = simulate_alignment(tree_t, mt, 300, seed=11, **kw)
    aj = JSim.simulate_alignment(tree_j, mj, 300, seed=11, **kw)
    np.testing.assert_array_equal(at, aj)
    assert at.dtype == np.int8 and at.max() < states


def _jax_codon(n_leaves=5, n_sites=200, variant="mxu", backend=None,
               seed=5):
    tree = jrt(n_leaves, seed=seed, mean_branch=0.2)
    model = JS.codon_gy94(2.0, 0.3)
    tips = JSim.simulate_alignment(tree, model, n_sites, alpha=0.6,
                                   seed=seed)
    kw = {} if backend is None else dict(backend=backend)
    cfg = JCfg(states=S, categories=4, block_sites=128, interpret=True,
               kernel_variant=variant, **kw)
    return JPM(tree, model, tips, alpha=0.6, config=cfg)


def _port_of(pm, variant):
    return convert.phylo_model(
        pi=pm.model.pi, eigenvalues=pm.model.eigenvalues, u=pm.model.u,
        w=pm.model.w, nodes=[(n.index, n.name, n.length, n.children)
                             for n in pm.tree.nodes], root=pm.tree.root,
        rates=pm.rates, tip_states=pm.tip_states, wgt=pm.wgt,
        config=PLFConfig(states=S, block_sites=128, kernel_variant=variant),
        device="cpu")


def test_convert_carries_a_codon_model():
    """By value: a JAX codon model's eigensystem, rates and tips give the
    port's own codon model's operators, tip tables and likelihood bit for
    bit, with the gap code 61 in the tips."""
    pm = _jax_codon()
    pm.tip_states[:, :3] = 61
    pt = _port_of(pm, "mxu")
    own = PhyloModel(random_tree(5, seed=5, mean_branch=0.2),
                     TS.codon_gy94(2.0, 0.3), pm.tip_states, alpha=0.6,
                     config=PLFConfig(states=S, block_sites=128,
                                      kernel_variant="mxu"), device="cpu")
    for name in ("lcs", "rcs", "ec", "tip_table", "fused_tip_table",
                 "root_rows", "codes"):
        assert torch.equal(getattr(pt, name), getattr(own, name)), name
    assert pt.tip_table.shape == (S * 4, S + 1)
    assert pt.log_likelihood().log_likelihood == \
        own.log_likelihood().log_likelihood


@pytest.mark.parametrize("variant", ["mxu", "mxu_3x"])
def test_codon_likelihood_matches_jax_xla(variant):
    """The 61-state likelihood, fused (kernel 2m's plain version) and
    per-node, against JAX's XLA backend (rel 1e-5 in "mxu"; 1e-4 in
    "mxu_3x", which drops the lo*lo term) and the float64 brute force;
    fused == per-node (rel 1e-12 in "mxu", 1e-5 in "mxu_3x") and "tree"
    values within rel 1e-5 of log_likelihood()."""
    pm = _jax_codon(backend=Backend.XLA)
    ll_x = pm.log_likelihood().log_likelihood
    pt = _port_of(pm, variant)
    fused = pt.log_likelihood(method="fused").log_likelihood
    pernode = pt.log_likelihood(method="per-node").log_likelihood
    rel = 1e-5 if variant == "mxu" else 1e-4
    assert fused == pytest.approx(ll_x, rel=rel)
    assert fused == pytest.approx(pt.log_likelihood_bruteforce(), rel=rel)
    assert fused == pytest.approx(
        pernode, rel=1e-12 if variant == "mxu" else 1e-5)
    fn, t0 = tree_loglik_fn(pt, backend="tree")
    with torch.no_grad():
        assert float(fn(t0)) == pytest.approx(fused, rel=1e-5)


def test_fit_codon_matches_jax():
    """fit_codon's profile search (4 taxa x 200 simulated codons, omega
    0.3, kappa 2, lengths held) on the port (CPU: kernel 2m's plain
    version per candidate) against JAX's (XLA) on the same input: the same
    F3x4 frequencies bit for bit, omega and kappa within rel 1e-6 (the
    golden-section searches take the same path unless two candidates tie
    within fp32 rounding) and the log-likelihood within rel 1e-6.  JAX's
    branch-length fit is left out: it compiles for ~25 s per model here."""
    tree = jrt(4, seed=2, mean_branch=0.2)
    tips = JSim.simulate_alignment(tree, JS.codon_gy94(2.0, 0.3), 200,
                                   seed=4)
    kw = dict(rounds=1, iters=3, fit_lengths=False)
    _, ij = j_fit_codon(tree, tips,
                        config=JCfg(states=S, block_sites=128,
                                    kernel_variant="mxu",
                                    backend=Backend.XLA), **kw)
    _, it = fit_codon(random_tree(4, seed=2, mean_branch=0.2), tips,
                      config=PLFConfig(states=S, block_sites=128,
                                       kernel_variant="mxu"),
                      device="cpu", **kw)
    np.testing.assert_array_equal(it["pi"], ij["pi"])
    for key in ("omega", "kappa", "ll"):
        assert it[key] == pytest.approx(ij[key], rel=1e-6), key
    np.testing.assert_array_equal(it["lengths"], ij["lengths"])


def test_fit_codon_fits_lengths_through_tree_loglik_fn():
    """With lengths fitted (5 taxa x 300 codons, CPU, "torch" steps: the
    auto backend off the card): the fitted lengths are positive and carried
    into the returned tree, and they raise the likelihood above the same
    search with the simulated lengths held."""
    tree = random_tree(5, seed=2, mean_branch=0.2)
    tips = simulate_alignment(tree, TS.codon_gy94(2.0, 0.3), 300, seed=4)
    cfg = PLFConfig(states=S, block_sites=128, kernel_variant="mxu")
    kw = dict(rounds=1, iters=4, config=cfg, device="cpu")
    model, info = fit_codon(tree, tips, length_steps=10, **kw)
    _, held = fit_codon(tree, tips, fit_lengths=False, **kw)
    assert model.states == S and np.all(info["lengths"] > 0)
    np.testing.assert_allclose(
        [info["tree"].nodes[i].length for i in range(len(info["lengths"]))],
        info["lengths"], rtol=1e-6)
    assert info["ll"] > held["ll"]
    assert 0.05 < info["omega"] < 2.0 and 0.5 < info["kappa"] < 8.0


def test_random_codon_witness():
    """The first 1,024 codons of chip_smoke.py's random-codon workload (32
    taxa, GY94 kappa 2 omega 0.3 + G4 alpha 0.7): the witness for the
    limits that script holds the card to, RANDOM_CODON_DISTANCES.

    Random codons cancel their eigen-coordinate sums below fp32 (and far
    below bf16x3's ~16-bit operands), so a site's value is a step function
    of its fp32 rounding, and XLA:CPU's rounding differs from one CPU to
    another: JAX's "mxu_3x" sites equal the port's plain versions on one
    machine and sit up to 83 apart at 823 of 1,024 sites on another, and
    its fused-vs-per-node distance moves from 2.65e-4 to 2.42e-4.  So:

    * exact, and machine-independent (plain torch, elementwise fp32): the
      port's "mxu" fused path equals its per-node path site for site,
      rescale counts included, and the port's own distances equal
      RANDOM_CODON_DISTANCES within rel 1e-3;
    * across the packages, within the variant's class measured here: each
      port total within twice JAX's own distance from the float64 brute
      force in that variant, and JAX's distances within a factor of two of
      RANDOM_CODON_DISTANCES (the reference lands in the same class).

    Run with -s to print both packages' distances."""
    import chip_smoke as smoke

    tips = smoke.random_codon_tips()[:, :smoke.CODON_BRUTE_SITES]
    tree = jrt(smoke.CODON_TAXA, seed=3)
    gy = JS.codon_gy94(kappa=2.0, omega=0.3)
    jm = {v: JPM(tree, gy, tips, alpha=0.7,
                 config=JCfg(states=S, kernel_variant=v))
          for v in ("mxu", "mxu_3x")}
    pt = {v: PhyloModel(random_tree(smoke.CODON_TAXA, seed=3),
                        TS.codon_gy94(kappa=2.0, omega=0.3), tips, alpha=0.7,
                        config=PLFConfig(states=S, kernel_variant=v),
                        device="cpu")
          for v in ("mxu", "mxu_3x")}
    bf = pt["mxu"].log_likelihood_bruteforce()
    assert bf == pytest.approx(jm["mxu"].log_likelihood_bruteforce(),
                               rel=1e-12)

    def distances(m, step_fn):
        ll = {v: m[v].log_likelihood(method="fused") for v in m}
        per_node = m["mxu_3x"].log_likelihood(method="per-node")
        fn, t0 = step_fn(m["mxu"])
        with torch.no_grad():
            step = float(fn(t0))
        return ll, per_node, dict(
            bf_mxu=abs(ll["mxu"].log_likelihood / bf - 1),
            bf_mxu_3x=abs(ll["mxu_3x"].log_likelihood / bf - 1),
            per_node_mxu_3x=abs(ll["mxu_3x"].log_likelihood
                                / per_node.log_likelihood - 1),
            step=abs(step / ll["mxu"].log_likelihood - 1))

    ll_j, pn_j, got_j = distances(
        jm, lambda m: j_tree_loglik_fn(m, backend="xla"))
    ll_t, pn_t, got_t = distances(
        pt, lambda m: tree_loglik_fn(m, backend="tree"))
    for who, got in (("JAX", got_j), ("port", got_t)):
        print(f"{who} on the random-codon slice:",
              {k: f"{x:.4g}" for k, x in got.items()})
    pn = pt["mxu"].log_likelihood(method="per-node")
    np.testing.assert_array_equal(ll_t["mxu"].site_log_likelihood,
                                  pn.site_log_likelihood)
    assert ll_t["mxu"].scaler_total == pn.scaler_total
    for key, want in smoke.RANDOM_CODON_DISTANCES.items():
        assert got_t[key] == pytest.approx(want, rel=1e-3), key
        assert want / 2 <= got_j[key] <= 2 * want, key
    for v, a, b in (("mxu", ll_t["mxu"], ll_j["mxu"]),
                    ("mxu_3x", ll_t["mxu_3x"], ll_j["mxu_3x"]),
                    ("mxu_3x", pn_t, pn_j)):
        assert abs(a.log_likelihood / b.log_likelihood - 1) \
            <= 2 * got_j[f"bf_{v}"], v
