"""The port's PhyloModel against the JAX package's: operator encodings
carried by convert.py (bit-equal), log-likelihoods on the fused and
per-node paths, +I / Lewis / rate weights, a >96-node tree, and the path
routing."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

from plf_tpu.config import Backend, PLFConfig  # noqa: E402
from plf_tpu.models import PhyloModel, hky85, jc69, random_tree  # noqa: E402
from plf_tpu_torch import convert  # noqa: E402
from plf_tpu_torch.config import Backend as TBackend  # noqa: E402
from plf_tpu_torch.config import PLFConfig as TCfg  # noqa: E402
from plf_tpu_torch.models import phylo as TP  # noqa: E402
from plf_tpu_torch.ops.plf_tree import root_reduce  # noqa: E402

VARIANTS = {
    "gamma": dict(alpha=0.5),
    "uniform": dict(),
    "lewis": dict(alpha=0.7, ascertainment="lewis"),
    "pinv": dict(alpha=0.5, p_inv=0.2),
    "rate_weights": dict(alpha=0.8, rate_weights=[0.1, 0.2, 0.3, 0.4]),
    "int8": dict(alpha=0.5, tip_dtype="int8"),
}


def _tips(n_leaves, n_sites, seed, iupac=True):
    rng = np.random.default_rng(seed)
    tips = rng.integers(-1, 14 if iupac else 4, size=(n_leaves, n_sites))
    tips[:, 5] = -1                                     # a gap column
    return tips


def _jax_model(variant, n_leaves=7, n_sites=256, seed=12, backend=None,
               model=None):
    kw = dict(VARIANTS[variant])
    tip_dtype = kw.pop("tip_dtype", "int32")
    cfg = PLFConfig(block_sites=128, interpret=True, tip_dtype=tip_dtype,
                    **({} if backend is None else {"backend": backend}))
    return PhyloModel(random_tree(n_leaves, seed=seed),
                      model or hky85(2.0, [0.3, 0.2, 0.3, 0.2]),
                      _tips(n_leaves, n_sites, seed), config=cfg, **kw)


def _port_of(pm, device="cpu", backend=TBackend.KERNEL, **kw):
    """The port's model of a JAX PhyloModel, through convert.py."""
    n_obs = pm.n_sites_obs
    return convert.phylo_model(
        pi=pm.model.pi, eigenvalues=pm.model.eigenvalues, u=pm.model.u,
        w=pm.model.w,
        nodes=[(n.index, n.name, n.length, n.children)
               for n in pm.tree.nodes], root=pm.tree.root,
        rates=pm.rates, rate_weights=pm.rate_weights,
        tip_states=pm.tip_states[:, :n_obs], wgt=pm.wgt[:n_obs],
        ascertainment=pm.ascertainment,
        config=TCfg(block_sites=pm.config.block_sites,
                    tip_dtype=pm.config.tip_dtype, backend=backend),
        device=device, **kw)


def _close(a, b, site_atol=5e-5):
    """Same scaler totals; site log-likelihoods within 5e-5 absolute (the
    JAX CPU kernels' FMA-contraction error, see test_torch_tree.py);
    totals within 1e-6 relative."""
    assert a.scaler_total == b.scaler_total
    np.testing.assert_allclose(a.site_log_likelihood,
                               b.site_log_likelihood, rtol=0,
                               atol=site_atol)
    assert abs(a.log_likelihood - b.log_likelihood) < \
        1e-6 * abs(b.log_likelihood) + 1e-6


# ------------------------------------------------------- convert encodings --

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_convert_encodings_bit_equal(variant):
    pm = _jax_model(variant)
    pt = _port_of(pm)
    assert pt.config.categories == pm.config.categories
    assert pt.n_pad == pm.n_pad and pt.n_sites == pm.n_sites
    np.testing.assert_array_equal(pt.rates, pm.rates)
    np.testing.assert_array_equal(pt.rate_weights, pm.rate_weights)
    np.testing.assert_array_equal(pt.lcs.numpy(), pm._lcs_np)
    np.testing.assert_array_equal(pt.rcs.numpy(), pm._rcs_np)
    np.testing.assert_array_equal(pt.ec.numpy(), np.asarray(pm._ec))
    np.testing.assert_array_equal(pt.tip_table.numpy(),
                                  np.asarray(pm._kernel_tip_table()))
    np.testing.assert_array_equal(pt.root_rows.numpy(),
                                  np.asarray(pm._root_rows))
    np.testing.assert_array_equal(pt.codes.numpy(), np.asarray(pm._codes))
    assert pt.codes.dtype == {"int32": torch.int32,
                              "int8": torch.int8}[pm.config.tip_dtype]
    np.testing.assert_array_equal(pt.wgt_pad.numpy(),
                                  np.asarray(pm._wgt_dev))


def test_convert_from_newick_and_own_rates_equal():
    from plf_tpu_torch.models import PhyloModel as TPM
    from plf_tpu_torch.models import hky85 as thky
    from plf_tpu_torch.models import parse_newick
    nwk = "((A:0.1,B:0.2):0.05,(C:0.3,(D:0.1,E:0.02):0.2):0.02);"
    m = hky85(2.0)
    tips = _tips(5, 200, 3)
    pt = convert.phylo_model(pi=m.pi, eigenvalues=m.eigenvalues, u=m.u,
                             w=m.w, newick=nwk, tip_states=tips,
                             rates=PhyloModel(parse_newick(nwk), m, tips,
                                              alpha=0.5).rates, device="cpu")
    own = TPM(parse_newick(nwk), thky(2.0), tips, alpha=0.5, device="cpu")
    assert torch.equal(pt.lcs, own.lcs) and torch.equal(pt.rcs, own.rcs)
    assert pt.log_likelihood().log_likelihood == \
        own.log_likelihood().log_likelihood
    with pytest.raises(ValueError):
        convert.phylo_model(pi=m.pi, eigenvalues=m.eigenvalues, u=m.u,
                            w=m.w, newick=nwk, nodes=[], tip_states=tips,
                            rates=[1.0])


# ------------------------------------------------------- log-likelihoods --

@pytest.mark.parametrize("method", ["fused", "per-node"])
def test_log_likelihood_matches_jax_fused(method):
    pm = _jax_model("gamma")
    ref = pm.log_likelihood(method="fused")
    out = _port_of(pm).log_likelihood(method=method)
    _close(out, ref)
    bf = pm.log_likelihood_bruteforce()
    assert abs(out.log_likelihood - bf) / abs(bf) < 1e-5


@pytest.mark.parametrize("variant", ["lewis", "pinv", "rate_weights",
                                     "uniform", "int8"])
@pytest.mark.parametrize("method", ["fused", "per-node"])
def test_features_match_jax_xla_per_node(variant, method):
    pm = _jax_model(variant, backend=Backend.XLA)
    ref = pm.log_likelihood(method="per-node")
    pt = _port_of(pm)
    out = pt.log_likelihood(method=method)
    _close(out, ref)
    np.testing.assert_array_equal(out.scaler_sites, ref.scaler_sites)
    assert pt.log_likelihood_bruteforce() == pm.log_likelihood_bruteforce()


def test_fused_and_per_node_agree_on_deep_underflow():
    """A 24-leaf caterpillar rescales many sites; both port paths agree
    (test_tree_kernel.py:50-59 bound) and match the brute force."""
    from plf_tpu_torch.models import PhyloModel as TPM, jc69 as tjc
    from plf_tpu_torch.models import parse_newick
    nwk = "A0:0.1"
    for i in range(1, 24):
        nwk = f"({nwk},A{i}:0.1):0.1"
    pt = TPM(parse_newick(nwk + ";"), tjc(), _tips(24, 256, 5, iupac=False),
             config=TCfg(block_sites=128), device="cpu")
    fused = pt.log_likelihood(method="fused")
    pernode = pt.log_likelihood(method="per-node")
    assert fused.scaler_total == pernode.scaler_total > 0
    np.testing.assert_allclose(fused.site_log_likelihood,
                               pernode.site_log_likelihood, rtol=1e-6)
    # both reduce the root in the same sequential fp32 order: bit-equal
    np.testing.assert_array_equal(fused.site_log_likelihood,
                                  pernode.site_log_likelihood)
    bf = pt.log_likelihood_bruteforce()
    assert abs(fused.log_likelihood - bf) / abs(bf) < 1e-4


def test_large_tree_matches_xla_and_bruteforce():
    """A 120-leaf tree (119 nodes, past the JAX unrolled kernel's 96: the
    dynamic path) against the JAX XLA per-node path and the float64 brute
    force."""
    tree = random_tree(120, seed=8)
    tips = np.random.default_rng(8).integers(0, 4, size=(120, 128))
    pm = PhyloModel(tree, jc69(), tips,
                    config=PLFConfig(block_sites=128, backend=Backend.XLA))
    assert len(pm.schedule) > pm.FUSED_UNROLL_MAX_NODES
    ref = pm.log_likelihood(method="per-node")
    pt = _port_of(pm)
    assert pt.can_fuse()
    out = pt.log_likelihood()
    _close(out, ref)
    bf = pm.log_likelihood_bruteforce()
    assert abs(out.log_likelihood - bf) / abs(bf) < 1e-5
    assert out.scaler_total == pt.log_likelihood(
        method="per-node").scaler_total


# --------------------------------------------------------------- routing --

class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


@pytest.fixture
def spies(monkeypatch):
    tree_spy, node_spy = _Spy(TP.plf_tree), _Spy(TP.plf_node)
    monkeypatch.setattr(TP, "plf_tree", tree_spy)
    monkeypatch.setattr(TP, "plf_node", node_spy)
    return tree_spy, node_spy


def test_auto_takes_the_fused_kernel(spies):
    tree_spy, node_spy = spies
    pt = _port_of(_jax_model("gamma"))
    assert pt.can_fuse()
    pt.log_likelihood()
    assert (tree_spy.calls, node_spy.calls) == (1, 0)
    pt.log_likelihood(method="per-node")
    assert (tree_spy.calls, node_spy.calls) == (1, len(pt.schedule))


def test_auto_falls_back_to_per_node_past_capacity(spies, monkeypatch):
    """Past kernel 2's capacity auto takes the segmented kernel (7), which
    takes a DNA "vpu" model, and the per-node path where that does not
    apply either."""
    tree_spy, node_spy = spies
    seg_spy = _Spy(TP.plf_tree_seg)
    monkeypatch.setattr(TP, "plf_tree_seg", seg_spy)
    pt = _port_of(_jax_model("gamma"))
    monkeypatch.setattr(TP, "tree_fused_threads", lambda *a: None)
    assert not pt.can_fuse() and pt.can_segment()
    pt.log_likelihood()
    assert (tree_spy.calls, seg_spy.calls, node_spy.calls) == (0, 1, 0)
    monkeypatch.setattr(TP.PhyloModel, "can_segment", lambda self: False)
    pt.log_likelihood()
    assert (tree_spy.calls, seg_spy.calls, node_spy.calls) == (
        0, 1, len(pt.schedule))


def test_keep_root_clv_takes_per_node(spies):
    tree_spy, _ = spies
    pt = _port_of(_jax_model("gamma"))
    res = pt.log_likelihood(keep_root_clv=True)
    assert tree_spy.calls == 0
    assert res.root_clv.shape == (pt.config.rows, pt.n_pad)
    lik = root_reduce(pt.root_rows[0], res.root_clv)[:pt.n_sites_obs]
    np.testing.assert_allclose(np.log(lik.double().numpy()),
                               res.site_log_likelihood, rtol=1e-12)


def test_unported_paths_raise():
    """The sharded path runs (on a one-rank mesh it equals
    ``log_likelihood()`` site for site); bf16 CLV storage now runs, and on the
    fused and per-node paths, which ignore it, equals the fp32 model site
    for site; the MXU variants run on the fused and per-node paths, which
    agree, and on the segmented path, which equals the fused one site for
    site."""
    pt = _port_of(_jax_model("gamma"))
    sharded, plain = pt.log_likelihood_sharded(), pt.log_likelihood()
    assert sharded.log_likelihood == plain.log_likelihood
    np.testing.assert_array_equal(sharded.site_log_likelihood,
                                  plain.site_log_likelihood)
    with pytest.raises(ValueError):
        pt.log_likelihood(method="bogus")
    pm = _jax_model("gamma")
    port = lambda cfg: convert.phylo_model(
        pi=pm.model.pi, eigenvalues=pm.model.eigenvalues, u=pm.model.u,
        w=pm.model.w, newick="((A,B),C);", tip_states=_tips(3, 10, 1),
        rates=[1.0], config=cfg, device="cpu")
    bf16, f32 = port(TCfg(dtype="bfloat16")), port(TCfg())
    for method in ("fused", "per-node"):
        a, b = (m.log_likelihood(method=method) for m in (bf16, f32))
        assert np.isfinite(a.log_likelihood)
        np.testing.assert_array_equal(a.site_log_likelihood,
                                      b.site_log_likelihood)
    for variant in ("mxu", "mxu_3x", "mxu_bf16"):
        pv = port(TCfg(kernel_variant=variant))
        fused = pv.log_likelihood(method="fused")
        pernode = pv.log_likelihood(method="per-node")
        assert np.isfinite(fused.log_likelihood)
        assert fused.scaler_total == pernode.scaler_total
        np.testing.assert_allclose(fused.site_log_likelihood,
                                   pernode.site_log_likelihood, rtol=1e-6)
        seg = pv.log_likelihood(method="segmented")
        np.testing.assert_array_equal(seg.site_log_likelihood,
                                      fused.site_log_likelihood)


@pytest.mark.parametrize("variant", ["gamma", "lewis", "pinv", "int8"])
def test_backend_torch_runs_the_plain_path(variant, monkeypatch):
    """PLFConfig(backend=Backend.TORCH) is the user's choice of the plain
    path, as Backend.XLA is in the JAX package (plf_tpu/models/
    phylo.py:445-446, :550, :332): can_fuse and can_segment are False,
    log_likelihood() runs ops/plf_torch.py node by node and no kernel
    wrapper is reached (plf_tree, plf_tree_seg and plf_node raise here);
    "fused" and "segmented" refuse.  Against the JAX Backend.XLA model:
    equal rescale counts site by site, site log-likelihoods within 5e-5
    and the total within 5e-5 relative."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called")

    for name in ("plf_tree", "plf_tree_seg", "plf_node"):
        monkeypatch.setattr(TP, name, refuse)
    pm = _jax_model(variant, backend=Backend.XLA)
    assert not pm.can_fuse() and not pm.can_segment()
    pt = _port_of(pm, backend=TBackend.TORCH)
    assert not pt.can_fuse() and not pt.can_segment()
    ref = pm.log_likelihood()
    out = pt.log_likelihood()
    assert out.scaler_total == ref.scaler_total
    np.testing.assert_array_equal(out.scaler_sites, ref.scaler_sites)
    np.testing.assert_allclose(out.site_log_likelihood,
                               ref.site_log_likelihood, rtol=0, atol=5e-5)
    assert out.log_likelihood == pytest.approx(ref.log_likelihood, rel=5e-5)
    kept = pt.log_likelihood(keep_root_clv=True)
    assert kept.root_clv.shape == (pt.config.rows, pt.n_pad)
    for method in ("fused", "segmented"):
        with pytest.raises(ValueError, match="Backend.TORCH"):
            pt.log_likelihood(method=method)


# ------------------------------------------------------- module and state --

def test_buffers_and_share_device_from():
    pt = _port_of(_jax_model("gamma"))
    names = dict(pt.named_buffers(remove_duplicate=False))
    assert set(names) == {"codes", "wgt_pad", "lcs", "rcs", "ec",
                          "tip_table", "fused_tip_table", "root_rows",
                          "sched"}
    assert all(b.device.type == "cpu" for b in names.values())
    from plf_tpu_torch.models import PhyloModel as TPM
    from plf_tpu_torch.models import random_tree as trt
    other = TPM(trt(7, seed=99), pt.model, pt.tip_states[:, :],
                rates=pt.rates, config=pt.config, share_device_from=pt,
                device="cpu")
    for name in ("codes", "wgt_pad", "ec", "tip_table", "fused_tip_table"):
        assert getattr(other, name) is getattr(pt, name)
    assert other._branch_cache is pt._branch_cache
    fresh = TPM(trt(7, seed=99), pt.model, pt.tip_states, rates=pt.rates,
                config=pt.config, device="cpu")
    assert other.log_likelihood().log_likelihood == \
        fresh.log_likelihood().log_likelihood
    with pytest.raises(ValueError):
        TPM(trt(7, seed=99), pt.model, pt.tip_states[:, :-1],
            rates=pt.rates, config=pt.config, share_device_from=pt,
            device="cpu")
