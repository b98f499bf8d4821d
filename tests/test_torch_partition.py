"""The port's partitioned models (``models/partition.py``) against the JAX
package's, on the CPU, built from the same partitions by value
(``convert.partitioned_model``).

Tolerances: lls within rel 1e-5 (fp32 traversals whose sums run in
another order); the joint objective's gradients within rtol 5e-4, atol
1e-4 (the JAX package's own bar between two gradient routes,
tests/test_partition.py); ``optimize(steps=20)`` within rel 1e-4 of
optax's trajectory (both Adams take the same steps from the same
gradients, which differ by fp32 rounding)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import plf_tpu.models as J  # noqa: E402
from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu_torch import convert  # noqa: E402
from plf_tpu_torch.config import PLFConfig  # noqa: E402
from test_torch_batch import _one_torch_thread  # noqa: E402,F401

LL_RTOL = 1e-5
FIT_RTOL = 1e-4


def _by_value(pmod_j):
    """The JAX PartitionedModel's partitions as convert takes them."""
    return [dict(name=p.name, sites=p.sites, wgt=p.wgt, alpha=p.alpha,
                 scale=p.scale, pi=p.model.pi,
                 eigenvalues=p.model.eigenvalues, u=p.model.u, w=p.model.w)
            for p in pmod_j.partitions]


def _pair(seed=41, n_each=128, mixed=False):
    """A JAX PartitionedModel (tests/test_partition.py's set-up: HKY+G and
    JC, the second with a 1.5 multiplier; or DNA + protein) and the port's
    from it."""
    tree = J.random_tree(6, seed=seed, mean_branch=0.2)
    if mixed:
        m1, m2 = J.hky85(2.0), J.random_gtr(20, seed=3)
        rng = np.random.default_rng(seed)
        tips = np.concatenate([rng.integers(0, 4, size=(6, n_each)),
                               rng.integers(0, 20, size=(6, n_each))], 1)
        parts = [J.Partition("dna", np.arange(n_each), m1, alpha=0.5),
                 J.Partition("prot", np.arange(n_each, 2 * n_each), m2)]
    else:
        m1, m2 = J.hky85(2.0, [0.3, 0.2, 0.3, 0.2]), J.jc69()
        tips = np.concatenate(
            [J.simulate_alignment(tree, m1, n_each, alpha=0.5, seed=seed),
             J.simulate_alignment(tree, m2, n_each, seed=seed + 1)], 1)
        # an interleaved split, as codon positions are
        sites = np.arange(2 * n_each)
        parts = [J.Partition("g1", sites[sites % 2 == 0], m1, alpha=0.5),
                 J.Partition("g2", sites[sites % 2 == 1], m2, scale=1.5)]
    pj = J.PartitionedModel(tree, parts, tips,
                            config=JCfg(block_sites=128, interpret=True))
    pt = convert.partitioned_model(
        partitions=_by_value(pj), tip_states=tips,
        nodes=[(n.index, n.name, n.length, n.children) for n in tree.nodes],
        root=tree.root, config=PLFConfig(block_sites=128), device="cpu")
    return pj, pt


@pytest.mark.parametrize("mixed", [False, True])
def test_partitioned_log_likelihood_equals_jax(mixed):
    pj, pt = _pair(mixed=mixed)
    rj, rt = pj.log_likelihood(), pt.log_likelihood()
    assert rt.log_likelihood == pytest.approx(rj.log_likelihood,
                                              rel=LL_RTOL)
    assert len(rt.per_partition) == 2
    for a, b, pm in zip(rj.per_partition, rt.per_partition, pt.models):
        assert b.log_likelihood == pytest.approx(a.log_likelihood,
                                                 rel=LL_RTOL)
        assert b.scaler_total == a.scaler_total
    # the total is the host sum of the parts, bit for bit
    assert rt.log_likelihood == float(sum(r.log_likelihood
                                          for r in rt.per_partition))
    assert [pm.config.states for pm in pt.models] == (
        [4, 20] if mixed else [4, 4])
    bf = sum(pm.log_likelihood_bruteforce() for pm in pt.models)
    assert rt.log_likelihood == pytest.approx(bf, rel=LL_RTOL)


@pytest.mark.parametrize("proportional", [True, False])
def test_joint_objective_and_gradient_equal_jax(proportional):
    pj, pt = _pair(seed=43)
    fj, t0j, s0j = pj.loglik_fn(proportional=proportional)
    ft, t0, s0 = pt.loglik_fn(proportional=proportional)
    np.testing.assert_array_equal(t0, np.asarray(t0j))
    np.testing.assert_array_equal(s0, s0j)
    ls = np.log(s0)
    vj, gj = jax.value_and_grad(fj, argnums=(0, 1))(jnp.asarray(t0),
                                                     jnp.asarray(ls))
    t = torch.tensor(t0, requires_grad=True)
    lt = torch.tensor(ls, requires_grad=True)
    v = ft(t, lt)
    v.backward()
    assert float(v.detach()) == pytest.approx(float(vj), rel=LL_RTOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj[0]),
                               rtol=5e-4, atol=1e-4)
    if proportional:
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gj[1]),
                                   rtol=5e-4, atol=1e-4)
    else:   # scales unused: no gradient reaches them (JAX: zeros)
        assert lt.grad is None and np.all(np.asarray(gj[1]) == 0)
    # at unit scales the objective is the partitioned log-likelihood
    ref = pt.log_likelihood().log_likelihood
    assert float(ft(torch.tensor(t0), torch.zeros(2))) == pytest.approx(
        ref, rel=LL_RTOL)


def test_optimize_follows_optax():
    pj, pt = _pair(seed=47, n_each=100)
    tj, sj, ll0j, ll1j = pj.optimize(steps=20)
    tt, st, ll0t, ll1t = pt.optimize(steps=20)
    assert ll1t > ll0t
    assert ll0t == pytest.approx(ll0j, rel=FIT_RTOL)
    assert ll1t == pytest.approx(ll1j, rel=FIT_RTOL)
    np.testing.assert_allclose(tt, tj, rtol=FIT_RTOL, atol=1e-6)
    np.testing.assert_allclose(st, sj, rtol=FIT_RTOL)
    assert st[0] == 1.0 and (tt > 0).all()


def test_sharding_is_not_ported():
    """Site sharding is ported (``plf_tpu_torch.parallel``): on a one-rank
    mesh (no process group) the sharded partitioned ll equals the
    unsharded one site for site, and the sharded joint objective (the
    "tree" backend on the shard) equals the unsharded "tree" objective,
    value and gradients, bit for bit; a mesh step on another backend is
    refused.  Several ranks: tests/test_torch_parallel.py."""
    from plf_tpu_torch.models import optimize as TO
    from plf_tpu_torch.parallel import make_mesh
    _, pt = _pair()
    mesh = make_mesh(device="cpu")
    res_m, res_s = pt.log_likelihood_sharded(mesh=mesh), pt.log_likelihood()
    assert res_m.log_likelihood == res_s.log_likelihood
    for a, b in zip(res_m.per_partition, res_s.per_partition):
        np.testing.assert_array_equal(a.site_log_likelihood,
                                      b.site_log_likelihood)
        assert a.scaler_total == b.scaler_total
    fn_m, t0, _ = pt.loglik_fn(mesh=mesh)
    pm = pt.models[0]
    fn_t, _ = TO.tree_loglik_fn(pm, backend="tree")
    fn_1, _ = TO.tree_loglik_fn(pm, backend="tree", mesh=mesh)
    ts = [torch.tensor(t0, requires_grad=True) for _ in range(2)]
    for fn, t in zip((fn_t, fn_1), ts):
        fn(t).backward()
    assert torch.equal(ts[0].grad, ts[1].grad)
    assert torch.isfinite(fn_m(torch.as_tensor(t0), torch.zeros(2)))
    with pytest.raises(ValueError, match="mesh-sharded"):
        TO.tree_loglik_fn(pm, backend="torch", mesh=mesh)
