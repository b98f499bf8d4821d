"""The port's training surface (``plf_tpu_torch/models/optimize.py``)
against the JAX package's ``models/optimize.py``.

Backends pair up by ``config.py``'s renaming: port "torch" with JAX "xla",
"kernel" with "pallas", "tree" with "tree".  Cases and tolerances are
those of ``tests/test_tree_grad.py``: values rel 1e-5; gradients rtol
2e-4 / atol 1e-4, and rtol 5e-4 on the underflow, gaps, Lewis and
rates/weights cases (``:49,72,94,108,117``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from plf_tpu.config import PLFConfig  # noqa: E402
from plf_tpu.models import PhyloModel, hky85, parse_newick, random_tree  # noqa: E402
from plf_tpu.models import optimize as JO  # noqa: E402
from plf_tpu_torch.models import optimize as TO  # noqa: E402
from tests.test_torch_phylo import _port_of  # noqa: E402

PAIRS = {"torch": "xla", "kernel": "pallas", "tree": "tree"}


def _make_pm(n_leaves=8, n=512, seed=0, **kw):
    """tests/test_tree_grad.py::_make_pm."""
    tree = random_tree(n_leaves, seed=seed)
    tips = np.random.default_rng(seed).integers(0, 4, size=(n_leaves, n))
    return PhyloModel(tree, hky85(2.0), tips, alpha=0.5,
                      config=PLFConfig(block_sites=128), **kw)


def _caterpillar():
    nwk = "A0:0.1"
    for i in range(1, 40):
        nwk = f"({nwk},A{i}:0.1):0.1"
    tips = np.random.default_rng(7).integers(0, 4, size=(40, 256))
    return PhyloModel(parse_newick(nwk + ";"), hky85(2.0), tips, alpha=0.5,
                      config=PLFConfig(block_sites=128))


def _gaps_weights():
    pm = _make_pm(n_leaves=8, n=300, seed=4)
    tips = np.asarray(pm.tip_states).copy()
    tips[0, ::7] = -1
    wgt = np.asarray(np.arange(300) % 3 + 1, np.int32)
    return PhyloModel(pm.tree, pm.model, tips, wgt=wgt, alpha=0.5,
                      config=PLFConfig(block_sites=128))


CASES = {
    "underflow40": (_caterpillar, dict(rtol=5e-4, atol=1e-5)),
    "gaps_weights": (_gaps_weights, dict(rtol=5e-4, atol=1e-4)),
    "lewis": (lambda: _make_pm(n_leaves=6, n=200, seed=5,
                               ascertainment="lewis"),
              dict(rtol=5e-4, atol=1e-4)),
    "small": (lambda: _make_pm(n_leaves=6, n=256, seed=1),
              dict(rtol=2e-4, atol=1e-4)),
}


@functools.cache
def _models(case):
    pm = CASES[case][0]()
    return pm, _port_of(pm)


@functools.cache
def _jax_value_and_grad(case, backend, with_weights):
    pm, _ = _models(case)
    fn, t0 = JO.tree_loglik_fn(pm, with_weights=with_weights,
                               backend=backend)
    args = (jnp.asarray(t0),)
    if with_weights:
        args += (jnp.asarray(pm.rates, jnp.float32),
                 jnp.asarray(pm.rate_weights, jnp.float32))
    val, g = jax.value_and_grad(fn, argnums=tuple(range(len(args))))(*args)
    return float(val), [np.asarray(a) for a in g], t0


def _port_value_and_grad(pt, backend, with_weights):
    fn, t0 = TO.tree_loglik_fn(pt, with_weights=with_weights,
                               backend=backend)
    args = [torch.tensor(t0, requires_grad=True)]
    if with_weights:
        args += [torch.tensor(np.asarray(a, np.float32), requires_grad=True)
                 for a in (pt.rates, pt.rate_weights)]
    val = fn(*args)
    val.backward()
    assert val.dtype == torch.float32 and val.dim() == 0
    return float(val.detach()), [a.grad.numpy() for a in args], t0, fn


@pytest.mark.parametrize("backend", sorted(PAIRS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_value_and_grad_match_jax(case, backend):
    pm, pt = _models(case)
    with_weights = case == "small"       # the rates/weights gradient case
    v_j, g_j, t0_j = _jax_value_and_grad(case, PAIRS[backend], with_weights)
    v_t, g_t, t0_t, fn = _port_value_and_grad(pt, backend, with_weights)
    np.testing.assert_array_equal(t0_t, t0_j)        # t0 bit for bit
    assert (fn.variant, fn.engine) == ("vpu", backend)
    assert v_t == pytest.approx(v_j, rel=1e-5)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, **CASES[case][1])
    if case == "underflow40":
        assert pt.log_likelihood().scaler_total > 0, "case must rescale"


@pytest.mark.parametrize("backend", sorted(PAIRS))
def test_device_fp32_value_matches_host_fp64(backend):
    """The differentiable value is finalised in fp32 on the device, the
    PhyloModel's in fp64 on the host: rel 1e-5 (as the JAX package holds
    its tree backend to its forward, test_tree_grad.py:41)."""
    for case in ("lewis", "gaps_weights"):
        _, pt = _models(case)
        fn, t0 = TO.tree_loglik_fn(pt, backend=backend)
        with torch.no_grad():
            ll = float(fn(t0))
        assert ll == pytest.approx(pt.log_likelihood().log_likelihood,
                                   rel=1e-5)


def test_optimize_branch_lengths_matches_jax():
    """Ten Adam steps (torch.optim.Adam against optax.adam, the same
    defaults) from the same start: lengths within rtol 1e-4 (the two
    libraries round the bias corrections in another order), likelihoods
    rel 1e-5."""
    pm, pt = _models("small")
    t_j, ll0_j, ll1_j = JO.optimize_branch_lengths(pm, steps=10)
    t_t, ll0_t, ll1_t = TO.optimize_branch_lengths(pt, steps=10)
    assert ll1_t > ll0_t
    np.testing.assert_allclose(t_t, np.asarray(t_j), rtol=1e-4)
    assert ll0_t == pytest.approx(ll0_j, rel=1e-5)
    assert ll1_t == pytest.approx(ll1_j, rel=1e-5)


def test_optimize_alpha_matches_jax():
    """tests/test_optimize.py's case: data simulated at alpha 0.4, search
    started from 5.0; alpha within rel 1e-3 (the search's last bracket)."""
    from plf_tpu.models import simulate_alignment
    tree = random_tree(6, seed=21, mean_branch=0.3)
    model = hky85(2.0, [0.3, 0.2, 0.3, 0.2])
    tips = simulate_alignment(tree, model, 2000, alpha=0.4, seed=5)
    pm = PhyloModel(tree, model, tips, alpha=5.0,
                    config=PLFConfig(block_sites=128))
    pt = _port_of(pm)
    a_j, ll0_j, ll1_j = JO.optimize_alpha(pm, iters=20)
    a_t, ll0_t, ll1_t = TO.optimize_alpha(pt, iters=20)
    assert ll1_t >= ll0_t and 0.02 < a_t < 100.0
    assert a_t == pytest.approx(a_j, rel=1e-3)
    assert (ll0_t, ll1_t) == (pytest.approx(ll0_j, rel=1e-5),
                              pytest.approx(ll1_j, rel=1e-5))


def test_optimize_pinv_matches_jax():
    """Data simulated with 30% invariant sites, search started from 0.1.
    p_inv within 2e-3: within ~1e-3 of its maximum the profile moves the
    fp32 log-likelihood by less than its rounding, so the last comparisons
    of the search are decided by rounding, which differs between the two
    packages' sums."""
    from plf_tpu.models import simulate_alignment
    tree = random_tree(6, seed=9, mean_branch=0.3)
    model = hky85(2.0)
    tips = simulate_alignment(tree, model, 2000, alpha=0.5, p_inv=0.3,
                              seed=9)
    pm = PhyloModel(tree, model, tips, alpha=0.5, p_inv=0.1,
                    config=PLFConfig(block_sites=128))
    pt = _port_of(pm)
    pt.p_inv = pm.p_inv
    p_j, ll0_j, ll1_j = JO.optimize_pinv(pm, iters=20)
    p_t, ll0_t, ll1_t = TO.optimize_pinv(pt, iters=20)
    assert ll1_t >= ll0_t
    assert p_t == pytest.approx(p_j, abs=2e-3)
    assert (ll0_t, ll1_t) == (pytest.approx(ll0_j, rel=1e-5),
                              pytest.approx(ll1_j, rel=1e-5))
    _, pt_plain = _models("small")
    with pytest.raises(ValueError, match="p_inv"):
        TO.optimize_pinv(pt_plain)


class _Stand:
    """What the auto rule reads of a PhyloModel (a matrix-form model, or
    one the segmented kernels do not take)."""

    def __init__(self, device, fits):
        self.device, self._fits = torch.device(device), fits

    def can_fuse(self):
        return self._fits

    def can_segment(self):
        return False


def test_backend_routing():
    assert TO._auto_backend(_Stand("cpu", True)) == "torch"
    assert TO._auto_backend(_Stand("cuda", True)) == "tree"
    assert TO._auto_backend(_Stand("cuda", False)) == "kernel"
    _, pt = _models("small")
    fn, _ = TO.tree_loglik_fn(pt)
    assert (fn.variant, fn.engine) == ("vpu", "torch")
    for kw in (dict(with_rates=True), dict(with_weights=True)):
        for backend in PAIRS:
            fn, _ = TO.tree_loglik_fn(pt, backend=backend, **kw)
            assert (fn.variant, fn.engine) == ("vpu", backend)
    fn, _ = TO.tree_loglik_fn(pt, backend="segmented")
    assert (fn.variant, fn.engine) == ("vpu", "segmented")
    with pytest.raises(ValueError, match="unknown backend"):
        TO.tree_loglik_fn(pt, backend="pallas")
