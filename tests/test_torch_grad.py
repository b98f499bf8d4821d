"""Kernel 3's plain version and the differentiable node against the JAX
package's node VJP (``plf_tpu/ops/plf_grad.py``, interpret mode)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from plf_tpu.ops import layout as JL  # noqa: E402
from plf_tpu.ops.plf_grad import make_plf_diff as jax_plf_diff  # noqa: E402
from plf_tpu.ops.plf_grad import transpose_lane_constants as jax_T  # noqa: E402
from plf_tpu_torch.ops import plf_grad as G  # noqa: E402
from plf_tpu_torch.ops.plf_node import node_plain, plf_node  # noqa: E402

S = 4


def _case(seed, categories=4, n_pad=512, underflow=True):
    """The inputs of tests/test_grad.py::_case plus a cotangent."""
    C = categories
    R = S * C
    rng = np.random.default_rng(seed)
    x1 = (rng.random((R, n_pad)) * 0.99 + 0.01).astype(np.float32)
    x2 = (rng.random((R, n_pad)) * 0.99 + 0.01).astype(np.float32)
    if underflow:
        x1[:, 1::7] *= np.float32(1e-8)
        x2[:, 1::7] *= np.float32(1e-8)
    left = rng.random((C, S, S)).astype(np.float32)
    right = rng.random((C, S, S)).astype(np.float32)
    ev = rng.random((S, S)).astype(np.float32)
    g = rng.standard_normal((R, n_pad)).astype(np.float32)
    return (x1, x2, JL.branch_to_lane_constants(left, S, C),
            JL.branch_to_lane_constants(right, S, C),
            JL.ev_to_lane_constants(ev, S, C), g)


def _port_vjp(x1, x2, lc, rc, ec, g, n, C=4):
    t = torch.as_tensor
    _, sc = plf_node(t(x1), t(x2), t(lc), t(rc), t(ec), n, categories=C)
    consts = [G.transpose_lane_constants(t(a), S, C) for a in (lc, rc, ec)]
    return G.plf_node_bwd(t(x1), t(x2), t(g), sc, t(lc), t(rc), *consts, n,
                          categories=C)


def test_transpose_lane_constants_identical():
    rng = np.random.default_rng(0)
    for C in (4, 5):
        lc = rng.random((S * C, S)).astype(np.float32)
        got = G.transpose_lane_constants(torch.as_tensor(lc), S, C)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_T(jnp.asarray(lc), S, C)))
        np.testing.assert_array_equal(
            G.transpose_lane_constants(got, S, C).numpy(), lc)
    # a whole operator stack at once: the "vpu" transpose_operator_stack
    from plf_tpu.ops.plf_tree_grad import transpose_operator_stack
    ops = rng.random((7, 16, S)).astype(np.float32)
    np.testing.assert_array_equal(
        G.transpose_lane_constants(torch.as_tensor(ops)).numpy(),
        np.asarray(transpose_operator_stack(jnp.asarray(ops), "vpu", S, 4)))


@pytest.mark.parametrize("underflow", [False, True])
def test_node_vjp_matches_jax(underflow):
    """gx1, gx2, gl, gr, ge against make_plf_diff(block_sites=128,
    interpret=True) with 37 padding sites.  Tolerance 1e-6 of each
    gradient's largest magnitude: XLA:CPU contracts the interpreted
    kernel's multiply-adds into FMAs (ROADMAP queue 3), measured 1.1e-7
    relative here, and the site sums run in another order."""
    x1, x2, lc, rc, ec, g = _case(3, underflow=underflow)
    n = x1.shape[-1] - 37
    f = jax_plf_diff(block_sites=128, interpret=True)
    (x3_j, sc_j), vjp = jax.vjp(
        lambda *a: f(*a, jnp.int32(n)),
        *(jnp.asarray(v) for v in (x1, x2, lc, rc, ec)))
    want = vjp((jnp.asarray(g), jnp.zeros_like(sc_j)))
    got = _port_vjp(x1, x2, lc, rc, ec, g, n)
    if underflow:
        assert int(np.asarray(sc_j).sum()) > 0
    for name, a, b in zip(("gx1", "gx2", "gl", "gr", "ge"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max(),
                                   err_msg=name)
    assert not got[0][:, n:].any() and not got[1][:, n:].any()


@pytest.mark.parametrize("C", [4, 5])
def test_node_vjp_matches_autograd_through_plain_forward(C):
    """The hand-written VJP against torch autograd through the plain
    forward (node_plain): the rescale factor enters as the constant it is.
    Per-site cotangents are the same ops in another association; 1e-6 of
    the largest magnitude."""
    x1, x2, lc, rc, ec, g = _case(9, categories=C)
    n = x1.shape[-1] - 5
    ts = [torch.tensor(a, requires_grad=True) for a in (x1, x2, lc, rc, ec)]
    valid = torch.arange(x1.shape[-1]) < n
    x3, _ = node_plain(*ts, valid, S, C)
    (x3 * torch.as_tensor(g) * valid).sum().backward()
    got = _port_vjp(x1, x2, lc, rc, ec, g, n, C)
    for name, a, t in zip(("gx1", "gx2", "gl", "gr", "ge"), got, ts):
        a, b = a.numpy(), t.grad.numpy()
        if name in ("gx1", "gx2"):
            a, b = a[:, :n], b[:, :n]
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)


def test_make_plf_diff_is_kernel1_forward_kernel3_backward():
    x1, x2, lc, rc, ec, g = _case(5)
    n = x1.shape[-1] - 3
    ts = [torch.tensor(a, requires_grad=True) for a in (x1, x2, lc, rc, ec)]
    x3, sc = G.make_plf_diff()(*ts, n)
    ref3, refsc = plf_node(*(t.detach() for t in ts), n)
    assert torch.equal(x3.detach(), ref3) and torch.equal(sc, refsc)
    assert not sc.requires_grad
    x3.backward(torch.as_tensor(g))
    want = _port_vjp(x1, x2, lc, rc, ec, g, n)
    for t, w in zip(ts, want):
        assert torch.equal(t.grad, w)
    # x1 and x2 are residuals: the forward never wrote over them
    assert np.array_equal(ts[0].detach().numpy(), x1)
    assert np.array_equal(ts[1].detach().numpy(), x2)


def test_node_bwd_wrapper_dispatch_and_checks():
    x1, x2, lc, rc, ec, g = _case(6, n_pad=256)
    t = torch.as_tensor
    _, sc = plf_node(t(x1), t(x2), t(lc), t(rc), t(ec), 200)
    consts = [t(a) for a in (lc, rc, lc, rc, ec)]
    before = G.plf_node_bwd.launches
    G.plf_node_bwd(t(x1), t(x2), t(g), sc, *consts, 200)
    assert G.plf_node_bwd.launches == before       # CPU: plain version
    meta = [a.to("meta") for a in (t(x1), t(x2), t(g), sc, *consts)]
    with pytest.raises(ValueError, match="no kernel for device"):
        G.plf_node_bwd(*meta, 200)
    with pytest.raises(ValueError):
        G.plf_node_bwd(t(x1), t(x2), t(g)[:, :128], sc, *consts, 200)
    with pytest.raises(ValueError):
        G.plf_node_bwd(t(x1), t(x2), t(g), sc.to(torch.int64), *consts, 200)
    with pytest.raises(TypeError):
        G.plf_node_bwd(t(x1).double(), t(x2), t(g), sc, *consts, 200)
    assert G.node_bwd_blocks(256) == (2, 1)
    assert G.node_bwd_blocks(1 << 20) == (1024, 8)
    assert G.node_bwd_blocks(1030 * 128) == (515, 2)


# ------------------------------------------- kernel 3m: S != 4 (20, 61) --

def _case_s(seed, S, C, n_pad=128):
    """Random operands at S states; every 7th site of both children is
    scaled by 1e-16 so that some sites rescale (at S = 20 and 61 the sums
    grow past what the DNA case's 1e-8 would rescue)."""
    R = S * C
    rng = np.random.default_rng(seed)
    x1 = (rng.random((R, n_pad)) * 0.99 + 0.01).astype(np.float32)
    x2 = (rng.random((R, n_pad)) * 0.99 + 0.01).astype(np.float32)
    x1[:, 1::7] *= np.float32(1e-16)
    x2[:, 1::7] *= np.float32(1e-16)
    left = rng.random((C, S, S)).astype(np.float32)
    right = rng.random((C, S, S)).astype(np.float32)
    ev = rng.random((S, S)).astype(np.float32)
    g = rng.standard_normal((R, n_pad)).astype(np.float32)
    return (x1, x2, JL.branch_to_lane_constants(left, S, C),
            JL.branch_to_lane_constants(right, S, C),
            JL.ev_to_lane_constants(ev, S, C), g)


@pytest.mark.parametrize("S,C", [(20, 4), (61, 2)])
def test_node_vjp_matches_jax_at_other_state_counts(S, C):
    """Kernel 3's plain version at S != 4 (what kernel 3m equals on the
    card, gx1/gx2 bit for bit) against make_plf_diff(states=S,
    block_sites=128, interpret=True) with 29 padding sites, at the S = 4
    test's bar: 1e-6 of each gradient's largest magnitude.  S = 61 runs
    at C = 2, the shape of the S = 61 kernel-backend test below, so the
    two share JAX's compiled kernels."""
    x1, x2, lc, rc, ec, g = _case_s(4, S, C)
    n = x1.shape[-1] - 29
    f = jax_plf_diff(states=S, categories=C, block_sites=128,
                     interpret=True)
    (x3_j, sc_j), vjp = jax.vjp(
        lambda *a: f(*a, jnp.int32(n)),
        *(jnp.asarray(v) for v in (x1, x2, lc, rc, ec)))
    want = vjp((jnp.asarray(g), jnp.zeros_like(sc_j)))
    t = torch.as_tensor
    _, sc = plf_node(t(x1), t(x2), t(lc), t(rc), t(ec), n, states=S,
                     categories=C)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_j))
    assert int(sc.sum()) > 0
    consts = [G.transpose_lane_constants(t(a), S, C) for a in (lc, rc, ec)]
    before = (G.plf_node_bwd.launches, G.plf_node_bwd_mxu.launches)
    got = G.plf_node_bwd(t(x1), t(x2), t(g), sc, t(lc), t(rc), *consts, n,
                         states=S, categories=C)
    assert (G.plf_node_bwd.launches, G.plf_node_bwd_mxu.launches) == before
    for name, a, b in zip(("gx1", "gx2", "gl", "gr", "ge"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max(),
                                   err_msg=name)
    assert not got[0][:, n:].any() and not got[1][:, n:].any()


def test_node_bwd_mxu_wrapper_dispatch_and_checks():
    """plf_node_bwd hands S != 4 to kernel 3m's wrapper, which takes the
    plain version on the CPU, raises for a device with no kernel and
    checks shapes; neither wrapper counts a CPU call."""
    S, C = 20, 4
    x1, x2, lc, rc, ec, g = _case_s(6, S, C, n_pad=256)
    t = torch.as_tensor
    _, sc = plf_node(t(x1), t(x2), t(lc), t(rc), t(ec), 200, states=S)
    consts = [t(lc), t(rc)] + [G.transpose_lane_constants(t(a), S, C)
                               for a in (lc, rc, ec)]
    args = (t(x1), t(x2), t(g), sc, *consts, 200)
    before = (G.plf_node_bwd.launches, G.plf_node_bwd_mxu.launches)
    via = G.plf_node_bwd(*args, states=S)
    direct = G.plf_node_bwd_mxu(*args, states=S)
    plain = G.plf_node_bwd_torch(*args, states=S)
    assert (G.plf_node_bwd.launches, G.plf_node_bwd_mxu.launches) == before
    for u, v, w in zip(via, direct, plain):
        assert torch.equal(u, w) and torch.equal(v, w)
    meta = [a.to("meta") for a in args[:-1]]
    with pytest.raises(ValueError, match="no kernel for device"):
        G.plf_node_bwd(*meta, 200, states=S)
    with pytest.raises(ValueError):
        G.plf_node_bwd(t(x1), t(x2), t(g)[:, :128], sc, *consts, 200,
                       states=S)
    assert G.node_bwd_mxu_blocks(1 << 21, 660, 32) == (656, 100)
    assert G.node_bwd_mxu_blocks(256, 660, 32) == (8, 1)
    assert G.node_bwd_mxu_blocks(1 << 21, 5000, 32) == (1024, 64)


@pytest.mark.parametrize("states", [20, 61])
def test_kernel_backend_matches_jax_pallas_at_other_state_counts(states):
    """tree_loglik_fn(backend="kernel") on a "vpu" model at S = 20 (random
    GTR, C = 2) and S = 61 (GY94 codons simulated under the model), 5
    taxa x 100 sites, against JAX's "pallas" backend, with
    tests/test_torch_optimize.py's tolerances: value rel 1e-5, gradient
    rtol 2e-4 / atol 1e-4.  (JAX's interpret mode takes ~20 s a node at
    S = 61.  A 3-taxon codon model was tried first: there every backend
    of the port, "torch" too, lies 5.2e-4 from JAX's "pallas" and "xla"
    while each package's backends agree within 3.5e-5, the fp32 rounding
    of the two packages' branch operators under the codon model's
    cancellation.)"""
    from tests.test_torch_tree_grad_mxu import (_jax_grads, _jax_protein,
                                                _port_of)
    from plf_tpu_torch.models import optimize as TO

    pm = _jax_protein("vpu", states=states)
    pt = _port_of(pm, states, "vpu")
    fn, t0 = TO.tree_loglik_fn(pt, backend="kernel")
    assert (fn.engine, fn.variant) == ("kernel", "vpu")
    t = torch.tensor(t0, requires_grad=True)
    v = fn(t)
    v.backward()
    v_j, g_j = _jax_grads(pm, "pallas")
    assert float(v.detach()) == pytest.approx(v_j, rel=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), g_j, rtol=2e-4, atol=1e-4)
