"""Kernel 3's plain version and the differentiable node against the JAX
package's node VJP (``plf_tpu/ops/plf_grad.py``, interpret mode)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
