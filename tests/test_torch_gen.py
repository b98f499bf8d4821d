"""Kernel 9's plain version (the compute-only probe, ``ops/plf_node.py::
plf_node_gen``) against the JAX package's ``plf_pallas_gen`` in interpret
mode, and the wrapper's dispatch."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from plf_tpu.ops import layout as JL  # noqa: E402
from plf_tpu.ops.plf_pallas import plf_pallas_gen  # noqa: E402
from plf_tpu_torch.ops import plf_node as N  # noqa: E402


def _consts(S, C, seed=0):
    rng = np.random.default_rng(seed)
    return (JL.branch_to_lane_constants(rng.random((C, S, S), np.float32),
                                        S, C),
            JL.branch_to_lane_constants(rng.random((C, S, S), np.float32),
                                        S, C),
            JL.ev_to_lane_constants(rng.random((S, S), np.float32), S, C))


@pytest.mark.parametrize("S", [4, 20])
def test_gen_matches_jax(S):
    """C = 4, block 128, 2 blocks, 2 iterations: every checksum finite and
    within rel 1e-6 of JAX's (measured 2.2e-7 at S = 4 and 3.1e-7 at
    S = 20: JAX sums the rows in XLA's order and XLA:CPU may contract the
    interpreted kernel's multiply-adds; the port sums row 0 first, the
    kernel's order).  Which shapes stay finite: with these constants the
    values grow by about S^3 a node; S = 4 and S = 20 stay finite through
    8 nodes at block 128, S = 61 reaches inf by the 8th (next test)."""
    C = 4
    kw = dict(states=S, categories=C, block_sites=128, n_blocks=2,
              inner_iters=2)
    lc, rc, ec = _consts(S, C)
    want = np.asarray(plf_pallas_gen(jnp.asarray(lc), jnp.asarray(rc),
                                     jnp.asarray(ec), interpret=True, **kw))
    got = N.plf_node_gen(*(torch.as_tensor(a) for a in (lc, rc, ec)), **kw)
    assert got.shape == (1, 256) and got.dtype == torch.float32
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # the sites of the two blocks repeat: a site's data is its index
    # within its block
    assert torch.equal(got[0, :128], got[0, 128:])


def test_gen_overflows_at_61_states():
    """S = 61 (244 rows): finite after 2 nodes, +inf at every site after 8
    (JAX's interpret-mode probe gives the same: finite within 6.2e-7 after
    2, all inf after 8, measured with these constants; it takes ~40 s at
    S = 61, so it is not rerun here).  inf arithmetic is exact, so the
    kernel still equals its plain version bit for bit on the card."""
    S, C = 61, 4
    kw = dict(states=S, categories=C, block_sites=128, n_blocks=1)
    lc, rc, ec = (torch.as_tensor(a) for a in _consts(S, C))
    two = N.plf_node_gen_torch(lc, rc, ec, inner_iters=2, **kw)
    eight = N.plf_node_gen_torch(lc, rc, ec, inner_iters=8, **kw)
    assert torch.isfinite(two).all()
    assert torch.isposinf(eight).all()


def test_gen_plain_sums_rows_in_order():
    """The plain version's row sum is the loop from row 0, not torch.sum:
    one node by hand equals it bit for bit."""
    S, C = 20, 4
    lc, rc, ec = (torch.as_tensor(a) for a in _consts(S, C, seed=3))
    got = N.plf_node_gen_torch(lc, rc, ec, states=S, categories=C,
                               block_sites=64, n_blocks=1, inner_iters=1)
    x1, x2 = N._gen_clvs(S * C, 64, 64, "cpu")
    x3 = N.stage(N.stage(x1, lc, S, C) * N.stage(x2, rc, S, C), ec, S, C)
    t = x3[0]
    for r in range(1, S * C):
        t = t + x3[r]
    assert torch.equal(got[0], torch.zeros(64) + t)
    assert N.gen_flops(4, 4) == 368 and N.gen_flops(20, 4) == 9520


def test_gen_dispatch_and_checks():
    S, C = 4, 4
    lc, rc, ec = (torch.as_tensor(a) for a in _consts(S, C))
    kw = dict(states=S, categories=C, block_sites=128, n_blocks=1,
              inner_iters=1)
    before = N.plf_node_gen.launches
    assert torch.equal(N.plf_node_gen(lc, rc, ec, **kw),
                       N.plf_node_gen_torch(lc, rc, ec, **kw))
    assert N.plf_node_gen.launches == before      # CPU: plain version
    meta = [t.to("meta") for t in (lc, rc, ec)]
    with pytest.raises(ValueError, match="no kernel for device"):
        N.plf_node_gen(*meta, **kw)
    with pytest.raises(ValueError, match="must be"):
        N.plf_node_gen(lc[:8], rc, ec, **kw)
    with pytest.raises(ValueError, match="must be"):
        N.plf_node_gen(lc.double(), rc, ec, **kw)
    with pytest.raises(ValueError, match="one device"):
        N.plf_node_gen(lc, rc.to("meta"), ec, **kw)
    with pytest.raises(ValueError, match="bad"):
        N.plf_node_gen(lc, rc, ec, **dict(kw, n_blocks=0))
