"""Kernel 9's plain version (the compute-only probe, ``ops/plf_node.py::
plf_node_gen``) against the JAX package's ``plf_pallas_gen`` in interpret
mode, and the wrapper's dispatch."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

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


def test_gen_operators_layout():
    """At S != 4 kernel 9 takes the operators transposed and padded,
    ``[k][c][q][o] = K[o*C + c][q]`` with rows o >= S zero, so that one
    float4 holds one q's values for 4 consecutive output rows."""
    S, C, sp = 13, 3, 16
    consts = [torch.as_tensor(a) for a in _consts(S, C, seed=5)]
    kt = N.gen_operators(*consts, sp, states=S, categories=C)
    assert kt.shape == (3, C, S, sp) and kt.dtype == torch.float32
    assert kt.is_contiguous()
    for i, k in enumerate(consts):
        for o in range(S):
            for c in range(C):
                assert torch.equal(kt[i, c, :, o], k[o * C + c])
    assert not kt[..., S:].any()


class _FakeGenLib:
    """Stands in for csrc/plf_gen.cu's library: plf_gen_plan writes the
    plan it is given, or fails as the library does where the tiles do not
    fit one block's shared memory."""

    def __init__(self, plans):
        self.plans = plans

    def plf_gen_plan(self, states, categories, *ptrs):
        plan = self.plans.get((states, categories))
        if plan is None:
            return 1          # cudaErrorInvalidValue
        for p, v in zip(ptrs, plan):
            p._obj.value = v
        return 0

    def plf_error_string(self, err):
        return b"invalid argument"


def test_gen_plan_is_the_library_rule(monkeypatch):
    """The wrapper restates no shared-memory rule: gen_plan reports the
    library's plan field by field and turns the library's refusal into a
    ValueError naming the shared memory (the on-card tests pin the plans
    themselves)."""
    plan = (160, 32, 4, 4, 20, 50688, 1, 4)
    monkeypatch.setattr(N, "_lib_gen", lambda: _FakeGenLib({(20, 4): plan}))
    assert N.gen_plan(20, 4) == dict(
        threads=160, tile_sites=32, job_rows=4, job_sites=4, sp=20,
        smem_bytes=50688, ops_shared=1, blocks_per_sm=4)
    with pytest.raises(ValueError, match="shared memory"):
        N.gen_plan(61, 10)
    with pytest.raises(ValueError, match="C in 1..8"):
        N.gen_plan(4, 9)
