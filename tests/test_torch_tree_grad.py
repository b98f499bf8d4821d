"""Kernel 4's planner and plain version, and the differentiable whole-tree
likelihood, against the JAX package's checkpointed tree VJP
(``plf_tpu/ops/plf_tree_grad.py``, interpret mode)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from plf_tpu.config import PLFConfig  # noqa: E402
from plf_tpu.models import PhyloModel, hky85, random_tree  # noqa: E402
from plf_tpu.ops import plf_tree_grad as JG  # noqa: E402
from plf_tpu_torch.ops import plf_tree as TT  # noqa: E402
from plf_tpu_torch.ops import plf_tree_grad as TG  # noqa: E402
from plf_tpu_torch.ops.plf_grad import transpose_lane_constants  # noqa: E402
from tests.test_torch_tree import TREES  # noqa: E402

S = 4


@pytest.mark.parametrize("name", sorted(TREES))
def test_backward_schedule_identical(name):
    tree = TREES[name]()
    sched = TT.reorder_schedule(tree.schedule(), tree.n_leaves)
    got = TG.compile_backward_schedule(sched, tree.n_leaves)
    want = JG.compile_backward_schedule(sched, tree.n_leaves)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(TREES))
def test_backward_schedule_puts_a_child_last(name):
    """Kernel 4 carries the CLV (forward) and the adjoint (reverse) of the
    op evaluated just before each op in registers: in the reordered
    schedule every op with an internal child has one of them at position
    i - 1 (the subtree evaluated last), on every test tree, so only the
    other child's values go through the checkpoint."""
    tree = TREES[name]()
    n = tree.n_leaves
    sched = TT.reorder_schedule(tree.schedule(), n)
    lpos, rpos, _ = TG.backward_schedule(sched, n)
    prev = n + np.arange(len(sched)) - 1
    internal = (lpos >= n) | (rpos >= n)
    carried = ((lpos == prev) | (rpos == prev)) & (np.arange(len(sched)) > 0)
    np.testing.assert_array_equal(carried, internal)
    assert internal.sum() > 0


def _case(n_leaves=9, n_sites=300, seed=4, alpha=0.6):
    """A JAX model (gaps, IUPAC codes, 300 sites -> 84 padding sites), its
    reordered schedule and a site-likelihood cotangent."""
    tree = random_tree(n_leaves, seed=seed)
    rng = np.random.default_rng(seed)
    tips = rng.integers(-1, 14, size=(n_leaves, n_sites))
    tips[:, 3] = -1
    pm = PhyloModel(tree, hky85(2.0, [0.3, 0.2, 0.3, 0.2]), tips,
                    alpha=alpha, config=PLFConfig(block_sites=128,
                                                  interpret=True))
    sched = TT.reorder_schedule(pm.schedule, n_leaves)
    glik = rng.standard_normal((1, pm.n_pad)).astype(np.float32)
    return pm, sched, glik


def _port_inputs(pm, sched):
    t = lambda a: torch.as_tensor(np.array(a))
    C = pm.config.categories
    lcs, rcs, ec = t(pm._lcs_np), t(pm._rcs_np), t(pm._ec)
    bsched = torch.as_tensor(TG.backward_schedule(sched, pm.tree.n_leaves))
    return dict(codes=t(pm._codes), bsched=bsched, lcs=lcs, rcs=rcs,
                lcsT=transpose_lane_constants(lcs, S, C),
                rcsT=transpose_lane_constants(rcs, S, C), ec=ec,
                ecT=transpose_lane_constants(ec, S, C),
                ttab=t(pm._kernel_tip_table()), rr=t(pm._root_rows)[0])


@pytest.mark.parametrize("alpha", [0.6, None])
def test_plain_tree_vjp_matches_jax(alpha):
    """gl, gr (per original edge), gec and grr against make_tree_diff
    (interpret=True, operators by schedule position).  Tolerance 2e-5 of
    each gradient's largest magnitude: the interpreted JAX kernels drift
    1.2e-5 relative from the golden chain on the CPU (FMA contraction,
    test_torch_tree.py), and the site sums run in another order."""
    pm, sched, glik = _case(alpha=alpha)
    n_leaves, n = pm.tree.n_leaves, pm.n_sites
    eidx = np.array([e[5] for e in sched])
    f = JG.make_tree_diff(sched, n_leaves, block_sites=128, interpret=True)
    codes3 = jnp.asarray(pm._codes).reshape(n_leaves, 1, pm.n_pad)
    ttab = pm._kernel_tip_table()

    def loss(lcs3, rcs3, ec, rr):
        lik, _ = f(codes3, lcs3, rcs3, ec, ttab, rr, n)
        return jnp.sum(lik * glik)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(pm._lcs_np[eidx]), jnp.asarray(pm._rcs_np[eidx]),
        pm._ec, pm._root_rows)
    inp = _port_inputs(pm, sched)
    got = TG.plf_tree_bwd_torch(*inp.values(), torch.as_tensor(glik), n,
                                categories=pm.config.categories)
    gl, gr, gec, grr = (a.numpy() for a in got)
    pairs = (("gl", gl[eidx], want[0]), ("gr", gr[eidx], want[1]),
             ("gec", gec, want[2]), ("grr", grr, np.asarray(want[3])[0]))
    for name, a, b in pairs:
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5 * np.abs(b).max(),
                                   err_msg=name)


def test_make_tree_diff_is_kernel2_forward_kernel4_backward():
    pm, sched, glik = _case(n_leaves=7, n_sites=200, seed=8)
    inp = _port_inputs(pm, sched)
    lcs, rcs, ec, rr = (inp[k].clone().requires_grad_()
                        for k in ("lcs", "rcs", "ec", "rr"))
    fn = TG.make_tree_diff(sched, pm.tree.n_leaves)
    lik, sc = fn(inp["codes"], lcs, rcs, ec, inp["ttab"], rr, pm.n_sites)
    arrs, n_slots, root_slot = TT.compile_register_schedule(
        sched, pm.tree.n_leaves)
    ref = TT.plf_tree(inp["codes"], torch.as_tensor(np.stack(arrs)),
                      inp["lcs"], inp["rcs"], inp["ec"], inp["ttab"],
                      inp["rr"], pm.n_sites, n_slots=n_slots,
                      root_slot=root_slot)
    assert torch.equal(lik.detach(), ref[0]) and torch.equal(sc, ref[1])
    assert not sc.requires_grad
    lik.backward(torch.as_tensor(glik))
    want = TG.plf_tree_bwd_torch(*inp.values(), torch.as_tensor(glik),
                                 pm.n_sites)
    for t, w in zip((lcs, rcs, ec, rr), want):
        assert torch.equal(t.grad, w)


def test_scratch_chunking_rule():
    rows, E = 16, 159
    per_site = TG.tree_bwd_scratch_bytes(E, rows, 1)
    assert per_site == E * (rows * 4 + 1) == 10335
    # 160 taxa x 2^20 sites: one 10.8 GB chunk when the budget allows it
    assert TG.tree_bwd_chunk_sites(1 << 20, E, rows, 40 << 30) == 1 << 20
    assert TG.tree_bwd_scratch_bytes(E, rows, 1 << 20) == 10335 << 20
    # otherwise the most whole 128-site tiles that fit
    chunk = TG.tree_bwd_chunk_sites(1 << 20, E, rows, 1 << 30)
    assert chunk % 128 == 0
    assert TG.tree_bwd_scratch_bytes(E, rows, chunk) <= 1 << 30
    assert TG.tree_bwd_scratch_bytes(E, rows, chunk + 128) > 1 << 30
    with pytest.raises(ValueError, match="one tile"):
        TG.tree_bwd_chunk_sites(1 << 20, E, rows, per_site * 127)


def test_tree_bwd_wrapper_dispatch_and_checks():
    pm, sched, glik = _case(n_leaves=6, n_sites=128, seed=2)
    inp = _port_inputs(pm, sched)
    g = torch.as_tensor(glik)
    before = TG.plf_tree_bwd.launches
    TG.plf_tree_bwd(*inp.values(), g, pm.n_sites)
    assert TG.plf_tree_bwd.launches == before        # CPU: plain version
    with pytest.raises(ValueError, match="no kernel for device"):
        TG.plf_tree_bwd(*(a.to("meta") for a in inp.values()), g.to("meta"),
                        pm.n_sites)
    bad = dict(inp, bsched=inp["bsched"][:2])
    with pytest.raises(ValueError, match="bsched"):
        TG.plf_tree_bwd(*bad.values(), g, pm.n_sites)
    with pytest.raises(ValueError, match="glik"):
        TG.plf_tree_bwd(*inp.values(), g[:, :64], pm.n_sites)
    with pytest.raises(TypeError):
        TG.plf_tree_bwd(*dict(inp, codes=inp["codes"].float()).values(), g,
                        pm.n_sites)
