"""The CUDA kernels on the card, against the numpy golden model and their
plain PyTorch versions.

This file imports neither JAX nor ``plf_tpu`` nor ``tests/conftest.py``, so
it runs on a GPU machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from plf_tpu_torch import PLFConfig, PLFEngine  # noqa: E402
from plf_tpu_torch.models import PhyloModel, hky85, random_tree  # noqa: E402
from plf_tpu_torch.ops import layout as L  # noqa: E402
from plf_tpu_torch.ops.plf_node import plf_node, plf_node_torch  # noqa: E402
from plf_tpu_torch.ops.plf_tree import (plf_tree, plf_tree_occupancy,  # noqa: E402
                                        plf_tree_torch)
from plf_tpu_torch.reference import plf_reference  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def _underflow_case(n, categories, seed):
    """Random PLF inputs with the reference generator's forced-underflow
    pattern (every 4th site of x1 scaled by 1e-12)."""
    rng = np.random.default_rng(seed)
    S, C = 4, categories
    ev = rng.random((S, S), dtype=np.float32)
    left = rng.random((C, S, S), dtype=np.float32)
    right = rng.random((C, S, S), dtype=np.float32)
    x1 = rng.random((n, C, S), dtype=np.float32)
    x2 = rng.random((n, C, S), dtype=np.float32)
    x1[0::4] *= np.float32(1e-12)
    return x1, x2, left, right, ev


def _model(device, n_leaves=40, n_sites=3000, **kw):
    tips = np.random.default_rng(3).integers(-1, 14,
                                             size=(n_leaves, n_sites))
    return PhyloModel(random_tree(n_leaves, seed=3), hky85(2.0), tips,
                      alpha=0.5, device=device, **kw)


@pytest.mark.parametrize("C", [4, 5])
def test_kernel1_bit_equal_to_golden_and_plain(cuda, C):
    n = 5000 - 7
    x1, x2, left, right, ev = _underflow_case(n, C, 11)
    lane = lambda x: torch.as_tensor(
        L.pad_to_multiple(L.to_lane_major(x, 4, C), 128), device=cuda)
    consts = [torch.as_tensor(a, device=cuda) for a in (
        L.branch_to_lane_constants(left, 4, C),
        L.branch_to_lane_constants(right, 4, C),
        L.ev_to_lane_constants(ev, 4, C))]
    a, b = lane(x1).contiguous(), lane(x2).contiguous()
    before = plf_node.launches
    x3, sc = plf_node(a, b, *consts, n, categories=C)
    assert plf_node.launches == before + 1
    x3p, scp = plf_node_torch(a, b, *consts, n, categories=C)
    torch.cuda.synchronize()
    assert torch.equal(x3, x3p) and torch.equal(sc, scp)
    x3_ref, sv_ref, _ = plf_reference(x1, x2, left, right, ev, categories=C)
    np.testing.assert_array_equal(
        L.from_lane_major(x3.cpu().numpy(), 4, C, n=n), x3_ref)
    flags = sc.cpu().numpy()[0]
    np.testing.assert_array_equal(flags[:n], sv_ref.astype(np.int32))
    assert sv_ref.sum() > 0 and not flags[n:].any()
    for which in (0, 1):
        ops = [a.clone(), b.clone()]
        x3i, sci = plf_node(*ops, *consts, n, categories=C, out=ops[which])
        assert x3i.data_ptr() == ops[which].data_ptr()
        assert torch.equal(x3i, x3p) and torch.equal(sci, scp)


def test_kernel1_rejects_what_it_cannot_run(cuda):
    x = torch.rand(36, 256, device=cuda)
    c = torch.rand(36, 4, device=cuda)
    with pytest.raises(ValueError, match="C in 1..8"):
        plf_node(x, x, c, c, c, 200, categories=9)
    with pytest.raises(ValueError, match="one device"):
        plf_node(x[:16], x[:16], c[:16].cpu(), c[:16], c[:16], 200)
    plf_node_torch(x.cpu(), x.cpu(), c.cpu(), c.cpu(), c.cpu(), 200,
                   categories=9)                    # the plain version can


@pytest.mark.parametrize("tip_dtype", ["int32", "int8"])
def test_kernel2_bit_equal_to_plain(cuda, tip_dtype):
    pm = _model(cuda, config=PLFConfig(tip_dtype=tip_dtype, block_sites=128))
    args = (pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
            pm.root_rows[0], pm.n_sites)
    kw = dict(n_slots=pm.n_slots, root_slot=pm.root_slot)
    before = plf_tree.launches
    lik, sc = plf_tree(*args, **kw)
    assert plf_tree.launches == before + 1
    lik_p, sc_p = plf_tree_torch(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(lik, lik_p) and torch.equal(sc, sc_p)
    assert int(sc.sum()) > 0


def test_phylo_on_card_takes_both_kernels(cuda):
    pm, cpu = _model(cuda), _model("cpu")
    t0, n0 = plf_tree.launches, plf_node.launches
    fused = pm.log_likelihood()
    pernode = pm.log_likelihood(method="per-node")
    assert plf_tree.launches == t0 + 1
    assert plf_node.launches == n0 + len(pm.schedule)
    assert fused.scaler_total == pernode.scaler_total
    np.testing.assert_allclose(fused.site_log_likelihood,
                               pernode.site_log_likelihood, rtol=1e-6)
    # kernel 2 on the card == its plain version on the CPU, bit for bit
    np.testing.assert_array_equal(fused.site_log_likelihood,
                                  cpu.log_likelihood().site_log_likelihood)
    bf = pm.log_likelihood_bruteforce()
    assert abs(fused.log_likelihood - bf) / abs(bf) < 1e-5


def test_per_node_root_sum_ignores_tf32(cuda):
    """The per-node root reduction is elementwise fp32 in kernel 2's order,
    so no matmul precision setting reaches it: both paths agree bit for
    bit even with TF32 matmuls allowed."""
    pm = _model(cuda)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pernode = pm.log_likelihood(method="per-node")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    np.testing.assert_array_equal(pernode.site_log_likelihood,
                                  pm.log_likelihood().site_log_likelihood)


def test_kernel2_occupancy_follows_the_arena(cuda):
    pm = _model(cuda)
    blocks = [plf_tree_occupancy(pm.codes.dtype, pm.config.categories,
                                 pm.tip_table.shape[1], n_slots)
              for n_slots in (pm.n_slots, 28)]
    assert blocks[0] > blocks[1] >= 1


def test_engine_verify_exact_on_card(cuda):
    n = 10_000
    x1, x2, left, right, ev = _underflow_case(n, 4, 5)
    eng = PLFEngine(PLFConfig(), device=cuda)
    out = eng.plf(x1, x2, left, right, ev)
    assert out.x3.device.type == "cuda"
    ok, n_err, msgs = eng.verify(out, x1, x2, left, right, ev, exact=True)
    assert ok and n_err == 0, msgs
