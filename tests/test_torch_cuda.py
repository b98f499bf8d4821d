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
from plf_tpu_torch.models import (PhyloModel, codon_gy94,  # noqa: E402
                                  empirical_protein, hky85, nni_neighbors,
                                  parse_newick, random_gtr, random_tree,
                                  simulate_alignment)
from plf_tpu_torch.models import phylo as TP  # noqa: E402
from plf_tpu_torch.ops import layout as L  # noqa: E402
from plf_tpu_torch.ops.plf_mxu import (node_mxu_plan,  # noqa: E402
                                       plf_node_mxu, plf_node_mxu_torch,
                                       uses_mxu_kernels)
from plf_tpu_torch.ops.plf_node import plf_node, plf_node_torch  # noqa: E402
from plf_tpu_torch.ops.plf_tree import (plf_tree, plf_tree_mxu,  # noqa: E402
                                        plf_tree_mxu_occupancy,
                                        plf_tree_occupancy, plf_tree_torch,
                                        reorder_schedule, tree_mxu_block)
from plf_tpu_torch.ops import plf_grad as G  # noqa: E402
from plf_tpu_torch.ops import plf_tree as TT  # noqa: E402
from plf_tpu_torch.ops import plf_tree_grad as TG  # noqa: E402
from plf_tpu_torch.ops import plf_tree_seg as SG  # noqa: E402
from plf_tpu_torch.models import optimize as TO  # noqa: E402
from plf_tpu_torch.models import tree_loglik_fn  # noqa: E402
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


# ------------------------------------------------------ backward kernels --

def _sums_close(got, want, rtol=1e-4):
    """Site sums in another order: within ``rtol`` of the largest
    magnitude of each (S*C, S) matrix (fp32 sums of ~10^3-10^6 terms in a
    different order differ by ~1e-6 of that scale)."""
    w = want.reshape(-1, *want.shape[-2:])
    scale = w.abs().amax(dim=(1, 2), keepdim=True)
    scale = torch.clamp_min(scale, 1e-6 * float(scale.max()))
    err = (got.reshape(w.shape) - w).abs() / scale
    assert float(err.max()) <= rtol, float(err.max())


@pytest.mark.parametrize("C", [4, 5])
def test_kernel3_matches_plain(cuda, C):
    n = 40 * 128 - 7
    x1, x2, left, right, ev = _underflow_case(n, C, 13)
    lane = lambda x: torch.as_tensor(
        L.pad_to_multiple(L.to_lane_major(x, 4, C), 128),
        device=cuda).contiguous()
    lc, rc, ec = [torch.as_tensor(a, device=cuda) for a in (
        L.branch_to_lane_constants(left, 4, C),
        L.branch_to_lane_constants(right, 4, C),
        L.ev_to_lane_constants(ev, 4, C))]
    a, b = lane(x1), lane(x2)
    _, sc = plf_node(a, b, lc, rc, ec, n, categories=C)
    assert int(sc.sum()) > 0
    g = torch.randn(a.shape, generator=torch.Generator(device=cuda)
                    .manual_seed(3), device=cuda)
    consts = [lc, rc] + [G.transpose_lane_constants(t, 4, C)
                         for t in (lc, rc, ec)]
    before = G.plf_node_bwd.launches
    k1 = G.plf_node_bwd(a, b, g, sc, *consts, n, categories=C)
    k2 = G.plf_node_bwd(a, b, g, sc, *consts, n, categories=C)
    assert G.plf_node_bwd.launches == before + 2
    p = G.plf_node_bwd_torch(a, b, g, sc, *consts, n, categories=C)
    torch.cuda.synchronize()
    assert torch.equal(k1[0], p[0]) and torch.equal(k1[1], p[1])
    assert not k1[0][:, n:].any()
    for i in range(5):
        assert torch.equal(k1[i], k2[i])       # run to run, bit for bit
    for i in (2, 3, 4):
        _sums_close(k1[i], p[i])


@pytest.mark.parametrize("tip_dtype,extra", [("int32", {}), ("int8", {}),
                                             ("int32", {"p_inv": 0.2})])
def test_kernel4_matches_plain(cuda, tip_dtype, extra):
    """Also at C = 5 (+I), whose kernel instance spills registers."""
    pm = _model(cuda, config=PLFConfig(tip_dtype=tip_dtype, block_sites=128),
                **extra)
    sched = reorder_schedule(pm.schedule, pm.tree.n_leaves)
    bsched = torch.as_tensor(
        TG.backward_schedule(sched, pm.tree.n_leaves), device=cuda)
    C = pm.config.categories
    T = lambda t: G.transpose_lane_constants(t, 4, C)
    args = (pm.codes, bsched, pm.lcs, pm.rcs, T(pm.lcs), T(pm.rcs), pm.ec,
            T(pm.ec), pm.tip_table, pm.root_rows[0])
    glik = torch.randn((1, pm.n_pad), generator=torch.Generator(device=cuda)
                       .manual_seed(5), device=cuda)
    before = TG.plf_tree_bwd.launches
    k1 = TG.plf_tree_bwd(*args, glik, pm.n_sites, categories=C)
    assert TG.plf_tree_bwd.last_scratch["chunks"] == 1
    k2 = TG.plf_tree_bwd(*args, glik, pm.n_sites, categories=C)
    # a budget of 7 tiles' checkpoint: several chunks, the last one short
    per_tile = TG.tree_bwd_scratch_bytes(len(sched), pm.config.rows, 128)
    k3 = TG.plf_tree_bwd(*args, glik, pm.n_sites, categories=C,
                         max_scratch_bytes=7 * per_tile)
    assert TG.plf_tree_bwd.last_scratch["chunks"] == -(-pm.n_pad // 896)
    assert TG.plf_tree_bwd.launches == before + 3
    p = TG.plf_tree_bwd_torch(*args, glik, pm.n_sites, categories=C)
    torch.cuda.synchronize()
    for i in range(4):
        assert torch.equal(k1[i], k2[i])       # run to run, bit for bit
    for k in (k1, k3):
        for i in range(3):
            _sums_close(k[i], p[i])
        _sums_close(k[3].reshape(1, -1, 1), p[3].reshape(1, -1, 1))


def _caterpillar_newick(n_leaves, grown_left):
    """A caterpillar whose internal child is always the left one (or the
    right one): the op before each op is its internal child."""
    nwk = "A0:0.1"
    for i in range(1, n_leaves):
        nwk = (f"({nwk},A{i}:0.1):0.1" if grown_left
               else f"(A{i}:0.1,{nwk}):0.1")
    return nwk + ";"


def _balanced_newick(depth):
    names = iter(range(1 << depth))

    def sub(d):
        if d == 0:
            return f"A{next(names)}:0.2"
        return f"({sub(d - 1)},{sub(d - 1)}):0.2"
    return sub(depth) + ";"


def _shaped_tree(shape):
    if shape == "random":
        return random_tree(64, seed=5)
    if shape == "balanced":
        return parse_newick(_balanced_newick(6))
    return parse_newick(_caterpillar_newick(64, shape == "left"))


def _carried(sched, n_leaves):
    """How many ops take their left and their right operand from the op
    evaluated just before them (kernel 4 carries it in registers)."""
    lpos, rpos, _ = TG.backward_schedule(sched, n_leaves)
    prev = n_leaves + np.arange(len(sched)) - 1
    return int((lpos == prev)[1:].sum()), int((rpos == prev)[1:].sum())


@pytest.mark.parametrize("shape", ["left", "right", "balanced", "random"])
def test_kernel4_carried_operands(cuda, shape):
    """Kernel 4 takes the operand of the op evaluated last from registers
    in both sweeps: on a caterpillar whose carried child is always the
    left one, one whose carried child is always the right one, a balanced
    tree (two internal children per op, the right one carried) and a
    random tree (both), at more tiles than a wave of blocks holds (so each
    block adds several tiles into its row) with rescaled sites and a real
    step's cotangent: sums within 1e-4 of scale of the plain version,
    chunked or not, and bit-identical run to run."""
    tree = _shaped_tree(shape)
    n_leaves = tree.n_leaves
    resident = TG.tree_bwd_resident_blocks(cuda, 4, 4, 16)
    n_sites = 2 * resident * 128 + 77
    tips = np.random.default_rng(11).integers(-1, 14, size=(n_leaves,
                                                             n_sites))
    pm = PhyloModel(tree, hky85(2.0), tips, alpha=0.5, device=cuda,
                    config=PLFConfig(block_sites=128))
    sched = reorder_schedule(pm.schedule, n_leaves)
    left, right = _carried(sched, n_leaves)
    want = {"left": left > 0 and right == 0, "right": right > 0 and left == 0,
            "balanced": right == len(sched) - n_leaves // 2 and left == 0,
            "random": left > 0 and right > 0}
    assert want[shape], (left, right)
    bsched = torch.as_tensor(TG.backward_schedule(sched, n_leaves),
                             device=cuda)
    T = lambda t: G.transpose_lane_constants(t, 4, 4)
    args = (pm.codes, bsched, pm.lcs, pm.rcs, T(pm.lcs), T(pm.rcs), pm.ec,
            T(pm.ec), pm.tip_table, pm.root_rows[0])
    lik, sc = plf_tree(pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec,
                       pm.tip_table, pm.root_rows[0], pm.n_sites,
                       n_slots=pm.n_slots, root_slot=pm.root_slot)
    assert int(sc.sum()) > 0
    glik = (pm.wgt_pad.to(torch.float32) / lik).contiguous()
    k1 = TG.plf_tree_bwd(*args, glik, pm.n_sites)
    assert TG.plf_tree_bwd.last_scratch["chunks"] == 1
    k2 = TG.plf_tree_bwd(*args, glik, pm.n_sites)
    per_tile = TG.tree_bwd_scratch_bytes(len(sched), 16, 128)
    k3 = TG.plf_tree_bwd(*args, glik, pm.n_sites,
                         max_scratch_bytes=(resident + 5) * per_tile)
    assert TG.plf_tree_bwd.last_scratch["chunks"] == 2
    p = TG.plf_tree_bwd_torch(*args, glik, pm.n_sites)
    torch.cuda.synchronize()
    for i in range(4):
        assert torch.equal(k1[i], k2[i])       # run to run, bit for bit
    for k in (k1, k3):
        for i in range(3):
            _sums_close(k[i], p[i])
        _sums_close(k[3].reshape(1, -1, 1), p[3].reshape(1, -1, 1))


def test_backward_wrappers_reject_what_they_cannot_run(cuda):
    x = torch.rand(36, 256, device=cuda)
    c = torch.rand(36, 4, device=cuda)
    sc = torch.zeros((1, 256), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="C in 1..8"):
        G.plf_node_bwd(x, x, x, sc, c, c, c, c, c, 200, categories=9)
    y, d = x[:16, :200].contiguous(), c[:16]
    with pytest.raises(ValueError, match="multiple of 128"):
        G.plf_node_bwd(y, y, y, sc[:, :200].contiguous(), d, d, d, d, d, 200)
    with pytest.raises(ValueError, match="contiguous"):
        G.plf_node_bwd(x[:16], x[:16], x[:16], sc, d, d, d, d,
                       torch.rand(4, 16, device=cuda).t(), 200)
    with pytest.raises(ValueError, match="one device"):
        G.plf_node_bwd(x[:16], x[:16], x[:16], sc.cpu(), d, d, d, d, d, 200)
    pm = _model(cuda, n_leaves=6, n_sites=300)
    E = len(pm.schedule)
    bs = torch.zeros((3, E), dtype=torch.int32, device=cuda)
    g = torch.zeros((1, pm.n_pad), device=cuda)
    with pytest.raises(ValueError, match="one device"):
        TG.plf_tree_bwd(pm.codes, bs, pm.lcs, pm.rcs, pm.lcs, pm.rcs, pm.ec,
                        pm.ec, pm.tip_table, pm.root_rows[0], g.cpu(),
                        pm.n_sites)
    with pytest.raises(ValueError, match="one tile"):
        TG.plf_tree_bwd(pm.codes, bs, pm.lcs, pm.rcs, pm.lcs, pm.rcs, pm.ec,
                        pm.ec, pm.tip_table, pm.root_rows[0], g, pm.n_sites,
                        max_scratch_bytes=1000)


def test_tree_and_kernel_gradients_agree(cuda):
    """On a 20-leaf tree: the "tree" backend (kernels 2 + 4) and the
    "kernel" backend (kernels 1 + 3, once per node) give the same value
    and gradient (rtol 2e-4, atol 1e-4 of the largest, the JAX package's
    bar), and auto takes "segmented" on the card (kernels 7 + 8, the
    faster pair for DNA): the same value, the gradient within 3e-6 of
    scale of "tree"'s (another summation order)."""
    pm = _model(cuda, n_leaves=20, n_sites=5000)
    E = len(pm.schedule)
    out = {}
    counted = (plf_tree, TG.plf_tree_bwd, plf_node, G.plf_node_bwd,
               SG.plf_tree_seg, SG.plf_tree_seg_bwd)
    want = {"tree": (1, 1, 0, 0, 0, 0), "kernel": (0, 0, E, E, 0, 0),
            "auto": (0, 0, 0, 0, 1, 1)}
    for backend in ("tree", "kernel", "auto"):
        counts = tuple(f.launches for f in counted)
        fn, t0 = tree_loglik_fn(pm, backend=backend)
        t = torch.tensor(t0, device=cuda, requires_grad=True)
        v = fn(t)
        v.backward()
        out[backend] = (float(v.detach()), t.grad.cpu().numpy())
        runs = tuple(f.launches - c for f, c in zip(counted, counts))
        assert runs == want[backend], (backend, runs)
        assert fn.engine == ("segmented" if backend == "auto" else backend)
    (v_t, g_t), (v_k, g_k) = out["tree"], out["kernel"]
    assert v_t == pytest.approx(v_k, rel=1e-5)
    assert v_t == pytest.approx(pm.log_likelihood().log_likelihood, rel=1e-5)
    np.testing.assert_allclose(g_t, g_k, rtol=2e-4,
                               atol=1e-4 * np.abs(g_k).max())
    assert out["auto"][0] == pytest.approx(v_t, rel=1e-6)
    assert np.abs(out["auto"][1] - g_t).max() <= 3e-6 * np.abs(g_t).max()


# ------------------------------------- kernel 9 and kernel 3m (S != 4) --

def _gen_consts(cuda, S, C, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a, device=cuda) for a in (
        L.branch_to_lane_constants(rng.random((C, S, S), np.float32), S, C),
        L.branch_to_lane_constants(rng.random((C, S, S), np.float32), S, C),
        L.ev_to_lane_constants(rng.random((S, S), np.float32), S, C))]


@pytest.mark.parametrize("S,C", [(4, 4), (4, 5), (20, 4), (61, 4)])
def test_kernel9_equals_plain(cuda, S, C):
    """The compute-only probe == its plain version bit for bit (at S = 61
    every checksum is +inf after 8 nodes, and equal as such); one launch
    counted per call."""
    from plf_tpu_torch.ops.plf_node import plf_node_gen, plf_node_gen_torch
    consts = _gen_consts(cuda, S, C)
    kw = dict(states=S, categories=C, block_sites=1024, n_blocks=3,
              inner_iters=8)
    before = plf_node_gen.launches
    got = plf_node_gen(*consts, **kw)
    assert plf_node_gen.launches == before + 1
    want = plf_node_gen_torch(*consts, **kw)
    torch.cuda.synchronize()
    assert got.shape == (1, 3072)
    assert torch.equal(got, want)
    assert bool(torch.isposinf(got).all()) == (S == 61)


def test_kernel9_rejects_what_it_cannot_run(cuda):
    from plf_tpu_torch.ops.plf_node import plf_node_gen
    lc, rc, ec = _gen_consts(cuda, 4, 9)
    with pytest.raises(ValueError, match="C in 1..8"):
        plf_node_gen(lc, rc, ec, states=4, categories=9)
    lc, rc, ec = _gen_consts(cuda, 61, 10)
    with pytest.raises(ValueError, match="shared memory"):
        plf_node_gen(lc, rc, ec, states=61, categories=10)
    lc, rc, ec = _gen_consts(cuda, 20, 4)
    with pytest.raises(ValueError, match="one device"):
        plf_node_gen(lc, rc.cpu(), ec, states=20)


@pytest.mark.parametrize("S,C", [(4, 4), (4, 5), (20, 4), (13, 3),
                                 (61, 4)])
def test_kernel9_odd_shapes_equal_plain(cuda, S, C):
    """The probe == its plain version bit for bit where a site's block
    index wraps inside a tile and the last tile (and, at S = 4, the last
    block) is cut short: odd block_sites, n a multiple of neither 32 nor
    256; S = 13 takes padded operator rows (Sp = 16)."""
    from plf_tpu_torch.ops.plf_node import plf_node_gen, plf_node_gen_torch
    consts = _gen_consts(cuda, S, C, seed=S + C)
    for block_sites, n_blocks in ((37, 5), (1023, 3)):
        kw = dict(states=S, categories=C, block_sites=block_sites,
                  n_blocks=n_blocks, inner_iters=3)
        got = plf_node_gen(*consts, **kw)
        want = plf_node_gen_torch(*consts, **kw)
        torch.cuda.synchronize()
        assert got.shape == (1, block_sites * n_blocks)
        assert torch.equal(got, want), (block_sites, n_blocks)


#: Kernel 9's plan by (S, C): threads per block, tile sites, dynamic shared
#: memory bytes, operators in shared memory (plf_gen_plan, csrc/plf_gen.cu):
#: one thread per 4-row x 4-site job of a stage on 32-site tiles with the
#: operators staged where tiles and operators fit half a block's shared
#: memory, else 4 x 8 jobs on 64-site tiles (32 and 4 where those do not
#: fit: S = 61, C = 9, 1,152 jobs in three rounds), the operators read from
#: device memory.
GEN_PLANS = {(4, 4): (128, 256, 0, 1), (20, 4): (160, 32, 49920, 1),
             (61, 4): (512, 64, 187392, 0), (13, 3): (96, 32, 22464, 1),
             (20, 8): (320, 32, 99840, 1), (61, 9): (384, 32, 210816, 0)}


def test_kernel9_plan(cuda):
    """The library's plan (gen_plan) as GEN_PLANS pins it, with at least
    two blocks an SM at S = 20."""
    from plf_tpu_torch.ops.plf_node import gen_plan
    for (S, C), want in GEN_PLANS.items():
        plan = gen_plan(S, C)
        got = (plan["threads"], plan["tile_sites"], plan["smem_bytes"],
               plan["ops_shared"])
        assert got == want, (S, C, plan)
        assert plan["blocks_per_sm"] >= 1
    assert gen_plan(20, 4)["blocks_per_sm"] >= 2
    assert gen_plan(20, 4)["sp"] == 20 and gen_plan(13, 3)["sp"] == 16


@pytest.mark.parametrize("tip_dtype", ["int32", "int8"])
@pytest.mark.parametrize("categories,p_inv", [(1, None), (4, 0.2)])
@pytest.mark.parametrize("shape", ["left", "right", "balanced", "random"])
def test_kernel2_carried_program_equals_plain(cuda, shape, categories, p_inv,
                                              tip_dtype):
    """Kernel 2 runs the model's carried program (operands of the op
    before from registers, only outputs a later op but the next reads
    stored) and == its plain version bit for bit, site likelihoods and
    scaler counts: on caterpillars carrying the left or the right child
    (no slot at all), a balanced and a random 64-taxon tree, C = 1 and 5
    (+I), int32 and int8 tips, padding sites past n, and n_pad a multiple
    of no block; also on the uncarried schedule.  One launch a call."""
    tree = _shaped_tree(shape)
    n_sites = 3 * 128 + 77
    tips = np.random.default_rng(13).integers(-1, 14, size=(tree.n_leaves,
                                                             n_sites))
    pm = PhyloModel(tree, hky85(2.0), tips, alpha=0.5, p_inv=p_inv,
                    device=cuda, config=PLFConfig(
                        categories=categories, tip_dtype=tip_dtype,
                        block_sites=128))
    C = pm.lcs.shape[1] // 4
    assert C == (5 if p_inv else 1)
    assert pm.carry_slots <= pm.n_slots
    if shape in ("left", "right"):
        assert pm.carry_slots == 0
    kw = dict(n_slots=pm.n_slots, root_slot=pm.root_slot, categories=C)
    for n_pad in (pm.n_pad, n_sites + 5):
        codes = pm.codes[:, :n_pad].contiguous()
        args = (codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
                pm.root_rows[0], pm.n_sites)
        before = plf_tree.launches
        lik, sc = plf_tree(*args, **kw,
                           program=pm.tree_program)
        assert plf_tree.launches == before + 1
        lik_u, sc_u = plf_tree(*args, **kw)   # derived from pm.sched
        lik_p, sc_p = plf_tree_torch(*args, **kw)
        torch.cuda.synchronize()
        assert lik.shape == (1, n_pad)
        assert torch.equal(lik, lik_p) and torch.equal(sc, sc_p)
        assert torch.equal(lik_u, lik_p) and torch.equal(sc_u, sc_p)
        if shape != "balanced":
            assert int(sc.sum()) > 0
    plan = TT.tree_plan(pm.codes.dtype, C, pm.tip_table.shape[1],
                        pm.carry_slots)
    assert plan["slots"] == pm.carry_slots and plan["sites"] == 128
    assert plan["threads"] * plan["sites_per_thread"] == 128
    assert plan["blocks_per_sm"] >= 1
    assert plan["smem_bytes"] == TT.tree_fused_smem_bytes(
        pm.carry_slots, 4 * C, pm.tip_table.shape[1])


@pytest.mark.parametrize("S,C,n", [(20, 4, 40 * 128 - 37),
                                   (20, 5, 40 * 128 - 37),
                                   (61, 4, 40 * 128 - 37),
                                   (13, 3, 40 * 128 - 37),
                                   (20, 4, 40 * 128 + 1),
                                   (61, 4, 40 * 128 + 1)])
def test_kernel3m_matches_plain(cuda, S, C, n):
    """Kernel 3m (plf_node_bwd at S != 4): gx1/gx2 == plain bit for bit,
    zero on padding sites; the operator sums within 1e-4 of scale of the
    plain version and bit-identical run to run; plf_node_bwd_mxu counts
    the launches, plf_node_bwd none.  Its plan is kernel 4m's: 32-site
    tiles with the accumulators in shared memory at S = 20, 8-site tiles
    with them in device memory at S = 61; n = 40 * 128 + 1 puts one site
    in the last tile."""
    n_pad = L.sites_padding(n, 128)
    rng = np.random.default_rng(S)
    lc, rc, ec = _gen_consts(cuda, S, C, seed=S)
    gen = torch.Generator(device=cuda).manual_seed(S)
    a = torch.rand((S * C, n_pad), generator=gen, device=cuda)
    b = torch.rand((S * C, n_pad), generator=gen, device=cuda)
    a[:, 0::4] *= 1e-16
    a[:, n:] = 0.0
    b[:, n:] = 0.0
    _, sc = plf_node(a, b, lc, rc, ec, n, states=S, categories=C)
    assert int(sc.sum()) > 0
    g = torch.as_tensor(rng.standard_normal((S * C, n_pad)),
                        dtype=torch.float32, device=cuda)
    consts = [lc, rc] + [G.transpose_lane_constants(t, S, C)
                         for t in (lc, rc, ec)]
    before = (G.plf_node_bwd.launches, G.plf_node_bwd_mxu.launches)
    k1 = G.plf_node_bwd(a, b, g, sc, *consts, n, states=S, categories=C)
    k2 = G.plf_node_bwd(a, b, g, sc, *consts, n, states=S, categories=C)
    assert (G.plf_node_bwd.launches, G.plf_node_bwd_mxu.launches) == (
        before[0], before[1] + 2)
    p = G.plf_node_bwd_torch(a, b, g, sc, *consts, n, states=S,
                             categories=C)
    torch.cuda.synchronize()
    assert torch.equal(k1[0], p[0]) and torch.equal(k1[1], p[1])
    assert not k1[0][:, n:].any() and not k1[1][:, n:].any()
    for i in range(5):
        assert torch.equal(k1[i], k2[i])       # run to run, bit for bit
    for i in (2, 3, 4):
        _sums_close(k1[i], p[i])
    acc_shared, resident, ts = G._mxu_plan(a.device, S, C)
    assert ts == (32 if S == 20 else 8) and resident > 0
    if C == 4:
        assert acc_shared == (S == 20)


def test_kernel3m_rejects_what_it_cannot_run(cuda):
    x = torch.rand(80, 256, device=cuda)
    c = torch.rand(80, 20, device=cuda)
    sc = torch.zeros((1, 256), dtype=torch.int32, device=cuda)
    y, d = x[:, :200].contiguous(), c
    with pytest.raises(ValueError, match="multiple of 128"):
        G.plf_node_bwd(y, y, y, sc[:, :200].contiguous(), d, d, d, d, d, 200,
                       states=20)
    with pytest.raises(ValueError, match="contiguous"):
        G.plf_node_bwd(x, x, x, sc, d, d, d, d,
                       torch.rand(20, 80, device=cuda).t(), 200, states=20)
    with pytest.raises(ValueError, match="one device"):
        G.plf_node_bwd(x, x, x, sc.cpu(), d, d, d, d, d, 200, states=20)
    big = torch.rand(61 * 20, 128, device=cuda)
    cb = torch.rand(61 * 20, 61, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        G.plf_node_bwd(big, big, big, sc[:, :128].contiguous(), cb, cb, cb,
                       cb, cb, 100, states=61, categories=20)


@pytest.mark.parametrize("states", [20, 61])
def test_kernel_backend_at_other_state_counts(cuda, states):
    """tree_loglik_fn(backend="kernel") on a "vpu" model at S = 20 (LG)
    and S = 61 (GY94, simulated codons): one kernel-1m and one kernel-3m
    launch per node and step, nothing else; value within rel 1e-5 and
    gradient within rtol 2e-4 / 1e-4 of the largest entry of the "tree"
    step on the same model; "auto" takes "tree", measured faster at 16
    taxa x 1,500 sites at both S (optimize.KERNEL_MIN_NODE_SITES)."""
    tree = random_tree(16, seed=8, mean_branch=0.2)
    if states == 20:
        model = empirical_protein("lg")
        tips = np.random.default_rng(8).integers(-1, 23, size=(16, 1500))
    else:
        model = codon_gy94(2.0, 0.3)
        tips = simulate_alignment(tree, model, 1500, alpha=0.6, seed=8)
    pm = PhyloModel(tree, model, tips, alpha=0.6,
                    config=PLFConfig(states=states, kernel_variant="vpu"))
    E = len(pm.schedule)
    out = {}
    for backend in ("kernel", "tree"):
        fn, t0 = tree_loglik_fn(pm, backend=backend)
        assert (fn.engine, fn.variant) == (backend, "vpu")
        counts = [f.launches for f in _counted() + (G.plf_node_bwd_mxu,)]
        t = torch.tensor(t0, device=cuda, requires_grad=True)
        v = fn(t)
        v.backward()
        runs = [f.launches - c for f, c in
                zip(_counted() + (G.plf_node_bwd_mxu,), counts)]
        if backend == "kernel":
            assert runs == [0, 0, 0, 0, E, 0, 0, E], runs
        out[backend] = (float(v.detach()), t.grad.cpu().numpy())
    (v_k, g_k), (v_t, g_t) = out["kernel"], out["tree"]
    assert tree_loglik_fn(pm)[0].engine == "tree"
    assert v_k == pytest.approx(v_t, rel=1e-5)
    np.testing.assert_allclose(g_k, g_t, rtol=2e-4,
                               atol=1e-4 * np.abs(g_t).max())


# ------------------------------------------------- matrix-form kernels --

MXU_VARIANTS = ["mxu", "mxu_3x", "mxu_bf16"]


@pytest.mark.parametrize("variant", MXU_VARIANTS)
@pytest.mark.parametrize("S,C", [(20, 4), (20, 5), (61, 4)])
def test_kernel1m_equals_plain(cuda, variant, S, C):
    """Kernel 1m == its plain version bit for bit in every mode (same
    products, same sums in the same order), out of place and in place;
    "mxu" also == the golden model."""
    n = 300 - 5
    x1, x2, left, right, ev = _underflow_case_s(n, S, C, 17)
    lane = lambda x: torch.as_tensor(
        L.pad_to_multiple(L.to_lane_major(x, S, C), 128),
        device=cuda).contiguous()
    consts = [torch.as_tensor(a, device=cuda) for a in (
        L.branch_to_lane_constants(left, S, C),
        L.branch_to_lane_constants(right, S, C),
        L.ev_to_lane_constants(ev, S, C))]
    a, b = lane(x1), lane(x2)
    kw = dict(states=S, categories=C, variant=variant)
    before = plf_node_mxu.launches
    x3, sc = plf_node(a, b, *consts, n, **kw)
    assert plf_node_mxu.launches == before + 1
    x3p, scp = plf_node_mxu_torch(a, b, *consts, n, **kw)
    torch.cuda.synchronize()
    assert torch.equal(x3, x3p) and torch.equal(sc, scp)
    assert int(sc.sum()) > 0 and not sc[0, n:].any()
    if variant == "mxu":
        x3_ref, sv_ref, _ = plf_reference(x1, x2, left, right, ev, states=S,
                                          categories=C)
        np.testing.assert_array_equal(
            L.from_lane_major(x3.cpu().numpy(), S, C, n=n), x3_ref)
    for which in (0, 1):
        ops = [a.clone(), b.clone()]
        x3i, sci = plf_node_mxu(*ops, *consts, n, out=ops[which], **kw)
        assert x3i.data_ptr() == ops[which].data_ptr()
        assert torch.equal(x3i, x3p) and torch.equal(sci, scp)


#: Kernel 1m's plan at each (S, C), as its library reports it
#: (node_mxu_plan): (sites per tile, threads per block).
NODE_MXU_PLANS = {(20, 4): (32, 320), (61, 4): (32, 416), (13, 3): (32, 288),
                  (20, 5): (32, 416), (4, 4): (32, 128)}


def test_kernel1m_plan(cuda):
    """Kernel 1m's launch shape in every mode and storage: the pinned tile
    and threads (plf_mxu.cuh's job shape on that tile), and at least one
    resident block per SM."""
    for (S, C), want in NODE_MXU_PLANS.items():
        for variant in MXU_VARIANTS:
            for bf16 in (False, True):
                ts, threads, blocks = node_mxu_plan(S, C, variant, bf16)
                assert (ts, threads) == want and blocks >= 1, (S, C, variant)


#: Edge shapes of kernel 1m: (S, C, n, n_pad).  n one site past a 32-site
#: tile; n_pad % 4 != 0, % 8 != 0 and odd (rows not 16- or 4-byte
#: aligned); S = 61; S = 13 with C = 3 (V = 1, five-row jobs).
NODE_MXU_EDGES = [(20, 4, 33, 128), (20, 4, 301, 302), (20, 4, 301, 301),
                  (20, 4, 1997, 2000), (61, 4, 33, 36), (61, 4, 700, 701),
                  (13, 3, 295, 300), (13, 3, 97, 99)]


@pytest.mark.parametrize("variant", MXU_VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,C,n,n_pad", NODE_MXU_EDGES)
def test_kernel1m_edges_equal_plain(cuda, variant, dtype, S, C, n, n_pad):
    """Kernel 1m at its edge shapes: x3 and the flags equal the plain
    version's bit for bit, out of place and in place over x1 and over x2;
    "mxu" in fp32 storage also equals the golden model."""
    x1, x2, left, right, ev = _underflow_case_s(n, S, C, 23)
    lane = lambda x: torch.as_tensor(np.pad(
        L.to_lane_major(x, S, C), ((0, 0), (0, n_pad - n))),
        device=cuda).to(dtype).contiguous()
    consts = [torch.as_tensor(a, device=cuda) for a in (
        L.branch_to_lane_constants(left, S, C),
        L.branch_to_lane_constants(right, S, C),
        L.ev_to_lane_constants(ev, S, C))]
    a, b = lane(x1), lane(x2)
    kw = dict(states=S, categories=C, variant=variant)
    x3p, scp = plf_node_mxu_torch(a, b, *consts, n, **kw)
    before = plf_node_mxu.launches
    x3, sc = plf_node_mxu(a, b, *consts, n, **kw)
    runs = [(x3, sc)]
    for which in (0, 1):
        ops = [a.clone(), b.clone()]
        x3i, sci = plf_node_mxu(*ops, *consts, n, out=ops[which], **kw)
        assert x3i.data_ptr() == ops[which].data_ptr()
        runs.append((x3i, sci))
    torch.cuda.synchronize()
    assert plf_node_mxu.launches == before + len(runs)
    for x3k, sck in runs:
        assert x3k.dtype == dtype
        assert torch.equal(x3k, x3p) and torch.equal(sck, scp)
    assert int(sc.sum()) > 0 and not sc[0, n:].any()
    if variant == "mxu" and dtype == torch.float32:
        x3_ref, _, _ = plf_reference(x1, x2, left, right, ev, states=S,
                                     categories=C)
        np.testing.assert_array_equal(
            L.from_lane_major(x3.cpu().numpy(), S, C, n=n), x3_ref)


def _underflow_case_s(n, S, C, seed):
    rng = np.random.default_rng(seed)
    ev = rng.random((S, S), dtype=np.float32)
    left = rng.random((C, S, S), dtype=np.float32)
    right = rng.random((C, S, S), dtype=np.float32)
    x1 = rng.random((n, C, S), dtype=np.float32)
    x2 = rng.random((n, C, S), dtype=np.float32)
    x1[0::4] *= np.float32(1e-16)   # small enough to rescale at S = 61
    return x1, x2, left, right, ev


def _protein_model(device, variant, n_leaves=24, n_sites=1000, states=20,
                   p_inv=None, tip_dtype="int32", categories=4):
    rng = np.random.default_rng(4)
    tips = rng.integers(-1, states + 3, size=(n_leaves, n_sites))
    model = (empirical_protein("lg") if states == 20
             else random_gtr(states, seed=2))
    return PhyloModel(random_tree(n_leaves, seed=4), model, tips, alpha=0.5,
                      p_inv=p_inv,
                      config=PLFConfig(states=states, block_sites=128,
                                       kernel_variant=variant,
                                       tip_dtype=tip_dtype,
                                       categories=categories),
                      device=device)


#: Kernel 2m's block at each (S, C) of test_kernel2m_equals_plain, as its
#: library reports it (tree_mxu_block): (threads, rows per job).
TREE_MXU_BLOCKS = {(20, 4): (160, 4), (20, 5): (200, 4), (61, 4): (416, 5),
                   (13, 3): (72, 5), (61, 5): (264, 5), (52, 5): (264, 4),
                   (4, 4): (32, 4), (4, 1): (8, 4), (20, 1): (40, 4),
                   (61, 8): (416, 5)}


def test_kernel2m_block_takes_every_job_in_whole_rounds(cuda):
    """The library's block for kernel 2m (tree_mxu_block) at each pinned
    (S, C): test_torch_mxu.py::test_kernel2m_job_slots_take_every_job_once
    walks node_tile's job loop over these values on the CPU."""
    for (S, C), want in TREE_MXU_BLOCKS.items():
        assert tree_mxu_block(S, C) == want, (S, C)


@pytest.mark.parametrize("variant", MXU_VARIANTS + ["vpu"])
@pytest.mark.parametrize("states,extra", [(20, {}), (20, {"p_inv": 0.2}),
                                          (20, {"tip_dtype": "int8"}),
                                          (61, {}), (13, {"categories": 3}),
                                          (61, {"p_inv": 0.2}),
                                          (52, {"p_inv": 0.2}),
                                          (4, {"n_leaves": 32}),
                                          (4, {"categories": 1}),
                                          (20, {"categories": 1})])
def test_kernel2m_equals_plain(cuda, variant, states, extra):
    """Kernel 2m == its plain version bit for bit (site likelihoods and
    rescale counts) for every variant, with +I (C = 5), int8 tips, at S =
    61, at S = 13, C = 3, at S = 4 (DNA in the matrix forms; "vpu" there
    is kernel 2's, so 2m is called directly) and at C = 1, with its
    operators split in the wrapper or by the model.  Its blocks take one
    job slot per job of a stage, as TREE_MXU_BLOCKS pins them: one round
    at S = 20 (160 threads; 200 at C = 5, 40 at C = 1), S = 13 (72; jobs
    of 5 rows), S = 61 (416) and S = 4 (32; 8 at C = 1); two at S = 61, C
    = 5 and at S = 52, C = 5, whose second rounds lack a job (65 jobs, 264
    threads)."""
    kw = {"n_leaves": 12, "n_sites": 700, "states": states}
    kw.update(extra)
    pm = _protein_model(cuda, variant, **kw)
    C = pm.config.categories
    run = plf_tree if uses_mxu_kernels(variant, states) else plf_tree_mxu
    args = (pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
            pm.root_rows[0], pm.n_sites)
    kwt = dict(n_slots=pm.n_slots, root_slot=pm.root_slot, states=states,
               categories=C, variant=variant)
    before = plf_tree_mxu.launches
    lik, sc = run(*args, **kwt)
    lik_m, sc_m = run(*args, **kwt, planes=pm._planes())
    assert plf_tree_mxu.launches == before + 2
    lik_p, sc_p = plf_tree_torch(*args, **kwt)
    torch.cuda.synchronize()
    assert torch.equal(lik, lik_p) and torch.equal(sc, sc_p)
    assert torch.equal(lik_m, lik) and torch.equal(sc_m, sc)
    assert int(sc.sum()) > 0


def test_protein_on_card_takes_2m_and_1m(cuda):
    """The default protein model (auto: mxu_3x) on the card: fused runs
    kernel 2m once, per-node kernel 1m once per node; they agree, equal the
    plain versions on the CPU bit for bit, and match the float64 brute
    force."""
    tips = np.random.default_rng(5).integers(-1, 23, size=(20, 2000))
    pm = PhyloModel(random_tree(20, seed=5), empirical_protein("lg"), tips,
                    alpha=0.5)
    assert pm.device.type == "cuda"
    assert pm.config.resolved_kernel_variant == "mxu_3x" and pm.can_fuse()
    t0, n0 = plf_tree_mxu.launches, plf_node_mxu.launches
    fused = pm.log_likelihood()
    pernode = pm.log_likelihood(method="per-node")
    assert plf_tree_mxu.launches == t0 + 1
    assert plf_node_mxu.launches == n0 + len(pm.schedule)
    assert fused.scaler_total == pernode.scaler_total
    np.testing.assert_allclose(fused.site_log_likelihood,
                               pernode.site_log_likelihood, rtol=1e-5)
    cpu = PhyloModel(random_tree(20, seed=5), empirical_protein("lg"), tips,
                     alpha=0.5, device="cpu")
    np.testing.assert_array_equal(fused.site_log_likelihood,
                                  cpu.log_likelihood().site_log_likelihood)
    bf = pm.log_likelihood_bruteforce()
    assert abs(fused.log_likelihood - bf) / abs(bf) < 1e-4


def test_kernel2m_occupancy_and_rejections(cuda):
    pm = _protein_model(cuda, "mxu_3x", n_leaves=12, n_sites=300)
    n_codes = pm.tip_table.shape[1]
    blocks = [plf_tree_mxu_occupancy(pm.codes.dtype, 20, 4, n_codes, s,
                                     "mxu_3x") for s in (pm.n_slots, 18)]
    assert blocks[0] >= blocks[1] >= 1
    args = (pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
            pm.root_rows[0], pm.n_sites)
    with pytest.raises(ValueError, match="per-node"):
        plf_tree_mxu(*args, n_slots=200, root_slot=0, variant="mxu_3x")
    with pytest.raises(ValueError, match="variant"):
        plf_tree_mxu(*args, n_slots=pm.n_slots, root_slot=pm.root_slot,
                     variant="tf32")
    x = torch.rand(80, 256, device=cuda)
    c = torch.rand(80, 20, device=cuda)
    with pytest.raises(ValueError, match="one device"):
        plf_node_mxu(x, x, c.cpu(), c, c, 200, variant="mxu")


# ------------------------------ kernels 2 and 2m with a candidate axis --

def _nni_batch(device, variant, states=4, n_leaves=24, n_sites=1000,
               tip_dtype="int32", categories=4, p_inv=None):
    """The incumbent and its NNI neighbours, sharing its device tensors."""
    rng = np.random.default_rng(6)
    tips = rng.integers(-1, states + (10 if states == 4 else 3),
                        size=(n_leaves, n_sites))
    model = {4: lambda: hky85(2.0), 20: lambda: empirical_protein("lg")}.get(
        states, lambda: random_gtr(states, seed=2))()
    cfg = PLFConfig(states=states, block_sites=128, kernel_variant=variant,
                    tip_dtype=tip_dtype, categories=categories)
    tree = random_tree(n_leaves, seed=6)
    pm0 = PhyloModel(tree, model, tips, alpha=0.5, p_inv=p_inv, config=cfg,
                     device=device)
    return [pm0] + [PhyloModel(t, model, tips, alpha=0.5, p_inv=p_inv,
                               config=cfg, share_device_from=pm0,
                               device=device)
                    for t in nni_neighbors(tree)]


def _batch_against_single_and_plain(pms, counter):
    """One batched launch == the plain batch and each candidate's
    single-tree launch, bit for bit (likelihoods and scaler counts);
    ``batch_log_likelihood`` is one more batched launch, each row within
    rtol 1e-6 of that candidate's log_likelihood()."""
    pm0 = pms[0]
    cfg = pm0.config
    progs, lcs, rcs, planes, n_slots = TP.batch_inputs(pms)
    kw = dict(n_slots=n_slots, states=cfg.states, categories=cfg.categories,
              variant=cfg.resolved_kernel_variant, planes=planes)
    args = (pm0.codes, progs, lcs, rcs, pm0.ec, pm0.fused_tip_table,
            pm0.root_rows[0], pm0.n_sites)
    before = counter.launches
    lik, sc = TT.plf_tree_batch(*args, **kw)
    assert counter.launches == before + 1
    lik_p, sc_p = TT.plf_tree_batch_torch(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(lik, lik_p) and torch.equal(sc, sc_p)
    for b, pm in enumerate(pms):
        one, one_sc = plf_tree(
            pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
            pm.root_rows[0], pm.n_sites, n_slots=pm.n_slots,
            root_slot=pm.root_slot, states=cfg.states,
            categories=cfg.categories, variant=cfg.resolved_kernel_variant,
            planes=pm._planes(), program=None if pm._matrix_form
            else pm.tree_program)
        assert torch.equal(lik[b], one[0]) and torch.equal(sc[b], one_sc[0])
    assert int(sc.sum()) > 0
    lls = TP.batch_log_likelihood(pms)
    assert counter.launches == before + 2
    np.testing.assert_allclose(
        lls, [pm.log_likelihood().log_likelihood for pm in pms], rtol=1e-6)


@pytest.mark.parametrize("tip_dtype", ["int32", "int8"])
@pytest.mark.parametrize("categories,p_inv", [(4, None), (4, 0.2),
                                              (1, None)])
def test_kernel2_batch_equals_single_and_plain(cuda, tip_dtype, categories,
                                               p_inv):
    """Kernel 2 with a candidate axis: an NNI neighbourhood plus the
    incumbent (45 candidates at 24 taxa) in one launch, each row == the
    single-tree kernel on that candidate and == the plain version, with
    int8 tips, +I (C = 5) and C = 1."""
    pms = _nni_batch(cuda, "vpu", tip_dtype=tip_dtype,
                     categories=categories, p_inv=p_inv)
    assert len(pms) == 45 and TP.batch_fits(pms)
    _batch_against_single_and_plain(pms, TT.plf_tree_batch)


#: (states, model size) x variant of the kernel-2m batch test: every
#: variant at S = 20 (+I too) and 61; the matrix forms at S = 4 ("vpu"
#: there is kernel 2's, tested above).
BATCH_2M_CASES = [
    (states, extra, variant)
    for states, extra in ((20, {}), (20, {"p_inv": 0.2}),
                          (61, {"n_leaves": 8, "n_sites": 300}),
                          (4, {"n_leaves": 32}))
    for variant in MXU_VARIANTS + ["vpu"]
    if (states, variant) != (4, "vpu")]


@pytest.mark.parametrize("states,extra,variant", BATCH_2M_CASES)
def test_kernel2m_batch_equals_single_and_plain(cuda, states, extra,
                                                variant):
    """Kernel 2m with a candidate axis, every variant, at S = 20 (+I too),
    61 and 4 (DNA in the matrix forms): one launch == single-tree 2m on
    each candidate == the plain version."""
    kw = {"n_leaves": 12, "n_sites": 700}
    kw.update(extra)
    pms = _nni_batch(cuda, variant, states=states, **kw)
    _batch_against_single_and_plain(pms, TT.plf_tree_mxu_batch)


def test_batch_plan_and_rejections(cuda):
    """tree_plan and tree_mxu_plan report the batched grid (site blocks,
    candidates); the wrappers refuse a program of the wrong shape or
    dtype."""
    pms = _nni_batch(cuda, "vpu")
    pm0 = pms[0]
    progs, lcs, rcs, _, n_slots = TP.batch_inputs(pms)
    n_codes = pm0.tip_table.shape[1]
    plan = TT.tree_plan(pm0.codes.dtype, 4, n_codes, n_slots, pm0.n_pad,
                        len(pms))
    assert plan["grid"] == (-(-pm0.n_pad // TT.TREE_THREADS), len(pms))
    assert plan["blocks_per_sm"] >= 1
    assert TT.tree_plan(pm0.codes.dtype, 4, n_codes, n_slots)["grid"] == \
        (1, 1)
    mplan = TT.tree_mxu_plan(torch.int32, 20, 4, 24, 6, "mxu_3x", 1024, 7)
    assert mplan["grid"] == (1024 // TT.TREE_MXU_SITES, 7)
    assert (mplan["threads"], mplan["rows"]) == TREE_MXU_BLOCKS[(20, 4)]
    args = (pm0.codes, progs, lcs, rcs, pm0.ec, pm0.fused_tip_table,
            pm0.root_rows[0], pm0.n_sites)
    with pytest.raises(ValueError, match="progs"):
        TT.plf_tree_batch(*args[:1], progs[0], *args[2:], n_slots=n_slots)
    with pytest.raises(ValueError, match="progs"):
        TT.plf_tree_batch(*args[:1], progs.to(torch.int64), *args[2:],
                          n_slots=n_slots)
    with pytest.raises(ValueError, match="does not fit"):
        TT.plf_tree_batch(*args, n_slots=40)


@pytest.mark.parametrize("states,argv", [
    (4, ["--model", "hky", "--alpha", "0.5", "--search", "mixed",
         "--bootstrap", "3"]),
    (20, ["--model", "lg", "--search", "spr", "--fit", "lengths"])])
def test_infer_cli_on_the_card(cuda, tmp_path, capsys, states, argv):
    """``python -m plf_tpu_torch infer`` on the card (its default device):
    SPR and mixed rounds score each neighbourhood in one batched launch
    (kernel 2 for DNA, 2m for LG proteins), and the newick parses back
    with every taxon."""
    from plf_tpu_torch.__main__ import main
    tree = random_tree(8, seed=3, mean_branch=0.2)
    model = hky85(2.0) if states == 4 else empirical_protein("lg")
    codes = simulate_alignment(tree, model, 400, alpha=0.5, seed=3)
    letters = "ACGT" if states == 4 else "ARNDCQEGHILKMFPSTWYV"
    fa, out = tmp_path / "aln.fa", tmp_path / "tree.nwk"
    fa.write_text("".join(f">t{i}\n" + "".join(letters[c] for c in row)
                          + "\n" for i, row in enumerate(codes)))
    counter = TT.plf_tree_batch if states == 4 else TT.plf_tree_mxu_batch
    before = counter.launches
    assert main(["infer", str(fa), "--out", str(out)] + argv) == 0
    assert counter.launches > before
    assert "final ll = " in capsys.readouterr().out
    assert sorted(parse_newick(out.read_text()).leaf_names()) == \
        sorted(tree.leaf_names())


# --------------------------------------------- kernel 4m (matrix forms) --

def _bsched(pm):
    sched = reorder_schedule(pm.schedule, pm.tree.n_leaves)
    return torch.as_tensor(TG.backward_schedule(sched, pm.tree.n_leaves),
                           device=pm.device)


def test_kernel7m_block_is_kernel2m_block(cuda):
    """Kernel 7m's library reports kernel 2m's job shape (one rule in
    csrc/plf_mxu.cuh) for both boundary storages at every pinned (S, C),
    and its blocks fit an SM at the test models' arenas."""
    for (S, C), want in TREE_MXU_BLOCKS.items():
        for dtype in (torch.float32, BF16):
            assert SG.tree_seg_mxu_block(S, C, dtype) == want, (S, C, dtype)
    for dtype in (torch.float32, BF16):
        for code_dtype in (torch.int32, torch.int8):
            assert SG.plf_tree_seg_mxu_occupancy(
                code_dtype, 20, 4, 24, 8, "mxu_3x", dtype) >= 1
    assert SG.plf_tree_seg_mxu_occupancy(torch.int32, 61, 4, 64, 4, "mxu",
                                         torch.float32) >= 1


@pytest.mark.parametrize("variant", MXU_VARIANTS + ["vpu"])
@pytest.mark.parametrize("states,extra", [(20, {}), (20, {"p_inv": 0.2}),
                                          (20, {"tip_dtype": "int8"}),
                                          (61, {}), (61, {"p_inv": 0.2}),
                                          (20, {"n_sites": 33}),
                                          (61, {"n_sites": 17})])
def test_kernel4m_matches_plain(cuda, variant, states, extra):
    """Kernel 4m against its plain version in every mode, at S = 20 (C = 4,
    C = 5 with +I, int8 tips: 32-site tiles, accumulators in shared memory)
    and S = 61 (C = 4 and 5: 8-site tiles, in device memory), and on one site past a whole tile (33 sites at S = 20,
    17 at S = 61, past two 8-site tiles); one
    chunk and three under a budget of two tiles' checkpoint; planes split
    by the wrapper or by the model, bit-identical run to run; site sums
    within 1e-4 of each matrix's scale."""
    pm = _protein_model(cuda, variant, states=states, n_leaves=12,
                        **{"n_sites": 700, **extra})
    C = pm.config.categories
    args = (pm.codes, _bsched(pm), pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
            pm.root_rows[0])
    glik = torch.randn((1, pm.n_pad), generator=torch.Generator(device=cuda)
                       .manual_seed(6), device=cuda)
    kw = dict(states=states, categories=C, variant=variant)
    before = TG.plf_tree_bwd_mxu.launches
    k1 = TG.plf_tree_bwd_mxu(*args, glik, pm.n_sites, **kw)
    last = TG.plf_tree_bwd_mxu.last_scratch
    assert last["chunks"] == 1 and last["acc_shared"] == (states == 20)
    assert last["tile_sites"] == (32 if states == 20 else 8)
    k2 = TG.plf_tree_bwd_mxu(*args, glik, pm.n_sites, planes=pm._planes(),
                             **kw)
    per_tile = TG.tree_bwd_scratch_bytes(len(pm.schedule), pm.config.rows,
                                         128)
    k3 = TG.plf_tree_bwd_mxu(*args, glik, pm.n_sites,
                             max_scratch_bytes=2 * per_tile, **kw)
    assert TG.plf_tree_bwd_mxu.last_scratch["chunks"] == -(-pm.n_pad // 256)
    assert TG.plf_tree_bwd_mxu.launches == before + 3
    p = TG.plf_tree_bwd_mxu_torch(*args, glik, pm.n_sites, **kw)
    torch.cuda.synchronize()
    for i in range(4):
        assert torch.equal(k1[i], k2[i])       # run to run, bit for bit
    for k in (k1, k3):
        for i in range(3):
            _sums_close(k[i], p[i])
        _sums_close(k[3].reshape(1, -1, 1), p[3].reshape(1, -1, 1))


def _counted():
    return (plf_node, plf_tree, G.plf_node_bwd, TG.plf_tree_bwd,
            plf_node_mxu, plf_tree_mxu, TG.plf_tree_bwd_mxu)


def _card_lane_constants(cuda):
    """The training function's lane constants computed on the card and
    copied to the CPU (autograd flows through both copies): a CPU model's
    step then runs on the card's exp, bit for bit."""
    on_host = TO._lane_constants

    def lane_constants(t, r_vec, lam, u, S, C):
        return on_host(*(x.to(cuda) for x in (t, r_vec, lam, u)), S,
                       C).cpu()
    return lane_constants


@pytest.mark.parametrize("states,variant", [(20, None), (20, "mxu"),
                                            (61, "mxu"), (61, "mxu_3x")])
def test_matrix_form_training_step(cuda, monkeypatch, states, variant):
    """A protein (LG) or codon (GY94, simulated codons) model on the card:
    auto takes "tree", and one value-and-gradient step launches kernel 2m
    once, kernel 4m once and nothing else.  The value matches
    log_likelihood() within rel 1e-5; the gradient matches the CPU twin's
    and, in "mxu", the "torch" backend's on the card, both within rtol
    2e-4 and 1e-4 of the largest entry.  The twin runs the plain versions
    (the same per-site arithmetic, the site sums in another order) on the
    lane constants the card computes: each device's exp may differ in the
    last bit, and the bf16 hi/lo split of an operand is a step function of
    it."""
    tree = random_tree(16, seed=8, mean_branch=0.2)
    if states == 20:
        model = empirical_protein("lg")
        tips = np.random.default_rng(8).integers(-1, 23, size=(16, 1500))
    else:
        model = codon_gy94(2.0, 0.3)
        tips = simulate_alignment(tree, model, 1500, alpha=0.6, seed=8)
    cfg = (None if variant is None
           else PLFConfig(states=states, kernel_variant=variant))
    pm = PhyloModel(tree, model, tips, alpha=0.6, config=cfg)
    twin = PhyloModel(tree, model, tips, alpha=0.6, config=cfg, device="cpu")
    assert pm.device.type == "cuda"
    resolved = pm.config.resolved_kernel_variant
    assert resolved == variant or (variant is None and resolved == "mxu_3x")
    out = {}
    for name, m, backend in (("card", pm, "auto"), ("cpu", twin, "tree"),
                             ("torch", pm, "torch")):
        if name == "torch" and resolved != "mxu":
            continue
        fn, t0 = tree_loglik_fn(m, backend=backend)
        counts = [f.launches for f in _counted()]
        t = torch.tensor(t0, device=m.device, requires_grad=True)
        with monkeypatch.context() as mp:
            if name == "cpu":
                mp.setattr(TO, "_lane_constants", _card_lane_constants(cuda))
            v = fn(t)
        v.backward()
        runs = [f.launches - c for f, c in zip(_counted(), counts)]
        if name == "card":
            assert (fn.engine, fn.variant) == ("tree", resolved)
            assert runs == [0, 0, 0, 0, 0, 1, 1], runs
        out[name] = (float(v.detach()), t.grad.cpu().numpy())
    ll = pm.log_likelihood().log_likelihood
    assert out["card"][0] == pytest.approx(ll, rel=1e-5)
    g = out["card"][1]
    for name in out.keys() - {"card"}:
        g_o = out[name][1]
        np.testing.assert_allclose(g, g_o, rtol=2e-4,
                                   atol=1e-4 * np.abs(g_o).max(),
                                   err_msg=name)


# ------------------------------------------------- kernels 7 and 8 (segmented)


def _seg_case(device, cap=None, n_leaves=60, n_sites=3000, **kw):
    """A DNA model, its segment plan (``cap`` ops at most, the capacity
    rule's cap when None) and both programs on the card."""
    pm = _model(device, n_leaves=n_leaves, n_sites=n_sites, **kw)
    sched = reorder_schedule(pm.schedule, pm.tree.n_leaves)
    pos = [(p, l, r, 0.0, 0.0, i) for i, (p, l, r, *_x) in enumerate(sched)]
    plan = SG.plan_segments(pos, n_leaves, rows=pm.config.rows, cap_ops=cap,
                            n_codes=pm.tip_table.shape[1])
    progs = []
    for reuse in (True, False):
        prog, segs, n_slots = SG.segment_program(plan, sched,
                                                 reuse_slots=reuse)
        progs.append((torch.as_tensor(prog, device=device),
                      torch.as_tensor(segs, device=device), n_slots))
    return pm, plan, progs


def _seg_fwd(pm, plan, fwd, fn=SG.plf_tree_seg, codes=None, n=None):
    prog, segs, n_slots = fwd
    return fn(pm.codes if codes is None else codes, prog, segs, pm.lcs,
              pm.rcs, pm.ec, pm.tip_table, pm.root_rows[0],
              pm.n_sites if n is None else n, n_boundaries=plan.n_boundaries,
              n_slots=n_slots, categories=pm.config.categories)


def _seg_carried(fwd):
    """Kernel 7's carried program of ``fwd`` (segment_program's, on the
    card), in ``fwd``'s form ``(prog, segs, n_slots)``."""
    prog, segs, _ = fwd
    cprog, slots = SG.carry_segment_program(prog.cpu().numpy(),
                                            segs.cpu().numpy())
    return torch.as_tensor(cprog, device=prog.device), segs, slots


def _hazards(fwd):
    """Ops of a program that read the boundary the op right before them
    exports (kernel 7 reads those rows late)."""
    prog, segs = (t.cpu().numpy() for t in fwd[:2])
    return sum(any(prog[2 * s + 1, end] == 2 and prog[2 * s, end] == gout
                   for s in range(2)) for end, gout in segs[:-1])


def _with_program(cfwd):
    """plf_tree_seg given the carried program ``cfwd`` explicitly."""
    return lambda *a, **k: SG.plf_tree_seg(*a, program=(cfwd[0], cfwd[2]),
                                           **k)


@pytest.mark.parametrize("tip_dtype,cap,extra,shape", [
    ("int32", None, {}, None), ("int8", None, {}, None),
    ("int32", 4, {}, None), ("int32", None, {"p_inv": 0.2}, None),
    ("int8", None, {}, "ragged"), ("int32", 16, {}, "one segment")])
def test_kernel7_equals_kernel2_and_plain(cuda, tip_dtype, cap, extra, shape):
    """Kernel 7 on the carried program: lik and sc equal kernel 2's bit for
    bit, and lik, sc and every boundary CLV equal the plain version's, on
    the carried program and on segment_program's; the wrapper derives the
    same carried program when given none.  The default 60-taxon plan has
    an op that reads the boundary the op before it exports; "ragged" cuts
    the codes to an odd n_pad, not a multiple of the 128-site block;
    "one segment" is an 8-taxon tree in one segment (no boundary)."""
    n_leaves = 8 if shape == "one segment" else 60
    pm, plan, (fwd, _) = _seg_case(
        cuda, cap, n_leaves=n_leaves,
        config=PLFConfig(tip_dtype=tip_dtype, block_sites=128), **extra)
    codes, n = pm.codes, pm.n_sites
    if shape == "ragged":
        codes, n = pm.codes[:, :2899].contiguous(), 2890
        assert codes.shape[1] % 128 and n < pm.n_sites
    if shape == "one segment":
        assert len(plan.segments) == 1 and plan.n_boundaries == 0
    else:
        assert len(plan.segments) > 1
    if cap is None and shape is None:
        assert _hazards(fwd) > 0
    cfwd = _seg_carried(fwd)
    assert cfwd[2] <= fwd[2]
    before = SG.plf_tree_seg.launches
    lik, sc, bbuf = _seg_fwd(pm, plan, cfwd, _with_program(cfwd), codes, n)
    assert SG.plf_tree_seg.launches == before + 1
    derived = _seg_fwd(pm, plan, fwd, codes=codes, n=n)
    ref = plf_tree(codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
                   pm.root_rows[0], n, n_slots=pm.n_slots,
                   root_slot=pm.root_slot, categories=pm.config.categories)
    plain = _seg_fwd(pm, plan, cfwd, SG.plf_tree_seg_torch, codes, n)
    uncarried = _seg_fwd(pm, plan, fwd, SG.plf_tree_seg_torch, codes, n)
    torch.cuda.synchronize()
    assert torch.equal(lik, ref[0]) and torch.equal(sc, ref[1])
    for a, b, c, d in zip((lik, sc, bbuf), plain, uncarried, derived):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)


def test_kernel7_capacity_rule(cuda):
    """Kernel 7 takes kernel 2's rule (tree_fused_threads) on the carried
    program's slots and its two landing slots: 26 arena slots of 16 rows
    fit beside the operator buffers and launch, 27 do not and raise before
    any launch; its plan gives 128 threads, the slots, the shared memory
    of that rule, and the blocks per SM and registers of the library."""
    pm, plan, (fwd, _) = _seg_case(cuda, n_sites=300)
    cprog, segs, slots = _seg_carried(fwd)
    n_codes = pm.tip_table.shape[1]
    assert SG.SEG_LANDING_SLOTS == 2
    assert TT.tree_fused_threads(28, 16, n_codes) == 128
    assert TT.tree_fused_threads(29, 16, n_codes) is None
    args = (pm.codes, fwd[0], segs, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
            pm.root_rows[0], pm.n_sites)
    kw = dict(n_boundaries=plan.n_boundaries, n_slots=fwd[2])
    want = SG.plf_tree_seg(*args, **kw)
    got = SG.plf_tree_seg(*args, **kw, program=(cprog, 26))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    before = SG.plf_tree_seg.launches
    with pytest.raises(ValueError, match="does not fit"):
        SG.plf_tree_seg(*args, **kw, program=(cprog, 27))
    assert SG.plf_tree_seg.launches == before
    for dt in (torch.float32, BF16):
        p = SG.plf_tree_seg_plan(pm.codes.dtype, 4, n_codes, slots, dt)
        assert p["threads"] == 128 and p["slots"] == slots
        assert p["smem_bytes"] == TT.tree_fused_smem_bytes(
            slots + SG.SEG_LANDING_SLOTS, 16, n_codes)
        assert p["blocks_per_sm"] >= 1 and 0 < p["registers"] <= 255


@pytest.mark.parametrize("tip_dtype,cap,extra", [
    ("int32", None, {}), ("int8", 6, {}), ("int32", None, {"p_inv": 0.2})])
def test_kernel8_matches_plain(cuda, tip_dtype, cap, extra):
    """The boundary adjoints equal the plain version's bit for bit, the
    site sums agree within 1e-6 of each matrix's scale (another summation
    order, the blocks' rows added in fp64), and two runs are
    bit-identical."""
    pm, plan, (fwd, (prog, segs, _)) = _seg_case(
        cuda, cap, config=PLFConfig(tip_dtype=tip_dtype, block_sites=128),
        **extra)
    C = pm.config.categories
    _, _, bbuf = _seg_fwd(pm, plan, fwd)
    glik = torch.randn((1, pm.n_pad), generator=torch.Generator(device=cuda)
                       .manual_seed(5), device=cuda)
    args = (pm.codes, prog, segs, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
            pm.root_rows[0], glik, bbuf, pm.n_sites)
    before = SG.plf_tree_seg_bwd.launches
    gbufs = [torch.full_like(bbuf, float("nan")) for _ in range(3)]
    k1 = SG.plf_tree_seg_bwd(*args, seg_ops=plan.seg_ops, categories=C,
                             gbuf=gbufs[0])
    k2 = SG.plf_tree_seg_bwd(*args, seg_ops=plan.seg_ops, categories=C,
                             gbuf=gbufs[1])
    assert SG.plf_tree_seg_bwd.launches == before + 2
    p = SG.plf_tree_seg_bwd_torch(*args, categories=C, gbuf=gbufs[2])
    torch.cuda.synchronize()
    assert torch.equal(gbufs[0], gbufs[2]) and torch.equal(gbufs[0],
                                                           gbufs[1])
    for i in range(4):
        assert torch.equal(k1[i], k2[i])       # run to run, bit for bit
    for i in range(3):
        _sums_close(k1[i], p[i], rtol=1e-6)
    _sums_close(k1[3].reshape(1, -1, 1), p[3].reshape(1, -1, 1), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel8_several_tiles_per_block(cuda, dtype):
    """Kernel 8 with several tiles per block (more tiles than a wave of
    blocks holds, so a segment's sums gather over the block's tiles in
    shared memory before its row is written) and several segments, fp32
    and bf16 boundaries, with rescaled sites and a real step's cotangent:
    boundary adjoints equal the plain version's bit for bit, the site sums
    within 1e-6 of scale, two runs bit-identical."""
    dt = getattr(torch, dtype)
    pm, plan, (fwd, (prog, segs, _)) = _seg_case(cuda, None,
                                                 n_sites=110_000)
    tiles = pm.n_pad // SG.SEG_SITES
    resident = SG._resident_blocks(cuda, 4, 4, pm.tip_table.shape[1],
                                   plan.seg_ops, dt == BF16)
    assert tiles > 2 * resident and len(plan.segments) > 4
    lik, sc, bbuf = _seg_fwd(pm, plan, fwd, _seg_bf16(SG.plf_tree_seg,
                                                      dtype=dt))
    assert int(sc.sum()) > 0 and bbuf.dtype == dt
    glik = (pm.wgt_pad.to(torch.float32) / lik).contiguous()
    args = (pm.codes, prog, segs, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
            pm.root_rows[0], glik, bbuf, pm.n_sites)
    gbufs = [torch.full_like(bbuf, float("nan")) for _ in range(3)]
    k1 = SG.plf_tree_seg_bwd(*args, seg_ops=plan.seg_ops, gbuf=gbufs[0])
    k2 = SG.plf_tree_seg_bwd(*args, seg_ops=plan.seg_ops, gbuf=gbufs[1])
    p = SG.plf_tree_seg_bwd_torch(*args, gbuf=gbufs[2])
    torch.cuda.synchronize()
    assert torch.equal(gbufs[0], gbufs[2]) and torch.equal(gbufs[0],
                                                           gbufs[1])
    for i in range(4):
        assert torch.equal(k1[i], k2[i])
    for i in range(3):
        _sums_close(k1[i], p[i], rtol=1e-6)
    _sums_close(k1[3].reshape(1, -1, 1), p[3].reshape(1, -1, 1), rtol=1e-6)


def test_segmented_paths_on_the_card(cuda):
    """log_likelihood(method="segmented") launches kernel 7 once and
    equals the fused path site for site; a "segmented" value-and-gradient
    step launches kernels 7 and 8 once each and nothing else, and agrees
    with the "tree" step (value rel 1e-6, gradient rtol 2e-4 / atol 1e-4
    of the largest)."""
    pm = _model(cuda, n_leaves=60, n_sites=5000)
    k7 = SG.plf_tree_seg.launches
    seg = pm.log_likelihood(method="segmented")
    assert SG.plf_tree_seg.launches == k7 + 1
    fused = pm.log_likelihood(method="fused")
    np.testing.assert_array_equal(seg.site_log_likelihood,
                                  fused.site_log_likelihood)
    assert seg.scaler_total == fused.scaler_total
    out = {}
    wrappers = (SG.plf_tree_seg, SG.plf_tree_seg_bwd, plf_tree,
                TG.plf_tree_bwd, plf_node, G.plf_node_bwd)
    for backend in ("segmented", "tree"):
        fn, t0 = tree_loglik_fn(pm, backend=backend)
        counts = [f.launches for f in wrappers]
        t = torch.tensor(t0, device=cuda, requires_grad=True)
        v = fn(t)
        v.backward()
        runs = [f.launches - c for f, c in zip(wrappers, counts)]
        assert runs == ([1, 1, 0, 0, 0, 0] if backend == "segmented"
                        else [0, 0, 1, 1, 0, 0]), runs
        assert (fn.engine, fn.variant) == (backend, "vpu")
        out[backend] = (float(v.detach()), t.grad.cpu().numpy())
    assert out["segmented"][0] == pytest.approx(out["tree"][0], rel=1e-6)
    g = out["tree"][1]
    np.testing.assert_allclose(out["segmented"][1], g, rtol=2e-4,
                               atol=1e-4 * np.abs(g).max())


def test_segmented_wrappers_reject_what_they_cannot_run(cuda):
    pm, plan, (fwd, (prog, segs, _)) = _seg_case(cuda, n_sites=300)
    lik, sc, bbuf = _seg_fwd(pm, plan, fwd)
    g = torch.zeros((1, pm.n_pad), device=cuda)
    args = (pm.codes, prog, segs, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
            pm.root_rows[0])
    with pytest.raises(ValueError, match="does not fit"):
        SG.plf_tree_seg_bwd(*args, g, bbuf, pm.n_sites, seg_ops=64)
    with pytest.raises(ValueError, match="glik"):
        SG.plf_tree_seg_bwd(*args, g.cpu(), bbuf, pm.n_sites,
                            seg_ops=plan.seg_ops)
    with pytest.raises(ValueError, match="does not fit"):
        SG.plf_tree_seg(pm.codes, *fwd[:2], pm.lcs, pm.rcs, pm.ec,
                        pm.tip_table, pm.root_rows[0], pm.n_sites,
                        n_boundaries=plan.n_boundaries, n_slots=fwd[2],
                        program=(_seg_carried(fwd)[0], 40))
    with pytest.raises(ValueError, match="program must be"):
        SG.plf_tree_seg(pm.codes, *fwd[:2], pm.lcs, pm.rcs, pm.ec,
                        pm.tip_table, pm.root_rows[0], pm.n_sites,
                        n_boundaries=plan.n_boundaries, n_slots=fwd[2],
                        program=(_seg_carried(fwd)[0].cpu(), 2))


# ----------------------------------------------- kernels 7m and 8m (segmented)


def _seg_mxu_case(device, variant, states=20, cap=4, n_leaves=12,
                  n_sites=700, **extra):
    """A protein or S = 61 model, its matrix-form segment plan (``cap`` ops
    at most) and both programs on the card."""
    pm = _protein_model(device, variant, states=states, n_leaves=n_leaves,
                        n_sites=n_sites, **extra)
    sched = reorder_schedule(pm.schedule, n_leaves)
    pos = [(p, l, r, 0.0, 0.0, i) for i, (p, l, r, *_x) in enumerate(sched)]
    plan = SG.plan_segments(pos, n_leaves, rows=pm.config.rows, cap_ops=cap,
                            n_codes=pm.tip_table.shape[1], matrix_form=True)
    assert len(plan.segments) > 1
    progs = []
    for reuse in (True, False):
        prog, segs, n_slots = SG.segment_program(plan, sched,
                                                 reuse_slots=reuse)
        progs.append((torch.as_tensor(prog, device=device),
                      torch.as_tensor(segs, device=device), n_slots))
    return pm, plan, progs


def _seg_mxu_args(pm, prog, segs, ttab=None, codes=None):
    return (pm.codes if codes is None else codes, prog, segs, pm.lcs, pm.rcs,
            pm.ec, pm.fused_tip_table if ttab is None else ttab,
            pm.root_rows[0])


def _forced_underflow(pm):
    """The reference generator's forced-underflow pattern on the tips
    (tests/conftest.py:122-136 scales x1 of every 4th site by 1e-12): the
    tip table gains S columns, 1e-12 times the state columns, and the
    first leaf's code at every 4th site moves to them."""
    S = pm.config.states
    ttab = pm.fused_tip_table
    ttab = torch.cat([ttab, ttab[:, :S] * 1e-12], dim=1).contiguous()
    codes = pm.codes.clone()
    codes[0, 0::4] = (ttab.shape[1] - S
                      + (codes[0, 0::4].long() % S)).to(codes.dtype)
    return ttab, codes


@pytest.mark.parametrize("variant", MXU_VARIANTS + ["vpu"])
@pytest.mark.parametrize("states,extra", [(20, {}), (20, {"p_inv": 0.2}),
                                          (20, {"tip_dtype": "int8"}),
                                          (61, {}), (20, {"underflow": 1}),
                                          (4, {"n_leaves": 32}),
                                          (4, {"n_leaves": 32,
                                               "tip_dtype": "int8"})])
def test_kernel7m_equals_kernel2m_and_plain(cuda, variant, states, extra):
    """Kernel 7m's lik and sc equal kernel 2m's bit for bit, and its lik,
    sc and every boundary CLV equal its plain version's, in every mode, at
    S = 20 (C = 4, C = 5 with +I, int8 tips, and the forced-underflow tips),
    S = 61 and S = 4 (DNA in the matrix forms, blocks of 32 threads; "vpu"
    there is kernel 7's, so 7m and 2m are called directly); its operators
    split by the wrapper or by the model."""
    underflow = extra.pop("underflow", 0)
    pm, plan, (fwd, _) = _seg_mxu_case(cuda, variant, states=states, **extra)
    prog, segs, n_slots = fwd
    ttab, codes = _forced_underflow(pm) if underflow else (None, None)
    args = _seg_mxu_args(pm, prog, segs, ttab, codes)
    S, C = states, pm.config.categories
    mxu = uses_mxu_kernels(variant, S)
    run = SG.plf_tree_seg if mxu else SG.plf_tree_seg_mxu
    kw = dict(n_boundaries=plan.n_boundaries, n_slots=n_slots, states=S,
              categories=C, variant=variant)
    before = SG.plf_tree_seg_mxu.launches
    lik, sc, bbuf = run(*args, pm.n_sites, **kw)
    lik_m, sc_m, bbuf_m = run(*args, pm.n_sites, planes=pm._planes(), **kw)
    assert SG.plf_tree_seg_mxu.launches == before + 2
    ref = (plf_tree if mxu else plf_tree_mxu)(
        args[0], pm.sched, *args[3:], pm.n_sites, n_slots=pm.n_slots,
        root_slot=pm.root_slot, states=S, categories=C, variant=variant)
    plain = SG.plf_tree_seg_torch(*args, pm.n_sites, **kw)
    torch.cuda.synchronize()
    assert torch.equal(lik, ref[0]) and torch.equal(sc, ref[1])
    for a, b, m in zip((lik, sc, bbuf), plain, (lik_m, sc_m, bbuf_m)):
        assert torch.equal(a, b) and torch.equal(a, m)
    assert int(sc.sum()) > 0
    if underflow:
        assert int(sc[0, 0::4].sum()) > int(sc[0, 1::4].sum())


@pytest.mark.parametrize("variant", MXU_VARIANTS + ["vpu"])
@pytest.mark.parametrize("states,extra", [(20, {}), (20, {"p_inv": 0.2}),
                                          (20, {"tip_dtype": "int8"}),
                                          (61, {}), (61, {"p_inv": 0.2}),
                                          (20, {"underflow": 1}),
                                          (20, {"n_sites": 33}),
                                          (61, {"n_sites": 17})])
def test_kernel8m_matches_plain(cuda, variant, states, extra):
    """Kernel 8m against its plain version in every mode, at S = 20
    (32-site tiles, accumulators in shared memory) and S = 61 (8-site
    tiles, in device memory), with the forced-underflow
    tips too, and on one site past a whole tile (33 sites at S = 20, 17 at
    S = 61): the boundary adjoints equal the plain
    version's bit for bit; the site sums within 3e-6 of each matrix's
    scale (another summation order, the blocks' rows added in fp64), in
    one chunk and in chunks of two tiles' checkpoint; planes split by the
    wrapper or by the model; two runs bit-identical."""
    underflow = extra.pop("underflow", 0)
    pm, plan, (fwd, (prog, segs, _)) = _seg_mxu_case(cuda, variant,
                                                     states=states, **extra)
    S, C = states, pm.config.categories
    ttab, codes = _forced_underflow(pm) if underflow else (None, None)
    _, sc, bbuf = SG.plf_tree_seg(*_seg_mxu_args(pm, *fwd[:2], ttab, codes),
                                  pm.n_sites, n_boundaries=plan.n_boundaries,
                                  n_slots=fwd[2], states=S, categories=C,
                                  variant=variant)
    if underflow:
        assert int(sc[0, 0::4].sum()) > int(sc[0, 1::4].sum())
    glik = torch.randn((1, pm.n_pad), generator=torch.Generator(device=cuda)
                       .manual_seed(7), device=cuda)
    args = _seg_mxu_args(pm, prog, segs, ttab, codes) + (glik, bbuf,
                                                         pm.n_sites)
    kw = dict(states=S, categories=C, variant=variant)
    gbufs = [torch.full_like(bbuf, float("nan")) for _ in range(4)]
    before = SG.plf_tree_seg_bwd_mxu.launches
    k1 = SG.plf_tree_seg_bwd(*args, seg_ops=plan.seg_ops, gbuf=gbufs[0], **kw)
    last = SG.plf_tree_seg_bwd_mxu.last_scratch
    assert last["chunks"] == 1 and last["acc_shared"] == (states == 20)
    assert last["tile_sites"] == (32 if states == 20 else 8)
    k2 = SG.plf_tree_seg_bwd(*args, seg_ops=plan.seg_ops, gbuf=gbufs[1],
                             planes=pm._planes(), **kw)
    per_tile = TG.tree_bwd_scratch_bytes(plan.seg_ops, pm.config.rows, 128)
    k3 = SG.plf_tree_seg_bwd(*args, seg_ops=plan.seg_ops, gbuf=gbufs[2],
                             max_scratch_bytes=2 * per_tile, **kw)
    assert SG.plf_tree_seg_bwd_mxu.last_scratch["chunks"] == \
        -(-pm.n_pad // 256)
    assert SG.plf_tree_seg_bwd_mxu.launches == before + 3
    p = SG.plf_tree_seg_bwd_torch(*args, gbuf=gbufs[3], **kw)
    torch.cuda.synchronize()
    for g in gbufs[:3]:
        assert torch.equal(g, gbufs[3])
    for i in range(4):
        assert torch.equal(k1[i], k2[i])       # run to run, bit for bit
    for k in (k1, k3):
        for i in range(3):
            _sums_close(k[i], p[i], rtol=3e-6)
        _sums_close(k[3].reshape(1, -1, 1), p[3].reshape(1, -1, 1),
                    rtol=3e-6)


@pytest.mark.parametrize("states,variant", [(20, None), (20, "mxu"),
                                            (61, "mxu_3x")])
def test_segmented_matrix_form_paths_on_the_card(cuda, states, variant):
    """A protein or codon model on the card: log_likelihood(method=
    "segmented") launches kernel 7m once and equals the fused path site
    for site; a "segmented" value-and-gradient step launches kernels 7m
    and 8m once each and nothing else, its value equals the "tree"
    step's (kernel 7m == kernel 2m) and its gradient is within 1e-5 of
    the largest entry of the "tree" gradient."""
    tree = random_tree(40, seed=8, mean_branch=0.2)
    if states == 20:
        model = empirical_protein("lg")
        tips = np.random.default_rng(8).integers(-1, 23, size=(40, 1500))
    else:
        model = codon_gy94(2.0, 0.3)
        tips = simulate_alignment(tree, model, 1000, alpha=0.6, seed=8)
    cfg = (None if variant is None
           else PLFConfig(states=states, kernel_variant=variant))
    pm = PhyloModel(tree, model, tips, alpha=0.6, config=cfg)
    assert pm.can_segment()
    assert len(pm._segmented_inputs()[0].segments) > 1
    k7 = SG.plf_tree_seg_mxu.launches
    seg = pm.log_likelihood(method="segmented")
    assert SG.plf_tree_seg_mxu.launches == k7 + 1
    fused = pm.log_likelihood(method="fused")
    np.testing.assert_array_equal(seg.site_log_likelihood,
                                  fused.site_log_likelihood)
    assert seg.scaler_total == fused.scaler_total
    wrappers = _counted() + (SG.plf_tree_seg, SG.plf_tree_seg_bwd,
                             SG.plf_tree_seg_mxu, SG.plf_tree_seg_bwd_mxu)
    out = {}
    for backend in ("segmented", "tree"):
        fn, t0 = tree_loglik_fn(pm, backend=backend)
        counts = [f.launches for f in wrappers]
        t = torch.tensor(t0, device=cuda, requires_grad=True)
        v = fn(t)
        v.backward()
        runs = [f.launches - c for f, c in zip(wrappers, counts)]
        assert runs == ([0] * 9 + [1, 1] if backend == "segmented"
                        else [0] * 5 + [1, 1] + [0] * 4), runs
        assert fn.engine == backend
        out[backend] = (float(v.detach()), t.grad.cpu().numpy())
    assert out["segmented"][0] == out["tree"][0]
    g = out["tree"][1]
    np.testing.assert_allclose(out["segmented"][1], g, rtol=0,
                               atol=1e-5 * np.abs(g).max())


def test_backend_torch_on_the_card(cuda):
    """A Backend.TORCH protein model on the card runs the plain site-major
    path (no kernel launched) and equals the kernel path within 1e-5
    relative."""
    from plf_tpu_torch.config import Backend
    tips = np.random.default_rng(9).integers(-1, 23, size=(12, 800))
    kw = dict(alpha=0.5)
    pm = PhyloModel(random_tree(12, seed=9), empirical_protein("lg"), tips,
                    config=PLFConfig(states=20, kernel_variant="mxu",
                                     backend=Backend.TORCH), **kw)
    ref = PhyloModel(random_tree(12, seed=9), empirical_protein("lg"), tips,
                     config=PLFConfig(states=20, kernel_variant="mxu"), **kw)
    assert not pm.can_fuse() and not pm.can_segment()
    wrappers = _counted() + (SG.plf_tree_seg, SG.plf_tree_seg_bwd,
                             SG.plf_tree_seg_mxu, SG.plf_tree_seg_bwd_mxu)
    counts = [f.launches for f in wrappers]
    out = pm.log_likelihood()
    fn, t0 = tree_loglik_fn(pm)
    assert fn.engine == "torch"
    assert [f.launches for f in wrappers] == counts
    want = ref.log_likelihood()
    assert out.scaler_total == want.scaler_total
    assert out.log_likelihood == pytest.approx(want.log_likelihood, rel=1e-5)


def test_segmented_mxu_wrappers_reject_what_they_cannot_run(cuda):
    pm, plan, (fwd, (prog, segs, _)) = _seg_mxu_case(cuda, "mxu_3x",
                                                     n_sites=300)
    args = _seg_mxu_args(pm, *fwd[:2])
    kw = dict(states=20, categories=4, variant="mxu_3x")
    with pytest.raises(ValueError, match="does not fit"):
        SG.plf_tree_seg(*args, pm.n_sites, n_boundaries=plan.n_boundaries,
                        n_slots=200, **kw)
    _, _, bbuf = SG.plf_tree_seg(*args, pm.n_sites,
                                 n_boundaries=plan.n_boundaries,
                                 n_slots=fwd[2], **kw)
    g = torch.zeros((1, pm.n_pad), device=cuda)
    bargs = _seg_mxu_args(pm, prog, segs)
    with pytest.raises(ValueError, match="glik"):
        SG.plf_tree_seg_bwd(*bargs, g.cpu(), bbuf, pm.n_sites,
                            seg_ops=plan.seg_ops, **kw)
    with pytest.raises(ValueError, match="bbuf"):
        SG.plf_tree_seg_bwd(*bargs, g, bbuf[:, :, :128], pm.n_sites,
                            seg_ops=plan.seg_ops, **kw)


# ----------------------------------------- bf16 CLV storage (dtype="bfloat16")

BF16 = torch.bfloat16


def _bf16_lane(x, S, C, device):
    """A site-major fp32 CLV as padded lane-major bf16 on the card."""
    return torch.as_tensor(L.pad_to_multiple(L.to_lane_major(x, S, C), 128),
                           device=device).to(BF16).contiguous()


@pytest.mark.parametrize("S,C,variant", [(4, 4, "vpu"), (4, 5, "vpu"),
                                         (20, 4, "mxu"), (20, 4, "mxu_3x"),
                                         (20, 4, "mxu_bf16"),
                                         (61, 4, "mxu_3x")])
def test_kernel1_bf16_storage_equals_plain(cuda, S, C, variant):
    """Kernels 1 ("vpu" at S = 4) and 1m on bf16 CLVs with the
    forced-underflow pattern: x3 (bf16) and the flags equal the plain
    version's bit for bit, out of place and in place; x3 is the bf16
    rounding of the fp32 kernel's x3 on the widened inputs; the launch is
    counted as a bf16 one."""
    n = 600 - 5
    x1, x2, left, right, ev = (_underflow_case(n, C, 19) if S == 4
                               else _underflow_case_s(n, S, C, 19))
    consts = [torch.as_tensor(a, device=cuda) for a in (
        L.branch_to_lane_constants(left, S, C),
        L.branch_to_lane_constants(right, S, C),
        L.ev_to_lane_constants(ev, S, C))]
    a, b = _bf16_lane(x1, S, C, cuda), _bf16_lane(x2, S, C, cuda)
    kw = dict(states=S, categories=C, variant=variant)
    wrapper = plf_node if S == 4 and variant == "vpu" else plf_node_mxu
    plain = plf_node_torch if wrapper is plf_node else plf_node_mxu_torch
    before = (wrapper.launches, wrapper.bf16_launches)
    x3, sc = plf_node(a, b, *consts, n, **kw)
    assert (wrapper.launches, wrapper.bf16_launches) == (before[0] + 1,
                                                         before[1] + 1)
    x3p, scp = plain(a, b, *consts, n, **(
        dict(states=S, categories=C) if plain is plf_node_torch else kw))
    x3f, scf = plf_node(a.float(), b.float(), *consts, n, **kw)
    torch.cuda.synchronize()
    assert x3.dtype == BF16
    assert torch.equal(x3, x3p) and torch.equal(sc, scp)
    assert torch.equal(x3, x3f.to(BF16)) and torch.equal(sc, scf)
    assert int(sc.sum()) > 0 and not sc[0, n:].any()
    for which in (0, 1):
        ops = [a.clone(), b.clone()]
        x3i, sci = plf_node(*ops, *consts, n, out=ops[which], **kw)
        assert x3i.data_ptr() == ops[which].data_ptr()
        assert torch.equal(x3i, x3p) and torch.equal(sci, scp)


def test_bf16_wrappers_reject_mixed_storage(cuda):
    """A wrapper given bf16 and fp32 CLVs together, bf16 constants, or a
    storage type other than fp32 and bf16 raises; it never converts."""
    x = torch.rand(16, 256, device=cuda)
    c = torch.rand(16, 4, device=cuda)
    for wrapper, kw in ((plf_node, {}),
                        (plf_node_mxu, dict(states=4, variant="mxu"))):
        with pytest.raises(TypeError, match="bfloat16"):
            wrapper(x.to(BF16), x, c, c, c, 200, **kw)
        with pytest.raises(TypeError, match="bfloat16"):
            wrapper(x.to(BF16), x.to(BF16), c, c, c, 200, out=x.clone(),
                    **kw)
        with pytest.raises(TypeError, match="bfloat16"):
            wrapper(x.to(BF16), x.to(BF16), c.to(BF16), c, c, 200, **kw)
        with pytest.raises(TypeError, match="bfloat16"):
            wrapper(x.half(), x.half(), c, c, c, 200, **kw)
    pm, plan, (fwd, (prog, segs, _)) = _seg_case(cuda, n_sites=300)
    with pytest.raises(ValueError, match="bfloat16"):
        _seg_fwd(pm, plan, fwd, lambda *a, **k: SG.plf_tree_seg(
            *a, dtype=torch.float16, **k))
    _, _, bbuf = _seg_fwd(pm, plan, fwd, lambda *a, **k: SG.plf_tree_seg(
        *a, dtype=BF16, **k))
    assert bbuf.dtype == BF16
    g = torch.zeros((1, pm.n_pad), device=cuda)
    args = (pm.codes, prog, segs, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
            pm.root_rows[0], g)
    with pytest.raises(ValueError, match="gbuf"):
        SG.plf_tree_seg_bwd(*args, bbuf, pm.n_sites, seg_ops=plan.seg_ops,
                            gbuf=torch.empty(bbuf.shape, device=cuda))
    with pytest.raises(ValueError, match="bfloat16"):
        SG.plf_tree_seg_bwd(*args, bbuf.half(), pm.n_sites,
                            seg_ops=plan.seg_ops)


def _seg_bf16(fn, **over):
    return lambda *a, **k: fn(*a, **{**k, **over})


@pytest.mark.parametrize("tip_dtype,cap", [("int32", None), ("int8", 4)])
def test_kernel7_kernel8_bf16_storage_equal_plain(cuda, tip_dtype, cap):
    """Kernel 7 with bf16 boundaries on the carried program: lik, sc and
    every (bf16) boundary equal the plain version's bit for bit, on the
    carried program and on segment_program's (a boundary read right
    after its export is read back rounded), and lik differs from the fp32
    form's.  Kernel 8 on them: the bf16 boundary adjoints equal the plain
    version's bit for bit, the site sums within 1e-6 of scale, two runs
    bit-identical; both launches counted as bf16 ones."""
    pm, plan, (fwd, (prog, segs, _)) = _seg_case(
        cuda, cap, config=PLFConfig(tip_dtype=tip_dtype, block_sites=128))
    assert plan.n_boundaries > 0
    cfwd = _seg_carried(fwd)
    k7 = SG.plf_tree_seg.bf16_launches
    lik, sc, bbuf = _seg_fwd(pm, plan, cfwd, _seg_bf16(_with_program(cfwd),
                                                       dtype=BF16))
    assert SG.plf_tree_seg.bf16_launches == k7 + 1
    plain = _seg_fwd(pm, plan, cfwd, _seg_bf16(SG.plf_tree_seg_torch,
                                               dtype=BF16))
    uncarried = _seg_fwd(pm, plan, fwd, _seg_bf16(SG.plf_tree_seg_torch,
                                                  dtype=BF16))
    lik32 = _seg_fwd(pm, plan, fwd)[0]
    torch.cuda.synchronize()
    assert bbuf.dtype == BF16
    for a, b, c in zip((lik, sc, bbuf), plain, uncarried):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(lik, lik32)
    C = pm.config.categories
    glik = torch.randn((1, pm.n_pad), generator=torch.Generator(device=cuda)
                       .manual_seed(5), device=cuda)
    args = (pm.codes, prog, segs, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
            pm.root_rows[0], glik, bbuf, pm.n_sites)
    gbufs = [torch.full_like(bbuf, float("nan")) for _ in range(3)]
    k8 = SG.plf_tree_seg_bwd.bf16_launches
    k1 = SG.plf_tree_seg_bwd(*args, seg_ops=plan.seg_ops, categories=C,
                             gbuf=gbufs[0])
    k2 = SG.plf_tree_seg_bwd(*args, seg_ops=plan.seg_ops, categories=C,
                             gbuf=gbufs[1])
    assert SG.plf_tree_seg_bwd.bf16_launches == k8 + 2
    p = SG.plf_tree_seg_bwd_torch(*args, categories=C, gbuf=gbufs[2])
    torch.cuda.synchronize()
    assert torch.equal(gbufs[0], gbufs[2]) and torch.equal(gbufs[0],
                                                           gbufs[1])
    for i in range(4):
        assert torch.equal(k1[i], k2[i])
    for i in range(3):
        _sums_close(k1[i], p[i], rtol=1e-6)
    _sums_close(k1[3].reshape(1, -1, 1), p[3].reshape(1, -1, 1), rtol=1e-6)


@pytest.mark.parametrize("variant", MXU_VARIANTS + ["vpu"])
@pytest.mark.parametrize("states", [20, 61])
def test_kernel7m_kernel8m_bf16_storage_equal_plain(cuda, variant, states):
    """Kernels 7m and 8m with bf16 boundaries and adjoints, in every mode
    at S = 20 and S = 61: lik, sc and every boundary equal the plain
    version's bit for bit; the boundary adjoints equal the plain version's
    bit for bit in one chunk and in chunks of two tiles, the site sums
    within 3e-6 of scale; the launches counted as bf16 ones.  Kernel 8m
    has no bf16 "mxu_bf16" form (no gradient backend trains it): its
    wrapper raises there and launches nothing."""
    pm, plan, (fwd, (prog, segs, _)) = _seg_mxu_case(cuda, variant,
                                                     states=states)
    S, C = states, pm.config.categories
    kw = dict(states=S, categories=C, variant=variant)
    fargs = _seg_mxu_args(pm, *fwd[:2]) + (pm.n_sites,)
    fkw = dict(n_boundaries=plan.n_boundaries, n_slots=fwd[2], dtype=BF16,
               **kw)
    k7 = SG.plf_tree_seg_mxu.bf16_launches
    lik, sc, bbuf = SG.plf_tree_seg(*fargs, **fkw)
    assert SG.plf_tree_seg_mxu.bf16_launches == k7 + 1
    plain = SG.plf_tree_seg_torch(*fargs, **fkw)
    torch.cuda.synchronize()
    for a, b in zip((lik, sc, bbuf), plain):
        assert torch.equal(a, b)
    glik = torch.randn((1, pm.n_pad), generator=torch.Generator(device=cuda)
                       .manual_seed(7), device=cuda)
    args = _seg_mxu_args(pm, prog, segs) + (glik, bbuf, pm.n_sites)
    k8 = SG.plf_tree_seg_bwd_mxu.bf16_launches
    if variant == "mxu_bf16":
        with pytest.raises(ValueError, match="mxu_bf16"):
            SG.plf_tree_seg_bwd(*args, seg_ops=plan.seg_ops, **kw)
        assert SG.plf_tree_seg_bwd_mxu.bf16_launches == k8
        return
    gbufs = [torch.full_like(bbuf, float("nan")) for _ in range(3)]
    k1 = SG.plf_tree_seg_bwd(*args, seg_ops=plan.seg_ops, gbuf=gbufs[0], **kw)
    per_tile = TG.tree_bwd_scratch_bytes(plan.seg_ops, pm.config.rows, 128)
    k2 = SG.plf_tree_seg_bwd(*args, seg_ops=plan.seg_ops, gbuf=gbufs[1],
                             max_scratch_bytes=2 * per_tile, **kw)
    assert SG.plf_tree_seg_bwd_mxu.last_scratch["chunks"] > 1
    assert SG.plf_tree_seg_bwd_mxu.bf16_launches == k8 + 2
    p = SG.plf_tree_seg_bwd_torch(*args, gbuf=gbufs[2], **kw)
    torch.cuda.synchronize()
    assert torch.equal(gbufs[0], gbufs[2]) and torch.equal(gbufs[1],
                                                           gbufs[2])
    for k in (k1, k2):
        for i in range(3):
            _sums_close(k[i], p[i], rtol=3e-6)
        _sums_close(k[3].reshape(1, -1, 1), p[3].reshape(1, -1, 1),
                    rtol=3e-6)


@pytest.mark.parametrize("states", [4, 20])
def test_bf16_paths_on_the_card(cuda, monkeypatch, states):
    """Under PLFConfig(dtype="bfloat16"): PLFEngine.plf launches the bf16
    form of kernel 1 (1m at S = 20) and returns bf16; plf_batch, the fused
    path and the "tree" step launch only fp32 forms and equal the fp32
    model; log_likelihood(method="segmented") launches the bf16 kernel 7
    (7m) once, and a "segmented" step the bf16 kernels 7 + 8 (7m + 8m)
    once each, its value within 5e-3 of the fp32 model's.  The DNA
    gradient is within 0.05 of the fp32 one with a 1e-2 floor
    (tests/test_tree_seg.py:449-450).  The protein gradient is not held to
    the fp32 one: on this model rounded eigen-coordinate boundaries and
    1/lik-scaled adjoints move it by about seven times its size, in the
    JAX package (7.17) as in the port's plain path (7.36; python -m
    tests.test_torch_bf16 40 1500).
    It matches its CPU twin's (the plain versions on the card's lane
    constants, as test_matrix_form_training_step's) within rtol 2e-4 and
    1e-4 of the largest entry."""
    variant = "vpu" if states == 4 else "mxu_3x"
    tree = random_tree(40, seed=8, mean_branch=0.2)
    rng = np.random.default_rng(8)
    tips = rng.integers(-1, states + (10 if states == 4 else 3),
                        size=(40, 1500))
    model = hky85(2.0) if states == 4 else empirical_protein("lg")
    pms = {d: PhyloModel(tree, model, tips, alpha=0.6, device=cuda,
                         config=PLFConfig(states=states, dtype=d,
                                          kernel_variant=variant))
           for d in ("float32", "bfloat16")}
    node = plf_node if states == 4 else plf_node_mxu
    fwd = SG.plf_tree_seg if states == 4 else SG.plf_tree_seg_mxu
    bwd = SG.plf_tree_seg_bwd if states == 4 else SG.plf_tree_seg_bwd_mxu
    wrappers = _counted() + (SG.plf_tree_seg, SG.plf_tree_seg_bwd,
                             SG.plf_tree_seg_mxu, SG.plf_tree_seg_bwd_mxu)
    bf16_counts = lambda: [f.bf16_launches for f in (node, fwd, bwd)]
    C = pms["float32"].config.categories
    x1, x2, left, right, ev = _underflow_case_s(300, states, C, 3)
    eng = PLFEngine(PLFConfig(states=states, categories=C, dtype="bfloat16",
                              kernel_variant=variant), device=cuda)
    c0 = bf16_counts()
    out = eng.plf(x1, x2, left, right, ev)
    assert out.x3.dtype == BF16 and bf16_counts() == [c0[0] + 1] + c0[1:]
    batch = eng.plf_batch(x1[None], x2[None], left[None], right[None],
                          ev[None])
    assert batch.x3.dtype == torch.float32 and bf16_counts()[0] == c0[0] + 1
    a, b = (pms[d].log_likelihood(method="fused") for d in pms)
    np.testing.assert_array_equal(a.site_log_likelihood,
                                  b.site_log_likelihood)
    c0 = bf16_counts()
    seg16 = pms["bfloat16"].log_likelihood(method="segmented")
    assert bf16_counts() == [c0[0], c0[1] + 1, c0[2]]
    seg32 = pms["float32"].log_likelihood(method="segmented")
    rel = abs(seg16.log_likelihood / seg32.log_likelihood - 1)
    assert seg16.log_likelihood != seg32.log_likelihood and rel < 5e-3
    out = {}
    for d, pm in pms.items():
        for backend in ("segmented", "tree"):
            fn, t0 = tree_loglik_fn(pm, backend=backend)
            counts, c0 = [f.launches for f in wrappers], bf16_counts()
            t = torch.tensor(t0, device=cuda, requires_grad=True)
            v = fn(t)
            v.backward()
            runs = sum(f.launches - c for f, c in zip(wrappers, counts))
            assert runs == 2, (d, backend, runs)
            seg16_step = d == "bfloat16" and backend == "segmented"
            assert bf16_counts() == ([c0[0], c0[1] + 1, c0[2] + 1]
                                     if seg16_step else c0)
            out[d, backend] = (float(v.detach()), t.grad)
    assert out["bfloat16", "tree"][0] == out["float32", "tree"][0]
    assert torch.equal(out["bfloat16", "tree"][1], out["float32", "tree"][1])
    (v16, g16), (v32, g32) = (out[d, "segmented"]
                              for d in ("bfloat16", "float32"))
    assert v16 != v32 and abs(v16 / v32 - 1) < 5e-3
    assert bool(torch.isfinite(g16).all())
    if states == 4:
        assert float(((g16 - g32).abs() / (g32.abs() + 1e-2)).max()) < 0.05
        return
    twin = PhyloModel(tree, model, tips, alpha=0.6, device="cpu",
                      config=pms["bfloat16"].config)
    fn, t0 = tree_loglik_fn(twin, backend="segmented")
    t = torch.tensor(t0, requires_grad=True)
    monkeypatch.setattr(TO, "_lane_constants", _card_lane_constants(cuda))
    fn(t).backward()
    want = t.grad.numpy()
    np.testing.assert_allclose(g16.cpu().numpy(), want, rtol=2e-4,
                               atol=1e-4 * np.abs(want).max())


# ------------------------------------------------ analyses around a tree --

def _analysis_case(states=4, n_taxa=24, n_sites=3000, seed=31):
    """A tree and a simulated alignment with 5% gaps (a few IUPAC codes
    in DNA)."""
    model = hky85(4.0, [0.3, 0.2, 0.2, 0.3]) if states == 4 else \
        empirical_protein("lg")
    tree = random_tree(n_taxa, seed=seed, mean_branch=0.15)
    tips = simulate_alignment(tree, model, n_sites, alpha=0.5, seed=seed)
    rng = np.random.default_rng(seed)
    tips[rng.random(tips.shape) < 0.05] = -1
    if states == 4:
        tips[rng.random(tips.shape) < 0.02] = 5
    return tree, model, tips


@pytest.mark.parametrize("states", [4, 20])
def test_ancestral_marginal_ignores_global_tf32(cuda, states):
    """``ancestral_marginal`` on the card equals its CPU plain run within
    1e-5 (probabilities in fp32; the sums of its broadcast contractions
    run in another order on the card) with TF32 switched on globally for
    cuBLAS and cuDNN: the port must not lean on a default a caller may
    have changed (TF32 keeps ~3 decimal digits, far outside the bar)."""
    from plf_tpu_torch.models import ancestral_marginal
    tree, model, tips = _analysis_case(states)
    want = ancestral_marginal(PhyloModel(tree, model, tips, alpha=0.5,
                                         device="cpu"))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = ancestral_marginal(PhyloModel(tree, model, tips, alpha=0.5,
                                            device=cuda))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    assert set(got) == set(want)
    for v in got:
        np.testing.assert_allclose(got[v], want[v], atol=1e-5, rtol=0)


def test_alrt_support_on_the_card_equals_cpu(cuda, monkeypatch):
    """Every tree ``alrt_support`` scores (kernel 2 once each on the card)
    within rel 1e-6 of the CPU plain run's ll; the aLRT statistics within
    abs 1e-2 (twice a difference of ~1e4-magnitude lls)."""
    from plf_tpu_torch.models import alrt_support
    from plf_tpu_torch.models import support as TSup
    tree, model, tips = _analysis_case(n_taxa=16, n_sites=2000, seed=33)
    real, seen = TSup._site_ll, {}

    def spy(t, *a, **kw):
        ll, s, pm = real(t, *a, **kw)
        seen.setdefault(str(pm.device), []).append(ll)
        return ll, s, pm

    monkeypatch.setattr(TSup, "_site_ll", spy)
    c0 = plf_tree.launches
    got = alrt_support(tree, model, tips, alpha=0.5, rell_replicates=200,
                       device=cuda)
    assert plf_tree.launches - c0 == 1 + 2 * len(got)
    want = alrt_support(tree, model, tips, alpha=0.5, rell_replicates=200,
                        device="cpu")
    (card,), (cpu,) = ([v for k, v in seen.items() if k.startswith(d)]
                       for d in ("cuda", "cpu"))
    np.testing.assert_allclose(card, cpu, rtol=1e-6)
    for d in want:
        assert got[d][0] == pytest.approx(want[d][0], abs=1e-2)


def test_partitioned_log_likelihood_is_the_sum_of_its_parts(cuda):
    """Three codon-position partitions, each HKY85+G4 with its own alpha:
    the partitioned ll is the host sum of the three PhyloModels' lls bit
    for bit (kernel 2 once each), and the joint objective at t0 within
    rel 1e-5 of it (the "segmented" forward, kernel 7)."""
    from plf_tpu_torch.models import Partition, PartitionedModel
    tree, model, tips = _analysis_case(n_sites=3000)
    sites = np.arange(tips.shape[1])
    parts = [Partition(f"pos{i}", sites[sites % 3 == i], model, alpha=a)
             for i, a in enumerate((0.4, 0.5, 0.6))]
    c0 = plf_tree.launches
    pmod = PartitionedModel(tree, parts, tips, device=cuda)
    res = pmod.log_likelihood()
    assert plf_tree.launches - c0 == 3
    sep = [PhyloModel(tree, model, tips[:, p.sites], alpha=p.alpha,
                      device=cuda).log_likelihood().log_likelihood
           for p in parts]
    assert res.log_likelihood == float(sum(sep))
    fn, t0, _ = pmod.loglik_fn()
    with torch.no_grad():
        v = float(fn(t0, torch.zeros(3)))
    assert v == pytest.approx(res.log_likelihood, rel=1e-5)


@pytest.mark.parametrize("states", [4, 20])
def test_site_rates_launches_one_node_kernel_a_node(cuda, states):
    """``site_rates`` runs the per-node traversal: kernel 1 (S=4) or 1m
    (S=20, the default protein model's "mxu_3x") once per internal node
    and no other kernel; its rates and category posteriors equal the CPU
    plain run's bit for bit (kernels 1 and 1m equal their plain versions
    bit for bit, and the float64 epilogue is the same numpy)."""
    from plf_tpu_torch.models import site_rates
    tree, model, tips = _analysis_case(states, n_taxa=12, n_sites=1000)
    pm = PhyloModel(tree, model, tips, alpha=0.5, device=cuda)
    wrappers = _counted()
    before = [f.launches for f in wrappers]
    mean, post = site_rates(pm)
    runs = {f.__name__: f.launches - b for f, b in zip(wrappers, before)
            if f.launches != b}
    node = "plf_node" if states == 4 else "plf_node_mxu"
    assert runs == {node: len(pm.schedule)}
    mean_c, post_c = site_rates(PhyloModel(tree, model, tips, alpha=0.5,
                                           device="cpu"))
    np.testing.assert_array_equal(post, post_c)
    np.testing.assert_array_equal(mean, mean_c)


# ------------------------------------------------------ the three axes --


@pytest.mark.parametrize("S,C,n,n_pad", [(4, 4, 5000 - 7, 5120),
                                         (4, 5, 301, 384)] + NODE_MXU_EDGES)
@pytest.mark.parametrize("variant", ["vpu"] + MXU_VARIANTS)
def test_node_batch_equals_single_launches_and_plain(cuda, S, C, n, n_pad,
                                                     variant):
    """Kernels 1 and 1m with an instance axis (``plf_node_batch``): three
    instances in one launch, each equal to a single launch on it and to
    the plain version bit for bit (x3 and flags), at kernel 1's shapes
    and kernel 1m's edge shapes (``NODE_MXU_EDGES``)."""
    if S == 4 and variant != "vpu" and C != 4:
        pytest.skip("the MXU forms at S = 4 are covered at C = 4")
    cases = [_underflow_case_s(n, S, C, 40 + i) for i in range(3)]
    lane = lambda x: np.pad(L.to_lane_major(x, S, C),
                            ((0, 0), (0, n_pad - n)))
    x1 = torch.as_tensor(np.stack([lane(c[0]) for c in cases]), device=cuda)
    x2 = torch.as_tensor(np.stack([lane(c[1]) for c in cases]), device=cuda)
    lc, rc, ec = (torch.as_tensor(np.stack([f(c) for c in cases]),
                                  device=cuda) for f in (
        lambda c: L.branch_to_lane_constants(c[2], S, C),
        lambda c: L.branch_to_lane_constants(c[3], S, C),
        lambda c: L.ev_to_lane_constants(c[4], S, C)))
    kw = dict(states=S, categories=C, variant=variant)
    mxu = uses_mxu_kernels(variant, S)
    from plf_tpu_torch.ops import plf_mxu as M, plf_node as NN
    counter = M.plf_node_mxu_batch if mxu else NN.plf_node_batch
    before = counter.launches
    x3, sc = NN.plf_node_batch(x1, x2, lc, rc, ec, n, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    x3p, scp = NN.plf_node_batch_torch(x1, x2, lc, rc, ec, n, states=S,
                                       categories=C) if not mxu else \
        M.plf_node_mxu_batch_torch(x1, x2, lc, rc, ec, n, **kw)
    for i in range(3):
        one, one_sc = plf_node(x1[i], x2[i], lc[i], rc[i], ec[i], n, **kw)
        assert torch.equal(x3[i], one) and torch.equal(sc[i], one_sc[0])
    assert torch.equal(x3, x3p) and torch.equal(sc, scp)
    assert int(sc.sum()) > 0 and not sc[:, n:].any()


def test_plf_batch_is_one_launch(cuda):
    """``PLFEngine.plf_batch`` on the card: one launch of kernel 1 (1m at
    S = 20), each instance equal to ``plf`` on it; fp32 under a bf16
    config."""
    from plf_tpu_torch.ops import plf_mxu as M, plf_node as NN
    for S, counter in ((4, NN.plf_node_batch), (20, M.plf_node_mxu_batch)):
        cases = [_underflow_case_s(999, S, 4, 50 + i) for i in range(3)]
        args = [np.stack([c[k] for c in cases]) for k in range(5)]
        eng = PLFEngine(PLFConfig(states=S, dtype="bfloat16"), device=cuda)
        before, single = counter.launches, (NN.plf_node.launches,
                                            M.plf_node_mxu.launches)
        out = eng.plf_batch(*args)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert (NN.plf_node.launches, M.plf_node_mxu.launches) == single
        assert out.x3.dtype == torch.float32
        f32 = PLFEngine(PLFConfig(states=S), device=cuda)
        for i in range(3):
            one = f32.plf(*(a[i] for a in args))
            assert torch.equal(out.x3[i], one.x3)
            assert int(out.scaler_increment[i]) == int(one.scaler_increment)


def _seg_batch_models(cuda, S, variant, dtype, n_leaves, n_sites, k=6):
    model = {4: lambda: hky85(2.0), 20: lambda: empirical_protein("lg"),
             61: lambda: codon_gy94(2.0, 0.5)}[S]()
    codes = {4: 14, 20: 23, 61: 61}[S]
    tips = np.random.default_rng(61).integers(-1, codes,
                                              size=(n_leaves, n_sites))
    cfg = PLFConfig(states=S, kernel_variant=variant, dtype=dtype)
    trees = [random_tree(n_leaves, seed=s) for s in range(k)]
    pm0 = PhyloModel(trees[0], model, tips, alpha=0.5, config=cfg,
                     device=cuda)
    return [pm0] + [PhyloModel(t, model, tips, alpha=0.5, config=cfg,
                               share_device_from=pm0, device=cuda)
                    for t in trees[1:]]


def _seg_batch_args(pms):
    progs, segs, lcs, rcs, planes, n_slots, n_bnd = \
        TP.segmented_batch_inputs(pms)
    pm0 = pms[0]
    cfg = pm0.config
    args = (pm0.codes, progs, segs, lcs, rcs, pm0.ec, pm0.fused_tip_table,
            pm0.root_rows[0], pm0.n_sites)
    kw = dict(n_boundaries=n_bnd, n_slots=n_slots, states=cfg.states,
              categories=cfg.categories, variant=cfg.resolved_kernel_variant,
              planes=planes, dtype=getattr(torch, cfg.dtype))
    return args, kw


@pytest.mark.parametrize("S,variant", [(4, "vpu"), (20, "mxu_3x"),
                                       (20, "mxu"), (61, "mxu")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seg_batch_equals_single_launches_and_plain(cuda, S, variant, dtype,
                                                    monkeypatch):
    """Kernels 7 and 7m with a candidate axis: random trees over one
    alignment (different segment counts; a cap of 3 ops a segment),
    batched under a boundary-buffer cap of two candidates, so the batch
    runs in chunks (one launch each); every row equals the single-tree
    launch on the candidate and the plain batch bit for bit, and with
    fp32 boundaries the fused kernel (2 or 2m)."""
    if S == 61 and dtype == "bfloat16":
        pytest.skip("S = 61 runs in fp32 storage here")
    monkeypatch.setattr(SG, "seg_cap_ops", lambda *a, **k: 3)
    monkeypatch.setattr(SG, "seg_mxu_cap_ops", lambda *a, **k: 3)
    n_leaves, n_sites = {4: (24, 3000), 20: (12, 700), 61: (8, 300)}[S]
    pms = _seg_batch_models(cuda, S, variant, dtype, n_leaves, n_sites)
    args, kw = _seg_batch_args(pms)
    rows, n_pad = pms[0].config.rows, pms[0].n_pad
    cap = 2 * kw["n_boundaries"] * rows * n_pad * (2 if dtype ==
                                                   "bfloat16" else 4)
    per = SG.seg_batch_size(len(pms), kw["n_boundaries"], rows, n_pad,
                            kw["dtype"], cap)
    assert per == 2
    mxu = uses_mxu_kernels(variant, S)
    counter = SG.plf_tree_seg_mxu_batch if mxu else SG.plf_tree_seg_batch
    before = counter.launches
    lik, sc = SG.plf_tree_seg_batch(*args, bbuf_bytes=cap, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + -(-len(pms) // per)
    lp, sp = SG.plf_tree_seg_batch_torch(*args, **kw)
    assert torch.equal(lik, lp) and torch.equal(sc, sp)
    whole, whole_sc = SG.plf_tree_seg_batch(*args, **kw)
    assert torch.equal(lik, whole) and torch.equal(sc, whole_sc)
    for b, pm in enumerate(pms):
        plan, prog, segs, slots = pm._segmented_inputs()
        one, one_sc, _ = SG.plf_tree_seg(
            pm.codes, prog, segs, pm.lcs, pm.rcs, pm.ec, pm.fused_tip_table,
            pm.root_rows[0], pm.n_sites, n_boundaries=plan.n_boundaries,
            n_slots=slots, states=S, categories=pm.config.categories,
            variant=variant, planes=pm._planes(), dtype=kw["dtype"],
            program=pm.segmented_program)
        assert torch.equal(lik[b], one[0]) and torch.equal(sc[b], one_sc[0])
        if dtype == "float32" and pm.can_fuse():
            f, f_sc = plf_tree(
                pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec,
                pm.fused_tip_table, pm.root_rows[0], pm.n_sites,
                n_slots=pm.n_slots, root_slot=pm.root_slot, states=S,
                categories=pm.config.categories, variant=variant,
                planes=pm._planes(),
                program=None if mxu else pm.tree_program)
            assert torch.equal(lik[b], f[0]) and torch.equal(sc[b], f_sc[0])
    lls = TP.batch_log_likelihood_segmented(pms)
    own = [pm.log_likelihood(method="segmented").log_likelihood
           for pm in pms]
    np.testing.assert_allclose(lls, own, rtol=1e-6)


def test_one_rank_mesh_on_the_card(cuda):
    """A one-rank ``SiteMesh`` on the card (no process group): the
    sharded likelihood equals the unsharded one site for site, and a
    "tree" and a "segmented" mesh step equal the unsharded steps bit for
    bit; ``plf_sharded`` equals kernel 1 on the whole array."""
    from plf_tpu_torch.parallel import ShardedPLF, make_mesh
    mesh = make_mesh(device=cuda)
    assert mesh.size == 1 and mesh.device.type == "cuda"
    pm = _model(cuda, n_leaves=40, n_sites=5000)
    got, want = pm.log_likelihood_sharded(mesh), pm.log_likelihood()
    np.testing.assert_array_equal(got.site_log_likelihood,
                                  want.site_log_likelihood)
    assert got.scaler_total == want.scaler_total
    for backend in ("tree", "segmented"):
        grads = []
        for m in (None, mesh):
            fn, t0 = tree_loglik_fn(pm, backend=backend, mesh=m)
            t = torch.tensor(t0, device=cuda, requires_grad=True)
            fn(t).backward()
            grads.append(t.grad)
        assert torch.equal(grads[0], grads[1])
    x1, x2, left, right, ev = _underflow_case(3000, 4, 12)
    sp = ShardedPLF(mesh, block_sites=128)
    w = np.ones(3000, np.int32)
    x3, sc, inc = sp(sp.prepare(x1, 3000), sp.prepare(x2, 3000),
                     *sp.constants(left, right, ev),
                     sp.prepare_weights(w, 3000), 3000)
    x3_ref, sv, inc_ref = plf_reference(x1, x2, left, right, ev)
    np.testing.assert_array_equal(
        L.from_lane_major(x3.cpu().numpy(), n=3000), x3_ref)
    assert int(inc) == inc_ref > 0
