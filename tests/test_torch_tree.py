"""Kernel 2's host planners and plain version against the JAX package's
whole-tree kernels (interpret mode), and the GPU capacity rule."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

from plf_tpu.config import PLFConfig  # noqa: E402
from plf_tpu.models import PhyloModel, hky85, parse_newick, random_tree  # noqa: E402
from plf_tpu.ops import plf_tree_pallas as JT  # noqa: E402
from plf_tpu_torch.models import PhyloModel as TPM  # noqa: E402
from plf_tpu_torch.models import hky85 as thky  # noqa: E402
from plf_tpu_torch.models import random_tree as trt  # noqa: E402
from plf_tpu_torch.ops import plf_tree as TT  # noqa: E402
from plf_tpu_torch.ops.layout import branch_to_lane_constants  # noqa: E402
from plf_tpu.models.substitution import branch_matrices  # noqa: E402
from plf_tpu.reference import plf_reference  # noqa: E402


def unpack_branch_constants(packed, n_edges: int, states: int = 4):
    """Lane-dense ``(rows, E*S)`` -> contiguous ``(E, rows, S)``."""
    rows = packed.shape[0]
    return packed.reshape(rows, n_edges, states).permute(1, 0, 2) \
        .contiguous()


def plf_tree_forward(codes, schedule, lcs, rcs, ec, tip_table, root_rows,
                     n: int, *, n_leaves: int):
    """The port's fused tree forward with the JAX package's signature
    (``plf_tree_pallas`` / ``plf_tree_pallas_dynamic``): ``schedule`` from
    ``reorder_schedule``, ``lcs``/``rcs`` lane-dense ``(rows, E*S)``,
    ``root_rows`` ``(1, rows)``."""
    arrs, n_slots, root_slot = TT.compile_register_schedule(schedule,
                                                            n_leaves)
    sched = torch.as_tensor(np.stack(arrs), device=codes.device)
    E = len(schedule)
    return TT.plf_tree(
        codes, sched, unpack_branch_constants(lcs, E),
        unpack_branch_constants(rcs, E), ec.contiguous(),
        tip_table.contiguous(), root_rows.reshape(-1).contiguous(), n,
        n_slots=n_slots, root_slot=root_slot)


def _caterpillar(n_leaves):
    nwk = "A0:0.1"
    for i in range(1, n_leaves):
        nwk = f"({nwk},A{i}:0.1):0.1"
    return parse_newick(nwk + ";")


TREES = {"random12": lambda: random_tree(12, seed=3),
         "random50": lambda: random_tree(50, seed=4),
         "random160": lambda: random_tree(160, seed=1),
         "caterpillar20": lambda: _caterpillar(20)}


# ------------------------------------------------------------- planners --

@pytest.mark.parametrize("name", sorted(TREES))
def test_planners_identical(name):
    tree = TREES[name]()
    sched = tree.schedule()
    re_j = JT.reorder_schedule(sched, tree.n_leaves)
    re_t = TT.reorder_schedule(sched, tree.n_leaves)
    assert re_t == re_j
    assert TT.schedule_depth(re_t, tree.n_leaves) == \
        JT.schedule_depth(re_j, tree.n_leaves)
    arrs_j, ns_j, root_j = JT.compile_register_schedule(re_j, tree.n_leaves)
    arrs_t, ns_t, root_t = TT.compile_register_schedule(re_t, tree.n_leaves)
    assert (ns_t, root_t) == (ns_j, root_j)
    for a, b in zip(arrs_t, arrs_j):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_pack_branch_constants_identical():
    rng = np.random.default_rng(0)
    branches = [rng.random((4, 4, 4), dtype=np.float32) for _ in range(7)]
    np.testing.assert_array_equal(TT.pack_branch_constants(branches),
                                  JT.pack_branch_constants(branches))
    packed = torch.as_tensor(TT.pack_branch_constants(branches))
    unpacked = unpack_branch_constants(packed, 7).numpy()
    for e, b in enumerate(branches):
        np.testing.assert_array_equal(unpacked[e],
                                      branch_to_lane_constants(b))


# ------------------------------------------------------ capacity rule --

def test_capacity_rule():
    rows, n_codes = 16, 15
    assert TT.TREE_THREADS == 128
    assert TT.tree_fused_threads(6, rows, n_codes) == 128
    # the largest arena that fits one 128-thread block beside the
    # operator buffers, then none
    fits = [s for s in range(1, 200)
            if TT.tree_fused_smem_bytes(s, rows, n_codes)
            <= TT.SMEM_BLOCK_BYTES]
    assert max(fits) == 28
    assert TT.tree_fused_threads(28, rows, n_codes) == 128
    assert TT.tree_fused_threads(29, rows, n_codes) is None
    assert TT.tree_smem_bytes(6, rows, n_codes, 128) == 4 * (
        rows * 4 + rows * n_codes + rows + 6 * rows * 128)


@pytest.mark.parametrize("n_leaves", [160, 1000])
def test_big_random_trees_fit_one_block(n_leaves):
    tree = random_tree(n_leaves, seed=1)
    sched = TT.reorder_schedule(tree.schedule(), n_leaves)
    _, n_slots, _ = TT.compile_register_schedule(sched, n_leaves)
    assert n_slots <= TT.schedule_depth(sched, n_leaves)
    assert TT.tree_fused_threads(n_slots, 16, 15) == 128


# ------------------------------------ plain tree forward vs JAX kernels --

def _jax_model(n_leaves, n_sites, seed, tip_dtype):
    tree = random_tree(n_leaves, seed=seed)
    rng = np.random.default_rng(seed)
    tips = rng.integers(-1, 14, size=(n_leaves, n_sites))
    tips[1, :7] = -1
    tips[:, 3] = -1                                      # a gap column
    cfg = PLFConfig(block_sites=128, interpret=True, tip_dtype=tip_dtype)
    return PhyloModel(tree, hky85(2.0, [0.3, 0.2, 0.3, 0.2]), tips,
                      alpha=0.6, config=cfg)


def _golden_chain(pm, sched, ttab):
    """Site likelihoods by the numpy golden model node by node (tips as
    table columns, plf_reference per op, sequential fp32 root sum)."""
    S, C, n = 4, pm.config.categories, pm.n_pad
    codes, tt = np.asarray(pm._codes), np.asarray(ttab)
    site_major = lambda lane: np.transpose(lane.reshape(S, C, n), (2, 1, 0))
    clvs = {leaf: site_major(tt[:, codes[leaf]])
            for leaf in range(pm.tree.n_leaves)}
    for (p, l, r, tl, tr, _e) in sched:
        clvs[p] = plf_reference(
            clvs[l], clvs[r], branch_matrices(pm.model, tl, pm.rates, C),
            branch_matrices(pm.model, tr, pm.rates, C), pm.model.plf_ev,
            categories=C)[0]
    root = np.transpose(clvs[sched[-1][0]], (2, 1, 0)).reshape(S * C, n)
    rr = np.asarray(pm._root_rows)[0]
    lik = rr[0] * root[0]
    for r in range(1, S * C):
        lik = lik + rr[r] * root[r]
    return lik


@pytest.mark.parametrize("tip_dtype", ["int32", "int8"])
@pytest.mark.parametrize("kernel", ["static", "dynamic"])
def test_plain_tree_matches_jax_kernels(kernel, tip_dtype):
    """Against plf_tree_pallas / plf_tree_pallas_dynamic in interpret
    mode: scaler counts exact, site likelihoods within 5e-5 relative.
    XLA:CPU contracts the kernels' mul+add into FMAs; through the tree and
    the cancelling root sum (eigen coordinates are mixed-sign) that grows
    to 1.2e-5 relative against the golden chain (measured, 9 leaves x 256
    sites), while the port equals the golden chain bit for bit."""
    n_leaves = 7 if kernel == "static" else 9
    pm = _jax_model(n_leaves, 256, 31, tip_dtype)
    sched, lcs, rcs, ttab = pm._fused_inputs()
    fn = (JT.plf_tree_pallas if kernel == "static"
          else JT.plf_tree_pallas_dynamic)
    lik_j, sc_j = fn(pm._codes, sched, lcs, rcs, pm._ec, ttab,
                     pm._root_rows, pm.n_sites, n_leaves=n_leaves,
                     block_sites=128, interpret=True)
    t = lambda a: torch.tensor(np.asarray(a))
    lik_t, sc_t = plf_tree_forward(
        t(pm._codes), sched, t(lcs), t(rcs), t(pm._ec), t(ttab),
        t(pm._root_rows), pm.n_sites, n_leaves=n_leaves)
    assert lik_t.shape == (1, pm.n_pad)
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    np.testing.assert_allclose(lik_t.numpy(), np.asarray(lik_j), rtol=5e-5,
                               atol=1e-37)
    np.testing.assert_array_equal(lik_t.numpy()[0],
                                  _golden_chain(pm, sched, ttab))


def test_plain_tree_int8_equals_int32():
    pm = _jax_model(8, 300, 5, "int32")
    sched, lcs, rcs, ttab = pm._fused_inputs()
    t = lambda a: torch.tensor(np.asarray(a))
    args = (sched, t(lcs), t(rcs), t(pm._ec), t(ttab), t(pm._root_rows),
            pm.n_sites)
    a = plf_tree_forward(t(pm._codes), *args, n_leaves=8)
    b = plf_tree_forward(t(pm._codes).to(torch.int8), *args, n_leaves=8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_plain_tree_padding_sites_never_rescale():
    pm = _jax_model(9, 130, 8, "int32")     # 130 sites -> 126 padding
    sched, lcs, rcs, ttab = pm._fused_inputs()
    t = lambda a: torch.tensor(np.asarray(a))
    _, sc = plf_tree_forward(t(pm._codes), sched, t(lcs), t(rcs),
                                t(pm._ec), t(ttab), t(pm._root_rows),
                                pm.n_sites, n_leaves=9)
    assert not sc[0, pm.n_sites:].any()


# --------------------------------------------------------------- dispatch --

def _port_model(n_leaves=10, n_sites=200, device="cpu", **kw):
    tips = np.random.default_rng(2).integers(-1, 14, size=(n_leaves,
                                                           n_sites))
    return TPM(trt(n_leaves, seed=2), thky(2.0), tips, alpha=0.5,
               device=device, **kw)


def test_cpu_tree_never_counts_a_launch():
    pm = _port_model()
    before = TT.plf_tree.launches
    pm.log_likelihood(method="fused")
    assert TT.plf_tree.launches == before


def test_tree_wrapper_validates_inputs():
    pm = _port_model()
    args = [pm.codes, pm.sched, pm.lcs, pm.rcs, pm.ec, pm.tip_table,
            pm.root_rows[0], pm.n_sites]
    kw = dict(n_slots=pm.n_slots, root_slot=pm.root_slot)
    with pytest.raises(ValueError, match="no kernel for device"):
        TT.plf_tree(*[a.to("meta") if torch.is_tensor(a) else a
                      for a in args], **kw)
    with pytest.raises(TypeError):
        TT.plf_tree(pm.codes.float(), *args[1:], **kw)
    with pytest.raises(ValueError):
        TT.plf_tree(*args, n_slots=pm.n_slots, root_slot=pm.n_slots)
    bad = list(args)
    bad[1] = pm.sched[:5]
    with pytest.raises(ValueError):
        TT.plf_tree(*bad, **kw)
