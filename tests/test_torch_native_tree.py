"""The port's native runtime beyond the node golden model
(``runtime/native.py``, ``native/plf_native.cpp``): the whole-tree golden
oracle (``plf_tree_golden_native``, ``tree_golden_for_model``), the
lane-layout converters, the instance packers and the branch transpose,
against the JAX package's (``plf_tpu/runtime/native.py``, both on the
host), the port's plain kernel 2 and their own NumPy fallbacks.

Every comparison is bit for bit: the oracle runs the tree kernels' fp32
op order (no contraction: ``-ffp-contract=off``), and the converters
move values."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

import plf_tpu.models as J  # noqa: E402
from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.runtime import native as JN  # noqa: E402
from plf_tpu_torch import convert  # noqa: E402
from plf_tpu_torch.config import PLFConfig  # noqa: E402
from plf_tpu_torch.ops import layout as L  # noqa: E402
from plf_tpu_torch.ops.plf_tree import plf_tree  # noqa: E402
from plf_tpu_torch.runtime import native as N  # noqa: E402


def _pair(states=4, taxa=12, sites=300, seed=90, p_inv=None):
    rng = np.random.default_rng(seed)
    codes = 14 if states == 4 else 23
    tips = rng.integers(-1, codes, size=(taxa, sites))
    model = (J.hky85(2.0) if states == 4 else J.empirical_protein("lg"))
    pj = J.PhyloModel(J.random_tree(taxa, seed=seed), model, tips,
                      alpha=0.5, p_inv=p_inv,
                      config=JCfg(states=states, block_sites=128,
                                  interpret=True, kernel_variant="vpu"))
    pt = convert.phylo_model(
        pi=model.pi, eigenvalues=model.eigenvalues, u=model.u, w=model.w,
        nodes=[(n.index, n.name, n.length, n.children)
               for n in pj.tree.nodes], root=pj.tree.root, rates=pj.rates,
        rate_weights=pj.rate_weights, tip_states=tips,
        config=PLFConfig(states=states, block_sites=128,
                         kernel_variant="vpu"), device="cpu")
    return pj, pt


@pytest.mark.parametrize("case", ["dna", "dna_pinv", "protein"])
def test_tree_golden_for_model_equals_jax_and_kernel2(case):
    """The port's oracle equals the JAX package's on the same model bit
    for bit, and kernel 2's (2m's, fp32 "vpu" mode at S = 20) plain
    outputs on the model's first ``n_sites`` sites; both rescale."""
    S = 20 if case == "protein" else 4
    pj, pt = _pair(states=S, taxa=40 if S == 4 else 10,
                   p_inv=0.2 if case == "dna_pinv" else None)
    lik, sc = N.tree_golden_for_model(pt)
    jlik, jsc = JN.tree_golden_for_model(pj)
    assert lik.dtype == np.float32 and sc.dtype == np.int32
    np.testing.assert_array_equal(lik, jlik)
    np.testing.assert_array_equal(sc, jsc)
    n = pt.n_sites
    klik, ksc = plf_tree(
        pt.codes, pt.sched, pt.lcs, pt.rcs, pt.ec, pt.fused_tip_table,
        pt.root_rows[0], n, n_slots=pt.n_slots, root_slot=pt.root_slot,
        states=S, categories=pt.config.categories, variant="vpu",
        planes=pt._planes(), program=None if S != 4 else pt.tree_program)
    np.testing.assert_array_equal(lik, klik[0, :n].numpy())
    np.testing.assert_array_equal(sc, ksc[0, :n].numpy())
    if S == 4:
        assert sc.sum() > 0


def test_tree_golden_native_equals_numpy_and_threads():
    """The native oracle, single- and multi-threaded, equals its NumPy
    fallback bit for bit."""
    _, pt = _pair(taxa=16, sites=2500, seed=91)
    lik1, sc1 = N.tree_golden_for_model(pt, threads=1)
    lik8, sc8 = N.tree_golden_for_model(pt, threads=8)
    np.testing.assert_array_equal(lik1, lik8)
    np.testing.assert_array_equal(sc1, sc8)
    from plf_tpu_torch.io.alignment import map_tip_codes, tip_expansion_table
    from plf_tpu_torch.models.substitution import branch_matrices
    from plf_tpu_torch.ops.plf_tree import (compile_register_schedule,
                                            reorder_schedule)
    S, C = 4, pt.config.categories
    n_leaves = pt.tree.n_leaves
    sched_r = reorder_schedule(pt.schedule, n_leaves)
    (ls, lf, rs, rf, os_, _), _, _ = compile_register_schedule(sched_r,
                                                               n_leaves)
    br = [np.stack([branch_matrices(pt.model, e[k], pt.rates, C)
                    for e in sched_r]) for k in (3, 4)]
    args = (np.ascontiguousarray(map_tip_codes(pt.tip_states, S), np.int32),
            tip_expansion_table(pt.model.w, S).astype(np.float32),
            (ls + lf * n_leaves).astype(np.int32),
            (rs + rf * n_leaves).astype(np.int32),
            (os_ + n_leaves).astype(np.int32), br[0].astype(np.float32),
            br[1].astype(np.float32), pt.model.plf_ev.astype(np.float32),
            pt.root_rows[0].numpy())
    lik_np, sc_np = N._tree_golden_np(*args, S, C)
    np.testing.assert_array_equal(lik1, lik_np)
    np.testing.assert_array_equal(sc1, sc_np)


@pytest.mark.parametrize("states", [4, 20])
def test_converters_round_trip_and_match_jax(states):
    rng = np.random.default_rng(92)
    C = 4
    clv = rng.random((777, C * states), dtype=np.float32)
    lm = N.to_lane_major_native(clv, states)
    np.testing.assert_array_equal(lm, L.to_lane_major(clv, states, C))
    np.testing.assert_array_equal(lm, JN.to_lane_major_native(clv, states))
    back = N.from_lane_major_native(np.pad(lm, ((0, 0), (0, 47))), n=777,
                                    states=states)
    np.testing.assert_array_equal(back.reshape(777, -1), clv)
    ev = rng.random((states, states), dtype=np.float32)
    branch = rng.random((C, states, states), dtype=np.float32)
    x = rng.random((100, C, states), dtype=np.float32)
    for combined in (True, False):
        buf = N.pack_instance_native(ev, branch, x, states, combined=combined)
        np.testing.assert_array_equal(
            buf, JN.pack_instance_native(ev, branch, x, states,
                                         combined=combined))
        header = (states * states if combined else 0) + C * states * states
        assert buf.size == header + x.size
        ev2, br2, x2 = N.unpack_instance_native(buf, 100, states,
                                                combined=combined)
        if combined:
            np.testing.assert_array_equal(ev2, ev)
        np.testing.assert_array_equal(br2, branch)
        np.testing.assert_array_equal(x2, x)
    t = N.transpose_branch_native(branch, states)
    np.testing.assert_array_equal(t, np.transpose(branch, (0, 2, 1)))


def test_numpy_fallbacks_without_the_library(monkeypatch):
    """Without a compiler every entry point answers from NumPy with the
    same bits."""
    rng = np.random.default_rng(93)
    clv = rng.random((300, 16), dtype=np.float32)
    branch = rng.random((4, 4, 4), dtype=np.float32)
    ev = rng.random((4, 4), dtype=np.float32)
    _, pt = _pair(taxa=8, sites=200, seed=94)
    native = (N.to_lane_major_native(clv),
              N.from_lane_major_native(N.to_lane_major_native(clv)),
              N.pack_instance_native(ev, branch, clv),
              N.transpose_branch_native(branch),
              N.tree_golden_for_model(pt))
    monkeypatch.setattr(N, "_lib", lambda: None)
    assert N.golden_oracle() == "numpy"
    plain = (N.to_lane_major_native(clv),
             N.from_lane_major_native(N.to_lane_major_native(clv)),
             N.pack_instance_native(ev, branch, clv),
             N.transpose_branch_native(branch),
             N.tree_golden_for_model(pt))
    for a, b in zip(native[:4], plain[:4]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(native[4], plain[4]):
        np.testing.assert_array_equal(a, b)
