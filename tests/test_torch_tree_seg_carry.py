"""Kernel 7's carried segment program
(``ops/plf_tree_seg.py::carry_segment_program``): an operand that the op
before produced in the same segment is taken from registers, only the
outputs that a later op other than the next one reads are stored, and a
segment's root is never stored (it leaves through the boundary buffer).
Its structure on caterpillar, balanced and random trees and on the smoke
plans, its plain interpreter (``plf_tree_seg_torch``) against the
uncarried program's run and the JAX package's ``plf_tree_segmented`` in
interpret mode, and a pin of ``segment_program``'s own output (kernel
7m's program)."""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

from plf_tpu.ops import plf_tree_seg as JSG  # noqa: E402
from plf_tpu_torch.config import PLFConfig  # noqa: E402
from plf_tpu_torch.models import PhyloModel, hky85  # noqa: E402
from plf_tpu_torch.models import parse_newick as tparse  # noqa: E402
from plf_tpu_torch.models import random_tree as trt  # noqa: E402
from plf_tpu_torch.ops import plf_tree as TT  # noqa: E402
from plf_tpu_torch.ops import plf_tree_seg as SG  # noqa: E402
from test_torch_tree_seg import (ROWS, _caterpillar, _jax_inputs,  # noqa: E402
                                 _jax_model, _port_of, _schedules)
from test_torch_tree_carry import _newick  # noqa: E402


def _tree(shape, n_leaves):
    if shape == "random":
        return trt(n_leaves, seed=n_leaves)
    return tparse(_newick(shape, n_leaves))


def _plan(tree, cap=None):
    n_leaves = tree.n_leaves
    sched = TT.reorder_schedule(tree.schedule(), n_leaves)
    pos = [(p, l, r, 0.0, 0.0, i) for i, (p, l, r, *_x) in enumerate(sched)]
    plan = SG.plan_segments(pos, n_leaves, rows=ROWS, cap_ops=cap,
                            n_codes=15)
    return sched, plan


def _programs(tree, cap=None):
    sched, plan = _plan(tree, cap)
    prog, segs, n_slots = SG.segment_program(plan, sched, reuse_slots=True)
    carried, slots = SG.carry_segment_program(prog, segs)
    return sched, plan, prog, segs, n_slots, carried, slots


def _hazards(prog, segs):
    """Ops that read the boundary the op right before them exports."""
    out = 0
    for end, gout in segs[:-1]:
        out += int(any(prog[2 * s + 1, end] == 2 and prog[2 * s, end] == gout
                       for s in range(2)))
    return out


def _interpret(sched, plan, prog, segs):
    """Run the program on node ids: per op, the tree nodes its operands
    hold (a boundary id names the node of the segment root it exports).
    Checks every read against the schedule's children, that a carried
    operand is op i-1's output in the same segment, that no live slot is
    overwritten and every stored CLV is read, and that every boundary is
    exported before it is read.  The program runs the ops in the plan's
    order, segment by segment."""
    lsrc, lflag, rsrc, rflag, oslot, _ = prog
    ops = [sched[int(p)] for sg in plan.segments for p in sg.opos[:sg.n_ops]]
    parents = [e[0] for e in ops]
    starts = {0} | {int(e) for e in segs[:-1, 0]}
    arena, exported, last = {}, {}, None
    seg = 0
    for i, (parent, left, right, *_x) in enumerate(ops):
        for src, flag, child in ((lsrc[i], lflag[i], left),
                                 (rsrc[i], rflag[i], right)):
            if flag == SG.SEG_CARRIED:
                assert i not in starts, i       # never across a segment end
                got = last
            elif flag == 1:
                got = arena.pop(int(src))
            elif flag == 2:
                got = exported[int(src)]
            else:
                got = int(src)
            assert got == child, (i, src, flag, child)
            # an operand that op i-1 produced in the same segment is carried
            assert (flag == SG.SEG_CARRIED) == (
                i not in starts and child == parents[i - 1]), (i, flag)
        if oslot[i] >= 0:
            assert int(oslot[i]) not in arena
            arena[int(oslot[i])] = parent
        last = parent
        if i + 1 == segs[seg, 0]:
            assert oslot[i] == -1                # no slot holds a root
            assert not arena                     # every stored CLV is read
            if segs[seg, 1] >= 0:
                exported[int(segs[seg, 1])] = parent
            seg += 1
    assert seg == len(segs) and len(exported) == plan.n_boundaries
    assert sorted(parents) == sorted(e[0] for e in sched)
    return last


SHAPES = [(s, n, cap) for s in ("left", "right", "balanced", "random")
          for n, cap in ((16, 3), (64, 6), (64, None))]


@pytest.mark.parametrize("shape,n_leaves,cap", SHAPES)
def test_carried_segment_program_structure(shape, n_leaves, cap):
    """Every op appears once, in segment_program's order with its edges,
    tips and boundaries, and the segment ends are unchanged; flag 3
    appears exactly where op i-1 of the same segment produced the operand;
    no arena slot holds a segment root; the program needs no more slots
    than segment_program's."""
    tree = _tree(shape, n_leaves)
    sched, plan, prog, segs, n_slots, carried, slots = _programs(tree, cap)
    assert len(plan.segments) > 1
    assert carried.shape == prog.shape and carried.dtype == np.int32
    np.testing.assert_array_equal(carried[5], prog[5])
    assert sorted(carried[5]) == list(range(len(sched)))
    for side in range(2):
        keep = prog[2 * side + 1] != 1
        np.testing.assert_array_equal(carried[2 * side][keep],
                                      prog[2 * side][keep])
        np.testing.assert_array_equal(carried[2 * side + 1][keep],
                                      prog[2 * side + 1][keep])
    assert _interpret(sched, plan, carried, segs) == sched[-1][0]
    assert (carried[4, segs[:, 0] - 1] == -1).all()
    assert 0 <= slots <= n_slots
    assert carried[4].max(initial=-1) == slots - 1
    if shape in ("left", "right"):
        assert slots == 0            # every op carries its internal child


@pytest.mark.parametrize("n_leaves,seed,want", [
    (160, 1, (36, 35, 3, 2, 3)), (256, 4, (53, 52, 3, 2, 5))])
def test_carried_segment_program_on_smoke_plans(n_leaves, seed, want):
    """The smoke models' plans (chip_smoke.py: 160 taxa seed 1, 256 taxa
    seed 4, 15 tip codes): segments, boundaries, segment_program's slots
    against the carried program's, and the ops that read a boundary
    exported by the op right before them (kernel 7 reads those late)."""
    tree = trt(n_leaves, seed=seed)
    sched, plan, prog, segs, n_slots, carried, slots = _programs(tree)
    assert _interpret(sched, plan, carried, segs) == sched[-1][0]
    assert (len(plan.segments), plan.n_boundaries, n_slots, slots,
            _hazards(carried, segs)) == want


#: segment_program's output (kernel 7m's and kernel 8's programs) at the
#: 12-taxon plan below, and digests of (prog, segs) at the smoke plans:
#: (n_leaves, seed, reuse_slots) -> (n_slots, sha256 prefix).
SEG_PROGRAM_12 = (
    [[5, 9, 0, 0, 1, 8, 2, 2, 11, 0, 3], [0, 0, 2, 1, 0, 0, 0, 2, 0, 1, 2],
     [4, 0, 0, 6, 10, 0, 1, 0, 3, 7, 4], [0, 1, 0, 0, 0, 1, 2, 1, 0, 0, 2],
     [0] * 11, [2, 3, 4, 5, 7, 8, 6, 9, 0, 1, 10]],
    [[2, 0], [4, 1], [6, 2], [8, 3], [10, 4], [11, -1]])
SEG_PROGRAM_DIGESTS = {
    (12, 3, True): (1, "1020a89ca565066c"),
    (12, 3, False): (2, "b1ee77d83ed3ba32"),
    (160, 1, True): (3, "b1a3fdf860722476"),
    (160, 1, False): (6, "1cf6d90f05efa21d"),
    (256, 4, True): (3, "81e58455fecfc57d"),
    (256, 4, False): (7, "08bc3b451c1b32e3"),
}


@pytest.mark.parametrize("key", list(SEG_PROGRAM_DIGESTS))
def test_segment_program_unchanged(key):
    """segment_program's own output, which kernels 7m and 8 run and
    seg_mxu_site_bytes counts, is what it was before the carried program
    existed."""
    n_leaves, seed, reuse = key
    sched, plan = _plan(trt(n_leaves, seed=seed),
                        4 if n_leaves == 12 else None)
    prog, segs, n_slots = SG.segment_program(plan, sched, reuse_slots=reuse)
    digest = hashlib.sha256(prog.astype("<i4").tobytes()
                            + segs.astype("<i4").tobytes()).hexdigest()
    assert (n_slots, digest[:16]) == SEG_PROGRAM_DIGESTS[key]
    if key == (12, 3, True):
        assert prog.tolist() == SEG_PROGRAM_12[0]
        assert segs.tolist() == SEG_PROGRAM_12[1]


# ------------------------------------------------------- plain interpreter --


def _port_model(tree, n_sites, seed, tip_dtype):
    tips = np.random.default_rng(seed).integers(-1, 14,
                                                size=(tree.n_leaves, n_sites))
    return PhyloModel(tree, hky85(2.0, [0.3, 0.2, 0.3, 0.2]), tips,
                      alpha=0.5, device="cpu",
                      config=PLFConfig(block_sites=128, tip_dtype=tip_dtype))


def _both(pt, plan, sched, dtype):
    """The plain version on segment_program's program and on its carried
    program."""
    prog, segs, n_slots = SG.segment_program(plan, sched, reuse_slots=True)
    carried, slots = SG.carry_segment_program(prog, segs)
    segs = torch.as_tensor(segs)
    args = (pt.codes, segs, pt.lcs, pt.rcs, pt.ec, pt.fused_tip_table,
            pt.root_rows[0], pt.n_sites)
    run = lambda p, s: SG.plf_tree_seg_torch(
        args[0], torch.as_tensor(p), *args[1:], n_boundaries=plan.n_boundaries,
        n_slots=s, dtype=dtype)
    return run(prog, n_slots), run(carried, slots), (carried, slots, segs)


CASES = [("rescaling", None), ("caterpillar", 6), ("random60", None),
         ("random30", 4)]


def _case_tree(name):
    if name == "rescaling":
        return tparse(_newick("left", 40)), 256
    if name == "caterpillar":
        return tparse(_newick("right", 24)), 300
    n = int(name[len("random"):])
    return trt(n, seed=3), 300


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tip_dtype", ["int32", "int8"])
@pytest.mark.parametrize("name,cap", CASES)
def test_carried_plain_equals_uncarried(name, cap, tip_dtype, dtype):
    """plf_tree_seg_torch on the carried program (flag 3: the last op's
    output; only oslot >= 0 stored; each root from the last op) == its run
    of segment_program's program bit for bit: lik, sc and every boundary,
    fp32 and bf16 boundaries, int32 and int8 codes; the rescaling case
    rescales, and the 60-taxon plan has an op that reads the boundary the
    op before it exports.  The wrapper on the CPU runs the carried program
    it is given to the same result."""
    tree, n_sites = _case_tree(name)
    pt = _port_model(tree, n_sites, 7, tip_dtype)
    sched, plan = _plan(tree, cap)
    assert len(plan.segments) > 1
    dt = getattr(torch, dtype)
    plain, carried, (cprog, slots, segs) = _both(pt, plan, sched, dt)
    for a, b in zip(plain, carried):
        assert torch.equal(a, b)
    assert carried[2].dtype == dt
    if name == "rescaling":
        assert int(carried[1].sum()) > 0, "case must rescale"
    if name == "random60":
        assert _hazards(cprog, segs.numpy()) > 0
    prog, _, n_slots = SG.segment_program(plan, sched, reuse_slots=True)
    got = SG.plf_tree_seg(
        pt.codes, torch.as_tensor(prog), segs, pt.lcs, pt.rcs, pt.ec,
        pt.fused_tip_table, pt.root_rows[0], pt.n_sites,
        n_boundaries=plan.n_boundaries, n_slots=n_slots, dtype=dt,
        program=(torch.as_tensor(cprog), slots))
    for a, b in zip(got, carried):
        assert torch.equal(a, b)


def test_carried_plain_matches_jax():
    """The carried program's plain run against JAX's plf_tree_segmented
    (interpret mode) on the same plan: rescale counts exactly, site
    likelihoods at rel 5e-5 (the bar of tests/test_torch_tree_seg.py:
    XLA:CPU contracts multiply-adds in the interpreted kernel)."""
    pm = _jax_model(_caterpillar(40), 256, 7)
    pt = _port_of(pm)
    sched, pos = _schedules(pm)
    plan = SG.plan_segments(pos, pm.tree.n_leaves, rows=ROWS, cap_ops=10)
    _, (lik, sc, _), _ = _both(pt, plan, sched, torch.float32)
    jplan = JSG.plan_segments(pos, pm.tree.n_leaves, rows=ROWS,
                              block_sites=128, cap_ops=10)
    lik_j, sc_j = JSG.plf_tree_segmented(jplan, *_jax_inputs(pm, sched),
                                         pm.n_sites, interpret=True)
    n = pm.n_sites
    assert int(sc.sum()) > 0
    np.testing.assert_array_equal(sc.numpy()[0, :n], np.asarray(sc_j)[0, :n])
    np.testing.assert_allclose(lik.numpy()[0, :n], np.asarray(lik_j)[0, :n],
                               rtol=5e-5)


def test_model_caches_the_carried_program():
    """PhyloModel builds kernel 7's carried program once, beside the
    segment plan, and log_likelihood(method="segmented") runs it to the
    fused path's result site for site; a matrix-form model has none."""
    pt = _port_model(trt(30, seed=5), 300, 5, "int32")
    program = pt.segmented_program
    assert program is pt.segmented_program
    plan, prog, segs, _ = pt._segmented_inputs()
    want = SG.carry_segment_program(prog.numpy(), segs.numpy())
    np.testing.assert_array_equal(program[0].numpy(), want[0])
    assert program[1] == want[1]
    seg = pt.log_likelihood(method="segmented")
    fused = pt.log_likelihood(method="fused")
    np.testing.assert_array_equal(seg.site_log_likelihood,
                                  fused.site_log_likelihood)
    mxu = PhyloModel(trt(12, seed=5), hky85(2.0),
                     np.zeros((12, 64), np.int64), device="cpu",
                     config=PLFConfig(kernel_variant="mxu"))
    assert mxu.segmented_program is None
