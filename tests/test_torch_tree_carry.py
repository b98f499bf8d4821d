"""Kernel 2's carried program (``ops/plf_tree.py::carry_program``): an
operand that the op before produced is taken from registers, and only the
outputs that a later op other than the next one reads are stored.  Its
structure on caterpillar, balanced and random trees, and its plain
interpreter (``plf_tree_torch``) against the uncarried plain version and
the JAX package's ``plf_tree_pallas_dynamic`` in interpret mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

from plf_tpu.config import PLFConfig  # noqa: E402
from plf_tpu.models import PhyloModel, hky85, parse_newick, random_tree  # noqa: E402
from plf_tpu.ops import plf_tree_pallas as JT  # noqa: E402
from plf_tpu_torch.models import parse_newick as tparse  # noqa: E402
from plf_tpu_torch.models import random_tree as trt  # noqa: E402
from plf_tpu_torch.ops import plf_tree as TT  # noqa: E402


def _caterpillar_newick(n_leaves, grown_left):
    """A caterpillar whose internal child is always the left one (or the
    right one)."""
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


def _newick(shape, n_leaves):
    if shape == "balanced":
        return _balanced_newick(int(np.log2(n_leaves)))
    return _caterpillar_newick(n_leaves, shape == "left")


def _tree(shape, n_leaves, parse=tparse, random=trt):
    if shape == "random":
        return random(n_leaves, seed=n_leaves)
    return parse(_newick(shape, n_leaves))


SHAPES = [(s, n) for s in ("left", "right", "balanced", "random")
          for n in (8, 64)]


def _programs(tree):
    n_leaves = tree.n_leaves
    sched = TT.reorder_schedule(tree.schedule(), n_leaves)
    arrs, n_slots, root_slot = TT.compile_register_schedule(sched, n_leaves)
    prog, slots = TT.carry_program(arrs)
    return sched, arrs, n_slots, prog, slots


def _interpret(sched, prog, n_leaves):
    """Run the program on node ids: per op, the tree nodes its operands
    hold.  Checks every read against the schedule's children."""
    lsrc, lflag, rsrc, rflag, oslot, _ = prog
    arena, last = {}, None
    for i, (parent, left, right, *_x) in enumerate(sched):
        for src, flag, child in ((lsrc[i], lflag[i], left),
                                 (rsrc[i], rflag[i], right)):
            if flag == TT.CARRIED:
                got = last
            elif flag:
                got = arena.pop(int(src))
            else:
                got = int(src)
            assert got == child, (i, src, flag, child)
        if oslot[i] >= 0:
            assert int(oslot[i]) not in arena    # a live slot is never hit
            arena[int(oslot[i])] = parent
        last = parent
    assert not arena                             # every stored CLV is read
    return last


@pytest.mark.parametrize("shape,n_leaves", SHAPES)
def test_carried_operands_are_the_op_before(shape, n_leaves):
    """Every operand flagged CARRIED is op i-1's output, and every
    operand that is op i-1's output is flagged CARRIED: a left
    caterpillar carries every left child, a right one every right child,
    a balanced tree the right child of every op with two internal
    children, a random tree both sides."""
    tree = _tree(shape, n_leaves)
    sched, _, _, prog, _ = _programs(tree)
    assert prog.shape == (6, len(sched)) and prog.dtype == np.int32
    assert _interpret(sched, prog, n_leaves) == sched[-1][0]
    parents = [e[0] for e in sched]
    carried = {0: 0, 1: 0}
    for i in range(1, len(sched)):
        for side, child in ((0, sched[i][1]), (1, sched[i][2])):
            is_prev = child == parents[i - 1]
            assert (prog[2 * side + 1, i] == TT.CARRIED) == is_prev
            carried[side] += is_prev
    assert prog[1, 0] != TT.CARRIED and prog[3, 0] != TT.CARRIED
    want = {"left": (len(sched) - 1, 0), "right": (0, len(sched) - 1),
            "balanced": (0, len(sched) - n_leaves // 2)}
    if shape in want:
        assert (carried[0], carried[1]) == want[shape]
    else:
        assert carried[0] > 0 and carried[1] > 0


@pytest.mark.parametrize("shape,n_leaves", SHAPES)
def test_only_outputs_read_later_are_stored(shape, n_leaves):
    """An op stores its output exactly when a later op other than the next
    one reads it (the root's output is never stored), and the program
    needs no more arena slots than compile_register_schedule's."""
    tree = _tree(shape, n_leaves)
    sched, arrs, n_slots, prog, slots = _programs(tree)
    pos = {e[0]: i for i, e in enumerate(sched)}
    reader = {}
    for i, (_, left, right, *_x) in enumerate(sched):
        for child in (left, right):
            if child in pos:
                reader[pos[child]] = i
    for j in range(len(sched)):
        stored = j in reader and reader[j] != j + 1
        assert (prog[4, j] >= 0) == stored, j
    assert prog[4, -1] == -1
    assert 0 <= slots <= n_slots
    assert prog[4].max(initial=-1) == slots - 1
    if shape in ("left", "right"):
        assert slots == 0            # every op carries its internal child
    # edges and tip operands as compile_register_schedule has them
    np.testing.assert_array_equal(prog[5], arrs[5])
    for side in range(2):
        tip = arrs[2 * side + 1] == 0
        np.testing.assert_array_equal(prog[2 * side][tip],
                                      arrs[2 * side][tip])
        np.testing.assert_array_equal(prog[2 * side + 1][tip], 0)


def test_carried_slots_at_real_sizes():
    """The random trees of the DNA workloads: 160 taxa need 5 slots
    carried against 6, 256 taxa 5 against 6, 1,000 taxa 7 against 8."""
    for n_leaves, seed, want in ((160, 1, (6, 5)), (256, 4, (6, 5)),
                                 (1000, 0, (8, 7))):
        tree = trt(n_leaves, seed=seed)
        _, _, n_slots, _, slots = _programs(tree)
        assert (n_slots, slots) == want


def _jax_model(tree, n_sites, seed, tip_dtype):
    rng = np.random.default_rng(seed)
    tips = rng.integers(-1, 14, size=(tree.n_leaves, n_sites))
    tips[:, 3] = -1                                      # a gap column
    cfg = PLFConfig(block_sites=128, interpret=True, tip_dtype=tip_dtype)
    return PhyloModel(tree, hky85(2.0, [0.3, 0.2, 0.3, 0.2]), tips,
                      alpha=0.6, config=cfg)


def _unpack(packed, n_edges, states=4):
    rows = packed.shape[0]
    return packed.reshape(rows, n_edges, states).permute(1, 0, 2) \
        .contiguous()


@pytest.mark.parametrize("tip_dtype", ["int32", "int8"])
@pytest.mark.parametrize("shape,n_leaves", [("left", 8), ("right", 16),
                                            ("balanced", 16),
                                            ("random", 24)])
def test_carried_plain_matches_jax(shape, n_leaves, tip_dtype):
    """The carried program run with plf_tree_torch's arithmetic (flag
    CARRIED: the last op's output; only oslot >= 0 stored; the root from
    the last op) == the uncarried plain version bit for bit, and within
    the 5e-5 relative of tests/test_torch_tree.py against JAX's dynamic
    tree kernel in interpret mode (XLA:CPU contracts its multiply-adds);
    scaler counts exact."""
    jm = _jax_model(_tree(shape, n_leaves, parse_newick, random_tree), 256,
                    n_leaves, tip_dtype)
    sched, lcs, rcs, ttab = jm._fused_inputs()
    lik_j, sc_j = JT.plf_tree_pallas_dynamic(
        jm._codes, sched, lcs, rcs, jm._ec, ttab, jm._root_rows, jm.n_sites,
        n_leaves=n_leaves, block_sites=128, interpret=True)
    t = lambda a: torch.tensor(np.asarray(a))
    E = len(sched)
    arrs, n_slots, root_slot = TT.compile_register_schedule(sched, n_leaves)
    prog, slots = TT.carry_program(arrs)
    args = (t(jm._codes), None, _unpack(t(lcs), E), _unpack(t(rcs), E),
            t(jm._ec).contiguous(), t(ttab).contiguous(),
            t(jm._root_rows).reshape(-1).contiguous(), jm.n_sites)
    plain = TT.plf_tree_torch(*args[:1], torch.as_tensor(np.stack(arrs)),
                              *args[2:], n_slots=n_slots,
                              root_slot=root_slot)
    carried = TT.plf_tree_torch(*args[:1], torch.as_tensor(prog), *args[2:],
                                n_slots=slots)
    assert torch.equal(carried[0], plain[0])
    assert torch.equal(carried[1], plain[1])
    np.testing.assert_array_equal(carried[1].numpy(), np.asarray(sc_j))
    np.testing.assert_allclose(carried[0].numpy(), np.asarray(lik_j),
                               rtol=5e-5, atol=1e-37)
