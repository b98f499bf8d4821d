"""Kernels 2 and 2m: the whole-tree forward likelihood, and its host
planners.

Replaces ``plf_tpu/ops/plf_tree_pallas.py::_tree_kernel`` (``:209``,
schedule unrolled at trace time, used for <= 96 nodes) and
``::_tree_kernel_dynamic`` (``:424``, the register machine).  One CUDA
kernel, ``csrc/plf_tree.cu``, serves both: one thread per site walks the
int32 arrays of :func:`carry_program` (the arrays of
:func:`compile_register_schedule`, with each operand that the op before
produced taken from registers and only the outputs that a later op but
the next one reads stored), expands tips on demand from their codes,
keeps those stored CLVs in a shared-memory arena, and ends with the
sequential root reduction on the root op's registers.  Device-memory traffic is
only the tip codes and 8 bytes of output per site; what bounds the
kernel is latency at the occupancy its shared-memory arena allows
(:func:`plf_tree_occupancy`; ``chip_smoke.py``'s profile phase times it at
lower occupancies).

The host planners (:func:`reorder_schedule`, :func:`schedule_depth`,
:func:`compile_register_schedule`, :func:`pack_branch_constants`) are
NumPy copies of the JAX package's, so both packages run the same ops in
the same order.

Capacity rule.  The JAX kernels fit an arena of ``n_leaves + n_slots``
CLV slots for a whole site block into ~10 MiB of TPU VMEM
(``ARENA_VMEM_BUDGET``/``fit_block_sites``, ``FUSED_MAX_LIVE``,
``FUSED_UNROLL_MAX_NODES``).  Here tips are never stored, the arena holds
``n_slots`` slots of ``S*C`` floats per site (kernel 2: the slots of
:func:`carry_program`, 5 for a random 160-taxon tree where
:func:`compile_register_schedule` has 6), and one block must fit the
card's shared memory: a block of :data:`TREE_THREADS` sites, whose arena
(plus the staged constants) must fit :data:`SMEM_BLOCK_BYTES`
(:func:`tree_fused_threads`, which kernel 7 shares for a segment arena
and its landing slots); a tree that does not fit takes the per-node
path.  At S = C = 4 that admits ``n_slots <=
28``; a random 1000-taxon tree needs well under 16.

Kernel 2m (``csrc/plf_tree_mxu.cu``) is the matrix ("MXU") form of the
same two TPU kernels (``_plf_node_mxu`` per op, ``_expand_tip(dot=)`` per
tip) for the "mxu", "mxu_3x" and "mxu_bf16" variants, and the "vpu"
variant at S != 4.  :func:`plf_tree` dispatches to it.  A block owns a
tile of :data:`TREE_MXU_SITES` = 8 sites and all ``S*C`` rows, with one
job slot of 8 threads per job of a stage, as its library decides
(:func:`tree_mxu_block`: 160 threads at S = 20, C = 4; 416 at S = 61,
whose jobs take 5 output rows), so that every stage runs its jobs in one
round; its capacity rule (:func:`tree_mxu_fits`) admits a tree whose
``n_slots + 3`` tiles fit shared memory; a tree that does not fit takes
the per-node path.  At S = 20, C = 4 with all 24 tip codes that admits
``n_slots <= 84``.  Narrow tiles leave room for more resident blocks
(``PERF.md`` records 8-, 16- and 32-site tiles on the card).

Both kernels take a candidate axis (:func:`plf_tree_batch`, the grid's
second dimension): a tree search scores a whole neighbourhood over one
alignment in one launch, each candidate with its own program and output
row, all sharing the codes, the tip table and one operator table that the
programs' ``eidx`` rows index.  It replaces ``plf_tpu/ops/
plf_tree_pallas.py::batched_tree_loglik_parts`` (``:628``, a ``lax.map``
of ``_tree_kernel_dynamic`` over the candidates); the per-site arithmetic
is the single-tree kernels', which are batches of one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import layout as L
from .plf_mxu import MODES, node_mxu_plain, node_planes, uses_mxu_kernels
from .plf_node import SMEM_BLOCK_BYTES

__all__ = ["plf_tree", "plf_tree_torch", "plf_tree_occupancy", "root_reduce",
           "reorder_schedule", "schedule_depth", "compile_register_schedule",
           "carry_program", "CARRIED", "tree_plan", "tree_fused_threads",
           "tree_fused_smem_bytes",
           "pack_branch_constants", "tree_smem_bytes",
           "SMEM_BLOCK_BYTES", "TREE_THREADS", "plf_tree_mxu",
           "plf_tree_mxu_occupancy", "tree_mxu_fits", "tree_mxu_smem_bytes",
           "tree_mxu_block", "TREE_MXU_SITES", "tree_mxu_plan",
           "plf_tree_batch", "plf_tree_mxu_batch", "plf_tree_batch_torch",
           "batched_tree_loglik_parts", "MAX_BATCH"]

#: Sites per block of the tree kernel (one a thread: :func:`tree_plan`),
#: four warps, which leaves room for several blocks per SM at the arena
#: sizes of real trees.
TREE_THREADS = 128


def tree_smem_bytes(n_slots: int, rows: int, n_codes: int, threads: int,
                    states: int = 4) -> int:
    """Dynamic shared memory of one tree-kernel block: the EV constants,
    tip table and root row vector, plus the ``n_slots`` x ``rows`` x
    ``threads`` fp32 arena."""
    return 4 * (rows * states + rows * n_codes + rows
                + n_slots * rows * threads)


def tree_fused_smem_bytes(n_slots: int, rows: int, n_codes: int,
                          states: int = 4) -> int:
    """Dynamic shared memory of one kernel-2 (or kernel-7) block of
    :data:`TREE_THREADS` sites: :func:`tree_smem_bytes` plus two buffers
    of one op's ``lc`` and ``rc`` rows, into which the kernel copies the
    next op's operators while it computes."""
    return (tree_smem_bytes(n_slots, rows, n_codes, TREE_THREADS, states)
            + 4 * 4 * rows * states)


def tree_fused_threads(n_slots: int, rows: int, n_codes: int,
                       states: int = 4) -> Optional[int]:
    """Kernel 2's capacity rule, and kernel 7's for a segment arena:
    :data:`TREE_THREADS` sites a block if its ``n_slots``-slot arena (the
    slots of :func:`carry_program`, or of
    :func:`.plf_tree_seg.carry_segment_program` with kernel 7's landing
    slots) fits
    :data:`SMEM_BLOCK_BYTES`, or None if the tree does not fuse."""
    if tree_fused_smem_bytes(n_slots, rows, n_codes, states) \
            <= SMEM_BLOCK_BYTES:
        return TREE_THREADS
    return None


#: Sites per block of kernel 2m (``kSites`` in ``csrc/plf_tree_mxu.cu``).
TREE_MXU_SITES = 8


def tree_mxu_smem_bytes(n_slots: int, rows: int, n_codes: int) -> int:
    """Dynamic shared memory of one kernel-2m block: the tip table and
    root row vector, two int arrays of :data:`TREE_MXU_SITES`, and
    ``n_slots + 3`` ``rows x TREE_MXU_SITES`` fp32 tiles (the arena, two
    tip operands, the stage-2 products)."""
    return 4 * (rows * n_codes + rows + 2 * TREE_MXU_SITES
                + (n_slots + 3) * rows * TREE_MXU_SITES)


def tree_mxu_fits(n_slots: int, rows: int, n_codes: int) -> bool:
    """Whether a kernel-2m block fits :data:`SMEM_BLOCK_BYTES` (else the
    tree does not fuse)."""
    return tree_mxu_smem_bytes(n_slots, rows, n_codes) <= SMEM_BLOCK_BYTES


# ---------------------------------------------------------------- planners --


def reorder_schedule(schedule: Sequence[Tuple], n_leaves: int
                     ) -> List[Tuple]:
    """Reorder a post-order schedule taller-child-first (Sethi-Ullman).

    Returns an equivalent post-order schedule that minimises the peak
    number of live intermediate CLVs.  Entries are (parent, left, right,
    t_left, t_right) as produced by Tree.schedule(); the edge index (the
    position in the ORIGINAL schedule) is appended as a 6th field so
    branch constants stay aligned.
    """
    children = {p: (l, r, tl, tr, e)
                for e, (p, l, r, tl, tr) in enumerate(schedule)}
    height: dict = {}
    for (p, l, r, _tl, _tr) in schedule:
        height[p] = 1 + max(height.get(l, 0), height.get(r, 0))

    out: List[Tuple] = []
    root = schedule[-1][0]
    stack = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if node not in children:
            continue
        l, r, tl, tr, e = children[node]
        if expanded:
            out.append((node, l, r, tl, tr, e))
        else:
            stack.append((node, True))
            if height.get(l, 0) >= height.get(r, 0):
                stack.append((r, False))
                stack.append((l, False))
            else:
                stack.append((l, False))
                stack.append((r, False))
    assert len(out) == len(schedule)
    return out


def schedule_depth(schedule: Sequence[Tuple], n_leaves: int) -> int:
    """Peak live-CLV count of the (reordered) schedule."""
    live = set()
    peak = 0
    for entry in schedule:
        parent, l, r = entry[0], entry[1], entry[2]
        live.discard(l)
        live.discard(r)
        live.add(parent)
        peak = max(peak, len(live) + 1)  # +1 for in-flight temporaries
    return peak


def compile_register_schedule(schedule: Sequence[Tuple], n_leaves: int):
    """Lower a (reordered) schedule to register-machine arrays.

    Returns ``((lsrc, lflag, rsrc, rflag, oslot, edge), n_slots,
    root_slot)``: int32 arrays of length E.  flag 0 means the operand is
    leaf code row ``src``; flag 1 means arena slot ``src``.  ``edge`` is
    the original edge index (for branch-constant lookup).  Slots are
    freed right after use, so an op's output may reuse an operand's slot.
    """
    slot_of = {}
    free: List[int] = []
    n_slots = 0
    lsrc, lflag, rsrc, rflag, oslot, eidx = [], [], [], [], [], []

    def operand(node):
        if node < n_leaves:
            return node, 0
        return slot_of[node], 1

    def release(node):
        if node >= n_leaves:
            free.append(slot_of.pop(node))

    def alloc():
        nonlocal n_slots
        if free:
            return free.pop()
        n_slots += 1
        return n_slots - 1

    for entry in schedule:
        parent, l, r, e = entry[0], entry[1], entry[2], entry[5]
        ls, lf = operand(l)
        rs, rf = operand(r)
        release(l)
        release(r)
        out = alloc()
        slot_of[parent] = out
        lsrc.append(ls)
        lflag.append(lf)
        rsrc.append(rs)
        rflag.append(rf)
        oslot.append(out)
        eidx.append(e)
    root_slot = oslot[-1]
    arrs = tuple(np.asarray(a, np.int32)
                 for a in (lsrc, lflag, rsrc, rflag, oslot, eidx))
    return arrs, n_slots, root_slot


#: Operand flag of :func:`carry_program`: the output of the op evaluated
#: just before (flag 0 is a tip, 1 an arena slot).
CARRIED = 2


def carry_program(arrs) -> Tuple[np.ndarray, int]:
    """Kernel 2's program from the arrays of
    :func:`compile_register_schedule` ``(lsrc, lflag, rsrc, rflag, oslot,
    edge)``.

    An operand that op ``i - 1`` produced gets flag :data:`CARRIED` (the
    kernel keeps it in registers); op ``j``'s output gets an arena slot
    only when a later op other than ``j + 1`` reads it, else ``oslot`` -1
    (the root op's output too: the root reduction reads it from
    registers).  Slots are allocated as in
    :func:`compile_register_schedule`, freed when read, so there are never
    more.  Returns ``((6, E) int32, n_slots)``.
    """
    lsrc, lflag, rsrc, rflag, oslot, eidx = (np.asarray(a) for a in arrs)
    E = len(eidx)
    producer = {}   # arena slot -> the op whose output it holds
    src_op = np.full((2, E), -1)
    for i in range(E):
        for side, (src, flag) in enumerate(((lsrc[i], lflag[i]),
                                            (rsrc[i], rflag[i]))):
            if flag:
                src_op[side, i] = producer[int(src)]
        producer[int(oslot[i])] = i
    reader = np.full(E, -1)
    for side in range(2):
        for i in np.flatnonzero(src_op[side] >= 0):
            reader[src_op[side, i]] = i
    stored = (reader >= 0) & (reader != np.arange(E) + 1)
    prog = np.stack([lsrc, lflag, rsrc, rflag, np.full(E, -1), eidx]
                    ).astype(np.int32)
    slot_of, free, n_slots = {}, [], 0
    for i in range(E):
        for side in range(2):
            j = src_op[side, i]
            if j < 0:
                continue
            if stored[j]:
                prog[2 * side, i] = slot_of[j]
                free.append(slot_of.pop(j))
            else:
                prog[2 * side, i], prog[2 * side + 1, i] = 0, CARRIED
        if stored[i]:
            if free:
                slot_of[i] = free.pop()
            else:
                slot_of[i], n_slots = n_slots, n_slots + 1
            prog[4, i] = slot_of[i]
    return prog, n_slots


def pack_branch_constants(branches, states: int = 4, categories: int = 4):
    """Stack per-edge branch constants lane-dense: (rows, E*S); column
    ``e*S + a`` is ``layout.branch_to_lane_constants(branch_e)[:, a]``."""
    cols = [L.branch_to_lane_constants(np.asarray(b), states, categories)
            for b in branches]
    return np.concatenate(cols, axis=1).astype(np.float32)


# ------------------------------------------------------- plain and kernel --


def root_reduce(rr, x):
    """Site likelihoods ``rr[0]*x[0] + rr[1]*x[1] + ...`` of a lane-major
    root CLV ``x`` ``(rows, n)``: separately rounded fp32 products and
    sums in row order, as kernel 2 does (no matmul, so no global
    precision setting changes the result)."""
    lik = rr[0] * x[0]
    for r in range(1, x.shape[0]):
        lik = lik + rr[r] * x[r]
    return lik


def plf_tree_torch(codes, sched, lcs, rcs, ec, ttab, rr, n: int, *,
                   n_slots: int, root_slot: Optional[int] = None,
                   states: int = 4, categories: int = 4,
                   variant: str = "vpu", planes=None):
    """Plain version of kernels 2 and 2m (same arguments and results as
    :func:`plf_tree`), on the device of its inputs, in the kernels' op
    order: tips as table columns, :func:`plf_mxu.node_mxu_plain` per op
    (in fp32 mode it is :func:`plf_node.node_plain`), a sequential root
    reduction of the last op's output (the root; ``root_slot`` holds it
    in a schedule of :func:`compile_register_schedule`).  ``sched`` may
    also be a program of :func:`carry_program` (flag :data:`CARRIED`,
    ``oslot`` -1), interpreted as kernel 2 runs it."""
    pl = None if planes is None else node_planes(lcs, rcs, ec, variant,
                                                 planes)
    n_pad = codes.shape[-1]
    valid = torch.arange(n_pad, device=codes.device) < n
    lsrc, lflag, rsrc, rflag, oslot, eidx = sched.cpu().tolist()
    arena: List[Optional[torch.Tensor]] = [None] * n_slots
    x3 = None

    def operand(src, flag):
        if flag == CARRIED:
            return x3
        if flag:
            return arena[src]
        return ttab[:, codes[src].long()]

    scaler = torch.zeros(n_pad, dtype=torch.int32, device=codes.device)
    for i in range(len(eidx)):
        e = eidx[i]
        x3, mask = node_mxu_plain(
            operand(lsrc[i], lflag[i]), operand(rsrc[i], rflag[i]), lcs[e],
            rcs[e], ec, valid, states, categories, variant,
            None if pl is None else (pl[0][e], pl[1][e], pl[2][e], pl[3][e],
                                     pl[4], pl[5]))
        if oslot[i] >= 0:
            arena[oslot[i]] = x3
        scaler += mask.to(torch.int32)
    return root_reduce(rr, x3)[None, :], scaler[None, :]


def _check_operands(codes, lcs, rcs, ec, ttab, rr, states, categories,
                    n_ops):
    """Types, shapes and device of the arrays every tree launch takes;
    ``lcs``/``rcs`` are ``(n_ops, S*C, S)``."""
    rows = states * categories
    if codes.dim() != 2 or codes.dtype not in (torch.int32, torch.int8):
        raise TypeError("codes must be (n_leaves, n_pad) int32 or int8")
    for name, t, shape in (("lcs", lcs, (n_ops, rows, states)),
                           ("rcs", rcs, (n_ops, rows, states)),
                           ("ec", ec, (rows, states)),
                           ("rr", rr, (rows,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if ttab.dim() != 2 or ttab.shape[0] != rows \
            or ttab.dtype != torch.float32:
        raise ValueError(f"ttab must be ({rows}, n_codes) float32")
    if any(t.device != codes.device for t in (lcs, rcs, ec, ttab, rr)):
        raise ValueError("plf_tree: all tensors must be on one device")


def _check(codes, sched, lcs, rcs, ec, ttab, rr, n_slots, root_slot,
           states, categories):
    E = lcs.shape[0]
    _check_operands(codes, lcs, rcs, ec, ttab, rr, states, categories, E)
    if tuple(sched.shape) != (6, E) or sched.dtype != torch.int32:
        raise ValueError(f"sched must be (6, {E}) int32, got "
                         f"{tuple(sched.shape)} {sched.dtype}")
    if sched.device != codes.device:
        raise ValueError("plf_tree: all tensors must be on one device")
    if not 0 <= root_slot < n_slots:
        raise ValueError(f"root_slot {root_slot} outside {n_slots} slots")


def _check_batch(codes, progs, lcs, rcs, ec, ttab, rr, states, categories):
    """The checks of :func:`plf_tree_batch`: ``progs`` ``(B, 6, E)`` int32
    on the device of ``codes``, one contiguous program per candidate, and
    an operator table ``lcs``/``rcs`` of any length."""
    _check_operands(codes, lcs, rcs, ec, ttab, rr, states, categories,
                    lcs.shape[0])
    if progs.dim() != 3 or progs.shape[1] != 6 or progs.shape[0] < 1 \
            or progs.dtype != torch.int32 or not progs.is_contiguous():
        raise ValueError(f"progs must be a contiguous (B, 6, E) int32 "
                         f"tensor, got {tuple(progs.shape)} {progs.dtype}")
    if progs.device != codes.device:
        raise ValueError("plf_tree: all tensors must be on one device")
    if progs.shape[0] > MAX_BATCH:
        raise ValueError(f"a batch of {progs.shape[0]} candidates exceeds "
                         f"the launch's {MAX_BATCH}")


@functools.cache
def _lib():
    """Build (first use) and load csrc/plf_tree.cu, with its C prototypes."""
    from ._build import load_library
    lib = load_library("plf_tree")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.plf_tree_launch.argtypes = [
        vp, ci, vp, ci, vp, vp, vp, vp, ci, vp, ci, vp, vp, ci, ci, ci, ci,
        ci, vp]
    lib.plf_tree_launch.restype = ci
    lib.plf_tree_occupancy.argtypes = [ci, ci, ci, ci, ci,
                                       ctypes.POINTER(ci)]
    lib.plf_tree_occupancy.restype = ci
    lib.plf_tree_plan.argtypes = [ci] * 6 + [ctypes.POINTER(ci)] * 5
    lib.plf_tree_plan.restype = ci
    lib.plf_error_string.argtypes = [ci]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


def _program(program, sched, E, device):
    """Kernel 2's ``(program, n_slots)``: ``program`` as given (checked),
    or :func:`carry_program` of ``sched`` (read back from the device)."""
    if program is None:
        prog, n_slots = carry_program(sched.cpu().numpy())
        return torch.as_tensor(prog, device=device), n_slots
    prog, n_slots = program
    if tuple(prog.shape) != (6, E) or prog.dtype != torch.int32 \
            or prog.device != device or not prog.is_contiguous():
        raise ValueError(f"program must be a contiguous (6, {E}) int32 "
                         f"tensor on {device}, got {tuple(prog.shape)} "
                         f"{prog.dtype} on {prog.device}")
    return prog, int(n_slots)


def plf_tree(codes, sched, lcs, rcs, ec, ttab, rr, n: int, *, n_slots: int,
             root_slot: int, states: int = 4, categories: int = 4,
             variant: str = "vpu", planes=None, program=None):
    """Fused whole-tree likelihood on register-machine arrays.

    Args:
      codes: ``(n_leaves, n_pad)`` int32 or int8 tip-table column codes
        (padding sites hold the gap code).
      sched: ``(6, E)`` int32 rows lsrc, lflag, rsrc, rflag, oslot, edge
        (:func:`compile_register_schedule`; kernel 2m reduces the last
        op's ``oslot``, which is ``root_slot``).
      lcs, rcs: ``(E, S*C, S)`` fp32 per-edge branch constants, indexed
        by original edge.
      ec: ``(S*C, S)`` eigenvector constants; ttab: ``(S*C, n_codes)`` tip
        table per lane-major row; rr: ``(S*C,)`` root row vector.
      n: valid site count.
      variant: the kernel form; "vpu" at S = 4 runs kernel 2, anything
        else kernel 2m (:func:`plf_tree_mxu`), whose tip table the caller
        rounds (:func:`plf_mxu.round_tip_table`).
      planes: kernel 2m only: ``lcs``/``rcs``/``ec`` already split for
        ``variant`` (:func:`plf_mxu.node_planes`).
      program: kernel 2 only: ``(prog, n_slots)``, :func:`carry_program`
        of ``sched`` with ``prog`` on the device of ``codes`` (a caller
        that evaluates one tree again and again builds it once, as
        ``PhyloModel`` does); derived from ``sched`` when None, which
        reads ``sched`` back to the host.

    Returns:
      ``(site_lik, scaler_counts)``: ``(1, n_pad)`` fp32 and int32.
    """
    if uses_mxu_kernels(variant, states):
        return plf_tree_mxu(codes, sched, lcs, rcs, ec, ttab, rr, n,
                            n_slots=n_slots, root_slot=root_slot,
                            states=states, categories=categories,
                            variant=variant, planes=planes)
    if planes is not None:
        raise ValueError("plf_tree: planes are for the matrix-form kernel")
    _check(codes, sched, lcs, rcs, ec, ttab, rr, n_slots, root_slot,
           states, categories)
    if codes.device.type == "cpu":
        return plf_tree_torch(codes, sched, lcs, rcs, ec, ttab, rr, n,
                              n_slots=n_slots, root_slot=root_slot,
                              states=states, categories=categories)
    if codes.device.type != "cuda":
        raise ValueError(f"plf_tree: no kernel for device {codes.device}")
    prog, slots = _program(program, sched, lcs.shape[0], codes.device)
    lik, sc = _launch_tree(codes, prog[None], lcs, rcs, ec, ttab, rr, n,
                           slots, states, categories)
    plf_tree.launches += 1
    return lik, sc


def _launch_tree(codes, progs, lcs, rcs, ec, ttab, rr, n, slots, states,
                 categories):
    """One kernel-2 launch over the ``(B, 6, E)`` programs ``progs``:
    ``(B, n_pad)`` likelihoods and scaler counts."""
    if states != 4 or not 1 <= categories <= 8:
        raise ValueError("the CUDA tree kernel takes S = 4 and C in 1..8, "
                         f"got S={states}, C={categories}")
    ts = (codes, progs, lcs, rcs, ec, ttab, rr)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("plf_tree: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (lcs, rcs, ec)):
        raise ValueError("plf_tree: lcs/rcs/ec must be 16-byte aligned")
    rows = states * categories
    n_codes = ttab.shape[1]
    block_sites = tree_fused_threads(slots, rows, n_codes, states)
    if block_sites is None:
        raise ValueError(
            f"plf_tree: a {slots}-slot arena of {rows} rows does not fit "
            f"{SMEM_BLOCK_BYTES} bytes of shared memory at {TREE_THREADS} "
            f"sites; use the per-node path")
    n_pad = codes.shape[-1]
    if not 0 <= n <= n_pad or n_pad == 0 or n_pad >= 2 ** 31:
        raise ValueError(f"plf_tree: bad n={n} for n_pad={n_pad}")
    lib = _lib()
    B, E = progs.shape[0], progs.shape[2]
    lik = torch.empty((B, n_pad), dtype=torch.float32, device=codes.device)
    sc = torch.empty((B, n_pad), dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.plf_tree_launch(
            codes.data_ptr(), codes.element_size(), progs.data_ptr(), E,
            lcs.data_ptr(), rcs.data_ptr(), ec.data_ptr(), ttab.data_ptr(),
            n_codes, rr.data_ptr(), slots, lik.data_ptr(), sc.data_ptr(),
            int(n), n_pad, categories, block_sites, B, stream)
    if err != 0:
        raise RuntimeError(f"plf_tree kernel launch failed: "
                           f"{lib.plf_error_string(err).decode()}")
    return lik, sc


plf_tree.launches = 0


def plf_tree_occupancy(code_dtype: torch.dtype, categories: int,
                       n_codes: int, n_slots: int) -> int:
    """Thread blocks of :func:`plf_tree` resident on one SM for an arena
    of ``n_slots`` slots (the program's: :func:`carry_program`), as the
    CUDA runtime computes it (registers and shared memory); builds the
    kernel on first use and needs a CUDA device."""
    code_bytes = {torch.int32: 4, torch.int8: 1}[code_dtype]
    lib = _lib()
    blocks = ctypes.c_int(0)
    err = lib.plf_tree_occupancy(code_bytes, categories, n_codes, n_slots,
                                 TREE_THREADS, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"plf_tree occupancy query failed: "
                           f"{lib.plf_error_string(err).decode()}")
    return blocks.value


def tree_plan(code_dtype: torch.dtype, categories: int, n_codes: int,
              n_slots: int, n_pad: int = TREE_THREADS,
              batch: int = 1) -> dict:
    """Kernel 2's launch for an arena of ``n_slots`` slots and ``batch``
    candidates of ``n_pad`` sites: ``sites`` per block
    (:data:`TREE_THREADS`), and as its library decides them
    (``plf_tree_plan``) ``threads`` per block, ``sites_per_thread``,
    dynamic ``smem_bytes`` (:func:`tree_fused_smem_bytes` restates them)
    and the ``grid`` (site blocks, candidates); the arena ``slots`` and
    ``blocks_per_sm`` (:func:`plf_tree_occupancy`).  Needs a CUDA
    device."""
    lib = _lib()
    threads, per, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    gx, gy = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.plf_tree_plan(categories, n_codes, n_slots, TREE_THREADS,
                            n_pad, batch, ctypes.byref(threads),
                            ctypes.byref(per), ctypes.byref(smem),
                            ctypes.byref(gx), ctypes.byref(gy))
    if err != 0:
        raise RuntimeError(f"plf_tree plan query failed: "
                           f"{lib.plf_error_string(err).decode()}")
    return dict(sites=TREE_THREADS, threads=threads.value,
                sites_per_thread=per.value, slots=n_slots,
                smem_bytes=smem.value, grid=(gx.value, gy.value),
                blocks_per_sm=plf_tree_occupancy(code_dtype, categories,
                                                 n_codes, n_slots))


# ------------------------------------------------------------ kernel 2m --


@functools.cache
def _lib_mxu():
    """Build (first use) and load csrc/plf_tree_mxu.cu, with its C
    prototypes."""
    from ._build import load_library
    lib = load_library("plf_tree_mxu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.plf_tree_mxu_launch.argtypes = [
        vp, ci, vp, ci, vp, vp, vp, vp, vp, vp, vp, ci, vp, ci, vp, vp, ci,
        ci, ci, ci, ci, ci, vp]
    lib.plf_tree_mxu_launch.restype = ci
    lib.plf_tree_mxu_occupancy.argtypes = [ci] * 6 + [ctypes.POINTER(ci)]
    lib.plf_tree_mxu_occupancy.restype = ci
    lib.plf_tree_mxu_block.argtypes = [ci] * 2 + [ctypes.POINTER(ci)] * 2
    lib.plf_tree_mxu_block.restype = ci
    lib.plf_error_string.argtypes = [ci]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


def plf_tree_mxu(codes, sched, lcs, rcs, ec, ttab, rr, n: int, *,
                 n_slots: int, root_slot: int, states: int = 20,
                 categories: int = 4, variant: str = "mxu_3x", planes=None):
    """Kernel 2m: :func:`plf_tree` in the arithmetic of ``variant`` (any
    key of :data:`plf_mxu.MODES`), at any S.  Same arguments and results
    as :func:`plf_tree`; ``ttab`` is taken as given (an exact column
    select), so the caller passes the variant's rounded tip table."""
    if variant not in MODES:
        raise ValueError(f"unknown kernel variant {variant!r}")
    _check(codes, sched, lcs, rcs, ec, ttab, rr, n_slots, root_slot,
           states, categories)
    if codes.device.type == "cpu":
        return plf_tree_torch(codes, sched, lcs, rcs, ec, ttab, rr, n,
                              n_slots=n_slots, root_slot=root_slot,
                              states=states, categories=categories,
                              variant=variant, planes=planes)
    if codes.device.type != "cuda":
        raise ValueError(f"plf_tree_mxu: no kernel for device {codes.device}")
    lik, sc = _launch_tree_mxu(codes, sched[None], lcs, rcs, ec, ttab, rr, n,
                               n_slots, states, categories, variant, planes)
    plf_tree_mxu.launches += 1
    return lik, sc


def _launch_tree_mxu(codes, scheds, lcs, rcs, ec, ttab, rr, n, n_slots,
                     states, categories, variant, planes):
    """One kernel-2m launch over the ``(B, 6, E)`` schedules ``scheds``:
    ``(B, n_pad)`` likelihoods and scaler counts."""
    ts = (codes, scheds, lcs, rcs, ec, ttab, rr)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("plf_tree_mxu: tensors must be contiguous")
    rows = states * categories
    n_codes = ttab.shape[1]
    if not tree_mxu_fits(n_slots, rows, n_codes):
        raise ValueError(
            f"plf_tree_mxu: a {n_slots}-slot arena of {rows} rows does not "
            f"fit {SMEM_BLOCK_BYTES} bytes of shared memory at "
            f"{TREE_MXU_SITES} sites; use the per-node path")
    n_pad = codes.shape[-1]
    if not 0 <= n <= n_pad or n_pad == 0 or n_pad >= 2 ** 31:
        raise ValueError(f"plf_tree_mxu: bad n={n} for n_pad={n_pad}")
    planes = [p.contiguous()
              for p in node_planes(lcs, rcs, ec, variant, planes)]
    if states % 4 == 0 and any(p.data_ptr() % 16 for p in planes):
        raise ValueError("plf_tree_mxu: lcs/rcs/ec must be 16-byte aligned")
    lib = _lib_mxu()
    B, E = scheds.shape[0], scheds.shape[2]
    lik = torch.empty((B, n_pad), dtype=torch.float32, device=codes.device)
    sc = torch.empty((B, n_pad), dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.plf_tree_mxu_launch(
            codes.data_ptr(), codes.element_size(), scheds.data_ptr(), E,
            *(p.data_ptr() for p in planes), ttab.data_ptr(), n_codes,
            rr.data_ptr(), n_slots, lik.data_ptr(), sc.data_ptr(), int(n),
            n_pad, states, categories, MODES[variant], B, stream)
    if err != 0:
        raise RuntimeError(f"plf_tree_mxu kernel launch failed: "
                           f"{lib.plf_error_string(err).decode()}")
    return lik, sc


plf_tree_mxu.launches = 0


def plf_tree_mxu_occupancy(code_dtype: torch.dtype, states: int,
                           categories: int, n_codes: int, n_slots: int,
                           variant: str) -> int:
    """Thread blocks of :func:`plf_tree_mxu` (of :func:`tree_mxu_block`'s
    threads) resident on one SM for this tree shape, as the CUDA runtime
    computes it; builds the kernel on first use and needs a CUDA device."""
    code_bytes = {torch.int32: 4, torch.int8: 1}[code_dtype]
    if not tree_mxu_fits(n_slots, states * categories, n_codes):
        raise ValueError(f"a {n_slots}-slot arena does not fit")
    lib = _lib_mxu()
    blocks = ctypes.c_int(0)
    err = lib.plf_tree_mxu_occupancy(code_bytes, states, categories, n_codes,
                                     n_slots, MODES[variant],
                                     ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"plf_tree_mxu occupancy query failed: "
                           f"{lib.plf_error_string(err).decode()}")
    return blocks.value


def tree_mxu_block(states: int, categories: int) -> Tuple[int, int]:
    """``(threads, rows)`` of kernel 2m at this state and category count,
    as its library decides them (``plf_tree_mxu_block``): threads per
    block, one job slot of :data:`TREE_MXU_SITES` threads per job of a
    stage in the fewest rounds of at most 64 jobs, and output rows per
    job (4 where S % 4 == 0, else 5).  Builds the kernel on first use."""
    lib = _lib_mxu()
    threads, rows = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.plf_tree_mxu_block(states, categories, ctypes.byref(threads),
                                 ctypes.byref(rows))
    if err != 0:
        raise RuntimeError(f"plf_tree_mxu block query failed: "
                           f"{lib.plf_error_string(err).decode()}")
    return threads.value, rows.value


def tree_mxu_plan(code_dtype: torch.dtype, states: int, categories: int,
                  n_codes: int, n_slots: int, variant: str,
                  n_pad: int = TREE_MXU_SITES, batch: int = 1) -> dict:
    """Kernel 2m's launch for ``batch`` candidates of ``n_pad`` sites:
    ``sites`` per block (:data:`TREE_MXU_SITES`), ``threads`` and output
    ``rows`` per job (:func:`tree_mxu_block`), ``blocks_per_sm``
    (:func:`plf_tree_mxu_occupancy`) and the ``grid`` (site tiles,
    candidates).  Needs a CUDA device."""
    threads, rows = tree_mxu_block(states, categories)
    return dict(sites=TREE_MXU_SITES, threads=threads, rows=rows,
                slots=n_slots,
                smem_bytes=tree_mxu_smem_bytes(n_slots, states * categories,
                                               n_codes),
                grid=(-(-n_pad // TREE_MXU_SITES), batch),
                blocks_per_sm=plf_tree_mxu_occupancy(
                    code_dtype, states, categories, n_codes, n_slots,
                    variant))


# ------------------------------------------------------- candidate axis --

#: Most candidates one batched launch takes (the grid's y extent).
MAX_BATCH = 65535

#: log(2^-32), the log-likelihood of one rescale.
LOG_MINLIK = float(np.log(np.float64(2.0) ** -32))

#: Site-likelihood floor before the log (a normal fp32 value, as in the
#: JAX package; exact paths never go below it).
LIK_FLOOR = 1.1754944e-38


def plf_tree_batch_torch(codes, progs, lcs, rcs, ec, ttab, rr, n: int, *,
                         n_slots: int, states: int = 4, categories: int = 4,
                         variant: str = "vpu", planes=None):
    """Plain version of :func:`plf_tree_batch`: :func:`plf_tree_torch` on
    each candidate's program in turn (same arguments and results)."""
    outs = [plf_tree_torch(codes, prog, lcs, rcs, ec, ttab, rr, n,
                           n_slots=n_slots, states=states,
                           categories=categories, variant=variant,
                           planes=planes)
            for prog in progs]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def plf_tree_batch(codes, progs, lcs, rcs, ec, ttab, rr, n: int, *,
                   n_slots: int, states: int = 4, categories: int = 4,
                   variant: str = "vpu", planes=None):
    """Kernels 2 and 2m with a candidate axis: many trees over one
    alignment in ONE launch (the tree-search neighbourhood).

    Args:
      codes, ec, ttab, rr, n: as :func:`plf_tree`, shared by every
        candidate.
      progs: ``(B, 6, E)`` int32, one program per candidate: a
        :func:`carry_program` for kernel 2 ("vpu" at S = 4), a
        :func:`compile_register_schedule` schedule for kernel 2m (every
        other form), whose last op's ``oslot`` is the root's slot.  Row 5
        (``eidx``) indexes the operator table.
      lcs, rcs: ``(P, S*C, S)`` fp32 operator table: op ``i`` of a
        candidate reads ``lcs[eidx[i]]`` and ``rcs[eidx[i]]``.
      n_slots: the largest arena of the programs (the launch's).
      variant, planes: as :func:`plf_tree` (planes shaped as the table).

    Returns:
      ``(site_lik, scaler_counts)``: ``(B, n_pad)`` fp32 and int32; row
      ``b`` equals :func:`plf_tree` on candidate ``b`` bit for bit.
    """
    if uses_mxu_kernels(variant, states):
        return plf_tree_mxu_batch(codes, progs, lcs, rcs, ec, ttab, rr, n,
                                  n_slots=n_slots, states=states,
                                  categories=categories, variant=variant,
                                  planes=planes)
    if planes is not None:
        raise ValueError("plf_tree: planes are for the matrix-form kernel")
    _check_batch(codes, progs, lcs, rcs, ec, ttab, rr, states, categories)
    if codes.device.type == "cpu":
        return plf_tree_batch_torch(codes, progs, lcs, rcs, ec, ttab, rr, n,
                                    n_slots=n_slots, states=states,
                                    categories=categories)
    if codes.device.type != "cuda":
        raise ValueError(f"plf_tree: no kernel for device {codes.device}")
    lik, sc = _launch_tree(codes, progs, lcs, rcs, ec, ttab, rr, n, n_slots,
                           states, categories)
    plf_tree_batch.launches += 1
    return lik, sc


plf_tree_batch.launches = 0


def plf_tree_mxu_batch(codes, progs, lcs, rcs, ec, ttab, rr, n: int, *,
                       n_slots: int, states: int = 20, categories: int = 4,
                       variant: str = "mxu_3x", planes=None):
    """Kernel 2m with a candidate axis: :func:`plf_tree_batch` in the
    arithmetic of ``variant`` (any key of :data:`plf_mxu.MODES`)."""
    if variant not in MODES:
        raise ValueError(f"unknown kernel variant {variant!r}")
    _check_batch(codes, progs, lcs, rcs, ec, ttab, rr, states, categories)
    if codes.device.type == "cpu":
        return plf_tree_batch_torch(codes, progs, lcs, rcs, ec, ttab, rr, n,
                                    n_slots=n_slots, states=states,
                                    categories=categories, variant=variant,
                                    planes=planes)
    if codes.device.type != "cuda":
        raise ValueError(f"plf_tree_mxu: no kernel for device {codes.device}")
    lik, sc = _launch_tree_mxu(codes, progs, lcs, rcs, ec, ttab, rr, n,
                               n_slots, states, categories, variant, planes)
    plf_tree_mxu_batch.launches += 1
    return lik, sc


plf_tree_mxu_batch.launches = 0


def batched_tree_loglik_parts(codes, progs, lcs, rcs, ec, ttab, rr, wpad,
                              n: int, *, n_slots: int, states: int = 4,
                              categories: int = 4, variant: str = "vpu",
                              planes=None, n_parts: int = 64):
    """Score a batch of same-shape topologies in ONE launch
    (:func:`plf_tree_batch`) and reduce each candidate's sites to
    ``(B, n_parts)`` fp32 partial sums of the weighted per-site
    log-likelihood, rescale counts folded in, over equal chunks of sites
    (the JAX package's epilogue, ``plf_tree_pallas.py:656-662``, as torch
    ops on the device); sum them in float64 on the host for each
    candidate's log-likelihood.
    Counterpart of ``plf_tpu/ops/plf_tree_pallas.py::
    batched_tree_loglik_parts`` (``:628``); ``wpad`` is the ``(n_pad,)``
    fp32 site weights."""
    B, n_pad = progs.shape[0], codes.shape[-1]
    if n_parts < 1 or n_pad % n_parts:
        raise ValueError(f"n_parts {n_parts} does not divide {n_pad} sites")
    lik, sc = plf_tree_batch(codes, progs, lcs, rcs, ec, ttab, rr, n,
                             n_slots=n_slots, states=states,
                             categories=categories, variant=variant,
                             planes=planes)
    site = (torch.log(torch.clamp_min(lik, LIK_FLOOR))
            + sc.to(torch.float32) * LOG_MINLIK) * wpad
    return site.reshape(B, n_parts, n_pad // n_parts).sum(dim=-1)
