"""Kernels 7 and 8: the segmented whole-tree forward and backward.

Counterpart of ``plf_tpu/ops/plf_tree_seg.py``, "vpu" form at S = 4.
Replaces ``_seg_fwd_kernel`` (``plf_tree_seg.py:383``, launched by
``_seg_fwd_call`` ``:591``) with ``csrc/plf_tree_seg.cu`` and
``_seg_bwd_kernel`` (``:843``, ``_seg_bwd_call`` ``:1095``) with
``csrc/plf_tree_seg_bwd.cu``.

The reordered schedule is contracted bottom-up into segments, each a
subtree of at most ``cap_ops`` ops whose inputs are tips or the roots of
earlier segments (boundary CLVs); the planner (:class:`Segment`,
:class:`SegPlan`, :func:`plan_segments`, :func:`_plan_with_cap`,
:func:`_stacked_plan`) is a NumPy copy of the JAX package's, so both
packages cut a tree into the same segments.

* Kernel 7: one thread per site walks every segment in order, as kernel 2
  walks the whole tree: tips expanded on demand from their codes, boundary
  CLVs read from the boundary buffer ``bbuf`` ``(n_boundaries, S*C,
  n_pad)``, each segment's ops in a shared-memory arena of register-
  allocated slots, the segment's root written to ``bbuf``.  The last
  segment's root gives the site likelihood: ``lik`` and ``sc`` equal
  kernel 2's bit for bit.
* Kernel 8: one thread per site and a block per tile of
  :data:`SEG_SITES` sites walks the segments in reverse: phase 1
  recomputes the segment's ops into a shared-memory arena of one slot per
  op (and a flag byte each), the root's adjoint is seeded (``rr * glik``
  for the last segment, else the boundary adjoint its consumer wrote to
  ``gbuf``), phase 2 sweeps the ops in reverse with kernel 4's identities
  and writes the adjoints of the segment's boundary inputs to ``gbuf``.
  The VJP's residual is ``bbuf``: ``n_boundaries * S*C * 4`` bytes per
  site, against kernel 4's ``E * (S*C * 4 + 1)``.

Nothing is ordered between thread blocks: each owns its sites through
every segment, so the TPU kernels' sequential grid, doubled DMA arena and
scaler chain (``scbuf``) have no counterpart; the rescale count stays in a
register.  Dropped as TPU-only: ``_pipeline_default``/
``_pipeline_bwd_default``, ``_rows_pad8``/``_pad_rows``, ``_phys_slot``,
the bf16 landing scratch, ``_gather_stacks`` (the kernels index codes by
tip id and operators by original edge) and the VMEM budget
(``SEG_VMEM_BUDGET``, ``fit_block_sites``).

Capacity rule (:func:`seg_bwd_smem_bytes`).  Kernel 8's block keeps per
site one ``S*C`` fp32 slot per segment op plus a flag byte, the six
operator-gradient staging rows of kernel 4 and the constants.  At
:data:`SEG_SITES` = 32 sites a DNA slot is 2 KB.  ``cap_ops`` is chosen so
that :data:`SEG_BLOCKS_PER_SM` blocks fit one SM's shared memory (6 ops
at S = C = 4); a plan that does not fit at ``cap_ops=1`` raises.  Kernel
7's arena is kernel 2's: the most slots live in any one segment, at 128
threads (:func:`.plf_tree.tree_block_threads`).

Not ported yet (ROADMAP queue 2): the MXU forms of both kernels, bf16
boundary storage and the batched segmented scorer.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .plf_grad import op_grad, transpose_lane_constants
from .plf_node import SMEM_BLOCK_BYTES, node_plain, stage
from .plf_tree import root_reduce, tree_block_threads

__all__ = ["plan_segments", "SegPlan", "Segment", "segment_program",
           "seg_bwd_smem_bytes", "seg_cap_ops", "plf_tree_seg",
           "plf_tree_seg_torch", "plf_tree_seg_bwd", "plf_tree_seg_bwd_torch",
           "make_tree_diff_segmented", "SEG_SITES", "SEG_BLOCKS_PER_SM"]

#: Sites per tile (threads per block) of kernel 8 (``kSites`` in
#: ``csrc/plf_tree_seg_bwd.cu``); ``n_pad`` must be a multiple.
SEG_SITES = 32

#: Kernel-8 blocks that must fit one SM's shared memory at once.  Measured
#: on an H100 at 160 taxa x 2^20 sites (chip_smoke.py, kernel8 phase):
#: plans cut for 2, 4 and 8 blocks per SM (48-, 20- and 6-op caps) ran
#: kernel 8 in 104, 62 and 39 ms; more blocks hide more latency than the
#: extra boundaries cost.
SEG_BLOCKS_PER_SM = 8

#: Shared memory of one H100 SM, and what the runtime keeps per block.
SM_SMEM_BYTES = 233472
SMEM_RESERVED_PER_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class Segment:
    """One contracted subtree, padded to the plan's uniform shape.

    Unified arena coordinates: [0, SEG_TIPS) are tips, [SEG_TIPS,
    SEG_TIPS+SEG_BND) boundary-input CLVs, then one per op (op j is
    coordinate SEG_TIPS+SEG_BND+j).  Padded entries are never read.
    """

    tip_ids: np.ndarray      # (SEG_TIPS,) global leaf rows (pad: 0)
    n_tips: int
    bnd_in_ids: np.ndarray   # (SEG_BND,) global boundary ids (pad: 0)
    n_bnd_in: int
    lsrc: np.ndarray         # (SEG_OPS,) unified arena coords
    rsrc: np.ndarray
    ovalid: np.ndarray       # (SEG_OPS,) 1 = real op, 0 = padding
    opos: np.ndarray         # (SEG_OPS,) reordered-schedule positions
    n_ops: int
    out_slots: np.ndarray    # (SEG_OUT,) arena slots of exports
    bnd_out_ids: np.ndarray  # (SEG_OUT,) global boundary ids of exports
    n_bnd_out: int
    root_slot: int           # arena slot of the segment root


@dataclasses.dataclass(frozen=True)
class SegPlan:
    segments: Tuple[Segment, ...]
    n_leaves: int
    n_edges: int
    n_boundaries: int
    seg_tips: int
    seg_bnd: int
    seg_ops: int
    seg_out: int


def seg_bwd_smem_bytes(seg_ops: int, rows: int, n_codes: int,
                       states: int = 4) -> int:
    """Dynamic shared memory of one kernel-8 block: ec and its transpose,
    the tip table and the root row vector, six ``rows x (SEG_SITES + 1)``
    operator-gradient staging arrays, and per op a ``rows x SEG_SITES``
    fp32 slot and ``SEG_SITES`` flag bytes."""
    return (4 * (2 * rows * states + rows * n_codes + rows)
            + 4 * 6 * rows * (SEG_SITES + 1)
            + seg_ops * (4 * rows * SEG_SITES + SEG_SITES))


def _seg_fits(seg_ops: int, rows: int, n_codes: int) -> bool:
    per_block = (SM_SMEM_BYTES // SEG_BLOCKS_PER_SM
                 - SMEM_RESERVED_PER_BLOCK)
    return seg_bwd_smem_bytes(seg_ops, rows, n_codes) <= per_block


def seg_cap_ops(rows: int, n_codes: int) -> int:
    """The largest ``cap_ops`` whose kernel-8 arena lets
    :data:`SEG_BLOCKS_PER_SM` blocks share an SM (0 if none)."""
    cap = 0
    while _seg_fits(cap + 1, rows, n_codes):
        cap += 1
    return cap


def plan_segments(schedule: Sequence[Tuple], n_leaves: int, *, rows: int,
                  cap_ops: Optional[int] = None,
                  n_codes: int = 16) -> SegPlan:
    """Contract a reordered schedule into uniform-shape segments (the JAX
    package's contraction; operators are indexed by schedule POSITION).

    Each node accumulates the not-yet-emitted entries of its subtree; once
    that reaches ``(cap_ops + 1) // 2`` (or the root), the pending subtree
    becomes a segment and the node a boundary, so a segment has at most
    ``cap_ops`` ops.  ``cap_ops`` defaults to :func:`seg_cap_ops`; a plan
    whose arena does not fit kernel 8 is retried at half the cap, and one
    that does not fit at ``cap_ops=1`` raises.
    """
    if cap_ops is None:
        cap_ops = max(1, min(seg_cap_ops(rows, n_codes), len(schedule)))
    return _plan_with_cap(schedule, n_leaves, rows=rows, cap_ops=cap_ops,
                          n_codes=n_codes)


def _plan_with_cap(schedule, n_leaves, *, rows, cap_ops,
                   n_codes=16) -> SegPlan:
    """Build a plan for ``cap_ops``; on an arena misfit retry with half
    the cap (a 1-op segment's arena is one slot)."""
    E = len(schedule)
    thresh = max(1, (cap_ops + 1) // 2)

    # ---- contraction ------------------------------------------------------
    pending: Dict[int, List[int]] = {}
    raw_segments: List[Tuple[List[int], int]] = []  # (positions, root node)
    is_boundary: Dict[int, int] = {}                # node -> boundary id
    for i, entry in enumerate(schedule):
        p, l, r = entry[0], entry[1], entry[2]
        ent = pending.pop(l, []) + pending.pop(r, []) + [i]
        if len(ent) >= thresh or i == E - 1:
            raw_segments.append((ent, p))
            if i != E - 1:
                is_boundary[p] = len(is_boundary)
            pending[p] = []
        else:
            pending[p] = ent
    assert not any(pending.get(k) for k in pending), "unemitted entries"
    n_boundaries = len(is_boundary)

    # ---- per-segment arrays ----------------------------------------------
    built = []
    seg_tips = seg_bnd = seg_ops = seg_out = 1
    for ent, root in raw_segments:
        in_seg = {schedule[i][0]: j for j, i in enumerate(ent)}
        tips: List[int] = []
        bnds: List[int] = []
        tip_slot: Dict[int, int] = {}
        bnd_slot: Dict[int, int] = {}
        for i in ent:
            for ch in (schedule[i][1], schedule[i][2]):
                if ch in in_seg:
                    continue
                if ch < n_leaves:
                    if ch not in tip_slot:
                        tip_slot[ch] = len(tips)
                        tips.append(ch)
                else:
                    if ch not in bnd_slot:
                        bnd_slot[ch] = len(bnds)
                        bnds.append(is_boundary[ch])
        outs = [(in_seg[schedule[i][0]], is_boundary[schedule[i][0]])
                for i in ent if schedule[i][0] in is_boundary]
        built.append((ent, root, in_seg, tips, bnds, tip_slot, bnd_slot,
                      outs))
        seg_tips = max(seg_tips, len(tips))
        seg_bnd = max(seg_bnd, len(bnds))
        seg_ops = max(seg_ops, len(ent))
        seg_out = max(seg_out, len(outs))

    dummy = seg_tips + seg_bnd + seg_ops
    segments = []
    for (ent, root, in_seg, tips, bnds, tip_slot, bnd_slot, outs) in built:
        k = len(ent)
        lsrc = np.full(seg_ops, 0, np.int32)
        rsrc = np.full(seg_ops, 0, np.int32)
        ovalid = np.zeros(seg_ops, np.int32)
        opos = np.zeros(seg_ops, np.int32)

        def coord(ch) -> int:
            if ch in in_seg:
                return seg_tips + seg_bnd + in_seg[ch]
            if ch < n_leaves:
                return tip_slot[ch]
            return seg_tips + bnd_slot[ch]

        for j, i in enumerate(ent):
            lsrc[j] = coord(schedule[i][1])
            rsrc[j] = coord(schedule[i][2])
            ovalid[j] = 1
            opos[j] = i
        for j in range(k, seg_ops):      # padding ops: self-contained
            lsrc[j] = rsrc[j] = seg_tips + seg_bnd + j
        out_slots = np.full(seg_out, dummy, np.int32)
        bnd_out_ids = np.zeros(seg_out, np.int32)
        for j, (slot_j, gid) in enumerate(outs):
            out_slots[j] = seg_tips + seg_bnd + slot_j
            bnd_out_ids[j] = gid
        segments.append(Segment(
            tip_ids=np.asarray(tips + [0] * (seg_tips - len(tips)),
                               np.int32),
            n_tips=len(tips),
            bnd_in_ids=np.asarray(bnds + [0] * (seg_bnd - len(bnds)),
                                  np.int32),
            n_bnd_in=len(bnds),
            lsrc=lsrc, rsrc=rsrc, ovalid=ovalid, opos=opos, n_ops=k,
            out_slots=out_slots, bnd_out_ids=bnd_out_ids,
            n_bnd_out=len(outs),
            root_slot=seg_tips + seg_bnd + in_seg[root]))

    if not _seg_fits(seg_ops, rows, n_codes):
        if cap_ops > 1:
            return _plan_with_cap(schedule, n_leaves, rows=rows,
                                  cap_ops=max(1, cap_ops // 2),
                                  n_codes=n_codes)
        raise ValueError(
            f"a {seg_ops}-op segment arena of {rows} rows does not fit "
            f"{SEG_BLOCKS_PER_SM} kernel-8 blocks per SM even at cap_ops=1")
    return SegPlan(segments=tuple(segments), n_leaves=n_leaves, n_edges=E,
                   n_boundaries=n_boundaries, seg_tips=seg_tips,
                   seg_bnd=seg_bnd, seg_ops=seg_ops, seg_out=seg_out)


def _stacked_plan(plan: SegPlan):
    """The per-segment plan arrays stacked over segments (cached per
    plan).  ``gout`` is each segment's exported boundary id, or
    ``n_boundaries`` for the last segment, which exports nothing."""
    cached = getattr(plan, "_stacked_cache", None)
    if cached is not None:
        return cached
    trash = plan.n_boundaries
    segs = plan.segments
    for s in segs:
        assert s.n_bnd_out <= 1, "planner invariant: root is the only " \
            "boundary output of a segment"

    def stk(get):
        return np.stack([get(s) for s in segs]).astype(np.int32)

    out = dict(
        tip_ids=stk(lambda s: s.tip_ids),
        bnd_idx=stk(lambda s: s.bnd_in_ids),
        lsrc=stk(lambda s: s.lsrc),
        rsrc=stk(lambda s: s.rsrc),
        opos=stk(lambda s: s.opos),
        rslot=np.asarray([s.root_slot for s in segs], np.int32),
        gout=np.asarray(
            [s.bnd_out_ids[0] if s.n_bnd_out else trash for s in segs],
            np.int32),
        counts=stk(lambda s: np.asarray(
            [s.n_tips, s.n_bnd_in, s.n_ops, s.n_bnd_out])),
    )
    object.__setattr__(plan, "_stacked_cache", out)
    return out


# ------------------------------------------------------------ the program --


def segment_program(plan: SegPlan, schedule: Sequence[Tuple], *,
                    reuse_slots: bool):
    """The flat operand program that kernels 7 and 8 walk.

    ``schedule`` is the reordered schedule the plan was cut from (field 5
    the original edge).  Returns ``(prog, segs, n_slots)``: ``prog`` is
    ``(6, E)`` int32 in the plan's op order, rows lsrc, lflag, rsrc,
    rflag, oslot and edge, where flag 0 means tip id ``src``, 1 arena slot
    ``src`` and 2 boundary ``src``; ``segs`` is ``(n_seg, 2)`` int32, the
    end of each segment's ops and its exported boundary id (-1 for the
    last segment, whose root is the tree's).  ``reuse_slots`` frees an
    op's operand slots for its output, as kernel 2's register allocation
    does (kernel 7, ``n_slots`` the most live in any segment); without it
    op j of a segment owns slot j (kernel 8, ``n_slots = seg_ops``).
    """
    st = _stacked_plan(plan)
    T, B = plan.seg_tips, plan.seg_bnd
    edge_of = np.asarray([entry[5] for entry in schedule], np.int32)
    cols: List[List[int]] = []
    segs, n_slots = [], 0
    for s, seg in enumerate(plan.segments):
        slot_of: Dict[int, int] = {}
        free: List[int] = []
        used = 0

        def operand(v):
            if v < T:
                return int(st["tip_ids"][s, v]), 0
            if v < T + B:
                return int(st["bnd_idx"][s, v - T]), 2
            j = v - T - B
            return (slot_of.pop(j) if reuse_slots else j), 1

        for j in range(seg.n_ops):
            ls, lf = operand(int(seg.lsrc[j]))
            rs, rf = operand(int(seg.rsrc[j]))
            if reuse_slots:
                free.extend(x for x, f in ((ls, lf), (rs, rf)) if f == 1)
                out = free.pop() if free else used
                used = max(used, out + 1)
                slot_of[j] = out
            else:
                out = j
                used = seg.n_ops
            cols.append([ls, lf, rs, rf, out,
                         int(edge_of[seg.opos[j]])])
        n_slots = max(n_slots, used)
        last = s == len(plan.segments) - 1
        segs.append([len(cols), -1 if last else int(st["gout"][s])])
    prog = np.ascontiguousarray(np.asarray(cols, np.int32).T)
    return prog, np.asarray(segs, np.int32), n_slots


# --------------------------------------------------------- plain versions --


def _operand(src, flag, codes, ttab, bbuf, arena):
    if flag == 0:
        return ttab[:, codes[src].long()]
    if flag == 2:
        return bbuf[src]
    return arena[src]


def plf_tree_seg_torch(codes, prog, segs, lcs, rcs, ec, ttab, rr, n: int, *,
                       n_boundaries: int, n_slots: int, states: int = 4,
                       categories: int = 4):
    """Plain version of kernel 7 (the arguments and results of
    :func:`plf_tree_seg`), on the device of its inputs, segment by segment
    in the kernel's op order: :func:`.plf_node.node_plain` per op, the
    sequential root reduction."""
    S, C = states, categories
    n_pad = codes.shape[-1]
    dev = codes.device
    valid = torch.arange(n_pad, device=dev) < n
    lsrc, lflag, rsrc, rflag, oslot, edge = prog.cpu().tolist()
    bbuf = torch.empty((n_boundaries, S * C, n_pad), dtype=torch.float32,
                       device=dev)
    arena: List[Optional[torch.Tensor]] = [None] * n_slots
    scaler = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    start = 0
    for end, gout in segs.cpu().tolist():
        for i in range(start, end):
            e = edge[i]
            x3, mask = node_plain(
                _operand(lsrc[i], lflag[i], codes, ttab, bbuf, arena),
                _operand(rsrc[i], rflag[i], codes, ttab, bbuf, arena),
                lcs[e], rcs[e], ec, valid, S, C)
            arena[oslot[i]] = x3
            scaler += mask.to(torch.int32)
        root = arena[oslot[end - 1]]
        if gout >= 0:
            bbuf[gout] = root
        start = end
    return root_reduce(rr, root)[None, :], scaler[None, :], bbuf


def plf_tree_seg_bwd_torch(codes, prog, segs, lcs, rcs, lcsT, rcsT, ec, ecT,
                           ttab, rr, glik, bbuf, n: int, *, states: int = 4,
                           categories: int = 4, gbuf=None):
    """Plain version of kernel 8 (the arguments and results of
    :func:`plf_tree_seg_bwd`), on the device of its inputs: the segments
    in reverse, each recomputed from its tips and boundary CLVs, then
    swept in reverse with :func:`.plf_tree_grad.plf_tree_bwd_torch`'s
    identities; the adjoints of a segment's boundary inputs go to ``gbuf``
    ``(n_boundaries, S*C, n_pad)`` (allocated when None) for the segments
    that produced them.  Every per-site value equals the kernel's; the
    site sums run in another order."""
    S, C = states, categories
    n_pad = codes.shape[-1]
    dev = codes.device
    valid = torch.arange(n_pad, device=dev) < n
    lsrc, lflag, rsrc, rflag, oslot, edge = prog.cpu().tolist()
    seg_rows = segs.cpu().tolist()
    if gbuf is None:
        gbuf = torch.empty_like(bbuf)
    gl, gr = torch.zeros_like(lcs), torch.zeros_like(rcs)
    gec = torch.zeros_like(ec)
    grr = torch.zeros_like(rr)
    two32 = float(2.0 ** 32)
    for s in range(len(seg_rows) - 1, -1, -1):
        end, gout = seg_rows[s]
        start = seg_rows[s - 1][0] if s else 0
        arena: Dict[int, torch.Tensor] = {}
        flag: Dict[int, torch.Tensor] = {}
        for i in range(start, end):
            e = edge[i]
            arena[oslot[i]], flag[oslot[i]] = node_plain(
                _operand(lsrc[i], lflag[i], codes, ttab, bbuf, arena),
                _operand(rsrc[i], rflag[i], codes, ttab, bbuf, arena),
                lcs[e], rcs[e], ec, valid, S, C)
        root = oslot[end - 1]
        if gout < 0:
            g = torch.where(valid, glik[0], 0.0)
            grr = (arena[root] * g).sum(dim=1)
            arena[root] = rr[:, None] * g
        else:
            arena[root] = gbuf[gout]
        for i in range(end - 1, start - 1, -1):
            e = edge[i]
            g_y = torch.where(flag[oslot[i]], arena[oslot[i]] * two32,
                              arena[oslot[i]])
            x1 = _operand(lsrc[i], lflag[i], codes, ttab, bbuf, arena)
            x2 = _operand(rsrc[i], rflag[i], codes, ttab, bbuf, arena)
            u1 = stage(x1, lcs[e], S, C)
            u2 = stage(x2, rcs[e], S, C)
            g_p = stage(g_y, ecT, S, C)
            g_u1 = g_p * u2
            g_u2 = g_p * u1
            gl[e] = op_grad(x1, g_u1, S, C)
            gr[e] = op_grad(x2, g_u2, S, C)
            gec = gec + op_grad(u1 * u2, g_y, S, C)
            for src, fl, gu, opT in ((lsrc[i], lflag[i], g_u1, lcsT),
                                     (rsrc[i], rflag[i], g_u2, rcsT)):
                if fl == 1:
                    arena[src] = stage(gu, opT[e], S, C)
                elif fl == 2:
                    gbuf[src] = stage(gu, opT[e], S, C)
    return gl, gr, gec, grr


# ---------------------------------------------------------------- kernels --


def _check(codes, prog, segs, stacks, consts, ttab, rr, states, categories):
    rows = states * categories
    if codes.dim() != 2 or codes.dtype not in (torch.int32, torch.int8):
        raise TypeError("codes must be (n_leaves, n_pad) int32 or int8")
    E = next(iter(stacks.values())).shape[0]
    if tuple(prog.shape) != (6, E) or prog.dtype != torch.int32:
        raise ValueError(f"prog must be (6, {E}) int32, got "
                         f"{tuple(prog.shape)} {prog.dtype}")
    if segs.dim() != 2 or segs.shape[1] != 2 or segs.dtype != torch.int32:
        raise ValueError("segs must be (n_seg, 2) int32")
    named = ([(k, t, (E, rows, states)) for k, t in stacks.items()]
             + [(k, t, (rows, states)) for k, t in consts.items()]
             + [("rr", rr, (rows,))])
    for name, t, shape in named:
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if ttab.dim() != 2 or ttab.shape[0] != rows \
            or ttab.dtype != torch.float32:
        raise ValueError(f"ttab must be ({rows}, n_codes) float32")
    ts = [codes, prog, segs, ttab, rr, *stacks.values(), *consts.values()]
    if any(t.device != codes.device for t in ts):
        raise ValueError("plf_tree_seg: all tensors must be on one device")


def _on_card(name, states, categories, tensors, aligned):
    if states != 4 or not 1 <= categories <= 8:
        raise ValueError(f"{name}: the CUDA kernel takes S = 4 and C in "
                         f"1..8, got S={states}, C={categories}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError(f"{name}: operator stacks and EV constants must "
                         f"be 16-byte aligned")


@functools.cache
def _lib():
    """Build (first use) and load csrc/plf_tree_seg.cu."""
    from ._build import load_library
    lib = load_library("plf_tree_seg")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.plf_tree_seg_launch.argtypes = (
        [vp, ci, vp, ci, vp, ci] + [vp] * 4 + [ci, vp, vp, vp, vp]
        + [ci] * 5 + [vp])
    lib.plf_tree_seg_launch.restype = ci
    lib.plf_error_string.argtypes = [ci]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


def plf_tree_seg(codes, prog, segs, lcs, rcs, ec, ttab, rr, n: int, *,
                 n_boundaries: int, n_slots: int, states: int = 4,
                 categories: int = 4):
    """Kernel 7: the segmented whole-tree likelihood.

    Args:
      codes: ``(n_leaves, n_pad)`` int32 or int8 tip codes.
      prog, segs, n_slots: :func:`segment_program` with
        ``reuse_slots=True``; n_boundaries: the plan's.
      lcs, rcs: ``(E, S*C, S)`` operators by original edge; ec ``(S*C,
        S)``; ttab ``(S*C, n_codes)``; rr ``(S*C,)``: as
        :func:`.plf_tree.plf_tree` takes them.
      n: valid site count.

    Returns:
      ``(lik, sc, bbuf)``: ``(1, n_pad)`` fp32 site likelihoods and int32
      rescale counts (kernel 2's, bit for bit), and every boundary CLV,
      ``(n_boundaries, S*C, n_pad)`` fp32 (the VJP's residual).
    """
    _check(codes, prog, segs, dict(lcs=lcs, rcs=rcs), dict(ec=ec), ttab, rr,
           states, categories)
    args = (codes, prog, segs, lcs, rcs, ec, ttab, rr)
    if codes.device.type == "cpu":
        return plf_tree_seg_torch(*args, n, n_boundaries=n_boundaries,
                                  n_slots=n_slots, states=states,
                                  categories=categories)
    if codes.device.type != "cuda":
        raise ValueError(f"plf_tree_seg: no kernel for device {codes.device}")
    _on_card("plf_tree_seg", states, categories, args, (lcs, rcs, ec))
    rows = states * categories
    n_codes = ttab.shape[1]
    threads = tree_block_threads(n_slots, rows, n_codes, states)
    if threads is None:
        raise ValueError(f"plf_tree_seg: a {n_slots}-slot segment arena does "
                         f"not fit {SMEM_BLOCK_BYTES} bytes of shared memory")
    n_pad = codes.shape[-1]
    if not 0 <= n <= n_pad or n_pad == 0 or n_pad >= 2 ** 31:
        raise ValueError(f"plf_tree_seg: bad n={n} for n_pad={n_pad}")
    dev = codes.device
    lik = torch.empty((1, n_pad), dtype=torch.float32, device=dev)
    sc = torch.empty((1, n_pad), dtype=torch.int32, device=dev)
    bbuf = torch.empty((n_boundaries, rows, n_pad), dtype=torch.float32,
                       device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.plf_tree_seg_launch(
            codes.data_ptr(), codes.element_size(), prog.data_ptr(),
            prog.shape[1], segs.data_ptr(), segs.shape[0], lcs.data_ptr(),
            rcs.data_ptr(), ec.data_ptr(), ttab.data_ptr(), n_codes,
            rr.data_ptr(), bbuf.data_ptr(), lik.data_ptr(), sc.data_ptr(),
            n_slots, int(n), n_pad, categories, threads,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"plf_tree_seg kernel launch failed: "
                           f"{lib.plf_error_string(err).decode()}")
    plf_tree_seg.launches += 1
    return lik, sc, bbuf


plf_tree_seg.launches = 0


@functools.cache
def _lib_bwd():
    """Build (first use) and load csrc/plf_tree_seg_bwd.cu."""
    from ._build import load_library
    lib = load_library("plf_tree_seg_bwd")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.plf_tree_seg_bwd_launch.argtypes = (
        [vp, ci, vp, ci, vp, ci] + [vp] * 7 + [ci] + [vp] * 5
        + [ci] * 6 + [vp])
    lib.plf_tree_seg_bwd_launch.restype = ci
    lib.plf_tree_seg_bwd_occupancy.argtypes = [ci, ci, ci, ci,
                                               ctypes.POINTER(ci)]
    lib.plf_tree_seg_bwd_occupancy.restype = ci
    lib.plf_tree_seg_bwd_reduce.argtypes = [vp, ci, ci, vp, vp]
    lib.plf_tree_seg_bwd_reduce.restype = ci
    lib.plf_error_string.argtypes = [ci]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _resident_blocks(device: torch.device, code_bytes: int, categories: int,
                     n_codes: int, seg_ops: int) -> int:
    """Kernel-8 blocks resident on the whole card at once (blocks per SM,
    registers and shared memory counted by the CUDA runtime, times the
    SMs): the launch is one wave."""
    lib = _lib_bwd()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.plf_tree_seg_bwd_occupancy(code_bytes, categories, n_codes,
                                             seg_ops, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"plf_tree_seg_bwd occupancy query failed: "
                           f"{lib.plf_error_string(err).decode()}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return blocks.value * sms


def plf_tree_seg_bwd(codes, prog, segs, lcs, rcs, lcsT, rcsT, ec, ecT, ttab,
                     rr, glik, bbuf, n: int, *, seg_ops: int, states: int = 4,
                     categories: int = 4, gbuf=None):
    """Kernel 8: the VJP of kernel 7's site likelihoods w.r.t. its
    operators.

    Args:
      prog, segs: :func:`segment_program` with ``reuse_slots=False``
        (the same plan as the forward's); seg_ops: the plan's, the most
        ops in a segment (the kernel stops on a segment with more).
      lcsT, rcsT, ecT: the transposed operators
        (:func:`.plf_grad.transpose_lane_constants`); glik: ``(1, n_pad)``
        cotangent; bbuf: kernel 7's boundary CLVs.  The rest as
        :func:`plf_tree_seg`.
      gbuf: where the boundary adjoints go, ``bbuf``'s shape (scratch,
        allocated when None; passed to inspect them).

    Returns:
      ``(gl, gr, gec, grr)``: ``(E, S*C, S)``, ``(E, S*C, S)``, ``(S*C,
      S)`` and ``(S*C,)`` fp32 site sums, by original edge.
    """
    _check(codes, prog, segs, dict(lcs=lcs, rcs=rcs, lcsT=lcsT, rcsT=rcsT),
           dict(ec=ec, ecT=ecT), ttab, rr, states, categories)
    rows = states * categories
    n_leaves, n_pad = codes.shape
    n_bnd = bbuf.shape[0]
    for name, t in (("glik", glik), ("bbuf", bbuf), ("gbuf", gbuf)):
        want = (1, n_pad) if name == "glik" else (n_bnd, rows, n_pad)
        if t is not None and (tuple(t.shape) != want
                              or t.dtype != torch.float32
                              or t.device != codes.device):
            raise ValueError(f"{name} must be {want} float32 on "
                             f"{codes.device}")
    args = (codes, prog, segs, lcs, rcs, lcsT, rcsT, ec, ecT, ttab, rr, glik,
            bbuf)
    if codes.device.type == "cpu":
        return plf_tree_seg_bwd_torch(*args, n, states=states,
                                      categories=categories, gbuf=gbuf)
    if codes.device.type != "cuda":
        raise ValueError(f"plf_tree_seg_bwd: no kernel for device "
                         f"{codes.device}")
    _on_card("plf_tree_seg_bwd", states, categories, args,
             (lcs, rcs, lcsT, rcsT, ec, ecT))
    if n_pad % SEG_SITES or n_pad >= 2 ** 31 or not 0 <= n <= n_pad:
        raise ValueError(f"plf_tree_seg_bwd: n_pad={n_pad} must be a "
                         f"positive multiple of {SEG_SITES} and 0 <= n={n} "
                         f"<= n_pad")
    n_codes = ttab.shape[1]
    if not _seg_fits(seg_ops, rows, n_codes):
        raise ValueError(f"plf_tree_seg_bwd: a {seg_ops}-op segment does not "
                         f"fit {SEG_BLOCKS_PER_SM} blocks per SM")
    dev = codes.device
    tiles = n_pad // SEG_SITES
    resident = _resident_blocks(dev, codes.element_size(), categories,
                                n_codes, seg_ops)
    per = -(-tiles // resident)
    n_blocks = -(-tiles // per)
    E, RS = lcs.shape[0], rows * states
    cols = 2 * E * RS + RS + rows
    partial = torch.empty((n_blocks, cols), dtype=torch.float32, device=dev)
    out = torch.empty(cols, dtype=torch.float32, device=dev)
    if gbuf is None:
        gbuf = torch.empty_like(bbuf)
    lib = _lib_bwd()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.plf_tree_seg_bwd_launch(
            codes.data_ptr(), codes.element_size(), prog.data_ptr(), E,
            segs.data_ptr(), segs.shape[0], lcs.data_ptr(), rcs.data_ptr(),
            lcsT.data_ptr(), rcsT.data_ptr(), ec.data_ptr(), ecT.data_ptr(),
            ttab.data_ptr(), n_codes, rr.data_ptr(), glik.data_ptr(),
            bbuf.data_ptr(), gbuf.data_ptr(), partial.data_ptr(), seg_ops,
            n_blocks, per, int(n), n_pad, categories, stream)
        if err == 0:
            err = lib.plf_tree_seg_bwd_reduce(partial.data_ptr(), n_blocks,
                                              cols, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"plf_tree_seg_bwd kernel launch failed: "
                           f"{lib.plf_error_string(err).decode()}")
    plf_tree_seg_bwd.launches += 1
    gl = out[:E * RS].view(E, rows, states)
    gr = out[E * RS:2 * E * RS].view(E, rows, states)
    gec = out[2 * E * RS:2 * E * RS + RS].view(rows, states)
    return gl, gr, gec, out[2 * E * RS + RS:]


plf_tree_seg_bwd.launches = 0


# ----------------------------------------------------------- differentiable --


class _SegDiff(torch.autograd.Function):
    """Kernel 7 forward, kernel 8 backward; the residual is the boundary
    buffer (and the small operand arrays), never an op CLV."""

    @staticmethod
    def forward(ctx, codes, lcs, rcs, ec, ttab, rr, fwd, bwd, n, plan,
                n_slots, states, categories):
        lik, sc, bbuf = plf_tree_seg(
            codes, fwd[0], fwd[1], lcs, rcs, ec, ttab, rr, n,
            n_boundaries=plan.n_boundaries, n_slots=n_slots, states=states,
            categories=categories)
        ctx.seg_ops = plan.seg_ops
        ctx.save_for_backward(codes, bwd[0], bwd[1], lcs, rcs, ec, ttab, rr,
                              bbuf)
        ctx.n, ctx.states, ctx.categories = n, states, categories
        ctx.mark_non_differentiable(sc)
        return lik, sc

    @staticmethod
    def backward(ctx, glik, _g_sc):
        codes, prog, segs, lcs, rcs, ec, ttab, rr, bbuf = ctx.saved_tensors
        S, C = ctx.states, ctx.categories
        lcsT, rcsT, ecT = (transpose_lane_constants(t, S, C)
                           for t in (lcs, rcs, ec))
        gl, gr, gec, grr = plf_tree_seg_bwd(
            codes, prog, segs, lcs, rcs, lcsT, rcsT, ec, ecT, ttab, rr,
            glik.contiguous(), bbuf, ctx.n, seg_ops=ctx.seg_ops, states=S,
            categories=C)
        return (None, gl, gr, gec, None, grr) + (None,) * 7


def make_tree_diff_segmented(schedule: Sequence[Tuple], n_leaves: int, *,
                             states: int = 4, categories: int = 4,
                             cap_ops: Optional[int] = None,
                             n_codes: int = 16):
    """Differentiable segmented whole-tree likelihood, with the contract
    of :func:`.plf_tree_grad.make_tree_diff`: ``fn(codes, lcs, rcs, ec,
    ttab, rr, n, planes=None) -> (lik, sc)``, operators by original edge,
    ``rr`` ``(S*C,)``; differentiable in lcs, rcs, ec and rr.  Kernel 7
    forward, kernel 8 backward, one launch each ("vpu", S = 4, so
    ``planes`` must be None).  ``fn.plan`` is the plan (the JAX package's
    for the same schedule and ``cap_ops``)."""
    if states != 4:
        raise NotImplementedError(
            "the segmented kernels are ported in the vpu form at S = 4 "
            "only; the MXU forms wait: ROADMAP.md, Queue 2 items 2-3")
    rows = states * categories
    pos_sched = [(p, l, r, 0.0, 0.0, i)
                 for i, (p, l, r, *_x) in enumerate(schedule)]
    plan = plan_segments(pos_sched, n_leaves, rows=rows, cap_ops=cap_ops,
                         n_codes=n_codes)
    fwd_np = segment_program(plan, schedule, reuse_slots=True)
    bwd_np = segment_program(plan, schedule, reuse_slots=False)
    n_slots = fwd_np[2]
    on_device = {}

    def fn(codes, lcs, rcs, ec, ttab, rr, n, planes=None):
        if planes is not None:
            raise ValueError("the segmented kernels take no operator planes")
        dev = codes.device
        if dev not in on_device:
            on_device[dev] = tuple(
                tuple(torch.as_tensor(a, device=dev) for a in p[:2])
                for p in (fwd_np, bwd_np))
        fwd, bwd = on_device[dev]
        return _SegDiff.apply(codes, lcs, rcs, ec, ttab, rr, fwd, bwd,
                              int(n), plan, n_slots, states, categories)

    fn.plan = plan
    return fn
