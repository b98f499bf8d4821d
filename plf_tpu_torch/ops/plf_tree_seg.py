"""Kernels 7, 8, 7m and 8m: the segmented whole-tree forward and backward.

Counterpart of ``plf_tpu/ops/plf_tree_seg.py``.  Replaces
``_seg_fwd_kernel`` (``plf_tree_seg.py:383``, launched by
``_seg_fwd_call`` ``:591``) with ``csrc/plf_tree_seg.cu`` ("vpu" form at
S = 4, kernel 7) and ``csrc/plf_tree_seg_mxu.cu`` (its matrix forms,
kernel 7m), and ``_seg_bwd_kernel`` (``:843``, ``_seg_bwd_call``
``:1095``) with ``csrc/plf_tree_seg_bwd.cu`` (kernel 8) and
``csrc/plf_tree_seg_bwd_mxu.cu`` (kernel 8m).  The matrix forms serve
the "mxu", "mxu_3x" and "mxu_bf16" variants and "vpu" at S != 4 (the
``is_mxu`` branches of the TPU kernels), as kernels 2m and 4m do.

The reordered schedule is contracted bottom-up into segments, each a
subtree of at most ``cap_ops`` ops whose inputs are tips or the roots of
earlier segments (boundary CLVs); the planner (:class:`Segment`,
:class:`SegPlan`, :func:`plan_segments`, :func:`_contract`,
:func:`_stacked_plan`) is a NumPy copy of the JAX package's, so both
packages cut a tree into the same segments for the same cap.

* Kernel 7: one thread per site walks every segment in order, as kernel 2
  walks the whole tree: tips expanded on demand from their codes, boundary
  CLVs read from the boundary buffer ``bbuf`` ``(n_boundaries, S*C,
  n_pad)``, each segment's ops in a shared-memory arena of register-
  allocated slots, the segment's root written to ``bbuf``.  The last
  segment's root gives the site likelihood: ``lik`` and ``sc`` equal
  kernel 2's bit for bit.
* Kernel 8: one thread per site, a one-warp block owns its tiles of
  :data:`SEG_SITES` sites and walks the segments in reverse, each over
  all its tiles: phase 1 recomputes the segment's ops into a
  shared-memory arena of one slot per op (and a flag byte each), the
  root's adjoint is seeded (``rr * glik`` for the last segment, else the
  boundary adjoint its consumer wrote to ``gbuf``), phase 2 sweeps the
  ops in reverse with kernel 4's identities and writes the adjoints of
  the segment's boundary inputs to ``gbuf``; a segment's gl/gr sums stay
  in shared memory until its tiles are done.
  The VJP's residual is ``bbuf``: ``n_boundaries * S*C * 4`` bytes per
  site, against kernel 4's ``E * (S*C * 4 + 1)``.
* Kernel 7m: kernel 7's program on kernel 2m's ``[row][site]`` 8-site
  tiles (``node_tile`` of ``csrc/plf_mxu.cuh`` per op, kernel 2m's
  sequential root reduction), so ``lik`` and ``sc`` equal kernel 2m's bit
  for bit in every mode.  The JAX kernel reduces the root as ``dot(rr,
  x_root)`` in the variant's pass count (``plf_tree_seg.py:554``) where
  its fused kernels reduce it in sequential fp32; the port keeps the
  fused kernels' reduction, so its fused and segmented paths agree bit
  for bit (the two JAX reductions differ within the variant's class).
* Kernel 8m: kernel 4m's per-block backward walked segment by segment in
  reverse: phase 1 recomputes the segment's ops (tips from codes,
  boundaries from ``bbuf``) into a device-memory checkpoint of
  ``seg_ops`` slots, the seed is kernel 8's, phase 2 is kernel 4m's
  edge-major reverse sweep and writes a boundary child's adjoint to
  ``gbuf``.  It returns the lane-constant entries ``(E, S*C, S)`` of the
  JAX kernel's dense ``(rows, rows)`` block gradients, as kernel 4m does.

Nothing is ordered between thread blocks: each owns its sites through
every segment, so the TPU kernels' sequential grid, doubled DMA arena and
scaler chain (``scbuf``) have no counterpart; the rescale count stays in a
register (shared memory in the matrix forms).  Dropped as TPU-only:
``_pipeline_default``/``_pipeline_bwd_default``, ``_rows_pad8``/
``_pad_rows``, ``_phys_slot``, the bf16 landing scratch,
``_gather_stacks`` (the kernels index codes by tip id and operators by
original edge) and the VMEM budget (``SEG_VMEM_BUDGET``,
``fit_block_sites``).

Capacity rules.  Kernel 8 (:func:`seg_bwd_smem_bytes`) keeps per site one
``S*C`` fp32 slot per segment op plus a flag byte, per op its gl/gr sums,
one warp's operator-gradient staging area and the constants in shared
memory.  At :data:`SEG_SITES` = 32 sites a DNA op takes 2.5 KB.
``cap_ops`` is chosen so that :data:`SEG_BLOCKS_PER_SM` blocks fit one
SM's shared memory (8 ops at S = C = 4); a plan that does not fit at
``cap_ops=1`` raises.  Kernel 7's arena is kernel 2's: the most slots
live in any one segment, at 128 threads
(:func:`.plf_tree.tree_block_threads`).  That rule admits no op at all
at S = 20 or 61 (its fixed part alone is 41 KB and 245 KB), so the
matrix forms have their own (:func:`seg_mxu_cap_ops`):
kernel 8m keeps its op checkpoint in device memory, as kernel 4m does, so
its shared memory does not grow with the segment; what a cap buys is
device memory, ``seg_ops`` checkpoint slots of ``S*C*4 + 1`` bytes per
site against two boundary rows (``bbuf`` and ``gbuf``) of ``S*C*4`` bytes
per boundary, and the rule takes the cap whose plan needs the least
(:func:`seg_mxu_site_bytes`), among plans whose kernel-7m arena fits
(:func:`.plf_tree.tree_mxu_fits`).

bf16 storage (``PLFConfig(dtype="bfloat16")``, the JAX package's
``io_dtype``): every kernel and plain version here takes ``bbuf`` (and
kernel 8's ``gbuf``) in bf16 as well as fp32.  A segment's root is rounded
to nearest even as it is exported and widened where a later segment (or
the backward's recompute) reads it, a boundary adjoint rounded as it is
written and widened as its producer's root seed, exactly where the JAX
kernels narrow and widen (``plf_tree_seg.py:452-484``, ``:568``,
``:1022-1024``, ``:1070-1075``); arithmetic, the last segment's root,
``lik``, ``sc`` and the site sums stay fp32.  The plan does not depend on
the storage type (:func:`seg_mxu_site_bytes` counts fp32 boundaries), so
an fp32 and a bf16 run cut a tree alike, as the JAX planner does.  Each
wrapper's ``bf16_launches`` counts the launches of its bf16 form.

Not ported yet (ROADMAP queue 1 item 3): the batched segmented scorer.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .plf_grad import GRAD_THREADS, transpose_lane_constants
from .plf_mxu import (MODES, mxu_op_grad, mxu_stage, node_mxu_plain,
                      node_planes, transpose_planes, uses_mxu_kernels)
from .plf_node import SMEM_BLOCK_BYTES, count_launch
from .plf_tree import root_reduce, tree_block_threads, tree_mxu_fits
from .plf_tree_grad import (acc_floats, tree_bwd_chunk_sites,
                            tree_bwd_mxu_blocks, tree_bwd_scratch_bytes)

__all__ = ["plan_segments", "SegPlan", "Segment", "segment_program",
           "seg_bwd_smem_bytes", "seg_cap_ops", "seg_mxu_cap_ops",
           "seg_mxu_site_bytes", "plf_tree_seg", "plf_tree_seg_torch",
           "plf_tree_seg_mxu", "plf_tree_seg_bwd", "plf_tree_seg_bwd_torch",
           "plf_tree_seg_bwd_mxu", "make_tree_diff_segmented", "SEG_SITES",
           "SEG_BLOCKS_PER_SM", "SEG_MXU_CAPS"]

#: Sites per tile (threads per block) of kernel 8 (``kSites`` in
#: ``csrc/plf_tree_seg_bwd.cu``); ``n_pad`` must be a multiple.
SEG_SITES = 32

#: Kernel-8 blocks that must fit one SM's shared memory at once.  Measured
#: on an H100 at 160 taxa x 2^20 sites (chip_smoke.py, kernel8 phase):
#: plans cut for 4, 6, 8 and 10 blocks per SM (19-, 12-, 8- and 6-op caps)
#: ran kernel 8 in 36.0, 29.4, 23.2 and 22.8 ms and kernel 7 in 5.96, 5.11,
#: 5.27 and 5.58 ms; more blocks hide more latency than the extra
#: boundaries cost, up to 8, where a step's two kernels level off.
SEG_BLOCKS_PER_SM = 8

#: Shared memory of one H100 SM, and what the runtime keeps per block.
SM_SMEM_BYTES = 233472
SMEM_RESERVED_PER_BLOCK = 1024

#: The caps :func:`seg_mxu_cap_ops` chooses from (each at most E).
SEG_MXU_CAPS = (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


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
    the warp's operator-gradient staging area (two ``rows x SEG_SITES``
    arrays), the tip table and the root row vector, and per op a ``rows x
    SEG_SITES`` fp32 slot, ``SEG_SITES`` flag bytes and the op's gl/gr
    sums (two floats per lane, per matrix and per pass of four
    categories)."""
    passes = -(-(rows // states) // 4)
    return (4 * (2 * rows * states + 2 * rows * SEG_SITES + rows * n_codes
                 + rows)
            + seg_ops * (4 * rows * SEG_SITES + SEG_SITES
                         + 4 * 4 * passes * SEG_SITES))


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


def seg_mxu_site_bytes(plan: "SegPlan", rows: int) -> int:
    """Device memory per site of a matrix-form segmented step on
    ``plan``: kernel 8m's op checkpoint (``seg_ops`` fp32 CLVs and flag
    bytes, :func:`.plf_tree_grad.tree_bwd_scratch_bytes`), and the
    boundary CLVs of kernel 7m with kernel 8m's adjoints of them, counted
    in fp32 whatever their storage (the plan is the same for both)."""
    return (tree_bwd_scratch_bytes(plan.seg_ops, rows, 1)
            + 2 * plan.n_boundaries * 4 * rows)


def _mxu_fits(plan: "SegPlan", schedule, rows: int, n_codes: int) -> bool:
    """Whether kernel 7m's arena (the most slots live in any one
    segment) fits one block, as kernel 2m's rule counts it."""
    n_slots = segment_program(plan, schedule, reuse_slots=True)[2]
    return tree_mxu_fits(n_slots, rows, n_codes)


def seg_mxu_cap_ops(schedule: Sequence[Tuple], n_leaves: int, *, rows: int,
                    n_codes: int = 16) -> int:
    """The matrix forms' capacity rule: of :data:`SEG_MXU_CAPS` (each at
    most E), the cap whose plan needs the least device memory per site
    (:func:`seg_mxu_site_bytes`; the larger cap on a tie), among plans
    whose kernel-7m arena fits; raises if none fits."""
    E = len(schedule)
    best = None
    for cap in sorted({min(c, E) for c in SEG_MXU_CAPS}):
        plan = _contract(schedule, n_leaves, cap)
        if not _mxu_fits(plan, schedule, rows, n_codes):
            continue
        key = seg_mxu_site_bytes(plan, rows)
        if best is None or key <= best[0]:
            best = (key, cap)
    if best is None:
        raise ValueError(f"no segment plan of {rows} rows fits kernel 7m's "
                         f"arena ({SMEM_BLOCK_BYTES} bytes)")
    return best[1]


def plan_segments(schedule: Sequence[Tuple], n_leaves: int, *, rows: int,
                  cap_ops: Optional[int] = None, n_codes: int = 16,
                  matrix_form: bool = False) -> SegPlan:
    """Contract a reordered schedule into uniform-shape segments (the JAX
    package's contraction; operators are indexed by schedule POSITION).

    Each node accumulates the not-yet-emitted entries of its subtree; once
    that reaches ``(cap_ops + 1) // 2`` (or the root), the pending subtree
    becomes a segment and the node a boundary, so a segment has at most
    ``cap_ops`` ops.  ``cap_ops`` defaults to the capacity rule of the
    kernels that run: :func:`seg_cap_ops` (kernels 7 and 8) or, with
    ``matrix_form``, :func:`seg_mxu_cap_ops` (kernels 7m and 8m).  A plan
    that does not fit is retried at half the cap (kernel 8's arena, or
    kernel 7m's with ``matrix_form``), and one that does not fit at
    ``cap_ops=1`` raises.
    """
    if cap_ops is None:
        if matrix_form:
            cap_ops = seg_mxu_cap_ops(schedule, n_leaves, rows=rows,
                                      n_codes=n_codes)
        else:
            cap_ops = max(1, min(seg_cap_ops(rows, n_codes), len(schedule)))
    while True:
        plan = _contract(schedule, n_leaves, cap_ops)
        fits = (_mxu_fits(plan, schedule, rows, n_codes) if matrix_form
                else _seg_fits(plan.seg_ops, rows, n_codes))
        if fits:
            return plan
        if cap_ops == 1:
            kernel = "kernel-7m arena" if matrix_form else (
                f"arena of {SEG_BLOCKS_PER_SM} kernel-8 blocks per SM")
            raise ValueError(f"a {plan.seg_ops}-op segment of {rows} rows "
                             f"does not fit the {kernel} even at cap_ops=1")
        cap_ops = max(1, cap_ops // 2)


def _contract(schedule, n_leaves, cap_ops) -> SegPlan:
    """The plan of the JAX package's contraction for ``cap_ops``."""
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
    """The flat operand program that the segmented kernels walk.

    ``schedule`` is the reordered schedule the plan was cut from (field 5
    the original edge).  Returns ``(prog, segs, n_slots)``: ``prog`` is
    ``(6, E)`` int32 in the plan's op order, rows lsrc, lflag, rsrc,
    rflag, oslot and edge, where flag 0 means tip id ``src``, 1 arena slot
    ``src`` and 2 boundary ``src``; ``segs`` is ``(n_seg, 2)`` int32, the
    end of each segment's ops and its exported boundary id (-1 for the
    last segment, whose root is the tree's).  ``reuse_slots`` frees an
    op's operand slots for its output, as kernel 2's register allocation
    does (kernels 7 and 7m, ``n_slots`` the most live in any segment);
    without it op j of a segment owns slot j (kernels 8 and 8m, ``n_slots
    = seg_ops``).
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
        return bbuf[src].float()
    return arena[src]


def plf_tree_seg_torch(codes, prog, segs, lcs, rcs, ec, ttab, rr, n: int, *,
                       n_boundaries: int, n_slots: int, states: int = 4,
                       categories: int = 4, variant: str = "vpu",
                       planes=None, dtype: torch.dtype = torch.float32):
    """Plain version of kernels 7 and 7m (the arguments and results of
    :func:`plf_tree_seg`), on the device of its inputs, segment by segment
    in the kernels' op order: :func:`.plf_mxu.node_mxu_plain` per op in
    the arithmetic of ``variant`` (in fp32 mode it is
    :func:`.plf_node.node_plain`), tips as columns of ``ttab`` (the
    variant's rounded table), the sequential root reduction; boundaries
    stored in ``dtype`` (assigning a root to a bf16 row rounds it)."""
    S, C = states, categories
    pl = node_planes(lcs, rcs, ec, variant, planes)
    n_pad = codes.shape[-1]
    dev = codes.device
    valid = torch.arange(n_pad, device=dev) < n
    lsrc, lflag, rsrc, rflag, oslot, edge = prog.cpu().tolist()
    bbuf = torch.empty((n_boundaries, S * C, n_pad), dtype=dtype, device=dev)
    arena: List[Optional[torch.Tensor]] = [None] * n_slots
    scaler = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    start = 0
    for end, gout in segs.cpu().tolist():
        for i in range(start, end):
            e = edge[i]
            x3, mask = node_mxu_plain(
                _operand(lsrc[i], lflag[i], codes, ttab, bbuf, arena),
                _operand(rsrc[i], rflag[i], codes, ttab, bbuf, arena),
                lcs[e], rcs[e], ec, valid, S, C, variant,
                (pl[0][e], pl[1][e], pl[2][e], pl[3][e], pl[4], pl[5]))
            arena[oslot[i]] = x3
            scaler += mask.to(torch.int32)
        root = arena[oslot[end - 1]]
        if gout >= 0:
            bbuf[gout] = root
        start = end
    return root_reduce(rr, root)[None, :], scaler[None, :], bbuf


def plf_tree_seg_bwd_torch(codes, prog, segs, lcs, rcs, ec, ttab, rr, glik,
                           bbuf, n: int, *, states: int = 4,
                           categories: int = 4, variant: str = "vpu",
                           planes=None, gbuf=None):
    """Plain version of kernels 8 and 8m (the arguments and results of
    :func:`plf_tree_seg_bwd`), on the device of its inputs: the segments
    in reverse, each recomputed from its tips and boundary CLVs, then
    swept in reverse with :func:`.plf_tree_grad.plf_tree_bwd_mxu_torch`'s
    identities in the arithmetic of ``variant`` (in fp32 mode those of
    :func:`.plf_tree_grad.plf_tree_bwd_torch`); the adjoints of a
    segment's boundary inputs go to ``gbuf`` ``(n_boundaries, S*C,
    n_pad)`` (allocated like ``bbuf`` when None; a bf16 row rounds them)
    for the segments that produced them.  Every per-site value equals the
    kernels'; the site sums run in another order."""
    S, C = states, categories
    pl = node_planes(lcs, rcs, ec, variant, planes)
    lh, ll, rh, rl, eh, el = pl
    lTh, lTl, rTh, rTl, eTh, eTl = transpose_planes(pl, S, C)
    st = lambda x, kh, kl: mxu_stage(x, (kh, kl), variant, S, C)
    og = lambda inp, gout: mxu_op_grad(inp, gout, variant, S, C)
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
            arena[oslot[i]], flag[oslot[i]] = node_mxu_plain(
                _operand(lsrc[i], lflag[i], codes, ttab, bbuf, arena),
                _operand(rsrc[i], rflag[i], codes, ttab, bbuf, arena),
                lcs[e], rcs[e], ec, valid, S, C, variant,
                (lh[e], ll[e], rh[e], rl[e], eh, el))
        root = oslot[end - 1]
        if gout < 0:
            g = torch.where(valid, glik[0], 0.0)
            grr = (arena[root] * g).sum(dim=1)
            arena[root] = rr[:, None] * g
        else:
            arena[root] = gbuf[gout].float()
        for i in range(end - 1, start - 1, -1):
            e = edge[i]
            g_y = torch.where(flag[oslot[i]], arena[oslot[i]] * two32,
                              arena[oslot[i]])
            x1 = _operand(lsrc[i], lflag[i], codes, ttab, bbuf, arena)
            x2 = _operand(rsrc[i], rflag[i], codes, ttab, bbuf, arena)
            u1 = st(x1, lh[e], ll[e])
            u2 = st(x2, rh[e], rl[e])
            g_p = st(g_y, eTh, eTl)
            g_u1 = g_p * u2
            g_u2 = g_p * u1
            gl[e] = og(x1, g_u1)
            gr[e] = og(x2, g_u2)
            gec = gec + og(u1 * u2, g_y)
            for src, fl, gu, kh, kl in ((lsrc[i], lflag[i], g_u1, lTh, lTl),
                                        (rsrc[i], rflag[i], g_u2, rTh, rTl)):
                if fl == 1:
                    arena[src] = st(gu, kh[e], kl[e])
                elif fl == 2:
                    gbuf[src] = st(gu, kh[e], kl[e])
    return gl, gr, gec, grr


# ---------------------------------------------------------------- kernels --


def _check(codes, prog, segs, lcs, rcs, ec, ttab, rr, states, categories,
           variant):
    rows = states * categories
    if variant not in MODES:
        raise ValueError(f"unknown kernel variant {variant!r}")
    if codes.dim() != 2 or codes.dtype not in (torch.int32, torch.int8):
        raise TypeError("codes must be (n_leaves, n_pad) int32 or int8")
    E = lcs.shape[0]
    if tuple(prog.shape) != (6, E) or prog.dtype != torch.int32:
        raise ValueError(f"prog must be (6, {E}) int32, got "
                         f"{tuple(prog.shape)} {prog.dtype}")
    if segs.dim() != 2 or segs.shape[1] != 2 or segs.dtype != torch.int32:
        raise ValueError("segs must be (n_seg, 2) int32")
    for name, t, shape in (("lcs", lcs, (E, rows, states)),
                           ("rcs", rcs, (E, rows, states)),
                           ("ec", ec, (rows, states)), ("rr", rr, (rows,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if ttab.dim() != 2 or ttab.shape[0] != rows \
            or ttab.dtype != torch.float32:
        raise ValueError(f"ttab must be ({rows}, n_codes) float32")
    if any(t.device != codes.device
           for t in (prog, segs, lcs, rcs, ec, ttab, rr)):
        raise ValueError("plf_tree_seg: all tensors must be on one device")


def _check_storage(dtype):
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"boundary storage must be float32 or bfloat16, "
                         f"got {dtype}")


def _check_bwd(codes, bbuf, glik, gbuf, rows):
    n_pad = codes.shape[-1]
    n_bnd = bbuf.shape[0]
    _check_storage(bbuf.dtype)
    for name, t in (("glik", glik), ("bbuf", bbuf), ("gbuf", gbuf)):
        want = (1, n_pad) if name == "glik" else (n_bnd, rows, n_pad)
        dtype = torch.float32 if name == "glik" else bbuf.dtype
        if t is not None and (tuple(t.shape) != want or t.dtype != dtype
                              or t.device != codes.device):
            raise ValueError(f"{name} must be {want} {dtype} on "
                             f"{codes.device}")


def _on_card(name, tensors, aligned):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError(f"{name}: operator stacks and EV constants must "
                         f"be 16-byte aligned")


def _raise_on(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.plf_error_string(err).decode()}")


@functools.cache
def _lib(bf16: bool = False):
    """Build (first use) and load csrc/plf_tree_seg.cu's library for fp32 or
    ``bf16`` storage."""
    from ._build import load_library, storage_library
    lib = load_library(storage_library("plf_tree_seg", bf16))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.plf_tree_seg_launch.argtypes = (
        [vp, ci, vp, ci, vp, ci] + [vp] * 4 + [ci, vp, vp, vp, vp]
        + [ci] * 6 + [vp])
    lib.plf_tree_seg_launch.restype = ci
    lib.plf_error_string.argtypes = [ci]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


def plf_tree_seg(codes, prog, segs, lcs, rcs, ec, ttab, rr, n: int, *,
                 n_boundaries: int, n_slots: int, states: int = 4,
                 categories: int = 4, variant: str = "vpu", planes=None,
                 dtype: torch.dtype = torch.float32):
    """Kernel 7 (or 7m): the segmented whole-tree likelihood.

    Args:
      codes: ``(n_leaves, n_pad)`` int32 or int8 tip codes.
      prog, segs, n_slots: :func:`segment_program` with
        ``reuse_slots=True``; n_boundaries: the plan's.
      lcs, rcs: ``(E, S*C, S)`` operators by original edge; ec ``(S*C,
        S)``; ttab ``(S*C, n_codes)``; rr ``(S*C,)``: as
        :func:`.plf_tree.plf_tree` takes them.
      n: valid site count.
      variant: "vpu" at S = 4 runs kernel 7, anything else kernel 7m
        (:func:`plf_tree_seg_mxu`), whose tip table the caller rounds
        (:func:`.plf_mxu.round_tip_table`).
      planes: kernel 7m only: ``lcs``/``rcs``/``ec`` already split for
        ``variant`` (:func:`.plf_mxu.node_planes`).
      dtype: the boundary storage, ``torch.float32`` or ``torch.bfloat16``.

    Returns:
      ``(lik, sc, bbuf)``: ``(1, n_pad)`` fp32 site likelihoods and int32
      rescale counts (with fp32 boundaries kernel 2's or 2m's, bit for
      bit), and every boundary CLV, ``(n_boundaries, S*C, n_pad)`` in
      ``dtype`` (the VJP's residual).
    """
    if uses_mxu_kernels(variant, states):
        return plf_tree_seg_mxu(codes, prog, segs, lcs, rcs, ec, ttab, rr, n,
                                n_boundaries=n_boundaries, n_slots=n_slots,
                                states=states, categories=categories,
                                variant=variant, planes=planes, dtype=dtype)
    if planes is not None:
        raise ValueError("plf_tree_seg: planes are for the matrix-form "
                         "kernel")
    _check(codes, prog, segs, lcs, rcs, ec, ttab, rr, states, categories,
           variant)
    _check_storage(dtype)
    args = (codes, prog, segs, lcs, rcs, ec, ttab, rr)
    if codes.device.type == "cpu":
        return plf_tree_seg_torch(*args, n, n_boundaries=n_boundaries,
                                  n_slots=n_slots, states=states,
                                  categories=categories, dtype=dtype)
    if codes.device.type != "cuda":
        raise ValueError(f"plf_tree_seg: no kernel for device {codes.device}")
    if not 1 <= categories <= 8:
        raise ValueError(f"plf_tree_seg: the CUDA kernel takes C in 1..8, "
                         f"got C={categories}")
    _on_card("plf_tree_seg", args, (lcs, rcs, ec))
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
    bbuf = torch.empty((n_boundaries, rows, n_pad), dtype=dtype, device=dev)
    lib = _lib(dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        err = lib.plf_tree_seg_launch(
            codes.data_ptr(), codes.element_size(), prog.data_ptr(),
            prog.shape[1], segs.data_ptr(), segs.shape[0], lcs.data_ptr(),
            rcs.data_ptr(), ec.data_ptr(), ttab.data_ptr(), n_codes,
            rr.data_ptr(), bbuf.data_ptr(), lik.data_ptr(), sc.data_ptr(),
            n_slots, int(n), n_pad, categories, threads,
            int(dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "plf_tree_seg")
    count_launch(plf_tree_seg, dtype)
    return lik, sc, bbuf


plf_tree_seg.launches = plf_tree_seg.bf16_launches = 0


@functools.cache
def _lib_mxu(bf16: bool = False):
    """Build (first use) and load csrc/plf_tree_seg_mxu.cu's library for fp32 or
    ``bf16`` storage."""
    from ._build import load_library, storage_library
    lib = load_library(storage_library("plf_tree_seg_mxu", bf16))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.plf_tree_seg_mxu_launch.argtypes = (
        [vp, ci, vp, ci, vp, ci] + [vp] * 7 + [ci, vp, vp, vp, vp]
        + [ci] * 7 + [vp])
    lib.plf_tree_seg_mxu_launch.restype = ci
    lib.plf_error_string.argtypes = [ci]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


def plf_tree_seg_mxu(codes, prog, segs, lcs, rcs, ec, ttab, rr, n: int, *,
                     n_boundaries: int, n_slots: int, states: int = 20,
                     categories: int = 4, variant: str = "mxu_3x",
                     planes=None, dtype: torch.dtype = torch.float32):
    """Kernel 7m: :func:`plf_tree_seg` in the arithmetic of ``variant``
    (any key of :data:`.plf_mxu.MODES`), at any S.  Same arguments and
    results as :func:`plf_tree_seg`; ``ttab`` is taken as given (an exact
    column select), so the caller passes the variant's rounded tip table;
    ``planes`` as :func:`.plf_mxu.node_planes` takes them (split here when
    None)."""
    _check(codes, prog, segs, lcs, rcs, ec, ttab, rr, states, categories,
           variant)
    _check_storage(dtype)
    args = (codes, prog, segs, lcs, rcs, ec, ttab, rr)
    if codes.device.type == "cpu":
        return plf_tree_seg_torch(*args, n, n_boundaries=n_boundaries,
                                  n_slots=n_slots, states=states,
                                  categories=categories, variant=variant,
                                  planes=planes, dtype=dtype)
    if codes.device.type != "cuda":
        raise ValueError(f"plf_tree_seg_mxu: no kernel for device "
                         f"{codes.device}")
    rows = states * categories
    n_codes = ttab.shape[1]
    if not tree_mxu_fits(n_slots, rows, n_codes):
        raise ValueError(f"plf_tree_seg_mxu: a {n_slots}-slot segment arena "
                         f"of {rows} rows does not fit {SMEM_BLOCK_BYTES} "
                         f"bytes of shared memory")
    n_pad = codes.shape[-1]
    if not 0 <= n <= n_pad or n_pad == 0 or n_pad >= 2 ** 31:
        raise ValueError(f"plf_tree_seg_mxu: bad n={n} for n_pad={n_pad}")
    pl = [p.contiguous() for p in node_planes(lcs, rcs, ec, variant, planes)]
    _on_card("plf_tree_seg_mxu", args, pl if states % 4 == 0 else ())
    dev = codes.device
    lik = torch.empty((1, n_pad), dtype=torch.float32, device=dev)
    sc = torch.empty((1, n_pad), dtype=torch.int32, device=dev)
    bbuf = torch.empty((n_boundaries, rows, n_pad), dtype=dtype, device=dev)
    lib = _lib_mxu(dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        err = lib.plf_tree_seg_mxu_launch(
            codes.data_ptr(), codes.element_size(), prog.data_ptr(),
            prog.shape[1], segs.data_ptr(), segs.shape[0],
            *(p.data_ptr() for p in pl), ttab.data_ptr(), n_codes,
            rr.data_ptr(), bbuf.data_ptr(), lik.data_ptr(), sc.data_ptr(),
            n_slots, int(n), n_pad, states, categories, MODES[variant],
            int(dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "plf_tree_seg_mxu")
    count_launch(plf_tree_seg_mxu, dtype)
    return lik, sc, bbuf


plf_tree_seg_mxu.launches = plf_tree_seg_mxu.bf16_launches = 0


@functools.cache
def _lib_bwd(bf16: bool = False):
    """Build (first use) and load csrc/plf_tree_seg_bwd.cu's library for fp32 or
    ``bf16`` storage."""
    from ._build import load_library, storage_library
    lib = load_library(storage_library("plf_tree_seg_bwd", bf16))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.plf_tree_seg_bwd_launch.argtypes = (
        [vp, ci, vp, ci, vp, ci] + [vp] * 7 + [ci] + [vp] * 5
        + [ci] * 7 + [vp])
    lib.plf_tree_seg_bwd_launch.restype = ci
    lib.plf_tree_seg_bwd_occupancy.argtypes = [ci] * 5 + [ctypes.POINTER(ci)]
    lib.plf_tree_seg_bwd_occupancy.restype = ci
    lib.plf_tree_seg_bwd_reduce.argtypes = [vp, ci, ci, vp, vp]
    lib.plf_tree_seg_bwd_reduce.restype = ci
    lib.plf_error_string.argtypes = [ci]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _resident_blocks(device: torch.device, code_bytes: int, categories: int,
                     n_codes: int, seg_ops: int, bf16: bool = False) -> int:
    """Kernel-8 blocks resident on the whole card at once (blocks per SM,
    registers and shared memory counted by the CUDA runtime, times the
    SMs) for the storage form ``bf16`` or fp32: the launch is one wave."""
    lib = _lib_bwd(bf16)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.plf_tree_seg_bwd_occupancy(code_bytes, categories, n_codes,
                                             seg_ops, int(bf16),
                                             ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"plf_tree_seg_bwd occupancy query failed: "
                           f"{lib.plf_error_string(err).decode()}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return blocks.value * sms


def _split_sums(out, E, rows, S):
    """``(gl, gr, gec, grr)`` views of one row of fixed-order site sums."""
    RS = rows * S
    return (out[:E * RS].view(E, rows, S),
            out[E * RS:2 * E * RS].view(E, rows, S),
            out[2 * E * RS:2 * E * RS + RS].view(rows, S),
            out[2 * E * RS + RS:])


def plf_tree_seg_bwd(codes, prog, segs, lcs, rcs, ec, ttab, rr, glik, bbuf,
                     n: int, *, seg_ops: int, states: int = 4,
                     categories: int = 4, variant: str = "vpu", planes=None,
                     gbuf=None, max_scratch_bytes: Optional[int] = None):
    """Kernel 8 (or 8m): the VJP of kernel 7's (7m's) site likelihoods
    w.r.t. its operators.

    Args:
      prog, segs: :func:`segment_program` with ``reuse_slots=False``
        (the same plan as the forward's); seg_ops: the plan's, the most
        ops in a segment (the kernel stops on a segment with more).
      glik: ``(1, n_pad)`` cotangent; bbuf: the forward's boundary CLVs,
        fp32 or bf16 (the storage of the adjoint chain ``gbuf`` too).
        The rest as :func:`plf_tree_seg` (the kernels take the transposed
        operators too, made here: :func:`.plf_grad.
        transpose_lane_constants`, or the transposed planes,
        :func:`.plf_mxu.transpose_planes`).
      variant: "vpu" at S = 4 runs kernel 8, anything else kernel 8m
        (:func:`plf_tree_seg_bwd_mxu`, which alone reads ``planes`` and
        ``max_scratch_bytes``).
      gbuf: where the boundary adjoints go, ``bbuf``'s shape and type
        (scratch, allocated when None; passed to inspect them).

    Returns:
      ``(gl, gr, gec, grr)``: ``(E, S*C, S)``, ``(E, S*C, S)``, ``(S*C,
      S)`` and ``(S*C,)`` fp32 site sums, by original edge.
    """
    if uses_mxu_kernels(variant, states):
        return plf_tree_seg_bwd_mxu(
            codes, prog, segs, lcs, rcs, ec, ttab, rr, glik, bbuf, n,
            seg_ops=seg_ops, states=states, categories=categories,
            variant=variant, planes=planes, gbuf=gbuf,
            max_scratch_bytes=max_scratch_bytes)
    if planes is not None:
        raise ValueError("plf_tree_seg_bwd: planes are for the matrix-form "
                         "kernel")
    _check(codes, prog, segs, lcs, rcs, ec, ttab, rr, states, categories,
           variant)
    rows = states * categories
    _check_bwd(codes, bbuf, glik, gbuf, rows)
    args = (codes, prog, segs, lcs, rcs, ec, ttab, rr, glik, bbuf)
    if codes.device.type == "cpu":
        return plf_tree_seg_bwd_torch(*args, n, states=states,
                                      categories=categories, gbuf=gbuf)
    if codes.device.type != "cuda":
        raise ValueError(f"plf_tree_seg_bwd: no kernel for device "
                         f"{codes.device}")
    if not 1 <= categories <= 8:
        raise ValueError(f"plf_tree_seg_bwd: the CUDA kernel takes C in "
                         f"1..8, got C={categories}")
    lcsT, rcsT, ecT = (transpose_lane_constants(t, states, categories)
                       for t in (lcs, rcs, ec))
    _on_card("plf_tree_seg_bwd", args, (lcs, rcs, lcsT, rcsT, ec, ecT))
    n_pad = codes.shape[-1]
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
    bf16 = bbuf.dtype == torch.bfloat16
    resident = _resident_blocks(dev, codes.element_size(), categories,
                                n_codes, seg_ops, bf16)
    per = -(-tiles // resident)
    n_blocks = -(-tiles // per)
    E, RS = lcs.shape[0], rows * states
    cols = 2 * E * RS + RS + rows
    partial = torch.empty((n_blocks, cols), dtype=torch.float32, device=dev)
    out = torch.empty(cols, dtype=torch.float32, device=dev)
    if gbuf is None:
        gbuf = torch.empty_like(bbuf)
    lib = _lib_bwd(bf16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.plf_tree_seg_bwd_launch(
            codes.data_ptr(), codes.element_size(), prog.data_ptr(), E,
            segs.data_ptr(), segs.shape[0], lcs.data_ptr(), rcs.data_ptr(),
            lcsT.data_ptr(), rcsT.data_ptr(), ec.data_ptr(), ecT.data_ptr(),
            ttab.data_ptr(), n_codes, rr.data_ptr(), glik.data_ptr(),
            bbuf.data_ptr(), gbuf.data_ptr(), partial.data_ptr(), seg_ops,
            n_blocks, per, int(n), n_pad, categories, int(bf16), stream)
        if err == 0:
            err = lib.plf_tree_seg_bwd_reduce(partial.data_ptr(), n_blocks,
                                              cols, out.data_ptr(), stream)
    _raise_on(lib, err, "plf_tree_seg_bwd")
    count_launch(plf_tree_seg_bwd, bbuf.dtype)
    return _split_sums(out, E, rows, states)


plf_tree_seg_bwd.launches = plf_tree_seg_bwd.bf16_launches = 0


@functools.cache
def _lib_bwd_mxu(bf16: bool = False):
    """Build (first use) and load csrc/plf_tree_seg_bwd_mxu.cu's library for fp32 or
    ``bf16`` storage."""
    from ._build import load_library, storage_library
    lib = load_library(storage_library("plf_tree_seg_bwd_mxu", bf16))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.plf_tree_seg_bwd_mxu_launch.argtypes = (
        [vp, ci, vp, ci, vp, ci] + [vp] * 13 + [ci] + [vp] * 6 + [ci] * 3
        + [vp] * 2 + [ci] * 9 + [vp])
    lib.plf_tree_seg_bwd_mxu_launch.restype = ci
    lib.plf_tree_seg_bwd_mxu_reduce.argtypes = [vp, ci, ci, vp, vp]
    lib.plf_tree_seg_bwd_mxu_reduce.restype = ci
    lib.plf_tree_seg_bwd_mxu_plan.argtypes = ([ci] * 5
                                              + [ctypes.POINTER(ci)] * 3)
    lib.plf_tree_seg_bwd_mxu_plan.restype = ci
    lib.plf_error_string.argtypes = [ci]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _launch_plan_mxu(device: torch.device, code_bytes: int, states: int,
                     categories: int, mode: int,
                     bf16: bool = False) -> Tuple[bool, int, int]:
    """``(acc_shared, resident, sites)`` of kernel 8m's fp32 or ``bf16``
    storage form, as its library decides them with kernel 4m's rule
    (``plf_tree_seg_bwd_mxu_plan``): the accumulators in shared memory or
    in a row of device memory per block (shared memory when two blocks with
    it fit an SM); the blocks resident on the whole card at once; and the sites
    per tile."""
    lib = _lib_bwd_mxu(bf16)
    acc_shared, blocks, sites = (ctypes.c_int(0) for _ in range(3))
    with torch.cuda.device(device):
        err = lib.plf_tree_seg_bwd_mxu_plan(code_bytes, states, categories,
                                            mode, int(bf16),
                                            ctypes.byref(acc_shared),
                                            ctypes.byref(blocks),
                                            ctypes.byref(sites))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"plf_tree_seg_bwd_mxu occupancy query failed: "
                           f"{lib.plf_error_string(err).decode()}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return bool(acc_shared.value), blocks.value * sms, sites.value


def plf_tree_seg_bwd_mxu(codes, prog, segs, lcs, rcs, ec, ttab, rr, glik,
                         bbuf, n: int, *, seg_ops: int, states: int = 20,
                         categories: int = 4, variant: str = "mxu_3x",
                         planes=None, gbuf=None,
                         max_scratch_bytes: Optional[int] = None):
    """Kernel 8m: :func:`plf_tree_seg_bwd` in the arithmetic of
    ``variant`` (any key of :data:`.plf_mxu.MODES`), at any S.

    Same arguments and results as :func:`plf_tree_seg_bwd`.  The op
    checkpoint, ``seg_ops`` fp32 CLVs and flag bytes per site, lives in
    device memory; the wrapper launches over chunks of sites so that it
    fits ``max_scratch_bytes`` (default half the card's free memory), as
    kernel 4m does (:func:`.plf_tree_grad.tree_bwd_chunk_sites`).
    ``plf_tree_seg_bwd_mxu.last_scratch`` records the last call's chunking
    and where its accumulators lived.  On the card bf16 storage takes
    every variant but "mxu_bf16", which no gradient backend trains.
    """
    _check(codes, prog, segs, lcs, rcs, ec, ttab, rr, states, categories,
           variant)
    rows = states * categories
    _check_bwd(codes, bbuf, glik, gbuf, rows)
    args = (codes, prog, segs, lcs, rcs, ec, ttab, rr, glik, bbuf)
    if codes.device.type == "cpu":
        return plf_tree_seg_bwd_torch(*args, n, states=states,
                                      categories=categories, variant=variant,
                                      planes=planes, gbuf=gbuf)
    if codes.device.type != "cuda":
        raise ValueError(f"plf_tree_seg_bwd_mxu: no kernel for device "
                         f"{codes.device}")
    if not 1 <= categories <= 8:
        raise ValueError(f"plf_tree_seg_bwd_mxu takes C in 1..8, got "
                         f"C={categories}")
    S, C = states, categories
    pl = [p.contiguous() for p in node_planes(lcs, rcs, ec, variant, planes)]
    tpl = transpose_planes(pl, S, C)
    ordered = pl[:4] + list(tpl[:4]) + pl[4:] + list(tpl[4:])
    _on_card("plf_tree_seg_bwd_mxu", args, ordered if S % 4 == 0 else ())
    n_pad = codes.shape[-1]
    if n_pad % GRAD_THREADS or n_pad >= 2 ** 31 or not 0 <= n <= n_pad:
        raise ValueError(f"plf_tree_seg_bwd_mxu: n_pad={n_pad} must be a "
                         f"positive multiple of {GRAD_THREADS} and "
                         f"0 <= n={n} <= n_pad")
    bf16 = bbuf.dtype == torch.bfloat16
    if bf16 and variant == "mxu_bf16":
        raise ValueError("plf_tree_seg_bwd_mxu: bf16 storage has no "
                         "'mxu_bf16' form (no gradient backend trains "
                         "'mxu_bf16')")
    lib = _lib_bwd_mxu(bf16)
    dev = codes.device
    if gbuf is None:
        gbuf = torch.empty_like(bbuf)
    if max_scratch_bytes is None:
        max_scratch_bytes = torch.cuda.mem_get_info(dev)[0] // 2
    chunk = tree_bwd_chunk_sites(n_pad, seg_ops, rows, max_scratch_bytes)
    E, RS = lcs.shape[0], rows * S
    cols = 2 * E * RS + RS + rows
    acc_shared, resident, ts = _launch_plan_mxu(
        dev, codes.element_size(), S, C, MODES[variant], bf16)
    n_blocks, _ = tree_bwd_mxu_blocks(chunk, cols, resident, ts)
    partial = torch.empty((n_blocks, cols), dtype=torch.float32, device=dev)
    acc = None if acc_shared else torch.empty(
        (n_blocks, acc_floats(S, C)), dtype=torch.float32,
        device=dev)
    scratch = torch.empty((seg_ops, rows, chunk), dtype=torch.float32,
                          device=dev)
    flags = torch.empty((seg_ops, chunk), dtype=torch.uint8, device=dev)
    out = torch.empty(cols, dtype=torch.float32, device=dev)
    chunks = range(0, n_pad, chunk)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k, site0 in enumerate(chunks):
            sites = min(chunk, n_pad - site0)
            tiles = sites // ts
            per = -(-tiles // n_blocks)
            err = lib.plf_tree_seg_bwd_mxu_launch(
                codes.data_ptr(), codes.element_size(), prog.data_ptr(), E,
                segs.data_ptr(), segs.shape[0],
                *(p.data_ptr() for p in ordered), ttab.data_ptr(),
                ttab.shape[1], rr.data_ptr(), glik.data_ptr(),
                bbuf.data_ptr(), gbuf.data_ptr(), scratch.data_ptr(),
                flags.data_ptr(), seg_ops, site0, sites, partial.data_ptr(),
                None if acc is None else acc.data_ptr(), int(k > 0),
                -(-tiles // per), per, int(n), n_pad, S, C, MODES[variant],
                int(bf16), stream)
            if err != 0:
                break
        else:
            err = lib.plf_tree_seg_bwd_mxu_reduce(
                partial.data_ptr(), n_blocks, cols, out.data_ptr(), stream)
    _raise_on(lib, err, "plf_tree_seg_bwd_mxu")
    count_launch(plf_tree_seg_bwd_mxu, bbuf.dtype)
    plf_tree_seg_bwd_mxu.last_scratch = dict(
        chunk_sites=chunk, chunks=len(chunks), blocks=n_blocks,
        bytes=tree_bwd_scratch_bytes(seg_ops, rows, chunk),
        acc_shared=acc_shared, tile_sites=ts)
    return _split_sums(out, E, rows, S)


plf_tree_seg_bwd_mxu.launches = plf_tree_seg_bwd_mxu.bf16_launches = 0
plf_tree_seg_bwd_mxu.last_scratch = None


# ----------------------------------------------------------- differentiable --


class _SegDiff(torch.autograd.Function):
    """Kernel 7 (7m) forward, kernel 8 (8m) backward; the residual is the
    boundary buffer in its storage type (and the small operand arrays and
    operator planes), never an op CLV."""

    @staticmethod
    def forward(ctx, codes, lcs, rcs, ec, ttab, rr, fwd, bwd, n, plan,
                n_slots, states, categories, variant, planes, dtype):
        lik, sc, bbuf = plf_tree_seg(
            codes, fwd[0], fwd[1], lcs, rcs, ec, ttab, rr, n,
            n_boundaries=plan.n_boundaries, n_slots=n_slots, states=states,
            categories=categories, variant=variant, planes=planes,
            dtype=dtype)
        ctx.seg_ops = plan.seg_ops
        ctx.save_for_backward(codes, bwd[0], bwd[1], lcs, rcs, ec, ttab, rr,
                              bbuf)
        ctx.n, ctx.states, ctx.categories = n, states, categories
        ctx.variant, ctx.planes = variant, planes
        ctx.mark_non_differentiable(sc)
        return lik, sc

    @staticmethod
    def backward(ctx, glik, _g_sc):
        codes, prog, segs, lcs, rcs, ec, ttab, rr, bbuf = ctx.saved_tensors
        gl, gr, gec, grr = plf_tree_seg_bwd(
            codes, prog, segs, lcs, rcs, ec, ttab, rr, glik.contiguous(),
            bbuf, ctx.n, seg_ops=ctx.seg_ops, states=ctx.states,
            categories=ctx.categories, variant=ctx.variant,
            planes=ctx.planes)
        return (None, gl, gr, gec, None, grr) + (None,) * 10


def make_tree_diff_segmented(schedule: Sequence[Tuple], n_leaves: int, *,
                             states: int = 4, categories: int = 4,
                             cap_ops: Optional[int] = None,
                             n_codes: int = 16, variant: str = "vpu",
                             dtype: str = "float32"):
    """Differentiable segmented whole-tree likelihood, with the contract
    of :func:`.plf_tree_grad.make_tree_diff`: ``fn(codes, lcs, rcs, ec,
    ttab, rr, n, planes=None) -> (lik, sc)``, operators by original edge,
    ``rr`` ``(S*C,)``; differentiable in lcs, rcs, ec and rr.  "vpu" at
    S = 4 runs kernel 7 forward and kernel 8 backward ("planes" must be
    None), every other ``variant`` kernels 7m and 8m on ``planes`` (split
    here when None); one launch each.  ``dtype="bfloat16"`` stores the
    boundary CLVs and their adjoints in bf16 (the JAX function's
    ``dtype``).  ``fn.plan`` is the plan, cut by the capacity rule of the
    kernels that run (the JAX package's plan for the same schedule and
    ``cap_ops``), whatever ``dtype``."""
    if variant not in MODES:
        raise ValueError(f"unknown kernel variant {variant!r}")
    storage = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rows = states * categories
    pos_sched = [(p, l, r, 0.0, 0.0, i)
                 for i, (p, l, r, *_x) in enumerate(schedule)]
    plan = plan_segments(pos_sched, n_leaves, rows=rows, cap_ops=cap_ops,
                         n_codes=n_codes,
                         matrix_form=uses_mxu_kernels(variant, states))
    fwd_np = segment_program(plan, schedule, reuse_slots=True)
    bwd_np = segment_program(plan, schedule, reuse_slots=False)
    n_slots = fwd_np[2]
    on_device = {}

    def fn(codes, lcs, rcs, ec, ttab, rr, n, planes=None):
        dev = codes.device
        if dev not in on_device:
            on_device[dev] = tuple(
                tuple(torch.as_tensor(a, device=dev) for a in p[:2])
                for p in (fwd_np, bwd_np))
        fwd, bwd = on_device[dev]
        if planes is not None:
            planes = tuple(p.detach() for p in planes)
        return _SegDiff.apply(codes, lcs, rcs, ec, ttab, rr, fwd, bwd,
                              int(n), plan, n_slots, states, categories,
                              variant, planes, storage)

    fn.plan = plan
    return fn
