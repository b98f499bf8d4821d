"""Kernels 4 and 4m: the checkpointed whole-tree backward, and the
differentiable whole-tree likelihood.

Counterpart of ``plf_tpu/ops/plf_tree_grad.py``.  Replaces
``_tree_bwd_kernel`` (``plf_tree_grad.py:110``, launched by
``_tree_bwd_call`` ``:229``) with ``csrc/plf_tree_bwd.cu``:

* phase 1 recomputes the forward and checkpoints every internal CLV and
  its rescale flag;
* the root adjoint is seeded with ``rr * g`` and ``grr`` accumulated;
* phase 2 sweeps the schedule in reverse; a node's slot flips from its
  CLV to its adjoint, and the per-edge ``gl``/``gr``, ``gec`` and ``grr``
  are summed over all sites.

A block of 128 threads takes its tiles of 128 sites through both phases
in turn; the operand an op takes from the op just before it (the child
evaluated last) stays in registers in both sweeps, and each warp sums its
own sites (``csrc/plf_grad.cuh``).  A launch is one wave of the blocks
resident on the card (:func:`tree_bwd_resident_blocks`).

The adjoint identities are those of :mod:`.plf_grad`;
:func:`.plf_grad.transpose_lane_constants` transposes a whole ``(E, S*C,
S)`` operator stack at once (the "vpu" branch of the JAX package's
``transpose_operator_stack``).

Kernel 4m (``csrc/plf_tree_bwd_mxu.cu``, :func:`plf_tree_bwd_mxu`) is the
MXU form of the same TPU kernel (its ``is_mxu`` branches, through
``make_mxu_bwd_ops``) for the "mxu", "mxu_3x" and "mxu_bf16" variants and
"vpu" at S != 4, the backward of kernel 2m.  It takes the lane constants
and their operator planes (``ops/plf_mxu.py``), as kernel 2m does, never
the JAX package's ``(rows, rows)`` block matrices: the block gradient's
entries off the lane-constant positions never reach a branch length, so
it returns the ``(E, S*C, S)`` lane-constant gradients
(:func:`plf_mxu.mxu_op_grad`).  Its checkpoint is ``E * (rows * 4 + 1)``
bytes per site, chunked by the same rule.  It sweeps tiles of the sites
its library's plan gives (32 at S = 20, 8 at S = 61) and sums the
operator gradients of a tile as GEMMs over its sites: on the tensor cores
in "mxu_3x" and "mxu_bf16", whose products are exact bf16 products, and
register-blocked fp32 on the CUDA cores in "mxu"; the per-site values
keep the plain version's arithmetic bit for bit.

Operators are indexed by ORIGINAL edge, as kernel 2 reads them (row 5 of
its schedule) and as ``PhyloModel.lcs`` holds them, through the forward
and the backward alike; the JAX factory indexes them by schedule position
instead (``plf_tree_grad.py:328-329``).

Capacity rule.  The TPU kernel keeps ``n_leaves + E`` CLV slots per site
block in ~10 MiB of VMEM (``tree_bwd_vmem_bytes``).  A Hopper block has
227 KB of shared memory, ~22 sites' worth of checkpoints at 159 nodes, so
the checkpoint lives in device memory: ``E`` slots of ``S*C`` floats plus
one flag byte per site (tips are expanded from their codes, never
stored).  The wrapper launches over chunks of sites so that this scratch
fits a budget, half the card's free memory by default
(:func:`tree_bwd_chunk_sites`); at 160 taxa x 2^20 sites one chunk is
10.8 GB.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .plf_grad import GRAD_THREADS, op_grad, transpose_lane_constants
from .plf_mxu import (MODES, mxu_op_grad, mxu_stage, node_mxu_plain,
                      node_planes, transpose_planes, uses_mxu_kernels)
from .plf_node import node_plain, stage
from .plf_tree import compile_register_schedule, plf_tree

__all__ = ["compile_backward_schedule", "backward_schedule",
           "tree_bwd_scratch_bytes", "tree_bwd_chunk_sites",
           "tree_bwd_resident_blocks", "plf_tree_bwd",
           "plf_tree_bwd_torch", "plf_tree_bwd_mxu", "plf_tree_bwd_mxu_torch",
           "tree_bwd_mxu_blocks", "acc_floats", "make_tree_diff"]


def compile_backward_schedule(schedule: Sequence[Tuple], n_leaves: int):
    """Unified operand positions for the checkpointed backward: for
    schedule entry i, ``(lpos[i], rpos[i])`` is a tip id (``< n_leaves``)
    or ``n_leaves + j`` for the CLV of schedule entry j.  Returns two int32
    arrays of length E, as the JAX package's function does."""
    pos_of = {entry[0]: n_leaves + i for i, entry in enumerate(schedule)}
    lpos = [node if node < n_leaves else pos_of[node]
            for (_, node, _r, *_rest) in schedule]
    rpos = [node if node < n_leaves else pos_of[node]
            for (_, _l, node, *_rest) in schedule]
    return np.asarray(lpos, np.int32), np.asarray(rpos, np.int32)


def backward_schedule(schedule: Sequence[Tuple], n_leaves: int) -> np.ndarray:
    """The ``(3, E)`` int32 schedule that kernels 4 and 4m take for a
    reordered schedule: rows lpos, rpos (:func:`compile_backward_schedule`)
    and eidx, the original edge of each entry."""
    eidx = np.asarray([entry[5] for entry in schedule], np.int32)
    return np.stack(compile_backward_schedule(schedule, n_leaves) + (eidx,))


def tree_bwd_scratch_bytes(n_edges: int, rows: int, sites: int) -> int:
    """Device-memory checkpoint of kernels 4 and 4m for ``sites`` sites:
    ``E`` fp32 CLVs of ``rows`` rows and ``E`` flag bytes per site."""
    return n_edges * (rows * 4 + 1) * sites


def tree_bwd_chunk_sites(n_pad: int, n_edges: int, rows: int,
                         budget: int) -> int:
    """Sites per kernel-4 (or 4m) launch: all ``n_pad`` if their
    checkpoint fits ``budget`` bytes, else the most whole 128-site tiles
    that fit (``rows`` 16 for DNA, 80 or 244 for protein and codon models
    at C = 4)."""
    per_tile = tree_bwd_scratch_bytes(n_edges, rows, GRAD_THREADS)
    tiles = budget // per_tile
    if tiles < 1:
        raise ValueError(f"kernel 4 needs {per_tile} bytes of scratch for "
                         f"one tile of {GRAD_THREADS} sites; budget {budget}")
    return min(n_pad, tiles * GRAD_THREADS)


def _operand(pos, codes, ttab, arena):
    n_leaves = codes.shape[0]
    if pos < n_leaves:
        return ttab[:, codes[pos].long()]
    return arena[pos - n_leaves]


def plf_tree_bwd_torch(codes, bsched, lcs, rcs, lcsT, rcsT, ec, ecT, ttab,
                       rr, glik, n: int, *, states: int = 4,
                       categories: int = 4):
    """Plain version of kernel 4 (the arguments and results of
    :func:`plf_tree_bwd`, which keeps every CLV instead of a chunked
    checkpoint), on the device of its inputs, in the kernel's op order."""
    S, C = states, categories
    n_pad = codes.shape[-1]
    valid = torch.arange(n_pad, device=codes.device) < n
    lpos, rpos, eidx = bsched.cpu().tolist()
    E = len(eidx)
    arena, flag = [None] * E, [None] * E
    for i in range(E):
        arena[i], flag[i] = node_plain(
            _operand(lpos[i], codes, ttab, arena),
            _operand(rpos[i], codes, ttab, arena), lcs[eidx[i]],
            rcs[eidx[i]], ec, valid, S, C)
    g = torch.where(valid, glik[0], 0.0)
    grr = (arena[-1] * g).sum(dim=1)
    arena[-1] = rr[:, None] * g
    gl, gr = torch.zeros_like(lcs), torch.zeros_like(rcs)
    gec = torch.zeros_like(ec)
    two32 = float(2.0 ** 32)
    for i in range(E - 1, -1, -1):
        e = eidx[i]
        g_y = torch.where(flag[i], arena[i] * two32, arena[i])
        x1 = _operand(lpos[i], codes, ttab, arena)
        x2 = _operand(rpos[i], codes, ttab, arena)
        u1 = stage(x1, lcs[e], S, C)
        u2 = stage(x2, rcs[e], S, C)
        g_p = stage(g_y, ecT, S, C)
        g_u1 = g_p * u2
        g_u2 = g_p * u1
        gl[e] = op_grad(x1, g_u1, S, C)
        gr[e] = op_grad(x2, g_u2, S, C)
        gec = gec + op_grad(u1 * u2, g_y, S, C)
        for pos, gu, opT in ((lpos[i], g_u1, lcsT), (rpos[i], g_u2, rcsT)):
            if pos >= codes.shape[0]:
                arena[pos - codes.shape[0]] = stage(gu, opT[e], S, C)
    return gl, gr, gec, grr


def _check(codes, bsched, stacks, consts, ttab, rr, glik, states,
           categories):
    """Shapes, types and device of a tree-backward call: ``stacks`` are
    ``(E, S*C, S)`` operator stacks, ``consts`` ``(S*C, S)`` constants (both
    dicts by name)."""
    rows = states * categories
    if codes.dim() != 2 or codes.dtype not in (torch.int32, torch.int8):
        raise TypeError("codes must be (n_leaves, n_pad) int32 or int8")
    E = next(iter(stacks.values())).shape[0]
    if tuple(bsched.shape) != (3, E) or bsched.dtype != torch.int32:
        raise ValueError(f"bsched must be (3, {E}) int32, got "
                         f"{tuple(bsched.shape)} {bsched.dtype}")
    named = ([(k, t, (E, rows, states)) for k, t in stacks.items()]
             + [(k, t, (rows, states)) for k, t in consts.items()]
             + [("rr", rr, (rows,)), ("glik", glik, (1, codes.shape[-1]))])
    for name, t, shape in named:
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if ttab.dim() != 2 or ttab.shape[0] != rows \
            or ttab.dtype != torch.float32:
        raise ValueError(f"ttab must be ({rows}, n_codes) float32")
    ts = [codes, bsched, ttab, rr, glik, *stacks.values(), *consts.values()]
    if any(t.device != codes.device for t in ts):
        raise ValueError("plf_tree_bwd: all tensors must be on one device")


@functools.cache
def _lib():
    """Build (first use) and load csrc/plf_tree_bwd.cu, with its C
    prototypes."""
    from ._build import load_library
    lib = load_library("plf_tree_bwd")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.plf_tree_bwd_launch.argtypes = (
        [vp, ci, ci, vp, ci] + [vp] * 7 + [ci, vp, vp, vp, vp, ci, ci, vp,
                                            ci, ci, ci, ci, ci, vp])
    lib.plf_tree_bwd_launch.restype = ci
    lib.plf_tree_bwd_occupancy.argtypes = [ci] * 3 + [ctypes.POINTER(ci)]
    lib.plf_tree_bwd_occupancy.restype = ci
    lib.plf_tree_bwd_reduce.argtypes = [vp, ci, ci, vp, vp]
    lib.plf_tree_bwd_reduce.restype = ci
    lib.plf_error_string.argtypes = [ci]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def tree_bwd_resident_blocks(device: torch.device, code_bytes: int,
                             categories: int, n_codes: int) -> int:
    """Kernel-4 blocks resident on the whole card at once (blocks per SM,
    registers and shared memory counted by the CUDA runtime, times the
    SMs): each launch is one wave of at most this many blocks."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.plf_tree_bwd_occupancy(code_bytes, categories, n_codes,
                                         ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"plf_tree_bwd occupancy query failed: "
                           f"{lib.plf_error_string(err).decode()}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return blocks.value * sms


def plf_tree_bwd(codes, bsched, lcs, rcs, lcsT, rcsT, ec, ecT, ttab, rr,
                 glik, n: int, *, states: int = 4, categories: int = 4,
                 max_scratch_bytes: Optional[int] = None):
    """VJP of the fused whole-tree likelihood (kernel 2) w.r.t. its
    operators.

    Args:
      codes: ``(n_leaves, n_pad)`` int32 or int8 tip codes.
      bsched: ``(3, E)`` int32 rows lpos, rpos and eidx
        (:func:`backward_schedule`).
      lcs, rcs: ``(E, S*C, S)`` per-edge operators by original edge;
        lcsT, rcsT: their transposes (:func:`transpose_lane_constants`).
      ec, ecT: ``(S*C, S)`` EV constants and their transpose; ttab:
        ``(S*C, n_codes)`` tip table; rr: ``(S*C,)`` root row vector.
      glik: ``(1, n_pad)`` cotangent of the site likelihoods.
      n: valid site count; padding sites contribute nothing.
      max_scratch_bytes: checkpoint budget of one launch; default half
        the card's free memory.

    Returns:
      ``(gl, gr, gec, grr)``: ``(E, S*C, S)``, ``(E, S*C, S)``,
      ``(S*C, S)`` and ``(S*C,)`` fp32 site sums.  ``plf_tree_bwd.
      last_scratch`` records the last launch's chunking.
    """
    args = (codes, bsched, lcs, rcs, lcsT, rcsT, ec, ecT, ttab, rr, glik)
    _check(codes, bsched, dict(lcs=lcs, rcs=rcs, lcsT=lcsT, rcsT=rcsT),
           dict(ec=ec, ecT=ecT), ttab, rr, glik, states, categories)
    if codes.device.type == "cpu":
        return plf_tree_bwd_torch(*args, n, states=states,
                                  categories=categories)
    if codes.device.type != "cuda":
        raise ValueError(f"plf_tree_bwd: no kernel for device "
                         f"{codes.device}")
    if states != 4 or not 1 <= categories <= 8:
        raise ValueError("the CUDA tree backward takes S = 4 and C in 1..8, "
                         f"got S={states}, C={categories}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("plf_tree_bwd: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (lcs, rcs, lcsT, rcsT, ec, ecT)):
        raise ValueError("plf_tree_bwd: operator stacks and EV constants "
                         "must be 16-byte aligned")
    n_leaves, n_pad = codes.shape
    E, rows, S = lcs.shape
    if n_pad % GRAD_THREADS or n_pad >= 2 ** 31 or not 0 <= n <= n_pad:
        raise ValueError(f"plf_tree_bwd: n_pad={n_pad} must be a positive "
                         f"multiple of {GRAD_THREADS} and 0 <= n={n} <= n_pad")
    lib = _lib()
    dev = codes.device
    if max_scratch_bytes is None:
        max_scratch_bytes = torch.cuda.mem_get_info(dev)[0] // 2
    chunk = tree_bwd_chunk_sites(n_pad, E, rows, max_scratch_bytes)
    resident = tree_bwd_resident_blocks(dev, codes.element_size(),
                                        categories, ttab.shape[1])
    plan, n_rows = [], 0
    for site0 in range(0, n_pad, chunk):
        sites = min(chunk, n_pad - site0)
        tiles = sites // GRAD_THREADS
        per = -(-tiles // resident)
        n_blocks = -(-tiles // per)
        plan.append((site0, sites, n_rows, n_blocks, per))
        n_rows += n_blocks
    RS = rows * S
    cols = 2 * E * RS + RS + rows
    partial = torch.empty((n_rows, cols), dtype=torch.float32, device=dev)
    scratch = torch.empty((E, rows, chunk), dtype=torch.float32, device=dev)
    flags = torch.empty((E, chunk), dtype=torch.uint8, device=dev)
    out = torch.empty(cols, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for site0, sites, row0, n_blocks, per in plan:
            err = lib.plf_tree_bwd_launch(
                codes.data_ptr(), codes.element_size(), n_leaves,
                bsched.data_ptr(), E, lcs.data_ptr(), rcs.data_ptr(),
                lcsT.data_ptr(), rcsT.data_ptr(), ec.data_ptr(),
                ecT.data_ptr(), ttab.data_ptr(), ttab.shape[1],
                rr.data_ptr(), glik.data_ptr(), scratch.data_ptr(),
                flags.data_ptr(), site0, sites, partial[row0].data_ptr(),
                n_blocks, per, int(n), n_pad, categories, stream)
            if err != 0:
                break
        else:
            err = lib.plf_tree_bwd_reduce(partial.data_ptr(), n_rows, cols,
                                          out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"plf_tree_bwd kernel launch failed: "
                           f"{lib.plf_error_string(err).decode()}")
    plf_tree_bwd.launches += 1
    plf_tree_bwd.last_scratch = dict(
        chunk_sites=chunk, chunks=len(plan),
        bytes=tree_bwd_scratch_bytes(E, rows, chunk))
    gl = out[:E * RS].view(E, rows, S)
    gr = out[E * RS:2 * E * RS].view(E, rows, S)
    gec = out[2 * E * RS:2 * E * RS + RS].view(rows, S)
    return gl, gr, gec, out[2 * E * RS + RS:]


plf_tree_bwd.launches = 0
plf_tree_bwd.last_scratch = None


# ------------------------------------------------------------ kernel 4m --

#: Device memory the per-block partial rows of one kernel-4m call may take
#: (3.75 MB a row at S = 61, 31 edges: at most 572 blocks).
TREE_BWD_MXU_PARTIAL_BYTES = 1 << 31


def tree_bwd_mxu_blocks(n_sites: int, cols: int, resident: int, sites: int):
    """``(n_blocks, tiles_per_block)`` of a kernel-4m (or 8m) launch over
    ``n_sites`` in tiles of ``sites`` (the library's plan: 32 at S = 20, 8
    at S = 61; each divides the 128-site padding unit, so every chunk is
    whole tiles): at most ``resident`` blocks (all that fit the card at
    once, so the launch is one wave with no tail) and at most
    :data:`TREE_BWD_MXU_PARTIAL_BYTES` of partial rows of ``cols`` floats,
    each block with at least one tile."""
    if n_sites % sites:
        raise ValueError(f"{n_sites} sites are not whole tiles of {sites}")
    tiles = n_sites // sites
    cap = max(1, min(resident, TREE_BWD_MXU_PARTIAL_BYTES // (4 * cols)))
    per = -(-tiles // cap)
    return -(-tiles // per), per


def plf_tree_bwd_mxu_torch(codes, bsched, lcs, rcs, ec, ttab, rr, glik,
                           n: int, *, states: int = 20, categories: int = 4,
                           variant: str = "mxu_3x", planes=None):
    """Plain version of kernel 4m (the arguments and results of
    :func:`plf_tree_bwd_mxu`, keeping every CLV instead of a chunked
    checkpoint), on the device of its inputs, in the kernel's op order:
    every per-site intermediate equals the kernel's; the site sums run in
    another order (:func:`plf_mxu.mxu_op_grad`)."""
    S, C = states, categories
    pl = node_planes(lcs, rcs, ec, variant, planes)
    lh, ll, rh, rl, eh, el = pl
    lTh, lTl, rTh, rTl, eTh, eTl = transpose_planes(pl, S, C)
    st = lambda x, kh, kl: mxu_stage(x, (kh, kl), variant, S, C)
    og = lambda inp, gout: mxu_op_grad(inp, gout, variant, S, C)
    n_pad = codes.shape[-1]
    valid = torch.arange(n_pad, device=codes.device) < n
    lpos, rpos, eidx = bsched.cpu().tolist()
    E = len(eidx)
    arena, flag = [None] * E, [None] * E
    for i in range(E):
        e = eidx[i]
        arena[i], flag[i] = node_mxu_plain(
            _operand(lpos[i], codes, ttab, arena),
            _operand(rpos[i], codes, ttab, arena), lcs[e], rcs[e], ec,
            valid, S, C, variant, (lh[e], ll[e], rh[e], rl[e], eh, el))
    g = torch.where(valid, glik[0], 0.0)
    grr = (arena[-1] * g).sum(dim=1)
    arena[-1] = rr[:, None] * g
    gl, gr = torch.zeros_like(lcs), torch.zeros_like(rcs)
    gec = torch.zeros_like(ec)
    two32 = float(2.0 ** 32)
    for i in range(E - 1, -1, -1):
        e = eidx[i]
        g_y = torch.where(flag[i], arena[i] * two32, arena[i])
        x1 = _operand(lpos[i], codes, ttab, arena)
        x2 = _operand(rpos[i], codes, ttab, arena)
        u1 = st(x1, lh[e], ll[e])
        u2 = st(x2, rh[e], rl[e])
        g_p = st(g_y, eTh, eTl)
        g_u1 = g_p * u2
        g_u2 = g_p * u1
        gl[e] = og(x1, g_u1)
        gr[e] = og(x2, g_u2)
        gec = gec + og(u1 * u2, g_y)
        for pos, gu, kh, kl in ((lpos[i], g_u1, lTh, lTl),
                                (rpos[i], g_u2, rTh, rTl)):
            if pos >= codes.shape[0]:
                arena[pos - codes.shape[0]] = st(gu, kh[e], kl[e])
    return gl, gr, gec, grr


@functools.cache
def _lib_mxu():
    """Build (first use) and load csrc/plf_tree_bwd_mxu.cu, with its C
    prototypes."""
    from ._build import load_library
    lib = load_library("plf_tree_bwd_mxu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.plf_tree_bwd_mxu_launch.argtypes = (
        [vp, ci, ci, vp, ci] + [vp] * 13 + [ci, vp, vp, vp, vp, ci, ci, vp,
                                             vp] + [ci] * 8 + [vp])
    lib.plf_tree_bwd_mxu_launch.restype = ci
    lib.plf_tree_bwd_mxu_reduce.argtypes = [vp, ci, ci, vp, vp]
    lib.plf_tree_bwd_mxu_reduce.restype = ci
    lib.plf_tree_bwd_mxu_plan.argtypes = [ci] * 4 + [ctypes.POINTER(ci)] * 3
    lib.plf_tree_bwd_mxu_plan.restype = ci
    lib.plf_error_string.argtypes = [ci]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _launch_plan(device: torch.device, code_bytes: int, states: int,
                 categories: int, mode: int) -> Tuple[bool, int, int]:
    """``(acc_shared, resident, sites)`` of kernel 4m, as its library
    decides them (``plf_tree_bwd_mxu_plan``): the sites per tile (32 at
    S = 20, 8 at S = 61), whether the accumulators live in shared memory
    or in a row of device memory per block (shared memory when two blocks
    with it fit an SM: shared at S = 20, device memory at S = 61), and the
    blocks resident
    on the whole card at once (blocks per SM, registers and shared memory
    counted by the CUDA runtime, times the SMs)."""
    lib = _lib_mxu()
    acc_shared, blocks, sites = (ctypes.c_int(0) for _ in range(3))
    with torch.cuda.device(device):
        err = lib.plf_tree_bwd_mxu_plan(code_bytes, states, categories, mode,
                                        ctypes.byref(acc_shared),
                                        ctypes.byref(blocks),
                                        ctypes.byref(sites))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"plf_tree_bwd_mxu occupancy query failed: "
                           f"{lib.plf_error_string(err).decode()}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return bool(acc_shared.value), blocks.value * sms, sites.value


def acc_floats(states: int, categories: int) -> int:
    """Accumulators of one kernel-4m or 8m block: gl, gr and gec of the
    edge being swept, 3*R*S floats."""
    return 3 * states * categories * states


def plf_tree_bwd_mxu(codes, bsched, lcs, rcs, ec, ttab, rr, glik, n: int, *,
                     states: int = 20, categories: int = 4,
                     variant: str = "mxu_3x", planes=None,
                     max_scratch_bytes: Optional[int] = None):
    """Kernel 4m: the VJP of kernel 2m's whole-tree likelihood w.r.t. its
    lane constants, in the arithmetic of ``variant`` (any key of
    :data:`plf_mxu.MODES`), at any S.

    Arguments are :func:`plf_tree_bwd`'s without the transposed operators
    (the kernel takes the transposed planes, made here from ``planes``):
    ``lcs``/``rcs`` ``(E, S*C, S)`` by original edge, ``ec`` ``(S*C, S)``,
    ``ttab`` the tip table the forward used (rounded for the variant,
    :func:`plf_mxu.round_tip_table`), ``planes`` the operators already
    split (:func:`plf_mxu.node_planes`; split here when None).

    Returns ``(gl, gr, gec, grr)`` site sums shaped as ``lcs``, ``rcs``,
    ``ec`` and ``rr``: the lane-constant entries of the JAX kernel's block
    gradients.  ``plf_tree_bwd_mxu.last_scratch`` records the last call's
    chunking, its tile of sites and where its accumulators lived.
    """
    _check(codes, bsched, dict(lcs=lcs, rcs=rcs), dict(ec=ec), ttab, rr,
           glik, states, categories)
    if variant not in MODES:
        raise ValueError(f"unknown kernel variant {variant!r}")
    args = (codes, bsched, lcs, rcs, ec, ttab, rr, glik)
    if codes.device.type == "cpu":
        return plf_tree_bwd_mxu_torch(*args, n, states=states,
                                      categories=categories, variant=variant,
                                      planes=planes)
    if codes.device.type != "cuda":
        raise ValueError(f"plf_tree_bwd_mxu: no kernel for device "
                         f"{codes.device}")
    if not 1 <= categories <= 8:
        raise ValueError(f"plf_tree_bwd_mxu takes C in 1..8, got "
                         f"C={categories}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("plf_tree_bwd_mxu: tensors must be contiguous")
    S, C = states, categories
    pl = [p.contiguous() for p in node_planes(lcs, rcs, ec, variant, planes)]
    tpl = transpose_planes(pl, S, C)
    ordered = pl[:4] + list(tpl[:4]) + pl[4:] + list(tpl[4:])
    if S % 4 == 0 and any(p.data_ptr() % 16 for p in ordered):
        raise ValueError("plf_tree_bwd_mxu: operator planes must be 16-byte "
                         "aligned")
    n_leaves, n_pad = codes.shape
    E, rows, _ = lcs.shape
    if n_pad % GRAD_THREADS or n_pad >= 2 ** 31 or not 0 <= n <= n_pad:
        raise ValueError(f"plf_tree_bwd_mxu: n_pad={n_pad} must be a "
                         f"positive multiple of {GRAD_THREADS} and "
                         f"0 <= n={n} <= n_pad")
    lib = _lib_mxu()
    dev = codes.device
    if max_scratch_bytes is None:
        max_scratch_bytes = torch.cuda.mem_get_info(dev)[0] // 2
    chunk = tree_bwd_chunk_sites(n_pad, E, rows, max_scratch_bytes)
    RS = rows * S
    cols = 2 * E * RS + RS + rows
    acc_shared, resident, ts = _launch_plan(dev, codes.element_size(), S, C,
                                            MODES[variant])
    n_blocks, _ = tree_bwd_mxu_blocks(chunk, cols, resident, ts)
    partial = torch.empty((n_blocks, cols), dtype=torch.float32, device=dev)
    acc = None if acc_shared else torch.empty(
        (n_blocks, acc_floats(S, C)), dtype=torch.float32,
        device=dev)
    scratch = torch.empty((E, rows, chunk), dtype=torch.float32, device=dev)
    flags = torch.empty((E, chunk), dtype=torch.uint8, device=dev)
    out = torch.empty(cols, dtype=torch.float32, device=dev)
    chunks = range(0, n_pad, chunk)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k, site0 in enumerate(chunks):
            sites = min(chunk, n_pad - site0)
            tiles = sites // ts
            per = -(-tiles // n_blocks)
            err = lib.plf_tree_bwd_mxu_launch(
                codes.data_ptr(), codes.element_size(), n_leaves,
                bsched.data_ptr(), E, *(p.data_ptr() for p in ordered),
                ttab.data_ptr(), ttab.shape[1], rr.data_ptr(),
                glik.data_ptr(), scratch.data_ptr(), flags.data_ptr(), site0,
                sites, partial.data_ptr(),
                None if acc is None else acc.data_ptr(), int(k > 0),
                -(-tiles // per), per, int(n), n_pad, S, C, MODES[variant],
                stream)
            if err != 0:
                break
        else:
            err = lib.plf_tree_bwd_mxu_reduce(partial.data_ptr(), n_blocks,
                                              cols, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"plf_tree_bwd_mxu kernel launch failed: "
                           f"{lib.plf_error_string(err).decode()}")
    plf_tree_bwd_mxu.launches += 1
    plf_tree_bwd_mxu.last_scratch = dict(
        chunk_sites=chunk, chunks=len(chunks), blocks=n_blocks,
        bytes=tree_bwd_scratch_bytes(E, rows, chunk), acc_shared=acc_shared,
        tile_sites=ts)
    gl = out[:E * RS].view(E, rows, S)
    gr = out[E * RS:2 * E * RS].view(E, rows, S)
    gec = out[2 * E * RS:2 * E * RS + RS].view(rows, S)
    return gl, gr, gec, out[2 * E * RS + RS:]


plf_tree_bwd_mxu.launches = 0
plf_tree_bwd_mxu.last_scratch = None


class _TreeDiff(torch.autograd.Function):
    """Kernel 2 (2m) forward, kernel 4 (4m) backward; residuals are only
    the small operand arrays and operator planes, never a CLV."""

    @staticmethod
    def forward(ctx, codes, lcs, rcs, ec, ttab, rr, sched, bsched, n,
                n_slots, root_slot, states, categories, variant, planes):
        lik, sc = plf_tree(codes, sched, lcs, rcs, ec, ttab, rr, n,
                           n_slots=n_slots, root_slot=root_slot,
                           states=states, categories=categories,
                           variant=variant, planes=planes)
        ctx.save_for_backward(codes, bsched, lcs, rcs, ec, ttab, rr)
        ctx.n, ctx.states, ctx.categories = n, states, categories
        ctx.variant, ctx.planes = variant, planes
        ctx.mark_non_differentiable(sc)
        return lik, sc

    @staticmethod
    def backward(ctx, glik, _g_sc):
        codes, bsched, lcs, rcs, ec, ttab, rr = ctx.saved_tensors
        S, C = ctx.states, ctx.categories
        if uses_mxu_kernels(ctx.variant, S):
            gl, gr, gec, grr = plf_tree_bwd_mxu(
                codes, bsched, lcs, rcs, ec, ttab, rr, glik.contiguous(),
                ctx.n, states=S, categories=C, variant=ctx.variant,
                planes=ctx.planes)
        else:
            lcsT, rcsT, ecT = (transpose_lane_constants(t, S, C)
                               for t in (lcs, rcs, ec))
            gl, gr, gec, grr = plf_tree_bwd(
                codes, bsched, lcs, rcs, lcsT, rcsT, ec, ecT, ttab, rr,
                glik.contiguous(), ctx.n, states=S, categories=C)
        return (None, gl, gr, gec, None, grr) + (None,) * 9


def make_tree_diff(schedule: Sequence[Tuple], n_leaves: int, *,
                   states: int = 4, categories: int = 4,
                   variant: str = "vpu"):
    """Differentiable fused whole-tree likelihood.

    ``schedule`` is a reordered schedule (``plf_tree.reorder_schedule``;
    entries ``(parent, left, right, t_left, t_right, edge)``).  Returns
    ``fn(codes, lcs, rcs, ec, ttab, rr, n, planes=None) -> (lik, sc)``
    with the arguments of :func:`.plf_tree.plf_tree` (operators by
    original edge, ``rr`` ``(S*C,)``, ``ttab`` as the forward kernel takes
    it); ``lik`` and ``sc`` are ``(1, n_pad)``.  Differentiable in lcs,
    rcs, ec and rr.  "vpu" at S = 4 runs kernel 2 forward and kernel 4
    backward; every other ``variant`` kernel 2m forward and kernel 4m
    backward, both on ``planes`` (the operators split once by the caller,
    :func:`plf_mxu.node_planes`; split here when None).
    """
    arrs, n_slots, root_slot = compile_register_schedule(schedule, n_leaves)
    fwd_np = np.stack(arrs)
    bwd_np = backward_schedule(schedule, n_leaves)
    on_device = {}

    def fn(codes, lcs, rcs, ec, ttab, rr, n, planes=None):
        dev = codes.device
        if dev not in on_device:
            on_device[dev] = (torch.as_tensor(fwd_np, device=dev),
                              torch.as_tensor(bwd_np, device=dev))
        sched, bsched = on_device[dev]
        if planes is not None:
            planes = tuple(p.detach() for p in planes)
        return _TreeDiff.apply(codes, lcs, rcs, ec, ttab, rr, sched, bsched,
                               int(n), n_slots, root_slot, states,
                               categories, variant, planes)
    return fn
