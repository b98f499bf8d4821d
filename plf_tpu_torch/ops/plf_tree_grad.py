"""Kernel 4: the checkpointed whole-tree backward, and the differentiable
whole-tree likelihood.

Counterpart of ``plf_tpu/ops/plf_tree_grad.py``.  Replaces
``_tree_bwd_kernel`` (``plf_tree_grad.py:110``, launched by
``_tree_bwd_call`` ``:229``) with ``csrc/plf_tree_bwd.cu``:

* phase 1 recomputes the forward and checkpoints every internal CLV and
  its rescale flag;
* the root adjoint is seeded with ``rr * g`` and ``grr`` accumulated;
* phase 2 sweeps the schedule in reverse; a node's slot flips from its
  CLV to its adjoint, and the per-edge ``gl``/``gr``, ``gec`` and ``grr``
  are summed over all sites.

The adjoint identities are those of :mod:`.plf_grad`;
:func:`.plf_grad.transpose_lane_constants` transposes a whole ``(E, S*C,
S)`` operator stack at once (the "vpu" branch of the JAX package's
``transpose_operator_stack``; the MXU forms are not ported).

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

from .plf_grad import (GRAD_THREADS, node_bwd_blocks, op_grad,
                       transpose_lane_constants)
from .plf_node import node_plain, stage
from .plf_tree import compile_register_schedule, plf_tree

__all__ = ["compile_backward_schedule", "tree_bwd_scratch_bytes",
           "tree_bwd_chunk_sites", "plf_tree_bwd", "plf_tree_bwd_torch",
           "make_tree_diff"]


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


def tree_bwd_scratch_bytes(n_edges: int, rows: int, sites: int) -> int:
    """Device-memory checkpoint of kernel 4 for ``sites`` sites: ``E``
    fp32 CLVs of ``rows`` rows and ``E`` flag bytes per site."""
    return n_edges * (rows * 4 + 1) * sites


def tree_bwd_chunk_sites(n_pad: int, n_edges: int, rows: int,
                         budget: int) -> int:
    """Sites per kernel-4 launch: all ``n_pad`` if their checkpoint fits
    ``budget`` bytes, else the most whole 128-site tiles that fit."""
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


def _check(codes, bsched, lcs, rcs, lcsT, rcsT, ec, ecT, ttab, rr, glik,
           states, categories):
    rows = states * categories
    if codes.dim() != 2 or codes.dtype not in (torch.int32, torch.int8):
        raise TypeError("codes must be (n_leaves, n_pad) int32 or int8")
    E = lcs.shape[0]
    if tuple(bsched.shape) != (3, E) or bsched.dtype != torch.int32:
        raise ValueError(f"bsched must be (3, {E}) int32, got "
                         f"{tuple(bsched.shape)} {bsched.dtype}")
    for name, t, shape in (("lcs", lcs, (E, rows, states)),
                           ("rcs", rcs, (E, rows, states)),
                           ("lcsT", lcsT, (E, rows, states)),
                           ("rcsT", rcsT, (E, rows, states)),
                           ("ec", ec, (rows, states)),
                           ("ecT", ecT, (rows, states)),
                           ("rr", rr, (rows,)),
                           ("glik", glik, (1, codes.shape[-1]))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if ttab.dim() != 2 or ttab.shape[0] != rows \
            or ttab.dtype != torch.float32:
        raise ValueError(f"ttab must be ({rows}, n_codes) float32")
    ts = (codes, bsched, lcs, rcs, lcsT, rcsT, ec, ecT, ttab, rr, glik)
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
    lib.plf_tree_bwd_reduce.argtypes = [vp, ci, ci, vp, vp]
    lib.plf_tree_bwd_reduce.restype = ci
    lib.plf_error_string.argtypes = [ci]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


def plf_tree_bwd(codes, bsched, lcs, rcs, lcsT, rcsT, ec, ecT, ttab, rr,
                 glik, n: int, *, states: int = 4, categories: int = 4,
                 max_scratch_bytes: Optional[int] = None):
    """VJP of the fused whole-tree likelihood (kernel 2) w.r.t. its
    operators.

    Args:
      codes: ``(n_leaves, n_pad)`` int32 or int8 tip codes.
      bsched: ``(3, E)`` int32 rows lpos, rpos (:func:`compile_backward_
        schedule`) and eidx (original edge of each schedule entry).
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
    _check(*args, states, categories)
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
    plan, n_rows = [], 0
    for site0 in range(0, n_pad, chunk):
        sites = min(chunk, n_pad - site0)
        n_blocks, per = node_bwd_blocks(sites)
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


class _TreeDiff(torch.autograd.Function):
    """Kernel 2 forward, kernel 4 backward; residuals are only the small
    operand arrays, never a CLV."""

    @staticmethod
    def forward(ctx, codes, lcs, rcs, ec, ttab, rr, sched, bsched, n,
                n_slots, root_slot, states, categories):
        lik, sc = plf_tree(codes, sched, lcs, rcs, ec, ttab, rr, n,
                           n_slots=n_slots, root_slot=root_slot,
                           states=states, categories=categories)
        ctx.save_for_backward(codes, bsched, lcs, rcs, ec, ttab, rr)
        ctx.n, ctx.states, ctx.categories = n, states, categories
        ctx.mark_non_differentiable(sc)
        return lik, sc

    @staticmethod
    def backward(ctx, glik, _g_sc):
        codes, bsched, lcs, rcs, ec, ttab, rr = ctx.saved_tensors
        S, C = ctx.states, ctx.categories
        lcsT, rcsT, ecT = (transpose_lane_constants(t, S, C)
                           for t in (lcs, rcs, ec))
        gl, gr, gec, grr = plf_tree_bwd(
            codes, bsched, lcs, rcs, lcsT, rcsT, ec, ecT, ttab, rr,
            glik.contiguous(), ctx.n, states=S, categories=C)
        return (None, gl, gr, gec, None, grr) + (None,) * 7


def make_tree_diff(schedule: Sequence[Tuple], n_leaves: int, *,
                   states: int = 4, categories: int = 4):
    """Differentiable fused whole-tree likelihood.

    ``schedule`` is a reordered schedule (``plf_tree.reorder_schedule``;
    entries ``(parent, left, right, t_left, t_right, edge)``).  Returns
    ``fn(codes, lcs, rcs, ec, ttab, rr, n) -> (lik, sc)`` with the
    arguments of :func:`.plf_tree.plf_tree` (operators by original edge,
    ``rr`` ``(S*C,)``); ``lik`` and ``sc`` are ``(1, n_pad)``.
    Differentiable in lcs, rcs, ec and rr: kernel 2 forward, kernel 4
    backward.
    """
    arrs, n_slots, root_slot = compile_register_schedule(schedule, n_leaves)
    fwd_np = np.stack(arrs)
    bwd_np = np.stack(compile_backward_schedule(schedule, n_leaves)
                      + (arrs[5],))
    on_device = {}

    def fn(codes, lcs, rcs, ec, ttab, rr, n):
        dev = codes.device
        if dev not in on_device:
            on_device[dev] = (torch.as_tensor(fwd_np, device=dev),
                              torch.as_tensor(bwd_np, device=dev))
        sched, bsched = on_device[dev]
        return _TreeDiff.apply(codes, lcs, rcs, ec, ttab, rr, sched, bsched,
                               int(n), n_slots, root_slot, states,
                               categories)
    return fn
