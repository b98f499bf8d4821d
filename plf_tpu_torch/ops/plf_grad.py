"""Kernel 3: the single-node PLF backward, and the differentiable node.

Counterpart of ``plf_tpu/ops/plf_grad.py``.  Replaces
``_plf_bwd_kernel`` (``plf_grad.py:120``, launched by ``_plf_bwd_call``
``:166``) with ``csrc/plf_node_bwd.cu``.  Math (per site, lane-major rows
``r = k*C + c``), with ``stage`` the PLF stage shape of
:func:`plf_node.stage`::

  forward:  u1 = S1(x1; lc)  u2 = S1(x2; rc)  p = u1*u2  y = S3(p; ec)
            x3 = f*y,  f = 2^32 where the site was rescued, else 1
            (f depends on y only through the discrete mask: a constant
            wherever the likelihood is differentiable)
  backward: g_y = f*g (0 on padding sites)
            g_p = S3(g_y; ecT)   g_u1 = g_p*u2   g_u2 = g_p*u1
            gx1 = S1(g_u1; lcT)  gx2 = S1(g_u2; rcT)
            gl[r, a] = sum_s x1[a*C + r%C, s] * g_u1[r, s]; gr, ge alike

The adjoint of a stage is the same stage with transposed constants
(:func:`transpose_lane_constants`).  What bounds the kernel on the card is
device memory: 324 bytes per site at S = C = 4 (x1, x2, g and the flags
read, gx1 and gx2 written).  At S != 4 kernel 3m (``csrc/
plf_node_bwd_mxu.cu``, :func:`plf_node_bwd_mxu`) computes the same
function in fp32 on ``[row][site]`` shared-memory tiles, kernel 4m's
reverse sweep for one node on kernel 4m's tile and plan (32 sites and
320 threads at S = 20, 8 and 128 at S = 61; its library says which): a
site's rows and its ``3*S*C*S`` gradient slots no longer fit a thread's
registers.

:func:`plf_node_bwd` dispatches on S first (S != 4 goes to kernel 3m),
then on the device of its tensors: a CPU tensor takes the plain version
:func:`plf_node_bwd_torch`, a CUDA tensor launches the kernel or raises.
``plf_node_bwd.launches`` and ``plf_node_bwd_mxu.launches`` count each
kernel's launches.  :func:`make_plf_diff` is the differentiable fused
PLF: kernel 1 (1m in fp32 mode at S != 4) forward, kernel 3 (3m) backward.
The TPU-only MXU form of the operator reduction (``_op_grad_mxu``,
``PLF_VPU_BWD_MXU_REDUCE``) is not ported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..reference import TWO_TO_THE_32
from .plf_node import SMEM_BLOCK_BYTES, _tile_rows, plf_node, stage

__all__ = ["transpose_lane_constants", "op_grad", "plf_node_bwd",
           "plf_node_bwd_torch", "plf_node_bwd_mxu", "make_plf_diff",
           "node_bwd_blocks", "node_bwd_mxu_blocks", "GRAD_THREADS",
           "MAX_GRAD_BLOCKS"]

#: Threads per block of the backward kernels, and sites per tile
#: (``csrc/plf_grad.cuh::kGradThreads``); ``n_pad`` must be a multiple.
GRAD_THREADS = 128

#: Most blocks a backward launch spreads its sites over; each block writes
#: one row of operator-gradient partials.
MAX_GRAD_BLOCKS = 1024


def transpose_lane_constants(lc, states: int = 4, categories: int = 4):
    """Adjoint-stage constants: ``lcT[a*C + c, k] = lc[k*C + c, a]``.
    Works on one ``(S*C, S)`` matrix or a stack ``(..., S*C, S)``."""
    S, C = states, categories
    lead = tuple(lc.shape[:-2])
    t = lc.reshape(lead + (S, C, S))                       # [k, c, a]
    t = t.permute(*range(len(lead)), -1, -2, -3)           # [a, c, k]
    return t.reshape(lead + (S * C, S)).contiguous()


def op_grad(inp, gout, states: int, categories: int):
    """``(S*C, S)`` operator gradient: column ``a`` is the site sum of
    ``inp[a*C + r%C] * gout[r]`` (each product rounded, then summed)."""
    S, C = states, categories
    return torch.stack([(_tile_rows(inp, a, S, C) * gout).sum(dim=1)
                        for a in range(S)], dim=1)


def _valid(n: int, n_pad: int, device):
    return torch.arange(n_pad, device=device) < n


def plf_node_bwd_torch(x1, x2, g, sc, lc, rc, lcT, rcT, ecT, n: int, *,
                       states: int = 4, categories: int = 4):
    """Plain version of kernel 3 (same arguments and results as
    :func:`plf_node_bwd`), on the device of its inputs, in the kernel's
    op order."""
    S, C = states, categories
    valid = _valid(n, x1.shape[-1], x1.device)
    fac = torch.where((sc[0] > 0) & valid, float(TWO_TO_THE_32),
                      1.0).to(g.dtype)
    g_y = torch.where(valid, g * fac, 0.0)
    u1 = stage(x1, lc, S, C)
    u2 = stage(x2, rc, S, C)
    g_p = stage(g_y, ecT, S, C)
    g_u1 = g_p * u2
    g_u2 = g_p * u1
    gx1 = stage(g_u1, lcT, S, C)
    gx2 = stage(g_u2, rcT, S, C)
    return (gx1, gx2, op_grad(x1, g_u1, S, C), op_grad(x2, g_u2, S, C),
            op_grad(u1 * u2, g_y, S, C))


def node_bwd_blocks(n_sites: int):
    """``(n_blocks, tiles_per_block)`` of a backward launch over
    ``n_sites`` (a multiple of :data:`GRAD_THREADS`): at most
    :data:`MAX_GRAD_BLOCKS` blocks, each with at least one tile."""
    tiles = n_sites // GRAD_THREADS
    per = -(-tiles // MAX_GRAD_BLOCKS)
    return -(-tiles // per), per


def _check(x1, x2, g, sc, consts, states, categories):
    rows = states * categories
    if x1.dim() != 2 or x1.shape[0] != rows or x2.shape != x1.shape \
            or g.shape != x1.shape:
        raise ValueError(f"x1/x2/g must all be ({rows}, n_pad), got "
                         f"{tuple(x1.shape)}, {tuple(x2.shape)} and "
                         f"{tuple(g.shape)}")
    if tuple(sc.shape) != (1, x1.shape[1]) or sc.dtype != torch.int32:
        raise ValueError(f"sc must be (1, {x1.shape[1]}) int32, got "
                         f"{tuple(sc.shape)} {sc.dtype}")
    for t in consts:
        if tuple(t.shape) != (rows, states):
            raise ValueError(f"lc/rc/lcT/rcT/ecT must be ({rows}, {states}),"
                             f" got {tuple(t.shape)}")
    ts = [x1, x2, g, *consts]
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("plf_node_bwd takes float32 tensors only")
    if any(t.device != x1.device for t in ts + [sc]):
        raise ValueError("plf_node_bwd: all tensors must be on one device")


@functools.cache
def _lib():
    """Build (first use) and load csrc/plf_node_bwd.cu, with its C
    prototypes."""
    from ._build import load_library
    lib = load_library("plf_node_bwd")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.plf_node_bwd_launch.argtypes = [vp] * 12 + [ci, ci, vp, ci, ci, ci,
                                                    vp]
    lib.plf_node_bwd_launch.restype = ci
    lib.plf_error_string.argtypes = [ci]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


def plf_node_bwd(x1, x2, g, sc, lc, rc, lcT, rcT, ecT, n: int, *,
                 states: int = 4, categories: int = 4):
    """VJP of one fused PLF node on lane-major operands.

    Args:
      x1, x2: ``(S*C, n_pad)`` fp32 child CLVs of the forward.
      g: ``(S*C, n_pad)`` fp32 cotangent of the parent CLV.
      sc: ``(1, n_pad)`` int32 rescale flags of the forward.
      lc, rc: ``(S*C, S)`` branch constants; lcT, rcT, ecT: the transposed
        branch and EV constants (:func:`transpose_lane_constants`).
      n: number of valid sites; padding sites get a zero cotangent.

    Returns:
      ``(gx1, gx2, gl, gr, ge)``: ``(S*C, n_pad)`` fp32 child cotangents
      and ``(S*C, S)`` fp32 operator gradients summed over sites.  At
      S != 4 the call goes to :func:`plf_node_bwd_mxu` (kernel 3m).
    """
    consts = (lc, rc, lcT, rcT, ecT)
    if states != 4:
        return plf_node_bwd_mxu(x1, x2, g, sc, *consts, n, states=states,
                                categories=categories)
    _check(x1, x2, g, sc, consts, states, categories)
    if x1.device.type == "cpu":
        return plf_node_bwd_torch(x1, x2, g, sc, *consts, n, states=states,
                                  categories=categories)
    if x1.device.type != "cuda":
        raise ValueError(f"plf_node_bwd: no kernel for device {x1.device}")
    if not 1 <= categories <= 8:
        raise ValueError("the CUDA PLF backward takes S = 4 and C in 1..8, "
                         f"got S={states}, C={categories}")
    if not all(t.is_contiguous() for t in (x1, x2, g, sc, *consts)):
        raise ValueError("plf_node_bwd: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in consts):
        raise ValueError("plf_node_bwd: lc/rc/lcT/rcT/ecT must be 16-byte "
                         "aligned")
    rows, n_pad = x1.shape
    if n_pad % GRAD_THREADS or n_pad >= 2 ** 31 or not 0 <= n <= n_pad:
        raise ValueError(f"plf_node_bwd: n_pad={n_pad} must be a positive "
                         f"multiple of {GRAD_THREADS} and 0 <= n={n} <= n_pad")
    lib = _lib()
    n_blocks, per = node_bwd_blocks(n_pad)
    gx1 = torch.empty_like(x1)
    gx2 = torch.empty_like(x1)
    partial = torch.empty((n_blocks, 3 * rows * states), dtype=torch.float32,
                          device=x1.device)
    gops = torch.empty((3, rows, states), dtype=torch.float32,
                       device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = lib.plf_node_bwd_launch(
            x1.data_ptr(), x2.data_ptr(), g.data_ptr(), sc.data_ptr(),
            *(t.data_ptr() for t in consts), gx1.data_ptr(), gx2.data_ptr(),
            partial.data_ptr(), n_blocks, per, gops.data_ptr(), int(n),
            n_pad, categories, stream)
    if err != 0:
        raise RuntimeError(f"plf_node_bwd kernel launch failed: "
                           f"{lib.plf_error_string(err).decode()}")
    plf_node_bwd.launches += 1
    return gx1, gx2, gops[0], gops[1], gops[2]


plf_node_bwd.launches = 0


@functools.cache
def _lib_mxu():
    """Build (first use) and load csrc/plf_node_bwd_mxu.cu, with its C
    prototypes."""
    from ._build import load_library
    lib = load_library("plf_node_bwd_mxu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.plf_node_bwd_mxu_launch.argtypes = [vp] * 12 + [ci] * 3 + [vp] + [
        ci] * 4 + [vp]
    lib.plf_node_bwd_mxu_launch.restype = ci
    lib.plf_node_bwd_mxu_plan.argtypes = [ci, ci] + [ctypes.POINTER(ci)] * 3
    lib.plf_node_bwd_mxu_plan.restype = ci
    lib.plf_error_string.argtypes = [ci]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _mxu_plan(device: torch.device, states: int, categories: int):
    """``(acc_shared, resident, sites)`` of kernel 3m, as its library
    decides them (``plf_node_bwd_mxu_plan``, kernel 4m's rule and tile):
    the accumulators in shared memory when two blocks with them fit an SM
    (S = 20), else in each block's row of partial sums in device memory
    (S = 61); the blocks resident on the whole card at once (0 when a
    block's tiles exceed its shared memory); and the sites per tile (32 at
    S = 20, 8 at S = 61)."""
    lib = _lib_mxu()
    acc_shared, blocks, sites = (ctypes.c_int(0) for _ in range(3))
    with torch.cuda.device(device):
        err = lib.plf_node_bwd_mxu_plan(states, categories,
                                        ctypes.byref(acc_shared),
                                        ctypes.byref(blocks),
                                        ctypes.byref(sites))
    if err != 0:
        raise RuntimeError(f"plf_node_bwd_mxu occupancy query failed: "
                           f"{lib.plf_error_string(err).decode()}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return bool(acc_shared.value), blocks.value * sms, sites.value


def node_bwd_mxu_blocks(n_sites: int, resident: int, sites: int):
    """``(n_blocks, tiles_per_block)`` of a kernel-3m launch over
    ``n_sites`` in tiles of ``sites`` (its plan's tile, which divides the
    128-site padding unit): at most one wave of ``resident`` blocks and
    :data:`MAX_GRAD_BLOCKS`, each with at least one tile."""
    tiles = n_sites // sites
    per = -(-tiles // max(1, min(resident, MAX_GRAD_BLOCKS)))
    return -(-tiles // per), per


def plf_node_bwd_mxu(x1, x2, g, sc, lc, rc, lcT, rcT, ecT, n: int, *,
                     states: int = 20, categories: int = 4):
    """Kernel 3m: the VJP of one fused PLF node at any S (the port routes
    S != 4 here), in fp32.  Arguments and results are
    :func:`plf_node_bwd`'s; ``gx1``/``gx2`` equal the plain version bit for
    bit, the operator sums agree with it to a tolerance and are
    bit-identical run to run."""
    consts = (lc, rc, lcT, rcT, ecT)
    _check(x1, x2, g, sc, consts, states, categories)
    if x1.device.type == "cpu":
        return plf_node_bwd_torch(x1, x2, g, sc, *consts, n, states=states,
                                  categories=categories)
    if x1.device.type != "cuda":
        raise ValueError(f"plf_node_bwd_mxu: no kernel for device "
                         f"{x1.device}")
    S, C = states, categories
    rows = S * C
    if not all(t.is_contiguous() for t in (x1, x2, g, sc, *consts)):
        raise ValueError("plf_node_bwd_mxu: tensors must be contiguous")
    if S % 4 == 0 and any(t.data_ptr() % 16 for t in consts):
        raise ValueError("plf_node_bwd_mxu: lc/rc/lcT/rcT/ecT must be "
                         "16-byte aligned")
    n_pad = x1.shape[1]
    if n_pad % GRAD_THREADS or n_pad >= 2 ** 31 or not 0 <= n <= n_pad:
        raise ValueError(f"plf_node_bwd_mxu: n_pad={n_pad} must be a "
                         f"positive multiple of {GRAD_THREADS} and "
                         f"0 <= n={n} <= n_pad")
    lib = _lib_mxu()
    dev = x1.device
    acc_shared, resident, ts = _mxu_plan(dev, S, C)
    if resident < 1:
        raise ValueError(f"plf_node_bwd_mxu: {rows} rows in tiles of {ts} "
                         f"sites do not fit one block's shared memory "
                         f"({SMEM_BLOCK_BYTES} bytes)")
    n_blocks, per = node_bwd_mxu_blocks(n_pad, resident, ts)
    gx1 = torch.empty_like(x1)
    gx2 = torch.empty_like(x1)
    partial = torch.empty((n_blocks, 3 * rows * S), dtype=torch.float32,
                          device=dev)
    gops = torch.empty((3, rows, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.plf_node_bwd_mxu_launch(
            x1.data_ptr(), x2.data_ptr(), g.data_ptr(), sc.data_ptr(),
            *(t.data_ptr() for t in consts), gx1.data_ptr(), gx2.data_ptr(),
            partial.data_ptr(), int(acc_shared), n_blocks, per,
            gops.data_ptr(), int(n), n_pad, S, C, stream)
    if err != 0:
        raise RuntimeError(f"plf_node_bwd_mxu kernel launch failed: "
                           f"{lib.plf_error_string(err).decode()}")
    plf_node_bwd_mxu.launches += 1
    return gx1, gx2, gops[0], gops[1], gops[2]


plf_node_bwd_mxu.launches = 0


class _PlfDiff(torch.autograd.Function):
    """Kernel 1 (1m) forward (never in place: x1 and x2 are residuals of
    the backward), kernel 3 (3m) backward."""

    @staticmethod
    def forward(ctx, x1, x2, lc, rc, ec, n, states, categories):
        x3, sc = plf_node(x1, x2, lc, rc, ec, n, states=states,
                          categories=categories)
        ctx.save_for_backward(x1, x2, lc, rc, ec, sc)
        ctx.n, ctx.states, ctx.categories = n, states, categories
        ctx.mark_non_differentiable(sc)
        return x3, sc

    @staticmethod
    def backward(ctx, g, _g_sc):
        x1, x2, lc, rc, ec, sc = ctx.saved_tensors
        S, C = ctx.states, ctx.categories
        lcT, rcT, ecT = (transpose_lane_constants(t, S, C)
                         for t in (lc, rc, ec))
        gx1, gx2, gl, gr, ge = plf_node_bwd(
            x1, x2, g.contiguous(), sc, lc.contiguous(), rc.contiguous(),
            lcT, rcT, ecT, ctx.n, states=S, categories=C)
        return gx1, gx2, gl, gr, ge, None, None, None


def make_plf_diff(states: int = 4, categories: int = 4):
    """Differentiable fused PLF: ``fn(x1, x2, lc, rc, ec, n) -> (x3, sc)``.

    The forward is kernel 1 (:func:`plf_node.plf_node` in "vpu": kernel
    1m in fp32 mode at S != 4; out of place: x1 and x2 are kept for the
    backward, as the JAX package passes ``donate=0``); the backward is
    kernel 3 (:func:`plf_node_bwd`: kernel 3m at S != 4).
    Gradients flow to x1, x2 and the lane constants lc, rc, ec; the int32
    scaler output is not differentiable.
    """
    def fn(x1, x2, lc, rc, ec, n):
        return _PlfDiff.apply(x1, x2, lc, rc, ec, int(n), states, categories)
    return fn
