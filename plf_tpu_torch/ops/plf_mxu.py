"""Kernel 1m: the single-node PLF in its matrix ("MXU") forms, and the
plain versions of the three MXU variants.

Counterpart of the MXU half of ``plf_tpu/ops/plf_pallas.py`` (``:123-266``):
``_plf_kernel_mxu`` runs the three PLF stages as ``(rows, rows) @ (rows,
BS)`` products against block operators (``layout.branch_to_block_matrix``)
at the variant's MXU pass count:

* ``"mxu"``: full fp32 (``Precision.HIGHEST``);
* ``"mxu_3x"``: each fp32 operand split into bf16 hi + lo, three bf16
  passes ``hi*hi + (hi*lo + lo*hi)`` (``_dot_bf16x3``);
* ``"mxu_bf16"``: one bf16 pass (operands rounded to bf16, fp32 sums).

The block operators are zero across categories and their non-zero entries
are the ``(rows, S)`` lane constants, so each product equals the
:func:`plf_node.stage` sum over ``S`` terms.  The port's kernels take the
lane constants for every variant and do only that work (``csrc/plf_mxu.cuh``
explains the arithmetic of each mode).  The dense forms :func:`dot_bf16x3`
and :func:`make_mxu_dots` are kept to exchange results with the JAX
package's block-matrix code.

:func:`plf_node_mxu` dispatches on the device of its tensors: a CPU tensor
takes the plain version :func:`plf_node_mxu_torch`, a CUDA tensor launches
``csrc/plf_node_mxu.cu`` or raises.  ``plf_node_mxu.launches`` counts
kernel launches, ``plf_node_mxu.bf16_launches`` those of the bf16 CLV
storage form (bf16 child and parent rows, fp32 arithmetic) among them.
The kernel's launch shape (site tile, threads, resident blocks per SM)
is its library's: :func:`node_mxu_plan`.  :func:`plf_node_mxu_batch` is
kernel 1m with an instance axis (``plf_node_mxu_batch_launch``, counted in
``plf_node_mxu_batch.launches``), as :func:`.plf_node.plf_node_batch` is
kernel 1's.
On the card set ``torch.backends.cuda.matmul.allow_tf32 = False`` before
calling the dense forms: the kernel's plain version uses no matmul.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..reference import MIN_LIKELIHOOD, TWO_TO_THE_32
from .plf_grad import op_grad, transpose_lane_constants
from .plf_node import _check, _valid, check_batch, count_launch, stage

__all__ = ["MODES", "uses_mxu_kernels", "bf16_round", "bf16_split",
           "dot_bf16x3", "make_mxu_dots", "operator_planes", "node_planes",
           "transpose_planes", "mxu_op_grad", "mxu_stage", "node_mxu_plain",
           "round_tip_table", "plf_node_mxu", "plf_node_mxu_torch",
           "node_mxu_plan", "plf_node_mxu_batch", "plf_node_mxu_batch_torch"]

#: Kernel arithmetic mode of each variant: 0 fp32, 1 bf16x3, 2 bf16.  "vpu"
#: at S != 4 runs in fp32 mode, the same arithmetic as the golden model.
MODES = {"vpu": 0, "mxu": 0, "mxu_3x": 1, "mxu_bf16": 2}


def uses_mxu_kernels(variant: str, states: int) -> bool:
    """Whether a PLF runs the matrix-form kernels (1m and 2m): every
    variant but "vpu", and "vpu" at S != 4 (kernels 1 and 2 are S = 4)."""
    return variant != "vpu" or states != 4


def _mode(variant: str) -> int:
    if variant not in MODES:
        raise ValueError(f"unknown kernel variant {variant!r}; one of "
                         f"{sorted(MODES)}")
    return MODES[variant]


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even) and held as fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_split(x: torch.Tensor):
    """``(hi, lo)`` bf16 parts of fp32 ``x``: ``hi = bf16(x)``, ``lo =
    bf16(x - hi)`` (``plf_pallas.py::_bf16_split``)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _dot_bf16(a, b):
    """One bf16 pass: a product of fp32 tensors holding bf16 values (exact
    products, fp32 sums; no bf16 rounding of the output)."""
    return a.to(torch.float32) @ b.to(torch.float32)


def dot_bf16x3(m, x):
    """3-pass bf16 ``m @ x``: ``hi*hi + (hi*lo + lo*hi)`` with fp32 sums
    (``plf_pallas.py::_dot_bf16x3``)."""
    m_hi, m_lo = bf16_split(m)
    x_hi, x_lo = bf16_split(x)
    return _dot_bf16(m_hi, x_hi) + (_dot_bf16(m_hi, x_lo)
                                    + _dot_bf16(m_lo, x_hi))


def _dot_t_bf16x3(a, b):
    """3-pass bf16 ``a @ b.T``."""
    return dot_bf16x3(a, b.t())


def make_mxu_dots(variant: str):
    """``(dot, dot_t)`` for an MXU variant: ``dot(m, x) = m @ x`` and
    ``dot_t(a, b) = a @ b.T`` at the variant's pass count with fp32 sums
    (``plf_pallas.py::make_mxu_dots``)."""
    if variant == "mxu_3x":
        return dot_bf16x3, _dot_t_bf16x3
    if variant == "mxu":
        return (lambda m, x: m @ x), (lambda a, b: a @ b.t())
    if variant == "mxu_bf16":
        return ((lambda m, x: _dot_bf16(bf16_round(m), bf16_round(x))),
                (lambda a, b: _dot_bf16(bf16_round(a), bf16_round(b).t())))
    raise ValueError(f"not an MXU variant: {variant!r}")


def operator_planes(k: torch.Tensor, variant: str):
    """The ``(hi, lo)`` fp32 planes of lane constants ``k`` that the
    kernels take: ``(k, k)`` in fp32 mode, ``(bf16(k), bf16(k))`` in bf16
    mode, the bf16 split in bf16x3 mode (``lo`` is read in that mode
    only).  Split once on the host, never per site."""
    mode = _mode(variant)
    if mode == 1:
        hi, lo = bf16_split(k)
        return hi.to(torch.float32), lo.to(torch.float32)
    if mode == 2:
        r = bf16_round(k)
        return r, r
    return k, k


def transpose_planes(planes, states: int, categories: int):
    """Adjoint-stage planes: :func:`plf_grad.transpose_lane_constants` of
    each plane (one matrix or a stack).  The bf16 split and rounding act
    element by element, so they commute with this relabelling:
    ``operator_planes(transpose_lane_constants(k))`` equals the transposed
    planes of ``k`` bit for bit, and the planes split once serve the
    backward's transposed stages too."""
    return tuple(transpose_lane_constants(p, states, categories)
                 for p in planes)


def mxu_op_grad(inp, gout, variant: str, states: int, categories: int):
    """The ``(S*C, S)`` lane-constant operator gradient at the variant's
    pass count: ``g[o*C+c, q] = sum_s inp[q*C+c, s] * gout[o*C+c, s]``.

    These are the entries of the JAX package's ``(rows, rows)`` block
    gradient ``gout @ inp.T`` (``make_mxu_bwd_ops``' ``dot_t_s``) that sit
    on the lane-constant positions of ``layout.branch_to_block_matrix``;
    the others never reach a branch length.  fp32 mode: the plain
    products (:func:`plf_grad.op_grad`); bf16 mode: both operands rounded
    to bf16; bf16x3 mode: three separate site sums ``hh = sum gh*ih``,
    ``hl = sum gh*il``, ``lh = sum gl*ih`` combined as ``hh + (hl + lh)``
    (``_dot_t_bf16x3``)."""
    S, C = states, categories
    mode = _mode(variant)
    if mode == 0:
        return op_grad(inp, gout, S, C)
    if mode == 2:
        return op_grad(bf16_round(inp), bf16_round(gout), S, C)
    ih, il = (t.to(torch.float32) for t in bf16_split(inp))
    gh, gl = (t.to(torch.float32) for t in bf16_split(gout))
    return op_grad(ih, gh, S, C) + (op_grad(il, gh, S, C)
                                    + op_grad(ih, gl, S, C))


def node_planes(lc, rc, ec, variant: str, planes=None):
    """The six operator planes ``(lc hi, lc lo, rc hi, rc lo, ec hi, ec
    lo)`` that kernels 1m and 2m take: ``planes`` as given, when the caller
    has split its operators once (``PhyloModel`` does), else
    :func:`operator_planes` of each."""
    if planes is None:
        return [p for k in (lc, rc, ec) for p in operator_planes(k, variant)]
    planes = list(planes)
    ops = (lc, lc, rc, rc, ec, ec)
    if len(planes) != 6 or any(
            p.shape != k.shape or p.dtype != torch.float32
            or p.device != k.device for p, k in zip(planes, ops)):
        raise ValueError("planes must be six float32 tensors shaped as and "
                         "on the device of lc, lc, rc, rc, ec, ec")
    return planes


def mxu_stage(x, planes, variant: str, states: int, categories: int):
    """:func:`plf_node.stage` in the variant's arithmetic, in the kernel's
    op order: ``x`` split (bf16x3) or rounded (bf16) here, the operator
    given as :func:`operator_planes`."""
    S, C = states, categories
    kh, kl = planes
    mode = _mode(variant)
    if mode == 0:
        return stage(x, kh, S, C)
    if mode == 2:
        return stage(bf16_round(x), kh, S, C)
    xh, xl = (t.to(torch.float32) for t in bf16_split(x))
    return stage(xh, kh, S, C) + (stage(xl, kh, S, C) + stage(xh, kl, S, C))


def node_mxu_plain(x1, x2, lc, rc, ec, valid, states: int, categories: int,
                   variant: str, planes=None):
    """One PLF node in plain torch, in kernel 1m's arithmetic and op order
    for ``variant`` (fp32 mode is :func:`plf_node.node_plain` exactly).

    ``x1``/``x2``: ``(S*C, n_pad)`` fp32; ``lc``/``rc``/``ec``: ``(S*C, S)``
    lane constants; ``valid``: ``(n_pad,)`` bool; ``planes``: as
    :func:`node_planes`.  Returns ``(x3, mask)``.
    """
    S, C = states, categories
    pl = node_planes(lc, rc, ec, variant, planes)
    st = lambda x, i: mxu_stage(x, (pl[i], pl[i + 1]), variant, S, C)
    p = st(x1, 0) * st(x2, 2)
    x3 = st(p, 4)
    mask = (x3.abs() < float(MIN_LIKELIHOOD)).all(dim=0) & valid
    x3 = torch.where(mask, x3 * float(TWO_TO_THE_32), x3)
    return x3, mask


def round_tip_table(ttab: torch.Tensor, variant: str) -> torch.Tensor:
    """The tip table as the JAX tree kernels' tip product ``ttab @ onehot``
    gives it at the variant's precision (``plf_tree_pallas.py:139-155``):
    exact for "vpu" and "mxu", ``fl(bf16(t) + bf16(t - bf16(t)))`` for
    "mxu_3x", ``bf16(t)`` for "mxu_bf16".  The fused path takes this table;
    the per-node path expands tips exactly, as the JAX package's does."""
    mode = _mode(variant)
    if mode == 1:
        hi, lo = bf16_split(ttab)
        return hi.to(torch.float32) + lo.to(torch.float32)
    if mode == 2:
        return bf16_round(ttab)
    return ttab


def plf_node_mxu_torch(x1, x2, lc, rc, ec, n: int, *, states: int = 20,
                       categories: int = 4, out: Optional[torch.Tensor] = None,
                       variant: str = "mxu_3x", planes=None):
    """Plain version of kernel 1m (same arguments and results as
    :func:`plf_node_mxu`), on the device of its inputs.  bf16 CLVs are
    widened, and ``x3`` is narrowed after the rescale."""
    x3, mask = node_mxu_plain(x1.float(), x2.float(), lc, rc, ec,
                              _valid(n, x1.shape[-1], x1.device), states,
                              categories, variant, planes)
    x3 = x3.to(x1.dtype)
    if out is not None:
        out.copy_(x3)
        x3 = out
    return x3, mask.to(torch.int32)[None, :]


@functools.cache
def _lib(bf16: bool = False):
    """Build (first use) and load csrc/plf_node_mxu.cu's library for fp32
    or ``bf16`` storage, with its C prototypes."""
    from ._build import load_library, storage_library
    lib = load_library(storage_library("plf_node_mxu", bf16))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.plf_node_mxu_launch.argtypes = [vp] * 10 + [ci] * 6 + [vp]
    lib.plf_node_mxu_launch.restype = ci
    lib.plf_node_mxu_batch_launch.argtypes = [vp] * 10 + [ci] * 7 + [vp]
    lib.plf_node_mxu_batch_launch.restype = ci
    lib.plf_node_mxu_plan.argtypes = [ci] * 4 + [ctypes.POINTER(ci)] * 3
    lib.plf_node_mxu_plan.restype = ci
    lib.plf_error_string.argtypes = [ci]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _plan(device: torch.device, states: int, categories: int, mode: int,
          bf16: bool):
    lib = _lib(bf16)
    ts, threads, blocks = (ctypes.c_int(0) for _ in range(3))
    with torch.cuda.device(device):
        err = lib.plf_node_mxu_plan(states, categories, mode, int(bf16),
                                    ctypes.byref(ts), ctypes.byref(threads),
                                    ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"plf_node_mxu plan query failed: "
                           f"{lib.plf_error_string(err).decode()}")
    return ts.value, threads.value, blocks.value


def node_mxu_plan(states: int, categories: int, variant: str = "mxu_3x",
                  bf16: bool = False, device=None):
    """``(sites, threads, blocks)`` of kernel 1m's launch, as its library
    launches them (``plf_node_mxu_plan``): sites per tile (32), threads
    per block (plf_mxu.cuh's job shape on that tile: 320 at S = 20, C = 4;
    416 at S = 61) and resident blocks per SM.  The grid is one block per
    tile.  Builds the kernel on first use and needs a CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _plan(dev, states, categories, _mode(variant), bool(bf16))


def plf_node_mxu(x1, x2, lc, rc, ec, n: int, *, states: int = 20,
                 categories: int = 4, out: Optional[torch.Tensor] = None,
                 variant: str = "mxu_3x", planes=None):
    """Kernel 1m: one PLF node on lane-major operands in the arithmetic
    of ``variant`` (any key of :data:`MODES`).

    Arguments and results are :func:`plf_node.plf_node`'s: ``x1``/``x2``
    ``(S*C, n_pad)`` fp32 or both bf16, ``lc``/``rc``/``ec`` ``(S*C, S)``
    lane constants, ``n`` valid sites, ``out`` optionally ``x1`` or ``x2``
    to write the parent in place; returns ``(x3, scaler)``.  ``planes``: the
    operators already split for ``variant`` (:func:`node_planes`).
    """
    _check(x1, x2, lc, rc, ec, out, states, categories)
    mode = _mode(variant)
    if x1.device.type == "cpu":
        return plf_node_mxu_torch(x1, x2, lc, rc, ec, n, states=states,
                                  categories=categories, out=out,
                                  variant=variant, planes=planes)
    if x1.device.type != "cuda":
        raise ValueError(f"plf_node_mxu: no kernel for device {x1.device}")
    ts = [x1, x2, lc, rc, ec] + ([] if out is None else [out])
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("plf_node_mxu: tensors must be contiguous")
    n_pad = x1.shape[-1]
    if not 0 <= n <= n_pad or n_pad == 0 or n_pad >= 2 ** 31:
        raise ValueError(f"plf_node_mxu: bad n={n} for n_pad={n_pad}")
    planes = [p.contiguous()
              for p in node_planes(lc, rc, ec, variant, planes)]
    if states % 4 == 0 and any(p.data_ptr() % 16 for p in planes):
        raise ValueError("plf_node_mxu: lc/rc/ec must be 16-byte aligned")
    bf16 = x1.dtype == torch.bfloat16
    lib = _lib(bf16)
    x3 = torch.empty_like(x1) if out is None else out
    sc = torch.empty((1, n_pad), dtype=torch.int32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = lib.plf_node_mxu_launch(
            x1.data_ptr(), x2.data_ptr(), *(p.data_ptr() for p in planes),
            x3.data_ptr(), sc.data_ptr(), int(n), n_pad, states, categories,
            mode, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"plf_node_mxu kernel launch failed: "
                           f"{lib.plf_error_string(err).decode()}")
    count_launch(plf_node_mxu, x1.dtype)
    return x3, sc


plf_node_mxu.launches = plf_node_mxu.bf16_launches = 0


def plf_node_mxu_batch_torch(x1, x2, lc, rc, ec, n: int, *, states: int = 20,
                             categories: int = 4, variant: str = "mxu_3x",
                             planes=None):
    """Plain version of :func:`plf_node_mxu_batch` (same arguments and
    results): :func:`plf_node_mxu_torch` on each instance."""
    pl = node_planes(lc, rc, ec, variant, planes)
    outs = [plf_node_mxu_torch(x1[i], x2[i], lc[i], rc[i], ec[i], n,
                               states=states, categories=categories,
                               variant=variant,
                               planes=[p[i] for p in pl])
            for i in range(x1.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def plf_node_mxu_batch(x1, x2, lc, rc, ec, n: int, *, states: int = 20,
                       categories: int = 4, variant: str = "mxu_3x",
                       planes=None):
    """Kernel 1m with an instance axis: :func:`.plf_node.plf_node_batch`
    in the arithmetic of ``variant`` (any key of :data:`MODES`); ``planes``
    are the six ``(I, S*C, S)`` operator-plane stacks (split here when
    None).  Instance ``i`` equals :func:`plf_node_mxu` on it bit for
    bit."""
    check_batch(x1, x2, lc, rc, ec, n, states, categories,
                "plf_node_mxu_batch")
    mode = _mode(variant)
    if x1.device.type == "cpu":
        return plf_node_mxu_batch_torch(x1, x2, lc, rc, ec, n,
                                        states=states, categories=categories,
                                        variant=variant, planes=planes)
    if x1.device.type != "cuda":
        raise ValueError(f"plf_node_mxu_batch: no kernel for device "
                         f"{x1.device}")
    if not x1.is_contiguous() or not x2.is_contiguous():
        raise ValueError("plf_node_mxu_batch: tensors must be contiguous")
    planes = [p.contiguous()
              for p in node_planes(lc, rc, ec, variant, planes)]
    if states % 4 == 0 and any(p.data_ptr() % 16 for p in planes):
        raise ValueError("plf_node_mxu_batch: lc/rc/ec must be 16-byte "
                         "aligned")
    I, _, n_pad = x1.shape
    bf16 = x1.dtype == torch.bfloat16
    lib = _lib(bf16)
    x3 = torch.empty_like(x1)
    sc = torch.empty((I, n_pad), dtype=torch.int32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = lib.plf_node_mxu_batch_launch(
            x1.data_ptr(), x2.data_ptr(), *(p.data_ptr() for p in planes),
            x3.data_ptr(), sc.data_ptr(), int(n), n_pad, states, categories,
            mode, int(bf16), I, stream)
    if err != 0:
        raise RuntimeError(f"plf_node_mxu_batch kernel launch failed: "
                           f"{lib.plf_error_string(err).decode()}")
    count_launch(plf_node_mxu_batch, x1.dtype)
    return x3, sc


plf_node_mxu_batch.launches = plf_node_mxu_batch.bf16_launches = 0
