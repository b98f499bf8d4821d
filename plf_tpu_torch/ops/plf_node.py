"""Kernel 1: the single-node PLF on lane-major CLVs.

Replaces ``plf_tpu/ops/plf_pallas.py::_plf_kernel`` (launched by
``plf_pallas_lane_major``, ``plf_pallas.py:273``), the bit-exact "vpu"
form.  The kernel is ``csrc/plf_node.cu``: one thread per site, constants
in shared memory, every intermediate in registers, uncontracted fp32 in
the golden model's order.  What bounds it on the card is device memory:
196 bytes per site at S = C = 4 (two child CLVs read, one parent CLV and
one int32 flag written), against ~23 fp32 operations per CLV element.
With bf16 CLV storage (``PLFConfig(dtype="bfloat16")``, the JAX
package's fast mode, ``plf_pallas.py:379-383``) the kernel reads and
writes bf16 rows, 100 bytes per site, and computes in fp32.

:func:`plf_node` dispatches on the kernel variant first (any form but
"vpu" at S = 4 goes to kernel 1m, ``ops/plf_mxu.py``), then on the device
of its tensors: a CPU tensor takes the plain version
:func:`plf_node_torch`, a CUDA tensor launches the kernel or raises.
``plf_node.launches`` counts kernel launches, ``plf_node.bf16_launches``
those of the bf16 storage form among them.

:func:`plf_node_batch` gives kernel 1 an instance axis (the grid's second
dimension, ``plf_node_batch_launch``): I independent node pairs, each
with its own CLVs and constants, in one launch, each instance equal to
:func:`plf_node` on it bit for bit.  It replaces the ``vmap`` of
``plf_pallas_lane_major`` in ``plf_tpu/engine.py::PLFEngine.plf_batch``
(``:147-228``); ``plf_node_batch.launches`` counts its launches (kernel
1m's form is ``plf_mxu.plf_node_mxu_batch``).

Kernel 9, :func:`plf_node_gen`, is the compute-only probe that replaces
``plf_pallas.py::_gen_kernel`` (``plf_pallas_gen``, ``:436``;
``csrc/plf_gen.cu``): it builds its CLVs on the card and chains PLF nodes
over them, so it moves no CLV through device memory and is bound by
operations.  At S != 4 it takes the operators transposed
(:func:`gen_operators`); its library decides its launch and whether it
can run at all (:func:`gen_plan`).  ``plf_node_gen.launches`` counts its
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..reference import MIN_LIKELIHOOD, TWO_TO_THE_32
from . import layout as L

__all__ = ["plf_node", "plf_node_torch", "plf_node_site_major",
           "plf_node_batch", "plf_node_batch_torch", "check_batch",
           "node_plain", "stage", "count_launch", "plf_node_gen",
           "plf_node_gen_torch", "gen_flops", "gen_operators", "gen_plan",
           "SMEM_BLOCK_BYTES"]

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int

#: Shared memory one thread block may use on an H100 (227 KiB; the part
#: above 48 KiB is opted into by the launchers).
SMEM_BLOCK_BYTES = 232448


def _tile_rows(x, a: int, states: int, categories: int):
    """Rows ``a*C .. a*C+C-1`` repeated ``S`` times -> ``(S*C, n)``."""
    C = categories
    return x[a * C:(a + 1) * C].repeat(states, 1)


def stage(x, const, states: int, categories: int):
    """One lane-major PLF stage: ``out[r] = sum_a x[a*C + r%C] * const[r, a]``
    for ``a = 0..S-1`` in order, each product and sum its own op (nothing
    contracts into an FMA).  The branch products, the EV projection and
    (with transposed constants) their adjoints all have this shape."""
    S, C = states, categories
    out = _tile_rows(x, 0, S, C) * const[:, 0:1]
    for a in range(1, S):
        out = out + _tile_rows(x, a, S, C) * const[:, a:a + 1]
    return out


def node_plain(x1, x2, lc, rc, ec, valid, states: int, categories: int):
    """One PLF node in plain torch, the kernel's op order.

    ``x1``/``x2``: ``(S*C, n_pad)`` fp32; ``lc``/``rc``/``ec``: ``(S*C, S)``;
    ``valid``: ``(n_pad,)`` bool (padding sites never rescale).
    Returns ``(x3, mask)`` with ``mask`` ``(n_pad,)`` bool.
    """
    S, C = states, categories
    p = stage(x1, lc, S, C) * stage(x2, rc, S, C)
    x3 = stage(p, ec, S, C)
    mask = (x3.abs() < float(MIN_LIKELIHOOD)).all(dim=0) & valid
    x3 = torch.where(mask, x3 * float(TWO_TO_THE_32), x3)
    return x3, mask


def _valid(n: int, n_pad: int, device):
    return torch.arange(n_pad, device=device) < n


def plf_node_torch(x1, x2, lc, rc, ec, n: int, *, states: int = 4,
                   categories: int = 4, out: Optional[torch.Tensor] = None):
    """Plain version of kernel 1 (same arguments and results as
    :func:`plf_node`), on the device of its inputs.  bf16 CLVs are widened,
    and ``x3`` is narrowed after the rescale (round to nearest even)."""
    x3, mask = node_plain(x1.float(), x2.float(), lc, rc, ec,
                          _valid(n, x1.shape[-1], x1.device), states,
                          categories)
    x3 = x3.to(x1.dtype)
    if out is not None:
        out.copy_(x3)
        x3 = out
    return x3, mask.to(torch.int32)[None, :]


def _check(x1, x2, lc, rc, ec, out, states, categories):
    rows = states * categories
    if x1.dim() != 2 or x1.shape[0] != rows or x2.shape != x1.shape:
        raise ValueError(f"x1/x2 must both be ({rows}, n_pad), got "
                         f"{tuple(x1.shape)} and {tuple(x2.shape)}")
    for name, t in (("lc", lc), ("rc", rc), ("ec", ec)):
        if tuple(t.shape) != (rows, states):
            raise ValueError(f"{name} must be ({rows}, {states}), got "
                             f"{tuple(t.shape)}")
    ts = [x1, x2, lc, rc, ec] + ([] if out is None else [out])
    clvs = [x1, x2] + ([] if out is None else [out])
    if (any(t.dtype != torch.float32 for t in (lc, rc, ec))
            or x1.dtype not in (torch.float32, torch.bfloat16)
            or any(t.dtype != x1.dtype for t in clvs)):
        raise TypeError("plf_node takes float32 lc/rc/ec and x1, x2 (and "
                        "out) all float32 or all bfloat16")
    if any(t.device != x1.device for t in ts):
        raise ValueError("plf_node: all tensors must be on one device")
    if out is not None and out.shape != x1.shape:
        raise ValueError("out must have the shape of x1")
    # In place is safe only over a whole child: a thread reads its site's
    # rows of x1 and x2 before it writes the same site's rows of out.
    for t in ([] if out is None else (x1, x2)):
        if (out.untyped_storage().data_ptr()
                == t.untyped_storage().data_ptr()
                and out.data_ptr() != t.data_ptr()):
            raise ValueError("out must be x1, x2, or share no memory "
                             "with them")


@functools.cache
def _lib(bf16: bool = False):
    """Build (first use) and load csrc/plf_node.cu's library for fp32 or
    ``bf16`` storage, with its C prototypes."""
    from ._build import load_library, storage_library
    lib = load_library(storage_library("plf_node", bf16))
    lib.plf_node_launch.argtypes = [_c_void_p] * 7 + [
        _c_int, _c_int, _c_int, _c_int, _c_void_p]
    lib.plf_node_launch.restype = _c_int
    lib.plf_node_batch_launch.argtypes = [_c_void_p] * 7 + [_c_int] * 5 + [
        _c_void_p]
    lib.plf_node_batch_launch.restype = _c_int
    lib.plf_error_string.argtypes = [_c_int]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


def plf_node(x1, x2, lc, rc, ec, n: int, *, states: int = 4,
             categories: int = 4, out: Optional[torch.Tensor] = None,
             variant: str = "vpu", planes=None):
    """Fused PLF on lane-major operands.

    Args:
      x1, x2: ``(S*C, n_pad)`` lane-major child CLVs, fp32 or, for bf16
        storage, both bf16.
      lc, rc: ``(S*C, S)`` branch constants
        (:func:`layout.branch_to_lane_constants`).
      ec: ``(S*C, S)`` eigenvector constants
        (:func:`layout.ev_to_lane_constants`).
      n: number of valid sites; sites ``>= n`` never set a scaler flag.
      out: optional output buffer; passing ``x1`` or ``x2`` writes the
        parent CLV in place over that (dead) child.
      variant: the kernel form, dispatched as ``plf_pallas_lane_major``
        does (``plf_pallas.py:314-325``): "vpu" at S = 4 runs this kernel;
        "mxu", "mxu_3x", "mxu_bf16", and "vpu" at S != 4, run kernel 1m
        (:func:`plf_mxu.plf_node_mxu`), which takes the same lane
        constants.
      planes: kernel 1m only: ``lc``/``rc``/``ec`` already split for
        ``variant`` (:func:`plf_mxu.node_planes`).

    Returns:
      ``(x3, scaler)``: ``(S*C, n_pad)`` in the storage type of ``x1``
      and ``(1, n_pad)`` int32.
    """
    from .plf_mxu import plf_node_mxu, uses_mxu_kernels
    if uses_mxu_kernels(variant, states):
        return plf_node_mxu(x1, x2, lc, rc, ec, n, states=states,
                            categories=categories, out=out, variant=variant,
                            planes=planes)
    if planes is not None:
        raise ValueError("plf_node: planes are for the matrix-form kernel")
    _check(x1, x2, lc, rc, ec, out, states, categories)
    if x1.device.type == "cpu":
        return plf_node_torch(x1, x2, lc, rc, ec, n, states=states,
                              categories=categories, out=out)
    if x1.device.type != "cuda":
        raise ValueError(f"plf_node: no kernel for device {x1.device}")
    if states != 4 or not 1 <= categories <= 8:
        raise ValueError("the CUDA PLF kernel takes S = 4 and C in 1..8, "
                         f"got S={states}, C={categories}")
    ts = [x1, x2, lc, rc, ec] + ([] if out is None else [out])
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("plf_node: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (lc, rc, ec)):
        raise ValueError("plf_node: lc/rc/ec must be 16-byte aligned")
    n_pad = x1.shape[-1]
    if not 0 <= n <= n_pad or n_pad == 0 or n_pad >= 2 ** 31:
        raise ValueError(f"plf_node: bad n={n} for n_pad={n_pad}")
    bf16 = x1.dtype == torch.bfloat16
    lib = _lib(bf16)
    x3 = torch.empty_like(x1) if out is None else out
    sc = torch.empty((1, n_pad), dtype=torch.int32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = lib.plf_node_launch(
            x1.data_ptr(), x2.data_ptr(), lc.data_ptr(), rc.data_ptr(),
            ec.data_ptr(), x3.data_ptr(), sc.data_ptr(), int(n), n_pad,
            categories, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"plf_node kernel launch failed: "
                           f"{lib.plf_error_string(err).decode()}")
    count_launch(plf_node, x1.dtype)
    return x3, sc


def count_launch(wrapper, dtype) -> None:
    """Add one launch to ``wrapper.launches`` and, for bf16 CLV storage,
    to ``wrapper.bf16_launches``."""
    wrapper.launches += 1
    wrapper.bf16_launches += int(dtype == torch.bfloat16)


plf_node.launches = plf_node.bf16_launches = 0


#: Most instances one batched launch takes (the grid's y extent).
MAX_INSTANCES = 65535


def check_batch(x1, x2, lc, rc, ec, n, states, categories, name):
    """The checks of the batched node kernels: ``x1``/``x2`` ``(I, S*C,
    n_pad)`` fp32 (or both bf16), ``lc``/``rc``/``ec`` ``(I, S*C, S)``
    fp32, all on one device, ``0 <= n <= n_pad``."""
    rows = states * categories
    if x1.dim() != 3 or x1.shape[1] != rows or x2.shape != x1.shape:
        raise ValueError(f"{name}: x1/x2 must both be (I, {rows}, n_pad), "
                         f"got {tuple(x1.shape)} and {tuple(x2.shape)}")
    I = x1.shape[0]
    for k, t in (("lc", lc), ("rc", rc), ("ec", ec)):
        if tuple(t.shape) != (I, rows, states) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {k} must be ({I}, {rows}, {states}) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    if x1.dtype not in (torch.float32, torch.bfloat16) \
            or x2.dtype != x1.dtype:
        raise TypeError(f"{name}: x1 and x2 must both be float32 or both "
                        f"bfloat16")
    if any(t.device != x1.device for t in (x2, lc, rc, ec)):
        raise ValueError(f"{name}: all tensors must be on one device")
    n_pad = x1.shape[-1]
    if not 1 <= I <= MAX_INSTANCES or not 0 <= n <= n_pad or n_pad == 0 \
            or n_pad >= 2 ** 31:
        raise ValueError(f"{name}: bad I={I}, n={n} or n_pad={n_pad}")


def plf_node_batch_torch(x1, x2, lc, rc, ec, n: int, *, states: int = 4,
                         categories: int = 4):
    """Plain version of :func:`plf_node_batch` (same arguments and
    results): :func:`plf_node_torch` on each instance."""
    outs = [plf_node_torch(*t, n, states=states, categories=categories)
            for t in zip(x1, x2, lc, rc, ec)]
    return (torch.stack([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def plf_node_batch(x1, x2, lc, rc, ec, n: int, *, states: int = 4,
                   categories: int = 4, variant: str = "vpu", planes=None):
    """Kernel 1 (or 1m) with an instance axis: I independent PLF nodes in
    one launch.

    Args:
      x1, x2: ``(I, S*C, n_pad)`` lane-major child CLVs, fp32 or both bf16.
      lc, rc, ec: ``(I, S*C, S)`` fp32 lane constants of each instance.
      n: valid sites of every instance.
      variant, planes: as :func:`plf_node`; "vpu" at S = 4 runs kernel 1,
        anything else kernel 1m (:func:`plf_mxu.plf_node_mxu_batch`), with
        ``planes`` shaped as the stacks.

    Returns:
      ``(x3, scaler)``: ``(I, S*C, n_pad)`` in the storage type of ``x1``
      and ``(I, n_pad)`` int32; instance ``i`` equals :func:`plf_node` on
      it bit for bit.
    """
    from .plf_mxu import plf_node_mxu_batch, uses_mxu_kernels
    if uses_mxu_kernels(variant, states):
        return plf_node_mxu_batch(x1, x2, lc, rc, ec, n, states=states,
                                  categories=categories, variant=variant,
                                  planes=planes)
    if planes is not None:
        raise ValueError("plf_node_batch: planes are for the matrix-form "
                         "kernel")
    check_batch(x1, x2, lc, rc, ec, n, states, categories, "plf_node_batch")
    if x1.device.type == "cpu":
        return plf_node_batch_torch(x1, x2, lc, rc, ec, n, states=states,
                                    categories=categories)
    if x1.device.type != "cuda":
        raise ValueError(f"plf_node_batch: no kernel for device {x1.device}")
    if states != 4 or not 1 <= categories <= 8:
        raise ValueError("the CUDA PLF kernel takes S = 4 and C in 1..8, "
                         f"got S={states}, C={categories}")
    ts = (x1, x2, lc, rc, ec)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("plf_node_batch: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (lc, rc, ec)):
        raise ValueError("plf_node_batch: lc/rc/ec must be 16-byte aligned")
    I, _, n_pad = x1.shape
    bf16 = x1.dtype == torch.bfloat16
    lib = _lib(bf16)
    x3 = torch.empty_like(x1)
    sc = torch.empty((I, n_pad), dtype=torch.int32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = lib.plf_node_batch_launch(
            x1.data_ptr(), x2.data_ptr(), lc.data_ptr(), rc.data_ptr(),
            ec.data_ptr(), x3.data_ptr(), sc.data_ptr(), int(n), n_pad,
            categories, int(bf16), I, stream)
    if err != 0:
        raise RuntimeError(f"plf_node_batch kernel launch failed: "
                           f"{lib.plf_error_string(err).decode()}")
    count_launch(plf_node_batch, x1.dtype)
    return x3, sc


plf_node_batch.launches = plf_node_batch.bf16_launches = 0


def plf_node_site_major(x1, x2, left, right, ev, wgt, *, states: int = 4,
                        categories: int = 4, block_sites: int = 4096,
                        variant: str = "vpu", dtype: str = "float32"):
    """Site-major convenience wrapper (counterpart of
    ``plf_tpu/ops/plf_pallas.py::plf_pallas``): layout in, kernel 1,
    layout out, in the form of ``variant``.  ``dtype="bfloat16"`` stores
    the padded lane-major CLVs, and so ``x3``, in bf16 (cast after
    padding, as ``plf_pallas`` does).  Returns ``(x3 (n, C, S),
    scaler_vector (n,) int32, scaler_increment int64 scalar)``."""
    S, C = states, categories
    n = x1.reshape(-1, C, S).shape[0]
    n2 = x2.reshape(-1, C, S).shape[0]
    if n != n2:
        raise ValueError(f"x1/x2 site count mismatch: {n} vs {n2}")
    x1l = L.pad_to_multiple(L.to_lane_major(x1, S, C), block_sites)
    x2l = L.pad_to_multiple(L.to_lane_major(x2, S, C), block_sites)
    x1l, x2l = (x.to(getattr(torch, dtype)) for x in (x1l, x2l))
    lc = L.branch_to_lane_constants(left, S, C)
    rc = L.branch_to_lane_constants(right, S, C)
    ec = L.ev_to_lane_constants(ev, S, C)
    x3l, sc = plf_node(x1l.contiguous(), x2l.contiguous(), lc, rc, ec, n,
                       states=S, categories=C, variant=variant)
    x3 = L.from_lane_major(x3l, S, C, n=n)
    sv = sc[0, :n]
    si = (sv.to(torch.int64) * wgt.to(torch.int64)).sum()
    return x3, sv, si


# ------------------------------------------- kernel 9: the compute probe --

def gen_flops(states: int, categories: int) -> int:
    """fp32 operations of one probe node at one site: three stages of S
    products and S - 1 sums per row, the stage-2 product and the row
    sum's add (368 at S = C = 4, as ``bench.py:297`` counts)."""
    return states * categories * (6 * states - 1)


def _gen_clvs(rows: int, n_sites: int, block_sites: int, device):
    """The probe's child CLVs ``(rows, n_sites)``, as ``_gen_kernel``
    builds them: with ``s`` a site's index within its block and ``r`` the
    row, ``x1 = (0.1 + s*1e-4) + r*0.05`` and ``x2 = (1 - (s*1e-4)*0.5) +
    (r*0.05)*0.25``, each op in fp32."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    s = torch.arange(n_sites, device=device) % block_sites
    base = s.to(torch.float32) * f32(1e-4)
    rowf = torch.arange(rows, device=device).to(torch.float32)[:, None] \
        * f32(0.05)
    x1 = (f32(0.1) + base) + rowf
    x2 = (f32(1.0) - base * f32(0.5)) + rowf * f32(0.25)
    return x1, x2


def plf_node_gen_torch(lc, rc, ec, *, states: int = 4, categories: int = 4,
                       block_sites: int = 4096, n_blocks: int = 64,
                       inner_iters: int = 8):
    """Plain version of kernel 9 (same arguments and result as
    :func:`plf_node_gen`), on the device of ``lc``.  The rows are summed
    in a loop, row 0 first, the kernel's order (``torch.sum`` may take
    another)."""
    S, C = states, categories
    x1, x2 = _gen_clvs(S * C, n_blocks * block_sites, block_sites, lc.device)
    acc = torch.zeros(x1.shape[1], dtype=torch.float32, device=lc.device)
    for _ in range(inner_iters):
        x1 = stage(stage(x1, lc, S, C) * stage(x2, rc, S, C), ec, S, C)
        t = x1[0]
        for r in range(1, S * C):
            t = t + x1[r]
        acc = acc + t
    return acc[None, :]


@functools.cache
def _lib_gen():
    """Build (first use) and load csrc/plf_gen.cu, with its C prototypes."""
    from ._build import load_library
    lib = load_library("plf_gen")
    lib.plf_gen_launch.argtypes = [_c_void_p] * 4 + [_c_int] * 5 + [
        _c_void_p]
    lib.plf_gen_launch.restype = _c_int
    lib.plf_gen_plan.argtypes = [_c_int] * 2 + [ctypes.POINTER(_c_int)] * 8
    lib.plf_gen_plan.restype = _c_int
    lib.plf_error_string.argtypes = [_c_int]
    lib.plf_error_string.restype = ctypes.c_char_p
    return lib


_GEN_PLAN = ("threads", "tile_sites", "job_rows", "job_sites", "sp",
             "smem_bytes", "ops_shared", "blocks_per_sm")


def gen_plan(states: int, categories: int) -> dict:
    """Kernel 9's launch at this state and category count, as its library
    (``plf_gen_plan`` in ``csrc/plf_gen.cu``, the one owner of the rule)
    decides it: ``threads`` per block, ``tile_sites`` per block tile,
    ``job_rows`` x ``job_sites`` outputs per thread and stage job, the
    operators' padded row count ``sp``, dynamic shared memory
    ``smem_bytes``, ``ops_shared`` (the operators staged in shared
    memory, else read from device memory) and ``blocks_per_sm``.  Raises
    ValueError where the kernel cannot run (its tiles do not fit one
    block's shared memory; C outside 1..8 at S = 4).  Builds the kernel on
    first use and needs a CUDA device."""
    lib = _lib_gen()
    vals = [_c_int(0) for _ in _GEN_PLAN]
    err = lib.plf_gen_plan(states, categories,
                           *(ctypes.byref(v) for v in vals))
    if err != 0:
        what = ("C in 1..8 at S = 4" if states == 4 else
                f"{states * categories} rows whose tiles fit one block's "
                f"shared memory ({SMEM_BLOCK_BYTES} bytes)")
        raise ValueError(f"plf_node_gen takes {what}: "
                         f"{lib.plf_error_string(err).decode()}")
    return dict(zip(_GEN_PLAN, (v.value for v in vals)))


def gen_operators(lc, rc, ec, sp: int, *, states: int, categories: int):
    """The operators as kernel 9 takes them at S != 4: ``(3, C, S, sp)``
    fp32, ``[k][c][q][o] = K[o*C + c][q]`` for ``K`` = lc, rc, ec (lane
    constants, ``(S*C, S)``), rows ``o >= S`` zero, so that one float4 is
    one ``q``'s values for 4 consecutive output rows."""
    S, C = states, categories
    kt = torch.zeros((3, C, S, sp), dtype=torch.float32, device=lc.device)
    for i, k in enumerate((lc, rc, ec)):
        kt[i, :, :, :S] = k.reshape(S, C, S).permute(1, 2, 0)
    return kt


def plf_node_gen(lc, rc, ec, *, states: int = 4, categories: int = 4,
                 block_sites: int = 4096, n_blocks: int = 64,
                 inner_iters: int = 8):
    """Compute-only PLF probe (kernel 9, ``plf_pallas_gen``'s contract):
    ``n_blocks * block_sites * inner_iters`` node-site evaluations with no
    CLV traffic.

    Args:
      lc, rc, ec: ``(S*C, S)`` fp32 lane constants; the device follows
        ``lc``.
      block_sites, n_blocks: the probe covers ``n_blocks * block_sites``
        sites; a site's synthetic CLVs depend on its index within its
        block.
      inner_iters: chained PLF nodes per site.

    Returns:
      ``(1, n_blocks * block_sites)`` fp32 per-site checksum.
    """
    S, C = states, categories
    rows = S * C
    for name, t in (("lc", lc), ("rc", rc), ("ec", ec)):
        if tuple(t.shape) != (rows, S) or t.dtype != torch.float32:
            raise ValueError(f"plf_node_gen: {name} must be ({rows}, {S}) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
        if t.device != lc.device:
            raise ValueError("plf_node_gen: lc/rc/ec must be on one device")
    n = n_blocks * block_sites
    if S < 2 or block_sites < 1 or n_blocks < 1 or inner_iters < 0 \
            or n >= 2 ** 31:
        raise ValueError(f"plf_node_gen: bad S={S}, block_sites="
                         f"{block_sites}, n_blocks={n_blocks} or "
                         f"inner_iters={inner_iters}")
    kw = dict(states=S, categories=C, block_sites=block_sites,
              n_blocks=n_blocks, inner_iters=inner_iters)
    if lc.device.type == "cpu":
        return plf_node_gen_torch(lc, rc, ec, **kw)
    if lc.device.type != "cuda":
        raise ValueError(f"plf_node_gen: no kernel for device {lc.device}")
    plan = gen_plan(S, C)
    if not all(t.is_contiguous() for t in (lc, rc, ec)):
        raise ValueError("plf_node_gen: lc/rc/ec must be contiguous")
    if S == 4 and any(t.data_ptr() % 16 for t in (lc, rc, ec)):
        raise ValueError("plf_node_gen: lc/rc/ec must be 16-byte aligned")
    if S != 4:
        lc = rc = ec = gen_operators(lc, rc, ec, plan["sp"], states=S,
                                     categories=C)
    lib = _lib_gen()
    out = torch.empty((1, n), dtype=torch.float32, device=lc.device)
    with torch.cuda.device(lc.device):
        stream = torch.cuda.current_stream(lc.device).cuda_stream
        err = lib.plf_gen_launch(lc.data_ptr(), rc.data_ptr(), ec.data_ptr(),
                                 out.data_ptr(), n, block_sites, inner_iters,
                                 S, C, stream)
    if err != 0:
        raise RuntimeError(f"plf_node_gen kernel launch failed: "
                           f"{lib.plf_error_string(err).decode()}")
    plf_node_gen.launches += 1
    return out


plf_node_gen.launches = 0
