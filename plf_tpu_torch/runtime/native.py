"""ctypes binding to the port's native runtime library.

Counterpart of ``plf_tpu/runtime/native.py``: a fast, multithreaded,
bit-exact host recompute of the PLF (the reference verifies every
benchmark run against one, ``host_mem.cpp:403-442``) and of a whole tree
(:func:`plf_tree_golden_native`, :func:`tree_golden_for_model`: the
post-order traversal in the tree kernels' fp32 op order), the lane-layout
converters, the reference-format instance packers and the branch
transpose, from ``plf_tpu_torch/native/plf_native.cpp``.  At first use the
source is built with g++ (``plf_tpu/native/Makefile``'s flags;
``-ffp-contract=off`` keeps the golden model's uncontracted order) into
``build/plf_tpu_torch/`` at
the root of the checkout, under a name that hashes the source, the flags
and the host CPU, so a library built for another machine is never loaded.
Without a compiler every entry point answers with NumPy instead (the
golden model ``reference.plf_reference``, the tree oracle's NumPy form),
with the same bits; :func:`golden_oracle` says which.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["plf_golden_native", "golden_oracle", "to_lane_major_native",
           "from_lane_major_native", "pack_instance_native",
           "unpack_instance_native", "plf_tree_golden_native",
           "tree_golden_for_model", "transpose_branch_native"]

_SRC = Path(__file__).resolve().parents[1] / "native" / "plf_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "plf_tpu_torch"
_CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fno-fast-math",
             "-fPIC", "-std=c++17", "-shared", "-pthread")


def _cpu_id() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine() + platform.processor()


def _library() -> Path:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    h.update(_cpu_id().encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libplf_native-{h.hexdigest()[:16]}.so"


@functools.cache
def _lib() -> Optional[ctypes.CDLL]:
    """Build (first use) and load the golden library; None without a C++
    compiler or when the build fails."""
    so = _library()
    if not so.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            return None
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fp = ctypes.POINTER(ctypes.c_float)
    lib.plf_golden_mt.restype = ctypes.c_longlong
    lib.plf_golden_mt.argtypes = [fp, fp, fp, fp, ctypes.c_longlong, fp, fp,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_ubyte),
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int]
    ll, i32 = ctypes.c_longlong, ctypes.c_int
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.to_lane_major.restype = None
    lib.to_lane_major.argtypes = [fp, fp, ll, i32, i32]
    lib.from_lane_major.restype = None
    lib.from_lane_major.argtypes = [fp, fp, ll, ll, i32, i32]
    lib.pack_instance.restype = ll
    lib.pack_instance.argtypes = [fp, fp, fp, fp, ll, i32, i32, i32]
    lib.unpack_instance.restype = ll
    lib.unpack_instance.argtypes = [fp, fp, fp, fp, ll, i32, i32, i32]
    lib.transpose_branch.restype = None
    lib.transpose_branch.argtypes = [fp, fp, i32, i32]
    lib.plf_tree_golden_mt.restype = None
    lib.plf_tree_golden_mt.argtypes = [
        i32p, ll, i32, fp, i32, i32p, i32p, i32p, i32, i32, fp, fp, fp, fp,
        i32, i32, fp, i32p, i32]
    return lib


def golden_oracle() -> str:
    """Which golden oracle :func:`plf_golden_native` runs: "native (g++)"
    or "numpy"."""
    return "numpy" if _lib() is None else "native (g++)"


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def plf_golden_native(x1, x2, left, right, ev, wgt=None, states=4,
                      categories=4, threads: Optional[int] = None):
    """Native golden PLF; the contract of ``reference.plf_reference``:
    returns ``(x3 (n, C, S), scaler (n,) uint8, weighted increment)``."""
    lib = _lib()
    S, C = states, categories
    e = S * C
    x1 = np.ascontiguousarray(np.asarray(x1, np.float32).reshape(-1, e))
    x2 = np.ascontiguousarray(np.asarray(x2, np.float32).reshape(-1, e))
    n = x1.shape[0]
    if lib is None:
        from ..reference import plf_reference
        return plf_reference(x1, x2, left, right, ev, wgt, states=S,
                             categories=C)
    left = np.ascontiguousarray(np.asarray(left, np.float32).reshape(-1))
    right = np.ascontiguousarray(np.asarray(right, np.float32).reshape(-1))
    ev = np.ascontiguousarray(np.asarray(ev, np.float32).reshape(-1))
    if wgt is None:
        wgt = np.ones((n,), np.int32)
    wgt = np.ascontiguousarray(np.asarray(wgt, np.int32))
    x3 = np.empty((n, e), np.float32)
    scaler = np.empty((n,), np.uint8)
    if threads is None:
        threads = min(os.cpu_count() or 1, 16)
    inc = lib.plf_golden_mt(
        _f32p(x1), _f32p(x2), _f32p(x3), _f32p(ev), n, _f32p(left),
        _f32p(right), wgt.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        scaler.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), S, C,
        int(threads))
    return x3.reshape(n, C, S), scaler, int(inc)


def to_lane_major_native(clv, states=4, categories=4):
    """Native site-major -> lane-major; NumPy fallback."""
    lib = _lib()
    S, C = states, categories
    clv = np.ascontiguousarray(
        np.asarray(clv, np.float32).reshape(-1, C * S))
    n = clv.shape[0]
    if lib is None:
        from ..ops.layout import to_lane_major
        return np.ascontiguousarray(to_lane_major(clv, S, C))
    out = np.empty((S * C, n), np.float32)
    lib.to_lane_major(_f32p(clv), _f32p(out), n, S, C)
    return out


def from_lane_major_native(x, n=None, states=4, categories=4):
    """Native lane-major -> site-major; NumPy fallback."""
    lib = _lib()
    S, C = states, categories
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    n_pad = x.shape[-1]
    n = n_pad if n is None else n
    if lib is None:
        from ..ops.layout import from_lane_major
        return np.ascontiguousarray(from_lane_major(x, S, C, n=n))
    out = np.empty((n, C * S), np.float32)
    lib.from_lane_major(_f32p(x), _f32p(out), n, n_pad, S, C)
    return out.reshape(n, C, S)


def pack_instance_native(ev, branch, clv, states=4, categories=4,
                         combined=True):
    """Pack a reference-format instance input buffer ([EV|branch|CLV])."""
    lib = _lib()
    S, C = states, categories
    ev = np.ascontiguousarray(np.asarray(ev, np.float32).reshape(-1))
    branch = np.ascontiguousarray(np.asarray(branch, np.float32).reshape(-1))
    clv = np.ascontiguousarray(np.asarray(clv, np.float32).reshape(-1))
    n = clv.size // (S * C)
    header = S * S if combined else 0
    out = np.empty(header + C * S * S + n * C * S, np.float32)
    if lib is None:
        off = 0
        if combined:
            out[:S * S] = ev
            off = S * S
        out[off:off + C * S * S] = branch
        out[off + C * S * S:] = clv
        return out
    written = lib.pack_instance(_f32p(ev), _f32p(branch), _f32p(clv),
                                _f32p(out), n, S, C, 0 if combined else 1)
    assert written == out.size
    return out


def unpack_instance_native(buf, n_sites, states=4, categories=4,
                           combined=True):
    """Inverse of pack_instance_native -> (ev, branch, clv)."""
    lib = _lib()
    S, C = states, categories
    buf = np.ascontiguousarray(np.asarray(buf, np.float32).reshape(-1))
    ev = np.empty(S * S, np.float32)
    branch = np.empty(C * S * S, np.float32)
    clv = np.empty(n_sites * C * S, np.float32)
    if lib is None:
        off = 0
        if combined:
            ev[:] = buf[:S * S]
            off = S * S
        branch[:] = buf[off:off + C * S * S]
        clv[:] = buf[off + C * S * S:off + C * S * S + clv.size]
    else:
        lib.unpack_instance(_f32p(buf), _f32p(ev), _f32p(branch),
                            _f32p(clv), n_sites, S, C,
                            0 if combined else 1)
    return (ev.reshape(S, S), branch.reshape(C, S, S),
            clv.reshape(n_sites, C, S))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _tree_golden_np(codes, ttab, lsrc, rsrc, oslot, lbr, rbr, ev, rr,
                    states, categories):
    """NumPy fallback for the whole-tree golden oracle.

    Vectorised over sites; the per-site accumulation order (sequential
    over a and k) matches the native/kernel op order exactly, so results
    are bit-identical to the C++ path.
    """
    S, C = states, categories
    n = codes.shape[1]
    n_slots = int(max(oslot.max(), lsrc.max(), rsrc.max())) + 1
    arena = np.zeros((n_slots, n, C, S), np.float32)
    for l in range(codes.shape[0]):
        arena[l] = ttab[:, codes[l]].T[:, None, :]     # (n, 1->C, S)
    minlik = np.float32(np.ldexp(1.0, -32))
    two32 = np.float32(np.ldexp(1.0, 32))
    sc = np.zeros(n, np.int32)
    for e in range(len(lsrc)):
        x1 = arena[lsrc[e]]
        x2 = arena[rsrc[e]]
        u1 = np.zeros((n, C, S), np.float32)
        u2 = np.zeros((n, C, S), np.float32)
        for a in range(S):
            u1 += x1[:, :, a:a + 1] * lbr[e][None, :, :, a]
            u2 += x2[:, :, a:a + 1] * rbr[e][None, :, :, a]
        p = u1 * u2
        out = np.zeros((n, C, S), np.float32)
        for k in range(S):
            out += p[:, :, k:k + 1] * ev[None, None, k, :]
        mask = np.all(np.abs(out) < minlik, axis=(1, 2))
        out[mask] *= two32
        sc += mask.astype(np.int32)
        arena[oslot[e]] = out
    root = arena[oslot[-1]]                            # (n, C, S)
    lik = np.zeros(n, np.float32)
    for a in range(S):
        for c in range(C):
            lik += rr[a * C + c] * root[:, c, a]
    return lik, sc


def plf_tree_golden_native(codes, ttab, lsrc, rsrc, oslot, lbr, rbr, ev,
                           rr, states=4, categories=4,
                           threads: Optional[int] = None):
    """Whole-tree golden oracle: per-site likelihood + rescale counts.

    The tree-level analogue of plf_golden_native — recomputes the entire
    post-order traversal on the host with the device kernels' exact fp32
    op order (the reference verifies every run against a host recompute,
    app/src/host_mem.cpp:403-442).  Arguments use the UNIFIED register
    coordinates of ops/plf_tree.compile_register_schedule (tips
    in slots [0, n_leaves)); ``lbr``/``rbr`` are (E, C, S, S) branch
    factors in schedule order, ``ttab`` the (S, ncode) tip table,
    ``rr`` the (S*C,) root-row vector.
    """
    S, C = states, categories
    codes = np.ascontiguousarray(np.asarray(codes, np.int32))
    ttab = np.ascontiguousarray(np.asarray(ttab, np.float32))
    lsrc = np.ascontiguousarray(np.asarray(lsrc, np.int32))
    rsrc = np.ascontiguousarray(np.asarray(rsrc, np.int32))
    oslot = np.ascontiguousarray(np.asarray(oslot, np.int32))
    lbr = np.ascontiguousarray(np.asarray(lbr, np.float32))
    rbr = np.ascontiguousarray(np.asarray(rbr, np.float32))
    ev = np.ascontiguousarray(np.asarray(ev, np.float32))
    rr = np.ascontiguousarray(np.asarray(rr, np.float32).reshape(-1))
    lib = _lib()
    if lib is None:
        return _tree_golden_np(codes, ttab, lsrc, rsrc, oslot, lbr, rbr,
                               ev, rr, S, C)
    n_leaves, n = codes.shape
    n_slots = int(max(oslot.max(), lsrc.max(), rsrc.max())) + 1
    lik = np.empty(n, np.float32)
    sc = np.empty(n, np.int32)
    if threads is None:
        threads = min(os.cpu_count() or 1, 16)
    lib.plf_tree_golden_mt(
        _i32p(codes), n, n_leaves, _f32p(ttab), ttab.shape[1],
        _i32p(lsrc), _i32p(rsrc), _i32p(oslot), len(lsrc), n_slots,
        _f32p(lbr), _f32p(rbr), _f32p(ev), _f32p(rr), S, C,
        _f32p(lik), _i32p(sc), int(threads))
    return lik, sc


def tree_golden_for_model(pm, threads: Optional[int] = None):
    """Run the whole-tree golden oracle on a ``PhyloModel``'s exact
    inputs: the port's planners (``ops/plf_tree.py::reorder_schedule`` and
    ``compile_register_schedule``), branch factors from the model's rates,
    the full tip table and the model's root rows.

    Returns ``(site_lik fp32 (n,), scaler_counts int32 (n,))`` over the
    model's ``n_sites`` sites, comparable bit for bit to the fused,
    per-node and segmented tree kernels' outputs before the log ("vpu"
    arithmetic)."""
    from ..io.alignment import map_tip_codes, tip_expansion_table
    from ..models.substitution import branch_matrices
    from ..ops.plf_tree import compile_register_schedule, reorder_schedule

    cfg = pm.config
    S, C = cfg.states, cfg.categories
    n_leaves = pm.tree.n_leaves
    sched_r = reorder_schedule(pm.schedule, n_leaves)
    arrs, _n_slots, _root = compile_register_schedule(sched_r, n_leaves)
    lsrc, lflag, rsrc, rflag, oslot, _eidx = arrs
    lsrc_u = lsrc + lflag * n_leaves
    rsrc_u = rsrc + rflag * n_leaves
    oslot_u = oslot + n_leaves
    lbr, rbr = [], []
    for (_p, _l, _r, tl, tr, _e) in sched_r:
        lbr.append(branch_matrices(pm.model, tl, pm.rates, C))
        rbr.append(branch_matrices(pm.model, tr, pm.rates, C))
    codes = map_tip_codes(pm.tip_states, S)
    ttab = tip_expansion_table(pm.model.w, S).astype(np.float32)
    rr = pm.root_rows.detach().cpu().numpy().astype(np.float32).reshape(-1)
    return plf_tree_golden_native(
        codes, ttab, lsrc_u, rsrc_u, oslot_u, np.stack(lbr),
        np.stack(rbr), pm.model.plf_ev, rr, states=S, categories=C,
        threads=threads)


def transpose_branch_native(branch, states=4, categories=4):
    """Per-category branch transpose (PL transpose analogue)."""
    lib = _lib()
    S, C = states, categories
    branch = np.ascontiguousarray(
        np.asarray(branch, np.float32).reshape(C, S, S))
    if lib is None:
        return np.ascontiguousarray(np.transpose(branch, (0, 2, 1)))
    out = np.empty_like(branch)
    lib.transpose_branch(_f32p(branch), _f32p(out), S, C)
    return out
