"""ctypes binding to the port's native golden oracle.

Counterpart of the golden part of ``plf_tpu/runtime/native.py``: a fast,
multithreaded, bit-exact host recompute of the PLF (the reference verifies
every benchmark run against one, ``host_mem.cpp:403-442``), from
``plf_tpu_torch/native/plf_native.cpp``.  At first use the source is built
with g++ (``plf_tpu/native/Makefile``'s flags; ``-ffp-contract=off`` keeps
the golden model's uncontracted order) into ``build/plf_tpu_torch/`` at
the root of the checkout, under a name that hashes the source, the flags
and the host CPU, so a library built for another machine is never loaded.
Without a compiler the NumPy golden model (``reference.plf_reference``)
answers instead, with the same bits; :func:`golden_oracle` says which.
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

__all__ = ["plf_golden_native", "golden_oracle"]

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
