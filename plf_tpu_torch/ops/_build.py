"""Build and load the CUDA kernels of ``plf_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` into ``build/plf_tpu_torch/lib<name>-<hash>.so``
at the root of the checkout and loaded with ``ctypes``.  The hash covers
the sources (the ``.cu`` file and every ``csrc/*.cuh``) and the flags, so
an edited source rebuilds and an unchanged one loads the library built
before.  Nothing is downloaded and no prebuilt binary is used; a failed
build raises with nvcc's output.

A kernel with a bf16 CLV storage form (``PLFConfig(dtype="bfloat16")``)
is built twice from its one source: library ``<name>`` holds the float
form and ``<name>_bf16`` (``storage_library(name, True)``, nvcc given
``-DPLF_BF16_STORAGE``) the bf16 one, so that the two compile in
parallel and the float form is the code it was before bf16 storage.

Flags: ``-fmad=false`` keeps every ``a*b + c`` as a rounded multiply and
a rounded add (the golden model's order), and neither ``-use_fast_math``
nor ``-ftz=true`` is given, so subnormals are kept as the golden model
keeps them.  The kernels also spell the arithmetic with ``__fmul_rn`` /
``__fadd_rn``, which nvcc never contracts.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..utils.profiling import span

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build_libraries",
           "load_library", "build_log", "storage_library"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "plf_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
BF16_SUFFIX = "_bf16"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    which = shutil.which("nvcc")
    if which:
        cand.append(which)
    for c in cand:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def storage_library(source: str, bf16: bool) -> str:
    """Name of the library of ``csrc/<source>.cu`` for float or bf16 CLV
    storage."""
    return source + BF16_SUFFIX if bf16 else source


def _source(name: str):
    """``(csrc/<source>.cu, extra nvcc flags)`` of library ``name``."""
    if name.endswith(BF16_SUFFIX):
        return (CSRC / f"{name[:-len(BF16_SUFFIX)]}.cu",
                ("-DPLF_BF16_STORAGE",))
    return CSRC / f"{name}.cu", ()


def _digest(name: str) -> str:
    src, extra = _source(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS + extra).encode())
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_log(name: str) -> Path:
    """Path of the compiler output kept beside the library (ptxas prints
    each kernel's registers, shared memory and spills there)."""
    return BUILD_DIR / f"lib{name}-{_digest(name)}.log"


def _library(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_libraries(names) -> None:
    """Build every library of ``names`` (``csrc/<name>.cu``, or its bf16
    storage form) that is missing or stale, one nvcc each, all started
    together; raise with nvcc's output if one fails (the others are
    stopped).  Each build log records its own nvcc's seconds; the wait
    for the batch is the span ``ops.nvcc``."""
    jobs = []
    try:
        for name in names:
            so = _library(name)
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            src, extra = _source(name)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            out = so.with_suffix(f".{os.getpid()}.out")
            cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o",
                   str(tmp), str(src)]
            with open(out, "w") as f:
                proc = subprocess.Popen(cmd, stdout=f,
                                        stderr=subprocess.STDOUT)
            jobs.append(dict(name=name, so=so, tmp=tmp, out=out, cmd=cmd,
                             t0=time.perf_counter(), proc=proc, secs=None))
        with span("ops.nvcc") if jobs else contextlib.nullcontext():
            while any(j["secs"] is None for j in jobs):
                for j in jobs:
                    if j["secs"] is None and j["proc"].poll() is not None:
                        j["secs"] = time.perf_counter() - j["t0"]
                time.sleep(0.05)
        for j in jobs:
            text = j["out"].read_text()
            if j["proc"].returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {j['name']} (exit "
                    f"{j['proc'].returncode}):\n{' '.join(j['cmd'])}\n{text}")
            build_log(j["name"]).write_text(
                f"{' '.join(j['cmd'])}\n# {j['secs']:.1f} s\n{text}")
            os.replace(j["tmp"], j["so"])
    finally:
        for j in jobs:
            if j["proc"].poll() is None:
                j["proc"].kill()
                j["proc"].wait()
            j["out"].unlink(missing_ok=True)


def load_library(name: str) -> ctypes.CDLL:
    """Build library ``name`` if its hash changed, then load it (once
    per process: the callers cache the handle); the span ``ops.load``."""
    with span("ops.load"):
        build_libraries([name])
        return ctypes.CDLL(str(_library(name)))
