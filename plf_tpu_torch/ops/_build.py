"""Build and load the CUDA kernels of ``plf_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` into ``build/plf_tpu_torch/lib<name>-<hash>.so``
at the root of the checkout and loaded with ``ctypes``.  The hash covers
the sources (the ``.cu`` file and every ``csrc/*.cuh``) and the flags, so
an edited source rebuilds and an unchanged one loads the library built
before.  Nothing is downloaded and no prebuilt binary is used; a failed
build raises with nvcc's output.

Flags: ``-fmad=false`` keeps every ``a*b + c`` as a rounded multiply and
a rounded add (the golden model's order), and neither ``-use_fast_math``
nor ``-ftz=true`` is given, so subnormals are kept as the golden model
keeps them.  The kernels also spell the arithmetic with ``__fmul_rn`` /
``__fadd_rn``, which nvcc never contracts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build_libraries",
           "load_library", "build_log"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "plf_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


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


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
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
    """Build every ``csrc/<name>.cu`` whose library is missing or stale,
    one nvcc per source, all started together; raise with nvcc's output
    if one fails (the others are stopped)."""
    jobs = []
    try:
        for name in names:
            so = _library(name)
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            jobs.append((name, so, tmp, cmd, time.perf_counter(),
                         subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True)))
        for name, so, tmp, cmd, t0, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {name}.cu (exit "
                    f"{proc.returncode}):\n{' '.join(cmd)}\n{out}")
            build_log(name).write_text(
                f"{' '.join(cmd)}\n# {time.perf_counter() - t0:.1f} s\n{out}")
            os.replace(tmp, so)
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its hash changed, then load it (once
    per process: the callers cache the handle)."""
    build_libraries([name])
    return ctypes.CDLL(str(_library(name)))
