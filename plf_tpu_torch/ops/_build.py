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

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "load_library", "build_log"]

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


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its hash changed, then load it (once
    per process: the callers cache the handle)."""
    so = BUILD_DIR / f"lib{name}-{_digest(name)}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        build_log(name).write_text(
            f"{' '.join(cmd)}\n# {time.perf_counter() - t0:.1f} s\n"
            f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))
