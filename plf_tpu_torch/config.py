"""Configuration of the PyTorch/CUDA PLF engine.

Counterpart of ``plf_tpu/config.py``.  One frozen dataclass carries the
model dimensions and the compute path.

Differences from the JAX config:

* ``Backend.PALLAS`` is ``Backend.KERNEL`` (the hand-written CUDA kernels
  on a CUDA tensor, their plain PyTorch versions on a CPU tensor) and
  ``Backend.XLA`` is ``Backend.TORCH`` (the plain site-major PyTorch
  path, chosen explicitly).
* There is no ``interpret`` flag: which code runs follows the device of
  the tensors, never a guess about the platform.
* ``block_sites`` no longer sizes a kernel block (the CUDA kernels pick
  their own thread blocks); it keeps the padded site count ``n_pad`` a
  multiple of the same 128-site unit as the JAX package, so lane-major
  arrays cross between the two packages by value.
* ``instances``, ``layout`` and ``aie_type`` are not fields: the port has
  one buffer layout and one streaming form, and :meth:`PLFConfig.from_name`
  hands a name's instance count back beside the config.
"""

from __future__ import annotations

import dataclasses
import re
from enum import Enum
from typing import Tuple


class Backend(Enum):
    """Which compute path evaluates the PLF."""

    KERNEL = "kernel"        # hand-written CUDA kernel (plain twin on CPU)
    TORCH = "torch"          # plain site-major PyTorch path
    REFERENCE = "reference"  # NumPy golden model (host; testing only)


@dataclasses.dataclass(frozen=True)
class PLFConfig:
    """One config object for the whole engine."""

    states: int = 4            # 4 = DNA
    categories: int = 4        # gamma rate categories
    block_sites: int = 4096    # site padding unit (multiple of 128)
    backend: Backend = Backend.KERNEL
    dtype: str = "float32"     # CLV storage: "float32" or "bfloat16" (fp32
                               # arithmetic; honoured by PLFEngine.plf and
                               # the segmented engine's boundaries)
    tip_dtype: str = "int32"   # tip state-code storage: "int32" or "int8"
    kernel_variant: str = "vpu"  # "vpu" (bit-exact elementwise), "mxu"
                                 # (fp32), "mxu_3x" (bf16x3), "mxu_bf16"
                                 # (1-pass bf16) or "auto"

    def __post_init__(self):
        if self.states < 2:
            raise ValueError(f"states must be >= 2, got {self.states}")
        if self.categories < 1:
            raise ValueError(f"categories must be >= 1, got {self.categories}")
        if self.block_sites < 128 or self.block_sites % 128:
            raise ValueError(
                f"block_sites must be a positive multiple of 128, got "
                f"{self.block_sites}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.tip_dtype not in ("int32", "int8"):
            raise ValueError(f"unsupported tip_dtype {self.tip_dtype!r}")
        if self.kernel_variant not in ("vpu", "mxu", "mxu_3x", "mxu_bf16",
                                       "auto"):
            raise ValueError(
                f"unsupported kernel_variant {self.kernel_variant!r}")

    @property
    def resolved_kernel_variant(self) -> str:
        """Resolve "auto" exactly as the JAX package does: the exact
        elementwise form for small state counts, the bf16x3 matrix form
        from S > 8 on."""
        if self.kernel_variant != "auto":
            return self.kernel_variant
        return "vpu" if self.states <= 8 else "mxu_3x"

    @property
    def elements_per_site(self) -> int:
        return self.states * self.categories

    @property
    def rows(self) -> int:
        """Rows of the canonical lane-major CLV layout."""
        return self.states * self.categories

    @property
    def exact(self) -> bool:
        """Whether this config targets bit-exact golden-model equality."""
        return self.dtype == "float32" and self.backend in (
            Backend.KERNEL, Backend.REFERENCE)

    @classmethod
    def from_name(cls, name: str, **overrides) -> Tuple["PLFConfig", int]:
        """Parse a config name: the JAX package's (``plftpu_..._pallas_
        inst9_blk2048``), the port's own (:meth:`to_name`) or a reference
        xclbin name (``plf_mem4DNAwindowComb_128x9DNAwindow8192Comb``),
        with the JAX package's rules (``plf_tpu/config.py:162-207``).

        A reference window size is in bytes and becomes sites by ``>> 4``,
        rounded down to the 128-site unit; ``"<S>state"`` sets the states;
        ``_pallas``/``_kernel`` map to ``Backend.KERNEL``,
        ``_xla``/``_torch`` to ``Backend.TORCH``.  Returns ``(config,
        instances)``: the instance count (``inst<I>`` or ``128x<I>``, else
        1) is the caller's, since the config has no such field.
        """
        mb = re.search(r"blk(\d+)", name)
        if mb:
            block = int(mb.group(1))
        else:
            mw = re.search(r"(?:window|stream)(\d\d+)", name)
            if mw:
                block = max(128, (int(mw.group(1)) >> 4) // 128 * 128)
            else:
                block = 4096
        ms = re.search(r"(\d+)state", name)
        states = int(ms.group(1)) if ms else 4
        mi = re.search(r"inst(\d+)", name) or re.search(r"128x(\d+)", name)
        instances = int(mi.group(1)) if mi else 1
        backend = Backend.KERNEL
        for token, b in (("pallas", Backend.KERNEL),
                         ("kernel", Backend.KERNEL),
                         ("xla", Backend.TORCH), ("torch", Backend.TORCH),
                         ("reference", Backend.REFERENCE)):
            if f"_{token}" in name:
                backend = b
                break
        kw = dict(states=states, block_sites=block, backend=backend)
        kw.update(overrides)
        return cls(**kw), instances

    def to_name(self) -> str:
        """Config-name string in the JAX package's token order (the port
        has one buffer layout and one streaming form)."""
        st = "DNA" if self.states == 4 else f"{self.states}state"
        return (f"plftorch_{st}_window_1inEV_{self.backend.value}"
                f"_blk{self.block_sites}")
