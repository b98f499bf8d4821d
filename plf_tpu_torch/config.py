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
"""

from __future__ import annotations

import dataclasses
from enum import Enum


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

    def to_name(self) -> str:
        """Config-name string in the JAX package's token order (the port
        has one buffer layout and one streaming form)."""
        st = "DNA" if self.states == 4 else f"{self.states}state"
        return (f"plftorch_{st}_window_1inEV_{self.backend.value}"
                f"_blk{self.block_sites}")
