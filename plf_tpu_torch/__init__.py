"""plf_tpu_torch -- the PyTorch/CUDA port of plf_tpu.

The DNA whole-tree likelihood path of the JAX package on PyTorch, with its
two Pallas kernels rewritten by hand in CUDA C++ for Hopper (``csrc/``):
the single-node PLF (``ops/plf_node.py``) and the whole-tree forward
(``ops/plf_tree.py``).  On a CPU tensor every kernel wrapper runs its plain
PyTorch version instead.  This package never imports JAX or ``plf_tpu``.
"""

from .config import PLFConfig, Backend
from .reference import plf_reference, MIN_LIKELIHOOD, TWO_TO_THE_32
from .engine import PLFEngine, PLFResult

__version__ = "0.1.0"
