"""plf_tpu_torch -- the PyTorch/CUDA port of plf_tpu.

The whole-tree likelihood paths of the JAX package on PyTorch (DNA
serving and branch-length training; protein serving under every MXU
variant), with their Pallas kernels rewritten by hand in CUDA C++ for
Hopper (``csrc/``): the single-node PLF (``ops/plf_node.py``, its matrix
forms in ``ops/plf_mxu.py``), the whole-tree forward (``ops/plf_tree.py``)
and both backward kernels (``ops/plf_grad.py``, ``ops/plf_tree_grad.py``).
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; on a CPU tensor every kernel wrapper runs its plain PyTorch
version instead.  This package never imports JAX or ``plf_tpu``.
"""

from .config import PLFConfig, Backend
from .reference import plf_reference, MIN_LIKELIHOOD, TWO_TO_THE_32
from .engine import PLFEngine, PLFResult, plf

__version__ = "0.1.0"
