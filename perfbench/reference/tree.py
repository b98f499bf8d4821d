"""Random rooted binary trees, as plain arrays.

The join rule is ``random_tree``'s (``plf_tpu_torch/models/tree.py:192-208``
at commit c0abfbb): two of the available nodes, drawn uniformly, are
joined under a new node until one is left, and each branch is
``exponential(mean_branch) + 1e-3``.  Here the topology and the lengths
come from two generators, so that a configuration can hold its topology
fixed while every seed draws new lengths: the work of a step then does
not depend on the seed.

Nodes ``0..n_leaves-1`` are the leaves; every internal node is made
after its two children, so increasing index is a post-order and the root
is the last node.  ``lengths[i]`` is the branch from node ``i`` to its
parent (the root's entry is unused).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["random_topology", "random_lengths"]


def random_topology(n_leaves: int, seed: int) -> List[Tuple[int, int]]:
    """``children[k]`` of internal node ``n_leaves + k``."""
    rng = np.random.default_rng(seed)
    avail = list(range(n_leaves))
    children = []
    while len(avail) > 1:
        i = avail.pop(rng.integers(len(avail)))
        j = avail.pop(rng.integers(len(avail)))
        children.append((i, j))
        avail.append(n_leaves + len(children) - 1)
    return children


def random_lengths(n_nodes: int, seed: int,
                   mean_branch: float = 0.1) -> np.ndarray:
    """``(n_nodes,)`` float64 branch lengths."""
    rng = np.random.default_rng(seed)
    return rng.exponential(mean_branch, n_nodes) + 1e-3
