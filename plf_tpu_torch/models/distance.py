"""Pairwise sequence distances + Neighbor-Joining starting trees.

Counterpart of ``plf_tpu/models/distance.py``.  RAxML seeds its
likelihood search with a distance-based starting tree; this module
supplies that front end:

* the O(L^2 * n) pairwise mismatch counting runs on the model's device as
  (L, n) @ (n, L) matmuls, batched over states via one-hot planes;
* the O(L^3) Neighbor-Joining agglomeration runs on host NumPy (tiny,
  sequential, data-dependent);
* output is a rooted binary :class:`~plf_tpu_torch.models.tree.Tree`
  ready for ``PhyloModel`` / ``tree_search``.

Distances use the Jukes-Cantor correction generalised to S states
(d = -(S-1)/S * log(1 - S/(S-1) * p)), with gap/ambiguous sites (code
>= S) excluded pairwise, and site weights (pattern compression,
io/alignment.compress_patterns) honoured exactly.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .tree import Tree, TreeNode

__all__ = ["pairwise_mismatch", "jc_distance_matrix", "neighbor_joining",
           "nj_tree"]

# Distances are clipped here when p >= saturation (log argument <= 0);
# RAxML similarly caps undefined JC distances at a large finite value.
MAX_DISTANCE = 10.0
MIN_BRANCH = 1e-6

#: Counts of an fp32 product stay exact while the weighted site total is
#: below 2^24; above it the products run in float64.
EXACT_FP32_TOTAL = 1 << 24


def pairwise_mismatch(codes, wgt=None, states: int = 4,
                      device: Union[str, torch.device] = "cuda"):
    """Weighted pairwise (mismatch, comparable-site) counts on ``device``.

    Args:
      codes: ``(L, n)`` int array of state codes; ``>= states`` means
        gap/ambiguous (excluded from the pair's comparable sites).
      wgt: ``(n,)`` site weights (pattern multiplicities); default 1.
      states: alphabet size S.

    Returns:
      ``(diff, total)``: two ``(L, L)`` tensors on ``device`` -- weighted
      count of differing sites and of pairwise-comparable sites.

    Per-state one-hot planes ``I_s`` give ``matches = sum_s I_s W I_s^T``
    and ``total = V W V^T`` with ``V = any_s I_s``.  The counts are
    integers and must stay exact (the JAX package runs these matmuls at
    ``Precision.HIGHEST``): here in fp32 with TF32 off for the call, or in
    float64 where the weighted total could pass 2^24.
    """
    device = torch.device(device)
    codes = torch.as_tensor(np.asarray(codes), dtype=torch.int32,
                            device=device)
    L, n = codes.shape
    w = (np.ones(n, np.float64) if wgt is None
         else np.asarray(wgt, np.float64))
    dtype = (torch.float32 if float(np.abs(w).sum()) < EXACT_FP32_TOTAL
             else torch.float64)
    w = torch.as_tensor(w, dtype=dtype, device=device)
    valid = (codes >= 0) & (codes < states)
    v = valid.to(dtype)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        total = (v * w[None, :]) @ v.T
        matches = torch.zeros((L, L), dtype=dtype, device=device)
        for s in range(states):
            plane = ((codes == s) & valid).to(dtype)
            matches = matches + (plane * w[None, :]) @ plane.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return total - matches, total


def jc_distance_matrix(codes, wgt=None, states: int = 4,
                       device: Union[str, torch.device] = "cuda"
                       ) -> np.ndarray:
    """S-state Jukes-Cantor ML distance matrix (host fp64 finish).

    ``d = -(S-1)/S * log(1 - S/(S-1) * p)`` with ``p`` the weighted
    mismatch fraction over pairwise-comparable sites; saturated or
    incomparable pairs get :data:`MAX_DISTANCE`.
    """
    diff, total = pairwise_mismatch(codes, wgt, states=states,
                                    device=device)
    diff = diff.cpu().numpy().astype(np.float64)
    total = total.cpu().numpy().astype(np.float64)
    S = float(states)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(total > 0, diff / np.maximum(total, 1.0), np.nan)
        arg = 1.0 - S / (S - 1.0) * p
        d = np.where(arg > 0, -(S - 1.0) / S * np.log(np.maximum(arg, 1e-300)),
                     MAX_DISTANCE)
    d = np.where(np.isfinite(d), d, MAX_DISTANCE)
    d = np.minimum(d, MAX_DISTANCE)
    np.fill_diagonal(d, 0.0)
    return d


def neighbor_joining(dist: np.ndarray,
                     names: Optional[Sequence[str]] = None) -> Tree:
    """Saitou-Nei Neighbor-Joining on a distance matrix.

    Produces the (unrooted) NJ tree rooted at the final join — a rooted
    binary :class:`Tree` whose unrooted topology is the NJ topology and
    whose path lengths between leaves reproduce the NJ edge estimates.
    Negative NJ branch estimates are clamped to :data:`MIN_BRANCH`
    (standard practice; likelihood optimisation refits them anyway).
    """
    D = np.array(dist, dtype=np.float64)
    L = D.shape[0]
    if D.shape != (L, L):
        raise ValueError(f"distance matrix must be square, got {D.shape}")
    if L < 2:
        raise ValueError("need at least 2 taxa")
    if names is None:
        names = [f"t{i}" for i in range(L)]

    nodes: List[TreeNode] = [
        TreeNode(index=i, name=str(names[i])) for i in range(L)]

    # active cluster -> node index
    active = list(range(L))
    # Growable working matrix indexed by node id.
    size = 2 * L
    W = np.zeros((size, size), dtype=np.float64)
    W[:L, :L] = D

    def new_node(a: int, b: int, la: float, lb: float) -> int:
        idx = len(nodes)
        nodes[a] = TreeNode(index=a, name=nodes[a].name,
                            length=max(la, MIN_BRANCH),
                            children=nodes[a].children)
        nodes[b] = TreeNode(index=b, name=nodes[b].name,
                            length=max(lb, MIN_BRANCH),
                            children=nodes[b].children)
        nodes.append(TreeNode(index=idx, children=(a, b)))
        return idx

    while len(active) > 2:
        m = len(active)
        sub = W[np.ix_(active, active)]
        r = sub.sum(axis=1)
        # Q matrix; argmin over off-diagonal entries.
        Q = (m - 2) * sub - r[:, None] - r[None, :]
        np.fill_diagonal(Q, np.inf)
        i, j = np.unravel_index(np.argmin(Q), Q.shape)
        if i > j:
            i, j = j, i
        a, b = active[i], active[j]
        dij = sub[i, j]
        la = 0.5 * dij + (r[i] - r[j]) / (2.0 * (m - 2))
        lb = dij - la
        u = new_node(a, b, la, lb)
        # Distances from the new cluster to the rest.
        rest = [k for k in range(m) if k not in (i, j)]
        for k in rest:
            c = active[k]
            W[u, c] = W[c, u] = 0.5 * (sub[i, k] + sub[j, k] - dij)
        active = [active[k] for k in rest] + [u]

    a, b = active
    d = W[a, b]
    root = new_node(a, b, 0.5 * d, 0.5 * d)
    return Tree(nodes=nodes, root=root)


def nj_tree(codes, wgt=None, names: Optional[Sequence[str]] = None,
            states: int = 4, device: Union[str, torch.device] = "cuda"
            ) -> Tree:
    """Convenience: codes -> JC distances on ``device`` -> host NJ tree."""
    d = jc_distance_matrix(codes, wgt, states=states, device=device)
    return neighbor_joining(d, names)
