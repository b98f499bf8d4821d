"""CLV memory layouts and the padding policy (torch/numpy twin of
``plf_tpu/ops/layout.py``).

* **site-major** ``(n, categories*states)``: the RAxML/host layout
  (``clv[site*16 + cat*4 + state]``), the user-facing format.
* **lane-major** ``(states*categories, n)`` with row ``state*C + cat``:
  the on-device layout.  On the GPU one thread owns one site, so a warp's
  loads of one row touch 32 neighbouring floats and coalesce.

Every function takes a NumPy array or a torch tensor and returns the same
kind, so arrays cross between this package and the JAX package by value.
Site counts pad up to a multiple of the padding unit (``block_sites``);
padded sites are masked out of the scaler stream by the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "cdiv", "pad_to_multiple", "sites_padding",
    "to_lane_major", "from_lane_major",
    "branch_to_lane_constants", "ev_to_lane_constants",
    "branch_to_block_matrix", "ev_to_block_matrix",
]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sites_padding(n: int, block: int) -> int:
    """Padded site count (ceil to block multiple), min one block."""
    return max(block, cdiv(n, block) * block)


def pad_to_multiple(x, block: int, axis: int = -1):
    """Zero-pad ``x`` along ``axis`` up to a multiple of ``block``."""
    n = x.shape[axis]
    target = sites_padding(n, block)
    if target == n:
        return x
    if isinstance(x, np.ndarray):
        pads = [(0, 0)] * x.ndim
        pads[axis] = (0, target - n)
        return np.pad(x, pads)
    shape = list(x.shape)
    shape[axis] = target - n
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _transpose(x, axes):
    if isinstance(x, np.ndarray):
        return np.transpose(x, axes)
    return x.permute(*axes)


def to_lane_major(clv, states: int = 4, categories: int = 4):
    """site-major ``(n, C*S)`` or ``(n, C, S)`` -> lane-major ``(S*C, n)``
    (row = state*C + cat)."""
    S, C = states, categories
    x = _transpose(clv.reshape(-1, C, S), (2, 1, 0))   # (a, c, n)
    return x.reshape(S * C, -1)


def from_lane_major(x, states: int = 4, categories: int = 4, n=None):
    """lane-major ``(S*C, n_pad)`` -> site-major ``(n, C, S)``."""
    S, C = states, categories
    y = _transpose(x.reshape(S, C, -1), (2, 1, 0))     # (n_pad, c, a)
    if n is not None:
        y = y[:n]
    return y


def branch_to_lane_constants(branch, states: int = 4, categories: int = 4):
    """Branch matrix ``(C, S, S)`` ``[c, k, a]`` -> ``(S*C, S)`` fp32 with
    ``Lc[k*C + c, a] = branch[c, k, a]`` (stage-1 columns)."""
    S, C = states, categories
    out = _transpose(branch.reshape(C, S, S), (1, 0, 2)).reshape(S * C, S)
    if isinstance(out, np.ndarray):
        return out.astype(np.float32)
    return out.to(torch.float32).contiguous()


def ev_to_lane_constants(ev, states: int = 4, categories: int = 4):
    """Eigenvector matrix ``(S, S)`` ``[k, a]`` -> ``(S*C, S)`` with
    ``Ec[a*C + c, k] = ev[k, a]`` (stage-3 columns, rows replicated over
    the C categories)."""
    S, C = states, categories
    if isinstance(ev, np.ndarray):
        e = np.repeat(np.transpose(ev.reshape(S, S), (1, 0)), C, axis=0)
        return e.astype(np.float32)
    e = torch.repeat_interleave(ev.reshape(S, S).t(), C, dim=0)
    return e.to(torch.float32).contiguous()


def _like(m: np.ndarray, x):
    """``m`` as the kind of ``x`` (a NumPy array or a CPU tensor)."""
    return m if isinstance(x, np.ndarray) else torch.as_tensor(m)


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def branch_to_block_matrix(branch, states: int = 4, categories: int = 4):
    """Branch matrix ``(C, S, S)`` ``[c, k, a]`` -> the ``(S*C, S*C)``
    block operator of the JAX package's MXU kernels,
    ``M[k*C + c, a*C + c] = branch[c, k, a]`` and zero across categories.
    Its non-zero entries are exactly :func:`branch_to_lane_constants`'s
    ``Lc[k*C + c, a]``, which is what the port's kernels take; this form
    exchanges operators with the JAX package by value."""
    S, C = states, categories
    b = _as_numpy(branch).reshape(C, S, S)               # [c, k, a]
    m = np.zeros((S * C, S * C), np.float32)
    for c in range(C):
        m[np.arange(S)[:, None] * C + c,
          np.arange(S)[None, :] * C + c] = b[c]          # [k, a] block
    return _like(m, branch)


def ev_to_block_matrix(ev, states: int = 4, categories: int = 4):
    """Eigenvector matrix ``(S, S)`` ``[k, a]`` -> the stage-3 block
    operator ``M[a*C + c, k*C + c] = ev[k, a]``; its non-zero entries are
    :func:`ev_to_lane_constants`'s ``Ec[a*C + c, k]``."""
    S, C = states, categories
    e = _as_numpy(ev).reshape(S, S)                      # [k, a]
    m = np.zeros((S * C, S * C), np.float32)
    for c in range(C):
        m[np.arange(S)[:, None] * C + c,
          np.arange(S)[None, :] * C + c] = e.T           # [a, k] block
    return _like(m, ev)
