"""Plain site-major PyTorch PLF (the ``Backend.TORCH`` path).

Counterpart of ``plf_tpu/ops/plf_xla.py``: the golden model's stage
structure as elementwise torch ops over ``(n, categories, states)`` site
batches, on whatever device the inputs live.  Each product and each sum
is its own torch op, so nothing contracts into an FMA and the result
keeps the golden model's fp32 order.
"""

from __future__ import annotations

import torch

from ..reference import MIN_LIKELIHOOD, TWO_TO_THE_32

__all__ = ["plf_torch"]


def plf_torch(x1, x2, left, right, ev, wgt, states: int = 4,
              categories: int = 4):
    """PLF over a site batch; all inputs site-major tensors on one device.

    Args:
      x1, x2: ``(n, C*S)`` or ``(n, C, S)`` fp32 child CLVs.
      left, right: ``(C, S, S)`` branch matrices ``[c, k, a]``.
      ev: ``(S, S)`` eigenvector matrix ``[k, a]``.
      wgt: ``(n,)`` integer site weights.

    Returns:
      ``(x3, scaler_vector, scaler_increment)``: ``(n, C, S)`` fp32,
      ``(n,)`` int32 flags and the weighted flag sum as an int64 scalar.
    """
    S, C = states, categories
    x1 = x1.reshape(-1, C, S).to(torch.float32)
    x2 = x2.reshape(-1, C, S).to(torch.float32)
    left = left.reshape(C, S, S).to(torch.float32)
    right = right.reshape(C, S, S).to(torch.float32)
    ev = ev.reshape(S, S).to(torch.float32)

    ump1 = x1[:, :, 0:1] * left[None, :, :, 0]
    ump2 = x2[:, :, 0:1] * right[None, :, :, 0]
    for a in range(1, S):
        ump1 = ump1 + x1[:, :, a:a + 1] * left[None, :, :, a]
        ump2 = ump2 + x2[:, :, a:a + 1] * right[None, :, :, a]
    p = ump1 * ump2
    x3 = p[:, :, 0:1] * ev[None, None, 0, :]
    for k in range(1, S):
        x3 = x3 + p[:, :, k:k + 1] * ev[None, None, k, :]

    scale_mask = (x3.abs() < float(MIN_LIKELIHOOD)).all(dim=2).all(dim=1)
    x3 = torch.where(scale_mask[:, None, None], x3 * float(TWO_TO_THE_32), x3)
    scaler_vector = scale_mask.to(torch.int32)
    scaler_increment = (scaler_vector.to(torch.int64)
                        * wgt.to(torch.int64)).sum()
    return x3, scaler_vector, scaler_increment
