"""Golden-model CPU reference for the Phylogenetic Likelihood Function (PLF).

A copy of ``plf_tpu/reference.py`` (NumPy only), so that the port carries
its own oracle on machines without JAX.  This is the semantic contract of
the whole framework: a vectorised NumPy re-implementation of the RAxML
``newviewGAMMA`` inner kernel that the reference accelerator computes
(``app/src/plf.cpp:8-68`` of the reference).  Every kernel of
:mod:`plf_tpu_torch` is validated against this function, and the fp32
operation *order* here is bit-identical to the scalar C loop so that the
CUDA kernels can target exact equality.

Semantics (DNA: 4 states x 4 gamma-rate categories = 16 floats/site):

For each alignment site ``i``:
  1. ``ump1[c,k] = sum_a x1[i,c,a] * left[c,k,a]``   (per-category 1x4 . 4x4)
     ``ump2[c,k] = sum_a x2[i,c,a] * right[c,k,a]``
  2. ``p[c,k]   = ump1[c,k] * ump2[c,k]``            (element-wise child product)
  3. ``x3[i,c,a] = sum_k p[c,k] * ev[k,a]``          (eigenvector projection)
  4. if every ``|x3[i,:,:]| < 2**-32``: multiply the whole site by ``2**32``
     and add ``wgt[i]`` to the scaler increment (numerical underflow rescue).

All arithmetic is IEEE fp32 with left-to-right sequential accumulation,
matching the C reference exactly (sequential ``+=`` starting from 0.0).
"""

from __future__ import annotations

import numpy as np

TWO_TO_THE_32 = np.float32(4294967296.0)
MIN_LIKELIHOOD = np.float32(1.0) / TWO_TO_THE_32  # 2**-32

__all__ = [
    "TWO_TO_THE_32",
    "MIN_LIKELIHOOD",
    "plf_reference",
    "plf_reference_scalar",
]


def _as_f32(name, x, shape=None):
    x = np.asarray(x, dtype=np.float32)
    if shape is not None and x.shape != shape:
        x = x.reshape(shape)
    return x


def plf_reference(x1, x2, left, right, ev, wgt=None, states: int = 4,
                  categories: int = 4):
    """Vectorised golden PLF, bit-exact to the scalar C reference.

    Args:
      x1, x2: child CLVs, shape ``(n, categories*states)`` (site-major, the
        RAxML memory layout ``clv[site*16 + cat*4 + state]``) or
        ``(n, categories, states)``.
      left, right: branch transition matrices, shape
        ``(categories, states, states)`` indexed ``[c, k, a]`` (flat RAxML
        layout ``left[c*16 + k*4 + a]`` also accepted as 1-D of length
        ``categories*states*states``).
      ev: eigenvector matrix, shape ``(states, states)`` indexed ``[k, a]``.
      wgt: per-site integer weights, shape ``(n,)``; defaults to all-ones.
      states, categories: model dimensions (DNA: 4/4; protein: 20/4).

    Returns:
      ``(x3, scaler_vector, scaler_increment)`` where ``x3`` has shape
      ``(n, categories, states)`` fp32, ``scaler_vector`` is an ``(n,)``
      uint8 array of per-site rescale flags (the reference s2mm's per-site
      scaler byte stream), and ``scaler_increment = sum(scaler_vector*wgt)``.
    """
    S, C = int(states), int(categories)
    x1 = _as_f32("x1", x1).reshape(-1, C, S)
    x2 = _as_f32("x2", x2).reshape(-1, C, S)
    n = x1.shape[0]
    if x2.shape[0] != n:
        raise ValueError(f"x1/x2 site count mismatch: {n} vs {x2.shape[0]}")
    left = _as_f32("left", left, (C, S, S))
    right = _as_f32("right", right, (C, S, S))
    ev = _as_f32("ev", ev, (S, S))
    if wgt is None:
        wgt = np.ones((n,), dtype=np.int32)
    wgt = np.asarray(wgt, dtype=np.int64).reshape(n)

    # Stage 1: per-category branch products, sequential over source state a
    # to reproduce the C loop's fp32 accumulation order.
    ump1 = np.zeros((n, C, S), dtype=np.float32)
    ump2 = np.zeros((n, C, S), dtype=np.float32)
    for a in range(S):
        ump1 += x1[:, :, a:a + 1] * left[None, :, :, a]
        ump2 += x2[:, :, a:a + 1] * right[None, :, :, a]

    # Stage 2: element-wise child product.
    p = ump1 * ump2

    # Stage 3: eigenvector projection, sequential over k.
    x3 = np.zeros((n, C, S), dtype=np.float32)
    for k in range(S):
        x3 += p[:, :, k:k + 1] * ev[None, None, k, :]

    # Stage 4: underflow rescaling.
    scale_mask = np.all(np.abs(x3) < MIN_LIKELIHOOD, axis=(1, 2))
    x3 = np.where(scale_mask[:, None, None], x3 * TWO_TO_THE_32, x3)
    scaler_vector = scale_mask.astype(np.uint8)
    scaler_increment = int(np.sum(scaler_vector.astype(np.int64) * wgt))
    return x3, scaler_vector, scaler_increment


def plf_reference_scalar(x1, x2, left, right, ev, wgt=None, states: int = 4,
                         categories: int = 4):
    """Pure-scalar triple-loop PLF (slow; oracle for the vectorised oracle).

    Literal transcription of the accumulation structure of the C reference
    (``app/src/plf.cpp:19-64``) in Python floats-on-np.float32; used only in
    tests to certify :func:`plf_reference` on small inputs.
    """
    S, C = int(states), int(categories)
    x1 = _as_f32("x1", x1).reshape(-1, C, S)
    x2 = _as_f32("x2", x2).reshape(-1, C, S)
    left = _as_f32("left", left, (C, S, S))
    right = _as_f32("right", right, (C, S, S))
    ev = _as_f32("ev", ev, (S, S))
    n = x1.shape[0]
    if wgt is None:
        wgt = np.ones((n,), dtype=np.int32)

    x3 = np.zeros((n, C, S), dtype=np.float32)
    scaler_vector = np.zeros((n,), dtype=np.uint8)
    add_scale = 0
    for i in range(n):
        for c in range(C):
            pk = np.zeros((S,), dtype=np.float32)
            for k in range(S):
                u1 = np.float32(0.0)
                u2 = np.float32(0.0)
                for a in range(S):
                    u1 += x1[i, c, a] * left[c, k, a]
                    u2 += x2[i, c, a] * right[c, k, a]
                pk[k] = u1 * u2
            for k in range(S):
                for a in range(S):
                    x3[i, c, a] += pk[k] * ev[k, a]
        if np.all(np.abs(x3[i]) < MIN_LIKELIHOOD):
            x3[i] *= TWO_TO_THE_32
            scaler_vector[i] = 1
            add_scale += int(wgt[i])
    return x3, scaler_vector, add_scale
