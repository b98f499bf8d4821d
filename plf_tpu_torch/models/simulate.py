"""Sequence simulation: sample alignments from (tree, model).

A copy of ``plf_tpu/models/simulate.py`` (NumPy only): draw root states
from the stationary distribution and evolve them down the tree with the
per-branch transition matrices (per-site gamma rate categories and the
+I mixture included).  The same seed gives the JAX package's alignment.
Used for workloads with realistic site patterns and for fitting tests
(``fit_codon`` recovers the omega and kappa it simulated under).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .substitution import SubstitutionModel, discrete_gamma_rates
from .tree import Tree

__all__ = ["simulate_alignment"]


def simulate_alignment(tree: Tree, model: SubstitutionModel, n_sites: int,
                       alpha: Optional[float] = None, categories: int = 4,
                       seed: int = 0,
                       p_inv: Optional[float] = None) -> np.ndarray:
    """Simulate tip states under the model.

    ``p_inv`` draws that proportion of sites from a rate-0 invariant
    category (the +I(+G) mixture, substitution.gamma_invariant_rates).
    Returns (n_leaves, n_sites) int8 state codes in tree leaf order.
    """
    rng = np.random.default_rng(seed)
    S = model.states
    if p_inv is not None:
        from .substitution import gamma_invariant_rates
        rates, weights = gamma_invariant_rates(alpha, p_inv, categories)
        categories = categories + 1
        site_cat = rng.choice(categories, size=n_sites, p=weights)
    else:
        if alpha is None:
            rates = np.ones(categories)
        else:
            rates = discrete_gamma_rates(alpha, categories)
        site_cat = rng.integers(0, categories, size=n_sites)

    # Parent-before-children order = reversed post-order schedule.
    schedule = tree.schedule()
    root = tree.root
    states = {root: rng.choice(S, size=n_sites, p=model.pi)}

    # Precompute per (node, category) transition matrices lazily.
    def evolve(parent_states, t):
        out = np.empty(n_sites, dtype=np.int64)
        for c in range(categories):
            mask = site_cat == c
            if not mask.any():
                continue
            P = model.p_matrix(t, rates[c])
            P = np.clip(P, 0.0, None)
            P = P / P.sum(axis=1, keepdims=True)
            ps = parent_states[mask]
            u = rng.random(ps.shape[0])
            cdf = np.cumsum(P, axis=1)
            out[mask] = (u[:, None] > cdf[ps]).sum(axis=1)
        return out

    for parent, l, r, tl, tr in reversed(schedule):
        states[l] = evolve(states[parent], tl)
        states[r] = evolve(states[parent], tr)

    tips = np.stack([states[i] for i in range(tree.n_leaves)])
    return tips.astype(np.int8)
