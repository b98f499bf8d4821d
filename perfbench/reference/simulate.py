"""Alignments simulated on the card from a seed.

``simulate_alignment``'s algorithm (``plf_tpu_torch/models/simulate.py``
at commit c0abfbb) in torch, so that millions of sites take a second on
the card and not minutes on the host: every site draws a rate category
uniformly, the root draws its state from ``pi``, and each child draws its
state from the row of its parent's state in ``P(t r_c)``, clipped at 0
and renormalised.  All draws come from one ``torch.Generator`` seeded
with the run's seed, so one seed on one device gives one alignment.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .substitution import Model, transition_matrices

__all__ = ["simulate"]


def _draw(cdf: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One state a row of ``cdf`` (n, S): the count of entries below a
    uniform draw, the last state where rounding leaves the sum under 1."""
    u = torch.rand(cdf.shape[0], 1, generator=gen, device=cdf.device,
                   dtype=cdf.dtype)
    return (u > cdf).sum(dim=1).clamp_max_(cdf.shape[1] - 1)


def simulate(children: Sequence[Tuple[int, int]], lengths: np.ndarray,
             model: Model, rates: np.ndarray, n_sites: int, seed: int,
             device) -> torch.Tensor:
    """``(n_leaves, n_sites)`` int8 tip states on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    n_leaves = len(children) + 1
    root = 2 * n_leaves - 2
    C = len(rates)
    cat = torch.randint(0, C, (n_sites,), generator=gen, device=device)
    pi = torch.as_tensor(model.pi, dtype=torch.float64, device=device)
    states = {root: _draw(torch.cumsum(pi, 0).expand(n_sites, -1), gen)}
    tips = torch.empty(n_leaves, n_sites, dtype=torch.int8, device=device)
    p = transition_matrices(
        model, torch.as_tensor(lengths, dtype=torch.float64, device=device),
        torch.as_tensor(rates, dtype=torch.float64, device=device))
    p = p.clamp_min(0.0)
    cdf = torch.cumsum(p / p.sum(dim=-1, keepdim=True), dim=-1)
    for k in reversed(range(len(children))):       # parents first
        parent = states.pop(n_leaves + k)
        for ch in children[k]:
            s = _draw(cdf[ch][cat, parent], gen)
            if ch < n_leaves:
                tips[ch] = s.to(torch.int8)
            else:
                states[ch] = s
    return tips
