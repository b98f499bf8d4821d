"""Felsenstein pruning in float64, its gradient, and Adam.

Conditional likelihoods are kept in state space (not eigen coordinates,
as the program keeps them), with ``P(t r_c)`` from the eigensystem of
``substitution.py`` and one rescale a node: each node's vector is divided
by its largest entry and the log of that factor added to the site's
log-likelihood.  The gradient comes from autograd through the same
computation, block by block of sites, so that a block's graph fits.

``precision`` selects the arithmetic: ``"fp64"`` is the reference;
``"tf32"`` and ``"bf16"`` are the controls, the same computation in
float32 with every operand of a matrix product (transition matrices and
conditional likelihoods) rounded to TF32's 10 or bfloat16's 7 mantissa
bits, products summed in float32, as a tensor core computes them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .substitution import Model, transition_matrices

__all__ = ["Problem", "log_likelihood", "adam_steps", "PRECISIONS"]

PRECISIONS = ("fp64", "tf32", "bf16")
_MANTISSA = {"tf32": 10, "bf16": 7}


@dataclasses.dataclass
class Problem:
    """A tree, a model and an alignment on one device."""

    children: Sequence[Tuple[int, int]]   # of internal node n_leaves + k
    model: Model
    tips: torch.Tensor                    # (n_leaves, n_sites) int8
    #: sites of a block: a block's graph of every node must fit the card
    block_sites: int = 1 << 18

    @property
    def n_leaves(self) -> int:
        return len(self.children) + 1

    @property
    def n_sites(self) -> int:
        return self.tips.shape[1]


def _round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 ``x`` rounded to nearest (ties to even) with ``bits``
    mantissa bits; the gradient passes through unchanged."""
    drop = 23 - bits
    i = x.detach().contiguous().view(torch.int32)
    half = (1 << (drop - 1)) - 1 + ((i >> drop) & 1)
    r = ((i + half) & ~((1 << drop) - 1)).view(torch.float32)
    return x + (r - x).detach()


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    bits = _MANTISSA.get(precision)
    return x if bits is None else _round_mantissa(x, bits)


def _block_ll(prob: Problem, p: torch.Tensor, tips: torch.Tensor,
              pi: torch.Tensor, precision: str) -> torch.Tensor:
    """Sum of the site log-likelihoods of one block of sites.  ``p``:
    ``(E, C, S, S)`` transition matrices; CLVs ``(C, n, S)``."""
    n_leaves = prob.n_leaves
    dt = p.dtype
    p = _operand(p, precision)
    pt = p.transpose(-1, -2)                 # [e, c, to, from]
    clv, logsc = {}, torch.zeros(tips.shape[1], dtype=dt, device=p.device)

    S = p.shape[-1]

    def toward_parent(ch):
        # a tip's vector is the one-hot of its state (a product, not a
        # gather: a gather's gradient would scatter into S*S entries)
        x = (torch.nn.functional.one_hot(tips[ch].long(), S).to(dt)
             if ch < n_leaves else _operand(clv.pop(ch), precision))
        return x @ pt[ch]

    for k, (left, right) in enumerate(prob.children):
        x = toward_parent(left) * toward_parent(right)
        m = x.detach().amax(dim=(0, 2)).clamp_min(torch.finfo(dt).tiny)
        clv[n_leaves + k] = x / m[None, :, None]
        logsc = logsc + torch.log(m)
    root = clv.pop(n_leaves + len(prob.children) - 1)
    C = root.shape[0]
    lik = (_operand(root, precision) @ _operand(pi.to(dt), precision)) \
        .sum(dim=0) / C
    return (torch.log(lik) + logsc).sum()


def log_likelihood(prob: Problem, lengths: torch.Tensor,
                   rates: torch.Tensor, precision: str = "fp64",
                   grad_of: Optional[torch.Tensor] = None,
                   sites: Optional[int] = None):
    """The tree's log-likelihood at ``lengths`` (``(n_nodes - 1,)``, the
    branch of each non-root node; a function of ``grad_of`` when given)
    and category ``rates`` (equal weights).  Returns ``(ll, grad)``:
    ``ll`` a Python float, ``grad`` d ll / d ``grad_of`` or None.
    ``sites`` limits the sum to the first that many sites."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    dt = torch.float64 if precision == "fp64" else torch.float32
    dev = prob.tips.device
    pi = torch.as_tensor(prob.model.pi, dtype=torch.float64, device=dev)
    n = prob.n_sites if sites is None else sites
    total, grad = 0.0, None
    for s0 in range(0, n, prob.block_sites):
        tips = prob.tips[:, s0:min(n, s0 + prob.block_sites)]
        with torch.set_grad_enabled(grad_of is not None):
            p = transition_matrices(prob.model, lengths, rates, dtype=dt)
            ll = _block_ll(prob, p, tips, pi, precision)
            if grad_of is not None:
                # the lengths' own graph serves every block
                (g,) = torch.autograd.grad(ll, grad_of, retain_graph=True)
                grad = g if grad is None else grad + g
        total += float(ll.detach())
        del p, ll                   # this block's graph, before the next
    return total, grad


def adam_steps(prob: Problem, t0: np.ndarray, rates: np.ndarray,
               steps: int, lr: float, min_length: float,
               precision: str = "fp64", sites: Optional[int] = None):
    """``steps`` Adam steps (torch.optim.Adam's rule: b1 0.9, b2 0.999,
    eps 1e-8 outside the square root) on log lengths, minimising the
    negative log-likelihood at lengths ``exp(log_t) + min_length``, as
    ``optimize_branch_lengths`` takes them.  Returns ``(losses, g1,
    change)``: each step's loss, the first gradient, and the log lengths'
    change after the last step."""
    dt = torch.float64 if precision == "fp64" else torch.float32
    dev = prob.tips.device
    t0 = torch.as_tensor(np.maximum(t0, min_length), dtype=dt, device=dev)
    log_t0 = torch.log(t0)
    log_t = log_t0.clone().requires_grad_()
    r = torch.as_tensor(rates, dtype=dt, device=dev)
    m = torch.zeros_like(log_t0)
    v = torch.zeros_like(log_t0)
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses: List[float] = []
    g1 = None
    for k in range(1, steps + 1):
        with torch.enable_grad():
            t = torch.exp(log_t) + min_length
        ll, g = log_likelihood(prob, t, r, precision, grad_of=log_t,
                               sites=sites)
        loss, g = -ll, -g.detach()
        losses.append(loss)
        if g1 is None:
            g1 = g.clone()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        denom = (v / (1 - b2 ** k)).sqrt() + eps
        with torch.no_grad():
            log_t -= lr / (1 - b1 ** k) * m / denom
    return losses, g1, (log_t.detach() - log_t0)
