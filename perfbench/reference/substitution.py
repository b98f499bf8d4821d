"""Reversible substitution models in float64, and the discrete-Gamma rule.

Frozen from ``plf_tpu_torch/models/substitution.py`` at commit c0abfbb:
the PAML parser (``parse_paml_matrix``), the GTR rate matrix with its
mean rate scaled to 1 (``gtr``, ``_make``, ``_normalise_q``) and the
median discrete Gamma (``discrete_gamma_rates``).  The eigensystem is
worked out here, from the symmetric form ``D^1/2 Q D^-1/2``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Model", "gtr", "paml", "discrete_gamma_rates",
           "transition_matrices"]


@dataclasses.dataclass(frozen=True)
class Model:
    """``Q = U diag(lam) W``; ``pi`` its stationary frequencies."""

    pi: np.ndarray
    q: np.ndarray
    lam: np.ndarray
    u: np.ndarray
    w: np.ndarray

    @property
    def states(self) -> int:
        return self.pi.shape[0]


def _model(exch: np.ndarray, pi) -> Model:
    pi = np.asarray(pi, np.float64)
    pi = pi / pi.sum()
    q = exch * pi[None, :]
    np.fill_diagonal(q, 0.0)
    np.fill_diagonal(q, -q.sum(axis=1))
    q = q / -np.sum(pi * np.diag(q))
    d = np.sqrt(pi)
    b = q * d[:, None] / d[None, :]
    lam, v = np.linalg.eigh(0.5 * (b + b.T))
    return Model(pi=pi, q=q, lam=lam, u=v / d[:, None], w=v.T * d[None, :])


def gtr(rates, pi) -> Model:
    """GTR from the ``S*(S-1)/2`` exchangeabilities in upper-triangle
    order (AC, AG, AT, CG, CT, GT for DNA)."""
    s = len(pi)
    exch = np.zeros((s, s))
    exch[np.triu_indices(s, 1)] = rates
    return _model(exch + exch.T, pi)


def paml(text: str) -> Model:
    """A 20-state model from PAML ``.dat`` text: 190 lower-triangle
    exchangeabilities, then 20 frequencies."""
    vals = []
    for tok in text.replace(",", " ").split():
        try:
            vals.append(float(tok))
        except ValueError:
            break
        if len(vals) == 210:
            break
    if len(vals) < 210:
        raise ValueError(f"PAML text holds {len(vals)} numbers, not 210")
    exch = np.zeros((20, 20))
    exch[np.tril_indices(20, -1)] = vals[:190]
    pi = np.asarray(vals[190:], np.float64)
    return _model(exch + exch.T, pi / pi.sum())   # normalised twice, as there


def discrete_gamma_rates(alpha: float, categories: int = 4) -> np.ndarray:
    """Mean-normalised discrete Gamma rates (median discretisation)."""
    from scipy.stats import gamma
    quantiles = (2 * np.arange(categories) + 1) / (2.0 * categories)
    rates = gamma.ppf(quantiles, a=alpha, scale=1.0 / alpha)
    return rates * categories / rates.sum()


def transition_matrices(model: Model, t: torch.Tensor, rates: torch.Tensor,
                        dtype=torch.float64) -> torch.Tensor:
    """``(E, C, S, S)`` ``P[e, c, from, to] = expm(Q t_e r_c)``, computed
    in ``dtype`` from the eigensystem; differentiable in ``t``."""
    dev = t.device
    lam, u, w = (torch.as_tensor(a, dtype=dtype, device=dev)
                 for a in (model.lam, model.u, model.w))
    e = torch.exp(lam * (t.to(dtype)[:, None, None]
                         * rates.to(dtype)[None, :, None]))
    return (u * e[..., None, :]) @ w
