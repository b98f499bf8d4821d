"""Substitution models: rate matrices, eigensystem, PLF branch matrices.

The DNA and protein parts of ``plf_tpu/models/substitution.py``, copied
(NumPy only): JC69, HKY85, GTR, random GTR-class models, the six PAML
empirical amino-acid models (their ``.dat`` files are copied into
``models/data/``), the discrete Gamma and +I rate mixtures and the
per-category branch matrices.  Codon (GY94) models are not ported yet
(ROADMAP.md, Queue 2 item 2).

The PLF computes, per category ``c``:

    x3 = EVarr^T [ (left_c . x1) * (right_c . x2) ]        (* = Hadamard)

with CLVs kept in eigen coordinates: for a reversible
``Q = U diag(lam) W`` (``W = U^-1``) a state-space CLV ``L`` is stored as
``x = W . L``, ``left_c[k, a] = U[k, a] * exp(lam_a * t_left * r_c)`` and
``EVarr[k, l] = W[l, k]``.  Tips enter as ``x_tip = W . e_obs`` and the
root likelihood per site is ``(pi^T U) . x_root``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["SubstitutionModel", "jc69", "hky85", "gtr", "random_gtr",
           "AMINO_ACIDS", "parse_paml_matrix", "BUILTIN_PROTEIN_MODELS",
           "empirical_protein", "discrete_gamma_rates",
           "gamma_invariant_rates", "branch_matrices"]


def _normalise_q(q: np.ndarray, pi: np.ndarray) -> np.ndarray:
    """Scale Q so the expected substitution rate is 1."""
    rate = -np.sum(pi * np.diag(q))
    return q / rate


def _reversible_eigen(q: np.ndarray, pi: np.ndarray):
    """Real eigensystem of a reversible Q via the symmetrised form
    ``B = D^{1/2} Q D^{-1/2}``: U = D^{-1/2} V, W = V^T D^{1/2}."""
    d = np.sqrt(pi)
    b = (q * d[:, None]) / d[None, :]
    b = 0.5 * (b + b.T)
    lam, v = np.linalg.eigh(b)
    u = v / d[:, None]
    w = v.T * d[None, :]
    return lam, u, w


@dataclasses.dataclass(frozen=True)
class SubstitutionModel:
    """An eigendecomposed reversible substitution model."""

    pi: np.ndarray           # (S,) stationary frequencies
    eigenvalues: np.ndarray  # (S,)
    u: np.ndarray            # (S, S) right eigenvectors, u[state, eigidx]
    w: np.ndarray            # (S, S) inverse, w[eigidx, state]

    @property
    def states(self) -> int:
        return self.pi.shape[0]

    @property
    def plf_ev(self) -> np.ndarray:
        """The EV array the PLF consumes (stage 3): EVarr[k, l] = W[l, k]."""
        return np.ascontiguousarray(self.w.T.astype(np.float32))

    @property
    def root_vector(self) -> np.ndarray:
        """v with per-site likelihood = v . x_root (eigen coords)."""
        return (self.pi @ self.u).astype(np.float64)

    def p_matrix(self, t: float, rate: float = 1.0) -> np.ndarray:
        """Full transition matrix P[from, to] = (U diag(e^{lam t r}) W)."""
        e = np.exp(self.eigenvalues * t * rate)
        return (self.u * e[None, :]) @ self.w


def _make(qsym: np.ndarray, pi: np.ndarray) -> SubstitutionModel:
    pi = np.asarray(pi, dtype=np.float64)
    pi = pi / pi.sum()
    q = qsym * pi[None, :]
    np.fill_diagonal(q, 0.0)
    np.fill_diagonal(q, -q.sum(axis=1))
    q = _normalise_q(q, pi)
    lam, u, w = _reversible_eigen(q, pi)
    return SubstitutionModel(pi=pi, eigenvalues=lam, u=u, w=w)


def jc69() -> SubstitutionModel:
    """Jukes-Cantor 1969 (equal rates and frequencies)."""
    qsym = np.ones((4, 4)) - np.eye(4)
    return _make(qsym, np.full(4, 0.25))


def hky85(kappa: float = 2.0, pi=None) -> SubstitutionModel:
    """HKY85 with transition/transversion ratio kappa (ACGT order)."""
    if pi is None:
        pi = np.full(4, 0.25)
    qsym = np.ones((4, 4)) - np.eye(4)
    qsym[0, 2] = qsym[2, 0] = kappa  # A<->G
    qsym[1, 3] = qsym[3, 1] = kappa  # C<->T
    return _make(qsym, pi)


def gtr(rates, pi) -> SubstitutionModel:
    """General time-reversible model from S*(S-1)/2 exchangeabilities."""
    pi = np.asarray(pi, dtype=np.float64)
    s = pi.shape[0]
    qsym = np.zeros((s, s))
    qsym[np.triu_indices(s, 1)] = rates
    qsym = qsym + qsym.T
    return _make(qsym, pi)


def random_gtr(states: int = 4, seed: int = 0) -> SubstitutionModel:
    """Random GTR-class model of any state count."""
    rng = np.random.default_rng(seed)
    rates = rng.random(states * (states - 1) // 2) + 0.1
    pi = rng.random(states) + 0.1
    return gtr(rates, pi / pi.sum())


AMINO_ACIDS = "ARNDCQEGHILKMFPSTWYV"  # PAML canonical order


def parse_paml_matrix(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a PAML ``.dat`` empirical amino-acid model file.

    The standard distribution format of LG/WAG/JTT etc.: 190 lower-
    triangular exchangeabilities (row i of 2..20 holds i-1 numbers),
    followed by 20 equilibrium frequencies, free-form whitespace;
    anything after the 210th number (comments, ancestral sequences) is
    ignored.  Returns ``(exchangeabilities (20, 20) symmetric, pi (20,))``
    in PAML amino-acid order ARNDCQEGHILKMFPSTWYV.
    """
    vals: list = []
    for tok in text.replace(",", " ").split():
        try:
            vals.append(float(tok))
        except ValueError:
            break  # first non-numeric token ends the numeric block
        if len(vals) == 210:
            break
    if len(vals) < 210:
        raise ValueError(
            f"PAML matrix needs 190 rates + 20 frequencies, got "
            f"{len(vals)} numbers")
    S = 20
    R = np.zeros((S, S))
    k = 0
    for i in range(1, S):
        for j in range(i):
            R[i, j] = R[j, i] = vals[k]
            k += 1
    pi = np.asarray(vals[190:210], dtype=np.float64)
    pi = pi / pi.sum()
    return R, pi


#: Empirical models shipped as PAML-format data files under models/data/
#: (the JAX package's files, copied): lg.dat: Le & Gascuel (2008) MBE
#: 25(7):1307-1320; wag.dat: Whelan & Goldman (2001) MBE 18(5):691-699;
#: jtt.dat: Jones, Taylor & Thornton (1992) CABIOS 8:275-282; dayhoff.dat:
#: Dayhoff, Schwartz & Orcutt (1978); mtrev.dat: Adachi & Hasegawa (1996)
#: mtREV24; cprev.dat: Adachi et al. (2000) cpREV.
BUILTIN_PROTEIN_MODELS = ("lg", "wag", "jtt", "dayhoff", "mtrev", "cprev")


def empirical_protein(source: str,
                      pi: Optional[np.ndarray] = None
                      ) -> SubstitutionModel:
    """Build a 20-state model from PAML ``.dat`` text, a file path, or a
    built-in name ("lg", "wag", "jtt", "dayhoff", "mtrev", "cprev").
    ``pi`` overrides the matrix's published equilibrium frequencies (the
    "+F" convention)."""
    text = source
    if source.lower() in BUILTIN_PROTEIN_MODELS:
        path = os.path.join(os.path.dirname(__file__), "data",
                            f"{source.lower()}.dat")
        with open(path) as f:
            text = f.read()
    elif "\n" not in source and os.path.exists(source):
        with open(source) as f:
            text = f.read()
    R, pi_file = parse_paml_matrix(text)
    iu = np.triu_indices(20, k=1)
    return gtr(R[iu], pi_file if pi is None else np.asarray(pi))


def discrete_gamma_rates(alpha: float, categories: int = 4) -> np.ndarray:
    """Mean-normalised discrete Gamma rates (median discretisation)."""
    from scipy.stats import gamma as _gamma
    c = categories
    quantiles = (2 * np.arange(c) + 1) / (2.0 * c)
    rates = _gamma.ppf(quantiles, a=alpha, scale=1.0 / alpha)
    return (rates * c / rates.sum()).astype(np.float64)


def gamma_invariant_rates(alpha: Optional[float], p_inv: float,
                          categories: int = 4):
    """Rate mixture for the +I(+G) model: a rate-0 category of weight
    ``p_inv`` plus ``categories`` gamma categories of weight
    ``(1-p_inv)/categories`` whose rates are scaled by ``1/(1-p_inv)``."""
    if not 0.0 <= p_inv < 1.0:
        raise ValueError(f"p_inv must be in [0, 1), got {p_inv}")
    g = (np.ones(categories) if alpha is None
         else discrete_gamma_rates(alpha, categories))
    rates = np.concatenate([[0.0], g / (1.0 - p_inv)])
    weights = np.concatenate([[p_inv],
                              np.full(categories, (1.0 - p_inv) / categories)])
    return rates.astype(np.float64), weights.astype(np.float64)


def branch_matrices(model: SubstitutionModel, t: float,
                    rates: Optional[np.ndarray] = None,
                    categories: int = 4) -> np.ndarray:
    """Per-category PLF branch matrix: (C, S, S), [c, k, a] with
    ``left[c, k, a] = U[k, a] * exp(lam_a * t * r_c)``."""
    if rates is None:
        rates = np.ones((categories,))
    out = np.empty((len(rates), model.states, model.states), dtype=np.float64)
    for c, r in enumerate(rates):
        e = np.exp(model.eigenvalues * t * r)
        out[c] = model.u * e[None, :]
    return out.astype(np.float32)
