"""Model selection: fit a ladder of substitution models, rank by AIC/BIC.

Counterpart of ``plf_tpu/models/selection.py``: the ModelTest-NG step
that users run before inference.  Every candidate is fitted with the
port's optimisers (models/optimize.py) on ``device`` and scored with the
standard information criteria.

Candidates (DNA): JC, HKY, GTR, each optionally +G (discrete-gamma
rates, fitted shape), +I (fitted invariant-site proportion), or +I+G.
Candidates (protein, selected automatically when config.states == 20):
the empirical-matrix ladder LG / WAG / JTT / Dayhoff ± G.  Parameter
counting follows ModelTest convention: unrooted branch lengths (2n-3)
+ model free parameters (JC 0; HKY 4 = kappa + 3 frequencies; GTR 8 =
5 exchangeabilities + 3 frequencies; empirical protein matrices 0;
+G adds 1, +I adds 1), sample size = total (weighted) alignment sites.

On the card each candidate's branch lengths train through
``tree_loglik_fn``'s auto backend (DNA: kernels 7 + 8, or 2 + 4; protein
and codon: kernels 2m + 4m), and each golden-section step of alpha, +I or
kappa is one whole-tree evaluation (kernel 2, 2m or 7).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import PLFConfig
from .phylo import PhyloModel
from .pipeline import _with_lengths
from .substitution import SubstitutionModel, gtr, hky85, jc69
from .tree import Tree

__all__ = ["ModelFit", "SelectionResult", "model_select",
           "empirical_frequencies", "DNA_CANDIDATES",
           "PROTEIN_CANDIDATES", "CODON_CANDIDATES"]

DNA_CANDIDATES = ("JC", "JC+G", "HKY", "HKY+G", "HKY+I", "HKY+I+G",
                  "GTR", "GTR+G", "GTR+I", "GTR+I+G")
#: ModelTest-style protein ladder: (matrix) x {, +G, +I, +I+G} x {, +F}
#: (+F = empirical frequencies from the data, adding 19 free params)
PROTEIN_CANDIDATES = tuple(
    f"{m}{s}{f}"
    for m in ("LG", "WAG", "JTT", "DAYHOFF")
    for s in ("", "+G", "+I", "+I+G")
    for f in ("", "+F"))
#: Codon ladder: GY94 with free omega/kappa + F3x4 frequencies
CODON_CANDIDATES = ("GY94", "GY94+G")

#: model free-parameter counts (frequencies counted as free for
#: HKY/GTR per ModelTest convention, even when set empirically;
#: empirical protein matrices contribute none unless +F adds the 19
#: observed frequencies; GY94 = kappa + omega + 9 F3x4 frequencies)
_K_MODEL = {"JC": 0, "HKY": 4, "GTR": 8,
            "LG": 0, "WAG": 0, "JTT": 0, "DAYHOFF": 0,
            "GY94": 11}


@dataclasses.dataclass
class ModelFit:
    """One fitted candidate; ``seconds`` is the wall time of its fit."""

    name: str
    model: SubstitutionModel
    alpha: Optional[float]
    lengths: np.ndarray
    log_likelihood: float
    k_params: int
    aic: float
    aicc: float
    bic: float
    p_inv: Optional[float] = None
    seconds: float = 0.0


@dataclasses.dataclass
class SelectionResult:
    fits: List[ModelFit]          # sorted by the chosen criterion
    criterion: str

    @property
    def best(self) -> ModelFit:
        return self.fits[0]

    def table(self) -> str:
        hdr = (f"{'model':8s} {'lnL':>14s} {'k':>3s} {'AIC':>14s} "
               f"{'AICc':>14s} {'BIC':>14s}")
        rows = [hdr]
        for f in self.fits:
            rows.append(f"{f.name:8s} {f.log_likelihood:14.2f} "
                        f"{f.k_params:3d} {f.aic:14.2f} {f.aicc:14.2f} "
                        f"{f.bic:14.2f}")
        return "\n".join(rows)


def empirical_frequencies(codes: np.ndarray, states: int) -> np.ndarray:
    """Observed state frequencies (plain states only; ambiguity/gap
    codes excluded), floored and renormalised."""
    counts = np.bincount(
        codes[(codes >= 0) & (codes < states)].ravel(),
        minlength=states).astype(np.float64)
    pi = np.maximum(counts, 1.0)
    return pi / pi.sum()


def _fit_lengths_alpha(tree, model, codes, wgt, alpha0, config, steps,
                       fit_alpha, fit_pinv=False, device="cuda"):
    """Branch lengths (adam through the kernels' VJP) + optional gamma
    shape and invariant-site proportion (golden-section), coordinate
    rounds."""
    from .optimize import (optimize_alpha, optimize_branch_lengths,
                           optimize_pinv)

    alpha = alpha0
    p_inv = 0.1 if fit_pinv else None

    def make_pm(t):
        return PhyloModel(t, model, codes, wgt=wgt, alpha=alpha,
                          config=config, p_inv=p_inv, device=device)

    t_opt, _, ll = optimize_branch_lengths(make_pm(tree), steps=steps)
    tree = _with_lengths(tree, np.asarray(t_opt))
    if fit_alpha:
        alpha, _, _ = optimize_alpha(make_pm(tree))
    if fit_pinv:
        # golden-section over the +I proportion on the 1-D profile
        # (rate rescale + mixture weights; optimize.optimize_pinv)
        p_inv, _, _ = optimize_pinv(make_pm(tree), alpha=alpha)
    if fit_alpha or fit_pinv:
        t_opt, _, ll = optimize_branch_lengths(make_pm(tree),
                                               steps=steps // 2)
        tree = _with_lengths(tree, np.asarray(t_opt))
    return tree, alpha, float(ll), np.asarray(t_opt), p_inv


BUILTIN_PROTEIN_LADDER = ("LG", "WAG", "JTT", "DAYHOFF")


def _fit_kappa(tree, codes, wgt, pi, alpha, config, bounds=(0.2, 80.0),
               p_inv=None, device="cuda"):
    """Golden-section ML fit of the HKY kappa on fixed lengths (every
    evaluation builds one PhyloModel and runs one whole-tree
    evaluation)."""
    from .optimize import _golden_section

    def ll_of(log_k: float) -> float:
        m = hky85(float(np.exp(log_k)), pi)
        pm = PhyloModel(tree, m, codes, wgt=wgt, alpha=alpha,
                        config=config, p_inv=p_inv, device=device)
        return pm.log_likelihood().log_likelihood

    lk, _ = _golden_section(ll_of, np.log(bounds[0]), np.log(bounds[1]),
                            iters=18)
    return float(np.exp(lk))


def model_select(tree: Tree, tip_states: np.ndarray,
                 wgt: Optional[np.ndarray] = None,
                 candidates: Optional[Sequence[str]] = None,
                 criterion: str = "AICc",
                 config: Optional[PLFConfig] = None,
                 steps: int = 80,
                 gtr_steps: int = 120,
                 verbose: bool = False,
                 device: Union[str, torch.device] = "cuda"
                 ) -> SelectionResult:
    """Fit every candidate model and rank by an information criterion.

    ``criterion``: "AIC", "AICc", or "BIC".  Branch lengths are re-fitted
    per candidate (they are free parameters of each model); +G fits the
    gamma shape by coordinate golden-section; +I fits the invariant-site
    proportion (optimize.optimize_pinv profile); GTR fits
    exchangeabilities/frequencies with the autodiff eigendecomposition
    path (optimize.fit_model).  ``candidates`` defaults to
    DNA_CANDIDATES, or PROTEIN_CANDIDATES (the LG/WAG/JTT/Dayhoff
    empirical ladder) when ``config.states == 20``, or CODON_CANDIDATES
    when it is 61.  The models live on ``device``.
    """
    codes = np.asarray(tip_states)
    cfg = config or PLFConfig()
    if candidates is None:
        candidates = (PROTEIN_CANDIDATES if cfg.states == 20
                      else CODON_CANDIDATES if cfg.states == 61
                      else DNA_CANDIDATES)
    wgt_arr = (np.ones(codes.shape[1], np.int32) if wgt is None
               else np.asarray(wgt))
    n_samp = float(wgt_arr.sum())
    n_leaves = tree.n_leaves
    k_branch = max(2 * n_leaves - 3, 1)
    pi_emp = empirical_frequencies(codes, cfg.states)

    fits: List[ModelFit] = []
    for name in candidates:
        t_fit = time.perf_counter()
        parts = name.split("+")
        base, flags = parts[0], set(parts[1:])
        fit_alpha = "G" in flags
        fit_pinv = "I" in flags
        plus_f = "F" in flags
        if plus_f and base not in BUILTIN_PROTEIN_LADDER:
            raise ValueError(f"+F applies to empirical protein "
                             f"matrices only, got {name!r}")
        alpha0 = 0.5 if fit_alpha else None
        p_inv = None

        if base == "JC":
            model = jc69()
            t_tree, alpha, ll, t_opt, p_inv = _fit_lengths_alpha(
                tree, model, codes, wgt_arr, alpha0, cfg, steps,
                fit_alpha, fit_pinv, device=device)
        elif base == "HKY":
            # coordinate: lengths under kappa=2 -> kappa -> lengths
            t_tree, alpha, _ll, t_opt, p_inv = _fit_lengths_alpha(
                tree, hky85(2.0, pi_emp), codes, wgt_arr, alpha0, cfg,
                steps, fit_alpha, fit_pinv, device=device)
            kappa = _fit_kappa(t_tree, codes, wgt_arr, pi_emp, alpha, cfg,
                               p_inv=p_inv, device=device)
            model = hky85(kappa, pi_emp)
            t_tree, alpha, ll, t_opt, p_inv = _fit_lengths_alpha(
                t_tree, model, codes, wgt_arr, alpha, cfg, steps // 2,
                fit_alpha, fit_pinv, device=device)
        elif base == "GTR":
            from .optimize import fit_model

            pm = PhyloModel(tree, gtr(np.ones(6), pi_emp), codes,
                            wgt=wgt_arr, alpha=alpha0, config=cfg, device=device)
            out = fit_model(pm, steps=gtr_steps, fit_alpha=fit_alpha)
            if fit_pinv:
                # coordinate: GTR rates/freqs at p_inv=0, then the +I
                # profile + lengths under the fitted matrix
                model = out[0]
                alpha = out[4] if fit_alpha else None
                t_tree, alpha, ll, t_opt, p_inv = _fit_lengths_alpha(
                    _with_lengths(tree, np.asarray(out[1])), model,
                    codes, wgt_arr, alpha, cfg, steps // 2, fit_alpha,
                    fit_pinv, device=device)
            else:
                if fit_alpha:
                    model, t_opt, _ll0, ll, alpha = out
                else:
                    model, t_opt, _ll0, ll = out
                    alpha = None
                t_tree = _with_lengths(tree, np.asarray(t_opt))
        elif base in BUILTIN_PROTEIN_LADDER:
            from .substitution import empirical_protein

            model = empirical_protein(
                base.lower(), pi=pi_emp if plus_f else None)
            t_tree, alpha, ll, t_opt, p_inv = _fit_lengths_alpha(
                tree, model, codes, wgt_arr, alpha0, cfg, steps,
                fit_alpha, fit_pinv, device=device)
        elif base == "GY94":
            from .optimize import fit_codon

            model, info = fit_codon(
                tree, codes, wgt=wgt_arr, config=cfg,
                rounds=2, iters=max(6, steps // 12),
                length_steps=steps, fit_alpha=fit_alpha, device=device)
            t_tree = info["tree"]
            t_opt = info["lengths"]
            ll = info["ll"]
            alpha = info["alpha"]
        else:
            raise ValueError(f"unknown candidate {name!r}")

        k = (k_branch + _K_MODEL[base] + (1 if fit_alpha else 0)
             + (1 if fit_pinv else 0) + (19 if plus_f else 0))
        ll = float(ll)
        aic = 2 * k - 2 * ll
        denom = max(n_samp - k - 1, 1.0)
        aicc = aic + (2 * k * (k + 1)) / denom
        bic = k * np.log(n_samp) - 2 * ll
        fits.append(ModelFit(name=name, model=model, alpha=alpha,
                             lengths=np.asarray(t_opt),
                             log_likelihood=ll, k_params=k, aic=aic,
                             aicc=aicc, bic=bic, p_inv=p_inv,
                             seconds=time.perf_counter() - t_fit))
        if verbose:
            print(f"{name}: lnL={ll:.2f} k={k} AICc={aicc:.2f} "
                  f"({fits[-1].seconds:.2f} s)", flush=True)

    key = {"AIC": lambda f: f.aic, "AICc": lambda f: f.aicc,
           "BIC": lambda f: f.bic}[criterion]
    fits.sort(key=key)
    return SelectionResult(fits=fits, criterion=criterion)
