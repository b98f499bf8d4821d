"""Nonparametric bootstrap over alignment sites (RAxML -b / RELL parity).

Counterpart of ``plf_tpu/models/bootstrap.py`` (NumPy on the host around
``PhyloModel.log_likelihood``).

The bootstrap resamples sites with replacement; on compressed pattern
alignments that is exactly a multinomial redraw of the pattern WEIGHT
vector — no data movement at all.  Per-replicate log-likelihoods are
then dot products of the resampled weights with the per-site true
log-likelihood (rescale counts folded in), so evaluating thousands of
replicates costs one tree traversal plus an (R, n) @ (n,) matmul.

* :func:`bootstrap_weights` — multinomial weight redraws.
* :func:`bootstrap_log_likelihoods` — replicate lls for one model.
* :func:`rell_support` — Kishino-Hasegawa RELL support: for competing
  topologies, the fraction of bootstrap replicates in which each tree
  has the highest resampled likelihood.

Full Felsenstein bootstrap support (re-search per replicate) composes
from these + models.search.tree_search(wgt=replicate_weights).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .phylo import PhyloModel

__all__ = ["bootstrap_weights", "bootstrap_log_likelihoods",
           "rell_support"]


def bootstrap_weights(wgt: np.ndarray, n_replicates: int,
                      seed: int = 0) -> np.ndarray:
    """(R, n) multinomial redraws of a site/pattern weight vector.

    Each replicate draws ``sum(wgt)`` sites with replacement with
    probability proportional to the original weights — the standard
    nonparametric bootstrap on a pattern-compressed alignment.
    """
    wgt = np.asarray(wgt, np.int64)
    total = int(wgt.sum())
    p = wgt / total
    rng = np.random.default_rng(seed)
    return rng.multinomial(total, p, size=n_replicates).astype(np.int64)


def bootstrap_log_likelihoods(pm: PhyloModel, n_replicates: int = 100,
                              seed: int = 0) -> np.ndarray:
    """(R,) bootstrap-replicate log-likelihoods of one fitted model.

    One traversal evaluates the per-site log-likelihoods; replicates are
    weight redraws (fixed tree/branch lengths — the RELL approximation).
    """
    res = pm.log_likelihood()
    site_ll = res.true_site_log_likelihood()
    n_obs = pm.n_sites_obs
    w = bootstrap_weights(pm.wgt[:n_obs], n_replicates, seed)
    return w @ site_ll


def rell_support(models: Sequence[PhyloModel], n_replicates: int = 1000,
                 seed: int = 0) -> np.ndarray:
    """RELL bootstrap support for competing models/topologies.

    Args:
      models: PhyloModels over the SAME alignment (same pattern weights),
        e.g. candidate topologies from a search.

    Returns:
      (len(models),) fraction of replicates in which each model attains
      the maximum resampled log-likelihood (ties split evenly).
    """
    if not models:
        raise ValueError("need at least one model")
    n_obs = models[0].n_sites_obs
    wgt0 = models[0].wgt[:n_obs]
    site_lls = []
    for pm in models:
        if pm.n_sites_obs != n_obs or not np.array_equal(
                pm.wgt[:n_obs], wgt0):
            raise ValueError("models must share the alignment/weights")
        site_lls.append(pm.log_likelihood().true_site_log_likelihood())
    mat = np.stack(site_lls)                        # (T, n)
    w = bootstrap_weights(wgt0, n_replicates, seed)  # (R, n)
    lls = w @ mat.T                                 # (R, T)
    best = lls.max(axis=1, keepdims=True)
    is_best = lls >= best - 1e-9
    return (is_best / is_best.sum(axis=1, keepdims=True)).mean(axis=0)
