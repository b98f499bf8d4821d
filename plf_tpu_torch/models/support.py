"""Per-branch support: aLRT and SH-like support (RELL).

Counterpart of ``plf_tpu/models/support.py``.  The approximate
likelihood-ratio test (Anisimova & Gascuel 2006) and its SH-like
nonparametric variant (Guindon et al. 2010) are the fast alternatives to
a full bootstrap, as in PhyML and IQ-TREE: for every internal branch, the
current topology is compared against the two NNI rearrangements around
that branch.  All 2E+1 tree evaluations are ``PhyloModel.log_likelihood()``
(on the card, one launch of kernel 2 or 2m each, or the segmented kernel
for a tree past their arena); each alternative shares the incumbent's
device tensors (alignment, weights, tip tables), as a search round's
candidates do, so only its operators are new.  The RELL resampling (site
log-likelihood vectors re-weighted by multinomial redraws, no
re-estimation) is a host matmul.  The RELL weights come from ``np.random.default_rng(seed)``, so
both packages draw the same matrix.

Complements models/consensus.py (full distance-bootstrap support) and
models/bootstrap.py (RELL topology tests).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .phylo import PhyloModel
from .search import _rebuild
from .substitution import SubstitutionModel
from .tree import Tree, TreeNode

__all__ = ["alrt_support", "annotate_alrt"]


def _site_ll(tree: Tree, model: SubstitutionModel, tips, wgt, alpha,
             p_inv, config, device, share=None
             ) -> Tuple[float, np.ndarray, PhyloModel]:
    """One topology's ll and per-site lls, and its model (whose device
    tensors an alternative over the same alignment can ``share``)."""
    pm = PhyloModel(tree, model, tips, wgt=wgt, alpha=alpha, p_inv=p_inv,
                    config=config, share_device_from=share, device=device)
    res = pm.log_likelihood()
    return res.log_likelihood, res.true_site_log_likelihood(), pm


def alrt_support(tree: Tree, model: SubstitutionModel, tips,
                 wgt: Optional[np.ndarray] = None,
                 alpha: Optional[float] = None,
                 p_inv: Optional[float] = None,
                 config=None, rell_replicates: int = 1000,
                 seed: int = 0,
                 device: Union[str, torch.device] = "cuda"
                 ) -> Dict[int, Tuple[float, float]]:
    """aLRT statistic + SH-like support for every internal branch.

    For each internal node ``d`` (the branch d -> parent): evaluate the
    two NNI alternatives around the branch and return

      ``{d: (alrt, sh_support)}``

    with ``alrt = 2*(ll_current - ll_best_alternative)`` (negative means
    an NNI neighbour beats the current topology — the tree is not at a
    local optimum for that branch) and ``sh_support`` the fraction of
    ``rell_replicates`` multinomial site redraws in which the current
    topology still beats both alternatives (RELL: the per-site
    log-likelihood vectors are re-weighted, nothing is re-fitted).  The
    models live on ``device``.
    """
    tips = np.asarray(tips)
    n_sites = tips.shape[1]
    base_w = (np.ones(n_sites, np.int64) if wgt is None
              else np.asarray(wgt, np.int64))

    ll0, s0, pm0 = _site_ll(tree, model, tips, base_w, alpha, p_inv,
                            config, device)

    parent_of = {}
    for n in tree.nodes:
        for c in n.children:
            parent_of[c] = n.index

    rng = np.random.default_rng(seed)
    total = int(base_w.sum())
    # (R, n) RELL weight matrix, shared across branches; in float64 once
    # (its counts are exact there), where a matmul per branch would
    # convert it every time
    W = rng.multinomial(total, base_w / total,
                        size=rell_replicates).astype(np.float64)

    out: Dict[int, Tuple[float, float]] = {}
    for d in tree.nodes:
        if d.is_leaf or d.index == tree.root:
            continue
        p_idx = parent_of[d.index]
        p = tree.nodes[p_idx]
        sibs = [c for c in p.children if c != d.index]
        if len(sibs) != 1:
            continue
        s = sibs[0]
        x, y = d.children
        alts = [
            _rebuild(tree, {p_idx: tuple(x if c == s else c
                                         for c in p.children),
                            d.index: (s, y)}),
            _rebuild(tree, {p_idx: tuple(y if c == s else c
                                         for c in p.children),
                            d.index: (x, s)}),
        ]
        site_lls = [s0]
        lls = [ll0]
        for t_alt in alts:
            ll_a, s_a, _ = _site_ll(t_alt, model, tips, base_w, alpha,
                                    p_inv, config, device, share=pm0)
            lls.append(ll_a)
            site_lls.append(s_a)
        alrt = 2.0 * (lls[0] - max(lls[1], lls[2]))
        # RELL: replicate lls for the three configs in one (R,n)@(n,3).
        M = np.stack(site_lls, axis=1)              # (n, 3)
        rep = W @ M                                  # (R, 3)
        wins = np.mean((rep[:, 0] >= rep[:, 1])
                       & (rep[:, 0] >= rep[:, 2]))
        out[d.index] = (float(alrt), float(wins))
    return out


def annotate_alrt(tree: Tree, support: Dict[int, Tuple[float, float]],
                  which: str = "sh") -> Tree:
    """Copy of ``tree`` with aLRT / SH-like values as internal labels.

    ``which``: "sh" writes the SH-like support as a percentage, "alrt"
    the raw statistic.
    """
    nodes = []
    for n in tree.nodes:
        if n.is_leaf or n.index not in support:
            nodes.append(n)
            continue
        a, sh = support[n.index]
        label = (str(int(round(sh * 100))) if which == "sh"
                 else f"{a:.3g}")
        nodes.append(TreeNode(index=n.index, name=label, length=n.length,
                              children=n.children))
    return Tree(nodes=nodes, root=tree.root)
