"""End-to-end inference pipeline: alignment in, annotated ML tree out.

Counterpart of ``plf_tpu/models/pipeline.py``: the RAxML-shaped loop
around the engine, so the port is usable as a complete tool:

    alignment -> pattern compression -> NJ starting tree (distances on the
    card) -> ML branch lengths + model parameters (+I/+G) -> NNI/SPR
    topology search -> bootstrap support -> annotated newick.

Every likelihood evaluation inside the loop takes ``PhyloModel``'s auto
route (kernel 2 or 2m when the tree fits the fused kernel's arena, the
segmented kernel otherwise); a search round scores its neighbourhood in
one batched launch (``phylo.batch_log_likelihood``); distances run as
matmuls on the card (models/distance).  The pipeline is plain host
Python: which topology wins is data-dependent control flow.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from .tree import Tree
from .substitution import SubstitutionModel, jc69
from .phylo import PhyloModel
from .distance import nj_tree
from .search import tree_search
from .optimize import (optimize_branch_lengths, optimize_alpha,
                       optimize_pinv, fit_model)
from .consensus import annotate_support, bootstrap_nj_trees

__all__ = ["InferenceResult", "run_inference"]


@dataclasses.dataclass
class InferenceResult:
    tree: Tree                      # ML tree, support values as labels
    log_likelihood: float
    model: SubstitutionModel
    alpha: Optional[float]
    p_inv: Optional[float]
    newick: str
    log: List[str]
    elapsed_s: float


def run_inference(codes: np.ndarray,
                  names: Optional[Sequence[str]] = None,
                  wgt: Optional[np.ndarray] = None,
                  model: Optional[SubstitutionModel] = None,
                  alpha: Optional[float] = 0.5,
                  p_inv: Optional[float] = None,
                  search: str = "nni",
                  fit: str = "lengths+alpha",
                  bootstrap: int = 0,
                  starting_tree: Optional[Tree] = None,
                  seed: int = 0,
                  progress: Optional[Callable[[str], None]] = None,
                  device: Union[str, torch.device] = "cuda"
                  ) -> InferenceResult:
    """Full ML phylogenetic inference; the models live on ``device``.

    Args:
      codes: (n_taxa, n_sites) int state codes (gaps/ambiguous >= S).
      names: taxon names (default t0..tN-1).
      wgt: site weights; if None the alignment is pattern-compressed
        here (RAxML always compresses).
      model: substitution model; default JC69 (use ``fit="model"`` to
        estimate GTR parameters from the data).
      alpha: initial gamma shape (None = no rate heterogeneity).
      p_inv: initial invariant-site proportion (None = no +I).
      search: "nni", "spr", or "none".
      fit: comma-free spec of what to optimise after the topology
        search: any of "lengths", "alpha", "pinv", "model" joined by
        "+" (e.g. "lengths+alpha+pinv"), or "none".
      bootstrap: number of distance-bootstrap replicates for branch
        support (0 = skip).
      starting_tree: skip the NJ step and start here.

    Returns an :class:`InferenceResult`; ``result.newick`` carries
    support percentages as internal labels when bootstrap > 0.
    """
    t_start = time.perf_counter()
    logs: List[str] = []

    def say(msg: str):
        logs.append(msg)
        if progress:
            progress(msg)

    codes = np.asarray(codes)
    L, n_raw = codes.shape
    if names is None:
        names = [f"t{i}" for i in range(L)]
    model = model or jc69()
    S = model.states

    if wgt is None:
        from ..io.alignment import compress_patterns
        codes, wgt = compress_patterns(codes)
        say(f"compressed {n_raw} sites -> {codes.shape[1]} patterns")

    # 1. Starting tree: NJ on JC distances computed on the device.
    if starting_tree is None:
        tree = nj_tree(codes, wgt, names=names, states=S, device=device)
        say("NJ starting tree built")
    else:
        tree = starting_tree
    # PhyloModel indexes tips by tree leaf order.
    name_to_row = {nm: i for i, nm in enumerate(names)}
    order = [name_to_row[nm] for nm in tree.leaf_names()]
    tips = codes[order]

    # The current model, gamma shape and invariant proportion: make_pm
    # reads them when it is called, so after the fits it builds the
    # fitted model (plf_tpu's make_pm keeps the initial alpha and p_inv,
    # so its final length pass and reported ll ignore the fitted ones).
    alpha_hat, pinv_hat = alpha, p_inv

    def make_pm(t: Tree, tip_rows: np.ndarray) -> PhyloModel:
        return PhyloModel(t, model, tip_rows, wgt=wgt, alpha=alpha_hat,
                          p_inv=pinv_hat, device=device)

    pm = make_pm(tree, tips)
    ll = pm.log_likelihood().log_likelihood
    say(f"starting ll = {ll:.4f}")

    # 2. Branch-length pass before the topology search (NJ lengths are
    # distance estimates, not ML).
    steps_fit = ("none" if fit is None else fit).split("+")
    if "lengths" in steps_fit:
        t_hat, ll0, ll = optimize_branch_lengths(pm)
        tree = _with_lengths(tree, t_hat)
        pm = make_pm(tree, tips)
        say(f"branch lengths: ll {ll0:.4f} -> {ll:.4f}")

    # 3. Topology search.
    if search != "none":
        res = tree_search(tree, model, tips, wgt=wgt, alpha=alpha,
                          strategy=search, device=device)
        tree, ll = res.tree, res.log_likelihood
        order = [name_to_row[nm] for nm in tree.leaf_names()]
        tips = codes[order]
        pm = make_pm(tree, tips)
        say(f"{search} search: ll = {ll:.4f} "
            f"({res.evaluations} trees evaluated)")

    # 4. Model parameter fitting on the final topology.
    if "model" in steps_fit:
        out = fit_model(pm, fit_alpha=alpha is not None)
        if alpha is not None:
            model, t_opt, _ll0, ll, alpha_hat = out
        else:
            model, t_opt, _ll0, ll = out
        tree = _with_lengths(tree, np.asarray(t_opt))
        pm = make_pm(tree, tips)
        say(f"GTR fit: ll = {ll:.4f}")
    else:
        if "alpha" in steps_fit and alpha is not None:
            alpha_hat, ll0, ll = optimize_alpha(pm)
            pm = make_pm(tree, tips)
            say(f"alpha = {alpha_hat:.4f}: ll {ll0:.4f} -> {ll:.4f}")
        if "pinv" in steps_fit and p_inv is not None:
            pinv_hat, ll0, ll = optimize_pinv(pm, alpha=alpha_hat)
            pm = make_pm(tree, tips)
            say(f"p_inv = {pinv_hat:.4f}: ll {ll0:.4f} -> {ll:.4f}")
    if "lengths" in steps_fit:
        t_hat, ll0, ll = optimize_branch_lengths(pm)
        tree = _with_lengths(tree, t_hat)
        pm = make_pm(tree, tips)
        say(f"final branch lengths: ll {ll0:.4f} -> {ll:.4f}")
        ll = pm.log_likelihood().log_likelihood

    # 5. Bootstrap support.
    if bootstrap > 0:
        reps = bootstrap_nj_trees(codes, wgt, n_replicates=bootstrap,
                                  names=names, states=S, seed=seed,
                                  device=device)
        tree = annotate_support(tree, reps)
        say(f"{bootstrap} bootstrap replicates -> support annotated")

    return InferenceResult(
        tree=tree, log_likelihood=float(ll), model=model,
        alpha=alpha_hat, p_inv=pinv_hat, newick=tree.to_newick(),
        log=logs, elapsed_s=time.perf_counter() - t_start)


def _with_lengths(tree: Tree, t_vec: np.ndarray) -> Tree:
    """Copy of ``tree`` with branch lengths from an optimiser vector
    (indexed by child node, root excluded)."""
    from .tree import TreeNode
    nodes = []
    for nd in tree.nodes:
        length = (float(t_vec[nd.index]) if nd.index < len(t_vec)
                  else nd.length)
        nodes.append(TreeNode(index=nd.index, name=nd.name, length=length,
                              children=nd.children))
    return Tree(nodes=nodes, root=tree.root)
