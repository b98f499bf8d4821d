"""Tree topology search: NNI / SPR hill climbing on the fused likelihood.

Counterpart of ``plf_tpu/models/search.py``.  The reference accelerates
one PLF node update; the application it plugs into is maximum-likelihood
tree *search* (RAxML).  This module supplies a compact version of that
loop:

* :func:`nni_neighbors` -- all nearest-neighbour-interchange
  rearrangements of a rooted binary tree (each internal edge yields two
  alternative topologies),
* :func:`spr_neighbors` -- subtree-prune-regraft rearrangements (prune
  any non-root subtree, regraft onto any other edge), the move set
  RAxML's "lazy SPR" rounds draw from,
* :func:`nni_search` / :func:`spr_search` -- greedy hill climbing with
  either move set, optionally re-optimising branch lengths
  (models/optimize.py) after accepted moves,
* :func:`tree_search` -- the production entry point: strategy selection plus
  checkpoint/resume (utils/checkpoint.py) so long searches survive
  preemption.

A round scores its whole neighbourhood, the incumbent included, in one
launch of the fused tree kernel with a candidate axis
(``phylo.batch_log_likelihood``) when the batch fits that kernel's arena,
else in one launch a chunk of the segmented kernel with a candidate axis
(``phylo.batch_log_likelihood_segmented``); only where that raises
ValueError (an ascertainment correction, a tree no segment arena takes)
are the candidates scored one by one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Backend, PLFConfig
from .phylo import (PhyloModel, batch_fits, batch_log_likelihood,
                    batch_log_likelihood_segmented)
from .substitution import SubstitutionModel
from .tree import Tree, TreeNode, parse_newick

__all__ = ["nni_neighbors", "spr_neighbors", "nni_search", "spr_search",
           "tree_search", "SearchResult"]


@dataclasses.dataclass
class SearchResult:
    tree: Tree
    log_likelihood: float
    accepted_moves: int
    evaluations: int


def _rebuild(tree: Tree, new_children, new_lengths=None) -> Tree:
    new_lengths = new_lengths or {}
    nodes = []
    for n in tree.nodes:
        ch = new_children.get(n.index, n.children)
        ln = new_lengths.get(n.index, n.length)
        nodes.append(TreeNode(index=n.index, name=n.name, length=ln,
                              children=tuple(ch)))
    return Tree(nodes=nodes, root=tree.root)


def nni_neighbors(tree: Tree, with_moves: bool = False):
    """All NNI rearrangements of a rooted binary tree.

    For each internal edge (parent P -> internal child D with children
    (x, y)) and P's other child s, the two interchanges swap s with x or
    with y.  Branch lengths ride along with their subtrees.

    With ``with_moves`` returns ``(trees, touched)`` where
    ``touched[i]`` lists the node indices whose branches the move
    rearranged (the candidates for local length refinement — RAxML's
    lazy rearrangement re-optimises exactly these).
    """
    parent_of = {}
    for n in tree.nodes:
        for c in n.children:
            parent_of[c] = n.index
    out: List[Tree] = []
    moves: List[Tuple[int, ...]] = []
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
        # swap s <-> x
        out.append(_rebuild(tree, {
            p_idx: tuple(x if c == s else c for c in p.children),
            d.index: (s, y)}))
        moves.append((s, x, d.index))
        # swap s <-> y
        out.append(_rebuild(tree, {
            p_idx: tuple(y if c == s else c for c in p.children),
            d.index: (x, s)}))
        moves.append((s, y, d.index))
    return (out, moves) if with_moves else out


def spr_neighbors(tree: Tree, max_neighbors: Optional[int] = None,
                  seed: int = 0, with_moves: bool = False):
    """All subtree-prune-regraft rearrangements of a rooted binary tree.

    For each prunable node ``v`` (neither the root nor a child of the
    root), detach the subtree rooted at ``v``: its parent ``p`` is removed
    by splicing ``v``'s sibling ``s`` into ``p``'s place (``s`` absorbs
    ``p``'s branch length).  Then ``p`` is reinserted into any other edge
    ``(u, parent(u))`` outside the pruned subtree, splitting ``u``'s
    branch in half, with ``v`` keeping its own length.  Regrafting onto
    ``s``'s (new) edge recreates the original topology and is skipped.

    The neighbourhood is O(n^2); ``max_neighbors`` (with ``seed``)
    subsamples it uniformly — the "lazy SPR" trick for big trees.
    """
    parent_of: Dict[int, int] = {}
    for n in tree.nodes:
        for c in n.children:
            parent_of[c] = n.index

    def subtree(v: int) -> set:
        out, stack = set(), [v]
        while stack:
            i = stack.pop()
            out.add(i)
            stack.extend(tree.nodes[i].children)
        return out

    out: List[Tree] = []
    moves: List[Tuple[int, ...]] = []
    for vnode in tree.nodes:
        v = vnode.index
        if v == tree.root or v not in parent_of:
            continue
        p = parent_of[v]
        if p == tree.root:
            # Pruning a child of the root would re-root the tree; those
            # topologies are reachable via moves lower in the tree.
            continue
        pnode = tree.nodes[p]
        sibs = [c for c in pnode.children if c != v]
        if len(sibs) != 1:
            continue
        s = sibs[0]
        g = parent_of[p]
        sub = subtree(v)
        for unode in tree.nodes:
            u = unode.index
            if u == tree.root or u in sub or u in (p, s):
                continue
            pu = parent_of[u]
            # Splice s into p's slot under g; insert p on the (u, pu) edge.
            # When pu == g both edits apply to g's child tuple, in order.
            children: Dict[int, Tuple[int, ...]] = {}
            children[g] = tuple(s if c == p else c
                                for c in tree.nodes[g].children)
            base = children.get(pu, tree.nodes[pu].children)
            children[pu] = tuple(p if c == u else c for c in base)
            children[p] = (v, u)
            half = unode.length / 2.0
            lengths = {s: tree.nodes[s].length + pnode.length,
                       p: half, u: half}
            out.append(_rebuild(tree, children, lengths))
            moves.append((s, p, u, v))
    if max_neighbors is not None and len(out) > max_neighbors:
        rng = np.random.default_rng(seed)
        keep = rng.choice(len(out), size=max_neighbors, replace=False)
        out = [out[i] for i in sorted(keep)]
        moves = [moves[i] for i in sorted(keep)]
    return (out, moves) if with_moves else out


def _scaled_lengths(tree: Tree, touched, mult: float) -> Tree:
    """Candidate variant with the move's touched branch lengths scaled."""
    lengths = {t: max(tree.nodes[t].length * mult, 1e-8)
               for t in touched}
    return _rebuild(tree, {}, lengths)


def _hill_climb(tree: Tree, model: SubstitutionModel, tip_states,
                neighbors_fn, wgt=None, alpha: Optional[float] = None,
                config: Optional[PLFConfig] = None, max_rounds: int = 10,
                optimize_lengths_every: int = 0, verbose: bool = False,
                on_round=None, start_round: int = 0,
                start_accepted: int = 0, start_evals: Optional[int] = None,
                refine_top: int = 0,
                refine_multipliers=(0.25, 0.5, 2.0, 4.0),
                device: Union[str, torch.device] = "cuda"
                ) -> SearchResult:
    """Greedy hill climbing over an arbitrary move set.

    Evaluates every neighbour per round and moves to the best
    strictly-improving topology until none improves or ``max_rounds`` is
    reached.  ``on_round(round, result)`` fires after every round
    (checkpoint hook).  The models live on ``device``.

    ``refine_top``: lazy-SPR-grade local refinement -- after the base
    neighbourhood scoring, the top-K candidates are re-scored with
    their move-touched branch lengths scaled by ``refine_multipliers``
    (the move generator must supply touched-node lists via
    ``with_moves``); the variant batch shares one launch and each
    candidate keeps its best variant.  Moves whose improvement only
    shows after local length adjustment -- the ones a fixed-length
    search wrongly rejects -- are recovered this way (RAxML's lazy
    rearrangement re-optimises exactly these branches before
    comparing).
    """

    def make(t: Tree, donor=None) -> PhyloModel:
        return PhyloModel(t, model, tip_states, wgt=wgt, alpha=alpha,
                          config=config if donor is None else donor.config,
                          share_device_from=donor, device=device)

    def ll_of(t: Tree) -> float:
        return make(t).log_likelihood().log_likelihood

    def score_all(cands) -> np.ndarray:
        """Score a whole neighbourhood, by rule: one launch of the fused
        kernel with a candidate axis (phylo.batch_log_likelihood) when
        the batch fits its arena (phylo.batch_fits); else the segmented
        kernel with a candidate axis (phylo.
        batch_log_likelihood_segmented), and candidate by candidate only
        where that raises ValueError (an ascertainment correction, a plan
        that fits no segment arena); under ``Backend.TORCH`` or for one
        candidate, each candidate's own ``log_likelihood()``."""
        pm0 = make(cands[0])
        if pm0.config.backend is Backend.TORCH or len(cands) == 1:
            return np.asarray([ll_of(c) for c in cands])
        # share pm0's device tensors (codes/weights/tables) and operator
        # cache: hundreds of candidates a round must not re-upload the
        # alignment
        pms = [pm0] + [make(c, donor=pm0) for c in cands[1:]]
        if batch_fits(pms):
            return batch_log_likelihood(pms)
        try:
            return batch_log_likelihood_segmented(pms)
        except ValueError:
            return np.asarray([pm.log_likelihood().log_likelihood
                               for pm in pms])

    current = tree
    best_ll = ll_of(current)
    accepted = start_accepted
    evals = start_evals if start_evals is not None else 1
    for rnd in range(start_round, max_rounds):
        best_move = None
        best_move_ll = best_ll
        res = neighbors_fn(current)
        cands, moves = res if isinstance(res, tuple) else (res, None)
        if cands:
            # The INCUMBENT is scored in the same batch as the
            # candidates: batched and single-model evaluations differ
            # by fp32 reduction order (documented rtol ~1e-6), so a
            # cross-scorer epsilon comparison could accept a spurious
            # "improvement" on a near-tie and loop on it.  Within one
            # scorer the comparison is deterministic and needs no
            # epsilon.
            lls = score_all([current] + cands)
            evals += len(cands)
            inc_ll = float(lls[0])
            i = int(np.argmax(lls[1:]))
            if lls[1 + i] > inc_ll:
                best_move_ll = float(lls[1 + i])
                best_move = cands[i]
            if refine_top and moves is not None:
                # lazy refinement pass: top-K candidates x multipliers
                # on the touched branches, one batched dispatch, each
                # compared against the incumbent scored in ITS batch
                order = np.argsort(np.asarray(lls[1:]))[::-1][:refine_top]
                variants, meta = [], []
                for ci in order:
                    for m in refine_multipliers:
                        variants.append(
                            _scaled_lengths(cands[ci], moves[ci], m))
                        meta.append(ci)
                vlls = score_all([current] + variants)
                evals += len(variants)
                vinc = float(vlls[0])
                j = int(np.argmax(vlls[1:]))
                base_margin = (best_move_ll - inc_ll
                               if best_move is not None else 0.0)
                if vlls[1 + j] > vinc and (
                        float(vlls[1 + j]) - vinc > base_margin):
                    best_move_ll = float(vlls[1 + j])
                    best_move = variants[j]
        if best_move is None:
            break
        current, best_ll = best_move, best_move_ll
        accepted += 1
        if verbose:
            print(f"move {accepted}: ll={best_ll:.4f}")
        if optimize_lengths_every and accepted % optimize_lengths_every == 0:
            from .optimize import optimize_branch_lengths
            t_opt, _, _ = optimize_branch_lengths(make(current), steps=40)
            nodes = [TreeNode(n.index, n.name,
                              float(t_opt[n.index]) if n.index < len(t_opt)
                              else n.length, n.children)
                     for n in current.nodes]
            current = Tree(nodes=nodes, root=current.root)
            best_ll = ll_of(current)
        if on_round is not None:
            on_round(rnd, SearchResult(current, best_ll, accepted, evals))
    return SearchResult(tree=current, log_likelihood=best_ll,
                        accepted_moves=accepted, evaluations=evals)


def nni_search(tree: Tree, model: SubstitutionModel, tip_states,
               wgt=None, alpha: Optional[float] = None,
               config: Optional[PLFConfig] = None, max_rounds: int = 10,
               optimize_lengths_every: int = 0,
               refine_top: int = 0,
               verbose: bool = False,
               device: Union[str, torch.device] = "cuda") -> SearchResult:
    """Greedy NNI hill climbing (see :func:`_hill_climb`);
    ``refine_top`` enables the lazy local-length refinement pass."""
    neigh = (lambda t: nni_neighbors(t, with_moves=True))
    return _hill_climb(tree, model, tip_states, neigh, wgt=wgt,
                       alpha=alpha, config=config, max_rounds=max_rounds,
                       optimize_lengths_every=optimize_lengths_every,
                       refine_top=refine_top,
                       verbose=verbose, device=device)


def spr_search(tree: Tree, model: SubstitutionModel, tip_states,
               wgt=None, alpha: Optional[float] = None,
               config: Optional[PLFConfig] = None, max_rounds: int = 10,
               optimize_lengths_every: int = 0,
               max_neighbors: Optional[int] = None,
               refine_top: int = 0,
               verbose: bool = False,
               device: Union[str, torch.device] = "cuda") -> SearchResult:
    """Greedy SPR hill climbing; ``max_neighbors`` subsamples the O(n^2)
    neighbourhood per round; ``refine_top`` enables the lazy
    local-length refinement pass (RAxML's lazy SPR)."""

    def neigh(t: Tree):
        return spr_neighbors(t, max_neighbors=max_neighbors,
                             with_moves=True)

    return _hill_climb(tree, model, tip_states, neigh, wgt=wgt,
                       alpha=alpha, config=config, max_rounds=max_rounds,
                       optimize_lengths_every=optimize_lengths_every,
                       refine_top=refine_top,
                       verbose=verbose, device=device)


def tree_search(tree: Tree, model: SubstitutionModel, tip_states,
                wgt=None, alpha: Optional[float] = None,
                config: Optional[PLFConfig] = None,
                strategy: str = "nni", max_rounds: int = 10,
                optimize_lengths_every: int = 0,
                max_neighbors: Optional[int] = None,
                checkpoint_path: Optional[str] = None,
                refine_top: int = 0,
                verbose: bool = False,
                device: Union[str, torch.device] = "cuda") -> SearchResult:
    """Production search entry point: strategy selection + checkpoint/resume.

    ``strategy``: "nni", "spr", or "mixed" (SPR rounds, then NNI polish).
    With ``checkpoint_path``, the search state (current tree as newick,
    ll, round/accepted/eval counters) is snapshotted after every round
    and resumed if the file exists — tip rows are re-matched BY LEAF NAME
    because newick reparsing renumbers leaves.
    """
    from ..utils.checkpoint import (checkpoint_exists, load_checkpoint,
                                    save_checkpoint)

    tips = np.asarray(tip_states)
    start_round = start_accepted = 0
    start_evals = None
    if checkpoint_path and checkpoint_exists(checkpoint_path):
        _, meta = load_checkpoint(checkpoint_path)
        resumed = parse_newick(meta["newick"])
        name_to_row = {(n.name or f"t{n.index}"): n.index
                       for n in tree.nodes if n.is_leaf}
        perm = [name_to_row[nm] for nm in resumed.leaf_names()]
        tips = tips[perm]
        tree = resumed
        start_round = int(meta["round"]) + 1
        start_accepted = int(meta["accepted"])
        start_evals = int(meta["evaluations"])
        if verbose:
            print(f"resumed search at round {start_round} "
                  f"(ll={meta['log_likelihood']:.4f})")

    def on_round(rnd: int, res: SearchResult) -> None:
        if checkpoint_path:
            save_checkpoint(checkpoint_path, {}, meta={
                "newick": res.tree.to_newick(),
                "log_likelihood": res.log_likelihood,
                "round": rnd, "accepted": res.accepted_moves,
                "evaluations": res.evaluations, "strategy": strategy})

    if strategy == "nni":
        neigh = lambda t: nni_neighbors(t, with_moves=True)
    elif strategy == "spr":
        neigh = lambda t: spr_neighbors(t, max_neighbors=max_neighbors,
                                        with_moves=True)
    elif strategy == "mixed":
        def neigh(t):
            ts, ms = spr_neighbors(t, max_neighbors=max_neighbors,
                                   with_moves=True)
            tn, mn = nni_neighbors(t, with_moves=True)
            return ts + tn, ms + mn
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return _hill_climb(tree, model, tips, neigh, wgt=wgt, alpha=alpha,
                       config=config, max_rounds=max_rounds,
                       optimize_lengths_every=optimize_lengths_every,
                       refine_top=refine_top,
                       verbose=verbose, on_round=on_round,
                       start_round=start_round,
                       start_accepted=start_accepted,
                       start_evals=start_evals, device=device)
