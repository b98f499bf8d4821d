"""Tree comparison and summary: bipartitions, RF distance, consensus,
bootstrap support.

Counterpart of ``plf_tpu/models/consensus.py``.

Completes the bootstrap story (models/bootstrap.py): resampled replicate
trees are summarised into split frequencies, a majority-rule consensus
tree, and per-branch support values mapped onto a reference topology —
the standard Felsenstein-bootstrap outputs RAxML prints (the reference
kernel's production context).  Distance-bootstrap replicates reuse the
device-side pairwise counting (models/distance.py), so the O(L^2 * n)
part of every replicate runs on the card and only O(L^3) NJ runs on
host.

All functions identify splits by leaf NAME (frozenset of the side not
containing the anchor leaf), so trees with different internal indexing
compare correctly.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .tree import Tree, TreeNode

__all__ = ["bipartitions", "rf_distance", "majority_rule_consensus",
           "split_support", "bootstrap_nj_trees", "annotate_support"]

Split = FrozenSet[str]


def _leafsets(tree: Tree) -> Dict[int, FrozenSet[str]]:
    """Leaf-name set under every node."""
    sets: Dict[int, FrozenSet[str]] = {}
    for node in tree.nodes:
        if node.is_leaf:
            sets[node.index] = frozenset([node.name or f"t{node.index}"])
    for idx in tree.postorder():
        node = tree.nodes[idx]
        s: FrozenSet[str] = frozenset()
        for c in node.children:
            s = s | sets[c]
        sets[idx] = s
    return sets


def bipartitions(tree: Tree) -> Dict[Split, Tuple[int, float]]:
    """Non-trivial splits of the *unrooted* topology.

    Returns {split: (node_index, branch_length)} where the split is the
    canonical side (the one NOT containing the anchor leaf = the
    alphabetically first name).  Trivial splits (single leaf / all-but-
    one) and the root's redundant split are excluded; zero-length
    binarisation connectors are kept (they are real splits of the binary
    tree, but callers comparing multifurcating trees may filter on
    length).
    """
    sets = _leafsets(tree)
    all_names = sets[tree.root]
    anchor = min(all_names)
    out: Dict[Split, Tuple[int, float]] = {}
    for node in tree.nodes:
        if node.is_leaf or node.index == tree.root:
            continue
        side = sets[node.index]
        if anchor in side:
            side = all_names - side
        if len(side) < 2 or len(side) > len(all_names) - 2:
            continue
        out[frozenset(side)] = (node.index, node.length)
    return out


def rf_distance(t1: Tree, t2: Tree) -> int:
    """Robinson-Foulds distance (symmetric difference of split sets)."""
    s1, s2 = set(bipartitions(t1)), set(bipartitions(t2))
    if _leafsets(t1)[t1.root] != _leafsets(t2)[t2.root]:
        raise ValueError("trees have different leaf sets")
    return len(s1 ^ s2)


def split_support(trees: Sequence[Tree]) -> Dict[Split, float]:
    """Frequency of every non-trivial split across a tree sample."""
    counts: Counter = Counter()
    for t in trees:
        counts.update(bipartitions(t).keys())
    n = float(len(trees))
    return {s: c / n for s, c in counts.items()}


def majority_rule_consensus(trees: Sequence[Tree],
                            threshold: float = 0.5) -> Tree:
    """Majority-rule consensus tree with support as internal node names.

    Splits with frequency > ``threshold`` (default strict majority —
    guarantees pairwise compatibility) are assembled into a (possibly
    multifurcating) tree, then binarised with zero-length connectors so
    the result is directly usable by the PLF engine.  Internal node
    names carry the support percentage (e.g. ``"87"``).
    """
    if not trees:
        raise ValueError("need at least one tree")
    if not 0.5 <= threshold < 1.0:
        raise ValueError("threshold must be in [0.5, 1.0)")
    support = split_support(trees)
    names = sorted(_leafsets(trees[0])[trees[0].root])
    keep = [(s, f) for s, f in support.items() if f > threshold]
    # Insert larger splits first so each split nests into its parent.
    keep.sort(key=lambda sf: (-len(sf[0]), -sf[1]))

    # Build a nested grouping: each group is (member_leaf_names, children)
    # where children are either leaf names or sub-groups.
    class Grp:
        __slots__ = ("members", "children", "label")

        def __init__(self, members, children, label=""):
            self.members = members      # frozenset of names
            self.children = children    # list of Grp | str
            self.label = label

    root = Grp(frozenset(names), list(names))

    def locate(g: Grp, split: Split) -> Optional[Grp]:
        for ch in g.children:
            if isinstance(ch, Grp) and split <= ch.members:
                return locate(ch, split)
        return g if split <= g.members else None

    for split, freq in keep:
        host = locate(root, split)
        if host is None:
            continue
        inside = [ch for ch in host.children
                  if (ch.members if isinstance(ch, Grp)
                      else frozenset([ch])) <= split]
        if not inside:
            continue  # incompatible with an already-inserted split
        covered = frozenset().union(
            *[(ch.members if isinstance(ch, Grp) else frozenset([ch]))
              for ch in inside])
        if covered != split:
            continue  # incompatible
        sub = Grp(split, inside, label=str(int(round(freq * 100))))
        host.children = [ch for ch in host.children
                         if ch not in inside] + [sub]

    nodes: List[TreeNode] = [TreeNode(index=i, name=nm, length=0.0)
                             for i, nm in enumerate(names)]
    leaf_idx = {nm: i for i, nm in enumerate(names)}

    def emit(g: Grp) -> int:
        child_ids = []
        for ch in g.children:
            if isinstance(ch, Grp):
                child_ids.append(emit(ch))
            else:
                child_ids.append(leaf_idx[ch])
        # Binarise multifurcations left-deep with zero-length connectors.
        while len(child_ids) > 2:
            a = child_ids.pop(0)
            b = child_ids.pop(0)
            idx = len(nodes)
            nodes.append(TreeNode(index=idx, length=0.0, children=(a, b)))
            child_ids.insert(0, idx)
        idx = len(nodes)
        nodes.append(TreeNode(index=idx, name=g.label or None, length=0.0,
                              children=tuple(child_ids)))
        return idx

    root_idx = emit(root)
    return Tree(nodes=nodes, root=root_idx)


def annotate_support(ref: Tree, trees: Sequence[Tree]) -> Tree:
    """Copy of ``ref`` with bootstrap support percentages as internal
    node names (the RAxML ``-f b`` bipartition-drawing mode)."""
    support = split_support(trees)
    by_node = {idx: support.get(split, 0.0)
               for split, (idx, _) in bipartitions(ref).items()}
    nodes = []
    for n in ref.nodes:
        if n.is_leaf or n.index not in by_node:
            nodes.append(n)
        else:
            nodes.append(TreeNode(
                index=n.index, name=str(int(round(by_node[n.index] * 100))),
                length=n.length, children=n.children))
    return Tree(nodes=nodes, root=ref.root)


def bootstrap_nj_trees(codes, wgt=None, n_replicates: int = 100,
                       names: Optional[Sequence[str]] = None,
                       states: int = 4, seed: int = 0,
                       device: Union[str, torch.device] = "cuda"
                       ) -> List[Tree]:
    """Distance-bootstrap replicate trees.

    Each replicate redraws site weights multinomially
    (models/bootstrap.bootstrap_weights), recomputes the JC distance
    matrix on ``device`` with those weights, and builds an NJ tree.  Feed
    the result to :func:`majority_rule_consensus` /
    :func:`annotate_support`.
    """
    from ..devices import resolve_device
    from .bootstrap import bootstrap_weights
    from .distance import jc_distance_matrix, neighbor_joining

    device = resolve_device(device)
    codes = np.asarray(codes)
    n = codes.shape[1]
    base = (np.ones((n,), np.int64) if wgt is None
            else np.asarray(wgt, np.int64))
    reps = bootstrap_weights(base, n_replicates, seed=seed)
    out = []
    for w in reps:
        d = jc_distance_matrix(codes, w.astype(np.float32), states=states,
                               device=device)
        out.append(neighbor_joining(d, names))
    return out
