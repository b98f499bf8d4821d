"""Phylogenetic tree structure and post-order PLF schedules.

A NumPy-only copy of ``plf_tpu/models/tree.py``.

The reference computes a single PLF node update per call; its production
context (RAxML's newview) walks a whole tree post-order, re-running the
kernel at every internal node (SURVEY.md §0).  This module supplies that
structure: a small binary tree with newick parsing and serialisation, a
post-order evaluation schedule and level grouping.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["TreeNode", "Tree", "parse_newick", "random_tree"]


@dataclasses.dataclass
class TreeNode:
    index: int
    name: Optional[str] = None
    length: float = 0.0          # branch length to parent
    children: Tuple[int, ...] = ()

    @property
    def is_leaf(self) -> bool:
        return not self.children


@dataclasses.dataclass
class Tree:
    """Rooted binary tree. Node 0..n_leaves-1 are leaves; root is last."""

    nodes: List[TreeNode]
    root: int

    @property
    def n_leaves(self) -> int:
        return sum(1 for n in self.nodes if n.is_leaf)

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def leaf_names(self) -> List[str]:
        return [n.name or f"t{n.index}" for n in self.nodes if n.is_leaf]

    def postorder(self) -> List[int]:
        """Internal-node indices in evaluation (post)order."""
        order: List[int] = []
        stack = [(self.root, False)]
        while stack:
            idx, expanded = stack.pop()
            node = self.nodes[idx]
            if node.is_leaf:
                continue
            if expanded:
                order.append(idx)
            else:
                stack.append((idx, True))
                for ch in node.children:
                    stack.append((ch, False))
        return order

    def schedule(self) -> List[Tuple[int, int, int, float, float]]:
        """Post-order PLF schedule: (parent, left, right, t_left, t_right)."""
        out = []
        for idx in self.postorder():
            node = self.nodes[idx]
            if len(node.children) != 2:
                raise ValueError(
                    f"node {idx} has {len(node.children)} children; "
                    "binarise the tree first (see parse_newick)")
            l, r = node.children
            out.append((idx, l, r, self.nodes[l].length, self.nodes[r].length))
        return out

    def to_newick(self, include_root_length: bool = False) -> str:
        """Serialise to newick (inverse of :func:`parse_newick`).

        Leaves without a name get ``t<index>`` so the string round-trips
        to an equivalent tree (same leaf labels, same branch lengths,
        same topology; leaf *indices* follow newick order after reparse —
        match by name when resuming from a serialised tree).
        """
        def rec(i: int, at_root: bool) -> str:
            n = self.nodes[i]
            if n.is_leaf:
                return f"{n.name or f't{i}'}:{n.length:.17g}"
            inner = ",".join(rec(c, False) for c in n.children)
            label = n.name or ""
            if at_root and not include_root_length:
                return f"({inner}){label}"
            return f"({inner}){label}:{n.length:.17g}"

        return rec(self.root, True) + ";"

    def levels(self) -> List[List[int]]:
        """Group internal nodes into dependency levels (batchable waves)."""
        depth: Dict[int, int] = {}
        for idx in self.postorder():
            node = self.nodes[idx]
            depth[idx] = 1 + max(
                (depth.get(c, 0) for c in node.children), default=0)
        levels: Dict[int, List[int]] = {}
        for idx, d in depth.items():
            levels.setdefault(d, []).append(idx)
        return [levels[d] for d in sorted(levels)]


def parse_newick(text: str) -> Tree:
    """Parse a newick string into a rooted binary Tree.

    Multifurcations (including the usual unrooted trifurcation at the
    outermost level) are binarised with zero-length internal branches,
    which leaves the likelihood unchanged.
    """
    text = text.strip().rstrip(";")
    pos = 0

    def parse_node():
        nonlocal pos
        children = []
        name = None
        length = 0.0
        if text[pos] == "(":
            pos += 1
            while True:
                children.append(parse_node())
                if text[pos] == ",":
                    pos += 1
                    continue
                if text[pos] == ")":
                    pos += 1
                    break
        # optional "label[:length]" (must consume ':' so it can't stall)
        start = pos
        while pos < len(text) and text[pos] not in ",();":
            pos += 1
        label = text[start:pos]
        if ":" in label:
            name_part, _, len_part = label.partition(":")
            name = name_part or None
            length = float(len_part)
        elif label:
            name = label
        return {"name": name, "length": length, "children": children}

    ast = parse_node()

    leaves: List[TreeNode] = []
    internals: List[dict] = []

    def collect(node):
        if not node["children"]:
            leaves.append(TreeNode(index=-1, name=node["name"],
                                   length=node["length"]))
            return ("leaf", len(leaves) - 1)
        kids = [collect(c) for c in node["children"]]
        # binarise left-deep with zero-length connectors
        while len(kids) > 2:
            a = kids.pop(0)
            b = kids.pop(0)
            internals.append({"name": None, "length": 0.0, "kids": (a, b)})
            kids.insert(0, ("internal", len(internals) - 1))
        internals.append({"name": node["name"], "length": node["length"],
                          "kids": tuple(kids)})
        return ("internal", len(internals) - 1)

    collect(ast)

    n_leaves = len(leaves)
    nodes: List[TreeNode] = []
    for i, leaf in enumerate(leaves):
        nodes.append(TreeNode(index=i, name=leaf.name, length=leaf.length))

    def resolve(ref) -> int:
        kind, i = ref
        return i if kind == "leaf" else n_leaves + i

    for i, spec in enumerate(internals):
        nodes.append(TreeNode(
            index=n_leaves + i, name=spec["name"], length=spec["length"],
            children=tuple(resolve(r) for r in spec["kids"])))
    return Tree(nodes=nodes, root=len(nodes) - 1)


def random_tree(n_leaves: int, seed: int = 0,
                mean_branch: float = 0.1) -> Tree:
    """Random rooted binary tree (coalescent-style joins) for tests/bench."""
    rng = np.random.default_rng(seed)
    nodes = [TreeNode(index=i, name=f"t{i}",
                      length=float(rng.exponential(mean_branch)) + 1e-3)
             for i in range(n_leaves)]
    avail = list(range(n_leaves))
    while len(avail) > 1:
        i = avail.pop(rng.integers(len(avail)))
        j = avail.pop(rng.integers(len(avail)))
        idx = len(nodes)
        nodes.append(TreeNode(
            index=idx, length=float(rng.exponential(mean_branch)) + 1e-3,
            children=(i, j)))
        avail.append(idx)
    return Tree(nodes=nodes, root=len(nodes) - 1)
