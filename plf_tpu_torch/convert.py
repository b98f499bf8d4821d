"""Build the port's objects from the JAX package's parameters.

The two packages share no code at run time (``plf_tpu`` imports JAX,
which the GPU machine does not have), so a model moves between them by
value: NumPy arrays and plain Python numbers.  From a JAX ``PhyloModel``
``pm`` the fields are::

    pi=pm.model.pi, eigenvalues=pm.model.eigenvalues, u=pm.model.u,
    w=pm.model.w, nodes=[(n.index, n.name, n.length, n.children)
    for n in pm.tree.nodes], root=pm.tree.root, rates=pm.rates,
    rate_weights=pm.rate_weights,
    tip_states=pm.tip_states[:, :pm.n_sites_obs], wgt=pm.wgt[:pm.n_sites_obs]

and the result encodes the same operators bit for bit.  A JAX
``PartitionedModel`` ``pmod`` moves by its partitions: for each ``p`` in
``pmod.partitions``::

    dict(name=p.name, sites=p.sites, wgt=p.wgt, alpha=p.alpha,
         scale=p.scale, pi=p.model.pi, eigenvalues=p.model.eigenvalues,
         u=p.model.u, w=p.model.w)

with the shared tree and the full tip matrix as for ``phylo_model``.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Union

import numpy as np
import torch

from .config import PLFConfig
from .models.partition import Partition, PartitionedModel
from .models.phylo import PhyloModel
from .models.substitution import SubstitutionModel
from .models.tree import Tree, TreeNode, parse_newick

__all__ = ["substitution_model", "tree_from_nodes", "phylo_model",
           "partitioned_model"]


def substitution_model(pi, eigenvalues, u, w) -> SubstitutionModel:
    """A SubstitutionModel from its eigensystem arrays."""
    return SubstitutionModel(pi=np.array(pi, np.float64),
                             eigenvalues=np.array(eigenvalues, np.float64),
                             u=np.array(u, np.float64),
                             w=np.array(w, np.float64))


def tree_from_nodes(nodes: Iterable, root: Optional[int] = None) -> Tree:
    """A Tree from ``(index, name, length, children)`` tuples, listed in
    index order; ``root`` defaults to the last node."""
    out = [TreeNode(index=int(i), name=name, length=float(length),
                    children=tuple(int(c) for c in children))
           for (i, name, length, children) in nodes]
    if any(n.index != k for k, n in enumerate(out)):
        raise ValueError("nodes must be listed in index order 0..N-1")
    return Tree(nodes=out, root=len(out) - 1 if root is None else int(root))


def phylo_model(*, pi, eigenvalues, u, w, tip_states, rates,
                rate_weights=None, nodes=None, root=None,
                newick: Optional[str] = None, wgt=None,
                ascertainment: Optional[str] = None,
                config: Optional[PLFConfig] = None,
                device: Union[str, torch.device] = "cuda") -> PhyloModel:
    """A port PhyloModel from the JAX model's arrays (see the module
    docstring); give the tree as ``nodes`` (+ ``root``) or ``newick``.
    It lives on the card unless ``device="cpu"``."""
    if (nodes is None) == (newick is None):
        raise ValueError("give the tree as nodes or as newick, not both")
    tree = (parse_newick(newick) if newick is not None
            else tree_from_nodes(nodes, root))
    model = substitution_model(pi, eigenvalues, u, w)
    return PhyloModel(tree, model, np.asarray(tip_states),
                      wgt=None if wgt is None else np.asarray(wgt),
                      config=config, ascertainment=ascertainment,
                      rates=np.asarray(rates, np.float64),
                      rate_weights=(None if rate_weights is None
                                    else np.asarray(rate_weights,
                                                    np.float64)),
                      device=device)


def partitioned_model(*, partitions: Sequence[dict], tip_states,
                      nodes=None, root=None, newick: Optional[str] = None,
                      ascertainment: Optional[str] = None,
                      config: Optional[PLFConfig] = None,
                      device: Union[str, torch.device] = "cuda"
                      ) -> PartitionedModel:
    """A port PartitionedModel from the JAX one's partitions, each a dict
    of its site indices, weights, eigensystem, alpha and scale (see the
    module docstring); the tree as for :func:`phylo_model`.  It lives on
    the card unless ``device="cpu"``."""
    if (nodes is None) == (newick is None):
        raise ValueError("give the tree as nodes or as newick, not both")
    tree = (parse_newick(newick) if newick is not None
            else tree_from_nodes(nodes, root))
    parts = [Partition(
        name=p["name"], sites=np.asarray(p["sites"]),
        model=substitution_model(p["pi"], p["eigenvalues"], p["u"], p["w"]),
        alpha=p.get("alpha"),
        wgt=None if p.get("wgt") is None else np.asarray(p["wgt"]),
        scale=float(p.get("scale", 1.0))) for p in partitions]
    return PartitionedModel(tree, parts, np.asarray(tip_states),
                            config=config, ascertainment=ascertainment,
                            device=device)
