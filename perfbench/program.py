"""The system under test, reached as a user reaches it.

This is the benchmark's only module that imports ``plf_tpu_torch``: the
tree, the substitution model and the alignment go in as a user's would
(a ``Tree``, a ``SubstitutionModel``, NumPy int8 tip states), and what
comes back is ``tree_loglik_fn``'s function with the user's defaults
(auto kernel variant, auto backend); the Gamma-shape search takes its
rates from the port's own rule, as ``optimize_alpha`` does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["substitution_model", "phylo_model", "port_tree", "loglik_fn",
           "gamma_rates", "launches"]


def substitution_model(spec: dict, paml_text: str = None):
    """The configuration's model as the port builds it."""
    from plf_tpu_torch.models.substitution import empirical_protein, gtr
    if spec["kind"] == "gtr":
        return gtr(spec["exchangeabilities"], spec["frequencies"])
    if spec["kind"] == "paml":
        return empirical_protein(paml_text)
    raise ValueError(f"unknown model kind {spec['kind']!r}")


def phylo_model(children: Sequence[Tuple[int, int]], lengths: np.ndarray,
                model, tips: np.ndarray, alpha, plf_config, device,
                rates=None):
    """``PhyloModel(tree, model, tips, alpha=...)`` on ``device``
    (``rates=`` instead of ``alpha``: explicit category rates)."""
    from plf_tpu_torch import PLFConfig
    from plf_tpu_torch.models.phylo import PhyloModel
    config = None if plf_config is None else PLFConfig(
        states=model.states, **plf_config)
    return PhyloModel(port_tree(children, lengths), model, tips, alpha=alpha,
                      config=config, rates=rates, device=device)


def port_tree(children: Sequence[Tuple[int, int]], lengths: np.ndarray):
    """The tree as the port's ``Tree``: node ``i`` of the arrays is node
    ``i`` of the tree."""
    from plf_tpu_torch.models.tree import Tree, TreeNode
    n_leaves = len(children) + 1
    nodes = [TreeNode(index=i, name=f"t{i}", length=float(lengths[i]))
             for i in range(n_leaves)]
    nodes += [TreeNode(index=n_leaves + k, length=float(lengths[n_leaves + k]),
                       children=tuple(ch))
              for k, ch in enumerate(children)]
    return Tree(nodes=nodes, root=len(nodes) - 1)


def loglik_fn(pm, with_rates: bool):
    """``tree_loglik_fn(pm[, with_rates=True])`` on the auto backend."""
    from plf_tpu_torch.models.optimize import tree_loglik_fn
    return tree_loglik_fn(pm, with_rates=with_rates)


def gamma_rates(alpha: float, categories: int) -> np.ndarray:
    """The port's discrete-Gamma rates, as ``optimize_alpha`` takes them."""
    from plf_tpu_torch.models.substitution import discrete_gamma_rates
    return discrete_gamma_rates(alpha, categories)


def launches() -> dict:
    """The kernel wrappers' launch counts, those above 0."""
    from plf_tpu_torch.ops import launch_counts
    return {k: v for k, v in launch_counts().items() if v}
