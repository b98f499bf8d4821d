"""Partitioned models: per-partition Q matrix / alpha on a shared tree.

Counterpart of ``plf_tpu/models/partition.py``.  Production phylogenetics
splits an alignment into partitions (genes, codon positions) that share
the tree topology and branch lengths but get their own substitution
model, gamma shape, and optionally a per-partition branch-length
multiplier ("proportional branch lengths", RAxML's -q/-M).

Total log-likelihood is the sum over partitions (sites are independent):
each partition's evaluation is its own ``PhyloModel.log_likelihood()``
(on the card one launch of kernel 2 or 2m, or the segmented kernel), and
the per-partition likelihoods sum on the host.  The joint objective of
:meth:`PartitionedModel.loglik_fn` sums each partition's
``tree_loglik_fn`` (its auto backend: on the card kernels 7 + 8 or
2 + 4 for DNA, 2m + 4m for protein and codon) and differentiates by
autograd; :meth:`PartitionedModel.optimize` fits it with
``torch.optim.Adam`` (optax's defaults).  Each takes a ``mesh``
(``parallel.SiteMesh``) that shards every partition's sites over the
ranks of a ``torch.distributed`` group.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import PLFConfig
from .phylo import PhyloModel, TreeLikelihoodResult
from .substitution import SubstitutionModel
from .tree import Tree

__all__ = ["Partition", "PartitionedModel", "PartitionedResult"]

@dataclasses.dataclass
class Partition:
    """One alignment partition.

    ``sites``: column indices into the alignment (any order, disjointness
    is the caller's contract).  ``scale``: initial branch-length
    multiplier for proportional-branch-length fitting.
    """

    name: str
    sites: np.ndarray
    model: SubstitutionModel
    alpha: Optional[float] = None
    wgt: Optional[np.ndarray] = None
    scale: float = 1.0


@dataclasses.dataclass
class PartitionedResult:
    log_likelihood: float
    per_partition: List[TreeLikelihoodResult]


class PartitionedModel:
    """Shared-tree, per-partition-model likelihood + joint fitting; the
    partitions' models live on ``device``."""

    def __init__(self, tree: Tree, partitions: Sequence[Partition],
                 tip_states: np.ndarray,
                 config: Optional[PLFConfig] = None,
                 ascertainment: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        tip_states = np.asarray(tip_states)
        self.tree = tree
        self.partitions = list(partitions)
        self.models: List[PhyloModel] = []
        for p in self.partitions:
            cfg = config
            if cfg is not None and cfg.states != p.model.states:
                cfg = dataclasses.replace(cfg, states=p.model.states)
            self.models.append(PhyloModel(
                tree, p.model, tip_states[:, np.asarray(p.sites)],
                wgt=p.wgt, alpha=p.alpha, config=cfg,
                ascertainment=ascertainment, device=device))

    def log_likelihood(self, method: str = "auto") -> PartitionedResult:
        results = [pm.log_likelihood(method=method) for pm in self.models]
        return PartitionedResult(
            log_likelihood=float(sum(r.log_likelihood for r in results)),
            per_partition=results)

    def log_likelihood_sharded(self, mesh=None) -> PartitionedResult:
        """Partitioned likelihood with every partition's site axis sharded
        over the ranks of ``mesh`` (``parallel.SiteMesh``): each partition
        runs ``PhyloModel.log_likelihood_sharded`` (one all-reduce of its
        partials each), and the totals sum on the host, the same on every
        rank.  Each per-partition result's site arrays are this rank's
        shard."""
        results = [pm.log_likelihood_sharded(mesh=mesh)
                   for pm in self.models]
        return PartitionedResult(
            log_likelihood=float(sum(r.log_likelihood for r in results)),
            per_partition=results)

    # -- differentiable joint objective --------------------------------------

    def loglik_fn(self, proportional: bool = True, mesh=None):
        """Joint objective over shared branch lengths.

        Returns ``(fn, t0, scales0)`` with
        ``fn(t_vec, log_scales) = sum_p ll_p(t_vec * exp(log_scales[p]))``,
        a 0-d fp32 tensor on the models' device, differentiable by
        ``.backward()`` in both arguments.  ``log_scales[0]`` should be
        held at 0 by the caller when fitting (only ratios are identifiable
        alongside free branch lengths); with ``proportional=False`` scales
        are ignored entirely.  With ``mesh`` (``parallel.SiteMesh``) each
        partition's forward and backward run on this rank's shard of its
        sites (``tree_loglik_fn``'s ``mesh``): the joint objective and its
        gradient are all-reduced, the same on every rank.
        """
        from .optimize import tree_loglik_fn

        fns = []
        t0 = None
        for pm in self.models:
            fn, t0_p = tree_loglik_fn(pm, with_rates=True, mesh=mesh)
            fns.append((fn, torch.as_tensor(pm.rates, dtype=torch.float32,
                                            device=pm.device)))
            t0 = t0_p if t0 is None else t0

        scales0 = np.array([p.scale for p in self.partitions], np.float32)
        dev = self.models[0].device

        def joint(t_vec, log_scales):
            t_vec = torch.as_tensor(t_vec, dtype=torch.float32, device=dev)
            log_scales = torch.as_tensor(log_scales, dtype=torch.float32,
                                         device=dev)
            total = torch.zeros((), dtype=torch.float32, device=dev)
            for i, (fn, rates) in enumerate(fns):
                s = torch.exp(log_scales[i]) if proportional else 1.0
                total = total + fn(t_vec * s, rates)
            return total

        return joint, t0, scales0

    def optimize(self, steps: int = 100, learning_rate: float = 0.02,
                 min_length: float = 1e-6, proportional: bool = True,
                 mesh=None):
        """Jointly fit shared branch lengths (+ per-partition multipliers).

        Adam (``torch.optim.Adam`` with optax's defaults: b1 0.9, b2
        0.999, eps 1e-8 added outside the square root) on log lengths and
        log multipliers.  Returns ``(t_opt, scales_opt, ll_before,
        ll_after)``; the first partition's multiplier is pinned to 1 for
        identifiability.
        """
        fn, t0, scales0 = self.loglik_fn(proportional=proportional,
                                         mesh=mesh)
        dev = self.models[0].device
        log_t = torch.log(torch.clamp_min(
            torch.as_tensor(t0, device=dev), min_length)).requires_grad_()
        log_s = torch.as_tensor(np.log(np.maximum(scales0, 1e-3)),
                                device=dev).requires_grad_()

        def pinned(ls):
            return ls - ls[0]  # partition 0 multiplier == 1

        def loss():
            return -fn(torch.exp(log_t) + min_length, pinned(log_s))

        with torch.no_grad():
            ll0 = -float(loss())
        opt = torch.optim.Adam([log_t, log_s], lr=learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        for _ in range(steps):
            opt.zero_grad()
            loss().backward()
            opt.step()
        with torch.no_grad():
            ll1 = -float(loss())
            t_opt = (torch.exp(log_t) + min_length).cpu().numpy()
            scales_opt = torch.exp(pinned(log_s)).cpu().numpy()
        return t_opt, scales_opt, ll0, ll1
