"""Site-sharded PLF over ``torch.distributed``: the scale-out layer.

Counterpart of ``plf_tpu/parallel/sharding.py``.  The JAX package shards
the site axis of lane-major CLVs over a 1-D device mesh inside one
process (``shard_map``), replicates the branch and EV constants, and
merges the weighted scaler counts with a ``psum``.  Here the mesh is SPMD
over ``torch.distributed``: one process per rank and one card per rank,
every rank running the same program on its own shard of sites.  The site
axis is pointwise (no halo, no resharding), so the only traffic between
ranks is the all-reduce of a few scalars (and, for a training step, of
the operator-stack gradients: ``models/optimize.py``).

* :class:`SiteMesh` / :func:`make_mesh`: the group, its size, this
  process's rank and the device it computes on; with no process group
  initialised, one rank and no collective at all.
* :func:`padded_sites` / :func:`shard_span`: the JAX package's ceil-div
  padding to ``ranks * block_sites`` and each rank's count of valid
  sites, ``n_local = clip(n - rank*shard, 0, shard)``
  (``plf_tpu/parallel/sharding.py:76-97``).
* :func:`shard_sites`: this rank's slice of a lane-major array.
* :func:`plf_sharded` / :class:`ShardedPLF`: kernel 1 (1m) on this rank's
  shard, the weighted scaler increment all-reduced as int64.

A gloo group carries tensors that live on a card through host copies
(:meth:`SiteMesh.all_reduce`); NCCL takes them where they are.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..ops import layout as L
from ..ops.plf_node import plf_node

__all__ = ["SiteMesh", "make_mesh", "padded_sites", "shard_span",
           "shard_sites", "plf_sharded", "ShardedPLF", "all_reduce_sum",
           "replicated"]


@dataclasses.dataclass(frozen=True)
class SiteMesh:
    """A 1-D mesh over the site axis: ``size`` ranks of process group
    ``group`` (None: one rank, no collective), this process's ``rank`` in
    it (-1 if this process is not a member) and the ``device`` it
    computes on."""

    group: Optional[object]
    size: int
    rank: int
    device: torch.device
    axis: str = "sites"

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as a JAX mesh's ``shape``."""
        return {self.axis: self.size}

    @property
    def backend(self) -> Optional[str]:
        """The group's backend ("nccl", "gloo"), or None with no group."""
        return None if self.group is None else str(
            dist.get_backend(self.group))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place, and return it.  Through
        host memory when the group is gloo and ``t`` lies on a card."""
        if self.group is None or self.size == 1:
            return t
        if t.device.type != "cpu" and self.backend == "gloo":
            h = t.cpu()
            dist.all_reduce(h, group=self.group)
            return t.copy_(h)
        dist.all_reduce(t, group=self.group)
        return t


def _local_device(device, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", max(rank, 0)))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(n_devices: Optional[int] = None, axis: str = "sites",
              device: Union[str, torch.device] = "cuda",
              group=None) -> SiteMesh:
    """1-D site mesh over the ranks of ``group`` (default: the world
    group of an initialised ``torch.distributed``; no group at all
    otherwise, one rank).  ``n_devices``, where given, must be that many
    ranks.  ``device``: where this rank computes; "cuda" is the card of
    its local rank (``LOCAL_RANK``, else its rank, modulo the cards).  A
    process outside ``group`` gets rank -1 and size 0, which
    ``validate_site_workload`` refuses."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD if group is None else group
        rank = dist.get_rank(group)
        size = dist.get_world_size(group) if rank >= 0 else 0
    elif group is not None:
        raise ValueError("make_mesh: a group needs an initialised "
                         "torch.distributed")
    else:
        size, rank = 1, 0
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, but the "
                         f"process group has {size} rank(s); one process "
                         f"runs one rank")
    return SiteMesh(group if size > 1 else None, size, rank,
                    _local_device(device, rank), axis)


def padded_sites(mesh: SiteMesh, n: int, block_sites: int) -> int:
    """Global padded site count: ``n`` rounded up to a multiple of
    ``ranks * block_sites`` (at least one such unit), the reference's
    multi-instance ceil-div policy (``include.h:181-195``)."""
    unit = mesh.size * block_sites
    return max(unit, L.cdiv(n, unit) * unit)


def shard_span(mesh: SiteMesh, n: int, n_pad: int):
    """``(lo, shard, n_local)`` of this rank: its first global site, its
    shard width and its count of valid sites, ``clip(n - rank*shard, 0,
    shard)`` (``plf_tpu/parallel/sharding.py:83``)."""
    if n_pad % mesh.size:
        raise ValueError(f"padded sites {n_pad} not divisible by "
                         f"{mesh.size} ranks")
    shard = n_pad // mesh.size
    lo = mesh.rank * shard
    return lo, shard, int(np.clip(n - lo, 0, shard))


def shard_sites(mesh: SiteMesh, x, n_pad: Optional[int] = None,
                fill=0) -> torch.Tensor:
    """This rank's shard of ``x``'s last axis (a global lane-major array,
    NumPy or tensor), padded with ``fill`` up to ``n_pad`` global sites
    first (default: its own width), as a contiguous tensor on the mesh's
    device."""
    x = torch.as_tensor(x)
    n_pad = x.shape[-1] if n_pad is None else n_pad
    lo, shard, _ = shard_span(mesh, x.shape[-1], n_pad)
    out = torch.full((*x.shape[:-1], shard), fill, dtype=x.dtype,
                     device=mesh.device)
    take = int(np.clip(x.shape[-1] - lo, 0, shard))
    if take:
        out[..., :take] = x[..., lo:lo + take].to(mesh.device)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the cotangent passes through unchanged (every
    rank holds the same total and seeds it itself)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """Identity on a value every rank computes alike; its cotangents,
    each from this rank's shard, are summed over the ranks: the transpose
    of JAX's replicated operands under ``shard_map``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone()), None


def all_reduce_sum(x: torch.Tensor, mesh: SiteMesh) -> torch.Tensor:
    """Differentiable sum of ``x`` over the mesh's ranks."""
    return _AllReduceSum.apply(x, mesh) if mesh.size > 1 else x


def replicated(x: torch.Tensor, mesh: SiteMesh) -> torch.Tensor:
    """``x``, with its gradient summed over the mesh's ranks."""
    return _Replicated.apply(x, mesh) if mesh.size > 1 else x


def plf_sharded(x1, x2, lc, rc, ec, wgt, n: int, *, mesh: SiteMesh,
                states: int = 4, categories: int = 4,
                block_sites: int = 1024, variant: str = "vpu"):
    """Site-sharded fused PLF: this rank's part of one PLF call.

    Args:
      x1, x2: ``(S*C, shard)`` this rank's lane-major CLV shards
        (:meth:`ShardedPLF.prepare`); the global padded width ``ranks *
        shard`` is a multiple of ``ranks * block_sites``.
      lc, rc, ec: ``(S*C, S)`` lane constants (every rank the same).
      wgt: ``(1, shard)`` int32 site weights of the shard (zero padding).
      n: global count of valid sites.
      variant: the kernel form, as :func:`.ops.plf_node.plf_node`.

    Returns:
      ``(x3, scaler, scaler_increment)``: this rank's ``(S*C, shard)``
      parent and ``(1, shard)`` int32 flags (kernel 1 or 1m on the shard,
      with ``n_local`` valid sites), and the weighted scaler increment
      over all ranks (int64, all-reduced; the same on every rank).
    """
    shard = x1.shape[-1]
    if shard % block_sites:
        raise ValueError(f"shard of {shard} sites not a multiple of "
                         f"block_sites {block_sites}")
    _, _, n_local = shard_span(mesh, n, shard * mesh.size)
    x3, sc = plf_node(x1, x2, lc, rc, ec, n_local, states=states,
                      categories=categories, variant=variant)
    inc = (sc.to(torch.int64) * wgt.to(torch.int64)).sum().reshape(1)
    return x3, sc, mesh.all_reduce(inc)[0]


class ShardedPLF:
    """Convenience wrapper owning the mesh and the layout for repeated
    sharded calls (counterpart of ``plf_tpu.parallel.ShardedPLF``): CLVs
    stay on each rank's device, lane-major, for a whole traversal; only
    the branch matrices change per call."""

    def __init__(self, mesh: Optional[SiteMesh] = None, states: int = 4,
                 categories: int = 4, block_sites: int = 1024,
                 variant: str = "vpu"):
        self.mesh = mesh or make_mesh()
        self.states = states
        self.categories = categories
        self.block_sites = block_sites
        self.variant = variant

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def padded_sites(self, n: int) -> int:
        """Global padded site count (:func:`padded_sites`)."""
        return padded_sites(self.mesh, n, self.block_sites)

    def prepare(self, clv_site_major, n: Optional[int] = None):
        """Site-major host CLV ``(n, C*S)`` -> this rank's padded
        lane-major shard ``(S*C, shard)`` on its device."""
        S, C = self.states, self.categories
        x = L.to_lane_major(np.asarray(clv_site_major, np.float32), S, C)
        n = x.shape[-1] if n is None else n
        return shard_sites(self.mesh, np.ascontiguousarray(x),
                           self.padded_sites(n))

    def prepare_weights(self, wgt, n: Optional[int] = None):
        w = np.asarray(wgt, np.int32).reshape(1, -1)
        n = w.shape[-1] if n is None else n
        return shard_sites(self.mesh, w, self.padded_sites(n))

    def constants(self, left, right, ev):
        S, C = self.states, self.categories
        dev = self.mesh.device
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                         device=dev)
        return (as_t(L.branch_to_lane_constants(np.asarray(left), S, C)),
                as_t(L.branch_to_lane_constants(np.asarray(right), S, C)),
                as_t(L.ev_to_lane_constants(np.asarray(ev), S, C)))

    def __call__(self, x1, x2, lc, rc, ec, wgt, n):
        return plf_sharded(x1, x2, lc, rc, ec, wgt, n, mesh=self.mesh,
                           states=self.states, categories=self.categories,
                           block_sites=self.block_sites,
                           variant=self.variant)
