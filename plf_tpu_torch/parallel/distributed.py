"""Multi-process initialisation and the global site mesh.

Counterpart of ``plf_tpu/parallel/distributed.py``.  The JAX package
initialises ``jax.distributed`` and builds one mesh over every device of
every host.  Here a multi-card run is one process per card, started by
``torchrun`` (which sets ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``) or by the caller, who then passes the
rendezvous itself: :func:`initialize_distributed` wraps
``torch.distributed.init_process_group`` (NCCL for ranks on cards, gloo on
the CPU, unless the caller names a backend), :func:`global_site_mesh`
spans every rank, and :func:`validate_site_workload` keeps the JAX
package's fail-fast checks of the mesh against the workload.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from .sharding import SiteMesh, make_mesh

__all__ = ["initialize_distributed", "global_site_mesh",
           "validate_site_workload", "process_summary"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: Union[str, torch.device] = "cuda"
                           ) -> bool:
    """Join a multi-process run; True once a process group is up.

    ``coordinator_address``: ``"host:port"`` (a TCP rendezvous) or a URL
    (``tcp://``, ``file://``, ``env://``); None reads ``torchrun``'s
    environment (``MASTER_ADDR``), and without it the process stays alone
    (False), as does ``num_processes <= 1``.  ``backend``: "nccl" when the
    ranks compute on cards (``device``), "gloo" on the CPU, unless named.
    Already initialised: True, nothing done.
    """
    if num_processes is not None and num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        if "MASTER_ADDR" not in os.environ:
            return False
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=url, **kw)
    return True


def global_site_mesh(axis: str = "sites",
                     device: Union[str, torch.device] = "cuda") -> SiteMesh:
    """1-D site mesh over every rank of the run (one rank when no process
    group is up); each rank's shard stays on its own card, so only the
    all-reduced scalars cross between ranks."""
    return make_mesh(axis=axis, device=device)


def validate_site_workload(mesh: SiteMesh, n_sites: int, block_sites: int,
                           axis: str = "sites") -> None:
    """Fail fast on a mesh that does not fit the workload (a mismatch is
    the one failure mode a multi-process PLF job must catch up front):
    the mesh's axis, this process a member of the mesh's group (else it
    contributes no device), a positive site count, a lane multiple of 128
    for ``block_sites`` and at least 128 sites a rank."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no '{axis}' axis: {mesh.shape}")
    if mesh.rank < 0:
        rank = dist.get_rank() if dist.is_initialized() else 0
        raise ValueError(
            f"process {rank} contributes no devices to the mesh — "
            "mesh/process topology mismatch")
    ndev = mesh.shape[axis]
    if n_sites <= 0:
        raise ValueError(f"n_sites must be positive, got {n_sites}")
    if block_sites % 128:
        raise ValueError(f"block_sites {block_sites} not a lane multiple")
    sites_per_dev = -(-n_sites // ndev)
    if sites_per_dev < 128:
        raise ValueError(
            f"{n_sites} sites over {ndev} devices leaves {sites_per_dev} "
            "sites/device (< one 128-lane tile); use fewer devices")


def process_summary() -> str:
    """One-line cluster summary for logs."""
    up = dist.is_initialized()
    rank = dist.get_rank() if up else 0
    world = dist.get_world_size() if up else 1
    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = dist.get_backend() if up else "none"
    return (f"process {rank}/{world} | {local} local cards / {world} "
            f"ranks | backend={backend}")
