"""Which card a process computes on: one rule for every "cuda" without an
index.

Outside a multi-process run "cuda" is the current card.  In a run that
``parallel.initialize_distributed`` started, it is the card that call made
current and bound NCCL to (:func:`pin_card`).  In a group the caller
started with ``torch.distributed.init_process_group`` itself, it is
``LOCAL_RANK`` where ``torchrun`` set it, else the current card (the
caller's own ``set_device``).  A rank's card is its index among the ranks
on its own machine (:func:`rank_card`); NCCL takes one card a rank, so
more NCCL ranks on a machine than it has cards are refused (ValueError),
while gloo ranks share the cards (card = that index modulo the cards).
With no card at all, "cuda" raises RuntimeError.
"""

from __future__ import annotations

import json
import os
import socket
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["card_count", "check_nccl_cards", "host_ranks", "pin_card",
           "rank_card", "resolve_device"]

#: ``(world group, card)`` of the run ``initialize_distributed`` started
_pinned: Optional[Tuple[object, torch.device]] = None

_HOST_KEY = "plf_tpu_torch/host/"
_READ_KEY = "plf_tpu_torch/read/"


def card_count() -> int:
    """The cards this process sees; RuntimeError if it sees none."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("device 'cuda' asked for, but no CUDA card is "
                           "visible to this process; pass device='cpu' "
                           "(--device cpu on the command line)")
    return n


def check_nccl_cards(ranks: int, cards: int, who: str) -> None:
    """ValueError unless ``cards`` cards hold ``ranks`` NCCL ranks, one
    card a rank."""
    if ranks > cards:
        raise ValueError(
            f"{who}: {ranks} ranks asked for on 'cuda', but this machine "
            f"has {cards} card(s); NCCL takes one card a rank "
            f"(backend='gloo' shares the cards)")


def host_ranks(store, rank: int, world: int) -> Tuple[int, int]:
    """``(index of rank among the ranks on its machine, ranks on its
    machine)``, from the rendezvous ``store`` before any group starts.

    Every rank posts its host name and card count and reads all of them,
    so every rank sees one table and refuses alike: ValueError where
    another machine has more ranks than cards (this machine's own count
    is :func:`rank_card`'s to check).  Rank 0 leaves only once every rank
    has read, since it may hold a TCP store's server."""
    me = socket.gethostname()
    store.set(f"{_HOST_KEY}{rank}",
              json.dumps([me, torch.cuda.device_count()]))
    table = [json.loads(store.get(f"{_HOST_KEY}{r}")) for r in range(world)]
    store.set(f"{_READ_KEY}{rank}", "1")
    if rank == 0:
        store.wait([f"{_READ_KEY}{r}" for r in range(world)])
    hosts = {}
    for r, (host, cards) in enumerate(table):
        hosts.setdefault(host, ([], cards))[0].append(r)
    for host, (ranks, cards) in hosts.items():
        if host != me and len(ranks) > cards:
            raise ValueError(
                f"rank {rank}: {len(ranks)} ranks asked for on 'cuda' on "
                f"machine {host!r}, but it has {cards} card(s); NCCL takes "
                f"one card a rank (backend='gloo' shares the cards)")
    mine = hosts[me][0]
    return mine.index(rank), len(mine)


def rank_card(rank: int, backend: str,
              host: Optional[Tuple[int, int]] = None) -> torch.device:
    """The card of ``rank``: its index among the ranks on this machine,
    ``LOCAL_RANK`` where set, else ``host`` (:func:`host_ranks`), else the
    rank.  Under NCCL every rank of this machine needs a card of its own:
    ValueError when its ranks (``LOCAL_WORLD_SIZE``, ``host``'s count or
    this index + 1) exceed the cards, so that every rank refuses alike.
    Under any other backend the ranks share the cards: the index modulo
    the cards."""
    n = card_count()
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
        here = max(local + 1, int(os.environ.get("LOCAL_WORLD_SIZE", 0)))
    elif host is not None:
        local, here = host
    else:
        local, here = rank, rank + 1
    if str(backend) == "nccl":
        check_nccl_cards(here, n, f"rank {rank} (card {local})")
        return torch.device("cuda", local)
    return torch.device("cuda", local % n)


def pin_card(card: torch.device, group=None) -> None:
    """Record ``card`` as "cuda" for the run whose world group is
    ``group`` (``initialize_distributed`` calls this once the group is
    up); :func:`resolve_device` returns it while that group lasts."""
    global _pinned
    _pinned = (group, torch.device(card))


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``device`` with "cuda" resolved to a card index by the module's
    rule: the card ``initialize_distributed`` pinned while its group is
    up, else in a group ``LOCAL_RANK``'s card (:func:`rank_card`), else
    the current card.  A CPU device or one with an index is returned as
    it is."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    card_count()                     # RuntimeError with no card
    if dist.is_available() and dist.is_initialized():
        if _pinned is not None and _pinned[0] is dist.group.WORLD:
            return _pinned[1]
        if "LOCAL_RANK" in os.environ:
            return rank_card(dist.get_rank(), dist.get_backend())
    return torch.device("cuda", torch.cuda.current_device())
