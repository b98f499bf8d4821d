"""Which card a process computes on: one rule for every "cuda" without an
index.

In a multi-process run (a ``torch.distributed`` group that is up, or that
``parallel.initialize_distributed`` is setting up) each rank computes on
its own card: ``LOCAL_RANK`` where ``torchrun`` set it, else its rank.
NCCL takes one card a rank, so a rank whose card the machine does not have
is refused (ValueError); gloo ranks share the cards (card = that index
modulo the cards).  Outside such a run "cuda" is the current card.  With
no card at all, "cuda" raises RuntimeError.
"""

from __future__ import annotations

import os
from typing import Union

import torch
import torch.distributed as dist

__all__ = ["card_count", "check_nccl_cards", "rank_card", "resolve_device"]


def card_count() -> int:
    """The cards this process sees; RuntimeError if it sees none."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("device 'cuda' asked for, but no CUDA card is "
                           "visible to this process; pass device='cpu'")
    return n


def check_nccl_cards(ranks: int, cards: int, who: str) -> None:
    """ValueError unless ``cards`` cards hold ``ranks`` NCCL ranks, one
    card a rank."""
    if ranks > cards:
        raise ValueError(
            f"{who}: {ranks} ranks asked for on 'cuda', but this machine "
            f"has {cards} card(s); NCCL takes one card a rank "
            f"(backend='gloo' shares the cards)")


def rank_card(rank: int, backend: str) -> torch.device:
    """The card of ``rank``: index ``LOCAL_RANK`` if set, else ``rank``.
    Under NCCL every rank of this machine needs a card of its own:
    ValueError when ``LOCAL_WORLD_SIZE`` (or this index + 1) exceeds the
    cards, so that every rank refuses alike.  Under any other backend the
    ranks share the cards: the index modulo the cards."""
    n = card_count()
    local = int(os.environ.get("LOCAL_RANK", rank))
    if str(backend) == "nccl":
        here = max(local + 1, int(os.environ.get("LOCAL_WORLD_SIZE", 0)))
        check_nccl_cards(here, n, f"rank {rank} (card {local})")
        return torch.device("cuda", local)
    return torch.device("cuda", local % n)


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``device`` with "cuda" resolved to a card index: in a run whose
    process group is up the rank's card (:func:`rank_card`), else the
    current card.  A CPU device or one with an index is returned as it
    is."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if dist.is_available() and dist.is_initialized():
        return rank_card(dist.get_rank(), dist.get_backend())
    card_count()                     # RuntimeError with no card
    return torch.device("cuda", torch.cuda.current_device())
