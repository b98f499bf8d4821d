"""A cell's inputs from its configuration and the seed.

The topology is the configuration's (``tree.topology_seed``), so every
seed asks the same work of a step; the branch lengths and the alignment
come from the run's seed.  The alignment is simulated on ``device`` under
the configuration's model and Gamma rates.  Both sides get these inputs:
the program as a user's tree, model and NumPy tip states, the reference
as they are.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from reference.likelihood import Problem
from reference.simulate import simulate
from reference.substitution import Model, discrete_gamma_rates, gtr, paml

__all__ = ["Inputs", "make_inputs", "reference_model", "paml_text"]

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Inputs:
    children: List[Tuple[int, int]]
    lengths: np.ndarray          # (n_nodes,) float64
    model: Model
    rates: np.ndarray            # (C,) float64
    tips: torch.Tensor           # (n_leaves, n_sites) int8 on the device

    @property
    def t0(self) -> np.ndarray:
        """The branch lengths as ``tree_loglik_fn`` hands them back:
        float32, one a non-root node."""
        return self.lengths[:-1].astype(np.float32)

    def problem(self, block_sites: int) -> Problem:
        return Problem(self.children, self.model, self.tips, block_sites)


def paml_text(spec: dict) -> str:
    """The PAML text a ``"paml"`` model names (a path from the root of
    the checkout)."""
    return (ROOT / spec["file"]).read_text()


def reference_model(spec: dict) -> Model:
    if spec["kind"] == "gtr":
        return gtr(spec["exchangeabilities"], spec["frequencies"])
    if spec["kind"] == "paml":
        return paml(paml_text(spec))
    raise ValueError(f"unknown model kind {spec['kind']!r}")


def make_inputs(cfg: dict, seed: int, device) -> Inputs:
    from reference.tree import random_lengths, random_topology
    taxa, tree = cfg["taxa"], cfg["tree"]
    children = random_topology(taxa, tree["topology_seed"])
    lengths = random_lengths(2 * taxa - 1, seed, tree["mean_branch"])
    model = reference_model(cfg["model"])
    rates = discrete_gamma_rates(cfg["alpha"], cfg["categories"])
    tips = simulate(children, lengths, model, rates, cfg["sites"], seed,
                    device)
    return Inputs(children, lengths, model, rates, tips)
