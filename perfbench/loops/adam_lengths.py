"""Branch-length optimisation as ``optimize_branch_lengths`` runs it.

Adam on log lengths (parameters ``learning_rate``, ``min_length``); a
step is the forward, ``.backward()`` and the update, ending on the value
read to the host as a convergence test reads it.

The check (a training loop): set-up drives the timed step through its
first ``CHECK_STEPS`` steps, and the float64 reference follows them from
the same lengths.  ``loss_gap``: the worst of those steps' relative gaps
of the loss.  ``grad_gap``: the gap between the norms of the first
gradient (the program's as Adam holds it after one step), over the
reference's norm.  ``change_gap``: the same for the log lengths' change
after the steps.  The lengths are one leaf.
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

from check import rel
from reference.likelihood import adam_steps

__all__ = ["WITH_RATES", "WORK", "NUMBERS", "CHECK_STEPS", "Loop",
           "numbers", "reference", "compare", "calibrate"]

WITH_RATES = False
WORK = "vjp"
NUMBERS = ("loss_gap", "grad_gap", "change_gap")
#: steps of the loop that the reference follows
CHECK_STEPS = 3
#: a relative alteration of the value where it is produced
ALTERED = 1e-3


class Loop:
    def __init__(self, fn, t0: np.ndarray, shape, device, params: dict):
        self.fn = fn
        self.min_length = params["min_length"]
        t0_dev = torch.as_tensor(t0, device=device)
        self.log_t = torch.log(torch.clamp_min(t0_dev, self.min_length)) \
            .requires_grad_()
        self.log_t0 = self.log_t.detach().clone()
        self.opt = torch.optim.Adam([self.log_t], lr=params["learning_rate"],
                                    betas=(0.9, 0.999), eps=1e-8)
        self.losses: List[float] = []
        self.g1 = None
        self.first = None

    def step(self, span: Callable) -> float:
        with span("adam"):
            self.opt.zero_grad()
        with span("forward"):
            loss = -self.fn(torch.exp(self.log_t) + self.min_length)
        with span("backward"):
            loss.backward()
        with span("adam"):
            self.opt.step()
        with span("read"):
            value = float(loss.detach())
        if not self.losses:
            # the first gradient as Adam holds it: exp_avg = (1 - b1) g
            state = self.opt.state.get(self.log_t)
            self.g1 = None if not state else (
                state["exp_avg"] / 0.1).detach().double().cpu()
        self.losses.append(value)
        if len(self.losses) == CHECK_STEPS:
            self.first = (list(self.losses), self.g1,
                          (self.log_t.detach() - self.log_t0).double().cpu())
        return value

    def checked(self, seed: int, window_start: int):
        """The first steps' losses, the first gradient and the change
        after them; None where the loop ran fewer steps."""
        return self.first


def reference(prob, inputs, params: dict, precision: str = "fp64",
              sites=None):
    """(losses, g1, change) of the reference's first steps."""
    return adam_steps(prob, inputs.t0, inputs.rates, CHECK_STEPS,
                      params["learning_rate"], params["min_length"],
                      precision, sites=sites)


def compare(got, ref) -> dict:
    """``got`` and ``ref``: (losses, g1, change) of the program (or a
    control, or a fault) and of the reference."""
    if got is None:
        return dict(loss_gap=math.inf, grad_gap=math.inf,
                    change_gap=math.inf)
    losses, g1, change = got
    r_losses, r_g1, r_change = ref
    norm = lambda v: float(torch.linalg.vector_norm(v.double().cpu()))
    return dict(
        loss_gap=max(rel(a, b) for a, b in zip(losses, r_losses)),
        # no first gradient: the optimizer holds no state after a step
        grad_gap=math.inf if g1 is None else rel(norm(g1), norm(r_g1)),
        change_gap=rel(norm(change), norm(r_change)))


def numbers(prob, inputs, params: dict, checked) -> dict:
    return compare(checked, reference(prob, inputs, params))


def calibrate(prob, inputs, cfg, params: dict, control: str, device,
              points: int) -> dict:
    """The control (the reference in ``control``'s precision) and the
    faults: half of the sites left out and the rest's sum doubled; the
    value altered by ``ALTERED``; a step that leaves its state as it was
    (a change gap of 1 by the measure, with no run)."""
    ref = reference(prob, inputs, params)
    ctl = reference(prob, inputs, params, precision=control)
    losses, g1, change = reference(prob, inputs, params,
                                   sites=prob.n_sites // 2)
    # Adam's steps do not change with the scale of the loss
    half = ([2 * x for x in losses], 2 * g1, change)
    altered = ([x * (1 + ALTERED) for x in ref[0]], ref[1], ref[2])
    return dict(control_numbers=compare(ctl, ref),
                half=compare(half, ref), altered=compare(altered, ref),
                unchanged=dict(change_gap=1.0))
