"""The Gamma-shape search as ``optimize_alpha`` runs it.

Golden-section over log alpha in ``alpha_bounds`` (``iterations`` steps,
then the search starts over); each evaluation the port's discrete-Gamma
rates on the host, handed over in float32 as ``optimize_alpha`` hands
them, the forward under ``no_grad`` and its value read.

The check (answers one by one): a sample of the window's evaluations
drawn from the seed (``check_sample`` of them) and the last one.  The
reference works out each one's rates again from its alpha (its own copy
of the discrete-Gamma rule, rounded to float32 as the program's input
is) and the float64 log-likelihood there.  ``ll_gap``: the worst
relative gap of the value.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

import program
from check import rel
from reference.likelihood import log_likelihood
from reference.substitution import discrete_gamma_rates

__all__ = ["WITH_RATES", "WORK", "NUMBERS", "Loop", "golden_section", "sample",
           "numbers", "calibrate"]

WITH_RATES = True
WORK = "forward"
NUMBERS = ("ll_gap",)
#: a relative alteration of the value where it is produced
ALTERED = 1e-3


def golden_section(lo: float, hi: float, iters: int):
    """``optimize.py``'s ``_golden_section`` (maximise over [lo, hi]) as
    a generator: it yields each point and is sent its value; after the
    final midpoint it starts over."""
    invphi = (math.sqrt(5.0) - 1.0) / 2.0
    while True:
        a, b = lo, hi
        c = b - invphi * (b - a)
        d = a + invphi * (b - a)
        fc = yield c
        fd = yield d
        for _ in range(iters):
            if fc > fd:
                b, d, fd = d, c, fc
                c = b - invphi * (b - a)
                fc = yield c
            else:
                a, c, fc = c, d, fd
                d = a + invphi * (b - a)
                fd = yield d
        yield (a + b) / 2.0


def _search(params: dict):
    lo, hi = params["alpha_bounds"]
    return golden_section(math.log(lo), math.log(hi), params["iterations"])


class Loop:
    def __init__(self, fn, t0: np.ndarray, shape, device, params: dict):
        self.fn = fn
        self.t0 = t0
        self.categories = shape.categories
        self.k = params["check_sample"]
        self.search = _search(params)
        self.point = next(self.search)
        #: every evaluation's alpha and value
        self.evaluations: List[Tuple[float, float]] = []

    def step(self, span: Callable) -> float:
        alpha = math.exp(self.point)
        with span("rates"):
            rates = np.asarray(program.gamma_rates(alpha, self.categories),
                               np.float32)
        with span("forward"), torch.no_grad():
            ll = self.fn(self.t0, rates)
        with span("read"):
            value = float(ll)
        self.evaluations.append((alpha, value))
        self.point = self.search.send(value)
        return value

    def checked(self, seed: int, window_start: int):
        return [self.evaluations[i] for i in
                sample(len(self.evaluations) - window_start, window_start,
                       self.k, seed)]


def sample(n_window: int, n_before: int, k: int, seed: int) -> List[int]:
    """Indices into the evaluations: ``k`` of the window's drawn from the
    seed, and the last."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(n_window, size=min(k, n_window), replace=False)
    return sorted({n_before + int(i) for i in pick}
                  | {n_before + n_window - 1})


def reference_rates(alpha: float, categories: int) -> np.ndarray:
    """The rates the program is handed at ``alpha``, worked out by the
    reference: the discrete-Gamma rule, rounded to float32."""
    return discrete_gamma_rates(alpha, categories).astype(np.float32)


def compare(prob, t0: np.ndarray, evaluations: Sequence,
            categories: int) -> dict:
    """``evaluations``: (alpha, value) pairs to judge."""
    dev = prob.tips.device
    t = torch.as_tensor(t0, dtype=torch.float64, device=dev)
    gap = 0.0
    for alpha, value in evaluations:
        r = torch.as_tensor(reference_rates(alpha, categories)
                            .astype(np.float64), device=dev)
        ref, _ = log_likelihood(prob, t, r)
        gap = max(gap, rel(value, ref) if math.isfinite(value)
                  else math.inf)
    return dict(ll_gap=gap)


def numbers(prob, inputs, params: dict, checked) -> dict:
    return compare(prob, inputs.t0, checked, len(inputs.rates))


def calibrate(prob, inputs, cfg, params: dict, control: str, device,
              points: int) -> dict:
    """The control at the search's first ``points`` evaluations: the
    reference in ``control``'s precision, or, for ``"program:<variant>"``,
    the program's own forward with ``kernel_variant=<variant>``
    (``PhyloModel.log_likelihood()`` at the same rates); and the faults:
    half of the sites left out and the rest's sum doubled, the value
    altered by ``ALTERED``."""
    C = len(inputs.rates)
    t0 = torch.as_tensor(inputs.t0, dtype=torch.float64, device=device)
    search = _search(params)
    point = next(search)
    ctl_ev, half_ev, alt_ev = [], [], []
    for _ in range(points):
        alpha = float(np.exp(point))
        rates = reference_rates(alpha, C)
        r = torch.as_tensor(rates.astype(np.float64), device=device)
        ref, _ = log_likelihood(prob, t0, r)
        if control.startswith("program:"):
            ctl = _program_value(inputs, cfg, control.split(":")[1], rates)
        else:
            ctl, _ = log_likelihood(prob, t0, r, control)
        half, _ = log_likelihood(prob, t0, r, sites=prob.n_sites // 2)
        ctl_ev.append((alpha, ctl))
        half_ev.append((alpha, 2 * half))
        alt_ev.append((alpha, ref * (1 + ALTERED)))
        point = search.send(ref)
    return dict(control_numbers=compare(prob, inputs.t0, ctl_ev, C),
                half=compare(prob, inputs.t0, half_ev, C),
                altered=compare(prob, inputs.t0, alt_ev, C))


def _program_value(inputs, cfg, variant: str, rates) -> float:
    """``PhyloModel.log_likelihood()`` with ``kernel_variant=variant`` at
    explicit category ``rates``."""
    from inputs import paml_text
    spec = cfg["model"]
    model = program.substitution_model(
        spec, paml_text(spec) if spec["kind"] == "paml" else None)
    pm = program.phylo_model(inputs.children, inputs.lengths, model,
                             inputs.tips.cpu().numpy(), None,
                             {"kernel_variant": variant}, inputs.tips.device,
                             rates=np.asarray(rates, np.float64))
    return pm.log_likelihood().log_likelihood
