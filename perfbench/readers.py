"""What a per-layer reader (``perfbench/metrics/<name>.py``) is handed.

Each reader is a module with ``read(ctx) -> float | None``; it returns
None where its cell gives it nothing to read, and the harness then
leaves the metric out.  ``ctx`` is a :class:`Context`: what one
iteration of the cell's loop computes, the iterations of the traced
window, the trace (``devtrace.Trace``), the set-up spans, and the shapes
the work counters need.  Which cells a reader is called in is
``BENCHMARK.json``'s to say (a metric's ``workloads``).  Work is counted by
``work.py`` from the shapes, whatever kernel computes it, over the
alignment's sites (padding is the program's choice).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import work
from devtrace import Trace

__all__ = ["Context", "Shape"]


@dataclasses.dataclass
class Shape:
    states: int
    categories: int
    nodes: int                  # PLF nodes: internal nodes of the tree
    leaves: int
    sites: int
    tip_bytes: int              # bytes of one tip code as the program keeps it
    variant: str                # the arithmetic of the kernels that ran


@dataclasses.dataclass
class Context:
    work_kind: str              # one iteration: "vjp" or "forward"
    iterations: int
    trace: Optional[Trace]
    spans: Dict[str, float]
    shape: Shape

    def work(self, kind: str):
        """(flops, peak rate) of one call of the function: ``"vjp"`` the
        value and gradient (``tree_bwd_work``), ``"forward"`` the value
        (every node's ``node_work``)."""
        s = self.shape
        if kind == "vjp":
            f, rate = work.tree_bwd_work(s.states, s.categories, s.nodes,
                                         s.variant)
        else:
            f, rate = work.node_work(s.states, s.categories, s.variant)
            f *= s.nodes
        return f * s.sites, rate

    def ops_per_iteration(self) -> Optional[float]:
        if self.trace is None or not self.iterations:
            return None
        return self.trace.device_ops / self.iterations

    def idle_pct(self) -> Optional[float]:
        if self.trace is None or not self.trace.window_s:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def mfu_pct(self) -> Optional[float]:
        """An iteration's flops (its loop's ``work_kind``) over the peak
        of their arithmetic times the wall time of an iteration of the
        traced window."""
        if self.trace is None or not self.iterations:
            return None
        flops, rate = self.work(self.work_kind)
        per_iter = self.trace.window_s / self.iterations
        return 100.0 * flops / (rate * per_iter)

    def kernel_roofline_pct(self, kernel: str, kind: str) -> Optional[float]:
        """``kernel``'s bound over its device time a call: the function's
        operations (``kind``) against the tip codes read once and, for
        the forward, the site likelihoods and rescale counts written
        once (8 bytes a site), for the gradient the cotangent read once
        (4 bytes a site)."""
        if self.trace is None:
            return None
        secs, calls = self.trace.kernel(kernel)
        if not calls or secs <= 0:
            return None
        s = self.shape
        flops, rate = self.work(kind)
        per_site = s.tip_bytes * s.leaves + (8 if kind == "forward" else 4)
        bd = work.bound(per_site * s.sites, flops, rate)
        return 100.0 * bd["bound_ms"] * 1e-3 * calls / secs
