"""Profiling / tracing utilities.

Counterpart of ``plf_tpu/utils/profiling.py``.  It maps the reference's
tracing mechanisms (SURVEY.md §5: xrt user ranges, in-queue phase
timestamps, xrt.ini device traces) onto PyTorch and the card:

* :func:`trace` — a ``torch.profiler`` context that writes a Chrome trace
  (``trace.json`` in ``logdir``; the device_trace analogue), with the
  card's kernels when the device is CUDA,
* :class:`PhaseProfiler` — named ranges with wall-ms accounting (the
  ``xrt::profile::user_range`` analogue, host_mem.cpp:273-282): each is a
  ``torch.profiler.record_function`` range, and on a CUDA device also an
  NVTX range whose ends synchronise the card, so that its wall ms count
  the device work it enqueued,
* :func:`throughput_report` — sites/s + GB/s + roofline fraction (the
  MA/s tables, timing.h:101-151), against the memory rate the caller
  gives (default: one NVIDIA H100 SXM's HBM3, 3,350 GB/s).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Union

import torch

__all__ = ["trace", "PhaseProfiler", "throughput_report",
           "H100_HBM_GBPS", "PLF_BYTES_PER_SITE"]

#: NVIDIA H100 SXM (80 GB HBM3) memory rate, NVIDIA's data sheet.
H100_HBM_GBPS = 3350.0
PLF_BYTES_PER_SITE = 196      # 2 CLV reads + 1 write + scaler (BASELINE.md)


def _is_cuda(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def trace(logdir: str, device: Union[str, torch.device, None] = None):
    """Capture a trace: ``with trace('/tmp/trace'): run()``.

    Writes ``<logdir>/trace.json`` (Chrome trace format; open it in
    Perfetto or ``chrome://tracing``) and yields the profiler, whose
    ``key_averages()`` sums the events by name.  The card's activity is
    recorded when ``device`` is CUDA (default: when a card is present).
    On the H100 machine a session late in a long process (after an
    earlier session and the kernels' build) recorded no device activity,
    while a session in a fresh process records every launch.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = _is_cuda(device)
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class PhaseProfiler:
    """Named wall-clock ranges: ``with prof.range("plf"): ...``.

    On a CUDA ``device`` (default: when a card is present) each range
    synchronises the card at both ends, so its wall ms include the device
    work enqueued inside it, and is an NVTX range besides its
    ``record_function`` range."""

    def __init__(self, device: Union[str, torch.device, None] = None):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.cuda = _is_cuda(device)

    @contextlib.contextmanager
    def range(self, name: str):
        nvtx = (torch.cuda.nvtx.range(name) if self.cuda
                else contextlib.nullcontext())
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with nvtx, torch.profiler.record_function(name):
                yield
                if self.cuda:
                    torch.cuda.synchronize()
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{'range':24} {'calls':>6} {'total ms':>10} {'avg ms':>10}"]
        for name, tot in sorted(self.totals.items()):
            c = self.counts[name]
            lines.append(f"{name:24} {c:6d} {tot*1e3:10.2f} "
                         f"{tot*1e3/c:10.2f}")
        return "\n".join(lines)


def throughput_report(sites: int, seconds: float,
                      bytes_per_site: int = PLF_BYTES_PER_SITE,
                      hbm_gbps: float = H100_HBM_GBPS,
                      label: str = "PLF") -> str:
    """One-line sites/s + bandwidth + roofline summary against
    ``hbm_gbps`` (by default the H100's HBM3, named in the line)."""
    memory = "H100 HBM3" if hbm_gbps == H100_HBM_GBPS else "HBM"
    sps = sites / seconds
    gbs = sps * bytes_per_site / 1e9
    roof = sps / (hbm_gbps * 1e9 / bytes_per_site)
    return (f"{label}: {sps/1e9:.3f} Gsites/s | {gbs:.0f} GB/s effective | "
            f"{100*roof:.1f}% of {hbm_gbps:.0f} GB/s {memory} roofline")
