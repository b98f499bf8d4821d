"""Profiling / tracing utilities.

Counterpart of ``plf_tpu/utils/profiling.py``.  It maps the reference's
tracing mechanisms (SURVEY.md §5: xrt user ranges, in-queue phase
timestamps, xrt.ini device traces) onto PyTorch and the card:

* :func:`trace` — a ``torch.profiler`` context that writes a Chrome trace
  (``trace.json`` in ``logdir``; the device_trace analogue), with the
  card's kernels when the device is CUDA,
* :class:`span` — the program's own spans at its layer boundaries
  (``phylo.init``, ``fn``, ``fn.backward``, ``gamma.rates``, ...).  A span
  never synchronises the card.  While a ``torch.profiler`` session
  records, it is a range named ``plf.<name>`` (as ``record_function``
  makes), on the
  same clock as the card's kernels in the Chrome trace; always, its host
  seconds, self seconds and calls are added to an in-memory table,
  :func:`span_totals` (cleared by :func:`reset_spans`),
* :class:`PhaseProfiler` — named ranges with wall-ms accounting (the
  ``xrt::profile::user_range`` analogue, host_mem.cpp:273-282): on a CUDA
  device each is an NVTX range whose ends synchronise the card, so that
  its wall ms count the device work it enqueued, and while a profiler
  records a ``record_function`` range.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Tuple, Union

import torch

__all__ = ["trace", "span", "span_totals", "reset_spans", "SPAN_PREFIX",
           "PhaseProfiler"]

#: prefix of a span's range in a profiler's trace
SPAN_PREFIX = "plf."

_profiling = torch.autograd._profiler_enabled
# The range ``record_function`` opens (a ``user_annotation`` in the trace),
# without its Python wrapper: a third of its cost while a profiler records
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit
_clock = time.perf_counter
# Each thread keeps its open spans and its own table (name -> [seconds,
# self seconds, calls]), so that a span takes no lock; the lock guards
# the list of the threads' tables.
_local = threading.local()          # .state: (open spans, table)
_tables_lock = threading.Lock()
_tables: List[Dict[str, list]] = []


def _thread_state():
    state = _local.state = ([], {})
    with _tables_lock:
        _tables.append(state[1])
    return state


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


class span:
    """``with span("fn.kernel"): ...`` — one of the program's spans.

    Host time only: the card is never synchronised, so a span holds the
    device work it enqueued only where something inside it waits for the
    card.  Self seconds are the span's seconds less those of the spans it
    holds on the same thread; each thread (the autograd engine's device
    thread runs the backward) keeps its own stack of open spans.  The
    range is made only while a profiler records: with none, a span costs
    two clock reads and a table update."""

    __slots__ = ("name", "_range", "_t0", "_inner", "_state")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = (_range_enter(SPAN_PREFIX + self.name)
                       if _profiling() else None)
        try:
            state = _local.state
        except AttributeError:
            state = _thread_state()
        self._state = state
        state[0].append(self)
        self._inner = 0.0
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        dt = _clock() - self._t0
        stack, table = self._state
        stack.pop()
        if stack:
            stack[-1]._inner += dt
        row = table.get(self.name)
        if row is None:
            table[self.name] = [dt, dt - self._inner, 1]
        else:
            row[0] += dt
            row[1] += dt - self._inner
            row[2] += 1
        if self._range is not None:
            _range_exit(self._range)
        return False


def span_totals() -> Dict[str, Tuple[float, float, int]]:
    """``{name: (seconds, self_seconds, calls)}`` of every span closed in
    this process since the last :func:`reset_spans`, summed over the
    threads."""
    out: Dict[str, list] = {}
    with _tables_lock:
        tables = [t.copy() for t in _tables]
    for table in tables:
        for name, row in table.items():
            acc = out.setdefault(name, [0.0, 0.0, 0])
            for i in range(3):
                acc[i] += row[i]
    return {k: (v[0], v[1], v[2]) for k, v in out.items()}


def reset_spans() -> None:
    """Clear the tables :func:`span_totals` reads (a span that closes on
    another thread meanwhile may be lost)."""
    with _tables_lock:
        for table in _tables:
            table.clear()


class PhaseProfiler:
    """Named wall-clock ranges: ``with prof.range("plf"): ...``.

    On a CUDA ``device`` (default: when a card is present) each range
    synchronises the card at both ends, so its wall ms include the device
    work enqueued inside it, and is an NVTX range; while a profiler
    records it is a ``record_function`` range besides."""

    def __init__(self, device: Union[str, torch.device, None] = None):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.cuda = _is_cuda(device)

    @contextlib.contextmanager
    def range(self, name: str):
        nvtx = (torch.cuda.nvtx.range(name) if self.cuda
                else contextlib.nullcontext())
        ranged = (torch.profiler.record_function(name) if _profiling()
                  else contextlib.nullcontext())
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with nvtx, ranged:
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
