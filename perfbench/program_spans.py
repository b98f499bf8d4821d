"""The program's own spans, for the per-layer readers.

The port times its layer boundaries itself (``plf_tpu_torch/utils/
profiling.py``): each span adds its host seconds to an in-memory table,
and while a profiler records it is also a ``record_function`` range named
``plf.<span>`` in the Chrome trace, on the clock of the card's kernels.
This module reads both: :func:`span_totals` the table (set-up spans run
before the traced window opens), :func:`read_program_spans` the ranges
inside the window, on any thread, each with the part of the device's idle
gaps that it covers.  The gaps are those ``devtrace.read_trace`` counts.
Where the program has no spans (a version from before them), both come
back empty and the readers report nothing.

Beside ``program.py``, this is the benchmark's only module that imports
``plf_tpu_torch``.  Run as a script it prints a traced run's table:

    python3 perfbench/program_spans.py build/perfbench/traces/<cell>.json
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from devtrace import DEVICE_CATS, WINDOW_SPAN

__all__ = ["ProgramSpans", "span_totals", "read_program_spans",
           "of_context", "PREFIX", "TRACES"]

PREFIX = "plf."
#: where ``run.py`` writes a traced run's Chrome trace
TRACES = Path(__file__).resolve().parent.parent / "build" / "perfbench" \
    / "traces"


@dataclasses.dataclass
class ProgramSpans:
    window_s: float
    #: span -> (host seconds, calls, device-idle seconds it covers)
    by: Dict[str, Tuple[float, int, float]]
    #: device-idle seconds under the union of all the program's spans
    idle_s: float


def span_totals() -> Dict[str, Tuple[float, float, int]]:
    """The port's table, ``{span: (seconds, self_seconds, calls)}``, of
    this process; empty where the port keeps none."""
    from plf_tpu_torch.utils import profiling
    read = getattr(profiling, "span_totals", None)
    return {} if read is None else read()


def _gaps(dev: List[tuple], w0: float, w1: float) -> List[tuple]:
    """The window's stretches with no device operation, as
    ``devtrace.read_trace`` finds them (``dev`` sorted by start)."""
    gaps, edge = [], w0
    for s, e in dev:
        e = min(e, w1)
        if s > edge:
            gaps.append((edge, s))
        if e > edge:
            edge = e
    if edge < w1:
        gaps.append((edge, w1))
    return gaps


def _union(ivals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for s, e in sorted(ivals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def _covered(ivals: List[tuple], gaps: List[tuple]) -> float:
    """Length of the gaps that the union of ``ivals`` covers (both in
    microseconds; ``gaps`` sorted and disjoint)."""
    total, j = 0.0, 0
    for s, e in _union(ivals):
        while j < len(gaps) and gaps[j][1] <= s:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < e:
            total += min(e, gaps[k][1]) - max(s, gaps[k][0])
            k += 1
    return total


def read_program_spans(path) -> Optional[ProgramSpans]:
    """The program's spans inside the ``bench.window`` span of the Chrome
    trace at ``path`` (each clipped to the window), or None without the
    window."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window, dev = None, []
    spans: Dict[str, List[tuple]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
        elif cat == "user_annotation":
            if e["name"] == WINDOW_SPAN:
                window = (ts, ts + dur)
            elif e["name"].startswith(PREFIX):
                spans.setdefault(e["name"][len(PREFIX):], []).append(
                    (ts, ts + dur))
    if window is None:
        return None
    w0, w1 = window
    gaps = _gaps(sorted(d for d in dev if w0 <= d[0] < w1), w0, w1)
    by, inside = {}, []
    for name, ivals in spans.items():
        clipped = [(max(s, w0), min(e, w1)) for s, e in ivals
                   if s < w1 and e > w0]
        if clipped:
            by[name] = (sum(e - s for s, e in clipped) * 1e-6, len(clipped),
                        _covered(clipped, gaps) * 1e-6)
            inside += clipped
    return ProgramSpans(window_s=(w1 - w0) * 1e-6, by=by,
                        idle_s=_covered(inside, gaps) * 1e-6)


_read: Dict[tuple, Optional[ProgramSpans]] = {}


def of_context(ctx) -> Optional[ProgramSpans]:
    """The program's spans of the run a reader's ``ctx`` belongs to: the
    newest trace under :data:`TRACES` (``run.py`` writes its own just
    before the readers run), if its window is the one ``ctx.trace`` read.
    None where the run has no trace or the program no spans in it."""
    if ctx.trace is None or not TRACES.is_dir():
        return None
    files = sorted(TRACES.glob("*.json"), key=lambda p: p.stat().st_mtime)
    if not files:
        return None
    key = (str(files[-1]), files[-1].stat().st_mtime_ns)
    if key not in _read:
        _read[key] = read_program_spans(files[-1])
    ps = _read[key]
    if ps is None or not ps.by or ps.window_s != ctx.trace.window_s:
        return None
    return ps


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__.strip().splitlines()[-1].strip(), file=sys.stderr)
        return 2
    ps = read_program_spans(argv[0])
    if ps is None:
        print("no bench.window span in the trace", file=sys.stderr)
        return 1
    print(f"program spans: {json.dumps(ps.by, sort_keys=True)}")
    print(f"program idle {ps.idle_s:.6f} s of the {ps.window_s:.6f} s "
          f"window")
    return 0


if __name__ == "__main__":
    sys.exit(main())
