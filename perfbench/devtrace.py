"""What a traced run's profile says, for the per-layer readers.

The traced run holds ``torch.profiler`` (CPU and CUDA activities) over
the whole window and writes its Chrome trace to a file.  This module
reads that file: the device's operations (kernels, copies, memsets)
inside the benchmark's ``bench.window`` span, their union (busy time),
the idle gaps between them, each named by the benchmark's host span and
the innermost host operation running at the gap's middle, and the time
and calls of each kernel by name.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

__all__ = ["Trace", "read_trace", "SPAN_PREFIX", "WINDOW_SPAN"]

SPAN_PREFIX = "bench."
WINDOW_SPAN = SPAN_PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: int
    #: device seconds and calls by operation name
    by_name: Dict[str, Tuple[float, int]]
    #: idle seconds by "span/host operation"
    idle_by: Dict[str, float]

    def kernel(self, name: str) -> Tuple[float, int]:
        """Seconds and calls of the kernels whose name holds ``name`` as
        a whole word (``plf_tree_seg_kernel``, not its ``_bwd`` twin)."""
        pat = re.compile(rf"\b{re.escape(name)}\b")
        secs = calls = 0
        for k, (s, c) in self.by_name.items():
            if pat.search(k):
                secs += s
                calls += c
        return secs, calls

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.idle_by.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[_short(k), v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _short(name: str, width: int = 160) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def _innermost(starts: List[float], ivals: List[tuple], t: float):
    """Name of the interval of latest start that holds ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    depth = 0
    while i >= 0 and depth < 64:
        s, e, name = ivals[i]
        if e >= t:
            return name
        i -= 1
        depth += 1
    return None


def read_trace(path: str) -> Optional[Trace]:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = None
    spans, cpu, dev = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e["name"]))
        elif cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            if e["name"] == WINDOW_SPAN:
                window = (ts, ts + dur)
            else:
                spans.append((ts, ts + dur, e["name"][len(SPAN_PREFIX):]))
        elif cat == "cpu_op":
            cpu.append((ts, ts + dur, e["name"]))
    if window is None:
        return None
    w0, w1 = window
    dev = sorted(d for d in dev if w0 <= d[0] < w1)
    by_name: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    busy, gaps, edge = 0.0, [], w0
    for s, e, name in dev:
        by_name[name][0] += (e - s) * 1e-6
        by_name[name][1] += 1
        e = min(e, w1)
        if s > edge:
            gaps.append((edge, s))
        if e > edge:
            busy += e - max(s, edge)
            edge = e
    if edge < w1:
        gaps.append((edge, w1))
    spans.sort()
    cpu.sort()
    s_starts, c_starts = [s[0] for s in spans], [c[0] for c in cpu]
    idle_by: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        span = _innermost(s_starts, spans, mid) or "loop"
        op = _innermost(c_starts, cpu, mid)
        idle_by[span if op is None else f"{span}/{op}"] += (g1 - g0) * 1e-6
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                 device_ops=len(dev),
                 by_name={k: (v[0], v[1]) for k, v in by_name.items()},
                 idle_by=dict(idle_by))
