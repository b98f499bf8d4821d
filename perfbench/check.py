"""The comparison that decides ``correct``: each number that the cell's
loop (``loops/<loop>.py``: its ``numbers``) compares, held to the cell's
limit in ``perfbench/limits/<workload>.json`` (with the readings it was
set from).  The same loop functions read the controls and the planted
faults (``calibrate.py``), so those readings and the program's are one
measure.
"""

from __future__ import annotations

import math
from typing import Dict

__all__ = ["rel", "judge"]


def rel(a: float, b: float) -> float:
    """``|a - b| / |b|``; infinite where ``b`` is 0."""
    return abs(a - b) / abs(b) if b else math.inf


def judge(numbers: Dict[str, float], limits: dict):
    """``(correct, {name: {"value", "limit"}})``; a number that is not
    finite, or has no limit, fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        out[name] = {"value": value, "limit": limit}
        ok &= limit is not None and math.isfinite(value) and value <= limit
    return ok, out
