"""The closed loops that the traffic mixes drive, one module a loop.

A mix (``perfbench/traffic/<mix>.json``) names its loop under ``"loop"``
and gives that loop's parameters; the module ``loops/<loop>.py`` holds
all that is particular to the loop, so that a new loop is a new file and
a new mix of a loop is data alone.  Each module gives:

* ``WITH_RATES``: whether the loop calls ``tree_loglik_fn``'s function
  with the category rates as an input;
* ``WORK``: what one iteration computes, ``"vjp"`` (value and gradient)
  or ``"forward"`` (the value), for the per-layer work counters;
* ``NUMBERS``: the names of the numbers its check compares;
* ``Loop(fn, t0, shape, device, params)``: one client, closed loop (the
  next iteration starts when the last one's value has reached the host).
  ``step(span)`` runs one iteration and returns its value; ``span(name)``
  is the harness's host span, a no-op when the run is not traced.
  ``checked(seed, window_start)`` hands over, as plain host data, what
  the check compares, once the window has closed;
* ``numbers(prob, inputs, params, checked)``: the float64 reference and
  the numbers that ``perfbench/limits/<cell>.json`` holds to limits;
* ``calibrate(prob, inputs, cfg, params, control, device, points)``: the
  same numbers for the control and the planted faults (``calibrate.py``).
"""

from __future__ import annotations

import importlib

__all__ = ["load"]


def load(name: str):
    """The loop module ``loops/<name>.py``."""
    return importlib.import_module(f"loops.{name}")
