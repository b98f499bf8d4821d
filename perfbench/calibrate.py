#!/usr/bin/env python3
"""Readings that a cell's limits are set from, other than the program's.

    python3 perfbench/calibrate.py --workload <name> --seeds 11 12 13

For each seed, at the cell's own size and with the cell's inputs, this
prints one JSON line with the numbers ``check.py`` compares for

* ``control``: the reference put in the program's place, computed in the
  precision below the configuration's (``"control"`` in its file, by
  loop: TF32 operands for the float32 "vpu" arithmetic, bfloat16 operands
  for the bf16x3 matrix forms), or, where the program has such a path of
  its own (``"program:<kernel_variant>"``), the program with that path
  switched on, against the float64 reference;
* ``half``: half of the sites left out and the sum over the rest doubled,
  the mean taken over the rest (the reference in the program's place);
* ``altered``: the value altered by a relative 1e-3 where it is produced;
* ``unchanged`` (training loops): a step that leaves its state as it was
  reads a change gap of 1 by the measure, with no run.

Each loop module says how (``loops/<loop>.py``: ``calibrate``).

The program's own readings come from the harness's runs (each prints its
``checks``).  The benchmark's runs never run this; on the card it runs at
the cells' sizes, and ``tests/test_perfbench_control.py`` runs it small
on the CPU.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402  (sets the paths and caches)


def readings(cfg: dict, params: dict, seed: int, device,
             points: int = 7) -> dict:
    """The control's and the faults' numbers for one seed, by the cell's
    loop (``loops/<loop>.py``: ``calibrate``)."""
    import loops
    from inputs import make_inputs

    control = cfg["control"][params["loop"]]
    inp = make_inputs(cfg, seed, device)
    prob = inp.problem(cfg["reference_block_sites"])
    out = dict(seed=seed, control=control)
    out.update(loops.load(params["loop"]).calibrate(
        prob, inp, cfg, params, control, device, points))
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    run._paths()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--points", type=int, default=7,
                    help="evaluations of the Gamma-shape search to judge")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    files = run.cell_files(run.benchmark(), args.workload)
    cfg = run.load_json(files["config"])
    params = run.load_json(files["traffic"])
    for seed in args.seeds:
        t = time.perf_counter()
        out = dict(workload=args.workload,
                   **readings(cfg, params, seed, "cuda", args.points))
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
