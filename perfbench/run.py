#!/usr/bin/env python3
"""Run one benchmark cell of ``plf_tpu_torch`` once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file, ``perfbench/traffic/<traffic>.json`` (the mix: the
name of its loop, ``perfbench/loops/<loop>.py``, and the loop's
parameters), ``perfbench/limits/<cell>.json`` (the limits of the
comparison) and ``perfbench/metrics/<metric>.py`` (a reader per
per-layer metric; a qualified name such as ``mfu.fit.dna48`` falls back
to the reader of its first part, ``metrics/mfu.py``).  An end-to-end
metric is known by its first part too: ``<iteration>_ms`` (the window
over the iterations completed), ``<iteration>_p95_ms`` (the 95th
percentile of all iteration times) and ``setup_s``, where the mix names
its iteration (``step``, ``eval``).

Set-up (``setup_s``, from the start of the process to the first timed
iteration): the kernels load from the port's own cache in the checkout
(``build/plf_tpu_torch``; the first run in a checkout compiles them), the
tree and the alignment are made from the seed (the alignment simulated on
the card), ``PhyloModel`` and ``tree_loglik_fn`` are built with the
user's defaults, and the mix's first iterations run: a training loop's
first steps are the ones the reference follows.  The window then runs the
loop for ``--seconds`` seconds.  With ``--trace 1`` ``torch.profiler``
holds the window and the per-layer metrics are read from its trace;
otherwise the end-to-end metrics are printed.  Then the program's state
is freed and the float64 reference judges what the timed path produced.

Standard output ends with one JSON line (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, ``breakdown`` when traced, and last
``checks``: each number compared with its limit); standard error ends
with the same numbers.  Without the cards, or with JAX or ``plf_tpu``
loaded in this process, the run exits 2 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "perfbench"
#: top-level module names this process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "plf_tpu")


def _paths() -> None:
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # every build and kernel cache of the run at a fixed path in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(bench: dict, workload: str) -> dict:
    """The cell's entry and the files it is found by."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return dict(cell=cell, config=ROOT / cfg["file"],
                traffic=HERE / "traffic" / f"{cell['traffic']}.json",
                limits=HERE / "limits" / f"{workload}.json")


def metrics_of(bench: dict, section: str, workload: str) -> list:
    return [m for m in bench[section]
            if "workloads" not in m or workload in m["workloads"]]


def base_name(name: str) -> str:
    """A metric's name up to its first dot: what it measures, without the
    cells it is qualified by."""
    return name.split(".")[0]


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, else the reader of ``base_name(name)``."""
    own = HERE / "metrics" / f"{name}.py"
    return own if own.exists() else HERE / "metrics" / f"{base_name(name)}.py"


def load_reader(name: str):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def percentile(values, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, np.float64), q))


class Timer:
    """Marks at the start of every iteration and one after the last: on
    the card CUDA events, so that the intervals between them are read from
    the device's clock (the host is idle between iterations, so a mark is
    stamped as the host records it); elsewhere the host's clock."""

    def __init__(self, cuda: bool):
        import torch
        self.torch, self.cuda, self.marks = torch, cuda, []

    def mark(self) -> None:
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        m = self.marks
        if self.cuda:
            self.torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict = None, t_start=T0):
    """One run of ``workload``.  Returns ``(result, log)``: the result
    line's object and the earlier lines.  ``overrides`` replaces keys of
    the configuration (the CPU tests' small sizes)."""
    import numpy as np
    import torch

    import check
    import loops
    import program
    from devtrace import WINDOW_SPAN, SPAN_PREFIX, read_trace
    from inputs import make_inputs, paml_text
    from readers import Context, Shape

    bench = benchmark()
    files = cell_files(bench, workload)
    cfg = load_json(files["config"])
    cfg.update(overrides or {})
    params = load_json(files["traffic"])
    limits = load_json(files["limits"])
    mix = loops.load(params["loop"])
    cuda = device.startswith("cuda")
    log = []
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    spans = {}
    clock = [time.perf_counter()]
    spans["start"] = clock[0] - t_start

    def lap(name):
        sync()
        now = time.perf_counter()
        spans[name] = now - clock[0]
        clock[0] = now

    inputs = make_inputs(cfg, seed, device)
    lap("inputs")
    tips = inputs.tips.cpu().numpy()
    spec = cfg["model"]
    model = program.substitution_model(
        spec, paml_text(spec) if spec["kind"] == "paml" else None)
    lap("to_host")
    pm = program.phylo_model(inputs.children, inputs.lengths, model, tips,
                             cfg["alpha"], cfg["plf_config"], device)
    lap("model_build")
    fn, t0 = program.loglik_fn(pm, mix.WITH_RATES)
    lap("loglik_fn")
    if not np.array_equal(t0, inputs.t0):
        raise RuntimeError("the program's branch lengths are not the tree's")
    shape = Shape(states=pm.config.states, categories=pm.config.categories,
                  nodes=len(pm.schedule), leaves=pm.tree.n_leaves,
                  sites=pm.n_sites, tip_bytes=pm.codes.element_size(),
                  variant=fn.variant)
    loop = mix.Loop(fn, t0, shape, device, params)
    null = contextlib.nullcontext()
    for k in range(params["warmup"]):
        loop.step(lambda name: null)
        lap(f"warmup{k + 1}")
    setup_s = time.perf_counter() - t_start
    log.append(f"engine {fn.engine} variant {fn.variant}; "
               f"{shape.nodes} nodes x {shape.sites} sites, S={shape.states}"
               f" C={shape.categories}, tips {tips.dtype} -> "
               f"{pm.codes.dtype}; set-up {setup_s:.3f} s: "
               + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))
    log.append(f"launches after set-up: {json.dumps(program.launches())}")

    timer = Timer(cuda)
    values = []
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        span = lambda name: record_function(SPAN_PREFIX + name)
        prof.__enter__()
        window_span = record_function(WINDOW_SPAN)
        window_span.__enter__()
    else:
        span = lambda name: null
    w0 = time.perf_counter()
    while True:
        timer.mark()
        values.append(loop.step(span))
        if time.perf_counter() - w0 >= seconds:
            break
    timer.mark()
    w1 = time.perf_counter()
    if trace:
        window_span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    intervals = timer.intervals_ms()
    n = len(values)
    failed = sum(not math.isfinite(v) for v in values)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log.append(f"window {w1 - w0:.3f} s, {n} iterations; launches "
               f"{json.dumps(program.launches())}; peak device memory "
               f"{peak} bytes")

    noun = params["iteration"]
    measured = {"setup_s": setup_s,
                f"{noun}_ms": (w1 - w0) * 1e3 / n,
                f"{noun}_p95_ms": percentile(intervals, 95)}
    result = {"correct": False, "attempted": n, "failed": failed,
              "metrics": {}, "device": {
                  "platform": "gpu" if cuda else "cpu",
                  "kind": (torch.cuda.get_device_name(0) if cuda
                           else "cpu"),
                  "count": files["cell"]["chips"],
                  "memory_peak_bytes": int(peak)}}
    if trace:
        path = CACHE / "traces" / f"{workload}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        del prof                    # its events, before the reference
        tr = read_trace(str(path))
        log.append(f"trace {path} ({path.stat().st_size} bytes)")
        if tr is not None:
            log.append(f"trace window {tr.window_s:.3f} s, device busy "
                       f"{tr.busy_s:.3f} s, {tr.device_ops} device "
                       f"operations; most device time: "
                       + json.dumps(tr.breakdown(3)))
        ctx = Context(work_kind=mix.WORK, iterations=n, trace=tr,
                      spans=spans, shape=shape)
        for m in metrics_of(bench, "per_layer", workload):
            v = load_reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        if tr is not None:
            result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
            result["breakdown"] = tr.breakdown()
    else:
        for m in metrics_of(bench, "end_to_end", workload):
            result["metrics"][m["name"]] = {
                "value": measured[base_name(m["name"])], "unit": m["unit"]}

    # what the check compares, as host data; then the program's state
    # goes before the reference runs
    checked = loop.checked(seed, params["warmup"])
    del loop, fn, pm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    prob = inputs.problem(cfg["reference_block_sites"])
    numbers = mix.numbers(prob, inputs, params, checked)
    ok, checks = check.judge(numbers, limits)
    result["correct"] = bool(ok and failed == 0)
    result["checks"] = checks
    return result, log


def main(argv=None) -> int:
    _paths()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = benchmark()
    chips = cell_files(bench, args.workload)["cell"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); this "
              f"machine shows {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, log = run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace))
    # read after the run, so that set-up does not wait for it
    print(f"# card: {card_line()}; torch {torch.__version__} "
          f"(CUDA {torch.version.cuda})", flush=True)
    for line in log:
        print("# " + line, flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: this process loaded {bad}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
