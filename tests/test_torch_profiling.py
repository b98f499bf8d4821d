"""The port's profiling utilities (``utils/profiling.py``) on the CPU,
beside the JAX package's: ``PhaseProfiler``'s accounting and report,
``trace`` writing a Chrome trace that holds the profiler's ranges, and the
program's spans: their table (seconds, self seconds, calls; one stack of
open spans a thread), no ``record_function`` range without a profiler,
and the ``plf.*`` ranges that ``PhyloModel``, ``tree_loglik_fn``'s
function and its backward, ``discrete_gamma_rates`` and the kernels'
build leave in a trace."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from plf_tpu.utils import profiling as JP  # noqa: E402
from plf_tpu_torch.models import (  # noqa: E402
    PhyloModel, discrete_gamma_rates, hky85, random_tree, tree_loglik_fn)
from plf_tpu_torch.ops import _build  # noqa: E402
from plf_tpu_torch.utils import profiling as TP  # noqa: E402
from test_torch_batch import _one_torch_thread  # noqa: E402,F401


def test_phase_profiler_accounts_ranges():
    prof = TP.PhaseProfiler(device="cpu")
    assert not prof.cuda
    for _ in range(3):
        with prof.range("plf"):
            time.sleep(0.002)
    with prof.range("search"):
        pass
    with pytest.raises(RuntimeError):
        with prof.range("fails"):
            raise RuntimeError("boom")
    assert prof.counts == {"plf": 3, "search": 1, "fails": 1}
    assert prof.totals["plf"] >= 0.006
    rep = prof.report().splitlines()
    jprof = JP.PhaseProfiler()
    jprof.totals, jprof.counts = dict(prof.totals), dict(prof.counts)
    assert rep == jprof.report().splitlines()
    assert [r.split()[0] for r in rep[1:]] == ["fails", "plf", "search"]


def test_trace_writes_a_chrome_trace_with_the_ranges(tmp_path):
    prof = TP.PhaseProfiler(device="cpu")
    with TP.trace(str(tmp_path / "tr"), device="cpu") as p:
        with prof.range("alrt_alternative"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.get("name") for e in json.load(
        open(tmp_path / "tr" / "trace.json"))["traceEvents"]}
    assert "alrt_alternative" in names
    assert any(k.key == "alrt_alternative" for k in p.key_averages())


# ------------------------------------------------------------------ spans --

def _trace_names(logdir):
    """Names of the ``plf.*`` ranges in ``logdir``'s Chrome trace."""
    events = json.load(open(logdir / "trace.json"))["traceEvents"]
    return {e["name"] for e in events
            if e.get("cat") == "user_annotation"
            and e["name"].startswith(TP.SPAN_PREFIX)}


def test_span_nesting_and_self_time():
    TP.reset_spans()
    with TP.span("outer"):
        time.sleep(0.004)
        for _ in range(2):
            with TP.span("inner"):
                time.sleep(0.003)
    with pytest.raises(ValueError):
        with TP.span("fails"):
            raise ValueError("boom")
    with TP.span("after"):          # the failed span left the stack
        pass
    tot = TP.span_totals()
    assert set(tot) == {"outer", "inner", "fails", "after"}
    (o, o_self, o_n), (i, i_self, i_n) = tot["outer"], tot["inner"]
    assert (o_n, i_n, tot["fails"][2], tot["after"][2]) == (1, 2, 1, 1)
    assert i >= 0.006 and o >= i + 0.004
    assert i_self == i
    assert o_self == pytest.approx(o - i, abs=1e-9)
    assert tot["after"][1] == tot["after"][0]


def test_span_in_a_backward_on_a_second_thread():
    """A backward that opens a span, run by autograd on another thread
    while the main thread holds a span of its own: each thread nests its
    spans on its own stack, so the main span's self time stays whole and
    the backward is the child of the second thread's span alone."""

    class Square(torch.autograd.Function):
        threads = []

        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, g):
            with TP.span("bwd"):
                Square.threads.append(threading.get_ident())
                time.sleep(0.005)
                (x,) = ctx.saved_tensors
                return 2 * x * g

    x = torch.ones(4, requires_grad=True)
    y = Square.apply(x).sum()
    TP.reset_spans()

    def run():
        with TP.span("thread"):
            y.backward()

    with TP.span("main"):
        worker = threading.Thread(target=run)
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive()
    assert Square.threads and Square.threads[0] != threading.get_ident()
    assert torch.equal(x.grad, torch.full((4,), 2.0))
    tot = TP.span_totals()
    assert tot["bwd"][2] == 1 and tot["bwd"][0] >= 0.005
    assert tot["main"][1] == tot["main"][0]
    assert tot["thread"][1] == pytest.approx(
        tot["thread"][0] - tot["bwd"][0], abs=1e-9)


def test_spans_on_many_threads_lose_no_call():
    """More threads than cores, each closing spans of shared names with a
    short switch interval: the table counts every call."""
    threads, calls = 2 * (os.cpu_count() or 2) + 2, 400
    TP.reset_spans()
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            _nested_spans() for _ in range(calls)]) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(before)
    assert not any(w.is_alive() for w in workers)
    tot = TP.span_totals()
    assert tot["shared"][2] == threads * calls
    assert tot["shared.inner"][2] == 2 * threads * calls
    assert tot["shared"][1] == pytest.approx(
        tot["shared"][0] - tot["shared.inner"][0], abs=1e-6)


def _nested_spans():
    with TP.span("shared"):
        for _ in range(2):
            with TP.span("shared.inner"):
                pass


def test_span_totals_and_reset_spans():
    TP.reset_spans()
    assert TP.span_totals() == {}
    for _ in range(3):
        with TP.span("a"):
            pass
    got = TP.span_totals()
    assert list(got) == ["a"] and got["a"][2] == 3
    assert all(isinstance(v, float) for v in got["a"][:2])
    got["a"] = (0.0, 0.0, 0)        # a copy: the table is not changed
    assert TP.span_totals()["a"][2] == 3
    TP.reset_spans()
    assert TP.span_totals() == {}


def test_no_profiler_no_record_function(monkeypatch):
    """Without a profiler recording, neither a span nor a PhaseProfiler
    range enters a record-function range (``record_function``, or the
    span's own way in to the same range); under one both do."""
    assert not torch.autograd._profiler_enabled()
    real = {"span": TP._range_enter, "range": torch.profiler.record_function}

    def refuse(name):
        raise AssertionError(f"a range {name!r} entered")

    monkeypatch.setattr(TP, "_range_enter", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    TP.reset_spans()
    with TP.span("quiet"):
        pass
    with TP.PhaseProfiler(device="cpu").range("quiet_range"):
        pass
    assert TP.span_totals()["quiet"][2] == 1
    seen = []

    def record(kind):
        def enter(name):
            seen.append(name)
            return real[kind](name)
        return enter

    monkeypatch.setattr(TP, "_range_enter", record("span"))
    monkeypatch.setattr(torch.profiler, "record_function", record("range"))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with TP.span("loud"):
            pass
        with TP.PhaseProfiler(device="cpu").range("loud_range"):
            pass
    assert seen == ["plf.loud", "loud_range"]
    assert {"plf.loud", "loud_range"} <= {e.key for e in
                                          prof.key_averages()}


@pytest.mark.parametrize("backend", ["segmented", "tree", "kernel", "torch"])
def test_model_and_function_spans_in_a_trace(backend, tmp_path):
    """A 6-taxon model, its function's forward and ``.backward()`` on the
    CPU (the kernels' plain versions) under ``torch.profiler``: the trace
    holds the model's set-up spans and the function's; the kernel
    backends split a call into operators, kernel and finalisation and
    time their backward, the plain "torch" core keeps the ``fn`` span
    alone."""
    rng = np.random.default_rng(7)
    tips = rng.integers(0, 4, size=(6, 300)).astype(np.int8)
    TP.reset_spans()
    with TP.trace(str(tmp_path), device="cpu"):
        pm = PhyloModel(random_tree(6, seed=3), hky85(2.0), tips, alpha=0.5,
                        device="cpu")
        fn, t0 = tree_loglik_fn(pm, backend=backend)
        t = torch.tensor(t0, requires_grad=True)
        fn(t).backward()
    assert fn.engine == backend
    assert torch.isfinite(t.grad).all()
    names = _trace_names(tmp_path)
    setup = {"plf.phylo.init", "plf.phylo.encode", "plf.phylo.upload",
             "plf.phylo.operators", "plf.phylo.plan", "plf.gamma.rates",
             "plf.fn.build", "plf.fn", "plf.fn.inputs"}
    split = {"plf.fn.operators", "plf.fn.kernel", "plf.fn.finalise",
             "plf.fn.backward"}
    assert setup <= names
    if backend == "torch":
        assert not names & split
    else:
        assert split <= names
    tot = TP.span_totals()
    assert tot["phylo.init"][2] == 1 and tot["phylo.operators"][2] == 2
    assert tot["fn"][2] == 1
    # the model's set-up spans sit inside phylo.init, the function's
    # inside fn
    inner = sum(tot[k][0] for k in ("phylo.encode", "phylo.upload",
                                    "phylo.operators", "phylo.plan",
                                    "gamma.rates"))
    assert tot["phylo.init"][1] == pytest.approx(
        tot["phylo.init"][0] - inner, abs=1e-9)
    parts = [k for k in ("fn.inputs", "fn.operators", "fn.kernel",
                         "fn.finalise") if k in tot]
    assert tot["fn"][1] == pytest.approx(
        tot["fn"][0] - sum(tot[k][0] for k in parts), abs=1e-9)
    assert "phylo.finalise_host" not in tot
    pm.log_likelihood()
    assert TP.span_totals()["phylo.finalise_host"][2] == 1


def test_gamma_rates_span(tmp_path):
    TP.reset_spans()
    with TP.trace(str(tmp_path), device="cpu"):
        rates = discrete_gamma_rates(0.7, 4)
    assert rates.shape == (4,) and rates.mean() == pytest.approx(1.0)
    assert "plf.gamma.rates" in _trace_names(tmp_path)
    assert TP.span_totals()["gamma.rates"][2] == 1


def test_nvcc_span_only_when_a_library_is_built(tmp_path, monkeypatch):
    """``ops.nvcc`` is entered for a batch with a missing library (here
    built by a stand-in compiler that writes its output file), not for
    one whose libraries are all built."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then shift; : > "$1"; fi\n'
                    '  shift\ndone\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    TP.reset_spans()
    _build.build_libraries(["plf_node", "plf_tree"])
    assert TP.span_totals()["ops.nvcc"][2] == 1
    assert _build._library("plf_node").exists()
    _build.build_libraries(["plf_node", "plf_tree"])
    assert TP.span_totals()["ops.nvcc"][2] == 1
