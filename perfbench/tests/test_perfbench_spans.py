"""The program's spans in a traced run: on a Chrome trace built by hand,
``program_spans`` finds the ``plf.*`` ranges inside the window and the
device-idle time under them, ``devtrace`` reads the same whether they are
there or not (no existing reading moves), and the readers that take them
return the hand-computed values, or nothing where the program has no
spans."""

import json
import os

import pytest

import devtrace
import program_spans
import run
from readers import Context

def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": 1_000.0 + ts,
            "dur": dur, "pid": 1, "tid": tid}


#: two kernels in a 1,000 us window: idle [0, 100), [300, 600), [900, 1000)
BASE = [
    _x("user_annotation", "bench.window", 0, 1_000),
    _x("kernel", "k1", 100, 200, tid=7),
    _x("kernel", "k2", 600, 300, tid=7),
    _x("user_annotation", "bench.forward", 0, 450),
    _x("user_annotation", "bench.read", 450, 150),
    _x("cpu_op", "aten::add", 310, 10),
    _x("cpu_op", "aten::_local_scalar_dense", 460, 100),
]
#: the middle gap half under plf.fn and half under bench.read; a backward
#: on another thread in the last gap; a set-up span that starts before the
#: window and one after it
PROGRAM = [
    _x("user_annotation", "plf.fn", 250, 200),
    _x("user_annotation", "plf.fn.kernel", 280, 40),
    _x("user_annotation", "plf.fn.backward", 920, 60, tid=2),
    _x("user_annotation", "plf.phylo.init", -50, 100),
    _x("user_annotation", "plf.gamma.rates", 1_100, 100),
]
WANT_BY = {"fn": (200e-6, 1, 150e-6), "fn.kernel": (40e-6, 1, 20e-6),
           "fn.backward": (60e-6, 1, 60e-6),
           "phylo.init": (50e-6, 1, 50e-6)}
WANT_IDLE = 260e-6


def _write(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def _close(got, want):
    assert set(got) == set(want)
    for k, (s, n, idle) in want.items():
        assert got[k][1] == n
        assert got[k][0] == pytest.approx(s, abs=1e-12)
        assert got[k][2] == pytest.approx(idle, abs=1e-12)


def test_devtrace_reads_the_same_with_the_program_spans(tmp_path):
    plain = devtrace.read_trace(_write(tmp_path / "a.json", BASE))
    spanned = devtrace.read_trace(_write(tmp_path / "b.json",
                                         BASE + PROGRAM))
    assert plain == spanned
    assert plain.breakdown() == spanned.breakdown()
    assert plain.window_s == pytest.approx(1e-3)
    assert 1.0 - plain.busy_s / plain.window_s == pytest.approx(0.5)
    # each gap named by the benchmark's span at its middle, never plf.*
    assert plain.idle_by == pytest.approx(
        {"forward": 100e-6, "read": 300e-6, "loop": 100e-6})


def test_program_spans_hand_computed(tmp_path):
    ps = program_spans.read_program_spans(
        _write(tmp_path / "t.json", BASE + PROGRAM))
    assert ps.window_s == pytest.approx(1e-3)
    _close(ps.by, WANT_BY)
    assert ps.idle_s == pytest.approx(WANT_IDLE, abs=1e-12)
    # never more than the device's own idle time
    tr = devtrace.read_trace(tmp_path / "t.json")
    assert ps.idle_s <= tr.window_s - tr.busy_s
    none = program_spans.read_program_spans(_write(tmp_path / "p.json",
                                                   BASE))
    assert none.by == {} and none.idle_s == 0.0
    assert program_spans.read_program_spans(
        _write(tmp_path / "w.json", BASE[1:] + PROGRAM)) is None


def _ctx(path, iterations=2):
    return Context(work_kind="forward", iterations=iterations,
                   trace=devtrace.read_trace(path), spans={}, shape=None)


def test_the_trace_readers_return_them(tmp_path, monkeypatch):
    monkeypatch.setattr(program_spans, "TRACES", tmp_path)
    ctx = _ctx(_write(tmp_path / "cell.json", BASE + PROGRAM))
    idle = run.load_reader("program_idle_pct.alpha.dna48")(ctx)
    host = run.load_reader("fn_host_ms.fit.dna48")(ctx)
    assert idle == pytest.approx(100.0 * WANT_IDLE / 1e-3)
    assert host == pytest.approx(1e3 * (200e-6 + 60e-6) / 2)
    # a trace the run did not read (another window) gives nothing
    other = _write(tmp_path / "other.json",
                   [_x("user_annotation", "bench.window", 0, 2_000)]
                   + PROGRAM)
    os.utime(other, (other.stat().st_atime, other.stat().st_mtime + 10))
    assert run.load_reader("program_idle_pct")(ctx) is None


def test_readers_report_nothing_without_program_spans(tmp_path,
                                                       monkeypatch):
    """A program from before the spans (the parent's): no ``plf.*``
    range in the trace and no table, so each new reader returns None."""
    from plf_tpu_torch.utils import profiling
    monkeypatch.setattr(program_spans, "TRACES", tmp_path)
    monkeypatch.delattr(profiling, "span_totals")
    assert program_spans.span_totals() == {}
    ctx = _ctx(_write(tmp_path / "cell.json", BASE))
    for name in ("program_idle_pct", "fn_host_ms", "model_init_s",
                 "model_encode_s"):
        assert run.load_reader(name)(ctx) is None
    no_trace = Context(work_kind="forward", iterations=2, trace=None,
                       spans={}, shape=None)
    assert run.load_reader("program_idle_pct")(no_trace) is None


def test_set_up_readers_read_the_ports_table():
    from plf_tpu_torch.utils import profiling
    profiling.reset_spans()
    with profiling.span("phylo.init"):
        with profiling.span("phylo.encode"):
            pass
    tot = program_spans.span_totals()
    assert run.load_reader("model_init_s")(None) == tot["phylo.init"][0]
    assert run.load_reader("model_encode_s")(None) == tot["phylo.encode"][0]
    profiling.reset_spans()
