"""Every cell of BENCHMARK.json resolves to its files, and the file keeps
to the benchmark's contract."""

import json
import re

import pytest

import loops
import run

BENCH = run.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    files = run.cell_files(BENCH, cell)
    cfg = run.load_json(files["config"])
    params = run.load_json(files["traffic"])
    limits = run.load_json(files["limits"])
    mix = loops.load(params["loop"])
    assert set(limits) == set(mix.NUMBERS)
    assert all(v["limit"] > 0 for v in limits.values())
    assert mix.WORK in ("vjp", "forward")
    assert isinstance(mix.WITH_RATES, bool)
    for key in ("source", "reduced", "assumed", "taxa", "sites", "model",
                "alpha", "tree", "plf_config", "control"):
        assert key in cfg, key
    assert params["loop"] in cfg["control"]
    listed = {c["name"]: c for c in BENCH["configs"]}[cfg["name"]]
    assert sorted(listed["reduced"]) == sorted(cfg["reduced"])
    assert listed["source"] == cfg["source"]
    e2e = run.metrics_of(BENCH, "end_to_end", cell)
    layer = run.metrics_of(BENCH, "per_layer", cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    # the harness measures each by its first part
    noun = params["iteration"]
    measured = {"setup_s", f"{noun}_ms", f"{noun}_p95_ms"}
    assert {run.base_name(m["name"]) for m in e2e} <= measured
    assert layer
    for m in layer:
        assert callable(run.load_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in e2e}


def test_every_reader_file_is_used():
    """No reader under ``metrics/`` that no metric reaches."""
    used = {run.reader_path(m["name"]).name for m in BENCH["per_layer"]}
    assert used == {p.name for p in (run.HERE / "metrics").glob("*.py")}


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells)) == len(cells)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(cells)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for name in names + cells:
        assert NAME.match(name)
    assert len(json.dumps(BENCH)) < 64 * 1024
