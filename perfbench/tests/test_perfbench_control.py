"""The controls and the faults come out not correct; a sound run comes
out correct.

``test_control_fails``: the control of each cell (``calibrate.readings``,
the reference in the program's place in the precision below the
configuration's, or the program's own lower path), at a size a test run
holds, against the cell's limits.  ``test_faults_fail``: the harness's
whole run on the CPU, its look for a card skipped, with the timed path
broken underneath: a step that leaves its state unchanged, half of the
sites left out and the rest's sum doubled, the value altered where it is
produced.  One chip a cell, so no exchange between chips to leave out.
"""

import pytest
import torch

import calibrate
import check
import program
import run

BENCH = run.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = dict(taxa=12, sites=8192, reference_block_sites=2048)
#: the relative alteration of the value that the controls read
ALTERED = 1e-3


def _files(cell):
    files = run.cell_files(BENCH, cell)
    cfg = run.load_json(files["config"])
    cfg.update(SMALL)
    return cfg, run.load_json(files["traffic"]), run.load_json(
        files["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    cfg, params, limits = _files(cell)
    got = calibrate.readings(cfg, params, 3, "cpu", points=3)
    for kind in ("control_numbers", "half", "altered"):
        ok, shown = check.judge(got[kind], limits)
        assert not ok, (kind, shown)


def _half(monkeypatch):
    build, fn_of = program.phylo_model, program.loglik_fn

    def phylo_model(children, lengths, model, tips, *a, **k):
        return build(children, lengths, model, tips[:, :tips.shape[1] // 2],
                     *a, **k)

    monkeypatch.setattr(program, "phylo_model", phylo_model)
    _scale(monkeypatch, fn_of, 2.0)


def _scale(monkeypatch, fn_of, factor):
    def loglik_fn(pm, with_rates):
        fn, t0 = fn_of(pm, with_rates)

        def broken(*a):
            return fn(*a) * factor

        broken.variant, broken.engine = fn.variant, fn.engine
        return broken, t0

    monkeypatch.setattr(program, "loglik_fn", loglik_fn)


def _altered(monkeypatch):
    _scale(monkeypatch, program.loglik_fn, 1.0 + ALTERED)


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


FAULTS = {"half": _half, "altered": _altered, "unchanged": _unchanged}


def _run(cell):
    res, _ = run.run_cell(cell, 17, 0.2, False, device="cpu",
                          overrides=SMALL)
    return res


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in FAULTS
    if f != "unchanged" or c.endswith("-fit")])
def test_faults_fail(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]
