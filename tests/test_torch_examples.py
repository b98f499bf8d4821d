"""The port's examples (``examples/torch_*.py``) on the CPU, at
tests/test_examples.py's small sizes, each run in-process with
``--device cpu`` (the plain versions of the kernels).

Quickstart and model selection are held against the JAX package's
examples (``examples/quickstart.py``, ``examples/model_selection.py``)
run in this process with the same arguments: both simulate the same
alignment from the same seeds, and the values each example reports are
read from the functions it calls (a recording wrapper around JAX's
``PhyloModel.log_likelihood``, ``optimize_branch_lengths`` and
``model_select``; no file of the JAX package changes): quickstart's
log-likelihoods before and after its 40 Adam steps within rel 1e-6 and
the same scaler count; model selection's ranking and selected model
equal, each candidate's fitted log-likelihood within rel 1e-5, the fitter
bar of tests/test_torch_selection.py (the fits take the same steps in
fp32 on both sides, their sums run in other orders: 1.0-2.6e-6 apart for
the fitted GTR and HKY candidates at this size).  The full inference
and codon examples run the port alone: the newick parses back over the
same taxa, and the codon fit finds omega below 1 (simulated at 0.2)."""

import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

import plf_tpu.models as J  # noqa: E402
from plf_tpu_torch.models import parse_newick  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
LL_RTOL = 1e-6
FIT_LL_RTOL = 1e-5


def _port(name, argv):
    """``examples/torch_<name>.py``'s ``main`` on the CPU."""
    main = runpy.run_path(str(REPO / "examples" / f"torch_{name}.py"))["main"]
    return main(argv + ["--device", "cpu"])


def _jax(name, argv, monkeypatch):
    """``examples/<name>.py`` as a script, in this process."""
    path = str(REPO / "examples" / f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path] + argv)
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        assert e.code in (0, None)


def _record(monkeypatch, owner, name, calls):
    """Wrap ``owner.name`` so that each call's result is appended to
    ``calls``."""
    f = getattr(owner, name)

    def wrapper(*a, **k):
        out = f(*a, **k)
        calls.append(out)
        return out
    monkeypatch.setattr(owner, name, wrapper)


def test_quickstart_matches_jax(monkeypatch, capsys):
    argv = ["--taxa", "6", "--sites", "300"]
    got = _port("quickstart", argv)
    text = capsys.readouterr().out
    assert "backend=cpu  taxa=6  sites=300" in text
    lls, opts = [], []
    _record(monkeypatch, J.PhyloModel, "log_likelihood", lls)
    _record(monkeypatch, J, "optimize_branch_lengths", opts)
    _jax("quickstart", argv, monkeypatch)
    ref = lls[0]
    assert got["log_likelihood"] == pytest.approx(ref.log_likelihood,
                                                  rel=LL_RTOL)
    assert got["scaler_total"] == ref.scaler_total
    (_, ll0, ll1), = opts
    assert got["ll0"] == pytest.approx(ll0, rel=LL_RTOL)
    assert got["ll1"] == pytest.approx(ll1, rel=LL_RTOL)
    assert np.isfinite(got["log_likelihood"]) and got["ll1"] > got["ll0"]


def test_model_selection_matches_jax(monkeypatch, capsys):
    argv = ["--taxa", "5", "--sites", "300"]
    got = _port("model_selection", argv)
    text = capsys.readouterr().out
    assert f"selected by AICc: {got.best.name}" in text
    runs = []
    _record(monkeypatch, J, "model_select", runs)
    _jax("model_selection", argv, monkeypatch)
    ref, = runs
    assert got.best.name == ref.best.name
    assert [f.name for f in got.fits] == [f.name for f in ref.fits]
    for a, b in zip(got.fits, ref.fits):
        assert a.log_likelihood == pytest.approx(b.log_likelihood,
                                                 rel=FIT_LL_RTOL), a.name
        assert a.k_params == b.k_params


def test_full_inference_runs(capsys):
    got = _port("full_inference", ["--taxa", "6", "--sites", "400",
                                   "--bootstrap", "3"])
    text = capsys.readouterr().out
    assert f"RF distance to true tree: {got['rf']}" in text
    tree = parse_newick(got["newick"])
    assert sorted(tree.leaf_names()) == sorted(got["result"].tree
                                               .leaf_names())
    assert np.isfinite(got["result"].log_likelihood)
    assert got["newick"] in text


def test_codon_dnds_runs(capsys):
    got = _port("codon_dnds", ["--taxa", "5", "--codons", "200"])
    text = capsys.readouterr().out
    assert got["omega"] < 1 and np.isfinite(got["ll"])
    assert "inference: purifying selection (omega < 1)" in text
