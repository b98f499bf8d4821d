"""The port's profiling utilities (``utils/profiling.py``) on the CPU,
beside the JAX package's: ``PhaseProfiler``'s accounting and report,
``throughput_report``'s text (the same as JAX's at the same memory rate;
its default names the H100's, not a TPU's), and ``trace`` writing a
Chrome trace that holds the profiler's ranges."""

import json
import time

import pytest

torch = pytest.importorskip("torch")

from plf_tpu.utils import profiling as JP  # noqa: E402
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


@pytest.mark.parametrize("sites,seconds", [(10**9, 0.5), (12345, 1e-3)])
def test_throughput_report(sites, seconds):
    line = TP.throughput_report(sites, seconds)
    assert "of 3350 GB/s H100 HBM3 roofline" in line
    assert "v5e" not in line.lower() and "819" not in line
    # at the same memory rate the text is the JAX package's
    assert TP.throughput_report(sites, seconds, hbm_gbps=819.0) == \
        JP.throughput_report(sites, seconds)
    assert TP.throughput_report(sites, seconds, hbm_gbps=1000.0).endswith(
        "of 1000 GB/s HBM roofline")
    assert TP.H100_HBM_GBPS == 3350.0
    assert not hasattr(TP, "V5E_HBM_GBPS")


def test_trace_writes_a_chrome_trace_with_the_ranges(tmp_path):
    prof = TP.PhaseProfiler(device="cpu")
    with TP.trace(str(tmp_path / "tr"), device="cpu") as p:
        with prof.range("alrt_alternative"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.get("name") for e in json.load(
        open(tmp_path / "tr" / "trace.json"))["traceEvents"]}
    assert "alrt_alternative" in names
    assert any(k.key == "alrt_alternative" for k in p.key_averages())
