"""``python -m plf_tpu_torch`` and what it stands on, on the CPU: the
streaming executor, the native golden oracle, ``PLFConfig.from_name`` and
the timing report, each against the JAX package's counterpart."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.runtime.native import plf_golden_native as j_golden  # noqa: E402
from plf_tpu.utils import timing as JT  # noqa: E402
from plf_tpu_torch.__main__ import main, make_data  # noqa: E402
from plf_tpu_torch.config import Backend, PLFConfig  # noqa: E402
from plf_tpu_torch.reference import plf_reference  # noqa: E402
from plf_tpu_torch.runtime.executor import StreamingExecutor  # noqa: E402
from plf_tpu_torch.runtime.native import plf_golden_native  # noqa: E402
from plf_tpu_torch.utils import timing as TT  # noqa: E402


def test_cli_host_mem_equivalent(tmp_path, capsys):
    """tests/test_io.py:170-178 on the port: report, run, exact golden
    check, timing table, CSV of one row per call."""
    csv_path = str(tmp_path / "runs.csv")
    rc = main(["--device", "cpu", "--sites", "600", "--calls", "2",
               "--csv", csv_path])
    assert rc == 0
    lines = open(csv_path).read().splitlines()
    assert lines[0] == "hm_i0,msm_i0,mh_i0"
    assert len(lines) == 3
    out = capsys.readouterr().out
    assert "Test result: Passed" in out and "exact equality" in out


@pytest.mark.parametrize("argv", [
    ["--gen", "--sites", "256", "--calls", "1", "--block", "128"],
    ["20state", "--gen", "--sites", "256", "--calls", "1", "--block", "128"],
    ["--roundtrip", "--sites", "300", "--calls", "2"],
    ["plf_mem4DNAwindowComb_128x9DNAwindow8192Comb", "--sites", "300",
     "--calls", "1"],
    ["20state", "--sites", "300", "--calls", "2", "--block", "128"],
])
def test_cli_runs(argv, capsys):
    assert main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    if "--gen" in argv:
        assert "Gnode-sites/s" in out
    else:
        assert "Test result: Passed" in out
    if argv[0].startswith("plf_mem4"):
        assert re.search(r"\| instances +\| +9 \|", out)


def test_cli_infer_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["infer", "aln.fasta"])


@pytest.mark.parametrize("S", [4, 20])
def test_executor_equals_golden_exactly(S):
    """Five calls through StreamingExecutor(device="cpu") (kernel 1's or
    1m's plain version, fp32) equal the golden model bit for bit, with
    the reference's forced-underflow data (it rescues sites at S = 4;
    at S = 20 the sums outgrow it);
    run_chunked over 1,000 sites in 256-site chunks makes 4 calls and
    equals it too."""
    cfg = PLFConfig(states=S, block_sites=128)
    case = make_data(300, S, 4, seed=S)
    ex = StreamingExecutor(cfg, device="cpu")
    outs = list(ex.run(case for _ in range(5)))
    x3_ref, _, inc_ref = plf_reference(*case, states=S, categories=4)
    assert len(outs) == 5 and ex.timing.num_calls == 5
    assert inc_ref > 0 or S != 4    # the 1e-12 pattern rescues at S = 4
    for x3, inc in outs:
        assert x3.shape == (300, 4, S)
        np.testing.assert_array_equal(x3, x3_ref)
        assert inc == inc_ref
    big = make_data(1000, S, 4, seed=1)
    ex = StreamingExecutor(cfg, device="cpu", timing_mode="fenced")
    x3, inc = ex.run_chunked(*big, chunk_sites=256)
    assert ex.timing.num_calls == 4
    x3_ref, _, inc_ref = plf_reference(*big, states=S, categories=4)
    np.testing.assert_array_equal(x3, x3_ref)
    assert inc == inc_ref
    with pytest.raises(ValueError, match="timing_mode"):
        StreamingExecutor(cfg, device="cpu", timing_mode="other")


@pytest.mark.parametrize("S", [4, 20])
def test_native_golden_equals_jax_native(S):
    case = make_data(2000, S, 4, seed=3)
    wgt = (np.arange(2000) % 3 + 1).astype(np.int32)
    got = plf_golden_native(*case[:5], wgt, states=S, categories=4)
    want = j_golden(*case[:5], wgt, states=S, categories=4)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and (got[2] > 0 or S != 4)


NAMES = ["plf_mem4DNAwindowComb_128x9DNAwindow8192Comb",
         "plf_mem4DNAstream2in_128x4DNAstream",
         "plftpu_DNA_window_1inEV_pallas_inst9_blk2048",
         "plftpu_20state_window_2in_xla_inst1_blk1024",
         "plftpu_61state_stream_1inEV_reference_inst3_blk128",
         "20state", "", "128x2DNAwindow1024"]


@pytest.mark.parametrize("name", NAMES)
def test_from_name_agrees_with_jax(name):
    cfg, inst = PLFConfig.from_name(name)
    want = JCfg.from_name(name)
    assert (cfg.states, cfg.block_sites, inst) == (
        want.states, want.block_sites, want.instances)
    assert cfg.backend is {"pallas": Backend.KERNEL, "xla": Backend.TORCH,
                           "reference": Backend.REFERENCE}[
                               want.backend.value]
    back, inst2 = PLFConfig.from_name(cfg.to_name())
    assert back == cfg and inst2 == 1


def test_timing_table_text_equals_jax():
    tj, tt = JT.TimingData(), TT.TimingData()
    for rec in ((0.0, 1.5, 4.25, 5.0), (5.0, 6.0, 9.5, 10.75)):
        tj.record(*rec)
        tt.record(*rec)
    for kw in ({}, {"reference_ms": 40.0}):
        assert (TT.format_timing_table(tt, 3e6, 2000, **kw)
                == JT.format_timing_table(tj, 3e6, 2000, **kw))
    assert TT.bandwidth_MBs(0, 1) == float("inf")

