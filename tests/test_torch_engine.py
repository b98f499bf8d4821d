"""The port's PLFEngine and config against the JAX package's, the kernel
build, and the guards: no JAX in the port, no CPU run of chip_smoke.py."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

from plf_tpu.config import Backend as JBackend  # noqa: E402
from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.engine import PLFEngine as JEngine  # noqa: E402
from plf_tpu.reference import plf_reference  # noqa: E402
from plf_tpu_torch.config import Backend, PLFConfig  # noqa: E402
from plf_tpu_torch.engine import PLFEngine  # noqa: E402
from plf_tpu_torch.ops import _build  # noqa: E402
from tests.conftest import assert_clv_match, make_random_case  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
BLOCK = 128


def _case(n, seed, weights=False, categories=4):
    rng = np.random.default_rng(seed)
    x1, x2, left, right, ev, wgt = make_random_case(rng, n,
                                                    categories=categories)
    if weights:
        wgt = rng.integers(1, 6, size=n).astype(np.int32)
    return x1, x2, left, right, ev, wgt


# ------------------------------------------------------------------ engine --

@pytest.mark.parametrize("backend", [Backend.KERNEL, Backend.TORCH,
                                     Backend.REFERENCE])
@pytest.mark.parametrize("categories", [4, 5])
def test_engine_bit_equal_to_golden(backend, categories):
    x1, x2, left, right, ev, wgt = _case(501, 3, weights=True,
                                         categories=categories)
    eng = PLFEngine(PLFConfig(block_sites=BLOCK, backend=backend,
                              categories=categories), device="cpu")
    out = eng.plf(x1, x2, left, right, ev, wgt)
    x3_ref, sv_ref, si_ref = plf_reference(x1, x2, left, right, ev, wgt,
                                           categories=categories)
    np.testing.assert_array_equal(out.x3.numpy(), x3_ref)
    np.testing.assert_array_equal(out.scaler_vector.numpy(), sv_ref)
    assert int(out.scaler_increment) == si_ref > 0
    ok, n_err, msgs = eng.verify(out, x1, x2, left, right, ev, wgt)
    assert ok and n_err == 0 and msgs == []


def test_engine_matches_jax_engine_interpret():
    x1, x2, left, right, ev, wgt = _case(300, 4)
    ref = JEngine(JCfg(block_sites=BLOCK, interpret=True)).plf(
        x1, x2, left, right, ev, wgt)
    out = PLFEngine(PLFConfig(block_sites=BLOCK), device="cpu").plf(
        x1, x2, left, right, ev, wgt)
    assert_clv_match(out.x3.numpy(), np.asarray(ref.x3), exact=False)
    np.testing.assert_array_equal(out.scaler_vector.numpy(),
                                  np.asarray(ref.scaler_vector))
    assert int(out.scaler_increment) == int(ref.scaler_increment)


def test_verify_counts_errors():
    x1, x2, left, right, ev, wgt = _case(200, 5)
    eng = PLFEngine(PLFConfig(block_sites=BLOCK), device="cpu")
    out = eng.plf(x1, x2, left, right, ev)
    out.x3[3, 1, 2] += 1.0
    out.scaler_increment += 1
    ok, n_err, msgs = eng.verify(out, x1, x2, left, right, ev)
    assert not ok and n_err == 2
    assert "alignment 3, probability 6" in msgs[0]
    assert "scalerIncrement" in msgs[1]


def test_plf_batch_matches_golden_and_jax():
    ni, n = 3, 260
    cases = [_case(n, 10 + i, weights=True) for i in range(ni)]
    stack = [np.stack([c[k] for c in cases]) for k in range(6)]
    out = PLFEngine(PLFConfig(block_sites=BLOCK), device="cpu").plf_batch(
        *stack)
    assert out.x3.shape == (ni, n, 4, 4)
    for i, c in enumerate(cases):
        x3_ref, sv_ref, si_ref = plf_reference(*c)
        np.testing.assert_array_equal(out.x3[i].numpy(), x3_ref)
        np.testing.assert_array_equal(out.scaler_vector[i].numpy(), sv_ref)
        assert int(out.scaler_increment[i]) == si_ref
    ref = JEngine(JCfg(block_sites=BLOCK, backend=JBackend.XLA)).plf_batch(
        *stack)
    assert_clv_match(out.x3.numpy(), np.asarray(ref.x3), exact=False)
    np.testing.assert_array_equal(out.scaler_increment.numpy(),
                                  np.asarray(ref.scaler_increment))


@pytest.mark.parametrize("n", [1000, 4096, 100_000])
def test_geometry_matches_jax(n):
    for block in (128, 4096):
        eng = PLFEngine(PLFConfig(block_sites=block), device="cpu")
        got = eng.geometry(n, 3)
        ref = JEngine(JCfg(block_sites=block)).geometry(n, 3)
        assert got == ref
        got = eng.geometry(n, 3, 9)
        ref = JEngine(JCfg(block_sites=block, instances=9)).geometry(n, 3)
        assert got == ref
    text = PLFEngine(PLFConfig(), device="cpu").describe(n)
    assert "padded sites" in text and str(n) in text


def test_unported_engine_settings_raise():
    """Every setting that once raised now runs.  bf16 CLV storage (kernel
    1's plain version here): a bf16 x3, the bf16 rounding of the golden
    model's x3 on the bf16-rounded inputs, and its flags.  Every kernel
    variant (the MXU forms through kernel 1m's plain version), "mxu"
    bit-equal to the golden model."""
    x1, x2, left, right, ev, _ = _case(128, 6)
    out = PLFEngine(PLFConfig(dtype="bfloat16"), device="cpu").plf(
        x1, x2, left, right, ev)
    r16 = lambda a: torch.as_tensor(a).to(torch.bfloat16)
    x3_16, sv_16, _ = plf_reference(r16(x1).float().numpy(),
                                    r16(x2).float().numpy(), left, right, ev)
    assert out.x3.dtype == torch.bfloat16
    assert torch.equal(out.x3, r16(x3_16))
    np.testing.assert_array_equal(out.scaler_vector.numpy(), sv_16)
    x3_ref, sv_ref, _ = plf_reference(x1, x2, left, right, ev)
    for variant in ("mxu", "mxu_3x", "mxu_bf16"):
        out = PLFEngine(PLFConfig(kernel_variant=variant),
                        device="cpu").plf(x1, x2, left, right, ev)
        np.testing.assert_array_equal(out.scaler_vector.numpy(), sv_ref)
        rtol = {"mxu": 0.0, "mxu_3x": 1e-4, "mxu_bf16": 2e-2}[variant]
        np.testing.assert_allclose(out.x3.numpy(), x3_ref, rtol=rtol,
                                   atol=0)


# ------------------------------------------------------------------ config --

def test_config_matches_jax():
    for states in (4, 8, 20):
        for variant in ("auto", "vpu", "mxu_3x"):
            assert PLFConfig(states=states, kernel_variant=variant) \
                .resolved_kernel_variant == JCfg(
                    states=states, kernel_variant=variant) \
                .resolved_kernel_variant
    for bad in (dict(block_sites=100), dict(states=1), dict(categories=0),
                dict(dtype="float16"), dict(tip_dtype="int16"),
                dict(kernel_variant="x")):
        with pytest.raises(ValueError):
            PLFConfig(**bad)
        with pytest.raises(ValueError):
            JCfg(**bad)
    cfg, ref = PLFConfig(block_sites=256), JCfg(block_sites=256)
    assert cfg.to_name() == ref.to_name().replace("plftpu", "plftorch") \
        .replace("_pallas_", "_kernel_").replace("_inst1_", "_")
    assert cfg.rows == ref.rows == cfg.elements_per_site == 16


# ------------------------------------------------------------------- build --

def test_build_flags_keep_golden_arithmetic():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "-fmad=false" in flags and "sm_90a" in flags
    assert "fast_math" not in flags and "ftz=true" not in flags
    assert _build.BUILD_DIR == REPO / "build" / "plf_tpu_torch"
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "plf_node.cu", "plf_tree.cu", "plf_node_bwd.cu", "plf_tree_bwd.cu",
        "plf_node_mxu.cu", "plf_tree_mxu.cu", "plf_tree_bwd_mxu.cu",
        "plf_tree_seg.cu", "plf_tree_seg_bwd.cu", "plf_tree_seg_mxu.cu",
        "plf_tree_seg_bwd_mxu.cu", "plf_gen.cu", "plf_node_bwd_mxu.cu"}


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed to build plf_node"):
        _build.load_library("plf_node")
    assert not list(tmp_path.glob("*.so"))


def test_build_hash_follows_sources(tmp_path, monkeypatch):
    for p in _build.CSRC.iterdir():
        shutil.copy(p, tmp_path / p.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._digest("plf_tree")
    (tmp_path / "plf_common.cuh").write_text(
        (tmp_path / "plf_common.cuh").read_text() + "\n// edited\n")
    assert _build._digest("plf_tree") != before


def test_bf16_storage_builds_a_library_of_its_own(tmp_path, monkeypatch):
    """A kernel's bf16 storage form is its source built with
    -DPLF_BF16_STORAGE into a second library, hashed apart from the float
    one; the float library's command is the one it had before."""
    assert _build.storage_library("plf_tree_seg", False) == "plf_tree_seg"
    name = _build.storage_library("plf_tree_seg", True)
    assert _build._source(name) == (_build.CSRC / "plf_tree_seg.cu",
                                    ("-DPLF_BF16_STORAGE",))
    assert _build._source("plf_tree_seg") == (_build.CSRC / "plf_tree_seg.cu",
                                              ())
    assert _build._digest(name) != _build._digest("plf_tree_seg")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed to build "
                       "plf_tree_seg_bf16") as err:
        _build.build_libraries([name])
    assert "-DPLF_BF16_STORAGE" in str(err.value)
    assert str(_build.CSRC / "plf_tree_seg.cu") in str(err.value)
    assert not [p for p in tmp_path.iterdir() if p.suffix != ".log"]


# ------------------------------------------------------------------ guards --

def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import plf_tpu_torch, plf_tpu_torch.engine, "
            "plf_tpu_torch.convert, plf_tpu_torch.models\n"
            "import plf_tpu_torch.ops.plf_node, plf_tpu_torch.ops.plf_tree, "
            "plf_tpu_torch.ops.plf_torch, plf_tpu_torch.ops._build\n"
            "import plf_tpu_torch.ops.plf_grad, plf_tpu_torch.ops.plf_tree_grad, "
            "plf_tpu_torch.models.optimize, plf_tpu_torch.ops.plf_mxu\n"
            "import plf_tpu_torch.__main__, plf_tpu_torch.runtime, "
            "plf_tpu_torch.runtime.executor, plf_tpu_torch.runtime.native, "
            "plf_tpu_torch.utils.timing\n"
            "import plf_tpu_torch.models.selection, "
            "plf_tpu_torch.models.support, plf_tpu_torch.models.ancestral, "
            "plf_tpu_torch.models.partition, plf_tpu_torch.io.streams, "
            "plf_tpu_torch.io.fixtures, plf_tpu_torch.utils.profiling\n"
            "import plf_tpu_torch.parallel, plf_tpu_torch.parallel.sharding, "
            "plf_tpu_torch.parallel.distributed\n"
            "bad = [m for m in sys.modules if m in ('jax', 'optax', "
            "'plf_tpu') or m.startswith(('jax.', 'optax.', 'plf_tpu.'))]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    res = _run(["-c", code], REPO)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_off_the_card(where, tmp_path):
    """No result without a CUDA device, nor in a directory that holds
    chip_smoke.py and nothing else of the repo."""
    if where == "checkout":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: chip_smoke.py would run")
        script, cwd = REPO / "chip_smoke.py", REPO
    else:
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
        shutil.copy(REPO / "chip_smoke.py", script)
    res = _run([str(script)], cwd)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
