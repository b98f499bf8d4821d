"""The instance axis: ``PLFEngine.plf_batch`` as one launch of kernel 1 or
1m (``ops/plf_node.py::plf_node_batch``, ``ops/plf_mxu.py::
plf_node_mxu_batch``), here through their plain versions, against the
port's own single-node ``plf``, the golden model and the JAX package's
``plf_batch`` (its Pallas kernels in interpret mode under ``vmap``); and
the module-level ``engine.plf`` and ``reference.plf_reference_scalar``.

Tolerances: each instance equals the port's ``plf`` on it bit for bit (the
batched kernel runs the single node's arithmetic per instance), and in
"vpu" and "mxu" the golden model bit for bit, as
tests/test_torch_engine.py holds ``plf``.  Against JAX, that file's bars:
rel 5e-7 for "vpu"/"mxu" (XLA:CPU contracts JAX's products into FMAs,
``assert_clv_match(exact=False)``), 1e-4 "mxu_3x" and 2e-2 "mxu_bf16"
(their error classes); scaler flags and increments exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

from plf_tpu.config import PLFConfig as JCfg  # noqa: E402
from plf_tpu.engine import PLFEngine as JEngine  # noqa: E402
from plf_tpu.reference import plf_reference_scalar as jscalar  # noqa: E402
from plf_tpu_torch import engine as E  # noqa: E402
from plf_tpu_torch.config import Backend, PLFConfig  # noqa: E402
from plf_tpu_torch.ops import plf_mxu, plf_node  # noqa: E402
from plf_tpu_torch.reference import (plf_reference,  # noqa: E402
                                     plf_reference_scalar)
from tests.conftest import make_random_case  # noqa: E402

BLOCK = 128
RTOL = {"vpu": 5e-7, "mxu": 5e-7, "mxu_3x": 1e-4, "mxu_bf16": 2e-2}


def _stack(states, n=260, ni=3, seed=70):
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(ni):
        c = list(make_random_case(rng, n, states=states))
        c[0] = np.asarray(c[0], np.float32).copy()
        c[0][::4] *= np.float32(1e-12)      # every 4th site rescales
        c[5] = rng.integers(1, 6, size=n).astype(np.int32)
        cases.append(c)
    return [np.stack([c[k] for c in cases]) for k in range(6)]


@pytest.mark.parametrize("states,variant", [
    (4, "vpu"), (20, "vpu"), (20, "mxu"), (20, "mxu_3x"), (20, "mxu_bf16")])
def test_plf_batch_instances_equal_plf_and_jax(states, variant):
    args = _stack(states)
    cfg = dict(states=states, block_sites=BLOCK, kernel_variant=variant)
    eng = E.PLFEngine(PLFConfig(**cfg), device="cpu")
    single, mxu_single = plf_node.plf_node_batch, plf_mxu.plf_node_mxu_batch
    out = eng.plf_batch(*args)
    assert out.x3.shape == (3, 260, 4, states)
    assert out.scaler_vector.shape == (3, 260)
    assert out.scaler_increment.dtype == torch.int64
    for i in range(3):
        one = eng.plf(*(a[i] for a in args))
        assert torch.equal(out.x3[i], one.x3)
        assert torch.equal(out.scaler_vector[i], one.scaler_vector)
        assert int(out.scaler_increment[i]) == int(one.scaler_increment)
    assert int(out.scaler_increment.sum()) > 0, "the case must rescale"
    ref = JEngine(JCfg(interpret=True, **cfg)).plf_batch(*args)
    np.testing.assert_array_equal(out.scaler_vector.numpy(),
                                  np.asarray(ref.scaler_vector))
    np.testing.assert_array_equal(out.scaler_increment.numpy(),
                                  np.asarray(ref.scaler_increment))
    np.testing.assert_allclose(out.x3.numpy(), np.asarray(ref.x3),
                               rtol=RTOL[variant], atol=1e-37)
    if variant in ("vpu", "mxu"):   # the golden model's order: exact
        for i in range(3):
            x3, _, _ = plf_reference(*(a[i] for a in args), states=states)
            np.testing.assert_array_equal(out.x3[i].numpy(), x3)
    assert single.launches == mxu_single.launches == 0, \
        "CPU tensors never count launches"


def test_batched_node_wrappers_match_their_plain_versions():
    """The wrappers on CPU tensors run their plain versions: each instance
    of ``plf_node_batch`` (and of kernel 1m's, with split planes) equals
    the single-node wrapper on it; shapes and instance counts are
    checked before any launch."""
    rng = np.random.default_rng(3)
    for S, variant in ((4, "vpu"), (20, "mxu_3x")):
        rows, n = S * 4, 256
        x1, x2 = (torch.as_tensor(rng.random((2, rows, n), np.float32))
                  for _ in range(2))
        lc, rc, ec = (torch.as_tensor(rng.random((2, rows, S), np.float32))
                      for _ in range(3))
        x3, sc = plf_node.plf_node_batch(x1, x2, lc, rc, ec, 250, states=S,
                                         variant=variant)
        assert x3.shape == x1.shape and sc.shape == (2, n)
        for i in range(2):
            one, one_sc = plf_node.plf_node(x1[i], x2[i], lc[i], rc[i],
                                            ec[i], 250, states=S,
                                            variant=variant)
            assert torch.equal(x3[i], one) and torch.equal(sc[i], one_sc[0])
        with pytest.raises(ValueError, match="must be"):
            plf_node.plf_node_batch(x1, x2, lc[:1], rc, ec, 250, states=S,
                                    variant=variant)
        with pytest.raises(ValueError, match="bad"):
            plf_node.plf_node_batch(x1, x2, lc, rc, ec, n + 1, states=S,
                                    variant=variant)


@pytest.mark.parametrize("backend", [Backend.TORCH, Backend.REFERENCE])
def test_plf_batch_on_the_plain_backends(backend):
    args = _stack(4, seed=71)
    out = E.PLFEngine(PLFConfig(block_sites=BLOCK, backend=backend),
                      device="cpu").plf_batch(*args)
    for i in range(3):
        x3, sv, si = plf_reference(*(a[i] for a in args))
        np.testing.assert_array_equal(out.x3[i].numpy(), x3)
        np.testing.assert_array_equal(out.scaler_vector[i].numpy(), sv)
        assert int(out.scaler_increment[i]) == si


def test_module_level_plf_and_scalar_reference():
    """``engine.plf`` is ``PLFEngine(config, device).plf``; the scalar
    triple loop equals the vectorised golden model bit for bit, and the
    JAX package's scalar loop."""
    rng = np.random.default_rng(72)
    case = make_random_case(rng, 40)
    out = E.plf(*case, device="cpu")
    x3, sv, si = plf_reference(*case)
    np.testing.assert_array_equal(out.x3.numpy(), x3)
    assert int(out.scaler_increment) == si
    for S in (4, 5):
        c = make_random_case(rng, 24, states=S)
        got = plf_reference_scalar(*c, states=S)
        want = plf_reference(*c, states=S)
        jwant = jscalar(*c, states=S)
        for a, b, j in zip(got, want, jwant):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, j)
