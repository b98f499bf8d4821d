"""Port ops against the JAX package: layout twins, the plain version of
kernel 1, the plain site-major PLF, and the device dispatch of the kernel
wrapper.  Inputs are made with numpy from a seed and fed to both."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch import _one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from plf_tpu.ops import layout as JL  # noqa: E402
from plf_tpu.ops.plf_pallas import plf_pallas_lane_major  # noqa: E402
from plf_tpu.ops.plf_xla import plf_xla  # noqa: E402
from plf_tpu.reference import plf_reference  # noqa: E402
from plf_tpu_torch.ops import layout as TL  # noqa: E402
from plf_tpu_torch.ops.plf_node import (plf_node, plf_node_site_major,  # noqa: E402
                                        plf_node_torch)
from plf_tpu_torch.ops.plf_torch import plf_torch  # noqa: E402
from tests.conftest import assert_clv_match, make_random_case  # noqa: E402

BLOCK = 128
SC = [(4, 4), (4, 5), (4, 1), (20, 4)]


def _lane_case(rng, n, S=4, C=4):
    """Forced-underflow case in padded lane-major form (numpy)."""
    x1, x2, left, right, ev, _ = make_random_case(rng, n, S, C)
    x1l = JL.pad_to_multiple(JL.to_lane_major(x1, S, C), BLOCK)
    x2l = JL.pad_to_multiple(JL.to_lane_major(x2, S, C), BLOCK)
    consts = (JL.branch_to_lane_constants(left, S, C),
              JL.branch_to_lane_constants(right, S, C),
              JL.ev_to_lane_constants(ev, S, C))
    return (x1, x2, left, right, ev), np.ascontiguousarray(x1l), \
        np.ascontiguousarray(x2l), consts


def _t(*arrs):
    """Fresh tensors (copies: the in-place forms must not write into the
    numpy inputs)."""
    return [torch.tensor(np.asarray(a)) for a in arrs]


# ------------------------------------------------------------ layout twins --

@pytest.mark.parametrize("S,C", SC)
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_layout_twins_bit_equal(S, C, kind):
    rng = np.random.default_rng(S * 10 + C)
    n = 300
    clv = rng.random((n, C, S), dtype=np.float32)
    branch = rng.random((C, S, S), dtype=np.float32)
    ev = rng.random((S, S), dtype=np.float32)
    wrap = (lambda a: a) if kind == "numpy" else (lambda a: _t(a)[0])
    back = np.asarray if kind == "numpy" else (lambda t: t.numpy())

    lane = JL.to_lane_major(clv, S, C)
    np.testing.assert_array_equal(back(TL.to_lane_major(wrap(clv), S, C)),
                                  lane)
    padded = JL.pad_to_multiple(lane, BLOCK)
    got = back(TL.pad_to_multiple(wrap(np.ascontiguousarray(lane)), BLOCK))
    np.testing.assert_array_equal(got, padded)
    np.testing.assert_array_equal(
        back(TL.from_lane_major(wrap(padded), S, C, n=n)),
        JL.from_lane_major(padded, S, C, n=n))
    np.testing.assert_array_equal(
        back(TL.branch_to_lane_constants(wrap(branch), S, C)),
        JL.branch_to_lane_constants(branch, S, C))
    np.testing.assert_array_equal(
        back(TL.ev_to_lane_constants(wrap(ev), S, C)),
        JL.ev_to_lane_constants(ev, S, C))


@pytest.mark.parametrize("n,block", [(1, 128), (128, 128), (129, 128),
                                     (1000, 4096), (5000, 4096)])
def test_sites_padding_matches(n, block):
    assert TL.sites_padding(n, block) == JL.sites_padding(n, block)
    assert TL.cdiv(n, block) == JL.cdiv(n, block)


# ------------------------------------------------- plain kernel 1 (CPU) --

@pytest.mark.parametrize("n", [1000 - 3, 1280])
def test_plain_node_bit_equal_to_golden(n):
    rng = np.random.default_rng(n)
    (x1, x2, left, right, ev), x1l, x2l, consts = _lane_case(rng, n)
    x3, sc = plf_node_torch(*_t(x1l, x2l, *consts), n)
    x3_ref, sv_ref, _ = plf_reference(x1, x2, left, right, ev)
    got = TL.from_lane_major(x3.numpy(), n=n)
    np.testing.assert_array_equal(got, x3_ref)
    flags = sc.numpy()[0]
    np.testing.assert_array_equal(flags[:n], sv_ref.astype(np.int32))
    assert sv_ref.sum() > 0                      # underflow really forced
    assert not flags[n:].any()                   # padding never rescales


@pytest.mark.parametrize("C", [4, 5])
@pytest.mark.parametrize("donate", [0, 1, 2])
def test_plain_node_matches_pallas_interpret(C, donate):
    """Within assert_clv_match's 5e-7 (XLA:CPU contracts FMAs); flags
    exact, padding included, also for the in-place form."""
    n = 400 - 5
    rng = np.random.default_rng(77 + C)
    _, x1l, x2l, consts = _lane_case(rng, n, 4, C)
    x3j, scj = plf_pallas_lane_major(
        jnp.asarray(x1l), jnp.asarray(x2l), *map(jnp.asarray, consts),
        jnp.int32(n), states=4, categories=C, block_sites=BLOCK,
        interpret=True, donate=donate)
    a, b, lc, rc, ec = _t(x1l, x2l, *consts)
    out = {0: None, 1: a, 2: b}[donate]
    x3t, sct = plf_node(a, b, lc, rc, ec, n, categories=C, out=out)
    if out is not None:
        assert x3t.data_ptr() == out.data_ptr()
    assert_clv_match(x3t.numpy(), np.asarray(x3j), exact=False)
    np.testing.assert_array_equal(sct.numpy(), np.asarray(scj))


def test_in_place_forms_equal_out_of_place():
    n = 700
    rng = np.random.default_rng(5)
    _, x1l, x2l, consts = _lane_case(rng, n)
    ref, sref = plf_node(*_t(x1l, x2l, *consts), n)
    for which in (0, 1):
        ts = _t(x1l, x2l, *consts)
        got, sgot = plf_node(*ts, n, out=ts[which])
        assert torch.equal(got, ref) and torch.equal(sgot, sref)
        assert torch.equal(ts[which], ref)


def test_site_major_wrapper_matches_golden():
    n = 333
    rng = np.random.default_rng(9)
    x1, x2, left, right, ev, wgt = make_random_case(rng, n)
    wgt = rng.integers(1, 5, size=n).astype(np.int32)
    x3, sv, si = plf_node_site_major(*_t(x1, x2, left, right, ev, wgt),
                                     block_sites=BLOCK)
    x3_ref, sv_ref, si_ref = plf_reference(x1, x2, left, right, ev, wgt)
    np.testing.assert_array_equal(x3.numpy(), x3_ref)
    np.testing.assert_array_equal(sv.numpy(), sv_ref)
    assert int(si) == si_ref


# ------------------------------------------------ plain site-major path --

@pytest.mark.parametrize("S,C", [(4, 4), (4, 5), (20, 4)])
def test_plf_torch_bit_equal_to_golden_and_close_to_xla(S, C):
    n = 257
    rng = np.random.default_rng(S + C)
    x1, x2, left, right, ev, wgt = make_random_case(rng, n, S, C)
    x3, sv, si = plf_torch(*_t(x1, x2, left, right, ev, wgt), states=S,
                           categories=C)
    x3_ref, sv_ref, si_ref = plf_reference(x1, x2, left, right, ev, wgt,
                                           states=S, categories=C)
    np.testing.assert_array_equal(x3.numpy(), x3_ref)
    np.testing.assert_array_equal(sv.numpy(), sv_ref)
    assert int(si) == si_ref
    x3x, svx, six = plf_xla(*map(jnp.asarray, (x1, x2, left, right, ev, wgt)),
                            states=S, categories=C)
    assert_clv_match(x3.numpy(), np.asarray(x3x), exact=False)
    np.testing.assert_array_equal(sv.numpy(), np.asarray(svx))
    assert int(si) == int(six)


# --------------------------------------------------------------- dispatch --

def test_cpu_tensors_never_count_a_launch():
    n = 256
    rng = np.random.default_rng(1)
    _, x1l, x2l, consts = _lane_case(rng, n)
    before = plf_node.launches
    plf_node(*_t(x1l, x2l, *consts), n)
    plf_node(*_t(x1l, x2l, *consts), n, out=None)
    assert plf_node.launches == before


def test_wrapper_rejects_unsupported_device_and_shapes():
    n = 128
    rng = np.random.default_rng(2)
    _, x1l, x2l, consts = _lane_case(rng, n)
    a, b, lc, rc, ec = _t(x1l, x2l, *consts)
    meta = [t.to("meta") for t in (a, b, lc, rc, ec)]
    with pytest.raises(ValueError, match="no kernel for device"):
        plf_node(*meta, n)
    with pytest.raises(ValueError):
        plf_node(a[:15], b[:15], lc, rc, ec, n)
    with pytest.raises(TypeError):
        plf_node(a.double(), b, lc, rc, ec, n)
    with pytest.raises(ValueError):
        plf_node(a, b, lc, rc, ec, n, out=torch.empty(16, 64))
    both = torch.cat([a, b])                       # x1 and x2 in one buffer
    with pytest.raises(ValueError, match="share no memory"):
        plf_node(both[:16], both[16:], lc, rc, ec, n, out=both[1:17])
