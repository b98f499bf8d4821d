"""The port's PLIO stream codec and fixture loader (``io/streams.py``,
``io/fixtures.py``, numpy copies) against the JAX package's, bit for bit:
every encoder's streams and every decoder's arrays are equal, and each
round trip gives back its inputs.  The fixture loader reads beat files
that the port's encoder wrote; the reference's own fixture files are on
no machine this runs on, so the tests that read them skip, as the JAX
package's do."""

import numpy as np
import pytest

pytest.importorskip("torch")

from plf_tpu.io import fixtures as JF  # noqa: E402
from plf_tpu.io import streams as JS  # noqa: E402
from plf_tpu_torch.__main__ import make_data  # noqa: E402
from plf_tpu_torch.io import fixtures as TF  # noqa: E402
from plf_tpu_torch.io import streams as TS  # noqa: E402


def _case(n, seed):
    x1, x2, left, right, ev, _ = make_data(n, 4, 4, seed=seed)
    return ev, left, right, x1, x2


def _equal(a, b):
    """Streams dicts, lists or tuples of arrays, equal bit for bit."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and a.shape == b.shape
        assert a.tobytes() == np.asarray(b).tobytes()
    else:
        assert a == b


CODECS = [("window", "combined"), ("window", "separate"),
          ("stream", "combined"), ("stream", "separate")]


@pytest.mark.parametrize("n", [64, 65, 70, 128])
@pytest.mark.parametrize("mode,layout", CODECS)
def test_codec_equals_jax_and_round_trips(mode, layout, n):
    case = _case(n, seed=50 + n)
    enc = getattr(TS, f"encode_{mode}_lanes")
    dec = getattr(TS, f"decode_{mode}_lanes")
    lanes = enc(*case, layout=layout)
    _equal(lanes, getattr(JS, f"encode_{mode}_lanes")(*case,
                                                      layout=layout))
    if mode == "window":
        back = dec(lanes, n_sites=n, layout=layout)
        _equal(back, JS.decode_window_lanes(lanes, n_sites=n,
                                            layout=layout))
        _equal(dec(lanes, layout=layout),
               JS.decode_window_lanes(lanes, layout=layout))
    else:
        back = dec(lanes, layout=layout)
        _equal(back, JS.decode_stream_lanes(lanes, layout=layout))
        assert back[5] == n + (n & 1)
        back = back[:5]
    for got, want in zip(back, case):
        np.testing.assert_array_equal(got[:n], want)


@pytest.mark.parametrize("n", [64, 70])
def test_window1in_and_output_codecs_equal_jax(n):
    case = _case(n, seed=60 + n)
    lanes = TS.encode_window1in_lanes(*case)
    _equal(lanes, JS.encode_window1in_lanes(*case))
    back = TS.decode_window1in_lanes(lanes, n_sites=n)
    _equal(back, JS.decode_window1in_lanes(lanes, n_sites=n))
    for got, want in zip(back, case):
        np.testing.assert_array_equal(got, want)
    x3 = case[3] * np.float32(0.5)
    streams = TS.encode_output_lanes(x3)
    _equal(streams, JS.encode_output_lanes(x3))
    assert all(s.shape == (-(-n // 64) * 64, 4) for s in streams)
    out = TS.decode_output_lanes(streams, n_sites=n)
    _equal(out, JS.decode_output_lanes(streams, n_sites=n))
    np.testing.assert_array_equal(out, x3)


def test_bad_layout_raises_as_jax():
    case = _case(8, seed=1)
    for mod in (TS, JS):
        with pytest.raises(ValueError, match="layout must be"):
            mod.encode_window_lanes(*case, layout="interleaved")


def _write_beats(path, beats):
    with open(path, "w") as f:
        for row in beats:
            f.write(" ".join(repr(float(v)) for v in row) + "\n\n")


def test_load_beats_and_assemble_equal_jax(tmp_path):
    """Beat files written from the port's window encoding of one 64-site
    window (the fixtures' shape: one header, then the data beats) read
    back through both loaders equal, and ``_assemble`` rebuilds the
    inputs."""
    n = 64
    ev, left, right, x1, x2 = _case(n, seed=7)
    lanes = TS.encode_window_lanes(ev, left, right, x1, x2)
    golden = TS.encode_output_lanes(x1 * x2)
    beats = {}
    for c in range(4):
        for name, arr in ((f"inputcombinedevleft{c}.txt",
                           lanes["left"][c]),
                          (f"inputcombinedevright{c}.txt",
                           lanes["right"][c]),
                          (f"golden{c}.txt", golden[c])):
            _write_beats(tmp_path / name, arr)
            beats[name] = TF.load_beats(str(tmp_path / name))
            _equal(beats[name], JF.load_beats(str(tmp_path / name)))
            np.testing.assert_array_equal(beats[name], arr)
    assert TF.reference_fixtures_available(str(tmp_path))
    assert not TF.reference_fixtures_available(str(tmp_path / "none"))
    lane_ev = [lanes["left"][0][0:2], lanes["right"][0][0:2]]
    lane_branch = [b[2:6] for b in lanes["left"]]
    lane_data = [b[6:] for b in lanes["left"]]
    gold = [beats[f"golden{c}.txt"] for c in range(4)]
    got = TF._assemble(lane_ev, lane_branch, lane_data, gold)
    _equal(got, JF._assemble(lane_ev, lane_branch, lane_data, gold))
    ev2, left2, x1b, gx3 = got
    np.testing.assert_array_equal(ev2, ev)
    np.testing.assert_array_equal(left2, left)
    np.testing.assert_array_equal(x1b, x1)
    np.testing.assert_array_equal(gx3, x1 * x2)
    # the whole window-vector loader on those files
    v = TF.load_window_vectors(str(tmp_path))
    np.testing.assert_array_equal(v.right, right)
    np.testing.assert_array_equal(v.x2, x2)
    assert v.n_sites == n


needs_fixtures = pytest.mark.skipif(
    not TF.reference_fixtures_available(),
    reason="reference aie/data fixtures not mounted")


@needs_fixtures
@pytest.mark.parametrize("loader", ["load_window_vectors",
                                    "load_separate_vectors",
                                    "load_stream_vectors"])
def test_reference_fixtures_load_as_jax(loader):
    got = getattr(TF, loader)()
    want = getattr(JF, loader)(TF.REFERENCE_DATA_DIR)
    for f in ("x1", "x2", "left", "right", "ev", "golden_x3"):
        _equal(getattr(got, f), getattr(want, f))
