"""Reference PLIO stream codec: window/stream beat formats.

A copy of ``plf_tpu/io/streams.py`` (numpy only): the port keeps its own,
so that it never imports the JAX package.

The reference PL data movers serialise each accelerator instance's input
as four 128-bit lane streams (4 fp32/beat).  Two disciplines exist:

* **window** (mm2sleft_memDNAwindowComb.cpp:50-97): per 64-site window,
  each lane re-receives [EV-half (2 beats) | transposed branch block
  (4 beats)] then one data beat per site; the left mover sends EV rows
  0-1, the right mover rows 2-3 (reassembled by the AIE combine kernel).
* **stream** (mm2sleft_memDNAstreamComb.cpp:44-114): one count beat
  (site count + padding encoded AS FLOAT), one header, then all data;
  a zero site is appended when the count is odd ("read per 2 in AIE").

This codec reads/writes those exact formats so the engine can consume or
produce reference-compatible test vectors and data dumps (with
``io/fixtures.py``, it is how the reference's aie/data fixtures are read).

Both PLIO layouts are implemented (``layout=`` on every function):

* **COMBINED** ("1inEV"): EV halves + branch block prefix every lane's
  data stream (described above).
* **SEPARATE** ("2in"): data streams s0-s3 carry only site beats; each
  lane's transposed branch block rides a dedicated sBranch<c> stream and
  the full EV a dedicated sEV stream on the *left* mover only
  (mm2sleft_memDNAwindowSep.cpp:58-72; the right mover has no EV,
  mm2sright_memDNAwindowSep.cpp).  In stream mode the count packet moves
  to the sBranch streams (mm2sleft_memDNAstreamSep.cpp:49-61) and the
  data streams start directly with site beats.

SEPARATE encodings return extra dict keys ``left_branch``/``right_branch``
(4 streams each) and ``left_ev`` (one stream).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["encode_window_lanes", "decode_window_lanes",
           "encode_stream_lanes", "decode_stream_lanes",
           "encode_window1in_lanes", "decode_window1in_lanes",
           "encode_output_lanes", "decode_output_lanes"]


def _check_layout(layout: str) -> str:
    if layout not in ("combined", "separate"):
        raise ValueError(f"layout must be 'combined' or 'separate', "
                         f"got {layout!r}")
    return layout


def _lane_data(clv: np.ndarray, lane: int) -> np.ndarray:
    """(n, C, S) site-major CLV -> lane ``c``'s (n, S) data beats.

    The PL splits each 512-bit site record so lane c carries rate
    category c's four floats (mm2sleft_memDNAwindowComb.cpp:86-96).
    """
    return np.ascontiguousarray(clv[:, lane, :].astype(np.float32))


def _branch_t(branch: np.ndarray, lane: int) -> np.ndarray:
    """Transposed branch block for lane c (transpose.cpp:6-24):
    beat a, float k = branch[c, k, a]."""
    return np.ascontiguousarray(branch[lane].T.astype(np.float32))


def encode_window_lanes(ev, left, right, x1, x2, window_sites: int = 64,
                        layout: str = "combined"
                        ) -> Dict[str, List[np.ndarray]]:
    """Encode inputs as window-mode lane streams.

    COMBINED returns {"left": [4 x (beats, 4)], "right": [...]};
    SEPARATE additionally returns "left_branch"/"right_branch" (4 streams
    of 4 beats/window = the lane's transposed branch block,
    mm2sleft_memDNAwindowSep.cpp:58-72) and "left_ev" (one stream, 4
    beats/window = the full EV; the right mover has none).  Site count is
    zero-padded up to a window multiple (the mm2s zero-fill of the last
    partial window, mm2sleft_uint128x4window1in.cpp:85-92).
    """
    _check_layout(layout)
    ev = np.asarray(ev, np.float32).reshape(4, 4)
    left = np.asarray(left, np.float32).reshape(4, 4, 4)
    right = np.asarray(right, np.float32).reshape(4, 4, 4)
    x1 = np.asarray(x1, np.float32).reshape(-1, 4, 4)
    x2 = np.asarray(x2, np.float32).reshape(-1, 4, 4)
    n = x1.shape[0]
    n_pad = -(-n // window_sites) * window_sites
    pad = n_pad - n
    if pad:
        z = np.zeros((pad, 4, 4), np.float32)
        x1 = np.concatenate([x1, z])
        x2 = np.concatenate([x2, z])
    n_windows = n_pad // window_sites

    if layout == "separate":
        out: Dict[str, List[np.ndarray]] = {
            "left": [], "right": [], "left_branch": [], "right_branch": []}
        for side, branch, clv in (("left", left, x1), ("right", right, x2)):
            for lane in range(4):
                # data streams carry only site beats (one per site).
                out[side].append(_lane_data(clv, lane))
                # sBranch<lane>: the transposed block, re-sent per window.
                out[f"{side}_branch"].append(
                    np.tile(_branch_t(branch, lane), (n_windows, 1)))
        # sEV: full EV re-sent per window, left mover only.
        out["left_ev"] = [np.tile(ev, (n_windows, 1))]
        return out

    out = {"left": [], "right": []}
    for side, branch, clv, ev_half in (
            ("left", left, x1, ev[0:2]), ("right", right, x2, ev[2:4])):
        for lane in range(4):
            beats = []
            data = _lane_data(clv, lane)
            bt = _branch_t(branch, lane)
            for w in range(n_pad // window_sites):
                beats.append(ev_half)
                beats.append(bt)
                beats.append(data[w * window_sites:(w + 1) * window_sites])
            out[side].append(np.concatenate(beats, axis=0))
    return out


def decode_window_lanes(lanes: Dict[str, List[np.ndarray]],
                        window_sites: int = 64, n_sites: int | None = None,
                        layout: str = "combined"
                        ) -> Tuple[np.ndarray, ...]:
    """Inverse of encode_window_lanes -> (ev, left, right, x1, x2)."""
    _check_layout(layout)
    if layout == "separate":
        ev = lanes["left_ev"][0][0:4]
        out = {}
        for side in ("left", "right"):
            out[side] = np.stack(
                [d for d in lanes[side]], axis=1)           # (n_pad, 4, 4)
            out[f"{side}_branch"] = np.stack(
                [bt[0:4].T for bt in lanes[f"{side}_branch"]])  # (C, S, S)
        x1, x2 = out["left"], out["right"]
        if n_sites is not None:
            x1, x2 = x1[:n_sites], x2[:n_sites]
        return ev, out["left_branch"], out["right_branch"], x1, x2
    beats_per_window = 6 + window_sites
    ev_halves = {}
    branches = {}
    datas = {}
    for side in ("left", "right"):
        lane_datas = []
        for lane, beats in enumerate(lanes[side]):
            n_windows = beats.shape[0] // beats_per_window
            ev_halves[side] = beats[0:2]
            bt = beats[2:6]
            branches.setdefault(side, []).append(bt.T)
            chunks = [beats[w * beats_per_window + 6:
                            (w + 1) * beats_per_window]
                      for w in range(n_windows)]
            lane_datas.append(np.concatenate(chunks, axis=0))
        datas[side] = np.stack(lane_datas, axis=1)  # (n_pad, 4, 4)
    ev = np.concatenate([ev_halves["left"], ev_halves["right"]], axis=0)
    left = np.stack(branches["left"])
    right = np.stack(branches["right"])
    x1, x2 = datas["left"], datas["right"]
    if n_sites is not None:
        x1, x2 = x1[:n_sites], x2[:n_sites]
    return ev, left, right, x1, x2


def encode_stream_lanes(ev, left, right, x1, x2, layout: str = "combined"
                        ) -> Dict[str, List[np.ndarray]]:
    """Encode inputs as stream-mode lane streams.

    COMBINED: beat 0 of every data stream carries ``n + padding`` encoded
    as float (mm2sleft_memDNAstreamComb.cpp:47-58); one zero site is
    appended when n is odd (the AIE reads 2 sites/iteration, lines
    44-45,107-114).

    SEPARATE: the count packet moves to beat 0 of every sBranch stream
    (mm2sleft_memDNAstreamSep.cpp:49-61), followed by the lane's 4
    transposed-branch beats; the full EV rides sEV (left mover only);
    data streams carry only site beats (+ the odd-count zero pad).
    """
    _check_layout(layout)
    ev = np.asarray(ev, np.float32).reshape(4, 4)
    left = np.asarray(left, np.float32).reshape(4, 4, 4)
    right = np.asarray(right, np.float32).reshape(4, 4, 4)
    x1 = np.asarray(x1, np.float32).reshape(-1, 4, 4)
    x2 = np.asarray(x2, np.float32).reshape(-1, 4, 4)
    n = x1.shape[0]
    padding = n & 1
    if padding:
        z = np.zeros((1, 4, 4), np.float32)
        x1 = np.concatenate([x1, z])
        x2 = np.concatenate([x2, z])
    count_beat = np.array([[np.float32(n + padding), 0, 0, 0]], np.float32)

    if layout == "separate":
        out: Dict[str, List[np.ndarray]] = {
            "left": [], "right": [], "left_branch": [], "right_branch": []}
        for side, branch, clv in (("left", left, x1), ("right", right, x2)):
            for lane in range(4):
                out[side].append(_lane_data(clv, lane))
                out[f"{side}_branch"].append(np.concatenate(
                    [count_beat, _branch_t(branch, lane)], axis=0))
        out["left_ev"] = [ev.copy()]
        return out

    out = {"left": [], "right": []}
    for side, branch, clv, ev_half in (
            ("left", left, x1, ev[0:2]), ("right", right, x2, ev[2:4])):
        for lane in range(4):
            beats = [count_beat, ev_half, _branch_t(branch, lane),
                     _lane_data(clv, lane)]
            out[side].append(np.concatenate(beats, axis=0))
    return out


def encode_window1in_lanes(ev, left, right, x1, x2,
                           window_sites: int = 64
                           ) -> Dict[str, List[np.ndarray]]:
    """Encode inputs in the LEGACY ``uint128x4window1in`` wire format.

    The first-generation PL movers (ref mm2sleft_uint128x4window1in.cpp:
    49-108, mm2sright_uint128x4window1in.cpp:45-95) use a hybrid layout
    that predates the Comb/Sep split: per window each data stream s<c>
    carries [transposed branch block (4 beats) | one beat per site], the
    FULL 4x4 EV rides a dedicated sEV stream (4 beats/window, LEFT mover
    only — the right mover has no EV port at all), and the last partial
    window is zero-filled (lines 85-92).  Site records are 512-bit
    site-major words; lane c takes floats [4c:4c+4] = rate category c
    (lines 96-106), identical to the modern codecs.

    Returns {"left": [4 streams], "right": [4 streams],
    "left_ev": [1 stream]}, each stream an (beats, 4) float32 array.
    """
    ev = np.asarray(ev, np.float32).reshape(4, 4)
    left = np.asarray(left, np.float32).reshape(4, 4, 4)
    right = np.asarray(right, np.float32).reshape(4, 4, 4)
    x1 = np.asarray(x1, np.float32).reshape(-1, 4, 4)
    x2 = np.asarray(x2, np.float32).reshape(-1, 4, 4)
    n = x1.shape[0]
    n_pad = -(-n // window_sites) * window_sites
    pad = n_pad - n
    if pad:
        z = np.zeros((pad, 4, 4), np.float32)
        x1 = np.concatenate([x1, z])
        x2 = np.concatenate([x2, z])
    n_windows = n_pad // window_sites

    out: Dict[str, List[np.ndarray]] = {"left": [], "right": []}
    for side, branch, clv in (("left", left, x1), ("right", right, x2)):
        for lane in range(4):
            data = _lane_data(clv, lane)
            bt = _branch_t(branch, lane)
            beats = []
            for w in range(n_windows):
                beats.append(bt)
                beats.append(data[w * window_sites:(w + 1) * window_sites])
            out[side].append(np.concatenate(beats, axis=0))
    out["left_ev"] = [np.tile(ev, (n_windows, 1))]
    return out


def decode_window1in_lanes(lanes: Dict[str, List[np.ndarray]],
                           window_sites: int = 64,
                           n_sites: int | None = None
                           ) -> Tuple[np.ndarray, ...]:
    """Inverse of encode_window1in_lanes -> (ev, left, right, x1, x2)."""
    ev = lanes["left_ev"][0][0:4]
    beats_per_window = 4 + window_sites
    branches = {}
    datas = {}
    for side in ("left", "right"):
        lane_datas = []
        for beats in lanes[side]:
            n_windows = beats.shape[0] // beats_per_window
            branches.setdefault(side, []).append(beats[0:4].T)
            chunks = [beats[w * beats_per_window + 4:
                            (w + 1) * beats_per_window]
                      for w in range(n_windows)]
            lane_datas.append(np.concatenate(chunks, axis=0))
        datas[side] = np.stack(lane_datas, axis=1)  # (n_pad, 4, 4)
    x1, x2 = datas["left"], datas["right"]
    if n_sites is not None:
        x1, x2 = x1[:n_sites], x2[:n_sites]
    return ev, np.stack(branches["left"]), np.stack(branches["right"]), \
        x1, x2


def encode_output_lanes(x3, window_sites: int = 64
                        ) -> List[np.ndarray]:
    """Serialise a result CLV as the four s2mm lane streams.

    The device emits one beat per (padded) site on each of the four
    output streams; lane c carries floats [4c:4c+4] of the 512-bit
    site record (ref s2mm_uint128x4window1in.cpp:44-57 — the s2mm writes
    mem[i] from the four stream reads and drains the zero-fill beats of
    the last partial window without storing them).
    """
    x3 = np.asarray(x3, np.float32).reshape(-1, 4, 4)
    n = x3.shape[0]
    n_pad = -(-n // window_sites) * window_sites
    if n_pad != n:
        x3 = np.concatenate(
            [x3, np.zeros((n_pad - n, 4, 4), np.float32)])
    return [_lane_data(x3, lane) for lane in range(4)]


def decode_output_lanes(streams: List[np.ndarray],
                        n_sites: int) -> np.ndarray:
    """s2mm semantics: assemble site records from the four lane streams,
    keeping only the first ``n_sites`` (padding beats are read and
    dropped, s2mm_uint128x4window1in.cpp:52-56)."""
    return np.stack([s[:n_sites] for s in streams], axis=1)


def decode_stream_lanes(lanes: Dict[str, List[np.ndarray]],
                        layout: str = "combined"
                        ) -> Tuple[np.ndarray, ...]:
    """Inverse of encode_stream_lanes -> (ev, left, right, x1, x2, n)."""
    _check_layout(layout)
    if layout == "separate":
        ev = lanes["left_ev"][0][0:4]
        branches = {}
        datas = {}
        declared = None
        for side in ("left", "right"):
            lane_datas = []
            for lane in range(4):
                bb = lanes[f"{side}_branch"][lane]
                declared = int(bb[0, 0])
                branches.setdefault(side, []).append(bb[1:5].T)
                lane_datas.append(lanes[side][lane][:declared])
            datas[side] = np.stack(lane_datas, axis=1)
        return (ev, np.stack(branches["left"]), np.stack(branches["right"]),
                datas["left"], datas["right"], declared)
    ev_halves = {}
    branches = {}
    datas = {}
    declared = None
    for side in ("left", "right"):
        lane_datas = []
        for beats in lanes[side]:
            declared = int(beats[0, 0])
            ev_halves[side] = beats[1:3]
            branches.setdefault(side, []).append(beats[3:7].T)
            lane_datas.append(beats[7:7 + declared])
        datas[side] = np.stack(lane_datas, axis=1)
    ev = np.concatenate([ev_halves["left"], ev_halves["right"]], axis=0)
    left = np.stack(branches["left"])
    right = np.stack(branches["right"])
    return ev, left, right, datas["left"], datas["right"], declared
