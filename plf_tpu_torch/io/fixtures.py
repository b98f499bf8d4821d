"""Loader for the reference repo's AIE-simulator test fixtures.

A copy of ``plf_tpu/io/fixtures.py`` (numpy only).  The fixtures are read
from ``REFERENCE_DATA_DIR``: the reference's ``aie/data`` directory placed
at ``reference/aie/data`` in the checkout, or the directory that the
``PLF_REFERENCE_DATA`` environment variable names.  Where it is absent,
``reference_fixtures_available()`` is False and whatever reads it skips.

The reference ships its only checked-in test vectors as PLIO beat files
(``aie/data/*.txt``, 4 floats per line = one 128-bit beat), bound per lane
to the simulator graphs (aie/src/.../graph.h:38-44).  Lane ``c`` carries
rate category ``c`` of every site.  We reconstruct full PLF inputs/outputs
from them so the engine can be validated against the exact vectors the
hardware was.

File roles (window mode, COMBINED layout — aie/data/):

* ``inputcombinedevleft<c>.txt``:  2 beats EV *top* half (EV rows 0-1,
  hls/src/mm2sleft_memDNAwindowComb.cpp:33-35), 4 beats transposed branch
  block ``Bt[a,k] = left[c,k,a]`` (transpose.cpp:6-24), then one beat per
  site = ``x1[site, c, :]``.
* ``inputcombinedevright<c>.txt``: EV *bottom* half (rows 2-3), right
  branch block, ``x2`` data.
* ``inputdataleft/right<c>.txt`` + ``inputbranchleft/right<c>.txt`` +
  ``inputEV0.txt``: the SEPARATE-layout split of the same content.
* ``golden<c>.txt``: expected AIE lane output — ``x3[site, c, :]``
  *pre-rescale* (scaling lives in the PL s2mm, downstream of the graph).
* ``stream/``: same files with a leading count beat ``<n> 0 0 0``
  (mm2sleft_memDNAstreamComb.cpp:47-58).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

REFERENCE_DATA_DIR = os.environ.get(
    "PLF_REFERENCE_DATA",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "reference", "aie", "data"))

__all__ = ["PLFTestVectors", "load_beats", "load_window_vectors",
           "load_stream_vectors", "reference_fixtures_available",
           "REFERENCE_DATA_DIR"]


def reference_fixtures_available(data_dir: str = REFERENCE_DATA_DIR) -> bool:
    return os.path.isfile(os.path.join(data_dir, "golden0.txt"))


def load_beats(path: str) -> np.ndarray:
    """Parse a PLIO beat file -> (n_beats, 4) float32."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            rows.append([np.float32(p) for p in parts])
    return np.asarray(rows, dtype=np.float32)


@dataclass
class PLFTestVectors:
    """Fully reconstructed PLF test case from lane fixtures."""

    x1: np.ndarray       # (n, C, S) fp32
    x2: np.ndarray       # (n, C, S)
    left: np.ndarray     # (C, S, S) [c, k, a]
    right: np.ndarray    # (C, S, S)
    ev: np.ndarray       # (S, S)    [k, a]
    golden_x3: np.ndarray  # (n, C, S) expected parent CLV, pre-rescale

    @property
    def n_sites(self) -> int:
        return self.x1.shape[0]


def _untranspose_branch(bt: np.ndarray) -> np.ndarray:
    """Fixture branch beats are the PL-transposed block: bt[a, k] = B[k, a]."""
    return bt.T.copy()


def _assemble(lane_ev, lane_branch, lane_data, golden, categories=4):
    n = min(min(d.shape[0] for d in lane_data),
            min(g.shape[0] for g in golden))
    ev = np.concatenate(lane_ev, axis=0)          # (4, 4) rows k
    branch = np.stack([_untranspose_branch(b) for b in lane_branch])  # (C,S,S)
    x = np.stack([d[:n] for d in lane_data], axis=1)      # (n, C, S)
    gx3 = np.stack([g[:n] for g in golden], axis=1)       # (n, C, S)
    return ev, branch, x, gx3


def load_window_vectors(data_dir: str = REFERENCE_DATA_DIR) -> PLFTestVectors:
    """Reconstruct the window-mode COMBINED-layout test case."""
    lanes = range(4)
    ev_halves_l, ev_halves_r = [], []
    branch_l, branch_r = [], []
    data_l, data_r, golden = [], [], []
    for c in lanes:
        bl = load_beats(os.path.join(data_dir, f"inputcombinedevleft{c}.txt"))
        br = load_beats(os.path.join(data_dir, f"inputcombinedevright{c}.txt"))
        ev_halves_l.append(bl[0:2])
        ev_halves_r.append(br[0:2])
        branch_l.append(bl[2:6])
        branch_r.append(br[2:6])
        data_l.append(bl[6:])
        data_r.append(br[6:])
        golden.append(load_beats(os.path.join(data_dir, f"golden{c}.txt")))
    # All lanes carry identical EV halves; top half from left, bottom from
    # right (mm2sleft/right_memDNAwindowComb.cpp:33-35).
    ev_top, ev_bot = ev_halves_l[0], ev_halves_r[0]
    evl, left, x1, gx3 = _assemble([ev_top, ev_bot], branch_l, data_l, golden)
    _, right, x2, _ = _assemble([ev_top, ev_bot], branch_r, data_r, golden)
    return PLFTestVectors(x1=x1, x2=x2, left=left, right=right, ev=evl,
                          golden_x3=gx3)


def load_separate_vectors(data_dir: str = REFERENCE_DATA_DIR) -> PLFTestVectors:
    """Reconstruct the SEPARATE-layout test case (dedicated EV/branch files)."""
    ev = load_beats(os.path.join(data_dir, "inputEV0.txt"))
    branch_l, branch_r, data_l, data_r, golden = [], [], [], [], []
    for c in range(4):
        branch_l.append(load_beats(
            os.path.join(data_dir, f"inputbranchleft{c}.txt")))
        branch_r.append(load_beats(
            os.path.join(data_dir, f"inputbranchright{c}.txt")))
        data_l.append(load_beats(
            os.path.join(data_dir, f"inputdataleft{c}.txt")))
        data_r.append(load_beats(
            os.path.join(data_dir, f"inputdataright{c}.txt")))
        golden.append(load_beats(os.path.join(data_dir, f"golden{c}.txt")))
    n = min(min(d.shape[0] for d in data_l + data_r),
            min(g.shape[0] for g in golden))
    left = np.stack([_untranspose_branch(b) for b in branch_l])
    right = np.stack([_untranspose_branch(b) for b in branch_r])
    x1 = np.stack([d[:n] for d in data_l], axis=1)
    x2 = np.stack([d[:n] for d in data_r], axis=1)
    gx3 = np.stack([g[:n] for g in golden], axis=1)
    return PLFTestVectors(x1=x1, x2=x2, left=left, right=right, ev=ev,
                          golden_x3=gx3)


def load_stream_vectors(data_dir: str = REFERENCE_DATA_DIR) -> PLFTestVectors:
    """Stream-mode fixtures: identical content behind a count-beat header."""
    sdir = os.path.join(data_dir, "stream")
    branch_l, branch_r, data_l, data_r, golden = [], [], [], [], []
    ev_top = ev_bot = None
    n_declared = None
    for c in range(4):
        bl = load_beats(os.path.join(sdir, f"inputcombinedevleft{c}.txt"))
        br = load_beats(os.path.join(sdir, f"inputcombinedevright{c}.txt"))
        # Beat 0 is the site count *encoded as float*
        # (mm2sleft_memDNAstreamComb.cpp:47-58).
        n_declared = int(bl[0, 0])
        bl, br = bl[1:], br[1:]
        ev_top, ev_bot = bl[0:2], br[0:2]
        branch_l.append(bl[2:6])
        branch_r.append(br[2:6])
        data_l.append(bl[6:])
        data_r.append(br[6:])
        golden.append(load_beats(os.path.join(data_dir, f"golden{c}.txt")))
    ev = np.concatenate([ev_top, ev_bot], axis=0)
    left = np.stack([_untranspose_branch(b) for b in branch_l])
    right = np.stack([_untranspose_branch(b) for b in branch_r])
    n = min(n_declared, min(d.shape[0] for d in data_l + data_r),
            min(g.shape[0] for g in golden))
    x1 = np.stack([d[:n] for d in data_l], axis=1)
    x2 = np.stack([d[:n] for d in data_r], axis=1)
    gx3 = np.stack([g[:n] for g in golden], axis=1)
    return PLFTestVectors(x1=x1, x2=x2, left=left, right=right, ev=ev,
                          golden_x3=gx3)
