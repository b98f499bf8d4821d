"""Alignment input: FASTA/PHYLIP parsing, state encoding, site patterns.

A NumPy-only copy of ``plf_tpu/io/alignment.py``.

The reference consumes raw random CLVs (host_mem.cpp:179-209); production
PLF workloads start from multiple sequence alignments.  This module turns
an alignment into the engine's inputs:

* parse FASTA / relaxed PHYLIP,
* encode DNA to int8 state codes, with IUPAC partial-ambiguity
  codes kept as first-class multi-hot states (R -> {A,G} etc., the RAxML
  tip-vector semantics the reference kernel serves —
  the reference's app/src/plf.cpp:21-22 consumes arbitrary tip CLVs);
  only N/X/gap collapse to the fully-ambiguous all-ones CLV,
* compress duplicate site patterns into (patterns, weights) — this is
  exactly what the RAxML ``wgt`` array the PLF consumes is
  (app/src/plf.cpp:63: scaler increments are weighted by pattern count).

Code space per alphabet: ``0..S-1`` plain states, ``S..S+A-1`` the A
partial-ambiguity codes (in ``AMBIGUITY[S]`` order), ``GAP`` (-1) fully
ambiguous.  ``tip_expansion_table``/``map_tip_codes`` translate this to
the engine's tip-table columns (``0..S-1`` states, ``S`` gap,
``S+1..S+A`` ambiguity) so the gap column keeps its historical index.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["parse_fasta", "parse_phylip", "encode_dna", "encode_protein",
           "compress_patterns", "Alignment", "AMBIGUITY",
           "tip_expansion_table", "map_tip_codes"]

DNA_CODE: Dict[str, int] = {"A": 0, "C": 1, "G": 2, "T": 3, "U": 3}
AA_ORDER = "ARNDCQEGHILKMFPSTWYV"
AA_CODE: Dict[str, int] = {a: i for i, a in enumerate(AA_ORDER)}
GAP = -1  # expands to the all-ones (fully ambiguous) tip CLV

# IUPAC partial-ambiguity codes: letter -> member plain states.  DNA
# follows the IUPAC nucleotide table (N/-/?/. are full gaps); protein has
# the standard B=Asx, Z=Glx, J=Xle (X is a full gap).
DNA_AMBIGUITY: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    ("R", (0, 2)), ("Y", (1, 3)), ("S", (1, 2)), ("W", (0, 3)),
    ("K", (2, 3)), ("M", (0, 1)), ("B", (1, 2, 3)), ("D", (0, 2, 3)),
    ("H", (0, 1, 3)), ("V", (0, 1, 2)))
AA_AMBIGUITY: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    ("B", (AA_CODE["N"], AA_CODE["D"])),
    ("Z", (AA_CODE["Q"], AA_CODE["E"])),
    ("J", (AA_CODE["I"], AA_CODE["L"])))

#: state-count -> ordered member tuples of the partial-ambiguity codes
AMBIGUITY: Dict[int, Tuple[Tuple[int, ...], ...]] = {
    4: tuple(m for _c, m in DNA_AMBIGUITY),
    20: tuple(m for _c, m in AA_AMBIGUITY),
}


def tip_expansion_table(w, states: int):
    """(S, S+1+A) tip table: column b<S is W·e_b, column S the gap CLV
    W·1, columns S+1.. the multi-hot ambiguity CLVs W·(Σ e_m).

    """
    w = np.asarray(w)
    cols = [w, w.sum(axis=1, keepdims=True)]
    for members in AMBIGUITY.get(states, ()):
        cols.append(w[:, list(members)].sum(axis=1, keepdims=True))
    return np.concatenate(cols, axis=1)


def map_tip_codes(tip_states, states: int) -> np.ndarray:
    """Alignment code space -> tip-table columns (int32).

    Plain states map to themselves, partial-ambiguity codes
    ``S..S+A-1`` shift past the gap column to ``S+1..S+A``, anything
    else (GAP, out of range) to the gap column ``S``.
    """
    ts = np.asarray(tip_states)
    n_amb = len(AMBIGUITY.get(states, ()))
    return np.where(
        (ts >= 0) & (ts < states), ts,
        np.where((ts >= states) & (ts < states + n_amb), ts + 1,
                 states)).astype(np.int32)


class Alignment:
    """Names + int8 state-code matrix (+ optional pattern weights)."""

    def __init__(self, names: List[str], codes: np.ndarray,
                 weights: np.ndarray | None = None):
        self.names = names
        self.codes = codes              # (n_seq, n_sites) int8
        self.weights = (np.ones(codes.shape[1], np.int32)
                        if weights is None else weights)

    @property
    def n_sequences(self) -> int:
        return self.codes.shape[0]

    @property
    def n_sites(self) -> int:
        return self.codes.shape[1]

    def compressed(self) -> "Alignment":
        pats, wgt = compress_patterns(self.codes, self.weights)
        return Alignment(self.names, pats, wgt)

    def reorder(self, names: List[str]) -> "Alignment":
        """Row order matching a tree's leaf order."""
        idx = [self.names.index(n) for n in names]
        return Alignment([self.names[i] for i in idx], self.codes[idx],
                         self.weights)


def parse_fasta(text: str) -> Tuple[List[str], List[str]]:
    names, seqs = [], []
    cur: List[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if cur:
                seqs.append("".join(cur))
                cur = []
            names.append(line[1:].split()[0])
        else:
            cur.append(line)
    if cur:
        seqs.append("".join(cur))
    if len(names) != len(seqs):
        raise ValueError("malformed FASTA: name/sequence count mismatch")
    return names, seqs


def parse_phylip(text: str) -> Tuple[List[str], List[str]]:
    """Relaxed (whitespace-delimited) sequential PHYLIP."""
    lines = [l for l in text.splitlines() if l.strip()]
    header = lines[0].split()
    n_seq, n_sites = int(header[0]), int(header[1])
    names, seqs = [], []
    for line in lines[1:]:
        parts = line.split(None, 1)
        if len(parts) < 2:
            continue
        names.append(parts[0])
        seqs.append(parts[1].replace(" ", ""))
        if len(names) == n_seq:
            break
    if len(names) != n_seq or any(len(s) != n_sites for s in seqs):
        raise ValueError("malformed PHYLIP")
    return names, seqs


def _encode(seqs: List[str], table: Dict[str, int]) -> np.ndarray:
    lut = np.full(256, GAP, np.int8)
    for ch, code in table.items():
        lut[ord(ch)] = code
        lut[ord(ch.lower())] = code
    arr = np.frombuffer("".join(seqs).encode("ascii"), np.uint8)
    codes = lut[arr].reshape(len(seqs), -1)
    return codes


def encode_dna(seqs: List[str]) -> np.ndarray:
    """ACGT(U) -> 0..3; IUPAC partial-ambiguity codes R/Y/S/W/K/M/B/D/H/V
    -> 4..13 (multi-hot tip CLVs); N and gaps -> GAP (-1)."""
    table = dict(DNA_CODE)
    table.update({c: 4 + i for i, (c, _m) in enumerate(DNA_AMBIGUITY)})
    return _encode(seqs, table)


def encode_protein(seqs: List[str]) -> np.ndarray:
    """20 amino acids (ARNDCQEGHILKMFPSTWYV order) -> 0..19; B/Z/J ->
    20..22 (multi-hot Asx/Glx/Xle); X and gaps -> GAP (-1)."""
    table = dict(AA_CODE)
    table.update({c: 20 + i for i, (c, _m) in enumerate(AA_AMBIGUITY)})
    return _encode(seqs, table)


def compress_patterns(codes: np.ndarray, weights=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicate identical alignment columns -> (patterns, weights).

    Returns codes (n_seq, n_patterns) and int32 weights summing to the
    original (weighted) site count.  This is the RAxML site-pattern
    compression that makes ``wgt`` meaningful.
    """
    if weights is None:
        weights = np.ones(codes.shape[1], np.int64)
    cols = np.ascontiguousarray(codes.T)
    view = cols.view([("", cols.dtype)] * cols.shape[1])
    _, idx, inv = np.unique(view, return_index=True, return_inverse=True)
    idx = np.sort(idx)
    # Recompute inverse against sorted unique order for stable output.
    order = {tuple(cols[i]): j for j, i in enumerate(idx)}
    inv = np.fromiter((order[tuple(c)] for c in cols), np.int64,
                      len(cols))
    wgt = np.zeros(len(idx), np.int64)
    np.add.at(wgt, inv, np.asarray(weights, np.int64))
    return codes[:, idx], wgt.astype(np.int32)
