"""The operator-gradient sums of kernels 4m, 8m and 3m, held on the CPU.

Kernels 4m and 8m (``csrc/plf_mxu_bwd.cuh``) sum the lane-constant
operator gradients ``g[o*C+c][q] = sum_s in[q*C+c][s] * gout[o*C+c][s]``
tile by tile: in "mxu_3x" and "mxu_bf16" on the tensor cores (bf16
operands, fp32 accumulation), in "mxu" register-blocked fp32.  Kernel 3m
(the node backward at S != 4, fp32 only) sums one node's three matrices
with the same fp32 code, on the same tiles and plan.  These tests
pin what that design rests on and what it does to the sums before the card
runs it:

* the premise: a product of the bf16 parts that ``bf16_split`` and
  ``bf16_round`` give is exact in fp32, and hi + lo reconstructs x within
  the class ``bf16_split`` documents (hypothesis);
* the order: a numpy emulation of the kernels' summation (k steps of 16 or
  8 sites in fp32 fragments, "mxu_3x"'s hh and hl + lh fragments combined
  per tile, tile sums added to fp32 accumulators, the blocks' rows added
  in fixed order) lands well inside the bars the card holds the kernels to
  against ``mxu_op_grad`` (``SUM_RTOL`` 1e-4 for 4m, ``SEG_MXU_SUM_RTOL``
  3e-6 for 8m in ``chip_smoke.py``), and kernel 3m's, with its plan's
  blocks, inside ``SUM_RTOL`` of the plain ``op_grad``;
* the Python planning that reads the site tile from the library's plan.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from plf_tpu_torch.ops import plf_grad as G
from plf_tpu_torch.ops import plf_tree_grad as TG
from plf_tpu_torch.ops import plf_tree_seg as SG
from plf_tpu_torch.ops.plf_mxu import bf16_round, bf16_split, mxu_op_grad

#: The bars of chip_smoke.py (kernel 4m's sums; kernel 8m's), as shares of
#: each matrix's largest magnitude; the emulation must stay a tenth inside.
SUM_RTOL = 1e-4
SEG_MXU_SUM_RTOL = 3e-6
MARGIN = 10

# fp32 values whose split parts and products stay normal in fp32.
_normal = st.floats(min_value=2.0 ** -40, max_value=2.0 ** 40, width=32)
_value = st.builds(lambda m, neg: -m if neg else m, _normal, st.booleans())
_pairs = st.lists(st.tuples(_value, _value), min_size=1, max_size=64)


def _f32(xs):
    return torch.tensor(xs, dtype=torch.float32)


@settings(max_examples=200, deadline=None)
@given(_pairs)
def test_bf16_part_products_are_exact_in_fp32(pairs):
    """Every product the tensor cores form, gh*ih, gh*il, gl*ih ("mxu_3x")
    and bf16(x)*bf16(y) ("mxu_bf16"), is the same in fp32 as in fp64: a
    product of two 8-bit significands fits fp32's 24 bits."""
    x, y = _f32([p[0] for p in pairs]), _f32([p[1] for p in pairs])
    xh, xl = (t.to(torch.float32) for t in bf16_split(x))
    yh, yl = (t.to(torch.float32) for t in bf16_split(y))
    for a, b in ((xh, yh), (xh, yl), (xl, yh),
                 (bf16_round(x), bf16_round(y))):
        assert torch.equal((a * b).double(), a.double() * b.double())


@settings(max_examples=200, deadline=None)
@given(st.lists(_value, min_size=1, max_size=64))
def test_bf16_split_reconstructs_within_its_class(xs):
    """hi + lo is x within 2^-16 of |x| (the "mxu_3x" class, ~2^-16 per
    operand): hi is x to 8 bits, lo the remainder to 8 more; hi + lo is
    exact in fp32."""
    x = _f32(xs)
    hi, lo = (t.to(torch.float32) for t in bf16_split(x))
    assert torch.equal((hi + lo).double(), hi.double() + lo.double())
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -16 * x.double().abs()).all())
    assert bool((lo.double().abs() <= 2.0 ** -8 * x.double().abs()).all())


# ------------------------------------------------- the summation order --

def _f(x):
    return np.asarray(x, np.float64).astype(np.float32)


def _entries(inp, gout, S, C):
    """(rows of in, rows of gout) per entry (o, c, q) of the (S*C, S)
    gradient, entry (o*C+c)*S + q: in[q*C+c], gout[o*C+c]."""
    o, c, q = np.meshgrid(np.arange(S), np.arange(C), np.arange(S),
                          indexing="ij")
    r = (o * C + c).reshape(-1)
    qi = (q * C + c).reshape(-1)
    order = np.argsort((r * S + q.reshape(-1)), kind="stable")
    return qi[order], r[order]


def emulate_sums(inp, gout, variant, S, C, ts, n_blocks, fp64_rows,
                 per=None):
    """The kernels' operator-gradient sums of one edge, in their order, in
    numpy: sites cut into ``n_blocks`` runs of whole ``ts``-site tiles (the
    launch's one wave), each tile's sums formed from zero (k steps of 16
    sites, 8 on 8-site tiles, rounded to fp32 on the tensor cores; in
    "mxu" an fp32 fma chain over the sites, each lane's from a site of its
    own), added to fp32 accumulators; "mxu_3x" forms hh and hl + lh in two
    fragments and adds each tile's hh + (hl + lh) to the accumulators;
    the blocks' rows added in order, in fp64 (8m) or fp32 (4m, 3m); each
    block takes ``per`` tiles (default: the fewest that ``n_blocks``
    cover).  Rounding
    is to nearest throughout (the tensor cores' own additions inside a k
    step are modelled as exact, then rounded)."""
    qi, r = _entries(inp, gout, S, C)
    # "mxu": the lane of entry (o, q) takes the tile's sites four at a time
    # from site 4 (g + 2t) on, g = o % 8, t = (q % 8) // 2, wrapping around
    o = r // C
    q = np.arange(r.size) % S
    rot = 4 * (o % 8 + 2 * ((q % 8) // 2))
    order = np.stack([(k0 + rot) % ts + u for k0 in range(0, ts, 4)
                      for u in range(4)], axis=1)
    ent = np.arange(r.size)
    n = inp.shape[1]
    tiles = n // ts
    per = per or -(-tiles // n_blocks)
    mode = {"mxu": 0, "vpu": 0, "mxu_3x": 1, "mxu_bf16": 2}[variant]
    t = lambda a: torch.as_tensor(a)
    if mode == 1:
        ih, il = (x.float().numpy() for x in bf16_split(t(inp)))
        gh, gl = (x.float().numpy() for x in bf16_split(t(gout)))
        pairs = [[(gh, ih)], [(gh, il), (gl, ih)]]
    elif mode == 2:
        pairs = [[(bf16_round(t(gout)).numpy(), bf16_round(t(inp)).numpy())]]
    else:
        pairs = [[(gout, inp)]]
    total = np.zeros(r.size, np.float64 if fp64_rows else np.float32)
    for b0 in range(0, tiles, per):
        acc = np.zeros(r.size, np.float32)
        for tt in range(b0, min(b0 + per, tiles)):
            sl = slice(tt * ts, (tt + 1) * ts)
            parts = []
            for group in pairs:
                d = np.zeros(r.size, np.float32)
                if mode == 0:
                    a, b = group[0][0][r, sl], group[0][1][qi, sl]
                    for step in range(ts):   # fmaf: one rounding per step
                        s = order[:, step]
                        d = _f(d + a[ent, s].astype(np.float64) * b[ent, s])
                else:
                    kk = 16 if ts % 16 == 0 else 8
                    for k0 in range(0, ts, kk):
                        ks = slice(sl.start + k0, sl.start + k0 + kk)
                        step = sum((a[r, ks].astype(np.float64)
                                    * b[qi, ks]).sum(axis=1)
                                   for a, b in group)
                        d = _f(d + step)
                parts.append(d)
            tile = parts[0] if len(parts) == 1 else _f(
                parts[0].astype(np.float64) + parts[1])
            acc = _f(acc.astype(np.float64) + tile)
        total = (total + acc if fp64_rows
                 else _f(total.astype(np.float64) + acc))
    return np.asarray(total, np.float32).reshape(S * C, S)


def _operands(rng, S, C, n):
    """A child CLV (non-negative, spanning decades) and an adjoint of mixed
    sign, as the sweep's (in, gout) pairs are."""
    R = S * C
    inp = _f(rng.random((R, n)) * 10.0 ** rng.uniform(-3, 0, (R, 1)))
    gout = _f(rng.standard_normal((R, n)) * 10.0 ** rng.uniform(-2, 2, (1, n)))
    return inp, gout


def _scale_err(got, want):
    want = want.numpy().astype(np.float64)
    return float(np.abs(got.astype(np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("variant", ["mxu", "mxu_3x", "mxu_bf16"])
@pytest.mark.parametrize("S,ts,n,n_blocks", [(20, 32, 768, 5),
                                             (61, 8, 768, 6)])
def test_emulated_sums_sit_well_inside_the_bars(variant, S, ts, n, n_blocks):
    """At the on-card test's shape (12 leaves x 700 sites, padded to 768;
    a few blocks), the emulated kernel order is within a tenth of both bars
    of mxu_op_grad, with 4m's fp32 rows and 8m's fp64 rows."""
    C = 4
    inp, gout = _operands(np.random.default_rng(S), S, C, n)
    want = mxu_op_grad(torch.as_tensor(inp), torch.as_tensor(gout), variant,
                       S, C)
    for fp64_rows, bar in ((False, SUM_RTOL), (True, SEG_MXU_SUM_RTOL)):
        got = emulate_sums(inp, gout, variant, S, C, ts, n_blocks, fp64_rows)
        assert _scale_err(got, want) <= bar / MARGIN


@pytest.mark.parametrize("variant", ["mxu", "mxu_3x", "mxu_bf16"])
def test_emulated_sums_on_a_protein_column(variant):
    """One 131,072-site column at S = 20 (the protein workload's length; 256
    blocks of 16 tiles of 32 sites, the plan of two blocks per SM on 132
    SMs): the emulated order within a tenth of both bars."""
    S, C, n = 20, 4, 1 << 17
    inp, gout = _operands(np.random.default_rng(7), S, C, n)
    want = mxu_op_grad(torch.as_tensor(inp), torch.as_tensor(gout), variant,
                       S, C)
    n_blocks, per = TG.tree_bwd_mxu_blocks(n, 203_280, 2 * 132, 32)
    assert (n_blocks, per) == (256, 16)
    for fp64_rows, bar in ((False, SUM_RTOL), (True, SEG_MXU_SUM_RTOL)):
        got = emulate_sums(inp, gout, variant, S, C, 32, n_blocks, fp64_rows)
        assert _scale_err(got, want) <= bar / MARGIN


@pytest.mark.parametrize("S,C,n,resident", [(20, 4, 1 << 17, 2 * 132),
                                            (61, 4, 1 << 13, 4 * 132),
                                            (13, 3, 1 << 12, 4 * 132)])
def test_emulated_kernel3m_sums_sit_inside_the_bar(S, C, n, resident):
    """Kernel 3m's order: one node's sites cut into its plan's blocks
    (node_bwd_mxu_blocks over bwd_tile(S)-site tiles: 32 at S = 20, 8 at S
    = 61 and 13; one wave of ``resident`` blocks, 2 or 4 a SM on 132 SMs),
    each tile's sums an fmaf chain per lane from a site of its own
    (unit_f32), added to fp32 accumulators with __fadd_rn, the blocks'
    rows added in order in fp32 (plf::colsum): within a tenth of the
    on-card bar (SUM_RTOL of scale) of the plain op_grad, for each of the
    node's three matrices' (in, gout) pairs."""
    ts = 32 if S <= 32 and S % 4 == 0 else 8
    n_blocks, per = G.node_bwd_mxu_blocks(n, resident, ts)
    assert n_blocks * per * ts >= n > (n_blocks - 1) * per * ts
    inp, gout = _operands(np.random.default_rng(S * C), S, C, n)
    want = G.op_grad(torch.as_tensor(inp), torch.as_tensor(gout), S, C)
    got = emulate_sums(inp, gout, "mxu", S, C, ts, n_blocks, False, per=per)
    assert _scale_err(got, want) <= SUM_RTOL / MARGIN


# ------------------------------------------------------------ planning --

@pytest.mark.parametrize("ts", [8, 32])
def test_chunks_and_blocks_hold_whole_tiles(ts):
    """Each tile the plan can give (32 at S = 20, 8 at S = 61) divides the
    128-site unit, so every
    chunk of the checkpoint rule is whole tiles, and the block rule covers
    a chunk with one wave of blocks (the last one not empty)."""
    for E, rows in ((63, 80), (31, 244), (31, 305)):
        for budget in (1 << 26, 1 << 29, 1 << 33):
            chunk = TG.tree_bwd_chunk_sites(1 << 17, E, rows, budget)
            assert chunk % ts == 0
            cols = 2 * E * rows * (rows // 4) + rows * (rows // 4) + rows
            n_blocks, per = TG.tree_bwd_mxu_blocks(chunk, cols, 3 * 132, ts)
            assert n_blocks <= 3 * 132
            assert n_blocks * per * ts >= chunk > (n_blocks - 1) * per * ts
    with pytest.raises(ValueError, match="whole tiles"):
        TG.tree_bwd_mxu_blocks(100, 1000, 132, ts)


def test_accumulators_per_block():
    """3*R*S accumulators a block, gl, gr and gec of the edge in every mode
    ("mxu_3x" adds each tile's hh + (hl + lh) to them): 19.2 KB at S = 20,
    C = 4; 178.6 KB at S = 61; 24 KB with +I (C = 5) at S = 20."""
    assert 4 * TG.acc_floats(20, 4) == 19_200
    assert 4 * TG.acc_floats(61, 4) == 178_608
    assert 4 * TG.acc_floats(20, 5) == 24_000


def test_segment_site_bytes_do_not_depend_on_the_tile():
    """The matrix forms' capacity rule counts device memory per site:
    kernel 8m's op checkpoint and the boundaries with their adjoints.  The
    site tile changes only the per-block accumulators, so a plan's bytes
    per site are those of its ops and boundaries alone."""
    rows = 80
    sched = [(64 + i, 2 * i, 2 * i + 1, 0.0, 0.0, i) for i in range(32)]
    sched += [(96 + i, 64 + 2 * i, 64 + 2 * i + 1, 0.0, 0.0, 32 + i)
              for i in range(16)]
    sched += [(112 + i, 96 + 2 * i, 96 + 2 * i + 1, 0.0, 0.0, 48 + i)
              for i in range(8)]
    sched += [(120 + i, 112 + 2 * i, 112 + 2 * i + 1, 0.0, 0.0, 56 + i)
              for i in range(4)]
    sched += [(124, 120, 121, 0.0, 0.0, 60), (125, 122, 123, 0.0, 0.0, 61),
              (126, 124, 125, 0.0, 0.0, 62)]
    plan = SG.plan_segments(sched, 64, rows=rows, cap_ops=24,
                            matrix_form=True)
    assert SG.seg_mxu_site_bytes(plan, rows) == (
        plan.seg_ops * (4 * rows + 1) + 2 * plan.n_boundaries * 4 * rows)
