// The reverse sweep of the matrix-form backward kernels, shared by kernel 4m
// (plf_tree_bwd_mxu.cu, the whole tree), kernel 8m (plf_tree_seg_bwd_mxu.cu,
// segment by segment) and kernel 3m (plf_node_bwd_mxu.cu, one node, fp32
// only): all three sweep tiles of bwd_tile(S) sites with bwd_threads
// threads, sum with tile_sums and place their accumulators by bwd_plan.
//
// One PLF step of the sweep, for one tile of TS sites of a node whose
// children x1, x2 and parent adjoint g_y (already multiplied by the rescale
// factor) sit in shared-memory [row][site] tiles:
//
//   u1 = S1(x1; L), u2 = S1(x2; R), g_p = S3(g_y; E^T)   (sweep_products)
//   g_u1 = g_p * u2, g_u2 = g_p * u1, p = u1 * u2
//   acc[e] += tile sums of the three operator gradients   (tile_sums)
//   the children's adjoints S1(g_u1; L^T), S1(g_u2; R^T)  (adjoint_to)
//
// every stage in the mode's arithmetic (plf_mxu.cuh's stage_block, each
// product and sum separately rounded in q order: the per-site values equal
// the plain versions bit for bit), the operator gradients the lane-constant
// entries g[o*C+c][q] = sum_s in[q*C+c][s] * gout[o*C+c][s] of the JAX
// kernel's (rows, rows) block gradients gout @ in^T.  Only these site sums
// run in another order than the plain version's, and are held to it by a
// tolerance.  No float atomics: two runs are bit-identical.
//
// The sums (tile_sums) are, for each (m, c), a GEMM
// G[o][q] += sum_k gout[o*C+c][k] * in[q*C+c][k] with K = the tile's sites,
// cut into units of 16 x 32 entries (o, q) that the block's warps take in
// turn, each unit four 16 x 8 mma fragments:
//
//   MODE_BF16X3  each value split once into bf16 hi + lo as it is loaded
//                into an mma.sync bf16 fragment (m16n8k16; m16n8k8 on
//                8-site tiles); three products per k step, hh = gh*ih into
//                one fp32 fragment and hl = gh*il, lh = gl*ih into a
//                second; the tile's sums hh + (hl + lh) are added to the
//                accumulators, as the 8-site sums before them were;
//   MODE_BF16    each value rounded to bf16 once, one product per k step;
//   MODE_F32     fp32 products on the CUDA cores, register-blocked: a lane
//                owns the 16 entries an mma fragment would give it and
//                reads each input value once per unit row or column, as
//                float4 over four sites, from a site of its own (fmaf, in
//                these sums only).
//
// A product of two bf16 values is exact in fp32, so the tensor cores form
// the plain version's own products; only the order of the fp32 additions
// differs.  Each tile's sums start from zero (in fragments or registers) and
// are added to the accumulators with __fadd_rn once per tile: the tensor
// cores' own additions span one tile.  Rows and columns past S are zeros in
// the fragments, and their results are dropped.
//
// The accumulators of the edge being swept (3*R*S floats, entry m*R*S +
// (o*C+c)*S + q) are read and written once per tile, each by the lane that
// owns it, in shared memory when two blocks with them fit an SM, else in a
// private row of device memory (bwd_plan): shared at S = 20 (19 KB beside
// 61 KB of tiles), device memory at S = 61 (178 KB).  flush_edge writes them
// into the block's row of partial sums once the edge is done, and
// plf::colsum adds the rows up in a fixed order (kernel 3m's block sums
// one edge, so its accumulators in device memory are its row itself).
// Tried on an H100 and slower (PERF.md): hh and hl + lh in two sets
// of accumulators combined once per edge (S = 61: 170 against 92 ms), the
// accumulators in the fragments' own order in device memory, 16-site tiles
// at S = 20, and more blocks per SM under a register cap.

#pragma once

#include <stdint.h>

#include "plf_grad.cuh"
#include "plf_mxu.cuh"

namespace plf_mxu {

// The site tile of kernels 4m, 8m and 3m (bwd_tile): 32 sites with float4
// plane loads for S <= 32 with S % 4 == 0 (S = 20: each stage's 20 jobs of 4
// rows, and a warp reads one operator address at a time), else 8 (S = 61:
// 64 jobs fill 128 threads in 4 rounds; six tiles take 47 KB, four blocks
// per SM where 16 sites allow two).  Measured on an H100 (PERF.md, PR 11):
// at S = 20, 16-site tiles with up to 7 blocks per SM ran slower than
// 32-site tiles with 3; at S = 61, 16-site tiles ran slower than 8.
__host__ __device__ constexpr int bwd_tile(int S) {
  return S <= 32 && S % 4 == 0 ? 32 : 8;
}

// Threads per block of kernels 4m, 8m and 3m on tiles of TS sites (a
// compile-time constant in every loop below: with the block size read at
// run time instead, kernel 4m's fp32 and bf16 modes ran 22-29% slower on an
// H100), and the blocks per SM their registers must allow
// (__launch_bounds__).  On 32-site tiles, 320 threads take each stage's 20
// jobs of 4 rows at S = 20 in two rounds; 10 warps a block, two blocks per SM (at most 102 registers).  On
// an H100 this ran kernel 4m's "mxu_3x" at 74-75 ms where 128 threads (3
// blocks) took 130 and 160 (3 blocks) 99-100; without the register cap
// kernel 8m's fp32 form kept one block per SM (PERF.md, PR 11).  8-site
// tiles keep 128 threads and four blocks per SM (128 registers).
__host__ __device__ constexpr int bwd_threads(int TS) {
  return TS == 32 ? 320 : 128;
}
__host__ __device__ constexpr int bwd_min_blocks(int TS) {
  return TS == 32 ? 2 : 4;
}

// dst[i] = a tile of rows rows x TS from src, whose rows are `stride`
// elements apart (a checkpoint slot, a boundary row, an adjoint), widened to
// fp32 from the storage type T (float, or bf16 boundaries: the float
// instantiation, the only one kernel 4m makes, is a plain copy).
template <int TS, int NT, typename T>
__device__ __forceinline__ void load_tile(const T* src, size_t stride,
                                          int tile, float* dst) {
  for (int i = threadIdx.x; i < tile; i += NT)
    dst[i] = plf::widen(src[(size_t)(i / TS) * stride + i % TS]);
}

// A tip's tile: the tip-table columns of the codes crow[0..TS) (a code
// outside the table gives zeros), the table read through the read-only
// cache.
template <int TS, int NT, typename CodeT>
__device__ __forceinline__ void expand_tip(const CodeT* crow,
                                           const float* ttab, int ncols,
                                           int tile, float* dst) {
  for (int i = threadIdx.x; i < tile; i += NT) {
    const int code = (int)crow[i % TS];
    const bool ok = code >= 0 && code < ncols;
    const float v = __ldg(ttab + (size_t)(i / TS) * ncols + (ok ? code : 0));
    dst[i] = ok ? v : 0.0f;
  }
}

// Phase 1's checkpoint of a recomputed tile O (node_tile's output, its
// rescale test in s_big): the slot dst, rows `stride` floats apart, gets O
// with the 2^32 rescale applied and flags[0..TS) the rescale flags; the
// first n_valid sites of the tile are real ones.
template <int TS, int NT>
__device__ __forceinline__ void checkpoint_tile(const float* O,
                                                const int* s_big, float* dst,
                                                size_t stride,
                                                unsigned char* flags,
                                                int n_valid, int tile) {
  for (int j = threadIdx.x; j < tile; j += NT) {
    const int ss = j % TS;
    const bool resc = !s_big[ss] && ss < n_valid;
    dst[(size_t)(j / TS) * stride + ss] =
        resc ? __fmul_rn(O[j], plf::TWO_TO_THE_32) : O[j];
  }
  if (threadIdx.x < TS)
    flags[threadIdx.x] =
        (!s_big[threadIdx.x] && (int)threadIdx.x < n_valid) ? 1 : 0;
}

// The seed of the root: s_grr[r] += sum over the tile's sites of x[r][s] *
// g[s] (x: the root CLV's tile, s_g: the cotangent), and the root's slot
// dst (rows `stride` apart) becomes its adjoint rr[r] * g[s].
template <int TS, int NT>
__device__ __forceinline__ void seed_root(const float* x, const float* s_g,
                                          float* s_grr, const float* rr,
                                          float* dst, size_t stride, int R) {
  for (int r = threadIdx.x; r < R; r += NT) {
    const float* xr = x + r * TS;
    float v = __fmul_rn(xr[0], s_g[0]);
    for (int k = 1; k < TS; ++k)
      v = __fadd_rn(v, __fmul_rn(xr[k], s_g[k]));
    s_grr[r] = __fadd_rn(s_grr[r], v);
  }
  for (int j = threadIdx.x; j < R * TS; j += NT)
    dst[(size_t)(j / TS) * stride + j % TS] =
        __fmul_rn(__ldg(rr + j / TS), s_g[j % TS]);
}

// g_y of a node for the tile: its adjoint (rows `stride` apart) times the
// rescale factor its flags record, into tG.
template <int TS, int NT>
__device__ __forceinline__ void load_adjoint(const float* adj, size_t stride,
                                             const unsigned char* fl,
                                             int tile, float* tG) {
  for (int j = threadIdx.x; j < tile; j += NT) {
    const int ss = j % TS;
    tG[j] = __fmul_rn(adj[(size_t)(j / TS) * stride + ss],
                      fl[ss] ? plf::TWO_TO_THE_32 : 1.0f);
  }
}

// u1, u2, g_p of one tile from x1 (tA), x2 (tB) and g_y (tG), and from them
// g_u1 (tU1), g_u2 (tU2) and p (tP).  lh..rl: the edge's operator planes;
// eTh/eTl: the transposed EV planes.  Ends at a barrier.
template <int MODE, int V, int TS, int NT>
__device__ __forceinline__ void sweep_products(
    const float* tA, const float* tB, const float* tG, float* tU1, float* tU2,
    float* tP, const float* lh, const float* ll, const float* rh,
    const float* rl, const float* eTh, const float* eTl, int S, int C) {
  const int s = threadIdx.x % TS;
  const int nj = NT / TS;
  const int jobs = C * ((S + kKB - 1) / kKB);
  for (int jb = threadIdx.x / TS; jb < jobs; jb += nj) {
    const int c = jb % C, o0 = (jb / C) * kKB;
    float u1[kKB], u2[kKB], gp[kKB];
    stage_block<MODE, V>(tA, TS, s, lh, ll, S, C, c, o0, u1);
    stage_block<MODE, V>(tB, TS, s, rh, rl, S, C, c, o0, u2);
    stage_block<MODE, V>(tG, TS, s, eTh, eTl, S, C, c, o0, gp);
#pragma unroll
    for (int k = 0; k < kKB; ++k) {
      if (o0 + k < S) {
        const int idx = ((o0 + k) * C + c) * TS + s;
        tU1[idx] = __fmul_rn(gp[k], u2[k]);
        tU2[idx] = __fmul_rn(gp[k], u1[k]);
        tP[idx] = __fmul_rn(u1[k], u2[k]);
      }
    }
  }
  __syncthreads();
}

// ---- the operator-gradient sums of a tile ----

// Two bf16 values in one register, a in the low half (the fragment order).
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float lo_part(float x) {
  return __fsub_rn(x, bf16r(x));
}

// A fragment register of two consecutive sites: hi = bf16(x) (rounded, as
// plf_mxu.py::bf16_round and bf16_split's hi) and, in MODE_BF16X3, lo =
// bf16(x - hi) (bf16_split's lo).
template <int MODE>
__device__ __forceinline__ void frag_pair(float2 v, uint32_t& hi,
                                          uint32_t& lo) {
  hi = bf16_pair(v.x, v.y);
  if constexpr (MODE == MODE_BF16X3)
    lo = bf16_pair(lo_part(v.x), lo_part(v.y));
}

// d += a * b on the tensor cores, fp32 accumulators: a 16 x K bf16 tile
// (row major; K = 16: 4 registers, K = 8: 2), b K x 8 (column major).
template <int K>
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t* a,
                                         const uint32_t* b) {
  if constexpr (K == 16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b[0]));
  }
}

// Row `row` of column c of a [row][site] tile at sites k.. (two as a
// float2, four as a float4); zeros past S.
template <int TS>
__device__ __forceinline__ float2 pair_at(const float* t, int row, int c,
                                          int C, int S, int k) {
  return row < S ? *reinterpret_cast<const float2*>(t + (row * C + c) * TS + k)
                 : make_float2(0.0f, 0.0f);
}
template <int TS>
__device__ __forceinline__ float4 quad_at(const float* t, int row, int c,
                                          int C, int S, int k) {
  return row < S ? *reinterpret_cast<const float4*>(t + (row * C + c) * TS + k)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One unit of G = gout_c . in_c^T over the tile: rows o0 .. o0 + 15 and
// columns q0 .. q0 + 31 as four 16 x 8 fragments nt (columns q0 + 8 nt ..);
// lane = 4 g + t holds rows g, g + 8 and columns 2t, 2t + 1 of each (entry
// i of fragment nt: row o0 + g + 8 (i >> 1), column q0 + 8 nt + 2t +
// (i & 1)).  dh gets the tile's sums (hh in MODE_BF16X3), dm the hl + lh
// sums; n_nt: the fragments with a column below S (warp-uniform).
template <int MODE, int TS>
__device__ __forceinline__ void unit_mma(const float* in, const float* go,
                                         int S, int C, int c, int o0, int q0,
                                         int n_nt, float (&dh)[4][4],
                                         float (&dm)[4][4]) {
  constexpr int K = TS % 16 == 0 ? 16 : 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < TS; k0 += K) {
    uint32_t ah[4], al[4];
    const int r0 = o0 + g, r1 = r0 + 8, k = k0 + 2 * t;
    frag_pair<MODE>(pair_at<TS>(go, r0, c, C, S, k), ah[0], al[0]);
    frag_pair<MODE>(pair_at<TS>(go, r1, c, C, S, k), ah[1], al[1]);
    if constexpr (K == 16) {
      frag_pair<MODE>(pair_at<TS>(go, r0, c, C, S, k + 8), ah[2], al[2]);
      frag_pair<MODE>(pair_at<TS>(go, r1, c, C, S, k + 8), ah[3], al[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt < n_nt) {
        const int q = q0 + 8 * nt + g;
        uint32_t bh[2], bl[2];
        frag_pair<MODE>(pair_at<TS>(in, q, c, C, S, k), bh[0], bl[0]);
        if constexpr (K == 16)
          frag_pair<MODE>(pair_at<TS>(in, q, c, C, S, k + 8), bh[1], bl[1]);
        mma_bf16<K>(dh[nt], ah, bh);  // gh * ih
        if constexpr (MODE == MODE_BF16X3) {
          mma_bf16<K>(dm[nt], ah, bl);  // gh * il
          mma_bf16<K>(dm[nt], al, bh);  // gl * ih
        }
      }
    }
  }
}

// The same unit in fp32 on the CUDA cores: each lane sums its own 16
// entries over the tile's sites, reading four sites of each of its two rows
// and eight columns as one float4.  Lane (g, t) starts at site 4 (g + 2t)
// and wraps around the tile: the eight lanes of each quarter-warp then read
// eight distinct 16-byte bank groups, where one site order for all would
// put rows TS floats apart on one group.
template <int TS>
__device__ __forceinline__ void unit_f32(const float* in, const float* go,
                                         int S, int C, int c, int o0, int q0,
                                         int n_nt, float (&d)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rot = 4 * (g + 2 * t);
#pragma unroll 2
  for (int k0 = 0; k0 < TS; k0 += 4) {
    const int k = (k0 + rot) % TS;
    const float4 a0 = quad_at<TS>(go, o0 + g, c, C, S, k);
    const float4 a1 = quad_at<TS>(go, o0 + g + 8, c, C, S, k);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt < n_nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 b = quad_at<TS>(in, q0 + 8 * nt + 2 * t + j, c, C, S, k);
          float& x0 = d[nt][j];      // row g
          float& x1 = d[nt][2 + j];  // row g + 8
          x0 = __fmaf_rn(a0.x, b.x, x0);
          x0 = __fmaf_rn(a0.y, b.y, x0);
          x0 = __fmaf_rn(a0.z, b.z, x0);
          x0 = __fmaf_rn(a0.w, b.w, x0);
          x1 = __fmaf_rn(a1.x, b.x, x1);
          x1 = __fmaf_rn(a1.y, b.y, x1);
          x1 = __fmaf_rn(a1.z, b.z, x1);
          x1 = __fmaf_rn(a1.w, b.w, x1);
        }
      }
    }
  }
}

// The tile's operator-gradient sums of (x1, g_u1), (x2, g_u2), (p, g_y)
// added to the edge's accumulators: matrix m, column c, unit (mt, nb) of
// 16 x 32 entries, taken by the block's warps in turn, so that every entry
// has one owner for the whole edge.  acc: 3*R*S floats, entry m*R*S +
// (o*C+c)*S + q.  Reads the six tiles; no barrier.
template <int MODE, int TS, int NT>
__device__ __forceinline__ void tile_sums(const float* tA, const float* tB,
                                          const float* tP, const float* tU1,
                                          const float* tU2, const float* tG,
                                          float* acc, int S, int C) {
  const int RS = S * C * S, n_mt = (S + 15) / 16, n_nb = (S + 31) / 32;
  const int per_m = C * n_mt * n_nb;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int kWarps = NT / 32;
  for (int u = threadIdx.x / 32; u < 3 * per_m; u += kWarps) {
    const int m = u / per_m, rem = u - m * per_m;
    const int c = rem % C, blk = rem / C;
    const int o0 = 16 * (blk / n_nb), q0 = 32 * (blk % n_nb);
    const int n_nt = min(4, (S - q0 + 7) / 8);
    const float* in = m == 0 ? tA : m == 1 ? tB : tP;
    const float* go = m == 0 ? tU1 : m == 1 ? tU2 : tG;
    float dh[4][4], dm[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) dh[nt][i] = dm[nt][i] = 0.0f;
    if constexpr (MODE == MODE_F32)
      unit_f32<TS>(in, go, S, C, c, o0, q0, n_nt, dh);
    else
      unit_mma<MODE, TS>(in, go, S, C, c, o0, q0, n_nt, dh, dm);
    float* a = acc + (size_t)m * RS;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = o0 + g + 8 * (i >> 1), q = q0 + 8 * nt + 2 * t + (i & 1);
        if (nt < n_nt && o < S && q < S) {
          const int e = (o * C + c) * S + q;
          a[e] = __fadd_rn(a[e], MODE == MODE_BF16X3
                                     ? __fadd_rn(dh[nt][i], dm[nt][i])
                                     : dh[nt][i]);
        }
      }
    }
  }
}

// The adjoints S1(g_u1; L^T) and S1(g_u2; R^T) of a node's two children for
// the tile, into dl[row * sl + site] and dr[row * sr + site] (lTh..rTl: the
// edge's transposed planes); a null destination (a tip child, whose
// adjoint is never formed) is skipped.  Both sides share each job's (c, o0)
// loop, as the sweep's other stages do.
template <int MODE, int V, int TS, int NT>
__device__ __forceinline__ void adjoint_to(const float* tU1, const float* tU2,
                                           const float* lTh, const float* lTl,
                                           const float* rTh, const float* rTl,
                                           float* dl, size_t sl, float* dr,
                                           size_t sr, int S, int C) {
  if (!dl && !dr) return;
  const int s = threadIdx.x % TS;
  const int nj = NT / TS;
  const int jobs = C * ((S + kKB - 1) / kKB);
  for (int jb = threadIdx.x / TS; jb < jobs; jb += nj) {
    const int c = jb % C, o0 = (jb / C) * kKB;
    float o[kKB];
    for (int side = 0; side < 2; ++side) {
      float* dst = side ? dr : dl;
      if (!dst) continue;
      stage_block<MODE, V>(side ? tU2 : tU1, TS, s, side ? rTh : lTh,
                           side ? rTl : lTl, S, C, c, o0, o);
      const size_t stride = side ? sr : sl;
#pragma unroll
      for (int k = 0; k < kKB; ++k)
        if (o0 + k < S) dst[(size_t)((o0 + k) * C + c) * stride + s] = o[k];
    }
  }
}

// gl[eo] and gr[eo] are complete for this block's sites: write them once,
// in output order j = m*RS + r*S + q, the accumulators' own, into the
// block's partial row `part` (2*E*RS + RS + R
// floats: gl by edge, gr by edge, gec, grr), and add this edge's gec share
// to the block's running gec; zero the accumulators.  init_edge / init_gec
// write instead of adding.  Call after the barrier that ends the edge's
// last tile; the next edge's first barrier orders the zeroing before its
// sums.
template <int NT>
__device__ __forceinline__ void flush_edge(float* acc, float* part, int E,
                                           int S, int C, int eo,
                                           bool init_edge, bool init_gec) {
  const int RS = S * C * S;
  for (int j = threadIdx.x; j < 3 * RS; j += NT) {
    const int m = j / RS, rem = j - m * RS;
    const float v = acc[j];
    float* d = m < 2 ? part + (size_t)m * E * RS + (size_t)eo * RS + rem
                     : part + (size_t)2 * E * RS + rem;
    const bool init = m < 2 ? init_edge : init_gec;
    *d = init ? v : __fadd_rn(*d, v);
    acc[j] = 0.0f;
  }
}

// Dynamic shared memory of one block: six tiles of TS sites (x1, x2, g_y,
// g_u1, g_u2, p), the rescale flags and cotangent of a tile, the grr sums
// and, when acc_shared, the 3*R*S accumulators.
inline size_t bwd_smem_bytes(int R, int S, bool acc_shared, int TS) {
  return sizeof(float) * ((size_t)6 * R * TS + 2 * TS + R +
                          (acc_shared ? (size_t)3 * R * S : 0));
}

template <typename K>
cudaError_t bwd_prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Resident blocks per SM of an instance of NT threads on tiles of TS sites
// with its accumulators in shared memory or not (0 where its shared memory
// exceeds a block's).
template <typename K>
int bwd_fit(K kernel, int R, int S, bool acc_shared, int TS, int NT,
            int* blocks) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  *blocks = 0;
  const size_t smem = bwd_smem_bytes(R, S, acc_shared, TS);
  if (smem > (size_t)optin) return 0;
  err = bwd_prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            NT, smem);
}

// The plan of a launch: the accumulators in shared memory when two blocks
// with them fit an SM, else in device memory (at S = 61 they are 178 KB: one
// block per SM could not hide the latency of its sums).  Each kernel plans
// with its bwd_tile(S) and bwd_threads, which keep shared memory at S = 20
// (two blocks of 320 threads) and take device memory at S = 61.
template <typename K>
int bwd_plan(K kernel, int R, int S, int* acc_shared, int* blocks, int TS,
             int NT) {
  const int err = bwd_fit(kernel, R, S, true, TS, NT, blocks);
  if (err != 0) return err;
  *acc_shared = *blocks >= 2;
  return *acc_shared ? 0 : bwd_fit(kernel, R, S, false, TS, NT, blocks);
}

}  // namespace plf_mxu

// Instantiate F<MODE, V, TS>(...) of kernels 4m and 8m for a run-time mode
// and state count: TS = bwd_tile(states), with V = 4 (float4 operator
// loads) on 32-site tiles, 1 on 8-site tiles.
#define PLF_MXU_BWD_DISPATCH(mode, states, ...)                              \
  do {                                                                       \
    const bool wide_ = plf_mxu::bwd_tile(states) == 32;                      \
    if ((mode) < 0 || (mode) > 2) return (int)cudaErrorInvalidValue;         \
    if ((mode) == 0 && wide_) { constexpr int M_ = 0, V_ = 4, T_S = 32; __VA_ARGS__; } \
    else if ((mode) == 0) { constexpr int M_ = 0, V_ = 1, T_S = 8; __VA_ARGS__; } \
    else if ((mode) == 1 && wide_) { constexpr int M_ = 1, V_ = 4, T_S = 32; __VA_ARGS__; } \
    else if ((mode) == 1) { constexpr int M_ = 1, V_ = 1, T_S = 8; __VA_ARGS__; } \
    else if (wide_) { constexpr int M_ = 2, V_ = 4, T_S = 32; __VA_ARGS__; } \
    else { constexpr int M_ = 2, V_ = 1, T_S = 8; __VA_ARGS__; }            \
  } while (0)
