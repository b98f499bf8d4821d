// The reverse sweep of the matrix-form backward kernels on 8-site tiles,
// shared by kernel 4m (plf_tree_bwd_mxu.cu, the whole tree) and kernel 8m
// (plf_tree_seg_bwd_mxu.cu, segment by segment).
//
// One PLF step of the sweep, for one tile of kSites sites of a node whose
// children x1, x2 and parent adjoint g_y (already multiplied by the rescale
// factor) sit in shared-memory [row][site] tiles:
//
//   u1 = S1(x1; L), u2 = S1(x2; R), g_p = S3(g_y; E^T)   (sweep_products)
//   g_u1 = g_p * u2, g_u2 = g_p * u1, p = u1 * u2
//   acc[e] += tile sums of the three operator gradients   (sweep_sums)
//   the children's adjoints S1(g_u1; L^T), S1(g_u2; R^T)  (adjoint_to)
//
// every stage in the mode's arithmetic (plf_mxu.cuh's stage_block), the
// operator gradients the lane-constant entries g[o*C+c][q] = sum_s
// in[q*C+c][s] * gout[o*C+c][s] of the JAX kernel's (rows, rows) block
// gradients gout @ in^T, in the mode's arithmetic (tile_dot).  A block keeps
// the accumulators of the edge it sweeps (gl, gr and its gec share, 3*R*S
// floats) in shared memory when two such blocks fit an SM, else in a private
// row of device memory (plan); flush_edge writes them into the block's row
// of partial sums once the edge is done, and plf::colsum adds the rows up in
// a fixed order.  No float atomics: two runs are bit-identical.
#pragma once

#include "plf_grad.cuh"
#include "plf_mxu.cuh"

namespace plf_mxu {

// Threads per block (a compile-time constant in every loop below: with the
// block size read at run time instead, kernel 4m's fp32 and bf16 modes ran
// 22-29% slower on an H100) and sites per tile.
constexpr int kBwdThreads = 128;
constexpr int kBwdSites = 8;  // TS

// One tile row (kBwdSites = 8 floats, 32-byte aligned) as two float4 loads.
__device__ __forceinline__ void load_row(const float* p,
                                         float (&v)[kBwdSites]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// sum over the tile's sites of in[s] * go[s] in the arithmetic of MODE.
template <int MODE>
__device__ __forceinline__ float tile_dot(const float* in_row,
                                          const float* go_row) {
  float in[kBwdSites], go[kBwdSites];
  load_row(in_row, in);
  load_row(go_row, go);
  float hh = -0.0f, hl = -0.0f, lh = -0.0f;  // -0 + x == x
#pragma unroll
  for (int s = 0; s < kBwdSites; ++s) {
    if constexpr (MODE == MODE_F32) {
      hh = __fadd_rn(hh, __fmul_rn(in[s], go[s]));
    } else if constexpr (MODE == MODE_BF16) {
      hh = __fadd_rn(hh, __fmul_rn(bf16r(in[s]), bf16r(go[s])));
    } else {
      const float ih = bf16r(in[s]), il = bf16r(__fsub_rn(in[s], ih));
      const float gh = bf16r(go[s]), gl = bf16r(__fsub_rn(go[s], gh));
      hh = __fadd_rn(hh, __fmul_rn(gh, ih));
      hl = __fadd_rn(hl, __fmul_rn(gh, il));
      lh = __fadd_rn(lh, __fmul_rn(gl, ih));
    }
  }
  return MODE == MODE_BF16X3 ? __fadd_rn(hh, __fadd_rn(hl, lh)) : hh;
}

// dst[i] = a tile of rows rows x kBwdSites from src, whose rows are
// `stride` floats apart (a checkpoint slot, a boundary row, an adjoint).
__device__ __forceinline__ void load_tile(const float* src, size_t stride,
                                          int tile, float* dst) {
  for (int i = threadIdx.x; i < tile; i += kBwdThreads)
    dst[i] = src[(size_t)(i / kBwdSites) * stride + i % kBwdSites];
}

// A tip's tile: the tip-table columns of the codes crow[0..kBwdSites) (a
// code outside the table gives zeros), the table read through the
// read-only cache.
template <typename CodeT>
__device__ __forceinline__ void expand_tip(const CodeT* crow,
                                           const float* ttab, int ncols,
                                           int tile, float* dst) {
  for (int i = threadIdx.x; i < tile; i += kBwdThreads) {
    const int code = (int)crow[i % kBwdSites];
    const bool ok = code >= 0 && code < ncols;
    const float v = __ldg(ttab + (size_t)(i / kBwdSites) * ncols +
                          (ok ? code : 0));
    dst[i] = ok ? v : 0.0f;
  }
}

// Phase 1's checkpoint of a recomputed tile O (node_tile's output, its
// rescale test in s_big): the slot dst, rows `stride` floats apart, gets O
// with the 2^32 rescale applied and flags[0..kBwdSites) the rescale flags;
// the first n_valid sites of the tile are real ones.
__device__ __forceinline__ void checkpoint_tile(const float* O,
                                                const int* s_big, float* dst,
                                                size_t stride,
                                                unsigned char* flags,
                                                int n_valid, int tile) {
  for (int j = threadIdx.x; j < tile; j += kBwdThreads) {
    const int ss = j % kBwdSites;
    const bool resc = !s_big[ss] && ss < n_valid;
    dst[(size_t)(j / kBwdSites) * stride + ss] =
        resc ? __fmul_rn(O[j], plf::TWO_TO_THE_32) : O[j];
  }
  if (threadIdx.x < kBwdSites)
    flags[threadIdx.x] =
        (!s_big[threadIdx.x] && (int)threadIdx.x < n_valid) ? 1 : 0;
}

// The seed of the root: s_grr[r] += sum over the tile's sites of x[r][s] *
// g[s] (x: the root CLV's tile, s_g: the cotangent), and the root's slot
// dst (rows `stride` apart) becomes its adjoint rr[r] * g[s].
__device__ __forceinline__ void seed_root(const float* x, const float* s_g,
                                          float* s_grr, const float* rr,
                                          float* dst, size_t stride, int R) {
  for (int r = threadIdx.x; r < R; r += kBwdThreads) {
    const float* xr = x + r * kBwdSites;
    float v = __fmul_rn(xr[0], s_g[0]);
    for (int k = 1; k < kBwdSites; ++k)
      v = __fadd_rn(v, __fmul_rn(xr[k], s_g[k]));
    s_grr[r] = __fadd_rn(s_grr[r], v);
  }
  for (int j = threadIdx.x; j < R * kBwdSites; j += kBwdThreads)
    dst[(size_t)(j / kBwdSites) * stride + j % kBwdSites] =
        __fmul_rn(__ldg(rr + j / kBwdSites), s_g[j % kBwdSites]);
}

// g_y of a node for the tile: its adjoint (rows `stride` apart) times the
// rescale factor its flags record, into tG.
__device__ __forceinline__ void load_adjoint(const float* adj, size_t stride,
                                             const unsigned char* fl,
                                             int tile, float* tG) {
  for (int j = threadIdx.x; j < tile; j += kBwdThreads) {
    const int ss = j % kBwdSites;
    tG[j] = __fmul_rn(adj[(size_t)(j / kBwdSites) * stride + ss],
                      fl[ss] ? plf::TWO_TO_THE_32 : 1.0f);
  }
}

// u1, u2, g_p of one tile from x1 (tA), x2 (tB) and g_y (tG), and from them
// g_u1 (tU1), g_u2 (tU2) and p (tP).  lh..rl: the edge's operator planes;
// eTh/eTl: the transposed EV planes.  Ends at a barrier.
template <int MODE, int V>
__device__ __forceinline__ void sweep_products(
    const float* tA, const float* tB, const float* tG, float* tU1, float* tU2,
    float* tP, const float* lh, const float* ll, const float* rh,
    const float* rl, const float* eTh, const float* eTl, int S, int C) {
  const int s = threadIdx.x % kBwdSites;
  const int nj = kBwdThreads / kBwdSites;
  const int jobs = C * ((S + KB - 1) / KB);
  for (int jb = threadIdx.x / kBwdSites; jb < jobs; jb += nj) {
    const int c = jb % C, o0 = (jb / C) * KB;
    float u1[KB], u2[KB], gp[KB];
    stage_block<MODE, V>(tA, kBwdSites, s, lh, ll, S, C, c, o0, u1);
    stage_block<MODE, V>(tB, kBwdSites, s, rh, rl, S, C, c, o0, u2);
    stage_block<MODE, V>(tG, kBwdSites, s, eTh, eTl, S, C, c, o0, gp);
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (o0 + k < S) {
        const int idx = ((o0 + k) * C + c) * kBwdSites + s;
        tU1[idx] = __fmul_rn(gp[k], u2[k]);
        tU2[idx] = __fmul_rn(gp[k], u1[k]);
        tP[idx] = __fmul_rn(u1[k], u2[k]);
      }
    }
  }
  __syncthreads();
}

// acc[ent] += the tile's sum of entry ent = m*RS + q*R + r of the three
// operator gradients, (x1, g_u1), (x2, g_u2), (p, g_y) for m = 0, 1, 2.  A
// thread owns the entries tid + k * kBwdThreads, r fastest: a warp then reads
// C input rows (broadcast) and consecutive gradient rows, where q fastest
// would put its input rows q*C + r%C, 32 floats apart, on one bank.
template <int MODE>
__device__ __forceinline__ void sweep_sums(const float* tA, const float* tB,
                                           const float* tP, const float* tU1,
                                           const float* tU2, const float* tG,
                                           float* acc, int S, int C) {
  const int R = S * C, RS = R * S;
  for (int ent = threadIdx.x; ent < 3 * RS; ent += kBwdThreads) {
    const int m = ent / RS, rem = ent - m * RS;
    const int q = rem / R, r = rem - q * R;
    const float* in = (m == 0 ? tA : m == 1 ? tB : tP) +
                      (q * C + r % C) * kBwdSites;
    const float* go = (m == 0 ? tU1 : m == 1 ? tU2 : tG) + r * kBwdSites;
    acc[ent] = __fadd_rn(acc[ent], tile_dot<MODE>(in, go));
  }
}

// The adjoints S1(g_u1; L^T) and S1(g_u2; R^T) of a node's two children for
// the tile, into dl[row * sl + site] and dr[row * sr + site] (lTh..rTl: the
// edge's transposed planes); a null destination (a tip child, whose
// adjoint is never formed) is skipped.  Both sides share each job's (c, o0)
// loop, as the sweep's other stages do.
template <int MODE, int V>
__device__ __forceinline__ void adjoint_to(const float* tU1, const float* tU2,
                                           const float* lTh, const float* lTl,
                                           const float* rTh, const float* rTl,
                                           float* dl, size_t sl, float* dr,
                                           size_t sr, int S, int C) {
  if (!dl && !dr) return;
  const int s = threadIdx.x % kBwdSites;
  const int nj = kBwdThreads / kBwdSites;
  const int jobs = C * ((S + KB - 1) / KB);
  for (int jb = threadIdx.x / kBwdSites; jb < jobs; jb += nj) {
    const int c = jb % C, o0 = (jb / C) * KB;
    float o[KB];
    for (int side = 0; side < 2; ++side) {
      float* dst = side ? dr : dl;
      if (!dst) continue;
      stage_block<MODE, V>(side ? tU2 : tU1, kBwdSites, s, side ? rTh : lTh,
                           side ? rTl : lTl, S, C, c, o0, o);
      const size_t stride = side ? sr : sl;
#pragma unroll
      for (int k = 0; k < KB; ++k)
        if (o0 + k < S) dst[(size_t)((o0 + k) * C + c) * stride + s] = o[k];
    }
  }
}

// gl[eo] and gr[eo] are complete for this block's sites: write them once, in
// output order (j = m*RS + r*S + q, coalesced) into the block's partial row
// `part` (2*E*RS + RS + R floats: gl by edge, gr by edge, gec, grr), and add
// this edge's gec share to the block's running gec; zero the accumulators.
// init_edge / init_gec write instead of adding.  Call after the barrier that
// ends the edge's last tile; the next edge's first barrier orders the
// zeroing before its sums.
__device__ __forceinline__ void flush_edge(float* acc, float* part, int E,
                                           int S, int C, int eo,
                                           bool init_edge, bool init_gec) {
  const int R = S * C, RS = R * S;
  for (int j = threadIdx.x; j < 3 * RS; j += kBwdThreads) {
    const int m = j / RS, rem = j - m * RS;
    const int r = rem / S, q = rem - r * S;
    const int ent = m * RS + q * R + r;
    float* d = m < 2 ? part + (size_t)m * E * RS + (size_t)eo * RS + rem
                     : part + (size_t)2 * E * RS + rem;
    const bool init = m < 2 ? init_edge : init_gec;
    *d = init ? acc[ent] : __fadd_rn(*d, acc[ent]);
    acc[ent] = 0.0f;
  }
}

// Dynamic shared memory of one block: six tiles (x1, x2, g_y, g_u1, g_u2,
// p), the rescale flags and cotangent of a tile, the grr sums and, when
// acc_shared, the 3*R*S accumulators.
inline size_t bwd_smem_bytes(int R, int S, bool acc_shared) {
  return sizeof(float) * ((size_t)6 * R * kBwdSites + 2 * kBwdSites + R +
                          (acc_shared ? (size_t)3 * R * S : 0));
}

template <typename K>
cudaError_t bwd_prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename K>
cudaError_t bwd_occupancy(K kernel, int R, int S, bool acc_shared,
                          int* blocks) {
  const size_t smem = bwd_smem_bytes(R, S, acc_shared);
  cudaError_t err = bwd_prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       kBwdThreads, smem);
}

// The accumulators' place and the resident blocks per SM that follow: in
// shared memory when two blocks with them fit an SM, else in device memory
// (at S = 61 they are 178 KB: one block of 4 warps per SM could not hide
// the latency of its serial sums).
template <typename K>
int bwd_plan(K kernel, int R, int S, int* acc_shared, int* blocks) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  *acc_shared = 0;
  if (bwd_smem_bytes(R, S, true) <= (size_t)optin) {
    err = bwd_occupancy(kernel, R, S, true, blocks);
    if (err != cudaSuccess) return (int)err;
    if (*blocks >= 2) {
      *acc_shared = 1;
      return 0;
    }
  }
  return (int)bwd_occupancy(kernel, R, S, false, blocks);
}

}  // namespace plf_mxu
