// Operator-gradient site sums, shared by the backward kernels (3, 4 and 8).
//
// Each backward PLF step gives, per site, three (S*C, S) operator-gradient
// contributions (plf_tpu/ops/plf_grad.py::_op_grad):
//
//   d(op_m)[r][a] = in_m[a*C + r%C] * gout_m[r]     m = 0: (x1, g_u1)  -> lc
//                                                   m = 1: (x2, g_u2)  -> rc
//                                                   m = 2: (p,  g_y)   -> ec
//
// summed over every site.  On the TPU the grid runs in order and the sums are
// carried across grid steps in VMEM; thread blocks on the GPU run in no order.
// So each warp sums its own 32 sites, each block writes its sums to its own
// row of a (blocks, entries) array, and colsum_kernel (colsum64_kernel) adds
// the rows up in row order.  No float atomics: two runs with the same inputs
// are bit-identical.
//
// One warp, one m (warp_stage, warp_grad_sum, group8_sum16): each lane puts
// its site's in_m and gout_m rows into the warp's own staging area, two
// (S*C, 32) arrays [row][site], and after a __syncwarp lane (c % 4)*8 + g
// takes category c (in pass c / 4) over sites 4g..4g+3: the 16 entries
// (k, a), r = k*C + c, from one float4 of each in row a*C + c and gout row
// k*C + c, each product and its sum one __fmaf_rn, sites in order.  A lane
// reads 8 float4 for 64 products; the 8 lanes of a quarter-warp read one
// 128-byte row segment, and a warp's store of a row is one 128-byte row: no
// bank conflicts.  group8_sum16 then adds up the 8 lanes of a category in a
// fixed butterfly of shuffles, which leaves entries 2g and 2g + 1 with lane
// g (warp_op_grad: one m of one warp's 32 sites).  Per lane and m that is
// 2*S*C stores, 8 float4 loads, 64 FMAs and a 14-shuffle butterfly for 64
// products and sums, with no dependent chain longer than four sites.  The
// kernels add such per-warp sums of one op and one tile into fp32 running
// sums, op by op (a lane's chain of 4-site sums over every op lands ~8e-7 of
// scale from the exact gec on a 60-taxon tree, a per-op sum ~1.4e-7).  The
// sums contract and run in another order than the plain versions', so they
// agree with them to a tolerance; every per-site value the kernels compute
// keeps the golden model's order.
#pragma once

#include "plf_common.cuh"

namespace plf {

constexpr int kGradThreads = 128;   // threads per block = sites per tile (kernels 3, 4)
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Passes of warp_grad_sum: a warp takes 4 categories at a time.
template <int C>
__host__ __device__ constexpr int grad_passes() {
  return (C + 3) / 4;
}

// Floats of one warp's staging area: two (S*C, 32) arrays.
template <int C>
__host__ __device__ constexpr int warp_stage_floats() {
  return 2 * S * C * kWarp;
}

// Lane `lane` puts its site's x into rows [0, S*C) and g into rows
// [S*C, 2*S*C) of the warp's staging area st.
template <int C>
__device__ __forceinline__ void warp_stage(float* st, const float (&x)[S * C],
                                           const float (&g)[S * C],
                                           int lane) {
  constexpr int R = S * C;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    st[r * kWarp + lane] = x[r];
    st[(R + r) * kWarp + lane] = g[r];
  }
}

// acc[q][k*S + a] += sum over sites 4g..4g+3 (in order) of
// x[a*C + c][s] * g[k*C + c][s], for lane (c % 4)*8 + g and c = lane/8 + 4q
// (lanes whose c is past C add nothing).  Call between two __syncwarp():
// after warp_stage, before the area is staged again.
template <int C>
__device__ __forceinline__ void warp_grad_sum(
    const float* st, int lane, float (&acc)[grad_passes<C>()][S * S]) {
  constexpr int R = S * C;
  const int g4 = 4 * (lane & 7);
#pragma unroll
  for (int q = 0; q < grad_passes<C>(); ++q) {
    const int c = (lane >> 3) + 4 * q;
    if (c >= C) continue;
    float4 x[S], g[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      x[j] = *reinterpret_cast<const float4*>(st + (j * C + c) * kWarp + g4);
      g[j] = *reinterpret_cast<const float4*>(st + (R + j * C + c) * kWarp +
                                              g4);
    }
#pragma unroll
    for (int k = 0; k < S; ++k) {
#pragma unroll
      for (int a = 0; a < S; ++a) {
        float t = acc[q][k * S + a];
        t = __fmaf_rn(x[a].x, g[k].x, t);
        t = __fmaf_rn(x[a].y, g[k].y, t);
        t = __fmaf_rn(x[a].z, g[k].z, t);
        t = __fmaf_rn(x[a].w, g[k].w, t);
        acc[q][k * S + a] = t;
      }
    }
  }
}

// The sums over the 8 lanes of each group (lanes 8j..8j+7) of v[0..15], by a
// fixed butterfly: lane 8j + g gets those of v[2g] and v[2g + 1].  Every lane
// of the warp calls it.
__device__ __forceinline__ float2 group8_sum16(const float (&v)[S * S],
                                               int lane) {
  float w[8], y[4], z[2];
  bool up = lane & 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float send = up ? v[j] : v[j + 8];
    const float keep = up ? v[j + 8] : v[j];
    w[j] = __fadd_rn(keep, __shfl_xor_sync(kFullMask, send, 4));
  }
  up = lane & 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = up ? w[j] : w[j + 4];
    const float keep = up ? w[j + 4] : w[j];
    y[j] = __fadd_rn(keep, __shfl_xor_sync(kFullMask, send, 2));
  }
  up = lane & 1;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = up ? y[j] : y[j + 2];
    const float keep = up ? y[j + 2] : y[j];
    z[j] = __fadd_rn(keep, __shfl_xor_sync(kFullMask, send, 1));
  }
  return make_float2(z[0], z[1]);
}

// One m of one warp: stage (x, g), sum its 32 sites, and leave lane 8j + g
// of pass q with entries 2g, 2g + 1 of category j + 4q (grad_entry).
template <int C>
__device__ __forceinline__ void warp_op_grad(float* st,
                                             const float (&x)[S * C],
                                             const float (&g)[S * C],
                                             int lane,
                                             float2 (&out)[grad_passes<C>()]) {
  float acc[grad_passes<C>()][S * S];
#pragma unroll
  for (int q = 0; q < grad_passes<C>(); ++q)
#pragma unroll
    for (int j = 0; j < S * S; ++j) acc[q][j] = 0.0f;
  warp_stage<C>(st, x, g, lane);
  __syncwarp();
  warp_grad_sum<C>(st, lane, acc);
  __syncwarp();
#pragma unroll
  for (int q = 0; q < grad_passes<C>(); ++q) out[q] = group8_sum16(acc[q], lane);
}

// Ask for the 128-byte line at p to be brought into L2 ahead of its load.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Offset r*S + a in an (S*C, S) matrix of entry v (0 or 1) that
// group8_sum16 leaves with `lane` in pass q; -1 if the lane's category is
// past C.
template <int C>
__device__ __forceinline__ int grad_entry(int lane, int q, int v) {
  const int c = (lane >> 3) + 4 * q;
  const int kk = 2 * (lane & 7) + v;
  return c < C ? ((kk / S) * C + c) * S + kk % S : -1;
}

// The root-vector gradient of one warp: lanes r < S*C add to acc the sum over
// the warp's sites, in order, of x[r][s] * g[s].  st is the warp's staging
// area.
template <int C>
__device__ __forceinline__ void warp_root_grad(float* st,
                                               const float (&x)[S * C],
                                               float g, int lane,
                                               float& acc) {
  constexpr int R = S * C;
#pragma unroll
  for (int r = 0; r < R; ++r) st[r * kWarp + lane] = x[r];
  st[R * kWarp + lane] = g;
  __syncwarp();
  if (lane < R) {
#pragma unroll
    for (int s = 0; s < kWarp; s += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(st + lane * kWarp + s);
      const float4 gv = *reinterpret_cast<const float4*>(st + R * kWarp + s);
      acc = __fadd_rn(acc, __fmul_rn(xv.x, gv.x));
      acc = __fadd_rn(acc, __fmul_rn(xv.y, gv.y));
      acc = __fadd_rn(acc, __fmul_rn(xv.z, gv.z));
      acc = __fadd_rn(acc, __fmul_rn(xv.w, gv.w));
    }
  }
  __syncwarp();
}

// Second pass: out[c] = part[0][c] + part[1][c] + ... in row order.
static __global__ void colsum_kernel(const float* part, int rows, int cols,
                                     float* out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float acc = part[c];
  for (int b = 1; b < rows; ++b) acc = __fadd_rn(acc, part[(size_t)b * cols + c]);
  out[c] = acc;
}

inline int colsum(const float* part, int rows, int cols, float* out,
                  cudaStream_t st) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  colsum_kernel<<<(cols + 255) / 256, 256, 0, st>>>(part, rows, cols, out);
  return (int)cudaGetLastError();
}

// The same pass accumulated in fp64 and rounded once (the segmented
// kernels' second pass: their rows are a wave of blocks' sums).
static __global__ void colsum64_kernel(const float* part, int rows, int cols,
                                       float* out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  double acc = 0.0;
  for (int b = 0; b < rows; ++b) acc += (double)part[(size_t)b * cols + c];
  out[c] = (float)acc;
}

inline int colsum64(const float* part, int rows, int cols, float* out,
                    cudaStream_t st) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  colsum64_kernel<<<(cols + 255) / 256, 256, 0, st>>>(part, rows, cols, out);
  return (int)cudaGetLastError();
}

}  // namespace plf
