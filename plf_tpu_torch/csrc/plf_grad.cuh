// Operator-gradient site sums, shared by the backward kernels (3 and 4).
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
// So: a block works through tiles of kGradThreads sites; after each tile its
// threads put the six operands of their sites into a shared-memory staging
// area, and thread e sums entry e over the tile's sites in site order
// (op_grad_tile) into a register; each block writes its per-entry partials to
// a (blocks, entries) array, and colsum_kernel adds those up in block order.
// No float atomics: two runs with the same inputs are bit-identical.  The
// 3*S*C*S = 192 entries (at S = C = 4) are spread over the block's 128 threads
// (two each at most), since 192 accumulators per thread would not fit the
// register file.  The tile width T is a template parameter (kernel 8 runs
// 32-site tiles); its default is kernels 3 and 4's kGradThreads.
#pragma once

#include "plf_common.cuh"

namespace plf {

constexpr int kGradThreads = 128;              // threads per block = sites per tile
constexpr int kStagePitch = kGradThreads + 1;  // row pitch: rows fall in distinct banks

// Accumulators per thread for the 3*R*S entries of one PLF step.
template <int C, int T = kGradThreads>
__host__ __device__ constexpr int grad_slots() {
  return (3 * S * C * S + T - 1) / T;
}

// Dynamic shared memory of the staging area: six (S*C, T + 1) arrays.
template <int C, int T = kGradThreads>
constexpr size_t grad_stage_bytes() {
  return sizeof(float) * 6 * S * C * (T + 1);
}

// Column tid of staging array `arr`: arrays (0, 1) = (x1, g_u1),
// (2, 3) = (x2, g_u2), (4, 5) = (p, g_y).  Rows are T + 1 floats apart, so
// they fall in distinct banks.
template <int C, int T = kGradThreads>
__device__ __forceinline__ void stage_put(float* st, int arr,
                                          const float (&v)[S * C], int tid) {
  float* d = st + (size_t)arr * S * C * (T + 1) + tid;
#pragma unroll
  for (int r = 0; r < S * C; ++r) d[r * (T + 1)] = v[r];
}

// Entry e = m*R*S + r*S + a: add the tile's sum over sites (in site order, each
// product rounded, then each sum) of in_m[a*C + r%C][s] * gout_m[r][s] to
// acc[j], for the entries e = tid + j*T this thread owns.  Call between two
// __syncthreads(): after the staging writes, before the next.
template <int C, int T = kGradThreads>
__device__ __forceinline__ void op_grad_tile(const float* st, int tid,
                                             float (&acc)[grad_slots<C, T>()]) {
  constexpr int R = S * C, RS = R * S;
#pragma unroll
  for (int j = 0; j < grad_slots<C, T>(); ++j) {
    const int e = tid + j * T;
    if (e >= 3 * RS) break;
    const int m = e / RS, rem = e - m * RS;
    const int r = rem / S, a = rem - r * S;
    const float* in = st + ((size_t)(2 * m) * R + a * C + r % C) * (T + 1);
    const float* gout = st + ((size_t)(2 * m + 1) * R + r) * (T + 1);
    float t = __fmul_rn(in[0], gout[0]);
    for (int s = 1; s < T; ++s)
      t = __fadd_rn(t, __fmul_rn(in[s], gout[s]));
    acc[j] = __fadd_rn(acc[j], t);
  }
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

}  // namespace plf
