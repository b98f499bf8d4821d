// The matrix ("MXU") forms of one PLF node on a tile of sites in shared
// memory, shared by kernel 1m (plf_node_mxu.cu), kernel 2m
// (plf_tree_mxu.cu), kernel 7m (plf_tree_seg_mxu.cu) and the sweeps of
// kernels 3m, 4m and 8m (plf_mxu_bwd.cuh).
//
// The TPU kernels run each PLF stage as a (rows, rows) @ (rows, sites) matrix
// product against block operators that are zero across categories
// (plf_tpu/ops/layout.py:105-140).  Their non-zero entries are exactly the
// (rows, S) lane constants K[o*C+c][q] that the port stores, adding exact
// zeros changes no fp32 sum, and the bf16 split of 0 is 0.  So each product
// is, for every output row o*C+c,
//
//     out[o*C+c] = sum_q src[q*C+c] * K[o*C+c][q],   q = 0..S-1 in order
//
// (stage 1: o = k, q = a, K = Lc; stage 3: o = a, q = k, K = Ec): 2*S
// multiplies and adds per output, 6*C*S^2 flops per site and node (9,600 at
// S = 20, C = 4) instead of the dense product's 6*C^2*S^2.  Three arithmetic
// modes, the variant's MXU pass count (plf_tpu/ops/plf_pallas.py:123-160):
//
//   MODE_F32     "mxu" (and "vpu" at S != 4): separately rounded fp32
//                products and sums in q order, the golden model's arithmetic;
//   MODE_BF16X3  "mxu_3x": src and K split into bf16 hi + lo; three fp32 sums
//                hh = sum sh*Kh, hl = sum sl*Kh, lh = sum sh*Kl, combined as
//                hh + (hl + lh), the order of _dot_bf16x3.  A product of two
//                bf16 values is exact in fp32, so only the sums round;
//   MODE_BF16    "mxu_bf16": src and K rounded to bf16, fp32 sums.
//
// K arrives from the host already split (hi and lo planes) or rounded; the
// kernel splits or rounds each src value once per block of KB outputs.  Every
// product and sum is __fmul_rn / __fadd_rn, never contracted, so the result
// equals the plain PyTorch version (ops/plf_mxu.py::node_mxu_plain) bit for
// bit in every mode.
//
// Threads and tiles: a tile is rows x TS floats laid out [row][site]; thread t
// owns site t % TS (TS divides 32: a warp serves 32 / TS jobs at once, each
// reading TS consecutive words of a row) and takes the jobs j = t / TS,
// t / TS + T / TS, ...; a job is one category c and one block of KB output
// rows o0 .. o0+KB-1, so each loaded src value feeds KB outputs and each
// operator load is a float4 over 4 consecutive q (V = 4, S % 4 == 0) at an
// address uniform over the TS threads of the job (a broadcast from L1).
// A stage has C * ceil(S / KB) jobs for the block's T / TS job slots: the
// job shape (KB, and the block size the kernel launches with) decides in
// how many rounds they run.  KB is a template parameter (default kKB = 4,
// the shape of kernels 4m, 8m and 9; kernels 1m, 2m and 7m take the job
// shape below); the job's arithmetic, each output's sum in q order, does
// not depend on it.
//
// The job shape of kernels 1m, 2m and 7m (block_threads, job_rows): KB = 4
// output rows per job where S % 4 == 0, else 5, and one job slot of TS
// threads per job of a stage, in the fewest rounds of at most kMaxThreads /
// TS slots (S = 20, C = 4 on kSites = 8-site tiles: 20 jobs, 160 threads,
// one round; S = 61: 52 five-row jobs, 416 threads; S = 4: 4 jobs, 32
// threads).  On an H100 (PERF.md) this ran kernel 2m's "mxu_3x" 24.6
// ms at 64 x 131,072 where 128 threads of 4-row jobs ran 31.9, and 5-row
// jobs the S = 61 fp32 forward 22% faster than 4-row jobs.
#pragma once

#include <cuda_bf16.h>

#include "plf_common.cuh"

namespace plf_mxu {

constexpr int MODE_F32 = 0;
constexpr int MODE_BF16X3 = 1;
constexpr int MODE_BF16 = 2;
constexpr int kKB = 4;  // output rows per job (the default job shape)
constexpr int kSites = 8;         // TS of kernels 2m and 7m
constexpr int kMaxThreads = 512;  // threads per block, a multiple of any TS

// KB, output rows per job, by the operator loads' width V (4 where S % 4 ==
// 0, else 5).
__host__ __device__ constexpr int job_rows(int V) { return V == 4 ? 4 : 5; }

// Threads per block on tiles of TS sites: one job slot of TS threads per job
// of a stage (C * ceil(S / KB) jobs), in the fewest rounds of at most
// kMaxThreads / TS jobs, every round full but the last, which lacks fewer
// jobs than there are rounds.
__host__ __device__ constexpr int block_threads(int S, int C, int KB,
                                                int TS = kSites) {
  const int jobs = C * ((S + KB - 1) / KB);
  const int slots = kMaxThreads / TS;
  const int rounds = (jobs + slots - 1) / slots;
  return TS * ((jobs + rounds - 1) / rounds);
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));  // round to nearest even
}

template <int V>
__device__ __forceinline__ void load_k(const float* p, float (&k)[V]) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
  } else {
#pragma unroll
    for (int t = 0; t < V; ++t) k[t] = __ldg(p + t);
  }
}

// out[j] = sum_q src[(q*C+c)*TS + s] * K[((o0+j)*C+c)*S + q] for o0+j < S, in
// the arithmetic of MODE.  kh/kl: the operator's hi and lo planes (kl is read
// in MODE_BF16X3 only).
template <int MODE, int V, int KB = kKB>
__device__ __forceinline__ void stage_block(const float* src, int TS, int s,
                                            const float* kh, const float* kl,
                                            int S, int C, int c, int o0,
                                            float (&out)[KB]) {
  float hh[KB], hl[KB], lh[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) hh[j] = hl[j] = lh[j] = -0.0f;  // -0 + x == x
  const int nj = min(KB, S - o0);
  for (int q0 = 0; q0 < S; q0 += V) {
    float xh[V], xl[V];
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const float x = src[((q0 + t) * C + c) * TS + s];
      if constexpr (MODE == MODE_F32) {
        xh[t] = x;
      } else {
        xh[t] = bf16r(x);
        if constexpr (MODE == MODE_BF16X3) xl[t] = bf16r(__fsub_rn(x, xh[t]));
      }
    }
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      if (j < nj) {
        const int off = ((o0 + j) * C + c) * S + q0;
        float h[V], l[V];
        load_k<V>(kh + off, h);
        if constexpr (MODE == MODE_BF16X3) load_k<V>(kl + off, l);
#pragma unroll
        for (int t = 0; t < V; ++t) {
          hh[j] = __fadd_rn(hh[j], __fmul_rn(xh[t], h[t]));
          if constexpr (MODE == MODE_BF16X3) {
            hl[j] = __fadd_rn(hl[j], __fmul_rn(xl[t], h[t]));
            lh[j] = __fadd_rn(lh[j], __fmul_rn(xh[t], l[t]));
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KB; ++j)
    out[j] = (MODE == MODE_BF16X3) ? __fadd_rn(hh[j], __fadd_rn(hl[j], lh[j]))
                                   : hh[j];
}

// One PLF node on a tile: A, B -> P = stage1(A, L) * stage1(B, R) ->
// O = stage3(P, E), all [row][site] tiles in shared memory; O may be A or B
// (every read of A and B ends at the first barrier).  Sets s_big[s] = 1 for a
// site where some |x3| >= 2^-32 (or is NaN); the caller clears s_big before
// its own barrier ahead of this call and applies the rescale afterwards.
// Begins and ends with the block at a barrier.
template <int MODE, int V, int KB = kKB>
__device__ __forceinline__ void node_tile(const float* A, const float* B,
                                          float* P, float* O, const float* lh,
                                          const float* ll, const float* rh,
                                          const float* rl, const float* eh,
                                          const float* el, int S, int C,
                                          int TS, int* s_big) {
  const int s = threadIdx.x % TS;
  const int nj = blockDim.x / TS;
  const int jobs = C * ((S + KB - 1) / KB);
  for (int j = threadIdx.x / TS; j < jobs; j += nj) {
    const int c = j % C, o0 = (j / C) * KB;
    float u1[KB], u2[KB];
    stage_block<MODE, V, KB>(A, TS, s, lh, ll, S, C, c, o0, u1);
    stage_block<MODE, V, KB>(B, TS, s, rh, rl, S, C, c, o0, u2);
#pragma unroll
    for (int k = 0; k < KB; ++k)
      if (o0 + k < S) P[((o0 + k) * C + c) * TS + s] = __fmul_rn(u1[k], u2[k]);
  }
  __syncthreads();
  bool big = false;
  for (int j = threadIdx.x / TS; j < jobs; j += nj) {
    const int c = j % C, o0 = (j / C) * KB;
    float x3[KB];
    stage_block<MODE, V, KB>(P, TS, s, eh, el, S, C, c, o0, x3);
#pragma unroll
    for (int a = 0; a < KB; ++a) {
      if (o0 + a < S) {
        O[((o0 + a) * C + c) * TS + s] = x3[a];
        big = big || !(fabsf(x3[a]) < plf::MIN_LIKELIHOOD);  // NaN counts big
      }
    }
  }
  if (big) s_big[s] = 1;
  __syncthreads();
}

}  // namespace plf_mxu

// Instantiate F<MODE, V>(...) for a run-time mode and state count: V = 4
// (float4 operator loads) when S is a multiple of 4, else 1.
#define PLF_MXU_DISPATCH(mode, states, ...)                                  \
  do {                                                                       \
    const bool v4_ = (states) % 4 == 0;                                      \
    if ((mode) == 0 && v4_) { constexpr int M_ = 0, V_ = 4; __VA_ARGS__; }   \
    else if ((mode) == 0) { constexpr int M_ = 0, V_ = 1; __VA_ARGS__; }     \
    else if ((mode) == 1 && v4_) { constexpr int M_ = 1, V_ = 4; __VA_ARGS__; }\
    else if ((mode) == 1) { constexpr int M_ = 1, V_ = 1; __VA_ARGS__; }     \
    else if ((mode) == 2 && v4_) { constexpr int M_ = 2, V_ = 4; __VA_ARGS__; }\
    else if ((mode) == 2) { constexpr int M_ = 2, V_ = 1; __VA_ARGS__; }     \
    else return (int)cudaErrorInvalidValue;                                  \
  } while (0)
