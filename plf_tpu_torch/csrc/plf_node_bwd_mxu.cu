// Kernel 3m: the single-node PLF backward (VJP) at S != 4, on lane-major
// CLVs.
//
// Replaces plf_tpu/ops/plf_grad.py::_plf_bwd_kernel (:120, launched by
// _plf_bwd_call :166) at any S but 4, where kernel 3 (plf_node_bwd.cu)
// serves.  The math is kernel 3's (per site, with the forward's
// u1 = S1(x1; lc), u2 = S1(x2; rc), p = u1*u2 and flags f):
//
//   g_y  = f * g (0 on padding sites)   g_p = S3(g_y; ecT)
//   g_u1 = g_p * u2                      g_u2 = g_p * u1
//   gx1  = S1(g_u1; lcT)                 gx2  = S1(g_u2; rcT)
//   gl[r][a] = sum_s x1[a*C + r%C][s] * g_u1[r][s]; gr, ge alike
//
// in fp32 only, as the JAX kernel: every stage is plf_mxu.cuh's stage_block
// in fp32 mode (separately rounded products and sums in the golden model's
// order), so gx1 and gx2 equal the plain version
// (plf_tpu_torch/ops/plf_grad.py::plf_node_bwd_torch) bit for bit.  The site
// sums run in another order than the plain version's and agree to a
// tolerance.
//
// Why kernel 3's design does not carry over: it keeps a site's rows and its
// 3*R*S gradient slots in registers; at S = 20, C = 4 that is 80 rows and
// 4,800 slots, at S = 61 244 rows and 44,652 slots (178 KB).  So this kernel
// is kernel 4m's reverse sweep for one node (plf_mxu_bwd.cuh), on kernel
// 4m's tile, threads and plan: a block walks tiles of bwd_tile(S) sites (32
// at S = 20 with 320 threads, 8 at S = 61 with 128) held [row][site] in
// shared memory (x1, x2, g_y, g_u1, g_u2, p); sweep_products forms u1, u2,
// g_p and the three products, tile_sums adds the tile's operator-gradient
// sums to the block's accumulators (register-blocked fp32 on the CUDA
// cores, each lane reading its rows as float4 from a site of its own), and
// adjoint_to writes gx1 and gx2 straight to device memory.  The
// accumulators sit in shared memory when two blocks with them fit an SM (S =
// 20: 19 KB beside 61 KB of tiles), else in the block's own row of partial
// sums in device memory (S = 61: 178 KB), by bwd_plan.  They are in output
// order, so a block in shared memory copies them into its row once; and
// plf::colsum adds the rows in a fixed order: no float atomics,
// bit-identical run to run.  On an H100 (PERF.md) the sums take 2.9 of
// 7.1 ms at S = 20 (2^21 - 77 sites) and 8.8 of 28.9 at S = 61 (2^18 - 5),
// where 16-site tiles (38.5 ms) and at most two blocks per SM (50.9 ms, the
// rows then L2-resident) ran slower.
//
// Bound: at S = 20, C = 4 a site moves 1,604 bytes (x1, x2, g read, gx1,
// gx2 written, the flag read) for 25,840 fp32 operations (five stages, three
// products, three operator gradients), near the card's balance of memory
// and fp32 compute, which -fmad=false halves; the operator loads and the
// shared-memory reads of the tiles take issue slots as in kernel 4m.
#include "plf_mxu_bwd.cuh"

namespace {

template <int V, int TS>
__global__ void __launch_bounds__(plf_mxu::bwd_threads(TS),
                                  plf_mxu::bwd_min_blocks(TS))
plf_node_bwd_mxu_kernel(const float* __restrict__ x1,
                        const float* __restrict__ x2,
                        const float* __restrict__ g,
                        const int* __restrict__ sc, const float* lc,
                        const float* rc, const float* lcT, const float* rcT,
                        const float* ecT, float* __restrict__ gx1,
                        float* __restrict__ gx2, float* partial,
                        int acc_shared, int n, int n_pad, int tiles_per_block,
                        int n_tiles, int S, int C) {
  extern __shared__ float smem[];
  constexpr int NT = plf_mxu::bwd_threads(TS);
  const int R = S * C, RS = R * S, tile = R * TS;
  float* tA = smem;         // x1
  float* tB = tA + tile;    // x2
  float* tG = tB + tile;    // g_y
  float* tU1 = tG + tile;   // g_u1
  float* tU2 = tU1 + tile;  // g_u2
  float* tP = tU2 + tile;   // p
  // The block's row of partial sums: (3, R, S) as gl, gr, ge, the
  // accumulators' own order.
  float* row = partial + (size_t)blockIdx.x * 3 * RS;
  float* acc = acc_shared ? tP + tile : row;  // 3 * RS
  const int tid = threadIdx.x;
  for (int j = tid; j < 3 * RS; j += NT) acc[j] = 0.0f;

  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, n_tiles);
  for (int t = t0; t < t1; ++t) {
    const int site0 = t * TS;
    for (int i = tid; i < tile; i += NT) {
      const int site = site0 + i % TS;
      const size_t gi = (size_t)(i / TS) * n_pad + site;
      tA[i] = x1[gi];
      tB[i] = x2[gi];
      tG[i] = site < n ? __fmul_rn(g[gi], sc[site] > 0 ? plf::TWO_TO_THE_32
                                                       : 1.0f)
                       : 0.0f;
    }
    __syncthreads();
    plf_mxu::sweep_products<plf_mxu::MODE_F32, V, TS, NT>(
        tA, tB, tG, tU1, tU2, tP, lc, lc, rc, rc, ecT, ecT, S, C);
    plf_mxu::tile_sums<plf_mxu::MODE_F32, TS, NT>(tA, tB, tP, tU1, tU2, tG,
                                                  acc, S, C);
    plf_mxu::adjoint_to<plf_mxu::MODE_F32, V, TS, NT>(
        tU1, tU2, lcT, lcT, rcT, rcT, gx1 + site0, n_pad, gx2 + site0, n_pad,
        S, C);
    __syncthreads();  // the tiles are read until here
  }
  // The barrier above makes every lane's sums visible (a block has at
  // least one tile).
  if (acc_shared)
    for (int j = tid; j < 3 * RS; j += NT) row[j] = acc[j];
}

template <int V, int TS>
int launch(const float* x1, const float* x2, const float* g, const int* sc,
           const float* lc, const float* rc, const float* lcT,
           const float* rcT, const float* ecT, float* gx1, float* gx2,
           float* partial, int acc_shared, int n_blocks, int tiles_per_block,
           float* gops, int n, int n_pad, int S, int C, cudaStream_t st) {
  const int R = S * C;
  const size_t smem = plf_mxu::bwd_smem_bytes(R, S, acc_shared, TS);
  auto kern = plf_node_bwd_mxu_kernel<V, TS>;
  cudaError_t err = plf_mxu::bwd_prepare(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<n_blocks, plf_mxu::bwd_threads(TS), smem, st>>>(
      x1, x2, g, sc, lc, rc, lcT, rcT, ecT, gx1, gx2, partial, acc_shared, n,
      n_pad, tiles_per_block, n_pad / TS, S, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return plf::colsum(partial, n_blocks, 3 * R * S, gops, st);
}

}  // namespace

// Instantiate F<V, TS>(...) for a state count: TS = bwd_tile(states), V = 4
// (float4 operator loads) on 32-site tiles, 1 on 8-site tiles, as kernel
// 4m's PLF_MXU_BWD_DISPATCH.
#define PLF_NODE_BWD_MXU_DISPATCH(states, ...)                              \
  do {                                                                       \
    if (plf_mxu::bwd_tile(states) == 32) { constexpr int V_ = 4, T_S = 32; __VA_ARGS__; } \
    else { constexpr int V_ = 1, T_S = 8; __VA_ARGS__; }                     \
  } while (0)

// x1, x2, g, gx1, gx2: (S*C, n_pad) fp32, n_pad a multiple of the tile
// (bwd_tile(S) sites); sc: (n_pad,) int32 forward flags; lc, rc, lcT, rcT,
// ecT: (S*C, S) fp32 (16-byte aligned when S % 4 == 0); partial: (n_blocks,
// 3*S*C*S) fp32 scratch, block b taking tiles [b*tiles_per_block,
// (b+1)*tiles_per_block) and keeping its accumulators in its row unless
// acc_shared (plf_node_bwd_mxu_plan's placement); gops: (3, S*C, S) = gl,
// gr, ge.  Returns the first CUDA error of the two launches, or 0.
extern "C" int plf_node_bwd_mxu_launch(
    const float* x1, const float* x2, const float* g, const int* sc,
    const float* lc, const float* rc, const float* lcT, const float* rcT,
    const float* ecT, float* gx1, float* gx2, float* partial, int acc_shared,
    int n_blocks, int tiles_per_block, float* gops, int n, int n_pad,
    int states, int categories, void* stream) {
  if (states < 2 || categories < 1 || n_pad <= 0 || n_blocks <= 0 ||
      tiles_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PLF_NODE_BWD_MXU_DISPATCH(
      states,
      if (n_pad % T_S || (long long)n_blocks * tiles_per_block * T_S < n_pad)
        return (int)cudaErrorInvalidValue;
      return launch<V_, T_S>(x1, x2, g, sc, lc, rc, lcT, rcT, ecT, gx1, gx2,
                             partial, acc_shared, n_blocks, tiles_per_block,
                             gops, n, n_pad, states, categories, st));
  return (int)cudaErrorInvalidValue;
}

// The launch's plan: its tile of sites (*sites), where it keeps its
// accumulators (*acc_shared: 1 in shared memory, 0 in the block's row of
// partial sums) and how many of its blocks are resident per SM (*blocks; 0
// when its tiles exceed a block's shared memory).
extern "C" int plf_node_bwd_mxu_plan(int states, int categories,
                                     int* acc_shared, int* blocks,
                                     int* sites) {
  const int R = states * categories;
  if (states < 2 || categories < 1) return (int)cudaErrorInvalidValue;
  PLF_NODE_BWD_MXU_DISPATCH(
      states, *sites = T_S;
      return plf_mxu::bwd_plan(plf_node_bwd_mxu_kernel<V_, T_S>, R, states,
                               acc_shared, blocks, T_S,
                               plf_mxu::bwd_threads(T_S)));
  return (int)cudaErrorInvalidValue;
}
