// Kernel 3: the single-node PLF backward (VJP) on lane-major CLVs.
//
// Replaces plf_tpu/ops/plf_grad.py::_plf_bwd_kernel.  Per site, with the
// forward's u1 = S1(x1; lc), u2 = S1(x2; rc), p = u1*u2, y = S3(p; ec) and
// x3 = f*y (f = 2^32 where the forward flagged a valid site, else 1):
//
//   g_y  = f * g          (0 on padding sites)
//   g_p  = S3(g_y; ecT)   g_u1 = g_p * u2   g_u2 = g_p * u1
//   gx1  = S1(g_u1; lcT)  gx2  = S1(g_u2; rcT)
//   gl, gr, ge: (S*C, S) sums over all sites (plf_grad.cuh)
//
// with the transposed constants lcT[a*C+c][k] = lc[k*C+c][a] (the adjoint of a
// stage is the same stage), every product and sum a separately rounded fp32
// op in the JAX kernel's order, so gx1 and gx2 equal the plain version
// (plf_tpu_torch/ops/plf_grad.py::plf_node_bwd_torch) bit for bit.  The site
// sums run in another order than the plain version's and agree to a tolerance.
//
// Bound: device memory.  Per site it reads x1, x2 and g (3 x 64 bytes at
// S = C = 4) and the int32 flag, and writes gx1 and gx2: 324 bytes, against
// ~60 fp32 operations per CLV element.  Design: one thread per site as in
// kernel 1 (coalesced rows, constants as float4 rows in shared memory, every
// per-site intermediate in registers), tiles of 128 sites per block in a loop.
// The operator-gradient sums (plf_grad.cuh): each warp sums its 32 sites per
// tile and m, each lane keeps its share in registers across the tiles, and at
// the end the block adds its four warps in order into its row of partials,
// for a fixed-order second pass.  gx1 gets its own buffer (the JAX call
// reuses g's buffer; autograd may still hold g).
#include "plf_grad.cuh"

namespace {

constexpr int kT = plf::kGradThreads;

template <int C>
__global__ void __launch_bounds__(kT)
plf_node_bwd_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                    const float* __restrict__ g, const int* __restrict__ sc,
                    const float* lc, const float* rc, const float* lcT,
                    const float* rcT, const float* ecT, float* __restrict__ gx1,
                    float* __restrict__ gx2, float* __restrict__ partial, int n,
                    int n_pad, int tiles_per_block, int n_tiles) {
  constexpr int R = plf::S * C;
  constexpr int RS = R * plf::S;
  constexpr int NQ = plf::grad_passes<C>();
  constexpr int NW = kT / plf::kWarp;
  __shared__ float4 s_lc[R], s_rc[R], s_lcT[R], s_rcT[R], s_ecT[R];
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid % plf::kWarp, warp = tid / plf::kWarp;
  float* st = reinterpret_cast<float*>(smem4) + warp * plf::warp_stage_floats<C>();
  for (int i = tid; i < R; i += kT) {
    s_lc[i] = reinterpret_cast<const float4*>(lc)[i];
    s_rc[i] = reinterpret_cast<const float4*>(rc)[i];
    s_lcT[i] = reinterpret_cast<const float4*>(lcT)[i];
    s_rcT[i] = reinterpret_cast<const float4*>(rcT)[i];
    s_ecT[i] = reinterpret_cast<const float4*>(ecT)[i];
  }
  __syncthreads();

  float2 sum[3][NQ];
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int q = 0; q < NQ; ++q) sum[m][q] = make_float2(0.0f, 0.0f);
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, n_tiles);
  for (int t = t0; t < t1; ++t) {
    const int site = t * kT + tid;      // n_pad is a multiple of kT
    const bool valid = site < n;
    const float fac = (valid && sc[site] > 0) ? plf::TWO_TO_THE_32 : 1.0f;
    float a[R], b[R], gy[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a[r] = x1[(size_t)r * n_pad + site];
      b[r] = x2[(size_t)r * n_pad + site];
      gy[r] = valid ? __fmul_rn(g[(size_t)r * n_pad + site], fac) : 0.0f;
    }
    float u1[R], u2[R], gp[R], gu1[R], gu2[R], o[R];
    plf::stage<C>(a, s_lc, u1);
    plf::stage<C>(b, s_rc, u2);
    plf::stage<C>(gy, s_ecT, gp);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      gu1[r] = __fmul_rn(gp[r], u2[r]);
      gu2[r] = __fmul_rn(gp[r], u1[r]);
      u1[r] = __fmul_rn(u1[r], u2[r]);  // p
    }
    plf::stage<C>(gu1, s_lcT, o);
#pragma unroll
    for (int r = 0; r < R; ++r) gx1[(size_t)r * n_pad + site] = o[r];
    plf::stage<C>(gu2, s_rcT, o);
#pragma unroll
    for (int r = 0; r < R; ++r) gx2[(size_t)r * n_pad + site] = o[r];
    float2 s[NQ];
    plf::warp_op_grad<C>(st, a, gu1, lane, s);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      sum[0][q] = make_float2(__fadd_rn(sum[0][q].x, s[q].x),
                              __fadd_rn(sum[0][q].y, s[q].y));
    plf::warp_op_grad<C>(st, b, gu2, lane, s);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      sum[1][q] = make_float2(__fadd_rn(sum[1][q].x, s[q].x),
                              __fadd_rn(sum[1][q].y, s[q].y));
    plf::warp_op_grad<C>(st, u1, gy, lane, s);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      sum[2][q] = make_float2(__fadd_rn(sum[2][q].x, s[q].x),
                              __fadd_rn(sum[2][q].y, s[q].y));
  }
  // The block's row: its warps' sums added in warp order.
  __syncthreads();
  float2* comb = reinterpret_cast<float2*>(smem4);   // [warp][m][q][lane]
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      comb[((warp * 3 + m) * NQ + q) * plf::kWarp + lane] = sum[m][q];
  __syncthreads();
  for (int j = tid; j < 3 * NQ * plf::kWarp; j += kT) {
    float2 v = comb[j];
    for (int w = 1; w < NW; ++w) {
      const float2 u = comb[w * 3 * NQ * plf::kWarp + j];
      v = make_float2(__fadd_rn(v.x, u.x), __fadd_rn(v.y, u.y));
    }
    const int m = j / (NQ * plf::kWarp), q = (j / plf::kWarp) % NQ;
    const int ln = j % plf::kWarp;
    float* row = partial + (size_t)blockIdx.x * 3 * RS + m * RS;
    const int e0 = plf::grad_entry<C>(ln, q, 0), e1 = plf::grad_entry<C>(ln, q, 1);
    if (e0 >= 0) row[e0] = v.x;
    if (e1 >= 0) row[e1] = v.y;
  }
}

// Dynamic shared memory: the four warps' staging areas (the block's
// combining area at the end fits in them).
template <int C>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kT / plf::kWarp) * plf::warp_stage_floats<C>();
}

template <int C>
int launch(const float* x1, const float* x2, const float* g, const int* sc,
           const float* lc, const float* rc, const float* lcT, const float* rcT,
           const float* ecT, float* gx1, float* gx2, float* partial,
           int n_blocks, int tiles_per_block, float* gops, int n, int n_pad,
           cudaStream_t st) {
  constexpr int R = plf::S * C;
  const size_t smem = smem_bytes<C>();
  auto kern = plf_node_bwd_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<n_blocks, kT, smem, st>>>(x1, x2, g, sc, lc, rc, lcT, rcT, ecT, gx1,
                                   gx2, partial, n, n_pad, tiles_per_block,
                                   n_pad / kT);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return plf::colsum(partial, n_blocks, 3 * R * plf::S, gops, st);
}

}  // namespace

// x1, x2, g, gx1, gx2: (S*C, n_pad) fp32, n_pad a multiple of 128; sc: (n_pad,)
// int32 forward flags; lc, rc, lcT, rcT, ecT: (S*C, S) fp32, 16-byte aligned;
// partial: (n_blocks, 3*S*C*S) fp32 scratch, block b taking tiles
// [b*tiles_per_block, (b+1)*tiles_per_block); gops: (3, S*C, S) = gl, gr, ge.
// Returns the first CUDA error of the two launches, or 0.
extern "C" int plf_node_bwd_launch(const float* x1, const float* x2,
                                   const float* g, const int* sc,
                                   const float* lc, const float* rc,
                                   const float* lcT, const float* rcT,
                                   const float* ecT, float* gx1, float* gx2,
                                   float* partial, int n_blocks,
                                   int tiles_per_block, float* gops, int n,
                                   int n_pad, int categories, void* stream) {
  if (n_pad <= 0 || n_pad % kT || n_blocks <= 0 || tiles_per_block <= 0 ||
      (long long)n_blocks * tiles_per_block * kT < n_pad)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PLF_DISPATCH_C(categories,
                 return launch<C_>(x1, x2, g, sc, lc, rc, lcT, rcT, ecT, gx1,
                                   gx2, partial, n_blocks, tiles_per_block,
                                   gops, n, n_pad, st));
  return (int)cudaErrorInvalidValue;
}
