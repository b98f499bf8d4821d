// Kernel 9: the compute-only PLF probe.
//
// Replaces plf_tpu/ops/plf_pallas.py::_gen_kernel (:401, launched by
// plf_pallas_gen :436), the host_gen analogue: no CLV crosses device memory.
// Each site builds its two child CLVs from its index s within its block of
// block_sites sites and from the row r,
//
//   x1[r] = (0.1 + s*1e-4) + r*0.05      x2[r] = (1 - (s*1e-4)*0.5) + (r*0.05)*0.25
//
// then runs inner_iters chained PLF nodes without the rescale: u1 = S1(x1;
// lc), u2 = S1(x2; rc), x3 = S3(u1*u2; ec), acc += (sum of the rows of x3,
// row 0 first), x1 = x3.  acc is stored per site, so nothing of the chain
// can be dropped.  Every product and sum is __fmul_rn / __fadd_rn, so the
// result equals the plain version (ops/plf_node.py::plf_node_gen_torch) bit
// for bit.  With random constants the values grow by about S^3 a node and
// reach inf at S = 61; inf arithmetic is exact, so the equality holds there
// too.
//
// Bound: operations.  Per node and site S*C*(6*S - 1) flops (three stages of
// S products and S - 1 sums per row, the stage-2 product and the row sum's
// add: 368 at S = C = 4, bench.py:297), against 4 bytes of output per site
// over all inner_iters nodes.  Under -fmad=false each product and each sum
// is its own instruction, so the card's uncontracted ceiling is half of the
// 67 TFLOP/s that counts an FMA as two flops.
//
// Design.  S = 4: one thread per site, the rows in registers and the three
// (S*C, 4) constant matrices as float4 rows in shared memory, kernel 1's
// stage code (plf_common.cuh).  x2 is the same in every iteration; an empty
// asm statement makes the compiler treat it as new, so each iteration
// computes both branch products as _gen_kernel does.  S != 4: blocks of 128
// threads on [row][site] tiles of 32 sites in shared memory (the block kernel
// 1m had before its redesign for the H100, kept here so that the probe stays
// the yardstick it was) running plf_mxu.cuh's fp32-mode node_tile with
// 4-row jobs, the parent written over x1's tile, one thread per site summing
// the rows; the operators stay in device memory.
#include "plf_mxu.cuh"

namespace {

constexpr int kThreads = 256;      // S = 4: sites per block
constexpr int kTileThreads = 128;  // S != 4: threads per 32-site tile
constexpr int kTileSites = 32;

__device__ __forceinline__ float gen_x1(int s, int r) {
  const float base = __fmul_rn((float)s, 1e-4f);
  return __fadd_rn(__fadd_rn(0.1f, base), __fmul_rn((float)r, 0.05f));
}

__device__ __forceinline__ float gen_x2(int s, int r) {
  const float base = __fmul_rn((float)s, 1e-4f);
  return __fadd_rn(__fsub_rn(1.0f, __fmul_rn(base, 0.5f)),
                   __fmul_rn(__fmul_rn((float)r, 0.05f), 0.25f));
}

template <int C>
__global__ void __launch_bounds__(kThreads)
plf_gen_kernel(const float* lc, const float* rc, const float* ec, float* out,
               int n_sites, int block_sites, int inner_iters) {
  constexpr int R = plf::S * C;
  __shared__ float4 s_lc[R], s_rc[R], s_ec[R];
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    s_lc[i] = reinterpret_cast<const float4*>(lc)[i];
    s_rc[i] = reinterpret_cast<const float4*>(rc)[i];
    s_ec[i] = reinterpret_cast<const float4*>(ec)[i];
  }
  __syncthreads();
  const int site = blockIdx.x * blockDim.x + threadIdx.x;
  if (site >= n_sites) return;
  const int s = site % block_sites;
  float x1[R], x2[R], u1[R], u2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x1[r] = gen_x1(s, r);
    x2[r] = gen_x2(s, r);
  }
  float acc = 0.0f;
#pragma unroll 1
  for (int it = 0; it < inner_iters; ++it) {
#pragma unroll
    for (int r = 0; r < R; ++r) asm volatile("" : "+f"(x2[r]));
    plf::stage<C>(x1, s_lc, u1);
    plf::stage<C>(x2, s_rc, u2);
#pragma unroll
    for (int r = 0; r < R; ++r) u1[r] = __fmul_rn(u1[r], u2[r]);
    plf::stage<C>(u1, s_ec, x1);  // x3, the next iteration's x1
    float t = x1[0];
#pragma unroll
    for (int r = 1; r < R; ++r) t = __fadd_rn(t, x1[r]);
    acc = __fadd_rn(acc, t);
  }
  out[site] = acc;
}

template <int V>
__global__ void __launch_bounds__(kTileThreads)
plf_gen_tile_kernel(const float* lc, const float* rc, const float* ec,
                    float* out, int n_sites, int block_sites,
                    int inner_iters, int S, int C) {
  extern __shared__ float smem[];
  const int rows = S * C;
  const int tile = rows * kTileSites;
  float* A = smem;
  float* B = A + tile;
  float* P = B + tile;
  int* s_big = reinterpret_cast<int*>(P + tile);  // set by node_tile, unread
  const int tid = threadIdx.x;
  const int site0 = blockIdx.x * kTileSites;
  for (int i = tid; i < tile; i += blockDim.x) {
    const int s = (site0 + i % kTileSites) % block_sites;
    A[i] = gen_x1(s, i / kTileSites);
    B[i] = gen_x2(s, i / kTileSites);
  }
  __syncthreads();
  float acc = 0.0f;
  for (int it = 0; it < inner_iters; ++it) {
    plf_mxu::node_tile<plf_mxu::MODE_F32, V>(A, B, P, A, lc, lc, rc, rc, ec,
                                             ec, S, C, kTileSites, s_big);
    if (tid < kTileSites) {
      float t = A[tid];
      for (int r = 1; r < rows; ++r) t = __fadd_rn(t, A[r * kTileSites + tid]);
      acc = __fadd_rn(acc, t);
    }
  }
  if (tid < kTileSites && site0 + tid < n_sites) out[site0 + tid] = acc;
}

size_t tile_smem_bytes(int rows) {
  return sizeof(float) * (3 * (size_t)rows * kTileSites + kTileSites);
}

template <int V>
int launch_tile(const float* lc, const float* rc, const float* ec, float* out,
                int n_sites, int block_sites, int inner_iters, int S, int C,
                cudaStream_t st) {
  const size_t smem = tile_smem_bytes(S * C);
  auto kern = plf_gen_tile_kernel<V>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_sites + kTileSites - 1) / kTileSites);
  kern<<<grid, kTileThreads, smem, st>>>(lc, rc, ec, out, n_sites,
                                         block_sites, inner_iters, S, C);
  return (int)cudaGetLastError();
}

}  // namespace

// lc, rc, ec: (S*C, S) fp32 lane constants (16-byte aligned when S % 4 ==
// 0); out: (n_sites,) fp32, n_sites = n_blocks * block_sites.  Returns
// cudaGetLastError() after the launch.
extern "C" int plf_gen_launch(const float* lc, const float* rc,
                              const float* ec, float* out, int n_sites,
                              int block_sites, int inner_iters, int states,
                              int categories, void* stream) {
  if (n_sites <= 0 || block_sites <= 0 || inner_iters < 0 || states < 2 ||
      categories < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (states == plf::S) {
    const dim3 grid((n_sites + kThreads - 1) / kThreads);
    PLF_DISPATCH_C(categories,
                   plf_gen_kernel<C_><<<grid, kThreads, 0, st>>>(
                       lc, rc, ec, out, n_sites, block_sites, inner_iters));
    return (int)cudaGetLastError();
  }
  if (states % 4 == 0)
    return launch_tile<4>(lc, rc, ec, out, n_sites, block_sites, inner_iters,
                          states, categories, st);
  return launch_tile<1>(lc, rc, ec, out, n_sites, block_sites, inner_iters,
                        states, categories, st);
}
