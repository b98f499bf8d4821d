// Kernel 1: the single-node PLF on lane-major CLVs.
//
// Replaces plf_tpu/ops/plf_pallas.py::_plf_kernel (the "vpu" form).
//
// Bound: device memory.  Per site it reads two CLVs of S*C floats, writes one
// and writes one int32 flag: 3*16*4 + 4 = 196 bytes at S = C = 4, for about
// 23 fp32 operations per CLV element, far below the card's balance point.
// Design: one thread per site; a thread reads row r of its site at
// x[r*n_pad + site], so the 32 threads of a warp read 128 contiguous bytes per
// row and every load and store coalesces.  The three (S*C, S) constant
// matrices are staged once per block in shared memory and read as one float4
// per row.  No intermediate leaves the registers.
//
// bf16 storage (T = __nv_bfloat16, PLFConfig(dtype="bfloat16")): the CLVs are
// read as bf16 and widened, the arithmetic and the rescale test are fp32, and
// x3 is narrowed after the rescale, as _plf_kernel stores (x3 * fac).astype
// (plf_pallas.py:114-119).  A site then moves 100 bytes (2*16*2 + 16*2 + 4),
// about half of the fp32 form's.
//
// Instance axis (plf_node_batch_launch, PLFEngine.plf_batch): blockIdx.y is
// the instance of a kernel instantiated with kBatch (a launch of one
// instance runs the single-node kernel, whose pointers stay kernel
// parameters rather than registers); instance i reads its own x1, x2 (i * S*C * n_pad elements
// in), its own lc, rc, ec (i * S*C * S floats in) and writes its own x3 and
// scaler row, so one launch evaluates I independent node pairs.  The
// per-site arithmetic is the single-node kernel's, which is instance 0 of a
// batch of one: instance i's x3 and flags equal plf_node on instance i bit
// for bit.  Replaces the vmap of plf_pallas_lane_major over instances in
// plf_tpu/engine.py::PLFEngine.plf_batch (:147-228).
//
// In-place form: x3 may be the same buffer as x1 or x2 (the parent CLV written
// over a dead child, plf_tpu/ops/plf_pallas.py:328-330).  That is safe because
// each thread reads every row of its own site into registers before it writes
// any row, and no thread touches another thread's site.  For the same reason
// the pointers are not declared __restrict__.
#include "plf_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int C, typename T, bool kBatch>
__global__ void __launch_bounds__(kThreads)
plf_node_kernel(const T* x1, const T* x2, const float* lc, const float* rc,
                const float* ec, T* x3, int* sc, int n, int n_pad) {
  constexpr int R = plf::S * C;
  if constexpr (kBatch) {  // this block's instance
    const size_t inst = blockIdx.y;
    x1 += inst * R * n_pad;
    x2 += inst * R * n_pad;
    x3 += inst * R * n_pad;
    sc += inst * n_pad;
    lc += inst * R * plf::S;
    rc += inst * R * plf::S;
    ec += inst * R * plf::S;
  }
  __shared__ float4 s_lc[R], s_rc[R], s_ec[R];
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    s_lc[i] = reinterpret_cast<const float4*>(lc)[i];
    s_rc[i] = reinterpret_cast<const float4*>(rc)[i];
    s_ec[i] = reinterpret_cast<const float4*>(ec)[i];
  }
  __syncthreads();
  const int site = blockIdx.x * blockDim.x + threadIdx.x;
  if (site >= n_pad) return;
  float a[R], b[R], out[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a[r] = plf::widen(x1[(size_t)r * n_pad + site]);
    b[r] = plf::widen(x2[(size_t)r * n_pad + site]);
  }
  const int flag = plf::plf_site<C>(a, b, s_lc, s_rc, s_ec, site < n, out);
#pragma unroll
  for (int r = 0; r < R; ++r)
    x3[(size_t)r * n_pad + site] = plf::narrow<T>(out[r]);
  sc[site] = flag;
}

int launch(const void* x1, const void* x2, const float* lc, const float* rc,
           const float* ec, void* x3, int* sc, int n, int n_pad,
           int categories, int bf16, int batch, void* stream) {
  if (n_pad <= 0 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_pad + kThreads - 1) / kThreads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PLF_DISPATCH_T(bf16, PLF_DISPATCH_C(categories,
      auto kern = batch > 1 ? plf_node_kernel<C_, T_, true>
                            : plf_node_kernel<C_, T_, false>;
      kern<<<grid, kThreads, 0, st>>>(
          static_cast<const T_*>(x1), static_cast<const T_*>(x2), lc, rc, ec,
          static_cast<T_*>(x3), sc, n, n_pad)));
  return (int)cudaGetLastError();
}

}  // namespace

// x1, x2, x3: (S*C, n_pad), fp32, or bf16 when bf16 is set; lc, rc, ec:
// (S*C, S) fp32, 16-byte aligned; sc: (n_pad,) int32.  Returns
// cudaGetLastError() after the launch.
extern "C" int plf_node_launch(const void* x1, const void* x2,
                               const float* lc, const float* rc,
                               const float* ec, void* x3, int* sc, int n,
                               int n_pad, int categories, int bf16,
                               void* stream) {
  return launch(x1, x2, lc, rc, ec, x3, sc, n, n_pad, categories, bf16, 1,
                stream);
}

// The instance axis: x1, x2, x3: (batch, S*C, n_pad); lc, rc, ec: (batch,
// S*C, S); sc: (batch, n_pad); n valid sites in every instance; batch in
// 1..65535 (the grid's y extent).  One launch.
extern "C" int plf_node_batch_launch(const void* x1, const void* x2,
                                     const float* lc, const float* rc,
                                     const float* ec, void* x3, int* sc,
                                     int n, int n_pad, int categories,
                                     int bf16, int batch, void* stream) {
  return launch(x1, x2, lc, rc, ec, x3, sc, n, n_pad, categories, bf16,
                batch, stream);
}
