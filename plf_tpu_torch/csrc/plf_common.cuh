// One PLF node for one alignment site, shared by both kernels.
//
// This is the golden model's arithmetic (plf_tpu/reference.py:81-99) in the
// lane-major row order of the Pallas kernels (plf_tpu/ops/plf_pallas.py:93-119):
//
//   stage 1  ump[k*C+c]  = sum_a x[a*C+c] * Lc[k*C+c][a]   (a = 0..S-1 in order)
//   stage 2  p           = ump_left * ump_right
//   stage 3  x3[a*C+c]   = sum_k p[k*C+c] * Ec[a*C+c][k]   (k = 0..S-1 in order)
//   stage 4  if every |x3| < 2^-32 and the site is a real one: x3 *= 2^32, flag 1
//
// Every product and every sum is a separately rounded fp32 operation
// (__fmul_rn / __fadd_rn are never contracted into an FMA), so the result is
// bit-identical to the golden model.  Subnormals are kept: the library is
// built without -ftz / fast-math.
//
// CLV storage.  A kernel that streams CLVs through device memory takes their
// storage type as a template parameter T: float, or __nv_bfloat16 for the
// bf16 storage of PLFConfig(dtype="bfloat16") (plf_tpu/ops/plf_pallas.py:
// 88-91, :119; plf_tpu/ops/plf_tree_seg.py:452-484, :568).  Arithmetic is
// fp32 either way: widen() on every load, narrow<T>() on every store, the
// latter rounding to nearest even as astype and torch's .to(bfloat16) do and
// keeping bf16 subnormals.  For T = float both are the identity, so a float
// instantiation compiles to the code it had before storage was a parameter.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace plf {

constexpr int S = 4;                                   // DNA states
constexpr float MIN_LIKELIHOOD = 2.3283064365386963e-10f;  // 2^-32
constexpr float TWO_TO_THE_32 = 4294967296.0f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Constants hold one float4 per row: row r of an (S*C, S) lane-constant
// matrix (plf_tpu_torch/ops/layout.py), i.e. its S = 4 columns.
template <int C>
__device__ __forceinline__ int plf_site(const float (&x1)[S * C],
                                        const float (&x2)[S * C],
                                        const float4* lc, const float4* rc,
                                        const float4* ec, bool valid,
                                        float (&x3)[S * C]) {
  constexpr int R = S * C;
  float p[R];
#pragma unroll
  for (int row = 0; row < R; ++row) {  // row = k*C + c
    const int c = row % C;
    const float4 l = lc[row];
    const float4 r = rc[row];
    float u1 = __fmul_rn(x1[0 * C + c], l.x);
    float u2 = __fmul_rn(x2[0 * C + c], r.x);
    u1 = __fadd_rn(u1, __fmul_rn(x1[1 * C + c], l.y));
    u2 = __fadd_rn(u2, __fmul_rn(x2[1 * C + c], r.y));
    u1 = __fadd_rn(u1, __fmul_rn(x1[2 * C + c], l.z));
    u2 = __fadd_rn(u2, __fmul_rn(x2[2 * C + c], r.z));
    u1 = __fadd_rn(u1, __fmul_rn(x1[3 * C + c], l.w));
    u2 = __fadd_rn(u2, __fmul_rn(x2[3 * C + c], r.w));
    p[row] = __fmul_rn(u1, u2);
  }
  bool small = true;
#pragma unroll
  for (int row = 0; row < R; ++row) {  // row = a*C + c
    const int c = row % C;
    const float4 e = ec[row];
    float v = __fmul_rn(p[0 * C + c], e.x);
    v = __fadd_rn(v, __fmul_rn(p[1 * C + c], e.y));
    v = __fadd_rn(v, __fmul_rn(p[2 * C + c], e.z));
    v = __fadd_rn(v, __fmul_rn(p[3 * C + c], e.w));
    x3[row] = v;
    small = small && (fabsf(v) < MIN_LIKELIHOOD);  // false for NaN, as all() is
  }
  const int flag = (small && valid) ? 1 : 0;
  if (flag) {
#pragma unroll
    for (int row = 0; row < R; ++row) x3[row] = __fmul_rn(x3[row], TWO_TO_THE_32);
  }
  return flag;
}

// One stage alone: out[r] = sum_a x[a*C + r%C] * k[r][a], a = 0..S-1 in order,
// as stage 1 and stage 3 of plf_site compute it.  With transposed constants
// (kT[a*C+c][k] = k[k*C+c][a]) it is the adjoint of the same stage, which is
// how the backward kernels apply S1^T and S3^T.
template <int C>
__device__ __forceinline__ void stage(const float (&x)[S * C], const float4* k,
                                      float (&out)[S * C]) {
  constexpr int R = S * C;
#pragma unroll
  for (int row = 0; row < R; ++row) {
    const int c = row % C;
    const float4 q = k[row];
    float v = __fmul_rn(x[0 * C + c], q.x);
    v = __fadd_rn(v, __fmul_rn(x[1 * C + c], q.y));
    v = __fadd_rn(v, __fmul_rn(x[2 * C + c], q.z));
    v = __fadd_rn(v, __fmul_rn(x[3 * C + c], q.w));
    out[row] = v;
  }
}

// 16 bytes from device memory into shared memory, asynchronously (L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Wait until every cp.async group this thread committed has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The operators of a whole-tree kernel's op (kernels 2 and 7): edge e's lc
// and rc rows (S*C float4 each, of the (E, S*C, S) stacks) copied by
// cp.async into buf[0, 2*S*C), one float4 a thread of the first 2*S*C
// threads; every thread commits a group, so cp_async_wait_all and a barrier
// later make the buffer visible to the block.
template <int C>
__device__ __forceinline__ void stage_ops(float4* buf, const float* lcs,
                                          const float* rcs, int e, int tid) {
  constexpr int R = S * C;
  if (tid < 2 * R) {
    const float* k = tid < R ? lcs : rcs;
    cp_async16(buf + tid,
               reinterpret_cast<const float4*>(k) + (size_t)e * R + tid % R);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

}  // namespace plf

// Name of a CUDA error code returned by a launch entry point.
extern "C" const char* plf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Instantiate F<C>(...) for the supported category counts (C = 5 comes from +I).
#define PLF_DISPATCH_C(categories, ...) \
  switch (categories) {                  \
    case 1: { constexpr int C_ = 1; __VA_ARGS__; } break; \
    case 2: { constexpr int C_ = 2; __VA_ARGS__; } break; \
    case 3: { constexpr int C_ = 3; __VA_ARGS__; } break; \
    case 4: { constexpr int C_ = 4; __VA_ARGS__; } break; \
    case 5: { constexpr int C_ = 5; __VA_ARGS__; } break; \
    case 6: { constexpr int C_ = 6; __VA_ARGS__; } break; \
    case 7: { constexpr int C_ = 7; __VA_ARGS__; } break; \
    case 8: { constexpr int C_ = 8; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;    \
  }

// Instantiate F<..., T_>(...) for the library's CLV storage type: a source
// is built twice, into a float library and, with -DPLF_BF16_STORAGE, a bf16
// one (plf_tpu_torch/ops/_build.py), so that the two forms compile in
// parallel.  A launch whose `bf16` argument names the other storage returns
// cudaErrorInvalidValue.
#ifdef PLF_BF16_STORAGE
#define PLF_STORAGE_T __nv_bfloat16
#define PLF_STORAGE_BF16 1
#else
#define PLF_STORAGE_T float
#define PLF_STORAGE_BF16 0
#endif
#define PLF_DISPATCH_T(bf16, ...)                                       \
  do {                                                                  \
    if ((bf16) != PLF_STORAGE_BF16) return (int)cudaErrorInvalidValue;  \
    using T_ = PLF_STORAGE_T;                                           \
    __VA_ARGS__;                                                        \
  } while (0)
