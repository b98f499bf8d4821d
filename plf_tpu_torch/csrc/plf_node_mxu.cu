// Kernel 1m: the single-node PLF in its matrix forms, on lane-major CLVs.
//
// Replaces plf_tpu/ops/plf_pallas.py::_plf_kernel_mxu (the "mxu", "mxu_3x"
// and "mxu_bf16" variants) and serves the "vpu" variant at S != 4 (in fp32
// mode, the same arithmetic); kernel 1 (plf_node.cu) keeps S = 4 "vpu".  The
// arithmetic of each mode and the thread layout are in plf_mxu.cuh.
//
// Bound: at S = 20, C = 4 a site moves 964 bytes (two CLVs of 80 floats read,
// one written, one int32 flag written) for 9,600 flops in fp32 mode and three
// times the products in bf16x3 mode.  Under -fmad=false the card issues 128
// separate fp32 multiplies or adds per SM and clock, so fp32 mode sits near
// the balance of memory and compute and bf16x3 mode is bound by compute (the
// tensor cores are later work).  The operator loads and the shared-memory
// reads of the tile also take issue slots: ~2,400 loads per site at S = 20.
// Design: one block of 128 threads owns TS = 32 sites and all rows.  It copies
// the two child tiles [row][site] into shared memory (each warp reads 128
// contiguous bytes of a row), runs node_tile (stage 1 of both children and
// their product into a third tile, then stage 3 over the first tile), reduces
// the rescale test over all rows of a site through a shared flag, and writes
// the parent tile and flags back, coalesced.  The operators stay in device
// memory: at S = 61 one plane is 60-119 KB, too big to stage with the tiles.
//
// bf16 storage (T = __nv_bfloat16, PLFConfig(dtype="bfloat16")): the child
// tiles are widened as they are copied into shared memory and the parent
// narrowed after its rescale, as _plf_kernel_mxu stores jnp.where(mask, x3 *
// 2^32, x3).astype (plf_pallas.py:249-250, :264-265); 484 bytes a site at S
// = 20, C = 4.
//
// In-place form: x3 may be x1 or x2 (the parent written over a dead child).
// A block reads its whole tile of both children before it writes any of its
// sites, and blocks own disjoint sites, so the pointers are not __restrict__.
#include "plf_mxu.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSites = 32;  // TS

template <int MODE, int V, typename T>
__global__ void __launch_bounds__(kThreads)
plf_node_mxu_kernel(const T* x1, const T* x2, const float* lh,
                    const float* ll, const float* rh, const float* rl,
                    const float* eh, const float* el, T* x3, int* sc, int n,
                    int n_pad, int S, int C) {
  extern __shared__ float smem[];
  const int rows = S * C;
  const int tile = rows * kSites;
  float* A = smem;
  float* B = A + tile;
  float* P = B + tile;
  int* s_big = reinterpret_cast<int*>(P + tile);
  const int tid = threadIdx.x;
  const int site0 = blockIdx.x * kSites;
  if (tid < kSites) s_big[tid] = 0;
  for (int i = tid; i < tile; i += blockDim.x) {
    const int site = site0 + i % kSites;
    const size_t g = (size_t)(i / kSites) * n_pad + site;
    const bool in = site < n_pad;
    A[i] = in ? plf::widen(x1[g]) : 0.0f;
    B[i] = in ? plf::widen(x2[g]) : 0.0f;
  }
  __syncthreads();
  plf_mxu::node_tile<MODE, V>(A, B, P, A, lh, ll, rh, rl, eh, el, S, C,
                              kSites, s_big);
  for (int i = tid; i < tile; i += blockDim.x) {
    const int s = i % kSites, site = site0 + s;
    if (site >= n_pad) continue;
    const float v = A[i];
    const bool flag = !s_big[s] && site < n;
    x3[(size_t)(i / kSites) * n_pad + site] =
        plf::narrow<T>(flag ? __fmul_rn(v, plf::TWO_TO_THE_32) : v);
  }
  if (tid < kSites && site0 + tid < n_pad)
    sc[site0 + tid] = (!s_big[tid] && site0 + tid < n) ? 1 : 0;
}

size_t smem_bytes(int rows) {
  return sizeof(float) * (3 * (size_t)rows * kSites + kSites);
}

template <int MODE, int V, typename T>
int launch(const void* x1, const void* x2, const float* lh, const float* ll,
           const float* rh, const float* rl, const float* eh, const float* el,
           void* x3, int* sc, int n, int n_pad, int S, int C,
           cudaStream_t st) {
  const size_t smem = smem_bytes(S * C);
  auto kern = plf_node_mxu_kernel<MODE, V, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_pad + kSites - 1) / kSites);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2), lh, ll, rh, rl, eh,
      el, static_cast<T*>(x3), sc, n, n_pad, S, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x1, x2, x3: (S*C, n_pad), fp32, or bf16 when bf16 is set; lh/ll, rh/rl,
// eh/el: the (S*C, S) fp32 hi and lo planes of the left, right and
// eigenvector lane constants (16-byte aligned when S % 4 == 0; lo is read in
// mode 1 only); sc: (n_pad,) int32.  mode: 0 fp32, 1 bf16x3, 2 bf16.  Returns
// cudaGetLastError() after the launch.
extern "C" int plf_node_mxu_launch(const void* x1, const void* x2,
                                   const float* lh, const float* ll,
                                   const float* rh, const float* rl,
                                   const float* eh, const float* el, void* x3,
                                   int* sc, int n, int n_pad, int states,
                                   int categories, int mode, int bf16,
                                   void* stream) {
  if (n_pad <= 0 || states < 1 || categories < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PLF_DISPATCH_T(bf16, PLF_MXU_DISPATCH(mode, states,
                   return launch<M_, V_, T_>(x1, x2, lh, ll, rh, rl, eh, el,
                                             x3, sc, n, n_pad, states,
                                             categories, st)));
  return (int)cudaErrorInvalidValue;
}
