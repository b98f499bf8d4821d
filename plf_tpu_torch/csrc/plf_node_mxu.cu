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
//
// Design: one block per tile of TS sites (kNodeSites) and all rows, on
// kernel 2m's job shape (plf_mxu.cuh's block_threads and job_rows on TS-site
// tiles: 320 threads at S = 20, C = 4; 416 of five-row jobs at S = 61).  The
// block copies the two child tiles [row][site] into shared memory, widened
// to fp32 (consecutive threads read consecutive sites of a row), runs
// node_tile (stage 1 of both children and their product into a third tile,
// then stage 3 over the first tile), reduces the rescale test over all rows
// of a site through a shared flag, and writes the parent tile and flags
// back, coalesced.  The operators stay in device memory (L1- and
// L2-resident): at S = 61 one plane is 60-119 KB, too big to stage.  The
// card's own scheduling of these short blocks overlaps one block's loads
// with another's arithmetic: on an H100 (PERF.md) a persistent walk over
// tiles that copied the next tile with cp.async into a second stage ran
// 13-15% slower at S = 20 and 12% at S = 61, summed over the modes and
// storages.
//
// bf16 storage (T = __nv_bfloat16, PLFConfig(dtype="bfloat16")): the child
// tiles are widened as they are copied into shared memory and the parent
// narrowed after its rescale, as _plf_kernel_mxu stores jnp.where(mask, x3 *
// 2^32, x3).astype (plf_pallas.py:249-250, :264-265); 484 bytes a site at S
// = 20, C = 4.
//
// Instance axis (plf_node_mxu_batch_launch, PLFEngine.plf_batch): blockIdx.y
// is the instance of a kernel instantiated with kBatch (a launch of one
// instance runs the single-node kernel, whose ten pointers stay kernel
// parameters rather than offset copies in registers); instance i reads its own child tiles (i * S*C * n_pad
// elements in), its own six operator planes (i * S*C * S floats in) and
// writes its own parent and flags.  The tile's arithmetic is unchanged, so
// instance i equals a single launch on it bit for bit (a single launch is a
// batch of one).  Replaces the vmap of plf_pallas_lane_major over instances
// in plf_tpu/engine.py::PLFEngine.plf_batch (:147-228).
//
// In-place form: x3 may be x1 or x2 (the parent written over a dead child).
// A block reads its whole tile of both children before it writes any of its
// sites, and blocks own disjoint sites, so the pointers are not __restrict__.
#include "plf_mxu.cuh"

namespace {

using plf_mxu::block_threads;
using plf_mxu::job_rows;
using plf_mxu::kMaxThreads;

// Sites per tile (TS).  On an H100 (PERF.md) 32-site tiles ran fastest of
// 8, 16 and 32 at S = 20 and S = 61, summed over the modes and storages.
constexpr int kNodeSites = 32;

template <int MODE, int V, typename T, bool kBatch>
__global__ void __launch_bounds__(kMaxThreads)
plf_node_mxu_kernel(const T* x1, const T* x2, const float* lh,
                    const float* ll, const float* rh, const float* rl,
                    const float* eh, const float* el, T* x3, int* sc, int n,
                    int n_pad, int S, int C) {
  constexpr int TS = kNodeSites;
  extern __shared__ float smem[];
  const int rows = S * C;
  const int tile = rows * TS;
  if constexpr (kBatch) {  // this block's instance
    const size_t inst = blockIdx.y;
    const size_t clv = inst * rows * n_pad, ops = inst * rows * S;
    x1 += clv;
    x2 += clv;
    x3 += clv;
    sc += inst * n_pad;
    lh += ops;
    ll += ops;
    rh += ops;
    rl += ops;
    eh += ops;
    el += ops;
  }
  float* A = smem;
  float* B = A + tile;
  float* P = B + tile;
  int* s_big = reinterpret_cast<int*>(P + tile);
  const int tid = threadIdx.x;
  const int site0 = blockIdx.x * TS;
  if (tid < TS) s_big[tid] = 0;
  for (int i = tid; i < tile; i += blockDim.x) {
    const int site = site0 + i % TS;
    const size_t g = (size_t)(i / TS) * n_pad + site;
    const bool in = site < n_pad;
    A[i] = in ? plf::widen(x1[g]) : 0.0f;
    B[i] = in ? plf::widen(x2[g]) : 0.0f;
  }
  __syncthreads();
  plf_mxu::node_tile<MODE, V, job_rows(V)>(A, B, P, A, lh, ll, rh, rl, eh,
                                           el, S, C, TS, s_big);
  for (int i = tid; i < tile; i += blockDim.x) {
    const int s = i % TS, site = site0 + s;
    if (site >= n_pad) continue;
    const float v = A[i];
    const bool flag = !s_big[s] && site < n;
    x3[(size_t)(i / TS) * n_pad + site] =
        plf::narrow<T>(flag ? __fmul_rn(v, plf::TWO_TO_THE_32) : v);
  }
  if (tid < TS && site0 + tid < n_pad)
    sc[site0 + tid] = (!s_big[tid] && site0 + tid < n) ? 1 : 0;
}

// Dynamic shared memory of one block: three fp32 tiles (two children and
// the products; the parent reuses the first) and the rescale flags.
size_t smem_bytes(int rows) {
  return sizeof(float) * (3 * (size_t)rows * kNodeSites + kNodeSites);
}

// Threads and shared memory of a block, the kernel's shared-memory ceiling
// raised to them (fails where they exceed what a block may use).
template <int MODE, int V, typename T, bool kBatch>
cudaError_t shape(int S, int C, int* threads, size_t* smem) {
  *threads = block_threads(S, C, job_rows(V), kNodeSites);
  *smem = smem_bytes(S * C);
  return cudaFuncSetAttribute(plf_node_mxu_kernel<MODE, V, T, kBatch>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <int MODE, int V, typename T, bool kBatch>
int launch(const void* x1, const void* x2, const float* lh, const float* ll,
           const float* rh, const float* rl, const float* eh, const float* el,
           void* x3, int* sc, int n, int n_pad, int S, int C, int batch,
           cudaStream_t st) {
  int threads = 0;
  size_t smem = 0;
  const cudaError_t err = shape<MODE, V, T, kBatch>(S, C, &threads, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_pad + kNodeSites - 1) / kNodeSites, batch);
  plf_node_mxu_kernel<MODE, V, T, kBatch><<<grid, threads, smem, st>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2), lh, ll, rh, rl, eh,
      el, static_cast<T*>(x3), sc, n, n_pad, S, C);
  return (int)cudaGetLastError();
}

template <int MODE, int V, typename T>
int plan(int S, int C, int* threads, int* blocks) {
  size_t smem = 0;
  cudaError_t err = shape<MODE, V, T, false>(S, C, threads, &smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, plf_node_mxu_kernel<MODE, V, T, false>, *threads, smem);
  return (int)err;
}

int launch_any(const void* x1, const void* x2, const float* lh,
               const float* ll, const float* rh, const float* rl,
               const float* eh, const float* el, void* x3, int* sc, int n,
               int n_pad, int states, int categories, int mode, int bf16,
               int batch, void* stream) {
  if (n_pad <= 0 || states < 1 || categories < 1 || batch < 1 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PLF_DISPATCH_T(bf16, PLF_MXU_DISPATCH(mode, states,
                   return batch > 1
                       ? launch<M_, V_, T_, true>(x1, x2, lh, ll, rh, rl, eh,
                                                  el, x3, sc, n, n_pad,
                                                  states, categories, batch,
                                                  st)
                       : launch<M_, V_, T_, false>(x1, x2, lh, ll, rh, rl, eh,
                                                   el, x3, sc, n, n_pad,
                                                   states, categories, 1,
                                                   st)));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x1, x2, x3: (S*C, n_pad), fp32, or bf16 when bf16 is set; lh/ll, rh/rl,
// eh/el: the (S*C, S) fp32 hi and lo planes of the left, right and
// eigenvector lane constants (16-byte aligned when S % 4 == 0; lo is read in
// mode 1 only); sc: (n_pad,) int32.  mode: 0 fp32, 1 bf16x3, 2 bf16.  One
// block per tile of kNodeSites sites.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue where a block's shared memory exceeds what
// a block may use).
extern "C" int plf_node_mxu_launch(const void* x1, const void* x2,
                                   const float* lh, const float* ll,
                                   const float* rh, const float* rl,
                                   const float* eh, const float* el, void* x3,
                                   int* sc, int n, int n_pad, int states,
                                   int categories, int mode, int bf16,
                                   void* stream) {
  return launch_any(x1, x2, lh, ll, rh, rl, eh, el, x3, sc, n, n_pad, states,
                    categories, mode, bf16, 1, stream);
}

// The instance axis: x1, x2, x3: (batch, S*C, n_pad); each plane (batch,
// S*C, S); sc: (batch, n_pad); n valid sites in every instance; batch in
// 1..65535 (the grid's y extent).  One launch.
extern "C" int plf_node_mxu_batch_launch(
    const void* x1, const void* x2, const float* lh, const float* ll,
    const float* rh, const float* rl, const float* eh, const float* el,
    void* x3, int* sc, int n, int n_pad, int states, int categories,
    int mode, int bf16, int batch, void* stream) {
  return launch_any(x1, x2, lh, ll, rh, rl, eh, el, x3, sc, n, n_pad, states,
                    categories, mode, bf16, batch, stream);
}

// The launch shape of kernel 1m for this state and category count, mode and
// storage, as plf_node_mxu_launch takes it: sites per tile, threads per
// block and resident blocks per SM.  The grid is one block per tile.
extern "C" int plf_node_mxu_plan(int states, int categories, int mode,
                                 int bf16, int* ts, int* threads,
                                 int* blocks) {
  if (states < 1 || categories < 1) return (int)cudaErrorInvalidValue;
  *ts = kNodeSites;
  PLF_DISPATCH_T(bf16, PLF_MXU_DISPATCH(mode, states,
                   return plan<M_, V_, T_>(states, categories, threads,
                                           blocks)));
  return (int)cudaErrorInvalidValue;
}
