// Kernel 2: the whole-tree forward likelihood as a register machine.
//
// Replaces plf_tpu/ops/plf_tree_pallas.py::_tree_kernel (schedule unrolled at
// trace time) and ::_tree_kernel_dynamic (schedule as run-time arrays): one
// kernel serves both, since here a run-time schedule costs nothing to compile.
//
// Bound: latency at the occupancy the arena allows.  Device-memory traffic
// is small: the tip codes (n_leaves * 4 bytes per site as int32, a quarter
// of that as int8) plus 8 bytes of output per site.  Each schedule op does
// ~23 fp32 operations per CLV element and moves ~192 bytes per site through
// shared memory, both well under the card's peak rates.  The arena
// (n_slots * S*C * 4 bytes per thread) caps the resident blocks per SM
// (plf_tree_occupancy reports them), and on an H100 the time grows as that
// cap falls: padding the arena so that 3, 2 or 1 blocks fit instead of 4
// costs 17%, 53% or 168% at 160 taxa x 2^20 sites (chip_smoke.py, profile
// phase).  Warp-scheduler slot use and shared-memory throughput are not
// measured (no hardware-counter profiler).
// Design:
//  * one thread per site walks the schedule of compile_register_schedule
//    (plf_tpu_torch/ops/plf_tree.py): int32 arrays that every thread reads
//    alike, so each read is one broadcast;
//  * the arena of live CLVs is in shared memory, laid out [slot][row][thread]
//    so a warp's access to one row touches 32 consecutive words (no bank
//    conflicts).  It holds only the n_slots internal-node CLVs (O(log taxa)
//    after the taller-child-first reordering): tips are expanded on demand
//    from the int32 or int8 codes through the tip table, one exact matched
//    column, never preloaded (the TPU kernel's preload is a Mosaic workaround);
//  * the output slot may be an operand's slot, freed by the same op: safe,
//    because a thread reads both operands into registers before it writes;
//  * per-edge operators are read from device memory as one float4 per row at
//    an address uniform over the block (cached broadcast); the eigenvector
//    constants, tip table and root row vector are staged in shared memory;
//  * the root reduction lik = rr[0]*x[0] + rr[1]*x[1] + ... is sequential,
//    with separately rounded products and sums, as the TPU kernels do
//    (plf_tpu/ops/plf_tree_pallas.py:470-474).
// The host picks the block size so the arena fits shared memory
// (tree_block_threads in plf_tree.py) and passes it as `threads`.
#include "plf_common.cuh"

namespace {

template <int C, typename CodeT>
__global__ void plf_tree_kernel(const CodeT* codes, const int* sched,
                                int n_edges, const float* lcs,
                                const float* rcs, const float* ec,
                                const float* ttab, int ncols, const float* rr,
                                int root_slot, float* lik, int* sc, int n,
                                int n_pad) {
  constexpr int R = plf::S * C;
  extern __shared__ float4 smem4[];
  float4* s_ec = smem4;                                    // R float4
  float* s_tt = reinterpret_cast<float*>(smem4 + R);       // R * ncols
  float* s_rr = s_tt + R * ncols;                          // R
  float* arena = s_rr + R;                                 // n_slots * R * T
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < R; i += T) {
    s_ec[i] = reinterpret_cast<const float4*>(ec)[i];
    s_rr[i] = rr[i];
  }
  for (int i = tid; i < R * ncols; i += T) s_tt[i] = ttab[i];
  __syncthreads();

  const int site = blockIdx.x * T + tid;
  if (site >= n_pad) return;
  const bool valid = site < n;
  const int* lsrc = sched;
  const int* lflag = sched + n_edges;
  const int* rsrc = sched + 2 * n_edges;
  const int* rflag = sched + 3 * n_edges;
  const int* oslot = sched + 4 * n_edges;
  const int* eidx = sched + 5 * n_edges;

  auto load = [&](int src, int flag, float (&x)[R]) {
    if (flag) {  // arena slot
      const float* s = arena + (size_t)src * R * T + tid;
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = s[r * T];
    } else {     // tip: the table column of this site's code
      const int code = (int)codes[(size_t)src * n_pad + site];
      const bool ok = code >= 0 && code < ncols;  // else no column: zeros
      const int col = ok ? code : 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = s_tt[r * ncols + col];
        x[r] = ok ? v : 0.0f;
      }
    }
  };

  int count = 0;
  float a[R], b[R], out[R];
  for (int i = 0; i < n_edges; ++i) {
    load(__ldg(lsrc + i), __ldg(lflag + i), a);
    load(__ldg(rsrc + i), __ldg(rflag + i), b);
    const int e = __ldg(eidx + i);
    const float4* lc = reinterpret_cast<const float4*>(lcs) + (size_t)e * R;
    const float4* rc = reinterpret_cast<const float4*>(rcs) + (size_t)e * R;
    count += plf::plf_site<C>(a, b, lc, rc, s_ec, valid, out);
    float* d = arena + (size_t)__ldg(oslot + i) * R * T + tid;
#pragma unroll
    for (int r = 0; r < R; ++r) d[r * T] = out[r];
  }

  const float* x = arena + (size_t)root_slot * R * T + tid;
  float l = __fmul_rn(s_rr[0], x[0]);
#pragma unroll
  for (int r = 1; r < R; ++r) l = __fadd_rn(l, __fmul_rn(s_rr[r], x[r * T]));
  lik[site] = l;
  sc[site] = count;
}

// Dynamic shared memory of one block (tree_smem_bytes in plf_tree.py).
template <int C>
size_t smem_bytes(int ncols, int n_slots, int threads) {
  constexpr int R = plf::S * C;
  return sizeof(float) * ((size_t)R * plf::S + (size_t)R * ncols + R +
                          (size_t)n_slots * R * threads);
}

template <int C, typename CodeT>
int launch(const void* codes, const int* sched, int n_edges, const float* lcs,
           const float* rcs, const float* ec, const float* ttab, int ncols,
           const float* rr, int n_slots, int root_slot, float* lik, int* sc,
           int n, int n_pad, int threads, cudaStream_t st) {
  const size_t smem = smem_bytes<C>(ncols, n_slots, threads);
  auto kern = plf_tree_kernel<C, CodeT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_pad + threads - 1) / threads);
  kern<<<grid, threads, smem, st>>>(static_cast<const CodeT*>(codes), sched,
                                    n_edges, lcs, rcs, ec, ttab, ncols, rr,
                                    root_slot, lik, sc, n, n_pad);
  return (int)cudaGetLastError();
}

template <int C, typename CodeT>
int occupancy(int ncols, int n_slots, int threads, int* blocks) {
  const size_t smem = smem_bytes<C>(ncols, n_slots, threads);
  auto kern = plf_tree_kernel<C, CodeT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                            threads, smem);
}

}  // namespace

// codes: (n_leaves, n_pad) int32 (code_bytes 4) or int8 (code_bytes 1);
// sched: (6, n_edges) int32 rows lsrc, lflag, rsrc, rflag, oslot, eidx;
// lcs, rcs: (E, S*C, S) fp32; ec: (S*C, S); ttab: (S*C, ncols); rr: (S*C,);
// lik: (n_pad,) fp32; sc: (n_pad,) int32.  Returns cudaGetLastError().
extern "C" int plf_tree_launch(const void* codes, int code_bytes,
                               const int* sched, int n_edges, const float* lcs,
                               const float* rcs, const float* ec,
                               const float* ttab, int ncols, const float* rr,
                               int n_slots, int root_slot, float* lik, int* sc,
                               int n, int n_pad, int categories, int threads,
                               void* stream) {
  if (n_pad <= 0 || n_edges <= 0 || threads <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4) {
    PLF_DISPATCH_C(categories, return launch<C_, int32_t>(
                                   codes, sched, n_edges, lcs, rcs, ec, ttab,
                                   ncols, rr, n_slots, root_slot, lik, sc, n,
                                   n_pad, threads, st));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_C(categories, return launch<C_, int8_t>(
                                   codes, sched, n_edges, lcs, rcs, ec, ttab,
                                   ncols, rr, n_slots, root_slot, lik, sc, n,
                                   n_pad, threads, st));
  }
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of the launch plf_tree_launch would make with these
// arguments (registers and shared memory both counted by the runtime).
extern "C" int plf_tree_occupancy(int code_bytes, int categories, int ncols,
                                  int n_slots, int threads, int* blocks) {
  if (code_bytes == 4) {
    PLF_DISPATCH_C(categories, return occupancy<C_, int32_t>(
                                   ncols, n_slots, threads, blocks));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_C(categories, return occupancy<C_, int8_t>(
                                   ncols, n_slots, threads, blocks));
  }
  return (int)cudaErrorInvalidValue;
}
