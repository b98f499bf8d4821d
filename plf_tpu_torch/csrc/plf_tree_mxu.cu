// Kernel 2m: the whole-tree forward likelihood in the matrix forms, as a
// register machine.
//
// Replaces the MXU form of plf_tpu/ops/plf_tree_pallas.py::_tree_kernel
// (:209) and ::_tree_kernel_dynamic (:424) -- _plf_node_mxu (:186) per
// schedule op and _expand_tip(dot=) (:128) per tip -- and serves the "vpu"
// variant at S != 4 in fp32 mode; kernel 2 (plf_tree.cu) keeps S = 4 "vpu".
// The arithmetic of each mode and the thread layout are in plf_mxu.cuh.
//
// Bound: compute and latency.  Device-memory traffic is the tip codes
// (n_leaves * 4 bytes per site as int32) plus 8 bytes of output per site; the
// work is 6*C*S^2 flops per site and schedule op in fp32 mode (63 ops x 9,600
// at 64 taxa, S = 20, C = 4) and three times the products in bf16x3 mode.
// The arena caps the resident blocks per SM (plf_tree_mxu_occupancy).
// Design:
//  * a block owns kSites = 8 sites (narrow tiles leave room for more
//    resident blocks: 8 per SM at 64 taxa, S = 20, C = 4, where 16- and
//    32-site tiles allowed 5 and 2 and ran slower) and walks the int32
//    schedule of compile_register_schedule, one node_tile per op, with a
//    barrier between the phases of an op (operands ready, products ready,
//    parent written, rescale applied);
//  * its threads are the stage's jobs (block_threads in plf_mxu.cuh;
//    plf_tree_mxu_block reports them): each of an op's stages has C *
//    ceil(S / KB) jobs of KB output rows (job_rows: 4 where S % 4 == 0,
//    else 5), and the block
//    has 8 threads (one job slot) per job, so that every stage runs in one
//    round (S = 20, C = 4: 20 jobs, 160 threads; S = 61: 52 jobs, 416
//    threads), and in the fewest rounds of at most 64 slots where the jobs
//    exceed 64: 16 slots at S = 20 would run a second round of 4 jobs on
//    one warp while three wait at the barrier, and at S = 61 shared memory
//    holds two blocks an SM, which need many warps each.  On an H100
//    (PERF.md): 5-row jobs ran the S = 61 fp32 forward 22% faster than
//    4-row jobs (bf16x3 2% slower) and S = 20 2-4% slower; splitting each
//    source value once per stage ran 2% slower;
//  * shared memory holds the tip table and root row vector, the n_slots live
//    internal CLVs as [row][site] tiles, two tiles for tip operands and one
//    for the stage-2 products.  A tip is expanded into its tile from the
//    site's int32 or int8 code: one exact column select of the tip table,
//    which the host has already rounded as the variant's tip product would
//    (round_tip_table in ops/plf_mxu.py);
//  * the output slot may be an operand's slot, freed by the same op: stage 3
//    reads only the product tile, after every operand read has ended;
//  * per-edge operator planes are read from device memory (L2-resident, 6.4
//    KB per edge, side and plane at S = 20, C = 4) at addresses uniform over
//    each job's threads;
//  * the rescale test is reduced over all rows of a site through a shared
//    flag; the count per site stays in shared memory; the root reduction
//    lik = rr[0]*x[0] + rr[1]*x[1] + ... is sequential, as in kernel 2, on
//    the last op's output slot (the root's);
//  * a candidate axis (blockIdx.y), as in kernel 2: a launch scores a batch
//    of trees over one alignment, each with its own schedule (sched + y * 6
//    * n_edges) and output rows, sharing the codes, the tip table and one
//    table of operator planes that every schedule's eidx row indexes (the
//    batch's distinct (left, right) operator pairs).  Per-site arithmetic
//    is the single-tree kernel's, so each row equals that tree's launch bit
//    for bit.  Replaces the MXU form of plf_tpu/ops/plf_tree_pallas.py::
//    batched_tree_loglik_parts (:628).
#include "plf_mxu.cuh"

namespace {

// The job shape (kSites-site tiles, block_threads, job_rows) is plf_mxu.cuh's
// rule, which kernel 7m takes too.
using plf_mxu::block_threads;
using plf_mxu::job_rows;
using plf_mxu::kMaxThreads;
using plf_mxu::kSites;

template <int MODE, int V, typename CodeT>
__global__ void __launch_bounds__(kMaxThreads)
plf_tree_mxu_kernel(const CodeT* codes, const int* sched, int n_edges,
                    const float* lh, const float* ll, const float* rh,
                    const float* rl, const float* eh, const float* el,
                    const float* ttab, int ncols, const float* rr, int n_slots,
                    float* lik, int* sc, int n, int n_pad, int S, int C) {
  extern __shared__ float smem[];
  const int rows = S * C;
  const int tile = rows * kSites;
  const size_t op_stride = (size_t)rows * S;  // one edge's operator plane
  float* s_tt = smem;                                     // rows * ncols
  float* s_rr = s_tt + rows * ncols;                      // rows
  int* s_big = reinterpret_cast<int*>(s_rr + rows);       // kSites
  int* s_cnt = s_big + kSites;                            // kSites
  float* arena = reinterpret_cast<float*>(s_cnt + kSites);  // n_slots tiles
  float* tip_l = arena + (size_t)n_slots * tile;
  float* tip_r = tip_l + tile;
  float* prod = tip_r + tile;
  const int tid = threadIdx.x;
  const int site0 = blockIdx.x * kSites;
  sched += (size_t)blockIdx.y * 6 * n_edges;  // this candidate's schedule
  lik += (size_t)blockIdx.y * n_pad;
  sc += (size_t)blockIdx.y * n_pad;
  for (int i = tid; i < rows * ncols; i += blockDim.x) s_tt[i] = ttab[i];
  for (int i = tid; i < rows; i += blockDim.x) s_rr[i] = rr[i];
  if (tid < kSites) s_cnt[tid] = 0;
  __syncthreads();

  const int* lsrc = sched;
  const int* lflag = sched + n_edges;
  const int* rsrc = sched + 2 * n_edges;
  const int* rflag = sched + 3 * n_edges;
  const int* oslot = sched + 4 * n_edges;
  const int* eidx = sched + 5 * n_edges;

  // The tip of leaf `leaf` into a tile: the table column of each site's
  // code (a code outside the table, or a site past n_pad, gives zeros).
  auto expand = [&](int leaf, float* dst) {
    for (int i = tid; i < tile; i += blockDim.x) {
      const int site = site0 + i % kSites;
      const int code =
          site < n_pad ? (int)codes[(size_t)leaf * n_pad + site] : -1;
      const bool ok = code >= 0 && code < ncols;
      const float v = s_tt[(i / kSites) * ncols + (ok ? code : 0)];
      dst[i] = ok ? v : 0.0f;
    }
  };

  for (int i = 0; i < n_edges; ++i) {
    const int ls = __ldg(lsrc + i), lf = __ldg(lflag + i);
    const int rs = __ldg(rsrc + i), rf = __ldg(rflag + i);
    const size_t e = (size_t)__ldg(eidx + i) * op_stride;
    float* out = arena + (size_t)__ldg(oslot + i) * tile;
    if (tid < kSites) s_big[tid] = 0;
    if (!lf) expand(ls, tip_l);
    if (!rf) expand(rs, tip_r);
    __syncthreads();
    plf_mxu::node_tile<MODE, V, job_rows(V)>(
        lf ? arena + (size_t)ls * tile : tip_l,
        rf ? arena + (size_t)rs * tile : tip_r, prod, out, lh + e, ll + e,
        rh + e, rl + e, eh, el, S, C, kSites, s_big);
    for (int j = tid; j < tile; j += blockDim.x) {
      const int s = j % kSites;
      if (!s_big[s] && site0 + s < n)
        out[j] = __fmul_rn(out[j], plf::TWO_TO_THE_32);
    }
    if (tid < kSites && !s_big[tid] && site0 + tid < n) s_cnt[tid] += 1;
    __syncthreads();
  }

  if (tid < kSites && site0 + tid < n_pad) {
    const int root_slot = __ldg(oslot + n_edges - 1);
    const float* x = arena + (size_t)root_slot * tile + tid;
    float l = __fmul_rn(s_rr[0], x[0]);
    for (int r = 1; r < rows; ++r)
      l = __fadd_rn(l, __fmul_rn(s_rr[r], x[r * kSites]));
    lik[site0 + tid] = l;
    sc[site0 + tid] = s_cnt[tid];
  }
}

// Dynamic shared memory of one block (tree_mxu_smem_bytes in plf_tree.py).
size_t smem_bytes(int rows, int ncols, int n_slots) {
  return sizeof(float) * ((size_t)rows * ncols + rows + 2 * (size_t)kSites +
                          ((size_t)n_slots + 3) * rows * kSites);
}

template <int MODE, int V, typename CodeT>
cudaError_t prepare(size_t smem) {
  return cudaFuncSetAttribute(plf_tree_mxu_kernel<MODE, V, CodeT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int MODE, int V, typename CodeT>
int launch(const void* codes, const int* sched, int n_edges, const float* lh,
           const float* ll, const float* rh, const float* rl, const float* eh,
           const float* el, const float* ttab, int ncols, const float* rr,
           int n_slots, float* lik, int* sc, int n, int n_pad, int S, int C,
           int batch, cudaStream_t st) {
  const int threads = block_threads(S, C, job_rows(V));
  const size_t smem = smem_bytes(S * C, ncols, n_slots);
  cudaError_t err = prepare<MODE, V, CodeT>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_pad + kSites - 1) / kSites, batch);
  plf_tree_mxu_kernel<MODE, V, CodeT><<<grid, threads, smem, st>>>(
      static_cast<const CodeT*>(codes), sched, n_edges, lh, ll, rh, rl, eh, el,
      ttab, ncols, rr, n_slots, lik, sc, n, n_pad, S, C);
  return (int)cudaGetLastError();
}

template <int MODE, int V, typename CodeT>
int occupancy(int S, int C, int ncols, int n_slots, int* blocks) {
  const size_t smem = smem_bytes(S * C, ncols, n_slots);
  cudaError_t err = prepare<MODE, V, CodeT>(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, plf_tree_mxu_kernel<MODE, V, CodeT>,
      block_threads(S, C, job_rows(V)), smem);
}

}  // namespace

// codes: (n_leaves, n_pad) int32 (code_bytes 4) or int8 (code_bytes 1);
// sched: (batch, 6, n_edges) int32, each candidate's rows lsrc, lflag, rsrc,
// rflag, oslot, eidx (compile_register_schedule: the last op's oslot is the
// root's slot); lh/ll, rh/rl: (P, S*C, S) fp32 hi and lo planes of the
// lane constants that eidx indexes (P = E, by original edge, for one tree);
// eh/el: (S*C, S); ttab: (S*C, ncols), already rounded for the variant; rr:
// (S*C,); n_slots: the largest arena of the schedules; lik: (batch, n_pad)
// fp32; sc: (batch, n_pad) int32.
// mode: 0 fp32, 1 bf16x3, 2 bf16; the block's threads and each job's rows
// follow from states and categories (plf_tree_mxu_block).
// Returns cudaGetLastError().
extern "C" int plf_tree_mxu_launch(const void* codes, int code_bytes,
                                   const int* sched, int n_edges,
                                   const float* lh, const float* ll,
                                   const float* rh, const float* rl,
                                   const float* eh, const float* el,
                                   const float* ttab, int ncols,
                                   const float* rr, int n_slots, float* lik,
                                   int* sc, int n, int n_pad, int states,
                                   int categories, int mode, int batch,
                                   void* stream) {
  if (n_pad <= 0 || n_edges <= 0 || n_slots <= 0 || states < 1 ||
      categories < 1 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4) {
    PLF_MXU_DISPATCH(mode, states,
                     return launch<M_, V_, int32_t>(
                         codes, sched, n_edges, lh, ll, rh, rl, eh, el, ttab,
                         ncols, rr, n_slots, lik, sc, n, n_pad, states,
                         categories, batch, st));
  } else if (code_bytes == 1) {
    PLF_MXU_DISPATCH(mode, states,
                     return launch<M_, V_, int8_t>(
                         codes, sched, n_edges, lh, ll, rh, rl, eh, el, ttab,
                         ncols, rr, n_slots, lik, sc, n, n_pad, states,
                         categories, batch, st));
  }
  return (int)cudaErrorInvalidValue;
}

// Threads per block and output rows per job of kernel 2m at this state and
// category count (160 and 4 at S = 20, C = 4; 416 and 5 at S = 61, C = 4).
extern "C" int plf_tree_mxu_block(int states, int categories, int* threads,
                                  int* rows) {
  if (states < 1 || categories < 1) return (int)cudaErrorInvalidValue;
  *rows = job_rows(states % 4 == 0 ? 4 : 1);
  *threads = block_threads(states, categories, *rows);
  return (int)cudaSuccess;
}

// Resident blocks per SM of the launch plf_tree_mxu_launch would make with
// these arguments (registers and shared memory both counted by the runtime).
extern "C" int plf_tree_mxu_occupancy(int code_bytes, int states,
                                      int categories, int ncols, int n_slots,
                                      int mode, int* blocks) {
  if (states < 1 || categories < 1) return (int)cudaErrorInvalidValue;
  if (code_bytes == 4) {
    PLF_MXU_DISPATCH(mode, states,
                     return occupancy<M_, V_, int32_t>(
                         states, categories, ncols, n_slots, blocks));
  } else if (code_bytes == 1) {
    PLF_MXU_DISPATCH(mode, states,
                     return occupancy<M_, V_, int8_t>(
                         states, categories, ncols, n_slots, blocks));
  }
  return (int)cudaErrorInvalidValue;
}
