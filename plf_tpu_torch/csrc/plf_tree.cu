// Kernel 2: the whole-tree forward likelihood as a register machine.
//
// Replaces plf_tpu/ops/plf_tree_pallas.py::_tree_kernel (schedule unrolled at
// trace time) and ::_tree_kernel_dynamic (schedule as run-time arrays): one
// kernel serves both, since here a run-time schedule costs nothing to compile.
//
// Bound: latency at the occupancy the arena allows.  Device-memory traffic
// is small: the tip codes (n_leaves * 4 bytes per site as int32, a quarter
// of that as int8) plus 8 bytes of output per site.  Each schedule op does
// ~23 fp32 operations per CLV element, well under the card's peak rate.  The
// arena (n_slots * S*C * 4 bytes per site) caps the resident blocks per SM
// (plf_tree_occupancy reports them), and on an H100 the time grows as that
// cap falls (chip_smoke.py, profile phase, times the kernel with the arena
// padded so that fewer blocks fit).  Warp-scheduler slot use and
// shared-memory throughput are not measured (no hardware-counter profiler).
// Design:
//  * one thread per site walks the carried program of carry_program
//    (plf_tpu_torch/ops/plf_tree.py), derived from compile_register_schedule:
//    int32 arrays that every thread reads alike, so each read is one
//    broadcast.  An operand is a tip (flag 0), an arena slot (flag 1) or the
//    output of the op evaluated just before (flag 2), which stays in the
//    registers that computed it; an op stores its output (oslot >= 0) only
//    when a later op other than the next one reads it, so the arena holds
//    only those outputs (5 slots instead of 6 at 160 taxa, one block more per
//    SM).  The root op's output stays in registers for the root reduction.
//    The kernel also runs an uncarried schedule (no flag 2, every output
//    stored) to the same result;
//  * the next op's schedule entries and tip codes are read while the current
//    op computes, so the codes' device-memory latency is off the op chain;
//  * the arena of stored CLVs is in shared memory, laid out [slot][row][site]
//    so a warp's access to one row touches 32 consecutive words (no bank
//    conflicts).  It holds O(log taxa) slots after the taller-child-first
//    reordering: tips are expanded on demand from the int32 or int8 codes
//    through the tip table, one exact matched column, never preloaded (the
//    TPU kernel's preload is a Mosaic workaround);
//  * the output slot may be an operand's slot, freed by the same op: safe,
//    because a thread reads both operands into registers before it writes,
//    and a thread touches only its own sites' column of the arena;
//  * per-edge operators: op i+1's lc and rc rows (2 * S*C float4) are
//    copied from device memory into a shared-memory double buffer with
//    cp.async while op i computes, one barrier an op (the block's threads
//    walk the program in lockstep); reading them from device memory at an
//    address uniform over the block (the design before) took 6.8 ms where
//    this takes 4.0 at 160 taxa x 2^20 on an H100 (PERF.md).  The eigenvector
//    constants, tip table and root row vector are staged in shared memory;
//  * the root reduction lik = rr[0]*x[0] + rr[1]*x[1] + ... is sequential,
//    with separately rounded products and sums, as the TPU kernels do
//    (plf_tpu/ops/plf_tree_pallas.py:470-474).
//  * a candidate axis (blockIdx.y) for tree search: a launch scores a batch
//    of trees over one alignment, each candidate with its own program
//    (prog + y * 6 * n_edges) and its own rows of the outputs (y * n_pad),
//    all sharing the tip codes, the EV constants, the tip table and one
//    operator table that every program's eidx row indexes (the batch's
//    distinct (left, right) operator pairs: batch_inputs in
//    plf_tpu_torch/models/phylo.py).  The per-site arithmetic is the
//    single-tree kernel's, so a candidate's row equals that tree's
//    single-tree launch bit for bit; a single tree is a batch of one.
//    Replaces plf_tpu/ops/plf_tree_pallas.py::batched_tree_loglik_parts
//    (:628), which maps _tree_kernel_dynamic over the candidates in turn.
// The host picks the block's sites so the arena fits shared memory
// (tree_fused_threads in plf_tree.py, at the batch's largest slot count)
// and passes them as `block_sites`.
#include "plf_common.cuh"

namespace {

constexpr int kCarried = 2;  // operand flag: the previous op's output

// Dynamic shared memory of one block (tree_fused_smem_bytes in
// plf_tree.py): the EV constants, two buffers of an op's operators, the tip
// table, the root row vector and the arena.
template <int C>
size_t smem_bytes(int ncols, int n_slots, int block_sites) {
  constexpr int R = plf::S * C;
  return sizeof(float) * ((size_t)R * plf::S + (size_t)R * ncols + R +
                          (size_t)n_slots * R * block_sites) +
         sizeof(float4) * 4 * R;
}

template <int C, typename CodeT>
__global__ void plf_tree_kernel(const CodeT* codes, const int* prog,
                                int n_edges, const float* lcs,
                                const float* rcs, const float* ec,
                                const float* ttab, int ncols, const float* rr,
                                float* lik, int* sc, int n, int n_pad) {
  constexpr int R = plf::S * C;
  extern __shared__ float4 smem4[];
  float4* s_ec = smem4;                                    // R float4
  float4* s_ops = smem4 + R;                               // 2 x (lc, rc)
  float* s_tt = reinterpret_cast<float*>(s_ops + 4 * R);   // R * ncols
  float* s_rr = s_tt + R * ncols;                          // R
  float* arena = s_rr + R;                                 // n_slots * R * T
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  prog += (size_t)blockIdx.y * 6 * n_edges;   // this candidate's program
  lik += (size_t)blockIdx.y * n_pad;
  sc += (size_t)blockIdx.y * n_pad;
  for (int i = tid; i < R; i += T) {
    s_ec[i] = reinterpret_cast<const float4*>(ec)[i];
    s_rr[i] = rr[i];
  }
  for (int i = tid; i < R * ncols; i += T) s_tt[i] = ttab[i];
  const int* lsrc = prog;
  const int* lflag = prog + n_edges;
  const int* rsrc = prog + 2 * n_edges;
  const int* rflag = prog + 3 * n_edges;
  const int* oslot = prog + 4 * n_edges;
  const int* eidx = prog + 5 * n_edges;
  // op i's lc and rc rows into buffer i % 2, one float4 a thread
  auto stage_ops = [&](int i) {
    plf::stage_ops<C>(s_ops + (i & 1) * 2 * R, lcs, rcs, __ldg(eidx + i),
                      tid);
  };
  stage_ops(0);
  __syncthreads();

  // A thread past n_pad (in a block's last sites) stays for the barriers:
  // it reads site n_pad - 1 and stores nothing.
  const int site = blockIdx.x * T + tid;
  const bool valid = site < n;
  const int at = min(site, n_pad - 1);
  float out[R];  // the output of the op evaluated last
  // this site's code of a tip operand (flag 0), else unread
  auto code_of = [&](int src, int flag) {
    return flag == 0 ? (int)codes[(size_t)src * n_pad + at] : 0;
  };
  auto load = [&](int src, int flag, int code, float (&x)[R]) {
    if (flag == kCarried) {
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = out[r];
    } else if (flag) {  // arena slot
      const float* s = arena + (size_t)src * R * T + tid;
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = s[r * T];
    } else {            // tip: the table column of this site's code
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
  int ls = __ldg(lsrc), lf = __ldg(lflag), rs = __ldg(rsrc), rf = __ldg(rflag);
  int lcode = code_of(ls, lf), rcode = code_of(rs, rf);
  for (int i = 0; i < n_edges; ++i) {
    float a[R], b[R];
    load(ls, lf, lcode, a);
    load(rs, rf, rcode, b);
    const int o = __ldg(oslot + i);
    if (i + 1 < n_edges) {  // the next op's entries and codes, in flight
      ls = __ldg(lsrc + i + 1);
      lf = __ldg(lflag + i + 1);
      rs = __ldg(rsrc + i + 1);
      rf = __ldg(rflag + i + 1);
      lcode = code_of(ls, lf);
      rcode = code_of(rs, rf);
    }
    plf::cp_async_wait_all();
    __syncthreads();  // op i's operators landed; op i-1's buffer is free
    if (i + 1 < n_edges) stage_ops(i + 1);
    const float4* lc = s_ops + (i & 1) * 2 * R;
    count += plf::plf_site<C>(a, b, lc, lc + R, s_ec, valid, out);
    if (o >= 0) {
      float* d = arena + (size_t)o * R * T + tid;
#pragma unroll
      for (int r = 0; r < R; ++r) d[r * T] = out[r];
    }
  }

  float l = __fmul_rn(s_rr[0], out[0]);
#pragma unroll
  for (int r = 1; r < R; ++r) l = __fadd_rn(l, __fmul_rn(s_rr[r], out[r]));
  if (site < n_pad) {
    lik[site] = l;
    sc[site] = count;
  }
}

template <int C, typename CodeT>
int launch(const void* codes, const int* prog, int n_edges, const float* lcs,
           const float* rcs, const float* ec, const float* ttab, int ncols,
           const float* rr, int n_slots, float* lik, int* sc, int n,
           int n_pad, int block_sites, int batch, cudaStream_t st) {
  const size_t smem = smem_bytes<C>(ncols, n_slots, block_sites);
  auto kern = plf_tree_kernel<C, CodeT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_pad + block_sites - 1) / block_sites, batch);
  kern<<<grid, block_sites, smem, st>>>(static_cast<const CodeT*>(codes),
                                        prog, n_edges, lcs, rcs, ec, ttab,
                                        ncols, rr, lik, sc, n, n_pad);
  return (int)cudaGetLastError();
}

template <int C, typename CodeT>
int occupancy(int ncols, int n_slots, int block_sites, int* blocks) {
  const size_t smem = smem_bytes<C>(ncols, n_slots, block_sites);
  auto kern = plf_tree_kernel<C, CodeT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, block_sites, smem);
}

}  // namespace

// codes: (n_leaves, n_pad) int32 (code_bytes 4) or int8 (code_bytes 1);
// prog: (batch, 6, n_edges) int32, each candidate's rows lsrc, lflag, rsrc,
// rflag, oslot, eidx, flag
// 0 a tip, 1 an arena slot, 2 the previous op's output, oslot -1 for an
// output kept in registers only (carry_program in plf_tree.py; a schedule
// of compile_register_schedule runs too); lcs, rcs: (P, S*C, S) fp32, the
// operators that eidx indexes (P = E, by original edge, for one tree); ec:
// (S*C, S); ttab: (S*C, ncols); rr: (S*C,); n_slots: the largest arena of
// the programs; lik: (batch, n_pad) fp32; sc: (batch, n_pad) int32;
// block_sites: sites (one a thread) per block.  Returns cudaGetLastError().
extern "C" int plf_tree_launch(const void* codes, int code_bytes,
                               const int* prog, int n_edges, const float* lcs,
                               const float* rcs, const float* ec,
                               const float* ttab, int ncols, const float* rr,
                               int n_slots, float* lik, int* sc, int n,
                               int n_pad, int categories, int block_sites,
                               int batch, void* stream) {
  if (n_pad <= 0 || n_edges <= 0 || block_sites <= 0 || n_slots < 0 ||
      batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4) {
    PLF_DISPATCH_C(categories, return launch<C_, int32_t>(
                                   codes, prog, n_edges, lcs, rcs, ec, ttab,
                                   ncols, rr, n_slots, lik, sc, n, n_pad,
                                   block_sites, batch, st));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_C(categories, return launch<C_, int8_t>(
                                   codes, prog, n_edges, lcs, rcs, ec, ttab,
                                   ncols, rr, n_slots, lik, sc, n, n_pad,
                                   block_sites, batch, st));
  }
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of the launch plf_tree_launch would make with these
// arguments (registers and shared memory both counted by the runtime).
extern "C" int plf_tree_occupancy(int code_bytes, int categories, int ncols,
                                  int n_slots, int block_sites, int* blocks) {
  if (code_bytes == 4) {
    PLF_DISPATCH_C(categories, return occupancy<C_, int32_t>(
                                   ncols, n_slots, block_sites, blocks));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_C(categories, return occupancy<C_, int8_t>(
                                   ncols, n_slots, block_sites, blocks));
  }
  return (int)cudaErrorInvalidValue;
}

// Threads per block, sites per thread, dynamic shared memory bytes and the
// grid (site blocks x candidates) of the launch plf_tree_launch makes for
// `batch` candidates of n_pad sites in blocks of block_sites sites.
extern "C" int plf_tree_plan(int categories, int ncols, int n_slots,
                             int block_sites, int n_pad, int batch,
                             int* threads, int* sites_per_thread, int* smem,
                             int* grid_x, int* grid_y) {
  if (block_sites <= 0 || n_slots < 0 || n_pad <= 0 || batch < 1)
    return (int)cudaErrorInvalidValue;
  *threads = block_sites;
  *sites_per_thread = 1;
  *grid_x = (n_pad + block_sites - 1) / block_sites;
  *grid_y = batch;
  PLF_DISPATCH_C(categories,
                 *smem = (int)smem_bytes<C_>(ncols, n_slots, block_sites));
  return 0;
}
