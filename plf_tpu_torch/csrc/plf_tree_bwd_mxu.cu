// Kernel 4m: the checkpointed whole-tree backward in the matrix forms (VJP of
// kernel 2m).
//
// Replaces the MXU form of plf_tpu/ops/plf_tree_grad.py::_tree_bwd_kernel
// (:110; the is_mxu branches :121-125, :140-145, :153-156, :189-203, through
// make_mxu_bwd_ops, plf_tpu/ops/plf_pallas.py:196) and serves the "vpu"
// variant at S != 4 in fp32 mode; kernel 4 (plf_tree_bwd.cu) keeps S = 4
// "vpu".  Over the schedule of compile_backward_schedule (lpos, rpos, eidx):
//
//   phase 1  recompute the forward exactly as kernel 2m does (node_tile of
//            plf_mxu.cuh, tips expanded from the tip table the forward used,
//            already rounded for the variant) and checkpoint every internal
//            CLV and its rescale flag;
//   seed     g = glik on valid sites (0 on padding); grr[r] += sum_s
//            x_root[r] * g; the root's slot becomes its adjoint rr[r] * g;
//   phase 2  for i = E-1 .. 0: g_y = f * adjoint, u1 = S1(x1; L), u2 =
//            S1(x2; R), g_p = S3(g_y; E^T), g_u1 = g_p*u2, g_u2 = g_p*u1,
//            and the internal children's slots flip to their adjoints
//            S1(g_u1; L^T), S1(g_u2; R^T); a tip child's adjoint is never
//            stored.  Every stage runs in the variant's arithmetic
//            (stage_block), with planes split once on the host.
//
// The operator gradients are the lane-constant entries of the JAX kernel's
// (rows, rows) block gradients gout @ in^T: g[o*C+c][q] = sum_s
// in[q*C+c][s] * gout[o*C+c][s] for (in, gout) = (x1, g_u1) -> gl[e],
// (x2, g_u2) -> gr[e], (p, g_y) -> gec, in the mode's arithmetic
// (tile_dot): fp32 products; bf16-rounded operands; or the bf16x3 split with
// hh + (hl + lh), combined per tile of sites.  The reverse sweep's device
// code (tile_dot, sweep_products, sweep_sums, adjoint_to, flush_edge) and
// the accumulators' placement (bwd_plan) live in plf_mxu_bwd.cuh, shared
// with kernel 8m.  The split is a pure function
// of a value, so splitting an operand where it is read gives the values
// make_mxu_bwd_ops splits once; the kernel spends the ALU work to keep one
// tile per operand instead of three.
//
// Layout.  A block of 128 threads walks tiles of kSites = 8 sites (as kernel
// 2m).  In the operator-gradient sums a thread owns entries m*R*S + q*R + r
// (r fastest), so a warp reads C input rows (broadcast) and consecutive
// gradient rows, each as two float4; with q fastest its input rows q*C +
// r%C, 32 floats apart, would all fall on one shared-memory bank.  Rows do not fit a thread (80 at S = 20, 244 at S = 61), so operands
// live in [row][site] shared-memory tiles: x1, x2, g_y, g_u1, g_u2 and p.  The
// checkpoint lives in device memory, [slot][row][site] with the chunk's
// length as row stride, and one flag byte per slot and site (63 x 321 B =
// 20 KB a site at 64 taxa, S = 20); the host launches over chunks of sites so
// that it fits a budget (plf_tree_bwd_mxu in ops/plf_tree_grad.py).
//
// Shared memory, and what is kept out of it.  Phase 2 is edge-major (edges
// outer, tiles inner, as kernel 4), so each edge's gl/gr entries are summed
// over all of the block's sites before they are written once.  The
// accumulators of the current edge (gl, gr and its gec share, 3*R*S floats)
// sit in shared memory when two such blocks fit an SM: 19 KB at S = 20,
// C = 4 (35 KB in all; registers allow 5 blocks per SM).  At S = 61 they are
// 178 KB (226 KB in all, one block of 4 warps per SM, too few to hide the
// latency of the serial sums), so they live in `acc_global`, a private row
// of device memory per block (L2-resident in part), and the same code reads
// and writes its accumulators there: 47 KB of shared memory.  This library
// makes that choice (plf_tree_bwd_mxu_plan, from the runtime's occupancy
// with the accumulators in shared memory); the host allocates acc_global
// when told to, and the kernel reads the choice from acc_global != null.  The
// tip table (244 x 62 floats at S = 61) and the root row vector are read
// through the read-only cache.
//
// Per-block partials.  Each block writes one row of 2*E*R*S + R*S + R
// floats (gl by edge, gr by edge, gec, grr); a fixed-order second pass
// (plf::colsum) adds the rows up: no float atomics, bit-identical run to run.
// The host launches no more blocks than fit the card at once
// (plf_tree_bwd_mxu_plan's blocks per SM x SMs: one wave, no tail) and caps
// the rows
// at 2 GB (3.75 MB each at S = 61, 31 edges); later chunks add into the
// rows of the first (`accumulate`).
//
// Bound: compute and latency, as kernel 2m.  Device-memory traffic per site
// and node is a few CLV tiles (~1.6 KB at S = 20); the work is ~35,000 fp32
// operations per site and node at S = 20, C = 4 (forward recompute, three
// stages and two adjoint stages, three operator gradients), three times the
// products in bf16x3 mode.
#include "plf_mxu_bwd.cuh"

namespace {

constexpr int kThreads = plf_mxu::kBwdThreads;
constexpr int kSites = plf_mxu::kBwdSites;  // TS

template <int MODE, int V, typename CodeT>
__global__ void __launch_bounds__(kThreads)
plf_tree_bwd_mxu_kernel(const CodeT* __restrict__ codes, int n_leaves,
                        const int* __restrict__ bsched, int n_edges,
                        const float* lh, const float* ll, const float* rh,
                        const float* rl, const float* lTh, const float* lTl,
                        const float* rTh, const float* rTl, const float* eh,
                        const float* el, const float* eTh, const float* eTl,
                        const float* __restrict__ ttab, int ncols,
                        const float* __restrict__ rr,
                        const float* __restrict__ glik, float* scratch,
                        unsigned char* flags, int site0, int chunk,
                        float* __restrict__ partial, float* acc_global,
                        int accumulate, int tiles_per_block, int n, int n_pad,
                        int S, int C) {
  extern __shared__ float smem[];
  const int R = S * C, RS = R * S, tile = R * kSites;
  float* tA = smem;          // x1 (and the recomputed parent in phase 1)
  float* tB = tA + tile;     // x2
  float* tG = tB + tile;     // g_y
  float* tU1 = tG + tile;    // g_u1
  float* tU2 = tU1 + tile;   // g_u2
  float* tP = tU2 + tile;    // p = u1 * u2 (phase 1: the stage-2 products)
  int* s_big = reinterpret_cast<int*>(tP + tile);         // kSites
  float* s_g = reinterpret_cast<float*>(s_big + kSites);  // kSites
  float* s_grr = s_g + kSites;                            // R
  float* acc = acc_global ? acc_global + (size_t)blockIdx.x * 3 * RS
                          : s_grr + R;                    // 3 * RS
  const int tid = threadIdx.x;
  // In the sums each thread owns the accumulator entries tid + k * kThreads
  // and the grr rows tid + k * kThreads.
  for (int j = tid; j < 3 * RS; j += kThreads) acc[j] = 0.0f;
  for (int r = tid; r < R; r += kThreads) s_grr[r] = 0.0f;

  const int* lpos = bsched;
  const int* rpos = bsched + n_edges;
  const int* eidx = bsched + 2 * n_edges;
  const int E = n_edges;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, chunk / kSites);
  const size_t slot_stride = (size_t)R * chunk;
  const size_t cols = (size_t)2 * E * RS + RS + R;
  float* part = partial + blockIdx.x * cols;

  // Operand `pos` of the tile at chunk offset local0 into a shared tile: a
  // tip's table columns or a checkpointed slot.
  auto load = [&](int pos, int local0, float* dst) {
    if (pos < n_leaves)
      plf_mxu::expand_tip(codes + (size_t)pos * n_pad + site0 + local0, ttab,
                          ncols, tile, dst);
    else
      plf_mxu::load_tile(
          scratch + (size_t)(pos - n_leaves) * slot_stride + local0, chunk,
          tile, dst);
  };

  // ---- phase 1: forward recompute, every internal CLV checkpointed ----
  for (int t = t0; t < t1; ++t) {
    const int local0 = t * kSites;
    for (int i = 0; i < E; ++i) {
      if (tid < kSites) s_big[tid] = 0;
      load(__ldg(lpos + i), local0, tA);
      load(__ldg(rpos + i), local0, tB);
      __syncthreads();
      const size_t e = (size_t)__ldg(eidx + i) * RS;
      plf_mxu::node_tile<MODE, V>(tA, tB, tP, tA, lh + e, ll + e, rh + e,
                                  rl + e, eh, el, S, C, kSites, s_big);
      plf_mxu::checkpoint_tile(tA, s_big,
                               scratch + (size_t)i * slot_stride + local0,
                               chunk, flags + (size_t)i * chunk + local0,
                               n - (site0 + local0), tile);
      __syncthreads();
    }
  }

  // ---- seed: root-vector gradient and the root adjoint ----
  for (int t = t0; t < t1; ++t) {
    const int local0 = t * kSites;
    load(n_leaves + E - 1, local0, tA);
    if (tid < kSites) {
      const int site = site0 + local0 + tid;
      s_g[tid] = site < n ? glik[site] : 0.0f;
    }
    __syncthreads();
    plf_mxu::seed_root(tA, s_g, s_grr, rr,
                       scratch + (size_t)(E - 1) * slot_stride + local0, chunk,
                       R);
    __syncthreads();
  }

  // ---- phase 2: reverse sweep, slots flip from CLV to adjoint ----
  for (int i = E - 1; i >= 0; --i) {
    const int lp = __ldg(lpos + i), rp = __ldg(rpos + i);
    const int eo = __ldg(eidx + i);
    const size_t e = (size_t)eo * RS;
    for (int t = t0; t < t1; ++t) {
      const int local0 = t * kSites;
      load(lp, local0, tA);
      load(rp, local0, tB);
      plf_mxu::load_adjoint(scratch + (size_t)i * slot_stride + local0, chunk,
                            flags + (size_t)i * chunk + local0, tile, tG);
      __syncthreads();
      plf_mxu::sweep_products<MODE, V>(tA, tB, tG, tU1, tU2, tP, lh + e,
                                       ll + e, rh + e, rl + e, eTh, eTl, S,
                                       C);
      plf_mxu::sweep_sums<MODE>(tA, tB, tP, tU1, tU2, tG, acc, S, C);
      auto slot = [&](int pos) -> float* {
        return pos < n_leaves ? nullptr
                              : scratch + (size_t)(pos - n_leaves) * slot_stride +
                                    local0;
      };
      plf_mxu::adjoint_to<MODE, V>(tU1, tU2, lTh + e, lTl + e, rTh + e,
                                   rTl + e, slot(lp), chunk, slot(rp), chunk,
                                   S, C);
      __syncthreads();
    }
    plf_mxu::flush_edge(acc, part, E, S, C, eo, !accumulate,
                        !accumulate && i == E - 1);
  }
  for (int r = tid; r < R; r += kThreads) {
    float* d = part + (size_t)2 * E * RS + RS + r;
    *d = accumulate ? __fadd_rn(*d, s_grr[r]) : s_grr[r];
  }
}

template <int MODE, int V, typename CodeT>
int launch(const void* codes, int n_leaves, const int* bsched, int n_edges,
           const float* const* pl, const float* ttab, int ncols,
           const float* rr, const float* glik, float* scratch,
           unsigned char* flags, int site0, int chunk, float* partial,
           float* acc_global, int accumulate, int n_blocks,
           int tiles_per_block, int n, int n_pad, int S, int C,
           cudaStream_t st) {
  auto kern = plf_tree_bwd_mxu_kernel<MODE, V, CodeT>;
  const size_t smem = plf_mxu::bwd_smem_bytes(S * C, S, acc_global == nullptr);
  cudaError_t err = plf_mxu::bwd_prepare(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<n_blocks, kThreads, smem, st>>>(
      static_cast<const CodeT*>(codes), n_leaves, bsched, n_edges, pl[0],
      pl[1], pl[2], pl[3], pl[4], pl[5], pl[6], pl[7], pl[8], pl[9], pl[10],
      pl[11], ttab, ncols, rr, glik, scratch, flags, site0, chunk, partial,
      acc_global, accumulate, tiles_per_block, n, n_pad, S, C);
  return (int)cudaGetLastError();
}

}  // namespace

// One chunk of sites [site0, site0 + chunk).  codes: (n_leaves, n_pad) int32
// (code_bytes 4) or int8 (1); bsched: (3, n_edges) int32 rows lpos, rpos,
// eidx; the twelve planes, each (E, S*C, S) fp32 by original edge or (S*C, S)
// for the EV constants: lc hi/lo, rc hi/lo, their transposes lcT hi/lo, rcT
// hi/lo, ec hi/lo, ecT hi/lo (lo is read in bf16x3 mode only); ttab: (S*C,
// ncols), rounded as the forward's tips; rr: (S*C,); glik: (n_pad,) fp32;
// scratch: (E, S*C, chunk) fp32; flags: (E, chunk) bytes; partial: (n_blocks,
// 2*E*S*C*S + S*C*S + S*C) fp32 (written when accumulate is 0, added to
// otherwise); acc_global: (n_blocks, 3*S*C*S) fp32 when
// plf_tree_bwd_mxu_plan put the accumulators in device memory, else null.
// chunk is a multiple of 8 sites; block b
// takes tiles [b * tiles_per_block, ...) of the chunk.  mode: 0 fp32, 1
// bf16x3, 2 bf16.  Returns cudaGetLastError().
extern "C" int plf_tree_bwd_mxu_launch(
    const void* codes, int code_bytes, int n_leaves, const int* bsched,
    int n_edges, const float* lh, const float* ll, const float* rh,
    const float* rl, const float* lTh, const float* lTl, const float* rTh,
    const float* rTl, const float* eh, const float* el, const float* eTh,
    const float* eTl, const float* ttab, int ncols, const float* rr,
    const float* glik, float* scratch, unsigned char* flags, int site0,
    int chunk, float* partial, float* acc_global, int accumulate,
    int n_blocks, int tiles_per_block, int n, int n_pad, int states,
    int categories, int mode, void* stream) {
  if (n_pad <= 0 || chunk <= 0 || chunk % kSites || site0 < 0 ||
      site0 + chunk > n_pad || n_edges <= 0 || n_blocks <= 0 ||
      tiles_per_block <= 0 || states < 1 || categories < 1 ||
      (long long)n_blocks * tiles_per_block * kSites < chunk)
    return (int)cudaErrorInvalidValue;
  const float* pl[12] = {lh, ll, rh, rl, lTh, lTl, rTh, rTl, eh, el, eTh, eTl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4) {
    PLF_MXU_DISPATCH(mode, states,
                     return launch<M_, V_, int32_t>(
                         codes, n_leaves, bsched, n_edges, pl, ttab, ncols, rr,
                         glik, scratch, flags, site0, chunk, partial,
                         acc_global, accumulate, n_blocks, tiles_per_block, n,
                         n_pad, states, categories, st));
  } else if (code_bytes == 1) {
    PLF_MXU_DISPATCH(mode, states,
                     return launch<M_, V_, int8_t>(
                         codes, n_leaves, bsched, n_edges, pl, ttab, ncols, rr,
                         glik, scratch, flags, site0, chunk, partial,
                         acc_global, accumulate, n_blocks, tiles_per_block, n,
                         n_pad, states, categories, st));
  }
  return (int)cudaErrorInvalidValue;
}

// Where the launch keeps its accumulators (*acc_shared: 1 in shared memory,
// 0 in device memory, acc_global) and how many of its blocks are resident
// per SM (registers and shared memory both counted by the runtime).
extern "C" int plf_tree_bwd_mxu_plan(int code_bytes, int states,
                                     int categories, int mode,
                                     int* acc_shared, int* blocks) {
  const int R = states * categories;
  if (code_bytes == 4) {
    PLF_MXU_DISPATCH(mode, states,
                     return plf_mxu::bwd_plan(
                         plf_tree_bwd_mxu_kernel<M_, V_, int32_t>, R, states,
                         acc_shared, blocks));
  } else if (code_bytes == 1) {
    PLF_MXU_DISPATCH(mode, states,
                     return plf_mxu::bwd_plan(
                         plf_tree_bwd_mxu_kernel<M_, V_, int8_t>, R, states,
                         acc_shared, blocks));
  }
  return (int)cudaErrorInvalidValue;
}

// The fixed-order second pass over the partial rows: out[c] = sum over rows
// b of partial[b][c], in row order.
extern "C" int plf_tree_bwd_mxu_reduce(const float* partial, int rows,
                                       int cols, float* out, void* stream) {
  return plf::colsum(partial, rows, cols, out,
                     static_cast<cudaStream_t>(stream));
}
