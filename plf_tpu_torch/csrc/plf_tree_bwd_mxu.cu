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
// (x2, g_u2) -> gr[e], (p, g_y) -> gec: per tile, a GEMM with K = the
// tile's sites for each (matrix, category), on the tensor cores in the
// bf16 modes (bf16 products are exact in fp32) and register-blocked fp32 on
// the CUDA cores in "mxu" (tile_sums).  The reverse sweep's device code
// (sweep_products, tile_sums, adjoint_to, flush_edge), the tile and the
// accumulators' placement (bwd_plan) live in plf_mxu_bwd.cuh,
// shared with kernel 8m.  The split is a pure function of a value, so
// splitting an operand where it is read gives the values make_mxu_bwd_ops
// splits once.
//
// Layout.  A block walks tiles of TS sites: 32 at S = 20 with 320 threads
// (kernel 1m's width: each stage's 20 jobs of 4 rows fill the 10 warps in
// 2 rounds, and a warp reads one operator address at a time), 8 at S = 61
// with 128 (64 jobs, 4 rounds; 16-site tiles would halve the blocks per
// SM): plf_tree_bwd_mxu_plan tells the host, which passes the tile back to
// each launch.  Rows do not fit a thread (80 at S = 20, 244 at S = 61), so
// operands live in [row][site] shared-memory tiles: x1, x2, g_y, g_u1, g_u2
// and p (61 KB at S = 20, 47 KB at S = 61).  The checkpoint lives in device
// memory, [slot][row][site] with the chunk's length as row stride, and one
// flag byte per slot and site (63 x 321 B = 20 KB a site at 64 taxa, S =
// 20); the host launches over chunks of sites so that it fits a budget
// (plf_tree_bwd_mxu in ops/plf_tree_grad.py).
//
// Shared memory, and what is kept out of it.  Phase 2 is edge-major (edges
// outer, tiles inner, as kernel 4), so each edge's gl/gr entries are summed
// over all of the block's sites before they are written once.  The
// accumulators of the current edge (gl, gr and its gec share, 3*R*S
// floats) are read and written once per tile by the lane that owns them,
// in shared memory when two blocks with them fit an SM, and otherwise in
// `acc_global`, a private row of device memory per block: at S = 20 19 KB
// beside 61 KB of tiles (two blocks of 320 threads), in shared memory; at
// S = 61 178 KB, in device memory.  Registers across the edge's tiles
// would need 30 floats a thread at C = 4 and more with C (up to 8).  This
// library makes the choice (plf_tree_bwd_mxu_plan, from the runtime's
// occupancy); the host allocates acc_global when told to, and the kernel
// reads the choice from acc_global != null.  The tip table (244 x 62 floats at S = 61) and
// the root row vector are read through the read-only cache.
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
// stage products in bf16x3 mode; the operator gradients (a third to a half
// of the work as CUDA-core sums) run on the tensor cores in the bf16 modes.
// With them out of the way the stages' latency binds: more warps per SM
// (320 threads a block, not 128) moved the kernel most (PERF.md, PR 11).
#include "plf_mxu_bwd.cuh"

namespace {

template <int MODE, int V, int TS, typename CodeT>
__global__ void __launch_bounds__(plf_mxu::bwd_threads(TS),
                                  plf_mxu::bwd_min_blocks(TS))
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
  constexpr int NT = plf_mxu::bwd_threads(TS);
  const int R = S * C, RS = R * S, tile = R * TS;
  float* tA = smem;          // x1 (and the recomputed parent in phase 1)
  float* tB = tA + tile;     // x2
  float* tG = tB + tile;     // g_y
  float* tU1 = tG + tile;    // g_u1
  float* tU2 = tU1 + tile;   // g_u2
  float* tP = tU2 + tile;    // p = u1 * u2 (phase 1: the stage-2 products)
  int* s_big = reinterpret_cast<int*>(tP + tile);     // TS
  float* s_g = reinterpret_cast<float*>(s_big + TS);  // TS
  float* s_grr = s_g + TS;                            // R
  float* acc = acc_global ? acc_global + (size_t)blockIdx.x * 3 * RS
                          : s_grr + R;                // 3 * RS
  const int tid = threadIdx.x;
  // Each thread owns the grr rows tid + k * NT.
  for (int j = tid; j < 3 * RS; j += NT) acc[j] = 0.0f;
  for (int r = tid; r < R; r += NT) s_grr[r] = 0.0f;

  const int* lpos = bsched;
  const int* rpos = bsched + n_edges;
  const int* eidx = bsched + 2 * n_edges;
  const int E = n_edges;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, chunk / TS);
  const size_t slot_stride = (size_t)R * chunk;
  const size_t cols = (size_t)2 * E * RS + RS + R;
  float* part = partial + blockIdx.x * cols;

  // Operand `pos` of the tile at chunk offset local0 into a shared tile: a
  // tip's table columns or a checkpointed slot.
  auto load = [&](int pos, int local0, float* dst) {
    if (pos < n_leaves)
      plf_mxu::expand_tip<TS, NT>(codes + (size_t)pos * n_pad + site0 + local0, ttab,
                          ncols, tile, dst);
    else
      plf_mxu::load_tile<TS, NT>(
          scratch + (size_t)(pos - n_leaves) * slot_stride + local0, chunk,
          tile, dst);
  };

  // ---- phase 1: forward recompute, every internal CLV checkpointed ----
  for (int t = t0; t < t1; ++t) {
    const int local0 = t * TS;
    for (int i = 0; i < E; ++i) {
      if (tid < TS) s_big[tid] = 0;
      load(__ldg(lpos + i), local0, tA);
      load(__ldg(rpos + i), local0, tB);
      __syncthreads();
      const size_t e = (size_t)__ldg(eidx + i) * RS;
      plf_mxu::node_tile<MODE, V>(tA, tB, tP, tA, lh + e, ll + e, rh + e,
                                  rl + e, eh, el, S, C, TS, s_big);
      plf_mxu::checkpoint_tile<TS, NT>(tA, s_big,
                               scratch + (size_t)i * slot_stride + local0,
                               chunk, flags + (size_t)i * chunk + local0,
                               n - (site0 + local0), tile);
      __syncthreads();
    }
  }

  // ---- seed: root-vector gradient and the root adjoint ----
  for (int t = t0; t < t1; ++t) {
    const int local0 = t * TS;
    load(n_leaves + E - 1, local0, tA);
    if (tid < TS) {
      const int site = site0 + local0 + tid;
      s_g[tid] = site < n ? glik[site] : 0.0f;
    }
    __syncthreads();
    plf_mxu::seed_root<TS, NT>(tA, s_g, s_grr, rr,
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
      const int local0 = t * TS;
      load(lp, local0, tA);
      load(rp, local0, tB);
      plf_mxu::load_adjoint<TS, NT>(scratch + (size_t)i * slot_stride + local0, chunk,
                            flags + (size_t)i * chunk + local0, tile, tG);
      __syncthreads();
      plf_mxu::sweep_products<MODE, V, TS, NT>(tA, tB, tG, tU1, tU2, tP, lh + e,
                                           ll + e, rh + e, rl + e, eTh, eTl,
                                           S, C);
      plf_mxu::tile_sums<MODE, TS, NT>(tA, tB, tP, tU1, tU2, tG, acc, S, C);
      auto slot = [&](int pos) -> float* {
        return pos < n_leaves ? nullptr
                              : scratch + (size_t)(pos - n_leaves) * slot_stride +
                                    local0;
      };
      plf_mxu::adjoint_to<MODE, V, TS, NT>(tU1, tU2, lTh + e, lTl + e, rTh + e,
                                       rTl + e, slot(lp), chunk, slot(rp),
                                       chunk, S, C);
      __syncthreads();
    }
    plf_mxu::flush_edge<NT>(acc, part, E, S, C, eo, !accumulate,
                        !accumulate && i == E - 1);
  }
  for (int r = tid; r < R; r += NT) {
    float* d = part + (size_t)2 * E * RS + RS + r;
    *d = accumulate ? __fadd_rn(*d, s_grr[r]) : s_grr[r];
  }
}

template <int MODE, int V, int TS, typename CodeT>
int launch(const void* codes, int n_leaves, const int* bsched, int n_edges,
           const float* const* pl, const float* ttab, int ncols,
           const float* rr, const float* glik, float* scratch,
           unsigned char* flags, int site0, int chunk, float* partial,
           float* acc_global, int accumulate, int n_blocks,
           int tiles_per_block, int n, int n_pad, int S, int C,
           cudaStream_t st) {
  auto kern = plf_tree_bwd_mxu_kernel<MODE, V, TS, CodeT>;
  const size_t smem = plf_mxu::bwd_smem_bytes(
      S * C, S, acc_global == nullptr, TS);
  cudaError_t err = plf_mxu::bwd_prepare(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<n_blocks, plf_mxu::bwd_threads(TS), smem, st>>>(
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
// plf_tree_bwd_mxu_plan put the accumulators in device memory, else null.  chunk is a multiple of the plan's tile of sites; block b takes
// tiles [b * tiles_per_block, ...) of the chunk.  mode: 0 fp32, 1
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
  if (states < 1 || categories < 1) return (int)cudaErrorInvalidValue;
  const int ts = plf_mxu::bwd_tile(states);
  if (n_pad <= 0 || chunk <= 0 || chunk % ts || site0 < 0 ||
      site0 + chunk > n_pad || n_edges <= 0 || n_blocks <= 0 ||
      tiles_per_block <= 0 ||
      (long long)n_blocks * tiles_per_block * ts < chunk)
    return (int)cudaErrorInvalidValue;
  const float* pl[12] = {lh, ll, rh, rl, lTh, lTl, rTh, rTl, eh, el, eTh, eTl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4) {
    PLF_MXU_BWD_DISPATCH(mode, states,
                     return launch<M_, V_, T_S, int32_t>(
                         codes, n_leaves, bsched, n_edges, pl, ttab, ncols, rr,
                         glik, scratch, flags, site0, chunk, partial,
                         acc_global, accumulate, n_blocks, tiles_per_block, n,
                         n_pad, states, categories, st));
  } else if (code_bytes == 1) {
    PLF_MXU_BWD_DISPATCH(mode, states,
                     return launch<M_, V_, T_S, int8_t>(
                         codes, n_leaves, bsched, n_edges, pl, ttab, ncols, rr,
                         glik, scratch, flags, site0, chunk, partial,
                         acc_global, accumulate, n_blocks, tiles_per_block, n,
                         n_pad, states, categories, st));
  }
  return (int)cudaErrorInvalidValue;
}

// The launch's plan: its tile of sites (*sites), where it keeps its
// accumulators (*acc_shared: 1 in shared memory, 0 in device memory,
// acc_global) and how many of its blocks are resident per SM (registers and
// shared memory both counted by the runtime).
extern "C" int plf_tree_bwd_mxu_plan(int code_bytes, int states,
                                     int categories, int mode,
                                     int* acc_shared, int* blocks,
                                     int* sites) {
  const int R = states * categories;
  if (states < 1 || categories < 1 || (code_bytes != 4 && code_bytes != 1))
    return (int)cudaErrorInvalidValue;
  *sites = plf_mxu::bwd_tile(states);
  if (code_bytes == 4)
    PLF_MXU_BWD_DISPATCH(mode, states,
                         return plf_mxu::bwd_plan(
                             plf_tree_bwd_mxu_kernel<M_, V_, T_S, int32_t>, R,
                             states, acc_shared, blocks, T_S,
                             plf_mxu::bwd_threads(T_S)));
  PLF_MXU_BWD_DISPATCH(mode, states,
                       return plf_mxu::bwd_plan(
                           plf_tree_bwd_mxu_kernel<M_, V_, T_S, int8_t>, R,
                           states, acc_shared, blocks, T_S,
                           plf_mxu::bwd_threads(T_S)));
  return (int)cudaErrorInvalidValue;
}

// The fixed-order second pass over the partial rows: out[c] = sum over rows
// b of partial[b][c], in row order.
extern "C" int plf_tree_bwd_mxu_reduce(const float* partial, int rows,
                                       int cols, float* out, void* stream) {
  return plf::colsum(partial, rows, cols, out,
                     static_cast<cudaStream_t>(stream));
}
