// Kernel 8m: the segmented whole-tree backward in the matrix forms (VJP of
// kernel 7m).
//
// Replaces the MXU form of plf_tpu/ops/plf_tree_seg.py::_seg_bwd_kernel
// (:843, launched by _seg_bwd_call :1095; its is_mxu branches :877-881,
// :997-999, :1037-1049, through make_mxu_bwd_ops, plf_tpu/ops/
// plf_pallas.py:196) and serves the "vpu" variant at S != 4 in fp32 mode;
// kernel 8 (plf_tree_seg_bwd.cu) keeps S = 4 "vpu".  It is kernel 4m's
// per-block backward (plf_tree_bwd_mxu.cu) walked segment by segment in
// reverse, as kernel 8 walks kernel 4's.  Over the program of
// segment_program(reuse_slots=False) (op j of a segment owns checkpoint
// slot j; operands are tips, slots or boundary ids, as in kernel 7m), for
// s = n_seg-1 .. 0:
//
//   phase 1  recompute the segment's ops exactly as kernel 7m does (tips
//            from the codes and the variant's rounded tip table, boundary
//            CLVs from bbuf) and checkpoint each op's CLV and rescale flag;
//   seed     the last segment (the tree's root): g = glik on valid sites,
//            grr[r] += sum_s x_root[r] * g and the root's slot becomes rr[r]
//            * g (kernel 4m's seed); any other segment: its root's slot
//            becomes the boundary adjoint its consumer wrote to gbuf;
//   phase 2  kernel 4m's reverse sweep over the segment's ops (edge-major,
//            the edge's accumulators summed over all of the block's sites
//            and flushed once); an internal child's slot flips to its
//            adjoint, a boundary child's adjoint goes to gbuf [boundary]
//            [row][site] for the segment that produced it, a tip child's is
//            never formed.
//
// Every boundary is produced by one segment and consumed by exactly one
// later one, so its adjoint is written once, before the producer (earlier in
// forward order, later in this walk) reads it; one block owns its sites
// through every segment, so that chain is a write and a read by one block
// across barriers, and nothing is ordered between blocks.  gbuf and the
// checkpoint are read with plain loads, never the read-only cache.
//
// Layout and memory.  The sweep's device code, the [row][site] 8-site tiles,
// the accumulators' placement and the per-block partial rows with their
// fixed-order second pass (no float atomics: bit-identical run to run) are
// kernel 4m's (plf_mxu_bwd.cuh), the second pass in fp64 as kernel 8's.  The
// op checkpoint lives in device memory as kernel 4m's does, [slot][row][site]
// with the chunk's length as row stride, but holds one segment's ops
// (seg_ops slots, 321 bytes each per site at S = 20, C = 4) instead of the
// whole tree's: at S = 61 one slot of one tile is 7.8 KB, so the segment's
// checkpoint would not fit shared memory beside kernel 4m's six tiles.  The
// host launches over chunks of sites so that it fits a budget, one wave of
// resident blocks each (plf_tree_seg_bwd_mxu in ops/plf_tree_seg.py).
//
// Bound: kernel 4m's work (the forward recompute, three stages and two
// adjoint stages, three operator gradients per op), plus reading each
// boundary CLV once and writing and reading each boundary adjoint once.
// Latency-bound at the occupancy kernel 4m's tiles allow, as kernel 4m is.
//
// bf16 storage (BT = __nv_bfloat16, PLFConfig(dtype="bfloat16")): bbuf holds
// kernel 7m's rounded boundaries, widened as phase 1 loads them; the seed of
// a segment's root widens its gbuf row; a boundary child's adjoint, which
// adjoint_to writes in fp32, is staged in the x1 or x2 tile (free once the
// sums have read them, a barrier later) and narrowed from there into gbuf, as
// the TPU kernel's gexp scratch narrows it (:1070-1075).  kernel 4m never
// instantiates BT, so its code is the float form of the shared header.
#include <type_traits>

#include "plf_mxu_bwd.cuh"

namespace {

constexpr int kThreads = plf_mxu::kBwdThreads;
constexpr int kSites = plf_mxu::kBwdSites;  // TS

template <int MODE, int V, typename CodeT, typename BT>
__global__ void __launch_bounds__(kThreads)
plf_tree_seg_bwd_mxu_kernel(
    const CodeT* __restrict__ codes, const int* __restrict__ prog,
    int n_ops, const int* __restrict__ segs, int n_seg, const float* lh,
    const float* ll, const float* rh, const float* rl, const float* lTh,
    const float* lTl, const float* rTh, const float* rTl, const float* eh,
    const float* el, const float* eTh, const float* eTl,
    const float* __restrict__ ttab, int ncols, const float* __restrict__ rr,
    const float* __restrict__ glik, const BT* bbuf, BT* gbuf,
    float* scratch, unsigned char* flags, int seg_ops, int site0, int chunk,
    float* __restrict__ partial, float* acc_global, int accumulate,
    int tiles_per_block, int n, int n_pad, int S, int C) {
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
  for (int j = tid; j < 3 * RS; j += kThreads) acc[j] = 0.0f;
  for (int r = tid; r < R; r += kThreads) s_grr[r] = 0.0f;

  const int* lsrc = prog;
  const int* lflag = prog + n_ops;
  const int* rsrc = prog + 2 * n_ops;
  const int* rflag = prog + 3 * n_ops;
  const int* oslot = prog + 4 * n_ops;
  const int* eidx = prog + 5 * n_ops;
  const int E = n_ops;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, chunk / kSites);
  const size_t slot_stride = (size_t)R * chunk;
  const size_t bnd_stride = (size_t)R * n_pad;
  const size_t cols = (size_t)2 * E * RS + RS + R;
  float* part = partial + blockIdx.x * cols;

  // fp32 storage: a boundary child's adjoint goes straight to gbuf; bf16
  // storage stages it in shared memory first (see the top of this file),
  // all of it under `if constexpr`.  Keep the fp32 form's code free of the
  // staging: passing the staging tile through `place` gave it 12 bytes of
  // spills and cost it 3-5% in "mxu_3x" on an H100 (kernel_turns.py).
  constexpr bool kStage = !std::is_same<BT, float>::value;

  // Where operand (src, flag) of the tile at chunk offset local0 lies, rows
  // `stride` floats apart: a checkpoint slot or, in fp32 storage, a boundary
  // row of gbuf (tips have no place; load expands them).
  auto place = [&](int src, int flag, int local0, size_t* stride) -> float* {
    if (flag == 1) {
      *stride = chunk;
      return scratch + (size_t)src * slot_stride + local0;
    }
    *stride = n_pad;
    if constexpr (kStage) {
      return nullptr;  // staged in tA / tB instead
    } else {
      return gbuf + (size_t)src * bnd_stride + site0 + local0;
    }
  };
  auto load = [&](int src, int flag, int local0, float* dst) {
    if (flag == 0) {
      plf_mxu::expand_tip(codes + (size_t)src * n_pad + site0 + local0, ttab,
                          ncols, tile, dst);
    } else if (flag == 2) {
      plf_mxu::load_tile(bbuf + (size_t)src * bnd_stride + site0 + local0,
                         n_pad, tile, dst);
    } else {
      size_t stride;
      plf_mxu::load_tile(place(src, flag, local0, &stride), stride, tile, dst);
    }
  };

  bool first = true;  // the first op swept: its gec share starts the sum
  for (int sg = n_seg - 1; sg >= 0; --sg) {
    const int start = sg ? __ldg(segs + 2 * (sg - 1)) : 0;
    const int end = __ldg(segs + 2 * sg);
    const int gout = __ldg(segs + 2 * sg + 1);
    if (end - start > seg_ops) __trap();  // the checkpoint was sized for less

    // ---- phase 1: the segment's forward recompute, checkpointed ----
    for (int t = t0; t < t1; ++t) {
      const int local0 = t * kSites;
      for (int i = start; i < end; ++i) {
        if (tid < kSites) s_big[tid] = 0;
        load(__ldg(lsrc + i), __ldg(lflag + i), local0, tA);
        load(__ldg(rsrc + i), __ldg(rflag + i), local0, tB);
        __syncthreads();
        const size_t e = (size_t)__ldg(eidx + i) * RS;
        plf_mxu::node_tile<MODE, V>(tA, tB, tP, tA, lh + e, ll + e, rh + e,
                                    rl + e, eh, el, S, C, kSites, s_big);
        const int slot = __ldg(oslot + i);
        plf_mxu::checkpoint_tile(tA, s_big,
                                 scratch + (size_t)slot * slot_stride + local0,
                                 chunk, flags + (size_t)slot * chunk + local0,
                                 n - (site0 + local0), tile);
        __syncthreads();
      }
    }

    // ---- seed: the root's adjoint ----
    const int root = __ldg(oslot + end - 1);
    for (int t = t0; t < t1; ++t) {
      const int local0 = t * kSites;
      float* dst = scratch + (size_t)root * slot_stride + local0;
      if (gout < 0) {
        plf_mxu::load_tile(dst, chunk, tile, tA);
        if (tid < kSites) {
          const int site = site0 + local0 + tid;
          s_g[tid] = site < n ? glik[site] : 0.0f;
        }
        __syncthreads();
        plf_mxu::seed_root(tA, s_g, s_grr, rr, dst, chunk, R);
      } else {
        const BT* g = gbuf + (size_t)gout * bnd_stride + site0 + local0;
        for (int j = tid; j < tile; j += kThreads)
          dst[(size_t)(j / kSites) * chunk + j % kSites] =
              plf::widen(g[(size_t)(j / kSites) * n_pad + j % kSites]);
      }
      __syncthreads();
    }

    // ---- phase 2: reverse sweep, slots flip from CLV to adjoint ----
    for (int i = end - 1; i >= start; --i) {
      const int ls = __ldg(lsrc + i), lf = __ldg(lflag + i);
      const int rs = __ldg(rsrc + i), rf = __ldg(rflag + i);
      const int slot = __ldg(oslot + i);
      const int eo = __ldg(eidx + i);
      const size_t e = (size_t)eo * RS;
      for (int t = t0; t < t1; ++t) {
        const int local0 = t * kSites;
        load(ls, lf, local0, tA);
        load(rs, rf, local0, tB);
        plf_mxu::load_adjoint(scratch + (size_t)slot * slot_stride + local0,
                              chunk, flags + (size_t)slot * chunk + local0,
                              tile, tG);
        __syncthreads();
        plf_mxu::sweep_products<MODE, V>(tA, tB, tG, tU1, tU2, tP, lh + e,
                                         ll + e, rh + e, rl + e, eTh, eTl, S,
                                         C);
        plf_mxu::sweep_sums<MODE>(tA, tB, tP, tU1, tU2, tG, acc, S, C);
        size_t sl = 0, sr = 0;
        float* dl = lf ? place(ls, lf, local0, &sl) : nullptr;
        float* dr = rf ? place(rs, rf, local0, &sr) : nullptr;
        if constexpr (kStage) {
          if (lf == 2 || rf == 2) __syncthreads();  // sums done with tA/tB
          if (lf == 2) {
            dl = tA;
            sl = kSites;
          }
          if (rf == 2) {
            dr = tB;
            sr = kSites;
          }
        }
        plf_mxu::adjoint_to<MODE, V>(tU1, tU2, lTh + e, lTl + e, rTh + e,
                                     rTl + e, dl, sl, dr, sr, S, C);
        __syncthreads();
        if constexpr (kStage) {
          if (lf == 2 || rf == 2) {
            for (int j = tid; j < tile; j += kThreads) {
              const size_t off = (size_t)(j / kSites) * n_pad + site0 +
                                 local0 + j % kSites;
              if (lf == 2)
                gbuf[(size_t)ls * bnd_stride + off] = plf::narrow<BT>(tA[j]);
              if (rf == 2)
                gbuf[(size_t)rs * bnd_stride + off] = plf::narrow<BT>(tB[j]);
            }
            __syncthreads();  // before the next tile's loads rewrite tA/tB
          }
        }
      }
      plf_mxu::flush_edge(acc, part, E, S, C, eo, !accumulate,
                          !accumulate && first);
      first = false;
    }
  }
  for (int r = tid; r < R; r += kThreads) {
    float* d = part + (size_t)2 * E * RS + RS + r;
    *d = accumulate ? __fadd_rn(*d, s_grr[r]) : s_grr[r];
  }
}

// bf16 storage with the one-pass bf16 mode ("mxu_bf16"), which no gradient
// backend runs: never instantiated, so the bf16 library holds 8 of these
// kernels where the float one holds 12.
template <int MODE, typename BT>
constexpr bool kBf16Mode2 = MODE == 2 && !std::is_same<BT, float>::value;

template <int MODE, int V, typename CodeT, typename BT>
int launch(const void* codes, const int* prog, int n_ops, const int* segs,
           int n_seg, const float* const* pl, const float* ttab, int ncols,
           const float* rr, const float* glik, const void* bbuf, void* gbuf,
           float* scratch, unsigned char* flags, int seg_ops, int site0,
           int chunk, float* partial, float* acc_global, int accumulate,
           int n_blocks, int tiles_per_block, int n, int n_pad, int S, int C,
           cudaStream_t st) {
  if constexpr (kBf16Mode2<MODE, BT>) {
    return (int)cudaErrorInvalidValue;
  } else {
    auto kern = plf_tree_seg_bwd_mxu_kernel<MODE, V, CodeT, BT>;
    const size_t smem =
        plf_mxu::bwd_smem_bytes(S * C, S, acc_global == nullptr);
    cudaError_t err = plf_mxu::bwd_prepare(kern, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<n_blocks, kThreads, smem, st>>>(
        static_cast<const CodeT*>(codes), prog, n_ops, segs, n_seg, pl[0],
        pl[1], pl[2], pl[3], pl[4], pl[5], pl[6], pl[7], pl[8], pl[9],
        pl[10], pl[11], ttab, ncols, rr, glik, static_cast<const BT*>(bbuf),
        static_cast<BT*>(gbuf), scratch, flags, seg_ops, site0, chunk,
        partial, acc_global, accumulate, tiles_per_block, n, n_pad, S, C);
    return (int)cudaGetLastError();
  }
}

template <int MODE, int V, typename CodeT, typename BT>
int plan(int R, int S, int* acc_shared, int* blocks) {
  if constexpr (kBf16Mode2<MODE, BT>) {
    return (int)cudaErrorInvalidValue;
  } else {
    return plf_mxu::bwd_plan(plf_tree_seg_bwd_mxu_kernel<MODE, V, CodeT, BT>,
                             R, S, acc_shared, blocks);
  }
}

}  // namespace

// One chunk of sites [site0, site0 + chunk).  codes: (n_leaves, n_pad) int32
// (code_bytes 4) or int8 (1); prog: (6, n_ops) int32 rows lsrc, lflag, rsrc,
// rflag, oslot (op j of a segment owns slot j), edge; segs: (n_seg, 2)
// int32; the twelve planes, each (E, S*C, S) fp32 by original edge or (S*C,
// S) for the EV constants: lc hi/lo, rc hi/lo, their transposes lcT hi/lo,
// rcT hi/lo, ec hi/lo, ecT hi/lo (lo is read in bf16x3 mode only); ttab:
// (S*C, ncols), rounded as the forward's tips; rr: (S*C,); glik: (n_pad,)
// fp32; bbuf, gbuf: (n_boundaries, S*C, n_pad), fp32, or bf16 when bf16 is
// set; scratch: (seg_ops, S*C, chunk) fp32; flags: (seg_ops, chunk) bytes;
// partial: (n_blocks, 2*E*S*C*S + S*C*S + S*C) fp32 (written when accumulate
// is 0, added to otherwise); acc_global: (n_blocks, 3*S*C*S) fp32 when
// plf_tree_seg_bwd_mxu_plan put the accumulators in device memory, else
// null.  chunk is a multiple of 8 sites; block b takes tiles [b *
// tiles_per_block, ...) of the chunk.  mode: 0 fp32, 1 bf16x3, 2 bf16; the
// bf16 storage library has no mode 2 ("mxu_bf16" never trains; kBf16Mode2).
// Returns cudaGetLastError(); a segment with more than seg_ops ops stops the
// kernel (the checkpoint was sized for seg_ops).
extern "C" int plf_tree_seg_bwd_mxu_launch(
    const void* codes, int code_bytes, const int* prog, int n_ops,
    const int* segs, int n_seg, const float* lh, const float* ll,
    const float* rh, const float* rl, const float* lTh, const float* lTl,
    const float* rTh, const float* rTl, const float* eh, const float* el,
    const float* eTh, const float* eTl, const float* ttab, int ncols,
    const float* rr, const float* glik, const void* bbuf, void* gbuf,
    float* scratch, unsigned char* flags, int seg_ops, int site0, int chunk,
    float* partial, float* acc_global, int accumulate, int n_blocks,
    int tiles_per_block, int n, int n_pad, int states, int categories,
    int mode, int bf16, void* stream) {
  if (n_pad <= 0 || chunk <= 0 || chunk % kSites || site0 < 0 ||
      site0 + chunk > n_pad || n_ops <= 0 || n_seg <= 0 || seg_ops <= 0 ||
      n_blocks <= 0 || tiles_per_block <= 0 || states < 1 || categories < 1 ||
      (long long)n_blocks * tiles_per_block * kSites < chunk)
    return (int)cudaErrorInvalidValue;
  const float* pl[12] = {lh, ll, rh, rl, lTh, lTl, rTh, rTl, eh, el, eTh, eTl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4) {
    PLF_DISPATCH_T(bf16, PLF_MXU_DISPATCH(mode, states,
                     return launch<M_, V_, int32_t, T_>(
                         codes, prog, n_ops, segs, n_seg, pl, ttab, ncols, rr,
                         glik, bbuf, gbuf, scratch, flags, seg_ops, site0,
                         chunk, partial, acc_global, accumulate, n_blocks,
                         tiles_per_block, n, n_pad, states, categories, st)));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_T(bf16, PLF_MXU_DISPATCH(mode, states,
                     return launch<M_, V_, int8_t, T_>(
                         codes, prog, n_ops, segs, n_seg, pl, ttab, ncols, rr,
                         glik, bbuf, gbuf, scratch, flags, seg_ops, site0,
                         chunk, partial, acc_global, accumulate, n_blocks,
                         tiles_per_block, n, n_pad, states, categories, st)));
  }
  return (int)cudaErrorInvalidValue;
}

// Where the launch keeps its accumulators (*acc_shared: 1 in shared memory,
// 0 in device memory, acc_global) and how many of its blocks are resident
// per SM: kernel 4m's rule (plf_mxu::bwd_plan).
extern "C" int plf_tree_seg_bwd_mxu_plan(int code_bytes, int states,
                                         int categories, int mode, int bf16,
                                         int* acc_shared, int* blocks) {
  const int R = states * categories;
  if (code_bytes == 4) {
    PLF_DISPATCH_T(bf16, PLF_MXU_DISPATCH(mode, states,
                     return plan<M_, V_, int32_t, T_>(R, states, acc_shared,
                                                    blocks)));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_T(bf16, PLF_MXU_DISPATCH(mode, states,
                     return plan<M_, V_, int8_t, T_>(R, states, acc_shared,
                                                    blocks)));
  }
  return (int)cudaErrorInvalidValue;
}

// The fixed-order second pass over the partial rows: out[c] = sum over rows
// b of partial[b][c], in row order, in fp64 as kernel 8's.
extern "C" int plf_tree_seg_bwd_mxu_reduce(const float* partial, int rows,
                                           int cols, float* out,
                                           void* stream) {
  return plf::colsum64(partial, rows, cols, out,
                       static_cast<cudaStream_t>(stream));
}
