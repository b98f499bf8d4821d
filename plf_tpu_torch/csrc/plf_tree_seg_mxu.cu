// Kernel 7m: the segmented whole-tree forward likelihood in the matrix forms.
//
// Replaces the MXU form of plf_tpu/ops/plf_tree_seg.py::_seg_fwd_kernel
// (:383, launched by _seg_fwd_call :591; its is_mxu branches :432-433,
// :535-537, :554) and serves the "vpu" variant at S != 4 in fp32 mode;
// kernel 7 (plf_tree_seg.cu) keeps S = 4 "vpu".  The TPU kernel runs a
// sequential grid of (segments x site blocks) with boundary CLVs streamed
// in and out by DMA and a scaler row carried between segments; here site
// tiles are independent, so one block walks every segment of the plan in
// order for its tile and nothing is ordered between blocks.
//
// The program is kernel 7's (segment_program in ops/plf_tree_seg.py): for
// op i, (lsrc, lflag), (rsrc, rflag) are a tip id (flag 0, the tile
// expanded from the int32 or int8 codes: one exact column select of the tip
// table the host rounded for the variant), an arena slot (flag 1) or a
// boundary id (flag 2, the tile read from bbuf [boundary][row][site]);
// oslot is the register-allocated output slot (slots are reused within a
// segment) and edge the original edge of the operator planes.  segs[s] =
// (end of segment s's ops, exported boundary id or -1): at the end of a
// segment its root tile goes to bbuf, and the last segment's root to the
// site likelihood.  Each op is kernel 2m's (plf_mxu.cuh's node_tile and the
// same rescale) and the root reduction is kernel 2m's sequential fp32 one,
// so with fp32 boundaries, which round-trip exactly, lik and sc equal kernel
// 2m's bit for bit in every mode.
//
// Bound: kernel 2m's, plus the boundary buffer: per site the tip codes
// once, 8 bytes of output, and each boundary CLV written once and read
// back once (320 bytes each at S = 20, C = 4); the work is 6*C*S^2 flops
// per site and op in fp32 mode, three times the products in bf16x3 mode.
// It is latency-bound at the occupancy its arena allows, as kernel 2m is;
// the arena holds only the slots live in one segment.
//
// Block: kernel 2m's job shape (plf_mxu.cuh's block_threads and job_rows;
// plf_tree_seg_mxu_block reports it): 8-site tiles and one job slot of 8
// threads per job of a stage, 160 threads at S = 20, C = 4, 416 at S = 61
// (five-row jobs), 32 at S = 4.  The loops that move whole tiles (bring,
// the rescale, the boundary export) stride by blockDim.x, and the root
// reduction and the count take the kSites threads tid < kSites, which
// every block size of the rule holds (at least one job slot).
//
// Candidate axis (blockIdx.y), as in kernel 7: candidate b walks its own
// program prog[b] and segment rows segs[b] (padded past its last segment to
// the batch's most with rows that end where the last one does: the loop
// stops at the first segment with no ops), through its own boundary buffer
// bbuf[b] (n_bnd boundaries, the batch's most), into its own lik and sc
// rows; the operator planes are one table that every program's edge row
// indexes.  Each row equals a single-tree launch bit for bit; a batch of one
// runs the single-tree kernel (kBatch false: its pointers stay kernel
// parameters, and it reads no padding row).  Replaces
// plf_tpu/ops/plf_tree_seg.py::batched_seg_loglik_parts (:1376).
//
// bf16 boundaries (BT = __nv_bfloat16, PLFConfig(dtype="bfloat16")): the
// root tile is narrowed as it is exported and a boundary tile widened as it
// is brought in, as the TPU kernel's bf16 landing scratch does (:452-484,
// :568), so a consumer computes on the rounded row; lik and sc then differ
// from kernel 2m's by that rounding, and 160 bytes of each boundary move
// where 320 did.
#include "plf_mxu.cuh"

namespace {

using plf_mxu::block_threads;
using plf_mxu::job_rows;
using plf_mxu::kMaxThreads;
using plf_mxu::kSites;

template <int MODE, int V, typename CodeT, typename BT, bool kBatch>
__global__ void __launch_bounds__(kMaxThreads)
plf_tree_seg_mxu_kernel(const CodeT* codes, const int* prog, int n_ops,
                        const int* segs, int n_seg, const float* lh,
                        const float* ll, const float* rh, const float* rl,
                        const float* eh, const float* el, const float* ttab,
                        int ncols, const float* rr, BT* bbuf, int n_bnd,
                        float* lik, int* sc, int n_slots, int n, int n_pad,
                        int S, int C) {
  extern __shared__ float smem[];
  const int rows = S * C;
  if constexpr (kBatch) {  // this block's candidate
    const size_t cand = blockIdx.y;
    prog += cand * 6 * n_ops;
    segs += cand * 2 * n_seg;
    bbuf += cand * n_bnd * rows * n_pad;
    lik += cand * n_pad;
    sc += cand * n_pad;
  }
  const int tile = rows * kSites;
  const size_t op_stride = (size_t)rows * S;  // one edge's operator plane
  const size_t bnd_stride = (size_t)rows * n_pad;
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
  for (int i = tid; i < rows * ncols; i += blockDim.x) s_tt[i] = ttab[i];
  for (int i = tid; i < rows; i += blockDim.x) s_rr[i] = rr[i];
  if (tid < kSites) s_cnt[tid] = 0;
  __syncthreads();

  const int* lsrc = prog;
  const int* lflag = prog + n_ops;
  const int* rsrc = prog + 2 * n_ops;
  const int* rflag = prog + 3 * n_ops;
  const int* oslot = prog + 4 * n_ops;
  const int* eidx = prog + 5 * n_ops;

  // A tip (its table columns; a code outside the table, or a site past
  // n_pad, gives zeros) or a boundary CLV (flag 2) into the tile `dst`; an
  // arena slot (flag 1) is used where it lies.  bbuf rows are written and
  // read back by this block alone: plain loads, never the read-only cache.
  auto bring = [&](int src, int flag, float* dst) {
    for (int i = tid; i < tile; i += blockDim.x) {
      const int site = site0 + i % kSites;
      float v = 0.0f;
      if (site < n_pad) {
        if (flag == 2) {
          v = plf::widen(bbuf[(size_t)src * bnd_stride +
                              (size_t)(i / kSites) * n_pad + site]);
        } else {
          const int code = (int)codes[(size_t)src * n_pad + site];
          if (code >= 0 && code < ncols) v = s_tt[(i / kSites) * ncols + code];
        }
      }
      dst[i] = v;
    }
  };

  int i = 0;
  for (int s = 0; s < n_seg; ++s) {
    const int end = __ldg(segs + 2 * s);
    const int gout = __ldg(segs + 2 * s + 1);
    if (kBatch && end <= i) break;  // a padding row: the candidate is done
    for (; i < end; ++i) {
      const size_t e = (size_t)__ldg(eidx + i) * op_stride;
      float* out = arena + (size_t)__ldg(oslot + i) * tile;
      const int ls = __ldg(lsrc + i), lf = __ldg(lflag + i);
      const int rs = __ldg(rsrc + i), rf = __ldg(rflag + i);
      if (tid < kSites) s_big[tid] = 0;
      if (lf != 1) bring(ls, lf, tip_l);
      if (rf != 1) bring(rs, rf, tip_r);
      __syncthreads();
      plf_mxu::node_tile<MODE, V, job_rows(V)>(
          lf == 1 ? arena + (size_t)ls * tile : tip_l,
          rf == 1 ? arena + (size_t)rs * tile : tip_r, prod, out, lh + e,
          ll + e, rh + e, rl + e, eh, el, S, C, kSites, s_big);
      for (int j = tid; j < tile; j += blockDim.x) {
        const int ss = j % kSites;
        if (!s_big[ss] && site0 + ss < n)
          out[j] = __fmul_rn(out[j], plf::TWO_TO_THE_32);
      }
      if (tid < kSites && !s_big[tid] && site0 + tid < n) s_cnt[tid] += 1;
      __syncthreads();
    }
    const float* root = arena + (size_t)__ldg(oslot + end - 1) * tile;
    if (gout >= 0) {
      // The next op's first barrier orders these reads of the root slot
      // before any write that reuses it.
      for (int j = tid; j < tile; j += blockDim.x) {
        const int site = site0 + j % kSites;
        if (site < n_pad)
          bbuf[(size_t)gout * bnd_stride + (size_t)(j / kSites) * n_pad +
               site] = plf::narrow<BT>(root[j]);
      }
    } else if (tid < kSites && site0 + tid < n_pad) {
      const float* x = root + tid;
      float l = __fmul_rn(s_rr[0], x[0]);
      for (int r = 1; r < rows; ++r)
        l = __fadd_rn(l, __fmul_rn(s_rr[r], x[r * kSites]));
      lik[site0 + tid] = l;
      sc[site0 + tid] = s_cnt[tid];
    }
  }
}

// Dynamic shared memory of one block (tree_mxu_smem_bytes in plf_tree.py:
// kernel 2m's layout for the segment's live slots).
size_t smem_bytes(int rows, int ncols, int n_slots) {
  return sizeof(float) * ((size_t)rows * ncols + rows + 2 * (size_t)kSites +
                          ((size_t)n_slots + 3) * rows * kSites);
}

template <int MODE, int V, typename CodeT, typename BT, bool kBatch>
cudaError_t prepare(size_t smem) {
  return cudaFuncSetAttribute(
      plf_tree_seg_mxu_kernel<MODE, V, CodeT, BT, kBatch>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int MODE, int V, typename CodeT, typename BT>
int launch(const void* codes, const int* prog, int n_ops, const int* segs,
           int n_seg, const float* const* pl, const float* ttab, int ncols,
           const float* rr, void* bbuf, int n_bnd, float* lik, int* sc,
           int n_slots, int n, int n_pad, int S, int C, int batch,
           cudaStream_t st) {
  const size_t smem = smem_bytes(S * C, ncols, n_slots);
  const bool batched = batch > 1;
  auto kern = batched ? plf_tree_seg_mxu_kernel<MODE, V, CodeT, BT, true>
                      : plf_tree_seg_mxu_kernel<MODE, V, CodeT, BT, false>;
  cudaError_t err = batched ? prepare<MODE, V, CodeT, BT, true>(smem)
                            : prepare<MODE, V, CodeT, BT, false>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_pad + kSites - 1) / kSites, batch);
  kern<<<grid, block_threads(S, C, job_rows(V)), smem, st>>>(
      static_cast<const CodeT*>(codes), prog, n_ops, segs, n_seg, pl[0],
      pl[1], pl[2], pl[3], pl[4], pl[5], ttab, ncols, rr,
      static_cast<BT*>(bbuf), n_bnd, lik, sc, n_slots, n, n_pad, S, C);
  return (int)cudaGetLastError();
}

template <int MODE, int V, typename CodeT, typename BT>
int occupancy(int S, int C, int ncols, int n_slots, int* blocks) {
  const size_t smem = smem_bytes(S * C, ncols, n_slots);
  cudaError_t err = prepare<MODE, V, CodeT, BT, false>(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, plf_tree_seg_mxu_kernel<MODE, V, CodeT, BT, false>,
      block_threads(S, C, job_rows(V)), smem);
}

}  // namespace

// codes: (n_leaves, n_pad) int32 (code_bytes 4) or int8 (1); prog: (batch,
// 6, n_ops) int32, each candidate's rows lsrc, lflag, rsrc, rflag, oslot,
// edge; segs: (batch, n_seg, 2) int32; lh/ll, rh/rl: (P, S*C, S) fp32 hi and
// lo planes of the operator table the edge rows index; eh/el: (S*C, S);
// ttab: (S*C, ncols), already rounded for the variant; rr: (S*C,); bbuf:
// (batch, n_bnd, S*C, n_pad), fp32, or bf16 when bf16 is set; lik, sc:
// (batch, n_pad) fp32 and int32.  mode: 0 fp32, 1 bf16x3, 2 bf16; batch in
// 1..65535.  Returns cudaGetLastError().
extern "C" int plf_tree_seg_mxu_launch(
    const void* codes, int code_bytes, const int* prog, int n_ops,
    const int* segs, int n_seg, const float* lh, const float* ll,
    const float* rh, const float* rl, const float* eh, const float* el,
    const float* ttab, int ncols, const float* rr, void* bbuf, int n_bnd,
    float* lik, int* sc, int n_slots, int n, int n_pad, int states,
    int categories, int mode, int bf16, int batch, void* stream) {
  if (n_pad <= 0 || n_ops <= 0 || n_seg <= 0 || n_slots <= 0 || states < 1 ||
      categories < 1 || n_bnd < 0 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const float* pl[6] = {lh, ll, rh, rl, eh, el};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4) {
    PLF_DISPATCH_T(bf16, PLF_MXU_DISPATCH(mode, states,
                     return launch<M_, V_, int32_t, T_>(
                         codes, prog, n_ops, segs, n_seg, pl, ttab, ncols, rr,
                         bbuf, n_bnd, lik, sc, n_slots, n, n_pad, states,
                         categories, batch, st)));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_T(bf16, PLF_MXU_DISPATCH(mode, states,
                     return launch<M_, V_, int8_t, T_>(
                         codes, prog, n_ops, segs, n_seg, pl, ttab, ncols, rr,
                         bbuf, n_bnd, lik, sc, n_slots, n, n_pad, states,
                         categories, batch, st)));
  }
  return (int)cudaErrorInvalidValue;
}

// Threads per block and output rows per job of kernel 7m at this state and
// category count: kernel 2m's (plf_tree_mxu_block), from the same rule.
extern "C" int plf_tree_seg_mxu_block(int states, int categories,
                                      int* threads, int* rows) {
  if (states < 1 || categories < 1) return (int)cudaErrorInvalidValue;
  *rows = job_rows(states % 4 == 0 ? 4 : 1);
  *threads = block_threads(states, categories, *rows);
  return (int)cudaSuccess;
}

// Resident blocks per SM of the launch plf_tree_seg_mxu_launch would make
// with these arguments (registers and shared memory both counted by the
// runtime); bf16 names the library's boundary storage, as in the launch.
extern "C" int plf_tree_seg_mxu_occupancy(int code_bytes, int states,
                                          int categories, int ncols,
                                          int n_slots, int mode, int bf16,
                                          int* blocks) {
  if (states < 1 || categories < 1 || n_slots < 1)
    return (int)cudaErrorInvalidValue;
  if (code_bytes == 4) {
    PLF_DISPATCH_T(bf16, PLF_MXU_DISPATCH(mode, states,
                     return occupancy<M_, V_, int32_t, T_>(
                         states, categories, ncols, n_slots, blocks)));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_T(bf16, PLF_MXU_DISPATCH(mode, states,
                     return occupancy<M_, V_, int8_t, T_>(
                         states, categories, ncols, n_slots, blocks)));
  }
  return (int)cudaErrorInvalidValue;
}
