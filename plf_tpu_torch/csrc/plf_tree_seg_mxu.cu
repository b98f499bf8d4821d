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
// so lik and sc equal kernel 2m's bit for bit in every mode, and the
// boundary CLVs, stored in fp32, round-trip exactly.
//
// Bound: kernel 2m's, plus the boundary buffer: per site the tip codes
// once, 8 bytes of output, and each boundary CLV written once and read
// back once (320 bytes each at S = 20, C = 4); the work is 6*C*S^2 flops
// per site and op in fp32 mode, three times the products in bf16x3 mode.
// It is latency-bound at the occupancy its arena allows, as kernel 2m is;
// the arena holds only the slots live in one segment.
#include "plf_mxu.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSites = 8;  // TS, as kernel 2m

template <int MODE, int V, typename CodeT>
__global__ void __launch_bounds__(kThreads)
plf_tree_seg_mxu_kernel(const CodeT* codes, const int* prog, int n_ops,
                        const int* segs, int n_seg, const float* lh,
                        const float* ll, const float* rh, const float* rl,
                        const float* eh, const float* el, const float* ttab,
                        int ncols, const float* rr, float* bbuf, float* lik,
                        int* sc, int n_slots, int n, int n_pad, int S, int C) {
  extern __shared__ float smem[];
  const int rows = S * C;
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
          v = bbuf[(size_t)src * bnd_stride + (size_t)(i / kSites) * n_pad +
                   site];
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
    for (; i < end; ++i) {
      const size_t e = (size_t)__ldg(eidx + i) * op_stride;
      float* out = arena + (size_t)__ldg(oslot + i) * tile;
      const int ls = __ldg(lsrc + i), lf = __ldg(lflag + i);
      const int rs = __ldg(rsrc + i), rf = __ldg(rflag + i);
      if (tid < kSites) s_big[tid] = 0;
      if (lf != 1) bring(ls, lf, tip_l);
      if (rf != 1) bring(rs, rf, tip_r);
      __syncthreads();
      plf_mxu::node_tile<MODE, V>(lf == 1 ? arena + (size_t)ls * tile : tip_l,
                                  rf == 1 ? arena + (size_t)rs * tile : tip_r,
                                  prod, out, lh + e, ll + e, rh + e, rl + e,
                                  eh, el, S, C, kSites, s_big);
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
               site] = root[j];
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

template <int MODE, int V, typename CodeT>
int launch(const void* codes, const int* prog, int n_ops, const int* segs,
           int n_seg, const float* const* pl, const float* ttab, int ncols,
           const float* rr, float* bbuf, float* lik, int* sc, int n_slots,
           int n, int n_pad, int S, int C, cudaStream_t st) {
  auto kern = plf_tree_seg_mxu_kernel<MODE, V, CodeT>;
  const size_t smem = smem_bytes(S * C, ncols, n_slots);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_pad + kSites - 1) / kSites);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const CodeT*>(codes), prog, n_ops, segs, n_seg, pl[0],
      pl[1], pl[2], pl[3], pl[4], pl[5], ttab, ncols, rr, bbuf, lik, sc,
      n_slots, n, n_pad, S, C);
  return (int)cudaGetLastError();
}

}  // namespace

// codes: (n_leaves, n_pad) int32 (code_bytes 4) or int8 (1); prog: (6, n_ops)
// int32 rows lsrc, lflag, rsrc, rflag, oslot, edge; segs: (n_seg, 2) int32;
// lh/ll, rh/rl: (E, S*C, S) fp32 hi and lo planes of the per-edge lane
// constants; eh/el: (S*C, S); ttab: (S*C, ncols), already rounded for the
// variant; rr: (S*C,); bbuf: (n_boundaries, S*C, n_pad) fp32; lik: (n_pad,)
// fp32; sc: (n_pad,) int32.  mode: 0 fp32, 1 bf16x3, 2 bf16.  Returns
// cudaGetLastError().
extern "C" int plf_tree_seg_mxu_launch(
    const void* codes, int code_bytes, const int* prog, int n_ops,
    const int* segs, int n_seg, const float* lh, const float* ll,
    const float* rh, const float* rl, const float* eh, const float* el,
    const float* ttab, int ncols, const float* rr, float* bbuf, float* lik,
    int* sc, int n_slots, int n, int n_pad, int states, int categories,
    int mode, void* stream) {
  if (n_pad <= 0 || n_ops <= 0 || n_seg <= 0 || n_slots <= 0 || states < 1 ||
      categories < 1)
    return (int)cudaErrorInvalidValue;
  const float* pl[6] = {lh, ll, rh, rl, eh, el};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4) {
    PLF_MXU_DISPATCH(mode, states,
                     return launch<M_, V_, int32_t>(
                         codes, prog, n_ops, segs, n_seg, pl, ttab, ncols, rr,
                         bbuf, lik, sc, n_slots, n, n_pad, states, categories,
                         st));
  } else if (code_bytes == 1) {
    PLF_MXU_DISPATCH(mode, states,
                     return launch<M_, V_, int8_t>(
                         codes, prog, n_ops, segs, n_seg, pl, ttab, ncols, rr,
                         bbuf, lik, sc, n_slots, n, n_pad, states, categories,
                         st));
  }
  return (int)cudaErrorInvalidValue;
}
