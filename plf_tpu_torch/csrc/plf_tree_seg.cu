// Kernel 7: the segmented whole-tree forward likelihood.
//
// Replaces plf_tpu/ops/plf_tree_seg.py::_seg_fwd_kernel (:383, launched by
// _seg_fwd_call :591), its "vpu" form at S = 4.  The TPU kernel runs a
// sequential grid of (segments x site blocks): a VMEM arena per segment,
// boundary CLVs streamed in and the segment's root streamed out by DMA, and a
// scaler-count row carried from one segment to the next in device memory.
// Here site tiles are independent, so one thread per site walks every segment
// of the plan in order and nothing is ordered between blocks; the rescale
// count stays in a register.
//
// The program (segment_program in plf_tpu_torch/ops/plf_tree_seg.py) is
// kernel 2's register machine over the plan's op order with a third operand
// kind: for op i, (lsrc, lflag), (rsrc, rflag) are a tip id (flag 0, its
// table column expanded on demand from the int32 or int8 codes), an arena
// slot (flag 1) or a boundary id (flag 2, the CLV read from bbuf
// [boundary][row][site]); oslot is the register-allocated output slot (slots
// are reused within a segment) and edge the original edge of the operators.
// segs[s] = (end of segment s's ops, exported boundary id or -1): at the end of
// a segment its root goes to bbuf, and the last segment's root to the site
// likelihood, the sequential root reduction of kernel 2.  Every op is
// plf::plf_site, so with fp32 boundaries lik and sc equal kernel 2's bit for
// bit.
//
// Bound: kernel 2's, plus the boundary buffer.  Per site the kernel reads the
// tip codes once (n_leaves x 1 or 4 bytes), writes 8 bytes of output and each
// boundary CLV once (64 bytes at S = C = 4) and reads it back once; ~23 fp32
// operations per CLV element per op (1,472 per site and op), so at 160 taxa
// the operations (159 ops, 0.23 MFLOP per site) bound it, as they bound kernel
// 2, and the boundaries add ~1% to its bytes.  In practice it is latency-bound
// at the occupancy its arena allows, as kernel 2 is: the design keeps kernel
// 2's block of 128 threads and an arena of only the slots live in one segment.
//
// bf16 boundaries (BT = __nv_bfloat16, PLFConfig(dtype="bfloat16")): a
// segment's root is narrowed as it is exported to bbuf and widened when a
// later segment reads it, as the TPU kernel stores root.astype(bf16) (:568)
// and widens the rows it lands (:452-484).  The consumer reads the rounded
// row back from bbuf, never the fp32 value the exporting thread computed;
// the last segment's root, lik and sc stay fp32.  The boundary bytes halve.
#include "plf_common.cuh"

namespace {

template <int C, typename CodeT, typename BT>
__global__ void plf_tree_seg_kernel(const CodeT* codes, const int* prog,
                                    int n_ops, const int* segs, int n_seg,
                                    const float* lcs, const float* rcs,
                                    const float* ec, const float* ttab,
                                    int ncols, const float* rr, BT* bbuf,
                                    float* lik, int* sc, int n, int n_pad) {
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
  const int* lsrc = prog;
  const int* lflag = prog + n_ops;
  const int* rsrc = prog + 2 * n_ops;
  const int* rflag = prog + 3 * n_ops;
  const int* oslot = prog + 4 * n_ops;
  const int* eidx = prog + 5 * n_ops;
  const size_t bnd_stride = (size_t)R * n_pad;

  // bbuf rows are written and read back by this thread alone: plain loads,
  // never the read-only cache.
  auto load = [&](int src, int flag, float (&x)[R]) {
    if (flag == 1) {         // arena slot
      const float* s = arena + (size_t)src * R * T + tid;
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = s[r * T];
    } else if (flag == 2) {  // boundary CLV
      const BT* b = bbuf + (size_t)src * bnd_stride + site;
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = plf::widen(b[(size_t)r * n_pad]);
    } else {                 // tip: the table column of this site's code
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
  int i = 0;
  float a[R], b[R], out[R];
  for (int s = 0; s < n_seg; ++s) {
    const int end = __ldg(segs + 2 * s);
    const int gout = __ldg(segs + 2 * s + 1);
    for (; i < end; ++i) {
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
    const float* x = arena + (size_t)__ldg(oslot + end - 1) * R * T + tid;
    if (gout >= 0) {
      BT* d = bbuf + (size_t)gout * bnd_stride + site;
#pragma unroll
      for (int r = 0; r < R; ++r)
        d[(size_t)r * n_pad] = plf::narrow<BT>(x[r * T]);
    } else {
      float l = __fmul_rn(s_rr[0], x[0]);
#pragma unroll
      for (int r = 1; r < R; ++r) l = __fadd_rn(l, __fmul_rn(s_rr[r], x[r * T]));
      lik[site] = l;
      sc[site] = count;
    }
  }
}

// Dynamic shared memory of one block (tree_smem_bytes in plf_tree.py).
template <int C>
size_t smem_bytes(int ncols, int n_slots, int threads) {
  constexpr int R = plf::S * C;
  return sizeof(float) * ((size_t)R * plf::S + (size_t)R * ncols + R +
                          (size_t)n_slots * R * threads);
}

template <int C, typename CodeT, typename BT>
int launch(const void* codes, const int* prog, int n_ops, const int* segs,
           int n_seg, const float* lcs, const float* rcs, const float* ec,
           const float* ttab, int ncols, const float* rr, void* bbuf,
           float* lik, int* sc, int n_slots, int n, int n_pad, int threads,
           cudaStream_t st) {
  const size_t smem = smem_bytes<C>(ncols, n_slots, threads);
  auto kern = plf_tree_seg_kernel<C, CodeT, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_pad + threads - 1) / threads);
  kern<<<grid, threads, smem, st>>>(static_cast<const CodeT*>(codes), prog,
                                    n_ops, segs, n_seg, lcs, rcs, ec, ttab,
                                    ncols, rr, static_cast<BT*>(bbuf), lik,
                                    sc, n, n_pad);
  return (int)cudaGetLastError();
}

}  // namespace

// codes: (n_leaves, n_pad) int32 (code_bytes 4) or int8 (1); prog: (6, n_ops)
// int32 rows lsrc, lflag, rsrc, rflag, oslot, edge; segs: (n_seg, 2) int32;
// lcs, rcs: (E, S*C, S) fp32; ec: (S*C, S); ttab: (S*C, ncols); rr: (S*C,);
// bbuf: (n_boundaries, S*C, n_pad), fp32, or bf16 when bf16 is set; lik:
// (n_pad,) fp32; sc: (n_pad,) int32.  Returns cudaGetLastError().
extern "C" int plf_tree_seg_launch(const void* codes, int code_bytes,
                                   const int* prog, int n_ops, const int* segs,
                                   int n_seg, const float* lcs,
                                   const float* rcs, const float* ec,
                                   const float* ttab, int ncols,
                                   const float* rr, void* bbuf, float* lik,
                                   int* sc, int n_slots, int n, int n_pad,
                                   int categories, int threads, int bf16,
                                   void* stream) {
  if (n_pad <= 0 || n_ops <= 0 || n_seg <= 0 || threads <= 0 || n_slots <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4) {
    PLF_DISPATCH_T(bf16, PLF_DISPATCH_C(categories,
        return launch<C_, int32_t, T_>(codes, prog, n_ops, segs, n_seg, lcs,
                                       rcs, ec, ttab, ncols, rr, bbuf, lik,
                                       sc, n_slots, n, n_pad, threads, st)));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_T(bf16, PLF_DISPATCH_C(categories,
        return launch<C_, int8_t, T_>(codes, prog, n_ops, segs, n_seg, lcs,
                                      rcs, ec, ttab, ncols, rr, bbuf, lik,
                                      sc, n_slots, n, n_pad, threads, st)));
  }
  return (int)cudaErrorInvalidValue;
}
