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
// The program is carry_segment_program's (plf_tpu_torch/ops/plf_tree_seg.py),
// kernel 2's carried register machine over the plan's op order with a
// boundary operand kind: for op i, (lsrc, lflag), (rsrc, rflag) are a tip id
// (flag 0, its table column expanded on demand from the int32 or int8
// codes), an arena slot (flag 1), a boundary id (flag 2, the CLV read from
// bbuf [boundary][row][site]) or the output of op i-1 in the same segment
// (flag 3, kept in registers); oslot is the arena slot of an output that a
// later op but the next one reads (-1 otherwise, and for every segment's
// root) and edge the original edge of the operators.  segs[s] = (end of
// segment s's ops, exported boundary id or -1): at the end of a segment its
// root goes from registers to bbuf, and the last segment's root to the site
// likelihood, the sequential root reduction of kernel 2.  Every op is
// plf::plf_site, so with fp32 boundaries lik and sc equal kernel 2's bit for
// bit.  The uncarried program of segment_program (no flag 3, every output
// stored) runs to the same result.
//
// Bound: kernel 2's operations plus the boundary buffer's bytes.  Per site
// the kernel reads the tip codes once (n_leaves x 1 or 4 bytes), writes 8
// bytes of output and each boundary CLV once (64 bytes at S = C = 4, fp32)
// and reads it back once; ~23 fp32 operations per CLV element per op (1,472
// per site and op).  In practice it is latency-bound at the occupancy its
// registers allow, as kernel 2 is (83 registers at C = 4 with fp32
// boundaries, 94 with bf16: 5 blocks of 128 threads per SM,
// plf_tree_seg_plan).
//
// Design, kernel 2's (csrc/plf_tree.cu) with the boundary rows added:
//  * the output of the op evaluated last stays in registers (out[R]): a
//    carried operand comes from it, a segment's root is exported to bbuf or
//    reduced from it, and only outputs read later than the next op go to the
//    shared-memory arena ([slot][row][site]; 2 slots at 160 taxa where the
//    uncarried program has 3);
//  * op i+1's lc and rc rows are copied by cp.async into a shared double
//    buffer during op i (plf::stage_ops), one barrier an op; the block's
//    threads walk the program in lockstep, so a thread past n_pad stays
//    for the barriers: it reads site n_pad - 1 (zeros for boundary rows)
//    and stores nothing;
//  * op i+1's schedule entries and tip codes are read while op i computes,
//    and one of its boundary rows (its left operand's, else its right's)
//    lands by 4-byte cp.async in the thread's own column of a shared slot,
//    double-buffered by op parity, so the barrier of each op orders a
//    landing after the last read of its slot.  A bf16 row lands as the
//    aligned 32-bit words that hold it, the half picked by the element's
//    parity.  A second boundary operand of the same op (5 ops of 159 at 160
//    taxa) is read at the op.  Rows read ahead into registers instead took
//    128 registers, 4 blocks per SM, and ran 10% slower on an H100 (PERF.md).
//    bbuf is written by this kernel, so its rows are read by plain loads or
//    cp.async, never through the read-only path; a thread reads back only
//    its own site's rows, so no barrier orders an export before its read.
// Ordering rule (the TPU kernel's "ordering safety", plf_tree_seg.py:
// 412-416, per thread here): a boundary row is never read before its
// export.  Landed an op ahead, op i+1's boundary operand could be the row
// op i itself exports (op i ends a segment and op i+1 reads its root: 3
// times in the 160-taxon plan).  So when op i ends a segment, an operand of
// op i+1 that names that segment's boundary (gout) does not land: it is
// read at op i+1, after the export.  Every other boundary was exported by
// an earlier op, before its landing is issued.
//
// Candidate axis (blockIdx.y; plf_tree_seg_batch in ops/plf_tree_seg.py,
// kernel 2's candidate axis on kernel 7): a launch scores a batch of trees
// over one alignment, candidate b with its own carried program prog[b] (6 x
// n_ops, the same op count for every candidate), its own segment rows
// segs[b] (n_seg rows, the batch's most; a candidate with fewer segments is
// padded past its last with rows that are never reached), its own boundary
// buffer bbuf[b] (n_bnd boundaries, the batch's most) and its own lik and sc
// rows; all share the codes, the tip table and one operator table that
// every program's edge row indexes (the batch's distinct (left, right)
// operator pairs).  Per-site arithmetic is the single-tree kernel's, so each
// row equals a single-tree launch bit for bit; a batch of one runs the
// single-tree kernel (kBatch false: its pointers stay kernel parameters).  The host launches a batch in chunks of candidates whose boundary
// buffers fit a stated cap, one launch a chunk over one reused buffer.
// Replaces plf_tpu/ops/plf_tree_seg.py::batched_seg_loglik_parts (:1376, a
// lax.map of _seg_fwd_call over the candidates of stack_plans :1289).
//
// bf16 boundaries (BT = __nv_bfloat16, PLFConfig(dtype="bfloat16")): a
// segment's root is narrowed as it is exported to bbuf and widened when a
// later segment reads it, as the TPU kernel stores root.astype(bf16) (:568)
// and widens the rows it lands (:452-484).  The consumer reads the rounded
// row back from bbuf, never the fp32 value the exporting thread computed
// (nothing is carried across a segment's end); the last segment's root, lik
// and sc stay fp32.  The boundary bytes halve.
#include "plf_common.cuh"

namespace {

constexpr int kSlot = 1;      // operand flag: an arena slot
constexpr int kBoundary = 2;  // a boundary CLV in bbuf
constexpr int kCarried = 3;   // the previous op's output (SEG_CARRIED)

constexpr int kLanding = 2;   // landing slots: one row, two op parities

// Dynamic shared memory of one block (tree_fused_smem_bytes in plf_tree.py
// of n_slots + kLanding slots): the EV constants, two buffers of an op's
// operators, the tip table, the root row vector, the landing slots and the
// arena.
template <int C>
size_t smem_bytes(int ncols, int n_slots, int threads) {
  constexpr int R = plf::S * C;
  return sizeof(float) * ((size_t)R * plf::S + (size_t)R * ncols + R +
                          (size_t)(kLanding + n_slots) * R * threads) +
         sizeof(float4) * 4 * R;
}

// 4 bytes from device memory into shared memory, asynchronously; zeros
// when !fill (nothing is read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 4 : 0));
}

// One op's entries: sources, flags, output slot, edge, tip codes, and
// whether a boundary operand is read at the op rather than ahead of it.
struct Entries {
  int ls, lf, rs, rf, o, e, lcode, rcode;
  bool llate, rlate;
};

template <int C, typename CodeT, typename BT, bool kBatch>
__global__ void plf_tree_seg_kernel(const CodeT* codes, const int* prog,
                                    int n_ops, const int* segs, int n_seg,
                                    const float* lcs, const float* rcs,
                                    const float* ec, const float* ttab,
                                    int ncols, const float* rr, BT* bbuf,
                                    int n_bnd, float* lik, int* sc, int n,
                                    int n_pad) {
  constexpr int R = plf::S * C;
  if constexpr (kBatch) {  // this block's candidate
    const size_t cand = blockIdx.y;
    prog += cand * 6 * n_ops;
    segs += cand * 2 * n_seg;
    bbuf += cand * n_bnd * R * n_pad;
    lik += cand * n_pad;
    sc += cand * n_pad;
  }
  extern __shared__ float4 smem4[];
  float4* s_ec = smem4;                                    // R float4
  float4* s_ops = smem4 + R;                               // 2 x (lc, rc)
  float* s_tt = reinterpret_cast<float*>(s_ops + 4 * R);   // R * ncols
  float* s_rr = s_tt + R * ncols;                          // R
  const int T = blockDim.x;
  float* land = s_rr + R;                                  // 2 x R * T
  float* arena = land + kLanding * R * T;                  // n_slots * R * T
  const int tid = threadIdx.x;
  for (int i = tid; i < R; i += T) {
    s_ec[i] = reinterpret_cast<const float4*>(ec)[i];
    s_rr[i] = rr[i];
  }
  for (int i = tid; i < R * ncols; i += T) s_tt[i] = ttab[i];
  const int* lsrc = prog;
  const int* lflag = prog + n_ops;
  const int* rsrc = prog + 2 * n_ops;
  const int* rflag = prog + 3 * n_ops;
  const int* oslot = prog + 4 * n_ops;
  const int* eidx = prog + 5 * n_ops;

  const int site = blockIdx.x * T + tid;
  const bool live = site < n_pad;
  const bool valid = site < n;
  const int at = min(site, n_pad - 1);
  const size_t bnd_stride = (size_t)R * n_pad;

  // boundary src's row at this site (zeros past n_pad)
  auto read_boundary = [&](int src, float (&x)[R]) {
    const BT* b = bbuf + (size_t)src * bnd_stride + at;
#pragma unroll
    for (int r = 0; r < R; ++r)
      x[r] = live ? plf::widen(b[(size_t)r * n_pad]) : 0.0f;
  };

  float out[R];  // the output of the op evaluated last
  Entries nx;    // the next op's entries
  // read op j's entries and codes; xg is the boundary that op j - 1
  // exports (-1 if none), which does not land: it is read at op j
  auto fetch = [&](int j, int xg) {
    nx.ls = __ldg(lsrc + j);
    nx.lf = __ldg(lflag + j);
    nx.rs = __ldg(rsrc + j);
    nx.rf = __ldg(rflag + j);
    nx.o = __ldg(oslot + j);
    nx.e = __ldg(eidx + j);
    nx.lcode = nx.lf == 0 ? (int)codes[(size_t)nx.ls * n_pad + at] : 0;
    nx.rcode = nx.rf == 0 ? (int)codes[(size_t)nx.rs * n_pad + at] : 0;
    nx.llate = nx.lf == kBoundary && nx.ls == xg;
    nx.rlate = nx.rf == kBoundary && nx.rs == xg;
    // one row lands: the left, else the right
    if (nx.lf == kBoundary && !nx.llate) nx.rlate = nx.rf == kBoundary;
  };
  // copy the landing row of entries x into landing slot p
  auto land_row = [&](const Entries& x, int p) {
    int src = -1;
    if (x.lf == kBoundary && !x.llate) src = x.ls;
    else if (x.rf == kBoundary && !x.rlate) src = x.rs;
    if (src < 0) return;
    const BT* b = bbuf + (size_t)src * bnd_stride + at;
    float* d = land + (size_t)p * R * T + tid;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const BT* q = b + (size_t)r * n_pad;  // bf16: its aligned word
      cp_async4(d + r * T,
                reinterpret_cast<const void*>(
                    reinterpret_cast<uintptr_t>(q) & ~(uintptr_t)3),
                live);
    }
  };
  // the landed row of boundary src, from landing slot p
  auto landed = [&](int src, int p, float (&x)[R]) {
    const float* d = land + (size_t)p * R * T + tid;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (sizeof(BT) == 2) {
        const unsigned w = __float_as_uint(d[r * T]);
        const size_t k = (size_t)src * bnd_stride + (size_t)r * n_pad + at;
        x[r] = __uint_as_float((k & 1 ? w >> 16 : w & 0xffffu) << 16);
      } else {
        x[r] = d[r * T];
      }
    }
  };
  auto load = [&](int src, int flag, int code, bool late, int p,
                  float (&x)[R]) {
    if (flag == kCarried) {
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = out[r];
    } else if (flag == kSlot) {
      const float* s = arena + (size_t)src * R * T + tid;
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = s[r * T];
    } else if (flag == kBoundary) {
      if (late) {
        read_boundary(src, x);
      } else {
        landed(src, p, x);
      }
    } else {  // tip: the table column of this site's code
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
  int end = __ldg(segs), gout = __ldg(segs + 1);  // the current segment
  int next_end = 0, next_gout = -1;               // and the one after it
  if (n_seg > 1) {
    next_end = __ldg(segs + 2);
    next_gout = __ldg(segs + 3);
  }
  fetch(0, -1);
  land_row(nx, 0);
  plf::stage_ops<C>(s_ops, lcs, rcs, nx.e, tid);
  __syncthreads();
  for (int i = 0, s = 0; i < n_ops; ++i) {
    float a[R], b[R];
    const Entries cur = nx;
    const int p = i & 1;
    const bool seg_end = i + 1 == end;
    if (i + 1 < n_ops) fetch(i + 1, seg_end ? gout : -1);
    plf::cp_async_wait_all();
    __syncthreads();  // op i's operators and row landed; op i-1's are free
    load(cur.ls, cur.lf, cur.lcode, cur.llate, p, a);
    load(cur.rs, cur.rf, cur.rcode, cur.rlate, p, b);
    if (i + 1 < n_ops) {
      land_row(nx, p ^ 1);
      plf::stage_ops<C>(s_ops + (p ^ 1) * 2 * R, lcs, rcs, nx.e, tid);
    }
    const float4* lc = s_ops + p * 2 * R;
    count += plf::plf_site<C>(a, b, lc, lc + R, s_ec, valid, out);
    if (cur.o >= 0) {
      float* d = arena + (size_t)cur.o * R * T + tid;
#pragma unroll
      for (int r = 0; r < R; ++r) d[r * T] = out[r];
    }
    if (!seg_end) continue;
    if (gout >= 0) {
      if (live) {
        BT* d = bbuf + (size_t)gout * bnd_stride + site;
#pragma unroll
        for (int r = 0; r < R; ++r)
          d[(size_t)r * n_pad] = plf::narrow<BT>(out[r]);
      }
    } else {
      float l = __fmul_rn(s_rr[0], out[0]);
#pragma unroll
      for (int r = 1; r < R; ++r) l = __fadd_rn(l, __fmul_rn(s_rr[r], out[r]));
      if (live) {
        lik[site] = l;
        sc[site] = count;
      }
    }
    end = next_end;
    gout = next_gout;
    if (++s + 1 < n_seg) {
      next_end = __ldg(segs + 2 * (s + 1));
      next_gout = __ldg(segs + 2 * (s + 1) + 1);
    }
  }
}

template <int C, typename CodeT, typename BT>
int launch(const void* codes, const int* prog, int n_ops, const int* segs,
           int n_seg, const float* lcs, const float* rcs, const float* ec,
           const float* ttab, int ncols, const float* rr, void* bbuf,
           int n_bnd, float* lik, int* sc, int n_slots, int n, int n_pad,
           int threads, int batch, cudaStream_t st) {
  if (threads < 2 * plf::S * C) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<C>(ncols, n_slots, threads);
  auto kern = batch > 1 ? plf_tree_seg_kernel<C, CodeT, BT, true>
                        : plf_tree_seg_kernel<C, CodeT, BT, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_pad + threads - 1) / threads, batch);
  kern<<<grid, threads, smem, st>>>(static_cast<const CodeT*>(codes), prog,
                                    n_ops, segs, n_seg, lcs, rcs, ec, ttab,
                                    ncols, rr, static_cast<BT*>(bbuf), n_bnd,
                                    lik, sc, n, n_pad);
  return (int)cudaGetLastError();
}

template <int C, typename CodeT, typename BT>
int plan(int ncols, int n_slots, int threads, int* smem, int* blocks,
         int* regs) {
  const size_t bytes = smem_bytes<C>(ncols, n_slots, threads);
  auto kern = plf_tree_seg_kernel<C, CodeT, BT, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  *smem = (int)bytes;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                            threads, bytes);
}

}  // namespace

// codes: (n_leaves, n_pad) int32 (code_bytes 4) or int8 (1); prog: (batch,
// 6, n_ops) int32, each candidate's rows lsrc, lflag, rsrc, rflag, oslot,
// edge (carry_segment_program; segment_program's uncarried program runs
// too); segs: (batch, n_seg, 2) int32; lcs, rcs: (P, S*C, S) fp32, the
// operator table the edge rows index; ec: (S*C, S); ttab: (S*C, ncols); rr:
// (S*C,); bbuf: (batch, n_bnd, S*C, n_pad), fp32, or bf16 when bf16 is set;
// lik, sc: (batch, n_pad) fp32 and int32; n_slots: the programs' largest
// arena; threads: sites (one a thread) per block, at least 2*S*C; batch in
// 1..65535.  Returns cudaGetLastError().
extern "C" int plf_tree_seg_launch(const void* codes, int code_bytes,
                                   const int* prog, int n_ops, const int* segs,
                                   int n_seg, const float* lcs,
                                   const float* rcs, const float* ec,
                                   const float* ttab, int ncols,
                                   const float* rr, void* bbuf, int n_bnd,
                                   float* lik, int* sc, int n_slots, int n,
                                   int n_pad, int categories, int threads,
                                   int bf16, int batch, void* stream) {
  if (n_pad <= 0 || n_ops <= 0 || n_seg <= 0 || threads <= 0 || n_slots < 0 ||
      n_bnd < 0 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4) {
    PLF_DISPATCH_T(bf16, PLF_DISPATCH_C(categories,
        return launch<C_, int32_t, T_>(codes, prog, n_ops, segs, n_seg, lcs,
                                       rcs, ec, ttab, ncols, rr, bbuf, n_bnd,
                                       lik, sc, n_slots, n, n_pad, threads,
                                       batch, st)));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_T(bf16, PLF_DISPATCH_C(categories,
        return launch<C_, int8_t, T_>(codes, prog, n_ops, segs, n_seg, lcs,
                                      rcs, ec, ttab, ncols, rr, bbuf, n_bnd,
                                      lik, sc, n_slots, n, n_pad, threads,
                                      batch, st)));
  }
  return (int)cudaErrorInvalidValue;
}

// The launch plf_tree_seg_launch makes with these arguments: dynamic shared
// memory bytes, resident blocks per SM (registers and shared memory both
// counted by the runtime) and registers per thread.
extern "C" int plf_tree_seg_plan(int code_bytes, int categories, int ncols,
                                 int n_slots, int threads, int bf16,
                                 int* smem, int* blocks, int* regs) {
  if (threads <= 0 || n_slots < 0) return (int)cudaErrorInvalidValue;
  if (code_bytes == 4) {
    PLF_DISPATCH_T(bf16, PLF_DISPATCH_C(categories,
        return plan<C_, int32_t, T_>(ncols, n_slots, threads, smem, blocks,
                                     regs)));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_T(bf16, PLF_DISPATCH_C(categories,
        return plan<C_, int8_t, T_>(ncols, n_slots, threads, smem, blocks,
                                    regs)));
  }
  return (int)cudaErrorInvalidValue;
}
