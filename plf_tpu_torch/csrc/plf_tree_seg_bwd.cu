// Kernel 8: the segmented whole-tree backward (VJP of kernel 7).
//
// Replaces plf_tpu/ops/plf_tree_seg.py::_seg_bwd_kernel (:843, launched by
// _seg_bwd_call :1095), its "vpu" form at S = 4.  The TPU kernel runs a
// sequential grid of (segments in reverse x site blocks) and chains the
// boundary adjoints through a buffer in device memory; here a one-warp block
// owns its tiles of kSites sites through every segment, so nothing is ordered
// between blocks.  For each segment of the plan in reverse, for each of the
// block's tiles:
//
//   phase 1  recompute the segment's ops (operands: tips from their codes,
//            boundary CLVs from bbuf, earlier ops of the segment from the
//            arena) into a shared-memory arena [slot][row][site] of one slot
//            per op, and each op's rescale flag (one byte);
//   seed     the root's adjoint: for the last segment g = glik on valid sites
//            (0 on padding), grr[r] += sum_s x_root[r] * g, adjoint rr[r] * g;
//            for the others the boundary adjoint its consumer wrote to gbuf
//            in an earlier segment of this loop (by this same thread);
//   phase 2  kernel 4's reverse sweep: g_y = f * adjoint, g_p = S3(g_y; ecT),
//            g_u1 = g_p*u2, g_u2 = g_p*u1; a child op's slot flips to its
//            adjoint S1(g_u1; lcT[e]), a boundary child's adjoint goes to
//            gbuf[boundary][row][site], a tip child's is never formed.
//
// gl[e], gr[e] (per edge), gec and grr are sums over all sites without float
// atomics (plf_grad.cuh): per tile and op the warp sums its 32 sites and adds
// them to the segment's sums in shared memory (`segacc`, one slot per op,
// written by the block's first tile); when the segment's tiles are done its
// sums go to the block's row of `partial`, each entry written once; gec and
// grr stay in each lane's registers to the end; a fixed-order second pass
// over the rows in fp64 (plf_tree_seg_bwd_reduce).  Two runs are
// bit-identical.  Every per-site value is computed in the order of the plain
// version (plf_tree_seg_bwd_torch), so the boundary adjoints in gbuf equal its
// bit for bit.
//
// Bound: operations.  Per site and op, the forward recompute (~23 fp32
// operations per CLV element), g_p, g_u1/g_u2, an adjoint stage per internal
// child and three operator-gradient products: ~1,040 fp32 operations per
// site and op at S = C = 4 that the function needs, ~1,800 instructions as
// the kernel issues them (the second stage-1 pass, the operator loads, the
// sums' staging and butterflies), against ~64 bytes per site for each
// boundary read and adjoint written.  The checkpoint of every op CLV lives
// in shared memory, not in device memory (kernel 4 moves ~31 KB per site at
// 159 nodes there); the device-memory residual is the boundary buffer,
// n_boundaries x 64 bytes per site.  The cost is occupancy: a block of 32
// threads holds seg_ops slots of 2.5 KB (CLV, flags, gl/gr sums), and the
// planner caps seg_ops so that eight blocks share an SM (plan_segments in
// plf_tree_seg.py).  Staging one pair of (S*C, 32) arrays at a time (4 KB
// at C = 4) leaves room for 8 ops a segment, and walking the segments
// outermost keeps a segment's gl/gr sums in shared memory until its tiles
// are done, so no tile reads back a partial sum from device memory.  On an
// H100 (80 GB HBM3, 700 W) at 160 taxa x 2^20 sites: 178 registers, 8
// blocks per SM (shared memory; registers would allow 11), 23.2 ms on the
// cap-8 plan (36 segments of at most 6 ops, 35 boundaries); plans cut for
// 4, 6, 8 and 10 blocks per SM ran it in 36.0, 29.4, 23.2 and 22.8 ms;
// without the operator-gradient sums it ran 18.2 ms (104 registers).
// Issue and latency bind, at 1/9 of the operations bound (2.7 ms).
//
// bf16 storage (BT = __nv_bfloat16, PLFConfig(dtype="bfloat16")): bbuf holds
// kernel 7's rounded boundaries, widened where phase 1 reads them, so the
// recompute sees the rows the forward's consumers saw; a boundary adjoint is
// narrowed as it is written to gbuf and widened as its producer's root seed,
// as the TPU kernel's gexp/gbout scratch does (:1022-1024, :1070-1075).
#include "plf_grad.cuh"

namespace {

constexpr int kSites = 32;  // threads per block = sites per tile (SEG_SITES)

template <int C, typename CodeT, typename BT>
__global__ void __launch_bounds__(kSites)
plf_tree_seg_bwd_kernel(const CodeT* __restrict__ codes,
                        const int* __restrict__ prog, int n_ops,
                        const int* __restrict__ segs, int n_seg,
                        const float* lcs, const float* rcs, const float* lcsT,
                        const float* rcsT, const float* ec, const float* ecT,
                        const float* ttab, int ncols, const float* rr,
                        const float* __restrict__ glik,
                        const BT* __restrict__ bbuf, BT* gbuf,
                        float* __restrict__ partial, int seg_ops,
                        int tiles_per_block, int n, int n_pad) {
  constexpr int R = plf::S * C;
  constexpr int RS = R * plf::S;
  constexpr int NQ = plf::grad_passes<C>();
  constexpr int NA = 2 * NQ * kSites;                    // float2 per op
  extern __shared__ float4 smem4[];
  float4* s_ec = smem4;                                  // R float4
  float4* s_ecT = smem4 + R;                             // R float4
  float* st = reinterpret_cast<float*>(smem4 + 2 * R);   // staging
  float2* segacc = reinterpret_cast<float2*>(
      st + plf::warp_stage_floats<C>());                 // seg_ops * NA
  float* arena = reinterpret_cast<float*>(segacc + (size_t)seg_ops * NA);
  float* s_tt = arena + (size_t)seg_ops * R * kSites;    // R * ncols
  float* s_rr = s_tt + R * ncols;                        // R
  unsigned char* flags = reinterpret_cast<unsigned char*>(s_rr + R);
  const int tid = threadIdx.x;
  for (int i = tid; i < R; i += kSites) {
    s_ec[i] = reinterpret_cast<const float4*>(ec)[i];
    s_ecT[i] = reinterpret_cast<const float4*>(ecT)[i];
    s_rr[i] = rr[i];
  }
  for (int i = tid; i < R * ncols; i += kSites) s_tt[i] = ttab[i];
  __syncthreads();

  const int* lsrc = prog;
  const int* lflag = prog + n_ops;
  const int* rsrc = prog + 2 * n_ops;
  const int* rflag = prog + 3 * n_ops;
  const int* oslot = prog + 4 * n_ops;
  const int* eidx = prog + 5 * n_ops;
  const int E = n_ops;
  const size_t bnd_stride = (size_t)R * n_pad;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(tile0 + tiles_per_block, n_pad / kSites);
  const size_t cols = (size_t)2 * E * RS + RS + R;
  float* part = partial + blockIdx.x * cols;

  auto load = [&](int src, int flag, int site, float (&x)[R]) {
    if (flag == 1) {         // arena slot
      const float* s = arena + (size_t)src * R * kSites + tid;
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = s[r * kSites];
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
  auto store = [&](int slot, const float (&x)[R]) {
    float* d = arena + (size_t)slot * R * kSites + tid;
#pragma unroll
    for (int r = 0; r < R; ++r) d[r * kSites] = x[r];
  };
  // gbuf rows are written and read back by this thread alone: plain loads.
  auto put_adjoint = [&](int src, int flag, int site, const float (&g)[R],
                         const float4* opT) {
    float o[R];
    if (flag == 1) {
      plf::stage<C>(g, opT, o);
      store(src, o);
    } else if (flag == 2) {
      plf::stage<C>(g, opT, o);
      BT* d = gbuf + (size_t)src * bnd_stride + site;
#pragma unroll
      for (int r = 0; r < R; ++r) d[(size_t)r * n_pad] = plf::narrow<BT>(o[r]);
    }
  };

  float2 gsum[NQ];   // gec: this lane's entries, op by op over all tiles
#pragma unroll
  for (int q = 0; q < NQ; ++q) gsum[q] = make_float2(0.0f, 0.0f);
  float acc_rr = 0.0f;

  for (int s = n_seg - 1; s >= 0; --s) {
    const int end = __ldg(segs + 2 * s);
    const int gout = __ldg(segs + 2 * s + 1);
    const int start = s ? __ldg(segs + 2 * s - 2) : 0;
    if (end - start > seg_ops) __trap();   // the arena was sized for less

    for (int t = tile0; t < tile1; ++t) {
      const int site = t * kSites + tid;
      const bool valid = site < n;

      // ---- phase 1: the segment's op CLVs and flags, recomputed ----
      float a[R], b[R], out[R];
      for (int i = start; i < end; ++i) {
        load(__ldg(lsrc + i), __ldg(lflag + i), site, a);
        load(__ldg(rsrc + i), __ldg(rflag + i), site, b);
        const int e = __ldg(eidx + i);
        const float4* lc = reinterpret_cast<const float4*>(lcs) + (size_t)e * R;
        const float4* rc = reinterpret_cast<const float4*>(rcs) + (size_t)e * R;
        const int f = plf::plf_site<C>(a, b, lc, rc, s_ec, valid, out);
        const int slot = __ldg(oslot + i);
        store(slot, out);
        flags[slot * kSites + tid] = (unsigned char)f;
      }

      // ---- seed: the root's adjoint (out holds the root's CLV) ----
      const int root = __ldg(oslot + end - 1);
      {
        float adj[R];
        if (gout < 0) {
          const float g = valid ? glik[site] : 0.0f;
          plf::warp_root_grad<C>(st, out, g, tid, acc_rr);
#pragma unroll
          for (int r = 0; r < R; ++r) adj[r] = __fmul_rn(s_rr[r], g);
        } else {
          const BT* src = gbuf + (size_t)gout * bnd_stride + site;
#pragma unroll
          for (int r = 0; r < R; ++r)
            adj[r] = plf::widen(src[(size_t)r * n_pad]);
        }
        store(root, adj);
      }

      // ---- phase 2: reverse sweep, op slots flip from CLV to adjoint ----
      for (int i = end - 1; i >= start; --i) {
        const int lp = __ldg(lsrc + i), lf = __ldg(lflag + i);
        const int rp = __ldg(rsrc + i), rf = __ldg(rflag + i);
        const int e = __ldg(eidx + i), slot = __ldg(oslot + i);
        const float4* lc = reinterpret_cast<const float4*>(lcs) + (size_t)e * R;
        const float4* rc = reinterpret_cast<const float4*>(rcs) + (size_t)e * R;
        const float4* lcT = reinterpret_cast<const float4*>(lcsT) + (size_t)e * R;
        const float4* rcT = reinterpret_cast<const float4*>(rcsT) + (size_t)e * R;
        const float fac = flags[slot * kSites + tid] ? plf::TWO_TO_THE_32 : 1.0f;
        float gy[R];
        load(slot, 1, site, gy);
#pragma unroll
        for (int r = 0; r < R; ++r) gy[r] = __fmul_rn(gy[r], fac);
        load(lp, lf, site, a);
        load(rp, rf, site, b);
        float u1[R], u2[R], gp[R], gu1[R], gu2[R];
        plf::stage<C>(a, lc, u1);
        plf::stage<C>(b, rc, u2);
        plf::stage<C>(gy, s_ecT, gp);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          gu1[r] = __fmul_rn(gp[r], u2[r]);
          gu2[r] = __fmul_rn(gp[r], u1[r]);
          u1[r] = __fmul_rn(u1[r], u2[r]);  // p
        }
        put_adjoint(lp, lf, site, gu1, lcT);
        put_adjoint(rp, rf, site, gu2, rcT);
        float2 s0[NQ], s1[NQ], s2[NQ];
        plf::warp_op_grad<C>(st, a, gu1, tid, s0);
        plf::warp_op_grad<C>(st, b, gu2, tid, s1);
        plf::warp_op_grad<C>(st, u1, gy, tid, s2);
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          gsum[q] = make_float2(__fadd_rn(gsum[q].x, s2[q].x),
                                __fadd_rn(gsum[q].y, s2[q].y));
        // gl[e], gr[e]: into the segment's sums (slot i - start).
        float2* sa = segacc + (size_t)(i - start) * NA + tid;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          float2 v0 = s0[q], v1 = s1[q];
          if (t > tile0) {
            const float2 o0 = sa[q * kSites], o1 = sa[(NQ + q) * kSites];
            v0 = make_float2(__fadd_rn(o0.x, v0.x), __fadd_rn(o0.y, v0.y));
            v1 = make_float2(__fadd_rn(o1.x, v1.x), __fadd_rn(o1.y, v1.y));
          }
          sa[q * kSites] = v0;
          sa[(NQ + q) * kSites] = v1;
        }
      }
    }

    // The segment's gl/gr sums, once, into this block's row.
    for (int i = start; i < end; ++i) {
      const int e = __ldg(eidx + i);
      const float2* sa = segacc + (size_t)(i - start) * NA + tid;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float* row = part + (size_t)m * E * RS + (size_t)e * RS;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float2 v = sa[(m * NQ + q) * kSites];
          const int e0 = plf::grad_entry<C>(tid, q, 0);
          const int e1 = plf::grad_entry<C>(tid, q, 1);
          if (e0 >= 0) row[e0] = v.x;
          if (e1 >= 0) row[e1] = v.y;
        }
      }
    }
  }
  float* tail = part + (size_t)2 * E * RS;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float2 v = gsum[q];
    const int e0 = plf::grad_entry<C>(tid, q, 0);
    const int e1 = plf::grad_entry<C>(tid, q, 1);
    if (e0 >= 0) tail[e0] = v.x;
    if (e1 >= 0) tail[e1] = v.y;
  }
  if (tid < R) tail[RS + tid] = acc_rr;
}

// Dynamic shared memory of one block (seg_bwd_smem_bytes in plf_tree_seg.py):
// ec, ecT, the staging area, the tip table, rr, and per op a CLV slot, its
// gl/gr sums and kSites flag bytes.
template <int C>
size_t smem_bytes(int ncols, int seg_ops) {
  constexpr int R = plf::S * C;
  return sizeof(float) * ((size_t)2 * R * plf::S + plf::warp_stage_floats<C>() +
                          (size_t)R * ncols + R) +
         (size_t)seg_ops * (sizeof(float) * (R * kSites +
                                             4 * plf::grad_passes<C>() * kSites) +
                            kSites);
}


template <int C, typename CodeT, typename BT>
int launch(const void* codes, const int* prog, int n_ops, const int* segs,
           int n_seg, const float* lcs, const float* rcs, const float* lcsT,
           const float* rcsT, const float* ec, const float* ecT,
           const float* ttab, int ncols, const float* rr, const float* glik,
           const void* bbuf, void* gbuf, float* partial, int seg_ops,
           int n_blocks, int tiles_per_block, int n, int n_pad,
           cudaStream_t st) {
  const size_t smem = smem_bytes<C>(ncols, seg_ops);
  auto kern = plf_tree_seg_bwd_kernel<C, CodeT, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<n_blocks, kSites, smem, st>>>(
      static_cast<const CodeT*>(codes), prog, n_ops, segs, n_seg, lcs, rcs,
      lcsT, rcsT, ec, ecT, ttab, ncols, rr, glik,
      static_cast<const BT*>(bbuf), static_cast<BT*>(gbuf), partial, seg_ops,
      tiles_per_block, n, n_pad);
  return (int)cudaGetLastError();
}

template <int C, typename CodeT, typename BT>
int occupancy(int ncols, int seg_ops, int* blocks) {
  const size_t smem = smem_bytes<C>(ncols, seg_ops);
  auto kern = plf_tree_seg_bwd_kernel<C, CodeT, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                            kSites, smem);
}

}  // namespace

// codes: (n_leaves, n_pad) int32 (code_bytes 4) or int8 (1); prog: (6, n_ops)
// int32 rows lsrc, lflag, rsrc, rflag, oslot (op j of a segment in slot j),
// edge; segs: (n_seg, 2) int32; lcs, rcs, lcsT, rcsT: (E, S*C, S) fp32 with
// E = n_ops; ec, ecT: (S*C, S); ttab: (S*C, ncols); rr: (S*C,); glik: (n_pad,);
// bbuf, gbuf: (n_boundaries, S*C, n_pad), fp32, or bf16 when bf16 is set;
// partial: (n_blocks, 2*E*S*C*S + S*C*S + S*C) fp32 (block b takes tiles
// [b*tiles_per_block, ...)).  n_pad is a multiple of 32.  Returns
// cudaGetLastError().
extern "C" int plf_tree_seg_bwd_launch(
    const void* codes, int code_bytes, const int* prog, int n_ops,
    const int* segs, int n_seg, const float* lcs, const float* rcs,
    const float* lcsT, const float* rcsT, const float* ec, const float* ecT,
    const float* ttab, int ncols, const float* rr, const float* glik,
    const void* bbuf, void* gbuf, float* partial, int seg_ops, int n_blocks,
    int tiles_per_block, int n, int n_pad, int categories, int bf16,
    void* stream) {
  if (n_pad <= 0 || n_pad % kSites || n_ops <= 0 || n_seg <= 0 ||
      seg_ops <= 0 || n_blocks <= 0 || tiles_per_block <= 0 ||
      (long long)n_blocks * tiles_per_block * kSites < n_pad)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4) {
    PLF_DISPATCH_T(bf16, PLF_DISPATCH_C(categories,
        return launch<C_, int32_t, T_>(
            codes, prog, n_ops, segs, n_seg, lcs, rcs, lcsT, rcsT, ec, ecT,
            ttab, ncols, rr, glik, bbuf, gbuf, partial, seg_ops, n_blocks,
            tiles_per_block, n, n_pad, st)));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_T(bf16, PLF_DISPATCH_C(categories,
        return launch<C_, int8_t, T_>(
            codes, prog, n_ops, segs, n_seg, lcs, rcs, lcsT, rcsT, ec, ecT,
            ttab, ncols, rr, glik, bbuf, gbuf, partial, seg_ops, n_blocks,
            tiles_per_block, n, n_pad, st)));
  }
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of the launch plf_tree_seg_bwd_launch would make.
extern "C" int plf_tree_seg_bwd_occupancy(int code_bytes, int categories,
                                          int ncols, int seg_ops, int bf16,
                                          int* blocks) {
  if (code_bytes == 4) {
    PLF_DISPATCH_T(bf16, PLF_DISPATCH_C(categories,
        return occupancy<C_, int32_t, T_>(ncols, seg_ops, blocks)));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_T(bf16, PLF_DISPATCH_C(categories,
        return occupancy<C_, int8_t, T_>(ncols, seg_ops, blocks)));
  }
  return (int)cudaErrorInvalidValue;
}

// The fixed-order second pass over the blocks' rows.
extern "C" int plf_tree_seg_bwd_reduce(const float* partial, int rows, int cols,
                                       float* out, void* stream) {
  return plf::colsum64(partial, rows, cols, out,
                       static_cast<cudaStream_t>(stream));
}
