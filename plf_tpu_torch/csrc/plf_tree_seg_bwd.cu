// Kernel 8: the segmented whole-tree backward (VJP of kernel 7).
//
// Replaces plf_tpu/ops/plf_tree_seg.py::_seg_bwd_kernel (:843, launched by
// _seg_bwd_call :1095), its "vpu" form at S = 4.  The TPU kernel runs a
// sequential grid of (segments in reverse x site blocks) and chains the
// boundary adjoints through a buffer in device memory; here a block owns its
// tiles of kSites sites through every segment, so nothing is ordered between
// blocks.  For each tile, the segments of the plan in reverse:
//
//   phase 1  recompute the segment's ops (operands: tips from their codes,
//            boundary CLVs from bbuf, earlier ops of the segment from the
//            arena) into a shared-memory arena [slot][row][site] of one slot
//            per op, and each op's rescale flag (one byte);
//   seed     the root's adjoint: for the last segment g = glik on valid sites
//            (0 on padding), grr[r] += sum_s x_root[r] * g, adjoint rr[r] * g;
//            for the others the boundary adjoint its consumer wrote to gbuf
//            earlier in this same loop (by this same thread);
//   phase 2  kernel 4's reverse sweep: g_y = f * adjoint, g_p = S3(g_y; ecT),
//            g_u1 = g_p*u2, g_u2 = g_p*u1; a child op's slot flips to its
//            adjoint S1(g_u1; lcT[e]), a boundary child's adjoint goes to
//            gbuf[boundary][row][site], a tip child's is never formed.
//
// gl[e], gr[e] (per edge), gec and grr are sums over all sites without float
// atomics: per tile a staging pass (plf_grad.cuh, 32-site rows), each block's
// sums in its own row of `partial` (gl/gr read, added to and written back in
// tile order by the thread that owns the entry), and a fixed-order second pass
// over the rows in fp64 (plf_tree_seg_bwd_reduce).  Two runs are
// bit-identical.  Every per-site value is computed in the order of the plain
// version (plf_tree_seg_bwd_torch), so the boundary adjoints in gbuf equal its
// bit for bit.
//
// Bound: operations.  Per site and op, the forward recompute (~23 fp32
// operations per CLV element), g_p, g_u1/g_u2, an adjoint stage per internal
// child and three operator-gradient products: ~5,000 fp32 operations per site
// and op at S = C = 4, against ~64 bytes per site for each boundary read and
// adjoint written.  What the design does about it: the checkpoint of every op
// CLV lives in shared memory, not in device memory (kernel 4 moves ~60 KB per
// site at 159 nodes there); the device-memory residual is the boundary buffer,
// n_boundaries x 64 bytes per site.  The cost is occupancy: a block of 32
// threads holds seg_ops slots of 2 KB, and the planner caps seg_ops so that
// eight blocks share an SM (plan_segments in plf_tree_seg.py; on an H100 at
// 160 taxa x 2^20 sites, plans for 2, 4 and 8 blocks per SM ran this kernel
// in 104, 62 and 39 ms).
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
  constexpr int NS = plf::grad_slots<C, kSites>();
  constexpr int P = kSites + 1;                            // staging pitch
  extern __shared__ float4 smem4[];
  float4* s_ec = smem4;                                  // R float4
  float4* s_ecT = smem4 + R;                             // R float4
  float* s_tt = reinterpret_cast<float*>(smem4 + 2 * R); // R * ncols
  float* s_rr = s_tt + R * ncols;                        // R
  float* st = s_rr + R;                                  // 6 * R * P staging
  float* arena = st + 6 * R * P;                         // seg_ops * R * kSites
  unsigned char* flags =
      reinterpret_cast<unsigned char*>(arena + (size_t)seg_ops * R * kSites);
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

  // This block's gl/gr sums start at zero; each entry is owned, here and
  // below, by thread (entry % kSites).
  for (int e = 0; e < E; ++e) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int ent = tid + j * kSites;
      if (ent < 2 * RS) {
        const int m = ent / RS;
        part[(size_t)m * E * RS + (size_t)e * RS + (ent - m * RS)] = 0.0f;
      }
    }
  }

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

  float acc[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) acc[j] = 0.0f;
  float acc_rr = 0.0f;

  for (int t = tile0; t < tile1; ++t) {
    const int site = t * kSites + tid;
    const bool valid = site < n;
    for (int s = n_seg - 1; s >= 0; --s) {
      const int end = __ldg(segs + 2 * s);
      const int gout = __ldg(segs + 2 * s + 1);
      const int start = s ? __ldg(segs + 2 * s - 2) : 0;
      if (end - start > seg_ops) __trap();   // the arena was sized for less

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

      // ---- seed: the root's adjoint ----
      const int root = __ldg(oslot + end - 1);
      if (gout < 0) {
        const float g = valid ? glik[site] : 0.0f;
        float x[R], adj[R];
        load(root, 1, site, x);
#pragma unroll
        for (int r = 0; r < R; ++r) adj[r] = __fmul_rn(s_rr[r], g);
        store(root, adj);
        plf::stage_put<C, kSites>(st, 0, x, tid);
        st[(size_t)R * P + tid] = g;   // staging array 1, row 0
        __syncthreads();
        if (tid < R) {
          const float* xr = st + (size_t)tid * P;
          const float* gs = st + (size_t)R * P;
          float sum = __fmul_rn(xr[0], gs[0]);
          for (int k = 1; k < kSites; ++k)
            sum = __fadd_rn(sum, __fmul_rn(xr[k], gs[k]));
          acc_rr = __fadd_rn(acc_rr, sum);
        }
        __syncthreads();
      } else {
        float adj[R];
        const BT* src = gbuf + (size_t)gout * bnd_stride + site;
#pragma unroll
        for (int r = 0; r < R; ++r) adj[r] = plf::widen(src[(size_t)r * n_pad]);
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
        plf::stage_put<C, kSites>(st, 0, a, tid);
        plf::stage_put<C, kSites>(st, 1, gu1, tid);
        plf::stage_put<C, kSites>(st, 2, b, tid);
        plf::stage_put<C, kSites>(st, 3, gu2, tid);
        plf::stage_put<C, kSites>(st, 4, u1, tid);
        plf::stage_put<C, kSites>(st, 5, gy, tid);
        put_adjoint(lp, lf, site, gu1, lcT);
        put_adjoint(rp, rf, site, gu2, rcT);
        __syncthreads();
        float tile_sum[NS];
#pragma unroll
        for (int j = 0; j < NS; ++j) tile_sum[j] = 0.0f;
        plf::op_grad_tile<C, kSites>(st, tid, tile_sum);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int ent = tid + j * kSites;
          if (ent < 2 * RS) {          // gl[e] or gr[e]: this block's row
            const int m = ent / RS;
            float* p = part + (size_t)m * E * RS + (size_t)e * RS + (ent - m * RS);
            *p = __fadd_rn(*p, tile_sum[j]);
          } else if (ent < 3 * RS) {   // gec: summed over every op
            acc[j] = __fadd_rn(acc[j], tile_sum[j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int ent = tid + j * kSites;
    if (ent >= 2 * RS && ent < 3 * RS)
      part[(size_t)2 * E * RS + (ent - 2 * RS)] = acc[j];
  }
  if (tid < R) part[(size_t)2 * E * RS + RS + tid] = acc_rr;
}

// Dynamic shared memory of one block (seg_bwd_smem_bytes in plf_tree_seg.py).
template <int C>
size_t smem_bytes(int ncols, int seg_ops) {
  constexpr int R = plf::S * C;
  return sizeof(float) * ((size_t)2 * R * plf::S + (size_t)R * ncols + R) +
         plf::grad_stage_bytes<C, kSites>() +
         (size_t)seg_ops * (sizeof(float) * R * kSites + kSites);
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
