// Kernel 4: the checkpointed whole-tree backward (VJP of kernel 2).
//
// Replaces plf_tpu/ops/plf_tree_grad.py::_tree_bwd_kernel.  One thread per
// site, as in kernel 2, over the schedule of compile_backward_schedule
// (plf_tpu_torch/ops/plf_tree_grad.py): for schedule position i, the operand
// positions lpos[i], rpos[i] (a tip id below n_leaves, else n_leaves + the
// child's position) and eidx[i], the original edge of the operators.  A block
// of 128 threads walks its tiles of 128 sites; per tile:
//
//   phase 1  recompute the forward and checkpoint every internal CLV and its
//            rescale flag;
//   seed     g = glik on valid sites (0 on padding); grr[r] += sum_s
//            x_root[r] * g; the root's adjoint is rr[r] * g;
//   phase 2  for i = E-1 .. 0, with the adjoint of node i: g_y = f * adjoint,
//            g_p = S3(g_y; ecT), g_u1 = g_p*u2, g_u2 = g_p*u1, and the
//            adjoints of the internal children S1(g_u1; lcT[e]),
//            S1(g_u2; rcT[e]) go to their slots, which flip from CLV to
//            adjoint.  A tip child's adjoint is never formed (the TPU
//            kernel's dead store, plf_tree_grad.py:215).
//
// Carried operands.  In the post-order schedule an op with an internal child
// finds one of them at position i - 1, the child evaluated last (104 of the
// 159 ops of the 160-taxon main path, 173 of 255 at 256 taxa).  Phase 1 takes
// that child's CLV from the registers that computed it, not from the
// checkpoint, and phase 2 keeps the adjoint it forms for node i - 1 in
// registers for the next step (the root's too), never stored or reloaded.
// The checkpoint (`scratch` [slot][row][site], a warp's access to a row is
// 128 contiguous bytes; `flags` [slot][site], one byte) moves per site, at
// 159 nodes and S = C = 4: phase 1 writes 159 CLVs and flags (10.3 KB) and
// reads the 54 uncarried internal children (3.5 KB); phase 2 reads 54
// adjoints, 159 flags and every internal child (13.7 KB) and writes 54
// adjoints (3.5 KB): 31.0 KB, against 51.1 KB before the operands were
// carried (then every child and adjoint went through device memory).
//
// Operator gradients.  gl[e], gr[e] (per edge), gec and grr are sums over
// all sites (plf_grad.cuh): per tile and node each warp sums its 32 sites for
// each m; the four warps' gl/gr sums meet in a shared combining area
// (double-buffered by node) behind one __syncthreads, and 64 threads add
// them in warp order into the block's row of `partial` (the first tile
// writes it, later tiles add to it, their read issued at the start of the
// node's step); gec and grr stay in each lane's registers to the end.  A
// fixed-order second pass adds the rows.  No float atomics: two runs are
// bit-identical.  Per site and node the kernel issues ~1,800 instructions:
// the ~1,040 fp32 operations the function needs, the second computation of
// the stage-1 products in phase 2 (~224; holding u1 and u2 in the
// checkpoint instead would add 128 B per site and node), the operator loads
// (float4 rows at block-uniform addresses, cached broadcasts; ec, ecT, the
// tip table and rr sit in shared memory) and the sums' staging and
// butterflies (~500).
//
// Bound, and what bounds it on an H100 (80 GB HBM3, 700 W).  The least time
// is that of the checkpoint's ~31 KB per site at 159 nodes (9.7 ms at 3.35
// TB/s for 2^20 sites); the function's operations take 2.7 ms at 67 TFLOP/s.
// At 160 taxa x 2^20 sites it runs 25.1 ms, 1.3 TB/s: latency-bound at 3
// blocks of 4 warps per SM.  __launch_bounds__
// holds it to 168 registers (186 bytes of spills at C = 4; the C > 4
// instances spill more).  Variants timed while it was designed: no bound,
// 255 registers and 2 blocks, 31.4 ms; 4 blocks, 128 registers and 672
// bytes of spills, 30.5 ms; without the operator-gradient sums 19.9 ms.
// The next op's operand rows, flags and codes are asked of L2 a step ahead
// (plf::prefetch_l2, one lane per row): 25.0 against 26.2 ms without.
//
// The host launches one wave of resident blocks over chunks of sites whose
// scratch fits a budget derived from the card's free memory (plf_tree_bwd in
// plf_tree_grad.py); `site0` is the chunk's first site and `chunk` its
// length, the scratch's site stride.
#include "plf_grad.cuh"

namespace {

constexpr int kT = plf::kGradThreads;
constexpr int kW = kT / plf::kWarp;   // warps per block

template <int C, typename CodeT>
__global__ void __launch_bounds__(kT, 3)
plf_tree_bwd_kernel(const CodeT* __restrict__ codes, int n_leaves,
                    const int* __restrict__ bsched, int n_edges,
                    const float* lcs, const float* rcs, const float* lcsT,
                    const float* rcsT, const float* ec, const float* ecT,
                    const float* ttab, int ncols, const float* rr,
                    const float* __restrict__ glik, float* scratch,
                    unsigned char* flags, int site0, int chunk,
                    float* __restrict__ partial, int tiles_per_block, int n,
                    int n_pad) {
  constexpr int R = plf::S * C;
  constexpr int RS = R * plf::S;
  constexpr int NQ = plf::grad_passes<C>();
  constexpr int NC = 2 * NQ * plf::kWarp;                // float2 per warp
  extern __shared__ float4 smem4[];
  float4* s_ec = smem4;                                  // R float4
  float4* s_ecT = smem4 + R;                             // R float4
  float* s_st = reinterpret_cast<float*>(smem4 + 2 * R); // kW staging areas
  float2* comb = reinterpret_cast<float2*>(
      s_st + kW * plf::warp_stage_floats<C>());          // [2][kW][NC]
  float* s_tt = reinterpret_cast<float*>(comb + 2 * kW * NC);  // R * ncols
  float* s_rr = s_tt + R * ncols;                        // R
  const int tid = threadIdx.x;
  const int lane = tid % plf::kWarp, warp = tid / plf::kWarp;
  float* st = s_st + warp * plf::warp_stage_floats<C>();
  for (int i = tid; i < R; i += kT) {
    s_ec[i] = reinterpret_cast<const float4*>(ec)[i];
    s_ecT[i] = reinterpret_cast<const float4*>(ecT)[i];
    s_rr[i] = rr[i];
  }
  for (int i = tid; i < R * ncols; i += kT) s_tt[i] = ttab[i];
  __syncthreads();

  const int* lpos = bsched;
  const int* rpos = bsched + n_edges;
  const int* eidx = bsched + 2 * n_edges;
  const int E = n_edges;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(tile0 + tiles_per_block, chunk / kT);
  const size_t row_stride = (size_t)chunk;
  const size_t cols = (size_t)2 * E * RS + RS + R;
  float* part = partial + blockIdx.x * cols;
  // Thread tid < NC owns gl/gr entries (m, q, lane') = tid of each node's
  // combined sums: m = tid / (NQ*32), entries grad_entry(lane', q, 0 and 1).
  const int own_m = tid / (NQ * plf::kWarp);
  const int own_e0 = tid < NC ? plf::grad_entry<C>(tid % plf::kWarp,
                                                   (tid / plf::kWarp) % NQ, 0)
                              : -1;
  const int own_e1 = tid < NC ? plf::grad_entry<C>(tid % plf::kWarp,
                                                   (tid / plf::kWarp) % NQ, 1)
                              : -1;

  // Operand `pos` of this thread's site: a tip's table column, or a checkpoint.
  auto load = [&](int pos, int local, int site, float (&x)[R]) {
    if (pos < n_leaves) {
      const int code = (int)codes[(size_t)pos * n_pad + site];
      const bool ok = code >= 0 && code < ncols;  // else no column: zeros
      const int col = ok ? code : 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = s_tt[r * ncols + col];
        x[r] = ok ? v : 0.0f;
      }
    } else {
      const float* s = scratch + (size_t)(pos - n_leaves) * R * row_stride + local;
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = s[r * row_stride];
    }
  };
  auto store = [&](int slot, int local, const float (&x)[R]) {
    float* d = scratch + (size_t)slot * R * row_stride + local;
#pragma unroll
    for (int r = 0; r < R; ++r) d[r * row_stride] = x[r];
  };
  // Ask L2 for the lines of operand `pos` of this warp's 32 sites (from
  // `wsite`, local): lane r < R the checkpoint row r, lane 0 a tip's codes.
  auto prefetch = [&](int pos, int wsite) {
    if (pos >= n_leaves) {
      if (lane < R)
        plf::prefetch_l2(scratch + ((size_t)(pos - n_leaves) * R + lane) *
                                       row_stride + wsite);
    } else if (lane == 0) {
      plf::prefetch_l2(codes + (size_t)pos * n_pad + site0 + wsite);
    }
  };

  float2 gsum[NQ];   // gec: this lane's entries, op by op over all tiles
#pragma unroll
  for (int q = 0; q < NQ; ++q) gsum[q] = make_float2(0.0f, 0.0f);
  float acc_rr = 0.0f;
  int buf = 0;

  for (int t = tile0; t < tile1; ++t) {
    const int local = t * kT + tid;
    const int site = site0 + local;
    const bool valid = site < n;
    const int wsite = t * kT + warp * plf::kWarp;

    // ---- phase 1: forward recompute, every internal CLV checkpointed ----
    float cur[R];   // the CLV of the op evaluated last
    for (int i = 0; i < E; ++i) {
      const int lp = __ldg(lpos + i), rp = __ldg(rpos + i), e = __ldg(eidx + i);
      const int prev = i > 0 ? n_leaves + i - 1 : -1;   // op i - 1's position
      if (i + 1 < E) {   // the next op's operands, but the one it carries
        const int nl = __ldg(lpos + i + 1), nr = __ldg(rpos + i + 1);
        if (nl != n_leaves + i) prefetch(nl, wsite);
        if (nr != n_leaves + i) prefetch(nr, wsite);
      }
      float a[R], b[R];
      if (lp == prev) {
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = cur[r];
      } else {
        load(lp, local, site, a);
      }
      if (rp == prev) {
#pragma unroll
        for (int r = 0; r < R; ++r) b[r] = cur[r];
      } else {
        load(rp, local, site, b);
      }
      const float4* lc = reinterpret_cast<const float4*>(lcs) + (size_t)e * R;
      const float4* rc = reinterpret_cast<const float4*>(rcs) + (size_t)e * R;
      const int f = plf::plf_site<C>(a, b, lc, rc, s_ec, valid, cur);
      store(i, local, cur);
      flags[(size_t)i * row_stride + local] = (unsigned char)f;
    }

    // ---- seed: root-vector gradient and the root adjoint (carried) ----
    const float g = valid ? glik[site] : 0.0f;
    plf::warp_root_grad<C>(st, cur, g, lane, acc_rr);
    float adj[R];   // the adjoint of the next node, when carried
#pragma unroll
    for (int r = 0; r < R; ++r) adj[r] = __fmul_rn(s_rr[r], g);
    bool carried = true;

    // ---- phase 2: reverse sweep, slots flip from CLV to adjoint ----
    for (int i = E - 1; i >= 0; --i) {
      const int lp = __ldg(lpos + i), rp = __ldg(rpos + i), e = __ldg(eidx + i);
      const int prev = n_leaves + i - 1;
      if (i > 0) {   // node i - 1's children, flag and (uncarried) adjoint
        prefetch(__ldg(lpos + i - 1), wsite);
        prefetch(__ldg(rpos + i - 1), wsite);
        if (lp != prev && rp != prev) prefetch(prev, wsite);
        if (lane == 0)
          plf::prefetch_l2(flags + (size_t)(i - 1) * row_stride + wsite);
      }
      float* gl = part + (size_t)own_m * E * RS + (size_t)e * RS;
      float old0 = 0.0f, old1 = 0.0f;   // this block's sums so far
      if (t > tile0) {
        if (own_e0 >= 0) old0 = gl[own_e0];
        if (own_e1 >= 0) old1 = gl[own_e1];
      }
      const float4* lc = reinterpret_cast<const float4*>(lcs) + (size_t)e * R;
      const float4* rc = reinterpret_cast<const float4*>(rcs) + (size_t)e * R;
      const float4* lcT = reinterpret_cast<const float4*>(lcsT) + (size_t)e * R;
      const float4* rcT = reinterpret_cast<const float4*>(rcsT) + (size_t)e * R;
      const float fac =
          flags[(size_t)i * row_stride + local] ? plf::TWO_TO_THE_32 : 1.0f;
      float gy[R], a[R], b[R];
      if (carried) {
#pragma unroll
        for (int r = 0; r < R; ++r) gy[r] = adj[r];
      } else {
        load(n_leaves + i, local, site, gy);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) gy[r] = __fmul_rn(gy[r], fac);
      load(lp, local, site, a);
      load(rp, local, site, b);
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
      carried = false;
      float2 s0[NQ], s1[NQ], s2[NQ];
      if (lp >= n_leaves) {
        float o[R];
        plf::stage<C>(gu1, lcT, o);
        if (lp == prev) {
#pragma unroll
          for (int r = 0; r < R; ++r) adj[r] = o[r];
          carried = true;
        } else {
          store(lp - n_leaves, local, o);
        }
      }
      plf::warp_op_grad<C>(st, a, gu1, lane, s0);
      if (rp >= n_leaves) {
        float o[R];
        plf::stage<C>(gu2, rcT, o);
        if (rp == prev) {
#pragma unroll
          for (int r = 0; r < R; ++r) adj[r] = o[r];
          carried = true;
        } else {
          store(rp - n_leaves, local, o);
        }
      }
      plf::warp_op_grad<C>(st, b, gu2, lane, s1);
      plf::warp_op_grad<C>(st, u1, gy, lane, s2);
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        gsum[q] = make_float2(__fadd_rn(gsum[q].x, s2[q].x),
                              __fadd_rn(gsum[q].y, s2[q].y));

      // gl[e], gr[e]: the four warps' sums in warp order, into the block row.
      float2* cb = comb + buf * kW * NC;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        cb[warp * NC + q * plf::kWarp + lane] = s0[q];
        cb[warp * NC + (NQ + q) * plf::kWarp + lane] = s1[q];
      }
      __syncthreads();
      if (tid < NC) {
        float2 v = cb[tid];
#pragma unroll
        for (int w = 1; w < kW; ++w) {
          const float2 u = cb[w * NC + tid];
          v = make_float2(__fadd_rn(v.x, u.x), __fadd_rn(v.y, u.y));
        }
        if (own_e0 >= 0) gl[own_e0] = __fadd_rn(old0, v.x);
        if (own_e1 >= 0) gl[own_e1] = __fadd_rn(old1, v.y);
      }
      buf ^= 1;
    }
  }

  // gec and grr: each warp's share, added in warp order.
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    comb[warp * NC + q * plf::kWarp + lane] = gsum[q];
  comb[warp * NC + NQ * plf::kWarp + lane] = make_float2(acc_rr, 0.0f);
  __syncthreads();
  if (tid < (NQ + 1) * plf::kWarp) {
    float2 v = comb[tid];
#pragma unroll
    for (int w = 1; w < kW; ++w) {
      const float2 u = comb[w * NC + tid];
      v = make_float2(__fadd_rn(v.x, u.x), __fadd_rn(v.y, u.y));
    }
    float* tail = part + (size_t)2 * E * RS;
    if (tid < NQ * plf::kWarp) {
      const int q = tid / plf::kWarp, ln = tid % plf::kWarp;
      const int e0 = plf::grad_entry<C>(ln, q, 0);
      const int e1 = plf::grad_entry<C>(ln, q, 1);
      if (e0 >= 0) tail[e0] = v.x;
      if (e1 >= 0) tail[e1] = v.y;
    } else if (tid - NQ * plf::kWarp < R) {
      tail[RS + tid - NQ * plf::kWarp] = v.x;
    }
  }
}

template <int C>
size_t smem_bytes(int ncols) {
  constexpr int R = plf::S * C;
  return sizeof(float) * ((size_t)2 * R * plf::S +
                          (size_t)kW * plf::warp_stage_floats<C>() +
                          (size_t)2 * kW * 4 * plf::grad_passes<C>() * plf::kWarp +
                          (size_t)R * ncols + R);
}

template <int C, typename CodeT>
int launch(const void* codes, int n_leaves, const int* bsched, int n_edges,
           const float* lcs, const float* rcs, const float* lcsT,
           const float* rcsT, const float* ec, const float* ecT,
           const float* ttab, int ncols, const float* rr, const float* glik,
           float* scratch, unsigned char* flags, int site0, int chunk,
           float* partial, int n_blocks, int tiles_per_block, int n, int n_pad,
           cudaStream_t st) {
  const size_t smem = smem_bytes<C>(ncols);
  auto kern = plf_tree_bwd_kernel<C, CodeT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<n_blocks, kT, smem, st>>>(static_cast<const CodeT*>(codes), n_leaves,
                                   bsched, n_edges, lcs, rcs, lcsT, rcsT, ec,
                                   ecT, ttab, ncols, rr, glik, scratch, flags,
                                   site0, chunk, partial, tiles_per_block, n,
                                   n_pad);
  return (int)cudaGetLastError();
}

template <int C, typename CodeT>
int occupancy(int ncols, int* blocks) {
  const size_t smem = smem_bytes<C>(ncols);
  auto kern = plf_tree_bwd_kernel<C, CodeT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, kT,
                                                            smem);
}

}  // namespace

// One chunk of sites [site0, site0 + chunk).  codes: (n_leaves, n_pad) int32
// (code_bytes 4) or int8 (1); bsched: (3, n_edges) int32 rows lpos, rpos,
// eidx; lcs, rcs, lcsT, rcsT: (E, S*C, S) fp32; ec, ecT: (S*C, S); ttab:
// (S*C, ncols); rr: (S*C,); glik: (n_pad,) fp32; scratch: (E, S*C, chunk)
// fp32; flags: (E, chunk) bytes; partial: (n_blocks, 2*E*S*C*S + S*C*S + S*C)
// fp32, this chunk's rows (block b takes tiles [b*tiles_per_block, ...) of the
// chunk).  chunk and n_pad are multiples of 128.  Returns cudaGetLastError().
extern "C" int plf_tree_bwd_launch(
    const void* codes, int code_bytes, int n_leaves, const int* bsched,
    int n_edges, const float* lcs, const float* rcs, const float* lcsT,
    const float* rcsT, const float* ec, const float* ecT, const float* ttab,
    int ncols, const float* rr, const float* glik, float* scratch,
    unsigned char* flags, int site0, int chunk, float* partial, int n_blocks,
    int tiles_per_block, int n, int n_pad, int categories, void* stream) {
  if (n_pad <= 0 || n_pad % kT || chunk <= 0 || chunk % kT || site0 < 0 ||
      site0 + chunk > n_pad || n_edges <= 0 || n_blocks <= 0 ||
      tiles_per_block <= 0 ||
      (long long)n_blocks * tiles_per_block * kT < chunk ||
      (long long)(n_blocks - 1) * tiles_per_block * kT >= chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4) {
    PLF_DISPATCH_C(categories, return launch<C_, int32_t>(
                                   codes, n_leaves, bsched, n_edges, lcs, rcs,
                                   lcsT, rcsT, ec, ecT, ttab, ncols, rr, glik,
                                   scratch, flags, site0, chunk, partial,
                                   n_blocks, tiles_per_block, n, n_pad, st));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_C(categories, return launch<C_, int8_t>(
                                   codes, n_leaves, bsched, n_edges, lcs, rcs,
                                   lcsT, rcsT, ec, ecT, ttab, ncols, rr, glik,
                                   scratch, flags, site0, chunk, partial,
                                   n_blocks, tiles_per_block, n, n_pad, st));
  }
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of the launch plf_tree_bwd_launch would make.
extern "C" int plf_tree_bwd_occupancy(int code_bytes, int categories,
                                      int ncols, int* blocks) {
  if (code_bytes == 4) {
    PLF_DISPATCH_C(categories, return occupancy<C_, int32_t>(ncols, blocks));
  } else if (code_bytes == 1) {
    PLF_DISPATCH_C(categories, return occupancy<C_, int8_t>(ncols, blocks));
  }
  return (int)cudaErrorInvalidValue;
}

// The fixed-order second pass over all chunks' partials: out[c] = sum over
// rows b of partial[b][c], in row order.
extern "C" int plf_tree_bwd_reduce(const float* partial, int rows, int cols,
                                   float* out, void* stream) {
  return plf::colsum(partial, rows, cols, out,
                     static_cast<cudaStream_t>(stream));
}
