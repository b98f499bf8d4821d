// Kernel 4: the checkpointed whole-tree backward (VJP of kernel 2).
//
// Replaces plf_tpu/ops/plf_tree_grad.py::_tree_bwd_kernel.  One thread per
// site, as in kernel 2, over the schedule of compile_backward_schedule
// (plf_tpu_torch/ops/plf_tree_grad.py): for schedule position i, the operand
// positions lpos[i], rpos[i] (a tip id below n_leaves, else n_leaves + the
// child's position) and eidx[i], the original edge of the operators.
//
//   phase 1  recompute the forward and checkpoint every internal CLV and its
//            rescale flag;
//   seed     g = glik on valid sites (0 on padding); grr[r] += sum_s
//            x_root[r] * g; the root's slot becomes its adjoint rr[r] * g;
//   phase 2  for i = E-1 .. 0: slot i holds the adjoint of node i (written by
//            its parent's step), its children's slots still hold their CLVs;
//            g_y = f * adjoint, g_p = S3(g_y; ecT), g_u1 = g_p*u2,
//            g_u2 = g_p*u1, and the children's slots flip to their adjoints
//            S1(g_u1; lcT[e]), S1(g_u2; rcT[e]).  A tip child's adjoint is
//            never stored (the TPU kernel's dead store, plf_tree_grad.py:215).
//   gl[e], gr[e] (per edge), gec and grr are sums over all sites: per-block
//   partials and a fixed-order second pass, no float atomics (plf_grad.cuh).
//
// The checkpoint.  The TPU kernel keeps n_leaves + E slots per site block in
// VMEM.  Without tips it is still E * S*C * 4 bytes per site (10 KB at 159
// nodes), so a 227 KB block of shared memory would hold ~22 sites: it lives in
// device memory instead, as `scratch` laid out [slot][row][site] (a warp's
// access to one row is 128 contiguous bytes) and `flags` [slot][site], one
// byte each.  The host launches over chunks of sites so that the scratch fits
// a budget derived from the card's free memory (plf_tree_bwd in
// plf_tree_grad.py); `site0` is the chunk's first site and `chunk` its length,
// the scratch's site stride.
//
// Bound: device memory.  Per site and node, phase 1 writes the CLV and reads
// an internal child's (~128 B), phase 2 reads the adjoint and both children
// and writes the internal children's adjoints (~320 B): ~60 KB per site at 159
// nodes, for ~3 x 23 fp32 operations per CLV element per node.  Operators are
// read from device memory as float4 rows at block-uniform addresses (cached
// broadcasts); ec, ecT, the tip table and rr are staged in shared memory.
#include "plf_grad.cuh"

namespace {

constexpr int kT = plf::kGradThreads;

template <int C, typename CodeT>
__global__ void __launch_bounds__(kT)
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
  constexpr int NS = plf::grad_slots<C>();
  extern __shared__ float4 smem4[];
  float4* s_ec = smem4;                                  // R float4
  float4* s_ecT = smem4 + R;                             // R float4
  float* s_tt = reinterpret_cast<float*>(smem4 + 2 * R); // R * ncols
  float* s_rr = s_tt + R * ncols;                        // R
  float* st = s_rr + R;                                  // staging
  const int tid = threadIdx.x;
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

  // ---- phase 1: forward recompute, every internal CLV checkpointed ----
  for (int t = tile0; t < tile1; ++t) {
    const int local = t * kT + tid;
    const int site = site0 + local;
    const bool valid = site < n;
    float a[R], b[R], out[R];
    for (int i = 0; i < E; ++i) {
      load(__ldg(lpos + i), local, site, a);
      load(__ldg(rpos + i), local, site, b);
      const int e = __ldg(eidx + i);
      const float4* lc = reinterpret_cast<const float4*>(lcs) + (size_t)e * R;
      const float4* rc = reinterpret_cast<const float4*>(rcs) + (size_t)e * R;
      const int f = plf::plf_site<C>(a, b, lc, rc, s_ec, valid, out);
      store(i, local, out);
      flags[(size_t)i * row_stride + local] = (unsigned char)f;
    }
  }

  // ---- seed: root-vector gradient and the root adjoint ----
  float acc_rr = 0.0f;
  for (int t = tile0; t < tile1; ++t) {
    const int local = t * kT + tid;
    const int site = site0 + local;
    const float g = site < n ? glik[site] : 0.0f;
    float x[R], adj[R];
    load(n_leaves + E - 1, local, site, x);
#pragma unroll
    for (int r = 0; r < R; ++r) adj[r] = __fmul_rn(s_rr[r], g);
    store(E - 1, local, adj);
    plf::stage_put<C>(st, 0, x, tid);
    st[(size_t)R * plf::kStagePitch + tid] = g;   // staging array 1, row 0
    __syncthreads();
    if (tid < R) {
      const float* xr = st + (size_t)tid * plf::kStagePitch;
      const float* gs = st + (size_t)R * plf::kStagePitch;
      float s = __fmul_rn(xr[0], gs[0]);
      for (int k = 1; k < kT; ++k) s = __fadd_rn(s, __fmul_rn(xr[k], gs[k]));
      acc_rr = __fadd_rn(acc_rr, s);
    }
    __syncthreads();
  }

  // ---- phase 2: reverse sweep, slots flip from CLV to adjoint ----
  float acc[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) acc[j] = 0.0f;
  for (int i = E - 1; i >= 0; --i) {
    const int lp = __ldg(lpos + i), rp = __ldg(rpos + i), e = __ldg(eidx + i);
    const float4* lc = reinterpret_cast<const float4*>(lcs) + (size_t)e * R;
    const float4* rc = reinterpret_cast<const float4*>(rcs) + (size_t)e * R;
    const float4* lcT = reinterpret_cast<const float4*>(lcsT) + (size_t)e * R;
    const float4* rcT = reinterpret_cast<const float4*>(rcsT) + (size_t)e * R;
    for (int t = tile0; t < tile1; ++t) {
      const int local = t * kT + tid;
      const int site = site0 + local;
      const float fac =
          flags[(size_t)i * row_stride + local] ? plf::TWO_TO_THE_32 : 1.0f;
      float gy[R], a[R], b[R];
      load(n_leaves + i, local, site, gy);
#pragma unroll
      for (int r = 0; r < R; ++r) gy[r] = __fmul_rn(gy[r], fac);
      load(lp, local, site, a);
      load(rp, local, site, b);
      float u1[R], u2[R], gp[R], gu1[R], gu2[R], o[R];
      plf::stage<C>(a, lc, u1);
      plf::stage<C>(b, rc, u2);
      plf::stage<C>(gy, s_ecT, gp);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        gu1[r] = __fmul_rn(gp[r], u2[r]);
        gu2[r] = __fmul_rn(gp[r], u1[r]);
        u1[r] = __fmul_rn(u1[r], u2[r]);  // p
      }
      plf::stage_put<C>(st, 0, a, tid);
      plf::stage_put<C>(st, 1, gu1, tid);
      plf::stage_put<C>(st, 2, b, tid);
      plf::stage_put<C>(st, 3, gu2, tid);
      plf::stage_put<C>(st, 4, u1, tid);
      plf::stage_put<C>(st, 5, gy, tid);
      if (lp >= n_leaves) {
        plf::stage<C>(gu1, lcT, o);
        store(lp - n_leaves, local, o);
      }
      if (rp >= n_leaves) {
        plf::stage<C>(gu2, rcT, o);
        store(rp - n_leaves, local, o);
      }
      __syncthreads();
      plf::op_grad_tile<C>(st, tid, acc);
      __syncthreads();
    }
    // gl[e] and gr[e] are complete for this block: write them, start afresh.
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int ent = tid + j * kT;
      if (ent < 2 * RS) {
        const int m = ent / RS;
        part[(size_t)m * E * RS + (size_t)e * RS + (ent - m * RS)] = acc[j];
        acc[j] = 0.0f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int ent = tid + j * kT;
    if (ent >= 2 * RS && ent < 3 * RS)
      part[(size_t)2 * E * RS + (ent - 2 * RS)] = acc[j];
  }
  if (tid < R) part[(size_t)2 * E * RS + RS + tid] = acc_rr;
}

template <int C>
size_t smem_bytes(int ncols) {
  constexpr int R = plf::S * C;
  return sizeof(float) * ((size_t)2 * R * plf::S + (size_t)R * ncols + R) +
         plf::grad_stage_bytes<C>();
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
      (long long)n_blocks * tiles_per_block * kT < chunk)
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

// The fixed-order second pass over all chunks' partials: out[c] = sum over
// rows b of partial[b][c], in row order.
extern "C" int plf_tree_bwd_reduce(const float* partial, int rows, int cols,
                                   float* out, void* stream) {
  return plf::colsum(partial, rows, cols, out,
                     static_cast<cudaStream_t>(stream));
}
