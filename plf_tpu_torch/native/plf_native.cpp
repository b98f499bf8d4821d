// The golden PLF on the host, for the port's command-line benchmark and
// its tests.
//
// A copy of plf_tpu/native/plf_native.cpp (the port never imports
// plf_tpu):
//  1. plf_golden / plf_golden_mt: the scalar golden model (fp32, sequential
//     accumulation, no fp contraction: build with -ffp-contract=off) used as
//     a fast verification oracle for large site counts.  The multithreaded
//     form is exact: sites are independent, and the per-range scaler counts
//     are summed in order.
//  2. Lane-layout converters: site-major (n, C*S) <-> lane-major (S*C, n).
//  3. Instance buffer packers in the reference's COMBINED / SEPARATE
//     header layouts ([EV|branch|CLV] vs [branch|CLV]), and the
//     per-category branch transpose.
//  4. plf_tree_golden_mt: the whole-tree golden oracle, the post-order
//     traversal per site in the tree kernels' fp32 op order.
// plf_tpu_torch/runtime/native.py builds it with g++ at first use and binds
// it with ctypes.
//
// Plain C ABI, fp32, row-major.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- golden --

// Generalised newviewGAMMA semantics (states S, categories C).
// x1, x2: n * C*S floats (site-major).  left/right: C*S*S ([c][k][a]).
// ev: S*S ([k][a]).  wgt: n ints.  out x3: n * C*S.  scaler: n bytes.
// Returns the weighted scaler increment.
static long long plf_golden_range(
    const float* x1, const float* x2, float* x3, const float* ev,
    long long site_lo, long long site_hi, const float* left,
    const float* right, const int* wgt, unsigned char* scaler,
    int states, int categories) {
  const int S = states, C = categories;
  const int e = S * C;
  const float minlik = ldexpf(1.0f, -32);
  const float two32 = ldexpf(1.0f, 32);
  long long add_scale = 0;
  std::vector<float> px(S);
  for (long long i = site_lo; i < site_hi; ++i) {
    const float* a1 = x1 + i * e;
    const float* a2 = x2 + i * e;
    float* a3 = x3 + i * e;
    for (int c = 0; c < C; ++c) {
      const float* l = left + c * S * S;
      const float* r = right + c * S * S;
      for (int k = 0; k < S; ++k) {
        float u1 = 0.0f, u2 = 0.0f;
        for (int a = 0; a < S; ++a) {
          u1 += a1[c * S + a] * l[k * S + a];
          u2 += a2[c * S + a] * r[k * S + a];
        }
        px[k] = u1 * u2;
      }
      for (int a = 0; a < S; ++a) a3[c * S + a] = 0.0f;
      for (int k = 0; k < S; ++k) {
        for (int a = 0; a < S; ++a) {
          a3[c * S + a] += px[k] * ev[k * S + a];
        }
      }
    }
    int scale = 1;
    for (int j = 0; scale && j < e; ++j) {
      scale = (fabsf(a3[j]) < minlik);
    }
    if (scale) {
      for (int j = 0; j < e; ++j) a3[j] *= two32;
      scaler[i] = 1;
      add_scale += wgt ? wgt[i] : 1;
    } else {
      scaler[i] = 0;
    }
  }
  return add_scale;
}

long long plf_golden(const float* x1, const float* x2, float* x3,
                     const float* ev, long long n, const float* left,
                     const float* right, const int* wgt,
                     unsigned char* scaler, int states, int categories) {
  return plf_golden_range(x1, x2, x3, ev, 0, n, left, right, wgt, scaler,
                          states, categories);
}

long long plf_golden_mt(const float* x1, const float* x2, float* x3,
                        const float* ev, long long n, const float* left,
                        const float* right, const int* wgt,
                        unsigned char* scaler, int states, int categories,
                        int num_threads) {
  if (num_threads <= 1 || n < 4096) {
    return plf_golden(x1, x2, x3, ev, n, left, right, wgt, scaler, states,
                      categories);
  }
  std::vector<long long> partial(num_threads, 0);
  std::vector<std::thread> threads;
  long long chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    long long lo = t * chunk;
    long long hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back([=, &partial]() {
      partial[t] = plf_golden_range(x1, x2, x3, ev, lo, hi, left, right,
                                    wgt, scaler, states, categories);
    });
  }
  for (auto& th : threads) th.join();
  long long total = 0;
  for (long long p : partial) total += p;
  return total;
}

// ---------------------------------------------------------- lane layouts --

// site-major (n, C*S) [site][c*S+a] -> lane-major (S*C, n) row = a*C+c.
void to_lane_major(const float* in, float* out, long long n, int states,
                   int categories) {
  const int S = states, C = categories;
  for (int a = 0; a < S; ++a) {
    for (int c = 0; c < C; ++c) {
      float* dst = out + (long long)(a * C + c) * n;
      const float* src = in + c * S + a;
      const long long stride = (long long)S * C;
      for (long long i = 0; i < n; ++i) dst[i] = src[i * stride];
    }
  }
}

// lane-major (S*C, n_pad) -> site-major (n, C*S).
void from_lane_major(const float* in, float* out, long long n,
                     long long n_pad, int states, int categories) {
  const int S = states, C = categories;
  for (int a = 0; a < S; ++a) {
    for (int c = 0; c < C; ++c) {
      const float* src = in + (long long)(a * C + c) * n_pad;
      float* dst = out + c * S + a;
      const long long stride = (long long)S * C;
      for (long long i = 0; i < n; ++i) dst[i * stride] = src[i];
    }
  }
}

// ------------------------------------------------------ instance packing --

// Pack one instance input buffer in the reference COMBINED layout:
// [EV(S*S) | branch(C*S*S) | CLV(n*C*S)] (host_mem.cpp:231-236).
// layout: 0 = COMBINED (EV+branch header), 1 = SEPARATE right buffer
// (branch only, host_mem.cpp:238-240).  Returns floats written.
long long pack_instance(const float* ev, const float* branch,
                        const float* clv, float* out, long long n_sites,
                        int states, int categories, int layout) {
  const int S = states, C = categories;
  long long off = 0;
  if (layout == 0) {
    std::memcpy(out, ev, sizeof(float) * S * S);
    off += S * S;
  }
  std::memcpy(out + off, branch, sizeof(float) * C * S * S);
  off += (long long)C * S * S;
  std::memcpy(out + off, clv, sizeof(float) * n_sites * C * S);
  off += n_sites * (long long)C * S;
  return off;
}

// Unpack a COMBINED/SEPARATE instance buffer (inverse of pack_instance).
long long unpack_instance(const float* in, float* ev, float* branch,
                          float* clv, long long n_sites, int states,
                          int categories, int layout) {
  const int S = states, C = categories;
  long long off = 0;
  if (layout == 0) {
    std::memcpy(ev, in, sizeof(float) * S * S);
    off += S * S;
  }
  std::memcpy(branch, in + off, sizeof(float) * C * S * S);
  off += (long long)C * S * S;
  std::memcpy(clv, in + off, sizeof(float) * n_sites * C * S);
  off += n_sites * (long long)C * S;
  return off;
}

// 4x4-per-category branch transpose (the PL pre-stream transpose,
// hls/src/transpose.cpp:6-24, generalised to S states): [c][k][a] ->
// [c][a][k].
void transpose_branch(const float* in, float* out, int states,
                      int categories) {
  const int S = states;
  for (int c = 0; c < categories; ++c) {
    const float* b = in + c * S * S;
    float* t = out + c * S * S;
    for (int k = 0; k < S; ++k)
      for (int a = 0; a < S; ++a) t[a * S + k] = b[k * S + a];
  }
}

// -------------------------------------------------------- tree golden ----

// Whole-tree golden oracle: evaluates the full post-order traversal per
// site with EXACTLY the device kernels' fp32 op order (sequential
// accumulation over source state a and eigen index k; tip expansion =
// direct table lookup; underflow rescale by 2^32 per node).  This is
// the tree-level analogue of the reference's host-side verification
// loop (app/src/host_mem.cpp:403-442 recomputes every workload with
// plf()) for the fused/segmented tree kernels.
//
// codes:  (n_leaves, n) int32 tip-table column indices.
// ttab:   (S, ncode) eigen-coordinate tip table ([a][col]).
// lsrc/rsrc/oslot: (E,) UNIFIED arena coordinates — slots [0, n_leaves)
//         are tips, the rest register slots (compile_register_schedule
//         + n_leaves offset, as in ops/plf_tree.py).
// lbr/rbr: (E, C, S, S) branch factors [e][c][k][a].
// ev:     (S, S) [k][a].   rr: (S*C) root rows, row = a*C + c.
// lik/sc: (n,) per-site likelihood and rescale counts.
static void plf_tree_golden_range(
    const int32_t* codes, long long n, int n_leaves, const float* ttab,
    int ncode, const int32_t* lsrc, const int32_t* rsrc,
    const int32_t* oslot, int n_edges, int n_slots, const float* lbr,
    const float* rbr, const float* ev, const float* rr, int states,
    int categories, float* lik, int32_t* sc, long long lo, long long hi) {
  const int S = states, C = categories;
  const int e_sz = C * S;
  const float minlik = ldexpf(1.0f, -32);
  const float two32 = ldexpf(1.0f, 32);
  std::vector<float> arena((size_t)n_slots * e_sz);
  std::vector<float> px(S);
  std::vector<float> out(e_sz);
  for (long long i = lo; i < hi; ++i) {
    for (int l = 0; l < n_leaves; ++l) {
      const int col = codes[(long long)l * n + i];
      float* slot = arena.data() + (size_t)l * e_sz;
      for (int c = 0; c < C; ++c)
        for (int a = 0; a < S; ++a)
          slot[c * S + a] = ttab[a * ncode + col];
    }
    int32_t count = 0;
    for (int e = 0; e < n_edges; ++e) {
      const float* x1 = arena.data() + (size_t)lsrc[e] * e_sz;
      const float* x2 = arena.data() + (size_t)rsrc[e] * e_sz;
      const float* lb = lbr + (size_t)e * C * S * S;
      const float* rb = rbr + (size_t)e * C * S * S;
      for (int c = 0; c < C; ++c) {
        const float* l = lb + c * S * S;
        const float* r = rb + c * S * S;
        for (int k = 0; k < S; ++k) {
          float u1 = 0.0f, u2 = 0.0f;
          for (int a = 0; a < S; ++a) {
            u1 += x1[c * S + a] * l[k * S + a];
            u2 += x2[c * S + a] * r[k * S + a];
          }
          px[k] = u1 * u2;
        }
        for (int a = 0; a < S; ++a) out[c * S + a] = 0.0f;
        for (int k = 0; k < S; ++k)
          for (int a = 0; a < S; ++a)
            out[c * S + a] += px[k] * ev[k * S + a];
      }
      int scale = 1;
      for (int j = 0; scale && j < e_sz; ++j)
        scale = (fabsf(out[j]) < minlik);
      if (scale) {
        for (int j = 0; j < e_sz; ++j) out[j] *= two32;
        ++count;
      }
      std::memcpy(arena.data() + (size_t)oslot[e] * e_sz, out.data(),
                  sizeof(float) * e_sz);
    }
    const float* root = arena.data() + (size_t)oslot[n_edges - 1] * e_sz;
    float acc = 0.0f;  // row order a*C + c, sequential (kernel order)
    for (int a = 0; a < S; ++a)
      for (int c = 0; c < C; ++c)
        acc += rr[a * C + c] * root[c * S + a];
    lik[i] = acc;
    sc[i] = count;
  }
}

void plf_tree_golden_mt(const int32_t* codes, long long n, int n_leaves,
                        const float* ttab, int ncode, const int32_t* lsrc,
                        const int32_t* rsrc, const int32_t* oslot,
                        int n_edges, int n_slots, const float* lbr,
                        const float* rbr, const float* ev, const float* rr,
                        int states, int categories, float* lik,
                        int32_t* sc, int num_threads) {
  if (num_threads <= 1 || n < 1024) {
    plf_tree_golden_range(codes, n, n_leaves, ttab, ncode, lsrc, rsrc,
                          oslot, n_edges, n_slots, lbr, rbr, ev, rr,
                          states, categories, lik, sc, 0, n);
    return;
  }
  std::vector<std::thread> threads;
  long long chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    long long lo = t * chunk;
    long long hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back([=]() {
      plf_tree_golden_range(codes, n, n_leaves, ttab, ncode, lsrc, rsrc,
                            oslot, n_edges, n_slots, lbr, rbr, ev, rr,
                            states, categories, lik, sc, lo, hi);
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
