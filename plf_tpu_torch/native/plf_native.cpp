// The golden PLF on the host, for the port's command-line benchmark.
//
// A copy of the golden part of plf_tpu/native/plf_native.cpp (the port never
// imports plf_tpu): plf_golden / plf_golden_mt, the scalar golden model
// (fp32, sequential accumulation, no fp contraction: build with
// -ffp-contract=off) used as a fast verification oracle for large site
// counts.  The multithreaded form is exact: sites are independent, and the
// per-range scaler counts are summed in order.  plf_tpu_torch/runtime/
// native.py builds it with g++ at first use and binds it with ctypes.
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

}  // extern "C"
