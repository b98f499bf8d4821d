// Kernel 9: the compute-only PLF probe.
//
// Replaces plf_tpu/ops/plf_pallas.py::_gen_kernel (:401, launched by
// plf_pallas_gen :436), the host_gen analogue: no CLV crosses device memory.
// Each site builds its two child CLVs from its index s within its block of
// block_sites sites and from the row r,
//
//   x1[r] = (0.1 + s*1e-4) + r*0.05      x2[r] = (1 - (s*1e-4)*0.5) + (r*0.05)*0.25
//
// then runs inner_iters chained PLF nodes without the rescale: u1 = S1(x1;
// lc), u2 = S1(x2; rc), x3 = S3(u1*u2; ec), acc += (sum of the rows of x3,
// row 0 first), x1 = x3.  acc is stored per site, so nothing of the chain
// can be dropped.  Every product and sum is __fmul_rn / __fadd_rn, so the
// result equals the plain version (ops/plf_node.py::plf_node_gen_torch) bit
// for bit.  With random constants the values grow by about S^3 a node and
// reach inf at S = 61; inf arithmetic is exact, so the equality holds there
// too.
//
// Bound: operations.  Per node and site S*C*(6*S - 1) flops (three stages of
// S products and S - 1 sums per row, the stage-2 product and the row sum's
// add: 368 at S = C = 4, bench.py:297), against 4 bytes of output per site
// over all inner_iters nodes.  Under -fmad=false each product and each sum
// is its own instruction, so the card's uncontracted ceiling is half of the
// 67 TFLOP/s that counts an FMA as two flops.
//
// Design.  S = 4: two sites a thread, the rows in registers and the three
// (S*C, 4) constant matrices as float4 rows in shared memory, each row read
// once for both sites (plf_common.cuh's stage arithmetic; on an H100 one
// site a thread ran 0.281 ms at bench_gen's shape, two run 0.231: PERF.md).
// x2 is the same in every iteration; an empty asm statement makes the
// compiler treat it as new, so each iteration computes both branch products
// as _gen_kernel does.
//
// S != 4: a kernel of its own, register-blocked.  A block owns a [row][site]
// tile of TS sites of x1 (written over by x3), x2 and the stage-2 products
// in shared memory, and walks tiles with a stride of the grid (one wave of
// resident blocks), so that it stages the operators once.  The wrapper
// hands the operators transposed, kt[c][q][o] with o padded to Sp, a
// multiple of kRows (ops/plf_node.py::gen_operators), so that one float4 is
// one q's operator values for kRows consecutive output rows.  A stage job is
// one category c, kRows output rows and JS consecutive sites: per q it reads
// JS/4 float4 of src over its sites and one float4 of the operator over its
// rows, and does kRows * JS products and sums, each src value feeding kRows
// outputs and each operator value JS sites.  Each output's sum runs in q
// order; it starts from the q = 0 product, which equals the golden model's
// -0 + product bit for bit.  Stage 1 computes both branch products of its
// job and stores their product; stage 3 writes x3 over x1.  A warp's 32
// jobs are 4 categories x 8 site blocks of one output block, so its src
// reads are 4 whole tile rows and its operator reads 4 addresses, one per 8
// threads (broadcast).
//
// The operators sit in shared memory when 32-site tiles (TS = 32, JS = 4)
// and all three fit half of a block's shared memory, so that two blocks fit
// an SM (S = 20, C = 4: 30 KiB of tiles and 18.75 KiB of operators, 4
// blocks an SM).  Otherwise (S = 61, C = 4: 183 KiB of operators) they are
// read through L1 from device memory, and the tiles take 64 sites with
// 8-site jobs (TS = 64, JS = 8; 32 and 4 where those do not fit), so that
// each operator value read feeds 8 sites: on an H100 at S = 61 that ran 72
// ms where 32-site tiles ran 121 (PERF.md).  Staging the operators a stage
// at a time would re-copy 183 KiB a node.  gen_plan is the one owner of this
// rule and of the block's bytes; the wrapper asks the library
// (plf_gen_plan).
//
// The row checksum of node i reads only x3, which is node i+1's x1 tile, so
// the first TS threads sum it (row 0 first) during node i+1's stage 1,
// beside their own stage jobs, instead of between two barriers.
#include "plf_common.cuh"

namespace {

constexpr int kThreads = 256;      // S = 4: sites per block
constexpr int kSites4 = 2;         // S = 4: sites per thread
constexpr int kTileSites = 32;     // S != 4: sites per tile
constexpr int kSites = 4;          // S != 4: sites per job
constexpr int kWideSites = 64;     // S != 4, operators in device memory:
constexpr int kWideJob = 8;        //   sites per tile and per job
constexpr int kRows = 4;           // S != 4: output rows per job
constexpr int kMaxThreads = 512;   // S != 4: threads per block at most
constexpr int kSmemBlock = 232448; // shared memory one block may use
static_assert(kTileSites % kSites == 0 && kSites % 4 == 0 &&
                  kWideSites % kWideJob == 0 && kWideJob % 4 == 0 &&
                  kRows % 4 == 0,
              "float4 reads over sites and over output rows");

__device__ __forceinline__ float gen_x1(int s, int r) {
  const float base = __fmul_rn((float)s, 1e-4f);
  return __fadd_rn(__fadd_rn(0.1f, base), __fmul_rn((float)r, 0.05f));
}

__device__ __forceinline__ float gen_x2(int s, int r) {
  const float base = __fmul_rn((float)s, 1e-4f);
  return __fadd_rn(__fsub_rn(1.0f, __fmul_rn(base, 0.5f)),
                   __fmul_rn(__fmul_rn((float)r, 0.05f), 0.25f));
}

// One stage for SPT sites at once: out[k][r] = sum_a x[k][a*C + r%C] *
// q[r][a], a = 0..3 in order (plf::stage's arithmetic), each operator row
// read once for the SPT sites.
template <int C, int SPT>
__device__ __forceinline__ void stage_sites(const float (&x)[SPT][plf::S * C],
                                            const float4* k,
                                            float (&out)[SPT][plf::S * C]) {
#pragma unroll
  for (int row = 0; row < plf::S * C; ++row) {
    const int c = row % C;
    const float4 q = k[row];
#pragma unroll
    for (int t = 0; t < SPT; ++t) {
      float v = __fmul_rn(x[t][0 * C + c], q.x);
      v = __fadd_rn(v, __fmul_rn(x[t][1 * C + c], q.y));
      v = __fadd_rn(v, __fmul_rn(x[t][2 * C + c], q.z));
      v = __fadd_rn(v, __fmul_rn(x[t][3 * C + c], q.w));
      out[t][row] = v;
    }
  }
}

// S = 4: a block of kThreads sites, kSites4 sites a thread (sites tid and
// tid + kThreads / kSites4 of the block).
template <int C>
__global__ void __launch_bounds__(kThreads / kSites4)
plf_gen_kernel(const float* lc, const float* rc, const float* ec, float* out,
               int n_sites, int block_sites, int inner_iters) {
  constexpr int R = plf::S * C;
  constexpr int T = kThreads / kSites4;
  __shared__ float4 s_lc[R], s_rc[R], s_ec[R];
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    s_lc[i] = reinterpret_cast<const float4*>(lc)[i];
    s_rc[i] = reinterpret_cast<const float4*>(rc)[i];
    s_ec[i] = reinterpret_cast<const float4*>(ec)[i];
  }
  __syncthreads();
  const int site0 = blockIdx.x * kThreads + threadIdx.x;
  if (site0 >= n_sites) return;
  float x1[kSites4][R], x2[kSites4][R], u1[kSites4][R], u2[kSites4][R];
#pragma unroll
  for (int t = 0; t < kSites4; ++t) {
    const int s = (site0 + t * T) % block_sites;  // past n_sites: unstored
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x1[t][r] = gen_x1(s, r);
      x2[t][r] = gen_x2(s, r);
    }
  }
  float acc[kSites4];
#pragma unroll
  for (int t = 0; t < kSites4; ++t) acc[t] = 0.0f;
#pragma unroll 1
  for (int it = 0; it < inner_iters; ++it) {
#pragma unroll
    for (int t = 0; t < kSites4; ++t)
#pragma unroll
      for (int r = 0; r < R; ++r) asm volatile("" : "+f"(x2[t][r]));
    stage_sites<C, kSites4>(x1, s_lc, u1);
    stage_sites<C, kSites4>(x2, s_rc, u2);
#pragma unroll
    for (int t = 0; t < kSites4; ++t)
#pragma unroll
      for (int r = 0; r < R; ++r) u1[t][r] = __fmul_rn(u1[t][r], u2[t][r]);
    stage_sites<C, kSites4>(u1, s_ec, x1);  // x3, the next iteration's x1
#pragma unroll
    for (int t = 0; t < kSites4; ++t) {
      float s = x1[t][0];
#pragma unroll
      for (int r = 1; r < R; ++r) s = __fadd_rn(s, x1[t][r]);
      acc[t] = __fadd_rn(acc[t], s);
    }
  }
#pragma unroll
  for (int t = 0; t < kSites4; ++t)
    if (site0 + t * T < n_sites) out[site0 + t * T] = acc[t];
}

// ---------------------------------------------------------- S != 4 --

// The launch of the S != 4 kernel: tile sites and sites per job (32 and 4
// with the operators in shared memory, else 64 and 8 where those tiles fit,
// else 32 and 4), threads per block, operator rows padded to a multiple of
// kRows, shared-memory bytes, operators in shared memory.
struct Plan {
  int ts, js, threads, sp, smem, ops_shared;
};

__host__ __device__ inline int jobs_of(int S, int C, int TS, int JS) {
  return C * ((S + kRows - 1) / kRows) * (TS / JS);
}

// Threads: one per stage job in the fewest rounds of at most kMaxThreads,
// and at least one a tile site (the checksum takes one thread a site).
// Returns false where no tile fits a block's shared memory.
bool gen_plan(int S, int C, Plan* p) {
  if (S < 2 || C < 1) return false;
  p->sp = ((S + kRows - 1) / kRows) * kRows;
  const size_t tile = sizeof(float) * 3 * (size_t)S * C;  // a site's 3 rows
  const size_t ops = sizeof(float) * 3 * (size_t)C * S * p->sp;
  p->ops_shared = kTileSites * tile + ops <= (size_t)kSmemBlock / 2;
  if (!p->ops_shared && kWideSites * tile <= (size_t)kSmemBlock) {
    p->ts = kWideSites;
    p->js = kWideJob;
  } else if (kTileSites * tile <= (size_t)kSmemBlock) {
    p->ts = kTileSites;
    p->js = kSites;
  } else {
    return false;
  }
  const int jobs = jobs_of(S, C, p->ts, p->js);
  const int rounds = (jobs + kMaxThreads - 1) / kMaxThreads;
  const int per_round = (jobs + rounds - 1) / rounds;
  p->threads = ((per_round > p->ts ? per_round : p->ts) + 31) / 32 * 32;
  p->smem = (int)(p->ts * tile + (p->ops_shared ? ops : 0));
  return true;
}

template <bool KS>
__device__ __forceinline__ float4 load_k(const float* k, int off) {
  const float4* p = reinterpret_cast<const float4*>(k + off);
  if constexpr (KS) return *p;
  else return __ldg(p);
}

template <int JS>
__device__ __forceinline__ void load_x(const float* src, int off,
                                       float (&x)[JS]) {
#pragma unroll
  for (int i = 0; i < JS; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + off + i);
    x[i] = v.x; x[i + 1] = v.y; x[i + 2] = v.z; x[i + 3] = v.w;
  }
}

template <bool KS>
__device__ __forceinline__ void load_k_rows(const float* k, int off,
                                            float (&kr)[kRows]) {
#pragma unroll
  for (int j = 0; j < kRows; j += 4) {
    const float4 v = load_k<KS>(k, off + j);
    kr[j] = v.x; kr[j + 1] = v.y; kr[j + 2] = v.z; kr[j + 3] = v.w;
  }
}

// acc[j][i] (+)= x[i] * k[j] for every output row j and site i; FIRST: the
// q = 0 term, which starts each sum.
template <bool FIRST, int JS>
__device__ __forceinline__ void mac(const float (&x)[JS],
                                    const float (&k)[kRows],
                                    float (&acc)[kRows][JS]) {
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int i = 0; i < JS; ++i) {
      const float p = __fmul_rn(x[i], k[j]);
      acc[j][i] = FIRST ? p : __fadd_rn(acc[j][i], p);
    }
}

// One stage of one job: acc[j][i] = sum_q src[(q*C+c)*TS + s0+i] *
// K[(o0+j)*C+c][q], q in order, K given as kt[(c*S+q)*Sp + o].
template <bool KS, int TS, int JS>
__device__ __forceinline__ void stage_job(const float* src, const float* kt,
                                          int S, int C, int Sp, int c, int o0,
                                          int s0, float (&acc)[kRows][JS]) {
  float x[JS], k[kRows];
  load_x<JS>(src, c * TS + s0, x);
  load_k_rows<KS>(kt, c * S * Sp + o0, k);
  mac<true, JS>(x, k, acc);
#pragma unroll 4
  for (int q = 1; q < S; ++q) {
    load_x<JS>(src, (q * C + c) * TS + s0, x);
    load_k_rows<KS>(kt, (c * S + q) * Sp + o0, k);
    mac<false, JS>(x, k, acc);
  }
}

// Stage 1 of one job: both branch products, then their product.
template <bool KS, int TS, int JS>
__device__ __forceinline__ void stage1_job(const float* A, const float* B,
                                           const float* lk, const float* rk,
                                           int S, int C, int Sp, int c,
                                           int o0, int s0,
                                           float (&u)[kRows][JS]) {
  float v[kRows][JS];
  float xa[JS], xb[JS], ka[kRows], kb[kRows];
  load_x<JS>(A, c * TS + s0, xa);
  load_x<JS>(B, c * TS + s0, xb);
  load_k_rows<KS>(lk, c * S * Sp + o0, ka);
  load_k_rows<KS>(rk, c * S * Sp + o0, kb);
  mac<true, JS>(xa, ka, u);
  mac<true, JS>(xb, kb, v);
#pragma unroll 2
  for (int q = 1; q < S; ++q) {
    const int src = (q * C + c) * TS + s0;
    const int off = (c * S + q) * Sp + o0;
    load_x<JS>(A, src, xa);
    load_x<JS>(B, src, xb);
    load_k_rows<KS>(lk, off, ka);
    load_k_rows<KS>(rk, off, kb);
    mac<false, JS>(xa, ka, u);
    mac<false, JS>(xb, kb, v);
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int i = 0; i < JS; ++i) u[j][i] = __fmul_rn(u[j][i], v[j][i]);
}

// Store a job's kRows x JS outputs into a [row][site] tile, rows past S
// (operator padding) dropped.
template <int TS, int JS>
__device__ __forceinline__ void store_job(float* dst, int S, int C, int c,
                                          int o0, int s0,
                                          const float (&acc)[kRows][JS]) {
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (o0 + j < S) {
      float* d = dst + ((o0 + j) * C + c) * TS + s0;
#pragma unroll
      for (int i = 0; i < JS; i += 4)
        *reinterpret_cast<float4*>(d + i) =
            make_float4(acc[j][i], acc[j][i + 1], acc[j][i + 2], acc[j][i + 3]);
    }
  }
}

// The row sum of site s of a tile, row 0 first.
template <int TS>
__device__ __forceinline__ float row_sum(const float* A, int rows, int s) {
  float t = A[s];
  for (int r = 1; r < rows; ++r) t = __fadd_rn(t, A[r * TS + s]);
  return t;
}

template <bool KS, int TS, int JS>
__global__ void __launch_bounds__(kMaxThreads)
plf_gen_tile_kernel(const float* kt, float* out, int n_sites,
                    int block_sites, int inner_iters, int S, int C, int Sp) {
  extern __shared__ float4 smem4[];
  const int rows = S * C;
  const int tile = rows * TS;
  const int kn = C * S * Sp;  // floats of one transposed operator
  float* A = reinterpret_cast<float*>(smem4);  // x1, then x3
  float* B = A + tile;                         // x2
  float* P = B + tile;                         // stage-2 products
  const float* lk = kt;
  if constexpr (KS) {
    float4* K = reinterpret_cast<float4*>(P + tile);
    for (int i = threadIdx.x; i < 3 * kn / 4; i += blockDim.x)
      K[i] = __ldg(reinterpret_cast<const float4*>(kt) + i);
    lk = reinterpret_cast<const float*>(K);
  }
  const float* rk = lk + kn;
  const float* ek = rk + kn;
  const int tid = threadIdx.x;
  const int jobs = jobs_of(S, C, TS, JS);
  constexpr int kBlocks = TS / JS;  // site blocks of a tile
  const int n_tiles = (n_sites + TS - 1) / TS;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int site0 = t * TS;
    for (int i = tid; i < tile; i += blockDim.x) {
      const int s = (site0 + i % TS) % block_sites;
      A[i] = gen_x1(s, i / TS);
      B[i] = gen_x2(s, i / TS);
    }
    __syncthreads();  // also: the operators are staged
    float acc = 0.0f;  // site tid's checksum (tid < TS)
    for (int it = 0; it < inner_iters; ++it) {
      if (it > 0 && tid < TS)  // node it-1's x3 is this node's x1
        acc = __fadd_rn(acc, row_sum<TS>(A, rows, tid));
      for (int j = tid; j < jobs; j += blockDim.x) {
        const int sb = j % kBlocks, cj = j / kBlocks;
        const int c = cj % C, o0 = (cj / C) * kRows, s0 = sb * JS;
        float u[kRows][JS];
        stage1_job<KS, TS, JS>(A, B, lk, rk, S, C, Sp, c, o0, s0, u);
        store_job<TS, JS>(P, S, C, c, o0, s0, u);
      }
      __syncthreads();
      for (int j = tid; j < jobs; j += blockDim.x) {
        const int sb = j % kBlocks, cj = j / kBlocks;
        const int c = cj % C, o0 = (cj / C) * kRows, s0 = sb * JS;
        float x3[kRows][JS];
        stage_job<KS, TS, JS>(P, ek, S, C, Sp, c, o0, s0, x3);
        store_job<TS, JS>(A, S, C, c, o0, s0, x3);
      }
      __syncthreads();
    }
    if (tid < TS) {
      if (inner_iters > 0) acc = __fadd_rn(acc, row_sum<TS>(A, rows, tid));
      if (site0 + tid < n_sites) out[site0 + tid] = acc;
    }
    __syncthreads();  // the next tile's x1 and x2 overwrite A and B
  }
}

// Instantiate F<KS, TS, JS>(...) for a plan's three shapes.
#define GEN_DISPATCH(p, ...)                                              \
  do {                                                                    \
    if ((p).ops_shared) {                                                 \
      constexpr bool KS_ = true;                                          \
      constexpr int TS_ = kTileSites, JS_ = kSites;                       \
      __VA_ARGS__;                                                        \
    } else if ((p).ts == kWideSites) {                                    \
      constexpr bool KS_ = false;                                         \
      constexpr int TS_ = kWideSites, JS_ = kWideJob;                     \
      __VA_ARGS__;                                                        \
    } else {                                                              \
      constexpr bool KS_ = false;                                         \
      constexpr int TS_ = kTileSites, JS_ = kSites;                       \
      __VA_ARGS__;                                                        \
    }                                                                     \
  } while (0)

int blocks_per_sm(const Plan& p, int* blocks) {
  GEN_DISPATCH(p, {
    auto kern = plf_gen_tile_kernel<KS_, TS_, JS_>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kern, p.threads, p.smem);
  });
  return (int)cudaErrorInvalidValue;
}

int launch_tile(const float* kt, float* out, int n_sites, int block_sites,
                int inner_iters, int S, int C, const Plan& p,
                cudaStream_t st) {
  int blocks = 0, dev = 0, sms = 0;
  int err = blocks_per_sm(p, &blocks);
  if (err) return err;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  const int n_tiles = (n_sites + p.ts - 1) / p.ts;
  const dim3 grid(n_tiles < blocks * sms ? n_tiles : blocks * sms);
  GEN_DISPATCH(p, plf_gen_tile_kernel<KS_, TS_, JS_>
                      <<<grid, p.threads, p.smem, st>>>(
                          kt, out, n_sites, block_sites, inner_iters, S, C,
                          p.sp));
  return (int)cudaGetLastError();
}

}  // namespace

// The launch plf_gen_launch makes at S != 4: threads per block, sites per
// tile, output rows and sites per job, operator rows padded (Sp), dynamic
// shared memory bytes, operators in shared memory (1) or read from device
// memory (0), resident blocks per SM.  At S = 4: 256 threads of one site,
// sites per tile 256, static shared memory.  Returns cudaErrorInvalidValue
// where the kernel cannot run (the tiles do not fit one block's shared
// memory, or C is outside 1..8 at S = 4).  At S = 4 the kSites4 sites of a
// thread are its job sites.
extern "C" int plf_gen_plan(int states, int categories, int* threads,
                            int* tile_sites, int* job_rows, int* job_sites,
                            int* sp, int* smem_bytes, int* ops_shared,
                            int* blocks) {
  if (states == plf::S) {
    if (categories < 1 || categories > 8) return (int)cudaErrorInvalidValue;
    *threads = kThreads / kSites4;
    *tile_sites = kThreads;
    *job_rows = plf::S * categories;
    *job_sites = kSites4;
    *sp = plf::S;
    *smem_bytes = 0;
    *ops_shared = 1;
    int err = 0;
    PLF_DISPATCH_C(categories,
                   err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       blocks, plf_gen_kernel<C_>, kThreads / kSites4, 0));
    return err;
  }
  Plan p;
  if (!gen_plan(states, categories, &p)) return (int)cudaErrorInvalidValue;
  *threads = p.threads;
  *tile_sites = p.ts;
  *job_rows = kRows;
  *job_sites = p.js;
  *sp = p.sp;
  *smem_bytes = p.smem;
  *ops_shared = p.ops_shared;
  return blocks_per_sm(p, blocks);
}

// S = 4: lc, rc, ec: (S*C, S) fp32 lane constants, 16-byte aligned.  S != 4:
// lc holds the three operators transposed and padded, (3, C, S, Sp) fp32
// (ops/plf_node.py::gen_operators), 16-byte aligned; rc and ec are unread.
// out: (n_sites,) fp32, n_sites = n_blocks * block_sites.  Returns
// cudaGetLastError() after the launch.
extern "C" int plf_gen_launch(const float* lc, const float* rc,
                              const float* ec, float* out, int n_sites,
                              int block_sites, int inner_iters, int states,
                              int categories, void* stream) {
  if (n_sites <= 0 || block_sites <= 0 || inner_iters < 0 || states < 2 ||
      categories < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (states == plf::S) {
    const dim3 grid((n_sites + kThreads - 1) / kThreads);
    PLF_DISPATCH_C(categories,
                   plf_gen_kernel<C_><<<grid, kThreads / kSites4, 0, st>>>(
                       lc, rc, ec, out, n_sites, block_sites, inner_iters));
    return (int)cudaGetLastError();
  }
  Plan p;
  if (!gen_plan(states, categories, &p)) return (int)cudaErrorInvalidValue;
  return launch_tile(lc, out, n_sites, block_sites, inner_iters, states,
                     categories, p, st);
}
