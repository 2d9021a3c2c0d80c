// Hopper (sm_90a) Mamba2 SSD chunked scan, with a plain C interface.
//
// It replaces the Pallas kernel of src/repro/kernels/ssd_scan.py:
//   ssd_scan  <- ssd_scan_call (ssd_scan.py:80), body _ssd_body (:36)
//
// For each (batch, head) the sequence is cut into chunks; within a chunk the
// recurrence h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t is
// computed as small matrix products, and only the (P x N) float32 state is
// carried from one chunk to the next:
//   cum   = cumsum(A dt)                                   (log decay, <= 0)
//   G     = (C B^T) o L o dt,   L[t,u] = exp(cum_t - cum_u) for t >= u, else 0
//   y     = G x + (C o exp(cum)) h^T
//   h    <- exp(cum_last) h + x^T (B o exp(cum_last - cum) dt)
// All arithmetic is float32 after the inputs are widened, as in the Pallas
// body.  exp(cum_t - cum_u) is formed only for t >= u: above the diagonal
// the exponent is positive and reaches hundreds at chunk 128, and a 0/1 mask
// multiplied after the exp would turn inf * 0 into NaN.
//
// Three kernels, one rule (the wrapper's route, kernels/ssd_scan.py:route):
// bf16 x, B and C at P 64, N 128 and chunk 128 -- the served mamba2 shapes
// -- run ssd_wgmma_kernel on the tensor cores; bf16 at P 64, N 16 and chunk
// 128 -- hymba's -- run ssd_wgmma_n16_kernel (namespace n16, at the end);
// float32, and every other shape, run ssd_scan_kernel on CUDA cores.  The
// backward has the same three routes (bwd_route).
//
// ssd_scan_kernel (CUDA cores).  Per chunk of 128 rows at P = 64, N = 128
// the four products need ~7.4 MFLOP (C B^T and G x over the causal
// triangle only) against ~50 KB of input, so in float32 outside the tensor
// cores it is bound by operations, not by bytes.  Plain float32 FMA:
//   * one CTA of 256 threads per (head, batch) walks the chunks in order --
//     the sequential grid axis of the TPU kernel becomes a loop, and the
//     state h stays in shared memory for the whole sequence;
//   * a chunk's x, B (all rows) and C (one 32-row tile at a time) are staged
//     in shared memory in the input dtype, h and a 32-row tile of G in
//     float32.  At chunk 128, P 64, N 128 that is 108 KB for bf16 inputs
//     (two CTAs an SM) and 165 KB for float32;
//   * G is built one 32-row tile at a time, only for columns u below the
//     tile's end (causal: 10/16 of the full C B^T at four tiles), and each
//     tile's y rows are finished before the next tile overwrites it;
//   * each thread keeps a 4x4 (G), 4x2 (y) or 8x4 (h) register tile; shared
//     rows that lanes read across are padded to an odd word stride.
//
// ssd_wgmma_kernel (tensor cores) is the chunked "state passing" form of
// arXiv 2405.21060: chunk outputs and chunk-end increments are computed in
// parallel, then the states are combined across chunks.  With bf16 inputs
// every product of the chunk is exact in float32, which is what wgmma does;
// so at the served shapes (B 4, S 512, H 80) the call is bound by its ~64.6
// MB of bytes (19.3 us at 3.35 TB/s), not by its 9.42 GFLOP (9.5 us at 989
// TFLOP/s).  Its design:
//   * one CTA of two warpgroups per chunk; the CTAs of a (batch, head) form
//     a thread-block cluster along the chunk axis, and a sequence of more
//     chunks than the cluster holds walks it over groups of chunks;
//   * one thread loads the chunk's x (128 x 64), B and C (128 x 128 each)
//     with TMA into 128-byte-swizzled boxes of 64 columns x 128 rows: 80 KB
//     of shared memory, two CTAs an SM.  Rows past S are zero-filled, and
//     dt is read as 0 there, which is the reference's call padded with dt 0;
//   * warpgroup w owns rows 64 w .. 64 w + 63 of the chunk.  For each
//     causal 32-column slice (2 or 4): S = C B^T on wgmma (both operands from
//     shared memory), G = S o L o dt in registers with exp(cum_t - cum_u)
//     taken only where t >= u and 0 selected elsewhere, then y_intra += G x
//     on wgmma with G from registers (as flash's P V).  Slices of 32 keep
//     the live accumulators within the 128 registers two CTAs an SM allow;
//   * warpgroup w also forms columns 64 w .. 64 w + 63 of the chunk-end
//     increment h_inc = (x o w)^T B (w_u = exp(cum_last - cum_u) dt_u) on
//     wgmma, (x o w)^T from registers (x^T's fragments by ldmatrix.trans)
//     and B from shared memory, and publishes h_inc in its B boxes;
//   * one cluster barrier, then each CTA forms its incoming state by prefix
//     combination, h_{c-1} = (prod d) carry + sum_j (prod d) h_inc_j, reading
//     the earlier ranks' increments through distributed shared memory (d_i
//     = exp(cum_last_i); carry is init_state, or the previous group's last
//     state in hout).  No CTA waits for another's result: a chain that
//     passed h from CTA to CTA, one cluster barrier a step, took most of
//     the kernel's time.  A second barrier frees the B boxes, and the CTA
//     of a group's last chunk writes h_c = d_c h_{c-1} + h_inc_c to hout;
//   * y_state = (C h_{c-1}^T) o exp(cum_t) on wgmma, C from shared memory and
//     h_{c-1} as bf16 parts; y = y_intra + y_state goes through shared
//     memory to one TMA store, which leaves out rows past S.
// The float32 state is carried in float32; only the copies of G, x o w and
// h that feed a wgmma are cut into bf16 parts (each part rounds what the
// ones before left).  How many parts each takes is a template argument,
// measured by scripts/ssd_scan_times.py against the checks' bounds; the
// wrapper's PARTS and cluster size are the served choice.
//
// Both kernels give the last, short chunk min(chunk, S - c0) rows: the y
// and final h of the reference's call padded with dt = 0.  x, B and C are
// read through strides (x is a slice of the conv output); y is written
// contiguous [B, S, H, P], h0 / h as [B, H, P, N].  Nothing is allocated;
// the kernels run on the caller's stream and each entry point returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 32;      // rows of a G / y tile (one per lane)
constexpr int kMaxChunk = 128;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Args {
  const void* x;    // [B, S, H, P], strides x_sb, x_ss, x_sh, 1
  const float* dt;  // [B, S, H],    strides dt_sb, dt_ss, 1
  const float* A;   // [H]
  const void* Bm;   // [B, S, G, N], strides b_sb, b_ss, b_sg, 1
  const void* C;    // [B, S, G, N], strides c_sb, c_ss, c_sg, 1
  const float* h0;  // [B, H, P, N] or null (zero state)
  void* y;          // [B, S, H, P], contiguous
  float* hout;      // [B, H, P, N], contiguous
  int S, H, P, G, N, chunk;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

// Row stride (in elements of T) for rows that 32 lanes read down a column:
// an odd number of 4-byte words, so the lanes fall on 32 distinct banks.
template <typename T>
__host__ __device__ constexpr int odd_words_ld(int n) {
  const int per_word = 4 / static_cast<int>(sizeof(T));
  const int words = (n + per_word - 1) / per_word;
  return (words | 1) * per_word;
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared-memory layout of one CTA, in bytes from the dynamic base.
template <typename T>
struct Layout {
  int ldh, ldb;
  size_t h, g, vec, x, b, c, total;
  __host__ __device__ Layout(int chunk, int P, int N) {
    ldh = odd_words_ld<float>(N);
    ldb = odd_words_ld<T>(N);
    h = 0;                                                        // float [P][ldh]
    g = align16(h + sizeof(float) * P * ldh);                     // float [kRows][chunk]
    vec = align16(g + sizeof(float) * kRows * chunk);             // float [4][chunk]
    x = align16(vec + sizeof(float) * 4 * chunk);                 // T [chunk][P]
    b = align16(x + sizeof(T) * chunk * P);                       // T [chunk][ldb]
    c = align16(b + sizeof(T) * chunk * ldb);                     // T [kRows][N]
    total = align16(c + sizeof(T) * kRows * N);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = a.P, N = a.N, S = a.S, chunk = a.chunk;
  const Layout<T> lay(chunk, P, N);
  float* hs = reinterpret_cast<float*>(smem + lay.h);
  float* gs = reinterpret_cast<float*>(smem + lay.g);
  float* dts = reinterpret_cast<float*>(smem + lay.vec);
  float* cum = dts + chunk;
  float* ecum = cum + chunk;  // exp(cum_t)
  float* wts = ecum + chunk;  // exp(cum_last - cum_u) * dt_u
  T* xs = reinterpret_cast<T*>(smem + lay.x);
  T* bs = reinterpret_cast<T*>(smem + lay.b);
  T* cs = reinterpret_cast<T*>(smem + lay.c);
  const int ldh = lay.ldh, ldb = lay.ldb;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x, lane = tid & 31, wy = tid >> 5;
  const float A = a.A[h];

  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const float* dtg = a.dt + b * a.dt_sb + h;
  const T* bg = static_cast<const T*>(a.Bm) + b * a.b_sb + g * a.b_sg;
  const T* cg = static_cast<const T*>(a.C) + b * a.c_sb + g * a.c_sg;
  const size_t state0 = (static_cast<size_t>(b) * a.H + h) * P * N;

  for (int i = tid; i < P * N; i += kThreads) {
    hs[(i / N) * ldh + i % N] = a.h0 ? a.h0[state0 + i] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int len = min(chunk, S - c0);
    __syncthreads();  // the previous chunk's state update is done with xs, bs
    for (int t = tid; t < len; t += kThreads) dts[t] = dtg[(c0 + t) * a.dt_ss];
    for (int i = tid; i < len * P; i += kThreads) {
      const int t = i / P, p = i % P;
      xs[t * P + p] = xg[(c0 + t) * a.x_ss + p];
    }
    for (int i = tid; i < len * N; i += kThreads) {
      const int t = i / N, n = i % N;
      bs[t * ldb + n] = bg[(c0 + t) * a.b_ss + n];
    }
    __syncthreads();

    // cum = inclusive cumsum of A dt over the chunk: warp 0, four rows a lane
    if (wy == 0) {
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * lane + k;
        run += t < len ? A * dts[t] : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += o;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) before = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * lane + k;
        if (t < len) cum[t] = before + v[k];
      }
    }
    __syncthreads();
    const float cum_last = cum[len - 1];
    for (int t = tid; t < len; t += kThreads) {
      ecum[t] = expf(cum[t]);
      wts[t] = expf(cum_last - cum[t]) * dts[t];
    }

    // y, one tile of kRows rows at a time
    for (int r0 = 0; r0 < len; r0 += kRows) {
      const int rows = min(kRows, len - r0);
      const int cols = r0 + rows;  // G[t, u] is zero for u > t
      __syncthreads();  // the previous tile is done with cs, gs; ecum/wts written
      for (int i = tid; i < rows * N; i += kThreads) {
        const int t = i / N, n = i % N;
        cs[t * N + n] = cg[(c0 + r0 + t) * a.c_ss + n];
      }
      __syncthreads();

      // G tile: rows r0 + 4 wy + i, columns u = lane + 32 j (u < cols)
      {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        const int nj = (cols + 31) / 32;  // uniform over the CTA
        for (int n = 0; n < N; ++n) {
          float cr[4], bu[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cr[i] = to_float(cs[(4 * wy + i) * N + n]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int u = lane + 32 * j;
            bu[j] = (j < nj && u < len) ? to_float(bs[u * ldb + n]) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cr[i], bu[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = 4 * wy + i, t = r0 + rr;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int u = lane + 32 * j;
            if (u >= cols) continue;
            float v = 0.f;
            if (t < len && u <= t) v = acc[i][j] * expf(cum[t] - cum[u]) * dts[u];
            gs[rr * chunk + u] = v;
          }
        }
      }
      __syncthreads();

      // y rows: G x + exp(cum_t) (C h^T); columns p = lane + 32 j
      {
        float yi[4][2], ys[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) yi[i][j] = ys[i][j] = 0.f;
        for (int u = 0; u < cols; ++u) {
          float gr[4], xu[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) gr[i] = gs[(4 * wy + i) * chunk + u];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = lane + 32 * j;
            xu[j] = p < P ? to_float(xs[u * P + p]) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) yi[i][j] = fmaf(gr[i], xu[j], yi[i][j]);
        }
        for (int n = 0; n < N; ++n) {
          float cr[4], hp[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) cr[i] = to_float(cs[(4 * wy + i) * N + n]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = lane + 32 * j;
            hp[j] = p < P ? hs[p * ldh + n] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) ys[i][j] = fmaf(cr[i], hp[j], ys[i][j]);
        }
        T* yg = static_cast<T*>(a.y);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = r0 + 4 * wy + i;
          if (t >= len) continue;
          const size_t row = ((static_cast<size_t>(b) * S + c0 + t) * a.H + h) * P;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = lane + 32 * j;
            if (p < P) yg[row + p] = from_float<T>(yi[i][j] + ecum[t] * ys[i][j]);
          }
        }
      }
    }
    __syncthreads();  // every y row has read the old state

    // h <- exp(cum_last) h + x^T (B o w); rows p = wy + 8 i, columns n = lane + 32 j
    {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int u = 0; u < len; ++u) {
        const float w = wts[u];
        float bw[4], xp[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = lane + 32 * j;
          bw[j] = n < N ? to_float(bs[u * ldb + n]) * w : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int p = wy + 8 * i;
          xp[i] = p < P ? to_float(xs[u * P + p]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xp[i], bw[j], acc[i][j]);
      }
      const float decay = expf(cum_last);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = wy + 8 * i;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = lane + 32 * j;
          if (n < N) hs[p * ldh + n] = decay * hs[p * ldh + n] + acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) a.hout[state0 + i] = hs[(i / N) * ldh + i % N];
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t bytes = Layout<T>(a.chunk, a.P, a.N).total;
  static size_t granted = 48 * 1024;  // dynamic shared memory allowed so far
  if (bytes > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    granted = bytes;
  }
  ssd_scan_kernel<T><<<dim3(a.H, batch), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor-core route: bf16 x, B and C at P 64, N 128, chunk 128
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kL = 128;            // rows of a chunk
constexpr int kP = 64;             // head dim
constexpr int kN = 128;            // state dim
constexpr int kThreads = 256;      // two warpgroups
constexpr int kMaxCluster = 8;
constexpr int kBox = 64 * kL * 2;  // a TMA box: 64 bf16 columns (128 bytes) x 128 rows
constexpr int kHalf = kBox / 2;    // 64 rows of a box
// Shared memory, in bytes from a 1024-aligned base (128-byte swizzle
// repeats every 1024 bytes).  After the chunk's products, B's boxes hold
// the CTA's h_inc (float32, 32 KB, in its threads' register order) for the
// later ranks of the cluster to read; then x's box and B's take h_{c-1} as
// bf16 parts for y_state, each part two boxes (N columns 0-63, 64-127) of
// 64 p rows; and C's first box takes y for its store.
constexpr int kOffC = 0;           // C: boxes of N columns 0-63 and 64-127
constexpr int kOffB = 2 * kBox;    // B: the same
constexpr int kOffX = 4 * kBox;    // x
constexpr int kOffVec = 5 * kBox;  // float cum, dt, exp(cum), w: kL each
constexpr int kOffBar = kOffVec + 4 * kL * 4;  // the loads' mbarrier, then cum_last
constexpr int kSmem = kOffBar + 16 + 1024;    // + the base's alignment

__host__ __device__ constexpr int part_offset(int part) {
  return part == 0 ? kOffX : kOffB + (part - 1) * kBox;
}

struct Params {
  CUtensorMap tx, tb, tc;  // (64 or 128, S, H or G, B) bf16; boxes of 64 x 128 x 1 x 1
  CUtensorMap ty;          // y's (64, S, H, B), the same boxes
  const float* dt;         // [B, S, H], strides dt_sb, dt_ss, 1
  const float* A;          // [H]
  const float* h0;         // [B, H, P, N] or null (zero state)
  float* hout;             // [B, H, P, N], contiguous; also the carry between groups
  long long dt_sb, dt_ss;
  int S, H, G, chunks, groups;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64 x 128 box of a 4-D tensor map at (col, s, h, b) into shared memory.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst, uint64_t* bar,
                                         int col, int s, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(s), "r"(h),
      "r"(b)
      : "memory");
}

// Order this thread's generic-proxy accesses of shared memory before later
// async-proxy ones (wgmma operand reads, TMA writes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Every thread of every CTA of the cluster: writes before it (shared and
// global) are seen by reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of the same shared-memory location in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout 1 = 128B swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

// The same for a tile in the 32-byte swizzle (layout 3): rows of 16 bf16
// (32 bytes), 8-row atoms of 256 bytes.
__device__ __forceinline__ uint64_t desc32(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(3) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {  // all but the last group
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads and writes across the
// asynchronous products (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define TC_D8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define TC_D32(i) TC_D8(i), TC_D8(i + 8), TC_D8(i + 16), TC_D8(i + 24)

// d[32] += A (64 x 16, K-major, shared) * B (16 x 64, K-major, shared)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TC_D32(0)
      : "l"(a), "l"(b), "r"(1));
}

// d[16] += A (64 x 16, K-major, shared) * B (16 x 32, K-major, shared)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : TC_D8(0), TC_D8(8)
      : "l"(a), "l"(b), "r"(1));
}

// d[32] += A (64 x 16, K-major, shared) * B (16 x 64, MN-major, shared)
__device__ __forceinline__ void wgmma_ss_n64_tb(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : TC_D32(0)
      : "l"(a), "l"(b), "r"(1));
}

// d[32] += A (64 x 16, bf16 registers) * B (16 x 64, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TC_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[8] += A (64 x 16, bf16 registers) * B (16 x 16, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : TC_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[8] += A (64 x 16, K-major, shared) * B (16 x 16, MN-major, shared)
__device__ __forceinline__ void wgmma_ss_n16_tb(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : TC_D8(0)
      : "l"(a), "l"(b), "r"(1));
}

#undef TC_D32
#undef TC_D8

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives
// the address of row l % 8 of matrix l / 8, and register i receives, of
// matrix i, the pair (rows 2 (l % 4) and 2 (l % 4) + 1, column l / 4).
__device__ __forceinline__ void ldmatrix_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// One 64 x 128 box of shared memory to a 4-D tensor map at (col, s, h, b);
// rows past the map's S are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int col,
                                          int s, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(s), "r"(h), "r"(b)
      : "memory");
}
// Wait until the stores issued so far have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The bf16 pair (a, b) as one wgmma register, and what its rounding left in
// a and b (exact): called once a part.
__device__ __forceinline__ uint32_t take_part(float& a, float& b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(v);
  a -= f.x;
  b -= f.y;
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of element (row, col < 64) in a 128-byte-swizzled bf16 box,
// as TMA lays it out.
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) << 1));
}

// Byte offset of element (row, col < 16) in a 32-byte-swizzled bf16 tile
// (rows of 32 bytes), as TMA lays it out: the two 16-byte halves of a row
// swap in rows 4-7 of every 8.
__device__ __forceinline__ int swizzled32(int row, int col) {
  return row * 32 + ((((col >> 3) ^ ((row >> 2) & 1)) << 4) | ((col & 7) << 1));
}

// cum = inclusive cumsum of A dt over the chunk: one warp, four rows a lane.
__device__ __forceinline__ void chunk_cumsum(float* cum, const float* dts, float A, int lane) {
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    run += A * dts[4 * lane + k];
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) cum[4 * lane + k] = before + v[k];
}

// yi += G x over the 64 x 32 slice of rows 64 wg.. and columns v0 = 32 k..
// of the chunk: S = C B^T on wgmma, G = S o L o dt in registers, then G
// (NP bf16 parts, from registers) times x's rows v0.. (MN-major, shared).
// Slices of 32 columns keep S and G's fragments to 16 registers each.  NS:
// the state width, 128 (C and B in two 128-byte-swizzled boxes, 8 k-steps)
// or 16 (one 32-byte-swizzled box each, one k-step).
template <int NP, int NS = kN>
__device__ __forceinline__ void intra_slice(float (&yi)[32], uint32_t sC, uint32_t sB,
                                            uint32_t sX, const float* cum, const float* dts,
                                            int wg, int v0, int r0, int c0) {
  float s[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = 0.f;
  fence_regs(s);
  wgmma_fence();
  if constexpr (NS == 16) {
    wgmma_ss_n32(s, desc32(sC + wg * 64 * 32, 16, 256), desc32(sB + v0 * 32, 16, 256));
  } else {
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_ss_n32(s, desc(sC + off + wg * kHalf, 16, 1024), desc(sB + off + v0 * 128, 16, 1024));
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);

  // exp(cum_t - cum_u) only where t >= u; 0 is selected elsewhere
  const int t0 = wg * 64 + r0;
  const float ct[2] = {cum[t0], cum[t0 + 8]};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int t = t0 + 8 * ((j / 2) % 2);
    const int u = v0 + 8 * (j / 4) + c0 + (j % 2);
    s[j] = u <= t ? s[j] * expf(ct[(j / 2) % 2] - cum[u]) * dts[u] : 0.f;
  }
  // step ks covers columns v0 + 16 ks .. v0 + 16 ks + 15
  uint32_t ga[NP][2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float a = s[8 * ks + 2 * r], b = s[8 * ks + 2 * r + 1];
#pragma unroll
      for (int part = 0; part < NP; ++part) ga[part][ks][r] = take_part(a, b);
    }
  fence_regs(yi);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const uint64_t xd = desc(sX + (v0 + 16 * ks) * 128, kHalf, 1024);
#pragma unroll
    for (int part = 0; part < NP; ++part) wgmma_rs_n64(yi, ga[part][ks], xd);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(yi);
}

// hi = columns 64 wg .. 64 wg + 63 of the chunk-end increment (x o w)^T B:
// rows p, summed over the chunk's rows u.  x o w goes
// to wgmma from registers in NP bf16 parts, x^T's fragments read from its
// swizzled box by ldmatrix.trans; B from shared memory as an MN-major
// operand.  With R = 8 it forms the whole 64 x 16 increment of a state
// of width 16 (B in one 32-byte-swizzled box; wg unused).
template <int NP, int R>
__device__ __forceinline__ void chunk_increment(float (&hi)[R], uint32_t sB, uint32_t sX,
                                                const float* wts, int wg, int c0) {
  static_assert(R == 32 || R == 8, "an n64 or n16 accumulator");
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  // this lane's row of the ldmatrix: u = 16 ks + 8 (m / 2) + lane % 8 of
  // matrix m = lane / 8, columns p = 16 warp + 8 (m % 2) ..
  const int m = lane / 8;
  const int lu = 8 * (m / 2) + lane % 8, lp = 16 * warp + 8 * (m % 2);
#pragma unroll
  for (int j = 0; j < R; ++j) hi[j] = 0.f;
  // one k-step at a time, its fragments double-buffered: the products of
  // step ks run while step ks + 1's fragments are built
  uint32_t wa[2][NP][4];
  fence_regs(hi);
#pragma unroll
  for (int ks = 0; ks < kL / 16; ++ks) {
    uint32_t xr[4];
    ldmatrix_t(xr, sX + swizzled(16 * ks + lu, lp));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int u = 16 * ks + c0 + 8 * (r / 2);  // columns u, u + 1
      const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[r]));
      const float2 w2 = *reinterpret_cast<const float2*>(wts + u);
      float a = x2.x * w2.x, b = x2.y * w2.y;
#pragma unroll
      for (int part = 0; part < NP; ++part) wa[ks % 2][part][r] = take_part(a, b);
    }
    wgmma_fence();
    if constexpr (R == 8) {
      const uint64_t bd = desc32(sB + ks * 16 * 32, 256, 256);
#pragma unroll
      for (int part = 0; part < NP; ++part) wgmma_rs_n16(hi, wa[ks % 2][part], bd);
    } else {
      const uint64_t bd = desc(sB + wg * kBox + ks * 16 * 128, kHalf, 1024);
#pragma unroll
      for (int part = 0; part < NP; ++part) wgmma_rs_n64(hi, wa[ks % 2][part], bd);
    }
    wgmma_commit();
    wgmma_wait_one();
  }
  wgmma_wait_all();
  fence_regs(hi);
}

// PG, PW, PH: bf16 parts of G, x o w and h_{c-1}.
template <int PG, int PW, int PH>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_wgmma_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* cum = reinterpret_cast<float*>(sm + kOffVec);
  float* dts = cum + kL;
  float* ecum = dts + kL;  // exp(cum_t)
  float* wts = ecum + kL;  // exp(cum_last - cum_u) dt_u
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kOffBar);
  float* clast = reinterpret_cast<float*>(sm + kOffBar + 8);  // cum_last, for the cluster
  const uint32_t sC = smem_u32(sm + kOffC), sB = smem_u32(sm + kOffB), sX = smem_u32(sm + kOffX);

  const int rank = blockIdx.x, K = gridDim.x;  // the cluster spans grid x
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, wg = tid / 128;
  // wgmma's accumulator layout: this thread holds rows r0 and r0 + 8 of its
  // warpgroup's 64 and, in each 8-column chunk j, columns 8 j + c0 and
  // 8 j + c0 + 1
  const int r0 = ((tid % 128) / 32) * 16 + (tid % 32) / 4, c0 = 2 * (tid % 4);
  const float A = p.A[h];
  const size_t state0 = (static_cast<size_t>(b) * p.H + h) * kP * kN;
  // element (p, n) of a [P, N] state that accumulator pair q of this thread holds
  auto at = [&](int q) { return (r0 + 8 * (q % 2)) * kN + wg * 64 + 8 * (q / 2) + c0; };

  if (tid == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  for (int grp = 0; grp < p.groups; ++grp) {
    const int c = grp * K + rank;
    const bool active = c < p.chunks;  // uniform over the CTA
    const int row0 = c * kL;
    const int len = active ? min(kL, p.S - row0) : 0;
    float yi[32], hp[32];
    if (active) {
      if (tid == 0) {
        tma_store_wait_read();  // the previous group's y has left C's box
        mbar_expect_tx(full, 5 * kBox);
        tma_load(&p.tc, sm + kOffC, full, 0, row0, g, b);
        tma_load(&p.tc, sm + kOffC + kBox, full, 64, row0, g, b);
        tma_load(&p.tb, sm + kOffB, full, 0, row0, g, b);
        tma_load(&p.tb, sm + kOffB + kBox, full, 64, row0, g, b);
        tma_load(&p.tx, sm + kOffX, full, 0, row0, h, b);
      }
      const float* dtg = p.dt + b * p.dt_sb + h;
      for (int t = tid; t < kL; t += kThreads) dts[t] = t < len ? dtg[(row0 + t) * p.dt_ss] : 0.f;
      __syncthreads();
      if (tid < 32) chunk_cumsum(cum, dts, A, tid);
      __syncthreads();
      const float cum_last = cum[kL - 1];
      for (int t = tid; t < kL; t += kThreads) {
        ecum[t] = expf(cum[t]);
        wts[t] = expf(cum_last - cum[t]) * dts[t];
      }
      __syncthreads();
      mbar_wait(full, grp & 1);

#pragma unroll
      for (int j = 0; j < 32; ++j) yi[j] = 0.f;
      // the causal 32-column slices of the warpgroup's rows: 2 or 4
      for (int k = 0; k < 2 * (wg + 1); ++k)
        intra_slice<PG>(yi, sC, sB, sX, cum, dts, wg, 32 * k, r0, c0);
      float hi[32];
      chunk_increment<PW>(hi, sB, sX, wts, wg, c0);
      // publish h_inc in this CTA's B boxes, in the threads' order (float4 q
      // of thread t at 16 (256 q + t) bytes), and cum_last beside it
      __syncthreads();  // both warpgroups are done reading B
      float4* mine = reinterpret_cast<float4*>(sm + kOffB);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        mine[q * kThreads + tid] = make_float4(hi[4 * q], hi[4 * q + 1], hi[4 * q + 2],
                                               hi[4 * q + 3]);
      if (tid == 0) *clast = cum_last;
    }
    cluster_sync();  // every increment of the group is published

    // The states, by prefix combination: with d_i = exp(cum_last_i),
    //   h_{c-1} = (prod_{i<r} d_i) carry + sum_{j<r} (prod_{j<i<r} d_i) h_inc_j
    // over the ranks i, j < r of the group; carry is init_state (or zeros)
    // for the first group, else the previous group's last state in hout.
    // A thread reads the 32 elements it holds of each earlier rank's
    // increment through distributed shared memory, each product of decays
    // taken as exp of a sum of cum_last; no CTA waits for another's result.
    if (active) {
#pragma unroll
      for (int j = 0; j < 32; ++j) hp[j] = 0.f;
      float run = 0.f;  // sum of cum_last_i over j < i < r
      for (int j = rank - 1; j >= 0; --j) {
        const float e = expf(run);
        const uint32_t inc = map_rank(sB, j);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 v = ld_cluster4(inc + 16 * (q * kThreads + tid));
          hp[4 * q] = fmaf(e, v.x, hp[4 * q]);
          hp[4 * q + 1] = fmaf(e, v.y, hp[4 * q + 1]);
          hp[4 * q + 2] = fmaf(e, v.z, hp[4 * q + 2]);
          hp[4 * q + 3] = fmaf(e, v.w, hp[4 * q + 3]);
        }
        run += ld_cluster(map_rank(smem_u32(clast), j));
      }
      const float* carry = grp == 0 ? p.h0 : p.hout;
      if (carry != nullptr) {
        const float e = expf(run);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(carry + state0 + at(q)));
          hp[2 * q] = fmaf(e, v.x, hp[2 * q]);
          hp[2 * q + 1] = fmaf(e, v.y, hp[2 * q + 1]);
        }
      }
    }
    cluster_sync();  // every read of the group's increments and carry is done

    if (active) {
      // the end of the sequence or of the group: h_c = d_c h_{c-1} + h_inc_c
      // to hout (the final state, or the next group's carry)
      if (c == p.chunks - 1 || rank == K - 1) {
        const float decay = expf(cum[kL - 1]);
        const float* mine = reinterpret_cast<const float*>(sm + kOffB);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int j = 2 * q, o = 4 * ((j / 4) * kThreads + tid) + j % 4;
          __stcg(reinterpret_cast<float2*>(p.hout + state0 + at(q)),
                 make_float2(fmaf(decay, hp[j], mine[o]), fmaf(decay, hp[j + 1], mine[o + 1])));
        }
      }
      __syncthreads();  // B's boxes are free for h's parts
      // h_{c-1} in PH bf16 parts, laid out as B^T's K-major boxes:
      // (N column box, p row, n) swizzled as TMA would
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int off = wg * kHalf + swizzled(r0 + 8 * (q % 2), 8 * (q / 2) + c0);
        float a = hp[2 * q], b2 = hp[2 * q + 1];
#pragma unroll
        for (int part = 0; part < PH; ++part)
          *reinterpret_cast<uint32_t*>(sm + part_offset(part) + off) = take_part(a, b2);
      }
      fence_proxy_async();  // the parts are read by wgmma
    }
    __syncthreads();
    if (active) {
      // y_state = (C h_{c-1}^T) o exp(cum_t), and y = y_intra + y_state
      float ys[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) ys[j] = 0.f;
      fence_regs(ys);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < PH; ++part) {
        const uint32_t hb = smem_u32(sm + part_offset(part));
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          wgmma_ss_n64(ys, desc(sC + (kk / 4) * kBox + wg * kHalf + (kk % 4) * 32, 16, 1024),
                       desc(hb + (kk / 4) * kHalf + (kk % 4) * 32, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(ys);
      // y through C's first box (free once both warpgroups' products are
      // done) to one TMA store, which leaves out rows past S
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int t = wg * 64 + r0 + 8 * (q % 2);
        const float e = ecum[t];
        *reinterpret_cast<__nv_bfloat162*>(sm + kOffC + swizzled(t, 8 * (q / 2) + c0)) =
            __floats2bfloat162_rn(fmaf(e, ys[2 * q], yi[2 * q]),
                                  fmaf(e, ys[2 * q + 1], yi[2 * q + 1]));
      }
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) tma_store(&p.ty, sm + kOffC, 0, row0, h, b);
    }
    fence_proxy_async();
    __syncthreads();  // shared memory is free for the next group's loads
  }
  if (tid == 0) tma_store_wait();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query, so that the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over (cols, S, H, B) of a bf16 tensor with element strides
// (s, h, b), boxes of 64 columns x 128 rows in the 128-byte swizzle; at 16
// columns (N 16), boxes of the 16 columns (32-byte rows) in the 32-byte
// swizzle.  Rows past S read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int cols, int S, int H, int B, long long ss,
            long long sh, long long sb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const bool narrow = cols == 16;
  const cuuint32_t box[4] = {narrow ? 16u : 64u, kL, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            narrow ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A kernel of kThreads-thread CTAs on a (cluster, H, B) grid, the cluster
// along x, with `smem` bytes of dynamic shared memory (the caller has
// allowed them).
template <typename P>
cudaError_t launch_clusters(void (*kernel)(P), const P& p, int smem, int cluster, int H, int B,
                            cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int PG, int PW, int PH>
cudaError_t launch(const Params& p, int cluster, int B, cudaStream_t s) {
  auto kernel = ssd_wgmma_kernel<PG, PW, PH>;
  static const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (set != cudaSuccess) return set;
  return launch_clusters(kernel, p, kSmem, cluster, p.H, B, s);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The backward: ssd_bwd_kernel (CUDA cores), then ssd_bwd_group_sum and
// ssd_bwd_batch_sum.
//
// No Pallas kernel to replace: the reference differentiates the plain scan
// kref.ssd_scan through a custom_vjp (src/repro/models/ssm.py:46-49).  Given
// dy [B,S,H,P] and dh_last [B,H,P,N] (either may be absent: zero) it returns
// dx, ddt, dA, dB, dC and dh0 of (y, h_last) = scan(x, dt, A, B, C, h0).
//
// One CTA of 512 threads per (head, batch), float32 throughout.  The
// sequence is cut into sub-chunks of kBL = 32 rows (the backward's own cut:
// the gradient does not depend on the forward's chunk).  In a sub-chunk with
// start state H0, cum_t = sum_{r<=t} A dt_r, L[t,s] = exp(cum_t - cum_s) for
// s <= t (never formed above the diagonal) and wend_s = exp(cum_last - cum_s):
//   y_t   = exp(cum_t) H0 C_t + sum_{s<=t} L[t,s] dt_s (C_t.B_s) x_s
//   h_end = exp(cum_last) H0 + sum_s wend_s dt_s x_s B_s^T
// Phase 1 walks the sub-chunks forward and writes each start state H0 to the
// scratch hs [B,H,K,P,N] (the reference's custom_vjp recomputes its forward
// too).  Phase 2 walks them in reverse, carrying U = dL/dh_end (P x N
// float32) in shared memory; with M1 = L o (C B^T) and M2 = L o (dy x^T):
//   dx_s   = dt_s (sum_t M1[t,s] dy_t + wend_s U B_s)
//   dB_s   = dt_s (sum_t M2[t,s] C_t + wend_s U^T x_s)            per head
//   dC_t   = exp(cum_t) H0^T dy_t + sum_s M2[t,s] dt_s B_s          per head
//   dcum_t = sum_s Q[t,s] - sum_s Q[s,t] + exp(cum_t) dy_t.(H0 C_t) - E_t,
//            and at the last row + exp(cum_last) U.H0 + sum_s E_s, where
//            Q[t,s] = M1[t,s] (dy_t.x_s) dt_s, E_s = wend_s dt_s x_s^T U B_s
//   da_s   = sum_{t>=s} dcum_t;  ddt_s = x_s.(dx_s / dt_s) + A da_s
//   dA    += sum_s dt_s da_s                                         per (b, h)
//   U     <- exp(cum_last) U + sum_t exp(cum_t) dy_t C_t^T   (dh0 at the end)
// The heads of a group add their dB and dC partials, and the batch its dA
// partials, in ssd_bwd_group_sum / ssd_bwd_batch_sum, in head (batch) order.
// No float atomics: a CUDA-graph replay equals an eager call bit for bit.
//
// Bound: bytes.  At mamba2's training shapes (B 4, S 512, H 80, P 64,
// N 128) the function moves ~66 MB (x, dy, dx in bf16 and the small rest),
// ~20 us at the card's memory rate; its ~8.1 GMAC at 32-row sub-chunks
// would take ~16 us on the bf16 tensor cores.  This first design does those
// products in float32 on the CUDA cores (~240 us at their peak) and reads
// both operands of each multiply-add from shared memory (one of them a
// broadcast; rows padded to an odd word pitch so the lanes fall on distinct
// banks), so shared-memory bandwidth, not the FMA rate, bounds it; it also
// writes and reads back the start states (hs, ~170 MB).  A tensor-core
// (wgmma) backward is ROADMAP work.
namespace bwd {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBL = 32;   // rows of a sub-chunk
constexpr int kVecs = 8;  // per-row vectors: dt, cum, eh, wend, rowq, ddtd, E, dcum

struct Args {
  const void* x;    // [B, S, H, P], strides x_sb, x_ss, x_sh, 1
  const float* dt;  // [B, S, H],    strides dt_sb, dt_ss, 1
  const float* A;   // [H]
  const void* Bm;   // [B, S, G, N], strides b_sb, b_ss, b_sg, 1
  const void* C;    // [B, S, G, N], strides c_sb, c_ss, c_sg, 1
  const float* h0;  // [B, H, P, N] or null
  const void* dy;   // [B, S, H, P] contiguous, x's dtype, or null
  const float* dh;  // [B, H, P, N] or null
  void* dx;         // [B, S, H, P] contiguous, x's dtype
  float* ddt;       // [B, S, H]
  float* dA_part;   // [B, H]
  float* dB_part;   // [B, S, H, N]
  float* dC_part;   // [B, S, H, N]
  float* dh0;       // [B, H, P, N]
  float* hs;        // [B, H, K, P, N] scratch
  int S, H, P, G, N;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

// Shared memory, in floats.  Rows are padded to an odd word pitch (P | 1,
// N | 1, kBL + 1), so lanes that read down a column fall on distinct banks.
struct Layout {
  int pp, pn, pl, U, H0, xs, dys, Bs, Cs, M1, M2, Q, RI, RE, TMP, vec, red, total;
  __host__ __device__ Layout(int P, int N) {
    pp = P | 1;
    pn = N | 1;
    pl = kBL + 1;
    int o = 0;
    U = o;   o += P * pn;
    H0 = o;  o += P * pn;
    xs = o;  o += kBL * pp;
    dys = o; o += kBL * pp;
    Bs = o;  o += kBL * pn;
    Cs = o;  o += kBL * pn;
    M1 = o;  o += kBL * pl;
    M2 = o;  o += kBL * pl;
    Q = o;   o += kBL * pl;
    RI = o;  o += kBL * pp;
    RE = o;  o += kBL * pp;
    TMP = o; o += kBL * pn;
    vec = o; o += kVecs * kBL;
    red = o; o += kWarps + 2;
    total = o;
  }
};

// Rows [t0, t0 + len) of a [S, cols] source with row stride rs, widened to
// float32 into dst (pitch `pitch`); rows len .. kBL - 1 are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* src, long long rs,
                                          int t0, int len, int cols) {
  for (int i = threadIdx.x; i < kBL * cols; i += kThreads) {
    const int t = i / cols, c = i - t * cols;
    dst[t * pitch + c] =
        (src != nullptr && t < len) ? to_float(src[static_cast<long long>(t0 + t) * rs + c]) : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel(const Args a) {
  extern __shared__ float sm[];
  const Layout ly(a.P, a.N);
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int S = a.S, H = a.H, P = a.P, N = a.N, pp = ly.pp, pn = ly.pn, pl = ly.pl;
  const int g = h / (H / a.G);
  const int K = (S + kBL - 1) / kBL;
  const int PN = P * N;
  float* U = sm + ly.U;
  float* H0 = sm + ly.H0;
  float* xs = sm + ly.xs;
  float* dys = sm + ly.dys;
  float* Bs = sm + ly.Bs;
  float* Cs = sm + ly.Cs;
  float* M1 = sm + ly.M1;
  float* M2 = sm + ly.M2;
  float* Qm = sm + ly.Q;
  float* RI = sm + ly.RI;
  float* RE = sm + ly.RE;
  float* TMP = sm + ly.TMP;
  float* vdt = sm + ly.vec;
  float* cum = vdt + kBL;
  float* eh = cum + kBL;
  float* wend = eh + kBL;
  float* rowq = wend + kBL;
  float* ddtd = rowq + kBL;
  float* Ev = ddtd + kBL;
  float* dcum = Ev + kBL;
  float* red = sm + ly.red;

  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const T* Bg = static_cast<const T*>(a.Bm) + b * a.b_sb + g * a.b_sg;
  const T* Cg = static_cast<const T*>(a.C) + b * a.c_sb + g * a.c_sg;
  const float* dt = a.dt + b * a.dt_sb + h;
  const long long rowHP = static_cast<long long>(H) * P, rowHN = static_cast<long long>(H) * N;
  const long long base = static_cast<long long>(b) * S * H + h;  // (b, 0, h)
  const T* dy = a.dy != nullptr ? static_cast<const T*>(a.dy) + base * P : nullptr;
  const long long bh = static_cast<long long>(b) * H + h;
  const float Ah = a.A[h];
  float* hs = a.hs + bh * K * PN;

  // phase 1: the start state of every sub-chunk, forward
  for (int i = tid; i < PN; i += kThreads) {
    const int p = i / N, n = i - p * N;
    H0[p * pn + n] = a.h0 != nullptr ? a.h0[bh * PN + i] : 0.f;
  }
  for (int k = 0; k < K; ++k) {
    const int t0 = k * kBL, len = min(kBL, S - t0);
    __syncthreads();  // H0 whole; the last sub-chunk's rows no longer read
    for (int i = tid; i < PN; i += kThreads) {
      const int p = i / N, n = i - p * N;
      hs[static_cast<long long>(k) * PN + i] = H0[p * pn + n];
    }
    load_rows(xs, pp, x, a.x_ss, t0, len, P);
    load_rows(Bs, pn, Bg, a.b_ss, t0, len, N);
    if (tid < kBL) vdt[tid] = tid < len ? dt[static_cast<long long>(t0 + tid) * a.dt_ss] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float c = 0.f;
      for (int t = 0; t < len; ++t) {
        c += Ah * vdt[t];
        cum[t] = c;
      }
      for (int s = 0; s < len; ++s) Ev[s] = expf(c - cum[s]) * vdt[s];
      red[kWarps] = expf(c);
    }
    __syncthreads();
    const float e_end = red[kWarps];
    for (int i = tid; i < PN; i += kThreads) {
      const int p = i / N, n = i - p * N;
      float acc = 0.f;
      for (int s = 0; s < len; ++s) acc = fmaf(Ev[s] * xs[s * pp + p], Bs[s * pn + n], acc);
      H0[p * pn + n] = fmaf(e_end, H0[p * pn + n], acc);
    }
  }

  // phase 2: the sub-chunks in reverse, carrying U
  for (int i = tid; i < PN; i += kThreads) {
    const int p = i / N, n = i - p * N;
    U[p * pn + n] = a.dh != nullptr ? a.dh[bh * PN + i] : 0.f;
  }
  T* dx = static_cast<T*>(a.dx) + base * P;
  float* ddt = a.ddt + base;
  float* dBp = a.dB_part + base * N;
  float* dCp = a.dC_part + base * N;
  float dA_acc = 0.f;  // thread 0's
  for (int k = K - 1; k >= 0; --k) {
    const int t0 = k * kBL, len = min(kBL, S - t0);
    __syncthreads();  // U updated; the last sub-chunk's rows no longer read
    for (int i = tid; i < PN; i += kThreads) {
      const int p = i / N, n = i - p * N;
      H0[p * pn + n] = hs[static_cast<long long>(k) * PN + i];
    }
    load_rows(xs, pp, x, a.x_ss, t0, len, P);
    load_rows(dys, pp, dy, rowHP, t0, len, P);
    load_rows(Bs, pn, Bg, a.b_ss, t0, len, N);
    load_rows(Cs, pn, Cg, a.c_ss, t0, len, N);
    if (tid < kBL) vdt[tid] = tid < len ? dt[static_cast<long long>(t0 + tid) * a.dt_ss] : 0.f;
    __syncthreads();
    // U.H0, and the sub-chunk's decays
    float uh = 0.f;
    for (int i = tid; i < PN; i += kThreads) {
      const int p = i / N, n = i - p * N;
      uh = fmaf(U[p * pn + n], H0[p * pn + n], uh);
    }
    uh = warp_sum(uh);
    if ((tid & 31) == 0) red[tid >> 5] = uh;
    __syncthreads();
    if (tid == 0) {
      float s_ = 0.f;
      for (int w = 0; w < kWarps; ++w) s_ += red[w];
      red[kWarps] = s_;
      float c = 0.f;
      for (int t = 0; t < kBL; ++t) {
        if (t < len) {
          c += Ah * vdt[t];
          cum[t] = c;
          eh[t] = expf(c);
        } else {
          cum[t] = 0.f;
          eh[t] = 0.f;
        }
      }
      for (int s = 0; s < kBL; ++s) wend[s] = s < len ? expf(c - cum[s]) : 0.f;
    }
    __syncthreads();
    // the pairs (t, s), s <= t: M1, M2, Q
    for (int i = tid; i < kBL * kBL; i += kThreads) {
      const int t = i / kBL, s = i - t * kBL;
      float m1 = 0.f, m2 = 0.f, q = 0.f;
      if (s <= t && t < len) {
        float cb = 0.f, dxv = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(Cs[t * pn + n], Bs[s * pn + n], cb);
        for (int p = 0; p < P; ++p) dxv = fmaf(dys[t * pp + p], xs[s * pp + p], dxv);
        const float l = expf(cum[t] - cum[s]);
        m1 = cb * l;
        m2 = dxv * l;
        q = m1 * dxv * vdt[s];
      }
      M1[t * pl + s] = m1;
      M2[t * pl + s] = m2;
      Qm[t * pl + s] = q;
    }
    __syncthreads();
    // dx (and its two parts, for ddt and E)
    for (int i = tid; i < kBL * P; i += kThreads) {
      const int s = i / P, p = i - s * P;
      float ub = 0.f, ri = 0.f;
      for (int n = 0; n < N; ++n) ub = fmaf(U[p * pn + n], Bs[s * pn + n], ub);
      for (int t = s; t < len; ++t) ri = fmaf(M1[t * pl + s], dys[t * pp + p], ri);
      RI[s * pp + p] = ri;
      RE[s * pp + p] = ub;
      if (s < len)
        dx[static_cast<long long>(t0 + s) * rowHP + p] = from_float<T>(vdt[s] * fmaf(wend[s], ub, ri));
    }
    // this head's dB
    for (int i = tid; i < kBL * N; i += kThreads) {
      const int s = i / N, n = i - s * N;
      float ux = 0.f, in = 0.f;
      for (int p = 0; p < P; ++p) ux = fmaf(U[p * pn + n], xs[s * pp + p], ux);
      for (int t = s; t < len; ++t) in = fmaf(M2[t * pl + s], Cs[t * pn + n], in);
      if (s < len) dBp[static_cast<long long>(t0 + s) * rowHN + n] = vdt[s] * fmaf(wend[s], ux, in);
    }
    // this head's dC, and the terms of dy_t.(H0 C_t)
    for (int i = tid; i < kBL * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      float hd = 0.f, in = 0.f;
      for (int p = 0; p < P; ++p) hd = fmaf(H0[p * pn + n], dys[t * pp + p], hd);
      const int last = min(t, len - 1);
      for (int s = 0; s <= last; ++s) in = fmaf(M2[t * pl + s] * vdt[s], Bs[s * pn + n], in);
      const float inter = eh[t] * hd;
      TMP[t * pn + n] = inter * Cs[t * pn + n];
      if (t < len) dCp[static_cast<long long>(t0 + t) * rowHN + n] = inter + in;
    }
    if (tid < kBL) {
      float r = 0.f;
      for (int s = 0; s < kBL; ++s) r += Qm[tid * pl + s];
      rowq[tid] = r;
    }
    __syncthreads();
    // per row: dt's direct part, E, dcum
    if (tid < kBL) {
      const int s = tid;
      float ri = 0.f, re = 0.f, y0 = 0.f;
      for (int p = 0; p < P; ++p) {
        ri = fmaf(xs[s * pp + p], RI[s * pp + p], ri);
        re = fmaf(xs[s * pp + p], RE[s * pp + p], re);
      }
      for (int n = 0; n < N; ++n) y0 += TMP[s * pn + n];
      ddtd[s] = fmaf(wend[s], re, ri);
      const float e = vdt[s] * wend[s] * re;
      Ev[s] = e;
      dcum[s] = rowq[s] - vdt[s] * ri + y0 - e;
    }
    __syncthreads();
    if (tid == 0) {
      float es = 0.f;
      for (int s = 0; s < len; ++s) es += Ev[s];
      dcum[len - 1] += eh[len - 1] * red[kWarps] + es;
      float da = 0.f;
      for (int s = len - 1; s >= 0; --s) {
        da += dcum[s];
        ddt[static_cast<long long>(t0 + s) * H] = fmaf(Ah, da, ddtd[s]);
        dA_acc = fmaf(vdt[s], da, dA_acc);
      }
    }
    // U <- dL/dH0
    const float e_last = eh[len - 1];
    for (int i = tid; i < PN; i += kThreads) {
      const int p = i / N, n = i - p * N;
      float acc = 0.f;
      for (int t = 0; t < len; ++t) acc = fmaf(eh[t] * dys[t * pp + p], Cs[t * pn + n], acc);
      U[p * pn + n] = fmaf(e_last, U[p * pn + n], acc);
    }
  }
  __syncthreads();
  for (int i = tid; i < PN; i += kThreads) {
    const int p = i / N, n = i - p * N;
    a.dh0[bh * PN + i] = U[p * pn + n];
  }
  if (tid == 0) a.dA_part[bh] = dA_acc;
}

// out[o, g, n] = sum_{j < H/G} in[o, g H/G + j, n] in head order, in T's
// dtype: in [outer, H, N] and out [outer, G, N], contiguous.
template <typename T>
__global__ void ssd_bwd_group_sum(const float* __restrict__ in, T* __restrict__ out,
                                  long long outer, int H, int G, int N) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= outer * G * N) return;
  const int n = static_cast<int>(i % N);
  const long long og = i / N;
  const int g = static_cast<int>(og % G);
  const long long o = og / G;
  const int rep = H / G;
  const float* src = in + (o * H + static_cast<long long>(g) * rep) * N + n;
  float s = 0.f;
  for (int j = 0; j < rep; ++j) s += src[static_cast<long long>(j) * N];
  out[i] = from_float<T>(s);
}

// dA[h] = sum_b part[b, h], in batch order.
__global__ void ssd_bwd_batch_sum(const float* __restrict__ part, float* __restrict__ out,
                                  int batch, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int b = 0; b < batch; ++b) s += part[static_cast<long long>(b) * H + h];
  out[h] = s;
}

template <typename T>
cudaError_t launch(const Args& a, int batch, void* dB, void* dC, float* dA, cudaStream_t s) {
  // the largest layout the wrapper passes (P 64, N 128): set once
  static const cudaError_t set =
      cudaFuncSetAttribute(ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Layout(kMaxP, kMaxN).total * sizeof(float)));
  if (set != cudaSuccess) return set;
  const size_t smem = Layout(a.P, a.N).total * sizeof(float);
  ssd_bwd_kernel<T><<<dim3(a.H, batch), kThreads, smem, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long outer = static_cast<long long>(batch) * a.S;
  const int blocks = static_cast<int>((outer * a.G * a.N + 255) / 256);
  ssd_bwd_group_sum<T><<<blocks, 256, 0, s>>>(a.dB_part, static_cast<T*>(dB), outer, a.H, a.G, a.N);
  ssd_bwd_group_sum<T><<<blocks, 256, 0, s>>>(a.dC_part, static_cast<T*>(dC), outer, a.H, a.G, a.N);
  ssd_bwd_batch_sum<<<(a.H + 255) / 256, 256, 0, s>>>(a.dA_part, dA, batch, a.H);
  return cudaGetLastError();
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// The tensor-core backward: ssd_bwd_wgmma_kernel, then ssd_bwd_group_sum and
// ssd_bwd_batch_sum as above.
//
// It replaces no Pallas kernel either (the reference's custom_vjp,
// src/repro/models/ssm.py:46-49): it is the route of bf16 x, B, C and dy at
// P 64, N 128 (kernels/ssd_scan.py:bwd_route), mamba2's training shapes;
// ssd_bwd_kernel stays the route of float32 and of every other shape.
//
// Bound: bytes.  At B 4, S 512, H 80 the function moves ~66 MB (19.8 us at
// 3.35 TB/s); its products, each counted once (not once a bf16 part) at
// the sub-chunk of 16 to 128 rows that needs the fewest, are 15.0 GFLOP
// (16 rows; 24.3 at 128): 15.2 us at the bf16 tensor-core peak.  This
// kernel computes more: 28.3 GFLOP at its 128-row chunks, with C B^T beside
// B C^T for da's pairs and dy x^T beside x dy^T for the layouts.  Beyond
// the 66 MB it writes float32 partials of dB and dC, one a head ([B, S, H,
// N], 84 MB each at H 80), and reads them back once in ssd_bwd_group_sum;
// and, for a sequence of more chunks than a cluster holds, 32 KB a (batch,
// head) and group boundary (hcarry).  The start-state scratch of
// ssd_bwd_kernel (hs) is gone.
//
// The chunked "state passing" form, the chunks of a (batch, head) in
// parallel as in ssd_wgmma_kernel: one CTA of two warpgroups per 128-row
// chunk, the CTAs of the chunks a thread-block cluster, a cluster a
// (batch, head).  Per chunk, with cum, eh_t = exp(cum_t), wend_s = exp(cum_last -
// cum_s), d = exp(cum_last) and L[t,s] = exp(cum_t - cum_s) for t >= s
// (taken only there, 0 selected elsewhere):
//   (a) TMA loads x, dy (128 x 64) and B, C (128 x 128), 96 KB; on wgmma the
//       forward increment h_inc = (x o wend dt)^T B and its mirror u_inc =
//       (eh o dy)^T C, both published in shared memory with cum_last;
//   (b) one cluster barrier, then by distributed shared memory the start
//       state H0_c by the forward's prefix combination, and U_c = dL/dh at
//       the chunk's end by the suffix combination
//         U_c = sum_{j>c} (prod_{c<i<j} d_i) u_inc_j + (prod_{i>c} d_i) carry,
//       carry being dh (or zeros) for the last group of chunks, else the U
//       the next group left in dh0.  A sequence of more chunks than the
//       cluster holds first walks its groups forward for their end states
//       (hcarry; x, B and h_inc only), then in reverse for everything; no
//       CTA waits on another's result.  H0 and U go to shared memory as PH
//       and PU bf16 parts, laid out as the forward's h parts;
//   (c) the local gradients on wgmma (formulas of ssd_bwd_kernel), each
//       warpgroup owning 64 rows of the chunk, the scores of every product
//       computed in the layout that product needs and fed from registers:
//         dx = dt o (M1^T dy + wend o (B U^T)),  M1^T = (B C^T) o L^T
//         dB = dt o (M2^T C + wend o (x U)),     M2^T = (x dy^T) o L^T
//         dC = eh o (dy H0) + (M2 o dt) B,       M2 = (dy x^T) o L
//       in 32-column slices of the causal triangle, the state products
//       first and their rows scaled in registers (exact float32) before the
//       slices accumulate;
//   (d) dcum and da.  Their row-sum-minus-column-sum form (ssd_bwd_kernel's)
//       leaves dA's bound at 128-row chunks in float32 (the diagonal blocks
//       of Q cancel), so da_s is summed directly:
//         da_s = sum_{t>=s} y0_t + eh_last U.H0 + sum_{u<s} E_u
//                + sum_{t>=s} sum_{u<s} Q[t,u],
//       Q = (C B^T) o (dy x^T) o L o dt (rows t, columns u, formed beside M2),
//       y0_t = C_t . (eh_t dy_t H0), E_u = dt_u x_u . (wend_u U B_u), taken
//       from the accumulators; the pairs' inner prefix over u runs along a
//       row by quad shuffles, the outer sum over t by warp shuffles and a
//       per-warp shared row added in warp order; ddt = x.(dx/dt) + A da;
//   (e) dB and dC leave as a head's float32 partials and are added over a
//       group's heads in head order by ssd_bwd_group_sum; dA leaves per
//       (batch, chunk, head) and is summed over batch and chunks in order.
//       No float atomics: a CUDA-graph replay equals an eager call bit for
//       bit.
// The float32 operands of a wgmma -- x o wend dt (PW parts), eh o dy (PE),
// the scores M1^T, M2^T, M2 o dt (PS), H0 (PH) and U (PU) -- are cut into
// bf16 parts (take_part); the counts are template arguments, measured
// against the checks' bounds in tests/test_torch_backward.py and
// scripts/ssd_bwd_times.py; the wrapper's BWD_PARTS is the served choice.
// One CTA an SM: 255 registers a thread (a few spilled) and ~169 KB of
// shared memory (the boxes 96 KB, the state area 64 KB, so PH + PU <= 4).
namespace tcb {

using tc::kBox;
using tc::kHalf;
using tc::kL;
using tc::kN;
using tc::kP;
using tc::kThreads;

constexpr int kStatePart = 2 * kHalf;  // a bf16 [P, N] state: boxes of N columns 0-63, 64-127
constexpr int kOffC = 0;               // C: boxes of N columns 0-63 and 64-127
constexpr int kOffB = 2 * kBox;        // B: the same
constexpr int kOffX = 4 * kBox;        // x, then dy, of the head
constexpr int kOffS = 6 * kBox;        // the state area
constexpr int kArea = 4 * kStatePart;  // 64 KB
constexpr int kPub = 2 * kStatePart;   // where u_inc is published in it, after h_inc
constexpr unsigned kFull = 0xffffffffu;

// Shared memory, in bytes from the 1024-aligned base, past the boxes (C, B,
// x and dy): the state area (the published float32 h_inc and u_inc, then
// H0's PH and U's PU bf16 parts), eight float vectors of kL rows, a row of
// kL floats a warp for da's pair sums, the loads' mbarrier, cum_last and
// U.H0 a warp.
template <int PH, int PU>
struct Smem {
  static_assert(PH + PU <= 4, "H0's and U's parts fill at most the state area");
  static constexpr int kVec = kOffS + kArea;
  static constexpr int kRed = kVec + 8 * kL * 4;
  static constexpr int kMisc = kRed + 8 * kL * 4;
  static constexpr int kTotal = kMisc + 64 + 1024;  // + the base's alignment
};

struct Params {
  CUtensorMap tx, tdy, tb, tc;  // (64 or 128, S, H or G, B) bf16; boxes of 64 x 128 x 1 x 1
  const float* dt;              // [B, S, H], strides dt_sb, dt_ss, 1
  const float* A;               // [H]
  const float* h0;              // [B, H, P, N] or null (zero state)
  const float* dh;              // [B, H, P, N] or null (zero cotangent)
  __nv_bfloat16* dx;            // [B, S, H, P]
  float* ddt;                   // [B, S, H]
  float* dB_part;               // [B, S, H, N]: a head's
  float* dC_part;               // [B, S, H, N]
  float* dA_part;               // [B, chunks, H]
  float* dh0;                   // [B, H, P, N]; also U's carry between groups
  float* hcarry;                // [B, H, groups - 1, P, N] end states, or null
  long long dt_sb, dt_ss;
  int S, H, G, chunks, groups, batch;
};

// dt of the chunk's rows (0 past len), cum, eh, wend and w = wend dt.
__device__ __forceinline__ void decays(float* dts, const float* dtg, long long ss, int row0,
                                       int len, float A, int tid) {
  float* cum = dts + kL;
  float* eh = cum + kL;
  float* wend = eh + kL;
  float* wts = wend + kL;
  for (int t = tid; t < kL; t += kThreads)
    dts[t] = t < len ? dtg[static_cast<long long>(row0 + t) * ss] : 0.f;
  __syncthreads();
  if (tid < 32) tc::chunk_cumsum(cum, dts, A, tid);
  __syncthreads();
  const float cl = cum[kL - 1];
  for (int t = tid; t < kL; t += kThreads) {
    eh[t] = expf(cum[t]);
    wend[t] = expf(cl - cum[t]);
    wts[t] = wend[t] * dts[t];
  }
  __syncthreads();
}

// A [P, N] state in the increments' register order, to shared memory:
// float4 q of thread t at 16 (T q + t) bytes, T the threads that hold it
// (both warpgroups at N 128, one at N 16).
template <int T = kThreads, int R>
__device__ __forceinline__ void publish(uint8_t* area, const float (&v)[R], int tid) {
  float4* out = reinterpret_cast<float4*>(area);
#pragma unroll
  for (int q = 0; q < R / 4; ++q)
    out[q * T + tid] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// acc += sum over the ranks j = first, first + step, ... (count of them) of
// exp(the sum of cum_last over the ranks between this CTA and j) times the
// state rank j published at `area`, read through distributed shared memory;
// returns the sum of cum_last over those ranks.  T as publish's.
template <int T = kThreads, int R>
__device__ __forceinline__ float combine(float (&acc)[R], uint32_t area, uint32_t clast,
                                         int first, int step, int count, int tid) {
  float run = 0.f;
  for (int i = 0; i < count; ++i) {
    const int j = first + i * step;
    const float e = expf(run);
    const uint32_t src = tc::map_rank(area, j);
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 v = tc::ld_cluster4(src + 16 * (q * T + tid));
      acc[4 * q] = fmaf(e, v.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(e, v.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(e, v.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(e, v.w, acc[4 * q + 3]);
    }
    run += tc::ld_cluster(tc::map_rank(clast, j));
  }
  return run;
}

// s = rows 64 wg .. 64 wg + 63 of the K-major box(es) at a times rows v0 ..
// v0 + 31 of those at b, over K = 16 KS (past 64 columns, the next box).
template <int KS>
__device__ __forceinline__ void score(float (&s)[16], uint32_t a, uint32_t b, int wg, int v0) {
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = 0.f;
  tc::fence_regs(s);
  tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    tc::wgmma_ss_n32(s, tc::desc(a + off + wg * kHalf, 16, 1024),
                     tc::desc(b + off + v0 * 128, 16, 1024));
  }
  tc::wgmma_commit();
  tc::wgmma_wait_all();
  tc::fence_regs(s);
}

// acc += a slice's 16 scores (cut into NP bf16 parts, from registers) times
// rows v0 .. v0 + 31 of an MN-major box of 64 columns.  The caller fences
// acc, commits and waits.
template <int NP>
__device__ __forceinline__ void slice_product(float (&acc)[32], const uint32_t (&ga)[NP][2][4],
                                              uint32_t box, int v0) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const uint64_t bd = tc::desc(box + (v0 + 16 * ks) * 128, kHalf, 1024);
#pragma unroll
    for (int part = 0; part < NP; ++part) tc::wgmma_rs_n64(acc, ga[part][ks], bd);
  }
}

template <int NP>
__device__ __forceinline__ void fragments(uint32_t (&ga)[NP][2][4], const float (&s)[16]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float a = s[8 * ks + 2 * r], b = s[8 * ks + 2 * r + 1];
#pragma unroll
      for (int part = 0; part < NP; ++part) ga[part][ks][r] = tc::take_part(a, b);
    }
}

template <int R>
__device__ __forceinline__ void scale_rows(float (&a)[R], float fa, float fb) {
#pragma unroll
  for (int q = 0; q < R / 2; ++q) {
    const float f = q % 2 ? fb : fa;
    a[2 * q] *= f;
    a[2 * q + 1] *= f;
  }
}

// The accumulator's rows ra and rb (64 columns) dotted with the same rows
// and columns of a swizzled bf16 box, each summed over the quad.
__device__ __forceinline__ void row_dots(const float (&a)[32], const uint8_t* box, int ra, int rb,
                                         int c0, float& da, float& db) {
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int row = q % 2 ? rb : ra;
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(box + tc::swizzled(row, 8 * (q / 2) + c0)));
    const float d = fmaf(a[2 * q], v.x, a[2 * q + 1] * v.y);
    if (q % 2) sb += d; else sa += d;
  }
  sa += __shfl_xor_sync(kFull, sa, 1);
  sb += __shfl_xor_sync(kFull, sb, 1);
  sa += __shfl_xor_sync(kFull, sa, 2);
  sb += __shfl_xor_sync(kFull, sb, 2);
  da = sa;
  db = sb;
}

// da's pairs over one 32-column slice of Q (rows t: this thread's ta, tb;
// columns u, in the accumulator layout): for each column s of the slice,
// the sum over this warp's rows t >= s of sum_{u<s} Q[t, u], to red[s] (by
// lanes 0-3).  run_a and run_b carry each row's sum over the earlier slices.
__device__ __forceinline__ void pair_sums(const float (&q)[16], float& run_a, float& run_b, int ta,
                                          int tb, int v0, int c0, int lane, float* red) {
  const int l4 = lane & 3;
  float col[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float pa = q[4 * j] + q[4 * j + 1], pb = q[4 * j + 2] + q[4 * j + 3];
    float ia = pa, ib = pb;  // inclusive scan of the pairs over the quad
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      const float oa = __shfl_up_sync(kFull, ia, d), ob = __shfl_up_sync(kFull, ib, d);
      if (l4 >= d) {
        ia += oa;
        ib += ob;
      }
    }
    float ea = __shfl_up_sync(kFull, ia, 1), eb = __shfl_up_sync(kFull, ib, 1);
    if (l4 == 0) ea = eb = 0.f;
    const float tot_a = __shfl_sync(kFull, ia, lane | 3), tot_b = __shfl_sync(kFull, ib, lane | 3);
    const int s0 = v0 + 8 * j + c0;
    const float ua = run_a + ea, ub = run_b + eb;  // sum_{u < s0} of each row
    col[2 * j] = (ta >= s0 ? ua : 0.f) + (tb >= s0 ? ub : 0.f);
    col[2 * j + 1] = (ta > s0 ? ua + q[4 * j] : 0.f) + (tb > s0 ? ub + q[4 * j + 2] : 0.f);
    run_a += tot_a;
    run_b += tot_b;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    col[i] += __shfl_xor_sync(kFull, col[i], 4);
    col[i] += __shfl_xor_sync(kFull, col[i], 8);
    col[i] += __shfl_xor_sync(kFull, col[i], 16);
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[v0 + 8 * j + c0] = col[2 * j];
      red[v0 + 8 * j + c0 + 1] = col[2 * j + 1];
    }
  }
}

// Rows ra, rb of a 64-column (R 32) or 16-column (R 8) float32 tile to
// rows of `out` (row stride rs), less rows past len.
template <int R>
__device__ __forceinline__ void store_half(float* out, long long rs, const float (&a)[R], int ra,
                                           int rb, int c0, int len) {
#pragma unroll
  for (int q = 0; q < R / 2; ++q) {
    const int row = q % 2 ? rb : ra;
    if (row < len)
      *reinterpret_cast<float2*>(out + row * rs + 8 * (q / 2) + c0) =
          make_float2(a[2 * q], a[2 * q + 1]);
  }
}

// Rows ra, rb of a 128-column float32 tile (lo: columns 0-63, hi: 64-127),
// as store_half each half.
__device__ __forceinline__ void store_rows(float* out, long long rs, const float (&lo)[32],
                                           const float (&hi)[32], int ra, int rb, int c0,
                                           int len) {
  store_half(out, rs, lo, ra, rb, c0, len);
  store_half(out + 64, rs, hi, ra, rb, c0, len);
}

// PW, PE, PS, PH, PU: bf16 parts of x o w, eh o dy, the scores, H0 and U.
template <int PW, int PE, int PS, int PH, int PU>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_wgmma_kernel(const __grid_constant__ Params p) {
  using Lay = Smem<PH, PU>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  float* dts = reinterpret_cast<float*>(sm + Lay::kVec);
  float* cum = dts + kL;
  float* eh = cum + kL;     // exp(cum_t)
  float* wend = eh + kL;    // exp(cum_last - cum_s)
  float* wts = wend + kL;   // wend_s dt_s
  float* y0v = wts + kL;    // y0_t = C_t . (eh_t dy_t H0)
  float* ev = y0v + kL;     // E_s = dt_s x_s . (wend_s U B_s)
  float* ddtd = ev + kL;    // x_s . (dx_s / dt_s)
  float* red = reinterpret_cast<float*>(sm + Lay::kRed);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Lay::kMisc);
  float* clast = reinterpret_cast<float*>(sm + Lay::kMisc + 16);
  float* uhw = reinterpret_cast<float*>(sm + Lay::kMisc + 32);
  const uint32_t sC = tc::smem_u32(sm + kOffC), sB = tc::smem_u32(sm + kOffB);
  const uint32_t sS = tc::smem_u32(sm + kOffS), sLast = tc::smem_u32(clast);

  const int rank = blockIdx.x, K = gridDim.x;  // the cluster spans grid x
  const int h = blockIdx.y, b = blockIdx.z, g = h / (p.H / p.G);
  const long long bh = static_cast<long long>(b) * p.H + h;
  const float A = p.A[h];
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid % 32;
  // wgmma's accumulator layout, as in ssd_wgmma_kernel; ta and tb are this
  // thread's rows of the chunk
  const int r0 = ((tid % 128) / 32) * 16 + (tid % 32) / 4, c0 = 2 * (tid % 4);
  const int ta = wg * 64 + r0, tb = ta + 8;
  const long long PN = kP * kN;
  auto at = [&](int q) { return (r0 + 8 * (q % 2)) * kN + wg * 64 + 8 * (q / 2) + c0; };
  auto end_state = [&](int grp) { return p.hcarry + (bh * (p.groups - 1) + grp) * PN; };
  uint8_t* const xb = sm + kOffX;  // x, then dy
  const uint32_t sX = tc::smem_u32(xb), sDY = sX + kBox;
  uint32_t phase = 0;  // of the loads' mbarrier

  if (tid == 0) {
    tc::mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto wait_loads = [&]() {
    tc::mbar_wait(full, phase);
    phase ^= 1;
  };

  // The end states of groups 0 .. groups - 2, walked forward (every chunk
  // of those groups is whole): the CTA of a group's last chunk writes them.
  for (int grp = 0; grp + 1 < p.groups; ++grp) {
    const int row0 = (grp * K + rank) * kL;
    if (tid == 0) {
      tc::mbar_expect_tx(full, 3 * kBox);
      tc::tma_load(&p.tb, sm + kOffB, full, 0, row0, g, b);
      tc::tma_load(&p.tb, sm + kOffB + kBox, full, 64, row0, g, b);
      tc::tma_load(&p.tx, sm + kOffX, full, 0, row0, h, b);
    }
    decays(dts, p.dt + b * p.dt_sb + h, p.dt_ss, row0, kL, A, tid);
    wait_loads();
    float inc[32];
    tc::chunk_increment<PW>(inc, sB, sX, wts, wg, c0);
    publish(sm + kOffS, inc, tid);
    if (tid == 0) *clast = cum[kL - 1];
    tc::cluster_sync();
    if (rank == K - 1) {
      float hp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) hp[j] = 0.f;
      const float run = combine(hp, sS, sLast, rank - 1, -1, rank, tid);
      const float* carry = grp == 0 ? (p.h0 ? p.h0 + bh * PN : nullptr) : end_state(grp - 1);
      if (carry != nullptr) {
        const float e = expf(run);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(carry + at(q)));
          hp[2 * q] = fmaf(e, v.x, hp[2 * q]);
          hp[2 * q + 1] = fmaf(e, v.y, hp[2 * q + 1]);
        }
      }
      const float d = expf(cum[kL - 1]);
      const float* mine = reinterpret_cast<const float*>(sm + kOffS);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int j = 2 * q, o = 4 * ((j / 4) * kThreads + tid) + j % 4;
        __stcg(reinterpret_cast<float2*>(end_state(grp) + at(q)),
               make_float2(fmaf(d, hp[j], mine[o]), fmaf(d, hp[j + 1], mine[o + 1])));
      }
    }
    tc::cluster_sync();
    tc::fence_proxy_async();
    __syncthreads();
  }

  // Every group of chunks in reverse: the exchange, then the chunk's
  // gradients.
  for (int grp = p.groups - 1; grp >= 0; --grp) {
    const int c = grp * K + rank;
    const bool active = c < p.chunks;  // uniform over the CTA
    const int nact = min(K, p.chunks - grp * K);
    const int row0 = c * kL;
    const int len = active ? min(kL, p.S - row0) : 0;
    if (active) {
      if (tid == 0) {  // once the group before is done with the boxes
        tc::mbar_expect_tx(full, 6 * kBox);
        tc::tma_load(&p.tc, sm + kOffC, full, 0, row0, g, b);
        tc::tma_load(&p.tc, sm + kOffC + kBox, full, 64, row0, g, b);
        tc::tma_load(&p.tb, sm + kOffB, full, 0, row0, g, b);
        tc::tma_load(&p.tb, sm + kOffB + kBox, full, 64, row0, g, b);
        tc::tma_load(&p.tx, xb, full, 0, row0, h, b);
        tc::tma_load(&p.tdy, xb + kBox, full, 0, row0, h, b);
      }
      decays(dts, p.dt + b * p.dt_sb + h, p.dt_ss, row0, len, A, tid);
      wait_loads();
      float inc[32];
      tc::chunk_increment<PW>(inc, sB, sX, wts, wg, c0);
      publish(sm + kOffS, inc, tid);
      tc::chunk_increment<PE>(inc, sC, sDY, eh, wg, c0);
      publish(sm + kOffS + kPub, inc, tid);
      if (tid == 0) *clast = cum[kL - 1];
    }
    tc::cluster_sync();  // every increment of the group is published

    float hp[32], up[32];
    if (active) {
#pragma unroll
      for (int j = 0; j < 32; ++j) hp[j] = up[j] = 0.f;
      float run = combine(hp, sS, sLast, rank - 1, -1, rank, tid);
      const float* carry = grp == 0 ? (p.h0 ? p.h0 + bh * PN : nullptr) : end_state(grp - 1);
      if (carry != nullptr) {
        const float e = expf(run);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(carry + at(q)));
          hp[2 * q] = fmaf(e, v.x, hp[2 * q]);
          hp[2 * q + 1] = fmaf(e, v.y, hp[2 * q + 1]);
        }
      }
      run = combine(up, sS + kPub, sLast, rank + 1, 1, nact - 1 - rank, tid);
      const float* ucarry = grp == p.groups - 1 ? p.dh : p.dh0;
      if (ucarry != nullptr) {
        const float e = expf(run);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(ucarry + bh * PN + at(q)));
          up[2 * q] = fmaf(e, v.x, up[2 * q]);
          up[2 * q + 1] = fmaf(e, v.y, up[2 * q + 1]);
        }
      }
    }
    tc::cluster_sync();  // every read of the group's increments and carries is done

    if (active) {
      float uh = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) uh = fmaf(up[j], hp[j], uh);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) uh += __shfl_xor_sync(kFull, uh, m);
      if (lane == 0) uhw[warp] = uh;
      // the group's first chunk: dL/dh at its start, d U + u_inc, to dh0
      // (the earlier group's carry, or the result)
      if (rank == 0) {
        const float d = expf(cum[kL - 1]);
        const float* mine = reinterpret_cast<const float*>(sm + kOffS + kPub);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int j = 2 * q, o = 4 * ((j / 4) * kThreads + tid) + j % 4;
          __stcg(reinterpret_cast<float2*>(p.dh0 + bh * PN + at(q)),
                 make_float2(fmaf(d, up[j], mine[o]), fmaf(d, up[j + 1], mine[o + 1])));
        }
      }
      __syncthreads();  // the published increments are read
      // H0 and U as bf16 parts, each laid out as B^T's K-major boxes
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int off = wg * kHalf + tc::swizzled(r0 + 8 * (q % 2), 8 * (q / 2) + c0);
        float a = hp[2 * q], b2 = hp[2 * q + 1];
#pragma unroll
        for (int part = 0; part < PH; ++part)
          *reinterpret_cast<uint32_t*>(sm + kOffS + part * kStatePart + off) =
              tc::take_part(a, b2);
        a = up[2 * q];
        b2 = up[2 * q + 1];
#pragma unroll
        for (int part = 0; part < PU; ++part)
          *reinterpret_cast<uint32_t*>(sm + kOffS + (PH + part) * kStatePart + off) =
              tc::take_part(a, b2);
      }
      tc::fence_proxy_async();  // the parts are read by wgmma
      __syncthreads();

      const float dta = dts[ta], dtb = dts[tb];
      const long long first = (static_cast<long long>(b) * p.S + row0) * p.H + h;  // (b, row0, h)
      const long long part_rows = static_cast<long long>(p.H) * kN;  // the partials' row stride

      // dx = dt o (M1^T dy + wend o (B U^T)): rows s = ta, tb
      {
        float acc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[j] = 0.f;
        tc::fence_regs(acc);
        tc::wgmma_fence();
#pragma unroll
        for (int part = 0; part < PU; ++part) {
          const uint32_t ub = sS + (PH + part) * kStatePart;
#pragma unroll
          for (int kk = 0; kk < kN / 16; ++kk)
            tc::wgmma_ss_n64(acc,
                             tc::desc(sB + (kk / 4) * kBox + wg * kHalf + (kk % 4) * 32, 16, 1024),
                             tc::desc(ub + (kk / 4) * kHalf + (kk % 4) * 32, 16, 1024));
        }
        tc::wgmma_commit();
        tc::wgmma_wait_all();
        tc::fence_regs(acc);
        scale_rows(acc, wend[ta], wend[tb]);
        float ea, eb;
        row_dots(acc, xb, ta, tb, c0, ea, eb);
        if ((tid & 3) == 0) {
          ev[ta] = dta * ea;
          ev[tb] = dtb * eb;
        }
        for (int k = 2 * wg; k < 4; ++k) {  // the slices of columns t >= the rows
          const int v0 = 32 * k;
          float s[16];
          score<kN / 16>(s, sB, sC, wg, v0);  // B C^T: rows s, columns t
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int row = (j / 2) % 2 ? tb : ta, t = v0 + 8 * (j / 4) + c0 + (j % 2);
            s[j] = t >= row ? s[j] * __expf(cum[t] - cum[row]) : 0.f;
          }
          uint32_t ga[PS][2][4];
          fragments<PS>(ga, s);
          tc::fence_regs(acc);
          tc::wgmma_fence();
          slice_product<PS>(acc, ga, sDY, v0);
          tc::wgmma_commit();
          tc::wgmma_wait_all();
          tc::fence_regs(acc);
        }
        float xa, xbv;
        row_dots(acc, xb, ta, tb, c0, xa, xbv);
        if ((tid & 3) == 0) {
          ddtd[ta] = xa;
          ddtd[tb] = xbv;
        }
        __nv_bfloat16* dx = p.dx + first * kP;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int row = q % 2 ? tb : ta;
          const float f = q % 2 ? dtb : dta;
          if (row < len)
            *reinterpret_cast<__nv_bfloat162*>(dx + row * static_cast<long long>(p.H) * kP +
                                               8 * (q / 2) + c0) =
                __floats2bfloat162_rn(f * acc[2 * q], f * acc[2 * q + 1]);
        }
      }

      // dB = dt o (M2^T C + wend o (x U)): rows s, the head's partial
      {
        float lo[32], hi[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) lo[j] = hi[j] = 0.f;
        tc::fence_regs(lo);
        tc::fence_regs(hi);
        tc::wgmma_fence();
#pragma unroll
        for (int part = 0; part < PU; ++part) {
          const uint32_t ub = sS + (PH + part) * kStatePart;
#pragma unroll
          for (int kk = 0; kk < kP / 16; ++kk) {
            const uint64_t a = tc::desc(sX + wg * kHalf + kk * 32, 16, 1024);
            tc::wgmma_ss_n64_tb(lo, a, tc::desc(ub + kk * 2048, kHalf, 1024));
            tc::wgmma_ss_n64_tb(hi, a, tc::desc(ub + kHalf + kk * 2048, kHalf, 1024));
          }
        }
        tc::wgmma_commit();
        tc::wgmma_wait_all();
        tc::fence_regs(lo);
        tc::fence_regs(hi);
        scale_rows(lo, wend[ta], wend[tb]);
        scale_rows(hi, wend[ta], wend[tb]);
        for (int k = 2 * wg; k < 4; ++k) {
          const int v0 = 32 * k;
          float s[16];
          score<kP / 16>(s, sX, sDY, wg, v0);  // x dy^T: rows s, columns t
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int row = (j / 2) % 2 ? tb : ta, t = v0 + 8 * (j / 4) + c0 + (j % 2);
            s[j] = t >= row ? s[j] * __expf(cum[t] - cum[row]) : 0.f;
          }
          uint32_t ga[PS][2][4];
          fragments<PS>(ga, s);
          tc::fence_regs(lo);
          tc::fence_regs(hi);
          tc::wgmma_fence();
          slice_product<PS>(lo, ga, sC, v0);
          slice_product<PS>(hi, ga, sC + kBox, v0);
          tc::wgmma_commit();
          tc::wgmma_wait_all();
          tc::fence_regs(lo);
          tc::fence_regs(hi);
        }
        scale_rows(lo, dta, dtb);
        scale_rows(hi, dta, dtb);
        store_rows(p.dB_part + first * kN, part_rows, lo, hi, ta, tb, c0, len);
      }

      // dC = eh o (dy H0) + (M2 o dt) B: rows t, as dB.  Q beside
      // M2, and da's pair sums from it
      {
        float lo[32], hi[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) lo[j] = hi[j] = 0.f;
        tc::fence_regs(lo);
        tc::fence_regs(hi);
        tc::wgmma_fence();
#pragma unroll
        for (int part = 0; part < PH; ++part) {
          const uint32_t hb = sS + part * kStatePart;
#pragma unroll
          for (int kk = 0; kk < kP / 16; ++kk) {
            const uint64_t a = tc::desc(sDY + wg * kHalf + kk * 32, 16, 1024);
            tc::wgmma_ss_n64_tb(lo, a, tc::desc(hb + kk * 2048, kHalf, 1024));
            tc::wgmma_ss_n64_tb(hi, a, tc::desc(hb + kHalf + kk * 2048, kHalf, 1024));
          }
        }
        tc::wgmma_commit();
        tc::wgmma_wait_all();
        tc::fence_regs(lo);
        tc::fence_regs(hi);
        scale_rows(lo, eh[ta], eh[tb]);
        scale_rows(hi, eh[ta], eh[tb]);
        {
          float ya, yb, za, zb;
          row_dots(lo, sm + kOffC, ta, tb, c0, ya, yb);
          row_dots(hi, sm + kOffC + kBox, ta, tb, c0, za, zb);
          if ((tid & 3) == 0) {
            y0v[ta] = ya + za;
            y0v[tb] = yb + zb;
          }
        }
        float* wred = red + warp * kL;
        for (int s_ = lane; s_ < kL; s_ += 32) wred[s_] = 0.f;  // columns past the rows stay 0
        __syncwarp();
        float run_a = 0.f, run_b = 0.f;
        for (int k = 0; k < 2 * (wg + 1); ++k) {  // the slices of columns u <= the rows
          const int v0 = 32 * k;
          float s[16], q[16];
          score<kP / 16>(s, sDY, sX, wg, v0);  // dy x^T: rows t, columns u
          score<kN / 16>(q, sC, sB, wg, v0);   // C B^T
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int row = (j / 2) % 2 ? tb : ta, u = v0 + 8 * (j / 4) + c0 + (j % 2);
            if (u <= row) {
              s[j] *= __expf(cum[row] - cum[u]) * dts[u];
              q[j] *= s[j];
            } else {
              s[j] = 0.f;
              q[j] = 0.f;
            }
          }
          uint32_t ga[PS][2][4];
          fragments<PS>(ga, s);
          tc::fence_regs(lo);
          tc::fence_regs(hi);
          tc::wgmma_fence();
          slice_product<PS>(lo, ga, sB, v0);
          slice_product<PS>(hi, ga, sB + kBox, v0);
          tc::wgmma_commit();
          pair_sums(q, run_a, run_b, ta, tb, v0, c0, lane, wred);  // beside the products
          tc::wgmma_wait_all();
          tc::fence_regs(lo);
          tc::fence_regs(hi);
        }
        store_rows(p.dC_part + first * kN, part_rows, lo, hi, ta, tb, c0, len);
      }
      __syncthreads();  // y0, E, x.(dx/dt), the pair sums and U.H0 are written

      // da, ddt and this chunk's share of dA: one warp, rows 4 lane .. + 3
      if (warp == 0) {
        float uh = 0.f;
        for (int w = 0; w < 8; ++w) uh += uhw[w];
        const float tail = eh[kL - 1] * uh;
        float y[4], e[4], dq[4];
        float ys = 0.f, es = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s_ = 4 * lane + j;
          y[j] = y0v[s_];
          e[j] = ev[s_];
          dq[j] = 0.f;
          for (int w = 0; w < 8; ++w) dq[j] += red[w * kL + s_];
          ys += y[j];
          es += e[j];
        }
        float ysuf = ys, epre = es;  // inclusive suffix / prefix over the lanes
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const float oy = __shfl_down_sync(kFull, ysuf, d), oe = __shfl_up_sync(kFull, epre, d);
          if (lane + d < 32) ysuf += oy;
          if (lane >= d) epre += oe;
        }
        float yrun = __shfl_down_sync(kFull, ysuf, 1), erun = __shfl_up_sync(kFull, epre, 1);
        if (lane == 31) yrun = 0.f;
        if (lane == 0) erun = 0.f;
        float da[4];
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          yrun += y[j];
          da[j] = yrun;  // sum_{t >= s} y0_t
        }
        float dap = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s_ = 4 * lane + j;
          da[j] += erun + tail + dq[j];
          erun += e[j];
          if (s_ < len) p.ddt[first + s_ * static_cast<long long>(p.H)] = fmaf(A, da[j], ddtd[s_]);
          dap = fmaf(dts[s_], da[j], dap);
        }
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) dap += __shfl_xor_sync(kFull, dap, m);
        if (lane == 0) p.dA_part[(static_cast<long long>(b) * p.chunks + c) * p.H + h] = dap;
      }
    }
    tc::fence_proxy_async();
    __syncthreads();  // shared memory is free for the next group's loads
  }
}

// After a tensor-core backward of state width N: dB and dC added over a
// group's heads, dA over the batch and the chunks, in order.
inline cudaError_t sums(const Params& p, int N, void* dB, void* dC, float* dA, cudaStream_t s) {
  const long long outer = static_cast<long long>(p.batch) * p.S;
  const int blocks = static_cast<int>((outer * p.G * N + 255) / 256);
  bwd::ssd_bwd_group_sum<__nv_bfloat16><<<blocks, 256, 0, s>>>(
      p.dB_part, static_cast<__nv_bfloat16*>(dB), outer, p.H, p.G, N);
  bwd::ssd_bwd_group_sum<__nv_bfloat16><<<blocks, 256, 0, s>>>(
      p.dC_part, static_cast<__nv_bfloat16*>(dC), outer, p.H, p.G, N);
  bwd::ssd_bwd_batch_sum<<<(p.H + 255) / 256, 256, 0, s>>>(p.dA_part, dA, p.batch * p.chunks,
                                                            p.H);
  return cudaGetLastError();
}

template <int PW, int PE, int PS, int PH, int PU>
cudaError_t launch(const Params& p, int cluster, void* dB, void* dC, float* dA, cudaStream_t s) {
  auto kernel = ssd_bwd_wgmma_kernel<PW, PE, PS, PH, PU>;
  constexpr int smem = Smem<PH, PU>::kTotal;
  static const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  const cudaError_t err = tc::launch_clusters(kernel, p, smem, cluster, p.H, p.batch, s);
  return err != cudaSuccess ? err : sums(p, kN, dB, dC, dA, s);
}

}  // namespace tcb

// ---------------------------------------------------------------------------
// The tensor-core route at a state width of 16: bf16 x, B and C at P 64,
// N 16 (hymba-1.5b's SSD heads), forward (chunk 128) and backward.
//
// ssd_wgmma_n16_kernel replaces ssd_scan_call (src/repro/kernels/ssd_scan.py:80)
// on that route, as ssd_wgmma_kernel does at N 128; ssd_bwd_wgmma_n16_kernel is
// the route's backward (the reference differentiates the plain scan through
// a custom_vjp, src/repro/models/ssm.py:46-49).  The algorithms are those of
// the N-128 kernels above (tc, tcb), the chunk-parallel "state passing" form:
// one CTA of two warpgroups per 128-row chunk, the CTAs of a (batch, head) a
// thread-block cluster, the states formed by prefix (and, backward, suffix)
// combination through distributed shared memory, the same helpers and the
// same bf16 parts.  What N 16 changes:
//   * a row of B or C is 32 bytes: TMA loads each as one 128 x 16 box in the
//     32-byte swizzle (4 KB), and every wgmma operand that reads them, or a
//     [P, N] state, takes 32-byte-swizzle descriptors (desc32): C B^T is one
//     m64n32k16 a 32-column slice, C h^T and B U^T one m64n64k16, the
//     increments and x U, dy H0 m64n16 over k-steps of 16 rows;
//   * a [P, N] state is 64 x 16: one warpgroup's m64n16 accumulator holds it
//     whole (8 floats a thread), so warpgroup 0 forms the forward's
//     increment h_inc (warpgroup 1 has twice its causal slices), and in the
//     backward warpgroup 0 forms h_inc, warpgroup 1 u_inc; the published
//     increments are 4 KB, not 32;
//   * shared memory is ~37 KB a CTA forward and ~66 KB backward (x and dy
//     in 16 KB boxes as at N 128), so two CTAs share an SM (registers).
// Bound: bytes, forward and backward (at hymba's shapes the products are a
// few percent of the bytes' time).  The products are exact float32 sums of
// bf16 parts, as at N 128; the parts are template arguments and the
// wrapper's PARTS_N16 / BWD_PARTS_N16 the served choice.
namespace n16 {

using tc::kBox;
using tc::kHalf;
using tc::kL;
using tc::kP;
using tc::kThreads;

constexpr int kN = 16;
constexpr int kWG = 128;              // threads of a warpgroup
constexpr int kBoxS = kN * kL * 2;    // a B or C box: 128 rows of 32 bytes
constexpr int kState = kP * kN * 2;   // a bf16 [P, N] state part: 64 rows of 32 bytes
constexpr int kPub = kP * kN * 4;     // a float32 [P, N] state

// Forward shared memory, in bytes from the 1024-aligned base.
constexpr int kOffX = 0;                       // x; then y for its store
constexpr int kOffC = kBox;                    // C (32-byte swizzle)
constexpr int kOffB = kOffC + kBoxS;           // B
constexpr int kOffPub = kOffB + kBoxS;         // h_inc, warpgroup 0's register order
constexpr int kOffH = kOffPub + kPub;          // h_{c-1}'s bf16 parts, at most 3
constexpr int kOffVec = kOffH + 3 * kState;    // float cum, dt, exp(cum), w: kL each
constexpr int kOffBar = kOffVec + 4 * kL * 4;  // the loads' mbarrier, then cum_last
constexpr int kSmem = kOffBar + 16 + 1024;     // + the base's alignment

// Element (p, n) of a [P, N] state that accumulator pair q of an m64n16
// accumulator holds (rows r0, r0 + 8; columns 8 (q / 2) + c0, + 1).
__device__ __forceinline__ int at(int q, int r0, int c0) {
  return (r0 + 8 * (q % 2)) * kN + 8 * (q / 2) + c0;
}

// A [P, N] state of an m64n16 accumulator as NPART bf16 parts, rows p of 32
// bytes in the 32-byte swizzle, kState bytes apart from `dst`.
template <int NPART>
__device__ __forceinline__ void state_parts(uint8_t* dst, const float (&v)[8], int r0, int c0) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int off = tc::swizzled32(r0 + 8 * (q % 2), 8 * (q / 2) + c0);
    float a = v[2 * q], b = v[2 * q + 1];
#pragma unroll
    for (int part = 0; part < NPART; ++part)
      *reinterpret_cast<uint32_t*>(dst + part * kState + off) = tc::take_part(a, b);
  }
}

// acc += e times the float32 [P, N] state at `src` (global), in the
// accumulator's layout.
__device__ __forceinline__ void add_state(float (&acc)[8], const float* src, float e, int r0,
                                          int c0) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(src + at(q, r0, c0)));
    acc[2 * q] = fmaf(e, v.x, acc[2 * q]);
    acc[2 * q + 1] = fmaf(e, v.y, acc[2 * q + 1]);
  }
}

// dst = d acc + the state this thread published at `pub` (slot t), to global.
__device__ __forceinline__ void store_state(float* dst, const float (&acc)[8], float d,
                                            const uint8_t* pub, int t, int r0, int c0) {
  const float* mine = reinterpret_cast<const float*>(pub);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = 2 * q, o = 4 * ((j / 4) * kWG + t) + j % 4;
    __stcg(reinterpret_cast<float2*>(dst + at(q, r0, c0)),
           make_float2(fmaf(d, acc[j], mine[o]), fmaf(d, acc[j + 1], mine[o + 1])));
  }
}

// PG, PW, PH: bf16 parts of G, x o w and h_{c-1}.
template <int PG, int PW, int PH>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_wgmma_n16_kernel(const __grid_constant__ tc::Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  float* cum = reinterpret_cast<float*>(sm + kOffVec);
  float* dts = cum + kL;
  float* ecum = dts + kL;  // exp(cum_t)
  float* wts = ecum + kL;  // exp(cum_last - cum_u) dt_u
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kOffBar);
  float* clast = reinterpret_cast<float*>(sm + kOffBar + 8);  // cum_last, for the cluster
  const uint32_t sC = tc::smem_u32(sm + kOffC), sB = tc::smem_u32(sm + kOffB);
  const uint32_t sX = tc::smem_u32(sm + kOffX), sH = tc::smem_u32(sm + kOffH);
  const uint32_t sPub = tc::smem_u32(sm + kOffPub), sLast = tc::smem_u32(clast);

  const int rank = blockIdx.x, K = gridDim.x;  // the cluster spans grid x
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, wg = tid / kWG;
  const int r0 = ((tid % kWG) / 32) * 16 + (tid % 32) / 4, c0 = 2 * (tid % 4);
  const float A = p.A[h];
  const size_t state0 = (static_cast<size_t>(b) * p.H + h) * kP * kN;

  if (tid == 0) {
    tc::mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  for (int grp = 0; grp < p.groups; ++grp) {
    const int c = grp * K + rank;
    const bool active = c < p.chunks;  // uniform over the CTA
    const int row0 = c * kL;
    const int len = active ? min(kL, p.S - row0) : 0;
    float yi[32], hp[8];
    if (active) {
      if (tid == 0) {
        tc::tma_store_wait_read();  // the previous group's y has left x's box
        tc::mbar_expect_tx(full, kBox + 2 * kBoxS);
        tc::tma_load(&p.tc, sm + kOffC, full, 0, row0, g, b);
        tc::tma_load(&p.tb, sm + kOffB, full, 0, row0, g, b);
        tc::tma_load(&p.tx, sm + kOffX, full, 0, row0, h, b);
      }
      const float* dtg = p.dt + b * p.dt_sb + h;
      for (int t = tid; t < kL; t += kThreads) dts[t] = t < len ? dtg[(row0 + t) * p.dt_ss] : 0.f;
      __syncthreads();
      if (tid < 32) tc::chunk_cumsum(cum, dts, A, tid);
      __syncthreads();
      const float cum_last = cum[kL - 1];
      for (int t = tid; t < kL; t += kThreads) {
        ecum[t] = expf(cum[t]);
        wts[t] = expf(cum_last - cum[t]) * dts[t];
      }
      __syncthreads();
      tc::mbar_wait(full, grp & 1);

#pragma unroll
      for (int j = 0; j < 32; ++j) yi[j] = 0.f;
      // the causal 32-column slices of the warpgroup's rows: 2 or 4
      for (int k = 0; k < 2 * (wg + 1); ++k)
        tc::intra_slice<PG, kN>(yi, sC, sB, sX, cum, dts, wg, 32 * k, r0, c0);
      if (wg == 0) {
        float hi[8];
        tc::chunk_increment<PW>(hi, sB, sX, wts, 0, c0);
        tcb::publish<kWG>(sm + kOffPub, hi, tid);
      }
      if (tid == 0) *clast = cum_last;
    }
    tc::cluster_sync();  // every increment of the group is published

    // h_{c-1} by prefix combination over the group's earlier ranks, then
    // the carry (init_state or zeros, or the previous group's last state)
    if (active && wg == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) hp[j] = 0.f;
      const float run = tcb::combine<kWG>(hp, sPub, sLast, rank - 1, -1, rank, tid);
      const float* carry = grp == 0 ? p.h0 : p.hout;
      if (carry != nullptr) add_state(hp, carry + state0, expf(run), r0, c0);
    }
    tc::cluster_sync();  // every read of the group's increments and carry is done

    if (active) {
      if (wg == 0) {
        // the end of the sequence or of the group: h_c = d_c h_{c-1} + h_inc_c
        if (c == p.chunks - 1 || rank == K - 1)
          store_state(p.hout + state0, hp, expf(cum[kL - 1]), sm + kOffPub, tid, r0, c0);
        state_parts<PH>(sm + kOffH, hp, r0, c0);
        tc::fence_proxy_async();  // the parts are read by wgmma
      }
      __syncthreads();
      // y_state = (C h_{c-1}^T) o exp(cum_t), and y = y_intra + y_state
      float ys[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) ys[j] = 0.f;
      tc::fence_regs(ys);
      tc::wgmma_fence();
#pragma unroll
      for (int part = 0; part < PH; ++part)
        tc::wgmma_ss_n64(ys, tc::desc32(sC + wg * 64 * 32, 16, 256),
                         tc::desc32(sH + part * kState, 16, 256));
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(ys);
      // y through x's box (its last readers, the products, finished before
      // the cluster barriers) to one TMA store, which leaves out rows past S
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int t = wg * 64 + r0 + 8 * (q % 2);
        const float e = ecum[t];
        *reinterpret_cast<__nv_bfloat162*>(sm + kOffX + tc::swizzled(t, 8 * (q / 2) + c0)) =
            __floats2bfloat162_rn(fmaf(e, ys[2 * q], yi[2 * q]),
                                  fmaf(e, ys[2 * q + 1], yi[2 * q + 1]));
      }
      tc::fence_proxy_async();
      __syncthreads();
      if (tid == 0) tc::tma_store(&p.ty, sm + kOffX, 0, row0, h, b);
    }
    tc::fence_proxy_async();
    __syncthreads();  // shared memory is free for the next group's loads
  }
  if (tid == 0) tc::tma_store_wait();
}

template <int PG, int PW, int PH>
cudaError_t launch(const tc::Params& p, int cluster, int B, cudaStream_t s) {
  auto kernel = ssd_wgmma_n16_kernel<PG, PW, PH>;
  static const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (set != cudaSuccess) return set;
  return tc::launch_clusters(kernel, p, kSmem, cluster, p.H, B, s);
}

// ---- the backward ----------------------------------------------------------

// Backward shared memory, in bytes from the 1024-aligned base: the boxes,
// the published float32 h_inc and u_inc, H0's PH and U's PU bf16 parts,
// eight float vectors of kL rows, a row of kL floats a warp for da's pair
// sums, the loads' mbarrier, cum_last and U.H0 a warp.
constexpr int kbX = 0;                       // x
constexpr int kbDY = kBox;                   // dy
constexpr int kbC = 2 * kBox;                // C (32-byte swizzle)
constexpr int kbB = kbC + kBoxS;             // B
constexpr int kbPub = kbB + kBoxS;           // h_inc (warpgroup 0's), then u_inc (1's)
constexpr int kbParts = kbPub + 2 * kPub;    // H0's parts, then U's: at most 4
constexpr int kbVec = kbParts + 4 * kState;
constexpr int kbRed = kbVec + 8 * kL * 4;
constexpr int kbMisc = kbRed + 8 * kL * 4;
constexpr int kbSmem = kbMisc + 64 + 1024;   // + the base's alignment

// s = rows 64 wg .. of the 16-column box at a (its row 0 at a) times rows
// v0 .. v0 + 31 of the one at b: one m64n32k16.
__device__ __forceinline__ void score16(float (&s)[16], uint32_t a, uint32_t b) {
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = 0.f;
  tc::fence_regs(s);
  tc::wgmma_fence();
  tc::wgmma_ss_n32(s, tc::desc32(a, 16, 256), tc::desc32(b, 16, 256));
  tc::wgmma_commit();
  tc::wgmma_wait_all();
  tc::fence_regs(s);
}

// acc += a slice's 16 scores (NP bf16 parts, from registers) times rows v0
// .. v0 + 31 of a 16-column box (MN-major).  The caller fences, commits and
// waits.
template <int NP>
__device__ __forceinline__ void slice_product16(float (&acc)[8], const uint32_t (&ga)[NP][2][4],
                                                uint32_t box, int v0) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const uint64_t bd = tc::desc32(box + (v0 + 16 * ks) * 32, 256, 256);
#pragma unroll
    for (int part = 0; part < NP; ++part) tc::wgmma_rs_n16(acc, ga[part][ks], bd);
  }
}

// acc (rows of the warpgroup, 16 columns) += the K-major 128-byte-swizzled
// box at a (x or dy: K = P) times the NPART bf16 parts of a [P, N] state at
// st (MN-major).
template <int NPART>
__device__ __forceinline__ void state_product16(float (&acc)[8], uint32_t a, uint32_t st,
                                                int wg) {
#pragma unroll
  for (int part = 0; part < NPART; ++part)
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk)
      tc::wgmma_ss_n16_tb(acc, tc::desc(a + wg * kHalf + kk * 32, 16, 1024),
                          tc::desc32(st + part * kState + kk * 16 * 32, 256, 256));
}

// The accumulator's rows ra and rb (16 columns) dotted with the same rows
// and columns of a 16-column box, each summed over the quad.
__device__ __forceinline__ void row_dots16(const float (&a)[8], const uint8_t* box, int ra,
                                           int rb, int c0, float& da, float& db) {
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = q % 2 ? rb : ra;
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        box + tc::swizzled32(row, 8 * (q / 2) + c0)));
    const float d = fmaf(a[2 * q], v.x, a[2 * q + 1] * v.y);
    if (q % 2) sb += d; else sa += d;
  }
  sa += __shfl_xor_sync(tcb::kFull, sa, 1);
  sb += __shfl_xor_sync(tcb::kFull, sb, 1);
  sa += __shfl_xor_sync(tcb::kFull, sa, 2);
  sb += __shfl_xor_sync(tcb::kFull, sb, 2);
  da = sa;
  db = sb;
}

// PW, PE, PS, PH, PU: bf16 parts of x o w, eh o dy, the scores, H0 and U.
template <int PW, int PE, int PS, int PH, int PU>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_wgmma_n16_kernel(const __grid_constant__ tcb::Params p) {
  static_assert(PH + PU <= 4, "H0's and U's parts fill at most the parts area");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  float* dts = reinterpret_cast<float*>(sm + kbVec);
  float* cum = dts + kL;
  float* eh = cum + kL;     // exp(cum_t)
  float* wend = eh + kL;    // exp(cum_last - cum_s)
  float* wts = wend + kL;   // wend_s dt_s
  float* y0v = wts + kL;    // y0_t = C_t . (eh_t dy_t H0)
  float* ev = y0v + kL;     // E_s = dt_s x_s . (wend_s U B_s)
  float* ddtd = ev + kL;    // x_s . (dx_s / dt_s)
  float* red = reinterpret_cast<float*>(sm + kbRed);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kbMisc);
  float* clast = reinterpret_cast<float*>(sm + kbMisc + 16);
  float* uhw = reinterpret_cast<float*>(sm + kbMisc + 32);
  const uint32_t sC = tc::smem_u32(sm + kbC), sB = tc::smem_u32(sm + kbB);
  const uint32_t sX = tc::smem_u32(sm + kbX), sDY = tc::smem_u32(sm + kbDY);
  const uint32_t sPub = tc::smem_u32(sm + kbPub), sParts = tc::smem_u32(sm + kbParts);
  const uint32_t sLast = tc::smem_u32(clast);
  uint8_t* const xb = sm + kbX;

  const int rank = blockIdx.x, K = gridDim.x;  // the cluster spans grid x
  const int h = blockIdx.y, b = blockIdx.z, g = h / (p.H / p.G);
  const long long bh = static_cast<long long>(b) * p.H + h;
  const float A = p.A[h];
  const int tid = threadIdx.x, wg = tid / kWG, t128 = tid % kWG, warp = tid / 32,
            lane = tid % 32;
  // wgmma's accumulator layout; ta and tb are this thread's rows of the chunk
  const int r0 = (t128 / 32) * 16 + (tid % 32) / 4, c0 = 2 * (tid % 4);
  const int ta = wg * 64 + r0, tb = ta + 8;
  const long long PN = kP * kN;
  auto end_state = [&](int grp) { return p.hcarry + (bh * (p.groups - 1) + grp) * PN; };
  uint32_t phase = 0;  // of the loads' mbarrier

  if (tid == 0) {
    tc::mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto wait_loads = [&]() {
    tc::mbar_wait(full, phase);
    phase ^= 1;
  };

  // The end states of groups 0 .. groups - 2, walked forward (every chunk
  // of those groups is whole): the CTA of a group's last chunk writes them.
  for (int grp = 0; grp + 1 < p.groups; ++grp) {
    const int row0 = (grp * K + rank) * kL;
    if (tid == 0) {
      tc::mbar_expect_tx(full, kBox + kBoxS);
      tc::tma_load(&p.tb, sm + kbB, full, 0, row0, g, b);
      tc::tma_load(&p.tx, xb, full, 0, row0, h, b);
    }
    tcb::decays(dts, p.dt + b * p.dt_sb + h, p.dt_ss, row0, kL, A, tid);
    wait_loads();
    if (wg == 0) {
      float inc[8];
      tc::chunk_increment<PW>(inc, sB, sX, wts, 0, c0);
      tcb::publish<kWG>(sm + kbPub, inc, t128);
    }
    if (tid == 0) *clast = cum[kL - 1];
    tc::cluster_sync();
    if (rank == K - 1 && wg == 0) {
      float hp[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) hp[j] = 0.f;
      const float run = tcb::combine<kWG>(hp, sPub, sLast, rank - 1, -1, rank, t128);
      const float* carry = grp == 0 ? (p.h0 ? p.h0 + bh * PN : nullptr) : end_state(grp - 1);
      if (carry != nullptr) add_state(hp, carry, expf(run), r0, c0);
      store_state(end_state(grp), hp, expf(cum[kL - 1]), sm + kbPub, t128, r0, c0);
    }
    tc::cluster_sync();
    tc::fence_proxy_async();
    __syncthreads();
  }

  // Every group of chunks in reverse: the exchange, then the chunk's
  // gradients.
  for (int grp = p.groups - 1; grp >= 0; --grp) {
    const int c = grp * K + rank;
    const bool active = c < p.chunks;  // uniform over the CTA
    const int nact = min(K, p.chunks - grp * K);
    const int row0 = c * kL;
    const int len = active ? min(kL, p.S - row0) : 0;
    if (active) {
      if (tid == 0) {  // once the group before is done with the boxes
        tc::mbar_expect_tx(full, 2 * kBox + 2 * kBoxS);
        tc::tma_load(&p.tc, sm + kbC, full, 0, row0, g, b);
        tc::tma_load(&p.tb, sm + kbB, full, 0, row0, g, b);
        tc::tma_load(&p.tx, xb, full, 0, row0, h, b);
        tc::tma_load(&p.tdy, sm + kbDY, full, 0, row0, h, b);
      }
      tcb::decays(dts, p.dt + b * p.dt_sb + h, p.dt_ss, row0, len, A, tid);
      wait_loads();
      float inc[8];
      if (wg == 0)
        tc::chunk_increment<PW>(inc, sB, sX, wts, 0, c0);  // h_inc = (x o wend dt)^T B
      else
        tc::chunk_increment<PE>(inc, sC, sDY, eh, 0, c0);  // u_inc = (eh o dy)^T C
      tcb::publish<kWG>(sm + kbPub + wg * kPub, inc, t128);
      if (tid == 0) *clast = cum[kL - 1];
    }
    tc::cluster_sync();  // every increment of the group is published

    // H0 by prefix and U by suffix combination, each warpgroup both
    float hp[8], up[8];
    if (active) {
#pragma unroll
      for (int j = 0; j < 8; ++j) hp[j] = up[j] = 0.f;
      float run = tcb::combine<kWG>(hp, sPub, sLast, rank - 1, -1, rank, t128);
      const float* carry = grp == 0 ? (p.h0 ? p.h0 + bh * PN : nullptr) : end_state(grp - 1);
      if (carry != nullptr) add_state(hp, carry, expf(run), r0, c0);
      run = tcb::combine<kWG>(up, sPub + kPub, sLast, rank + 1, 1, nact - 1 - rank, t128);
      const float* ucarry = grp == p.groups - 1 ? p.dh : p.dh0;
      if (ucarry != nullptr) add_state(up, ucarry + bh * PN, expf(run), r0, c0);
    }
    tc::cluster_sync();  // every read of the group's increments and carries is done

    if (active) {
      if (wg == 0) {
        float uh = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) uh = fmaf(up[j], hp[j], uh);
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) uh += __shfl_xor_sync(tcb::kFull, uh, m);
        if (lane == 0) uhw[warp] = uh;
        state_parts<PH>(sm + kbParts, hp, r0, c0);
      } else {
        // the group's first chunk: dL/dh at its start, d U + u_inc, to dh0
        // (the earlier group's carry, or the result)
        if (rank == 0)
          store_state(p.dh0 + bh * PN, up, expf(cum[kL - 1]), sm + kbPub + kPub, t128, r0, c0);
        state_parts<PU>(sm + kbParts + PH * kState, up, r0, c0);
      }
      tc::fence_proxy_async();  // the parts are read by wgmma
      __syncthreads();
      const uint32_t sH0 = sParts, sU = sParts + PH * kState;

      const float dta = dts[ta], dtb = dts[tb];
      const long long first = (static_cast<long long>(b) * p.S + row0) * p.H + h;  // (b, row0, h)
      const long long part_rows = static_cast<long long>(p.H) * kN;  // the partials' row stride

      // dx = dt o (M1^T dy + wend o (B U^T)): rows s = ta, tb
      {
        float acc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[j] = 0.f;
        tc::fence_regs(acc);
        tc::wgmma_fence();
#pragma unroll
        for (int part = 0; part < PU; ++part)
          tc::wgmma_ss_n64(acc, tc::desc32(sB + wg * 64 * 32, 16, 256),
                           tc::desc32(sU + part * kState, 16, 256));
        tc::wgmma_commit();
        tc::wgmma_wait_all();
        tc::fence_regs(acc);
        tcb::scale_rows(acc, wend[ta], wend[tb]);
        float ea, eb;
        tcb::row_dots(acc, xb, ta, tb, c0, ea, eb);
        if ((tid & 3) == 0) {
          ev[ta] = dta * ea;
          ev[tb] = dtb * eb;
        }
        for (int k = 2 * wg; k < 4; ++k) {  // the slices of columns t >= the rows
          const int v0 = 32 * k;
          float s[16];
          score16(s, sB + wg * 64 * 32, sC + v0 * 32);  // B C^T: rows s, columns t
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int row = (j / 2) % 2 ? tb : ta, t = v0 + 8 * (j / 4) + c0 + (j % 2);
            s[j] = t >= row ? s[j] * __expf(cum[t] - cum[row]) : 0.f;
          }
          uint32_t ga[PS][2][4];
          tcb::fragments<PS>(ga, s);
          tc::fence_regs(acc);
          tc::wgmma_fence();
          tcb::slice_product<PS>(acc, ga, sDY, v0);
          tc::wgmma_commit();
          tc::wgmma_wait_all();
          tc::fence_regs(acc);
        }
        float xa, xbv;
        tcb::row_dots(acc, xb, ta, tb, c0, xa, xbv);
        if ((tid & 3) == 0) {
          ddtd[ta] = xa;
          ddtd[tb] = xbv;
        }
        __nv_bfloat16* dx = p.dx + first * kP;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int row = q % 2 ? tb : ta;
          const float f = q % 2 ? dtb : dta;
          if (row < len)
            *reinterpret_cast<__nv_bfloat162*>(dx + row * static_cast<long long>(p.H) * kP +
                                               8 * (q / 2) + c0) =
                __floats2bfloat162_rn(f * acc[2 * q], f * acc[2 * q + 1]);
        }
      }

      // dB = dt o (M2^T C + wend o (x U)): rows s, the head's partial
      {
        float lo[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) lo[j] = 0.f;
        tc::fence_regs(lo);
        tc::wgmma_fence();
        state_product16<PU>(lo, sX, sU, wg);
        tc::wgmma_commit();
        tc::wgmma_wait_all();
        tc::fence_regs(lo);
        tcb::scale_rows(lo, wend[ta], wend[tb]);
        for (int k = 2 * wg; k < 4; ++k) {
          const int v0 = 32 * k;
          float s[16];
          tcb::score<kP / 16>(s, sX, sDY, wg, v0);  // x dy^T: rows s, columns t
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int row = (j / 2) % 2 ? tb : ta, t = v0 + 8 * (j / 4) + c0 + (j % 2);
            s[j] = t >= row ? s[j] * __expf(cum[t] - cum[row]) : 0.f;
          }
          uint32_t ga[PS][2][4];
          tcb::fragments<PS>(ga, s);
          tc::fence_regs(lo);
          tc::wgmma_fence();
          slice_product16<PS>(lo, ga, sC, v0);
          tc::wgmma_commit();
          tc::wgmma_wait_all();
          tc::fence_regs(lo);
        }
        tcb::scale_rows(lo, dta, dtb);
        tcb::store_half(p.dB_part + first * kN, part_rows, lo, ta, tb, c0, len);
      }

      // dC = eh o (dy H0) + (M2 o dt) B: rows t, as dB.  Q beside M2, and
      // da's pair sums from it
      {
        float lo[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) lo[j] = 0.f;
        tc::fence_regs(lo);
        tc::wgmma_fence();
        state_product16<PH>(lo, sDY, sH0, wg);
        tc::wgmma_commit();
        tc::wgmma_wait_all();
        tc::fence_regs(lo);
        tcb::scale_rows(lo, eh[ta], eh[tb]);
        {
          float ya, yb;
          row_dots16(lo, sm + kbC, ta, tb, c0, ya, yb);
          if ((tid & 3) == 0) {
            y0v[ta] = ya;
            y0v[tb] = yb;
          }
        }
        float* wred = red + warp * kL;
        for (int s_ = lane; s_ < kL; s_ += 32) wred[s_] = 0.f;  // columns past the rows stay 0
        __syncwarp();
        float run_a = 0.f, run_b = 0.f;
        for (int k = 0; k < 2 * (wg + 1); ++k) {  // the slices of columns u <= the rows
          const int v0 = 32 * k;
          float s[16], q[16];
          tcb::score<kP / 16>(s, sDY, sX, wg, v0);  // dy x^T: rows t, columns u
          score16(q, sC + wg * 64 * 32, sB + v0 * 32);  // C B^T
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int row = (j / 2) % 2 ? tb : ta, u = v0 + 8 * (j / 4) + c0 + (j % 2);
            if (u <= row) {
              s[j] *= __expf(cum[row] - cum[u]) * dts[u];
              q[j] *= s[j];
            } else {
              s[j] = 0.f;
              q[j] = 0.f;
            }
          }
          uint32_t ga[PS][2][4];
          tcb::fragments<PS>(ga, s);
          tc::fence_regs(lo);
          tc::wgmma_fence();
          slice_product16<PS>(lo, ga, sB, v0);
          tc::wgmma_commit();
          tcb::pair_sums(q, run_a, run_b, ta, tb, v0, c0, lane, wred);  // beside the products
          tc::wgmma_wait_all();
          tc::fence_regs(lo);
        }
        tcb::store_half(p.dC_part + first * kN, part_rows, lo, ta, tb, c0, len);
      }
      __syncthreads();  // y0, E, x.(dx/dt), the pair sums and U.H0 are written

      // da, ddt and this chunk's share of dA: one warp, rows 4 lane .. + 3
      if (warp == 0) {
        float uh = 0.f;
        for (int w = 0; w < 4; ++w) uh += uhw[w];
        const float tail = eh[kL - 1] * uh;
        float y[4], e[4], dq[4];
        float ys = 0.f, es = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s_ = 4 * lane + j;
          y[j] = y0v[s_];
          e[j] = ev[s_];
          dq[j] = 0.f;
          for (int w = 0; w < 8; ++w) dq[j] += red[w * kL + s_];
          ys += y[j];
          es += e[j];
        }
        float ysuf = ys, epre = es;  // inclusive suffix / prefix over the lanes
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const float oy = __shfl_down_sync(tcb::kFull, ysuf, d);
          const float oe = __shfl_up_sync(tcb::kFull, epre, d);
          if (lane + d < 32) ysuf += oy;
          if (lane >= d) epre += oe;
        }
        float yrun = __shfl_down_sync(tcb::kFull, ysuf, 1);
        float erun = __shfl_up_sync(tcb::kFull, epre, 1);
        if (lane == 31) yrun = 0.f;
        if (lane == 0) erun = 0.f;
        float da[4];
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          yrun += y[j];
          da[j] = yrun;  // sum_{t >= s} y0_t
        }
        float dap = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s_ = 4 * lane + j;
          da[j] += erun + tail + dq[j];
          erun += e[j];
          if (s_ < len) p.ddt[first + s_ * static_cast<long long>(p.H)] = fmaf(A, da[j], ddtd[s_]);
          dap = fmaf(dts[s_], da[j], dap);
        }
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) dap += __shfl_xor_sync(tcb::kFull, dap, m);
        if (lane == 0) p.dA_part[(static_cast<long long>(b) * p.chunks + c) * p.H + h] = dap;
      }
    }
    tc::fence_proxy_async();
    __syncthreads();  // shared memory is free for the next group's loads
  }
}

template <int PW, int PE, int PS, int PH, int PU>
cudaError_t launch_bwd(const tcb::Params& p, int cluster, void* dB, void* dC, float* dA,
                       cudaStream_t s) {
  auto kernel = ssd_bwd_wgmma_n16_kernel<PW, PE, PS, PH, PU>;
  static const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kbSmem);
  if (set != cudaSuccess) return set;
  const cudaError_t err = tc::launch_clusters(kernel, p, kbSmem, cluster, p.H, p.batch, s);
  return err != cudaSuccess ? err : tcb::sums(p, kN, dB, dC, dA, s);
}

}  // namespace n16

}  // namespace

extern "C" {

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rt_ssd_scan(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                const void* C, const void* h0, void* y, void* hout, int batch, int S, int H,
                int P, int G, int N, int chunk, long long x_sb, long long x_ss, long long x_sh,
                long long dt_sb, long long dt_ss, long long b_sb, long long b_ss, long long b_sg,
                long long c_sb, long long c_ss, long long c_sg, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || chunk <= 0 || chunk > kMaxChunk ||
      P <= 0 || P > kMaxP || N <= 0 || N > kMaxN || batch > 65535)
    return cudaErrorInvalidValue;
  const Args a{x,    static_cast<const float*>(dt), static_cast<const float*>(A), Bm, C,
               static_cast<const float*>(h0), y, static_cast<float*>(hout), S, H, P, G, N,
               chunk, x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float>(a, batch, s);
    case kBFloat16: return launch<__nv_bfloat16>(a, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

// The tensor-core kernels: bf16 x [B,S,H,64] and B, C [B,S,G,N] at N 128
// (ssd_wgmma_kernel) or 16 (namespace n16), element strides (batch, seq,
// head or group) and unit last stride, base pointers and strides 16-byte
// aligned (TMA); dt, A, h0, y, hout as rt_ssd_scan's, chunk 128.  cluster:
// the CTAs of a (batch, head), 1 to min(chunks, 8); parts: 100 (G parts) +
// 10 (x o w parts) + (h parts), an instantiated variant of that width
// (kernels/ssd_scan.py: PARTS_VARIANTS, PARTS_N16_VARIANTS).
int rt_ssd_scan_wgmma(const void* x, const void* dt, const void* A, const void* Bm,
                      const void* C, const void* h0, void* y, void* hout, int batch, int S,
                      int H, int G, int N, int cluster, int parts, long long x_sb, long long x_ss,
                      long long x_sh, long long dt_sb, long long dt_ss, long long b_sb,
                      long long b_ss, long long b_sg, long long c_sb, long long c_ss,
                      long long c_sg, void* stream) {
  const int chunks = S > 0 ? (S + tc::kL - 1) / tc::kL : 0;
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || batch > 65535 || H > 65535 ||
      cluster < 1 || cluster > tc::kMaxCluster || cluster > chunks ||
      (N != tc::kN && N != n16::kN))
    return cudaErrorInvalidValue;
  tc::Params p{};
  if (!tc::encode(&p.tx, x, tc::kP, S, H, batch, x_ss, x_sh, x_sb) ||
      !tc::encode(&p.tb, Bm, N, S, G, batch, b_ss, b_sg, b_sb) ||
      !tc::encode(&p.tc, C, N, S, G, batch, c_ss, c_sg, c_sb) ||
      !tc::encode(&p.ty, y, tc::kP, S, H, batch, static_cast<long long>(H) * tc::kP, tc::kP,
                  static_cast<long long>(S) * H * tc::kP))
    return cudaErrorInvalidValue;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.h0 = static_cast<const float*>(h0);
  p.hout = static_cast<float*>(hout);
  p.dt_sb = dt_sb;
  p.dt_ss = dt_ss;
  p.S = S;
  p.H = H;
  p.G = G;
  p.chunks = chunks;
  p.groups = (chunks + cluster - 1) / cluster;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == n16::kN) {
    switch (parts) {
      case 111: return n16::launch<1, 1, 1>(p, cluster, batch, s);
      case 121: return n16::launch<1, 2, 1>(p, cluster, batch, s);
      case 222: return n16::launch<2, 2, 2>(p, cluster, batch, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (parts) {
    case 111: return tc::launch<1, 1, 1>(p, cluster, batch, s);
    case 121: return tc::launch<1, 2, 1>(p, cluster, batch, s);
    case 222: return tc::launch<2, 2, 2>(p, cluster, batch, s);
    case 333: return tc::launch<3, 3, 3>(p, cluster, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward (namespace bwd): x, dt, A, Bm, C, h0 and their strides as
// rt_ssd_scan's; dy [B,S,H,P] contiguous of x's dtype or null; dh [B,H,P,N]
// or null.  Writes dx [B,S,H,P] (x's dtype), ddt [B,S,H], dA [H], dB and dC
// [B,S,G,N] (x's dtype), dh0 [B,H,P,N], all contiguous, through the float32
// scratch dA_part [B,H], dB_part and dC_part [B,S,H,N] and hs
// [B,H,ceil(S/32),P,N].
int rt_ssd_scan_bwd(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                    const void* C, const void* h0, const void* dy, const void* dh, void* dx,
                    void* ddt, void* dA, void* dB, void* dC, void* dh0, void* dA_part,
                    void* dB_part, void* dC_part, void* hs, int batch, int S, int H, int P,
                    int G, int N, long long x_sb, long long x_ss, long long x_sh,
                    long long dt_sb, long long dt_ss, long long b_sb, long long b_ss,
                    long long b_sg, long long c_sb, long long c_ss, long long c_sg,
                    void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || batch > 65535)
    return cudaErrorInvalidValue;
  const bwd::Args a{x,
                    static_cast<const float*>(dt),
                    static_cast<const float*>(A),
                    Bm,
                    C,
                    static_cast<const float*>(h0),
                    dy,
                    static_cast<const float*>(dh),
                    dx,
                    static_cast<float*>(ddt),
                    static_cast<float*>(dA_part),
                    static_cast<float*>(dB_part),
                    static_cast<float*>(dC_part),
                    static_cast<float*>(dh0),
                    static_cast<float*>(hs),
                    S, H, P, G, N,
                    x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dAf = static_cast<float*>(dA);
  switch (dtype) {
    case kFloat32: return bwd::launch<float>(a, batch, dB, dC, dAf, s);
    case kBFloat16: return bwd::launch<__nv_bfloat16>(a, batch, dB, dC, dAf, s);
    default: return cudaErrorInvalidValue;
  }
}

// The tensor-core backwards (namespace tcb at N 128, n16 at N 16): bf16
// x [B,S,H,64], B and C [B,S,G,N] with element strides (batch, seq, head or
// group), unit last stride, base pointers and strides 16-byte aligned
// (TMA); dy [B,S,H,64] bf16 contiguous; dt, A, h0 (or null), dh (or null)
// as rt_ssd_scan_bwd's.  Writes dx [B,S,H,64] and dB, dC [B,S,G,N] (bf16),
// ddt [B,S,H], dA [H] and dh0 [B,H,64,N] (float32), all contiguous, through
// the float32 scratch dA_part [B,ceil(S/128),H], dB_part and dC_part
// [B,S,H,N] and, when the cluster holds fewer CTAs than the chunks, hcarry
// [B,H,groups-1,64,N].  cluster: the CTAs of a (batch, head), 1 to
// min(chunks, 8); parts: the five part counts (x o w, eh o dy, scores, H0,
// U) as decimal digits, an instantiated variant of that width
// (kernels/ssd_scan.py: BWD_PARTS_VARIANTS, BWD_PARTS_N16_VARIANTS).
int rt_ssd_scan_bwd_wgmma(const void* x, const void* dt, const void* A, const void* Bm,
                          const void* C, const void* h0, const void* dy, const void* dh,
                          void* dx, void* ddt, void* dA, void* dB, void* dC, void* dh0,
                          void* dA_part, void* dB_part, void* dC_part, void* hcarry, int batch,
                          int S, int H, int G, int N, int cluster, int parts, long long x_sb,
                          long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
                          long long b_sb, long long b_ss, long long b_sg, long long c_sb,
                          long long c_ss, long long c_sg, void* stream) {
  const int chunks = S > 0 ? (S + tc::kL - 1) / tc::kL : 0;
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || batch > 65535 || H > 65535 ||
      cluster < 1 || cluster > tc::kMaxCluster || cluster > chunks || dy == nullptr ||
      (N != tc::kN && N != n16::kN))
    return cudaErrorInvalidValue;
  const int groups = (chunks + cluster - 1) / cluster;
  if (groups > 1 && hcarry == nullptr) return cudaErrorInvalidValue;
  tcb::Params p{};
  const long long hp = static_cast<long long>(H) * tc::kP;
  if (!tc::encode(&p.tx, x, tc::kP, S, H, batch, x_ss, x_sh, x_sb) ||
      !tc::encode(&p.tdy, dy, tc::kP, S, H, batch, hp, tc::kP, static_cast<long long>(S) * hp) ||
      !tc::encode(&p.tb, Bm, N, S, G, batch, b_ss, b_sg, b_sb) ||
      !tc::encode(&p.tc, C, N, S, G, batch, c_ss, c_sg, c_sb))
    return cudaErrorInvalidValue;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.h0 = static_cast<const float*>(h0);
  p.dh = static_cast<const float*>(dh);
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.ddt = static_cast<float*>(ddt);
  p.dB_part = static_cast<float*>(dB_part);
  p.dC_part = static_cast<float*>(dC_part);
  p.dA_part = static_cast<float*>(dA_part);
  p.dh0 = static_cast<float*>(dh0);
  p.hcarry = static_cast<float*>(hcarry);
  p.dt_sb = dt_sb;
  p.dt_ss = dt_ss;
  p.S = S;
  p.H = H;
  p.G = G;
  p.chunks = chunks;
  p.groups = groups;
  p.batch = batch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dAf = static_cast<float*>(dA);
  if (N == n16::kN) {
    switch (parts) {
      case 11111: return n16::launch_bwd<1, 1, 1, 1, 1>(p, cluster, dB, dC, dAf, s);
      case 22222: return n16::launch_bwd<2, 2, 2, 2, 2>(p, cluster, dB, dC, dAf, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (parts) {
    case 11111: return tcb::launch<1, 1, 1, 1, 1>(p, cluster, dB, dC, dAf, s);
    case 22222: return tcb::launch<2, 2, 2, 2, 2>(p, cluster, dB, dC, dAf, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
