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
// What bounds it: per chunk of 128 rows at P = 64, N = 128 the four products
// need ~7.4 MFLOP (C B^T and G x over the causal triangle only) against
// ~50 KB of input, so the kernel is bound by operations (float32, outside
// the tensor cores) and not by bytes.  This
// first design is plain CUDA-core float32 FMA:
//   * one CTA of 256 threads per (head, batch) walks the chunks in order --
//     the sequential grid axis of the TPU kernel becomes a loop, and the
//     state h stays in shared memory for the whole sequence;
//   * a chunk's x, B (all rows) and C (one 32-row tile at a time) are staged
//     in shared memory in the input dtype (bf16 on the served path), h and a
//     32-row tile of G in float32.  At chunk 128, P 64, N 128 that is 108 KB
//     for bf16 inputs (two CTAs an SM) and 165 KB for float32;
//   * G is built one 32-row tile at a time, only for columns u below the
//     tile's end (causal: 10/16 of the full C B^T at four tiles), and each
//     tile's y rows are finished before the next tile overwrites it;
//   * each thread keeps a 4x4 (G), 4x2 (y) or 8x4 (h) register tile; shared
//     rows that lanes read across are padded to an odd word stride.
// Tensor cores (wgmma), TMA and warp specialisation are for a later PR.
//
// The tail is handled with bounds: the last chunk holds min(chunk, S - c0)
// rows, which gives the y and final h of the reference's call padded with
// dt = 0.  x, B and C are read through strides (x is a slice of the conv
// output); y is written contiguous [B, S, H, P], h0 / h as [B, H, P, N].
// Nothing is allocated; the kernel runs on the caller's stream and the entry
// point returns cudaGetLastError() so the Python wrapper raises on a refused
// launch.

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

}  // extern "C"
