// Hopper (sm_90a) flash-attention forward, with a plain C interface.
//
// Replaces flash_attention_call (src/repro/kernels/flash_attention.py:96):
// online-softmax attention of q [B,Hq,Sq,D] against k, v [B,Hkv,Skv,D] with
// GQA (query head h reads kv head h / (Hq/Hkv), the TPU kernel's index map
// (bh % Hq) // group: K and V are never repeated in memory), causal masking
// at a global q_offset, an optional sliding window and logit soft-cap,
// float32 accumulation, fully masked kv tiles skipped, a zero-row guard
// (a row that sees no key gives zeros) and ragged Sq / Skv.
//
// Translation.  The TPU kernel carries acc, m and l in VMEM scratch across
// a sequential ("arbitrary") kv grid axis; Hopper blocks run in no order, so
// ONE BLOCK per (batch, q head, 64-row q tile) loops over the kv tiles
// itself, with acc in registers and m, l per row.  The TPU's block skip
// (flash_attention.py:47-53) becomes the loop's bounds, computed from
// q_offset, the window and kv_valid; the wrapper's padding (:116-124)
// becomes masked loads (rows past Sq or Skv read as zeros) and a bounded
// store.  q, k, v and the output are addressed through (b, h, s) strides
// with unit stride along D, so the model's [B,S,H,D] tensors are passed as
// views with no transpose copy.
//
// Bound.  At gemma3-1b's prefill (B 4, Hq 4, Hkv 1, S 1024, D 256, bf16)
// the function needs 8.6 GFLOP on a global layer (the causal triangle) and
// 6.45 GFLOP on a local one (window 512), and moves 21 MB: operations
// bound it, 8.7 us at the bf16 tensor-core peak of 989 TFLOP/s.  This
// first design computes on CUDA cores in float32 (the redesign with
// wgmma and TMA is later work), so it is expected tens of times above
// that bound.
//
// Tiles, and why.  head_dim 256 sizes everything: a 64 x 256 float32
// accumulator is 64 KB, so 256 threads hold 64 values each in registers
// (4 rows x 16 columns); q, k and v tiles are staged in shared memory as
// float32 (converted once, when loaded), q 64 x 256 (65 KB), k and v 32 x
// 256 each (33 KB each), plus the 64 x 32 probabilities (9 KB): 139 KB at
// D = 256, one block per SM.  A kv tile of 32 rows keeps that under the
// 227 KB a block may use; 64 q rows keep the accumulator's registers under
// the 255-per-thread limit.  Rows are padded by 4 floats so that 16-byte
// reads of different rows fall in different banks.  Each thread computes a
// 4 x 2 block of the scores with 16-byte reads along D, reduces a row's max
// and sum over the 16 threads that share it with shuffles, and adds
// P V into its 4 x 16 accumulator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kBQ = 64;       // q rows of a block
constexpr int kBK = 32;       // kv rows of a tile
constexpr int kThreads = 256;
constexpr int kPad = 4;       // floats of padding per staged row
constexpr float kNegInf = -1e30f;

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, Sq, Skv, group;
  int64_t qsb, qsh, qss;  // element strides of q (batch, head, seq)
  int64_t ksb, ksh, kss;
  int64_t vsb, vsh, vss;
  int64_t osb, osh, oss;
  float scale, softcap;   // softcap 0: off
  int causal, has_window, window, q_offset;
};

// Stage `rows` rows of D elements (row r at src + r * stride, zeros at and
// past `valid`) into smem rows of D + kPad floats.  kVec: 16-byte loads.
template <typename T, int D, bool kVec>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t stride, int rows,
                                      int valid) {
  constexpr int kCh = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kPerRow = D / kCh;
  for (int c = threadIdx.x; c < rows * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * kCh;
    float* d = dst + r * (D + kPad) + col;
    if (r < valid) {
      const T* s = src + r * stride + col;
      if constexpr (kVec) {
        T buf[kCh];
        *reinterpret_cast<uint4*>(buf) = *reinterpret_cast<const uint4*>(s);
#pragma unroll
        for (int e = 0; e < kCh; ++e) d[e] = to_float(buf[e]);
      } else {
        d[0] = to_float(s[0]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kCh; ++e) d[e] = 0.f;
    }
  }
}

template <typename T, int D, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(Params p) {
  constexpr int kLd = D + kPad;
  constexpr int kPLd = kBK + kPad;
  constexpr int kVecO = D / 16 < 4 ? D / 16 : 4;  // accumulator columns per group
  constexpr int kGroups = D / (16 * kVecO);
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kLd;
  float* Vs = Ks + kBK * kLd;
  float* Ps = Vs + kBK * kLd;

  const int tx = threadIdx.x & 15;  // score columns tx, tx + 16; output column groups
  const int ty = threadIdx.x >> 4;  // rows ty * 4 .. ty * 4 + 3
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / p.group;
  const T* q = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh + q0 * p.qss;
  const T* k = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* v = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;

  // kv range this block's rows can see (the TPU kernel's block skip)
  const int q_rows = min(kBQ, p.Sq - q0);
  const int qpos_lo = p.q_offset + q0, qpos_hi = p.q_offset + q0 + q_rows - 1;
  int k_lo = 0, k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, qpos_hi + 1);
  if (p.has_window) k_lo = max(k_lo, qpos_lo - p.window + 1);

  stage<T, D, kVec>(Qs, q, p.qss, kBQ, q_rows);

  float acc[4][kGroups][kVecO];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < kVecO; ++e) acc[i][g][e] = 0.f;
  }

  if (k_lo < k_hi) {
    for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
      const int kv_rows = min(kBK, p.Skv - k0);
      __syncthreads();  // the previous tile's K, V, P are consumed
      stage<T, D, kVec>(Ks, k + k0 * p.kss, p.kss, kBK, kv_rows);
      stage<T, D, kVec>(Vs, v + k0 * p.vss, p.vss, kBK, kv_rows);
      __syncthreads();

      // scores of rows ty*4+i, columns tx and tx+16
      float s[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 qv[4], kv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * kLd + d);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          kv[j] = *reinterpret_cast<const float4*>(Ks + (j * 16 + tx) * kLd + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y + qv[i].z * kv[j].z +
                       qv[i].w * kv[j].w;
      }

      // mask, online softmax; a row's 32 columns live on 16 lanes
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = p.q_offset + q0 + ty * 4 + i;
        bool ok[2];
        float rmax = kNegInf;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kpos = k0 + j * 16 + tx;
          float x = s[i][j] * p.scale;
          if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
          ok[j] = kpos < p.Skv && (!p.causal || kpos <= qpos) &&
                  (!p.has_window || kpos > qpos - p.window);
          s[i][j] = x;
          if (ok[j]) rmax = fmaxf(rmax, x);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
        const float m_new = fmaxf(m[i], rmax);
        const float alpha = expf(m[i] - m_new);
        float rsum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float pr = ok[j] ? expf(s[i][j] - m_new) : 0.f;
          Ps[(ty * 4 + i) * kPLd + j * 16 + tx] = pr;
          rsum += pr;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
        l[i] = l[i] * alpha + rsum;
        m[i] = m_new;
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
#pragma unroll
          for (int e = 0; e < kVecO; ++e) acc[i][g][e] *= alpha;
      }
      __syncthreads();

      // acc += P V
#pragma unroll 2
      for (int kk = 0; kk < kBK; kk += 4) {
        float4 pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kPLd + kk);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float* vrow = Vs + (kk + t) * kLd + tx * kVecO;
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            float vv[kVecO];
            if constexpr (kVecO == 4) {
              const float4 f = *reinterpret_cast<const float4*>(vrow + g * 16 * kVecO);
              vv[0] = f.x; vv[1] = f.y; vv[2] = f.z; vv[3] = f.w;
            } else {
#pragma unroll
              for (int e = 0; e < kVecO; ++e) vv[e] = vrow[g * 16 * kVecO + e];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pi = t == 0 ? pv[i].x : t == 1 ? pv[i].y : t == 2 ? pv[i].z : pv[i].w;
#pragma unroll
              for (int e = 0; e < kVecO; ++e) acc[i][g][e] += pi * vv[e];
            }
          }
        }
      }
    }
  }

  // normalise (a row that saw no key keeps zeros) and store rows < Sq
  T* o = static_cast<T*>(p.o) + b * p.osb + h * p.osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= q_rows) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = o + static_cast<int64_t>(q0 + r) * p.oss + tx * kVecO;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < kVecO; ++e) orow[g * 16 * kVecO + e] = from_float<T>(acc[i][g][e] * inv);
  }
}

constexpr size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kBQ + 2 * kBK) * (D + kPad) +
                          static_cast<size_t>(kBQ) * (kBK + kPad));
}

template <typename T, int D, bool kVec>
cudaError_t launch_one(const Params& p, int B, cudaStream_t s) {
  auto kernel = flash_fwd_kernel<T, D, kVec>;
  constexpr size_t smem = smem_bytes(D);
  static const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return set;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, B);
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const Params& p, int B, bool vec, cudaStream_t s) {
  return vec ? launch_one<T, D, true>(p, B, s) : launch_one<T, D, false>(p, B, s);
}

template <typename T>
cudaError_t launch_t(const Params& p, int B, int D, bool vec, cudaStream_t s) {
  switch (D) {
    case 16: return launch_d<T, 16>(p, B, vec, s);
    case 32: return launch_d<T, 32>(p, B, vec, s);
    case 64: return launch_d<T, 64>(p, B, vec, s);
    case 128: return launch_d<T, 128>(p, B, vec, s);
    case 256: return launch_d<T, 256>(p, B, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, o: element strides (batch, head, seq) each, unit stride along D;
// o has q's shape and dtype.  window < 0: no window; softcap 0: off.
int rt_flash_attention(int dtype, const void* q, const void* k, const void* v, void* o, int B,
                       int Hq, int Hkv, int Sq, int Skv, int D, long long qsb, long long qsh,
                       long long qss, long long ksb, long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss, long long osb,
                       long long osh, long long oss, float scale, float softcap, int causal,
                       int window, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hq <= 0 || Hkv <= 0 || Hq % Hkv || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, Hq, Sq, Skv, Hq / Hkv, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
           osb, osh, oss, scale, softcap, causal, window >= 0, window < 0 ? 0 : window,
           q_offset};
  const int ch = dtype == kBFloat16 ? 8 : 4;  // elements of a 16-byte load
  bool vec = D % ch == 0;
  for (const void* ptr : {q, k, v})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (long long st : {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss}) vec = vec && st % ch == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kFloat32: err = launch_t<float>(p, B, D, vec, s); break;
    case kBFloat16: err = launch_t<__nv_bfloat16>(p, B, D, vec, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
