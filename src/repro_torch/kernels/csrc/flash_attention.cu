// Hopper (sm_90a) flash-attention forward and backward, with a plain C
// interface.  The backward (dQ, dK, dV; no Pallas counterpart; a
// tensor-core and a CUDA-core route) is described where its kernels begin,
// after the forward's CUDA-core kernel; for it the
// forward also writes each row's log-sum-exp and, in bf16, its output in
// float32 (serving passes null for both; the tensor-core kernel's serving
// instance, kTrain false, has none of that code).
//
// Replaces flash_attention_call (src/repro/kernels/flash_attention.py:96):
// online-softmax attention of q [B,Hq,Sq,D] against k, v [B,Hkv,Skv,D] with
// GQA (query head h reads kv head h / (Hq/Hkv), the TPU kernel's index map
// (bh % Hq) // group: K and V are never repeated in memory), causal masking
// at a global q_offset, an optional sliding window and logit soft-cap (tanh
// before the mask), float32 softmax statistics and accumulation, fully
// masked kv tiles skipped, a zero-row guard (a row that sees no key gives
// zeros) and ragged Sq / Skv.
//
// Translation.  The TPU kernel carries acc, m and l in VMEM scratch across
// a sequential ("arbitrary") kv grid axis; Hopper blocks run in no order, so
// one block per (batch, q head, q tile) loops over the kv tiles itself, with
// acc in registers and m, l per row.  The TPU's block skip
// (flash_attention.py:47-53) becomes the loop's bounds, computed from
// q_offset, the window and Skv; the wrapper's padding (:116-124) becomes
// zero-filled loads and a bounded store.  q, k, v and the output are
// addressed through (b, h, s) strides with unit stride along D, so the
// model's [B,S,H,D] tensors are passed as views with no transpose copy.
//
// Head dims come in pairs (D, DV): q and k rows of D, v and output rows of
// DV.  They are equal but for multi-head latent attention (deepseek-v3's
// MLA: D 192 = 128 + 64 rope dims, DV 128; its smoke config 48 / 32), where
// S = Q K^T runs over K = 192 (12 wgmma k-steps of 16, three 64-wide TMA
// boxes a row) and P V at N = 128 (m64n128k16), with no padding of q, k or
// v to a common width: the tiles, TMA boxes and shared memory of q and k
// and those of v are sized apart (q 48 KB, the K ring 48 KB, the V ring 32
// KB at 192 / 128).
//
// Two kernels, one rule (the wrapper enforces it): bfloat16 at (64, 64),
// (128, 128), (256, 256) or (192, 128) runs flash_wgmma_kernel on the tensor
// cores; float32, and bfloat16 at (16, 16), (32, 32) or (48, 32), run
// flash_fwd_kernel on CUDA cores.  wgmma in TF32 would not hold float32's
// bound against the plain version (rtol 2e-4).
//
// Bound, on an NVIDIA H100 80GB HBM3 at its 700 W limit (989 TFLOP/s of
// bf16 tensor-core products, 3.35 TB/s).  At gemma3-1b's prefill (B 4, Hq
// 4, Hkv 1, S 1024, D 256, bf16) the function needs 8.60 GFLOP on a global
// layer (the causal triangle) and 6.45 GFLOP on a local one (window 512),
// and moves 21 MB (6.3 us): operations bound it, 8.69 us and 6.52 us.  At
// deepseek-v3's served prefill (B 4, 128 heads with no sharing of K and V, S
// 512, D 192, DV 128) it needs 43.0 GFLOP (43.5 us) and moves 336 MB (100 us):
// bytes bound it.
//
// flash_wgmma_kernel: warp-specialised, one block of 384 threads per
// (batch, q head, 128-row q tile).
// - Warpgroup 2 is the producer.  It gives most of its registers to the
//   consumers (setmaxnreg), and one of its threads loads the block's q rows
//   once and then K and V tiles of 64 rows into a ring of 2 stages with the
//   Tensor Memory Accelerator (TMA), each completing on an mbarrier; the
//   consumers free a stage through a third.  The tensor maps are 4-D over
//   (D, S, H, B) with the views' strides, boxes of 64 x 64 (a
//   128-byte-swizzled box is at most 128 bytes wide, so a 256-wide row is 4
//   boxes), encoded on the host per call.  Rows past Sq or Skv are
//   zero-filled by TMA; the store skips rows past Sq.
// - Warpgroups 0 and 1 are the consumers, 64 q rows each (wgmma's M).  Per
//   kv tile: S = Q K^T as D/16 wgmma m64n64k16 from shared memory (Q and K
//   K-major), the online softmax in registers (scale * log2 e folded, exp2;
//   a row's 64 columns live on the 4 threads of a quad), then O += P V as
//   wgmma m64nDk16 with P from registers and V from shared memory as an
//   MN-major operand (the transpose bit of the descriptor: no transposed
//   copy of V).  Only tiles that cross Skv, the causal diagonal or the
//   window's edge compute the mask; the others skip its arithmetic.
// - P goes to the tensor cores as three bf16 parts, P = p0 + p1 + p2 (each
//   rounding what the ones before left: P to 2^-26), each multiplied by V
//   into the same accumulator.  P rounded once to bf16 (2^-9 of each term)
//   puts about one output in ten more than one bf16 rounding away from the
//   float32 plain version, and two parts (2^-18) still a few per million:
//   outputs near zero whose row attends to few keys
//   (scripts/flash_p_rounding.py).  A tile thus costs twice the products
//   of a one-pass kernel: Q K^T once, P V three times.
// - Registers: 168 a thread at launch; setmaxnreg moves them to 24 in the
//   producer and 240 in the consumers, which hold a 64 x D float32
//   accumulator (D / 2 a thread: 128 at D = 256), S (32) and the P parts
//   (48).  Shared memory at D = 256: q 64 KB, 2 stages of K and V 128 KB,
//   one block an SM.
// - Causal q tiles differ up to 16x in work; blocks take the q tiles
//   heaviest first (the tile index reversed in blockIdx.x).  At the served
//   shape there are B Hq Sq / 128 = 128 blocks on 132 SMs, one wave, so a
//   global layer takes as long as its heaviest block (16 kv tiles against a
//   mean of 8.5).  64-row tiles (256 blocks of one consumer warpgroup,
//   one block an SM) balance the wave better but measured slower on both
//   the global and the local layer (scripts/flash_tile_rows.py): a lone
//   warpgroup leaves the tensor cores idle while it runs its softmax, and
//   each K/V tile is loaded for 64 q rows instead of 128.
// What holds it back from the bound: within a warpgroup the softmax waits
// for S and the next S waits for P V (no intra-warpgroup pipelining), the
// three-part P V, the O rescale every tile, and the global layers'
// one-wave imbalance.
//
// flash_fwd_kernel (CUDA cores, float32 and small head_dims): one block of
// 256 threads per (batch, q head, 64-row q tile) loops over 32-row kv tiles
// staged in shared memory as float32 (rows padded by 4 floats against bank
// conflicts), acc 64 x D in registers (4 rows x D/16 columns a thread);
// each thread computes a 4 x 2 block of the scores, and a row's max and sum
// are reduced over the 16 threads that share it with shuffles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
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
  float* lse;             // [B,Hq,Sq] natural-log log-sum-exp of each row, or null
  float* o32;             // [B,Hq,Sq,DV] the output in float32, or null
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

template <typename T, int D, int DV, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(Params p) {
  constexpr int kLd = D + kPad;    // q and k rows
  constexpr int kLdV = DV + kPad;  // v rows
  constexpr int kPLd = kBK + kPad;
  constexpr int kVecO = DV / 16 < 4 ? DV / 16 : 4;  // accumulator columns per group
  constexpr int kGroups = DV / (16 * kVecO);
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kLd;
  float* Vs = Ks + kBK * kLd;
  float* Ps = Vs + kBK * kLdV;

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
      stage<T, DV, kVec>(Vs, v + k0 * p.vss, p.vss, kBK, kv_rows);
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
          const float* vrow = Vs + (kk + t) * kLdV + tx * kVecO;
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

  // normalise (a row that saw no key keeps zeros) and store rows < Sq;
  // for the backward, each row's L = m + log(l) (-inf without a key) and
  // the output in float32
  T* o = static_cast<T*>(p.o) + b * p.osb + h * p.osh;
  const int64_t row0 = (static_cast<int64_t>(b) * p.Hq + h) * p.Sq + q0;
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
    if (p.lse != nullptr && tx == 0) p.lse[row0 + r] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    if (p.o32 != nullptr) {
      float* frow = p.o32 + (row0 + r) * DV + tx * kVecO;
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int e = 0; e < kVecO; ++e) frow[g * 16 * kVecO + e] = acc[i][g][e] * inv;
    }
  }
}

constexpr size_t smem_bytes(int D, int DV) {
  return sizeof(float) * (static_cast<size_t>(kBQ + kBK) * (D + kPad) +
                          static_cast<size_t>(kBK) * (DV + kPad) +
                          static_cast<size_t>(kBQ) * (kBK + kPad));
}

template <typename T, int D, int DV, bool kVec>
cudaError_t launch_one(const Params& p, int B, cudaStream_t s) {
  auto kernel = flash_fwd_kernel<T, D, DV, kVec>;
  constexpr size_t smem = smem_bytes(D, DV);
  static const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return set;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, B);
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, int DV>
cudaError_t launch_d(const Params& p, int B, bool vec, cudaStream_t s) {
  return vec ? launch_one<T, D, DV, true>(p, B, s) : launch_one<T, D, DV, false>(p, B, s);
}

// (D, DV): the equal pairs, and MLA's 192 / 128 and its smoke config's 48 / 32
template <typename T>
cudaError_t launch_t(const Params& p, int B, int D, int DV, bool vec, cudaStream_t s) {
  if (D == DV) {
    switch (D) {
      case 16: return launch_d<T, 16, 16>(p, B, vec, s);
      case 32: return launch_d<T, 32, 32>(p, B, vec, s);
      case 64: return launch_d<T, 64, 64>(p, B, vec, s);
      case 128: return launch_d<T, 128, 128>(p, B, vec, s);
      case 256: return launch_d<T, 256, 256>(p, B, vec, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (D == 48 && DV == 32) return launch_d<T, 48, 32>(p, B, vec, s);
  if (D == 192 && DV == 128) return launch_d<T, 192, 128>(p, B, vec, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// backward: dQ, dK, dV; two routes, the forward's rule
// ---------------------------------------------------------------------------
//
// No Pallas counterpart: the JAX package differentiates its plain _sdpa with
// XLA (src/repro/models/nn.py:258).  The FlashAttention-2 backward: the
// forward leaves each row's L = log-sum-exp of its scaled, capped logits, so
// P = exp(t - L) is recomputed tile by tile and the [Sq, Skv] matrices never
// reach device memory.  Both routes launch three kernels on one stream, the
// first shared:
// - flash_bwd_dot_kernel: delta = rowsum(dO o O) in float32, a warp a row,
//   from the float32 output (a bf16 O rounded once puts delta 2^-9 off, and
//   rows that see few keys then carry that error into dS = P (dP - delta);
//   the training forward writes O in float32 beside the bf16 result).
// No float atomics and every sum in a fixed order on both routes: two calls
// give the same bits, and a captured call equals the eager one.  A row that
// sees no key (L = -inf) gets P = 0, so zero gradients, never NaN.
//
// Bound (NVIDIA H100 80GB HBM3, 700 W): at gemma3-1b's global layer (B 4, Hq
// 4, Hkv 1, S 1024, D 256, bf16) the function needs five products a visible
// (q, k) pair, 2 (3 D + 2 DV) FLOP: 21.5 GFLOP, 21.7 us on bf16 tensor cores
// (16.1 GFLOP at the local layers' window of 512).
//
// Tensor-core route (namespace tcb, after the forward's tc): bf16 at the
// forward's wgmma pairs, the forward's machinery (TMA maps over (D, S, H, B)
// with 64 x 64 boxes, mbarrier rings, setmaxnreg, wgmma descriptors with the
// MN-major transpose bit).  P and dS are float32 and the tensor cores take
// bf16, so each goes in as two bf16 parts (the second rounds what the first
// left, 2^-17 of each term): one part leaves chip_smoke.py's gradient bound
// 18-44x on every bf16 case, two use under half of it (the CPU emulation,
// tests/test_torch_flash_bwd.py).
// - flash_bwd_dkdv_wgmma_kernel: a cluster of CTAs per (batch, kv head, 64
//   keys), the largest power of two up to 8 dividing the group (gemma3's 4:
//   256 CTAs where one a block would give 64); CTA `rank` walks query heads
//   rank * per .. rank * per + per - 1 of the group in order, and in each the
//   64-row query tiles that can see its keys.  Keys are wgmma's M side, so
//   S^T = K Q^T and dP^T = V dO^T (from shared memory, K-major) land in the
//   accumulator layout and P^T, dS^T feed dV += P^T dO and dK += dS^T Q as
//   register A operands, with dO and Q MN-major B operands (no transposed
//   copies).  Warpgroup 0 owns dK (it computes S^T, dP^T, dS^T), warpgroup 1
//   owns dV (S^T, P^T): at D 256 each accumulator is 128 registers a
//   thread, and neither needs the other's P^T or dS^T, so nothing is
//   exchanged through shared memory and no barrier joins them inside the
//   walk; the cost is S^T computed twice, one product in seven.  (Splitting
//   S^T between the warpgroups and exchanging P^T and dS^T as bf16 parts,
//   FlashAttention-3's layout, would add 8 KB a part a matrix, 32 KB: 226
//   KB at D 256, at the limit, and a barrier between the warpgroups every
//   tile.)  A producer warpgroup streams Q and dO through a ring of 2
//   stages (TMA; rows past Sq zero-filled) while one of its warps stages
//   each tile's L (log2 units, -inf past Sq) and delta.  The per-element
//   pass (P, dS, the mask) runs in an instance chosen per tile, with or
//   without the soft-cap and the mask: the first build, with those
//   branches inside its unrolled loop, took 1.45x as long at gemma3's
//   global layer (scripts/flash_bwd_times.py).  At the end the ring takes
//   the CTA's float32 dK and dV (64 x (D + DV) x 4 bytes, exactly its size;
//   8-float chunks swizzled by row against bank conflicts) and each CTA
//   sums its share of the rows over the cluster's CTAs in rank order
//   through distributed shared memory: no global traffic, no atomics.  Key
//   block 0, the heaviest under a causal mask, is the slowest grid axis:
//   first.
//   Shared memory at D 256: K, V 64 KB, the ring 128 KB: 194 KB.
// - flash_bwd_dq_wgmma_kernel: a block per (batch, q head, 128 query rows),
//   64 a consumer warpgroup, laid out as the forward's tensor-core kernel:
//   q and dO rows loaded once, K and V tiles of 64 through rings (K 2
//   stages, V 1 at D 256 to fit 227 KB, else 2; V's stage is released once
//   dP is done).  Per tile: dP = dO V^T and S = Q K^T, dS in registers (the
//   dK/dV kernel's S and dP recomputed: writing dS would move 33 MB at
//   gemma3's global layer), dQ += scale dS K with K MN-major.
// Registers: 240 a consumer thread (setmaxnreg), which holds a 64 x D float32
// accumulator (128 at D 256), S and dP (64) and the two parts (32).
//
// CUDA-core route (float32 at every pair; bf16 at (16, 16), (32, 32) and
// (48, 32)): wgmma in TF32 would not hold float32's bound.
// - flash_bwd_dkdv_kernel: a block per (batch, kv head, 32 keys).  K and V
//   stay in shared memory; the block walks the group's Hq/Hkv query heads in
//   ascending order and in each the 64-row query tiles that can see its keys
//   (causal, window, q_offset), recomputing s = Q K^T and t = c tanh(s/c),
//   P = exp(t - L), dP = dO V^T, dS = P (dP - delta) (1 - (t/c)^2) (the last
//   factor exactly 1 without a cap), and accumulating dV += P^T dO and dK +=
//   dS^T Q in registers (2 key rows x DV/16 and D/16 columns a thread).  The
//   GQA sum over the group happens in the block, in a fixed order: each
//   block writes its dK, dV rows once.
// - flash_bwd_dq_kernel: a block per (batch, q head, 64 query rows), laid
//   out as the forward's CUDA-core kernel, walks the kv tiles in range and
//   accumulates dQ = scale dS K; it writes dQ once.
//   Seven products a pair on CUDA cores at float32's 67 TFLOP/s.  Shared
//   memory at D = DV = 256: the dK/dV block stages K, V (32 rows), Q, dO (64
//   rows) and P, dS (64 x 32) in float32, 213 KB; the dQ block Q, dO, K, V
//   and dS, 204 KB: one block of 8 warps an SM.

constexpr int kBwdBK = 32;  // keys of a dK/dV block and of a dQ kv tile

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* o;      // the forward's output in float32
  const float* lse;    // [B,Hq,Sq]
  float* delta;        // [B,Hq,Sq]
  void* dq;
  void* dk;
  void* dv;
  int Hq, Hkv, Sq, Skv, group, Dv;
  int64_t qsb, qsh, qss;  // element strides (batch, head, seq)
  int64_t ksb, ksh, kss;
  int64_t vsb, vsh, vss;
  int64_t gsb, gsh, gss;  // dout
  int64_t osb, osh, oss;  // o
  int64_t dqsb, dqsh, dqss;
  int64_t dksb, dksh, dkss;
  int64_t dvsb, dvsh, dvss;
  float scale, softcap;   // softcap 0: off
  int causal, has_window, window, q_offset;
};

// Accumulator columns of a thread over a row of W: tx * kVec + g * 16 kVec.
template <int W>
struct Cols {
  static constexpr int kVec = W / 16 < 4 ? W / 16 : 4;
  static constexpr int kGroups = W / (16 * kVec);
};

template <int V>
__device__ __forceinline__ void load_cols(float (&dst)[V], const float* src) {
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    dst[0] = f.x; dst[1] = f.y; dst[2] = f.z; dst[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) dst[e] = src[e];
  }
}

__device__ __forceinline__ bool bwd_visible(const BwdParams& p, int qpos, int kpos) {
  return kpos < p.Skv && (!p.causal || kpos <= qpos) &&
         (!p.has_window || kpos > qpos - p.window);
}

// s[i][j] = row ty*4+i of A . row j*16+tx of B over W columns (rows of ld floats)
template <int W>
__device__ __forceinline__ void tile_dots(float (&s)[4][2], const float* A, const float* Bm,
                                          int ld, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < W; d += 4) {
    float4 a[4], bv[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * ld + d);
#pragma unroll
    for (int j = 0; j < 2; ++j) bv[j] = *reinterpret_cast<const float4*>(Bm + (j * 16 + tx) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        s[i][j] += a[i].x * bv[j].x + a[i].y * bv[j].y + a[i].z * bv[j].z + a[i].w * bv[j].w;
  }
}

// P and dS of rows ty*4+i (query rows q0 + ...) and columns j*16+tx (keys
// k0 + ...) from the scores s and dP; each row's L and delta in lse, dlt.
__device__ __forceinline__ void probs_and_dscores(const BwdParams& p, const float (&s)[4][2],
                                                  const float (&dp)[4][2],
                                                  const float (&lse)[4],
                                                  const float (&dlt)[4], int q0, int k0,
                                                  int ty, int tx, float (&pr)[4][2],
                                                  float (&ds)[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const int qpos = p.q_offset + row;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kpos = k0 + j * 16 + tx;
      float t = s[i][j] * p.scale;
      float dcap = 1.f;
      if (p.softcap != 0.f) {
        const float th = tanhf(t / p.softcap);
        t = p.softcap * th;
        dcap = 1.f - th * th;
      }
      const bool ok = row < p.Sq && bwd_visible(p, qpos, kpos) && lse[i] != -INFINITY;
      pr[i][j] = ok ? expf(t - lse[i]) : 0.f;
      ds[i][j] = pr[i][j] * (dp[i][j] - dlt[i]) * dcap;
    }
  }
}

template <typename T>
__global__ void flash_bwd_dot_kernel(BwdParams p, int64_t rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (row >= rows) return;
  const int s = static_cast<int>(row % p.Sq);
  const int h = static_cast<int>((row / p.Sq) % p.Hq);
  const int b = static_cast<int>(row / (static_cast<int64_t>(p.Sq) * p.Hq));
  const T* g = static_cast<const T*>(p.dout) + b * p.gsb + h * p.gsh + s * p.gss;
  const float* o = p.o + b * p.osb + h * p.osh + s * p.oss;
  float acc = 0.f;
  for (int c = lane; c < p.Dv; c += 32) acc += to_float(g[c]) * o[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

template <typename T, int D, int DV, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_kernel(BwdParams p) {
  constexpr int kLd = D + kPad, kLdV = DV + kPad, kPLd = kBwdBK + kPad;
  using CD = Cols<D>;
  using CV = Cols<DV>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBwdBK * kLd;
  float* Qs = Vs + kBwdBK * kLdV;
  float* dOs = Qs + kBQ * kLd;
  float* Ps = dOs + kBQ * kLdV;
  float* dSs = Ps + kBQ * kPLd;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // key tile 0 first: under a causal mask it sees the most queries
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kBwdBK;
  const int kv_rows = min(kBwdBK, p.Skv - k0);
  stage<T, D, kVec>(Ks, static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh + k0 * p.kss, p.kss,
                    kBwdBK, kv_rows);
  stage<T, DV, kVec>(Vs, static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh + k0 * p.vss,
                     p.vss, kBwdBK, kv_rows);

  // query rows that can see a key of [k0, k0 + kv_rows)
  const int64_t k_last = k0 + kv_rows - 1;
  int64_t q_lo = 0, q_hi = p.Sq;
  if (p.causal) q_lo = max(q_lo, static_cast<int64_t>(k0) - p.q_offset);
  if (p.has_window) q_hi = min(q_hi, k_last + p.window - p.q_offset);

  float dk[2][CD::kGroups][CD::kVec], dv[2][CV::kGroups][CV::kVec];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int g = 0; g < CD::kGroups; ++g)
#pragma unroll
      for (int e = 0; e < CD::kVec; ++e) dk[i][g][e] = 0.f;
#pragma unroll
    for (int g = 0; g < CV::kGroups; ++g)
#pragma unroll
      for (int e = 0; e < CV::kVec; ++e) dv[i][g][e] = 0.f;
  }

  for (int j = 0; j < p.group && q_lo < q_hi; ++j) {  // the group's heads, ascending
    const int h = hk * p.group + j;
    const T* q = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
    const T* g = static_cast<const T*>(p.dout) + b * p.gsb + h * p.gsh;
    const int64_t row0 = (static_cast<int64_t>(b) * p.Hq + h) * p.Sq;
    for (int q0 = static_cast<int>(q_lo / kBQ) * kBQ; q0 < q_hi; q0 += kBQ) {
      const int q_rows = min(kBQ, p.Sq - q0);
      __syncthreads();  // the previous tile's Q, dO, P, dS are consumed
      stage<T, D, kVec>(Qs, q + static_cast<int64_t>(q0) * p.qss, p.qss, kBQ, q_rows);
      stage<T, DV, kVec>(dOs, g + static_cast<int64_t>(q0) * p.gss, p.gss, kBQ, q_rows);
      float lse[4], dlt[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        lse[i] = r < q_rows ? p.lse[row0 + q0 + r] : -INFINITY;
        dlt[i] = r < q_rows ? p.delta[row0 + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[4][2], dp[4][2], pr[4][2], ds[4][2];
      tile_dots<D>(s, Qs, Ks, kLd, ty, tx);
      tile_dots<DV>(dp, dOs, Vs, kLdV, ty, tx);
      probs_and_dscores(p, s, dp, lse, dlt, q0, k0, ty, tx, pr, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          Ps[(ty * 4 + i) * kPLd + jj * 16 + tx] = pr[i][jj];
          dSs[(ty * 4 + i) * kPLd + jj * 16 + tx] = ds[i][jj];
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: key rows ty*2, ty*2+1, query rows in order
      for (int r = 0; r < q_rows; ++r) {
        const float2 pp = *reinterpret_cast<const float2*>(Ps + r * kPLd + ty * 2);
        const float2 dd = *reinterpret_cast<const float2*>(dSs + r * kPLd + ty * 2);
#pragma unroll
        for (int gg = 0; gg < CV::kGroups; ++gg) {
          float x[CV::kVec];
          load_cols(x, dOs + r * kLdV + tx * CV::kVec + gg * 16 * CV::kVec);
#pragma unroll
          for (int e = 0; e < CV::kVec; ++e) {
            dv[0][gg][e] += pp.x * x[e];
            dv[1][gg][e] += pp.y * x[e];
          }
        }
#pragma unroll
        for (int gg = 0; gg < CD::kGroups; ++gg) {
          float x[CD::kVec];
          load_cols(x, Qs + r * kLd + tx * CD::kVec + gg * 16 * CD::kVec);
#pragma unroll
          for (int e = 0; e < CD::kVec; ++e) {
            dk[0][gg][e] += dd.x * x[e];
            dk[1][gg][e] += dd.y * x[e];
          }
        }
      }
    }
  }

  // each key row written once: dK = scale dS^T Q, dV
  T* dkp = static_cast<T*>(p.dk) + b * p.dksb + hk * p.dksh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dvsb + hk * p.dvsh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty * 2 + i;
    if (r >= kv_rows) continue;
    T* krow = dkp + static_cast<int64_t>(k0 + r) * p.dkss + tx * CD::kVec;
    T* vrow = dvp + static_cast<int64_t>(k0 + r) * p.dvss + tx * CV::kVec;
#pragma unroll
    for (int gg = 0; gg < CD::kGroups; ++gg)
#pragma unroll
      for (int e = 0; e < CD::kVec; ++e)
        krow[gg * 16 * CD::kVec + e] = from_float<T>(dk[i][gg][e] * p.scale);
#pragma unroll
    for (int gg = 0; gg < CV::kGroups; ++gg)
#pragma unroll
      for (int e = 0; e < CV::kVec; ++e) vrow[gg * 16 * CV::kVec + e] = from_float<T>(dv[i][gg][e]);
  }
}

template <typename T, int D, int DV, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(BwdParams p) {
  constexpr int kLd = D + kPad, kLdV = DV + kPad, kPLd = kBwdBK + kPad;
  using CD = Cols<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBQ * kLd;
  float* Ks = dOs + kBQ * kLdV;
  float* Vs = Ks + kBwdBK * kLd;
  float* dSs = Vs + kBwdBK * kLdV;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // the query tiles heaviest first under a causal mask
  const int b = blockIdx.z, h = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int hk = h / p.group;
  const int q_rows = min(kBQ, p.Sq - q0);
  const T* k = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* v = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;
  stage<T, D, kVec>(Qs, static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh + q0 * p.qss, p.qss,
                    kBQ, q_rows);
  stage<T, DV, kVec>(dOs, static_cast<const T*>(p.dout) + b * p.gsb + h * p.gsh + q0 * p.gss,
                     p.gss, kBQ, q_rows);
  const int64_t row0 = (static_cast<int64_t>(b) * p.Hq + h) * p.Sq + q0;
  float lse[4], dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    lse[i] = r < q_rows ? p.lse[row0 + r] : -INFINITY;
    dlt[i] = r < q_rows ? p.delta[row0 + r] : 0.f;
  }

  // kv range this block's rows can see, as the forward's
  const int qpos_lo = p.q_offset + q0, qpos_hi = p.q_offset + q0 + q_rows - 1;
  int k_lo = 0, k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, qpos_hi + 1);
  if (p.has_window) k_lo = max(k_lo, qpos_lo - p.window + 1);

  float acc[4][CD::kGroups][CD::kVec];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < CD::kGroups; ++g)
#pragma unroll
      for (int e = 0; e < CD::kVec; ++e) acc[i][g][e] = 0.f;

  if (k_lo < k_hi) {
    for (int k0 = (k_lo / kBwdBK) * kBwdBK; k0 < k_hi; k0 += kBwdBK) {
      const int kv_rows = min(kBwdBK, p.Skv - k0);
      __syncthreads();  // the previous tile's K, V, dS are consumed
      stage<T, D, kVec>(Ks, k + static_cast<int64_t>(k0) * p.kss, p.kss, kBwdBK, kv_rows);
      stage<T, DV, kVec>(Vs, v + static_cast<int64_t>(k0) * p.vss, p.vss, kBwdBK, kv_rows);
      __syncthreads();

      float s[4][2], dp[4][2], pr[4][2], ds[4][2];
      tile_dots<D>(s, Qs, Ks, kLd, ty, tx);
      tile_dots<DV>(dp, dOs, Vs, kLdV, ty, tx);
      probs_and_dscores(p, s, dp, lse, dlt, q0, k0, ty, tx, pr, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) dSs[(ty * 4 + i) * kPLd + j * 16 + tx] = ds[i][j];
      __syncthreads();

      // dQ += dS K, kv rows in order
#pragma unroll 2
      for (int kk = 0; kk < kBwdBK; kk += 4) {
        float4 dv4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dv4[i] = *reinterpret_cast<const float4*>(dSs + (ty * 4 + i) * kPLd + kk);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float* krow = Ks + (kk + t) * kLd + tx * CD::kVec;
#pragma unroll
          for (int g = 0; g < CD::kGroups; ++g) {
            float x[CD::kVec];
            load_cols(x, krow + g * 16 * CD::kVec);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float di = t == 0 ? dv4[i].x : t == 1 ? dv4[i].y : t == 2 ? dv4[i].z : dv4[i].w;
#pragma unroll
              for (int e = 0; e < CD::kVec; ++e) acc[i][g][e] += di * x[e];
            }
          }
        }
      }
    }
  }

  T* dq = static_cast<T*>(p.dq) + b * p.dqsb + h * p.dqsh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= q_rows) continue;
    T* row = dq + static_cast<int64_t>(q0 + r) * p.dqss + tx * CD::kVec;
#pragma unroll
    for (int g = 0; g < CD::kGroups; ++g)
#pragma unroll
      for (int e = 0; e < CD::kVec; ++e)
        row[g * 16 * CD::kVec + e] = from_float<T>(acc[i][g][e] * p.scale);
  }
}

constexpr size_t bwd_dkdv_smem(int D, int DV) {
  return sizeof(float) * (static_cast<size_t>(kBwdBK + kBQ) * (D + kPad) +
                          static_cast<size_t>(kBwdBK + kBQ) * (DV + kPad) +
                          2 * static_cast<size_t>(kBQ) * (kBwdBK + kPad));
}

constexpr size_t bwd_dq_smem(int D, int DV) {
  return sizeof(float) * (static_cast<size_t>(kBQ + kBwdBK) * (D + kPad) +
                          static_cast<size_t>(kBQ + kBwdBK) * (DV + kPad) +
                          static_cast<size_t>(kBQ) * (kBwdBK + kPad));
}

template <typename T, int D, int DV, bool kVec>
cudaError_t launch_bwd_one(const BwdParams& p, int B, cudaStream_t s) {
  auto dkdv = flash_bwd_dkdv_kernel<T, D, DV, kVec>;
  auto dq = flash_bwd_dq_kernel<T, D, DV, kVec>;
  constexpr size_t smem_kv = bwd_dkdv_smem(D, DV), smem_q = bwd_dq_smem(D, DV);
  static const cudaError_t set = [&] {
    const cudaError_t e = cudaFuncSetAttribute(
        dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_kv));
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem_q));
  }();
  if (set != cudaSuccess) return set;
  const int64_t rows = static_cast<int64_t>(B) * p.Hq * p.Sq;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.Skv > 0) {
    dkdv<<<dim3((p.Skv + kBwdBK - 1) / kBwdBK, p.Hkv, B), kThreads, smem_kv, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  dq<<<dim3((p.Sq + kBQ - 1) / kBQ, p.Hq, B), kThreads, smem_q, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, int DV>
cudaError_t launch_bwd_d(const BwdParams& p, int B, bool vec, cudaStream_t s) {
  return vec ? launch_bwd_one<T, D, DV, true>(p, B, s) : launch_bwd_one<T, D, DV, false>(p, B, s);
}

// the (D, DV) pairs of launch_t
template <typename T>
cudaError_t launch_bwd_t(const BwdParams& p, int B, int D, int DV, bool vec, cudaStream_t s) {
  if (D == DV) {
    switch (D) {
      case 16: return launch_bwd_d<T, 16, 16>(p, B, vec, s);
      case 32: return launch_bwd_d<T, 32, 32>(p, B, vec, s);
      case 64: return launch_bwd_d<T, 64, 64>(p, B, vec, s);
      case 128: return launch_bwd_d<T, 128, 128>(p, B, vec, s);
      case 256: return launch_bwd_d<T, 256, 256>(p, B, vec, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (D == 48 && DV == 32) return launch_bwd_d<T, 48, 32>(p, B, vec, s);
  if (D == 192 && DV == 128) return launch_bwd_d<T, 192, 128>(p, B, vec, s);
  return cudaErrorInvalidValue;
}



// ---------------------------------------------------------------------------
// tensor-core route: bf16, head_dim 64 / 128 / 256
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kRows = 64;                 // q rows of a consumer warpgroup
constexpr int kWG = 2;                    // consumer warpgroups
constexpr int kBM = kRows * kWG;          // q rows of a block
constexpr int kBN = 64;                   // kv rows of a tile
constexpr int kStages = 2;                // K/V ring
constexpr int kThreads = 128 * (kWG + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 24;          // setmaxnreg: 24 x 128 + 240 x 256 =
constexpr int kConsumerRegs = 240;         // the 168 x 384 of the launch
constexpr int kBox = 64 * 64 * 2;         // bytes of one 64 x 64 bf16 TMA box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  CUtensorMap tq, tk, tv;  // (D, S, H, B), boxes of 64 x 64 x 1 x 1, 128-byte swizzle
  __nv_bfloat16* o;
  long long osb, osh, oss;
  int Sq, Skv, group, q_offset;
  int causal, window;                     // window < 0: none
  float scale_log2;                       // scale * log2 e
  float cap_in, cap_out;                  // softcap: cap_out tanh(s cap_in); cap_in 0: off
  int Hq;
  float* lse;                             // [B,Hq,Sq] log-sum-exp (natural log), or null
  float* o32;                             // [B,Hq,Sq,DV] the output in float32, or null
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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

// One 64 x 64 box of a 4-D tensor map at (d, s, h, b) into shared memory.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst, uint64_t* bar, int d,
                                         int s, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d), "r"(s), "r"(h), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout 1 = 128B swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
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

// d[32] += A (64 x 16, K-major, shared) * B (64 x 16, K-major, shared)
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

// d[64] += A (64 x 16, bf16 registers) * B (16 x 128, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TC_D32(0), TC_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[96] += A (64 x 16, bf16 registers) * B (16 x 192, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : TC_D32(0), TC_D32(32), TC_D32(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[128] += A (64 x 16, bf16 registers) * B (16 x 256, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : TC_D32(0), TC_D32(32), TC_D32(64), TC_D32(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef TC_D32
#undef TC_D8

// d[N / 2] += A (64 x 16, bf16 registers) * B (16 x N, MN-major, shared)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, b);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, b);
  else wgmma_rs_n256(d, a, b);
}

// kv tiles [t_lo, t_hi) that q rows [row, row + rows) of a head can see
__device__ __forceinline__ void kv_tiles(const Params& p, int row, int rows, int& t_lo,
                                         int& t_hi) {
  t_lo = t_hi = 0;
  if (rows <= 0) return;
  const int first = p.q_offset + row, last = first + rows - 1;
  const int lo = p.window >= 0 ? max(0, first - p.window + 1) : 0;
  const int hi = p.causal ? min(p.Skv, last + 1) : p.Skv;
  if (lo >= hi) return;
  t_lo = lo / kBN;
  t_hi = (hi + kBN - 1) / kBN;
}

// The consumer warpgroups' part of flash_wgmma_kernel: q and k rows of D
// elements, v rows (and the output's) of DV.
template <int D, int DV, bool kTrain>
__device__ __forceinline__ void consume(const Params& p, uint8_t* sq, uint8_t* sk, uint8_t* sv,
                                        uint64_t* full_q, uint64_t* full_k, uint64_t* full_v,
                                        uint64_t* empty, int q0, int t_lo, int t_hi) {
  constexpr int kTile = 64 * D * 2;    // bytes of 64 q or k rows
  constexpr int kTileV = 64 * DV * 2;  // bytes of 64 v rows
  const int h = blockIdx.y, b = blockIdx.z;
  // warpgroup wg owns q rows [row_w, row_w + 64); in wgmma's
  // accumulator layout this thread holds rows r0 and r0 + 8 and, in each
  // 8-column chunk j of a row, columns 8 j + c0 and 8 j + c0 + 1
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int row_w = q0 + wg * kRows;
  const int r0 = (tid / 32) * 16 + (tid % 32) / 4, c0 = 2 * (tid % 4);
  const int first = p.q_offset + row_w, last = first + kRows - 1;
  const int qpos[2] = {first + r0, first + r0 + 8};
  int w_lo, w_hi;
  kv_tiles(p, row_w, min(kRows, p.Sq - row_w), w_lo, w_hi);

  float o[DV / 2];
#pragma unroll
  for (int j = 0; j < DV / 2; ++j) o[j] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t qa = smem_u32(sq + wg * kTile);
  mbar_wait(full_q, 0);

  for (int t = t_lo; t < t_hi; ++t) {
    const int i = t - t_lo, s = i % kStages;
    const uint32_t par = (i / kStages) & 1;
    if (t < w_lo || t >= w_hi) {  // no row of this warpgroup sees the tile
      mbar_wait(&full_k[s], par);
      mbar_wait(&full_v[s], par);
      mbar_arrive(&empty[s]);
      continue;
    }

    // S = Q K^T over D / 16 steps of 16 (32 bytes within a 128-byte row)
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    const uint32_t ka = smem_u32(sk + s * kTile);
    mbar_wait(&full_k[s], par);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_ss_n64(sc, desc(qa + off, 16, 1024), desc(ka + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // logits in log2 units; the mask only on tiles that cross Skv, the
    // causal diagonal or the window's edge
    if (p.cap_in != 0.f) {
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = p.cap_out * tanhf(sc[j] * p.cap_in);
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] *= p.scale_log2;
    }
    const int k0 = t * kBN;
    if (k0 + kBN > p.Skv || (p.causal && k0 + kBN - 1 > first) ||
        (p.window >= 0 && k0 <= last - p.window)) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = k0 + 8 * (j / 4) + c0 + (j % 2);
        const int qp = qpos[(j / 2) % 2];
        const bool ok = col < p.Skv && (!p.causal || col <= qp) &&
                        (p.window < 0 || col > qp - p.window);
        if (!ok) sc[j] = -INFINITY;
      }
    }

    // online softmax: a row's max and sum over the 4 threads of its quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 32; ++j) mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], sc[j]);
    float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row that saw no key yet
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      sc[j] = exp2f(sc[j] - base[(j / 2) % 2]);
      rs[(j / 2) % 2] += sc[j];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < DV / 2; ++j) o[j] *= alpha[(j / 2) % 2];

    // P as wgmma A fragments in three bf16 parts, P = p0 + p1 + p2 to 2^-26
    // (each part rounds what the ones before left).  Step ks covers kv
    // columns 16 ks .. 16 ks + 15.
    uint32_t pa[3][4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = sc[8 * ks + 2 * r], y = sc[8 * ks + 2 * r + 1];
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          const __nv_bfloat162 v2 = __floats2bfloat162_rn(x, y);
          const float2 f = __bfloat1622float2(v2);
          x -= f.x;
          y -= f.y;
          pa[part][ks][r] = *reinterpret_cast<const uint32_t*>(&v2);
        }
      }
    }

    // O += P V: V's 16 kv rows of a step are 16 x 128 bytes further on;
    // the DV columns span DV / 64 boxes of 64 rows (leading offset kBox)
    const uint32_t va = smem_u32(sv + s * kTileV);
    mbar_wait(&full_v[s], par);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t vd = desc(va + ks * 16 * 128, kBox, 1024);
#pragma unroll
      for (int part = 0; part < 3; ++part) wgmma_rs<DV>(o, pa[part][ks], vd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&empty[s]);
  }

  // normalise (a row that saw no key keeps zeros) and store rows < Sq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* out = p.o + b * p.osb + h * p.osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row_w + r0 + 8 * r;
    if (q >= p.Sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* orow = out + q * p.oss + c0;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    // for the backward (the kTrain instances only: serving's have none of
    // this code): L in natural-log units (m and l are kept in log2 units),
    // -inf for a row that saw no key, and the output in float32
    if constexpr (kTrain) {
      const int64_t row = (static_cast<int64_t>(b) * p.Hq + h) * p.Sq + q;
      if (c0 == 0) p.lse[row] = l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : -INFINITY;
      if (p.o32 != nullptr) {
        float* frow = p.o32 + row * DV + c0;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          *reinterpret_cast<float2*>(frow + 8 * j) =
              make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

template <int D, int DV, bool kTrain>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ Params p) {
  constexpr int kTile = 64 * D * 2;    // bytes of 64 q or k rows: D / 64 boxes side by side
  constexpr int kTileV = 64 * DV * 2;  // bytes of 64 v rows: DV / 64 boxes
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
  uint8_t* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = sq + kWG * kTile;
  uint8_t* sv = sk + kStages * kTile;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sv + kStages * kTileV);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  int t_lo, t_hi;
  kv_tiles(p, q0, min(kBM, p.Sq - q0), t_lo, t_hi);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], kWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWG * 128) {
    // producer warpgroup: it gives its registers to the consumers, and one
    // thread issues every load of the block
    if constexpr (kWG > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kWG * 128) {
      const int hk = h / p.group;
      const int q_wgs = min(kWG, (p.Sq - q0 + kRows - 1) / kRows);  // with rows < Sq
      mbar_expect_tx(full_q, q_wgs * kTile);
      for (int w = 0; w < q_wgs; ++w)
        for (int c = 0; c < D / 64; ++c)
          tma_load(&p.tq, sq + w * kTile + c * kBox, full_q, c * 64, q0 + w * kRows, h, b);
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo, s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
        mbar_expect_tx(&full_k[s], kTile);
        for (int c = 0; c < D / 64; ++c)
          tma_load(&p.tk, sk + s * kTile + c * kBox, &full_k[s], c * 64, t * kBN, hk, b);
        mbar_expect_tx(&full_v[s], kTileV);
        for (int c = 0; c < DV / 64; ++c)
          tma_load(&p.tv, sv + s * kTileV + c * kBox, &full_v[s], c * 64, t * kBN, hk, b);
      }
    }
  } else {
    if constexpr (kWG > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<D, DV, kTrain>(p, sq, sk, sv, full_q, full_k, full_v, empty, q0, t_lo, t_hi);
  }
}

template <int D, int DV>
constexpr int smem_bytes() {
  return (kWG + kStages) * 64 * D * 2 + kStages * 64 * DV * 2 + (1 + 3 * kStages) * 8 + 1024;
}

template <int D, int DV, bool kTrain>
cudaError_t launch_k(const Params& p, int B, int Hq, cudaStream_t s) {
  auto kernel = flash_wgmma_kernel<D, DV, kTrain>;
  static const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D, DV>());
  if (set != cudaSuccess) return set;
  const dim3 grid((p.Sq + kBM - 1) / kBM, Hq, B);
  kernel<<<grid, kThreads, smem_bytes<D, DV>(), s>>>(p);
  return cudaGetLastError();
}

// The training instance (it writes lse and o32) when lse is given, else
// serving's, whose code has no stores of either.
template <int D, int DV>
cudaError_t launch(const Params& p, int B, int Hq, cudaStream_t s) {
  return p.lse != nullptr ? launch_k<D, DV, true>(p, B, Hq, s)
                          : launch_k<D, DV, false>(p, B, Hq, s);
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

// A 4-D map over (D, S, H, B) of a bf16 tensor with element strides (s, h, b).
bool encode(CUtensorMap* map, const void* ptr, int D, int S, int H, int B, long long ss,
            long long sh, long long sb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// backward on the tensor cores: bf16 at the wgmma pairs
// ---------------------------------------------------------------------------
// The design is described where the backward's kernels begin, above.
namespace tcb {

using tc::desc;
using tc::fence_regs;
using tc::kBox;
using tc::mbar_arrive;
using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::smem_u32;
using tc::tma_load;
using tc::wgmma_commit;
using tc::wgmma_fence;
using tc::wgmma_wait_all;

constexpr int kRows = 64;     // keys of a dK/dV block, query rows of a tile: wgmma's M
constexpr int kStages = 2;    // the dK/dV kernel's Q / dO ring
constexpr int kParts = 2;     // bf16 parts of P and of dS
constexpr int kThreads = 384; // two consumer warpgroups and the producer's
constexpr int kMaxCluster = 8;

struct Params {
  CUtensorMap tq, tk, tv, tdo;  // (D or DV, S, H, B), boxes of 64 x 64 x 1 x 1, 128-byte swizzle
  const float* lse;             // [B,Hq,Sq], natural log
  const float* delta;           // [B,Hq,Sq]
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long dqsb, dqsh, dqss, dksb, dksh, dkss, dvsb, dvsh, dvss;
  int Hq, Hkv, Sq, Skv, group, q_offset, causal, window;  // window < 0: none
  int per;                      // query heads a dK/dV CTA walks: group / cluster
  float scale, scale_log2;      // scale, scale * log2 e
  float cap_in, cap_out;        // softcap: cap_out tanh(s cap_in); cap_in 0: off
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.Skv && (!p.causal || kpos <= qpos) && (p.window < 0 || kpos > qpos - p.window);
}

// Whether a 64 x 64 tile of query rows from q0 and keys from k0 crosses Skv,
// the causal diagonal or the window's edge (else every pair is visible).
__device__ __forceinline__ bool edge_tile(const Params& p, int q0, int k0) {
  const int first = p.q_offset + q0;
  return k0 + kRows > p.Skv || (p.causal && k0 + kRows - 1 > first) ||
         (p.window >= 0 && k0 <= first + kRows - 1 - p.window);
}

// The logit in log2 units, and in dcap the soft-cap's derivative factor.
template <bool kCap>
__device__ __forceinline__ float logit2(const Params& p, float s, float& dcap) {
  if constexpr (kCap) {
    const float th = tanhf(s * p.cap_in);
    dcap = 1.f - th * th;
    return p.cap_out * th;
  }
  dcap = 1.f;
  return s * p.scale_log2;
}

// The dK/dV tile's P^T = exp(t - L) of the visible pairs, into sc (kDs
// false), or dS^T = P^T (dP^T - delta) dcap, into dp (kDs true): rows are
// keys from k0, columns queries from q0, each column's L (log2 units) and
// delta in sl, sd.  kEdge: the tile crosses Skv, the diagonal or the
// window's edge (edge_tile), so each pair's mask is computed.  The
// branches on the soft-cap and the edge stay out of the unrolled loop.
template <bool kDs, bool kCap, bool kEdge>
__device__ __forceinline__ void dkdv_scores(const Params& p, float (&sc)[32], float (&dp)[32],
                                            const float* sl, const float* sd, int q0, int k0,
                                            int r0, int c0) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * (j / 4) + c0 + (j % 2);
    const int key = k0 + r0 + 8 * ((j / 2) % 2);
    const float L2 = sl[col];
    float dcap;
    const float t2 = logit2<kCap>(p, sc[j], dcap);
    const bool ok = L2 != -INFINITY && (!kEdge || visible(p, p.q_offset + q0 + col, key));
    const float pr = ok ? exp2f(t2 - L2) : 0.f;
    if constexpr (kDs) dp[j] = pr * (dp[j] - sd[col]) * dcap;
    else sc[j] = pr;
  }
}

// The dQ tile's dS = P (dP - delta) dcap into dp: rows are queries row_w +
// r0 (+ 8), with L (log2 units) and delta in L2, dl; columns keys from k0;
// kCap, kEdge as dkdv_scores'.
template <bool kCap, bool kEdge>
__device__ __forceinline__ void dq_scores(const Params& p, const float (&sc)[32], float (&dp)[32],
                                          const float (&L2)[2], const float (&dl)[2], int row_w,
                                          int k0, int r0, int c0) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int r = (j / 2) % 2;
    const int key = k0 + 8 * (j / 4) + c0 + (j % 2);
    float dcap;
    const float t2 = logit2<kCap>(p, sc[j], dcap);
    const bool ok =
        L2[r] != -INFINITY && (!kEdge || visible(p, p.q_offset + row_w + r0 + 8 * r, key));
    const float pr = ok ? exp2f(t2 - L2[r]) : 0.f;
    dp[j] = pr * (dp[j] - dl[r]) * dcap;
  }
}

// A 64 x 64 accumulator tile (wgmma's layout) as A fragments in kParts bf16
// parts, x = part 0 + part 1 (each part rounds what the ones before left).
// Step ks covers columns 16 ks .. 16 ks + 15.
__device__ __forceinline__ void to_parts(const float (&x)[32], uint32_t (&a)[kParts][4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float u = x[8 * ks + 2 * r], w = x[8 * ks + 2 * r + 1];
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(u, w);
        const float2 f = __bfloat1622float2(v2);
        u -= f.x;
        w -= f.y;
        a[part][ks][r] = *reinterpret_cast<const uint32_t*>(&v2);
      }
    }
  }
}

// acc[N / 2] += (the parts' sum) x B, B a 64-row tile of N columns in
// shared memory (N / 64 boxes) read MN-major: its rows are the product's K.
template <int N>
__device__ __forceinline__ void mma_parts(float (&acc)[N / 2], const uint32_t (&a)[kParts][4][4],
                                          uint32_t b_addr) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t bd = desc(b_addr + ks * 16 * 128, kBox, 1024);
#pragma unroll
    for (int part = 0; part < kParts; ++part) tc::wgmma_rs<N>(acc, a[part][ks], bd);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// d[32] += A B^T over W columns: A and B 64-row tiles (W / 64 boxes each)
// in shared memory, both K-major.  Committed with what follows.
template <int W>
__device__ __forceinline__ void mma_tile(float (&d)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    tc::wgmma_ss_n64(d, desc(a_addr + off, 16, 1024), desc(b_addr + off, 16, 1024));
  }
}

// query tiles [t_lo, t_hi) of a head that can see keys [k0, k0 + 64)
// (the rows of flash_bwd_dkdv_kernel's range, in tiles of 64)
__device__ __forceinline__ void query_tiles(const Params& p, int k0, int& t_lo, int& t_hi) {
  t_lo = t_hi = 0;
  const long long last = min(k0 + kRows, p.Skv) - 1;
  long long lo = 0, hi = p.Sq;
  if (p.causal) lo = max(lo, static_cast<long long>(k0) - p.q_offset);
  if (p.window >= 0) hi = min(hi, last + p.window - p.q_offset);
  if (lo >= hi) return;
  t_lo = static_cast<int>(lo / kRows);
  t_hi = static_cast<int>((hi + kRows - 1) / kRows);
}

// key tiles [t_lo, t_hi) that query rows [row, row + rows) can see
__device__ __forceinline__ void key_tiles(const Params& p, int row, int rows, int& t_lo,
                                          int& t_hi) {
  t_lo = t_hi = 0;
  if (rows <= 0) return;
  const int first = p.q_offset + row, last = first + rows - 1;
  const int lo = p.window >= 0 ? max(0, first - p.window + 1) : 0;
  const int hi = p.causal ? min(p.Skv, last + 1) : p.Skv;
  if (lo >= hi) return;
  t_lo = lo / kRows;
  t_hi = (hi + kRows - 1) / kRows;
}

// Every thread of every CTA of the cluster: shared-memory writes before it
// are seen by reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld_rank4(const float* local, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_u32(local)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Offset of (row, col) in a [64][W] float32 block of the ring (W a
// multiple of 64), its 8-float chunks XOR-swizzled by the row: a warp's
// writes in the accumulator layout (8 rows, 4 column pairs) then conflict
// 2-way in the banks, not 8-way.
template <int W>
__device__ __forceinline__ int red_at(int row, int col) {
  return row * W + (((col / 8) ^ (row % 8)) * 8 + col % 8);
}

// The shared memory of a dK/dV CTA: K and V (64 keys), a ring of Q and dO
// tiles (64 query rows) with each row's L (log2 units) and delta.
template <int D, int DV>
struct DkdvSmem {
  static constexpr int kTileQ = kRows * D * 2;   // bytes of 64 rows of q or k
  static constexpr int kTileO = kRows * DV * 2;  // of dO or v
  uint8_t* sk;
  uint8_t* sv;
  uint8_t* sq;
  uint8_t* sdo;
  float* sl;
  float* sd;
  uint64_t* full_kv;
  uint64_t* full;
  uint64_t* empty;
  __device__ explicit DkdvSmem(uint8_t* raw) {
    // 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
    sk = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    sv = sk + kTileQ;
    sq = sv + kTileO;
    sdo = sq + kStages * kTileQ;
    sl = reinterpret_cast<float*>(sdo + kStages * kTileO);
    sd = sl + kStages * kRows;
    full_kv = reinterpret_cast<uint64_t*>(sd + kStages * kRows);
    full = full_kv + 1;
    empty = full + kStages;
  }
  static constexpr int bytes() {
    return (1 + kStages) * (kTileQ + kTileO) + 2 * kStages * kRows * 4 +
           (1 + 2 * kStages) * 8 + 1024;
  }
};

// The dK/dV kernel's consumer warpgroup kDk (warpgroup 0: dK = dS^T Q) or
// not (warpgroup 1: dV = P^T dO).  Per tile of the walk: S^T = K Q^T (and
// dP^T = V dO^T for dK) on wgmma from shared memory, then P^T (and dS^T)
// in registers, cut into bf16 parts that are the A operand of the
// accumulating product; its float32 sum goes to `red` at the end.
template <int D, int DV, bool kDk>
__device__ __forceinline__ void dkdv_consume(const Params& p, const DkdvSmem<D, DV>& sm,
                                             int k0, int t_lo, int n_t, int steps,
                                             float* red) {
  constexpr int N = kDk ? D : DV;
  const int tid = threadIdx.x % 128;
  // in wgmma's accumulator layout this thread holds rows (keys) r0 and
  // r0 + 8 and, in each 8-column chunk j, columns (queries) 8 j + c0, + 1
  const int r0 = (tid / 32) * 16 + (tid % 32) / 4, c0 = 2 * (tid % 4);
  float acc[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
  const uint32_t ka = smem_u32(sm.sk), va = smem_u32(sm.sv);
  if (steps > 0) mbar_wait(sm.full_kv, 0);

  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages;
    const int q0 = (t_lo + i % n_t) * kRows;
    const uint32_t qa = smem_u32(sm.sq + s * DkdvSmem<D, DV>::kTileQ);
    const uint32_t ga = smem_u32(sm.sdo + s * DkdvSmem<D, DV>::kTileO);
    float sc[32], dp[32];  // dp: the dK warpgroup's only
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    if constexpr (kDk) {
#pragma unroll
      for (int j = 0; j < 32; ++j) dp[j] = 0.f;
    }
    mbar_wait(&sm.full[s], (i / kStages) & 1);
    fence_regs(sc);
    if constexpr (kDk) fence_regs(dp);
    wgmma_fence();
    mma_tile<D>(sc, ka, qa);
    if constexpr (kDk) mma_tile<DV>(dp, va, ga);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    if constexpr (kDk) fence_regs(dp);

    const float* sl = sm.sl + s * kRows;
    const float* sd = sm.sd + s * kRows;
    const bool edge = edge_tile(p, q0, k0);
    if (p.cap_in != 0.f) {
      if (edge) dkdv_scores<kDk, true, true>(p, sc, dp, sl, sd, q0, k0, r0, c0);
      else dkdv_scores<kDk, true, false>(p, sc, dp, sl, sd, q0, k0, r0, c0);
    } else {
      if (edge) dkdv_scores<kDk, false, true>(p, sc, dp, sl, sd, q0, k0, r0, c0);
      else dkdv_scores<kDk, false, false>(p, sc, dp, sl, sd, q0, k0, r0, c0);
    }
    uint32_t a[kParts][4][4];
    if constexpr (kDk) to_parts(dp, a);
    else to_parts(sc, a);
    mma_parts<N>(acc, a, kDk ? qa : ga);
    mbar_arrive(&sm.empty[s]);
  }

  // both warpgroups are done with the ring: it takes the float32 sums,
  // dK [64][D] then dV [64][DV]
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  float* out = kDk ? red : red + kRows * D;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + red_at<N>(r0 + 8 * r, 8 * j + c0)) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
}

// rows [lo, hi) of a [64][W] float32 block summed over the cluster's
// CTAs in rank order, times `mul`, stored as bf16 rows k0 + row < Skv
template <int W>
__device__ __forceinline__ void cluster_sum(const float* block, int lo, int hi, int ranks,
                                            float mul, __nv_bfloat16* dst, long long ss,
                                            int k0, int Skv, int tid, int nthreads) {
  constexpr int kPer = W / 4;  // float4 a row
  for (int idx = tid; idx < (hi - lo) * kPer; idx += nthreads) {
    const int row = lo + idx / kPer, col = (idx % kPer) * 4;
    const float* src = block + red_at<W>(row, col);
    float4 sum = ld_rank4(src, 0);
    for (int r = 1; r < ranks; ++r) {
      const float4 v = ld_rank4(src, r);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (k0 + row < Skv) {
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dst + (k0 + row) * ss + col);
      o[0] = __floats2bfloat162_rn(sum.x * mul, sum.y * mul);
      o[1] = __floats2bfloat162_rn(sum.z * mul, sum.w * mul);
    }
  }
}

// dK and dV: a cluster of CTAs per (batch, kv head, 64 keys), CTA `rank`
// walking query heads h0 .. h0 + per - 1 of the group in order and in each
// the 64-row query tiles that can see the keys; the CTAs' sums are added in
// rank order through distributed shared memory.
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ Params p) {
  using Sm = DkdvSmem<D, DV>;
  static_assert(kStages * (Sm::kTileQ + Sm::kTileO) >= kRows * (D + DV) * 4,
                "the ring holds the float32 sums");
  extern __shared__ uint8_t smem_raw[];
  const Sm sm(smem_raw);
  const int rank = blockIdx.x, ranks = gridDim.x;  // the cluster spans grid x
  const int hk = blockIdx.y % p.Hkv, b = blockIdx.y / p.Hkv;
  const int k0 = blockIdx.z * kRows;  // key block 0 first: under a causal mask the heaviest
  int t_lo, t_hi;
  query_tiles(p, k0, t_lo, t_hi);
  const int n_t = t_hi - t_lo, steps = p.per * n_t;
  const int h0 = hk * p.group + rank * p.per;

  if (threadIdx.x == 0) {
    mbar_init(sm.full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1 + 32);  // the TMA thread and the L / delta warp
      mbar_init(&sm.empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: warp 8's first thread issues the TMA loads, warp
    // 9 stages each tile's L and delta
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(tc::kProducerRegs));
    const int warp = (threadIdx.x - 256) / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0 && steps > 0) {
      mbar_expect_tx(sm.full_kv, Sm::kTileQ + Sm::kTileO);
      for (int c = 0; c < D / 64; ++c)
        tma_load(&p.tk, sm.sk + c * kBox, sm.full_kv, c * 64, k0, hk, b);
      for (int c = 0; c < DV / 64; ++c)
        tma_load(&p.tv, sm.sv + c * kBox, sm.full_kv, c * 64, k0, hk, b);
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages, h = h0 + i / n_t, q0 = (t_lo + i % n_t) * kRows;
        if (i >= kStages) mbar_wait(&sm.empty[s], (i / kStages - 1) & 1);
        mbar_expect_tx(&sm.full[s], Sm::kTileQ + Sm::kTileO);
        for (int c = 0; c < D / 64; ++c)
          tma_load(&p.tq, sm.sq + s * Sm::kTileQ + c * kBox, &sm.full[s], c * 64, q0, h, b);
        for (int c = 0; c < DV / 64; ++c)
          tma_load(&p.tdo, sm.sdo + s * Sm::kTileO + c * kBox, &sm.full[s], c * 64, q0, h, b);
      }
    } else if (warp == 1) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages, h = h0 + i / n_t, q0 = (t_lo + i % n_t) * kRows;
        if (i >= kStages) mbar_wait(&sm.empty[s], (i / kStages - 1) & 1);
        const long long row0 = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
        for (int r = lane; r < kRows; r += 32) {
          const int q = q0 + r;
          sm.sl[s * kRows + r] = q < p.Sq ? p.lse[row0 + q] * tc::kLog2e : -INFINITY;
          sm.sd[s * kRows + r] = q < p.Sq ? p.delta[row0 + q] : 0.f;
        }
        mbar_arrive(&sm.full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(tc::kConsumerRegs));
    float* red = reinterpret_cast<float*>(sm.sq);
    if (threadIdx.x < 128) dkdv_consume<D, DV, true>(p, sm, k0, t_lo, n_t, steps, red);
    else dkdv_consume<D, DV, false>(p, sm, k0, t_lo, n_t, steps, red);
    cluster_sync();  // every CTA's sums are in its shared memory
    const int lo = rank * kRows / ranks, hi = (rank + 1) * kRows / ranks;
    cluster_sum<D>(red, lo, hi, ranks, p.scale, p.dk + b * p.dksb + hk * p.dksh, p.dkss, k0,
                   p.Skv, threadIdx.x, 256);
    cluster_sum<DV>(red + kRows * D, lo, hi, ranks, 1.f, p.dv + b * p.dvsb + hk * p.dvsh,
                    p.dvss, k0, p.Skv, threadIdx.x, 256);
    cluster_sync();  // no CTA leaves while another reads its shared memory
    return;
  }
  // the producer warpgroup joins the consumers' two cluster barriers
  cluster_sync();
  cluster_sync();
}

// dQ: a block per (batch, q head, 128 query rows), 64 a consumer warpgroup;
// the producer streams K (2 stages) and V (1 stage at D 256, else 2) tiles.
// Per kv tile: dP = dO V^T and S = Q K^T on wgmma from shared memory, dS in
// registers, dQ += dS K with dS in bf16 parts as the A operand.
template <int D, int DV>
struct DqSmem {
  static constexpr int kTileQ = kRows * D * 2, kTileO = kRows * DV * 2;
  static constexpr int kKS = 2, kVS = D == 256 ? 1 : 2;
  uint8_t* sq;   // 2 warpgroups' q rows
  uint8_t* sdo;  // and their dO rows
  uint8_t* sk;
  uint8_t* sv;
  uint64_t* full_q;
  uint64_t* full_k;
  uint64_t* full_v;
  uint64_t* empty_k;
  uint64_t* empty_v;
  __device__ explicit DqSmem(uint8_t* raw) {
    sq = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    sdo = sq + 2 * kTileQ;
    sk = sdo + 2 * kTileO;
    sv = sk + kKS * kTileQ;
    full_q = reinterpret_cast<uint64_t*>(sv + kVS * kTileO);
    full_k = full_q + 1;
    full_v = full_k + kKS;
    empty_k = full_v + kVS;
    empty_v = empty_k + kKS;
  }
  static constexpr int bytes() {
    return (2 + kKS) * kTileQ + (2 + kVS) * kTileO + (1 + 2 * kKS + 2 * kVS) * 8 + 1024;
  }
};

template <int D, int DV>
__device__ __forceinline__ void dq_consume(const Params& p, const DqSmem<D, DV>& sm, int q0,
                                           int t_lo, int t_hi) {
  using Sm = DqSmem<D, DV>;
  const int h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int row_w = q0 + wg * kRows;
  // rows (queries) r0 and r0 + 8; columns (keys) 8 j + c0, + 1 of chunk j
  const int r0 = (tid / 32) * 16 + (tid % 32) / 4, c0 = 2 * (tid % 4);
  int w_lo, w_hi;
  key_tiles(p, row_w, min(kRows, p.Sq - row_w), w_lo, w_hi);
  float L2[2], dl[2];
  const long long row0 = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row_w + r0 + 8 * r;
    L2[r] = q < p.Sq ? p.lse[row0 + q] * tc::kLog2e : -INFINITY;
    dl[r] = q < p.Sq ? p.delta[row0 + q] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  const uint32_t qa = smem_u32(sm.sq + wg * Sm::kTileQ), ga = smem_u32(sm.sdo + wg * Sm::kTileO);
  mbar_wait(sm.full_q, 0);

  for (int t = t_lo; t < t_hi; ++t) {
    const int i = t - t_lo, sk = i % Sm::kKS, sv = i % Sm::kVS;
    const uint32_t pk = (i / Sm::kKS) & 1, pv = (i / Sm::kVS) & 1;
    if (t < w_lo || t >= w_hi) {  // no row of this warpgroup sees the tile
      mbar_wait(&sm.full_k[sk], pk);
      mbar_wait(&sm.full_v[sv], pv);
      mbar_arrive(&sm.empty_v[sv]);
      mbar_arrive(&sm.empty_k[sk]);
      continue;
    }
    const uint32_t ka = smem_u32(sm.sk + sk * Sm::kTileQ), va = smem_u32(sm.sv + sv * Sm::kTileO);
    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
    mbar_wait(&sm.full_v[sv], pv);
    mbar_wait(&sm.full_k[sk], pk);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    mma_tile<DV>(dp, ga, va);
    mma_tile<D>(sc, qa, ka);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    mbar_arrive(&sm.empty_v[sv]);

    const int k0 = t * kRows;
    const bool edge = edge_tile(p, row_w, k0);
    if (p.cap_in != 0.f) {
      if (edge) dq_scores<true, true>(p, sc, dp, L2, dl, row_w, k0, r0, c0);
      else dq_scores<true, false>(p, sc, dp, L2, dl, row_w, k0, r0, c0);
    } else {
      if (edge) dq_scores<false, true>(p, sc, dp, L2, dl, row_w, k0, r0, c0);
      else dq_scores<false, false>(p, sc, dp, L2, dl, row_w, k0, r0, c0);
    }
    uint32_t a[kParts][4][4];
    to_parts(dp, a);
    mma_parts<D>(acc, a, ka);
    mbar_arrive(&sm.empty_k[sk]);
  }

  __nv_bfloat16* dq = p.dq + b * p.dqsb + h * p.dqsh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row_w + r0 + 8 * r;
    if (q >= p.Sq) continue;
    __nv_bfloat16* row = dq + q * p.dqss + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * p.scale, acc[4 * j + 2 * r + 1] * p.scale);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ Params p) {
  using Sm = DqSmem<D, DV>;
  extern __shared__ uint8_t smem_raw[];
  const Sm sm(smem_raw);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 2 * kRows;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  int t_lo, t_hi;
  key_tiles(p, q0, min(2 * kRows, p.Sq - q0), t_lo, t_hi);

  if (threadIdx.x == 0) {
    mbar_init(sm.full_q, 1);
    for (int s = 0; s < Sm::kKS; ++s) {
      mbar_init(&sm.full_k[s], 1);
      mbar_init(&sm.empty_k[s], 256);
    }
    for (int s = 0; s < Sm::kVS; ++s) {
      mbar_init(&sm.full_v[s], 1);
      mbar_init(&sm.empty_v[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(tc::kProducerRegs));
    if (threadIdx.x == 256) {
      const int hk = h / p.group;
      const int q_wgs = min(2, (p.Sq - q0 + kRows - 1) / kRows);  // with rows < Sq
      mbar_expect_tx(sm.full_q, q_wgs * (Sm::kTileQ + Sm::kTileO));
      for (int w = 0; w < q_wgs; ++w) {
        for (int c = 0; c < D / 64; ++c)
          tma_load(&p.tq, sm.sq + w * Sm::kTileQ + c * kBox, sm.full_q, c * 64, q0 + w * kRows,
                   h, b);
        for (int c = 0; c < DV / 64; ++c)
          tma_load(&p.tdo, sm.sdo + w * Sm::kTileO + c * kBox, sm.full_q, c * 64, q0 + w * kRows,
                   h, b);
      }
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo, sk = i % Sm::kKS, sv = i % Sm::kVS;
        if (i >= Sm::kKS) mbar_wait(&sm.empty_k[sk], (i / Sm::kKS - 1) & 1);
        mbar_expect_tx(&sm.full_k[sk], Sm::kTileQ);
        for (int c = 0; c < D / 64; ++c)
          tma_load(&p.tk, sm.sk + sk * Sm::kTileQ + c * kBox, &sm.full_k[sk], c * 64, t * kRows,
                   hk, b);
        if (i >= Sm::kVS) mbar_wait(&sm.empty_v[sv], (i / Sm::kVS - 1) & 1);
        mbar_expect_tx(&sm.full_v[sv], Sm::kTileO);
        for (int c = 0; c < DV / 64; ++c)
          tma_load(&p.tv, sm.sv + sv * Sm::kTileO + c * kBox, &sm.full_v[sv], c * 64, t * kRows,
                   hk, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(tc::kConsumerRegs));
    dq_consume<D, DV>(p, sm, q0, t_lo, t_hi);
  }
}

// delta, then dK and dV (clusters of `cluster` CTAs), then dQ
template <int D, int DV>
cudaError_t launch(const Params& p, const BwdParams& bp, int B, int cluster, cudaStream_t s) {
  auto dkdv = flash_bwd_dkdv_wgmma_kernel<D, DV>;
  auto dq = flash_bwd_dq_wgmma_kernel<D, DV>;
  constexpr int smem_kv = DkdvSmem<D, DV>::bytes(), smem_q = DqSmem<D, DV>::bytes();
  static_assert(smem_kv <= 232448 && smem_q <= 232448, "beyond an SM's shared memory");
  static const cudaError_t set = [&] {
    const cudaError_t e =
        cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  }();
  if (set != cudaSuccess) return set;
  const int64_t rows = static_cast<int64_t>(B) * p.Hq * p.Sq;
  flash_bwd_dot_kernel<__nv_bfloat16>
      <<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(bp, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.Skv > 0) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, p.Hkv * B, (p.Skv + kRows - 1) / kRows);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem_kv;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if ((err = cudaLaunchKernelEx(&cfg, dkdv, p)) != cudaSuccess) return err;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  dq<<<dim3((p.Sq + 2 * kRows - 1) / (2 * kRows), p.Hq, B), kThreads, smem_q, s>>>(p);
  return cudaGetLastError();
}

}  // namespace tcb

}  // namespace


extern "C" {

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, o: element strides (batch, head, seq) each, unit stride along the
// head dim, D for q and k, Dv for v and o; o has q's dtype.  window < 0: no
// window; softcap 0: off.  lse ([B,Hq,Sq]) and o32 ([B,Hq,Sq,Dv], float32,
// contiguous) are written when not null: the training forward asks for
// them, serving passes null.
int rt_flash_attention(int dtype, const void* q, const void* k, const void* v, void* o, int B,
                       int Hq, int Hkv, int Sq, int Skv, int D, int Dv, long long qsb,
                       long long qsh,
                       long long qss, long long ksb, long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss, long long osb,
                       long long osh, long long oss, float scale, float softcap, int causal,
                       int window, int q_offset, float* lse, float* o32, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hq <= 0 || Hkv <= 0 || Hq % Hkv || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, Hq, Sq, Skv, Hq / Hkv, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
           osb, osh, oss, scale, softcap, causal, window >= 0, window < 0 ? 0 : window,
           q_offset, lse, o32};
  const int ch = dtype == kBFloat16 ? 8 : 4;  // elements of a 16-byte load
  bool vec = D % ch == 0 && Dv % ch == 0;
  for (const void* ptr : {q, k, v})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (long long st : {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss}) vec = vec && st % ch == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kFloat32: err = launch_t<float>(p, B, D, Dv, vec, s); break;
    case kBFloat16: err = launch_t<__nv_bfloat16>(p, B, D, Dv, vec, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// The tensor-core kernel: bf16 q, k, v, o with element strides (batch, head,
// seq) each, unit stride along the head dim, (D, Dv) one of (64, 64),
// (128, 128), (256, 256) and (192, 128), 16-byte aligned base pointers and
// strides (TMA); arguments as rt_flash_attention's.
int rt_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                             int Hq, int Hkv, int Sq, int Skv, int D, int Dv, long long qsb,
                             long long qsh, long long qss, long long ksb, long long ksh,
                             long long kss, long long vsb, long long vsh, long long vss,
                             long long osb, long long osh, long long oss, float scale,
                             float softcap, int causal, int window, int q_offset,
                             float* lse, float* o32, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hq <= 0 || Hkv <= 0 || Hq % Hkv || Hq > 65535 || B > 65535 || Skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  tc::Params p{};
  const int kv_rows = Skv > 0 ? Skv : 1;  // a map needs one row; none is read
  if (!tc::encode(&p.tq, q, D, Sq, Hq, B, qss, qsh, qsb) ||
      !tc::encode(&p.tk, k, D, kv_rows, Hkv, B, kss, ksh, ksb) ||
      !tc::encode(&p.tv, v, Dv, kv_rows, Hkv, B, vss, vsh, vsb))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.osb = osb;
  p.osh = osh;
  p.oss = oss;
  p.Sq = Sq;
  p.Skv = Skv;
  p.group = Hq / Hkv;
  p.q_offset = q_offset;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * tc::kLog2e;
  p.cap_in = softcap != 0.f ? scale / softcap : 0.f;
  p.cap_out = softcap * tc::kLog2e;
  p.Hq = Hq;
  p.lse = lse;
  p.o32 = o32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && Dv == 64) return static_cast<int>(tc::launch<64, 64>(p, B, Hq, s));
  if (D == 128 && Dv == 128) return static_cast<int>(tc::launch<128, 128>(p, B, Hq, s));
  if (D == 256 && Dv == 256) return static_cast<int>(tc::launch<256, 256>(p, B, Hq, s));
  if (D == 192 && Dv == 128) return static_cast<int>(tc::launch<192, 128>(p, B, Hq, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: dq, dk, dv (q's dtype, element strides (batch, head, seq),
// unit stride along the head dim) of attention at q, k, v for the output's
// cotangent dout, from the forward's float32 output o and its row
// log-sum-exp lse ([B,Hq,Sq]); delta is a [B,Hq,Sq] float32 scratch.  Three
// launches on the stream; other arguments as rt_flash_attention's.
int rt_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                           const void* dout, const float* o, const float* lse, float* delta,
                           void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
                           int Skv, int D, int Dv, long long qsb, long long qsh, long long qss,
                           long long ksb, long long ksh, long long kss, long long vsb,
                           long long vsh, long long vss, long long gsb, long long gsh,
                           long long gss, long long osb, long long osh, long long oss,
                           long long dqsb, long long dqsh, long long dqss, long long dksb,
                           long long dksh, long long dkss, long long dvsb, long long dvsh,
                           long long dvss, float scale, float softcap, int causal, int window,
                           int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hq <= 0 || Hkv <= 0 || Hq % Hkv || Hq > 65535 || B > 65535 || Skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{q, k, v, dout, o, lse, delta, dq, dk, dv, Hq, Hkv, Sq, Skv, Hq / Hkv, Dv,
              qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, gsb, gsh, gss, osb, osh, oss,
              dqsb, dqsh, dqss, dksb, dksh, dkss, dvsb, dvsh, dvss, scale, softcap, causal,
              window >= 0, window < 0 ? 0 : window, q_offset};
  const int ch = dtype == kBFloat16 ? 8 : 4;  // elements of a 16-byte load
  bool vec = D % ch == 0 && Dv % ch == 0;
  for (const void* ptr : {q, k, v, dout})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (long long st : {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, gsb, gsh, gss})
    vec = vec && st % ch == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kFloat32: err = launch_bwd_t<float>(p, B, D, Dv, vec, s); break;
    case kBFloat16: err = launch_bwd_t<__nv_bfloat16>(p, B, D, Dv, vec, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}


// The tensor-core backward: bf16 at (D, Dv) (64, 64), (128, 128), (256, 256)
// or (192, 128); q, k, v and dout 16-byte aligned with strides in multiples
// of 8 elements (TMA); arguments as rt_flash_attention_bwd's.  Three
// launches on the stream: delta, dK and dV (clusters of up to 8 CTAs), dQ.
int rt_flash_attention_bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
                                 const float* o, const float* lse, float* delta, void* dq,
                                 void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
                                 int D, int Dv, long long qsb, long long qsh, long long qss,
                                 long long ksb, long long ksh, long long kss, long long vsb,
                                 long long vsh, long long vss, long long gsb, long long gsh,
                                 long long gss, long long osb, long long osh, long long oss,
                                 long long dqsb, long long dqsh, long long dqss, long long dksb,
                                 long long dksh, long long dkss, long long dvsb, long long dvsh,
                                 long long dvss, float scale, float softcap, int causal,
                                 int window, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hq <= 0 || Hkv <= 0 || Hq % Hkv || Hq > 65535 || B > 65535 || Skv < 0 ||
      static_cast<long long>(Hkv) * B > 65535 || (Skv + tcb::kRows - 1) / tcb::kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams bp{q, k, v, dout, o, lse, delta, dq, dk, dv, Hq, Hkv, Sq, Skv, Hq / Hkv, Dv,
                     qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, gsb, gsh, gss, osb, osh, oss,
                     dqsb, dqsh, dqss, dksb, dksh, dkss, dvsb, dvsh, dvss, scale, softcap, causal,
                     window >= 0, window < 0 ? 0 : window, q_offset};
  tcb::Params p{};
  const int kv_rows = Skv > 0 ? Skv : 1;  // a map needs one row; none is read
  if (!tc::encode(&p.tq, q, D, Sq, Hq, B, qss, qsh, qsb) ||
      !tc::encode(&p.tk, k, D, kv_rows, Hkv, B, kss, ksh, ksb) ||
      !tc::encode(&p.tv, v, Dv, kv_rows, Hkv, B, vss, vsh, vsb) ||
      !tc::encode(&p.tdo, dout, Dv, Sq, Hq, B, gss, gsh, gsb))
    return static_cast<int>(cudaErrorInvalidValue);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dqsb = dqsb;
  p.dqsh = dqsh;
  p.dqss = dqss;
  p.dksb = dksb;
  p.dksh = dksh;
  p.dkss = dkss;
  p.dvsb = dvsb;
  p.dvsh = dvsh;
  p.dvss = dvss;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.group = Hq / Hkv;
  p.q_offset = q_offset;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.scale_log2 = scale * tc::kLog2e;
  p.cap_in = softcap != 0.f ? scale / softcap : 0.f;
  p.cap_out = softcap * tc::kLog2e;
  // a cluster of the largest power of two up to 8 that divides the group
  int cluster = 1;
  while (cluster < tcb::kMaxCluster && p.group % (2 * cluster) == 0) cluster *= 2;
  p.per = p.group / cluster;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && Dv == 64) return static_cast<int>(tcb::launch<64, 64>(p, bp, B, cluster, s));
  if (D == 128 && Dv == 128) return static_cast<int>(tcb::launch<128, 128>(p, bp, B, cluster, s));
  if (D == 256 && Dv == 256) return static_cast<int>(tcb::launch<256, 256>(p, bp, B, cluster, s));
  if (D == 192 && Dv == 128) return static_cast<int>(tcb::launch<192, 128>(p, bp, B, cluster, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
