// Kernel D: blockwise online-softmax attention (the flash-attention
// schedule) for prefill, in the model layout.
//
//   o[b, t, h] = sum_j softmax_j(scale * q[b, t, h] . k[b, j, g]) v[b, j, g]
//
// with g = h / (H / KV) (GQA by index: K/V are never repeated), scale
// 1/sqrt(hd), keys j >= Tk masked and, when causal, the start-aligned mask
// j <= t. Running max, denominator and accumulator are fp32; the output is
// cast to the input dtype (fp32 or bf16).
//
// Replaces: src/repro/kernels/flash_attn.py:69 `flash_attention` (its
// pl.pallas_call at :89, body `_flash_kernel` at :28).
//
// What bounds it on the H100: operations. Causal attention at T = 32768,
// H = 32, hd = 128 is 2*2*H*T*T*hd/2 = 8.8e12 FLOP against 0.67 GB of
// q, k, v and o; even at the 989 TFLOP/s bf16 tensor-core rate the FLOPs
// take 13x longer than the bytes. This first version does every product on
// the fp32 CUDA cores (FMA), as the TPU kernel casts both operands to f32
// (flash_attn.py:40-41, :57): right first, tensor cores (mma/wgmma with
// bf16 operands, TMA) come later.
//
// Design. The TPU kernel walks a sequential KV grid axis and carries
// (m, l, acc) in VMEM scratch; CUDA blocks run in no order and cannot carry
// state, so one block of 256 threads owns a (b, h, 64-query block) and
// loops over the 64-key blocks itself. Shared memory holds q^T * scale,
// one K^T or V tile (the two take turns in one buffer) and P^T. 16 x 16
// threads each own a 4 x 4 tile of scores (query rows 4*ty.., key columns
// 4*tx..) and the same 4 query rows of the output (hd/16 columns), so a
// row's running max and denominator live in registers and are reduced over
// the 16 lanes that share the row with shuffles. At hd 64 and 128 every
// shared-memory read of the two products is a 16-byte load that feeds 16
// or 32 FMAs (85 KB of shared memory and 123 registers at hd 128: two
// blocks share an SM). Causal blocks wholly above the diagonal are skipped:
// after key block 0 every row's max is finite, so such a block would add
// exp(NEG - m) = 0 with alpha = 1. Query blocks run longest-first (the last
// query block is launched first) to even out the causal tail. No padding to
// a block multiple: staging writes zeros past Tq, Tk and hd.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBq = 64;            // queries per block
constexpr int kBk = 64;            // keys per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kPitch = kBq + 4;    // row pitch of q^T, K^T, P^T (16-byte rows)
constexpr float kNeg = -1e30f;     // the TPU kernel's NEG
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int HDP>
struct Layout {
  static constexpr int kCols = HDP / 16;           // output columns a thread owns
  static constexpr int kVPitch = HDP + 4;          // row pitch of V
  static constexpr int kQ = HDP * kPitch;          // floats of q^T
  static constexpr int kKV = (HDP * kPitch > kBk * kVPitch) ? HDP * kPitch : kBk * kVPitch;
  static constexpr int kP = kBk * kPitch;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKV + kP);
  // output column of a thread's j-th accumulator: 4 consecutive columns
  // per 64-wide stripe (16-byte V loads), or kCols consecutive below 64
  static __device__ __forceinline__ int col(int tx, int j) {
    return kCols >= 4 ? (j / 4) * 64 + tx * 4 + (j % 4) : tx * kCols + j;
  }
};

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 2)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int heads,
                  int kv_heads, int tq, int tk, int hd, int causal, float scale) {
  using L = Layout<HDP>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [HDP][kPitch]  q^T * scale
  float* kv = smem + L::kQ;          // K^T [HDP][kPitch], then V [kBk][kVPitch]
  float* ps = kv + L::kKV;           // P^T [kBk][kPitch]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int nq = (tq + kBq - 1) / kBq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (heads / kv_heads);
  const int64_t q_step = static_cast<int64_t>(heads) * hd;     // between tokens
  const int64_t kv_step = static_cast<int64_t>(kv_heads) * hd;
  const T* qb = q + (static_cast<int64_t>(b) * tq * heads + h) * hd;
  const T* kb = k + (static_cast<int64_t>(b) * tk * kv_heads + g) * hd;
  const T* vb = v + (static_cast<int64_t>(b) * tk * kv_heads + g) * hd;
  T* ob = o + (static_cast<int64_t>(b) * tq * heads + h) * hd;

  // q^T * scale (the TPU kernel scales q before the product); zeros past
  // Tq and hd add nothing to a score
  for (int e = threadIdx.x; e < kBq * HDP; e += kThreads) {
    const int r = e / HDP;
    const int c = e % HDP;
    const int t = q0 + r;
    qs[c * kPitch + r] = (t < tq && c < hd) ? to_f32(qb[t * q_step + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][L::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < L::kCols; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(tk, q0 + kBq) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBk) {
    __syncthreads();  // q staged; the previous V and P^T fully read
    for (int e = threadIdx.x; e < kBk * HDP; e += kThreads) {
      const int r = e / HDP;
      const int c = e % HDP;
      const int t = k0 + r;
      kv[c * kPitch + r] = (t < tk && c < hd) ? to_f32(kb[t * kv_step + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int c = 0; c < HDP; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(qs + c * kPitch + ty * 4);
      const float4 x = *reinterpret_cast<const float4*>(kv + c * kPitch + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], xv[j], s[i][j]);
      }
    }

    // mask, then the online softmax over this tile (as _flash_kernel)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        if (kpos >= tk || (causal && kpos > qpos)) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f((m[i] - m_new) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f((s[i][j] - m_new) * kLog2e);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < L::kCols; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // K^T fully read: the buffer takes V
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(ps + (tx * 4 + j) * kPitch + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    for (int e = threadIdx.x; e < kBk * HDP; e += kThreads) {
      const int r = e / HDP;
      const int c = e % HDP;
      const int t = k0 + r;
      kv[r * L::kVPitch + c] = (t < tk && c < hd) ? to_f32(vb[t * kv_step + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBk; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + kk * kPitch + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float* vrow = kv + kk * L::kVPitch;
      float x[L::kCols];
      if constexpr (L::kCols >= 4) {
#pragma unroll
        for (int j4 = 0; j4 < L::kCols / 4; ++j4) {
          const float4 w = *reinterpret_cast<const float4*>(vrow + j4 * 64 + tx * 4);
          x[j4 * 4 + 0] = w.x;
          x[j4 * 4 + 1] = w.y;
          x[j4 * 4 + 2] = w.z;
          x[j4 * 4 + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < L::kCols; ++j) x[j] = vrow[L::col(tx, j)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < L::kCols; ++j) acc[i][j] = fmaf(pv[i], x[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= tq) continue;
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < L::kCols; ++j) {
      const int c = L::col(tx, j);
      if (c < hd) store(ob + t * q_step + c, acc[i][j] / den);
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int heads, int kv_heads, int tq, int tk, int hd, int causal,
           float scale, cudaStream_t stream) {
  using L = Layout<HDP>;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((tq + kBq - 1) / kBq, heads, batch);
  flash_attn_kernel<T, HDP><<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), heads, kv_heads, tq, tk, hd, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch,
             int heads, int kv_heads, int tq, int tk, int hd, int causal,
             float scale, cudaStream_t s) {
  if (hd <= 16) return launch<T, 16>(q, k, v, o, batch, heads, kv_heads, tq, tk, hd, causal, scale, s);
  if (hd <= 32) return launch<T, 32>(q, k, v, o, batch, heads, kv_heads, tq, tk, hd, causal, scale, s);
  if (hd <= 64) return launch<T, 64>(q, k, v, o, batch, heads, kv_heads, tq, tk, hd, causal, scale, s);
  return launch<T, 128>(q, k, v, o, batch, heads, kv_heads, tq, tk, hd, causal, scale, s);
}

}  // namespace

// C entry, launched on `stream`: q [B, Tq, H, hd], k/v [B, Tk, KV, hd],
// o [B, Tq, H, hd], all contiguous, of one dtype (bf16 != 0: bfloat16,
// else float32). `scale` multiplies q before the product. Allocates
// nothing; returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int batch, int heads, int kv_heads,
                                     int tq, int tk, int hd, int causal, int bf16,
                                     float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      tq <= 0 || tk <= 0 || hd <= 0 || hd > 128 || batch > 65535 || heads > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, batch, heads, kv_heads, tq, tk, hd, causal, scale, s)
              : dispatch<float>(q, k, v, o, batch, heads, kv_heads, tq, tk, hd, causal, scale, s);
}
