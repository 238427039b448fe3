// Kernel D on Hopper's tensor cores: blockwise online-softmax attention
// (the flash-attention schedule) for prefill, bf16, in the model layout.
//
//   o[b, t, h] = sum_j softmax_j(scale * q[b, t, h] . k[b, j, g]) v[b, j, g]
//
// with g = h / (H / KV) (GQA by index), scale 1/sqrt(hd), keys j >= Tk
// masked and, when causal, the start-aligned mask j <= t. Same function and
// same checks as the SIMT kernel in flash_attn.cu. Scope, by rule: bf16 q,
// k, v with hd 64 or 128, any B and T, H % KV == 0, causal or not (every
// LM prefill). f32 and any other hd go to flash_attn.cu; ops.flash_attention
// picks the kernel from dtype and hd alone.
//
// Replaces: src/repro/kernels/flash_attn.py:69 `flash_attention` (its
// pl.pallas_call at :89, body `_flash_kernel` at :28).
//
// What bounds it on the H100: operations. Causal attention at T = 32768,
// H = 32, hd = 128 is 2*2*H*T*T*hd/2 = 8.8e12 FLOP against 0.67 GB of
// q, k, v and o, so the bf16 tensor cores (989 TFLOP/s) are the limit:
// 8.9 ms. The products run there, as wgmma with f32 accumulation.
//
// Why P is split. The checks hold the bf16 output to the f32 plain version
// within one bf16 rounding step. The usual recipe rounds the probabilities
// P to bf16 before P.V; on the CPU twin of this kernel
// (tests/test_torch_flash_attn_sm90.py) that uses 19-77x the bound, the
// split 0.95-0.98 of it. Here
// P_hi = bf16(P) and P_lo = bf16(P - P_hi) go through two wgmmas into one
// f32 O, which keeps P to about 16 bits at 1.5x the tensor-core work of
// bf16-only P (Q.K^T once, P.V twice).
//
// Design. One block of three warpgroups owns a (b, h, 128-query block);
// blocks run longest first (the last query block of every head first) to
// shorten the causal tail. Warpgroup 2 is the producer: it gives up its
// registers (setmaxnreg) and one of its threads issues every TMA load,
// Q once, then K and V tiles of 64 keys into a ring of four stages, each
// signalled on its own mbarrier and released by the consumers on another.
// The tensor maps describe the model layout [B, T, heads, hd] as it is
// (4-d: hd, head, token, batch), so no copy surrounds the launch; each
// 64-column half of a tile lands 128-byte swizzled, as wgmma reads it, and
// rows past T are filled with zeros. Warpgroups 0 and
// 1 own 64 query rows each (wgmma's M): S = Q.K^T from shared memory (both
// K-major), then scale.log2(e), the mask (only on tiles that cross the
// diagonal or Tk), the online softmax in registers on the accumulator
// fragments (a row's max and sum reduce over the 4 lanes that share it,
// with exp2f), and O += P_hi.V + P_lo.V with P from registers and V read
// MN-major. A warpgroup issues S of tile j + 1 before P.V of tile j and
// runs tile j + 1's softmax while that P.V is on the tensor cores. Tiles
// wholly above the diagonal are never loaded. At hd 128: 32 KB of Q and
// 4 x (16 + 16) KB of K, V: 160 KB, one block an SM.
//
// Why 64-key tiles. ptxas holds every warp of this kernel to the launch
// budget of 168 registers (65536 / 384 threads), whatever setmaxnreg later
// gives the consumers. At 128 keys the S, P (hi, lo) and O fragments of a
// consumer thread (64 + 64 + 64 at hd 128) spill and ptxas serialises the
// wgmmas; at 64 keys (32 + 32 + 64) they fit without spills. The sweep in
// kernels/flash_sweep.py builds and times both tiles and ring depths 2, 4
// and 6 (six is the most that fits beside Q at hd 128): on the H100 at
// T 32768, 128-key tiles were the slowest and 4 stages the fastest, 6 no
// faster (PERF.md).

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBq = 128;           // queries per block (two warpgroups of 64)
constexpr int kBk = 64;            // keys per tile
constexpr int kStages = 4;         // K/V ring depth
constexpr int kThreads = 384;      // consumers: warpgroups 0, 1; producer: 2
constexpr int kRowBytes = 128;     // one swizzled row: 64 bf16 columns
constexpr float kNeg = -1e30f;     // the TPU kernel's NEG, in log2 units here
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base: Q [HDP/64][kBq][64], then
// K and V rings [kStages][HDP/64][kBk][64], then the mbarriers.
template <int HDP>
struct Smem {
  static constexpr int kHalves = HDP / 64;
  static constexpr uint32_t kQBytes = kBq * HDP * 2;
  static constexpr uint32_t kTileBytes = kBk * HDP * 2;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBar = kV + kStages * kTileBytes;
  static constexpr int kNumBars = 1 + 3 * kStages;   // q, full_k[], full_v[], empty[]
  static constexpr size_t kBytes = kBar + 8 * kNumBars + 1024;   // + alignment slack
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// spin until the phase of parity `parity` has completed. A block waits
// only on its own loads and warps (microseconds), so a wait of 2^31 cycles
// (over a second) is a fault: trap, and the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 31)) __trap();
  }
}

// one box {64 columns, 1 head, rows, 1 batch} of a 4-d map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = SW128
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[0:64] (+)= A[64 x 16] (shared, K-major) . B[16 x 128] (shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:32] (+)= A[64 x 16] (shared, K-major) . B[16 x 64] (shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:64] += A[64 x 16] (registers) . B[16 x 128] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:32] += A[64 x 16] (registers) . B[16 x 64] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (BK == 128) {
    wgmma_ss_n128(d, da, db, accumulate);
  } else {
    wgmma_ss_n64(d, da, db, accumulate);
  }
}

template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&o)[HDP / 2], const uint32_t* a, uint64_t db) {
  if constexpr (HDP == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n64(o, a, db);
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// S = Q . K^T for one key tile, over hd in steps of 16 (two per 32 bytes
// of a swizzled row); both operands K-major in shared memory
template <int HDP>
__device__ __forceinline__ void issue_qk(float (&sc)[kBk / 2], uint32_t q_base, uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t qoff = (kk / 4) * kBq * kRowBytes + (kk % 4) * 32;
    const uint32_t koff = (kk / 4) * kBk * kRowBytes + (kk % 4) * 32;
    wgmma_qk<kBk>(sc, sw128_desc(q_base + qoff, 16, 1024), sw128_desc(k_base + koff, 16, 1024),
                  kk > 0);
  }
}

// O += P_hi . V + P_lo . V for one key tile; V [keys][hd] is read MN-major:
// 8-key groups 1024 bytes apart, 64-column halves a tile's half apart
template <int HDP>
__device__ __forceinline__ void issue_pv(float (&acc)[HDP / 2], const uint32_t* p_hi,
                                         const uint32_t* p_lo, uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < kBk / 16; ++kk) {
    const uint64_t dv = sw128_desc(v_base + kk * 16 * kRowBytes, kBk * kRowBytes, 1024);
    wgmma_pv<HDP>(acc, p_hi + 4 * kk, dv);
    wgmma_pv<HDP>(acc, p_lo + 4 * kk, dv);
  }
}

// The online softmax of one score tile, in place and in log2 units: the
// mask (keys >= Tk, and keys past the row when causal), the row max over
// the 4 lanes that share a row, P = exp2(s * scale * log2(e) - m). Updates
// (m, l) and gives the factors alpha that rescale O.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBk / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], bool mask,
                                             int k0, int row, int col, int tk, int causal,
                                             float scale_log2) {
  if (mask) {
#pragma unroll
    for (int n = 0; n < kBk / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + col + (e & 1);
        if (key >= tk || (causal && key > row + 8 * (e >> 1))) sc[4 * n + e] = -INFINITY;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < kBk / 8; ++n) mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * i], sc[4 * n + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[i], mx * scale_log2);
    alpha[i] = exp2f(m_run[i] - m_new);
    m_run[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < kBk / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = exp2f(sc[4 * n + 2 * i + j] * scale_log2 - m_new);
        sc[4 * n + 2 * i + j] = p;
        sum += p;
      }
    }
    l_run[i] = l_run[i] * alpha[i] + sum;
  }
}

// P as wgmma A fragments, split: hi = bf16(P), lo = bf16(P - hi). For keys
// 16 kk ...: reg 0 holds row, reg 1 row + 8 (columns 16 kk + col ..), regs
// 2 and 3 the same 8 columns on
__device__ __forceinline__ void split_p(const float (&sc)[kBk / 2], uint32_t (&p_hi)[kBk / 4],
                                        uint32_t (&p_lo)[kBk / 4]) {
#pragma unroll
  for (int kk = 0; kk < kBk / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[idx], sc[idx + 1]);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(sc[idx] - hf.x, sc[idx + 1] - hf.y);
      p_hi[4 * kk + r] = bf16x2_bits(hi);
      p_lo[4 * kk + r] = bf16x2_bits(lo);
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                       int heads, int kv_heads, int tq, int tk, int causal,
                       float scale_log2) {
  using S = Smem<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + S::kBar;
  const auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  const auto full_v = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  const auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };

  // every head's last query block first, then the one before, ...
  const int h = blockIdx.x;
  const int nq = (tq + kBq - 1) / kBq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kBq;
  const int b = blockIdx.z;
  const int g = h / (heads / kv_heads);
  const int k_end = causal ? min(tk, q0 + kBq) : tk;
  const int n_tiles = (k_end + kBk - 1) / kBk;
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 8);     // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load; the warpgroup's registers go
    // to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, S::kQBytes);
      for (int c = 0; c < S::kHalves; ++c) {
        tma_load(base + S::kQ + c * kBq * kRowBytes, &q_map, bar_q, c * 64, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
        const int k0 = it * kBk;
        mbar_expect_tx(full_k(s), S::kTileBytes);
        for (int c = 0; c < S::kHalves; ++c) {
          tma_load(base + S::kK + s * S::kTileBytes + c * kBk * kRowBytes, &k_map, full_k(s),
                   c * 64, g, k0, b);
        }
        mbar_expect_tx(full_v(s), S::kTileBytes);
        for (int c = 0; c < S::kHalves; ++c) {
          tma_load(base + S::kV + s * S::kTileBytes + c * kBk * kRowBytes, &v_map, full_v(s),
                   c * 64, g, k0, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg ... + 63; this
  // thread holds rows `row` and `row + 8` of every accumulator, columns
  // 8 n + col and 8 n + col + 1 (the wgmma fragment layout). Tile it's
  // scores are computed while P.V of tile it - 1 runs on the tensor cores.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int row = q0 + wg * 64 + warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {kNeg, kNeg};
  float l_run[2] = {0.f, 0.f};     // this thread's share of each row's sum
  float alpha[2];
  float sc[kBk / 2];
  uint32_t p_hi[kBk / 4], p_lo[kBk / 4];
  const uint32_t q_base = base + S::kQ + wg * 64 * kRowBytes;
  const auto k_tile = [&](int s) { return base + S::kK + s * S::kTileBytes; };
  const auto v_tile = [&](int s) { return base + S::kV + s * S::kTileBytes; };
  const auto softmax = [&](int k0) {
    const bool mask = k0 + kBk > tk || (causal && k0 + kBk - 1 > q0 + wg * 64);
    softmax_tile(sc, m_run, l_run, alpha, mask, k0, row, col, tk, causal, scale_log2);
  };

  mbar_wait(bar_q, 0);
  mbar_wait(full_k(0), 0);
  fence_regs(sc);
  wgmma_fence();
  issue_qk<HDP>(sc, q_base, k_tile(0));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);                       // alpha is unused: O is still 0
  split_p(sc, p_hi, p_lo);

  for (int it = 1; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int prev = (it - 1) % kStages;
    mbar_wait(full_k(s), (it / kStages) & 1);
    mbar_wait(full_v(prev), ((it - 1) / kStages) & 1);
    fence_regs(sc);
    fence_regs(acc);
    wgmma_fence();
    issue_qk<HDP>(sc, q_base, k_tile(s));
    wgmma_commit();
    issue_pv<HDP>(acc, p_hi, p_lo, v_tile(prev));
    wgmma_commit();
    wgmma_wait<1>();                // tile it's scores are in
    fence_regs(sc);
    softmax(it * kBk);
    wgmma_wait<0>();                // P.V of tile it - 1 is in: its stage is free
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(prev));
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    split_p(sc, p_hi, p_lo);
  }

  const int last = (n_tiles - 1) % kStages;
  mbar_wait(full_v(last), ((n_tiles - 1) / kStages) & 1);
  fence_regs(acc);
  wgmma_fence();
  issue_pv<HDP>(acc, p_hi, p_lo, v_tile(last));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  // O / max(l, 1e-20) in bf16, rows < Tq
  const int64_t step = static_cast<int64_t>(heads) * HDP;
  __nv_bfloat16* ob = o + (static_cast<int64_t>(b) * tq * heads + h) * HDP;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-20f);
    const int t = row + 8 * i;
    if (t >= tq) continue;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(ob + t * step + 8 * n + col) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] / den, acc[4 * n + 2 * i + 1] / den);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (cudaGetDriverEntryPoint), so the link line needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [batch, t, n_heads, hd] bf16 as a 4-d map (hd, head, token, batch), box
// {64, 1, rows, 1}, 128-byte swizzle, zeros outside
int make_map(CUtensorMap* map, const void* ptr, int batch, int t, int n_heads, int hd,
             int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInitializationError;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(n_heads),
                              static_cast<cuuint64_t>(t), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * n_heads, row_bytes * n_heads * t};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
           int kv_heads, int tq, int tk, int causal, float scale, cudaStream_t stream) {
  using S = Smem<HDP>;
  CUtensorMap q_map, k_map, v_map;
  int err = make_map(&q_map, q, batch, tq, heads, HDP, kBq);
  if (err == 0) err = make_map(&k_map, k, batch, tk, kv_heads, HDP, kBk);
  if (err == 0) err = make_map(&v_map, v, batch, tk, kv_heads, HDP, kBk);
  if (err != 0) return err;
  const cudaError_t attr =
      cudaFuncSetAttribute(flash_attn_sm90_kernel<HDP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::kBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(heads, (tq + kBq - 1) / kBq, batch);
  flash_attn_sm90_kernel<HDP><<<grid, kThreads, S::kBytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), heads, kv_heads, tq, tk, causal,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, launched on `stream`: bf16 q [B, Tq, H, hd], k/v [B, Tk, KV, hd],
// o [B, Tq, H, hd], contiguous, 16-byte aligned, hd 64 or 128. `scale`
// multiplies q . k (after the product). Allocates nothing; returns
// cudaGetLastError() or the tensor maps' error.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                          int batch, int heads, int kv_heads, int tq, int tk,
                                          int hd, int causal, float scale, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || tq <= 0 ||
      tk <= 0 || (hd != 64 && hd != 128) || batch > 65535 ||
      (tq + kBq - 1) / kBq > 65535 || misaligned(q) || misaligned(k) || misaligned(v) ||
      misaligned(o)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 64 ? launch<64>(q, k, v, o, batch, heads, kv_heads, tq, tk, causal, scale, s)
                  : launch<128>(q, k, v, o, batch, heads, kv_heads, tq, tk, causal, scale, s);
}
