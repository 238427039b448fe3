// Kernel A: windowed weighted sum over a byte stream (gear hash / Rabin
// fingerprints), with the two FastCDC candidate maps fused in.
//
//   h_i = sum_{k<W} r^k * g_{i-k}   (uint32 wraparound)
//   g_j = GEAR_TABLE[byte_j] (gear) or byte_j (Rabin); g_j = 0 for j < 0
//
// Replaces: src/repro/kernels/gear_hash.py:43 `windowed_sum` (its
// pl.pallas_call at :50), and the scan that the reference main path runs
// as jnp in src/repro/kernels/ingest.py:124 `_scan_fused` (hashes plus the
// two `(h & mask) == 0` candidate maps).
//
// What bounds it on the H100: device-memory bytes. Per position it reads
// 1 byte and writes a 4-byte hash plus 2 candidate bits (~5.25 B, about
// 0.1 ms for 64 MiB at 3.35 TB/s). Evaluated as W multiply-adds a
// position, the taps alone cost W shared-memory loads a position (32 for
// gear, 48 for Rabin): 7x that bound (0.729 ms at 64 MiB on an NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md).
//
// Design: both tap sets the port uses are geometric, w_k = r^k (gear
// r = 2, Rabin r = POLY_P), so the window rolls exactly in uint32:
//
//   h_i = r * h_{i-1} + g_i - r^W * g_{i-W}
//
// and for gear the last term vanishes (2^32 = 0 mod 2^32). Each thread
// owns a run of kRun = 32 consecutive positions s .. s+31. It warms up
// over the W-1 positions before s from h = 0 (positions before 0 hold
// g = 0, so no clamp is needed), then rolls through its run at 2-4
// integer operations a position instead of W. The first step of the run
// subtracts nothing: the warm-up never added g_{s-W}.
//
// Memory traffic. A block of 256 threads covers 8192 positions. It stages
// their bytes plus a 64-byte halo with 16-byte loads, turns each byte into
// g once (the gear table sits in shared memory; a lookup with 32 different
// bytes a warp would serialise in the constant cache), and keeps g as
// uint32 rows of 32 positions at a pitch of 33 words, so the 32 lanes of a
// warp, each reading the same offset of its own run, hit 32 banks. The
// hashes stay in registers until the run is done, then go out through
// shared memory (the same buffer, reused): each lane writes its run as 8
// 16-byte chunks, XOR-swizzled by lane, and the warp reads them back so
// that 32 lanes store 512 consecutive bytes with 16-byte stores. Each
// thread builds the two 32-bit candidate words of its own run (bit i of
// word w is position 32w + i), so no ballot is needed and a warp writes
// 128 consecutive bytes per map.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 32;                         // positions per thread
constexpr int kBlockPos = kThreads * kRun;       // 8192 positions per block
constexpr int kHalo = 64;                        // bytes staged before the block
constexpr int kMaxTaps = kHalo + 1;              // W - 1 <= kHalo
constexpr int kRows = (kHalo + kBlockPos) / kRun;  // 258 rows of 32 positions
constexpr int kPitch = kRun + 1;                 // words per staged row
constexpr int kWarps = kThreads / 32;

static_assert(kHalo % 16 == 0 && kHalo % kRun == 0, "halo must keep 16-byte loads aligned");
static_assert(kRows * kPitch >= kWarps * 32 * kRun, "the output staging reuses the g rows");

// staged position `rel` (0 = the first halo byte) -> its word in the g rows
__device__ __forceinline__ int slot(int rel) { return (rel >> 5) * kPitch + (rel & 31); }

template <bool kGear>
__global__ void __launch_bounds__(kThreads)
rolling_scan_kernel(const uint8_t* __restrict__ data, int64_t n, int aligned,
                    const uint32_t* __restrict__ table, uint32_t r,
                    uint32_t r_w, int taps, uint32_t mask_s, uint32_t mask_l,
                    uint32_t* __restrict__ out, uint32_t* __restrict__ bits_s,
                    uint32_t* __restrict__ bits_l) {
  __shared__ uint32_t gtab[256];
  __shared__ __align__(16) uint32_t rows[kRows * kPitch];
  if (kGear) gtab[threadIdx.x] = table[threadIdx.x];
  __syncthreads();

  const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlockPos;
  const int64_t first = base - kHalo;  // stream position of rel 0
  // stage g over [first, base + kBlockPos) in 16-byte pieces
  for (int m = threadIdx.x; m < (kHalo + kBlockPos) / 16; m += kThreads) {
    const int64_t p = first + 16 * m;
    uint8_t b[16];
    if (aligned && p >= 0 && p + 16 <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(data + p);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) b[j] = static_cast<uint8_t>(w[j >> 2] >> (8 * (j & 3)));
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) b[j] = (p + j >= 0 && p + j < n) ? data[p + j] : 0;
    }
    uint32_t* dst = rows + slot(16 * m);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const bool real = p + j >= 0;  // g_j = 0 before the stream, also for gear
      dst[j] = real ? (kGear ? gtab[b[j]] : static_cast<uint32_t>(b[j])) : 0u;
    }
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int rel0 = kHalo + kRun * t;  // rel of this thread's first position
  uint32_t h = 0;
  // warm-up over positions s-(W-1) .. s-1
#pragma unroll 4
  for (int k = taps - 1; k >= 1; --k) h = h * r + rows[slot(rel0 - k)];
  uint32_t hs[kRun];
  uint32_t ws = 0, wl = 0;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    h = h * r + rows[slot(rel0 + i)];
    if (!kGear && i > 0) h -= r_w * rows[slot(rel0 + i - taps)];
    hs[i] = h;
    ws |= static_cast<uint32_t>((h & mask_s) == 0u) << i;
    wl |= static_cast<uint32_t>((h & mask_l) == 0u) << i;
  }

  const int64_t s = base + kRun * t;
  if (bits_s != nullptr && s < n) {
    const int64_t left = n - s;
    const uint32_t keep = left >= kRun ? 0xffffffffu : (1u << left) - 1u;
    bits_s[s >> 5] = ws & keep;
    bits_l[s >> 5] = wl & keep;
  }
  __syncthreads();  // every thread is done reading the g rows
  const int lane = t & 31;
  uint4* stage = reinterpret_cast<uint4*>(rows) + (t >> 5) * (32 * kRun / 4);
  // lane L's run is row L of its warp's [32][8] chunks, chunk c at c ^ (L & 7)
#pragma unroll
  for (int c = 0; c < kRun / 4; ++c) {
    stage[lane * 8 + (c ^ (lane & 7))] =
        make_uint4(hs[4 * c], hs[4 * c + 1], hs[4 * c + 2], hs[4 * c + 3]);
  }
  __syncwarp();
  const int64_t wbase = base + static_cast<int64_t>(t >> 5) * 32 * kRun;
#pragma unroll
  for (int k = 0; k < kRun / 4; ++k) {
    const int pos = 128 * k + 4 * lane;  // position in the warp's 1024
    const int row = pos >> 5, c = (pos & 31) >> 2;
    const uint4 v = stage[row * 8 + (c ^ (row & 7))];
    const int64_t p = wbase + pos;
    if (p + 4 <= n) {
      *reinterpret_cast<uint4*>(out + p) = v;
    } else {
      const uint32_t vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (p + j < n) out[p + j] = vals[j];
      }
    }
  }
}

}  // namespace

// C entry, launched on `stream`: h_i = sum_{k<taps} r^k g_{i-k}. `table`
// (256 device uint32) selects gear's GEAR_TABLE[byte] over the raw byte
// (null); gear needs r = 2 and taps = 32, where r^W vanishes. `out`
// holds n hashes and is 16-byte aligned; `bits_s`/`bits_l` may both be
// null (hashes only), otherwise each holds ceil(n / 32) words. Allocates
// nothing; returns the first CUDA error.
extern "C" int repro_windowed_sum(const void* data, long long n,
                                  const void* table, unsigned r, int taps,
                                  unsigned mask_s, unsigned mask_l, void* out,
                                  void* bits_s, void* bits_l, void* stream) {
  if (n <= 0 || taps < 1 || taps > kMaxTaps) return cudaErrorInvalidValue;
  if (out == nullptr || (bits_s == nullptr) != (bits_l == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return cudaErrorMisalignedAddress;  // hashes leave in 16-byte stores
  }
  uint32_t r_w = 1;  // r^W mod 2^32
  for (int k = 0; k < taps; ++k) r_w *= r;
  if (table != nullptr && r_w != 0u) return cudaErrorInvalidValue;
  const long long blocks = (n + kBlockPos - 1) / kBlockPos;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int aligned = (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* d8 = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint32_t*>(out);
  auto* bs = static_cast<uint32_t*>(bits_s);
  auto* bl = static_cast<uint32_t*>(bits_l);
  if (table != nullptr) {
    rolling_scan_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        d8, n, aligned, static_cast<const uint32_t*>(table), r, r_w, taps,
        mask_s, mask_l, o, bs, bl);
  } else {
    rolling_scan_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        d8, n, aligned, nullptr, r, r_w, taps, mask_s, mask_l, o, bs, bl);
  }
  return static_cast<int>(cudaGetLastError());
}
