// Kernel A: windowed weighted sum over a byte stream (gear hash / Rabin
// fingerprints), with the two FastCDC candidate maps fused in.
//
//   h_i = sum_{k<W} w_k * g_{i-k}   (uint32 wraparound)
//   g_j = GEAR_TABLE[byte_j] (gear) or byte_j (Rabin); g_j = 0 for j < 0
//
// Replaces: src/repro/kernels/gear_hash.py:43 `windowed_sum` (its
// pl.pallas_call at :50), and the scan that the reference main path runs
// as jnp in src/repro/kernels/ingest.py:123 `_scan_fused` (hashes plus the
// two `(h & mask) == 0` candidate maps).
//
// What bounds it on the H100: device-memory bytes. Per position it reads
// 1 byte and writes a 4-byte hash plus 2 candidate bits (~5.25 B). The
// function's least work is a few integer operations per position (the
// serial recurrence h = (h << 1) + g and two mask tests), far below the
// card's rate; the W multiply-adds per position of this windowed form are
// not, and they are what keep it above its byte bound.
//
// Design: one thread per position. A block stages its 256 positions plus
// the W-1 halo before them in shared memory (one coalesced byte load per
// element), so every tap reads shared memory instead of device memory.
// The taps live in __constant__ memory: every lane of a warp reads the
// same tap at the same time, which the constant cache serves in one
// broadcast. The gear table also arrives in __constant__ but is copied
// into shared memory once per block, since a lookup with 32 different
// bytes per warp would serialise in the constant cache. Both arrive in
// device memory (uploaded once by the launcher) and the C entry copies
// them device-to-device with cudaMemcpyToSymbolAsync on the launch
// stream: a copy from device memory never waits for the host, and a
// later launch with other taps (Rabin after gear) is ordered after this
// one. The uint32 multiply-add wraps natively. Each candidate map is a
// warp ballot: bit i of word w is position 32w + i, so a warp writes one
// 32-bit word per map instead of 32 bools. The TPU kernel's [R, C] row
// layout and its row-0 zero halo were a TPU tiling; here the stream is
// flat and positions before 0 contribute 0. This simple form reads W
// shared-memory words per position, which costs more than the
// device-memory traffic it was meant to hide; a sliding window held in
// registers (several positions per thread) is the faster form.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 64;

__constant__ uint32_t c_taps[kMaxTaps];
__constant__ uint32_t c_gear[256];

__global__ void __launch_bounds__(kThreads)
windowed_sum_kernel(const uint8_t* __restrict__ data, int64_t n,
                    int use_table, int ntaps, uint32_t mask_s,
                    uint32_t mask_l, uint32_t* __restrict__ out,
                    uint32_t* __restrict__ bits_s,
                    uint32_t* __restrict__ bits_l) {
  __shared__ uint32_t gtab[256];
  __shared__ uint32_t tile[kThreads + kMaxTaps - 1];
  if (use_table) gtab[threadIdx.x] = c_gear[threadIdx.x];
  __syncthreads();

  const int halo = ntaps - 1;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  // tile[j] holds g at stream position base - halo + j
  for (int j = threadIdx.x; j < kThreads + halo; j += kThreads) {
    const int64_t p = base - halo + j;
    uint32_t v = 0;
    if (p >= 0 && p < n) {
      const uint32_t byte = data[p];
      v = use_table ? gtab[byte] : byte;
    }
    tile[j] = v;
  }
  __syncthreads();

  const int64_t i = base + threadIdx.x;
  uint32_t h = 0;
#pragma unroll 8
  for (int k = 0; k < ntaps; ++k) {
    h += c_taps[k] * tile[threadIdx.x + halo - k];
  }
  const bool valid = i < n;
  if (valid && out != nullptr) out[i] = h;
  if (bits_s != nullptr) {
    // every lane reaches the ballots (no early return above)
    const unsigned ws = __ballot_sync(0xffffffffu, valid && (h & mask_s) == 0u);
    const unsigned wl = __ballot_sync(0xffffffffu, valid && (h & mask_l) == 0u);
    if ((threadIdx.x & 31) == 0 && valid) {
      bits_s[i >> 5] = ws;
      bits_l[i >> 5] = wl;
    }
  }
}

}  // namespace

// C entry, launched on `stream`. `table` (256 device uint32, or null for
// raw bytes) and `taps` (ntaps device uint32) are copied into __constant__
// memory on `stream`. `out` may be null (candidate maps only);
// `bits_s`/`bits_l` may both be null (hashes only); otherwise each holds
// ceil(n / 32) words. Allocates nothing; returns the first CUDA error.
extern "C" int repro_windowed_sum(const void* data, long long n,
                                  const void* table, const void* taps,
                                  int ntaps, unsigned mask_s, unsigned mask_l,
                                  void* out, void* bits_s, void* bits_l,
                                  void* stream) {
  if (n <= 0 || ntaps < 1 || ntaps > kMaxTaps) return cudaErrorInvalidValue;
  if ((bits_s == nullptr) != (bits_l == nullptr)) return cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_taps, taps, sizeof(uint32_t) * ntaps, 0, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (table != nullptr) {
    err = cudaMemcpyToSymbolAsync(c_gear, table, sizeof(uint32_t) * 256, 0,
                                  cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  windowed_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(data), static_cast<int64_t>(n),
      table != nullptr ? 1 : 0, ntaps, mask_s, mask_l,
      static_cast<uint32_t*>(out), static_cast<uint32_t*>(bits_s),
      static_cast<uint32_t*>(bits_l));
  return static_cast<int>(cudaGetLastError());
}
