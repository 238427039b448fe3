// Kernel C: cosine top-1 of each query against the stored index.
//
//   score[b] = max_n q[b] . index[n],   row[b] = the lowest n attaining it
//
// computed in fp32 with a running (max, argmax); the [B, N] score matrix
// is never stored.
//
// Replaces: src/repro/kernels/sim_topk.py:45 `sim_topk` (its
// pl.pallas_call at :60).
//
// What bounds it on the H100: fp32 operations. 2*B*N*D FLOP against
// 4*(B + N)*D bytes; at B = 4096, N = 2^20, D = 50 that is 4.3e11 FLOP
// (~6.4 ms at the 67 TFLOP/s fp32 peak) against ~200 MiB (~0.06 ms).
// Scores are fp32 FMAs, never TF32: TF32 keeps ~3 decimal digits and could
// flip an argmax or a verdict at the 0.3 threshold
// (src/repro/core/similarity.py:75, src/repro/core/pipeline.py:212-215).
// Shared-memory reads, not FMA issue, appear to hold an fp32 tile product
// below that peak (a 16-byte shared load seems to take as much of the
// shared-memory pipe as four 4-byte ones even when its lanes share
// addresses; no profiler that sees inside a kernel ran). An 8 x 8 tile a
// thread reads 8 + 8 words a column for 64 FMAs and ran at 11.4-12.3 ms
// at B 4096, N 2^20, D 50; an 8 x 16 tile reads 8 + 16 words for 128
// FMAs and runs at 9.6 ms (NVIDIA H100 80GB HBM3, 700 W; topk_sweep.py,
// PERF.md).
//
// Design: grid = (query blocks of 128, the fastest axis) x (splits of N),
// so the blocks that share an index range run together and each index
// tile comes from device memory about once. A block keeps its 128 queries
// in shared memory, transposed to [D][128], while 128-row index tiles
// stream through a two-stage ring filled by cp.async: tile j + 1 is in
// flight while tile j is computed, and one barrier a tile both publishes
// tile j and frees tile j - 1's stage for the next copy. At D 50 a tile
// is 128 consecutive rows, one contiguous 16-byte-aligned run of 25,600
// bytes, copied in 16-byte pieces as it lies ([128][D], row-major). 128
// threads, 16 along the queries and 8 along the rows, each own an 8 x 16
// micro tile: queries 4ty..4ty+3 and 64+4ty..64+4ty+3 (two 16-byte loads
// a column) and rows tx + 8j (at D 50 one 8-byte load covers a row's two
// columns): 256 FMAs per 20 loads, 8 + 16 words read per 128 FMAs. Read at
// a row pitch of 50 words the 8 rows of a load fall in distinct banks
// (50 mod 32 = 18); a pitch that is a multiple of 4 words would not, so
// such D (16, 64, ...) get the pitch D + 1 and a 4-byte copy per element.
// D above 64 is walked in 64-column chunks, the queries then staged per
// chunk beside the tile; the accumulators carry across the chunks. At 189
// registers two blocks of 4 warps share an SM.
//
// Exact arithmetic: every score is one fmaf chain over c = 0 .. D-1 in
// ascending order from +0.0f, whatever the tiling. Each thread walks its rows in ascending order keeping a running
// max with strict `>` (first max wins); an 8-lane shuffle then merges the
// per-thread bests with "higher score, else lower row". The TPU kernel
// carries the running best across its sequential N grid
// (sim_topk.py:24-41); CUDA blocks run in no order and cannot carry
// state, so each split writes a partial best and a second small pass
// merges the splits in ascending row order with strict `>` (lowest row
// wins ties). Rows at or past N never win, as `n_valid` masks padding in
// sim_topk.py:34-35.
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;         // queries per block, index rows per tile
constexpr int kChunk = 64;         // columns of D per step
constexpr int kStages = 2;         // index tiles in the cp.async ring
constexpr int kTx = 8;             // threads along the index rows
constexpr int kRowsPer = kTile / kTx;  // rows a thread owns: 16
constexpr int kThreads = kTx * 16; // 16 along the queries, 8 queries each
constexpr int kReduceThreads = 256;
constexpr int kMainD = 50;         // the context model's d on the main path
static_assert(kMainD % 4 == 2 && kMainD <= kChunk,
              "kMainD must take the contiguous copy and the paired column loads");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy `bytes` (0 .. 16) of src and zero-fill the rest of 16 bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes) : "memory");
}

// copy one float, or zero-fill it when `valid` is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void merge_best(float& s, int& r, float s2, int r2) {
  if (s2 > s || (s2 == s && r2 < r)) {
    s = s2;
    r = r2;
  }
}

// queries [q0, q0 + 128) x columns [col0, col0 + width) -> dst[c][128]
__device__ __forceinline__ void stage_queries(float* dst, const float* q, int rows_q,
                                              int d, int q0, int col0, int width) {
  for (int e = threadIdx.x; e < kTile * width; e += kThreads) {
    const int r = e / width;
    const int c = e - r * width;
    const int qi = min(q0 + r, rows_q - 1);
    cp_async4(dst + c * kTile + r, q + static_cast<int64_t>(qi) * d + col0 + c,
              q0 + r < rows_q);
  }
}

// index rows [n0, n0 + 128) x columns [col0, col0 + width) -> dst[128][pitch]
__device__ __forceinline__ void stage_rows(float* dst, const float* index, int rows_n,
                                           int d, int64_t n0, int col0, int width,
                                           int pitch, bool contiguous) {
  if (contiguous) {  // pitch == width == d: the tile is one run of 512 * d bytes
    const int64_t first = n0 * d * 4;
    const int64_t total = static_cast<int64_t>(rows_n) * d * 4;
    const char* src = reinterpret_cast<const char*>(index);
    for (int e = threadIdx.x; e < 32 * d; e += kThreads) {
      const int64_t off = first + 16 * static_cast<int64_t>(e);
      const int64_t left = total - off;
      const int bytes = left >= 16 ? 16 : (left > 0 ? static_cast<int>(left) : 0);
      cp_async16(dst + 4 * e, bytes > 0 ? src + off : src, bytes);
    }
    return;
  }
  for (int e = threadIdx.x; e < kTile * width; e += kThreads) {
    const int r = e / width;
    const int c = e - r * width;
    const int64_t ni = n0 + r;
    const int64_t row = ni < rows_n ? ni : rows_n - 1;
    cp_async4(dst + r * pitch + c, index + row * d + col0 + c, ni < rows_n);
  }
}

// kD > 0 fixes D (and the pitch, = D) at compile time, so the row loads of
// the inner loop take immediate offsets; kD = 0 takes both at run time
template <int kD>
__global__ void __launch_bounds__(kThreads, 2)
sim_topk_partial_kernel(const float* __restrict__ q,
                        const float* __restrict__ index, int rows_q,
                        int rows_n, int d_arg, int pitch_arg, int contiguous,
                        int tiles_per_split, float* __restrict__ part_s,
                        int* __restrict__ part_r) {
  extern __shared__ __align__(16) float smem[];
  const int d = kD > 0 ? kD : d_arg;
  const int pitch = kD > 0 ? kD : pitch_arg;
  const int nch = (d + kChunk - 1) / kChunk;
  const int kc = nch == 1 ? d : kChunk;
  // nch == 1: [D][128] queries once, then two stages of [128][pitch] rows;
  // nch > 1:  two stages of ([128][pitch] rows, [kc][128] queries)
  float* q_once = smem;
  float* ring = nch == 1 ? smem + d * kTile : smem;
  const int stage_floats = kTile * pitch + (nch == 1 ? 0 : kc * kTile);

  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const int q0 = blockIdx.x * kTile;
  const int ntiles = (rows_n + kTile - 1) / kTile;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  const int steps = (t_end - t_begin) * nch;

  auto issue = [&](int step) {
    const int t = t_begin + step / nch;
    const int k = step - (step / nch) * nch;
    const int col0 = k * kChunk;
    const int width = min(kc, d - col0);
    float* st = ring + (step % kStages) * stage_floats;
    stage_rows(st, index, rows_n, d, static_cast<int64_t>(t) * kTile, col0, width,
               pitch, contiguous != 0);
    if (nch > 1) stage_queries(st + kTile * pitch, q, rows_q, d, q0, col0, width);
  };

  if (nch == 1) stage_queries(q_once, q, rows_q, d, q0, 0, d);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) issue(st);
    cp_async_commit();
  }

  float best[8];
  int arg[8];
  float acc[8][kRowsPer];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = -INFINITY;
    arg[i] = 0;
#pragma unroll
    for (int j = 0; j < kRowsPer; ++j) acc[i][j] = 0.f;
  }

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // this step's group has landed
    // ... for every thread, and every thread is done with the previous
    // step's stage, which the issue below refills
    __syncthreads();
    if (step + kStages - 1 < steps) issue(step + kStages - 1);
    cp_async_commit();

    const int t = t_begin + step / nch;
    const int k = step - (step / nch) * nch;
    const int width = min(kc, d - k * kChunk);
    const float* xs = ring + (step % kStages) * stage_floats;
    const float* qs = nch == 1 ? q_once : xs + kTile * pitch;
    const float* xrow = xs + tx * pitch;
    if constexpr (kD > 0 && kD % 2 == 0) {
      // two columns a step: each row's pair in one 8-byte load. Not
      // unrolled: at 189 registers it ran 2 % faster than 5 steps an
      // iteration at 255 registers (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
#pragma unroll 1
      for (int c = 0; c < kD; c += 2) {
        float2 xb2[kRowsPer];
#pragma unroll
        for (int j = 0; j < kRowsPer; ++j) {
          xb2[j] = *reinterpret_cast<const float2*>(xrow + kTx * j * kD + c);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* qc = qs + (c + h) * kTile;
          const float4 qa0 = *reinterpret_cast<const float4*>(qc + 4 * ty);
          const float4 qa1 = *reinterpret_cast<const float4*>(qc + 64 + 4 * ty);
          const float qa[8] = {qa0.x, qa0.y, qa0.z, qa0.w, qa1.x, qa1.y, qa1.z, qa1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int j = 0; j < kRowsPer; ++j) {
              acc[i][j] = fmaf(qa[i], h == 0 ? xb2[j].x : xb2[j].y, acc[i][j]);
            }
          }
        }
      }
    } else {
#pragma unroll 2
      for (int c = 0; c < width; ++c) {
        const float4 qa0 = *reinterpret_cast<const float4*>(qs + c * kTile + 4 * ty);
        const float4 qa1 = *reinterpret_cast<const float4*>(qs + c * kTile + 64 + 4 * ty);
        const float qa[8] = {qa0.x, qa0.y, qa0.z, qa0.w, qa1.x, qa1.y, qa1.z, qa1.w};
        float xb[kRowsPer];
#pragma unroll
        for (int j = 0; j < kRowsPer; ++j) xb[j] = xrow[kTx * j * pitch + c];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < kRowsPer; ++j) acc[i][j] = fmaf(qa[i], xb[j], acc[i][j]);
        }
      }
    }

    if (k == nch - 1) {
      // ascending rows within the thread: strict > keeps the first max
      const int n0 = t * kTile;  // rows_n <= INT_MAX - kTile: no overflow
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j) {
        const int row = n0 + tx + kTx * j;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (row < rows_n && acc[i][j] > best[i]) {
            best[i] = acc[i][j];
            arg[i] = row;
          }
          acc[i][j] = 0.f;
        }
      }
    }
  }

  // merge the kTx threads (tx) that share each query: lanes tx of one ty
  // are kTx consecutive lanes of a warp
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = kTx / 2; o > 0; o >>= 1) {
      const float s2 = __shfl_xor_sync(0xffffffffu, best[i], o);
      const int r2 = __shfl_xor_sync(0xffffffffu, arg[i], o);
      merge_best(best[i], arg[i], s2, r2);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qi = q0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
      if (qi < rows_q) {
        part_s[static_cast<int64_t>(blockIdx.y) * rows_q + qi] = best[i];
        part_r[static_cast<int64_t>(blockIdx.y) * rows_q + qi] = arg[i];
      }
    }
  }
}

__global__ void sim_topk_reduce_kernel(const float* __restrict__ part_s,
                                       const int* __restrict__ part_r,
                                       int rows_q, int splits,
                                       float* __restrict__ out_s,
                                       int* __restrict__ out_r) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= rows_q) return;
  float s = part_s[qi];
  int r = part_r[qi];
  // splits cover ascending row ranges: strict > keeps the lowest row
  for (int k = 1; k < splits; ++k) {
    const float s2 = part_s[static_cast<int64_t>(k) * rows_q + qi];
    if (s2 > s) {
      s = s2;
      r = part_r[static_cast<int64_t>(k) * rows_q + qi];
    }
  }
  out_s[qi] = s;
  out_r[qi] = r;
}

// words per staged index row: D itself when 8 rows at that pitch fall in
// distinct banks (D mod 4 != 0), else D + 1 (odd)
int row_pitch(int width) { return width % 4 != 0 ? width : width + 1; }

}  // namespace

// C entry, launched on `stream`: q [rows_q, d] f32, index [rows_n, d] f32
// -> out_s [rows_q] f32, out_r [rows_q] int32. `part_s`/`part_r` are
// caller-allocated scratch of [splits, rows_q]; split k covers index tiles
// [k * tiles_per_split, (k + 1) * tiles_per_split) of 128 rows each.
// Allocates nothing; returns cudaGetLastError().
extern "C" int repro_sim_topk(const void* q, const void* index, int rows_q,
                              int rows_n, int d, int splits,
                              int tiles_per_split, void* part_s, void* part_r,
                              void* out_s, void* out_r, void* stream) {
  if (rows_q <= 0 || rows_n <= 0 || rows_n > INT_MAX - kTile || d <= 0 || d > 256 ||
      splits <= 0 || tiles_per_split <= 0) {
    return cudaErrorInvalidValue;
  }
  const int ntiles = (rows_n + kTile - 1) / kTile;
  if (static_cast<long long>(splits) * tiles_per_split < ntiles ||
      static_cast<long long>(splits - 1) * tiles_per_split >= ntiles) {
    return cudaErrorInvalidValue;  // every split must own >= 1 tile
  }
  const int nch = (d + kChunk - 1) / kChunk;
  const int kc = nch == 1 ? d : kChunk;
  const int pitch = row_pitch(kc);
  const int contiguous =
      nch == 1 && pitch == d && (reinterpret_cast<uintptr_t>(index) & 15) == 0;
  const size_t stage = static_cast<size_t>(kTile) * pitch + (nch == 1 ? 0 : kc * kTile);
  const size_t smem = sizeof(float) * ((nch == 1 ? d * kTile : 0) + kStages * stage);
  // the main path's width (the context model's d) runs the fixed-D form
  auto* kernel = contiguous && d == kMainD ? sim_topk_partial_kernel<kMainD>
                                           : sim_topk_partial_kernel<0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows_q + kTile - 1) / kTile, splits);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(index), rows_q,
      rows_n, d, pitch, contiguous, tiles_per_split, static_cast<float*>(part_s),
      static_cast<int*>(part_r));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sim_topk_reduce_kernel<<<(rows_q + kReduceThreads - 1) / kReduceThreads,
                           kReduceThreads, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_r),
      rows_q, splits, static_cast<float*>(out_s), static_cast<int*>(out_r));
  return static_cast<int>(cudaGetLastError());
}
