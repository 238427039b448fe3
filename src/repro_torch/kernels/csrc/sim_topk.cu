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
//
// Design: grid = (query blocks of 64) x (splits of N). A block keeps its
// 64 queries in shared memory (transposed, [D][64]) while 64-row index
// tiles stream through shared memory; 16x16 threads each own a 4x4 micro
// tile of (query, row) scores, so each shared-memory load feeds 2 FMAs.
// Each thread walks its rows in ascending order keeping a running max with
// strict `>` (first max wins); a 16-lane shuffle then merges the per-thread
// bests with "higher score, else lower row". The TPU kernel carries the
// running best across its sequential N grid (sim_topk.py:24-41); CUDA
// blocks run in no order and cannot carry state, so each split writes a
// partial best and a second small pass merges the splits in ascending row
// order with strict `>` (lowest row wins ties). Rows at or past N are
// masked out, as `n_valid` masks padding in sim_topk.py:34-35.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;          // queries per block, index rows per tile
constexpr int kPitch = kTile + 1;  // shared-memory row pitch (bank spread)
constexpr int kThreads = 256;      // 16 x 16
constexpr int kReduceThreads = 256;

__device__ __forceinline__ void merge_best(float& s, int& r, float s2, int r2) {
  if (s2 > s || (s2 == s && r2 < r)) {
    s = s2;
    r = r2;
  }
}

__global__ void __launch_bounds__(kThreads)
sim_topk_partial_kernel(const float* __restrict__ q,
                        const float* __restrict__ index, int rows_q,
                        int rows_n, int d, int tiles_per_split,
                        float* __restrict__ part_s, int* __restrict__ part_r) {
  extern __shared__ float smem[];
  float* qs = smem;               // [d][kPitch]: this block's queries
  float* xs = smem + d * kPitch;  // [d][kPitch]: the current index tile
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kTile;
  const int split = blockIdx.y;

  for (int e = threadIdx.x; e < kTile * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    const int qi = q0 + r;
    qs[c * kPitch + r] = qi < rows_q ? q[static_cast<int64_t>(qi) * d + c] : 0.f;
  }

  float best[4];
  int arg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = -INFINITY;
    arg[i] = 0;
  }

  const int ntiles = (rows_n + kTile - 1) / kTile;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();  // queries staged / previous tile fully read
    const int64_t n0 = static_cast<int64_t>(t) * kTile;
    for (int e = threadIdx.x; e < kTile * d; e += kThreads) {
      const int r = e / d;
      const int c = e - r * d;
      const int64_t ni = n0 + r;
      xs[c * kPitch + r] = ni < rows_n ? index[ni * d + c] : 0.f;
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int c = 0; c < d; ++c) {
      float qa[4], xb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[c * kPitch + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) xb[j] = xs[c * kPitch + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qa[i], xb[j], acc[i][j]);
      }
    }
    // ascending rows within the thread: strict > keeps the first max
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t row = n0 + tx + 16 * j;
      if (row < rows_n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (acc[i][j] > best[i]) {
            best[i] = acc[i][j];
            arg[i] = static_cast<int>(row);
          }
        }
      }
    }
  }

  // merge the 16 threads (tx) that share each query: lanes tx of one ty
  // are 16 consecutive lanes of a warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float s2 = __shfl_xor_sync(0xffffffffu, best[i], o);
      const int r2 = __shfl_xor_sync(0xffffffffu, arg[i], o);
      merge_best(best[i], arg[i], s2, r2);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      if (qi < rows_q) {
        part_s[static_cast<int64_t>(split) * rows_q + qi] = best[i];
        part_r[static_cast<int64_t>(split) * rows_q + qi] = arg[i];
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

}  // namespace

// C entry, launched on `stream`: q [rows_q, d] f32, index [rows_n, d] f32
// -> out_s [rows_q] f32, out_r [rows_q] int32. `part_s`/`part_r` are
// caller-allocated scratch of [splits, rows_q]; split k covers index tiles
// [k * tiles_per_split, (k + 1) * tiles_per_split) of 64 rows each.
// Allocates nothing; returns cudaGetLastError().
extern "C" int repro_sim_topk(const void* q, const void* index, int rows_q,
                              int rows_n, int d, int splits,
                              int tiles_per_split, void* part_s, void* part_r,
                              void* out_s, void* out_r, void* stream) {
  if (rows_q <= 0 || rows_n <= 0 || d <= 0 || d > 256 || splits <= 0 ||
      tiles_per_split <= 0) {
    return cudaErrorInvalidValue;
  }
  const int ntiles = (rows_n + kTile - 1) / kTile;
  if (static_cast<long long>(splits) * tiles_per_split < ntiles ||
      static_cast<long long>(splits - 1) * tiles_per_split >= ntiles) {
    return cudaErrorInvalidValue;  // every split must own >= 1 tile
  }
  const size_t smem = static_cast<size_t>(2) * d * kPitch * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sim_topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows_q + kTile - 1) / kTile, splits);
  sim_topk_partial_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(index), rows_q,
      rows_n, d, tiles_per_split, static_cast<float*>(part_s),
      static_cast<int*>(part_r));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sim_topk_reduce_kernel<<<(rows_q + kReduceThreads - 1) / kReduceThreads,
                           kReduceThreads, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_r),
      rows_q, splits, static_cast<float*>(out_s), static_cast<int*>(out_r));
  return static_cast<int>(cudaGetLastError());
}
