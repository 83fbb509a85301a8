// Segment sum: out[r, c, s] = sum over w with seg[r, w] == s of vals[r, c, w].
//
// Replaces the Pallas TPU kernel lidar_visual_odometry_tpu/ops/pallas_segsum.py
// (segment_sum_batched / _segsum_kernel), which builds an (S, W) one-hot on the
// TPU's matrix unit for each row. Two callers on the main path:
//  * lvo_segment_sum_batched: the per-ring voxel runs of the less-flat filter,
//    seg (64, 2048) int32, vals (64, 4, 2048) float32, S = 513 (512 voxels +
//    the overflow bucket), once per frame;
//  * lvo_segment_sum_flat: the flat segment_sum of the mapping voxel filter
//    (pallas_segsum.py:72), seg (W,) and vals (C, W) with W 7680 (less-sharp)
//    or 32768 (less-flat), C 4, S 4097, cut into rows of `row` points that are
//    summed one block each; the caller adds the (R, C, S) row partials. The
//    rows read vals in place through (row, channel) strides, and the last row
//    may be short.
//
// What bounds it on an H100: bytes. The function reads seg and vals once and
// writes out once (about 3 MB per frame, under 1 us at 3.35 TB/s); its few adds
// per point are nothing. At these sizes the launch and one pass over a row per
// block dominate.
//
// Design: one block per row; every sum has exactly one writer and a
// fixed order of additions, so there are no atomics and the result is the same
// from run to run. Two paths, chosen per row inside the kernel:
//  * sorted row (ids never decrease, as the voxel filters produce them): the
//    row's ids are staged in shared memory, each thread binary-searches the
//    first index start[s] of a few segments (in parallel: a row may be all
//    overflow bucket, so a fill by ranges of ids would leave one thread
//    thousands of steps), and a warp per
//    segment sums its run [start[s], start[s+1]) with lanes striding over the
//    points (coalesced loads) and a butterfly shuffle at the end. An empty run
//    writes zeros without the shuffles: at S = 4097 most segments of a row are
//    empty. Runs are short (a few points per voxel) except the overflow
//    bucket, which holds every masked point of the row; the lanes split that
//    long run 32 ways.
//  * any other row: the (C, S) sums live in shared memory (4 x 513 x 4 B ~ 8 KB;
//    64 KB at S = 4097, above the 48 KB default, so the launcher opts in),
//    the row's ids and values are staged through shared memory in tiles of
//    kTile points with coalesced loads, and the thread that owns a segment
//    scans every tile for it, adding in ascending w (S x W compares per row).
// Ids outside [0, S) match no segment and are dropped, as the one-hot of the
// TPU kernel drops them. The TPU kernel's padding of S to 128 lanes is a TPU
// layout rule and is not kept.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 512;
constexpr int kMaxC = 8;
constexpr size_t kMaxStagedBytes = 160 * 1024;  // sorted path: W + S + 1 ids

__global__ void __launch_bounds__(kThreads) segsum_kernel(const int* __restrict__ seg,
                              const float* __restrict__ vals,
                              float* __restrict__ out, int C, int W, int S,
                              int stage_sorted, long long row_stride,
                              long long chan_stride, long long w_total) {
  extern __shared__ float smem[];
  float* acc = smem;                                  // (C, S)
  int* tile_seg = reinterpret_cast<int*>(acc + C * S);  // (kTile,)
  float* tile_val = reinterpret_cast<float*>(tile_seg + kTile);  // (C, kTile)

  const int r = blockIdx.x;
  const int* seg_r = seg + static_cast<long long>(r) * W;
  const float* vals_r = vals + static_cast<long long>(r) * row_stride;
  float* out_r = out + static_cast<long long>(r) * C * S;
  W = static_cast<int>(min(static_cast<long long>(W), w_total - static_cast<long long>(r) * W));

  int unsorted = 0;
  for (int i = threadIdx.x; i + 1 < W; i += blockDim.x) unsorted |= seg_r[i] > seg_r[i + 1];
  if (!__syncthreads_or(unsorted) && stage_sorted) {  // one branch for the block
    int* row = reinterpret_cast<int*>(smem);  // (W,) ids
    int* start = row + W;                      // (S + 1,) first index of each id
    for (int i = threadIdx.x; i < W; i += blockDim.x) row[i] = seg_r[i];
    __syncthreads();
    for (int s = threadIdx.x; s <= S; s += blockDim.x) {
      int lo = 0, hi = W;  // start[s]: the first w with row[w] >= s (W if none)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row[mid] < s) lo = mid + 1; else hi = mid;
      }
      start[s] = lo;
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    for (int s = threadIdx.x >> 5; s < S; s += blockDim.x >> 5) {
      const int run_begin = start[s], run_end = start[s + 1];
      if (run_begin == run_end) {  // warp-uniform: an empty run sums to zero
        if (lane < C) out_r[lane * S + s] = 0.0f;
        continue;
      }
      float sum[kMaxC];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) sum[c] = 0.0f;
      for (int w = run_begin + lane; w < run_end; w += 32) {
#pragma unroll
        for (int c = 0; c < kMaxC; ++c)
          if (c < C) sum[c] += vals_r[c * chan_stride + w];
      }
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        float v = sum[c];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0 && c < C) out_r[c * S + s] = v;
      }
    }
    return;
  }

  for (int i = threadIdx.x; i < C * S; i += blockDim.x) acc[i] = 0.0f;

  for (int w0 = 0; w0 < W; w0 += kTile) {
    const int n = min(kTile, W - w0);
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < n; i += blockDim.x) tile_seg[i] = seg_r[w0 + i];
    for (int c = 0; c < C; ++c)
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        tile_val[c * kTile + i] = vals_r[c * chan_stride + w0 + i];
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      // Continue the running sums in registers, so each value is added in
      // ascending w order, exactly as a sequential scatter-add would.
      float sum[kMaxC];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) sum[c] = c < C ? acc[c * S + s] : 0.0f;
      for (int i = 0; i < n; ++i) {
        if (tile_seg[i] == s) {  // every lane reads the same id: a broadcast
#pragma unroll
          for (int c = 0; c < kMaxC; ++c)
            if (c < C) sum[c] += tile_val[c * kTile + i];
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxC; ++c)
        if (c < C) acc[c * S + s] = sum[c];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C * S; i += blockDim.x) out_r[i] = acc[i];
}

cudaError_t launch(const void* seg, const void* vals, void* out, int R, int C, int W,
                   int S, long long row_stride, long long chan_stride, long long w_total,
                   void* stream) {
  if (R <= 0 || C <= 0 || C > kMaxC || W <= 0 || S <= 0) return cudaErrorInvalidValue;
  const size_t tiled = sizeof(float) * (static_cast<size_t>(C) * S + kTile * C) +
                       sizeof(int) * kTile;
  const size_t staged = sizeof(int) * (static_cast<size_t>(W) + S + 1);
  const int stage_sorted = staged <= kMaxStagedBytes;
  const size_t smem = stage_sorted && staged > tiled ? staged : tiled;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        segsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  segsum_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg), static_cast<const float*>(vals),
      static_cast<float*>(out), C, W, S, stage_sorted, row_stride, chan_stride, w_total);
  return cudaGetLastError();
}

}  // namespace

// seg (R, W) int32, vals (R, C, W) float32 -> out (R, C, S).
extern "C" int lvo_segment_sum_batched(const void* seg, const void* vals, void* out,
                                       int R, int C, int W, int S, void* stream) {
  return launch(seg, vals, out, R, C, W, S, static_cast<long long>(C) * W, W,
                static_cast<long long>(R) * W, stream);
}

// seg (W_total,) int32, vals (C, W_total) float32 -> out (R, C, S) row partials,
// R = ceil(W_total / row); the caller sums them over R.
extern "C" int lvo_segment_sum_flat(const void* seg, const void* vals, void* out,
                                    int C, int w_total, int row, int S, void* stream) {
  if (row <= 0 || w_total <= 0) return cudaErrorInvalidValue;
  const int R = (w_total + row - 1) / row;
  return launch(seg, vals, out, R, C, row, S, row, w_total, w_total, stream);
}
