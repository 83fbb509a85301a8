// Batched segment sum: out[r, c, s] = sum over w with seg[r, w] == s of vals[r, c, w].
//
// Replaces the Pallas TPU kernel lidar_visual_odometry_tpu/ops/pallas_segsum.py
// (segment_sum_batched / _segsum_kernel), which builds an (S, W) one-hot on the
// TPU's matrix unit for each ring. On the main path it reduces the per-ring
// voxel runs of the less-flat filter: seg (64, 2048) int32, vals (64, 4, 2048)
// float32, S = 513 (512 voxels + the overflow bucket), once per frame.
//
// What bounds it on an H100: bytes. The function reads seg and vals once and
// writes out once (about 3 MB per frame, under 1 us at 3.35 TB/s); its few adds
// per point are nothing. At these sizes the launch and one pass over a ring per
// block dominate.
//
// Design: one block per ring row; every sum has exactly one writer and a
// fixed order of additions, so there are no atomics and the result is the same
// from run to run. Two paths, chosen per row inside the kernel:
//  * sorted row (ids never decrease, as the voxel filter produces them): the
//    row's ids are staged in shared memory, one pass writes each segment's
//    first index (start[s], a lower bound for every s at once), and a warp per
//    segment sums its run [start[s], start[s+1]) with lanes striding over the
//    points (coalesced loads) and a butterfly shuffle at the end. Runs are
//    short (a few points per voxel) except the overflow bucket, which holds
//    every masked point of the ring; the lanes split that long run 32 ways.
//  * any other row: the (C, S) sums live in shared memory (4 x 513 x 4 B ~ 8 KB),
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
                              int stage_sorted) {
  extern __shared__ float smem[];
  float* acc = smem;                                  // (C, S)
  int* tile_seg = reinterpret_cast<int*>(acc + C * S);  // (kTile,)
  float* tile_val = reinterpret_cast<float*>(tile_seg + kTile);  // (C, kTile)

  const int r = blockIdx.x;
  const int* seg_r = seg + static_cast<long long>(r) * W;
  const float* vals_r = vals + static_cast<long long>(r) * C * W;
  float* out_r = out + static_cast<long long>(r) * C * S;

  int unsorted = 0;
  for (int i = threadIdx.x; i + 1 < W; i += blockDim.x) unsorted |= seg_r[i] > seg_r[i + 1];
  if (!__syncthreads_or(unsorted) && stage_sorted) {  // one branch for the block
    int* row = reinterpret_cast<int*>(smem);  // (W,) ids
    int* start = row + W;                      // (S + 1,) first index of each id
    for (int i = threadIdx.x; i < W; i += blockDim.x) row[i] = seg_r[i];
    __syncthreads();
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const int lo = w == 0 ? 0 : max(row[w - 1] + 1, 0);
      const int hi = min(row[w], S);
      for (int s = lo; s <= hi; ++s) start[s] = w;  // ids in (row[w-1], row[w]]
    }
    for (int s = max(row[W - 1] + 1, 0) + threadIdx.x; s <= S; s += blockDim.x) start[s] = W;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    for (int s = threadIdx.x >> 5; s < S; s += blockDim.x >> 5) {
      float sum[kMaxC];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) sum[c] = 0.0f;
      for (int w = start[s] + lane; w < start[s + 1]; w += 32) {
#pragma unroll
        for (int c = 0; c < kMaxC; ++c)
          if (c < C) sum[c] += vals_r[static_cast<long long>(c) * W + w];
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
        tile_val[c * kTile + i] = vals_r[static_cast<long long>(c) * W + w0 + i];
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

}  // namespace

extern "C" int lvo_segment_sum_batched(const void* seg, const void* vals, void* out,
                                       int R, int C, int W, int S, void* stream) {
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
      static_cast<float*>(out), C, W, S, stage_sorted);
  return cudaGetLastError();
}
