// Segment sum: out[r, c, s] = sum over w with seg[r, w] == s of vals[r, c, w].
//
// Replaces the Pallas TPU kernel lidar_visual_odometry_tpu/ops/pallas_segsum.py
// (segment_sum_batched / _segsum_kernel, pallas_call at :57), which builds an
// (S, W) one-hot on the TPU's matrix unit for each row, and its flat form
// segment_sum (:72), which goes onto the same call. Two callers on the main path:
//  * lvo_segment_sum_batched (segsum_rows_kernel): the per-ring voxel runs of
//    the less-flat filter, seg (64, 2048) int32, vals (64, 4, 2048) float32,
//    S = 513 (512 voxels + the overflow bucket), once per frame;
//  * lvo_segment_sum_flat (segsum_flat_kernel): the mapping voxel filters,
//    seg (W,) and vals (C, W) with W 32768 (less-flat) or 7680 (less-sharp),
//    C 4, S 4097, twice per frame. It is the batched form with one row, in
//    one launch: no row partials, no second reduction.
//
// What bounds it on an H100: bytes. The function reads seg and vals once and
// writes out once: 0.94 us for the batched call and 0.28 us for the two flat
// calls at 3.35 TB/s; its one add per value is nothing. At these sizes launch
// latency and a few dependent loads per block set the time.
//
// Design. The grid is (ceil(S / T), R): a block owns T consecutive segments
// of one row, T and the block's threads constants of each kernel: 128
// segments and 256 threads for the batched form (64 rows of S 513 make 320
// blocks, one wave on 132 SMs), 32 and 1024 for the flat one (129 blocks for
// S 4097). Every sum has one writer and a fixed order of additions: no
// atomics, no state kept between launches, the same result from run to run.
//  * Bounds and sortedness. Every block reads its whole row once (8 KB for a
//    batched row, 128 KB of L2 for the flat W 32768): the pass tests that no
//    id exceeds the next one and, for a sorted row, stores the first index of
//    each of the block's T + 1 ids where the id steps up (at most T + 1
//    stores a step; no S-wide table, no binary search). A flat block has
//    1024 threads so that this pass, and the overflow bucket's long run in
//    the last block, keep four times the loads in flight (at 256 threads
//    the W 32768 call took twice as long).
//  * Sorted ids: thread (c, k) sums channel c of the run of segment s0 + k
//    when it has at most 32 points (every voxel) and writes it; consecutive
//    threads write consecutive s (coalesced), empty runs write zeros in the
//    same pass. Longer runs (the overflow bucket, which holds every masked
//    point of the row) are rare: a block counts them first and skips the
//    rest when there are none. Each of their (piece, channel) pairs gets a
//    warp: lanes stride over the piece with 32 loads in flight (coalesced)
//    and a butterfly shuffle adds the lanes; the piece sums are then added in
//    turn.
//  * The order of additions is the earlier warp-per-segment kernel's, bit for
//    bit: lane l adds positions l, l+32, l+64, ... of the run in ascending
//    order, starting from +0.0f, and the 32 lane sums are reduced by the xor
//    butterfly of 16, 8, 4, 2, 1, lane 0's value being the result. After the
//    step of offset o lane l (l < o) holds a[l] + a[l + o], so lane 0's value
//    is a fixed pairwise tree over the 32 lane sums. For a run of at most 32
//    points each lane sum is +0.0f + v[l] (+0.0f for l >= n), and one thread
//    evaluates the same tree alone: the absent positions add +0.0f exactly as
//    the lanes did, and float addition is commutative, so a[l] + a[l + o]
//    equals the shuffle's a[l + o] + a[l]. The earlier flat kernel summed
//    rows of 2048 points and then the row partials, so the flat form cuts a
//    run at multiples of kFlatPiece (2048) points, sums each piece so, and
//    adds the pieces in turn (the same as the earlier sum for a run over one
//    cut, which is every voxel). `segment_sum_run_order` in kernels/segsum.py
//    is this order in PyTorch.
//  * Ids in any other order: the general path, in every block of the row.
//    Thread j adds, in ascending w, every value whose id is s0 + j, reading
//    the row through shared memory in tiles of kTile points (W compares a
//    thread). Correct and deterministic, slow (milliseconds); no caller
//    takes it.
// Ids outside [0, S) match no segment and are dropped, as the one-hot of the
// TPU kernel drops them. Shared memory (bounds, the long-run list, one tile,
// the piece sums: under 12 KB at these shapes) stays below the 48 KB default:
// no opt-in. The TPU kernel's padding of S to 128 lanes is a TPU layout rule
// and is not kept.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kShort = 32;  // a run of at most this many points: one thread
constexpr int kBatch = 32;  // long runs: loads a lane keeps in flight
constexpr int kTile = 256;  // general path: points staged per step
constexpr int kMaxC = 8;
constexpr int kRowTile = 128;     // segments a block of the batched form owns
constexpr int kRowThreads = 256;  // ... and its threads
constexpr int kFlatTile = 32;     // the same for the flat form
constexpr int kFlatThreads = 1024;
constexpr int kFlatPiece = 2048;  // the flat form's cut: FLAT_PIECE in kernels/segsum.py

// bound[s - s0] = w for every id s in [lo, hi] that lies in the block's
// [s0, s0 + nseg]. At most nseg + 1 stores.
__device__ __forceinline__ void mark(int* bound, int s0, int nseg, long long lo, long long hi,
                                     int w) {
  const long long a = max(lo, static_cast<long long>(s0));
  const long long b = min(hi, static_cast<long long>(s0) + nseg);
  for (long long s = a; s <= b; ++s) bound[s - s0] = w;
}

// The step from id `prev` at w - 1 to id `cur` at w: a decrease is flagged;
// an increase starts the runs of every id in (prev, cur] at w.
__device__ __forceinline__ int step(int* bound, int s0, int nseg, int prev, int cur, int w) {
  if (prev < cur) mark(bound, s0, nseg, static_cast<long long>(prev) + 1, cur, w);
  return prev > cur;
}

// One pass over the row: this thread's share of the test "some id exceeds
// the next one", and, for a sorted row, the first index of each of the
// block's ids s0..s0 + nseg (each written exactly once).
__device__ __forceinline__ int scan_row(const int* __restrict__ row, int W, int* bound, int s0,
                                        int nseg) {
  int bad = 0;
  int tail = 1;
  if (threadIdx.x == 0) {
    mark(bound, s0, nseg, LLONG_MIN, __ldg(row), 0);                       // ids <= row[0]
    mark(bound, s0, nseg, static_cast<long long>(__ldg(row + W - 1)) + 1, LLONG_MAX, W);
  }
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const int4* row4 = reinterpret_cast<const int4*>(row);
    const int n4 = W >> 2;
#pragma unroll 4
    for (int q = threadIdx.x; q < n4; q += blockDim.x) {
      const int4 v = __ldg(row4 + q);
      const int w = 4 * q;
      if (q > 0) bad |= step(bound, s0, nseg, __ldg(row + w - 1), v.x, w);
      bad |= step(bound, s0, nseg, v.x, v.y, w + 1);
      bad |= step(bound, s0, nseg, v.y, v.z, w + 2);
      bad |= step(bound, s0, nseg, v.z, v.w, w + 3);
    }
    tail = max(4 * n4, 1);
  }
  for (int w = tail + threadIdx.x; w < W; w += blockDim.x)
    bad |= step(bound, s0, nseg, __ldg(row + w - 1), __ldg(row + w), w);
  return bad;
}

// The warp butterfly's sum of n <= 32 points, by one thread.
__device__ __forceinline__ float tree_sum(const float* __restrict__ v, int n) {
  float a[32];
#pragma unroll
  for (int l = 0; l < 32; ++l) a[l] = l < n ? __fadd_rn(0.0f, __ldg(v + l)) : 0.0f;
  // one loop per butterfly step, each with a constant trip count, so that
  // a[] stays in registers
#pragma unroll
  for (int l = 0; l < 16; ++l) a[l] = __fadd_rn(a[l], a[l + 16]);
#pragma unroll
  for (int l = 0; l < 8; ++l) a[l] = __fadd_rn(a[l], a[l + 8]);
#pragma unroll
  for (int l = 0; l < 4; ++l) a[l] = __fadd_rn(a[l], a[l + 4]);
  a[0] = __fadd_rn(a[0], a[2]);
  a[1] = __fadd_rn(a[1], a[3]);
  return __fadd_rn(a[0], a[1]);
}

// General path, for ids in any order: thread j < nseg adds, in ascending w,
// every value of the row whose id is s0 + j, and writes its C sums to
// out_r[c * S + s0 + j]. The row is staged through shared memory in tiles of
// kTile points (coalesced loads).
__device__ void general_sums(const int* __restrict__ row, const float* __restrict__ vals_r,
                             float* __restrict__ out_r, int C, int W, int S, int s0, int nseg,
                             int* tile_seg, float* tile_val) {
  const int j = threadIdx.x;
  float sum[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) sum[c] = 0.0f;
  for (int w0 = 0; w0 < W; w0 += kTile) {
    const int n = min(kTile, W - w0);
    __syncthreads();  // previous tile fully consumed
    for (int i = j; i < n; i += blockDim.x) tile_seg[i] = row[w0 + i];
    for (int c = 0; c < C; ++c)
      for (int i = j; i < n; i += blockDim.x) tile_val[c * kTile + i] = vals_r[c * W + w0 + i];
    __syncthreads();
    if (j < nseg) {
      for (int i = 0; i < n; ++i) {
        if (tile_seg[i] == s0 + j) {  // every lane reads the same id: a broadcast
#pragma unroll
          for (int c = 0; c < kMaxC; ++c)
            if (c < C) sum[c] = __fadd_rn(sum[c], tile_val[c * kTile + i]);
        }
      }
    }
  }
  if (j < nseg) {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) out_r[c * S + s0 + j] = sum[c];
  }
}

// Sorted path: the sums of the block's segments s0 .. s0 + nseg - 1, whose
// runs are [bound[k], bound[k + 1]), in the order of the note at the top.
// Called by every thread of the block.
template <int T>
__device__ void sorted_sums(const float* __restrict__ vals_r, float* __restrict__ out_r, int C,
                            int W, int S, int P, int nseg, const int* bound, int* long_k,
                            int* first, float* piece_sum) {
  const int j = threadIdx.x;
  // runs of at most kShort points: a thread per (segment, channel),
  // consecutive threads on consecutive segments
  for (int p = j; p < C * T; p += blockDim.x) {
    const int c = p / T, k = p - c * T;
    if (k >= nseg) continue;
    const int b = bound[k], n = bound[k + 1] - b;
    if (n > kShort) continue;
    const float* v = vals_r + c * W + b;
    const int m = min(n, (b / P + 1) * P - b);  // points before the next cut
    float sum = tree_sum(v, m);
    if (m < n) sum = __fadd_rn(sum, tree_sum(v + m, n - m));
    out_r[c * S + k] = sum;
  }
  // longer runs (most blocks have none): a warp per (piece, channel), the
  // pieces of a run then added in turn
  const int n_long = __syncthreads_count(j < nseg && bound[j + 1] - bound[j] > kShort);
  if (n_long == 0) return;
  if (j == 0) {
    int i = 0, t = 0;
    for (int k = 0; k < nseg; ++k) {
      const int b = bound[k], e = bound[k + 1];
      if (e - b <= kShort) continue;
      long_k[i] = k;
      first[i++] = t;
      t += (e - 1) / P - b / P + 1;
    }
    first[i] = t;
  }
  __syncthreads();
  const int warp = j >> 5, lane = j & 31;
  for (int u = warp; u < first[n_long] * C; u += blockDim.x >> 5) {
    const int t = u / C, c = u - t * C;
    int i = 0;
    while (first[i + 1] <= t) ++i;  // the run that piece t belongs to
    const int b = bound[long_k[i]], e = bound[long_k[i] + 1];
    const int pb = t == first[i] ? b : (b / P + t - first[i]) * P;
    const int pe = min(e, (pb / P + 1) * P);
    const float* v = vals_r + c * W;
    float sum = 0.0f;
    for (int w0 = pb + lane; w0 < pe; w0 += 32 * kBatch) {
      float x[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int w = w0 + 32 * q;
        x[q] = w < pe ? __ldg(v + w) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) sum = __fadd_rn(sum, x[q]);
    }
    for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    if (lane == 0) piece_sum[u] = sum;
  }
  __syncthreads();
  for (int q = j; q < n_long * C; q += blockDim.x) {
    const int i = q / C, c = q - i * C;
    float total = piece_sum[first[i] * C + c];
    for (int t = first[i] + 1; t < first[i + 1]; ++t)
      total = __fadd_rn(total, piece_sum[t * C + c]);
    out_r[c * S + long_k[i]] = total;
  }
}

// A block of T segments of row blockIdx.y, of kThreads threads: one pass
// over the row tests sortedness and finds the block's bounds; a sorted row
// takes the sorted path, any other the general path. Runs are cut at
// multiples of P points.
template <int T, int kThreads>
__device__ __forceinline__ void segsum_block(const int* __restrict__ seg,
                                             const float* __restrict__ vals,
                                             float* __restrict__ out, int C, int W, int S,
                                             int P) {
  static_assert(T <= kThreads, "a thread a segment on the general path");
  __shared__ int bound[T + 1];
  __shared__ int long_k[T];
  __shared__ int first[T + 1];
  __shared__ int tile_seg[kTile];
  extern __shared__ float smem[];
  float* tile_val = smem;                  // (C, kTile)
  float* piece_sum = tile_val + kTile * C;  // ((T + W / P + 1) * C,)

  const int r = blockIdx.y;
  const int s0 = blockIdx.x * T;
  const int nseg = min(T, S - s0);
  const int* row = seg + static_cast<long long>(r) * W;
  const float* vals_r = vals + static_cast<long long>(r) * C * W;
  float* out_r = out + static_cast<long long>(r) * C * S;

  if (__syncthreads_or(scan_row(row, W, bound, s0, nseg))) {
    general_sums(row, vals_r, out_r, C, W, S, s0, nseg, tile_seg, tile_val);
    return;
  }
  sorted_sums<T>(vals_r, out_r + s0, C, W, S, P, nseg, bound, long_k, first, piece_sum);
}

// Two kernels, so that a profile tells the two callers apart.
__global__ void __launch_bounds__(kRowThreads) segsum_rows_kernel(
    const int* __restrict__ seg, const float* __restrict__ vals, float* __restrict__ out,
    int C, int W, int S) {
  segsum_block<kRowTile, kRowThreads>(seg, vals, out, C, W, S, W);
}

__global__ void __launch_bounds__(kFlatThreads) segsum_flat_kernel(
    const int* __restrict__ seg, const float* __restrict__ vals, float* __restrict__ out,
    int C, int W, int S) {
  segsum_block<kFlatTile, kFlatThreads>(seg, vals, out, C, W, S, kFlatPiece);
}

template <int T, int kThreads>
cudaError_t launch(void (*kernel)(const int*, const float*, float*, int, int, int),
                   const void* seg, const void* vals, void* out, int R, int C, int W, int S,
                   int P, void* stream) {
  if (R <= 0 || R > 65535 || C <= 0 || C > kMaxC || W <= 0 || S <= 0)
    return cudaErrorInvalidValue;
  const dim3 grid((S + T - 1) / T, R);
  const size_t smem = sizeof(float) * (kTile + T + W / P + 1) * C;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg), static_cast<const float*>(vals),
      static_cast<float*>(out), C, W, S);
  return cudaGetLastError();
}

}  // namespace

// seg (R, W) int32, vals (R, C, W) float32 -> out (R, C, S).
extern "C" int lvo_segment_sum_batched(const void* seg, const void* vals, void* out, int R,
                                       int C, int W, int S, void* stream) {
  return launch<kRowTile, kRowThreads>(segsum_rows_kernel, seg, vals, out, R, C, W, S, W, stream);
}

// seg (W,) int32, vals (C, W) float32 -> out (C, S), in one launch; a run is
// summed in pieces cut at multiples of kFlatPiece points, the pieces added in
// order.
extern "C" int lvo_segment_sum_flat(const void* seg, const void* vals, void* out, int C,
                                    int W, int S, void* stream) {
  return launch<kFlatTile, kFlatThreads>(segsum_flat_kernel, seg, vals, out, 1, C, W, S,
                                         kFlatPiece, stream);
}
