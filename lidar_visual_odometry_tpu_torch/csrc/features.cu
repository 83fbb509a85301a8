// Greedy feature selection of the lidar front end (A-LOAM scanRegistration,
// src/scanRegistration.cpp:283-368): in each ring, sector by sector, up to K
// corner picks by descending curvature and then up to F flat picks by
// ascending curvature, each accepted pick clearing its neighbours'
// availability up to a > 0.05 m^2 gap (across sector boundaries).
//
// Replaces no TPU kernel. The JAX package runs the selection as a lax.scan of
// masked arg-max / arg-min steps (lidar_visual_odometry_tpu/ops/features.py:
// 142-189) inside one jitted program, which XLA compiles for the TPU. Run as
// eager PyTorch ops, the same S x (K + F) = 144 dependent steps a frame (the
// defaults) cost about 17 launches each, about 2,450 a frame, and their host
// dispatch paced the lidar front end. This kernel is the whole selection in
// one launch: kernels/features.py select_features, whose plain version is the
// eager loop and the definition of the result, bit for bit.
//
// What bounds it on an H100: latency. The inputs of a frame (64 x 2048
// curvatures, availability, two reaches, counts) are about 1.7 MB, read once:
// 0.5 us at 3.35 TB/s. The picks of a ring are a chain of 144 dependent
// arg-max steps over a sector of ~340 points each, so the time is the chain's
// length times one step's latency, whatever the rings' count.
//
// Design. One warp (one block of 32 threads) per ring, all rings in one
// launch; 64 rings fill 64 of the 132 SMs. The ring lives in shared memory:
// an order key per point (the curvature's bits mapped so that unsigned order
// is float order; 0 for a point that is not available), and the two reaches
// as int16. A step reads only the sector's keys: lane l takes points
// lo + l, lo + l + 32, ... in ascending order, keeps the first of its largest,
// and two warp reductions (__reduce_max_sync of the keys, __reduce_min_sync
// of the index among the lanes holding the largest) give the row's first
// extremum, as torch.argmax / argmin return it. An accepted pick zeroes the
// keys of its neighbourhood; nothing else changes between steps. After a
// rejected pick the remaining steps of its kind would repeat it (nothing was
// cleared), so they are written without a search. Picks, their gates and the
// corner labels go to device memory as they are decided; no host read, no
// allocation, no synchronisation.
//
// Equal to the plain version for every input:
//  * Scores. The plain score is curv where available and in the sector, else
//    -1e30 (corners) / +1e30 (flats), arg-maxed over the whole row. The
//    sector never holds index 0 (it starts at 5 or is empty), so a sector
//    whose best score does not beat the fill ties with, or loses to, index 0:
//    the pick is 0 and its score the fill. A not-available point keys 0,
//    below every real key, so it never beats the fill either.
//  * Order keys: -0 keys as +0 (they compare equal); every NaN keys
//    0xFFFFFFFF, above +inf, for arg-max and arg-min alike (PyTorch's
//    GreaterOrNan / LessOrNan: a NaN wins, the first NaN of a row). A NaN
//    pick fails its gate (NaN compares false) and so clears nothing.
//  * Gates compare in float32 (edge_gate and surf_gate are rounded to float
//    by the caller, as PyTorch casts a Python scalar to the tensor's dtype).
//  * Sector bounds: for counts whose bounds do not overflow int32 (any count
//    below 2^31 / S; a compacted ring's is at most W). Every sector starts
//    at 5 or lies empty.
//  * Suppression clears [p - reach_l[p], p + reach_r[p]] and p, clipped to
//    the row. Reaches are held saturated to [-W, W], which clips the same.
//
// Shared memory: 8 W bytes (the keys and the reaches) plus W for the corner
// labels, 9 W in all: 18 KB at W 2048. kMaxW 16384 (144 KB) needs the opt-in
// above 48 KB, set once.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kNanKey = 0xFFFFFFFFu;
constexpr int kMaxW = 16384;  // kernels/features.py MAX_W
constexpr int kSmemPerPoint = 9;

__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t b = __float_as_uint(v);
  if (isnan(v)) return kNanKey;
  if ((b << 1) == 0) b = 0;  // -0 -> +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  if (k == kNanKey) return __uint_as_float(0x7FC00000u);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// ascending order of the value, NaN highest; 0 (not available) stays 0
__device__ __forceinline__ uint32_t flat_key(uint32_t k) {
  return (k == 0u || k == kNanKey) ? k : ~k;
}

__device__ __forceinline__ int16_t saturate(int v, int W) {
  return (int16_t)(v < -W ? -W : (v > W ? W : v));
}

// The first index of the largest step key over [lo, hi] of the warp, and
// that key (0 when the range is empty or nothing in it is available).
template <bool kFlat>
__device__ __forceinline__ void warp_best(const uint32_t* key, int lo, int hi, int lane,
                                          uint32_t& best, int& best_i) {
  uint32_t b = 0;
  int bi = INT_MAX;
  int i = lo + lane;
  for (; i + 96 <= hi; i += 128) {
    uint32_t k0 = key[i], k1 = key[i + 32], k2 = key[i + 64], k3 = key[i + 96];
    if (kFlat) { k0 = flat_key(k0); k1 = flat_key(k1); k2 = flat_key(k2); k3 = flat_key(k3); }
    if (k0 > b) { b = k0; bi = i; }
    if (k1 > b) { b = k1; bi = i + 32; }
    if (k2 > b) { b = k2; bi = i + 64; }
    if (k3 > b) { b = k3; bi = i + 96; }
  }
  for (; i <= hi; i += 32) {
    uint32_t k = kFlat ? flat_key(key[i]) : key[i];
    if (k > b) { b = k; bi = i; }
  }
  best = __reduce_max_sync(kFull, b);
  best_i = (int)__reduce_min_sync(kFull, b == best ? (unsigned)bi : UINT_MAX);
}

// One kind of pick (corners or flats) in one sector: n steps, results at
// picks[0..n), ok[0..n).
template <bool kFlat>
__device__ void select_run(uint32_t* key, const int16_t* reach_l, const int16_t* reach_r,
                           uint8_t* label, int W, int lo, int hi, int n, float gate, int lane,
                           int64_t* picks, bool* ok) {
  const float fill = kFlat ? 1e30f : -1e30f;
  const uint32_t fill_key = kFlat ? flat_key(order_key(fill)) : order_key(fill);
  for (int step = 0; step < n; ++step) {
    uint32_t best;
    int best_i;
    warp_best<kFlat>(key, lo, hi, lane, best, best_i);
    const bool inside = best > fill_key;
    const int p = inside ? best_i : 0;
    const float score = inside ? key_value(key[p]) : fill;
    const bool accept = kFlat ? (score < gate) : (score > gate);
    if (!accept) {
      // nothing is cleared: every remaining step finds the same pick
      for (int s = step + lane; s < n; s += 32) {
        picks[s] = p;
        ok[s] = false;
      }
      return;
    }
    if (lane == 0) {
      picks[step] = p;
      ok[step] = true;
      if (!kFlat) label[p] = 1;
    }
    const int first = max(p - (int)reach_l[p], 0);
    const int last = min(p + (int)reach_r[p], W - 1);
    __syncwarp();
    for (int i = first + lane; i <= last; i += 32) key[i] = 0u;
    if (lane == 0) key[p] = 0u;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(32) select_features_kernel(
    const float* __restrict__ curv, const bool* __restrict__ avail,
    const int* __restrict__ reach_l, const int* __restrict__ reach_r,
    const int* __restrict__ count, int W, int S, int K, int F, float edge_gate,
    float surf_gate, int64_t* __restrict__ corner_picks, bool* __restrict__ corner_ok,
    int64_t* __restrict__ flat_picks, bool* __restrict__ flat_ok,
    int8_t* __restrict__ corner_label) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* key = reinterpret_cast<uint32_t*>(smem);
  int16_t* rl = reinterpret_cast<int16_t*>(key + W);
  int16_t* rr = rl + W;
  uint8_t* label = reinterpret_cast<uint8_t*>(rr + W);
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t row = (size_t)r * W;
  for (int i = lane; i < W; i += 32) {
    key[i] = avail[row + i] ? order_key(curv[row + i]) : 0u;
    rl[i] = saturate(reach_l[row + i], W);
    rr[i] = saturate(reach_r[row + i], W);
    label[i] = 0;
  }
  __syncwarp();
  // sector j spans [5 + floor(span * j / S), 5 + floor(span * (j + 1) / S) - 1]
  const long long span = max((long long)count[r] - 11, 0LL);
  for (int j = 0; j < S; ++j) {
    const int lo = (int)min(5 + span * j / S, (long long)W);
    const int hi = (int)min(5 + span * (j + 1) / S - 1, (long long)W - 1);
    const size_t cj = ((size_t)r * S + j) * K;
    const size_t fj = ((size_t)r * S + j) * F;
    select_run<false>(key, rl, rr, label, W, lo, hi, K, edge_gate, lane, corner_picks + cj,
                      corner_ok + cj);
    __syncwarp();
    select_run<true>(key, rl, rr, label, W, lo, hi, F, surf_gate, lane, flat_picks + fj,
                     flat_ok + fj);
    __syncwarp();
  }
  for (int i = lane; i < W; i += 32) corner_label[row + i] = (int8_t)label[i];
}

}  // namespace

extern "C" int lvo_select_features(const void* curv, const void* avail, const void* reach_l,
                                   const void* reach_r, const void* count, int R, int W, int S,
                                   int K, int F, float edge_gate, float surf_gate,
                                   void* corner_picks, void* corner_ok, void* flat_picks,
                                   void* flat_ok, void* corner_label, void* stream) {
  if (R < 0 || W < 1 || W > kMaxW || S < 1 || K < 1 || F < 1) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const size_t smem = (size_t)kSmemPerPoint * W;
  static bool opted_in = false;
  if (smem > 48 * 1024 && !opted_in) {
    cudaError_t e = cudaFuncSetAttribute(select_features_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemPerPoint * kMaxW);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  select_features_kernel<<<R, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(curv), static_cast<const bool*>(avail),
      static_cast<const int*>(reach_l), static_cast<const int*>(reach_r),
      static_cast<const int*>(count), W, S, K, F, edge_gate, surf_gate,
      static_cast<int64_t*>(corner_picks), static_cast<bool*>(corner_ok),
      static_cast<int64_t*>(flat_picks), static_cast<bool*>(flat_ok),
      static_cast<int8_t*>(corner_label));
  return cudaGetLastError();
}
