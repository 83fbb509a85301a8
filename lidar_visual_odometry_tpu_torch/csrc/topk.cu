// Streaming k-nearest-neighbour search over a candidate cloud, four forms:
//  * windowed (K4): replaces the Pallas TPU kernel
//    lidar_visual_odometry_tpu/ops/pallas_nn.py block_topk_windowed
//    (_block_topk_windowed_kernel). Queries and candidates are sorted by a
//    coarse-cell raster key; a candidate chunk of c_tile points is read for a
//    query tile of q_tile points only when the chunk's key range
//    [clo, chi] meets the tile's [qlo - reach, qhi + reach]. Exact within one
//    cell, which is all the scan-to-map 1 m gates need. It has kernels of its
//    own (lvo_block_topk_windowed; see the K4 section below).
//  * dense (K5): replaces pallas_nn.py block_topk with packed=False
//    (_block_topk_loop_kernel): the same loop with no range test.
//  * dense with coordinates (K8): replaces pallas_nn.py block_topk_coords
//    (_block_topk_kernel): K5, then each slot's coordinates fetched by index
//    in place of the TPU kernel's one-hot reductions. Its rule for the
//    distance: a slot whose distance is above 1e29 reads exactly 1e30, and a
//    slot no candidate filled has zero coordinates.
//  * packed (K5p): replaces pallas_nn.py block_topk with packed=True
//    (_block_topk_packed_kernel): the running list holds one int32 key per
//    slot, (bits(d) & ~0x7FFF) | index, ordered as an integer, so the
//    distance is cut to its top 8 mantissa bits (2^-8 relative) and ties of
//    the cut distance go to the lower index. Slots report d = bits(key &
//    ~0x7FFF) and index = key & 0x7FFF; unfilled slots hold the key
//    (bits(1e30) & ~0x7FFF) | 0x7FFF. Needs C <= 32768 (the caller checks).
// K8 and K5p are off the product path (only the JAX package's tests and
// scripts/profile_mapping.py call them); they run at the mapping path's shapes.
// On the mapping path: Q 4096 queries against C 16384 (corner) and 32768
// (surf) map points, k 5, q_tile 256, c_tile 512, two windowed launches per
// re-association round.
//
// The result is what the TPU kernel computes: for each query the k smallest
// (distance, index) pairs in that order, distances ascending, ties to the
// lower index; slots that no candidate filled hold distance 1e30 and index 0.
// Distances are (dx*dx + dy*dy) + dz*dz with round-to-nearest intrinsics, so
// nvcc cannot contract them into fused multiply-adds and the plain PyTorch
// version gives the same bits. Candidates baked to BAKE_FAR (1e6) are
// ordinary far candidates.
//
// What bounds it on an H100: operations. Each considered (query, candidate)
// pair costs 3 subtractions, 3 products and 2 sums (8 float32 operations); the
// bytes (queries, candidates and keys once, results once) are well under a
// megabyte. At Q 4096 x C 32768 the dense form is 1.07 G operations, 16 us at
// 67 TFLOP/s; the windowed form does the pairs of the chunks it reads.
//
// Design of topk_kernel (K5, K8, K5p): one block per 32 queries (one query
// per lane) and kSplits warps.
// The block first finds the chunks it must read (for K4, the union over the
// query tiles its queries belong to, usually one; every chunk for K5) and
// lists them in index order in shared memory. It then stages kSplits listed
// chunks at a time through shared memory (coalesced loads, planar x/y/z);
// warp w walks the w-th staged chunk, so each warp sees its chunks in
// ascending index order and keeps a running top-k per lane in registers,
// inserting a candidate only when it is strictly nearer than the k-th (the
// lower index wins ties, as the TPU kernel's first-index argmin and its
// running-before-local merge do). For K4 a lane also skips a staged chunk that
// its own tile's range misses. At the end warp 0 merges the kSplits lists of
// each query by (distance, index), which gives the same k pairs in any split.
// 32 queries a block give Q / 32 = 128 blocks at the path's Q 4096. K8 is K5
// with another epilogue; K5p is K5 with one int32 key in place of each
// (distance, index) pair, inserted and merged by integer order. (K4 ran in
// topk_kernel until it got kernels of its own; its windowed branch is no
// longer launched and goes with K5's redesign, which keeps topk_kernel's
// code, and so K5, K8 and K5p, as they were until then.)

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <limits>

namespace {

constexpr int kQB = 32;       // queries per block, one per lane
constexpr int kSplits = 8;    // warps per block
constexpr int kThreads = kQB * kSplits;
constexpr int kMaxK = 8;
constexpr int kMaxTiles = kQB;  // query tiles one block can span (q_tile >= 1)
constexpr float kBig = 1e30f;
constexpr float kFar = 1e29f;
constexpr int kLowBits = 0x7FFF;  // K5p: the index bits of a packed key
// K5p: the packed 1e30 of an unfilled slot, (bits(1e30) & ~0x7FFF) | 0x7FFF
constexpr int kPackedSentinel = (0x7149F2CA & ~kLowBits) | kLowBits;

__device__ __forceinline__ bool lex_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Insert (d, id) into the ascending list; candidates arrive in ascending
// index order, so a strict < keeps the earlier (lower) index on ties.
template <int K>
__device__ __forceinline__ void insert_in_order(float d, int id, float (&bd)[K], int (&bi)[K]) {
  if (!(d < bd[K - 1])) return;
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    if (s > 0 && d < bd[s - 1]) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (d < bd[s]) {
      bd[s] = d;
      bi[s] = id;
    }
  }
}

// Insert a packed key into an ascending list of keys (distinct but for the
// sentinel, which no key equal to it replaces).
template <int K>
__device__ __forceinline__ void insert_key(int key, int (&bk)[K]) {
  if (!(key < bk[K - 1])) return;
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    if (s > 0 && key < bk[s - 1]) {
      bk[s] = bk[s - 1];
    } else if (key < bk[s]) {
      bk[s] = key;
    }
  }
}

// Insert (d, id) into a list ordered by (distance, index).
template <int K>
__device__ __forceinline__ void insert_lex(float d, int id, float (&bd)[K], int (&bi)[K]) {
  if (!lex_less(d, id, bd[K - 1], bi[K - 1])) return;
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    if (s > 0 && lex_less(d, id, bd[s - 1], bi[s - 1])) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (lex_less(d, id, bd[s], bi[s])) {
      bd[s] = d;
      bi[s] = id;
    }
  }
}

// Packed: bi holds the keys and bd is unused. out_i and out_c may be null.
template <int K, bool Packed>
__global__ void __launch_bounds__(kThreads) topk_kernel(
    const float* __restrict__ q, const int* __restrict__ q_keys,
    const float* __restrict__ c, const int* __restrict__ c_keys,
    float* __restrict__ out_d, int* __restrict__ out_i, float* __restrict__ out_c,
    int Q, int C, int q_tile, int c_tile, int reach, int windowed) {
  extern __shared__ float smem[];
  const int n_c = (C + c_tile - 1) / c_tile;
  float* cx = smem;                      // (kSplits, c_tile) staged candidates
  float* cy = cx + kSplits * c_tile;
  float* cz = cy + kSplits * c_tile;
  int* clo = reinterpret_cast<int*>(cz + kSplits * c_tile);  // (n_c,) chunk key ranges
  int* chi = clo + n_c;
  int* hits = chi + n_c;                 // (n_c,) chunks to read, ascending
  __shared__ int tlo[kMaxTiles], thi[kMaxTiles];
  __shared__ int n_hits;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kQB;
  const int qi = q0 + lane;
  const bool q_ok = qi < Q;
  const int t0 = q0 / q_tile;            // first query tile of the block
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (q_ok) {
    px = q[3 * qi];
    py = q[3 * qi + 1];
    pz = q[3 * qi + 2];
  }

  // ---- 1. the chunks this block reads, in ascending order ----
  int my_lo = 0, my_hi = 0;
  if (windowed) {
    const int q_last = min(q0 + kQB, Q) - 1;
    const int n_t = q_last / q_tile - t0 + 1;
    for (int t = threadIdx.x; t < n_t; t += blockDim.x) {
      tlo[t] = 0x7fffffff;
      thi[t] = -0x7fffffff - 1;
    }
    for (int ci = warp; ci < n_c; ci += kSplits) {  // a warp per chunk: min and max key
      int lo = 0x7fffffff, hi = -0x7fffffff - 1;
      const int end = min(C, (ci + 1) * c_tile);
      for (int j = ci * c_tile + lane; j < end; j += 32) {
        const int key = c_keys[j];
        lo = min(lo, key);
        hi = max(hi, key);
      }
      for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      if (lane == 0) {
        clo[ci] = lo;
        chi[ci] = hi;
      }
    }
    __syncthreads();
    for (int j = t0 * q_tile + threadIdx.x; j < (t0 + n_t) * q_tile; j += blockDim.x) {
      const int key = q_keys[j];  // Q is a multiple of q_tile: every tile is whole
      atomicMin(&tlo[j / q_tile - t0], key);
      atomicMax(&thi[j / q_tile - t0], key);
    }
    __syncthreads();
    const int mt = q_ok ? qi / q_tile - t0 : 0;
    my_lo = tlo[mt] - reach;
    my_hi = thi[mt] + reach;
    if (threadIdx.x == 0) {
      int n = 0;
      for (int ci = 0; ci < n_c; ++ci) {
        bool hit = false;
        for (int t = 0; t < n_t; ++t)
          hit |= clo[ci] <= thi[t] + reach && chi[ci] >= tlo[t] - reach;
        if (hit) hits[n++] = ci;
      }
      n_hits = n;
    }
  } else {
    for (int ci = threadIdx.x; ci < n_c; ci += blockDim.x) hits[ci] = ci;
    if (threadIdx.x == 0) n_hits = n_c;
  }
  __syncthreads();
  const int nh = n_hits;

  // ---- 2. stream the listed chunks, kSplits at a time ----
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kBig;
    bi[s] = Packed ? kPackedSentinel : 0;
  }
  for (int h0 = 0; h0 < nh; h0 += kSplits) {
    const int n_stage = min(kSplits, nh - h0);
    __syncthreads();  // the previous round's chunks are consumed
    for (int slot = 0; slot < n_stage; ++slot) {
      const int base = hits[h0 + slot] * c_tile;
      const int n = min(c_tile, C - base);
      const float* src = c + 3LL * base;
      for (int f = threadIdx.x; f < 3 * n; f += blockDim.x) {
        const float v = src[f];
        const int j = f / 3;
        const int comp = f - 3 * j;
        (comp == 0 ? cx : comp == 1 ? cy : cz)[slot * c_tile + j] = v;
      }
    }
    __syncthreads();
    if (warp < n_stage) {
      const int ci = hits[h0 + warp];
      const bool mine = !windowed || (clo[ci] <= my_hi && chi[ci] >= my_lo);
      if (q_ok && mine) {
        const int base = ci * c_tile;
        const int n = min(c_tile, C - base);
        const float* sx = cx + warp * c_tile;
        const float* sy = cy + warp * c_tile;
        const float* sz = cz + warp * c_tile;
        for (int j = 0; j < n; ++j) {
          const float dx = __fsub_rn(px, sx[j]);
          const float dy = __fsub_rn(py, sy[j]);
          const float dz = __fsub_rn(pz, sz[j]);
          const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                    __fmul_rn(dz, dz));
          if constexpr (Packed) {
            insert_key<K>((__float_as_int(d) & ~kLowBits) | (base + j), bi);
          } else {
            insert_in_order<K>(d, base + j, bd, bi);
          }
        }
      }
    }
  }

  // ---- 3. merge the warps' lists per query, by (distance, index) ----
  __syncthreads();
  float* md = smem;                                        // (kSplits, K, kQB)
  int* mi = reinterpret_cast<int*>(md + kSplits * K * kQB);  // (kSplits, K, kQB)
#pragma unroll
  for (int s = 0; s < K; ++s) {
    md[(warp * K + s) * kQB + lane] = bd[s];
    mi[(warp * K + s) * kQB + lane] = bi[s];
  }
  __syncthreads();
  if (warp == 0 && q_ok) {
    for (int w = 1; w < kSplits; ++w) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if constexpr (Packed) {
          insert_key<K>(mi[(w * K + s) * kQB + lane], bi);
        } else {
          insert_lex<K>(md[(w * K + s) * kQB + lane], mi[(w * K + s) * kQB + lane], bd, bi);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const long long o = static_cast<long long>(qi) * K + s;
      if constexpr (Packed) {
        out_d[o] = __int_as_float(bi[s] & ~kLowBits);
        out_i[o] = bi[s] & kLowBits;
      } else if (out_c != nullptr) {
        // K8: a filled slot (below the 1e30 start) takes its candidate's
        // coordinates; its distance reads 1e30 above 1e29, as on the TPU
        const bool filled = bd[s] < kBig;
        out_d[o] = bd[s] > kFar ? kBig : bd[s];
        for (int k = 0; k < 3; ++k) out_c[3 * o + k] = filled ? c[3LL * bi[s] + k] : 0.0f;
        if (out_i != nullptr) out_i[o] = bi[s];
      } else {
        out_d[o] = bd[s];
        out_i[o] = bi[s];
      }
    }
  }
}

template <int K, bool Packed>
cudaError_t launch(const void* q, const void* q_keys, const void* c, const void* c_keys,
                   void* out_d, void* out_i, void* out_c, int Q, int C, int q_tile,
                   int c_tile, int reach, int windowed, cudaStream_t stream) {
  const int n_c = (C + c_tile - 1) / c_tile;
  const size_t staged = sizeof(float) * 3 * kSplits * static_cast<size_t>(c_tile);
  const size_t merged = (sizeof(float) + sizeof(int)) * kSplits * K * kQB;
  const size_t smem = (staged > merged ? staged : merged) + sizeof(int) * 3 * n_c;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        topk_kernel<K, Packed>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (Q + kQB - 1) / kQB;
  topk_kernel<K, Packed><<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int*>(q_keys),
      static_cast<const float*>(c), static_cast<const int*>(c_keys),
      static_cast<float*>(out_d), static_cast<int*>(out_i), static_cast<float*>(out_c), Q, C,
      q_tile, c_tile, reach, windowed);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(const void* q, const void* q_keys, const void* c, const void* c_keys,
                     void* out_d, void* out_i, void* out_c, int Q, int C, int q_tile,
                     int c_tile, int reach, int windowed, int packed, cudaStream_t stream) {
  return packed ? launch<K, true>(q, q_keys, c, c_keys, out_d, out_i, out_c, Q, C, q_tile,
                                  c_tile, reach, windowed, stream)
                : launch<K, false>(q, q_keys, c, c_keys, out_d, out_i, out_c, Q, C, q_tile,
                                   c_tile, reach, windowed, stream);
}

// ---- K4: the windowed search, kernels of its own ----
//
// Replaces pallas_nn.py block_topk_windowed (_block_topk_windowed_kernel).
// What bounds it on an H100: the pairs of the chunks it reads (5.9% of the
// path's pairs, 11.3 M for the corner and surf calls of a round: about 2 us
// of float32 instructions at ~10 a pair), and latency: two launches a call,
// a few dependent trips to L2 before the first distance, and a warp's
// reductions at the end.
//
// Design, two launches:
//  1. topk_window_ranges_kernel, a warp a range: the min and max key of every
//     candidate chunk, then of every query tile, into a small (n_c + n_t)
//     int2 array. Any key order is right: the ranges come from reading every
//     key once, in this pass alone.
//  2. topk_windowed_kernel: a warp a query, each on its own (no shared memory,
//     no block barrier: a warp never waits for another). It tests the n_c
//     chunk ranges against its tile's window (lanes over chunks, ballots for
//     the ascending order) and reads the hit chunks' candidates through L1
//     (the 8 warps of a block are 8 neighbouring queries, usually of one
//     tile, so they read the same chunks), lane l taking quads l, l + 32, ... (four
//     candidates are three float4s) and keeping a sorted list of K in
//     registers. The query's home chunk (the hit chunk nearest its cell key)
//     is read first for each lane's nearest distance; the K-th smallest of
//     those 32 (distances of K distinct candidates) bounds the query's K-th
//     nearest from above, so a candidate is inserted only within the bound:
//     the warp branches to the insertion together (a vote) and rarely,
//     instead of running it predicated for every candidate. At the end K
//     rounds of warp reductions take the K smallest (distance, index) pairs
//     of the 32 lists.

constexpr int kWinWarps = 8;                    // queries a block, a warp each
constexpr int kWinThreads = 32 * kWinWarps;
constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr int kRangeWarps = 8;                  // pre-pass: warps a block

// ranges[w] = (min, max) key of chunk w < n_c, then of query tile w - n_c.
__global__ void __launch_bounds__(32 * kRangeWarps) topk_window_ranges_kernel(
    const int* __restrict__ q_keys, const int* __restrict__ c_keys, int2* __restrict__ ranges,
    int n_c, int n_t, int q_tile, int c_tile) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kRangeWarps + (threadIdx.x >> 5);
  if (w >= n_c + n_t) return;
  const bool chunk = w < n_c;
  const int* keys = chunk ? c_keys + static_cast<long long>(w) * c_tile
                          : q_keys + static_cast<long long>(w - n_c) * q_tile;
  const int n = chunk ? c_tile : q_tile;
  int lo = INT_MAX, hi = INT_MIN;
  for (int j = lane; j < n; j += 32) {
    const int key = keys[j];
    lo = min(lo, key);
    hi = max(hi, key);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) ranges[w] = make_int2(lo, hi);
}

// The lexicographic minimum of (d, i) over the warp, in every lane, by two
// warp reductions: d >= +0 (a distance, 1e30 or +inf), so its bits order as
// unsigned integers, and i >= 0.
__device__ __forceinline__ void warp_lex_min(float& d, int& i) {
  const unsigned bits = __float_as_uint(d);
  const unsigned least = __reduce_min_sync(0xffffffffu, bits);
  i = static_cast<int>(
      __reduce_min_sync(0xffffffffu, bits == least ? static_cast<unsigned>(i) : 0xffffffffu));
  d = __uint_as_float(least);
}

// The k-th smallest of the lanes' v >= +0 (k >= 1), in every lane.
__device__ __forceinline__ float warp_kth_smallest(float v, int k, int lane) {
  float kth = v;
  for (int s = 0; s < k; ++s) {
    const unsigned least = __reduce_min_sync(0xffffffffu, __float_as_uint(v));
    kth = __uint_as_float(least);
    const unsigned holders = __ballot_sync(0xffffffffu, __float_as_uint(v) == least);
    if (lane == __ffs(holders) - 1) v = kInf;  // the lowest holder drops it
  }
  return kth;
}

// The K smallest (distance, index) pairs below 1e30 of the warp's per-lane
// ascending lists (bd, bi), into out (slot s from lane s), 1e30 / 0 where
// there are fewer. Each round takes the warp's least list head and pops it.
template <int K>
__device__ __forceinline__ void warp_take_k(float (&bd)[K], int (&bi)[K], int lane,
                                            float* out_d, int* out_i) {
  float rd = kBig;
  int ri = 0;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    float d = bd[0];
    int i = bi[0];
    warp_lex_min(d, i);
    const bool taken = d < kBig;
    if (lane == s && taken) {
      rd = d;
      ri = i;
    }
    if (taken && bd[0] == d && bi[0] == i) {  // the owner pops its head
#pragma unroll
      for (int j = 0; j + 1 < K; ++j) {
        bd[j] = bd[j + 1];
        bi[j] = bi[j + 1];
      }
      bd[K - 1] = kBig;
      bi[K - 1] = 0;
    }
  }
  if (lane < K) {
    out_d[lane] = rd;
    out_i[lane] = ri;
  }
}

// (q - c)^2 summed as (dx^2 + dy^2) + dz^2, each operation rounded alone.
__device__ __forceinline__ float sqd_qc(float qx, float qy, float qz, float cx, float cy,
                                        float cz) {
  const float dx = __fsub_rn(qx, cx);
  const float dy = __fsub_rn(qy, cy);
  const float dz = __fsub_rn(qz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// vec: c_tile % 4 == 0 and c 16-byte aligned (a chunk is one run of 16-byte
// copies); else 4-byte copies.
// The four candidates of quad k of chunk h: three float4 loads when vec
// (c_tile % 4 == 0, c 16-byte aligned), else one float each, +inf past the
// chunk's end.
__device__ __forceinline__ void load_quad(const float* __restrict__ c, int h, int c_tile, int k,
                                          int vec, float (&cs)[12]) {
  const float* quad = c + 3LL * (static_cast<long long>(h) * c_tile + 4 * k);
  if (vec) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(quad));
    const float4 v = __ldg(reinterpret_cast<const float4*>(quad) + 1);
    const float4 w = __ldg(reinterpret_cast<const float4*>(quad) + 2);
    cs[0] = u.x; cs[1] = u.y; cs[2] = u.z; cs[3] = u.w; cs[4] = v.x; cs[5] = v.y;
    cs[6] = v.z; cs[7] = v.w; cs[8] = w.x; cs[9] = w.y; cs[10] = w.z; cs[11] = w.w;
  } else {
#pragma unroll
    for (int f = 0; f < 12; ++f) cs[f] = 4 * k + f / 3 < c_tile ? __ldg(quad + f) : kInf;
  }
}

template <int K>
__global__ void __launch_bounds__(kWinThreads) topk_windowed_kernel(
    const float* __restrict__ q, const int* __restrict__ q_keys, const float* __restrict__ c,
    const int2* __restrict__ ranges, float* __restrict__ out_d, int* __restrict__ out_i, int Q,
    int C, int q_tile, int c_tile, int reach, int vec) {
  const int lane = threadIdx.x & 31;
  const int qg = blockIdx.x * kWinWarps + (threadIdx.x >> 5);  // the warp's query
  if (qg >= Q) return;  // the whole warp: no warp waits for another
  const int n_c = C / c_tile;
  const int n_quads = (c_tile + 3) / 4;
  const float px = q[3 * qg], py = q[3 * qg + 1], pz = q[3 * qg + 2];
  const long long key = q_keys[qg];
  const int2 tr = ranges[n_c + qg / q_tile];
  const long long lo = static_cast<long long>(tr.x) - reach;
  const long long hi = static_cast<long long>(tr.y) + reach;

  // the query's home chunk: the hit chunk nearest its key (it holds the
  // query's own cell, or the cells beside it); none: -1
  unsigned gap = 0xffffffffu;  // key gaps of int32 keys fit 32 bits
  unsigned h_best = 0xffffffffu;
  for (int ci = lane; ci < n_c; ci += 32) {
    const int2 cr = ranges[ci];
    if (!(cr.x <= hi && cr.y >= lo)) continue;
    const long long g = key < cr.x ? cr.x - key : (key > cr.y ? key - cr.y : 0);
    if (g < gap) {
      gap = static_cast<unsigned>(g);
      h_best = ci;
    }
  }
  const unsigned least = __reduce_min_sync(0xffffffffu, gap);
  const int home =
      static_cast<int>(__reduce_min_sync(0xffffffffu, gap == least ? h_best : 0xffffffffu));

  // the bound: each lane's nearest in the home chunk, then the K-th smallest
  // of the 32 (distances of K distinct candidates), at or above the query's
  // K-th nearest
  float bound = kInf;
  if (home >= 0) {  // uniform in the warp
    float nearest = kInf;
    for (int k = lane; k < n_quads; k += 32) {
      float cs[12];
      load_quad(c, home, c_tile, k, vec, cs);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        nearest = fminf(nearest, sqd_qc(px, py, pz, cs[3 * e], cs[3 * e + 1], cs[3 * e + 2]));
    }
    bound = warp_kth_smallest(nearest, K, lane);
  }

  // every hit chunk in ascending order; a lane keeps the K nearest of its
  // candidates within the bound
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kBig;
    bi[s] = 0;
  }
  for (int base = 0; base < n_c; base += 32) {
    bool hit = false;
    if (base + lane < n_c) {
      const int2 cr = ranges[base + lane];
      hit = cr.x <= hi && cr.y >= lo;
    }
    for (unsigned m = __ballot_sync(0xffffffffu, hit); m != 0; m &= m - 1) {
      const int h = base + __ffs(m) - 1;
      for (int k0 = 0; k0 < n_quads; k0 += 32) {  // the same trips in every lane
        const int k = k0 + lane;
        float d[4] = {kInf, kInf, kInf, kInf};
        if (k < n_quads) {
          float cs[12];
          load_quad(c, h, c_tile, k, vec, cs);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            d[e] = sqd_qc(px, py, pz, cs[3 * e], cs[3 * e + 1], cs[3 * e + 2]);
        }
        // the insertion is a branch the warp takes together, and rarely
        // (only a few candidates of a query are within its bound), not code
        // that every candidate runs predicated
        const float d_min = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
        if (__any_sync(0xffffffffu, d_min <= bound && d_min < bd[K - 1])) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (d[e] <= bound) insert_in_order<K>(d[e], h * c_tile + 4 * k + e, bd, bi);
        }
      }
    }
  }

  // the K smallest of the warp's lists
  warp_take_k<K>(bd, bi, lane, out_d + static_cast<long long>(qg) * K,
                 out_i + static_cast<long long>(qg) * K);
}

template <int K>
cudaError_t launch_windowed(const void* q, const void* q_keys, const void* c,
                            const void* c_keys, void* ranges, void* out_d, void* out_i, int Q,
                            int C, int q_tile, int c_tile, int reach, cudaStream_t stream) {
  const int n_c = C / c_tile, n_t = Q / q_tile;
  const int n_ranges = n_c + n_t;
  topk_window_ranges_kernel<<<(n_ranges + kRangeWarps - 1) / kRangeWarps, 32 * kRangeWarps, 0,
                              stream>>>(static_cast<const int*>(q_keys),
                                        static_cast<const int*>(c_keys),
                                        static_cast<int2*>(ranges), n_c, n_t, q_tile, c_tile);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int vec = c_tile % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  topk_windowed_kernel<K><<<(Q + kWinWarps - 1) / kWinWarps, kWinThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const int*>(q_keys), static_cast<const float*>(c),
      static_cast<const int2*>(ranges), static_cast<float*>(out_d), static_cast<int*>(out_i), Q,
      C, q_tile, c_tile, reach, vec);
  return cudaGetLastError();
}

}  // namespace

// q (Q, 3), c (C, 3) float32; q_keys (Q,), c_keys (C,) int32 (windowed only,
// else may be null) -> out_d (Q, k) float32, out_i (Q, k) int32 and, for K8,
// out_c (Q, k, 3) float32 (else null; with it out_i may be null).
// windowed: Q % q_tile == 0 and C % c_tile == 0 (the caller checks); dense:
// any Q and C, q_tile unused. packed (K5p): dense, out_c null, C <= 32768.
extern "C" int lvo_block_topk(const void* q, const void* q_keys, const void* c,
                              const void* c_keys, void* out_d, void* out_i, void* out_c,
                              int Q, int C, int k, int q_tile, int c_tile, int reach,
                              int windowed, int packed, void* stream) {
  if (Q <= 0 || C <= 0 || q_tile <= 0 || c_tile <= 0 || k < 1 || k > kMaxK)
    return cudaErrorInvalidValue;
  if ((out_i == nullptr && out_c == nullptr) ||
      (packed && (windowed || out_c != nullptr || out_i == nullptr || C > kLowBits + 1)) ||
      (windowed && out_c != nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LVO_TOPK_CASE(K)                                                                  \
  case K:                                                                                \
    return launch_k<K>(q, q_keys, c, c_keys, out_d, out_i, out_c, Q, C, q_tile, c_tile, \
                       reach, windowed, packed, s);
  switch (k) {
    LVO_TOPK_CASE(1)
    LVO_TOPK_CASE(2)
    LVO_TOPK_CASE(3)
    LVO_TOPK_CASE(4)
    LVO_TOPK_CASE(5)
    LVO_TOPK_CASE(6)
    LVO_TOPK_CASE(7)
    default: return launch_k<8>(q, q_keys, c, c_keys, out_d, out_i, out_c, Q, C, q_tile,
                                c_tile, reach, windowed, packed, s);
  }
#undef LVO_TOPK_CASE
}

// K4. q (Q, 3) with q_keys (Q,), c (C, 3) sorted by key with c_keys (C,)
// -> out_d (Q, k) float32, out_i (Q, k) int32. ranges: (C / c_tile +
// Q / q_tile) int2 of scratch for the pre-pass. Q % q_tile == 0 and
// C % c_tile == 0 (the caller checks). Two launches on the stream.
extern "C" int lvo_block_topk_windowed(const void* q, const void* q_keys, const void* c,
                                       const void* c_keys, void* ranges, void* out_d,
                                       void* out_i, int Q, int C, int k, int q_tile,
                                       int c_tile, int reach, void* stream) {
  if (Q <= 0 || C <= 0 || q_tile <= 0 || c_tile <= 0 || k < 1 || k > kMaxK ||
      Q % q_tile != 0 || C % c_tile != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LVO_WINDOWED_CASE(K)                                                                \
  case K:                                                                                  \
    return launch_windowed<K>(q, q_keys, c, c_keys, ranges, out_d, out_i, Q, C, q_tile,    \
                              c_tile, reach, s);
  switch (k) {
    LVO_WINDOWED_CASE(1)
    LVO_WINDOWED_CASE(2)
    LVO_WINDOWED_CASE(3)
    LVO_WINDOWED_CASE(4)
    LVO_WINDOWED_CASE(5)
    LVO_WINDOWED_CASE(6)
    LVO_WINDOWED_CASE(7)
    default: return launch_windowed<8>(q, q_keys, c, c_keys, ranges, out_d, out_i, Q, C,
                                       q_tile, c_tile, reach, s);
  }
#undef LVO_WINDOWED_CASE
}
