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
//    (_block_topk_loop_kernel): every candidate, no range test.
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
// re-association round; K5 only with MappingConfig(windowed_nn=False).
//
// The result is what the TPU kernel computes: for each query the k smallest
// (distance, index) pairs in that order, distances ascending, ties to the
// lower index; slots that no candidate filled hold distance 1e30 and index 0.
// Distances are (dx*dx + dy*dy) + dz*dz with round-to-nearest intrinsics, so
// nvcc cannot contract them into fused multiply-adds and the plain PyTorch
// version gives the same bits. Candidates baked to BAKE_FAR (1e6) are
// ordinary far candidates.
//
// ---- K5, K8, K5p: topk_kernel<K, Form>, one launch a call ----
//
// What bounds it on an H100: operations. Each (query, candidate) pair costs 3
// subtractions, 3 products and 2 sums, each rounded alone; the bytes
// (queries and candidates once, results once) are well under a megabyte. At
// Q 4096 x C 32768 that is 1.07 G float32 operations, 16 us at the 67 TFLOP/s
// of the table's bound. That rate counts a fused multiply-add as two
// operations, and none may be fused here, so the floor is the instruction
// rate: 8 operations and a compare a pair on 132 SMs x 128 lanes at ~1.98
// GHz is about 0.036 ms at C 32768 and 0.018 ms at C 16384, 2.3 times the
// bound. The tensor cores cannot help: |q|^2 + |c|^2 - 2 q.c rounds otherwise
// and reorders near ties.
//
// Design (replacing one block per 32 queries, a query a lane, 8 warps over
// 8 chunks and a merge by warp 0: 128 blocks at Q 4096 for 132 SMs, two
// warps a scheduler, a latency chain and a divergent insertion a candidate):
//  * The card is filled by splitting each group of kBlockQueries queries'
//    candidates into S pieces of whole chunks (block r of the cluster takes
//    chunks r, r + S, ...), one block each, launched as a thread-block
//    cluster of S blocks (S from 1 to 8, chosen at launch so that the grid
//    fits the blocks the card holds at once: S 2 at Q 4096). At the end
//    every block pushes its lists into the cluster leader's shared memory
//    (distributed shared memory: mapa + st.shared::cluster between two
//    cluster barriers), and the leader merges them by (distance, index), or
//    by key for K5p: the same k pairs whatever the split.
//  * A warp holds kWarpQueries queries, every lane all of them; its lanes
//    split the candidates (lane l reads quads l, l + 32, ... of a chunk:
//    three 16-byte shared loads a quad, conflict-free), so one read of a
//    candidate serves kWarpQueries distances.
//  * Staging is asynchronous: a block's piece lies in shared memory in
//    windows of kWindow chunks (12 KB each, as the candidates lie in
//    memory); one thread issues a window's 1-D bulk copies (TMA) at once,
//    each completing on its own mbarrier, and the warps start on a chunk as
//    soon as it lands. At Q 4096 a piece is one window at C 16384 and two,
//    one after the other, at C 32768.
//  * Two passes over the resident window, so that insertions do not depend
//    on the candidates' order (a streaming top-k inserts about k ln(n/k)
//    times a query on random order, and far more on a cloud stored in
//    spatial order, each insertion stalling its warp). Pass 1 keeps, per
//    lane and query, the nearest distance and its quad: 4 distances, a
//    minimum and a compare a quad, no insertion and no warp collective. The
//    K-th smallest of the warp's 32 (distance, quad) pairs bounds the
//    query's K-th nearest, and only the K lanes at or below it can hold a
//    candidate at or below it. Pass 2 hands those (query, lane) pairs to the
//    warp's lanes, which recompute that lane's quads for that query alone
//    and mark a quad whose nearest is at or below the bound (one compare a
//    quad); every lane then recomputes the few marked quads alike and offers
//    their candidates at or below the bound (a few a query) to the query's
//    list, which each lane holds in registers. The list compares
//    (distance, index) (K5p: the key), so ties keep the lower index whatever
//    the order of the offers.
//  * Rounding as before: __fsub_rn, __fmul_rn and __fadd_rn in the same order.
// K8 and K5p are K5 with another epilogue or key, separate instances
// (topk_kernel<K, kCoords>, <K, kPacked>), so a trace tells them apart.
// What holds it back (PERF.md): pass 1 issues about 10 instructions a pair
// (the floor above), and pass 2, a quarter of pass 1's distances, costs
// well above that share (a quad's three loads serve one query).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <limits>

namespace {

constexpr int kMaxK = 8;
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


// ---- K5, K8, K5p: the dense search (design in the note at the top) ----

constexpr int kDenseWarps = 8;       // warps a block, each with kWarpQueries queries
constexpr int kWarpQueries = 4;      // queries a warp; every lane holds all of them
constexpr int kDenseThreads = 32 * kDenseWarps;
constexpr int kBlockQueries = kDenseWarps * kWarpQueries;
constexpr int kChunk = 1024;         // candidates a chunk (12 KB), a multiple of 128
constexpr int kWindow = 8;           // chunks resident at once (96 KB)
constexpr int kMaxCluster = 8;       // blocks that split a query group's candidates
constexpr unsigned kFull = 0xffffffffu;

enum Form { kIndex = 0, kCoords = 1, kPacked = 2 };  // K5, K8, K5p

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// arrive, and expect `bytes` of bulk-copy data in this phase
__device__ __forceinline__ void bar_arrive_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait for the phase of parity `parity` to complete (each try suspends the
// thread for at most ~1 us); a phase that never completes (a fault) ends the
// kernel with an error within seconds instead of a hang
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p, [%1], %2, 1000;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 22)) __trap();
  }
}

// one 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global memory into this block's shared memory,
// counted on mbarrier `bar`
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// store v at shared address `addr` of the cluster's block `rank`
__device__ __forceinline__ void store_in_block(unsigned addr, int rank, unsigned v) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.b32 [%0], %1;" ::"r"(r), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// The k-th smallest of the lanes' v in unsigned order (k <= 32), in every lane.
template <int K>
__device__ __forceinline__ unsigned warp_kth_unsigned(unsigned v, int lane) {
  unsigned kth = v;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    kth = __reduce_min_sync(kFull, v);
    const unsigned holders = __ballot_sync(kFull, v == kth);
    if (lane == __ffs(holders) - 1) v = 0xffffffffu;  // the lowest holder drops it
  }
  return kth;
}

// Insert (d, i) into an ascending list ordered by (distance, index): a
// bubble pass that keeps the smaller pair in each slot and carries the larger
// on (the last slot's pair drops out).
template <int K>
__device__ __forceinline__ void insert_lex(float d, int i, float (&ld)[K], int (&li)[K]) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool lt = lex_less(d, i, ld[s], li[s]);
    const float td = lt ? ld[s] : d;
    const int ti = lt ? li[s] : i;
    ld[s] = lt ? d : ld[s];
    li[s] = lt ? i : li[s];
    d = td;
    i = ti;
  }
}

// K5p: the same for a list of packed keys, by integer minimum and maximum.
template <int K>
__device__ __forceinline__ void insert_key(int key, int (&lk)[K]) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int lo = min(lk[s], key);
    key = max(lk[s], key);
    lk[s] = lo;
  }
}

// a[j], j the same or not in every lane, by selects (a register array
// indexed at run time would go to local memory)
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&a)[N], int j) {
  T v = a[0];
#pragma unroll
  for (int t = 1; t < N; ++t) v = j == t ? a[t] : v;
  return v;
}

// A warp's queries, their bounds and their lists (module note). Pass 1
// keeps each lane's nearest (distance, first index of its quad) per query
// (K5p: its least key); bound() makes the K-th smallest of the warp's 32 the
// query's bound (bd, bi) (K5p: bk); pass 2 offers each candidate at or below
// it, and below the list's K-th, to the query's list. Every lane holds the
// same copy of each list, ascending (K5, K8: distances ld, indices li; K5p:
// keys in li).
template <int K, int F>
struct WarpLists {
  float px[kWarpQueries], py[kWarpQueries], pz[kWarpQueries];
  float m[kWarpQueries];    // pass 1: the lane's nearest
  int mq[kWarpQueries];     //         and the first index of its quad; K5p: the least key
  float bd[kWarpQueries];   // the bound: K5, K8 (bd, bi); K5p bk
  int bi[kWarpQueries];
  int bk[kWarpQueries];
  int n_pairs;              // the (query, hit lane) pairs of pass 2
  int pj[kWarpQueries];     // the lane's pair of round r: query pj[r], hit lane pl[r]
  int pl[kWarpQueries];     // (pl[r] < 0: none)
  float ld[kWarpQueries][K];
  int li[kWarpQueries][K];

  __device__ __forceinline__ void init(const float* __restrict__ q, int q0, int Q) {
#pragma unroll
    for (int j = 0; j < kWarpQueries; ++j) {
      const int qi = min(q0 + j, Q - 1);  // a query past Q repeats the last; never written
      px[j] = q[3 * qi];
      py[j] = q[3 * qi + 1];
      pz[j] = q[3 * qi + 2];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        ld[j][s] = kBig;
        li[j][s] = F == kPacked ? kPackedSentinel : 0;
      }
    }
  }

  // Pass 1, one quad a lane (candidates qfirst ... qfirst + 3 of the chunk
  // sc, which holds candidates base ... base + n - 1; Tail: past n masked).
  // A lane's quads come in ascending order, so the strict < keeps the lowest
  // quad of a tie.
  template <bool Tail>
  __device__ __forceinline__ void scan(const float* __restrict__ sc, int m0, int n, int base,
                                       int lane) {
    const float4* p = reinterpret_cast<const float4*>(sc) + 3 * (m0 + lane);
    const float4 u = p[0], v = p[1], w = p[2];
    const float cx[4] = {u.x, u.w, v.z, w.y};
    const float cy[4] = {u.y, v.x, v.w, w.z};
    const float cz[4] = {u.z, v.y, w.x, w.w};
    const int qfirst = base + 4 * (m0 + lane);
#pragma unroll
    for (int j = 0; j < kWarpQueries; ++j) {
      float d[4];
      int key[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[e] = sqd_qc(px[j], py[j], pz[j], cx[e], cy[e], cz[e]);
        key[e] = (__float_as_int(d[e]) & ~kLowBits) | (qfirst + e);
        if (Tail && 4 * (m0 + lane) + e >= n) {
          d[e] = kInf;
          key[e] = INT_MAX;
        }
      }
      if constexpr (F == kPacked) {
        mq[j] = min(mq[j], min(min(key[0], key[1]), min(key[2], key[3])));
      } else {
        const float dmin = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
        mq[j] = dmin < m[j] ? qfirst : mq[j];
        m[j] = fminf(m[j], dmin);
      }
    }
  }

  __device__ __forceinline__ void start_pass1() {
#pragma unroll
    for (int j = 0; j < kWarpQueries; ++j) {
      m[j] = kInf;
      mq[j] = INT_MAX;
    }
  }

  // After pass 1: the K-th smallest of the lanes' (nearest, quad) pairs, by
  // K rounds of two warp minima (a distance's bits order as unsigned: it is
  // +0 or more, or NaN). K distinct candidates lie at or below (its
  // distance, its quad's last index), so the query's K nearest do too, and
  // only the lanes whose pair is at or below the K-th (the hit lanes) can
  // hold one. K5p: the K-th smallest of the lanes' least keys, K distinct
  // keys. Then pass 2's pairs (query j, hit lane l), in query order, 32 a
  // round: this lane's of each round.
  __device__ __forceinline__ void bound(int lane) {
    unsigned hit[kWarpQueries];
#pragma unroll
    for (int j = 0; j < kWarpQueries; ++j) {
      if constexpr (F == kPacked) {
        bk[j] = static_cast<int>(
            warp_kth_unsigned<K>(static_cast<unsigned>(mq[j]) ^ 0x80000000u, lane) ^ 0x80000000u);
        hit[j] = __ballot_sync(kFull, mq[j] <= bk[j]);
      } else {
        unsigned v = __float_as_uint(m[j]);
        int qi = mq[j];
        unsigned least = 0;
        int qmin = 0;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          least = __reduce_min_sync(kFull, v);
          qmin = static_cast<int>(
              __reduce_min_sync(kFull, v == least ? static_cast<unsigned>(qi) : 0xffffffffu));
          if (v == least && qi == qmin) v = 0xffffffffu;  // the holder drops it
        }
        // fewer than K lanes with a candidate: no bound (+inf)
        bd[j] = least == 0xffffffffu ? kInf : __uint_as_float(least);
        bi[j] = qmin > INT_MAX - 3 ? INT_MAX : qmin + 3;
        hit[j] = __ballot_sync(kFull, !lex_less(bd[j], qmin, m[j], mq[j]));
      }
    }
    n_pairs = 0;
#pragma unroll
    for (int r = 0; r < kWarpQueries; ++r) {
      pj[r] = 0;
      pl[r] = -1;
    }
#pragma unroll
    for (int j = 0; j < kWarpQueries; ++j) {
      const int c = __popc(hit[j]);
#pragma unroll
      for (int r = 0; r < kWarpQueries; ++r) {
        const int off = 32 * r + lane - n_pairs;  // this lane's place in query j's hit lanes
        if (off >= 0 && off < c) {
          unsigned mm = hit[j];
          for (int k = 0; k < off; ++k) mm &= mm - 1;
          pj[r] = j;
          pl[r] = __ffs(mm) - 1;
        }
      }
      n_pairs += c;
    }
  }

  // (d, i), or the key i, to list j, the same in every lane
  __device__ __forceinline__ void offer(int j, float d, int i) {
#pragma unroll
    for (int t = 0; t < kWarpQueries; ++t) {
      if (t != j) continue;
      if constexpr (F == kPacked) {
        if (i < li[t][K - 1]) insert_key<K>(i, li[t]);
      } else if (lex_less(d, i, ld[t][K - 1], li[t][K - 1])) {
        insert_lex<K>(d, i, ld[t], li[t]);
      }
    }
  }

  // Query j's distance (K5p: key) to candidate e of quad m of the chunk sc
  // (candidate base + 4 m + e), +inf (INT_MAX) past n
  template <bool Tail>
  __device__ __forceinline__ void value(const float* __restrict__ sc, int m, int e, int n,
                                        int base, float qx, float qy, float qz, float& d,
                                        int& key) const {
    const float* c3 = sc + 3 * (4 * m + e);
    d = sqd_qc(qx, qy, qz, c3[0], c3[1], c3[2]);
    key = (__float_as_int(d) & ~kLowBits) | (base + 4 * m + e);
    if (Tail && 4 * m + e >= n) {
      d = kInf;
      key = INT_MAX;
    }
  }

  // Pass 2 over a chunk: lane L takes pair 32 r + L (query j, hit lane l)
  // and marks each of lane l's 8 quads of the chunk whose nearest to query j
  // is at or below the bound (one compare a quad); a marked quad's 4
  // candidates are then recomputed by every lane (the same values in each)
  // and those at or below the bound offered, rarely.
  template <bool Tail>
  __device__ __forceinline__ void rescan(const float* __restrict__ sc, int n, int base, int lane) {
    constexpr int kQuads = kChunk / 128;  // a lane's quads in a chunk
#pragma unroll
    for (int r = 0; r < kWarpQueries; ++r) {  // at most 32 lanes a query
      if (32 * r >= n_pairs) break;
      const int j = pj[r], l = pl[r];
      const float qx = pick(px, j), qy = pick(py, j), qz = pick(pz, j);
      const float b_d = pick(bd, j);
      const int b_i = pick(bi, j), b_k = pick(bk, j);
      unsigned mark = 0;  // bit it: quad l + 32 it
      if (l >= 0) {
#pragma unroll
        for (int it = 0; it < kQuads; ++it) {
          const int m = l + 32 * it;
          const float4* p = reinterpret_cast<const float4*>(sc) + 3 * m;
          const float4 u = p[0], v = p[1], w = p[2];
          const float cx[4] = {u.x, u.w, v.z, w.y};
          const float cy[4] = {u.y, v.x, v.w, w.z};
          const float cz[4] = {u.z, v.y, w.x, w.w};
          float d[4];
          int key[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            d[e] = sqd_qc(qx, qy, qz, cx[e], cy[e], cz[e]);
            key[e] = (__float_as_int(d[e]) & ~kLowBits) | (base + 4 * m + e);
            if (Tail && 4 * m + e >= n) {
              d[e] = kInf;
              key[e] = INT_MAX;
            }
          }
          // a quad whose nearest ties the bound can hold a candidate at or
          // below it only if its first index is (a window of equal
          // distances, masked points baked to one place, then marks none)
          const float dmin = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
          const bool in = F == kPacked
                              ? min(min(key[0], key[1]), min(key[2], key[3])) <= b_k
                              : dmin < b_d || (dmin == b_d && base + 4 * m <= b_i);
          mark |= static_cast<unsigned>(in) << it;
        }
      }
      for (unsigned lanes = __ballot_sync(kFull, mark != 0); lanes != 0; lanes &= lanes - 1) {
        const int s = __ffs(lanes) - 1;
        const int js = __shfl_sync(kFull, j, s);
        const int ls = __shfl_sync(kFull, l, s);
        for (unsigned bits = __shfl_sync(kFull, mark, s); bits != 0; bits &= bits - 1) {
          const int ms = ls + 32 * (__ffs(bits) - 1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float d;
            int key;
            value<Tail>(sc, ms, e, n, base, pick(px, js), pick(py, js), pick(pz, js), d, key);
            const int idx = base + 4 * ms + e;
            if (F == kPacked ? key <= pick(bk, js) : !lex_less(pick(bd, js), pick(bi, js), d, idx))
              offer(js, d, F == kPacked ? key : idx);
          }
        }
      }
    }
  }
};

// dynamic shared memory: a window of kWindow chunks; after both passes,
// the leader's holds the lists of the cluster's other blocks
constexpr size_t kDenseSmem = sizeof(float) * 3 * kWindow * kChunk;
static_assert(sizeof(float) * 2 * (kMaxCluster - 1) * kBlockQueries * kMaxK <= kDenseSmem,
              "the merge area must fit the window");

// Grid: (query groups x S) blocks in clusters of S; cluster g searches
// queries g * kBlockQueries ... for the candidates, block r of it its piece.
template <int K, int F>
__global__ void __launch_bounds__(kDenseThreads) topk_kernel(
    const float* __restrict__ q, const float* __restrict__ c, float* __restrict__ out_d,
    int* __restrict__ out_i, float* __restrict__ out_c, int Q, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* window = reinterpret_cast<float*>(smem);  // (kWindow, kChunk, 3)
  __shared__ __align__(8) unsigned long long full[kWindow];  // a window chunk has landed

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int S = static_cast<int>(cluster_size());
  const int rank = static_cast<int>(cluster_rank());
  const int q0 = (blockIdx.x / S) * kBlockQueries + warp * kWarpQueries;
  // block r's piece: chunks r, r + S, r + 2S, ..., in windows of kWindow
  const int n_local = ((C + kChunk - 1) / kChunk - rank + S - 1) / S;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWindow; ++s) bar_init(smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  WarpLists<K, F> w;
  w.init(q, q0, Q);
  for (int w0 = 0; w0 < n_local; w0 += kWindow) {
    const int n_win = min(kWindow, n_local - w0);
    const unsigned parity = (w0 / kWindow) & 1;
    // the window's chunks, all at once: the 16-byte multiple by a bulk copy,
    // the last 1-3 floats of a short last chunk by this thread
    if (threadIdx.x == 0) {
      // the generic-proxy reads of the window before (ordered by the block
      // barrier below) come before these bulk copies into it
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int t = 0; t < n_win; ++t) {
        const long long first = static_cast<long long>(rank + (w0 + t) * S) * kChunk;
        const unsigned bytes =
            12u * static_cast<unsigned>(min(static_cast<long long>(kChunk), C - first));
        const unsigned bulk = bytes & ~15u;
        float* dst = window + t * 3 * kChunk;
        const float* src = c + 3 * first;
        for (unsigned f = bulk / 4; f < bytes / 4; ++f) dst[f] = src[f];
        bar_arrive_expect(smem_addr(&full[t]), bulk);
        if (bulk != 0) bulk_copy(smem_addr(dst), src, bulk, smem_addr(&full[t]));
      }
    }
    w.start_pass1();
    // pass 1, each chunk as it lands
    for (int t = 0; t < n_win; ++t) {
      bar_wait(smem_addr(&full[t]), parity);
      const float* sc = window + t * 3 * kChunk;
      const int base = (rank + (w0 + t) * S) * kChunk;
      const int n = min(kChunk, C - base);
      if (n == kChunk) {
#pragma unroll 1
        for (int m0 = 0; m0 < kChunk / 4; m0 += 32) w.template scan<false>(sc, m0, n, base, lane);
      } else {
#pragma unroll 1
        for (int m0 = 0; m0 < (n + 3) / 4; m0 += 32) w.template scan<true>(sc, m0, n, base, lane);
      }
    }
    // the bounds, then pass 2 over the resident window
    w.bound(lane);
    for (int t = 0; t < n_win; ++t) {
      const float* sc = window + t * 3 * kChunk;
      const int base = (rank + (w0 + t) * S) * kChunk;
      const int n = min(kChunk, C - base);
      if (n == kChunk) {
        w.template rescan<false>(sc, n, base, lane);
      } else {
        w.template rescan<true>(sc, n, base, lane);
      }
    }
    __syncthreads();  // every warp is done with the window before it is refilled
  }

  // ---- the cluster's lists into its leader's window, merged there ----
  // the first barrier: every block of the cluster has finished its piece
  // (and so has started) and its window is free
  float* md = window;                                                  // (S - 1, kBlockQueries, K)
  int* mi = reinterpret_cast<int*>(md + (kMaxCluster - 1) * kBlockQueries * K);
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
  if (rank != 0 && lane < K) {  // lane s: slot s of each list
#pragma unroll
    for (int j = 0; j < kWarpQueries; ++j) {
      const int o = (((rank - 1) * kDenseWarps + warp) * kWarpQueries + j) * K + lane;
      store_in_block(smem_addr(md + o), 0, __float_as_uint(pick(w.ld[j], lane)));
      store_in_block(smem_addr(mi + o), 0, static_cast<unsigned>(pick(w.li[j], lane)));
    }
  }
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
  if (rank != 0) return;
  for (int r = 1; r < S; ++r) {
#pragma unroll
    for (int j = 0; j < kWarpQueries; ++j) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int o = (((r - 1) * kDenseWarps + warp) * kWarpQueries + j) * K + s;
        w.offer(j, md[o], mi[o]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kWarpQueries; ++j) {  // lane s writes slot s
    if (q0 + j >= Q || lane >= K) continue;
    const long long o = static_cast<long long>(q0 + j) * K + lane;
    const float d = pick(w.ld[j], lane);
    const int i = pick(w.li[j], lane);
    if constexpr (F == kPacked) {
      out_d[o] = __int_as_float(i & ~kLowBits);
      out_i[o] = i & kLowBits;
    } else if constexpr (F == kCoords) {
      // a filled slot (below the 1e30 start) takes its candidate's
      // coordinates; its distance reads 1e30 above 1e29, as on the TPU
      out_d[o] = d > kFar ? kBig : d;
      for (int k = 0; k < 3; ++k) out_c[3 * o + k] = d < kBig ? c[3LL * i + k] : 0.0f;
      if (out_i != nullptr) out_i[o] = i;
    } else {
      out_d[o] = d;
      out_i[o] = i;
    }
  }
}

// The cluster size S: as many pieces as let the grid's blocks all be
// resident at once (at least 1, at most kMaxCluster and the chunk count).
template <int K, int F>
cudaError_t launch_dense(const void* q, const void* c, void* out_d, void* out_i, void* out_c,
                         int Q, int C, cudaStream_t stream) {
  constexpr size_t smem = kDenseSmem;
  static int per_sm = 0;  // resident blocks an SM, found once
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(topk_kernel<K, F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_kernel<K, F>, kDenseThreads,
                                                      smem);
    if (e != cudaSuccess) return e;
    per_sm = per_sm < 1 ? 1 : per_sm;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int groups = (Q + kBlockQueries - 1) / kBlockQueries;
  const int n_chunks = (C + kChunk - 1) / kChunk;
  const int S = max(1, min(min(kMaxCluster, n_chunks), sms * per_sm / groups));

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * S);
  cfg.blockDim = dim3(kDenseThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, topk_kernel<K, F>, static_cast<const float*>(q),
                            static_cast<const float*>(c), static_cast<float*>(out_d),
                            static_cast<int*>(out_i), static_cast<float*>(out_c), Q, C);
}

template <int K>
cudaError_t launch_dense_k(int form, const void* q, const void* c, void* out_d, void* out_i,
                           void* out_c, int Q, int C, cudaStream_t stream) {
  switch (form) {
    case kPacked: return launch_dense<K, kPacked>(q, c, out_d, out_i, out_c, Q, C, stream);
    case kCoords: return launch_dense<K, kCoords>(q, c, out_d, out_i, out_c, Q, C, stream);
    default: return launch_dense<K, kIndex>(q, c, out_d, out_i, out_c, Q, C, stream);
  }
}

}  // namespace

// K5, K8, K5p. q (Q, 3), c (C, 3) float32, c 16-byte aligned -> out_d (Q, k)
// float32, out_i (Q, k) int32 and, for K8, out_c (Q, k, 3) float32 (else
// null; with it out_i may be null). packed (K5p): out_c null, C <= 32768.
// One launch on the stream.
extern "C" int lvo_block_topk(const void* q, const void* c, void* out_d, void* out_i, void* out_c,
                              int Q, int C, int k, int packed, void* stream) {
  if (Q <= 0 || C <= 0 || k < 1 || k > kMaxK || reinterpret_cast<uintptr_t>(c) % 16 != 0)
    return cudaErrorInvalidValue;
  if ((out_i == nullptr && out_c == nullptr) ||
      (packed && (out_c != nullptr || out_i == nullptr || C > kLowBits + 1)))
    return cudaErrorInvalidValue;
  const int form = packed ? kPacked : out_c != nullptr ? kCoords : kIndex;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LVO_TOPK_CASE(K) \
  case K:                \
    return launch_dense_k<K>(form, q, c, out_d, out_i, out_c, Q, C, s);
  switch (k) {
    LVO_TOPK_CASE(1)
    LVO_TOPK_CASE(2)
    LVO_TOPK_CASE(3)
    LVO_TOPK_CASE(4)
    LVO_TOPK_CASE(5)
    LVO_TOPK_CASE(6)
    LVO_TOPK_CASE(7)
    default: return launch_dense_k<8>(form, q, c, out_d, out_i, out_c, Q, C, s);
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
