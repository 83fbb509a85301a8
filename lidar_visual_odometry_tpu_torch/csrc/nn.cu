// Ring-structured nearest neighbours, two kernels of the JAX package:
//  * K2, ring-structured scan-to-scan association (lvo_associate): for each
//    query, the two nearest candidates of every ring, then the cross-ring
//    selection that the edge and plane factors need. Replaces the Pallas TPU
//    kernel lidar_visual_odometry_tpu/ops/pallas_nn.py associate_kernel
//    (_assoc_kernel).
//  * K7, per-ring top-2 (lvo_ring_top2): the first stage of K2 alone, with its
//    own outputs. Replaces pallas_nn.py ring_top2_pallas / ring_top2_coords
//    (_ring_top2_call, _ring_top2_kernel); its note follows K2's.
//
// K2. Inputs: queries q (Q, 3) and ring-blocked
// candidates c (R, B, 3) whose masked points were moved to BAKE_FAR by the
// caller. Output (Q, 16) float32 rows:
//   [0:3 c1r0 | 3:6 c2r0 | 6:9 c1rw | 9 d0 | 10 d2same | 11 dw | 12:16 zero]
// where r0 is the ring holding the nearest candidate overall, c1r0/c2r0 its
// nearest and runner-up, and rw the ring with the nearest candidate among the
// rings 0 < |r - r0| <= nearby_scan (c1rw is zero when no ring is in that
// window). On the main path: edges Q = 768 against (64, 120, 3), planes
// Q = 1536 against (64, 512, 3), two calls per re-association round.
//
// What bounds it on an H100: float32 instructions. A (query, candidate) pair
// costs 3 subtractions, 3 products and 2 sums, each rounded alone, and a
// compare: about 9-10 instructions, at ~32 T instructions a second. The
// planes call has 1536 x 64 x 512 = 50.3 M pairs, ~15 us; the edges call
// 5.9 M, ~2 us. Both move well under 1 MB; a launch costs a few microseconds
// of latency beside that.
//
// Design: one launch, no scratch outside the block. A block owns QT queries
// (12 when that still gives 128 blocks, else 6: 128 blocks for both path
// calls on 132 SMs) and all R rings, in two passes:
//  1. The nearest distance of every (query, ring). Rings are staged in shared
//     memory with cp.async as they lie in memory (four candidates are three
//     float4s): all R in one stage when they fit 96 KB (the edges' 64 x 120),
//     else 16 at a time, double buffered (the planes' 6 KB rings). Warp w
//     takes the rings w, w + 16, ... of a stage; lane l the quads l, l + 32,
//     ... of the ring, with all QT queries in registers: QT independent
//     chains a candidate and one fminf a pair, no index or runner-up kept.
//     A transposing lane reduction (LaneMin) leaves each (query, ring)
//     minimum in shared memory.
//  2. A warp a query: r0 and rw from those minima by warp reductions, then
//     the exact (distance, index) top-2 of ring r0 and the nearest of ring
//     rw, rescanning just those two rings from global memory (L2), and the
//     (Q, 16) row. Two rings a query cost 2/64 of the first pass.
// Keeping only minima in the first pass takes the index and runner-up
// bookkeeping (about half the instructions a pair) out of the hot loop.
//
// K7. Inputs as K2's; outputs dist (Q, R, 2) and either idx (Q, R, 2), flat
// into R * B, or the winners' coordinates c1, c2 (Q, R, 3): the exact
// (distance, index) top-2 of every (query, ring), so it cannot drop K2's
// bookkeeping. Off the product path; shapes as K2's.
//
// What bounds it on an H100: instructions. The table's bound counts the 8
// float32 operations a pair at 67 T a second (0.0067 ms for both path
// calls), but unfused operations issue at half that rate, ~33.5 T a second
// on 132 SMs at 1.98 GHz, and the exact top-2 costs more again: updated
// candidate by candidate, two compares, three min/max and three selects a
// pair, on a pipe of half the float32 rate, so about 16.5 instructions a
// pair with the loads (~0.025 ms for the planes' 50.3 M pairs, ~0.003 for
// the edges' 5.9 M). The outputs are 0.8-3.1 MB a call, a microsecond.
//
// Design: one launch. A block owns 32 * QPT queries (lane l holds queries
// l, l + 32, ...: QPT independent chains) and G consecutive rings, each
// split into S segments of candidate quads, a warp a (ring, segment); QPT
// and S are chosen at launch so that both path calls give the card ~16
// warps an SM (top2_config). The G rings are staged in shared memory with
// cp.async as they lie in memory, in pieces of at most 48 KB (double
// buffered) when they do not fit one. A warp reads a staged quad with three
// broadcast float4 loads and folds its four distances into each query's
// top-2 a quad at a time, with no branch (push_quad): the quad's two
// smallest values by a min/max network, merged with the running pair by
// value, the pairs tagged by quad; 4.5 bookkeeping instructions a pair
// where a candidate-by-candidate update takes 8. Within a segment the quads
// ascend, so a strict < keeps the first index; at the end of a piece the
// tags become indices (first_at, two quads a query rescanned). The segments'
// pairs meet in shared memory, merged lexicographically by (distance,
// index), which gives the same pair for any S; then the runner-up rule
// below, once, and the writes, G consecutive rings of a query from
// neighbouring threads (c1 and c2 read from the staged ring when it is whole
// in shared memory).
//
// Exact rules kept from the TPU kernel: the distance is (c - q) squared per
// component, summed as (dx^2 + dy^2) + dz^2 with round-to-nearest intrinsics so
// that nvcc cannot contract it into fused multiply-adds; ties go to the first
// index within a ring and to the first ring across rings. The runner-up is
// the TPU kernel's second arg-min over the ring with the winner set to 1e30:
// the lexicographic second (distance, index) when that is below 1e30, and
// (1e30, the first index holding 1e30 after the winner is set to it)
// otherwise; so B == 1 gives (1e30, 0). A ring whose distances are all +inf
// (coordinates near 1e19 and beyond) has its winner at index 0, as arg-min.

#include <cuda_runtime.h>
#include <math.h>

#include <climits>
#include <cstdint>
#include <limits>

namespace {

constexpr float kBig = 1e30f;

// ---- K2 ----

constexpr int kAssocWarps = 16;
constexpr int kAssocThreads = 32 * kAssocWarps;
constexpr int kMaxSmem = 227 * 1024;            // an H100 block's shared memory
constexpr int kStageBytes = 96 * 1024;          // a stage buffer, when R rings do not fit one
constexpr float kInf = std::numeric_limits<float>::infinity();

struct Best2 {
  float d1, d2;
  int i1, i2;
};

__device__ __forceinline__ bool lex_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// (d, i) into a stream that sees ascending indices: a strict < keeps the
// earlier index on ties, so the stream holds its lexicographic two smallest.
__device__ __forceinline__ void push(Best2& t, float d, int i) {
  if (d < t.d2) {
    if (d < t.d1) {
      t.d2 = t.d1;
      t.i2 = t.i1;
      t.d1 = d;
      t.i1 = i;
    } else {
      t.d2 = d;
      t.i2 = i;
    }
  }
}

// The two smallest (distance, index) pairs of two disjoint streams.
__device__ __forceinline__ Best2 merge(const Best2& a, const Best2& b) {
  Best2 r;
  if (lex_less(b.d1, b.i1, a.d1, a.i1)) {
    const bool a1 = lex_less(a.d1, a.i1, b.d2, b.i2);
    r = Best2{b.d1, a1 ? a.d1 : b.d2, b.i1, a1 ? a.i1 : b.i2};
  } else {
    const bool b1 = lex_less(b.d1, b.i1, a.d2, a.i2);
    r = Best2{a.d1, b1 ? b.d1 : a.d2, a.i1, b1 ? b.i1 : a.i2};
  }
  return r;
}

__device__ __forceinline__ Best2 shfl_xor(const Best2& t, int m) {
  return Best2{__shfl_xor_sync(0xffffffffu, t.d1, m), __shfl_xor_sync(0xffffffffu, t.d2, m),
               __shfl_xor_sync(0xffffffffu, t.i1, m), __shfl_xor_sync(0xffffffffu, t.i2, m)};
}

// (c - q)^2 summed as (dx^2 + dy^2) + dz^2, each operation rounded alone.
__device__ __forceinline__ float sqd(float cx, float cy, float cz, float qx, float qy,
                                     float qz) {
  const float dx = __fsub_rn(cx, qx);
  const float dy = __fsub_rn(cy, qy);
  const float dz = __fsub_rn(cz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The lane-wise minimum of a warp's QT values: after it, a lane holds M
// minima over all 32 lanes, for the queries qbase .. qbase + M - 1. While the
// count is even a step halves it (the lanes on either side of bit Off keep
// one half, receiving the other lane's copy of it); an odd count is reduced
// whole (butterfly).
template <int M, int Off>
struct LaneMin {
  template <int N>
  __device__ __forceinline__ static int run(float (&m)[N], int lane, int qbase) {
    if constexpr (Off == 0) {
      return qbase;
    } else if constexpr (M % 2 == 0) {
      const bool hi = (lane & Off) != 0;
#pragma unroll
      for (int j = 0; j < M / 2; ++j) {
        const float keep = hi ? m[j + M / 2] : m[j];
        const float send = hi ? m[j] : m[j + M / 2];
        m[j] = fminf(keep, __shfl_xor_sync(0xffffffffu, send, Off));
      }
      return LaneMin<M / 2, Off / 2>::run(m, lane, hi ? qbase + M / 2 : qbase);
    } else {
#pragma unroll
      for (int j = 0; j < M; ++j) m[j] = fminf(m[j], __shfl_xor_sync(0xffffffffu, m[j], Off));
      return LaneMin<M, Off / 2>::run(m, lane, qbase);
    }
  }
};

// The count of values LaneMin leaves a lane: QT with its factors 2 taken out,
// at most five times.
__host__ __device__ constexpr int reduced_count(int m, int steps = 5) {
  return steps == 0 || m % 2 ? m : reduced_count(m / 2, steps - 1);
}

// The two nearest of ring r's B candidates to (qx, qy, qz) by (distance,
// index), over the warp (lane l takes b = l, l + 32, ... from global memory),
// with the TPU's runner-up: the winner's slot set to 1e30, then the first
// arg-min, which differs from the second pair only at or above 1e30 (so
// B == 1 gives (1e30, 0)).
__device__ __forceinline__ Best2 ring_top2_warp(const float* __restrict__ c, int r, int B,
                                                float qx, float qy, float qz, int lane) {
  Best2 t{kInf, kInf, INT_MAX, INT_MAX};
  const float* cr = c + 3LL * r * B;
#pragma unroll 4
  for (int b = lane; b < B; b += 32)
    push(t, sqd(__ldg(cr + 3 * b), __ldg(cr + 3 * b + 1), __ldg(cr + 3 * b + 2), qx, qy, qz),
         b);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) t = merge(t, shfl_xor(t, m));
  if (t.i1 == INT_MAX) t.i1 = 0;  // no distance below +inf: arg-min's first index
  if (!(t.d2 < kBig)) {
    t.i2 = (t.d2 == kBig && t.i2 < t.i1) ? t.i2 : t.i1;
    t.d2 = kBig;
  }
  return t;
}

// A ring in shared memory: its candidates as they lie in memory, padded to
// whole quads (four candidates are 12 floats, three float4s).
__host__ __device__ inline int assoc_ring_floats(int B) { return 12 * ((B + 3) / 4); }

// Rings a stage: all R when they fit kStageBytes (one stage, one buffer),
// else as many as fit it (two buffers, double buffered).
__host__ __device__ inline int assoc_stage_rings(int R, int B) {
  const int per = kStageBytes / (4 * assoc_ring_floats(B));
  return R <= per ? R : (per > 0 ? per : 1);
}

template <int QT>
__host__ __device__ inline size_t assoc_smem_bytes(int R, int B) {
  const int G = assoc_stage_rings(R, B);
  const int n_buf = G < R ? 2 : 1;
  return sizeof(float) * (n_buf * G * static_cast<size_t>(assoc_ring_floats(B)) +
                          QT * static_cast<size_t>(R));
}

// A block: QT queries, all R rings, in two passes.
//  1. Every ring's nearest distance d1 for every query, from the staged rings:
//     lane l of a warp takes the quads l, l + 32, ... of its ring and keeps a
//     running minimum a query (QT independent chains a candidate, one fminf a
//     pair: no index, no runner-up), then LaneMin.
//  2. A warp a query: r0 and rw from the d1s, then the exact (distance, index)
//     top-2 of ring r0 and the nearest of ring rw, rescanning those two rings
//     from global memory (ring_top2_warp), and the row.
// vec: B % 4 == 0 and c 16-byte aligned, so a stage is one contiguous run of
// 16-byte copies; else 4-byte copies.
template <int QT>
__global__ void __launch_bounds__(kAssocThreads) assoc_kernel(
    const float* __restrict__ q, const float* __restrict__ c, float* __restrict__ out, int Q,
    int R, int B, float nearby_scan, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int ring_f = assoc_ring_floats(B);
  const int n_quads = ring_f / 12;
  const int G = assoc_stage_rings(R, B);
  const int n_groups = (R + G - 1) / G;
  const int n_buf = n_groups > 1 ? 2 : 1;
  float* const d1s = smem + n_buf * G * ring_f;  // (QT, R)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QT;
  float qx[QT], qy[QT], qz[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) {  // a query past Q repeats the last one
    const int qc = min(q0 + j, Q - 1);
    qx[j] = q[3 * qc];
    qy[j] = q[3 * qc + 1];
    qz[j] = q[3 * qc + 2];
  }

  // the tail of a ring's last quad is never copied: +inf never lowers a minimum
  for (int j = threadIdx.x; j < n_buf * G; j += kAssocThreads)
    for (int f = 3 * B; f < ring_f; ++f) smem[j * ring_f + f] = kInf;

  auto stage_group = [&](int g, float* dst) {
    const int r0 = g * G;
    const int nr = min(G, R - r0);
    const float* src = c + 3LL * r0 * B;
    if (vec) {
      for (int f = threadIdx.x; f < nr * 3 * B / 4; f += kAssocThreads)
        cp_async16(dst + 4 * f, src + 4 * f);
    } else {
      for (int j = 0; j < nr; ++j)
        for (int f = threadIdx.x; f < 3 * B; f += kAssocThreads)
          cp_async4(dst + j * ring_f + f, src + 3LL * j * B + f);
    }
    cp_async_commit();
  };

  // ---- 1. every ring's nearest distance, for every query ----
  stage_group(0, smem);
  for (int g = 0; g < n_groups; ++g) {
    if (g + 1 < n_groups) {
      stage_group(g + 1, smem + ((g + 1) & 1) * G * ring_f);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = smem + (g & 1) * G * ring_f;
    for (int rr = warp; rr < min(G, R - g * G); rr += kAssocWarps) {  // uniform in the warp
      const float4* ring = reinterpret_cast<const float4*>(buf + rr * ring_f);
      float m[QT];
#pragma unroll
      for (int j = 0; j < QT; ++j) m[j] = kInf;
      for (int k = lane; k < n_quads; k += 32) {
        const float4 u = ring[3 * k], v = ring[3 * k + 1], w = ring[3 * k + 2];
        const float cs[12] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w, w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < QT; ++j)
            m[j] = fminf(m[j], sqd(cs[3 * e], cs[3 * e + 1], cs[3 * e + 2], qx[j], qy[j], qz[j]));
        }
      }
      const int qbase = LaneMin<QT, 16>::run(m, lane, 0);
      // lanes holding the same minimum write the same value
#pragma unroll
      for (int j = 0; j < reduced_count(QT); ++j) d1s[(qbase + j) * R + g * G + rr] = m[j];
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // ---- 2. the cross-ring selection and the winners, a warp a query ----
  for (int qq = warp; qq < QT; qq += kAssocWarps) {
    const int qg = q0 + qq;
    if (qg >= Q) break;  // uniform in the warp
    const float* dq = d1s + qq * R;
    // r0: the ring of the nearest candidate, the first ring on ties
    float d0 = kInf;
    int r0 = INT_MAX;
    for (int r = lane; r < R; r += 32) {
      if (lex_less(dq[r], r, d0, r0)) {
        d0 = dq[r];
        r0 = r;
      }
    }
    warp_lex_min(d0, r0);
    // rw: the nearest among the rings 0 < |r - r0| <= nearby_scan, the others
    // reading 1e30; the first ring on ties
    float dw = kInf;
    int rw = INT_MAX;
    for (int r = lane; r < R; r += 32) {
      const float rdiff = fabsf(static_cast<float>(r) - static_cast<float>(r0));
      const float d = (rdiff > 0.0f && rdiff <= nearby_scan) ? dq[r] : kBig;
      if (lex_less(d, r, dw, rw)) {
        dw = d;
        rw = r;
      }
    }
    warp_lex_min(dw, rw);
    const float rwdiff = fabsf(static_cast<float>(rw) - static_cast<float>(r0));
    const bool rw_in_window = rwdiff > 0.0f && rwdiff <= nearby_scan;
    const float px = q[3 * qg], py = q[3 * qg + 1], pz = q[3 * qg + 2];
    const Best2 t0 = ring_top2_warp(c, r0, B, px, py, pz, lane);
    const int iw = rw_in_window ? ring_top2_warp(c, rw, B, px, py, pz, lane).i1 : 0;
    float v = 0.0f;
    if (lane < 3) {
      v = c[(static_cast<long long>(r0) * B + t0.i1) * 3 + lane];
    } else if (lane < 6) {
      v = c[(static_cast<long long>(r0) * B + t0.i2) * 3 + lane - 3];
    } else if (lane < 9) {
      if (rw_in_window) v = c[(static_cast<long long>(rw) * B + iw) * 3 + lane - 6];
    } else if (lane == 9) {
      v = d0;
    } else if (lane == 10) {
      v = t0.d2;
    } else if (lane == 11) {
      v = dw;
    }
    if (lane < 16) out[static_cast<long long>(qg) * 16 + lane] = v;
  }
}

template <int QT>
cudaError_t launch_assoc(const void* q, const void* c, void* out, int Q, int R, int B,
                         float nearby_scan, cudaStream_t stream) {
  const size_t smem = assoc_smem_bytes<QT>(R, B);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static bool configured[64] = {};  // the attribute, set once a device
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(assoc_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    configured[dev] = true;
  }
  const int vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  assoc_kernel<QT><<<(Q + QT - 1) / QT, kAssocThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(c), static_cast<float*>(out), Q,
      R, B, nearby_scan, vec);
  return cudaGetLastError();
}

// ---- K7 ----

constexpr int kTop2MaxWarps = 8;              // a block: G rings x S segments, a warp each
constexpr int kTop2StageBytes = 48 * 1024;    // a stage buffer
constexpr int kTop2TargetWarps = 132 * 16;    // ~16 warps on each of the H100's SMs
constexpr int kTop2MinQuads = 12;             // a segment's fewest quads at 2 or 4 queries a thread

// A quad of four distances into a stream's (d1, x1, d2, x2), whose
// candidates all come before the quad's, with no branch: the quad's two
// smallest values (a min/max network), then a merge in which the stream wins
// ties, as a strict < keeps the first index. x1 and x2 tag their pairs:
// quad k of this piece (>= 0), or a resolved index i as ~i (first_at).
__device__ __forceinline__ void push_quad(Best2& t, float a0, float a1, float a2, float a3,
                                          int k) {
  const float lo01 = fminf(a0, a1), hi01 = fmaxf(a0, a1);
  const float lo23 = fminf(a2, a3), hi23 = fmaxf(a2, a3);
  const float m1 = fminf(lo01, lo23);
  const float m2 = fminf(fmaxf(lo01, lo23), fminf(hi01, hi23));
  const bool first = m1 < t.d1;                // the quad holds the new first
  const int if_first = m2 < t.d1 ? k : t.i1;   // then the second: the quad's or the old first
  const int if_not = m1 < t.d2 ? k : t.i2;     // else: the quad's first or the old second
  t.i2 = first ? if_first : if_not;
  t.d2 = fminf(fmaxf(t.d1, m1), fminf(t.d2, m2));
  t.i1 = first ? k : t.i1;
  t.d1 = fminf(t.d1, m1);
}

// The first candidate of staged quad k, other than `skip`, at distance d
// from (qx, qy, qz): the one a tag names (d is one of its distances).
__device__ __forceinline__ int first_at(const float4* ring, int k, float d, int skip, float qx,
                                        float qy, float qz) {
  const float4 u = ring[3 * k], v = ring[3 * k + 1], w = ring[3 * k + 2];
  const float cs[12] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w, w.x, w.y, w.z, w.w};
  int e = 3;
#pragma unroll
  for (int f = 2; f >= 0; --f)
    if (f != skip && sqd(cs[3 * f], cs[3 * f + 1], cs[3 * f + 2], qx, qy, qz) == d) e = f;
  return e;
}

// A block: 32 * QPT queries x G = blockDim.x / (32 * S) rings, a warp a
// (ring g, segment s). The rings are staged in pieces of PB candidates (a
// multiple of 4), each ring's piece padded to whole quads with +inf, which
// never enters a top-2. Segment s takes quads [s * nq / S, (s + 1) * nq / S)
// of every piece, so its candidates ascend. vec: B % 4 == 0 and c 16-byte
// aligned, so 16-byte copies; else 4-byte copies.
template <int QPT>
__global__ void __launch_bounds__(32 * kTop2MaxWarps) ring_top2_kernel(
    const float* __restrict__ q, const float* __restrict__ c, float2* __restrict__ dist,
    int2* __restrict__ idx, float* __restrict__ c1, float* __restrict__ c2, int Q, int R, int B,
    int S, int PB, int vec) {
  constexpr int QB = 32 * QPT;
  extern __shared__ __align__(16) float smem[];
  const int G = blockDim.x / (32 * S);
  const int n_pieces = (B + PB - 1) / PB;
  const int ring_f = 3 * PB;
  float4* const part = reinterpret_cast<float4*>(smem + (n_pieces > 1 ? 2 : 1) * G * ring_f);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = warp / S, s = warp - g * S;
  const int q0 = blockIdx.x * QB;
  const int r0 = blockIdx.y * G;
  const int nr = min(G, R - r0);

  float qx[QPT], qy[QPT], qz[QPT];
  Best2 t[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {  // a query past Q repeats the last one
    const int qc = min(q0 + lane + 32 * j, Q - 1);
    qx[j] = q[3 * qc];
    qy[j] = q[3 * qc + 1];
    qz[j] = q[3 * qc + 2];
    t[j] = Best2{kInf, kInf, ~INT_MAX, ~INT_MAX};  // resolved to "no candidate"
  }

  auto stage = [&](int p, float* dst) {
    const int b0 = p * PB;
    const int nf = 3 * min(PB, B - b0);
    if (vec) {
      const int per = nf / 4;
      for (int f = threadIdx.x; f < nr * per; f += blockDim.x) {
        const int j = f / per;
        const int k = f - j * per;
        cp_async16(dst + j * ring_f + 4 * k,
                   c + 3 * ((r0 + j) * static_cast<long long>(B) + b0) + 4 * k);
      }
    } else {
      for (int f = threadIdx.x; f < nr * nf; f += blockDim.x) {
        const int j = f / nf;
        const int k = f - j * nf;
        cp_async4(dst + j * ring_f + k, c + 3 * ((r0 + j) * static_cast<long long>(B) + b0) + k);
      }
      const int tail = 12 * ((nf / 3 + 3) / 4) - nf;
      for (int f = threadIdx.x; f < nr * tail; f += blockDim.x) {
        const int j = f / tail;
        dst[j * ring_f + nf + f - j * tail] = kInf;
      }
    }
    cp_async_commit();
  };

  stage(0, smem);
  for (int p = 0; p < n_pieces; ++p) {
    if (p + 1 < n_pieces) {
      stage(p + 1, smem + ((p + 1) & 1) * G * ring_f);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (g < nr) {  // uniform in the warp
      const float4* ring =
          reinterpret_cast<const float4*>(smem + ((p & 1) * G + g) * ring_f);
      const int nq = (min(PB, B - p * PB) + 3) / 4;
      const int k_end = (s + 1) * nq / S;
#pragma unroll 2
      for (int k = s * nq / S; k < k_end; ++k) {
        const float4 u = ring[3 * k], v = ring[3 * k + 1], w = ring[3 * k + 2];
#pragma unroll
        for (int j = 0; j < QPT; ++j)
          push_quad(t[j], sqd(u.x, u.y, u.z, qx[j], qy[j], qz[j]),
                    sqd(u.w, v.x, v.y, qx[j], qy[j], qz[j]),
                    sqd(v.z, v.w, w.x, qx[j], qy[j], qz[j]),
                    sqd(w.y, w.z, w.w, qx[j], qy[j], qz[j]), k);
      }
      // this piece's quad tags become indices while its quads are staged
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        int e1 = -1;
        if (t[j].i1 >= 0) e1 = first_at(ring, t[j].i1, t[j].d1, -1, qx[j], qy[j], qz[j]);
        if (t[j].i2 >= 0) {
          const int skip = t[j].i2 == t[j].i1 ? e1 : -1;
          t[j].i2 = ~(p * PB + 4 * t[j].i2 +
                      first_at(ring, t[j].i2, t[j].d2, skip, qx[j], qy[j], qz[j]));
        }
        if (t[j].i1 >= 0) t[j].i1 = ~(p * PB + 4 * t[j].i1 + e1);
      }
    }
    __syncthreads();  // the buffer is consumed before it is refilled
  }

  // the segments' pairs, merged a (query, ring) slot a thread, G consecutive
  // rings of a query on neighbouring threads
  if (g < nr) {
#pragma unroll
    for (int j = 0; j < QPT; ++j)
      part[warp * QB + lane + 32 * j] =
          make_float4(t[j].d1, t[j].d2, __int_as_float(~t[j].i1), __int_as_float(~t[j].i2));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < QB * nr; e += blockDim.x) {
    const int qq = e / nr;
    const int gg = e - qq * nr;
    const int qg = q0 + qq;
    if (qg >= Q) break;
    Best2 m{kInf, kInf, INT_MAX, INT_MAX};
    for (int ss = 0; ss < S; ++ss) {
      const float4 v = part[(gg * S + ss) * QB + qq];
      m = merge(m, Best2{v.x, v.y, __float_as_int(v.z), __float_as_int(v.w)});
    }
    if (m.i1 == INT_MAX) m.i1 = 0;  // no distance below +inf: arg-min's first index
    // the TPU's runner-up: the winner's slot set to 1e30, then the first arg-min
    if (!(m.d2 < kBig)) {
      m.i2 = (m.d2 == kBig && m.i2 < m.i1) ? m.i2 : m.i1;
      m.d2 = kBig;
    }
    const int r = r0 + gg;
    const long long o = static_cast<long long>(qg) * R + r;
    dist[o] = make_float2(m.d1, m.d2);
    if (idx != nullptr) {
      idx[o] = make_int2(r * B + m.i1, r * B + m.i2);
    } else {
      const float* a = n_pieces == 1 ? smem + gg * ring_f + 3 * m.i1
                                     : c + 3 * (static_cast<long long>(r) * B + m.i1);
      const float* b = n_pieces == 1 ? smem + gg * ring_f + 3 * m.i2
                                     : c + 3 * (static_cast<long long>(r) * B + m.i2);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        c1[3 * o + k] = a[k];
        c2[3 * o + k] = b[k];
      }
    }
  }
}

struct Top2Config {
  int qpt, segments;
};

// Queries a thread and segments a ring: the most queries a thread (4, 2,
// 1) for which the fewest segments that give the card kTop2TargetWarps keep
// kTop2MinQuads quads a segment (at one query a thread, at least 2 quads).
// The path's calls get 1 x 2 (edges) and 4 x 4 (planes), the fastest of
// every combination tools/tune_ring_top2.py timed there; LVO_K7_QPT and
// LVO_K7_SEGMENTS fix both for it.
Top2Config top2_config(int Q, int R, int B) {
#if defined(LVO_K7_QPT) && defined(LVO_K7_SEGMENTS)
  return Top2Config{LVO_K7_QPT, LVO_K7_SEGMENTS};
#else
  const int nq = (B + 3) / 4;
  int qpt = 4, s = 1;
  for (;; qpt /= 2) {
    const long long warps = static_cast<long long>((Q + 32 * qpt - 1) / (32 * qpt)) * R;
    s = 1;
    while (2 * s <= kTop2MaxWarps && 4 * s <= nq && warps * s < kTop2TargetWarps) s *= 2;
    if (qpt == 1 || (warps * s >= kTop2TargetWarps && nq >= kTop2MinQuads * s)) break;
  }
  return Top2Config{qpt, s};
#endif
}

template <int QPT>
cudaError_t launch_top2(const void* q, const void* c, void* dist, void* idx, void* c1, void* c2,
                        int Q, int R, int B, int S, cudaStream_t stream) {
  const int G = max(1, min(R, kTop2MaxWarps / S));
  const int PB = min(4 * ((B + 3) / 4), max(4, kTop2StageBytes / (12 * G) / 4 * 4));
  const size_t smem = sizeof(float) * (B > PB ? 2 : 1) * G * 3 * static_cast<size_t>(PB) +
                      sizeof(float4) * G * S * 32 * QPT;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static bool configured[64] = {};  // the attribute, set once a device
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(ring_top2_kernel<QPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    configured[dev] = true;
  }
  const int vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  const dim3 grid((Q + 32 * QPT - 1) / (32 * QPT), (R + G - 1) / G);
  ring_top2_kernel<QPT><<<grid, 32 * G * S, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(c), static_cast<float2*>(dist),
      static_cast<int2*>(idx), static_cast<float*>(c1), static_cast<float*>(c2), Q, R, B, S, PB,
      vec);
  return cudaGetLastError();
}

}  // namespace

// q (Q, 3), baked c (R, B, 3) -> out (Q, 16), all float32. 12 queries a
// block when that still gives a block an SM (Q >= 12 * 128), else 6.
extern "C" int lvo_associate(const void* q, const void* c, void* out, int Q, int R, int B,
                             float nearby_scan, void* stream) {
  if (Q <= 0 || R <= 0 || B <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return Q >= 12 * 128 ? launch_assoc<12>(q, c, out, Q, R, B, nearby_scan, s)
                       : launch_assoc<6>(q, c, out, Q, R, B, nearby_scan, s);
}

// K7. q (Q, 3) and baked candidates c (R, B, 3) -> dist (Q, R, 2) float32 and
// either idx (Q, R, 2) int32 or c1, c2 (Q, R, 3) float32 (the other null).
//
// Replaces the TPU kernel's grid of (query tile, ring) steps, each taking a
// (QT, B) distance matrix, two arg-mins and one-hot MXU products for the
// coordinates (pallas_nn.py _ring_top2_call). Off the product path: only the
// JAX package's ring-blocked association (knn.ring_top2_best) and its tests
// reach the TPU kernel; chip_smoke.py phase 5 drives this one at the
// odometry association's shapes, edges Q = 768 against (64, 120, 3) and
// planes Q = 1536 against (64, 512, 3). Bound and design: the K7 note at the
// top. One launch; top2_config gives the edges 1 query a thread and 2
// segments a ring, the planes 4 and 4 (3,072 warps each).
extern "C" int lvo_ring_top2(const void* q, const void* c, void* dist, void* idx, void* c1,
                             void* c2, int Q, int R, int B, void* stream) {
  if (Q <= 0 || R <= 0 || B <= 0) return cudaErrorInvalidValue;
  if ((idx == nullptr) == (c1 == nullptr) || (c1 == nullptr) != (c2 == nullptr))
    return cudaErrorInvalidValue;
  const Top2Config cfg = top2_config(Q, R, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cfg.qpt) {
    case 1:
      return launch_top2<1>(q, c, dist, idx, c1, c2, Q, R, B, cfg.segments, s);
    case 2:
      return launch_top2<2>(q, c, dist, idx, c1, c2, Q, R, B, cfg.segments, s);
    case 4:
      return launch_top2<4>(q, c, dist, idx, c1, c2, Q, R, B, cfg.segments, s);
    default:
      return cudaErrorInvalidValue;
  }
}
