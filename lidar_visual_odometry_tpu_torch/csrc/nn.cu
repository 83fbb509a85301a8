// Ring-structured nearest neighbours, two kernels of the JAX package:
//  * K2, ring-structured scan-to-scan association (lvo_associate): for each
//    query, the two nearest candidates of every ring, then the cross-ring
//    selection that the edge and plane factors need. Replaces the Pallas TPU
//    kernel lidar_visual_odometry_tpu/ops/pallas_nn.py associate_kernel
//    (_assoc_kernel).
//  * K7, per-ring top-2 (lvo_ring_top2): the first stage of K2 alone, with its
//    own outputs. Replaces pallas_nn.py ring_top2_pallas / ring_top2_coords
//    (_ring_top2_call, _ring_top2_kernel); see the note at lvo_ring_top2.
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
// Exact rules kept from the TPU kernel: the distance is (c - q) squared per
// component, summed as (dx^2 + dy^2) + dz^2 with round-to-nearest intrinsics so
// that nvcc cannot contract it into fused multiply-adds; ties go to the first
// index within a ring and to the first ring across rings. The runner-up is
// the TPU kernel's second arg-min over the ring with the winner set to 1e30:
// the lexicographic second (distance, index) when that is below 1e30, and
// (1e30, the first index holding 1e30 after the winner is set to it)
// otherwise; so B == 1 gives (1e30, 0).

#include <cuda_runtime.h>
#include <math.h>

#include <climits>
#include <cstdint>
#include <limits>

namespace {

constexpr float kBig = 1e30f;

// ---- K7 ----

constexpr int kQueriesPerBlock = 32;
constexpr int kRingsPerBlock = 8;

struct Top2 {
  float d1, d2;
  int i1, i2;
};

// The two nearest of one ring's B candidates (cr, (B, 3) row-major) to
// (qx, qy, qz). Candidate 0 starts as the nearest; the runner-up starts as the TPU
// kernel's sentinel (the winner's slot set to 1e30), which is what it returns
// when the ring has no other candidate (B == 1).
__device__ __forceinline__ Top2 stream_ring(const float* __restrict__ cr, int B, float qx,
                                            float qy, float qz) {
  Top2 t{0.0f, kBig, 0, 0};
  for (int b = 0; b < B; ++b) {
    const float dx = __fsub_rn(__ldg(cr + 3 * b), qx);
    const float dy = __fsub_rn(__ldg(cr + 3 * b + 1), qy);
    const float dz = __fsub_rn(__ldg(cr + 3 * b + 2), qz);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    if (b == 0) {
      t.d1 = d;
    } else if (d < t.d1) {
      t.d2 = t.d1;
      t.i2 = t.i1;
      t.d1 = d;
      t.i1 = b;
    } else if (d < t.d2) {
      t.d2 = d;
      t.i2 = b;
    }
  }
  return t;
}

// K7: a thread per (query, ring), 32 queries x 8 rings a block, each
// streaming its ring from global memory (stream_ring), written in the
// (Q, R, 2) layout of ring_top2_pallas: dist, and either idx (flat into R * B) or the winners'
// coordinates c1, c2 (Q, R, 3), fetched by index. Null outputs are skipped.
__global__ void ring_top2_out_kernel(const float* __restrict__ q, const float* __restrict__ c,
                                     float2* __restrict__ dist, int2* __restrict__ idx,
                                     float* __restrict__ c1, float* __restrict__ c2, int Q,
                                     int R, int B) {
  const int qi = blockIdx.x * kQueriesPerBlock + threadIdx.x;
  const int r = blockIdx.y * kRingsPerBlock + threadIdx.y;
  if (qi >= Q || r >= R) return;
  const float* cr = c + static_cast<long long>(r) * B * 3;
  const Top2 t = stream_ring(cr, B, q[3 * qi], q[3 * qi + 1], q[3 * qi + 2]);
  const long long o = static_cast<long long>(qi) * R + r;
  dist[o] = make_float2(t.d1, t.d2);
  if (idx != nullptr) idx[o] = make_int2(r * B + t.i1, r * B + t.i2);
  if (c1 != nullptr) {
    for (int k = 0; k < 3; ++k) {
      c1[3 * o + k] = cr[3 * t.i1 + k];
      c2[3 * o + k] = cr[3 * t.i2 + k];
    }
  }
}

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
// Off the product path: only the JAX package's ring-blocked association
// (knn.ring_top2_best) and its tests reach the TPU kernel. Shapes: edges
// Q = 768 against (64, 120, 3), planes Q = 1536 against (64, 512, 3).
// What bounds it on an H100: float32 arithmetic, as K2's first stage (8
// operations a pair, 5e7 pairs for the planes); the outputs are 1.5 MB (idx)
// or 3 MB (coordinates) for the planes. Design: a (query, ring) thread
// streams its ring's candidates from global memory (all 32 lanes of a warp
// read the same candidate, one broadcast transaction from L1/L2) and writes
// its own (query, ring) slots; the TPU kernel's one-hot MXU products for the
// coordinates become loads by index.
extern "C" int lvo_ring_top2(const void* q, const void* c, void* dist, void* idx, void* c1,
                             void* c2, int Q, int R, int B, void* stream) {
  if (Q <= 0 || R <= 0 || B <= 0) return cudaErrorInvalidValue;
  if ((idx == nullptr) == (c1 == nullptr) || (c1 == nullptr) != (c2 == nullptr))
    return cudaErrorInvalidValue;
  dim3 block(kQueriesPerBlock, kRingsPerBlock);
  dim3 grid((Q + kQueriesPerBlock - 1) / kQueriesPerBlock,
            (R + kRingsPerBlock - 1) / kRingsPerBlock);
  ring_top2_out_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(c), static_cast<float2*>(dist),
      static_cast<int2*>(idx), static_cast<float*>(c1), static_cast<float*>(c2), Q, R, B);
  return cudaGetLastError();
}
