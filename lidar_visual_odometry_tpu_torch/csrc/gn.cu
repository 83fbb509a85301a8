// Fused scan-to-scan Gauss-Newton inner loop: n_iters iterations of
// point-to-line and point-to-plane residuals with analytic Jacobians, Huber
// IRLS weights, the 6x6 normal equations, a damped Cholesky solve and the
// left-multiplicative pose update, in one launch.
//
// Replaces the Pallas TPU kernel lidar_visual_odometry_tpu/ops/pallas_gn.py
// (gn_inner_loop / _gn_kernel) and follows its math step for step: the same
// residuals and Jacobian rows, Huber weights delta / max(|r|, 1e-12) outside
// delta, damping H_ii += lambda * max(H_ii, 1e-6), Cholesky pivots clamped at
// 1e-12, and the update skipped when the step is not finite. On the main path:
// pose q (4,) and t (3,), edges (3, 768) x 3 plus weights (1, 768), planes
// (3, 1536) x 4 plus weights (1, 1536), float32, one launch per
// re-association round.
//
// What bounds it on an H100: latency. About 2.3k correspondences times a few
// hundred operations is ~0.4 MFLOP an iteration, a microsecond of one SM's
// float32 rate and far less of the card's; each iteration's reduction to 27
// sums, the barrier that publishes them and the serial 6x6 solve set the time.
// The pose never leaves the card between iterations or between rounds.
//
// Design: one thread-block cluster of kBlocks blocks (the portable cluster
// size) on neighbouring SMs shares the problem.
//   * Warps are homogeneous: the first warps (interleaved over the blocks)
//     take edges, the rest planes, split by their cost (an edge's three
//     residual rows against a plane's one). A thread loads its first kSlots
//     correspondences once, with their pose-independent terms (the edge
//     direction and 1/|a - b|, the plane normal), and keeps them in registers
//     for all iterations; any further ones (inputs larger than the path's)
//     it reads again each iteration.
//   * Per iteration each thread accumulates the 27 terms (21 of H, 6 of g);
//     a transposed warp reduction (31 shuffles, lane l ends with term l) and
//     one shared-memory pass over the block's warps give the block's 27
//     partial sums. The block pushes them into slot [rank] of every block of
//     the cluster, with st.async into the others' shared memory, each store
//     counted on the receiver's mbarrier; each block waits on its own
//     mbarrier until all kBlocks partials are in. No cluster-wide barrier an
//     iteration (cluster.sync() is a barrier plus a GPU-scope fence and an
//     L1 invalidation); two slots and two mbarriers, used in turn, keep an
//     iteration's stores from meeting the reads of the one before.
//   * Every warp then sums the kBlocks partials in rank order from its own
//     shared memory, and every thread solves the same 6x6 system in
//     registers (reciprocal square-root pivots, no division) and updates the
//     same pose: no broadcast.
// Sums are taken in a fixed order (a thread's correspondences in index
// order, the warp tree, warps, then blocks in rank order), so two calls on
// the same inputs give the same bits. That order is not the plain PyTorch
// version's (two matrix products) and nvcc contracts products into fused
// multiply-adds, so the pose agrees with it to float32 rounding, not bit for
// bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlocks = 8;     // blocks of the cluster
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 2;      // correspondences a thread keeps in registers
constexpr int kTerms = 27;     // 21 upper-triangle H terms, then 6 g terms
constexpr unsigned kFull = 0xffffffffu;

struct Edge {  // a point, its line through a and b, and the line's cross-product rows
  float px, py, pz, ax, ay, az, bx, by, bz, dninv, m01, m02, m10, m12, m20, m21, w;
};

struct Plane {  // a point, a point j of its plane, the unit normal
  float px, py, pz, jx, jy, jz, nx, ny, nz, w;
};

struct Pose {
  float qw, qx, qy, qz, tx, ty, tz;
  float r00, r01, r02, r10, r11, r12, r20, r21, r22;

  __device__ __forceinline__ void rotation() {
    r00 = 1 - 2 * (qy * qy + qz * qz);
    r01 = 2 * (qx * qy - qw * qz);
    r02 = 2 * (qx * qz + qw * qy);
    r10 = 2 * (qx * qy + qw * qz);
    r11 = 1 - 2 * (qx * qx + qz * qz);
    r12 = 2 * (qy * qz - qw * qx);
    r20 = 2 * (qx * qz - qw * qy);
    r21 = 2 * (qy * qz + qw * qx);
    r22 = 1 - 2 * (qx * qx + qy * qy);
  }
};

__device__ __forceinline__ Edge load_edge(const float* __restrict__ ep,
                                          const float* __restrict__ ea,
                                          const float* __restrict__ eb,
                                          const float* __restrict__ ew, int Ne, int i) {
  Edge e;
  e.px = ep[i], e.py = ep[Ne + i], e.pz = ep[2 * Ne + i];
  e.ax = ea[i], e.ay = ea[Ne + i], e.az = ea[2 * Ne + i];
  e.bx = eb[i], e.by = eb[Ne + i], e.bz = eb[2 * Ne + i];
  e.w = ew[i];
  const float dx = e.ax - e.bx, dy = e.ay - e.by, dz = e.az - e.bz;
  e.dninv = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-18f));
  e.m01 = dz * e.dninv, e.m02 = -dy * e.dninv;
  e.m10 = -dz * e.dninv, e.m12 = dx * e.dninv;
  e.m20 = dy * e.dninv, e.m21 = -dx * e.dninv;
  return e;
}

__device__ __forceinline__ Plane load_plane(const float* __restrict__ pp,
                                            const float* __restrict__ pj,
                                            const float* __restrict__ pl,
                                            const float* __restrict__ pm,
                                            const float* __restrict__ pw, int Np, int i) {
  Plane p;
  p.px = pp[i], p.py = pp[Np + i], p.pz = pp[2 * Np + i];
  p.jx = pj[i], p.jy = pj[Np + i], p.jz = pj[2 * Np + i];
  p.w = pw[i];
  const float v1x = p.jx - pl[i], v1y = p.jy - pl[Np + i], v1z = p.jz - pl[2 * Np + i];
  const float v2x = p.jx - pm[i], v2y = p.jy - pm[Np + i], v2z = p.jz - pm[2 * Np + i];
  const float nx = v1y * v2z - v1z * v2y;
  const float ny = v1z * v2x - v1x * v2z;
  const float nz = v1x * v2y - v1y * v2x;
  const float ninv = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-18f));
  p.nx = nx * ninv, p.ny = ny * ninv, p.nz = nz * ninv;
  return p;
}

__device__ __forceinline__ void add_row(float* acc, const float J[6], float r, float w) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float wi = w * J[i];
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += wi * J[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += w * J[i] * r;
}

__device__ __forceinline__ void accumulate(float* acc, const Edge& e, const Pose& P,
                                           float delta) {
  const float ypx = P.r00 * e.px + P.r01 * e.py + P.r02 * e.pz;
  const float ypy = P.r10 * e.px + P.r11 * e.py + P.r12 * e.pz;
  const float ypz = P.r20 * e.px + P.r21 * e.py + P.r22 * e.pz;
  const float yx = ypx + P.tx, yy = ypy + P.ty, yz = ypz + P.tz;
  const float ux = yx - e.ax, uy = yy - e.ay, uz = yz - e.az;
  const float vx = yx - e.bx, vy = yy - e.by, vz = yz - e.bz;
  const float rx = (uy * vz - uz * vy) * e.dninv;
  const float ry = (uz * vx - ux * vz) * e.dninv;
  const float rz = (ux * vy - uy * vx) * e.dninv;
  const float rn = sqrtf(rx * rx + ry * ry + rz * rz);
  const float wh = rn <= delta ? 1.0f : delta / fmaxf(rn, 1e-12f);
  const float we = wh * e.w;
  // J_d = M[d] [I | -[y']x]: (M G)[d] = (M1 (-ypz) + M2 ypy, M0 ypz - M2 ypx,
  // -M0 ypy + M1 ypx) for row M[d] = (M0, M1, M2)
  const float J0[6] = {0.0f, e.m01, e.m02, e.m01 * (-ypz) + e.m02 * ypy, e.m02 * (-ypx),
                       e.m01 * ypx};
  const float J1[6] = {e.m10, 0.0f, e.m12, e.m12 * ypy, e.m10 * ypz + e.m12 * (-ypx),
                       e.m10 * (-ypy)};
  const float J2[6] = {e.m20, e.m21, 0.0f, e.m21 * (-ypz), e.m20 * ypz,
                       e.m20 * (-ypy) + e.m21 * ypx};
  add_row(acc, J0, rx, we);
  add_row(acc, J1, ry, we);
  add_row(acc, J2, rz, we);
}

__device__ __forceinline__ void accumulate(float* acc, const Plane& p, const Pose& P,
                                           float delta) {
  const float qpx = P.r00 * p.px + P.r01 * p.py + P.r02 * p.pz;
  const float qpy = P.r10 * p.px + P.r11 * p.py + P.r12 * p.pz;
  const float qpz = P.r20 * p.px + P.r21 * p.py + P.r22 * p.pz;
  const float rp = (qpx + P.tx - p.jx) * p.nx + (qpy + P.ty - p.jy) * p.ny +
                   (qpz + P.tz - p.jz) * p.nz;
  const float arp = fabsf(rp);
  const float whp = arp <= delta ? 1.0f : delta / fmaxf(arp, 1e-12f);
  const float Jp[6] = {p.nx, p.ny, p.nz, qpy * p.nz - qpz * p.ny, qpz * p.nx - qpx * p.nz,
                       qpx * p.ny - qpy * p.nx};
  add_row(acc, Jp, rp, whp * p.w);
}

// c ? a : b on values, as one selp: a select the compiler cannot turn into a
// load from a selected address (which would put the array in local memory)
__device__ __forceinline__ float pick(bool c, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %3, 0;\n\tselp.f32 %0, %1, %2, p;\n\t}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(static_cast<int>(c)));
  return r;
}

// one round of the warp's transposed sum over v[0..2O-1]: a lane keeps half
// of its values and sends its partner (lane ^ O) the other half; O is a
// template constant so that every index is fixed and v stays in registers
template <int O>
__device__ __forceinline__ void transpose_round(float (&v)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = pick(upper, v[k], v[k + O]);
    const float keep = pick(upper, v[k + O], v[k]);
    v[k] = keep + __shfl_xor_sync(kFull, send, O);
  }
  if constexpr (O > 1) transpose_round<O / 2>(v, lane);
}

// the warp's sums of v[0..31]: lane l ends with the sum of v[l] over the
// warp, in 16 + 8 + 4 + 2 + 1 shuffles
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32], int lane) {
  transpose_round<16>(v, lane);
  return v[0];
}

// ---- the exchange between the cluster's blocks: mbarriers and st.async ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address of the same shared variable in the block of cluster rank `rank`
__device__ __forceinline__ unsigned in_block(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// arrive, and expect `bytes` more of st.async data in this phase
__device__ __forceinline__ void bar_arrive_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool bar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2, 1000;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the phase of parity `parity` to complete (each try suspends the
// thread for at most ~1 us); a phase that never completes (a fault) ends the
// kernel with an error within seconds instead of a hang
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  for (unsigned spins = 0; !bar_try_wait(bar, parity);) {
    if (++spins == (1u << 22)) __trap();
  }
}

// store v into the block whose shared-memory address is `addr` (mapped) and
// count its 4 bytes on that block's mbarrier `bar` (mapped)
__device__ __forceinline__ void send(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// x = -H^-1 g by Cholesky, pivots clamped at 1e-12; each pivot's reciprocal
// square root replaces the square root and the divisions by it
__device__ __forceinline__ void chol6_solve(const float H[6][6], const float g[6], float x[6]) {
  float L[6][6], inv[6], y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = H[i][i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * L[i][k];
    inv[i] = rsqrtf(fmaxf(s, 1e-12f));
#pragma unroll
    for (int j = i + 1; j < 6; ++j) {
      float t = H[j][i];
#pragma unroll
      for (int k = 0; k < i; ++k) t -= L[j][k] * L[i][k];
      L[j][i] = t * inv[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {  // L y = -g
    float s = -g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {  // L^T x = y
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

// one GN step from the 27 sums: damp, solve, t += dt, q <- exp(dtheta) q
// (small-angle safe); a step that is not finite leaves the pose as it is
__device__ __forceinline__ void step(Pose& P, const float (&S)[kTerms], float lambda) {
  float H[6][6], g[6], x[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      H[i][j] = S[k];
      H[j][i] = S[k];
      ++k;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    g[i] = S[21 + i];
    H[i][i] = H[i][i] + lambda * fmaxf(H[i][i], 1e-6f);
  }
  chol6_solve(H, g, x);
  const float wx = x[3], wy = x[4], wz = x[5];
  const float th2 = wx * wx + wy * wy + wz * wz;
  const float th = sqrtf(fmaxf(th2, 1e-32f));
  const bool small = th2 < 1e-6f;
  float sn, cs;
  sincosf(0.5f * th, &sn, &cs);
  const float kk = small ? 0.5f - th2 / 48.0f : sn / th;
  const float dw = small ? 1.0f - th2 / 8.0f : cs;
  const float dxq = kk * wx, dyq = kk * wy, dzq = kk * wz;
  const float nqw = dw * P.qw - dxq * P.qx - dyq * P.qy - dzq * P.qz;
  const float nqx = dw * P.qx + dxq * P.qw + dyq * P.qz - dzq * P.qy;
  const float nqy = dw * P.qy - dxq * P.qz + dyq * P.qw + dzq * P.qx;
  const float nqz = dw * P.qz + dxq * P.qy - dyq * P.qx + dzq * P.qw;
  const float norm = rsqrtf(nqw * nqw + nqx * nqx + nqy * nqy + nqz * nqz);
  if (isfinite(x[0] + x[1] + x[2] + th2)) {
    P.qw = nqw * norm;
    P.qx = nqx * norm;
    P.qy = nqy * norm;
    P.qz = nqz * norm;
    P.tx += x[0];
    P.ty += x[1];
    P.tz += x[2];
  }
}

__global__ void __cluster_dims__(kBlocks, 1, 1) __launch_bounds__(kThreads)
gn_kernel(const float* __restrict__ pose_q, const float* __restrict__ pose_t,
          const float* __restrict__ ep, const float* __restrict__ ea,
          const float* __restrict__ eb, const float* __restrict__ ew, int Ne,
          const float* __restrict__ pp, const float* __restrict__ pj,
          const float* __restrict__ pl, const float* __restrict__ pm,
          const float* __restrict__ pw, int Np, int edge_warps, float* __restrict__ pose_out,
          int n_iters, float delta, float lambda) {
  __shared__ float s_part[kWarps][32];
  // slot[buf][b][k]: term k of block b's partial sums, filled by block b
  __shared__ float s_slot[2][kBlocks][32];
  __shared__ __align__(8) unsigned long long s_bar[2];  // one mbarrier per slot
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gw = warp * kBlocks + rank;  // a warp's place in the cluster
  const bool edges = gw < edge_warps;
  const int first = (edges ? gw : gw - edge_warps) * 32 + lane;
  const int stride = (edges ? edge_warps : kBlocks * kWarps - edge_warps) * 32;
  const int n = edges ? Ne : Np;

  Pose P;
  P.qw = pose_q[0], P.qx = pose_q[1], P.qy = pose_q[2], P.qz = pose_q[3];
  P.tx = pose_t[0], P.ty = pose_t[1], P.tz = pose_t[2];

  Edge ekeep[kSlots];
  Plane pkeep[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = first + s * stride;
    if (i < n) {
      if (edges) {
        ekeep[s] = load_edge(ep, ea, eb, ew, Ne, i);
      } else {
        pkeep[s] = load_plane(pp, pj, pl, pm, pw, Np, i);
      }
    }
  }

  if (n_iters > 0) {
    // each phase of a slot's mbarrier: the kTerms local writers arrive, the
    // other blocks' terms arrive as st.async bytes; every block's mbarriers
    // exist before any block sends
    if (tid == 0) {
      bar_init(smem_addr(&s_bar[0]), kTerms);
      bar_init(smem_addr(&s_bar[1]), kTerms);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\tbarrier.cluster.wait.aligned;"
                 ::: "memory");
  }

  for (int it = 0; it < n_iters; ++it) {
    P.rotation();
    float acc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
    if (edges) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (first + s * stride < n) accumulate(acc, ekeep[s], P, delta);
      }
      for (int i = first + kSlots * stride; i < n; i += stride)
        accumulate(acc, load_edge(ep, ea, eb, ew, Ne, i), P, delta);
    } else {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (first + s * stride < n) accumulate(acc, pkeep[s], P, delta);
      }
      for (int i = first + kSlots * stride; i < n; i += stride)
        accumulate(acc, load_plane(pp, pj, pl, pm, pw, Np, i), P, delta);
    }

    // the block's 27 partial sums, warps in order, into slot [buf][rank] of
    // every block of the cluster: here by a store, elsewhere by st.async
    s_part[warp][lane] = warp_transpose_sum(acc, lane);
    __syncthreads();
    const int buf = it & 1;
    const unsigned bar = smem_addr(&s_bar[buf]);
    if (tid < kTerms) {
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += s_part[w][tid];
      s_slot[buf][rank][tid] = v;
      const unsigned dst = smem_addr(&s_slot[buf][rank][tid]);
#pragma unroll
      for (int b = 1; b < kBlocks; ++b) {
        const int d = (rank + b) % kBlocks;
        send(in_block(dst, d), v, in_block(bar, d));
      }
      if (tid == 0) {
        bar_arrive_expect(bar, (kBlocks - 1) * kTerms * sizeof(float));
      } else {
        bar_arrive(bar);
      }
    }
    // a slot is filled again two iterations on, after every block has sent
    // the iteration between, which it does after reading this one
    bar_wait(bar, (it >> 1) & 1);

    // the cluster's sums, blocks in rank order, in every warp
    float tot = 0.0f;
    if (lane < kTerms) {
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) tot += s_slot[buf][b][lane];
    }
    float S[kTerms];
#pragma unroll
    for (int k = 0; k < kTerms; ++k) S[k] = __shfl_sync(kFull, tot, k);
    step(P, S, lambda);
  }
  if (rank == 0 && tid == 0) {
    pose_out[0] = P.qw;
    pose_out[1] = P.qx;
    pose_out[2] = P.qy;
    pose_out[3] = P.qz;
    pose_out[4] = P.tx;
    pose_out[5] = P.ty;
    pose_out[6] = P.tz;
    pose_out[7] = 0.0f;
  }
}

}  // namespace

// pose_q (4,), pose_t (3,); edges ep, ea, eb (3, Ne), ew (1, Ne); planes pp,
// pj, pl, pm (3, Np), pw (1, Np); pose_out (8,) = [q, t, 0]; all float32.
extern "C" int lvo_gn_inner_loop(const void* pose_q, const void* pose_t, const void* ep,
                                 const void* ea, const void* eb, const void* ew, int Ne,
                                 const void* pp, const void* pj, const void* pl,
                                 const void* pm, const void* pw, int Np, void* pose_out,
                                 int n_iters, float huber_delta, float lm_lambda,
                                 void* stream) {
  if (Ne < 0 || Np < 0 || n_iters < 0) return cudaErrorInvalidValue;
  // edge warps in proportion to the work (an edge ~2.5 planes), no more
  // than the edges fill; the rest of the cluster's warps take the planes
  const int total = kBlocks * kWarps;
  int edge_warps = 0;
  if (Ne > 0) {
    edge_warps = Np == 0 ? total
                         : static_cast<int>(lrint(total * 5.0 * Ne / (5.0 * Ne + 2.0 * Np)));
    edge_warps = std::min(std::max(edge_warps, 1),
                          std::min(total - (Np > 0 ? 1 : 0), (Ne + 31) / 32));
  }
  gn_kernel<<<kBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose_q), static_cast<const float*>(pose_t),
      static_cast<const float*>(ep), static_cast<const float*>(ea),
      static_cast<const float*>(eb), static_cast<const float*>(ew), Ne,
      static_cast<const float*>(pp), static_cast<const float*>(pj),
      static_cast<const float*>(pl), static_cast<const float*>(pm),
      static_cast<const float*>(pw), Np, edge_warps, static_cast<float*>(pose_out), n_iters,
      huber_delta, lm_lambda);
  return cudaGetLastError();
}
