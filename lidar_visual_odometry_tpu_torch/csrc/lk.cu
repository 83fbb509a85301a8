// K6: one pyramid level of inverse-compositional KLT for Hopper (sm_90a).
//
// Replaces lidar_visual_odometry_tpu/ops/pallas_lk.py `lk_level` (its default
// batch8 body `_lk_level_kernel_b8`, pallas_lk.py:327). Semantics, per feature:
//   * the template and both gradients come from ONE bilinear (win+2)^2 sample
//     of img0 with origin (x - r - 1, y - r - 1), r = (win - 1) / 2: gradients
//     are 0.5 * (p[., c+1] - p[., c-1]) of the sampled patch;
//   * window origins: xi = floor(xf), fractions taken before the clamp, then
//     xi clamped to [0, W - w - 1] (w = win + 3 for the template, win + 1 for
//     each iteration's sample), yi likewise; rows mix first, then columns;
//   * 2x2 GN (ok = det > 1e-9, inv_det = 0 when not ok), or the 6-DOF solve
//     with affine nuisance columns (jx, jy, jx*ox, jx*oy, jy*ox, jy*oy):
//     21 Gram sums, diagonal * (1 + damp) for i >= 2, + 1e-6, Cholesky with
//     pivots sqrt(max(s, 1e-12));
//   * p <- p - dp while dd2 >= eps^2 (dd2 = dp0^2 + dp1^2, starts at +inf),
//     at most `iters` steps; inactive rows return (guess, ok = 0);
//   * fixed_affine (non-affine solve) adds (fa0*ox + fa1*oy)*jx +
//     (fa2*ox + fa3*oy)*jy to the residual; with affine the fitted
//     parameters are returned, zero where not ok.
//
// Bound on the H100: latency. Each feature is a chain of up to `iters`
// dependent sample -> reduce -> solve steps; bytes (two images, <= 1 MB) and
// operations (~30 MFLOP for the bench's affine level-0 call, ~6 for each
// coarse 2x2 level: under a microsecond at the card's rates) are far below.
// 768 features are 768 warps, all resident at once on the 132 SMs, so a
// call takes about as long as its slowest feature's chain.
//
// Design: one warp per feature, 4 features per block. Lane l owns elements
// l, l + 32, ... of the win^2 window. What shortens each step of the chain:
//   * the kernel is instantiated for the windows the package uses (9, 13,
//     25; other windows run the runtime-`win` instance of the same code), so
//     a lane's ceil(win^2 / 32) elements are unrolled and an iteration's
//     4 * ceil(win^2 / 32) image loads (read-only path, L1/L2 hits) are
//     in flight together instead of one element after another;
//   * up to kRegElems elements a lane (win <= 15), the template, both
//     gradients and the four affine columns (or the fixed_affine terms) stay
//     in registers for all iterations; at win 25 (20 elements a lane) the
//     template and gradients stay in the warp's slice of shared memory;
//   * the independent warp sums of a step (2, 3, 6 or 21 values) go through
//     the __shfl_xor_sync butterfly together, one shuffle round for all of
//     them, then the next.
// The sampled patch sits in shared memory (a lane's gradients read its
// neighbours' samples). Each lane sums its elements in order, then the
// butterfly (16, 8, 4, 2, 1): every lane holds the same sums, solves the same
// system and leaves the loop with the others (no broadcast, no barrier).
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn, ...;
// __fdiv_rn, __fsqrt_rn): no contraction into FMAs, so the plain PyTorch
// version (kernels/lk.py, lk_level_plain), which sums in the same lane order,
// agrees bit for bit. The level images need no padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;      // features per block
constexpr int kRegElems = 8;   // elements a lane keeps in registers (win <= 15)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// max that propagates NaN like jnp.maximum / torch.clamp
__device__ __forceinline__ float max_nan(float a, float b) { return isnan(a) ? a : fmaxf(a, b); }

// M warp sums at once: one butterfly round for all M values, then the next.
// Each value sees the same additions in the same order as alone.
template <int M>
__device__ __forceinline__ void warp_sums(float (&v)[M]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float o[M];
#pragma unroll
    for (int m = 0; m < M; ++m) o[m] = __shfl_xor_sync(kFull, v[m], off);
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] = add(v[m], o[m]);
  }
}

struct Corner {
  const float* base;  // the window origin in the level
  float fx, fy, omx, omy;
};

// integer origin clamped so that a (w + 1)-wide read stays inside the level;
// fractions of the unclamped position
__device__ __forceinline__ Corner corner(const float* img, float xf, float yf, int w, int H,
                                         int W) {
  const float flx = floorf(xf), fly = floorf(yf);
  Corner c;
  c.fx = sub(xf, flx);
  c.fy = sub(yf, fly);
  c.omx = sub(1.0f, c.fx);
  c.omy = sub(1.0f, c.fy);
  const int xi = min(max(static_cast<int>(flx), 0), W - w - 1);
  const int yi = min(max(static_cast<int>(fly), 0), H - w - 1);
  c.base = img + static_cast<long long>(yi) * W + xi;
  return c;
}

// bilinear sample at patch element (a, b): rows mix first, then columns
__device__ __forceinline__ float bilin(int W, const Corner& c, int a, int b) {
  const float* r0 = c.base + a * W + b;
  const float* r1 = r0 + W;
  const float v0 = add(mul(__ldg(r0), c.omy), mul(__ldg(r1), c.fy));
  const float v1 = add(mul(__ldg(r0 + 1), c.omy), mul(__ldg(r1 + 1), c.fy));
  return add(mul(v0, c.omx), mul(v1, c.fx));
}

// A lane's value of each element it owns: in registers (REG, indices fixed by
// unrolling), or in the warp's shared-memory slice, element k at s[32 * k].
template <int KR, bool REG>
struct LaneVals {
  float r[KR];
  float* s;
  __device__ __forceinline__ float& operator[](int k) {
    if constexpr (REG) {
      return r[k];
    } else {
      return s[32 * k];
    }
  }
};

template <int WIN>
__host__ __device__ constexpr int lane_elems() { return (WIN * WIN + 31) / 32; }
template <int WIN>
__host__ __device__ constexpr bool in_registers() {
  return WIN > 0 && lane_elems<WIN>() <= kRegElems;
}

// floats of shared memory a warp uses: the sampled patch, then (unless in
// registers) the template and both gradients, 32 * ceil(win^2 / 32) each
template <int WIN>
__host__ __device__ int warp_floats(int win) {
  const int k = (win * win + 31) / 32;
  return (win + 2) * (win + 2) + (in_registers<WIN>() ? 0 : 3 * 32 * k);
}

template <int WIN>
__global__ void __launch_bounds__(kWarps * 32)
lk_level_kernel(const float* __restrict__ img0, const float* __restrict__ img1, int H, int W,
                const float* __restrict__ uv0, const float* __restrict__ guess,
                const uint8_t* __restrict__ active, const float* __restrict__ fixed_aff, int N,
                int win_rt, int iters, float eps2, int affine, float damp, float* __restrict__ out) {
  constexpr bool kReg = in_registers<WIN>();
  constexpr int KR = kReg ? lane_elems<WIN>() : 1;
  extern __shared__ float smem[];
  const int win = WIN > 0 ? WIN : win_rt;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarps + warp;
  if (f >= N) return;  // the whole warp leaves together
  const int w2 = win + 2;
  const int np = w2 * w2;
  const int ne = win * win;
  const int K = WIN > 0 ? lane_elems<WIN>() : (ne + 31) / 32;   // elements a lane owns
  const int KP = (np + 31) / 32;                                 // patch samples a lane takes
  float* P = smem + warp * warp_floats<WIN>(win);
  float* o = out + 8LL * f;
  const float g0 = guess[2 * f], g1 = guess[2 * f + 1];

  if (!active[f]) {
    if (lane == 0) {
      o[0] = g0;
      o[1] = g1;
#pragma unroll
      for (int k = 2; k < 8; ++k) o[k] = 0.0f;
    }
    return;
  }

  const float r = 0.5f * static_cast<float>(win - 1);
  const float tx = sub(uv0[2 * f], r);
  const float ty = sub(uv0[2 * f + 1], r);

  // ---- template + gradients from one (win+2)^2 sample ----
  {
    const Corner c = corner(img0, sub(tx, 1.0f), sub(ty, 1.0f), win + 3, H, W);
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int e = lane + 32 * k;
      if (e < np) P[e] = bilin(W, c, e / w2, e % w2);
    }
  }
  __syncwarp();
  LaneVals<KR, kReg> T, JX, JY;
  T.s = P + np + lane;
  JX.s = T.s + 32 * K;
  JY.s = JX.s + 32 * K;
  float s3[3] = {0.0f, 0.0f, 0.0f};  // s11, s12, s22
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = lane + 32 * k;
    float jx = 0.0f, jy = 0.0f, t = 0.0f;
    if (e < ne) {
      const int i = e / win, j = e % win;
      const float* p = P + (i + 1) * w2 + (j + 1);
      t = p[0];
      jx = mul(0.5f, sub(p[1], p[-1]));
      jy = mul(0.5f, sub(p[w2], p[-w2]));
      s3[0] = add(s3[0], mul(jx, jx));
      s3[1] = add(s3[1], mul(jx, jy));
      s3[2] = add(s3[2], mul(jy, jy));
    }
    T[k] = t;
    JX[k] = jx;
    JY[k] = jy;
  }
  // in shared memory each lane reads back only the elements it wrote
  warp_sums(s3);
  const float a11 = s3[0], a12 = s3[1], a22 = s3[2];
  const float det = sub(mul(a11, a22), mul(a12, a12));
  const bool ok = det > 1e-9f;

  float p[6] = {g0, g1, 0.0f, 0.0f, 0.0f, 0.0f};
  float dd2 = __int_as_float(0x7f800000);  // +inf
  int it = 0;
  // per element, four terms fixed for all iterations: the affine columns
  // jx*ox, jx*oy, jy*ox, jy*oy, or the two fixed_affine residual terms
  float xa[KR][4];

  if (!affine) {
    const float inv_det = ok ? dvd(1.0f, max_nan(det, 1e-12f)) : 0.0f;
    const bool fixed = fixed_aff != nullptr;
    float fa[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (fixed) {
#pragma unroll
      for (int k = 0; k < 4; ++k) fa[k] = fixed_aff[4 * f + k];
    }
    // the fixed deformation's residual terms of element k (i, j)
    auto fixed_terms = [&](int k, int i, int j, float& ca, float& cb) {
      const float ox = sub(static_cast<float>(j), r), oy = sub(static_cast<float>(i), r);
      ca = mul(add(mul(fa[0], ox), mul(fa[1], oy)), JX[k]);
      cb = mul(add(mul(fa[2], ox), mul(fa[3], oy)), JY[k]);
    };
    if constexpr (kReg) {
      if (fixed) {
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          const int e = lane + 32 * k;
          fixed_terms(k, e / win, e % win, xa[k][0], xa[k][1]);
        }
      }
    }
    for (; it < iters; ++it) {
      if (!(dd2 >= eps2)) break;
      const Corner c = corner(img1, add(tx, p[0]), add(ty, p[1]), win + 1, H, W);
      float b[2] = {0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = lane + 32 * k;
        if (e < ne) {
          const int i = e / win, j = e % win;
          float err = sub(bilin(W, c, i, j), T[k]);
          if (fixed) {
            float ca, cb;
            if constexpr (kReg) {
              ca = xa[k][0];
              cb = xa[k][1];
            } else {
              fixed_terms(k, i, j, ca, cb);
            }
            err = add(add(err, ca), cb);
          }
          b[0] = add(b[0], mul(err, JX[k]));
          b[1] = add(b[1], mul(err, JY[k]));
        }
      }
      warp_sums(b);
      const float ddx = mul(inv_det, sub(mul(a22, b[0]), mul(a12, b[1])));
      const float ddy = mul(inv_det, sub(mul(a11, b[1]), mul(a12, b[0])));
      p[0] = sub(p[0], ddx);
      p[1] = sub(p[1], ddy);
      dd2 = add(mul(ddx, ddx), mul(ddy, ddy));
    }
  } else {
    // the six columns of element k (i, j)
    auto columns = [&](int k, int i, int j, float (&col)[6]) {
      const float jx = JX[k], jy = JY[k];
      const float ox = sub(static_cast<float>(j), r), oy = sub(static_cast<float>(i), r);
      col[0] = jx;
      col[1] = jy;
      if constexpr (kReg) {
        col[2] = xa[k][0];
        col[3] = xa[k][1];
        col[4] = xa[k][2];
        col[5] = xa[k][3];
      } else {
        col[2] = mul(jx, ox);
        col[3] = mul(jx, oy);
        col[4] = mul(jy, ox);
        col[5] = mul(jy, oy);
      }
    };
    // 21 Gram sums of the six columns, lower triangle row by row
    float g[21];
#pragma unroll
    for (int k = 0; k < 21; ++k) g[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = lane + 32 * k;
      if constexpr (kReg) {
        const float ox = sub(static_cast<float>(e % win), r);
        const float oy = sub(static_cast<float>(e / win), r);
        xa[k][0] = mul(JX[k], ox);
        xa[k][1] = mul(JX[k], oy);
        xa[k][2] = mul(JY[k], ox);
        xa[k][3] = mul(JY[k], oy);
      }
      if (e < ne) {
        float col[6];
        columns(k, e / win, e % win, col);
        int m = 0;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b = 0; b <= a; ++b) g[m] = add(g[m], mul(col[a], col[b])), ++m;
        }
      }
    }
    warp_sums(g);
    float L[6][6];
    {
      int m = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = 0; b <= a; ++b) {
          float v = g[m++];
          if (a == b) {
            if (a >= 2) v = mul(v, damp);
            v = add(v, 1e-6f);
          }
          L[a][b] = v;  // H, factored in place below
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        float s = L[a][b];
#pragma unroll
        for (int k = 0; k < b; ++k) s = sub(s, mul(L[a][k], L[b][k]));
        L[a][b] = (a == b) ? __fsqrt_rn(max_nan(s, 1e-12f)) : dvd(s, L[b][b]);
      }
    }
    for (; it < iters; ++it) {
      if (!(dd2 >= eps2)) break;
      const Corner c = corner(img1, add(tx, p[0]), add(ty, p[1]), win + 1, H, W);
      float bv[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = lane + 32 * k;
        if (e < ne) {
          const int i = e / win, j = e % win;
          const float ox = sub(static_cast<float>(j), r), oy = sub(static_cast<float>(i), r);
          float col[6];
          columns(k, i, j, col);
          float err = sub(bilin(W, c, i, j), T[k]);
          err = add(add(err, mul(add(mul(p[2], ox), mul(p[3], oy)), col[0])),
                    mul(add(mul(p[4], ox), mul(p[5], oy)), col[1]));
#pragma unroll
          for (int q = 0; q < 6; ++q) bv[q] = add(bv[q], mul(err, col[q]));
        }
      }
      warp_sums(bv);
      float y[6], x[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        float s = bv[a];
#pragma unroll
        for (int k = 0; k < a; ++k) s = sub(s, mul(L[a][k], y[k]));
        y[a] = dvd(s, L[a][a]);
      }
#pragma unroll
      for (int a = 5; a >= 0; --a) {
        float s = y[a];
#pragma unroll
        for (int k = a + 1; k < 6; ++k) s = sub(s, mul(L[k][a], x[k]));
        x[a] = dvd(s, L[a][a]);
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) p[k] = sub(p[k], x[k]);
      dd2 = add(mul(x[0], x[0]), mul(x[1], x[1]));
    }
  }

  if (lane == 0) {
    const bool keep = !affine || ok;
    o[0] = keep ? p[0] : g0;
    o[1] = keep ? p[1] : g1;
    o[2] = ok ? 1.0f : 0.0f;
    o[3] = static_cast<float>(it);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[4 + k] = (affine && ok) ? p[2 + k] : 0.0f;
  }
}

template <int WIN>
cudaError_t launch(const float* img0, const float* img1, int H, int W, const float* uv0,
                   const float* guess, const uint8_t* active, const float* fixed_aff, int N,
                   int win, int iters, float eps2, int affine, float damp, float* out,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * static_cast<size_t>(warp_floats<WIN>(win));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lk_level_kernel<WIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  lk_level_kernel<WIN><<<blocks, kWarps * 32, smem, stream>>>(
      img0, img1, H, W, uv0, guess, active, fixed_aff, N, win, iters, eps2, affine, damp, out);
  return cudaGetLastError();
}

}  // namespace

// img0, img1 (H, W) f32; uv0, guess (N, 2) f32; active (N,) bool; fixed_aff
// (N, 4) f32 or null; out (N, 8) f32 = [dx, dy, ok, iterations, a0..a3].
extern "C" int lvo_lk_level(const void* img0, const void* img1, int H, int W, const void* uv0,
                            const void* guess, const void* active, const void* fixed_aff, int N,
                            int win, int iters, float eps2, int affine, float damp, void* out,
                            void* stream) {
  if (N <= 0) return cudaSuccess;
  if (win < 1 || H - win - 4 < 0 || W - win - 4 < 0 || iters < 0) return cudaErrorInvalidValue;
  auto* run = &launch<0>;
  switch (win) {
    case 9: run = &launch<9>; break;
    case 13: run = &launch<13>; break;
    case 25: run = &launch<25>; break;
    default: break;
  }
  return run(static_cast<const float*>(img0), static_cast<const float*>(img1), H, W,
             static_cast<const float*>(uv0), static_cast<const float*>(guess),
             static_cast<const uint8_t*>(active), static_cast<const float*>(fixed_aff), N, win,
             iters, eps2, affine, damp, static_cast<float*>(out),
             static_cast<cudaStream_t>(stream));
}
