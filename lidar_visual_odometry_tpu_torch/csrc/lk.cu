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
// Design: one warp per feature, 4 features per block. The sampled patch,
// the template and its gradients sit in shared memory (warp-private slices);
// each iteration's win^2 samples of img1 come from global memory (a level is
// at most 480 KB and stays in L2). Lane l owns elements l, l + 32, ...; sums
// reduce with __shfl_xor_sync, so every lane holds the same sums, solves the
// same system and leaves the loop with the others (no broadcast, no block
// barrier). Every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, ...): no contraction into FMAs, so the plain PyTorch version
// (kernels/lk.py, lk_level_plain), which sums in the same lane order, agrees
// bit for bit. The level images need no padding.
//
// Bound on the H100: latency. Each feature is a chain of up to `iters`
// dependent sample -> reduce -> solve steps; bytes (two images, <= 1 MB) and
// operations (~30 MFLOP for the bench's affine level-0 call, ~6 for each
// coarse 2x2 level: under a microsecond at the card's rates) are far below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // features per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// max that propagates NaN like jnp.maximum / torch.clamp
__device__ __forceinline__ float max_nan(float a, float b) { return isnan(a) ? a : fmaxf(a, b); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = add(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

struct Corner {
  int xi, yi;
  float fx, fy, omx, omy;
};

// integer origin clamped so that a (w + 1)-wide read stays inside the level;
// fractions of the unclamped position
__device__ __forceinline__ Corner corner(float xf, float yf, int w, int H, int W) {
  const float flx = floorf(xf), fly = floorf(yf);
  Corner c;
  c.fx = sub(xf, flx);
  c.fy = sub(yf, fly);
  c.omx = sub(1.0f, c.fx);
  c.omy = sub(1.0f, c.fy);
  c.xi = min(max(static_cast<int>(flx), 0), W - w - 1);
  c.yi = min(max(static_cast<int>(fly), 0), H - w - 1);
  return c;
}

// bilinear sample at patch element (a, b): rows mix first, then columns
__device__ __forceinline__ float bilin(const float* __restrict__ img, int W, const Corner& c,
                                       int a, int b) {
  const float* r0 = img + static_cast<long long>(c.yi + a) * W + (c.xi + b);
  const float* r1 = r0 + W;
  const float v0 = add(mul(__ldg(r0), c.omy), mul(__ldg(r1), c.fy));
  const float v1 = add(mul(__ldg(r0 + 1), c.omy), mul(__ldg(r1 + 1), c.fy));
  return add(mul(v0, c.omx), mul(v1, c.fx));
}

__global__ void __launch_bounds__(kWarps * 32)
lk_level_kernel(const float* __restrict__ img0, const float* __restrict__ img1, int H, int W,
                const float* __restrict__ uv0, const float* __restrict__ guess,
                const uint8_t* __restrict__ active, const float* __restrict__ fixed_aff, int N,
                int win, int iters, float eps2, int affine, float damp, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarps + warp;
  if (f >= N) return;  // the whole warp leaves together
  const int w2 = win + 2;
  const int np = w2 * w2;
  const int ne = win * win;
  float* P = smem + warp * (np + 3 * ne);
  float* T = P + np;
  float* JX = T + ne;
  float* JY = JX + ne;
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
    const Corner c = corner(sub(tx, 1.0f), sub(ty, 1.0f), win + 3, H, W);
    for (int e = lane; e < np; e += 32) P[e] = bilin(img0, W, c, e / w2, e % w2);
  }
  __syncwarp();
  for (int e = lane; e < ne; e += 32) {
    const int i = e / win, j = e % win;
    const float* p = P + (i + 1) * w2 + (j + 1);
    T[e] = p[0];
    JX[e] = mul(0.5f, sub(p[1], p[-1]));
    JY[e] = mul(0.5f, sub(p[w2], p[-w2]));
  }
  // each lane reads back only the elements it wrote: no barrier needed

  float s11 = 0.0f, s12 = 0.0f, s22 = 0.0f;
  for (int e = lane; e < ne; e += 32) {
    const float jx = JX[e], jy = JY[e];
    s11 = add(s11, mul(jx, jx));
    s12 = add(s12, mul(jx, jy));
    s22 = add(s22, mul(jy, jy));
  }
  const float a11 = warp_sum(s11), a12 = warp_sum(s12), a22 = warp_sum(s22);
  const float det = sub(mul(a11, a22), mul(a12, a12));
  const bool ok = det > 1e-9f;

  float p[6] = {g0, g1, 0.0f, 0.0f, 0.0f, 0.0f};
  float dd2 = __int_as_float(0x7f800000);  // +inf
  int it = 0;

  if (!affine) {
    const float inv_det = ok ? dvd(1.0f, max_nan(det, 1e-12f)) : 0.0f;
    const bool fixed = fixed_aff != nullptr;
    float fa[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (fixed) {
#pragma unroll
      for (int k = 0; k < 4; ++k) fa[k] = fixed_aff[4 * f + k];
    }
    for (; it < iters; ++it) {
      if (!(dd2 >= eps2)) break;
      const Corner c = corner(add(tx, p[0]), add(ty, p[1]), win + 1, H, W);
      float b1 = 0.0f, b2 = 0.0f;
      for (int e = lane; e < ne; e += 32) {
        const int i = e / win, j = e % win;
        const float jx = JX[e], jy = JY[e];
        float err = sub(bilin(img1, W, c, i, j), T[e]);
        if (fixed) {
          const float ox = sub(static_cast<float>(j), r), oy = sub(static_cast<float>(i), r);
          err = add(add(err, mul(add(mul(fa[0], ox), mul(fa[1], oy)), jx)),
                    mul(add(mul(fa[2], ox), mul(fa[3], oy)), jy));
        }
        b1 = add(b1, mul(err, jx));
        b2 = add(b2, mul(err, jy));
      }
      b1 = warp_sum(b1);
      b2 = warp_sum(b2);
      const float ddx = mul(inv_det, sub(mul(a22, b1), mul(a12, b2)));
      const float ddy = mul(inv_det, sub(mul(a11, b2), mul(a12, b1)));
      p[0] = sub(p[0], ddx);
      p[1] = sub(p[1], ddy);
      dd2 = add(mul(ddx, ddx), mul(ddy, ddy));
    }
  } else {
    // 21 Gram sums of the six columns, lower triangle row by row
    float g[21];
#pragma unroll
    for (int k = 0; k < 21; ++k) g[k] = 0.0f;
    for (int e = lane; e < ne; e += 32) {
      const int i = e / win, j = e % win;
      const float jx = JX[e], jy = JY[e];
      const float ox = sub(static_cast<float>(j), r), oy = sub(static_cast<float>(i), r);
      const float col[6] = {jx, jy, mul(jx, ox), mul(jx, oy), mul(jy, ox), mul(jy, oy)};
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = 0; b <= a; ++b) g[k] = add(g[k], mul(col[a], col[b])), ++k;
      }
    }
    float L[6][6];
    {
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = 0; b <= a; ++b) {
          float v = warp_sum(g[k++]);
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
      const Corner c = corner(add(tx, p[0]), add(ty, p[1]), win + 1, H, W);
      float bv[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int e = lane; e < ne; e += 32) {
        const int i = e / win, j = e % win;
        const float jx = JX[e], jy = JY[e];
        const float ox = sub(static_cast<float>(j), r), oy = sub(static_cast<float>(i), r);
        float err = sub(bilin(img1, W, c, i, j), T[e]);
        err = add(add(err, mul(add(mul(p[2], ox), mul(p[3], oy)), jx)),
                  mul(add(mul(p[4], ox), mul(p[5], oy)), jy));
        const float col[6] = {jx, jy, mul(jx, ox), mul(jx, oy), mul(jy, ox), mul(jy, oy)};
#pragma unroll
        for (int k = 0; k < 6; ++k) bv[k] = add(bv[k], mul(err, col[k]));
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) bv[k] = warp_sum(bv[k]);
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

}  // namespace

// img0, img1 (H, W) f32; uv0, guess (N, 2) f32; active (N,) bool; fixed_aff
// (N, 4) f32 or null; out (N, 8) f32 = [dx, dy, ok, iterations, a0..a3].
extern "C" int lvo_lk_level(const void* img0, const void* img1, int H, int W, const void* uv0,
                            const void* guess, const void* active, const void* fixed_aff, int N,
                            int win, int iters, float eps2, int affine, float damp, void* out,
                            void* stream) {
  if (N <= 0) return cudaSuccess;
  if (win < 1 || H - win - 4 < 0 || W - win - 4 < 0 || iters < 0) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * kWarps * static_cast<size_t>((win + 2) * (win + 2) + 3 * win * win);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lk_level_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  lk_level_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img0), static_cast<const float*>(img1), H, W,
      static_cast<const float*>(uv0), static_cast<const float*>(guess),
      static_cast<const uint8_t*>(active), static_cast<const float*>(fixed_aff), N, win, iters,
      eps2, affine, damp, static_cast<float*>(out));
  return cudaGetLastError();
}
