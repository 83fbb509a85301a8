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
// pose (8,), edges (3, 768) x 3 plus weights (1, 768), planes (3, 1536) x 4
// plus weights (1, 1536), float32, one launch per re-association round.
//
// What bounds it on an H100: latency. About 2.3k correspondences times a few
// hundred operations per iteration is microseconds of work for one SM and far
// less for the card; the serial 6x6 solve between iterations and the block-wide
// barriers set the time. The pose never leaves the card between iterations or
// between rounds.
//
// Design: one block of kThreads threads. Threads stride over the
// correspondences and accumulate the 21 upper-triangle terms of H and the 6 of
// g in registers; warp shuffles and one shared-memory pass reduce them; thread
// 0 runs the Cholesky solve and the pose update and broadcasts the pose through
// shared memory. Sums are taken in another order than the TPU kernel's lane
// reductions and nvcc may contract products into fused multiply-adds, so the
// pose agrees with the plain PyTorch version to float32 rounding, not bit for
// bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = 27;  // 21 upper-triangle H terms, then 6 g terms

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

__device__ void chol6_solve(const float H[6][6], const float g[6], float x[6]) {
  float L[6][6] = {};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = H[i][i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * L[i][k];
    L[i][i] = sqrtf(fmaxf(s, 1e-12f));
    const float inv = 1.0f / L[i][i];
    for (int j = i + 1; j < 6; ++j) {
      float t = H[j][i];
      for (int k = 0; k < i; ++k) t -= L[j][k] * L[i][k];
      L[j][i] = t * inv;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {  // L y = -g
    float s = -g[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {  // L^T x = y
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

__global__ void __launch_bounds__(kThreads)
gn_kernel(const float* __restrict__ pose_in, const float* __restrict__ ep,
          const float* __restrict__ ea, const float* __restrict__ eb,
          const float* __restrict__ ew, int Ne, const float* __restrict__ pp,
          const float* __restrict__ pj, const float* __restrict__ pl,
          const float* __restrict__ pm, const float* __restrict__ pw, int Np,
          float* __restrict__ pose_out, int n_iters, float delta, float lambda) {
  __shared__ float s_pose[7];
  __shared__ float s_part[kWarps][kTerms];
  __shared__ float s_sum[kTerms];
  const int tid = threadIdx.x;
  if (tid < 7) s_pose[tid] = pose_in[tid];
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    const float qw = s_pose[0], qx = s_pose[1], qy = s_pose[2], qz = s_pose[3];
    const float tx = s_pose[4], ty = s_pose[5], tz = s_pose[6];
    const float r00 = 1 - 2 * (qy * qy + qz * qz), r01 = 2 * (qx * qy - qw * qz),
                r02 = 2 * (qx * qz + qw * qy);
    const float r10 = 2 * (qx * qy + qw * qz), r11 = 1 - 2 * (qx * qx + qz * qz),
                r12 = 2 * (qy * qz - qw * qx);
    const float r20 = 2 * (qx * qz - qw * qy), r21 = 2 * (qy * qz + qw * qx),
                r22 = 1 - 2 * (qx * qx + qy * qy);

    float acc[kTerms];
#pragma unroll
    for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;

    for (int i = tid; i < Ne; i += kThreads) {
      const float px = ep[i], py = ep[Ne + i], pz = ep[2 * Ne + i];
      const float ax = ea[i], ay = ea[Ne + i], az = ea[2 * Ne + i];
      const float bx = eb[i], by = eb[Ne + i], bz = eb[2 * Ne + i];
      const float dx = ax - bx, dy = ay - by, dz = az - bz;
      const float dninv = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-18f));
      const float m01 = dz * dninv, m02 = -dy * dninv;
      const float m10 = -dz * dninv, m12 = dx * dninv;
      const float m20 = dy * dninv, m21 = -dx * dninv;
      const float ypx = r00 * px + r01 * py + r02 * pz;
      const float ypy = r10 * px + r11 * py + r12 * pz;
      const float ypz = r20 * px + r21 * py + r22 * pz;
      const float yx = ypx + tx, yy = ypy + ty, yz = ypz + tz;
      const float ux = yx - ax, uy = yy - ay, uz = yz - az;
      const float vx = yx - bx, vy = yy - by, vz = yz - bz;
      const float rx = (uy * vz - uz * vy) * dninv;
      const float ry = (uz * vx - ux * vz) * dninv;
      const float rz = (ux * vy - uy * vx) * dninv;
      const float rn = sqrtf(rx * rx + ry * ry + rz * rz);
      const float wh = rn <= delta ? 1.0f : delta / fmaxf(rn, 1e-12f);
      const float we = wh * ew[i];
      // J_d = M[d] [I | -[y']x]: (M G)[d] = (M1 (-ypz) + M2 ypy, M0 ypz - M2 ypx,
      // -M0 ypy + M1 ypx) for row M[d] = (M0, M1, M2)
      const float J0[6] = {0.0f, m01, m02, m01 * (-ypz) + m02 * ypy, m02 * (-ypx),
                           m01 * ypx};
      const float J1[6] = {m10, 0.0f, m12, m12 * ypy, m10 * ypz + m12 * (-ypx),
                           m10 * (-ypy)};
      const float J2[6] = {m20, m21, 0.0f, m21 * (-ypz), m20 * ypz,
                           m20 * (-ypy) + m21 * ypx};
      add_row(acc, J0, rx, we);
      add_row(acc, J1, ry, we);
      add_row(acc, J2, rz, we);
    }

    for (int i = tid; i < Np; i += kThreads) {
      const float px = pp[i], py = pp[Np + i], pz = pp[2 * Np + i];
      const float jx = pj[i], jy = pj[Np + i], jz = pj[2 * Np + i];
      const float v1x = jx - pl[i], v1y = jy - pl[Np + i], v1z = jz - pl[2 * Np + i];
      const float v2x = jx - pm[i], v2y = jy - pm[Np + i], v2z = jz - pm[2 * Np + i];
      float nx = v1y * v2z - v1z * v2y;
      float ny = v1z * v2x - v1x * v2z;
      float nz = v1x * v2y - v1y * v2x;
      const float ninv = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-18f));
      nx *= ninv;
      ny *= ninv;
      nz *= ninv;
      const float qpx = r00 * px + r01 * py + r02 * pz;
      const float qpy = r10 * px + r11 * py + r12 * pz;
      const float qpz = r20 * px + r21 * py + r22 * pz;
      const float rp = (qpx + tx - jx) * nx + (qpy + ty - jy) * ny + (qpz + tz - jz) * nz;
      const float arp = fabsf(rp);
      const float whp = arp <= delta ? 1.0f : delta / fmaxf(arp, 1e-12f);
      const float wp = whp * pw[i];
      const float Jp[6] = {nx, ny, nz, qpy * nz - qpz * ny, qpz * nx - qpx * nz,
                           qpx * ny - qpy * nx};
      add_row(acc, Jp, rp, wp);
    }

    // block reduction of the 27 sums
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      float v = acc[k];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) s_part[warp][k] = v;
    }
    __syncthreads();
    if (tid < kTerms) {
      float v = 0.0f;
      for (int w = 0; w < kWarps; ++w) v += s_part[w][tid];
      s_sum[tid] = v;
    }
    __syncthreads();

    if (tid == 0) {
      float H[6][6], g[6], x[6];
      int k = 0;
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j) {
          H[i][j] = s_sum[k];
          H[j][i] = s_sum[k];
          ++k;
        }
      for (int i = 0; i < 6; ++i) {
        g[i] = s_sum[21 + i];
        H[i][i] = H[i][i] + lambda * fmaxf(H[i][i], 1e-6f);
      }
      chol6_solve(H, g, x);

      // t += dt; q <- exp(dtheta) q, small-angle safe
      const float wx = x[3], wy = x[4], wz = x[5];
      const float th2 = wx * wx + wy * wy + wz * wz;
      const float th = sqrtf(fmaxf(th2, 1e-32f));
      const bool small = th2 < 1e-6f;
      const float kk = small ? 0.5f - th2 / 48.0f : sinf(0.5f * th) / th;
      const float cw = small ? 1.0f - th2 / 8.0f : cosf(0.5f * th);
      const float dw = cw, dxq = kk * wx, dyq = kk * wy, dzq = kk * wz;
      const float nqw = dw * qw - dxq * qx - dyq * qy - dzq * qz;
      const float nqx = dw * qx + dxq * qw + dyq * qz - dzq * qy;
      const float nqy = dw * qy - dxq * qz + dyq * qw + dzq * qx;
      const float nqz = dw * qz + dxq * qy - dyq * qx + dzq * qw;
      const float norm = rsqrtf(nqw * nqw + nqx * nqx + nqy * nqy + nqz * nqz);
      if (isfinite(x[0] + x[1] + x[2] + th2)) {
        s_pose[0] = nqw * norm;
        s_pose[1] = nqx * norm;
        s_pose[2] = nqy * norm;
        s_pose[3] = nqz * norm;
        s_pose[4] = tx + x[0];
        s_pose[5] = ty + x[1];
        s_pose[6] = tz + x[2];
      }
    }
    __syncthreads();
  }
  if (tid < 8) pose_out[tid] = tid < 7 ? s_pose[tid] : 0.0f;
}

}  // namespace

extern "C" int lvo_gn_inner_loop(const void* pose_in, const void* ep, const void* ea,
                                 const void* eb, const void* ew, int Ne, const void* pp,
                                 const void* pj, const void* pl, const void* pm,
                                 const void* pw, int Np, void* pose_out, int n_iters,
                                 float huber_delta, float lm_lambda, void* stream) {
  if (Ne < 0 || Np < 0 || n_iters < 0) return cudaErrorInvalidValue;
  gn_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose_in), static_cast<const float*>(ep),
      static_cast<const float*>(ea), static_cast<const float*>(eb),
      static_cast<const float*>(ew), Ne, static_cast<const float*>(pp),
      static_cast<const float*>(pj), static_cast<const float*>(pl),
      static_cast<const float*>(pm), static_cast<const float*>(pw), Np,
      static_cast<float*>(pose_out), n_iters, huber_delta, lm_lambda);
  return cudaGetLastError();
}
