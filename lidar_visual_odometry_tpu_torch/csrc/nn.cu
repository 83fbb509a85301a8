// Ring-structured scan-to-scan association: for each query, the two nearest
// candidates of every ring, then the cross-ring selection that the edge and
// plane factors need.
//
// Replaces the Pallas TPU kernel lidar_visual_odometry_tpu/ops/pallas_nn.py
// (associate_kernel / _assoc_kernel). Inputs: queries q (Q, 3) and ring-blocked
// candidates c (R, B, 3) whose masked points were moved to BAKE_FAR by the
// caller. Output (Q, 16) float32 rows:
//   [0:3 c1r0 | 3:6 c2r0 | 6:9 c1rw | 9 d0 | 10 d2same | 11 dw | 12:16 zero]
// where r0 is the ring holding the nearest candidate overall, c1r0/c2r0 its
// nearest and runner-up, and rw the ring with the nearest candidate among the
// rings 0 < |r - r0| <= nearby_scan (c1rw is zero when no ring is in that
// window). On the main path: edges Q = 768 against (64, 120, 3), planes
// Q = 1536 against (64, 512, 3), two calls per re-association round.
//
// What bounds it on an H100: float32 arithmetic. The planes call evaluates
// 1536 x 64 x 512 ~ 5e7 squared distances of 8 operations each; it moves well
// under 1 MB.
//
// Design: two launches. The first spreads the (query, ring) pairs over the
// card: a block is 32 queries x 8 rings, one thread per pair, and each thread
// streams its ring's B candidates from global memory (all 32 lanes of a warp
// read the same candidate, so each load is one broadcast transaction served
// from L1/L2) while keeping (d1, i1, d2, i2) in registers. The results go to a
// (4, R, Q) scratch array. The second launch is one thread per query: it walks
// the R rings to pick r0 and rw and fetches the winners' coordinates by index
// from c, in place of the TPU kernel's one-hot reductions.
//
// Exact rules kept from the TPU kernel: the distance is (c - q) squared per
// component, summed as (dx^2 + dy^2) + dz^2 with round-to-nearest intrinsics so
// that nvcc cannot contract it into fused multiply-adds; ties go to the first
// index within a ring and to the first ring across rings (ascending scans with
// a strict <). The streamed runner-up equals the TPU kernel's second arg-min
// over the ring with the winner set to 1e30 whenever every distance is below
// 1e30, which baking guarantees for finite queries.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQueriesPerBlock = 32;
constexpr int kRingsPerBlock = 8;
constexpr float kBig = 1e30f;

__global__ void ring_top2_kernel(const float* __restrict__ q, const float* __restrict__ c,
                                 float* __restrict__ d1s, int* __restrict__ i1s,
                                 float* __restrict__ d2s, int* __restrict__ i2s,
                                 int Q, int R, int B) {
  const int qi = blockIdx.x * kQueriesPerBlock + threadIdx.x;
  const int r = blockIdx.y * kRingsPerBlock + threadIdx.y;
  if (qi >= Q || r >= R) return;
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
  const float* cr = c + static_cast<long long>(r) * B * 3;
  // Candidate 0 starts as the nearest; the runner-up starts as the TPU
  // kernel's sentinel (the winner's slot set to 1e30), which is what it
  // returns when the ring has no other candidate (B == 1).
  float d1 = 0.0f, d2 = kBig;
  int i1 = 0, i2 = 0;
  for (int b = 0; b < B; ++b) {
    const float dx = __fsub_rn(__ldg(cr + 3 * b), qx);
    const float dy = __fsub_rn(__ldg(cr + 3 * b + 1), qy);
    const float dz = __fsub_rn(__ldg(cr + 3 * b + 2), qz);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    if (b == 0) {
      d1 = d;
    } else if (d < d1) {
      d2 = d1;
      i2 = i1;
      d1 = d;
      i1 = b;
    } else if (d < d2) {
      d2 = d;
      i2 = b;
    }
  }
  const long long o = static_cast<long long>(r) * Q + qi;
  d1s[o] = d1;
  i1s[o] = i1;
  d2s[o] = d2;
  i2s[o] = i2;
}

__global__ void resolve_kernel(const float* __restrict__ c, const float* __restrict__ d1s,
                               const int* __restrict__ i1s, const float* __restrict__ d2s,
                               const int* __restrict__ i2s, float* __restrict__ out, int Q,
                               int R, int B, float nearby_scan) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= Q) return;
  float d0 = d1s[qi];
  int r0 = 0;
  for (int r = 1; r < R; ++r) {
    const float d = d1s[static_cast<long long>(r) * Q + qi];
    if (d < d0) {
      d0 = d;
      r0 = r;
    }
  }
  float dw = 0.0f;
  int rw = 0;
  bool rw_in_window = false;
  for (int r = 0; r < R; ++r) {
    const float rdiff = fabsf(static_cast<float>(r) - static_cast<float>(r0));
    const bool win = rdiff > 0.0f && rdiff <= nearby_scan;
    const float d = win ? d1s[static_cast<long long>(r) * Q + qi] : kBig;
    if (r == 0 || d < dw) {
      dw = d;
      rw = r;
      rw_in_window = win;
    }
  }
  const long long o0 = static_cast<long long>(r0) * Q + qi;
  const float* c1 = c + (static_cast<long long>(r0) * B + i1s[o0]) * 3;
  const float* c2 = c + (static_cast<long long>(r0) * B + i2s[o0]) * 3;
  const float* cw =
      c + (static_cast<long long>(rw) * B + i1s[static_cast<long long>(rw) * Q + qi]) * 3;
  float* row = out + static_cast<long long>(qi) * 16;
  for (int k = 0; k < 3; ++k) {
    row[k] = c1[k];
    row[3 + k] = c2[k];
    row[6 + k] = rw_in_window ? cw[k] : 0.0f;
  }
  row[9] = d0;
  row[10] = d2s[o0];
  row[11] = dw;
  for (int k = 12; k < 16; ++k) row[k] = 0.0f;
}

}  // namespace

// scratch: 4 * R * Q 32-bit words (d1, i1, d2, i2), allocated by the caller.
extern "C" int lvo_associate(const void* q, const void* c, void* scratch, void* out, int Q,
                             int R, int B, float nearby_scan, void* stream) {
  if (Q <= 0 || R <= 0 || B <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(R) * Q;
  float* d1s = static_cast<float*>(scratch);
  int* i1s = reinterpret_cast<int*>(d1s + n);
  float* d2s = reinterpret_cast<float*>(i1s + n);
  int* i2s = reinterpret_cast<int*>(d2s + n);
  dim3 block(kQueriesPerBlock, kRingsPerBlock);
  dim3 grid((Q + kQueriesPerBlock - 1) / kQueriesPerBlock,
            (R + kRingsPerBlock - 1) / kRingsPerBlock);
  ring_top2_kernel<<<grid, block, 0, s>>>(static_cast<const float*>(q),
                                          static_cast<const float*>(c), d1s, i1s, d2s, i2s,
                                          Q, R, B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  resolve_kernel<<<(Q + 127) / 128, 128, 0, s>>>(static_cast<const float*>(c), d1s, i1s, d2s,
                                                   i2s, static_cast<float*>(out), Q, R, B,
                                                   nearby_scan);
  return cudaGetLastError();
}
