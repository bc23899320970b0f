// Polar shape-matching solve on the pieces of one unstructured mesh: the
// solve of the polar_pieces engine, tetsim_torch/kernels/polar_pieces.py,
// whose pieces_solve_reference is its plain twin.
//
// Replaces the TPU kernel tetsim_tpu/kernels/polar_pieces.py:
// _make_solve_kernel (built by _solve_call).  That kernel walks 8 pieces per
// grid step in VMEM and splits every gather into per-tile dynamic gathers
// (the source-tile lists); on the card a thread addresses any lane, so the
// kernel reads the same tables and no tile lists.
//
// Layout (B pieces, rt tet lanes and rp particle lanes per piece):
//   px, py, pz  [B, rp]      predicted local positions
//   quat_in/out [4, B, rt]   component-major quaternions
//   ids         [4, B, rt]   corner k of tet lane t -> local particle lane
//   rc          [12, B, rt]  rest corner k, coordinate r at row 3k + r
//   wvol        [B, rt]      rest volume (0 on padded tet lanes)
//   inc         [K, B, rp]   bank v of a lane: its v-th corner slot k*rt + t,
//                            -1 after the last (the live banks are a prefix)
//   num         [3, B, rp]   out: partial numerators (the piece's sum)
//   delta       [B, 3, 4rt]  scratch: weighted goal deltas at slot k*rt + t
//
// Design: two launches per substep, no atomics, a fixed order.
//   A. One thread per (piece, tet lane), B * rt in all (1,048,576 for the
//      987,090-tet blob at 2,048 tets per piece): gather the 4 corners from
//      the piece's planes, the centroid (((c0 + c1) + c2) + c3) / 4, the
//      covariance with the rest corners rotated by the tet's quaternion,
//      extract_rotation from the identity (polar_math.cuh, the grid
//      engine's axis form), the quaternion update q <- normalise(dq q) with
//      a 1e-30 floor on the norm, written to quat_out; then the 4 goal
//      deltas (rotated rest corner - centred corner) * rest volume.
//   B. One thread per (piece, lane), B * rp in all: its incidence banks in
//      order, starting from 0.0, into the numerator planes.
// A padded tet lane (corner lane 0, rest volume 0) computes a zero delta; a
// padded particle lane has no incidence and gets 0.
//
// Numerics: the sums of pass B round every addition as the plain twin does;
// the tet arithmetic is contracted by nvcc into FMAs where it can, so a
// result may differ from the twin's in its last bits.
//
// What bounds it: bytes, at the data sheet's peaks.  Per substep at 987,090
// tets the solve does 1.59 GFLOP (polar_pieces.frame_flops: 24 us at 67
// TFLOP/s) and must move 129 MB (frame_bytes: 116 bytes per tet, the planes
// 14 MB; 39 us at 3.35 TB/s).  The design reads every table once with
// neighbouring threads on neighbouring tet lanes (the [.., B, rt] planes),
// gathers corners from a piece's 4.6 KB position planes (cache-resident),
// and passes the deltas through a 50 MB scratch that is written once and
// read once.  Pass A's threads are long dependent chains (9 extract_rotation
// iterations with divides, a square root, a sine and a cosine each), so
// latency, not either peak, is the likely limit in practice.

#include <cuda_runtime.h>
#include <stdint.h>

#include "polar_math.cuh"

namespace {

constexpr int kTetThreads = 128;
constexpr int kLaneThreads = 256;

__global__ void __launch_bounds__(kTetThreads)
polar_pieces_tet_kernel(const float* __restrict__ px,
                        const float* __restrict__ py,
                        const float* __restrict__ pz,
                        const float* __restrict__ quat_in,  // [4,B,rt]
                        float* __restrict__ quat_out,       // [4,B,rt]
                        const int* __restrict__ ids,        // [4,B,rt]
                        const float* __restrict__ rc,       // [12,B,rt]
                        const float* __restrict__ wvol,     // [B,rt]
                        float* __restrict__ delta,          // [B,3,4rt]
                        int B, int rp, int rt, int iters) {
  const size_t plane = (size_t)B * rt;
  const size_t idx = (size_t)blockIdx.x * kTetThreads + threadIdx.x;
  if (idx >= plane) return;
  const int b = (int)(idx / rt), t = (int)(idx - (size_t)b * rt);
  const float* pos[3] = {px + (size_t)b * rp, py + (size_t)b * rp,
                         pz + (size_t)b * rp};

  float p[4][3], rest[4][3];
  for (int c = 0; c < 4; ++c) {
    const int lane = ids[c * plane + idx];
    for (int r = 0; r < 3; ++r) {
      p[c][r] = pos[r][lane];
      rest[c][r] = rc[(3 * c + r) * plane + idx];
    }
  }
  float pc[4][3];
  for (int r = 0; r < 3; ++r) {
    const float cc = (((p[0][r] + p[1][r]) + p[2][r]) + p[3][r]) * 0.25f;
    for (int c = 0; c < 4; ++c) pc[c][r] = p[c][r] - cc;
  }

  float4 q = make_float4(quat_in[idx], quat_in[plane + idx],
                         quat_in[2 * plane + idx], quat_in[3 * plane + idx]);
  float rr[4][3];
  for (int c = 0; c < 4; ++c) polar::qrot(rest[c], q, rr[c]);
  float a[3][3];  // a[r][c] = sum_k pc[k][r] * rr[k][c]
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      a[r][c] = ((pc[0][r] * rr[0][c] + pc[1][r] * rr[1][c]) +
                 pc[2][r] * rr[2][c]) + pc[3][r] * rr[3][c];
  const float4 inc = polar::extract_rotation<polar::AxisForm::kReciprocal>(
      a, make_float4(0.0f, 0.0f, 0.0f, 1.0f), iters);
  q = polar::qnormalize_guarded(polar::qmul(inc, q));
  quat_out[idx] = q.x;
  quat_out[plane + idx] = q.y;
  quat_out[2 * plane + idx] = q.z;
  quat_out[3 * plane + idx] = q.w;

  const float w = wvol[idx];
  float* d = delta + (size_t)b * 12 * rt;
  for (int c = 0; c < 4; ++c) {
    float g[3];
    polar::qrot(rest[c], q, g);
    for (int r = 0; r < 3; ++r)
      d[(size_t)r * 4 * rt + c * rt + t] = __fmul_rn(g[r] - pc[c][r], w);
  }
}

__global__ void __launch_bounds__(kLaneThreads)
polar_pieces_lane_kernel(const int* __restrict__ inc,      // [K,B,rp]
                         const float* __restrict__ delta,  // [B,3,4rt]
                         float* __restrict__ num,          // [3,B,rp]
                         int B, int rp, int rt, int K) {
  const size_t plane = (size_t)B * rp;
  const size_t idx = (size_t)blockIdx.x * kLaneThreads + threadIdx.x;
  if (idx >= plane) return;
  const int b = (int)(idx / rp);
  const float* d = delta + (size_t)b * 12 * rt;
  float s[3] = {0.0f, 0.0f, 0.0f};
  for (int v = 0; v < K; ++v) {
    const int e = inc[v * plane + idx];
    if (e < 0) break;  // the live banks are a prefix
    for (int r = 0; r < 3; ++r)
      s[r] = __fadd_rn(s[r], d[(size_t)r * 4 * rt + e]);
  }
  for (int r = 0; r < 3; ++r) num[r * plane + idx] = s[r];
}

}  // namespace

extern "C" {

int polar_pieces_launches_per_substep() { return 2; }

// Launches one solve on `stream`, two kernels; returns the first launch
// error (0 = both kernels launched).
int polar_pieces_launch(const void* px, const void* py, const void* pz,
                        const void* quat_in, void* quat_out, void* delta,
                        void* num, const void* ids, const void* inc,
                        const void* rc, const void* wvol, int B, int rp,
                        int rt, int K, int iters, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t tets = (size_t)B * rt, lanes = (size_t)B * rp;
  polar_pieces_tet_kernel<<<(unsigned)((tets + kTetThreads - 1) / kTetThreads),
                            kTetThreads, 0, st>>>(
      (const float*)px, (const float*)py, (const float*)pz,
      (const float*)quat_in, (float*)quat_out, (const int*)ids,
      (const float*)rc, (const float*)wvol, (float*)delta, B, rp, rt, iters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  polar_pieces_lane_kernel<<<(unsigned)((lanes + kLaneThreads - 1) /
                                        kLaneThreads),
                             kLaneThreads, 0, st>>>(
      (const int*)inc, (const float*)delta, (float*)num, B, rp, rt, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return 0;
}

const char* polar_pieces_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
