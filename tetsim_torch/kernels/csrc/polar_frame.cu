// Fused polar shape-matching frame kernel: one Jacobi polar frame for B
// bodies of one tetrahedral mesh.
//
// Replaces the TPU kernel tetsim_tpu/kernels/polar_fused.py:_make_kernel
// (built by _pallas_step_call, rotations by _qrot_table) and follows the
// semantics of tetsim_tpu/solvers/polar.py + solvers/common.py, as the
// plain path tetsim_torch/solvers/polar.py writes them.  For each substep:
// predict (gravity, gated by inv_mass > 0); per tet, the corner gather and
// centroid, the covariance with the rest corners rotated by the tet's
// quaternion, extract_rotation from the identity, the quaternion update and
// the four rest-volume-weighted goal deltas; per particle, the sum of its
// incident deltas in the column order of inc_idx over the sum of its rest
// volumes, then collide (world bounds, ground with friction), grab override
// and velocity update.  Where K2 differed from the XLA engine, this follows
// the XLA engine: num / max(den, eps), q / |q|, (x - prev) / dt.
//
// Numerics: every sum keeps the plain path's order, and nvcc contracts
// multiply-adds into FMAs (polar_fused.NVCC_FLAGS is empty), so a product
// is not always rounded before it is added, as plain torch rounds it.  The
// differences that leaves grow over the dragon's substeps at the rate of
// the dragon's own spread from positions 1 ulp apart: after 3 frames at 20
// substeps both are 1.5e-5 in position (profile_frame.py prints them for
// this build and for a -fmad=false build, which gives the plain path's
// bits and is about 5% slower on an H100).
//
// Design: one thread block per body, one launch per frame, the substep
// loop inside.  The body's nine particle planes (pos, prev, vel; x, y, z)
// live in shared memory (9 * 4 * N bytes, 44 KB for the dragon).  Phase A
// gives each thread tets t = tid, tid + kThreads, ...; it reads the tet's
// quaternion from global memory (quat_in in the first substep, quat_out
// after it) and writes it to quat_out (one owner per tet, so no other thread
// touches it), and writes the tet's four deltas to a
// global scratch buffer [B, 4M] of float4 (the dragon's 4 * 3840 corners
// take 240 KB, more than a block's shared memory; it stays in L2).  Phase B
// gives each thread particles i = tid, tid + kThreads, ...; a particle adds
// its incident deltas one at a time, so the sum order is fixed and the
// kernel is deterministic: no atomics.  Two __syncthreads() per substep:
// after predict (phase A reads every particle) and after phase A (phase B
// reads every tet's deltas).
//
// What bounds it: FP32 arithmetic on one SM.  Counted from this code
// (kernels/polar_fused.py frame_flops), a tet costs 391 + 136 * iters flops
// per substep, 1,615 at the default 9 iterations of extract_rotation, which
// are most of it; a particle 19 plus 3 per incident corner.  That is 6.3
// MFLOP per dragon substep and 125 MFLOP per frame at 20 substeps, against
// 0.63 MB of tables and state read and written once.  One
// block per body gives a body one of 132 SMs, so B = 1 cannot reach the
// card's bound, and batches up to 132 bodies fill one wave at the same time
// per launch.  A later change could spread a body over a cluster of SMs
// with distributed shared memory, keep the deltas in shared memory, or
// capture many frames in a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

#include "polar_math.cuh"

// Scalars of one frame, computed in float32 on the host.
struct PolarParams {
  float dt;      // substep length
  float gdt;     // gravity * dt
  float k_fric;  // min(1, dt * friction)
  float wmin[3];
  float wmax[3];
};

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
polar_frame_kernel(const float* __restrict__ pos_in,   // [B,N,3]
                   const float* __restrict__ vel_in,   // [B,N,3]
                   const float4* __restrict__ quat_in, // [B,M] xyzw
                   float* __restrict__ pos_out,        // [B,N,3]
                   float* __restrict__ prev_out,       // [B,N,3]
                   float* __restrict__ vel_out,        // [B,N,3]
                   float4* __restrict__ quat_out,      // [B,M]
                   float4* __restrict__ delta,         // [B,4M] scratch
                   const int4* __restrict__ tets,      // [M] of 4 ids
                   const float4* __restrict__ rc,      // [M,3] = [M,4,3] rest_centered
                   const float* __restrict__ rest_volume,  // [M]
                   const float* __restrict__ inv_mass,     // [N]
                   const int* __restrict__ inc_idx,    // [N,K], -1 padded
                   const float* __restrict__ inc_den,  // [N]
                   const int* __restrict__ grab_id,    // [B,G], -1 inactive
                   const float* __restrict__ grab_pos, // [B,G,3]
                   int N, int M, int K, int G, int S, int iters,
                   PolarParams P) {
  extern __shared__ float smem[];
  float* X = smem;
  float* Y = X + N;
  float* Z = Y + N;
  float* PX = Z + N;
  float* PY = PX + N;
  float* PZ = PY + N;
  float* VX = PZ + N;
  float* VY = VX + N;
  float* VZ = VY + N;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* pin = pos_in + (size_t)b * N * 3;
  const float* vin = vel_in + (size_t)b * N * 3;
  const float4* qin = quat_in + (size_t)b * M;
  float4* qout = quat_out + (size_t)b * M;
  float4* dl = delta + (size_t)b * 4 * M;
  const int* gid = grab_id + (size_t)b * G;
  const float* gpos = grab_pos + (size_t)b * G * 3;

  for (int i = tid; i < N; i += kThreads) {
    X[i] = pin[3 * i];
    Y[i] = pin[3 * i + 1];
    Z[i] = pin[3 * i + 2];
    VX[i] = vin[3 * i];
    VY[i] = vin[3 * i + 1];
    VZ[i] = vin[3 * i + 2];
  }

  for (int s = 0; s < S; ++s) {
    // predict; each thread owns particles tid, tid + kThreads, ... in every
    // per-particle phase, so phase B and the next predict need no barrier
    for (int i = tid; i < N; i += kThreads) {
      float vx = VX[i], vy = VY[i] + P.gdt, vz = VZ[i];
      if (!(inv_mass[i] > 0.0f)) vx = vy = vz = 0.0f;
      VX[i] = vx;
      VY[i] = vy;
      VZ[i] = vz;
      const float x = X[i], y = Y[i], z = Z[i];
      PX[i] = x;
      PY[i] = y;
      PZ[i] = z;
      X[i] = x + vx * P.dt;
      Y[i] = y + vy * P.dt;
      Z[i] = z + vz * P.dt;
    }
    __syncthreads();

    // phase A: one tet per thread
    const float4* qsrc = s == 0 ? qin : qout;
    for (int t = tid; t < M; t += kThreads) {
      const int4 tt = tets[t];
      const int ids[4] = {tt.x, tt.y, tt.z, tt.w};
      float pc[4][3];
      for (int k = 0; k < 4; ++k) {
        pc[k][0] = X[ids[k]];
        pc[k][1] = Y[ids[k]];
        pc[k][2] = Z[ids[k]];
      }
      for (int r = 0; r < 3; ++r) {
        const float c = (((pc[0][r] + pc[1][r]) + pc[2][r]) + pc[3][r]) * 0.25f;
        for (int k = 0; k < 4; ++k) pc[k][r] = pc[k][r] - c;
      }
      float rest[4][3];
      {
        const float4 r0 = rc[3 * t], r1 = rc[3 * t + 1], r2 = rc[3 * t + 2];
        const float flat[12] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                                r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
        for (int k = 0; k < 4; ++k)
          for (int r = 0; r < 3; ++r) rest[k][r] = flat[3 * k + r];
      }
      const float4 q = qsrc[t];
      float a[3][3];  // a[r][c] = sum_k pc[k][r] * rot(rest[k])[c]
      for (int k = 0; k < 4; ++k) {
        float rr[3];
        polar::qrot(rest[k], q, rr);
        for (int r = 0; r < 3; ++r)
          for (int c = 0; c < 3; ++c)
            a[r][c] = k == 0 ? pc[k][r] * rr[c] : a[r][c] + pc[k][r] * rr[c];
      }
      const float4 inc =
          polar::extract_rotation(a, make_float4(0.0f, 0.0f, 0.0f, 1.0f), iters);
      const float4 qn = polar::qnormalize(polar::qmul(inc, q));
      qout[t] = qn;
      const float w = rest_volume[t];
      for (int k = 0; k < 4; ++k) {
        float g[3];
        polar::qrot(rest[k], qn, g);
        dl[4 * t + k] = make_float4((g[0] - pc[k][0]) * w, (g[1] - pc[k][1]) * w,
                                    (g[2] - pc[k][2]) * w, 0.0f);
      }
    }
    __syncthreads();

    // phase B: one particle per thread: apply, collide, grab, velocity
    for (int i = tid; i < N; i += kThreads) {
      float x = X[i], y = Y[i], z = Z[i];
      if (inv_mass[i] > 0.0f) {
        float nx = 0.0f, ny = 0.0f, nz = 0.0f;
        const int* row = inc_idx + (size_t)i * K;
        for (int j = 0; j < K; ++j) {  // live entries come first, in order
          const int c = row[j];
          if (c < 0) break;
          const float4 d = dl[c];
          nx += d.x;
          ny += d.y;
          nz += d.z;
        }
        const float den = fmaxf(inc_den[i], polar::kEps);
        x = x + nx / den;
        y = y + ny / den;
        z = z + nz / den;
      }
      x = fminf(fmaxf(x, P.wmin[0]), P.wmax[0]);
      y = fminf(fmaxf(y, P.wmin[1]), P.wmax[1]);
      z = fminf(fmaxf(z, P.wmin[2]), P.wmax[2]);
      const float px = PX[i], py = PY[i], pz = PZ[i];
      if (y < 0.0f) {
        y = 0.0f;
        x = x + (px - x) * P.k_fric;
        z = z + (pz - z) * P.k_fric;
      }
      for (int g = 0; g < G; ++g) {
        if (gid[g] == i) {
          x = gpos[3 * g];
          y = gpos[3 * g + 1];
          z = gpos[3 * g + 2];
        }
      }
      X[i] = x;
      Y[i] = y;
      Z[i] = z;
      VX[i] = (x - px) / P.dt;
      VY[i] = (y - py) / P.dt;
      VZ[i] = (z - pz) / P.dt;
    }
  }

  float* pout = pos_out + (size_t)b * N * 3;
  float* qprev = prev_out + (size_t)b * N * 3;
  float* vout = vel_out + (size_t)b * N * 3;
  for (int i = tid; i < N; i += kThreads) {
    pout[3 * i] = X[i];
    pout[3 * i + 1] = Y[i];
    pout[3 * i + 2] = Z[i];
    qprev[3 * i] = PX[i];
    qprev[3 * i + 1] = PY[i];
    qprev[3 * i + 2] = PZ[i];
    vout[3 * i] = VX[i];
    vout[3 * i + 1] = VY[i];
    vout[3 * i + 2] = VZ[i];
  }
}

}  // namespace

extern "C" {

int polar_frame_threads() { return kThreads; }

size_t polar_frame_smem_bytes(int n) { return (size_t)9 * n * sizeof(float); }

// Launches one frame on `stream`; returns cudaGetLastError() (0 = launched).
int polar_frame_launch(const void* pos_in, const void* vel_in,
                       const void* quat_in, void* pos_out, void* prev_out,
                       void* vel_out, void* quat_out, void* delta,
                       const void* tets, const void* rc,
                       const void* rest_volume, const void* inv_mass,
                       const void* inc_idx, const void* inc_den,
                       const void* grab_id, const void* grab_pos, int B, int N,
                       int M, int K, int G, int S, int iters, PolarParams P,
                       void* stream) {
  const size_t smem = polar_frame_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      polar_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  polar_frame_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pos_in, (const float*)vel_in, (const float4*)quat_in,
      (float*)pos_out, (float*)prev_out, (float*)vel_out, (float4*)quat_out,
      (float4*)delta, (const int4*)tets, (const float4*)rc,
      (const float*)rest_volume, (const float*)inv_mass, (const int*)inc_idx,
      (const float*)inc_den, (const int*)grab_id, (const float*)grab_pos, N, M,
      K, G, S, iters, P);
  return (int)cudaGetLastError();
}

const char* polar_frame_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
