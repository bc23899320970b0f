// Polar shape-matching frames (Jacobi) of one body too large for one
// block's shared memory: the solve of tetsim_torch/solvers/polar.py with
// the particle state in global memory, two launches per substep.
//
// Replaces no TPU kernel: for such a body the JAX package runs its XLA
// engine (tetsim_tpu/solvers/polar.py through tetsim_tpu/world.py's Body).
// The port's fused frame kernel (polar_frame.cu) keeps a body's nine
// particle planes in one block's shared memory, which holds at most 6,456
// particles; this kernel takes the bodies above that.
//
// Layout: pos / prev / vel [B, N, 3] as Body holds them, quaternions
// [B, M] of float4 (xyzw) in the mesh's tet order; the tables tets [M, 4],
// rest_centered [M, 4, 3], rest_volume [M], inv_mass [N], inc_idx [N, K]
// (a particle's corner ids 4 t + k in ascending order, -1 padded) and
// inc_den [N] of TetArrays as they are.
//
// Design: two launches per substep, no atomics, deterministic, as the
// pieces kernel polar_pieces.cu.
//   A. One thread per tet: it predicts its 4 corners from the substep's
//      start state (predict is elementwise and rounds every operation, so
//      every thread gets the same bits for a particle), forms the centroid
//      and the covariance with the rest corners rotated by its quaternion,
//      runs extract_rotation from the identity (polar_math.cuh), writes the
//      new quaternion and its 4 rest-volume-weighted goal deltas to a
//      scratch buffer [B, 4M] of float4.
//   B. One thread per particle: it predicts itself again, sums its row of
//      inc_idx in order (the plain path's order), divides by
//      max(inc_den, eps), collides, applies the grabs and sets the velocity.
// Substep 0 reads the inputs; later substeps update the outputs in place
// (a thread reads its own particle, or its own quaternion, before it
// writes it).
//
// Numerics: predict, the particle sums, collide and velocity round every
// operation as the plain path does; the tet arithmetic is contracted by
// nvcc into FMAs where it can, as in polar_frame.cu.
//
// What bounds it on this card: at grid_mesh(20, 20, 20) (48,000 tets) the
// launches and pass A's dependent chain per thread (9 extract_rotation
// iterations with divides, a square root, a sine and a cosine): 48,000
// threads fill about 375 blocks of 128, under three per SM, so each SM
// runs few warps and the chain's latency is not hidden.  The work is 1,615
// flops per tet (78 MFLOP per substep, 1.2 us at the FP32 peak).

#include <cuda_runtime.h>
#include <stdint.h>

#include "polar_math.cuh"

// Scalars of one frame, computed in float32 on the host.
struct JacobiParams {
  float dt;      // substep length
  float gdt;     // gravity * dt
  float k_fric;  // min(1, dt * friction)
  float wmin[3];
  float wmax[3];
};

namespace {

constexpr int kTetThreads = 128;
constexpr int kParticleThreads = 256;

// The predicted position of particle v of one body: gravity into the
// velocity, pinned particles (inv_mass 0) held, pos + vel * dt.
__device__ __forceinline__ void predict(const float* pos, const float* vel,
                                        const float* inv_mass, int v,
                                        const JacobiParams& P, float out[3]) {
  float vx = vel[3 * v], vy = __fadd_rn(vel[3 * v + 1], P.gdt),
        vz = vel[3 * v + 2];
  if (!(inv_mass[v] > 0.0f)) vx = vy = vz = 0.0f;
  out[0] = __fadd_rn(pos[3 * v], __fmul_rn(vx, P.dt));
  out[1] = __fadd_rn(pos[3 * v + 1], __fmul_rn(vy, P.dt));
  out[2] = __fadd_rn(pos[3 * v + 2], __fmul_rn(vz, P.dt));
}

__global__ void __launch_bounds__(kTetThreads)
polar_jacobi_tet_kernel(const float* __restrict__ pos,  // [B,N,3]
                        const float* __restrict__ vel,  // [B,N,3]
                        const float4* quat_in,          // [B,M]
                        float4* quat_out,               // [B,M]
                        float4* __restrict__ delta,     // [B,4M] scratch
                        const int4* __restrict__ tets,  // [M]
                        const float* __restrict__ rc,   // [M,4,3]
                        const float* __restrict__ rest_volume,  // [M]
                        const float* __restrict__ inv_mass,     // [N]
                        int N, int M, int iters, JacobiParams P) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * kTetThreads + threadIdx.x;
  if (t >= M) return;
  const float* bpos = pos + (size_t)b * N * 3;
  const float* bvel = vel + (size_t)b * N * 3;
  const int4 tt = tets[t];
  const int ids[4] = {tt.x, tt.y, tt.z, tt.w};
  float pc[4][3], rest[4][3];
  for (int k = 0; k < 4; ++k) {
    predict(bpos, bvel, inv_mass, ids[k], P, pc[k]);
    for (int r = 0; r < 3; ++r) rest[k][r] = rc[((size_t)t * 4 + k) * 3 + r];
  }
  for (int r = 0; r < 3; ++r) {
    const float c = (((pc[0][r] + pc[1][r]) + pc[2][r]) + pc[3][r]) * 0.25f;
    for (int k = 0; k < 4; ++k) pc[k][r] = pc[k][r] - c;
  }
  const size_t q_at = (size_t)b * M + t;
  const float4 q = quat_in[q_at];
  float a[3][3];  // a[r][c] = sum_k pc[k][r] * rot(rest[k])[c]
  for (int k = 0; k < 4; ++k) {
    float rr[3];
    polar::qrot(rest[k], q, rr);
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        a[r][c] = k == 0 ? pc[k][r] * rr[c] : a[r][c] + pc[k][r] * rr[c];
  }
  const float4 inc = polar::extract_rotation(
      a, make_float4(0.0f, 0.0f, 0.0f, 1.0f), iters);
  const float4 qn = polar::qnormalize(polar::qmul(inc, q));
  quat_out[q_at] = qn;
  const float w = rest_volume[t];
  float4* dl = delta + (size_t)b * 4 * M + 4 * (size_t)t;
  for (int k = 0; k < 4; ++k) {
    float g[3];
    polar::qrot(rest[k], qn, g);
    dl[k] = make_float4(__fmul_rn(g[0] - pc[k][0], w),
                        __fmul_rn(g[1] - pc[k][1], w),
                        __fmul_rn(g[2] - pc[k][2], w), 0.0f);
  }
}

__global__ void __launch_bounds__(kParticleThreads)
polar_jacobi_particle_kernel(const float* pos,  // [B,N,3] substep start
                             const float* vel,  // [B,N,3]
                             float* pos_out,    // [B,N,3]
                             float* __restrict__ prev_out,  // [B,N,3]
                             float* vel_out,                // [B,N,3]
                             const float4* __restrict__ delta,   // [B,4M]
                             const float* __restrict__ inv_mass,  // [N]
                             const int* __restrict__ inc_idx,    // [N,K]
                             const float* __restrict__ inc_den,  // [N]
                             const int* __restrict__ grab_id,    // [B,G]
                             const float* __restrict__ grab_pos,  // [B,G,3]
                             int N, int M, int K, int G, JacobiParams P) {
  const int b = blockIdx.y;
  const int v = blockIdx.x * kParticleThreads + threadIdx.x;
  if (v >= N) return;
  const size_t base = (size_t)b * N * 3;
  const float* bpos = pos + base;
  float p[3];
  predict(bpos, vel + base, inv_mass, v, P, p);
  float x = p[0], y = p[1], z = p[2];
  if (inv_mass[v] > 0.0f) {
    const float4* dl = delta + (size_t)b * 4 * M;
    const int* row = inc_idx + (size_t)v * K;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    for (int j = 0; j < K; ++j) {  // live entries come first, in order
      const int c = row[j];
      if (c < 0) break;
      const float4 d = dl[c];
      nx = __fadd_rn(nx, d.x);
      ny = __fadd_rn(ny, d.y);
      nz = __fadd_rn(nz, d.z);
    }
    const float den = fmaxf(inc_den[v], polar::kEps);
    x = __fadd_rn(x, nx / den);
    y = __fadd_rn(y, ny / den);
    z = __fadd_rn(z, nz / den);
  }
  const float px = bpos[3 * v], py = bpos[3 * v + 1], pz = bpos[3 * v + 2];
  x = fminf(fmaxf(x, P.wmin[0]), P.wmax[0]);
  y = fminf(fmaxf(y, P.wmin[1]), P.wmax[1]);
  z = fminf(fmaxf(z, P.wmin[2]), P.wmax[2]);
  if (y < 0.0f) {
    y = 0.0f;
    x = __fadd_rn(x, __fmul_rn(px - x, P.k_fric));
    z = __fadd_rn(z, __fmul_rn(pz - z, P.k_fric));
  }
  for (int g = 0; g < G; ++g) {  // the last grab on v wins
    if (grab_id[b * G + g] == v) {
      x = grab_pos[(b * G + g) * 3];
      y = grab_pos[(b * G + g) * 3 + 1];
      z = grab_pos[(b * G + g) * 3 + 2];
    }
  }
  prev_out[base + 3 * v] = px;
  prev_out[base + 3 * v + 1] = py;
  prev_out[base + 3 * v + 2] = pz;
  pos_out[base + 3 * v] = x;
  pos_out[base + 3 * v + 1] = y;
  pos_out[base + 3 * v + 2] = z;
  vel_out[base + 3 * v] = (x - px) / P.dt;
  vel_out[base + 3 * v + 1] = (y - py) / P.dt;
  vel_out[base + 3 * v + 2] = (z - pz) / P.dt;
}

}  // namespace

extern "C" {

int polar_jacobi_launches_per_substep() { return 2; }

// Launches S substeps on `stream`, two kernels each; delta is scratch
// [B, 4M] of float4.  Returns the first launch error (0 = every kernel
// launched).
int polar_jacobi_launch(const void* pos_in, const void* vel_in,
                        const void* quat_in, void* pos_out, void* prev_out,
                        void* vel_out, void* quat_out, void* delta,
                        const void* tets, const void* rc,
                        const void* rest_volume, const void* inv_mass,
                        const void* inc_idx, const void* inc_den,
                        const void* grab_id, const void* grab_pos, int B,
                        int N, int M, int K, int G, int S, int iters,
                        JacobiParams P, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 tet_grid((M + kTetThreads - 1) / kTetThreads, B);
  const dim3 particle_grid((N + kParticleThreads - 1) / kParticleThreads, B);
  for (int s = 0; s < S; ++s) {
    const float* pos = (const float*)(s == 0 ? pos_in : pos_out);
    const float* vel = (const float*)(s == 0 ? vel_in : vel_out);
    const float4* quat = (const float4*)(s == 0 ? quat_in : quat_out);
    polar_jacobi_tet_kernel<<<tet_grid, kTetThreads, 0, st>>>(
        pos, vel, quat, (float4*)quat_out, (float4*)delta, (const int4*)tets,
        (const float*)rc, (const float*)rest_volume, (const float*)inv_mass, N,
        M, iters, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    polar_jacobi_particle_kernel<<<particle_grid, kParticleThreads, 0, st>>>(
        pos, vel, (float*)pos_out, (float*)prev_out, (float*)vel_out,
        (const float4*)delta, (const float*)inv_mass, (const int*)inc_idx,
        (const float*)inc_den, (const int*)grab_id, (const float*)grab_pos, N,
        M, K, G, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* polar_jacobi_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
