// Neo-Hookean XPBD frames of one body too large for one block's shared
// memory: the coloured Gauss-Seidel sweep of tetsim_torch/solvers/
// neohookean.py over the slot-major level schedule of TetArrays, with the
// particle state in global memory.
//
// Replaces no TPU kernel: for such a body the JAX package runs its XLA
// engine (tetsim_tpu/solvers/neohookean.py through tetsim_tpu/world.py's
// Body).  The port's fused frame kernel (gs_frame.cu) keeps a body's nine
// particle planes in one block's shared memory, which holds at most 6,456
// particles; this kernel takes the bodies above that.
//
// Layout: pos / prev / vel [B, N, 3] as Body holds them; the tables
// slot_tets [L, C, 4], slot_inv_rest_pose [L, C, 3, 3],
// slot_inv_rest_volume [L, C], slot_inv_mass [L, C, 4] and slot_valid
// [L, C] of TetArrays as they are.
//
// Design: L + 2 launches per substep, no atomics, deterministic.  A predict
// launch (one thread per particle; it also saves the substep's start
// positions as prev), one launch per level (one thread per slot; the tets
// of a level share no vertex, so each thread reads its 4 corners from
// global memory and writes them back with no race; padded slots idle), and
// a collide launch (one thread per particle: world bounds, the ground with
// friction, grab override, velocity).  Each level block writes the sum of
// its tets' det F - 1 (a tree in shared memory, in a fixed order) to a
// scratch row, and block 0 of the collide launch adds the rows in a fixed
// order into vol_err[b, s] / num_tets.  Substep 0 reads the inputs; later
// substeps update the outputs in place.  The tet projection is
// nh::solve_tet (nh_math.cuh), as in gs_frame.cu.
//
// Numerics: predict, collide and velocity round every operation as the
// plain path does; the tet projection is contracted by nvcc into FMAs
// where it can.
//
// What bounds it on this card: launches.  grid_mesh(20, 20, 20) (9,261
// particles, 48,000 tets) has 78 ordered levels of at most 1,520 tets:
// 80 launches per substep, each of at most six blocks, against 421 flops
// per tet (20 MFLOP per substep, 0.3 us at the FP32 peak).  A later
// change could run the levels as one cooperative kernel with a grid-wide
// barrier between them, or capture a substep's launches in a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nh_math.cuh"

// Scalars of one frame, computed in float32 on the host.
struct LevelParams {
  float dt;         // substep length
  float gdt;        // gravity * dt
  float k_fric;     // min(1, dt * friction)
  float dev_scale;  // dev_compliance / (dt * dt)
  float vol_scale;  // vol_compliance / (dt * dt)
  float gamma;      // vol_compliance / dev_compliance
  float wmin[3];
  float wmax[3];
};

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gs_levels_predict_kernel(const float* pos,   // [B,N,3] substep start
                         const float* vel,   // [B,N,3]
                         float* pos_out,     // [B,N,3] predicted
                         float* __restrict__ prev_out,       // [B,N,3]
                         const float* __restrict__ inv_mass,  // [N]
                         int N, LevelParams P) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= N) return;
  const size_t i = ((size_t)blockIdx.y * N + v) * 3;
  float vx = vel[i], vy = __fadd_rn(vel[i + 1], P.gdt), vz = vel[i + 2];
  if (!(inv_mass[v] > 0.0f)) vx = vy = vz = 0.0f;
  const float x = pos[i], y = pos[i + 1], z = pos[i + 2];
  prev_out[i] = x;
  prev_out[i + 1] = y;
  prev_out[i + 2] = z;
  pos_out[i] = __fadd_rn(x, __fmul_rn(vx, P.dt));
  pos_out[i + 1] = __fadd_rn(y, __fmul_rn(vy, P.dt));
  pos_out[i + 2] = __fadd_rn(z, __fmul_rn(vz, P.dt));
}

// Sum of the block's values in a fixed order (a tree in shared memory);
// every thread of the block must call it.
__device__ __forceinline__ float block_sum(float x, float* red) {
  red[threadIdx.x] = x;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

__global__ void __launch_bounds__(kThreads)
gs_levels_level_kernel(float* __restrict__ pos,               // [B,N,3]
                       const int4* __restrict__ slot_tets,    // [L,C]
                       const float* __restrict__ slot_irp,    // [L,C,9]
                       const float* __restrict__ slot_irv,    // [L,C]
                       const float4* __restrict__ slot_imc,   // [L,C]
                       const uint8_t* __restrict__ slot_valid,  // [L,C]
                       float* __restrict__ partial,  // [B,L,nblk]
                       int N, int L, int C, int level, LevelParams P) {
  __shared__ float red[kThreads];
  const int slot = blockIdx.x * kThreads + threadIdx.x;
  float verr = 0.0f;
  const size_t k = (size_t)level * C + slot;
  if (slot < C && slot_valid[k]) {
    float* bpos = pos + (size_t)blockIdx.y * N * 3;
    const int4 t = slot_tets[k];
    const int ids[4] = {t.x, t.y, t.z, t.w};
    float p[4][3], ir[9];
    for (int c = 0; c < 4; ++c)
      for (int r = 0; r < 3; ++r) p[c][r] = bpos[(size_t)ids[c] * 3 + r];
    for (int e = 0; e < 9; ++e) ir[e] = slot_irp[k * 9 + e];
    const float4 wm = slot_imc[k];
    const float w[4] = {wm.x, wm.y, wm.z, wm.w};
    verr = nh::solve_tet(p, ir, slot_irv[k], w, P.dev_scale, P.vol_scale,
                         P.gamma);
    for (int c = 0; c < 4; ++c)
      for (int r = 0; r < 3; ++r) bpos[(size_t)ids[c] * 3 + r] = p[c][r];
  }
  const float total = block_sum(verr, red);
  if (threadIdx.x == 0)
    partial[((size_t)blockIdx.y * L + level) * gridDim.x + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
gs_levels_collide_kernel(float* __restrict__ pos,             // [B,N,3]
                         const float* __restrict__ prev,      // [B,N,3]
                         float* __restrict__ vel_out,         // [B,N,3]
                         const int* __restrict__ grab_id,     // [B,G]
                         const float* __restrict__ grab_pos,  // [B,G,3]
                         const float* __restrict__ partial,   // [B,L,nblk]
                         float* __restrict__ vol_err,         // [B,S]
                         int N, int G, int S, int s, int rows, int num_tets,
                         LevelParams P) {
  __shared__ float red[kThreads];
  const int b = blockIdx.y;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v < N) {
    const size_t i = ((size_t)b * N + v) * 3;
    const float px = prev[i], py = prev[i + 1], pz = prev[i + 2];
    float x = fminf(fmaxf(pos[i], P.wmin[0]), P.wmax[0]);
    float y = fminf(fmaxf(pos[i + 1], P.wmin[1]), P.wmax[1]);
    float z = fminf(fmaxf(pos[i + 2], P.wmin[2]), P.wmax[2]);
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
    pos[i] = x;
    pos[i + 1] = y;
    pos[i + 2] = z;
    vel_out[i] = (x - px) / P.dt;
    vel_out[i + 1] = (y - py) / P.dt;
    vel_out[i + 2] = (z - pz) / P.dt;
  }
  if (blockIdx.x == 0) {
    // the levels' block sums, each thread a fixed stride of them
    const float* row = partial + (size_t)b * rows;
    float acc = 0.0f;
    for (int j = threadIdx.x; j < rows; j += kThreads) acc += row[j];
    const float total = block_sum(acc, red);
    if (threadIdx.x == 0) vol_err[(size_t)b * S + s] = total / (float)num_tets;
  }
}

}  // namespace

extern "C" {

int gs_levels_threads() { return kThreads; }

// Launches S substeps on `stream`, L + 2 kernels each; partial is scratch
// [B, L, ceil(C / kThreads)].  Returns the first launch error (0 = every
// kernel launched).
int gs_levels_launch(const void* pos_in, const void* vel_in, void* pos_out,
                     void* prev_out, void* vel_out, void* vol_err,
                     void* partial, const void* slot_tets,
                     const void* slot_irp, const void* slot_irv,
                     const void* slot_imc, const void* slot_valid,
                     const void* inv_mass, const void* grab_id,
                     const void* grab_pos, int B, int N, int L, int C, int G,
                     int S, int num_tets, LevelParams P, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (C + kThreads - 1) / kThreads;
  const dim3 parts((N + kThreads - 1) / kThreads, B), slots(nblk, B);
  for (int s = 0; s < S; ++s) {
    const float* pos = (const float*)(s == 0 ? pos_in : pos_out);
    const float* vel = (const float*)(s == 0 ? vel_in : vel_out);
    gs_levels_predict_kernel<<<parts, kThreads, 0, st>>>(
        pos, vel, (float*)pos_out, (float*)prev_out, (const float*)inv_mass, N,
        P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int l = 0; l < L; ++l) {
      gs_levels_level_kernel<<<slots, kThreads, 0, st>>>(
          (float*)pos_out, (const int4*)slot_tets, (const float*)slot_irp,
          (const float*)slot_irv, (const float4*)slot_imc,
          (const uint8_t*)slot_valid, (float*)partial, N, L, C, l, P);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    gs_levels_collide_kernel<<<parts, kThreads, 0, st>>>(
        (float*)pos_out, (const float*)prev_out, (float*)vel_out,
        (const int*)grab_id, (const float*)grab_pos, (const float*)partial,
        (float*)vol_err, N, G, S, s, L * nblk, num_tets, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* gs_levels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
