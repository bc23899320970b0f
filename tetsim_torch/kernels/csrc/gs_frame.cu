// Fused coloured Gauss-Seidel frame kernel: one Neo-Hookean XPBD frame for
// B bodies of one tetrahedral mesh.
//
// Replaces the TPU kernel tetsim_tpu/kernels/gs_fused.py:_make_kernel (built
// by _pallas_step_call, device function _solve_level) and follows the
// semantics of tetsim_tpu/solvers/neohookean.py + solvers/common.py.  For
// each substep: predict (gravity, gated by inv_mass > 0), the L colour
// levels (deviatoric C = ||F||_F, then hydrostatic C = det F - 1 - gamma on
// the updated corners), collide (world bounds, ground with friction), grab
// override, velocity update.  It also writes vol_err[B, S]: the sum of
// det F - 1 over the valid tets of each substep, divided by the tet count.
//
// The tet projection is nh::solve_tet (nh_math.cuh), shared with
// nh_stencil.cu.
//
// Design: one thread block per body.  The body's nine particle planes
// (pos, prev, vel; x, y, z) live in shared memory (9 * 4 * N bytes, 44 KB
// for the dragon).  Threads stride over the slots of a level; the tets of a
// level are vertex-disjoint, so their corner reads and write-backs never
// collide, and padded slots (slot_valid false, slot_tets 0) are skipped.
// The slot-major tables of TetArrays stay in global memory and are read in
// order through L1/L2.  __syncthreads() separates predict, every level and
// collide.
//
// What bounds it at the dragon's size: barrier latency, not bytes.  The
// ordered schedule runs 703 levels of at most 22 tets, so Body.step pays
// 703 * 5 dependent barrier rounds per frame on one SM while the other
// SMs idle; the greedy schedule (32 levels of up to 228 tets) pays 160.
// A later change could prefetch the next level's tables into registers
// before the barrier, keep a body's tables in shared memory, run several
// bodies per block with one warp per level slice, or capture many frames
// in one launch or a CUDA graph to hide the per-frame launch cost.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nh_math.cuh"

// Scalars of one frame, computed in float32 on the host.
struct FrameParams {
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
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gs_frame_kernel(const float* __restrict__ pos_in,    // [B,N,3]
                const float* __restrict__ vel_in,    // [B,N,3]
                float* __restrict__ pos_out,         // [B,N,3]
                float* __restrict__ prev_out,        // [B,N,3]
                float* __restrict__ vel_out,         // [B,N,3]
                float* __restrict__ vol_err,         // [B,S]
                const int4* __restrict__ slot_tets,  // [L,C] of 4 ids
                const float* __restrict__ slot_irp,  // [L,C,9] row-major
                const float* __restrict__ slot_irv,  // [L,C]
                const float4* __restrict__ slot_imc, // [L,C] of 4 inv masses
                const uint8_t* __restrict__ slot_valid,  // [L,C]
                const float* __restrict__ inv_mass,  // [N]
                const int* __restrict__ grab_id,     // [B,G], -1 inactive
                const float* __restrict__ grab_pos,  // [B,G,3]
                int N, int L, int C, int G, int S, int num_tets,
                FrameParams P) {
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
  float* red = VZ + N;  // [kWarps] partial vol_err sums

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* pin = pos_in + (size_t)b * N * 3;
  const float* vin = vel_in + (size_t)b * N * 3;
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
    // per-particle phase, so only the level sweep needs barriers around it
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

    float verr = 0.0f;
    for (int l = 0; l < L; ++l) {
      for (int slot = tid; slot < C; slot += kThreads) {
        const int k = l * C + slot;
        if (!slot_valid[k]) continue;
        const int4 t = slot_tets[k];
        const int ids[4] = {t.x, t.y, t.z, t.w};
        float p[4][3];
        for (int c = 0; c < 4; ++c) {
          p[c][0] = X[ids[c]];
          p[c][1] = Y[ids[c]];
          p[c][2] = Z[ids[c]];
        }
        float ir[9];
        for (int e = 0; e < 9; ++e) ir[e] = slot_irp[(size_t)k * 9 + e];
        const float4 wm = slot_imc[k];
        const float w[4] = {wm.x, wm.y, wm.z, wm.w};
        verr += nh::solve_tet(p, ir, slot_irv[k], w, P.dev_scale, P.vol_scale,
                              P.gamma);
        for (int c = 0; c < 4; ++c) {
          X[ids[c]] = p[c][0];
          Y[ids[c]] = p[c][1];
          Z[ids[c]] = p[c][2];
        }
      }
      __syncthreads();
    }

    // collide, grab, velocity update
    for (int i = tid; i < N; i += kThreads) {
      float x = fminf(fmaxf(X[i], P.wmin[0]), P.wmax[0]);
      float y = fminf(fmaxf(Y[i], P.wmin[1]), P.wmax[1]);
      float z = fminf(fmaxf(Z[i], P.wmin[2]), P.wmax[2]);
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

    // vol_err of this substep: warp sums, then one thread adds the warps
    for (int o = 16; o > 0; o >>= 1)
      verr += __shfl_down_sync(0xffffffffu, verr, o);
    if ((tid & 31) == 0) red[tid >> 5] = verr;
    __syncthreads();
    if (tid == 0) {
      float total = 0.0f;
      for (int w = 0; w < kWarps; ++w) total += red[w];
      vol_err[(size_t)b * S + s] = total / (float)num_tets;
    }
  }

  float* pout = pos_out + (size_t)b * N * 3;
  float* qout = prev_out + (size_t)b * N * 3;
  float* vout = vel_out + (size_t)b * N * 3;
  for (int i = tid; i < N; i += kThreads) {
    pout[3 * i] = X[i];
    pout[3 * i + 1] = Y[i];
    pout[3 * i + 2] = Z[i];
    qout[3 * i] = PX[i];
    qout[3 * i + 1] = PY[i];
    qout[3 * i + 2] = PZ[i];
    vout[3 * i] = VX[i];
    vout[3 * i + 1] = VY[i];
    vout[3 * i + 2] = VZ[i];
  }
}

}  // namespace

extern "C" {

int gs_frame_threads() { return kThreads; }

size_t gs_frame_smem_bytes(int n) {
  return (size_t)(9 * n + kWarps) * sizeof(float);
}

// Launches one frame on `stream`; returns cudaGetLastError() (0 = launched).
int gs_frame_launch(const void* pos_in, const void* vel_in, void* pos_out,
                    void* prev_out, void* vel_out, void* vol_err,
                    const void* slot_tets, const void* slot_irp,
                    const void* slot_irv, const void* slot_imc,
                    const void* slot_valid, const void* inv_mass,
                    const void* grab_id, const void* grab_pos, int B, int N,
                    int L, int C, int G, int S, int num_tets, FrameParams P,
                    void* stream) {
  const size_t smem = gs_frame_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      gs_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gs_frame_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pos_in, (const float*)vel_in, (float*)pos_out,
      (float*)prev_out, (float*)vel_out, (float*)vol_err,
      (const int4*)slot_tets, (const float*)slot_irp, (const float*)slot_irv,
      (const float4*)slot_imc, (const uint8_t*)slot_valid,
      (const float*)inv_mass, (const int*)grab_id, (const float*)grab_pos, N,
      L, C, G, S, num_tets, P);
  return (int)cudaGetLastError();
}

const char* gs_frame_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
