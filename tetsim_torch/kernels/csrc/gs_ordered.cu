// Exact-order Gauss-Seidel frame kernel: one Neo-Hookean XPBD frame for a
// batch of bodies of one tetrahedral mesh, walking the mesh's ordered level
// schedule (every level of the reference's sequential constraint order,
// split into sub-levels of at most 32 vertex-disjoint tets).
//
// Replaces the TPU kernel tetsim_tpu/kernels/gs_ordered.py:_make_kernel
// (called by _step_call) and computes what it computes: per substep,
// predict (gravity, velocity multiplied by the movable mask movw), the
// sub-levels in schedule order (deviatoric C = ||F||_F, then hydrostatic
// C = det F - 1 - gamma on the updated corners, nh::solve_tet of
// nh_math.cuh), then clamp to the world bounds, the ground with friction,
// the grab override and the velocity (x - prev) * (1 / dt).
//
// What bounds it: not bytes.  The dragon's schedule has 703 sub-levels, and
// each depends on the one before it, so a frame is 703 x substeps rounds of
// one tet's projection chain on one SM per body.  Measured (profile_frame.py
// --phases, PERF.md): a sub-level takes about 1,100 SM cycles of warp 0,
// and one solve is about 580 SASS instructions per lane, so a lane issues
// one instruction every two cycles; the rest is the dependent chain (the
// deviatoric step's nine-term norm, an IEEE square root, reciprocal and
// divide, the hydrostatic step on its result, the next sub-level's gather),
// which the idle lanes cannot shorten.  Splitting a tet over three lanes
// (each lane one coordinate, the cross-lane rows by __shfl_sync) cut the
// instructions per lane by 14% but put four rounds of shuffles on the chain
// and measured about 1,530 cycles per sub-level, so it was not kept.  The
// windows and the W-lane working set of the TPU kernel exist
// only because Mosaic gathers from one 384-lane VMEM set; here a body's
// nine particle planes sit in one block's shared memory (44 KB for the
// dragon), so the schedule is one flat list of sub-levels.
//
// Design: one block per body.  All threads share predict and collide,
// strided over the particles (each thread owns the same particles in both,
// so only the level walk needs block barriers around it).  Warp 0 walks the
// sub-levels, one lane per tet, with __syncwarp() between sub-levels in
// place of a block barrier: a warp barrier also orders the lanes' shared
// memory writes before the next sub-level's reads, and it does not assume
// lockstep (Volta and later schedule a warp's threads independently).  Lanes
// past a short sub-level's count skip the solve but still reach the
// barrier.  A sub-level's tables (global corner ids, rest pose, inverse rest
// volume, corner inverse masses) do not depend on the state, so each lane
// loads the next sub-level's into registers before it solves the current
// one: the load's latency hides behind the solve.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nh_math.cuh"

// Scalars of one frame, computed in float32 on the host.
struct OrderedParams {
  float dt;         // substep length
  float gdt;        // gravity * dt
  float inv_dt;     // 1 / dt
  float k_fric;     // min(1, dt * friction)
  float dev_scale;  // dev_compliance / (dt * dt)
  float vol_scale;  // vol_compliance / (dt * dt)
  float gamma;      // vol_compliance / dev_compliance
  float wmin[3];
  float wmax[3];
};

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;  // tets per sub-level, one lane each
constexpr int kCons = 14;   // rows 0-8 rest pose, 9 inverse volume, 10-13 w

#ifdef GS_ORDERED_PHASES
// A build for profile_frame.py --phases only: lane 0 of block 0 sums the SM
// cycles of the level walk (from the barrier before it to its last
// __syncwarp()) and counts the substeps.
__device__ unsigned long long phase_cycles[2];
#endif

struct SubLevel {
  int ids[4];      // global corner ids, -1 on a padded lane
  float c[kCons];  // the tet's constants
};

// Lane `lane`'s tet of sub-level l: tables are [S, 4, 32] and [S, 14, 32],
// so the lanes of a warp read consecutive words.
__device__ __forceinline__ void load_sub(const int* __restrict__ sub_ids,
                                         const float* __restrict__ sub_cons,
                                         int l, int lane, SubLevel& s) {
  const int* ids = sub_ids + (size_t)l * 4 * kLanes + lane;
  for (int c = 0; c < 4; ++c) s.ids[c] = ids[c * kLanes];
  const float* cons = sub_cons + (size_t)l * kCons * kLanes + lane;
  for (int r = 0; r < kCons; ++r) s.c[r] = cons[r * kLanes];
}

__global__ void __launch_bounds__(kThreads)
gs_ordered_kernel(const float* __restrict__ pos_in,   // [B,N,3]
                  const float* __restrict__ vel_in,   // [B,N,3]
                  float* __restrict__ pos_out,        // [B,N,3]
                  float* __restrict__ prev_out,       // [B,N,3]
                  float* __restrict__ vel_out,        // [B,N,3]
                  const int* __restrict__ sub_ids,    // [S,4,32]
                  const float* __restrict__ sub_cons, // [S,14,32]
                  const float* __restrict__ movw,     // [N] 1 movable, 0 pinned
                  const int* __restrict__ grab_id,    // [B,G], -1 inactive
                  const float* __restrict__ grab_pos, // [B,G,3]
                  int N, int S, int G, int num_substeps, OrderedParams P) {
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

  for (int s = 0; s < num_substeps; ++s) {
    // predict
    for (int i = tid; i < N; i += kThreads) {
      const float mov = movw[i];
      const float vx = VX[i] * mov, vy = (VY[i] + P.gdt) * mov,
                  vz = VZ[i] * mov;
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

    // the level walk: warp 0, a lane per tet, a warp barrier per sub-level
    if (tid < kLanes) {
#ifdef GS_ORDERED_PHASES
      const long long t0 = clock64();
#endif
      SubLevel next;
      load_sub(sub_ids, sub_cons, 0, tid, next);
      for (int l = 0; l < S; ++l) {
        const SubLevel cur = next;
        if (l + 1 < S) load_sub(sub_ids, sub_cons, l + 1, tid, next);
        if (cur.ids[0] >= 0) {
          float p[4][3];
          for (int c = 0; c < 4; ++c) {
            p[c][0] = X[cur.ids[c]];
            p[c][1] = Y[cur.ids[c]];
            p[c][2] = Z[cur.ids[c]];
          }
          const float w[4] = {cur.c[10], cur.c[11], cur.c[12], cur.c[13]};
          nh::solve_tet(p, cur.c, cur.c[9], w, P.dev_scale, P.vol_scale,
                        P.gamma);
          for (int c = 0; c < 4; ++c) {
            X[cur.ids[c]] = p[c][0];
            Y[cur.ids[c]] = p[c][1];
            Z[cur.ids[c]] = p[c][2];
          }
        }
        __syncwarp();
      }
#ifdef GS_ORDERED_PHASES
      if (b == 0 && tid == 0) {
        phase_cycles[0] += clock64() - t0;
        phase_cycles[1] += 1;
      }
#endif
    }
    __syncthreads();

    // clamp, ground with friction, grab, velocity
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
      VX[i] = (x - px) * P.inv_dt;
      VY[i] = (y - py) * P.inv_dt;
      VZ[i] = (z - pz) * P.inv_dt;
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

#ifdef GS_ORDERED_PHASES
// One tet's solve per lane on values from global memory and nothing else,
// never launched: profile_frame.py --phases counts its SASS instructions,
// the instructions a lane issues per sub-level (beside the loads and
// stores).
__global__ void gs_ordered_solve_probe(float* p, const float* c,
                                       OrderedParams P) {
  const int tid = threadIdx.x;
  float cons[kCons];
  for (int k = 0; k < kCons; ++k) cons[k] = c[k * kLanes + tid];
  const float w[4] = {cons[10], cons[11], cons[12], cons[13]};
  float pc[4][3];
  for (int i = 0; i < 4; ++i)
    for (int r = 0; r < 3; ++r) pc[i][r] = p[(3 * i + r) * kLanes + tid];
  nh::solve_tet(pc, cons, cons[9], w, P.dev_scale, P.vol_scale, P.gamma);
  for (int i = 0; i < 4; ++i)
    for (int r = 0; r < 3; ++r) p[(3 * i + r) * kLanes + tid] = pc[i][r];
}
#endif

}  // namespace

extern "C" {

int gs_ordered_threads() { return kThreads; }

size_t gs_ordered_smem_bytes(int n) { return (size_t)9 * n * sizeof(float); }

// Launches one frame on `stream`; returns cudaGetLastError() (0 = launched).
int gs_ordered_launch(const void* pos_in, const void* vel_in, void* pos_out,
                      void* prev_out, void* vel_out, const void* sub_ids,
                      const void* sub_cons, const void* movw,
                      const void* grab_id, const void* grab_pos, int B, int N,
                      int S, int G, int num_substeps, OrderedParams P,
                      void* stream) {
  const size_t smem = gs_ordered_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      gs_ordered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gs_ordered_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pos_in, (const float*)vel_in, (float*)pos_out,
      (float*)prev_out, (float*)vel_out, (const int*)sub_ids,
      (const float*)sub_cons, (const float*)movw, (const int*)grab_id,
      (const float*)grab_pos, N, S, G, num_substeps, P);
  return (int)cudaGetLastError();
}

#ifdef GS_ORDERED_PHASES
// Copies phase_cycles to out[2] (walk cycles, substeps) and zeroes it;
// returns the CUDA error.
int gs_ordered_phase_cycles(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
  const unsigned long long zero[2] = {0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
  return (int)err;
}
#endif

const char* gs_ordered_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
