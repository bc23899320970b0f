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
// for the dragon).  Predict and collide stride over the particles on all
// threads (each thread owns the same particles in both, so only the level
// walk needs block barriers around it).  The tets of a level are
// vertex-disjoint, so their corner reads and write-backs never collide,
// and padded slots (slot_valid false) are skipped.  The slot-major tables
// of TetArrays stay in global memory.
//
// What bounds it on an H100: latency, not bytes or operations.  A frame
// is L x substeps dependent level rounds on one SM, and each round is the
// dependent chain of one tet's two projections (a square root, two
// divides and some 400 dependent multiply-adds) plus the barrier that
// orders the round's shared-memory writes before the next round's reads.
// The first design paid, per round, a __syncthreads() of 256 threads and,
// after it, the loads of the slot's tables from L1/L2 at the head of the
// chain: 0.80 us per level on the ordered schedule (703 levels of at most
// 22 tets; 2.8074 ms per frame at 5 substeps) and 1.16 us on the greedy
// one (32 levels of up to 228 tets; 0.185 ms).  This design does two
// things about it:
//   - the warp walk: where a schedule's widest level has at most 32 slots
//     (the ordered schedule; World.add_body's default), warp 0 walks the
//     levels, lane l on slot l, with __syncwarp() between levels in place
//     of a block barrier (a warp barrier also orders the lanes' shared
//     memory writes before the next level's reads, and assumes no
//     lockstep); lanes past a level's slots skip the solve but reach the
//     barrier.  gs_ordered.cu (K7) walks the same order this way;
//   - the prefetch, in both walks: each thread loads the next level's
//     tables of its first slot (corner ids, valid flag, the 9 rest-pose
//     floats, inverse volume, the 4 inverse masses) into registers before
//     it solves the current level, so the load's latency hides behind the
//     solve.  The tables do not depend on the state, so this is exact.
//     Slots past the block's width (C > 256, meshes wider than the dragon)
//     are loaded where they are solved.
// Which walk runs is chosen on the host from C (gs_fused.walk) and passed
// as `walk`.  Thread l sums its slots' det F - 1 in the same order in both
// walks, so the two give the same bits, vol_err included.  Measured on an
// H100 at 700 W (profile_frame.py --parent, chip_smoke.py phase 5): 0.61
// us per ordered level (2.158 ms per frame), 1.01 us per greedy level
// (0.163 ms); K7 walks the ordered order at 0.55 us per sub-level.

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
constexpr int kBlockWalk = 0;  // every thread, __syncthreads() per level
constexpr int kWarpWalk = 1;   // warp 0, __syncwarp() per level (C <= 32)

// One slot's tables: the state-independent half of a tet's projection.
struct Slot {
  int4 t;        // corner ids
  float ir[9];   // inverse rest pose, row-major
  float irv;     // inverse rest volume
  float4 w;      // corner inverse masses
  int valid;     // slot_valid as loaded: tested only where the slot is
                 // solved, so the prefetch never waits for its load
};

// The slot-major tables of a schedule, [L, C] each.
struct Tables {
  const int4* tets;      // 4 corner ids
  const float* irp;      // 9 floats, row-major
  const float* irv;
  const float4* imc;     // 4 inverse masses
  const uint8_t* valid;

  __device__ __forceinline__ void load(int k, Slot& s) const {
    s.valid = __ldg(valid + k);
    s.t = __ldg(tets + k);
    for (int e = 0; e < 9; ++e) s.ir[e] = __ldg(irp + (size_t)k * 9 + e);
    s.irv = __ldg(irv + k);
    s.w = __ldg(imc + k);
  }
};

// Projects a valid slot's tet in place on the planes; returns det F - 1.
__device__ __forceinline__ float solve_slot(const Slot& s, float* X, float* Y,
                                            float* Z, const FrameParams& P) {
  const int ids[4] = {s.t.x, s.t.y, s.t.z, s.t.w};
  float p[4][3];
  for (int c = 0; c < 4; ++c) {
    p[c][0] = X[ids[c]];
    p[c][1] = Y[ids[c]];
    p[c][2] = Z[ids[c]];
  }
  const float w[4] = {s.w.x, s.w.y, s.w.z, s.w.w};
  const float verr = nh::solve_tet(p, s.ir, s.irv, w, P.dev_scale,
                                   P.vol_scale, P.gamma);
  for (int c = 0; c < 4; ++c) {
    X[ids[c]] = p[c][0];
    Y[ids[c]] = p[c][1];
    Z[ids[c]] = p[c][2];
  }
  return verr;
}

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
                int walk, FrameParams P) {
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
  const Tables tab{slot_tets, slot_irp, slot_irv, slot_imc, slot_valid};

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

    // the level walk; each thread prefetches the next level's tables of
    // its first slot (slot tid) before it solves the current level
    float verr = 0.0f;
    const bool has = tid < C;
    if (walk == kWarpWalk) {
      if (tid < 32) {
        Slot next{};
        if (has) tab.load(tid, next);
        for (int l = 0; l < L; ++l) {
          const Slot cur = next;
          if (has && l + 1 < L) tab.load((l + 1) * C + tid, next);
          if (has && cur.valid) verr += solve_slot(cur, X, Y, Z, P);
          __syncwarp();
        }
      }
      __syncthreads();
    } else {
      Slot next{};
      if (has) tab.load(tid, next);
      for (int l = 0; l < L; ++l) {
        const Slot cur = next;
        if (has && l + 1 < L) tab.load((l + 1) * C + tid, next);
        if (has && cur.valid) verr += solve_slot(cur, X, Y, Z, P);
        for (int slot = tid + kThreads; slot < C; slot += kThreads) {
          Slot wide;
          tab.load(l * C + slot, wide);
          if (wide.valid) verr += solve_slot(wide, X, Y, Z, P);
        }
        __syncthreads();
      }
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

// Lets the kernel take the shared memory of n particles on the current
// device; returns the CUDA error (0 = set).  The attribute is one value per
// kernel: the wrapper calls this before the first launch on a device and
// again before a launch for a larger n.
int gs_frame_prepare(int n) {
  return (int)cudaFuncSetAttribute(gs_frame_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)gs_frame_smem_bytes(n));
}

// Launches one frame on `stream`; returns cudaGetLastError() (0 = launched).
int gs_frame_launch(const void* pos_in, const void* vel_in, void* pos_out,
                    void* prev_out, void* vel_out, void* vol_err,
                    const void* slot_tets, const void* slot_irp,
                    const void* slot_irv, const void* slot_imc,
                    const void* slot_valid, const void* inv_mass,
                    const void* grab_id, const void* grab_pos, int B, int N,
                    int L, int C, int G, int S, int num_tets, int walk,
                    FrameParams P, void* stream) {
  const size_t smem = gs_frame_smem_bytes(N);
  gs_frame_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pos_in, (const float*)vel_in, (float*)pos_out,
      (float*)prev_out, (float*)vel_out, (float*)vol_err,
      (const int4*)slot_tets, (const float*)slot_irp, (const float*)slot_irv,
      (const float4*)slot_imc, (const uint8_t*)slot_valid,
      (const float*)inv_mass, (const int*)grab_id, (const float*)grab_pos, N,
      L, C, G, S, num_tets, walk, P);
  return (int)cudaGetLastError();
}

const char* gs_frame_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
