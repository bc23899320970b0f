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
// Design: one launch per frame.  Each body runs on one thread-block
// cluster of cs blocks (1, 2, 4, 8 or 16; the host picks the largest at
// which the batch's clusters run at once with one block per SM,
// polar_fused.cluster_size), the substep loop inside.  Block r of a
// cluster owns particles [r * Nt, (r + 1) * Nt), Nt = ceil(N / cs), and
// the slots [r * Ct, (r + 1) * Ct) of every level, Ct = ceil(C / cs)
// (kernels/gs_levels.py level_plan).  The positions live in a float4 copy
// pos4 [B, N] in global memory, so a corner is one 16-byte load and one
// store.  A substep:
//   1. predict: each thread its particles (velocity plus gravity, gated by
//      inv_mass > 0; the start saved as prev, the prediction into pos4);
//   2. cluster.sync();
//   3. for each level: each thread its slots (one pass where Ct <= 256):
//      it reads its tet's 4 corners, projects it (nh::solve_tet,
//      nh_math.cuh), writes them back (a level's tets share no vertex, so
//      no race) and writes det F - 1 (0 for a padded slot) to the scratch
//      row err[b, l]; the tables of its first slot of the next level were
//      loaded during this one; then cluster.sync();
//   4. collide (world bounds, the ground with friction, grab override,
//      velocity), each thread its own particles, and the volume sums: a
//      warp each takes a (level, 256 slots in a row) of err and sums it in
//      the first design's tree (block_sum's pairs) into partial[b, l, vb];
//      block 0 adds the partials in the first design's strided order into
//      vol_err[b, s] / num_tets after the next barrier (the next substep's
//      first, or one more at the end of the frame).  The next substep's
//      predict of a particle falls to the thread that collided it, so no
//      barrier between them.
// L + 1 cluster barriers per substep and one per frame, where the first
// design made L + 2 host launches per substep.  No block synchronises
// inside a level.  The volume sums are the first design's (a tree over
// each level block of 256 slots, then the collide block's strided sum),
// so every cs gives its bits, vol_err included.
//
// Visibility.  A level reads corners that other blocks of the cluster, on
// other SMs, wrote in earlier levels, and collide and the sums read what
// the levels wrote.  cluster.sync() is barrier.cluster.arrive.release /
// barrier.cluster.wait.acquire: every write before it is visible, at
// cluster scope, to every read after it.  The SMs' L1 caches are not
// coherent with each other, so pos4, err and partial are read with __ldcg
// (ld.global.cg: cached in L2 only, never in L1), which can never see a
// line that an earlier read left in this SM's L1; L2 is the card's point
// of coherence, where the release put the other blocks' stores.  A
// particle's prev is written and read by one thread, and the tables are
// read-only for the launch (__ldg).  The state stays in global memory
// (148 KB of pos4 for grid_mesh(20, 20, 20), in L2), so a body of any size
// fits.
//
// Numerics: predict, collide and velocity round every operation as the
// plain path does; the tet projection is contracted by nvcc into FMAs
// where it can.
//
// What bounds it on this card.  grid_mesh(20, 20, 20) (9,261 particles,
// 48,000 tets) has 78 ordered levels of at most 1,520 tets, 421 flops per
// tet: 20 MFLOP per substep, 0.3 us at the FP32 peak.  The first design
// launched L + 2 = 80 kernels per substep, each at most six blocks: a
// level launch took 4.5 us of device time and about 5.2 us of the host's
// enqueue (2.08 ms per frame on an H100).  Here a level is a chain: the corner loads from L2,
// one tet's projection, the stores and the cluster barrier, whose release
// waits for them.  The corners of a level are scattered, so each warp
// instruction that loads or stores them is a request of up to 32 lines:
// hence a float4 per corner (4 such requests a way, not 12) and a level's
// slots cut over every block of the cluster (a block runs 95 of the 1,520,
// not 256), and no block tree on the chain.  Measured on an H100
// (profile_frame.py --phases, PERF.md): at cs = 16, 2,250 SM cycles per
// level on block 0 and 1,470 waiting in the barrier after it (one cluster
// barrier alone 0.46 us), 0.79 ms per frame.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nh_math.cuh"

namespace cg = cooperative_groups;

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

#ifdef GS_LEVELS_PHASES
// A build for profile_frame.py --phases only: block 0 of the launch sums
// the SM cycles of its particle phases (the first predict, then collide
// with the next predict and the volume error), of its level phases and of
// its cluster barriers, each phase ended by a __syncthreads() that the
// shipped build does not have, and counts the substeps and levels.
__device__ unsigned long long phase_cycles[5];
#endif

// Sum of the block's values in the first design's fixed tree (red[j] +=
// red[j + s] for s = 128, 64, ..., 1); the last five steps run in warp 0
// as shuffles, which pair the same lanes.  Every thread of the block must
// call it; the sum is valid in thread 0 only.
__device__ __forceinline__ float block_sum(float x, float* red) {
  red[threadIdx.x] = x;
  __syncthreads();
  for (int s = kThreads / 2; s >= 32; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  float v = 0.0f;
  if (threadIdx.x < 32) {
    v = red[threadIdx.x];
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  }
  return v;
}

// The same tree over row[0 .. 256) (0 past n), taken by one warp: lane j
// holds row[j + 32 k], k = 0 .. 7, so the steps s = 128, 64, 32 add within
// a lane and the rest are shuffles.  The sum is valid in lane 0.
__device__ __forceinline__ float warp_tree(const float* row, int n) {
  const int lane = threadIdx.x & 31;
  float v[8];
  for (int k = 0; k < 8; ++k)
    v[k] = lane + 32 * k < n ? __ldcg(row + lane + 32 * k) : 0.0f;
  for (int k = 0; k < 4; ++k) v[k] += v[k + 4];
  for (int k = 0; k < 2; ++k) v[k] += v[k + 2];
  v[0] += v[1];
  for (int s = 16; s > 0; s >>= 1)
    v[0] += __shfl_down_sync(0xffffffffu, v[0], s);
  return v[0];
}

// Predict of one particle from (x, y, z) with velocity (vx, vy, vz):
// gravity, the pinned gate, the start saved as prev (AoS, component offset
// i), the new position into the kernel's float4 copy.
__device__ __forceinline__ void predict_one(float x, float y, float z,
                                            float vx, float vy, float vz,
                                            float im, float4* pos4,
                                            float* prev, size_t i,
                                            const LevelParams& P) {
  vy = __fadd_rn(vy, P.gdt);
  if (!(im > 0.0f)) vx = vy = vz = 0.0f;
  prev[i] = x;
  prev[i + 1] = y;
  prev[i + 2] = z;
  *pos4 = make_float4(__fadd_rn(x, __fmul_rn(vx, P.dt)),
                      __fadd_rn(y, __fmul_rn(vy, P.dt)),
                      __fadd_rn(z, __fmul_rn(vz, P.dt)), 0.0f);
}

// The level schedule's tables, read-only for the launch.
struct SlotTables {
  const int4* tets;      // [L,C]
  const float* irp;      // [L,C,9]
  const float* irv;      // [L,C]
  const float4* imc;     // [L,C]
  const uint8_t* valid;  // [L,C]
};

// One slot's constants in registers; live is false for a padded slot or a
// slot past the level.
struct Slot {
  bool live;
  int4 t;
  float4 wm;
  float ir[9];
  float irv;
};

// Slot `slot` of level l, where slot < hi (a block's slots end there).
__device__ __forceinline__ Slot load_slot(const SlotTables& T, int l,
                                          int slot, int hi, int C) {
  Slot q;
  const size_t k = (size_t)l * C + slot;
  q.live = false;
  if (slot < hi) {  // a padded slot's tables are loaded too: no wait on valid
    q.live = __ldg(T.valid + k);
    q.t = __ldg(T.tets + k);
    q.wm = __ldg(T.imc + k);
    for (int e = 0; e < 9; ++e) q.ir[e] = __ldg(T.irp + k * 9 + e);
    q.irv = __ldg(T.irv + k);
  }
  return q;
}

__global__ void __launch_bounds__(kThreads)
gs_levels_frame_kernel(const float* __restrict__ pos_in,   // [B,N,3]
                       const float* __restrict__ vel_in,   // [B,N,3]
                       float* __restrict__ pos,   // [B,N,3] out
                       float* __restrict__ prev,  // [B,N,3] out
                       float* __restrict__ vel,   // [B,N,3] out
                       float* vol_err,  // [B,S]
                       float4* pos4,    // [B,N] scratch, read across blocks
                       float* err,      // [B,L,C] scratch
                       float* partial,  // [B,L,nblk] scratch
                       const int4* __restrict__ slot_tets,    // [L,C]
                       const float* __restrict__ slot_irp,    // [L,C,9]
                       const float* __restrict__ slot_irv,    // [L,C]
                       const float4* __restrict__ slot_imc,   // [L,C]
                       const uint8_t* __restrict__ slot_valid,  // [L,C]
                       const float* __restrict__ inv_mass,    // [N]
                       const int* __restrict__ grab_id,       // [B,G]
                       const float* __restrict__ grab_pos,    // [B,G,3]
                       int N, int L, int C, int G, int S, int num_tets,
                       LevelParams P) {
  __shared__ float red[kThreads];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int nblk = (C + kThreads - 1) / kThreads;
  const int nt = (N + cs - 1) / cs, span = (C + cs - 1) / cs;
  const int i_lo = min(N, r * nt), i_hi = min(N, i_lo + nt);
  const int s_lo = min(C, r * span), s_hi = min(C, s_lo + span);
  const size_t body = (size_t)b * N * 3;
  float4* bpos = pos4 + (size_t)b * N;
  float* berr = err + (size_t)b * L * C;
  float* bpart = partial + (size_t)b * L * nblk;
  const int* gid = grab_id + (size_t)b * G;
  const float* gpos = grab_pos + (size_t)b * G * 3;
#ifdef GS_LEVELS_PHASES
  const bool mark = blockIdx.x == 0 && tid == 0;
  unsigned long long acc[3] = {0, 0, 0};
  long long t_mark = clock64();
#define PHASE_END(k)                 \
  __syncthreads();                   \
  if (mark) {                        \
    const long long now = clock64(); \
    acc[k] += now - t_mark;          \
    t_mark = now;                    \
  }
#else
#define PHASE_END(k)
#endif
  // block 0 adds substep s's virtual-block sums, each thread a fixed
  // stride of them, into vol_err[b, s]; every sum was written before the
  // cluster barrier that precedes this
  auto volume_error = [&](int s) {
    const int rows = L * nblk;
    float a = 0.0f;
    for (int j = tid; j < rows; j += kThreads) a += __ldcg(bpart + j);
    const float total = block_sum(a, red);
    if (tid == 0) vol_err[(size_t)b * S + s] = total / (float)num_tets;
  };

  for (int v = i_lo + tid; v < i_hi; v += kThreads) {
    const size_t i = body + 3 * (size_t)v;
    predict_one(pos_in[i], pos_in[i + 1], pos_in[i + 2], vel_in[i],
                vel_in[i + 1], vel_in[i + 2], inv_mass[v], bpos + v, prev, i,
                P);
  }
  PHASE_END(0);
  const SlotTables T = {slot_tets, slot_irp, slot_irv, slot_imc, slot_valid};
  Slot ahead = load_slot(T, 0, s_lo + tid, s_hi, C);
  for (int s = 0; s < S; ++s) {
    cluster.sync();
    PHASE_END(2);
    if (s > 0 && r == 0) volume_error(s - 1);
    PHASE_END(0);
    for (int l = 0; l < L; ++l) {
      for (int slot = s_lo + tid; slot < s_hi; slot += kThreads) {
        // the first pass's tables were loaded a level ahead; load the next
        // level's now, while this one's corners and chain run
        Slot q;
        if (slot == s_lo + tid) {
          q = ahead;
          ahead = load_slot(T, (l + 1) % L, slot, s_hi, C);
        } else {
          q = load_slot(T, l, slot, s_hi, C);
        }
        float verr = 0.0f;
        if (q.live) {
          const int ids[4] = {q.t.x, q.t.y, q.t.z, q.t.w};
          float p[4][3];
          for (int c = 0; c < 4; ++c) {
            const float4 x = __ldcg(bpos + ids[c]);
            p[c][0] = x.x;
            p[c][1] = x.y;
            p[c][2] = x.z;
          }
          const float w[4] = {q.wm.x, q.wm.y, q.wm.z, q.wm.w};
          verr = nh::solve_tet(p, q.ir, q.irv, w, P.dev_scale, P.vol_scale,
                               P.gamma);
          for (int c = 0; c < 4; ++c)
            bpos[ids[c]] = make_float4(p[c][0], p[c][1], p[c][2], 0.0f);
        }
        berr[(size_t)l * C + slot] = verr;
      }
      PHASE_END(1);
      cluster.sync();
      PHASE_END(2);
    }
    // collide this substep and predict the next, a particle per thread
    const bool last = s + 1 == S;
    for (int v = i_lo + tid; v < i_hi; v += kThreads) {
      const size_t i = body + 3 * (size_t)v;
      const float px = prev[i], py = prev[i + 1], pz = prev[i + 2];
      const float4 q = __ldcg(bpos + v);
      float x = fminf(fmaxf(q.x, P.wmin[0]), P.wmax[0]);
      float y = fminf(fmaxf(q.y, P.wmin[1]), P.wmax[1]);
      float z = fminf(fmaxf(q.z, P.wmin[2]), P.wmax[2]);
      if (y < 0.0f) {
        y = 0.0f;
        x = __fadd_rn(x, __fmul_rn(px - x, P.k_fric));
        z = __fadd_rn(z, __fmul_rn(pz - z, P.k_fric));
      }
      for (int g = 0; g < G; ++g) {  // the last grab on v wins
        if (gid[g] == v) {
          x = gpos[3 * g];
          y = gpos[3 * g + 1];
          z = gpos[3 * g + 2];
        }
      }
      const float vx = (x - px) / P.dt, vy = (y - py) / P.dt,
                  vz = (z - pz) / P.dt;
      if (last) {
        pos[i] = x;
        pos[i + 1] = y;
        pos[i + 2] = z;
        vel[i] = vx;
        vel[i + 1] = vy;
        vel[i + 2] = vz;
      } else {
        predict_one(x, y, z, vx, vy, vz, inv_mass[v], bpos + v, prev, i, P);
      }
    }
    // the virtual blocks' trees, a warp each, spread over the cluster
    constexpr int kWarps = kThreads / 32;
    for (int item = r * kWarps + tid / 32; item < L * nblk;
         item += cs * kWarps) {
      const int l = item / nblk, vb = item % nblk;
      const float sum = warp_tree(berr + (size_t)l * C + vb * kThreads,
                                  C - vb * kThreads);
      if ((tid & 31) == 0) bpart[item] = sum;
    }
    PHASE_END(0);
  }
  cluster.sync();
  if (r == 0) volume_error(S - 1);
#ifdef GS_LEVELS_PHASES
  if (mark) {
    for (int k = 0; k < 3; ++k) phase_cycles[k] += acc[k];
    phase_cycles[3] += S;
    phase_cycles[4] += (unsigned long long)S * L;
  }
#endif
#undef PHASE_END
}

#ifdef GS_LEVELS_PHASES
// iters cluster barriers and nothing else: the cost of one at a cluster
// size.
__global__ void __launch_bounds__(kThreads) sync_probe_kernel(int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int k = 0; k < iters; ++k) cluster.sync();
}
#endif

// The shared memory a block asks for so that an SM holds one block: just
// over half the SM's (the kernel uses none of it).
cudaError_t one_per_sm(size_t* smem) {
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  *smem = (size_t)per_sm / 2 + 1;
  return err;
}

// The launch shape of B bodies at cluster size cs.
cudaLaunchConfig_t launch_config(int B, int cs, size_t smem, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

int gs_levels_threads() { return kThreads; }

int gs_levels_launches_per_frame() { return 1; }

// Lets the kernel take just over half an SM's shared memory (one block per
// SM) and clusters of up to 16 blocks on the current device; returns the
// CUDA error (0 = set).
int gs_levels_prepare() {
  size_t smem = 0;
  cudaError_t err = one_per_sm(&smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gs_levels_frame_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gs_levels_frame_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return (int)err;
}

// How many clusters of cs blocks the current device runs at once with one
// block on each SM (cudaOccupancyMaxActiveClusters) into *count; returns
// the CUDA error (0 = answered).  Needs gs_levels_prepare() first.
int gs_levels_active_clusters(int cs, int* count) {
  size_t smem = 0;
  const cudaError_t err = one_per_sm(&smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cs, cs, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(count, gs_levels_frame_kernel,
                                             &cfg);
}

// Launches one frame of S substeps for B bodies, a cluster of cs blocks
// each, on `stream`; pos4 [B, N] (float4), slot_err [B, L, C] and
// partial [B, L, ceil(C / kThreads)] are scratch.
// Returns the launch's error, then cudaGetLastError() (0 = launched).
int gs_levels_launch(const void* pos_in, const void* vel_in, void* pos_out,
                     void* prev_out, void* vel_out, void* vol_err, void* pos4,
                     void* slot_err, void* partial, const void* slot_tets,
                     const void* slot_irp, const void* slot_irv,
                     const void* slot_imc, const void* slot_valid,
                     const void* inv_mass, const void* grab_id,
                     const void* grab_pos, int B, int cs, int N, int L, int C,
                     int G, int S, int num_tets, LevelParams P,
                     void* stream) {
  size_t smem = 0;
  cudaError_t err = one_per_sm(&smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config(B, cs, smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(
      &cfg, gs_levels_frame_kernel, (const float*)pos_in,
      (const float*)vel_in, (float*)pos_out, (float*)prev_out,
      (float*)vel_out, (float*)vol_err, (float4*)pos4, (float*)slot_err,
      (float*)partial,
      (const int4*)slot_tets, (const float*)slot_irp, (const float*)slot_irv,
      (const float4*)slot_imc, (const uint8_t*)slot_valid,
      (const float*)inv_mass, (const int*)grab_id, (const float*)grab_pos, N,
      L, C, G, S, num_tets, P);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

#ifdef GS_LEVELS_PHASES
// One launch of `clusters` clusters of cs blocks that runs `iters` cluster
// barriers.
int gs_levels_sync_probe(int clusters, int cs, int iters, void* stream) {
  size_t smem = 0;
  cudaError_t err = one_per_sm(&smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sync_probe_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sync_probe_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config(clusters, cs, smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, sync_probe_kernel, iters);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// Copies phase_cycles to out[5] (particle phases, level phases, barriers,
// substeps, levels walked) and zeroes it; returns the CUDA error.
int gs_levels_phase_cycles(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
  return (int)err;
}
#endif

const char* gs_levels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
