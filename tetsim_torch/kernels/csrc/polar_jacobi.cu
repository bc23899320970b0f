// Polar shape-matching frames (Jacobi) of one body too large for one
// block's shared memory: the solve of tetsim_torch/solvers/polar.py with
// the particle state in global memory, one cooperative launch per frame.
//
// Replaces no TPU kernel: for such a body the JAX package runs its XLA
// engine (tetsim_tpu/solvers/polar.py through tetsim_tpu/world.py's Body).
// The port's fused frame kernel (polar_frame.cu) keeps a body's nine
// particle planes in one block's shared memory, which holds at most 6,456
// particles; this kernel takes the bodies above that.
//
// Layout: pos / prev / vel [B, N, 3] as Body holds them, quaternions
// [B, M] of float4 (xyzw) in the mesh's tet order; the tables tets [M, 4],
// rest_centered [M, 4, 3], rest_volume [M], inv_mass [N] and inc_den [N]
// of TetArrays as they are, and two made from its inc_idx [N, K] (a
// particle's corner ids 4 t + k in ascending order, -1 padded) by
// kernels/polar_jacobi.py corner_tables: slots [M] of int4, the place
// j N + p of corner k of tet t in its particle p's row (inc_idx[p, j] =
// 4 t + k), and inc_count [N], the live entries of each row.  Scratch:
// delta [B, K, N] of float4 (the rest-volume-weighted goal deltas, each
// at its corner's place: a particle's deltas one row apart, in its row's
// order) and pred4 [B, N] of float4 (each particle's predicted position
// in the current substep).
//
// Design: the frame is one cooperative launch on a co-resident grid (every
// SM times the blocks one SM holds, cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Its passes deal their items (B x M tets, B x N particles) to the grid a
// warp's chunk at a time: chunk j runs on block j % G, warp j / G (mod the
// warps of a block), so that a pass of few items still spreads over every
// SM (for_items); a chunk is 32 items, or in the particle pass 32 / kGroup
// particles of kGroup lanes each.  A frame:
//   predict: each thread its particles, from the inputs: gravity into the
//     velocity, pinned particles (inv_mass 0) held, pos + vel * dt, into
//     pred4; grid barrier;
//   for each substep:
//     tet pass: each thread its tets: the 4 predicted corners (one 16-byte
//       load each), the centroid and the covariance with the rest corners
//       rotated by the tet's quaternion, extract_rotation from the identity
//       (polar_math.cuh), the new quaternion and its 4 rest-volume-weighted
//       goal deltas, each stored at its corner's place; grid barrier;
//     particle pass: kGroup lanes to a particle: each lane loads every
//       kGroup-th of its inc_count deltas (up to kRound at once, in one
//       round trip), the group's first lane takes them by shuffles and
//       sums them in row order (the plain path's order), divides by
//       max(inc_den, eps), collides, applies the grabs, sets the velocity
//       and, but in the last substep, writes the particle's prediction for
//       the next substep into pred4; grid barrier, but after the last
//       substep.
// 2 S barriers per frame, no atomics, deterministic.  A thread takes the
// same tets in every tet pass, so it reads back its own quaternion.  What
// another thread may have written before a barrier (pred4 and the
// substep's start in the particle pass, which deals its particles other
// than predict; pred4 in the tet pass; delta in the particle pass) is read
// with __ldcg (ld.global.cg: cached in L2, the card's point of coherence,
// never in the SM's own L1, which is not coherent with the other SMs'), as
// in gs_levels.cu.
//
// Numerics: predict, the particle sums, collide and velocity round every
// operation as the plain path does (predict is elementwise and rounds each
// step, so its bits do not depend on which thread runs it); the tet
// arithmetic is contracted by nvcc into FMAs where it can, as in
// polar_frame.cu.  The tet body is the first design's (two launches per
// substep) and the particle pass adds the same deltas in the same order,
// so the frame keeps its bits.
//
// What bounds it on this card: at grid_mesh(20, 20, 20) (48,000 tets) the
// tet pass's dependent chain per thread (9 extract_rotation iterations with
// divides, a square root, a sine and a cosine): 48,000 threads give each
// SM about 11 warps, too few to hide the chain's latency.  The work is
// 1,615 flops per tet (78 MFLOP per substep, 1.2 us at the FP32 peak).
// The first design launched two kernels per substep, enqueued from the
// host (10 per frame at 5 substeps), and its particle pass walked inc_idx:
// each delta's load waited for its index's, a chain of 2 K dependent
// loads per particle (9.1-9.8 us per substep on an H100, as long as the
// tet pass).  Here a particle's deltas sit at known places and its lanes
// load them at once.  Registers are capped at 80 (3 blocks of 256 per
// SM): uncapped, the particle pass's loads in flight take more and leave
// 2 blocks.  Measured on an H100 (profile_frame.py --phases, PERF.md), per
// substep on block 0 at B = 1: the tet pass about 13,600 SM cycles, the
// particle pass 5,400 and each barrier 4,300 (1.44 us alone), 0.071 ms
// of device time per frame.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "polar_math.cuh"

namespace cg = cooperative_groups;

// Scalars of one frame, computed in float32 on the host.
struct JacobiParams {
  float dt;      // substep length
  float gdt;     // gravity * dt
  float k_fric;  // min(1, dt * friction)
  float wmin[3];
  float wmax[3];
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;  // __launch_bounds__' blocks per SM: at most
                               // 80 registers a thread
constexpr int kGroup = 4;      // lanes per particle in the particle pass
constexpr int kRound = 24;  // deltas a group loads at once: a grid's valence
constexpr int kPerLane = kRound / kGroup;
static_assert(kRound % kGroup == 0 && 32 % kGroup == 0, "kGroup");

#ifdef POLAR_JACOBI_PHASES
// A build for profile_frame.py --phases only: block 0 of the launch sums
// the SM cycles of its predict phase, its tet passes, its particle passes
// and its grid barriers, each phase ended by a __syncthreads() that the
// shipped build does not have, and counts the substeps.
__device__ unsigned long long phase_cycles[5];
#endif

// Runs f(i, valid, sub) for the items that fall to this thread, `group`
// lanes to an item: chunk j of 32 / group items on block j % G, warp
// (j / G) % kWarps, round j / (G kWarps); lane l takes item
// j 32 / group + l / group as its place sub = l % group.  Every lane of a
// warp makes the same calls (valid is false past n).
template <int group, class F>
__device__ __forceinline__ void for_items(int n, F&& f) {
  constexpr int per_chunk = 32 / group;
  const int lane = threadIdx.x & 31;
  const int chunks = (n + per_chunk - 1) / per_chunk;
  const int step = gridDim.x * kWarps;
  for (int j = blockIdx.x + gridDim.x * (threadIdx.x >> 5); j < chunks;
       j += step) {
    const int i = j * per_chunk + lane / group;
    f(i, i < n, lane % group);
  }
}

// A particle's prediction: gravity into the velocity, a pinned particle
// (inv_mass 0) held, x + v dt, every operation rounded.
__device__ __forceinline__ float4 predict(float x, float y, float z, float vx,
                                          float vy, float vz, float im,
                                          const JacobiParams& P) {
  vy = __fadd_rn(vy, P.gdt);
  if (!(im > 0.0f)) vx = vy = vz = 0.0f;
  return make_float4(__fadd_rn(x, __fmul_rn(vx, P.dt)),
                     __fadd_rn(y, __fmul_rn(vy, P.dt)),
                     __fadd_rn(z, __fmul_rn(vz, P.dt)), 0.0f);
}

// Tet t of body b: its new quaternion and its 4 weighted goal deltas, at
// their corners' places in delta.
__device__ __forceinline__ void tet_pass(
    int b, int t, const float4* pred4, const float4* quat_src,
    float4* quat_out, float4* delta, const int4* __restrict__ tets,
    const int4* __restrict__ slots, const float* __restrict__ rc,
    const float* __restrict__ rest_volume, int N, int M, int K, int iters) {
  const float4* bp = pred4 + (size_t)b * N;
  const int4 tt = tets[t];
  const int ids[4] = {tt.x, tt.y, tt.z, tt.w};
  float pc[4][3], rest[4][3];
  for (int k = 0; k < 4; ++k) {
    const float4 p = __ldcg(bp + ids[k]);
    pc[k][0] = p.x;
    pc[k][1] = p.y;
    pc[k][2] = p.z;
    for (int r = 0; r < 3; ++r) rest[k][r] = rc[((size_t)t * 4 + k) * 3 + r];
  }
  for (int r = 0; r < 3; ++r) {
    const float c = (((pc[0][r] + pc[1][r]) + pc[2][r]) + pc[3][r]) * 0.25f;
    for (int k = 0; k < 4; ++k) pc[k][r] = pc[k][r] - c;
  }
  const size_t q_at = (size_t)b * M + t;
  const float4 q = __ldcg(quat_src + q_at);
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
  float4* dl = delta + (size_t)b * K * N;
  const int4 st = slots[t];
  const int at[4] = {st.x, st.y, st.z, st.w};
  for (int k = 0; k < 4; ++k) {
    float g[3];
    polar::qrot(rest[k], qn, g);
    dl[at[k]] = make_float4(__fmul_rn(g[0] - pc[k][0], w),
                        __fmul_rn(g[1] - pc[k][1], w),
                        __fmul_rn(g[2] - pc[k][2], w), 0.0f);
  }
}

// Particle i = b N + v (where `valid`) in a substep that starts at pos,
// run by the kGroup lanes of its group, `sub` the lane's place in it:
// each lane loads every kGroup-th of the particle's deltas, lane 0 takes
// them by shuffles and sums them in row order, then collides, grabs, sets
// the velocity and, with `next`, writes the prediction for the next
// substep.  Every lane of the warp must call it (the shuffles).
__device__ __forceinline__ void particle_pass(
    int i, bool valid, int sub, bool next, const float* pos, float* pos_out,
    float* prev_out, float* vel_out, float4* pred4, const float4* delta,
    const float* __restrict__ inv_mass, const int* __restrict__ inc_count,
    const float* __restrict__ inc_den, const int* __restrict__ grab_id,
    const float* __restrict__ grab_pos, int N, int K, int G,
    const JacobiParams& P) {
  const int b = valid ? i / N : 0;
  const int v = valid ? i - b * N : 0;
  const bool own = valid && sub == 0;
  const size_t base = (size_t)i * 3;
  float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (own) {
    p = __ldcg(pred4 + i);
    px = __ldcg(pos + base);
    py = __ldcg(pos + base + 1);
    pz = __ldcg(pos + base + 2);
  }
  const float im = valid ? inv_mass[v] : 0.0f;
  const int n = im > 0.0f ? inc_count[v] : 0;  // the live deltas
  const float4* dl = delta + (size_t)b * K * N + v;  // entry j at j N
  const int first = (threadIdx.x & 31) & ~(kGroup - 1);
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  for (int j0 = 0; j0 < K; j0 += kRound) {  // the same count in every lane
    float4 d[kPerLane];  // entry j0 + sub + kGroup u
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int j = j0 + sub + kGroup * u;
      d[u] = j < n ? __ldcg(dl + (size_t)j * N)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int jj = 0; jj < kRound; ++jj) {  // entry j0 + jj, in row order
      const float4 e = d[jj / kGroup];
      const int from = first | (jj % kGroup);
      const float ex = __shfl_sync(0xffffffffu, e.x, from);
      const float ey = __shfl_sync(0xffffffffu, e.y, from);
      const float ez = __shfl_sync(0xffffffffu, e.z, from);
      if (j0 + jj < n) {
        nx = __fadd_rn(nx, ex);
        ny = __fadd_rn(ny, ey);
        nz = __fadd_rn(nz, ez);
      }
    }
  }
  if (!own) return;
  float x = p.x, y = p.y, z = p.z;
  if (im > 0.0f) {
    const float den = fmaxf(inc_den[v], polar::kEps);
    x = __fadd_rn(x, nx / den);
    y = __fadd_rn(y, ny / den);
    z = __fadd_rn(z, nz / den);
  }
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
  const float vx = (x - px) / P.dt, vy = (y - py) / P.dt,
              vz = (z - pz) / P.dt;
  prev_out[base] = px;
  prev_out[base + 1] = py;
  prev_out[base + 2] = pz;
  pos_out[base] = x;
  pos_out[base + 1] = y;
  pos_out[base + 2] = z;
  vel_out[base] = vx;
  vel_out[base + 1] = vy;
  vel_out[base + 2] = vz;
  if (next) pred4[i] = predict(x, y, z, vx, vy, vz, im, P);
}

// S substeps of B bodies in one cooperative launch (the design note).  The
// outputs, pred4 and delta are written between barriers, so they are plain
// pointers (no read-only cache).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
polar_jacobi_frame_kernel(const float* __restrict__ pos_in,   // [B,N,3]
                          const float* __restrict__ vel_in,   // [B,N,3]
                          const float4* __restrict__ quat_in,  // [B,M]
                          float* pos_out, float* prev_out,    // [B,N,3]
                          float* vel_out,                     // [B,N,3]
                          float4* quat_out,                   // [B,M]
                          float4* delta,                      // [B,K,N]
                          float4* pred4,                      // [B,N]
                          const int4* __restrict__ tets,      // [M]
                          const int4* __restrict__ slots,     // [M]
                          const float* __restrict__ rc,       // [M,4,3]
                          const float* __restrict__ rest_volume,  // [M]
                          const float* __restrict__ inv_mass,     // [N]
                          const int* __restrict__ inc_count,      // [N]
                          const float* __restrict__ inc_den,      // [N]
                          const int* __restrict__ grab_id,        // [B,G]
                          const float* __restrict__ grab_pos,     // [B,G,3]
                          int B, int N, int M, int K, int G, int S, int iters,
                          JacobiParams P) {
  cg::grid_group grid = cg::this_grid();
#ifdef POLAR_JACOBI_PHASES
  const bool mark = blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long acc[4] = {0, 0, 0, 0};
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
  for_items<1>(B * N, [&](int i, bool valid, int) {
    if (!valid) return;
    const size_t at = (size_t)i * 3;
    pred4[i] = predict(pos_in[at], pos_in[at + 1], pos_in[at + 2],
                       vel_in[at], vel_in[at + 1], vel_in[at + 2],
                       inv_mass[i % N], P);
  });
  PHASE_END(0);
  grid.sync();
  PHASE_END(3);
  for (int s = 0; s < S; ++s) {
    const float4* quat = s == 0 ? quat_in : quat_out;
    for_items<1>(B * M, [&](int i, bool valid, int) {
      if (!valid) return;
      const int b = i / M;
      tet_pass(b, i - b * M, pred4, quat, quat_out, delta, tets, slots, rc,
               rest_volume, N, M, K, iters);
    });
    PHASE_END(1);
    grid.sync();
    PHASE_END(3);
    const float* pos = s == 0 ? pos_in : pos_out;
    const bool next = s + 1 < S;
    for_items<kGroup>(B * N, [&](int i, bool valid, int sub) {
      particle_pass(i, valid, sub, next, pos, pos_out, prev_out, vel_out,
                    pred4, delta, inv_mass, inc_count, inc_den, grab_id,
                    grab_pos, N, K, G, P);
    });
    PHASE_END(2);
    if (next) {
      grid.sync();
      PHASE_END(3);
    }
  }
#ifdef POLAR_JACOBI_PHASES
  if (mark) {
    for (int k = 0; k < 4; ++k) phase_cycles[k] += acc[k];
    phase_cycles[4] += S;
  }
#endif
#undef PHASE_END
}

#ifdef POLAR_JACOBI_PHASES
// iters grid barriers and nothing else: the cost of one at a grid size.
__global__ void __launch_bounds__(kThreads) sync_probe_kernel(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < iters; ++k) grid.sync();
}
#endif

cudaError_t cooperative(const void* kernel, int grid, void** args,
                        void* stream) {
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args, 0, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return err != cudaSuccess ? err : last;
}

}  // namespace

extern "C" {

int polar_jacobi_launches_per_frame() { return 1; }

int polar_jacobi_threads() { return kThreads; }

int polar_jacobi_group() { return kGroup; }

// Blocks of the frame kernel that one SM of the current device holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the device's SM
// count.  Returns the CUDA error.
int polar_jacobi_occupancy(int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, polar_jacobi_frame_kernel, kThreads, 0);
  return (int)err;
}

// Launches a frame of S substeps on `stream`: one cooperative launch of
// `grid` blocks, which must all be resident at once
// (polar_jacobi_occupancy).  Returns the launch's error (0 = launched).
int polar_jacobi_launch(const void* pos_in, const void* vel_in,
                        const void* quat_in, void* pos_out, void* prev_out,
                        void* vel_out, void* quat_out, void* delta,
                        void* pred4, const void* tets, const void* slots,
                        const void* rc, const void* rest_volume,
                        const void* inv_mass, const void* inc_count,
                        const void* inc_den, const void* grab_id,
                        const void* grab_pos, int B, int N, int M, int K,
                        int G, int S, int iters, int grid, JacobiParams P,
                        void* stream) {
  void* args[] = {&pos_in,  &vel_in,   &quat_in,     &pos_out,  &prev_out,
                  &vel_out, &quat_out, &delta,       &pred4,    &tets,
                  &slots,   &rc,       &rest_volume, &inv_mass, &inc_count,
                  &inc_den, &grab_id,  &grab_pos,    &B,        &N,
                  &M,       &K,        &G,           &S,        &iters,
                  &P};
  return (int)cooperative((const void*)polar_jacobi_frame_kernel, grid, args,
                          stream);
}

#ifdef POLAR_JACOBI_PHASES
// One cooperative launch of `grid` blocks that runs `iters` grid barriers.
int polar_jacobi_sync_probe(int grid, int iters, void* stream) {
  void* args[] = {&iters};
  return (int)cooperative((const void*)sync_probe_kernel, grid, args, stream);
}

// Copies phase_cycles to out[5] (predict, tet passes, particle passes,
// barriers, substeps) and zeroes it; returns the CUDA error.
int polar_jacobi_phase_cycles(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
  return (int)err;
}
#endif

const char* polar_jacobi_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
