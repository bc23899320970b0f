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
// Design: one thread-block cluster of cs blocks per body (cs = 1, 2, 4, 8
// or 16; the host picks it, polar_fused.cluster_size), one launch per
// frame, the substep loop inside.  Each block keeps a full replica of the
// body's nine particle planes (pos, prev, vel; x, y, z) in its shared
// memory (9 * 4 * N bytes, 44 KB for the dragon).  Block r of a cluster
// owns tets [r * Mt, (r + 1) * Mt) and particles [r * Nt, (r + 1) * Nt),
// Mt = ceil(M / cs), Nt = ceil(N / cs).  Each substep:
//   1. every block predicts all N particles on its own replica (the same
//      arithmetic on the same bits, so the replicas stay identical), then
//      __syncthreads();
//   2. phase A: block r solves its tets, a thread per tet: it reads the
//      tet's quaternion (quat_in in the first substep, quat_out after it;
//      only block r touches them) and writes it to quat_out, and writes
//      the tet's four weighted deltas to a global scratch [B, 4M] of
//      float4, which stays in L2;
//   3. cluster.sync();
//   4. phase B: block r's threads take its particles, a thread per
//      particle: each adds its incident deltas in the column order of
//      inc_idx, eight loads in flight at a time; the sum order is fixed,
//      so the kernel is deterministic, with no atomics; then collide, grab
//      and velocity update;
//   5. the new x, y, z, vx, vy, vz go to all cs replicas, through
//      distributed shared memory (cluster.map_shared_rank);
//   6. cluster.sync(), after which no block reads or writes a peer's
//      shared memory until step 5 of the next substep.
// The deltas another SM of the cluster wrote are read with plain loads:
// cluster.sync() is a release by every thread of the cluster and an
// acquire by this one (barrier.cluster.arrive.release / wait.acquire), so
// the loads after it see those writes, L1 included.  They stay in L2 and
// not in the owning block's shared memory: at cs = 1 (B = 132, one block
// per SM) the dragon's 4 * 3840 deltas take 240 KB, more than a block has
// beside its 44 KB of planes, and a probe build that read them from the
// owners' shared memory over DSMEM where they fit gathered them more
// slowly than from L2 on an H100.  The per-tet arithmetic and the
// per-particle sum order do not depend on cs, so every cs gives the bits
// of cs = 1, which is the first design (a block per body) with its two
// __syncthreads() per substep as cluster barriers of one block.  At the
// end, block r writes its own particles of pos, prev and vel.
//
// What bounds it: FP32 operations.  Counted from this code
// (kernels/polar_fused.py frame_flops), a tet costs 391 + 136 * iters flops
// per substep, 1,615 at the default 9 iterations of extract_rotation,
// which are most of it; a particle 19 plus 3 per incident corner.  That is
// 6.3 MFLOP per dragon substep and 125 MFLOP per frame at 20 substeps
// (1.872 us at 67 TFLOP/s), against 0.63 MB of tables and state read and
// written once.  On one SM a body could not come near that bound: 512
// threads ran 7.5 tets each in series per substep, each a chain of
// dependent divides, square roots, sines and cosines, so a B = 1 frame
// took 1.6665 ms (75 GFLOP/s) while 131 SMs idled.  A cluster of 16 blocks
// gives one body 16 SMs and each thread about one tet per substep (240 per
// block), at the price of two cluster barriers per substep and the 6N
// replica stores of phase B over DSMEM.  What is left is latency: one
// tet's dependent chain in phase A, the gather of phase B (a particle's
// ~12 deltas from L2, eight loads in flight) and the two barriers;
// profile_frame.py --phases measures each (PERF.md).  A batch takes the
// largest cs at which its B clusters run at once with one block per SM
// (cudaOccupancyMaxActiveClusters): on an H100, B = 1 takes 16, B = 8
// takes 8 (the card places 7 clusters of 16 at once), B = 132 takes 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "polar_math.cuh"

namespace cg = cooperative_groups;

#ifdef POLAR_FRAME_PHASES
// A build for profile_frame.py --phases only: block 0 sums the SM cycles
// of each phase of a substep (predict, phase A, barrier 1, phase B with the
// replica stores, barrier 2; each phase end after a __syncthreads() that
// the shipped build does not have) and counts the substeps.
__device__ unsigned long long phase_cycles[6];
#define PHASE_MARK(t) \
  __syncthreads();    \
  const long long t = clock64()
#define PHASE_AT(t) const long long t = clock64()
#else
#define PHASE_MARK(t)
#define PHASE_AT(t)
#endif

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
constexpr int kChunk = 8;  // incident deltas a particle loads at once

// Shared memory of a block: the nine particle planes.
size_t smem_bytes(int n) { return (size_t)9 * n * sizeof(float); }

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

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int mt = (M + cs - 1) / cs, nt = (N + cs - 1) / cs;
  const int t_lo = min(M, r * mt), t_hi = min(M, t_lo + mt);
  const int i_lo = min(N, r * nt), i_hi = min(N, i_lo + nt);
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
    PHASE_AT(t0);
    // 1. predict on this block's replica; each thread owns particles tid,
    // tid + kThreads, ... here as in the load, so no barrier before it
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
    PHASE_AT(t1);

    // 2. phase A: one tet per thread over this block's tets
    const float4* qsrc = s == 0 ? qin : qout;
    for (int t = t_lo + tid; t < t_hi; t += kThreads) {
      const int4 tt = tets[t];
      const int ids[4] = {tt.x, tt.y, tt.z, tt.w};
      float pc[4][3];
      for (int k = 0; k < 4; ++k) {
        pc[k][0] = X[ids[k]];
        pc[k][1] = Y[ids[k]];
        pc[k][2] = Z[ids[k]];
      }
      for (int c3 = 0; c3 < 3; ++c3) {
        const float c =
            (((pc[0][c3] + pc[1][c3]) + pc[2][c3]) + pc[3][c3]) * 0.25f;
        for (int k = 0; k < 4; ++k) pc[k][c3] = pc[k][c3] - c;
      }
      float rest[4][3];
      {
        const float4 r0 = rc[3 * t], r1 = rc[3 * t + 1], r2 = rc[3 * t + 2];
        const float flat[12] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                                r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
        for (int k = 0; k < 4; ++k)
          for (int c3 = 0; c3 < 3; ++c3) rest[k][c3] = flat[3 * k + c3];
      }
      const float4 q = qsrc[t];
      float a[3][3];  // a[r][c] = sum_k pc[k][r] * rot(rest[k])[c]
      for (int k = 0; k < 4; ++k) {
        float rr[3];
        polar::qrot(rest[k], q, rr);
        for (int ro = 0; ro < 3; ++ro)
          for (int c = 0; c < 3; ++c)
            a[ro][c] = k == 0 ? pc[k][ro] * rr[c] : a[ro][c] + pc[k][ro] * rr[c];
      }
      const float4 inc =
          polar::extract_rotation(a, make_float4(0.0f, 0.0f, 0.0f, 1.0f), iters);
      const float4 qn = polar::qnormalize(polar::qmul(inc, q));
      qout[t] = qn;
      const float w = rest_volume[t];
      for (int k = 0; k < 4; ++k) {
        float g[3];
        polar::qrot(rest[k], qn, g);
        dl[4 * t + k] = make_float4((g[0] - pc[k][0]) * w,
                                    (g[1] - pc[k][1]) * w,
                                    (g[2] - pc[k][2]) * w, 0.0f);
      }
    }
    // 3. every block's deltas are written
    PHASE_MARK(t2);
    cluster.sync();
    PHASE_AT(t3);

    // 4. phase B: one particle per thread over this block's particles:
    // apply, collide, grab, velocity; 5. into every replica
    for (int i = i_lo + tid; i < i_hi; i += kThreads) {
      float x = X[i], y = Y[i], z = Z[i];
      if (inv_mass[i] > 0.0f) {
        float nx = 0.0f, ny = 0.0f, nz = 0.0f;
        const int* row = inc_idx + (size_t)i * K;
        // live entries come first, in order; kChunk of them are loaded
        // at once (indices, then deltas, each batch independent), then
        // added in column order
        for (int j0 = 0; j0 < K; j0 += kChunk) {
          int c[kChunk];
          for (int u = 0; u < kChunk; ++u)
            c[u] = j0 + u < K ? row[j0 + u] : -1;
          float4 d[kChunk];
          for (int u = 0; u < kChunk; ++u)
            d[u] = c[u] >= 0 ? dl[c[u]] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int u = 0; u < kChunk; ++u) {
            if (c[u] >= 0) {
              nx += d[u].x;
              ny += d[u].y;
              nz += d[u].z;
            }
          }
          if (c[kChunk - 1] < 0) break;
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
      const float vx = (x - px) / P.dt, vy = (y - py) / P.dt,
                  vz = (z - pz) / P.dt;
      for (int q = 0; q < cs; ++q) {
        float* peer = cluster.map_shared_rank(smem, q);  // replica q's planes
        peer[i] = x;
        peer[N + i] = y;
        peer[2 * N + i] = z;
        peer[6 * N + i] = vx;
        peer[7 * N + i] = vy;
        peer[8 * N + i] = vz;
      }
    }
    // 6. every replica is whole again
    PHASE_MARK(t4);
    cluster.sync();
#ifdef POLAR_FRAME_PHASES
    if (blockIdx.x == 0 && tid == 0) {
      const long long t5 = clock64(), t[6] = {t0, t1, t2, t3, t4, t5};
      for (int k = 0; k < 5; ++k) phase_cycles[k] += t[k + 1] - t[k];
      phase_cycles[5] += 1;
    }
#endif
  }

  float* pout = pos_out + (size_t)b * N * 3;
  float* qprev = prev_out + (size_t)b * N * 3;
  float* vout = vel_out + (size_t)b * N * 3;
  for (int i = i_lo + tid; i < i_hi; i += kThreads) {
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

// The shared memory that leaves room for one block of n particles on an
// SM of the current device: at least half the SM's.
cudaError_t one_per_sm(int n, size_t* smem) {
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  const size_t half = (size_t)per_sm / 2 + 1;
  *smem = smem_bytes(n) > half ? smem_bytes(n) : half;
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

int polar_frame_threads() { return kThreads; }

size_t polar_frame_smem_bytes(int n) { return smem_bytes(n); }

// Lets the kernel take the shared memory of n particles, and at least half
// an SM's for the occupancy query, and clusters of up to 16 blocks, on the
// current device; returns the CUDA error (0 = set).  The shared-memory
// attribute is one value per kernel: the wrapper calls this before the
// first launch on a device and again before a launch for a larger n.
int polar_frame_prepare(int n) {
  size_t most = 0;
  cudaError_t err = one_per_sm(n, &most);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      polar_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)most);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      polar_frame_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// How many clusters of cs blocks of n particles the current device runs at
// once with one block on each SM (cudaOccupancyMaxActiveClusters, asked
// for at least half an SM's shared memory a block) into *count; returns
// the CUDA error (0 = answered).  Needs polar_frame_prepare(n) first.
int polar_frame_active_clusters(int n, int cs, int* count) {
  size_t smem = 0;
  const cudaError_t err = one_per_sm(n, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cs, cs, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(count, polar_frame_kernel, &cfg);
}

// Launches one frame of B bodies, a cluster of cs blocks each, on
// `stream`; returns the launch's error, then cudaGetLastError() (0 =
// launched).
int polar_frame_launch(const void* pos_in, const void* vel_in,
                       const void* quat_in, void* pos_out, void* prev_out,
                       void* vel_out, void* quat_out, void* delta,
                       const void* tets, const void* rc,
                       const void* rest_volume, const void* inv_mass,
                       const void* inc_idx, const void* inc_den,
                       const void* grab_id, const void* grab_pos, int B,
                       int cs, int N, int M, int K, int G, int S, int iters,
                       PolarParams P, void* stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config(B, cs, smem_bytes(N), (cudaStream_t)stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, polar_frame_kernel, (const float*)pos_in, (const float*)vel_in,
      (const float4*)quat_in, (float*)pos_out, (float*)prev_out,
      (float*)vel_out, (float4*)quat_out, (float4*)delta, (const int4*)tets,
      (const float4*)rc, (const float*)rest_volume, (const float*)inv_mass,
      (const int*)inc_idx, (const float*)inc_den, (const int*)grab_id,
      (const float*)grab_pos, N, M, K, G, S, iters, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef POLAR_FRAME_PHASES
// Copies phase_cycles to out[6] and zeroes it; returns the CUDA error.
int polar_frame_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
  const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
  return (int)err;
}
#endif

const char* polar_frame_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
