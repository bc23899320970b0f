// Polar shape-matching substeps on a grid_mesh box: the stencil engine of
// tetsim_torch/solvers/polar_grid.py on B boxes of one size.
//
// Replaces the TPU kernel tetsim_tpu/kernels/polar_stencil.py:_make_kernel
// (built by _build_call / _make_call) and follows the semantics of the XLA
// stencil engine tetsim_tpu/solvers/polar_grid.py, as the plain path
// tetsim_torch/solvers/polar_grid.py writes them.  Where K4 departs from
// that engine (it carries (pos, prev) instead of the velocity and multiplies
// by a precomputed 1 / max(den, eps)), this follows the engine: velocity in
// the state, num / max(den, eps), (x - prev) / dt.
//
// Layout: particle state as planes [B, 3, N] over the flat C-order vertex
// grid v = (i*gy + j)*gz + k, quaternions as [B, 24, C] (type t, component
// c at row 4t + c; C = nx*ny*nz real cubes in C order).  The TPU kernel's
// [rows, 128] planes, lane rolls and phantom lanes are only addressing: a
// thread computes its corner ids from (cube, type) directly.
//
// Design: two launches per substep, no atomics, deterministic.
//   A. One block per strip of W = kStrip consecutive cubes (C order) and
//      body, 6 W threads: thread (t, w) = threadIdx.x / W, % W solves type
//      t of cube w (solve_tet, the same function for K4 and K4a).  It
//      predicts its 4 corners from the substep's start state (predict is
//      elementwise and rounds every product, so every thread gets the same
//      bits for a vertex), forms the centroid and the covariance with the
//      rest corners rotated by its quaternion, runs extract_rotation from
//      the identity (polar_math.cuh, the grid engine's axis form), writes
//      the new quaternion, and keeps its 4 rest-volume-weighted goal deltas
//      in shared memory [6][4][3][W].  After one __syncthreads() the block
//      forms each (slab s, coordinate r, cube w) sum over types t = 0..5 in
//      order from 0 (a tet has at most one corner in a slab): the plain
//      path's accx[s], 24 floats per cube, written to a scratch [B, 24, C]
//      at row 3s + r, coalesced along the cubes.
//   B. One thread per vertex: it predicts itself again, adds the 8 slab
//      sums of the cubes it is a corner of in slab order s = 0..7 (the
//      engine's order), divides by max(den, eps), collides, applies the
//      grabs and sets the velocity.
// Substep 0 reads the inputs; later substeps update the outputs in place
// (a thread reads its own vertex, or its own quaternion, before it writes).
//
// Numerics: the accumulation, the predict and the collide round every
// operation as the plain path does; the tet arithmetic is contracted by
// nvcc into FMAs where it can, so a result may differ from the plain
// path's in its last bits.  The sums are the first design's (which summed
// 72 corner deltas per cube in pass B in the same order), so K4 gives its
// bits.
//
// What bounds it: FP32 arithmetic.  A tet costs 391 + 136 * iters flops
// per substep (kernels/polar_stencil.py frame_flops), 1.70 GFLOP per
// substep for the 56^3 box (25.6 us at 67 TFLOP/s), against about 50 MB of
// state and quaternions read and written once.  Measured at 56^3
// (profile_frame.py --parent / --variants, NVIDIA H100 80GB HBM3 at 700 W):
// the first design kept all 72 corner deltas of a cube in a global scratch
// [B, 72, C], 50.6 MB written by pass A and read back by pass B each
// substep; its pass A took 106.6-106.9 us (48 registers, 128 threads,
// 1,280 resident threads per SM) and pass B 37.4-37.6 us, most of it that
// read, 0.146 ms per substep.  The 24 slab sums are 16.9 MB each way: pass
// B takes 11.0 us, pass A 111.2 us (54 registers, 192 threads, 1,152
// resident threads per SM; the sums cost it about 4.6 us), 0.123 ms per
// substep.  Pass A now bounds K4: 1.7x K9's measured pass
// (extract_rotation.cu, 0.064 ms per 1,048,576 lanes), the rest of a tet's
// arithmetic (4 predicted corners, 8 quaternion rotations, the covariance,
// the normalisation) on top.  Strips of 64 cubes took the same time;
// predicting a strip's corners once into shared memory, and 7 blocks per
// SM at 40 registers, were no faster.

// K4a, the slab form: replaces the TPU kernel
// tetsim_tpu/kernels/polar_stencil.py:_make_call_acc (_build_call with
// epilogue=False), which stops a slab's substep after the accumulation and
// returns the predicted positions, the new quaternions and the unapplied
// numerator planes; make_grid_sharded_stepper completes the boundary
// planes with a ppermute per neighbour and applies them.
//
// Here a substep on the slabs of one device is two launches, as K4's: pass
// A (polar_grid_tet_kernel over blockIdx.y = slab, the inverse masses a
// row per slab) and one vertex pass (polar_slab_vertex_kernel) that takes
// in what the first design did in three steps (B1: predict and the inverse
// stencil into numerator planes; the SlabMesh halo adding each shared
// plane's neighbour partial; B2: apply, collide, grab, velocity): a vertex
// predicts itself and gathers its own slab's sums, as B1 did; a vertex on
// plane 0 of slab i > 0 then adds the gather of slab i - 1's sums at its
// mirror vertex on plane lx, and a vertex on plane lx the gather of slab
// i + 1's sums at plane 0; then it applies, collides, grabs by global id
// (x_offset0 + b * x_stride + v) and writes pos, prev and the velocity, as
// B2 did.  The halo formed lo_i + hi_{i-1} on one replica and hi_{i-1} +
// lo_i on the other; IEEE addition commutes, so both replicas get those
// bits here too, from the sums, which the vertex pass only reads: no plane
// copies, no predicted or numerator planes in device memory, the first
// design's bits.  One host call enqueues a frame's launches on a device
// (polar_stencil_slab_launch over phases [0, 2 S)).
//
// Where a mesh spans several devices, each device runs a range of the
// frame's phases per call (polar_stencil.slab_calls): a call ends after
// each pass A, the host copies the sums' boundary cube column across each
// device cut into the neighbour's ghost sums (left_sums / right_sums,
// [24, C] laid out as a slab's sums, only that column written), and the
// next call's vertex pass gathers the mirror from there.  That pattern is
// compiled and planned on the CPU but has not run on a card.
//
// What bounds it: pass A, as in K4 (the same kernel on the same cubes).
// Measured on an H100 (PERF.md): a cooperative form that walked a whole
// frame in one launch, both passes grid-stride with a grid barrier
// between them, took 80 registers in its pass-A loop (4 blocks per SM
// against this pass A's 6) and ran slower than this form at 1, 2 and 4
// slabs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "polar_math.cuh"

// Scalars and per-type constants of one frame, computed on the host.
struct GridPolarParams {
  float dt;      // substep length
  float gdt;     // gravity * dt
  float k_fric;  // min(1, dt * friction)
  float wmin[3];
  float wmax[3];
  float rest_volume;
  float rest_centered[6][4][3];  // per type, per corner
  int corner_slab[6][4];         // slab s = 4 dx + 2 dy + dz of each corner
  int slab_items[8][6];  // slab s: the corners 4t + c in it, types in order,
                         // then -1
  int nx, ny, nz;                // cubes
  int iters;                     // extract_rotation iterations
};

namespace {

// W, the cubes of one pass-A block (32 or 64; profile_frame.py builds both)
#ifndef POLAR_STENCIL_STRIP
#define POLAR_STENCIL_STRIP 32
#endif
constexpr int kStrip = POLAR_STENCIL_STRIP;
constexpr int kTetThreads = 6 * kStrip;
constexpr int kVertexThreads = 256;

// The predicted position of vertex v of one body's planes: gravity into
// the velocity, pinned particles (inv_mass 0) held, pos + vel * dt.
__device__ __forceinline__ void predict(const float* pos, const float* vel,
                                        const float* inv_mass, int v, int N,
                                        const GridPolarParams& P,
                                        float out[3]) {
  float vx = vel[v], vy = __fadd_rn(vel[N + v], P.gdt), vz = vel[2 * N + v];
  if (!(inv_mass[v] > 0.0f)) vx = vy = vz = 0.0f;
  out[0] = __fadd_rn(pos[v], __fmul_rn(vx, P.dt));
  out[1] = __fadd_rn(pos[N + v], __fmul_rn(vy, P.dt));
  out[2] = __fadd_rn(pos[2 * N + v], __fmul_rn(vz, P.dt));
}

// One tet of type t from its predicted corners p and its quaternion q:
// returns the new quaternion and writes the 4 rest-volume-weighted goal
// deltas d[c][r] = (R rest_c - (p_c - centroid))[r] * rest_volume.
__device__ __forceinline__ float4 solve_tet(const float p[4][3], int t,
                                            float4 q,
                                            const GridPolarParams& P,
                                            float d[4][3]) {
  float rc[4][3];
  for (int c = 0; c < 4; ++c)
    for (int r = 0; r < 3; ++r) rc[c][r] = P.rest_centered[t][c][r];
  float pc[4][3];
  for (int r = 0; r < 3; ++r) {
    const float cc = (((p[0][r] + p[1][r]) + p[2][r]) + p[3][r]) * 0.25f;
    for (int c = 0; c < 4; ++c) pc[c][r] = p[c][r] - cc;
  }
  float rr[4][3];
  for (int c = 0; c < 4; ++c) polar::qrot(rc[c], q, rr[c]);
  float a[3][3];  // a[r][c] = sum_k pc[k][r] * rr[k][c]
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      a[r][c] = ((pc[0][r] * rr[0][c] + pc[1][r] * rr[1][c]) +
                 pc[2][r] * rr[2][c]) + pc[3][r] * rr[3][c];
  const float4 inc = polar::extract_rotation<polar::AxisForm::kReciprocal>(
      a, make_float4(0.0f, 0.0f, 0.0f, 1.0f), P.iters);
  q = polar::qnormalize_guarded(polar::qmul(inc, q));
  for (int c = 0; c < 4; ++c) {
    float g[3];
    polar::qrot(rc[c], q, g);
    for (int r = 0; r < 3; ++r)
      d[c][r] = __fmul_rn(g[r] - pc[c][r], P.rest_volume);
  }
  return q;
}

// The inverse stencil at vertex (vi, vj, vk) of one body's slab sums bs
// [24, C]: slab s holds the corners of the cube v - (dx, dy, dz); the slabs
// are added in order s = 0..7 (the engine's order).
__device__ __forceinline__ void gather(const float* __restrict__ bs, int vi,
                                       int vj, int vk, int C,
                                       const GridPolarParams& P,
                                       float num[3]) {
  num[0] = num[1] = num[2] = 0.0f;
  for (int s = 0; s < 8; ++s) {
    const int ci = vi - ((s >> 2) & 1), cj = vj - ((s >> 1) & 1),
              ck = vk - (s & 1);
    if (ci < 0 || ci >= P.nx || cj < 0 || cj >= P.ny || ck < 0 || ck >= P.nz)
      continue;
    const int cube = (ci * P.ny + cj) * P.nz + ck;
    for (int r = 0; r < 3; ++r)
      num[r] = __fadd_rn(num[r], bs[(size_t)(3 * s + r) * C + cube]);
  }
}

// Pass A on a strip of kStrip cubes of body blockIdx.y (see the note).
__global__ void __launch_bounds__(kTetThreads)
polar_grid_tet_kernel(const float* __restrict__ pos,  // [B,3,N]
                      const float* __restrict__ vel,  // [B,3,N]
                      const float* quat_in,           // [B,24,C]
                      float* quat_out,                // [B,24,C]
                      float* __restrict__ sums,       // [B,24,C] scratch
                      const float* __restrict__ inv_mass,  // [N] or [B,N]
                      int im_stride,  // 0: one inv_mass row for every body
                      int N, int C, GridPolarParams P) {
  __shared__ float sd[24][3][kStrip];  // weighted deltas, corner 4t + c
  const int b = blockIdx.y;
  const int t = threadIdx.x / kStrip, w = threadIdx.x - t * kStrip;
  const int cube = blockIdx.x * kStrip + w;
  inv_mass += (size_t)b * im_stride;
  const int gy = P.ny + 1, gz = P.nz + 1;
  const float* bpos = pos + (size_t)b * 3 * N;
  const float* bvel = vel + (size_t)b * 3 * N;
  if (cube < C) {
    const int i = cube / (P.ny * P.nz), j = (cube / P.nz) % P.ny,
              k = cube % P.nz;
    float p[4][3];
    for (int c = 0; c < 4; ++c) {
      const int s = P.corner_slab[t][c];
      const int v = ((i + ((s >> 2) & 1)) * gy + (j + ((s >> 1) & 1))) * gz +
                    (k + (s & 1));
      predict(bpos, bvel, inv_mass, v, N, P, p[c]);
    }
    const float* qi = quat_in + ((size_t)b * 24 + 4 * t) * C + cube;
    float d[4][3];
    const float4 q = solve_tet(
        p, t, make_float4(qi[0], qi[C], qi[2 * C], qi[3 * C]), P, d);
    float* qo = quat_out + ((size_t)b * 24 + 4 * t) * C + cube;
    qo[0] = q.x;
    qo[C] = q.y;
    qo[2 * C] = q.z;
    qo[3 * C] = q.w;
    for (int c = 0; c < 4; ++c)
      for (int r = 0; r < 3; ++r) sd[4 * t + c][r][w] = d[c][r];
  }
  __syncthreads();
  if (cube >= C) return;
  // rows t, t + 6, t + 12, t + 18 of cube w: row 3s + r sums the corners
  // of slab s over the types in order, as the plain path's accx[s] and the
  // first design's per-slab acc
  float* out = sums + (size_t)b * 24 * C + cube;
  for (int row = t; row < 24; row += 6) {
    const int s = row / 3, r = row - 3 * s;
    float acc = 0.0f;
    for (int e = 0; e < 6; ++e) {
      const int item = P.slab_items[s][e];
      if (item < 0) break;
      acc = __fadd_rn(acc, sd[item][r][w]);
    }
    out[(size_t)row * C] = acc;
  }
}

// The end of a vertex's substep: from its predicted position p and its
// completed numerator num, apply over max(den, eps) where im > 0, collide
// (world bounds, then the ground with friction toward the substep's start
// (px, py, pz)), apply the grabs (rows gid / gpos matched against the
// particle id `id`; the last grab on it wins) and write pos, prev and the
// velocity at v of the planes that start at `base`.
__device__ __forceinline__ void finish_vertex(
    const float p[3], const float num[3], float im, float den, float px,
    float py, float pz, const int* gid, const float* gpos, int G, int id,
    float* pos_out, float* prev_out, float* vel_out, size_t base, int N,
    int v, const GridPolarParams& P) {
  float x = p[0], y = p[1], z = p[2];
  if (im > 0.0f) {
    const float d = fmaxf(den, polar::kEps);
    x = __fadd_rn(x, num[0] / d);
    y = __fadd_rn(y, num[1] / d);
    z = __fadd_rn(z, num[2] / d);
  }
  x = fminf(fmaxf(x, P.wmin[0]), P.wmax[0]);
  y = fminf(fmaxf(y, P.wmin[1]), P.wmax[1]);
  z = fminf(fmaxf(z, P.wmin[2]), P.wmax[2]);
  if (y < 0.0f) {
    y = 0.0f;
    x = __fadd_rn(x, __fmul_rn(px - x, P.k_fric));
    z = __fadd_rn(z, __fmul_rn(pz - z, P.k_fric));
  }
  for (int g = 0; g < G; ++g) {
    if (gid[g] == id) {
      x = gpos[3 * g];
      y = gpos[3 * g + 1];
      z = gpos[3 * g + 2];
    }
  }
  prev_out[base + v] = px;
  prev_out[base + N + v] = py;
  prev_out[base + 2 * N + v] = pz;
  pos_out[base + v] = x;
  pos_out[base + N + v] = y;
  pos_out[base + 2 * N + v] = z;
  vel_out[base + v] = (x - px) / P.dt;
  vel_out[base + N + v] = (y - py) / P.dt;
  vel_out[base + 2 * N + v] = (z - pz) / P.dt;
}

__global__ void __launch_bounds__(kVertexThreads)
polar_grid_vertex_kernel(const float* pos,        // [B,3,N] substep start
                         const float* vel,        // [B,3,N]
                         float* pos_out,          // [B,3,N]
                         float* __restrict__ prev_out,  // [B,3,N]
                         float* vel_out,          // [B,3,N]
                         const float* __restrict__ sums,      // [B,24,C]
                         const float* __restrict__ inv_mass,  // [N]
                         const float* __restrict__ den,       // [N]
                         const int* __restrict__ grab_id,     // [B,G]
                         const float* __restrict__ grab_pos,  // [B,G,3]
                         int N, int C, int G, GridPolarParams P) {
  const int b = blockIdx.y;
  const int v = blockIdx.x * kVertexThreads + threadIdx.x;
  if (v >= N) return;
  const int gy = P.ny + 1, gz = P.nz + 1;
  const int vi = v / (gy * gz), vj = (v / gz) % gy, vk = v % gz;
  const size_t base = (size_t)b * 3 * N;
  const float* bpos = pos + base;
  float p[3], num[3];
  predict(bpos, vel + base, inv_mass, v, N, P, p);
  gather(sums + (size_t)b * 24 * C, vi, vj, vk, C, P, num);
  finish_vertex(p, num, inv_mass[v], den[v], bpos[v], bpos[N + v],
                bpos[2 * N + v], grab_id + (size_t)b * G,
                grab_pos + (size_t)b * G * 3, G, v, pos_out, prev_out,
                vel_out, base, N, v, P);
}

// K4a's vertex pass on slab blockIdx.y of the k slabs of one device (the
// K4a design note).  pos_out may be pos (a thread reads its vertex before
// it writes it).
__global__ void __launch_bounds__(kVertexThreads)
polar_slab_vertex_kernel(const float* pos,        // [k,3,N] substep start
                         const float* vel,        // [k,3,N]
                         float* pos_out,          // [k,3,N]
                         float* __restrict__ prev_out,  // [k,3,N]
                         float* vel_out,          // [k,3,N]
                         const float* __restrict__ sums,        // [k,24,C]
                         const float* __restrict__ left_sums,   // [24,C]
                         const float* __restrict__ right_sums,  // [24,C]
                         const float* __restrict__ inv_mass,  // [k,N]
                         const float* __restrict__ den,       // [k,N]
                         const int* __restrict__ grab_id,     // [G]
                         const float* __restrict__ grab_pos,  // [G,3]
                         int k, int G, int x_offset0, int x_stride,
                         GridPolarParams P) {
  const int gy = P.ny + 1, gz = P.nz + 1;
  const int N = (P.nx + 1) * gy * gz, C = P.nx * P.ny * P.nz;
  const int b = blockIdx.y;
  const int v = blockIdx.x * kVertexThreads + threadIdx.x;
  if (v >= N) return;
  const int vi = v / (gy * gz), vj = (v / gz) % gy, vk = v % gz;
  const size_t base = (size_t)b * 3 * N, at = (size_t)b * N + v;
  const size_t slab_sums = (size_t)24 * C;
  float p[3], num[3];
  predict(pos + base, vel + base, inv_mass + (size_t)b * N, v, N, P, p);
  gather(sums + b * slab_sums, vi, vj, vk, C, P, num);
  // the shared planes: the neighbour's partial at the mirror vertex
  const float* peer = nullptr;
  int mirror = 0;
  if (vi == 0) {
    peer = b > 0 ? sums + (b - 1) * slab_sums : left_sums;
    mirror = P.nx;
  } else if (vi == P.nx) {
    peer = b + 1 < k ? sums + (b + 1) * slab_sums : right_sums;
  }
  if (peer != nullptr) {
    float m[3];
    gather(peer, mirror, vj, vk, C, P, m);
    for (int r = 0; r < 3; ++r) num[r] = __fadd_rn(num[r], m[r]);
  }
  finish_vertex(p, num, inv_mass[at], den[at], pos[base + v],
                pos[base + N + v], pos[base + 2 * N + v], grab_id, grab_pos,
                G, v + x_offset0 + b * x_stride, pos_out, prev_out, vel_out,
                base, N, v, P);
}

}  // namespace

extern "C" {

int polar_stencil_slab_launches_per_substep() { return 2; }

// Launches phases [begin, end) of a frame of S substeps (0 and 2 S for a
// whole frame) on the k slabs of one device on `stream`: phase 2s is pass
// A of substep s, 2s + 1 its vertex pass, one kernel each.  P holds a
// slab's local dims; pos_in, vel_in and quat_in are read by substep 0
// only; left_sums / right_sums may be null.  Returns the first launch
// error (0 = every kernel launched).
int polar_stencil_slab_launch(const void* pos_in, const void* vel_in,
                              const void* quat_in, void* pos_out,
                              void* prev_out, void* vel_out, void* quat_out,
                              void* sums, const void* left_sums,
                              const void* right_sums, const void* inv_mass,
                              const void* den, const void* grab_id,
                              const void* grab_pos, int k, int G,
                              int x_offset0, int x_stride, int begin, int end,
                              GridPolarParams P, void* stream) {
  const int N = (P.nx + 1) * (P.ny + 1) * (P.nz + 1);
  const int C = P.nx * P.ny * P.nz;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 tets((C + kStrip - 1) / kStrip, k);
  const dim3 verts((N + kVertexThreads - 1) / kVertexThreads, k);
  for (int u = begin; u < end; ++u) {
    const bool first = u < 2;
    const float* pos = (const float*)(first ? pos_in : pos_out);
    const float* vel = (const float*)(first ? vel_in : vel_out);
    if ((u & 1) == 0)
      polar_grid_tet_kernel<<<tets, kTetThreads, 0, st>>>(
          pos, vel, (const float*)(first ? quat_in : quat_out),
          (float*)quat_out, (float*)sums, (const float*)inv_mass, N, N, C, P);
    else
      polar_slab_vertex_kernel<<<verts, kVertexThreads, 0, st>>>(
          pos, vel, (float*)pos_out, (float*)prev_out, (float*)vel_out,
          (const float*)sums, (const float*)left_sums,
          (const float*)right_sums, (const float*)inv_mass,
          (const float*)den, (const int*)grab_id, (const float*)grab_pos, k,
          G, x_offset0, x_stride, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int polar_stencil_launches_per_substep() { return 2; }

int polar_stencil_strip() { return kStrip; }

// Launches S substeps on `stream`, two kernels each; returns the first
// launch error (0 = every kernel launched).
int polar_stencil_launch(const void* pos_in, const void* vel_in,
                         const void* quat_in, void* pos_out, void* prev_out,
                         void* vel_out, void* quat_out, void* sums,
                         const void* inv_mass, const void* den,
                         const void* grab_id, const void* grab_pos, int B,
                         int G, int S, GridPolarParams P, void* stream) {
  const int N = (P.nx + 1) * (P.ny + 1) * (P.nz + 1);
  const int C = P.nx * P.ny * P.nz;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 tets((C + kStrip - 1) / kStrip, B);
  const dim3 verts((N + kVertexThreads - 1) / kVertexThreads, B);
  for (int s = 0; s < S; ++s) {
    const float* pos = (const float*)(s == 0 ? pos_in : pos_out);
    const float* vel = (const float*)(s == 0 ? vel_in : vel_out);
    const float* quat = (const float*)(s == 0 ? quat_in : quat_out);
    polar_grid_tet_kernel<<<tets, kTetThreads, 0, st>>>(
        pos, vel, quat, (float*)quat_out, (float*)sums,
        (const float*)inv_mass, 0, N, C, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    polar_grid_vertex_kernel<<<verts, kVertexThreads, 0, st>>>(
        pos, vel, (float*)pos_out, (float*)prev_out, (float*)vel_out,
        (const float*)sums, (const float*)inv_mass, (const float*)den,
        (const int*)grab_id, (const float*)grab_pos, N, C, G, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* polar_stencil_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
