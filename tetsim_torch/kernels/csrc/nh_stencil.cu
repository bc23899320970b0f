// Neo-Hookean XPBD substeps on a grid_mesh box with the 48-colour
// Gauss-Seidel sweep: the stencil engine of
// tetsim_torch/solvers/neohookean_grid.py on B boxes of one size.
//
// Replaces the TPU kernel tetsim_tpu/kernels/nh_stencil.py:_make_kernel
// (built by _build_call; sweep _emit_sweep) and follows the semantics of the
// XLA stencil engine tetsim_tpu/solvers/neohookean_grid.py, as the plain
// path tetsim_torch/solvers/neohookean_grid.py writes them: predict
// (gravity, gated by inv_mass > 0), the 48 colours in order (Kuhn type t
// major, cube parity (i%2, j%2, k%2) minor), collide (world bounds, the
// ground with friction), grab override, velocity update.  The tet
// projection is nh::solve_tet (nh_math.cuh, shared with gs_frame.cu), which
// applies the deviatoric and then the hydrostatic step to the corners in
// turn, as the grid engine does.
//
// Layout: particle state as planes [B, 3, N] over the flat C-order vertex
// grid v = (i*gy + j)*gz + k.  The TPU kernel's parity blocks, [8, rows,
// 128] planes and lane rolls are only addressing: a thread computes its
// corner ids from (colour, cube) directly.
//
// K3, the design: the whole frame is one cooperative launch
// (nh_grid_frame_kernel), as the TPU kernel runs a substep inside one
// pallas_call.  Its grid is co-resident (the wrapper sizes it from the
// occupancy query, 1 block of 256 threads per SM) and walks the frame's
// phases with a grid barrier (cooperative_groups this_grid().sync())
// between them: predict, then per substep the 48 colours and a phase that
// collides the substep and predicts the next.  Each phase walks its items
// grid-stride: a particle phase the (body, vertex) pairs, so a particle's
// collide and its next predict fall to the same thread and need no barrier
// between them; a colour phase the (body, virtual block of 256 tet lanes)
// pairs, each lane the tet nh_grid_color_kernel's thread of that block
// solves.  A colour's tets share no vertex, so the order in which the
// blocks take them changes no bit.  Where the caller asks for the volume
// error, each (body, colour, virtual block) writes the sum of its lanes'
// det F - 1 (a tree in shared memory, in a fixed order) to a scratch row,
// and the collide phase adds a body's row in a fixed strided order into
// vol_err[b, s] / num_tets.  49 grid barriers per substep, no atomics of
// its own, deterministic: the first design's bits.
//
// Numerics: predict, collide and velocity round every operation as the
// plain path does; the tet projection is contracted by nvcc into FMAs
// where it can.
//
// What bounds it.  The work is 421 flops per tet and 13 per particle per
// substep (kernels/nh_stencil.py frame_flops): 0.45 GFLOP, about 7 us at
// the card's FP32 peak for the 56^3 box.  The first design launched 50
// kernels per substep from a C loop; a colour of 21,952 tets fills 86
// blocks for about 3 us, and the host enqueued 250 launches per frame in
// about 1.09 ms against 0.77 ms of device time, so the host paced the frame
// (busy 71%).  Here the host enqueues one launch per frame, and a colour
// phase costs one L2 gather of its corners, one tet's dependent chain per
// thread (8 warps of it on each SM that has an item) and a grid barrier;
// the 48 colours stay sequential.  Measured on an H100 (profile_frame.py
// --phases, PERF.md): one grid barrier alone takes about 1.0 us at 132
// blocks (1.3 at 264, which is why the grid is one block per SM); on
// block 0 a colour phase takes 3,000-3,200 SM cycles and the barrier after
// it, waiting for the slowest block, 3,100-3,250: about 3.1 us per phase,
// against the first design's 3.08 us of device time per colour launch and
// about 4.4 us of host time per launch that paced it.

// K3s, the slab form: replaces the TPU kernel
// tetsim_tpu/kernels/nh_stencil.py:_build_seg_call, one colour group (the 4
// colours of one (type, px) pair) of K3's sweep on one x-slab, which
// make_nh_sharded_stepper runs 12 times per substep with a one-plane
// ppermute between groups.  Here the slabs of one device run together:
// nh_grid_color_kernel on the slab's local dims, with blockIdx.y over the
// slabs and each slab's own inv_mass row, so 4 slabs on one card cost one
// launch per colour as one box does; predict and collide likewise, the
// collide decoding grabs by global particle id.  The per-particle and
// per-tet code is K3's.  A px=0 colour updates a shared vertex plane only on
// the right slab and a px=1 colour only on the left, so the 12 SlabMesh
// copies per substep between the groups (one plane of 3 * gy * gz * 4 =
// 38,988 B per neighbour pair at 56^3, one way each) give K3's trajectory
// bit for bit.  What bounds it: launches (50 per substep for the whole
// device) and the 12 exchanges' copies (3 per exchange at 4 slabs).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nh_math.cuh"

namespace cg = cooperative_groups;

// Scalars and per-type constants of one frame, computed on the host.
struct GridNHParams {
  float dt;         // substep length
  float gdt;        // gravity * dt
  float k_fric;     // min(1, dt * friction)
  float dev_scale;  // dev_compliance / (dt * dt)
  float vol_scale;  // vol_compliance / (dt * dt)
  float gamma;      // vol_compliance / dev_compliance
  float wmin[3];
  float wmax[3];
  float irv;          // inverse rest volume (uniform)
  float ir[6][9];     // inverse rest pose per type, row-major
  int corner_slab[6][4];  // offset s = 4 dx + 2 dy + dz of each corner
  int nx, ny, nz;     // cubes
};

namespace {

constexpr int kThreads = 256;
constexpr int kColors = 48;

#ifdef NH_STENCIL_PHASES
// A build for profile_frame.py --phases only: block 0 of K3 sums the SM
// cycles of its particle phases (the first predict, then collide with the
// next predict and the volume error), of its 48 colour phases and of its
// grid barriers, each phase ended by a __syncthreads() that the shipped
// build does not have, and counts the substeps.
__device__ unsigned long long phase_cycles[4];
#endif

// Blocks of 256 tet lanes that cover the largest colour (the volume
// error's scratch holds one sum per body, colour and such block;
// nh_stencil.partial_blocks on the host).
__host__ __device__ __forceinline__ int partial_blocks(int nx, int ny,
                                                       int nz) {
  const int most = ((nx + 1) / 2) * ((ny + 1) / 2) * ((nz + 1) / 2);
  return (most + kThreads - 1) / kThreads;
}

// Predict of vertex v of the body whose planes start at `base`: velocity
// plus gravity, zeroed where inv_mass is not > 0; the start is saved as
// prev.
__device__ __forceinline__ void predict_one(float x, float y, float z,
                                            float vx, float vy, float vz,
                                            float im, float* pos, float* prev,
                                            size_t base, int N, int v,
                                            const GridNHParams& P) {
  vy = __fadd_rn(vy, P.gdt);
  if (!(im > 0.0f)) vx = vy = vz = 0.0f;
  prev[base + v] = x;
  prev[base + N + v] = y;
  prev[base + 2 * N + v] = z;
  pos[base + v] = __fadd_rn(x, __fmul_rn(vx, P.dt));
  pos[base + N + v] = __fadd_rn(y, __fmul_rn(vy, P.dt));
  pos[base + 2 * N + v] = __fadd_rn(z, __fmul_rn(vz, P.dt));
}

// Collide of one particle at (x, y, z) that started the substep at (px,
// py, pz): world bounds, the ground with friction, then the grab override
// (grab rows gid / gpos, matched against the particle id `id`; the last
// grab on it wins).
__device__ __forceinline__ void collide_one(float& x, float& y, float& z,
                                            float px, float pz,
                                            const int* gid, const float* gpos,
                                            int G, int id,
                                            const GridNHParams& P) {
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
}

// Tet lane `lane` of colour `color` on one body's planes bpos [3, N] with
// its inverse masses bim [N]: the colour's cubes are (px + 2 ax, py + 2 ay,
// pz + 2 az), lanes in C order over (ax, ay, az).  Projects the tet in
// place; returns its det F - 1, or 0 for a lane past the colour.
__device__ __forceinline__ float solve_lane(float* bpos, const float* bim,
                                            int N, int color, int lane,
                                            const GridNHParams& P) {
  const int t = color >> 3;
  const int px = (color >> 2) & 1, py = (color >> 1) & 1, pz = color & 1;
  const int cwx = (P.nx - px + 1) / 2, cwy = (P.ny - py + 1) / 2,
            cwz = (P.nz - pz + 1) / 2;
  if (lane >= cwx * cwy * cwz) return 0.0f;
  const int ci = px + 2 * (lane / (cwy * cwz));
  const int cj = py + 2 * ((lane / cwz) % cwy);
  const int ck = pz + 2 * (lane % cwz);
  const int gy = P.ny + 1, gz = P.nz + 1;
  int ids[4];
  float p[4][3], w[4], ir[9];
  for (int c = 0; c < 4; ++c) {
    const int s = P.corner_slab[t][c];
    ids[c] = ((ci + ((s >> 2) & 1)) * gy + (cj + ((s >> 1) & 1))) * gz +
             (ck + (s & 1));
    for (int r = 0; r < 3; ++r) p[c][r] = bpos[(size_t)r * N + ids[c]];
    w[c] = bim[ids[c]];
  }
  for (int e = 0; e < 9; ++e) ir[e] = P.ir[t][e];
  const float verr =
      nh::solve_tet<true>(p, ir, P.irv, w, P.dev_scale, P.vol_scale, P.gamma);
  for (int c = 0; c < 4; ++c)
    for (int r = 0; r < 3; ++r) bpos[(size_t)r * N + ids[c]] = p[c][r];
  return verr;
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

// K3: S substeps of B boxes in one cooperative launch (the design note at
// the top).  Positions, prev and velocities are read and written by other
// blocks between barriers, so they are plain pointers (no read-only
// cache); the partial sums too.
__global__ void __launch_bounds__(kThreads)
nh_grid_frame_kernel(const float* __restrict__ pos_in,  // [B,3,N]
                     const float* __restrict__ vel_in,  // [B,3,N]
                     float* pos,      // [B,3,N] out
                     float* prev,     // [B,3,N] out
                     float* vel,      // [B,3,N] out
                     float* vol_err,  // [B,S] or null
                     float* partial,  // [B,48,nblk], with vol_err
                     const float* __restrict__ inv_mass,  // [N]
                     const int* __restrict__ grab_id,     // [B,G]
                     const float* __restrict__ grab_pos,  // [B,G,3]
                     int B, int G, int S, GridNHParams P) {
  __shared__ float red[kThreads];
  cg::grid_group grid = cg::this_grid();
  const int N = (P.nx + 1) * (P.ny + 1) * (P.nz + 1);
  const int nblk = partial_blocks(P.nx, P.ny, P.nz);
  const int total = B * N;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
#ifdef NH_STENCIL_PHASES
  const bool mark = blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long acc[3] = {0, 0, 0};
  long long t_mark = clock64();
#define PHASE_END(k)                     \
  __syncthreads();                       \
  if (mark) {                            \
    const long long now = clock64();     \
    acc[k] += now - t_mark;              \
    t_mark = now;                        \
  }
#else
#define PHASE_END(k)
#endif

  for (int i = first; i < total; i += stride) {
    const int v = i % N;
    const size_t base = (size_t)(i / N) * 3 * N;
    predict_one(pos_in[base + v], pos_in[base + N + v],
                pos_in[base + 2 * N + v], vel_in[base + v],
                vel_in[base + N + v], vel_in[base + 2 * N + v], inv_mass[v],
                pos, prev, base, N, v, P);
  }
  PHASE_END(0);
  for (int s = 0; s < S; ++s) {
    grid.sync();
    PHASE_END(2);
    for (int color = 0; color < kColors; ++color) {
      for (int item = blockIdx.x; item < B * nblk; item += gridDim.x) {
        const int b = item / nblk, vb = item % nblk;
        const float verr = solve_lane(pos + (size_t)b * 3 * N, inv_mass, N,
                                      color, vb * kThreads + threadIdx.x, P);
        if (vol_err != nullptr) {
          const float sum = block_sum(verr, red);
          if (threadIdx.x == 0)
            partial[((size_t)b * kColors + color) * nblk + vb] = sum;
          __syncthreads();  // red serves the block's next item
        }
      }
      PHASE_END(1);
      grid.sync();
      PHASE_END(2);
    }
    // collide this substep and predict the next, a particle per thread
    const bool last = s + 1 == S;
    for (int i = first; i < total; i += stride) {
      const int b = i / N, v = i % N;
      const size_t base = (size_t)b * 3 * N;
      const float px = prev[base + v], py = prev[base + N + v],
                  pz = prev[base + 2 * N + v];
      float x = pos[base + v], y = pos[base + N + v], z = pos[base + 2 * N + v];
      collide_one(x, y, z, px, pz, grab_id + (size_t)b * G,
                  grab_pos + (size_t)b * G * 3, G, v, P);
      const float vx = (x - px) / P.dt, vy = (y - py) / P.dt,
                  vz = (z - pz) / P.dt;
      if (last) {
        pos[base + v] = x;
        pos[base + N + v] = y;
        pos[base + 2 * N + v] = z;
        vel[base + v] = vx;
        vel[base + N + v] = vy;
        vel[base + 2 * N + v] = vz;
      } else {
        predict_one(x, y, z, vx, vy, vz, inv_mass[v], pos, prev, base, N, v,
                    P);
      }
    }
    if (vol_err != nullptr) {
      // a body's colour block sums, each thread a fixed stride of them
      for (int b = blockIdx.x; b < B; b += gridDim.x) {
        const float* row = partial + (size_t)b * kColors * nblk;
        float a = 0.0f;
        for (int i = threadIdx.x; i < kColors * nblk; i += kThreads)
          a += row[i];
        const float sum = block_sum(a, red);
        if (threadIdx.x == 0)
          vol_err[(size_t)b * S + s] = sum / (float)(6 * P.nx * P.ny * P.nz);
        __syncthreads();
      }
    }
    PHASE_END(0);
  }
#ifdef NH_STENCIL_PHASES
  if (mark) {
    for (int k = 0; k < 3; ++k) phase_cycles[k] += acc[k];
    phase_cycles[3] += S;
  }
#endif
#undef PHASE_END
}

#ifdef NH_STENCIL_PHASES
// iters grid barriers and nothing else: the cost of one at a grid size.
__global__ void __launch_bounds__(kThreads) nh_grid_sync_probe(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < iters; ++k) grid.sync();
}
#endif

// The slab form's kernels (K3s), over B slabs (blockIdx.y) with one
// inv_mass row each and the grabs shared by every slab.

__global__ void __launch_bounds__(kThreads)
nh_grid_predict_kernel(const float* pos,     // [B,3,N] substep start
                       const float* __restrict__ vel,  // [B,3,N]
                       float* pos_out,       // [B,3,N] predicted
                       float* __restrict__ prev_out,   // [B,3,N]
                       const float* __restrict__ inv_mass,  // [B,N]
                       int N, GridNHParams P) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= N) return;
  const size_t base = (size_t)blockIdx.y * 3 * N;
  predict_one(pos[base + v], pos[base + N + v], pos[base + 2 * N + v],
              vel[base + v], vel[base + N + v], vel[base + 2 * N + v],
              inv_mass[(size_t)blockIdx.y * N + v], pos_out, prev_out, base,
              N, v, P);
}

__global__ void __launch_bounds__(kThreads)
nh_grid_color_kernel(float* __restrict__ pos,             // [B,3,N] in place
                     const float* __restrict__ inv_mass,  // [B,N]
                     int N, int color, GridNHParams P) {
  solve_lane(pos + (size_t)blockIdx.y * 3 * N,
             inv_mass + (size_t)blockIdx.y * N, N, color,
             blockIdx.x * kThreads + threadIdx.x, P);
}

__global__ void __launch_bounds__(kThreads)
nh_grid_collide_kernel(float* __restrict__ pos,             // [B,3,N]
                       const float* __restrict__ prev,      // [B,3,N]
                       float* __restrict__ vel_out,         // [B,3,N]
                       const int* __restrict__ grab_id,     // [G]
                       const float* __restrict__ grab_pos,  // [G,3]
                       int N, int G,
                       int x_offset0, int x_stride,  // id = v + these
                       GridNHParams P) {
  const int b = blockIdx.y;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= N) return;
  const size_t base = (size_t)b * 3 * N;
  const float px = prev[base + v], py = prev[base + N + v],
              pz = prev[base + 2 * N + v];
  float x = pos[base + v], y = pos[base + N + v], z = pos[base + 2 * N + v];
  collide_one(x, y, z, px, pz, grab_id, grab_pos, G,
              v + x_offset0 + b * x_stride, P);
  pos[base + v] = x;
  pos[base + N + v] = y;
  pos[base + 2 * N + v] = z;
  vel_out[base + v] = (x - px) / P.dt;
  vel_out[base + N + v] = (y - py) / P.dt;
  vel_out[base + 2 * N + v] = (z - pz) / P.dt;
}

}  // namespace

extern "C" {

int nh_stencil_launches_per_frame() { return 1; }

int nh_stencil_slab_launches_per_substep() { return kColors + 2; }

// Blocks of K3's kernel that one SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the device's SM
// count.  Returns the CUDA error.
int nh_stencil_occupancy(int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, nh_grid_frame_kernel, kThreads, 0);
  return (int)err;
}

// Launches K3 for S substeps on `stream`: one cooperative launch of `grid`
// blocks, which must all be resident at once (nh_stencil_occupancy).
// vol_err [B,S] and its scratch partial [B, 48, nblk] may both be null.
// Returns the launch's error (0 = launched).
int nh_stencil_launch(const void* pos_in, const void* vel_in, void* pos_out,
                      void* prev_out, void* vel_out, void* vol_err,
                      void* partial, const void* inv_mass,
                      const void* grab_id, const void* grab_pos, int B, int G,
                      int S, int grid, GridNHParams P, void* stream) {
  const float* a0 = (const float*)pos_in;
  const float* a1 = (const float*)vel_in;
  float* a2 = (float*)pos_out;
  float* a3 = (float*)prev_out;
  float* a4 = (float*)vel_out;
  float* a5 = (float*)vol_err;
  float* a6 = vol_err != nullptr ? (float*)partial : nullptr;
  const float* a7 = (const float*)inv_mass;
  const int* a8 = (const int*)grab_id;
  const float* a9 = (const float*)grab_pos;
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &a6, &a7, &a8, &a9,
                  &B,  &G,  &S,  &P};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)nh_grid_frame_kernel, dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

#ifdef NH_STENCIL_PHASES
// Copies phase_cycles to out[4] (particle phases, colour phases, barriers,
// substeps) and zeroes it; returns the CUDA error.
int nh_stencil_phase_cycles(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
  return (int)err;
}

// One cooperative launch of `grid` blocks that runs `iters` grid barriers.
int nh_stencil_sync_probe(int grid, int iters, void* stream) {
  void* args[] = {&iters};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)nh_grid_sync_probe, dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
#endif

// K3s, the slab form: B slabs of one device (P holds the slab's local
// dims, inv_mass is [B, N], the grabs are shared and decoded by global id
// v + x_offset0 + b * x_stride).  A substep is slab_predict, the 12
// segments (each with a boundary-plane copy between slabs after it) and
// slab_collide.  Each returns the first launch error.
int nh_stencil_slab_predict(const void* pos, const void* vel, void* pos_out,
                            void* prev_out, const void* inv_mass, int B,
                            GridNHParams P, void* stream) {
  const int N = (P.nx + 1) * (P.ny + 1) * (P.nz + 1);
  const dim3 verts((N + kThreads - 1) / kThreads, B);
  nh_grid_predict_kernel<<<verts, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)vel, (float*)pos_out, (float*)prev_out,
      (const float*)inv_mass, N, P);
  return (int)cudaGetLastError();
}

// Colour group seg (0..11): the 4 colours of one (type, px) pair, in K3's
// order.
int nh_stencil_slab_segment(void* pos, const void* inv_mass, int B, int seg,
                            GridNHParams P, void* stream) {
  const int N = (P.nx + 1) * (P.ny + 1) * (P.nz + 1);
  const dim3 cells(partial_blocks(P.nx, P.ny, P.nz), B);
  for (int color = 4 * seg; color < 4 * seg + 4; ++color) {
    nh_grid_color_kernel<<<cells, kThreads, 0, (cudaStream_t)stream>>>(
        (float*)pos, (const float*)inv_mass, N, color, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int nh_stencil_slab_collide(void* pos, const void* prev, void* vel_out,
                            const void* grab_id, const void* grab_pos, int B,
                            int G, int x_offset0, int x_stride,
                            GridNHParams P, void* stream) {
  const int N = (P.nx + 1) * (P.ny + 1) * (P.nz + 1);
  const dim3 verts((N + kThreads - 1) / kThreads, B);
  nh_grid_collide_kernel<<<verts, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)pos, (const float*)prev, (float*)vel_out, (const int*)grab_id,
      (const float*)grab_pos, N, G, x_offset0, x_stride, P);
  return (int)cudaGetLastError();
}

const char* nh_stencil_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
