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
// Design: 50 launches per substep, no atomics, deterministic.  A predict
// launch (one thread per vertex; it also saves the substep's start
// positions as prev), one launch per colour (one thread per tet of the
// colour; the tets of a colour share no vertex, so each thread reads its 4
// corners and writes them back with no race), and a collide launch (one
// thread per vertex).  Where the caller asks for the volume error, each
// colour block writes the sum of its tets' det F - 1 (a tree in shared
// memory, in a fixed order) to a scratch row, and block 0 of the collide
// launch adds the rows in a fixed order into vol_err[b, s] / num_tets.
// Substep 0 reads the inputs; later substeps update the outputs in place.
//
// Numerics: predict, collide and velocity round every operation as the
// plain path does; the tet projection is contracted by nvcc into FMAs
// where it can.
//
// What bounds it: launches.  The work is 421 flops per tet and 13 per
// particle per substep (kernels/nh_stencil.py frame_flops), 0.45 GFLOP and
// about 7 us at the card's FP32 peak for the 56^3 box, but the 48 colours
// are sequential, and a colour of 21,952 tets fills 86 blocks of 256
// threads on 132 SMs for a few microseconds: each launch costs about what
// its work does.  A later change could run the sweep as one cooperative
// kernel with a grid-wide barrier between colours, or capture the
// substep's 50 launches in a CUDA graph.

// K3s, the slab form: replaces the TPU kernel
// tetsim_tpu/kernels/nh_stencil.py:_build_seg_call, one colour group (the 4
// colours of one (type, px) pair) of K3's sweep on one x-slab, which
// make_nh_sharded_stepper runs 12 times per substep with a one-plane
// ppermute between groups.  Here the slabs of one device run together:
// the same nh_grid_color_kernel as K3 on the slab's local dims, with
// blockIdx.y over the slabs and each slab's own inv_mass row, so 4 slabs
// on one card cost one launch per colour as one box does; predict and
// collide likewise, the collide decoding grabs by global particle id.  A
// px=0 colour updates a shared vertex plane only on the right slab and a
// px=1 colour only on the left, so the 12 SlabMesh copies per substep
// between the groups (one plane of 3 * gy * gz * 4 = 38,988 B per
// neighbour pair at 56^3, one way each) give K3's trajectory bit for bit.
// What bounds it: launches, as K3 (50 per substep for the whole device),
// plus the 12 exchanges' copies (3 per exchange at 4 slabs).

#include <cuda_runtime.h>
#include <stdint.h>

#include "nh_math.cuh"

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

__global__ void __launch_bounds__(kThreads)
nh_grid_predict_kernel(const float* pos,     // [B,3,N] substep start
                       const float* __restrict__ vel,  // [B,3,N]
                       float* pos_out,       // [B,3,N] predicted
                       float* __restrict__ prev_out,   // [B,3,N]
                       const float* __restrict__ inv_mass,  // [N] or [B,N]
                       int im_stride,  // 0: one inv_mass row for every body
                       int N, GridNHParams P) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= N) return;
  const size_t base = (size_t)blockIdx.y * 3 * N;
  float vx = vel[base + v], vy = __fadd_rn(vel[base + N + v], P.gdt),
        vz = vel[base + 2 * N + v];
  if (!(inv_mass[(size_t)blockIdx.y * im_stride + v] > 0.0f))
    vx = vy = vz = 0.0f;
  const float x = pos[base + v], y = pos[base + N + v],
              z = pos[base + 2 * N + v];
  prev_out[base + v] = x;
  prev_out[base + N + v] = y;
  prev_out[base + 2 * N + v] = z;
  pos_out[base + v] = __fadd_rn(x, __fmul_rn(vx, P.dt));
  pos_out[base + N + v] = __fadd_rn(y, __fmul_rn(vy, P.dt));
  pos_out[base + 2 * N + v] = __fadd_rn(z, __fmul_rn(vz, P.dt));
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
nh_grid_color_kernel(float* __restrict__ pos,             // [B,3,N] in place
                     const float* __restrict__ inv_mass,  // [N] or [B,N]
                     int im_stride,  // 0: one inv_mass row for every body
                     float* __restrict__ partial,  // [B,48,nblk] or null
                     int N, int color, GridNHParams P) {
  __shared__ float red[kThreads];
  const int t = color >> 3;
  const int px = (color >> 2) & 1, py = (color >> 1) & 1, pz = color & 1;
  // the colour's cubes are (px + 2 ax, py + 2 ay, pz + 2 az)
  const int cwx = (P.nx - px + 1) / 2, cwy = (P.ny - py + 1) / 2,
            cwz = (P.nz - pz + 1) / 2;
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  float verr = 0.0f;
  if (lane < cwx * cwy * cwz) {
    const int ci = px + 2 * (lane / (cwy * cwz));
    const int cj = py + 2 * ((lane / cwz) % cwy);
    const int ck = pz + 2 * (lane % cwz);
    const int gy = P.ny + 1, gz = P.nz + 1;
    float* bpos = pos + (size_t)blockIdx.y * 3 * N;
    const float* bim = inv_mass + (size_t)blockIdx.y * im_stride;
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
    verr = nh::solve_tet<true>(p, ir, P.irv, w, P.dev_scale, P.vol_scale,
                               P.gamma);
    for (int c = 0; c < 4; ++c)
      for (int r = 0; r < 3; ++r) bpos[(size_t)r * N + ids[c]] = p[c][r];
  }
  if (partial != nullptr) {
    const float total = block_sum(verr, red);
    if (threadIdx.x == 0)
      partial[((size_t)blockIdx.y * kColors + color) * gridDim.x +
              blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kThreads)
nh_grid_collide_kernel(float* __restrict__ pos,             // [B,3,N]
                       const float* __restrict__ prev,      // [B,3,N]
                       float* __restrict__ vel_out,         // [B,3,N]
                       const int* __restrict__ grab_id,     // [B,G] or [G]
                       const float* __restrict__ grab_pos,  // [B,G,3] or [G,3]
                       const float* __restrict__ partial,   // [B,48,nblk]
                       float* __restrict__ vol_err,         // [B,S] or null
                       int N, int G, int S, int s, int nblk, int num_tets,
                       int grab_stride,  // G: a grab row per body; 0: shared
                       int x_offset0, int x_stride,  // id = v + these
                       GridNHParams P) {
  __shared__ float red[kThreads];
  const int b = blockIdx.y;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v < N) {
    const size_t base = (size_t)b * 3 * N;
    const float px = prev[base + v], py = prev[base + N + v],
                pz = prev[base + 2 * N + v];
    float x = fminf(fmaxf(pos[base + v], P.wmin[0]), P.wmax[0]);
    float y = fminf(fmaxf(pos[base + N + v], P.wmin[1]), P.wmax[1]);
    float z = fminf(fmaxf(pos[base + 2 * N + v], P.wmin[2]), P.wmax[2]);
    if (y < 0.0f) {
      y = 0.0f;
      x = __fadd_rn(x, __fmul_rn(px - x, P.k_fric));
      z = __fadd_rn(z, __fmul_rn(pz - z, P.k_fric));
    }
    const int* gid = grab_id + (size_t)b * grab_stride;
    const float* gpos = grab_pos + (size_t)b * grab_stride * 3;
    const int id = v + x_offset0 + b * x_stride;
    for (int g = 0; g < G; ++g) {  // the last grab on v wins
      if (gid[g] == id) {
        x = gpos[3 * g];
        y = gpos[3 * g + 1];
        z = gpos[3 * g + 2];
      }
    }
    pos[base + v] = x;
    pos[base + N + v] = y;
    pos[base + 2 * N + v] = z;
    vel_out[base + v] = (x - px) / P.dt;
    vel_out[base + N + v] = (y - py) / P.dt;
    vel_out[base + 2 * N + v] = (z - pz) / P.dt;
  }
  if (vol_err != nullptr && blockIdx.x == 0) {
    // the colours' block sums, each thread a fixed stride of them
    const float* row = partial + (size_t)b * kColors * nblk;
    float acc = 0.0f;
    for (int i = threadIdx.x; i < kColors * nblk; i += kThreads) acc += row[i];
    const float total = block_sum(acc, red);
    if (threadIdx.x == 0) vol_err[(size_t)b * S + s] = total / (float)num_tets;
  }
}

}  // namespace

extern "C" {

int nh_stencil_launches_per_substep() { return kColors + 2; }

// Blocks of a colour launch: the largest colour's tets over kThreads (the
// volume error's scratch holds one sum per block and colour).
int nh_stencil_partial_blocks(int nx, int ny, int nz) {
  const int most = ((nx + 1) / 2) * ((ny + 1) / 2) * ((nz + 1) / 2);
  return (most + kThreads - 1) / kThreads;
}

// Launches S substeps on `stream`, 50 kernels each; vol_err [B,S] and its
// scratch partial [B, 48, nblk] may both be null.  Returns the first launch
// error (0 = every kernel launched).
int nh_stencil_launch(const void* pos_in, const void* vel_in, void* pos_out,
                      void* prev_out, void* vel_out, void* vol_err,
                      void* partial, const void* inv_mass,
                      const void* grab_id, const void* grab_pos, int B, int G,
                      int S, GridNHParams P, void* stream) {
  const int N = (P.nx + 1) * (P.ny + 1) * (P.nz + 1);
  const int nblk = nh_stencil_partial_blocks(P.nx, P.ny, P.nz);
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 verts((N + kThreads - 1) / kThreads, B), cells(nblk, B);
  float* part = vol_err != nullptr ? (float*)partial : nullptr;
  for (int s = 0; s < S; ++s) {
    const float* pos = (const float*)(s == 0 ? pos_in : pos_out);
    const float* vel = (const float*)(s == 0 ? vel_in : vel_out);
    nh_grid_predict_kernel<<<verts, kThreads, 0, st>>>(
        pos, vel, (float*)pos_out, (float*)prev_out, (const float*)inv_mass,
        0, N, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int color = 0; color < kColors; ++color) {
      nh_grid_color_kernel<<<cells, kThreads, 0, st>>>(
          (float*)pos_out, (const float*)inv_mass, 0, part, N, color, P);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    nh_grid_collide_kernel<<<verts, kThreads, 0, st>>>(
        (float*)pos_out, (const float*)prev_out, (float*)vel_out,
        (const int*)grab_id, (const float*)grab_pos, part, (float*)vol_err, N,
        G, S, s, nblk, 6 * P.nx * P.ny * P.nz, G, 0, 0, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

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
      (const float*)inv_mass, N, N, P);
  return (int)cudaGetLastError();
}

// Colour group seg (0..11): the 4 colours of one (type, px) pair, as K3
// launches them.
int nh_stencil_slab_segment(void* pos, const void* inv_mass, int B, int seg,
                            GridNHParams P, void* stream) {
  const int N = (P.nx + 1) * (P.ny + 1) * (P.nz + 1);
  const dim3 cells(nh_stencil_partial_blocks(P.nx, P.ny, P.nz), B);
  for (int color = 4 * seg; color < 4 * seg + 4; ++color) {
    nh_grid_color_kernel<<<cells, kThreads, 0, (cudaStream_t)stream>>>(
        (float*)pos, (const float*)inv_mass, N, nullptr, N, color, P);
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
      (const float*)grab_pos, nullptr, nullptr, N, G, 1, 0, 1, 0, 0,
      x_offset0, x_stride, P);
  return (int)cudaGetLastError();
}

const char* nh_stencil_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
