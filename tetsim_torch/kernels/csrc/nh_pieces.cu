// Neo-Hookean Gauss-Seidel on the pieces of one unstructured mesh: a whole
// frame of the nh_pieces engine, tetsim_torch/kernels/nh_pieces.py, whose
// nh_pieces_frame_reference (the substep loop on
// nh_pieces_solve_reference) is its plain twin.
//
// Replaces the TPU kernel tetsim_tpu/kernels/nh_pieces.py:_make_solve_kernel
// (built by _solve_call), the per-piece sweep, and the glue around it that
// the JAX package fuses under jit (_substep_local, _complete_boundary).  The
// TPU kernel gathers each sub-level's corners from VMEM planes with per-tile
// dynamic gathers and writes them back with a second gather through the
// inverse table winv; on the card a thread reads and writes its tet's
// corners in shared memory directly, so winv is not read.
//
// Layout (B pieces, rp lanes per piece, L sub-levels of CW = 128 slots):
//   in[6]        [B, rp] each     lx, ly, lz, vx, vy, vz at the frame start
//   out          [6, B, rp]       the same planes at the frame end
//   scratch      [6, B, rp]       rows 0-2 the swept planes, 3-5 the
//                                 predicted ones, of the current substep
//   lids         [L, B, 4*CW]     corner c of slot t at c*CW + t -> lane
//   cons         [L, B, 14, CW]   rows 0-8 inverse rest pose (row-major),
//                                 9 inverse rest volume, 10-13 inverse masses
//   n_live       [L, B]           live slots of a sub-level: [0, n_live)
//   movw         [B, rp]          1 where the lane's particle moves, else 0
//   pid          [B, rp]          the lane's global particle id (N: padding)
//   pidx, is2    [B, r2]          the J=2 band's partner lane (flat) and
//                                 whether the lane holds a J=2 particle
//   lane_bnd     [B*rp]           the lane's boundary row, or -1
//   bnd_inst     [Jmax, Sb]       instance j of boundary row i (flat lane)
//   bnd_count    [Sb]             instances of boundary row i
//
// Design: the frame is one cooperative launch.  Its grid is co-resident
// (the wrapper sizes it from the occupancy query at the piece's shared
// memory, every block an SM holds) and walks two phases per substep with a
// grid barrier after each (none after the last):
//   piece phase, a block per piece, grid-stride over the B pieces: the
//     block loads the piece's position and velocity planes, predicts into
//     shared memory (gravity into vy, the velocity zeroed where movw is not
//     > 0, x + v dt) and writes the predicted planes to the scratch, walks
//     the L sub-levels in order with a barrier between them (a live thread
//     reads its tet's 4 lanes and 14 constants, runs nh::solve_tet,
//     nh_math.cuh, and writes its 4 corners back in place; the tets of a
//     sub-level share no vertex; a padded slot idles), and writes the swept
//     planes to the scratch.  The piece's three planes sit in shared memory
//     (12 rp bytes: 13.8 KB at rp = 1,152), as the first design's sweep
//     kernel kept them.
//   lane phase, a thread per lane of [B, rp], grid-stride: the Jacobi
//     completion across pieces, then collide, grab and velocity, as the
//     first design's torch ops did.  A J=2 lane (is2) becomes b + ((s - b)
//     + d_partner) * 0.5, with s and b its swept and predicted position and
//     d_partner = s - b at pidx; a lane of a boundary row becomes b + tot /
//     count, tot the row's deltas over its instances in order (instance 0,
//     + 1, + 2, ...), recomputed by each instance in the same order, so
//     every instance gets the bits of the first design's one row total;
//     any other lane keeps s.  Then the world bounds, the ground with
//     friction toward the substep's start, the grabs by global id (the
//     last one wins) and (x - start) / dt; the thread writes its lane's
//     position and velocity.
// Substep 0 reads the inputs; later ones read the outputs (a lane's
// start is read by its own thread before it writes it; the piece phase
// reads the planes the lane phase wrote only after a barrier).  2 S - 1
// barriers per frame, no atomics, deterministic.
//
// Numerics: the projection rounds as nh_math.cuh says (nvcc contracts a
// multiply and an add into one FMA where it can), as the first design's
// sweep kernel did.  Every glue operation rounds as the first design's
// torch ops: each product and sum is __fmul_rn / __fadd_rn / __fsub_rn
// (nvcc would otherwise contract b + m * 0.5 into an FMA), gravity * dt is
// the f32 product, the friction term is added to every lane (+0.0 where
// the lane is not below the ground, which turns -0.0 into +0.0, as
// torch.where(below, ..., 0.0) does), and the velocity is a true division
// by the f32 dt.  So the frame keeps the first design's bits.
//
// What bounds it: bytes, at the data sheet's peaks.  Per substep at 987,090
// tets the sweep does 0.41 GFLOP (nh_pieces.frame_flops: 6 us at 67
// TFLOP/s) and the frame must move about 120 MB (nh_pieces.frame_bytes:
// 72 bytes of tables per tet, the state planes in and out, movw, pid,
// lane_bnd and the completion's reads across pieces; about 36 us at 3.35
// TB/s).  This design moves 35 MB more per substep (nh_pieces.design_bytes:
// the scratch's round trip and a second read of the start positions).  In
// practice the L sub-levels are L dependent rounds of one projection (two
// square roots and divides) and a barrier each; the first design's sweep
// took about 53 us per substep for that, and the torch ops around it
// about 2.7 ms of device time per frame, paced by the host.  Measured on
// an H100 (PERF.md): 0.437 ms of device time per 5-substep frame, about
// 2.4x that bound, the card busy 0.98 of the frame.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nh_math.cuh"

namespace cg = cooperative_groups;

// Scalars of one frame, computed on the host.
struct NHPiecesParams {
  float dt;         // substep length
  float gdt;        // gravity * dt
  float k_fric;     // min(1, dt * friction)
  float wmin[3];
  float wmax[3];
  float dev_scale;  // dev_compliance / (dt * dt)
  float vol_scale;  // vol_compliance / (dt * dt)
  float gamma;      // vol_compliance / dev_compliance
};

// The six state planes [B, rp] at the frame start.
struct NHPiecesInputs {
  const float* p[6];
};

namespace {

constexpr int kSlots = 128;

// The piece phase on piece b (the design note); every thread of the block
// calls it.  x[r] / v[r] are the substep's start planes [B, rp].
__device__ __forceinline__ void piece_phase(
    int b, const float* const x[3], const float* const v[3], float* scratch,
    const int* __restrict__ lids, const float* __restrict__ cons,
    const int* __restrict__ n_live, const float* __restrict__ movw, int B,
    int rp, int L, const NHPiecesParams& P, float* planes) {
  const int t = threadIdx.x;
  const size_t base = (size_t)b * rp, plane = (size_t)B * rp;
  for (int i = t; i < rp; i += kSlots) {
    float vx = v[0][base + i], vy = __fadd_rn(v[1][base + i], P.gdt),
          vz = v[2][base + i];
    if (!(movw[base + i] > 0.0f)) vx = vy = vz = 0.0f;
    const float p0 = __fadd_rn(x[0][base + i], __fmul_rn(vx, P.dt));
    const float p1 = __fadd_rn(x[1][base + i], __fmul_rn(vy, P.dt));
    const float p2 = __fadd_rn(x[2][base + i], __fmul_rn(vz, P.dt));
    planes[i] = p0;
    planes[rp + i] = p1;
    planes[2 * rp + i] = p2;
    scratch[3 * plane + base + i] = p0;
    scratch[4 * plane + base + i] = p1;
    scratch[5 * plane + base + i] = p2;
  }
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const size_t lb = (size_t)l * B + b;
    if (t < n_live[lb]) {
      const int* id = lids + lb * 4 * kSlots;
      const float* cs = cons + lb * 14 * kSlots;
      int lane[4];
      float p[4][3], ir[9], w[4];
      for (int c = 0; c < 4; ++c) {
        lane[c] = id[c * kSlots + t];
        for (int r = 0; r < 3; ++r) p[c][r] = planes[r * rp + lane[c]];
        w[c] = cs[(10 + c) * kSlots + t];
      }
      for (int j = 0; j < 9; ++j) ir[j] = cs[j * kSlots + t];
      nh::solve_tet<false>(p, ir, cs[9 * kSlots + t], w, P.dev_scale,
                           P.vol_scale, P.gamma);
      for (int c = 0; c < 4; ++c)
        for (int r = 0; r < 3; ++r) planes[r * rp + lane[c]] = p[c][r];
    }
    __syncthreads();
  }

  for (int i = t; i < rp; i += kSlots) {
    scratch[base + i] = planes[i];
    scratch[plane + base + i] = planes[rp + i];
    scratch[2 * plane + base + i] = planes[2 * rp + i];
  }
  __syncthreads();  // planes serve the block's next piece
}

// d = s - b of coordinate r at flat lane f of the scratch.
__device__ __forceinline__ float delta(const float* scratch, size_t plane,
                                       int r, size_t f) {
  return __fsub_rn(scratch[r * plane + f], scratch[(3 + r) * plane + f]);
}

// The lane phase on flat lane f = b * rp + i (the design note): writes the
// lane's position to out rows 0-2 and its velocity to rows 3-5.
__device__ __forceinline__ void lane_phase(
    size_t f, const float* const x[3], const float* scratch, float* out,
    const int* __restrict__ pid, const int* __restrict__ pidx,
    const uint8_t* __restrict__ is2, const int* __restrict__ lane_bnd,
    const int* __restrict__ bnd_inst, const float* __restrict__ bnd_count,
    const int* __restrict__ gid, const float* __restrict__ gpos, int G,
    int rp, int r2, int sb, size_t plane, const NHPiecesParams& P) {
  const int i = (int)(f % rp);
  const size_t b = f / rp;
  float p[3];
  for (int r = 0; r < 3; ++r) p[r] = scratch[r * plane + f];  // swept
  const int lb = lane_bnd[f];
  if (i < r2 && is2[b * r2 + i]) {
    const size_t q = pidx[b * r2 + i];
    for (int r = 0; r < 3; ++r) {
      const float pred = scratch[(3 + r) * plane + f];
      const float m = __fmul_rn(
          __fadd_rn(__fsub_rn(p[r], pred), delta(scratch, plane, r, q)),
          0.5f);
      p[r] = __fadd_rn(pred, m);
    }
  } else if (lb >= 0) {
    const float count = bnd_count[lb];
    const int n = (int)count;
    float tot[3];
    const size_t q0 = bnd_inst[lb];
    for (int r = 0; r < 3; ++r) tot[r] = delta(scratch, plane, r, q0);
    for (int j = 1; j < n; ++j) {
      const size_t q = bnd_inst[(size_t)j * sb + lb];
      for (int r = 0; r < 3; ++r)
        tot[r] = __fadd_rn(tot[r], delta(scratch, plane, r, q));
    }
    for (int r = 0; r < 3; ++r)
      p[r] = __fadd_rn(scratch[(3 + r) * plane + f], tot[r] / count);
  }
  // collide: world bounds, then the ground with friction toward the
  // substep's start (every lane adds its friction term, 0 off the ground)
  const float sx = x[0][f], sy = x[1][f], sz = x[2][f];
  float px = fminf(fmaxf(p[0], P.wmin[0]), P.wmax[0]);
  float py = fminf(fmaxf(p[1], P.wmin[1]), P.wmax[1]);
  float pz = fminf(fmaxf(p[2], P.wmin[2]), P.wmax[2]);
  const bool below = py < 0.0f;
  if (below) py = 0.0f;
  px = __fadd_rn(px, below ? __fmul_rn(__fsub_rn(sx, px), P.k_fric) : 0.0f);
  pz = __fadd_rn(pz, below ? __fmul_rn(__fsub_rn(sz, pz), P.k_fric) : 0.0f);
  const int id = pid[f];
  for (int g = 0; g < G; ++g) {  // the last grab on the particle wins
    if (gid[g] == id) {
      px = gpos[3 * g];
      py = gpos[3 * g + 1];
      pz = gpos[3 * g + 2];
    }
  }
  out[f] = px;
  out[plane + f] = py;
  out[2 * plane + f] = pz;
  out[3 * plane + f] = __fsub_rn(px, sx) / P.dt;
  out[4 * plane + f] = __fsub_rn(py, sy) / P.dt;
  out[5 * plane + f] = __fsub_rn(pz, sz) / P.dt;
}

// S substeps of the B pieces in one cooperative launch (the design note).
// The state planes and the scratch are written by other blocks between
// barriers, so they are plain pointers (no read-only cache).
__global__ void __launch_bounds__(kSlots)
nh_pieces_frame_kernel(NHPiecesInputs in, float* out, float* scratch,
                       const int* __restrict__ lids,    // [L,B,4*CW]
                       const float* __restrict__ cons,  // [L,B,14,CW]
                       const int* __restrict__ n_live,  // [L,B]
                       const float* __restrict__ movw,  // [B,rp]
                       const int* __restrict__ pid,     // [B,rp]
                       const int* __restrict__ pidx,    // [B,r2]
                       const uint8_t* __restrict__ is2,  // [B,r2]
                       const int* __restrict__ lane_bnd,    // [B*rp]
                       const int* __restrict__ bnd_inst,    // [Jmax,Sb]
                       const float* __restrict__ bnd_count,  // [Sb]
                       const int* __restrict__ gid,          // [G]
                       const float* __restrict__ gpos,       // [G,3]
                       int B, int rp, int L, int r2, int sb, int G, int S,
                       NHPiecesParams P) {
  extern __shared__ float planes[];  // [3][rp]
  cg::grid_group grid = cg::this_grid();
  const size_t plane = (size_t)B * rp;
  const size_t first = (size_t)blockIdx.x * kSlots + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * kSlots;
  for (int s = 0; s < S; ++s) {
    const float* x[3];
    const float* v[3];
    for (int r = 0; r < 3; ++r) {
      x[r] = s == 0 ? in.p[r] : out + r * plane;
      v[r] = s == 0 ? in.p[3 + r] : out + (3 + r) * plane;
    }
    if (s > 0) grid.sync();
    for (int b = blockIdx.x; b < B; b += gridDim.x)
      piece_phase(b, x, v, scratch, lids, cons, n_live, movw, B, rp, L, P,
                  planes);
    grid.sync();
    for (size_t f = first; f < plane; f += stride)
      lane_phase(f, x, scratch, out, pid, pidx, is2, lane_bnd, bnd_inst,
                 bnd_count, gid, gpos, G, rp, r2, sb, plane, P);
  }
}

}  // namespace

extern "C" {

int nh_pieces_slots() { return kSlots; }

int nh_pieces_launches_per_frame() { return 1; }

// Blocks of the frame kernel that one SM of the current device holds at
// once with a piece of rp lanes in shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after opting in to the
// shared memory above 48 KB) and the device's SM count.  Returns the CUDA
// error.
int nh_pieces_occupancy(int rp, int* blocks_per_sm, int* sms) {
  const size_t smem = (size_t)3 * rp * sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(nh_pieces_frame_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, nh_pieces_frame_kernel, kSlots, smem);
  return (int)err;
}

// Launches S substeps on `stream`: one cooperative launch of `grid` blocks,
// which must all be resident at once (nh_pieces_occupancy).  pidx and is2
// may be null where r2 = 0.  Returns the launch's error (0 = launched).
int nh_pieces_frame_launch(NHPiecesInputs in, void* out, void* scratch,
                           const void* lids, const void* cons,
                           const void* n_live, const void* movw,
                           const void* pid, const void* pidx,
                           const void* is2, const void* lane_bnd,
                           const void* bnd_inst, const void* bnd_count,
                           const void* gid, const void* gpos, int B, int rp,
                           int L, int r2, int sb, int G, int S, int grid,
                           NHPiecesParams P, void* stream) {
  const size_t smem = (size_t)3 * rp * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    err = cudaFuncSetAttribute(nh_pieces_frame_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  float* a1 = (float*)out;
  float* a2 = (float*)scratch;
  const int* a3 = (const int*)lids;
  const float* a4 = (const float*)cons;
  const int* a5 = (const int*)n_live;
  const float* a6 = (const float*)movw;
  const int* a7 = (const int*)pid;
  const int* a8 = (const int*)pidx;
  const uint8_t* a9 = (const uint8_t*)is2;
  const int* a10 = (const int*)lane_bnd;
  const int* a11 = (const int*)bnd_inst;
  const float* a12 = (const float*)bnd_count;
  const int* a13 = (const int*)gid;
  const float* a14 = (const float*)gpos;
  void* args[] = {&in,  &a1,  &a2,  &a3, &a4, &a5, &a6, &a7, &a8,
                  &a9,  &a10, &a11, &a12, &a13, &a14, &B, &rp, &L,
                  &r2,  &sb,  &G,   &S,  &P};
  err = cudaLaunchCooperativeKernel((const void*)nh_pieces_frame_kernel,
                                    dim3(grid), dim3(kSlots), args, smem,
                                    (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

const char* nh_pieces_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
