// Neo-Hookean Gauss-Seidel sweep on the pieces of one unstructured mesh:
// the per-piece solve of the nh_pieces engine,
// tetsim_torch/kernels/nh_pieces.py, whose nh_pieces_solve_reference is its
// plain twin.
//
// Replaces the TPU kernel tetsim_tpu/kernels/nh_pieces.py:_make_solve_kernel
// (built by _solve_call).  That kernel gathers each sub-level's corners from
// VMEM planes with per-tile dynamic gathers and writes them back with a
// second gather through the inverse table winv; on the card a thread reads
// and writes its tet's corners in shared memory directly, so winv is not
// read.
//
// Layout (B pieces, rp lanes per piece, L sub-levels of CW = 128 slots):
//   px, py, pz   [B, rp]          predicted local positions (in)
//   ox, oy, oz   [B, rp]          swept positions (out)
//   lids         [L, B, 4*CW]     corner c of slot t at c*CW + t -> lane
//   cons         [L, B, 14, CW]   rows 0-8 inverse rest pose (row-major),
//                                 9 inverse rest volume, 10-13 inverse masses
//   n_live       [L, B]           live slots of a sub-level: [0, n_live)
//
// Design: one block per piece (512 at 987,090 tets and 2,048 tets per
// piece), one thread per slot of a sub-level.  The piece's three planes sit
// in shared memory (12 rp bytes: 13.8 KB at rp = 1,152).  The block walks
// the sub-levels in order with a barrier between them; at each, a live
// thread reads its 4 lanes and 14 constants (neighbouring threads on
// neighbouring addresses), runs nh::solve_tet (nh_math.cuh, K1's
// composition p + (d_dev + d_vol)) and writes its 4 corners back in place.
// The tets of a sub-level share no vertex, so that is race-free; a padded
// slot (past n_live) would read lane 0 with zero constants and must not
// write, so it idles.  One launch per substep.
//
// Numerics: the projection rounds as nh_math.cuh says (nvcc contracts a
// multiply and an add into one FMA where it can), so a result may differ
// from the plain twin's in its last bits.
//
// What bounds it: bytes, at the data sheet's peaks.  Per substep at 987,090
// tets the sweep does 0.41 GFLOP (nh_pieces.frame_flops: 6 us at 67
// TFLOP/s) and must move 85 MB (frame_bytes: 72 bytes of tables per tet
// and the planes; 25 us at 3.35 TB/s).  The tables are read once, coalesced;
// the planes go through shared memory once each way.  In practice the L
// sub-levels are L dependent rounds of one projection (two square roots
// and divides) and a barrier each; with up to 16 blocks resident per SM,
// the 512 blocks run in one wave, so the rounds, not the bytes, are the
// likely limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nh_math.cuh"

// Scalars of one substep, computed on the host.
struct NHPiecesParams {
  float dev_scale;  // dev_compliance / (dt * dt)
  float vol_scale;  // vol_compliance / (dt * dt)
  float gamma;      // vol_compliance / dev_compliance
};

namespace {

constexpr int kSlots = 128;

__global__ void __launch_bounds__(kSlots)
nh_pieces_kernel(const float* __restrict__ px, const float* __restrict__ py,
                 const float* __restrict__ pz, float* __restrict__ ox,
                 float* __restrict__ oy, float* __restrict__ oz,
                 const int* __restrict__ lids,    // [L,B,4*CW]
                 const float* __restrict__ cons,  // [L,B,14,CW]
                 const int* __restrict__ n_live,  // [L,B]
                 int B, int rp, int L, NHPiecesParams P) {
  extern __shared__ float planes[];  // [3][rp]
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t base = (size_t)b * rp;
  for (int i = t; i < rp; i += kSlots) {
    planes[i] = px[base + i];
    planes[rp + i] = py[base + i];
    planes[2 * rp + i] = pz[base + i];
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
    ox[base + i] = planes[i];
    oy[base + i] = planes[rp + i];
    oz[base + i] = planes[2 * rp + i];
  }
}

}  // namespace

extern "C" {

int nh_pieces_slots() { return kSlots; }

// Launches one sweep on `stream`; returns the launch error (0 = launched).
int nh_pieces_launch(const void* px, const void* py, const void* pz, void* ox,
                     void* oy, void* oz, const void* lids, const void* cons,
                     const void* n_live, int B, int rp, int L,
                     NHPiecesParams P, void* stream) {
  const size_t smem = (size_t)3 * rp * sizeof(float);
  cudaError_t err;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    err = cudaFuncSetAttribute(nh_pieces_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nh_pieces_kernel<<<B, kSlots, smem, (cudaStream_t)stream>>>(
      (const float*)px, (const float*)py, (const float*)pz, (float*)ox,
      (float*)oy, (float*)oz, (const int*)lids, (const float*)cons,
      (const int*)n_live, B, rp, L, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return 0;
}

const char* nh_pieces_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
