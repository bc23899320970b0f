// Polar shape-matching solve on the pieces of one unstructured mesh: the
// solve of the polar_pieces engine, tetsim_torch/kernels/polar_pieces.py,
// whose pieces_solve_reference is its plain twin.
//
// Replaces the TPU kernel tetsim_tpu/kernels/polar_pieces.py:
// _make_solve_kernel (built by _solve_call).  That kernel walks 8 pieces per
// grid step in VMEM and splits every gather into per-tile dynamic gathers
// (the source-tile lists); on the card a thread addresses any lane, so the
// kernel reads the same tables and no tile lists.
//
// Layout (B pieces, rt tet lanes and rp particle lanes per piece):
//   px, py, pz  [B, rp]      predicted local positions
//   quat_in/out [4, B, rt]   component-major quaternions
//   ids         [4, B, rt]   corner k of tet lane t -> local particle lane
//   rc          [12, B, rt]  rest corner k, coordinate r at row 3k + r
//   wvol        [B, rt]      rest volume (0 on padded tet lanes)
//   inc         [K, B, rp]   bank v of a lane: its v-th corner slot k*rt + t,
//                            -1 after the last (the live banks are a prefix)
//   num         [3, B, rp]   out: partial numerators (the piece's sum)
//
// Design: one launch per substep, no atomics, no global scratch, a fixed
// order.  A persistent grid of (blocks per SM x SMs) blocks of kThreads
// threads; block x walks the pieces x, x + gridDim.x, ...  A piece's whole
// solve stays in its block's shared memory: its position planes [3][rp]
// and its weighted goal deltas [3][4 rt] at slot k*rt + t, the slot order
// of the incidence banks (smem_bytes: 12 rp + 48 rt bytes, 109.5 KB at
// rp 1,152 and rt 2,048, so two blocks fit an SM).
//   0. The block copies the piece's planes into shared memory.
//   1. The piece's tet lanes, strided over the threads (neighbouring
//      threads on neighbouring lanes, so every table is read coalesced):
//      gather the 4 corners from the shared planes, the centroid
//      (((c0 + c1) + c2) + c3) / 4, the covariance with the rest corners
//      rotated by the tet's quaternion, extract_rotation from the identity
//      (polar_math.cuh, the grid engine's axis form), the quaternion update
//      q <- normalise(dq q) with a 1e-30 floor on the norm, written to
//      quat_out; then the 4 goal deltas (rotated rest corner - centred
//      corner) * rest volume into shared memory.
//   2. After a barrier, the piece's particle lanes, strided over the
//      threads: each lane's incidence banks in order, starting from 0.0,
//      into the numerator planes.  A barrier ends the piece.
// A padded tet lane (corner lane 0, rest volume 0) computes a zero delta; a
// padded particle lane has no incidence and gets 0.
//
// Numerics: the sums of phase 2 round every addition as the plain twin
// does; the tet arithmetic is contracted by nvcc into FMAs where it can, so
// a result may differ from the twin's in its last bits.  The arithmetic and
// the order are the first design's (a tet pass and a lane pass, two
// launches, the deltas through a global scratch), so its bits stay.
//
// What bounds it: bytes, at the data sheet's peaks.  Per substep at 987,090
// tets the solve does 1.59 GFLOP (polar_pieces.frame_flops: 24 us at 67
// TFLOP/s) and must move 129 MB (frame_bytes: 116 bytes per tet, the planes
// 14 MB; 38.4 us at 3.35 TB/s).  The first design moved the deltas
// through a 50.3 MB global scratch, written by a tet pass and read back
// through the incidence banks by a lane pass, about 100 MB more per
// substep; here no delta leaves the SM, so the solve moves the 129 MB.
// Measured at 987,090 tets (profile_frame.py --parent / --variants, NVIDIA
// H100 80GB HBM3 at 700 W): the first design's tet pass took 103.8-104.2
// us (64 registers, 128 threads, 1,024 resident threads per SM) and its
// lane pass 54.1-54.2 us, 0.158 ms per solve by CUDA events.  This kernel,
// at 64 registers, 2 blocks of 512 threads per SM (1,024 resident threads,
// the shared memory allows no more), takes 0.129 ms: 3.4x the byte bound,
// 2.0x K9's measured pass per lane (extract_rotation.cu, 0.064 ms per
// 1,048,576 lanes).  What it loses to the tet pass alone is the piece's
// barriers and the lane phase, during which half the SM's threads wait;
// loading a lane's 24 banks at once (a global round trip each) instead of
// 8 took 0.132 -> 0.129 ms.  256 and 384 threads per block (72 registers,
// 512 / 768 resident threads) took 0.161 and 0.154 ms, 576 (56 registers,
// spills) 0.135, and the planes read from global memory 0.152 against
// 0.151 at that stage.

#include <cuda_runtime.h>
#include <stdint.h>

#include "polar_math.cuh"

namespace {

// threads per block (profile_frame.py builds others to compare)
#ifndef POLAR_PIECES_THREADS
#define POLAR_PIECES_THREADS 512
#endif
constexpr int kThreads = POLAR_PIECES_THREADS;
constexpr int kBlocksPerSM = 2;  // the shared memory of the default pieces
constexpr int kBanks = 24;  // incidence banks a lane loads at once

size_t smem_bytes(int rp, int rt) {
  return sizeof(float) * ((size_t)3 * rp + (size_t)12 * rt);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
polar_pieces_kernel(const float* __restrict__ px,
                    const float* __restrict__ py,
                    const float* __restrict__ pz,
                    const float* __restrict__ quat_in,  // [4,B,rt]
                    float* __restrict__ quat_out,       // [4,B,rt]
                    const int* __restrict__ ids,        // [4,B,rt]
                    const int* __restrict__ inc,        // [K,B,rp]
                    const float* __restrict__ rc,       // [12,B,rt]
                    const float* __restrict__ wvol,     // [B,rt]
                    float* __restrict__ num,            // [3,B,rp]
                    int B, int rp, int rt, int K, int iters) {
  extern __shared__ float smem[];
  float* planes = smem;         // [3][rp]
  float* delta = smem + 3 * rp;  // [3][4 rt]
  const size_t tplane = (size_t)B * rt, lplane = (size_t)B * rp;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const size_t lane0 = (size_t)b * rp;
    for (int l = threadIdx.x; l < rp; l += kThreads) {
      planes[l] = px[lane0 + l];
      planes[rp + l] = py[lane0 + l];
      planes[2 * rp + l] = pz[lane0 + l];
    }
    __syncthreads();

    for (int t = threadIdx.x; t < rt; t += kThreads) {
      const size_t idx = (size_t)b * rt + t;
      float p[4][3], rest[4][3];
      for (int c = 0; c < 4; ++c) {
        const int lane = ids[c * tplane + idx];
        for (int r = 0; r < 3; ++r) {
          p[c][r] = planes[r * rp + lane];
          rest[c][r] = rc[(3 * c + r) * tplane + idx];
        }
      }
      float pc[4][3];
      for (int r = 0; r < 3; ++r) {
        const float cc = (((p[0][r] + p[1][r]) + p[2][r]) + p[3][r]) * 0.25f;
        for (int c = 0; c < 4; ++c) pc[c][r] = p[c][r] - cc;
      }

      float4 q = make_float4(quat_in[idx], quat_in[tplane + idx],
                             quat_in[2 * tplane + idx],
                             quat_in[3 * tplane + idx]);
      float rr[4][3];
      for (int c = 0; c < 4; ++c) polar::qrot(rest[c], q, rr[c]);
      float a[3][3];  // a[r][c] = sum_k pc[k][r] * rr[k][c]
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c)
          a[r][c] = ((pc[0][r] * rr[0][c] + pc[1][r] * rr[1][c]) +
                     pc[2][r] * rr[2][c]) + pc[3][r] * rr[3][c];
      const float4 dq =
          polar::extract_rotation<polar::AxisForm::kReciprocal>(
              a, make_float4(0.0f, 0.0f, 0.0f, 1.0f), iters);
      q = polar::qnormalize_guarded(polar::qmul(dq, q));
      quat_out[idx] = q.x;
      quat_out[tplane + idx] = q.y;
      quat_out[2 * tplane + idx] = q.z;
      quat_out[3 * tplane + idx] = q.w;

      const float w = wvol[idx];
      for (int c = 0; c < 4; ++c) {
        float g[3];
        polar::qrot(rest[c], q, g);
        for (int r = 0; r < 3; ++r)
          delta[r * 4 * rt + c * rt + t] = __fmul_rn(g[r] - pc[c][r], w);
      }
    }
    __syncthreads();

    for (int l = threadIdx.x; l < rp; l += kThreads) {
      const size_t idx = lane0 + l;
      float s[3] = {0.0f, 0.0f, 0.0f};
      // the banks kBanks at a time, loaded together; the live banks are a
      // prefix, so the walk stops at the first -1
      for (int v0 = 0; v0 < K; v0 += kBanks) {
        int e[kBanks];
        for (int j = 0; j < kBanks; ++j)
          e[j] = v0 + j < K ? inc[(v0 + j) * lplane + idx] : -1;
        bool live = true;
        for (int j = 0; j < kBanks && live; ++j) {
          live = e[j] >= 0;
          if (live)
            for (int r = 0; r < 3; ++r)
              s[r] = __fadd_rn(s[r], delta[r * 4 * rt + e[j]]);
        }
        if (!live) break;
      }
      for (int r = 0; r < 3; ++r) num[r * lplane + idx] = s[r];
    }
    __syncthreads();  // before the next piece reuses the buffers
  }
}

// The persistent grid on the current device for pieces of this size: the
// blocks an SM holds times the SMs (0 where a block does not fit), asked
// once per device and size.
int grid_size(size_t smem, int* grid) {
  static int cached_dev = -1, cached_grid = 0;
  static size_t cached_smem = 0;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev == cached_dev && smem == cached_smem) {
    *grid = cached_grid;
    return 0;
  }
  err = cudaFuncSetAttribute(polar_pieces_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, polar_pieces_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cached_dev = dev;
  cached_smem = smem;
  cached_grid = *grid = per_sm * sms;
  return 0;
}

}  // namespace

extern "C" {

int polar_pieces_launches_per_substep() { return 1; }

int polar_pieces_threads() { return kThreads; }

size_t polar_pieces_smem_bytes(int rp, int rt) { return smem_bytes(rp, rt); }

// Launches one solve on `stream`; returns the launch error (0 = launched;
// cudaErrorInvalidConfiguration where a piece's block does not fit an SM).
int polar_pieces_launch(const void* px, const void* py, const void* pz,
                        const void* quat_in, void* quat_out, void* num,
                        const void* ids, const void* inc, const void* rc,
                        const void* wvol, int B, int rp, int rt, int K,
                        int iters, void* stream) {
  const size_t smem = smem_bytes(rp, rt);
  int grid = 0;
  int err = grid_size(smem, &grid);
  if (err) return err;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = grid < B ? grid : B;
  polar_pieces_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)px, (const float*)py, (const float*)pz,
      (const float*)quat_in, (float*)quat_out, (const int*)ids,
      (const int*)inc, (const float*)rc, (const float*)wvol, (float*)num, B,
      rp, rt, K, iters);
  return (int)cudaGetLastError();
}

const char* polar_pieces_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
