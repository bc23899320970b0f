// The level solve of the dense Neo-Hookean engine (solvers/dense.py): both
// constraints of every slot of one colour level, for every body, between
// the level's one-hot gather and scatter products.
//
// Replaces no TPU kernel: the JAX package runs this solve as XLA's fusion
// of _solve_level_planes (tetsim_tpu/solvers/dense.py:123-181), between
// two MXU products.  In eager torch that function is about 150 elementwise
// launches per level, so the port fuses it into one launch, as XLA does.
//
// Layout: g and d are [4C, 3B] row-major, as the gather product gives
// them: row c*C + t is corner c of slot t, column r*B + b is coordinate r
// of body b.  The level's tables are irp [9, C] (row-major inverse rest
// pose), irv [C] and imc [4, C].  One thread per (slot, body), the body
// fastest, so that a warp's reads of a row of g are contiguous; it reads
// its tet's 12 coordinates and 14 constants, projects it (nh::solve_tet_
// delta, nh_math.cuh, the arithmetic of the port's other Neo-Hookean
// kernels) and writes the 12 deltas d_dev + d_vol.  Padded slots (all
// tables 0, corners gathered as 0) give a zero delta, as in the plain
// twin; nothing is masked, so a NaN gathered into a slot reaches its delta
// as it does in the JAX package.
//
// What bounds it: bytes.  A level reads g and writes d, 96 bytes per slot
// and body, and does about 421 flops per slot and body: 4.4 flops a byte,
// under the card's 20 (67 TFLOP/s over 3.35 TB/s).  At the dragon's greedy
// levels (C = 256) and B = 128 that is 3.1 MB, about 0.94 us at 3.35 TB/s,
// under the cost of a launch; the L x num_substeps launches of a frame
// and the products around them, not this kernel, set the frame's pace.

#include <cuda_runtime.h>

#include "nh_math.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dense_level_kernel(const float* __restrict__ g,    // [4C, 3B]
                   const float* __restrict__ irp,  // [9, C]
                   const float* __restrict__ irv,  // [C]
                   const float* __restrict__ imc,  // [4, C]
                   float* __restrict__ d,          // [4C, 3B]
                   int C, int B, float dev_scale, float vol_scale,
                   float gamma) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= C * B) return;
  const int t = i / B, b = i - t * B;
  const size_t row = (size_t)3 * B;
  float p[4][3], ir[9], w[4], dd[4][3];
  for (int c = 0; c < 4; ++c)
    for (int r = 0; r < 3; ++r)
      p[c][r] = g[(size_t)(c * C + t) * row + r * B + b];
  for (int k = 0; k < 9; ++k) ir[k] = irp[k * C + t];
  for (int c = 0; c < 4; ++c) w[c] = imc[c * C + t];
  nh::solve_tet_delta(p, ir, irv[t], w, dev_scale, vol_scale, gamma, dd);
  for (int c = 0; c < 4; ++c)
    for (int r = 0; r < 3; ++r)
      d[(size_t)(c * C + t) * row + r * B + b] = dd[c][r];
}

}  // namespace

extern "C" {

int dense_level_threads() { return kThreads; }

// Launches one level's solve on `stream`; returns cudaGetLastError() (0 =
// launched).
int dense_level_launch(const void* g, const void* irp, const void* irv,
                       const void* imc, void* d, int C, int B,
                       float dev_scale, float vol_scale, float gamma,
                       void* stream) {
  const int blocks = (C * B + kThreads - 1) / kThreads;
  dense_level_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)irp, (const float*)irv,
      (const float*)imc, (float*)d, C, B, dev_scale, vol_scale, gamma);
  return (int)cudaGetLastError();
}

const char* dense_level_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
