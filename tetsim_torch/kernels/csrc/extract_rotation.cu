// extract_rotation micro-kernel: k passes of Müller's 9-iteration polar
// decomposition on covariance planes held in registers, one lane per
// thread, the measured floor of the polar kernels' rotation solve.
//
// Replaces the TPU kernel tetsim_tpu's scripts/roofline.py:
// bench_extract_rotation_kernel (the pallas_call there).  What it
// computes: for each lane, k times, the grid engine's extract_rotation
// (polar::extract_rotation<AxisForm::kReciprocal>, the variant K4 runs)
// from the identity on the nine planes a[r][c], then a00 += qw * 1e-20, a
// data-dependent feedback so no pass can be folded away; it writes the last
// pass's quaternion as four planes.
//
// What bounds it: the instruction stream.  After the one read of its 36
// bytes a lane touches no memory until it writes 16: a pass is 9
// iterations of about 136 flops with a square root, three divides, a sine
// and a cosine, a dependent chain per lane.  At IEEE rounding each divide
// is a reciprocal, Newton steps and a check that calls a slow path (never
// taken on these planes), the sine and cosine a range reduction whose
// Payne-Hanek branch (|x| >= 105615) keeps a local-memory frame; the fast
// path of one iteration is about 190 SASS instructions, so the card's
// issue rate (4 warp instructions per SM and cycle) and not its flop rate
// sets the floor (profile_frame.py --phases counts them).  The design
// gives every lane its own thread and keeps the planes in registers, so a
// two-point fit over the pass count k measures that stream alone, across
// the whole card.  It runs polar_math.cuh's iteration itself, so that it
// stays the floor of the code K4 runs.

#include <cuda_runtime.h>

#include "polar_math.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
extract_rotation_kernel(const float* __restrict__ a_in,  // [9, L]
                        float* __restrict__ q_out,       // [4, L]
                        int L, int passes, int iters) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= L) return;
  float a[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) a[r][c] = a_in[(size_t)(3 * r + c) * L + i];
  float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = 0; k < passes; ++k) {
    q = polar::extract_rotation<polar::AxisForm::kReciprocal>(
        a, make_float4(0.0f, 0.0f, 0.0f, 1.0f), iters);
    a[0][0] = a[0][0] + q.w * 1e-20f;
  }
  q_out[i] = q.x;
  q_out[(size_t)L + i] = q.y;
  q_out[(size_t)2 * L + i] = q.z;
  q_out[(size_t)3 * L + i] = q.w;
}

#ifdef EXTRACT_ROTATION_PROBE
// For profile_frame.py's SASS counts only: n of the kernel's iterations,
// one after another, from a quaternion the compiler cannot see;
// probe<2> less probe<1> is one iteration's code.
template <int n>
__device__ __forceinline__ void probe(const float* a_in, float4 q,
                                      float* q_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float a[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) a[r][c] = a_in[9 * i + 3 * r + c];
#pragma unroll
  for (int it = 0; it < n; ++it)
    q = polar::extract_rotation<polar::AxisForm::kReciprocal>(a, q, 1);
  reinterpret_cast<float4*>(q_out)[i] = q;
}

__global__ void extract_rotation_probe1(const float* a_in, float4 q0,
                                        float* q_out) {
  probe<1>(a_in, q0, q_out);
}

__global__ void extract_rotation_probe2(const float* a_in, float4 q0,
                                        float* q_out) {
  probe<2>(a_in, q0, q_out);
}
#endif

}  // namespace

extern "C" {

int extract_rotation_threads() { return kThreads; }

// Launches the k passes on `stream`; returns cudaGetLastError() (0 = launched).
int extract_rotation_launch(const void* a_in, void* q_out, int L, int passes,
                            int iters, void* stream) {
  const int blocks = (L + kThreads - 1) / kThreads;
  extract_rotation_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a_in, (float*)q_out, L, passes, iters);
  return (int)cudaGetLastError();
}

const char* extract_rotation_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
