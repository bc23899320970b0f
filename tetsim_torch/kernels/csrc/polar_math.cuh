// Quaternion math of the polar shape-matching solve, shared by the CUDA
// kernels that run it (polar_frame.cu, polar_stencil.cu, polar_pieces.cu).
// Quaternions are float4 (x, y, z, w).
//
// Every expression follows tetsim_torch/solvers/polar.py term by term and
// in its order.  nvcc contracts a multiply and an add into one FMA where it
// can, so a result may differ from the plain path's in its last bits.

#pragma once

#include <cuda_runtime.h>

namespace polar {

constexpr float kEps = 1e-9f;

// Hamilton product a b (polar.quat_mul).
__device__ __forceinline__ float4 qmul(float4 a, float4 b) {
  return make_float4(a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
                     a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
                     a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
                     a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z);
}

// v + 2 u x (u x v + w v), u = (q.x, q.y, q.z) (polar.quat_rotate).
__device__ __forceinline__ void qrot(const float v[3], float4 q, float out[3]) {
  const float tx = (q.y * v[2] - q.z * v[1]) + q.w * v[0];
  const float ty = (q.z * v[0] - q.x * v[2]) + q.w * v[1];
  const float tz = (q.x * v[1] - q.y * v[0]) + q.w * v[2];
  out[0] = v[0] + 2.0f * (q.y * tz - q.z * ty);
  out[1] = v[1] + 2.0f * (q.z * tx - q.x * tz);
  out[2] = v[2] + 2.0f * (q.x * ty - q.y * tx);
}

// q / |q|, squares added in x, y, z, w order (polar.quat_normalize).
__device__ __forceinline__ float4 qnormalize(float4 q) {
  const float n = sqrtf(((q.x * q.x + q.y * q.y) + q.z * q.z) + q.w * q.w);
  return make_float4(q.x / n, q.y / n, q.z / n, q.w / n);
}

// q / max(|q|, 1e-30): the grid and pieces engines' normalisation, which
// keeps a zero quaternion finite.
__device__ __forceinline__ float4 qnormalize_guarded(float4 q) {
  const float n =
      fmaxf(sqrtf(((q.x * q.x + q.y * q.y) + q.z * q.z) + q.w * q.w), 1e-30f);
  return make_float4(q.x / n, q.y / n, q.z / n, q.w / n);
}

// How a step's axis-angle quaternion is formed: solvers/polar.py divides
// omega by the angle first, (omega / angle) * sin(angle / 2);
// solvers/polar_grid.py scales omega by sin(angle / 2) * (1 / angle).
enum class AxisForm { kDivideFirst, kReciprocal };

// Müller's iteration toward the covariance a[r][c] from q, a fixed trip
// count with a masked update (polar.extract_rotation).
template <AxisForm kForm = AxisForm::kDivideFirst>
__device__ __forceinline__ float4 extract_rotation(const float a[3][3],
                                                   float4 q, int iters) {
  for (int it = 0; it < iters; ++it) {
    const float x = q.x, y = q.y, z = q.z, w = q.w;
    float m[3][3];  // m[r][c], column c = R e_c (polar.quat_to_mat)
    m[0][0] = 1.0f - 2.0f * (y * y + z * z);
    m[1][0] = 2.0f * (x * y + z * w);
    m[2][0] = 2.0f * (x * z - y * w);
    m[0][1] = 2.0f * (x * y - z * w);
    m[1][1] = 1.0f - 2.0f * (x * x + z * z);
    m[2][1] = 2.0f * (y * z + x * w);
    m[0][2] = 2.0f * (x * z + y * w);
    m[1][2] = 2.0f * (y * z - x * w);
    m[2][2] = 1.0f - 2.0f * (x * x + y * y);
    float o[3] = {0.0f, 0.0f, 0.0f};
    for (int c = 0; c < 3; ++c) {  // sum over columns of cross(m_c, a_c)
      const float cx = m[1][c] * a[2][c] - m[2][c] * a[1][c];
      const float cy = m[2][c] * a[0][c] - m[0][c] * a[2][c];
      const float cz = m[0][c] * a[1][c] - m[1][c] * a[0][c];
      if (c == 0) {
        o[0] = cx;
        o[1] = cy;
        o[2] = cz;
      } else {
        o[0] += cx;
        o[1] += cy;
        o[2] += cz;
      }
    }
    float den = m[0][0] * a[0][0];
    for (int i = 1; i < 9; ++i) den += m[i / 3][i % 3] * a[i / 3][i % 3];
    den = fabsf(den) + kEps;
    const float ox = o[0] / den, oy = o[1] / den, oz = o[2] / den;
    const float angle = sqrtf((ox * ox + oy * oy) + oz * oz);
    if (angle >= kEps) {
      const float half = angle * 0.5f;
      float4 dq;
      if (kForm == AxisForm::kDivideFirst) {
        const float s = sinf(half);
        dq = make_float4((ox / angle) * s, (oy / angle) * s, (oz / angle) * s,
                         cosf(half));
      } else {
        const float s = sinf(half) * (1.0f / angle);
        dq = make_float4(ox * s, oy * s, oz * s, cosf(half));
      }
      q = qmul(dq, q);
    }
  }
  return q;
}

}  // namespace polar
