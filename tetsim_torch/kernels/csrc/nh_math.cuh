// The stable Neo-Hookean XPBD projection of one tet, shared by the CUDA
// kernels that run it: gs_frame.cu (coloured GS over a mesh's level
// schedule), nh_stencil.cu (the 48-colour grid sweep), the other
// Neo-Hookean kernels and dense_frame.cu (the dense engine's frame).  It is the device
// function _solve_level of tetsim_tpu/kernels/gs_fused.py and _solve_color
// of tetsim_tpu/solvers/neohookean_grid.py: a deviatoric step C = ||F||_F,
// then a hydrostatic step C = det F - 1 - gamma on the corners the first
// step moved.  Every sum follows the plain paths' order; nvcc contracts a
// multiply and an add into one FMA where it can.

#pragma once

#include <cuda_runtime.h>

namespace nh {

// XPBD projection of one constraint.  g[j][r]: gradient of corner j+1,
// coordinate r (corner 0 gets minus their sum).  Writes the delta of the
// four corners into d.
__device__ __forceinline__ void xpbd(const float g[3][3], float c, float scale,
                                     float irv, const float w[4],
                                     float d[4][3]) {
  float gall[4][3];
  for (int r = 0; r < 3; ++r) {
    gall[0][r] = -((g[0][r] + g[1][r]) + g[2][r]);
    gall[1][r] = g[0][r];
    gall[2][r] = g[1][r];
    gall[3][r] = g[2][r];
  }
  float wsum = 0.0f;
  for (int i = 0; i < 4; ++i) {
    float n2 = (gall[i][0] * gall[i][0] + gall[i][1] * gall[i][1]) +
               gall[i][2] * gall[i][2];
    wsum += n2 * w[i];
  }
  const float alpha = scale * irv;
  const bool ok = (c != 0.0f) && (wsum != 0.0f);
  const float dl = ok ? -c / (wsum + alpha) : 0.0f;
  for (int i = 0; i < 4; ++i)
    for (int r = 0; r < 3; ++r) d[i][r] = (dl * w[i]) * gall[i][r];
}

// F[r][c] = sum_k e[k][r] * ir[k][c], e[k] = p[k+1] - p[0].
__device__ __forceinline__ void deformation(const float p[4][3],
                                            const float ir[9], float f[3][3]) {
  float e[3][3];
  for (int k = 0; k < 3; ++k)
    for (int r = 0; r < 3; ++r) e[k][r] = p[k + 1][r] - p[0][r];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      f[r][c] = (e[0][r] * ir[c] + e[1][r] * ir[3 + c]) + e[2][r] * ir[6 + c];
}

// Both constraints on one tet with rest pose ir (row-major), inverse rest
// volume irv, corner inverse masses w and the scales compliance / dt^2:
// the deviatoric step's delta on p into d_dev, the hydrostatic step's on
// p + d_dev into d_vol.  Returns det F - 1 on the corners the hydrostatic
// step saw.
__device__ __forceinline__ float project(const float p[4][3], const float ir[9],
                                         float irv, const float w[4],
                                         float dev_scale, float vol_scale,
                                         float gamma, float d_dev[4][3],
                                         float d_vol[4][3]) {
  float f[3][3], g[3][3], q[4][3];

  // deviatoric: C = ||F||_F
  deformation(p, ir, f);
  float rs2 = 0.0f;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) rs2 += f[r][c] * f[r][c];
  const float rs = sqrtf(rs2);
  const float rinv = rs > 0.0f ? 1.0f / rs : 0.0f;
  for (int j = 0; j < 3; ++j)
    for (int r = 0; r < 3; ++r)
      g[j][r] = ((f[r][0] * ir[3 * j] + f[r][1] * ir[3 * j + 1]) +
                 f[r][2] * ir[3 * j + 2]) * rinv;
  xpbd(g, rs, dev_scale, irv, w, d_dev);
  for (int i = 0; i < 4; ++i)
    for (int r = 0; r < 3; ++r) q[i][r] = p[i][r] + d_dev[i][r];

  // hydrostatic: C = det F - 1 - gamma on the updated corners
  deformation(q, ir, f);
  float df[3][3];  // df[r][c]: column c of the cofactor matrix
  for (int c = 0; c < 3; ++c) {
    const int a = (c + 1) % 3, b = (c + 2) % 3;
    df[0][c] = f[1][a] * f[2][b] - f[2][a] * f[1][b];
    df[1][c] = f[2][a] * f[0][b] - f[0][a] * f[2][b];
    df[2][c] = f[0][a] * f[1][b] - f[1][a] * f[0][b];
  }
  for (int j = 0; j < 3; ++j)
    for (int r = 0; r < 3; ++r)
      g[j][r] = (df[r][0] * ir[3 * j] + df[r][1] * ir[3 * j + 1]) +
                df[r][2] * ir[3 * j + 2];
  const float det = (f[0][0] * df[0][0] + f[1][0] * df[1][0]) +
                    f[2][0] * df[2][0];
  const float c_vol = (det - 1.0f) - gamma;
  xpbd(g, c_vol, vol_scale, irv, w, d_vol);
  return det - 1.0f;
}

// ``project`` applied to p in place: p + (d_dev + d_vol) (the generic
// engine's order) or, with kInOrder, (p + d_dev) + d_vol (the grid
// engine's, which applies each step to the corners in turn).  Returns det
// F - 1 on the corners the hydrostatic step saw.
template <bool kInOrder = false>
__device__ __forceinline__ float solve_tet(float p[4][3], const float ir[9],
                                           float irv, const float w[4],
                                           float dev_scale, float vol_scale,
                                           float gamma) {
  float d_dev[4][3], d_vol[4][3];
  const float err = project(p, ir, irv, w, dev_scale, vol_scale, gamma,
                            d_dev, d_vol);
  for (int i = 0; i < 4; ++i)
    for (int r = 0; r < 3; ++r)
      p[i][r] = kInOrder ? (p[i][r] + d_dev[i][r]) + d_vol[i][r]
                         : p[i][r] + (d_dev[i][r] + d_vol[i][r]);
  return err;
}

// The delta d_dev + d_vol of ``project`` into d, p left as it is (the
// dense engine's frame, dense_frame.cu, which scatters the delta).
__device__ __forceinline__ void solve_tet_delta(const float p[4][3],
                                                const float ir[9], float irv,
                                                const float w[4],
                                                float dev_scale,
                                                float vol_scale, float gamma,
                                                float d[4][3]) {
  float d_dev[4][3], d_vol[4][3];
  project(p, ir, irv, w, dev_scale, vol_scale, gamma, d_dev, d_vol);
  for (int i = 0; i < 4; ++i)
    for (int r = 0; r < 3; ++r) d[i][r] = d_dev[i][r] + d_vol[i][r];
}

}  // namespace nh
