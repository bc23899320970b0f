// One frame of the dense Neo-Hookean engine (solvers/dense.py) for B bodies
// of one mesh held in columns: every substep's predict, colour levels,
// collide, grab and velocity update, in one launch.
//
// Replaces no TPU kernel: the JAX package runs this frame as XLA's scan
// over the levels of tetsim_tpu/solvers/dense.py:184-257, each level a
// one-hot gather product on the MXU, XLA's fusion of _solve_level_planes
// and a one-hot scatter product.  It routes the gather and scatter through
// the MXU because XLA's per-row scatter costs about 18 ns a row on a TPU
// (tetsim_tpu/solvers/dense.py:1-25).  On an H100 a thread reads any
// address, and the one-hot products reduce to index operations: a column
// of the one-hot holds one 1, and within a level a particle is a corner of
// one valid slot at most, so the gather is pos[ids] and the scatter pos[ids]
// += delta, both exact.
//
// Design: one thread block per body (grid = B; the blocks never wait on
// each other).  The body's positions live in three planes (12 bytes a
// particle): in dynamic shared memory up to 19,370 particles a body (14.8
// KB for the dragon), past that in a global scratch [B, 3, N] that the
// wrapper allocates (the global form, kGlobal: 1.86 MB at N = 19,372 and B
// = 8, which stays in L2).  Only block b reads and writes its planes, with
// plain loads and stores (never the read-only path: they change during the
// launch), so the barriers that order the shared form's accesses order the
// global form's too (__syncthreads makes a block's global writes visible to
// the block).  The form is the host's plan from N (launch_plan in
// dense_frame.py); the walk below is one body for both.  Each thread owns
// particles tid, tid + kThreads, ... in every per-particle pass, so what
// passes between those passes needs no barrier: prev stays in the owner's
// registers (its first kOwn particles; past kOwn * kThreads particles a
// body, in prev_out), and the velocity never leaves them, because the
// collide, grab and velocity update of one substep and the predict of the
// next are one pass.  The state is read from global memory once at the
// frame's start and written once at its end; its [N, 3, B] layout stays,
// block b reading and writing its column with a stride of 3B floats.  A
// level is a thread per slot (slots past kThreads loop), each gathering
// its corners from shared memory by index, projecting its tet with
// nh::solve_tet_delta (nh_math.cuh, the arithmetic of the parent's level
// kernel) and adding the delta at the same indices; one barrier ends the
// level.  The tables (ids, irp, irv, imc: [L, 4C], [L, 9, C], [L, C],
// [L, 4, C]) stay in global memory, shared by all blocks through L2, and
// each thread loads its first slot's tables of the next level before it
// solves the current one, as gs_frame.cu does.  Padded slots (irv == 0, as
// the one-hot tells them apart) are skipped.
//
// Bits: the frame gives the bits of the products and the parent's level
// kernel.  Every operation torch rounds on its own is rounded on its own
// here (__fmul_rn / __fadd_rn keep nvcc from contracting them into an FMA),
// the velocity is a true division by dt, and torch's clamp_ keeps a NaN
// where fminf / fmaxf would drop it.
//
// NaN and inf spread as the products spread them (0 * NaN = 0 * inf =
// NaN), which an index gather and scatter would not:
//   - gather: a coordinate that is not finite anywhere in body b makes
//     every gathered corner of its column NaN, every delta of body b NaN and
//     so, after the level, every coordinate of body b NaN.  Predict tells
//     the block whether the body is finite (__syncthreads_or); a level that
//     finds it is not sets every coordinate NaN, and the rest of the walk
//     would change nothing;
//   - scatter: a delta in column r of a finite body that is not finite makes
//     coordinate r of every other particle NaN (each sums one 0 * delta);
//     its own particle keeps pos + delta where it is the column's only one,
//     and is NaN where there are two or more.  Each thread counts such
//     deltas per coordinate; the level's barrier (__syncthreads_or) tells
//     the block whether there were any, and only then do three more
//     reductions settle which case each column is in.
//
// What bounds it on an H100: latency.  At B = 128 the frame's work is 421
// flops a tet and 13 a particle per substep and body, 1.045 GFLOP, 15.6 us
// at 67 TFLOP/s, and it moves 0.6 MB of tables and 9.5 MB of state, 3.0 us
// at 3.35 TB/s; but a body's frame is L x substeps dependent level rounds
// on one SM, each one tet's chain of two projections plus a barrier, as in
// gs_frame.cu's greedy walk.  The B blocks run side by side, one per SM up
// to 132 bodies.  A first form that passed prev and vel through global
// memory in separate predict and collide passes took 0.196 ms a greedy
// dragon frame at B = 8 and 0.261 at B = 128 (the column's strided
// accesses from every block); this one 0.169 and 0.187, about 1.1 us a
// level (profile_frame.py --parent, NVIDIA H100 80GB HBM3 at 700 W).  The
// global form walks the same levels with its gathers and scatters going to
// L1 and L2 instead of shared memory; its time is in PERF.md.

#include <cuda_runtime.h>
#include <math.h>

#include "nh_math.cuh"

// Scalars of one frame, computed in float32 on the host (gs_frame.cu's).
struct FrameParams {
  float dt;         // substep length
  float gdt;        // gravity * dt
  float k_fric;     // min(1, dt * friction)
  float dev_scale;  // dev_compliance / (dt * dt)
  float vol_scale;  // vol_compliance / (dt * dt)
  float gamma;      // vol_compliance / dev_compliance
  float wmin[3];
  float wmax[3];
};

namespace {

constexpr int kThreads = 256;
constexpr int kOwn = 8;  // particles a thread keeps prev of in registers

// One slot's tables: the state-independent half of a tet's projection.
struct Slot {
  int id[4];     // corner particles
  float ir[9];   // inverse rest pose, row-major
  float irv;     // inverse rest volume (0: a padded slot)
  float w[4];    // corner inverse masses
};

// The level tables of a colouring, C slots a level.
struct Tables {
  const int* ids;    // [L, 4C]: ids[l, c*C + t] corner c of slot t
  const float* irp;  // [L, 9, C]
  const float* irv;  // [L, C]
  const float* imc;  // [L, 4, C]
  int C;

  __device__ __forceinline__ void load(int l, int t, Slot& s) const {
    const size_t k4 = (size_t)l * 4 * C + t;
    const size_t k9 = (size_t)l * 9 * C + t;
    for (int c = 0; c < 4; ++c) s.id[c] = __ldg(ids + k4 + (size_t)c * C);
    for (int k = 0; k < 9; ++k) s.ir[k] = __ldg(irp + k9 + (size_t)k * C);
    s.irv = __ldg(irv + (size_t)l * C + t);
    for (int c = 0; c < 4; ++c) s.w[c] = __ldg(imc + k4 + (size_t)c * C);
  }
};

// A thread's deltas of one level that are not finite, per coordinate: how
// many, and the particle and new value of the last one.
struct Unfinite {
  int n[3];
  int id[3];
  float v[3];
};

// Projects a valid slot's tet: gathers its corners from the planes, adds
// the delta d_dev + d_vol at the same indices (the scatter product's
// pos + delta) and counts the deltas that are not finite.
__device__ __forceinline__ void solve_slot(const Slot& s, float* const P[3],
                                           const FrameParams& F,
                                           Unfinite& u) {
  float p[4][3], d[4][3];
  for (int c = 0; c < 4; ++c)
    for (int r = 0; r < 3; ++r) p[c][r] = P[r][s.id[c]];
  nh::solve_tet_delta(p, s.ir, s.irv, s.w, F.dev_scale, F.vol_scale,
                      F.gamma, d);
  for (int c = 0; c < 4; ++c)
    for (int r = 0; r < 3; ++r) {
      const float v = __fadd_rn(p[c][r], d[c][r]);
      P[r][s.id[c]] = v;
      if (!isfinite(d[c][r])) {
        ++u.n[r];
        u.id[r] = s.id[c];
        u.v[r] = v;
      }
    }
}

// After a level whose deltas were not all finite: coordinate r of every
// particle NaN where column r had any such delta, but for the particle of
// the column's only one, which keeps pos + delta.  Ends with a barrier.
__device__ __forceinline__ void spread_scatter(float* const P[3],
                                               const Unfinite& u, int N) {
  for (int r = 0; r < 3; ++r) {
    const int many = __syncthreads_or(u.n[r] > 1);
    const int threads = __syncthreads_count(u.n[r] > 0);
    if (threads == 0) continue;
    for (int i = threadIdx.x; i < N; i += kThreads) P[r][i] = NAN;
    __syncthreads();
    if (!many && threads == 1 && u.n[r] == 1) P[r][u.id[r]] = u.v[r];
  }
  __syncthreads();
}

// Predicts particle i from position x and velocity v (vel_y += g dt, no
// inverse-mass gate; pos = prev + vel dt): prev into q, the prediction into
// the planes; returns whether the prediction is not finite.
__device__ __forceinline__ int predict(float* const P[3], int i,
                                       const float x[3], float v[3],
                                       float q[3], const FrameParams& F) {
  v[1] = __fadd_rn(v[1], F.gdt);
  int unfinite = 0;
  for (int r = 0; r < 3; ++r) {
    q[r] = x[r];
    const float y = __fadd_rn(x[r], __fmul_rn(v[r], F.dt));
    P[r][i] = y;
    unfinite |= !isfinite(y);
  }
  return unfinite;
}

// Collides particle i (world bounds, then the ground with friction), applies
// the grab and updates the velocity: position into x, velocity into v.
__device__ __forceinline__ void collide(float* const P[3], int i,
                                        const float q[3], int gid,
                                        const float gpos[3],
                                        const FrameParams& F, float x[3],
                                        float v[3]) {
  for (int r = 0; r < 3; ++r) {
    const float y = P[r][i];
    x[r] = isnan(y) ? y : fminf(fmaxf(y, F.wmin[r]), F.wmax[r]);
  }
  if (x[1] < 0.0f) {
    x[1] = 0.0f;
    x[0] = __fadd_rn(x[0], __fmul_rn(__fsub_rn(q[0], x[0]), F.k_fric));
    x[2] = __fadd_rn(x[2], __fmul_rn(__fsub_rn(q[2], x[2]), F.k_fric));
  }
  if (i == gid)
    for (int r = 0; r < 3; ++r) x[r] = gpos[r];
  for (int r = 0; r < 3; ++r) v[r] = __fdiv_rn(__fsub_rn(x[r], q[r]), F.dt);
}

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
dense_frame_kernel(const float* __restrict__ pos_in,   // [N, 3, B]
                   const float* __restrict__ vel_in,   // [N, 3, B]
                   float* __restrict__ pos_out,        // [N, 3, B]
                   float* __restrict__ prev_out,       // [N, 3, B]
                   float* __restrict__ vel_out,        // [N, 3, B]
                   const Tables tab,
                   const int* __restrict__ grab_id,    // [B], -1 inactive
                   const float* __restrict__ grab_pos, // [3, B]
                   int N, int B, int L, int S, FrameParams F,
                   float* planes) {  // [B, 3, N]: the global form's
  extern __shared__ float smem[];
  float* const g = planes + (size_t)blockIdx.x * 3 * N;
  float* const P[3] = {kGlobal ? g : smem,
                       kGlobal ? g + (size_t)N : smem + N,
                       kGlobal ? g + 2 * (size_t)N : smem + 2 * N};
  const int b = blockIdx.x, tid = threadIdx.x, C = tab.C;
  const size_t row = (size_t)3 * B;  // floats from one particle to the next
  const int gid = grab_id[b];
  const float gpos[3] = {grab_pos[b], grab_pos[B + b], grab_pos[2 * B + b]};

  // Each thread owns particles tid, tid + kThreads, ... in every
  // per-particle pass, so prev passes from predict to collide with no
  // barrier: in registers for its first kOwn particles, in prev_out for the
  // rest.  fn(i, q) runs on particle i with its prev q.
  float own_q[kOwn][3];
  const auto for_own = [&](auto&& fn) {
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      const int i = tid + k * kThreads;
      if (i < N) fn(i, own_q[k]);
    }
    for (int i = tid + kOwn * kThreads; i < N; i += kThreads) {
      float q[3];
      for (int r = 0; r < 3; ++r) q[r] = prev_out[i * row + r * B + b];
      fn(i, q);
      for (int r = 0; r < 3; ++r) prev_out[i * row + r * B + b] = q[r];
    }
  };

  // the frame's start: the state read once, the first prediction
  const bool has = tid < C;
  Slot next;  // level 0's tables of slot tid, loaded across the pass
  if (has) tab.load(0, tid, next);
  int unfinite = 0;
  for_own([&](int i, float q[3]) {
    const size_t o = i * row + b;
    const float x[3] = {pos_in[o], pos_in[o + B], pos_in[o + 2 * B]};
    float v[3] = {vel_in[o], vel_in[o + B], vel_in[o + 2 * B]};
    unfinite |= predict(P, i, x, v, q, F);
  });

  for (int s = 0; s < S; ++s) {
    bool finite = !__syncthreads_or(unfinite);  // block-uniform

    // the level walk; each thread prefetches the next level's tables of its
    // first slot (slot tid) before it solves the current level
    for (int l = 0; l < L; ++l) {
      if (!finite) {  // the gather spreads it to the whole body
        for (int i = tid; i < N; i += kThreads)
          P[0][i] = P[1][i] = P[2][i] = NAN;
        break;
      }
      const Slot cur = next;
      if (has && l + 1 < L) tab.load(l + 1, tid, next);
      Unfinite u = {};
      if (has && cur.irv != 0.0f) solve_slot(cur, P, F, u);
      for (int t = tid + kThreads; t < C; t += kThreads) {
        Slot wide;
        tab.load(l, t, wide);
        if (wide.irv != 0.0f) solve_slot(wide, P, F, u);
      }
      if (__syncthreads_or(u.n[0] | u.n[1] | u.n[2])) {
        spread_scatter(P, u, N);
        finite = false;
      }
    }

    // collide, grab and velocity update, then the next substep's
    // prediction or, after the last, the state written once
    const bool last = s + 1 == S;
    if (has && !last) tab.load(0, tid, next);
    unfinite = 0;
    for_own([&](int i, float q[3]) {
      float x[3], v[3];
      collide(P, i, q, gid, gpos, F, x, v);
      if (!last) {
        unfinite |= predict(P, i, x, v, q, F);
        return;
      }
      const size_t o = i * row + b;
      for (int r = 0; r < 3; ++r) {
        pos_out[o + r * B] = x[r];
        prev_out[o + r * B] = q[r];
        vel_out[o + r * B] = v[r];
      }
    });
  }
}

}  // namespace

extern "C" {

int dense_frame_threads() { return kThreads; }

size_t dense_frame_smem_bytes(int n) { return (size_t)3 * n * sizeof(float); }

// Lets the shared form take the shared memory of n particles on the
// current device; returns the CUDA error (0 = set).
int dense_frame_prepare(int n) {
  return (int)cudaFuncSetAttribute(dense_frame_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)dense_frame_smem_bytes(n));
}

// Launches one frame on `stream`: the global form on `planes` ([B, 3, N]
// f32) where it is not null, else the shared form; returns
// cudaGetLastError() (0 = launched).
int dense_frame_launch(const void* pos_in, const void* vel_in, void* pos_out,
                       void* prev_out, void* vel_out, const void* ids,
                       const void* irp, const void* irv, const void* imc,
                       const void* grab_id, const void* grab_pos, int N, int B,
                       int L, int C, int S, FrameParams F, void* planes,
                       void* stream) {
  const Tables tab{(const int*)ids, (const float*)irp, (const float*)irv,
                   (const float*)imc, C};
  if (planes)
    dense_frame_kernel<true><<<B, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)pos_in, (const float*)vel_in, (float*)pos_out,
        (float*)prev_out, (float*)vel_out, tab, (const int*)grab_id,
        (const float*)grab_pos, N, B, L, S, F, (float*)planes);
  else
    dense_frame_kernel<false><<<B, kThreads, dense_frame_smem_bytes(N),
                                (cudaStream_t)stream>>>(
        (const float*)pos_in, (const float*)vel_in, (float*)pos_out,
        (float*)prev_out, (float*)vel_out, tab, (const int*)grab_id,
        (const float*)grab_pos, N, B, L, S, F, nullptr);
  return (int)cudaGetLastError();
}

const char* dense_frame_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
