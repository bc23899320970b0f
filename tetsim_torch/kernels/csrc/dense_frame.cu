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
// Two forms, the host's plan from the body's size (launch_plan in
// dense_frame.py), one template (dense_frame_kernel<kGlobal, kCluster>):
//
// The shared form (<false, false>, up to 19,370 particles a
// body): one thread block per body (grid = B; the blocks never wait on each
// other), the body's positions in three planes of dynamic shared memory
// (12 bytes a particle: 14.8 KB for the dragon).  Each thread owns
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
// The global form (any body; past 19,370 particles the plan's only one):
// a thread-block cluster of cs blocks per body (1, 2, 4, 8 or 16: the
// largest at which the batch's clusters run at once, capped where a
// level's slots already take one pass of a block).  On one block (cs = 1,
// <true, false>) it is the shared form's walk with the positions in three
// planes of a global scratch [B, 3, N] (12 bytes a particle): only block b
// reads and writes its planes, with plain loads and stores (never the
// read-only path: they change during the launch), so the barriers that
// order the shared form's accesses order these too (__syncthreads makes a
// block's global writes visible to the block).  Past one block (<true,
// true>, launched with one cluster dimension) it is the cluster walk, as
// gs_levels.cu walks a body too large for a block: block r of a body's
// cluster owns the particles split(N, cs)[r] in every per-particle pass
// and the slots split(C, cs)[r] of every level (polar_fused.split: ceil(n
// / cs) each, in a row), with the shared form's walk inside: prev in the
// owner's registers up to kOwn * kThreads * cs particles a body, the next
// level's tables of a thread's first slot loaded during the current level.
// The positions live in a float4 scratch [B, N] (16 bytes a particle: one
// load and one store a corner).  A substep is a predict pass, a cluster
// barrier, then each level and a cluster barrier, then the collide pass
// that also predicts the next substep: L + 1 barriers.  The barrier is
// cluster.sync() (barrier.cluster.arrive.release / wait.acquire), and the
// positions are read with __ldcg (L2 only): other SMs of the cluster wrote
// them, and the SMs' L1 caches are not coherent with each other.  One
// block keeps the shared form's walk in an instance of its own: at 128
// bodies of 19,372 particles, whose particle passes are bound by DRAM
// latency, the cluster walk on one block and the one-block walk built into
// the cluster walk's instance (203 registers against 179, and the Mails'
// shared memory) each took 8-11% longer than this instance (PERF.md).
//
// Bits: every form gives the bits of the products (and of the level
// kernel this frame replaced), at every cs (a level's valid slots share no
// particle, so cutting them over blocks changes no sum).  Every operation
// torch rounds on its own is rounded on its own here (__fmul_rn /
// __fadd_rn keep nvcc from contracting them into an FMA), the velocity is
// a true division by dt, and torch's clamp_ keeps a NaN where fminf /
// fmaxf would drop it.
//
// NaN and inf spread as the products spread them (0 * NaN = 0 * inf =
// NaN), which an index gather and scatter would not:
//   - gather: a coordinate that is not finite anywhere in body b makes
//     every gathered corner of its column NaN, every delta of body b NaN and
//     so, after the level, every coordinate of body b NaN.  Predict tells
//     the body whether it is finite; a level that finds it is not sets
//     every coordinate NaN, and the rest of the walk would change nothing;
//   - scatter: a delta in column r of a finite body that is not finite makes
//     coordinate r of every other particle NaN (each sums one 0 * delta);
//     its own particle keeps pos + delta where it is the column's only one,
//     and is NaN where there are two or more.
// The one-block walk takes both decisions with block reductions
// (__syncthreads_or / _count).  The cluster walk takes them across the
// cluster through a Mail in every block's shared memory, one per barrier
// in a ring of three: a thread whose prediction or deltas are not finite
// writes the flag, or adds its per-coordinate counts and names its
// particle, in every block's copy (distributed shared memory) before the
// barrier; after it each block reads its own copy, and thread 0 zeroes a
// written copy one barrier after it was read, when no block reads or
// writes it again before the ring comes round.  Only a non-finite body
// writes a Mail; a clean barrier reads one word of shared memory.
//
// What bounds it on an H100: latency.  At B = 128 the dragon's frame is
// 421 flops a tet and 13 a particle per substep and body, 1.045 GFLOP,
// 15.6 us at 67 TFLOP/s, and it moves 0.6 MB of tables and 9.5 MB of
// state, 3.0 us at 3.35 TB/s; but a body's frame is L x substeps
// dependent level rounds, each one tet's chain of two projections plus a
// barrier, as in gs_frame.cu's greedy walk.  The shared form's B blocks run
// side by side, one per SM up to 132 bodies: 0.169 / 0.187 ms a greedy
// dragon frame at B = 8 / 128, about 1.1 us a level (profile_frame.py
// --parent, NVIDIA H100 80GB HBM3 at 700 W).  A body past 19,370
// particles has levels of thousands of slots: on one block a level is 19
// serial slots a thread and a pass 76 particles a thread, 8 SMs busy at B
// = 8 (0.89 ms a frame of 19,372 particles, the particle passes 77% of
// it); the cluster cuts both by cs and spreads the batch over cs times the
// SMs, at the cost of a cluster barrier (about 1,000-2,000 SM cycles) a
// level: 0.10 ms.  Its times are in PERF.md.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "nh_math.cuh"

namespace cg = cooperative_groups;

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

#ifdef DENSE_FRAME_PHASES
// A build for profile_frame.py --phases only: block 0 of the launch (rank
// 0 of body 0's cluster) sums the SM cycles of the cluster walk's particle
// passes, of its level walks and of its barriers, each phase ended by a
// __syncthreads() that the shipped build does not have, and counts the
// substeps and levels.
__device__ unsigned long long phase_cycles[5];
// and every block of the cluster walk records when it starts and ends
// (%globaltimer, ns), up to kMarked blocks.
constexpr int kMarked = 4096;
__device__ unsigned long long block_ns[2][kMarked];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

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

// A body's positions as a walk reads and writes them, the template
// parameter of the helpers below.  kPacked says whether a particle's three
// coordinates are loaded and stored together (one float4) or one by one,
// each stored as soon as it is computed: the one-block walk's order, whose
// SASS changes when its helpers are written the other way (PERF.md).
//
// Planes: three f32 planes [3, N], in shared memory or, on one block, in
// the global scratch (only block b touches them, and its barriers order
// its accesses).
struct Planes {
  static constexpr bool kPacked = false;
  float* p[3];
  __device__ __forceinline__ float get(int i, int r) const { return p[r][i]; }
  __device__ __forceinline__ void get(int i, float x[3]) const {
    for (int r = 0; r < 3; ++r) x[r] = p[r][i];
  }
  __device__ __forceinline__ void set(int i, int r, float x) const {
    p[r][i] = x;
  }
};

// Quads: the cluster walk's scratch, a float4 a particle (one 16-byte load
// or store a corner), read with __ldcg (L2 only): other SMs of the cluster
// write them, and the SMs' L1 caches are not coherent with each other.
struct Quads {
  static constexpr bool kPacked = true;
  float4* p;
  __device__ __forceinline__ void get(int i, float x[3]) const {
    const float4 v = __ldcg(p + i);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
  }
  __device__ __forceinline__ void set(int i, const float x[3]) const {
    p[i] = make_float4(x[0], x[1], x[2], 0.0f);
  }
  __device__ __forceinline__ void set(int i, int r, float x) const {
    reinterpret_cast<float*>(p + i)[r] = x;
  }
};

// Projects a valid slot's tet: gathers its corners, adds the delta d_dev +
// d_vol at the same indices (the scatter product's pos + delta) and counts
// the deltas that are not finite.
template <class Pos>
__device__ __forceinline__ void solve_slot(const Slot& s, const Pos& P,
                                           const FrameParams& F,
                                           Unfinite& u) {
  float p[4][3], d[4][3];
  for (int c = 0; c < 4; ++c) P.get(s.id[c], p[c]);
  nh::solve_tet_delta(p, s.ir, s.irv, s.w, F.dev_scale, F.vol_scale,
                      F.gamma, d);
  for (int c = 0; c < 4; ++c) {
    for (int r = 0; r < 3; ++r) {
      const float v = __fadd_rn(p[c][r], d[c][r]);
      if constexpr (Pos::kPacked)
        p[c][r] = v;
      else
        P.set(s.id[c], r, v);
      if (!isfinite(d[c][r])) {
        ++u.n[r];
        u.id[r] = s.id[c];
        u.v[r] = v;
      }
    }
    if constexpr (Pos::kPacked) P.set(s.id[c], p[c]);
  }
}

// After a level whose deltas were not all finite, on one block: coordinate
// r of every particle NaN where column r had any such delta, but for the
// particle of the column's only one, which keeps pos + delta.  Ends with a
// barrier.
__device__ __forceinline__ void spread_scatter(const Planes& P,
                                               const Unfinite& u, int N) {
  for (int r = 0; r < 3; ++r) {
    const int many = __syncthreads_or(u.n[r] > 1);
    const int threads = __syncthreads_count(u.n[r] > 0);
    if (threads == 0) continue;
    for (int i = threadIdx.x; i < N; i += kThreads) P.p[r][i] = NAN;
    __syncthreads();
    if (!many && threads == 1 && u.n[r] == 1) P.p[r][u.id[r]] = u.v[r];
  }
  __syncthreads();
}

// Predicts particle i from position x and velocity v (vel_y += g dt, no
// inverse-mass gate; pos = prev + vel dt): prev into q, the prediction into
// P; returns whether the prediction is not finite.
template <class Pos>
__device__ __forceinline__ int predict(const Pos& P, int i, const float x[3],
                                       float v[3], float q[3],
                                       const FrameParams& F) {
  v[1] = __fadd_rn(v[1], F.gdt);
  float y[3];
  int unfinite = 0;
  for (int r = 0; r < 3; ++r) {
    q[r] = x[r];
    const float yr = __fadd_rn(x[r], __fmul_rn(v[r], F.dt));
    if constexpr (Pos::kPacked)
      y[r] = yr;
    else
      P.set(i, r, yr);
    unfinite |= !isfinite(yr);
  }
  if constexpr (Pos::kPacked) P.set(i, y);
  return unfinite;
}

// Collides particle i (world bounds, then the ground with friction), applies
// the grab and updates the velocity: position into x, velocity into v.
template <class Pos>
__device__ __forceinline__ void collide(const Pos& P, int i, const float q[3],
                                        int gid, const float gpos[3],
                                        const FrameParams& F, float x[3],
                                        float v[3]) {
  float y[3];
  if constexpr (Pos::kPacked) P.get(i, y);
  for (int r = 0; r < 3; ++r) {
    if constexpr (!Pos::kPacked) y[r] = P.get(i, r);
    x[r] = isnan(y[r]) ? y[r] : fminf(fmaxf(y[r], F.wmin[r]), F.wmax[r]);
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


// -- the global form past one block ------------------------------------------

// One barrier's decisions for the whole cluster, a copy in every block.
struct Mail {
  int any;    // a prediction, or a level's delta, that is not finite
  int n[3];   // the level's deltas that are not finite, per coordinate
  int id[3];  // the particle of one of them, per coordinate
};

// The scatter's spread after a level whose deltas were not all finite
// (spread_scatter's rule, the counts summed over the cluster): this
// thread's particles of [lo, hi) NaN in every coordinate that had any
// such delta, but for the particle of the coordinate's only one, which
// keeps the pos + delta its slot stored.
__device__ __forceinline__ void spread(const Quads& P, const Mail& m,
                                       int lo, int hi) {
  for (int r = 0; r < 3; ++r) {
    if (m.n[r] == 0) continue;
    const int keep = m.n[r] == 1 ? m.id[r] : -1;
    for (int i = lo + (int)threadIdx.x; i < hi; i += kThreads)
      if (i != keep) P.set(i, r, NAN);
  }
}

// The global form's frame of body blockIdx.x / cs on its cluster; scratch
// the bodies' positions (Quads), mail the block's ring of three
// Mails.
__device__ __forceinline__ void cluster_walk(
    const float* __restrict__ pos_in, const float* __restrict__ vel_in,
    float* __restrict__ pos_out, float* __restrict__ prev_out,
    float* __restrict__ vel_out, const Tables& tab,
    const int* __restrict__ grab_id, const float* __restrict__ grab_pos,
    int N, int B, int L, int S, const FrameParams& F, float* scratch,
    Mail* mail) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs, tid = threadIdx.x, C = tab.C;
  const int nt = (N + cs - 1) / cs, span = (C + cs - 1) / cs;
  const int i_lo = min(N, rank * nt), i_hi = min(N, i_lo + nt);
  const int s_lo = min(C, rank * span), s_hi = min(C, s_lo + span);
  const Quads P{reinterpret_cast<float4*>(scratch) + (size_t)b * N};
  const size_t row = (size_t)3 * B;  // floats from one particle to the next
  const int gid = grab_id[b];
  const float gpos[3] = {grab_pos[b], grab_pos[B + b], grab_pos[2 * B + b]};
#ifdef DENSE_FRAME_PHASES
  const bool mark = blockIdx.x == 0 && tid == 0;
  unsigned long long acc[3] = {0, 0, 0};
  long long t_mark = clock64();
  if (tid == 0 && blockIdx.x < kMarked) block_ns[0][blockIdx.x] = global_ns();
#define PHASE_END(k)                 \
  __syncthreads();                   \
  if (mark) {                        \
    const long long now = clock64(); \
    acc[k] += now - t_mark;          \
    t_mark = now;                    \
  }
#else
#define PHASE_END(k)
#endif

  // The cluster barrier; then this block's copy of its Mail where a block
  // had news (unchanged until the next barrier), else null.  Every block
  // reads its copy's flag after each barrier, so the ring moves on at
  // each; thread 0 zeroes a written copy after the barrier that follows
  // the one it was read at.
  int slot = 0;    // the Mail of the next barrier
  int dirty = -1;  // a Mail written for the last barrier, or -1
  const auto sync = [&]() -> const Mail* {
    cluster.sync();
    const Mail* const m = mail[slot].any ? mail + slot : nullptr;
    if (dirty >= 0 && tid == 0) mail[dirty] = Mail{};
    dirty = m ? slot : -1;
    slot = slot == 2 ? 0 : slot + 1;
    return m;
  };
  // fn on every block's copy of the next barrier's Mail.
  const auto tell = [&](auto&& fn) {
    for (int j = 0; j < cs; ++j) fn(cluster.map_shared_rank(mail + slot, j));
  };

  // every copy zeroed, and every block of the cluster running, before any
  // block writes to another's shared memory
  if (tid == 0)
    for (int j = 0; j < 3; ++j) mail[j] = Mail{};
  cluster.sync();

  // Each thread owns particles i_lo + tid, i_lo + tid + kThreads, ... of
  // its block's range in every per-particle pass, as in the shared form.
  float own_q[kOwn][3];
  const auto for_own = [&](auto&& fn) {
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int i = i_lo + tid + j * kThreads;
      if (i < i_hi) fn(i, own_q[j]);
    }
    for (int i = i_lo + tid + kOwn * kThreads; i < i_hi; i += kThreads) {
      float q[3];
      float* const o = prev_out + i * row + b;
      for (int r = 0; r < 3; ++r) q[r] = o[r * B];
      fn(i, q);
      for (int r = 0; r < 3; ++r) o[r * B] = q[r];
    }
  };
  const auto tell_unfinite = [&](int unfinite) {
    if (unfinite) tell([](Mail* m) { m->any = 1; });
  };

  // the frame's start: the state read once, the first prediction
  const int first = s_lo + tid;  // this thread's first slot of every level
  const bool has = first < s_hi;
  Slot next;  // level 0's tables of slot first, loaded across the pass
  if (has) tab.load(0, first, next);
  int unfinite = 0;
  for_own([&](int i, float q[3]) {
    const size_t o = i * row + b;
    const float x[3] = {pos_in[o], pos_in[o + B], pos_in[o + 2 * B]};
    float v[3] = {vel_in[o], vel_in[o + B], vel_in[o + 2 * B]};
    unfinite |= predict(P, i, x, v, q, F);
  });
  tell_unfinite(unfinite);
  PHASE_END(0);

  for (int s = 0; s < S; ++s) {
    bool finite = !sync();  // cluster-uniform
    PHASE_END(2);

    for (int l = 0; l < L; ++l) {
      if (!finite) {  // the gather spreads it to the whole body
        const float nan[3] = {NAN, NAN, NAN};
        for (int i = i_lo + tid; i < i_hi; i += kThreads) P.set(i, nan);
        break;
      }
      const Slot cur = next;
      if (has && l + 1 < L) tab.load(l + 1, first, next);
      Unfinite u = {};
      if (has && cur.irv != 0.0f) solve_slot(cur, P, F, u);
      for (int t = first + kThreads; t < s_hi; t += kThreads) {
        Slot wide;
        tab.load(l, t, wide);
        if (wide.irv != 0.0f) solve_slot(wide, P, F, u);
      }
      const int bad = u.n[0] | u.n[1] | u.n[2];
      if (bad)
        tell([&](Mail* m) {
          m->any = 1;
          for (int r = 0; r < 3; ++r)
            if (u.n[r]) {
              atomicAdd(&m->n[r], u.n[r]);
              m->id[r] = u.id[r];
            }
        });
      PHASE_END(1);
      const Mail* m = sync();
      PHASE_END(2);
      if (m) {
        spread(P, *m, i_lo, i_hi);
        finite = false;
      }
    }

    // collide, grab and velocity update, then the next substep's
    // prediction or, after the last, the state written once
    const bool last = s + 1 == S;
    if (has && !last) tab.load(0, first, next);
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
    tell_unfinite(unfinite);
    PHASE_END(0);
  }
#ifdef DENSE_FRAME_PHASES
  __syncthreads();
  if (tid == 0 && blockIdx.x < kMarked) block_ns[1][blockIdx.x] = global_ns();
  if (mark) {
    for (int j = 0; j < 3; ++j) phase_cycles[j] += acc[j];
    phase_cycles[3] += S;
    phase_cycles[4] += (unsigned long long)S * L;
  }
#endif
#undef PHASE_END
}

template <bool kGlobal, bool kCluster = false>
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
                   float* planes) {  // the global form's scratch
  if constexpr (kCluster) {  // the global form past one block
    __shared__ Mail mail[3];
    cluster_walk(pos_in, vel_in, pos_out, prev_out, vel_out, tab, grab_id,
                 grab_pos, N, B, L, S, F, planes, mail);
    return;
  }
  extern __shared__ float smem[];
  float* const g = planes + (size_t)blockIdx.x * 3 * N;
  const Planes P{{kGlobal ? g : smem, kGlobal ? g + (size_t)N : smem + N,
                  kGlobal ? g + 2 * (size_t)N : smem + 2 * N}};
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
          P.p[0][i] = P.p[1][i] = P.p[2][i] = NAN;
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

// The global form's launch shape: B clusters of cs blocks.
cudaLaunchConfig_t global_config(int B, int cs, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
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

// Lets the global form take clusters of up to 16 blocks on the current
// device; returns the CUDA error (0 = set).
int dense_frame_prepare_global() {
  return (int)cudaFuncSetAttribute(
      dense_frame_kernel<true, true>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// How many clusters of cs blocks of the global form the current device runs
// at once (cudaOccupancyMaxActiveClusters) into *count; returns the CUDA
// error (0 = answered).  Needs dense_frame_prepare_global() first.
int dense_frame_active_clusters(int cs, int* count) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = global_config(1, cs, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      count, dense_frame_kernel<true, true>, &cfg);
}

// Launches one frame on `stream`: the global form where `planes`, its
// scratch, is not null: past one block (cs > 1) the cluster walk, B
// clusters of cs blocks on a [B, N] float4 scratch, else a block a body on
// [B, 3, N] f32 planes; where it is null, the shared form.  Returns the
// launch's error, then cudaGetLastError() (0 = launched).
int dense_frame_launch(const void* pos_in, const void* vel_in, void* pos_out,
                       void* prev_out, void* vel_out, const void* ids,
                       const void* irp, const void* irv, const void* imc,
                       const void* grab_id, const void* grab_pos, int N, int B,
                       int L, int C, int S, FrameParams F, void* planes,
                       int cs, void* stream) {
  const Tables tab{(const int*)ids, (const float*)irp, (const float*)irv,
                   (const float*)imc, C};
  cudaError_t err = cudaSuccess;
  if (planes && cs > 1) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        global_config(B, cs, (cudaStream_t)stream, &attr);
    err = cudaLaunchKernelEx(
        &cfg, dense_frame_kernel<true, true>, (const float*)pos_in,
        (const float*)vel_in, (float*)pos_out, (float*)prev_out,
        (float*)vel_out, tab, (const int*)grab_id, (const float*)grab_pos, N,
        B, L, S, F, (float*)planes);
  } else if (planes) {
    dense_frame_kernel<true><<<B, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)pos_in, (const float*)vel_in, (float*)pos_out,
        (float*)prev_out, (float*)vel_out, tab, (const int*)grab_id,
        (const float*)grab_pos, N, B, L, S, F, (float*)planes);
  } else {
    dense_frame_kernel<false><<<B, kThreads, dense_frame_smem_bytes(N),
                                (cudaStream_t)stream>>>(
        (const float*)pos_in, (const float*)vel_in, (float*)pos_out,
        (float*)prev_out, (float*)vel_out, tab, (const int*)grab_id,
        (const float*)grab_pos, N, B, L, S, F, nullptr);
  }
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

#ifdef DENSE_FRAME_PHASES
// Copies phase_cycles to out[5] (particle passes, level walks, barriers,
// substeps, levels walked) and zeroes it; returns the CUDA error.
int dense_frame_phase_cycles(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
  return (int)err;
}

// Copies block_ns to out[2 * kMarked] (the last launch's start, then end,
// of each block); returns the CUDA error.
int dense_frame_block_ns(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, block_ns, sizeof(block_ns));
}
#endif

const char* dense_frame_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
