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
// K3, the design: the whole frame is one cooperative launch
// (nh_grid_frame_kernel), as the TPU kernel runs a substep inside one
// pallas_call.  Its grid is co-resident (the wrapper sizes it from the
// occupancy query, 1 block of 256 threads per SM) and walks the frame's
// phases: predict, then per substep the 48 colours and a phase that
// collides the substep and predicts the next.  Each phase walks its items
// grid-stride: a particle phase the (body, vertex) pairs, so a particle's
// collide and its next predict fall to the same thread and need no barrier
// between them; a colour phase the (body, virtual block of `lanes` tet
// lanes) pairs, thread j of the block solving lane vb * lanes + j.  A
// colour's tets share no vertex, so the order in which the blocks take
// them changes no bit.  Where the caller asks for the volume error, the
// virtual blocks are 256 lanes (nblk a colour), each (body, colour,
// virtual block) writes the sum of its lanes' det F - 1 (a tree in shared
// memory, in a fixed order) to a scratch row, and the collide phase adds a
// body's row in a fixed strided order into vol_err[b, s] / num_tets.
// Without it they are the largest colour's lanes spread over the grid
// (nh_stencil.item_lanes: 167 for the 56^3 box on 132 SMs, whose 86
// blocks of 256 left 46 SMs idle in every colour).  Deterministic, no
// atomics in the arithmetic: the first design's bits.
//
// Between phases.  A particle phase walks the particles grid-stride, so a
// grid barrier (cooperative_groups this_grid().sync()) stands before and
// after it: after the first predict, after colour 47 and after each
// collide.  Between two colours of a substep there is none.  Every colour
// maps lane (ax * cwy + ay) * cwz + az to its cube lattice, so a virtual
// block covers about the same slab of the box in every colour, and a tet
// reads and writes only the corners of its cube.  A tet of a later colour
// therefore depends only on tets whose cubes share a vertex with its own,
// and those lie within `reach` virtual blocks of it in every colour
// (nh_stencil.reach on the host: 4 for the 56^3 box at 256 lanes, 5 at
// 167; a box of few blocks waits for all of them).  Each item (b, vb) owns
// an int flag, alone in its 32-byte sector (kFlagInts), zeroed in the
// first predict.  After its colour phase u and the block's
// __syncthreads(), lane 0 of the last warp publishes u with
// st.release.gpu; before colour phase u + 1, warp 0 polls the flags of
// items (b, vb - reach .. vb + reach), clipped to the body, with
// ld.acquire.gpu until each reads at least u, and a __syncthreads() hands
// the acquire to the block.  The acquire is what makes the other SMs'
// position stores visible to the plain loads that follow.  Warp 0 starts
// polling while the last warp waits out its release, and no two items'
// flags share a sector, so a release does not queue behind the other
// items' polls: with one flag a word and thread 0 publishing, the walk
// took as long as with the grid barriers.  A block takes its items of
// phase u only after all its items of phase u - 1, and every block is
// resident, so the blocks at the lowest phase can always go on: no
// deadlock.  2 grid barriers and 47 neighbour waits a substep, where a
// barrier after every phase made 49; the order of the writes to each
// vertex is unchanged, and so are the bits.
//
// Numerics: predict, collide and velocity round every operation as the
// plain path does; the tet projection is contracted by nvcc into FMAs
// where it can.
//
// What bounds it.  The work is 421 flops per tet and 13 per particle per
// substep (kernels/nh_stencil.py frame_flops): 0.45 GFLOP, about 7 us at
// the card's FP32 peak for the 56^3 box.  The first design launched 50
// kernels per substep from a C loop; a colour of 21,952 tets fills 86
// blocks for about 3 us, and the host enqueued 250 launches per frame in
// about 1.09 ms against 0.77 ms of device time, so the host paced the frame
// (busy 71%).  Here the host enqueues one launch per frame, and a colour
// phase costs one L2 gather of its corners, one tet's dependent chain per
// thread, its scattered stores and the hand-over to the next colour; the
// 48 colours stay sequential.  Measured on an H100 (profile_frame.py
// --phases and a probe build, PERF.md): one grid barrier alone takes
// about 1.0 us at 132 blocks (1.3 at 264, which is why the grid is one
// block per SM).  In blocks of 256 lanes a colour phase on block 0 spent
// about 800 SM cycles in the gather, 2,700 in the solve and the stores (8
// warps on each of 86 SMs) and 840 in the release before its flag; the
// grid barrier after every phase cost 3,100-3,250, mostly that release
// and round trips through L2, not the wait for the slowest block, so the
// neighbour waits alone gained 2-3%.  Spread over all 132 SMs the colour
// phase takes about 4,900 cycles with its wait, against 6,600 with the
// barrier: 126 against 152 us a substep of the 56^3 box (140 with the
// spread items and a barrier after every phase).

// K3s, the slab form: replaces the TPU kernel
// tetsim_tpu/kernels/nh_stencil.py:_build_seg_call, one colour group (the 4
// colours of one (type, px) pair) of K3's sweep on one x-slab, which
// make_nh_sharded_stepper runs 12 times per substep with a one-plane
// ppermute between groups.  Here the slabs of one device run together in
// one cooperative launch per frame (nh_slab_frame_kernel): K3's walk on
// K3's grid, the slabs in the place of K3's bodies, each (slab, virtual
// block) an item of a colour phase, each slab with its local dims, its own
// inv_mass row [k, n] and the grabs decoded by global particle id
// (x_offset0 + b * x_stride + v).  No copy phase, and a grid barrier
// between every two phases, 49 per substep: K3's neighbour waits do not
// apply, since the write-through below is a dependency across slabs that
// the lane window does not describe.
//
// The boundary planes, by write-through.  A slab stores the vertex plane
// it shares with each neighbour (its planes 0 and lx), so the plane has two
// replicas.  With cuts at even cube columns, a px = 0 colour's cubes are
// x = 0, 2, ..., lx - 2: it writes a slab's plane 0 and never its plane
// lx; a px = 1 colour's cubes are x = 1, 3, ..., lx - 1: it writes plane
// lx and never plane 0.  So during a colour group (one type, one px) each
// shared plane is read and written on one side of its boundary only, and
// the replica on the other side is neither read nor written.  The first
// design refreshed that replica with a SlabMesh copy after each group;
// here the thread that writes a shared-plane vertex writes the same value
// into the neighbour slab's replica at once (the neighbour is the next or
// previous [3, n] slice of the device's buffer, and never past its ends).
// The last write in a group is the group's final value, and the next
// group, which reads the replica, runs after a grid barrier: it reads what
// the copy would have given, so K3s keeps K3's trajectory bit for bit
// (tests/test_torch_launch_layouts.py runs this order in plain torch
// against the sharded twin).  The replicas also agree at frame ends:
// predict and collide compute both on the same bits with the same global
// ids.  Where a mesh spans several devices, each device runs the same
// kernel over a range of the frame's phases, one colour group per call,
// and SlabMesh copies move the planes between the devices' end slabs
// only (nh_stencil.slab_calls); that pattern is compiled and planned on
// the CPU but has not run on a card.  Measured on an H100 (PERF.md): the
// 56^3 box in 4 slabs on one card takes 0.163-0.175 ms per substep, about
// 3.4 us per phase, against K3's 0.151 unsharded with the same barriers
// and blocks of 256 lanes (0.126 with its spread items and neighbour
// waits); the first design's 50 launches and 36 copies per substep took
// 0.44-0.66 ms, paced by the host.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nh_math.cuh"

namespace cg = cooperative_groups;

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
constexpr int kFlagInts = 8;  // an item's flag and its 32-byte sector

#ifdef NH_STENCIL_PHASES
// A build for profile_frame.py --phases only: block 0 of K3 sums the SM
// cycles of its particle phases (the first predict, then collide with the
// next predict and the volume error), of its 48 colour phases (their
// neighbour waits included) and of its grid barriers, each phase ended by a
// __syncthreads() that the shipped build does not have, and counts the
// substeps; then its neighbour waits, those whose first poll found a flag
// not yet ready, and the SM cycles from a wait's start to the block going
// on.
__device__ unsigned long long phase_cycles[7];
#endif

// Virtual blocks of `lanes` tet lanes that cover the largest colour: a
// colour phase's items per body (nh_stencil.partial_blocks on the host; of
// 256 lanes, the volume error's scratch holds one sum per body, colour and
// such block).
__host__ __device__ __forceinline__ int partial_blocks(int nx, int ny, int nz,
                                                       int lanes) {
  const int most = ((nx + 1) / 2) * ((ny + 1) / 2) * ((nz + 1) / 2);
  return (most + lanes - 1) / lanes;
}

// Predict of vertex v of the body whose planes start at `base`: velocity
// plus gravity, zeroed where inv_mass is not > 0; the start is saved as
// prev.
__device__ __forceinline__ void predict_one(float x, float y, float z,
                                            float vx, float vy, float vz,
                                            float im, float* pos, float* prev,
                                            size_t base, int N, int v,
                                            const GridNHParams& P) {
  vy = __fadd_rn(vy, P.gdt);
  if (!(im > 0.0f)) vx = vy = vz = 0.0f;
  prev[base + v] = x;
  prev[base + N + v] = y;
  prev[base + 2 * N + v] = z;
  pos[base + v] = __fadd_rn(x, __fmul_rn(vx, P.dt));
  pos[base + N + v] = __fadd_rn(y, __fmul_rn(vy, P.dt));
  pos[base + 2 * N + v] = __fadd_rn(z, __fmul_rn(vz, P.dt));
}

// Collide of one particle at (x, y, z) that started the substep at (px,
// py, pz): world bounds, the ground with friction, then the grab override
// (grab rows gid / gpos, matched against the particle id `id`; the last
// grab on it wins).
__device__ __forceinline__ void collide_one(float& x, float& y, float& z,
                                            float px, float pz,
                                            const int* gid, const float* gpos,
                                            int G, int id,
                                            const GridNHParams& P) {
  x = fminf(fmaxf(x, P.wmin[0]), P.wmax[0]);
  y = fminf(fmaxf(y, P.wmin[1]), P.wmax[1]);
  z = fminf(fmaxf(z, P.wmin[2]), P.wmax[2]);
  if (y < 0.0f) {
    y = 0.0f;
    x = __fadd_rn(x, __fmul_rn(px - x, P.k_fric));
    z = __fadd_rn(z, __fmul_rn(pz - z, P.k_fric));
  }
  for (int g = 0; g < G; ++g) {
    if (gid[g] == id) {
      x = gpos[3 * g];
      y = gpos[3 * g + 1];
      z = gpos[3 * g + 2];
    }
  }
}

// Tet lane `lane` of colour `color` on one body's planes bpos [3, N] with
// its inverse masses bim [N]: the colour's cubes are (px + 2 ax, py + 2 ay,
// pz + 2 az), lanes in C order over (ax, ay, az).  Projects the tet in
// place; returns its det F - 1, or 0 for a lane past the colour.  With
// kSlabs, bpos is slab b of the k slabs [k, 3, N] of one device buffer,
// and a corner on the slab's plane 0 or plane nx that has a neighbour slab
// there is also written into the neighbour's replica (the design note).
template <bool kSlabs>
__device__ __forceinline__ float solve_lane(float* bpos, const float* bim,
                                            int N, int color, int lane,
                                            int b, int k,
                                            const GridNHParams& P) {
  const int t = color >> 3;
  const int px = (color >> 2) & 1, py = (color >> 1) & 1, pz = color & 1;
  const int cwx = (P.nx - px + 1) / 2, cwy = (P.ny - py + 1) / 2,
            cwz = (P.nz - pz + 1) / 2;
  if (lane >= cwx * cwy * cwz) return 0.0f;
  const int ci = px + 2 * (lane / (cwy * cwz));
  const int cj = py + 2 * ((lane / cwz) % cwy);
  const int ck = pz + 2 * (lane % cwz);
  const int gy = P.ny + 1, gz = P.nz + 1;
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
  const float verr =
      nh::solve_tet<true>(p, ir, P.irv, w, P.dev_scale, P.vol_scale, P.gamma);
  for (int c = 0; c < 4; ++c)
    for (int r = 0; r < 3; ++r) bpos[(size_t)r * N + ids[c]] = p[c][r];
  if (kSlabs) {
    const int shift = P.nx * gy * gz;  // plane nx of slab b - 1 is plane 0
    for (int c = 0; c < 4; ++c) {
      const int x = ci + ((P.corner_slab[t][c] >> 2) & 1);
      float* peer = nullptr;
      if (x == 0 && b > 0) peer = bpos - (size_t)3 * N + ids[c] + shift;
      if (x == P.nx && b + 1 < k) peer = bpos + (size_t)3 * N + ids[c] - shift;
      if (peer != nullptr)
        for (int r = 0; r < 3; ++r) peer[(size_t)r * N] = p[c][r];
    }
  }
  return verr;
}

// Item flags (the K3 design note): a release store of the colour phase an
// item finished, and the acquire load that polls it.
__device__ __forceinline__ void publish(int* flag, int u) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(flag), "r"(u)
               : "memory");
}

__device__ __forceinline__ int acquire(const int* flag) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(flag)
               : "memory");
  return v;
}

// Warp 0 polls flags [lo, hi) until each reads at least u, then the block
// goes on; every thread of the block must call it.  Returns, to warp 0,
// whether they all did at the first poll.
__device__ __forceinline__ bool wait_flags(const int* flags, int lo, int hi,
                                           int u) {
  bool first = true;
  if (threadIdx.x < 32) {
    for (;;) {
      bool ready = true;
      for (int f = lo + (int)threadIdx.x; f < hi; f += 32)
        if (acquire(flags + f * kFlagInts) < u) ready = false;
      if (__all_sync(0xffffffffu, ready)) break;
      first = false;
    }
  }
  __syncthreads();
  return first;
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

// Phases of a frame of S substeps: the first predict (0), then per substep
// s the 48 colours (1 + 49 s + colour) and collide with the next predict
// (49 (s + 1)).
__host__ __device__ __forceinline__ int frame_phases(int S) {
  return 1 + S * (kColors + 1);
}

// Phases [begin, end) of a frame of B items (K3's boxes or, with kSlabs,
// K3s's slabs of one device), a colour phase in items of `lanes` tet
// lanes (256 for K3s and wherever vol_err is asked for): K3 with a grid
// barrier on either side of a particle phase and, between colours, each
// item waiting on the flags [B, items, kFlagInts] of the items within
// `reach` of it; K3s with a grid barrier between every two phases (the
// design notes at the top).  Positions, prev and velocities are read and
// written by other blocks between barriers, so they are plain pointers
// (no read-only cache); the partial sums too.  inv_mass is [N] (K3) or
// [B, N] (K3s); the grabs are [B, G] and match particle ids v (K3), or [G]
// shared by the slabs and matching global ids x_offset0 + b * x_stride + v
// (K3s).
template <bool kSlabs>
__device__ __forceinline__ void walk_frame(
    const float* __restrict__ pos_in, const float* __restrict__ vel_in,
    float* pos, float* prev, float* vel, float* vol_err, float* partial,
    int* flags, const float* __restrict__ inv_mass,
    const int* __restrict__ grab_id, const float* __restrict__ grab_pos,
    int B, int G, int S, int lanes, int reach, int x_offset0, int x_stride,
    int begin, int end, const GridNHParams& P) {
  __shared__ float red[kThreads];
  cg::grid_group grid = cg::this_grid();
  const int N = (P.nx + 1) * (P.ny + 1) * (P.nz + 1);
  const int nblk = partial_blocks(P.nx, P.ny, P.nz, kThreads);
  const int items = partial_blocks(P.nx, P.ny, P.nz, lanes);
  const int total = B * N;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
#ifdef NH_STENCIL_PHASES
  const bool mark = blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long acc[6] = {0, 0, 0, 0, 0, 0};
  long long t_mark = clock64();
#define PHASE_END(k)                     \
  __syncthreads();                       \
  if (mark) {                            \
    const long long now = clock64();     \
    acc[k] += now - t_mark;              \
    t_mark = now;                        \
  }
#else
#define PHASE_END(k)
#endif

  for (int u = begin; u < end; ++u) {
    // colour (0-47) or particle phase (48) of the substep; -1: first predict
    const int color = u == 0 ? -1 : (u - 1) % (kColors + 1);
    bool barrier = u > begin;
    if constexpr (!kSlabs)  // none between two colours
      barrier = barrier && (color <= 0 || color == kColors);
    if (barrier) {
      grid.sync();
      PHASE_END(2);
    }
    if (u == 0) {
      if constexpr (!kSlabs)
        for (int i = first; i < B * items * kFlagInts; i += stride)
          flags[i] = 0;
      for (int i = first; i < total; i += stride) {
        const int v = i % N;
        const size_t base = (size_t)(i / N) * 3 * N;
        predict_one(pos_in[base + v], pos_in[base + N + v],
                    pos_in[base + 2 * N + v], vel_in[base + v],
                    vel_in[base + N + v], vel_in[base + 2 * N + v],
                    inv_mass[kSlabs ? i : v], pos, prev, base, N, v, P);
      }
      PHASE_END(0);
      continue;
    }
    const int s = (u - 1) / (kColors + 1);
    if (color < kColors) {
      for (int item = blockIdx.x; item < B * items; item += gridDim.x) {
        const int b = item / items, vb = item % items;
        if constexpr (!kSlabs) {
          if (color > 0) {  // the previous colour's items within reach
            const int* row = flags + (size_t)b * items * kFlagInts;
            const int lo = max(vb - reach, 0);
            const int hi = min(vb + reach + 1, items);
#ifdef NH_STENCIL_PHASES
            const long long t_wait = clock64();
            const bool at_once = wait_flags(row, lo, hi, u - 1);
            if (mark) {
              acc[3] += 1;
              acc[4] += !at_once;
              acc[5] += clock64() - t_wait;
            }
#else
            wait_flags(row, lo, hi, u - 1);
#endif
          }
        }
        const float verr =
            (int)threadIdx.x < lanes
                ? solve_lane<kSlabs>(pos + (size_t)b * 3 * N,
                                     inv_mass + (kSlabs ? (size_t)b * N : 0),
                                     N, color, vb * lanes + threadIdx.x, b, B,
                                     P)
                : 0.0f;
        if (vol_err != nullptr) {
          const float sum = block_sum(verr, red);
          if (threadIdx.x == 0)
            partial[((size_t)b * kColors + color) * nblk + vb] = sum;
          __syncthreads();  // red serves the block's next item
        }
        if constexpr (!kSlabs) {
          if (vol_err == nullptr) __syncthreads();  // the item's stores
          if (threadIdx.x == kThreads - 32)  // warp 0 polls meanwhile
            publish(flags + (size_t)item * kFlagInts, u);
        }
      }
      PHASE_END(1);
      continue;
    }
    // collide this substep and predict the next, a particle per thread
    const bool last = s + 1 == S;
    for (int i = first; i < total; i += stride) {
      const int b = i / N, v = i % N;
      const size_t base = (size_t)b * 3 * N;
      const float px = prev[base + v], py = prev[base + N + v],
                  pz = prev[base + 2 * N + v];
      float x = pos[base + v], y = pos[base + N + v], z = pos[base + 2 * N + v];
      if (kSlabs)
        collide_one(x, y, z, px, pz, grab_id, grab_pos, G,
                    v + x_offset0 + b * x_stride, P);
      else
        collide_one(x, y, z, px, pz, grab_id + (size_t)b * G,
                    grab_pos + (size_t)b * G * 3, G, v, P);
      const float vx = (x - px) / P.dt, vy = (y - py) / P.dt,
                  vz = (z - pz) / P.dt;
      if (last) {
        pos[base + v] = x;
        pos[base + N + v] = y;
        pos[base + 2 * N + v] = z;
        vel[base + v] = vx;
        vel[base + N + v] = vy;
        vel[base + 2 * N + v] = vz;
      } else {
        predict_one(x, y, z, vx, vy, vz, inv_mass[kSlabs ? i : v], pos, prev,
                    base, N, v, P);
      }
    }
    if (vol_err != nullptr) {
      // a body's colour block sums, each thread a fixed stride of them
      for (int b = blockIdx.x; b < B; b += gridDim.x) {
        const float* row = partial + (size_t)b * kColors * nblk;
        float a = 0.0f;
        for (int i = threadIdx.x; i < kColors * nblk; i += kThreads)
          a += row[i];
        const float sum = block_sum(a, red);
        if (threadIdx.x == 0)
          vol_err[(size_t)b * S + s] = sum / (float)(6 * P.nx * P.ny * P.nz);
        __syncthreads();
      }
    }
    PHASE_END(0);
  }
#ifdef NH_STENCIL_PHASES
  if (mark) {
    for (int k = 0; k < 3; ++k) phase_cycles[k] += acc[k];
    phase_cycles[3] += (end - begin) / (kColors + 1);  // whole substeps
    for (int k = 3; k < 6; ++k) phase_cycles[k + 1] += acc[k];
  }
#endif
#undef PHASE_END
}

// K3: S substeps of B boxes in one cooperative launch.
__global__ void __launch_bounds__(kThreads)
nh_grid_frame_kernel(const float* __restrict__ pos_in,  // [B,3,N]
                     const float* __restrict__ vel_in,  // [B,3,N]
                     float* pos,      // [B,3,N] out
                     float* prev,     // [B,3,N] out
                     float* vel,      // [B,3,N] out
                     float* vol_err,  // [B,S] or null
                     float* partial,  // [B,48,nblk], with vol_err
                     int* flags,      // [B,items,8] scratch
                     const float* __restrict__ inv_mass,  // [N]
                     const int* __restrict__ grab_id,     // [B,G]
                     const float* __restrict__ grab_pos,  // [B,G,3]
                     int B, int G, int S, int lanes, int reach,
                     GridNHParams P) {
  walk_frame<false>(pos_in, vel_in, pos, prev, vel, vol_err, partial, flags,
                    inv_mass, grab_id, grab_pos, B, G, S, lanes, reach, 0, 0,
                    0, frame_phases(S), P);
}

// K3s: phases [begin, end) of a frame of S substeps on the k slabs of one
// device (the K3s design note).
__global__ void __launch_bounds__(kThreads)
nh_slab_frame_kernel(const float* __restrict__ pos_in,  // [k,3,N]
                     const float* __restrict__ vel_in,  // [k,3,N]
                     float* pos,   // [k,3,N] out
                     float* prev,  // [k,3,N] out
                     float* vel,   // [k,3,N] out
                     const float* __restrict__ inv_mass,  // [k,N]
                     const int* __restrict__ grab_id,     // [G]
                     const float* __restrict__ grab_pos,  // [G,3]
                     int k, int G, int S, int x_offset0, int x_stride,
                     int begin, int end, GridNHParams P) {
  walk_frame<true>(pos_in, vel_in, pos, prev, vel, nullptr, nullptr, nullptr,
                   inv_mass, grab_id, grab_pos, k, G, S, kThreads, 0,
                   x_offset0, x_stride, begin, end, P);
}

#ifdef NH_STENCIL_PHASES
// iters grid barriers and nothing else: the cost of one at a grid size.
__global__ void __launch_bounds__(kThreads) nh_grid_sync_probe(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < iters; ++k) grid.sync();
}
#endif

cudaError_t cooperative(const void* kernel, int grid, void** args,
                        void* stream) {
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args, 0, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return err != cudaSuccess ? err : last;
}

}  // namespace

extern "C" {

int nh_stencil_launches_per_frame() { return 1; }

int nh_stencil_slab_launches_per_frame() { return 1; }

int nh_stencil_frame_phases(int S) { return frame_phases(S); }

int nh_stencil_flag_ints() { return kFlagInts; }

// Blocks of K3's and K3s's kernels (the fewer) that one SM of the current
// device holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
// the device's SM count.  Returns the CUDA error.
int nh_stencil_occupancy(int* blocks_per_sm, int* sms) {
  int dev = 0, slab = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, nh_grid_frame_kernel, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &slab, nh_slab_frame_kernel, kThreads, 0);
  if (err == cudaSuccess && slab < *blocks_per_sm) *blocks_per_sm = slab;
  return (int)err;
}

// Launches K3 for S substeps on `stream`: one cooperative launch of `grid`
// blocks, which must all be resident at once (nh_stencil_occupancy).
// vol_err [B,S] and its scratch partial [B, 48, nblk] may both be null.
// A colour phase's items are `lanes` tet lanes each (256 with vol_err,
// whose sums are per 256 lanes), and each waits on the items within
// `reach` of it (nh_stencil.item_lanes, nh_stencil.reach); flags is an int
// scratch of nh_stencil_flag_ints() per (body, item), which the kernel
// zeroes itself.  Returns the launch's error (0 = launched).
int nh_stencil_launch(const void* pos_in, const void* vel_in, void* pos_out,
                      void* prev_out, void* vel_out, void* vol_err,
                      void* partial, void* flags, const void* inv_mass,
                      const void* grab_id, const void* grab_pos, int B, int G,
                      int S, int lanes, int reach, int grid, GridNHParams P,
                      void* stream) {
  if (lanes < 1 || lanes > kThreads || reach < 0 ||
      (vol_err != nullptr && lanes != kThreads))
    return (int)cudaErrorInvalidValue;
  const float* a0 = (const float*)pos_in;
  const float* a1 = (const float*)vel_in;
  float* a2 = (float*)pos_out;
  float* a3 = (float*)prev_out;
  float* a4 = (float*)vel_out;
  float* a5 = (float*)vol_err;
  float* a6 = vol_err != nullptr ? (float*)partial : nullptr;
  int* a7 = (int*)flags;
  const float* a8 = (const float*)inv_mass;
  const int* a9 = (const int*)grab_id;
  const float* a10 = (const float*)grab_pos;
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &a6, &a7, &a8,
                  &a9, &a10, &B, &G, &S, &lanes, &reach, &P};
  return (int)cooperative((const void*)nh_grid_frame_kernel, grid, args,
                          stream);
}

// Launches K3s on `stream` for phases [begin, end) of a frame of S
// substeps (0 and nh_stencil_frame_phases(S) for a whole frame) on the k
// slabs of one device: one cooperative launch of `grid` blocks.  P holds a
// slab's local dims; pos_in / vel_in are read by phase 0 only.  Returns the
// launch's error (0 = launched).
int nh_stencil_slab_launch(const void* pos_in, const void* vel_in,
                           void* pos_out, void* prev_out, void* vel_out,
                           const void* inv_mass, const void* grab_id,
                           const void* grab_pos, int k, int G, int S,
                           int x_offset0, int x_stride, int begin, int end,
                           int grid, GridNHParams P, void* stream) {
  const float* a0 = (const float*)pos_in;
  const float* a1 = (const float*)vel_in;
  float* a2 = (float*)pos_out;
  float* a3 = (float*)prev_out;
  float* a4 = (float*)vel_out;
  const float* a5 = (const float*)inv_mass;
  const int* a6 = (const int*)grab_id;
  const float* a7 = (const float*)grab_pos;
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &a6, &a7, &k,
                  &G,  &S,  &x_offset0, &x_stride, &begin, &end, &P};
  return (int)cooperative((const void*)nh_slab_frame_kernel, grid, args,
                          stream);
}

#ifdef NH_STENCIL_PHASES
// Copies phase_cycles to out[7] (particle phases, colour phases, grid
// barriers, substeps, neighbour waits, waits not ready at the first poll,
// cycles waiting) and zeroes it; returns the CUDA error.
int nh_stencil_phase_cycles(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
  const unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
  return (int)err;
}

// One cooperative launch of `grid` blocks that runs `iters` grid barriers.
int nh_stencil_sync_probe(int grid, int iters, void* stream) {
  void* args[] = {&iters};
  return (int)cooperative((const void*)nh_grid_sync_probe, grid, args,
                          stream);
}
#endif

const char* nh_stencil_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
