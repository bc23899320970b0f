// Native mesh-preprocessing kernels for tetsim_torch (the port's own copy of
// tetsim_tpu/native/coloring.cpp; the two must give the same tables).
//
// The constraint-graph coloring the reference declared but never implemented
// (SoftbodyGPU.js:590 stores color = -1 "Undefined") is host-side precompute
// in this framework; for million-tet meshes the pure-Python versions in
// mesh.py take minutes, so the hot loops live here.  Exposed over a plain C
// ABI and loaded with ctypes (no pybind11 dependency).
//
// All functions return 0 on success.

#include <cstdint>
#include <vector>
#include <algorithm>
#include <numeric>

extern "C" {

// Order-preserving level schedule: level[i] = 1 + max level of any earlier
// tet sharing a vertex with tet i.  Mirrors mesh.level_schedule.
int level_schedule(const int32_t* tets, int64_t m, int64_t n_particles,
                   int32_t* levels_out) {
  std::vector<int32_t> vert_level(static_cast<size_t>(n_particles), -1);
  for (int64_t i = 0; i < m; ++i) {
    const int32_t* t = tets + 4 * i;
    int32_t lvl = -1;
    for (int k = 0; k < 4; ++k) lvl = std::max(lvl, vert_level[t[k]]);
    lvl += 1;
    levels_out[i] = lvl;
    for (int k = 0; k < 4; ++k)
      vert_level[t[k]] = std::max(vert_level[t[k]], lvl);
  }
  return 0;
}

// First-fit greedy coloring of the tet conflict graph (tets conflict iff
// they share a vertex).  Mirrors mesh.greedy_color; per-vertex dynamic
// color bitmasks keep it O(sum valence) with unbounded color count.
int greedy_color(const int32_t* tets, int64_t m, int64_t n_particles,
                 int32_t* colors_out) {
  // per-vertex mask of colors used by incident tets, in 64-color words
  std::vector<std::vector<uint64_t>> used(static_cast<size_t>(n_particles));
  std::vector<uint64_t> merged;
  for (int64_t i = 0; i < m; ++i) {
    const int32_t* t = tets + 4 * i;
    merged.clear();
    for (int k = 0; k < 4; ++k) {
      const auto& u = used[t[k]];
      if (u.size() > merged.size()) merged.resize(u.size(), 0);
      for (size_t w = 0; w < u.size(); ++w) merged[w] |= u[w];
    }
    int32_t c = -1;
    for (size_t w = 0; w < merged.size() && c < 0; ++w) {
      uint64_t free_bits = ~merged[w];
      if (free_bits)
        c = static_cast<int32_t>(64 * w + __builtin_ctzll(free_bits));
    }
    if (c < 0) c = static_cast<int32_t>(64 * merged.size());
    colors_out[i] = c;
    const size_t word = c / 64;
    const uint64_t bit = 1ull << (c % 64);
    for (int k = 0; k < 4; ++k) {
      auto& u = used[t[k]];
      if (u.size() <= word) u.resize(word + 1, 0);
      u[word] |= bit;
    }
  }
  return 0;
}

// Stable counting-sort of tet ids by color: fills slots[L*cmax] (row-major,
// -1 padded) given precomputed colors.  Mirrors mesh.color_slots.
// Returns the number of colors L, or -1 if outputs would not fit
// (caller passes capacity = l_cap * cmax_cap).
int64_t color_slots(const int32_t* colors, int64_t m, int64_t l_cap,
                    int64_t cmax_cap, int32_t* slots_out, int64_t* cmax_out) {
  int32_t num_colors = 0;
  for (int64_t i = 0; i < m; ++i)
    num_colors = std::max(num_colors, colors[i] + 1);
  if (num_colors > l_cap) return -1;
  std::vector<int64_t> counts(num_colors, 0);
  for (int64_t i = 0; i < m; ++i) counts[colors[i]]++;
  const int64_t cmax = *std::max_element(counts.begin(), counts.end());
  if (cmax > cmax_cap) return -1;
  std::fill(slots_out, slots_out + num_colors * cmax, -1);
  std::vector<int64_t> fill(num_colors, 0);
  for (int64_t i = 0; i < m; ++i) {
    const int32_t c = colors[i];
    slots_out[c * cmax + fill[c]++] = static_cast<int32_t>(i);
  }
  *cmax_out = cmax;
  return num_colors;
}

}  // extern "C"
