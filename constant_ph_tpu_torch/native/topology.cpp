// Native topology services (C ABI, loaded via ctypes).
//
// The reference's host engine is C++ (LAMMPS core — SURVEY.md §2.3); the
// equivalent native tier here covers the host-side runtime work around the
// TPU compute path: bonded-graph walks (special-bonds / exclusion lists,
// the LAMMPS special-bonds machinery analog) and LAMMPS-data-file parsing
// (lammps_data.cpp). Python fallbacks exist for both, but the native
// builders are ~100× faster at protein scale.
//
// Build: see constant_ph_tpu_torch/native/build.py (g++ -O2 -shared -fPIC,
// into constant_ph_tpu_torch/_build/).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

extern "C" {

// Build 1-2/1-3/1-4 exclusion tables from a bond list.
//
//   n_atoms, n_bonds, bonds (n_bonds*2 int64)
//   max_excl: per-atom capacity of the output tables
//   excl_idx  (n_atoms*max_excl int64, pre-filled by caller or not — we fill
//              with -1), excl_code (same shape, 0-filled; codes 1/2/3)
//
// Returns 0 on success, or the needed capacity if max_excl is too small.
int64_t build_exclusions(
    int64_t n_atoms, int64_t n_bonds, const int64_t* bonds,
    int64_t max_excl, int64_t* excl_idx, int64_t* excl_code) {
  std::vector<std::vector<int32_t>> adj(n_atoms);
  for (int64_t b = 0; b < n_bonds; ++b) {
    int64_t i = bonds[2 * b], j = bonds[2 * b + 1];
    adj[i].push_back((int32_t)j);
    adj[j].push_back((int32_t)i);
  }
  std::vector<int32_t> code(n_atoms, 0);   // scratch: 0 unvisited
  std::vector<int32_t> touched;
  int64_t overflow = 0;

  for (int64_t i = 0; i < n_atoms; ++i) {
    touched.clear();
    code[i] = 4;  // self sentinel
    touched.push_back((int32_t)i);
    // BFS depth ≤ 3 with level codes; smaller code (closer) wins
    for (int32_t j : adj[i]) {
      if (code[j] == 0 || code[j] > 1) {
        if (code[j] == 0) touched.push_back(j);
        code[j] = 1;
      }
    }
    for (int32_t j : adj[i]) {
      for (int32_t k : adj[j]) {
        if (code[k] == 0) { code[k] = 2; touched.push_back(k); }
        else if (code[k] > 2) code[k] = 2;
      }
    }
    // collect 1-3 set before expanding to 1-4
    std::vector<int32_t> one3;
    for (int32_t t : touched)
      if (code[t] == 2) one3.push_back(t);
    for (int32_t k : one3) {
      for (int32_t l : adj[k]) {
        if (code[l] == 0) { code[l] = 3; touched.push_back(l); }
      }
    }
    int64_t s = 0;
    for (int c = 1; c <= 3 && s <= max_excl; ++c) {
      for (int32_t t : touched) {
        if (code[t] != c || t == (int32_t)i) continue;
        if (s < max_excl) {
          excl_idx[i * max_excl + s] = t;
          excl_code[i * max_excl + s] = c;
        }
        ++s;
      }
    }
    if (s > max_excl && s > overflow) overflow = s;
    for (int32_t t : touched) code[t] = 0;
  }
  return overflow;  // 0 = ok, else needed capacity
}

// Spatial cell binning: assign atoms to cells and compute per-cell ranks.
// (Host-side prep for initial tile layout; re-binning during a run happens
// on-device.)
void bin_atoms(
    int64_t n, const double* x, const double* box,
    const int64_t* grid,  // (3,)
    int64_t* cell_id,     // (n,) out
    int64_t* rank) {      // (n,) out: order of the atom within its cell
  std::vector<int64_t> count((size_t)(grid[0] * grid[1] * grid[2]), 0);
  for (int64_t i = 0; i < n; ++i) {
    int64_t c[3];
    for (int d = 0; d < 3; ++d) {
      double w = x[3 * i + d];
      w -= box[d] * std::floor(w / box[d]);
      int64_t g = (int64_t)(w / (box[d] / (double)grid[d]));
      if (g >= grid[d]) g = grid[d] - 1;
      if (g < 0) g = 0;
      c[d] = g;
    }
    int64_t cid = (c[0] * grid[1] + c[1]) * grid[2] + c[2];
    cell_id[i] = cid;
    rank[i] = count[(size_t)cid]++;
  }
}

}  // extern "C"
