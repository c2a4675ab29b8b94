// LAMMPS data-file parser (C ABI, loaded via ctypes).
//
// Reads the "read_data" format the reference's host consumes (Masses,
// Pair Coeffs, Atoms full/charge style, Bonds, Angles, Dihedrals,
// Impropers, Velocities) into flat arrays. Two-pass: size query, then fill.
// A pure-Python fallback lives in systems/lammps_data.py.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Data {
  int64_t n_atoms = 0, n_bonds = 0, n_angles = 0, n_dihedrals = 0,
          n_impropers = 0, n_types = 0;
  double box[6] = {0, 0, 0, 0, 0, 0};  // xlo xhi ylo yhi zlo zhi
  std::vector<double> x, v, q, mass_by_type, pair_eps, pair_sig;
  std::vector<int64_t> type, mol;
  std::vector<int64_t> bonds, angles, dihedrals, impropers;   // type,i,j,...
  bool ok = false;
  std::string error;
};

std::string strip_comment(const std::string& line) {
  auto pos = line.find('#');
  std::string s = (pos == std::string::npos) ? line : line.substr(0, pos);
  size_t a = s.find_first_not_of(" \t\r\n");
  if (a == std::string::npos) return "";
  size_t b = s.find_last_not_of(" \t\r\n");
  return s.substr(a, b - a + 1);
}

bool parse(const char* path, Data& d) {
  std::ifstream f(path);
  if (!f) { d.error = "cannot open file"; return false; }
  std::string line;
  std::getline(f, line);  // title line

  // header
  std::streampos body_start = f.tellg();
  while (std::getline(f, line)) {
    std::string s = strip_comment(line);
    if (s.empty()) continue;
    std::istringstream is(s);
    long long n;
    if (s.find("atoms") != std::string::npos && (is >> n)) d.n_atoms = n;
    else if (s.find("bonds") != std::string::npos &&
             s.find("types") == std::string::npos) {
      std::istringstream i2(s); i2 >> n; d.n_bonds = n;
    } else if (s.find("angles") != std::string::npos &&
               s.find("types") == std::string::npos) {
      std::istringstream i2(s); i2 >> n; d.n_angles = n;
    } else if (s.find("dihedrals") != std::string::npos &&
               s.find("types") == std::string::npos) {
      std::istringstream i2(s); i2 >> n; d.n_dihedrals = n;
    } else if (s.find("impropers") != std::string::npos &&
               s.find("types") == std::string::npos) {
      std::istringstream i2(s); i2 >> n; d.n_impropers = n;
    } else if (s.find("atom types") != std::string::npos) {
      std::istringstream i2(s); i2 >> n; d.n_types = n;
    } else if (s.find("xlo xhi") != std::string::npos) {
      std::istringstream i2(s); i2 >> d.box[0] >> d.box[1];
    } else if (s.find("ylo yhi") != std::string::npos) {
      std::istringstream i2(s); i2 >> d.box[2] >> d.box[3];
    } else if (s.find("zlo zhi") != std::string::npos) {
      std::istringstream i2(s); i2 >> d.box[4] >> d.box[5];
    } else if (s == "Masses" || s == "Atoms" || s.rfind("Atoms", 0) == 0 ||
               s == "Bonds" || s == "Angles" || s == "Dihedrals" ||
               s == "Impropers" || s == "Velocities" ||
               s.rfind("Pair Coeffs", 0) == 0) {
      break;  // body begins
    }
  }

  d.x.assign(d.n_atoms * 3, 0.0);
  d.v.assign(d.n_atoms * 3, 0.0);
  d.q.assign(d.n_atoms, 0.0);
  d.type.assign(d.n_atoms, 0);
  d.mol.assign(d.n_atoms, 0);
  d.mass_by_type.assign(d.n_types, 0.0);
  d.pair_eps.assign(d.n_types, 0.0);
  d.pair_sig.assign(d.n_types, 0.0);
  d.bonds.assign(d.n_bonds * 3, 0);
  d.angles.assign(d.n_angles * 4, 0);
  d.dihedrals.assign(d.n_dihedrals * 5, 0);
  d.impropers.assign(d.n_impropers * 5, 0);

  // body sections
  f.clear();
  f.seekg(0);
  std::getline(f, line);
  std::string section;
  bool atoms_full = true;
  int64_t remaining = 0;
  while (std::getline(f, line)) {
    std::string s = strip_comment(line);
    if (s.empty()) continue;
    // section headers
    if (s == "Masses") { section = "Masses"; remaining = d.n_types; continue; }
    if (s.rfind("Pair Coeffs", 0) == 0) {
      section = "PairCoeffs"; remaining = d.n_types; continue;
    }
    if (s.rfind("Atoms", 0) == 0) {
      section = "Atoms"; remaining = d.n_atoms;
      atoms_full = line.find("charge") == std::string::npos;
      continue;
    }
    if (s == "Velocities") { section = "Vel"; remaining = d.n_atoms; continue; }
    if (s == "Bonds") { section = "Bonds"; remaining = d.n_bonds; continue; }
    if (s == "Angles") { section = "Angles"; remaining = d.n_angles; continue; }
    if (s == "Dihedrals") {
      section = "Dihedrals"; remaining = d.n_dihedrals; continue;
    }
    if (s == "Impropers") {
      section = "Impropers"; remaining = d.n_impropers; continue;
    }
    if (!remaining) { section.clear(); continue; }

    std::istringstream is(s);
    if (section == "Masses") {
      long long t; double m; is >> t >> m;
      if (t >= 1 && t <= d.n_types) d.mass_by_type[t - 1] = m;
    } else if (section == "PairCoeffs") {
      long long t; double e, sg; is >> t >> e >> sg;
      if (t >= 1 && t <= d.n_types) { d.pair_eps[t-1] = e; d.pair_sig[t-1] = sg; }
    } else if (section == "Atoms") {
      long long id, mol = 0, ty; double q = 0, X, Y, Z;
      if (atoms_full) is >> id >> mol >> ty >> q >> X >> Y >> Z;
      else is >> id >> ty >> q >> X >> Y >> Z;  // charge style
      if (id >= 1 && id <= d.n_atoms) {
        d.mol[id-1] = mol; d.type[id-1] = ty - 1; d.q[id-1] = q;
        d.x[(id-1)*3] = X; d.x[(id-1)*3+1] = Y; d.x[(id-1)*3+2] = Z;
      }
    } else if (section == "Vel") {
      long long id; double vx, vy, vz; is >> id >> vx >> vy >> vz;
      if (id >= 1 && id <= d.n_atoms) {
        d.v[(id-1)*3] = vx; d.v[(id-1)*3+1] = vy; d.v[(id-1)*3+2] = vz;
      }
    } else if (section == "Bonds") {
      long long id, t, i, j; is >> id >> t >> i >> j;
      if (id >= 1 && id <= d.n_bonds) {
        d.bonds[(id-1)*3] = t-1; d.bonds[(id-1)*3+1] = i-1;
        d.bonds[(id-1)*3+2] = j-1;
      }
    } else if (section == "Angles") {
      long long id, t, i, j, k; is >> id >> t >> i >> j >> k;
      if (id >= 1 && id <= d.n_angles) {
        int64_t* a = &d.angles[(id-1)*4];
        a[0] = t-1; a[1] = i-1; a[2] = j-1; a[3] = k-1;
      }
    } else if (section == "Dihedrals" || section == "Impropers") {
      long long id, t, i, j, k, l; is >> id >> t >> i >> j >> k >> l;
      auto& vec = (section == "Dihedrals") ? d.dihedrals : d.impropers;
      int64_t nmax = (section == "Dihedrals") ? d.n_dihedrals : d.n_impropers;
      if (id >= 1 && id <= nmax) {
        int64_t* a = &vec[(id-1)*5];
        a[0] = t-1; a[1] = i-1; a[2] = j-1; a[3] = k-1; a[4] = l-1;
      }
    }
    --remaining;
  }
  d.ok = true;
  return true;
}

Data* g_data = nullptr;

}  // namespace

extern "C" {

// pass 1: parse + return sizes: [n_atoms, n_bonds, n_angles, n_dihedrals,
// n_impropers, n_types] ; returns 0 on success
int64_t ld_open(const char* path, int64_t* sizes) {
  delete g_data;
  g_data = new Data();
  if (!parse(path, *g_data)) return 1;
  sizes[0] = g_data->n_atoms; sizes[1] = g_data->n_bonds;
  sizes[2] = g_data->n_angles; sizes[3] = g_data->n_dihedrals;
  sizes[4] = g_data->n_impropers; sizes[5] = g_data->n_types;
  return 0;
}

// pass 2: copy into caller-allocated buffers
void ld_fill(double* x, double* v, double* q, int64_t* type, int64_t* mol,
             double* mass_by_type, double* pair_eps, double* pair_sig,
             int64_t* bonds, int64_t* angles, int64_t* dihedrals,
             int64_t* impropers, double* box) {
  Data& d = *g_data;
  std::memcpy(x, d.x.data(), d.x.size() * 8);
  std::memcpy(v, d.v.data(), d.v.size() * 8);
  std::memcpy(q, d.q.data(), d.q.size() * 8);
  std::memcpy(type, d.type.data(), d.type.size() * 8);
  std::memcpy(mol, d.mol.data(), d.mol.size() * 8);
  std::memcpy(mass_by_type, d.mass_by_type.data(), d.mass_by_type.size() * 8);
  std::memcpy(pair_eps, d.pair_eps.data(), d.pair_eps.size() * 8);
  std::memcpy(pair_sig, d.pair_sig.data(), d.pair_sig.size() * 8);
  if (!d.bonds.empty()) std::memcpy(bonds, d.bonds.data(), d.bonds.size() * 8);
  if (!d.angles.empty())
    std::memcpy(angles, d.angles.data(), d.angles.size() * 8);
  if (!d.dihedrals.empty())
    std::memcpy(dihedrals, d.dihedrals.data(), d.dihedrals.size() * 8);
  if (!d.impropers.empty())
    std::memcpy(impropers, d.impropers.data(), d.impropers.size() * 8);
  std::memcpy(box, d.box, 6 * 8);
}

void ld_close() { delete g_data; g_data = nullptr; }

}  // extern "C"
