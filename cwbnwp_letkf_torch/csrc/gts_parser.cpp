// Native fixed-width parser for WRFDA "gts_omboma" conventional-obs files.
//
// Host-side replacement for the reference's Fortran formatted READs
// (module_gts_omboma.f90:93-500).  The reference amortizes
// parsing over >= nmember MPI ranks (one member file per rank,
// cwb_letkf.f90:46-48); a single host ingests all members itself, so the
// text parse is on the critical path — this parser is ~40x the Python one
// and is driven from a thread pool (one member file per thread).
//
// File format (gts_omboma.f90:93,132,135): repeated platform sections
//   <name:a20><nobs:i8>
//   per report: <nlev:i8><nreq:i8>
//   per level:  (2i8,a5,2f9.2,f17.7, nvar*(2f17.7,i8,2f17.7))
//
// C ABI (driven from Python via ctypes, io/native.py):
//   gts_parse(path) -> handle          gts_free(handle)
//   gts_num_families / gts_family_name / gts_family_nrec / gts_family_nvar
//   gts_family_copy(handle, idx, ids, lat, lon, pre, level, obs, omb, qc, err)

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace {

struct Family {
  int nvar;
};

// family name -> observed-variable count (gts_omboma.f90:101-500)
const std::map<std::string, int>& family_table() {
  static const std::map<std::string, int> t = {
      {"synop", 5},    {"ships", 5},    {"buoy", 5},   {"metar", 5},
      {"sonde_sfc", 5},{"tamdar_sfc", 5},
      {"pilot", 2},    {"profiler", 2}, {"geoamv", 2}, {"qscat", 2},
      {"polaramv", 2},
      {"gpspw", 1},
      {"sound", 4},    {"tamdar", 4},   {"airep", 4},
      {"gpsref", 1},
  };
  return t;
}

struct FamilyData {
  std::string name;
  int nvar = 0;
  std::vector<std::string> ids;      // a5, trimmed
  std::vector<float> lat, lon, pre;
  std::vector<int32_t> level;        // 1-based level within report
  std::vector<float> obs, omb, err;  // [nrec * nvar], record-major
  std::vector<int32_t> qc;           // [nrec * nvar]
};

struct Parsed {
  std::vector<FamilyData> families;
  std::map<std::string, size_t> index;
  std::string error;
};

// Fixed-width field readers.  Fortran list panels tolerate leading blanks;
// strtod/strtol skip them natively.  A field narrower than expected (short
// line) reads as 0 — the Fortran READ would error instead, but short lines
// do not occur in well-formed files.
inline double read_f(const char* s, size_t len, size_t& pos, size_t width) {
  if (pos >= len) return 0.0;
  size_t w = std::min(width, len - pos);
  char buf[32];
  w = std::min(w, sizeof(buf) - 1);
  std::memcpy(buf, s + pos, w);
  buf[w] = '\0';
  pos += width;
  return std::strtod(buf, nullptr);
}

inline long read_i(const char* s, size_t len, size_t& pos, size_t width) {
  if (pos >= len) return 0;
  size_t w = std::min(width, len - pos);
  char buf[32];
  w = std::min(w, sizeof(buf) - 1);
  std::memcpy(buf, s + pos, w);
  buf[w] = '\0';
  pos += width;
  return std::strtol(buf, nullptr, 10);
}

inline std::string trim(const std::string& s) {
  size_t a = s.find_first_not_of(" \t\r");
  if (a == std::string::npos) return "";
  size_t b = s.find_last_not_of(" \t\r");
  return s.substr(a, b - a + 1);
}

class LineReader {
 public:
  LineReader(const char* data, size_t size) : data_(data), size_(size) {}
  bool next(const char*& line, size_t& len) {
    if (pos_ >= size_) return false;
    size_t start = pos_;
    while (pos_ < size_ && data_[pos_] != '\n') ++pos_;
    len = pos_ - start;
    if (len > 0 && data_[start + len - 1] == '\r') --len;
    if (pos_ < size_) ++pos_;  // skip '\n'
    line = data_ + start;
    return true;
  }

 private:
  const char* data_;
  size_t size_;
  size_t pos_ = 0;
};

void parse_record_line(const char* s, size_t len, int nvar, FamilyData& fd,
                       int lev) {
  size_t pos = 16;  // skip kk(i8) l(i8)
  std::string ident(s + std::min(pos, len),
                    s + std::min(pos + 5, len));
  pos += 5;
  float lat = static_cast<float>(read_f(s, len, pos, 9));
  float lon = static_cast<float>(read_f(s, len, pos, 9));
  float slot = static_cast<float>(read_f(s, len, pos, 17));
  fd.ids.push_back(trim(ident));
  fd.lat.push_back(lat);
  fd.lon.push_back(lon);
  fd.pre.push_back(slot);
  fd.level.push_back(lev);
  for (int v = 0; v < nvar; ++v) {
    fd.obs.push_back(static_cast<float>(read_f(s, len, pos, 17)));
    fd.omb.push_back(static_cast<float>(read_f(s, len, pos, 17)));
    fd.qc.push_back(static_cast<int32_t>(read_i(s, len, pos, 8)));
    fd.err.push_back(static_cast<float>(read_f(s, len, pos, 17)));
    pos += 17;  // oma, unused (the Fortran reads it into scratch)
  }
}

}  // namespace

extern "C" {

void* gts_parse_buffer(const char* data, long size) {
  auto* out = new Parsed();
  LineReader rd(data, static_cast<size_t>(size));
  const char* line;
  size_t len;
  while (rd.next(line, len)) {
    std::string header(line, len);
    if (trim(header).empty()) continue;
    std::string name = trim(header.substr(0, std::min<size_t>(20, len)));
    for (auto& c : name) c = static_cast<char>(std::tolower(c));
    size_t hpos = 20;
    long nobs = read_i(line, len, hpos, 8);
    auto it = family_table().find(name);
    if (it == family_table().end() || nobs <= 0) continue;
    int nvar = it->second;

    size_t fi;
    auto idx_it = out->index.find(name);
    if (idx_it == out->index.end()) {
      fi = out->families.size();
      out->families.emplace_back();
      out->families.back().name = name;
      out->families.back().nvar = nvar;
      out->index[name] = fi;
    } else {
      fi = idx_it->second;
    }
    FamilyData& fd = out->families[fi];

    for (long r = 0; r < nobs; ++r) {
      if (!rd.next(line, len)) { out->error = "truncated report header"; return out; }
      size_t pos = 0;
      long nlev = read_i(line, len, pos, 8);
      for (long l = 0; l < nlev; ++l) {
        if (!rd.next(line, len)) { out->error = "truncated record"; return out; }
        parse_record_line(line, len, nvar, fd, static_cast<int>(l + 1));
      }
    }
  }
  return out;
}

void* gts_parse(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    auto* out = new Parsed();
    out->error = std::string("cannot open ") + path;
    return out;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size));
  size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  return gts_parse_buffer(buf.data(), static_cast<long>(got));
}

const char* gts_error(void* h) {
  auto* p = static_cast<Parsed*>(h);
  return p->error.empty() ? nullptr : p->error.c_str();
}

int gts_num_families(void* h) {
  return static_cast<int>(static_cast<Parsed*>(h)->families.size());
}

const char* gts_family_name(void* h, int idx) {
  return static_cast<Parsed*>(h)->families[idx].name.c_str();
}

long gts_family_nrec(void* h, int idx) {
  return static_cast<long>(static_cast<Parsed*>(h)->families[idx].ids.size());
}

int gts_family_nvar(void* h, int idx) {
  return static_cast<Parsed*>(h)->families[idx].nvar;
}

// Copies into caller-allocated buffers:
//   ids:  char[nrec*8]  (zero-padded, max 5 significant chars)
//   lat/lon/pre: float[nrec];  level: int32[nrec]
//   obs/omb/err: float[nrec*nvar];  qc: int32[nrec*nvar]
void gts_family_copy(void* h, int idx, char* ids, float* lat, float* lon,
                     float* pre, int32_t* level, float* obs, float* omb,
                     int32_t* qc, float* err) {
  const FamilyData& fd = static_cast<Parsed*>(h)->families[idx];
  size_t n = fd.ids.size();
  for (size_t i = 0; i < n; ++i) {
    std::memset(ids + i * 8, 0, 8);
    std::memcpy(ids + i * 8, fd.ids[i].data(),
                std::min<size_t>(fd.ids[i].size(), 7));
  }
  std::memcpy(lat, fd.lat.data(), n * sizeof(float));
  std::memcpy(lon, fd.lon.data(), n * sizeof(float));
  std::memcpy(pre, fd.pre.data(), n * sizeof(float));
  std::memcpy(level, fd.level.data(), n * sizeof(int32_t));
  std::memcpy(obs, fd.obs.data(), fd.obs.size() * sizeof(float));
  std::memcpy(omb, fd.omb.data(), fd.omb.size() * sizeof(float));
  std::memcpy(qc, fd.qc.data(), fd.qc.size() * sizeof(int32_t));
  std::memcpy(err, fd.err.data(), fd.err.size() * sizeof(float));
}

void gts_free(void* h) { delete static_cast<Parsed*>(h); }

// ---------------------------------------------------------------------------
// Radar retrieval files (module_radar.f90:90-112):
//   <nobs:i10>
//   per obs: '(5(f10.4,1x))' -> obs, H(xb)_member, lon, lat, alt
// ---------------------------------------------------------------------------

struct RadarParsed {
  std::vector<float> data;  // [nobs * 5]
  std::string error;
};

void* radar_parse(const char* path) {
  auto* out = new RadarParsed();
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    out->error = std::string("cannot open ") + path;
    return out;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size));
  size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);

  LineReader rd(buf.data(), got);
  const char* line;
  size_t len;
  if (!rd.next(line, len)) return out;
  size_t pos = 0;
  long nobs = read_i(line, len, pos, 10);
  if (nobs <= 0) return out;
  out->data.reserve(static_cast<size_t>(nobs) * 5);
  for (long n = 0; n < nobs; ++n) {
    if (!rd.next(line, len)) { out->error = "truncated radar file"; return out; }
    size_t p = 0;
    for (int j = 0; j < 5; ++j) {
      out->data.push_back(static_cast<float>(read_f(line, len, p, 10)));
      p += 1;  // the 1x separator
    }
  }
  return out;
}

const char* radar_error(void* h) {
  auto* p = static_cast<RadarParsed*>(h);
  return p->error.empty() ? nullptr : p->error.c_str();
}

long radar_nobs(void* h) {
  return static_cast<long>(static_cast<RadarParsed*>(h)->data.size() / 5);
}

void radar_copy(void* h, float* out) {
  auto* p = static_cast<RadarParsed*>(h);
  std::memcpy(out, p->data.data(), p->data.size() * sizeof(float));
}

void radar_free(void* h) { delete static_cast<RadarParsed*>(h); }

}  // extern "C"
