// cavmd_tpu_torch native host I/O — C++ components behind a C ABI, loaded
// through ctypes by cavmd_tpu_torch/io/native.py, which builds this file
// with g++ at first use. The port's own copy of the JAX package's
// native/cavmd_native.cc (same code, so the two write the same bytes):
//   1. a GSD v1 frame writer (the file layout of cavmd_tpu_torch/io/gsd.py:
//      256-byte header, 32-byte index entries, 64-byte namelist entries,
//      metadata rewritten in preallocated regions after each frame), and
//   2. a bulk fixed-format table formatter for the energy-audit text files
//      (one snprintf pass over a whole observable chunk instead of
//      per-value Python string formatting).
//
// Written from the public GSD v1 format specification; not derived from
// any existing implementation.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <string>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x65DF65DF65DF65DFull;
constexpr uint32_t kGsdVersion = (1u << 16);  // 1.0
constexpr int kNameSize = 64;

#pragma pack(push, 1)
struct Header {
  uint64_t magic;
  uint64_t index_location;
  uint64_t index_allocated_entries;
  uint64_t namelist_location;
  uint64_t namelist_allocated_entries;
  uint32_t schema_version;
  uint32_t gsd_version;
  char application[64];
  char schema[64];
  char reserved[80];
};
struct IndexEntry {
  uint64_t frame;
  uint64_t N;
  int64_t location;
  uint32_t M;
  uint16_t id;
  uint8_t type;
  uint8_t flags;
};
#pragma pack(pop)

static_assert(sizeof(Header) == 256, "GSD header must be 256 bytes");
static_assert(sizeof(IndexEntry) == 32, "GSD index entry must be 32 bytes");

struct GsdWriter {
  FILE* f = nullptr;
  std::vector<std::string> names;
  std::vector<IndexEntry> index;
  std::vector<IndexEntry> pending;
  uint64_t nframes = 0;
  uint32_t schema_version = (1u << 16) | 4u;  // hoomd 1.4
  std::string application = "cavmd_tpu_torch";
  std::string schema = "hoomd";
  // preallocated metadata regions, written in place (O(frames) total cost;
  // the index stays (frame, id)-sorted because frames grow monotonically
  // and each frame's entries are id-sorted before appending)
  long index_location = 0;
  size_t index_capacity = 0;
  long names_location = 0;
  size_t names_capacity = 0;
  size_t index_written = 0;
  size_t names_written = 0;

  int name_id(const char* name) {
    for (size_t i = 0; i < names.size(); ++i)
      if (names[i] == name) return static_cast<int>(i);
    names.emplace_back(name);
    return static_cast<int>(names.size() - 1);
  }

  void write_header() {
    Header h{};
    h.magic = kMagic;
    h.index_location = static_cast<uint64_t>(index_location);
    h.index_allocated_entries = index_capacity;
    h.namelist_location = static_cast<uint64_t>(names_location);
    h.namelist_allocated_entries = names_capacity;
    h.schema_version = schema_version;
    h.gsd_version = kGsdVersion;
    strncpy(h.application, application.c_str(), sizeof(h.application) - 1);
    strncpy(h.schema, schema.c_str(), sizeof(h.schema) - 1);
    fseek(f, 0, SEEK_SET);
    fwrite(&h, sizeof(h), 1, f);
    fflush(f);
  }

  void allocate_regions(size_t icap, size_t ncap) {
    fseek(f, 0, SEEK_END);
    index_location = ftell(f);
    index_capacity = icap;
    std::vector<char> zeros(sizeof(IndexEntry) * icap, 0);
    fwrite(zeros.data(), 1, zeros.size(), f);
    names_location = ftell(f);
    names_capacity = ncap;
    std::vector<char> nzeros(kNameSize * ncap, 0);
    fwrite(nzeros.data(), 1, nzeros.size(), f);
    // refill with existing entries
    fseek(f, index_location, SEEK_SET);
    if (!index.empty())
      fwrite(index.data(), sizeof(IndexEntry), index.size(), f);
    fseek(f, names_location, SEEK_SET);
    char buf[kNameSize];
    for (auto& n : names) {
      memset(buf, 0, kNameSize);
      strncpy(buf, n.c_str(), kNameSize - 1);
      fwrite(buf, 1, kNameSize, f);
    }
    index_written = index.size();
    names_written = names.size();
    write_header();
  }

  void write_metadata() {
    if (index.size() > index_capacity || names.size() > names_capacity) {
      size_t icap = std::max(index_capacity * 2, index.size());
      size_t ncap = std::max(names_capacity * 2, names.size());
      allocate_regions(icap, ncap);
      return;
    }
    fseek(f, index_location + static_cast<long>(index_written * sizeof(IndexEntry)),
          SEEK_SET);
    fwrite(index.data() + index_written, sizeof(IndexEntry),
           index.size() - index_written, f);
    index_written = index.size();
    fseek(f, names_location + static_cast<long>(names_written * kNameSize),
          SEEK_SET);
    char buf[kNameSize];
    for (size_t i = names_written; i < names.size(); ++i) {
      memset(buf, 0, kNameSize);
      strncpy(buf, names[i].c_str(), kNameSize - 1);
      fwrite(buf, 1, kNameSize, f);
    }
    names_written = names.size();
    fflush(f);
  }
};

}  // namespace

extern "C" {

// ------------------------------------------------------------------ GSD API
void* cavmd_gsd_open(const char* path, const char* application,
                     const char* schema, uint32_t schema_version) {
  auto* w = new GsdWriter();
  w->f = fopen(path, "w+b");
  if (!w->f) {
    delete w;
    return nullptr;
  }
  if (application) w->application = application;
  if (schema) w->schema = schema;
  if (schema_version) w->schema_version = schema_version;
  char zeros[sizeof(Header)] = {0};
  fwrite(zeros, 1, sizeof(zeros), w->f);
  w->allocate_regions(256, 64);
  return w;
}

// type_id: 1=u8 2=u16 3=u32 4=u64 5=i8 6=i16 7=i32 8=i64 9=f32 10=f64
int cavmd_gsd_write_chunk(void* handle, const char* name, const void* data,
                          uint64_t rows, uint32_t cols, uint8_t type_id,
                          uint64_t item_size) {
  auto* w = static_cast<GsdWriter*>(handle);
  if (!w || !w->f) return -1;
  fseek(w->f, 0, SEEK_END);
  long loc = ftell(w->f);
  size_t nbytes = static_cast<size_t>(rows) * cols * item_size;
  if (fwrite(data, 1, nbytes, w->f) != nbytes) return -2;
  IndexEntry e{};
  e.frame = w->nframes;
  e.N = rows;
  e.location = loc;
  e.M = cols;
  e.id = static_cast<uint16_t>(w->name_id(name));
  e.type = type_id;
  e.flags = 0;
  w->pending.push_back(e);
  return 0;
}

int cavmd_gsd_end_frame(void* handle) {
  auto* w = static_cast<GsdWriter*>(handle);
  if (!w) return -1;
  std::sort(w->pending.begin(), w->pending.end(),
            [](const IndexEntry& a, const IndexEntry& b) { return a.id < b.id; });
  w->index.insert(w->index.end(), w->pending.begin(), w->pending.end());
  w->pending.clear();
  w->nframes += 1;
  w->write_metadata();
  return 0;
}

uint64_t cavmd_gsd_nframes(void* handle) {
  auto* w = static_cast<GsdWriter*>(handle);
  return w ? w->nframes : 0;
}

void cavmd_gsd_close(void* handle) {
  auto* w = static_cast<GsdWriter*>(handle);
  if (!w) return;
  if (w->f) fclose(w->f);
  delete w;
}

// ----------------------------------------------------------- table formatter
// Format a (nrows x ncols) row-major double matrix as fixed-point text with
// `decimals` places, columns space-separated, one row per line. Column 1
// (the timestep) is written as an integer when int_col >= 0. Returns bytes
// written, or -1 if `cap` was too small.
long cavmd_format_table(const double* data, long nrows, long ncols,
                        int decimals, int int_col, char* out, long cap) {
  long pos = 0;
  for (long r = 0; r < nrows; ++r) {
    for (long c = 0; c < ncols; ++c) {
      if (pos + 64 > cap) return -1;
      if (c) out[pos++] = ' ';
      double v = data[r * ncols + c];
      int wrote;
      if (c == int_col) {
        wrote = snprintf(out + pos, cap - pos, "%lld",
                         static_cast<long long>(v));
      } else {
        wrote = snprintf(out + pos, cap - pos, "%.*f", decimals, v);
      }
      if (wrote < 0) return -1;
      pos += wrote;
    }
    if (pos + 1 > cap) return -1;
    out[pos++] = '\n';
  }
  return pos;
}

}  // extern "C"
