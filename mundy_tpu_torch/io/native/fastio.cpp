// fastio: buffered binary trajectory IO + Hilbert keys (native runtime layer).
//
// The compiled-IO role that Exodus/Ioss plays in the reference's IOBroker
// (scrap/parameter_interface/io/src/mundy_io/IOBroker.hpp): high-throughput
// trajectory frames with CRC integrity, plus host-side Hilbert key batches
// for load-balance resharding of arrays too large for the numpy path.
//
// Format (little-endian):
//   header:  magic "MTRJ1\0\0\0" (8) | n_particles i64 | n_fields i64
//   frame:   step i64 | time f64 | crc32 u32 | pad u32 | payload (n*3*f32)
//
// C API only (ctypes-friendly); no exceptions across the boundary.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr char kMagic[8] = {'M', 'T', 'R', 'J', '1', 0, 0, 0};

uint32_t crc32(const uint8_t* data, size_t len) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Writer {
  FILE* f = nullptr;
  int64_t n_particles = 0;
  std::vector<uint8_t> buf;  // frame staging buffer
};

struct Reader {
  FILE* f = nullptr;
  int64_t n_particles = 0;
  int64_t n_frames = 0;
  int64_t frame_bytes = 0;
  int64_t header_bytes = 0;
};

int64_t frame_size(int64_t n) {
  return 8 + 8 + 4 + 4 + n * 3 * static_cast<int64_t>(sizeof(float));
}

}  // namespace

extern "C" {

void* mundy_traj_open_write(const char* path, int64_t n_particles, int append) {
  Writer* w = new Writer();
  w->n_particles = n_particles;
  w->f = std::fopen(path, append ? "ab" : "wb");
  if (!w->f) {
    delete w;
    return nullptr;
  }
  if (!append) {
    int64_t n_fields = 1;
    std::fwrite(kMagic, 1, 8, w->f);
    std::fwrite(&n_particles, 8, 1, w->f);
    std::fwrite(&n_fields, 8, 1, w->f);
  }
  w->buf.resize(static_cast<size_t>(frame_size(n_particles)));
  return w;
}

int mundy_traj_write_frame(void* handle, int64_t step, double time,
                           const float* pos) {
  Writer* w = static_cast<Writer*>(handle);
  if (!w || !w->f) return -1;
  const int64_t payload = w->n_particles * 3 * static_cast<int64_t>(sizeof(float));
  uint8_t* p = w->buf.data();
  std::memcpy(p, &step, 8);
  std::memcpy(p + 8, &time, 8);
  const uint32_t crc =
      crc32(reinterpret_cast<const uint8_t*>(pos), static_cast<size_t>(payload));
  const uint32_t pad = 0;
  std::memcpy(p + 16, &crc, 4);
  std::memcpy(p + 20, &pad, 4);
  std::memcpy(p + 24, pos, static_cast<size_t>(payload));
  const size_t total = static_cast<size_t>(frame_size(w->n_particles));
  if (std::fwrite(p, 1, total, w->f) != total) return -2;
  return 0;
}

void mundy_traj_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  if (w) {
    if (w->f) std::fclose(w->f);
    delete w;
  }
}

void* mundy_traj_open_read(const char* path) {
  Reader* r = new Reader();
  r->f = std::fopen(path, "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  char magic[8];
  int64_t n_fields = 0;
  if (std::fread(magic, 1, 8, r->f) != 8 || std::memcmp(magic, kMagic, 8) != 0 ||
      std::fread(&r->n_particles, 8, 1, r->f) != 1 ||
      std::fread(&n_fields, 8, 1, r->f) != 1) {
    std::fclose(r->f);
    delete r;
    return nullptr;
  }
  r->header_bytes = 24;
  r->frame_bytes = frame_size(r->n_particles);
  std::fseek(r->f, 0, SEEK_END);
  const int64_t end = std::ftell(r->f);
  r->n_frames = (end - r->header_bytes) / r->frame_bytes;
  return r;
}

int64_t mundy_traj_num_particles(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  return r ? r->n_particles : -1;
}

int64_t mundy_traj_num_frames(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  return r ? r->n_frames : -1;
}

// returns 0 ok, -1 bad handle/index, -2 io error, -3 crc mismatch
int mundy_traj_read_frame(void* handle, int64_t idx, int64_t* step, double* time,
                          float* pos) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r || idx < 0 || idx >= r->n_frames) return -1;
  std::fseek(r->f, r->header_bytes + idx * r->frame_bytes, SEEK_SET);
  uint32_t crc = 0, pad = 0;
  const int64_t payload = r->n_particles * 3 * static_cast<int64_t>(sizeof(float));
  if (std::fread(step, 8, 1, r->f) != 1 || std::fread(time, 8, 1, r->f) != 1 ||
      std::fread(&crc, 4, 1, r->f) != 1 || std::fread(&pad, 4, 1, r->f) != 1 ||
      std::fread(pos, 1, static_cast<size_t>(payload), r->f) !=
          static_cast<size_t>(payload))
    return -2;
  const uint32_t actual =
      crc32(reinterpret_cast<const uint8_t*>(pos), static_cast<size_t>(payload));
  if (actual != crc) return -3;
  return 0;
}

void mundy_traj_close_read(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (r) {
    if (r->f) std::fclose(r->f);
    delete r;
  }
}

// --------------------------------------------------------------------------
// Hilbert keys (Skilling transform), batch over points — host-side
// resharding for arrays where the interpreter path is too slow.
// --------------------------------------------------------------------------
void mundy_hilbert_keys(const double* pos, int64_t n, const double* lo,
                        const double* hi, int bits, uint32_t* keys) {
  const uint32_t ncell = 1u << bits;
  for (int64_t i = 0; i < n; i++) {
    uint32_t x[3];
    for (int a = 0; a < 3; a++) {
      double f = (pos[3 * i + a] - lo[a]) / (hi[a] - lo[a]);
      if (f < 0) f = 0;
      if (f > 0.999999999) f = 0.999999999;
      x[a] = static_cast<uint32_t>(f * ncell);
    }
    // inverse undo
    for (uint32_t q = ncell >> 1; q > 1; q >>= 1) {
      const uint32_t p = q - 1;
      for (int a = 0; a < 3; a++) {
        if (x[a] & q) {
          x[0] ^= p;
        } else {
          const uint32_t t = (x[0] ^ x[a]) & p;
          x[0] ^= t;
          x[a] ^= t;
        }
      }
    }
    // gray encode
    x[1] ^= x[0];
    x[2] ^= x[1];
    uint32_t t = 0;
    for (uint32_t q = ncell >> 1; q > 1; q >>= 1)
      if (x[2] & q) t ^= q - 1;
    for (int a = 0; a < 3; a++) x[a] ^= t;
    // interleave (axis 0 most significant)
    uint32_t key = 0;
    for (int b = bits - 1; b >= 0; b--)
      for (int a = 0; a < 3; a++) key = (key << 1) | ((x[a] >> b) & 1u);
    keys[i] = key;
  }
}

}  // extern "C"
