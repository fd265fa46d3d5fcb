// fastlog: a binary event-log writer for the observability layer
// (observability/fastlog.py drives it through ctypes).
//
// A batched rollout logs 10^5-10^6 records; written one JSON line at a
// time, that is host time spent after the device work is done.  This
// writer frames the records in a flat little-endian format behind a 1 MiB
// stdio buffer, and its bulk "rows" entry point logs a whole (T, d)
// channel in one call.
//
// Format (all little-endian):
//   header:  8 bytes magic "FLOG0001"
//   tagdef:  u8 kind=1, u16 tag_id, u16 name_len, name bytes (utf-8)
//   record:  u8 kind=2, u16 tag_id, i64 step, u32 n, n * f32 payload
//
// observability/fastlog.py's Python writer emits the same bytes, so a
// reader never cares which wrote the file.
//
// Build: g++ -O2 -shared -fPIC -o libfastlog.so fastlog.cpp
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct FastLog {
  FILE* f = nullptr;
  std::vector<char> buf;
};

constexpr char kMagic[8] = {'F', 'L', 'O', 'G', '0', '0', '0', '1'};
constexpr uint8_t kTagDef = 1;
constexpr uint8_t kRecord = 2;

inline void put_u16(std::string& out, uint16_t v) {
  out.push_back(static_cast<char>(v & 0xff));
  out.push_back(static_cast<char>((v >> 8) & 0xff));
}

inline void put_u32(std::string& out, uint32_t v) {
  for (int i = 0; i < 4; ++i) out.push_back(static_cast<char>((v >> (8 * i)) & 0xff));
}

inline void put_i64(std::string& out, int64_t sv) {
  uint64_t v = static_cast<uint64_t>(sv);
  for (int i = 0; i < 8; ++i) out.push_back(static_cast<char>((v >> (8 * i)) & 0xff));
}

}  // namespace

extern "C" {

void* fl_open(const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  auto* h = new FastLog;
  h->f = f;
  h->buf.resize(1 << 20);
  std::setvbuf(f, h->buf.data(), _IOFBF, h->buf.size());
  std::fwrite(kMagic, 1, sizeof(kMagic), f);
  return h;
}

// Register a tag name under an id chosen by the caller (the Python side
// interns names -> dense ids).  Safe to call once per (id, name).
int fl_tag(void* handle, uint16_t tag_id, const char* name) {
  auto* h = static_cast<FastLog*>(handle);
  if (!h || !h->f) return -1;
  size_t len = std::strlen(name);
  if (len > 0xffff) return -1;
  std::string rec;
  rec.reserve(5 + len);
  rec.push_back(static_cast<char>(kTagDef));
  put_u16(rec, tag_id);
  put_u16(rec, static_cast<uint16_t>(len));
  rec.append(name, len);
  return std::fwrite(rec.data(), 1, rec.size(), h->f) == rec.size() ? 0 : -1;
}

int fl_write(void* handle, uint16_t tag_id, int64_t step,
             const float* data, uint32_t n) {
  auto* h = static_cast<FastLog*>(handle);
  if (!h || !h->f) return -1;
  std::string head;
  head.reserve(15);
  head.push_back(static_cast<char>(kRecord));
  put_u16(head, tag_id);
  put_i64(head, step);
  put_u32(head, n);
  if (std::fwrite(head.data(), 1, head.size(), h->f) != head.size()) return -1;
  if (n && std::fwrite(data, sizeof(float), n, h->f) != n) return -1;
  return 0;
}

// Bulk path: `rows` records of `cols` floats each, steps step0, step0 +
// stride, ...  One call logs an entire (T, d) rollout channel.
int fl_write_rows(void* handle, uint16_t tag_id, int64_t step0,
                  int64_t stride, const float* data, int64_t rows,
                  uint32_t cols) {
  auto* h = static_cast<FastLog*>(handle);
  if (!h || !h->f) return -1;
  for (int64_t r = 0; r < rows; ++r) {
    if (fl_write(handle, tag_id, step0 + r * stride,
                 data + r * static_cast<int64_t>(cols), cols) != 0)
      return -1;
  }
  return 0;
}

int fl_flush(void* handle) {
  auto* h = static_cast<FastLog*>(handle);
  if (!h || !h->f) return -1;
  return std::fflush(h->f);
}

void fl_close(void* handle) {
  auto* h = static_cast<FastLog*>(handle);
  if (!h) return;
  if (h->f) std::fclose(h->f);
  delete h;
}

}  // extern "C"
