// perfetto_write: format and gzip the Trace Event export in one native pass
// (the JAX package's sofa_tpu/native/perfetto_write.cc, unchanged but for
// this comment).
//
// sofa_tpu_torch/export_perfetto.py reduces the kernel frame to one JSON
// prefix per (name, args) signature and flat ts/dur/pid/lane arrays; this
// tool takes exactly those columns in a flat binary file, prints each
// event, and deflates with zlib.  The other events (steps, host spans,
// counters, metadata) are few: Python serializes them and passes one blob.
// A kernel's ts and dur print as %.3f microseconds, as the Python path's
// do, so both writers' files decompress to the same bytes.
//
// Input (argv[1], little-endian):
//   u32 magic 'SFP1' (0x31504653)   u32 version=1   u32 gzip level
//   u32 n_prefix; n_prefix x { u32 len; bytes }   (UTF-8 JSON prefixes,
//        each ending with ...,'"args":{...},' -- this tool appends ts/dur/
//        pid/tid and the closing brace)
//   u64 n_events
//   f64 ts_us[n]   f64 dur_us[n]   u32 sig[n]   i32 pid[n]   u8 lane[n]
//   u64 other_len; bytes            (pre-serialized events, comma-joined)
//   u64 tail_len;  bytes            (everything after the events array)
// Output (argv[2]): the complete trace.json.gz.
//
// Exits nonzero on any malformed input; the caller then writes the file
// with its Python path.
//
// Build: g++ -O2 -o perfetto_write perfetto_write.cc -lz
// (sofa_tpu_torch/collectors/native_build.py does, into build/torch_native/).

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
  FILE* f;
  bool ok = true;

  void read(void* dst, size_t n) {
    if (ok && fread(dst, 1, n, f) != n) ok = false;
  }
  uint32_t u32() { uint32_t v = 0; read(&v, 4); return v; }
  uint64_t u64() { uint64_t v = 0; read(&v, 8); return v; }
  std::string str(uint64_t n) {
    std::string s(n, '\0');
    if (n) read(&s[0], n);
    return s;
  }
  template <typename T>
  std::vector<T> arr(uint64_t n) {
    std::vector<T> v(n);
    if (n) read(v.data(), n * sizeof(T));
    return v;
  }
};

constexpr uint32_t kMagic = 0x31504653;  // "SFP1"
// An event line is prefix + ~64 bytes of numbers; prefixes are bounded by
// the flush threshold check below rather than a hard cap here.
constexpr size_t kBuf = 4u << 20;

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: perfetto_write <input.bin> <out.json.gz>\n");
    return 2;
  }
  FILE* in = fopen(argv[1], "rb");
  if (!in) { perror("input"); return 2; }
  Reader r{in};

  if (r.u32() != kMagic || r.u32() != 1) {
    fprintf(stderr, "perfetto_write: bad magic/version\n");
    return 3;
  }
  uint32_t level = r.u32();
  if (level > 9) level = 9;

  uint32_t n_prefix = r.u32();
  if (!r.ok || n_prefix > (1u << 24)) return 3;
  std::vector<std::string> prefixes(n_prefix);
  for (uint32_t i = 0; i < n_prefix; ++i) {
    uint32_t len = r.u32();
    if (!r.ok || len > (64u << 20)) return 3;
    prefixes[i] = r.str(len);
  }

  uint64_t n = r.u64();
  if (!r.ok || n > (1ull << 33)) return 3;
  auto ts = r.arr<double>(n);
  auto dur = r.arr<double>(n);
  auto sig = r.arr<uint32_t>(n);
  auto pid = r.arr<int32_t>(n);
  auto lane = r.arr<uint8_t>(n);
  uint64_t other_len = r.u64();
  if (!r.ok || other_len > (1ull << 33)) return 3;
  std::string other = r.str(other_len);
  uint64_t tail_len = r.u64();
  if (!r.ok || tail_len > (1ull << 24)) return 3;
  std::string tail = r.str(tail_len);
  if (!r.ok) { fprintf(stderr, "perfetto_write: truncated input\n"); return 3; }
  fclose(in);

  char mode[8];
  snprintf(mode, sizeof mode, "wb%u", level);
  gzFile out = gzopen(argv[2], mode);
  if (!out) { perror("output"); return 2; }
  // Big internal gzip buffer: fewer deflate calls on a multi-100MB stream.
  gzbuffer(out, 1u << 20);

  std::string buf;
  buf.reserve(kBuf + (1u << 16));
  auto flush = [&]() -> bool {
    if (buf.empty()) return true;
    if (gzwrite(out, buf.data(), static_cast<unsigned>(buf.size())) !=
        static_cast<int>(buf.size())) {
      fprintf(stderr, "perfetto_write: gzwrite failed\n");
      return false;
    }
    buf.clear();
    return true;
  };

  buf += "{\"traceEvents\":[";
  char num[160];
  for (uint64_t i = 0; i < n; ++i) {
    if (sig[i] >= n_prefix) { gzclose(out); return 3; }
    if (i) buf += ',';
    buf += prefixes[sig[i]];
    // %.3f of microseconds = nanosecond resolution, Perfetto's native grain.
    int w = snprintf(num, sizeof num,
                     "\"ts\":%.3f,\"dur\":%.3f,\"pid\":%d,\"tid\":%u}",
                     ts[i], dur[i], pid[i], static_cast<unsigned>(lane[i]));
    if (w < 0 || w >= static_cast<int>(sizeof num)) {
      // Python clamps ts/dur to +-1e15 us; a wider value means corrupt
      // input — fail so the caller falls back rather than appending past
      // the formatted bytes.
      fprintf(stderr, "perfetto_write: unformattable ts/dur at %llu\n",
              static_cast<unsigned long long>(i));
      gzclose(out);
      return 3;
    }
    buf.append(num, static_cast<size_t>(w));
    if (buf.size() >= kBuf && !flush()) { gzclose(out); return 2; }
  }
  if (!other.empty()) {
    if (n) buf += ',';
    if (!flush()) { gzclose(out); return 2; }
    buf = std::move(other);
  }
  if (!flush()) { gzclose(out); return 2; }
  buf = tail;
  if (!flush()) { gzclose(out); return 2; }
  if (gzclose(out) != Z_OK) {
    fprintf(stderr, "perfetto_write: gzclose failed\n");
    return 2;
  }
  return 0;
}
