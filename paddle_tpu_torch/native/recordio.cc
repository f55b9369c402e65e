// ported from paddle_tpu/native/recordio.cc
// RecordIO: chunked, CRC-checked record file format + scanner.
//
// Native C++ reimplementation of the reference's recordio library
// (reference: recordio/{header,chunk,scanner,writer}.{h,cc} — Chunk
// chunk.h:27, Scanner scanner.h:26), exposed through a C ABI consumed by
// ctypes (paddle_tpu_torch/recordio.py). Data-plane work (framing, CRC32,
// buffering) stays native; Python only moves pointers.
//
// On-disk layout per chunk:
//   u32 magic  'PTRC'
//   u32 num_records
//   u64 payload_len
//   u32 crc32(payload)
//   u32 record_len[num_records]
//   u8  payload[payload_len]   (records back to back)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x50545243;  // 'PTRC'
constexpr size_t kDefaultChunkRecords = 1024;
constexpr size_t kDefaultChunkBytes = 1 << 20;

// CRC-32 (IEEE 802.3), table-driven.
class Crc32 {
 public:
  Crc32() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table_[i] = c;
    }
  }
  uint32_t operator()(const uint8_t* data, size_t len) const {
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < len; ++i) c = table_[(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
  }

 private:
  uint32_t table_[256];
};

const Crc32& crc32() {
  static Crc32 c;
  return c;
}

struct Writer {
  FILE* f = nullptr;
  std::vector<uint32_t> lens;
  std::string payload;
  size_t max_records = kDefaultChunkRecords;
  size_t max_bytes = kDefaultChunkBytes;

  bool flush() {
    if (lens.empty()) return true;
    uint32_t n = static_cast<uint32_t>(lens.size());
    uint64_t plen = payload.size();
    uint32_t crc = crc32()(reinterpret_cast<const uint8_t*>(payload.data()),
                           payload.size());
    if (fwrite(&kMagic, 4, 1, f) != 1) return false;
    if (fwrite(&n, 4, 1, f) != 1) return false;
    if (fwrite(&plen, 8, 1, f) != 1) return false;
    if (fwrite(&crc, 4, 1, f) != 1) return false;
    if (n && fwrite(lens.data(), 4, n, f) != n) return false;
    if (plen && fwrite(payload.data(), 1, plen, f) != plen) return false;
    lens.clear();
    payload.clear();
    return true;
  }
};

struct Scanner {
  FILE* f = nullptr;
  std::vector<uint32_t> lens;
  std::string payload;
  size_t rec_idx = 0;
  size_t offset = 0;
  bool corrupt = false;

  // Hard caps so a corrupt/malicious header can't drive unbounded
  // allocations: 16M records / 1 GiB payload per chunk (writer emits far
  // smaller chunks; see kDefaultChunk*).
  static constexpr uint32_t kMaxRecordsPerChunk = 1u << 24;
  static constexpr uint64_t kMaxPayloadPerChunk = 1ull << 30;

  bool load_chunk() {
    uint32_t magic = 0, n = 0, crc = 0;
    uint64_t plen = 0;
    if (fread(&magic, 4, 1, f) != 1) return false;  // clean EOF
    if (magic != kMagic) {
      corrupt = true;
      return false;
    }
    if (fread(&n, 4, 1, f) != 1 || fread(&plen, 8, 1, f) != 1 ||
        fread(&crc, 4, 1, f) != 1) {
      corrupt = true;
      return false;
    }
    if (n > kMaxRecordsPerChunk || plen > kMaxPayloadPerChunk) {
      corrupt = true;
      return false;
    }
    lens.resize(n);
    if (n && fread(lens.data(), 4, n, f) != n) {
      lens.clear();
      corrupt = true;
      return false;
    }
    // The CRC covers the payload only; the record_len table must be
    // independently consistent or a tampered table would let the scanner
    // read past payload.data() (heap over-read).
    uint64_t total = 0;
    for (uint32_t l : lens) total += l;
    if (total != plen) {
      lens.clear();
      corrupt = true;
      return false;
    }
    payload.resize(plen);
    if (plen && fread(&payload[0], 1, plen, f) != plen) {
      corrupt = true;
      return false;
    }
    uint32_t got = crc32()(reinterpret_cast<const uint8_t*>(payload.data()),
                           payload.size());
    if (got != crc) {
      corrupt = true;
      return false;
    }
    rec_idx = 0;
    offset = 0;
    return true;
  }
};

}  // namespace

extern "C" {

void* ptrio_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  return w;
}

int ptrio_writer_write(void* handle, const char* data, uint64_t len) {
  auto* w = static_cast<Writer*>(handle);
  w->lens.push_back(static_cast<uint32_t>(len));
  w->payload.append(data, len);
  if (w->lens.size() >= w->max_records || w->payload.size() >= w->max_bytes) {
    return w->flush() ? 0 : -1;
  }
  return 0;
}

int ptrio_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  bool ok = w->flush();
  fclose(w->f);
  delete w;
  return ok ? 0 : -1;
}

void* ptrio_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* s = new Scanner();
  s->f = f;
  return s;
}

// Returns pointer to the next record (valid until the next call), sets *len.
// NULL at EOF; NULL with *len == UINT64_MAX on corruption.
const char* ptrio_scanner_next(void* handle, uint64_t* len) {
  auto* s = static_cast<Scanner*>(handle);
  if (s->corrupt) {  // terminal: never serve records after a corrupt chunk
    *len = ~0ull;
    return nullptr;
  }
  if (s->rec_idx >= s->lens.size()) {
    if (!s->load_chunk()) {
      *len = s->corrupt ? ~0ull : 0ull;
      return nullptr;
    }
  }
  uint32_t l = s->lens[s->rec_idx];
  const char* p = s->payload.data() + s->offset;
  s->offset += l;
  s->rec_idx += 1;
  *len = l;
  return p;
}

void ptrio_scanner_close(void* handle) {
  auto* s = static_cast<Scanner*>(handle);
  fclose(s->f);
  delete s;
}

}  // extern "C"
