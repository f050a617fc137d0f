// colttio — native IO hot loops for the coltt_tpu runtime.
//
// Reference parity: the reference keeps its persistence layer in Go
// (pkg/wal segment.go chunk framing, diskv record replay) with its native
// code reserved for SIMD distance kernels (pkg/distance/simd). In this
// build the distance kernels live on the device (JAX/XLA), and the native
// budget goes where the host actually burns cycles: WAL chunk
// framing/replay and CRC, which are per-byte loops Python executes ~100x
// slower than C++ (and the deployment hosts here are heavily throttled).
//
// Format (bit-compatible with coltt_tpu/storage/wal.py and the reference
// pkg/wal/segment.go:47-60): 32 KiB blocks; 7-byte big-endian chunk header
// crc32(frag) u32 | frag_len u16 | chunk_type u8; types FULL/FIRST/MIDDLE/
// LAST for payloads spanning blocks; block tails shorter than a header are
// zero-padded.
//
// C ABI only — consumed via ctypes from coltt_tpu/native.py.

#include <cstdint>
#include <cstring>

#include <zlib.h>  // hardware-accelerated crc32 (same IEEE poly as Go)

namespace {

constexpr int64_t kBlockSize = 32 * 1024;
constexpr int64_t kHeaderSize = 7;

constexpr uint8_t kChunkFull = 0;
constexpr uint8_t kChunkFirst = 1;
constexpr uint8_t kChunkMiddle = 2;
constexpr uint8_t kChunkLast = 3;

inline uint32_t crc32ieee(const uint8_t* p, int64_t n) {
  return uint32_t(::crc32(0L, p, uInt(n)));
}

inline void put_header(uint8_t* dst, uint32_t crc, uint16_t len, uint8_t type) {
  dst[0] = uint8_t(crc >> 24);
  dst[1] = uint8_t(crc >> 16);
  dst[2] = uint8_t(crc >> 8);
  dst[3] = uint8_t(crc);
  dst[4] = uint8_t(len >> 8);
  dst[5] = uint8_t(len);
  dst[6] = type;
}

inline void get_header(const uint8_t* src, uint32_t* crc, uint16_t* len,
                       uint8_t* type) {
  *crc = (uint32_t(src[0]) << 24) | (uint32_t(src[1]) << 16) |
         (uint32_t(src[2]) << 8) | uint32_t(src[3]);
  *len = uint16_t((uint16_t(src[4]) << 8) | uint16_t(src[5]));
  *type = src[6];
}

}  // namespace

extern "C" {

uint32_t cio_crc32(const uint8_t* p, int64_t n) { return crc32ieee(p, n); }

// Frame one payload starting at absolute segment offset `off` into `out`.
// Returns bytes written (including any leading block padding), or -1 if
// out_cap is too small. Mirrors WAL.write_batch's emit() framing loop.
int64_t cio_wal_frame(const uint8_t* payload, int64_t n, int64_t off,
                      uint8_t* out, int64_t out_cap) {
  int64_t w = 0;  // bytes written to out
  int64_t remaining = n;
  const uint8_t* src = payload;
  bool first = true;
  for (;;) {
    int64_t cur = (off + w) % kBlockSize;
    int64_t room = kBlockSize - cur;
    if (room < kHeaderSize) {
      if (w + room > out_cap) return -1;
      std::memset(out + w, 0, size_t(room));
      w += room;
      continue;
    }
    int64_t space = room - kHeaderSize;
    int64_t frag = remaining < space ? remaining : space;
    uint8_t type;
    if (first && frag == remaining) type = kChunkFull;
    else if (first) type = kChunkFirst;
    else if (frag < remaining) type = kChunkMiddle;
    else type = kChunkLast;
    if (w + kHeaderSize + frag > out_cap) return -1;
    put_header(out + w, crc32ieee(src, frag), uint16_t(frag), type);
    std::memcpy(out + w + kHeaderSize, src, size_t(frag));
    w += kHeaderSize + frag;
    src += frag;
    remaining -= frag;
    first = false;
    if (remaining == 0) break;
  }
  return w;
}

// Frame `count` payloads (concatenated in `payloads`, lengths in `lens`)
// starting at absolute segment offset `off`. Writes per-payload
// (start_block, start_off, total_size) into pos_out (3 int64 each).
// Returns total bytes written to out, or -1 if out_cap is too small.
int64_t cio_wal_frame_batch(const uint8_t* payloads, const int64_t* lens,
                            int64_t count, int64_t off, uint8_t* out,
                            int64_t out_cap, int64_t* pos_out) {
  int64_t w = 0;
  const uint8_t* src = payloads;
  for (int64_t p = 0; p < count; p++) {
    int64_t start = off + w;
    int64_t written =
        cio_wal_frame(src, lens[p], start, out + w, out_cap - w);
    if (written < 0) return -1;
    pos_out[p * 3 + 0] = start / kBlockSize;
    pos_out[p * 3 + 1] = start % kBlockSize;
    pos_out[p * 3 + 2] = written;
    w += written;
    src += lens[p];
  }
  return w;
}

// Decode one record read at absolute segment offset `abs_off` (raw starts
// at the record's first header). Returns payload length written to out, or
// -1 on CRC mismatch / truncation, -2 if out_cap too small.
int64_t cio_wal_decode(const uint8_t* raw, int64_t n, int64_t abs_off,
                       uint8_t* out, int64_t out_cap) {
  int64_t i = 0, w = 0;
  while (i < n) {
    int64_t cur = (abs_off + i) % kBlockSize;
    int64_t room = kBlockSize - cur;
    if (room < kHeaderSize) {
      i += room;  // block padding
      continue;
    }
    if (i + kHeaderSize > n) return -1;
    uint32_t crc;
    uint16_t len;
    uint8_t type;
    get_header(raw + i, &crc, &len, &type);
    if (i + kHeaderSize + len > n) return -1;
    const uint8_t* frag = raw + i + kHeaderSize;
    if (crc32ieee(frag, len) != crc) return -1;
    if (w + len > out_cap) return -2;
    std::memcpy(out + w, frag, len);
    w += len;
    i += kHeaderSize + len;
    if (type == kChunkFull || type == kChunkLast) return w;
  }
  return -1;
}

// Replay a whole segment: reassemble every payload into out_arena and
// record (payload_off, payload_len, block_number, chunk_offset, chunk_size)
// per record into recs (5 int64 per record). Stops cleanly at a torn tail
// or zero padding, exactly like WAL.read_all. Returns the record count,
// -1 if the arena is too small, -2 if recs_cap is too small.
int64_t cio_wal_scan(const uint8_t* seg, int64_t n, uint8_t* out_arena,
                     int64_t arena_cap, int64_t* recs, int64_t recs_cap,
                     int64_t* arena_used) {
  int64_t i = 0;
  int64_t count = 0;
  int64_t w = 0;           // arena write offset
  int64_t rec_start_w = 0; // arena offset where current record began
  int64_t start_block = -1, start_off = -1;
  bool in_record = false;

  while (i + kHeaderSize <= n) {
    int64_t cur = i % kBlockSize;
    int64_t room = kBlockSize - cur;
    if (room < kHeaderSize) {
      i += room;
      continue;
    }
    uint32_t crc;
    uint16_t len;
    uint8_t type;
    get_header(seg + i, &crc, &len, &type);
    if (crc == 0 && len == 0 && type == 0) {
      i += room;  // zero padding / preallocated tail
      continue;
    }
    if (i + kHeaderSize + len > n) break;  // torn tail
    const uint8_t* frag = seg + i + kHeaderSize;
    if (crc32ieee(frag, len) != crc) break;  // torn/corrupt tail
    if (type == kChunkFull || type == kChunkFirst) {
      rec_start_w = w;
      start_block = i / kBlockSize;
      start_off = i % kBlockSize;
      in_record = true;
    }
    if (w + len > arena_cap) return -1;
    std::memcpy(out_arena + w, frag, len);
    w += len;
    i += kHeaderSize + len;
    if ((type == kChunkFull || type == kChunkLast) && in_record) {
      if (count >= recs_cap) return -2;
      int64_t* r = recs + count * 5;
      r[0] = rec_start_w;
      r[1] = w - rec_start_w;
      r[2] = start_block;
      r[3] = start_off;
      r[4] = i - (start_block * kBlockSize + start_off);
      count++;
      in_record = false;
    }
  }
  if (!in_record && count >= 0) {
    *arena_used = w;
  } else {
    // unterminated record at tail: drop its partial bytes
    *arena_used = rec_start_w;
  }
  return count;
}

}  // extern "C"
