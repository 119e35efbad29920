// Fast TFRecord scanner: parses TFRecord framing (8-byte little-endian
// length + masked crc32c(length) + payload + masked crc32c(payload)) and
// returns record offsets/lengths, optionally verifying CRCs.
//
// Native-runtime counterpart of the TensorFlow record-reading machinery the
// reference leans on for its RLDS pipeline (prismatic/vla/datasets/
// datasets.py:128-219 via tfds/dlimp).  Exposed to Python over ctypes
// (vla_rft_tpu_torch/data/tfrecord.py); the Python side mmaps the file and
// slices payloads from it.  A copy of the root csrc/tfrecord_reader.cc.
//
// Build: vla_rft_tpu_torch/ops/cuda_build.py at first use

#include <cstdint>
#include <cstring>
#include <cstdio>

namespace {

// crc32c (Castagnoli), software fallback table implementation.
uint32_t kCrcTable[256];
bool table_init = false;

void InitTable() {
  if (table_init) return;
  const uint32_t poly = 0x82f63b78u;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int j = 0; j < 8; j++) {
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    }
    kCrcTable[i] = crc;
  }
  table_init = true;
}

uint32_t Crc32c(const uint8_t* data, size_t n) {
  InitTable();
  uint32_t crc = 0xffffffffu;
  for (size_t i = 0; i < n; i++) {
    crc = (crc >> 8) ^ kCrcTable[(crc ^ data[i]) & 0xff];
  }
  return crc ^ 0xffffffffu;
}

// TFRecord "masked" crc.
uint32_t MaskedCrc(const uint8_t* data, size_t n) {
  uint32_t crc = Crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

}  // namespace

extern "C" {

// Scans the buffer; writes up to max_records (offset, length) pairs into
// out_offsets/out_lengths. Returns the number of records found, or -1 on a
// framing/CRC error. verify_crc != 0 enables payload CRC checks.
long tfrecord_scan(const uint8_t* buf, long size, long* out_offsets,
                   long* out_lengths, long max_records, int verify_crc) {
  long pos = 0;
  long n = 0;
  while (pos + 12 <= size && n < max_records) {
    uint64_t len;
    std::memcpy(&len, buf + pos, 8);
    uint32_t len_crc;
    std::memcpy(&len_crc, buf + pos + 8, 4);
    if (verify_crc && MaskedCrc(buf + pos, 8) != len_crc) return -1;
    long data_start = pos + 12;
    if (data_start + (long)len + 4 > size) return -1;  // truncated
    if (verify_crc) {
      uint32_t data_crc;
      std::memcpy(&data_crc, buf + data_start + len, 4);
      if (MaskedCrc(buf + data_start, len) != data_crc) return -1;
    }
    out_offsets[n] = data_start;
    out_lengths[n] = (long)len;
    n++;
    pos = data_start + (long)len + 4;
  }
  return n;
}

// Writes one TFRecord frame (for tests / dataset generation). Returns the
// number of bytes written into out (which must have room for len + 16).
long tfrecord_write(const uint8_t* data, long len, uint8_t* out) {
  uint64_t len64 = (uint64_t)len;
  std::memcpy(out, &len64, 8);
  uint32_t len_crc = MaskedCrc(out, 8);
  std::memcpy(out + 8, &len_crc, 4);
  std::memcpy(out + 12, data, len);
  uint32_t data_crc = MaskedCrc(data, len);
  std::memcpy(out + 12 + len, &data_crc, 4);
  return len + 16;
}

}  // extern "C"
