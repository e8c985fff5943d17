// Shared helpers for the native runtime: CRC32 (self-contained, no zlib
// dependency) and little-endian buffer IO.
//
// The port's counterpart of the reference's C++ runtime utilities
// (paddle/utils/, go/pserver checkpoint CRC — go/pserver/service.go:76).
#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace pt {

inline uint32_t crc32(const void* data, size_t n, uint32_t crc = 0) {
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
  const uint8_t* p = static_cast<const uint8_t*>(data);
  crc = ~crc;
  for (size_t i = 0; i < n; i++) crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// Little-endian append/read of PODs into a byte buffer.
template <typename T>
inline void put(std::string* buf, T v) {
  buf->append(reinterpret_cast<const char*>(&v), sizeof(T));
}

template <typename T>
inline bool get(const char** p, const char* end, T* v) {
  if (end - *p < static_cast<ptrdiff_t>(sizeof(T))) return false;
  std::memcpy(v, *p, sizeof(T));
  *p += sizeof(T);
  return true;
}

}  // namespace pt
