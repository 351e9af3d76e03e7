// Native EXR scanline-block codec core for image_lens_reproject_tpu.
//
// The framework's host-side data loader: the per-block hot path of
// OpenEXR scanline decode/encode (zlib inflate/deflate, the EXR ZIP
// predictor + two-half interleave transform, HALF<->FLOAT conversion,
// planar->interleaved pixel layout), parallelized across blocks with a
// std::thread pool. Fills the role the reference delegates to the OpenEXR
// C++ library (reference: src/image_formats.cpp:208-345) — but built for
// feeding batched device transfers: output is one interleaved float32
// (H, W, C) buffer ready for jax.device_put.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (image_lens_reproject_tpu/utils/native.py). No Python.h dependency.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// --- half <-> float (scalar, table-free; correct for all values incl.
// denormals, inf, nan) ---

inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;  // +-0
    } else {
      // subnormal: normalize
      int e = -1;
      uint32_t m = man;
      do {
        ++e;
        m <<= 1;
      } while ((m & 0x400u) == 0);
      bits = sign | ((uint32_t)(127 - 15 - e) << 23) | ((m & 0x3FFu) << 13);
    }
  } else if (exp == 0x1F) {
    bits = sign | 0x7F800000u | (man << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

inline uint16_t float_to_half(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t sign = (bits >> 16) & 0x8000u;
  int32_t exp = (int32_t)((bits >> 23) & 0xFF) - 127 + 15;
  uint32_t man = bits & 0x7FFFFFu;
  if (((bits >> 23) & 0xFF) == 0xFF) {  // inf/nan
    return (uint16_t)(sign | 0x7C00u | (man ? 0x200u | (man >> 13) : 0));
  }
  if (exp >= 0x1F) return (uint16_t)(sign | 0x7C00u);  // overflow -> inf
  if (exp <= 0) {
    if (exp < -10) return (uint16_t)sign;  // underflow -> 0
    // subnormal half; round to nearest even
    man |= 0x800000u;
    uint32_t shift = (uint32_t)(14 - exp);
    uint32_t half_man = man >> shift;
    uint32_t rem = man & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half_man & 1))) half_man++;
    return (uint16_t)(sign | half_man);
  }
  // round to nearest even on the 13 dropped bits
  uint32_t half_man = man >> 13;
  uint32_t rem = man & 0x1FFFu;
  uint16_t out = (uint16_t)(sign | ((uint32_t)exp << 10) | half_man);
  if (rem > 0x1000u || (rem == 0x1000u && (out & 1))) out++;
  return out;
}

// --- EXR ZIP transform (matches OpenEXR ImfZip semantics) ---

// Undo: delta predictor then de-interleave (first half -> even positions).
void zip_reconstruct(uint8_t* data, size_t n, uint8_t* scratch) {
  // predictor undo: s[i] = s[i-1] + d[i] - 128 (mod 256)
  uint8_t prev = data[0];
  for (size_t i = 1; i < n; ++i) {
    prev = (uint8_t)(prev + data[i] - 128);
    data[i] = prev;
  }
  size_t half = (n + 1) / 2;
  const uint8_t* t1 = data;
  const uint8_t* t2 = data + half;
  uint8_t* out = scratch;
  size_t i1 = 0, i2 = 0;
  for (size_t i = 0; i < n; ++i) {
    out[i] = (i & 1) ? t2[i2++] : t1[i1++];
  }
  std::memcpy(data, scratch, n);
}

// Forward: interleave split then predictor (for the encoder).
void zip_split_predict(const uint8_t* src, size_t n, uint8_t* dst) {
  size_t half = (n + 1) / 2;
  size_t i1 = 0, i2 = 0;
  for (size_t i = 0; i < n; ++i) {
    if (i & 1)
      dst[half + i2++] = src[i];
    else
      dst[i1++] = src[i];
  }
  uint8_t prev = dst[0];
  for (size_t i = 1; i < n; ++i) {
    uint8_t cur = dst[i];
    dst[i] = (uint8_t)(cur - prev + 128);
    prev = cur;
  }
}

struct ChannelDesc {
  int pixel_type;  // 0=UINT, 1=HALF, 2=FLOAT
  int dst_slot;    // output channel slot (may collide; last writer wins)
};

int decode_one_block(const uint8_t* file_data, uint64_t block_off,
                     size_t file_size, int compression, int lines_per_block,
                     int width, int height, int ymin, int n_channels,
                     const ChannelDesc* chans, int out_channels, float* out) {
  if (block_off + 8 > file_size) return -2;
  int32_t y;
  uint32_t size;
  std::memcpy(&y, file_data + block_off, 4);
  std::memcpy(&size, file_data + block_off + 4, 4);
  if (block_off + 8 + size > file_size) return -2;
  // The per-block scanline header is untrusted input: a corrupt/malicious
  // offset table or block header must not drive out-of-bounds writes.
  if (y < ymin || y >= ymin + height) return -2;
  const uint8_t* payload = file_data + block_off + 8;

  int block_lines = std::min(lines_per_block, ymin + height - y);
  if (block_lines <= 0) return -2;
  size_t bytes_per_line = 0;
  for (int c = 0; c < n_channels; ++c) {
    bytes_per_line += (chans[c].pixel_type == 1 ? 2 : 4) * (size_t)width;
  }
  size_t raw_size = bytes_per_line * (size_t)block_lines;

  std::vector<uint8_t> raw(raw_size);
  if (compression == 0 || size == raw_size) {
    if ((size_t)size < raw_size) return -2;  // short payload: don't overread
    std::memcpy(raw.data(), payload, raw_size);
  } else {
    uLongf dlen = (uLongf)raw_size;
    if (uncompress(raw.data(), &dlen, payload, size) != Z_OK ||
        dlen != raw_size) {
      return -3;
    }
    std::vector<uint8_t> scratch(raw_size);
    zip_reconstruct(raw.data(), raw_size, scratch.data());
  }

  // Per scanline, per channel (file order), width values.
  const uint8_t* pos = raw.data();
  for (int ln = 0; ln < block_lines; ++ln) {
    int row = y - ymin + ln;
    for (int c = 0; c < n_channels; ++c) {
      int slot = chans[c].dst_slot;
      float* dst_row = out + ((size_t)row * width) * out_channels + slot;
      if (chans[c].pixel_type == 1) {
        const uint16_t* src = (const uint16_t*)pos;
        for (int x = 0; x < width; ++x) {
          dst_row[(size_t)x * out_channels] = half_to_float(src[x]);
        }
        pos += 2 * (size_t)width;
      } else {
        const float* src = (const float*)pos;
        for (int x = 0; x < width; ++x) {
          dst_row[(size_t)x * out_channels] = src[x];
        }
        pos += 4 * (size_t)width;
      }
    }
  }
  return 0;
}

void parallel_for(int n, int n_threads, const std::function<void(int)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> threads;
  int workers = std::min(n_threads, n);
  threads.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    threads.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Decode all scanline blocks of a parsed EXR into an interleaved float32
// (height, width, out_channels) buffer. Returns 0 on success.
int ilr_exr_decode(const uint8_t* file_data, uint64_t file_size,
                   const uint64_t* block_offsets, int n_blocks,
                   int compression, int lines_per_block, int width, int height,
                   int ymin, int n_channels, const int* pixel_types,
                   const int* dst_slots, int out_channels, float* out,
                   int n_threads) {
  std::vector<ChannelDesc> chans(n_channels);
  for (int c = 0; c < n_channels; ++c) {
    if (pixel_types[c] == 0) return -4;  // UINT channels unsupported
    chans[c] = ChannelDesc{pixel_types[c], dst_slots[c]};
  }
  std::atomic<int> status{0};
  parallel_for(n_blocks, n_threads, [&](int b) {
    int rc = decode_one_block(file_data, block_offsets[b], file_size,
                              compression, lines_per_block, width, height,
                              ymin, n_channels, chans.data(), out_channels,
                              out);
    if (rc != 0) status.store(rc);
  });
  return status.load();
}

// Encode (height, width, channels) interleaved float32 into EXR ZIP blocks:
// for block b, writes [deflate(predict(split(half-planarized block)))] and
// stores its compressed size in block_sizes[b]. The caller assembles the
// file. sort_order maps sorted-channel position -> source channel index.
// Each block output area must hold raw_size + 64 bytes.
int ilr_exr_encode_blocks(const float* img, int width, int height,
                          int channels, const int* sort_order,
                          int lines_per_block, int level, uint8_t* out_blocks,
                          uint64_t out_stride, uint64_t* block_sizes,
                          int n_threads) {
  int n_blocks = (height + lines_per_block - 1) / lines_per_block;
  std::atomic<int> status{0};
  parallel_for(n_blocks, n_threads, [&](int b) {
    int y0 = b * lines_per_block;
    int y1 = std::min(y0 + lines_per_block, height);
    int lines = y1 - y0;
    size_t raw_size = (size_t)lines * channels * width * 2;
    std::vector<uint8_t> raw(raw_size);
    uint16_t* dst = (uint16_t*)raw.data();
    for (int ln = 0; ln < lines; ++ln) {
      for (int c = 0; c < channels; ++c) {
        int src_c = sort_order[c];
        const float* src_row =
            img + ((size_t)(y0 + ln) * width) * channels + src_c;
        for (int x = 0; x < width; ++x) {
          *dst++ = float_to_half(src_row[(size_t)x * channels]);
        }
      }
    }
    std::vector<uint8_t> transformed(raw_size);
    zip_split_predict(raw.data(), raw_size, transformed.data());
    uLongf clen = (uLongf)(raw_size + 64);
    uint8_t* out = out_blocks + (uint64_t)b * out_stride;
    if (compress2(out, &clen, transformed.data(), raw_size, level) != Z_OK) {
      status.store(-3);
      return;
    }
    if (clen >= raw_size) {  // incompressible: store raw (EXR convention)
      std::memcpy(out, raw.data(), raw_size);
      clen = (uLongf)raw_size;
    }
    block_sizes[b] = (uint64_t)clen;
  });
  return status.load();
}

// Gamma-2.2 decode: uint8 RGBA (or RGB) -> linear float32 RGB, LUT-based
// (reference src/image_formats.cpp:195-197 math).
void ilr_gamma_decode(const uint8_t* src, int n_pixels, int src_stride,
                      float* dst, const float* lut256, int n_threads) {
  parallel_for(n_threads, n_threads, [&](int t) {
    int64_t per = ((int64_t)n_pixels + n_threads - 1) / n_threads;
    int64_t lo = (int64_t)t * per;
    int64_t hi = std::min<int64_t>(n_pixels, lo + per);
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* p = src + i * src_stride;
      float* d = dst + i * 3;
      d[0] = lut256[p[0]];
      d[1] = lut256[p[1]];
      d[2] = lut256[p[2]];
    }
  });
}

// Gamma-2.2 encode: float32 (n,C) -> uint8 RGBA with clamp, ^(1/2.2) via
// 4096-entry LUT on clamped linear value, uint8(255.9*s) truncation
// (reference src/image_formats.cpp:150-163). Exactness note: the Python
// path computes pow per pixel; this LUT path is for throughput and is
// used only when bit-parity is not required.
void ilr_gamma_encode_rgba(const float* src, int n_pixels, int channels,
                           uint8_t* dst, int n_threads) {
  int cw = channels < 4 ? channels : 4;
  parallel_for(n_threads, n_threads, [&](int t) {
    int64_t per = ((int64_t)n_pixels + n_threads - 1) / n_threads;
    int64_t lo = (int64_t)t * per;
    int64_t hi = std::min<int64_t>(n_pixels, lo + per);
    for (int64_t i = lo; i < hi; ++i) {
      const float* p = src + i * channels;
      uint8_t* d = dst + i * 4;
      for (int c = 0; c < cw; ++c) {
        float s = p[c];
        s = s < 0.0f ? 0.0f : (s > 1.0f ? 1.0f : s);
        s = __builtin_powf(s, 1.0f / 2.2f);
        d[c] = (uint8_t)(255.9f * s);
      }
      if (channels != 4) d[3] = 255;
    }
  });
}

int ilr_version(void) { return 1; }
}
