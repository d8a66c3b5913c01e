// Native data path of the PyTorch port: multithreaded WAV decode, silence
// trim and the ADPCM wire's row decode, on the host.
//
// A copy of the JAX package's `sstts/ops/native/wavio.cpp`, so that the port
// builds its own library: a dependency-free RIFF/WAVE decoder (PCM 8/16/24/32
// and IEEE float, multichannel downmix) with a std::thread batch front end,
// exposed through a plain C ABI for ctypes.  The numpy codec
// (sstts_torch/data/wav.py) is its fallback and its oracle.
//
// Build (sstts_torch/data/native_loader.py does it on first use):
//   g++ -O3 -shared -fPIC -std=c++17 -pthread wavio.cpp -o libsstts_torch_wavio.so

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <thread>
#include <vector>

namespace {

struct Chunk {
  uint32_t id;
  std::vector<char> body;
};

constexpr uint32_t fourcc(const char s[5]) {
  return (uint32_t)(uint8_t)s[0] | ((uint32_t)(uint8_t)s[1] << 8) |
         ((uint32_t)(uint8_t)s[2] << 16) | ((uint32_t)(uint8_t)s[3] << 24);
}

// Decode one WAV file into float32 mono.  Returns sample count, or a negative
// error code: -1 open, -2 not RIFF/WAVE, -3 missing chunks, -4 unsupported
// format, -5 output buffer too small.
int64_t decode_wav_impl(const char* path, float* out, int64_t max_len,
                        int32_t* sample_rate_out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  char hdr[12];
  if (!f.read(hdr, 12)) return -2;
  if (std::memcmp(hdr, "RIFF", 4) != 0 || std::memcmp(hdr + 8, "WAVE", 4) != 0)
    return -2;

  uint16_t fmt_code = 0, n_ch = 0, bits = 0;
  uint32_t sr = 0;
  std::vector<char> data;
  bool have_fmt = false, have_data = false;
  while (f) {
    char chdr[8];
    if (!f.read(chdr, 8)) break;
    uint32_t size;
    std::memcpy(&size, chdr + 4, 4);
    std::vector<char> body(size);
    if (size && !f.read(body.data(), size)) break;
    if (size & 1) f.seekg(1, std::ios::cur);  // chunk padding
    if (std::memcmp(chdr, "fmt ", 4) == 0 && size >= 16) {
      std::memcpy(&fmt_code, body.data(), 2);
      std::memcpy(&n_ch, body.data() + 2, 2);
      std::memcpy(&sr, body.data() + 4, 4);
      std::memcpy(&bits, body.data() + 14, 2);
      if (fmt_code == 0xFFFE && size >= 26)  // WAVE_FORMAT_EXTENSIBLE
        std::memcpy(&fmt_code, body.data() + 24, 2);
      have_fmt = true;
    } else if (std::memcmp(chdr, "data", 4) == 0) {
      data = std::move(body);
      have_data = true;
    }
  }
  if (!have_fmt || !have_data) return -3;
  if (n_ch == 0) return -4;
  *sample_rate_out = (int32_t)sr;

  int64_t n_raw;
  auto emit = [&](int64_t i, float v) { out[i] = v; };
  const char* p = data.data();
  if (fmt_code == 1 && bits == 16) {
    n_raw = (int64_t)data.size() / 2;
  } else if (fmt_code == 1 && bits == 32) {
    n_raw = (int64_t)data.size() / 4;
  } else if (fmt_code == 1 && bits == 24) {
    n_raw = (int64_t)data.size() / 3;
  } else if (fmt_code == 1 && bits == 8) {
    n_raw = (int64_t)data.size();
  } else if (fmt_code == 3 && bits == 32) {
    n_raw = (int64_t)data.size() / 4;
  } else {
    return -4;
  }
  int64_t n_frames = n_raw / n_ch;
  if (n_frames > max_len) return -5;

  const float inv_ch = 1.0f / (float)n_ch;
  for (int64_t t = 0; t < n_frames; ++t) {
    float acc = 0.0f;
    for (int c = 0; c < n_ch; ++c) {
      int64_t i = t * n_ch + c;
      float v;
      if (fmt_code == 1 && bits == 16) {
        int16_t s;
        std::memcpy(&s, p + 2 * i, 2);
        v = (float)s / 32768.0f;
      } else if (fmt_code == 1 && bits == 32) {
        int32_t s;
        std::memcpy(&s, p + 4 * i, 4);
        v = (float)((double)s / 2147483648.0);
      } else if (fmt_code == 1 && bits == 24) {
        const uint8_t* b = (const uint8_t*)p + 3 * i;
        int32_t s = (int32_t)b[0] | ((int32_t)b[1] << 8) | ((int32_t)b[2] << 16);
        if (s & 0x800000) s -= 0x1000000;
        v = (float)s / 8388608.0f;
      } else if (fmt_code == 1 && bits == 8) {
        v = ((float)(uint8_t)p[i] - 128.0f) / 128.0f;
      } else {  // float32
        std::memcpy(&v, p + 4 * i, 4);
      }
      acc += v;
    }
    emit(t, acc * inv_ch);
  }
  return n_frames;
}

// RMS-based silence trim matching sstts_torch.data.pipeline.trim_silence.
void trim_impl(const float* in, int64_t n, float top_db, int64_t frame,
               int64_t hop, int64_t* start_out, int64_t* end_out) {
  *start_out = 0;
  *end_out = n;
  if (n == 0) return;
  int64_t n_frames = n >= frame ? (n - frame) / hop + 1 : 1;
  std::vector<double> rms((size_t)n_frames);
  double peak = 1e-10;
  for (int64_t i = 0; i < n_frames; ++i) {
    double acc = 0.0;
    int64_t beg = i * hop;
    int64_t len = std::min(frame, n - beg);
    for (int64_t t = 0; t < len; ++t) acc += (double)in[beg + t] * in[beg + t];
    rms[(size_t)i] = std::sqrt(acc / (double)std::max<int64_t>(len, 1));
    peak = std::max(peak, rms[(size_t)i]);
  }
  int64_t first = -1, last = -1;
  for (int64_t i = 0; i < n_frames; ++i) {
    double db = 20.0 * std::log10(std::max(rms[(size_t)i], 1e-10) / peak);
    if (db > -top_db) {
      if (first < 0) first = i;
      last = i;
    }
  }
  if (first < 0) {
    *end_out = 0;
    return;
  }
  *start_out = first * hop;
  *end_out = std::min(n, last * hop + frame);
}

// IEEE binary16 -> binary32 (portable bit manipulation; the ADPCM wire
// carries per-block float16 scales written by jax bitcast on device).
float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal: renormalize into the f32 exponent range
      int e = 0;
      while (!(man & 0x400)) {
        man <<= 1;
        ++e;
      }
      man &= 0x3FF;
      bits = sign | ((uint32_t)(113 - e) << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (man << 13);
  } else {
    bits = sign | ((exp + 112) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

// Decode one ADPCM wire row (layout produced by sstts_torch.dsp.ops
// adpcm{4,3}_encode_wire: [packed codes][float16 scales][int16 seeds],
// 256-sample blocks).  Per block, y[0] = seed/32767 and
// y[i] = y[i-1] + (code_i - offset)*scale, accumulated sequentially in
// float32; numpy's cumsum may order the additions differently, so parity
// with the oracle is within float32 rounding (~1e-7, measured; the
// quantizer step is ~1e-2 of full scale, so this is far below wire noise).
void adpcm_decode_row(const uint8_t* row, int64_t nb, int32_t bits,
                      float* out) {
  const int64_t block = 256;
  const int64_t packed_per_block = block * bits / 8;  // 128/96/64 (4/3/2b)
  const uint8_t* packed = row;
  const uint8_t* scale_b = row + nb * packed_per_block;
  const uint8_t* seed_b = scale_b + nb * 2;
  // 4/3-bit are mid-tread (integer lattice, offset = -q_lo); 2-bit is
  // mid-rise: stored codes {0..3} reconstruct as (code - 1.5) * scale
  // (sstts_torch/dsp/ops.py adpcm2_encode_wire).
  const float offset = bits == 4 ? 8.0f : (bits == 3 ? 4.0f : 1.5f);
  for (int64_t b = 0; b < nb; ++b) {
    uint16_t sh = (uint16_t)scale_b[2 * b] | ((uint16_t)scale_b[2 * b + 1] << 8);
    float scale = half_to_float(sh);
    int16_t seed_i =
        (int16_t)((uint16_t)seed_b[2 * b] | ((uint16_t)seed_b[2 * b + 1] << 8));
    float acc = (float)seed_i / 32767.0f;
    float* o = out + b * block;
    o[0] = acc;  // code slot 0 is a dummy; sample 0 is the seed itself
    if (bits == 4) {
      const uint8_t* pb = packed + b * packed_per_block;
      for (int64_t i = 1; i < block; ++i) {
        uint8_t byte = pb[i >> 1];
        float c = (float)((i & 1) ? (byte >> 4) : (byte & 15));
        acc += (c - offset) * scale;
        o[i] = acc;
      }
    } else if (bits == 2) {  // 2-bit: 4 codes per byte, little-endian
      const uint8_t* pb = packed + b * packed_per_block;
      for (int64_t i = 1; i < block; ++i) {
        uint8_t byte = pb[i >> 2];
        float c = (float)((byte >> ((i & 3) * 2)) & 3);
        acc += (c - offset) * scale;
        o[i] = acc;
      }
    } else {  // 3-bit: 3 bytes -> 8 codes, little-endian packing
      const uint8_t* pb = packed + b * packed_per_block;
      for (int64_t g = 0; g < block / 8; ++g) {
        uint16_t b0 = pb[3 * g], b1 = pb[3 * g + 1], b2 = pb[3 * g + 2];
        uint8_t c[8] = {
            (uint8_t)(b0 & 7),
            (uint8_t)((b0 >> 3) & 7),
            (uint8_t)(((b0 >> 6) | (b1 << 2)) & 7),
            (uint8_t)((b1 >> 1) & 7),
            (uint8_t)((b1 >> 4) & 7),
            (uint8_t)(((b1 >> 7) | (b2 << 1)) & 7),
            (uint8_t)((b2 >> 2) & 7),
            (uint8_t)((b2 >> 5) & 7),
        };
        int64_t base = g * 8;
        for (int64_t k = base == 0 ? 1 : 0; k < 8; ++k) {
          acc += ((float)c[k] - offset) * scale;
          o[base + k] = acc;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int64_t sstts_decode_wav(const char* path, float* out, int64_t max_len,
                         int32_t* sample_rate_out) {
  return decode_wav_impl(path, out, max_len, sample_rate_out);
}

void sstts_trim_silence(const float* in, int64_t n, float top_db,
                        int64_t frame, int64_t hop, int64_t* start_out,
                        int64_t* end_out) {
  trim_impl(in, n, top_db, frame, hop, start_out, end_out);
}

// Decode a batch of WAVs in parallel.  `out` is (n, stride) row-major; writes
// lengths[i] (or negative error codes) and srs[i] per file.
void sstts_decode_batch(const char** paths, int32_t n, float* out,
                        int64_t stride, int64_t* lengths, int32_t* srs,
                        int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) break;
      lengths[i] =
          decode_wav_impl(paths[i], out + (int64_t)i * stride, stride, &srs[i]);
    }
  };
  std::vector<std::thread> pool;
  int32_t k = std::min<int32_t>(n_threads, n);
  pool.reserve((size_t)k);
  for (int32_t i = 0; i < k; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

// Decode a (bsz, row_bytes) ADPCM wire matrix into (bsz, nb*256) float32,
// threaded over rows.  `bits` is 4 or 3 (adpcm4/adpcm3); nb is derived from
// row_bytes.  The serving stream's hot host loop (Synthesizer._decode_wire)
// calls this instead of the numpy cumsum decoder (~5x on the 1-core bench
// host); the numpy implementation stays as oracle + fallback.
void sstts_adpcm_decode(const uint8_t* rows, int32_t bsz, int64_t row_bytes,
                        int32_t bits, float* out, int32_t n_threads) {
  const int64_t per_block = 256 * bits / 8 + 4;
  const int64_t nb = row_bytes / per_block;
  const int64_t out_stride = nb * 256;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= bsz) break;
      adpcm_decode_row(rows + (int64_t)i * row_bytes, nb, bits,
                       out + (int64_t)i * out_stride);
    }
  };
  std::vector<std::thread> pool;
  int32_t k = std::min<int32_t>(n_threads, bsz);
  pool.reserve((size_t)k);
  for (int32_t i = 0; i < k; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

}  // extern "C"
