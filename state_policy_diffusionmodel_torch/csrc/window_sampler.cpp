// Host-side helpers of the port, built with g++ at first use and loaded
// through ctypes (state_policy_diffusionmodel_torch/data/native.py).
//
// 1. Batch assembly for the windowed dataset: a multithreaded strided
//    window gather over the in-RAM episode arrays and the per-window
//    position normalization (translate to the first frame, halve). The
//    reference feeds training through DataLoader worker processes
//    (utils/load_data.py:174); this is one pass over the arrays instead.
//    Results equal the numpy versions in data/dataset.py bit for bit:
//    uint8 frames are divided by 255 (a multiply by 1/255 differs by an
//    ulp on about half of the 256 values), and every float operation is
//    the one numpy performs, in the same order, in float32.
// 2. An LZ4 block decoder, for blosc chunks compressed with lz4 or lz4hc
//    (data/replay_buffer.py reads the JAX package's blosc zarr stores).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename Fn>
void parallel_for(int64_t n, int n_threads, Fn fn) {
  if (n_threads <= 0) n_threads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    int64_t b;
    while ((b = next.fetch_add(1)) < n) fn(b);
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads - 1);
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Gather B strided windows from a (T, feat) float32 array.
//   src:    (T, feat)
//   starts: (B,) window start rows
//   out:    (B, seq_len, feat)
// Each window takes rows start, start+step, ..., start+(seq_len-1)*step.
void gather_windows_f32(const float* src, int64_t feat,
                        const int64_t* starts, int64_t batch,
                        int64_t seq_len, int64_t step, float* out,
                        int n_threads) {
  parallel_for(batch, n_threads, [&](int64_t b) {
    const int64_t start = starts[b];
    float* dst = out + b * seq_len * feat;
    for (int64_t i = 0; i < seq_len; ++i) {
      std::memcpy(dst + i * feat, src + (start + i * step) * feat,
                  sizeof(float) * feat);
    }
  });
}

// The same gather for uint8 sources (raw image frames), each value
// converted to float32 and divided by 255 on the fly.
void gather_windows_u8_to_f32(const uint8_t* src, int64_t feat,
                              const int64_t* starts, int64_t batch,
                              int64_t seq_len, int64_t step, float* out,
                              int n_threads) {
  parallel_for(batch, n_threads, [&](int64_t b) {
    const int64_t start = starts[b];
    float* dst = out + b * seq_len * feat;
    for (int64_t i = 0; i < seq_len; ++i) {
      const uint8_t* row = src + (start + i * step) * feat;
      float* d = dst + i * feat;
      for (int64_t j = 0; j < feat; ++j) d[j] = float(row[j]) / 255.0f;
    }
  });
}

// Per-window position normalization (utils/load_data.py:85-89):
//   pos: (B, seq_len, 2) raw positions, normalized IN PLACE:
//     p' = (p - min) / range * 2 - 1; p'' = (p' - p'_0) / 2
//   translations: (B, 2) out, the removed first-frame vectors.
// range is (max - min) in float32, 1 where that is 0.
void normalize_positions_f32(float* pos, int64_t batch, int64_t seq_len,
                             float stat_min, float stat_max,
                             float* translations, int n_threads) {
  const float range = (stat_max - stat_min) == 0.f ? 1.f
                                                   : (stat_max - stat_min);
  parallel_for(batch, n_threads, [&](int64_t b) {
    float* w = pos + b * seq_len * 2;
    const float t0 = (w[0] - stat_min) / range * 2.f - 1.f;
    const float t1 = (w[1] - stat_min) / range * 2.f - 1.f;
    translations[2 * b] = t0;
    translations[2 * b + 1] = t1;
    for (int64_t i = 0; i < seq_len; ++i) {
      const float a = (w[2 * i] - stat_min) / range * 2.f - 1.f;
      const float c = (w[2 * i + 1] - stat_min) / range * 2.f - 1.f;
      w[2 * i] = (a - t0) / 2.f;
      w[2 * i + 1] = (c - t1) / 2.f;
    }
  });
}

// Decode one LZ4 block (the raw block format, no frame header) of
// src_size bytes into dst, which holds dst_cap bytes. Returns the number
// of bytes written, or -1 if the block is malformed or does not fit.
int64_t lz4_decompress_block(const uint8_t* src, int64_t src_size,
                             uint8_t* dst, int64_t dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_size;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;
  while (ip < iend) {
    const unsigned token = *ip++;
    // literals: the high nibble, extended by 255-valued bytes
    uint64_t lit = token >> 4;
    if (lit == 15) {
      unsigned b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (uint64_t(iend - ip) < lit || uint64_t(oend - op) < lit) return -1;
    std::memcpy(op, ip, lit);
    op += lit;
    ip += lit;
    if (ip == iend) break;  // the last sequence holds literals only
    // the match: a 2-byte little-endian offset, then the low nibble + 4,
    // extended likewise
    if (iend - ip < 2) return -1;
    const uint64_t offset = uint64_t(ip[0]) | (uint64_t(ip[1]) << 8);
    ip += 2;
    if (offset == 0 || offset > uint64_t(op - dst)) return -1;
    uint64_t len = token & 15;
    if (len == 15) {
      unsigned b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        len += b;
      } while (b == 255);
    }
    len += 4;
    if (uint64_t(oend - op) < len) return -1;
    // byte by byte: a match may overlap the bytes it produces
    const uint8_t* match = op - offset;
    for (uint64_t i = 0; i < len; ++i) op[i] = match[i];
    op += len;
  }
  return int64_t(op - dst);
}

}  // extern "C"
