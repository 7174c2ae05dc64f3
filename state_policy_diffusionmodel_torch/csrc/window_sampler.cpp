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
// 3. A zstd frame decoder, for blosc chunks compressed with zstd, and
//    blosc's bitshuffle undone (an 8x8 bit transpose a group of 8
//    elements).

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#include "host_common.h"

using host::parallel_for;

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

// ---------------------------------------------------------------------------
// 3. A zstd frame decoder (RFC 8878), for blosc chunks compressed with zstd
//    (the JAX package's default stores: blosc zstd-5 with bitshuffle). It
//    reads zstd and skippable frames, one after another: the frame header
//    (a dictionary id other than 0 is refused), raw, RLE and compressed
//    blocks, literals raw, RLE, Huffman-coded in 1 or 4 streams (with a
//    direct or an FSE-coded weight table) or treeless, sequences with
//    predefined, RLE, FSE-coded and repeated tables, the repeat offsets,
//    and the content checksum (XXH64, verified). Every read and write is
//    bounds-checked: a corrupt or truncated frame ends the decode with an
//    error code and never reads or writes past a buffer.
// ---------------------------------------------------------------------------

namespace zstd {

enum Error : int64_t {
  kCorrupt = -1,      // malformed or truncated input
  kTooSmall = -2,     // the output does not fit the destination
  kDictionary = -3,   // the frame needs a dictionary
  kChecksum = -4,     // the content checksum does not match
};

struct Fail {
  Error code;
};

[[noreturn]] inline void fail(Error e = kCorrupt) { throw Fail{e}; }

using host::highest_bit;
using namespace zstd_format;

// Forward reader over [p, end): bytes, and bits least significant first
// (the FSE table descriptions).
struct Forward {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t bit = 0;  // bits consumed from p[0]

  uint8_t byte() {
    if (p >= end) fail();
    return *p++;
  }
  const uint8_t* take(uint64_t n) {
    if (uint64_t(end - p) < n) fail();
    const uint8_t* q = p;
    p += n;
    return q;
  }
  uint32_t le(int n) {
    const uint8_t* q = take(n);
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v |= uint32_t(q[i]) << (8 * i);
    return v;
  }
  uint32_t bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++bit) {
      const uint64_t at = bit >> 3;
      if (at >= uint64_t(end - p)) fail();
      v |= uint32_t((p[at] >> (bit & 7)) & 1) << i;
    }
    return v;
  }
  void rewind_bit() { --bit; }
  void align() {  // to the byte after the last bit read
    p += (bit + 7) >> 3;
    bit = 0;
  }
};

// Backward bit reader: a stream is read from its last bit down to its
// first, after the highest set bit of its last byte (the end mark). Bits
// below the stream's start read as 0 (`pos` goes negative), which the
// FSE-coded Huffman weights rely on; the other users check that they end
// exactly at 0.
struct Backward {
  const uint8_t* src;
  int64_t len;
  int64_t pos;  // bits still above the start

  Backward(const uint8_t* s, int64_t n) : src(s), len(n) {
    if (n <= 0 || s[n - 1] == 0) fail();
    pos = n * 8 - (8 - highest_bit(s[n - 1]));
  }
  uint64_t bits(int n) {  // n <= 56
    if (n == 0) return 0;
    pos -= n;
    if (pos >= 0 && (pos >> 3) + 8 <= len) {  // one 8-byte load
      uint64_t v;
      std::memcpy(&v, src + (pos >> 3), 8);
      return (v >> (pos & 7)) & ((uint64_t(1) << n) - 1);
    }
    int64_t off = pos, cnt = n;
    if (off < 0) {
      cnt += off;
      off = 0;
      if (cnt <= 0) return 0;
    }
    // the cnt bits at bit offset off, little-endian
    const int64_t first = off >> 3, last = (off + cnt - 1) >> 3;
    uint64_t v = 0;
    for (int64_t b = last; b >= first; --b) v = (v << 8) | src[b];
    v = (v >> (off & 7)) & ((uint64_t(1) << cnt) - 1);
    return pos < 0 ? v << (-pos) : v;
  }
};

// FSE decoding table of accuracy log `log` (1 << log states)
struct Fse {
  int log = 0;
  uint8_t symbol[512];
  uint8_t nbits[512];
  uint16_t base[512];
  bool ready = false;

  void build(const int16_t* norm, int nsym, int accuracy) {
    const int size = 1 << accuracy;
    int high = size;
    uint16_t next[256];
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] == -1) {
        symbol[--high] = uint8_t(s);
        next[s] = 1;
      }
    }
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int pos = 0;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] <= 0) continue;
      next[s] = uint16_t(norm[s]);
      for (int i = 0; i < norm[s]; ++i) {
        symbol[pos] = uint8_t(s);
        do {
          pos = (pos + step) & mask;
        } while (pos >= high);
      }
    }
    if (pos != 0) fail();
    for (int i = 0; i < size; ++i) {
      const uint16_t d = next[symbol[i]]++;
      nbits[i] = uint8_t(accuracy - highest_bit(d));
      base[i] = uint16_t((d << nbits[i]) - size);
    }
    log = accuracy;
    ready = true;
  }

  void rle(uint8_t s) {
    log = 0;
    symbol[0] = s;
    nbits[0] = 0;
    base[0] = 0;
    ready = true;
  }

  // the table description at `in`, accuracy log at most max_log
  void read(Forward& in, int max_log, int max_symbol) {
    const int accuracy = 5 + int(in.bits(4));
    if (accuracy > max_log) fail();
    int16_t norm[256];
    int remaining = 1 << accuracy, s = 0;
    while (remaining > 0 && s <= max_symbol) {
      const int nb = highest_bit(uint64_t(remaining) + 1) + 1;
      uint32_t v = in.bits(nb);
      const uint32_t low = (1u << (nb - 1)) - 1;
      const uint32_t threshold = (1u << nb) - 1 - uint32_t(remaining + 1);
      if ((v & low) < threshold) {
        in.rewind_bit();
        v &= low;
      } else if (v > low) {
        v -= threshold;
      }
      const int p = int(v) - 1;
      remaining -= p < 0 ? -p : p;
      norm[s++] = int16_t(p);
      if (p == 0) {
        for (;;) {
          const uint32_t repeat = in.bits(2);
          for (uint32_t i = 0; i < repeat; ++i) {
            if (s > max_symbol) fail();
            norm[s++] = 0;
          }
          if (repeat != 3) break;
        }
      }
    }
    if (remaining != 0) fail();
    in.align();
    build(norm, s, accuracy);
  }

  uint16_t init(Backward& in) const { return uint16_t(in.bits(log)); }
  uint8_t peek(uint16_t state) const { return symbol[state]; }
  void update(uint16_t& state, Backward& in) const {
    state = uint16_t(base[state] + in.bits(nbits[state]));
  }
};

// Huffman decoding table, at most 11 bits
struct Huffman {
  int max_bits = 0;
  uint8_t symbol[1 << 11];
  uint8_t nbits[1 << 11];
  bool ready = false;

  void build(const uint8_t* weights, int n) {  // n weights given, + 1 implied
    if (n + 1 > 256) fail();
    uint64_t sum = 0;
    for (int i = 0; i < n; ++i) {
      if (weights[i] > 11) fail();
      if (weights[i]) sum += uint64_t(1) << (weights[i] - 1);
    }
    if (sum == 0) fail();
    const int mb = highest_bit(sum) + 1;
    const uint64_t left = (uint64_t(1) << mb) - sum;
    if (left & (left - 1)) fail();
    if (mb > 11) fail();
    uint8_t bits[256];
    for (int i = 0; i < n; ++i)
      bits[i] = weights[i] ? uint8_t(mb + 1 - weights[i]) : 0;
    bits[n] = uint8_t(mb + 1 - (highest_bit(left) + 1));
    const int nsym = n + 1;
    uint32_t count[13] = {0}, start[13];
    for (int i = 0; i < nsym; ++i) count[bits[i]]++;
    start[mb] = 0;
    for (int b = mb; b >= 1; --b) {
      start[b - 1] = start[b] + count[b] * (1u << (mb - b));
      if (start[b - 1] > (1u << mb)) fail();
      for (uint32_t j = start[b]; j < start[b - 1]; ++j) nbits[j] = uint8_t(b);
    }
    if (start[0] != (1u << mb)) fail();
    for (int i = 0; i < nsym; ++i) {
      if (!bits[i]) continue;
      const uint32_t len = 1u << (mb - bits[i]);
      for (uint32_t j = 0; j < len; ++j) symbol[start[bits[i]] + j] = uint8_t(i);
      start[bits[i]] += len;
    }
    max_bits = mb;
    ready = true;
  }

  // the tree description at `in`
  void read(Forward& in) {
    const uint8_t head = in.byte();
    uint8_t w[256];
    int n = 0;
    if (head >= 128) {  // direct: 4 bits a weight
      n = head - 127;
      const uint8_t* q = in.take((n + 1) / 2);
      for (int i = 0; i < n; ++i)
        w[i] = (i & 1) ? (q[i / 2] & 15) : (q[i / 2] >> 4);
    } else {  // FSE-coded weights in `head` bytes
      Forward desc{in.take(head), nullptr};
      desc.end = desc.p + head;
      Fse table;
      desc.bit = 0;
      table.read(desc, 6, 255);
      Backward bits(desc.p, desc.end - desc.p);
      uint16_t s1 = table.init(bits), s2 = table.init(bits);
      for (;;) {
        if (n > 254) fail();
        w[n++] = table.peek(s1);
        table.update(s1, bits);
        if (bits.pos < 0) {
          if (n > 254) fail();
          w[n++] = table.peek(s2);
          break;
        }
        if (n > 254) fail();
        w[n++] = table.peek(s2);
        table.update(s2, bits);
        if (bits.pos < 0) {
          if (n > 254) fail();
          w[n++] = table.peek(s1);
          break;
        }
      }
    }
    build(w, n);
  }

  // n symbols of one stream into out
  void stream(const uint8_t* src, int64_t len, uint8_t* out, int64_t n) const {
    Backward in(src, len);
    uint32_t state = uint32_t(in.bits(max_bits));
    const uint32_t mask = (1u << max_bits) - 1;
    for (int64_t i = 0; i < n; ++i) {
      out[i] = symbol[state];
      const int b = nbits[state];
      state = ((state << b) + uint32_t(in.bits(b))) & mask;
    }
    if (in.pos != -max_bits) fail();
  }
};


// the state that carries from block to block within a frame
struct FrameState {
  Huffman huf;
  Fse ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
};

struct Output {
  uint8_t* dst;
  int64_t cap;
  int64_t pos;
  int64_t frame_start;

  void room(int64_t n) {
    if (n < 0 || cap - pos < n) fail(kTooSmall);
  }
};

void read_table(Forward& in, int mode, Fse& t, const int16_t* def, int ndef,
                int def_log, int max_log, int max_symbol) {
  switch (mode) {
    case 0:
      t.build(def, ndef, def_log);
      break;
    case 1:
      t.rle(in.byte());
      if (t.symbol[0] > max_symbol) fail();
      break;
    case 2:
      t.read(in, max_log, max_symbol);
      break;
    default:
      if (!t.ready) fail();  // repeat: the previous block's table
  }
}

// one compressed block's content [p, end)
void compressed_block(const uint8_t* p, const uint8_t* end, FrameState& st,
                      Output& out, uint8_t* literals) {
  Forward in{p, end};
  // -- literals ---------------------------------------------------------
  const uint8_t h0 = in.byte();
  const int ltype = h0 & 3, sf = (h0 >> 2) & 3;
  int64_t regen = 0;
  const uint8_t* lit = literals;
  if (ltype <= 1) {  // raw or RLE
    if (sf == 0 || sf == 2) {
      regen = h0 >> 3;
    } else if (sf == 1) {
      regen = (h0 >> 4) + (int64_t(in.byte()) << 4);
    } else {
      regen = (h0 >> 4) + (int64_t(in.le(2)) << 4);
    }
    if (regen > kMaxBlock) fail();
    if (ltype == 0) {
      lit = in.take(regen);
    } else {
      std::memset(literals, in.byte(), size_t(regen));
    }
  } else {  // Huffman-coded, with a tree (2) or the last one (3)
    const int streams = sf == 0 ? 1 : 4;
    const int hbytes = sf <= 1 ? 3 : sf + 2;  // 3, 3, 4, 5 header bytes
    uint64_t h = h0;
    for (int i = 1; i < hbytes; ++i) h |= uint64_t(in.byte()) << (8 * i);
    const int sb = sf <= 1 ? 10 : (sf == 2 ? 14 : 18);
    regen = int64_t((h >> 4) & ((1u << sb) - 1));
    const int64_t csize = int64_t((h >> (4 + sb)) & ((1u << sb) - 1));
    if (regen > kMaxBlock) fail();
    Forward sec{in.take(csize), nullptr};
    sec.end = sec.p + csize;
    if (ltype == 2) {
      st.huf.read(sec);
    } else if (!st.huf.ready) {
      fail();
    }
    const int64_t left = sec.end - sec.p;
    if (streams == 1) {
      st.huf.stream(sec.p, left, literals, regen);
    } else {
      if (left < 6) fail();
      const int64_t s1 = sec.p[0] | (sec.p[1] << 8), s2 = sec.p[2] | (sec.p[3] << 8),
                    s3 = sec.p[4] | (sec.p[5] << 8);
      const int64_t s4 = left - 6 - s1 - s2 - s3;
      if (s4 < 1) fail();
      const int64_t per = (regen + 3) / 4;
      if (3 * per > regen) fail();
      const uint8_t* q = sec.p + 6;
      st.huf.stream(q, s1, literals, per);
      st.huf.stream(q + s1, s2, literals + per, per);
      st.huf.stream(q + s1 + s2, s3, literals + 2 * per, per);
      st.huf.stream(q + s1 + s2 + s3, s4, literals + 3 * per, regen - 3 * per);
    }
  }
  // -- sequences --------------------------------------------------------
  int64_t nseq = 0;
  const uint8_t b0 = in.byte();
  if (b0 < 128) {
    nseq = b0;
  } else if (b0 < 255) {
    nseq = (int64_t(b0 - 128) << 8) + in.byte();
  } else {
    nseq = in.le(2) + 0x7F00;
  }
  int64_t lit_left = regen;
  if (nseq > 0) {
    const uint8_t modes = in.byte();
    if (modes & 3) fail();
    read_table(in, modes >> 6, st.ll, kLLDefault, 36, 6, 9, 35);
    read_table(in, (modes >> 4) & 3, st.of, kOFDefault, 29, 5, 8, 31);
    read_table(in, (modes >> 2) & 3, st.ml, kMLDefault, 53, 6, 9, 52);
    Backward bits(in.p, in.end - in.p);
    uint16_t sl = st.ll.init(bits), so = st.of.init(bits), sm = st.ml.init(bits);
    for (int64_t i = 0; i < nseq; ++i) {
      const uint8_t oc = st.of.peek(so), mc = st.ml.peek(sm), lc = st.ll.peek(sl);
      if (oc > 31 || mc > 52 || lc > 35) fail();
      const uint64_t ofv = (uint64_t(1) << oc) + bits.bits(oc);
      const uint64_t ml = kMLBase[mc] + bits.bits(kMLBits[mc]);
      const uint64_t ll = kLLBase[lc] + bits.bits(kLLBits[lc]);
      if (i + 1 < nseq) {
        st.ll.update(sl, bits);
        st.ml.update(sm, bits);
        st.of.update(so, bits);
      }
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = offset;
      } else {
        const uint64_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = st.rep[0];
        } else {
          offset = idx < 3 ? st.rep[idx] : st.rep[0] - 1;
          if (idx > 1) st.rep[2] = st.rep[1];
          st.rep[1] = st.rep[0];
          st.rep[0] = offset;
        }
      }
      // literals, then the match
      if (int64_t(ll) > lit_left) fail();
      out.room(int64_t(ll));
      std::memcpy(out.dst + out.pos, lit, size_t(ll));
      out.pos += ll;
      lit += ll;
      lit_left -= ll;
      if (offset == 0 || offset > uint64_t(out.pos - out.frame_start)) fail();
      out.room(int64_t(ml));
      uint8_t* d = out.dst + out.pos;
      const uint8_t* m = d - offset;
      if (offset >= ml) {
        std::memcpy(d, m, size_t(ml));
      } else {  // overlapping: byte by byte
        for (uint64_t k = 0; k < ml; ++k) d[k] = m[k];
      }
      out.pos += ml;
    }
    if (bits.pos != 0) fail();
  } else if (in.p != in.end) {
    fail();
  }
  out.room(lit_left);
  std::memcpy(out.dst + out.pos, lit, size_t(lit_left));
  out.pos += lit_left;
}

// XXH64 of [p, p + n), seed 0
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
               P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
               P5 = 2870177450012600261ULL;
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t merge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}
uint64_t xxh64(const uint8_t* p, int64_t n) {
  const uint8_t* const end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = uint64_t(0) - P1;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (end - p >= 32);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(h, v1);
    h = merge(h, v2);
    h = merge(h, v3);
    h = merge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  while (end - p >= 8) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= uint64_t(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// one frame at in; its content appended to out
void frame(Forward& in, Output& out, std::vector<uint8_t>& literals) {
  const uint32_t magic = in.le(4);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable
    in.take(in.le(4));
    return;
  }
  if (magic != 0xFD2FB528u) fail();
  const uint8_t fhd = in.byte();
  const int fcs_flag = fhd >> 6, dict_flag = fhd & 3;
  const bool single = fhd & 0x20, checksum = fhd & 0x4;
  if (fhd & 0x8) fail();  // reserved bit
  if (!single) in.byte();  // the window descriptor: one buffer holds all
  if (dict_flag) {
    const int n = dict_flag == 3 ? 4 : dict_flag;
    if (in.le(n) != 0) fail(kDictionary);
  }
  int64_t fcs = -1;
  if (fcs_flag == 0) {
    if (single) fcs = in.byte();
  } else if (fcs_flag == 1) {
    fcs = int64_t(in.le(2)) + 256;
  } else if (fcs_flag == 2) {
    fcs = in.le(4);
  } else {
    const uint64_t lo = in.le(4), hi = in.le(4);
    fcs = int64_t(lo | (hi << 32));
    if (fcs < 0) fail();
  }
  if (fcs >= 0 && out.cap - out.pos < fcs) fail(kTooSmall);
  FrameState st;
  out.frame_start = out.pos;
  for (;;) {
    const uint32_t bh = in.le(3);
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const int64_t size = bh >> 3;
    if (type == 3) fail();
    if (type == 1) {  // RLE: size is the regenerated size
      if (size > kMaxBlock) fail();
      const uint8_t v = in.byte();
      out.room(size);
      std::memset(out.dst + out.pos, v, size_t(size));
      out.pos += size;
    } else {
      if (size > kMaxBlock) fail();
      const uint8_t* q = in.take(size);
      if (type == 0) {
        out.room(size);
        std::memcpy(out.dst + out.pos, q, size_t(size));
        out.pos += size;
      } else {
        compressed_block(q, q + size, st, out, literals.data());
      }
    }
    if (last) break;
  }
  if (fcs >= 0 && out.pos - out.frame_start != fcs) fail();
  if (checksum) {
    const uint32_t want = in.le(4);
    const uint64_t got = xxh64(out.dst + out.frame_start, out.pos - out.frame_start);
    if (uint32_t(got) != want) fail(kChecksum);
  }
}

}  // namespace zstd

extern "C" {

// Decode the zstd frames (and skippable frames) of src[0, src_size) into
// dst, which holds dst_cap bytes. Returns the number of bytes written, or
// a negative code: -1 malformed or truncated input, -2 the content does
// not fit in dst_cap bytes, -3 a frame needs a dictionary, -4 a content
// checksum does not match.
int64_t zstd_decompress(const uint8_t* src, int64_t src_size, uint8_t* dst,
                        int64_t dst_cap) {
  try {
    zstd::Forward in{src, src + src_size};
    zstd::Output out{dst, dst_cap, 0, 0};
    std::vector<uint8_t> literals(zstd::kMaxBlock);
    if (src_size < 4) zstd::fail();
    while (in.p < in.end) zstd::frame(in, out, literals);
    return out.pos;
  } catch (const zstd::Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return zstd::kTooSmall;
  }
}

// Undo blosc's bitshuffle of one block of `elems` elements (a multiple of
// 8) of `typesize` bytes: in holds typesize * 8 bit planes of elems / 8
// bytes, plane b * 8 + i holding bit i of byte b of every element, least
// significant bit first; out receives the elements.
void bitunshuffle(const uint8_t* in, int64_t elems, int64_t typesize,
                  uint8_t* out) {
  const int64_t nb = elems / 8;
  for (int64_t b = 0; b < typesize; ++b) {
    for (int64_t g = 0; g < nb; ++g) {
      // row i = plane b * 8 + i's byte for elements g * 8 .. g * 8 + 7
      uint64_t x = 0;
      for (int i = 0; i < 8; ++i)
        x |= uint64_t(in[(b * 8 + i) * nb + g]) << (8 * i);
      // transpose: bit 8 * i + k -> bit 8 * k + i
      uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAULL;
      x = x ^ t ^ (t << 7);
      t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCULL;
      x = x ^ t ^ (t << 14);
      t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ULL;
      x = x ^ t ^ (t << 28);
      for (int k = 0; k < 8; ++k)
        out[(g * 8 + k) * typesize + b] = uint8_t(x >> (8 * k));
    }
  }
}

}  // extern "C"
