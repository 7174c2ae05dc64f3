// The blosc codecs of the port's host library that csrc/window_sampler.cpp
// does not hold: the write side of the JAX package's zarr stores, and the
// two blosc codecs it reads. Built with g++ at first use and loaded
// through ctypes (state_policy_diffusionmodel_torch/data/native.py). Plain
// C interface, no third-party code.
//
// 1. A zstd frame encoder (RFC 8878): one frame that states its content
//    size, blocks of at most 128 KiB, matches from hash chains over the
//    whole frame (lazy from clevel 4), literals raw, RLE or Huffman-coded,
//    sequences with the predefined, RLE or encoder-built FSE tables. A
//    block that does not shrink is stored raw (RLE where it is one byte
//    value).
// 2. An LZ4 block encoder (the raw block format, for lz4 and lz4hc) that
//    keeps LZ4's end-of-block rules: the last 5 bytes are literals and the
//    last match starts at least 12 bytes before the end.
// 3. blosclz (c-blosc 1.x's FastLZ level-2 format with its far-distance
//    escape) and raw snappy (snappy's format_description.txt): encoders
//    over the same hash chains, and bounds-checked decoders.
// 4. blosc's byte shuffle and bitshuffle, forward: the exact inverses of
//    data/replay_buffer.py's unshuffle and window_sampler.cpp's
//    bitunshuffle.
// 5. The blosc1 chunk writer: the 16-byte header, the block offsets, each
//    block shuffled, split into typesize streams where c-blosc splits,
//    each stream compressed, or stored as it is where that does not
//    shrink it; the blocks spread over threads, then laid out with
//    c-blosc's own accounting of the room left, so a chunk is stored
//    whole (memcpyed) where c-blosc's would be. A codec the library does
//    not hold (zlib) comes in as a function pointer.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#include "host_common.h"

namespace {

using host::highest_bit;
using host::parallel_for;
using namespace zstd_format;

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline void put_le(std::vector<uint8_t>& out, uint64_t v, int n) {
  for (int i = 0; i < n; ++i) out.push_back(uint8_t(v >> (8 * i)));
}

// Little-endian bit writer: each field lands above the bits before it. A
// zstd backward stream is closed by a 1 bit, its end mark; its decoder
// reads the fields back last first.
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int n = 0;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint64_t v, int bits) {  // bits <= 32, v < 2^bits
    acc |= v << n;
    n += bits;
    while (n >= 8) {
      out.push_back(uint8_t(acc));
      acc >>= 8;
      n -= 8;
    }
  }
  void flush() {  // to a whole byte, with zero bits
    if (n > 0) out.push_back(uint8_t(acc));
    acc = 0;
    n = 0;
  }
  void close() {
    put(1, 1);
    flush();
  }
};

// ---------------------------------------------------------------------------
// 1. zstd
// ---------------------------------------------------------------------------

// the largest code whose base is at most v
inline int code_of(const uint32_t* base, int n, uint32_t v) {
  return int(std::upper_bound(base, base + n, v) - base) - 1;
}

// One FSE distribution, encoding side: the decoder's spread of the symbols
// over 1 << log states, and each symbol's states in increasing order (the
// k-th of them is the decoder's state that reads d = count + k). A state
// is carried as x = state + (1 << log). `rle` tables (one symbol, log 0)
// write no bits.
struct FseEncoder {
  int log = 0;
  bool rle = false;
  int16_t norm[256];
  uint16_t first[257];
  uint16_t states[512];

  int count(int s) const { return norm[s] == -1 ? 1 : norm[s]; }

  void build(const int16_t* nm, int nsym, int lg) {
    log = lg;
    rle = false;
    const int size = 1 << lg;
    uint8_t symbol[512];
    int high = size;
    for (int s = 0; s < nsym; ++s) {
      norm[s] = nm[s];
      if (nm[s] == -1) symbol[--high] = uint8_t(s);
    }
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int pos = 0;
    for (int s = 0; s < nsym; ++s) {
      for (int i = 0; i < nm[s]; ++i) {
        symbol[pos] = uint8_t(s);
        do {
          pos = (pos + step) & mask;
        } while (pos >= high);
      }
    }
    first[0] = 0;
    for (int s = 0; s < nsym; ++s) first[s + 1] = uint16_t(first[s] + count(s));
    uint16_t fill[256];
    std::memcpy(fill, first, sizeof(uint16_t) * nsym);
    for (int i = 0; i < size; ++i) states[fill[symbol[i]]++] = uint16_t(i);
  }

  void make_rle() {
    rle = true;
    log = 0;
  }
  uint32_t init(int s) const { return rle ? 0 : states[first[s]] + (1u << log); }
  void encode(BitWriter& w, uint32_t& x, int s) const {
    if (rle) return;
    const int c = count(s);
    int nb = log - highest_bit(uint64_t(c));
    if (int(x >> nb) < c) --nb;
    w.put(x & ((1u << nb) - 1), nb);
    x = states[first[s] + (x >> nb) - c] + (1u << log);
  }
  void flush(BitWriter& w, uint32_t x) const {
    if (!rle) w.put(x - (1u << log), log);
  }
};

// counts -> a distribution of 1 << log states in which every present
// symbol holds at least one (at most 1 << log symbols are present)
void normalize(const uint32_t* count, int nsym, int log, int16_t* norm) {
  uint64_t total = 0;
  for (int s = 0; s < nsym; ++s) total += count[s];
  const int64_t size = int64_t(1) << log;
  int64_t sum = 0;
  int big = -1;
  for (int s = 0; s < nsym; ++s) {
    norm[s] = 0;
    if (!count[s]) continue;
    int64_t v = int64_t((uint64_t(count[s]) * size + total / 2) / total);
    norm[s] = int16_t(v < 1 ? 1 : v);
    sum += norm[s];
    if (big < 0 || norm[s] > norm[big]) big = s;
  }
  if (sum < size) norm[big] = int16_t(norm[big] + (size - sum));
  while (sum > size) {
    int s = 0;
    for (int t = 1; t < nsym; ++t)
      if (norm[t] > norm[s]) s = t;
    const int64_t take = std::min<int64_t>(sum - size, norm[s] - 1);
    norm[s] = int16_t(norm[s] - take);
    sum -= take;
  }
}

// the bits a distribution spends on `count` (table description excluded)
double fse_cost(const uint32_t* count, const int16_t* norm, int nsym, int log) {
  double bits = 0;
  for (int s = 0; s < nsym; ++s) {
    if (!count[s]) continue;
    if (norm[s] == 0) return 1e300;
    bits += count[s] * (log - std::log2(double(norm[s] == -1 ? 1 : norm[s])));
  }
  return bits;
}

// the table description (RFC 8878 4.1.1), read by Fse::read
void write_ncount(std::vector<uint8_t>& out, const int16_t* norm, int nsym, int log) {
  BitWriter w(out);
  w.put(uint64_t(log - 5), 4);
  int remaining = 1 << log, s = 0;
  while (remaining > 0 && s < nsym) {
    const int nb = highest_bit(uint64_t(remaining) + 1) + 1;
    const uint32_t x = uint32_t(norm[s] + 1);
    const uint32_t low = (1u << (nb - 1)) - 1;
    const uint32_t threshold = (1u << nb) - 1 - uint32_t(remaining + 1);
    if (x < threshold)
      w.put(x, nb - 1);
    else if (x <= low)
      w.put(x, nb);
    else
      w.put(x + threshold, nb);
    remaining -= norm[s] < 0 ? -norm[s] : norm[s];
    if (norm[s++] == 0) {  // the zeros that follow: 2-bit repeat flags
      int z = 0;
      while (s + z < nsym && norm[s + z] == 0) ++z;
      s += z;
      for (; z >= 3; z -= 3) w.put(3, 2);
      w.put(uint64_t(z), 2);
    }
  }
  w.flush();
}

// Huffman code of the literals, at most 11 bits, its weights as the
// decoder's Huffman::build reads them
struct HufEncoder {
  uint8_t bits[256];
  uint16_t code[256];
  int max_bits = 0;
  int last = 0;  // the highest present symbol, whose weight is implied

  // false unless at least two symbols are present
  bool build(const uint32_t* count) {
    int sym[256], n = 0;
    for (int s = 0; s < 256; ++s) {
      bits[s] = 0;
      if (count[s]) sym[n++] = s;
    }
    if (n < 2) return false;
    std::stable_sort(sym, sym + n, [&](int a, int b) { return count[a] < count[b]; });
    // two-queue Huffman over the sorted leaves; depth of every node
    uint64_t w[512];
    int parent[512];
    for (int i = 0; i < n; ++i) w[i] = count[sym[i]];
    int leaf = 0, inner = n;
    for (int k = n; k < 2 * n - 1; ++k) {
      int pick[2];
      for (int j = 0; j < 2; ++j) {
        if (leaf < n && (inner >= k || w[leaf] <= w[inner]))
          pick[j] = leaf++;
        else
          pick[j] = inner++;
      }
      w[k] = w[pick[0]] + w[pick[1]];
      parent[pick[0]] = parent[pick[1]] = k;
    }
    int depth[512];
    depth[2 * n - 2] = 0;
    for (int k = 2 * n - 3; k >= 0; --k) depth[k] = depth[parent[k]] + 1;
    const int limit = 11;
    int64_t kraft = 0;  // sum of 2^(limit - len)
    for (int i = 0; i < n; ++i) {
      bits[sym[i]] = uint8_t(std::min(depth[i], limit));
      kraft += int64_t(1) << (limit - bits[sym[i]]);
    }
    // over the limit: lengthen the longest codes under it (the rarest
    // first) until the code fits, then shorten the longest ones while the
    // code stays a prefix code, until it is complete
    while (kraft > (int64_t(1) << limit)) {
      int best = -1;
      for (int i = 0; i < n; ++i)
        if (bits[sym[i]] < limit && (best < 0 || bits[sym[i]] > bits[sym[best]])) best = i;
      kraft -= int64_t(1) << (limit - bits[sym[best]] - 1);
      bits[sym[best]]++;
    }
    while (kraft < (int64_t(1) << limit)) {
      int best = -1;
      for (int i = n - 1; i >= 0; --i)
        if (bits[sym[i]] > 1 && kraft + (int64_t(1) << (limit - bits[sym[i]])) <= (int64_t(1) << limit) &&
            (best < 0 || bits[sym[i]] > bits[sym[best]]))
          best = i;
      kraft += int64_t(1) << (limit - bits[sym[best]]);
      bits[sym[best]]--;
    }
    max_bits = 0;
    last = 0;
    for (int s = 0; s < 256; ++s)
      if (bits[s]) {
        max_bits = std::max(max_bits, int(bits[s]));
        last = s;
      }
    // canonical codes, as the decoder lays out its table: the longest
    // codes first, symbols in increasing order within a length
    uint32_t cnt[13] = {0}, start[13];
    for (int s = 0; s < 256; ++s) cnt[bits[s]]++;
    start[max_bits] = 0;
    for (int b = max_bits; b >= 1; --b) start[b - 1] = start[b] + cnt[b] * (1u << (max_bits - b));
    for (int s = 0; s < 256; ++s) {
      if (!bits[s]) continue;
      code[s] = uint16_t(start[bits[s]] >> (max_bits - bits[s]));
      start[bits[s]] += 1u << (max_bits - bits[s]);
    }
    return true;
  }

  uint8_t weight(int s) const { return bits[s] ? uint8_t(max_bits + 1 - bits[s]) : 0; }

  // the tree description: the weights of symbols 0 .. last - 1, FSE-coded
  // in two interleaved states or 4 bits each; false if neither fits
  bool write_tree(std::vector<uint8_t>& out) const {
    const int n = last;
    uint8_t w[256];
    uint32_t count[16] = {0};
    int distinct = 0;
    for (int i = 0; i < n; ++i) {
      w[i] = weight(i);
      distinct += count[w[i]]++ == 0;
    }
    std::vector<uint8_t> best;
    if (n >= 2 && distinct >= 2) {
      for (int log = 5; log <= 6; ++log) {
        int16_t norm[16];
        normalize(count, 12, log, norm);
        FseEncoder enc;
        enc.build(norm, 12, log);
        std::vector<uint8_t> buf;
        write_ncount(buf, norm, 12, log);
        BitWriter bw(buf);
        uint32_t s1, s2;
        int i = n;
        if (n & 1) {
          s1 = enc.init(w[--i]);
          s2 = enc.init(w[--i]);
          enc.encode(bw, s1, w[--i]);
        } else {
          s2 = enc.init(w[--i]);
          s1 = enc.init(w[--i]);
        }
        while (i > 0) {
          enc.encode(bw, s2, w[--i]);
          enc.encode(bw, s1, w[--i]);
        }
        enc.flush(bw, s2);
        enc.flush(bw, s1);
        bw.close();
        if (buf.size() < 128 && (best.empty() || buf.size() < best.size())) best.swap(buf);
      }
    }
    if (n <= 128 && (best.empty() || size_t((n + 1) / 2) <= best.size())) {
      out.push_back(uint8_t(127 + n));
      for (int i = 0; i < n; i += 2) out.push_back(uint8_t((w[i] << 4) | (i + 1 < n ? w[i + 1] : 0)));
      return true;
    }
    if (best.empty()) return false;
    out.push_back(uint8_t(best.size()));
    out.insert(out.end(), best.begin(), best.end());
    return true;
  }

  void stream(const uint8_t* lit, int64_t n, std::vector<uint8_t>& out) const {
    BitWriter bw(out);
    for (int64_t i = n - 1; i >= 0; --i) bw.put(code[lit[i]], bits[lit[i]]);
    bw.close();
  }
};

void literal_header(std::vector<uint8_t>& out, int type, int64_t n) {  // raw or RLE
  if (n < 32) {
    out.push_back(uint8_t(type | (n << 3)));
  } else if (n < 4096) {
    put_le(out, uint64_t(type | (1 << 2) | (n << 4)), 2);
  } else {
    put_le(out, uint64_t(type | (3 << 2) | (n << 4)), 3);
  }
}

// the literals section (RFC 8878 3.1.1.3.1): Huffman-coded where that is
// smaller than raw, RLE where every literal is one byte value
void write_literals(const uint8_t* lit, int64_t n, std::vector<uint8_t>& out) {
  uint32_t count[256] = {0};
  for (int64_t i = 0; i < n; ++i) count[lit[i]]++;
  int present = 0;
  for (int s = 0; s < 256; ++s) present += count[s] != 0;
  if (n > 0 && present == 1) {
    literal_header(out, 1, n);
    out.push_back(lit[0]);
    return;
  }
  const size_t raw_size = size_t(n) + (n < 32 ? 1 : n < 4096 ? 2 : 3);
  HufEncoder huf;
  std::vector<uint8_t> body;
  if (n >= 64 && huf.build(count) && huf.write_tree(body)) {
    const bool single = n <= 1023;
    bool fits = true;  // each of the first three streams' sizes in 16 bits
    if (single) {
      huf.stream(lit, n, body);
    } else {  // four streams of (n + 3) / 4 literals, the last of the rest
      const int64_t seg = (n + 3) / 4;
      const size_t jump = body.size();
      body.resize(jump + 6);
      for (int k = 0; k < 4; ++k) {
        const size_t at = body.size();
        huf.stream(lit + k * seg, std::min(n, (k + 1) * seg) - k * seg, body);
        const size_t size = body.size() - at;
        if (k < 3) {
          fits = fits && size <= 0xFFFF;
          body[jump + 2 * k] = uint8_t(size);
          body[jump + 2 * k + 1] = uint8_t(size >> 8);
        }
      }
    }
    const int64_t comp = int64_t(body.size());
    const int64_t most = std::max(n, comp);
    int sf, nbits, head;
    if (single && comp <= 1023) {
      sf = 0, nbits = 10, head = 3;
    } else if (most <= 1023) {
      sf = 1, nbits = 10, head = 3;
    } else if (most <= 16383) {
      sf = 2, nbits = 14, head = 4;
    } else {
      sf = 3, nbits = 18, head = 5;
    }
    if (fits && !(single && comp > 1023) && size_t(head + comp) < raw_size) {
      put_le(out, uint64_t(2 | (sf << 2)) | (uint64_t(n) << 4) | (uint64_t(comp) << (4 + nbits)), head);
      out.insert(out.end(), body.begin(), body.end());
      return;
    }
  }
  literal_header(out, 0, n);
  out.insert(out.end(), lit, lit + n);
}

struct Sequence {
  uint32_t ll, ml, off_base;
};

// one of the three code tables of a block: RLE where one code is used,
// else the predefined distribution or one built from the counts, whichever
// costs fewer bits with its description
struct TableChoice {
  int mode = 0;
  FseEncoder enc;
  std::vector<uint8_t> desc;

  void choose(const uint32_t* count, int nsym, uint32_t n, const int16_t* def, int ndef,
              int def_log, int max_log) {
    int present = 0, last = 0;
    for (int s = 0; s < nsym; ++s)
      if (count[s]) {
        present++;
        last = s;
      }
    desc.clear();
    if (present == 1) {
      mode = 1;
      desc.push_back(uint8_t(last));
      enc.make_rle();
      return;
    }
    const double def_cost = last < ndef ? fse_cost(count, def, ndef, def_log) : 1e300;
    int log = std::min(max_log, std::max(5, highest_bit(n) + 1));
    while ((1 << log) < present) ++log;
    int16_t norm[64];
    normalize(count, last + 1, log, norm);
    std::vector<uint8_t> d;
    write_ncount(d, norm, last + 1, log);
    const double own_cost = fse_cost(count, norm, last + 1, log) + 8.0 * double(d.size());
    if (def_cost <= own_cost) {
      mode = 0;
      enc.build(def, ndef, def_log);
    } else {
      mode = 2;
      desc.swap(d);
      enc.build(norm, last + 1, log);
    }
  }
};

// the sequences section (RFC 8878 3.1.1.3.2)
void write_sequences(const std::vector<Sequence>& seqs, std::vector<uint8_t>& out) {
  const uint32_t n = uint32_t(seqs.size());
  if (n < 128) {
    out.push_back(uint8_t(n));
  } else if (n < 0x7F00) {
    out.push_back(uint8_t((n >> 8) + 128));
    out.push_back(uint8_t(n));
  } else {
    out.push_back(255);
    put_le(out, n - 0x7F00, 2);
  }
  if (n == 0) return;
  std::vector<uint8_t> llc(n), mlc(n), ofc(n);
  uint32_t llcount[36] = {0}, mlcount[53] = {0}, ofcount[32] = {0};
  for (uint32_t i = 0; i < n; ++i) {
    llc[i] = uint8_t(code_of(kLLBase, 36, seqs[i].ll));
    mlc[i] = uint8_t(code_of(kMLBase, 53, seqs[i].ml));
    ofc[i] = uint8_t(highest_bit(seqs[i].off_base));
    llcount[llc[i]]++;
    mlcount[mlc[i]]++;
    ofcount[ofc[i]]++;
  }
  TableChoice ll, of, ml;
  ll.choose(llcount, 36, n, kLLDefault, 36, 6, 9);
  of.choose(ofcount, 32, n, kOFDefault, 29, 5, 8);
  ml.choose(mlcount, 53, n, kMLDefault, 53, 6, 9);
  out.push_back(uint8_t((ll.mode << 6) | (of.mode << 4) | (ml.mode << 2)));
  for (const TableChoice* t : {&ll, &of, &ml}) out.insert(out.end(), t->desc.begin(), t->desc.end());
  BitWriter bw(out);
  auto extra = [&](uint32_t i) {
    bw.put(seqs[i].ll - kLLBase[llc[i]], kLLBits[llc[i]]);
    bw.put(seqs[i].ml - kMLBase[mlc[i]], kMLBits[mlc[i]]);
    bw.put(seqs[i].off_base - (1u << ofc[i]), ofc[i]);
  };
  uint32_t sll = ll.enc.init(llc[n - 1]), sof = of.enc.init(ofc[n - 1]), sml = ml.enc.init(mlc[n - 1]);
  extra(n - 1);
  for (int64_t i = int64_t(n) - 2; i >= 0; --i) {
    of.enc.encode(bw, sof, ofc[i]);
    ml.enc.encode(bw, sml, mlc[i]);
    ll.enc.encode(bw, sll, llc[i]);
    extra(uint32_t(i));
  }
  ml.enc.flush(bw, sml);
  of.enc.flush(bw, sof);
  ll.enc.flush(bw, sll);
  bw.close();
}

// Hash chains over src[0, n): every position inserted in order, searched
// newest first, `depth` candidates at most, none farther than `window`.
struct Matcher {
  const uint8_t* src;
  int64_t n, window, next = 0;
  int depth, hbits;
  std::vector<int32_t> head, chain;

  Matcher(const uint8_t* s, int64_t len, int d, int64_t w)
      : src(s), n(len), window(w), depth(d),
        hbits(std::min(16, std::max(10, len > 1 ? highest_bit(uint64_t(len)) : 10))),
        head(size_t(1) << hbits, -1), chain(size_t(std::max<int64_t>(len, 1))) {}

  uint32_t hash(int64_t i) const { return (read32(src + i) * 2654435761u) >> (32 - hbits); }
  void update(int64_t i) {  // insert every position before i
    for (; next < i && next + 4 <= n; ++next) {
      const uint32_t h = hash(next);
      chain[next] = head[h];
      head[h] = int32_t(next);
    }
    if (next < i) next = i;
  }
  int64_t extend(int64_t a, int64_t b, int64_t limit) const {  // common length at a > b
    int64_t len = 0;
    while (a + len + 8 <= limit) {
      uint64_t x, y;
      std::memcpy(&x, src + a + len, 8);
      std::memcpy(&y, src + b + len, 8);
      if (x != y) return len + (__builtin_ctzll(x ^ y) >> 3);
      len += 8;
    }
    while (a + len < limit && src[a + len] == src[b + len]) ++len;
    return len;
  }
  // the longest match at i ending by limit, among the offsets `reps` and
  // the chain; 0 when none reaches 4 bytes
  int64_t find(int64_t i, int64_t limit, const uint32_t* reps, int nreps, uint32_t& off) const {
    int64_t best = 3;
    for (int r = 0; r < nreps; ++r) {
      if (reps[r] > i) continue;
      const int64_t len = extend(i, i - reps[r], limit);
      if (len > best) {
        best = len;
        off = reps[r];
      }
    }
    if (i + 4 <= n) {
      int32_t cand = head[hash(i)];
      for (int d = 0; d < depth && cand >= 0 && i - cand <= window; ++d, cand = chain[cand]) {
        if (i + best < limit && src[cand + best] != src[i + best]) continue;
        const int64_t len = extend(i, cand, limit);
        if (len > best) {
          best = len;
          off = uint32_t(i - cand);
          if (i + len >= limit) break;
        }
      }
    }
    return best > 3 ? best : 0;
  }
};

// the offset as the decoder reads it (repeat codes 1-3 or offset + 3),
// with the repeat offsets updated as the decoder updates them
uint32_t offset_code(uint32_t off, uint32_t ll, uint32_t* rep) {
  uint32_t code;
  if (ll) {
    if (off == rep[0]) return 1;
    code = off == rep[1] ? 2 : off == rep[2] ? 3 : off + 3;
  } else {
    code = off == rep[1] ? 1 : off == rep[2] ? 2 : (rep[0] > 1 && off == rep[0] - 1) ? 3 : off + 3;
  }
  if (code > 3 || (ll == 0 && code == 3)) {  // a new offset goes in front
    rep[2] = rep[1];
    rep[1] = rep[0];
    rep[0] = off;
  } else if (off == rep[1]) {
    rep[1] = rep[0];
    rep[0] = off;
  } else {  // rep[2]
    rep[2] = rep[1];
    rep[1] = rep[0];
    rep[0] = off;
  }
  return code;
}

struct Effort {
  int depth;
  bool lazy;
};

Effort zstd_effort(int clevel) {
  if (clevel <= 1) return {4, false};
  if (clevel <= 3) return {8, false};
  if (clevel <= 5) return {16, true};
  if (clevel <= 7) return {48, true};
  return {128, true};
}

// one frame of src[0, n) into out
void zstd_frame(const uint8_t* src, int64_t n, int clevel, std::vector<uint8_t>& out) {
  put_le(out, 0xFD2FB528u, 4);
  // single segment (the window is the content), no checksum, no dictionary
  if (n < 256) {
    out.push_back(0x20);
    out.push_back(uint8_t(n));
  } else if (n < 65536 + 256) {
    out.push_back(0x20 | (1 << 6));
    put_le(out, uint64_t(n - 256), 2);
  } else {
    out.push_back(0x20 | (2 << 6));
    put_le(out, uint64_t(n), 4);
  }
  if (n == 0) {
    put_le(out, 1, 3);  // one empty raw block, the last
    return;
  }
  const Effort e = zstd_effort(clevel);
  Matcher m(src, n, e.depth, n);
  uint32_t rep[3] = {1, 4, 8};
  std::vector<Sequence> seqs;
  std::vector<uint8_t> lits, block;
  for (int64_t lo = 0; lo < n; lo += kMaxBlock) {
    const int64_t hi = std::min(n, lo + kMaxBlock), size = hi - lo;
    const uint32_t last = hi == n;
    bool same = true;
    for (int64_t i = lo + 1; i < hi && same; ++i) same = src[i] == src[lo];
    if (same) {  // an RLE block
      put_le(out, last | (1u << 1) | (uint64_t(size) << 3), 3);
      out.push_back(src[lo]);
      continue;
    }
    uint32_t saved[3] = {rep[0], rep[1], rep[2]};
    seqs.clear();
    lits.clear();
    int64_t i = lo, anchor = lo;
    while (i + 4 <= hi) {
      m.update(i);
      uint32_t off = 0;
      int64_t len = m.find(i, hi, rep, 3, off);
      if (!len) {
        ++i;
        continue;
      }
      if (e.lazy && len < 64 && i + 5 <= hi) {
        m.update(i + 1);
        uint32_t off2 = 0;
        const int64_t len2 = m.find(i + 1, hi, rep, 3, off2);
        if (len2 > len) {
          ++i;
          len = len2;
          off = off2;
        }
      }
      const uint32_t ll = uint32_t(i - anchor);
      lits.insert(lits.end(), src + anchor, src + i);
      seqs.push_back({ll, uint32_t(len), offset_code(off, ll, rep)});
      i += len;
      anchor = i;
    }
    lits.insert(lits.end(), src + anchor, src + hi);
    block.clear();
    write_literals(lits.data(), int64_t(lits.size()), block);
    write_sequences(seqs, block);
    if (int64_t(block.size()) < size) {
      put_le(out, last | (2u << 1) | (uint64_t(block.size()) << 3), 3);
      out.insert(out.end(), block.begin(), block.end());
    } else {  // raw; the decoder's repeat offsets stay as they were
      std::memcpy(rep, saved, sizeof(rep));
      put_le(out, last | (uint64_t(size) << 3), 3);
      out.insert(out.end(), src + lo, src + hi);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. LZ4
// ---------------------------------------------------------------------------

void lz4_length(std::vector<uint8_t>& out, int64_t v) {  // past the nibble's 15
  for (; v >= 255; v -= 255) out.push_back(255);
  out.push_back(uint8_t(v));
}

void lz4_block(const uint8_t* src, int64_t n, int depth, std::vector<uint8_t>& out) {
  int64_t anchor = 0;
  if (n >= 13) {
    Matcher m(src, n, depth, 65535);
    const int64_t mflimit = n - 12, limit = n - 5;
    int64_t i = 0;
    while (i <= mflimit) {
      m.update(i);
      uint32_t off = 0;
      const int64_t len = m.find(i, limit, nullptr, 0, off);
      if (!len) {
        ++i;
        continue;
      }
      const int64_t lit = i - anchor, ml = len - 4;
      out.push_back(uint8_t((std::min<int64_t>(lit, 15) << 4) | std::min<int64_t>(ml, 15)));
      if (lit >= 15) lz4_length(out, lit - 15);
      out.insert(out.end(), src + anchor, src + i);
      out.push_back(uint8_t(off));
      out.push_back(uint8_t(off >> 8));
      if (ml >= 15) lz4_length(out, ml - 15);
      i += len;
      anchor = i;
    }
  }
  const int64_t lit = n - anchor;
  out.push_back(uint8_t(std::min<int64_t>(lit, 15) << 4));
  if (lit >= 15) lz4_length(out, lit - 15);
  out.insert(out.end(), src + anchor, src + n);
}

int lz4_depth(int clevel, bool hc) {
  return hc ? 16 << std::min(clevel / 2, 4) : 1 + clevel / 3;
}

// ---------------------------------------------------------------------------
// 3. blosclz and snappy encoders
// ---------------------------------------------------------------------------

// blosclz, as blosclz_decompress below (and c-blosc's) reads it. A literal
// run is a control byte count - 1 (0-31) and its bytes. A match of len >= 3
// bytes at distance d + 1 is a control byte (min(len - 2, 7) << 5 | d >> 8),
// then where len - 2 >= 7 the rest of len - 9 in bytes of 255 and a last
// byte, then d & 255; a d of 8191 or more is the escape (31 << 8 | 255)
// followed by d - 8191 in two bytes, high first. The first control byte
// carries the format's level, 1 << 5. c-blosc's decoder stops before it
// copies a match that ends the stream, so the stream ends in literals.
constexpr int64_t kBlosclzNear = 8191;                // c-blosc's MAX_DISTANCE
constexpr int64_t kBlosclzWindow = 65535 + 8191 - 2;  // below MAX_FARDISTANCE

void blosclz_block(const uint8_t* src, int64_t n, int depth, std::vector<uint8_t>& out) {
  size_t ctrl = 0;  // the open literal run's control byte
  int run = 0;      // its literals, 0 where none is open
  auto literal = [&](int64_t from, int64_t to) {
    for (; from < to; ++from) {
      if (run == 0 || run == 32) {
        ctrl = out.size();
        out.push_back(0);
        run = 0;
      }
      out.push_back(src[from]);
      out[ctrl] = uint8_t(run++);
    }
  };
  int64_t anchor = 0;
  if (n >= 6) {
    Matcher m(src, n, depth, kBlosclzWindow);
    int64_t i = 1;
    while (i + 5 <= n) {  // a match ends a byte before the stream at most
      m.update(i);
      uint32_t off = 0;
      const int64_t len = m.find(i, n - 1, nullptr, 0, off);
      const int64_t d = int64_t(off) - 1;
      if (!len || (d >= kBlosclzNear && len < 6)) {  // a far match costs 4 bytes
        ++i;
        continue;
      }
      literal(anchor, i);
      const int64_t l = len - 2;
      out.push_back(uint8_t((std::min<int64_t>(l, 7) << 5) | (d >= kBlosclzNear ? 31 : d >> 8)));
      if (l >= 7) {
        int64_t rest = l - 7;
        for (; rest >= 255; rest -= 255) out.push_back(255);
        out.push_back(uint8_t(rest));
      }
      if (d >= kBlosclzNear) {
        out.push_back(255);
        out.push_back(uint8_t((d - kBlosclzNear) >> 8));
        out.push_back(uint8_t(d - kBlosclzNear));
      } else {
        out.push_back(uint8_t(d));
      }
      run = 0;
      i += len;
      anchor = i;
    }
  }
  literal(anchor, n);
  if (!out.empty()) out[0] |= 1u << 5;
}

// snappy's raw format: the length as a varint, then literals (tag 0: the
// length - 1 in the tag's top 6 bits below 60, else in the 1-2 bytes that
// follow) and copies of 1-64 bytes (tag 1: 4-11 bytes at an 11-bit offset;
// tag 2: a 16-bit offset). Offsets stay within 65535.
void snappy_block(const uint8_t* src, int64_t n, int depth, std::vector<uint8_t>& out) {
  for (uint64_t v = uint64_t(n);; v >>= 7) {
    if (v < 128) {
      out.push_back(uint8_t(v));
      break;
    }
    out.push_back(uint8_t(v | 128));
  }
  auto literal = [&](int64_t from, int64_t to) {
    while (from < to) {
      const int64_t len = std::min<int64_t>(to - from, 65536), l = len - 1;
      if (l < 60) {
        out.push_back(uint8_t(l << 2));
      } else if (l < 256) {
        out.push_back(uint8_t(60 << 2));
        out.push_back(uint8_t(l));
      } else {
        out.push_back(uint8_t(61 << 2));
        out.push_back(uint8_t(l));
        out.push_back(uint8_t(l >> 8));
      }
      out.insert(out.end(), src + from, src + from + len);
      from += len;
    }
  };
  auto copy = [&](uint32_t off, int64_t len) {  // 1 <= len <= 64
    if (len >= 4 && len < 12 && off < 2048) {
      out.push_back(uint8_t(1 | ((len - 4) << 2) | ((off >> 8) << 5)));
      out.push_back(uint8_t(off));
    } else {
      out.push_back(uint8_t(2 | ((len - 1) << 2)));
      out.push_back(uint8_t(off));
      out.push_back(uint8_t(off >> 8));
    }
  };
  int64_t anchor = 0;
  if (n >= 4) {
    Matcher m(src, n, depth, 65535);
    int64_t i = 1;
    while (i + 4 <= n) {
      m.update(i);
      uint32_t off = 0;
      int64_t len = m.find(i, n, nullptr, 0, off);
      if (!len) {
        ++i;
        continue;
      }
      literal(anchor, i);
      i += len;
      anchor = i;
      for (; len >= 68; len -= 64) copy(off, 64);  // pieces of 4-64 bytes
      if (len > 64) {
        copy(off, 60);
        len -= 60;
      }
      copy(off, len);
    }
  }
  literal(anchor, n);
}

// ---------------------------------------------------------------------------
// 4. shuffles
// ---------------------------------------------------------------------------

void shuffle_block(const uint8_t* in, int64_t size, int64_t typesize, uint8_t* out) {
  const int64_t elems = size / typesize;
  for (int64_t j = 0; j < typesize; ++j)
    for (int64_t i = 0; i < elems; ++i) out[j * elems + i] = in[i * typesize + j];
  std::memcpy(out + elems * typesize, in + elems * typesize, size - elems * typesize);
}

void bitshuffle_block(const uint8_t* in, int64_t size, int64_t typesize, uint8_t* out) {
  const int64_t elems = size / typesize;
  if (elems % 8) {  // stored as it is, as c-blosc stores it
    std::memcpy(out, in, size);
    return;
  }
  const int64_t nb = elems / 8;
  for (int64_t b = 0; b < typesize; ++b) {
    for (int64_t g = 0; g < nb; ++g) {
      uint64_t x = 0;
      for (int k = 0; k < 8; ++k) x |= uint64_t(in[(g * 8 + k) * typesize + b]) << (8 * k);
      // transpose: bit 8 * k + i -> bit 8 * i + k
      uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAULL;
      x = x ^ t ^ (t << 7);
      t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCULL;
      x = x ^ t ^ (t << 14);
      t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ULL;
      x = x ^ t ^ (t << 28);
      for (int i = 0; i < 8; ++i) out[(b * 8 + i) * nb + g] = uint8_t(x >> (8 * i));
    }
  }
  std::memcpy(out + elems * typesize, in + elems * typesize, size - elems * typesize);
}

// ---------------------------------------------------------------------------
// 5. the chunk writer
// ---------------------------------------------------------------------------

// the blosc1 compressor format codes (the header's flags >> 5); lz4hc is
// written as lz4
enum Codec { kBlosclz = 0, kLz4 = 1, kSnappy = 2, kZlib = 3, kZstd = 4 };

// c-blosc 1.x's largest block (BLOSC_MAX_BLOCKSIZE)
constexpr int64_t kMaxBlocksize = (INT32_MAX - 255 * 4) / 3;

// c-blosc 1.x's block size for a chunk (compute_blocksize, with its
// forward-compatible split rule): `forced` is the caller's blocksize as
// the 32-bit int c-blosc takes (0: c-blosc's own), raised to 128 bytes
// (a negative one too) and then taken through the split rule as c-blosc's
// own is; lz4hc (hc), zlib and zstd are its high compression ratio
// codecs, whose blocks are doubled
int64_t blosc_blocksize(int codec, bool hc, int clevel, int64_t typesize, int64_t nbytes,
                        int64_t forced, bool split_codec) {
  const int64_t l1 = 32 * 1024;
  if (nbytes < typesize) return 1;
  int64_t bs = nbytes;
  if (forced != 0) {
    bs = std::min(std::max<int64_t>(forced, 128), kMaxBlocksize);
  } else if (nbytes >= l1) {
    bs = l1;
    const bool hcr = hc || codec == kZlib || codec == kZstd;
    if (hcr) bs *= 2;
    static const int factor[10] = {0, 0, 1, 2, 4, 4, 8, 8, 8, 8};
    if (clevel == 0)
      bs /= 4;
    else if (clevel == 1)
      bs /= 2;
    else
      bs *= factor[clevel];
    if (clevel == 9 && hcr) bs *= 2;
  }
  if (clevel > 0 && split_codec && bs / typesize >= 128) {  // c-blosc's split_block
    bs = std::min<int64_t>(bs, 1 << 18) * typesize;
    bs = std::min<int64_t>(std::max<int64_t>(bs, 1 << 16), 1024 * 1024);
  }
  bs = std::min(bs, nbytes);
  if (bs > typesize) bs = bs / typesize * typesize;
  return bs;
}

// the room c-blosc gives a codec for a stream of n bytes: snappy's bound
// (snappy refuses any less), n for the others
int64_t codec_room(int codec, int64_t n) { return codec == kSnappy ? 32 + n + n / 6 : n; }

}  // namespace

extern "C" {

// A codec the caller supplies (zlib): compress src[0, n) at clevel into
// dst, which holds cap bytes. Returns the bytes written, 0 where the
// result does not fit, or a negative error.
typedef int64_t (*stream_encoder)(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                                  int clevel);

// One zstd frame of src[0, n) into dst (cap bytes). Returns its size, 0
// where it does not fit, -2 where memory ran out.
int64_t zstd_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int clevel) {
  try {
    std::vector<uint8_t> out;
    out.reserve(size_t(n / 2 + 64));
    zstd_frame(src, n, clevel, out);
    if (int64_t(out.size()) > cap) return 0;
    std::memcpy(dst, out.data(), out.size());
    return int64_t(out.size());
  } catch (const std::bad_alloc&) {
    return -2;
  }
}

// One LZ4 block of src[0, n) into dst (cap bytes), hc for lz4hc's deeper
// search. Returns its size, 0 where it does not fit, -2 where memory ran
// out.
int64_t lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int clevel, int hc) {
  try {
    std::vector<uint8_t> out;
    out.reserve(size_t(n + n / 255 + 16));
    lz4_block(src, n, lz4_depth(clevel, hc != 0), out);
    if (int64_t(out.size()) > cap) return 0;
    std::memcpy(dst, out.data(), out.size());
    return int64_t(out.size());
  } catch (const std::bad_alloc&) {
    return -2;
  }
}

// One blosclz stream (depth: the hash chain's, c-blosc's clevel 1-9 as
// lz4's) or one raw snappy stream of src[0, n) into dst (cap bytes).
// Returns its size, 0 where it does not fit, -2 where memory ran out.
int64_t blosclz_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int clevel) {
  try {
    std::vector<uint8_t> out;
    out.reserve(size_t(n + n / 32 + 16));
    blosclz_block(src, n, lz4_depth(clevel, false), out);
    if (int64_t(out.size()) > cap) return 0;
    std::memcpy(dst, out.data(), out.size());
    return int64_t(out.size());
  } catch (const std::bad_alloc&) {
    return -2;
  }
}
int64_t snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int clevel) {
  try {
    std::vector<uint8_t> out;
    out.reserve(size_t(n + n / 32 + 16));
    snappy_block(src, n, lz4_depth(clevel, false), out);
    if (int64_t(out.size()) > cap) return 0;
    std::memcpy(dst, out.data(), out.size());
    return int64_t(out.size());
  } catch (const std::bad_alloc&) {
    return -2;
  }
}

// blosc's shuffles of one block of `size` bytes, forward
void shuffle(const uint8_t* in, int64_t size, int64_t typesize, uint8_t* out) {
  shuffle_block(in, size, typesize, out);
}
void bitshuffle(const uint8_t* in, int64_t size, int64_t typesize, uint8_t* out) {
  bitshuffle_block(in, size, typesize, out);
}

// Decode one blosclz stream (c-blosc 1.x's FastLZ level-2 format) of
// src_size bytes into dst (dst_cap bytes). Returns the bytes written, or
// -1 if the stream is malformed or does not fit.
int64_t blosclz_decompress(const uint8_t* src, int64_t src_size, uint8_t* dst, int64_t dst_cap) {
  if (src_size <= 0) return 0;
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_size;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;
  uint32_t ctrl = *ip++ & 31u;  // the first instruction is literals
  for (;;) {
    if (ctrl >= 32) {  // a match: length in the top 3 bits, 13-bit distance
      int64_t len = int64_t(ctrl >> 5) - 1;
      int64_t dist = int64_t(ctrl & 31u) << 8;
      if (len == 6) {
        uint32_t b;
        do {
          if (ip >= iend) return -1;
          b = *ip++;
          len += b;
        } while (b == 255);
      }
      if (ip >= iend) return -1;
      const uint32_t code = *ip++;
      len += 3;
      if (code == 255 && dist == (31 << 8)) {  // a 16-bit far distance
        if (iend - ip < 2) return -1;
        dist = (int64_t(ip[0]) << 8) + ip[1] + 8191;
        ip += 2;
      } else {
        dist += code;
      }
      dist += 1;
      if (dist > op - dst || oend - op < len) return -1;
      const uint8_t* ref = op - dist;
      for (int64_t i = 0; i < len; ++i) op[i] = ref[i];
      op += len;
    } else {  // ctrl + 1 literals
      const int64_t lit = int64_t(ctrl) + 1;
      if (iend - ip < lit || oend - op < lit) return -1;
      std::memcpy(op, ip, lit);
      op += lit;
      ip += lit;
    }
    if (ip >= iend) break;
    ctrl = *ip++;
  }
  return int64_t(op - dst);
}

// Decode one raw snappy stream (a varint length, then literals and copies)
// of src_size bytes into dst (dst_cap bytes). Returns the bytes written,
// or -1 if the stream is malformed, does not fit or decodes to another
// length than it states.
int64_t snappy_decompress(const uint8_t* src, int64_t src_size, uint8_t* dst, int64_t dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_size;
  uint64_t want = 0;
  for (int shift = 0;; shift += 7) {
    if (ip >= iend || shift > 28) return -1;
    const uint8_t b = *ip++;
    want |= uint64_t(b & 127) << shift;
    if (!(b & 128)) break;
  }
  if (want > uint64_t(dst_cap)) return -1;
  uint8_t* op = dst;
  uint8_t* const oend = dst + want;
  while (ip < iend) {
    const uint8_t tag = *ip++;
    int64_t len, off;
    switch (tag & 3) {
      case 0: {  // literals
        len = (tag >> 2) + 1;
        if (len > 60) {
          const int nb = int(len - 60);
          if (iend - ip < nb) return -1;
          len = 0;
          for (int i = 0; i < nb; ++i) len |= int64_t(ip[i]) << (8 * i);
          len += 1;
          ip += nb;
        }
        if (iend - ip < len || oend - op < len) return -1;
        std::memcpy(op, ip, len);
        op += len;
        ip += len;
        continue;
      }
      case 1:
        if (ip >= iend) return -1;
        len = ((tag >> 2) & 7) + 4;
        off = (int64_t(tag >> 5) << 8) | *ip++;
        break;
      case 2:
        if (iend - ip < 2) return -1;
        len = (tag >> 2) + 1;
        off = int64_t(ip[0]) | (int64_t(ip[1]) << 8);
        ip += 2;
        break;
      default:
        if (iend - ip < 4) return -1;
        len = (tag >> 2) + 1;
        off = int64_t(read32(ip));
        ip += 4;
    }
    if (off == 0 || off > op - dst || oend - op < len) return -1;
    const uint8_t* ref = op - off;
    for (int64_t i = 0; i < len; ++i) op[i] = ref[i];
    op += len;
  }
  return op == oend ? int64_t(want) : -1;
}

// Write src[0, nbytes) as one blosc1 chunk into dst (dst_cap >= nbytes +
// 16 bytes): typesize 1-255 (larger is written as 1, as c-blosc does),
// clevel 0-9, shuffle 0 (none), 1 (bytes) or 2 (bits), codec 0 (blosclz),
// 1 (lz4; hc for lz4hc's search), 2 (snappy), 3 (zlib, through
// `external`) or 4 (zstd), at c-blosc's block size, or a forced one
// (blocksize != 0). Returns the chunk's size, or -1 for bad arguments, -2
// where an encoder failed, -4 where dst is too small.
int64_t blosc_compress(const uint8_t* src, int64_t nbytes, int64_t typesize, int clevel,
                       int doshuffle, int codec, int hc, int32_t blocksize, uint8_t* dst,
                       int64_t dst_cap, int n_threads, stream_encoder external) {
  if (nbytes < 0 || nbytes > INT32_MAX - 16 || typesize < 1 || clevel < 0 || clevel > 9 ||
      doshuffle < 0 || doshuffle > 2 || codec < kBlosclz || codec > kZstd ||
      (hc && codec != kLz4) || (codec == kZlib && !external))
    return -1;
  if (dst_cap < nbytes + 16) return -4;
  if (typesize > 255) typesize = 1;
  const bool split_codec = codec != kZstd && typesize <= 16;
  const int64_t bs = blosc_blocksize(codec, hc != 0, clevel, typesize, nbytes, blocksize, split_codec);
  const bool split = split_codec && bs / typesize >= 128;
  uint8_t flags = uint8_t((doshuffle == 1 ? 0x1 : 0) | (doshuffle == 2 ? 0x4 : 0) |
                          (split ? 0 : 0x10) | (codec << 5));
  auto header = [&](int64_t cbytes) {
    const uint8_t head[4] = {2, 1, flags, uint8_t(typesize)};
    std::memcpy(dst, head, 4);
    const uint32_t v[3] = {uint32_t(nbytes), uint32_t(bs), uint32_t(cbytes)};
    std::memcpy(dst + 4, v, 12);
    return cbytes;
  };
  auto memcpyed = [&]() {
    flags |= 0x2;
    std::memcpy(dst + 16, src, nbytes);
    return header(nbytes + 16);
  };
  if (clevel == 0 || nbytes < 128) return memcpyed();
  const int64_t nblocks = (nbytes + bs - 1) / bs;
  // each block shuffled and its streams compressed, over threads: stream s
  // of a block at s * room in `packed`, its size in `sizes` (0 where it
  // did not fit in the room c-blosc would give it with all the chunk left)
  struct Block {
    std::vector<uint8_t> shuffled, packed;
    std::vector<int64_t> sizes;
  };
  std::vector<Block> blocks(nblocks);
  std::atomic<int> error(0);
  try {
    parallel_for(nblocks, n_threads, [&](int64_t b) {
      try {
        const int64_t size = std::min(bs, nbytes - b * bs);
        const uint8_t* in = src + b * bs;
        Block& blk = blocks[b];
        blk.shuffled.resize(size);
        uint8_t* tmp = blk.shuffled.data();
        if (doshuffle == 1 && typesize > 1)
          shuffle_block(in, size, typesize, tmp);
        else if (doshuffle == 2 && size >= typesize)
          bitshuffle_block(in, size, typesize, tmp);
        else
          std::memcpy(tmp, in, size);
        const int64_t ns = split && size == bs ? typesize : 1, ss = size / ns;
        const int64_t room = codec_room(codec, ss);
        blk.packed.resize(size_t(ns * room));
        blk.sizes.resize(ns);
        for (int64_t s = 0; s < ns; ++s) {
          const uint8_t* stream = tmp + s * ss;
          uint8_t* body = blk.packed.data() + s * room;
          int64_t c;
          if (codec == kZstd)
            c = zstd_compress(stream, ss, body, room, clevel);
          else if (codec == kLz4)
            c = lz4_compress(stream, ss, body, room, clevel, hc);
          else if (codec == kBlosclz)
            c = blosclz_compress(stream, ss, body, room, clevel);
          else if (codec == kSnappy)
            c = snappy_compress(stream, ss, body, room, clevel);
          else
            c = external(stream, ss, body, room, clevel);
          if (c < 0) {
            error = 1;
            return;
          }
          blk.sizes[s] = c;
        }
      } catch (const std::bad_alloc&) {
        error = 1;
      }
    });
  } catch (...) {
    return -2;
  }
  if (error) return -2;
  // the layout, with c-blosc's accounting: each stream may take what is
  // left of nbytes + 16 bytes, snappy its whole bound or nothing; a stream
  // that did not fit, or compressed to its raw size, is stored raw; where
  // that does not fit either, the chunk is stored whole
  const int64_t maxbytes = nbytes + 16;
  int64_t at = 16 + 4 * nblocks;
  for (int64_t b = 0; b < nblocks; ++b) {
    const Block& blk = blocks[b];
    const int64_t ns = int64_t(blk.sizes.size()), ss = int64_t(blk.shuffled.size()) / ns;
    const int64_t full = codec_room(codec, ss);
    const int32_t start = int32_t(at);
    std::memcpy(dst + 16 + 4 * b, &start, 4);
    for (int64_t s = 0; s < ns; ++s) {
      at += 4;
      int64_t room = full;
      if (at + room > maxbytes) {
        room = maxbytes - at;
        if (room <= 0) return memcpyed();
      }
      int64_t c = blk.sizes[s];
      const uint8_t* body = blk.packed.data() + s * full;
      if (c == 0 || c > room || c == ss || (codec == kSnappy && room < full)) {
        if (at + ss > maxbytes) return memcpyed();
        c = ss;
        body = blk.shuffled.data() + s * ss;
      }
      const int32_t c32 = int32_t(c);
      std::memcpy(dst + at - 4, &c32, 4);
      std::memcpy(dst + at, body, c);
      at += c;
    }
  }
  return header(at);
}

}  // extern "C"
