// Zstandard frame decoder (RFC 8878) and CRC-32C, for reading the orbax
// checkpoints of the JAX package on a host without the zstd library.
//
// Covers raw, RLE and compressed blocks; raw, RLE, Huffman (1 or 4
// streams) and treeless literals; predefined, RLE, FSE-compressed and
// repeat sequence tables; the three repeat offsets; skippable and
// concatenated frames, with or without a content size; the XXH64 content
// checksum, verified when a frame carries one. Dictionaries are refused.
// Every read of the input is bounds-checked, and a match may reach back
// only as far as the window and the frame's own output: bad input makes an
// exported function return an error with a message, never read outside
// its buffers. Built with g++ at first use (utils/zstd.py); a plain C ABI
// for ctypes.
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw Error(what); }

int highbit(uint64_t v) {  // index of the highest set bit; v > 0
  return 63 - __builtin_clzll(v);
}

// ---- output: a caller's buffer that must hold the whole result ----------

struct Out {
  uint8_t* buf;
  size_t cap;
  size_t n = 0;
  bool overflow = false;
  void need(size_t k) {
    if (k > cap - n) {
      overflow = true;
      fail("output buffer too small");
    }
  }
  void put(const uint8_t* p, size_t k) {
    need(k);
    std::memcpy(buf + n, p, k);
    n += k;
  }
  void fill(uint8_t b, size_t k) {
    need(k);
    std::memset(buf + n, b, k);
    n += k;
  }
};

// ---- forward reader over the input -------------------------------------

struct In {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  size_t left() const { return n - pos; }
  const uint8_t* take(size_t k, const char* what) {
    if (k > left()) fail(std::string("truncated input: ") + what);
    const uint8_t* r = p + pos;
    pos += k;
    return r;
  }
  uint8_t u8(const char* what) { return *take(1, what); }
  uint64_t le(size_t k, const char* what) {
    const uint8_t* q = take(k, what);
    uint64_t v = 0;
    for (size_t i = 0; i < k; ++i) v |= uint64_t(q[i]) << (8 * i);
    return v;
  }
};

// ---- backward bit reader (FSE and Huffman streams) -----------------------
// Reads from the end of a span towards its start; bits past the start read
// as zeros, and `pos` goes negative, which is how a stream's end is seen.

struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;  // number of bits not yet consumed
  BackBits(const uint8_t* src, size_t len, const char* what) : p(src), n(len) {
    if (len == 0) fail(std::string("empty bitstream: ") + what);
    uint8_t last = src[len - 1];
    if (last == 0) fail(std::string("bitstream without end mark: ") + what);
    pos = int64_t(len) * 8 - (8 - highbit(last));
  }
  uint64_t read(int bits) {
    if (bits == 0) return 0;
    pos -= bits;
    int64_t start = pos;
    int nb = bits;
    int shift = 0;
    if (start < 0) {
      nb += int(start);
      shift = int(-start);
      start = 0;
      if (nb <= 0) return 0;
    }
    int64_t byte = start >> 3;
    int off = int(start & 7);
    if (byte + 8 <= int64_t(n) && nb <= 56) {  // one unaligned 8-byte load
      uint64_t w;
      std::memcpy(&w, p + byte, 8);
      return ((w >> off) & ((uint64_t(1) << nb) - 1)) << shift;
    }
    uint64_t v = 0;
    // bits [start, start + nb) of the little-endian span, near its end
    int got = 0;
    while (got < nb) {
      uint64_t b = (byte < int64_t(n)) ? p[byte] : 0;
      v |= (b >> off) << got;
      got += 8 - off;
      off = 0;
      ++byte;
    }
    if (nb < 64) v &= (uint64_t(1) << nb) - 1;
    return shift >= 64 ? 0 : (v << shift);
  }
};

// ---- forward little-endian bit reader (FSE table descriptions) ----------

struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t bitpos = 0;
  uint32_t read(int bits, const char* what) {
    uint32_t v = 0;
    for (int i = 0; i < bits; ++i) {
      size_t b = bitpos >> 3;
      if (b >= n) fail(std::string("truncated table description: ") + what);
      v |= uint32_t((p[b] >> (bitpos & 7)) & 1) << i;
      ++bitpos;
    }
    return v;
  }
  uint32_t peek(int bits) const {
    uint32_t v = 0;
    for (int i = 0; i < bits; ++i) {
      size_t q = bitpos + i;
      size_t b = q >> 3;
      uint32_t bit = b < n ? (p[b] >> (q & 7)) & 1 : 0;
      v |= bit << i;
    }
    return v;
  }
  size_t bytes() const { return (bitpos + 7) >> 3; }
};

// ---- FSE ----------------------------------------------------------------

struct FSE {
  int log = 0;
  std::vector<uint8_t> sym, nbits;
  std::vector<uint16_t> base;
  bool ready = false;

  void build(const int16_t* norm, int nsym, int accuracy) {
    size_t size = size_t(1) << accuracy;
    log = accuracy;
    sym.assign(size, 0);
    nbits.assign(size, 0);
    base.assign(size, 0);
    std::vector<uint32_t> next(nsym, 0);
    size_t high = size;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] == -1) {
        if (high == 0) fail("corrupt FSE table: too many low symbols");
        sym[--high] = uint8_t(s);
        next[s] = 1;
      }
    }
    size_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] <= 0) continue;
      next[s] = uint32_t(norm[s]);
      for (int i = 0; i < norm[s]; ++i) {
        sym[pos] = uint8_t(s);
        do {
          pos = (pos + step) & mask;
        } while (pos >= high);
      }
    }
    if (pos != 0) fail("corrupt FSE table: spread does not close");
    for (size_t i = 0; i < size; ++i) {
      uint32_t d = next[sym[i]]++;
      int nb = accuracy - highbit(d);
      nbits[i] = uint8_t(nb);
      base[i] = uint16_t((d << nb) - size);
    }
    ready = true;
  }

  void rle(uint8_t s) {
    log = 0;
    sym.assign(1, s);
    nbits.assign(1, 0);
    base.assign(1, 0);
    ready = true;
  }

  // Reads a table description forward from `in`; returns bytes used.
  size_t read(const uint8_t* p, size_t n, int max_log, int max_sym) {
    FwdBits br{p, n};
    int accuracy = int(br.read(4, "FSE accuracy")) + 5;
    if (accuracy > max_log) fail("FSE accuracy log too large");
    int32_t remaining = 1 << accuracy;
    int16_t norm[256];
    int s = 0;
    while (remaining > 0) {
      if (s > max_sym) fail("corrupt FSE table: too many symbols");
      int bits = highbit(uint64_t(remaining) + 1) + 1;
      uint32_t val = br.peek(bits);
      uint32_t lower = (uint32_t(1) << (bits - 1)) - 1;
      uint32_t threshold = (uint32_t(1) << bits) - 1 - uint32_t(remaining + 1);
      if ((val & lower) < threshold) {
        val &= lower;
        br.read(bits - 1, "FSE count");
      } else {
        if (val > lower) val -= threshold;
        br.read(bits, "FSE count");
      }
      int16_t proba = int16_t(int(val) - 1);
      remaining -= proba < 0 ? -proba : proba;
      norm[s++] = proba;
      if (proba == 0) {
        for (;;) {
          uint32_t rep = br.read(2, "FSE zero repeat");
          for (uint32_t i = 0; i < rep; ++i) {
            if (s > max_sym) fail("corrupt FSE table: zero run too long");
            norm[s++] = 0;
          }
          if (rep != 3) break;
        }
      }
    }
    if (remaining != 0) fail("corrupt FSE table: counts do not sum");
    if (br.bytes() > n) fail("truncated FSE table description");
    build(norm, s, accuracy);
    return br.bytes();
  }

  uint32_t init(BackBits& bb) const { return uint32_t(bb.read(log)); }
  uint8_t symbol(uint32_t state) const { return sym[state]; }
  uint32_t update(uint32_t state, BackBits& bb) const {
    return base[state] + uint32_t(bb.read(nbits[state]));
  }
};

// ---- Huffman --------------------------------------------------------------

struct Huffman {
  int max_bits = 0;
  std::vector<uint8_t> sym, nbits;
  bool ready = false;

  void from_weights(const uint8_t* w, int n) {
    // n explicit weights; the last symbol's weight is implied
    if (n < 1 || n > 255) fail("corrupt Huffman weights: bad count");
    uint64_t total = 0;
    for (int i = 0; i < n; ++i) {
      if (w[i] > 11) fail("corrupt Huffman weights: weight too large");
      if (w[i]) total += uint64_t(1) << (w[i] - 1);
    }
    if (total == 0) fail("corrupt Huffman weights: all zero");
    int mb = highbit(total) + 1;
    uint64_t left = (uint64_t(1) << mb) - total;
    if (left == 0 || (left & (left - 1))) fail("corrupt Huffman weights: no valid last weight");
    int last = highbit(left) + 1;
    if (mb > 11) fail("corrupt Huffman weights: code too long");
    std::vector<uint8_t> bits(n + 1);
    for (int i = 0; i < n; ++i) bits[i] = w[i] ? uint8_t(mb + 1 - w[i]) : 0;
    bits[n] = uint8_t(mb + 1 - last);
    max_bits = mb;
    size_t size = size_t(1) << mb;
    sym.assign(size, 0);
    nbits.assign(size, 0);
    uint32_t count[13] = {0}, start[13] = {0};
    for (int i = 0; i <= n; ++i) count[bits[i]]++;
    uint32_t at = 0;
    for (int b = mb; b >= 1; --b) {  // longest codes first, at index 0
      start[b] = at;
      at += count[b] << (mb - b);
    }
    if (at != size) fail("corrupt Huffman weights: codes do not fill the table");
    for (int i = 0; i <= n; ++i) {
      if (!bits[i]) continue;
      uint32_t len = uint32_t(1) << (mb - bits[i]);
      std::memset(&sym[start[bits[i]]], i, len);
      std::memset(&nbits[start[bits[i]]], bits[i], len);
      start[bits[i]] += len;
    }
    ready = true;
  }

  // Reads a tree description; returns bytes used.
  size_t read(const uint8_t* p, size_t n) {
    if (n < 1) fail("truncated Huffman tree description");
    uint8_t header = p[0];
    uint8_t w[256];
    int count = 0;
    if (header >= 128) {
      count = header - 127;
      size_t bytes = (size_t(count) + 1) / 2;
      if (1 + bytes > n) fail("truncated Huffman weights");
      for (int i = 0; i < count; ++i) {
        uint8_t b = p[1 + i / 2];
        w[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
      }
      from_weights(w, count);
      return 1 + bytes;
    }
    size_t csize = header;
    if (csize == 0 || 1 + csize > n) fail("truncated Huffman weights");
    const uint8_t* q = p + 1;
    FSE t;
    size_t used = t.read(q, csize, 6, 255);
    if (used >= csize) fail("corrupt Huffman weights: no bitstream");
    BackBits bb(q + used, csize - used, "Huffman weights");
    uint32_t s1 = t.init(bb), s2 = t.init(bb);
    for (;;) {
      if (count >= 255) fail("corrupt Huffman weights: too many");
      w[count++] = t.symbol(s1);
      s1 = t.update(s1, bb);
      if (bb.pos < 0) {
        if (count >= 255) fail("corrupt Huffman weights: too many");
        w[count++] = t.symbol(s2);
        break;
      }
      if (count >= 255) fail("corrupt Huffman weights: too many");
      w[count++] = t.symbol(s2);
      s2 = t.update(s2, bb);
      if (bb.pos < 0) {
        if (count >= 255) fail("corrupt Huffman weights: too many");
        w[count++] = t.symbol(s1);
        break;
      }
    }
    from_weights(w, count);
    return 1 + csize;
  }

  // One Huffman stream being decoded into dst[0:count].
  struct Lane {
    BackBits bb;
    uint32_t state;
    uint8_t* dst;
    size_t i, count;
  };

  Lane lane(const uint8_t* p, size_t n, uint8_t* dst, size_t count) const {
    BackBits bb(p, n, "Huffman literals");
    uint32_t state = uint32_t(bb.read(max_bits));
    return Lane{bb, state, dst, 0, count};
  }

  // One symbol of `l`, its bits taken from w, the span's bits [base, base + 64).
  void step(Lane& l, uint64_t w, int64_t base, uint32_t mask) const {
    l.dst[l.i++] = sym[l.state];
    int b = nbits[l.state];
    l.bb.pos -= b;
    uint32_t bits = uint32_t((w >> (l.bb.pos - base)) & ((uint64_t(1) << b) - 1));
    l.state = ((l.state << b) | bits) & mask;
  }

  // Decodes the lanes to their ends. While every lane has 4 symbols left and
  // an 8-byte window below its position, the lanes take turns, 4 symbols
  // each per window load (4 x 11 bits fit the >= 57 bits a load leaves),
  // which keeps their dependency chains apart; then each lane alone, the
  // first bytes of its span bit by bit.
  void decode(Lane* lanes, int n) const {
    uint32_t mask = (uint32_t(1) << max_bits) - 1;
    for (;;) {
      uint64_t w[4];
      int64_t base[4];
      bool ready = true;
      for (int k = 0; k < n && ready; ++k) {
        int64_t base_byte = ((lanes[k].bb.pos + 7) >> 3) - 8;
        ready = base_byte >= 0 && lanes[k].count - lanes[k].i >= 4;
        if (ready) {
          std::memcpy(&w[k], lanes[k].bb.p + base_byte, 8);
          base[k] = base_byte * 8;
        }
      }
      if (!ready) break;
      for (int r = 0; r < 4; ++r)
        for (int k = 0; k < n; ++k) step(lanes[k], w[k], base[k], mask);
    }
    for (int k = 0; k < n; ++k) {
      Lane& l = lanes[k];
      while (l.i < l.count) {
        int64_t base_byte = ((l.bb.pos + 7) >> 3) - 8;
        if (base_byte < 0) break;
        uint64_t w;
        std::memcpy(&w, l.bb.p + base_byte, 8);
        int64_t base = base_byte * 8;
        while (l.i < l.count && l.bb.pos - base >= max_bits) step(l, w, base, mask);
      }
      for (; l.i < l.count; ++l.i) {
        l.dst[l.i] = sym[l.state];
        int b = nbits[l.state];
        l.state = ((l.state << b) | uint32_t(l.bb.read(b))) & mask;
      }
      if (l.bb.pos != -int64_t(max_bits)) fail("corrupt Huffman stream: size mismatch");
    }
  }
};

// ---- sequence code tables (RFC 8878 3.1.1.3.2.1) --------------------------

const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,   4,   5,    6,    7,    8,    9,    10,    11,    12,    13,
                              14,  15,  16,   17,   18,   19,   20,   21,    22,    23,    24,
                              25,  26,  27,   28,   29,   30,   31,   32,    33,    34,    35,
                              37,  39,  41,   43,   47,   51,   59,   67,    83,    99,    131,
                              259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

constexpr size_t BLOCK_MAX = 128 * 1024;

// ---- XXH64 -----------------------------------------------------------------

const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
               P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
               P5 = 2870177450012600261ULL;

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}
uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(len);
  while (p + 8 <= end) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- frame decoding ---------------------------------------------------------

struct FrameState {
  Huffman huf;
  FSE ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  uint64_t window = 0;
  size_t start = 0;  // where this frame's output begins
  std::vector<uint8_t> lit;
};

void read_table(FSE& t, int mode, In& in, const int16_t* def, int ndef, int def_log,
                int max_log, int max_sym, const char* name) {
  switch (mode) {
    case 0:
      t.build(def, ndef, def_log);
      break;
    case 1: {
      uint8_t s = in.u8(name);
      if (s > max_sym) fail(std::string("corrupt RLE symbol: ") + name);
      t.rle(s);
      break;
    }
    case 2: {
      size_t used = t.read(in.p + in.pos, in.left(), max_log, max_sym);
      in.take(used, name);
      break;
    }
    default:
      if (!t.ready) fail(std::string("repeat mode without a previous table: ") + name);
  }
}

void literals(FrameState& st, In& in) {
  uint8_t b0 = in.u8("literals header");
  int type = b0 & 3, fmt = (b0 >> 2) & 3;
  std::vector<uint8_t>& lit = st.lit;
  if (type == 0 || type == 1) {
    size_t size;
    if (fmt == 0 || fmt == 2) {
      size = b0 >> 3;
    } else if (fmt == 1) {
      size = (b0 >> 4) + (size_t(in.u8("literals header")) << 4);
    } else {
      size_t b1 = in.u8("literals header"), b2 = in.u8("literals header");
      size = (b0 >> 4) + (b1 << 4) + (b2 << 12);
    }
    if (size > BLOCK_MAX) fail("corrupt literals: too large");
    if (type == 0) {
      const uint8_t* q = in.take(size, "raw literals");
      lit.assign(q, q + size);
    } else {
      lit.assign(size, in.u8("RLE literal"));
    }
    return;
  }
  size_t regen, csize;
  int streams = fmt == 0 ? 1 : 4;
  if (fmt <= 1) {
    uint64_t h = b0 | (in.le(2, "literals header") << 8);
    regen = (h >> 4) & 0x3FF;
    csize = (h >> 14) & 0x3FF;
  } else if (fmt == 2) {
    uint64_t h = b0 | (in.le(3, "literals header") << 8);
    regen = (h >> 4) & 0x3FFF;
    csize = (h >> 18) & 0x3FFF;
  } else {
    uint64_t h = b0 | (in.le(4, "literals header") << 8);
    regen = (h >> 4) & 0x3FFFF;
    csize = (h >> 22) & 0x3FFFF;
  }
  if (regen > BLOCK_MAX) fail("corrupt literals: too large");
  const uint8_t* q = in.take(csize, "compressed literals");
  size_t n = csize;
  if (type == 2) {
    size_t used = st.huf.read(q, n);
    if (used > n) fail("truncated Huffman tree description");
    q += used;
    n -= used;
  } else if (!st.huf.ready) {
    fail("treeless literals without a previous Huffman table");
  }
  lit.resize(regen);
  if (streams == 1) {
    Huffman::Lane one = st.huf.lane(q, n, lit.data(), regen);
    st.huf.decode(&one, 1);
    return;
  }
  if (n < 6) fail("truncated literals jump table");
  size_t s1 = q[0] | (size_t(q[1]) << 8), s2 = q[2] | (size_t(q[3]) << 8),
         s3 = q[4] | (size_t(q[5]) << 8);
  if (6 + s1 + s2 + s3 > n) fail("corrupt literals jump table");
  size_t s4 = n - 6 - s1 - s2 - s3;
  size_t per = (regen + 3) / 4;
  if (3 * per > regen) fail("corrupt literals: too few for four streams");
  const uint8_t* p = q + 6;
  Huffman::Lane four[4] = {
      st.huf.lane(p, s1, lit.data(), per), st.huf.lane(p + s1, s2, lit.data() + per, per),
      st.huf.lane(p + s1 + s2, s3, lit.data() + 2 * per, per),
      st.huf.lane(p + s1 + s2 + s3, s4, lit.data() + 3 * per, regen - 3 * per)};
  st.huf.decode(four, 4);
}

void copy_match(Out& out, FrameState& st, uint64_t offset, uint64_t len) {
  size_t produced = out.n - st.start;
  if (offset == 0) fail("corrupt sequence: zero offset");
  if (offset > produced) fail("corrupt sequence: offset before the frame's start");
  if (offset > st.window) fail("corrupt sequence: offset past the window");
  out.need(len);
  uint8_t* dst = out.buf + out.n;
  const uint8_t* src = dst - offset;
  if (offset >= len) {
    std::memcpy(dst, src, len);
  } else {
    for (uint64_t i = 0; i < len; ++i) dst[i] = src[i];
  }
  out.n += len;
}

void compressed_block(FrameState& st, In& blk, Out& out) {
  literals(st, blk);
  const std::vector<uint8_t>& lit = st.lit;
  uint32_t nseq;
  uint8_t b0 = blk.u8("sequences header");
  if (b0 < 128) {
    nseq = b0;
  } else if (b0 < 255) {
    nseq = ((uint32_t(b0) - 128) << 8) + blk.u8("sequences header");
  } else {
    nseq = uint32_t(blk.le(2, "sequences header")) + 0x7F00;
  }
  if (nseq == 0) {
    if (blk.left() != 0) fail("corrupt block: bytes after an empty sequences section");
    out.put(lit.data(), lit.size());
    return;
  }
  uint8_t modes = blk.u8("sequence modes");
  if (modes & 3) fail("corrupt block: reserved sequence mode bits set");
  read_table(st.ll, modes >> 6, blk, LL_DEFAULT, 36, 6, 9, 35, "literal lengths table");
  read_table(st.of, (modes >> 4) & 3, blk, OF_DEFAULT, 29, 5, 8, 31, "offsets table");
  read_table(st.ml, (modes >> 2) & 3, blk, ML_DEFAULT, 53, 6, 9, 52, "match lengths table");
  BackBits bb(blk.p + blk.pos, blk.left(), "sequences");
  uint32_t sll = st.ll.init(bb), sof = st.of.init(bb), sml = st.ml.init(bb);
  size_t lpos = 0;
  for (uint32_t i = 0; i < nseq; ++i) {
    uint8_t ofc = st.of.symbol(sof), llc = st.ll.symbol(sll), mlc = st.ml.symbol(sml);
    if (ofc > 31 || llc > 35 || mlc > 52) fail("corrupt sequence: bad code");
    uint64_t ofv = (uint64_t(1) << ofc) + bb.read(ofc);
    uint64_t ml = ML_BASE[mlc] + bb.read(ML_BITS[mlc]);
    uint64_t ll = LL_BASE[llc] + bb.read(LL_BITS[llc]);
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      st.rep[2] = st.rep[1];
      st.rep[1] = st.rep[0];
      st.rep[0] = offset;
    } else {
      uint64_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = st.rep[0];
      } else {
        offset = idx < 3 ? st.rep[idx] : st.rep[0] - 1;
        if (idx > 1) st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = offset;
      }
    }
    if (ll > lit.size() - lpos) fail("corrupt sequence: literals overrun");
    out.put(lit.data() + lpos, ll);
    lpos += ll;
    copy_match(out, st, offset, ml);
    if (i + 1 < nseq) {
      sll = st.ll.update(sll, bb);
      sml = st.ml.update(sml, bb);
      sof = st.of.update(sof, bb);
    }
    if (bb.pos < 0) fail("corrupt sequences: bitstream overrun");
  }
  if (bb.pos != 0) fail("corrupt sequences: bitstream not fully consumed");
  out.put(lit.data() + lpos, lit.size() - lpos);
}

// One frame (or skippable frame) starting at in.pos.
void frame(In& in, Out& out) {
  uint32_t magic = uint32_t(in.le(4, "frame magic"));
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    uint32_t size = uint32_t(in.le(4, "skippable frame size"));
    in.take(size, "skippable frame");
    return;
  }
  if (magic != 0xFD2FB528u) fail("not a zstd frame (bad magic)");
  uint8_t fhd = in.u8("frame header");
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      did_flag = fhd & 3;
  if (fhd & 8) fail("corrupt frame header: reserved bit set");
  uint64_t window = 0;
  if (!single) {
    uint8_t wd = in.u8("window descriptor");
    int exponent = wd >> 3, mantissa = wd & 7;
    uint64_t base = uint64_t(1) << (10 + exponent);
    window = base + (base / 8) * mantissa;
  }
  static const int DID_SIZE[4] = {0, 1, 2, 4};
  uint64_t did = in.le(DID_SIZE[did_flag], "dictionary id");
  if (did != 0) fail("frame needs a dictionary, which this decoder does not take");
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  bool has_fcs = fcs_size > 0;
  uint64_t fcs = in.le(fcs_size, "frame content size");
  if (fcs_size == 2) fcs += 256;
  if (single) window = fcs;
  FrameState st;
  st.window = window;
  st.start = out.n;
  if (has_fcs && fcs > out.cap - out.n) {
    out.overflow = true;
    fail("output buffer too small");
  }
  uint64_t block_max = window < BLOCK_MAX ? window : BLOCK_MAX;
  for (;;) {
    uint32_t bh = uint32_t(in.le(3, "block header"));
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail("corrupt block: reserved block type");
    if (type == 0) {
      if (size > block_max) fail("corrupt block: larger than the block maximum");
      out.put(in.take(size, "raw block"), size);
    } else if (type == 1) {
      if (size > block_max) fail("corrupt block: larger than the block maximum");
      out.fill(in.u8("RLE block"), size);
    } else {
      if (size > BLOCK_MAX) fail("corrupt block: larger than the block maximum");
      In blk{in.take(size, "compressed block"), size};
      size_t before = out.n;
      compressed_block(st, blk, out);
      if (out.n - before > block_max) fail("corrupt block: decodes past the block maximum");
    }
    if (last) break;
  }
  size_t produced = out.n - st.start;
  if (has_fcs && produced != fcs) fail("corrupt frame: content size mismatch");
  if (checksum) {
    uint32_t want = uint32_t(in.le(4, "content checksum"));
    uint32_t got = uint32_t(xxh64(out.buf + st.start, produced, 0));
    if (want != got) fail("content checksum mismatch");
  }
}

// ---- CRC-32C (Castagnoli, reflected 0x82F63B78) ------------------------------

struct CrcTable {
  uint32_t t[8][256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int k = 1; k < 8; ++k) t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

const CrcTable CRC;  // filled when the library loads

void set_error(char* err, size_t errlen, const char* what) {
  if (err && errlen) {
    std::strncpy(err, what, errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Decodes every frame of src[0:n] into dst[0:cap]. Returns the bytes
// written; -1 on bad input (message in err), -2 when cap is too small.
long long egtp_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                               char* err, size_t errlen) {
  Out out{dst, cap};
  try {
    In in{src, n};
    while (in.left() > 0) frame(in, out);
    return (long long)out.n;
  } catch (const Error& e) {
    set_error(err, errlen, e.what());
    return out.overflow ? -2 : -1;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// The summed content sizes of src's frames when every frame declares one
// (skippable frames add 0), -1 when one does not, -3 on a bad header.
long long egtp_zstd_content_size(const uint8_t* src, size_t n) {
  try {
    In in{src, n};
    unsigned long long total = 0;
    while (in.left() > 0) {
      uint32_t magic = uint32_t(in.le(4, "frame magic"));
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        in.take(uint32_t(in.le(4, "skippable frame size")), "skippable frame");
        continue;
      }
      if (magic != 0xFD2FB528u) return -3;
      uint8_t fhd = in.u8("frame header");
      int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
      if (!single) in.u8("window descriptor");
      static const int DID_SIZE[4] = {0, 1, 2, 4};
      in.le(DID_SIZE[fhd & 3], "dictionary id");
      int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
      if (fcs_size == 0) return -1;
      uint64_t fcs = in.le(fcs_size, "frame content size");
      if (fcs_size == 2) fcs += 256;
      total += fcs;
      // skip the blocks
      for (;;) {
        uint32_t bh = uint32_t(in.le(3, "block header"));
        size_t size = bh >> 3;
        int type = (bh >> 1) & 3;
        in.take(type == 1 ? 1 : size, "block");
        if (bh & 1) break;
      }
      if ((fhd >> 2) & 1) in.take(4, "content checksum");
    }
    return (long long)total;
  } catch (const std::exception&) {
    return -3;
  }
}

uint32_t egtp_crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  const auto& T = CRC.t;
  crc = ~crc;
  while (n >= 8) {
    uint32_t lo = crc ^ rd32(p), hi = rd32(p + 4);
    crc = T[7][lo & 0xFF] ^ T[6][(lo >> 8) & 0xFF] ^
          T[5][(lo >> 16) & 0xFF] ^ T[4][lo >> 24] ^
          T[3][hi & 0xFF] ^ T[2][(hi >> 8) & 0xFF] ^
          T[1][(hi >> 16) & 0xFF] ^ T[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ T[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

}  // extern "C"
