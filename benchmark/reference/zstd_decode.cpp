// A zstd frame decoder (RFC 8878), for the host: the chunks and B+tree
// nodes of the orbax checkpoints that the repository ships are zstd
// frames, and the machines that run the port may have no zstd library.
//
// Covered: raw, RLE and compressed blocks; literals raw, RLE, Huffman with
// one and four streams, and treeless (the previous block's Huffman table);
// sequences with predefined, RLE, FSE-compressed and repeat tables; the
// three repeat offsets; single-segment and windowed frames; concatenated
// frames, with skippable frames skipped; the XXH64 content checksum where
// the frame descriptor sets it.  Dictionaries are not: a frame that names
// one fails.
//
// The whole output lies in one caller-owned buffer, so a match may reach
// back to the start of its frame.  Every read of the input and every write
// of the output is bounds-checked; corrupt or truncated input ends the call
// with an error code, never a crash.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 zstd_decode.cpp -o libzstd_decode.so

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Code : int {
  kOk = 0,
  kTruncated = 1,       // input ends inside a frame
  kBadMagic = 2,        // neither a zstd nor a skippable frame
  kReservedBit = 3,     // a reserved field is set
  kDictionary = 4,      // the frame names a dictionary
  kBlockType = 5,       // reserved block type
  kBlockSize = 6,       // block larger than the format allows
  kLiterals = 7,        // malformed literals section
  kHuffman = 8,         // malformed Huffman table or stream
  kFse = 9,             // malformed FSE table or stream
  kSequences = 10,      // malformed sequences section
  kOffset = 11,         // a match reaches before the frame's start
  kDstTooSmall = 12,    // output larger than the caller's buffer
  kContentSize = 13,    // frame output differs from its content size
  kChecksum = 14,       // XXH64 content checksum differs
  kNoTable = 15,        // repeat/treeless mode without an earlier table
  kMemory = 16,         // a table could not be allocated
};

const char* const kNames[] = {
    "ok", "truncated input", "bad magic number", "reserved bit set",
    "dictionary frames are not supported", "reserved block type",
    "block too large", "corrupt literals section", "corrupt Huffman table or stream",
    "corrupt FSE table or stream", "corrupt sequences section",
    "match offset before the start of the frame", "output larger than the buffer",
    "frame content size mismatch", "content checksum mismatch",
    "repeat or treeless mode without an earlier table", "out of memory",
};

struct Fail {
  int code;
};

[[noreturn]] void fail(int code) { throw Fail{code}; }

constexpr size_t kBlockMax = 128 * 1024;

inline uint32_t highbit(uint32_t v) {  // v > 0
  return 31u - static_cast<uint32_t>(__builtin_clz(v));
}

uint32_t read_le(const uint8_t* p, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; ++i) v |= static_cast<uint32_t>(p[i]) << (8 * i);
  return v;
}

uint64_t read_le64(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= static_cast<uint64_t>(p[i]) << (8 * i);
  return v;
}

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xxmerge(uint64_t acc, uint64_t v) { return (acc ^ xxround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxround(v1, read_le64(p, 8));
      v2 = xxround(v2, read_le64(p + 8, 8));
      v3 = xxround(v3, read_le64(p + 16, 8));
      v4 = xxround(v4, read_le64(p + 24, 8));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxmerge(h, v1);
    h = xxmerge(h, v2);
    h = xxmerge(h, v3);
    h = xxmerge(h, v4);
  } else {
    h = P5;
  }
  h += static_cast<uint64_t>(n);
  while (end - p >= 8) {
    h ^= xxround(0, read_le64(p, 8));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= static_cast<uint64_t>(read_le(p, 4)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= static_cast<uint64_t>(*p) * P5;
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

// ---------------------------------------------------------- bit readers

// Forward, least significant bit first: FSE table descriptions.
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // bits consumed
  FwdBits(const uint8_t* src, size_t size) : p(src), n(size) {}
  uint32_t read(int nb, int err) {
    if (pos + static_cast<size_t>(nb) > n * 8) fail(err);
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i, ++pos) v |= static_cast<uint32_t>((p[pos >> 3] >> (pos & 7)) & 1u) << i;
    return v;
  }
  size_t bytes() const { return (pos + 7) >> 3; }
};

// Backward: Huffman streams, FSE-coded weights and the sequences.  The
// stream is one little-endian number whose highest set bit marks its end;
// bits are read from just below that mark towards bit 0.  `left` counts
// the bits not yet read; reads past bit 0 give zeros and leave `left`
// negative, which the callers check.
struct BackBits {
  const uint8_t* p;
  int64_t n;
  int64_t left;
  BackBits(const uint8_t* src, size_t size, int err) : p(src), n(static_cast<int64_t>(size)) {
    if (size == 0 || src[size - 1] == 0) fail(err);
    left = (n - 1) * 8 + highbit(src[size - 1]);
  }
  // bits [left - nb, left), nb <= 56
  uint64_t peek(int nb) const {
    if (nb == 0) return 0;
    int64_t lo = left - nb;
    if (lo < 0) {
      if (left <= 0) return 0;
      return bits_at(0, static_cast<int>(left)) << (-lo);
    }
    return bits_at(lo, nb);
  }
  uint64_t bits_at(int64_t lo, int nb) const {  // lo >= 0, lo + nb <= 8 * n
    int64_t byte = lo >> 3;
    uint64_t v;
    if (byte + 8 <= n) {
      std::memcpy(&v, p + byte, 8);  // x86-64 and aarch64 linux: little-endian
    } else {
      v = read_le64(p + byte, static_cast<int>(n - byte));
    }
    return (v >> (lo & 7)) & ((1ULL << nb) - 1);
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    left -= nb;
    return v;
  }
};

// ------------------------------------------------------------------ FSE

struct FseEntry {
  uint16_t symbol;
  uint8_t nb;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
  bool ok = false;
};

void build_fse(FseTable& tab, const int16_t* norm, int max_symbol, int log) {
  const uint32_t size = 1u << log;
  tab.t.assign(size, FseEntry{0, 0, 0});
  tab.log = log;
  std::vector<uint32_t> next(max_symbol + 1);
  int64_t high = static_cast<int64_t>(size) - 1;
  for (int s = 0; s <= max_symbol; ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail(kFse);
      tab.t[high--].symbol = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint32_t>(norm[s]);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s <= max_symbol; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      tab.t[pos].symbol = static_cast<uint16_t>(s);
      do {
        pos = (pos + step) & mask;
      } while (static_cast<int64_t>(pos) > high);
    }
  }
  if (pos != 0) fail(kFse);
  for (uint32_t u = 0; u < size; ++u) {
    uint32_t s = tab.t[u].symbol;
    uint32_t x = next[s]++;
    if (x == 0) fail(kFse);
    int nb = log - static_cast<int>(highbit(x));
    tab.t[u].nb = static_cast<uint8_t>(nb);
    tab.t[u].base = static_cast<uint16_t>((x << nb) - size);
  }
  tab.ok = true;
}

void build_rle(FseTable& tab, int symbol) {
  tab.log = 0;
  tab.t.assign(1, FseEntry{static_cast<uint16_t>(symbol), 0, 0});
  tab.ok = true;
}

// An FSE table description; returns the bytes it takes.
size_t read_fse(FseTable& tab, const uint8_t* src, size_t n, int max_symbol, int max_log) {
  FwdBits br(src, n);
  const int log = static_cast<int>(br.read(4, kFse)) + 5;
  if (log > max_log) fail(kFse);
  std::vector<int16_t> norm(max_symbol + 1, 0);
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nb = log + 1;
  int s = 0;
  bool prev0 = false;
  while (remaining > 1) {
    if (prev0) {
      int rep = static_cast<int>(br.read(2, kFse));
      int zeros = rep;
      while (rep == 3) {
        rep = static_cast<int>(br.read(2, kFse));
        zeros += rep;
      }
      s += zeros;
      if (s > max_symbol) fail(kFse);
      prev0 = false;
      continue;
    }
    if (s > max_symbol) fail(kFse);
    const int max = (2 * threshold - 1) - remaining;
    int count = static_cast<int>(br.read(nb - 1, kFse));
    if (count >= max) {
      count += static_cast<int>(br.read(1, kFse)) << (nb - 1);
      if (count >= threshold) count -= max;
    }
    count -= 1;  // -1 is a probability "less than one"
    remaining -= count < 0 ? -count : count;
    norm[s++] = static_cast<int16_t>(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || s == 0) fail(kFse);
  build_fse(tab, norm.data(), s - 1, log);
  return br.bytes();
}

struct FseState {
  const FseTable* tab;
  uint32_t state;
  void init(BackBits& br) {
    state = static_cast<uint32_t>(br.read(tab->log));
  }
  uint32_t symbol() const { return tab->t[state].symbol; }
  void update(BackBits& br) {
    const FseEntry& e = tab->t[state];
    state = e.base + static_cast<uint32_t>(br.read(e.nb));
  }
};

// -------------------------------------------------------------- Huffman

constexpr int kHufMaxBits = 11;

struct HufTable {
  int bits = 0;
  std::vector<uint16_t> t;  // symbol | (code length << 8)
  bool ok = false;
};

// A Huffman tree description; returns the bytes it takes.
size_t read_huffman(HufTable& huf, const uint8_t* src, size_t n) {
  if (n < 1) fail(kHuffman);
  uint8_t weights[256] = {0};
  int count = 0;
  size_t used;
  const uint32_t header = src[0];
  if (header < 128) {
    // FSE-coded weights, two interleaved states
    used = 1 + header;
    if (header == 0 || used > n) fail(kHuffman);
    FseTable tab;
    size_t desc = read_fse(tab, src + 1, header, 15, 6);
    if (desc >= header) fail(kHuffman);
    BackBits br(src + 1 + desc, header - desc, kHuffman);
    FseState s1{&tab, 0}, s2{&tab, 0};
    s1.init(br);
    s2.init(br);
    if (br.left < 0) fail(kHuffman);
    while (true) {
      if (count >= 255) fail(kHuffman);
      weights[count++] = static_cast<uint8_t>(s1.symbol());
      s1.update(br);
      if (br.left < 0) {
        if (count >= 255) fail(kHuffman);
        weights[count++] = static_cast<uint8_t>(s2.symbol());
        break;
      }
      if (count >= 255) fail(kHuffman);
      weights[count++] = static_cast<uint8_t>(s2.symbol());
      s2.update(br);
      if (br.left < 0) {
        if (count >= 255) fail(kHuffman);
        weights[count++] = static_cast<uint8_t>(s1.symbol());
        break;
      }
    }
  } else {
    count = static_cast<int>(header) - 127;
    used = 1 + (static_cast<size_t>(count) + 1) / 2;
    if (used > n) fail(kHuffman);
    for (int i = 0; i < count; ++i) {
      const uint8_t b = src[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  }
  // the last symbol's weight fills the sum up to the next power of two
  uint32_t total = 0;
  for (int i = 0; i < count; ++i) {
    if (weights[i] > kHufMaxBits + 1) fail(kHuffman);
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail(kHuffman);
  const int bits = static_cast<int>(highbit(total)) + 1;
  if (bits > kHufMaxBits) fail(kHuffman);
  const uint32_t rest = (1u << bits) - total;
  if (rest & (rest - 1)) fail(kHuffman);
  weights[count++] = static_cast<uint8_t>(highbit(rest) + 1);
  // canonical codes: lowest weight first, then symbol order
  huf.bits = bits;
  huf.t.assign(static_cast<size_t>(1) << bits, 0);
  uint32_t pos = 0;
  for (int w = 1; w <= bits; ++w) {
    const uint32_t span = 1u << (w - 1);
    const uint16_t entry_len = static_cast<uint16_t>((bits + 1 - w) << 8);
    for (int s = 0; s < count; ++s) {
      if (weights[s] != w) continue;
      if (pos + span > huf.t.size()) fail(kHuffman);
      for (uint32_t k = 0; k < span; ++k) huf.t[pos + k] = static_cast<uint16_t>(s) | entry_len;
      pos += span;
    }
  }
  if (pos != huf.t.size()) fail(kHuffman);
  huf.ok = true;
  return used;
}

// One Huffman-coded stream of literals being decoded into dst[0..count).
struct HufStream {
  BackBits br;
  uint8_t* dst;
  size_t count;
  size_t i = 0;
  HufStream(const uint8_t* src, size_t n, uint8_t* out, size_t cnt)
      : br(src, n, kHuffman), dst(out), count(cnt) {}
  bool fast() const { return count - i >= 5 && br.left >= 64; }
  // five codes (at most 55 bits) from one 8-byte load holding 57 to 64 of
  // the bits just below `left`; only while fast()
  void five(const uint16_t* t, int bits) {
    const int64_t byte = (br.left - 64 + 7) >> 3;
    uint64_t c;
    std::memcpy(&c, br.p + byte, 8);
    int avail = static_cast<int>(br.left - byte * 8);
    const uint64_t mask = (1ULL << bits) - 1;
    for (int k = 0; k < 5; ++k) {
      const uint16_t e = t[(c >> (avail - bits)) & mask];
      dst[i++] = static_cast<uint8_t>(e & 0xFF);
      avail -= e >> 8;
    }
    br.left = byte * 8 + avail;
  }
  // the rest, code by code; the stream must end exactly at its first bit
  void finish(const uint16_t* t, int bits) {
    while (fast()) five(t, bits);
    for (; i < count; ++i) {
      const uint16_t e = t[br.peek(bits)];
      dst[i] = static_cast<uint8_t>(e & 0xFF);
      br.left -= e >> 8;
    }
    if (br.left != 0) fail(kHuffman);
  }
};

void huffman_1stream(const HufTable& huf, const uint8_t* src, size_t n, uint8_t* dst,
                     size_t count) {
  HufStream(src, n, dst, count).finish(huf.t.data(), huf.bits);
}

// Four streams, interleaved while all four have codes and bits to spare:
// four independent chains of table lookups instead of one.
void huffman_4streams(const HufTable& huf, const uint8_t* src, const size_t* sizes,
                      uint8_t* dst, const size_t* counts) {
  const uint16_t* t = huf.t.data();
  const int bits = huf.bits;
  HufStream s0(src, sizes[0], dst, counts[0]);
  HufStream s1(src + sizes[0], sizes[1], dst + counts[0], counts[1]);
  HufStream s2(src + sizes[0] + sizes[1], sizes[2], dst + counts[0] + counts[1], counts[2]);
  HufStream s3(src + sizes[0] + sizes[1] + sizes[2], sizes[3],
               dst + counts[0] + counts[1] + counts[2], counts[3]);
  while (s0.fast() && s1.fast() && s2.fast() && s3.fast()) {
    s0.five(t, bits);
    s1.five(t, bits);
    s2.five(t, bits);
    s3.five(t, bits);
  }
  s0.finish(t, bits);
  s1.finish(t, bits);
  s2.finish(t, bits);
  s3.finish(t, bits);
}

// ------------------------------------------------------------ sequences

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,    9,    10,   11,
                              12, 13, 14, 15, 16, 18, 20, 22, 24,   28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Frame {
  uint8_t* dst;
  size_t cap;
  size_t out;          // bytes written into dst, all frames
  size_t frame_start;  // where this frame's output starts
  uint32_t rep[3] = {1, 4, 8};
  HufTable huf;
  FseTable ll, of, ml;
  std::vector<uint8_t> lits;
};

// One table of the sequences section; returns the bytes its description takes.
size_t sequence_table(FseTable& tab, int mode, const uint8_t* src, size_t n, const int16_t* dflt,
                      int dflt_max, int dflt_log, int max_symbol, int max_log) {
  switch (mode) {
    case 0:
      build_fse(tab, dflt, dflt_max, dflt_log);
      return 0;
    case 1:
      if (n < 1 || src[0] > max_symbol) fail(kSequences);
      build_rle(tab, src[0]);
      return 1;
    case 2:
      return read_fse(tab, src, n, max_symbol, max_log);
    default:
      if (!tab.ok) fail(kNoTable);
      return 0;
  }
}

void copy_literals(Frame& f, const uint8_t*& lit, const uint8_t* lit_end, size_t k) {
  if (static_cast<size_t>(lit_end - lit) < k) fail(kSequences);
  if (f.cap - f.out < k) fail(kDstTooSmall);
  std::memcpy(f.dst + f.out, lit, k);
  f.out += k;
  lit += k;
}

void copy_match(Frame& f, size_t offset, size_t len) {
  if (offset == 0 || offset > f.out - f.frame_start) fail(kOffset);
  if (f.cap - f.out < len) fail(kDstTooSmall);
  uint8_t* d = f.dst + f.out;
  const uint8_t* s = d - offset;
  if (offset >= len) {
    std::memcpy(d, s, len);
  } else {
    for (size_t i = 0; i < len; ++i) d[i] = s[i];  // overlapping: repeats the last `offset` bytes
  }
  f.out += len;
}

void compressed_block(Frame& f, const uint8_t* src, size_t n) {
  const size_t block_start = f.out;
  // ---- literals section
  if (n < 1) fail(kLiterals);
  const int ltype = src[0] & 3, sfmt = (src[0] >> 2) & 3;
  size_t regen = 0, csize = 0, hsize = 0;
  int streams = 1;
  const uint8_t* lit = nullptr;
  if (ltype < 2) {
    if (sfmt == 0 || sfmt == 2) {
      hsize = 1;
      regen = src[0] >> 3;
    } else if (sfmt == 1) {
      hsize = 2;
      if (n < 2) fail(kLiterals);
      regen = (src[0] >> 4) + (static_cast<size_t>(src[1]) << 4);
    } else {
      hsize = 3;
      if (n < 3) fail(kLiterals);
      regen = (src[0] >> 4) + (static_cast<size_t>(src[1]) << 4) + (static_cast<size_t>(src[2]) << 12);
    }
    if (regen > kBlockMax) fail(kLiterals);
    if (ltype == 0) {
      if (n - hsize < regen) fail(kLiterals);
      lit = src + hsize;
      csize = regen;
    } else {
      if (n - hsize < 1) fail(kLiterals);
      f.lits.assign(regen, src[hsize]);
      lit = f.lits.data();
      csize = 1;
    }
  } else {
    int field;
    if (sfmt == 0 || sfmt == 1) {
      hsize = 3;
      field = 10;
      streams = sfmt == 0 ? 1 : 4;
    } else {
      hsize = sfmt == 2 ? 4 : 5;
      field = sfmt == 2 ? 14 : 18;
      streams = 4;
    }
    if (n < hsize) fail(kLiterals);
    const uint64_t h = read_le64(src, static_cast<int>(hsize));
    const uint64_t mask = (1ULL << field) - 1;
    regen = static_cast<size_t>((h >> 4) & mask);
    csize = static_cast<size_t>((h >> (4 + field)) & mask);
    if (regen > kBlockMax || csize > n - hsize) fail(kLiterals);
    const uint8_t* p = src + hsize;
    size_t left = csize;
    if (ltype == 2) {
      const size_t used = read_huffman(f.huf, p, left);
      p += used;
      left -= used;
    } else if (!f.huf.ok) {
      fail(kNoTable);
    }
    f.lits.resize(regen);
    if (streams == 1) {
      huffman_1stream(f.huf, p, left, f.lits.data(), regen);
    } else {
      if (left < 6 || regen < 6) fail(kLiterals);
      const size_t s1 = read_le(p, 2), s2 = read_le(p + 2, 2), s3 = read_le(p + 4, 2);
      if (s1 + s2 + s3 > left - 6) fail(kLiterals);
      const size_t s4 = left - 6 - s1 - s2 - s3;
      const size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail(kLiterals);
      const size_t sizes[4] = {s1, s2, s3, s4};
      const size_t counts[4] = {seg, seg, seg, regen - 3 * seg};
      huffman_4streams(f.huf, p + 6, sizes, f.lits.data(), counts);
    }
    lit = f.lits.data();
  }
  const uint8_t* lit_end = lit + regen;
  const uint8_t* p = src + hsize + csize;
  size_t left = n - hsize - csize;
  // ---- sequences section
  if (left < 1) fail(kSequences);
  size_t nseq = p[0];
  size_t used = 1;
  if (nseq >= 128) {
    if (nseq == 255) {
      if (left < 3) fail(kSequences);
      nseq = p[1] + (static_cast<size_t>(p[2]) << 8) + 0x7F00;
      used = 3;
    } else {
      if (left < 2) fail(kSequences);
      nseq = ((nseq - 128) << 8) + p[1];
      used = 2;
    }
  }
  p += used;
  left -= used;
  if (nseq == 0) {
    if (left != 0) fail(kSequences);
    copy_literals(f, lit, lit_end, static_cast<size_t>(lit_end - lit));
    if (f.out - block_start > kBlockMax) fail(kBlockSize);
    return;
  }
  if (left < 1) fail(kSequences);
  const uint8_t modes = p[0];
  if (modes & 3) fail(kReservedBit);
  ++p;
  --left;
  used = sequence_table(f.ll, modes >> 6, p, left, kLLDefault, 35, 6, 35, 9);
  p += used;
  left -= used;
  used = sequence_table(f.of, (modes >> 4) & 3, p, left, kOFDefault, 28, 5, 31, 8);
  p += used;
  left -= used;
  used = sequence_table(f.ml, (modes >> 2) & 3, p, left, kMLDefault, 52, 6, 52, 9);
  p += used;
  left -= used;
  BackBits br(p, left, kSequences);
  FseState sll{&f.ll, 0}, sof{&f.of, 0}, sml{&f.ml, 0};
  sll.init(br);
  sof.init(br);
  sml.init(br);
  for (size_t i = 0; i < nseq; ++i) {
    const uint32_t llc = sll.symbol(), ofc = sof.symbol(), mlc = sml.symbol();
    if (llc > 35 || mlc > 52 || ofc > 31) fail(kSequences);
    // extra bits: offset, then match length, then literal length
    const uint64_t ofv = (1ULL << ofc) + br.read(static_cast<int>(ofc));
    const size_t mlen = kMLBase[mlc] + static_cast<size_t>(br.read(kMLBits[mlc]));
    const size_t llen = kLLBase[llc] + static_cast<size_t>(br.read(kLLBits[llc]));
    size_t offset;
    if (ofv > 3) {
      offset = static_cast<size_t>(ofv - 3);
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = static_cast<uint32_t>(offset);
    } else {
      const uint32_t idx = static_cast<uint32_t>(ofv) - (llen != 0 ? 1u : 0u);
      if (idx == 0) {
        offset = f.rep[0];
      } else {
        const uint32_t r = idx == 3 ? f.rep[0] - 1 : f.rep[idx];
        if (idx != 1) f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = r;
        offset = r;
      }
    }
    if (i + 1 < nseq) {  // states update in the order literal length, match length, offset
      sll.update(br);
      sml.update(br);
      sof.update(br);
    }
    if (br.left < 0) fail(kSequences);
    copy_literals(f, lit, lit_end, llen);
    copy_match(f, offset, mlen);
  }
  if (br.left != 0) fail(kSequences);
  copy_literals(f, lit, lit_end, static_cast<size_t>(lit_end - lit));
  if (f.out - block_start > kBlockMax) fail(kBlockSize);
}

// One frame at src[0..n); returns the bytes it takes.
size_t frame(Frame& f, const uint8_t* src, size_t n) {
  if (n < 5) fail(kTruncated);
  const uint8_t fhd = src[4];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
            did_flag = fhd & 3;
  if (fhd & 8) fail(kReservedBit);
  size_t pos = 5;
  uint64_t window = 0;
  if (!single) {
    if (pos >= n) fail(kTruncated);
    const uint8_t wd = src[pos++];
    const int wlog = 10 + (wd >> 3);
    const uint64_t base = 1ULL << wlog;
    window = base + (base / 8) * (wd & 7);
  }
  const int did_size[4] = {0, 1, 2, 4};
  if (n - pos < static_cast<size_t>(did_size[did_flag])) fail(kTruncated);
  if (did_flag && read_le(src + pos, did_size[did_flag]) != 0) fail(kDictionary);
  pos += did_size[did_flag];
  const int fcs_size[4] = {single ? 1 : 0, 2, 4, 8};
  const int fsz = fcs_size[fcs_flag];
  bool has_fcs = fsz > 0;
  uint64_t fcs = 0;
  if (has_fcs) {
    if (n - pos < static_cast<size_t>(fsz)) fail(kTruncated);
    fcs = read_le64(src + pos, fsz) + (fsz == 2 ? 256 : 0);
    pos += fsz;
  }
  if (single) window = fcs;
  const size_t block_max = static_cast<size_t>(window < kBlockMax ? window : kBlockMax);
  f.frame_start = f.out;
  f.rep[0] = 1;
  f.rep[1] = 4;
  f.rep[2] = 8;
  f.huf.ok = f.ll.ok = f.of.ok = f.ml.ok = false;
  if (has_fcs && fcs > f.cap - f.out) fail(kDstTooSmall);
  while (true) {
    if (n - pos < 3) fail(kTruncated);
    const uint32_t bh = read_le(src + pos, 3);
    pos += 3;
    const int last = bh & 1, type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (size > block_max) fail(kBlockSize);
    if (type == 0) {
      if (n - pos < size) fail(kTruncated);
      if (f.cap - f.out < size) fail(kDstTooSmall);
      std::memcpy(f.dst + f.out, src + pos, size);
      f.out += size;
      pos += size;
    } else if (type == 1) {
      if (n - pos < 1) fail(kTruncated);
      if (f.cap - f.out < size) fail(kDstTooSmall);
      std::memset(f.dst + f.out, src[pos], size);
      f.out += size;
      pos += 1;
    } else if (type == 2) {
      if (n - pos < size) fail(kTruncated);
      compressed_block(f, src + pos, size);
      pos += size;
    } else {
      fail(kBlockType);
    }
    if (last) break;
  }
  const size_t produced = f.out - f.frame_start;
  if (has_fcs && produced != fcs) fail(kContentSize);
  if (checksum) {
    if (n - pos < 4) fail(kTruncated);
    const uint32_t want = read_le(src + pos, 4);
    const uint32_t got = static_cast<uint32_t>(xxh64(f.dst + f.frame_start, produced));
    if (want != got) fail(kChecksum);
    pos += 4;
  }
  return pos;
}

constexpr uint32_t kMagic = 0xFD2FB528u;

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

}  // namespace

extern "C" {

// The sum of the content sizes that the frames at src[0..n) state:
// >= 0 where every zstd frame states its size, -1 where one does not, and
// -(1 + code) where the input is malformed before its first block.
int64_t zstd_frames_content_size(const uint8_t* src, size_t n) {
  size_t pos = 0;
  uint64_t total = 0;
  bool known = true;
  if (n == 0) return -(1 + kTruncated);
  while (pos < n) {
    if (n - pos < 8) return -(1 + kTruncated);
    const uint32_t magic = read_le(src + pos, 4);
    if (skippable(magic)) {
      const uint64_t size = read_le(src + pos + 4, 4);
      if (size > n - pos - 8) return -(1 + kTruncated);
      pos += 8 + size;
      continue;
    }
    if (magic != kMagic) return -(1 + kBadMagic);
    const uint8_t fhd = src[pos + 4];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did_flag = fhd & 3;
    const int did_size[4] = {0, 1, 2, 4};
    const int fcs_size[4] = {single ? 1 : 0, 2, 4, 8};
    const size_t hpos = pos + 5 + (single ? 0 : 1) + did_size[did_flag];
    const int fsz = fcs_size[fcs_flag];
    if (fsz == 0) {
      known = false;
      break;  // the frame's end is only found by decoding it
    }
    if (hpos + fsz > n) return -(1 + kTruncated);
    total += read_le64(src + hpos, fsz) + (fsz == 2 ? 256 : 0);
    // find the frame's end by walking its block headers
    size_t bpos = hpos + fsz;
    while (true) {
      if (n - bpos < 3) return -(1 + kTruncated);
      const uint32_t bh = read_le(src + bpos, 3);
      const size_t size = (bh >> 1 & 3) == 1 ? 1 : bh >> 3;
      if (n - bpos - 3 < size) return -(1 + kTruncated);
      bpos += 3 + size;
      if (bh & 1) break;
    }
    if ((fhd >> 2) & 1) bpos += 4;
    if (bpos > n) return -(1 + kTruncated);
    pos = bpos;
  }
  return known ? static_cast<int64_t>(total) : -1;
}

// Decode every frame at src[0..n) into dst[0..cap); *out_n gets the bytes
// written.  Returns 0 or an error code (zstd_error_name names it).
int zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* out_n) {
  Frame f;
  f.dst = dst;
  f.cap = cap;
  f.out = 0;
  f.frame_start = 0;
  *out_n = 0;
  try {
    if (n == 0) fail(kTruncated);
    size_t pos = 0;
    while (pos < n) {
      if (n - pos < 4) fail(kTruncated);
      const uint32_t magic = read_le(src + pos, 4);
      if (skippable(magic)) {
        if (n - pos < 8) fail(kTruncated);
        const uint64_t size = read_le(src + pos + 4, 4);
        if (size > n - pos - 8) fail(kTruncated);
        pos += 8 + size;
        continue;
      }
      if (magic != kMagic) fail(kBadMagic);
      pos += frame(f, src + pos, n - pos);
    }
  } catch (const Fail& e) {
    *out_n = f.out;
    return e.code;
  } catch (const std::bad_alloc&) {  // a table's vector
    *out_n = f.out;
    return kMemory;
  }
  *out_n = f.out;
  return kOk;
}

const char* zstd_error_name(int code) {
  if (code < 0 || code >= static_cast<int>(sizeof(kNames) / sizeof(kNames[0]))) return "unknown error";
  return kNames[code];
}

}  // extern "C"
