// Host-side entropy coding of the camera intake (frontend/jpeg.py,
// frontend/png.py): the work that is sequential by nature.
//
//   jpeg_decode_scan  baseline sequential Huffman decoding of one scan
//                     (ITU T.81 F.2.2): the bit reader with its 0xFF00
//                     stuffing, the canonical Huffman tables, the DC
//                     prediction and the RSTn restart intervals; writes
//                     each block's int16 coefficients in natural order.
//   jpeg_encode_scan  the inverse (F.1.2), for the bag writer's encoder.
//   png_unfilter      the five PNG row filters (Sub, Average and Paeth run
//                     along a row).
//
// A plain C interface loaded with ctypes; built with g++ at first use by
// frontend/native.py. Every function returns a negative code on malformed
// input and never reads or writes outside the sizes it is given.

#include <cstdint>
#include <cstdlib>

namespace {

// zigzag index -> natural (row-major) index within the 8x8 block
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

enum {
  kErrTable = -1,     // an over-subscribed or missing Huffman table
  kErrCode = -2,      // a bit pattern that is no code of the table
  kErrIndex = -3,     // a run past the 64th coefficient
  kErrRestart = -4,   // a restart marker missing or out of sequence
  kErrOverflow = -5,  // the encoder's output buffer is too small
  kErrFilter = -6,    // a PNG filter type other than 0..4
};

// One DHT table: counts[l-1] codes of length l, then the symbols.
struct DecodeTable {
  int32_t maxcode[17];  // largest code of length l, -1 where there is none
  int32_t valptr[17];
  int32_t mincode[17];
  const uint8_t* vals;
  int nvals;
};

bool build_decode(DecodeTable* t, const uint8_t* counts, const uint8_t* vals) {
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    t->valptr[l] = k;
    t->mincode[l] = code;
    code += counts[l - 1];
    k += counts[l - 1];
    t->maxcode[l] = counts[l - 1] ? code - 1 : -1;
    if (code > (1 << l)) return false;
    code <<= 1;
  }
  t->vals = vals;
  t->nvals = k;
  return k > 0 && k <= 256;
}

// MSB-first bit reader. A marker (0xFF followed by anything but 0x00) is
// not consumed: past it, and past the end, it feeds zero bits as libjpeg
// does.
struct BitReader {
  const uint8_t* p;
  long n;
  long pos;
  uint64_t buf;
  int bits;
  bool at_marker;

  void fill() {
    while (bits <= 56) {
      uint64_t b = 0;
      if (!at_marker && pos < n) {
        b = p[pos];
        if (b == 0xFF) {
          if (pos + 1 < n && p[pos + 1] == 0x00) {
            pos += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          pos += 1;
        }
      }
      buf |= b << (56 - bits);
      bits += 8;
    }
  }
  uint32_t peek16() {
    if (bits < 16) fill();
    return static_cast<uint32_t>(buf >> 48);
  }
  void skip(int nb) {
    buf <<= nb;
    bits -= nb;
  }
  int32_t get(int nb) {
    if (nb == 0) return 0;
    if (bits < nb) fill();
    int32_t v = static_cast<int32_t>(buf >> (64 - nb));
    skip(nb);
    return v;
  }
};

int decode_symbol(BitReader* br, const DecodeTable* t) {
  uint32_t look = br->peek16();
  for (int l = 1; l <= 16; ++l) {
    int32_t code = static_cast<int32_t>(look >> (16 - l));
    if (code <= t->maxcode[l]) {
      int idx = t->valptr[l] + code - t->mincode[l];
      if (idx >= t->nvals) return kErrCode;
      br->skip(l);
      return t->vals[idx];
    }
  }
  return kErrCode;
}

int32_t extend(int32_t v, int s) {
  return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
}

// comp rows of the scan's components, six int32 each
struct Comp {
  int32_t h, v, dc, ac, stride, offset;
};

int decode_block(BitReader* br, const DecodeTable* dc, const DecodeTable* ac,
                 int32_t* pred, int16_t* out) {
  int s = decode_symbol(br, dc);
  if (s < 0) return s;
  if (s > 16) return kErrCode;
  *pred += extend(br->get(s), s);
  out[0] = static_cast<int16_t>(*pred);
  for (int k = 1; k < 64;) {
    int rs = decode_symbol(br, ac);
    if (rs < 0) return rs;
    int r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      if (k > 63) return kErrIndex;
      out[kNatural[k]] = static_cast<int16_t>(extend(br->get(sz), sz));
      k += 1;
    } else if (r == 15) {
      k += 16;
    } else {
      break;
    }
  }
  return 0;
}

// Huffman code and length of each symbol (T.81 Annex C).
struct EncodeTable {
  uint16_t code[256];
  uint8_t size[256];
};

bool build_encode(EncodeTable* t, const uint8_t* counts, const uint8_t* vals) {
  for (int i = 0; i < 256; ++i) t->size[i] = 0;
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
      if (k >= 256) return false;
      t->code[vals[k]] = static_cast<uint16_t>(code);
      t->size[vals[k]] = static_cast<uint8_t>(l);
    }
    if (code > (1 << l)) return false;
    code <<= 1;
  }
  return true;
}

struct BitWriter {
  uint8_t* out;
  long cap;
  long pos;
  uint32_t acc;
  int bits;
  bool overflow;

  void byte(uint8_t b) {
    if (pos + 2 > cap) {
      overflow = true;
      return;
    }
    out[pos++] = b;
    if (b == 0xFF) out[pos++] = 0x00;
  }
  void put(uint32_t v, int nb) {
    for (int i = nb - 1; i >= 0; --i) {
      acc = (acc << 1) | ((v >> i) & 1u);
      if (++bits == 8) {
        byte(static_cast<uint8_t>(acc));
        acc = 0;
        bits = 0;
      }
    }
  }
  void flush() {  // pad the last byte with 1 bits
    while (bits) put(1, 1);
  }
};

int nbits(int32_t v) {
  int n = 0;
  for (v = v < 0 ? -v : v; v; v >>= 1) ++n;
  return n;
}

bool emit(BitWriter* bw, const EncodeTable* t, int sym) {
  if (!t->size[sym]) return false;
  bw->put(t->code[sym], t->size[sym]);
  return true;
}

int encode_block(BitWriter* bw, const EncodeTable* dc, const EncodeTable* ac,
                 int32_t* pred, const int16_t* blk) {
  int32_t diff = blk[0] - *pred;
  *pred = blk[0];
  int s = nbits(diff);
  if (!emit(bw, dc, s)) return kErrTable;
  bw->put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff) & ((1u << s) - 1), s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int32_t c = blk[kNatural[k]];
    if (c == 0) {
      ++run;
      continue;
    }
    for (; run > 15; run -= 16)
      if (!emit(bw, ac, 0xF0)) return kErrTable;
    s = nbits(c);
    if (s > 10 || !emit(bw, ac, (run << 4) | s)) return kErrTable;
    bw->put(static_cast<uint32_t>(c < 0 ? c - 1 : c) & ((1u << s) - 1), s);
    run = 0;
  }
  if (run && !emit(bw, ac, 0x00)) return kErrTable;
  return 0;
}

}  // namespace

extern "C" {

// Decode one baseline scan. `data` starts right after the SOS header.
// `comp` holds ncomp rows of (h, v, dc table, ac table, stride in blocks,
// offset in blocks into `out`); an interleaved scan walks mcus_x x mcus_y
// MCUs of h x v blocks per component, a one-component scan passes h = v = 1
// and its block grid as the MCU grid. Huffman tables: counts [8][16] and
// vals [8][256], DC tables 0..3 then AC tables 0..3. `out` ([blocks][64]
// int16, natural order) must be zeroed. Returns the offset of the marker
// that ends the scan, or a negative error code.
long jpeg_decode_scan(const uint8_t* data, long n, int ncomp, const int32_t* comp,
                      int mcus_x, int mcus_y, int restart_interval,
                      const uint8_t* counts, const uint8_t* vals, int16_t* out) {
  DecodeTable tables[8];
  bool built[8] = {false};
  const Comp* cs = reinterpret_cast<const Comp*>(comp);
  for (int c = 0; c < ncomp; ++c) {
    int ids[2] = {cs[c].dc, 4 + cs[c].ac};
    for (int id : ids) {
      if (id < 0 || id > 7) return kErrTable;
      if (!built[id] && !build_decode(&tables[id], counts + 16 * id, vals + 256 * id))
        return kErrTable;
      built[id] = true;
    }
  }
  BitReader br = {data, n, 0, 0, 0, false};
  int32_t pred[4] = {0, 0, 0, 0};
  long mcus = static_cast<long>(mcus_x) * mcus_y;
  int next_rst = 0;
  for (long m = 0; m < mcus; ++m) {
    if (restart_interval && m && m % restart_interval == 0) {
      // the bits left belong to the interval's padding; the reader stopped
      // at the marker
      br.buf = 0;
      br.bits = 0;
      if (br.pos + 1 >= n || data[br.pos] != 0xFF || data[br.pos + 1] != 0xD0 + next_rst)
        return kErrRestart;
      br.pos += 2;
      br.at_marker = false;
      next_rst = (next_rst + 1) & 7;
      for (int c = 0; c < 4; ++c) pred[c] = 0;
    }
    long my = m / mcus_x, mx = m % mcus_x;
    for (int c = 0; c < ncomp; ++c) {
      const Comp& k = cs[c];
      for (int by = 0; by < k.v; ++by)
        for (int bx = 0; bx < k.h; ++bx) {
          long blk = k.offset + (my * k.v + by) * k.stride + mx * k.h + bx;
          int err = decode_block(&br, &tables[k.dc], &tables[4 + k.ac], &pred[c],
                                 out + 64 * blk);
          if (err) return err;
        }
    }
  }
  long pos = br.pos;
  while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                          (data[pos + 1] & 0xF8) != 0xD0))
    ++pos;
  return pos;
}

// Encode one interleaved baseline scan of quantised coefficients laid out as
// jpeg_decode_scan writes them (same comp rows and tables); no restart
// intervals. Returns the bytes written to `out` (stuffed, padded with 1
// bits) or a negative error code.
long jpeg_encode_scan(const int16_t* coefs, int ncomp, const int32_t* comp, int mcus_x,
                      int mcus_y, const uint8_t* counts, const uint8_t* vals,
                      uint8_t* out, long cap) {
  EncodeTable tables[8];
  bool built[8] = {false};
  const Comp* cs = reinterpret_cast<const Comp*>(comp);
  for (int c = 0; c < ncomp; ++c) {
    int ids[2] = {cs[c].dc, 4 + cs[c].ac};
    for (int id : ids) {
      if (id < 0 || id > 7) return kErrTable;
      if (!built[id] && !build_encode(&tables[id], counts + 16 * id, vals + 256 * id))
        return kErrTable;
      built[id] = true;
    }
  }
  BitWriter bw = {out, cap, 0, 0, 0, false};
  int32_t pred[4] = {0, 0, 0, 0};
  for (long my = 0; my < mcus_y; ++my)
    for (long mx = 0; mx < mcus_x; ++mx)
      for (int c = 0; c < ncomp; ++c) {
        const Comp& k = cs[c];
        for (int by = 0; by < k.v; ++by)
          for (int bx = 0; bx < k.h; ++bx) {
            long blk = k.offset + (my * k.v + by) * k.stride + mx * k.h + bx;
            int err = encode_block(&bw, &tables[k.dc], &tables[4 + k.ac], &pred[c],
                                   coefs + 64 * blk);
            if (err) return err;
            if (bw.overflow) return kErrOverflow;
          }
      }
  bw.flush();
  return bw.overflow ? kErrOverflow : bw.pos;
}

// Undo the PNG row filters: `raw` holds `height` rows of a filter byte and
// `rowbytes` bytes, `bpp` bytes a pixel; `out` gets height x rowbytes.
// Returns 0 or a negative error code.
int png_unfilter(const uint8_t* raw, long height, long rowbytes, int bpp, uint8_t* out) {
  for (long y = 0; y < height; ++y) {
    const uint8_t* src = raw + y * (rowbytes + 1);
    uint8_t* cur = out + y * rowbytes;
    const uint8_t* up = y ? cur - rowbytes : nullptr;
    int type = src[0];
    ++src;
    for (long x = 0; x < rowbytes; ++x) {
      int a = x >= bpp ? cur[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
              pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return kErrFilter;
      }
      cur[x] = static_cast<uint8_t>(src[x] + pred);
    }
  }
  return 0;
}

}  // extern "C"
