// JPEG and PNG decoding to RGB, bit for bit as PIL (libjpeg-turbo, zlib)
// decodes them; see image_decode.h for what it takes and refuses.
//
// JPEG follows libjpeg-turbo's decompressor with PIL's settings (ISLOW
// IDCT, fancy upsampling, no scaling):
//  * every scan, baseline or progressive, is entropy-decoded into one
//    coefficient array per component (jdhuff.c, jdphuff.c: successive
//    approximation, EOB runs and restart markers);
//  * each 8x8 block goes through jpeg_idct_islow (jidctint.c) with its
//    range-limit table (jdmaster.c);
//  * chroma is upsampled by jdsample.c's h2v1, h1v2 and h2v2 triangle
//    filters (box replication for other integral ratios and for planes at
//    most 2 samples wide), with the edge rows and columns replicated as
//    jdmainct.c does;
//  * YCbCr goes to RGB through jdcolor.c's tables; grayscale is replicated
//    to RGB (PIL's "L" -> "RGB"); CMYK is read inverted and converted with
//    PIL's cmyk2rgb (Convert.c), as PIL does for Adobe CMYK files.
// PNG: colour types 0, 2, 3, 4 and 6 (bit depths 1-8 for gray and palette,
// 8 otherwise), the five row filters, alpha dropped; palette indices past
// the palette read black, as in PIL.

#include "image_decode.h"

#include <zlib.h>

#include <algorithm>
#include <cstdio>
#include <cstring>

namespace t2i {

namespace {

[[noreturn]] void fail(const std::string& m) { throw DecodeError(m); }

// ------------------------------------------------------------------ JPEG

// Zigzag -> natural order, with 16 extra entries so that a corrupt run
// length writes to coefficient 63, as jpeg_natural_order does (jutils.c).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t fast_len[512];  // 9-bit lookahead: code length, 0 = longer code
  uint8_t fast_val[512];
  int32_t maxcode[17];    // largest code of each length, -1 for none
  int32_t valoffset[17];  // symbol index = code + valoffset[length]
  uint8_t vals[256];
  int count = 0;
};

// jpeg_make_d_derived_tbl (jdhuff.c).
void build_huffman(Huffman& t, const uint8_t bits[17], const uint8_t* vals,
                   int count, bool dc) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) fail("corrupt JPEG: bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t.valoffset[l] = p - huffcode[p];
      p += bits[l];
      t.maxcode[l] = huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  std::memcpy(t.vals, vals, count);
  t.count = count;
  std::memset(t.fast_len, 0, sizeof t.fast_len);
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      const int look = huffcode[p] << (9 - l);
      for (int c = 0; c < (1 << (9 - l)); ++c) {
        t.fast_len[look + c] = static_cast<uint8_t>(l);
        t.fast_val[look + c] = vals[p];
      }
    }
  }
  if (dc)
    for (int i = 0; i < count; ++i)
      if (vals[i] > 15) fail("corrupt JPEG: bad DC Huffman table");
  t.defined = true;
}

// The entropy-coded segment's bits: 0xFF00 is a data 0xFF, a marker ends
// the segment.  Past the marker, zero bits are supplied as libjpeg does,
// but consuming one of them means the data ran out, which is an error here
// (libjpeg only warns and decodes zeros).
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0;         // bits in buf
  int pad = 0;       // of which trailing fake zero bits
  int marker = -1;   // marker that ended the segment (0: end of file)

  void fill() {
    while (n <= 56) {
      uint32_t b = 0;
      if (marker < 0 && p < end) {
        b = *p++;
        if (b == 0xFF) {
          while (p < end && *p == 0xFF) ++p;  // fill bytes
          if (p >= end) {
            marker = 0;
            b = 0;
            pad += 8;
          } else if (*p == 0) {
            ++p;
          } else {
            marker = *p++;
            b = 0;
            pad += 8;
          }
        }
      } else {
        pad += 8;
      }
      buf |= static_cast<uint64_t>(b) << (56 - n);
      n += 8;
    }
  }
  uint32_t peek(int k) {
    if (n < k) fill();
    return static_cast<uint32_t>(buf >> (64 - k));
  }
  void skip(int k) {
    if (n - pad < k) fail("corrupt JPEG: premature end of entropy-coded data");
    buf <<= k;
    n -= k;
  }
  int bits(int k) {
    if (k == 0) return 0;
    const int v = static_cast<int>(peek(k));
    skip(k);
    return v;
  }
  int decode(const Huffman& t) {
    const uint32_t look = peek(16);
    const int fl = t.fast_len[look >> 7];
    if (fl) {
      skip(fl);
      return t.fast_val[look >> 7];
    }
    int l = 10;
    int32_t code = static_cast<int32_t>(look >> (16 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      ++l;
      code = static_cast<int32_t>(look >> (16 - l));
    }
    if (l > 16) fail("corrupt JPEG: bad Huffman code");
    const int idx = code + t.valoffset[l];
    if (idx < 0 || idx >= t.count) fail("corrupt JPEG: bad Huffman code");
    skip(l);
    return t.vals[idx];
  }
  // The marker after the segment; restarts the reader after it.
  int next_marker() {
    int m = marker;
    if (m < 0) {
      // Bytes left before the marker are skipped, as libjpeg skips them.
      for (;;) {
        while (p < end && *p != 0xFF) ++p;
        while (p < end && *p == 0xFF) ++p;
        if (p >= end) {
          m = 0;
          break;
        }
        if (*p != 0) {
          m = *p++;
          break;
        }
        ++p;
      }
    }
    buf = 0;
    n = pad = 0;
    marker = -1;
    return m;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (-(1 << s)) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // width and height in blocks
  int bw_pad = 0, bh_pad = 0;  // padded to whole MCUs
  int dw = 0, dh = 0;          // downsampled width and height in samples
  std::vector<int16_t> coef;   // bw_pad * bh_pad blocks of 64, natural order
  int16_t quant[64];           // latched at the component's first scan
  bool latched = false;
  int coef_bits[64];           // progressive: -1 = no data yet
  int dc_pred = 0;
  int td = 0, ta = 0;
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples after the IDCT
};

struct Jpeg {
  Jpeg(const uint8_t* d, size_t n) : data(d), len(n) {}
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool frame = false, progressive = false;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool scanned = false;

  int u8() {
    if (pos >= len) fail("corrupt JPEG: truncated file");
    return data[pos++];
  }
  int u16() {
    const int a = u8();
    return (a << 8) | u8();
  }
  // A marker segment's payload: [pos, pos + n).
  size_t segment() {
    const int n = u16() - 2;
    if (n < 0 || pos + n > len) fail("corrupt JPEG: truncated marker segment");
    return static_cast<size_t>(n);
  }

  void read_dqt(size_t n) {
    const size_t stop = pos + n;
    while (pos < stop) {
      const int pq_tq = u8();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("corrupt JPEG: bad quantization table");
      for (int i = 0; i < 64; ++i)
        qt[tq][kNatural[i]] = static_cast<uint16_t>(pq ? u16() : u8());
      qt_defined[tq] = true;
    }
    if (pos != stop) fail("corrupt JPEG: bad DQT length");
  }

  void read_dht(size_t n) {
    const size_t stop = pos + n;
    while (pos < stop) {
      const int tc_th = u8();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: bad Huffman table");
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = static_cast<uint8_t>(u8());
        count += bits[l];
      }
      if (count > 256) fail("corrupt JPEG: bad Huffman table");
      uint8_t vals[256];
      for (int i = 0; i < count; ++i) vals[i] = static_cast<uint8_t>(u8());
      build_huffman(tc ? ac[th] : dc[th], bits, vals, count, tc == 0);
    }
    if (pos != stop) fail("corrupt JPEG: bad DHT length");
  }

  void read_sof(size_t n, int marker) {
    if (frame) fail("corrupt JPEG: two frames");
    const size_t stop = pos + n;
    if (u8() != 8) fail("unsupported JPEG: sample precision other than 8 bits "
                        "(12-bit)");
    height = u16();
    width = u16();
    const int nc = u8();
    if (height == 0) fail("unsupported JPEG: height defined by a DNL marker");
    if (width == 0) fail("corrupt JPEG: zero width");
    if (static_cast<int64_t>(width) * height > (int64_t{1} << 28))
      fail("unsupported JPEG: more than 2^28 pixels");
    if (nc != 1 && nc != 3 && nc != 4)
      fail("unsupported JPEG: " + std::to_string(nc) + " components");
    if (pos + 3 * nc != stop) fail("corrupt JPEG: bad SOF length");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      const int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt JPEG: bad component parameters");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    progressive = marker == 0xC2;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v)
        fail("unsupported JPEG: non-integral sampling ratio");
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) /
                              hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) /
                              vmax);
      c.bw = static_cast<int>(
          (static_cast<int64_t>(width) * c.h + 8 * hmax - 1) / (8 * hmax));
      c.bh = static_cast<int>(
          (static_cast<int64_t>(height) * c.v + 8 * vmax - 1) / (8 * vmax));
      c.bw_pad = mcux * c.h;
      c.bh_pad = mcuy * c.v;
      c.coef.assign(static_cast<size_t>(c.bw_pad) * c.bh_pad * 64, 0);
      for (int& b : c.coef_bits) b = -1;
    }
    frame = true;
  }

  int16_t* block(Component& c, int by, int bx) {
    return c.coef.data() + (static_cast<size_t>(by) * c.bw_pad + bx) * 64;
  }

  // One scan: its header, then its entropy-coded segment.  Returns the
  // marker that follows the segment.
  int read_sos(size_t n) {
    if (!frame) fail("corrupt JPEG: scan before frame header");
    const int ns = u8();
    if (ns < 1 || ns > 4 || n != static_cast<size_t>(4 + 2 * ns))
      fail("corrupt JPEG: bad SOS");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      const int id = u8(), t = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found || std::find(sc.begin(), sc.end(), found) != sc.end())
        fail("corrupt JPEG: bad scan component");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3)
        fail("corrupt JPEG: bad Huffman table selector");
      sc.push_back(found);
    }
    const int ss = u8(), se = u8(), a = u8();
    const int ah = a >> 4, al = a & 15;
    if (progressive) {
      bool bad = ss > se || se > 63;
      if (ss == 0) bad = bad || se != 0;
      else bad = bad || ns != 1;
      if (ah != 0) bad = bad || al != ah - 1;
      bad = bad || al > 13;
      if (bad) fail("corrupt JPEG: bad progression parameters");
      for (Component* c : sc)
        for (int k = ss; k <= se; ++k) {
          const int expected = c->coef_bits[k] < 0 ? 0 : c->coef_bits[k];
          if (ah != expected)
            fail("corrupt JPEG: inconsistent progression sequence");
          c->coef_bits[k] = al;
        }
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      fail("corrupt JPEG: bad sequential scan parameters");
    }
    for (Component* c : sc) {
      if (!c->latched) {
        if (!qt_defined[c->tq]) fail("corrupt JPEG: undefined quantization "
                                     "table");
        for (int k = 0; k < 64; ++k)
          c->quant[k] = static_cast<int16_t>(qt[c->tq][k]);
        c->latched = true;
      }
      const bool need_dc = !progressive || (ss == 0 && ah == 0);
      const bool need_ac = !progressive || ss > 0;
      if ((need_dc && !dc[c->td].defined) || (need_ac && !ac[c->ta].defined))
        fail("corrupt JPEG: undefined Huffman table");
      c->dc_pred = 0;
    }
    scanned = true;

    BitReader br{data + pos, data + len};
    int eobrun = 0;
    int restarts_left = restart_interval, next_rst = 0;
    auto restart = [&]() {
      const int m = br.next_marker();
      if (m != 0xD0 + next_rst)
        fail("corrupt JPEG: restart marker missing or out of order");
      next_rst = (next_rst + 1) & 7;
      for (Component* c : sc) c->dc_pred = 0;
      eobrun = 0;
      restarts_left = restart_interval;
    };
    auto decode_block = [&](Component& c, int16_t* blk) {
      if (!progressive) {
        const int s = br.decode(dc[c.td]);
        const int diff = s ? extend(br.bits(s), s) : 0;
        c.dc_pred += diff;
        blk[0] = static_cast<int16_t>(c.dc_pred);
        const Huffman& t = ac[c.ta];
        for (int k = 1; k < 64; ++k) {
          const int rs = br.decode(t);
          const int r = rs >> 4, sz = rs & 15;
          if (sz) {
            k += r;
            blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(sz), sz));
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
      } else if (ss == 0) {
        if (ah == 0) {
          const int s = br.decode(dc[c.td]);
          const int diff = s ? extend(br.bits(s), s) : 0;
          c.dc_pred += diff;
          blk[0] = static_cast<int16_t>(
              static_cast<int>(static_cast<unsigned>(c.dc_pred) << al));
        } else if (br.bits(1)) {
          blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        }
      } else if (ah == 0) {
        if (eobrun > 0) {
          --eobrun;
          return;
        }
        const Huffman& t = ac[c.ta];
        for (int k = ss; k <= se; ++k) {
          const int rs = br.decode(t);
          int r = rs >> 4;
          const int sz = rs & 15;
          if (sz) {
            k += r;
            const int val = extend(br.bits(sz), sz);
            blk[kNatural[k]] = static_cast<int16_t>(
                static_cast<int>(static_cast<unsigned>(val) << al));
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.bits(r);
            --eobrun;
            break;
          }
        }
      } else {
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        const Huffman& t = ac[c.ta];
        int k = ss;
        auto refine = [&](int16_t* coef) {
          if (*coef != 0 && br.bits(1) && (*coef & p1) == 0)
            *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
        };
        if (eobrun == 0) {
          for (; k <= se; ++k) {
            const int rs = br.decode(t);
            int r = rs >> 4, s = rs & 15;
            if (s) {
              if (s != 1) fail("corrupt JPEG: bad refinement coefficient");
              s = br.bits(1) ? p1 : m1;
            } else if (r != 15) {
              eobrun = 1 << r;
              if (r) eobrun += br.bits(r);
              break;
            }
            do {
              int16_t* coef = blk + kNatural[k];
              if (*coef != 0) {
                refine(coef);
              } else if (--r < 0) {
                break;
              }
              ++k;
            } while (k <= se);
            if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
          }
        }
        if (eobrun > 0) {
          for (; k <= se; ++k) refine(blk + kNatural[k]);
          --eobrun;
        }
      }
    };

    if (sc.size() == 1) {
      Component& c = *sc[0];
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx) {
          if (restart_interval) {
            if (restarts_left == 0) restart();
            --restarts_left;
          }
          decode_block(c, block(c, by, bx));
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart_interval) {
            if (restarts_left == 0) restart();
            --restarts_left;
          }
          for (Component* c : sc)
            for (int v = 0; v < c->v; ++v)
              for (int h = 0; h < c->h; ++h)
                decode_block(*c, block(*c, my * c->v + v, mx * c->h + h));
        }
    }
    const int m = br.next_marker();
    pos = static_cast<size_t>(br.p - data);
    return m;
  }

  void parse() {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8)
      fail("corrupt JPEG: no SOI marker");
    pos = 2;
    int pending = -1;  // a marker already read by the entropy decoder
    for (;;) {
      int m = pending;
      pending = -1;
      if (m < 0) {
        if (u8() != 0xFF) fail("corrupt JPEG: expected a marker");
        do m = u8(); while (m == 0xFF);
      }
      if (m == 0) fail("corrupt JPEG: truncated file (no EOI marker)");
      if (m == 0xD9) break;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(segment(), m);
          break;
        case 0xC3: case 0xC7: case 0xCB: case 0xCF:
          fail("unsupported JPEG: lossless coding");
        case 0xC5: case 0xC6: case 0xCD: case 0xCE:
          fail("unsupported JPEG: hierarchical (differential) coding");
        case 0xC9: case 0xCA: case 0xCC:
          fail("unsupported JPEG: arithmetic coding");
        case 0xC4:
          read_dht(segment());
          break;
        case 0xDB:
          read_dqt(segment());
          break;
        case 0xDD: {
          const size_t n = segment();
          if (n != 2) fail("corrupt JPEG: bad DRI length");
          restart_interval = u16();
          break;
        }
        case 0xDA:
          pending = read_sos(segment());
          break;
        case 0xDC:
          fail("unsupported JPEG: DNL marker");
        case 0xE0: {
          const size_t n = segment();
          // libjpeg's examine_app0 wants the whole 14-byte JFIF header.
          if (n >= 14 && std::memcmp(data + pos, "JFIF\0", 5) == 0)
            jfif = true;
          pos += n;
          break;
        }
        case 0xEE: {
          const size_t n = segment();
          if (n >= 12 && std::memcmp(data + pos, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = data[pos + 11];
          }
          pos += n;
          break;
        }
        default:
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
            pos += segment();
          } else {
            char buf[64];
            std::snprintf(buf, sizeof buf, "corrupt JPEG: unexpected marker "
                          "0x%02X", m);
            fail(buf);
          }
      }
    }
    if (!frame || !scanned) fail("corrupt JPEG: no image data");
    for (auto& c : comps)
      if (!c.latched) fail("corrupt JPEG: a component has no scan");
    if (progressive)
      for (auto& c : comps)
        for (int k = 1; k < 10; ++k)
          if (c.coef_bits[k] != 0)
            fail("unsupported JPEG: progressive refinement incomplete "
                 "(libjpeg block smoothing)");
  }
};

// jpeg_idct_islow (jidctint.c), CONST_BITS 13, PASS1_BITS 2, with the
// post-IDCT range-limit table of jdmaster.c (indices masked by 1023).
uint8_t kRangeLimit[1024];

struct RangeInit {
  RangeInit() {
    // limit[x] for x = v & 1023 where v is the IDCT output before the
    // +128 shift: 128..255 for 0..127, 255 to 511, 0 from 512, then the
    // wrap of -128..-1 to 0..127.
    for (int i = 0; i < 1024; ++i) {
      const int j = 128 + i;  // index into sample_range_limit
      int v;
      if (j < 256) v = j;
      else if (j < 640) v = 255;
      else if (j < 1024) v = 0;
      else v = j - 1024;
      kRangeLimit[i] = static_cast<uint8_t>(v);
    }
  }
} range_init;

constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
    FIX_0_541196100 = 4433, FIX_0_765366865 = 6270, FIX_0_899976223 = 7373,
    FIX_1_175875602 = 9633, FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
    FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
    FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      const int dc = (ip[0] * qp[0]) * (1 << 2);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << 13);
    int64_t tmp1 = (z2 - z3) * (1 << 13);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, 11));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, 11));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, 11));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, 11));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, 11));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, 11));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, 11));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, 11));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      const uint8_t v = kRangeLimit[descale(wp[0], 5) & 1023];
      std::memset(op, v, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << 13);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << 13);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRangeLimit[descale(tmp10 + tmp3, 18) & 1023];
    op[7] = kRangeLimit[descale(tmp10 - tmp3, 18) & 1023];
    op[1] = kRangeLimit[descale(tmp11 + tmp2, 18) & 1023];
    op[6] = kRangeLimit[descale(tmp11 - tmp2, 18) & 1023];
    op[2] = kRangeLimit[descale(tmp12 + tmp1, 18) & 1023];
    op[5] = kRangeLimit[descale(tmp12 - tmp1, 18) & 1023];
    op[3] = kRangeLimit[descale(tmp13 + tmp0, 18) & 1023];
    op[4] = kRangeLimit[descale(tmp13 - tmp0, 18) & 1023];
  }
}

// The component's samples upsampled to the full image (width x height),
// as libjpeg-turbo's upsampler with do_fancy_upsampling (jdsample.c).
void upsample(const Component& c, int hmax, int vmax, int width, int height,
              uint8_t* out) {
  const int rh = hmax / c.h, rv = vmax / c.v;
  const int stride = c.bw * 8;
  const uint8_t* in = c.plane.data();
  const int dw = c.dw, dh = c.dh;
  auto row = [&](int y) {
    return in + static_cast<size_t>(std::min(std::max(y, 0), dh - 1)) * stride;
  };
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < height; ++y)
      std::memcpy(out + static_cast<size_t>(y) * width, row(y), width);
    return;
  }
  const bool fancy_h = dw > 2;
  if (rh == 2 && rv == 1 && fancy_h) {  // h2v1_fancy_upsample
    for (int y = 0; y < height; ++y) {
      const uint8_t* ip = row(y);
      uint8_t* op = out + static_cast<size_t>(y) * width;
      for (int x = 0; x < width; ++x) {
        const int i = x >> 1;
        const int v = ip[i] * 3;
        op[x] = (x & 1) ? static_cast<uint8_t>(
                              (v + ip[std::min(i + 1, dw - 1)] + 2) >> 2)
                        : static_cast<uint8_t>(
                              (v + ip[std::max(i - 1, 0)] + 1) >> 2);
      }
    }
    return;
  }
  if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; ++y) {
      const int k = y >> 1;
      const uint8_t* i0 = row(k);
      const uint8_t* i1 = (y & 1) ? row(k + 1) : row(k - 1);
      const int bias = (y & 1) ? 2 : 1;
      uint8_t* op = out + static_cast<size_t>(y) * width;
      for (int x = 0; x < width; ++x)
        op[x] = static_cast<uint8_t>((i0[x] * 3 + i1[x] + bias) >> 2);
    }
    return;
  }
  if (rh == 2 && rv == 2 && fancy_h) {  // h2v2_fancy_upsample
    std::vector<int> colsum(dw);
    for (int y = 0; y < height; ++y) {
      const int k = y >> 1;
      const uint8_t* i0 = row(k);
      const uint8_t* i1 = (y & 1) ? row(k + 1) : row(k - 1);
      for (int i = 0; i < dw; ++i) colsum[i] = i0[i] * 3 + i1[i];
      uint8_t* op = out + static_cast<size_t>(y) * width;
      for (int x = 0; x < width; ++x) {
        const int i = x >> 1;
        op[x] = (x & 1)
            ? static_cast<uint8_t>(
                  (colsum[i] * 3 + colsum[std::min(i + 1, dw - 1)] + 7) >> 4)
            : static_cast<uint8_t>(
                  (colsum[i] * 3 + colsum[std::max(i - 1, 0)] + 8) >> 4);
      }
    }
    return;
  }
  // int_upsample / h2v1_upsample / h2v2_upsample: replication.
  for (int y = 0; y < height; ++y) {
    const uint8_t* ip = row(y / rv);
    uint8_t* op = out + static_cast<size_t>(y) * width;
    for (int x = 0; x < width; ++x) op[x] = ip[x / rh];
  }
}

// ycc_rgb_convert's tables (jdcolor.c, SCALEBITS 16).
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t{1} << 15;
    auto fix = [](double x) {
      return static_cast<int64_t>(x * 65536.0 + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = static_cast<int32_t>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int32_t>(-fix(0.34414) * x + one_half);
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

inline int muldiv255(int a, int b) {
  const int tmp = a * b + 128;
  return ((tmp >> 8) + tmp) >> 8;
}

void decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>& rgb,
                 int* h, int* w) {
  Jpeg j(data, len);
  j.parse();
  const int nc = static_cast<int>(j.comps.size());
  // The colour space libjpeg infers (jdapimin.c default_decompress_parms).
  enum { GRAY, YCC, RGB, CMYK } space = GRAY;
  if (nc == 3) {
    if (j.jfif) {
      space = YCC;
    } else if (j.adobe) {
      space = j.adobe_transform == 0 ? RGB : YCC;
    } else {
      const int c0 = j.comps[0].id, c1 = j.comps[1].id, c2 = j.comps[2].id;
      space = (c0 == 82 && c1 == 71 && c2 == 66) ? RGB : YCC;
    }
  } else if (nc == 4) {
    if (j.adobe && j.adobe_transform != 0)
      fail("unsupported JPEG: YCCK colour space");
    space = CMYK;
  }
  const int width = j.width, height = j.height;
  std::vector<std::vector<uint8_t>> full(nc);
  for (auto& c : j.comps) {
    const int stride = c.bw * 8;
    c.plane.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(j.block(c, by, bx), c.quant,
                   c.plane.data() + static_cast<size_t>(by) * 8 * stride +
                       bx * 8,
                   stride);
    c.coef.clear();
    c.coef.shrink_to_fit();
  }
  for (int i = 0; i < nc; ++i) {
    full[i].resize(static_cast<size_t>(width) * height);
    upsample(j.comps[i], j.hmax, j.vmax, width, height, full[i].data());
    j.comps[i].plane.clear();
  }
  const size_t npx = static_cast<size_t>(width) * height;
  rgb.resize(npx * 3);
  uint8_t* o = rgb.data();
  switch (space) {
    case GRAY:
      for (size_t i = 0; i < npx; ++i)
        o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = full[0][i];
      break;
    case RGB:
      for (size_t i = 0; i < npx; ++i) {
        o[3 * i] = full[0][i];
        o[3 * i + 1] = full[1][i];
        o[3 * i + 2] = full[2][i];
      }
      break;
    case YCC:
      for (size_t i = 0; i < npx; ++i) {
        const int y = full[0][i], cb = full[1][i], cr = full[2][i];
        o[3 * i] = clamp255(y + kYcc.cr_r[cr]);
        o[3 * i + 1] =
            clamp255(y + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        o[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
      }
      break;
    case CMYK:
      // PIL reads Adobe CMYK inverted ("CMYK;I") and converts with
      // cmyk2rgb: nk = 255 - K, out = nk - nk * C / 255.
      for (size_t i = 0; i < npx; ++i) {
        const int nk = full[3][i];  // 255 - (255 - raw)
        for (int ch = 0; ch < 3; ++ch) {
          const int cval = 255 - full[ch][i];
          o[3 * i + ch] = clamp255(nk - muldiv255(cval, nk));
        }
      }
      break;
  }
  *h = height;
  *w = width;
}

void jpeg_dims(const uint8_t* data, size_t len, int* h, int* w) {
  size_t pos = 2;
  for (;;) {
    if (pos + 4 > len) fail("corrupt JPEG: no frame header");
    if (data[pos] != 0xFF) fail("corrupt JPEG: expected a marker");
    int m = data[pos + 1];
    ++pos;
    while (m == 0xFF && pos + 1 < len) m = data[++pos];
    ++pos;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (pos + 2 > len) fail("corrupt JPEG: truncated marker segment");
    const size_t n = (static_cast<size_t>(data[pos]) << 8) | data[pos + 1];
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      if (pos + 7 > len) fail("corrupt JPEG: truncated frame header");
      *h = (data[pos + 3] << 8) | data[pos + 4];
      *w = (data[pos + 5] << 8) | data[pos + 6];
      if (*h == 0) fail("unsupported JPEG: height defined by a DNL marker");
      return;
    }
    if (m == 0xDA || m == 0xD9) fail("corrupt JPEG: no frame header");
    pos += n;
  }
}

// ------------------------------------------------------------------- PNG

inline uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

void decode_png(const uint8_t* data, size_t len, std::vector<uint8_t>& rgb,
                int* h, int* w) {
  size_t pos = 8;
  uint32_t width = 0, height = 0;
  int depth = 0, ctype = -1;
  std::vector<uint8_t> palette, idat;
  bool ended = false;
  while (pos + 8 <= len) {
    const uint32_t n = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    if (n > 0x7FFFFFFFu) fail("corrupt PNG: bad chunk length");
    if (pos + 12 + n > len) break;  // truncated chunk: the data decides
    const uint8_t* body = data + pos + 8;
    const uint32_t crc = be32(body + n);
    if (static_cast<uint32_t>(crc32(crc32(0, type, 4), body, n)) != crc)
      fail(std::string("corrupt PNG: CRC error in ") +
           std::string(reinterpret_cast<const char*>(type), 4) + " chunk");
    pos += 12 + n;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (n != 13) fail("corrupt PNG: bad IHDR");
      width = be32(body);
      height = be32(body + 4);
      depth = body[8];
      ctype = body[9];
      if (body[10] != 0 || body[11] != 0)
        fail("corrupt PNG: unknown compression or filter method");
      if (body[12] == 1) fail("unsupported PNG: interlaced (Adam7)");
      if (body[12] != 0) fail("corrupt PNG: unknown interlace method");
      if (depth == 16) fail("unsupported PNG: 16 bits per sample");
      const bool ok =
          ((ctype == 0 || ctype == 3) &&
           (depth == 1 || depth == 2 || depth == 4 || depth == 8)) ||
          ((ctype == 2 || ctype == 4 || ctype == 6) && depth == 8);
      if (!ok) fail("corrupt PNG: bad colour type and bit depth");
      if (width == 0 || height == 0) fail("corrupt PNG: zero size");
      if (static_cast<uint64_t>(width) * height > (uint64_t{1} << 28))
        fail("unsupported PNG: more than 2^28 pixels");
    } else if (ctype < 0) {
      fail("corrupt PNG: IHDR is not the first chunk");
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (n % 3 || n > 768) fail("corrupt PNG: bad PLTE");
      palette.assign(body, body + n);
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + n);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      ended = true;
      break;
    } else if (!(type[0] & 0x20)) {
      fail("unsupported PNG: critical chunk " +
           std::string(reinterpret_cast<const char*>(type), 4));
    }
  }
  if (ctype < 0) fail("corrupt PNG: no IHDR");
  (void)ended;
  if (ctype == 3 && palette.empty()) fail("corrupt PNG: palette missing");
  const int channels = ctype == 2 ? 3 : ctype == 4 ? 2 : ctype == 6 ? 4 : 1;
  const size_t bits_per_px = static_cast<size_t>(channels) * depth;
  const size_t rowbytes = (width * bits_per_px + 7) / 8;
  const size_t bpp = std::max<size_t>(1, bits_per_px / 8);
  std::vector<uint8_t> raw((rowbytes + 1) * height);
  z_stream zs;
  std::memset(&zs, 0, sizeof zs);
  if (inflateInit(&zs) != Z_OK) fail("PNG: zlib initialisation failed");
  zs.next_in = idat.data();
  zs.avail_in = static_cast<uInt>(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = static_cast<uInt>(raw.size());
  const int zr = inflate(&zs, Z_FINISH);
  const size_t got = raw.size() - zs.avail_out;
  inflateEnd(&zs);
  if (got < raw.size()) {
    fail(zr == Z_DATA_ERROR ? "corrupt PNG: bad compressed data"
                            : "corrupt PNG: image data truncated");
  }
  std::vector<uint8_t> prev(rowbytes, 0), cur(rowbytes);
  rgb.resize(static_cast<size_t>(width) * height * 3);
  for (uint32_t y = 0; y < height; ++y) {
    const uint8_t* src = raw.data() + y * (rowbytes + 1);
    const int filter = src[0];
    ++src;
    for (size_t i = 0; i < rowbytes; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev[i];
      const int c = i >= bpp ? prev[i - bpp] : 0;
      int v = src[i];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) >> 1; break;
        case 4: v += paeth(a, b, c); break;
        default: fail("corrupt PNG: bad row filter");
      }
      cur[i] = static_cast<uint8_t>(v);
    }
    uint8_t* o = rgb.data() + static_cast<size_t>(y) * width * 3;
    for (uint32_t x = 0; x < width; ++x) {
      uint8_t r, g, b;
      if (depth == 8) {
        const uint8_t* p = cur.data() + static_cast<size_t>(x) * channels;
        if (ctype == 2 || ctype == 6) {
          r = p[0];
          g = p[1];
          b = p[2];
        } else if (ctype == 3) {
          const size_t k = p[0];
          if (3 * k + 2 < palette.size()) {
            r = palette[3 * k];
            g = palette[3 * k + 1];
            b = palette[3 * k + 2];
          } else {
            r = g = b = 0;
          }
        } else {
          r = g = b = p[0];
        }
      } else {
        const size_t bit = static_cast<size_t>(x) * depth;
        const int v = (cur[bit >> 3] >> (8 - depth - (bit & 7))) &
                      ((1 << depth) - 1);
        if (ctype == 3) {
          const size_t k = static_cast<size_t>(v);
          if (3 * k + 2 < palette.size()) {
            r = palette[3 * k];
            g = palette[3 * k + 1];
            b = palette[3 * k + 2];
          } else {
            r = g = b = 0;
          }
        } else {
          r = g = b = static_cast<uint8_t>(v * 255 / ((1 << depth) - 1));
        }
      }
      o[3 * x] = r;
      o[3 * x + 1] = g;
      o[3 * x + 2] = b;
    }
    std::swap(prev, cur);
  }
  *h = static_cast<int>(height);
  *w = static_cast<int>(width);
}

void png_dims(const uint8_t* data, size_t len, int* h, int* w) {
  if (len < 24 || std::memcmp(data + 12, "IHDR", 4) != 0)
    fail("corrupt PNG: no IHDR");
  *w = static_cast<int>(be32(data + 16));
  *h = static_cast<int>(be32(data + 20));
}

enum Format { JPEG, PNG };

Format sniff(const uint8_t* data, size_t len) {
  if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF)
    return JPEG;
  if (len >= 8 && std::memcmp(data, kPngSig, 8) == 0) return PNG;
  if (len >= 2 && data[0] == 'B' && data[1] == 'M')
    fail("unsupported image format: BMP");
  if (len >= 12 && std::memcmp(data, "RIFF", 4) == 0 &&
      std::memcmp(data + 8, "WEBP", 4) == 0)
    fail("unsupported image format: WebP");
  if (len >= 6 && std::memcmp(data, "GIF8", 4) == 0)
    fail("unsupported image format: GIF");
  fail("unsupported image format: neither JPEG nor PNG");
}

}  // namespace

void decode_image(const uint8_t* data, size_t len, std::vector<uint8_t>& rgb,
                  int* h, int* w) {
  if (sniff(data, len) == JPEG) decode_jpeg(data, len, rgb, h, w);
  else decode_png(data, len, rgb, h, w);
}

void image_dims(const uint8_t* data, size_t len, int* h, int* w) {
  if (sniff(data, len) == JPEG) jpeg_dims(data, len, h, w);
  else png_dims(data, len, h, w);
}

bool read_file(const std::string& path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long n = std::ftell(f);
  if (n < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(n));
  const size_t got = n ? std::fread(out.data(), 1, static_cast<size_t>(n), f)
                       : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

}  // namespace t2i
