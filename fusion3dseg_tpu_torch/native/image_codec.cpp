// Image codec of the PyTorch port: PNG row filters, JPEG and the Exif
// orientation tag.
//
// A host library with a plain C interface, loaded with ctypes by
// `fusion3dseg_tpu_torch/io/image.py`, which does the PNG chunk, zlib,
// interlace and bit-depth work in Python. It covers what RTAB-Map, TUM
// and phone cameras write and what OpenCV writes:
//
//   * PNG: undo the five row filters (Paeth and Average run along a row).
//   * JPEG read: sequential (SOF0/SOF1) and progressive (SOF2) Huffman,
//     8-bit, 1 or 3 components, any integer sampling (4:4:4, 4:2:2, 4:2:0,
//     ...), restart intervals, interleaved and single-component scans.
//     Progressive scans (spectral selection, successive approximation, EOB
//     runs) decode as libjpeg-turbo's jdphuff.c does into a coefficient
//     buffer of the whole image; every block then goes through the same
//     output path as a sequential file. That path follows libjpeg-turbo's
//     defaults, which OpenCV decodes with: the ISLOW integer IDCT with its
//     descale and range limit, "fancy" triangular chroma upsampling with its
//     edge rules, and the fixed-point YCbCr->RGB tables. libjpeg-turbo's
//     block smoothing acts only while some coefficient bits are still
//     unknown, which a complete file never leaves, so it has no counterpart
//     here. Arithmetic-coded (SOF9-SOF15), lossless and 12-bit files, and
//     four-component (CMYK/YCCK) ones, are refused.
//   * Exif: the Orientation tag (0x0112) of a TIFF structure, read the way
//     OpenCV's ExifReader reads it: from the first APP1 segment of a JPEG
//     (past its 6-byte "Exif\0\0" header), or from a PNG eXIf chunk that
//     image.py hands over.
//   * JPEG write: baseline, 4:2:0 for colour (one component for gray), the
//     standard quantization tables scaled to a quality, the standard
//     Huffman tables, no optimization.
//
// Every function returns 0 (or a byte count) on success and a negative
// code on failure; the codes are listed in `enum Err`.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

enum Err {
  kOk = 0,
  kTruncated = -1,
  kNotJpeg = -2,
  kArithmetic = -4,
  kUnsupported = -5,
  kBadData = -6,
  kBadHuffman = -7,
  kNoFrame = -8,
  kOutOfSpace = -9,
};

int g_zigzag[64];  // zigzag index -> natural (row-major) index

struct ZigzagInit {
  ZigzagInit() {
    int k = 0;
    for (int s = 0; s < 15; ++s) {
      int lo = s < 8 ? 0 : s - 7, hi = s < 8 ? s : 7;
      if (s % 2 == 0) {
        for (int i = hi; i >= lo; --i) g_zigzag[k++] = i * 8 + (s - i);
      } else {
        for (int i = lo; i <= hi; ++i) g_zigzag[k++] = i * 8 + (s - i);
      }
    }
  }
} g_zigzag_init;

// ---------------------------------------------------------------- PNG --

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// --------------------------------------------------------- JPEG decode --

struct Huffman {
  bool defined = false;
  uint8_t look_len[512];  // 9-bit lookahead: code length (0: longer code)
  uint8_t look_sym[512];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

bool build_huffman(Huffman& h, const uint8_t* bits, const uint8_t* vals, int nvals) {
  int count = 0;
  for (int l = 1; l <= 16; ++l) count += bits[l - 1];
  if (count > 256 || count != nvals) return false;
  std::memcpy(h.vals, vals, nvals);
  std::memset(h.look_len, 0, sizeof(h.look_len));
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    int n = bits[l - 1];
    if (n) {
      h.valoffset[l] = k - code;
      for (int i = 0; i < n; ++i, ++k, ++code) {
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j) {
            h.look_len[(code << shift) | j] = (uint8_t)l;
            h.look_sym[(code << shift) | j] = vals[k];
          }
        }
      }
      h.maxcode[l] = code - 1;
    } else {
      h.maxcode[l] = -1;
    }
    if (code > (1 << l)) return false;
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  h.defined = true;
  return true;
}

struct BitReader {
  const uint8_t* buf;
  int64_t len;
  int64_t pos;
  uint64_t acc = 0;
  int nbits = 0;
  bool hit_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint8_t byte = 0;
      if (!hit_marker && pos < len) {
        byte = buf[pos];
        if (byte == 0xFF) {
          uint8_t next = pos + 1 < len ? buf[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;  // zeros from here on, as libjpeg inserts
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= (uint64_t)byte << (56 - nbits);
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return (uint32_t)(acc >> (64 - n));
  }
  void skip(int n) {
    acc <<= n;
    nbits -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return (int)v;
  }
  // byte-align and step over the RSTn marker that ends a restart interval
  bool restart() {
    acc = 0;
    nbits = 0;
    hit_marker = false;
    while (pos + 1 < len && !(buf[pos] == 0xFF && buf[pos + 1] >= 0xD0 && buf[pos + 1] <= 0xD7)) {
      if (buf[pos] == 0xFF && buf[pos + 1] != 0x00 && buf[pos + 1] != 0xFF) return false;
      ++pos;
    }
    if (pos + 1 >= len) return false;
    pos += 2;
    return true;
  }
};

inline int decode_symbol(BitReader& br, const Huffman& h) {
  uint32_t look = br.peek(16);
  int idx = look >> 7;
  int l = h.look_len[idx];
  if (l) {
    br.skip(l);
    return h.look_sym[idx];
  }
  l = 10;
  while (l <= 16 && (int32_t)(look >> (16 - l)) > h.maxcode[l]) ++l;
  if (l > 16) return -1;
  br.skip(l);
  const int32_t k = (int32_t)(look >> (16 - l)) + h.valoffset[l];
  return k >= 0 && k < 256 ? h.vals[k] : -1;
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id, h, v, tq;
  int bw, bh;          // blocks allocated per row / column (MCU padded)
  int dw, dh;          // downsampled width / height in samples
  std::vector<int16_t> coef;  // bw * bh * 64, natural order
  uint16_t quant[64];  // latched at the component's first scan
  bool latched = false;
};

struct Decoder {
  const uint8_t* buf;
  int64_t len;
  int64_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool frame = false, progressive = false, adobe = false, jfif = false;
  int64_t app1 = -1, app1_len = 0;  // the first APP1 segment's body
  int adobe_transform = -1;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];

  int u16(int64_t p) { return (buf[p] << 8) | buf[p + 1]; }

  int parse_sof(int64_t p, int seglen) {
    if (seglen < 8) return kBadData;
    if (buf[p] != 8) return kUnsupported;  // 8-bit samples only
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = buf[p + 5];
    if (width <= 0 || height <= 0) return kUnsupported;
    if (ncomp != 1 && ncomp != 3) return kUnsupported;
    if (seglen < 6 + 3 * ncomp) return kBadData;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = buf[p + 6 + 3 * i];
      c.h = buf[p + 7 + 3 * i] >> 4;
      c.v = buf[p + 7 + 3 * i] & 15;
      c.tq = buf[p + 8 + 3 * i] & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return kBadData;
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) return kUnsupported;  // integer ratios only
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    frame = true;
    return kOk;
  }

  // A sequential scan's block: DC difference and every AC coefficient.
  int decode_block(BitReader& br, int& pred, const Huffman& hd, const Huffman& ha,
                   int16_t* blk) {
    int t = decode_symbol(br, hd);
    if (t < 0 || t > 11) return kBadHuffman;
    int diff = t ? extend(br.get(t), t) : 0;
    pred += diff;
    blk[0] = (int16_t)pred;
    for (int k = 1; k < 64;) {
      int rs = decode_symbol(br, ha);
      if (rs < 0) return kBadHuffman;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) return kBadData;
        blk[g_zigzag[k]] = (int16_t)extend(br.get(s), s);
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
    return kOk;
  }

  // Progressive scans, as libjpeg-turbo's jdphuff.c decodes them. The scan
  // covers coefficients ss..se (zigzag) at bit al; ah != 0 refines bits
  // that an earlier scan sent. eobrun counts blocks left in an EOB run.
  int ss = 0, se = 63, ah = 0, al = 0;
  int eobrun = 0;

  int decode_dc_first(BitReader& br, int& pred, const Huffman& hd, int16_t* blk) {
    int t = decode_symbol(br, hd);
    if (t < 0 || t > 11) return kBadHuffman;
    pred += t ? extend(br.get(t), t) : 0;
    blk[0] = (int16_t)((unsigned)pred << al);
    return kOk;
  }

  int decode_dc_refine(BitReader& br, int16_t* blk) {
    if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
    return kOk;
  }

  int decode_ac_first(BitReader& br, const Huffman& ha, int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return kOk;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = decode_symbol(br, ha);
      if (rs < 0) return kBadHuffman;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) return kBadData;
        blk[g_zigzag[k]] = (int16_t)((unsigned)extend(br.get(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) - 1;
        if (r) eobrun += br.get(r);
        break;
      }
    }
    return kOk;
  }

  int decode_ac_refine(BitReader& br, const Huffman& ha, int16_t* blk) {
    const int p1 = 1 << al, m1 = -p1;
    // a coefficient already nonzero takes one correction bit
    auto refine = [&](int16_t& coef) {
      if (br.get(1) && (coef & p1) == 0) coef = (int16_t)(coef + (coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode_symbol(br, ha);
        if (rs < 0) return kBadHuffman;
        int r = rs >> 4, s = rs & 15;
        if (s) {  // a newly nonzero coefficient, of size 1: its sign
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        // skip r zero coefficients (refining the nonzero ones on the way),
        // then place s on the next zero one
        do {
          int16_t& coef = blk[g_zigzag[k]];
          if (coef != 0) {
            refine(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > 63) return kBadData;
          blk[g_zigzag[k]] = (int16_t)s;
        }
      }
    }
    if (eobrun > 0) {  // the rest of the band: corrections only
      for (; k <= se; ++k)
        if (blk[g_zigzag[k]] != 0) refine(blk[g_zigzag[k]]);
      --eobrun;
    }
    return kOk;
  }

  int decode_unit(BitReader& br, int& pred, int td, int ta, int16_t* blk) {
    if (!progressive) return decode_block(br, pred, dc[td], ac[ta], blk);
    if (ss == 0) return ah ? decode_dc_refine(br, blk) : decode_dc_first(br, pred, dc[td], blk);
    return ah ? decode_ac_refine(br, ac[ta], blk) : decode_ac_first(br, ac[ta], blk);
  }

  int parse_sos(int64_t p, int seglen, int64_t& data_start) {
    if (!frame) return kNoFrame;
    int ns = buf[p];
    if (ns < 1 || ns > 4 || seglen < 1 + 2 * ns + 3) return kBadData;
    ss = buf[p + 1 + 2 * ns];
    se = buf[p + 2 + 2 * ns];
    ah = buf[p + 3 + 2 * ns] >> 4;
    al = buf[p + 3 + 2 * ns] & 15;
    if (!progressive) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0) return kBadData;
    } else if (ss > se || se > 63 || al > 13 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) ||
               (ah != 0 && ah != al + 1)) {
      return kBadData;  // libjpeg's "invalid progressive parameters"
    }
    // the tables this scan reads: DC for sequential and first DC scans, AC
    // for sequential and AC scans
    const bool need_dc = !progressive || (ss == 0 && ah == 0);
    const bool need_ac = !progressive || ss > 0;
    int idx[4], td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
      int cid = buf[p + 1 + 2 * i];
      idx[i] = -1;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) idx[i] = j;
      if (idx[i] < 0) return kBadData;
      td[i] = buf[p + 2 + 2 * i] >> 4;
      ta[i] = buf[p + 2 + 2 * i] & 15;
      if (td[i] > 3 || ta[i] > 3 || (need_dc && !dc[td[i]].defined) ||
          (need_ac && !ac[ta[i]].defined))
        return kBadHuffman;
      Component& c = comp[idx[i]];
      if (!c.latched) {
        if (!qt_defined[c.tq]) return kBadData;
        std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
        c.latched = true;
      }
    }
    eobrun = 0;

    BitReader br{buf, len, p + seglen};
    int pred[4] = {0, 0, 0, 0};
    int64_t units;  // MCUs of the scan
    int ux = 0;
    if (ns == 1) {  // non-interleaved: one block an MCU over the component's own blocks
      const Component& c = comp[idx[0]];
      ux = (c.dw + 7) / 8;
      units = (int64_t)ux * ((c.dh + 7) / 8);
    } else {
      units = (int64_t)mcux * mcuy;
    }
    int64_t left = restart_interval;
    for (int64_t m = 0; m < units; ++m) {
      if (restart_interval) {
        if (left == 0) {
          if (!br.restart()) return kBadData;
          for (int i = 0; i < 4; ++i) pred[i] = 0;
          eobrun = 0;
          left = restart_interval;
        }
        --left;
      }
      if (ns == 1) {
        Component& c = comp[idx[0]];
        int bx = (int)(m % ux), by = (int)(m / ux);
        int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
        int rc = decode_unit(br, pred[0], td[0], ta[0], blk);
        if (rc) return rc;
      } else {
        int mx = (int)(m % mcux), my = (int)(m / mcux);
        for (int i = 0; i < ns; ++i) {
          Component& c = comp[idx[i]];
          for (int yy = 0; yy < c.v; ++yy)
            for (int xx = 0; xx < c.h; ++xx) {
              int bx = mx * c.h + xx, by = my * c.v + yy;
              int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
              int rc = decode_unit(br, pred[i], td[i], ta[i], blk);
              if (rc) return rc;
            }
        }
      }
    }
    // continue after the entropy-coded data: the next marker
    int64_t q = br.pos;
    while (q + 1 < len && !(buf[q] == 0xFF && buf[q + 1] != 0x00 &&
                           !(buf[q + 1] >= 0xD0 && buf[q + 1] <= 0xD7)))
      ++q;
    data_start = q;
    return kOk;
  }

  int parse() {
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return kNotJpeg;
    pos = 2;
    while (true) {
      while (pos < len && buf[pos] != 0xFF) ++pos;  // tolerate junk
      while (pos < len && buf[pos] == 0xFF) ++pos;  // fill bytes
      if (pos >= len) return frame ? kOk : kTruncated;
      int marker = buf[pos++];
      if (marker == 0xD9) return kOk;  // EOI
      if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
      if (pos + 2 > len) return kTruncated;
      int seglen = u16(pos);
      if (seglen < 2 || pos + seglen > len) return kTruncated;
      int64_t p = pos + 2;
      int body = seglen - 2;
      switch (marker) {
        case 0xC0:
        case 0xC1:
        case 0xC2: {
          progressive = marker == 0xC2;
          int rc = parse_sof(p, body);
          if (rc) return rc;
          break;
        }
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF: case 0xCC:
          return kArithmetic;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7:
          return kUnsupported;  // lossless and hierarchical
        case 0xC4: {  // DHT
          int64_t q = p, end = p + body;
          while (q < end) {
            if (q + 17 > end) return kBadHuffman;
            int tc = buf[q] >> 4, th = buf[q] & 15;
            if (tc > 1 || th > 3) return kBadHuffman;
            int n = 0;
            for (int l = 0; l < 16; ++l) n += buf[q + 1 + l];
            if (q + 17 + n > end) return kBadHuffman;
            Huffman& h = tc ? ac[th] : dc[th];
            if (!build_huffman(h, buf + q + 1, buf + q + 17, n)) return kBadHuffman;
            q += 17 + n;
          }
          break;
        }
        case 0xDB: {  // DQT
          int64_t q = p, end = p + body;
          while (q < end) {
            int pq = buf[q] >> 4, tq = buf[q] & 15;
            if (tq > 3 || pq > 1) return kBadData;
            int step = pq ? 2 : 1;
            if (q + 1 + 64 * step > end) return kBadData;
            for (int k = 0; k < 64; ++k)
              qt[tq][g_zigzag[k]] = pq ? (uint16_t)u16(q + 1 + 2 * k) : buf[q + 1 + k];
            qt_defined[tq] = true;
            q += 1 + 64 * step;
          }
          break;
        }
        case 0xDD:  // DRI
          if (body < 2) return kBadData;
          restart_interval = u16(p);
          break;
        case 0xDA: {  // SOS
          int64_t next;
          int rc = parse_sos(p, body, next);
          if (rc) return rc;
          pos = next;
          continue;
        }
        case 0xE0:
          if (body >= 5 && !std::memcmp(buf + p, "JFIF\0", 5)) jfif = true;
          break;
        case 0xEE:
          if (body >= 12 && !std::memcmp(buf + p, "Adobe", 5)) {
            adobe = true;
            adobe_transform = buf[p + 11];
          }
          break;
        default:
          break;
      }
      pos += seglen;
    }
  }

  bool is_rgb() const {
    // libjpeg-turbo's default_decompress_parms for three components
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }
};

// libjpeg's jidctint.c (ISLOW): 13-bit constants, 2 extra bits in pass 1
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// the post-IDCT range limit: value x (centred on 0) -> sample, through the
// 1024-entry table libjpeg indexes with (x & 1023)
inline uint8_t idct_limit(int64_t x) {
  int v = (int)(x & 1023);
  if (v < 128) return (uint8_t)(v + 128);
  if (v < 384) return 255;
  if (v < 896) return 0;
  return (uint8_t)(v - 896);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* ip = in + col;
    const uint16_t* qp = q + col;
    int* wp = ws + col;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = (int64_t)ip[16] * qp[16];
    z3 = (int64_t)ip[48] * qp[48];
    z1 = (z2 + z3) * F0541;
    tmp2 = z1 + z3 * -F1847;
    tmp3 = z1 + z2 * F0765;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    tmp0 = (z2 + z3) * (1 << kConstBits);
    tmp1 = (z2 - z3) * (1 << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = (int)descale(tmp10 + tmp3, sh);
    wp[56] = (int)descale(tmp10 - tmp3, sh);
    wp[8] = (int)descale(tmp11 + tmp2, sh);
    wp[48] = (int)descale(tmp11 - tmp2, sh);
    wp[16] = (int)descale(tmp12 + tmp1, sh);
    wp[40] = (int)descale(tmp12 - tmp1, sh);
    wp[24] = (int)descale(tmp13 + tmp0, sh);
    wp[32] = (int)descale(tmp13 - tmp0, sh);
  }
  for (int row = 0; row < 8; ++row) {
    const int* wp = ws + row * 8;
    uint8_t* op = out + (size_t)row * stride;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = wp[2];
    z3 = wp[6];
    z1 = (z2 + z3) * F0541;
    tmp2 = z1 + z3 * -F1847;
    tmp3 = z1 + z2 * F0765;
    tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << kConstBits);
    tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    op[0] = idct_limit(descale(tmp10 + tmp3, sh));
    op[7] = idct_limit(descale(tmp10 - tmp3, sh));
    op[1] = idct_limit(descale(tmp11 + tmp2, sh));
    op[6] = idct_limit(descale(tmp11 - tmp2, sh));
    op[2] = idct_limit(descale(tmp12 + tmp1, sh));
    op[5] = idct_limit(descale(tmp12 - tmp1, sh));
    op[3] = idct_limit(descale(tmp13 + tmp0, sh));
    op[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

// One component's samples at full resolution [height, width]: IDCT of
// every block, then libjpeg-turbo's upsampler for the component's ratio.
// The rows above the first and below the last (dh - 1) repeat the edge
// row, and the fancy filters treat column dw - 1 as the last.
void component_plane(const Component& c, int hmax, int vmax, int width, int height,
                     std::vector<uint8_t>& out) {
  const int pw = c.bw * 8, ph = c.bh * 8;
  std::vector<uint8_t> plane((size_t)pw * ph);
  for (int by = 0; by < c.bh; ++by)
    for (int bx = 0; bx < c.bw; ++bx)
      idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.quant,
                 &plane[(size_t)by * 8 * pw + bx * 8], pw);
  const int hr = hmax / c.h, vr = vmax / c.v;
  out.assign((size_t)width * height, 0);
  const int dw = c.dw, dh = c.dh;
  auto in = [&](int y, int x) -> int {
    y = y < 0 ? 0 : (y > dh - 1 ? dh - 1 : y);
    return plane[(size_t)y * pw + x];
  };
  const bool fancy_h = dw > 2;  // libjpeg-turbo falls back to replication below 3
  std::vector<uint8_t> row((size_t)dw * hr + 2);
  for (int oy = 0; oy < height; ++oy) {
    uint8_t* op = &out[(size_t)oy * width];
    if (hr == 1 && vr == 1) {
      std::memcpy(op, &plane[(size_t)oy * pw], width);
      continue;
    }
    const int iy = oy / vr;
    if (hr == 2 && vr == 2 && fancy_h) {  // h2v2_fancy_upsample
      const int ny = (oy % 2 == 0) ? iy - 1 : iy + 1;
      int this_sum = in(iy, 0) * 3 + in(ny, 0);
      int next_sum = in(iy, 1) * 3 + in(ny, 1);
      row[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
      row[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      int k = 2;
      for (int x = 2; x < dw; ++x) {
        next_sum = in(iy, x) * 3 + in(ny, x);
        row[k++] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        row[k++] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      row[k++] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      row[k++] = (uint8_t)((this_sum * 4 + 7) >> 4);
    } else if (hr == 2 && vr == 1 && fancy_h) {  // h2v1_fancy_upsample
      const uint8_t* ip = &plane[(size_t)iy * pw];
      int k = 0;
      int v0 = ip[0];
      row[k++] = (uint8_t)v0;
      row[k++] = (uint8_t)((v0 * 3 + ip[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        int v = ip[x] * 3;
        row[k++] = (uint8_t)((v + ip[x - 1] + 1) >> 2);
        row[k++] = (uint8_t)((v + ip[x + 1] + 2) >> 2);
      }
      int vl = ip[dw - 1];
      row[k++] = (uint8_t)((vl * 3 + ip[dw - 2] + 1) >> 2);
      row[k++] = (uint8_t)vl;
    } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      const int ny = (oy % 2 == 0) ? iy - 1 : iy + 1;
      const int bias = (oy % 2 == 0) ? 1 : 2;
      for (int x = 0; x < dw; ++x) row[x] = (uint8_t)((in(iy, x) * 3 + in(ny, x) + bias) >> 2);
    } else {  // integral replication (int_upsample, h2v1/h2v2_upsample)
      const uint8_t* ip = &plane[(size_t)iy * pw];
      for (int x = 0; x < dw; ++x)
        for (int j = 0; j < hr; ++j) row[(size_t)x * hr + j] = ip[x];
    }
    std::memcpy(op, row.data(), width);
  }
}

// jdcolor.c: fixed-point YCbCr -> RGB tables
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16;
    const int64_t half = (int64_t)1 << (kScale - 1);
    auto fix = [&](double x) { return (int64_t)(x * (1L << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
} g_ycc;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// --------------------------------------------------------- JPEG encode --

const uint8_t kStdLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// the standard Huffman tables (ITU T.81 Annex K.3)
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Codes {
  uint16_t code[256];
  uint8_t size[256];  // 0: no code for the symbol
};

void make_codes(const uint8_t* bits, const uint8_t* vals, Codes& c) {
  std::memset(c.size, 0, sizeof(c.size));
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
      c.code[vals[k]] = (uint16_t)code;
      c.size[vals[k]] = (uint8_t)l;
    }
    code <<= 1;
  }
}

struct Writer {
  uint8_t* out;
  int64_t cap;
  int64_t n = 0;
  bool overflow = false;
  uint32_t acc = 0;
  int nbits = 0;

  void byte(uint8_t b) {
    if (n < cap) out[n] = b; else overflow = true;
    ++n;
  }
  void u16(int v) {
    byte((uint8_t)(v >> 8));
    byte((uint8_t)v);
  }
  void bits(uint32_t v, int len) {
    while (len > 0) {
      int take = len > 16 ? 16 : len;
      len -= take;
      acc = (acc << take) | ((v >> len) & ((1u << take) - 1));
      nbits += take;
      while (nbits >= 8) {
        uint8_t b = (uint8_t)(acc >> (nbits - 8));
        byte(b);
        if (b == 0xFF) byte(0);
        nbits -= 8;
      }
    }
  }
  void flush() {
    if (nbits > 0) bits((1u << (8 - nbits)) - 1, 8 - nbits);  // pad with ones
  }
};

void scaled_quant(const uint8_t* base, int quality, uint16_t* q) {
  quality = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = ((long)base[i] * scale + 50) / 100;
    q[i] = (uint16_t)(t < 1 ? 1 : (t > 255 ? 255 : t));
  }
}

struct Dct {
  double c[8][8];  // c[u][x] = C(u)/2 cos((2x+1) u pi / 16)
  Dct() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        c[u][x] = (u == 0 ? std::sqrt(0.125) : 0.5) * std::cos((2 * x + 1) * u * kPi / 16.0);
  }
} g_dct;

// forward DCT of one level-shifted block and quantization (rounded to
// nearest), coefficients in natural order
void fdct_quant(const double* blk, const uint16_t* q, int* out) {
  double tmp[64];
  for (int y = 0; y < 8; ++y)
    for (int u = 0; u < 8; ++u) {
      double s = 0;
      for (int x = 0; x < 8; ++x) s += g_dct.c[u][x] * blk[y * 8 + x];
      tmp[y * 8 + u] = s;
    }
  for (int v = 0; v < 8; ++v)
    for (int u = 0; u < 8; ++u) {
      double s = 0;
      for (int y = 0; y < 8; ++y) s += g_dct.c[v][y] * tmp[y * 8 + u];
      out[v * 8 + u] = (int)std::lround(s / q[v * 8 + u]);
    }
}

inline int bit_size(int v) {
  v = v < 0 ? -v : v;
  int s = 0;
  while (v) {
    ++s;
    v >>= 1;
  }
  return s;
}

void encode_block(Writer& w, const int* coef, int& pred, const Codes& dc, const Codes& ac) {
  int diff = coef[0] - pred;
  pred = coef[0];
  int s = bit_size(diff);
  w.bits(dc.code[s], dc.size[s]);
  if (s) w.bits((uint32_t)(diff < 0 ? diff - 1 : diff) & ((1u << s) - 1), s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[g_zigzag[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    s = bit_size(v);
    int sym = (run << 4) | s;
    w.bits(ac.code[sym], ac.size[sym]);
    w.bits((uint32_t)(v < 0 ? v - 1 : v) & ((1u << s) - 1), s);
    run = 0;
  }
  if (run) w.bits(ac.code[0x00], ac.size[0x00]);
}

}  // namespace

extern "C" {

// PNG: rows of `1 + rowbytes` bytes (filter type, then the filtered row)
// -> `height * rowbytes` bytes; bpp is the filter's byte distance.
int png_unfilter(const uint8_t* src, int64_t height, int64_t rowbytes, int bpp, uint8_t* dst) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (rowbytes + 1);
    const int f = in[0];
    ++in;
    uint8_t* out = dst + y * rowbytes;
    const uint8_t* up = y ? out - rowbytes : nullptr;
    switch (f) {
      case 0:
        std::memcpy(out, in, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i) out[i] = in[i] + (i >= bpp ? out[i - bpp] : 0);
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i) out[i] = in[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0, b = up ? up[i] : 0;
          out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (i >= bpp && up) ? up[i - bpp] : 0;
          out[i] = (uint8_t)(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return kBadData;
    }
  }
  return kOk;
}

// The Exif Orientation (tag 0x0112) of a TIFF structure ("II" or "MM",
// 42, the offset of IFD0, its entries), read as OpenCV's ExifReader reads
// it: a 16-bit value 8 bytes into IFD0's entry, whatever the entry's type.
// Returns 1 (no transform) where the structure is cut short or malformed
// or has no such tag.
int exif_orientation(const uint8_t* tiff, int64_t len) {
  if (len < 8) return 1;
  const bool le = tiff[0] == 'I' && tiff[1] == 'I';
  if (!le && !(tiff[0] == 'M' && tiff[1] == 'M')) return 1;
  auto u16 = [&](int64_t o) -> int64_t {
    if (o < 0 || o + 1 >= len) return -1;
    return le ? tiff[o] | tiff[o + 1] << 8 : tiff[o] << 8 | tiff[o + 1];
  };
  auto u32 = [&](int64_t o) -> int64_t {
    if (o < 0 || o + 3 >= len) return -1;
    const int64_t a = u16(o), b = u16(o + 2);
    return le ? a | b << 16 : a << 16 | b;
  };
  if (u16(2) != 42) return 1;
  const int64_t ifd = u32(4), n = u16(ifd);
  if (ifd < 0 || n < 0) return 1;
  int64_t orientation = 0;  // the first entry of the tag counts
  for (int64_t i = 0; i < n; ++i) {
    const int64_t e = ifd + 2 + 12 * i, tag = u16(e);
    if (tag < 0) return 1;  // a cut entry fails the whole parse, as OpenCV's does
    if (tag == 0x0112 && orientation == 0) {
      orientation = u16(e + 8);
      if (orientation < 0) return 1;
    }
  }
  return orientation ? (int)orientation : 1;
}

// JPEG header: info = [width, height, components, orientation]. The
// markers are read up to the first scan, as libjpeg's jpeg_read_header
// does; orientation is the Exif Orientation of the first APP1 segment
// (exif_orientation), 1 where it has none.
int jpeg_info(const uint8_t* buf, int64_t len, int32_t* info) {
  if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return kNotJpeg;
  int64_t pos = 2;
  bool frame = false, app1 = false;
  info[3] = 1;
  while (pos + 4 <= len) {
    while (pos < len && buf[pos] != 0xFF) ++pos;
    while (pos < len && buf[pos] == 0xFF) ++pos;
    if (pos + 3 > len) break;
    int marker = buf[pos++];
    if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
    if (marker == 0xD9 || marker == 0xDA) break;  // EOI, SOS
    int seglen = (buf[pos] << 8) | buf[pos + 1];
    if (seglen < 2 || pos + seglen > len) return kTruncated;
    if (marker >= 0xC9 && marker <= 0xCF && marker != 0xCC) return kArithmetic;
    if (marker == 0xC3 || (marker >= 0xC5 && marker <= 0xC7)) return kUnsupported;
    if (marker >= 0xC0 && marker <= 0xC2 && !frame) {
      if (seglen < 8) return kTruncated;
      info[0] = (buf[pos + 5] << 8) | buf[pos + 6];
      info[1] = (buf[pos + 3] << 8) | buf[pos + 4];
      info[2] = buf[pos + 7];
      frame = true;
    }
    if (marker == 0xE1 && !app1) {  // OpenCV reads the first APP1 past 6 bytes
      app1 = true;
      if (seglen - 2 > 6) info[3] = exif_orientation(buf + pos + 8, seglen - 8);
    }
    pos += seglen;
  }
  return frame ? kOk : kNoFrame;
}

// JPEG decode into out: [height, width, 3] RGB, or [height, width] when
// gray != 0 (the luma plane, as libjpeg gives JCS_GRAYSCALE for YCbCr).
// width and height are the sizes `out` was allocated for (jpeg_info's); a
// stream whose frame differs is refused.
int jpeg_decode(const uint8_t* buf, int64_t len, int gray, uint8_t* out, int width, int height) {
  Decoder d;
  d.buf = buf;
  d.len = len;
  int rc = d.parse();
  if (rc) return rc;
  if (!d.frame) return kNoFrame;
  if (d.width != width || d.height != height) return kBadData;
  for (int i = 0; i < d.ncomp; ++i)
    if (!d.comp[i].latched) return kBadData;  // a component no scan carried
  const int w = d.width, h = d.height;
  const size_t npix = (size_t)w * h;
  std::vector<uint8_t> p0, p1, p2;
  component_plane(d.comp[0], d.hmax, d.vmax, w, h, p0);
  if (d.ncomp == 1) {
    if (gray) {
      std::memcpy(out, p0.data(), npix);
    } else {
      for (size_t i = 0; i < npix; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = p0[i];
    }
    return kOk;
  }
  const bool rgb = d.is_rgb();
  if (gray && !rgb) {
    std::memcpy(out, p0.data(), npix);
    return kOk;
  }
  component_plane(d.comp[1], d.hmax, d.vmax, w, h, p1);
  component_plane(d.comp[2], d.hmax, d.vmax, w, h, p2);
  if (rgb) {
    for (size_t i = 0; i < npix; ++i) {
      if (gray) {  // jdcolor.c rgb_gray_convert
        const int64_t half = (int64_t)1 << 15;
        out[i] = (uint8_t)((19595 * p0[i] + 38470 * p1[i] + 7471 * p2[i] + half) >> 16);
      } else {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
    }
    return kOk;
  }
  for (size_t i = 0; i < npix; ++i) {
    const int y = p0[i], cb = p1[i], cr = p2[i];
    out[3 * i] = clamp255(y + g_ycc.cr_r[cr]);
    out[3 * i + 1] = clamp255(y + (int)((g_ycc.cb_g[cb] + g_ycc.cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp255(y + g_ycc.cb_b[cb]);
  }
  return kOk;
}

// JPEG encode of [height, width, channels] uint8 (channels 1: gray, 3:
// RGB, written as YCbCr 4:2:0) at `quality`. Returns the byte count, or
// kOutOfSpace when `cap` bytes do not hold it.
int64_t jpeg_encode(const uint8_t* img, int height, int width, int channels, int quality,
                    uint8_t* out, int64_t cap) {
  if (height < 1 || width < 1 || height > 65535 || width > 65535) return kUnsupported;
  if (channels != 1 && channels != 3) return kUnsupported;
  const int ncomp = channels;
  const int hs = ncomp == 3 ? 2 : 1;  // luma sampling factor (both axes)
  const int mcu = 8 * hs;
  const int mcux = (width + mcu - 1) / mcu, mcuy = (height + mcu - 1) / mcu;
  const int pw = mcux * mcu, ph = mcuy * mcu;  // edge-replicated padding

  // planes at full resolution, level-shifted later
  std::vector<uint8_t> planes[3];
  for (int c = 0; c < ncomp; ++c) planes[c].resize((size_t)pw * ph);
  for (int y = 0; y < ph; ++y) {
    const int sy = y < height ? y : height - 1;
    for (int x = 0; x < pw; ++x) {
      const int sx = x < width ? x : width - 1;
      const uint8_t* p = img + ((size_t)sy * width + sx) * channels;
      const size_t o = (size_t)y * pw + x;
      if (ncomp == 1) {
        planes[0][o] = p[0];
        continue;
      }
      // jccolor.c rgb_ycc_convert, 16-bit fixed point
      const int64_t r = p[0], g = p[1], b = p[2];
      const int64_t half = (int64_t)1 << 15, off = (int64_t)128 << 16;
      planes[0][o] = (uint8_t)((19595 * r + 38470 * g + 7471 * b + half) >> 16);
      planes[1][o] = (uint8_t)((-11059 * r - 21709 * g + 32768 * b + off + half - 1) >> 16);
      planes[2][o] = (uint8_t)((32768 * r - 27439 * g - 5329 * b + off + half - 1) >> 16);
    }
  }
  // chroma 2x2 box, jcsample.c h2v2_downsample's alternating bias
  const int cw = pw / hs, ch = ph / hs;
  std::vector<uint8_t> chroma[2];
  if (ncomp == 3) {
    for (int c = 0; c < 2; ++c) {
      chroma[c].resize((size_t)cw * ch);
      const std::vector<uint8_t>& src = planes[c + 1];
      for (int y = 0; y < ch; ++y) {
        int bias = 1;
        for (int x = 0; x < cw; ++x) {
          const size_t o = (size_t)(2 * y) * pw + 2 * x;
          chroma[c][(size_t)y * cw + x] =
              (uint8_t)((src[o] + src[o + 1] + src[o + pw] + src[o + pw + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
  }

  uint16_t qlum[64], qchrom[64];
  scaled_quant(kStdLumQuant, quality, qlum);
  scaled_quant(kStdChromQuant, quality, qchrom);
  Codes dc_lum, ac_lum, dc_chrom, ac_chrom;
  make_codes(kDcLumBits, kDcVals, dc_lum);
  make_codes(kAcLumBits, kAcLumVals, ac_lum);
  make_codes(kDcChromBits, kDcVals, dc_chrom);
  make_codes(kAcChromBits, kAcChromVals, ac_chrom);

  Writer w{out, cap};
  w.u16(0xFFD8);
  // JFIF APP0: version 1.1, no density units, 1:1
  const uint8_t app0[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  w.u16(0xFFE0);
  w.u16(2 + sizeof(app0));
  for (uint8_t b : app0) w.byte(b);
  for (int t = 0; t < (ncomp == 3 ? 2 : 1); ++t) {  // DQT, 8-bit entries
    const uint16_t* q = t ? qchrom : qlum;
    w.u16(0xFFDB);
    w.u16(2 + 65);
    w.byte((uint8_t)t);
    for (int k = 0; k < 64; ++k) w.byte((uint8_t)q[g_zigzag[k]]);
  }
  w.u16(0xFFC0);  // SOF0
  w.u16(8 + 3 * ncomp);
  w.byte(8);
  w.u16(height);
  w.u16(width);
  w.byte((uint8_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    w.byte((uint8_t)(c + 1));
    w.byte(c == 0 ? (uint8_t)(hs << 4 | hs) : 0x11);
    w.byte(c == 0 ? 0 : 1);
  }
  auto dht = [&](int cls_id, const uint8_t* bits, const uint8_t* vals) {
    int n = 0;
    for (int l = 0; l < 16; ++l) n += bits[l];
    w.u16(0xFFC4);
    w.u16(2 + 17 + n);
    w.byte((uint8_t)cls_id);
    for (int l = 0; l < 16; ++l) w.byte(bits[l]);
    for (int i = 0; i < n; ++i) w.byte(vals[i]);
  };
  dht(0x00, kDcLumBits, kDcVals);
  dht(0x10, kAcLumBits, kAcLumVals);
  if (ncomp == 3) {
    dht(0x01, kDcChromBits, kDcVals);
    dht(0x11, kAcChromBits, kAcChromVals);
  }
  w.u16(0xFFDA);  // SOS: one interleaved scan
  w.u16(6 + 2 * ncomp);
  w.byte((uint8_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    w.byte((uint8_t)(c + 1));
    w.byte(c == 0 ? 0x00 : 0x11);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  int pred[3] = {0, 0, 0};
  double blk[64];
  int coef[64];
  auto block_from = [&](const uint8_t* src, int stride, int x0, int y0) {
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) blk[y * 8 + x] = (double)src[(size_t)(y0 + y) * stride + x0 + x] - 128.0;
  };
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      for (int by = 0; by < hs; ++by)
        for (int bx = 0; bx < hs; ++bx) {
          block_from(planes[0].data(), pw, mx * mcu + bx * 8, my * mcu + by * 8);
          fdct_quant(blk, qlum, coef);
          encode_block(w, coef, pred[0], dc_lum, ac_lum);
        }
      for (int c = 0; c < ncomp - 1; ++c) {
        block_from(chroma[c].data(), cw, mx * 8, my * 8);
        fdct_quant(blk, qchrom, coef);
        encode_block(w, coef, pred[c + 1], dc_chrom, ac_chrom);
      }
    }
  w.flush();
  w.u16(0xFFD9);
  if (w.overflow) return kOutOfSpace;
  return w.n;
}

}  // extern "C"
