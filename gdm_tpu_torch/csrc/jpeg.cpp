// Baseline and progressive JPEG decode, and baseline encode, on the host.
//
// Host code of gdm_tpu_torch/data/imio.py (not a device kernel): the BOP
// train_pbr frames are JPEG, and the card's host has neither cv2 nor PIL.
// The decoder gives what cv2.imread(path, IMREAD_COLOR) gives through
// libjpeg-turbo's default decompression, sample for sample:
//
//   * Huffman sequential 8-bit scans (SOF0, SOF1), interleaved or not, with
//     restart markers; 1 (gray) or 3 components;
//   * dequantisation and the ISLOW integer inverse DCT of jidctint.c
//     (CONST_BITS 13, PASS1_BITS 2) with its post-IDCT range limit;
//   * "fancy" triangle upsampling of jdsample.c for 2x1 (4:2:2), 2x2
//     (4:2:0) and 1x2 (4:4:0) chroma, edge rows and columns replicated as
//     jdmainct.c does, and its box upsampling for other integral factors
//     (4:1:1) and for chroma at most 2 samples wide;
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c (SCALEBITS 16);
//   * progressive scans (SOF2): DC first and refinement, AC first and
//     refinement with EOB runs (jdphuff.c), into one coefficient buffer
//     per component that the IDCT reads after the last scan;
//   * JCS_GRAYSCALE output: the luma plane, or jdcolor.c's rgb_gray of an
//     Adobe RGB file.
//
// Arithmetic-coded, lossless, hierarchical, 12-bit and 4-component files,
// and progressive files whose scans leave low coefficients unrefined
// (libjpeg-turbo block-smooths those), return an error code, and the
// Python wrapper raises naming the file.  So do truncated files.
// Entropy decoding is sequential per bit, which is why this is C++ and
// not numpy.  The encoder writes baseline files (standard Annex K tables,
// libjpeg's quality scaling, 4:2:0 or 4:4:4, optional restart interval)
// for the synthetic train_pbr frames of data/synthetic.py.
//
// Built at first use with the host C++ compiler (gdm_tpu_torch/_build.py)
// and called through ctypes, which releases the GIL for loader threads.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err {
  OK = 0,
  NOT_JPEG = 1,
  CORRUPT = 2,
  SMOOTHING = 3,       // progressive, some low coefficients never refined
  ARITHMETIC = 4,
  PRECISION = 5,
  UNSUPPORTED = 6,
  NO_TABLE = 7,
  TOO_SMALL = 8,
  BAD_PROGRESSION = 9,  // a scan libjpeg warns of (JWRN_BOGUS_PROGRESSION)
};

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huff {
  bool present = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | value, 0 = longer code
  uint16_t look[512];
};

bool build_huff(Huff& h, const uint8_t* bits, const uint8_t* vals, int nvals) {
  int code = 0, k = 0;
  std::memset(h.look, 0, sizeof(h.look));
  for (int l = 1; l <= 16; ++l) {
    int n = bits[l - 1];
    h.valoffset[l] = k - code;
    for (int i = 0; i < n; ++i, ++k, ++code) {
      if (k >= nvals) return false;
      if (l <= 9) {
        int shift = 9 - l;
        for (int j = 0; j < (1 << shift); ++j)
          h.look[(code << shift) | j] = static_cast<uint16_t>((l << 8) | vals[k]);
      }
    }
    h.maxcode[l] = n ? code - 1 : -1;
    if (code > (1 << l)) return false;
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  std::memcpy(h.vals, vals, nvals);
  h.present = true;
  return true;
}

struct Reader {
  const uint8_t* d;
  int64_t n, pos;
  uint32_t buf = 0;
  int cnt = 0;
  bool hit_marker = false;

  void fill() {
    while (cnt <= 24) {
      uint32_t byte = 0;
      if (!hit_marker && pos < n) {
        byte = d[pos];
        if (byte == 0xFF) {
          uint8_t nxt = pos + 1 < n ? d[pos + 1] : 0;
          if (nxt == 0x00) {
            pos += 2;
          } else {            // a marker: feed zeros, as libjpeg does
            hit_marker = true;
            byte = 0;
          }
        } else {
          pos += 1;
        }
      }
      buf |= byte << (24 - cnt);
      cnt += 8;
    }
  }
  int bits(int k) {           // k <= 16
    if (k == 0) return 0;
    fill();
    int v = static_cast<int>(buf >> (32 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }
  int decode(const Huff& h) {
    fill();
    uint16_t e = h.look[buf >> 23];
    if (e) {
      int l = e >> 8;
      buf <<= l;
      cnt -= l;
      return e & 0xFF;
    }
    int code = static_cast<int>(buf >> 23);
    int l = 9;
    buf <<= 9;
    cnt -= 9;
    while (code > h.maxcode[l]) {
      code = (code << 1) | bits(1);
      if (++l > 16) return -1;
    }
    return h.vals[code + h.valoffset[l]];
  }
  void reset() {              // byte-align after a restart marker
    buf = 0;
    cnt = 0;
    hit_marker = false;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Comp {
  int id, h, v, tq;
  int bw, bh;                 // blocks stored (MCU-padded)
  int cw, ch;                 // samples of the component in the image
  std::vector<int16_t> coef;  // [bh][bw][64], natural order
  int dc_tbl = 0, ac_tbl = 0, pred = 0;
  int coef_bits[64];          // progressive: Al of the last scan, -1 = none
};

struct Decoder {
  const uint8_t* d;
  int64_t n;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  std::vector<Comp> comps;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  int adobe_transform = -1;   // APP14 Adobe colour transform, -1 = none
  bool jfif = false;          // an APP0 JFIF marker
  bool frame = false;
  bool progressive = false;
  int eobrun = 0;             // progressive AC scans: blocks left in an EOB run
};

int read_u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

int decode_block(Reader& r, Decoder& D, Comp& c, int16_t* blk) {
  const Huff& hd = D.dc[c.dc_tbl];
  const Huff& ha = D.ac[c.ac_tbl];
  int s = r.decode(hd);
  if (s < 0 || s > 11) return CORRUPT;
  int diff = s ? extend(r.bits(s), s) : 0;
  c.pred += diff;
  blk[0] = static_cast<int16_t>(c.pred);
  for (int k = 1; k < 64;) {
    int rs = r.decode(ha);
    if (rs < 0) return CORRUPT;
    int run = rs >> 4, sz = rs & 15;
    if (sz) {
      k += run;
      if (k > 63) return CORRUPT;
      blk[kZigzag[k]] = static_cast<int16_t>(extend(r.bits(sz), sz));
      ++k;
    } else if (run == 15) {
      k += 16;
    } else {
      break;
    }
  }
  return OK;
}

// jdphuff.c decode_mcu_DC_first / _DC_refine for one block
int decode_dc_prog(Reader& r, Decoder& D, Comp& c, int16_t* blk, int ah,
                   int al) {
  if (ah == 0) {
    int s = r.decode(D.dc[c.dc_tbl]);
    if (s < 0 || s > 11) return CORRUPT;
    c.pred += s ? extend(r.bits(s), s) : 0;
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.pred) << al);
  } else if (r.bits(1)) {
    blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }
  return OK;
}

// jdphuff.c decode_mcu_AC_first for one block
int decode_ac_first(Reader& r, Decoder& D, Comp& c, int16_t* blk, int ss,
                    int se, int al) {
  if (D.eobrun > 0) {
    --D.eobrun;
    return OK;
  }
  const Huff& ha = D.ac[c.ac_tbl];
  for (int k = ss; k <= se; ++k) {
    int rs = r.decode(ha);
    if (rs < 0) return CORRUPT;
    int run = rs >> 4, sz = rs & 15;
    if (sz) {
      k += run;
      if (k > 63) return CORRUPT;
      int v = extend(r.bits(sz), sz);
      blk[kZigzag[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
    } else if (run == 15) {
      k += 15;
    } else {
      D.eobrun = (1 << run) - 1;
      if (run) D.eobrun += r.bits(run);
      break;
    }
  }
  return OK;
}

// jdphuff.c decode_mcu_AC_refine for one block: new coefficients of
// magnitude 1 << al, and a correction bit for every coefficient already
// nonzero that the band passes over
int decode_ac_refine(Reader& r, Decoder& D, Comp& c, int16_t* blk, int ss,
                     int se, int al) {
  const int p1 = 1 << al, m1 = -p1;
  auto refine = [&](int16_t& coef) {
    if (r.bits(1) && (coef & p1) == 0)
      coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
  };
  int k = ss;
  if (D.eobrun == 0) {
    const Huff& ha = D.ac[c.ac_tbl];
    for (; k <= se; ++k) {
      int rs = r.decode(ha);
      if (rs < 0) return CORRUPT;
      int run = rs >> 4, sz = rs & 15, v = 0;
      if (sz) {
        v = r.bits(1) ? p1 : m1;      // libjpeg takes any size as 1
      } else if (run != 15) {
        D.eobrun = 1 << run;
        if (run) D.eobrun += r.bits(run);
        break;
      }
      // skip `run` zero coefficients, refining the nonzero ones passed
      for (; k <= se; ++k) {
        int16_t& coef = blk[kZigzag[k]];
        if (coef != 0) {
          refine(coef);
        } else if (--run < 0) {
          break;
        }
      }
      if (v) {
        if (k > 63) return CORRUPT;
        blk[kZigzag[k]] = static_cast<int16_t>(v);
      }
    }
  }
  if (D.eobrun > 0) {
    for (; k <= se; ++k) {
      int16_t& coef = blk[kZigzag[k]];
      if (coef != 0) refine(coef);
    }
    --D.eobrun;
  }
  return OK;
}

int decode_scan(Decoder& D, const uint8_t* seg, int seglen, int64_t& pos) {
  int ns = seg[0];
  if (ns < 1 || ns > 4 || seglen < 1 + 2 * ns + 3) return CORRUPT;
  int ss = seg[1 + 2 * ns], se = seg[2 + 2 * ns];
  int ah = seg[3 + 2 * ns] >> 4, al = seg[3 + 2 * ns] & 15;
  // which tables the scan decodes with: a DC refinement reads raw bits
  bool need_dc = !D.progressive || (ss == 0 && ah == 0);
  bool need_ac = !D.progressive || ss != 0;
  if (!D.progressive) {
    if (ss != 0 || se != 63 || ah != 0 || al != 0) return CORRUPT;
  } else if ((ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) ||
             (ah != 0 && al != ah - 1) || al > 13) {
    return CORRUPT;                    // jdphuff.c JERR_BAD_PROGRESSION
  }
  std::vector<Comp*> sc;
  for (int i = 0; i < ns; ++i) {
    int id = seg[1 + 2 * i], t = seg[2 + 2 * i];
    Comp* c = nullptr;
    for (auto& cc : D.comps)
      if (cc.id == id) c = &cc;
    if (!c) return CORRUPT;
    c->dc_tbl = t >> 4;
    c->ac_tbl = t & 15;
    if (c->dc_tbl > 3 || c->ac_tbl > 3 ||
        (need_dc && !D.dc[c->dc_tbl].present) ||
        (need_ac && !D.ac[c->ac_tbl].present))
      return NO_TABLE;
    c->pred = 0;
    if (D.progressive) {
      // libjpeg-turbo warns and decodes on; such a file (scans dropped or
      // reordered) decodes to what its bits happen to give, so refuse it
      if (ss != 0 && c->coef_bits[0] < 0) return BAD_PROGRESSION;
      for (int k = ss; k <= se; ++k) {
        if (ah != std::max(c->coef_bits[k], 0)) return BAD_PROGRESSION;
        c->coef_bits[k] = al;
      }
    }
    sc.push_back(c);
  }
  D.eobrun = 0;

  auto block = [&](Reader& r, Comp& c, int16_t* blk) {
    if (!D.progressive) return decode_block(r, D, c, blk);
    if (ss == 0) return decode_dc_prog(r, D, c, blk, ah, al);
    return ah == 0 ? decode_ac_first(r, D, c, blk, ss, se, al)
                   : decode_ac_refine(r, D, c, blk, ss, se, al);
  };
  Reader r{D.d, D.n, pos};
  int64_t total, per_row;
  if (ns == 1) {               // non-interleaved: the component's own blocks
    Comp& c = *sc[0];
    per_row = (c.cw + 7) / 8;
    total = per_row * ((c.ch + 7) / 8);
  } else {
    per_row = D.mcux;
    total = static_cast<int64_t>(D.mcux) * D.mcuy;
  }
  for (int64_t m = 0; m < total; ++m) {
    if (D.restart && m > 0 && m % D.restart == 0) {
      // expect RSTn: skip to the marker, reset the predictors and EOB run
      int64_t p = r.pos;
      while (p + 1 < D.n && !(D.d[p] == 0xFF && D.d[p + 1] >= 0xD0 &&
                              D.d[p + 1] <= 0xD7))
        ++p;
      if (p + 1 >= D.n) return CORRUPT;
      r.pos = p + 2;
      r.reset();
      for (auto* c : sc) c->pred = 0;
      D.eobrun = 0;
    }
    int64_t my = m / per_row, mx = m % per_row;
    if (ns == 1) {
      Comp& c = *sc[0];
      int e = block(r, c, &c.coef[(my * c.bw + mx) * 64]);
      if (e) return e;
    } else {
      for (auto* cp : sc) {
        Comp& c = *cp;
        for (int by = 0; by < c.v; ++by)
          for (int bx = 0; bx < c.h; ++bx) {
            int64_t row = my * c.v + by, col = mx * c.h + bx;
            int e = block(r, c, &c.coef[(row * c.bw + col) * 64]);
            if (e) return e;
          }
      }
    }
  }
  // continue at the next marker
  int64_t p = r.pos;
  while (p + 1 < D.n && !(D.d[p] == 0xFF && D.d[p + 1] != 0x00 &&
                          !(D.d[p + 1] >= 0xD0 && D.d[p + 1] <= 0xD7)))
    ++p;
  pos = p;
  return OK;
}

// jdcoefct.c smoothing_ok: libjpeg-turbo block-smooths a progressive
// image whose DC is known but whose first nine AC coefficients (in zigzag
// order) are not all refined to the last bit, in some component
bool needs_smoothing(const Decoder& D) {
  if (!D.progressive) return false;
  bool useful = false;
  for (const auto& c : D.comps) {
    for (int k = 0; k < 10; ++k)
      if (D.qt[c.tq][kZigzag[k]] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

// jidctint.c jpeg_idct_islow, 8-bit samples
const int CONST_BITS = 13, PASS1_BITS = 2;
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) {
  return (x + (1 << (n - 1))) >> n;
}

inline uint8_t range_limit(int32_t x) {     // post-IDCT table, & RANGE_MASK
  int i = x & 1023;
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int32_t* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int32_t dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int k = 0; k < 8; ++k) wp[8 * k] = dc;
      continue;
    }
    int32_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int32_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int32_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = descale(tmp10 + tmp3, sh);
    wp[56] = descale(tmp10 - tmp3, sh);
    wp[8] = descale(tmp11 + tmp2, sh);
    wp[48] = descale(tmp11 - tmp2, sh);
    wp[16] = descale(tmp12 + tmp1, sh);
    wp[40] = descale(tmp12 - tmp1, sh);
    wp[24] = descale(tmp13 + tmp0, sh);
    wp[32] = descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t v = range_limit(descale(wp[0], PASS1_BITS + 3));
      for (int k = 0; k < 8; ++k) op[k] = v;
      continue;
    }
    int32_t z2 = wp[2], z3 = wp[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (wp[0] + wp[4]) * (1 << CONST_BITS);
    int32_t tmp1 = (wp[0] - wp[4]) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int sh = CONST_BITS + PASS1_BITS + 3;
    op[0] = range_limit(descale(tmp10 + tmp3, sh));
    op[7] = range_limit(descale(tmp10 - tmp3, sh));
    op[1] = range_limit(descale(tmp11 + tmp2, sh));
    op[6] = range_limit(descale(tmp11 - tmp2, sh));
    op[2] = range_limit(descale(tmp12 + tmp1, sh));
    op[5] = range_limit(descale(tmp12 - tmp1, sh));
    op[3] = range_limit(descale(tmp13 + tmp0, sh));
    op[4] = range_limit(descale(tmp13 - tmp0, sh));
  }
}

// jdsample.c h2v1_fancy_upsample: one row of cw samples -> 2 cw
// (cw > 2: narrower components take the box upsampler)
void up_h2(const uint8_t* in, int cw, uint8_t* out) {
  int v = in[0];
  out[0] = static_cast<uint8_t>(v);
  out[1] = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
  for (int i = 1; i < cw - 1; ++i) {
    v = in[i] * 3;
    out[2 * i] = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
    out[2 * i + 1] = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
  }
  v = in[cw - 1];
  out[2 * cw - 2] = static_cast<uint8_t>((v * 3 + in[cw - 2] + 1) >> 2);
  out[2 * cw - 1] = static_cast<uint8_t>(v);
}

// jdsample.c h2v2_fancy_upsample: output row from the nearer (in0) and the
// further (in1) input row; bias 8 / 7 alternate as in libjpeg
void up_h2v2_row(const uint8_t* in0, const uint8_t* in1, int cw,
                 uint8_t* out) {
  int this_s = in0[0] * 3 + in1[0];
  int next_s = in0[1] * 3 + in1[1];
  out[0] = static_cast<uint8_t>((this_s * 4 + 8) >> 4);
  out[1] = static_cast<uint8_t>((this_s * 3 + next_s + 7) >> 4);
  int last_s = this_s;
  this_s = next_s;
  for (int i = 1; i < cw - 1; ++i) {
    next_s = in0[i + 1] * 3 + in1[i + 1];
    out[2 * i] = static_cast<uint8_t>((this_s * 3 + last_s + 8) >> 4);
    out[2 * i + 1] = static_cast<uint8_t>((this_s * 3 + next_s + 7) >> 4);
    last_s = this_s;
    this_s = next_s;
  }
  out[2 * cw - 2] = static_cast<uint8_t>((this_s * 3 + last_s + 8) >> 4);
  out[2 * cw - 1] = static_cast<uint8_t>((this_s * 4 + 7) >> 4);
}

int parse(Decoder& D, bool decode_scans) {
  const uint8_t* d = D.d;
  if (D.n < 4 || d[0] != 0xFF || d[1] != 0xD8) return NOT_JPEG;
  int64_t pos = 2;
  while (true) {
    while (pos < D.n && d[pos] != 0xFF) ++pos;    // tolerate junk
    while (pos < D.n && d[pos] == 0xFF) ++pos;    // fill bytes
    if (pos >= D.n) return CORRUPT;
    int marker = d[pos++];
    if (marker == 0xD9) return D.frame ? OK : CORRUPT;   // EOI
    if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) ||
        marker == 0x01)
      continue;
    if (pos + 2 > D.n) return CORRUPT;
    int len = read_u16(d + pos);
    if (len < 2 || pos + len > D.n) return CORRUPT;
    const uint8_t* seg = d + pos + 2;
    int seglen = len - 2;
    pos += len;
    if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2) {   // Huffman
      if (D.frame) return CORRUPT;   // a second frame
      D.progressive = marker == 0xC2;
      if (seglen < 6) return CORRUPT;
      if (seg[0] != 8) return PRECISION;
      D.height = read_u16(seg + 1);
      D.width = read_u16(seg + 3);
      int nc = seg[5];
      if (D.width == 0 || D.height == 0) return UNSUPPORTED;
      if (nc != 1 && nc != 3) return UNSUPPORTED;
      if (seglen < 6 + 3 * nc) return CORRUPT;
      D.comps.resize(nc);
      D.hmax = D.vmax = 1;
      for (int i = 0; i < nc; ++i) {
        Comp& c = D.comps[i];
        c.id = seg[6 + 3 * i];
        c.h = seg[7 + 3 * i] >> 4;
        c.v = seg[7 + 3 * i] & 15;
        c.tq = seg[8 + 3 * i];
        std::fill(c.coef_bits, c.coef_bits + 64, -1);
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
          return CORRUPT;
        D.hmax = std::max(D.hmax, c.h);
        D.vmax = std::max(D.vmax, c.v);
      }
      if (nc == 1) D.comps[0].h = D.comps[0].v = D.hmax = D.vmax = 1;
      D.mcux = (D.width + 8 * D.hmax - 1) / (8 * D.hmax);
      D.mcuy = (D.height + 8 * D.vmax - 1) / (8 * D.vmax);
      for (auto& c : D.comps) {
        if (D.hmax % c.h || D.vmax % c.v)
          return UNSUPPORTED;        // fractional sampling ratios
        c.cw = (D.width * c.h + D.hmax - 1) / D.hmax;
        c.ch = (D.height * c.v + D.vmax - 1) / D.vmax;
        c.bw = D.mcux * c.h;
        c.bh = D.mcuy * c.v;
        if (decode_scans)
          c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      }
      D.frame = true;
      if (!decode_scans) return OK;
    } else if (marker == 0xC9 || marker == 0xCA || marker == 0xCB ||
               marker == 0xCD || marker == 0xCE || marker == 0xCF ||
               marker == 0xCC) {
      return ARITHMETIC;
    } else if (marker == 0xC3 || marker == 0xC5 || marker == 0xC6 ||
               marker == 0xC7 || marker == 0xDE || marker == 0xDF) {
      return UNSUPPORTED;            // lossless, hierarchical
    } else if (marker == 0xC4) {     // DHT
      int p = 0;
      while (p < seglen) {
        if (p + 17 > seglen) return CORRUPT;
        int tc = seg[p] >> 4, th = seg[p] & 15;
        if (tc > 1 || th > 3) return CORRUPT;
        int nv = 0;
        for (int i = 0; i < 16; ++i) nv += seg[p + 1 + i];
        if (nv > 256 || p + 17 + nv > seglen) return CORRUPT;
        Huff& h = tc ? D.ac[th] : D.dc[th];
        if (!build_huff(h, seg + p + 1, seg + p + 17, nv)) return CORRUPT;
        p += 17 + nv;
      }
    } else if (marker == 0xDB) {     // DQT
      int p = 0;
      while (p < seglen) {
        int pq = seg[p] >> 4, tq = seg[p] & 15;
        if (tq > 3 || pq > 1) return CORRUPT;
        int sz = pq ? 128 : 64;
        if (p + 1 + sz > seglen) return CORRUPT;
        for (int k = 0; k < 64; ++k)
          D.qt[tq][kZigzag[k]] = pq ? read_u16(seg + p + 1 + 2 * k)
                                    : seg[p + 1 + k];
        D.qt_present[tq] = true;
        p += 1 + sz;
      }
    } else if (marker == 0xDD) {     // DRI
      if (seglen < 2) return CORRUPT;
      D.restart = read_u16(seg);
    } else if (marker == 0xEE) {     // APP14 Adobe: colour transform flag
      if (seglen >= 12 && std::memcmp(seg, "Adobe", 5) == 0)
        D.adobe_transform = seg[11];
    } else if (marker == 0xE0) {     // APP0 JFIF
      if (seglen >= 14 && std::memcmp(seg, "JFIF", 5) == 0) D.jfif = true;
    } else if (marker == 0xDA) {     // SOS
      if (!D.frame) return CORRUPT;
      for (auto& c : D.comps)
        if (!D.qt_present[c.tq]) return NO_TABLE;
      int e = decode_scan(D, seg, seglen, pos);
      if (e) return e;
    }
  }
}

}  // namespace

extern "C" {

// Header of a JPEG: out = {width, height, components}.  Returns an Err.
int gdm_jpeg_info(const uint8_t* data, int64_t len, int32_t* out) {
  Decoder D;
  D.d = data;
  D.n = len;
  int e = parse(D, false);
  if (e) return e;
  out[0] = D.width;
  out[1] = D.height;
  out[2] = static_cast<int32_t>(D.comps.size());
  return OK;
}

// Decode to interleaved RGB [height][width][3] (gray replicated), or with
// `gray` to one plane [height][width] as libjpeg's JCS_GRAYSCALE output
// gives it (the luma plane; RGB->Y for an Adobe RGB file), the samples
// libjpeg-turbo's defaults give.  Returns an Err.
int gdm_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out,
                    int64_t cap, int gray) {
  Decoder D;
  D.d = data;
  D.n = len;
  int e = parse(D, true);
  if (e) return e;
  if (needs_smoothing(D)) return SMOOTHING;
  const int W = D.width, H = D.height;
  if (cap < static_cast<int64_t>(W) * H * (gray ? 1 : 3)) return TOO_SMALL;
  const int nc = static_cast<int>(D.comps.size());
  // inverse DCT of every block into the component planes
  std::vector<std::vector<uint8_t>> planes(nc);
  for (int i = 0; i < nc; ++i) {
    Comp& c = D.comps[i];
    const int pw = c.bw * 8;
    planes[i].assign(static_cast<size_t>(pw) * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64],
                   D.qt[c.tq], &planes[i][(by * 8) * pw + bx * 8], pw);
  }
  // upsample each component to full resolution (width W)
  std::vector<std::vector<uint8_t>> full(nc);
  std::vector<uint8_t> tmp;
  for (int i = 0; i < nc; ++i) {
    Comp& c = D.comps[i];
    const int pw = c.bw * 8;
    const int rh = D.hmax / c.h, rv = D.vmax / c.v;
    full[i].assign(static_cast<size_t>(W) * H, 0);
    tmp.assign(2 * static_cast<size_t>(c.cw) + 2, 0);
    for (int y = 0; y < H; ++y) {
      uint8_t* dst = &full[i][static_cast<size_t>(y) * W];
      const uint8_t* row = &planes[i][static_cast<size_t>(y / rv) * pw];
      if (rh == 1 && rv == 1) {
        std::memcpy(dst, row, W);
      } else if (rh == 2 && rv == 1 && c.cw > 2) {
        up_h2(row, c.cw, tmp.data());
        std::memcpy(dst, tmp.data(), W);
      } else if (rh == 2 && rv == 2 && c.cw > 2) {
        int iy = y >> 1;
        int other = (y & 1) ? std::min(iy + 1, c.ch - 1) : std::max(iy - 1, 0);
        up_h2v2_row(row, &planes[i][static_cast<size_t>(other) * pw], c.cw,
                    tmp.data());
        std::memcpy(dst, tmp.data(), W);
      } else if (rh == 1 && rv == 2) {
        // jdsample.c h1v2_fancy_upsample (4:4:0): the nearer row 3/4, the
        // further 1/4, bias 1 above and 2 below
        int iy = y >> 1;
        int other = (y & 1) ? std::min(iy + 1, c.ch - 1) : std::max(iy - 1, 0);
        const uint8_t* far = &planes[i][static_cast<size_t>(other) * pw];
        const int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; ++x)
          dst[x] = static_cast<uint8_t>((row[x] * 3 + far[x] + bias) >> 2);
      } else {
        // jdsample.c int_upsample (and h2v1/h2v2_upsample for components
        // at most two samples wide): each sample repeated rh x rv times
        for (int x = 0; x < W; ++x) dst[x] = row[x / rh];
      }
    }
  }
  const size_t npx = static_cast<size_t>(W) * H;
  // jdapimin.c default_decompress_parms: JFIF means YCbCr, else Adobe's
  // transform 0 or, with neither marker, component ids 'R' 'G' 'B' mean RGB
  const bool rgb_stored =
      nc == 3 && !D.jfif &&
      (D.adobe_transform >= 0
           ? D.adobe_transform == 0
           : D.comps[0].id == 'R' && D.comps[1].id == 'G' &&
                 D.comps[2].id == 'B');
  if (gray && rgb_stored) {
    // jdcolor.c rgb_gray_convert: the rgb_ycc_tab luma rows, SCALEBITS 16
    const int64_t ry = static_cast<int64_t>(0.29900 * 65536 + 0.5),
                  gy = static_cast<int64_t>(0.58700 * 65536 + 0.5),
                  by = static_cast<int64_t>(0.11400 * 65536 + 0.5);
    for (size_t p = 0; p < npx; ++p)
      out[p] = static_cast<uint8_t>(
          (ry * full[0][p] + gy * full[1][p] + by * full[2][p] + 32768) >>
          16);
    return OK;
  }
  if (gray) {                        // JCS_YCbCr or gray: the first plane
    std::memcpy(out, full[0].data(), npx);
    return OK;
  }
  if (nc == 1) {
    for (size_t p = 0; p < npx; ++p)
      out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = full[0][p];
    return OK;
  }
  if (rgb_stored) {                  // stored as RGB
    for (size_t p = 0; p < npx; ++p)
      for (int k = 0; k < 3; ++k) out[3 * p + k] = full[k][p];
    return OK;
  }
  // jdcolor.c build_ycc_rgb_table + ycc_rgb_convert
  const int SCALEBITS = 16;
  const int64_t ONE_HALF = int64_t{1} << (SCALEBITS - 1);
  auto fix = [](double x) {
    return static_cast<int64_t>(x * (int64_t{1} << 16) + 0.5);
  };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    int64_t x = i - 128;
    cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
    cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + ONE_HALF;
  }
  auto clamp = [](int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  };
  for (size_t p = 0; p < npx; ++p) {
    int y = full[0][p], cb = full[1][p], cr = full[2][p];
    out[3 * p] = clamp(y + cr_r[cr]);
    out[3 * p + 1] =
        clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
    out[3 * p + 2] = clamp(y + cb_b[cb]);
  }
  return OK;
}

}  // extern "C"

// ---------------------------------------------------------------- encoder

namespace {

const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Code {
  uint16_t code[256];
  uint8_t len[256];
};

void build_code(Code& c, const uint8_t* bits, const uint8_t* vals) {
  std::memset(c.len, 0, sizeof(c.len));
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
      c.code[vals[k]] = static_cast<uint16_t>(code);
      c.len[vals[k]] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
}

struct Writer {
  std::vector<uint8_t> out;
  uint32_t buf = 0;
  int cnt = 0;
  void put(int v, int n) {
    for (int i = n - 1; i >= 0; --i) {
      buf = (buf << 1) | ((v >> i) & 1);
      if (++cnt == 8) {
        out.push_back(static_cast<uint8_t>(buf));
        if ((buf & 0xFF) == 0xFF) out.push_back(0);
        buf = 0;
        cnt = 0;
      }
    }
  }
  void flush() {              // pad with 1-bits to a byte boundary
    while (cnt) put(1, 1);
  }
  void u8(int v) { out.push_back(static_cast<uint8_t>(v)); }
  void u16(int v) {
    u8(v >> 8);
    u8(v & 0xFF);
  }
};

void quality_table(const uint8_t* base, int quality, uint8_t* out) {
  quality = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(base[i]) * scale + 50) / 100;
    out[i] = static_cast<uint8_t>(t < 1 ? 1 : (t > 255 ? 255 : t));
  }
}

void fdct_quant(const float* px, const uint8_t* q, int* coef) {
  static float cosv[8][8];
  static bool init = false;
  if (!init) {
    for (int x = 0; x < 8; ++x)
      for (int u = 0; u < 8; ++u)
        cosv[x][u] = static_cast<float>(
            std::cos((2 * x + 1) * u * 3.14159265358979323846 / 16.0) *
            (u == 0 ? std::sqrt(0.125) : 0.5));
    init = true;
  }
  float tmp[64];
  for (int y = 0; y < 8; ++y)
    for (int u = 0; u < 8; ++u) {
      float s = 0;
      for (int x = 0; x < 8; ++x) s += px[y * 8 + x] * cosv[x][u];
      tmp[y * 8 + u] = s;
    }
  for (int v = 0; v < 8; ++v)
    for (int u = 0; u < 8; ++u) {
      float s = 0;
      for (int y = 0; y < 8; ++y) s += tmp[y * 8 + u] * cosv[y][v];
      int lim = (u == 0 && v == 0) ? 2047 : 1023;   // baseline sizes
      long c = std::lround(s / q[v * 8 + u]);
      coef[v * 8 + u] = static_cast<int>(c < -lim ? -lim : (c > lim ? lim : c));
    }
}

int bit_size(int v) {
  v = v < 0 ? -v : v;
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(Writer& w, const int* coef, int& pred, const Code& dc,
                  const Code& ac) {
  int diff = coef[0] - pred;
  pred = coef[0];
  int s = bit_size(diff);
  w.put(dc.code[s], dc.len[s]);
  if (s) w.put(diff < 0 ? diff + (1 << s) - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kZigzag[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.put(ac.code[0xF0], ac.len[0xF0]);
      run -= 16;
    }
    int sz = bit_size(v);
    int rs = (run << 4) | sz;
    w.put(ac.code[rs], ac.len[rs]);
    w.put(v < 0 ? v + (1 << sz) - 1 : v, sz);
    run = 0;
  }
  if (run) w.put(ac.code[0], ac.len[0]);
}

}  // namespace

extern "C" {

// Baseline JPEG of an 8-bit image [h][w][c] (c = 1 gray, c = 3 RGB):
// quality 1..100 (libjpeg scaling of the Annex K tables), subsample 1 for
// 4:2:0 chroma (else 4:4:4), restart interval in MCUs (0 = none).
// Writes at most cap bytes to out; returns the size, or -1 when cap is too
// small and -2 on bad arguments.
int64_t gdm_jpeg_encode(const uint8_t* img, int w, int h, int c,
                        int quality, int subsample, int restart,
                        uint8_t* out, int64_t cap) {
  if (w < 1 || h < 1 || w > 65535 || h > 65535 || (c != 1 && c != 3) ||
      restart < 0 || restart > 65535)
    return -2;
  const int nc = c;
  const int hs = (nc == 3 && subsample) ? 2 : 1;
  const int mw = 8 * hs, mh = 8 * hs;
  const int mcux = (w + mw - 1) / mw, mcuy = (h + mh - 1) / mh;
  const int PW = mcux * mw, PH = mcuy * mh;
  // planes at full resolution, padded by edge replication
  std::vector<float> plane[3];
  for (int k = 0; k < nc; ++k) plane[k].assign(static_cast<size_t>(PW) * PH, 0);
  for (int y = 0; y < PH; ++y)
    for (int x = 0; x < PW; ++x) {
      const uint8_t* p =
          img + (static_cast<size_t>(std::min(y, h - 1)) * w + std::min(x, w - 1)) * c;
      size_t o = static_cast<size_t>(y) * PW + x;
      if (nc == 1) {
        plane[0][o] = p[0];
      } else {
        float r = p[0], g = p[1], b = p[2];
        plane[0][o] = 0.299f * r + 0.587f * g + 0.114f * b;
        plane[1][o] = -0.168736f * r - 0.331264f * g + 0.5f * b + 128.f;
        plane[2][o] = 0.5f * r - 0.418688f * g - 0.081312f * b + 128.f;
      }
    }
  uint8_t ql[64], qc[64];
  quality_table(kStdLumaQ, quality, ql);
  quality_table(kStdChromaQ, quality, qc);
  Code dcl, acl, dcc, acc;
  build_code(dcl, kDcLumaBits, kDcVals);
  build_code(acl, kAcLumaBits, kAcLumaVals);
  build_code(dcc, kDcChromaBits, kDcVals);
  build_code(acc, kAcChromaBits, kAcChromaVals);

  Writer W;
  W.u16(0xFFD8);
  W.u16(0xFFE0);                     // JFIF APP0
  W.u16(16);
  const char jfif[5] = {'J', 'F', 'I', 'F', 0};
  for (char ch : jfif) W.u8(ch);
  W.u16(0x0101);
  W.u8(0);
  W.u16(1);
  W.u16(1);
  W.u8(0);
  W.u8(0);
  W.u16(0xFFDB);                     // DQT
  W.u16(2 + (nc == 3 ? 2 : 1) * 65);
  W.u8(0);
  for (int k = 0; k < 64; ++k) W.u8(ql[kZigzag[k]]);
  if (nc == 3) {
    W.u8(1);
    for (int k = 0; k < 64; ++k) W.u8(qc[kZigzag[k]]);
  }
  W.u16(0xFFC0);                     // SOF0
  W.u16(8 + 3 * nc);
  W.u8(8);
  W.u16(h);
  W.u16(w);
  W.u8(nc);
  for (int k = 0; k < nc; ++k) {
    W.u8(k + 1);
    W.u8(k == 0 ? (hs << 4) | hs : 0x11);
    W.u8(k == 0 ? 0 : 1);
  }
  auto dht = [&](int cls_id, const uint8_t* bits, const uint8_t* vals) {
    int nv = 0;
    for (int i = 0; i < 16; ++i) nv += bits[i];
    W.u16(0xFFC4);
    W.u16(2 + 17 + nv);
    W.u8(cls_id);
    for (int i = 0; i < 16; ++i) W.u8(bits[i]);
    for (int i = 0; i < nv; ++i) W.u8(vals[i]);
  };
  dht(0x00, kDcLumaBits, kDcVals);
  dht(0x10, kAcLumaBits, kAcLumaVals);
  if (nc == 3) {
    dht(0x01, kDcChromaBits, kDcVals);
    dht(0x11, kAcChromaBits, kAcChromaVals);
  }
  if (restart) {
    W.u16(0xFFDD);
    W.u16(4);
    W.u16(restart);
  }
  W.u16(0xFFDA);                     // SOS
  W.u16(6 + 2 * nc);
  W.u8(nc);
  for (int k = 0; k < nc; ++k) {
    W.u8(k + 1);
    W.u8(k == 0 ? 0x00 : 0x11);
  }
  W.u8(0);
  W.u8(63);
  W.u8(0);

  int pred[3] = {0, 0, 0};
  float px[64];
  int coef[64];
  int64_t m = 0, rst = 0;
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx, ++m) {
      if (restart && m > 0 && m % restart == 0) {
        W.flush();
        W.u8(0xFF);
        W.u8(0xD0 + (rst++ & 7));
        pred[0] = pred[1] = pred[2] = 0;
      }
      for (int by = 0; by < hs; ++by)
        for (int bx = 0; bx < hs; ++bx) {
          int x0 = mx * mw + bx * 8, y0 = my * mh + by * 8;
          for (int y = 0; y < 8; ++y)
            for (int x = 0; x < 8; ++x)
              px[y * 8 + x] =
                  plane[0][static_cast<size_t>(y0 + y) * PW + x0 + x] - 128.f;
          fdct_quant(px, ql, coef);
          encode_block(W, coef, pred[0], dcl, acl);
        }
      for (int k = 1; k < nc; ++k) {
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x) {
            float s = 0;
            for (int dy = 0; dy < hs; ++dy)
              for (int dx = 0; dx < hs; ++dx)
                s += plane[k][static_cast<size_t>(my * mh + y * hs + dy) * PW +
                              mx * mw + x * hs + dx];
            px[y * 8 + x] = s / (hs * hs) - 128.f;
          }
        fdct_quant(px, qc, coef);
        encode_block(W, coef, pred[k], dcc, acc);
      }
    }
  W.flush();
  W.u16(0xFFD9);
  if (static_cast<int64_t>(W.out.size()) > cap) return -1;
  std::memcpy(out, W.out.data(), W.out.size());
  return static_cast<int64_t>(W.out.size());
}

}  // extern "C"
