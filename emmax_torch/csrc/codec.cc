// emmax_torch image codec: baseline JPEG decode and encode, CRC32C, and a
// batch decode on a thread pool. Host code, built with g++ (see
// emmax_torch/data/codec.py), no library beyond the C++ standard one.
//
// The decoder follows libjpeg-turbo's arithmetic step for step, so that its
// pixels equal what libjpeg-turbo (and so tf.io.decode_image) gives:
//   - dequantization and the IDCT: jidctfst.c (JDCT_IFAST, with the
//     aanscales multiplier table of jddctmgr.c) and jidctint.c (JDCT_ISLOW);
//   - the IDCT's range limit: the masked table of jdmaster.c;
//   - chroma upsampling: jdsample.c's fancy h2v1, h1v2 and h2v2 (triangle
//     filters on the component's real width and height, its last row
//     and column repeated as jdmainct.c's context pointers do), the box
//     filter elsewhere;
//   - colour: jdcolor.c's integer YCbCr -> RGB tables.
// Only sequential Huffman JPEG of 8-bit samples is read (SOF0 / SOF1), with
// one or three components; anything else returns an error.
//
// The encoder writes baseline JFIF: 4:2:0 YCbCr, the standard quantization
// tables scaled by quality as libjpeg scales them, the standard Huffman
// tables. Its bytes are its own, not libjpeg's.
//
// C ABI (ctypes): emx_jpeg_info, emx_jpeg_decode, emx_jpeg_decode_batch,
// emx_jpeg_encode, emx_crc32c.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kIfast = 0;
constexpr int kIslow = 1;

int g_natural[64];   // zigzag position -> natural (row-major) index

struct NaturalOrderInit {
  NaturalOrderInit() {
    int i = 0, j = 0;
    for (int k = 0; k < 64; ++k) {
      g_natural[k] = i * 8 + j;
      if ((i + j) % 2 == 0) {          // moving up-right
        if (j == 7) ++i;
        else if (i == 0) ++j;
        else { --i; ++j; }
      } else {                         // moving down-left
        if (i == 7) ++j;
        else if (j == 0) ++i;
        else { ++i; --j; }
      }
    }
  }
} g_natural_init;

// ---- decoding ---------------------------------------------------------------

struct HuffTable {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[256];   // 8-bit lookahead: (length << 8) | value, 0 = miss
};

bool build_huff(const uint8_t bits[17], const uint8_t* vals, int nvals,
                HuffTable* t) {
  int code = 0, p = 0;
  std::memset(t->look, 0, sizeof(t->look));
  std::memcpy(t->vals, vals, nvals);
  for (int len = 1; len <= 16; ++len) {
    t->valoffset[len] = p - code;
    for (int i = 0; i < bits[len]; ++i, ++p, ++code) {
      if (len <= 8) {
        int shift = 8 - len;
        for (int fill = 0; fill < (1 << shift); ++fill)
          t->look[(code << shift) | fill] =
              static_cast<uint16_t>((len << 8) | vals[p]);
      }
    }
    t->maxcode[len] = bits[len] ? code - 1 : -1;
    if (code > (1 << len)) return false;   // not a prefix code
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;
  t->defined = true;
  return p == nvals;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;                 // Huffman tables of the current scan
  int dc_pred = 0;
  int bw = 0, bh = 0;                 // blocks across / down (padded plane)
  int dw = 0, dh = 0;                 // real (downsampled) width / height
  std::vector<uint8_t> plane;         // (bh * 8) x (bw * 8) samples
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  bool hit_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (!hit_marker && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          uint8_t next = p + 1 < end ? p[1] : 0xD9;
          if (next == 0x00) {
            p += 2;
          } else {
            hit_marker = true;   // a marker: feed zeros from here on
            byte = 0;
          }
        } else {
          ++p;
        }
      }
      acc |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }
  int peek(int n) {
    if (nbits < n) fill();
    return static_cast<int>(acc >> (64 - n));
  }
  void skip(int n) {
    acc <<= n;
    nbits -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }
  // Drop buffered bits and move past an RSTn marker.
  bool restart() {
    acc = 0;
    nbits = 0;
    hit_marker = false;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)) {
      ++p;
    }
    if (p + 1 >= end) return false;
    p += 2;
    return true;
  }
};

inline int decode_huff(BitReader& br, const HuffTable& t) {
  int look = br.peek(8);
  uint16_t hit = t.look[look];
  if (hit) {
    br.skip(hit >> 8);
    return hit & 0xFF;
  }
  int code = br.peek(16);
  for (int len = 9; len <= 16; ++len) {
    int c = code >> (16 - len);
    if (c <= t.maxcode[len]) {
      br.skip(len);
      int idx = c + t.valoffset[len];
      return (idx >= 0 && idx < 256) ? t.vals[idx] : 0;
    }
  }
  br.skip(16);   // corrupt data: libjpeg also gives 0 here
  return 0;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jdmaster.c's post-IDCT range limit: index by (x & 1023), x descaled
// without the +128 level shift.
inline uint8_t idct_limit(int x) {
  int v = x & 1023;
  if (v < 128) return static_cast<uint8_t>(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return static_cast<uint8_t>(v - 896);
}

// jidctint.c, jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2.
void idct_islow(const int16_t* coef, const int32_t* q, uint8_t* out,
                int stride) {
  constexpr int CB = 13, P1 = 2;
  auto descale = [](int64_t x, int n) {
    return static_cast<int>((x + (int64_t(1) << (n - 1))) >> n);
  };
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int32_t* qq = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = (in[0] * qq[0]) * (1 << P1);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * qq[16], z3 = in[48] * qq[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * (-F1847);
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = in[0] * qq[0];
    z3 = in[32] * qq[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << CB);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * qq[56];
    tmp1 = in[40] * qq[40];
    tmp2 = in[24] * qq[24];
    tmp3 = in[8] * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
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
    w[0] = descale(tmp10 + tmp3, CB - P1);
    w[56] = descale(tmp10 - tmp3, CB - P1);
    w[8] = descale(tmp11 + tmp2, CB - P1);
    w[48] = descale(tmp11 - tmp2, CB - P1);
    w[16] = descale(tmp12 + tmp1, CB - P1);
    w[40] = descale(tmp12 - tmp1, CB - P1);
    w[24] = descale(tmp13 + tmp0, CB - P1);
    w[32] = descale(tmp13 - tmp0, CB - P1);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t v = idct_limit(descale(w[0], P1 + 3));
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * (-F1847);
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CB);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
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
    constexpr int S = CB + P1 + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, S));
    o[7] = idct_limit(descale(tmp10 - tmp3, S));
    o[1] = idct_limit(descale(tmp11 + tmp2, S));
    o[6] = idct_limit(descale(tmp11 - tmp2, S));
    o[2] = idct_limit(descale(tmp12 + tmp1, S));
    o[5] = idct_limit(descale(tmp12 - tmp1, S));
    o[3] = idct_limit(descale(tmp13 + tmp0, S));
    o[4] = idct_limit(descale(tmp13 - tmp0, S));
  }
}

// jidctfst.c, jpeg_idct_ifast for 8-bit samples: CONST_BITS 8, PASS1_BITS 2,
// products descaled by a plain (truncating) shift, no rounding anywhere.
// `q` is the multiplier table (quantval * aanscale, 12 bits descaled).
void idct_ifast(const int16_t* coef, const int32_t* q, uint8_t* out,
                int stride) {
  constexpr int P1 = 2;
  // MULTIPLY: a 64-bit product (the constants are JLONG) truncated to int
  auto mul = [](int v, int c) {
    return static_cast<int>((int64_t(v) * c) >> 8);
  };
  constexpr int F1082 = 277, F1414 = 362, F1847 = 473, F2613 = 669;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int32_t* qq = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = in[0] * qq[0];
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int tmp0 = in[0] * qq[0], tmp1 = in[16] * qq[16];
    int tmp2 = in[32] * qq[32], tmp3 = in[48] * qq[48];
    int tmp10 = tmp0 + tmp2, tmp11 = tmp0 - tmp2;
    int tmp13 = tmp1 + tmp3;
    int tmp12 = mul(tmp1 - tmp3, F1414) - tmp13;
    tmp0 = tmp10 + tmp13;
    tmp3 = tmp10 - tmp13;
    tmp1 = tmp11 + tmp12;
    tmp2 = tmp11 - tmp12;
    int tmp4 = in[8] * qq[8], tmp5 = in[24] * qq[24];
    int tmp6 = in[40] * qq[40], tmp7 = in[56] * qq[56];
    int z13 = tmp6 + tmp5, z10 = tmp6 - tmp5;
    int z11 = tmp4 + tmp7, z12 = tmp4 - tmp7;
    tmp7 = z11 + z13;
    tmp11 = mul(z11 - z13, F1414);
    int z5 = mul(z10 + z12, F1847);
    tmp10 = mul(z12, F1082) - z5;
    tmp12 = mul(z10, -F2613) + z5;
    tmp6 = tmp12 - tmp7;
    tmp5 = tmp11 - tmp6;
    tmp4 = tmp10 + tmp5;
    w[0] = tmp0 + tmp7;
    w[56] = tmp0 - tmp7;
    w[8] = tmp1 + tmp6;
    w[48] = tmp1 - tmp6;
    w[16] = tmp2 + tmp5;
    w[40] = tmp2 - tmp5;
    w[32] = tmp3 + tmp4;
    w[24] = tmp3 - tmp4;
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    constexpr int S = P1 + 3;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t v = idct_limit(w[0] >> S);
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int tmp10 = w[0] + w[4], tmp11 = w[0] - w[4];
    int tmp13 = w[2] + w[6];
    int tmp12 = mul(w[2] - w[6], F1414) - tmp13;
    int tmp0 = tmp10 + tmp13, tmp3 = tmp10 - tmp13;
    int tmp1 = tmp11 + tmp12, tmp2 = tmp11 - tmp12;
    int z13 = w[5] + w[3], z10 = w[5] - w[3];
    int z11 = w[1] + w[7], z12 = w[1] - w[7];
    int tmp7 = z11 + z13;
    tmp11 = mul(z11 - z13, F1414);
    int z5 = mul(z10 + z12, F1847);
    tmp10 = mul(z12, F1082) - z5;
    tmp12 = mul(z10, -F2613) + z5;
    int tmp6 = tmp12 - tmp7;
    int tmp5 = tmp11 - tmp6;
    int tmp4 = tmp10 + tmp5;
    o[0] = idct_limit((tmp0 + tmp7) >> S);
    o[7] = idct_limit((tmp0 - tmp7) >> S);
    o[1] = idct_limit((tmp1 + tmp6) >> S);
    o[6] = idct_limit((tmp1 - tmp6) >> S);
    o[2] = idct_limit((tmp2 + tmp5) >> S);
    o[5] = idct_limit((tmp2 - tmp5) >> S);
    o[4] = idct_limit((tmp3 + tmp4) >> S);
    o[3] = idct_limit((tmp3 - tmp4) >> S);
  }
}

const int16_t kAanScales[64] = {
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,
    22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270,
    21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,
    19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315,
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,
    12873, 17855, 16819, 15137, 12873, 10114, 6967,  3552,
    8867,  12299, 11585, 10426, 8867,  6967,  4799,  2446,
    4520,  6270,  5906,  5315,  4520,  3552,  2446,  1247};

inline uint16_t be16(const uint8_t* p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}

struct Jpeg {
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool adobe_rgb = false;
  bool have_frame = false;
  uint16_t qt[4][64];   // natural order
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  Component comp[3];
  int mcus_x = 0, mcus_y = 0;
};

// Error codes returned through the C ABI.
constexpr int kErrTruncated = 1, kErrUnsupported = 2, kErrCorrupt = 3,
              kErrSize = 4;

int parse_sof(Jpeg& j, const uint8_t* s, int len) {
  if (len < 6 || s[0] != 8) return kErrUnsupported;   // 8-bit samples only
  j.height = be16(s + 1);
  j.width = be16(s + 3);
  j.ncomp = s[5];
  if (j.width == 0 || j.height == 0) return kErrUnsupported;
  if (j.ncomp != 1 && j.ncomp != 3) return kErrUnsupported;
  if (len < 6 + 3 * j.ncomp) return kErrCorrupt;
  for (int i = 0; i < j.ncomp; ++i) {
    Component& c = j.comp[i];
    c.id = s[6 + 3 * i];
    c.h = s[7 + 3 * i] >> 4;
    c.v = s[7 + 3 * i] & 15;
    c.tq = s[8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      return kErrCorrupt;
    j.hmax = std::max(j.hmax, c.h);
    j.vmax = std::max(j.vmax, c.v);
  }
  j.mcus_x = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
  j.mcus_y = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  for (int i = 0; i < j.ncomp; ++i) {
    Component& c = j.comp[i];
    if (j.hmax % c.h || j.vmax % c.v) return kErrUnsupported;
    c.dw = (j.width * c.h + j.hmax - 1) / j.hmax;
    c.dh = (j.height * c.v + j.vmax - 1) / j.vmax;
    c.bw = j.mcus_x * c.h;
    c.bh = j.mcus_y * c.v;
  }
  j.have_frame = true;
  return 0;
}

// Reads the markers up to the first SOS (or to the frame header only when
// `header_only`). Returns 0 and sets *pos to the scan header's start.
int read_markers(Jpeg& j, const uint8_t* d, size_t n, size_t* pos,
                 bool header_only) {
  size_t p = *pos;
  while (true) {
    while (p < n && d[p] != 0xFF) ++p;          // skip fill / garbage
    while (p < n && d[p] == 0xFF) ++p;
    if (p >= n) return kErrTruncated;
    uint8_t m = d[p++];
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (m == 0xD9) return kErrTruncated;        // EOI before any scan
    if (p + 2 > n) return kErrTruncated;
    int len = be16(d + p);
    if (len < 2 || p + len > n) return kErrTruncated;
    const uint8_t* s = d + p + 2;
    int sl = len - 2;
    if (m == 0xC0 || m == 0xC1) {
      int rc = parse_sof(j, s, sl);
      if (rc) return rc;
      if (header_only) {
        *pos = p + len;
        return 0;
      }
    } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {
      return kErrUnsupported;                   // progressive, lossless...
    } else if (m == 0xC4) {
      int k = 0;
      while (k < sl) {
        if (k + 17 > sl) return kErrCorrupt;
        int tc = s[k] >> 4, th = s[k] & 15;
        if (tc > 1 || th > 3) return kErrCorrupt;
        uint8_t bits[17];
        bits[0] = 0;
        int total = 0;
        for (int i = 1; i <= 16; ++i) {
          bits[i] = s[k + i];
          total += bits[i];
        }
        if (total > 256 || k + 17 + total > sl) return kErrCorrupt;
        HuffTable& t = tc == 0 ? j.dc[th] : j.ac[th];
        if (!build_huff(bits, s + k + 17, total, &t)) return kErrCorrupt;
        k += 17 + total;
      }
    } else if (m == 0xDB) {
      int k = 0;
      while (k < sl) {
        int pq = s[k] >> 4, tq = s[k] & 15;
        if (tq > 3 || pq > 1) return kErrCorrupt;
        int need = 1 + 64 * (pq + 1);
        if (k + need > sl) return kErrCorrupt;
        for (int i = 0; i < 64; ++i) {
          uint16_t v = pq ? be16(s + k + 1 + 2 * i) : s[k + 1 + i];
          j.qt[tq][g_natural[i]] = v;
        }
        j.qt_defined[tq] = true;
        k += need;
      }
    } else if (m == 0xDD) {
      if (sl < 2) return kErrCorrupt;
      j.restart_interval = be16(s);
    } else if (m == 0xEE) {
      // Adobe APP14: transform 0 with 3 components means RGB samples
      if (sl >= 12 && std::memcmp(s, "Adobe", 5) == 0)
        j.adobe_rgb = (s[11] == 0 && j.ncomp != 1);
    } else if (m == 0xDA) {
      *pos = p;
      return j.have_frame ? 0 : kErrCorrupt;
    }
    p += len;
  }
}

void dequant_table(const Jpeg& j, int tq, int dct, int32_t out[64]) {
  for (int i = 0; i < 64; ++i) {
    int32_t q = j.qt[tq][i];
    out[i] = dct == kIfast
                 ? static_cast<int32_t>(
                       (int64_t(q) * kAanScales[i] + (1 << 11)) >> 12)
                 : q;
  }
}

int decode_block(BitReader& br, const HuffTable& dc, const HuffTable& ac,
                 int* pred, int16_t blk[64]) {
  std::memset(blk, 0, 64 * sizeof(int16_t));
  int s = decode_huff(br, dc);
  if (s > 15) return kErrCorrupt;
  int diff = s ? extend(br.get(s), s) : 0;
  *pred += diff;
  blk[0] = static_cast<int16_t>(*pred);
  for (int k = 1; k < 64;) {
    int rs = decode_huff(br, ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s == 0) {
      if (r != 15) break;       // EOB
      k += 16;
      continue;
    }
    k += r;
    if (k > 63) return kErrCorrupt;
    blk[g_natural[k]] = static_cast<int16_t>(extend(br.get(s), s));
    ++k;
  }
  return 0;
}

int decode_scan(Jpeg& j, const uint8_t* d, size_t n, size_t* pos, int dct) {
  size_t p = *pos;
  int len = be16(d + p);
  if (p + len > n || len < 3) return kErrTruncated;
  const uint8_t* s = d + p + 2;
  int ns = s[0];
  if (ns < 1 || ns > j.ncomp || len < 6 + 2 * ns) return kErrCorrupt;
  Component* sc[3];
  for (int i = 0; i < ns; ++i) {
    int cid = s[1 + 2 * i];
    sc[i] = nullptr;
    for (int c = 0; c < j.ncomp; ++c)
      if (j.comp[c].id == cid) sc[i] = &j.comp[c];
    if (!sc[i]) return kErrCorrupt;
    sc[i]->td = s[2 + 2 * i] >> 4;
    sc[i]->ta = s[2 + 2 * i] & 15;
    if (sc[i]->td > 3 || sc[i]->ta > 3 || !j.dc[sc[i]->td].defined ||
        !j.ac[sc[i]->ta].defined || !j.qt_defined[sc[i]->tq])
      return kErrCorrupt;
    sc[i]->dc_pred = 0;
  }
  BitReader br;
  br.p = d + p + len;
  br.end = d + n;
  int32_t qtab[3][64];
  for (int i = 0; i < ns; ++i) dequant_table(j, sc[i]->tq, dct, qtab[i]);
  auto idct = dct == kIfast ? idct_ifast : idct_islow;
  int16_t blk[64];

  // Interleaved: MCUs over the padded grid. One component: its own blocks.
  int units_x, units_y;
  if (ns == 1) {
    units_x = (sc[0]->dw + 7) / 8;
    units_y = (sc[0]->dh + 7) / 8;
  } else {
    units_x = j.mcus_x;
    units_y = j.mcus_y;
  }
  int todo = j.restart_interval;
  for (int my = 0; my < units_y; ++my) {
    for (int mx = 0; mx < units_x; ++mx) {
      if (j.restart_interval) {
        if (todo == 0) {
          if (!br.restart()) return kErrTruncated;
          for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
          todo = j.restart_interval;
        }
        --todo;
      }
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        int bh = ns == 1 ? 1 : c.v, bwn = ns == 1 ? 1 : c.h;
        for (int by = 0; by < bh; ++by) {
          for (int bx = 0; bx < bwn; ++bx) {
            int rc = decode_block(br, j.dc[c.td], j.ac[c.ta], &c.dc_pred,
                                  blk);
            if (rc) return rc;
            int row = (ns == 1 ? my : my * c.v + by) * 8;
            int col = (ns == 1 ? mx : mx * c.h + bx) * 8;
            int stride = c.bw * 8;
            idct(blk, qtab[i], c.plane.data() + size_t(row) * stride + col,
                 stride);
          }
        }
      }
    }
  }
  // Move past the entropy-coded data to the next marker.
  const uint8_t* q = br.p;
  while (q + 1 < d + n && !(q[0] == 0xFF && q[1] != 0 &&
                            !(q[1] >= 0xD0 && q[1] <= 0xD7)))
    ++q;
  *pos = static_cast<size_t>(q - d);
  return 0;
}

// The component upsampled to the full image: out[y * W + x].
void upsample(const Jpeg& j, const Component& c, uint8_t* out) {
  const int W = j.width, H = j.height;
  const int stride = c.bw * 8;
  const uint8_t* P = c.plane.data();
  const int fh = j.hmax / c.h, fv = j.vmax / c.v;
  auto at = [&](int r, int col) { return int(P[size_t(r) * stride + col]); };
  if (fh == 1 && fv == 1) {
    for (int y = 0; y < H; ++y)
      std::memcpy(out + size_t(y) * W, P + size_t(y) * stride, W);
    return;
  }
  const int dw = c.dw, dh = c.dh;
  if (fh == 2 && fv == 1 && dw > 2) {                  // h2v1_fancy
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) {
        int jx = x >> 1;
        int v3 = 3 * at(y, jx);
        out[size_t(y) * W + x] = static_cast<uint8_t>(
            x & 1 ? (v3 + at(y, std::min(jx + 1, dw - 1)) + 2) >> 2
                  : (v3 + at(y, std::max(jx - 1, 0)) + 1) >> 2);
      }
    return;
  }
  if (fh == 1 && fv == 2) {                            // h1v2_fancy
    for (int y = 0; y < H; ++y) {
      int iy = y >> 1;
      int ny = y & 1 ? std::min(iy + 1, dh - 1) : std::max(iy - 1, 0);
      int bias = y & 1 ? 2 : 1;
      for (int x = 0; x < W; ++x)
        out[size_t(y) * W + x] =
            static_cast<uint8_t>((3 * at(iy, x) + at(ny, x) + bias) >> 2);
    }
    return;
  }
  if (fh == 2 && fv == 2 && dw > 2) {                  // h2v2_fancy
    std::vector<int> cs(dw);
    for (int y = 0; y < H; ++y) {
      int iy = y >> 1;
      int ny = y & 1 ? std::min(iy + 1, dh - 1) : std::max(iy - 1, 0);
      for (int k = 0; k < dw; ++k) cs[k] = 3 * at(iy, k) + at(ny, k);
      for (int x = 0; x < W; ++x) {
        int jx = x >> 1;
        out[size_t(y) * W + x] = static_cast<uint8_t>(
            x & 1 ? (3 * cs[jx] + cs[std::min(jx + 1, dw - 1)] + 7) >> 4
                  : (3 * cs[jx] + cs[std::max(jx - 1, 0)] + 8) >> 4);
      }
    }
    return;
  }
  for (int y = 0; y < H; ++y)                          // box (int_upsample)
    for (int x = 0; x < W; ++x)
      out[size_t(y) * W + x] = static_cast<uint8_t>(at(y / fv, x / fh));
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int SB = 16;
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (1 << SB) + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + (1 << (SB - 1))) >> SB);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + (1 << (SB - 1))) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + (1 << (SB - 1));
    }
  }
} g_ycc;

int decode_jpeg(const uint8_t* d, size_t n, int dct, uint8_t* out, int W,
                int H) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kErrCorrupt;
  if (dct != kIfast && dct != kIslow) return kErrUnsupported;
  Jpeg j;
  size_t pos = 2;
  bool any_scan = false;
  while (true) {
    int rc = read_markers(j, d, n, &pos, false);
    if (rc == kErrTruncated && any_scan) break;   // reached EOI
    if (rc) return rc;
    if (!any_scan) {
      if (j.width != W || j.height != H) return kErrSize;
      for (int i = 0; i < j.ncomp; ++i)
        j.comp[i].plane.assign(size_t(j.comp[i].bw) * 8 * j.comp[i].bh * 8,
                               0);
    }
    rc = decode_scan(j, d, n, &pos, dct);
    if (rc) return rc;
    any_scan = true;
    if (pos + 1 < n && d[pos] == 0xFF && d[pos + 1] == 0xD9) break;
  }
  const size_t npix = size_t(W) * H;
  if (j.ncomp == 1) {
    std::vector<uint8_t> g(npix);
    upsample(j, j.comp[0], g.data());
    for (size_t i = 0; i < npix; ++i)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
    return 0;
  }
  std::vector<uint8_t> c0(npix), c1(npix), c2(npix);
  upsample(j, j.comp[0], c0.data());
  upsample(j, j.comp[1], c1.data());
  upsample(j, j.comp[2], c2.data());
  if (j.adobe_rgb) {
    for (size_t i = 0; i < npix; ++i) {
      out[3 * i] = c0[i];
      out[3 * i + 1] = c1[i];
      out[3 * i + 2] = c2[i];
    }
    return 0;
  }
  for (size_t i = 0; i < npix; ++i) {
    int y = c0[i], cb = c1[i], cr = c2[i];
    out[3 * i] = clamp255(y + g_ycc.cr_r[cr]);
    out[3 * i + 1] =
        clamp255(y + static_cast<int>((g_ycc.cb_g[cb] + g_ycc.cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp255(y + g_ycc.cb_b[cb]);
  }
  return 0;
}

// ---- encoding ---------------------------------------------------------------

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

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
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
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
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

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
};

void build_enc(const uint8_t bits[17], const uint8_t* vals, EncTable* t) {
  std::memset(t->size, 0, sizeof(t->size));
  int code = 0, p = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len]; ++i, ++p, ++code) {
      t->code[vals[p]] = static_cast<uint16_t>(code);
      t->size[vals[p]] = static_cast<uint8_t>(len);
    }
    code <<= 1;
  }
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int len) {
    while (len > 0) {
      int take = std::min(len, 8);
      len -= take;
      acc = (acc << take) | ((bits >> len) & ((1u << take) - 1));
      n += take;
      while (n >= 8) {
        uint8_t byte = static_cast<uint8_t>(acc >> (n - 8));
        out.push_back(byte);
        if (byte == 0xFF) out.push_back(0);
        n -= 8;
      }
    }
  }
  void flush() {
    if (n > 0) put((1u << (8 - n)) - 1, 8 - n);
  }
};

int bit_size(int v) {
  v = v < 0 ? -v : v;
  int s = 0;
  while (v) {
    ++s;
    v >>= 1;
  }
  return s;
}

void encode_block(BitWriter& bw, const int* q, int* pred, const EncTable& dc,
                  const EncTable& ac) {
  int diff = q[0] - *pred;
  *pred = q[0];
  int s = bit_size(diff);
  bw.put(dc.code[s], dc.size[s]);
  if (s) bw.put(diff < 0 ? diff + (1 << s) - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = q[g_natural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    s = bit_size(v);
    int sym = (run << 4) | s;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(v < 0 ? v + (1 << s) - 1 : v, s);
    run = 0;
  }
  if (run) bw.put(ac.code[0], ac.size[0]);
}

constexpr double kPi = 3.14159265358979323846;

struct Fdct {
  double c[8][8];   // c[u][x] = C(u)/2 cos((2x+1) u pi / 16)
  Fdct() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        c[u][x] = (u == 0 ? std::sqrt(0.5) : 1.0) * 0.5 *
                  std::cos((2 * x + 1) * u * kPi / 16.0);
  }
  // samples (level-shifted) -> quantized coefficients, natural order
  void run(const double s[64], const uint16_t* qt, int out[64]) const {
    double t[64];
    for (int y = 0; y < 8; ++y)
      for (int u = 0; u < 8; ++u) {
        double acc = 0;
        for (int x = 0; x < 8; ++x) acc += c[u][x] * s[y * 8 + x];
        t[y * 8 + u] = acc;
      }
    for (int v = 0; v < 8; ++v)
      for (int u = 0; u < 8; ++u) {
        double acc = 0;
        for (int y = 0; y < 8; ++y) acc += c[v][y] * t[y * 8 + u];
        long c = std::lround(acc / qt[v * 8 + u]);
        // baseline Huffman tables code magnitudes below 2^10 (AC), 2^11 (DC)
        long lim = v == 0 && u == 0 ? 2047 : 1023;
        out[v * 8 + u] = static_cast<int>(std::min(std::max(c, -lim), lim));
      }
  }
} g_fdct;

void quality_table(const uint8_t* base, int quality, uint16_t out[64]) {
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long v = (long(base[i]) * scale + 50) / 100;
    out[i] = static_cast<uint16_t>(std::min(std::max(v, 1L), 255L));
  }
}

void put_marker(std::vector<uint8_t>& o, uint8_t m, const uint8_t* body,
                int len) {
  o.push_back(0xFF);
  o.push_back(m);
  o.push_back(static_cast<uint8_t>((len + 2) >> 8));
  o.push_back(static_cast<uint8_t>((len + 2) & 0xFF));
  o.insert(o.end(), body, body + len);
}

void put_dht(std::vector<uint8_t>& o, int tc_th, const uint8_t bits[17],
             const uint8_t* vals, int nvals) {
  std::vector<uint8_t> b;
  b.push_back(static_cast<uint8_t>(tc_th));
  b.insert(b.end(), bits + 1, bits + 17);
  b.insert(b.end(), vals, vals + nvals);
  put_marker(o, 0xC4, b.data(), static_cast<int>(b.size()));
}

std::vector<uint8_t> encode_jpeg(const uint8_t* rgb, int W, int H,
                                 int quality) {
  uint16_t ql[64], qc[64];
  quality_table(kStdLumaQ, quality, ql);
  quality_table(kStdChromaQ, quality, qc);
  const int mx = (W + 15) / 16, my = (H + 15) / 16;
  const int PW = mx * 16, PH = my * 16;
  // YCbCr of the image padded by repeating its last column and row
  std::vector<double> Y(size_t(PW) * PH), Cb(Y.size()), Cr(Y.size());
  for (int y = 0; y < PH; ++y)
    for (int x = 0; x < PW; ++x) {
      const uint8_t* p =
          rgb + (size_t(std::min(y, H - 1)) * W + std::min(x, W - 1)) * 3;
      double r = p[0], g = p[1], b = p[2];
      size_t i = size_t(y) * PW + x;
      Y[i] = 0.299 * r + 0.587 * g + 0.114 * b;
      Cb[i] = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0;
      Cr[i] = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0;
    }
  std::vector<uint8_t> o;
  o.reserve(size_t(W) * H / 2 + 1024);
  o.push_back(0xFF);
  o.push_back(0xD8);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  put_marker(o, 0xE0, jfif, 14);
  for (int t = 0; t < 2; ++t) {
    uint8_t b[65];
    b[0] = static_cast<uint8_t>(t);
    const uint16_t* q = t ? qc : ql;
    for (int k = 0; k < 64; ++k) b[1 + k] = static_cast<uint8_t>(q[g_natural[k]]);
    put_marker(o, 0xDB, b, 65);
  }
  const uint8_t sof[15] = {8, uint8_t(H >> 8), uint8_t(H & 0xFF),
                           uint8_t(W >> 8), uint8_t(W & 0xFF), 3,
                           1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  put_marker(o, 0xC0, sof, 15);
  put_dht(o, 0x00, kDcLumaBits, kDcVals, 12);
  put_dht(o, 0x10, kAcLumaBits, kAcLumaVals, 162);
  put_dht(o, 0x01, kDcChromaBits, kDcVals, 12);
  put_dht(o, 0x11, kAcChromaBits, kAcChromaVals, 162);
  const uint8_t sos[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  put_marker(o, 0xDA, sos, 10);
  EncTable dcl, acl, dcc, acc;
  build_enc(kDcLumaBits, kDcVals, &dcl);
  build_enc(kAcLumaBits, kAcLumaVals, &acl);
  build_enc(kDcChromaBits, kDcVals, &dcc);
  build_enc(kAcChromaBits, kAcChromaVals, &acc);
  BitWriter bw(o);
  int pred[3] = {0, 0, 0};
  double s[64];
  int q[64];
  for (int by = 0; by < my; ++by)
    for (int bx = 0; bx < mx; ++bx) {
      for (int k = 0; k < 4; ++k) {
        int y0 = by * 16 + (k >> 1) * 8, x0 = bx * 16 + (k & 1) * 8;
        for (int i = 0; i < 64; ++i)
          s[i] = Y[size_t(y0 + i / 8) * PW + x0 + i % 8] - 128.0;
        g_fdct.run(s, ql, q);
        encode_block(bw, q, &pred[0], dcl, acl);
      }
      for (int ch = 0; ch < 2; ++ch) {
        const std::vector<double>& C = ch ? Cr : Cb;
        for (int i = 0; i < 64; ++i) {
          size_t y0 = size_t(by * 16 + 2 * (i / 8)), x0 = bx * 16 + 2 * (i % 8);
          s[i] = 0.25 * (C[y0 * PW + x0] + C[y0 * PW + x0 + 1] +
                         C[(y0 + 1) * PW + x0] + C[(y0 + 1) * PW + x0 + 1]) -
                 128.0;
        }
        g_fdct.run(s, qc, q);
        encode_block(bw, q, &pred[1 + ch], dcc, acc);
      }
    }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

// ---- CRC32C (Castagnoli, reflected 0x82F63B78) ------------------------------

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = c & 1 ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (int i = 0; i < 256; ++i)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
} g_crc;

}  // namespace

extern "C" {

// Frame header of a JPEG: 0 and (width, height, components), else an error.
int emx_jpeg_info(const uint8_t* src, uint64_t n, int32_t* w, int32_t* h,
                  int32_t* comps) {
  if (n < 4 || src[0] != 0xFF || src[1] != 0xD8) return kErrCorrupt;
  Jpeg j;
  size_t pos = 2;
  int rc = read_markers(j, src, n, &pos, true);
  if (rc) return rc;
  *w = j.width;
  *h = j.height;
  *comps = j.ncomp;
  return 0;
}

// Decode into out[h][w][3] (RGB). dct: 0 = IFAST, 1 = ISLOW.
int emx_jpeg_decode(const uint8_t* src, uint64_t n, int32_t dct, uint8_t* out,
                    int32_t w, int32_t h) {
  return decode_jpeg(src, n, dct, out, w, h);
}

// Decode n JPEGs of one size into out[n][h][w][3] on up to `threads`
// threads; returns the number that failed.
int emx_jpeg_decode_batch(const uint8_t* const* srcs, const uint64_t* sizes,
                          int32_t n, int32_t dct, uint8_t* out, int32_t w,
                          int32_t h, int32_t threads) {
  std::atomic<int32_t> next{0}, failures{0};
  const size_t frame = size_t(w) * h * 3;
  auto work = [&] {
    for (int32_t i; (i = next.fetch_add(1)) < n;)
      if (decode_jpeg(srcs[i], sizes[i], dct, out + frame * i, w, h) != 0)
        failures.fetch_add(1);
  };
  int nt = std::max(1, std::min<int>(threads, n));
  std::vector<std::thread> pool;
  for (int t = 1; t < nt; ++t) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  return failures.load();
}

// Encode rgb[h][w][3] as baseline 4:2:0 JPEG into out (capacity cap).
// Returns the byte count, or -(needed size) when cap is too small.
int64_t emx_jpeg_encode(const uint8_t* rgb, int32_t w, int32_t h,
                        int32_t quality, uint8_t* out, int64_t cap) {
  if (w <= 0 || h <= 0 || w > 65535 || h > 65535) return 0;
  std::vector<uint8_t> enc = encode_jpeg(rgb, w, h, quality);
  int64_t size = static_cast<int64_t>(enc.size());
  if (size > cap) return -size;
  std::memcpy(out, enc.data(), enc.size());
  return size;
}

uint32_t emx_crc32c(const uint8_t* p, uint64_t n, uint32_t crc) {
  crc = ~crc;
  while (n >= 8) {
    uint32_t lo = crc ^ (uint32_t(p[0]) | uint32_t(p[1]) << 8 |
                         uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24);
    crc = g_crc.t[7][lo & 0xFF] ^ g_crc.t[6][(lo >> 8) & 0xFF] ^
          g_crc.t[5][(lo >> 16) & 0xFF] ^ g_crc.t[4][lo >> 24] ^
          g_crc.t[3][p[4]] ^ g_crc.t[2][p[5]] ^ g_crc.t[1][p[6]] ^
          g_crc.t[0][p[7]];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ g_crc.t[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

}  // extern "C"
