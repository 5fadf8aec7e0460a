// JPEG decoder for the port's dataset readers (Replica's
// results/frame*.jpg and any JPEG an image folder holds), bound with
// ctypes by data/jpeg.py.
//
// It decodes what cv2.imread decodes with libjpeg-turbo's default
// settings, bit for bit, by following IJG libjpeg's published decode
// arithmetic:
//   - jidctint.c's "islow" integer IDCT (CONST_BITS 13, PASS1_BITS 2,
//     64-bit intermediates, the post-IDCT range-limit table);
//   - jdsample.c's upsampling: "fancy" (triangular) h2v1 and h2v2 when the
//     downsampled width exceeds 2 (else sample replication), fancy h1v2,
//     and replication for every other integral ratio (4:1:1), with the
//     alternating rounding biases and replicated edges (jdmainct.c repeats
//     the first and the last real sample row);
//   - jdcolor.c's fixed-point YCbCr -> RGB, YCCK -> CMYK and RGB -> gray
//     tables (SCALEBITS 16), and OpenCV's own CMYK -> BGR and CMYK -> gray
//     conversions (OpenCV asks libjpeg for CMYK output from a 4-component
//     file);
//   - jdphuff.c's progressive Huffman decoding (DC and AC first and
//     refinement scans, end-of-band runs), all scans gathered into the
//     coefficients and then rendered once: libjpeg applies no block
//     smoothing when every coefficient's last scan has arrived;
//   - jdhuff.c's handling of data that ends early: the bits past the end
//     read as zeros, the MCU where they ran out is finished with them and
//     every later MCU of the scan keeps the coefficients it had (zeros in
//     a sequential file: level 128), with a warning.
// Scope: SOF0 / SOF1 / SOF2 at 8 bits; 1 (gray), 3 (YCbCr, or RGB by the
// Adobe transform 0 or the component ids 'R' 'G' 'B') or 4 (CMYK, or
// YCCK by the Adobe transform 2) components; sampling factors 1 to 4 at
// integral ratios; interleaved and non-interleaved scans, restart
// intervals, byte stuffing and fill bytes, sizes that are not a multiple
// of the MCU, and the standard Huffman tables where a file defines none
// (Motion-JPEG frames). Lossless, hierarchical and arithmetic-coded files,
// 12-bit samples, fractional sampling ratios and a progressive file whose
// scans stop before the low-frequency coefficients are complete (which
// libjpeg renders with block smoothing) are refused with a message naming
// the feature.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// zigzag index -> natural (row-major) index; 16 extra entries keep a
// corrupt run inside the block, as libjpeg's jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // kLookBits-bit prefix -> (code length << 8) | symbol; 0: a longer code
  uint16_t look[1 << kLookBits];
};

void build_huffman(Huffman& t, const uint8_t* bits, const uint8_t* vals,
                   int nvals, bool dc) {
  // jdhuff.c jpeg_make_d_derived_tbl (Figures C.1, C.2, F.15)
  uint8_t size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l - 1]; i++) size[p++] = (uint8_t)l;
  size[p] = 0;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (1u << si)) throw Error("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l - 1]) {
      t.valoffset[l] = p - (int32_t)code_of[p];
      p += bits[l - 1];
      t.maxcode[l] = (int32_t)code_of[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  std::memcpy(t.vals, vals, nvals);
  if (dc)
    for (int i = 0; i < nvals; i++)
      if (vals[i] > 15) throw Error("bad Huffman table (DC symbol > 15)");
  std::memset(t.look, 0, sizeof(t.look));
  p = 0;
  for (int l = 1; l <= kLookBits; l++)
    for (int i = 0; i < bits[l - 1]; i++, p++) {
      int base = (int)(code_of[p] << (kLookBits - l));
      for (int k = 0; k < (1 << (kLookBits - l)); k++)
        t.look[base + k] = (uint16_t)((l << 8) | vals[p]);
    }
}

// jstdhuff.c: the tables of the JPEG standard's Annex K.3, which
// libjpeg-turbo uses for table 0 (luminance) and 1 (chrominance) when a
// file defines none
const uint8_t kStdDcBits[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcBits[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
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
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
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
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// Entropy-coded data reader. Bits are left-aligned in `buf`; at a marker or
// at the end of the data it appends zero bytes, as libjpeg does. `real`
// counts the bits in `buf` that came from the data: consuming more than
// those sets `insufficient` (jdhuff.c's insufficient_data), and the
// decoder then leaves the scan's later MCUs alone.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  const uint8_t* marker = nullptr;  // the 0xFF that starts the next marker
  uint64_t buf = 0;
  int cnt = 0;
  int real = 0;
  bool insufficient = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (marker == nullptr && p < end) {
        b = *p;
        if (b == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;  // fill bytes
          if (q < end && *q == 0x00) {
            p = q + 1;  // stuffed zero: a data byte 0xFF
            real += 8;
          } else {
            marker = p;
            b = 0;
          }
        } else {
          p++;
          real += 8;
        }
      } else if (marker == nullptr) {
        marker = end;
      }
      buf |= (uint64_t)b << (56 - cnt);
      cnt += 8;
    }
  }
  void consume(int n) {
    buf <<= n;
    cnt -= n;
    if (n > real) {
      insufficient = true;
      real = 0;
    } else {
      real -= n;
    }
  }
  int bits(int n) {  // n in 1..16
    if (cnt < n) fill();
    int v = (int)(buf >> (64 - n));
    consume(n);
    return v;
  }
  int bit() { return bits(1); }
  int decode(const Huffman& t) {
    if (cnt < 16) fill();
    int e = t.look[buf >> (64 - kLookBits)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = (int32_t)(buf >> (64 - l));
    while (code > t.maxcode[l]) {
      l++;
      if (l > 16) throw Error("bad Huffman code in JPEG data");
      code = (int32_t)(buf >> (64 - l));
    }
    consume(l);
    return t.vals[code + t.valoffset[l]];
  }
  // after a restart interval: drop the padding bits, read RSTn. Where the
  // data has ended (a truncated file) there is no marker to read: the
  // zeros go on, as libjpeg leaves its out-of-data state as it was.
  void restart(int expected) {
    const uint8_t* q = marker ? marker : p;
    while (q < end && *q != 0xFF) q++;  // extraneous bytes
    while (q < end && *q == 0xFF) q++;
    buf = 0;
    cnt = real = 0;
    if (q >= end) {
      p = marker = end;
      return;
    }
    if (*q != 0xD0 + expected) throw Error("bad JPEG restart marker");
    p = q + 1;
    marker = nullptr;
    insufficient = false;
  }
  // where marker parsing resumes after the scan
  const uint8_t* resume() const { return marker ? marker : p; }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (int)(~0u << s) + 1 : v;
}

struct Component {
  int id, h, v, tq;
  int bw, bh;      // blocks stored (whole MCUs)
  int dw, dh;      // downsampled size in samples
  bool latched = false;
  int16_t quant[64] = {};  // natural order, as libjpeg's ISLOW_MULT_TYPE
  int coef_bits[64];       // jdphuff.c: the last Al of each coefficient
  std::vector<int16_t> coef;  // bh * bw blocks of 64
};

// --- jidctint.c: jpeg_idct_islow -----------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196,
                  F0_541196100 = 4433, F0_765366865 = 6270,
                  F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137,
                  F1_961570560 = 16069, F2_053119869 = 16819,
                  F2_562915447 = 20995, F3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

struct RangeLimit {
  // jdmaster.c prepare_range_limit_table, the post-IDCT part: index
  // (value & 1023) of a level-shifted sample
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      if (i < 128) t[i] = (uint8_t)(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = (uint8_t)(i - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = (int)((int64_t)ip[0] * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = kConstBits - kPass1Bits;
    wp[0] = (int)descale(tmp10 + tmp3, s);
    wp[56] = (int)descale(tmp10 - tmp3, s);
    wp[8] = (int)descale(tmp11 + tmp2, s);
    wp[48] = (int)descale(tmp11 - tmp2, s);
    wp[16] = (int)descale(tmp12 + tmp1, s);
    wp[40] = (int)descale(tmp12 - tmp1, s);
    wp[24] = (int)descale(tmp13 + tmp0, s);
    wp[32] = (int)descale(tmp13 - tmp0, s);
  }
  const int s = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t v = kRange.t[(int)descale(wp[0], kPass1Bits + 3) & 1023];
      for (int k = 0; k < 8; k++) op[k] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.t[(int)descale(tmp10 + tmp3, s) & 1023];
    op[7] = kRange.t[(int)descale(tmp10 - tmp3, s) & 1023];
    op[1] = kRange.t[(int)descale(tmp11 + tmp2, s) & 1023];
    op[6] = kRange.t[(int)descale(tmp11 - tmp2, s) & 1023];
    op[2] = kRange.t[(int)descale(tmp12 + tmp1, s) & 1023];
    op[5] = kRange.t[(int)descale(tmp12 - tmp1, s) & 1023];
    op[3] = kRange.t[(int)descale(tmp13 + tmp0, s) & 1023];
    op[4] = kRange.t[(int)descale(tmp13 - tmp0, s) & 1023];
  }
}

// --- jdsample.c: one component to full size --------------------------------

// `plane` holds the component's samples (row stride `stride`, dh x dw
// real); `out` receives H x W samples at full size. (rh, rv) is the
// integral ratio of the largest sampling factors to the component's.
void upsample(const uint8_t* plane, int stride, int dw, int dh, int rh,
              int rv, uint8_t* out, int W, int H) {
  auto row = [&](int y) {  // jdmainct.c: first and last real rows repeat
    return plane + (size_t)(y < 0 ? 0 : (y >= dh ? dh - 1 : y)) * stride;
  };
  auto col = [&](int x) { return x < 0 ? 0 : (x >= dw ? dw - 1 : x); };
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < H; y++) std::memcpy(out + (size_t)y * W, row(y), W);
    return;
  }
  if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < H; y++) {
      const uint8_t* near = row(y >> 1);
      const uint8_t* far = row((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* o = out + (size_t)y * W;
      for (int x = 0; x < W; x++) o[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
    }
    return;
  }
  bool fancy = dw > 2;
  if (rh == 2 && rv == 1) {
    for (int y = 0; y < H; y++) {
      const uint8_t* in = row(y);
      uint8_t* o = out + (size_t)y * W;
      for (int x = 0; x < W; x++) {
        int j = x >> 1;
        if (!fancy) {  // h2v1_upsample
          o[x] = in[j];
        } else if (x & 1) {  // h2v1_fancy_upsample
          o[x] = (uint8_t)((in[j] * 3 + in[col(j + 1)] + 2) >> 2);
        } else {
          o[x] = (uint8_t)((in[j] * 3 + in[col(j - 1)] + 1) >> 2);
        }
      }
    }
    return;
  }
  if (rh == 2 && rv == 2) {
    std::vector<int> colsum(dw);
    for (int y = 0; y < H; y++) {
      uint8_t* o = out + (size_t)y * W;
      if (!fancy) {  // h2v2_upsample
        const uint8_t* in = row(y >> 1);
        for (int x = 0; x < W; x++) o[x] = in[x >> 1];
        continue;
      }
      // h2v2_fancy_upsample: nearer row * 3 + farther row, then the same
      // triangle across columns with biases 8 and 7
      const uint8_t* near = row(y >> 1);
      const uint8_t* far = row((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
      for (int j = 0; j < dw; j++) colsum[j] = near[j] * 3 + far[j];
      for (int x = 0; x < W; x++) {
        int j = x >> 1;
        if (x & 1)
          o[x] = (uint8_t)((colsum[j] * 3 + colsum[col(j + 1)] + 7) >> 4);
        else
          o[x] = (uint8_t)((colsum[j] * 3 + colsum[col(j - 1)] + 8) >> 4);
      }
    }
    return;
  }
  // int_upsample: every other integral ratio (4:1:1 and the like) repeats
  // each sample rh times across and rv times down
  for (int y = 0; y < H; y++) {
    const uint8_t* in = row(y / rv);
    uint8_t* o = out + (size_t)y * W;
    for (int x = 0; x < W; x++) o[x] = in[x / rh];
  }
}

// --- jdcolor.c: YCbCr -> RGB ------------------------------------------------

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int kBits = 16;
    const int64_t half = (int64_t)1 << (kBits - 1);
    auto fix = [](double x) { return (int64_t)(x * (1 << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + half) >> kBits);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> kBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jdcolor.c build_rgb_y_table: RGB -> Y for a gray read of an RGB-coded
// file (SCALEBITS 16)
struct RgbYTables {
  int64_t r[256], g[256], b[256];
  RgbYTables() {
    auto fix = [](double x) { return (int64_t)(x * (1 << 16) + 0.5); };
    for (int i = 0; i < 256; i++) {
      r[i] = fix(0.29900) * i;
      g[i] = fix(0.58700) * i;
      b[i] = fix(0.11400) * i + ((int64_t)1 << 15);
    }
  }
};
const RgbYTables kRgbY;

// OpenCV's icvCvt_CMYK2BGR_8u_C4C3R: one channel of a CMYK sample (as
// libjpeg hands it over: an Adobe file's inverted values) with its K
inline int cmyk_channel(int c, int k) { return k - (((255 - c) * k) >> 8); }

// OpenCV's icvCvt_CMYK2Gray_8u_C4C1R weights (SCALE 14)
constexpr int kGrayR = 4899, kGrayG = 9617, kGrayB = 1868;

// --- the file --------------------------------------------------------------

enum Space { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  int W = 0, H = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool progressive = false, saw_jfif = false, saw_adobe = false;
  bool truncated = false;  // data ended early or without EOI
  int adobe_transform = -1;
  Space space = kGray;
  Component comp[4];
  uint16_t qtab[4][64];
  bool qdef[4] = {false, false, false, false};
  Huffman dc[4], ac[4];

  Decoder(const uint8_t* d, int64_t n) : data(d), end(d + n) {}

  int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

  // the payload of the marker segment at p (p after the marker code)
  const uint8_t* segment(const uint8_t* p, int* len) {
    if (end - p < 2) throw Error("truncated JPEG data (in a marker segment)");
    *len = u16(p) - 2;
    if (*len < 0 || end - p - 2 < *len)
      throw Error("truncated JPEG data (in a marker segment)");
    return p + 2;
  }

  void read_sof(const uint8_t* s, int len) {
    if (len < 6) throw Error("bad JPEG frame header");
    if (s[0] == 12) throw Error("12-bit JPEG samples are not supported");
    if (s[0] != 8)
      throw Error("JPEG sample precision " + std::to_string(s[0]) +
                  " is not supported (8 bits are)");
    H = u16(s + 1);
    W = u16(s + 3);
    ncomp = s[5];
    if (H == 0) throw Error("JPEG height defined by a DNL marker is not supported");
    if (W == 0) throw Error("bad JPEG frame header (width 0)");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      throw Error("JPEGs with " + std::to_string(ncomp) +
                  " components are not supported (1, 3 or 4 are)");
    if (len < 6 + 3 * ncomp) throw Error("bad JPEG frame header");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        throw Error("bad JPEG sampling factors (1 to 4 are allowed)");
      if (c.tq > 3) throw Error("bad JPEG quantization table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (int i = 0; i < ncomp; i++)
      if (hmax % comp[i].h || vmax % comp[i].v)
        throw Error("JPEG fractional sampling ratios are not supported");
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (W * c.h + hmax - 1) / hmax;
      c.dh = (H * c.v + vmax - 1) / vmax;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
  }

  void read_dqt(const uint8_t* s, int len) {
    while (len > 0) {
      int pq = s[0] >> 4, tq = s[0] & 15;
      int n = pq ? 128 : 64;
      if (tq > 3 || pq > 1 || len < 1 + n) throw Error("bad JPEG quantization table");
      for (int k = 0; k < 64; k++)
        qtab[tq][kNatural[k]] = pq ? (uint16_t)u16(s + 1 + 2 * k) : s[1 + k];
      qdef[tq] = true;
      s += 1 + n;
      len -= 1 + n;
    }
  }

  void read_dht(const uint8_t* s, int len) {
    while (len > 0) {
      if (len < 17) throw Error("bad JPEG Huffman table");
      int tc = s[0] >> 4, th = s[0] & 15;
      int n = 0;
      for (int i = 0; i < 16; i++) n += s[1 + i];
      if (tc > 1 || th > 3 || n > 256 || len < 17 + n)
        throw Error("bad JPEG Huffman table");
      Huffman& t = tc ? ac[th] : dc[th];
      build_huffman(t, s + 1, s + 17, n, tc == 0);
      t.defined = true;
      s += 17 + n;
      len -= 17 + n;
    }
  }

  // a scan's Huffman table: the file's, else (jdhuff.c via jstdhuff.c)
  // the standard one for tables 0 and 1
  const Huffman& table(bool is_dc, int n) {
    Huffman& t = is_dc ? dc[n] : ac[n];
    if (!t.defined) {
      if (n > 1) throw Error("JPEG scan uses an undefined Huffman table");
      if (is_dc) {
        build_huffman(t, kStdDcBits[n], kStdDcVals, 12, true);
      } else {
        build_huffman(t, kStdAcBits[n], kStdAcVals[n], 162, false);
      }
      t.defined = true;
    }
    return t;
  }

  void find_color_space() {
    // jdapimin.c default_decompress_parms
    if (ncomp == 1) {
      space = kGray;
    } else if (ncomp == 3) {
      bool rgb;
      if (saw_jfif)
        rgb = false;
      else if (saw_adobe)
        rgb = adobe_transform == 0;
      else
        rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
      space = rgb ? kRGB : kYCbCr;
    } else {
      space = (saw_adobe && adobe_transform != 0) ? kYCCK : kCMYK;
    }
  }

  // --- jdhuff.c / jdphuff.c: one block of a scan ---

  void seq_block(BitReader& br, int16_t* blk, int& pred, const Huffman& hd,
                 const Huffman& ha) {
    int s = br.decode(hd);
    if (s) pred += extend(br.bits(s), s);
    blk[0] = (int16_t)pred;
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(br.bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void dc_first(BitReader& br, int16_t* blk, int& pred, const Huffman& hd,
                int al) {
    int s = br.decode(hd);
    if (s) pred += extend(br.bits(s), s);
    blk[0] = (int16_t)(int)((unsigned)pred << al);
  }

  void dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.bit()) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  void ac_first(BitReader& br, int16_t* blk, const Huffman& ha, int ss,
                int se, int al, int& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(br.bits(s), s);
        blk[kNatural[k]] = (int16_t)(int)((unsigned)v << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        eobrun--;
        break;
      }
    }
  }

  void ac_refine(BitReader& br, int16_t* blk, const Huffman& ha, int ss,
                 int se, int al, int& eobrun) {
    const int p1 = 1 << al, m1 = (int)(~0u << al);
    int k = ss;
    auto correct = [&](int16_t* c) {  // a correction bit of a nonzero coef
      if (br.bit() && (*c & p1) == 0) *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
    };
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(ha);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          // the size of a newly nonzero coefficient is 1 (libjpeg warns
          // and goes on otherwise)
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;  // the rest of the block is the end-of-band run's
        }
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            correct(c);
          } else if (--r < 0) {
            break;  // the zero coefficient that becomes nonzero
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) correct(c);
      }
      eobrun--;
    }
  }

  // returns where marker parsing resumes
  const uint8_t* read_scan(const uint8_t* s, int len, const uint8_t* after) {
    if (W == 0) throw Error("JPEG scan before the frame header");
    int ns = len > 0 ? s[0] : 0;
    if (ns < 1 || ns > ncomp || len < 4 + 2 * ns) throw Error("bad JPEG scan header");
    Component* sc[4];
    int td[4], ta[4];
    for (int i = 0; i < ns; i++) {
      int id = s[1 + 2 * i];
      sc[i] = nullptr;
      for (int k = 0; k < ncomp; k++)
        if (comp[k].id == id) sc[i] = &comp[k];
      if (!sc[i]) throw Error("bad JPEG scan header (unknown component)");
      td[i] = s[2 + 2 * i] >> 4;
      ta[i] = s[2 + 2 * i] & 15;
      if (td[i] > 3 || ta[i] > 3) throw Error("bad JPEG scan header (table index)");
    }
    const uint8_t* t = s + 1 + 2 * ns;
    const int ss = t[0], se = t[1], ah = t[2] >> 4, al = t[2] & 15;
    const bool dc_band = ss == 0;
    if (!progressive) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        throw Error("bad JPEG scan header (not a sequential scan)");
    } else {
      // jdphuff.c start_pass_phuff_decoder
      bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad)
        throw Error("bad progressive JPEG scan parameters (Ss " +
                    std::to_string(ss) + ", Se " + std::to_string(se) +
                    ", Ah " + std::to_string(ah) + ", Al " +
                    std::to_string(al) + ")");
      for (int i = 0; i < ns; i++)
        for (int k = ss; k <= se; k++) sc[i]->coef_bits[k] = al;
    }
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i];
      if (!c.latched) {  // jdinput.c latch_quant_tables
        if (!qdef[c.tq]) throw Error("JPEG component uses an undefined quantization table");
        for (int k = 0; k < 64; k++) c.quant[k] = (int16_t)qtab[c.tq][k];
        c.latched = true;
      }
    }
    const Huffman* hd[4] = {};
    const Huffman* ha[4] = {};
    for (int i = 0; i < ns; i++) {
      if (!progressive || (dc_band && ah == 0)) hd[i] = &table(true, td[i]);
      if (!progressive || !dc_band) ha[i] = &table(false, ta[i]);
    }
    int blocks_per_mcu = 0;
    for (int i = 0; i < ns; i++) blocks_per_mcu += sc[i]->h * sc[i]->v;
    if (ns > 1 && blocks_per_mcu > 10) throw Error("bad JPEG scan (MCU too large)");

    BitReader br{after, end};
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    auto block = [&](int i, int by, int bx) {
      Component& c = *sc[i];
      int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
      if (!progressive)
        seq_block(br, blk, pred[i], *hd[i], *ha[i]);
      else if (dc_band && ah == 0)
        dc_first(br, blk, pred[i], *hd[i], al);
      else if (dc_band)
        dc_refine(br, blk, al);
      else if (ah == 0)
        ac_first(br, blk, *ha[i], ss, se, al, eobrun);
      else
        ac_refine(br, blk, *ha[i], ss, se, al, eobrun);
    };
    int nx, ny;
    if (ns == 1) {
      nx = (sc[0]->dw + 7) / 8;
      ny = (sc[0]->dh + 7) / 8;
    } else {
      nx = mcux;
      ny = mcuy;
    }
    int64_t total = (int64_t)nx * ny, todo = restart_interval, rst = 0;
    for (int64_t m = 0; m < total; m++) {
      if (restart_interval) {
        if (todo == 0) {
          br.restart((int)(rst++ & 7));
          pred[0] = pred[1] = pred[2] = pred[3] = 0;
          eobrun = 0;
          todo = restart_interval;
        }
        todo--;
      }
      if (br.insufficient) continue;  // jdhuff.c: out of data
      int my = (int)(m / nx), mx = (int)(m % nx);
      if (ns == 1) {
        block(0, my, mx);
        continue;
      }
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        for (int by = 0; by < c.v; by++)
          for (int bx = 0; bx < c.h; bx++)
            block(i, my * c.v + by, mx * c.h + bx);
      }
    }
    if (br.insufficient) truncated = true;
    return br.resume();
  }

  // parses markers up to the first scan (header only) or to EOI
  void run(bool header_only) {
    if (end - data < 2 || data[0] != 0xFF || data[1] != 0xD8)
      throw Error("not a JPEG file");
    const uint8_t* p = data + 2;
    bool any_scan = false;
    while (true) {
      // the next marker: skip what is not 0xFF (garbage), then fill bytes
      while (p < end && *p != 0xFF) p++;
      while (p < end && *p == 0xFF) p++;
      if (p >= end) {
        if (!any_scan) throw Error("truncated JPEG data (no scan)");
        truncated = true;  // libjpeg: "Premature end of JPEG file"
        break;
      }
      int code = *p++;
      if (code == 0xD9) break;                         // EOI
      if (code >= 0xD0 && code <= 0xD7) continue;      // stray RSTn
      if (code == 0x01) continue;                      // TEM
      if (code == 0xC3 || code == 0xC7)
        throw Error("lossless JPEGs are not supported");
      if (code == 0xC5 || code == 0xC6)
        throw Error("hierarchical (differential) JPEGs are not supported");
      if (code >= 0xC9 && code <= 0xCF && code != 0xCC)
        throw Error("arithmetic-coded JPEGs are not supported");
      if (code == 0xCC)
        throw Error("arithmetic-coded JPEGs are not supported (DAC marker)");
      int len;
      const uint8_t* s = segment(p, &len);
      const uint8_t* next = s + len;
      switch (code) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          if (W) throw Error("bad JPEG: two frame headers");
          progressive = code == 0xC2;
          read_sof(s, len);
          for (int i = 0; i < ncomp; i++)
            comp[i].coef.assign((size_t)comp[i].bw * comp[i].bh * 64, 0);
          break;
        case 0xC4: read_dht(s, len); break;
        case 0xDB: read_dqt(s, len); break;
        case 0xDD:
          if (len < 2) throw Error("bad JPEG restart interval");
          restart_interval = u16(s);
          break;
        case 0xE0:  // jdmarker.c examine_app0: APP0_DATA_LEN 14
          if (len >= 14 && std::memcmp(s, "JFIF\0", 5) == 0) saw_jfif = true;
          break;
        case 0xEE:  // examine_app14: APP14_DATA_LEN 12
          if (len >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = s[11];
          }
          break;
        case 0xDA:
          if (!any_scan) {
            find_color_space();
            if (header_only) return;
          }
          any_scan = true;
          next = read_scan(s, len, next);
          break;
        default: break;  // APPn, COM and others: skipped
      }
      p = next;
    }
    if (W == 0) throw Error("JPEG without a frame header");
    if (progressive && smoothing_applies())
      throw Error(
          "progressive JPEG whose scans stop before its low-frequency "
          "coefficients are complete (libjpeg renders it with block "
          "smoothing, which this decoder does not implement)");
  }

  // jdcoefct.c smoothing_ok (SAVED_COEFS 10): libjpeg smooths blocks when
  // every component has its DC and some of coefficients 1..9 still lack
  // their last scan
  bool smoothing_applies() const {
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      const Component& c = comp[i];
      if (!c.latched) return false;
      for (int k : kPos)
        if (c.quant[k] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // component i's samples at full size
  std::vector<uint8_t> plane(int i) {
    Component& c = comp[i];
    int stride = c.bw * 8;
    std::vector<uint8_t> idct((size_t)stride * c.bh * 8);
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.quant,
                   &idct[(size_t)by * 8 * stride + bx * 8], stride);
    std::vector<uint8_t> full((size_t)W * H);
    upsample(idct.data(), stride, c.dw, c.dh, hmax / c.h, vmax / c.v,
             full.data(), W, H);
    return full;
  }

  // gray: H x W (cv2's IMREAD_GRAYSCALE); else H x W gray for a
  // 1-component file and H x W x 3 RGB for the others (IMREAD_COLOR)
  void render(uint8_t* out, bool gray) {
    const size_t n = (size_t)W * H;
    if (space == kGray || (gray && space == kYCbCr)) {
      std::vector<uint8_t> y = plane(0);  // jdcolor.c grayscale_convert
      std::memcpy(out, y.data(), n);
      return;
    }
    std::vector<uint8_t> p[4];
    for (int i = 0; i < ncomp; i++) p[i] = plane(i);
    for (size_t k = 0; k < n; k++) {
      int r, g, b;
      if (space == kRGB) {
        r = p[0][k];
        g = p[1][k];
        b = p[2][k];
        if (gray) {  // jdcolor.c rgb_gray_convert
          out[k] = (uint8_t)((kRgbY.r[r] + kRgbY.g[g] + kRgbY.b[b]) >> 16);
          continue;
        }
      } else if (space == kYCbCr) {
        int y = p[0][k], cb = p[1][k], cr = p[2][k];
        r = clamp255(y + kYcc.cr_r[cr]);
        g = clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        b = clamp255(y + kYcc.cb_b[cb]);
      } else {
        int c0 = p[0][k], c1 = p[1][k], c2 = p[2][k], kk = p[3][k];
        if (space == kYCCK) {  // jdcolor.c ycck_cmyk_convert
          int y = c0, cb = c1, cr = c2;
          c0 = clamp255(255 - (y + kYcc.cr_r[cr]));
          c1 = clamp255(255 - (y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
          c2 = clamp255(255 - (y + kYcc.cb_b[cb]));
        }
        r = cmyk_channel(c0, kk);
        g = cmyk_channel(c1, kk);
        b = cmyk_channel(c2, kk);
        if (gray) {  // icvCvt_CMYK2Gray_8u_C4C1R
          out[k] = (uint8_t)((r * kGrayR + g * kGrayG + b * kGrayB + (1 << 13)) >> 14);
          continue;
        }
      }
      out[3 * k] = (uint8_t)r;
      out[3 * k + 1] = (uint8_t)g;
      out[3 * k + 2] = (uint8_t)b;
    }
  }
};

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
}

}  // namespace

extern "C" {

// Reads the headers up to the first scan: width, height and components
// (1, 3 or 4). Returns 0, or 1 with a message in err.
int jpeg_info(const uint8_t* data, int64_t n, int32_t* whc, char* err,
              int errlen) {
  try {
    Decoder d(data, n);
    d.run(true);
    if (d.W == 0) throw Error("JPEG without a frame header");
    whc[0] = d.W;
    whc[1] = d.H;
    whc[2] = d.ncomp;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Decodes into out: with gray != 0, H x W (cv2.IMREAD_GRAYSCALE);
// otherwise H x W for a 1-component file, else H x W x 3 RGB
// (cv2.IMREAD_COLOR). out_size must be that. *truncated is set to 1 where
// the data ended early (libjpeg's warning). Returns 0, or 1 with a message
// in err.
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                int64_t out_size, int gray, int32_t* truncated, char* err,
                int errlen) {
  try {
    Decoder d(data, n);
    d.run(false);
    int channels = (gray || d.ncomp == 1) ? 1 : 3;
    if ((int64_t)d.W * d.H * channels != out_size)
      throw Error("output buffer has the wrong size");
    d.render(out, gray != 0);
    *truncated = d.truncated ? 1 : 0;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

}  // extern "C"
