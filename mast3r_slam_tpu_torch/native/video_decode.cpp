// Video frame decoder for the port's video reader (data/video.py), bound
// with ctypes.
//
// It decodes what OpenCV's FFmpeg backend (cv2.VideoCapture) decodes, bit
// for bit, by following FFmpeg's decode arithmetic, decoding to Y/Cb/Cr
// 4:2:0 planes (H.264 and VP9 in their own files):
//   - MPEG-4 Part 2 (ISO/IEC 14496-2) as FFmpeg's `mpeg4` decoder reads
//     what FFmpeg, Xvid and DivX write (fourcc mp4v, XVID, DIVX, FMP4,
//     ...): VOS/VO/VOL/GOV headers and user data; I-, P-, B- and
//     not-coded VOPs (FFmpeg puts out no frame for a not-coded VOP, but
//     for a stream's last); intra DC VLC or intra DC as a TCOEF
//     (intra_dc_vlc_thr), DC and AC prediction with the QP rescaling and
//     the alternate scans under ac_pred; the TCOEF VLCs with the three
//     escape modes; H.263 and MPEG quantisation with the VOL's matrices
//     (MPEG's mismatch control on inter blocks); P macroblocks with 1MV and
//     4MV (median prediction, f_code residuals, the 4MV chroma vector's
//     sixteenth rounding), B macroblocks in the four modes (direct: the
//     co-located P macroblock's one or four vectors scaled by TRB / TRD
//     from the VOP clock, modulo_time_base and GOV time codes included;
//     interpolate, backward, forward; MODB, CBPB, DBQUANT, both f_codes;
//     a macroblock skipped in the future reference skipped too); half-pel
//     MC placed as mpegvideo_motion.c places its reads (1MV blocks read
//     through the edge emulation over h_edge_pos / v_edge_pos, 8x8 blocks
//     clipped first) with hpeldsp's x86 arithmetic (the 8-wide no_rnd
//     averages approximate); FFmpeg's output order (a VOL that is not low
//     delay puts each I- or P-VOP out at the next one, a B-VOP at once; a
//     B-VOP before two references is skipped); DivX / Xvid packed
//     bitstreams (the VOP a sample leaves over is decoded at the next);
//     sizes that are not multiples of 16. The IDCT, which Part 2 leaves to
//     the decoder, and the workarounds are FFmpeg's choice by the
//     encoder's build (user data XviD / DivX / Lavc / FFmpeg) and the
//     container's codec tag, as ff_mpeg4_workaround_bugs makes it: Xvid's
//     IDCT (xvididct.c, as its SSE2 version saturates) once the build is
//     Xvid's or the tag says Xvid with no build named, with FF_BUG_EDGE
//     (edges at the display size) and FF_BUG_DC_CLIP (DC predictors over
//     2047 kept) where the build sets them; else FFmpeg's integer "simple"
//     IDCT (simple_idct_template.c at 8 bits: row shift 11, column shift
//     20). The other workarounds touch only tools refused below
//     (quarter-pel, fields), or (FF_BUG_HPEL_CHROMA, set for DivX) change
//     nothing in what cv2's FFmpeg puts out.
//   - Motion JPEG frames as FFmpeg's `mjpeg` decoder gives them: the
//     entropy stage of jpeg_decode.cpp (baseline and progressive Huffman,
//     the standard tables where a frame defines none), coefficients
//     dequantized into 16 bits, the simple IDCT, and the planes as they
//     are, without libjpeg's upsampling.
// Frames go to RGB through one converter, I420 (limited range) or J420
// (full range) -> RGB24, as the unscaled YUV -> RGB path of swscale that
// OpenCV's sws_scale call (BGR24, same size) takes: each chroma sample
// covers its 2x2 luma samples, and each channel is the saturated sum of a
// luma term and one or two chroma terms, each a 16-bit fixed-point product
// truncated as pmulhw truncates (see yuv_to_rgb below).
//
// Refused with a message naming the feature: quarter-pel motion, GMC and
// static sprites (S-VOPs), interlaced VOLs, data partitioning and RVLC,
// resync markers, NEWPRED, reduced-resolution VOPs, scalability,
// non-rectangular shapes, not-8-bit VOLs, complexity estimation headers,
// the short video header (H.263 baseline) and a VOL that changes the
// picture's size (FFmpeg reinitialises there); MJPEG frames that are not 4:2:0
// YCbCr. A frame whose data ends early or does not parse is an error.

#include <climits>
#include <cstdlib>
#include <deque>
#include <memory>

#include "jpeg_decode.cpp"

namespace {

// --- FFmpeg simple_idct_template.c (BIT_DEPTH 8) ---------------------------

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873,
              W6 = 8867, W7 = 4520;
constexpr int kRowShift = 11, kColShift = 20, kDcShift = 3;

inline uint8_t clip_u8(int v) { return (uint8_t)std::min(std::max(v, 0), 255); }

// Unsigned sums wrap as FFmpeg's (SUINT) arithmetic does; each output is
// the wrapped sum as a signed 32-bit value, shifted.
void idct_row(int16_t* row) {
  if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
    int16_t t = (int16_t)(uint16_t)((unsigned)row[0] << kDcShift);
    for (int i = 0; i < 8; i++) row[i] = t;
    return;
  }
  unsigned a0 = W4 * row[0] + (1 << (kRowShift - 1));
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * row[2];
  a1 += W6 * row[2];
  a2 -= W6 * row[2];
  a3 -= W2 * row[2];
  unsigned b0 = W1 * row[1] + W3 * row[3];
  unsigned b1 = W3 * row[1] - W7 * row[3];
  unsigned b2 = W5 * row[1] - W1 * row[3];
  unsigned b3 = W7 * row[1] - W5 * row[3];
  a0 += W4 * row[4] + W6 * row[6];
  a1 += -W4 * row[4] - W2 * row[6];
  a2 += -W4 * row[4] + W2 * row[6];
  a3 += W4 * row[4] - W6 * row[6];
  b0 += W5 * row[5] + W7 * row[7];
  b1 += -W1 * row[5] - W5 * row[7];
  b2 += W7 * row[5] + W3 * row[7];
  b3 += W3 * row[5] - W1 * row[7];
  row[0] = (int16_t)((int)(a0 + b0) >> kRowShift);
  row[7] = (int16_t)((int)(a0 - b0) >> kRowShift);
  row[1] = (int16_t)((int)(a1 + b1) >> kRowShift);
  row[6] = (int16_t)((int)(a1 - b1) >> kRowShift);
  row[2] = (int16_t)((int)(a2 + b2) >> kRowShift);
  row[5] = (int16_t)((int)(a2 - b2) >> kRowShift);
  row[3] = (int16_t)((int)(a3 + b3) >> kRowShift);
  row[4] = (int16_t)((int)(a3 - b3) >> kRowShift);
}

// the column pass of column c: out[r] for the 8 rows
void idct_col(const int16_t* blk, int c, int* out) {
  const int16_t* col = blk + c;
  unsigned a0 = W4 * (col[0] + ((1 << (kColShift - 1)) / W4));
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * col[16];
  a1 += W6 * col[16];
  a2 += -W6 * col[16];
  a3 += -W2 * col[16];
  unsigned b0 = W1 * col[8] + W3 * col[24];
  unsigned b1 = W3 * col[8] - W7 * col[24];
  unsigned b2 = W5 * col[8] - W1 * col[24];
  unsigned b3 = W7 * col[8] - W5 * col[24];
  a0 += W4 * col[32];
  a1 += -W4 * col[32];
  a2 += -W4 * col[32];
  a3 += W4 * col[32];
  b0 += W5 * col[40];
  b1 += -W1 * col[40];
  b2 += W7 * col[40];
  b3 += W3 * col[40];
  a0 += W6 * col[48];
  a1 += -W2 * col[48];
  a2 += W2 * col[48];
  a3 += -W6 * col[48];
  b0 += W7 * col[56];
  b1 += -W5 * col[56];
  b2 += W3 * col[56];
  b3 += -W1 * col[56];
  out[0] = (int)(a0 + b0) >> kColShift;
  out[1] = (int)(a1 + b1) >> kColShift;
  out[2] = (int)(a2 + b2) >> kColShift;
  out[3] = (int)(a3 + b3) >> kColShift;
  out[4] = (int)(a3 - b3) >> kColShift;
  out[5] = (int)(a2 - b2) >> kColShift;
  out[6] = (int)(a1 - b1) >> kColShift;
  out[7] = (int)(a0 - b0) >> kColShift;
}

// blk (natural order, modified in place) -> dst; add: dst + residual
void simple_idct(int16_t* blk, uint8_t* dst, int stride, bool add) {
  for (int r = 0; r < 8; r++) idct_row(blk + 8 * r);
  int v[8];
  for (int c = 0; c < 8; c++) {
    idct_col(blk, c, v);
    for (int r = 0; r < 8; r++) {
      uint8_t* d = dst + r * stride + c;
      *d = clip_u8(add ? *d + v[r] : v[r]);
    }
  }
}

// --- FFmpeg xvididct.c / x86/xvididct.asm: the Xvid IDCT ---------------------

// FFmpeg's C version, which its comment says is made to give the SSE2
// version's results, with the SSE2 version's 16-bit saturation (cv2 on x86
// runs the SSE2 one; the C version wraps where a row's sum leaves 16 bits,
// measured different from cv2 on such blocks, equal everywhere else): rows
// scaled by their cosine tables and biased by a rounder each (row 0's
// carries the column pass's rounding), 32-bit sums saturated to 16 bits
// (packssdw); columns in the tangent form, 16-bit products (pmulhw) and
// saturating sums (paddsw / psubsw).
namespace xvid {

const int kTab04[7] = {22725, 21407, 19266, 16384, 12873, 8867, 4520};
const int kTab17[7] = {31521, 29692, 26722, 22725, 17855, 12299, 6270};
const int kTab26[7] = {29692, 27969, 25172, 21407, 16819, 11585, 5906};
const int kTab35[7] = {26722, 25172, 22654, 19266, 15137, 10426, 5315};
const int* const kRowTab[8] = {kTab04, kTab17, kTab26, kTab35,
                               kTab04, kTab35, kTab26, kTab17};
const int kRowRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
constexpr unsigned kTan1 = 0x32EC, kTan2 = 0x6A0A, kTan3 = 0xAB0E, kSqrt2 = 0x5A82;

inline int s16(int v) { return std::min(std::max(v, -32768), 32767); }

void row(int16_t* in, const int* tab, int rnd) {
  const int c1 = tab[0], c2 = tab[1], c3 = tab[2], c4 = tab[3], c5 = tab[4],
            c6 = tab[5], c7 = tab[6];
  const int k = c4 * in[0] + rnd;
  const int a0 = k + c2 * in[2] + c4 * in[4] + c6 * in[6];
  const int a1 = k + c6 * in[2] - c4 * in[4] - c2 * in[6];
  const int a2 = k - c6 * in[2] - c4 * in[4] + c2 * in[6];
  const int a3 = k - c2 * in[2] + c4 * in[4] - c6 * in[6];
  const int b0 = c1 * in[1] + c3 * in[3] + c5 * in[5] + c7 * in[7];
  const int b1 = c3 * in[1] - c7 * in[3] - c1 * in[5] - c5 * in[7];
  const int b2 = c5 * in[1] - c1 * in[3] + c7 * in[5] + c3 * in[7];
  const int b3 = c7 * in[1] - c5 * in[3] + c3 * in[5] - c1 * in[7];
  // 16-bit inputs: every sum fits 32 bits, as pmaddwd's do
  in[0] = (int16_t)s16((a0 + b0) >> 11);
  in[1] = (int16_t)s16((a1 + b1) >> 11);
  in[2] = (int16_t)s16((a2 + b2) >> 11);
  in[3] = (int16_t)s16((a3 + b3) >> 11);
  in[4] = (int16_t)s16((a3 - b3) >> 11);
  in[5] = (int16_t)s16((a2 - b2) >> 11);
  in[6] = (int16_t)s16((a1 - b1) >> 11);
  in[7] = (int16_t)s16((a0 - b0) >> 11);
}

// (c * x) >> 16 of a 16-bit x (tan3 > 1/2: pmulhw by tan3 - 1, plus x)
inline int mult(unsigned c, int x) { return (int)(c * (unsigned)x) >> 16; }

// idct_col_8 (its 4- and 3-row forms give the same values on their rows)
void col(int16_t* in) {
  int mm4 = in[56], mm5 = in[40], mm6 = in[24], mm7 = in[8];
  int mm0 = s16(mult(kTan1, mm4) + mm7);
  int mm1 = s16(mult(kTan1, mm7) - mm4);
  int mm2 = s16(mult(kTan3, mm5) + mm6);
  int mm3 = s16(mult(kTan3, mm6) - mm5);
  mm7 = s16(mm0 + mm2);
  mm4 = s16(mm1 - mm3);
  mm0 = s16(mm0 - mm2);
  mm1 = s16(mm1 + mm3);
  mm6 = s16(mm0 + mm1);
  mm5 = s16(mm0 - mm1);
  mm5 = s16(2 * mult(kSqrt2, mm5));
  mm6 = s16(2 * mult(kSqrt2, mm6));
  mm1 = in[16];
  mm2 = in[48];
  mm3 = s16(mult(kTan2, mm2) + mm1);
  mm2 = s16(mult(kTan2, mm1) - mm2);
  mm0 = s16(in[0] + in[32]);
  mm1 = s16(in[0] - in[32]);
  int t = s16(mm0 + mm3);
  mm3 = s16(mm0 - mm3);
  mm0 = t;
  t = s16(mm0 + mm7);
  mm7 = s16(mm0 - mm7);
  in[0] = (int16_t)(t >> 6);
  in[56] = (int16_t)(mm7 >> 6);
  t = s16(mm3 + mm4);
  mm4 = s16(mm3 - mm4);
  in[24] = (int16_t)(t >> 6);
  in[32] = (int16_t)(mm4 >> 6);
  t = s16(mm1 + mm2);
  mm2 = s16(mm1 - mm2);
  mm1 = t;
  t = s16(mm1 + mm6);
  mm6 = s16(mm1 - mm6);
  in[8] = (int16_t)(t >> 6);
  in[48] = (int16_t)(mm6 >> 6);
  t = s16(mm2 + mm5);
  mm5 = s16(mm2 - mm5);
  in[16] = (int16_t)(t >> 6);
  in[40] = (int16_t)(mm5 >> 6);
}

}  // namespace xvid

// blk (natural order, modified in place) -> dst; add: dst + residual
void xvid_idct(int16_t* blk, uint8_t* dst, int stride, bool add) {
  for (int r = 0; r < 8; r++) xvid::row(blk + 8 * r, xvid::kRowTab[r], xvid::kRowRnd[r]);
  for (int c = 0; c < 8; c++) xvid::col(blk + c);
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++) {
      uint8_t* d = dst + r * stride + c;
      *d = clip_u8(add ? *d + blk[8 * r + c] : blk[8 * r + c]);
    }
}

// --- swscale's unscaled YUV -> RGB (yuv2rgb, x86 SIMD form) -----------------

// The fixed-point coefficients of ff_yuv2rgb_c_init_tables for the frame's
// matrix (OpenCV hands swscale the decoder's colorspace; BT.601 when it is
// unspecified) at the default contrast, saturation and brightness, scaled
// to the 13 fractional bits the SIMD code multiplies by.
struct YuvCoeffs {
  int y_coeff, y_offset, vr, ub, ug, vg;
};

// ff_yuv2rgb_coeffs (crv, cbu, cgu, cgv in 16.16) by matrix_coefficients /
// AVColorSpace: BT.709 (1), FCC (4), SMPTE 240M (7), BT.2020 (9, 10), and
// BT.601 for every other value
void matrix_coeffs(int matrix, int64_t* c) {
  static const int64_t k[5][4] = {{104597, 132201, 25675, 53279},
                                  {117489, 138438, 13975, 34925},
                                  {104448, 132798, 24759, 53109},
                                  {117579, 136230, 16907, 35559},
                                  {110013, 140363, 12277, 42626}};
  int i = matrix == 1 ? 1 : matrix == 4 ? 2 : matrix == 7 ? 3
          : (matrix == 9 || matrix == 10) ? 4 : 0;
  for (int j = 0; j < 4; j++) c[j] = k[i][j];
}

YuvCoeffs yuv_coeffs(bool full_range, int matrix) {
  int64_t m[4];
  matrix_coeffs(matrix, m);
  int64_t crv = m[0], cbu = m[1], cgu = -m[2], cgv = -m[3];
  int64_t cy = 1 << 16, oy = 0;
  if (!full_range) {
    cy = (cy * 255) / 219;
    oy = 16 << 16;
  } else {
    crv = (crv * 224) / 255;
    cbu = (cbu * 224) / 255;
    cgu = (cgu * 224) / 255;
    cgv = (cgv * 224) / 255;
  }
  auto round16 = [](int64_t f) {  // roundToInt16
    int64_t r = (f + (1 << 15)) >> 16;
    return (int)std::min<int64_t>(std::max<int64_t>(r, -0x8000), 0x7FFF);
  };
  YuvCoeffs k;
  k.y_coeff = round16(cy * 8192);
  k.y_offset = round16(oy * 8);
  k.vr = round16(crv * 8192);
  k.ub = round16(cbu * 8192);
  k.ug = round16(cgu * 8192);
  k.vg = round16(cgv * 8192);
  return k;
}

inline int16_t sat16(int v) {
  return (int16_t)std::min(std::max(v, -32768), 32767);
}
inline int mulhi(int a, int b) { return (int)(((int32_t)(int16_t)a * b) >> 16); }

// the converter's terms by sample value, one set per range
struct YuvTables {
  int16_t y[256], ub[256], vr[256], ug[256], vg[256];
  YuvTables(bool full_range, int matrix) {
    const YuvCoeffs k = yuv_coeffs(full_range, matrix);
    for (int i = 0; i < 256; i++) {
      y[i] = (int16_t)mulhi(sat16(i * 8 - k.y_offset), k.y_coeff);
      ub[i] = (int16_t)mulhi(sat16(i * 8 - 1024), k.ub);
      vr[i] = (int16_t)mulhi(sat16(i * 8 - 1024), k.vr);
      ug[i] = (int16_t)mulhi(sat16(i * 8 - 1024), k.ug);
      vg[i] = (int16_t)mulhi(sat16(i * 8 - 1024), k.vg);
    }
  }
};

inline void put_rgb(const YuvTables& t, int yv, int ro, int go, int bo,
                    uint8_t* o) {
  const int yy = t.y[yv];
  o[0] = clip_u8(sat16(yy + ro));
  o[1] = clip_u8(sat16(yy + go));
  o[2] = clip_u8(sat16(yy + bo));
}

// Each chroma sample's three terms once, then its (up to) 2 x 2 luma
// samples: each channel the saturated sum of a luma and a chroma term.
void yuv_to_rgb(const uint8_t* y, int ys, const uint8_t* cb, const uint8_t* cr,
                int cs, int w, int h, bool full_range, int matrix, uint8_t* out) {
  const YuvTables t(full_range, matrix);
  for (int r = 0; r < h; r += 2) {
    const uint8_t* br = cb + (size_t)(r >> 1) * cs;
    const uint8_t* rr = cr + (size_t)(r >> 1) * cs;
    const uint8_t* y0 = y + (size_t)r * ys;
    const uint8_t* y1 = r + 1 < h ? y0 + ys : nullptr;
    uint8_t* o0 = out + (size_t)r * w * 3;
    uint8_t* o1 = o0 + (size_t)w * 3;
    for (int c = 0; c < w; c += 2) {
      const int u = br[c >> 1], v = rr[c >> 1];
      const int ro = t.vr[v], go = sat16(t.ug[u] + t.vg[v]), bo = t.ub[u];
      const bool two = c + 1 < w;
      put_rgb(t, y0[c], ro, go, bo, o0 + 3 * c);
      if (two) put_rgb(t, y0[c + 1], ro, go, bo, o0 + 3 * c + 3);
      if (y1) {
        put_rgb(t, y1[c], ro, go, bo, o1 + 3 * c);
        if (two) put_rgb(t, y1[c + 1], ro, go, bo, o1 + 3 * c + 3);
      }
    }
  }
}

// --- a frame of 4:2:0 planes -----------------------------------------------

struct Frame {
  int w = 0, h = 0;    // display size
  int pw = 0, ph = 0;  // allocated luma size (whole macroblocks)
  std::vector<uint8_t> y, cb, cr;
  void alloc(int width, int height, int mb = 16) {
    w = width;
    h = height;
    pw = (w + mb - 1) / mb * mb;
    ph = (h + mb - 1) / mb * mb;
    y.assign((size_t)pw * ph, 0);
    cb.assign((size_t)(pw / 2) * (ph / 2), 128);
    cr.assign((size_t)(pw / 2) * (ph / 2), 128);
  }
  int cstride() const { return pw / 2; }
};

// What the H.264, VP9 and HEVC decoders share: samples in, frames out in
// output order, each with its sample's tag and its colour.
struct FrameDecoder {
  int64_t out_tag = -1;  // the tag of the sample the last frame came from
  bool have_frame = false, full_range = false;
  int matrix = 2;  // the last frame's matrix_coefficients (2: unspecified)
  virtual ~FrameDecoder() = default;
  // decodes one sample tagged `tag`; true when it puts out a frame
  virtual bool decode(const uint8_t* p, int64_t n, int64_t tag) = 0;
  // at the end of the stream: true when a waiting frame is put out
  virtual bool flush() { return false; }
  // the last frame put out, or null
  virtual const Frame* frame() const = 0;
};

#include "h264_decode.cpp"
#include "vp9_decode.cpp"
#include "hevc_decode.cpp"

// --- MPEG-4 Part 2 ---------------------------------------------------------

// MSB-first bit reader; reading past the end is an error
struct Bits {
  const uint8_t* p;
  int64_t nbits, pos = 0;
  Bits(const uint8_t* d, int64_t n) : p(d), nbits(n * 8) {}
  uint32_t peek(int n) const {  // n <= 32; bits past the end read as 0
    uint64_t v = 0;
    int64_t byte = pos >> 3;
    for (int i = 0; i < 5; i++) {
      v <<= 8;
      if ((byte + i) * 8 < nbits) v |= p[byte + i];
    }
    v <<= 24;  // 40 bits at the top of 64
    return (uint32_t)((v << (pos & 7)) >> (64 - n));
  }
  void skip(int n) {
    pos += n;
    if (pos > nbits) throw Error("MPEG-4 frame data ends early");
  }
  uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  int get1() { return (int)get(1); }
  int sget(int n) {  // n-bit two's complement
    int v = (int)get(n);
    return v >= (1 << (n - 1)) ? v - (1 << n) : v;
  }
  void marker(const char* what) {
    if (!get1()) throw Error(std::string("MPEG-4: missing marker bit (") + what + ")");
  }
  int64_t left() const { return nbits - pos; }
};

// A prefix code read by looking up the next `maxlen` bits: sym[i] is the
// symbol of the prefix i, len[i] its code length (0: no code)
struct Vlc {
  int maxlen = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  void build(int ml, const uint16_t (*codes)[2], int n,
             const int16_t* syms = nullptr) {
    maxlen = ml;
    sym.assign((size_t)1 << ml, -1);
    len.assign((size_t)1 << ml, 0);
    for (int i = 0; i < n; i++) {
      int c = codes[i][0], l = codes[i][1];
      if (l == 0) continue;
      int base = c << (ml - l);
      for (int k = 0; k < (1 << (ml - l)); k++) {
        sym[base + k] = (int16_t)(syms ? syms[i] : i);
        len[base + k] = (uint8_t)l;
      }
    }
  }
  int read(Bits& b, const char* what) const {
    uint32_t i = b.peek(maxlen);
    if (!len[i]) throw Error(std::string("MPEG-4: invalid ") + what + " code");
    b.skip(len[i]);
    return sym[i];
  }
};

// ff_h263_intra_MCBPC (index: bit 2 set for IntraQ, 8 = stuffing)
const uint16_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                    {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// ff_h263_inter_MCBPC (index bits: 3:0 cbpc, 4 intra, 8 dquant, 16 4MV;
// 20 = stuffing; 24..27, H.263's Inter4V+Q, do not occur in MPEG-4)
const uint16_t kInterMcbpc[21][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7},
    {3, 3}, {7, 7}, {6, 7}, {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9},
    {2, 3}, {5, 7}, {4, 7}, {5, 8}, {1, 9}};
const uint16_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                               {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                               {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// ff_mvtab: |motion_code| 0..32, then a sign bit when nonzero
const uint16_t kMvtab[33][2] = {
    {1, 1},  {1, 2},  {1, 3},  {1, 4},  {3, 6},  {5, 7},  {4, 7},
    {3, 7},  {11, 9}, {10, 9}, {9, 9},  {17, 10}, {16, 10}, {15, 10},
    {14, 10}, {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10}, {8, 10},
    {7, 10}, {6, 10}, {5, 10}, {4, 10}, {7, 11}, {6, 11}, {5, 11},
    {4, 11}, {3, 11}, {2, 11}, {3, 12}, {2, 12}};
// ff_mpeg4_DCtab_lum / _chrom: dct_dc_size 0..12
const uint16_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},
                                {1, 4}, {1, 5}, {1, 6}, {1, 7}, {1, 8},
                                {1, 9}, {1, 10}, {1, 11}};
const uint16_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},
                                  {1, 5}, {1, 6}, {1, 7}, {1, 8}, {1, 9},
                                  {1, 10}, {1, 11}, {1, 12}};

// TCOEF tables: code, run, level; the first `last` entries have last = 0,
// and index 102 is the escape (0000011)
struct RlTable {
  uint16_t vlc[103][2];
  int8_t run[102], level[102];
  int last;
};

// ff_h263_rl_inter (ISO/IEC 14496-2 Table B-17)
const RlTable kRlInter = {
    {{0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},
     {0x24, 9},  {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11},
     {0x6, 3},   {0x14, 6},  {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12},
     {0xe, 4},   {0x1d, 8},  {0xe, 10},  {0x51, 12}, {0xd, 5},   {0x23, 9},
     {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12}, {0xb, 5},   {0xc, 10},
     {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},  {0xa, 10},
     {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
     {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},
     {0x1f, 9},  {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},
     {0x22, 11}, {0x23, 11}, {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},
     {0x5, 11},  {0xf, 6},   {0x4, 11},  {0xe, 6},   {0xd, 6},   {0xc, 6},
     {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},  {0x1a, 8},  {0x19, 8},
     {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},  {0x13, 8},
     {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
     {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},
     {0x24, 11}, {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12},
     {0x5a, 12}, {0x5b, 12}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12},
     {0x3, 7}},
    {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,
     1,  2,  2,  2,  2,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6,  6,  6,
     7,  7,  8,  8,  9,  9,  10, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
     20, 21, 22, 23, 24, 25, 26, 0,  0,  0,  1,  1,  2,  3,  4,  5,  6,
     7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
     24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40},
    {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3,
     4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    58};

// ff_mpeg4_rl_intra (Table B-16)
const RlTable kRlIntra = {
    {{0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},
     {0x13, 6},  {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},
     {0x25, 9},  {0x24, 9},  {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10},
     {0xf, 10},  {0xe, 10},  {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x21, 11},
     {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},   {0x14, 6},  {0x16, 7},
     {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11}, {0x53, 12},
     {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
     {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},
     {0xa, 10},  {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},
     {0x54, 12}, {0x14, 7},  {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},
     {0x18, 8},  {0x23, 11}, {0x17, 8},  {0x19, 9},  {0x18, 9},  {0x7, 10},
     {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},  {0x17, 9},  {0x6, 10},
     {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},  {0x5, 10},
     {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
     {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},
     {0x1a, 8},  {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},
     {0x26, 11}, {0x27, 11}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12},
     {0x3, 7}},
    {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
     0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  1,
     1,  1,  1,  2,  2,  2,  2,  2,  3,  3,  3,  3,  4,  4,  4,  5,  5,
     5,  6,  6,  6,  7,  7,  7,  8,  8,  9,  9,  10, 11, 12, 13, 14, 0,
     0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  2,  2,  3,  3,  4,  4,  5,
     5,  6,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20},
    {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
     21, 22, 23, 24, 25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3,
     4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2,
     1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2,
     1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1},
    67};

// a TCOEF table ready to read: the VLC and the escape modes' LMAX / RMAX
struct Rl {
  const RlTable* t;
  Vlc vlc;
  int max_level[2][64], max_run[2][64];
  explicit Rl(const RlTable& tab) : t(&tab) {
    vlc.build(12, tab.vlc, 103);
    std::memset(max_level, 0, sizeof(max_level));
    std::memset(max_run, 0, sizeof(max_run));
    for (int i = 0; i < 102; i++) {
      int last = i >= tab.last, r = tab.run[i], l = tab.level[i];
      max_level[last][r] = std::max(max_level[last][r], l);
      max_run[last][l] = std::max(max_run[last][l], r);
    }
  }
};

const int kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18,
                         11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20,
                         13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
                         36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
                         38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const int kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const int kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
// ff_mpeg4_default_intra_matrix / _non_intra_matrix (natural order)
const uint8_t kDefIntraMatrix[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
    20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
    22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefInterMatrix[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
    18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
    20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};
// ff_mpeg4_y_dc_scale_table / c_dc_scale_table by QP
const uint8_t kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18,
                               19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                               30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11,
                               12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17,
                               17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kDquant[4] = {-1, -2, 1, 2};

struct Tables {
  Vlc intra_mcbpc, inter_mcbpc, cbpy, mv, dc_lum, dc_chrom;
  Rl inter{kRlInter}, intra{kRlIntra};
  Tables() {
    intra_mcbpc.build(9, kIntraMcbpc, 9);
    inter_mcbpc.build(9, kInterMcbpc, 21);
    cbpy.build(6, kCbpy, 16);
    mv.build(12, kMvtab, 33);
    dc_lum.build(11, kDcLum, 13);
    dc_chrom.build(12, kDcChrom, 13);
  }
};
const Tables& tables() {
  static const Tables t;
  return t;
}

inline int rounded_div(int a, int b) {
  return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b;
}
inline int mid3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// FFmpeg's workaround_bugs flags (FF_BUG_*) that ff_mpeg4_workaround_bugs
// sets from the encoder's build and the container's codec tag
enum : unsigned {
  kBugEdge = 1u << 0,             // edges at the display size
  kBugDcClip = 1u << 1,           // DC predictors not clipped at 2047
  kBugHpelChroma = 1u << 2,       // set for DivX; cv2's FFmpeg reads no other vector
  kBugDirectBlocksize = 1u << 3,  // quarter-pel direct blocks (no effect here)
  kBugQpelChroma = 1u << 4,       // quarter-pel chroma (no effect here)
  kBugQpelChroma2 = 1u << 5,
  kBugStdQpel = 1u << 6,          // old quarter-pel filters (no effect here)
  kBugIedge = 1u << 7,            // field MC's edge buffer (no effect here)
  kBugXvidIlace = 1u << 8,        // interlaced only (no effect here)
  kBugUmp4 = 1u << 9,
};

constexpr uint32_t fourcc(const char* s) {
  return (uint32_t)(uint8_t)s[0] | (uint32_t)(uint8_t)s[1] << 8 |
         (uint32_t)(uint8_t)s[2] << 16 | (uint32_t)(uint8_t)s[3] << 24;
}

// A decoded VOP and what later VOPs read of it: the P-VOP's vectors per
// luma block, its 4MV and not-coded macroblocks (B-VOPs' direct mode and
// skips), and the tag of the sample it was decoded from.
struct M4Pic {
  Frame f;
  std::vector<int16_t> mv;     // per luma block (2 mbw x 2 mbh): x, y
  std::vector<uint8_t> four;   // per macroblock
  std::vector<uint8_t> skip;   // per macroblock
  int64_t tag = -1;
};

// ff_mb_type_b_tab: direct '1', interpolate '01', backward '001', forward '0001'
const uint16_t kMbTypeB[4][2] = {{1, 1}, {1, 2}, {1, 3}, {1, 4}};

struct Mpeg4 {
  // what FFmpeg learns of the encoder: its build from user data and the
  // container's codec tag (upper case, as ff_toupper4 leaves it)
  uint32_t codec_tag = 0;
  int xvid_build = -1, divx_version = -1, divx_build = -1, lavc_build = -1;
  bool divx_packed = false, use_xvid_idct = false, edge_bug = false;
  unsigned bugs = 0;
  // VOL
  bool have_vol = false, low_delay = false, vol_control = false;
  int vo_type = 0, width = 0, height = 0, time_inc_bits = 1, time_res = 1;
  bool mpeg_quant = false;
  int intra_matrix[64], inter_matrix[64];
  int mbw = 0, mbh = 0;
  // VOP times as FFmpeg keeps them (pp_time and pb_time are 16-bit there)
  int64_t time_base = 0, last_time_base = 0, time = 0, last_non_b_time = 0;
  uint16_t pp_time = 0, pb_time = 0;
  int picture_number = 0;
  // VOP
  int type = 0, qscale = 1, fcode = 1, bcode = 1, rounding = 0;
  int intra_dc_threshold = 99;
  bool ac_pred = false;
  int16_t direct_scale[2][64];
  // macroblock state of the current VOP
  std::vector<uint8_t> mb_intra, mb_q;
  std::vector<int16_t> dc;     // per block: (2 mbw) x (2 mbh) luma, then 2 x mbw x mbh
  std::vector<int16_t> ac;     // 16 per block: [1..7] left column, [9..15] top row
  int last_mv[2][2];           // B-VOP vector predictors, forward and backward
  // pictures as FFmpeg's mpegvideo keeps them: the two references (last,
  // next) and the VOP being decoded; `out` is the frame put out
  std::shared_ptr<M4Pic> last, next, cur, out;
  bool skipped_last = false;   // the last sample was a not-coded VOP
  std::vector<uint8_t> held;   // packed bitstreams: the VOPs a sample left over

  Mpeg4() {
    for (int i = 0; i < 64; i++) {
      intra_matrix[i] = kDefIntraMatrix[i];
      inter_matrix[i] = kDefInterMatrix[i];
    }
  }

  static void refuse(const std::string& what) {
    throw Error("MPEG-4 Part 2 " + what + " not supported");
  }

  // ff_mpeg_flush (a seek): the pictures and the held VOPs go; the VOL,
  // the encoder's build, the workarounds and the VOP clock stay
  void reset() {
    last.reset();
    next.reset();
    cur.reset();
    out.reset();
    held.clear();
    pp_time = 0;
    skipped_last = false;
  }

  // --- headers ---------------------------------------------------------------

  void load_matrix(Bits& b, int* m) {
    int last_v = 0, i = 0;
    for (; i < 64; i++) {
      int v = (int)b.get(8);
      if (v == 0) break;
      last_v = v;
      m[kZigzag[i]] = v;
    }
    for (; i < 64; i++) m[kZigzag[i]] = last_v;  // FFmpeg replicates the last (0 if none)
  }

  void parse_vol(Bits& b) {
    b.skip(1);  // random_accessible_vol
    vo_type = (int)b.get(8);
    if (vo_type == 0x12) refuse("fine granularity scalable VOLs are");
    int verid = 1;
    if (b.get1()) {  // is_object_layer_identifier
      verid = (int)b.get(4);
      b.skip(3);
    }
    if (b.get(4) == 15) b.skip(16);  // aspect_ratio_info, extended PAR
    vol_control = b.get1();
    if (vol_control) {
      int chroma = (int)b.get(2);
      if (chroma != 1) refuse("chroma formats other than 4:2:0 are");
      low_delay = b.get1();
      if (b.get1()) {  // vbv_parameters
        b.skip(15); b.marker("vbv"); b.skip(15); b.marker("vbv");
        b.skip(15); b.marker("vbv"); b.skip(3); b.skip(11); b.marker("vbv");
        b.skip(15); b.marker("vbv");
      }
    } else if (picture_number == 0) {
      // FFmpeg: simple and advanced simple VOLs without the flag are low delay
      low_delay = vo_type == 1 || vo_type == 17;
    }
    int shape = (int)b.get(2);
    if (shape != 0) refuse("non-rectangular (shape-coded) VOLs are");
    b.marker("VOL");
    int res = (int)b.get(16);
    if (res == 0) throw Error("MPEG-4: VOL time increment resolution 0");
    time_res = res;
    int bits = 0;
    while ((1 << bits) < res) bits++;  // av_log2(res - 1) + 1
    time_inc_bits = std::max(bits, 1);
    b.marker("VOL");
    if (b.get1()) b.skip(time_inc_bits);  // fixed_vop_rate
    b.marker("VOL");
    const int w = (int)b.get(13);
    b.marker("VOL");
    const int h = (int)b.get(13);
    b.marker("VOL");
    if (w <= 0 || h <= 0) throw Error("MPEG-4: VOL of size 0");
    if (have_vol && (w != width || h != height)) refuse("a size change (a VOL of another size) is");
    width = w;
    height = h;
    if (b.get1()) refuse("interlaced video is");
    b.skip(1);  // obmc_disable
    int sprite = (int)b.get(verid == 1 ? 1 : 2);
    if (sprite) refuse("GMC and sprites (S-VOPs) are");
    if (b.get1()) refuse("not-8-bit video is");
    mpeg_quant = b.get1();
    if (mpeg_quant) {
      for (int i = 0; i < 64; i++) {
        intra_matrix[i] = kDefIntraMatrix[i];
        inter_matrix[i] = kDefInterMatrix[i];
      }
      if (b.get1()) load_matrix(b, intra_matrix);
      if (b.get1()) load_matrix(b, inter_matrix);
    }
    if (verid != 1 && b.get1()) refuse("quarter-pel motion (quarter_sample) is");
    if (!b.get1()) refuse("a complexity estimation header is");
    if (!b.get1()) refuse("resync markers are");
    if (b.get1()) refuse("data partitioning (and RVLC) is");
    if (verid != 1) {
      if (b.get1()) refuse("NEWPRED is");
      if (b.get1()) refuse("reduced-resolution VOPs are");
    }
    if (b.get1()) refuse("scalability is");
    mbw = (width + 15) / 16;
    mbh = (height + 15) / 16;
    have_vol = true;
  }

  // decode_user_data: the encoder's build, as FFmpeg reads it with sscanf
  void user_data(const uint8_t* p, int64_t n) {
    char buf[256];
    int i = 0;
    for (; i < 255 && i < n; i++) {
      // up to the next 23 zero bits (a start code); bytes past the end are 0
      const int b1 = i + 1 < n ? p[i + 1] : 0, b2 = i + 2 < n ? p[i + 2] : 0;
      if (p[i] == 0 && b1 == 0 && (b2 & 0xFE) == 0) break;
      buf[i] = (char)p[i];
    }
    buf[i] = 0;
    int ver = 0, build = 0, ver2 = 0, ver3 = 0;
    char last_c = 0;
    int e = std::sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &last_c);
    if (e < 2) e = std::sscanf(buf, "DivX%db%d%c", &ver, &build, &last_c);
    if (e >= 2) {
      divx_version = ver;
      divx_build = build;
      divx_packed = e == 3 && last_c == 'p';
    }
    e = std::sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4)
      e = std::sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2,
                      &ver3, &build);
    if (e != 4) {
      e = std::sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
      if (e > 1)
        build = ((ver & 0xFF) << 16) + ((ver2 & 0xFF) << 8) + (ver3 & 0xFF);
    }
    if (e != 4 && std::strcmp(buf, "ffmpeg") == 0) lavc_build = 4600;
    if (e == 4) lavc_build = build;
    if (std::sscanf(buf, "XviD%d", &build) == 1) xvid_build = build;
  }

  // mpeg4_decode_gop_header: the GOV's time code sets the time base
  void gov(const uint8_t* p, int64_t n) {
    Bits b(p, n);
    if (!b.peek(23) || b.left() < 18) return;  // FFmpeg: "GOP header invalid"
    int hours = (int)b.get(5), minutes = (int)b.get(6);
    b.skip(1);  // marker (FFmpeg only logs it)
    int seconds = (int)b.get(6);
    time_base = seconds + 60 * (minutes + 60 * hours);
  }

  // ff_mpeg4_workaround_bugs (with FF_BUG_AUTODETECT, FFmpeg's default)
  void workarounds() {
    if (xvid_build == -1 && divx_version == -1 && lavc_build == -1 &&
        (codec_tag == fourcc("XVID") || codec_tag == fourcc("XVIX") ||
         codec_tag == fourcc("RMP4") || codec_tag == fourcc("ZMP4") ||
         codec_tag == fourcc("SIPP")))
      xvid_build = 0;
    if (xvid_build == -1 && divx_version == -1 && lavc_build == -1 &&
        codec_tag == fourcc("DIVX") && vo_type == 0 && !vol_control)
      divx_version = 400;
    if (xvid_build >= 0 && divx_version >= 0) divx_version = divx_build = -1;
    if (codec_tag == fourcc("XVIX")) bugs |= kBugXvidIlace;
    if (codec_tag == fourcc("UMP4")) bugs |= kBugUmp4;
    if (divx_version >= 500 && divx_build < 1814) bugs |= kBugQpelChroma;
    if (divx_version > 502 && divx_build < 1814) bugs |= kBugQpelChroma2;
    if ((unsigned)xvid_build <= 1u) bugs |= kBugQpelChroma;
    if ((unsigned)xvid_build <= 12u) bugs |= kBugEdge;
    if ((unsigned)xvid_build <= 32u) bugs |= kBugDcClip;
    if ((unsigned)lavc_build < 4653u) bugs |= kBugStdQpel;
    if ((unsigned)lavc_build < 4655u) bugs |= kBugDirectBlocksize;
    if ((unsigned)lavc_build < 4670u) bugs |= kBugEdge;
    if ((unsigned)lavc_build <= 4712u) bugs |= kBugDcClip;
    if ((lavc_build & 0xFF) >= 100 && lavc_build > 3621476 && lavc_build < 3752552 &&
        (lavc_build < 3752037 || lavc_build > 3752191))
      bugs |= kBugIedge;
    if (divx_version >= 0) bugs |= kBugDirectBlocksize;
    if ((unsigned)divx_version < 500u) bugs |= kBugEdge;
    if (divx_version >= 0) bugs |= kBugHpelChroma;
    if (xvid_build >= 0 && !use_xvid_idct) {
      // FFmpeg switches to the Xvid IDCT and decodes the sample again, its
      // VOP header now under the new workarounds
      use_xvid_idct = true;
      if (bugs & kBugEdge) edge_bug = true;
    }
  }

  // the start codes of a buffer up to its VOP: VOS/VO/VOL/GOV/user data
  // set up the stream. Returns the VOP's offset (past its start code), or
  // -1 when the buffer holds none.
  int64_t headers(const uint8_t* d, int64_t n) {
    if (n >= 3 && d[0] == 0 && d[1] == 0 && (d[2] & 0xFC) == 0x80)
      refuse("short video header (H.263 baseline) is");
    int64_t i = 0;
    bool vol = false;
    while (true) {
      while (i + 3 < n && !(d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1)) i++;
      if (i + 3 >= n) return -1;
      int code = d[i + 3];
      const uint8_t* body = d + i + 4;
      int64_t m = n - i - 4;
      if (code >= 0x20 && code <= 0x2F) {
        if (!vol) {  // FFmpeg ignores a second VOL in one buffer
          Bits b(body, m);
          parse_vol(b);
        }
        vol = true;
      } else if (code == 0xB2) {
        user_data(body, m);
      } else if (code == 0xB3) {
        gov(body, m);
      } else if (code == 0xB6) {
        return i + 4;
      }
      i += 4;
    }
  }

  // decode_vop_header; false for a VOP FFmpeg puts out nothing for (not
  // coded, or a B-VOP whose times do not lie between its references')
  bool vop_header(Bits& b) {
    type = (int)b.get(2);
    if (type == 3) refuse("S-VOPs (GMC and sprites) are");
    if (type == 2 && low_delay && !vol_control) low_delay = false;
    int incr = 0;
    while (b.get1()) incr++;  // modulo_time_base
    b.marker("VOP");
    const int inc = (int)b.get(time_inc_bits);
    b.marker("VOP");
    if (type != 2) {
      last_time_base = time_base;
      time_base += incr;
      time = time_base * (int64_t)time_res + inc;
      pp_time = (uint16_t)(time - last_non_b_time);
      last_non_b_time = time;
    } else {
      time = (last_time_base + incr) * (int64_t)time_res + inc;
      pb_time = (uint16_t)(pp_time - (last_non_b_time - time));
      const int pp = pp_time, pb = pb_time;
      if (pp <= pb || pp <= pp - pb || pp <= 0) return false;
      for (int i = 0; i < 64; i++) {  // ff_mpeg4_init_direct_mv
        direct_scale[0][i] = (int16_t)((i - 32) * pb / pp);
        direct_scale[1][i] = (int16_t)((i - 32) * (pb - pp) / pp);
      }
    }
    if (!b.get1()) {  // vop_coded 0
      skipped_last = true;
      return false;
    }
    rounding = type == 1 ? b.get1() : 0;
    intra_dc_threshold = kDcThreshold[b.get(3)];
    qscale = (int)b.get(5);
    if (qscale == 0) throw Error("MPEG-4: VOP quantiser 0");
    fcode = bcode = 1;
    if (type != 0) {
      fcode = (int)b.get(3);
      if (fcode == 0) throw Error("MPEG-4: VOP fcode 0");
    }
    if (type == 2) {
      bcode = (int)b.get(3);
      if (bcode == 0) throw Error("MPEG-4: VOP fcode_backward 0");
    }
    if (vo_type == 0 && !vol_control && divx_version == -1 && picture_number == 0)
      low_delay = true;  // "divx4/(old)xvid/opendivx"
    picture_number++;
    if (bugs & kBugEdge) edge_bug = true;
    return true;
  }

  // --- one sample (h263_decode_frame) ---------------------------------------

  // Decodes one sample; true when it puts a frame out (`out`), in FFmpeg's
  // output order: a VOL that is not low delay puts each I-/P-VOP out when
  // the next one is decoded, and a B-VOP at once.
  bool decode(const uint8_t* d, int64_t n, int64_t tag) {
    skipped_last = false;
    // packed bitstreams (DivX's "p", Xvid's packed mode): a sample whose
    // first start code is a VOS drops what the last one left over;
    // otherwise that is decoded in place of the sample (its placeholder)
    if (divx_packed && !held.empty()) {
      for (int64_t i = 0; i + 3 < n; i++)
        if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) {
          if (d[i + 3] == 0xB0) held.clear();
          break;
        }
    }
    std::vector<uint8_t> src;
    const bool from_held = !held.empty() && (divx_packed || n <= 19);
    if (from_held) src.swap(held);
    held.clear();
    const uint8_t* buf = from_held ? src.data() : d;
    const int64_t size = from_held ? (int64_t)src.size() : n;
    const int64_t at = headers(buf, size);
    if (at < 0) {
      if (size == 1 && (divx_version >= 0 || xvid_build >= 0)) return false;  // "divx bug"
      throw Error("MPEG-4 sample without a VOP");
    }
    if (!have_vol) throw Error("MPEG-4 VOP before any VOL header");
    Bits b(buf + at, size - at);
    if (!vop_header(b)) return false;
    workarounds();
    if (type == 2 && !last) return false;  // a B-VOP without two references
    if (type == 1 && !next) throw Error("MPEG-4: a P-VOP before any I-VOP");
    decode_vop(b, tag);
    if (divx_packed) {  // ff_mpeg4_frame_end
      const int64_t pos = from_held ? 0 : at + (b.pos >> 3);
      bool found = false;
      if (n - pos > 7)
        for (int64_t i = pos; i < n - 4; i++)
          if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1 && d[i + 3] == 0xB6) {
            found = !(d[i + 4] & 0x40);  // an I- or B-VOP follows
            break;
          }
      if (found) held.assign(d + pos, d + n);
    }
    if (type == 2 || low_delay) {
      out = cur;
      return true;
    }
    out = last;
    return (bool)last;
  }

  // At the end of the stream: the reference still held back, or (low
  // delay) the last frame again after a not-coded VOP
  bool flush() {
    if (!low_delay && next) {
      out = next;
      next.reset();
      return true;
    }
    if (skipped_last && cur) {
      out = cur;
      cur.reset();
      skipped_last = false;
      return true;
    }
    return false;
  }

  // --- a VOP ------------------------------------------------------------------

  void decode_vop(Bits& b, int64_t tag) {
    cur = std::make_shared<M4Pic>();
    cur->f.alloc(width, height);
    cur->tag = tag;
    cur->mv.assign((size_t)8 * mbw * mbh, 0);
    cur->four.assign((size_t)mbw * mbh, 0);
    cur->skip.assign((size_t)mbw * mbh, 0);
    if (type != 2) {  // ff_mpv_frame_start: the references move on
      last = next;
      next = cur;
    }
    const int nb = 4 * mbw * mbh + 2 * mbw * mbh;
    mb_intra.assign((size_t)mbw * mbh, 0);
    mb_q.assign((size_t)mbw * mbh, 0);
    dc.assign(nb, 1024);
    ac.assign((size_t)nb * 16, 0);
    for (int my = 0; my < mbh; my++)
      for (int mx = 0; mx < mbw; mx++) {
        if (type == 2) decode_b_mb(b, mx, my);
        else decode_mb(b, mx, my);
      }
  }

  // block index of block n (0..5) of macroblock (mx, my); -1 outside
  int blk_index(int n, int bx, int by) const {
    // bx, by in block units of that plane
    if (n < 4) {
      if (bx < 0 || by < 0 || bx >= 2 * mbw || by >= 2 * mbh) return -1;
      if (!mb_intra[(by >> 1) * mbw + (bx >> 1)]) return -1;
      return by * 2 * mbw + bx;
    }
    if (bx < 0 || by < 0 || bx >= mbw || by >= mbh) return -1;
    if (!mb_intra[by * mbw + bx]) return -1;
    return 4 * mbw * mbh + (n - 4) * mbw * mbh + by * mbw + bx;
  }
  void blk_pos(int n, int mx, int my, int* bx, int* by) const {
    if (n < 4) {
      *bx = 2 * mx + (n & 1);
      *by = 2 * my + (n >> 1);
    } else {
      *bx = mx;
      *by = my;
    }
  }
  int mb_of(int n, int bx, int by) const {
    return n < 4 ? (by >> 1) * mbw + (bx >> 1) : by * mbw + bx;
  }

  void set_q(int q) { qscale = std::min(std::max(q, 1), 31); }

  // an I- or P-VOP's macroblock
  void decode_mb(Bits& b, int mx, int my) {
    const Tables& T = tables();
    const int xy = my * mbw + mx;
    int mcbpc;
    bool intra, q4mv = false;
    if (type == 1) {
      while (true) {
        if (b.get1()) {  // not_coded: a copy of the reference
          mb_q[xy] = (uint8_t)qscale;
          cur->skip[xy] = 1;
          mc16(last->f, mx, my, 0, 0, 1 - rounding, false);
          return;
        }
        mcbpc = T.inter_mcbpc.read(b, "MCBPC");
        if (mcbpc != 20) break;
      }
      intra = (mcbpc & 4) != 0;
      q4mv = (mcbpc & 16) != 0;
    } else {
      do mcbpc = T.intra_mcbpc.read(b, "MCBPC");
      while (mcbpc == 8);
      intra = true;
    }
    const bool dquant = type == 1 ? (mcbpc & 8) != 0 : (mcbpc & 4) != 0;
    int16_t blocks[6][64];
    std::memset(blocks, 0, sizeof(blocks));
    if (intra) {
      ac_pred = b.get1();
      int cbpy = T.cbpy.read(b, "CBPY");
      int cbp = (mcbpc & 3) | (cbpy << 2);
      bool dc_vlc = qscale < intra_dc_threshold;
      if (dquant) set_q(qscale + kDquant[b.get(2)]);
      mb_intra[xy] = 1;
      mb_q[xy] = (uint8_t)qscale;
      for (int i = 0; i < 6; i++)
        intra_block(b, blocks[i], i, mx, my, (cbp & (32 >> i)) != 0, dc_vlc);
      for (int i = 0; i < 6; i++) idct_put(blocks[i], i, mx, my, false);
      return;
    }
    int cbpy = T.cbpy.read(b, "CBPY") ^ 15;
    int cbp = (mcbpc & 3) | (cbpy << 2);
    if (dquant) set_q(qscale + kDquant[b.get(2)]);
    mb_q[xy] = (uint8_t)qscale;
    int16_t v[4][2];
    if (!q4mv) {
      int px, py;
      pred_mv(mx, my, 0, &px, &py);
      v[0][0] = (int16_t)read_mv(b, px, fcode);
      v[0][1] = (int16_t)read_mv(b, py, fcode);
      for (int k = 0; k < 4; k++) set_mv(mx, my, k, v[0][0], v[0][1]);
      mc16(last->f, mx, my, v[0][0], v[0][1], 1 - rounding, false);
    } else {
      cur->four[xy] = 1;
      for (int k = 0; k < 4; k++) {
        int px, py;
        pred_mv(mx, my, k, &px, &py);
        v[k][0] = (int16_t)read_mv(b, px, fcode);
        v[k][1] = (int16_t)read_mv(b, py, fcode);
        set_mv(mx, my, k, v[k][0], v[k][1]);
      }
      mc8x8(last->f, mx, my, v, 1 - rounding, false);
    }
    for (int i = 0; i < 6; i++) {
      if (!(cbp & (32 >> i))) continue;
      inter_block(b, blocks[i]);
      idct_put(blocks[i], i, mx, my, true);
    }
  }

  // a B-VOP's macroblock (mpeg4_decode_mb's B branch)
  void decode_b_mb(Bits& b, int mx, int my) {
    static Vlc mb_type_vlc = [] {
      Vlc v;
      v.build(4, kMbTypeB, 4);
      return v;
    }();
    const int xy = my * mbw + mx;
    if (mx == 0) std::memset(last_mv, 0, sizeof(last_mv));
    if (next->skip[xy]) {  // skipped in the future reference: a copy of the past one
      mc16(last->f, mx, my, 0, 0, 1, false);
      return;
    }
    int mb_type = 0, cbp = 0;
    const bool modb1 = b.get1();  // 1: direct, no vectors, no coefficients
    if (!modb1) {
      const int modb2 = b.get1();
      mb_type = mb_type_vlc.read(b, "B macroblock type");
      if (!modb2) cbp = (int)b.get(6);
      if (mb_type != 0 && cbp && b.get1()) set_q(qscale + (int)b.get1() * 4 - 2);
    }
    int16_t mv[2][4][2] = {};
    bool four = false;
    int dirs = 0;  // bit 0 forward, bit 1 backward
    if (mb_type == 0) {
      int dx = 0, dy = 0;
      if (!modb1) {
        dx = read_mv(b, 0, 1);
        dy = read_mv(b, 0, 1);
      }
      four = set_direct_mv(xy, dx, dy, mv);
      dirs = 3;
    } else {
      if (mb_type == 1 || mb_type == 3) {
        dirs |= 1;
        last_mv[0][0] = read_mv(b, last_mv[0][0], fcode);
        last_mv[0][1] = read_mv(b, last_mv[0][1], fcode);
        mv[0][0][0] = (int16_t)last_mv[0][0];
        mv[0][0][1] = (int16_t)last_mv[0][1];
      }
      if (mb_type == 1 || mb_type == 2) {
        dirs |= 2;
        last_mv[1][0] = read_mv(b, last_mv[1][0], bcode);
        last_mv[1][1] = read_mv(b, last_mv[1][1], bcode);
        mv[1][0][0] = (int16_t)last_mv[1][0];
        mv[1][0][1] = (int16_t)last_mv[1][1];
      }
    }
    bool avg = false;
    for (int dir = 0; dir < 2; dir++) {
      if (!(dirs & (1 << dir))) continue;
      const Frame& ref = dir ? next->f : last->f;
      if (four) mc8x8(ref, mx, my, mv[dir], 1, avg);
      else mc16(ref, mx, my, mv[dir][0][0], mv[dir][0][1], 1, avg);
      avg = true;
    }
    int16_t blk[64];
    for (int i = 0; i < 6; i++) {
      if (!(cbp & (32 >> i))) continue;
      std::memset(blk, 0, sizeof(blk));
      inter_block(b, blk);
      idct_put(blk, i, mx, my, true);
    }
  }

  // ff_mpeg4_set_direct_mv: the co-located P macroblock's one or four
  // vectors scaled by TRB / TRD (the table for |v| < 32, else the division
  // on the 16-bit times), plus the delta; true for four vectors
  bool set_direct_mv(int xy, int dx, int dy, int16_t (*mv)[4][2]) {
    const int mx = xy % mbw, my = xy / mbw;
    const bool four = next->four[xy] != 0;
    const int tpp = pp_time, tpb = pb_time;
    for (int i = 0; i < (four ? 4 : 1); i++) {
      const int bx = 2 * mx + (i & 1), by = 2 * my + (i >> 1);
      const size_t k = ((size_t)by * 2 * mbw + bx) * 2;
      for (int c = 0; c < 2; c++) {
        const int p = next->mv[k + c], d = c ? dy : dx;
        int m0, m1;
        if ((unsigned)(p + 32) < 64u) {
          m0 = direct_scale[0][p + 32] + d;
          m1 = d ? m0 - p : direct_scale[1][p + 32];
        } else {
          m0 = p * tpb / tpp + d;
          m1 = d ? m0 - p : p * (tpb - tpp) / tpp;
        }
        mv[0][i][c] = (int16_t)m0;
        mv[1][i][c] = (int16_t)m1;
      }
    }
    return four;
  }

  // motion vectors of the current VOP per luma block (2 mbw x 2 mbh);
  // intra and skipped macroblocks and anything outside the VOP hold 0
  void set_mv(int mx, int my, int k, int x, int y) {
    int bx = 2 * mx + (k & 1), by = 2 * my + (k >> 1);
    size_t i = ((size_t)by * 2 * mbw + bx) * 2;
    cur->mv[i] = (int16_t)x;
    cur->mv[i + 1] = (int16_t)y;
  }
  void mv_at(int bx, int by, int* x, int* y) const {
    if (bx < 0 || by < 0 || bx >= 2 * mbw) {
      *x = *y = 0;
      return;
    }
    size_t i = ((size_t)by * 2 * mbw + bx) * 2;
    *x = cur->mv[i];
    *y = cur->mv[i + 1];
  }

  // ff_h263_pred_motion for a VOP of one slice
  void pred_mv(int mx, int my, int k, int* px, int* py) {
    const int bx = 2 * mx + (k & 1), by = 2 * my + (k >> 1);
    int ax, ay, bx_, by_, cx, cy;
    mv_at(bx - 1, by, &ax, &ay);
    if (my == 0 && k < 2) {  // the first row: the left vector alone
      if (k == 0 && mx == 0) {
        *px = *py = 0;
      } else {
        *px = ax;
        *py = ay;
      }
      return;
    }
    static const int off[4] = {2, 1, 1, -1};
    mv_at(bx, by - 1, &bx_, &by_);
    mv_at(bx + off[k], by - 1, &cx, &cy);
    *px = mid3(ax, bx_, cx);
    *py = mid3(ay, by_, cy);
  }

  // ff_h263_decode_motion
  int read_mv(Bits& b, int pred, int f) {
    int code = tables().mv.read(b, "motion vector");
    if (code == 0) return pred;
    int sign = b.get1();
    int shift = f - 1, val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= (int)b.get(shift);
      val++;
    }
    if (sign) val = -val;
    val += pred;
    const int nb = 5 + f;  // sign_extend(val, 5 + f_code)
    val = (int)((unsigned)val << (32 - nb)) >> (32 - nb);
    return val;
  }

  // ff_h263_round_chroma: the four vectors' sum in sixteenths of a chroma
  // sample, rounded to halves (0-2 down, 3-13 to a half, 14 and 15 up)
  static int round_chroma(int x) {
    static const int tab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
    return tab[x & 0xF] + ((x >> 3) & ~1);
  }

  // --- motion compensation, as mpegvideo_motion.c places its reads --------

  // h_edge_pos / v_edge_pos: the whole macroblocks, or (FF_BUG_EDGE) the
  // display size
  int hep() const { return edge_bug ? width : mbw * 16; }
  int vep() const { return edge_bug ? height : mbh * 16; }

  // A bw x bh area at (x, y) of a plane (pw x ph samples, stride): read
  // straight from the picture (emu false; FFmpeg reads there only inside
  // its edge), or through emulated_edge_mc, every coordinate clamped into
  // [0, ew) x [0, eh)
  static const uint8_t* area(const uint8_t* plane, int stride, int pw, int ph,
                             int x, int y, int bw, int bh, bool emu, int ew,
                             int eh, uint8_t* tmp, int* ts) {
    if (!emu && x >= 0 && y >= 0 && x + bw <= pw && y + bh <= ph) {
      *ts = stride;
      return plane + (size_t)y * stride + x;
    }
    if (!emu) {
      ew = pw;
      eh = ph;
    }
    for (int r = 0; r < bh; r++) {
      const int yy = std::min(std::max(y + r, 0), eh - 1);
      for (int c = 0; c < bw; c++)
        tmp[r * 24 + c] = plane[(size_t)yy * stride + std::min(std::max(x + c, 0), ew - 1)];
    }
    *ts = 24;
    return tmp;
  }

  // hpeldsp as cv2's FFmpeg runs it on x86: put_pixels (rnd 1),
  // put_no_rnd_pixels (rnd 0) or, avg, avg_pixels (the put with rounding,
  // then (dst + p + 1) >> 1). Without AV_CODEC_FLAG_BITEXACT the 8-wide
  // no_rnd half-pel averages in one direction are pavgb(a - 1, b), a - 1
  // saturating at 0 (x2: a is the left sample; y2: the sample of the
  // block's odd row), which is (a + b) >> 1 except where that sample is 0;
  // the 16-wide ones are exact (measured against cv2).
  static void hpel_op(const uint8_t* s, int ss, int dxy, int rnd, int n, bool avg,
                      uint8_t* d, int ds) {
    if (n == 16) rnd |= 2;  // exact: (a + b + (rnd & 1)) >> 1
    auto approx = [](int a, int b) { return (std::max(a - 1, 0) + b + 1) >> 1; };
    for (int r = 0; r < n; r++) {
      const uint8_t* a = s + r * ss;
      const uint8_t* b = a + ss;
      uint8_t* o = d + r * ds;
      for (int c = 0; c < n; c++) {
        int v;
        switch (dxy) {
          case 0: v = a[c]; break;
          case 1: v = rnd ? (a[c] + a[c + 1] + (rnd & 1)) >> 1 : approx(a[c], a[c + 1]); break;
          case 2:
            v = rnd ? (a[c] + b[c] + (rnd & 1)) >> 1
                    : r & 1 ? approx(a[c], b[c]) : approx(b[c], a[c]);
            break;
          default: v = (a[c] + a[c + 1] + b[c] + b[c + 1] + 1 + (rnd & 1)) >> 2;
        }
        o[c] = (uint8_t)(avg ? (o[c] + v + 1) >> 1 : v);
      }
    }
  }

  // mpeg_motion: a 16x16 macroblock's luma and 8x8 chroma from one vector
  void mc16(const Frame& ref, int mx, int my, int vx, int vy, int rnd, bool avg) {
    const int he = hep(), ve = vep(), cs = ref.cstride();
    const int dxy = ((vy & 1) << 1) | (vx & 1);
    const int sx = mx * 16 + (vx >> 1), sy = my * 16 + (vy >> 1);
    // the chroma vector: the luma one halved, its quarters rounded to
    // halves (under DivX's FF_BUG_HPEL_CHROMA too: cv2's FFmpeg gives this
    // vector for DivX 4 and 5 builds, measured)
    const int uvdxy = dxy | (vy & 2) | ((vx & 2) >> 1), ux = sx >> 1, uy = sy >> 1;
    const bool emu = (unsigned)sx >= (unsigned)std::max(he - (vx & 1) - 15, 0) ||
                     (unsigned)sy >= (unsigned)std::max(ve - (vy & 1) - 15, 0);
    uint8_t tmp[24 * 24];
    int ts;
    const uint8_t* s = area(ref.y.data(), ref.pw, ref.pw, ref.ph, sx, sy, 17, 17,
                            emu, he, ve, tmp, &ts);
    hpel_op(s, ts, dxy, rnd, 16, avg, &cur->f.y[(size_t)my * 16 * cur->f.pw + mx * 16],
            cur->f.pw);
    const size_t o = (size_t)my * 8 * cs + mx * 8;
    for (int p = 0; p < 2; p++) {
      const auto& plane = p ? ref.cr : ref.cb;
      s = area(plane.data(), cs, cs, ref.ph / 2, ux, uy, 9, 9, emu, he >> 1, ve >> 1,
               tmp, &ts);
      hpel_op(s, ts, uvdxy, rnd, 8, avg, &(p ? cur->f.cr : cur->f.cb)[o], cs);
    }
  }

  // apply_8x8: four 8x8 luma blocks through hpel_motion (each read clipped
  // to [-16, width] x [-16, height], its half-pel dropped at the far
  // clip), and chroma_4mv_motion from the four vectors' sum
  void mc8x8(const Frame& ref, int mx, int my, const int16_t (*v)[2], int rnd, bool avg) {
    const int he = hep(), ve = vep(), cs = ref.cstride();
    uint8_t tmp[24 * 24];
    int ts, sumx = 0, sumy = 0;
    for (int k = 0; k < 4; k++) {
      const int vx = v[k][0], vy = v[k][1];
      sumx += vx;
      sumy += vy;
      int dxy = 0;
      int sx = mx * 16 + (k & 1) * 8 + (vx >> 1), sy = my * 16 + (k >> 1) * 8 + (vy >> 1);
      sx = std::min(std::max(sx, -16), width);
      if (sx != width) dxy |= vx & 1;
      sy = std::min(std::max(sy, -16), height);
      if (sy != height) dxy |= (vy & 1) << 1;
      const bool emu = (unsigned)sx >= (unsigned)std::max(he - (vx & 1) - 7, 0) ||
                       (unsigned)sy >= (unsigned)std::max(ve - (vy & 1) - 7, 0);
      const uint8_t* s = area(ref.y.data(), ref.pw, ref.pw, ref.ph, sx, sy, 9, 9, emu,
                              he, ve, tmp, &ts);
      hpel_op(s, ts, dxy, rnd, 8, avg,
              &cur->f.y[(size_t)(my * 16 + (k >> 1) * 8) * cur->f.pw + mx * 16 + (k & 1) * 8],
              cur->f.pw);
    }
    int cx = round_chroma(sumx), cy = round_chroma(sumy);
    int dxy = ((cy & 1) << 1) | (cx & 1);
    int sx = mx * 8 + (cx >> 1), sy = my * 8 + (cy >> 1);
    sx = std::min(std::max(sx, -8), width >> 1);
    if (sx == (width >> 1)) dxy &= ~1;
    sy = std::min(std::max(sy, -8), height >> 1);
    if (sy == (height >> 1)) dxy &= ~2;
    const bool emu = (unsigned)sx >= (unsigned)std::max((he >> 1) - (dxy & 1) - 7, 0) ||
                     (unsigned)sy >= (unsigned)std::max((ve >> 1) - (dxy >> 1) - 7, 0);
    const size_t o = (size_t)my * 8 * cs + mx * 8;
    for (int p = 0; p < 2; p++) {
      const auto& plane = p ? ref.cr : ref.cb;
      const uint8_t* s = area(plane.data(), cs, cs, ref.ph / 2, sx, sy, 9, 9, emu,
                              he >> 1, ve >> 1, tmp, &ts);
      hpel_op(s, ts, dxy, rnd, 8, avg, &(p ? cur->f.cr : cur->f.cb)[o], cs);
    }
  }

  // --- blocks -----------------------------------------------------------------

  // the IDCT FFmpeg chose for the stream (Xvid's once the build says
  // Xvid, else the simple one) put into, or added to, block n's place
  void idct_put(int16_t* blk, int n, int mx, int my, bool add) {
    Frame& f = cur->f;
    uint8_t* dst;
    int stride;
    if (n < 4) {
      stride = f.pw;
      dst = &f.y[(size_t)(my * 16 + (n >> 1) * 8) * f.pw + mx * 16 + (n & 1) * 8];
    } else {
      stride = f.cstride();
      dst = &(n == 4 ? f.cb : f.cr)[(size_t)my * 8 * stride + mx * 8];
    }
    if (use_xvid_idct) xvid_idct(blk, dst, stride, add);
    else simple_idct(blk, dst, stride, add);
  }

  // TCOEF levels into blk (natural order) along `scan` from position i0;
  // inter: dequantized here (H.263), as FFmpeg's run-level tables do
  void read_coefs(Bits& b, int16_t* blk, const Rl& rl, const int* scan,
                  int i0, int qmul, int qadd) {
    int i = i0 - 1;
    while (true) {
      int sym = rl.vlc.read(b, "TCOEF");
      int run, level, last_;
      if (sym != 102) {
        run = rl.t->run[sym];
        level = rl.t->level[sym];
        last_ = sym >= rl.t->last;
        level = level * qmul + qadd;
        if (b.get1()) level = -level;
      } else if (!b.get1()) {  // escape 1: level + LMAX
        sym = rl.vlc.read(b, "TCOEF");
        if (sym == 102) throw Error("MPEG-4: bad TCOEF escape");
        run = rl.t->run[sym];
        last_ = sym >= rl.t->last;
        level = (rl.t->level[sym] + rl.max_level[last_][run]) * qmul + qadd;
        if (b.get1()) level = -level;
      } else if (!b.get1()) {  // escape 2: run + RMAX + 1
        sym = rl.vlc.read(b, "TCOEF");
        if (sym == 102) throw Error("MPEG-4: bad TCOEF escape");
        last_ = sym >= rl.t->last;
        level = rl.t->level[sym];
        run = rl.t->run[sym] + rl.max_run[last_][level] + 1;
        level = level * qmul + qadd;
        if (b.get1()) level = -level;
      } else {  // escape 3: fixed length
        last_ = b.get1();
        run = (int)b.get(6);
        b.marker("escape");
        level = b.sget(12);
        b.marker("escape");
        if (level > 0) level = level * qmul + qadd;
        else level = level * qmul - qadd;
        if (level < -2048) level = -2048;
        if (level > 2047) level = 2047;
      }
      i += run + 1;
      if (i > 63) throw Error("MPEG-4: run past the end of a block");
      blk[scan[i]] = (int16_t)level;
      if (last_) return;
    }
  }

  void inter_block(Bits& b, int16_t* blk) {
    const Tables& T = tables();
    if (!mpeg_quant) {
      read_coefs(b, blk, T.inter, kZigzag, 0, 2 * qscale, (qscale - 1) | 1);
      return;
    }
    read_coefs(b, blk, T.inter, kZigzag, 0, 1, 0);
    // dct_unquantize_mpeg2_inter, with its mismatch control: coefficient
    // 63's low bit flipped when the levels' sum is even
    const int q2 = qscale << 1;
    int sum = -1;
    for (int k = 0; k < 64; k++) {
      int l = blk[k];
      if (!l) continue;
      int m = (((std::abs(l) << 1) + 1) * q2 * inter_matrix[k]) >> 5;
      blk[k] = (int16_t)(l < 0 ? -m : m);
      sum += blk[k];
    }
    blk[63] ^= (int16_t)(sum & 1);
  }

  void intra_block(Bits& b, int16_t* blk, int n, int mx, int my, bool coded,
                   bool dc_vlc) {
    const Tables& T = tables();
    int bx, by;
    blk_pos(n, mx, my, &bx, &by);
    const int scale = n < 4 ? kYDcScale[qscale] : kCDcScale[qscale];
    // DC prediction direction: B C / A X
    const int ia = blk_index(n, bx - 1, by), ib = blk_index(n, bx - 1, by - 1),
              ic = blk_index(n, bx, by - 1);
    const int a = ia < 0 ? 1024 : dc[ia], bb = ib < 0 ? 1024 : dc[ib],
              c = ic < 0 ? 1024 : dc[ic];
    const int dir = std::abs(a - bb) < std::abs(bb - c) ? 1 : 0;  // 1: top
    const int pred = ((dir ? c : a) + (scale >> 1)) / scale;
    int level = 0;
    if (dc_vlc) {
      int size = (n < 4 ? T.dc_lum : T.dc_chrom).read(b, "DC size");
      if (size) {
        level = (int)b.get(size);
        if (level < (1 << (size - 1))) level -= (1 << size) - 1;
        if (size > 8) b.marker("intra DC");
      }
    }
    const int* scan = ac_pred ? (dir == 0 ? kAltVertical : kAltHorizontal) : kZigzag;
    if (coded) read_coefs(b, blk, T.intra, scan, dc_vlc ? 1 : 0, 1, 0);
    if (dc_vlc) blk[0] = (int16_t)level;
    // mpeg4_pred_dc: the DC level with its prediction; the predictor kept
    // is clipped to [0, 2047], or (FF_BUG_DC_CLIP) only at 0
    int dcl = blk[0] + pred;
    blk[0] = (int16_t)dcl;
    int stored = dcl * scale;
    if (stored & ~2047) {
      if (stored < 0) stored = 0;
      else if (!(bugs & kBugDcClip)) stored = 2047;
    }
    const int self = blk_index_self(n, bx, by);
    dc[self] = (int16_t)stored;
    // ff_mpeg4_pred_ac
    int16_t* av = &ac[(size_t)self * 16];
    if (ac_pred) {
      if (dir == 0) {
        if (ia >= 0) {
          const int16_t* p = &ac[(size_t)ia * 16];
          int qn = mb_q[mb_of(n, bx - 1, by)];
          bool same = qn == qscale || (n == 1 || n == 3);
          for (int k = 1; k < 8; k++)
            blk[k << 3] = (int16_t)(blk[k << 3] + (same ? p[k] : rounded_div(p[k] * qn, qscale)));
        }
      } else if (ic >= 0) {
        const int16_t* p = &ac[(size_t)ic * 16];
        int qn = mb_q[mb_of(n, bx, by - 1)];
        bool same = qn == qscale || (n == 2 || n == 3);
        for (int k = 1; k < 8; k++)
          blk[k] = (int16_t)(blk[k] + (same ? p[8 + k] : rounded_div(p[8 + k] * qn, qscale)));
      }
    }
    for (int k = 1; k < 8; k++) {
      av[k] = blk[k << 3];
      av[8 + k] = blk[k];
    }
    // dequantisation (dct_unquantize_h263_intra / _mpeg2_intra)
    blk[0] = (int16_t)(blk[0] * scale);
    if (!mpeg_quant) {
      const int qmul = qscale << 1, qadd = (qscale - 1) | 1;
      for (int k = 1; k < 64; k++) {
        int l = blk[k];
        if (l) blk[k] = (int16_t)(l < 0 ? l * qmul - qadd : l * qmul + qadd);
      }
    } else {
      const int q2 = qscale << 1;
      for (int k = 1; k < 64; k++) {
        int l = blk[k];
        if (!l) continue;
        int m = (std::abs(l) * q2 * intra_matrix[k]) >> 4;
        blk[k] = (int16_t)(l < 0 ? -m : m);
      }
    }
  }

  int blk_index_self(int n, int bx, int by) const {
    if (n < 4) return by * 2 * mbw + bx;
    return 4 * mbw * mbh + (n - 4) * mbw * mbh + by * mbw + bx;
  }
};

// --- Motion JPEG -------------------------------------------------------------

struct Mjpeg {
  Frame cur;
  bool have_frame = false;

  void decode(const uint8_t* d, int64_t n) {
    Decoder jd(d, n);
    jd.run(false);
    if (jd.truncated) throw Error("MJPEG frame data ends early");
    if (jd.space != kYCbCr || jd.ncomp != 3 || jd.comp[0].h != 2 ||
        jd.comp[0].v != 2 || jd.comp[1].h != 1 || jd.comp[1].v != 1 ||
        jd.comp[2].h != 1 || jd.comp[2].v != 1)
      throw Error("MJPEG frames other than 4:2:0 YCbCr are not supported");
    cur.alloc(jd.W, jd.H);
    for (int ci = 0; ci < 3; ci++) {
      Component& c = jd.comp[ci];
      auto& plane = ci == 0 ? cur.y : ci == 1 ? cur.cb : cur.cr;
      const int stride = ci == 0 ? cur.pw : cur.cstride();
      const int rows = ci == 0 ? cur.ph / 8 : cur.ph / 16;
      const int cols = ci == 0 ? cur.pw / 8 : cur.pw / 16;
      for (int by = 0; by < std::min(rows, c.bh); by++)
        for (int bx = 0; bx < std::min(cols, c.bw); bx++) {
          const int16_t* src = &c.coef[((size_t)by * c.bw + bx) * 64];
          int16_t blk[64];
          // FFmpeg: the DC summed and dequantized from 1024 (4 << bits:
          // the level shift), clipped to 16 bits; each AC level times its
          // quantiser into 16 bits
          int dcv = 1024 + src[0] * c.quant[0];
          blk[0] = (int16_t)std::min(std::max(dcv, -32768), 32767);
          for (int k = 1; k < 64; k++) blk[k] = (int16_t)(src[k] * c.quant[k]);
          simple_idct(blk, &plane[(size_t)by * 8 * stride + bx * 8], stride, false);
        }
    }
    have_frame = true;
  }
};

struct Handle {
  int codec;  // 1 MPEG-4 Part 2, 2 MJPEG, 3 H.264, 4 VP9, 5 HEVC
  Mpeg4 m4;
  Mjpeg mj;
  std::unique_ptr<FrameDecoder> dec;  // H.264, VP9, HEVC
  int64_t tag = -1;                   // MJPEG: the last sample's tag
  const Frame* frame() const {
    if (dec) return dec->frame();
    if (codec == 1) return m4.out ? &m4.out->f : nullptr;
    return mj.have_frame ? &mj.cur : nullptr;
  }
  bool full_range() const { return dec ? dec->full_range : codec == 2; }
  int matrix() const { return dec ? dec->matrix : 2; }
  h264::Decoder* avc() const { return static_cast<h264::Decoder*>(dec.get()); }
};

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
}

}  // namespace

extern "C" {

// A decoder of `codec` (1: MPEG-4 Part 2, 2: MJPEG, 3: H.264, 4: VP9, whose
// samples carry all its headers, 5: HEVC). For MPEG-4,
// `extra` holds the headers the container keeps apart (MP4 esds'
// DecoderSpecificInfo, Matroska CodecPrivate), or is empty, and `tag` is
// the codec tag FFmpeg's demuxer gives the track (its four bytes, first
// in the low byte; 0 for none), whose upper-case form chooses Xvid's
// workarounds where the stream names no build; for H.264 the avcC record
// (samples are then length-prefixed NAL units) or nothing (Annex B
// samples); for HEVC the hvcC record (length-prefixed samples) or nothing
// or Annex B headers (Annex B samples). Returns the handle, or null with a
// message in err.
void* vd_open(int codec, const uint8_t* extra, int64_t n, uint32_t tag, char* err,
              int errlen) {
  try {
    if (codec < 1 || codec > 5) throw Error("unknown codec");
    std::unique_ptr<Handle> h(new Handle());
    h->codec = codec;
    if (codec == 1) {
      for (int k = 0; k < 4; k++) {  // ff_toupper4
        uint32_t c = (tag >> (8 * k)) & 0xFF;
        if (c >= 'a' && c <= 'z') c -= 'a' - 'A';
        h->m4.codec_tag |= c << (8 * k);
      }
      if (n > 0) h->m4.headers(extra, n);  // esds, CodecPrivate: headers only
    }
    if (codec == 3) {
      auto* d = new h264::Decoder();
      h->dec.reset(d);
      d->open(extra, n);
    }
    if (codec == 4) h->dec.reset(new vp9::Decoder());
    if (codec == 5) {
      auto* d = new hevc::Decoder();
      h->dec.reset(d);
      d->open(extra, n);
    }
    return h.release();
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return nullptr;
  }
}

void vd_close(void* h) { delete static_cast<Handle*>(h); }

// Decodes one sample, tagged `tag`. Returns 1 when a frame is ready (its
// width and height in wh; an H.264 picture or an MPEG-4 I- or P-VOP may
// come out of a later sample, in output order, and its tag says which
// sample it was), 0 when the sample puts no frame out (an H.264 picture
// waiting for its turn, or one dropped; a VP9 sample of frames that are
// not shown; an MPEG-4 VOP held back, not coded, or a B-VOP FFmpeg skips),
// or -1 with a message in err (no picture in the sample, data that ends
// early or does not parse, a refused feature).
int vd_decode(void* hp, const uint8_t* data, int64_t n, int64_t tag, int32_t* wh,
              char* err, int errlen) {
  Handle* h = static_cast<Handle*>(hp);
  try {
    if (h->dec) {
      if (!h->dec->decode(data, n, tag)) return 0;
    } else if (h->codec == 1) {
      if (!h->m4.decode(data, n, tag)) return 0;
    } else {
      h->mj.decode(data, n);
      h->tag = tag;
    }
    const Frame* f = h->frame();
    wh[0] = f->w;
    wh[1] = f->h;
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

// At the end of the stream: puts out the next H.264 or HEVC picture still
// waiting or the MPEG-4 reference FFmpeg puts out last (1, its size in
// wh), or returns 0 when none waits.
int vd_flush(void* hp, int32_t* wh) {
  Handle* h = static_cast<Handle*>(hp);
  if (h->dec ? !h->dec->flush() : h->codec != 1 || !h->m4.flush()) return 0;
  const Frame* f = h->frame();
  wh[0] = f->w;
  wh[1] = f->h;
  return 1;
}

// The last frame's tag.
int64_t vd_tag(void* hp) {
  Handle* h = static_cast<Handle*>(hp);
  if (h->dec) return h->dec->out_tag;
  if (h->codec == 1) return h->m4.out ? h->m4.out->tag : -1;
  return h->tag;
}

// MPEG-4: a seek, as avcodec_flush_buffers does it (ff_mpeg_flush: the
// pictures and any held VOP go; the headers and the encoder's build stay).
void vd_reset(void* hp) {
  Handle* h = static_cast<Handle*>(hp);
  if (h->codec == 1) h->m4.reset();
}

// MPEG-4: what FFmpeg made of the encoder, in info[0..6]: the Xvid build,
// the DivX version and build, the Lavc build (-1 where none), the
// workaround flags (bit 0 FF_BUG_EDGE, 1 DC_CLIP, 2 HPEL_CHROMA, 3
// DIRECT_BLOCKSIZE, 4 QPEL_CHROMA, 5 QPEL_CHROMA2, 6 STD_QPEL, 7 IEDGE, 8
// XVID_ILACE, 9 UMP4), the Xvid IDCT (1) and packed bitstreams (1); info[7]
// the VOL's low delay.
void vd_mpeg4_info(void* hp, int32_t* info) {
  const Mpeg4& m = static_cast<Handle*>(hp)->m4;
  const int32_t v[8] = {m.xvid_build, m.divx_version, m.divx_build, m.lavc_build,
                        (int32_t)m.bugs, m.use_xvid_idct, m.divx_packed, m.low_delay};
  std::memcpy(info, v, sizeof(v));
}

// H.264's reorder delay (FFmpeg's has_b_frames): set where decoding starts
// (delay >= 0), and returned with the active SPS's bitstream_restriction
// flag and reorder depth and the pictures dropped so far in info[0..2] (0s
// before a picture).
int vd_delay(void* hp, int delay, int32_t* info) {
  Handle* h = static_cast<Handle*>(hp);
  if (info) info[0] = info[1] = info[2] = 0;
  if (h->codec != 3) return 0;
  h264::Decoder* avc = h->avc();
  if (delay >= 0) avc->has_b = delay;
  if (info) {
    info[0] = avc->restriction;
    info[1] = avc->num_reorder;
    info[2] = avc->dropped;
  }
  return avc->has_b;
}

// The last decoded frame as H x W x 3 RGB (rgb) and its planes: y (H x W),
// cb and cr ((H+1)/2 x (W+1)/2); any pointer may be null. Returns 0, or 1
// when there is no frame.
int vd_frame(void* hp, uint8_t* rgb, uint8_t* y, uint8_t* cb, uint8_t* cr) {
  Handle* h = static_cast<Handle*>(hp);
  const Frame* f = h->frame();
  if (!f) return 1;
  const int cw = (f->w + 1) / 2, ch = (f->h + 1) / 2, cs = f->cstride();
  if (rgb)
    yuv_to_rgb(f->y.data(), f->pw, f->cb.data(), f->cr.data(), cs, f->w, f->h,
               h->full_range(), h->matrix(), rgb);
  for (int r = 0; y && r < f->h; r++)
    std::memcpy(y + (size_t)r * f->w, &f->y[(size_t)r * f->pw], f->w);
  for (int r = 0; cb && r < ch; r++)
    std::memcpy(cb + (size_t)r * cw, &f->cb[(size_t)r * cs], cw);
  for (int r = 0; cr && r < ch; r++)
    std::memcpy(cr + (size_t)r * cw, &f->cr[(size_t)r * cs], cw);
  return 0;
}

// The arithmetic alone, for the tests: the simple IDCT of one block
// (natural order) put into (add 0) or added to (add 1) dst (8 x 8,
// stride 8); one n x n half-pel block (n 8 or 16) of a w x h plane, its
// coordinates clamped into the plane; the I420/J420 -> RGB conversion.
void vd_idct(const int16_t* in, int add, uint8_t* dst) {
  int16_t blk[64];
  std::memcpy(blk, in, sizeof(blk));
  simple_idct(blk, dst, 8, add != 0);
}

// The Xvid IDCT, as vd_idct.
void vd_xvid_idct(const int16_t* in, int add, uint8_t* dst) {
  int16_t blk[64];
  std::memcpy(blk, in, sizeof(blk));
  xvid_idct(blk, dst, 8, add != 0);
}

// A B-VOP's bidirectional prediction of an n x n block: the forward block
// at (x0, y0) + half-pel dxy0 of plane p0 put with rounding, then the
// backward one of p1 averaged in (avg_pixels); both planes w x h (stride
// w), read with their coordinates clamped into the plane.
void vd_mpeg4_bipred(const uint8_t* p0, const uint8_t* p1, int w, int h, int x0,
                     int y0, int dxy0, int x1, int y1, int dxy1, int n, uint8_t* dst) {
  uint8_t tmp[24 * 24];
  int ts;
  const uint8_t* s = Mpeg4::area(p0, w, w, h, x0, y0, n + 1, n + 1, true, w, h, tmp, &ts);
  Mpeg4::hpel_op(s, ts, dxy0, 1, n, false, dst, n);
  s = Mpeg4::area(p1, w, w, h, x1, y1, n + 1, n + 1, true, w, h, tmp, &ts);
  Mpeg4::hpel_op(s, ts, dxy1, 1, n, true, dst, n);
}

void vd_hpel(const uint8_t* src, int stride, int w, int h, int x, int y,
             int dxy, int rounding, int n, uint8_t* dst) {
  uint8_t tmp[24 * 24];
  int ts;
  const uint8_t* s = Mpeg4::area(src, stride, w, h, x, y, n + 1, n + 1, true, w, h, tmp, &ts);
  Mpeg4::hpel_op(s, ts, dxy, 1 - rounding, n, false, dst, n);
}

void vd_yuv_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                   int w, int h, int full_range, int matrix, uint8_t* out) {
  yuv_to_rgb(y, w, cb, cr, (w + 1) / 2, w, h, full_range != 0, matrix, out);
}

// The H.264 arithmetic alone, for the tests: the scaling and inverse
// transform of one 4x4 (n 4) or 8x8 (n 8) block of levels (raster order)
// under weights `w` (the scaling list, raster) and QP `qp`, added to the
// n x n block `dst` (stride n); one quarter-sample luma block and one
// eighth-sample chroma block at (x, y) + fraction (fx, fy) of a w x h
// plane, its samples outside the plane those of its edge; one edge of
// `n` lines through `pix` (stride `stride` between lines, p3..p0 | q0..q3
// along each line at offsets -4..3) under bS, indexA and indexB.
void vd_h264_idct(const int16_t* levels, const uint8_t* w, int qp, int n,
                  uint8_t* dst) {
  int c[64], ls[64], d[64];
  for (int k = 0; k < n * n; k++) {
    c[k] = levels[k];
    ls[k] = w[k] * (n == 4 ? h264::norm4(qp % 6, k) : h264::norm8(qp % 6, k));
  }
  if (n == 4) {
    h264::scale4(c, ls, qp, false, d);
    h264::idct4_add(d, dst, 4);
  } else {
    h264::scale8(c, ls, qp, d);
    h264::idct8_add(d, dst, 8);
  }
}

void vd_h264_mc(const uint8_t* src, int w, int h, int chroma, int x, int y,
                int fx, int fy, int bw, int bh, uint8_t* dst) {
  const int pad = 32;
  const int pw = w + 2 * pad, ph = h + 2 * pad;
  std::vector<uint8_t> p((size_t)pw * ph);
  for (int r = 0; r < ph; r++)
    for (int c = 0; c < pw; c++)
      p[(size_t)r * pw + c] = src[(size_t)std::min(std::max(r - pad, 0), h - 1) * w +
                                  std::min(std::max(c - pad, 0), w - 1)];
  const uint8_t* o = p.data() + (size_t)pad * pw + pad;
  if (chroma) {
    x = std::min(std::max(x, -(bw + 4)), w + 4);
    y = std::min(std::max(y, -(bh + 4)), h + 4);
    h264::chroma_mc(o, pw, x, y, fx, fy, bw, bh, dst, bw);
  } else {
    x = std::min(std::max(x, -(bw + 8)), w + 8);
    y = std::min(std::max(y, -(bh + 8)), h + 8);
    h264::luma_mc(o, pw, x, y, fx, fy, bw, bh, dst, bw);
  }
}

// B slices' arithmetic alone: n samples of the bi-prediction of a and b
// (mode 0: the default average; else weights w0 / w1, offset o0 + o1 and
// denominator logwd, as FFmpeg's C routine (mode 1) or its x86 one (mode
// 2) weights them); DistScaleFactor and the temporal direct vectors of
// mvcol (mv[0..3] out: mvL0, mvL1); the implicit weight w0 of a pair of
// POCs.
void vd_h264_bipred(const uint8_t* a, const uint8_t* b, int n, int logwd, int w0, int w1,
                    int o, int mode, uint8_t* out) {
  for (int i = 0; i < n; i++)
    out[i] = mode == 0 ? (uint8_t)((a[i] + b[i] + 1) >> 1)
             : mode == 2 ? h264::biweight_x86(a[i], b[i], logwd, w0, w1, o)
                         : h264::biweight_c(a[i], b[i], logwd, w0, w1, o);
}

int vd_h264_temporal(int cur, int poc0, int poc1, int lt0, const int16_t* mvcol, int32_t* mv) {
  int sc = h264::dist_scale(cur, poc0, poc1, lt0 != 0);
  for (int c = 0; c < 2; c++) {
    mv[c] = (int16_t)((sc * mvcol[c] + 128) >> 8);
    mv[2 + c] = (int16_t)(mv[c] - mvcol[c]);
  }
  return sc;
}

int vd_h264_implicit(int cur, int poc0, int poc1, int lt0, int lt1) {
  return h264::implicit_weight(cur, poc0, poc1, lt0 != 0, lt1 != 0);
}

void vd_h264_edge(uint8_t* pix, int stride, int n, int bs, int index_a,
                  int index_b, int chroma) {
  if (bs < 1 || bs > 4) return;
  for (int i = 0; i < n; i++)
    h264::filter_line(pix + (size_t)i * stride, 1, bs, h264::kAlpha[index_a],
                      h264::kBeta[index_b],
                      bs < 4 ? h264::kTc0[index_a][bs - 1] : 0, chroma != 0);
}

// VP9's arithmetic alone, for the tests: one n x n inverse transform
// (n = 4 << tx; type 0-3: DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST; 4: the
// WHT of lossless frames, tx 0) of dequantised coefficients (raster order)
// added to dst (stride n); one w x h block at (x, y) + the 1/16 fraction
// (fx, fy) of a w x h plane read past its edges, filter 0 regular, 1
// smooth, 2 sharp, 3 bilinear, put (avg 0) or averaged with dst (avg 1);
// one loop-filter edge of n lines through pix (along: the stride between
// lines, across: between the samples of a line, p3..p0 | q0..q3 at
// -4..3), wd 4, 8 or 16, at filter level `level` and sharpness `sharp`.
void vd_vp9_itx(const int16_t* coef, int tx, int type, uint8_t* dst) {
  vp9::inverse_transform_add(coef, tx, type == 4 ? 0 : type, type == 4, dst, 4 << tx);
}

void vd_vp9_mc(const uint8_t* src, int w, int h, int x, int y, int fx, int fy,
               int bw, int bh, int filter, int avg, uint8_t* dst) {
  vp9::predict_block(src, w, w, h, x, y, fx, fy, bw, bh, filter, avg != 0, dst, bw);
}

void vd_vp9_lf(uint8_t* pix, int along, int across, int n, int wd, int level,
               int sharp) {
  vp9::LfLut lut;
  lut.set(sharp);
  vp9::filter_edge(pix, along, across, n, wd, lut.mblim[level], lut.lim[level],
                   level >> 4);
}

// HEVC's arithmetic alone, for the tests: one n x n inverse transform
// (n = 1 << log2; trtype 1 the 4x4 DST; skip: transform skip) of scaled
// coefficients (raster) into the residual; the prediction of one bw x bh
// block of a w x h plane (luma, or chroma: mvs in eighth samples) from one
// list (pred 1: src0 with mv[0..1], 2: src1 with mv[2..3]) or both (3),
// weighted by default or explicitly (wt: log2wd, w0, w1, o0, o1); the intra
// prediction of an n x n block from its references and their availability
// (ref / avail: p[-1][-1], the 2n left samples downwards, the 2n top
// samples rightwards); one deblocking edge segment of 4 lines through pix
// (along / across as vd_h264_edge) of luma or chroma (chroma filtered
// where bS is 2, with the PPS's QP offset); SAO of one w x h block (src:
// its first sample, the samples round it readable where usable says).
void vd_hevc_idct(const int16_t* coef, int log2, int trtype, int skip, int16_t* res) {
  hevc::inverse_transform(coef, log2, trtype, skip != 0, res);
}

void vd_hevc_mc(const uint8_t* src0, const uint8_t* src1, int w, int h, int chroma, int x,
                int y, const int32_t* mv, int pred, int weighted, const int32_t* wt, int bw,
                int bh, uint8_t* out) {
  std::vector<int16_t> a((size_t)bw * bh), b((size_t)bw * bh);
  const int s = chroma ? 3 : 2, m = chroma ? 7 : 3;
  int n = 0;
  for (int l = 0; l < 2; l++) {
    if (!(pred >> l & 1)) continue;
    const int mx = mv[2 * l], my = mv[2 * l + 1];
    hevc::interpolate(l ? src1 : src0, w, w, h, chroma != 0, x + (mx >> s), y + (my >> s), mx & m,
                      my & m, bw, bh, n ? b.data() : a.data());
    n++;
  }
  hevc::weight(a.data(), n == 2 ? b.data() : nullptr, bw * bh, weighted != 0, wt[0], wt[1], wt[2],
               wt[3], wt[4], out);
}

void vd_hevc_intra(const uint8_t* ref, const uint8_t* avail, int log2, int c, int mode,
                   int strong, uint8_t* out) {
  hevc::intra_predict(ref, avail, log2, c, mode, strong != 0, out);
}

void vd_hevc_deblock(uint8_t* pix, int along, int across, int chroma, int bs, int qp,
                     int beta_offset, int tc_offset, int pps_offset, int no_p, int no_q) {
  if (chroma) {
    if (bs == 2)
      hevc::filter_chroma(pix, along, across, 4, hevc::chroma_tc(qp, pps_offset, tc_offset),
                          no_p != 0, no_q != 0);
  } else if (bs > 0) {
    hevc::filter_luma(pix, along, across, bs, qp, beta_offset, tc_offset, no_p != 0, no_q != 0);
  }
}

void vd_hevc_sao(const uint8_t* src, int stride, uint8_t* dst, int w, int h, int type, int band,
                 int eo, const int32_t* offsets, const uint8_t* usable) {
  bool u[8];
  int off[4];
  for (int k = 0; k < 8; k++) u[k] = usable[k] != 0;
  for (int k = 0; k < 4; k++) off[k] = offsets[k];
  hevc::sao_block(src, stride, dst, w, w, h, type, band, eo, off, u);
}

}  // extern "C"
