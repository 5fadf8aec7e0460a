// HEVC (ITU-T H.265 | ISO/IEC 23008-2) picture decoder of the video reader,
// included by video_decode.cpp (which supplies Error, Frame and clip_u8,
// and h264_decode.cpp's CABAC tables) and bound through its vd_* entries as
// codec 5.
//
// HEVC reconstruction is exact in the standard, and FFmpeg's hevc decoder
// (which cv2.VideoCapture runs) meets the conformance streams bit for bit,
// so this file follows the standard; where FFmpeg's own choices show in
// what it puts out, they are marked "FFmpeg:" below. What is decoded: the
// Main and Main Still Picture profiles (8-bit 4:2:0), I, P and B pictures
// in any order of decoding and output (hierarchical B pictures whose lists
// hold pictures on both sides), RADL pictures, RASL pictures where FFmpeg
// decodes them, pictures sent with pic_output_flag 0:
//   - NAL units from length-prefixed samples (hvcC) or an Annex B byte
//     stream, parameter sets in the hvcC record or in band; AUD, SEI, EOS,
//     EOB and filler data skipped; slices and SEI of nuh_layer_id > 0
//     dropped (FFmpeg decodes the base layer alone);
//   - VPS, SPS (profile_tier_level, conformance window, sub-layer ordering,
//     scaling lists with prediction, AMP, SAO, PCM, short-term RPS sets with
//     inter RPS prediction, long-term reference pictures, TMVP, strong intra
//     smoothing, VUI colour fields and HRD) and PPS (dependent slices,
//     output flag, extra slice header bits, sign hiding, cabac_init, QP
//     offsets, constrained intra prediction, transform skip, cu_qp_delta,
//     weighted prediction, transquant bypass, uniform and explicit tiles,
//     WPP, deblocking control and overrides, scaling lists, list
//     modification, parallel merge level, slice header extensions); the
//     picture keeps copies of its parameter sets; a set sent again
//     unchanged is kept, one that changes drops the sets that name it, as
//     in FFmpeg;
//   - slice segment headers: POC, short- and long-term RPS marking of the
//     DPB, reference lists with modification, pred weight tables, entry
//     points; several slices and dependent slice segments a picture;
//   - IRAP pictures of every type (IDR, CRA, BLA: an IDR or BLA picture, and
//     a CRA picture that starts the stream or follows an end of sequence,
//     start a coded video sequence) and their leading pictures: RADL
//     pictures decoded, RASL pictures behind FFmpeg's gate (max_ra: skipped,
//     neither decoded nor put out, after an IRAP picture decoding starts at
//     and after a BLA picture; decoded after a CRA picture met mid-stream);
//   - CABAC with WPP storage and synchronisation, tiles (CTB raster <->
//     tile scan, availability, context reset), SAO syntax, the coding
//     quadtree, PCM, transquant bypass, intra (35 modes, MPM, reference
//     substitution and filtering, constrained intra prediction as FFmpeg
//     substitutes there, strong smoothing, the DC / angular edge filters,
//     chroma mode derivation) and inter prediction (merge with
//     spatial, temporal, combined bi-predictive and zero candidates, AMVP
//     with MV scaling, luma 8-tap and chroma 4-tap interpolation in 14-bit
//     intermediates, default and explicit weighted prediction), residual
//     coding with sub-blocks, sign hiding and Rice adaptation, scaling
//     lists, transform skip, the DCT at 4-32 and the 4x4 DST;
//   - deblocking (bS from intra, coefficients and motion, beta / tC with
//     the slice's offsets, luma strong / weak, chroma, the slice and tile
//     boundary flags, PCM / bypass samples kept) and SAO (band and edge,
//     picture, slice and tile boundaries, PCM / bypass samples kept);
//   - output in FFmpeg's bumping order (sps_max_num_reorder_pics and
//     sps_max_dec_pic_buffering delay output, the lowest POC first, a
//     missing reference of the RPS holding a place of the DPB as FFmpeg's
//     generated picture does, a new sequence puts the last one's pictures
//     out first), each cropped to its own SPS's conformance
//     window (FFmpeg leaves the VUI's default display window alone); the
//     VUI's range (the picture's SPS's) and matrix (the active SPS's) go to
//     the converter.
// Refused with a message naming it: profiles other than Main and
// Main Still Picture (general_profile_idc named), slices of one picture
// that differ in their deblocking (FFmpeg's filter carries one slice's
// offsets into its neighbour's edges there in ways not all followed), a
// chroma format other than 4:2:0, more than 8 bits, the range / multilayer / 3D / SCC
// extensions, parameter sets of nuh_layer_id > 0 (FFmpeg reads them into
// the base layer's tables), field-coded sequences (field_seq_flag), a size change
// mid-stream, a left crop FFmpeg does not keep aligned, an odd frame height
// and VUI matrices swscale does not convert. A picture whose data ends
// early or does not parse, whose references are missing, or that changes
// the SPS within a coded video sequence (FFmpeg then forgets every
// reference), is an error.

namespace hevc {

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline uint8_t clip1(int v) { return (uint8_t)clip3(0, 255, v); }

[[noreturn]] void fail(const std::string& m) { throw Error("HEVC: " + m); }
[[noreturn]] void refuse(const std::string& m) {
  throw Error("HEVC with " + m + " is not supported");
}

// --- tables ----------------------------------------------------------------

// FFmpeg's CABAC initValues (hevc_cabac.c init_values, the standard's
// Tables 9-5 to 9-37) in its layout of contexts, by initType
enum Ctx {
  kSaoMerge = 0, kSaoType = 1, kSplitCu = 2, kBypassFlag = 5, kSkip = 6,
  kQpDelta = 9, kPredMode = 12, kPartMode = 13, kPrevIntra = 17,
  kChromaMode = 18, kMergeFlag = 20, kMergeIdx = 21, kInterDir = 22,
  kRefIdx0 = 27, kRefIdx1 = 29, kMvdG0 = 31, kMvdG1 = 33, kMvpFlag = 35,
  kRootCbf = 36, kSplitTu = 37, kCbfLuma = 40, kCbfChroma = 42,
  kTsFlag = 47, kLastX = 53, kLastY = 71, kCsbf = 89, kSig = 93,
  kGt1 = 137, kGt2 = 161, kNumCtx = 179
};
const uint8_t kInit[3][kNumCtx] = {
    {153, 200, 139, 141, 157, 154, 154, 154, 154, 154, 154, 154, 154, 184, 154, 154, 154,
     184, 63,  139, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154,
     154, 154, 154, 153, 138, 138, 111, 141, 94,  138, 182, 154, 154, 139, 139, 139, 139,
     139, 139, 110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79,
     108, 123, 63,  110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111,
     79,  108, 123, 63,  91,  171, 134, 141, 111, 111, 125, 110, 110, 94,  124, 108, 124,
     107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153,
     125, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111, 141,
     111, 140, 92,  137, 138, 140, 152, 138, 139, 153, 74,  149, 92,  139, 107, 122, 152,
     140, 179, 166, 182, 140, 227, 122, 197, 138, 153, 136, 167, 152, 152, 154, 154, 154,
     154, 154, 154, 154, 154, 154, 154, 154, 154},
    {153, 185, 107, 139, 126, 154, 197, 185, 201, 154, 154, 154, 149, 154, 139, 154, 154,
     154, 152, 139, 110, 122, 95,  79,  63,  31,  31,  153, 153, 153, 153, 140, 198, 140,
     198, 168, 79,  124, 138, 94,  153, 111, 149, 107, 167, 154, 154, 139, 139, 139, 139,
     139, 139, 125, 110, 94,  110, 95,  79,  125, 111, 110, 78,  110, 111, 111, 95,  94,
     108, 123, 108, 125, 110, 94,  110, 95,  79,  125, 111, 110, 78,  110, 111, 111, 95,
     94,  108, 123, 108, 121, 140, 61,  154, 155, 154, 139, 153, 139, 123, 123, 63,  153,
     166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
     154, 170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140, 140,
     140, 154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137,
     169, 194, 166, 167, 154, 167, 137, 182, 107, 167, 91,  122, 107, 167, 154, 154, 154,
     154, 154, 154, 154, 154, 154, 154, 154, 154},
    {153, 160, 107, 139, 126, 154, 197, 185, 201, 154, 154, 154, 134, 154, 139, 154, 154,
     183, 152, 139, 154, 137, 95,  79,  63,  31,  31,  153, 153, 153, 153, 169, 198, 169,
     198, 168, 79,  224, 167, 122, 153, 111, 149, 92,  167, 154, 154, 139, 139, 139, 139,
     139, 139, 125, 110, 124, 110, 95,  94,  125, 111, 111, 79,  125, 126, 111, 111, 79,
     108, 123, 93,  125, 110, 124, 110, 95,  94,  125, 111, 111, 79,  125, 126, 111, 111,
     79,  108, 123, 93,  121, 140, 61,  154, 170, 154, 139, 153, 139, 123, 123, 63,  124,
     166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
     154, 170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140, 140,
     140, 154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122,
     169, 208, 166, 167, 154, 152, 167, 182, 107, 167, 91,  107, 107, 167, 154, 154, 154,
     154, 154, 154, 154, 154, 154, 154, 154, 154}};

// intraPredAngle (Table 8-5) and invAngle by mode
const int kAngle[35] = {0,   0,   32,  26,  21,  17,  13,  9,  5,  2,  0,  -2,
                        -5,  -9,  -13, -17, -21, -26, -32, -26, -21, -17, -13, -9,
                        -5,  -2,  0,   2,   5,   9,   13,  17,  21,  26,  32};
inline int inv_angle(int mode) {
  static const int k[] = {-4096, -1638, -910, -630, -482, -390, -315, -256,
                          -315,  -390,  -482, -630, -910, -1638, -4096};
  return k[mode - 11];
}
// luma and chroma interpolation filters (Tables 8-11 / 8-12) by fraction
const int kLumaFilter[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                               {-1, 4, -10, 58, 17, -5, 1, 0},
                               {-1, 4, -11, 40, 40, -11, 4, -1},
                               {0, 1, -5, 17, 58, -10, 4, -1}};
const int kChromaFilter[8][4] = {{0, 64, 0, 0},     {-2, 58, 10, -2}, {-4, 54, 16, -2},
                                 {-6, 46, 28, -4},  {-4, 36, 36, -4}, {-4, 28, 46, -6},
                                 {-2, 16, 54, -4},  {-2, 10, 58, -2}};
// beta' and tC' (Table 8-12) by Q
const uint8_t kBeta[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
                           0,  0,  0,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15,
                           16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38,
                           40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
const uint8_t kTc[54] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,
                         1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2,  2,  2,  3,  3,  3,  3,  4,
                         4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};
const int kLevelScale[6] = {40, 45, 51, 57, 64, 72};
// QpC of qPi for 4:2:0 (Table 8-10)
inline int chroma_qp(int qpi) {
  static const int k[14] = {29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37};
  return qpi < 30 ? qpi : qpi > 43 ? qpi - 6 : k[qpi - 30];
}
// default scaling lists (Table 7-6), in up-right diagonal order
const uint8_t kDefIntra[64] = {16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 16, 17,
                               16, 17, 18, 17, 18, 18, 17, 18, 21, 19, 20, 21, 20,
                               19, 21, 24, 22, 22, 24, 24, 22, 22, 24, 25, 25, 27,
                               30, 27, 25, 25, 29, 31, 35, 35, 31, 29, 36, 41, 44,
                               41, 36, 47, 54, 54, 47, 65, 70, 65, 88, 88, 115};
const uint8_t kDefInter[64] = {16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 17, 17,
                               17, 17, 18, 18, 18, 18, 18, 18, 20, 20, 20, 20, 20,
                               20, 20, 24, 24, 24, 24, 24, 24, 24, 24, 25, 25, 25,
                               25, 25, 25, 25, 28, 28, 28, 28, 28, 28, 33, 33, 33,
                               33, 33, 41, 41, 41, 41, 54, 54, 54, 71, 71, 91};

// scan orders (6.5.3-6.5.5): [log2 size 1..3][scanIdx][pos] = x | y << 4
struct Scans {
  uint8_t s[4][3][64];
  Scans() {
    for (int l = 1; l <= 3; l++) {
      int n = 1 << l, i = 0, x = 0, y = 0;
      while (i < n * n) {  // up-right diagonal
        while (y >= 0) {
          if (x < n && y < n) s[l][0][i++] = (uint8_t)(x | y << 4);
          y--;
          x++;
        }
        y = x;
        x = 0;
      }
      i = 0;
      for (y = 0; y < n; y++)
        for (x = 0; x < n; x++) s[l][1][i++] = (uint8_t)(x | y << 4);  // horizontal
      i = 0;
      for (x = 0; x < n; x++)
        for (y = 0; y < n; y++) s[l][2][i++] = (uint8_t)(x | y << 4);  // vertical
    }
  }
};
const Scans kScan;

// the DCT matrix (8.6.4.2): row k of an N-point transform is row k * 32 / N
// of the 32-point one
struct DctMatrix {
  int m[32][32];
  DctMatrix() {
    static const int odd32[16] = {90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4};
    static const int odd16[8] = {90, 87, 80, 70, 57, 43, 25, 9};
    static const int odd8[4] = {89, 75, 50, 18};
    auto mag = [&](int t) {  // 64 sqrt(2) cos(t pi / 64), t in [0, 32]
      if (t == 0) return 64;
      if (t == 32) return 0;
      if (t & 1) return odd32[t >> 1];
      if (t & 2) return odd16[t >> 2];
      if (t & 4) return odd8[t >> 3];
      if (t == 8) return 83;
      if (t == 24) return 36;
      return 64;  // 16
    };
    for (int k = 0; k < 32; k++)
      for (int n = 0; n < 32; n++) {
        int t = (k * (2 * n + 1)) % 128, sign = 1;
        if (t > 64) t = 128 - t;
        if (t > 32) {
          t = 64 - t;
          sign = -1;
        }
        m[k][n] = k == 0 ? 64 : sign * mag(t);
      }
  }
};
const DctMatrix kDct;
const int kDst[4][4] = {{29, 55, 74, 84}, {74, 74, 0, -74}, {84, -29, -74, 55}, {55, -84, 74, -29}};

// --- the arithmetic, also bound alone for the tests ------------------------

// One n x n inverse transform (8.6.4.2): coefficients d (raster, [y][x]),
// residual r; trtype 1 the 4x4 DST; skip: transform skip ((d << 7) then
// the second stage's rounding, 8 bits); each stage clipped to 16 bits.
void inverse_transform(const int16_t* d, int log2, int trtype, bool skip, int16_t* r) {
  const int n = 1 << log2;
  if (skip) {
    for (int i = 0; i < n * n; i++) r[i] = (int16_t)((d[i] * 128 + 2048) >> 12);
    return;
  }
  int tmp[32 * 32];
  const int step = 32 >> log2;
  auto coef = [&](int k, int j) { return trtype ? kDst[k][j] : kDct.m[k * step][j]; };
  // first stage: each column, then clipped to 16 bits after >> 7
  for (int x = 0; x < n; x++)
    for (int y = 0; y < n; y++) {
      int64_t s = 0;
      for (int k = 0; k < n; k++)
        if (d[k * n + x]) s += (int64_t)coef(k, y) * d[k * n + x];
      tmp[y * n + x] = clip3(-32768, 32767, (int)((s + 64) >> 7));
    }
  // second stage: each row, >> 12
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) {
      int64_t s = 0;
      for (int k = 0; k < n; k++) s += (int64_t)coef(k, x) * tmp[y * n + k];
      r[y * n + x] = (int16_t)clip3(-32768, 32767, (int)((s + 2048) >> 12));
    }
}

// The prediction samples of one block (8.5.3.3.3) before weighting, 14 bits:
// luma (chroma 0, 8-tap, quarter samples) or 4:2:0 chroma (4-tap, eighth
// samples) at integer position (x, y) plus fraction (fx, fy) of a w x h
// plane, its coordinates clipped into the plane.
void interpolate(const uint8_t* src, int stride, int w, int h, bool chroma, int x, int y,
                 int fx, int fy, int bw, int bh, int16_t* out) {
  const int taps = chroma ? 4 : 8, half = chroma ? 1 : 3;
  const int* fh = chroma ? kChromaFilter[fx] : kLumaFilter[fx];
  const int* fv = chroma ? kChromaFilter[fy] : kLumaFilter[fy];
  auto px = [&](int xx, int yy) {
    return (int)src[(size_t)clip3(0, h - 1, yy) * stride + clip3(0, w - 1, xx)];
  };
  if (!fx && !fy) {
    for (int j = 0; j < bh; j++)
      for (int i = 0; i < bw; i++) out[j * bw + i] = (int16_t)(px(x + i, y + j) << 6);
    return;
  }
  if (!fy) {
    for (int j = 0; j < bh; j++)
      for (int i = 0; i < bw; i++) {
        int s = 0;
        for (int t = 0; t < taps; t++) s += fh[t] * px(x + i + t - half, y + j);
        out[j * bw + i] = (int16_t)s;
      }
    return;
  }
  if (!fx) {
    for (int j = 0; j < bh; j++)
      for (int i = 0; i < bw; i++) {
        int s = 0;
        for (int t = 0; t < taps; t++) s += fv[t] * px(x + i, y + j + t - half);
        out[j * bw + i] = (int16_t)s;
      }
    return;
  }
  std::vector<int> tmp((size_t)(bh + taps - 1) * bw);
  for (int j = 0; j < bh + taps - 1; j++)
    for (int i = 0; i < bw; i++) {
      int s = 0;
      for (int t = 0; t < taps; t++) s += fh[t] * px(x + i + t - half, y + j - half);
      tmp[(size_t)j * bw + i] = s;
    }
  for (int j = 0; j < bh; j++)
    for (int i = 0; i < bw; i++) {
      int s = 0;
      for (int t = 0; t < taps; t++) s += fv[t] * tmp[(size_t)(j + t) * bw + i];
      out[j * bw + i] = (int16_t)(s >> 6);
    }
}

// Weighted sample prediction (8.5.3.3.4): n samples of one list (b null)
// or two; weighted 0: the default; else log2wd (the denominator + 6),
// weights w0 / w1 and offsets o0 / o1.
void weight(const int16_t* a, const int16_t* b, int n, bool weighted, int log2wd, int w0,
            int w1, int o0, int o1, uint8_t* out) {
  for (int i = 0; i < n; i++) {
    int v;
    if (!weighted) {
      v = b ? (a[i] + b[i] + 64) >> 7 : (a[i] + 32) >> 6;
    } else if (!b) {
      v = log2wd >= 1 ? ((a[i] * w0 + (1 << (log2wd - 1))) >> log2wd) + o0 : a[i] * w0 + o0;
    } else {
      v = (a[i] * w0 + b[i] * w1 + (o0 + o1 + 1) * (1 << log2wd)) >> (log2wd + 1);
    }
    out[i] = clip1(v);
  }
}

// Intra sample prediction (8.4.4.2) of an n x n block (n = 1 << log2) of
// component c from its references: ref[0] = p[-1][-1], ref[1 + k] =
// p[-1][k] (left, k < 2n), ref[1 + 2n + k] = p[k][-1] (top), with avail
// the same layout (0 where a sample is not available); substitution,
// filtering (strong: strong_intra_smoothing_enabled_flag), the mode's
// prediction and the DC / angular edge filters; out raster n x n.
void intra_predict(const uint8_t* ref_in, const uint8_t* avail, int log2, int c, int mode,
                   bool strong, uint8_t* out) {
  const int n = 1 << log2, m = 4 * n + 1;
  int p[4 * 32 + 1];
  // substitution (8.4.4.2.2): the order is p[-1][2n-1] .. p[-1][-1],
  // p[0][-1] .. p[2n-1][-1]
  auto at = [&](int k) {  // k-th sample of the search order
    return k < 2 * n ? 2 * n - k : k == 2 * n ? 0 : k;  // left bottom-up, corner, top
  };
  int any = -1;
  for (int k = 0; k < m; k++)
    if (avail[at(k)]) {
      any = k;
      break;
    }
  if (any < 0) {
    for (int k = 0; k < m; k++) p[k] = 128;
  } else {
    for (int k = 0; k < m; k++) p[k] = ref_in[k];
    if (any > 0) p[at(0)] = ref_in[at(any)];
    for (int k = 1; k < m; k++)
      if (!avail[at(k)]) p[at(k)] = p[at(k - 1)];
  }
  // p index helpers: left(k) = p[-1][k], top(k) = p[k][-1], corner
  auto L = [&](const int* q, int k) { return k < 0 ? q[0] : q[1 + k]; };
  auto T = [&](const int* q, int k) { return k < 0 ? q[0] : q[1 + 2 * n + k]; };
  // filtering (8.4.4.2.3)
  int f[4 * 32 + 1];
  const int* q = p;
  bool filter = false;
  if (c == 0 && mode != 1 && n > 4) {
    int dist = std::min(std::abs(mode - 26), std::abs(mode - 10));
    int thres = n == 8 ? 7 : n == 16 ? 1 : 0;
    filter = dist > thres;
  }
  if (filter) {
    bool bi = strong && n == 32 &&
              std::abs(p[0] + T(p, 2 * n - 1) - 2 * T(p, n - 1)) < (1 << 3) &&
              std::abs(p[0] + L(p, 2 * n - 1) - 2 * L(p, n - 1)) < (1 << 3);
    if (bi) {
      f[0] = p[0];
      for (int k = 0; k < 63; k++) {
        f[1 + k] = ((63 - k) * p[0] + (k + 1) * L(p, 63) + 32) >> 6;
        f[1 + 2 * n + k] = ((63 - k) * p[0] + (k + 1) * T(p, 63) + 32) >> 6;
      }
      f[1 + 63] = L(p, 63);
      f[1 + 2 * n + 63] = T(p, 63);
    } else {
      f[0] = (L(p, 0) + 2 * p[0] + T(p, 0) + 2) >> 2;
      for (int k = 0; k < 2 * n - 1; k++) {
        f[1 + k] = (L(p, k + 1) + 2 * L(p, k) + L(p, k - 1) + 2) >> 2;
        f[1 + 2 * n + k] = (T(p, k + 1) + 2 * T(p, k) + T(p, k - 1) + 2) >> 2;
      }
      f[1 + 2 * n - 1] = L(p, 2 * n - 1);
      f[1 + 4 * n - 1] = T(p, 2 * n - 1);
    }
    q = f;
  }
  if (mode == 0) {  // planar
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++)
        out[y * n + x] = (uint8_t)(((n - 1 - x) * L(q, y) + (x + 1) * T(q, n) +
                                    (n - 1 - y) * T(q, x) + (y + 1) * L(q, n) + n) >>
                                   (log2 + 1));
    return;
  }
  if (mode == 1) {  // DC
    int s = n;
    for (int k = 0; k < n; k++) s += T(q, k) + L(q, k);
    int dc = s >> (log2 + 1);
    for (int k = 0; k < n * n; k++) out[k] = (uint8_t)dc;
    if (c == 0 && n < 32) {
      out[0] = (uint8_t)((L(q, 0) + 2 * dc + T(q, 0) + 2) >> 2);
      for (int x = 1; x < n; x++) out[x] = (uint8_t)((T(q, x) + 3 * dc + 2) >> 2);
      for (int y = 1; y < n; y++) out[y * n] = (uint8_t)((L(q, y) + 3 * dc + 2) >> 2);
    }
    return;
  }
  const int angle = kAngle[mode];
  int refb[3 * 32 + 1];
  int* ref = refb + 32;  // ref[-n .. 2n]
  const bool vert = mode >= 18;
  auto main_ = [&](int k) { return vert ? T(q, k) : L(q, k); };  // k >= -1
  auto side = [&](int k) { return vert ? L(q, k) : T(q, k); };
  for (int x = 0; x <= n; x++) ref[x] = main_(x - 1);
  if (angle < 0) {
    if ((n * angle) >> 5 < -1)
      for (int x = (n * angle) >> 5; x <= -1; x++)
        ref[x] = side(-1 + ((x * inv_angle(mode) + 128) >> 8));
  } else {
    for (int x = n + 1; x <= 2 * n; x++) ref[x] = main_(x - 1);
  }
  for (int y = 0; y < n; y++) {
    int idx = ((y + 1) * angle) >> 5, fact = ((y + 1) * angle) & 31;
    for (int x = 0; x < n; x++) {
      int v = fact ? ((32 - fact) * ref[x + idx + 1] + fact * ref[x + idx + 2] + 16) >> 5
                   : ref[x + idx + 1];
      if (vert) out[y * n + x] = (uint8_t)v;
      else out[x * n + y] = (uint8_t)v;
    }
  }
  if (c == 0 && n < 32) {
    if (mode == 26)
      for (int y = 0; y < n; y++) out[y * n] = clip1(T(q, 0) + ((L(q, y) - q[0]) >> 1));
    if (mode == 10)
      for (int x = 0; x < n; x++) out[x] = clip1(L(q, 0) + ((T(q, x) - q[0]) >> 1));
  }
}

// One deblocking edge segment (8.7.2.5.3 / 8.7.2.5.5): n lines (4 for luma,
// 4 for chroma) through pix, `along` between lines and `across` between
// the samples of a line (p3..p0 | q0..q3 at -4..3), the edge's bS, the
// average QpY of its sides (qpc: chroma's QpC already derived), the
// slice's beta / tc offsets (div2), and sides left alone (PCM with the
// loop filter off, transquant bypass).
void filter_luma(uint8_t* pix, int along, int across, int bs, int qp, int beta_off,
                 int tc_off, bool no_p, bool no_q) {
  const int beta = kBeta[clip3(0, 51, qp + 2 * beta_off)];
  const int tc = kTc[clip3(0, 53, qp + 2 * (bs - 1) + 2 * tc_off)];
  auto P = [&](int line, int i) -> uint8_t& { return pix[line * along - (i + 1) * across]; };
  auto Q = [&](int line, int i) -> uint8_t& { return pix[line * along + i * across]; };
  const int dp0 = std::abs(P(0, 2) - 2 * P(0, 1) + P(0, 0));
  const int dp3 = std::abs(P(3, 2) - 2 * P(3, 1) + P(3, 0));
  const int dq0 = std::abs(Q(0, 2) - 2 * Q(0, 1) + Q(0, 0));
  const int dq3 = std::abs(Q(3, 2) - 2 * Q(3, 1) + Q(3, 0));
  const int dpq0 = dp0 + dq0, dpq3 = dp3 + dq3, dp = dp0 + dp3, dq = dq0 + dq3;
  const int d = dpq0 + dpq3;
  if (d >= beta) return;
  auto dsam = [&](int line, int dpq) {
    return 2 * dpq < (beta >> 2) &&
           std::abs(P(line, 3) - P(line, 0)) + std::abs(Q(line, 0) - Q(line, 3)) < (beta >> 3) &&
           std::abs(P(line, 0) - Q(line, 0)) < ((5 * tc + 1) >> 1);
  };
  const bool strong = dsam(0, dpq0) && dsam(3, dpq3);
  const bool dep = dp < ((beta + (beta >> 1)) >> 3), deq = dq < ((beta + (beta >> 1)) >> 3);
  for (int k = 0; k < 4; k++) {
    const int p0 = P(k, 0), p1 = P(k, 1), p2 = P(k, 2), p3 = P(k, 3);
    const int q0 = Q(k, 0), q1 = Q(k, 1), q2 = Q(k, 2), q3 = Q(k, 3);
    if (strong) {
      if (!no_p) {
        P(k, 0) = (uint8_t)clip3(p0 - 2 * tc, p0 + 2 * tc, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
        P(k, 1) = (uint8_t)clip3(p1 - 2 * tc, p1 + 2 * tc, (p2 + p1 + p0 + q0 + 2) >> 2);
        P(k, 2) = (uint8_t)clip3(p2 - 2 * tc, p2 + 2 * tc, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
      }
      if (!no_q) {
        Q(k, 0) = (uint8_t)clip3(q0 - 2 * tc, q0 + 2 * tc, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
        Q(k, 1) = (uint8_t)clip3(q1 - 2 * tc, q1 + 2 * tc, (p0 + q0 + q1 + q2 + 2) >> 2);
        Q(k, 2) = (uint8_t)clip3(q2 - 2 * tc, q2 + 2 * tc, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3);
      }
    } else {
      int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (std::abs(delta) >= tc * 10) continue;
      delta = clip3(-tc, tc, delta);
      if (!no_p) P(k, 0) = clip1(p0 + delta);
      if (!no_q) Q(k, 0) = clip1(q0 - delta);
      if (dep && !no_p) {
        int dpv = clip3(-(tc >> 1), tc >> 1, (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1);
        P(k, 1) = clip1(p1 + dpv);
      }
      if (deq && !no_q) {
        int dqv = clip3(-(tc >> 1), tc >> 1, (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1);
        Q(k, 1) = clip1(q1 + dqv);
      }
    }
  }
}

// FFmpeg: chroma_tc clips QpY + the PPS offset into [0, 57] before Table
// 8-10 (the standard does not; the tC that results is the same)
int chroma_tc(int qp_avg, int pps_offset, int tc_off) {
  int qpi = clip3(0, 57, qp_avg + pps_offset);
  return kTc[clip3(0, 53, chroma_qp(qpi) + 2 + 2 * tc_off)];
}

void filter_chroma(uint8_t* pix, int along, int across, int n, int tc, bool no_p, bool no_q) {
  for (int k = 0; k < n; k++) {
    uint8_t* s = pix + k * along;
    const int p0 = s[-across], p1 = s[-2 * across], q0 = s[0], q1 = s[across];
    const int delta = clip3(-tc, tc, ((((q0 - p0) * 4) + p1 - q1 + 4) >> 3));
    if (!no_p) s[-across] = clip1(p0 + delta);
    if (!no_q) s[0] = clip1(q0 - delta);
  }
}

// SAO of one w x h block (8.7.3): src points at its first deblocked sample
// (its neighbours one sample round it readable), type 1 band (band_pos) or
// 2 edge (eo_class), offsets[4] signed; usable[8] whether the neighbour
// blocks left, right, above, below, above-left, above-right, below-left
// and below-right may be read (picture, slice and tile boundaries): a
// sample whose edge-offset neighbour lies in one that may not is left.
void sao_block(const uint8_t* src, int sstride, uint8_t* dst, int dstride, int w, int h,
               int type, int band_pos, int eo_class, const int* offsets, const bool* usable) {
  if (type == 1) {
    int table[32] = {0};
    for (int k = 0; k < 4; k++) table[(k + band_pos) & 31] = k + 1;
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        int v = src[(size_t)y * sstride + x], b = table[v >> 3];
        dst[(size_t)y * dstride + x] = b ? clip1(v + offsets[b - 1]) : (uint8_t)v;
      }
    return;
  }
  static const int kPos[4][2][2] = {{{-1, 0}, {1, 0}},
                                    {{0, -1}, {0, 1}},
                                    {{-1, -1}, {1, 1}},
                                    {{1, -1}, {-1, 1}}};
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      const int v = src[(size_t)y * sstride + x];
      uint8_t& o = dst[(size_t)y * dstride + x];
      o = (uint8_t)v;
      bool ok = true;
      int nb[2];
      for (int k = 0; k < 2 && ok; k++) {
        int xx = x + kPos[eo_class][k][0], yy = y + kPos[eo_class][k][1];
        int hx = xx < 0 ? 0 : xx >= w ? 2 : 1, vy = yy < 0 ? 0 : yy >= h ? 2 : 1;
        // neighbour block index: 0 left 1 right 2 above 3 below 4 above-left
        // 5 above-right 6 below-left 7 below-right; -1 inside
        static const int kBlock[3][3] = {{4, 2, 5}, {0, -1, 1}, {6, 3, 7}};
        int blk = kBlock[vy][hx];
        if (blk >= 0 && !usable[blk]) ok = false;
        else nb[k] = src[(ptrdiff_t)yy * sstride + xx];
      }
      if (!ok) continue;
      auto sign = [](int a) { return (a > 0) - (a < 0); };
      int edge = 2 + sign(v - nb[0]) + sign(v - nb[1]);
      if (edge <= 2) edge = edge == 2 ? 0 : edge + 1;
      if (edge) o = clip1(v + offsets[edge - 1]);
    }
}

// --- bitstream ---------------------------------------------------------------

struct Bits {
  std::vector<uint8_t> buf;  // the RBSP, with 8 zero bytes of slack
  size_t pos = 0, end = 0;   // in bits
  void load(const uint8_t* p, size_t n) {
    buf.clear();
    buf.reserve(n + 8);
    int zeros = 0;
    for (size_t i = 0; i < n; i++) {
      uint8_t b = p[i];
      if (zeros >= 2 && b == 3) {  // emulation prevention
        zeros = 0;
        continue;
      }
      buf.push_back(b);
      zeros = b ? 0 : zeros + 1;
    }
    end = buf.size() * 8;
    buf.resize(buf.size() + 8, 0);
    pos = 0;
  }
  uint32_t u1() {
    if (pos >= end) fail("data ends early");
    uint32_t v = (buf[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return v;
  }
  uint32_t u(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; i++) v = (v << 1) | u1();
    return v;
  }
  uint32_t ue() {
    int z = 0;
    while (!u1())
      if (++z > 31) fail("exp-Golomb code too long");
    return (uint32_t)((((uint64_t)1 << z) - 1) + u(z));
  }
  int32_t se() {
    uint32_t k = ue();
    return (k & 1) ? (int32_t)((k + 1) >> 1) : -(int32_t)(k >> 1);
  }
  void skip(size_t k) {
    pos += k;
    if (pos > end) fail("data ends early");
  }
  bool more_rbsp() const {  // not at the rbsp_stop_one_bit
    if (pos >= end) return false;
    size_t last = end;
    while (last > 0 && !((buf[(last - 1) >> 3] >> (7 - ((last - 1) & 7))) & 1)) last--;
    return pos + 1 < last;
  }
};

inline int ceil_log2(int v) {
  int k = 0;
  while ((1 << k) < v) k++;
  return k;
}
inline uint32_t ue_max(Bits& b, uint32_t hi, const char* what) {
  uint32_t v = b.ue();
  if (v > hi) fail(std::string(what) + " out of range");
  return v;
}
inline int32_t se_range(Bits& b, int32_t lo, int32_t hi, const char* what) {
  int32_t v = b.se();
  if (v < lo || v > hi) fail(std::string(what) + " out of range");
  return v;
}

// --- parameter sets -----------------------------------------------------------

struct ScalingList {
  uint8_t sl[4][6][64];  // [sizeId][matrixId][up-right diagonal position]
  uint8_t dc[4][6];      // sizeIds 2 and 3
  void set_default() {
    for (int m = 0; m < 6; m++) {
      for (int i = 0; i < 16; i++) sl[0][m][i] = 16;
      for (int s = 1; s < 4; s++) {
        std::memcpy(sl[s][m], m < 3 ? kDefIntra : kDefInter, 64);
        dc[s][m] = 16;
      }
    }
  }
  void parse(Bits& b) {
    set_default();
    for (int s = 0; s < 4; s++)
      for (int m = 0; m < 6; m += s == 3 ? 3 : 1) {
        const int n = std::min(64, 1 << (4 + (s << 1)));
        if (!b.u1()) {  // scaling_list_pred_mode_flag
          uint32_t delta = ue_max(b, (uint32_t)m / (s == 3 ? 3 : 1), "scaling_list_pred_matrix_id_delta");
          if (delta) {
            int ref = m - (int)delta * (s == 3 ? 3 : 1);
            std::memcpy(sl[s][m], sl[s][ref], n);
            dc[s][m] = dc[s][ref];
          } else {
            if (s == 0) std::memset(sl[s][m], 16, 16);
            else std::memcpy(sl[s][m], m < 3 ? kDefIntra : kDefInter, 64);
            dc[s][m] = 16;
          }
        } else {
          int next = 8;
          if (s > 1) {
            next = se_range(b, -7, 247, "scaling_list_dc_coef_minus8") + 8;
            dc[s][m] = (uint8_t)next;
          }
          for (int i = 0; i < n; i++) {
            int delta = se_range(b, -128, 127, "scaling_list_delta_coef");
            next = (next + delta + 256) % 256;
            sl[s][m][i] = (uint8_t)next;
          }
          if (s <= 1) dc[s][m] = 16;
        }
      }
    // the 32x32 chroma matrices (used only by 4:4:4) from the 16x16 ones
    for (int m : {1, 2, 4, 5}) {
      std::memcpy(sl[3][m], sl[2][m], 64);
      dc[3][m] = dc[2][m];
    }
  }
  // ScalingFactor (7.4.5) of an n x n block, raster
  void factors(int log2, int matrix, uint8_t* out) const {
    const int n = 1 << log2, s = log2 - 2;
    if (s == 0) {
      for (int i = 0; i < 16; i++) {
        int p = kScan.s[2][0][i];
        out[(p >> 4) * 4 + (p & 15)] = sl[0][matrix][i];
      }
      return;
    }
    const int rep = n / 8;
    for (int i = 0; i < 64; i++) {
      int p = kScan.s[3][0][i], x = p & 15, y = p >> 4;
      for (int j = 0; j < rep; j++)
        for (int k = 0; k < rep; k++) out[(y * rep + j) * n + x * rep + k] = sl[s][matrix][i];
    }
    if (s >= 2) out[0] = dc[s][matrix];
  }
};

struct StRps {
  int num_neg = 0, num_pos = 0;
  int delta[32] = {};  // S0 (decreasing), then S1 (increasing)
  bool used[32] = {};
  int num() const { return num_neg + num_pos; }
};

// st_ref_pic_set (7.3.7) as FFmpeg derives an inter-predicted one
// (ff_hevc_decode_short_term_rps: the entries sorted)
void parse_st_rps(Bits& b, StRps& r, int idx, const std::vector<StRps>& sets, bool in_slice) {
  bool pred = idx != 0 && b.u1();
  if (pred) {
    int delta_idx = 1;
    if (in_slice) delta_idx = (int)ue_max(b, (uint32_t)idx - 1, "delta_idx_minus1") + 1;
    const StRps& ref = sets[idx - delta_idx];
    int sign = b.u1();
    int abs_delta = (int)ue_max(b, 32767, "abs_delta_rps_minus1") + 1;
    int drps = (1 - 2 * sign) * abs_delta;
    int k = 0, neg = 0;
    for (int j = 0; j <= ref.num(); j++) {
      bool used = b.u1();
      bool use_delta = used || b.u1();
      if (!use_delta) continue;
      int dpoc = (j < ref.num() ? ref.delta[j] : 0) + drps;
      if (k >= 32) fail("short-term RPS too large");
      r.delta[k] = dpoc;
      r.used[k] = used;
      if (dpoc < 0) neg++;
      k++;
    }
    if (k > 16) fail("short-term RPS too large");
    // increasing order, then the negative ones reversed
    for (int i = 1; i < k; i++)
      for (int j = i; j > 0 && r.delta[j] < r.delta[j - 1]; j--) {
        std::swap(r.delta[j], r.delta[j - 1]);
        std::swap(r.used[j], r.used[j - 1]);
      }
    std::reverse(r.delta, r.delta + neg);
    std::reverse(r.used, r.used + neg);
    r.num_neg = neg;
    r.num_pos = k - neg;
  } else {
    r.num_neg = (int)ue_max(b, 16, "num_negative_pics");
    r.num_pos = (int)ue_max(b, 16 - r.num_neg, "num_positive_pics");
    int poc = 0;
    for (int i = 0; i < r.num_neg; i++) {
      poc -= (int)ue_max(b, 32767, "delta_poc_s0_minus1") + 1;
      r.delta[i] = poc;
      r.used[i] = b.u1();
    }
    poc = 0;
    for (int i = 0; i < r.num_pos; i++) {
      poc += (int)ue_max(b, 32767, "delta_poc_s1_minus1") + 1;
      r.delta[r.num_neg + i] = poc;
      r.used[r.num_neg + i] = b.u1();
    }
  }
}

void profile_tier_level(Bits& b, int max_sub_layers_minus1, int* profile_idc) {
  b.u(2);
  b.u1();
  int idc = (int)b.u(5);
  uint32_t compat = b.u(32);
  b.skip(4 + 43 + 1);
  b.u(8);  // general_level_idc
  if (profile_idc) {
    *profile_idc = idc;
    if (idc == 0) *profile_idc = (compat >> 30) & 1 ? 1 : (compat >> 28) & 1 ? 3 : 0;
  }
  bool prof[8], lvl[8];
  for (int i = 0; i < max_sub_layers_minus1; i++) {
    prof[i] = b.u1();
    lvl[i] = b.u1();
  }
  if (max_sub_layers_minus1 > 0)
    for (int i = max_sub_layers_minus1; i < 8; i++) b.u(2);
  for (int i = 0; i < max_sub_layers_minus1; i++) {
    if (prof[i]) b.skip(88);
    if (lvl[i]) b.u(8);
  }
}

void hrd_parameters(Bits& b, bool common, int max_sub_layers_minus1) {
  bool nal = false, vcl = false, sub_pic = false;
  if (common) {
    nal = b.u1();
    vcl = b.u1();
    if (nal || vcl) {
      sub_pic = b.u1();
      if (sub_pic) b.skip(8 + 5 + 1 + 5);
      b.skip(8);
      if (sub_pic) b.skip(4);
      b.skip(15);
    }
  }
  for (int i = 0; i <= max_sub_layers_minus1; i++) {
    bool fixed_general = b.u1(), fixed_cvs = true, low_delay = false;
    if (!fixed_general) fixed_cvs = b.u1();
    if (fixed_cvs) b.ue();
    else low_delay = b.u1();
    int cpb_cnt = 1;
    if (!low_delay) cpb_cnt = (int)ue_max(b, 31, "cpb_cnt_minus1") + 1;
    for (int k = 0; k < (int)nal + (int)vcl; k++)
      for (int j = 0; j < cpb_cnt; j++) {
        b.ue();
        b.ue();
        if (sub_pic) {
          b.ue();
          b.ue();
        }
        b.u1();
      }
  }
}

struct Sps {
  bool valid = false;
  int vps_id = 0, max_sub_layers = 1, profile = 1;
  int width = 0, height = 0;
  int conf[4] = {0, 0, 0, 0};  // left, right, top, bottom in luma samples
  int log2_max_poc_lsb = 4;
  int max_dec_pic_buffering = 1, num_reorder = 0, max_latency_plus1 = 0;
  int log2_min_cb = 3, log2_ctb = 4, log2_min_tb = 2, log2_max_tb = 4;
  int max_th_inter = 0, max_th_intra = 0;
  bool scaling_enabled = false;
  ScalingList sl;
  bool amp = false, sao = false, pcm = false, pcm_lf_disabled = false;
  int pcm_bd_y = 8, pcm_bd_c = 8, log2_min_pcm = 3, log2_max_pcm = 3;
  std::vector<StRps> st_rps;
  bool long_term = false;
  int num_lt_sps = 0;
  int lt_lsb_sps[33] = {};
  bool lt_used_sps[33] = {};
  bool tmvp = false, strong_intra = false;
  bool full_range = false;
  int matrix = 2;
  // derived
  int ctb_w = 0, ctb_h = 0;
  std::vector<uint8_t> raw;  // the RBSP, to tell a repeat from a new SPS
  int gen = 0;               // the table entry's generation: new content, a new number
  int ctb_size() const { return 1 << log2_ctb; }
};

struct Pps {
  bool valid = false;
  int sps_id = 0;
  bool dependent_slices = false, output_flag_present = false;
  int extra_bits = 0;
  bool sign_hiding = false, cabac_init_present = false;
  int num_ref_default[2] = {1, 1};
  int init_qp = 26;
  bool constrained_intra = false, transform_skip = false, cu_qp_delta = false;
  int diff_cu_qp_delta_depth = 0;
  int cb_qp_offset = 0, cr_qp_offset = 0;
  bool slice_chroma_offsets = false, weighted_pred = false, weighted_bipred = false;
  bool bypass = false, tiles = false, wpp = false;
  int tile_cols = 1, tile_rows = 1;
  bool uniform = true;
  std::vector<int> col_w, row_h;  // explicit, in CTBs
  bool lf_across_tiles = true, lf_across_slices = false;
  bool deblock_override = false, deblock_disabled = false;
  int beta_offset = 0, tc_offset = 0;
  bool scaling_present = false;
  ScalingList sl;
  bool lists_mod = false;
  int log2_par_mrg = 2;
  bool slice_ext = false;
};


struct SliceHeader {
  bool first = true, no_output_prior = false, dependent = false;
  int pps_id = 0, segment_addr = 0, slice_addr = 0;  // in CTBs (raster)
  int type = 2;  // 0 B, 1 P, 2 I
  int nal_type = 0;
  bool pic_output = true;
  int poc_lsb = 0;
  StRps rps;
  int num_lt = 0;
  int lt_poc[32] = {};
  bool lt_used[32] = {}, lt_msb[32] = {};
  int lt_cycle[32] = {};
  bool tmvp = false, sao_luma = false, sao_chroma = false;
  int num_ref[2] = {0, 0};
  bool mod[2] = {false, false};
  int entry[2][16] = {};
  bool mvd_l1_zero = false, cabac_init = false, col_from_l0 = true;
  int col_ref = 0;
  int luma_wd = 0, chroma_wd = 0;
  int lw[2][16] = {}, lo[2][16] = {}, cw[2][16][2] = {}, co[2][16][2] = {};
  int max_merge = 5;
  int qp = 26, cb_offset = 0, cr_offset = 0;
  bool deblock_disabled = false;
  int beta_offset = 0, tc_offset = 0;
  bool lf_across_slices = false;
  int num_entry = 0;
};

struct Mvf {
  int16_t mv[2][2];
  int poc[2];     // the reference pictures' POCs (identity in the DPB)
  int8_t ref[2];  // reference indices
  uint8_t pred;   // bit 0: list 0, bit 1: list 1; 0: intra (or none)
  uint8_t lt;     // bit per list: the reference is long-term
};

struct Pic {
  Frame f;
  int poc = 0, seq = 0;
  // what its SPS says of its output: window (left, top), size and range
  int crop_x = 0, crop_y = 0, out_w = 0, out_h = 0;
  bool full_range = false;
  bool ref_st = false, ref_lt = false, output = false;
  int64_t tag = -1;
  std::vector<Mvf> mvf;  // per 4x4 luma block
};

struct SaoParams {
  int type[3] = {0, 0, 0}, band[3] = {0, 0, 0}, eo[3] = {0, 0, 0};
  int off[3][4] = {{0}};
};

class Decoder : public FrameDecoder {
 public:
  int nal_len = 0;  // NAL length field size; 0 for Annex B
  Frame out;        // the last picture put out

  void open(const uint8_t* p, int64_t n);
  bool decode(const uint8_t* p, int64_t n, int64_t tag) override;
  bool flush() override;
  const Frame* frame() const override { return have_frame ? &out : nullptr; }

 private:
  std::vector<uint8_t> vps_raw[16];  // empty: no VPS of that id
  Sps sps[16];
  int sps_gen = 0;
  Pps pps[64];
  int ps_nals = 0, pic_ps_nals = 0;
  // the picture being decoded, with copies of its parameter sets
  Sps S;
  Pps P;
  std::shared_ptr<Pic> cur;
  std::vector<std::shared_ptr<Pic>> dpb;
  std::deque<std::shared_ptr<Pic>> queue;  // put out, waiting for the caller
  int64_t cur_tag = -1;
  int seq = 0;
  bool first_pic = true, after_eos = false;
  int prev_tid0_poc = 0, cur_poc = 0;
  // FFmpeg's RASL gate (hevcdec.c): max_ra, the POC at or below which a
  // RASL picture is skipped (INT_MAX: not yet set by an IRAP picture), and
  // the last IRAP picture's NoRaslOutputFlag; skip_pic: the picture whose
  // first slice was skipped
  int max_ra = INT_MAX;
  bool no_rasl_out = false, skip_pic = false;
  int out_w = -1, out_h = -1;
  bool cur_irap = false;
  // picture layout
  int W = 0, H = 0, W4 = 0, H4 = 0, ctb_w = 0, ctb_h = 0, nctb = 0, log2ctb = 4;
  std::vector<int> rs2ts, ts2rs, tile_id, col_bd, row_bd, zs;
  std::vector<int> ctb_sh, ctb_slice;  // the CTB's slice segment header, SliceAddrRs
  std::vector<uint8_t> flags4, depth4, ipm4, bs_v, bs_h;
  std::vector<int8_t> qp4;
  std::vector<SaoParams> sao;
  std::vector<SliceHeader> headers;
  uint8_t factors[2][3][4][32 * 32];  // ScalingFactor [inter][cIdx][log2 - 2]
  enum { kIsIntra = 1, kIsSkip = 2, kIsPcm = 4, kIsBypass = 8, kIsNz = 16 };  // flags4

  // the slice segment being decoded
  SliceHeader sh;
  int sh_idx = 0;
  Pic* list[2][16];
  Bits* B = nullptr;
  uint32_t range = 0, offset = 0;
  uint8_t st[kNumCtx], mps[kNumCtx];
  uint8_t wpp_st[kNumCtx], wpp_mps[kNumCtx];
  bool wpp_saved = false;
  int ctb_addr_ts = 0;
  int qg_pred = 26, last_cu_qp = 26, qp_y = 26, cu_qp_delta = 0;
  bool first_qg = true, qp_delta_coded = false;
  int log2_qg = 4;
  // the coding unit being decoded
  int cu_x = 0, cu_y = 0, cu_log2 = 3;
  bool cu_intra = false, cu_bypass = false, cu_merge2n = false;
  int part = 0, intra_chroma = 0;
  int16_t coef[32 * 32], res[32 * 32];

  void nals(const uint8_t* p, int64_t n);
  void nal(const uint8_t* p, size_t n);
  void parse_vps(Bits& b);
  void drop_sps(int id);
  void parse_sps(Bits& b);
  void parse_pps(Bits& b);
  void slice(Bits& b, int type, int tid);
  void parse_slice_header(Bits& b, SliceHeader& h, int nal_type);
  int picture_poc(const SliceHeader& h, bool new_cvs) const;
  void start_picture(const SliceHeader& h, int nal_type, int tid, bool new_cvs);
  void finish_picture();
  void build_lists();
  void layout();
  void bump(int max_out, int max_dpb, bool discard, int generated = 0);
  void emit(const std::shared_ptr<Pic>& p);
  // entropy decoding
  void init_contexts();
  void init_engine();
  int dec(int ctx);
  int bypass();
  int bypass_bits(int n);
  int terminate();
  // availability (6.4.1) of (xn, yn) from (xc, yc)
  bool avail(int xc, int yc, int xn, int yn) const;
  int idx4(int x, int y) const { return (y >> 2) * W4 + (x >> 2); }
  bool col_start(int rx) const {  // a tile column starts at CTB column rx
    for (int c : col_bd)
      if (c == rx) return true;
    return false;
  }
  // slice data
  void slice_data();
  void sao_syntax(int rx, int ry, int ctb_rs);
  void quadtree(int x0, int y0, int log2, int depth);
  void coding_unit(int x0, int y0, int log2);
  void set_qp();
  void pcm_sample(int x0, int y0, int log2);
  void prediction_unit(int x, int y, int w, int h, int part_idx, bool skip);
  void merge(int xp, int yp, int w, int h, int part_idx, int merge_idx, Mvf& out);
  void amvp(int xp, int yp, int w, int h, int part_idx, int X, int ref_idx, int16_t* mvp_out,
            int mvp_flag);
  bool temporal(int xp, int yp, int w, int h, int ref_idx, int X, int16_t* mv);
  bool pb_avail(int xc, int yc, int w, int h, int part_idx, int xn, int yn) const;
  void mc(int xp, int yp, int w, int h, const Mvf& m);
  void transform_tree(int x0, int y0, int xb, int yb, int log2, int depth, int blk, int max_depth,
                      bool intra_split, int parent_cb, int parent_cr);
  void transform_unit(int x0, int y0, int xb, int yb, int log2, int blk, bool cbf_l,
                      int cbf_cb, int cbf_cr);
  void residual(int x0, int y0, int log2, int c, int pred_mode);
  void intra(int x0, int y0, int log2, int c, int mode);
  void cip_references(int x0, int y0, int log2, int c, uint8_t* ref, uint8_t* av) const;
  int luma_mode_at(int x, int y) const { return ipm4[idx4(x, y)]; }
  int chroma_mode(int luma) const;
  void edges(int x0, int y0, int w, int h, bool tu);
  int bs_of(int xp, int yp, int xq, int yq, bool tu) const;
  // loop filters
  std::vector<uint8_t> sao_pre[3], sao_done[3];
  void loop_filters();
  void hls_filter(int x, int y);
  void deblock_ctb(int rx, int ry);
  void sao_ctb(int rx, int ry);
};

// --- parameter sets -----------------------------------------------------------

// FFmpeg keeps a parameter set sent again unchanged; one whose content
// changes drops the sets that name it (an SPS its PPSs, a VPS its SPSs)
void Decoder::drop_sps(int id) {
  if (!sps[id].valid) return;
  for (auto& q : pps)
    if (q.valid && q.sps_id == id) q.valid = false;
  sps[id].valid = false;
}

void Decoder::parse_vps(Bits& b) {
  int id = (int)b.u(4);
  std::vector<uint8_t> raw(b.buf.begin(), b.buf.begin() + b.end / 8);
  if (vps_raw[id] == raw) return;
  for (int i = 0; i < 16; i++)
    if (sps[i].valid && sps[i].vps_id == id) drop_sps(i);
  vps_raw[id] = raw;
}

void vui(Bits& b, Sps& s, int max_sub_layers_minus1) {
  if (b.u1() && b.u(8) == 255) b.skip(32);  // aspect ratio
  if (b.u1()) b.u1();                        // overscan
  if (b.u1()) {                              // video_signal_type
    b.u(3);
    s.full_range = b.u1();
    if (b.u1()) {
      b.u(8);
      b.u(8);
      s.matrix = (int)b.u(8);
      if (s.matrix == 8 || (s.matrix >= 10 && s.matrix <= 15))
        refuse("matrix_coeffs " + std::to_string(s.matrix) + " (swscale converts no such frame)");
    }
  }
  if (b.u1()) {  // chroma_loc_info
    b.ue();
    b.ue();
  }
  b.u1();  // neutral_chroma_indication_flag
  if (b.u1()) refuse("field-coded sequences (field_seq_flag)");
  b.u1();  // frame_field_info_present_flag
  if (b.u1())
    for (int i = 0; i < 4; i++) b.ue();  // default display window (FFmpeg: not applied)
  if (b.u1()) {                          // timing
    b.skip(64);
    if (b.u1()) b.ue();
    if (b.u1()) hrd_parameters(b, true, max_sub_layers_minus1);
  }
  if (b.u1()) {  // bitstream_restriction
    b.skip(3);
    for (int i = 0; i < 5; i++) b.ue();
  }
}

void Decoder::parse_sps(Bits& b) {
  Sps s;
  s.vps_id = (int)b.u(4);
  int msl = (int)b.u(3);
  if (msl > 6) fail("sps_max_sub_layers_minus1 out of range");
  s.max_sub_layers = msl + 1;
  b.u1();
  profile_tier_level(b, msl, &s.profile);
  int id = (int)ue_max(b, 15, "sps_seq_parameter_set_id");
  if (vps_raw[s.vps_id].empty()) fail("VPS " + std::to_string(s.vps_id) + " does not exist");
  static const char* kNames[] = {"", "Main", "Main 10", "Main Still Picture",
                                 "Format Range Extensions", "High Throughput 4:4:4",
                                 "Multiview Main", "Scalable Main", "3D Main",
                                 "Screen Content Coding", "Scalable Format Range Extensions",
                                 "High Throughput Screen Content Coding"};
  if (s.profile != 1 && s.profile != 3)
    refuse("the " + std::string(s.profile > 0 && s.profile < 12 ? kNames[s.profile] : "unknown") +
           " profile (general_profile_idc " + std::to_string(s.profile) + ")");
  int cf = (int)ue_max(b, 3, "chroma_format_idc");
  if (cf == 3) b.u1();
  if (cf != 1) refuse("chroma_format_idc " + std::to_string(cf) + " (only 4:2:0)");
  s.width = (int)ue_max(b, 16888, "pic_width_in_luma_samples");
  s.height = (int)ue_max(b, 16888, "pic_height_in_luma_samples");
  if (b.u1()) {
    for (int i = 0; i < 4; i++) s.conf[i] = 2 * (int)ue_max(b, 8444, "conformance window");
    if (s.conf[0] + s.conf[1] >= s.width || s.conf[2] + s.conf[3] >= s.height)
      fail("conformance window out of range");
  }
  int bdl = (int)ue_max(b, 8, "bit_depth_luma_minus8") + 8;
  int bdc = (int)ue_max(b, 8, "bit_depth_chroma_minus8") + 8;
  if (bdl != 8 || bdc != 8) refuse("bit depth " + std::to_string(std::max(bdl, bdc)) + " (only 8 bits)");
  s.log2_max_poc_lsb = (int)ue_max(b, 12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
  bool ordering = b.u1();
  for (int i = ordering ? 0 : msl; i <= msl; i++) {
    s.max_dec_pic_buffering = (int)ue_max(b, 15, "sps_max_dec_pic_buffering_minus1") + 1;
    s.num_reorder = (int)ue_max(b, 15, "sps_max_num_reorder_pics");
    s.max_latency_plus1 = (int)b.ue();
  }
  s.log2_min_cb = (int)ue_max(b, 3, "log2_min_luma_coding_block_size_minus3") + 3;
  s.log2_ctb = s.log2_min_cb + (int)ue_max(b, 3, "log2_diff_max_min_luma_coding_block_size");
  s.log2_min_tb = (int)ue_max(b, 3, "log2_min_luma_transform_block_size_minus2") + 2;
  s.log2_max_tb = s.log2_min_tb + (int)ue_max(b, 3, "log2_diff_max_min_luma_transform_block_size");
  if (s.log2_ctb < 4 || s.log2_ctb > 6 || s.log2_max_tb > 5 || s.log2_max_tb > s.log2_ctb ||
      s.log2_min_tb >= s.log2_min_cb)
    fail("block sizes out of range");
  if (s.width % (1 << s.log2_min_cb) || s.height % (1 << s.log2_min_cb) || !s.width || !s.height)
    fail("picture size not a multiple of the minimum coding block");
  s.max_th_inter = (int)ue_max(b, 4, "max_transform_hierarchy_depth_inter");
  s.max_th_intra = (int)ue_max(b, 4, "max_transform_hierarchy_depth_intra");
  s.scaling_enabled = b.u1();
  s.sl.set_default();
  if (s.scaling_enabled && b.u1()) s.sl.parse(b);
  s.amp = b.u1();
  s.sao = b.u1();
  s.pcm = b.u1();
  if (s.pcm) {
    s.pcm_bd_y = (int)b.u(4) + 1;
    s.pcm_bd_c = (int)b.u(4) + 1;
    s.log2_min_pcm = (int)ue_max(b, 2, "log2_min_pcm_luma_coding_block_size_minus3") + 3;
    s.log2_max_pcm = s.log2_min_pcm + (int)ue_max(b, 2, "log2_diff_max_min_pcm");
    if (s.pcm_bd_y > 8 || s.pcm_bd_c > 8 || s.log2_max_pcm > 5) fail("PCM parameters out of range");
    s.pcm_lf_disabled = b.u1();
  }
  int nst = (int)ue_max(b, 64, "num_short_term_ref_pic_sets");
  s.st_rps.resize(nst);
  for (int i = 0; i < nst; i++) parse_st_rps(b, s.st_rps[i], i, s.st_rps, false);
  s.long_term = b.u1();
  if (s.long_term) {
    s.num_lt_sps = (int)ue_max(b, 32, "num_long_term_ref_pics_sps");
    for (int i = 0; i < s.num_lt_sps; i++) {
      s.lt_lsb_sps[i] = (int)b.u(s.log2_max_poc_lsb);
      s.lt_used_sps[i] = b.u1();
    }
  }
  s.tmvp = b.u1();
  s.strong_intra = b.u1();
  if (b.u1()) vui(b, s, msl);
  if (b.u1()) {  // sps_extension_present_flag
    if (b.u1()) refuse("the range extension (sps_range_extension_flag)");
    if (b.u1()) refuse("the multilayer extension (sps_multilayer_extension_flag)");
    if (b.u1()) refuse("the 3D extension (sps_3d_extension_flag)");
    if (b.u1()) refuse("the screen content coding extension (sps_scc_extension_flag)");
    b.u(4);
  }
  s.ctb_w = (s.width + s.ctb_size() - 1) >> s.log2_ctb;
  s.ctb_h = (s.height + s.ctb_size() - 1) >> s.log2_ctb;
  s.valid = true;
  s.raw.assign(b.buf.begin(), b.buf.begin() + b.end / 8);
  if (sps[id].valid && sps[id].raw == s.raw) return;
  drop_sps(id);
  s.gen = ++sps_gen;
  sps[id] = s;
}

void Decoder::parse_pps(Bits& b) {
  Pps p;
  int id = (int)ue_max(b, 63, "pps_pic_parameter_set_id");
  p.sps_id = (int)ue_max(b, 15, "pps_seq_parameter_set_id");
  p.dependent_slices = b.u1();
  p.output_flag_present = b.u1();
  p.extra_bits = (int)b.u(3);
  p.sign_hiding = b.u1();
  p.cabac_init_present = b.u1();
  p.num_ref_default[0] = (int)ue_max(b, 14, "num_ref_idx_l0_default_active_minus1") + 1;
  p.num_ref_default[1] = (int)ue_max(b, 14, "num_ref_idx_l1_default_active_minus1") + 1;
  p.init_qp = 26 + se_range(b, -26, 25, "init_qp_minus26");
  p.constrained_intra = b.u1();
  p.transform_skip = b.u1();
  p.cu_qp_delta = b.u1();
  if (p.cu_qp_delta) p.diff_cu_qp_delta_depth = (int)ue_max(b, 3, "diff_cu_qp_delta_depth");
  p.cb_qp_offset = se_range(b, -12, 12, "pps_cb_qp_offset");
  p.cr_qp_offset = se_range(b, -12, 12, "pps_cr_qp_offset");
  p.slice_chroma_offsets = b.u1();
  p.weighted_pred = b.u1();
  p.weighted_bipred = b.u1();
  p.bypass = b.u1();
  p.tiles = b.u1();
  p.wpp = b.u1();
  if (p.tiles) {
    p.tile_cols = (int)ue_max(b, 19, "num_tile_columns_minus1") + 1;
    p.tile_rows = (int)ue_max(b, 21, "num_tile_rows_minus1") + 1;
    p.uniform = b.u1();
    if (!p.uniform) {
      for (int i = 0; i < p.tile_cols - 1; i++) p.col_w.push_back((int)ue_max(b, 1023, "column_width_minus1") + 1);
      for (int i = 0; i < p.tile_rows - 1; i++) p.row_h.push_back((int)ue_max(b, 1023, "row_height_minus1") + 1);
    }
    p.lf_across_tiles = b.u1();
  }
  p.lf_across_slices = b.u1();
  if (b.u1()) {  // deblocking_filter_control_present_flag
    p.deblock_override = b.u1();
    p.deblock_disabled = b.u1();
    if (!p.deblock_disabled) {
      p.beta_offset = se_range(b, -6, 6, "pps_beta_offset_div2");
      p.tc_offset = se_range(b, -6, 6, "pps_tc_offset_div2");
    }
  }
  p.scaling_present = b.u1();
  if (p.scaling_present) p.sl.parse(b);
  p.lists_mod = b.u1();
  p.log2_par_mrg = (int)ue_max(b, 4, "log2_parallel_merge_level_minus2") + 2;
  p.slice_ext = b.u1();
  if (b.u1()) {  // pps_extension_present_flag
    if (b.u1()) refuse("the range extension (pps_range_extension_flag)");
    if (b.u1()) refuse("the multilayer extension (pps_multilayer_extension_flag)");
    if (b.u1()) refuse("the 3D extension (pps_3d_extension_flag)");
    if (b.u1()) refuse("the screen content coding extension (pps_scc_extension_flag)");
  }
  p.valid = true;
  pps[id] = p;
}

// --- slice headers ---------------------------------------------------------------

void Decoder::parse_slice_header(Bits& b, SliceHeader& h, int nal_type) {
  h.first = b.u1();
  if (nal_type >= 16 && nal_type <= 23) h.no_output_prior = b.u1();
  h.pps_id = (int)ue_max(b, 63, "slice_pic_parameter_set_id");
  if (!h.first && (!cur || headers.empty()))
    fail("a slice segment without its picture's first slice segment");
  const Pps& p = h.first ? pps[h.pps_id] : P;
  if (!p.valid) fail("PPS " + std::to_string(h.pps_id) + " does not exist");
  if (!h.first && h.pps_id != headers.front().pps_id) fail("slices of one picture name different PPSs");
  const Sps& s = h.first ? sps[p.sps_id] : S;
  if (!s.valid) fail("SPS " + std::to_string(p.sps_id) + " does not exist");
  const int nctb_s = s.ctb_w * s.ctb_h;
  h.dependent = false;
  h.segment_addr = 0;
  if (!h.first) {
    if (p.dependent_slices) h.dependent = b.u1();
    h.segment_addr = (int)b.u(ceil_log2(nctb_s));
    if (h.segment_addr >= nctb_s) fail("slice_segment_address out of range");
  }
  if (h.dependent) {
    // the rest of the header is the slice's (its last independent segment)
    if (headers.empty()) fail("a dependent slice segment starts the picture");
    SliceHeader prev = headers.back();
    prev.first = h.first;
    prev.dependent = true;
    prev.segment_addr = h.segment_addr;
    prev.no_output_prior = h.no_output_prior;
    h = prev;
  } else {
    h.slice_addr = h.segment_addr;
    b.skip(p.extra_bits);
    int t = (int)ue_max(b, 2, "slice_type");
    h.type = t;
    h.pic_output = !p.output_flag_present || b.u1();
    h.nal_type = nal_type;
    bool idr = nal_type == 19 || nal_type == 20;
    h.num_lt = 0;
    h.rps = StRps();
    h.tmvp = false;
    if (!idr) {
      h.poc_lsb = (int)b.u(s.log2_max_poc_lsb);
      if (!b.u1()) {
        parse_st_rps(b, h.rps, (int)s.st_rps.size(), s.st_rps, true);
      } else {
        if (s.st_rps.empty()) fail("no short-term RPS in the SPS");
        int idx = (int)b.u(ceil_log2((int)s.st_rps.size()));
        if (idx >= (int)s.st_rps.size()) fail("short_term_ref_pic_set_idx out of range");
        h.rps = s.st_rps[idx];
      }
      if (s.long_term) {
        int nsps = 0;
        if (s.num_lt_sps > 0) nsps = (int)ue_max(b, s.num_lt_sps, "num_long_term_sps");
        int npics = (int)ue_max(b, 32 - nsps, "num_long_term_pics");
        h.num_lt = nsps + npics;
        if (h.num_lt + h.rps.num() > 16) fail("too many reference pictures");
        int msb = 0;
        for (int i = 0; i < h.num_lt; i++) {
          if (i < nsps) {
            int k = s.num_lt_sps > 1 ? (int)b.u(ceil_log2(s.num_lt_sps)) : 0;
            if (k >= s.num_lt_sps) fail("lt_idx_sps out of range");
            h.lt_poc[i] = s.lt_lsb_sps[k];
            h.lt_used[i] = s.lt_used_sps[k];
          } else {
            h.lt_poc[i] = (int)b.u(s.log2_max_poc_lsb);
            h.lt_used[i] = b.u1();
          }
          h.lt_msb[i] = b.u1();
          h.lt_cycle[i] = 0;
          if (h.lt_msb[i]) {
            // FFmpeg: the cycle adds up over the entries that carry one
            // (the standard restarts it at entry num_long_term_sps)
            int cycle = (int)ue_max(b, 1 << 24, "delta_poc_msb_cycle_lt");
            if (i && i != nsps) cycle += msb;
            msb = cycle;
            h.lt_cycle[i] = cycle;
          }
        }
      }
      if (s.tmvp) h.tmvp = b.u1();
    } else {
      h.poc_lsb = 0;
    }
    h.sao_luma = h.sao_chroma = false;
    if (s.sao) {
      h.sao_luma = b.u1();
      h.sao_chroma = b.u1();
    }
    h.num_ref[0] = h.num_ref[1] = 0;
    h.mod[0] = h.mod[1] = false;
    h.mvd_l1_zero = h.cabac_init = false;
    h.col_from_l0 = true;
    h.col_ref = 0;
    h.max_merge = 5;
    if (h.type != 2) {
      h.num_ref[0] = p.num_ref_default[0];
      h.num_ref[1] = h.type == 0 ? p.num_ref_default[1] : 0;
      if (b.u1()) {
        h.num_ref[0] = (int)ue_max(b, 14, "num_ref_idx_l0_active_minus1") + 1;
        if (h.type == 0) h.num_ref[1] = (int)ue_max(b, 14, "num_ref_idx_l1_active_minus1") + 1;
      }
      int total = 0;
      for (int i = 0; i < h.rps.num(); i++) total += h.rps.used[i];
      for (int i = 0; i < h.num_lt; i++) total += h.lt_used[i];
      if (total == 0) fail("a P or B slice without reference pictures");
      if (p.lists_mod && total > 1) {
        for (int l = 0; l < (h.type == 0 ? 2 : 1); l++) {
          h.mod[l] = b.u1();
          if (h.mod[l])
            for (int i = 0; i < h.num_ref[l]; i++) {
              h.entry[l][i] = (int)b.u(ceil_log2(total));
              if (h.entry[l][i] >= total) fail("list_entry out of range");
            }
        }
      }
      if (h.type == 0) h.mvd_l1_zero = b.u1();
      if (p.cabac_init_present) h.cabac_init = b.u1();
      if (h.tmvp) {
        if (h.type == 0) h.col_from_l0 = b.u1();
        int n = h.num_ref[h.col_from_l0 ? 0 : 1];
        if (n > 1) h.col_ref = (int)ue_max(b, n - 1, "collocated_ref_idx");
      }
      if ((p.weighted_pred && h.type == 1) || (p.weighted_bipred && h.type == 0)) {
        h.luma_wd = (int)ue_max(b, 7, "luma_log2_weight_denom");
        h.chroma_wd = h.luma_wd + se_range(b, -7, 7, "delta_chroma_log2_weight_denom");
        if (h.chroma_wd < 0 || h.chroma_wd > 7) fail("chroma weight denominator out of range");
        for (int l = 0; l < (h.type == 0 ? 2 : 1); l++) {
          bool lf[16], cf[16];
          for (int i = 0; i < h.num_ref[l]; i++) lf[i] = b.u1();
          for (int i = 0; i < h.num_ref[l]; i++) cf[i] = b.u1();
          for (int i = 0; i < h.num_ref[l]; i++) {
            h.lw[l][i] = 1 << h.luma_wd;
            h.lo[l][i] = 0;
            if (lf[i]) {
              h.lw[l][i] += se_range(b, -128, 127, "delta_luma_weight");
              h.lo[l][i] = se_range(b, -128, 127, "luma_offset");
            }
            for (int j = 0; j < 2; j++) {
              h.cw[l][i][j] = 1 << h.chroma_wd;
              h.co[l][i][j] = 0;
              if (cf[i]) {
                h.cw[l][i][j] += se_range(b, -128, 127, "delta_chroma_weight");
                int d = se_range(b, -512, 511, "delta_chroma_offset");
                h.co[l][i][j] = clip3(-128, 127, (128 + d - ((128 * h.cw[l][i][j]) >> h.chroma_wd)));
              }
            }
          }
        }
      }
      h.max_merge = 5 - (int)ue_max(b, 4, "five_minus_max_num_merge_cand");
    }
    h.qp = p.init_qp + se_range(b, -64, 64, "slice_qp_delta");
    if (h.qp < 0 || h.qp > 51) fail("slice QP out of range");
    h.cb_offset = h.cr_offset = 0;
    if (p.slice_chroma_offsets) {
      h.cb_offset = se_range(b, -12, 12, "slice_cb_qp_offset");
      h.cr_offset = se_range(b, -12, 12, "slice_cr_qp_offset");
    }
    bool override = p.deblock_override && b.u1();
    h.deblock_disabled = p.deblock_disabled;
    h.beta_offset = p.beta_offset;
    h.tc_offset = p.tc_offset;
    if (override) {
      h.deblock_disabled = b.u1();
      if (!h.deblock_disabled) {
        h.beta_offset = se_range(b, -6, 6, "slice_beta_offset_div2");
        h.tc_offset = se_range(b, -6, 6, "slice_tc_offset_div2");
      }
    }
    h.lf_across_slices = p.lf_across_slices;
    if (p.lf_across_slices && (h.sao_luma || h.sao_chroma || !h.deblock_disabled))
      h.lf_across_slices = b.u1();
  }
  h.num_entry = 0;
  if (p.tiles || p.wpp) {
    h.num_entry = (int)ue_max(b, (uint32_t)nctb_s, "num_entry_point_offsets");
    if (h.num_entry > 0) {
      int len = (int)ue_max(b, 31, "offset_len_minus1") + 1;
      for (int i = 0; i < h.num_entry; i++) b.u(len);
    }
  }
  if (p.slice_ext) {
    int n = (int)ue_max(b, 256, "slice_segment_header_extension_length");
    b.skip((size_t)n * 8);
  }
  if (!b.u1()) fail("slice header not byte-aligned by a one bit");
  while (b.pos & 7)
    if (b.u1()) fail("slice header alignment bits not zero");
}

// --- NAL units and pictures -----------------------------------------------------

// hvcC (ISO/IEC 14496-15 8.3.3.1): the NAL length size and the parameter
// set arrays; anything else (or nothing) means Annex B samples
void Decoder::open(const uint8_t* p, int64_t n) {
  if (n < 23 || p[0] != 1) {
    nal_len = 0;
    if (n > 0) nals(p, n);  // Annex B headers
    return;
  }
  nal_len = (p[21] & 3) + 1;
  if (nal_len == 3) fail("hvcC lengthSizeMinusOne 2");
  int narr = p[22];
  int64_t i = 23;
  for (int a = 0; a < narr; a++) {
    if (i + 3 > n) fail("hvcC ends early");
    int cnt = (p[i + 1] << 8) | p[i + 2];
    i += 3;
    for (int k = 0; k < cnt; k++) {
      if (i + 2 > n) fail("hvcC ends early");
      int len = (p[i] << 8) | p[i + 1];
      i += 2;
      if (i + len > n) fail("hvcC ends early");
      nal(p + i, len);
      i += len;
    }
  }
}

bool Decoder::decode(const uint8_t* p, int64_t n, int64_t tag) {
  cur_tag = tag;
  nals(p, n);
  if (cur) finish_picture();
  if (queue.empty()) return false;
  emit(queue.front());
  queue.pop_front();
  return true;
}

// the NAL units of a sample: length-prefixed, or an Annex B byte stream
void Decoder::nals(const uint8_t* p, int64_t n) {
  if (nal_len) {
    int64_t i = 0;
    while (i < n) {
      if (i + nal_len > n) fail("a NAL unit's length field is cut");
      int64_t len = 0;
      for (int k = 0; k < nal_len; k++) len = (len << 8) | p[i + k];
      i += nal_len;
      if (len > n - i) fail("a NAL unit runs past its sample");
      nal(p + i, (size_t)len);
      i += len;
    }
  } else {
    int64_t i = 0, start = -1;
    while (i + 2 < n) {
      if (p[i] == 0 && p[i + 1] == 0 && p[i + 2] == 1) {
        if (start >= 0) {
          int64_t e = i;
          while (e > start && p[e - 1] == 0) e--;
          nal(p + start, (size_t)(e - start));
        }
        i += 3;
        start = i;
      } else {
        i++;
      }
    }
    if (start >= 0) nal(p + start, (size_t)(n - start));
  }
}

bool Decoder::flush() {
  if (cur) finish_picture();
  bump(0, 0, false);
  if (queue.empty()) return false;
  emit(queue.front());
  queue.pop_front();
  return true;
}

// puts picture p out: cropped to its SPS's conformance window.
// cv2: a picture of the last coded video sequence put out after the next
// one's SPS is active converts with its own SPS's range (the frame's) but
// with the active SPS's matrix (the decoder context's)
void Decoder::emit(const std::shared_ptr<Pic>& p) {
  const Frame& f = p->f;
  const int cl = p->crop_x, ct = p->crop_y;
  const int w = p->out_w, h = p->out_h;
  out.alloc(w, h, 2);
  for (int r = 0; r < h; r++)
    std::memcpy(&out.y[(size_t)r * out.pw], &f.y[(size_t)(r + ct) * f.pw + cl], w);
  for (int r = 0; r < h / 2; r++) {
    std::memcpy(&out.cb[(size_t)r * out.cstride()],
                &f.cb[(size_t)(r + ct / 2) * f.cstride() + cl / 2], w / 2);
    std::memcpy(&out.cr[(size_t)r * out.cstride()],
                &f.cr[(size_t)(r + ct / 2) * f.cstride() + cl / 2], w / 2);
  }
  out_tag = p->tag;
  full_range = p->full_range;
  matrix = S.matrix;
  have_frame = true;
}

void Decoder::nal(const uint8_t* p, size_t n) {
  if (n < 2) return;
  if (p[0] & 0x80) fail("forbidden_zero_bit set");
  const int type = (p[0] >> 1) & 63, layer = ((p[0] & 1) << 5) | (p[1] >> 3);
  const int tid = (p[1] & 7) - 1;
  if (tid < 0) fail("nuh_temporal_id_plus1 0");
  // FFmpeg decodes the base layer alone, but reads parameter sets of every
  // layer into the base layer's tables
  if (layer > 0 && type >= 32 && type <= 34)
    refuse("parameter sets of nuh_layer_id > 0 (multi-layer streams)");
  if (layer > 0) return;
  if (type == 36 || type == 37) {  // end of sequence / bitstream
    if (cur) finish_picture();
    after_eos = true;
    max_ra = INT_MAX;
    return;
  }
  if (type > 34 || (type > 21 && type < 32) || (type > 9 && type < 16)) return;
  Bits b;
  b.load(p + 2, n - 2);
  if (type == 32) {
    parse_vps(b);
    ps_nals++;
  } else if (type == 33) {
    parse_sps(b);
    ps_nals++;
  } else if (type == 34) {
    parse_pps(b);
    ps_nals++;
  } else {
    slice(b, type, tid);
  }
}

void Decoder::slice(Bits& b, int type, int tid) {
  SliceHeader h;
  // the first bit says whether a picture starts: finish the last one first
  const bool first = b.end > 0 && (b.buf[0] & 0x80);
  if (first && cur) finish_picture();
  // FFmpeg: the later slices of a skipped picture find no picture started
  // ("First slice in a frame missing") and are dropped
  if (!first && skip_pic) return;
  parse_slice_header(b, h, type);
  if (h.first) {
    const bool irap = type >= 16 && type <= 23, rasl = type == 8 || type == 9;
    const bool new_cvs = irap && (type <= 20 || first_pic || after_eos);
    // FFmpeg: an IDR or BLA picture starts its sequence over the gate; the
    // first CRA or BLA picture after that sets it to its own POC, an IDR
    // picture opens it; a RASL picture at or below it, or after an IRAP
    // picture whose NoRaslOutputFlag is 1, is skipped, neither decoded nor
    // put out (the standard decodes it and leaves it out); a RASL_R picture
    // above it opens it
    if (type >= 16 && type <= 20) max_ra = INT_MAX;
    const int poc = picture_poc(h, new_cvs);
    if (max_ra == INT_MAX) {
      if (irap && type != 19 && type != 20) max_ra = poc;
      else if (type == 19 || type == 20) max_ra = INT_MIN;
    }
    skip_pic = rasl && (poc <= max_ra || no_rasl_out);
    if (skip_pic) return;
    if (type == 9 && poc > max_ra) max_ra = INT_MIN;
    start_picture(h, type, tid, new_cvs);
  } else if (ps_nals != pic_ps_nals) {
    fail("a VPS, SPS or PPS NAL unit between two slices of one picture");
  } else if (type != headers.front().nal_type) {
    fail("slices of one picture of different NAL unit types");
  }
  if (!h.dependent && h.type != 2 && cur_irap) fail("a P or B slice in an IRAP picture");
  // FFmpeg: slices of one picture that filter with different parameters do
  // not come out as the standard filters them
  if (!h.first && !h.dependent &&
      (h.deblock_disabled != headers.front().deblock_disabled ||
       h.beta_offset != headers.front().beta_offset || h.tc_offset != headers.front().tc_offset))
    refuse("slices of one picture that differ in their deblocking (slice_deblocking_filter_"
           "disabled_flag, beta / tC offsets)");
  if (h.segment_addr < nctb && ctb_sh[h.segment_addr] >= 0 && !h.first)
    fail("slice_segment_address already decoded");
  headers.push_back(h);
  sh_idx = (int)headers.size() - 1;
  sh = h;
  B = &b;
  build_lists();
  slice_data();
  B = nullptr;
}

// PicOrderCntVal (8.3.1) of the picture whose first slice header is h;
// new_cvs: an IRAP picture whose NoRaslOutputFlag is 1 (its MSB is 0)
int Decoder::picture_poc(const SliceHeader& h, bool new_cvs) const {
  const Sps& s = sps[pps[h.pps_id].sps_id];
  const int max_lsb = 1 << s.log2_max_poc_lsb;
  int msb = 0;
  if (!new_cvs) {
    int prev_lsb = prev_tid0_poc & (max_lsb - 1), prev_msb = prev_tid0_poc - prev_lsb;
    if (h.poc_lsb < prev_lsb && prev_lsb - h.poc_lsb >= max_lsb / 2) msb = prev_msb + max_lsb;
    else if (h.poc_lsb > prev_lsb && h.poc_lsb - prev_lsb > max_lsb / 2) msb = prev_msb - max_lsb;
    else msb = prev_msb;
  }
  return msb + h.poc_lsb;
}

void Decoder::start_picture(const SliceHeader& h, int nal_type, int tid, bool new_cvs) {
  const Pps& p = pps[h.pps_id];
  const Sps& s = sps[p.sps_id];
  const bool irap = nal_type >= 16 && nal_type <= 23;
  const bool idr = nal_type == 19 || nal_type == 20;
  if (first_pic && !irap) fail("the stream does not start with an IRAP picture");
  // FFmpeg forgets every reference when the active SPS changes: only a
  // picture that starts a coded video sequence may change it
  if (!first_pic && s.gen != S.gen && !new_cvs) fail("a new SPS within a coded video sequence");
  P = p;
  S = s;
  pic_ps_nals = ps_nals;
  cur_irap = irap;
  // size
  const int w = s.width - s.conf[0] - s.conf[1], hh = s.height - s.conf[2] - s.conf[3];
  if (out_w >= 0 && (w != out_w || hh != out_h))
    refuse("a size change mid-stream (" + std::to_string(out_w) + "x" + std::to_string(out_h) +
           " to " + std::to_string(w) + "x" + std::to_string(hh) + ")");
  if (hh & 1) refuse("an odd frame height (" + std::to_string(hh) + ")");
  // FFmpeg keeps a frame's planes aligned: a left crop that is not a
  // multiple of 64 samples would start its window elsewhere
  if (s.conf[0] & 63)
    refuse("a left crop of " + std::to_string(s.conf[0]) +
           " luma samples (not a multiple of 64)");
  out_w = w;
  out_h = hh;
  // picture order count (8.3.1); prevTid0Pic is no RASL, RADL or
  // sub-layer non-reference picture
  const int max_lsb = 1 << s.log2_max_poc_lsb;
  cur_poc = picture_poc(h, new_cvs);
  const bool slnr = nal_type <= 14 && !(nal_type & 1);
  if (tid == 0 && !slnr && !(nal_type >= 6 && nal_type <= 9)) prev_tid0_poc = cur_poc;
  if (irap) no_rasl_out = new_cvs;
  // a new coded video sequence: FFmpeg puts the last one's pictures out
  // (drops them under no_output_of_prior_pics_flag) and forgets its refs
  if (new_cvs) {
    if (!first_pic) bump(0, 0, h.no_output_prior || (nal_type == 21 && after_eos));
    for (auto& q : dpb) q->ref_st = q->ref_lt = false;
    seq++;
  }
  first_pic = after_eos = false;
  // reference picture set (8.3.2)
  auto find = [&](int poc, bool full) -> Pic* {
    for (auto& q : dpb)
      if (q->seq == seq && (full ? q->poc == poc : (q->poc & (max_lsb - 1)) == poc)) return q.get();
    return nullptr;
  };
  std::vector<std::pair<Pic*, bool>> marks;  // picture, long-term
  // FFmpeg: an entry of a CRA or BLA picture's RPS missing from the DPB
  // (the pictures before a CRA picture decoding starts at, kept there for
  // its RASL pictures) is generated as a picture (generate_missing_ref)
  // that fills a place of the DPB until the next picture's RPS, so while
  // this picture bumps; any other picture fails on it ("Error constructing
  // the frame RPS"), whether it uses the entry or not
  int generated = 0;
  if (!idr) {
    for (int i = 0; i < h.rps.num(); i++) {
      Pic* q = find(cur_poc + h.rps.delta[i], true);
      if (q) marks.push_back({q, false});
      else if (h.rps.used[i] || !irap) fail("a reference picture is missing (POC " +
                                            std::to_string(cur_poc + h.rps.delta[i]) + ")");
      else generated++;
    }
    for (int i = 0; i < h.num_lt; i++) {
      int poc = h.lt_poc[i];
      if (h.lt_msb[i]) poc += cur_poc - h.lt_cycle[i] * max_lsb - h.poc_lsb;
      Pic* q = find(poc, h.lt_msb[i]);
      if (q) marks.push_back({q, true});
      else if (h.lt_used[i] || !irap) fail("a long-term reference picture is missing");
      else generated++;
    }
  }
  for (auto& q : dpb) q->ref_st = q->ref_lt = false;
  for (auto& m : marks) {
    m.first->ref_lt = m.second;
    m.first->ref_st = !m.second;
  }
  // the DPB keeps references and pictures waiting for output
  std::vector<std::shared_ptr<Pic>> kept;
  for (auto& q : dpb)
    if (q->ref_st || q->ref_lt || q->output) kept.push_back(q);
  dpb.swap(kept);
  // the picture
  cur = std::make_shared<Pic>();
  cur->f.alloc(s.width, s.height, 8);
  cur->poc = cur_poc;
  cur->seq = seq;
  cur->crop_x = s.conf[0];
  cur->crop_y = s.conf[2];
  cur->out_w = w;
  cur->out_h = hh;
  cur->full_range = s.full_range;
  cur->tag = cur_tag;
  cur->output = h.pic_output;
  cur->ref_st = true;
  layout();
  cur->mvf.assign((size_t)W4 * H4, Mvf());
  dpb.push_back(cur);
  headers.clear();
  // FFmpeg's bumping with the new picture in the DPB
  bump(s.num_reorder, s.max_dec_pic_buffering, false, generated);
}

// FFmpeg's ff_hevc_output_frames: while more pictures wait for output than
// max_out, or the DPB holds more than max_dpb (with `generated` missing
// references), the one of lowest POC goes out (or is dropped under
// `discard`)
void Decoder::bump(int max_out, int max_dpb, bool discard, int generated) {
  while (true) {
    int nout = 0, ndpb = generated;
    std::shared_ptr<Pic> best;
    for (auto& q : dpb) {
      if (q->output) {
        nout++;
        if (!best || q->poc < best->poc) best = q;
      }
      if (q->output || q->ref_st || q->ref_lt) ndpb++;
    }
    if (!(nout > max_out || (nout && ndpb > max_dpb))) return;
    best->output = false;
    if (!discard) queue.push_back(best);
    std::vector<std::shared_ptr<Pic>> kept;
    for (auto& q : dpb)
      if (q->ref_st || q->ref_lt || q->output || q == cur) kept.push_back(q);
    dpb.swap(kept);
  }
}

void Decoder::layout() {
  W = S.width;
  H = S.height;
  W4 = W >> 2;
  H4 = H >> 2;
  log2ctb = S.log2_ctb;
  ctb_w = S.ctb_w;
  ctb_h = S.ctb_h;
  nctb = ctb_w * ctb_h;
  std::vector<int> cw, rh;
  if (!P.tiles) {
    cw = {ctb_w};
    rh = {ctb_h};
  } else if (P.uniform) {
    for (int i = 0; i < P.tile_cols; i++)
      cw.push_back((i + 1) * ctb_w / P.tile_cols - i * ctb_w / P.tile_cols);
    for (int j = 0; j < P.tile_rows; j++)
      rh.push_back((j + 1) * ctb_h / P.tile_rows - j * ctb_h / P.tile_rows);
  } else {
    int sum = 0;
    for (int v : P.col_w) cw.push_back(v), sum += v;
    if (sum >= ctb_w) fail("tile columns wider than the picture");
    cw.push_back(ctb_w - sum);
    sum = 0;
    for (int v : P.row_h) rh.push_back(v), sum += v;
    if (sum >= ctb_h) fail("tile rows taller than the picture");
    rh.push_back(ctb_h - sum);
  }
  for (int v : cw)
    if (v <= 0) fail("an empty tile column");
  for (int v : rh)
    if (v <= 0) fail("an empty tile row");
  col_bd.assign(cw.size() + 1, 0);
  row_bd.assign(rh.size() + 1, 0);
  for (size_t i = 0; i < cw.size(); i++) col_bd[i + 1] = col_bd[i] + cw[i];
  for (size_t j = 0; j < rh.size(); j++) row_bd[j + 1] = row_bd[j] + rh[j];
  rs2ts.assign(nctb, 0);
  ts2rs.assign(nctb, 0);
  tile_id.assign(nctb, 0);
  for (int rs = 0; rs < nctb; rs++) {
    int tx = rs % ctb_w, ty = rs / ctb_w, ci = 0, ri = 0;
    while (tx >= col_bd[ci + 1]) ci++;
    while (ty >= row_bd[ri + 1]) ri++;
    int v = 0;
    for (int i = 0; i < ci; i++) v += rh[ri] * cw[i];
    for (int j = 0; j < ri; j++) v += ctb_w * rh[j];
    v += (ty - row_bd[ri]) * cw[ci] + tx - col_bd[ci];
    rs2ts[rs] = v;
    ts2rs[v] = rs;
    tile_id[v] = ri * (int)cw.size() + ci;
  }
  zs.assign((size_t)W4 * H4, 0);
  const int sub = log2ctb - 2;
  for (int y = 0; y < H4; y++)
    for (int x = 0; x < W4; x++) {
      int rs = (y >> sub) * ctb_w + (x >> sub);
      int v = rs2ts[rs] << (2 * sub);
      for (int i = 0; i < sub; i++) {
        int m = 1 << i;
        v += (m & x ? m * m : 0) + (m & y ? 2 * m * m : 0);
      }
      zs[(size_t)y * W4 + x] = v;
    }
  ctb_sh.assign(nctb, -1);
  ctb_slice.assign(nctb, -1);
  flags4.assign((size_t)W4 * H4, 0);
  depth4.assign((size_t)W4 * H4, 0);
  ipm4.assign((size_t)W4 * H4, 1);
  qp4.assign((size_t)W4 * H4, 0);
  bs_v.assign((size_t)W4 * H4, 0);
  bs_h.assign((size_t)W4 * H4, 0);
  sao.assign(nctb, SaoParams());
  log2_qg = log2ctb - P.diff_cu_qp_delta_depth;
  if (S.scaling_enabled) {
    const ScalingList& sl = P.scaling_present ? P.sl : S.sl;
    for (int inter = 0; inter < 2; inter++)
      for (int c = 0; c < 3; c++)
        for (int l = 2; l <= 5; l++) sl.factors(l, 3 * inter + c, factors[inter][c][l - 2]);
  }
}

void Decoder::finish_picture() {
  loop_filters();
  cur.reset();
  headers.clear();
}

// RefPicList0 / 1 (8.3.4) of the slice
void Decoder::build_lists() {
  for (int l = 0; l < 2; l++)
    for (int i = 0; i < 16; i++) list[l][i] = nullptr;
  if (sh.type == 2) return;
  const int max_lsb = 1 << S.log2_max_poc_lsb;
  std::vector<Pic*> before, after, lt;
  auto find = [&](int poc, bool full) -> Pic* {
    for (auto& q : dpb)
      if (q != cur && q->seq == seq && (q->ref_st || q->ref_lt) &&
          (full ? q->poc == poc : (q->poc & (max_lsb - 1)) == poc))
        return q.get();
    return nullptr;
  };
  for (int i = 0; i < sh.rps.num(); i++)
    if (sh.rps.used[i]) {
      Pic* q = find(cur_poc + sh.rps.delta[i], true);
      if (!q) fail("a reference picture is missing");
      (i < sh.rps.num_neg ? before : after).push_back(q);
    }
  for (int i = 0; i < sh.num_lt; i++)
    if (sh.lt_used[i]) {
      int poc = sh.lt_poc[i];
      if (sh.lt_msb[i]) poc += cur_poc - sh.lt_cycle[i] * max_lsb - sh.poc_lsb;
      Pic* q = find(poc, sh.lt_msb[i]);
      if (!q) fail("a long-term reference picture is missing");
      lt.push_back(q);
    }
  const int total = (int)(before.size() + after.size() + lt.size());
  for (int l = 0; l < (sh.type == 0 ? 2 : 1); l++) {
    std::vector<Pic*> temp;
    const int n = std::max(sh.num_ref[l], total);
    while ((int)temp.size() < n) {
      for (Pic* q : l ? after : before)
        if ((int)temp.size() < n) temp.push_back(q);
      for (Pic* q : l ? before : after)
        if ((int)temp.size() < n) temp.push_back(q);
      for (Pic* q : lt)
        if ((int)temp.size() < n) temp.push_back(q);
    }
    for (int i = 0; i < sh.num_ref[l]; i++) {
      Pic* q = temp[sh.mod[l] ? sh.entry[l][i] : i];
      // prediction reads a reference in the current picture's layout
      if (q->f.pw != cur->f.pw || q->f.ph != cur->f.ph || q->mvf.size() != cur->mvf.size())
        fail("a reference picture of another coded size");
      list[l][i] = q;
    }
  }
}

// --- CABAC (9.3) -------------------------------------------------------------------

void Decoder::init_contexts() {
  const int init_type = sh.type == 2 ? 0 : sh.type == 1 ? (sh.cabac_init ? 2 : 1)
                                                        : (sh.cabac_init ? 1 : 2);
  const int qp = clip3(0, 51, sh.qp);
  for (int i = 0; i < kNumCtx; i++) {
    const int v = kInit[init_type][i];
    const int m = (v >> 4) * 5 - 45, n = ((v & 15) << 3) - 16;
    const int pre = clip3(1, 126, ((m * qp) >> 4) + n);
    mps[i] = pre > 63;
    st[i] = (uint8_t)(mps[i] ? pre - 64 : 63 - pre);
  }
}

void Decoder::init_engine() {
  range = 510;
  offset = B->u(9);
  if (offset >= 510) fail("bad CABAC offset");
}

int Decoder::dec(int ctx) {
  const int s = st[ctx];
  const uint32_t lps = h264::kRangeLps[s][(range >> 6) & 3];
  range -= lps;
  int bin;
  if (offset >= range) {
    bin = !mps[ctx];
    offset -= range;
    range = lps;
    if (s == 0) mps[ctx] ^= 1;
    st[ctx] = h264::kTransLps[s];
  } else {
    bin = mps[ctx];
    if (s < 62) st[ctx] = (uint8_t)(s + 1);
  }
  while (range < 256) {
    range <<= 1;
    offset = (offset << 1) | B->u1();
  }
  return bin;
}

int Decoder::bypass() {
  offset = (offset << 1) | B->u1();
  if (offset >= range) {
    offset -= range;
    return 1;
  }
  return 0;
}

int Decoder::bypass_bits(int n) {
  int v = 0;
  for (int i = 0; i < n; i++) v = (v << 1) | bypass();
  return v;
}

int Decoder::terminate() {
  range -= 2;
  if (offset >= range) return 1;
  while (range < 256) {
    range <<= 1;
    offset = (offset << 1) | B->u1();
  }
  return 0;
}

bool Decoder::avail(int xc, int yc, int xn, int yn) const {
  if (xn < 0 || yn < 0 || xn >= W || yn >= H) return false;
  if (zs[idx4(xn, yn)] > zs[idx4(xc, yc)]) return false;
  const int cn = (yn >> log2ctb) * ctb_w + (xn >> log2ctb);
  const int cc = (yc >> log2ctb) * ctb_w + (xc >> log2ctb);
  if (ctb_slice[cn] != ctb_slice[cc] || ctb_slice[cn] < 0) return false;
  return tile_id[rs2ts[cn]] == tile_id[rs2ts[cc]];
}

// --- slice data (7.3.8) ----------------------------------------------------------

void Decoder::slice_data() {
  ctb_addr_ts = rs2ts[sh.segment_addr];
  init_engine();
  // contexts at the segment's start (9.3.1): a tile's first CTB, a WPP
  // row's, a dependent segment's (the last segment's states) or fresh
  const int rs0 = sh.segment_addr;
  const bool tile_start = ctb_addr_ts == 0 || tile_id[ctb_addr_ts] != tile_id[ctb_addr_ts - 1];
  ctb_slice[rs0] = sh.slice_addr;  // for the availability of T below
  bool fresh = true;
  if (!tile_start && P.wpp && col_start(rs0 % ctb_w)) {
    const int x0 = (rs0 % ctb_w) << log2ctb, y0 = (rs0 / ctb_w) << log2ctb;
    if (avail(x0, y0, x0 + (1 << log2ctb), y0 - (1 << log2ctb)) && wpp_saved) {
      std::memcpy(st, wpp_st, kNumCtx);
      std::memcpy(mps, wpp_mps, kNumCtx);
      fresh = false;
    }
  } else if (!tile_start && sh.dependent) {
    fresh = false;  // the states the last segment left
  }
  if (fresh) init_contexts();
  if (!sh.dependent || tile_start) first_qg = true;
  if (P.wpp && col_start(rs0 % ctb_w)) first_qg = true;
  while (true) {
    if (ctb_addr_ts >= nctb) fail("slice data past the picture's last CTB");
    const int rs = ts2rs[ctb_addr_ts];
    if (ctb_sh[rs] >= 0) fail("a CTB decoded twice");
    ctb_sh[rs] = sh_idx;
    ctb_slice[rs] = sh.slice_addr;
    const int rx = rs % ctb_w, ry = rs / ctb_w;
    if (sh.sao_luma || sh.sao_chroma) sao_syntax(rx, ry, rs);
    quadtree(rx << log2ctb, ry << log2ctb, log2ctb, 0);
    const int end = terminate();
    // WPP storage after a row's second CTB (9.3.2.4)
    if (P.wpp && rx > 0 && col_start(rx - 1) && !col_start(rx)) {
      std::memcpy(wpp_st, st, kNumCtx);
      std::memcpy(wpp_mps, mps, kNumCtx);
      wpp_saved = true;
    }
    ctb_addr_ts++;
    if (end) break;
    if (ctb_addr_ts >= nctb) fail("slice data past the picture's last CTB");
    const int nrs = ts2rs[ctb_addr_ts];
    const bool new_tile = P.tiles && tile_id[ctb_addr_ts] != tile_id[ctb_addr_ts - 1];
    const bool new_row = P.wpp && col_start(nrs % ctb_w);
    if (new_tile || new_row) {
      if (!terminate()) fail("end_of_subset_one_bit is not 1");
      B->pos = (B->pos + 7) & ~(size_t)7;
      init_engine();
      first_qg = true;
      bool synced = false;
      if (!new_tile && new_row) {
        const int x0 = (nrs % ctb_w) << log2ctb, y0 = (nrs / ctb_w) << log2ctb;
        ctb_slice[nrs] = sh.slice_addr;
        if (wpp_saved && avail(x0, y0, x0 + (1 << log2ctb), y0 - (1 << log2ctb))) {
          std::memcpy(st, wpp_st, kNumCtx);
          std::memcpy(mps, wpp_mps, kNumCtx);
          synced = true;
        }
        ctb_slice[nrs] = -1;
      }
      if (!synced) init_contexts();
    }
  }
}

void Decoder::sao_syntax(int rx, int ry, int rs) {
  SaoParams& s = sao[rs];
  const int ts = rs2ts[rs];
  bool merge_left = false, merge_up = false;
  if (rx > 0) {
    bool in_slice = rs - 1 >= sh.slice_addr;
    bool in_tile = tile_id[ts] == tile_id[rs2ts[rs - 1]];
    if (in_slice && in_tile) merge_left = dec(kSaoMerge);
  }
  if (ry > 0 && !merge_left) {
    bool in_slice = rs - ctb_w >= sh.slice_addr;
    bool in_tile = tile_id[ts] == tile_id[rs2ts[rs - ctb_w]];
    if (in_slice && in_tile) merge_up = dec(kSaoMerge);
  }
  if (merge_left || merge_up) {
    s = sao[merge_left ? rs - 1 : rs - ctb_w];
    if (!sh.sao_luma) s.type[0] = 0;
    if (!sh.sao_chroma) s.type[1] = s.type[2] = 0;
    return;
  }
  s = SaoParams();
  for (int c = 0; c < 3; c++) {
    if (!(c == 0 ? sh.sao_luma : sh.sao_chroma)) continue;
    if (c < 2) {
      int t = 0;
      if (dec(kSaoType)) t = bypass() ? 2 : 1;
      s.type[c] = t;
    } else {
      s.type[2] = s.type[1];
      s.eo[2] = s.eo[1];
    }
    if (!s.type[c]) continue;
    int abs_[4];
    for (int k = 0; k < 4; k++) {
      int v = 0;
      while (v < 7 && bypass()) v++;
      abs_[k] = v;
    }
    if (s.type[c] == 1) {
      for (int k = 0; k < 4; k++) s.off[c][k] = abs_[k] && bypass() ? -abs_[k] : abs_[k];
      s.band[c] = bypass_bits(5);
    } else {
      s.off[c][0] = abs_[0];
      s.off[c][1] = abs_[1];
      s.off[c][2] = -abs_[2];
      s.off[c][3] = -abs_[3];
      if (c == 0) s.eo[0] = bypass_bits(2);
      if (c == 1) s.eo[1] = s.eo[2] = bypass_bits(2);
    }
  }
}

void Decoder::quadtree(int x0, int y0, int log2, int depth) {
  const int size = 1 << log2;
  int split;
  if (x0 + size <= W && y0 + size <= H && log2 > S.log2_min_cb) {
    int ctx = 0;
    if (avail(x0, y0, x0 - 1, y0) && depth4[idx4(x0 - 1, y0)] > depth) ctx++;
    if (avail(x0, y0, x0, y0 - 1) && depth4[idx4(x0, y0 - 1)] > depth) ctx++;
    split = dec(kSplitCu + ctx);
  } else {
    split = log2 > S.log2_min_cb;
  }
  if (log2 >= log2_qg) {
    // a quantization group starts (8.6.1): its predicted QpY
    qp_delta_coded = false;
    cu_qp_delta = 0;
    const int prev = first_qg ? sh.qp : last_cu_qp;
    const int mask = (1 << log2ctb) - 1;
    const int qa = (x0 & mask) ? qp4[idx4(x0 - 1, y0)] : prev;
    const int qb = (y0 & mask) ? qp4[idx4(x0, y0 - 1)] : prev;
    qg_pred = (qa + qb + 1) >> 1;
  }
  if (split) {
    const int h = size >> 1;
    quadtree(x0, y0, log2 - 1, depth + 1);
    if (x0 + h < W) quadtree(x0 + h, y0, log2 - 1, depth + 1);
    if (y0 + h < H) quadtree(x0, y0 + h, log2 - 1, depth + 1);
    if (x0 + h < W && y0 + h < H) quadtree(x0 + h, y0 + h, log2 - 1, depth + 1);
  } else {
    const int n4 = size >> 2;
    for (int j = 0; j < n4 && (y0 >> 2) + j < H4; j++)
      for (int i = 0; i < n4 && (x0 >> 2) + i < W4; i++)
        depth4[((y0 >> 2) + j) * W4 + (x0 >> 2) + i] = (uint8_t)depth;
    coding_unit(x0, y0, log2);
  }
}

void Decoder::set_qp() { qp_y = (qg_pred + cu_qp_delta + 52) % 52; }

// --- coding units (7.3.8.5) -------------------------------------------------------

void Decoder::coding_unit(int x0, int y0, int log2) {
  const int n = 1 << log2, n4 = n >> 2;
  cu_x = x0;
  cu_y = y0;
  cu_log2 = log2;
  cu_bypass = P.bypass && dec(kBypassFlag);
  bool skip = false;
  if (sh.type != 2) {
    int ctx = 0;
    if (avail(x0, y0, x0 - 1, y0) && (flags4[idx4(x0 - 1, y0)] & kIsSkip)) ctx++;
    if (avail(x0, y0, x0, y0 - 1) && (flags4[idx4(x0, y0 - 1)] & kIsSkip)) ctx++;
    skip = dec(kSkip + ctx);
  }
  bool pcm = false;
  cu_intra = sh.type == 2;
  part = 0;  // PART_2Nx2N
  if (!skip && sh.type != 2) cu_intra = dec(kPredMode);
  if (!skip && (!cu_intra || log2 == S.log2_min_cb)) {
    // part_mode (9.3.3.7): 0 2Nx2N, 1 2NxN, 2 Nx2N, 3 NxN, 4 2NxnU, 5
    // 2NxnD, 6 nLx2N, 7 nRx2N
    if (dec(kPartMode)) {
      part = 0;
    } else if (cu_intra) {
      part = 3;
    } else if (log2 == S.log2_min_cb) {
      if (dec(kPartMode + 1)) part = 1;
      else if (log2 == 3) part = 2;
      else part = dec(kPartMode + 2) ? 2 : 3;
    } else if (!S.amp) {
      part = dec(kPartMode + 1) ? 1 : 2;
    } else if (dec(kPartMode + 1)) {
      part = dec(kPartMode + 3) ? 1 : bypass() ? 5 : 4;
    } else {
      part = dec(kPartMode + 3) ? 2 : bypass() ? 7 : 6;
    }
  }
  // the CU's flags and (for intra) no motion, before its blocks look round
  const uint8_t fl = (uint8_t)((cu_intra ? kIsIntra : 0) | (skip ? kIsSkip : 0) |
                               (cu_bypass ? kIsBypass : 0));
  for (int j = 0; j < n4; j++)
    for (int i = 0; i < n4; i++) {
      const int k = ((y0 >> 2) + j) * W4 + (x0 >> 2) + i;
      flags4[k] = fl;
      if (cu_intra) cur->mvf[k] = Mvf();
    }
  set_qp();
  cu_merge2n = false;
  if (skip) {
    prediction_unit(x0, y0, n, n, 0, true);
    edges(x0, y0, n, n, true);
  } else if (cu_intra) {
    if (part == 0 && S.pcm && log2 >= S.log2_min_pcm && log2 <= S.log2_max_pcm)
      pcm = terminate();
    if (pcm) {
      pcm_sample(x0, y0, log2);
      for (int j = 0; j < n4; j++)
        for (int i = 0; i < n4; i++) {
          const int k = ((y0 >> 2) + j) * W4 + (x0 >> 2) + i;
          flags4[k] |= kIsPcm;
          ipm4[k] = 1;
        }
      edges(x0, y0, n, n, true);
    } else {
      const int nb = part == 3 ? 4 : 1, pb = part == 3 ? n / 2 : n;
      int prev[4];
      for (int k = 0; k < nb; k++) prev[k] = dec(kPrevIntra);
      for (int k = 0; k < nb; k++) {
        const int xp = x0 + (k & 1) * pb, yp = y0 + (k >> 1) * pb;
        // MPM (8.4.2)
        int a = 1, b = 1;
        if (avail(xp, yp, xp - 1, yp) && (flags4[idx4(xp - 1, yp)] & kIsIntra) &&
            !(flags4[idx4(xp - 1, yp)] & kIsPcm))
          a = ipm4[idx4(xp - 1, yp)];
        if (avail(xp, yp, xp, yp - 1) && (flags4[idx4(xp, yp - 1)] & kIsIntra) &&
            !(flags4[idx4(xp, yp - 1)] & kIsPcm) &&
            yp - 1 >= ((yp >> log2ctb) << log2ctb))
          b = ipm4[idx4(xp, yp - 1)];
        int cand[3];
        if (a == b) {
          if (a < 2) {
            cand[0] = 0;
            cand[1] = 1;
            cand[2] = 26;
          } else {
            cand[0] = a;
            cand[1] = 2 + ((a + 29) % 32);
            cand[2] = 2 + ((a - 2 + 1) % 32);
          }
        } else {
          cand[0] = a;
          cand[1] = b;
          cand[2] = (a != 0 && b != 0) ? 0 : (a != 1 && b != 1) ? 1 : 26;
        }
        int mode;
        if (prev[k]) {
          int idx = 0;
          while (idx < 2 && bypass()) idx++;
          mode = cand[idx];
        } else {
          mode = bypass_bits(5);
          std::sort(cand, cand + 3);
          for (int i = 0; i < 3; i++)
            if (mode >= cand[i]) mode++;
        }
        for (int j = 0; j < pb / 4; j++)
          for (int i = 0; i < pb / 4; i++) ipm4[((yp >> 2) + j) * W4 + (xp >> 2) + i] = (uint8_t)mode;
      }
      intra_chroma = dec(kChromaMode) ? bypass_bits(2) : 4;
    }
  } else {
    const int h = n / 2, q = n / 4;
    switch (part) {
      case 0: prediction_unit(x0, y0, n, n, 0, false); break;
      case 1:
        prediction_unit(x0, y0, n, h, 0, false);
        prediction_unit(x0, y0 + h, n, h, 1, false);
        break;
      case 2:
        prediction_unit(x0, y0, h, n, 0, false);
        prediction_unit(x0 + h, y0, h, n, 1, false);
        break;
      case 4:
        prediction_unit(x0, y0, n, q, 0, false);
        prediction_unit(x0, y0 + q, n, n - q, 1, false);
        break;
      case 5:
        prediction_unit(x0, y0, n, n - q, 0, false);
        prediction_unit(x0, y0 + n - q, n, q, 1, false);
        break;
      case 6:
        prediction_unit(x0, y0, q, n, 0, false);
        prediction_unit(x0 + q, y0, n - q, n, 1, false);
        break;
      case 7:
        prediction_unit(x0, y0, n - q, n, 0, false);
        prediction_unit(x0 + n - q, y0, q, n, 1, false);
        break;
      default:
        prediction_unit(x0, y0, h, h, 0, false);
        prediction_unit(x0 + h, y0, h, h, 1, false);
        prediction_unit(x0, y0 + h, h, h, 2, false);
        prediction_unit(x0 + h, y0 + h, h, h, 3, false);
    }
  }
  if (!skip && !pcm) {
    bool root = true;
    if (!cu_intra && !(part == 0 && cu_merge2n)) root = dec(kRootCbf);
    if (root) {
      const bool isplit = cu_intra && part == 3;
      const int maxd = cu_intra ? S.max_th_intra + (isplit ? 1 : 0) : S.max_th_inter;
      transform_tree(x0, y0, x0, y0, log2, 0, 0, maxd, isplit, 0, 0);
    } else {
      edges(x0, y0, n, n, true);
    }
  }
  set_qp();
  for (int j = 0; j < n4; j++)
    for (int i = 0; i < n4; i++) qp4[((y0 >> 2) + j) * W4 + (x0 >> 2) + i] = (int8_t)qp_y;
  last_cu_qp = qp_y;
  first_qg = false;
}

void Decoder::pcm_sample(int x0, int y0, int log2) {
  B->pos = (B->pos + 7) & ~(size_t)7;  // pcm_alignment_zero_bit
  const int n = 1 << log2;
  Frame& f = cur->f;
  for (int j = 0; j < n; j++)
    for (int i = 0; i < n; i++)
      f.y[(size_t)(y0 + j) * f.pw + x0 + i] = (uint8_t)(B->u(S.pcm_bd_y) << (8 - S.pcm_bd_y));
  for (int c = 0; c < 2; c++) {
    std::vector<uint8_t>& pl = c ? f.cr : f.cb;
    for (int j = 0; j < n / 2; j++)
      for (int i = 0; i < n / 2; i++)
        pl[(size_t)(y0 / 2 + j) * f.cstride() + x0 / 2 + i] =
            (uint8_t)(B->u(S.pcm_bd_c) << (8 - S.pcm_bd_c));
  }
  init_engine();
}

// --- inter prediction (8.5.3) -----------------------------------------------------

// 6.4.2: (xn, yn) is available to prediction block part_idx at (xc, yc),
// w x h, of the current CU, and coded in inter mode
bool Decoder::pb_avail(int xc, int yc, int w, int h, int part_idx, int xn, int yn) const {
  const int ncb = 1 << cu_log2;
  bool a;
  if (xn >= cu_x && yn >= cu_y && xn < cu_x + ncb && yn < cu_y + ncb) {
    a = !((w << 1) == ncb && (h << 1) == ncb && part_idx == 1 && cu_y + h <= yn && cu_x + w > xn);
  } else {
    a = avail(xc, yc, xn, yn);
  }
  return a && !(flags4[idx4(xn, yn)] & kIsIntra) && cur->mvf[idx4(xn, yn)].pred;
}

static bool same_motion(const Mvf& a, const Mvf& b) {
  if (a.pred != b.pred) return false;
  for (int l = 0; l < 2; l++)
    if ((a.pred >> l & 1) && (a.mv[l][0] != b.mv[l][0] || a.mv[l][1] != b.mv[l][1] ||
                               a.ref[l] != b.ref[l]))
      return false;
  return true;
}

static void scale_mv(int16_t* dst, const int16_t* src, int td, int tb) {
  td = clip3(-128, 127, td);
  tb = clip3(-128, 127, tb);
  const int tx = (16384 + (std::abs(td) >> 1)) / td;
  const int dsf = clip3(-4096, 4095, (tb * tx + 32) >> 6);
  for (int c = 0; c < 2; c++) {
    const int v = dsf * src[c];
    dst[c] = (int16_t)clip3(-32768, 32767, (v < 0 ? -1 : 1) * ((std::abs(v) + 127) >> 8));
  }
}

// temporal luma MV prediction (8.5.3.2.8) for reference ref_idx of list X
bool Decoder::temporal(int xp, int yp, int w, int h, int ref_idx, int X, int16_t* mv) {
  mv[0] = mv[1] = 0;
  if (!sh.tmvp) return false;
  Pic* col = list[sh.type == 0 && !sh.col_from_l0 ? 1 : 0][sh.col_ref];
  if (!col || col->mvf.size() != cur->mvf.size()) return false;
  Pic* target = list[X][ref_idx];
  const bool cur_lt = target->ref_lt;
  auto try_at = [&](int x, int y) {
    x &= ~15;
    y &= ~15;
    const Mvf& c = col->mvf[idx4(x, y)];
    if (!c.pred) return false;
    int l;
    if (!(c.pred & 1)) l = 1;
    else if (c.pred == 1) l = 0;
    else {
      bool backward = false;  // NoBackwardPredFlag is 0
      for (int k = 0; k < 2 && !backward; k++)
        for (int i = 0; i < sh.num_ref[k]; i++)
          if (list[k][i]->poc > cur_poc) backward = true;
      l = !backward ? X : (sh.col_from_l0 ? 1 : 0);
    }
    const bool col_lt = (c.lt >> l) & 1;
    if (col_lt != cur_lt) return false;
    const int col_diff = col->poc - c.poc[l], cur_diff = cur_poc - target->poc;
    if (cur_lt || col_diff == cur_diff || !col_diff) {
      mv[0] = c.mv[l][0];
      mv[1] = c.mv[l][1];
    } else {
      scale_mv(mv, c.mv[l], col_diff, cur_diff);
    }
    return true;
  };
  const int xb = xp + w, yb = yp + h;
  if ((yp >> log2ctb) == (yb >> log2ctb) && yb < H && xb < W && try_at(xb, yb)) return true;
  return try_at(xp + (w >> 1), yp + (h >> 1));
}

void Decoder::merge(int xp, int yp, int w, int h, int part_idx, int merge_idx, Mvf& out) {
  const int ow = w, oh = h;
  if (P.log2_par_mrg > 2 && cu_log2 == 3) {  // one merge list for the CU
    xp = cu_x;
    yp = cu_y;
    w = h = 8;
    part_idx = 0;
  }
  Mvf cand[5];
  int nc = 0;
  const int pl = P.log2_par_mrg;
  auto mer = [&](int xn, int yn) { return (xp >> pl) == (xn >> pl) && (yp >> pl) == (yn >> pl); };
  auto get = [&](int xn, int yn, bool ok, Mvf& m) {
    if (!ok || mer(xn, yn) || !pb_avail(xp, yp, w, h, part_idx, xn, yn)) return false;
    m = cur->mvf[idx4(xn, yn)];
    return true;
  };
  Mvf a1, b1, b0, a0, b2;
  const bool vert2 = part == 2 || part == 6 || part == 7, hor2 = part == 1 || part == 4 || part == 5;
  // each candidate is pruned against the availability of its neighbours,
  // not against whether they were listed (8.5.3.2.3)
  const bool has_a1 = get(xp - 1, yp + h - 1, !(vert2 && part_idx == 1), a1);
  if (has_a1) cand[nc++] = a1;
  const bool has_b1 = get(xp + w - 1, yp - 1, !(hor2 && part_idx == 1), b1);
  if (has_b1 && !(has_a1 && same_motion(a1, b1))) cand[nc++] = b1;
  const bool has_b0 = get(xp + w, yp - 1, true, b0);
  if (has_b0 && !(has_b1 && same_motion(b1, b0))) cand[nc++] = b0;
  const bool has_a0 = get(xp - 1, yp + h, true, a0);
  if (has_a0 && !(has_a1 && same_motion(a1, a0))) cand[nc++] = a0;
  if (nc != 4) {
    const bool has_b2 = get(xp - 1, yp - 1, true, b2);
    if (has_b2 && !(has_a1 && same_motion(a1, b2)) && !(has_b1 && same_motion(b1, b2)))
      cand[nc++] = b2;
  }
  // temporal
  if (nc < sh.max_merge && sh.tmvp) {
    Mvf t = Mvf();
    int16_t mv[2];
    if (temporal(xp, yp, w, h, 0, 0, mv)) {
      t.pred |= 1;
      t.mv[0][0] = mv[0];
      t.mv[0][1] = mv[1];
      t.ref[0] = 0;
    }
    if (sh.type == 0 && temporal(xp, yp, w, h, 0, 1, mv)) {
      t.pred |= 2;
      t.mv[1][0] = mv[0];
      t.mv[1][1] = mv[1];
      t.ref[1] = 0;
    }
    if (t.pred) cand[nc++] = t;
  }
  // combined bi-predictive (8.5.3.2.4)
  const int orig = nc;
  if (sh.type == 0 && orig > 1 && orig < sh.max_merge) {
    static const int l0i[12] = {0, 1, 0, 2, 1, 2, 0, 3, 2, 3, 1, 3};
    static const int l1i[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 2, 3, 1};
    for (int k = 0; k < orig * (orig - 1) && nc < sh.max_merge; k++) {
      const Mvf& c0 = cand[l0i[k]];
      const Mvf& c1 = cand[l1i[k]];
      if ((c0.pred & 1) && (c1.pred & 2) &&
          (list[0][c0.ref[0]]->poc != list[1][c1.ref[1]]->poc || c0.mv[0][0] != c1.mv[1][0] ||
           c0.mv[0][1] != c1.mv[1][1])) {
        Mvf m = Mvf();
        m.pred = 3;
        m.ref[0] = c0.ref[0];
        m.ref[1] = c1.ref[1];
        m.mv[0][0] = c0.mv[0][0];
        m.mv[0][1] = c0.mv[0][1];
        m.mv[1][0] = c1.mv[1][0];
        m.mv[1][1] = c1.mv[1][1];
        cand[nc++] = m;
      }
    }
  }
  // zero candidates
  const int nref = sh.type == 1 ? sh.num_ref[0] : std::min(sh.num_ref[0], sh.num_ref[1]);
  for (int zi = 0; nc < sh.max_merge; zi++) {
    Mvf m = Mvf();
    m.pred = sh.type == 0 ? 3 : 1;
    m.ref[0] = m.ref[1] = (int8_t)(zi < nref ? zi : 0);
    if (!(m.pred & 2)) m.ref[1] = -1;
    cand[nc++] = m;
  }
  out = cand[merge_idx];
  if (out.pred == 3 && ow + oh == 12) out.pred = 1;  // 8x4 / 4x8: list 0 only
  for (int l = 0; l < 2; l++)
    if (!(out.pred >> l & 1)) {
      out.ref[l] = -1;
      out.mv[l][0] = out.mv[l][1] = 0;
    }
}

// AMVP (8.5.3.2.6 / 8.5.3.2.7)
void Decoder::amvp(int xp, int yp, int w, int h, int part_idx, int X, int ref_idx,
                   int16_t* mvp_out, int mvp_flag) {
  const int Y = 1 - X;
  Pic* target = list[X][ref_idx];
  auto nb = [&](int xn, int yn, const Mvf** m) {
    if (!pb_avail(xp, yp, w, h, part_idx, xn, yn)) return false;
    *m = &cur->mvf[idx4(xn, yn)];
    return true;
  };
  // the same picture, no scaling
  auto plain = [&](const Mvf* m, int16_t* mv) {
    for (int l : {X, Y})
      if ((m->pred >> l & 1) && list[l][m->ref[l]] == target) {
        mv[0] = m->mv[l][0];
        mv[1] = m->mv[l][1];
        return true;
      }
    return false;
  };
  // long-term status alike, scaled when both are short-term
  auto scaled = [&](const Mvf* m, int16_t* mv) {
    for (int l : {X, Y})
      if (m->pred >> l & 1) {
        Pic* r = list[l][m->ref[l]];
        if (r->ref_lt != target->ref_lt) continue;
        mv[0] = m->mv[l][0];
        mv[1] = m->mv[l][1];
        if (!target->ref_lt && r->poc != target->poc) {
          int td = cur_poc - r->poc;
          if (!td) td = 1;
          scale_mv(mv, m->mv[l], td, cur_poc - target->poc);
        }
        return true;
      }
    return false;
  };
  const Mvf *ma0 = nullptr, *ma1 = nullptr, *mb0 = nullptr, *mb1 = nullptr, *mb2 = nullptr;
  const bool a0 = nb(xp - 1, yp + h, &ma0), a1 = nb(xp - 1, yp + h - 1, &ma1);
  const bool is_scaled = a0 || a1;
  int16_t mva[2] = {0, 0}, mvb[2] = {0, 0};
  bool fa = false, fb = false;
  if (a0) fa = plain(ma0, mva);
  if (!fa && a1) fa = plain(ma1, mva);
  if (!fa && a0) fa = scaled(ma0, mva);
  if (!fa && a1) fa = scaled(ma1, mva);
  const bool b0 = nb(xp + w, yp - 1, &mb0), b1 = nb(xp + w - 1, yp - 1, &mb1),
             b2 = nb(xp - 1, yp - 1, &mb2);
  if (b0) fb = plain(mb0, mvb);
  if (!fb && b1) fb = plain(mb1, mvb);
  if (!fb && b2) fb = plain(mb2, mvb);
  if (!is_scaled && fb) {
    fa = true;
    mva[0] = mvb[0];
    mva[1] = mvb[1];
  }
  if (!is_scaled) {
    fb = false;
    if (b0) fb = scaled(mb0, mvb);
    if (!fb && b1) fb = scaled(mb1, mvb);
    if (!fb && b2) fb = scaled(mb2, mvb);
  }
  int16_t cand[3][2];
  int nc = 0;
  if (fa) {
    cand[nc][0] = mva[0];
    cand[nc++][1] = mva[1];
  }
  if (fb && !(fa && mva[0] == mvb[0] && mva[1] == mvb[1])) {
    cand[nc][0] = mvb[0];
    cand[nc++][1] = mvb[1];
  }
  if (nc < 2) {
    int16_t mv[2];
    if (temporal(xp, yp, w, h, ref_idx, X, mv)) {
      cand[nc][0] = mv[0];
      cand[nc++][1] = mv[1];
    }
  }
  while (nc < 2) {
    cand[nc][0] = cand[nc][1] = 0;
    nc++;
  }
  mvp_out[0] = cand[mvp_flag][0];
  mvp_out[1] = cand[mvp_flag][1];
}

void Decoder::prediction_unit(int x, int y, int w, int h, int part_idx, bool skip) {
  Mvf m = Mvf();
  m.ref[0] = m.ref[1] = -1;
  bool mflag = skip;
  if (!skip) mflag = dec(kMergeFlag);
  if (mflag) {
    int idx = 0;
    if (sh.max_merge > 1) {
      if (dec(kMergeIdx)) {
        idx = 1;
        while (idx < sh.max_merge - 1 && bypass()) idx++;
      }
    }
    merge(x, y, w, h, part_idx, idx, m);
    if (part_idx == 0) cu_merge2n = true;
  } else {
    int dir = 1;  // 1 L0, 2 L1, 3 bi
    if (sh.type == 0) {
      if (w + h != 12 && dec(kInterDir + depth4[idx4(cu_x, cu_y)])) dir = 3;
      else dir = dec(kInterDir + 4) ? 2 : 1;
    }
    int mvd[2][2] = {{0, 0}, {0, 0}};
    int ref[2] = {-1, -1}, flag[2] = {0, 0};
    for (int l = 0; l < 2; l++) {
      if (!(dir >> l & 1)) continue;
      ref[l] = 0;
      if (sh.num_ref[l] > 1) {
        const int ctx = kRefIdx0;  // ref_idx_l0 and ref_idx_l1 share their contexts
        int r = 0;
        while (r < sh.num_ref[l] - 1) {
          int bin = r < 2 ? dec(ctx + r) : bypass();
          if (!bin) break;
          r++;
        }
        ref[l] = r;
      }
      if (l == 1 && sh.mvd_l1_zero && dir == 3) {
        mvd[1][0] = mvd[1][1] = 0;
      } else {
        // mvd_coding (7.3.8.9)
        int g0[2], g1[2] = {0, 0};
        g0[0] = dec(kMvdG0);
        g0[1] = dec(kMvdG0);
        if (g0[0]) g1[0] = dec(kMvdG1 + 1);
        if (g0[1]) g1[1] = dec(kMvdG1 + 1);
        for (int c = 0; c < 2; c++) {
          if (!g0[c]) continue;
          int a = 1;
          if (g1[c]) {  // abs_mvd_minus2: EG1
            int k = 1, v = 0;
            while (bypass()) {
              v += 1 << k;
              if (++k > 31) fail("abs_mvd_minus2 too long");
            }
            v += bypass_bits(k);
            a = v + 2;
          }
          mvd[l][c] = bypass() ? -a : a;
        }
      }
      flag[l] = dec(kMvpFlag);
    }
    for (int l = 0; l < 2; l++) {
      if (!(dir >> l & 1)) continue;
      int16_t mvp[2];
      amvp(x, y, w, h, part_idx, l, ref[l], mvp, flag[l]);
      m.pred |= (uint8_t)(1 << l);
      m.ref[l] = (int8_t)ref[l];
      // (mvp + mvd) wrapped to 16 bits (8.5.3.2.5)
      m.mv[l][0] = (int16_t)(uint16_t)(mvp[0] + mvd[l][0]);
      m.mv[l][1] = (int16_t)(uint16_t)(mvp[1] + mvd[l][1]);
    }
  }
  m.lt = 0;
  for (int l = 0; l < 2; l++)
    if (m.pred >> l & 1) {
      Pic* r = list[l][m.ref[l]];
      if (!r) fail("a reference index past the list");
      m.poc[l] = r->poc;
      if (r->ref_lt) m.lt |= (uint8_t)(1 << l);
    } else {
      m.poc[l] = 0;
    }
  for (int j = 0; j < h / 4; j++)
    for (int i = 0; i < w / 4; i++) cur->mvf[((y >> 2) + j) * W4 + (x >> 2) + i] = m;
  mc(x, y, w, h, m);
  edges(x, y, w, h, false);
}

void Decoder::mc(int xp, int yp, int w, int h, const Mvf& m) {
  static thread_local int16_t buf[2][64 * 64];
  static thread_local uint8_t pred[64 * 64];
  const bool weighted = (sh.type == 1 && P.weighted_pred) || (sh.type == 0 && P.weighted_bipred);
  for (int c = 0; c < 3; c++) {
    const int sx = c ? 1 : 0;
    const int bw = w >> sx, bh = h >> sx, x = xp >> sx, y = yp >> sx;
    int nl = 0;
    int lists[2];
    for (int l = 0; l < 2; l++) {
      if (!(m.pred >> l & 1)) continue;
      const Frame& rf = list[l][m.ref[l]]->f;
      const uint8_t* src = c == 0 ? rf.y.data() : c == 1 ? rf.cb.data() : rf.cr.data();
      const int stride = c ? rf.cstride() : rf.pw;
      const int mvx = m.mv[l][0], mvy = m.mv[l][1];
      if (c == 0)
        interpolate(src, stride, W, H, false, x + (mvx >> 2), y + (mvy >> 2), mvx & 3, mvy & 3,
                    bw, bh, buf[nl]);
      else
        interpolate(src, stride, W / 2, H / 2, true, x + (mvx >> 3), y + (mvy >> 3), mvx & 7,
                    mvy & 7, bw, bh, buf[nl]);
      lists[nl++] = l;
    }
    int w0 = 0, w1 = 0, o0 = 0, o1 = 0, log2wd = 0;
    if (weighted) {
      log2wd = (c ? sh.chroma_wd : sh.luma_wd) + 6;
      const int l0 = lists[0], r0 = m.ref[l0];
      w0 = c ? sh.cw[l0][r0][c - 1] : sh.lw[l0][r0];
      o0 = c ? sh.co[l0][r0][c - 1] : sh.lo[l0][r0];
      if (nl == 2) {
        const int r1 = m.ref[1];
        w1 = c ? sh.cw[1][r1][c - 1] : sh.lw[1][r1];
        o1 = c ? sh.co[1][r1][c - 1] : sh.lo[1][r1];
      }
    }
    weight(buf[0], nl == 2 ? buf[1] : nullptr, bw * bh, weighted, log2wd, w0, w1, o0, o1, pred);
    Frame& f = cur->f;
    uint8_t* dst = c == 0 ? f.y.data() : c == 1 ? f.cb.data() : f.cr.data();
    const int ds = c ? f.cstride() : f.pw;
    for (int j = 0; j < bh; j++) std::memcpy(dst + (size_t)(y + j) * ds + x, pred + j * bw, bw);
  }
}

// --- transform tree and residuals (7.3.8.8 - 7.3.8.11) -------------------------------

int Decoder::chroma_mode(int luma) const {
  if (intra_chroma == 4) return luma;
  static const int k[4] = {0, 26, 10, 1};
  return k[intra_chroma] == luma ? 34 : k[intra_chroma];
}

void Decoder::transform_tree(int x0, int y0, int xb, int yb, int log2, int depth, int blk,
                             int maxd, bool isplit, int pcb, int pcr) {
  int split;
  if (log2 <= S.log2_max_tb && log2 > S.log2_min_tb && depth < maxd && !(isplit && depth == 0)) {
    split = dec(kSplitTu + 5 - log2);
  } else {
    const bool inter_split = S.max_th_inter == 0 && !cu_intra && part != 0 && depth == 0;
    split = log2 > S.log2_max_tb || (isplit && depth == 0) || inter_split;
  }
  int cb = pcb, cr = pcr;
  if (log2 > 2) {
    cb = (depth == 0 || pcb) ? dec(kCbfChroma + depth) : 0;
    cr = (depth == 0 || pcr) ? dec(kCbfChroma + depth) : 0;
  }
  if (split) {
    const int h = 1 << (log2 - 1);
    transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0, maxd, isplit, cb, cr);
    transform_tree(x0 + h, y0, x0, y0, log2 - 1, depth + 1, 1, maxd, isplit, cb, cr);
    transform_tree(x0, y0 + h, x0, y0, log2 - 1, depth + 1, 2, maxd, isplit, cb, cr);
    transform_tree(x0 + h, y0 + h, x0, y0, log2 - 1, depth + 1, 3, maxd, isplit, cb, cr);
  } else {
    bool cbf_l = true;
    if (cu_intra || depth != 0 || cb || cr) cbf_l = dec(kCbfLuma + (depth == 0 ? 1 : 0));
    transform_unit(x0, y0, xb, yb, log2, blk, cbf_l, cb, cr);
  }
}

void Decoder::transform_unit(int x0, int y0, int xb, int yb, int log2, int blk, bool cbf_l,
                             int cb, int cr) {
  const int lmode = cu_intra ? luma_mode_at(x0, y0) : -1;
  if (cu_intra) intra(x0, y0, log2, 0, lmode);
  if ((cbf_l || cb || cr) && P.cu_qp_delta && !qp_delta_coded) {
    int v = 0;
    while (v < 5 && dec(kQpDelta + (v ? 1 : 0))) v++;
    if (v == 5) {
      int k = 0;
      while (bypass()) {
        v += 1 << k;
        if (++k > 31) fail("cu_qp_delta_abs too long");
      }
      v += bypass_bits(k);
    }
    if (v && bypass()) v = -v;
    if (v < -26 || v > 25) fail("cu_qp_delta out of range");
    cu_qp_delta = v;
    qp_delta_coded = true;
    set_qp();
  }
  const int n = 1 << log2;
  if (cbf_l) {
    residual(x0, y0, log2, 0, lmode);
    for (int j = 0; j < n / 4; j++)
      for (int i = 0; i < n / 4; i++) flags4[((y0 >> 2) + j) * W4 + (x0 >> 2) + i] |= kIsNz;
  }
  const int cmode = cu_intra ? chroma_mode(luma_mode_at(cu_x, cu_y)) : -1;
  if (log2 > 2) {
    for (int c = 1; c <= 2; c++) {
      if (cu_intra) intra(x0 / 2, y0 / 2, log2 - 1, c, cmode);
      if (c == 1 ? cb : cr) residual(x0 / 2, y0 / 2, log2 - 1, c, cmode);
    }
  } else if (blk == 3) {
    for (int c = 1; c <= 2; c++) {
      if (cu_intra) intra(xb / 2, yb / 2, 2, c, cmode);
      if (c == 1 ? cb : cr) residual(xb / 2, yb / 2, 2, c, cmode);
    }
  }
  edges(x0, y0, n, n, true);
}

void Decoder::intra(int x0, int y0, int log2, int c, int mode) {
  const int n = 1 << log2, s = c ? 1 : 0, unit = 4 >> s;
  Frame& f = cur->f;
  uint8_t* pl = c == 0 ? f.y.data() : c == 1 ? f.cb.data() : f.cr.data();
  const int stride = c ? f.cstride() : f.pw;
  const int xl = x0 << s, yl = y0 << s;
  uint8_t ref[4 * 32 + 1], av[4 * 32 + 1];
  auto ok = [&](int xn, int yn) {
    const int lx = xn * (1 << s), ly = yn * (1 << s);
    return avail(xl, yl, lx, ly);
  };
  av[0] = ok(x0 - 1, y0 - 1);
  ref[0] = av[0] ? pl[(size_t)(y0 - 1) * stride + x0 - 1] : 0;
  for (int k = 0; k < 2 * n; k += unit) {
    const bool a = ok(x0 - 1, y0 + k), t = ok(x0 + k, y0 - 1);
    for (int u = 0; u < unit; u++) {
      av[1 + k + u] = a;
      ref[1 + k + u] = a ? pl[(size_t)(y0 + k + u) * stride + x0 - 1] : 0;
      av[1 + 2 * n + k + u] = t;
      ref[1 + 2 * n + k + u] = t ? pl[(size_t)(y0 - 1) * stride + x0 + k + u] : 0;
    }
  }
  if (P.constrained_intra) cip_references(x0, y0, log2, c, ref, av);
  uint8_t out[32 * 32];
  intra_predict(ref, av, log2, c, mode, S.strong_intra, out);
  for (int j = 0; j < n; j++) std::memcpy(pl + (size_t)(y0 + j) * stride + x0, out + j * n, n);
}

// FFmpeg: the references under constrained intra prediction as
// hevcpred_template.c's intra_pred builds them, which departs from the
// standard's substitution (8.4.4.2.2): a region's use is decided from its
// minimum prediction blocks (every other one, and none at all for the left
// and bottom-left regions of a block shorter than one), then samples of
// blocks not coded intra are replaced scanning in its own order. In:
// the references and their availability as gathered (ref / av: corner,
// 2n left downwards, 2n top rightwards); out: every reference set, av all
// ones.
void Decoder::cip_references(int x0, int y0, int log2, int c, uint8_t* ref, uint8_t* av) const {
  const int n = 1 << log2, s = c ? 1 : 0;
  const int X0 = x0 << s, Y0 = y0 << s, size_l = n << s;  // luma position and size
  const int lpu = S.log2_min_cb - 1;
  const int min_pu_w = W >> lpu, min_pu_h = H >> lpu;
  auto mvf_intra = [&](int pu_x, int pu_y) {
    const int x = pu_x * (1 << lpu), y = pu_y * (1 << lpu);
    return x >= 0 && y >= 0 && x < W && y < H && (flags4[idx4(x, y)] & kIsIntra);
  };
  // IS_INTRA(x, y) of a sample at (x, y) from the block, component units
  auto is_intra = [&](int x, int y) {
    return mvf_intra((X0 + x * (1 << s)) >> lpu, (Y0 + y * (1 << s)) >> lpu);
  };
  bool cand_up_left = av[0], cand_left = av[1], cand_bottom_left = av[1 + n];
  bool cand_up = av[1 + 2 * n], cand_up_right = av[1 + 3 * n];
  int bottom_left_size = 0, top_right_size = 0;
  for (int k = 0; k < n; k++) {
    bottom_left_size += av[1 + n + k];
    top_right_size += av[1 + 3 * n + k];
  }
  int pu_v = size_l >> lpu, pu_h = size_l >> lpu;
  const bool edge_x = !(X0 & ((1 << lpu) - 1)), edge_y = !(Y0 & ((1 << lpu) - 1));
  if (!pu_h) pu_h = 1;
  if (cand_bottom_left && edge_x) {
    const int xp = (X0 - 1) >> lpu, yp = (Y0 + size_l) >> lpu;
    const int mx = std::min(pu_v, min_pu_h - yp);
    cand_bottom_left = false;
    for (int i = 0; i < mx; i += 2) cand_bottom_left |= mvf_intra(xp, yp + i);
  }
  if (cand_left && edge_x) {
    const int xp = (X0 - 1) >> lpu, yp = Y0 >> lpu;
    const int mx = std::min(pu_v, min_pu_h - yp);
    cand_left = false;
    for (int i = 0; i < mx; i += 2) cand_left |= mvf_intra(xp, yp + i);
  }
  if (cand_up_left) cand_up_left = mvf_intra((X0 - 1) >> lpu, (Y0 - 1) >> lpu);
  if (cand_up && edge_y) {
    const int xp = X0 >> lpu, yp = (Y0 - 1) >> lpu;
    const int mx = std::min(pu_h, min_pu_w - xp);
    cand_up = false;
    for (int i = 0; i < mx; i += 2) cand_up |= mvf_intra(xp + i, yp);
  }
  if (cand_up_right && edge_y) {
    const int xp = (X0 + size_l) >> lpu, yp = (Y0 - 1) >> lpu;
    const int mx = std::min(pu_h, min_pu_w - xp);
    cand_up_right = false;
    for (int i = 0; i < mx; i += 2) cand_up_right |= mvf_intra(xp + i, yp);
  }
  // left[-1 .. 2n-1] and top[-1 .. 2n-1]: FFmpeg's arrays, filled with 128
  int lb[2 * 32 + 1], tb[2 * 32 + 1];
  int* left = lb + 1;
  int* top = tb + 1;
  for (int k = 0; k < 2 * n; k++) left[k] = top[k] = 128;
  left[-1] = top[-1] = 128;
  if (cand_up_left) left[-1] = top[-1] = ref[0];
  if (cand_up)
    for (int k = 0; k < n; k++) top[k] = ref[1 + 2 * n + k];
  if (cand_up_right) {
    for (int k = 0; k < n; k++) top[n + k] = ref[1 + 3 * n + k];
    for (int k = top_right_size; k < n; k++) top[n + k] = top[n + top_right_size - 1];
  }
  if (cand_left)
    for (int k = 0; k < n; k++) left[k] = ref[1 + k];
  if (cand_bottom_left) {
    for (int k = 0; k < bottom_left_size; k++) left[n + k] = ref[1 + n + k];
    for (int k = bottom_left_size; k < n; k++) left[n + k] = left[n + bottom_left_size - 1];
  }
  auto extend = [&](int* p, int v, int len) {  // EXTEND writes whole groups of 4
    for (int i = 0; i < len; i += 4)
      for (int k = 0; k < 4; k++) p[i + k] = v;
  };
  if (cand_bottom_left || cand_left || cand_up_left || cand_up || cand_up_right) {
    const int w = W, h = H;
    int size_max_x = X0 + ((2 * n) << s) < w ? 2 * n : (w - X0) >> s;
    int size_max_y = Y0 + ((2 * n) << s) < h ? 2 * n : (h - Y0) >> s;
    int j = n + (cand_bottom_left ? bottom_left_size : 0) - 1;
    if (!cand_up_right) size_max_x = X0 + (n << s) < w ? n : (w - X0) >> s;
    if (!cand_bottom_left) size_max_y = Y0 + (n << s) < h ? n : (h - Y0) >> s;
    if (cand_bottom_left || cand_left || cand_up_left) {
      while (j > -1 && !is_intra(-1, j)) j--;
      if (!is_intra(-1, j)) {
        j = 0;
        while (j < size_max_x && !is_intra(j, -1)) j++;
        for (int i = j; i > j - (j + 1); i--)  // EXTEND_LEFT_CIP(top, j, j + 1)
          if (!is_intra(i - 1, -1)) top[i - 1] = top[i];
        left[-1] = top[-1];
      }
    } else {
      j = 0;
      while (j < size_max_x && !is_intra(j, -1)) j++;
      if (j > 0) {
        for (int i = j; i > 0; i--)  // EXTEND_LEFT_CIP(top, j, j)
          if (!is_intra(i - 1, -1)) top[i - 1] = top[i];
        top[-1] = top[0];
      }
      left[-1] = top[-1];
    }
    left[-1] = top[-1];
    int a;
    if (cand_bottom_left || cand_left) {  // EXTEND_DOWN_CIP(left, 0, size_max_y)
      a = left[-1];
      for (int i = 0; i < size_max_y; i += 4) {
        if (!is_intra(-1, i))
          for (int k = 0; k < 4; k++) left[i + k] = a;
        else
          a = left[i + 3];
      }
    }
    if (!cand_left) extend(left, left[-1], n);
    if (!cand_bottom_left) extend(left + n, left[n - 1], n);
    auto extend_up = [&]() {  // EXTEND_UP_CIP(left, size_max_y - 1, size_max_y)
      a = left[size_max_y - 1];
      for (int i = size_max_y - 1; i > -1; i -= 4) {
        if (!is_intra(-1, i - 3))
          for (int k = 0; k < 4; k++) left[i - 3 + k] = a;
        else
          a = left[i - 3];
      }
    };
    if (X0 != 0 && Y0 != 0) {
      extend_up();
      if (!is_intra(-1, -1)) left[-1] = left[0];
    } else if (X0 == 0) {
      extend(left, 0, size_max_y);
    } else {
      extend_up();
    }
    top[-1] = left[-1];
    if (Y0 != 0) {  // EXTEND_RIGHT_CIP(top, 0, size_max_x)
      a = left[-1];
      for (int i = 0; i < size_max_x; i += 4) {
        if (!is_intra(i, -1))
          for (int k = 0; k < 4; k++) top[i + k] = a;
        else
          a = top[i + 3];
      }
    }
  }
  // the unavailable samples (as without constrained intra prediction)
  if (!cand_bottom_left) {
    if (cand_left) {
      extend(left + n, left[n - 1], n);
    } else if (cand_up_left) {
      extend(left, left[-1], 2 * n);
      cand_left = true;
    } else if (cand_up) {
      left[-1] = top[0];
      extend(left, left[-1], 2 * n);
      cand_up_left = cand_left = true;
    } else if (cand_up_right) {
      extend(top, top[n], n);
      left[-1] = top[n];
      extend(left, left[-1], 2 * n);
      cand_up = cand_up_left = cand_left = true;
    } else {
      left[-1] = 128;
      extend(top, left[-1], 2 * n);
      extend(left, left[-1], 2 * n);
    }
  }
  if (!cand_left) extend(left, left[n], n);
  if (!cand_up_left) left[-1] = left[0];
  if (!cand_up) extend(top, left[-1], n);
  if (!cand_up_right) extend(top + n, top[n - 1], n);
  top[-1] = left[-1];
  ref[0] = (uint8_t)left[-1];
  for (int k = 0; k < 2 * n; k++) {
    ref[1 + k] = (uint8_t)left[k];
    ref[1 + 2 * n + k] = (uint8_t)top[k];
  }
  std::memset(av, 1, 4 * n + 1);
}

// residual_coding (7.3.8.11), then scaling, transform and reconstruction
void Decoder::residual(int x0, int y0, int log2, int c, int mode) {
  const int n = 1 << log2;
  std::memset(coef, 0, sizeof(int16_t) * n * n);
  bool ts = false;
  if (P.transform_skip && !cu_bypass && log2 == 2) ts = dec(kTsFlag + (c ? 1 : 0));
  int off, shift;
  if (c == 0) {
    off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
    shift = (log2 + 1) >> 2;
  } else {
    off = 15;
    shift = log2 - 2;
  }
  const int maxp = (log2 << 1) - 1;
  int px = 0, py = 0;
  while (px < maxp && dec(kLastX + off + (px >> shift))) px++;
  while (py < maxp && dec(kLastY + off + (py >> shift))) py++;
  int lx = px, ly = py;
  if (px > 3) {
    const int k = (px >> 1) - 1;
    lx = (1 << k) * (2 + (px & 1)) + bypass_bits(k);
  }
  if (py > 3) {
    const int k = (py >> 1) - 1;
    ly = (1 << k) * (2 + (py & 1)) + bypass_bits(k);
  }
  int scan = 0;
  if (mode >= 0 && (log2 == 2 || (log2 == 3 && c == 0)))
    scan = (mode >= 6 && mode <= 14) ? 2 : (mode >= 22 && mode <= 30) ? 1 : 0;
  if (scan == 2) std::swap(lx, ly);
  const int lsb = log2 - 2, nsb = 1 << lsb;
  auto sbpos = [&](int i) { return lsb == 0 ? 0 : (int)kScan.s[lsb][scan][i]; };
  const uint8_t* cs = kScan.s[2][scan];
  int last_sb = (1 << (2 * lsb)) - 1, last_pos = 16;
  while (true) {
    if (last_pos == 0) {
      if (--last_sb < 0) fail("last significant coefficient not on the scan");
      last_pos = 16;
    }
    last_pos--;
    const int sp = sbpos(last_sb), p = cs[last_pos];
    if (((sp & 15) << 2) + (p & 15) == lx && ((sp >> 4) << 2) + (p >> 4) == ly) break;
  }
  uint8_t csbf[8][8];
  std::memset(csbf, 0, sizeof(csbf));
  static const uint8_t kCtxMap[16] = {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8};
  int g1ctx = 1;
  const bool hide_ok = P.sign_hiding && !cu_bypass;
  for (int i = last_sb; i >= 0; i--) {
    const int sp = sbpos(i), xs = sp & 15, ys = sp >> 4;
    bool infer_dc = false;
    if (i < last_sb && i > 0) {
      const int r = xs + 1 < nsb ? csbf[xs + 1][ys] : 0, b = ys + 1 < nsb ? csbf[xs][ys + 1] : 0;
      csbf[xs][ys] = (uint8_t)dec(kCsbf + std::min(1, r + b) + (c ? 2 : 0));
      infer_dc = true;
    } else {
      csbf[xs][ys] = 1;
    }
    const int prev = (xs + 1 < nsb ? csbf[xs + 1][ys] : 0) | ((ys + 1 < nsb ? csbf[xs][ys + 1] : 0) << 1);
    int pos[16], ns = 0;
    int start = 15;
    if (i == last_sb) {
      pos[ns++] = last_pos;
      start = last_pos - 1;
    }
    if (csbf[xs][ys]) {
      for (int k = start; k >= 0; k--) {
        const int p = cs[k], xp = p & 15, yp = p >> 4;
        const int xc = (xs << 2) + xp, yc = (ys << 2) + yp;
        if (k == 0 && infer_dc) {
          pos[ns++] = 0;
          break;
        }
        int sc;
        if (log2 == 2) {
          sc = kCtxMap[(yc << 2) + xc];
        } else if (xc + yc == 0) {
          sc = 0;
        } else {
          if (prev == 0) sc = (xp + yp == 0) ? 2 : (xp + yp < 3) ? 1 : 0;
          else if (prev == 1) sc = yp == 0 ? 2 : yp == 1 ? 1 : 0;
          else if (prev == 2) sc = xp == 0 ? 2 : xp == 1 ? 1 : 0;
          else sc = 2;
          if (c == 0) {
            if (xs + ys > 0) sc += 3;
            sc += log2 == 3 ? (scan == 0 ? 9 : 15) : 21;
          } else {
            sc += log2 == 3 ? 9 : 12;
          }
        }
        if (dec(kSig + (c ? 27 + sc : sc))) {
          pos[ns++] = k;
          infer_dc = false;
        }
      }
    }
    if (!ns) continue;
    // levels
    int ctx_set = (i > 0 && c == 0) ? 2 : 0;
    if (i != last_sb && g1ctx == 0) ctx_set++;
    g1ctx = 1;
    int g1[16] = {0}, first_g1 = -1;
    for (int m = 0; m < std::min(ns, 8); m++) {
      g1[m] = dec(kGt1 + ctx_set * 4 + g1ctx + (c ? 16 : 0));
      if (g1[m]) {
        g1ctx = 0;
        if (first_g1 < 0) first_g1 = m;
      } else if (g1ctx > 0 && g1ctx < 3) {
        g1ctx++;
      }
    }
    if (first_g1 >= 0) g1[first_g1] += dec(kGt2 + ctx_set + (c ? 4 : 0));
    const bool hidden = hide_ok && pos[0] - pos[ns - 1] > 3;
    const int nsign = ns - (hidden ? 1 : 0);
    const int signs = bypass_bits(nsign);
    int rice = 0, sum = 0;
    for (int m = 0; m < ns; m++) {
      int base = 1 + (m < 8 ? g1[m] : 0), lvl = base;
      if (base == (m < 8 ? (m == first_g1 ? 3 : 2) : 1)) {
        // coeff_abs_level_remaining (9.3.3.11), FFmpeg's form
        int prefix = 0;
        while (prefix < 32 && bypass()) prefix++;
        if (prefix >= 32) fail("coeff_abs_level_remaining prefix too long");
        int rem;
        if (prefix < 3) {
          rem = (prefix << rice) + bypass_bits(rice);
        } else {
          const int pm3 = prefix - 3;
          if (pm3 + rice > 22) fail("coeff_abs_level_remaining too large");
          rem = (((1 << pm3) + 3 - 1) << rice) + bypass_bits(pm3 + rice);
        }
        lvl = base + rem;
        if (lvl > 3 * (1 << rice)) rice = std::min(rice + 1, 4);
      }
      int v = lvl;
      if (m < nsign && ((signs >> (nsign - 1 - m)) & 1)) v = -v;
      if (hidden) {
        sum += lvl;
        if (m == ns - 1 && (sum & 1)) v = -v;
      }
      const int p = cs[pos[m]];
      const int xc = (xs << 2) + (p & 15), yc = (ys << 2) + (p >> 4);
      coef[yc * n + xc] = (int16_t)clip3(-32768, 32767, v);
    }
  }
  // scaling (8.6.2 / 8.6.4), transform and reconstruction
  Frame& f = cur->f;
  uint8_t* pl = c == 0 ? f.y.data() : c == 1 ? f.cb.data() : f.cr.data();
  const int stride = c ? f.cstride() : f.pw;
  if (cu_bypass) {
    for (int k = 0; k < n * n; k++) res[k] = coef[k];
  } else {
    int qp = qp_y;
    if (c) {
      const int qpi = clip3(0, 57, qp_y + (c == 1 ? P.cb_qp_offset + sh.cb_offset
                                                  : P.cr_qp_offset + sh.cr_offset));
      qp = chroma_qp(qpi);
    }
    const int bd_shift = log2 + 3;
    const int64_t scale = (int64_t)kLevelScale[qp % 6] << (qp / 6);
    const uint8_t* fac = S.scaling_enabled ? factors[cu_intra ? 0 : 1][c][log2 - 2] : nullptr;
    for (int k = 0; k < n * n; k++) {
      if (!coef[k]) continue;
      const int64_t m = fac ? fac[k] : 16;
      coef[k] = (int16_t)clip3(-32768, 32767,
                               (int)((coef[k] * m * scale + ((int64_t)1 << (bd_shift - 1))) >> bd_shift));
    }
    inverse_transform(coef, log2, cu_intra && c == 0 && log2 == 2, ts, res);
  }
  for (int j = 0; j < n; j++)
    for (int i = 0; i < n; i++) {
      uint8_t& d = pl[(size_t)(y0 + j) * stride + x0 + i];
      d = clip1(d + res[j * n + i]);
    }
}

// --- deblocking (8.7.2) ---------------------------------------------------------------

int Decoder::bs_of(int xp, int yp, int xq, int yq, bool tu) const {
  const int ip = idx4(xp, yp), iq = idx4(xq, yq);
  const int fp = flags4[ip], fq = flags4[iq];
  if ((fp | fq) & kIsIntra) return 2;
  if (tu && ((fp | fq) & kIsNz)) return 1;
  const Mvf& p = cur->mvf[ip];
  const Mvf& q = cur->mvf[iq];
  auto far = [](const int16_t* a, const int16_t* b) {
    return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4;
  };
  const int np = __builtin_popcount(p.pred), nq = __builtin_popcount(q.pred);
  if (np != nq) return 1;
  if (np == 1) {
    const int lp = p.pred & 1 ? 0 : 1, lq = q.pred & 1 ? 0 : 1;
    if (p.poc[lp] != q.poc[lq]) return 1;
    return far(p.mv[lp], q.mv[lq]);
  }
  const int p0 = p.poc[0], p1 = p.poc[1], q0 = q.poc[0], q1 = q.poc[1];
  if (!((p0 == q0 && p1 == q1) || (p0 == q1 && p1 == q0))) return 1;
  if (p0 != p1) {
    if (p0 == q0) return far(p.mv[0], q.mv[0]) || far(p.mv[1], q.mv[1]);
    return far(p.mv[0], q.mv[1]) || far(p.mv[1], q.mv[0]);
  }
  return (far(p.mv[0], q.mv[0]) || far(p.mv[1], q.mv[1])) &&
         (far(p.mv[0], q.mv[1]) || far(p.mv[1], q.mv[0]));
}

// bS of the left and top edges of a transform (tu) or prediction block at
// (x0, y0), w x h, where they lie on the 8x8 grid (8.7.2.2 - 8.7.2.4)
void Decoder::edges(int x0, int y0, int w, int h, bool tu) {
  if (sh.deblock_disabled) return;
  auto cross_ok = [&](int xp, int yp, int xq, int yq) {
    const int cp = (yp >> log2ctb) * ctb_w + (xp >> log2ctb);
    const int cq = (yq >> log2ctb) * ctb_w + (xq >> log2ctb);
    if (cp == cq) return true;
    if (!P.lf_across_tiles && tile_id[rs2ts[cp]] != tile_id[rs2ts[cq]]) return false;
    if (!sh.lf_across_slices && ctb_slice[cp] != ctb_slice[cq]) return false;
    return true;
  };
  if (x0 > 0 && !(x0 & 7)) {
    const bool ok = cross_ok(x0 - 1, y0, x0, y0);
    for (int y = y0; y < y0 + h && y < H; y += 4)
      bs_v[idx4(x0, y)] = (uint8_t)(ok ? bs_of(x0 - 1, y, x0, y, tu) : 0);
  }
  if (y0 > 0 && !(y0 & 7)) {
    const bool ok = cross_ok(x0, y0 - 1, x0, y0);
    for (int x = x0; x < x0 + w && x < W; x += 4)
      bs_h[idx4(x, y0)] = (uint8_t)(ok ? bs_of(x, y0 - 1, x, y0, tu) : 0);
  }
}

// FFmpeg: deblocking_filter_CTB, one CTB's pass: per 8-row strip the luma
// vertical edges, then the luma horizontal edges of the row (the last 8
// columns of the CTB to the left are filtered in this pass); then per
// chroma component the vertical and the horizontal edges. One beta / tC
// offset pair serves the picture: slices that differ in them are refused
// (`slice`). FFmpeg carries the offsets of the CTBs' slices through the
// pass in one variable, and a slice that overrides to disable keeps the
// offsets of the slice before; both count only once that refusal goes.
void Decoder::deblock_ctb(int rx, int ry) {
  Frame& f = cur->f;
  auto keep = [&](int x, int y) {
    const int fl = flags4[idx4(x, y)];
    return (fl & kIsBypass) || ((fl & kIsPcm) && S.pcm_lf_disabled);
  };
  auto qp_at = [&](int x, int y) { return (int)qp4[idx4(x, y)]; };
  const int cs = 1 << log2ctb;
  const int x0 = rx * cs, y0 = ry * cs;
  const int x_end = std::min(x0 + cs, W), y_end = std::min(y0 + cs, H);
  const int beta_off = headers.front().beta_offset, tc_off = headers.front().tc_offset;
  const int x_end2 = x_end == W ? x_end : x_end - 8;
  for (int y = y0; y < y_end; y += 8) {
    // luma, the strip's vertical edges
    for (int x = x0 ? x0 : 8; x < x_end; x += 8) {
      const int b0 = bs_v[idx4(x, y)], b1 = y + 4 < y_end ? bs_v[idx4(x, y + 4)] : 0;
      if (!b0 && !b1) continue;
      const int qp = (qp_at(x - 1, y) + qp_at(x, y) + 1) >> 1;
      for (int k = 0; k < 2; k++) {
        const int yy = y + 4 * k, b = k ? b1 : b0;
        if (!b) continue;
        filter_luma(&f.y[(size_t)yy * f.pw + x], f.pw, 1, b, qp, beta_off, tc_off,
                    keep(x - 1, yy), keep(x, yy));
      }
    }
    if (!y) continue;
    // luma, the row's horizontal edges
    for (int x = x0 ? x0 - 8 : 0; x < x_end2; x += 8) {
      const int b0 = bs_h[idx4(x, y)], b1 = bs_h[idx4(x + 4, y)];
      if (!b0 && !b1) continue;
      const int qp = (qp_at(x, y - 1) + qp_at(x, y) + 1) >> 1;
      for (int k = 0; k < 2; k++) {
        const int xx = x + 4 * k, b = k ? b1 : b0;
        if (!b) continue;
        filter_luma(&f.y[(size_t)y * f.pw + xx], 1, f.pw, b, qp, beta_off, tc_off,
                    keep(xx, y - 1), keep(xx, y));
      }
    }
  }
  for (int c = 1; c <= 2; c++) {
    std::vector<uint8_t>& pl = c == 1 ? f.cb : f.cr;
    const int off = c == 1 ? P.cb_qp_offset : P.cr_qp_offset, st = f.cstride();
    // vertical edges on the 16-sample luma grid, bS 2
    for (int y = y0; y < y_end; y += 16)
      for (int x = x0 ? x0 : 16; x < x_end; x += 16)
        for (int k = 0; k < 2 && y + 8 * k < y_end; k++) {
          const int yy = y + 8 * k;
          if (bs_v[idx4(x, yy)] != 2) continue;
          const int qp = (qp_at(x - 1, yy) + qp_at(x, yy) + 1) >> 1;
          filter_chroma(&pl[(size_t)(yy / 2) * st + x / 2], st, 1, 4,
                        chroma_tc(qp, off, tc_off), keep(x - 1, yy), keep(x, yy));
        }
    // horizontal edges
    const int x_end3 = x_end == W ? x_end : x_end - 16;
    for (int y = y0; y < y_end; y += 16) {
      if (!y) continue;
      for (int x = x0 ? x0 - 16 : 0; x < x_end3; x += 16)
        for (int k = 0; k < 2 && x + 8 * k < W; k++) {
          const int xx = x + 8 * k;
          if (bs_h[idx4(xx, y)] != 2) continue;
          const int qp = (qp_at(xx, y - 1) + qp_at(xx, y) + 1) >> 1;
          filter_chroma(&pl[(size_t)(y / 2) * st + xx / 2], 1, st, 4,
                        chroma_tc(qp, off, tc_off), keep(xx, y - 1),
                        keep(xx, y));
        }
    }
  }
}

// --- SAO (8.7.3) ----------------------------------------------------------------------

// SAO of one CTB (FFmpeg's sao_filter_CTB): its samples and those round it
// as they stand (deblocked so far), a neighbour CTB already filtered read
// from the samples it had then (FFmpeg's sao_pixel_buffer copies)
void Decoder::sao_ctb(int rx, int ry) {
  Frame& f = cur->f;
  const int cs = 1 << log2ctb, rs = ry * ctb_w + rx;
  if (ctb_sh[rs] < 0) return;
  const SaoParams& sp = sao[rs];
  const SliceHeader& h = headers[ctb_sh[rs]];
  // the neighbour CTBs an edge offset may read
  static const int kD[8][2] = {{-1, 0}, {1, 0}, {0, -1}, {0, 1}, {-1, -1}, {1, -1}, {-1, 1}, {1, 1}};
  bool usable[8];
  for (int d = 0; d < 8; d++) {
    const int nx = rx + kD[d][0], ny = ry + kD[d][1];
    usable[d] = nx >= 0 && ny >= 0 && nx < ctb_w && ny < ctb_h;
    if (!usable[d]) continue;
    const int nr = ny * ctb_w + nx;
    if (ctb_sh[nr] < 0) {
      usable[d] = false;
      continue;
    }
    // FFmpeg: the CTB's own slice_loop_filter_across_slices_enabled_flag
    // for every neighbour (the standard takes a later neighbour's own)
    if (ctb_slice[nr] != ctb_slice[rs] && !h.lf_across_slices) usable[d] = false;
    if (!P.lf_across_tiles && tile_id[rs2ts[nr]] != tile_id[rs2ts[rs]]) usable[d] = false;
  }
  for (int c = 0; c < 3; c++) {
    if (!sp.type[c]) continue;
    const int s = c ? 1 : 0;
    const int x0 = (rx * cs) >> s, y0 = (ry * cs) >> s, pw = W >> s, ph = H >> s;
    const int w = std::min(cs >> s, pw - x0), hh = std::min(cs >> s, ph - y0);
    std::vector<uint8_t>& cp = c == 0 ? f.y : c == 1 ? f.cb : f.cr;
    std::vector<uint8_t>& pp = sao_pre[c];
    const int stride = c ? f.cstride() : f.pw;
    // the block and one sample round it
    std::vector<uint8_t> win((size_t)(w + 2) * (hh + 2), 0);
    for (int j = -1; j <= hh; j++)
      for (int i = -1; i <= w; i++) {
        const int xx = x0 + i, yy = y0 + j;
        if (xx < 0 || yy < 0 || xx >= pw || yy >= ph) continue;
        const int nr = ((yy << s) >> log2ctb) * ctb_w + ((xx << s) >> log2ctb);
        const bool done = sao_done[c][nr] && nr != rs;
        win[(size_t)(j + 1) * (w + 2) + i + 1] = (done ? pp : cp)[(size_t)yy * stride + xx];
      }
    for (int j = 0; j < hh; j++)
      std::memcpy(&pp[(size_t)(y0 + j) * stride + x0], &cp[(size_t)(y0 + j) * stride + x0], w);
    sao_done[c][rs] = 1;
    sao_block(&win[(size_t)(w + 2) + 1], w + 2, &cp[(size_t)y0 * stride + x0], stride, w, hh,
              sp.type[c], sp.band[c], sp.eo[c], sp.off[c], usable);
    // PCM (loop filter off) and transquant-bypass samples are left.
    // FFmpeg: restore_tqb_pixels walks the minimum prediction blocks
    // from the CTB's luma origin over the component's width and height,
    // so in chroma only those of the CTB's top-left quarter keep their
    // samples
    if (!P.bypass && !(S.pcm && S.pcm_lf_disabled)) continue;
    const int lpu = S.log2_min_cb - 1, pu = 1 << lpu, X = rx * cs, Y = ry * cs;
    for (int py = Y >> lpu; py < (Y + hh) >> lpu; py++)
      for (int px = X >> lpu; px < (X + w) >> lpu; px++) {
        const int fl = flags4[idx4(px << lpu, py << lpu)];
        if (!((fl & kIsBypass) || ((fl & kIsPcm) && S.pcm_lf_disabled))) continue;
        const int cx = ((px << lpu) - X) >> s, cy = ((py << lpu) - Y) >> s;
        for (int jj = 0; jj < pu >> s; jj++)
          std::memcpy(&cp[(size_t)(y0 + cy + jj) * stride + x0 + cx],
                      &pp[(size_t)(y0 + cy + jj) * stride + x0 + cx], pu >> s);
      }
  }
}

// FFmpeg's ff_hevc_hls_filter: deblocks CTB (x, y) (luma position), then
// filters with SAO the CTBs whose neighbours are all deblocked by now
void Decoder::hls_filter(int x, int y) {
  const int cs = 1 << log2ctb;
  const bool x_end = x >= W - cs, y_end = y >= H - cs;
  deblock_ctb(x >> log2ctb, y >> log2ctb);
  if (!S.sao) return;
  if (y && x) sao_ctb((x - cs) >> log2ctb, (y - cs) >> log2ctb);
  if (x && y_end) sao_ctb((x - cs) >> log2ctb, y >> log2ctb);
  if (y && x_end) sao_ctb(x >> log2ctb, (y - cs) >> log2ctb);
  if (x_end && y_end) sao_ctb(x >> log2ctb, y >> log2ctb);
}

// The loop filters as FFmpeg runs them while it decodes: after each CTB
// (in decoding order) the filters ff_hevc_hls_filters calls. The order is
// FFmpeg's so that SAO reads what FFmpeg's reads: with 16x16 CTBs its SAO
// of a CTB runs before the chroma of the first columns of the CTBs to its
// right and below-right is deblocked across their lower edge.
void Decoder::loop_filters() {
  const int cs = 1 << log2ctb;
  for (int c = 0; c < 3; c++) {
    sao_done[c].assign(nctb, 0);
    const Frame& f = cur->f;
    sao_pre[c] = c == 0 ? f.y : c == 1 ? f.cb : f.cr;
  }
  int last = -1;
  for (int ts = 0; ts < nctb; ts++) {
    const int rs = ts2rs[ts];
    if (ctb_sh[rs] < 0) continue;
    const int x = (rs % ctb_w) * cs, y = (rs / ctb_w) * cs;
    const bool x_end = x >= W - cs, y_end = y >= H - cs;
    if (y && x) hls_filter(x - cs, y - cs);
    if (y && x_end) hls_filter(x, y - cs);
    if (x && y_end) hls_filter(x - cs, y);
    last = rs;
  }
  if (last >= 0) {
    const int x = (last % ctb_w) * cs, y = (last / ctb_w) * cs;
    if (x + cs >= W && y + cs >= H) hls_filter(x, y);
  }
}

}  // namespace hevc
