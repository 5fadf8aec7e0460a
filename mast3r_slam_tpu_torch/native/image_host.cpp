// The per-frame host arithmetic of the port's dataset readers, bound with
// ctypes by data/image_host.py:
//   - png_unfilter undoes the five PNG scanline filters (None, Sub, Up,
//     Average, Paeth) over one pass of a PNG image, as libpng's
//     png_read_filter_row does: the PNG specification's predictors, the
//     Paeth predictor's ties going to a, then b, then c, and a previous
//     row of zeros at the start of each pass (data/png.py);
//   - remap_bilinear_f32 is cv2.remap(img, mapx, mapy, INTER_LINEAR) with
//     zero borders on a float32 image, as OpenCV 5.0 interpolates in
//     float: v0 = fma(tx, b - a, a), v1 = fma(tx, d - c, c),
//     out = fma(ty, v1 - v0, v0) (data/undistort.py).
//
// Every operand of the remap is a float and every fma is a correctly
// rounded float fma, whether the CPU has the FMA instruction (the clone
// that target_clones builds for it) or not (glibc's fmaf in software): the
// results are OpenCV's bit for bit either way. The file must not be built
// with -ffast-math, and the remap's only products are the fmas, so no
// contraction of a product and a sum can change it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// The Paeth predictor of a (left), b (up) and c (up left): of a, b and c
// the one nearest to a + b - c, ties going to a, then b. Written as two
// selections (b over a only when strictly nearer, then c over the winner
// only when strictly nearer), which the compiler makes branch free: on
// noisy rows a branch per byte mispredicts.
inline int paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c),
            pc = std::abs(a + b - 2 * c);
  const bool take_b = pb < pa;
  const int nearest = take_b ? pb : pa;
  const int pred = take_b ? b : a;
  return pc < nearest ? c : pred;
}

// One row of n bytes: out = row unfiltered against prev (the unfiltered
// row above, zeros for a pass's first). Returns false for a filter type
// above 4.
bool unfilter_row(int ftype, const uint8_t* __restrict row,
                  const uint8_t* __restrict prev, int64_t n, int64_t bpp,
                  uint8_t* __restrict out) {
  const int64_t lead = std::min(bpp, n);   // bytes with no left neighbour
  switch (ftype) {
    case 0:
      std::memcpy(out, row, n);
      return true;
    case 1:
      std::memcpy(out, row, lead);
      for (int64_t i = lead; i < n; ++i)
        out[i] = static_cast<uint8_t>(row[i] + out[i - bpp]);
      return true;
    case 2:
      for (int64_t i = 0; i < n; ++i)
        out[i] = static_cast<uint8_t>(row[i] + prev[i]);
      return true;
    case 3:
      for (int64_t i = 0; i < lead; ++i)
        out[i] = static_cast<uint8_t>(row[i] + (prev[i] >> 1));
      for (int64_t i = lead; i < n; ++i)
        out[i] = static_cast<uint8_t>(row[i] + ((out[i - bpp] + prev[i]) >> 1));
      return true;
    case 4:
      // with no left neighbour a = c = 0 and the predictor is b
      for (int64_t i = 0; i < lead; ++i)
        out[i] = static_cast<uint8_t>(row[i] + prev[i]);
      for (int64_t i = lead; i < n; ++i)
        out[i] = static_cast<uint8_t>(
            row[i] + paeth(out[i - bpp], prev[i], prev[i - bpp]));
      return true;
    default:
      return false;
  }
}

// The remap with C channels (C_ 1 or 3 fixed at compile time, 0: C at
// run time). Inlined into each clone of remap_bilinear_f32, so the fma
// clone's std::fma is the FMA instruction.
template <int C_>
inline void remap(const float* __restrict img, int64_t pixels, int64_t C,
                  const int32_t* __restrict corners,
                  const float* __restrict tx, const float* __restrict ty,
                  int64_t n, float* __restrict out) {
  if (C_) C = C_;
  const uint64_t outside = static_cast<uint64_t>(pixels);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t k[4];
    for (int j = 0; j < 4; ++j)
      k[j] = static_cast<uint64_t>(static_cast<int64_t>(corners[j * n + i]));
    const float fx = tx[i], fy = ty[i];
    for (int64_t ch = 0; ch < C; ++ch) {
      const float a = k[0] < outside ? img[k[0] * C + ch] : 0.0f;
      const float b = k[1] < outside ? img[k[1] * C + ch] : 0.0f;
      const float c = k[2] < outside ? img[k[2] * C + ch] : 0.0f;
      const float d = k[3] < outside ? img[k[3] * C + ch] : 0.0f;
      const float v0 = std::fma(fx, b - a, a);
      const float v1 = std::fma(fx, d - c, c);
      out[i * C + ch] = std::fma(fy, v1 - v0, v0);
    }
  }
}

}  // namespace

extern "C" {

// raw: rows x (1 + stride) bytes, each row its filter type and then its
// stride filtered bytes; out: rows x stride unfiltered bytes; bpp: bytes a
// pixel (at least 1). Returns 0, or 1 with the offending filter type in
// *bad_filter.
int png_unfilter(const uint8_t* raw, int64_t rows, int64_t stride, int bpp,
                 uint8_t* out, int32_t* bad_filter) {
  const std::vector<uint8_t> zeros(stride, 0);
  const uint8_t* prev = zeros.data();
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* row = raw + y * (stride + 1);
    uint8_t* dst = out + y * stride;
    if (!unfilter_row(row[0], row + 1, prev, stride, bpp, dst)) {
      *bad_filter = row[0];
      return 1;
    }
    prev = dst;
  }
  return 0;
}

// img: H x W x C floats; corners: 4 x n flat source pixel indices (top
// left, top right, bottom left, bottom right), H * W for a corner outside
// the image; tx, ty: n float fractions; out: n x C floats. A corner index
// that is not below H * W (negative ones included) reads 0.
__attribute__((target_clones("fma", "default")))
void remap_bilinear_f32(const float* img, int64_t H, int64_t W, int64_t C,
                        const int32_t* corners, const float* tx,
                        const float* ty, int64_t n, float* out) {
  if (C == 1)
    remap<1>(img, H * W, 1, corners, tx, ty, n, out);
  else if (C == 3)
    remap<3>(img, H * W, 3, corners, tx, ty, n, out);
  else
    remap<0>(img, H * W, C, corners, tx, ty, n, out);
}

}  // extern "C"
