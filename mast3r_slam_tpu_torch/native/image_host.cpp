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
//     out = fma(ty, v1 - v0, v0) (data/undistort.py);
//   - resize_area_f32 is cv2.resize(img, (w, h), interpolation=INTER_AREA)
//     on a float32 image of 1 or 3 channels, as OpenCV 5.0 computes it,
//     for the rows and columns of a crop window only: the same size is a
//     copy; two integer scales take resizeAreaFast_'s sums; any other
//     shrink computeResizeAreaTab's table and ResizeArea_Invoker's sums
//     (data/image_ops.py). It can write, in the same pass, the model image
//     crop * 2 - 1 and the display image clip(crop * 255) as uint8
//     (truncated), as resize_img makes them.
//
// Every operand of the remap is a float and every fma is a correctly
// rounded float fma, whether the CPU has the FMA instruction (the clone
// that target_clones builds for it) or not (glibc's fmaf in software): the
// results are OpenCV's bit for bit either way. The file must not be built
// with -ffast-math, and the remap's only products are the fmas, so no
// contraction of a product and a sum can change it. The resize's sums are
// float products followed by float adds, never fused (OpenCV's own are
// not): the file is built with -ffp-contract=off (data/image_host.py).

#include <pthread.h>

#include <algorithm>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <thread>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef __SSE2__
#include <emmintrin.h>
#endif

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


// computeResizeAreaTab's table of one axis, n_in -> n_out (OpenCV 5.0,
// imgproc/src/resize.cpp), grouped by destination: the taps of
// destination d are si[ofs[d] .. ofs[d + 1]) with weights alpha, in the
// table's order. The scale is cv::resize's 1 / (n_out / n_in).
struct AreaTab {
  std::vector<int64_t> ofs, si;
  std::vector<float> alpha;
};

AreaTab area_tab(int64_t n_in, int64_t n_out) {
  AreaTab t;
  const double scale = 1.0 / (static_cast<double>(n_out) / n_in);
  auto push = [&t](int64_t s, float a) {
    t.si.push_back(s);
    t.alpha.push_back(a);
  };
  for (int64_t d = 0; d < n_out; ++d) {
    t.ofs.push_back(static_cast<int64_t>(t.si.size()));
    const double f1 = d * scale, f2 = f1 + scale;
    const double cell = std::min(scale, n_in - f1);
    int64_t s1 = static_cast<int64_t>(std::ceil(f1));
    int64_t s2 = static_cast<int64_t>(std::floor(f2));
    s2 = std::min(s2, n_in - 1);
    s1 = std::min(s1, s2);
    if (s1 - f1 > 1e-3) push(s1 - 1, static_cast<float>((s1 - f1) / cell));
    for (int64_t s = s1; s < s2; ++s) push(s, static_cast<float>(1.0 / cell));
    if (f2 - s2 > 1e-3)
      push(s2, static_cast<float>(std::min(std::min(f2 - s2, 1.0), cell) /
                                  cell));
  }
  t.ofs.push_back(static_cast<int64_t>(t.si.size()));
  return t;
}

// Where one output row of n floats goes: the raw crop, the model image
// (v * 2 - 1) and the display image (clip(v * 255, 0, 255) truncated to
// uint8; NaN gives 0, as numpy's cast does here), each optional.
struct Sink {
  float* raw;
  float* model;
  uint8_t* display;

  void emit(const float* v, int64_t n, int64_t row) const {
    const int64_t o = row * n;
    if (raw) std::memcpy(raw + o, v, n * sizeof(float));
    if (model)
      for (int64_t i = 0; i < n; ++i) model[o + i] = v[i] * 2.0f - 1.0f;
    if (display) {
      int64_t i = 0;
#ifdef __SSE2__
      // max(y, 0) then min(y, 255): MAXPS / MINPS take the second operand
      // for a NaN, as the scalar loop's comparisons do
      const __m128 lo = _mm_setzero_ps(), hi = _mm_set1_ps(255.0f),
                   k255 = _mm_set1_ps(255.0f);
      for (; i + 16 <= n; i += 16) {
        __m128i q[4];
        for (int j = 0; j < 4; ++j) {
          const __m128 y = _mm_mul_ps(_mm_loadu_ps(v + i + 4 * j), k255);
          q[j] = _mm_cvttps_epi32(_mm_min_ps(_mm_max_ps(y, lo), hi));
        }
        _mm_storeu_si128(
            reinterpret_cast<__m128i*>(display + o + i),
            _mm_packus_epi16(_mm_packs_epi32(q[0], q[1]),
                             _mm_packs_epi32(q[2], q[3])));
      }
#endif
      for (; i < n; ++i) {
        float y = v[i] * 255.0f;
        y = y > 0.0f ? y : 0.0f;     // NaN: 0
        y = y < 255.0f ? y : 255.0f;
        display[o + i] = static_cast<uint8_t>(static_cast<int32_t>(y));
      }
    }
  }
};

// One source row through the horizontal table, destinations x0..x1:
// out[(d - x0) * C + c] = sum over d's taps, in table order, of
// src[s * C + c] * alpha (each product rounded, then added).
template <int C>
void area_hrow(const float* __restrict src, const AreaTab& xt, int64_t x0,
               int64_t x1, float* __restrict out) {
  for (int64_t d = x0; d < x1; ++d) {
    float v[C] = {};
    for (int64_t k = xt.ofs[d]; k < xt.ofs[d + 1]; ++k) {
      const float a = xt.alpha[k];
      const float* p = src + xt.si[k] * C;
      for (int c = 0; c < C; ++c) v[c] = v[c] + p[c] * a;
    }
    for (int c = 0; c < C; ++c) out[(d - x0) * C + c] = v[c];
  }
}

// Output rows y0 + r0 .. y0 + r1 of the table path. A destination row is
// its first source row's sums times beta, plus each further row's sums
// times its beta, in table order (ResizeArea_Invoker). A source row shared
// with the row before is summed once: its sums are the same numbers.
template <int C>
void area_rows(const float* src, int64_t W, const AreaTab& xt,
               const AreaTab& yt, int64_t x0, int64_t x1, int64_t y0,
               int64_t r0, int64_t r1, const Sink& sink) {
  const int64_t n = (x1 - x0) * C;
  std::vector<float> a(n), b(n), sum(n);
  float* fresh = a.data();
  float* last = b.data();
  int64_t last_sy = -1;
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t dy = y0 + r;
    for (int64_t j = yt.ofs[dy]; j < yt.ofs[dy + 1]; ++j) {
      const int64_t sy = yt.si[j];
      if (sy != last_sy) {
        area_hrow<C>(src + sy * W * C, xt, x0, x1, fresh);
        std::swap(fresh, last);
        last_sy = sy;
      }
      const float beta = yt.alpha[j];
      if (j == yt.ofs[dy])
        for (int64_t i = 0; i < n; ++i) sum[i] = beta * last[i];
      else
        for (int64_t i = 0; i < n; ++i) sum[i] = sum[i] + beta * last[i];
    }
    sink.emit(sum.data(), n, r);
  }
}

// Output rows of resizeAreaFast_ (both scales integers sx, sy): each
// output value is the sum of its sx * sy source values in row-major order,
// added four at a time ((s0 + s1) + s2) + s3 into the running sum from 0,
// then times 1.f / (sx * sy). With one channel at 2 x 2, OpenCV's 128-bit
// vector loop takes the first (w / 4) * 4 values of each row as
// ((s00 + s01) + (s10 + s11)) * 0.25f (ResizeAreaFastVec_SIMD_32f).
template <int C>
void fast_rows(const float* src, int64_t W, int64_t w, int64_t sx,
               int64_t sy, int64_t x0, int64_t x1, int64_t y0, int64_t r0,
               int64_t r1, const Sink& sink) {
  const int64_t n = (x1 - x0) * C, area = sx * sy, row = W * C;
  const float scale = 1.0f / static_cast<float>(area);
  std::vector<int64_t> tap(area);      // OpenCV's ofs: row-major taps
  for (int64_t k = 0; k < area; ++k) tap[k] = (k / sx) * row + (k % sx) * C;
  // the columns the vector loop takes (C is 1 there)
  const int64_t split = C == 1 && sx == 2 && sy == 2
                            ? std::min(std::max(w / 4 * 4, x0), x1) : x0;
  std::vector<float> v(n);
  for (int64_t r = r0; r < r1; ++r) {
    const float* S = src + (y0 + r) * sy * row;
    for (int64_t d = x0; d < split; ++d) {
      const float* p = S + d * 2;
      v[d - x0] = ((p[0] + p[1]) + (p[row] + p[row + 1])) * 0.25f;
    }
    for (int64_t d = split; d < x1; ++d)
      for (int c = 0; c < C; ++c) {
        const float* p = S + d * sx * C + c;
        float s = 0.0f;
        int64_t k = 0;
        for (; k <= area - 4; k += 4)
          s = s + (((p[tap[k]] + p[tap[k + 1]]) + p[tap[k + 2]]) +
                   p[tap[k + 3]]);
        for (; k < area; ++k) s = s + p[tap[k]];
        v[(d - x0) * C + c] = s * scale;
      }
    sink.emit(v.data(), n, r);
  }
}

// Output rows of the same-size copy.
template <int C>
void copy_rows(const float* src, int64_t W, int64_t x0, int64_t x1,
               int64_t y0, int64_t r0, int64_t r1, const Sink& sink) {
  for (int64_t r = r0; r < r1; ++r)
    sink.emit(src + ((y0 + r) * W + x0) * C, (x1 - x0) * C, r);
}

// Worker threads kept across calls: starting a thread costs more than the
// resize of a small image on some hosts. A call hands out its parts and
// takes them itself as well, so it finishes even with no worker (in a
// forked child, which has none: the pool is made anew there).
class Pool {
 public:
  static Pool*& instance() {
    static Pool* pool = [] {
      pthread_atfork(nullptr, nullptr, [] { instance() = new Pool(); });
      return new Pool();
    }();
    return pool;
  }

  // task(0) .. task(parts - 1) on up to `threads` threads, this one
  // included; one call at a time
  void run(int64_t parts, int threads,
           const std::function<void(int64_t)>& task) {
    std::lock_guard<std::mutex> one(call_);
    {
      std::lock_guard<std::mutex> l(m_);
      while (static_cast<int>(workers_) < threads - 1) {
        std::thread(&Pool::loop, this).detach();
        ++workers_;
      }
      task_ = &task;
      next_ = 0;
      end_ = left_ = parts;
    }
    work_.notify_all();
    std::unique_lock<std::mutex> l(m_);
    drain(l);
    done_.wait(l, [this] { return left_ == 0; });
    task_ = nullptr;
  }

 private:
  // runs parts while any is left; m_ held on entry and exit
  void drain(std::unique_lock<std::mutex>& l) {
    while (next_ < end_) {
      const int64_t i = next_++;
      const auto* task = task_;
      l.unlock();
      (*task)(i);
      l.lock();
      if (--left_ == 0) done_.notify_all();
    }
  }

  void loop() {
    std::unique_lock<std::mutex> l(m_);
    for (;;) {
      work_.wait(l, [this] { return next_ < end_; });
      drain(l);
    }
  }

  std::mutex call_, m_;
  std::condition_variable work_, done_;
  const std::function<void(int64_t)>* task_ = nullptr;
  int64_t next_ = 0, end_ = 0, left_ = 0;
  int workers_ = 0;
};

// rows split into up to `threads` contiguous blocks of at least 16 rows,
// run on the pool.
template <typename F>
void over_rows(int64_t rows, int threads, F fn) {
  const int64_t parts =
      std::max<int64_t>(1, std::min<int64_t>(threads, rows / 16));
  if (parts == 1) {
    fn(0, rows);
    return;
  }
  const std::function<void(int64_t)> task = [&](int64_t i) {
    fn(rows * i / parts, rows * (i + 1) / parts);
  };
  Pool::instance()->run(parts, threads, task);
}

template <int C>
int resize_area(const float* src, int64_t H, int64_t W, int64_t h, int64_t w,
                int64_t y0, int64_t y1, int64_t x0, int64_t x1,
                const Sink& sink, int threads) {
  const int64_t rows = y1 - y0;
  if (h == H && w == W) {
    over_rows(rows, threads, [&](int64_t r0, int64_t r1) {
      copy_rows<C>(src, W, x0, x1, y0, r0, r1, sink);
    });
    return 0;
  }
  // hal::resize's test for resizeAreaFast_: both scales within DBL_EPSILON
  // of an integer (saturate_cast<int> rounds to nearest)
  const double scale_x = 1.0 / (static_cast<double>(w) / W);
  const double scale_y = 1.0 / (static_cast<double>(h) / H);
  const int64_t isx = std::llrint(scale_x), isy = std::llrint(scale_y);
  if (std::abs(scale_x - isx) < 2.220446049250313e-16 &&
      std::abs(scale_y - isy) < 2.220446049250313e-16) {
    over_rows(rows, threads, [&](int64_t r0, int64_t r1) {
      fast_rows<C>(src, W, w, isx, isy, x0, x1, y0, r0, r1, sink);
    });
    return 2;
  }
  const AreaTab xt = area_tab(W, w), yt = area_tab(H, h);
  over_rows(rows, threads, [&](int64_t r0, int64_t r1) {
    area_rows<C>(src, W, xt, yt, x0, x1, y0, r0, r1, sink);
  });
  return 1;
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

// img: H x W x C floats (C 1 or 3); the output is h x w (h <= H, w <= W),
// of which rows y0..y1 and columns x0..x1 are computed, written row-major
// as (y1 - y0) x (x1 - x0) x C into each of raw (floats), model (floats,
// v * 2 - 1) and display (uint8) that is not null, on up to `threads`
// threads. Returns the path taken: 0 the copy, 1 the table, 2
// resizeAreaFast_; -1 for sizes or a window it does not take.
int resize_area_f32(const float* img, int64_t H, int64_t W, int64_t C,
                    int64_t h, int64_t w, int64_t y0, int64_t y1, int64_t x0,
                    int64_t x1, float* raw, float* model, uint8_t* display,
                    int threads) {
  if (h < 1 || w < 1 || h > H || w > W || y0 < 0 || y1 > h || y0 > y1 ||
      x0 < 0 || x1 > w || x0 > x1 || (C != 1 && C != 3))
    return -1;
  const Sink sink{raw, model, display};
  return C == 1 ? resize_area<1>(img, H, W, h, w, y0, y1, x0, x1, sink,
                                 threads)
                : resize_area<3>(img, H, W, h, w, y0, y1, x0, x1, sink,
                                 threads);
}

}  // extern "C"
