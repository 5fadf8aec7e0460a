// 3x3 stride-1 SAME convolution, NHWC activations and HWIO weights, sm_90a.
//
// Replaces the TPU kernel mast3r_slam_tpu/ops/conv3x3.py::conv3x3
// (_conv3x3_impl / _kernel): the nine shifted (pixels, Cin) @ (Cin, Cout)
// products accumulated in f32, the bias added in f32, one cast to x's type.
//
// Four paths with the same arithmetic: products accumulated in f32, the
// bias (in x's type) added in f32, one cast. ops/conv3x3.py picks one by
// type and shape, never on failure:
//
// float32, Cin and Cout multiples of 8 — the implicit GEMM on the tensor
// cores in 3xTF32 (conv3x3_tf32x3_kernel, below): every DPT shape.
//
// float32, other channel counts — the first design, CUDA cores
// (conv3x3_kernel; path "fma"). One block of 256 threads computes
// an 8x16 tile of output pixels for a 64-wide slice of Cout, walking Cin in
// chunks of 8: each chunk stages the (8+2) x (16+2) x 8 halo tile of x and
// the 3x3x8x64 slice of the weights in shared memory. Thread (ty, tx) owns
// output column ty of the tile for all 8 rows and output channels
// 4tx..4tx+3 (32 f32 accumulators), fed by float4 shared-memory reads and
// plain FMAs.
//
// bfloat16, Cin and Cout multiples of 8 — the implicit GEMM on Hopper
// (conv3x3_igemm_kernel, below): every DPT shape.
//
// bfloat16, other channel counts — the first tensor-core design
// (conv3x3_mma_kernel, mma.sync with synchronous staging).
//
// All zero the halo outside the image while staging it (no padded copy of
// x in device memory, unlike the TPU kernel, which padded once in HBM) and
// mask channels past Cin and outputs past Cout.
//
// Bound on an H100: at the DPT shapes (Cin, Cout >= 128) a conv does
// 18*Cin*Cout flops per output pixel against ~(Cin + Cout) bytes moved,
// so it is bound by operations (except the 12x16 convs, which are small
// enough to be bound by bytes). In float32 the CUDA cores' 67 TFLOP/s
// would be the floor; three TF32 tensor-core products at 495 TFLOP/s are
// 2.5x below it at float32 accuracy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_once.cuh"

#include <algorithm>
#include <cstdint>

namespace {

constexpr int TH = 8;    // output rows per block
constexpr int TW = 16;   // output columns per block
constexpr int CO = 64;   // output channels per block
constexpr int CK = 8;    // input channels per shared-memory chunk
constexpr int THREADS = 256;
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;

__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ y, int H,
               int W, int cin, int cout, int tiles_w) {
  __shared__ __align__(16) float Hs[HALO_H * HALO_W * CK];
  __shared__ __align__(16) float Ws[9 * CK * CO];

  const int tile = blockIdx.x;
  const int oy0 = (tile / tiles_w) * TH;
  const int ox0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * CO;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;   // output channels 4tx..4tx+3
  const int ty = threadIdx.x / 16;   // output column ty of the tile

  const float* xb = x + size_t(b) * H * W * cin;

  float acc[TH][4];
#pragma unroll
  for (int i = 0; i < TH; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    __syncthreads();  // the previous chunk is no longer read
    for (int e = threadIdx.x; e < HALO_H * HALO_W * CK; e += THREADS) {
      const int ci = e % CK;
      const int pix = e / CK;
      const int gy = oy0 - 1 + pix / HALO_W;
      const int gx = ox0 - 1 + pix % HALO_W;
      const int c = c0 + ci;
      float val = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin)
        val = xb[(size_t(gy) * W + gx) * cin + c];
      Hs[e] = val;
    }
    for (int e = threadIdx.x; e < 9 * CK * CO; e += THREADS) {
      const int co = e % CO;
      const int ci = (e / CO) % CK;
      const int kk = e / (CO * CK);
      const int c = c0 + ci;
      float val = 0.f;
      if (c < cin && co0 + co < cout)
        val = w[(size_t(kk) * cin + c) * cout + co0 + co];
      Ws[e] = val;
    }
    __syncthreads();

#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
        for (int ci = 0; ci < CK; ci += 4) {
          const float* wrow = Ws + ((ky * 3 + kx) * CK + ci) * CO + 4 * tx;
          const float4 w0 = *reinterpret_cast<const float4*>(wrow);
          const float4 w1 = *reinterpret_cast<const float4*>(wrow + CO);
          const float4 w2 = *reinterpret_cast<const float4*>(wrow + 2 * CO);
          const float4 w3 = *reinterpret_cast<const float4*>(wrow + 3 * CO);
#pragma unroll
          for (int i = 0; i < TH; ++i) {
            const float4 xv = *reinterpret_cast<const float4*>(
                Hs + ((i + ky) * HALO_W + ty + kx) * CK + ci);
            acc[i][0] = fmaf(xv.x, w0.x, acc[i][0]);
            acc[i][1] = fmaf(xv.x, w0.y, acc[i][1]);
            acc[i][2] = fmaf(xv.x, w0.z, acc[i][2]);
            acc[i][3] = fmaf(xv.x, w0.w, acc[i][3]);
            acc[i][0] = fmaf(xv.y, w1.x, acc[i][0]);
            acc[i][1] = fmaf(xv.y, w1.y, acc[i][1]);
            acc[i][2] = fmaf(xv.y, w1.z, acc[i][2]);
            acc[i][3] = fmaf(xv.y, w1.w, acc[i][3]);
            acc[i][0] = fmaf(xv.z, w2.x, acc[i][0]);
            acc[i][1] = fmaf(xv.z, w2.y, acc[i][1]);
            acc[i][2] = fmaf(xv.z, w2.z, acc[i][2]);
            acc[i][3] = fmaf(xv.z, w2.w, acc[i][3]);
            acc[i][0] = fmaf(xv.w, w3.x, acc[i][0]);
            acc[i][1] = fmaf(xv.w, w3.y, acc[i][1]);
            acc[i][2] = fmaf(xv.w, w3.z, acc[i][2]);
            acc[i][3] = fmaf(xv.w, w3.w, acc[i][3]);
          }
        }
      }
    }
  }

  const int ox = ox0 + ty;
  if (ox >= W) return;
  float bv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + 4 * tx + j;
    bv[j] = (bias != nullptr && co < cout) ? bias[co] : 0.f;
  }
  float* yb = y + size_t(b) * H * W * cout;
#pragma unroll
  for (int i = 0; i < TH; ++i) {
    const int oy = oy0 + i;
    if (oy >= H) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + 4 * tx + j;
      if (co < cout)
        yb[(size_t(oy) * W + ox) * cout + co] = acc[i][j] + bv[j];
    }
  }
}

int launch_f32(const void* x, const void* w, const void* bias, void* y,
               int B, int H, int W, int cin, int cout, cudaStream_t stream) {
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(tiles_h * tiles_w, (cout + CO - 1) / CO, B);
  conv3x3_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), H, W, cin,
      cout, tiles_w);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 path on the tensor cores (mma.sync.m16n8k16, f32 accumulation).
//
// The same implicit GEMM — M = output pixels, N = Cout, K = 9 * Cin — with
// bf16 products accumulated in f32, as the f32 path, only on the tensor
// cores. One block of 4 warps computes an 8x16-pixel tile for 64 output
// channels; warp w owns output rows 2w and 2w+1 (two m16 tiles, one row of
// 16 pixels each) for all 64 channels (eight n8 tiles): 64 f32
// accumulators per thread. Cin is walked in chunks of 16 (one k16 step):
// the (8+2) x (16+2) x 16 halo (zeros outside the image and past Cin) and
// the 3x3x16x64 weights, stored [tap][cout][cin], sit in shared memory
// with a padded channel stride of 24 so that the fragment loads are free of
// bank conflicts. For each of the nine taps a warp loads its two A
// fragments from the shifted halo and eight B fragments, and issues 16
// mma's.
// ---------------------------------------------------------------------------

constexpr int MT_H = 8;      // output rows per block (two per warp)
constexpr int MT_W = 16;     // output columns per block (one m16 tile)
constexpr int MN = 64;       // output channels per block
constexpr int MK = 16;       // input channels per chunk
constexpr int KP = 24;       // padded channel stride in shared memory
constexpr int MTHREADS = 128;
constexpr int MHALO_W = MT_W + 2;
constexpr int MHALO = (MT_H + 2) * MHALO_W;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(MTHREADS)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ bias,
                   __nv_bfloat16* __restrict__ y, int H, int W, int cin,
                   int cout, int tiles_w) {
  __shared__ __align__(16) __nv_bfloat16 Hs[MHALO * KP];
  __shared__ __align__(16) __nv_bfloat16 Ws[9 * MN * KP];

  const int tile = blockIdx.x;
  const int oy0 = (tile / tiles_w) * MT_H;
  const int ox0 = (tile % tiles_w) * MT_W;
  const int co0 = blockIdx.y * MN;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread in group
  const bool vec_x = (cin % 8) == 0;
  const bool vec_w = (cout % 8) == 0;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  const __nv_bfloat16* xb = x + size_t(b) * H * W * cin;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][nt][j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += MK) {
    __syncthreads();  // the previous chunk is no longer read
    // halo: 16 channels of each pixel, two 8-channel vectors when aligned
    for (int e = threadIdx.x; e < MHALO * 2; e += MTHREADS) {
      const int pix = e >> 1;
      const int half = (e & 1) * 8;
      const int gy = oy0 - 1 + pix / MHALO_W;
      const int gx = ox0 - 1 + pix % MHALO_W;
      const int c = c0 + half;
      __nv_bfloat16* dst = Hs + pix * KP + half;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const __nv_bfloat16* src = xb + (size_t(gy) * W + gx) * cin + c;
      if (inside && vec_x && c + 8 <= cin) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = (inside && c + j < cin) ? src[j] : zero;
      }
    }
    // weights: w[tap][c][co0 .. co0+63] → Ws[tap][co][c], 8 channels of
    // Cout per thread step
    for (int e = threadIdx.x; e < 9 * MK * (MN / 8); e += MTHREADS) {
      const int cv = (e % (MN / 8)) * 8;
      const int ci = (e / (MN / 8)) % MK;
      const int kk = e / ((MN / 8) * MK);
      const int c = c0 + ci;
      const int co = co0 + cv;
      __nv_bfloat16 v8[8];
      const __nv_bfloat16* src = w + (size_t(kk) * cin + c) * cout + co;
      if (c < cin && vec_w && co + 8 <= cout) {
        *reinterpret_cast<uint4*>(v8) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v8[j] = (c < cin && co + j < cout) ? src[j] : zero;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) Ws[(kk * MN + cv + j) * KP + ci] = v8[j];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < 9; ++kk) {
      const int ky = kk / 3, kx = kk % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = 2 * warp + mi + ky;
        const __nv_bfloat16* h0 = Hs + (row * MHALO_W + g + kx) * KP + 2 * tg;
        const __nv_bfloat16* h8 = h0 + 8 * KP;   // pixel g + 8
        a[mi][0] = lds32(h0);
        a[mi][1] = lds32(h8);
        a[mi][2] = lds32(h0 + 8);
        a[mi][3] = lds32(h8 + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* wp = Ws + (kk * MN + nt * 8 + g) * KP + 2 * tg;
        const uint32_t b0 = lds32(wp);
        const uint32_t b1 = lds32(wp + 8);
        mma_bf16(acc[0][nt], a[0], b0, b1);
        mma_bf16(acc[1][nt], a[1], b0, b1);
      }
    }
  }

  __nv_bfloat16* yb = y + size_t(b) * H * W * cout;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int oy = oy0 + 2 * warp + mi;
    if (oy >= H) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int co = co0 + nt * 8 + 2 * tg;
      const float b0 = (bias != nullptr && co < cout)
                           ? __bfloat162float(bias[co]) : 0.f;
      const float b1 = (bias != nullptr && co + 1 < cout)
                           ? __bfloat162float(bias[co + 1]) : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = ox0 + g + 8 * half;
        if (ox >= W) continue;
        __nv_bfloat16* dst = yb + (size_t(oy) * W + ox) * cout + co;
        const float v0 = acc[mi][nt][2 * half] + b0;
        const float v1 = acc[mi][nt][2 * half + 1] + b1;
        if (co + 1 < cout && (cout % 2) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < cout) dst[0] = __float2bfloat16(v0);
          if (co + 1 < cout) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

int launch_mma(const void* x, const void* w, const void* bias, void* y,
               int B, int H, int W, int cin, int cout, cudaStream_t stream) {
  const int tiles_h = (H + MT_H - 1) / MT_H;
  const int tiles_w = (W + MT_W - 1) / MT_W;
  const dim3 grid(tiles_h * tiles_w, (cout + MN - 1) / MN, B);
  conv3x3_mma_kernel<<<grid, MTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), H, W, cin, cout, tiles_w);
  return int(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16 implicit GEMM for Hopper (cp.async ring, ldmatrix gather, wgmma).
//
// M = the batch's output pixels, N = Cout, K = 9 * Cin, walked chunk-major:
// K step it = 9 * chunk + tap covers 64 input channels (one chunk) of one
// tap. One block is one warpgroup (4 warps) and computes an 8 x 16-pixel x
// 128-channel output tile as two m64n128 wgmma tiles (tile rows 0-3 and
// 4-7); warp w owns tile rows w and 4 + w (128 f32 accumulators a thread).
//
// A (activations), in registers: per channel chunk the block stages the
// (8+2) x (16+2) halo of its tile once and reads all nine taps from it:
// ldmatrix takes one row address a lane, so the A fragment of tap (ky, kx)
// gathers halo rows (y + ky) * 18 + x + kx. Pixels outside the image and
// channels past Cin are zero-filled by cp.async (src-size 0): SAME padding
// without a padded copy. Each activation is read ~1.4 times from L2 (the
// halo's overlap), not nine times as an im2col tile per tap would. Two halo
// buffers: the next chunk's halo lands while the last taps of this one run.
// A wgmma shared-memory descriptor cannot express this per-lane gather,
// which is why A comes from registers.
// B (weights), in shared memory: read as they lie, w[tap][c0..c0+63]
// [n0..n0+127] (K x N with N contiguous, MN-major), through a ring of 3
// cp.async stages, one per K step, stored in the 128-byte-swizzle MN-major
// layout (each K row's 64-channel half one 128-byte row, its 16-byte chunks
// XOR-permuted by the row within 8) that the wgmma descriptor reads with
// trans-b = 1: no transpose in memory, and the tensor cores' reads and the
// cp.async writes both hit distinct banks. Halo rows are padded by 16 bytes
// (144-byte rows) so ldmatrix's eight row addresses hit eight bank groups.
// One barrier and one wgmma group a K step (measured: keeping a group in
// flight across steps gained < 1%); the loads of step i+2 overlap step i.
// Against the same loop on mma.sync (ldmatrix.trans for B, 4 warps of
// 64 x 64), this runs 13% faster per frame (PERF.md).
//
// Split K: when the output tiles alone give fewer blocks than the card has
// SMs (the 12x16 to 48x64 convs; ops/conv3x3.py::plan), blockIdx.y cuts the
// K steps into `splits` contiguous ranges, steps [s*kiters/splits,
// (s+1)*kiters/splits). Each block writes its f32 partial tile to a
// workspace (splits, M, Cout); conv3x3_split_sum_kernel then adds the
// partials in split order, adds the bias and casts once: two launches give
// the same bits, and no float atomics are used. With one split the
// epilogue adds the bias and casts directly.
// ---------------------------------------------------------------------------

constexpr int IG_TH = 8;                   // output rows of a tile
constexpr int IG_TW = 16;                  // output columns of a tile
constexpr int IG_BN = 128;                 // output channels of a tile
constexpr int IG_BK = 64;                  // input channels a K step
constexpr int IG_STAGES = 3;               // weight ring depth
constexpr int IG_THREADS = 128;            // one warpgroup
constexpr int IG_HW = IG_TW + 2;           // halo row length (pixels)
constexpr int IG_HROWS = (IG_TH + 2) * IG_HW;
constexpr int IG_HS = IG_BK + 8;           // halo pixel stride (bf16)
constexpr int IG_HALO = IG_HROWS * IG_HS;
constexpr int IG_B_STAGE = IG_BK * IG_BN;  // dense, swizzled
constexpr size_t IG_SMEM =
    size_t(IG_STAGES * IG_B_STAGE + 2 * IG_HALO) * sizeof(__nv_bfloat16);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += A (64 x 16, registers: this warp's 16 rows as an m16k16 fragment) x
// B (16 x 128, shared memory via `desc`, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Descriptor of a 16 x 128 B slice: 128-byte swizzle, 1024 bytes between
// the two 64-channel atoms (LBO), 2048 between 8-row groups (SBO).
__device__ __forceinline__ uint64_t b_desc(const __nv_bfloat16* p) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  uint64_t desc = (addr & 0x3FFFF) >> 4;       // start address
  desc |= uint64_t(1024 >> 4) << 16;           // LBO: next 64 channels
  desc |= uint64_t(2048 >> 4) << 32;           // SBO: next 8 K rows
  desc |= uint64_t(1) << 62;                   // 128-byte swizzle
  return desc;
}

__global__ void __launch_bounds__(IG_THREADS, 2)
conv3x3_igemm_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                     int H, int W, int cin, int cout, int m_total,
                     int tiles_h, int tiles_w, int kiters, int splits) {
  // the weight ring first: the swizzle atoms need 1024-byte alignment
  extern __shared__ __align__(1024) unsigned char ig_smem[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(ig_smem);
  __nv_bfloat16* Hs = Bs + IG_STAGES * IG_B_STAGE;

  const int tiles_m = m_total / (H * W) * tiles_h * tiles_w;
  const int mt = blockIdx.x % tiles_m;
  const int n0 = (blockIdx.x / tiles_m) * IG_BN;
  const int img = mt / (tiles_h * tiles_w);
  const int oy0 = (mt / tiles_w) % tiles_h * IG_TH;
  const int ox0 = mt % tiles_w * IG_TW;
  const int split = blockIdx.y;
  const int k_lo = int((long long)split * kiters / splits);
  const int k_hi = int((long long)(split + 1) * kiters / splits);
  const int nk = k_hi - k_lo;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const __nv_bfloat16* xb = x + size_t(img) * H * W * cin;

  // the weights: thread t copies channel chunk t%16 of K rows t/16 + 8i;
  // a K row's 64-channel half is one 128-byte swizzle row
  const int b_chunk = tid & 15, b_row = tid >> 4;
  const bool b_col_ok = n0 + b_chunk * 8 < cout;

  // K step it: chunk it / 9 (channels c0..c0+63) of tap it % 9; the halo
  // of its chunk comes with a split's first step and with every tap 0
  auto load_step = [&](int slot, int it, bool first) {
    const int chunk = it / 9, tap = it - 9 * (it / 9);
    const int c0 = chunk * IG_BK;
    if (first || tap == 0) {
      __nv_bfloat16* hs = Hs + (chunk & 1) * IG_HALO;
      for (int e = tid; e < IG_HROWS * (IG_BK / 8); e += IG_THREADS) {
        const int hr = e / (IG_BK / 8), cv = e % (IG_BK / 8) * 8;
        const int c = c0 + cv;
        const int gy = oy0 - 1 + hr / IG_HW, gx = ox0 - 1 + hr % IG_HW;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin;
        const __nv_bfloat16* src =
            ok ? xb + (size_t(gy) * W + gx) * cin + c : x;
        cp_async16(hs + hr * IG_HS + cv, src, ok ? 16 : 0);
      }
    }
    __nv_bfloat16* bs = Bs + slot * IG_B_STAGE;
#pragma unroll
    for (int i = 0; i < IG_BK / 8; ++i) {
      const int c = c0 + 8 * i + b_row;
      const bool ok = b_col_ok && c < cin;
      const __nv_bfloat16* src =
          ok ? w + (size_t(tap) * cin + c) * cout + n0 + b_chunk * 8 : w;
      // 8-row group i, 64-channel atom b_chunk / 8, row b_row, 16-byte
      // chunk (b_chunk % 8) ^ b_row within the row
      cp_async16(bs + i * 1024 + (b_chunk >> 3) * 512 + b_row * 64 +
                     (((b_chunk & 7) ^ b_row) << 3),
                 src, ok ? 16 : 0);
    }
  };

  float acc[2][64];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[t][j] = 0.f;
  // ldmatrix row of this lane: pixel (w, lane & 15) under tap (0, 0); the
  // second m64 tile is 4 tile rows further
  const int a_lane = (warp * IG_HW + (lane & 15)) * IG_HS + (lane >> 4) * 8;

#pragma unroll
  for (int s = 0; s < IG_STAGES - 1; ++s) {
    if (s < nk) load_step(s, k_lo + s, s == 0);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<IG_STAGES - 2>();   // step i has landed
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                  // ... for every thread; slot i-1 free
    const int nxt = i + IG_STAGES - 1;
    if (nxt < nk) load_step(nxt % IG_STAGES, k_lo + nxt, false);
    cp_async_commit();

    const int it = k_lo + i;
    const int chunk = it / 9, tap = it - 9 * (it / 9);
    const int ky = tap / 3, kx = tap - 3 * (tap / 3);
    const int ksteps = min(IG_BK, cin - chunk * IG_BK + 15) / 16;
    const __nv_bfloat16* hs =
        Hs + (chunk & 1) * IG_HALO + a_lane + (ky * IG_HW + kx) * IG_HS;
    const __nv_bfloat16* bs = Bs + (i % IG_STAGES) * IG_B_STAGE;
    uint32_t a[IG_BK / 16][2][4];
#pragma unroll
    for (int ks = 0; ks < IG_BK / 16; ++ks)
#pragma unroll
      for (int t = 0; t < 2; ++t)
        ldmatrix_x4(a[ks][t], hs + t * 4 * IG_HW * IG_HS + ks * 16);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < IG_BK / 16; ++ks) {
      if (ks >= ksteps) break;   // past Cin (a partial last chunk)
      const uint64_t desc = b_desc(bs + ks * 2 * 1024);
#pragma unroll
      for (int t = 0; t < 2; ++t) wgmma_m64n128k16(acc[t], a[ks][t], desc);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  cp_async_wait<0>();

  // accumulator j of n8 chunk ni: row g + 8 (j / 2), column 8 ni + 2 tg +
  // j % 2 of the warp's 16 rows
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 16; ++ni) {
    const int co = n0 + ni * 8 + 2 * tg;
    if (co >= cout) continue;   // cout % 8 == 0: co + 1 < cout as well
    float b0 = 0.f, b1 = 0.f;
    if (splits == 1 && bias != nullptr) {
      b0 = __bfloat162float(bias[co]);
      b1 = __bfloat162float(bias[co + 1]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int oy = oy0 + 4 * t + warp;
      if (oy >= H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = ox0 + g + 8 * half;
        if (ox >= W) continue;
        const size_t p = (size_t(img) * H + oy) * W + ox;
        const float v0 = acc[t][4 * ni + 2 * half];
        const float v1 = acc[t][4 * ni + 2 * half + 1];
        if (splits == 1) {
          *reinterpret_cast<__nv_bfloat162*>(y + p * cout + co) =
              __floats2bfloat162_rn(v0 + b0, v1 + b1);
        } else {
          *reinterpret_cast<float2*>(
              ws + (size_t(split) * m_total + p) * cout + co) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ void store4(__nv_bfloat16* y, size_t i, float4 s) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
  uint2 out;
  out.x = *reinterpret_cast<uint32_t*>(&lo);
  out.y = *reinterpret_cast<uint32_t*>(&hi);
  reinterpret_cast<uint2*>(y)[i] = out;
}

__device__ __forceinline__ void store4(float* y, size_t i, float4 s) {
  reinterpret_cast<float4*>(y)[i] = s;
}

// y = T(sum over splits, in split order, of ws[s] + bias): four outputs a
// thread step (cout % 8 == 0, so a float4 never straddles a pixel). T is
// bf16 (the implicit GEMM) or float (3xTF32).
template <typename T>
__global__ void conv3x3_split_sum_kernel(const float* __restrict__ ws,
                                         const T* __restrict__ bias,
                                         T* __restrict__ y, int splits,
                                         size_t n4, int cout) {
  const size_t plane = n4 * 4;
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += size_t(gridDim.x) * blockDim.x) {
    float4 s = reinterpret_cast<const float4*>(ws)[i];
    for (int k = 1; k < splits; ++k) {
      const float4 t = reinterpret_cast<const float4*>(ws + k * plane)[i];
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    if (bias != nullptr) {
      const int co = int((i * 4) % size_t(cout));
      s.x += to_float(bias[co]);
      s.y += to_float(bias[co + 1]);
      s.z += to_float(bias[co + 2]);
      s.w += to_float(bias[co + 3]);
    }
    store4(y, i, s);
  }
}

int launch_igemm(const void* x, const void* w, const void* bias, void* y,
                 void* ws, int B, int H, int W, int cin, int cout,
                 int splits, cudaStream_t stream) {
  static PerDeviceOnce once;
  const cudaError_t setup = once.run([] {
    return cudaFuncSetAttribute(conv3x3_igemm_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(IG_SMEM));
  });
  if (setup != cudaSuccess) return int(setup);
  if (cin % 8 != 0 || cout % 8 != 0) return int(cudaErrorInvalidValue);
  const long long m_total = (long long)B * H * W;
  const int tiles_h = (H + IG_TH - 1) / IG_TH;
  const int tiles_w = (W + IG_TW - 1) / IG_TW;
  const long long tiles_m = (long long)B * tiles_h * tiles_w;
  const int tiles_n = (cout + IG_BN - 1) / IG_BN;
  const int kiters = 9 * ((cin + IG_BK - 1) / IG_BK);
  if (m_total > (1LL << 30) || tiles_m * tiles_n > (1LL << 30) ||
      splits < 1 || splits > kiters || splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned(tiles_m * tiles_n), splits);
  conv3x3_igemm_kernel<<<grid, IG_THREADS, IG_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(ws), H, W, cin,
      cout, int(m_total), tiles_h, tiles_w, kiters, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return int(e);
  const size_t n4 = size_t(m_total) * cout / 4;
  const int blocks = int(std::min<size_t>((n4 + 255) / 256, 132 * 16));
  conv3x3_split_sum_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), splits, n4, cout);
  return int(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// float32 implicit GEMM for Hopper: 3xTF32 on wgmma (path "tf32x3").
//
// The implicit GEMM above with float32 operands, accurate to float32 on the
// tensor cores: each operand a is split into hi = cvt.rna.tf32(a) and lo =
// the same rounding of a - hi (exact; two integer operations, the rounding
// cvt.rna gives a finite value), a = hi + lo to about 2^-22 |a|,
// and each product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b, three
// wgmma m64n64k8 .tf32 products (each exact in f32; lo lo, ~2^-22 |a b|,
// is dropped). The three passes run at 3 x 1/495 TFLOP/s, 2.5x under the
// CUDA cores' float32 floor (1/67).
// - Tile: 8 x 16 output pixels x 64 output channels, two warpgroups, one
//   m64n64 tile each (tile rows 0-3 and 4-7; warp w of warpgroup v owns
//   row 4 v + w), sharing the block's weight ring and halo. K step it = 9 *
//   chunk + tap: TF_BK (32) input channels of one tap, four k8 steps, 12
//   wgmma a warpgroup a step (two commit groups of 6). Two blocks an SM:
//   four warpgroups, so that one's fragment loads and sums overlap
//   another's products.
// - Two-level sums: each half K step's 6 products of a tile start from
//   zero (scale-d 0) and are then added to the running f32 total in
//   registers. The tensor cores' own accumulation rounds differently from
//   an FMA chain; a partial keeps that to 6 additions, and the 18 x Cin /
//   32 partials are summed in f32 as the FMA path sums its products.
// - B (weights), shared memory: TF32 wgmma reads only K-major operands (no
//   transposed B), so a pre-pass (conv3x3_tf32_split_kernel, part of each
//   launch) writes the weights' hi and lo parts as (tap, Cout, Cin). A
//   ring of TF_STAGES cp.async stages, one per K step, each the step's 64
//   x 32 hi and lo parts in the 128-byte-swizzle K-major layout (a Cout
//   row's 32 channels one 128-byte row, its 16-byte chunks XOR-permuted by
//   the row within 8); the descriptor advances 32 bytes a k8 step.
// - A (activations), registers: the (8+2) x (16+2) halo of a channel chunk
//   lands once (cp.async, zero fill outside the image: SAME padding) and
//   serves the nine taps; rows of 32 floats with each 4-channel chunk
//   XOR-permuted by the pixel index within 8, so that a fragment load's 8
//   pixels x 4 channels hit 32 banks. Each lane loads its m16k8 fragment
//   values (pixel g / g + 8, channel tg / tg + 4) and splits them. Two halo
//   buffers, as the bf16 path.
// - Split K as the bf16 path (ops/conv3x3.py::plan with this tile): an
//   ordered f32 sum of per-split partials, the bias added and one store.
// ---------------------------------------------------------------------------

constexpr int TF_BN = 64;                      // output channels of a tile
constexpr int TF_BK = 32;                      // input channels a K step
constexpr int TF_STAGES = 3;                   // weight ring depth
constexpr int TF_THREADS = 256;                // two warpgroups
constexpr int TF_HALO = IG_HROWS * TF_BK;      // floats, swizzled
constexpr int TF_B_PART = TF_BN * TF_BK;       // floats of hi or lo
constexpr int TF_B_STAGE = 2 * TF_B_PART;
constexpr size_t TF_SMEM =
    size_t(TF_STAGES * TF_B_STAGE + 2 * TF_HALO) * sizeof(float);

__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

// cvt.rna.tf32.f32 of a finite x in two integer operations: half a TF32
// ulp added to the magnitude bits, the 13 dropped bits cleared (no NaN
// test: the caller rounds only finite values this way).
__device__ __forceinline__ uint32_t tf32_rna_finite(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi and lo TF32 parts of a: hi = rna(a) (cvt: a NaN stays a NaN), lo =
// rna(a - hi), where a - hi is exact and finite for a finite a (for an
// infinite or NaN a, hi carries it into every product)
__device__ __forceinline__ void tf32_split(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna_finite(a - __uint_as_float(hi));
}

// wsplit[p][tap][co][ci]: TF32 part p (0 hi, 1 lo) of w[tap][ci][co],
// through a 32 x 32 shared-memory transpose (block 32 x 8).
__global__ void conv3x3_tf32_split_kernel(const float* __restrict__ w,
                                          float* __restrict__ wsplit,
                                          int cin, int cout) {
  __shared__ float t[32][33];
  const int tap = blockIdx.z;
  const int ci0 = blockIdx.y * 32, co0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int ci = ci0 + i, co = co0 + tx;
    t[i][tx] = (ci < cin && co < cout)
                   ? w[(size_t(tap) * cin + ci) * cout + co] : 0.f;
  }
  __syncthreads();
  const size_t plane = size_t(9) * cin * cout;
  for (int i = ty; i < 32; i += 8) {
    const int co = co0 + i, ci = ci0 + tx;
    if (co < cout && ci < cin) {
      uint32_t hi, lo;
      tf32_split(t[tx][i], hi, lo);
      const size_t o = (size_t(tap) * cout + co) * cin + ci;
      wsplit[o] = __uint_as_float(hi);
      wsplit[plane + o] = __uint_as_float(lo);
    }
  }
}

// y[i] = the TF32 rounding of x[i] (cvt.rna), as float32 bits: test
// support for the plain version's rounding.
__global__ void tf32_round_kernel(const float* __restrict__ x,
                                  float* __restrict__ y, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    y[i] = __uint_as_float(tf32_rna(x[i]));
}

// d (+)= A (64 x 8 tf32, registers: this warp's 16 rows as an m16k8
// fragment) x B (8 x 64 tf32, shared memory via `desc`, K-major); d is
// overwritten when scale_d is 0.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Descriptor of an 8 x 64 K-major B slice: 128-byte swizzle, 1024 bytes
// between 8-row groups (SBO); the leading offset is unused in this layout.
__device__ __forceinline__ uint64_t tf_desc(const float* p) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  uint64_t desc = (addr & 0x3FFFF) >> 4;       // start address
  desc |= uint64_t(1) << 16;                   // LBO (unused)
  desc |= uint64_t(1024 >> 4) << 32;           // SBO: next 8 Cout rows
  desc |= uint64_t(1) << 62;                   // 128-byte swizzle
  return desc;
}

__global__ void __launch_bounds__(TF_THREADS, 2)
conv3x3_tf32x3_kernel(const float* __restrict__ x,
                      const float* __restrict__ wsplit,
                      const float* __restrict__ bias, float* __restrict__ y,
                      float* __restrict__ ws, int H, int W, int cin,
                      int cout, int m_total, int tiles_h, int tiles_w,
                      int kiters, int splits) {
  // the weight ring first: the swizzle atoms need 1024-byte alignment
  extern __shared__ __align__(1024) unsigned char tf_smem[];
  float* Bs = reinterpret_cast<float*>(tf_smem);
  float* Hs = Bs + TF_STAGES * TF_B_STAGE;

  const int tiles_m = m_total / (H * W) * tiles_h * tiles_w;
  const int mt = blockIdx.x % tiles_m;
  const int n0 = (blockIdx.x / tiles_m) * TF_BN;
  const int img = mt / (tiles_h * tiles_w);
  const int oy0 = (mt / tiles_w) % tiles_h * IG_TH;
  const int ox0 = mt % tiles_w * IG_TW;
  const int split = blockIdx.y;
  const int k_lo = int((long long)split * kiters / splits);
  const int k_hi = int((long long)(split + 1) * kiters / splits);
  const int nk = k_hi - k_lo;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int row = tid / 32;   // the warp's tile row: 4 (warpgroup) + warp
  const int g = lane >> 2, tg = lane & 3;
  const float* xb = x + size_t(img) * H * W * cin;
  const size_t plane = size_t(9) * cin * cout;

  // the weights: thread t copies 16-byte chunk t%8 of Cout rows t/8 + 32i
  // of both parts
  const int b_chunk = tid & 7, b_row = tid >> 3;

  auto load_step = [&](int slot, int it, bool first) {
    const int chunk = it / 9, tap = it - 9 * (it / 9);
    const int c0 = chunk * TF_BK;
    if (first || tap == 0) {
      float* hs = Hs + (chunk & 1) * TF_HALO;
      for (int e = tid; e < IG_HROWS * (TF_BK / 4); e += TF_THREADS) {
        const int hr = e >> 3, q = e & 7;
        const int c = c0 + 4 * q;
        const int gy = oy0 - 1 + hr / IG_HW, gx = ox0 - 1 + hr % IG_HW;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin;
        const float* src = ok ? xb + (size_t(gy) * W + gx) * cin + c : x;
        cp_async16(hs + hr * TF_BK + ((q ^ (hr & 7)) << 2), src, ok ? 16 : 0);
      }
    }
    float* bs = Bs + slot * TF_B_STAGE;
    const int c = c0 + 4 * b_chunk;
#pragma unroll
    for (int i = 0; i < TF_BN / 32; ++i) {
      const int n = b_row + 32 * i;
      const bool ok = n0 + n < cout && c < cin;
      const size_t off = (size_t(tap) * cout + n0 + n) * cin + c;
#pragma unroll
      for (int p = 0; p < 2; ++p)
        cp_async16(bs + p * TF_B_PART + n * TF_BK + ((b_chunk ^ (n & 7)) << 2),
                   ok ? wsplit + p * plane + off : wsplit, ok ? 16 : 0);
    }
  };

  float acc[32], tot[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = tot[j] = 0.f;

#pragma unroll
  for (int s = 0; s < TF_STAGES - 1; ++s) {
    if (s < nk) load_step(s, k_lo + s, s == 0);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<TF_STAGES - 2>();   // step i has landed
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                  // ... for every thread; slot i-1 free
    const int nxt = i + TF_STAGES - 1;
    if (nxt < nk) load_step(nxt % TF_STAGES, k_lo + nxt, false);
    cp_async_commit();

    const int it = k_lo + i;
    const int chunk = it / 9, tap = it - 9 * (it / 9);
    const int ky = tap / 3, kx = tap - 3 * (tap / 3);
    const float* hs = Hs + (chunk & 1) * TF_HALO;
    const float* bs = Bs + (i % TF_STAGES) * TF_B_STAGE;
    // A fragment: pixel g (+ 8) of the warp's tile row, shifted by the tap,
    // channels 8 ks + tg (+ 4); hi and lo parts. Channels past Cin (a
    // partial last chunk) are zeros in the halo and the weights.
    uint32_t ah[TF_BK / 8][4], al[TF_BK / 8][4];
    {
      const int hp = (row + ky) * IG_HW + g + kx;   // pixel + 8: same swz
      const float* h0 = hs + hp * TF_BK + tg;
      const float* h8 = h0 + 8 * TF_BK;
      const int swz = hp & 7;
#pragma unroll
      for (int ks = 0; ks < TF_BK / 8; ++ks) {
        const int q0 = ((2 * ks) ^ swz) << 2, q1 = ((2 * ks + 1) ^ swz) << 2;
        tf32_split(h0[q0], ah[ks][0], al[ks][0]);
        tf32_split(h8[q0], ah[ks][1], al[ks][1]);
        tf32_split(h0[q1], ah[ks][2], al[ks][2]);
        tf32_split(h8[q1], ah[ks][3], al[ks][3]);
      }
    }
    // two halves of the step (16 channels, 6 wgmma each), each from zero
    // and added to the f32 total apart
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 2 * h; ks < 2 * h + 2; ++ks) {
        const uint64_t dh = tf_desc(bs + ks * 8);
        const uint64_t dl = tf_desc(bs + TF_B_PART + ks * 8);
        wgmma_m64n64k8_tf32(acc, al[ks], dh, ks > 2 * h);
        wgmma_m64n64k8_tf32(acc, ah[ks], dl, 1);
        wgmma_m64n64k8_tf32(acc, ah[ks], dh, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < 32; ++j) tot[j] += acc[j];
    }
  }
  cp_async_wait<0>();

  // accumulator j of n8 chunk ni: row g + 8 (j / 2), column 8 ni + 2 tg +
  // j % 2 of the warp's 16 rows
#pragma unroll
  for (int ni = 0; ni < TF_BN / 8; ++ni) {
    const int co = n0 + ni * 8 + 2 * tg;
    if (co >= cout) continue;   // cout % 8 == 0: co + 1 < cout as well
    float b0 = 0.f, b1 = 0.f;
    if (splits == 1 && bias != nullptr) {
      b0 = bias[co];
      b1 = bias[co + 1];
    }
    const int oy = oy0 + row;
    if (oy >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = ox0 + g + 8 * half;
      if (ox >= W) continue;
      const size_t p = (size_t(img) * H + oy) * W + ox;
      const float v0 = tot[4 * ni + 2 * half];
      const float v1 = tot[4 * ni + 2 * half + 1];
      if (splits == 1)
        *reinterpret_cast<float2*>(y + p * cout + co) =
            make_float2(v0 + b0, v1 + b1);
      else
        *reinterpret_cast<float2*>(
            ws + (size_t(split) * m_total + p) * cout + co) =
            make_float2(v0, v1);
    }
  }
}

int launch_tf32_split(const void* w, void* wsplit, int cin, int cout,
                      cudaStream_t stream) {
  const dim3 grid((cout + 31) / 32, (cin + 31) / 32, 9);
  conv3x3_tf32_split_kernel<<<grid, dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(w), static_cast<float*>(wsplit), cin, cout);
  return int(cudaGetLastError());
}

int launch_tf32x3(const void* x, const void* w, const void* bias, void* y,
                  void* wsplit, void* ws, int B, int H, int W, int cin,
                  int cout, int splits, cudaStream_t stream) {
  static PerDeviceOnce once;
  const cudaError_t setup = once.run([] {
    return cudaFuncSetAttribute(conv3x3_tf32x3_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(TF_SMEM));
  });
  if (setup != cudaSuccess) return int(setup);
  if (cin % 8 != 0 || cout % 8 != 0 || wsplit == nullptr)
    return int(cudaErrorInvalidValue);
  const long long m_total = (long long)B * H * W;
  const int tiles_h = (H + IG_TH - 1) / IG_TH;
  const int tiles_w = (W + IG_TW - 1) / IG_TW;
  const long long tiles_m = (long long)B * tiles_h * tiles_w;
  const int tiles_n = (cout + TF_BN - 1) / TF_BN;
  const int kiters = 9 * ((cin + TF_BK - 1) / TF_BK);
  if (m_total > (1LL << 30) || tiles_m * tiles_n > (1LL << 30) ||
      splits < 1 || splits > kiters || splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return int(cudaErrorInvalidValue);
  int err = launch_tf32_split(w, wsplit, cin, cout, stream);
  if (err != 0) return err;
  const dim3 grid(unsigned(tiles_m * tiles_n), splits);
  conv3x3_tf32x3_kernel<<<grid, TF_THREADS, TF_SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wsplit),
      static_cast<const float*>(bias), static_cast<float*>(y),
      static_cast<float*>(ws), H, W, cin, cout, int(m_total), tiles_h,
      tiles_w, kiters, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return int(e);
  const size_t n4 = size_t(m_total) * cout / 4;
  const int blocks = int(std::min<size_t>((n4 + 255) / 256, 132 * 16));
  conv3x3_split_sum_kernel<float><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<float*>(y), splits, n4, cout);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x (B, H, W, cin), w (3, 3, cin, cout),
// bias (cout,) or null, y (B, H, W, cout); all contiguous, 16-byte aligned
// and of one dtype. Returns a cudaError_t (0 on success).
extern "C" int conv3x3_nhwc(int dtype, const void* x, const void* w,
                            const void* bias, void* y, int B, int H, int W,
                            int cin, int cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0 || B > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(x, w, bias, y, B, H, W, cin, cout, s);
  if (dtype == 1) return launch_mma(x, w, bias, y, B, H, W, cin, cout, s);
  return int(cudaErrorInvalidValue);
}

// The implicit GEMM (bf16). x (B, H, W, cin), w (3, 3, cin, cout), bias
// (cout,) or null, y (B, H, W, cout): contiguous, 16-byte aligned bf16 with
// cin and cout multiples of 8. ws: f32 (splits, B*H*W, cout) when splits >
// 1, else unused. Returns a cudaError_t (0 on success).
extern "C" int conv3x3_igemm(const void* x, const void* w, const void* bias,
                             void* y, void* ws, int B, int H, int W, int cin,
                             int cout, int splits, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0)
    return int(cudaErrorInvalidValue);
  return launch_igemm(x, w, bias, y, ws, B, H, W, cin, cout, splits,
                      static_cast<cudaStream_t>(stream));
}

// The 3xTF32 implicit GEMM (float32). x (B, H, W, cin), w (3, 3, cin,
// cout), bias (cout,) or null, y (B, H, W, cout): contiguous, 16-byte
// aligned float32 with cin and cout multiples of 8. wsplit: float32 (2, 9,
// cout, cin) scratch (the weights' TF32 parts, written here); ws: f32
// (splits, B*H*W, cout) when splits > 1, else unused. Returns a
// cudaError_t (0 on success).
extern "C" int conv3x3_tf32x3(const void* x, const void* w, const void* bias,
                              void* y, void* wsplit, void* ws, int B, int H,
                              int W, int cin, int cout, int splits,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0)
    return int(cudaErrorInvalidValue);
  return launch_tf32x3(x, w, bias, y, wsplit, ws, B, H, W, cin, cout, splits,
                       static_cast<cudaStream_t>(stream));
}

// The 3xTF32 path's weight pre-pass alone (timing): wsplit (2, 9, cout,
// cin) from w (3, 3, cin, cout), float32.
extern "C" int conv3x3_tf32_split(const void* w, void* wsplit, int cin,
                                  int cout, void* stream) {
  if (cin <= 0 || cout <= 0) return int(cudaErrorInvalidValue);
  return launch_tf32_split(w, wsplit, cin, cout,
                           static_cast<cudaStream_t>(stream));
}

// Test support: y[i] = cvt.rna.tf32.f32(x[i]) for n float32 values.
extern "C" int conv3x3_tf32_round(const void* x, void* y, int n,
                                  void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const int blocks = std::min((n + 255) / 256, 1024);
  tf32_round_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return int(cudaGetLastError());
}

extern "C" const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
