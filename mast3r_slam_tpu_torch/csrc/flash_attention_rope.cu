// Flash attention, with or without 2D RoPE, for sm_90a.
//
// Replaces two TPU kernels of mast3r_slam_tpu/ops/flash_attention.py:
// flash_attention_rope (K1: body _flash_rope_kernel, rotation _rope_rotate)
// and flash_attention (K3: body _flash_kernel). One source serves both: the
// template flag ROPE switches the rotation off at compile time. With RoPE it
// computes exactly what the K1 TPU kernel computes: q and k arrive
// un-rotated; each row is rotated in f32 against (B, N, D) cos/sin tables
// laid out as quarters [y, y, x, x] with rotate-half pairing inside each D/2
// half (rot = [-t2, t1, -t4, t3]); q is then scaled by sm_scale; the softmax
// runs online over K/V tiles in f32; the output is o / max(l, 1e-30) in q's
// type. Without RoPE the q rows are only scaled by sm_scale.
//
// Three bodies:
//
// float32 — CUDA cores (flash_rope_kernel; entries flash_attention_rope /
// flash_attention with dtype 0). One block of 256 threads owns one
// (batch*head, 64-row q tile). The rotated, scaled q tile lives in shared
// memory for the whole kernel; 64-row K/V tiles stream through shared
// memory (K rotated on load). Each thread owns a 4x4 patch of the 64x64
// score tile and the same 4x4 patch of the 64x64 output accumulator (rows
// ty + 16i, columns tx + 16j), so the row max / row sum of the online
// softmax reduce over the 16 lanes of a half-warp with shuffles. After the
// scores are read, the K tile's shared buffer is reused for the
// probabilities P, which feed P @ V. Products are plain f32 FMAs, so the
// result follows the plain PyTorch version to f32 rounding.
//
// bfloat16 — the pipelined tensor-core body (flash_pipelined_kernel, entry
// flash_attention_bf16; see its note below): strided q/k/v views, RoPE on
// K once per row in a pre-pass, a cp.async K/V ring, ldmatrix, exp2f, a
// token-major output.
//
// bfloat16, first design (flash_rope_mma_kernel; entries with dtype 1):
// contiguous inputs, K rotated by every q tile, synchronous loads. No path
// calls it; it is kept as the yardstick of the redesign.
//
// Bound on an H100: at the tracker's shapes (768 tokens, D = 64) the work is
// 4*Nq*Nk*D flops per head against ~4*N*D input bytes, far above the
// card's flop:byte balance, so it is bound by operations. Ragged Nq and Nk
// are masked, so any lengths work; the head dimension is fixed at 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_once.cuh"
#include <math.h>

#include <cstdint>

namespace {

constexpr int D = 64;        // head dimension
constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // k/v rows per tile
constexpr int THREADS = 256;
constexpr int LD = D + 1;    // padded shared-memory row stride (floats)
constexpr size_t SMEM_BYTES = size_t(3) * 64 * LD * sizeof(float);

// Rows [row0, row0 + 64) of an (n, D) slab into shared memory (stride LD),
// rotated by the RoPE tables (when ROPE) and multiplied by `scale`; rows past
// n are 0.
template <bool ROPE>
__device__ void load_rotated(const float* __restrict__ src,
                             const float* __restrict__ cosb,
                             const float* __restrict__ sinb, int row0, int n,
                             float scale, float* dst) {
  constexpr int QT = D / 4;
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    float val = 0.f;
    if (row < n) {
      const size_t base = size_t(row) * D;
      const float t = src[base + c];
      if constexpr (ROPE) {
        const bool first = ((c / QT) & 1) == 0;
        const int partner = first ? c + QT : c - QT;
        const float p = src[base + partner];
        const float rot = first ? -p : p;
        val = (t * cosb[base + c] + rot * sinb[base + c]) * scale;
      } else {
        val = t * scale;
      }
    }
    dst[r * LD + c] = val;
  }
}

__device__ void load_plain(const float* __restrict__ src, int row0, int n,
                           float* dst) {
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * LD + c] = row < n ? src[size_t(row) * D + c] : 0.f;
  }
}

template <bool ROPE>
__global__ void __launch_bounds__(THREADS)
flash_rope_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ cos_q,
                  const float* __restrict__ sin_q,
                  const float* __restrict__ cos_k,
                  const float* __restrict__ sin_k, float* __restrict__ o,
                  int n_heads, int nq, int nk, float sm_scale) {
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x LD, rotated and scaled q
  float* Ks = Qs + BQ * LD;    // BK x LD, rotated k, then P
  float* Vs = Ks + BK * LD;    // BK x LD

  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  const float* qb = q + size_t(bh) * nq * D;
  const float* kb = k + size_t(bh) * nk * D;
  const float* vb = v + size_t(bh) * nk * D;
  const size_t tq = ROPE ? size_t(b) * nq * D : 0;
  const size_t tk = ROPE ? size_t(b) * nk * D : 0;
  load_rotated<ROPE>(qb, cos_q + tq, sin_q + tq, q0, nq, sm_scale, Qs);

  float acc[4][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();  // the previous tile's P and V are no longer read
    load_rotated<ROPE>(kb, cos_k + tk, sin_k + tk, k0, nk, 1.f, Ks);
    load_plain(vb, k0, nk, Vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + tx + 16 * j >= nk)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;

    // online softmax; the 16 lanes sharing ty hold one row each
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every thread is done reading Ks as K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ks[(ty + 16 * i) * LD + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ks[(ty + 16 * i) * LD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* ob = o + size_t(bh) * nq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= nq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ob[size_t(row) * D + tx + 16 * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16 path on the tensor cores (mma.sync.m16n8k16, f32 accumulation).
//
// One block of 4 warps owns a (batch*head, 64-row q tile); warp w owns q rows
// 16w..16w+15. The rotated, scaled q tile is rounded to bf16 once and kept as
// A fragments in registers. Per 64-key tile, the rotated K tile ([key][d])
// and the V tile, transposed to [d][key], are staged in shared memory as
// bf16 (row stride 72: conflict-free fragment loads); S = Q Kᵀ is 32 mma's
// per warp into f32 accumulators; the online softmax runs on those
// fragments (a row lives in the 4 lanes of a quad, reduced with two
// shuffles); P is rounded to bf16 and fed straight from the S fragments
// as the A operand of P V (another 32 mma's). The output is normalized by
// the f32 row sum.
// ---------------------------------------------------------------------------

constexpr int MTHREADS = 128;
constexpr int SP = D + 8;   // bf16 row stride of the shared tiles

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// load_rotated for bf16 rows with 16-byte accesses: each step rotates 8
// consecutive channels from one vector of t, one of its RoPE partner (a
// quarter away, so also contiguous) and two float4 each of cos and sin.
// Without ROPE the 8 channels are only scaled (and copied as they are when
// scale is 1).
template <bool ROPE>
__device__ void load_rotated_vec(const __nv_bfloat16* __restrict__ src,
                                 const float* __restrict__ cosb,
                                 const float* __restrict__ sinb, int row0,
                                 int n, float scale, __nv_bfloat16* dst) {
  constexpr int QT = D / 4;
  for (int e = threadIdx.x; e < 64 * D / 8; e += MTHREADS) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    const int row = row0 + r;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (row < n && !ROPE) {
      const uint4 tv =
          *reinterpret_cast<const uint4*>(src + size_t(row) * D + c);
      if (scale == 1.f) {
        out = tv;
      } else {
        const __nv_bfloat16* t = reinterpret_cast<const __nv_bfloat16*>(&tv);
        __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = __float2bfloat16(__bfloat162float(t[j]) * scale);
      }
    } else if (row < n) {
      const size_t base = size_t(row) * D;
      const bool first = ((c / QT) & 1) == 0;
      const int partner = first ? c + QT : c - QT;
      const uint4 tv = *reinterpret_cast<const uint4*>(src + base + c);
      const uint4 pv = *reinterpret_cast<const uint4*>(src + base + partner);
      const __nv_bfloat16* t = reinterpret_cast<const __nv_bfloat16*>(&tv);
      const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&pv);
      float cs[8], sn[8];
      *reinterpret_cast<float4*>(cs) =
          *reinterpret_cast<const float4*>(cosb + base + c);
      *reinterpret_cast<float4*>(cs + 4) =
          *reinterpret_cast<const float4*>(cosb + base + c + 4);
      *reinterpret_cast<float4*>(sn) =
          *reinterpret_cast<const float4*>(sinb + base + c);
      *reinterpret_cast<float4*>(sn + 4) =
          *reinterpret_cast<const float4*>(sinb + base + c + 4);
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = __bfloat162float(p[j]);
        const float rot = first ? -pj : pj;
        o[j] = __float2bfloat16(
            (__bfloat162float(t[j]) * cs[j] + rot * sn[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * SP + c) = out;
  }
}

template <bool ROPE>
__global__ void __launch_bounds__(MTHREADS)
flash_rope_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ cos_q,
                      const float* __restrict__ sin_q,
                      const float* __restrict__ cos_k,
                      const float* __restrict__ sin_k,
                      __nv_bfloat16* __restrict__ o, int n_heads, int nq,
                      int nk, float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[BQ * SP];
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * SP];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * SP];

  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;

  const __nv_bfloat16* kb = k + size_t(bh) * nk * D;
  const __nv_bfloat16* vb = v + size_t(bh) * nk * D;
  const size_t tq = ROPE ? size_t(b) * nq * D : 0;
  const size_t tk = ROPE ? size_t(b) * nk * D : 0;
  load_rotated_vec<ROPE>(q + size_t(bh) * nq * D, cos_q + tq, sin_q + tq, q0,
                         nq, sm_scale, Qs);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const __nv_bfloat16* p = Qs + (warp * 16 + g) * SP + ks * 16 + 2 * tg;
    qa[ks][0] = lds32(p);
    qa[ks][1] = lds32(p + 8 * SP);
    qa[ks][2] = lds32(p + 8);
    qa[ks][3] = lds32(p + 8 * SP + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nd][j] = 0.f;
  float m0 = -1e30f, m1 = -1e30f;   // rows g and g + 8 of the warp's tile
  float l0 = 0.f, l1 = 0.f;         // this lane's part of the row sums

  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    load_rotated_vec<ROPE>(kb, cos_k + tk, sin_k + tk, k0, nk, 1.f, Ks);
    for (int e = threadIdx.x; e < BK * D / 8; e += MTHREADS) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      const int row = k0 + r;
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (row < nk)
        vv = *reinterpret_cast<const uint4*>(vb + size_t(row) * D + c);
      const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * SP + r] = vh[j];
    }
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const __nv_bfloat16* p = Ks + (nt * 8 + g) * SP + ks * 16 + 2 * tg;
        mma_bf16(s[nt], qa[ks], lds32(p), lds32(p + 8));
      }
      const int key = k0 + nt * 8 + 2 * tg;
      if (key >= nk) s[nt][0] = s[nt][2] = -INFINITY;
      if (key + 1 >= nk) s[nt][1] = s[nt][3] = -INFINITY;
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = alpha0 * l0 + rs0;
    l1 = alpha1 * l1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= alpha0;
      acc[nd][1] *= alpha0;
      acc[nd][2] *= alpha1;
      acc[nd][3] *= alpha1;
    }

#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __nv_bfloat16* p = Vt + (nd * 8 + g) * SP + kc * 16 + 2 * tg;
        mma_bf16(acc[nd], pa, lds32(p), lds32(p + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + size_t(bh) * nq * D;
  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * tg;
    if (r0 < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + size_t(r0) * D + c) =
          __floats2bfloat162_rn(acc[nd][0] * inv0, acc[nd][1] * inv0);
    if (r0 + 8 < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + size_t(r0 + 8) * D + c) =
          __floats2bfloat162_rn(acc[nd][2] * inv1, acc[nd][3] * inv1);
  }
}

template <bool ROPE>
int launch_mma(const void* q, const void* k, const void* v, const void* cq,
               const void* sq, const void* ck, const void* sk, void* o,
               int bh, int n_heads, int nq, int nk, float sm_scale,
               cudaStream_t stream) {
  const dim3 grid((nq + BQ - 1) / BQ, bh);
  flash_rope_mma_kernel<ROPE><<<grid, MTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(cq),
      static_cast<const float*>(sq), static_cast<const float*>(ck),
      static_cast<const float*>(sk), static_cast<__nv_bfloat16*>(o), n_heads,
      nq, nk, sm_scale);
  return int(cudaGetLastError());
}

template <bool ROPE>
int launch_f32(const void* q, const void* k, const void* v, const void* cq,
               const void* sq, const void* ck, const void* sk, void* o, int bh,
               int n_heads, int nq, int nk, float sm_scale,
               cudaStream_t stream) {
  static PerDeviceOnce once;
  const cudaError_t setup = once.run([] {
    return cudaFuncSetAttribute(flash_rope_kernel<ROPE>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(SMEM_BYTES));
  });
  if (setup != cudaSuccess) return int(setup);
  const dim3 grid((nq + BQ - 1) / BQ, bh);
  flash_rope_kernel<ROPE><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(cq),
      static_cast<const float*>(sq), static_cast<const float*>(ck),
      static_cast<const float*>(sk), static_cast<float*>(o), n_heads, nq, nk,
      sm_scale);
  return int(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16, pipelined (mma.sync.m16n8k16, f32 accumulation), for Hopper.
//
// Inputs are (B, H, N, 64) views with the last dimension contiguous, read
// through their (b, h, n) strides: the head split of a projection's output
// is never copied. With RoPE, rope_rotate_rows first rotates each K row
// once, for every head (f32 math, one rounding to bf16, as the first
// design), into a head-major (B, H, Nk, 64) scratch; q is rotated, scaled
// and rounded once as its block stages it (each q row has one block). So
// no block reads the tables per K tile.
//
// One block owns (batch*head, 48 q rows): 3 q groups of 16 rows, each
// served by two warps that take one half of every 64-key tile, with their
// own online softmax (twice the warps of one warp a q group: one warp's
// exp/max chain overlaps another's products). At 768 tokens the encoder's
// 16 heads and the decoder's 24 give 256 and 384 blocks, 97% of whole
// waves over 132 SMs. Each warp keeps its 16 rotated q rows as A fragments
// (ldmatrix). 64-key K/V tiles stream through a three-stage cp.async ring
// (zero-filled past Nk), the loads of tile t+2 overlapping the products of
// tile t. S = Q Kᵀ reads K with ldmatrix (rows = keys, the "col" B operand
// as it lies); the online softmax runs on the S fragments with exp2 (ex2.
// approx) and log2(e) folded into one FMA (the bf16 rounding points are the
// first design's: q·scale, k, P); P is rounded to bf16 and fed from
// registers as the A operand of P V, whose B fragments come from the V tile
// with ldmatrix.trans (no transpose in memory). At the end the two key
// halves of a q group merge their (m, l, o) through shared memory in a
// fixed order. Shared rows are padded to 144 bytes, so ldmatrix's eight row
// addresses hit distinct bank groups. The output is written through its
// own strides: the wrapper passes a token-major (B, N, H, 64) buffer, so
// merging the heads is a view. mma.sync, not wgmma: at D = 64 the softmax's
// exp and shuffles, not the products, set the pace (FA2's choice at this
// head size).
// ---------------------------------------------------------------------------

struct Strides {
  long long b, h, n;   // element strides of a (B, H, N, 64) view
};

constexpr int PK = 64;   // keys per K/V tile

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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Channels c..c+7 of one row, rotated by its f32 tables (ROPE) and scaled,
// rounded to bf16 once: the first design's load_rotated_vec for one vector.
template <bool ROPE>
__device__ __forceinline__ uint4 rotate8(const __nv_bfloat16* __restrict__ row,
                                         const float* __restrict__ cosr,
                                         const float* __restrict__ sinr,
                                         int c, float scale) {
  constexpr int QT = D / 4;
  const uint4 tv = *reinterpret_cast<const uint4*>(row + c);
  const __nv_bfloat16* t = reinterpret_cast<const __nv_bfloat16*>(&tv);
  uint4 out;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
  if constexpr (ROPE) {
    const bool first = ((c / QT) & 1) == 0;
    const int partner = first ? c + QT : c - QT;
    const uint4 pv = *reinterpret_cast<const uint4*>(row + partner);
    const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&pv);
    float cs[8], sn[8];
    *reinterpret_cast<float4*>(cs) = *reinterpret_cast<const float4*>(cosr + c);
    *reinterpret_cast<float4*>(cs + 4) =
        *reinterpret_cast<const float4*>(cosr + c + 4);
    *reinterpret_cast<float4*>(sn) = *reinterpret_cast<const float4*>(sinr + c);
    *reinterpret_cast<float4*>(sn + 4) =
        *reinterpret_cast<const float4*>(sinr + c + 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float pj = __bfloat162float(p[j]);
      const float rot = first ? -pj : pj;
      o[j] = __float2bfloat16(
          (__bfloat162float(t[j]) * cs[j] + rot * sn[j]) * scale);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = __float2bfloat16(__bfloat162float(t[j]) * scale);
  }
  return out;
}

// The RoPE pre-pass: k (B, H, nk, 64) through its strides → out (B*H, nk,
// 64) contiguous, each row rotated once. Eight threads a row.
__global__ void __launch_bounds__(256)
rope_rotate_rows(const __nv_bfloat16* __restrict__ k, Strides sk,
                 const float* __restrict__ cos_k,
                 const float* __restrict__ sin_k,
                 __nv_bfloat16* __restrict__ out, int n_heads, int nk) {
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = e >> 3, c = (e & 7) * 8;
  if (row >= nk) return;
  const size_t t = (size_t(b) * nk + row) * D;
  *reinterpret_cast<uint4*>(out + (size_t(bh) * nk + row) * D + c) =
      rotate8<true>(k + b * sk.b + h * sk.h + row * sk.n, cos_k + t,
                    sin_k + t, c, 1.f);
}

constexpr int PQG = 3;               // q groups (16 rows each) a block
constexpr int PBQ = 16 * PQG;         // q rows a block
constexpr int PTHREADS = 64 * PQG;    // two warps (key halves) a q group
constexpr int PMERGE = 16 * (D + 2);  // floats a q group merges through
constexpr int PSTAGES = 3;            // K/V ring depth
constexpr int PTILE = 2 * PK * SP;    // a ring slot: K rows then V rows
constexpr size_t PSMEM =
    size_t(PBQ * SP + PSTAGES * PTILE) * sizeof(__nv_bfloat16);
static_assert(PQG * PMERGE * sizeof(float) <=
                  PSTAGES * PTILE * sizeof(__nv_bfloat16),
              "the merge buffer lives over the ring");

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <bool ROPE>
__global__ void __launch_bounds__(PTHREADS)
flash_pipelined_kernel(const __nv_bfloat16* __restrict__ q, Strides sq,
                       const __nv_bfloat16* __restrict__ k, Strides sk,
                       const __nv_bfloat16* __restrict__ v, Strides sv,
                       const float* __restrict__ cos_q,
                       const float* __restrict__ sin_q,
                       __nv_bfloat16* __restrict__ o, Strides so, int n_heads,
                       int nq, int nk, float sm_scale) {
  extern __shared__ __align__(16) unsigned char fa_smem[];
  __nv_bfloat16* const Qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* const ring = Qs + PBQ * SP;

  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const int q0 = blockIdx.x * PBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int qg = warp >> 1, kh = warp & 1;   // q group, key half
  const int g = lane >> 2, tg = lane & 3;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  auto load_kv = [&](int slot, int k0) {
    for (int e = tid; e < PK * (D / 8); e += PTHREADS) {
      const int r = e >> 3, c = (e & 7) * 8;
      const bool ok = k0 + r < nk;
      const long long row = ok ? k0 + r : 0;
      __nv_bfloat16* dst = ring + slot * PTILE + r * SP + c;
      cp_async16(dst, kb + row * sk.n + c, ok ? 16 : 0);
      cp_async16(dst + PK * SP, vb + row * sv.n + c, ok ? 16 : 0);
    }
  };
  const int ntiles = (nk + PK - 1) / PK;
#pragma unroll
  for (int st = 0; st < PSTAGES - 1; ++st) {
    if (st < ntiles) load_kv(st, st * PK);
    cp_async_commit();
  }

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  for (int e = tid; e < PBQ * (D / 8); e += PTHREADS) {
    const int r = e >> 3, c = (e & 7) * 8;
    const int row = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < nq) {
      const size_t t = ROPE ? (size_t(b) * nq + row) * D : 0;
      val = rotate8<ROPE>(qb + row * sq.n, cos_q + t, sin_q + t, c,
                          sm_scale);
    }
    *reinterpret_cast<uint4*>(Qs + r * SP + c) = val;
  }
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldmatrix_x4(qa[ks], Qs + (qg * 16 + (lane & 15)) * SP + ks * 16 +
                            (lane >> 4) * 8);

  constexpr float L2E = 1.4426950408889634f;
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nd][j] = 0.f;
  float m0 = -1e30f, m1 = -1e30f;   // rows g and g + 8 of the q group
  float l0 = 0.f, l1 = 0.f;         // this lane's part of the row sums

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<PSTAGES - 2>();   // tile t has landed
    __syncthreads();                // ... for all; slot (t-1) % 3 free
    if (t + PSTAGES - 1 < ntiles)
      load_kv((t + PSTAGES - 1) % PSTAGES, (t + PSTAGES - 1) * PK);
    cp_async_commit();
    const __nv_bfloat16* kt = ring + (t % PSTAGES) * PTILE + kh * 32 * SP;
    const __nv_bfloat16* vt = kt + PK * SP;

    float s[4][4];   // 16 rows x this warp's 32 keys of the tile
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * SP +
                           ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[ks], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qa[ks], r[2], r[3]);
      }
    }
    if ((t + 1) * PK > nk) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int key = t * PK + kh * 32 + nt * 8 + 2 * tg;
        if (key >= nk) s[nt][0] = s[nt][2] = -INFINITY;
        if (key + 1 >= nk) s[nt][1] = s[nt][3] = -INFINITY;
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = fast_exp2((m0 - mn0) * L2E);
    const float alpha1 = fast_exp2((m1 - mn1) * L2E);
    const float mb0 = mn0 * L2E, mb1 = mn1 * L2E;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      s[nt][0] = fast_exp2(fmaf(s[nt][0], L2E, -mb0));
      s[nt][1] = fast_exp2(fmaf(s[nt][1], L2E, -mb0));
      s[nt][2] = fast_exp2(fmaf(s[nt][2], L2E, -mb1));
      s[nt][3] = fast_exp2(fmaf(s[nt][3], L2E, -mb1));
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = alpha0 * l0 + rs0;
    l1 = alpha1 * l1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= alpha0;
      acc[nd][1] *= alpha0;
      acc[nd][2] *= alpha1;
      acc[nd][3] *= alpha1;
    }
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt + (kc * 16 + (lane & 15)) * SP + dp * 16 +
                                 (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, r[0], r[1]);
        mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // merge the key halves: half 1 leaves (o, m, l) in shared memory (over
  // the ring, no longer read), half 0 combines and writes the output
  float* const mrg = reinterpret_cast<float*>(ring) + qg * PMERGE;
  __syncthreads();
  if (kh == 1) {
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int c = nd * 8 + 2 * tg;
      *reinterpret_cast<float2*>(mrg + g * D + c) =
          make_float2(acc[nd][0], acc[nd][1]);
      *reinterpret_cast<float2*>(mrg + (g + 8) * D + c) =
          make_float2(acc[nd][2], acc[nd][3]);
    }
    if (tg == 0) {
      mrg[16 * D + g] = m0;
      mrg[16 * D + g + 8] = m1;
      mrg[16 * D + 16 + g] = l0;
      mrg[16 * D + 16 + g + 8] = l1;
    }
  }
  __syncthreads();
  if (kh == 1) return;
  const float pm0 = mrg[16 * D + g], pm1 = mrg[16 * D + g + 8];
  const float mm0 = fmaxf(m0, pm0), mm1 = fmaxf(m1, pm1);
  const float a0 = exp2f((m0 - mm0) * L2E), a1 = exp2f((m1 - mm1) * L2E);
  const float b0 = exp2f((pm0 - mm0) * L2E), b1 = exp2f((pm1 - mm1) * L2E);
  const float inv0 =
      1.f / fmaxf(l0 * a0 + mrg[16 * D + 16 + g] * b0, 1e-30f);
  const float inv1 =
      1.f / fmaxf(l1 * a1 + mrg[16 * D + 16 + g + 8] * b1, 1e-30f);
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
  const int r0 = q0 + qg * 16 + g;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * tg;
    const float2 p0 = *reinterpret_cast<const float2*>(mrg + g * D + c);
    const float2 p1 = *reinterpret_cast<const float2*>(mrg + (g + 8) * D + c);
    if (r0 < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * so.n + c) =
          __floats2bfloat162_rn((acc[nd][0] * a0 + p0.x * b0) * inv0,
                                (acc[nd][1] * a0 + p0.y * b0) * inv0);
    if (r0 + 8 < nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (r0 + 8) * so.n + c) =
          __floats2bfloat162_rn((acc[nd][2] * a1 + p1.x * b1) * inv1,
                                (acc[nd][3] * a1 + p1.y * b1) * inv1);
  }
}

template <bool ROPE>
int launch_pipelined(const void* q, Strides sq, const void* k, Strides sk,
                     const void* v, Strides sv, const void* cq,
                     const void* sqt, void* o, Strides so, int bh,
                     int n_heads, int nq, int nk, float sm_scale,
                     cudaStream_t stream) {
  static PerDeviceOnce once;
  const cudaError_t setup = once.run([] {
    return cudaFuncSetAttribute(flash_pipelined_kernel<ROPE>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(PSMEM));
  });
  if (setup != cudaSuccess) return int(setup);
  const dim3 grid((nq + PBQ - 1) / PBQ, bh);
  flash_pipelined_kernel<ROPE><<<grid, PTHREADS, PSMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), sq,
      static_cast<const __nv_bfloat16*>(k), sk,
      static_cast<const __nv_bfloat16*>(v), sv, static_cast<const float*>(cq),
      static_cast<const float*>(sqt), static_cast<__nv_bfloat16*>(o), so,
      n_heads, nq, nk, sm_scale);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the first design). q (BH, nq, D), k/v
// (BH, nk, D) and o (BH, nq, D) contiguous; tables (BH / n_heads, n, D)
// contiguous float32.
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_rope(int dtype, const void* q, const void* k,
                                    const void* v, const void* cos_q,
                                    const void* sin_q, const void* cos_k,
                                    const void* sin_k, void* o, int bh,
                                    int n_heads, int nq, int nk, int d,
                                    float sm_scale, void* stream) {
  if (d != D || bh <= 0 || nq <= 0 || nk <= 0 || bh > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32<true>(q, k, v, cos_q, sin_q, cos_k, sin_k, o, bh,
                            n_heads, nq, nk, sm_scale, s);
  if (dtype == 1)
    return launch_mma<true>(q, k, v, cos_q, sin_q, cos_k, sin_k, o, bh,
                            n_heads, nq, nk, sm_scale, s);
  return int(cudaErrorInvalidValue);
}

// K3: the same kernel with RoPE switched off. q (BH, nq, D), k/v (BH, nk, D)
// and o (BH, nq, D) contiguous; no tables. Returns a cudaError_t.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* o, int bh, int nq, int nk,
                               int d, float sm_scale, void* stream) {
  if (d != D || bh <= 0 || nq <= 0 || nk <= 0 || bh > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32<false>(q, k, v, nullptr, nullptr, nullptr, nullptr, o,
                             bh, 1, nq, nk, sm_scale, s);
  if (dtype == 1)
    return launch_mma<false>(q, k, v, nullptr, nullptr, nullptr, nullptr, o,
                             bh, 1, nq, nk, sm_scale, s);
  return int(cudaErrorInvalidValue);
}

// The pipelined bf16 body (K1 with rope != 0, K3 without). q (B, H, nq,
// 64), k and v (B, H, nk, 64) and o (B, H, nq, 64): bf16 views with the
// last dimension contiguous, rows 16-byte aligned; strides[12] holds the
// (b, h, n) element strides of q, k, v and o. With rope: tables (B, n, 64)
// contiguous float32 and k_rot, a (B*H, nk, 64) bf16 scratch for the
// rotated k. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_bf16(int rope, const void* q, const void* k,
                                    const void* v, const void* cos_q,
                                    const void* sin_q, const void* cos_k,
                                    const void* sin_k, void* o, void* k_rot,
                                    const long long* strides, int B,
                                    int n_heads, int nq, int nk, int d,
                                    float sm_scale, void* stream) {
  const long long bh = (long long)B * n_heads;
  if (d != D || B <= 0 || n_heads <= 0 || nq <= 0 || nk <= 0 || bh > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sq{strides[0], strides[1], strides[2]};
  Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  if (!rope)
    return launch_pipelined<false>(q, sq, k, sk, v, sv, nullptr, nullptr, o,
                                   so, int(bh), n_heads, nq, nk, sm_scale, s);
  const dim3 grid((nk * 8 + 255) / 256, int(bh));
  rope_rotate_rows<<<grid, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(k), sk,
      static_cast<const float*>(cos_k), static_cast<const float*>(sin_k),
      static_cast<__nv_bfloat16*>(k_rot), n_heads, nk);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  sk = Strides{(long long)n_heads * nk * D, (long long)nk * D, D};
  return launch_pipelined<true>(q, sq, k_rot, sk, v, sv, cos_q, sin_q, o, so,
                                int(bh), n_heads, nq, nk, sm_scale, s);
}

extern "C" const char* flash_attention_rope_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
