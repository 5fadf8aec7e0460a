// Flash attention, with or without 2D RoPE applied inside the kernel, for
// sm_90a.
//
// Replaces two TPU kernels of mast3r_slam_tpu/ops/flash_attention.py:
// flash_attention_rope (K1: body _flash_rope_kernel, rotation _rope_rotate)
// and flash_attention (K3: body _flash_kernel). One kernel source serves
// both: the template flag ROPE switches the rotation off at compile time, and
// the entry points flash_attention_rope / flash_attention launch the two
// instances. Without RoPE the q rows are only scaled by sm_scale and the k
// rows are loaded as they are; everything else is shared. With RoPE it
// computes exactly what the K1 TPU kernel computes: q and k arrive un-rotated;
// each row is rotated in f32 against (B, N, D) cos/sin tables laid out as
// quarters [y, y, x, x] with rotate-half pairing inside each D/2 half
// (rot = [-t2, t1, -t4, t3]); q is then scaled by sm_scale; the softmax runs
// online over K/V tiles in f32; the output is o / max(l, 1e-30) in q's type.
//
// Two paths, one per input type:
//
// float32 — CUDA cores. One block of 256 threads owns one (batch*head,
// 64-row q tile). The rotated, scaled q tile lives in shared memory for the
// whole kernel; 64-row K/V tiles stream through shared memory (K rotated on
// load). Each thread owns a 4x4 patch of the 64x64 score tile and the same
// 4x4 patch of the 64x64 output accumulator (rows ty + 16i, columns
// tx + 16j), so the row max / row sum of the online softmax reduce over the
// 16 lanes of a half-warp with shuffles. After the scores are read, the K
// tile's shared buffer is reused for the probabilities P, which feed P @ V.
// Products are plain f32 FMAs, so the result follows the plain PyTorch
// version to f32 rounding.
//
// bfloat16 — tensor cores (mma.sync.m16n8k16, see flash_rope_mma_kernel):
// the rotated q and k and the probabilities P are rounded to bf16 for the
// two products, which accumulate in f32; softmax statistics stay in f32.
//
// Bound on an H100: at the tracker's shapes (768 tokens, D = 64) the work is
// 4*Nq*Nk*D flops per head against ~4*N*D input bytes, far above the
// card's flop:byte balance, so it is bound by operations. Ragged Nq and Nk
// are masked, so any lengths work; the head dimension is fixed at 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_rope_kernel<ROPE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(SMEM_BYTES));
    if (e != cudaSuccess) return int(e);
    configured = true;
  }
  const dim3 grid((nq + BQ - 1) / BQ, bh);
  flash_rope_kernel<ROPE><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(cq),
      static_cast<const float*>(sq), static_cast<const float*>(ck),
      static_cast<const float*>(sk), static_cast<float*>(o), n_heads, nq, nk,
      sm_scale);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (BH, nq, D), k/v (BH, nk, D) and o
// (BH, nq, D) contiguous; tables (BH / n_heads, n, D) contiguous float32.
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

extern "C" const char* flash_attention_rope_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
