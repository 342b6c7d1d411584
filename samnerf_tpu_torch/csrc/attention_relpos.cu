// FLASH-RELPOS: attention with SAM's decomposed relative-position bias,
// for sm_90a, to f32 precision on the tensor cores.
//
// Replaces the TPU Pallas kernel samnerf_tpu/ops/attention_pallas.py
// _attn_kernel.  For each (batch*head) b, query i and key j it computes
//   softmax_j(q_i . k_j * scale + rel_h[b, i, j / Kw] + rel_w[b, i, j % Kw]) v_j
// with an online softmax, so the N x N logits never reach device memory;
// rel_h [B, N, Kh] and rel_w [B, N, Kw] are the bias terms already
// contracted with q (outside the kernel, as the JAX encoder does).
//
// What bounds it on an H100: operations.  4 N^2 D flops per (batch*head)
// against 4 (4 N D + N (Kh + Kw)) bytes.  To f32 precision on the tensor
// cores each product is three TF32 passes (3xTF32: big*big + big*small +
// small*big, the small terms first), so the least time is 3 * 4 N^2 D
// flops at the TF32 rate: 0.521 ms at SAM ViT-H's global layers (N = 4096,
// D = 80, 16 heads).  The mma.sync used here tops out near 310 TFLOP/s of
// the 495 (0.83 ms there), and on this card other instructions run
// after it rather than beside it, so the splits and the softmax add to
// that time (PERF.md).
//
// Design:
// - Warps own query rows.  A block of 4 warps takes one batch*head and 64
//   queries; each warp owns 16 query rows for the whole key loop.  The
//   logits tile S, the running max m, sum l and the output accumulator stay
//   in registers in the mma.m16n8k8 accumulator layout, so a row's max
//   reduces over the 4 lanes of a quad (2 shuffles), the sum is kept per
//   lane and reduced once at the end, and the softmax needs no barrier.
// - Both products, S = (q scale) K^T and O += P V, run as
//   mma.sync.m16n8k8 .tf32 in 3xTF32, in passes over 4 accumulators (so no
//   mma waits on the one before it).  D is padded to a multiple of 8 with
//   zeros (KD = ceil(D / 8) k-steps; ViT-H's D = 80 is 10).  The split
//   takes two instructions: the tensor core reads a .tf32 operand's top 19
//   bits, so x itself is the big part and x - (x truncated) the small.
// - An asynchronous K/V ring: tiles of 64 keys of K and V arrive by
//   16-byte cp.async.cg (4-byte where D % 4 != 0 or a pointer is not
//   16-byte aligned) into a ring of 2 stages, so tile t + 1 is in flight
//   while tile t multiplies; one __syncthreads per tile.  Within a k-step
//   the A columns / B rows t and t + 4 are head dims 2t and 2t + 1, so q
//   and K fragments are float2 reads; their rows are padded to 8 mod 16
//   floats, V's to 4 mod 8 (D + 4), which keeps every fragment read free
//   of bank conflicts.  Ragged tiles and the padded columns are
//   zero-filled through cp.async's src-size.
// - P stays in registers.  The accumulator layout of S holds keys 2t and
//   2t + 1 of each 8-key block in lane t of a quad; the PV product takes
//   the keys of a block in the order (0, 2, 4, 6, 1, 3, 5, 7), so that its
//   A operand (columns t and t + 4) is exactly those two registers, and
//   reads V's rows in the same order.  No shuffle, no shared memory.
// - The bias is the accumulator's initial value: S starts at
//   rel_h + rel_w and the products add q.k.  Where Kw is the key tile
//   (64, SAM's 64 x 64 token grid) a tile is one kh row: each lane holds
//   its 2 rows x 16 columns of rel_w in registers for the whole loop and
//   reads 2 values of rel_h per tile.  Otherwise (any Kh, Kw) the block
//   writes each tile's 64 x 64 bias into shared memory; a thread's column
//   is fixed, so its (kh, kw) comes from the tile's base and one divmod
//   made before the loop, with no division in it.  Keys past N get -1e30
//   (their K rows are zero, so they stay there); queries past N are not
//   written.
// - Semantics of the TPU kernel: m starts at -1e30, out = acc /
//   max(l, 1e-30); expf, no --use_fast_math.
//
// Budget (ptxas, sm_90a, CUDA 12.9): 210 registers at D = 80 and 202 at
// D = 64 on the token grid, 159 to 238 over all 32 instantiations, no
// spills (__launch_bounds__ asks for two blocks a SM).  Shared memory:
// 108 KB at D = 80 and 88 KB at D = 64, so two blocks (8 warps) a SM;
// 168 KB at D = 128 (one block); the general path adds a 17 KB bias tile.
// The variants of the design that lost to this one (8 warps, K a tile
// ahead of V, 3 stages, P by shuffles or through shared memory, q in
// registers, other mma orders) are measured in PERF.md.
//
// Head dims 1..128 (templated on KD); any Kh * Kw == N.  The wrapper keeps
// the first design's Kh + Kw <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockK = 64;               // keys per tile
constexpr int kMaxHeadDim = 128;
constexpr int kMaxRelSum = 256;
constexpr float kNegInf = -1e30f;

// x = big + small in TF32 (3xTF32: big*big' + big*small' + small*big'
// carries a product to about f32 precision).  The tensor core reads a
// .tf32 operand's top 19 bits and ignores the low 13, so x's own bits are
// big (its mantissa truncated to 10 bits) and small = x - big, whose low
// bits are truncated likewise: two instructions a split.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x);
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// d += a b for one 16x8x8 TF32 tile of a warp, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i] += a b[i] in 3xTF32 over a group of accumulators, a pass per
// term (small terms first), so no mma waits on the one before it.
// a, b: [big, small].
template <int N>
__device__ __forceinline__ void mma_group(float (*acc)[4], const uint32_t (&a)[2][4],
                                          const uint32_t (&b)[N][2][2], int live) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < live) mma_tf32(acc[i], a[1], b[i][0]);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < live) mma_tf32(acc[i], a[0], b[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < live) mma_tf32(acc[i], a[0], b[i][0]);
}

// cp.async of 16 bytes (.cg: to L2 only) or 4 bytes; valid false
// zero-fills the destination (src-size 0).  dst and src of any element type.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tiles of one instantiation: 4 warps, 64 queries a block, one ring
// of 2 (K, V) stages of 64 keys.
template <int KD>
struct Tiles {
  static constexpr int kDP = 8 * KD;                 // padded head dim
  // q, K rows: read as float2 at (row g, dim 2t), so 8 mod 16 floats is
  // conflict free
  static constexpr int kStride = (kDP + 15) / 16 * 16 + 8;
  // V rows: read at (key 2t or 2t + 1, dim g), so 4 mod 8 floats is
  // conflict free
  static constexpr int kVStride = kDP + 4;
  static constexpr int kWarps = 4;
  static constexpr int kStages = 2;
  static constexpr int kBlockQ = 16 * kWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kPStride = kBlockK + 4;
  static constexpr int kQFloats = kBlockQ * kStride;
  static constexpr int kKFloats = kBlockK * kStride;
  static constexpr int kVFloats = kBlockK * kVStride;
  static constexpr int kBFloats = kBlockQ * kPStride;   // the general path's bias tile
  static constexpr size_t bytes(bool spec) {
    return (size_t)(kQFloats + kStages * (kKFloats + kVFloats) + (spec ? 0 : kBFloats)) *
           sizeof(float);
  }
};

// Rows [row0, row0 + R) of src [n, d] (elements of type E) into dst
// [R][STRIDE] (DP columns), rows past n and columns past d zero-filled.
// vec 2: 16-byte cp.async (d a multiple of 16 bytes, 16-byte aligned
// pointers), where also d == DP the rows are one contiguous run of
// chunks; vec 1: 4-byte cp.async (d a multiple of 4 bytes, 4-byte
// aligned), which f32 takes for any vec but 2; vec 0 (2-byte elements):
// plain loads and stores.
template <typename E, int R, int DP, int STRIDE, int THREADS>
__device__ __forceinline__ void stage_rows(E* dst, const E* __restrict__ src, int row0, int n,
                                           int d, int vec) {
  if (vec == 2) {
    constexpr int kE = 16 / sizeof(E), kChunks = DP / kE;
    if (d == DP) {
      const E* run = src + (size_t)row0 * d;
      const int live = min(R, n - row0) * kChunks;
#pragma unroll 4
      for (int e = threadIdx.x; e < R * kChunks; e += THREADS) {
        const int r = e / kChunks, c = (e - r * kChunks) * kE;
        cp_async16(dst + r * STRIDE + c, e < live ? run + kE * e : src, e < live);
      }
    } else {
#pragma unroll 4
      for (int e = threadIdx.x; e < R * kChunks; e += THREADS) {
        const int r = e / kChunks, c = (e - r * kChunks) * kE;
        const bool valid = row0 + r < n && c < d;
        cp_async16(dst + r * STRIDE + c, valid ? src + (size_t)(row0 + r) * d + c : src, valid);
      }
    }
  } else if (sizeof(E) == 4 || vec == 1) {
    constexpr int kE = 4 / sizeof(E), kChunks = DP / kE;
#pragma unroll 4
    for (int e = threadIdx.x; e < R * kChunks; e += THREADS) {
      const int r = e / kChunks, c = (e - r * kChunks) * kE;
      const bool valid = row0 + r < n && c < d;
      cp_async4(dst + r * STRIDE + c, valid ? src + (size_t)(row0 + r) * d + c : src, valid);
    }
  } else if constexpr (sizeof(E) < 4) {
    for (int e = threadIdx.x; e < R * DP; e += THREADS) {
      const int r = e / DP, c = e - r * DP;
      const bool valid = row0 + r < n && c < d;
      dst[r * STRIDE + c] = valid ? __ldg(src + (size_t)(row0 + r) * d + c) : E(0);
    }
  }
}

// The q fragment of k-step kk for rows (g, g + 8) of a warp, scaled and
// split: A columns t and t + 4 are head dims 2t and 2t + 1 of the step
// (K's B rows likewise), so each row is one float2.  qa = q tile + row g
// + 2t.
template <int STRIDE>
__device__ __forceinline__ void load_q(const float* qa, int kk, float scale,
                                       uint32_t (&f)[2][4]) {
  const float2 lo = *reinterpret_cast<const float2*>(qa + kk * 8);
  const float2 hi = *reinterpret_cast<const float2*>(qa + 8 * STRIDE + kk * 8);
  split_tf32(lo.x * scale, f[0][0], f[1][0]);
  split_tf32(hi.x * scale, f[0][1], f[1][1]);
  split_tf32(lo.y * scale, f[0][2], f[1][2]);
  split_tf32(hi.y * scale, f[0][3], f[1][3]);
}

// KD: head dim in k-steps of 8.  SPEC: kw == kBlockK, so a key tile is
// one kh row.
template <int KD, bool SPEC>
__global__ void __launch_bounds__(128, 2)
flash_relpos_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ rel_h,
                    const float* __restrict__ rel_w, float* __restrict__ out,
                    int n, int d, int kh, int kw, float scale, int vec) {
  using T = Tiles<KD>;
  constexpr int kGroup = 4;                       // accumulators per mma pass
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);    // [kBlockQ][kStride]
  float* ks = qs + T::kQFloats;                   // kStages x [kBlockK][kStride]
  float* vs = ks + T::kStages * T::kKFloats;      // kStages x [kBlockK][kVStride]
  float* bt = vs + T::kStages * T::kVFloats;      // !SPEC: [kBlockQ][kPStride]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * T::kBlockQ;
  const size_t base = (size_t)blockIdx.y * n * d;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const int num_kt = (n + kBlockK - 1) / kBlockK;

  auto stage_kv = [&](int tile) {
    if (tile < num_kt) {
      stage_rows<float, kBlockK, T::kDP, T::kStride, T::kThreads>(
          ks + (tile % T::kStages) * T::kKFloats, kb, tile * kBlockK, n, d, vec);
      stage_rows<float, kBlockK, T::kDP, T::kVStride, T::kThreads>(
          vs + (tile % T::kStages) * T::kVFloats, vb, tile * kBlockK, n, d, vec);
    }
  };

  // a lane's two query rows (g and g + 8 of its warp), clamped for the
  // bias reads; rows past n are computed and not written
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  const size_t rel_row = (size_t)blockIdx.y * n;
  const float* rh_lo = rel_h + (rel_row + min(i0 + r_lo, n - 1)) * kh;
  const float* rh_hi = rel_h + (rel_row + min(i0 + r_hi, n - 1)) * kh;

  // SPEC (kw == kBlockK): rel_w of the lane's columns, fixed for the loop.
  // Otherwise the block builds each tile's bias in shared memory; a
  // thread's column c = tid % 64 is fixed, so (c / kw, c % kw) is
  // computed once, and (h0, w0) = divmod(j0, kw) advances per tile.
  float relw[SPEC ? 8 : 1][4];
  int h0 = 0, w0 = 0, q64 = 0, r64 = 0, cq = 0, cr = 0;
  if constexpr (SPEC) {
    const float* rw_lo = rel_w + (rel_row + min(i0 + r_lo, n - 1)) * kw;
    const float* rw_hi = rel_w + (rel_row + min(i0 + r_hi, n - 1)) * kw;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      relw[nt][0] = __ldg(rw_lo + c);
      relw[nt][1] = __ldg(rw_lo + c + 1);
      relw[nt][2] = __ldg(rw_hi + c);
      relw[nt][3] = __ldg(rw_hi + c + 1);
    }
  } else {
    const int c = threadIdx.x % kBlockK;
    cq = c / kw;
    cr = c - cq * kw;
    q64 = kBlockK / kw;
    r64 = kBlockK - q64 * kw;
  }

  float o[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  const float* qa = qs + r_lo * T::kStride + 2 * t;

  stage_rows<float, T::kBlockQ, T::kDP, T::kStride, T::kThreads>(qs, qb, i0, n, d, vec);
  stage_kv(0);                                    // q goes with the first tile's group
  cp_async_commit();
  for (int tile = 0; tile < num_kt; ++tile) {
    cp_async_wait<0>();    // this thread's copies of the tile landed
    __syncthreads();       // everyone's did; the other slot is free
    stage_kv(tile + 1);
    cp_async_commit();

    // s = bias + (q scale) K^T of the tile
    float s[8][4];
    if constexpr (SPEC) {
      const float bh_lo = __ldg(rh_lo + tile), bh_hi = __ldg(rh_hi + tile);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = bh_lo + relw[nt][0];
        s[nt][1] = bh_lo + relw[nt][1];
        s[nt][2] = bh_hi + relw[nt][2];
        s[nt][3] = bh_hi + relw[nt][3];
      }
    } else {
      const int c = threadIdx.x % kBlockK, j = tile * kBlockK + c;
      int hh = h0 + cq, ww = w0 + cr;
      if (ww >= kw) {
        ww -= kw;
        ++hh;
      }
#pragma unroll 4
      for (int r = threadIdx.x / kBlockK; r < T::kBlockQ; r += T::kThreads / kBlockK) {
        const size_t row = rel_row + min(i0 + r, n - 1);
        bt[r * T::kPStride + c] =
            j < n ? __ldg(rel_h + row * kh + hh) + __ldg(rel_w + row * kw + ww) : kNegInf;
      }
      h0 += q64;
      w0 += r64;
      if (w0 >= kw) {
        w0 -= kw;
        ++h0;
      }
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 lo = *reinterpret_cast<const float2*>(bt + r_lo * T::kPStride + nt * 8 + 2 * t);
        const float2 hi = *reinterpret_cast<const float2*>(bt + r_hi * T::kPStride + nt * 8 + 2 * t);
        s[nt][0] = lo.x;
        s[nt][1] = lo.y;
        s[nt][2] = hi.x;
        s[nt][3] = hi.y;
      }
    }
    const float* kt = ks + (tile % T::kStages) * T::kKFloats;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[2][4];
      load_q<T::kStride>(qa, kk, scale, a);
#pragma unroll
      for (int n0 = 0; n0 < 8; n0 += kGroup) {
        uint32_t b[kGroup][2][2];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const float2 x = *reinterpret_cast<const float2*>(
              kt + ((n0 + i) * 8 + g) * T::kStride + kk * 8 + 2 * t);
          split_tf32(x.x, b[i][0][0], b[i][1][0]);
          split_tf32(x.y, b[i][0][1], b[i][1][1]);
        }
        mma_group<kGroup>(s + n0, a, b, kGroup);
      }
    }

    // the online softmax of the tile's logits (a row's 64 logits are in
    // one quad)
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float alpha_lo = expf(m_lo - mx_lo), alpha_hi = expf(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mx_lo);
      s[nt][1] = expf(s[nt][1] - mx_lo);
      s[nt][2] = expf(s[nt][2] - mx_hi);
      s[nt][3] = expf(s[nt][3] - mx_hi);
      sum_lo += s[nt][0] + s[nt][1];
      sum_hi += s[nt][2] + s[nt][3];
    }
    l_lo = alpha_lo * l_lo + sum_lo;       // this lane's columns; quad sum at the end
    l_hi = alpha_hi * l_hi + sum_hi;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      o[nd][0] *= alpha_lo;
      o[nd][1] *= alpha_lo;
      o[nd][2] *= alpha_hi;
      o[nd][3] *= alpha_hi;
    }

    // O += P V, one 8-key block per k-step; A columns (t, t + 4) are keys
    // (2t, 2t + 1) of the block, so P is the S registers as they are
    const float* vt = vs + (tile % T::kStages) * T::kVFloats;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float p[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      const float* vr = vt + (kk * 8 + 2 * t) * T::kVStride + g;
      uint32_t a[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(p[e], a[0][e], a[1][e]);
#pragma unroll
      for (int n0 = 0; n0 < KD; n0 += kGroup) {
        uint32_t b[kGroup][2][2];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (n0 + i < KD) {
            split_tf32(vr[(n0 + i) * 8], b[i][0][0], b[i][1][0]);
            split_tf32(vr[T::kVStride + (n0 + i) * 8], b[i][0][1], b[i][1][1]);
          }
        }
        mma_group<kGroup>(o + n0, a, b, KD - n0);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = i0 + (half ? r_hi : r_lo);
    if (row >= n) continue;
    const float den = half ? den_hi : den_lo;
    float* orow = out + base + (size_t)row * d;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (col < d) orow[col] = o[nd][2 * half] / den;
      if (col + 1 < d) orow[col + 1] = o[nd][2 * half + 1] / den;
    }
  }
}

struct Args {
  const float *q, *k, *v, *rel_h, *rel_w;
  float* out;
  int b, n, d, kh, kw;
  float scale;
  int vec;
};

template <int KD, bool SPEC>
int launch(const Args& a, cudaStream_t stream) {
  using T = Tiles<KD>;
  auto kernel = flash_relpos_kernel<KD, SPEC>;
  constexpr size_t kBytes = T::bytes(SPEC);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + T::kBlockQ - 1) / T::kBlockQ, a.b);
  kernel<<<grid, T::kThreads, kBytes, stream>>>(a.q, a.k, a.v, a.rel_h, a.rel_w, a.out,
                                                   a.n, a.d, a.kh, a.kw, a.scale, a.vec);
  return (int)cudaGetLastError();
}

template <int KD>
int launch_design(const Args& a, cudaStream_t stream) {
  return a.kw == kBlockK ? launch<KD, true>(a, stream) : launch<KD, false>(a, stream);
}

bool invalid(int b, int n, int d, int kh, int kw) {
  return b < 1 || b > 65535 || n < 1 || d < 1 || d > kMaxHeadDim || kh < 1 || kw < 1 ||
         (long long)kh * kw != n || kh + kw > kMaxRelSum;
}

Args make_args(const void* q, const void* k, const void* v, const void* rel_h,
               const void* rel_w, void* out, int b, int n, int d, int kh, int kw,
               float scale) {
  const bool aligned = (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15u) == 0;
  return Args{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<const float*>(rel_h),
              static_cast<const float*>(rel_w), static_cast<float*>(out),
              b, n, d, kh, kw, scale, (d % 4 == 0 && aligned) ? 2 : 1};
}

}  // namespace

// q, k, v, out [b, n, d]; rel_h [b, n, kh]; rel_w [b, n, kw]; all
// contiguous f32 on one device.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_relpos_f32(const void* q, const void* k,
                                          const void* v, const void* rel_h,
                                          const void* rel_w, void* out, int b,
                                          int n, int d, int kh, int kw,
                                          float scale, void* stream) {
  if (invalid(b, n, d, kh, kw)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, rel_h, rel_w, out, b, n, d, kh, kw, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 7) / 8) {
    case 1: return launch_design<1>(a, s);
    case 2: return launch_design<2>(a, s);
    case 3: return launch_design<3>(a, s);
    case 4: return launch_design<4>(a, s);
    case 5: return launch_design<5>(a, s);
    case 6: return launch_design<6>(a, s);
    case 7: return launch_design<7>(a, s);
    case 8: return launch_design<8>(a, s);
    case 9: return launch_design<9>(a, s);
    case 10: return launch_design<10>(a, s);
    case 11: return launch_design<11>(a, s);
    case 12: return launch_design<12>(a, s);
    case 13: return launch_design<13>(a, s);
    case 14: return launch_design<14>(a, s);
    case 15: return launch_design<15>(a, s);
    default: return launch_design<16>(a, s);
  }
}

// ---------------------------------------------------------------------------
// FLASH-RELPOS on bf16 operands (the ViT's compute_dtype = bfloat16 path).
//
// Replaces the same Pallas kernel, _attn_kernel, as JAX runs it on bf16
// q, k, v, rel_h and rel_w: the kernel upcasts every operand to f32, takes
// the logits, the bias rel_h[q, j / Kw] + rel_w[q, j % Kw], the online
// softmax, P and the output accumulator in f32, and rounds the output to
// bf16 once (out_shape q.dtype).
//
// What bounds it on an H100: operations.  4 N^2 D flops per (batch*head)
// at the dense bf16 rate (989 TFLOP/s): 0.087 ms at SAM ViT-H's global
// layers (N = 4096, D = 80, 16 heads), against 2 (4 N D + N (Kh + Kw))
// bytes (0.018 ms).  This design issues 6 N^2 D (P V twice, below):
// 0.130 ms there.
//
// Design (a simple kernel that is right, the f32 kernel's shape):
// - 4 warps a block, 16 query rows a warp, 64 queries and one batch*head a
//   block; the logits S, m, l and the output accumulator stay in
//   registers in the mma.m16n8k16 accumulator layout, so a row's max and
//   sum reduce over a quad.
// - S = q K^T by mma.sync.m16n8k16 .bf16 with f32 accumulators.  A product
//   of two bf16 values is exact in f32, so S is the Pallas kernel's f32 dot
//   up to summation order; the scale is applied to S in f32 and the f32
//   bias added (s = S scale + (rel_h + rel_w)).  q's fragments are loaded
//   once into registers (KD16 x 4 words, up to D = 96); K's by
//   ldmatrix.x4.
// - P V keeps P in f32: P = hi + lo, both bf16 (hi = bf16(P), lo =
//   bf16(P - hi), about 16 bits of P), two MMAs against V, which is exact
//   in bf16.  A single bf16 P would move the output by more than a bf16
//   ulp.  P's A fragments are the S registers of two 8-key blocks as they
//   are (no shuffle); V's B fragments come by ldmatrix.x4.trans from V's
//   row-major tile.
// - An asynchronous K/V ring of 2 stages of 64 keys: 16-byte cp.async.cg
//   runs of 8 bf16 (4-byte runs where D % 8 != 0 or a pointer is not
//   16-byte aligned, plain loads where D is odd), half the f32 kernel's
//   shared memory.  Rows are padded to D16 + 8 bf16 (a word stride of 4
//   mod 8), so 32-bit fragment reads and ldmatrix rows are free of bank
//   conflicts.  Rows past N and columns past D are zero-filled.
// - The bias: where Kw is the key tile (64, SAM's 64 x 64 token grid) each
//   lane keeps its 2 rows x 16 columns of rel_w in f32 registers and reads
//   2 values of rel_h a tile; otherwise the block writes each tile's
//   64 x 64 f32 bias into shared memory, as the f32 kernel does.  Keys
//   past N get -1e30.
// - The TPU kernel's semantics: m starts at -1e30, out = bf16(acc /
//   max(l, 1e-30)); expf, no --use_fast_math.
// - Later (PERF.md): wgmma from shared memory, TMA and warp
//   specialisation.
//
// Head dims 1..128 (templated on KD16 = ceil(D / 16)); any Kh * Kw == N,
// Kh + Kw <= 256 as the f32 entry point.

namespace {

constexpr int kBlockKB = 64;              // keys per tile

__device__ __forceinline__ float bf16_bits_to_float(unsigned short x) {
  return __uint_as_float((uint32_t)x << 16);
}

// two f32 -> one register of two bf16 (round to nearest even), a in the
// low half (the lower column of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b for one 16x8x16 bf16 tile of a warp, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

template <int KD16>
struct TilesB {
  static constexpr int kDP = 16 * KD16;               // padded head dim
  static constexpr int kStride = kDP + 8;             // bf16 a row: 4 mod 8 words
  static constexpr int kWarps = 4;
  static constexpr int kStages = 2;
  static constexpr int kBlockQ = 16 * kWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kPStride = kBlockKB + 4;       // f32 bias tile row
  static constexpr int kQElems = kBlockQ * kStride;
  static constexpr int kKVElems = kBlockKB * kStride;
  static constexpr size_t bytes(bool spec) {
    return (size_t)(kQElems + 2 * kStages * kKVElems) * 2 +
           (spec ? 0 : (size_t)kBlockQ * kPStride * sizeof(float));
  }
};

template <int KD16, bool SPEC>
__global__ void __launch_bounds__(128, 2)
flash_relpos_bf16_kernel(const unsigned short* __restrict__ q,
                         const unsigned short* __restrict__ k,
                         const unsigned short* __restrict__ v,
                         const unsigned short* __restrict__ rel_h,
                         const unsigned short* __restrict__ rel_w,
                         unsigned short* __restrict__ out, int n, int d, int kh, int kw,
                         float scale, int vec) {
  using T = TilesB<KD16>;
  constexpr int kND = 2 * KD16;                   // 8-dim output tiles
  extern __shared__ float4 smem4b[];
  unsigned short* qs = reinterpret_cast<unsigned short*>(smem4b);   // [kBlockQ][kStride]
  unsigned short* ks = qs + T::kQElems;           // kStages x [kBlockKB][kStride]
  unsigned short* vs = ks + T::kStages * T::kKVElems;
  float* bt = reinterpret_cast<float*>(vs + T::kStages * T::kKVElems);   // !SPEC

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * T::kBlockQ;
  const size_t base = (size_t)blockIdx.y * n * d;
  const int num_kt = (n + kBlockKB - 1) / kBlockKB;

  auto stage_kv = [&](int tile) {
    if (tile < num_kt) {
      stage_rows<unsigned short, kBlockKB, T::kDP, T::kStride, T::kThreads>(
          ks + (tile % T::kStages) * T::kKVElems, k + base, tile * kBlockKB, n, d, vec);
      stage_rows<unsigned short, kBlockKB, T::kDP, T::kStride, T::kThreads>(
          vs + (tile % T::kStages) * T::kKVElems, v + base, tile * kBlockKB, n, d, vec);
    }
  };

  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  const size_t rel_row = (size_t)blockIdx.y * n;
  const unsigned short* rh_lo = rel_h + (rel_row + min(i0 + r_lo, n - 1)) * kh;
  const unsigned short* rh_hi = rel_h + (rel_row + min(i0 + r_hi, n - 1)) * kh;

  float relw[SPEC ? 8 : 1][4];
  int h0 = 0, w0 = 0, q64 = 0, r64 = 0, cq = 0, cr = 0;
  if constexpr (SPEC) {
    const unsigned short* rw_lo = rel_w + (rel_row + min(i0 + r_lo, n - 1)) * kw;
    const unsigned short* rw_hi = rel_w + (rel_row + min(i0 + r_hi, n - 1)) * kw;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      relw[nt][0] = bf16_bits_to_float(__ldg(rw_lo + c));
      relw[nt][1] = bf16_bits_to_float(__ldg(rw_lo + c + 1));
      relw[nt][2] = bf16_bits_to_float(__ldg(rw_hi + c));
      relw[nt][3] = bf16_bits_to_float(__ldg(rw_hi + c + 1));
    }
  } else {
    const int c = threadIdx.x % kBlockKB;
    cq = c / kw;
    cr = c - cq * kw;
    q64 = kBlockKB / kw;
    r64 = kBlockKB - q64 * kw;
  }

  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  // q's A fragment of k-step kk (rows g, g + 8; dims 2t, 2t + 8 of the
  // step), kept in registers for the loop up to D = 96 and read from
  // shared memory per tile above (D = 128 would spill at 255 registers)
  constexpr bool kQRegs = KD16 <= 6;
  auto load_qf = [&](int kk, uint32_t (&a)[4]) {
    const unsigned short* lo = qs + r_lo * T::kStride + kk * 16 + 2 * t;
    const unsigned short* hi = qs + r_hi * T::kStride + kk * 16 + 2 * t;
    a[0] = *reinterpret_cast<const uint32_t*>(lo);
    a[1] = *reinterpret_cast<const uint32_t*>(hi);
    a[2] = *reinterpret_cast<const uint32_t*>(lo + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(hi + 8);
  };
  uint32_t qf[kQRegs ? KD16 : 1][4];

  // ldmatrix row addresses of this lane: K (non-transposed) x4 covers key
  // tiles nt, nt + 1 at one 16-dim k-step; V (transposed) x4 covers 16
  // keys at output tiles nd, nd + 1
  const int k_row = (lane >> 4) * 8 + (lane & 7), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = (lane >> 4) * 8;

  stage_rows<unsigned short, T::kBlockQ, T::kDP, T::kStride, T::kThreads>(qs, q + base, i0, n,
                                                                          d, vec);
  stage_kv(0);
  cp_async_commit();
  for (int tile = 0; tile < num_kt; ++tile) {
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (kQRegs) {
      if (tile == 0) {
#pragma unroll
        for (int kk = 0; kk < KD16; ++kk) load_qf(kk, qf[kk]);
      }
    }
    stage_kv(tile + 1);
    cp_async_commit();

    // the tile's f32 bias
    float bias[8][4];
    if constexpr (SPEC) {
      const float bh_lo = bf16_bits_to_float(__ldg(rh_lo + tile));
      const float bh_hi = bf16_bits_to_float(__ldg(rh_hi + tile));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        bias[nt][0] = bh_lo + relw[nt][0];
        bias[nt][1] = bh_lo + relw[nt][1];
        bias[nt][2] = bh_hi + relw[nt][2];
        bias[nt][3] = bh_hi + relw[nt][3];
      }
    } else {
      const int c = threadIdx.x % kBlockKB, j = tile * kBlockKB + c;
      int hh = h0 + cq, ww = w0 + cr;
      if (ww >= kw) {
        ww -= kw;
        ++hh;
      }
#pragma unroll 4
      for (int r = threadIdx.x / kBlockKB; r < T::kBlockQ; r += T::kThreads / kBlockKB) {
        const size_t row = rel_row + min(i0 + r, n - 1);
        bt[r * T::kPStride + c] =
            j < n ? bf16_bits_to_float(__ldg(rel_h + row * kh + hh)) +
                        bf16_bits_to_float(__ldg(rel_w + row * kw + ww))
                  : kNegInf;
      }
      h0 += q64;
      w0 += r64;
      if (w0 >= kw) {
        w0 -= kw;
        ++h0;
      }
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 lo = *reinterpret_cast<const float2*>(bt + r_lo * T::kPStride + nt * 8 + 2 * t);
        const float2 hi = *reinterpret_cast<const float2*>(bt + r_hi * T::kPStride + nt * 8 + 2 * t);
        bias[nt][0] = lo.x;
        bias[nt][1] = lo.y;
        bias[nt][2] = hi.x;
        bias[nt][3] = hi.y;
      }
    }

    // s = (q K^T) scale + bias
    const unsigned short* kt = ks + (tile % T::kStages) * T::kKVElems;
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD16; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        load_qf(kk, a);
      }
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (nt * 8 + k_row) * T::kStride + kk * 16 + k_col);
        mma_bf16(s[nt], a, b[0], b[1]);
        mma_bf16(s[nt + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = fmaf(s[nt][e], scale, bias[nt][e]);

    // the online softmax of the tile's logits
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float alpha_lo = expf(m_lo - mx_lo), alpha_hi = expf(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mx_lo);
      s[nt][1] = expf(s[nt][1] - mx_lo);
      s[nt][2] = expf(s[nt][2] - mx_hi);
      s[nt][3] = expf(s[nt][3] - mx_hi);
      sum_lo += s[nt][0] + s[nt][1];
      sum_hi += s[nt][2] + s[nt][3];
    }
    l_lo = alpha_lo * l_lo + sum_lo;
    l_hi = alpha_hi * l_hi + sum_hi;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      o[nd][0] *= alpha_lo;
      o[nd][1] *= alpha_lo;
      o[nd][2] *= alpha_hi;
      o[nd][3] *= alpha_hi;
    }

    // O += P V over 16-key steps, P = hi + lo in bf16: the A fragment of
    // keys 16 kb.. is the S registers of 8-key blocks 2 kb and 2 kb + 1
    const unsigned short* vt = vs + (tile % T::kStages) * T::kKVElems;
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // e: (row g, keys 2t..), (row g + 8, 2t..), (row g, 8 + 2t..), (row g + 8, 8 + 2t..)
        const float x = s[2 * kb + (e >> 1)][2 * (e & 1)];
        const float y = s[2 * kb + (e >> 1)][2 * (e & 1) + 1];
        ahi[e] = pack_bf16(x, y);
        alo[e] = pack_bf16(x - bf16_bits_to_float((unsigned short)(ahi[e] & 0xffffu)),
                           y - bf16_bits_to_float((unsigned short)(ahi[e] >> 16)));
      }
#pragma unroll
      for (int nd = 0; nd < kND; nd += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (kb * 16 + v_row) * T::kStride + nd * 8 + v_col);
        mma_bf16(o[nd], alo, b[0], b[1]);
        mma_bf16(o[nd + 1], alo, b[2], b[3]);
        mma_bf16(o[nd], ahi, b[0], b[1]);
        mma_bf16(o[nd + 1], ahi, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = i0 + (half ? r_hi : r_lo);
    if (row >= n) continue;
    const float den = half ? den_hi : den_lo;
    unsigned short* orow = out + base + (size_t)row * d;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (col < d) orow[col] = __bfloat16_as_ushort(__float2bfloat16_rn(o[nd][2 * half] / den));
      if (col + 1 < d)
        orow[col + 1] = __bfloat16_as_ushort(__float2bfloat16_rn(o[nd][2 * half + 1] / den));
    }
  }
}

template <int KD16, bool SPEC>
int launch_bf16(const Args& a, cudaStream_t stream) {
  using T = TilesB<KD16>;
  auto kernel = flash_relpos_bf16_kernel<KD16, SPEC>;
  constexpr size_t kBytes = T::bytes(SPEC);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + T::kBlockQ - 1) / T::kBlockQ, a.b);
  kernel<<<grid, T::kThreads, kBytes, stream>>>(
      reinterpret_cast<const unsigned short*>(a.q), reinterpret_cast<const unsigned short*>(a.k),
      reinterpret_cast<const unsigned short*>(a.v),
      reinterpret_cast<const unsigned short*>(a.rel_h),
      reinterpret_cast<const unsigned short*>(a.rel_w), reinterpret_cast<unsigned short*>(a.out),
      a.n, a.d, a.kh, a.kw, a.scale, a.vec);
  return (int)cudaGetLastError();
}

template <int KD16>
int launch_design_bf16(const Args& a, cudaStream_t stream) {
  return a.kw == kBlockKB ? launch_bf16<KD16, true>(a, stream)
                          : launch_bf16<KD16, false>(a, stream);
}

}  // namespace

// As flash_attention_relpos_f32, on bf16 q, k, v, rel_h, rel_w and out
// (f32 inside).  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_relpos_bf16(const void* q, const void* k,
                                           const void* v, const void* rel_h,
                                           const void* rel_w, void* out, int b,
                                           int n, int d, int kh, int kw,
                                           float scale, void* stream) {
  if (invalid(b, n, d, kh, kw)) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, rel_h, rel_w, out, b, n, d, kh, kw, scale);
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  a.vec = (d % 8 == 0 && (ptrs & 15u) == 0) ? 2 : (d % 2 == 0 && (ptrs & 3u) == 0) ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch_design_bf16<1>(a, s);
    case 2: return launch_design_bf16<2>(a, s);
    case 3: return launch_design_bf16<3>(a, s);
    case 4: return launch_design_bf16<4>(a, s);
    case 5: return launch_design_bf16<5>(a, s);
    case 6: return launch_design_bf16<6>(a, s);
    case 7: return launch_design_bf16<7>(a, s);
    default: return launch_design_bf16<8>(a, s);
  }
}

// ---------------------------------------------------------------------------
// FLASH-RELPOS-BF16 on Hopper's warpgroup MMA: SAM's global layers (a
// 64-wide token grid) on bf16 operands.
//
// Replaces the same Pallas kernel, samnerf_tpu/ops/attention_pallas.py
// _attn_kernel, on bf16 q, k, v, rel_h and rel_w, and computes what
// flash_relpos_bf16_kernel above computes: every operand upcast to f32,
// s = (q . k) scale + rel_h[q, j / 64] + rel_w[q, j % 64] in f32, the online
// softmax in f32 (m from -1e30), P V with P at f32 precision, out =
// bf16(acc / max(l, 1e-30)) rounded once.
//
// What bounds it on an H100: operations.  4 N^2 D flops per (batch*head)
// at the dense bf16 rate (989 TFLOP/s): 0.087 ms at SAM ViT-H's global
// layers (N = 4096, D = 80, 16 heads); its bytes, 2 (4 N D + N (Kh + Kw)),
// take 0.018 ms.  This design issues 6 N^2 D (P V twice, P = hi + lo):
// 0.130 ms there.  The mma.sync kernel above reaches 13-14 % of the bound:
// every HMMA needs its own ldmatrix, every thread computes cp.async
// addresses, and nothing overlaps its softmax with its products.
//
// Design:
// - Warp specialisation: 3 warpgroups a block, one batch*head and 128
//   query rows.  Warpgroup 0 is the producer: one thread issues every TMA
//   load, and the warpgroup gives its registers up (setmaxnreg 24).  The
//   two consumer warpgroups (setmaxnreg 240) own 64 query rows each,
//   wgmma's M.
// - Loads by TMA, completing on mbarriers: q once a block; K and V in a
//   ring of 4 stages of 64-key tiles (one row of the token grid), each
//   stage with a full barrier (the producer's expect_tx, the copies' bytes)
//   and an empty one (all 256 consumer threads arrive once both of their
//   products that read the stage have retired).  The tensor maps are 3-d
//   ([B, N, D], encoded on the host for every call, passed as
//   __grid_constant__), so no box reaches into the next head.
//   Boxes are 64 rows x 16 bf16 (32 bytes) with the 32-byte swizzle: a
//   160-byte ViT-H row is wider than the 128-byte swizzle span, so D is cut
//   into D16 / 16 boxes, one per 16-wide k-step, and head dims that are a
//   multiple of 8 but not of 16 read zeros past D.  cuTensorMapEncodeTiled,
//   a libcuda function, is reached through the CUDA runtime's entry-point
//   lookup, so the library links no libcuda.
// - S = q K^T by wgmma.m64n64k16 bf16 -> f32, both operands K-major in
//   shared memory, D16 / 16 k-steps.  A product of two bf16 values is exact
//   in f32, so S is the Pallas kernel's f32 dot up to summation order; the
//   scale and the f32 bias follow in f32.
// - The bias: wgmma's accumulator has mma.sync's layout within each warp
//   (rows g and g + 8, columns 2t and 2t + 1 of each 8-column group), so
//   each lane keeps its 2 rows x 16 columns of rel_w in f32 registers for
//   the whole loop (s = fmaf(S, scale, rel_w)).  rel_h is one value a row
//   on a tile (a grid row), so it is added to the row's max and to the
//   exponent's offset instead of to every logit, and read a tile ahead.
// - The softmax: row maxima and sums as trees over a lane's 16 values,
//   then over the quad; exp(x) as ex2.approx(x log2(e)), the log2(e)
//   folded into one FFMA with the offset (rel_h - m) log2(e).  Against
//   expf (about 8 instructions) this is the design's largest saving; its
//   relative error, about 1e-6 at logits of +-30, keeps the output within
//   one bf16 ulp of the plain version on peaky inputs (q scaled by 8),
//   which the card tests and chip_smoke.py hold.
// - O += P V by wgmma.m64nNk16 with A from registers: the f32 S registers
//   are the A fragments of two 8-key groups as they are (no shuffle).  P
//   = hi + lo, two bf16 parts, each multiplied with the same V tile (a
//   single bf16 P moves outputs by more than an ulp).  V's [keys, D] tile
//   is MN-major for the B operand (the transposed form, which bf16
//   allows); N = D16 is one n80 product at D = 80, else n64, n32 and n16
//   pieces.
// - Order: wgmma.fence before each group of products, commit, wait; O is
//   rescaled by alpha only after the previous P V group retired; the
//   compiler is kept from moving accumulator and fragment registers across
//   the asynchronous products by empty asm fences on them.  The two
//   consumer warpgroups run unsynchronised, so one's softmax overlaps the
//   other's products where the scheduler lets it.
// - Tried on the card and dropped, each no faster or slower (PERF.md):
//   the softmax of tile t behind the P V of tile t - 1 within a
//   warpgroup, FA3's ping-pong of the two warpgroups (named barriers), q's
//   fragments in registers, and 128-key tiles (a second S and P in flight;
//   slower, with no spill reported).
//
// Budget (ptxas, sm_90a, CUDA 12.9): 168 registers (the launch's share of
// 384 threads; setmaxnreg moves them to the consumers), no spills; shared
// memory (4 stages) 101 KB at D = 80, 81 KB at D = 64, 161 KB at D = 128.
//
// Takes Kw == 64 (a key tile is one grid row, so N % 64 == 0 and keys are
// never ragged), D % 8 == 0 with 8 <= D <= 128, and 16-byte aligned q, k
// and v (TMA's rule for addresses and strides); ops/attention.py
// bf16_route sends every other bf16 call to flash_relpos_bf16_kernel.
// Query tiles may be ragged (Kh odd): rows past N are computed on a
// clamped copy of the last rows and not stored.

#include <cuda.h>

namespace {

constexpr int kWgKeys = 64;                  // keys a tile: one row of the grid
constexpr int kWgRows = 64;                  // query rows a consumer warpgroup
constexpr int kWgConsumers = 2;
constexpr int kWgThreads = 128 * (1 + kWgConsumers);
constexpr int kWgStages = 4;
constexpr int kBox = kWgKeys * 32;           // bytes of a box: 64 rows x 16 bf16
constexpr int kSwizzleAtom = 8 * 32;         // 8 rows of 32 bytes: the B32 pattern

template <int KD16>
struct WgTiles {
  static constexpr int kQBytes = kWgConsumers * KD16 * kBox;
  static constexpr int kStageBytes = 2 * KD16 * kBox;        // K's boxes, then V's
  static constexpr int kBytes = kQBytes + kWgStages * kStageBytes + 1024;   // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box (16 columns x 64 rows of head `head`) of a [B, N, D] tensor map
// into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head)
      : "memory");
}

// A wgmma shared-memory descriptor, 32-byte swizzle (layout type 3):
// start address, leading and stride byte offsets, each in 16-byte units.
// K-major tiles (q, K): rows of 32 bytes, 8-row groups kSwizzleAtom apart
// (the stride offset; the leading one is unused).  MN-major V: the
// leading offset steps 16 columns (the next box), the stride offset 8 keys.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of these registers across
// an asynchronous product.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

#define WG_ACC(d, i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

// d (+)= A B for a 64 x 64 tile, k = 16; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[8][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC(d, 0), WG_ACC(d, 1), WG_ACC(d, 2), WG_ACC(d, 3), WG_ACC(d, 4), WG_ACC(d, 5),
        WG_ACC(d, 6), WG_ACC(d, 7)
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d += A B, A (64 x 16) from registers, B (16 x N) MN-major in shared
// memory; d: the N / 8 column groups of the accumulator
__device__ __forceinline__ void wgmma_pv64(float (*d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC(d, 0), WG_ACC(d, 1), WG_ACC(d, 2), WG_ACC(d, 3), WG_ACC(d, 4), WG_ACC(d, 5),
        WG_ACC(d, 6), WG_ACC(d, 7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_pv32(float (*d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_ACC(d, 0), WG_ACC(d, 1), WG_ACC(d, 2), WG_ACC(d, 3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_pv16(float (*d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : WG_ACC(d, 0), WG_ACC(d, 1)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_pv80(float (*d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : WG_ACC(d, 0), WG_ACC(d, 1), WG_ACC(d, 2), WG_ACC(d, 3), WG_ACC(d, 4), WG_ACC(d, 5),
        WG_ACC(d, 6), WG_ACC(d, 7), WG_ACC(d, 8), WG_ACC(d, 9)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

#undef WG_ACC

// o += a V for one 16-key step: V's 16 rows start at v16 (two 8-key
// groups); its D16 columns are KD16 boxes kBox apart, one n80 product for
// ViT-H's head (faster than n64 + n16 in turns, PERF.md), else n64, n32
// and n16 pieces
template <int KD16>
__device__ __forceinline__ void wgmma_pv(float (&o)[2 * KD16][4], const uint32_t (&a)[4],
                                         uint32_t v16) {
  if constexpr (KD16 == 5) {
    wgmma_pv80(&o[0], a, wg_desc(v16, kBox, kSwizzleAtom));
  } else {
    constexpr int kN64 = KD16 / 4, kRest = KD16 % 4;
#pragma unroll
    for (int p = 0; p < kN64; ++p)
      wgmma_pv64(&o[8 * p], a, wg_desc(v16 + 4 * p * kBox, kBox, kSwizzleAtom));
    if constexpr (kRest >= 2)
      wgmma_pv32(&o[8 * kN64], a, wg_desc(v16 + 4 * kN64 * kBox, kBox, kSwizzleAtom));
    if constexpr (kRest % 2 == 1) {
      constexpr int kBoxIdx = 4 * kN64 + (kRest >= 2 ? 2 : 0);
      wgmma_pv16(&o[2 * kBoxIdx], a, wg_desc(v16 + kBoxIdx * kBox, kBox, kSwizzleAtom));
    }
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx, flushing results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wait until every committed group of this warpgroup has retired
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// KD16: head dim in 16-wide k-steps (boxes).
template <int KD16>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_relpos_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const unsigned short* __restrict__ rel_h,
                               const unsigned short* __restrict__ rel_w,
                               unsigned short* __restrict__ out, int n, int d, int kh,
                               float scale) {
  using T = WgTiles<KD16>;
  constexpr int kND = 2 * KD16;                   // 8-column output groups
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kWgStages];   // q, full[], empty[]
  // the swizzle pattern repeats every kSwizzleAtom bytes: align the tiles
  const uint32_t q_s = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + T::kQBytes;
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]), empty0 = smem_u32(&bars[1 + kWgStages]);
  const int head = blockIdx.y, i0 = blockIdx.x * (kWgConsumers * kWgRows);
  const int num_kt = n / kWgKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int w = 0; w < kWgConsumers; ++w) {
        // a warpgroup wholly past N (Kh odd) reads the last rows again
        const int row = min(i0 + w * kWgRows, n - kWgRows);
        for (int c = 0; c < KD16; ++c)
          tma_load(q_s + (w * KD16 + c) * kBox, &tq, q_full, 16 * c, row, head);
      }
      for (int tile = 0; tile < num_kt; ++tile) {
        const int s = tile % kWgStages;
        mbar_wait(empty0 + 8 * s, ((tile / kWgStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, T::kStageBytes);
        const uint32_t ks = kv_s + s * T::kStageBytes, vs = ks + KD16 * kBox;
        for (int c = 0; c < KD16; ++c) {
          tma_load(ks + c * kBox, &tk, full0 + 8 * s, 16 * c, tile * kWgKeys, head);
          tma_load(vs + c * kBox, &tv, full0 + 8 * s, 16 * c, tile * kWgKeys, head);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1, ctid = threadIdx.x - 128 * wg;
    const int warp = ctid >> 5, lane = ctid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = i0 + cw * kWgRows + warp * 16 + g, r_hi = r_lo + 8;
    const size_t rel_row = (size_t)head * n;
    const unsigned short* rh_lo = rel_h + (rel_row + min(r_lo, n - 1)) * kh;
    const unsigned short* rh_hi = rel_h + (rel_row + min(r_hi, n - 1)) * kh;
    float relw[8][4];
    {
      const unsigned short* rw_lo = rel_w + (rel_row + min(r_lo, n - 1)) * kWgKeys;
      const unsigned short* rw_hi = rel_w + (rel_row + min(r_hi, n - 1)) * kWgKeys;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = nt * 8 + 2 * t;
        relw[nt][0] = bf16_bits_to_float(__ldg(rw_lo + c));
        relw[nt][1] = bf16_bits_to_float(__ldg(rw_lo + c + 1));
        relw[nt][2] = bf16_bits_to_float(__ldg(rw_hi + c));
        relw[nt][3] = bf16_bits_to_float(__ldg(rw_hi + c + 1));
      }
    }
    float o[kND][4], s[8][4];
#pragma unroll
    for (int nd = 0; nd < kND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    uint32_t ahi[4][4], alo[4][4];
    float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
    float alpha_lo = 0.f, alpha_hi = 0.f;
    // rel_h of the next tile (grid row), loaded a tile ahead
    float bh_lo = bf16_bits_to_float(__ldg(rh_lo)), bh_hi = bf16_bits_to_float(__ldg(rh_hi));
    const uint32_t qw = q_s + cw * KD16 * kBox;
    auto stage_k = [&](int tile) { return kv_s + (tile % kWgStages) * T::kStageBytes; };

    // S = q K^T of a tile, one commit group
    auto issue_qk = [&](int tile) {
      const uint32_t ks = stage_k(tile);
      reg_fence(s);
      wg_fence();
#pragma unroll
      for (int c = 0; c < KD16; ++c)
        wgmma_qk(s, wg_desc(qw + c * kBox, 16, kSwizzleAtom),
                 wg_desc(ks + c * kBox, 16, kSwizzleAtom), c > 0);
      wg_commit();
    };
    // O += P V of a tile (P in ahi, alo), one commit group
    auto issue_pv = [&](int tile) {
      const uint32_t vs = stage_k(tile) + KD16 * kBox;
      reg_fence(o);
      reg_fence(ahi);
      reg_fence(alo);
      wg_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        const uint32_t v16 = vs + kb * 2 * kSwizzleAtom;
        wgmma_pv<KD16>(o, alo[kb], v16);
        wgmma_pv<KD16>(o, ahi[kb], v16);
      }
      wg_commit();
    };
    // s = S scale + bias and the tile's online softmax in place: s becomes
    // P (f32), m and l advance, alpha is the factor O still owes
    auto softmax = [&](int tile) {
      const float b_lo = bh_lo, b_hi = bh_hi;
      if (tile + 1 < num_kt) {
        bh_lo = bf16_bits_to_float(__ldg(rh_lo + tile + 1));
        bh_hi = bf16_bits_to_float(__ldg(rh_hi + tile + 1));
      }
      // s = S scale + rel_w; rel_h is one value a row on the tile, so it
      // joins the row's max and the exponent's offset
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = fmaf(s[nt][0], scale, relw[nt][0]);
        s[nt][1] = fmaf(s[nt][1], scale, relw[nt][1]);
        s[nt][2] = fmaf(s[nt][2], scale, relw[nt][2]);
        s[nt][3] = fmaf(s[nt][3], scale, relw[nt][3]);
      }
      // row maxima as trees (short dependency chains)
      float x_lo[8], x_hi[8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        x_lo[nt] = fmaxf(s[nt][0], s[nt][1]);
        x_hi[nt] = fmaxf(s[nt][2], s[nt][3]);
      }
#pragma unroll
      for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
        for (int i = 0; i < w; ++i) {
          x_lo[i] = fmaxf(x_lo[i], x_lo[i + w]);
          x_hi[i] = fmaxf(x_hi[i], x_hi[i + w]);
        }
      float mx_lo = fmaxf(m_lo, x_lo[0] + b_lo), mx_hi = fmaxf(m_hi, x_hi[0] + b_hi);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      alpha_lo = ex2((m_lo - mx_lo) * kLog2e);
      alpha_hi = ex2((m_hi - mx_hi) * kLog2e);
      m_lo = mx_lo;
      m_hi = mx_hi;
      // exp(s + rel_h - m) = 2^(s log2(e) + (rel_h - m) log2(e)), one FFMA
      // and one ex2
      const float ml_lo = (b_lo - mx_lo) * kLog2e, ml_hi = (b_hi - mx_hi) * kLog2e;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = ex2(fmaf(s[nt][0], kLog2e, ml_lo));
        s[nt][1] = ex2(fmaf(s[nt][1], kLog2e, ml_lo));
        s[nt][2] = ex2(fmaf(s[nt][2], kLog2e, ml_hi));
        s[nt][3] = ex2(fmaf(s[nt][3], kLog2e, ml_hi));
        x_lo[nt] = s[nt][0] + s[nt][1];
        x_hi[nt] = s[nt][2] + s[nt][3];
      }
#pragma unroll
      for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
        for (int i = 0; i < w; ++i) {
          x_lo[i] += x_lo[i + w];
          x_hi[i] += x_hi[i + w];
        }
      l_lo = fmaf(alpha_lo, l_lo, x_lo[0]);   // this lane's columns; quad sum at the end
      l_hi = fmaf(alpha_hi, l_hi, x_hi[0]);
    };
    auto rescale = [&]() {
#pragma unroll
      for (int nd = 0; nd < kND; ++nd) {
        o[nd][0] *= alpha_lo;
        o[nd][1] *= alpha_lo;
        o[nd][2] *= alpha_hi;
        o[nd][3] *= alpha_hi;
      }
    };
    // P = hi + lo in bf16; the A fragment of keys 16 kb.. is the S
    // registers of 8-key groups 2 kb and 2 kb + 1
    auto make_p = [&]() {
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[2 * kb + (e >> 1)][2 * (e & 1)];
          const float y = s[2 * kb + (e >> 1)][2 * (e & 1) + 1];
          ahi[kb][e] = pack_bf16(x, y);
          alo[kb][e] = pack_bf16(x - bf16_bits_to_float((unsigned short)(ahi[kb][e] & 0xffffu)),
                                 y - bf16_bits_to_float((unsigned short)(ahi[kb][e] >> 16)));
        }
    };
    mbar_wait(q_full, 0);
    for (int tile = 0; tile < num_kt; ++tile) {
      mbar_wait(full0 + 8 * (tile % kWgStages), (tile / kWgStages) & 1);
      issue_qk(tile);
      wg_wait_all();
      reg_fence(s);
      softmax(tile);
      rescale();
      make_p();
      issue_pv(tile);
      wg_wait_all();
      reg_fence(o);
      mbar_arrive(empty0 + 8 * (tile % kWgStages));   // both products that read it retired
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? r_hi : r_lo;
      if (row >= n) continue;
      const float den = half ? den_hi : den_lo;
      unsigned short* orow = out + ((size_t)head * n + row) * d;
#pragma unroll
      for (int nd = 0; nd < kND; ++nd) {
        const int col = nd * 8 + 2 * t;          // d % 8 == 0: col < d covers col + 1
        if (col < d)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(o[nd][2 * half] / den, o[nd][2 * half + 1] / den);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the [b, n, d] bf16 tensor at ptr as a 3-d map of 16 x 64 x 1 boxes, 32-byte
// swizzle, zeros past its bounds
cudaError_t encode_map(CUtensorMap* map, const void* ptr, int b, int n, int d) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {16, (cuuint32_t)kWgKeys, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int KD16>
int launch_bf16_wgmma(const Args& a, cudaStream_t stream) {
  using T = WgTiles<KD16>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_map(&tq, a.q, a.b, a.n, a.d);
  if (err == cudaSuccess) err = encode_map(&tk, a.k, a.b, a.n, a.d);
  if (err == cudaSuccess) err = encode_map(&tv, a.v, a.b, a.n, a.d);
  if (err != cudaSuccess) return (int)err;
  auto kernel = flash_relpos_bf16_wgmma_kernel<KD16>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + kWgConsumers * kWgRows - 1) / (kWgConsumers * kWgRows), a.b);
  kernel<<<grid, kWgThreads, T::kBytes, stream>>>(
      tq, tk, tv, reinterpret_cast<const unsigned short*>(a.rel_h),
      reinterpret_cast<const unsigned short*>(a.rel_w), reinterpret_cast<unsigned short*>(a.out),
      a.n, a.d, a.kh, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// As flash_attention_relpos_bf16, for kw == 64, d % 8 == 0 and 16-byte
// aligned q, k, v (cudaErrorInvalidValue otherwise).  Returns a
// cudaError_t (0 on success).
extern "C" int flash_attention_relpos_bf16_wgmma(const void* q, const void* k,
                                                 const void* v, const void* rel_h,
                                                 const void* rel_w, void* out, int b,
                                                 int n, int d, int kh, int kw,
                                                 float scale, void* stream) {
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  if (invalid(b, n, d, kh, kw) || kw != kWgKeys || d % 8 != 0 || (ptrs & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, rel_h, rel_w, out, b, n, d, kh, kw, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch_bf16_wgmma<1>(a, s);
    case 2: return launch_bf16_wgmma<2>(a, s);
    case 3: return launch_bf16_wgmma<3>(a, s);
    case 4: return launch_bf16_wgmma<4>(a, s);
    case 5: return launch_bf16_wgmma<5>(a, s);
    case 6: return launch_bf16_wgmma<6>(a, s);
    case 7: return launch_bf16_wgmma<7>(a, s);
    default: return launch_bf16_wgmma<8>(a, s);
  }
}
