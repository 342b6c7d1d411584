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

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
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

// Rows [row0, row0 + R) of src [n, d] into dst [R][STRIDE] (DP columns),
// by cp.async; rows past n and columns past d are zero-filled.  vec: 16
// bytes a copy (d % 4 == 0, aligned pointers); where also d == DP the
// rows are one contiguous run of chunks.
template <int R, int DP, int STRIDE, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int row0, int n, int d, bool vec) {
  if (vec && d == DP) {
    constexpr int kChunks = DP / 4;
    const float* run = src + (size_t)row0 * d;
    const int live = min(R, n - row0) * kChunks;
#pragma unroll 4
    for (int e = threadIdx.x; e < R * kChunks; e += THREADS) {
      const int r = e / kChunks, c = (e - r * kChunks) * 4;
      cp_async16(dst + r * STRIDE + c, e < live ? run + 4 * e : src, e < live);
    }
  } else if (vec) {
    constexpr int kChunks = DP / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < R * kChunks; e += THREADS) {
      const int r = e / kChunks, c = (e - r * kChunks) * 4;
      const bool valid = row0 + r < n && c < d;
      cp_async16(dst + r * STRIDE + c, valid ? src + (size_t)(row0 + r) * d + c : src, valid);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < R * DP; e += THREADS) {
      const int r = e / DP, c = e - r * DP;
      const bool valid = row0 + r < n && c < d;
      cp_async4(dst + r * STRIDE + c, valid ? src + (size_t)(row0 + r) * d + c : src, valid);
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
      stage_rows<kBlockK, T::kDP, T::kStride, T::kThreads>(
          ks + (tile % T::kStages) * T::kKFloats, kb, tile * kBlockK, n, d, vec);
      stage_rows<kBlockK, T::kDP, T::kVStride, T::kThreads>(
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

  stage_rows<T::kBlockQ, T::kDP, T::kStride, T::kThreads>(qs, qb, i0, n, d, vec);
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
              b, n, d, kh, kw, scale, (d % 4 == 0 && aligned) ? 1 : 0};
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
