// Parity-partitioned multiresolution hash encode and its table gradient,
// for sm_90a.
//
// Replaces the TPU Pallas kernels of samnerf_tpu/ops/hash_pallas.py:
//   F32-ENC      _fwd_kernel (v1), _fwd_kernel_v2, _fwd_kernel_v4
//   Q-ENC        _fwd_kernel_q8 (qbits 8 and 4), _fwd_kernel_q8v4
//   F32-ENC-BWD  _bwd_kernel (v1), _bwd_kernel_v2, _bwd_kernel_v4
//   FUSED-QMLP   _fwd_kernel_qmlp (qbits 8 and 4)
// Those kernels scan table slabs, and the backward ones scatter through
// one-hot matmuls, because the TPU has no vector gather or scatter; on
// Hopper every corner is one direct gather of row 8*hi+s, lane lo, and
// every gradient contribution one atomic add there.
//
// What bounds it on an H100: bytes.  Each (point, pack*level) output pair
// does 8 random 8-byte (f32 pair) or 4-byte (packed word) gathers and
// about 200 integer/float operations, far below the compute lines; the
// gathers are the cost.  Design: one thread per (point, pack*level), a
// grid-stride loop, no shared memory.  Consecutive threads take
// consecutive levels of one point, so the position loads broadcast and
// the two output stores of a warp fall in a few 32-byte sectors.  The
// f32 masters are rounded to bf16 in registers (__float2bfloat16_rn),
// which equals the reference's table.astype(bf16) without a per-frame
// pack pass over the table.
//
// F32-ENC-BWD is bound by its atomics: per (point, pack*level) 8 random
// 8-byte read-modify-writes in L2 against about 200 integer/float
// operations.  Same thread layout as the forward; the index math is the
// forward's own point_level / corner, so a gradient cannot land on
// another row than the value it came from.  A (point, level) whose two
// cotangents are both 0 adds nothing and is skipped, which is exact and
// removes the hot spot of points outside the unit cube, all moved to the
// origin.  Sums stay in f32 and are not rounded to bf16 (the JAX CPU
// reference rounds the accumulated gradient; the TPU v2 kernel rounds each
// product): tests hold the two at rtol 1e-2 / atol 1e-4.  Atomics add in
// an order that changes from run to run.
//
// FUSED-QMLP computes relu(enc @ w1 + b1) @ w2 + b2 for the serve heads,
// enc the Q-ENC features of 1-4 stacked pyramids, without writing enc
// or the hidden layer to device memory.  Its bound is the larger of the
// bytes (positions, output, touched table words) over 3.35 TB/s and the
// f32 operations (the MLP's 2 N (C H + H O) and the encode's
// multiply-adds) over 67 TFLOP/s; at the SAM head (N 262,144, C 192,
// H 256, O 256) the operations, 60.9 GFLOP, 0.91 ms.  Design: one block per tile of points, sized so the tile's enc and
// h rows fit 64 KB of shared memory (32 points at the SAM head, dynamic
// shared memory above 48 KB).  Phase 1 is Q-ENC's own gather and
// dequantization (q_encode_pair), written at the public channel; the
// two dense layers run in f32 FMAs on the CUDA cores, a thread taking
// one output column of 8 points, x read from shared memory as float4,
// the weights through the read-only cache (w1 is 192 KB at the SAM head:
// it stays in L2).  The TPU kernel's touched-slab skip, acc2 row merge
// and w1 column permutation serve its VMEM and sublane rules and have no
// counterpart.  Tensor cores (TF32 or bf16) would change the numerics
// against the f32 reference and are left for later.
//
// Index math follows _corner_index_math / _morton_mix bit for bit: every
// product that feeds floor() or a morton bit is a rounded f32 product
// (__fmul_rn), so FMA contraction cannot move a cell boundary.  Build
// without --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kLanes = 128;
constexpr int kParities = 8;

struct Plan {
  int num_levels;
  int num_packed;
  int num_steps;    // f32 class capacity is num_steps * 128 entries
  int table_bits;   // log2(num_steps * 128)
  int key_bits;     // 0: primes-XOR hash; else morton key width
  int rows;         // rows per (pack, level) in the table given
  float scale[kMaxLevels];
  float inv[kMaxLevels];   // f32 1 / max(scale, 1), for the morton key
  int dense[kMaxLevels];
  int half[kMaxLevels];
};

__device__ __forceinline__ uint32_t morton_mix(uint32_t h, int cx, int cy,
                                               int cz, float inv,
                                               const Plan& p) {
  const float u[3] = {__fmul_rn((float)cx, inv), __fmul_rn((float)cy, inv),
                      __fmul_rn((float)cz, inv)};
  uint32_t key = 0u;
  for (int b = 0; b < p.key_bits; ++b) {
    const float v = __fmul_rn(u[b % 3], (float)(1 << (b / 3)));
    key = (key << 1) | (__fsub_rn(v, floorf(v)) >= 0.5f ? 1u : 0u);
  }
  const int low = p.table_bits - p.key_bits;
  return (key << low) | (h & ((1u << low) - 1u));
}

// Class entry e = hi * 128 + lo of the corner with parity s, and its
// trilinear weight.
struct Corner {
  uint32_t entry;
  float w;
};

struct PointLevel {
  int ix, iy, iz;
  float ox, oy, oz;
};

__device__ __forceinline__ PointLevel point_level(const float* pos,
                                                  long long pt, float scale) {
  PointLevel q;
  const float sx = __fmul_rn(pos[3 * pt + 0], scale);
  const float sy = __fmul_rn(pos[3 * pt + 1], scale);
  const float sz = __fmul_rn(pos[3 * pt + 2], scale);
  const float fx = floorf(sx), fy = floorf(sy), fz = floorf(sz);
  q.ox = __fsub_rn(sx, fx);
  q.oy = __fsub_rn(sy, fy);
  q.oz = __fsub_rn(sz, fz);
  q.ix = (int)fx;
  q.iy = (int)fy;
  q.iz = (int)fz;
  return q;
}

__device__ __forceinline__ Corner corner(const PointLevel& q, int s, int l,
                                         const Plan& p) {
  const int ex = (q.ix & 1) ^ (s & 1);
  const int ey = (q.iy & 1) ^ ((s >> 1) & 1);
  const int ez = (q.iz & 1) ^ ((s >> 2) & 1);
  const int cx = q.ix + ex, cy = q.iy + ey, cz = q.iz + ez;
  const float wx = ex ? q.ox : __fsub_rn(1.0f, q.ox);
  const float wy = ey ? q.oy : __fsub_rn(1.0f, q.oy);
  const float wz = ez ? q.oz : __fsub_rn(1.0f, q.oz);
  uint32_t idx;
  if (p.dense[l]) {
    const uint32_t h = (uint32_t)p.half[l];
    idx = (uint32_t)(cx >> 1) +
          h * ((uint32_t)(cy >> 1) + h * (uint32_t)(cz >> 1));
  } else {
    idx = ((uint32_t)cx * 1u) ^ ((uint32_t)cy * 2654435761u) ^
          ((uint32_t)cz * 805459861u);
    if (p.key_bits) idx = morton_mix(idx, cx, cy, cz, p.inv[l], p);
  }
  Corner c;
  const uint32_t lo = idx & (kLanes - 1u);
  const uint32_t hi = (idx >> 7) & (uint32_t)(p.num_steps - 1);
  c.entry = hi * kLanes + lo;
  c.w = __fmul_rn(__fmul_rn(wx, wy), wz);
  return c;
}

__global__ void f32_encode_kernel(const float2* __restrict__ table,
                                  const float* __restrict__ pos,
                                  float* __restrict__ out, long long n,
                                  const Plan p) {
  const int L = p.num_levels;
  const int PL = p.num_packed * L;
  const long long total = n * PL;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long pt = t / PL;
    const int pl = (int)(t - pt * PL);
    const int pk = pl / L, l = pl - pk * L;
    const PointLevel q = point_level(pos, pt, p.scale[l]);
    const float2* tab = table + (long long)pl * p.rows * kLanes;
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int s = 0; s < kParities; ++s) {
      const Corner c = corner(q, s, l, p);
      const uint32_t hi = c.entry >> 7, lo = c.entry & (kLanes - 1u);
      const float2 v = __ldg(tab + ((long long)(kParities * hi + s) * kLanes + lo));
      const float v0 = __bfloat162float(__float2bfloat16_rn(v.x));
      const float v1 = __bfloat162float(__float2bfloat16_rn(v.y));
      a0 = __fadd_rn(a0, __fmul_rn(v0, c.w));
      a1 = __fadd_rn(a1, __fmul_rn(v1, c.w));
    }
    float* o = out + pt * (2LL * PL);
    o[(2 * pk) * L + l] = a0;
    o[(2 * pk + 1) * L + l] = a1;
  }
}

// The dequantized, trilinearly weighted feature pair of level l of one
// point from the packed (pack, level) row ``tab`` with scale ``qs``:
// Q-ENC's arithmetic, shared by q_encode_kernel and qmlp_kernel.
template <int QBITS>
__device__ __forceinline__ float2 q_encode_pair(const uint32_t* __restrict__ tab,
                                                float qs, const PointLevel& q,
                                                int l, const Plan& p) {
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int s = 0; s < kParities; ++s) {
    const Corner c = corner(q, s, l, p);
    const uint32_t e = c.entry;
    int v0, v1;
    if (QBITS == 8) {
      // two entries per word: byte 8*(2*(e&1)+f)
      const uint32_t word =
          __ldg(tab + ((long long)(e >> 8) * kParities + s) * kLanes + ((e >> 1) & 127u));
      const uint32_t sh = 16u * (e & 1u);
      v0 = (int)(int8_t)((word >> sh) & 0xFFu);
      v1 = (int)(int8_t)((word >> (sh + 8u)) & 0xFFu);
    } else {
      // four entries per word: nibble 8*(e&3)+4f
      const uint32_t word =
          __ldg(tab + ((long long)(e >> 9) * kParities + s) * kLanes + ((e >> 2) & 127u));
      const uint32_t sh = 8u * (e & 3u);
      v0 = (int)(((word >> sh) & 0xFu) ^ 0x8u) - 8;
      v1 = (int)(((word >> (sh + 4u)) & 0xFu) ^ 0x8u) - 8;
    }
    a0 = __fadd_rn(a0, __fmul_rn(__fmul_rn((float)v0, qs), c.w));
    a1 = __fadd_rn(a1, __fmul_rn(__fmul_rn((float)v1, qs), c.w));
  }
  return make_float2(a0, a1);
}

template <int QBITS>
__global__ void q_encode_kernel(const uint32_t* __restrict__ packed,
                                const float* __restrict__ qscales,
                                const float* __restrict__ pos,
                                float* __restrict__ out, long long n,
                                const Plan p) {
  const int L = p.num_levels;
  const int PL = p.num_packed * L;
  const long long total = n * PL;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long pt = t / PL;
    const int pl = (int)(t - pt * PL);
    const int pk = pl / L, l = pl - pk * L;
    const PointLevel q = point_level(pos, pt, p.scale[l]);
    const float2 v = q_encode_pair<QBITS>(packed + (long long)pl * p.rows * kLanes,
                                          qscales[pl], q, l, p);
    float* o = out + pt * (2LL * PL);
    o[(2 * pk) * L + l] = v.x;
    o[(2 * pk + 1) * L + l] = v.y;
  }
}

// --- FUSED-QMLP: quantized encode of 1-4 stacked pyramids + a 1-hidden-layer MLP

constexpr int kMaxPyramids = 4;
constexpr int kQmlpThreads = 256;
constexpr int kQmlpRows = 8;              // points per thread in the MLP layers
constexpr int kQmlpSmemTarget = 64 * 1024;
constexpr int kMaxSmem = 232448;          // what one H100 block may use

struct QmlpArgs {
  int num_pyramids;
  int rows;             // stacked (pack, level) rows: sum of P_i * L_i
  int channels;         // C = 2 * rows, the MLP's input width
  int hidden, out_dim;  // H, O
  int c_stride, h_stride;   // shared-memory row strides: C, H rounded up to 4
  int tile;             // points per block
  int row_off[kMaxPyramids + 1];
  const uint32_t* packed[kMaxPyramids];
  const float* qscales[kMaxPyramids];
  Plan plan[kMaxPyramids];
};

// One dense layer over the block's tile: y[i][j] = x[i] . w[:, j] + b[j],
// x rows in shared memory (stride x_stride, zero-padded to it, read as
// float4), w [in_dim, out_dim] and b through the read-only cache.  A
// thread takes output column j of kQmlpRows consecutive points, so a
// warp reads one w row coalesced and broadcasts each x element.  HIDDEN:
// ReLU into shared memory (stride y_stride); else the output rows of the
// points below n go to global memory.
template <bool HIDDEN>
__device__ __forceinline__ void dense_tile(const float* x, int x_stride,
                                           int in_dim,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b,
                                           int out_dim, int tile, float* y,
                                           int y_stride, long long base,
                                           long long n) {
  const int groups = tile / kQmlpRows;
  for (int t = threadIdx.x; t < groups * out_dim; t += blockDim.x) {
    const int g = t / out_dim, j = t - g * out_dim;
    const float* xg = x + g * kQmlpRows * x_stride;
    float acc[kQmlpRows];
#pragma unroll
    for (int r = 0; r < kQmlpRows; ++r) acc[r] = 0.0f;
    for (int c = 0; c < in_dim; c += 4) {
      float wc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wc[k] = c + k < in_dim ? __ldg(w + (long long)(c + k) * out_dim + j) : 0.0f;
#pragma unroll
      for (int r = 0; r < kQmlpRows; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(xg + r * x_stride + c);
        acc[r] = fmaf(v.x, wc[0], acc[r]);
        acc[r] = fmaf(v.y, wc[1], acc[r]);
        acc[r] = fmaf(v.z, wc[2], acc[r]);
        acc[r] = fmaf(v.w, wc[3], acc[r]);
      }
    }
    const float bj = __ldg(b + j);
#pragma unroll
    for (int r = 0; r < kQmlpRows; ++r) {
      const int i = g * kQmlpRows + r;
      if (HIDDEN) {
        y[i * y_stride + j] = fmaxf(acc[r] + bj, 0.0f);
      } else if (base + i < n) {
        y[(base + i) * out_dim + j] = acc[r] + bj;
      }
    }
  }
}

// Zero columns [from, stride) of a [tile, stride] shared-memory matrix.
__device__ __forceinline__ void zero_pad_columns(float* m, int tile, int from,
                                                 int stride) {
  const int pad = stride - from;
  for (int t = threadIdx.x; t < tile * pad; t += blockDim.x)
    m[(t / pad) * stride + from + t % pad] = 0.0f;
}

// One block per tile of a.tile points.  Phase 1: threads over (point,
// stacked row) write the feature pair of each (pack, level) at its public
// channel (p*2+f)*L_i + l, offset by the earlier pyramids' channels, so w1
// needs no permutation.  Phase 2: h = relu(enc @ w1 + b1) in shared
// memory.  Phase 3: out = h @ w2 + b2, the ragged last tile masked.
template <int QBITS>
__global__ void __launch_bounds__(kQmlpThreads)
qmlp_kernel(const float* __restrict__ pos, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, float* __restrict__ out, long long n,
            const QmlpArgs a) {
  extern __shared__ float4 smem4[];
  float* enc = reinterpret_cast<float*>(smem4);    // [tile, c_stride]
  float* hid = enc + a.tile * a.c_stride;          // [tile, h_stride]
  const long long base = (long long)blockIdx.x * a.tile;
  for (int t = threadIdx.x; t < a.tile * a.rows; t += blockDim.x) {
    const int i = t / a.rows, r = t - i * a.rows;
    int py = 0;
    while (r >= a.row_off[py + 1]) ++py;
    const Plan& p = a.plan[py];
    const int pl = r - a.row_off[py];
    const int pk = pl / p.num_levels, l = pl - pk * p.num_levels;
    float2 v = make_float2(0.0f, 0.0f);
    if (base + i < n) {
      const PointLevel q = point_level(pos, base + i, p.scale[l]);
      v = q_encode_pair<QBITS>(a.packed[py] + (long long)pl * p.rows * kLanes,
                               a.qscales[py][pl], q, l, p);
    }
    float* e = enc + i * a.c_stride + 2 * a.row_off[py];
    e[(2 * pk) * p.num_levels + l] = v.x;
    e[(2 * pk + 1) * p.num_levels + l] = v.y;
  }
  zero_pad_columns(enc, a.tile, a.channels, a.c_stride);
  zero_pad_columns(hid, a.tile, a.hidden, a.h_stride);
  __syncthreads();
  dense_tile<true>(enc, a.c_stride, a.channels, w1, b1, a.hidden, a.tile, hid,
                   a.h_stride, base, n);
  __syncthreads();
  dense_tile<false>(hid, a.h_stride, a.hidden, w2, b2, a.out_dim, a.tile, out,
                    0, base, n);
}

// Add 2 floats at *dst.  sm_90 has 8-byte float2 atomics on global
// memory from CUDA 12.1; older toolkits take two 4-byte ones.
__device__ __forceinline__ void atomic_add2(float2* dst, float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(dst, make_float2(a, b));
#else
  atomicAdd(&dst->x, a);
  atomicAdd(&dst->y, b);
#endif
}

__global__ void f32_encode_bwd_kernel(const float* __restrict__ pos,
                                      const float* __restrict__ gout,
                                      float2* __restrict__ grad, long long n,
                                      const Plan p) {
  const int L = p.num_levels;
  const int PL = p.num_packed * L;
  const long long total = n * PL;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long pt = t / PL;
    const int pl = (int)(t - pt * PL);
    const int pk = pl / L, l = pl - pk * L;
    const float* g = gout + pt * (2LL * PL);
    const float g0 = g[(2 * pk) * L + l];
    const float g1 = g[(2 * pk + 1) * L + l];
    if (g0 == 0.0f && g1 == 0.0f) continue;
    const PointLevel q = point_level(pos, pt, p.scale[l]);
    float2* tab = grad + (long long)pl * p.rows * kLanes;
#pragma unroll
    for (int s = 0; s < kParities; ++s) {
      const Corner c = corner(q, s, l, p);
      const uint32_t hi = c.entry >> 7, lo = c.entry & (kLanes - 1u);
      atomic_add2(tab + ((long long)(kParities * hi + s) * kLanes + lo),
                  __fmul_rn(g0, c.w), __fmul_rn(g1, c.w));
    }
  }
}

int make_plan(Plan* p, int num_levels, int num_packed, int num_steps,
              int table_bits, int key_bits, int rows, const float* scale,
              const float* inv, const int* dense, const int* half) {
  if (num_levels < 1 || num_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  p->num_levels = num_levels;
  p->num_packed = num_packed;
  p->num_steps = num_steps;
  p->table_bits = table_bits;
  p->key_bits = key_bits;
  p->rows = rows;
  for (int l = 0; l < num_levels; ++l) {
    p->scale[l] = scale[l];
    p->inv[l] = inv[l];
    p->dense[l] = dense[l];
    p->half[l] = half[l];
  }
  return 0;
}

unsigned int grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;   // grid-stride covers the rest
  return (unsigned int)(blocks < 1 ? 1 : blocks);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Pointers are device pointers
// except the per-level plan arrays (scale, inv, dense, half), which are
// host arrays copied into the kernel's parameter block.  Returns the
// cudaError_t of the launch.  Outputs are allocated by the caller; the
// gradient table must arrive zeroed.
extern "C" int parity_hash_encode_f32(const void* table, const void* pos,
                                      void* out, long long n, int num_levels,
                                      int num_packed, int num_steps,
                                      int table_bits, int key_bits,
                                      const float* scale, const float* inv,
                                      const int* dense, const int* half,
                                      void* stream) {
  Plan p;
  int err = make_plan(&p, num_levels, num_packed, num_steps, table_bits,
                      key_bits, num_steps * kParities, scale, inv, dense, half);
  if (err) return err;
  const long long total = n * num_packed * num_levels;
  if (total == 0) return 0;
  const int threads = 256;
  f32_encode_kernel<<<grid_for(total, threads), threads, 0,
                      (cudaStream_t)stream>>>(
      (const float2*)table, (const float*)pos, (float*)out, n, p);
  return (int)cudaGetLastError();
}

extern "C" int parity_hash_encode_q(const void* packed, const void* qscales,
                                    const void* pos, void* out, long long n,
                                    int num_levels, int num_packed,
                                    int num_steps, int table_bits, int key_bits,
                                    int rows_q, int qbits, const float* scale,
                                    const float* inv, const int* dense,
                                    const int* half, void* stream) {
  Plan p;
  int err = make_plan(&p, num_levels, num_packed, num_steps, table_bits,
                      key_bits, rows_q, scale, inv, dense, half);
  if (err) return err;
  if (qbits != 8 && qbits != 4) return (int)cudaErrorInvalidValue;
  const long long total = n * num_packed * num_levels;
  if (total == 0) return 0;
  const int threads = 256;
  if (qbits == 8) {
    q_encode_kernel<8><<<grid_for(total, threads), threads, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)packed, (const float*)qscales, (const float*)pos,
        (float*)out, n, p);
  } else {
    q_encode_kernel<4><<<grid_for(total, threads), threads, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)packed, (const float*)qscales, (const float*)pos,
        (float*)out, n, p);
  }
  return (int)cudaGetLastError();
}

// FUSED-QMLP.  ``packed`` and ``qscales`` are host arrays of device
// pointers, one per pyramid; the per-level plan arrays (scale, inv,
// dense, half) are the pyramids' concatenated in order.  The pyramids
// share num_steps (so rows_q) and qbits.  w1 [C, H], b1 [H], w2 [H, O],
// b2 [O], out [n, O], C = 2 * sum(num_packed[i] * num_levels[i]).
extern "C" int parity_hash_encode_qmlp(
    int num_pyramids, const void* const* packed, const void* const* qscales,
    const int* num_levels, const int* num_packed, const float* scale,
    const float* inv, const int* dense, const int* half, const void* pos,
    const void* w1, const void* b1, const void* w2, const void* b2, void* out,
    long long n, int num_steps, int table_bits, int key_bits, int rows_q,
    int qbits, int hidden, int out_dim, void* stream) {
  if (num_pyramids < 1 || num_pyramids > kMaxPyramids || hidden < 1 ||
      out_dim < 1 || (qbits != 8 && qbits != 4))
    return (int)cudaErrorInvalidValue;
  QmlpArgs a;
  a.num_pyramids = num_pyramids;
  a.row_off[0] = 0;
  int lv = 0;
  for (int i = 0; i < num_pyramids; ++i) {
    int err = make_plan(&a.plan[i], num_levels[i], num_packed[i], num_steps,
                        table_bits, key_bits, rows_q, scale + lv, inv + lv,
                        dense + lv, half + lv);
    if (err) return err;
    lv += num_levels[i];
    a.packed[i] = (const uint32_t*)packed[i];
    a.qscales[i] = (const float*)qscales[i];
    a.row_off[i + 1] = a.row_off[i] + num_packed[i] * num_levels[i];
  }
  for (int i = num_pyramids + 1; i <= kMaxPyramids; ++i) a.row_off[i] = a.row_off[i - 1];
  a.rows = a.row_off[num_pyramids];
  a.channels = 2 * a.rows;
  a.hidden = hidden;
  a.out_dim = out_dim;
  a.c_stride = (a.channels + 3) / 4 * 4;
  a.h_stride = (hidden + 3) / 4 * 4;
  const long long row_bytes = 4LL * (a.c_stride + a.h_stride);
  a.tile = 256;
  while (a.tile > kQmlpRows && a.tile * row_bytes > kQmlpSmemTarget) a.tile /= 2;
  const long long smem = a.tile * row_bytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long blocks = (n + a.tile - 1) / a.tile;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  auto kernel = qbits == 8 ? &qmlp_kernel<8> : &qmlp_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned int)blocks, kQmlpThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (float*)out, n, a);
  return (int)cudaGetLastError();
}

extern "C" int parity_hash_encode_f32_bwd(const void* pos, const void* gout,
                                          void* grad, long long n,
                                          int num_levels, int num_packed,
                                          int num_steps, int table_bits,
                                          int key_bits, const float* scale,
                                          const float* inv, const int* dense,
                                          const int* half, void* stream) {
  Plan p;
  int err = make_plan(&p, num_levels, num_packed, num_steps, table_bits,
                      key_bits, num_steps * kParities, scale, inv, dense, half);
  if (err) return err;
  const long long total = n * num_packed * num_levels;
  if (total == 0) return 0;
  const int threads = 256;
  f32_encode_bwd_kernel<<<grid_for(total, threads), threads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)gout, (float2*)grad, n, p);
  return (int)cudaGetLastError();
}
