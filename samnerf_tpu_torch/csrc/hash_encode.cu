// Parity-partitioned multiresolution hash encode and its table gradient,
// for sm_90a.
//
// Replaces the TPU Pallas kernels of samnerf_tpu/ops/hash_pallas.py:
//   F32-ENC      _fwd_kernel (v1), _fwd_kernel_v2, _fwd_kernel_v4
//   Q-ENC        _fwd_kernel_q8 (qbits 8 and 4), _fwd_kernel_q8v4
//   F32-ENC-BWD  _bwd_kernel (v1), _bwd_kernel_v2, _bwd_kernel_v4
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
    const uint32_t* tab = packed + (long long)pl * p.rows * kLanes;
    const float qs = qscales[pl];
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
    float* o = out + pt * (2LL * PL);
    o[(2 * pk) * L + l] = a0;
    o[(2 * pk + 1) * L + l] = a1;
  }
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
