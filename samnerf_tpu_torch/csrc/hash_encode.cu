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
// What bounds F32-ENC on an H100: bytes.  Each (point, pack*level)
// output pair does 8 random 8-byte (f32 pair) gathers and about 200
// integer/float operations, far below the compute lines; the gathers are
// the cost.  Design: one thread per (point, pack*level), a grid-stride
// loop, no shared memory.  Consecutive threads take consecutive levels of
// one point, so the position loads broadcast and the two output stores of
// a warp fall in a few 32-byte sectors.  The f32 masters are rounded to
// bf16 in registers (__float2bfloat16_rn), which equals the reference's
// table.astype(bf16) without a per-frame pack pass over the table.
//
// Q-ENC reads the pack-interleaved serve table [L, rows_q, 128, P] (an
// exact permutation of the packed [P*L, rows_q, 128], made once when the
// tables are baked): the P packs of a pyramid share every corner index,
// so one (level, row, lane) holds the P packs' words side by side and a
// corner is one 4-, 8- or 16-byte load.  Its bound is bytes too, and the
// cost is the 32-byte sectors the gathers touch (the q8 SAM pyramid is
// 48 MB of table, as large as the 50 MB L2): one sector per (point,
// level, corner) rather than one per (point, pack*level, corner), a
// quarter of them at P = 4, and the index math once for all packs.  A
// block takes a tile of consecutive points and its threads walk (level,
// point) with the point fastest, so the samples of one ray, which the
// serve path feeds in ray order, gather the same coarse cells in one
// warp.  The tile's output rows are staged in shared memory and stored
// whole.  Per pack the dequantized sum runs in the plain version's order,
// so Q-ENC equals it bit for bit.
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
// H 256, O 256) the operations, 60.9 GFLOP, 0.91 ms.  So the MLP half
// has to run near the arithmetic rate and the gathers have to hide under
// it.  Design: one block of 256 threads per tile of points (64 at the
// SAM head).  The encode is Q-ENC's own gather (q_encode_packs), written
// channel-major into shared memory.  The hidden layer runs in passes of
// 64 units: h = relu(enc @ w1[:, pass] + b1) into shared memory, then
// out += h @ w2[pass, :] into registers that live across the passes, so
// the [tile, H] hidden matrix is never held whole.  The weights stream
// through shared memory in slices, double-buffered by cp.async.  The
// wide heads (SAM, ClipSeg), whose time is the MLP, multiply on the
// tensor cores in 3xTF32 (mma.sync m16n8k8: each f32 operand split into
// a TF32 big and small part, big*big + big*small + small*big summed in
// f32), close to f32 accuracy and held to the f32 tolerance; an f32
// register-tiled MLP reached about 25 TFLOP/s here and lost to the
// unfused route.  The narrow heads (proposal, nerfacto), whose time is
// the gathers, stay on f32 FMAs in 4x4 register tiles at <= 64
// registers, so four blocks share an SM.  Two blocks share an SM at the
// SAM head (<= 128 registers a thread, <= 110 KB of shared memory), so
// one block's gathers overlap the other's multiplies.
// The TPU kernel's touched-slab skip, acc2 row merge and w1 column
// permutation serve its VMEM and sublane rules and have no counterpart.
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

// --- Q-ENC: the quantized encode over the pack-interleaved serve table

// The P packed words of one (level, row, lane) of the interleaved table
// [L, rows, 128, P]: one 4-, 8- or 16-byte load.
template <int P>
__device__ __forceinline__ void load_packs(const uint32_t* __restrict__ tab,
                                           long long idx, uint32_t (&w)[P]) {
  if constexpr (P == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(tab) + idx);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (P == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(tab) + idx);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = __ldg(tab + idx);
  }
}

// Q-ENC's arithmetic for one (point, level): the dequantized, trilinearly
// weighted feature pair of each of the P packs, from the level's slab
// ``tab`` of the interleaved table and the pyramid's scales ``qs`` [P*L].
// The 8 corners' index math runs once for all packs and each corner is
// one P-word load; per pack the sum runs in the plain version's order
// (a += (v*qs)*w over s = 0..7, rounded f32).  Shared by q_encode_kernel
// and qmlp_kernel, so the two encodes cannot drift.
template <int QBITS, int P>
__device__ __forceinline__ void q_encode_packs(const uint32_t* __restrict__ tab,
                                               const float* __restrict__ qs,
                                               const PointLevel& q, int l,
                                               const Plan& p, float2 (&v)[P]) {
  float sc[P];
#pragma unroll
  for (int pk = 0; pk < P; ++pk) {
    sc[pk] = __ldg(qs + pk * p.num_levels + l);
    v[pk] = make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int s = 0; s < kParities; ++s) {
    const Corner c = corner(q, s, l, p);
    const uint32_t e = c.entry;
    long long idx;
    uint32_t sh;
    if (QBITS == 8) {
      // two entries per word: byte 8*(2*(e&1)+f)
      idx = ((long long)(e >> 8) * kParities + s) * kLanes + ((e >> 1) & 127u);
      sh = 16u * (e & 1u);
    } else {
      // four entries per word: nibble 8*(e&3)+4f
      idx = ((long long)(e >> 9) * kParities + s) * kLanes + ((e >> 2) & 127u);
      sh = 8u * (e & 3u);
    }
    uint32_t w[P];
    load_packs<P>(tab, idx, w);
#pragma unroll
    for (int pk = 0; pk < P; ++pk) {
      int v0, v1;
      if (QBITS == 8) {
        v0 = (int)(int8_t)((w[pk] >> sh) & 0xFFu);
        v1 = (int)(int8_t)((w[pk] >> (sh + 8u)) & 0xFFu);
      } else {
        v0 = (int)(((w[pk] >> sh) & 0xFu) ^ 0x8u) - 8;
        v1 = (int)(((w[pk] >> (sh + 4u)) & 0xFu) ^ 0x8u) - 8;
      }
      v[pk].x = __fadd_rn(v[pk].x, __fmul_rn(__fmul_rn((float)v0, sc[pk]), c.w));
      v[pk].y = __fadd_rn(v[pk].y, __fmul_rn(__fmul_rn((float)v1, sc[pk]), c.w));
    }
  }
}

// Words of one level's slab of the interleaved table.
__device__ __forceinline__ long long level_words(const Plan& p) {
  return (long long)p.rows * kLanes * p.num_packed;
}

constexpr int kQencThreads = 256;

// One block per tile of consecutive points; its threads walk (level,
// point) with the point fastest, so a warp gathers one level for 32
// neighbouring points.  Each (point, level) writes its 2P features into a
// shared-memory row of the tile (stride C|1, odd, so a warp's writes hit
// 32 banks), and the block then stores the tile's output rows, which are
// contiguous in ``out``.
template <int QBITS, int P>
__global__ void __launch_bounds__(kQencThreads)
q_encode_kernel(const uint32_t* __restrict__ packed,
                const float* __restrict__ qscales,
                const float* __restrict__ pos, float* __restrict__ out,
                long long n, const Plan p, int tile) {
  extern __shared__ float stage[];
  const int L = p.num_levels;
  const int C = 2 * P * L;
  const int cs = C | 1;
  const long long base = (long long)blockIdx.x * tile;
  const int cnt = (int)min((long long)tile, n - base);
  for (int t = threadIdx.x; t < L * tile; t += blockDim.x) {
    const int l = t / tile, i = t - l * tile;
    if (i >= cnt) continue;
    const PointLevel q = point_level(pos, base + i, p.scale[l]);
    float2 v[P];
    q_encode_packs<QBITS, P>(packed + l * level_words(p), qscales, q, l, p, v);
    float* st = stage + i * cs + l;
#pragma unroll
    for (int pk = 0; pk < P; ++pk) {
      st[(2 * pk) * L] = v[pk].x;
      st[(2 * pk + 1) * L] = v[pk].y;
    }
  }
  __syncthreads();
  float* o = out + base * C;
  int k = threadIdx.x;
  int i = k / C, ch = k - i * C;
  const int di = blockDim.x / C, dc = blockDim.x - di * C;
  for (; k < cnt * C; k += blockDim.x) {
    o[k] = stage[i * cs + ch];
    i += di;
    ch += dc;
    if (ch >= C) {
      ch -= C;
      ++i;
    }
  }
}

// --- FUSED-QMLP: quantized encode of 1-4 stacked pyramids + a 1-hidden-layer MLP

constexpr int kMaxPyramids = 4;
constexpr int kQmlpThreads = 256;
constexpr int kBK = 16;                   // rows of a staged w2 slice
constexpr int kMaxChunk = 64;             // hidden units per layer-1 pass
constexpr int kMaxSmem = 232448;          // what one H100 block may use

struct QmlpArgs {
  int num_pyramids;
  int row_off[kMaxPyramids + 1];   // stacked (pyramid, level) rows: sum of L_i
  int ch_off[kMaxPyramids + 1];    // channel offsets: sum of 2 P_i L_i
  const uint32_t* packed[kMaxPyramids];
  const float* qscales[kMaxPyramids];
  Plan plan[kMaxPyramids];
  int channels, cpad;     // C, and C rounded up to k1rows
  int k1rows;             // rows of a staged w1 slice: a multiple of kBK
  int hidden, chunk, chunks;   // H, hidden units per pass, passes
  int out_dim, opad;      // O, and O rounded up to the layer-2 micro-tile
  int w1_vec, w2_vec;     // the weight rows can be staged 16 bytes at a time
};

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage rows [k0, k0 + nrows) and columns [c0, c0 + width) of the
// row-major weight w [rows, ld] into dst [nrows][dst_stride] with
// cp.async; entries outside w are zero-filled (the padded channels,
// hidden units and outputs).
__device__ __forceinline__ void stage_weights(float* dst, int dst_stride,
                                              const float* __restrict__ w, int rows, int ld,
                                              int k0, int nrows, int c0, int width,
                                              bool vec) {
  if (vec) {          // ld, c0 and width multiples of 4, w 16-byte aligned
    const int quads = width / 4;
    for (int e = threadIdx.x; e < nrows * quads; e += blockDim.x) {
      const int kk = e / quads, j = 4 * (e - kk * quads);
      const bool ok = k0 + kk < rows && c0 + j < ld;
      cp_async16(dst + kk * dst_stride + j, ok ? w + (long long)(k0 + kk) * ld + c0 + j : w,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * width; e += blockDim.x) {
      const int kk = e / width, j = e - kk * width;
      const bool ok = k0 + kk < rows && c0 + j < ld;
      cp_async4(dst + kk * dst_stride + j, ok ? w + (long long)(k0 + kk) * ld + c0 + j : w,
                ok);
    }
  }
  cp_async_commit();
}

// The (row group, column group) of thread t in a GR x GC grid of
// micro-tiles, false for a thread beyond it.  Where the grid allows, a
// warp takes 4 row groups x 8 column groups, so each k step's operand
// loads of a warp are one 64-byte and one 128-byte shared-memory read.
__device__ __forceinline__ bool micro_tile_of(int t, int gr, int gc, int& rg, int& cg) {
  if (t >= gr * gc) return false;
  if (gr % 4 == 0 && gc % 8 == 0) {
    const int w = t >> 5, lane = t & 31, wcols = gc / 8;
    rg = (w / wcols) * 4 + (lane >> 3);
    cg = (w % wcols) * 8 + (lane & 7);
  } else {
    rg = t / gc;
    cg = t - rg * gc;
  }
  return true;
}

// acc[i][j] += sum_k xT[k][row i] * ws[k][col j] over the nrows (a
// multiple of kBK) rows of a staged slice.  The thread's rows are 4-row
// runs (rg*4 + i%4) in TM/4 bands of bh rows, its columns 4-column runs
// (cg*4 + j%4) in TN/4 bands of bw columns: each k step reads TM/4 +
// TN/4 float4s for TM*TN FMAs.
template <int TM, int TN>
__device__ __forceinline__ void mma_slice(const float* __restrict__ xT, int xs, int k0,
                                          int nrows, const float* __restrict__ ws,
                                          int wstride, int r0, int bh, int c0, int bw,
                                          float (&acc)[TM][TN]) {
  for (int kb = 0; kb < nrows; kb += kBK) {
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const int k = kb + kk;
      float a[TM], b[TN];
      const float* xr = xT + (k0 + k) * xs + r0;
#pragma unroll
      for (int i = 0; i < TM / 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(xr + i * bh);
        a[4 * i] = v.x; a[4 * i + 1] = v.y; a[4 * i + 2] = v.z; a[4 * i + 3] = v.w;
      }
      const float* wr = ws + k * wstride + c0;
#pragma unroll
      for (int j = 0; j < TN / 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(wr + j * bw);
        b[4 * j] = v.x; b[4 * j + 1] = v.y; b[4 * j + 2] = v.z; b[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Encode one (point, level) of a pyramid with P packs into the block's
// enc tile (channel-major, row stride xs, ``e`` = this point at channel
// (p*2+f)*L + l of the pyramid); a point beyond n gets zeros.
template <int QBITS, int P>
__device__ __forceinline__ void encode_into(float* e, int xs, const uint32_t* __restrict__ tab,
                                            const float* __restrict__ qs,
                                            const float* __restrict__ pos, long long pt,
                                            bool live, int l, const Plan& p) {
  float2 v[P];
  if (live) {
    const PointLevel q = point_level(pos, pt, p.scale[l]);
    q_encode_packs<QBITS, P>(tab, qs, q, l, p, v);
  } else {
#pragma unroll
    for (int pk = 0; pk < P; ++pk) v[pk] = make_float2(0.0f, 0.0f);
  }
  const int L = p.num_levels;
#pragma unroll
  for (int pk = 0; pk < P; ++pk) {
    e[(2 * pk) * L * xs] = v[pk].x;
    e[(2 * pk + 1) * L * xs] = v[pk].y;
  }
}

// The weight slices of one tile, in order: per pass c of ``chunk``
// hidden units, the k1rows-row slices of w1[:, pass] (as deep as a
// slice buffer allows, so a pass takes few of them), then the kBK-row
// slices of w2[pass, :].  Slice s is staged by cp.async into buffer
// s & 1 while the other buffer is multiplied; a staged row is padded by
// 8 floats, so mma fragment loads hit 32 banks.
struct WeightPipe {
  const float* w1;
  const float* w2;
  float* wbuf;       // [2][slice]
  int channels, hidden, out_dim, chunk, opad, k1rows, w1_vec, w2_vec;
  int slice, k1, k2, total, s;

  __device__ void stage(int i) const {
    const int c = i / (k1 + k2), r = i - c * (k1 + k2);
    float* dst = wbuf + (i & 1) * slice;
    if (r < k1)
      stage_weights(dst, chunk + 8, w1, channels, hidden, r * k1rows, k1rows, c * chunk,
                    chunk, w1_vec);
    else
      stage_weights(dst, opad + 8, w2, hidden, out_dim, c * chunk + (r - k1) * kBK, kBK, 0,
                    opad, w2_vec);
  }
  // wait for the next slice, make it visible, and start the one after it
  // into the buffer every thread has finished reading
  __device__ const float* next() {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < total) stage(s + 1);
    return wbuf + (s++ & 1) * slice;
  }
};

// The MLP of a tile on the CUDA cores: each thread owns a TM1 x TN1 tile
// of a hidden pass and a TM2 x TN2 tile of the output (f32 FMAs); the
// narrow heads, whose time is the gathers.
template <int T, int TM1, int TN1, int TM2, int TN2>
__device__ __forceinline__ void mlp_simt(const QmlpArgs& a, WeightPipe& pipe, const float* encT,
                                         float* hT, int xs, const float* __restrict__ b1,
                                         const float* __restrict__ b2, float* __restrict__ out,
                                         long long base, long long n) {
  const int tid = threadIdx.x;
  int rg1 = 0, cg1 = 0, rg2 = 0, cg2 = 0;
  const bool on1 = micro_tile_of(tid, T / TM1, a.chunk / TN1, rg1, cg1);
  const bool on2 = micro_tile_of(tid, T / TM2, a.opad / TN2, rg2, cg2);
  const int bh1 = T / (TM1 / 4), bw1 = a.chunk / (TN1 / 4);
  const int bh2 = T / (TM2 / 4), bw2 = a.opad / (TN2 / 4);
  float acc2[TM2][TN2];
#pragma unroll
  for (int i = 0; i < TM2; ++i)
#pragma unroll
    for (int j = 0; j < TN2; ++j) acc2[i][j] = 0.0f;

  for (int c = 0; c < a.chunks; ++c) {
    float acc1[TM1][TN1];
#pragma unroll
    for (int i = 0; i < TM1; ++i)
#pragma unroll
      for (int j = 0; j < TN1; ++j) acc1[i][j] = 0.0f;
    for (int r = 0; r < pipe.k1; ++r) {
      const float* ws = pipe.next();
      if (on1)
        mma_slice<TM1, TN1>(encT, xs, r * a.k1rows, a.k1rows, ws, a.chunk + 8, rg1 * 4, bh1,
                            cg1 * 4, bw1, acc1);
    }
    if (on1) {
#pragma unroll
      for (int j = 0; j < TN1; ++j) {
        const int col = (j / 4) * bw1 + cg1 * 4 + j % 4;
        const int hid = c * a.chunk + col;
        const float bj = hid < a.hidden ? __ldg(b1 + hid) : 0.0f;
#pragma unroll
        for (int i = 0; i < TM1 / 4; ++i) {
          float4 h;
          h.x = fmaxf(acc1[4 * i][j] + bj, 0.0f);
          h.y = fmaxf(acc1[4 * i + 1][j] + bj, 0.0f);
          h.z = fmaxf(acc1[4 * i + 2][j] + bj, 0.0f);
          h.w = fmaxf(acc1[4 * i + 3][j] + bj, 0.0f);
          *reinterpret_cast<float4*>(hT + col * xs + i * bh1 + rg1 * 4) = h;
        }
      }
    }
    for (int r = 0; r < pipe.k2; ++r) {
      const float* ws = pipe.next();
      if (on2)
        mma_slice<TM2, TN2>(hT, xs, r * kBK, kBK, ws, a.opad + 8, rg2 * 4, bh2, cg2 * 4, bw2,
                            acc2);
    }
  }

  if (!on2) return;
  const int O = a.out_dim;
#pragma unroll
  for (int i = 0; i < TM2; ++i) {
    const int row = (i / 4) * bh2 + rg2 * 4 + i % 4;
    if (base + row >= n) continue;
    float* o = out + (base + row) * O;
#pragma unroll
    for (int j = 0; j < TN2; j += 4) {
      const int col = (j / 4) * bw2 + cg2 * 4;
      if (col >= O) continue;
      if (O % 4 == 0) {
        *reinterpret_cast<float4*>(o + col) = make_float4(
            acc2[i][j] + __ldg(b2 + col), acc2[i][j + 1] + __ldg(b2 + col + 1),
            acc2[i][j + 2] + __ldg(b2 + col + 2), acc2[i][j + 3] + __ldg(b2 + col + 3));
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (col + jj < O) o[col + jj] = acc2[i][j + jj] + __ldg(b2 + col + jj);
      }
    }
  }
}

// x = big + small in TF32: big keeps the top 10 mantissa bits (rounded
// toward zero), small the rest rounded to TF32, so big*big' + big*small'
// + small*big' carries a product to about f32 precision (3xTF32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
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

// acc[mt][nt] += x[m0 + 16 mt.., k] w[k, n0 + 8 nt..] over the nrows rows of
// a staged slice (nt < ntiles), one warp, 3xTF32 with the small terms
// first.  x is xT [k][row] (stride xs), w the slice [k][col] (stride
// ws_stride); fragment layouts of mma.m16n8k8 .tf32: a (g, t), (g+8, t),
// (g, t+4), (g+8, t+4); b (k t, n g), (k t+4, n g); g = lane/4, t = lane%4.
template <int MT, int NT>
__device__ __forceinline__ void mma_slice_tc(const float* xT, int xs, int k0, int nrows,
                                             const float* ws, int ws_stride, int m0, int n0,
                                             int ntiles, float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < nrows; k += 8) {
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* x = xT + (k0 + k + t) * xs + m0 + 16 * mt + g;
      split_tf32(x[0], ab[mt][0], as[mt][0]);
      split_tf32(x[8], ab[mt][1], as[mt][1]);
      split_tf32(x[4 * xs], ab[mt][2], as[mt][2]);
      split_tf32(x[4 * xs + 8], ab[mt][3], as[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= ntiles) break;
      const float* w = ws + (k + t) * ws_stride + n0 + 8 * nt + g;
      uint32_t bb[2], bs[2];
      split_tf32(w[0], bb[0], bs[0]);
      split_tf32(w[4 * ws_stride], bb[1], bs[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_tf32(acc[mt][nt], as[mt], bb);
        mma_tf32(acc[mt][nt], ab[mt], bs);
        mma_tf32(acc[mt][nt], ab[mt], bb);
      }
    }
  }
}

// The MLP of a tile on the tensor cores, 3xTF32 (the wide heads, whose
// time is the MLP).  Warps 2 x 4 over (points, columns): a warp takes
// T/2 points x chunk/4 hidden units of a pass, then T/2 points x opad/4
// outputs, accumulated across the passes.  chunk and opad are multiples
// of 32.
template <int T>
__device__ __forceinline__ void mlp_tc(const QmlpArgs& a, WeightPipe& pipe, const float* encT,
                                       float* hT, int xs, const float* __restrict__ b1,
                                       const float* __restrict__ b2, float* __restrict__ out,
                                       long long base, long long n) {
  constexpr int MT = T / 32;          // 16-row tiles per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp / 4) * (T / 2);
  const int n1 = (warp % 4) * (a.chunk / 4), nt1 = a.chunk / 32;
  const int n2 = (warp % 4) * (a.opad / 4), nt2 = a.opad / 32;
  float acc2[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc2[mt][nt][v] = 0.0f;

  for (int c = 0; c < a.chunks; ++c) {
    float acc1[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc1[mt][nt][v] = 0.0f;
    for (int r = 0; r < pipe.k1; ++r) {
      const float* ws = pipe.next();
      mma_slice_tc<MT, 2>(encT, xs, r * a.k1rows, a.k1rows, ws, a.chunk + 8, m0, n1, nt1,
                          acc1);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      if (nt >= nt1) break;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int col = n1 + 8 * nt + 2 * t + (v & 1);
        const int hid = c * a.chunk + col;
        const float bj = hid < a.hidden ? __ldg(b1 + hid) : 0.0f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          hT[col * xs + m0 + 16 * mt + g + 8 * (v >> 1)] = fmaxf(acc1[mt][nt][v] + bj, 0.0f);
      }
    }
    for (int r = 0; r < pipe.k2; ++r) {
      const float* ws = pipe.next();
      mma_slice_tc<MT, 8>(hT, xs, r * kBK, kBK, ws, a.opad + 8, m0, n2, nt2, acc2);
    }
  }

  const int O = a.out_dim;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = base + m0 + 16 * mt + g + 8 * h;
      if (row >= n) continue;
      float* o = out + row * O;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= nt2) break;
        const int col = n2 + 8 * nt + 2 * t;
        if (col + 1 < O && O % 2 == 0) {
          *reinterpret_cast<float2*>(o + col) =
              make_float2(acc2[mt][nt][2 * h] + __ldg(b2 + col),
                          acc2[mt][nt][2 * h + 1] + __ldg(b2 + col + 1));
        } else {
          if (col < O) o[col] = acc2[mt][nt][2 * h] + __ldg(b2 + col);
          if (col + 1 < O) o[col + 1] = acc2[mt][nt][2 * h + 1] + __ldg(b2 + col + 1);
        }
      }
    }
}

// One block per tile of T points.  Shared memory holds the tile's
// features channel-major (encT [cpad][T + 8]), one pass of hidden units
// (hT [chunk][T + 8]) and two weight slices (WeightPipe).
//   1. Encode: threads walk (stacked pyramid level, point), point
//      fastest, through q_encode_packs, writing encT; the first weight
//      slice is in flight meanwhile.  Pyramids have at most PMAX packs.
//   2. For each pass of ``chunk`` hidden units: hT = relu(enc @
//      w1[:, pass] + b1), then out += hT^T @ w2[pass, :] into registers
//      that live across the passes, so the [T, H] hidden matrix is never
//      held whole: on the tensor cores in 3xTF32 (TC, mlp_tc) or in f32
//      FMAs with TM x TN register tiles (mlp_simt).
//   3. out + b2 to the rows below n.
// MINB blocks share an SM (two at the SAM head: <= 128 registers a
// thread, <= 110 KB of shared memory), so one block's gathers overlap
// another's multiplies.
template <int QBITS, int T, int TM1, int TN1, int TM2, int TN2, int PMAX, int MINB, bool TC>
__global__ void __launch_bounds__(kQmlpThreads, MINB)
qmlp_kernel(const float* __restrict__ pos, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, float* __restrict__ out, long long n,
            const QmlpArgs a) {
  constexpr int XS = T + 8;       // row stride of encT and hT
  extern __shared__ float4 smem4[];
  float* encT = reinterpret_cast<float*>(smem4);   // [cpad][XS]
  float* hT = encT + a.cpad * XS;                   // [chunk][XS]
  const int k1 = a.cpad / a.k1rows, k2 = a.chunk / kBK;
  WeightPipe pipe{w1, w2, hT + a.chunk * XS, a.channels, a.hidden, a.out_dim, a.chunk,
                  a.opad, a.k1rows, a.w1_vec, a.w2_vec, kBK * (max(a.chunk, a.opad) + 8),
                  k1, k2, a.chunks * (k1 + k2), 0};
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * T;

  pipe.stage(0);
  for (int e = tid; e < (a.cpad - a.channels) * XS; e += blockDim.x)
    encT[a.channels * XS + e] = 0.0f;
  const int rows = a.row_off[a.num_pyramids];
  for (int t = tid; t < rows * T; t += blockDim.x) {
    const int r = t / T, i = t - r * T;
    int py = 0;
    while (r >= a.row_off[py + 1]) ++py;
    const Plan& p = a.plan[py];
    const int l = r - a.row_off[py];
    const uint32_t* tab = a.packed[py] + l * level_words(p);
    float* e = encT + (a.ch_off[py] + l) * XS + i;
    const bool live = base + i < n;
    if (PMAX >= 4 && p.num_packed == 4)
      encode_into<QBITS, 4>(e, XS, tab, a.qscales[py], pos, base + i, live, l, p);
    else if (PMAX >= 2 && p.num_packed == 2)
      encode_into<QBITS, 2>(e, XS, tab, a.qscales[py], pos, base + i, live, l, p);
    else
      encode_into<QBITS, 1>(e, XS, tab, a.qscales[py], pos, base + i, live, l, p);
  }
  if constexpr (TC)
    mlp_tc<T>(a, pipe, encT, hT, XS, b1, b2, out, base, n);
  else
    mlp_simt<T, TM1, TN1, TM2, TN2>(a, pipe, encT, hT, XS, b1, b2, out, base, n);
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

template <int QBITS, int P>
void launch_q_encode(const void* packed, const void* qscales, const void* pos,
                     void* out, long long n, const Plan& p, int tile, int smem,
                     cudaStream_t stream) {
  const long long blocks = (n + tile - 1) / tile;
  q_encode_kernel<QBITS, P><<<(unsigned int)blocks, kQencThreads, smem, stream>>>(
      (const uint32_t*)packed, (const float*)qscales, (const float*)pos, (float*)out, n,
      p, tile);
}

// Q-ENC.  ``packed`` is the pack-interleaved table [L, rows_q, 128, P]
// (P = num_packed in {1, 2, 4}), 16-byte aligned; ``qscales`` [P*L].
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
  if ((qbits != 8 && qbits != 4) ||
      (num_packed != 1 && num_packed != 2 && num_packed != 4))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  // the largest tile of at most 256 points whose staged rows fit 32 KB
  const int cs = (2 * num_packed * num_levels) | 1;
  int tile = 256;
  while (tile > 32 && tile * cs * 4 > 32 * 1024) tile /= 2;
  const int smem = tile * cs * 4;
  if ((n + tile - 1) / tile > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int key = qbits * 10 + num_packed;
  switch (key) {
    case 81: launch_q_encode<8, 1>(packed, qscales, pos, out, n, p, tile, smem, st); break;
    case 82: launch_q_encode<8, 2>(packed, qscales, pos, out, n, p, tile, smem, st); break;
    case 84: launch_q_encode<8, 4>(packed, qscales, pos, out, n, p, tile, smem, st); break;
    case 41: launch_q_encode<4, 1>(packed, qscales, pos, out, n, p, tile, smem, st); break;
    case 42: launch_q_encode<4, 2>(packed, qscales, pos, out, n, p, tile, smem, st); break;
    default: launch_q_encode<4, 4>(packed, qscales, pos, out, n, p, tile, smem, st); break;
  }
  return (int)cudaGetLastError();
}

template <int QBITS, int T, int TM1, int TN1, int TM2, int TN2, int PMAX, int MINB, bool TC>
int launch_qmlp(QmlpArgs& a, const void* pos, const void* w1, const void* b1,
                const void* w2, const void* b2, void* out, long long n,
                cudaStream_t stream) {
  // hidden units per pass and padded outputs: multiples of the register
  // tile, of 32 on the tensor cores (4 warps x 8 columns)
  const int quantum = TC ? 32 : kBK;
  a.chunk = min((a.hidden + quantum - 1) / quantum * quantum, kMaxChunk);
  a.chunks = (a.hidden + a.chunk - 1) / a.chunk;
  a.opad = (a.out_dim + (TC ? 31 : TN2 - 1)) / (TC ? 32 : TN2) * (TC ? 32 : TN2);
  if (!TC && ((T / TM1) * (a.chunk / TN1) > kQmlpThreads ||
              (T / TM2) * (a.opad / TN2) > kQmlpThreads))
    return (int)cudaErrorInvalidValue;
  // a w1 slice fills the buffer a w2 slice needs: as many rows of the
  // pass's columns as fit, a multiple of kBK, no more than C needs
  const int slice = kBK * (max(a.chunk, a.opad) + 8);
  const int c16 = (a.channels + kBK - 1) / kBK * kBK;
  a.k1rows = max(kBK, min(slice / (a.chunk + 8) / kBK * kBK, c16));
  a.cpad = (a.channels + a.k1rows - 1) / a.k1rows * a.k1rows;
  const long long smem = 4LL * ((long long)(a.cpad + a.chunk) * (T + 8) + 2LL * slice);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + T - 1) / T;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  auto kernel = &qmlp_kernel<QBITS, T, TM1, TN1, TM2, TN2, PMAX, MINB, TC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned int)blocks, kQmlpThreads, (size_t)smem, stream>>>(
      (const float*)pos, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (float*)out, n, a);
  return (int)cudaGetLastError();
}

// The MLP by head.  O <= 32 (the proposal and nerfacto heads, whose time
// is the gathers): f32 FMAs, 64-point tiles with 4x4 hidden and output
// micro-tiles at <= 64 registers, so four blocks share an SM, and only
// the one-pack gather compiled when every pyramid has one pack.  Wider
// heads (SAM, ClipSeg: their time is the MLP): 3xTF32 on the tensor
// cores, 64-point tiles, or 32-point tiles where 64-point tiles would not
// give two blocks to every SM (the ClipSeg head's 8,192 points).
template <int QBITS>
int dispatch_qmlp(QmlpArgs& a, const void* pos, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* out, long long n,
                  cudaStream_t stream) {
  int pmax = 1;
  for (int i = 0; i < a.num_pyramids; ++i) pmax = max(pmax, a.plan[i].num_packed);
  if (a.out_dim <= 32 && pmax == 1)
    return launch_qmlp<QBITS, 64, 4, 4, 4, 4, 1, 4, false>(a, pos, w1, b1, w2, b2, out, n,
                                                           stream);
  if (a.out_dim <= 32)
    return launch_qmlp<QBITS, 64, 4, 4, 4, 4, 4, 4, false>(a, pos, w1, b1, w2, b2, out, n,
                                                           stream);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if ((n + 63) / 64 >= 2LL * sms)
    return launch_qmlp<QBITS, 64, 4, 4, 4, 4, 4, 2, true>(a, pos, w1, b1, w2, b2, out, n,
                                                          stream);
  return launch_qmlp<QBITS, 32, 4, 4, 4, 4, 4, 2, true>(a, pos, w1, b1, w2, b2, out, n,
                                                        stream);
}

// FUSED-QMLP.  ``packed`` and ``qscales`` are host arrays of device
// pointers, one per pyramid: pack-interleaved tables [L_i, rows_q, 128,
// P_i] (P_i in {1, 2, 4}, 16-byte aligned) and scales [P_i*L_i]; the
// per-level plan arrays (scale, inv, dense, half) are the pyramids'
// concatenated in order.  The pyramids share num_steps (so rows_q) and
// qbits.  w1 [C, H], b1 [H], w2 [H, O], b2 [O], out [n, O], C = 2 *
// sum(num_packed[i] * num_levels[i]), O <= 256.
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
  a.ch_off[0] = 0;
  int lv = 0;
  for (int i = 0; i < num_pyramids; ++i) {
    if (num_packed[i] != 1 && num_packed[i] != 2 && num_packed[i] != 4)
      return (int)cudaErrorInvalidValue;
    int err = make_plan(&a.plan[i], num_levels[i], num_packed[i], num_steps,
                        table_bits, key_bits, rows_q, scale + lv, inv + lv,
                        dense + lv, half + lv);
    if (err) return err;
    lv += num_levels[i];
    a.packed[i] = (const uint32_t*)packed[i];
    a.qscales[i] = (const float*)qscales[i];
    a.row_off[i + 1] = a.row_off[i] + num_levels[i];
    a.ch_off[i + 1] = a.ch_off[i] + 2 * num_packed[i] * num_levels[i];
  }
  for (int i = num_pyramids + 1; i <= kMaxPyramids; ++i) {
    a.row_off[i] = a.row_off[i - 1];
    a.ch_off[i] = a.ch_off[i - 1];
  }
  a.channels = a.ch_off[num_pyramids];
  a.hidden = hidden;
  a.out_dim = out_dim;
  a.w1_vec = hidden % 4 == 0 && (uintptr_t)w1 % 16 == 0;
  a.w2_vec = out_dim % 4 == 0 && (uintptr_t)w2 % 16 == 0;
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return qbits == 8 ? dispatch_qmlp<8>(a, pos, w1, b1, w2, b2, out, n, st)
                    : dispatch_qmlp<4>(a, pos, w1, b1, w2, b2, out, n, st);
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
