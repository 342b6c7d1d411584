// FLASH-RELPOS: attention with SAM's decomposed relative-position bias,
// for sm_90a, in f32.
//
// Replaces the TPU Pallas kernel samnerf_tpu/ops/attention_pallas.py
// _attn_kernel.  For each (batch*head) b, query i and key j it computes
//   softmax_j(q_i . k_j * scale + rel_h[b, i, j / Kw] + rel_w[b, i, j % Kw]) v_j
// with an online softmax, so the N x N logits never reach device memory;
// rel_h [B, N, Kh] and rel_w [B, N, Kw] are the bias terms already
// contracted with q (outside the kernel, as the JAX encoder does).
//
// What bounds it on an H100: operations.  Per (batch*head) it does
// 4 N^2 D f32 flops against 4 (4 N D + N (Kh + Kw)) bytes of input and
// output; at SAM ViT-H's global layers (N = 4096, D = 80) that is about
// 80 flops per byte of K and V re-read from L2, far above the f32 ridge.
// Design (simple first): one block of 256 threads per (batch*head, tile of
// 64 queries), a loop over tiles of 64 keys.  The q tile (pre-scaled) and
// each k tile sit transposed in shared memory so a thread reads four
// queries or four keys as one float4; each thread owns a 4 x 4 block of
// the logits tile and, for the product with V, 4 queries x ceil(D / 16)
// output columns (column tx + 16 c).  The running max, sum and
// accumulator stay in registers, in f32, as in the TPU kernel: m starts
// at -1e30, out = acc / max(l, 1e-30).  The q tile's rel_h / rel_w rows
// are staged once per block.  Ragged tiles are masked (keys past N get
// -1e30 before the max), and kh = j / Kw, kw = j % Kw per key, so no
// tile-size or grid-shape assumption of the TPU kernel is kept.  expf,
// no --use_fast_math.  wgmma, TMA and a bf16 path are later work.
//
// Head dims 1..128 (templated on ceil(D / 16)); Kh + Kw <= 256.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;             // 16 x 16: ty -> 4 rows, tx -> 4 cols
constexpr int kTileStride = kBlockQ + 4;  // Qt / Kt rows: float4-aligned, fewer bank conflicts
constexpr int kProbStride = kBlockK + 4;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxRelSum = 256;
constexpr float kNegInf = -1e30f;

size_t smem_floats(int d, int dpt, int kh, int kw) {
  return 2 * (size_t)d * kTileStride            // qt, kt
         + (size_t)kBlockK * 16 * dpt           // vs
         + (size_t)kBlockQ * kProbStride        // ps
         + (size_t)kBlockQ * (kh + kw);         // rh, rw
}

template <int DPT>
__global__ void __launch_bounds__(kThreads)
flash_relpos_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ rel_h,
                    const float* __restrict__ rel_w, float* __restrict__ out,
                    int n, int d, int kh, int kw, float scale) {
  constexpr int VD = 16 * DPT;                 // padded V row
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4); // [d][kTileStride]
  float* kt = qt + d * kTileStride;            // [d][kTileStride]
  float* vs = kt + d * kTileStride;            // [kBlockK][VD]
  float* ps = vs + kBlockK * VD;               // [kBlockQ][kProbStride]
  float* rh = ps + kBlockQ * kProbStride;      // [kBlockQ][kh]
  float* rw = rh + kBlockQ * kh;               // [kBlockQ][kw]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.x * kBlockQ;
  const int rows = min(kBlockQ, n - i0);
  const size_t base = (size_t)blockIdx.y * n * d;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const size_t rel_row = (size_t)blockIdx.y * n + i0;

  for (int e = tid; e < kBlockQ * d; e += kThreads) {
    const int i = e / d, c = e - i * d;
    qt[c * kTileStride + i] = i < rows ? qb[(size_t)(i0 + i) * d + c] * scale : 0.f;
  }
  for (int e = tid; e < kBlockQ * kh; e += kThreads)
    rh[e] = e < rows * kh ? rel_h[rel_row * kh + e] : 0.f;
  for (int e = tid; e < kBlockQ * kw; e += kThreads)
    rw[e] = e < rows * kw ? rel_w[rel_row * kw + e] : 0.f;

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[r][c] = 0.f;
  }

  const int num_kb = (n + kBlockK - 1) / kBlockK;
  for (int t = 0; t < num_kb; ++t) {
    const int j0 = t * kBlockK;
    const int cols = min(kBlockK, n - j0);
    __syncthreads();  // the last tile's kt / vs / ps reads are done
    for (int e = tid; e < kBlockK * d; e += kThreads) {
      const int j = e / d, c = e - j * d;
      kt[c * kTileStride + j] = j < cols ? kb[(size_t)(j0 + j) * d + c] : 0.f;
    }
    for (int e = tid; e < kBlockK * VD; e += kThreads) {
      const int j = e / VD, c = e - j * VD;
      vs[e] = (j < cols && c < d) ? vb[(size_t)(j0 + j) * d + c] : 0.f;
    }
    __syncthreads();

    // logits tile: s[r][cc] = q[ty*4 + r] . k[tx*4 + cc]
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[r][cc] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(qt + c * kTileStride + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kt + c * kTileStride + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) s[r][cc] = fmaf(av[r], bv[cc], s[r][cc]);
    }

    // decomposed bias, masked keys
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int jl = tx * 4 + cc;
      if (jl < cols) {
        const int j = j0 + jl;
        const int hh = j / kw, ww = j - hh * kw;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = ty * 4 + r;
          s[r][cc] += rh[row * kh + hh] + rw[row * kw + ww];
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) s[r][cc] = kNegInf;
      }
    }

    // online softmax; a row's 64 logits live in the 16 lanes of one half-warp
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        s[r][cc] = expf(s[r][cc] - m_new);
        sum += s[r][cc];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[r][c] *= alpha;
      *reinterpret_cast<float4*>(ps + (ty * 4 + r) * kProbStride + tx * 4) =
          make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
    }
    __syncthreads();

    // acc[r][c] += sum_j p[ty*4 + r][j] v[j][tx + 16 c]
    for (int j = 0; j < kBlockK; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p4[r] = *reinterpret_cast<const float4*>(ps + (ty * 4 + r) * kProbStride + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DPT];
#pragma unroll
        for (int c = 0; c < DPT; ++c) vv[c] = vs[(j + jj) * VD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = jj == 0 ? p4[r].x : jj == 1 ? p4[r].y : jj == 2 ? p4[r].z : p4[r].w;
#pragma unroll
          for (int c = 0; c < DPT; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    if (row < rows) {
      const float denom = fmaxf(l[r], 1e-30f);
      float* o = out + base + (size_t)(i0 + row) * d;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 16 * c;
        if (col < d) o[col] = acc[r][c] / denom;
      }
    }
  }
}

template <int DPT>
int launch(const float* q, const float* k, const float* v, const float* rel_h,
           const float* rel_w, float* out, int b, int n, int d, int kh, int kw,
           float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(d, DPT, kh, kw) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_relpos_kernel<DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, b);
  flash_relpos_kernel<DPT><<<grid, kThreads, bytes, stream>>>(
      q, k, v, rel_h, rel_w, out, n, d, kh, kw, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out [b, n, d]; rel_h [b, n, kh]; rel_w [b, n, kw]; all
// contiguous f32 on one device.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_relpos_f32(const void* q, const void* k,
                                          const void* v, const void* rel_h,
                                          const void* rel_w, void* out, int b,
                                          int n, int d, int kh, int kw,
                                          float scale, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || d < 1 || d > kMaxHeadDim || kh < 1 ||
      kw < 1 || (long long)kh * kw != n || kh + kw > kMaxRelSum)
    return (int)cudaErrorInvalidValue;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* hp = static_cast<const float*>(rel_h);
  const float* wp = static_cast<const float*>(rel_w);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch<1>(qp, kp, vp, hp, wp, op, b, n, d, kh, kw, scale, s);
    case 2: return launch<2>(qp, kp, vp, hp, wp, op, b, n, d, kh, kw, scale, s);
    case 3: return launch<3>(qp, kp, vp, hp, wp, op, b, n, d, kh, kw, scale, s);
    case 4: return launch<4>(qp, kp, vp, hp, wp, op, b, n, d, kh, kw, scale, s);
    case 5: return launch<5>(qp, kp, vp, hp, wp, op, b, n, d, kh, kw, scale, s);
    case 6: return launch<6>(qp, kp, vp, hp, wp, op, b, n, d, kh, kw, scale, s);
    case 7: return launch<7>(qp, kp, vp, hp, wp, op, b, n, d, kh, kw, scale, s);
    default: return launch<8>(qp, kp, vp, hp, wp, op, b, n, d, kh, kw, scale, s);
  }
}
