// K8: the W8A8 linear of the frozen int8 trunk, forward and dgrad, as two
// hand-written sm_90a kernels (int32 accumulation on the s8 tensor cores).
//
// Replaces agacs_tpu/ops/int8_linear.py `int8_matmul` (:83-127): on the
// TPU an XLA int8 dot_general with `_row_quant` fused into its producers,
// not a Pallas kernel.
//
//   K8q int8_rowquant: per row of x (M, K), float32 v = x (* colscale), s =
//       max(max|v|, 1e-12) / 127, q = round(v / s) -> int8 q (M, K), f32 s
//       (M,). The colscale is the dgrad's `dy * w_s` (:111). One warp per
//       row, two passes over it (the second from L1/L2).
//   K8g int8_gemm: out = (acc * s_row) [* w_s[col]] cast to bf16 or f32,
//       acc = q (M, K) . w, int32. w is the JAX buffer w_q (d_in, d_out)
//       read row-major (forward: K = d_in, N = d_out, staged through a 4x4
//       byte transpose) or as w_q^T (dgrad: K = d_out, N = d_in, its rows
//       copied as they are). 64 x 64 output tile per block of 4 warps, each
//       warp 32 x 32 (2 x 4 m16n8k32 products per 32 k), 64-byte k slabs
//       staged in shared memory without double buffering. Bias is added
//       outside, as in JAX (:151-152). Any M >= 1 (decode steps have 8 or
//       40 rows; a 64-row tile then computes on zero rows).
//
// Bound on the H100 (989/1979 TOPS int8 dense, 3.35 TB/s): at (12000, 768)
// -> 768 the product is 14.2 GOP (7.2 us) and the bytes ~28 MB (8.3 us):
// bytes-bound; at 8 rows the 0.6-2.4 MB weight read bounds it (< 1 us).
// This first version is neither: every k slab waits for its load, and the
// forward transposes the weight tile on every read. Levers for a later
// change: cp.async or TMA double buffering, wgmma, a pre-transposed copy of
// the weight for the forward, the row quantisation fused into the
// producer or into the GEMM's A load.
#include "int8_mma.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 64, LDS = BK + 16;  // 80-byte rows: no bank conflicts
constexpr int THREADS = 128;

template <bool BF16>
__global__ void __launch_bounds__(256) rowquant_kernel(const void* __restrict__ x,
                                                       const float* __restrict__ cs,
                                                       int8_t* __restrict__ q,
                                                       float* __restrict__ s, int M,
                                                       int K) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t base = (size_t)row * K;
  float m = 0.f;
  for (int c = lane; c < K; c += 32) {
    float v = i8::ldf<BF16>(x, base + c);
    if (cs) v = __fmul_rn(v, cs[c]);
    m = fmaxf(m, fabsf(v));
  }
  const float sc = i8::quant_scale(i8::warp_max(m));
  for (int c = lane; c < K; c += 32) {
    float v = i8::ldf<BF16>(x, base + c);
    if (cs) v = __fmul_rn(v, cs[c]);
    q[base + c] = i8::quant(v, sc);
  }
  if (lane == 0) s[row] = sc;
}

template <bool DGRAD, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS) gemm_kernel(
    const int8_t* __restrict__ a, const float* __restrict__ s_row,
    const int8_t* __restrict__ w, const float* __restrict__ w_s, void* __restrict__ out,
    int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[BM * LDS];
  __shared__ __align__(16) int8_t sB[BN * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    i8::stage_rows<BM, BK>(sA, LDS, a, K, m0, M, k0, K, tid, THREADS);
    if constexpr (DGRAD)  // w_q (N, K) row-major is already Bt
      i8::stage_rows<BN, BK>(sB, LDS, w, K, n0, N, k0, K, tid, THREADS);
    else                  // w_q (K, N) row-major
      i8::stage_trans<BK, BN>(sB, LDS, w, N, k0, K, n0, N, tid, THREADS);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) i8::load_a(af[i], sA + (wm + 16 * i) * LDS + kk, LDS, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) i8::load_b(bf[j], sB + (wn + 8 * j) * LDS + kk, LDS, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) i8::mma(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm + 16 * i + g + 8 * hh;
      if (row >= M) continue;
      const float sr = s_row[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + 8 * j + 2 * t;
        if (col >= N) continue;
        float v0 = __fmul_rn((float)acc[i][j][2 * hh], sr);
        float v1 = __fmul_rn((float)acc[i][j][2 * hh + 1], sr);
        if (!DGRAD) {
          v0 = __fmul_rn(v0, w_s[col]);
          v1 = __fmul_rn(v1, w_s[col + 1]);
        }
        const size_t o = (size_t)row * N + col;
        i8::stf<OUT_BF16>(out, o, v0);
        i8::stf<OUT_BF16>(out, o + 1, v1);
      }
    }
}

}  // namespace

extern "C" int int8_rowquant(const void* x, int x_bf16, const float* colscale,
                             int8_t* q, float* s, int M, int K, cudaStream_t stream) {
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + 7) / 8);
  if (x_bf16)
    rowquant_kernel<true><<<grid, 256, 0, stream>>>(x, colscale, q, s, M, K);
  else
    rowquant_kernel<false><<<grid, 256, 0, stream>>>(x, colscale, q, s, M, K);
  return (int)cudaGetLastError();
}

// out (M, N) = (a (M, K) . B) * s_row [* w_s]; B = w (K, N) if !dgrad, else
// w^T with w (N, K). K % 16 == 0 and N % 16 == 0; 16-byte aligned buffers.
extern "C" int int8_gemm(const int8_t* a, const float* s_row, const int8_t* w,
                         const float* w_s, void* out, int out_bf16, int M, int N,
                         int K, int dgrad, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % 16 || (!dgrad && !w_s))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (dgrad) {
    if (out_bf16)
      gemm_kernel<true, true><<<grid, THREADS, 0, stream>>>(a, s_row, w, w_s, out, M, N, K);
    else
      gemm_kernel<true, false><<<grid, THREADS, 0, stream>>>(a, s_row, w, w_s, out, M, N, K);
  } else {
    if (out_bf16)
      gemm_kernel<false, true><<<grid, THREADS, 0, stream>>>(a, s_row, w, w_s, out, M, N, K);
    else
      gemm_kernel<false, false><<<grid, THREADS, 0, stream>>>(a, s_row, w, w_s, out, M, N, K);
  }
  return (int)cudaGetLastError();
}
