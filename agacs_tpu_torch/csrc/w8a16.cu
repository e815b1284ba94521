// K6: the weight-only int8 (W8A16) matmul of thin-row serving (sm_90a).
//
// Replaces agacs_tpu/ops/int8_serve.py `_w8a16_2d` / `_kernel` (:64-94):
//   y = x . bf16(f32(w_q) * w_s)   x (M, K) bf16, w_q (K, N) int8 row-major,
//                                  w_s (N,) f32, y (M, N) bf16.
// Each weight value is dequantised on chip, in float32, with its column's
// scale and rounded to bf16 before the dot (the TPU kernel's `wt`); the
// dot is bf16 mma.sync with float32 accumulation and the output is rounded
// to bf16 once. Rows past M are zero in shared memory (JAX pads x to a
// multiple of 8 rows) and are never written.
//
// What bounds it on the H100: the weight's bytes. A decode step's 8 rows
// do 2 * 8 = 16 operations per weight byte, far below the card's ~295
// FLOP/byte ridge: (768, 768) is 0.59 MB (0.18 us at 3.35 TB/s), fc1 and
// fc2 2.36 MB (0.70 us), the padded logits head (768, 52224) 40.1 MB
// (12.0 us; its bf16 table would be twice that). So the design reads each
// weight byte once, in 16-byte loads, and keeps enough blocks in flight to
// cover the 132 SMs even at N = 768: a block owns 32 output columns (4
// warps x 8) and up to 64 rows, and the wrapper splits K over gridDim.y
// until there are at least 264 blocks; the float32 partials of a split
// then meet in a second pass (`splitk_reduce`), summed in split order.
// Per 128-row stage a thread loads the int8 of two k rows x 16 columns,
// dequantises them and stores them as (k, k+1) bf16 pairs in a [n][k]
// tile, so each B fragment is two 32-bit shared loads; x's stage is staged
// row-major [m][k]. No double buffering, TMA or wgmma yet: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BN = 32;          // output columns per block (4 warps x 8)
constexpr int KT = 128;         // k rows per shared-memory stage
constexpr int MR = 64;          // rows of x per block (4 m16 tiles)
constexpr int THREADS = 128;
constexpr int LDX = KT + 8;     // bf16 per staged x row: 272 bytes, no bank conflicts
constexpr int LDW = KT + 8;     // bf16 per staged weight column [n][k]

// c += a (16x16 bf16, row) * b (16x8 bf16, col), float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): columns [32x, 32x + 32),
// k [y * k_split, (y + 1) * k_split) and rows [64z, 64z + 64). PARTIAL:
// float32 partials into part[y] (M, N); else bf16 y directly.
template <bool PARTIAL>
__global__ void __launch_bounds__(THREADS)
w8a16_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ w_s, bf16* __restrict__ y,
             float* __restrict__ part, int M, int N, int K, int k_split) {
  __shared__ __align__(16) bf16 sx[MR * LDX];
  __shared__ __align__(16) bf16 sw[BN * LDW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * MR;
  const int k_begin = blockIdx.y * k_split, k_end = min(K, k_begin + k_split);
  const int rows = min(MR, M - m0);
  const int mt = (rows + 15) >> 4;  // m16 tiles holding rows

  // this thread's weight slice of a stage: k rows 2p, 2p + 1, columns c..c+15
  const int p = tid >> 1, c = (tid & 1) * 16;
  const bool col_ok = n0 + c < N;  // N % 16 == 0: a slice is all in or all out
  float sc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) sc[j] = col_ok ? w_s[n0 + c + j] : 0.f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += KT) {
    for (int i = tid; i < mt * 16 * (KT / 8); i += THREADS) {
      const int r = i / (KT / 8), kc = (i % (KT / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && k0 + kc < k_end)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + kc);
      *reinterpret_cast<uint4*>(sx + r * LDX + kc) = v;
    }
    {
      const int ka = k0 + 2 * p;
      int4 ra = make_int4(0, 0, 0, 0), rb = make_int4(0, 0, 0, 0);
      if (col_ok && ka < k_end)
        ra = *reinterpret_cast<const int4*>(w + (size_t)ka * N + n0 + c);
      if (col_ok && ka + 1 < k_end)
        rb = *reinterpret_cast<const int4*>(w + (size_t)(ka + 1) * N + n0 + c);
      const int8_t* a8 = reinterpret_cast<const int8_t*>(&ra);
      const int8_t* b8 = reinterpret_cast<const int8_t*>(&rb);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        // f32(w_q) * w_s in float32, then one rounding to bf16
        const __nv_bfloat162 pr = __floats2bfloat162_rn(__fmul_rn((float)a8[j], sc[j]),
                                                        __fmul_rn((float)b8[j], sc[j]));
        *reinterpret_cast<__nv_bfloat162*>(sw + (c + j) * LDW + 2 * p) = pr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      const bf16* bp = sw + (warp * 8 + g) * LDW + kk + 2 * t;
      const uint32_t b[2] = {ld32(bp), ld32(bp + 8)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < mt) {
          const bf16* ap = sx + (i * 16 + g) * LDX + kk + 2 * t;
          const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * LDX), ld32(ap + 8),
                                 ld32(ap + 8 * LDX + 8)};
          mma_bf16(acc[i], a, b);
        }
      }
    }
    __syncthreads();
  }

  const int col = n0 + warp * 8 + 2 * t;
  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = i * 16 + g + 8 * hh;
      if (i >= mt || r >= rows) continue;
      const size_t o = (size_t)(m0 + r) * N + col;
      if (PARTIAL)
        *reinterpret_cast<float2*>(part + (size_t)blockIdx.y * M * N + o) =
            make_float2(acc[i][2 * hh], acc[i][2 * hh + 1]);
      else
        *reinterpret_cast<__nv_bfloat162*>(y + o) =
            __floats2bfloat162_rn(acc[i][2 * hh], acc[i][2 * hh + 1]);
    }
  }
}

// y = bf16(sum over the S splits' float32 partials, in split order).
__global__ void __launch_bounds__(256)
splitk_reduce(const float* __restrict__ part, bf16* __restrict__ y, int S, size_t mn) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int j = 1; j < S; ++j) s += part[(size_t)j * mn + i];
    y[i] = __float2bfloat16_rn(s);
  }
}

}  // namespace

// y (M, N) bf16 = x (M, K) bf16 . bf16(w_q (K, N) int8 * w_s (N,) f32).
// K % 16 == 0, N % 16 == 0, 16-byte aligned contiguous buffers. splits >
// 1 splits K into that many ranges of whole 128-row stages and needs
// `work`, (splits, M, N) float32. Returns cudaGetLastError() after the
// launches.
extern "C" int w8a16_matmul(const void* x, const void* w_q, const void* w_s, void* y,
                            void* work, int M, int N, int K, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % 16 || splits < 1 ||
      (splits > 1 && !work))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int chunks = (K + KT - 1) / KT;
  const int k_split = ((chunks + splits - 1) / splits) * KT;
  const dim3 grid((N + BN - 1) / BN, splits, (M + MR - 1) / MR);
  if (splits == 1) {
    w8a16_kernel<false><<<grid, THREADS, 0, s>>>(
        (const bf16*)x, (const int8_t*)w_q, (const float*)w_s, (bf16*)y, nullptr, M, N, K,
        k_split);
    return (int)cudaGetLastError();
  }
  w8a16_kernel<true><<<grid, THREADS, 0, s>>>(
      (const bf16*)x, (const int8_t*)w_q, (const float*)w_s, nullptr, (float*)work, M, N,
      K, k_split);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 1024 ? (mn + 255) / 256 : 1024);
  splitk_reduce<<<blocks, 256, 0, s>>>((const float*)work, (bf16*)y, splits, mn);
  return (int)cudaGetLastError();
}
