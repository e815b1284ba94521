// Shared pieces of the hand-written int8 kernels: the m16n8k32 s8
// tensor-core product (mma.sync, int32 accumulators), its fragment loads
// from shared memory and the staging of int8 tiles into shared memory
// (int8_gemm.cu), and JAX's quantisation arithmetic, by division and by a
// correctly rounded reciprocal (int8_gemm.cu and int8_mlp.cu;
// agacs_tpu/ops/int8_linear.py `_row_quant`,
// agacs_tpu/ops/int8_mlp.py `_rowq`, `_erf`, `_gelu`, `_dgelu`).
//
// The s8 mma takes A row-major and B "col" (each column's 32 k values
// contiguous): B is staged in shared memory as Bt[n][k]. The JAX layout of
// a quantised weight is w_q (d_in, d_out) row-major, so a product over d_in
// (the forward) stages it through a 4x4 byte transpose (`stage_trans`), and
// a product over d_out (the dgrad, w_q^T) copies its rows as they are
// (`stage_rows`): one buffer serves both directions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace i8 {

// c += a (16x32 s8, row) * b (32x8 s8, col), int32.
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment: rows 0-15, k 0-31 of a row-major int8 tile (stride lda bytes).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* A, int lda,
                                       int lane) {
  const int8_t* p = A + (lane >> 2) * lda + 4 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 16);
}

// B fragment: k 0-31 of columns 0-7, from Bt[n][k] (stride ldb bytes).
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const int8_t* Bt, int ldb,
                                       int lane) {
  const int8_t* p = Bt + (lane >> 2) * ldb + 4 * (lane & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 16);
}

// Rows [r0, r0+ROWS) x bytes [c0, c0+COLS) of a row-major int8 matrix
// (n_rows x n_cols, row stride ld bytes, a multiple of 16) into dst (stride
// ldd), 16 bytes per load, zero past the matrix's edges (n_cols % 16 == 0).
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_rows(int8_t* dst, int ldd, const int8_t* src,
                                           int ld, int r0, int n_rows, int c0,
                                           int n_cols, int tid, int nthr) {
  constexpr int CH = COLS / 16;
  for (int i = tid; i < ROWS * CH; i += nthr) {
    const int r = i / CH, c = (i % CH) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (r0 + r < n_rows && c0 + c < n_cols)
      v = *reinterpret_cast<const int4*>(src + (size_t)(r0 + r) * ld + c0 + c);
    *reinterpret_cast<int4*>(dst + r * ldd + c) = v;
  }
}

// Bt[n][k] for k in [k0, k0+BK), n in [n0, n0+BN) of a row-major int8
// matrix w (n_k x n_n, row stride ld bytes): each thread reads a 4 (k) x 4
// (n) block as four 32-bit words and transposes it with byte permutes.
template <int BK, int BN>
__device__ __forceinline__ void stage_trans(int8_t* Bt, int ldb, const int8_t* w,
                                            int ld, int k0, int n_k, int n0, int n_n,
                                            int tid, int nthr) {
  constexpr int NB = BN / 4;
  for (int i = tid; i < (BK / 4) * NB; i += nthr) {
    const int kb = (i / NB) * 4, nb = (i % NB) * 4;
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + kb + j;
      r[j] = (k < n_k && n0 + nb < n_n)
                 ? *reinterpret_cast<const uint32_t*>(w + (size_t)k * ld + n0 + nb)
                 : 0u;
    }
    const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
    int8_t* d = Bt + nb * ldb + kb;
    *reinterpret_cast<uint32_t*>(d) = __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<uint32_t*>(d + ldb) = __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<uint32_t*>(d + 2 * ldb) = __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<uint32_t*>(d + 3 * ldb) = __byte_perm(hi01, hi23, 0x7632);
  }
}

template <bool BF16>
__device__ __forceinline__ float ldf(const void* p, size_t i) {
  if constexpr (BF16)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  else
    return reinterpret_cast<const float*>(p)[i];
}

template <bool BF16>
__device__ __forceinline__ void stf(void* p, size_t i, float v) {
  if constexpr (BF16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

// JAX's per-row scale and value: s = max(max|x|, 1e-12) / 127, q = round(x / s)
// (round half to even, IEEE division; |x| / s <= 127 by construction).
__device__ __forceinline__ float quant_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
}
__device__ __forceinline__ int8_t quant(float v, float s) {
  return (int8_t)__float2int_rn(__fdiv_rn(v, s));
}

// quant(v, s) given y = 1/s correctly rounded: RN(v y) refined by two FMA
// corrections is RN(v / s) for a normal s and |v / s| <= 127 (a row's own
// scale), the IEEE quotient without the division's slow-path branch, so
// the int8 (returned as its byte) is quant's.
__device__ __forceinline__ uint32_t quant_by(float v, float s, float y) {
  float q = __fmul_rn(v, y);
  q = __fmaf_rn(__fmaf_rn(-q, s, v), y, q);
  q = __fmaf_rn(__fmaf_rn(-q, s, v), y, q);
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(q);
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Abramowitz-Stegun 7.1.26 erf and the exact-erf GELU and its derivative,
// operation for operation as int8_mlp.py `_erf`/`_gelu`/`_dgelu` (the _rn
// intrinsics keep nvcc from fusing a product and a sum into one rounding).
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = __frcp_rn(__fadd_rn(1.0f, __fmul_rn(0.3275911f, ax)));  // RN(1 / .)
  float poly = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  poly = __fadd_rn(1.421413741f, __fmul_rn(t, poly));
  poly = __fadd_rn(-0.284496736f, __fmul_rn(t, poly));
  poly = __fadd_rn(0.254829592f, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  const float y = __fsub_rn(1.0f, __fmul_rn(poly, expf(__fmul_rn(-ax, ax))));
  const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return __fmul_rn(sgn, y);
}

constexpr float RSQRT2 = 0.70710678118654752f;   // 2 ** -0.5
constexpr float RSQRT2PI = 0.398942280401432678f;  // 1 / sqrt(2 pi)

__device__ __forceinline__ float gelu(float h) {
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.0f, erf_as(__fmul_rn(h, RSQRT2))));
}

__device__ __forceinline__ float dgelu(float h) {
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, erf_as(__fmul_rn(h, RSQRT2))));
  const float pdf = __fmul_rn(expf(__fmul_rn(__fmul_rn(-0.5f, h), h)), RSQRT2PI);
  return __fadd_rn(cdf, __fmul_rn(h, pdf));
}

}  // namespace i8
