// Shared pieces of the hand-written int8 kernels: the m16n8k32 s8
// tensor-core product (mma.sync, int32 accumulators; int8_gemm.cu's thin
// kernel) and JAX's quantisation arithmetic, by division and by a correctly
// rounded reciprocal (int8_gemm.cu and int8_mlp.cu;
// agacs_tpu/ops/int8_linear.py `_row_quant`,
// agacs_tpu/ops/int8_mlp.py `_rowq`, `_erf`, `_gelu`, `_dgelu`).
//
// The s8 mma takes A row-major and B "col" (each column's 32 k values
// contiguous).
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

template <bool BF16>
__device__ __forceinline__ void stf(void* p, size_t i, float v) {
  if constexpr (BF16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

// JAX's per-row scale: s = max(max|x|, 1e-12) / 127 (IEEE division).
__device__ __forceinline__ float quant_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
}

// JAX's quotient v / s (|v| / s <= 127 by construction), given y = 1/s
// correctly rounded: RN(v y) refined by two FMA corrections is RN(v / s)
// for a normal s and |v / s| <= 127 (a row's own scale), the IEEE quotient
// without the division's slow-path branch.
__device__ __forceinline__ float quotient(float v, float s, float y) {
  float q = __fmul_rn(v, y);
  q = __fmaf_rn(__fmaf_rn(-q, s, v), y, q);
  q = __fmaf_rn(__fmaf_rn(-q, s, v), y, q);
  return q;
}

// JAX's value q = round(v / s) (round half to even), as its byte.
__device__ __forceinline__ uint32_t quant_by(float v, float s, float y) {
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(quotient(v, s, y));
}

// The same q as the bits of quotient + 1.5 x 2^23: the add rounds half to
// even onto an integer (|q| <= 127) whose two's complement byte is the bits'
// low byte; one full-rate add instead of a quarter-rate conversion.
__device__ __forceinline__ uint32_t quant_bits(float v, float s, float y) {
  return __float_as_uint(__fadd_rn(quotient(v, s, y), 12582912.0f));
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
