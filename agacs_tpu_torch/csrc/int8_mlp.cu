// K2: the fused W8A8 MLP of the frozen int8 trunk, fc2(gelu(fc1(x))), and
// its dx, as two hand-written sm_90a kernels.
//
// Replaces agacs_tpu/ops/int8_mlp.py `_run` (:151, pallas_call :165):
//   K2f `_fwd_pallas` (:180, kernel `_fwd_kernel` :112) and
//   K2b `_bwd_pallas` (:187, kernel `_bwd_kernel` :126):
//
//   K2f: xq, sx = rowq(x); h = (xq.w1q) sx s1 + b1; g = gelu(h) (f32, A-S erf);
//        gq, sg = rowq(g); y = (gq.w2q) sg s2 + b2
//   K2b: h as above; dq, sd = rowq(dy s2); dg = (dq.w2q^T) sd gelu'(h) s1;
//        gq, sg = rowq(dg); dx = (gq.w1q^T) sg
//
// The TPU kernel keeps both int8 weights and a (256, h) f32 hidden block in
// VMEM. On Hopper the obstacle is the hidden row quantisation: it needs the
// whole h-wide row of gelu(h) (or dg) before the second product can start,
// and 64 rows of f32 hidden are 786 KB, far over the 227 KB of shared
// memory. Design: one block of 8 warps per 16-row tile holds that tile's
// f32 hidden (16 x h x 4 = 192 KB at h = 3072) and its int8 input rows in
// dynamic shared memory, and
//   1. row-quantises x (and dy * s2) into shared memory, one warp per 2 rows;
//   2. runs the first product in 256-column (K2b: 128) chunks of the hidden,
//      each warp owning 32 (16) columns, the weight staged 64 k at a time
//      into shared memory (w1q through a byte transpose, w2q^T as its rows),
//      and writes the epilogue (bias, GELU or gelu' and the dy path) as f32;
//   3. takes each row's max, then quantises the hidden to int8 IN PLACE, row
//      after row (row r's h bytes land below f32 row r + 1, after row r has
//      been read into registers), at a 16-byte padded stride;
//   4. runs the second product over the int8 hidden, each warp owning 32
//      (16) output columns.
// The f32 hidden never reaches device memory. The weights are re-read once
// per 16-row tile: 2 x 2.36 MB per tile, ~3.5 GB of L2 traffic at 12,000
// rows for 113 GOP (57 us of int8 tensor time on the H100); the kernel is
// bound by those L2 reads and by its single-buffered staging, not by the
// tensor cores. Levers for a later change: more rows per tile with the
// hidden in int8 (recomputing fc1), weights multicast to a cluster, TMA +
// wgmma. h <= 3072 (the shared-memory budget; whisper-small and smaller).
#include "int8_mma.cuh"

namespace {

constexpr int R = 16, NW = 8, THREADS = NW * 32, HMAX = 3072;
constexpr int BK = 64, LDB = BK + 16;
constexpr int F_NCH = 256;  // K2f: hidden / output columns per chunk (32 per warp)
constexpr int B_NCH = 128;  // K2b: 16 per warp, two products per chunk

__host__ __device__ constexpr size_t smem_bytes(int d, int h, bool bwd) {
  return (size_t)R * h * 4 + (size_t)(bwd ? 2 : 1) * R * (d + 16) +
         (size_t)(bwd ? B_NCH : F_NCH) * LDB + (bwd ? 3 : 2) * R * 4;
}

// Row-quantise rows [n0, n0+R) of x (n, d) (times colscale when given) into
// q (R, ldq) and s (R,); rows past n quantise zeros. One warp per 2 rows.
template <bool BF16>
__device__ void quant_rows(const void* x, const float* cs, int8_t* q, int ldq, float* s,
                           int n0, int n, int d, int warp, int lane) {
  for (int r = warp; r < R; r += NW) {
    const bool valid = n0 + r < n;
    const size_t base = (size_t)(n0 + r) * d;
    float m = 0.f;
    if (valid)
      for (int c = lane; c < d; c += 32) {
        float v = i8::ldf<BF16>(x, base + c);
        if (cs) v = __fmul_rn(v, cs[c]);
        m = fmaxf(m, fabsf(v));
      }
    const float sc = i8::quant_scale(i8::warp_max(m));
    for (int c = lane; c < d; c += 32) {
      float v = 0.f;
      if (valid) {
        v = i8::ldf<BF16>(x, base + c);
        if (cs) v = __fmul_rn(v, cs[c]);
      }
      q[r * ldq + c] = i8::quant(v, sc);
    }
    if (lane == 0) s[r] = sc;
  }
}

// Steps 3: per-row max of the f32 hidden (each thread's partial maxima for
// rows g and g + 8 of its warp's columns), then in-place int8 quantisation
// to stride h + 16. `red` is NW x R floats of scratch.
__device__ void quant_hidden(float* hid, int h, const float (&pm)[2], float* red,
                             float* sg, int warp, int lane, int tid) {
  float m0 = pm[0], m1 = pm[1];
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  if ((lane & 3) == 0) {
    red[warp * R + (lane >> 2)] = m0;
    red[warp * R + (lane >> 2) + 8] = m1;
  }
  __syncthreads();
  if (tid < R) {
    float m = 0.f;
    for (int w = 0; w < NW; ++w) m = fmaxf(m, red[w * R + tid]);
    sg[tid] = i8::quant_scale(m);
  }
  __syncthreads();
  int8_t* q = reinterpret_cast<int8_t*>(hid);
  for (int r = 0; r < R; ++r) {
    float v[HMAX / THREADS];
#pragma unroll
    for (int i = 0; i < HMAX / THREADS; ++i) {
      const int c = tid + i * THREADS;
      v[i] = c < h ? hid[r * h + c] : 0.f;
    }
    __syncthreads();  // row r read by every thread before its bytes are overwritten
    const float sc = sg[r];
#pragma unroll
    for (int i = 0; i < HMAX / THREADS; ++i) {
      const int c = tid + i * THREADS;
      if (c < h) q[r * (h + 16) + c] = i8::quant(v[i], sc);
    }
    __syncthreads();
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1) mlp_fwd_kernel(
    const void* __restrict__ x, const int8_t* __restrict__ w1q, const float* __restrict__ s1,
    const float* __restrict__ b1, const int8_t* __restrict__ w2q,
    const float* __restrict__ s2, const float* __restrict__ b2, void* __restrict__ y,
    int n, int d, int h) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hid = reinterpret_cast<float*>(smem);                       // R x h f32
  int8_t* xq = reinterpret_cast<int8_t*>(smem + (size_t)R * h * 4);  // R x (d+16)
  int8_t* bt = xq + R * (d + 16);                                    // F_NCH x LDB
  float* sx = reinterpret_cast<float*>(bt + F_NCH * LDB);
  float* sg = sx + R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * R, ldx = d + 16, ldh = h + 16;

  quant_rows<BF16>(x, nullptr, xq, ldx, sx, n0, n, d, warp, lane);

  float pm[2] = {0.f, 0.f};
  for (int nc = 0; nc < h; nc += F_NCH) {
    int acc[4][4] = {};
    for (int k0 = 0; k0 < d; k0 += BK) {
      __syncthreads();
      i8::stage_trans<BK, F_NCH>(bt, LDB, w1q, h, k0, d, nc, h, tid, THREADS);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t af[4];
        i8::load_a(af, xq + k0 + kk, ldx, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bf[2];
          i8::load_b(bf, bt + (warp * 32 + 8 * j) * LDB + kk, LDB, lane);
          i8::mma(acc[j], af, bf);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1), col = nc + warp * 32 + 8 * j + 2 * t + (e & 1);
        if (col >= h) continue;
        const float hv = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[j][e], sx[row]), s1[col]),
                                   b1[col]);
        const float gv = i8::gelu(hv);
        hid[row * h + col] = gv;
        pm[e >> 1] = fmaxf(pm[e >> 1], fabsf(gv));
      }
  }
  __syncthreads();
  quant_hidden(hid, h, pm, reinterpret_cast<float*>(bt), sg, warp, lane, tid);
  const int8_t* hq = reinterpret_cast<const int8_t*>(hid);

  for (int nc = 0; nc < d; nc += F_NCH) {
    int acc[4][4] = {};
    for (int k0 = 0; k0 < h; k0 += BK) {
      __syncthreads();
      i8::stage_trans<BK, F_NCH>(bt, LDB, w2q, d, k0, h, nc, d, tid, THREADS);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t af[4];
        i8::load_a(af, hq + k0 + kk, ldh, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bf[2];
          i8::load_b(bf, bt + (warp * 32 + 8 * j) * LDB + kk, LDB, lane);
          i8::mma(acc[j], af, bf);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1), col = nc + warp * 32 + 8 * j + 2 * t + (e & 1);
        if (col >= d || n0 + row >= n) continue;
        const float v = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[j][e], sg[row]), s2[col]),
                                  b2[col]);
        i8::stf<BF16>(y, (size_t)(n0 + row) * d + col, v);
      }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1) mlp_bwd_kernel(
    const void* __restrict__ x, const int8_t* __restrict__ w1q, const float* __restrict__ s1,
    const float* __restrict__ b1, const int8_t* __restrict__ w2q,
    const float* __restrict__ s2, const void* __restrict__ dy, void* __restrict__ dx,
    int n, int d, int h) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hid = reinterpret_cast<float*>(smem);                       // R x h f32
  int8_t* xq = reinterpret_cast<int8_t*>(smem + (size_t)R * h * 4);  // R x (d+16)
  int8_t* dq = xq + R * (d + 16);                                    // R x (d+16)
  int8_t* bt = dq + R * (d + 16);                                    // B_NCH x LDB
  float* sx = reinterpret_cast<float*>(bt + B_NCH * LDB);
  float* sd = sx + R;
  float* sg = sd + R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * R, ldx = d + 16, ldh = h + 16;

  quant_rows<BF16>(x, nullptr, xq, ldx, sx, n0, n, d, warp, lane);
  quant_rows<BF16>(dy, s2, dq, ldx, sd, n0, n, d, warp, lane);

  float pm[2] = {0.f, 0.f};
  for (int nc = 0; nc < h; nc += B_NCH) {
    int acc1[2][4] = {}, accd[2][4] = {};
    for (int k0 = 0; k0 < d; k0 += BK) {  // h = x . w1q (w1q (d, h): transposed staging)
      __syncthreads();
      i8::stage_trans<BK, B_NCH>(bt, LDB, w1q, h, k0, d, nc, h, tid, THREADS);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t af[4];
        i8::load_a(af, xq + k0 + kk, ldx, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bf[2];
          i8::load_b(bf, bt + (warp * 16 + 8 * j) * LDB + kk, LDB, lane);
          i8::mma(acc1[j], af, bf);
        }
      }
    }
    for (int k0 = 0; k0 < d; k0 += BK) {  // dy . w2q^T (w2q (h, d) rows are Bt)
      __syncthreads();
      i8::stage_rows<B_NCH, BK>(bt, LDB, w2q, d, nc, h, k0, d, tid, THREADS);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t af[4];
        i8::load_a(af, dq + k0 + kk, ldx, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bf[2];
          i8::load_b(bf, bt + (warp * 16 + 8 * j) * LDB + kk, LDB, lane);
          i8::mma(accd[j], af, bf);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1), col = nc + warp * 16 + 8 * j + 2 * t + (e & 1);
        if (col >= h) continue;
        const float hv = __fadd_rn(__fmul_rn(__fmul_rn((float)acc1[j][e], sx[row]), s1[col]),
                                   b1[col]);
        float dg = __fmul_rn(__fmul_rn((float)accd[j][e], sd[row]), i8::dgelu(hv));
        dg = __fmul_rn(dg, s1[col]);
        hid[row * h + col] = dg;
        pm[e >> 1] = fmaxf(pm[e >> 1], fabsf(dg));
      }
  }
  __syncthreads();
  quant_hidden(hid, h, pm, reinterpret_cast<float*>(bt), sg, warp, lane, tid);
  const int8_t* gq = reinterpret_cast<const int8_t*>(hid);

  for (int nc = 0; nc < d; nc += B_NCH) {  // dx = gq . w1q^T (w1q (d, h) rows are Bt)
    int acc[2][4] = {};
    for (int k0 = 0; k0 < h; k0 += BK) {
      __syncthreads();
      i8::stage_rows<B_NCH, BK>(bt, LDB, w1q, h, nc, d, k0, h, tid, THREADS);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t af[4];
        i8::load_a(af, gq + k0 + kk, ldh, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bf[2];
          i8::load_b(bf, bt + (warp * 16 + 8 * j) * LDB + kk, LDB, lane);
          i8::mma(acc[j], af, bf);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1), col = nc + warp * 16 + 8 * j + 2 * t + (e & 1);
        if (col >= d || n0 + row >= n) continue;
        i8::stf<BF16>(dx, (size_t)(n0 + row) * d + col,
                      __fmul_rn((float)acc[j][e], sg[row]));
      }
  }
}

template <typename K>
int launch_setup(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

bool bad_shape(int n, int d, int h, bool bwd) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return n <= 0 || d <= 0 || h <= 0 || d % 128 || h % 128 || h > HMAX ||
         smem_bytes(d, h, bwd) > (size_t)max_smem;
}

}  // namespace

extern "C" int int8_mlp_fwd(const void* x, int x_bf16, const int8_t* w1q, const float* s1,
                            const float* b1, const int8_t* w2q, const float* s2,
                            const float* b2, void* y, int n, int d, int h,
                            cudaStream_t stream) {
  if (bad_shape(n, d, h, false)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d, h, false);
  const dim3 grid((n + R - 1) / R);
  int rc;
  if (x_bf16) {
    if ((rc = launch_setup(mlp_fwd_kernel<true>, smem))) return rc;
    mlp_fwd_kernel<true><<<grid, THREADS, smem, stream>>>(x, w1q, s1, b1, w2q, s2, b2, y, n, d, h);
  } else {
    if ((rc = launch_setup(mlp_fwd_kernel<false>, smem))) return rc;
    mlp_fwd_kernel<false><<<grid, THREADS, smem, stream>>>(x, w1q, s1, b1, w2q, s2, b2, y, n, d, h);
  }
  return (int)cudaGetLastError();
}

extern "C" int int8_mlp_bwd(const void* x, int x_bf16, const int8_t* w1q, const float* s1,
                            const float* b1, const int8_t* w2q, const float* s2,
                            const void* dy, void* dx, int n, int d, int h,
                            cudaStream_t stream) {
  if (bad_shape(n, d, h, true)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d, h, true);
  const dim3 grid((n + R - 1) / R);
  int rc;
  if (x_bf16) {
    if ((rc = launch_setup(mlp_bwd_kernel<true>, smem))) return rc;
    mlp_bwd_kernel<true><<<grid, THREADS, smem, stream>>>(x, w1q, s1, b1, w2q, s2, dy, dx, n, d, h);
  } else {
    if ((rc = launch_setup(mlp_bwd_kernel<false>, smem))) return rc;
    mlp_bwd_kernel<false><<<grid, THREADS, smem, stream>>>(x, w1q, s1, b1, w2q, s2, dy, dx, n, d, h);
  }
  return (int)cudaGetLastError();
}
