// K1: packed-layout non-causal multi-head attention, forward (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of agacs_tpu/ops/flash_train.py
// (`packed_flash_mha` -> `_fwd_pallas`), the whisper encoder's
// self-attention. Same math: q * d_head^-0.5 (x0.125, exact in bf16),
// float32 scores, max-subtracted exp, the UN-normalized p cast to bf16 for
// the value product with float32 accumulation, division by the row sum at
// the end.
//
// What bounds it here: at the encoder shape (B=8, T=750, 12 heads of 64)
// a call is 2*2*B*H*T*T*64 = 13.8 GFLOP against 4*B*T*768*2 = 37 MB of
// q/k/v/o, so it is compute-bound on the tensor cores. The TPU kernel kept
// a head group's whole (T, T) score block in VMEM; a Hopper SM has 227 KB
// of shared memory, so this kernel streams 64-key tiles with an online
// softmax (running f32 max m and sum l per row) instead and never holds
// more than a (64, 64) score tile. That reorders the f32 sums relative to
// the TPU's whole-row softmax, which with the bf16 cast of p is why it is
// compared with its plain version under a tolerance.
//
// Design: one block of 4 warps per (64-row q tile, head, batch row). It
// reads q/k/v straight from the packed (B, T, H*64) layout at column h*64
// with row stride H*64 (no head-split transposes), with 16-byte loads.
// Each warp owns 16 q rows; the score and value products are bf16
// tensor-core tiles (nvcuda::wmma 16x16x16, f32 accumulation); each pair
// of lanes runs the softmax of one row. The key tail (T = 750 is not a
// multiple of 64) is masked to -inf. wgmma, TMA and a deeper pipeline are
// later work: this version is the simple, correct one.
//
// Under autograd the kernel also writes each row's f32 log-sum-exp,
// lse = m + log(l), to a (B, H, T) buffer: the row statistics that the
// backward kernel (packed_flash_bwd.cu) recomputes p from. The serving
// path passes a null pointer and writes nothing extra.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 64;       // head width
constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // keys per tile
constexpr int WARPS = 4;     // each warp owns 16 q rows
constexpr int THREADS = WARPS * 32;
constexpr int SLD = BK + 4;  // f32 score-row stride (fewer bank conflicts)
constexpr int PLD = BK + 8;  // bf16 p-row stride

struct Smem {
  bf16 q[BQ * DH];
  bf16 k[BK * DH];
  bf16 v[BK * DH];
  float s[WARPS][16 * SLD];  // scores, then the P.V tile
  bf16 p[WARPS][16 * PLD];
};

// Copy rows [row0, row0 + 64) x 64 columns of a row-major matrix with
// leading dimension ld into a dense (64, 64) tile; rows >= rows are zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int rows, int ld) {
  for (int i = threadIdx.x; i < 64 * 8; i += THREADS) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * DH + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
packed_flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int T, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const size_t base = (size_t)b * T * D + (size_t)h * DH;

  load_tile(sm.q, q + base, q0, T, D);
  __syncthreads();
  for (int i = tid; i < BQ * DH; i += THREADS)
    sm.q[i] = __float2bfloat16(__bfloat162float(sm.q[i]) * scale);

  const int r = lane >> 1;         // this lane's row within the warp's 16
  const int c0 = (lane & 1) * 32;  // and its half of the 64 columns
  float* s_w = sm.s[warp];
  bf16* p_w = sm.p[warp];
  const bf16* q_w = sm.q + warp * 16 * DH;
  float m_i = -INFINITY, l_i = 0.f;
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // q scaled; the previous tile's k/v reads are done
    load_tile(sm.k, k + base, k0, T, D);
    load_tile(sm.v, v + base, k0, T, D);
    __syncthreads();

    // S (16 x 64) = q_w . k^T
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(af, q_w + kt * 16, DH);
        wmma::load_matrix_sync(bfr, sm.k + nt * 16 * DH + kt * 16, DH);
        wmma::mma_sync(sf, af, bfr, sf);
      }
      wmma::store_matrix_sync(s_w + nt * 16, sf, SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile for row r (two lanes per row)
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float x = (k0 + c0 + j < T) ? s_w[r * SLD + c0 + j] : -INFINITY;
      sv[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);  // finite: key 0 is always valid
    const float alpha = expf(m_i - m_new);  // 0 on the first tile
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float e = expf(sv[j] - m_new);
      sum += e;
      p_w[r * PLD + c0 + j] = __float2bfloat16(e);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    __syncwarp();

    // P.V (16 x 64) = p_w (bf16) . v, f32 accumulation, into s_w
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(af, p_w + kt * 16, PLD);
        wmma::load_matrix_sync(bfr, sm.v + kt * 16 * DH + nt * 16, DH);
        wmma::mma_sync(of, af, bfr, of);
      }
      wmma::store_matrix_sync(s_w + nt * 16, of, SLD, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = acc[j] * alpha + s_w[r * SLD + c0 + j];
    __syncwarp();
  }

  const int row = q0 + warp * 16 + r;
  if (row < T) {
    bf16* dst = o + base + (size_t)row * D + c0;
#pragma unroll
    for (int j = 0; j < 32; j += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + j) =
          __floats2bfloat162_rn(acc[j] / l_i, acc[j + 1] / l_i);
    if (lse != nullptr && (lane & 1) == 0)
      lse[((size_t)b * H + h) * T + row] = m_i + logf(l_i);
  }
}

}  // namespace

// q, k, v, o: (B, T, H*64) bf16, contiguous, 16-byte aligned; lse: null,
// or (B, H, T) f32. Returns cudaGetLastError() after the launch.
extern "C" int packed_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int T, int H,
                                void* stream) {
  const int smem = (int)sizeof(Smem);  // 51200 bytes: above the 48 KB default
  // Set on every launch: the attribute is per device, and it is cheap.
  const cudaError_t attr = cudaFuncSetAttribute(
      packed_flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  packed_flash_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, T,
      H, 0.125f /* 64^-0.5 */);
  return (int)cudaGetLastError();
}
