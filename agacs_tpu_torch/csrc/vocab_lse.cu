// K4: streaming log-sum-exp over a vocabulary projection, forward and
// backward (sm_90a).
//
// Replaces the TPU kernels of agacs_tpu/ops/vocab_lse.py (`streaming_lse`
// -> `_fwd_pallas` `_fwd_kernel`, `_bwd_pallas` `_dx_kernel` and
// `_dw_kernel`), the CTC head's normaliser: for rows x (N, K) bf16, W
// (K, V) bf16 and b (V,) f32,
//
//   z    = x . W + b                     (f32 accumulation, never stored)
//   lse  = log sum_v exp(z[:, v])        (N,) f32
//   dz   = exp(z - lse) * g              g = d loss / d lse, (N,) f32
//   dx   = bf16(dz) . W^T                (N, K), f32 accumulation, bf16 out
//   dW   = x^T . bf16(dz)                (K, V) f32 (the caller casts it)
//   db   = sum over rows of dz           (V,) f32
//
// What bounds it: at the conformer's training shape (N = 16 x 468 = 7488
// rows, K 256, V 51865) each z is 2*N*K*V = 199 GFLOP against ~31 MB of
// x, W and b, so the tensor cores bound all three (0.20 ms for the forward
// at 989 TFLOP/s; dx and dW each recompute z: 0.40 ms). The point of the
// kernel is what it keeps out of device memory: the (N, V) float32 logits
// are 1.55 GB.
//
// Design. The TPU kernels tile rows x V (512 x up to 2048) with the whole
// x block and W tile in VMEM, and carry dx and dW in scratch across their
// sequential grid axis. Here every block owns 64 rows (forward, dx) or 64
// vocabulary columns (dw) and loops over the other axis itself:
//   * a z tile (64 rows x 64 columns) is computed by 4 warps of 16 rows,
//     bf16 wmma 16x16x16 with f32 accumulation, from the block's x tile
//     (64 x K, resident in shared memory) and 64 x 64 chunks of W streamed
//     through shared memory with 16-byte loads (W's row stride ldw is a
//     multiple of 8: the caller pads W's rows when V is not); columns
//     >= V are masked by index (no -1e30 bias padding) and rows >= N are
//     never written.
//   * forward: grid (row tiles, V splits). Each block sweeps its share of
//     the V tiles with an online (max, sum-exp) per row (two lanes a row)
//     and writes one (m, s) pair per row and split; a second small kernel
//     combines the splits, as the TPU path combines its per-tile partials
//     outside the kernel. The split keeps the card full at N = 7488 (117
//     row tiles for 132 SMs).
//   * dx: grid (row tiles, K / 128). Each block sweeps every V tile,
//     recomputes z, and accumulates bf16(dz) . W[kc:kc+128, tile]^T for its
//     128 columns of dx in registers (8 fragments a warp): z is recomputed
//     K / 128 times, the price of keeping the accumulator in registers.
//   * dw: grid (V tiles, K / 128). Each block sweeps every row tile,
//     recomputes z, and accumulates x[:, kc:kc+128]^T . bf16(dz) for its
//     128 x 64 slice of dW (8 fragments a warp) and, in the kc = 0
//     blocks, the column sums of the f32 dz for db.
// wgmma, TMA and a pipeline are later work: this is the simple, right one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BR = 64;      // rows per tile
constexpr int BV = 64;      // vocabulary columns per tile
constexpr int KC = 64;      // depth of one streamed W chunk
constexpr int CK = 128;     // dx columns / dW rows per block
constexpr int WARPS = 4;    // each warp owns 16 rows (or 32 dW rows)
constexpr int THREADS = WARPS * 32;
constexpr int ZLD = BV + 4;  // f32 z-row stride
constexpr int WLD = BV + 8;  // bf16 W-chunk and dz-row stride

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// Shared memory: the x tile (64 x (K+8) bf16), a W chunk (64 x WLD bf16),
// the z tile (64 x ZLD f32), the dz tile (64 x WLD bf16), and, for dx, the
// W slice of the block's dx columns (128 x WLD bf16).
__host__ __device__ inline size_t x_bytes(int K) { return (size_t)BR * (K + 8) * 2; }
constexpr size_t W_BYTES = (size_t)KC * WLD * 2;
constexpr size_t Z_BYTES = (size_t)BR * ZLD * 4;
constexpr size_t DZ_BYTES = (size_t)BR * WLD * 2;
constexpr size_t WC_BYTES = (size_t)CK * WLD * 2;

struct Bufs {
  bf16* x;
  bf16* w;
  float* z;
  bf16* dz;
  bf16* wc;
};

__device__ __forceinline__ Bufs carve(unsigned char* raw, int K) {
  Bufs s;
  s.x = reinterpret_cast<bf16*>(raw);
  s.w = reinterpret_cast<bf16*>(raw + x_bytes(K));
  s.z = reinterpret_cast<float*>(raw + x_bytes(K) + W_BYTES);
  s.dz = reinterpret_cast<bf16*>(raw + x_bytes(K) + W_BYTES + Z_BYTES);
  s.wc = reinterpret_cast<bf16*>(raw + x_bytes(K) + W_BYTES + Z_BYTES + DZ_BYTES);
  return s;
}

// x rows [r0, r0 + 64) (rows >= N zero) into the (64, K+8) tile.
__device__ __forceinline__ void load_x(bf16* xs, const bf16* x, int r0, int N, int K) {
  const int xld = K + 8, vecs = K / 8;
  for (int i = threadIdx.x; i < BR * vecs; i += THREADS) {
    const int r = i / vecs, c = (i % vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N) val = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * K + c);
    *reinterpret_cast<uint4*>(xs + r * xld + c) = val;
  }
}

// W[k0 : k0 + rows, v0 : v0 + 64] into dst (rows x WLD) from rows of
// stride ldw (a multiple of 8); columns >= ldw read as zero (columns from
// V on are masked later by index).
__device__ __forceinline__ void load_w(bf16* dst, const bf16* W, int ldw, int k0, int rows,
                                       int v0) {
  for (int i = threadIdx.x; i < rows * (BV / 8); i += THREADS) {
    const int r = i / (BV / 8), c = (i % (BV / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (v0 + c < ldw) val = *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * ldw + v0 + c);
    *reinterpret_cast<uint4*>(dst + r * WLD + c) = val;
  }
}

// The z tile of the block's x tile and vocabulary columns [v0, v0 + 64):
// each warp writes its 16 rows of z (f32, stride ZLD), plus the bias, and
// -inf in columns >= V. Starts and ends with a block barrier.
__device__ __forceinline__ void z_tile(const Bufs& s, const bf16* W, int ldw,
                                       const float* bias, int K, int V, int v0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, xld = K + 8;
  Acc acc[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) wmma::fill_fragment(acc[nt], 0.f);
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // the previous chunk's readers are done
    load_w(s.w, W, ldw, k0, KC, v0);
    __syncthreads();
#pragma unroll
    for (int kt = 0; kt < KC / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, s.x + warp * 16 * xld + k0 + kt * 16, xld);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, s.w + kt * 16 * WLD + nt * 16, WLD);
        wmma::mma_sync(acc[nt], af, bfr, acc[nt]);
      }
    }
  }
  float* z_w = s.z + warp * 16 * ZLD;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    wmma::store_matrix_sync(z_w + nt * 16, acc[nt], ZLD, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * BV; i += 32) {
    const int r = i / BV, c = i % BV, col = v0 + c;
    z_w[r * ZLD + c] = col < V ? z_w[r * ZLD + c] + bias[col] : -INFINITY;
  }
  __syncthreads();
}

// dz = exp(z - lse) * g over the z tile (0 in columns >= V and rows >= N;
// g null: 1): bf16 into s.dz; with keep_f32 also f32 back into s.z.
__device__ __forceinline__ void dz_tile(const Bufs& s, const float* lse, const float* g,
                                        int r0, int N, bool keep_f32) {
  for (int i = threadIdx.x; i < BR * BV; i += THREADS) {
    const int r = i / BV, c = i % BV, row = r0 + r;
    const float zv = s.z[r * ZLD + c];
    const float d = (row < N && zv != -INFINITY)
                        ? expf(zv - lse[row]) * (g != nullptr ? g[row] : 1.f) : 0.f;
    s.dz[r * WLD + c] = __float2bfloat16(d);
    if (keep_f32) s.z[r * ZLD + c] = d;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
vocab_lse_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W, int ldw,
                     const float* __restrict__ bias, float* __restrict__ part_m,
                     float* __restrict__ part_s, int N, int K, int V, int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Bufs s = carve(smem_raw, K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * BR, split = blockIdx.y;
  const int n_vt = (V + BV - 1) / BV;
  const int vt0 = split * tiles_per_split, vt1 = min(vt0 + tiles_per_split, n_vt);
  load_x(s.x, x, r0, N, K);

  const int r = lane >> 1, c0 = (lane & 1) * 32;  // two lanes a row
  const float* z_r = s.z + (warp * 16 + r) * ZLD + c0;
  float m = -INFINITY, sum = 0.f;
  for (int vt = vt0; vt < vt1; ++vt) {
    z_tile(s, W, ldw, bias, K, V, vt * BV);
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) mx = fmaxf(mx, z_r[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);  // finite: a tile's first column is < V
    float e = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) e += expf(z_r[j] - m_new);
    e += __shfl_xor_sync(0xffffffffu, e, 1);
    sum = sum * expf(m - m_new) + e;
    m = m_new;
  }
  const int row = r0 + warp * 16 + r;
  if ((lane & 1) == 0 && row < N) {
    part_m[(size_t)split * N + row] = m;
    part_s[(size_t)split * N + row] = sum;
  }
}

__global__ void vocab_lse_combine_kernel(const float* __restrict__ part_m,
                                         const float* __restrict__ part_s,
                                         float* __restrict__ lse, int N, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float m = -INFINITY;
  for (int i = 0; i < splits; ++i) m = fmaxf(m, part_m[(size_t)i * N + row]);
  float sum = 0.f;
  for (int i = 0; i < splits; ++i)
    sum += expf(part_m[(size_t)i * N + row] - m) * part_s[(size_t)i * N + row];
  lse[row] = m + logf(sum);
}

__global__ void __launch_bounds__(THREADS)
vocab_lse_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W, int ldw,
                    const float* __restrict__ bias, const float* __restrict__ lse,
                    const float* __restrict__ g, bf16* __restrict__ dx, int N, int K, int V) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Bufs s = carve(smem_raw, K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * BR, kc = blockIdx.y * CK;
  load_x(s.x, x, r0, N, K);

  Acc acc[CK / 16];  // the warp's 16 rows x 128 columns of dx
#pragma unroll
  for (int nt = 0; nt < CK / 16; ++nt) wmma::fill_fragment(acc[nt], 0.f);
  for (int v0 = 0; v0 < V; v0 += BV) {
    z_tile(s, W, ldw, bias, K, V, v0);
    load_w(s.wc, W, ldw, kc, CK, v0);
    dz_tile(s, lse, g, r0, N, false);
    // acc += dz (16 rows x 64 v) . W[kc:kc+128, v0:v0+64]^T (64 v x 128)
#pragma unroll
    for (int kt = 0; kt < BV / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, s.dz + warp * 16 * WLD + kt * 16, WLD);
#pragma unroll
      for (int nt = 0; nt < CK / 16; ++nt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, s.wc + nt * 16 * WLD + kt * 16, WLD);
        wmma::mma_sync(acc[nt], af, bfr, acc[nt]);
      }
    }
  }
  // write the warp's rows through its z rows, 64 columns at a time
  float* z_w = s.z + warp * 16 * ZLD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      wmma::store_matrix_sync(z_w + nt * 16, acc[half * 4 + nt], ZLD, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * 64; i += 32) {
      const int r = i / 64, c = i % 64, row = r0 + warp * 16 + r;
      if (row < N) dx[(size_t)row * K + kc + half * 64 + c] = __float2bfloat16(z_w[r * ZLD + c]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
vocab_lse_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W, int ldw,
                    const float* __restrict__ bias, const float* __restrict__ lse,
                    const float* __restrict__ g, float* __restrict__ dw,
                    float* __restrict__ db, int N, int K, int V, int Vp) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Bufs s = carve(smem_raw, K);
  const int warp = threadIdx.x >> 5, tid = threadIdx.x;
  const int v0 = blockIdx.x * BV, kc = blockIdx.y * CK, xld = K + 8;
  const bool with_db = blockIdx.y == 0;

  Acc acc[2][4];  // the warp's 32 dW rows (kc + 32w ..) x 64 columns
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) wmma::fill_fragment(acc[i][nt], 0.f);
  float db_acc = 0.f;  // column tid's sum (tid < 64)
  for (int r0 = 0; r0 < N; r0 += BR) {
    __syncthreads();  // the previous row tile's readers of x are done
    load_x(s.x, x, r0, N, K);
    z_tile(s, W, ldw, bias, K, V, v0);
    dz_tile(s, lse, g, r0, N, with_db);
    if (with_db && tid < BV) {
      for (int r = 0; r < BR; ++r) db_acc += s.z[r * ZLD + tid];
    }
    // acc += x[:, kc + 32w + 16i ..]^T (16 x 64 rows) . dz (64 rows x 64 v)
#pragma unroll
    for (int kt = 0; kt < BR / 16; ++kt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
        wmma::load_matrix_sync(af, s.x + kt * 16 * xld + kc + warp * 32 + i * 16, xld);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, s.dz + kt * 16 * WLD + nt * 16, WLD);
          wmma::mma_sync(acc[i][nt], af, bfr, acc[i][nt]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      wmma::store_matrix_sync(dw + (size_t)(kc + warp * 32 + i * 16) * Vp + v0 + nt * 16,
                              acc[i][nt], Vp, wmma::mem_row_major);
  if (with_db && tid < BV) db[v0 + tid] = db_acc;
}

size_t smem_bytes(int K, bool dx) {
  return x_bytes(K) + W_BYTES + Z_BYTES + DZ_BYTES + (dx ? WC_BYTES : 0);
}

int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

// x: (N, K) bf16, K a multiple of 128 up to 1024, rows 16-byte aligned;
// W: (K, V) bf16 in rows of stride ldw (a multiple of 8, >= V; 16-byte
// aligned); b: (V,) f32; part_m, part_s:
// (splits, N) f32 scratch; lse: (N,) f32 out. Returns the first
// cudaGetLastError() that is not cudaSuccess, or cudaSuccess.
extern "C" int vocab_lse_fwd(const void* x, const void* W, int ldw, const void* b,
                             void* part_m, void* part_s, void* lse, int N, int K, int V,
                             int splits, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = smem_bytes(K, false);
  int err = set_smem((const void*)vocab_lse_fwd_kernel, smem);
  if (err) return err;
  const int n_vt = (V + BV - 1) / BV;
  const int per = (n_vt + splits - 1) / splits;
  dim3 grid((N + BR - 1) / BR, splits);
  vocab_lse_fwd_kernel<<<grid, THREADS, smem, st>>>(
      (const bf16*)x, (const bf16*)W, ldw, (const float*)b, (float*)part_m, (float*)part_s, N,
      K, V, per);
  if ((err = (int)cudaGetLastError())) return err;
  vocab_lse_combine_kernel<<<(N + 255) / 256, 256, 0, st>>>(
      (const float*)part_m, (const float*)part_s, (float*)lse, N, splits);
  return (int)cudaGetLastError();
}

// The gradient of the row lse for g = d loss / d lse (N,) f32: dx (N, K)
// bf16 out.
extern "C" int vocab_lse_dx(const void* x, const void* W, int ldw, const void* b,
                            const void* lse, const void* g, void* dx, int N, int K, int V,
                            void* stream) {
  const size_t smem = smem_bytes(K, true);
  int err = set_smem((const void*)vocab_lse_dx_kernel, smem);
  if (err) return err;
  dim3 grid((N + BR - 1) / BR, K / CK);
  vocab_lse_dx_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)W, ldw, (const float*)b, (const float*)lse,
      (const float*)g, (bf16*)dx, N, K, V);
  return (int)cudaGetLastError();
}

// dW (K, Vp) f32 and db (Vp,) f32 out, Vp = V rounded up to 64 (the
// columns from V on are written as zeros; the caller slices them off).
extern "C" int vocab_lse_dw(const void* x, const void* W, int ldw, const void* b,
                            const void* lse, const void* g, void* dw, void* db, int N, int K,
                            int V, int Vp, void* stream) {
  const size_t smem = smem_bytes(K, false);
  int err = set_smem((const void*)vocab_lse_dw_kernel, smem);
  if (err) return err;
  dim3 grid(Vp / BV, K / CK);
  vocab_lse_dw_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)W, ldw, (const float*)b, (const float*)lse,
      (const float*)g, (float*)dw, (float*)db, N, K, V, Vp);
  return (int)cudaGetLastError();
}
