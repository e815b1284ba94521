// K1b: packed-layout non-causal multi-head attention, backward (sm_90a).
//
// Replaces the TPU kernels `_bwd_kernel` (T <= 1024) and `_bwd_kernel_qc`
// (q-chunked, T 1025-1536) of agacs_tpu/ops/flash_train.py
// (`packed_flash_mha`'s custom VJP -> `_bwd_pallas`): dq, dk and dv of the
// whisper encoder's self-attention. Same math: q * d_head^-0.5 (x0.125,
// exact in bf16); f32 scores; the softmax weights recomputed from q and k;
// D = rowsum(do * o); dv = p^T do; ds = p (dp - D) cast to bf16 before its
// products; dq = 0.125 ds k; dk = ds^T (0.125 q); f32 accumulation.
//
// What bounds it here: at the training shape (B=16, T=750, 12 heads of
// 64) the three kernels below run 7 products of 2*B*H*T*T*64 = 13.8 GFLOP
// each (97 GFLOP per call) against ~5 x 18.4 MB of bf16 q/k/v/o/do read
// and 3 x 18.4 MB written (~1,000 FLOP per byte of the 55 MB read once;
// tiles are re-read from L2), so it is compute-bound on the tensor cores.
//
// Design. The TPU kernel holds a head group's whole (T, T) f32 score
// block in VMEM and carries dk/dv in scratch across its sequential q-chunk
// grid axis. A Hopper SM has 227 KB of shared memory and its blocks run in
// no order, so the work is split the way an online-softmax backward has to
// be, with nothing carried between blocks and no atomics:
//   (a) row statistics: the forward kernel (packed_flash_fwd.cu) writes the
//       f32 log-sum-exp of every score row, lse (B, H, T), when it runs
//       under autograd; p = exp(s - lse) is then the normalized weight;
//   (b) rowdot: D = rowsum(do * o) (B, H, T) f32, one warp per (row, head);
//   (c) dkdv: one block per (64-key tile, head, batch row); it loops over
//       every 64-row q tile and accumulates its keys' dk and dv in
//       registers (wmma accumulator fragments);
//   (d) dq: one block per (64-row q tile, head, batch row); it loops over
//       every key tile and accumulates dq in registers.
// (c) and (d) both recompute s and dp (7 products where an atomic dq would
// need 5): the price of a deterministic result without a dq scratch
// buffer. Each block has 4 warps; each warp owns 16 rows of the block's
// tile; products are bf16 wmma 16x16x16 tiles with f32 accumulation; each
// pair of lanes runs the elementwise math of one row. q/k/v/o/do are read
// straight from the packed (B, T, H*64) layout at column h*64 with 16-byte
// loads (no head-split transposes). The key tail and the q tail (T = 750
// and 1500 are not multiples of 64) are masked: a key past T gets p = 0 in
// (d), a q row past T gets p = 0 in (c). wgmma, TMA and pipelining are
// later work: this version is the simple, correct one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 64;       // head width
constexpr int BT = 64;       // rows per tile (q rows or keys)
constexpr int WARPS = 4;     // each warp owns 16 rows of the block's tile
constexpr int THREADS = WARPS * 32;
constexpr int SLD = BT + 4;  // f32 tile-row stride (fewer bank conflicts)
constexpr int PLD = BT + 8;  // bf16 tile-row stride

struct Smem {
  bf16 own0[BT * DH];  // the block's own rows: dkdv K, dq 0.125*Q
  bf16 own1[BT * DH];  //                       dkdv V, dq dO
  bf16 str0[BT * DH];  // the streamed tiles:   dkdv 0.125*Q, dq K
  bf16 str1[BT * DH];  //                       dkdv dO,      dq V
  float lse[BT];       // per q row of the tile that carries q rows
  float dd[BT];
  float s[WARPS][16 * SLD];  // scores, then dp, then the epilogue tiles
  bf16 p[WARPS][16 * PLD];
  bf16 ds[WARPS][16 * PLD];
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

__device__ __forceinline__ void scale_tile(bf16* t, float scale) {
  for (int i = threadIdx.x; i < BT * DH; i += THREADS)
    t[i] = __float2bfloat16(__bfloat162float(t[i]) * scale);
}

// out (16 x 64 f32, stride SLD) = a (16 x 64, stride DH) . b^T, b (64 x 64,
// stride DH): out[i][j] = sum_d a[i][d] b[j][d].
__device__ __forceinline__ void mm_abt(float* out, const bf16* a, const bf16* b) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
      wmma::load_matrix_sync(af, a + kt * 16, DH);
      wmma::load_matrix_sync(bfr, b + nt * 16 * DH + kt * 16, DH);
      wmma::mma_sync(acc, af, bfr, acc);
    }
    wmma::store_matrix_sync(out + nt * 16, acc, SLD, wmma::mem_row_major);
  }
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// acc[nt] += a (16 x 64 bf16, stride PLD) . b (64 x 64, stride DH).
__device__ __forceinline__ void mm_ab_acc(Acc* acc, const bf16* a, const bf16* b) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(af, a + kt * 16, PLD);
      wmma::load_matrix_sync(bfr, b + kt * 16 * DH + nt * 16, DH);
      wmma::mma_sync(acc[nt], af, bfr, acc[nt]);
    }
  }
}

// Write a warp's 16 x 64 accumulator rows [row0, row0 + 16) of a packed
// output (rows >= T skipped), times `scale`, through the f32 tile s_w.
__device__ __forceinline__ void store_rows(bf16* dst, Acc* acc, float* s_w,
                                           int row0, int T, int D, float scale) {
  const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 32;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    wmma::store_matrix_sync(s_w + nt * 16, acc[nt], SLD, wmma::mem_row_major);
  __syncwarp();
  if (row0 + r < T) {
    bf16* out = dst + (size_t)(row0 + r) * D + c0;
#pragma unroll
    for (int j = 0; j < 32; j += 2)
      *reinterpret_cast<__nv_bfloat162*>(out + j) = __floats2bfloat162_rn(
          s_w[r * SLD + c0 + j] * scale, s_w[r * SLD + c0 + j + 1] * scale);
  }
}

// (b) D[b, h, t] = sum over the head's 64 columns of do * o, in f32.
__global__ void rowdot_kernel(const bf16* __restrict__ dout,
                              const bf16* __restrict__ o, float* __restrict__ dd,
                              int B, int T, int H) {
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= B * T * H) return;
  const int h = w % H, bt = w / H;  // bt = b * T + t
  const size_t off = (size_t)bt * H * DH + (size_t)h * DH + lane * 2;
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off));
  const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + off));
  float sum = x.x * y.x + x.y * y.y;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) {
    const int b = bt / T, t = bt % T;
    dd[((size_t)b * H + h) * T + t] = sum;
  }
}

// (c) dk, dv of one (64-key tile, head, batch row).
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dd,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H,
            float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const size_t base = (size_t)b * T * D + (size_t)h * DH;
  const float* lse_bh = lse + ((size_t)b * H + h) * T;
  const float* dd_bh = dd + ((size_t)b * H + h) * T;

  load_tile(sm.own0, k + base, k0, T, D);
  load_tile(sm.own1, v + base, k0, T, D);

  const int r = lane >> 1;         // this lane's key row within the warp's 16
  const int c0 = (lane & 1) * 32;  // and its half of the tile's 64 q columns
  float* s_w = sm.s[warp];
  bf16* p_w = sm.p[warp];
  bf16* ds_w = sm.ds[warp];
  const bf16* k_w = sm.own0 + warp * 16 * DH;
  const bf16* v_w = sm.own1 + warp * 16 * DH;

  Acc dk_acc[4], dv_acc[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    wmma::fill_fragment(dk_acc[nt], 0.f);
    wmma::fill_fragment(dv_acc[nt], 0.f);
  }

  for (int q0 = 0; q0 < T; q0 += BT) {
    __syncthreads();  // the previous q tile's reads are done
    load_tile(sm.str0, q + base, q0, T, D);
    load_tile(sm.str1, dout + base, q0, T, D);
    if (tid < BT) {
      const int qi = q0 + tid;
      sm.lse[tid] = qi < T ? lse_bh[qi] : 0.f;
      sm.dd[tid] = qi < T ? dd_bh[qi] : 0.f;
    }
    __syncthreads();
    scale_tile(sm.str0, scale);
    __syncthreads();

    // s^T (16 keys x 64 q) = k_w . (0.125 q)^T; p^T = exp(s^T - lse[q]),
    // 0 for q rows past T
    mm_abt(s_w, k_w, sm.str0);
    __syncwarp();
    float pv[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = c0 + j;
      pv[j] = (q0 + c < T) ? expf(s_w[r * SLD + c] - sm.lse[c]) : 0.f;
      p_w[r * PLD + c] = __float2bfloat16(pv[j]);
    }
    __syncwarp();

    // dp^T (16 x 64) = v_w . do^T; ds^T = p^T (dp^T - D[q])
    mm_abt(s_w, v_w, sm.str1);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = c0 + j;
      ds_w[r * PLD + c] = __float2bfloat16(pv[j] * (s_w[r * SLD + c] - sm.dd[c]));
    }
    __syncwarp();

    // dv += p^T . do;  dk += ds^T . (0.125 q)
    mm_ab_acc(dv_acc, p_w, sm.str1);
    mm_ab_acc(dk_acc, ds_w, sm.str0);
  }

  const int row0 = k0 + warp * 16;
  store_rows(dk + base, dk_acc, s_w, row0, T, D, 1.f);
  store_rows(dv + base, dv_acc, s_w, row0, T, D, 1.f);
}

// (d) dq of one (64-row q tile, head, batch row).
__global__ void __launch_bounds__(THREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dd,
          bf16* __restrict__ dq, int T, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const size_t base = (size_t)b * T * D + (size_t)h * DH;

  load_tile(sm.own0, q + base, q0, T, D);
  load_tile(sm.own1, dout + base, q0, T, D);
  if (tid < BT) {
    const int qi = q0 + tid;
    const size_t bh = ((size_t)b * H + h) * T;
    sm.lse[tid] = qi < T ? lse[bh + qi] : 0.f;
    sm.dd[tid] = qi < T ? dd[bh + qi] : 0.f;
  }
  __syncthreads();
  scale_tile(sm.own0, scale);

  const int r = lane >> 1;         // this lane's q row within the warp's 16
  const int c0 = (lane & 1) * 32;  // and its half of the tile's 64 keys
  float* s_w = sm.s[warp];
  bf16* ds_w = sm.ds[warp];
  const bf16* q_w = sm.own0 + warp * 16 * DH;
  const bf16* do_w = sm.own1 + warp * 16 * DH;
  const float row_lse = sm.lse[warp * 16 + r];
  const float row_dd = sm.dd[warp * 16 + r];

  Acc dq_acc[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) wmma::fill_fragment(dq_acc[nt], 0.f);

  for (int k0 = 0; k0 < T; k0 += BT) {
    __syncthreads();  // q scaled; the previous key tile's reads are done
    load_tile(sm.str0, k + base, k0, T, D);
    load_tile(sm.str1, v + base, k0, T, D);
    __syncthreads();

    // s (16 q x 64 keys) = (0.125 q_w) . k^T; p = exp(s - lse), 0 past T
    mm_abt(s_w, q_w, sm.str0);
    __syncwarp();
    float pv[32];
#pragma unroll
    for (int j = 0; j < 32; ++j)
      pv[j] = (k0 + c0 + j < T) ? expf(s_w[r * SLD + c0 + j] - row_lse) : 0.f;
    __syncwarp();

    // dp (16 x 64) = do_w . v^T; ds = p (dp - D)
    mm_abt(s_w, do_w, sm.str1);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j)
      ds_w[r * PLD + c0 + j] =
          __float2bfloat16(pv[j] * (s_w[r * SLD + c0 + j] - row_dd));
    __syncwarp();

    // dq += ds . k
    mm_ab_acc(dq_acc, ds_w, sm.str0);
  }

  store_rows(dq + base, dq_acc, s_w, q0 + warp * 16, T, D, scale);
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (B, T, H*64) bf16, contiguous, 16-byte
// aligned; lse: (B, H, T) f32 from packed_flash_fwd; dd: (B, H, T) f32
// scratch. Launches (b), (c), (d) on `stream`; returns the first
// cudaGetLastError() that is not cudaSuccess, or cudaSuccess.
extern "C" int packed_flash_bwd(const void* q, const void* k, const void* v,
                                const void* o, const void* dout, const void* lse,
                                void* dd, void* dq, void* dk, void* dv, int B,
                                int T, int H, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int smem = (int)sizeof(Smem);  // 69,120 bytes: above the 48 KB default
  // Set on every launch: the attribute is per device, and it is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 0.125f;  // 64^-0.5

  const int rows = B * T * H;
  rowdot_kernel<<<(rows + 7) / 8, 256, 0, st>>>((const bf16*)dout,
                                                (const bf16*)o, (float*)dd, B, T, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  dim3 grid((T + BT - 1) / BT, H, B);
  dkdv_kernel<<<grid, THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)dd, (bf16*)dk, (bf16*)dv, T, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  dq_kernel<<<grid, THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)dd, (bf16*)dq, T, H, scale);
  return (int)cudaGetLastError();
}
