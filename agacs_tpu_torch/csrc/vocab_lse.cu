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
// at 989 TFLOP/s; dx and dW each need z and one more product of the same
// size: 0.40 ms). The point of the kernels is what they keep out of device
// memory: the (N, V) float32 logits are 1.55 GB.
//
// Forward (wgmma fed by TMA, `vocab_lse_fwd_kernel`; one launch at every
// K). It replaced a wmma kernel (15x its bound: 64 x 64 W chunks loaded
// synchronously between two block barriers, z round-tripped through
// shared memory as f32, two lanes a row) and a second kernel that combined
// its per-split (m, s) pairs through device memory. A block of BM rows
// (`vocab_lse.fwd_tiling`: 128, two consumer warpgroups of 64 rows; 64,
// one, where x's 128 rows do not fit beside the ring) and a producer
// warpgroup holds x resident in shared memory (TMA, K / 64 swizzled boxes
// of BM x 64); the producer streams W through a ring of 4 slots with each
// V tile's bias strip (b log2 e, -inf from column V on: the V tail is
// masked by index; W's map ends at column V and rows >= N read as zeros
// and are never written). Per 64-column V tile a warpgroup computes S = X
// W_tile on wgmma m64n64k16 into 32 f32 registers a thread, folds b and
// log2 e in with one fmaf, takes the tile's row maxima over the quad (2
// shuffles) and updates its rows' running (m, s) in log2 units, s
// rescaled only when m grows (`online_rows`). At K <= 256 a slot holds a
// whole K x 64 tile, the warpgroup's 64 rows of x sit in its registers as
// the product's A operand (K / 4 registers a thread, loaded once with
// ldmatrix; with A read from shared memory too, both operands of every
// m64n64k16 step come from shared memory and the kernel was ~20% slower
// on an H100: PERF.md, PR 16), and two S buffers alternate: the next
// tile's S is issued before this tile's exps, which run under it. Above
// 256 x is read from shared memory, a slot is a 64 x 64 chunk (8 KB) and
// S is summed over K / 64 chunk products. Each row tile's V sweep is split
// over a cluster of C blocks as dx's (rank r sweeps V tiles [r n / C, (r +
// 1) n / C)); each rank writes its (m, s) per row into its shared memory,
// and rank r merges rows [r BM / C, (r + 1) BM / C) of the C pairs in
// rank order through distributed shared memory, m = max m_r, s = sum s_r
// 2^(m_r - m), and stores lse = (m + log2 s) ln 2: no atomics, no second
// pass, bit-identical from run to run.
//
// Backward at K <= 256 (wgmma; `vocab_lse_dx_kernel`, `vocab_lse_dw_kernel`).
// It replaced wmma kernels that rebuilt z once for every 128 output columns
// (K / 128 times: 3 products of 199 GFLOP a pass at K 256, not 2), loaded W
// synchronously and round-tripped z and dz through shared memory. Here z is
// computed once per (row tile, V tile), and dz never leaves registers:
//   * dx: a block of two consumer warpgroups (64 rows each) and a producer
//     warpgroup owns 128 rows of x, resident in shared memory (TMA, K / 64
//     swizzled 128 x 64 boxes). The producer streams W's K x 64 column
//     tiles through a ring of 4 slots (TMA; full / empty mbarriers),
//     with each tile's bias strip (b, or -inf from column V on: the V tail
//     is masked by index). Per tile a warpgroup computes S = X W_tile
//     (wgmma m64n64k16, x K-major, the tile MN-major), P = exp2((S + b)
//     log2 e - lse log2 e) g on the accumulator registers (lse and g held
//     per row; rows >= N get lse +inf and g 0), packs P to bf16 as the
//     register A operand of dX += P W_tile^T (m64nKk16, the same staged
//     tile read K-major): W is read from L2 once per row tile and serves
//     both products. The next tile's S is issued before this tile's second
//     product, so its exp runs while that product is in flight. 59 row
//     tiles at N 7488 do not fill 132 SMs, so each row tile's V sweep is
//     split over a thread-block cluster of C blocks (`vocab_lse.dx_tiling`:
//     C 2 there; rank r sweeps V tiles [r n / C, (r + 1) n / C) of the n,
//     C <= n); each rank writes its f32 partial dX into its own shared
//     memory (over its dead x and ring), and rank r sums rows [r 128 / C,
//     (r + 1) 128 / C) of every rank's partial in rank order through
//     distributed shared memory and stores them as bf16: no atomics, and
//     the result is bit-identical from run to run.
//   * dw: a block owns 128 vocabulary columns, 64 a consumer warpgroup, whose
//     K x 64 W tile stays resident; the producer streams 64-row x tiles
//     (TMA) with their strips of lse log2 e and g (+inf and 0 from row N
//     on: the row tail is masked by index) through the ring. Per x tile a
//     warpgroup computes S^T = W_tile^T X_tile^T (m64n64k16, the W tile
//     MN-major as A, the x tile K-major), dz^T = exp2(...) g with the bias
//     per accumulator row (-inf from column V on), adds the f32 dz^T into
//     its two rows' db sums, packs dz^T to bf16 as the register A operand
//     of dW^T += dz^T X_tile (m64nKk16, the x tile MN-major: its K / 64
//     boxes 8 KB apart). At the end the quads' db sums are added by
//     shuffles and dW^T is stored transposed into dW (K, Vp) f32, every
//     warp store filling whole 32-byte sectors.
//   Both kernels run one block of 384 threads an SM; the producer
//   warpgroup (one warp of it loads) gives its registers to the consumers
//   (setmaxnreg: 40 a producer thread, 232 a consumer thread), which hold
//   the f32 accumulator of 64 x K (128 registers at K 256), S (32) and the
//   packed P (16). At K 256 ptxas still spills ~240 bytes a thread around
//   the products and serialises the wgmma groups (its C7512 note); at K 128
//   it does neither. Splitting the accumulator into two of 64, packing P
//   into a second buffer, or 240 registers did not help.
//
// Backward at K > 256 (wmma; `vocab_lse_dx_wmma_kernel`,
// `vocab_lse_dw_wmma_kernel`): the accumulator of 64 x K does not fit the
// registers, and x's 128 rows do not fit shared memory beside a ring, so
// the earlier design stays for those widths (only the whisper family's CTC
// head, K 768, takes it; no shipped recipe trains that head): grid (row
// tiles or V tiles, K / 128), each block recomputing z for its 128 columns
// of dx or rows of dW, with the column sums of the f32 dz for db in the
// first column block. The C entries dispatch by K, and the tiling rules
// `vocab_lse.dx_tiling` / `dw_tiling` mirror them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

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
vocab_lse_dx_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W, int ldw,
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
vocab_lse_dw_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ W, int ldw,
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

// ---------------------------------------------------------------------------
// The backward at K <= 256: wgmma fed by TMA (see the header note)

namespace {

namespace cg = cooperative_groups;

constexpr int HK_MAX = 256;     // the widest K of the wgmma backward
constexpr int DX_BM = 128;      // dx: rows a block owns, 64 a consumer warpgroup
constexpr int VT = 64;          // columns of a streamed W tile (dx), of a warpgroup (dw)
constexpr int DW_BV = 128;      // dw: vocabulary columns a block owns
constexpr int DW_BN = 64;       // dw: rows of a streamed x tile
constexpr int MAX_C = 8;        // dx: blocks of a cluster (the portable size)
constexpr int STAGES = 4;       // ring slots
constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int HTHREADS = CONSUMERS + 128;  // and a producer warpgroup (one warp loads)
constexpr int PAD = 8;          // f32 row padding of dx's partial (no bank conflicts)
constexpr int STRIPS = STAGES * VT * 4;  // bytes of one table of per-slot strips
constexpr int BARS = (1 + 2 * STAGES) * 8;
constexpr float LOG2E = 1.4426950408889634f;

// dx's shared memory: x (128 x K), the ring (STAGES x K x 64), and over
// both, once the sweep is done, the f32 partial dX (128 x (K + PAD)); then
// the bias strips and the barriers.
__host__ __device__ constexpr int dx_region(int K) {
  return DX_BM * K * 2 + STAGES * K * 128 > DX_BM * (K + PAD) * 4
             ? DX_BM * K * 2 + STAGES * K * 128 : DX_BM * (K + PAD) * 4;
}
__host__ __device__ constexpr size_t dx_smem(int K) {
  return 1024 + dx_region(K) + STRIPS + BARS;
}
// dw's: the two warpgroups' W tiles (2 x K x 64), the ring (STAGES x 64 x
// K), the lse and g strips and the barriers.
__host__ __device__ constexpr int dw_region(int K) {
  return 2 * K * 128 + STAGES * DW_BN * K * 2;
}
__host__ __device__ constexpr size_t dw_smem(int K) {
  return 1024 + dw_region(K) + 2 * STRIPS + BARS;
}
// A block's shared memory on sm_90 is at most 227 KB.
static_assert(dx_smem(HK_MAX) <= 232448 && dw_smem(HK_MAX) <= 232448,
              "K4's backward ring does not fit shared memory at K 256");

struct Maps {
  CUtensorMap x, w;  // x (N, K) in (64, rows) boxes; W (K, V) in (64, 64) boxes
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// The register A fragments of a 64 x 64 f32 accumulator, rounded to bf16.
__device__ __forceinline__ void pack(uint32_t (&pa)[16], const float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = hop::pack_bf16(d[2 * i], d[2 * i + 1]);
}

// acc (64 x K) += pa (64 x 64, registers) . b (64 x K, the k16 step kk at
// `step` bytes times kk), b read K-major (TB 0) or MN-major (TB 1, its 64
// columns blocks `lbo` bytes apart). Issued and committed.
template <int K, int TB>
__device__ __forceinline__ void issue_pv(float (&acc)[K / 2], const uint32_t (&pa)[16],
                                         const unsigned char* b, int step, int lbo) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = hop::desc_lbo(b, kk * step, lbo);
    if constexpr (K == 128) hop::wgmma_rs_n128<TB>(acc, &pa[4 * kk], db);
    else hop::wgmma_rs_n256<TB>(acc, &pa[4 * kk], db);
  }
  hop::wgmma_commit();
}

// dx's dz on the accumulator of S (rows a and b of this thread, the tile's
// 64 columns): exp2((S + bias) log2 e - lse log2 e) g. The strip holds the
// tile's bias (-inf from column V on); la, lb are lse log2 e (+inf from row
// N on) and ga, gb the rows' g (0 from row N on).
__device__ __forceinline__ void dz_rows(float (&sc)[32], const float* strip, float la,
                                        float lb, float ga, float gb) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bv = *reinterpret_cast<const float2*>(strip + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)  // d[4j + e]: row a (e < 2) or b, column 8j + 2t + e % 2
      sc[4 * j + e] = hop::ex2(fmaf(sc[4 * j + e] + ((e & 1) ? bv.y : bv.x), LOG2E,
                                    -(e < 2 ? la : lb))) * (e < 2 ? ga : gb);
  }
}

// S = X (the warpgroup's 64 rows, K-major: K / 64 boxes of 128 rows; xd
// its descriptor) . the W tile (K x 64, MN-major). Issued and committed.
// A descriptor's address field counts 16 bytes, so offsets add >> 4.
template <int K>
__device__ __forceinline__ void issue_s(float (&sc)[32], uint64_t xd, const unsigned char* wt) {
  const uint64_t wd = hop::desc(wt);
#pragma unroll
  for (int j = 0; j < K / 16; ++j)
    hop::wgmma_ss_n64_tb(sc, xd + (((j >> 2) * DX_BM * 128 + (j & 3) * 32) >> 4),
                         wd + ((j * 2048) >> 4), j);
  hop::wgmma_commit();
}

template <int K>
__global__ void __launch_bounds__(HTHREADS, 1)
vocab_lse_dx_kernel(const __grid_constant__ Maps mp, const float* __restrict__ bias,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    bf16* __restrict__ dx, int N, int V) {
  constexpr int STAGE = K * 128;  // bytes of a W tile: K rows x 64 columns
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  unsigned char* xs = base;
  unsigned char* ring = base + DX_BM * K * 2;
  float* strip = reinterpret_cast<float*>(base + dx_region(K));  // [slot][column]
  uint64_t* bars = reinterpret_cast<uint64_t*>(strip + STAGES * VT);
  uint64_t* xfull = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.y * DX_BM;
  const int n_vt = (V + VT - 1) / VT;
  const int vt0 = rank * n_vt / C, nt = (rank + 1) * n_vt / C - vt0;  // this rank's V tiles, >= 1
  if (tid == 0) {
    hop::mbar_init(xfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 32);  // the producer warp's lanes
      hop::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // the producer: x once, then W tiles and their bias strips
    hop::reg_dealloc<40>();
    if (warp == CONSUMERS / 32) {  // one warp loads
      if (lane == 0) {
        hop::prefetch_map(&mp.x);
        hop::prefetch_map(&mp.w);
        hop::mbar_expect_tx(xfull, DX_BM * K * 2);
        for (int kb = 0; kb < K / 64; ++kb)
          hop::tma_load_2d(xs + kb * DX_BM * 128, &mp.x, xfull, kb * 64, r0);
      }
      for (int it = 0; it < nt; ++it) {
        const int s = it % STAGES, v0 = (vt0 + it) * VT;
        hop::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        for (int c = lane; c < VT; c += 32)
          strip[s * VT + c] = v0 + c < V ? bias[v0 + c] : -INFINITY;
        if (lane == 0) {
          hop::mbar_expect_tx(&full[s], STAGE);
          for (int kb = 0; kb < K / 64; ++kb)
            hop::tma_load_2d(ring + s * STAGE + kb * 8192, &mp.w, &full[s], v0, kb * 64);
        } else {
          hop::mbar_arrive(&full[s]);
        }
      }
    }
    __syncwarp();
    cluster.sync();  // every rank's partial written
    cluster.sync();  // and read
    return;
  }
  hop::reg_alloc<232>();

  const int wg = warp >> 2, t = lane & 3;
  const int ra = r0 + 64 * wg + 16 * (warp & 3) + (lane >> 2), rb = ra + 8;
  const float la = ra < N ? lse[ra] * LOG2E : INFINITY, lb = rb < N ? lse[rb] * LOG2E : INFINITY;
  const float ga = ra < N ? g[ra] : 0.f, gb = rb < N ? g[rb] : 0.f;
  const uint64_t xd = hop::desc(xs + wg * 64 * 128);
  float acc[K / 2];
#pragma unroll
  for (int i = 0; i < K / 2; ++i) acc[i] = 0.f;
  float sc[32];
  uint32_t pa[16];
  hop::mbar_wait(xfull, 0);
  hop::mbar_wait(&full[0], 0);
  __syncwarp();
  hop::wgmma_fence();
  issue_s<K>(sc, xd, ring);
  hop::wgmma_wait();
  hop::fence_regs(sc);
  dz_rows(sc, strip, la, lb, ga, gb);
  pack(pa, sc);
  // Tile it's second product in flight while tile it + 1's dz is computed;
  // the last tile's product after the loop (no wgmma under a condition).
  int s = 0, s1 = 1, ph1 = 0;  // the slots of tiles it and it + 1, the phase of s1
  for (int it = 0; it + 1 < nt; ++it) {
    hop::mbar_wait(&full[s1], ph1);
    __syncwarp();
    hop::wgmma_fence();
    issue_s<K>(sc, xd, ring + s1 * STAGE);  // the next tile's S first
    issue_pv<K, 0>(acc, pa, ring + s * STAGE, 32, 1024);  // dX += P W_tile^T
    hop::wgmma_wait_n<1>();
    hop::fence_regs(sc);
    dz_rows(sc, strip + s1 * VT, la, lb, ga, gb);
    hop::wgmma_wait();
    hop::fence_regs(acc);
    hop::fence_regs(pa);  // read by the product in flight until here
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
    pack(pa, sc);
    s = s1;
    if (++s1 == STAGES) s1 = 0, ph1 ^= 1;
  }
  __syncwarp();
  hop::wgmma_fence();
  issue_pv<K, 0>(acc, pa, ring + s * STAGE, 32, 1024);
  hop::wgmma_wait();
  hop::fence_regs(acc);
  hop::fence_regs(pa);

  // The rank's partial over its dead x and ring, then rows [rank 128 / C,
  // +128 / C) of the C partials summed in rank order.
  constexpr int PL = K + PAD;
  float* part = reinterpret_cast<float*>(base);
  hop::bar_sync(1, CONSUMERS);  // both warpgroups are done with x and the ring
  {
    const int pr = ra - r0;
#pragma unroll
    for (int j = 0; j < K / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + (pr + 8 * h) * PL + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  cluster.sync();
  const int rows = DX_BM / C;
  for (int q = tid; q < rows * (K / 8); q += CONSUMERS) {
    const int r = rank * rows + q / (K / 8), c = (q % (K / 8)) * 8;
    float4 lo[MAX_C], hi[MAX_C];  // every rank's 8 values read at once, then added in rank order
#pragma unroll
    for (int src = 0; src < MAX_C; ++src)
      if (src < C) {
        const float4* p = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, src) +
                                                          r * PL + c);
        lo[src] = p[0];
        hi[src] = p[1];
      }
    float4 a = lo[0], b = hi[0];
#pragma unroll
    for (int src = 1; src < MAX_C; ++src)
      if (src < C) {
        a.x += lo[src].x, a.y += lo[src].y, a.z += lo[src].z, a.w += lo[src].w;
        b.x += hi[src].x, b.y += hi[src].y, b.z += hi[src].z, b.w += hi[src].w;
      }
    if (r0 + r < N) {
      uint4 o;
      o.x = hop::pack_bf16(a.x, a.y), o.y = hop::pack_bf16(a.z, a.w);
      o.z = hop::pack_bf16(b.x, b.y), o.w = hop::pack_bf16(b.z, b.w);
      *reinterpret_cast<uint4*>(dx + (size_t)(r0 + r) * (K) + c) = o;
    }
  }
  cluster.sync();  // no block exits while another still reads its partial
}

// dw's dz^T on the accumulator of S^T (rows a and b of this thread: its two
// vocabulary columns, with their bias, -inf from V on; the tile's 64 x
// rows, whose lse log2 e and g the strips hold, +inf and 0 from row N on),
// the f32 values added into the rows' db sums.
__device__ __forceinline__ void dz_cols(float (&sc)[32], const float* sl, const float* sg,
                                        float ba, float bb, float& da, float& dbb) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * t);
    const float2 gg = *reinterpret_cast<const float2*>(sg + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = hop::ex2(fmaf(sc[4 * j + e] + (e < 2 ? ba : bb), LOG2E,
                                    -((e & 1) ? l.y : l.x))) * ((e & 1) ? gg.y : gg.x);
      sc[4 * j + e] = d;
      if (e < 2) da += d;
      else dbb += d;
    }
  }
}

// S^T = the warpgroup's W tile^T (K x 64, MN-major as A; wd its
// descriptor) . the x tile^T (64 rows x K, K-major: K / 64 boxes of 64
// rows). Issued and committed.
template <int K>
__device__ __forceinline__ void issue_st(float (&sc)[32], uint64_t wd, const unsigned char* xt) {
  const uint64_t xd = hop::desc(xt);
#pragma unroll
  for (int j = 0; j < K / 16; ++j)
    hop::wgmma_ss_n64_ta(sc, wd + ((j * 2048) >> 4),
                         xd + (((j >> 2) * DW_BN * 128 + (j & 3) * 32) >> 4), j);
  hop::wgmma_commit();
}

template <int K>
__global__ void __launch_bounds__(HTHREADS, 1)
vocab_lse_dw_kernel(const __grid_constant__ Maps mp, const float* __restrict__ bias,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    float* __restrict__ dw, float* __restrict__ db, int N, int V, int Vp) {
  constexpr int STAGE = DW_BN * K * 2;  // bytes of an x tile: 64 rows x K
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  unsigned char* wt = base;
  unsigned char* ring = base + 2 * K * 128;
  float* sl = reinterpret_cast<float*>(base + dw_region(K));  // [slot][row]
  float* sg = sl + STAGES * VT;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sg + STAGES * VT);
  uint64_t* wfull = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int v0 = blockIdx.x * DW_BV, n_rt = (N + DW_BN - 1) / DW_BN;
  if (tid == 0) {
    hop::mbar_init(wfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 32);
      hop::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // the producer: the W tiles once, then x tiles and strips
    hop::reg_dealloc<40>();
    if (warp > CONSUMERS / 32) return;
    if (lane == 0) {
      hop::prefetch_map(&mp.x);
      hop::prefetch_map(&mp.w);
      hop::mbar_expect_tx(wfull, 2 * K * 128);
      for (int h = 0; h < 2; ++h)
        for (int kb = 0; kb < K / 64; ++kb)
          hop::tma_load_2d(wt + h * K * 128 + kb * 8192, &mp.w, wfull, v0 + 64 * h, kb * 64);
    }
    for (int it = 0; it < n_rt; ++it) {
      const int s = it % STAGES;
      hop::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      for (int c = lane; c < DW_BN; c += 32) {
        const int row = it * DW_BN + c;
        sl[s * VT + c] = row < N ? lse[row] * LOG2E : INFINITY;
        sg[s * VT + c] = row < N ? g[row] : 0.f;
      }
      if (lane == 0) {
        hop::mbar_expect_tx(&full[s], STAGE);
        for (int kb = 0; kb < K / 64; ++kb)
          hop::tma_load_2d(ring + s * STAGE + kb * 8192, &mp.x, &full[s], kb * 64, it * DW_BN);
      } else {
        hop::mbar_arrive(&full[s]);
      }
    }
    return;
  }
  hop::reg_alloc<232>();

  const int wg = warp >> 2, t = lane & 3;
  const int va = v0 + 64 * wg + 16 * (warp & 3) + (lane >> 2), vb = va + 8;
  const float ba = va < V ? bias[va] : -INFINITY, bb = vb < V ? bias[vb] : -INFINITY;
  const uint64_t wd = hop::desc(wt + wg * K * 128);
  float acc[K / 2];
#pragma unroll
  for (int i = 0; i < K / 2; ++i) acc[i] = 0.f;
  float sc[32], da = 0.f, dbb = 0.f;
  uint32_t pa[16];
  hop::mbar_wait(wfull, 0);
  hop::mbar_wait(&full[0], 0);
  __syncwarp();
  hop::wgmma_fence();
  issue_st<K>(sc, wd, ring);
  hop::wgmma_wait();
  hop::fence_regs(sc);
  dz_cols(sc, sl, sg, ba, bb, da, dbb);
  pack(pa, sc);
  int s = 0, s1 = 1, ph1 = 0;  // the slots of tiles it and it + 1, the phase of s1
  for (int it = 0; it + 1 < n_rt; ++it) {
    hop::mbar_wait(&full[s1], ph1);
    __syncwarp();
    hop::wgmma_fence();
    issue_st<K>(sc, wd, ring + s1 * STAGE);
    issue_pv<K, 1>(acc, pa, ring + s * STAGE, 2048, DW_BN * 128);  // dW^T += dz^T X_tile
    hop::wgmma_wait_n<1>();
    hop::fence_regs(sc);
    dz_cols(sc, sl + s1 * VT, sg + s1 * VT, ba, bb, da, dbb);
    hop::wgmma_wait();
    hop::fence_regs(acc);
    hop::fence_regs(pa);  // read by the product in flight until here
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
    pack(pa, sc);
    s = s1;
    if (++s1 == STAGES) s1 = 0, ph1 ^= 1;
  }
  __syncwarp();
  hop::wgmma_fence();
  issue_pv<K, 1>(acc, pa, ring + s * STAGE, 2048, DW_BN * 128);
  hop::wgmma_wait();
  hop::fence_regs(acc);
  hop::fence_regs(pa);

  da += __shfl_xor_sync(0xffffffffu, da, 1);
  da += __shfl_xor_sync(0xffffffffu, da, 2);
  dbb += __shfl_xor_sync(0xffffffffu, dbb, 1);
  dbb += __shfl_xor_sync(0xffffffffu, dbb, 2);
  if (t == 0) db[va] = da, db[vb] = dbb;
  // dW[k, v] = dW^T[v, k]: for each register, a warp fills 4 rows x 32 bytes
#pragma unroll
  for (int j = 0; j < K / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dw[(size_t)(8 * j + 2 * t + (e & 1)) * Vp + (e < 2 ? va : vb)] = acc[4 * j + e];
}

// ---------------------------------------------------------------------------
// The forward: wgmma fed by TMA at every K (see the header note)

constexpr int FWD_KC = 64;        // depth of a ring slot above HK_MAX: 64 x 64 W chunks
constexpr int SMEM_MAX = 232448;  // a block's shared memory on sm_90 (227 KB)
constexpr float LN2 = 0.6931471805599453f;

// The forward's shared memory at K and BM rows a block: x (BM x K), the
// ring (STAGES slots of fwd_kc(K) W rows x 64 columns), the bias strips and
// the barriers; the ranks' (m, s) per row go over the dead ring once the
// sweep is done.
__host__ __device__ constexpr int fwd_kc(int K) { return K <= HK_MAX ? K : FWD_KC; }
__host__ __device__ constexpr size_t fwd_smem(int K, int BM) {
  return 1024 + BM * K * 2 + STAGES * fwd_kc(K) * 128 + STRIPS + BARS;
}
// 128 rows a block where x's 128 rows fit beside the ring, else 64.
__host__ __device__ constexpr int fwd_bm(int K) { return fwd_smem(K, 128) <= SMEM_MAX ? 128 : 64; }
static_assert(fwd_bm(HK_MAX) == 128 && fwd_bm(768) == 128 && fwd_bm(896) == 64 &&
                  fwd_smem(1024, 64) <= SMEM_MAX,
              "K4's forward does not fit shared memory at some K up to 1024");

// A V tile's bias strip (b log2 e, -inf from column V on): the 16 values
// of this thread's columns 8j + 2t, 8j + 2t + 1.
__device__ __forceinline__ void load_strip(float2 (&bv)[8], const float* strip) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) bv[j] = *reinterpret_cast<const float2*>(strip + 8 * j + 2 * t);
}

// The online (max, sum) of this thread's rows a and b over one S tile (the
// m64n64 accumulator: 16 columns of each row, the quad holding all 64), in
// log2 units: y = S log2 e + b log2 e; the tile's row maxima over the quad;
// m raised to them, s rescaled only when m grows; then s += the sum of
// exp2(y - m) over the thread's columns. m is the quad's, s the thread's
// share of it.
__device__ __forceinline__ void online_rows(const float (&sc)[32], const float2 (&bv)[8],
                                            float& ma, float& mb, float& sa, float& sb) {
  float y[32], xa = -INFINITY, xb = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // d[4j + e]: row a (e < 2) or b, column 8j + 2t + e % 2
      y[4 * j + e] = fmaf(sc[4 * j + e], LOG2E, (e & 1) ? bv[j].y : bv[j].x);
      if (e < 2) xa = fmaxf(xa, y[4 * j + e]);
      else xb = fmaxf(xb, y[4 * j + e]);
    }
  xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, 1));
  xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, 2));
  xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, 1));
  xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, 2));
  if (xa > ma) sa *= hop::ex2(ma - xa), ma = xa;
  if (xb > mb) sb *= hop::ex2(mb - xb), mb = xb;
  float ea = 0.f, eb = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < 2) ea += hop::ex2(y[4 * j + e] - ma);
      else eb += hop::ex2(y[4 * j + e] - mb);
    }
  sa += ea;
  sb += eb;
}

// The warpgroup's 64 rows of x (xs: its first row in x's K / 64 swizzled
// boxes of DX_BM rows) as the register A operand of K / 16 k16 steps:
// registers 4j..4j+3 hold columns 16j..16j+15 (ldmatrix .x4: lanes 0-7
// address rows 0-7 of the warp's 16 at k 0-7, lanes 8-15 rows 8-15, lanes
// 16-31 the same rows at k 8-15).
template <int K>
__device__ __forceinline__ void load_xa(uint32_t (&xa)[K / 4], const unsigned char* xs) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int j = 0; j < K / 16; ++j) {
    const int ch = 2 * (j & 3) + (lane >> 4);  // the 16-byte chunk of the row, before the swizzle
    const unsigned char* p = xs + (j >> 2) * DX_BM * 128 + r * 128 + ((ch ^ (r & 7)) << 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(xa[4 * j]), "=r"(xa[4 * j + 1]), "=r"(xa[4 * j + 2]), "=r"(xa[4 * j + 3])
                 : "r"(hop::smem_u32(p)));
  }
}

// S = X (the warpgroup's 64 rows, in registers: `load_xa`) . the W tile
// (K x 64, MN-major). Issued and committed.
template <int K>
__device__ __forceinline__ void issue_s_rs(float (&sc)[32], const uint32_t (&xa)[K / 4],
                                           const unsigned char* wt) {
  const uint64_t wd = hop::desc(wt);
#pragma unroll
  for (int j = 0; j < K / 16; ++j) hop::wgmma_rs_n64_t(sc, &xa[4 * j], wd + ((j * 2048) >> 4), j);
  hop::wgmma_commit();
}

// S (+)= X[:, 64c : 64c + 64] (the warpgroup's 64 rows; xd the descriptor
// of x's box 0, its boxes BM x 128 bytes) . a 64 x 64 W chunk (MN-major);
// chunk 0 overwrites S. Issued and committed.
template <int BM>
__device__ __forceinline__ void issue_chunk(float (&sc)[32], uint64_t xd, const unsigned char* wt,
                                            int c) {
  const uint64_t xc = xd + ((c * BM * 128) >> 4), wd = hop::desc(wt);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    hop::wgmma_ss_n64_tb(sc, xc + ((j * 32) >> 4), wd + ((j * 2048) >> 4), c | j);
  hop::wgmma_commit();
}

// The ring position of a consumer: slot s, phase ph.
struct Pos {
  int s = 0, ph = 0;
  __device__ __forceinline__ Pos next() const {
    return s + 1 == STAGES ? Pos{0, ph ^ 1} : Pos{s + 1, ph};
  }
};

// One V tile at K <= HK_MAX (a slot holds the whole K x 64 tile): S of the
// next tile (slot p.next(); after the rank's last tile the slot p again, a
// product whose result is dropped, so that no wgmma sits under a
// condition) issued into nx, then this tile's online (max, sum) from cur
// while it runs. The slot is released once its strip is read: its W tile
// was read by cur's product, which has landed.
template <int K>
__device__ __forceinline__ void fwd_tile(const float (&cur)[32], float (&nx)[32],
                                         const uint32_t (&xa)[K / 4],
                                         const unsigned char* ring, const float* strip,
                                         uint64_t* full, uint64_t* empty, Pos& p, bool more,
                                         float& ma, float& mb, float& sa, float& sb) {
  const Pos q = p.next();
  if (more) hop::mbar_wait(&full[q.s], q.ph);
  __syncwarp();
  hop::wgmma_fence();
  issue_s_rs<K>(nx, xa, ring + (more ? q.s : p.s) * K * 128);
  float2 bv[8];
  load_strip(bv, strip + p.s * VT);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hop::mbar_arrive(&empty[p.s]);
  online_rows(cur, bv, ma, mb, sa, sb);
  hop::wgmma_wait();
  hop::fence_regs(nx);
  p = q;
}

// lse of rows [r0, r0 + BM): KC = K (128 or 256; whole W tiles, two S
// buffers) or FWD_KC (K / 64 chunks a tile, one S buffer); BM / 64
// consumer warpgroups and a producer warpgroup. Grid (C, row tiles) in
// clusters of C along x.
template <int KC, int BM>
__global__ void __launch_bounds__(BM * 2 + 128, 1)
vocab_lse_fwd_kernel(const __grid_constant__ Maps mp, const float* __restrict__ bias,
                     float* __restrict__ lse, int N, int K, int V) {
  constexpr int CONS = BM * 2;        // consumer threads: a warpgroup of 128 per 64 rows
  constexpr int STAGE = KC * 128;     // bytes of a ring slot: KC W rows x 64 columns
  constexpr bool WHOLE = KC > FWD_KC;  // a slot holds a whole K x 64 tile
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  unsigned char* xs = base;
  unsigned char* ring = base + BM * K * 2;
  float* strip = reinterpret_cast<float*>(ring + STAGES * STAGE);  // [slot][column]
  uint64_t* bars = reinterpret_cast<uint64_t*>(strip + STAGES * VT);
  uint64_t* xfull = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.y * BM;
  const int n_vt = (V + VT - 1) / VT, nch = K / KC;  // V tiles; ring slots a tile takes
  const int vt0 = rank * n_vt / C, nt = (rank + 1) * n_vt / C - vt0;  // this rank's V tiles, >= 1
  if (tid == 0) {
    hop::mbar_init(xfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 32);  // the producer warp's lanes
      hop::mbar_init(&empty[s], CONS / 32);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONS / 32) {  // the producer: x once, then W slots and each tile's bias strip
    if constexpr (CONS == 256) hop::reg_dealloc<40>();
    if (warp == CONS / 32) {  // one warp loads
      if (lane == 0) {
        hop::prefetch_map(&mp.x);
        hop::prefetch_map(&mp.w);
        hop::mbar_expect_tx(xfull, BM * K * 2);
        for (int kb = 0; kb < K / 64; ++kb)
          hop::tma_load_2d(xs + kb * BM * 128, &mp.x, xfull, kb * 64, r0);
      }
      Pos p;
      for (int it = 0; it < nt; ++it) {
        const int v0 = (vt0 + it) * VT;
        for (int c = 0; c < nch; ++c, p = p.next()) {
          hop::mbar_wait(&empty[p.s], p.ph ^ 1);
          if (c == 0)
            for (int j = lane; j < VT; j += 32)
              strip[p.s * VT + j] = v0 + j < V ? bias[v0 + j] * LOG2E : -INFINITY;
          if (lane == 0) {
            hop::mbar_expect_tx(&full[p.s], STAGE);
            for (int kb = 0; kb < KC / 64; ++kb)
              hop::tma_load_2d(ring + p.s * STAGE + kb * 8192, &mp.w, &full[p.s], v0,
                               c * KC + kb * 64);
          } else {
            hop::mbar_arrive(&full[p.s]);
          }
        }
      }
    }
    __syncwarp();
    cluster.sync();  // every rank's (m, s) written
    cluster.sync();  // and read
    return;
  }
  if constexpr (CONS == 256) hop::reg_alloc<232>();

  const int wg = warp >> 2, t = lane & 3;
  const int la = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // rows la and la + 8 of the block
  float ma = -INFINITY, mb = -INFINITY, sa = 0.f, sb = 0.f;
  hop::mbar_wait(xfull, 0);
  if constexpr (WHOLE) {
    uint32_t xa[KC / 4];
    load_xa<KC>(xa, xs + wg * 64 * 128);
    float s0[32], s1[32];
    hop::mbar_wait(&full[0], 0);
    __syncwarp();
    hop::wgmma_fence();
    issue_s_rs<KC>(s0, xa, ring);
    hop::wgmma_wait();
    hop::fence_regs(s0);
    Pos p;
    for (int it = 0;;) {  // two tiles a pass, so that each S buffer stays in its registers
      fwd_tile<KC>(s0, s1, xa, ring, strip, full, empty, p, it + 1 < nt, ma, mb, sa, sb);
      if (++it == nt) break;
      fwd_tile<KC>(s1, s0, xa, ring, strip, full, empty, p, it + 1 < nt, ma, mb, sa, sb);
      if (++it == nt) break;
    }
  } else {
    const uint64_t xd = hop::desc(xs + wg * 64 * 128);
    float sc[32];
    Pos p, prev;
    for (int it = 0; it < nt; ++it) {
      float2 bv[8];
      for (int c = 0; c < nch; ++c) {
        hop::mbar_wait(&full[p.s], p.ph);
        if (c == 0) load_strip(bv, strip + p.s * VT);
        __syncwarp();
        hop::wgmma_fence();
        issue_chunk<BM>(sc, xd, ring + p.s * STAGE, c);
        hop::wgmma_wait_n<1>();  // the previous chunk's product has landed: free its slot
        __syncwarp();
        if (c > 0 && lane == 0) hop::mbar_arrive(&empty[prev.s]);
        prev = p;
        p = p.next();
      }
      hop::wgmma_wait();
      hop::fence_regs(sc);
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[prev.s]);
      online_rows(sc, bv, ma, mb, sa, sb);
    }
  }

  // The quad's shares of s summed; each rank's (m, s) per row over its dead
  // ring, then rows [rank BM / C, +BM / C) of the C pairs merged in rank
  // order.
  sa += __shfl_xor_sync(0xffffffffu, sa, 1);
  sa += __shfl_xor_sync(0xffffffffu, sa, 2);
  sb += __shfl_xor_sync(0xffffffffu, sb, 1);
  sb += __shfl_xor_sync(0xffffffffu, sb, 2);
  float* pm = reinterpret_cast<float*>(ring);
  float* ps = pm + BM;
  hop::bar_sync(1, CONS);  // every consumer is done with the ring
  if (t == 0) pm[la] = ma, ps[la] = sa, pm[la + 8] = mb, ps[la + 8] = sb;
  cluster.sync();
  const int rows = BM / C;
  for (int q = tid; q < rows; q += CONS) {
    const int r = rank * rows + q;
    float mr[MAX_C], sr[MAX_C];  // every rank's pair read at once, then merged in rank order
#pragma unroll
    for (int src = 0; src < MAX_C; ++src)
      if (src < C) {
        mr[src] = *cluster.map_shared_rank(pm + r, src);
        sr[src] = *cluster.map_shared_rank(ps + r, src);
      }
    float m = mr[0], sum = 0.f;
#pragma unroll
    for (int src = 1; src < MAX_C; ++src)
      if (src < C) m = fmaxf(m, mr[src]);
#pragma unroll
    for (int src = 0; src < MAX_C; ++src)
      if (src < C) sum += sr[src] * hop::ex2(mr[src] - m);
    if (r0 + r < N) lse[r0 + r] = (m + log2f(sum)) * LN2;
  }
  cluster.sync();  // no block exits while another still reads its pairs
}

template <typename... KArgs, typename... Args>
int launch_hk(void (*kern)(KArgs...), dim3 grid, int cluster_x, int threads, size_t smem,
              cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The row lse of x W + b: x (N, K) bf16, K a multiple of 128 up to 1024,
// rows 16-byte aligned; W (K, V) bf16 in rows of stride ldw (a multiple of
// 8, >= V; 16-byte aligned); b (V,) f32; lse (N,) f32 out. One launch:
// blocks of BM rows (`vocab_lse.fwd_tiling`: fwd_bm(K)), each row tile's
// V sweep split over a cluster of C blocks (1, 2, 4 or 8, no more than V's
// 64-column tiles). Returns cudaErrorInvalidValue for a shape, BM or C the
// kernel does not take, else the first launch error or cudaSuccess.
extern "C" int vocab_lse_fwd(const void* x, const void* W, int ldw, const void* b, void* lse,
                             int N, int K, int V, int BM, int C, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0 || V <= 0 || K <= 0 || K % 128 || K > 1024 || ldw < V || ldw % 8 ||
      BM != fwd_bm(K) || C < 1 || C > MAX_C || (C & (C - 1)) || C > (V + VT - 1) / VT)
    return (int)cudaErrorInvalidValue;
  Maps mp = {};
  int rc;
  if ((rc = hop_host::encode_bf16(&mp.x, x, N, K, K, BM)) ||
      (rc = hop_host::encode_bf16(&mp.w, W, K, V, ldw, 64)))
    return rc;
  const dim3 grid(C, (N + BM - 1) / BM);
  const size_t smem = fwd_smem(K, BM);
  const float* bf = (const float*)b;
  float* out = (float*)lse;
  if (K == 128)
    return launch_hk(vocab_lse_fwd_kernel<128, 128>, grid, C, HTHREADS, smem, st, mp, bf, out,
                     N, K, V);
  if (K == 256)
    return launch_hk(vocab_lse_fwd_kernel<256, 128>, grid, C, HTHREADS, smem, st, mp, bf, out,
                     N, K, V);
  if (BM == 128)
    return launch_hk(vocab_lse_fwd_kernel<FWD_KC, 128>, grid, C, HTHREADS, smem, st, mp, bf,
                     out, N, K, V);
  return launch_hk(vocab_lse_fwd_kernel<FWD_KC, 64>, grid, C, 256, smem, st, mp, bf, out, N, K,
                   V);
}

// The gradient of the row lse for g = d loss / d lse (N,) f32: dx (N, K)
// bf16 out. K <= 256 runs the wgmma kernel on clusters of C blocks (1, 2,
// 4 or 8, no more than V's 64-column tiles; `vocab_lse.dx_tiling`), a
// wider K the wmma kernel, with C 1. x, W, b, lse and g as for
// vocab_lse_fwd (lse and g (N,) f32). Returns cudaErrorInvalidValue for a
// shape or cluster the kernels do not take.
extern "C" int vocab_lse_dx(const void* x, const void* W, int ldw, const void* b,
                            const void* lse, const void* g, void* dx, int N, int K, int V,
                            int C, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0 || V <= 0 || K <= 0 || K % 128 || K > 1024 || ldw < V || ldw % 8)
    return (int)cudaErrorInvalidValue;
  if (K > HK_MAX) {
    if (C != 1) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(K, true);
    int err = set_smem((const void*)vocab_lse_dx_wmma_kernel, smem);
    if (err) return err;
    dim3 grid((N + BR - 1) / BR, K / CK);
    vocab_lse_dx_wmma_kernel<<<grid, THREADS, smem, st>>>(
        (const bf16*)x, (const bf16*)W, ldw, (const float*)b, (const float*)lse,
        (const float*)g, (bf16*)dx, N, K, V);
    return (int)cudaGetLastError();
  }
  if (C < 1 || C > MAX_C || (C & (C - 1)) || C > (V + VT - 1) / VT)
    return (int)cudaErrorInvalidValue;
  Maps mp = {};
  int rc;
  if ((rc = hop_host::encode_bf16(&mp.x, x, N, K, K, DX_BM)) ||
      (rc = hop_host::encode_bf16(&mp.w, W, K, V, ldw, 64)))
    return rc;
  const dim3 grid(C, (N + DX_BM - 1) / DX_BM);
  const size_t smem = dx_smem(K);
  const float *bf = (const float*)b, *lf = (const float*)lse, *gf = (const float*)g;
  if (K == 128)
    return launch_hk(vocab_lse_dx_kernel<128>, grid, C, HTHREADS, smem, st, mp, bf, lf, gf,
                     (bf16*)dx, N, V);
  return launch_hk(vocab_lse_dx_kernel<256>, grid, C, HTHREADS, smem, st, mp, bf, lf, gf,
                   (bf16*)dx, N, V);
}

// dW (K, Vp) f32 and db (Vp,) f32 out, Vp = V rounded up to the kernel's
// vocabulary block (`vocab_lse.dw_tiling`: 128 at K <= 256, 64 above). The
// columns from V on are written as zeros; the caller slices them off.
extern "C" int vocab_lse_dw(const void* x, const void* W, int ldw, const void* b,
                            const void* lse, const void* g, void* dw, void* db, int N, int K,
                            int V, int Vp, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0 || V <= 0 || K <= 0 || K % 128 || K > 1024 || ldw < V || ldw % 8 || Vp < V)
    return (int)cudaErrorInvalidValue;
  if (K > HK_MAX) {
    if (Vp % BV) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(K, false);
    int err = set_smem((const void*)vocab_lse_dw_wmma_kernel, smem);
    if (err) return err;
    dim3 grid(Vp / BV, K / CK);
    vocab_lse_dw_wmma_kernel<<<grid, THREADS, smem, st>>>(
        (const bf16*)x, (const bf16*)W, ldw, (const float*)b, (const float*)lse,
        (const float*)g, (float*)dw, (float*)db, N, K, V, Vp);
    return (int)cudaGetLastError();
  }
  if (Vp % DW_BV) return (int)cudaErrorInvalidValue;
  Maps mp = {};
  int rc;
  if ((rc = hop_host::encode_bf16(&mp.x, x, N, K, K, DW_BN)) ||
      (rc = hop_host::encode_bf16(&mp.w, W, K, V, ldw, 64)))
    return rc;
  const dim3 grid(Vp / DW_BV);
  const size_t smem = dw_smem(K);
  const float *bf = (const float*)b, *lf = (const float*)lse, *gf = (const float*)g;
  if (K == 128)
    return launch_hk(vocab_lse_dw_kernel<128>, grid, 1, HTHREADS, smem, st, mp, bf, lf, gf,
                     (float*)dw, (float*)db, N, V, Vp);
  return launch_hk(vocab_lse_dw_kernel<256>, grid, 1, HTHREADS, smem, st, mp, bf, lf, gf,
                   (float*)dw, (float*)db, N, V, Vp);
}
