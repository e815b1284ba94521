// K5: Transformer-XL relative-position multi-head attention, forward
// (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of agacs_tpu/ops/relpos_flash.py
// (`relpos_mha` -> `_fwd_pallas`), the conformer encoder's rel-pos
// self-attention. Same function: per head h, with qu = q + pos_bias_u and
// qv = q + pos_bias_v given,
//
//   s[q, j] = (qu[q] . k[j] + qv[q] . pe[T-1-q+j]) * d_head^-0.5 + mask[j]
//
// with bf16 inputs and float32 accumulation, the additive mask (0 or -1e30
// per key), a float32 softmax, the UN-normalized p cast to bf16 for the
// value product with float32 accumulation, and the division by the row sum
// at the end. pe holds the projected positions T-1 .. -(T-1) in rows
// 0 .. 2T-2; rows from 2T-1 on (the JAX padding to a multiple of 128) are
// never read.
//
// What bounds it here: at the recipe's shape (B=8, T=468, 4 heads of 64) a
// call is 3 products of 2*B*H*T*T*64 = 3.6 GFLOP against ~10 MB of
// qu/qv/k/v/pe/mask/o, so the tensor cores bound it, not HBM. The TPU
// kernel held a head's whole (T, T) content scores and (T, Wp) position
// scores in VMEM and realigned the position scores with a strided lane
// rotate, because Mosaic has no per-row gather (relpos_flash.py:94-145).
// A Hopper SM has 227 KB of shared memory, so this kernel streams 64-key
// tiles with an online softmax (running f32 max and sum per row), as K1f
// (packed_flash_fwd.cu) does, and turns the shift into an index: for the
// 64 queries q0.. and 64 keys k0.. of a tile, the position scores needed
// are qv_tile . pe[p0 .. p0+126]^T with p0 = T-1-(q0+63)+k0, and
// bd[q, j] = P[q, 63-(q-q0)+(j-k0)]. A warp owns 16 query rows, whose
// columns of P span 16+63 = 79, so each warp computes a (16, 80) block of
// P from its own 80 rows of the block's 128-row pe tile. The streaming
// reorders the f32 sums relative to the TPU's whole-row softmax, which
// with the bf16 cast of p is why it is compared with its plain version
// under a tolerance.
//
// Design: one block of 4 warps per (64-query tile, head, batch row),
// reading qu/qv/k/v straight from the packed (B, T, H*64) layout at column
// h*64 with 16-byte loads; the three products are bf16 tensor-core tiles
// (nvcuda::wmma 16x16x16, f32 accumulation); each pair of lanes runs the
// softmax of one row. Keys past T get -inf; pe rows outside 0 .. 2T-2
// (only ever read for padded query rows q >= T or padded keys j >= T) are
// loaded as zeros. wgmma, TMA and a deeper pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 64;        // head width
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int WARPS = 4;      // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int PW = BQ + BK;   // pe rows a tile reads (127 used)
constexpr int PC = 80;        // columns of P one warp computes (79 used)
constexpr int SLD = BK + 4;   // f32 score-row stride
constexpr int QLD = PC + 4;   // f32 position-score-row stride
constexpr int PLD = BK + 8;   // bf16 p-row stride

struct Smem {
  bf16 qu[BQ * DH];
  bf16 qv[BQ * DH];
  bf16 k[BK * DH];
  bf16 v[BK * DH];
  bf16 pe[PW * DH];
  float s[WARPS][16 * SLD];    // content scores, then the P.V tile
  float pos[WARPS][16 * QLD];  // position scores
  bf16 p[WARPS][16 * PLD];
};

// Copy rows [row0, row0 + nrows) x 64 columns of a row-major matrix with
// leading dimension ld into a dense (nrows, 64) tile; rows outside [lo, hi)
// are zero (row0 may be negative).
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int nrows,
                                          int lo, int hi, int ld) {
  for (int i = threadIdx.x; i < nrows * 8; i += THREADS) {
    const int r = i >> 3, c = (i & 7) * 8, row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row >= lo && row < hi)
      val = *reinterpret_cast<const uint4*>(src + (size_t)row * ld + c);
    *reinterpret_cast<uint4*>(dst + r * DH + c) = val;
  }
}

// out (16 x 16*NT, f32, row stride ldo) = a (16 x 64, row-major) . b^T,
// b holding 16*NT rows of 64 (so read column-major).
template <int NT>
__device__ __forceinline__ void rows_dot(float* out, int ldo, const bf16* a, const bf16* b) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
    wmma::fill_fragment(sf, 0.f);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
      wmma::load_matrix_sync(af, a + kt * 16, DH);
      wmma::load_matrix_sync(bfr, b + nt * 16 * DH + kt * 16, DH);
      wmma::mma_sync(sf, af, bfr, sf);
    }
    wmma::store_matrix_sync(out + nt * 16, sf, ldo, wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(THREADS)
relpos_flash_fwd_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ qv,
                        const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ pe, const float* __restrict__ mask,
                        bf16* __restrict__ o, int T, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const int n_real = 2 * T - 1;  // pe rows of the positions T-1 .. -(T-1)
  const size_t base = (size_t)b * T * D + (size_t)h * DH;
  const float* mrow = mask + (size_t)b * T;

  load_rows(sm.qu, qu + base, q0, BQ, 0, T, D);
  load_rows(sm.qv, qv + base, q0, BQ, 0, T, D);

  const int r = lane >> 1;         // this lane's row within the warp's 16
  const int c0 = (lane & 1) * 32;  // and its half of the 64 key columns
  float* s_w = sm.s[warp];
  float* pos_w = sm.pos[warp];
  bf16* p_w = sm.p[warp];
  const bf16* qu_w = sm.qu + warp * 16 * DH;
  const bf16* qv_w = sm.qv + warp * 16 * DH;
  // the warp's rows q0+16w+i need P columns 63-(16w+i)+(j-k0), i.e. tile
  // rows 48-16w .. 127-16w: its column c reads tile row 48-16w+c
  const bf16* pe_w = sm.pe + (48 - 16 * warp) * DH;
  float m_i = -INFINITY, l_i = 0.f;
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // the previous tile's k/v/pe reads are done
    load_rows(sm.k, k + base, k0, BK, 0, T, D);
    load_rows(sm.v, v + base, k0, BK, 0, T, D);
    // query q and key j read pe row T-1-q+j: p0 = T-1-(q0+63)+k0 is the
    // least row the tile reads
    const int p0 = T - 1 - (q0 + BQ - 1) + k0;
    load_rows(sm.pe, pe + h * DH, p0, PW, 0, n_real, D);
    __syncthreads();

    rows_dot<BK / 16>(s_w, SLD, qu_w, sm.k);   // content scores (16 x 64)
    rows_dot<PC / 16>(pos_w, QLD, qv_w, pe_w);  // position scores (16 x 80)
    __syncwarp();

    // online softmax over this tile for row r (two lanes per row); key
    // column cj of row r takes position column 15 - r + cj
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int cj = c0 + j, key = k0 + cj;
      float x = -INFINITY;
      if (key < T)
        x = (s_w[r * SLD + cj] + pos_w[r * QLD + 15 - r + cj]) * scale + mrow[key];
      sv[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);  // finite: key 0 is always below T
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
    const float linv = 1.f / l_i;
#pragma unroll
    for (int j = 0; j < 32; j += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + j) =
          __floats2bfloat162_rn(acc[j] * linv, acc[j + 1] * linv);
  }
}

}  // namespace

// qu, qv, k, v, o: (B, T, H*64) bf16; pe: (n_pe >= 2T-1, H*64) bf16 (rows
// 0 .. 2T-2 read); mask: (B, T) f32 additive; all contiguous and 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int relpos_flash_fwd(const void* qu, const void* qv, const void* k,
                                const void* v, const void* pe, const void* mask, void* o,
                                int B, int T, int H, void* stream) {
  const int smem = (int)sizeof(Smem);  // 97280 bytes: above the 48 KB default
  // Set on every launch: the attribute is per device, and it is cheap.
  const cudaError_t attr = cudaFuncSetAttribute(
      relpos_flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  relpos_flash_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)qu, (const bf16*)qv, (const bf16*)k, (const bf16*)v, (const bf16*)pe,
      (const float*)mask, (bf16*)o, T, H, 0.125f /* 64^-0.5 */);
  return (int)cudaGetLastError();
}
