// K5: Transformer-XL relative-position multi-head attention, forward and
// backward (sm_90a).
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
// loaded as zeros. wgmma, TMA and a deeper pipeline are later work. Under
// autograd the forward also writes each row's float32 max m and sum l
// (B, H, T), which the backward reads (see `relpos_flash_bwd` below).

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
                        bf16* __restrict__ o, float* __restrict__ row_m,
                        float* __restrict__ row_l, int T, int H, float scale) {
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
    if (row_m != nullptr && (lane & 1) == 0) {
      const size_t at = ((size_t)b * H + h) * T + row;
      row_m[at] = m_i;
      row_l[at] = l_i;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
//
// Replaces the TPU kernel `_bwd_kernel` of agacs_tpu/ops/relpos_flash.py
// (`relpos_mha`'s custom VJP -> `_bwd_pallas`). Same arithmetic as there
// (:178-246), per head, with s recomputed as the forward computes it and
// the forward's row max m and row sum l read back:
//
//   p   = exp(s - m)                     unnormalised, f32
//   dd  = rowsum(do * o)                 f32
//   dv  = bf16(p)^T . bf16(do / l)
//   dp  = do . v^T
//   ds  = bf16(p (dp - dd) / l * d_head^-0.5)
//   dqu = ds . k          dk = ds^T . qu
//   dqv[q] = sum_j ds[q, j] pe[T-1-q+j]
//   dpe[p] = sum_(b, q) ds[q, p-(T-1-q)] qv[q]    (float32 over the batch)
//
// What bounds it: at the training shape (B=16, T=468, 4 heads of 64) the
// passes below run ~11 products of 2*B*H*T*T*64 (the two recomputed score
// pairs, dp twice, dv, dk, dqu, dqv, dpe) = ~20 GFLOP against ~40 MB of
// bf16 inputs and outputs, so the tensor cores bound it, not HBM.
//
// Design. The TPU kernel held a head's whole (T, T) and (T, Wp) score
// blocks in VMEM and un-shifted the position-score gradient with a row
// reversal and a strided lane rotate, because Mosaic cannot gather
// (`_shift_bwd_rolled`, `_rev_matrix`). Here the un-shift is an index, as
// the forward's shift is: for a 64 x 64 (query, key) tile the position
// rows read are the 127 rows from p0 = T-1-(q0+63)+k0, and a warp owning
// query rows q0+16w.. touches the 80 of them from tile row 48-16w, at
// column 15-r+kj for its row r and key kj. Three passes, as K1b's
// (packed_flash_bwd.cu), with nothing carried between blocks:
//   (a) rowdot: dd = rowsum(do * o) (B, H, T), one warp per (row, head);
//   (b) dkdv: one block per (64-key tile, head, batch row), looping over
//       the query tiles; the position scores of the query tile are the
//       forward's four (16, 80) warp blocks, read across warps after a
//       block barrier, because here a warp owns keys;
//   (c) dq: one block per (64-query tile, head, batch row), looping over
//       the key tiles; each warp writes its ds rows twice, as a (16, 64)
//       tile for dqu and shifted onto its 80 pe rows for dqv and dpe;
//       dpe's per-tile (80, 64) products are summed into a 128-row float32
//       band in shared memory (shared atomics, a lane per column so that
//       a warp's 32 atomics hit 32 banks: the warps' rows overlap).
//       The band slides with the key tile: after tile k0 its first 64 rows
//       are final for this block and are added into the (Wp, D) float32
//       dpe with global float32 atomics (every batch row and query tile
//       adds into the same rows), the upper 64 move down. The caller zeroes
//       dpe and casts it to pe's dtype.
// Products are bf16 wmma 16x16x16 tiles with float32 accumulation. Keys
// and queries past T get p = 0; pe rows outside 0 .. 2T-2 are loaded as
// zeros and get no gradient.

constexpr int DLD = PC + 8;  // bf16 stride of the shifted ds rows (80 used)

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// acc[nt] += a (16 x 16*KT bf16, stride lda) . b (16*KT x 64, stride DH).
template <int KT>
__device__ __forceinline__ void mm_ab_acc(Acc* acc, const bf16* a, int lda, const bf16* b) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(af, a + kt * 16, lda);
      wmma::load_matrix_sync(bfr, b + kt * 16 * DH + nt * 16, DH);
      wmma::mma_sync(acc[nt], af, bfr, acc[nt]);
    }
  }
}

// Write a warp's 16 x 64 accumulator rows [row0, row0 + 16) of a packed
// output (rows >= T skipped) through the f32 tile s_w.
__device__ __forceinline__ void store_rows(bf16* dst, Acc* acc, float* s_w, int row0,
                                           int T, int D) {
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
      *reinterpret_cast<__nv_bfloat162*>(out + j) =
          __floats2bfloat162_rn(s_w[r * SLD + c0 + j], s_w[r * SLD + c0 + j + 1]);
  }
}

// (a) dd[b, h, t] = sum over the head's 64 columns of do * o, in f32.
__global__ void relpos_rowdot_kernel(const bf16* __restrict__ dout,
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

struct SmemDkdv {
  bf16 k[BK * DH];  // the block's own keys
  bf16 v[BK * DH];
  bf16 qu[BQ * DH];  // the streamed query tile
  bf16 qv[BQ * DH];
  bf16 dout[BQ * DH];
  bf16 don[BQ * DH];  // bf16(do / l)
  bf16 pe[PW * DH];
  float m[BQ], linv[BQ], dd[BQ];
  float pos[WARPS][16 * QLD];  // the query tile's position scores, as the forward's
  float s[WARPS][16 * SLD];
  bf16 p[WARPS][16 * PLD];
  bf16 ds[WARPS][16 * PLD];
};

// (b) dk, dv of one (64-key tile, head, batch row).
__global__ void __launch_bounds__(THREADS)
relpos_dkdv_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ qv,
                   const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const bf16* __restrict__ pe, const float* __restrict__ mask,
                   const bf16* __restrict__ dout, const float* __restrict__ row_m,
                   const float* __restrict__ row_l, const float* __restrict__ dd,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemDkdv& sm = *reinterpret_cast<SmemDkdv*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const int n_real = 2 * T - 1;
  const size_t base = (size_t)b * T * D + (size_t)h * DH;
  const size_t bh = ((size_t)b * H + h) * T;

  load_rows(sm.k, k + base, k0, BK, 0, T, D);
  load_rows(sm.v, v + base, k0, BK, 0, T, D);

  const int r = lane >> 1;         // this lane's key row within the warp's 16
  const int c0 = (lane & 1) * 32;  // and its half of the tile's 64 query columns
  const int key = k0 + warp * 16 + r;
  const float kmask = key < T ? mask[(size_t)b * T + key] : 0.f;
  float* s_w = sm.s[warp];
  bf16* p_w = sm.p[warp];
  bf16* ds_w = sm.ds[warp];
  const bf16* k_w = sm.k + warp * 16 * DH;
  const bf16* v_w = sm.v + warp * 16 * DH;

  Acc dk_acc[4], dv_acc[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    wmma::fill_fragment(dk_acc[nt], 0.f);
    wmma::fill_fragment(dv_acc[nt], 0.f);
  }

  for (int q0 = 0; q0 < T; q0 += BQ) {
    __syncthreads();  // the previous query tile's reads are done
    load_rows(sm.qu, qu + base, q0, BQ, 0, T, D);
    load_rows(sm.qv, qv + base, q0, BQ, 0, T, D);
    load_rows(sm.dout, dout + base, q0, BQ, 0, T, D);
    const int p0 = T - 1 - (q0 + BQ - 1) + k0;
    load_rows(sm.pe, pe + h * DH, p0, PW, 0, n_real, D);
    if (tid < BQ) {
      const int qi = q0 + tid;
      sm.m[tid] = qi < T ? row_m[bh + qi] : 0.f;
      sm.linv[tid] = qi < T ? 1.f / row_l[bh + qi] : 0.f;
      sm.dd[tid] = qi < T ? dd[bh + qi] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < BQ * DH; i += THREADS)
      sm.don[i] = __float2bfloat16(__bfloat162float(sm.dout[i]) * sm.linv[i / DH]);
    // the query rows 16w.. of the tile: their position scores against
    // the 80 pe rows from tile row 48-16w (the forward's warp block)
    rows_dot<PC / 16>(sm.pos[warp], QLD, sm.qv + warp * 16 * DH, sm.pe + (48 - 16 * warp) * DH);
    rows_dot<BQ / 16>(s_w, SLD, k_w, sm.qu);  // content scores^T (16 keys x 64 q)
    __syncthreads();  // every warp's position block and don are written

    // query column c of key row r: position column 15-(c%16)+(key-k0) of
    // the block of the warp that owns query row c
    float pv[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = c0 + j;
      const float x = (s_w[r * SLD + c] +
                       sm.pos[c >> 4][(c & 15) * QLD + 15 - (c & 15) + warp * 16 + r]) * scale +
                      kmask;
      pv[j] = (q0 + c < T && key < T) ? expf(x - sm.m[c]) : 0.f;
      p_w[r * PLD + c] = __float2bfloat16(pv[j]);
    }
    __syncwarp();
    rows_dot<BQ / 16>(s_w, SLD, v_w, sm.dout);  // dp^T (16 keys x 64 q)
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = c0 + j;
      ds_w[r * PLD + c] =
          __float2bfloat16(pv[j] * (s_w[r * SLD + c] - sm.dd[c]) * sm.linv[c] * scale);
    }
    __syncwarp();
    mm_ab_acc<4>(dv_acc, p_w, PLD, sm.don);  // dv += p^T . (do / l)
    mm_ab_acc<4>(dk_acc, ds_w, PLD, sm.qu);  // dk += ds^T . qu
  }

  store_rows(dk + base, dk_acc, s_w, k0 + warp * 16, T, D);
  store_rows(dv + base, dv_acc, s_w, k0 + warp * 16, T, D);
}

struct SmemDq {
  bf16 qu[BQ * DH];  // the block's own query rows
  bf16 qv[BQ * DH];
  bf16 dout[BQ * DH];
  bf16 k[BK * DH];  // the streamed key tile
  bf16 v[BK * DH];
  bf16 pe[PW * DH];
  float kmask[BK];
  float pos[WARPS][16 * QLD];
  float s[WARPS][16 * SLD];
  bf16 ds[WARPS][16 * PLD];
  bf16 dsh[WARPS][16 * DLD];  // ds shifted onto the warp's 80 pe rows
  float band[PW * DH];        // dpe of the tile's 128 pe rows
};

// Add the band's rows [0, 64) (pe rows p0 ..) into dpe and slide the
// upper 64 rows down.
__device__ __forceinline__ void flush_band(float* band, float* dpe, int p0, int n_real,
                                           int D, int h) {
  for (int i = threadIdx.x; i < 64 * DH; i += THREADS) {
    const int p = p0 + (i >> 6);
    const float val = band[i];
    if (p >= 0 && p < n_real && val != 0.f)
      atomicAdd(dpe + (size_t)p * D + h * DH + (i & 63), val);
    band[i] = band[i + 64 * DH];
    band[i + 64 * DH] = 0.f;
  }
}

// (c) dqu, dqv of one (64-query tile, head, batch row), and its share of dpe.
__global__ void __launch_bounds__(THREADS)
relpos_dq_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ qv,
                 const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const bf16* __restrict__ pe, const float* __restrict__ mask,
                 const bf16* __restrict__ dout, const float* __restrict__ row_m,
                 const float* __restrict__ row_l, const float* __restrict__ dd,
                 bf16* __restrict__ dqu, bf16* __restrict__ dqv, float* __restrict__ dpe,
                 int T, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemDq& sm = *reinterpret_cast<SmemDq*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const int n_real = 2 * T - 1;
  const size_t base = (size_t)b * T * D + (size_t)h * DH;

  load_rows(sm.qu, qu + base, q0, BQ, 0, T, D);
  load_rows(sm.qv, qv + base, q0, BQ, 0, T, D);
  load_rows(sm.dout, dout + base, q0, BQ, 0, T, D);
  for (int i = tid; i < PW * DH; i += THREADS) sm.band[i] = 0.f;

  const int r = lane >> 1;         // this lane's query row within the warp's 16
  const int c0 = (lane & 1) * 32;  // and its half of the tile's 64 keys
  const int row = q0 + warp * 16 + r;
  const size_t at = ((size_t)b * H + h) * T + row;
  const float row_max = row < T ? row_m[at] : 0.f;
  const float row_linv = row < T ? 1.f / row_l[at] : 0.f;
  const float row_dd = row < T ? dd[at] : 0.f;
  float* s_w = sm.s[warp];
  float* pos_w = sm.pos[warp];
  bf16* ds_w = sm.ds[warp];
  bf16* dsh_w = sm.dsh[warp];
  const bf16* qu_w = sm.qu + warp * 16 * DH;
  const bf16* qv_w = sm.qv + warp * 16 * DH;
  const bf16* do_w = sm.dout + warp * 16 * DH;
  const bf16* pe_w = sm.pe + (48 - 16 * warp) * DH;

  Acc dqu_acc[4], dqv_acc[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    wmma::fill_fragment(dqu_acc[nt], 0.f);
    wmma::fill_fragment(dqv_acc[nt], 0.f);
  }

  int p0 = 0;
  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // the previous key tile's reads and the band's slide are done
    load_rows(sm.k, k + base, k0, BK, 0, T, D);
    load_rows(sm.v, v + base, k0, BK, 0, T, D);
    p0 = T - 1 - (q0 + BQ - 1) + k0;
    load_rows(sm.pe, pe + h * DH, p0, PW, 0, n_real, D);
    if (tid < BK) sm.kmask[tid] = k0 + tid < T ? mask[(size_t)b * T + k0 + tid] : 0.f;
    for (int i = lane; i < 16 * DLD; i += 32) dsh_w[i] = __float2bfloat16(0.f);
    __syncthreads();

    rows_dot<BK / 16>(s_w, SLD, qu_w, sm.k);   // content scores (16 x 64)
    rows_dot<PC / 16>(pos_w, QLD, qv_w, pe_w);  // position scores (16 x 80)
    __syncwarp();
    float pv[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kj = c0 + j;
      const float x = (s_w[r * SLD + kj] + pos_w[r * QLD + 15 - r + kj]) * scale + sm.kmask[kj];
      pv[j] = (row < T && k0 + kj < T) ? expf(x - row_max) : 0.f;
    }
    __syncwarp();
    rows_dot<BK / 16>(s_w, SLD, do_w, sm.v);  // dp (16 x 64)
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kj = c0 + j;
      const bf16 d = __float2bfloat16(pv[j] * (s_w[r * SLD + kj] - row_dd) * row_linv * scale);
      ds_w[r * PLD + kj] = d;
      dsh_w[r * DLD + 15 - r + kj] = d;
    }
    __syncwarp();
    mm_ab_acc<4>(dqu_acc, ds_w, PLD, sm.k);       // dqu += ds . k
    mm_ab_acc<PC / 16>(dqv_acc, dsh_w, DLD, pe_w);  // dqv += ds (shifted) . pe

    // dpe rows 48-16w+c of the tile += dsh[:, c]^T . qv_w, 16 columns at a time
#pragma unroll 1
    for (int pt = 0; pt < PC / 16; ++pt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        Acc acc;
        wmma::fill_fragment(acc, 0.f);
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(af, dsh_w + pt * 16, DLD);
        wmma::load_matrix_sync(bfr, qv_w + nt * 16, DH);
        wmma::mma_sync(acc, af, bfr, acc);
        wmma::store_matrix_sync(s_w + nt * 16, acc, SLD, wmma::mem_row_major);
      }
      __syncwarp();
      // lane = column: the 32 lanes of each atomic hit 32 banks
      float* band_w = sm.band + (48 - 16 * warp + pt * 16) * DH;
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        atomicAdd(&band_w[i * DH + lane], s_w[i * SLD + lane]);
        atomicAdd(&band_w[i * DH + 32 + lane], s_w[i * SLD + 32 + lane]);
      }
      __syncwarp();
    }
    __syncthreads();  // the band holds every warp's share of this tile
    flush_band(sm.band, dpe, p0, n_real, D, h);
  }
  __syncthreads();
  flush_band(sm.band, dpe, p0 + 64, n_real, D, h);

  store_rows(dqu + base, dqu_acc, s_w, q0 + warp * 16, T, D);
  store_rows(dqv + base, dqv_acc, s_w, q0 + warp * 16, T, D);
}

}  // namespace

// qu, qv, k, v, o: (B, T, H*64) bf16; pe: (n_pe >= 2T-1, H*64) bf16 (rows
// 0 .. 2T-2 read); mask: (B, T) f32 additive; all contiguous and 16-byte
// aligned. row_m, row_l: (B, H, T) f32 outputs (the row max and sum the
// backward reads), or both null. Returns cudaGetLastError() after the
// launch.
extern "C" int relpos_flash_fwd(const void* qu, const void* qv, const void* k,
                                const void* v, const void* pe, const void* mask, void* o,
                                void* row_m, void* row_l, int B, int T, int H,
                                void* stream) {
  const int smem = (int)sizeof(Smem);  // 97280 bytes: above the 48 KB default
  // Set on every launch: the attribute is per device, and it is cheap.
  const cudaError_t attr = cudaFuncSetAttribute(
      relpos_flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  relpos_flash_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)qu, (const bf16*)qv, (const bf16*)k, (const bf16*)v, (const bf16*)pe,
      (const float*)mask, (bf16*)o, (float*)row_m, (float*)row_l, T, H,
      0.125f /* 64^-0.5 */);
  return (int)cudaGetLastError();
}

// The backward of relpos_flash_fwd. Inputs as there, plus o and dout
// (B, T, H*64) bf16 and the forward's row_m, row_l (B, H, T) f32; dd:
// (B, H, T) f32 scratch; outputs dqu, dqv, dk, dv (B, T, H*64) bf16 and dpe
// (n_pe, H*64) f32, which the caller zeroes (rows from 2T-1 on stay 0).
// Launches (a), (b), (c) on `stream`; returns the first cudaGetLastError()
// that is not cudaSuccess, or cudaSuccess.
extern "C" int relpos_flash_bwd(const void* qu, const void* qv, const void* k,
                                const void* v, const void* pe, const void* mask,
                                const void* o, const void* dout, const void* row_m,
                                const void* row_l, void* dd, void* dqu, void* dqv, void* dk,
                                void* dv, void* dpe, int B, int T, int H, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int smem_kv = (int)sizeof(SmemDkdv), smem_q = (int)sizeof(SmemDq);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(relpos_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return (int)err;
  const float scale = 0.125f;  // 64^-0.5

  const int rows = B * T * H;
  relpos_rowdot_kernel<<<(rows + 7) / 8, 256, 0, st>>>((const bf16*)dout, (const bf16*)o,
                                                       (float*)dd, B, T, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  dim3 grid((T + BQ - 1) / BQ, H, B);
  relpos_dkdv_kernel<<<grid, THREADS, smem_kv, st>>>(
      (const bf16*)qu, (const bf16*)qv, (const bf16*)k, (const bf16*)v, (const bf16*)pe,
      (const float*)mask, (const bf16*)dout, (const float*)row_m, (const float*)row_l,
      (const float*)dd, (bf16*)dk, (bf16*)dv, T, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  relpos_dq_kernel<<<grid, THREADS, smem_q, st>>>(
      (const bf16*)qu, (const bf16*)qv, (const bf16*)k, (const bf16*)v, (const bf16*)pe,
      (const float*)mask, (const bf16*)dout, (const float*)row_m, (const float*)row_l,
      (const float*)dd, (bf16*)dqu, (bf16*)dqv, (float*)dpe, T, H, scale);
  return (int)cudaGetLastError();
}
