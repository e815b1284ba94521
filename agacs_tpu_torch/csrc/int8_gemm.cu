// K8: the W8A8 linear of the frozen int8 trunk, forward and dgrad, as
// hand-written sm_90a kernels (int32 accumulation on the s8 tensor cores).
//
// Replaces agacs_tpu/ops/int8_linear.py `int8_matmul` (:83-127): on the
// TPU an XLA int8 dot_general with `_row_quant` fused into its producers,
// not a Pallas kernel.
//
//   K8q int8_rowquant: per row of x (M, K), float32 v = x (* colscale), s =
//       max(max|v|, 1e-12) / 127, q = round(v / s) -> int8 q (M, K), f32 s
//       (M,). The colscale is the dgrad's `dy * w_s` (:111). One warp per
//       row, two passes over it (the second from L1/L2).
//   K8g int8_gemm: out = (acc * s_row) [* w_s[col]] cast to bf16 or f32,
//       acc = q (M, K) . w, int32. w is the JAX buffer w_q (d_in, d_out)
//       read row-major (forward: K = d_in, N = d_out) or as w_q^T (dgrad:
//       K = d_out, N = d_in, its rows copied as they are). Bias is added
//       outside, as in JAX (:151-152). Two kernels:
//     * gemm_kernel, every dgrad and every forward above 64 rows: a 64 x 64
//       output tile per block of 4 warps, each warp 32 x 32 (2 x 4
//       m16n8k32 products per 32 k), 64-byte k slabs staged in shared
//       memory without double buffering (the forward through a 4x4 byte
//       transpose, `stage_trans`);
//     * thin_gemm_kernel, the forward at 64 rows or fewer (a decode step's
//       8 or 40): the thin-row design of thin_rows.cuh. The raw int8 weight
//       streams through a 4-slot cp.async ring of 128-row stages (3 in
//       flight), the stage's slice of the int8 rows beside it; the weight
//       tile is the mma's A (its columns as A's rows), the rows are B, and
//       each thread turns the 4-byte words it reads (rows 8t..8t+7 of a
//       32-row step, columns 4g..4g+3) into A fragments with a 4x4 byte
//       transpose in registers, so w_q is never copied. K is split over a
//       cluster of S <= 8 blocks (`int8_serve.thin_tiling`) whose int32
//       partials rank 0 adds: exact, so the result is bit-identical to the
//       plain version whatever the order.
//
// Bound on the H100 (989/1979 TOPS int8 dense, 3.35 TB/s): at (12000, 768)
// -> 768 the product is 14.2 GOP (7.2 us) and the bytes ~28 MB (8.3 us):
// bytes-bound; at 8 rows the 0.6-2.4 MB weight read bounds it (< 1 us).
// The 64-row kernel is neither: every k slab waits for its load, and the
// forward transposes the weight tile on every read. Levers for a later
// change: cp.async or TMA double buffering, wgmma, the row quantisation
// fused into the producer or into the GEMM's A load.
#include "int8_mma.cuh"
#include "thin_rows.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 64, LDS = BK + 16;  // 80-byte rows: no bank conflicts
constexpr int THREADS = 128;

template <bool BF16>
__global__ void __launch_bounds__(256) rowquant_kernel(const void* __restrict__ x,
                                                       const float* __restrict__ cs,
                                                       int8_t* __restrict__ q,
                                                       float* __restrict__ s, int M,
                                                       int K) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t base = (size_t)row * K;
  float m = 0.f;
  for (int c = lane; c < K; c += 32) {
    float v = i8::ldf<BF16>(x, base + c);
    if (cs) v = __fmul_rn(v, cs[c]);
    m = fmaxf(m, fabsf(v));
  }
  const float sc = i8::quant_scale(i8::warp_max(m));
  for (int c = lane; c < K; c += 32) {
    float v = i8::ldf<BF16>(x, base + c);
    if (cs) v = __fmul_rn(v, cs[c]);
    q[base + c] = i8::quant(v, sc);
  }
  if (lane == 0) s[row] = sc;
}

template <bool DGRAD, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS) gemm_kernel(
    const int8_t* __restrict__ a, const float* __restrict__ s_row,
    const int8_t* __restrict__ w, const float* __restrict__ w_s, void* __restrict__ out,
    int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[BM * LDS];
  __shared__ __align__(16) int8_t sB[BN * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    i8::stage_rows<BM, BK>(sA, LDS, a, K, m0, M, k0, K, tid, THREADS);
    if constexpr (DGRAD)  // w_q (N, K) row-major is already Bt
      i8::stage_rows<BN, BK>(sB, LDS, w, K, n0, N, k0, K, tid, THREADS);
    else                  // w_q (K, N) row-major
      i8::stage_trans<BK, BN>(sB, LDS, w, N, k0, K, n0, N, tid, THREADS);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) i8::load_a(af[i], sA + (wm + 16 * i) * LDS + kk, LDS, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) i8::load_b(bf[j], sB + (wn + 8 * j) * LDS + kk, LDS, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) i8::mma(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm + 16 * i + g + 8 * hh;
      if (row >= M) continue;
      const float sr = s_row[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + 8 * j + 2 * t;
        if (col >= N) continue;
        float v0 = __fmul_rn((float)acc[i][j][2 * hh], sr);
        float v1 = __fmul_rn((float)acc[i][j][2 * hh + 1], sr);
        if (!DGRAD) {
          v0 = __fmul_rn(v0, w_s[col]);
          v1 = __fmul_rn(v1, w_s[col + 1]);
        }
        const size_t o = (size_t)row * N + col;
        i8::stf<OUT_BF16>(out, o, v0);
        i8::stf<OUT_BF16>(out, o + 1, v1);
      }
    }
}

// The thin forward (M <= 64): 128 weight rows a stage, 4 mma steps of 32.
constexpr int TKR = 128;
constexpr int TG = 8;  // rows a thread reads per step (wrow's pad period)
constexpr int THIN_ROWS = 64;

template <int BN>
__host__ __device__ constexpr int thin_w_bytes() {
  return TKR * BN + (TKR / TG) * 32;
}

template <int BN, int NT>
__host__ __device__ constexpr int thin_stage_bytes() {
  return thin_w_bytes<BN>() + 8 * NT * thin::A_LD;
}

// o[c] = byte c of r0, r1, r2, r3 (in that order): a 4x4 byte transpose.
__device__ __forceinline__ void trans4(uint32_t (&o)[4], uint32_t r0, uint32_t r1,
                                       uint32_t r2, uint32_t r3) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140), hi01 = __byte_perm(r0, r1, 0x7362);
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140), hi23 = __byte_perm(r2, r3, 0x7362);
  o[0] = __byte_perm(lo01, lo23, 0x5410);
  o[1] = __byte_perm(lo01, lo23, 0x7632);
  o[2] = __byte_perm(hi01, hi23, 0x5410);
  o[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Block (x, rank): columns [BN x, BN x + BN), all M rows, k stages
// [rank * per, rank * per + per) of 128 rows. The mma's k order is
// permuted: thread t's k bytes 4t..4t+3 and 16+4t..16+4t+3 of a step are
// the step's rows 8t..8t+3 and 8t+4..8t+7, in A and in B alike.
template <int BN, int NT, bool OUT_BF16>
__global__ void __launch_bounds__(thin::THREADS) thin_gemm_kernel(
    const int8_t* __restrict__ a, const float* __restrict__ s_row,
    const int8_t* __restrict__ w, const float* __restrict__ w_s, void* __restrict__ out,
    int M, int N, int K, int per) {
  using namespace thin;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int WK = THREADS / BN;
  constexpr int SB = thin_stage_bytes<BN, NT>();
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  if (S > 1) cluster_arrive_relaxed();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % (BN / 32), wk = warp / (BN / 32);
  const int n0 = blockIdx.x * BN;
  const int n_stages = (K + TKR - 1) / TKR;
  const int st0 = rank * per, nst = max(0, min(n_stages, st0 + per) - st0);

  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto fetch = [&](int j) {
    if (j < nst) {
      unsigned char* slot = smem + (j % STAGES) * SB;
      const int k0 = (st0 + j) * TKR;
      fetch_stage<BN, TKR, TG, NT>(slot, slot + thin_w_bytes<BN>(), w, K, N, k0, n0,
                                   reinterpret_cast<const unsigned char*>(a), (size_t)K, M,
                                   (size_t)k0, (size_t)K, tid);
    }
    cp_commit();
  };
  for (int j = 0; j < STAGES - 1; ++j) fetch(j);

  for (int j = 0; j < nst; ++j) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    fetch(j + STAGES - 1);
    const unsigned char* tile = smem + (j % STAGES) * SB;
    const unsigned char* act = tile + thin_w_bytes<BN>();
#pragma unroll
    for (int s = 0; s < STEPS / WK; ++s) {
      const int q = wk + s * WK;
      uint32_t wv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        wv[r] = ld32(tile + wrow<BN, TG>(32 * q + 8 * t + r) + wn * 32 + 4 * g);
      uint32_t lo[4], hi[4];  // lo[c]: rows 8t..8t+3 of column 4g + c; hi: 8t+4..8t+7
      trans4(lo, wv[0], wv[1], wv[2], wv[3]);
      trans4(hi, wv[4], wv[5], wv[6], wv[7]);
      const uint32_t af[2][4] = {{lo[0], lo[1], hi[0], hi[1]}, {lo[2], lo[3], hi[2], hi[3]}};
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        const uint2 b2 = ld64(act + (8 * jt + g) * A_LD + 32 * q + 8 * t);
        const uint32_t b[2] = {b2.x, b2.y};
        i8::mma(acc[0][jt], af[0], b);
        i8::mma(acc[1][jt], af[1], b);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  reduce_put<BN, NT>(acc, reinterpret_cast<int*>(smem),
                     reinterpret_cast<int*>(smem + STAGES * SB), wn, wk, M, S, rank,
                     [&](int r, int c, int4 v) {
                       const int col = n0 + c;
                       if (col >= N) return;  // four columns, all in or all out
                       const float sr = s_row[r];
                       const int vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                       for (int e = 0; e < 4; ++e)
                         i8::stf<OUT_BF16>(out, (size_t)r * N + col + e,
                                           __fmul_rn(__fmul_rn((float)vs[e], sr), w_s[col + e]));
                     });
}

template <int BN, int NT, bool OUT_BF16>
int launch_thin_nt(const int8_t* a, const float* s_row, const int8_t* w, const float* w_s,
                   void* out, int M, int N, int K, int S, cudaStream_t stream) {
  static bool opted[thin::MAX_DEVICES] = {};
  return thin::launch_split<BN, NT, thin_stage_bytes<BN, NT>(), int>(
      thin_gemm_kernel<BN, NT, OUT_BF16>, opted, (K + TKR - 1) / TKR, S, (N + BN - 1) / BN, 1,
      stream, a, s_row, w, w_s, out, M, N, K);
}

template <int BN, bool OUT_BF16>
int launch_thin_rows(const int8_t* a, const float* s_row, const int8_t* w, const float* w_s,
                     void* out, int M, int N, int K, int S, cudaStream_t stream) {
  if (M <= 8) return launch_thin_nt<BN, 1, OUT_BF16>(a, s_row, w, w_s, out, M, N, K, S, stream);
  if (M <= 16) return launch_thin_nt<BN, 2, OUT_BF16>(a, s_row, w, w_s, out, M, N, K, S, stream);
  if (M <= 32) return launch_thin_nt<BN, 4, OUT_BF16>(a, s_row, w, w_s, out, M, N, K, S, stream);
  return launch_thin_nt<BN, 8, OUT_BF16>(a, s_row, w, w_s, out, M, N, K, S, stream);
}

int launch_thin(const int8_t* a, const float* s_row, const int8_t* w, const float* w_s,
                void* out, bool out_bf16, int M, int N, int K, int bn, int S,
                cudaStream_t stream) {
  if (M > THIN_ROWS || (bn != 32 && bn != 128)) return (int)cudaErrorInvalidValue;
  if (bn == 128)
    return out_bf16 ? launch_thin_rows<128, true>(a, s_row, w, w_s, out, M, N, K, S, stream)
                    : launch_thin_rows<128, false>(a, s_row, w, w_s, out, M, N, K, S, stream);
  return out_bf16 ? launch_thin_rows<32, true>(a, s_row, w, w_s, out, M, N, K, S, stream)
                  : launch_thin_rows<32, false>(a, s_row, w, w_s, out, M, N, K, S, stream);
}

}  // namespace

extern "C" int int8_rowquant(const void* x, int x_bf16, const float* colscale,
                             int8_t* q, float* s, int M, int K, cudaStream_t stream) {
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + 7) / 8);
  if (x_bf16)
    rowquant_kernel<true><<<grid, 256, 0, stream>>>(x, colscale, q, s, M, K);
  else
    rowquant_kernel<false><<<grid, 256, 0, stream>>>(x, colscale, q, s, M, K);
  return (int)cudaGetLastError();
}

// out (M, N) = (a (M, K) . B) * s_row [* w_s]; B = w (K, N) if !dgrad, else
// w^T with w (N, K). K % 16 == 0 and N % 16 == 0; 16-byte aligned buffers.
// The forward at M <= 64 takes the thin kernel with bn (32 or 128) columns
// a block and K split over `splits` (1..8) blocks of a cluster
// (`int8_serve.thin_tiling`); every other call the 64-row kernel, which
// ignores bn and splits.
extern "C" int int8_gemm(const int8_t* a, const float* s_row, const int8_t* w,
                         const float* w_s, void* out, int out_bf16, int M, int N,
                         int K, int dgrad, int bn, int splits, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % 16 || (!dgrad && !w_s))
    return (int)cudaErrorInvalidValue;
  if (!dgrad && M <= THIN_ROWS)
    return launch_thin(a, s_row, w, w_s, out, out_bf16, M, N, K, bn, splits, stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (dgrad) {
    if (out_bf16)
      gemm_kernel<true, true><<<grid, THREADS, 0, stream>>>(a, s_row, w, w_s, out, M, N, K);
    else
      gemm_kernel<true, false><<<grid, THREADS, 0, stream>>>(a, s_row, w, w_s, out, M, N, K);
  } else {
    if (out_bf16)
      gemm_kernel<false, true><<<grid, THREADS, 0, stream>>>(a, s_row, w, w_s, out, M, N, K);
    else
      gemm_kernel<false, false><<<grid, THREADS, 0, stream>>>(a, s_row, w, w_s, out, M, N, K);
  }
  return (int)cudaGetLastError();
}
