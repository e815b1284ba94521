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
// Backward above K 256 (the whisper family's CTC head: K 384, 512, 768,
// 1024, 1280; `vocab_lse_split_kernel<DW, CM>`, one template for dx and
// dw). A warpgroup's 64 x K f32 accumulator does not fit its registers
// there (384 a thread at K 768) and x's 128 rows take 192 KB, so the K-wide
// accumulator is split over a thread-block cluster: C = K / KS ranks (KS
// 128: C 3 to 8, the portable size at K 1024; 9 and 10 above, up to K_MAX
// 1280, whisper-large's width, on a non-portable cluster, `CM` WIDE_C)
// work on one output tile (dx:
// 128 rows, dw: 128 vocabulary columns; two consumer warpgroups of 64), and
// rank r owns the K-slice [r KS, (r + 1) KS) of the accumulator and of the
// resident operand (dx: x's slice of the row tile; dw: W's slice of the
// column block; TMA). Each rank streams its slice of the other operand
// through its own 4-slot TMA ring (dx: W's KS x 64 tiles with their bias
// strips; dw: x's 64 x KS tiles with their lse and g strips), a producer
// warpgroup handing its registers to the consumers (setmaxnreg) as at K <=
// 256: every element is read from L2 by one rank, once per output tile,
// and no rank rebuilds z. Per tile a warpgroup computes its partial S_r
// over the slice on wgmma m64n64k16 (`issue_s`, `issue_st`). The exchange
// is a reduce-scatter of the f32 partials and an all-gather of packed bf16
// P, both by st.async (`hopper.cuh`): stores into another rank's shared
// memory that complete their bytes on its mbarrier, so no fence orders
// them. Rank r owns quads [r 32 / C, (r + 1) 32 / C) of the warpgroup's 32
// (a quad: the 4 threads that hold rows a, a + 8); each thread stores its
// 32 S values into its quad's owner (two slots, room for C ceil(32 / C)
// quads), the owner waits for every rank's bytes, adds the C partials of
// each of its float4 in rank order, takes dz and stores the packed bf16
// pairs into every rank's P (two slots), and each thread loads its own
// packed P once every rank's bytes of it have landed. Every rank so holds
// the same S, the C partials added in rank order, with no atomics,
// bit-identical from run to run; (C - 1) / C x 48 KB cross the cluster a
// tile. The product of P lags its exchange by a tile, so its bytes land
// under a tile's work; a rank's barriers await a tile's bytes from the
// phase after the last wait on them, and a rank stores tile t + 2's
// partial or P only after it has seen every rank's P, or partial, of a
// tile that each produced after reading tile t: the double-buffered slots
// need no release barrier. P (dx) or dz^T (dw) then is the register A
// operand of dX[:, slice] += P W_slice^T or dW^T[:, slice] += dz^T X_slice
// (wgmma m64n128k16, on the tile still in the ring). dx stores its bf16
// slice directly (ranks own distinct columns); dw stores dW^T transposed
// into dW (K, Vp) rows [r KS, (r + 1) KS), and db, from the f32 dz, comes
// from the one rank that owns the column's quad. Rows >= N and columns >=
// V are masked by index (lse log2 e +inf and g 0; the bias -inf). Shared
// memory: 209,032 bytes at every K up to 1024 (`split_smem`), 217,224 above
// (`split_smem_wide`: a receive slot of RECV_WIDE quads); registers of a consumer
// thread: the accumulator KS / 2 = 64, S 32, packed P 16. The exchange
// bounds both kernels, its latency a tile with two slots (PERF.md: every
// rank reading every partial, the same exchange by loads of the others'
// partials with arrivals released at cluster scope, and by the TMA
// engine's bulk copies were slower). The C entries dispatch by K, and the
// tiling rules `vocab_lse.dx_tiling` / `dw_tiling` mirror them. Above K
// 1024 the same kernel runs on a cluster of 9 or 10 (the instance CM
// WIDE_C, launched with cudaFuncAttributeNonPortableClusterSizeAllowed):
// the quads no longer divide evenly over the ranks (3 or 4 a rank), and a
// GPC holds one such cluster, so ~80 of the 132 SMs work at once; the C
// entries ask cudaOccupancyMaxActiveClusters first and refuse a launch the
// card cannot hold.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

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
constexpr int K_MAX = 1280;     // the widest K the C entries take (whisper-large's d)
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
static_assert(fwd_bm(K_MAX) == 64 && fwd_smem(K_MAX, 64) <= SMEM_MAX,
              "K4's forward does not fit shared memory at K_MAX");

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

// ---------------------------------------------------------------------------
// The backward above K 256: the K-wide accumulator split over a cluster (see
// the header note)

constexpr int KS = 128;                 // the K-slice of a cluster rank
constexpr int SPLIT_STAGE = KS * 128;   // bytes of a ring slot: KS x 64 or 64 x KS bf16
constexpr int QBLK = 32 * 16;           // bytes of a quad's S tile: 32 float4
constexpr int PBLK = 32 * 8;            // bytes of a quad's packed P: 32 pairs of bf16 pairs
constexpr int RECV_QUADS = 36;          // max over C of C ceil(32 / C): a receive slot
constexpr int RECV_WIDE = 40;           // the same over C 9 and 10 (above K 1024)
constexpr int WIDE_C = K_MAX / KS;      // the widest cluster, 10: non-portable
constexpr int SPLIT_BARS = (1 + 2 * STAGES + 8) * 8;

// The split kernels' shared memory, the same at every K (a rank holds a
// KS-wide slice): the resident slice (128 x KS bf16), the ring (STAGES
// slots), the partials every rank sends for this rank's
// quads (2 slots x 2 warpgroups x RECV_QUADS quads, f32), P (2 x 2 x 32
// quads, bf16 pairs), the per-slot strips (two tables), the block's row or
// column tables (2 x 128 f32) and the barriers.
__host__ __device__ constexpr size_t split_smem() {
  return 1024 + 128 * KS * 2 + STAGES * SPLIT_STAGE + 4 * RECV_QUADS * QBLK + 4 * 32 * PBLK +
         2 * STRIPS + 2 * 128 * 4 + SPLIT_BARS;
}
static_assert(split_smem() <= 232448 && MAX_C * KS >= 1024 && 3 * KS > HK_MAX,
              "K4's split backward does not fit shared memory, or a cluster, at some K");
// The most quads of the receive slot over clusters of c0 to c1 ranks.
__host__ __device__ constexpr int recv_need(int c0, int c1) {
  return c0 > c1 ? 0
                 : (c0 * ((32 + c0 - 1) / c0) > recv_need(c0 + 1, c1) ? c0 * ((32 + c0 - 1) / c0)
                                                                     : recv_need(c0 + 1, c1));
}
// Above K 1024: the same layout with a receive slot of RECV_WIDE quads.
__host__ __device__ constexpr size_t split_smem_wide() {
  return split_smem() + 4 * (RECV_WIDE - RECV_QUADS) * QBLK;
}
static_assert(recv_need(3, MAX_C) == RECV_QUADS && recv_need(MAX_C + 1, WIDE_C) == RECV_WIDE &&
                  split_smem_wide() <= 232448 && WIDE_C * KS == K_MAX && WIDE_C <= 16,
              "K4's split backward does not fit shared memory, or a cluster, above K 1024");

// Rank r of C owns quads [r 32 / C, (r + 1) 32 / C) of a warpgroup's 32 (a
// quad: the 4 threads that hold rows a, a + 8); every rank sends it its
// partials of them into ceil(32 / C) quads' room.
__device__ __forceinline__ int quad0(int r, int C) { return r * 32 / C; }
__device__ __forceinline__ int quad_owner(int q, int C) { return ((q + 1) * C - 1) / 32; }
__device__ __forceinline__ int quad_room(int C) { return (32 + C - 1) / C; }

// Where float4 j (S values 4j..4j+3) of thread t of quad q lies among the
// quad's 32 (swizzled so that 8 lanes of two quads storing the same j, and
// a warp reading the 32 in order, touch every bank once), and where its
// packed pair j lies among the quad's packed P.
__device__ __forceinline__ int quad_at(int t, int j, int q) {
  return t * 8 + (j ^ (t | ((q & 1) << 2)));
}
__device__ __forceinline__ int pair_at(int t, int j, int q) { return t * 8 + (j ^ (q & 7)); }

// This thread's 32 S values (its tile's partial over the rank's slice) into
// its quad's owner's receive slot `recv` (one warpgroup, one slot) at [this
// rank][the quad among the owner's], each store completing on the owner's
// barrier `bar`.
__device__ __forceinline__ void send_part(float* recv, uint64_t* bar, const float (&sc)[32],
                                          int C, int rank, int tw) {
  const int q = tw >> 2, t = tw & 3, o = quad_owner(q, C);
  float4* dst = reinterpret_cast<float4*>(recv) + (rank * quad_room(C) + q - quad0(o, C)) * 32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    hop::st_async(dst + quad_at(t, j, q),
                  make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]), bar, o);
}

// This rank's share of one tile's exchange for a warpgroup, the
// reduce-scatter of the f32 partials and the all-gather of packed P: warp
// w takes this rank's quads w, w + 4, ... (at C >= 3 a rank has at most
// 11, 3 a warp); a lane adds the C ranks' partials of one float4 in rank
// order from the receive slot, takes dz (dx: the strip's bias by column,
// lse log2 e and g by row from the block's tables; dw: the table's bias by
// row, the strips' lse log2 e and g by column, its f32 values added into
// the lane's db sums sa, sb) and stores the two packed bf16 pairs into
// every rank's P (`pk`, one warpgroup, one slot), completing on its barrier
// `bar`.
template <bool DW, int CM>
__device__ __forceinline__ void reduce_quads(const float* recv, uint32_t* pk, uint64_t* bar,
                                             int C, int rank, int wg, const float* st0,
                                             const float* st1, const float* tb0,
                                             const float* tb1, float (&sa)[3], float (&sb)[3]) {
  const int lane = threadIdx.x & 31, q0 = quad0(rank, C), nq = quad0(rank + 1, C) - q0;
  const int room = quad_room(C);
  const float4* in = reinterpret_cast<const float4*>(recv);
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int lq = ((threadIdx.x >> 5) & 3) + 4 * m;
    if (lq >= nq) break;
    float4 z;
    if constexpr (CM > MAX_C) {  // a partial at a time: fewer registers live (above K 1024)
      z = in[lq * 32 + lane];
#pragma unroll
      for (int r = 1; r < CM; ++r)
        if (r < C) {
          const float4 u = in[(r * room + lq) * 32 + lane];
          z.x += u.x, z.y += u.y, z.z += u.z, z.w += u.w;
        }
    } else {
      float4 v[CM];
#pragma unroll
      for (int r = 0; r < CM; ++r)
        if (r < C) v[r] = in[(r * room + lq) * 32 + lane];
      z = v[0];
#pragma unroll
      for (int r = 1; r < CM; ++r)
        if (r < C) z.x += v[r].x, z.y += v[r].y, z.z += v[r].z, z.w += v[r].w;
    }
    // z: rows a, a + 8 of the tile at columns c, c + 1 (thread t of quad q, its float4 j)
    const int q = q0 + lq, t = lane >> 3, j = (lane & 7) ^ (t | ((q & 1) << 2));
    const int a = 64 * wg + 16 * (q >> 3) + (q & 7), c = 8 * j + 2 * t;
    float d0, d1, d2, d3;
    if constexpr (DW) {
      const float ba = tb0[a], bb = tb0[a + 8];
      const float2 l = *reinterpret_cast<const float2*>(st0 + c);
      const float2 gg = *reinterpret_cast<const float2*>(st1 + c);
      d0 = hop::ex2(fmaf(z.x + ba, LOG2E, -l.x)) * gg.x;
      d1 = hop::ex2(fmaf(z.y + ba, LOG2E, -l.y)) * gg.y;
      d2 = hop::ex2(fmaf(z.z + bb, LOG2E, -l.x)) * gg.x;
      d3 = hop::ex2(fmaf(z.w + bb, LOG2E, -l.y)) * gg.y;
      sa[m] += d0 + d1;
      sb[m] += d2 + d3;
    } else {
      const float2 bv = *reinterpret_cast<const float2*>(st0 + c);
      const float la = tb0[a], lb = tb0[a + 8], ga = tb1[a], gb = tb1[a + 8];
      d0 = hop::ex2(fmaf(z.x + bv.x, LOG2E, -la)) * ga;
      d1 = hop::ex2(fmaf(z.y + bv.y, LOG2E, -la)) * ga;
      d2 = hop::ex2(fmaf(z.z + bv.x, LOG2E, -lb)) * gb;
      d3 = hop::ex2(fmaf(z.w + bv.y, LOG2E, -lb)) * gb;
    }
    const uint2 pv = make_uint2(hop::pack_bf16(d0, d1), hop::pack_bf16(d2, d3));
    uint2* dst = reinterpret_cast<uint2*>(pk) + q * 32 + pair_at(t, j, q);
#pragma unroll
    for (int r = 0; r < CM; ++r)
      if (r < C) hop::st_async(dst, pv, bar, r);
  }
}

// This thread's packed P (its 16 register A fragments) from P.
__device__ __forceinline__ void load_pa(uint32_t (&pa)[16], const uint32_t* pk, int tw) {
  const int q = tw >> 2, t = tw & 3;
  const uint2* p = reinterpret_cast<const uint2*>(pk) + q * 32;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint2 u = p[pair_at(t, j, q)];
    pa[2 * j] = u.x, pa[2 * j + 1] = u.y;
  }
}

// A tile's partial S_r (dx: the warpgroup's 64 rows of x's slice . the W
// tile; dw: its 64 columns of W's slice^T . the x tile^T) and the second
// product (dx: dX += P W_tile^T; dw: dW^T += dz^T X_tile). Issued and
// committed.
template <bool DW>
__device__ __forceinline__ void split_s(float (&sc)[32], uint64_t rd, const unsigned char* slot) {
  if constexpr (DW) issue_st<KS>(sc, rd, slot);
  else issue_s<KS>(sc, rd, slot);
}
template <bool DW>
__device__ __forceinline__ void split_pv(float (&acc)[KS / 2], const uint32_t (&pa)[16],
                                         const unsigned char* slot) {
  if constexpr (DW) issue_pv<KS, 1>(acc, pa, slot, 2048, DW_BN * 128);
  else issue_pv<KS, 0>(acc, pa, slot, 32, 1024);
}

// dx (DW false: out the (N, K) bf16 dx) or dw (out the (K, Vp) f32 dW, db
// (Vp,)) at K = C KS: grid (C, row tiles or column blocks) in clusters of C
// along x, C at most CM (MAX_C, or WIDE_C with a receive slot of RECV_WIDE
// quads).
template <bool DW, int CM = MAX_C>
__global__ void __launch_bounds__(HTHREADS, 1)
vocab_lse_split_kernel(const __grid_constant__ Maps mp, const float* __restrict__ bias,
                       const float* __restrict__ lse, const float* __restrict__ g,
                       void* __restrict__ out, float* __restrict__ db, int N, int K, int V,
                       int Vp) {
  constexpr int RQ = CM > MAX_C ? RECV_WIDE : RECV_QUADS;  // quads of a receive slot
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  unsigned char* res = base;  // the resident slice: dx x's 128 rows, dw W's 128 columns
  unsigned char* ring = res + 128 * KS * 2;
  unsigned char* recv = ring + STAGES * SPLIT_STAGE;  // [slot][wg][RQ]
  unsigned char* pk = recv + 4 * RQ * QBLK;                 // [slot][wg][32 quads]: P
  float* st0 = reinterpret_cast<float*>(pk + 4 * 32 * PBLK);  // [ring slot][64]: dx b, dw lse log2 e
  float* st1 = st0 + STAGES * VT;                       // dw: g
  float* tb0 = st1 + STAGES * VT;  // the block's 128 rows' lse log2 e (dx) or columns' b (dw)
  float* tb1 = tb0 + 128;                // dx: the rows' g
  uint64_t* bars = reinterpret_cast<uint64_t*>(tb1 + 128);
  uint64_t* rfull = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* sfull = empty + STAGES;  // [slot][wg]: every rank's partials of my quads landed
  uint64_t* pfull = sfull + 4;             // [slot][wg]: every rank's quads of P landed
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.y * 128, k0 = rank * KS;  // the block's first row (dx) or column (dw)
  const int nt = DW ? (N + DW_BN - 1) / DW_BN : (V + VT - 1) / VT;  // tiles a rank sweeps
  const int q0 = quad0(rank, C), nq = quad0(rank + 1, C) - q0;
  // The bytes a phase of sfull and of pfull awaits: every rank's partials
  // of this rank's quads, and every rank's quads of P.
  const uint32_t s_bytes = C * nq * QBLK, p_bytes = 32 * PBLK;
  if (tid == 0) {
    hop::mbar_init(rfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 32);  // the producer warp's lanes
      hop::mbar_init(&empty[s], CONSUMERS / 32);
    }
    for (int i = 0; i < 4; ++i) {  // one arrival a phase, the rank's own, with the bytes it awaits
      hop::mbar_init(&sfull[i], 1);
      hop::mbar_init(&pfull[i], 1);
    }
    hop::mbar_fence_init();
    for (int i = 0; i < 4; ++i) {  // tiles 0 and 1
      hop::mbar_expect_tx(&sfull[i], s_bytes);
      hop::mbar_expect_tx(&pfull[i], p_bytes);
    }
  }
  cluster.sync();  // every rank's barriers initialised before the first remote store

  if (warp >= CONSUMERS / 32) {  // the producer: the tables and the slice once, then the tiles
    hop::reg_dealloc<40>();
    if (warp == CONSUMERS / 32) {  // one warp loads
      for (int i = lane; i < 128; i += 32) {
        const int j = b0 + i;
        if (DW) {
          tb0[i] = j < V ? bias[j] : -INFINITY;
        } else {
          tb0[i] = j < N ? lse[j] * LOG2E : INFINITY;
          tb1[i] = j < N ? g[j] : 0.f;
        }
      }
      __syncwarp();
      if (lane == 0) {
        hop::prefetch_map(&mp.x);
        hop::prefetch_map(&mp.w);
        hop::mbar_expect_tx(rfull, 128 * KS * 2);
        for (int kb = 0; kb < KS / 64; ++kb) {
          if (DW) {
            for (int h = 0; h < 2; ++h)
              hop::tma_load_2d(res + h * KS * 128 + kb * 8192, &mp.w, rfull, b0 + 64 * h,
                               k0 + 64 * kb);
          } else {
            hop::tma_load_2d(res + kb * DX_BM * 128, &mp.x, rfull, k0 + 64 * kb, b0);
          }
        }
      }
      Pos p;
      for (int it = 0; it < nt; ++it, p = p.next()) {
        const int s = p.s, j0 = it * 64;
        hop::mbar_wait(&empty[s], p.ph ^ 1);
        for (int c = lane; c < 64; c += 32) {
          const int j = j0 + c;
          if (DW) {
            st0[s * VT + c] = j < N ? lse[j] * LOG2E : INFINITY;
            st1[s * VT + c] = j < N ? g[j] : 0.f;
          } else {
            st0[s * VT + c] = j < V ? bias[j] : -INFINITY;
          }
        }
        if (lane == 0) {
          hop::mbar_expect_tx(&full[s], SPLIT_STAGE);
          for (int kb = 0; kb < KS / 64; ++kb) {
            if (DW)
              hop::tma_load_2d(ring + s * SPLIT_STAGE + kb * 8192, &mp.x, &full[s],
                               k0 + 64 * kb, j0);
            else
              hop::tma_load_2d(ring + s * SPLIT_STAGE + kb * 8192, &mp.w, &full[s], j0,
                               k0 + 64 * kb);
          }
        } else {
          hop::mbar_arrive(&full[s]);
        }
      }
    }
    __syncwarp();
    cluster.sync();  // no block exits while another still stores into its shared memory
    return;
  }
  hop::reg_alloc<232>();

  const int wg = warp >> 2, tw = tid & 127, t = lane & 3;
  const int ra = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // this thread's rows ra, ra + 8
  const bool lead = tw == 0;  // the warpgroup's thread that posts its barriers' bytes
  float* myrecv = reinterpret_cast<float*>(recv + wg * RQ * QBLK);  // + slot * rslot
  uint32_t* mypk = reinterpret_cast<uint32_t*>(pk + wg * 32 * PBLK);       // + slot * pslot
  constexpr int rslot = 2 * RQ * QBLK / 4, pslot = 2 * 32 * PBLK / 4;
  const uint64_t rd = hop::desc(res + wg * (DW ? KS * 128 : 64 * 128));
  float acc[KS / 2];
#pragma unroll
  for (int i = 0; i < KS / 2; ++i) acc[i] = 0.f;
  float sc[32];
  uint32_t pa[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = 0u;
  float sa[3] = {0.f, 0.f, 0.f}, sb[3] = {0.f, 0.f, 0.f};  // dw's db sums
  hop::mbar_wait(rfull, 0);
  hop::mbar_wait(&full[0], 0);
  __syncwarp();
  hop::wgmma_fence();
  split_s<DW>(sc, rd, ring);
  hop::wgmma_wait();
  hop::fence_regs(sc);
  send_part(myrecv, &sfull[wg], sc, C, rank, tw);
  // Tile it's exchange beside the product of tile it - 1's P (at tile 0 a
  // product of zeros on tile 0's slot, so that no wgmma sits under a
  // condition); the next tile's S_r in flight under both.
  Pos p, pp;  // tiles it's and it - 1's ring slots
  for (int it = 0; it < nt; ++it) {
    const bool more = it + 1 < nt;
    const Pos nx = p.next();
    const int x = it & 1;
    if (more) hop::mbar_wait(&full[nx.s], nx.ph);
    __syncwarp();
    hop::wgmma_fence();
    // the next tile's S_r (after the last tile a product whose result is dropped)
    split_s<DW>(sc, rd, ring + (more ? nx.s : p.s) * SPLIT_STAGE);
    hop::mbar_wait_cluster(&sfull[x * 2 + wg], (it >> 1) & 1);
    if (lead) hop::mbar_expect_tx(&sfull[x * 2 + wg], s_bytes);  // tile it + 2's
    reduce_quads<DW, CM>(myrecv + x * rslot, mypk + x * pslot, &pfull[x * 2 + wg], C, rank, wg,
                     st0 + p.s * VT, st1 + p.s * VT, tb0, tb1, sa, sb);
    if (it > 0) {
      hop::mbar_wait_cluster(&pfull[(x ^ 1) * 2 + wg], ((it - 1) >> 1) & 1);
      if (lead) hop::mbar_expect_tx(&pfull[(x ^ 1) * 2 + wg], p_bytes);  // tile it + 1's
      load_pa(pa, mypk + (x ^ 1) * pslot, tw);
    }
    __syncwarp();
    hop::wgmma_fence();
    split_pv<DW>(acc, pa, ring + pp.s * SPLIT_STAGE);
    hop::wgmma_wait_n<1>();
    hop::fence_regs(sc);
    if (more) send_part(myrecv + (x ^ 1) * rslot, &sfull[(x ^ 1) * 2 + wg], sc, C, rank, tw);
    hop::wgmma_wait();
    hop::fence_regs(acc);
    hop::fence_regs(pa);
    __syncwarp();
    if (it > 0 && lane == 0) hop::mbar_arrive(&empty[pp.s]);
    pp = p;
    p = nx;
  }
  {
    const int x = (nt - 1) & 1;
    hop::mbar_wait_cluster(&pfull[x * 2 + wg], ((nt - 1) >> 1) & 1);
    load_pa(pa, mypk + x * pslot, tw);
    __syncwarp();
    hop::wgmma_fence();
    split_pv<DW>(acc, pa, ring + pp.s * SPLIT_STAGE);  // the last tile's product
    hop::wgmma_wait();
    hop::fence_regs(acc);
    hop::fence_regs(pa);
  }

  if constexpr (DW) {
    // db: each rank's quads' columns, their sums added over the warp
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int quad = q0 + (warp & 3) + 4 * m;
      if (quad >= q0 + nq) break;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        sa[m] += __shfl_xor_sync(0xffffffffu, sa[m], o);
        sb[m] += __shfl_xor_sync(0xffffffffu, sb[m], o);
      }
      const int a = b0 + 64 * wg + 16 * (quad >> 3) + (quad & 7);
      if (lane == 0) db[a] = sa[m], db[a + 8] = sb[m];
    }
    // dW[k0 + k, v] = dW^T[v, k]: for each register, a warp fills 4 rows x 32 bytes
    float* dw = static_cast<float*>(out);
#pragma unroll
    for (int j = 0; j < KS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dw[(size_t)(k0 + 8 * j + 2 * t + (e & 1)) * Vp + b0 + ra + 8 * (e >> 1)] = acc[4 * j + e];
  } else {  // dx[row, k0 + k] as bf16 pairs
    bf16* dx = static_cast<bf16*>(out);
#pragma unroll
    for (int j = 0; j < KS / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = b0 + ra + 8 * h;
        if (row < N)
          *reinterpret_cast<uint32_t*>(dx + (size_t)row * K + k0 + 8 * j + 2 * t) =
              hop::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }
  cluster.sync();  // no block exits while another still stores into its shared memory
}

template <typename... KArgs, typename... Args>
int launch_hk(void (*kern)(KArgs...), dim3 grid, int cluster_x, int threads, size_t smem,
              cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  // above the portable 8: the split kernels past K 1024
  if (e == cudaSuccess && cluster_x > MAX_C)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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

// The clusters of C blocks of `kern` (`smem` bytes of shared memory each)
// that the card holds at once (cudaOccupancyMaxActiveClusters), or a
// negative error.
int held_clusters(const void* kern, int C, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess && C > MAX_C)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1024);
  cfg.blockDim = dim3(HTHREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// The split kernel `kern` above K 1024 on clusters of C (9 or 10, beyond
// the portable size): launched only where the card holds such a cluster,
// else cudaErrorInvalidConfiguration (or the query's error).
template <typename... KArgs, typename... Args>
int launch_wide(void (*kern)(KArgs...), dim3 grid, int C, cudaStream_t stream, Args... args) {
  const int held = held_clusters((const void*)kern, C, split_smem_wide());
  if (held <= 0) return held < 0 ? -held : (int)cudaErrorInvalidConfiguration;
  return launch_hk(kern, grid, C, HTHREADS, split_smem_wide(), stream, args...);
}

}  // namespace

// The row lse of x W + b: x (N, K) bf16, K a multiple of 128 up to K_MAX 1280,
// rows 16-byte aligned; W (K, V) bf16 in rows of stride ldw (a multiple of
// 8, >= V; 16-byte aligned); b (V,) f32; lse (N,) f32 out. One launch:
// blocks of BM rows (`vocab_lse.fwd_tiling`: fwd_bm(K)), each row tile's
// V sweep split over a cluster of C blocks (1, 2, 4 or 8, no more than V's
// 64-column tiles). Returns cudaErrorInvalidValue for a shape, BM or C the
// kernel does not take, else the first launch error or cudaSuccess.
extern "C" int vocab_lse_fwd(const void* x, const void* W, int ldw, const void* b, void* lse,
                             int N, int K, int V, int BM, int C, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0 || V <= 0 || K <= 0 || K % 128 || K > K_MAX || ldw < V || ldw % 8 ||
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
// 4 or 8, no more than V's 64-column tiles), a wider K the split kernel on
// clusters of C = K / 128 (`vocab_lse.dx_tiling`; 9 and 10 non-portable).
// x, W, b, lse and g as for vocab_lse_fwd (lse and g (N,) f32). Returns
// cudaErrorInvalidValue for a shape or cluster the kernels do not take,
// cudaErrorInvalidConfiguration where the card holds no cluster of C.
extern "C" int vocab_lse_dx(const void* x, const void* W, int ldw, const void* b,
                            const void* lse, const void* g, void* dx, int N, int K, int V,
                            int C, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0 || V <= 0 || K <= 0 || K % 128 || K > K_MAX || ldw < V || ldw % 8)
    return (int)cudaErrorInvalidValue;
  if (K > HK_MAX ? C != K / KS
                 : C < 1 || C > MAX_C || (C & (C - 1)) || C > (V + VT - 1) / VT)
    return (int)cudaErrorInvalidValue;
  Maps mp = {};
  int rc;
  if ((rc = hop_host::encode_bf16(&mp.x, x, N, K, K, DX_BM)) ||
      (rc = hop_host::encode_bf16(&mp.w, W, K, V, ldw, 64)))
    return rc;
  const dim3 grid(C, (N + DX_BM - 1) / DX_BM);
  const float *bf = (const float*)b, *lf = (const float*)lse, *gf = (const float*)g;
  if (C > MAX_C)
    return launch_wide(vocab_lse_split_kernel<false, WIDE_C>, grid, C, st, mp, bf, lf, gf, dx,
                       (float*)nullptr, N, K, V, 0);
  if (K > HK_MAX)
    return launch_hk(vocab_lse_split_kernel<false>, grid, C, HTHREADS, split_smem(), st, mp,
                     bf, lf, gf, dx, (float*)nullptr, N, K, V, 0);
  const size_t smem = dx_smem(K);
  if (K == 128)
    return launch_hk(vocab_lse_dx_kernel<128>, grid, C, HTHREADS, smem, st, mp, bf, lf, gf,
                     (bf16*)dx, N, V);
  return launch_hk(vocab_lse_dx_kernel<256>, grid, C, HTHREADS, smem, st, mp, bf, lf, gf,
                   (bf16*)dx, N, V);
}

// dW (K, Vp) f32 and db (Vp,) f32 out, Vp = V rounded up to the 128
// vocabulary columns of a block (`vocab_lse.dw_tiling`). K <= 256 runs the
// wgmma kernel, a wider K the split kernel on clusters of K / 128 (9 and 10
// non-portable, as for vocab_lse_dx). The columns from V on are written as
// zeros; the caller slices them off.
extern "C" int vocab_lse_dw(const void* x, const void* W, int ldw, const void* b,
                            const void* lse, const void* g, void* dw, void* db, int N, int K,
                            int V, int Vp, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0 || V <= 0 || K <= 0 || K % 128 || K > K_MAX || ldw < V || ldw % 8 || Vp < V ||
      Vp % DW_BV)
    return (int)cudaErrorInvalidValue;
  Maps mp = {};
  int rc;
  if ((rc = hop_host::encode_bf16(&mp.x, x, N, K, K, DW_BN)) ||
      (rc = hop_host::encode_bf16(&mp.w, W, K, V, ldw, 64)))
    return rc;
  const float *bf = (const float*)b, *lf = (const float*)lse, *gf = (const float*)g;
  if (K / KS > MAX_C)
    return launch_wide(vocab_lse_split_kernel<true, WIDE_C>, dim3(K / KS, Vp / DW_BV), K / KS, st,
                       mp, bf, lf, gf, dw, (float*)db, N, K, V, Vp);
  if (K > HK_MAX)
    return launch_hk(vocab_lse_split_kernel<true>, dim3(K / KS, Vp / DW_BV), K / KS,
                     HTHREADS, split_smem(), st, mp, bf, lf, gf, dw, (float*)db, N, K, V,
                     Vp);
  const dim3 grid(Vp / DW_BV);
  const size_t smem = dw_smem(K);
  if (K == 128)
    return launch_hk(vocab_lse_dw_kernel<128>, grid, 1, HTHREADS, smem, st, mp, bf, lf, gf,
                     (float*)dw, (float*)db, N, V, Vp);
  return launch_hk(vocab_lse_dw_kernel<256>, grid, 1, HTHREADS, smem, st, mp, bf, lf, gf,
                   (float*)dw, (float*)db, N, V, Vp);
}

// The clusters of the split kernel at K (dx, or dw when `dw`) that the card
// holds at once (cudaOccupancyMaxActiveClusters), or a negative error.
extern "C" int vocab_lse_split_clusters(int K, int dw) {
  if (K <= HK_MAX || K % KS || K > K_MAX) return -(int)cudaErrorInvalidValue;
  const int C = K / KS;
  if (C > MAX_C)
    return held_clusters(dw ? (const void*)vocab_lse_split_kernel<true, WIDE_C>
                            : (const void*)vocab_lse_split_kernel<false, WIDE_C>,
                         C, split_smem_wide());
  return held_clusters(dw ? (const void*)vocab_lse_split_kernel<true>
                          : (const void*)vocab_lse_split_kernel<false>,
                       C, split_smem());
}
