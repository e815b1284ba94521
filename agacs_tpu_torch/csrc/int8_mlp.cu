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
// What bounds it: at the encoder's (12000, 768, 3072) K2f does 4 n d h =
// 113 G int8 operations (57 us at the H100's 1979 TOP/s) against ~42 MB of
// x, y and weights (13 us at 3.35 TB/s), K2b 6 n d h (86 us) against ~60 MB:
// the tensor cores bound both. What holds this kernel back is per-tile
// work around the products: the weights are re-read from L2 once per
// 64-row tile (188 times at 12,000 rows), the products run at N = 64 a
// warpgroup with a wait every k-block, and the float32 epilogues (GELU or
// its derivative, the quantisations) run between them.
//
// The obstacle: the second product's A operand is the hidden row-quantised,
// which needs the whole h-wide row of gelu(h) (K2b: dg) first, and 64 rows
// of f32 hidden are 768 KB at h 3072, more than three SMs' shared memory.
//
// Design. One 64-row tile (one m64 wgmma tile) is shared by a cluster of C
// blocks (cudaLaunchKernelEx, cluster (C, 1, 1), C in {1, 2, 4, 8}); rank r
// owns the hidden columns [r HC, (r + 1) HC), HC = h / C = 128 U, U <= 3
// units of 128 columns (64 per consumer warpgroup). A block of two consumer
// warpgroups and a producer warp:
//   1. the ranks row-quantise the tile's x (K2b: and dy s2) between them,
//      64 / C rows each, into K-major, 128-byte-swizzled int8 tiles that
//      each rank writes into every rank's shared memory (distributed shared
//      memory, then a proxy fence and a cluster barrier: wgmma reads them);
//   2. the consumers run the first product(s) unit by unit with s8 wgmma
//      (m64n64k32, int32 accumulators in registers) and keep the epilogue's
//      f32 values (gelu(h); K2b: dg, with h's and dy.w2q^T's accumulators of
//      one unit live together) in registers, U x 32 a thread;
//   3. each rank takes each row's absolute max over its slice and writes it
//      into every rank's table; after a cluster barrier each rank takes the
//      max of the C entries, so every rank holds the row's whole-h scale;
//   4. each rank quantises its slice in registers straight into a swizzled
//      int8 tile, the second product's A over K = its own HC columns;
//   5. the second product runs in 128-column output chunks. Each rank's
//      int32 partial of a chunk goes to its own shared memory; after a
//      cluster barrier the C ranks each take 64 / C of the chunk's rows,
//      read the C partials, add them in rank order, apply the epilogue and
//      store. int32 sums are exact, so the result equals the plain
//      version's bit for bit and does not depend on timing. Two partial
//      buffers alternate (over x's dead tiles): one barrier a chunk.
// Every quantisation divides by one scale a row: y = 1/s correctly rounded
// once, then RN(v y) with two FMA corrections is the IEEE quotient, without
// the division's slow-path branch in the inner loop (`i8::quant_by`).
// The B operands must be K-major: K2f reads w1q^T (h, d) and w2q^T (d, h),
// K2b w1q^T, w2q (h, d) and w1q (d, h); the wrapper keeps the transposed
// copies (ops/int8_mlp.py `transposed`). Every B tile is one TMA box of 128
// rows x 128 bytes through a ring of S 16 KB slots with full (TMA bytes)
// and empty (one arrival a consumer warp) mbarriers, fed by the producer
// warp from a table of the block's loads. The producer takes part in the
// cluster barriers too: before each it issues the loads the consumers use
// up to that barrier and a ring's worth beyond, which need no slot freed
// later, so neither side waits for the other there. The tiling (C, S)
// comes from the wrapper (`int8_mlp.mlp_tiling`), which mirrors
// `smem_bytes` below.
#include <cooperative_groups.h>

#include "hopper.cuh"
#include "int8_mma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int BM = 64;            // rows of a tile: one m64 wgmma tile
constexpr int UNIT = 128;         // hidden columns of a unit, 64 a warpgroup
constexpr int MAX_UNITS = 3;      // units a rank keeps in registers
constexpr int MAX_C = 8;          // blocks of a cluster: the portable size
constexpr int MAX_STAGES = 8;     // ring slots
constexpr int MAX_KB = 8;         // 128-byte k-blocks of x a row: d <= 1024
constexpr int CONSUMERS = 256;    // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and a producer warp
constexpr int TILE = BM * 128;    // bytes of a 64 x 128 int8 operand tile
constexpr int SLOT = 2 * TILE;    // bytes of a ring slot: one 128 x 128 TMA box
constexpr int PLD = 136;          // int32 row stride of a partial chunk
constexpr int PBUF = BM * PLD;    // int32 values of one partial chunk
constexpr int MAX_LOADS = (2 * MAX_KB + MAX_KB) * MAX_UNITS;  // ring loads a block
constexpr int SMALL = 3 * BM * 4 + MAX_C * 2 * BM * 4 + 2 * MAX_STAGES * 8 + MAX_LOADS * 4;

// Bytes of the region that holds x's (and dy's) tiles, then the two partial
// chunks.
__host__ __device__ constexpr int areg_bytes(int d, bool bwd) {
  return (bwd ? 2 : 1) * BM * d > 2 * PBUF * 4 ? (bwd ? 2 : 1) * BM * d : 2 * PBUF * 4;
}

// Dynamic shared memory of a block: the 1024-byte alignment, the ring, x's
// region, the quantised hidden and the scales, row-max table and barriers.
__host__ __device__ constexpr size_t smem_bytes(int d, int units, int stages, bool bwd) {
  return 1024 + (size_t)stages * SLOT + areg_bytes(d, bwd) + (size_t)units * TILE + SMALL;
}

struct Maps {
  CUtensorMap b[3];  // K2f: w1q^T, w2q^T; K2b: w1q^T, w2q, w1q
};

// Byte offset of (row r, byte k < 128) in a K-major 64 x 128 tile with the
// 128-byte swizzle (the 16-byte chunk c of row r stored at c ^ (r % 8)).
__device__ __forceinline__ int swz(int r, int k) {
  return r * 128 + (((k >> 4) ^ (r & 7)) << 4) + (k & 15);
}

template <bool BF16>
__device__ __forceinline__ void load4(const void* p, size_t i, float (&v)[4]) {
  if constexpr (BF16) {
    const uint2 w = *reinterpret_cast<const uint2*>(reinterpret_cast<const __nv_bfloat16*>(p) + i);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
    v[0] = __low2float(a), v[1] = __high2float(a), v[2] = __low2float(b), v[3] = __high2float(b);
  } else {
    const float4 f = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  }
}

template <bool BF16>
__device__ __forceinline__ void store4(void* p, size_t i, const float (&v)[4]) {
  if constexpr (BF16) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&a);
    w.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(p) + i) = w;
  } else {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(p) + i) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Row-quantise this rank's share of the tile's rows, [r0, r0 + nr) of the
// 64 from m0, of x (n, d) (times cs per column when given), and write each
// row into every rank's K-major swizzled tiles at q (k-block i at
// q + i TILE) and its scale into every rank's s: the cluster's blocks
// quantise the tile once between them. Rows past n quantise zeros. A warp
// per row, a lane per 4 consecutive values of each k-block.
template <bool BF16>
__device__ __forceinline__ void quant_share(cg::cluster_group& cluster, int C, const void* x,
                                            const float* cs, unsigned char* q, float* s,
                                            int m0, int r0, int nr, int n, int d, int warp,
                                            int lane) {
  const int nkb = d / 128;
  for (int r = r0 + warp; r < r0 + nr; r += CONSUMERS / 32) {
    const bool valid = m0 + r < n;
    const size_t base = (size_t)(m0 + r) * d + 4 * lane;
    float v[MAX_KB][4];
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_KB; ++i) {
      if (i >= nkb) break;
      if (valid) {
        load4<BF16>(x, base + 128 * i, v[i]);
      } else {
        v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (cs) v[i][e] = __fmul_rn(v[i][e], cs[128 * i + 4 * lane + e]);
        m = fmaxf(m, fabsf(v[i][e]));
      }
    }
    const float sc = i8::quant_scale(i8::warp_max(m)), y = __frcp_rn(sc);
    uint32_t word[MAX_KB];
#pragma unroll
    for (int i = 0; i < MAX_KB; ++i) {
      if (i >= nkb) break;
      word[i] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) word[i] |= i8::quant_by(v[i][e], sc, y) << (8 * e);
    }
    for (int dst = 0; dst < C; ++dst) {
      unsigned char* qd = cluster.map_shared_rank(q, dst);
#pragma unroll
      for (int i = 0; i < MAX_KB; ++i) {
        if (i >= nkb) break;
        *reinterpret_cast<uint32_t*>(qd + i * TILE + swz(r, 4 * lane)) = word[i];
      }
      if (lane == 0) cluster.map_shared_rank(s, dst)[r] = sc;
    }
  }
}

// The order of the ring's loads, one 128 x 128 box each. K2f: for each unit
// the d / 128 k-blocks of w1q^T's rows [col0 + 128 u, +128); then for each
// 128-column output chunk the U k-blocks of w2q^T at columns [col0, +HC).
// K2b: for each unit the k-blocks of w1q^T, then those of w2q, same rows;
// then for each output chunk the U k-blocks of w1q. Load L packed as its
// map (an index into Maps::b) and its column and row in units of 128.
__device__ __forceinline__ int load_entry(int L, int col0, int units, int kb1, bool bwd) {
  const int per = kb1 * (bwd ? 2 : 1), first = units * per;
  int map, col, row;
  if (L < first) {
    const int u = L / per, i = L % per;
    map = bwd && i >= kb1 ? 1 : 0;
    col = i % kb1;
    row = col0 / 128 + u;
  } else {
    const int j = L - first;
    map = bwd ? 2 : 1;
    col = col0 / 128 + j % units;
    row = j / units;
  }
  return map | col << 2 | row << 10;
}

struct Ring {
  unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;
  const int* sched;  // load_entry of every load
  int stages, total;
};

// A ring load's index, its slot and that slot's phase.
struct Pos {
  int L, s, ph;
  __device__ __forceinline__ void next(int stages) {
    ++L;
    if (++s == stages) s = 0, ph ^= 1;
  }
};

// The producer warp: lane 0 issues the loads below min(X + stages, total),
// each into its slot once every consumer warp is done with the slot's last
// load (the first round's waits, on the phase before a fresh barrier's
// first, return at once). Called with X, the loads the consumers use
// before the producer's next cluster barrier: those loads and the ring's
// worth after them need no slot that is freed later, so the producer can
// join that barrier without stalling the consumers.
__device__ __forceinline__ void produce(const Ring& R, const Maps& mp, Pos& p, int X) {
  if ((threadIdx.x & 31) == 0)
    for (const int end = min(X + R.stages, R.total); p.L < end; p.next(R.stages)) {
      hop::mbar_wait(&R.empty[p.s], p.ph ^ 1);
      const int e = R.sched[p.L];
      hop::mbar_expect_tx(&R.full[p.s], SLOT);
      hop::tma_load_2d(R.slots + p.s * SLOT, &mp.b[e & 3], &R.full[p.s],
                       128 * ((e >> 2) & 255), 128 * (e >> 10));
    }
  __syncwarp();
}

// acc = A . B over the ring's next nkb loads (from cur, which advances): A
// is nkb K-major 64 x 128 tiles at a, B each load's 128 rows, of which
// warpgroup wg reads rows [64 wg, +64): the accumulator's columns.
__device__ __forceinline__ void gemm(int (&acc)[32], const unsigned char* a, int nkb, Pos& cur,
                                     const Ring& R) {
  const int wg = threadIdx.x >> 7;
  for (int kb = 0; kb < nkb; ++kb) {
    hop::mbar_wait(&R.full[cur.s], cur.ph);
    __syncwarp();  // the wgmma below is .aligned: the warp converged
    const unsigned char* b = R.slots + cur.s * SLOT + wg * TILE;
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hop::wgmma_s8_n64(acc, hop::desc(a + kb * TILE, 32 * k), hop::desc(b, 32 * k), kb | k);
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(acc);
    if ((threadIdx.x & 31) == 0) hop::mbar_arrive(&R.empty[cur.s]);
    cur.next(R.stages);
  }
}

template <bool BF16, bool BWD>
__device__ __forceinline__ void mlp_body(const Maps& mp, const void* __restrict__ x,
                                         const void* __restrict__ dy,
                                         const float* __restrict__ s1,
                                         const float* __restrict__ b1,
                                         const float* __restrict__ s2,
                                         const float* __restrict__ b2, void* __restrict__ out,
                                         int n, int d, int h, int stages) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  hop::cluster_arrive_relaxed();
  extern __shared__ unsigned char raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = tid >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * (warp & 3) + g;  // this thread's accumulator rows: row0, row0 + 8
  const int HC = h / C, U = HC / UNIT, KB1 = d / 128, NCH = d / 128;
  const int m0 = blockIdx.y * BM;
  if (tid == CONSUMERS)
    for (int i = 0; i < (BWD ? 3 : 2); ++i) hop::prefetch_map(&mp.b[i]);
  unsigned char* areg = base + stages * SLOT;
  unsigned char* gq = areg + areg_bytes(d, BWD);
  float* sx = reinterpret_cast<float*>(gq + U * TILE);
  float* sd = sx + BM;
  float* sg = sd + BM;
  float* xmax = sg + BM;  // [rank][warpgroup][row]: each rank's row maxima
  uint64_t* bars = reinterpret_cast<uint64_t*>(xmax + MAX_C * 2 * BM);
  int* sched = reinterpret_cast<int*>(bars + 2 * MAX_STAGES);
  const Ring R{base, bars, bars + MAX_STAGES, sched, stages, ((BWD ? 2 : 1) * KB1 + NCH) * U};
  for (int L = tid; L < R.total; L += THREADS) sched[L] = load_entry(L, rank * HC, U, KB1, BWD);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hop::mbar_init(&R.full[s], 1);
      hop::mbar_init(&R.empty[s], CONSUMERS / 32);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  const int first = (BWD ? 2 : 1) * KB1 * U;  // the first products' loads
  if (warp == CONSUMERS / 32) {  // the producer: loads, and the cluster's barriers
    Pos p{0, 0, 0};
    produce(R, mp, p, 0);
    hop::cluster_wait();
    cluster.sync();  // the activations shared
    produce(R, mp, p, first);
    cluster.sync();  // the row maxima exchanged
    for (int c = 0; c < NCH; ++c) {
      produce(R, mp, p, first + (c + 1) * U);
      cluster.sync();  // chunk c's partials written
    }
    cluster.sync();
    return;
  }
  Pos cur{0, 0, 0};

  // 1. the activations, quantised into swizzled tiles: each rank 64 / C rows,
  // written into every rank's tiles
  hop::cluster_wait();  // every block of the cluster has started
  const int nr = BM / C;
  quant_share<BF16>(cluster, C, x, nullptr, areg, sx, m0, rank * nr, nr, n, d, warp, lane);
  if constexpr (BWD)
    quant_share<BF16>(cluster, C, dy, s2, areg + BM * d, sd, m0, rank * nr, nr, n, d, warp, lane);
  hop::fence_proxy_async_cluster();  // the remote stores, before the wgmma that read them
  cluster.sync();
  hop::fence_proxy_async();

  // 2. the first product(s), unit by unit; the f32 hidden stays in registers
  float hid[MAX_UNITS][32];
  float pm0 = 0.f, pm1 = 0.f;
#pragma unroll
  for (int u = 0; u < MAX_UNITS; ++u) {
    if (u < U) {
      int acc[32], accd[32];
      gemm(acc, areg, KB1, cur, R);
      if constexpr (BWD) gemm(accd, areg + BM * d, KB1, cur, R);
#pragma unroll
      for (int i = 0; i < 32; ++i) {  // d[4j + e]: row row0 + 8 (e / 2), column 8j + 2t + e % 2
        const int row = row0 + 8 * ((i >> 1) & 1);
        const int col = rank * HC + UNIT * u + 64 * wg + 8 * (i >> 2) + 2 * t + (i & 1);
        const float hv = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[i], sx[row]), s1[col]),
                                   b1[col]);
        float v;
        if constexpr (BWD) {
          v = __fmul_rn(__fmul_rn((float)accd[i], sd[row]), i8::dgelu(hv));
          v = __fmul_rn(v, s1[col]);
        } else {
          v = i8::gelu(hv);
        }
        hid[u][i] = v;
        if ((i >> 1) & 1)
          pm1 = fmaxf(pm1, fabsf(v));
        else
          pm0 = fmaxf(pm0, fabsf(v));
      }
    }
  }

  // 3. each row's absolute max over the cluster's h columns
  pm0 = fmaxf(pm0, __shfl_xor_sync(0xffffffffu, pm0, 1));
  pm0 = fmaxf(pm0, __shfl_xor_sync(0xffffffffu, pm0, 2));
  pm1 = fmaxf(pm1, __shfl_xor_sync(0xffffffffu, pm1, 1));
  pm1 = fmaxf(pm1, __shfl_xor_sync(0xffffffffu, pm1, 2));
  if (t == 0)
    for (int dst = 0; dst < C; ++dst) {
      float* tab = cluster.map_shared_rank(xmax, dst) + (rank * 2 + wg) * BM;
      tab[row0] = pm0;
      tab[row0 + 8] = pm1;
    }
  cluster.sync();
  float mx0 = 0.f, mx1 = 0.f;
  for (int from = 0; from < C; ++from)
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      mx0 = fmaxf(mx0, xmax[(from * 2 + w) * BM + row0]);
      mx1 = fmaxf(mx1, xmax[(from * 2 + w) * BM + row0 + 8]);
    }
  const float sc0 = i8::quant_scale(mx0), sc1 = i8::quant_scale(mx1);
  const float y0 = __frcp_rn(sc0), y1 = __frcp_rn(sc1);
  if (wg == 0 && t == 0) sg[row0] = sc0, sg[row0 + 8] = sc1;

  // 4. the slice quantised into the second product's A
#pragma unroll
  for (int u = 0; u < MAX_UNITS; ++u) {
    if (u < U) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float s = half ? sc1 : sc0, y = half ? y1 : y0;
          const uint32_t lo = i8::quant_by(hid[u][4 * j + 2 * half], s, y);
          const uint32_t hi = i8::quant_by(hid[u][4 * j + 2 * half + 1], s, y);
          *reinterpret_cast<uint16_t*>(gq + u * TILE +
                                       swz(row0 + 8 * half, 64 * wg + 8 * j + 2 * t)) =
              (uint16_t)(lo | (hi << 8));
        }
    }
  }
  hop::fence_proxy_async();
  hop::bar_sync(1, CONSUMERS);

  // 5. the second product over the rank's slice, chunk by chunk, summed
  // across the cluster
  int* pbuf = reinterpret_cast<int*>(areg);  // x's tiles are dead
  constexpr int E4 = BM * 128 / 4;           // int4 groups of a chunk
  const int q0 = rank * (E4 / C) + tid;  // this thread's first int4 group of a chunk
  for (int c = 0; c < NCH; ++c) {
    int acc[32];
    gemm(acc, gq, U, cur, R);
    int* pb = pbuf + (c & 1) * PBUF;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<int2*>(pb + (row0 + 8 * half) * PLD + 64 * wg + 8 * j + 2 * t) =
            make_int2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    float4 s2v, b2v;  // K2f's column factors of the first group, read before the barrier
    if constexpr (!BWD) {
      s2v = *reinterpret_cast<const float4*>(s2 + 128 * c + (q0 & 31) * 4);
      b2v = *reinterpret_cast<const float4*>(b2 + 128 * c + (q0 & 31) * 4);
    }
    cluster.sync();
    for (int q = q0; q < (rank + 1) * (E4 / C); q += CONSUMERS) {
      const int row = q >> 5, c4 = (q & 31) * 4, off = row * PLD + c4;
      int4 part[MAX_C];  // every rank's partial read at once, then added in rank order
#pragma unroll
      for (int src = 0; src < MAX_C; ++src)
        if (src < C) part[src] = *reinterpret_cast<const int4*>(cluster.map_shared_rank(pb, src) + off);
      int4 v = part[0];
#pragma unroll
      for (int src = 1; src < MAX_C; ++src)
        if (src < C) v.x += part[src].x, v.y += part[src].y, v.z += part[src].z, v.w += part[src].w;
      if (m0 + row >= n) continue;
      const float s = sg[row];
      const int a[4] = {v.x, v.y, v.z, v.w};
      float o[4];
      if constexpr (BWD) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = __fmul_rn((float)a[e], s);
      } else {
        if (q != q0) {
          s2v = *reinterpret_cast<const float4*>(s2 + 128 * c + c4);
          b2v = *reinterpret_cast<const float4*>(b2 + 128 * c + c4);
        }
        const float sc2[4] = {s2v.x, s2v.y, s2v.z, s2v.w}, bc2[4] = {b2v.x, b2v.y, b2v.z, b2v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = __fadd_rn(__fmul_rn(__fmul_rn((float)a[e], s), sc2[e]), bc2[e]);
      }
      store4<BF16>(out, (size_t)(m0 + row) * d + 128 * c + c4, o);
    }
  }
  cluster.sync();  // no block exits while another still reads its partials
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1) mlp_fwd_kernel(
    const __grid_constant__ Maps mp, const void* __restrict__ x, const float* __restrict__ s1,
    const float* __restrict__ b1, const float* __restrict__ s2, const float* __restrict__ b2,
    void* __restrict__ y, int n, int d, int h, int stages) {
  mlp_body<BF16, false>(mp, x, nullptr, s1, b1, s2, b2, y, n, d, h, stages);
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1) mlp_bwd_kernel(
    const __grid_constant__ Maps mp, const void* __restrict__ x, const void* __restrict__ dy,
    const float* __restrict__ s1, const float* __restrict__ b1, const float* __restrict__ s2,
    void* __restrict__ dx, int n, int d, int h, int stages) {
  mlp_body<BF16, true>(mp, x, dy, s1, b1, s2, nullptr, dx, n, d, h, stages);
}

// The shapes the kernels take: d a multiple of 128 up to 1024, h = 128 C U
// with C in {1, 2, 4, 8} and U <= 3, 2 <= stages <= MAX_STAGES, within the
// device's shared memory.
bool bad_shape(int n, int d, int h, int C, int stages, bool bwd) {
  if (n <= 0 || d <= 0 || d % 128 || d / 128 > MAX_KB || C < 1 || C > MAX_C || (C & (C - 1)) ||
      h <= 0 || h % (UNIT * C) || h / (UNIT * C) > MAX_UNITS || stages < 2 ||
      stages > MAX_STAGES)
    return true;
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return smem_bytes(d, h / (UNIT * C), stages, bwd) > (size_t)max_smem;
}

template <typename... KArgs, typename... Args>
int launch(void (*kern)(KArgs...), int n, int d, int h, int C, int stages, bool bwd,
           cudaStream_t stream, Args... args) {
  const size_t smem = smem_bytes(d, h / (UNIT * C), stages, bwd);
  // Set on every launch: the attribute is per device, and it is cheap.
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, tiles, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args..., n, d, h, stages);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, d) bf16 (x_bf16) or f32; w1t = w1q^T (h, d) and w2t = w2q^T (d, h)
// int8; s1, b1 (h,), s2, b2 (d,) f32; y (n, d) in x's dtype; all contiguous
// and 16-byte aligned. C ranks a cluster, `stages` ring slots (the tiling
// of `int8_mlp.mlp_tiling`). Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for a shape the kernel does not take, or a negative
// code if a tensor map could not be encoded.
extern "C" int int8_mlp_fwd(const void* x, int x_bf16, const int8_t* w1t, const float* s1,
                            const float* b1, const int8_t* w2t, const float* s2,
                            const float* b2, void* y, int n, int d, int h, int C, int stages,
                            cudaStream_t stream) {
  if (bad_shape(n, d, h, C, stages, false)) return (int)cudaErrorInvalidValue;
  Maps mp = {};
  int rc;
  if ((rc = hop_host::encode_i8(&mp.b[0], w1t, h, d)) ||
      (rc = hop_host::encode_i8(&mp.b[1], w2t, d, h)))
    return rc;
  if (x_bf16)
    return launch(mlp_fwd_kernel<true>, n, d, h, C, stages, false, stream, mp, x, s1, b1, s2,
                  b2, y);
  return launch(mlp_fwd_kernel<false>, n, d, h, C, stages, false, stream, mp, x, s1, b1, s2,
                b2, y);
}

// As int8_mlp_fwd, for dx (n, d) from dy (n, d) in x's dtype: w1q (d, h),
// w1t = w1q^T (h, d) and w2q (h, d) int8; s1, b1 (h,), s2 (d,) f32.
extern "C" int int8_mlp_bwd(const void* x, int x_bf16, const int8_t* w1q, const int8_t* w1t,
                            const float* s1, const float* b1, const int8_t* w2q,
                            const float* s2, const void* dy, void* dx, int n, int d, int h,
                            int C, int stages, cudaStream_t stream) {
  if (bad_shape(n, d, h, C, stages, true)) return (int)cudaErrorInvalidValue;
  Maps mp = {};
  int rc;
  if ((rc = hop_host::encode_i8(&mp.b[0], w1t, h, d)) ||
      (rc = hop_host::encode_i8(&mp.b[1], w2q, h, d)) ||
      (rc = hop_host::encode_i8(&mp.b[2], w1q, d, h)))
    return rc;
  if (x_bf16)
    return launch(mlp_bwd_kernel<true>, n, d, h, C, stages, true, stream, mp, x, dy, s1, b1,
                  s2, dx);
  return launch(mlp_bwd_kernel<false>, n, d, h, C, stages, true, stream, mp, x, dy, s1, b1, s2,
                dx);
}
