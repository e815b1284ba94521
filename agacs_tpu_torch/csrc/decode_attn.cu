// K3 and its variants: decode-step cache attention (sm_90a).
//
// Replaces the TPU kernels of agacs_tpu/ops/decode_attn.py:
//   K3   `_make_kernel` (`decode_cache_attention` -> `_call`) with an
//        identity ancestry map, and its time-chunked twin
//        `_make_kernel_chunked`: plain rows;
//   K3a  the same `_make_kernel` / `_make_kernel_chunked` with an ancestry
//        map over beam groups of j rows: query row n of group g = n / j reads
//        position t from the physical cache row g*j + anc_local[n, t];
//   K3-PE, K3a-PE  `_make_kernel(pe=True)` (and its chunked twin): the
//        gated dual-QK scores (1 - g_h)·(q.k) + g_h·(q_cs.k_cs) per head h
//        over a third cache k_cs, read through the same ancestry map;
//   K3-int8, K3a-int8  `_make_kernel(quant=True)`: int8 k/v with
//        per-channel float32 scales;
//   K3s  `_make_kernel_shared` (`decode_shared_cache_attention` ->
//        `_call_shared`): the j beam queries of group g over ONE shared
//        (Tp, d) cache, the utterance's cross-attention K/V; K3s-int8 its
//        `quant=True` form;
//   K3-f32  `_make_kernel` on float32 caches (`_dispatch` sizes its blocks
//        by `k.dtype.itemsize`, decode_attn.py:615): the transformer LM's
//        self-attention, which the decode CLI builds in float32
//        (agacs_tpu/bin/decode.py:131-133). Query, caches and output are
//        float32 and p is not rounded (the TPU kernel casts it to the
//        cache's dtype).
// Same math in all: one query token per row, q (pre-scaled by d_head^-0.5)
// . k over a head's channels with bf16 (or int8) inputs and float32
// accumulation, float32 softmax over keys 0..pos, normalised BEFORE the
// bf16 cast of p (the rounding point of `_make_kernel`, not of the chunked
// form's online softmax), then the value sum with float32 accumulation and
// a bf16 output. The int8 forms fold the scales as the TPU kernel does:
// q·s_k is formed in float32 and rounded to bf16 once per block (the TPU's
// bf16 query matrix), int8 -> float is exact, and s_v multiplies the
// float32 value sum before the bf16 cast. K3-f32 keeps everything in
// float32.
//
// What bounds them here: HBM bytes. A call reads 2*N*(pos+1)*d*2 bytes of
// cache (K3 / K3a; PE 1.5x; int8 half; K3-f32 twice) or 2*G*(pos+1)*d*2
// (K3s: 18.4 MB at G=8, pos 749, d=768; int8 half), at 4 FLOPs a
// byte-pair (K3s: 4*j), far below the card's ~295 FLOP/byte ridge. Keys
// past pos are skipped, not loaded (their TPU weight exp(-1e30 - m) is
// exactly 0). At the decode shapes those bytes are 18 MB or less, a few
// microseconds of HBM time, so what decides the time is how many bytes are
// in flight at once and how few serial steps a block takes.
//
// The design: a split over time, combined inside a thread-block cluster.
// The grid is (H, N, S) for the rows kernel and (H, G, S) for K3s; the S
// blocks of one (head, row) form one cluster (cudaLaunchKernelEx with a
// cluster dimension of (1, 1, S), S <= 8, the portable size). The Python
// wrapper picks S from (rows, heads, Tp) and never from pos
// (`decode_attn.time_splits`), so a captured decode step sees one grid.
// Block b (its rank in the cluster) takes the keys [b*C, (b+1)*C) with C
// = ceil(Tp / S), cut at pos; a block whose keys all lie past pos loads
// nothing and contributes m = -inf, l = 0 and a zero partial.
//
// In a block: every 16-byte piece of the chunk's key slices (and k_cs's,
// PE), then of its value slices, is copied to shared memory with cp.async,
// one commit group a tile: the whole chunk in one key and one value tile
// when the launch leaves an SM room for it (`whole_chunk_budget`), else
// 4 KB tiles through a ring of up to 8 slots, so the block scores a tile
// while the rest arrive. At the decode shapes the whole chunk, keys and
// values, is in flight from the first instruction. K3a resolves each
// key's physical row through the ancestry map first (a gather, which TMA
// cannot do on Hopper). A warp scores KPP keys at once, LPK lanes a key,
// each lane one 16-byte piece dotted with its channels of q (kept in
// registers), the LPK lanes reduced by shuffles in a fixed order. Then
// the cluster's softmax, at the TPU kernel's rounding point: each block
// pushes its chunk max into every block's table (distributed shared
// memory, `map_shared_rank`), and after a cluster barrier each takes the
// global m over the table in rank order; the same for its sum of exp(s -
// m), into the global l; p = bf16(exp(s - m) / l) for its own keys. The
// value tiles have meanwhile arrived: warp w takes keys w, w + 4, ... of
// a tile, lane l the channel pair (2l, 2l+1), the four warps' sums meet in
// shared memory in warp order, and each block pushes its partial output
// to rank 0, which after a last barrier sums the S partials in rank order,
// applies s_v (int8) and writes the output; no block's memory is read
// after that barrier but rank 0's own. One block (S = 1) skips the
// exchanges. Every sum has a fixed order, so a call is bit-identical from
// run to run, and differs from the unsplit kernel only in the order of
// its float32 sums.
//
// K3s is the same split with the group's j <= 16 queries in the block, on
// the tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulators; j
// rows of A padded to 16): each key and value row read once serves all j,
// and no lane reduces a dot product across lanes. Its tiles are swizzled
// for ldmatrix; int8 keys and values are widened to bf16 in registers
// (exact), with their channels paired to suit ldmatrix. It takes the whole
// chunk in one tile up to 64 KB, and fills the card with fewer, busier
// blocks.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

// Head width of every kernel but K3's plain bf16 rows, which also run at
// d_head 48 (the ladder side network's 192 / 4 heads): the rows kernel
// takes the width as a template parameter (`DW`).
constexpr int DH = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SLOTS = 8;   // ring slots, each one cp.async group
constexpr int MAX_SPLITS = 8;  // blocks of a cluster: the portable size
// Dynamic shared memory a block may take (227 KB less the static arrays).
constexpr int MAX_DYN_SMEM = 220 * 1024;
constexpr int MAX_DEVICES = 64;  // per-device records of the launchers

// One 16-byte copy from global to shared memory, L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (< MAX_SLOTS) of this thread's newest groups are
// still in flight.
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// A head slice of a cache row as the kernels read it: 16-byte pieces of
// CPL channels; LPK lanes score a key (PIECES rounded up to a power of 2,
// the lanes past PIECES idle: d_head 48), KPP keys a warp at once.
template <typename KT, int DW>
struct Slice {
  static constexpr int CPL = 16 / (int)sizeof(KT);
  static constexpr int PIECES = DW / CPL;
  static constexpr int LPK = PIECES <= 4 ? 4 : PIECES <= 8 ? 8 : 16;
  static constexpr int KPP = 32 / LPK;
  static constexpr int BYTES = DW * (int)sizeof(KT);
  static_assert(DW % CPL == 0 && PIECES <= 16, "a head slice is whole 16-byte pieces");
};

// Ring slots of a block whose chunk holds up to `cap` keys in tiles of
// `tk`: its K and V tiles, at most MAX_SLOTS.
__host__ __device__ __forceinline__ int ring_slots(int cap, int tk) {
  const int tiles = 2 * ((cap + tk - 1) / tk);
  return tiles < MAX_SLOTS ? tiles : MAX_SLOTS;
}

// Keys of a ring tile: the whole chunk when its keys and values take at
// most `whole` bytes (one K and one V tile: two waits), else 4 KB of key
// rows (3 KB at d_head 48) in up to 8 slots, a ring of at most RING_BYTES,
// so that an SM holds several blocks and scores while the rest arrives.
constexpr int RING_BYTES = 32 * 1024;
__host__ __device__ __forceinline__ int tile_keys(int cap, int row, int whole = RING_BYTES) {
  if (2 * cap * row <= whole) return (cap + 15) / 16 * 16;
  return row <= 64 ? 64 : row <= 128 ? 32 : 16;
}

// The rows kernel takes a whole chunk in one tile when the launch's blocks
// leave each SM that much shared memory: SM_SMEM over the blocks an SM
// runs, within [RING_BYTES, WHOLE_MAX].
constexpr int SM_SMEM = 200 * 1024;
constexpr int WHOLE_MAX = 96 * 1024;
inline int whole_chunk_budget(int blocks) {
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES) return RING_BYTES;
  if (!sms[dev] &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return RING_BYTES;
  const int per_sm = (blocks + sms[dev] - 1) / sms[dev];
  const int b = SM_SMEM / per_sm;
  return b < RING_BYTES ? RING_BYTES : b > WHOLE_MAX ? WHOLE_MAX : b;
}

// The cluster's barriers. A one-block split needs only the block's own.
// Every block arrives (relaxed) at the start and waits before its first
// store into another block's shared memory, so that store never finds a
// block that has not started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync(cg::cluster_group& cluster, bool multi) {
  if (multi)
    cluster.sync();
  else
    __syncthreads();
}

// Where rank `rank` puts its entry `i` of a table that rank `to` holds.
template <typename T>
__device__ __forceinline__ T* remote(cg::cluster_group& cluster, bool multi, T* p, int to) {
  return multi ? cluster.map_shared_rank(p, to) : p;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The block's max / sum (warps in order), for every thread; `red` (one
// float a warp) is not reused by the caller.
__device__ __forceinline__ float block_max(float x, float* red) {
  x = warp_max(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < WARPS; ++w) x = fmaxf(x, red[w]);
  return x;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < WARPS; ++w) x += red[w];
  return x;
}

// A 16-byte piece of a cache row as floats (exact conversions).
template <typename KT>
__device__ __forceinline__ void unpack(const unsigned char* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  if constexpr (std::is_same<KT, bf16>::value) {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 x = __bfloat1622float2(b[c]);
      f[2 * c] = x.x;
      f[2 * c + 1] = x.y;
    }
  } else if constexpr (std::is_same<KT, int8_t>::value) {
    const char4* b = reinterpret_cast<const char4*>(&u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      f[4 * c] = (float)b[c].x;
      f[4 * c + 1] = (float)b[c].y;
      f[4 * c + 2] = (float)b[c].z;
      f[4 * c + 3] = (float)b[c].w;
    }
  } else {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
}

// q . k over one piece's channels, in channel order.
template <typename KT>
__device__ __forceinline__ float dot_piece(const unsigned char* p, const float* q) {
  constexpr int CPL = 16 / (int)sizeof(KT);
  float kf[CPL];
  unpack<KT>(p, kf);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c) s = fmaf(q[c], kf[c], s);
  return s;
}

// The sum over a key's LPK lanes (every lane gets it).
template <int LPK>
__device__ __forceinline__ float lanes_sum(float s) {
#pragma unroll
  for (int off = LPK / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The channel pair (c, c+1) of a value row in shared memory.
__device__ __forceinline__ float2 load_pair(const bf16* vp) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vp));
}

__device__ __forceinline__ float2 load_pair(const int8_t* vp) {
  const char2 c = *reinterpret_cast<const char2*>(vp);
  return make_float2((float)c.x, (float)c.y);
}

__device__ __forceinline__ float2 load_pair(const float* vp) {
  return *reinterpret_cast<const float2*>(vp);
}

// The query / output type of a cache type: float32 caches (K3-f32) take
// float32 queries and give float32 outputs; bf16 and int8 caches bf16.
template <typename KT>
struct Query {
  typedef bf16 T;
};
template <>
struct Query<float> {
  typedef float T;
};

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void put(bf16* dst, float x) { *dst = __float2bfloat16(x); }
__device__ __forceinline__ void put(float* dst, float x) { *dst = x; }

// A query channel as the kernel dots it: as given; against int8 keys q·s_k
// in float32, rounded to bf16 (the TPU's bf16 query matrix).
template <typename KT, typename QT>
__device__ __forceinline__ float query_channel(QT q, const float* __restrict__ k_scale,
                                               int c) {
  const float x = to_float(q);
  if constexpr (std::is_same<KT, int8_t>::value)
    return __bfloat162float(__float2bfloat16(x * k_scale[c]));
  return x;
}

// K3 (ANC false), K3a (ANC true); PE: the gated dual-QK scores over k_cs
// with the head's gate[h] (post-sigmoid, float32); KT int8: the int8
// caches with k_scale / v_scale (d,) float32; KT float: K3-f32, float32
// query, caches and output, p not rounded. anc: (N, Tp) int32 local rows
// in [0, J) (clamped into it); row n of group n / J reads position t from
// row (n / J) * J + anc[n, t], for k, k_cs and v alike. DW: the head
// width, 64, or 48 for the plain bf16 rows. Grid (H, N, S) in clusters of
// (1, 1, S); chunk = ceil(Tp / S) keys a block, tiles of tk keys.
// Dynamic shared memory: the ring (slots x tk x ROW bytes), cap = min(chunk,
// pos + 1) float scores, then (K3a) cap int rows.
template <bool ANC, bool PE, typename KT, int DW = DH>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const typename Query<KT>::T* __restrict__ q, const KT* __restrict__ k,
                   const KT* __restrict__ v, const int* __restrict__ anc,
                   const bf16* __restrict__ q_cs, const bf16* __restrict__ k_cs,
                   const float* __restrict__ gate, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, typename Query<KT>::T* __restrict__ o,
                   int Tp, int H, int pos, int J, int chunk, int tk) {
  typedef Slice<KT, DW> SL;
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr bool F32 = std::is_same<KT, float>::value;
  constexpr int ROW = (PE ? 2 : 1) * SL::BYTES;  // a key in a K tile: k, then k_cs
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float qs[DW];
  __shared__ float qcs[PE ? DW : 1];
  __shared__ float redm[WARPS], redl[WARPS];
  __shared__ float wpart[WARPS][DW];
  // Every rank's chunk max and sum, each pushed here by its rank; rank 0
  // also receives every rank's partial output.
  __shared__ float xm[MAX_SPLITS], xl[MAX_SPLITS];
  __shared__ float parts[MAX_SPLITS][DW];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const bool multi = S > 1;
  const int h = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = H * DW;
  const int nk = pos + 1;
  const int cap = min(chunk, nk);
  const int c0 = rank * chunk;                  // this block's first key
  const int nkb = max(0, min(chunk, nk - c0));  // its keys, none past pos
  const int nt = (nkb + tk - 1) / tk;
  const int slots = ring_slots(cap, tk);
  unsigned char* ring = smem;
  float* sc = reinterpret_cast<float*>(smem + (size_t)slots * tk * ROW);
  int* rows = reinterpret_cast<int*>(sc + cap);
  const int* an = ANC ? anc + (size_t)n * Tp : nullptr;
  const int base = ANC ? (n / J) * J : n;
  if (multi) cluster_arrive_relaxed();

  // A tile's copies: PER 16-byte pieces a key, from k (then k_cs) or v.
  auto copy = [&](auto per_c, unsigned char* dst, int t0, int cnt, bool val) {
    constexpr int PER = decltype(per_c)::value;
    for (int i = tid; i < cnt * PER; i += THREADS) {
      const int kk = i / PER, pc = i - kk * PER;
      const int r = ANC ? rows[t0 + kk] : n;
      const size_t off = ((size_t)r * Tp + c0 + t0 + kk) * D + h * DW;
      const KT* src =
          val ? v : (PE && pc >= SL::PIECES ? reinterpret_cast<const KT*>(k_cs) : k);
      cp_async16(dst + kk * PER * 16 + pc * 16,
                 reinterpret_cast<const unsigned char*>(src + off) + (pc % SL::PIECES) * 16);
    }
  };
  // Load j of the sequence (K tiles 0..nt-1, then V tiles 0..nt-1) into
  // slot j % slots as one cp.async group; past the end an empty group, so
  // every step commits one and a wait for slots - 1 pending finds load j.
  auto fetch = [&](int j) {
    if (j < 2 * nt) {
      const bool val = j >= nt;
      const int t0 = (val ? j - nt : j) * tk, cnt = min(tk, nkb - t0);
      unsigned char* dst = ring + (size_t)(j % slots) * tk * ROW;
      if (val)
        copy(std::integral_constant<int, SL::PIECES>(), dst, t0, cnt, true);
      else
        copy(std::integral_constant<int, ROW / 16>(), dst, t0, cnt, false);
    }
    cp_commit();
  };
  // The copies go out first (K3a: once the map has given each key's row),
  // the query's channels after them.
  if constexpr (ANC) {
    for (int t = tid; t < nkb; t += THREADS)
      rows[t] = base + min(max(an[c0 + t], 0), J - 1);  // never outside the group
    __syncthreads();
  }
  for (int j = 0; j < slots; ++j) fetch(j);
  if (tid < DW) {
    const size_t qi = (size_t)n * D + h * DW + tid;
    qs[tid] = query_channel<KT>(q[qi], k_scale, h * DW + tid);
    if constexpr (PE) qcs[tid] = __bfloat162float(q_cs[qi]);
  }

  // Scores: lane `sub` of a key holds q's channels of piece `sub` (read
  // after the first tile's barrier, which also publishes qs).
  const int sub = lane % SL::LPK, kq = lane / SL::LPK;
  const bool act = sub < SL::PIECES;
  float qr[SL::CPL], qcr[PE ? SL::CPL : 1];
  const float g = PE ? gate[h] : 0.f;
  float mx = -INFINITY;
  for (int j = 0; j < nt; ++j) {
    cp_wait(slots - 1);
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int c = 0; c < SL::CPL; ++c) {
        qr[c] = act ? qs[sub * SL::CPL + c] : 0.f;
        if constexpr (PE) qcr[c] = act ? qcs[sub * SL::CPL + c] : 0.f;
      }
    }
    const unsigned char* kt = ring + (size_t)(j % slots) * tk * ROW;
    const int t0 = j * tk, cnt = min(tk, nkb - t0);
    for (int kk0 = warp * SL::KPP; kk0 < cnt; kk0 += WARPS * SL::KPP) {
      const int kk = kk0 + kq;
      const bool on = act && kk < cnt;
      float s = lanes_sum<SL::LPK>(on ? dot_piece<KT>(kt + kk * ROW + sub * 16, qr) : 0.f);
      if constexpr (PE) {
        const float s_cs = lanes_sum<SL::LPK>(
            on ? dot_piece<KT>(kt + kk * ROW + SL::BYTES + sub * 16, qcr) : 0.f);
        s = (1.f - g) * s + g * s_cs;
      }
      if (sub == 0 && kk < cnt) {
        sc[t0 + kk] = s;
        mx = fmaxf(mx, s);
      }
    }
    if (j + slots < 2 * nt) __syncthreads();  // the slot is refilled
    fetch(j + slots);
  }

  // The cluster's softmax: each rank pushes its chunk max to every rank,
  // which takes the global m over them in rank order; then the same with
  // its sum of exp(s - m) for the global l; then p, normalised before the
  // bf16 cast. One block (S = 1) has them already.
  mx = block_max(mx, redm);
  float m = mx;
  if (multi) {
    cluster_wait();
    if (tid < S) *cluster.map_shared_rank(&xm[rank], tid) = mx;
    cluster.sync();
    for (int r = 0; r < S; ++r) m = fmaxf(m, xm[r]);
  }
  float sum = 0.f;
  for (int t = tid; t < nkb; t += THREADS) {
    const float e = expf(sc[t] - m);
    sc[t] = e;
    sum += e;
  }
  sum = block_sum(sum, redl);
  float l = sum;
  if (multi) {
    if (tid < S) *cluster.map_shared_rank(&xl[rank], tid) = sum;
    cluster.sync();
    l = 0.f;
    for (int r = 0; r < S; ++r) l += xl[r];
  }
  for (int t = tid; t < nkb; t += THREADS) {
    const float w = sc[t] / l;
    sc[t] = F32 ? w : __bfloat162float(__float2bfloat16(w));  // normalise, then bf16
  }

  // Values: warp w takes keys w, w+4, ... of each tile, lane l the channel
  // pair (2l, 2l+1).
  float2 acc = make_float2(0.f, 0.f);
  const bool pair = 2 * lane < DW;
  for (int j = 0; j < nt; ++j) {
    cp_wait(slots - 1);
    __syncthreads();
    const unsigned char* vt = ring + (size_t)((nt + j) % slots) * tk * ROW;
    const int t0 = j * tk, cnt = min(tk, nkb - t0);
    if (pair) {
      for (int kk = warp; kk < cnt; kk += WARPS) {
        const float w = sc[t0 + kk];
        const float2 f = load_pair(reinterpret_cast<const KT*>(vt + kk * SL::BYTES) + 2 * lane);
        acc.x = fmaf(w, f.x, acc.x);
        acc.y = fmaf(w, f.y, acc.y);
      }
    }
    if (nt + j + slots < 2 * nt) __syncthreads();  // the slot is refilled
    fetch(nt + j + slots);
  }
  if (pair) {
    wpart[warp][2 * lane] = acc.x;
    wpart[warp][2 * lane + 1] = acc.y;
  }
  __syncthreads();
  // The warps' sums in warp order, pushed to rank 0, which adds the
  // ranks' partials in rank order; no block's memory is read after the
  // barrier but rank 0's own. One block writes its sum.
  float s = 0.f;
  if (tid < DW) {
    s = wpart[0][tid];
    for (int w = 1; w < WARPS; ++w) s += wpart[w][tid];
  }
  if (multi) {
    if (tid < DW) cluster.map_shared_rank(&parts[rank][0], 0)[tid] = s;
    cluster.sync();
    if (rank == 0 && tid < DW) {
      s = 0.f;
      for (int r = 0; r < S; ++r) s += parts[r][tid];
    }
  }
  if (rank == 0 && tid < DW) {
    if (QUANT) s *= v_scale[h * DW + tid];  // v's scale, after the sum
    put(o + (size_t)n * D + h * DW + tid, s);
  }
}

// cudaLaunchKernelEx with the S blocks along z as one cluster (S = 1: a
// cluster of one block, which skips the cluster's exchanges). The kernel
// is opted into
// MAX_DYN_SMEM of dynamic shared memory once per device (`opted`, the
// kernel's record): the default allows 48 KB less its static arrays, which
// a launch near 48 KB would exceed. The opt-in is a ceiling; a launch still
// takes only what it asks for.
template <typename... KArgs, typename... Args>
int launch_cluster(void (*kern)(KArgs...), bool* opted, dim3 grid, int S, size_t smem,
                   cudaStream_t stream, Args... args) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !opted[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYN_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) opted[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = S;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool ANC, bool PE, typename KT, int DW = DH>
int launch_rows(const void* q, const void* k, const void* v, const void* anc,
                const void* q_cs, const void* k_cs, const void* gate, const void* ks,
                const void* vs, void* o, int N, int Tp, int H, int pos, int J, int S,
                cudaStream_t stream) {
  if (S < 1 || S > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  constexpr int ROW = (PE ? 2 : 1) * Slice<KT, DW>::BYTES;
  const int chunk = (Tp + S - 1) / S, cap = chunk < pos + 1 ? chunk : pos + 1;
  const int tk = tile_keys(cap, ROW, whole_chunk_budget(H * N * S));
  const size_t smem = (size_t)ring_slots(cap, tk) * tk * ROW +
                      (size_t)cap * (sizeof(float) + (ANC ? sizeof(int) : 0));
  if (smem > (size_t)MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  typedef typename Query<KT>::T QT;
  static bool opted[MAX_DEVICES] = {};
  return launch_cluster(decode_attn_kernel<ANC, PE, KT, DW>, opted, dim3(H, N, S), S, smem,
                        stream, (const QT*)q, (const KT*)k, (const KT*)v, (const int*)anc,
                        (const bf16*)q_cs, (const bf16*)k_cs, (const float*)gate,
                        (const float*)ks, (const float*)vs, (QT*)o, Tp, H, pos, J, chunk, tk);
}

// K3s's products run on the tensor cores (mma.sync m16n8k16, bf16 in,
// float32 accumulators): the group's j <= 16 queries are the 16 rows of A
// (rows j.. zero), so a key or value row read once serves all of them and
// no lane reduces a dot product across lanes. Tiles hold 128-byte bf16 rows
// with 16-byte chunk c of row r at chunk c ^ (r % 8), so ldmatrix reads
// them without bank conflicts.
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p, bool trans) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a b for one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// K3s's pieces, common to its two kernels.

// Byte offset of 16-byte chunk c of row r in an int8 tile: 64-byte rows,
// chunk c at c ^ ((r / 2) % 4), so ldmatrix's 8 rows hit 8 banks.
__device__ __forceinline__ int swz_i8(int r, int c) { return r * 64 + ((c ^ ((r >> 1) & 3)) << 4); }

// A tile's copies, to the swizzled layout; a bf16 value tile's rows past
// its keys zeroed up to a multiple of 16 (the product reads them with
// p = 0; int8 rows there are finite whatever they hold).
template <typename KT>
__device__ __forceinline__ void shared_copy(unsigned char* dst, const KT* src, int cnt, int D,
                                            bool val) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int ROW = DH * (int)sizeof(KT), PIECES = ROW / 16;
  for (int i = threadIdx.x; i < cnt * PIECES; i += THREADS) {
    const int kk = i / PIECES, pc = i - kk * PIECES;
    cp_async16(dst + (QUANT ? swz_i8(kk, pc) : swz(kk, pc)),
               reinterpret_cast<const unsigned char*>(src + (size_t)kk * D) + pc * 16);
  }
  if (!QUANT && val)
    for (int i = threadIdx.x; i < ((cnt + 15) / 16 * 16 - cnt) * 8; i += THREADS)
      *reinterpret_cast<uint4*>(dst + (cnt + i / 8) * 128 + (i % 8) * 16) = make_uint4(0, 0, 0, 0);
}

// q as A fragments, one per 16 channels, straight from global memory:
// this lane's rows g and g + 8 (rows J.. zero), columns 2t, 2t + 1, and
// 8 further; int8: bf16(q·s_k), as `query_channel` forms it, with the
// channels paired as `score_tile_i8` pairs the keys' (4t, 4t + 1 for the
// k-slots 2t, 2t + 1; 4t + 2, 4t + 3 for 2t + 8, 2t + 9: the dot product
// is the same sum in another order).
template <typename KT>
__device__ __forceinline__ void q_fragments(uint32_t (&qa)[4][4], const bf16* q,
                                            const float* k_scale, size_t row0, int J, int D,
                                            int h) {
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = (lane & 3) * 2;
  auto pair = [&](int row, int c) -> uint32_t {
    if (row >= J) return 0u;
    const __nv_bfloat162 x =
        *reinterpret_cast<const __nv_bfloat162*>(q + (row0 + row) * D + h * DH + c);
    if constexpr (std::is_same<KT, int8_t>::value) {
      const float2 f = __bfloat1622float2(x);
      return pack_bf16(f.x * k_scale[h * DH + c], f.y * k_scale[h * DH + c + 1]);
    }
    return *reinterpret_cast<const uint32_t*>(&x);
  };
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = 16 * ks + (QUANT ? 2 * cq : cq), c2 = c + (QUANT ? 2 : 8);
    qa[ks][0] = pair(g, c);
    qa[ks][1] = pair(g + 8, c);
    qa[ks][2] = pair(g, c2);
    qa[ks][3] = pair(g + 8, c2);
  }
}

// The scores of one 8-key column tile (keys n0..n0+7 of a swizzled tile)
// for the 16 query rows: c += q k^T.
__device__ __forceinline__ void score_tile(float* c, const uint32_t (&qa)[4][4],
                                           const unsigned char* kt, int n0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t b[4];
    ldsm_x4(b, kt + swz(n0 + (lane & 7), 4 * half + (lane >> 3)), false);
    mma_bf16(c, qa[2 * half], b[0], b[1]);
    mma_bf16(c, qa[2 * half + 1], b[2], b[3]);
  }
}

// The same for an int8 key tile (`swz_i8`): ldmatrix hands each lane the
// four channels 16m + 4t .. 16m + 4t + 3 of key g for k-step m, widened to
// bf16 in registers (exact).
__device__ __forceinline__ void score_tile_i8(float* c, const uint32_t (&qa)[4][4],
                                              const unsigned char* kt, int n0) {
  const int lane = threadIdx.x & 31, r = n0 + (lane & 7);
  uint32_t d[4];
  ldsm_x4(d, kt + swz_i8(r, lane >> 3), false);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const char4 x = *reinterpret_cast<const char4*>(&d[ks]);
    mma_bf16(c, qa[ks], pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  }
}

// Warp w's two column tiles of 8 channels (16w ..) over the 16 keys at kb0
// of a swizzled value tile: acc += p v, p given as an A fragment.
__device__ __forceinline__ void value_step(float (&acc)[2][4], const uint32_t* a,
                                           const unsigned char* vt, int kb0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, m = lane >> 3;
  uint32_t b[4];
  ldsm_x4(b, vt + swz(kb0 + (m & 1) * 8 + (lane & 7), 2 * warp + (m >> 1)), true);
  mma_bf16(acc[0], a, b[0], b[1]);
  mma_bf16(acc[1], a, b[2], b[3]);
}

// The same for an int8 value tile (`swz_i8`): ldmatrix.trans hands each
// lane keys 2t, 2t + 1 (and 8 further) of the channel pair 2g, 2g + 1 of
// warp w's 16 channels, widened in registers; the even channels make
// column tile 0 and the odd ones column tile 1, so the lane's outputs are
// the channels 16w + 4t .. 16w + 4t + 3 (`push_partial`).
__device__ __forceinline__ void value_step_i8(float (&acc)[2][4], const uint32_t* a,
                                              const unsigned char* vt, int kb0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t d[2];
  ldsm_x2_t(d, vt + swz_i8(kb0 + (lane & 7) + ((lane >> 3) & 1) * 8, warp));
  const char4 x = *reinterpret_cast<const char4*>(&d[0]);
  const char4 y = *reinterpret_cast<const char4*>(&d[1]);
  mma_bf16(acc[0], a, pack_bf16(x.x, x.z), pack_bf16(y.x, y.z));
  mma_bf16(acc[1], a, pack_bf16(x.y, x.w), pack_bf16(y.y, y.w));
}

// The warp's partial output (rows < J, its 16 channels) into rank 0's
// table, slot `rank`. Column tile e, accumulator element 2r + c (row g +
// 8r) is channel 8e + 2t + c of the warp's 16 (bf16), or 4t + 2c + e
// (int8, `value_step_i8`).
template <bool QUANT>
__device__ __forceinline__ void push_partial(float* to0, const float (&acc)[2][4], int J) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int rc = 0; rc < 4; ++rc) {
      const int row = g + 8 * (rc >> 1), c = rc & 1;
      const int ch = 16 * warp + (QUANT ? 4 * t + 2 * c + e : 8 * e + 2 * t + c);
      if (row < J) to0[row * DH + ch] = acc[e][rc];
    }
}

// K3s takes a whole chunk in one tile up to this many bytes of keys and
// values: with its j queries a block has more work a key,
// and the launch fewer blocks (`decode_attn.SHARED_SPLIT_BLOCKS`), so a
// larger tile costs no occupancy and saves the ring's waits.
constexpr int SHARED_WHOLE = 64 * 1024;

// K3s's dynamic shared memory, in bytes: the ring, J x cap float scores,
// the S x J x DH partials rank 0 receives, and every rank's J maxima and J
// sums.
__host__ __device__ __forceinline__ int shared_smem(int cap, int tk, int row, int J, int S) {
  return ring_slots(cap, tk) * tk * row + 4 * J * (cap + S * (DH + 2));
}

// K3s (KT bf16) and K3s-int8 (KT int8, with k_scale / v_scale). q, o:
// (G*J, D) group-major (row g*J + i is group g's slot i); k, v: (G, Tp, D);
// J <= 16. Grid (H, G, S) in clusters of (1, 1, S); tk a multiple of 16.
// Scores: warp w takes the 8-key column tiles w, w + 4, ... of a tile, and
// writes the J x cap scores to shared memory; softmax: warp w takes
// queries w, w + 4, ...; values: warp w takes channels 16w .. 16w + 15.
template <typename KT>
__global__ void __launch_bounds__(THREADS)
decode_attn_shared_kernel(const bf16* __restrict__ q, const KT* __restrict__ k,
                               const KT* __restrict__ v, const float* __restrict__ k_scale,
                               const float* __restrict__ v_scale, bf16* __restrict__ o,
                               int Tp, int H, int pos, int J, int chunk, int tk) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int ROW = DH * (int)sizeof(KT);
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const bool multi = S > 1;
  const int h = blockIdx.x, gi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = (lane & 3) * 2;
  const int D = H * DH;
  const int nk = pos + 1;
  const int cap = min(chunk, nk);
  const int c0 = rank * chunk;
  const int nkb = max(0, min(chunk, nk - c0));
  const int nt = (nkb + tk - 1) / tk;
  const int slots = ring_slots(cap, tk);
  unsigned char* ring = smem;
  float* sc = reinterpret_cast<float*>(ring + (size_t)slots * tk * ROW);
  float* parts = sc + J * cap;
  float* xm = parts + S * J * DH;
  float* xl = xm + S * J;
  const KT* kb = k + (size_t)gi * Tp * D + h * DH;
  const KT* vb = v + (size_t)gi * Tp * D + h * DH;
  if (multi) cluster_arrive_relaxed();

  auto fetch = [&](int j) {
    if (j < 2 * nt) {
      const bool val = j >= nt;
      const int t0 = (val ? j - nt : j) * tk;
      shared_copy<KT>(ring + (size_t)(j % slots) * tk * ROW,
                      (val ? vb : kb) + (size_t)(c0 + t0) * D, min(tk, nkb - t0), D, val);
    }
    cp_commit();
  };
  for (int j = 0; j < slots; ++j) fetch(j);
  uint32_t qa[4][4];
  q_fragments<KT>(qa, q, k_scale, (size_t)gi * J, J, D, h);

  for (int j = 0; j < nt; ++j) {
    cp_wait(slots - 1);
    __syncthreads();
    const unsigned char* kt = ring + (size_t)(j % slots) * tk * ROW;
    const int t0 = j * tk, cnt = min(tk, nkb - t0);
    for (int n0 = 8 * warp; n0 < cnt; n0 += 8 * WARPS) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (QUANT)
        score_tile_i8(c, qa, kt, n0);
      else
        score_tile(c, qa, kt, n0);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (n0 + cq + e < cnt) {
          if (g < J) sc[g * cap + t0 + n0 + cq + e] = c[e];
          if (g + 8 < J) sc[(g + 8) * cap + t0 + n0 + cq + e] = c[2 + e];
        }
      }
    }
    if (j + slots < 2 * nt) __syncthreads();  // the slot is refilled
    fetch(j + slots);
  }

  __syncthreads();
  if (multi) cluster_wait();
  for (int i = warp; i < J; i += WARPS) {
    float x = -INFINITY;
    for (int t = lane; t < nkb; t += 32) x = fmaxf(x, sc[i * cap + t]);
    x = warp_max(x);
    if (lane < S) *remote(cluster, multi, &xm[rank * J + i], lane) = x;
  }
  cluster_sync(cluster, multi);
  for (int i = warp; i < J; i += WARPS) {
    float m = -INFINITY;
    for (int r = 0; r < S; ++r) m = fmaxf(m, xm[r * J + i]);
    float x = 0.f;
    for (int t = lane; t < nkb; t += 32) {
      const float e = expf(sc[i * cap + t] - m);
      sc[i * cap + t] = e;
      x += e;
    }
    x = warp_sum(x);
    if (lane < S) *remote(cluster, multi, &xl[rank * J + i], lane) = x;
  }
  cluster_sync(cluster, multi);
  for (int i = warp; i < J; i += WARPS) {
    float l = 0.f;
    for (int r = 0; r < S; ++r) l += xl[r * J + i];
    for (int t = lane; t < nkb; t += 32)
      sc[i * cap + t] = __bfloat162float(__float2bfloat16(sc[i * cap + t] / l));
  }

  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int j = 0; j < nt; ++j) {
    cp_wait(slots - 1);
    __syncthreads();
    const unsigned char* vt = ring + (size_t)((nt + j) % slots) * tk * ROW;
    const int t0 = j * tk, cnt = min(tk, nkb - t0);
    for (int kb0 = 0; kb0 < cnt; kb0 += 16) {
      auto p = [&](int r, int t) { return r < J && t < cnt ? sc[r * cap + t0 + t] : 0.f; };
      const int t = kb0 + cq;
      const uint32_t a[4] = {pack_bf16(p(g, t), p(g, t + 1)), pack_bf16(p(g + 8, t), p(g + 8, t + 1)),
                             pack_bf16(p(g, t + 8), p(g, t + 9)),
                             pack_bf16(p(g + 8, t + 8), p(g + 8, t + 9))};
      if constexpr (QUANT)
        value_step_i8(acc, a, vt, kb0);
      else
        value_step(acc, a, vt, kb0);
    }
    if (nt + j + slots < 2 * nt) __syncthreads();  // the slot is refilled
    fetch(nt + j + slots);
  }
  push_partial<QUANT>(remote(cluster, multi, parts + rank * J * DH, 0), acc, J);
  cluster_sync(cluster, multi);
  if (rank == 0) {
    for (int idx = tid; idx < J * DH; idx += THREADS) {
      float s = 0.f;
      for (int r = 0; r < S; ++r) s += parts[r * J * DH + idx];
      if (QUANT) s *= v_scale[h * DH + idx % DH];
      o[((size_t)gi * J + idx / DH) * D + h * DH + idx % DH] = __float2bfloat16(s);
    }
  }
}

template <typename KT>
int launch_shared(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, void* o, int G, int Tp, int H, int pos, int J, int S,
                  cudaStream_t stream) {
  if (S < 1 || S > MAX_SPLITS || J < 1 || J > 16) return (int)cudaErrorInvalidValue;
  constexpr int ROW = DH * (int)sizeof(KT);
  const int chunk = (Tp + S - 1) / S, cap = chunk < pos + 1 ? chunk : pos + 1;
  // The whole chunk in one tile when its keys and values take at most
  // SHARED_WHOLE bytes, else 4 KB tiles; shrunk (multiples of 16 keys)
  // until the block fits.
  const int whole = (cap + 15) / 16 * 16;
  int tk = 2 * ROW * whole <= SHARED_WHOLE ? whole : 4096 / ROW;
  while (tk > 16 && shared_smem(cap, tk, ROW, J, S) > MAX_DYN_SMEM)
    tk = tk / 32 * 16 > 16 ? tk / 32 * 16 : 16;
  const size_t smem = shared_smem(cap, tk, ROW, J, S);
  if (smem > (size_t)MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  static bool opted[MAX_DEVICES] = {};
  return launch_cluster(decode_attn_shared_kernel<KT>, opted, dim3(H, G, S), S, smem, stream,
                        (const bf16*)q, (const KT*)k, (const KT*)v, (const float*)ks,
                        (const float*)vs, (bf16*)o, Tp, H, pos, J, chunk, tk);
}

}  // namespace

// K3 and its per-row variants, chosen by which pointers are given:
//   anc     (N, Tp) int32, values in [0, J), N % J == 0   -> K3a
//   q_cs, k_cs, gate  bf16 (N, H*64), (N, Tp, H*64), f32 (H,) -> PE
//   k_scale, v_scale  f32 (H*64,); k, v then int8         -> int8
// q, o: (N, H*64) bf16; k, v: (N, Tp, H*64); all contiguous and 16-byte
// aligned; 0 <= pos < Tp; 1 <= S <= 8 blocks a (head, row), one cluster.
// PE with int8 is refused. Shared memory: the ring (the whole chunk, up
// to WHOLE_MAX, or at most 8 tiles of 4 KB) and min(ceil(Tp / S), pos +
// 1) float scores (+ as many ints for K3a), within MAX_DYN_SMEM for pos +
// 1 <= 8192 (the wrapper's MAX_KEYS; 4096 with a map, MAX_ANC_KEYS).
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attn_fwd(const void* q, const void* k, const void* v,
                               const void* anc, const void* q_cs, const void* k_cs,
                               const void* gate, const void* k_scale,
                               const void* v_scale, void* o, int N, int Tp, int H,
                               int pos, int J, int S, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool pe = q_cs != nullptr, quant = k_scale != nullptr;
#define ROWS(ANC, PE, KT)                                                          \
  launch_rows<ANC, PE, KT>(q, k, v, anc, q_cs, k_cs, gate, k_scale, v_scale, o, N, \
                           Tp, H, pos, J, S, s)
  if (pe && quant) return (int)cudaErrorInvalidValue;
  if (quant) return anc ? ROWS(true, false, int8_t) : ROWS(false, false, int8_t);
  if (pe) return anc ? ROWS(true, true, bf16) : ROWS(false, true, bf16);
  return anc ? ROWS(true, false, bf16) : ROWS(false, false, bf16);
#undef ROWS
}

// K3-f32: q, o (N, H*64) float32; k, v (N, Tp, H*64) float32; all
// contiguous and 16-byte aligned; 0 <= pos < Tp; 1 <= S <= 8. Returns
// cudaGetLastError() after the launch.
extern "C" int decode_attn_f32_fwd(const void* q, const void* k, const void* v, void* o,
                                   int N, int Tp, int H, int pos, int S, void* stream) {
  return launch_rows<false, false, float>(q, k, v, nullptr, nullptr, nullptr, nullptr,
                                          nullptr, nullptr, o, N, Tp, H, pos, 1, S,
                                          (cudaStream_t)stream);
}

// K3 at d_head 48 (the side ladder's self- and cross-attention): plain
// bf16 rows, q, o (N, H*48), k, v (N, Tp, H*48); all contiguous and
// 16-byte aligned; 0 <= pos < Tp; 1 <= S <= 8. Returns cudaGetLastError()
// after the launch.
extern "C" int decode_attn_d48_fwd(const void* q, const void* k, const void* v, void* o,
                                   int N, int Tp, int H, int pos, int S, void* stream) {
  return launch_rows<false, false, bf16, 48>(q, k, v, nullptr, nullptr, nullptr, nullptr,
                                             nullptr, nullptr, o, N, Tp, H, pos, 1, S,
                                             (cudaStream_t)stream);
}

// K3s (k_scale null: bf16 caches) and K3s-int8. q, o: (G*J, H*64) bf16
// group-major; k, v: (G, Tp, H*64) bf16 or int8 with f32 (H*64,) scales;
// all contiguous and 16-byte aligned; 0 <= pos < Tp; 1 <= J <= 16; 1 <= S
// <= 8. Shared memory: J * (min(ceil(Tp / S), pos + 1) + S * 66) floats
// beside the ring (the whole chunk up to SHARED_WHOLE, else tiles that
// shrink to 16 keys to fit); the wrapper's bound (J * (pos + 1 + 16 * 64)
// * 4 <= 200 KB) keeps it within MAX_DYN_SMEM. Returns cudaGetLastError()
// after the launch.
extern "C" int decode_attn_shared_fwd(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      void* o, int G, int Tp, int H, int pos, int J, int S,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k_scale)
    return launch_shared<int8_t>(q, k, v, k_scale, v_scale, o, G, Tp, H, pos, J, S, s);
  return launch_shared<bf16>(q, k, v, nullptr, nullptr, o, G, Tp, H, pos, J, S, s);
}
