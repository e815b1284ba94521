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
// K3s is the same split with a tile of up to 16 of the group's queries in
// the block (a grid axis over a group's tiles of balanced sizes, so a block's
// scores take no more shared memory than its queries need), on the tensor cores
// (mma.sync m16n8k16, bf16 in, float32 accumulators; the tile's rows of A
// padded to 16): each key and value row read once serves the tile's
// queries, and no lane reduces a dot product across lanes. Its tiles are
// swizzled for ldmatrix, a head of 128-256 channels as 64-channel
// sub-rows whose k-steps the scores sum; int8 keys and values are widened
// to bf16 in registers (exact), with their channels paired to suit
// ldmatrix. It takes the whole chunk in one tile up to 64 KB, and fills the
// card with fewer, busier blocks.
//
// Routes (`decode_attn.envelope`, from the shapes alone): a block whose
// keys fit one table (`decode_attn.short_keys`: 8192 scores, 4096 beside
// an ancestry map's rows) takes the kernels above (the
// fixed d_head-64 instances, the runtime-width rows and forms entries, K3s
// at d_head 64-256 a multiple of 64); everything else, any width and form,
// the long route at the end of this file.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

// Head width of the fixed instances and of K3s's 64-channel sub-rows: bf16
// rows also run at d_head 48 (the ladder side network's 192 / 4 heads), and
// every form of the rows kernel at a width given at launch up to DH_MAX
// (plain bf16 and float32 rows a multiple of 4; the ancestry map, PE and
// int8 a multiple of a 16-byte piece): the rows kernel takes the width as a
// template parameter (`DW`), or its greatest width with the width itself
// given at launch (`FIXED` false).
constexpr int DH = 64;
constexpr int DH_MAX = 256;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SLOTS = 8;   // ring slots, each one cp.async group
constexpr int MAX_SPLITS = 8;  // blocks of a cluster: the portable size
// Dynamic shared memory a block may take (227 KB less the static arrays:
// the rows kernel's grow with its width, `rows_dyn_smem`).
constexpr int MAX_DYN_SMEM = 220 * 1024;
constexpr int MAX_DEVICES = 64;  // per-device records of the launchers

// One 16-byte copy from global to shared memory, L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// One copy of PB (16 or 8) bytes (the 8-byte form goes through L1).
template <int PB>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (PB == 16) {
    cp_async16(dst, src);
  } else {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
  }
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

// A head slice of a cache row as the kernels read it: PB-byte pieces (16,
// or 8 where 16 do not divide the row: bf16 d_head 36, 44, ...) of CPL
// channels; LPK lanes score a key (PIECES rounded up to a power of 2 up to
// a warp, the lanes past PIECES idle: d_head 48), PPL pieces a lane (2 past
// 32 pieces), KPP keys a warp at once. DW is the slice's (greatest) width.
template <typename KT, int DW, int PB = 16>
struct Slice {
  static constexpr int CPL = PB / (int)sizeof(KT);
  static constexpr int PIECES = DW / CPL;
  static constexpr int LPK = PIECES <= 4 ? 4 : PIECES <= 8 ? 8 : PIECES <= 16 ? 16 : 32;
  static constexpr int PPL = (PIECES + 31) / 32;
  static constexpr int KPP = 32 / LPK;
  static constexpr int BYTES = DW * (int)sizeof(KT);
  static_assert(DW % CPL == 0 && PIECES <= 64, "a head slice is whole pieces, 2 a lane");
};

// A count given at run time, or at compile time as an integral_constant.
__device__ __forceinline__ int count_of(int n) { return n; }
template <int N>
__device__ __forceinline__ int count_of(std::integral_constant<int, N>) { return N; }

// The rows kernel's dynamic shared memory limit: 227 KB less its static
// arrays (the query, the warps' and the ranks' partial outputs at DW
// floats each, the tables), and a margin.
constexpr int rows_dyn_smem(int dw) {
  const int stat = 4 * dw * (2 + WARPS + MAX_SPLITS) + 4 * (2 * WARPS + 2 * MAX_SPLITS);
  return 227 * 1024 - stat - 1024 < MAX_DYN_SMEM ? 227 * 1024 - stat - 1024 : MAX_DYN_SMEM;
}

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

// A piece of a cache row as floats (exact conversions): 16 bytes, or 8 of
// bf16.
template <typename KT, int PB = 16>
__device__ __forceinline__ void unpack(const unsigned char* p, float* f) {
  if constexpr (PB == 8) {
    static_assert(std::is_same<KT, bf16>::value, "8-byte pieces are bf16");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float2 x = __bfloat1622float2(b[c]);
      f[2 * c] = x.x;
      f[2 * c + 1] = x.y;
    }
    return;
  }
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
template <typename KT, int PB = 16>
__device__ __forceinline__ float dot_piece(const unsigned char* p, const float* q) {
  constexpr int CPL = PB / (int)sizeof(KT);
  float kf[CPL];
  unpack<KT, PB>(p, kf);
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
// width, 64, or 48 for the plain bf16 rows; with FIXED false the plain
// rows' greatest width, the width itself `dw_rt` (a multiple of PB's
// channels). Grid (H, N, S) in clusters of (1, 1, S); chunk = ceil(Tp / S)
// keys a block, tiles of tk keys. Dynamic shared memory: the ring (slots x
// tk x ROW bytes), cap = min(chunk, pos + 1) float scores, then (K3a) cap
// int rows.
template <bool ANC, bool PE, typename KT, int DW = DH, int PB = 16, bool FIXED = true>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const typename Query<KT>::T* __restrict__ q, const KT* __restrict__ k,
                   const KT* __restrict__ v, const int* __restrict__ anc,
                   const bf16* __restrict__ q_cs, const bf16* __restrict__ k_cs,
                   const float* __restrict__ gate, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, typename Query<KT>::T* __restrict__ o,
                   int Tp, int H, int pos, int J, int chunk, int tk, int dw_rt) {
  typedef Slice<KT, DW, PB> SL;
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr bool F32 = std::is_same<KT, float>::value;
  constexpr int VP = (DW + 63) / 64;              // value channel pairs a lane
  constexpr int CPT = (DW + THREADS - 1) / THREADS;  // output channels a thread
  const int dw = FIXED ? DW : dw_rt;
  const int pieces = FIXED ? SL::PIECES : dw / SL::CPL;  // a head slice's
  const int bytes = dw * (int)sizeof(KT);
  const int ROW = (PE ? 2 : 1) * bytes;  // a key in a K tile: k, then k_cs
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
  const int D = H * dw;
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

  // A tile's copies: `per_c` PB-byte pieces a key, from k (then k_cs) or v
  // (a compile-time constant at a FIXED width, so the divisions fold).
  auto copy = [&](auto per_c, unsigned char* dst, int t0, int cnt, bool val) {
    const int per = count_of(per_c);
    for (int i = tid; i < cnt * per; i += THREADS) {
      const int kk = i / per, pc = i - kk * per;
      const int r = ANC ? rows[t0 + kk] : n;
      const size_t off = ((size_t)r * Tp + c0 + t0 + kk) * D + h * dw;
      const KT* src =
          val ? v : (PE && pc >= pieces ? reinterpret_cast<const KT*>(k_cs) : k);
      cp_async<PB>(dst + kk * per * PB + pc * PB,
                   reinterpret_cast<const unsigned char*>(src + off) + (pc % pieces) * PB);
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
      if constexpr (FIXED) {
        if (val)
          copy(std::integral_constant<int, SL::PIECES>(), dst, t0, cnt, true);
        else
          copy(std::integral_constant<int, (PE ? 2 : 1) * SL::BYTES / PB>(), dst, t0, cnt,
               false);
      } else {
        copy(val ? pieces : ROW / PB, dst, t0, cnt, val);
      }
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
  for (int c = tid; c < dw; c += THREADS) {
    const size_t qi = (size_t)n * D + h * dw + c;
    qs[c] = query_channel<KT>(q[qi], k_scale, h * dw + c);
    if constexpr (PE) qcs[c] = __bfloat162float(q_cs[qi]);
  }

  // Scores: lane `sub` of a key holds q's channels of its pieces sub, sub +
  // 32 (read after the first tile's barrier, which also publishes qs).
  const int sub = lane % SL::LPK, kq = lane / SL::LPK;
  const bool act = sub < pieces;
  float qr[SL::PPL][SL::CPL], qcr[PE ? SL::PPL : 1][PE ? SL::CPL : 1];
  const float g = PE ? gate[h] : 0.f;
  float mx = -INFINITY;
  for (int j = 0; j < nt; ++j) {
    cp_wait(slots - 1);
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int pp = 0; pp < SL::PPL; ++pp) {
        const int pc = sub + pp * SL::LPK;
        const bool on = pp ? pc < pieces : act;
#pragma unroll
        for (int c = 0; c < SL::CPL; ++c) {
          qr[pp][c] = on ? qs[pc * SL::CPL + c] : 0.f;
          if constexpr (PE) qcr[pp][c] = on ? qcs[pc * SL::CPL + c] : 0.f;
        }
      }
    }
    const unsigned char* kt = ring + (size_t)(j % slots) * tk * ROW;
    const int t0 = j * tk, cnt = min(tk, nkb - t0);
    for (int kk0 = warp * SL::KPP; kk0 < cnt; kk0 += WARPS * SL::KPP) {
      const int kk = kk0 + kq;
      float s = 0.f, s_cs = 0.f;
#pragma unroll
      for (int pp = 0; pp < SL::PPL; ++pp) {
        const int pc = sub + pp * SL::LPK;
        if ((pp ? pc < pieces : act) && kk < cnt) {
          s += dot_piece<KT, PB>(kt + kk * ROW + pc * PB, qr[pp]);
          if constexpr (PE) s_cs += dot_piece<KT, PB>(kt + kk * ROW + bytes + pc * PB, qcr[pp]);
        }
      }
      s = lanes_sum<SL::LPK>(s);
      if constexpr (PE) s = (1.f - g) * s + g * lanes_sum<SL::LPK>(s_cs);
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
  // pairs (2l, 2l+1) + 64i.
  float2 acc[VP];
#pragma unroll
  for (int i = 0; i < VP; ++i) acc[i] = make_float2(0.f, 0.f);
  for (int j = 0; j < nt; ++j) {
    cp_wait(slots - 1);
    __syncthreads();
    const unsigned char* vt = ring + (size_t)((nt + j) % slots) * tk * ROW;
    const int t0 = j * tk, cnt = min(tk, nkb - t0);
    for (int kk = warp; kk < cnt; kk += WARPS) {
      const float w = sc[t0 + kk];
#pragma unroll
      for (int i = 0; i < VP; ++i) {
        const int c = 2 * lane + 64 * i;
        if (c < dw) {
          const float2 f = load_pair(reinterpret_cast<const KT*>(vt + kk * bytes) + c);
          acc[i].x = fmaf(w, f.x, acc[i].x);
          acc[i].y = fmaf(w, f.y, acc[i].y);
        }
      }
    }
    if (nt + j + slots < 2 * nt) __syncthreads();  // the slot is refilled
    fetch(nt + j + slots);
  }
#pragma unroll
  for (int i = 0; i < VP; ++i) {
    const int c = 2 * lane + 64 * i;
    if (c < dw) {
      wpart[warp][c] = acc[i].x;
      wpart[warp][c + 1] = acc[i].y;
    }
  }
  __syncthreads();
  // The warps' sums in warp order, pushed to rank 0, which adds the
  // ranks' partials in rank order; no block's memory is read after the
  // barrier but rank 0's own. One block writes its sum.
  float s[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = tid + i * THREADS;
    s[i] = 0.f;
    if (c < dw) {
      s[i] = wpart[0][c];
      for (int w = 1; w < WARPS; ++w) s[i] += wpart[w][c];
    }
  }
  if (multi) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * THREADS;
      if (c < dw) cluster.map_shared_rank(&parts[rank][0], 0)[c] = s[i];
    }
    cluster.sync();
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * THREADS;
      if (rank == 0 && c < dw) {
        s[i] = 0.f;
        for (int r = 0; r < S; ++r) s[i] += parts[r][c];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = tid + i * THREADS;
    if (rank == 0 && c < dw) {
      if (QUANT) s[i] *= v_scale[h * dw + c];  // v's scale, after the sum
      put(o + (size_t)n * D + h * dw + c, s[i]);
    }
  }
}

// cudaLaunchKernelEx with the S blocks along z as one cluster (S = 1: a
// cluster of one block, which skips the cluster's exchanges). The kernel
// is opted into
// `max_smem` of dynamic shared memory once per device (`opted`, the
// kernel's record): the default allows 48 KB less its static arrays, which
// a launch near 48 KB would exceed. The opt-in is a ceiling; a launch still
// takes only what it asks for.
template <typename... KArgs, typename... Args>
int launch_cluster(void (*kern)(KArgs...), bool* opted, dim3 grid, int S, size_t smem,
                   int max_smem, cudaStream_t stream, Args... args) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !opted[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
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

template <bool ANC, bool PE, typename KT, int DW = DH, int PB = 16, bool FIXED = true>
int launch_rows(const void* q, const void* k, const void* v, const void* anc,
                const void* q_cs, const void* k_cs, const void* gate, const void* ks,
                const void* vs, void* o, int N, int Tp, int H, int pos, int J, int S,
                cudaStream_t stream, int dw = DW) {
  if (S < 1 || S > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  if (FIXED ? dw != DW : (dw <= 0 || dw > DW || dw % Slice<KT, DW, PB>::CPL))
    return (int)cudaErrorInvalidValue;
  const int ROW = (PE ? 2 : 1) * dw * (int)sizeof(KT);
  const int chunk = (Tp + S - 1) / S, cap = chunk < pos + 1 ? chunk : pos + 1;
  const int tk = tile_keys(cap, ROW, whole_chunk_budget(H * N * S));
  const size_t smem = (size_t)ring_slots(cap, tk) * tk * ROW +
                      (size_t)cap * (sizeof(float) + (ANC ? sizeof(int) : 0));
  if (smem > (size_t)rows_dyn_smem(DW)) return (int)cudaErrorInvalidValue;
  typedef typename Query<KT>::T QT;
  static bool opted[MAX_DEVICES] = {};
  return launch_cluster(decode_attn_kernel<ANC, PE, KT, DW, PB, FIXED>, opted, dim3(H, N, S),
                        S, smem, rows_dyn_smem(DW), stream, (const QT*)q, (const KT*)k,
                        (const KT*)v, (const int*)anc, (const bf16*)q_cs, (const bf16*)k_cs,
                        (const float*)gate, (const float*)ks, (const float*)vs, (QT*)o, Tp, H,
                        pos, J, chunk, tk, dw);
}

// The plain rows at a width given at launch (d_head <= 256, a multiple of
// 4): bf16 (16-byte pieces where 8 channels divide the width, else 8-byte)
// or float32 caches, on the instance of the least greatest width of 32, 64,
// 128 and 256 that holds it.
template <typename KT, int PB>
int launch_rows_at(const void* q, const void* k, const void* v, void* o, int N, int Tp,
                   int H, int dw, int pos, int S, cudaStream_t stream) {
#define AT(W)                                                                           \
  launch_rows<false, false, KT, W, PB, false>(q, k, v, nullptr, nullptr, nullptr, nullptr, \
                                              nullptr, nullptr, o, N, Tp, H, pos, 1, S,    \
                                              stream, dw)
  if (dw <= 32) return AT(32);
  if (dw <= 64) return AT(64);
  if (dw <= 128) return AT(128);
  return AT(DH_MAX);
#undef AT
}

// K3s's products run on the tensor cores (mma.sync m16n8k16, bf16 in,
// float32 accumulators): a tile of up to QTILE = 16 of the group's queries
// are the 16 rows of A (rows past the tile's zero), a grid axis over a
// group's tiles, so a key or value row read once serves the tile's queries and
// no lane reduces a dot product across lanes. Tiles hold 128-byte bf16 rows
// with 16-byte chunk c of row r at chunk c ^ (r % 8), so ldmatrix reads
// them without bank conflicts.
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

constexpr int QTILE = 16;  // K3s's queries a block: the rows of mma.sync's A

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

// q as A fragments, one per 16 of the 64 channels from ch0, straight from
// global memory: this lane's rows g and g + 8 (rows J.. zero), columns 2t,
// 2t + 1, and 8 further; int8: bf16(q·s_k), as `query_channel` forms it, with the
// channels paired as `score_tile_i8` pairs the keys' (4t, 4t + 1 for the
// k-slots 2t, 2t + 1; 4t + 2, 4t + 3 for 2t + 8, 2t + 9: the dot product
// is the same sum in another order).
template <typename KT>
__device__ __forceinline__ void q_fragments(uint32_t (&qa)[4][4], const bf16* q,
                                            const float* k_scale, size_t row0, int J, int D,
                                            int ch0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = (lane & 3) * 2;
  auto pair = [&](int row, int c) -> uint32_t {
    if (row >= J) return 0u;
    const __nv_bfloat162 x =
        *reinterpret_cast<const __nv_bfloat162*>(q + (row0 + row) * D + ch0 + c);
    if constexpr (std::is_same<KT, int8_t>::value) {
      const float2 f = __bfloat1622float2(x);
      return pack_bf16(f.x * k_scale[ch0 + c], f.y * k_scale[ch0 + c + 1]);
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
// table, slot `rank`, rows `ld` floats apart. Column tile e, accumulator
// element 2r + c (row g + 8r) is channel 8e + 2t + c of the warp's 16
// (bf16), or 4t + 2c + e (int8, `value_step_i8`).
template <bool QUANT>
__device__ __forceinline__ void push_partial(float* to0, const float (&acc)[2][4], int J,
                                             int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int rc = 0; rc < 4; ++rc) {
      const int row = g + 8 * (rc >> 1), c = rc & 1;
      const int ch = 16 * warp + (QUANT ? 4 * t + 2 * c + e : 8 * e + 2 * t + c);
      if (row < J) to0[row * ld + ch] = acc[e][rc];
    }
}

// K3s takes a whole chunk in one tile up to this many bytes of keys and
// values: with its j queries a block has more work a key,
// and the launch fewer blocks (`decode_attn.SHARED_SPLIT_BLOCKS`), so a
// larger tile costs no occupancy and saves the ring's waits.
constexpr int SHARED_WHOLE = 64 * 1024;

// K3s's dynamic shared memory, in bytes: the ring (tiles of `row` bytes
// a key), J x cap float scores, the S x J x W partials rank 0 receives, and
// every rank's J maxima and J sums.
__host__ __device__ __forceinline__ int shared_smem(int cap, int tk, int row, int J, int S,
                                                    int W) {
  return ring_slots(cap, tk) * tk * row + 4 * J * (cap + S * (W + 2));
}

// K3s (KT bf16) and K3s-int8 (KT int8, with k_scale / v_scale) at d_head W
// = M x 64. q, o: (G*JG, H*W) group-major (row g*JG + i is group g's slot
// i); k, v: (G, Tp, H*W). Grid (H, G x tiles, S) in clusters of (1, 1, S);
// tk a multiple of 16; a tile holds each key's M 64-channel sub-rows as M
// swizzled sub-tiles, and the scores sum the M sub-rows' k-steps. Scores:
// warp w takes the 8-key column tiles w, w + 4, ... of a tile, and writes
// the J x cap scores to shared memory; softmax: warp w takes queries w, w +
// 4, ...; values: warp w takes channels 16w .. 16w + 15 of each sub-row.
template <typename KT, int M = 1>
__global__ void __launch_bounds__(THREADS)
decode_attn_shared_kernel(const bf16* __restrict__ q, const KT* __restrict__ k,
                               const KT* __restrict__ v, const float* __restrict__ k_scale,
                               const float* __restrict__ v_scale, bf16* __restrict__ o,
                               int Tp, int H, int pos, int JG, int chunk, int tk) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int ROW = DH * (int)sizeof(KT);  // a 64-channel sub-row
  constexpr int W = M * DH;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const bool multi = S > 1;
  // blockIdx.y: group gi's query tile ti, each tile a block of its own over
  // the group's cache; a group's JG queries in the fewest tiles of at most
  // QTILE, their sizes balanced (T, then what is left: 20 as 10 + 10)
  const int tiles = (JG + QTILE - 1) / QTILE, T = (JG + tiles - 1) / tiles;
  const int h = blockIdx.x, gi = blockIdx.y / tiles, ti = blockIdx.y - gi * tiles;
  const int J = min(T, JG - T * ti);
  const size_t row0 = (size_t)gi * JG + T * ti;  // the tile's first query row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = (lane & 3) * 2;
  const int D = H * W;
  const int nk = pos + 1;
  const int cap = min(chunk, nk);
  const int c0 = rank * chunk;
  const int nkb = max(0, min(chunk, nk - c0));
  const int nt = (nkb + tk - 1) / tk;
  const int slots = ring_slots(cap, tk);
  const size_t sub = (size_t)tk * ROW;  // a sub-tile's bytes
  unsigned char* ring = smem;
  float* sc = reinterpret_cast<float*>(ring + (size_t)slots * M * sub);
  float* parts = sc + J * cap;
  float* xm = parts + S * J * W;
  float* xl = xm + S * J;
  const KT* kb = k + (size_t)gi * Tp * D + h * W;
  const KT* vb = v + (size_t)gi * Tp * D + h * W;
  if (multi) cluster_arrive_relaxed();

  auto fetch = [&](int j) {
    if (j < 2 * nt) {
      const bool val = j >= nt;
      const int t0 = (val ? j - nt : j) * tk;
#pragma unroll
      for (int m = 0; m < M; ++m)
        shared_copy<KT>(ring + (size_t)(j % slots) * M * sub + m * sub,
                        (val ? vb : kb) + (size_t)(c0 + t0) * D + m * DH, min(tk, nkb - t0), D,
                        val);
    }
    cp_commit();
  };
  for (int j = 0; j < slots; ++j) fetch(j);
  uint32_t qa[M][4][4];
#pragma unroll
  for (int m = 0; m < M; ++m) q_fragments<KT>(qa[m], q, k_scale, row0, J, D, h * W + m * DH);

  for (int j = 0; j < nt; ++j) {
    cp_wait(slots - 1);
    __syncthreads();
    const unsigned char* kt = ring + (size_t)(j % slots) * M * sub;
    const int t0 = j * tk, cnt = min(tk, nkb - t0);
    for (int n0 = 8 * warp; n0 < cnt; n0 += 8 * WARPS) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if constexpr (QUANT)
          score_tile_i8(c, qa[m], kt + m * sub, n0);
        else
          score_tile(c, qa[m], kt + m * sub, n0);
      }
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

  float acc[M][2][4] = {};
  for (int j = 0; j < nt; ++j) {
    cp_wait(slots - 1);
    __syncthreads();
    const unsigned char* vt = ring + (size_t)((nt + j) % slots) * M * sub;
    const int t0 = j * tk, cnt = min(tk, nkb - t0);
    for (int kb0 = 0; kb0 < cnt; kb0 += 16) {
      auto p = [&](int r, int t) { return r < J && t < cnt ? sc[r * cap + t0 + t] : 0.f; };
      const int t = kb0 + cq;
      const uint32_t a[4] = {pack_bf16(p(g, t), p(g, t + 1)), pack_bf16(p(g + 8, t), p(g + 8, t + 1)),
                             pack_bf16(p(g, t + 8), p(g, t + 9)),
                             pack_bf16(p(g + 8, t + 8), p(g + 8, t + 9))};
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if constexpr (QUANT)
          value_step_i8(acc[m], a, vt + m * sub, kb0);
        else
          value_step(acc[m], a, vt + m * sub, kb0);
      }
    }
    if (nt + j + slots < 2 * nt) __syncthreads();  // the slot is refilled
    fetch(nt + j + slots);
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
    push_partial<QUANT>(remote(cluster, multi, parts + rank * J * W, 0) + m * DH, acc[m], J, W);
  cluster_sync(cluster, multi);
  if (rank == 0) {
    for (int idx = tid; idx < J * W; idx += THREADS) {
      float s = 0.f;
      for (int r = 0; r < S; ++r) s += parts[r * J * W + idx];
      if (QUANT) s *= v_scale[h * W + idx % W];
      o[(row0 + idx / W) * D + h * W + idx % W] = __float2bfloat16(s);
    }
  }
}

template <typename KT, int M>
int launch_shared(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, void* o, int G, int Tp, int H, int pos, int JG, int S,
                  cudaStream_t stream) {
  if (S < 1 || S > MAX_SPLITS || JG < 1) return (int)cudaErrorInvalidValue;
  constexpr int ROW = M * DH * (int)sizeof(KT);  // a key's bytes in a tile
  const int tiles = (JG + QTILE - 1) / QTILE, J = (JG + tiles - 1) / tiles;
  const int chunk = (Tp + S - 1) / S, cap = chunk < pos + 1 ? chunk : pos + 1;
  // The whole chunk in one tile when its keys and values take at most
  // SHARED_WHOLE bytes, else 4 KB tiles (16 keys at least); shrunk
  // (multiples of 16 keys) until the block fits.
  const int whole = (cap + 15) / 16 * 16;
  int tk = 2 * ROW * whole <= SHARED_WHOLE ? whole : 4096 / ROW >= 16 ? 4096 / ROW : 16;
  while (tk > 16 && shared_smem(cap, tk, ROW, J, S, M * DH) > MAX_DYN_SMEM)
    tk = tk / 32 * 16 > 16 ? tk / 32 * 16 : 16;
  const size_t smem = shared_smem(cap, tk, ROW, J, S, M * DH);
  if (smem > (size_t)MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  static bool opted[MAX_DEVICES] = {};
  return launch_cluster(decode_attn_shared_kernel<KT, M>, opted, dim3(H, G * tiles, S), S, smem,
                        MAX_DYN_SMEM, stream,
                        (const bf16*)q, (const KT*)k, (const KT*)v, (const float*)ks,
                        (const float*)vs, (bf16*)o, Tp, H, pos, JG, chunk, tk);
}


// The long route: `_make_kernel_chunked` (decode_attn.py:341-465, the
// online-softmax carry over time chunks) for every form of the rows kernel
// (plain, ancestry, PE, int8, float32) and for K3s's groups (one query a
// block, its group's cache row), at any head width. The split over time
// and its cluster stay as above; what changes is inside a block. Its keys
// are walked in passes of kc keys (`decode_attn.PASS_KEYS`, a shape
// constant), so its scores never need more than kc floats of shared
// memory: each pass scores its keys, then takes JAX's recurrence, m_new =
// max(m, max s), alpha = exp(m - m_new), p = exp(s - m_new), l = alpha l
// + sum p, the value sum acc = alpha acc + sum bf16(p) v (p rounded to the
// cache's dtype as JAX rounds it, float32 not rounded), each key and value
// read once. At the end each block pushes (m, l) and its partial output to
// rank 0, which takes M = max m, e_r = exp(m_r - M), L = sum e_r l_r and
// O = sum e_r acc_r in rank order and divides once; a block with no keys
// brings m = -inf, l = 0. Heads wider than PIECE channels are streamed in
// PIECE-wide pieces: a K tile holds one column piece of its keys (the
// scores summed over the pieces), and a grid axis over the head's output
// pieces gives each block the V piece of its own (K is read once per
// output piece). A head slice whose rows are not 16-byte aligned (any
// d_head) is copied in the largest unit that divides its bytes, the tail of
// each 16-byte piece zero-filled in shared memory (q is zero there too), so
// no cache is ever padded. Bound: bytes, as the rows kernel.
constexpr int PIECE = 256;       // channels of a head piece
constexpr int LONG_TILE = 4096;  // bytes of a ring tile (one key at least)
constexpr int MAX_PASS = 4096;  // keys of a pass at most (its scores)
// its dynamic shared memory at most (the ring's 32 KB and 16 KB of scores),
// beside 12.4 KB of static arrays
constexpr int LONG_DYN_SMEM = 64 * 1024;
enum { LONG_ROWS = 0, LONG_ANC = 1, LONG_SHARED = 2 };

// A 4-byte copy from global to shared memory (through L1).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// One 16-byte piece of a tile: `valid` bytes (a multiple of cu, possibly
// none) from src in copies of `cu` bytes (16, 8, 4 by cp.async; 2 or 1 by
// plain loads where the head slice's rows are not 4-byte aligned), the
// rest zero.
__device__ __forceinline__ void copy_piece(unsigned char* dst, const unsigned char* src,
                                           int valid, int cu) {
  if (cu == 16 && valid >= 16) {
    cp_async16(dst, src);
    return;
  }
  for (int b = 0; b < 16; b += cu) {
    unsigned char* d = dst + b;
    if (b >= valid) {
      for (int z = 0; z < cu; ++z) d[z] = 0;
    } else if (cu == 8) {
      cp_async<8>(d, src + b);
    } else if (cu == 4) {
      cp_async4(d, src + b);
    } else if (cu == 2) {
      *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(src + b);
    } else {
      *d = src[b];
    }
  }
}

// The sum over a key's lpk lanes (lpk a power of 2 given at launch).
__device__ __forceinline__ float lanes_sum_n(float s, int lpk) {
  for (int off = lpk >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// MODE: LONG_ROWS (row n reads cache row n), LONG_ANC (row n of group n / J
// reads position t from row (n / J) J + anc[n, t], clamped into the group),
// LONG_SHARED (query n reads cache row n / J: K3s's group of J). PE, KT as
// the rows kernel (q_cs in the query's type, k_cs in the cache's). Grid (N,
// H x NP, S) in clusters of (1, 1, S), NP = ceil(dh / PIECE); chunk =
// ceil(Tp / S) keys a block, passes of kc keys, tiles of tk keys (kc a
// multiple of tk); lpk lanes score a key; cu the copy unit. Dynamic shared
// memory: MAX_SLOTS ring slots of tk keys x kstride bytes, then kc float
// scores.
template <int MODE, bool PE, typename KT>
__global__ void __launch_bounds__(THREADS)
decode_attn_long_kernel(const typename Query<KT>::T* __restrict__ q, const KT* __restrict__ k,
                        const KT* __restrict__ v, const int* __restrict__ anc,
                        const typename Query<KT>::T* __restrict__ q_cs,
                        const KT* __restrict__ k_cs, const float* __restrict__ gate,
                        const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                        typename Query<KT>::T* __restrict__ o, int Tp, int H, int dh, int pos,
                        int J, int chunk, int kc, int tk, int lpk, int cu) {
  typedef typename Query<KT>::T QT;
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr bool F32 = std::is_same<KT, float>::value;
  constexpr int ESZ = (int)sizeof(KT);
  constexpr int CPL = 16 / ESZ;                      // channels of a piece
  constexpr int PPL = (PIECE * ESZ / 16 + 31) / 32;  // pieces a lane: 2 for float32
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float redm[WARPS], redl[WARPS];
  __shared__ float wpart[WARPS][PIECE];
  __shared__ float xm[MAX_SPLITS], xl[MAX_SPLITS], xe[MAX_SPLITS];
  __shared__ float parts[MAX_SPLITS][PIECE];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const bool multi = S > 1;
  const int np = (dh + PIECE - 1) / PIECE;
  const int n = blockIdx.x, h = blockIdx.y / np, piece = blockIdx.y - h * np;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = H * dh;
  const int pw = min(PIECE, dh - piece * PIECE);          // the block's output channels
  const int krow = (min(dh, PIECE) * ESZ + 15) / 16 * 16;  // a key's bytes of a piece
  const int kstride = (PE ? 2 : 1) * krow;                 // in a K tile: k, then k_cs
  const int start = rank * chunk;                          // the block's first key
  const int own = max(0, min(chunk, pos + 1 - start));     // its keys, none past pos
  const int npass = (own + kc - 1) / kc;
  const int last_keys = own - (npass - 1) * kc;
  const int full = kc / tk * (np + 1);                     // the loads of a whole pass
  const int loads = npass ? (npass - 1) * full + (last_keys + tk - 1) / tk * (np + 1) : 0;
  unsigned char* ring = smem;
  float* sc = reinterpret_cast<float*>(smem + (size_t)MAX_SLOTS * tk * kstride);
  const int base = MODE == LONG_ANC ? n / J * J : MODE == LONG_SHARED ? n / J : n;
  if (multi) cluster_arrive_relaxed();

  // Load j of the block: of pass p, the K tiles (tile i, column piece c)
  // i-major, then the V tiles of the block's own piece. Returns whether it
  // is a V tile.
  auto load_of = [&](int j, int& pass, int& tile, int& col) -> bool {
    pass = min(j / full, npass - 1);
    const int r = j - pass * full;
    const int tiles = ((pass == npass - 1 ? last_keys : kc) + tk - 1) / tk;
    if (r < tiles * np) {
      tile = r / np;
      col = r - tile * np;
      return false;
    }
    tile = r - tiles * np;
    col = piece;
    return true;
  };
  // Load j into slot j % MAX_SLOTS as one cp.async group (past the last
  // load an empty group, so a wait for MAX_SLOTS - 1 pending finds load j).
  auto fetch = [&](int j) {
    if (j < loads) {
      int pass, tile, col;
      const bool val = load_of(j, pass, tile, col);
      const int keys = pass == npass - 1 ? last_keys : kc;
      const int t0 = start + pass * kc + tile * tk, cnt = min(tk, keys - tile * tk);
      const int cb = min(PIECE, dh - col * PIECE) * ESZ, kp = (cb + 15) / 16;
      const int per = (PE && !val ? 2 : 1) * kp;
      unsigned char* dst = ring + (size_t)(j % MAX_SLOTS) * tk * kstride;
      for (int i = tid; i < cnt * per; i += THREADS) {
        const int kk = i / per, pc = i - kk * per, t = t0 + kk;
        const bool cs = PE && !val && pc >= kp;
        const int p = cs ? pc - kp : pc;
        const int r = MODE == LONG_ANC ? base + min(max(anc[(size_t)n * Tp + t], 0), J - 1) : base;
        const KT* src = val ? v : cs ? k_cs : k;
        copy_piece(dst + kk * (val ? krow : kstride) + (cs ? krow : 0) + p * 16,
                   reinterpret_cast<const unsigned char*>(src + ((size_t)r * Tp + t) * D + h * dh +
                                                          col * PIECE) + p * 16,
                   cb - p * 16, cu);
      }
    }
    cp_commit();
  };
  for (int j = 0; j < MAX_SLOTS; ++j) fetch(j);

  // q's channels of column piece c in registers: lane `sub` of a key holds
  // those of its pieces sub, sub + lpk (zero past the head).
  const int sub = lane % lpk, kq = lane / lpk, kpp = 32 / lpk;
  const QT* qn = q + (size_t)n * D + h * dh;
  const QT* qcn = PE ? q_cs + (size_t)n * D + h * dh : nullptr;
  float qr[PPL][CPL], qcr[PE ? PPL : 1][PE ? CPL : 1];
  auto load_q = [&](int col) {
#pragma unroll
    for (int pp = 0; pp < PPL; ++pp)
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int at = (sub + pp * lpk) * CPL + c, ch = col * PIECE + at;
        const bool on = at < PIECE && ch < dh;
        qr[pp][c] = on ? query_channel<KT>(qn[ch], k_scale, h * dh + ch) : 0.f;
        if constexpr (PE) qcr[pp][c] = on ? to_float(qcn[ch]) : 0.f;
      }
  };
  const float g = PE ? gate[h] : 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  float2 acc[PIECE / 64];
#pragma unroll
  for (int i = 0; i < PIECE / 64; ++i) acc[i] = make_float2(0.f, 0.f);
  int qcol = -1;
  for (int j = 0; j < loads; ++j) {
    cp_wait(MAX_SLOTS - 1);
    __syncthreads();
    int pass, tile, col;
    const bool val = load_of(j, pass, tile, col);
    const int keys = pass == npass - 1 ? last_keys : kc;
    const int cnt = min(tk, keys - tile * tk);
    const unsigned char* tl = ring + (size_t)(j % MAX_SLOTS) * tk * kstride;
    if (!val) {
      // scores of column piece col, summed into the pass's table
      if (col != qcol) {
        load_q(col);
        qcol = col;
      }
      const int kp = (min(PIECE, dh - col * PIECE) * ESZ + 15) / 16;
      for (int kk0 = warp * kpp; kk0 < cnt; kk0 += WARPS * kpp) {
        const int kk = kk0 + kq;
        float s = 0.f, s_cs = 0.f;
#pragma unroll
        for (int pp = 0; pp < PPL; ++pp) {
          const int pc = sub + pp * lpk;
          if (pc < kp && kk < cnt) {
            s += dot_piece<KT>(tl + kk * kstride + pc * 16, qr[pp]);
            if constexpr (PE) s_cs += dot_piece<KT>(tl + kk * kstride + krow + pc * 16, qcr[pp]);
          }
        }
        s = lanes_sum_n(s, lpk);
        if constexpr (PE) s = (1.f - g) * s + g * lanes_sum_n(s_cs, lpk);
        if (sub == 0 && kk < cnt) {
          float* at = sc + tile * tk + kk;
          *at = col ? *at + s : s;
        }
      }
    } else {
      if (tile == 0) {
        // the pass's scores are in: JAX's online-softmax step
        float mx = -INFINITY;
        for (int t = tid; t < keys; t += THREADS) mx = fmaxf(mx, sc[t]);
        mx = block_max(mx, redm);
        const float m_new = fmaxf(m_run, mx);
        const float alpha = expf(m_run - m_new);  // 0 on the first pass
        float ps = 0.f;
        for (int t = tid; t < keys; t += THREADS) {
          const float e = expf(sc[t] - m_new);
          ps += e;
          sc[t] = F32 ? e : __bfloat162float(__float2bfloat16(e));  // JAX's cast of p
        }
        l_run = alpha * l_run + block_sum(ps, redl);
        m_run = m_new;
#pragma unroll
        for (int i = 0; i < PIECE / 64; ++i) {
          acc[i].x *= alpha;
          acc[i].y *= alpha;
        }
      }
      for (int kk = warp; kk < cnt; kk += WARPS) {
        const float w = sc[tile * tk + kk];
#pragma unroll
        for (int i = 0; i < PIECE / 64; ++i) {
          const int c = 2 * lane + 64 * i;
          if (c < pw) {
            const float2 f = load_pair(reinterpret_cast<const KT*>(tl + kk * krow) + c);
            acc[i].x = fmaf(w, f.x, acc[i].x);
            acc[i].y = fmaf(w, f.y, acc[i].y);
          }
        }
      }
    }
    if (j + MAX_SLOTS < loads) __syncthreads();  // the slot is refilled
    fetch(j + MAX_SLOTS);
  }
#pragma unroll
  for (int i = 0; i < PIECE / 64; ++i) {
    const int c = 2 * lane + 64 * i;
    if (c < pw) {
      wpart[warp][c] = acc[i].x;
      wpart[warp][c + 1] = acc[i].y;
    }
  }
  __syncthreads();
  // The warps' sums in warp order; every rank's (m, l) and partial to rank
  // 0, which merges them in rank order and divides once.
  float s[PIECE / THREADS];
#pragma unroll
  for (int i = 0; i < PIECE / THREADS; ++i) {
    const int c = tid + i * THREADS;
    s[i] = 0.f;
    if (c < pw) {
      s[i] = wpart[0][c];
      for (int w = 1; w < WARPS; ++w) s[i] += wpart[w][c];
    }
  }
  if (multi) cluster_wait();
  if (tid == 0) {
    *remote(cluster, multi, &xm[rank], 0) = m_run;
    *remote(cluster, multi, &xl[rank], 0) = l_run;
  }
#pragma unroll
  for (int i = 0; i < PIECE / THREADS; ++i) {
    const int c = tid + i * THREADS;
    if (c < pw) remote(cluster, multi, &parts[rank][0], 0)[c] = s[i];
  }
  cluster_sync(cluster, multi);
  if (rank == 0) {
    float M = xm[0];
    for (int r = 1; r < S; ++r) M = fmaxf(M, xm[r]);
    if (tid < S) xe[tid] = expf(xm[tid] - M);  // 0 for a block with no keys
    __syncthreads();
    float L = 0.f;
    for (int r = 0; r < S; ++r) L += xe[r] * xl[r];
#pragma unroll
    for (int i = 0; i < PIECE / THREADS; ++i) {
      const int c = tid + i * THREADS;
      if (c < pw) {
        float out = 0.f;
        for (int r = 0; r < S; ++r) out += xe[r] * parts[r][c];
        out /= L;
        const int ch = h * dh + piece * PIECE + c;
        if (QUANT) out *= v_scale[ch];  // v's scale, after the sum
        put(o + (size_t)n * D + ch, out);
      }
    }
  }
}

template <int MODE, bool PE, typename KT>
int launch_long(const void* q, const void* k, const void* v, const void* anc, const void* q_cs,
                const void* k_cs, const void* gate, const void* ks, const void* vs, void* o,
                int N, int Tp, int H, int dh, int pos, int J, int S, int kc,
                cudaStream_t stream) {
  if (S < 1 || S > MAX_SPLITS || dh < 1 || J < 1 || kc < 64 || kc % 64 || kc > MAX_PASS)
    return (int)cudaErrorInvalidValue;
  constexpr int ESZ = (int)sizeof(KT);
  constexpr int PPL = (PIECE * ESZ / 16 + 31) / 32;
  const int krow = ((dh < PIECE ? dh : PIECE) * ESZ + 15) / 16 * 16;
  const int kstride = (PE ? 2 : 1) * krow;
  int tk = 64;  // a power of 2, so it divides kc
  while (tk > 1 && tk * kstride > LONG_TILE) tk >>= 1;
  int lpk = 1;
  while (lpk * PPL < krow / 16) lpk <<= 1;
  const int bytes = dh * ESZ;
  const int cu = bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4
                                                        : bytes % 2 == 0 ? 2 : 1;
  const int np = (dh + PIECE - 1) / PIECE;
  const size_t smem = (size_t)MAX_SLOTS * tk * kstride + (size_t)kc * sizeof(float);
  if (smem > (size_t)LONG_DYN_SMEM || (long long)H * np > 65535) return (int)cudaErrorInvalidValue;
  typedef typename Query<KT>::T QT;
  static bool opted[MAX_DEVICES] = {};
  return launch_cluster(decode_attn_long_kernel<MODE, PE, KT>, opted, dim3(N, H * np, S), S,
                        smem, LONG_DYN_SMEM, stream, (const QT*)q, (const KT*)k, (const KT*)v,
                        (const int*)anc, (const QT*)q_cs, (const KT*)k_cs, (const float*)gate,
                        (const float*)ks, (const float*)vs, (QT*)o, Tp, H, dh, pos, J,
                        (Tp + S - 1) / S, kc, tk, lpk, cu);
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
// 1) float scores (+ as many ints for K3a), within the rows kernel's
// shared memory for a chunk of up to 8192 keys, 4096 for K3a, at every
// width (the wrapper's `decode_attn.short_keys`). Returns
// cudaGetLastError() after the launch.
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

// K3 and K3-f32 at any other width: plain rows, q, o (N, H*dw), k, v (N,
// Tp, H*dw), bf16 (f32 0) or float32 (f32 1); dw <= 256 a multiple of 4;
// all contiguous and 16-byte aligned; 0 <= pos < Tp; 1 <= S <= 8. Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a width
// it does not take.
extern "C" int decode_attn_rows_fwd(const void* q, const void* k, const void* v, void* o,
                                    int f32, int N, int Tp, int H, int dw, int pos, int S,
                                    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dw <= 0 || dw > DH_MAX || dw % 4) return (int)cudaErrorInvalidValue;
  if (f32) return launch_rows_at<float, 16>(q, k, v, o, N, Tp, H, dw, pos, S, st);
  if (dw % 8 == 0) return launch_rows_at<bf16, 16>(q, k, v, o, N, Tp, H, dw, pos, S, st);
  return launch_rows_at<bf16, 8>(q, k, v, o, N, Tp, H, dw, pos, S, st);
}

// K3s (k_scale null: bf16 caches) and K3s-int8 at d_head dh = 64, 128, 192
// or 256. q, o: (G*J, H*dh) bf16 group-major; k, v: (G, Tp, H*dh) bf16 or
// int8 with f32 (H*dh,) scales; all contiguous and 16-byte aligned; 0 <=
// pos < Tp; J >= 1 (in ceil(J / 16) tiles of ceil(J / tiles)); 1 <= S <= 8.
// Shared memory: ceil(J / tiles) *
// (min(ceil(Tp / S), pos + 1) + S * (dh + 2)) floats beside the ring (the
// whole chunk up to SHARED_WHOLE, else tiles that shrink to 16 keys to
// fit); the wrapper (`decode_attn.envelope`) sends a call here only where
// that with a ring of 8 x 16 keys fits MAX_DYN_SMEM. Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a width
// or size it does not take.
extern "C" int decode_attn_shared_fwd(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      void* o, int G, int Tp, int H, int dh, int pos, int J,
                                      int S, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dh % DH || dh < DH || dh > 4 * DH) return (int)cudaErrorInvalidValue;
#define SHARED(KT, M) launch_shared<KT, M>(q, k, v, k_scale, v_scale, o, G, Tp, H, pos, J, S, s)
#define WIDTH(KT) \
  (dh == DH ? SHARED(KT, 1) : dh == 2 * DH ? SHARED(KT, 2) : dh == 3 * DH ? SHARED(KT, 3) \
                                                                          : SHARED(KT, 4))
  if (k_scale) return WIDTH(int8_t);
  return WIDTH(bf16);
#undef WIDTH
#undef SHARED
}

// K3a, K3-PE, K3a-PE, K3-int8 and K3a-int8 at a head width other than 64,
// given at launch (the short route: a block's keys fit one table): dw <=
// 256, a multiple of 8 (bf16) or 16 (int8), on the instance of the least
// greatest width of 64, 128 and 256 that holds it; the arguments as
// decode_attn_fwd's with H * dw channels. Returns cudaGetLastError() after
// the launch, cudaErrorInvalidValue for what it does not take (plain rows
// take decode_attn_rows_fwd).
extern "C" int decode_attn_forms_fwd(const void* q, const void* k, const void* v,
                                     const void* anc, const void* q_cs, const void* k_cs,
                                     const void* gate, const void* k_scale,
                                     const void* v_scale, void* o, int N, int Tp, int H,
                                     int dw, int pos, int J, int S, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool pe = q_cs != nullptr, quant = k_scale != nullptr;
  if ((pe && quant) || (!anc && !pe && !quant) || dw <= 0 || dw > DH_MAX ||
      dw % (quant ? 16 : 8))
    return (int)cudaErrorInvalidValue;
#define FORM(ANC, PE, KT, W)                                                               \
  launch_rows<ANC, PE, KT, W, 16, false>(q, k, v, anc, q_cs, k_cs, gate, k_scale, v_scale, o, \
                                         N, Tp, H, pos, J, S, st, dw)
#define AT(ANC, PE, KT) \
  (dw <= 64 ? FORM(ANC, PE, KT, 64) : dw <= 128 ? FORM(ANC, PE, KT, 128) : FORM(ANC, PE, KT, DH_MAX))
  if (quant) return anc ? AT(true, false, int8_t) : AT(false, false, int8_t);
  if (pe) return anc ? AT(true, true, bf16) : AT(false, true, bf16);
  return AT(true, false, bf16);
#undef AT
#undef FORM
}

// The long route (`decode_attn_long_kernel`): mode 0 plain rows, 1 the
// ancestry map (anc (N, Tp) int32, groups of J), 2 K3s's shared caches (q
// (N, H*dh) over (N / J, Tp, H*dh)); bf16, int8 (k_scale, v_scale) or
// float32 (f32 1) caches; PE (q_cs, k_cs, gate) on modes 0 and 1, not
// with int8; any dh >= 1; all contiguous, 16-byte aligned; 0 <= pos < Tp;
// 1 <= S <= 8; kc, the keys of a pass, a multiple of 64 up to 4096.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for
// what it does not take.
extern "C" int decode_attn_long_fwd(const void* q, const void* k, const void* v,
                                    const void* anc, const void* q_cs, const void* k_cs,
                                    const void* gate, const void* k_scale, const void* v_scale,
                                    void* o, int N, int Tp, int H, int dh, int pos, int mode,
                                    int J, int f32, int S, int kc, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool pe = q_cs != nullptr, quant = k_scale != nullptr;
  if ((pe && quant) || (f32 && quant) || (mode == LONG_SHARED && pe) || mode < 0 || mode > 2 ||
      (mode == LONG_ANC) != (anc != nullptr))
    return (int)cudaErrorInvalidValue;
#define LONG(MODE, PE, KT)                                                                    \
  launch_long<MODE, PE, KT>(q, k, v, anc, q_cs, k_cs, gate, k_scale, v_scale, o, N, Tp, H, dh, \
                            pos, J, S, kc, st)
#define FORMS(MODE)                                                                 \
  (quant ? LONG(MODE, false, int8_t)                                                \
         : f32 ? (pe ? LONG(MODE, true, float) : LONG(MODE, false, float))          \
               : (pe ? LONG(MODE, true, bf16) : LONG(MODE, false, bf16)))
  if (mode == LONG_SHARED)
    return quant ? LONG(LONG_SHARED, false, int8_t)
                 : f32 ? LONG(LONG_SHARED, false, float) : LONG(LONG_SHARED, false, bf16);
  return mode == LONG_ANC ? FORMS(LONG_ANC) : FORMS(LONG_ROWS);
#undef FORMS
#undef LONG
}
