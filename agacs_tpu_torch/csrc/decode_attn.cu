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
// . k over a head's 64 channels with bf16 (or int8) inputs and float32
// accumulation, float32 softmax over keys 0..pos, normalized BEFORE the
// bf16 cast of p, then the value sum with float32 accumulation and a bf16
// output. The int8 forms fold the scales as the TPU kernel does: q·s_k is
// formed in float32 and rounded to bf16 once per block (the TPU's bf16
// query matrix), int8 -> float is exact, and s_v multiplies the float32
// value sum before the bf16 cast. K3-f32 keeps everything in float32.
//
// What bounds them here: HBM bytes. A call reads 2*N*(pos+1)*d*2 bytes of
// cache (K3 / K3a self-attention; K3a reads the same bytes as plain rows,
// only from other rows of the group; PE 3*N*(pos+1)*d*2, 1.5x; int8
// 2*N*(pos+1)*d, half; K3-f32 2*N*(pos+1)*d*4, twice; the LM's 80 rows x
// 104 keys x 512 read 34 MB per layer at pos 103) or 2*G*T_enc*d*2 (K3s:
// 18.4 MB at G=8, T_enc=750,
// d=768, where the per-row layout of 40 beam rows would read 92 MB; int8
// half of that), and does 4 FLOPs per byte-pair (K3s: 4*j), far below
// the card's ~295 FLOP/byte ridge. So the design reads each needed byte
// once: keys past pos are skipped, not loaded (their TPU weight
// exp(-1e30 - m) is exactly 0, so the result is unchanged), and the time
// loop runs inside the block, which covers any Tp and so also the TPU's
// VMEM-driven chunked variant.
//
// The TPU kernels resolve the ancestry map, the group's queries and the
// per-head gate with one-hot and block-diagonal matrix products because
// Mosaic cannot gather (decode_attn.py:16-33, :233-243); a Hopper thread
// reads any row, and a block owns one head, so its gate is one scalar.
//
// K3 / K3a (and their PE and int8 forms): one block of 4 warps per (head,
// row). Phase 1: one thread per key reads (K3a: first the key's physical
// row, kept in shared memory for phase 3) the key's head slice (128 bytes
// of bf16 or 64 of int8, in 16-byte loads; PE also k_cs's 128 bytes from
// the same row) and keeps the score in shared memory. Phase 2: block max
// and sum. Phase 3: warp w takes keys w, w+4, ...; lane l the channel pair
// (2l, 2l+1), so a warp reads one head row per key; the 4 partial sums
// meet in shared memory. Shared memory: pos+1 floats, plus pos+1 ints
// (K3a). One block per (head, row) gives H*N blocks (96 at the greedy
// 8-row batch, 480 at 8 x beam 5).
//
// K3s: one block of 16 warps per (head, group). Each thread loads key t's
// head slice once and computes all j dot products; the j x (pos+1) scores
// and the warps' j x 64 partial outputs live in dynamic shared memory
// (35 KB at j=5, T=750; the attribute is set on every launch, so up to the
// wrapper's 200 KB bound). Max and sum per query, then warps stride over
// keys with lanes on channel pairs and accumulate j outputs each. One
// block per (head, group) gives only H*G blocks (96 at 8 utterances), so
// the block is wide (16 warps, where K3's 4 warps left the value loop
// waiting on loads); a split over time is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

namespace {

// Head width of every kernel but K3's plain bf16 rows, which also run at
// d_head 48 (the ladder side network's 192 / 4 heads): their kernel takes
// the width as a template parameter (`DW`).
constexpr int DH = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// K3s runs 16 warps a block: with one block per (head, group) there are
// only H*G blocks, and 4 warps an SM left its value loop latency-bound.
constexpr int SH_WARPS = 16;
constexpr int SH_THREADS = SH_WARPS * 32;

template <int NW = WARPS>
__device__ __forceinline__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < NW; ++w) x = fmaxf(x, red[w]);
  __syncthreads();
  return x;
}

template <int NW = WARPS>
__device__ __forceinline__ float block_sum(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < NW; ++w) x += red[w];
  __syncthreads();
  return x;
}

// One head's DW cache channels into float registers: bf16 as DW / 8
// 16-byte loads (eight at 64, six at 48: a 96-byte head slice, still
// 16-byte aligned), int8 as DW / 16 (exact conversions both).
template <int DW>
__device__ __forceinline__ void load_head(const bf16* __restrict__ kp, float* kf) {
  const uint4* kr = reinterpret_cast<const uint4*>(kp);
#pragma unroll
  for (int i = 0; i < DW / 8; ++i) {
    const uint4 u = kr[i];
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 f = __bfloat1622float2(k2[c]);
      kf[i * 8 + 2 * c] = f.x;
      kf[i * 8 + 2 * c + 1] = f.y;
    }
  }
}

template <int DW>
__device__ __forceinline__ void load_head(const int8_t* __restrict__ kp, float* kf) {
  const int4* kr = reinterpret_cast<const int4*>(kp);
#pragma unroll
  for (int i = 0; i < DW / 16; ++i) {
    const int4 u = kr[i];
    const char4* c4 = reinterpret_cast<const char4*>(&u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kf[i * 16 + 4 * c] = (float)c4[c].x;
      kf[i * 16 + 4 * c + 1] = (float)c4[c].y;
      kf[i * 16 + 4 * c + 2] = (float)c4[c].z;
      kf[i * 16 + 4 * c + 3] = (float)c4[c].w;
    }
  }
}

template <int DW>
__device__ __forceinline__ void load_head(const float* __restrict__ kp, float* kf) {
  const float4* kr = reinterpret_cast<const float4*>(kp);
#pragma unroll
  for (int i = 0; i < DW / 4; ++i) {
    const float4 u = kr[i];
    kf[4 * i] = u.x;
    kf[4 * i + 1] = u.y;
    kf[4 * i + 2] = u.z;
    kf[4 * i + 3] = u.w;
  }
}

// The channel pair (c, c+1) of a value row.
__device__ __forceinline__ float2 load_pair(const bf16* __restrict__ vp) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vp));
}

__device__ __forceinline__ float2 load_pair(const int8_t* __restrict__ vp) {
  const char2 c = *reinterpret_cast<const char2*>(vp);
  return make_float2((float)c.x, (float)c.y);
}

__device__ __forceinline__ float2 load_pair(const float* __restrict__ vp) {
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

// q . k over one head's DW channels.
template <int DW, typename KT>
__device__ __forceinline__ float dot_head(const KT* __restrict__ kp, const float* qs) {
  float kf[DW];
  load_head<DW>(kp, kf);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DW; ++c) s = fmaf(qs[c], kf[c], s);
  return s;
}

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
// query, caches and output, p not rounded. anc: (N, Tp) int32 local
// rows in [0, J) (clamped into it); row n of group n / J reads position t
// from row (n / J) * J + anc[n, t], for k, k_cs and v alike. DW: the head
// width, 64, or 48 for the plain bf16 rows (lanes 24-31 then carry no
// channel pair in phase 3).
template <bool ANC, bool PE, typename KT, int DW = DH>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const typename Query<KT>::T* __restrict__ q, const KT* __restrict__ k,
                   const KT* __restrict__ v, const int* __restrict__ anc,
                   const bf16* __restrict__ q_cs, const bf16* __restrict__ k_cs,
                   const float* __restrict__ gate, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, typename Query<KT>::T* __restrict__ o,
                   int Tp, int H, int pos, int J) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr bool F32 = std::is_same<KT, float>::value;
  extern __shared__ float p[];  // pos + 1 scores, then weights; K3a: then pos + 1 rows
  __shared__ float qs[DW];
  __shared__ float qcs[PE ? DW : 1];
  __shared__ float red[WARPS];
  __shared__ float part[WARPS][DW];
  const int h = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = H * DW;
  const int nk = pos + 1;
  int* rows = reinterpret_cast<int*>(p + nk);
  const int* an = ANC ? anc + (size_t)n * Tp : nullptr;
  const int base = ANC ? (n / J) * J : n;

  if (tid < DW) {
    const size_t qi = (size_t)n * D + h * DW + tid;
    qs[tid] = query_channel<KT>(q[qi], k_scale, h * DW + tid);
    if (PE) qcs[tid] = __bfloat162float(q_cs[qi]);
  }
  const float g = PE ? gate[h] : 0.f;
  __syncthreads();

  float mx = -INFINITY;
  for (int t = tid; t < nk; t += THREADS) {
    int r = n;
    if (ANC) {
      r = base + min(max(an[t], 0), J - 1);  // never outside the group
      rows[t] = r;
    }
    const size_t off = ((size_t)r * Tp + t) * D + h * DW;
    float s = dot_head<DW>(k + off, qs);
    if (PE) s = (1.f - g) * s + g * dot_head<DW>(k_cs + off, qcs);
    p[t] = s;
    mx = fmaxf(mx, s);
  }
  mx = block_max<>(mx, red);

  float sum = 0.f;
  for (int t = tid; t < nk; t += THREADS) {
    const float e = expf(p[t] - mx);
    p[t] = e;
    sum += e;
  }
  sum = block_sum<>(sum, red);
  for (int t = tid; t < nk; t += THREADS) {
    const float w = p[t] / sum;
    p[t] = F32 ? w : __bfloat162float(__float2bfloat16(w));  // normalize, then bf16
  }
  __syncthreads();

  float2 acc = make_float2(0.f, 0.f);
  for (int t = warp; t < nk && 2 * lane < DW; t += WARPS) {
    const int r = ANC ? rows[t] : n;
    const float2 f = load_pair(v + ((size_t)r * Tp + t) * D + h * DW + 2 * lane);
    acc.x = fmaf(p[t], f.x, acc.x);
    acc.y = fmaf(p[t], f.y, acc.y);
  }
  if (2 * lane < DW) {
    part[warp][2 * lane] = acc.x;
    part[warp][2 * lane + 1] = acc.y;
  }
  __syncthreads();
  if (tid < DW) {
    float s = part[0][tid];
    for (int w = 1; w < WARPS; ++w) s += part[w][tid];
    if (QUANT) s *= v_scale[h * DW + tid];  // v's scale, after the sum
    put(o + (size_t)n * D + h * DW + tid, s);
  }
}

template <bool ANC, bool PE, typename KT, int DW = DH>
int launch_rows(const void* q, const void* k, const void* v, const void* anc,
                const void* q_cs, const void* k_cs, const void* gate, const void* ks,
                const void* vs, void* o, int N, int Tp, int H, int pos, int J,
                cudaStream_t stream) {
  dim3 grid(H, N);
  const size_t smem = (size_t)(pos + 1) * (sizeof(float) + (ANC ? sizeof(int) : 0));
  typedef typename Query<KT>::T QT;
  decode_attn_kernel<ANC, PE, KT, DW><<<grid, THREADS, smem, stream>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, (const int*)anc, (const bf16*)q_cs,
      (const bf16*)k_cs, (const float*)gate, (const float*)ks, (const float*)vs,
      (QT*)o, Tp, H, pos, J);
  return (int)cudaGetLastError();
}

// K3s (KT bf16) and K3s-int8 (KT int8, with k_scale / v_scale). q, o:
// (G*J, D) group-major (row g*J + i is group g's slot i); k, v: (G, Tp, D);
// J <= MAXJ. Dynamic shared memory: J x (pos + 1) scores, then SH_WARPS x
// J x DH partial outputs.
template <int MAXJ, typename KT>
__global__ void __launch_bounds__(SH_THREADS)
decode_attn_shared_kernel(const bf16* __restrict__ q, const KT* __restrict__ k,
                          const KT* __restrict__ v, const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale, bf16* __restrict__ o,
                          int Tp, int H, int pos, int J) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  extern __shared__ float p[];
  __shared__ float qs[MAXJ][DH];
  __shared__ float red[SH_WARPS];
  const int h = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = H * DH;
  const int nk = pos + 1;
  float* part = p + J * nk;
  const KT* kb = k + (size_t)g * Tp * D + h * DH;
  const KT* vb = v + (size_t)g * Tp * D + h * DH;

  for (int i = tid; i < J * DH; i += SH_THREADS)
    qs[i / DH][i % DH] = query_channel<KT>(
        q[((size_t)g * J + i / DH) * D + h * DH + i % DH], k_scale, h * DH + i % DH);
  __syncthreads();

  // Phase 1: key t's head slice is read once into registers and dotted
  // with each of the J queries (a loop the compiler keeps rolled, so the
  // queries stay in shared memory and out of registers).
  for (int t = tid; t < nk; t += SH_THREADS) {
    float kf[DH];
    load_head<DH>(kb + (size_t)t * D, kf);
#pragma unroll 1
    for (int i = 0; i < J; ++i) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < DH; ++c) s = fmaf(qs[i][c], kf[c], s);
      p[i * nk + t] = s;
    }
  }

  // Phase 2, per query: max, exp and sum, normalize, then bf16. Each
  // thread touches only the keys it scored, so phase 1 needs no barrier.
  for (int i = 0; i < J; ++i) {
    float* pi = p + i * nk;
    float mx = -INFINITY;
    for (int t = tid; t < nk; t += SH_THREADS) mx = fmaxf(mx, pi[t]);
    mx = block_max<SH_WARPS>(mx, red);
    float sum = 0.f;
    for (int t = tid; t < nk; t += SH_THREADS) {
      const float e = expf(pi[t] - mx);
      pi[t] = e;
      sum += e;
    }
    sum = block_sum<SH_WARPS>(sum, red);
    for (int t = tid; t < nk; t += SH_THREADS)
      pi[t] = __bfloat162float(__float2bfloat16(pi[t] / sum));
  }
  __syncthreads();

  // Phase 3: warp w takes keys w, w + SH_WARPS, ...; lane l the channel
  // pair (2l, 2l+1); each value row read once serves all J queries.
  float2 acc[MAXJ];
#pragma unroll
  for (int i = 0; i < MAXJ; ++i) acc[i] = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int t = warp; t < nk; t += SH_WARPS) {
    const float2 f = load_pair(vb + (size_t)t * D + 2 * lane);
#pragma unroll
    for (int i = 0; i < MAXJ; ++i) {
      if (i < J) {
        const float w = p[i * nk + t];
        acc[i].x = fmaf(w, f.x, acc[i].x);
        acc[i].y = fmaf(w, f.y, acc[i].y);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MAXJ; ++i) {
    if (i < J) {
      part[(warp * J + i) * DH + 2 * lane] = acc[i].x;
      part[(warp * J + i) * DH + 2 * lane + 1] = acc[i].y;
    }
  }
  __syncthreads();
  for (int i = tid; i < J * DH; i += SH_THREADS) {
    float s = part[i];
    for (int w = 1; w < SH_WARPS; ++w) s += part[w * J * DH + i];
    if (QUANT) s *= v_scale[h * DH + i % DH];
    o[((size_t)g * J + i / DH) * D + h * DH + i % DH] = __float2bfloat16(s);
  }
}

template <int MAXJ, typename KT>
int launch_shared(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, void* o, int G, int Tp, int H, int pos, int J,
                  cudaStream_t stream) {
  const int smem = J * (pos + 1 + SH_WARPS * DH) * (int)sizeof(float);
  // Set on every launch: the attribute is per device, and it is cheap.
  const cudaError_t attr = cudaFuncSetAttribute(
      decode_attn_shared_kernel<MAXJ, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(H, G);
  decode_attn_shared_kernel<MAXJ, KT><<<grid, SH_THREADS, smem, stream>>>(
      (const bf16*)q, (const KT*)k, (const KT*)v, (const float*)ks, (const float*)vs,
      (bf16*)o, Tp, H, pos, J);
  return (int)cudaGetLastError();
}

template <typename KT>
int dispatch_shared(const void* q, const void* k, const void* v, const void* ks,
                    const void* vs, void* o, int G, int Tp, int H, int pos, int J,
                    cudaStream_t s) {
  if (J <= 4) return launch_shared<4, KT>(q, k, v, ks, vs, o, G, Tp, H, pos, J, s);
  if (J <= 8) return launch_shared<8, KT>(q, k, v, ks, vs, o, G, Tp, H, pos, J, s);
  if (J <= 16) return launch_shared<16, KT>(q, k, v, ks, vs, o, G, Tp, H, pos, J, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3 and its per-row variants, chosen by which pointers are given:
//   anc     (N, Tp) int32, values in [0, J), N % J == 0   -> K3a
//   q_cs, k_cs, gate  bf16 (N, H*64), (N, Tp, H*64), f32 (H,) -> PE
//   k_scale, v_scale  f32 (H*64,); k, v then int8         -> int8
// q, o: (N, H*64) bf16; k, v: (N, Tp, H*64); all contiguous and 16-byte
// aligned; 0 <= pos < Tp. PE with int8 is refused. Shared memory: (pos + 1)
// floats (+ (pos + 1) ints for K3a) beside ~1.8 KB of static arrays, within
// the 48 KB default for pos + 1 <= 4096 (the wrapper's MAX_ANC_KEYS) and
// pos + 1 <= 8192 without a map (MAX_KEYS). Returns cudaGetLastError()
// after the launch.
extern "C" int decode_attn_fwd(const void* q, const void* k, const void* v,
                               const void* anc, const void* q_cs, const void* k_cs,
                               const void* gate, const void* k_scale,
                               const void* v_scale, void* o, int N, int Tp, int H,
                               int pos, int J, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool pe = q_cs != nullptr, quant = k_scale != nullptr;
#define ROWS(ANC, PE, KT)                                                          \
  launch_rows<ANC, PE, KT>(q, k, v, anc, q_cs, k_cs, gate, k_scale, v_scale, o, N, \
                           Tp, H, pos, J, s)
  if (pe && quant) return (int)cudaErrorInvalidValue;
  if (quant) return anc ? ROWS(true, false, int8_t) : ROWS(false, false, int8_t);
  if (pe) return anc ? ROWS(true, true, bf16) : ROWS(false, true, bf16);
  return anc ? ROWS(true, false, bf16) : ROWS(false, false, bf16);
#undef ROWS
}

// K3-f32: q, o (N, H*64) float32; k, v (N, Tp, H*64) float32; all
// contiguous and 16-byte aligned; 0 <= pos < Tp; (pos + 1) floats of
// shared memory, as K3. Returns cudaGetLastError() after the launch.
extern "C" int decode_attn_f32_fwd(const void* q, const void* k, const void* v, void* o,
                                   int N, int Tp, int H, int pos, void* stream) {
  return launch_rows<false, false, float>(q, k, v, nullptr, nullptr, nullptr, nullptr,
                                          nullptr, nullptr, o, N, Tp, H, pos, 1,
                                          (cudaStream_t)stream);
}

// K3 at d_head 48 (the side ladder's self- and cross-attention): plain
// bf16 rows, q, o (N, H*48), k, v (N, Tp, H*48); all contiguous and
// 16-byte aligned; 0 <= pos < Tp; (pos + 1) floats of shared memory, as
// K3. Returns cudaGetLastError() after the launch.
extern "C" int decode_attn_d48_fwd(const void* q, const void* k, const void* v, void* o,
                                   int N, int Tp, int H, int pos, void* stream) {
  return launch_rows<false, false, bf16, 48>(q, k, v, nullptr, nullptr, nullptr, nullptr,
                                             nullptr, nullptr, o, N, Tp, H, pos, 1,
                                             (cudaStream_t)stream);
}

// K3s (k_scale null: bf16 caches) and K3s-int8. q, o: (G*J, H*64) bf16
// group-major; k, v: (G, Tp, H*64) bf16 or int8 with f32 (H*64,) scales;
// all contiguous and 16-byte aligned; 0 <= pos < Tp; 1 <= J <= 16;
// J * (pos + 1 + 16 * 64) * 4 bytes of dynamic shared memory (the wrapper
// bounds it at 200 KB, which leaves room for the <= 4.2 KB static).
extern "C" int decode_attn_shared_fwd(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      void* o, int G, int Tp, int H, int pos, int J,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k_scale)
    return dispatch_shared<int8_t>(q, k, v, k_scale, v_scale, o, G, Tp, H, pos, J, s);
  return dispatch_shared<bf16>(q, k, v, nullptr, nullptr, o, G, Tp, H, pos, J, s);
}
