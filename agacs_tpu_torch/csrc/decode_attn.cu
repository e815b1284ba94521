// K3, K3a and K3s: decode-step cache attention (sm_90a).
//
// Replaces the TPU kernels of agacs_tpu/ops/decode_attn.py:
//   K3   `_make_kernel` (`decode_cache_attention` -> `_call`) with an
//        identity ancestry map, and its time-chunked twin
//        `_make_kernel_chunked`: plain rows;
//   K3a  the same `_make_kernel` / `_make_kernel_chunked` with an ancestry
//        map over beam groups of j rows: query row n of group g = n / j reads
//        position t from the physical cache row g*j + anc_local[n, t];
//   K3s  `_make_kernel_shared` (`decode_shared_cache_attention` ->
//        `_call_shared`): the j beam queries of group g over ONE shared
//        (Tp, d) cache, the utterance's cross-attention K/V.
// Same math in all three: one query token per row, q (pre-scaled by
// d_head^-0.5) . k over a head's 64 channels with bf16 inputs and float32
// accumulation, float32 softmax over keys 0..pos, normalized BEFORE the
// bf16 cast of p, then the value sum with float32 accumulation and a bf16
// output.
//
// What bounds them here: HBM bytes. A call reads 2*N*(pos+1)*d*2 bytes of
// cache (K3 / K3a self-attention; K3a reads the same bytes as plain rows,
// only from other rows of the group) or 2*G*T_enc*d*2 (K3s: 18.4 MB at
// G=8, T_enc=750, d=768, where the per-row layout of 40 beam rows would
// read 92 MB), and does 4 FLOPs per byte-pair (K3s: 4*j), far below the
// card's ~295 FLOP/byte ridge. So the design reads each needed byte once:
// keys past pos are skipped, not loaded (their TPU weight exp(-1e30 - m)
// is exactly 0, so the result is unchanged), and the time loop runs inside
// the block, which covers any Tp and so also the TPU's VMEM-driven
// chunked variant.
//
// The TPU kernels resolve the ancestry map and the group's queries with
// one-hot and block-diagonal matrix products because Mosaic cannot gather
// (decode_attn.py:16-33); a Hopper thread reads any row, so none of that
// is carried over.
//
// K3 / K3a: one block of 4 warps per (head, row). Phase 1: one thread per
// key reads (K3a: first the key's physical row, kept in shared memory for
// phase 3) the key's 128-byte head slice with 16-byte loads and keeps the
// score in shared memory. Phase 2: block max and sum. Phase 3: warp w takes
// keys w, w+4, ...; lane l the channel pair (2l, 2l+1), so a warp reads one
// 128-byte row per key; the 4 partial sums meet in shared memory. Shared
// memory: pos+1 floats (K3), plus pos+1 ints (K3a). One block per (head,
// row) gives H*N blocks (96 at the greedy 8-row batch, 480 at 8 x beam 5).
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

typedef __nv_bfloat16 bf16;

namespace {

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

// q . k over one head's 64 channels: k read as eight 16-byte loads.
__device__ __forceinline__ float dot_head(const bf16* __restrict__ kp,
                                          const float* qs) {
  const uint4* kr = reinterpret_cast<const uint4*>(kp);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    const uint4 u = kr[i];
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 f = __bfloat1622float2(k2[c]);
      s = fmaf(qs[i * 8 + 2 * c], f.x, s);
      s = fmaf(qs[i * 8 + 2 * c + 1], f.y, s);
    }
  }
  return s;
}

// K3 (ANC false) and K3a (ANC true). anc: (N, Tp) int32 local rows in
// [0, J) (clamped into it); row n of group n / J reads position t from
// row (n / J) * J + anc[n, t].
template <bool ANC>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ anc,
                   bf16* __restrict__ o, int Tp, int H, int pos, int J) {
  extern __shared__ float p[];  // pos + 1 scores, then weights; K3a: then pos + 1 rows
  __shared__ float qs[DH];
  __shared__ float red[WARPS];
  __shared__ float part[WARPS][DH];
  const int h = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = H * DH;
  const int nk = pos + 1;
  int* rows = reinterpret_cast<int*>(p + nk);
  const int* an = ANC ? anc + (size_t)n * Tp : nullptr;
  const int base = ANC ? (n / J) * J : n;

  if (tid < DH) qs[tid] = __bfloat162float(q[(size_t)n * D + h * DH + tid]);
  __syncthreads();

  float mx = -INFINITY;
  for (int t = tid; t < nk; t += THREADS) {
    int r = n;
    if (ANC) {
      r = base + min(max(an[t], 0), J - 1);  // never outside the group
      rows[t] = r;
    }
    const float s = dot_head(k + ((size_t)r * Tp + t) * D + h * DH, qs);
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
  for (int t = tid; t < nk; t += THREADS)
    p[t] = __bfloat162float(__float2bfloat16(p[t] / sum));  // normalize, then bf16
  __syncthreads();

  float2 acc = make_float2(0.f, 0.f);
  for (int t = warp; t < nk; t += WARPS) {
    const int r = ANC ? rows[t] : n;
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        v + ((size_t)r * Tp + t) * D + h * DH + 2 * lane));
    acc.x = fmaf(p[t], f.x, acc.x);
    acc.y = fmaf(p[t], f.y, acc.y);
  }
  part[warp][2 * lane] = acc.x;
  part[warp][2 * lane + 1] = acc.y;
  __syncthreads();
  if (tid < DH) {
    float s = part[0][tid];
    for (int w = 1; w < WARPS; ++w) s += part[w][tid];
    o[(size_t)n * D + h * DH + tid] = __float2bfloat16(s);
  }
}

// K3s. q, o: (G*J, D) group-major (row g*J + i is group g's slot i);
// k, v: (G, Tp, D); J <= MAXJ. Dynamic shared memory: J x (pos + 1)
// scores, then SH_WARPS x J x DH partial outputs.
template <int MAXJ>
__global__ void __launch_bounds__(SH_THREADS)
decode_attn_shared_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          int Tp, int H, int pos, int J) {
  extern __shared__ float p[];
  __shared__ float qs[MAXJ][DH];
  __shared__ float red[SH_WARPS];
  const int h = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = H * DH;
  const int nk = pos + 1;
  float* part = p + J * nk;
  const bf16* kb = k + (size_t)g * Tp * D + h * DH;
  const bf16* vb = v + (size_t)g * Tp * D + h * DH;

  for (int i = tid; i < J * DH; i += SH_THREADS)
    qs[i / DH][i % DH] =
        __bfloat162float(q[((size_t)g * J + i / DH) * D + h * DH + i % DH]);
  __syncthreads();

  // Phase 1: key t's head slice is read once into registers and dotted
  // with each of the J queries (a loop the compiler keeps rolled, so the
  // queries stay in shared memory and out of registers).
  for (int t = tid; t < nk; t += SH_THREADS) {
    const uint4* kr = reinterpret_cast<const uint4*>(kb + (size_t)t * D);
    float kf[DH];
#pragma unroll
    for (int c8 = 0; c8 < DH / 8; ++c8) {
      const uint4 u = kr[c8];
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 f = __bfloat1622float2(k2[c]);
        kf[c8 * 8 + 2 * c] = f.x;
        kf[c8 * 8 + 2 * c + 1] = f.y;
      }
    }
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
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(vb + (size_t)t * D + 2 * lane));
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
    o[((size_t)g * J + i / DH) * D + h * DH + i % DH] = __float2bfloat16(s);
  }
}

template <int MAXJ>
int launch_shared(const void* q, const void* k, const void* v, void* o, int G,
                  int Tp, int H, int pos, int J, cudaStream_t stream) {
  const int smem = J * (pos + 1 + SH_WARPS * DH) * (int)sizeof(float);
  // Set on every launch: the attribute is per device, and it is cheap.
  const cudaError_t attr = cudaFuncSetAttribute(
      decode_attn_shared_kernel<MAXJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(H, G);
  decode_attn_shared_kernel<MAXJ><<<grid, SH_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Tp, H, pos, J);
  return (int)cudaGetLastError();
}

}  // namespace

// K3. q, o: (N, H*64) bf16; k, v: (N, Tp, H*64) bf16; all contiguous and
// 16-byte aligned; 0 <= pos < Tp. Returns cudaGetLastError() after the
// launch.
extern "C" int decode_attn_fwd(const void* q, const void* k, const void* v,
                               void* o, int N, int Tp, int H, int pos,
                               void* stream) {
  dim3 grid(H, N);
  const size_t smem = (size_t)(pos + 1) * sizeof(float);
  decode_attn_kernel<false><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, nullptr, (bf16*)o, Tp, H,
      pos, 1);
  return (int)cudaGetLastError();
}

// K3a. As K3, plus anc: (N, Tp) int32, values in [0, J); N % J == 0.
// Shared memory: (pos + 1) floats + (pos + 1) ints beside ~1.3 KB of
// static arrays, within the 48 KB default for pos + 1 <= 4096 (the
// wrapper's bound, MAX_ANC_KEYS).
extern "C" int decode_attn_anc_fwd(const void* q, const void* k, const void* v,
                                   const void* anc, void* o, int N, int Tp, int H,
                                   int pos, int J, void* stream) {
  dim3 grid(H, N);
  const size_t smem = (size_t)(pos + 1) * (sizeof(float) + sizeof(int));
  decode_attn_kernel<true><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)anc, (bf16*)o,
      Tp, H, pos, J);
  return (int)cudaGetLastError();
}

// K3s. q, o: (G*J, H*64) bf16 group-major; k, v: (G, Tp, H*64) bf16; all
// contiguous and 16-byte aligned; 0 <= pos < Tp; 1 <= J <= 16;
// J * (pos + 1 + 16 * 64) * 4 bytes of dynamic shared memory (the wrapper
// bounds it at 200 KB, which leaves room for the <= 4.2 KB static).
extern "C" int decode_attn_shared_fwd(const void* q, const void* k, const void* v,
                                      void* o, int G, int Tp, int H, int pos,
                                      int J, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (J <= 4) return launch_shared<4>(q, k, v, o, G, Tp, H, pos, J, s);
  if (J <= 8) return launch_shared<8>(q, k, v, o, G, Tp, H, pos, J, s);
  if (J <= 16) return launch_shared<16>(q, k, v, o, G, Tp, H, pos, J, s);
  return (int)cudaErrorInvalidValue;
}
