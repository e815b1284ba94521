// K3: decode-step cache attention, plain rows (sm_90a).
//
// Replaces the TPU kernel `_make_kernel` of agacs_tpu/ops/decode_attn.py
// (`decode_cache_attention` -> `_call`, with an identity ancestry map) and
// its time-chunked twin `_make_kernel_chunked`. Same math: one query token
// per row, q (pre-scaled by d_head^-0.5) . k over a head's 64 channels with
// bf16 inputs and float32 accumulation, float32 softmax over keys 0..pos,
// normalized BEFORE the bf16 cast of p, then the value sum with float32
// accumulation and a bf16 output.
//
// What bounds it here: HBM bytes. A call reads 2*N*(pos+1)*d*2 bytes of
// cache (self-attention) or 2*N*T_enc*d*2 (cross-attention: 18.4 MB at
// N=8, T_enc=750, d=768) and does 4 FLOPs per byte-pair, far below the
// card's ~295 FLOP/byte ridge. So the design reads each needed byte once:
// keys past pos are skipped, not loaded (their TPU weight exp(-1e30 - m)
// is exactly 0, so the result is unchanged), and the time loop runs inside
// the block, which covers any Tp and so also the TPU's VMEM-driven
// chunked variant.
//
// Design: one block of 4 warps per (head, row). Phase 1: one thread per
// key reads the key's 128-byte head slice with 16-byte loads and keeps
// the score in shared memory. Phase 2: block max and sum. Phase 3: warp w
// takes keys w, w+4, ...; lane l the channel pair (2l, 2l+1), so a warp
// reads one 128-byte row per key; the 4 partial sums meet in shared
// memory. One block per (head, row) gives only H*N blocks (96 at the
// greedy 8-row batch); a split over time is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < WARPS; ++w) x = fmaxf(x, red[w]);
  __syncthreads();
  return x;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < WARPS; ++w) x += red[w];
  __syncthreads();
  return x;
}

__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int Tp,
                   int H, int pos) {
  extern __shared__ float p[];  // pos + 1 scores, then weights
  __shared__ float qs[DH];
  __shared__ float red[WARPS];
  __shared__ float part[WARPS][DH];
  const int h = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = H * DH;
  const int nk = pos + 1;
  const bf16* kb = k + (size_t)n * Tp * D + (size_t)h * DH;
  const bf16* vb = v + (size_t)n * Tp * D + (size_t)h * DH;

  if (tid < DH) qs[tid] = __bfloat162float(q[(size_t)n * D + h * DH + tid]);
  __syncthreads();

  float mx = -INFINITY;
  for (int t = tid; t < nk; t += THREADS) {
    const uint4* kr = reinterpret_cast<const uint4*>(kb + (size_t)t * D);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const uint4 u = kr[i];
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(k2[j]);
        s = fmaf(qs[i * 8 + 2 * j], f.x, s);
        s = fmaf(qs[i * 8 + 2 * j + 1], f.y, s);
      }
    }
    p[t] = s;
    mx = fmaxf(mx, s);
  }
  mx = block_max(mx, red);

  float sum = 0.f;
  for (int t = tid; t < nk; t += THREADS) {
    const float e = expf(p[t] - mx);
    p[t] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int t = tid; t < nk; t += THREADS)
    p[t] = __bfloat162float(__float2bfloat16(p[t] / sum));  // normalize, then bf16
  __syncthreads();

  float2 acc = make_float2(0.f, 0.f);
  for (int t = warp; t < nk; t += WARPS) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(vb + (size_t)t * D + 2 * lane));
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

}  // namespace

// q, o: (N, H*64) bf16; k, v: (N, Tp, H*64) bf16; all contiguous and
// 16-byte aligned; 0 <= pos < Tp. Returns cudaGetLastError() after the
// launch.
extern "C" int decode_attn_fwd(const void* q, const void* k, const void* v,
                               void* o, int N, int Tp, int H, int pos,
                               void* stream) {
  dim3 grid(H, N);
  const size_t smem = (size_t)(pos + 1) * sizeof(float);
  decode_attn_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Tp, H, pos);
  return (int)cudaGetLastError();
}
