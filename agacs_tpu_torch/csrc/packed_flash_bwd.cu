// K1b: packed-layout non-causal multi-head attention, backward (sm_90a).
//
// Replaces the TPU kernels `_bwd_kernel` (T <= 1024) and `_bwd_kernel_qc`
// (q-chunked, T 1025-1536) of agacs_tpu/ops/flash_train.py
// (`packed_flash_mha`'s custom VJP -> `_bwd_pallas`): dq, dk and dv of the
// whisper encoder's self-attention. Same math: scores 0.125 q.k^T in f32;
// the softmax weights recomputed from q and k; D = rowsum(do * o);
// dv = p^T do; ds = p (dp - D) cast to bf16 before its products;
// dq = 0.125 ds k; dk = ds^T (0.125 q); f32 accumulation. (0.125 is a power
// of two: applying it to an f32 sum equals summing products of the exactly
// scaled bf16 values.)
//
// What bounds it here: at the training shape (B=16, T=750, 12 heads of
// 64) the least backward is 5 products of 2*B*H*T*T*64 = 13.8 GFLOP each
// (S, dP, dV, dQ, dK: 69 GFLOP, ~0.070 ms at the bf16 peak) against
// 5 x 18.4 MB of bf16 q/k/v/o/do read and 3 x 18.4 MB written (~0.044 ms):
// the tensor cores bound it.
//
// Design. The TPU kernel holds a head group's whole (T, T) f32 score block
// in VMEM and carries dk/dv in scratch across its sequential q-chunk grid
// axis. A Hopper SM has 227 KB of shared memory and its blocks run in no
// order, so the work is split the way an online-softmax backward has to
// be, with nothing carried between blocks and no atomics:
//   (a) row statistics: the forward kernel (packed_flash_fwd.cu) writes the
//       f32 log-sum-exp of every score row, lse (B, H, T), when it runs
//       under autograd; p = exp(0.125 s - lse) is then the normalized
//       weight;
//   (b) rowdot: D = rowsum(do * o) (B, H, T) f32, eight threads a (row,
//       head) with 16-byte loads;
//   (c) dkdv: one block per (128 keys, head, batch row); each of its two
//       consumer warpgroups owns 64 keys, holds their dk and dv in
//       accumulator registers, and loops over 64-row q tiles:
//       S^T = K Q^T and dP^T = V dO^T with keys as wgmma's M, so that the
//       accumulators of P^T and dS^T become the register A operands of
//       dV += P^T dO and dK += dS^T Q (q and do read MN-major);
//   (d) dq: one block per (128 q rows, head, batch row); each warpgroup
//       owns 64 rows and loops over 64-key tiles: S, dP, then dQ += dS K.
// (c) and (d) both recompute s and dp: 7 products where an atomic dq would
// need 5, the price of a result that is deterministic (bit-identical from
// run to run) without a dq scratch buffer; the kernels can reach at most
// 5/7 of the 5-product bound above.
// Both kernels follow packed_flash_fwd.cu's layout (shared pieces in
// hopper.cuh): a producer warp loads the block's own 128-row tiles once and
// streams the other operand pair through a 3-stage TMA ring guarded by
// mbarriers (in dkdv its lanes also stage each q tile's lse and D rows in
// shared memory, which keeps dkdv's registers under the cap of 168 that
// nine warps leave); every product is a wgmma with f32 accumulators in
// registers, and the elementwise math runs on those registers, with exp on
// ex2.approx.ftz. The two warpgroups take turns issuing their products
// (named barriers 1 and 2), so one warpgroup's elementwise math runs while
// the other's products use the tensor cores. Rows past T read as zeros
// (TMA); a q row past T gets p = 0 in (c) through an lse of +inf, a key
// past T gets p = 0 in (d) through its mask (without it exp(-lse) could
// overflow when every score of a row is very negative), and rows past T
// are never stored.

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 64;                 // head width
constexpr int BR = 128;                // rows a block owns (keys or q rows)
constexpr int BS = 64;                 // rows per streamed tile (q rows or keys)
constexpr int STAGES = 3;              // streamed ring depth
constexpr int THREADS = 2 * 128 + 32;  // two consumer warpgroups, a producer warp
constexpr float SCALE = 0.125f;        // 64^-0.5
constexpr float LOG2E = 1.4426950408889634f;
constexpr float C = SCALE * LOG2E;

struct Smem {
  alignas(1024) bf16 own0[BR * DH];          // dkdv: K;  dq: Q
  alignas(1024) bf16 own1[BR * DH];          // dkdv: V;  dq: dO
  alignas(1024) bf16 str0[STAGES][BS * DH];  // dkdv: Q;  dq: K
  alignas(1024) bf16 str1[STAGES][BS * DH];  // dkdv: dO; dq: V
  float lse[STAGES][BS];  // dkdv: the q tile's lse in log2 units, +inf past T
  float dd[STAGES][BS];   //       and its D, 0 past T
  uint64_t own_full, full[STAGES], empty[STAGES];
};

// The 1024-byte aligned shared storage, its barriers initialised.
__device__ __forceinline__ Smem& setup(unsigned char* raw) {
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                      ~uintptr_t(1023));
  if (threadIdx.x == 0) {
    hop::mbar_init(&sm.own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&sm.full[s], 32);  // the producer warp's lanes
      hop::mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  return sm;
}

// The producer warp: the block's own rows [r0, r0 + 128) of o0 and o1,
// then rows [64 it, 64 it + 64) of s0 and s1 for every streamed tile (lane
// 0 issues the copies), with the tile's lse and D rows when `rows` (every
// lane stores two of each and arrives, releasing its stores).
__device__ __forceinline__ void produce(Smem& sm, const CUtensorMap* o0,
                                        const CUtensorMap* o1, const CUtensorMap* s0,
                                        const CUtensorMap* s1, int r0, int n_tiles,
                                        const float* lse, const float* dd, int T) {
  const int lane = threadIdx.x & 31, c = blockIdx.y * DH, b = blockIdx.z;
  const size_t bh = ((size_t)b * gridDim.y + blockIdx.y) * T;
  if (lane == 0) {
    hop::mbar_expect_tx(&sm.own_full, 2 * BR * DH * 2);
    hop::tma_load(sm.own0, o0, &sm.own_full, c, r0, b);
    hop::tma_load(sm.own1, o1, &sm.own_full, c, r0, b);
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    hop::mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
    if (lse != nullptr) {
      for (int i = lane; i < BS; i += 32) {
        const int qi = it * BS + i;
        sm.lse[s][i] = qi < T ? lse[bh + qi] * LOG2E : INFINITY;
        sm.dd[s][i] = qi < T ? dd[bh + qi] : 0.f;
      }
    }
    if (lane == 0) {
      hop::mbar_expect_tx(&sm.full[s], 2 * BS * DH * 2);
      hop::tma_load(sm.str0[s], s0, &sm.full[s], c, it * BS, b);
      hop::tma_load(sm.str1[s], s1, &sm.full[s], c, it * BS, b);
    } else {
      hop::mbar_arrive(&sm.full[s]);
    }
  }
}

__device__ __forceinline__ float ds_of(float p, float dp, float d) {
  return p * (dp - d);
}

// Two 64 x 64 products into s and dp, issued and committed as one group:
// s = a0 b0^T, dp = a1 b1^T (all K-major).
__device__ __forceinline__ void issue_two(float (&s)[32], float (&dp)[32], uint64_t a0,
                                          uint64_t b0, uint64_t a1, uint64_t b1) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) hop::wgmma_ss_n64(s, a0 + 2 * kc, b0 + 2 * kc, kc);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) hop::wgmma_ss_n64(dp, a1 + 2 * kc, b1 + 2 * kc, kc);
  hop::wgmma_commit();
}

// acc += a (the 64 x 64 bf16 A fragments) b, b a 64-row tile read MN-major:
// issued, not committed.
__device__ __forceinline__ void issue_ab(float (&acc)[32], const uint32_t (&a)[16],
                                         const bf16* b) {
#pragma unroll
  for (int kc = 0; kc < BS / 16; ++kc)
    hop::wgmma_rs_n64_t(acc, &a[4 * kc], hop::desc(b, kc * 16 * 128));
}

// Store rows row0 and row0 + 8 (if < T) of a warp's accumulator, times scale.
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[32], int row0,
                                           int T, int D, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row < T) {
      bf16* out = dst + (size_t)row * D + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
    }
  }
}

// (b) D[b, h, t] = sum over the head's 64 columns of do * o, in f32: eight
// threads a (row, head), 16-byte loads.
__global__ void rowdot_kernel(const bf16* __restrict__ dout,
                              const bf16* __restrict__ o, float* __restrict__ dd,
                              int B, int T, int H) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t w = i >> 3;  // the (row, head): b * T * H + t * H + h
  const bool live = w < (size_t)B * T * H;
  float sum = 0.f;
  if (live) {
    const uint4 x = *reinterpret_cast<const uint4*>(dout + i * 8);
    const uint4 y = *reinterpret_cast<const uint4*>(o + i * 8);
    const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(xa[j]), c = __bfloat1622float2(ya[j]);
      sum += a.x * c.x + a.y * c.y;
    }
  }
#pragma unroll
  for (int m = 4; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (live && (i & 7) == 0) {
    const int h = (int)(w % H);
    const size_t bt = w / H;  // b * T + t
    const size_t b = bt / T, t = bt % T;
    dd[(b * H + h) * T + t] = sum;
  }
}

// (c) dk, dv of one (128 keys, head, batch row). Maps: q and do with
// 64-row boxes, k and v with 128-row boxes.
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
            const float* __restrict__ lse, const float* __restrict__ dd,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = setup(smem_raw);
  const int tid = threadIdx.x, k0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int n_q_tiles = (T + BS - 1) / BS;
  if (tid >= 256) {
    if (tid < 256 + 32) produce(sm, &mk, &mv, &mq, &mdo, k0, n_q_tiles, lse, dd, T);
    return;
  }

  // Two tensor-core issue slots a q tile (S^T and dP^T; dV and dK), each
  // behind named barrier 1 + wg and alternating with the other warpgroup,
  // so one warpgroup's elementwise math runs beside the other's products.
  const int wg = tid >> 7, lane = tid & 31, t = lane & 3;
  const uint64_t kd = hop::desc(sm.own0, wg * 64 * 128), vd = hop::desc(sm.own1, wg * 64 * 128);
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  hop::mbar_wait(&sm.own_full, 0);
  if (wg == 1) hop::bar_arrive(1, 256);  // warpgroup 0 issues first

  for (int it = 0; it < n_q_tiles; ++it) {
    const int s = it % STAGES;
    hop::mbar_wait(&sm.full[s], (it / STAGES) & 1);

    // S^T (64 keys x 64 q) = K Q^T and dP^T = V dO^T, unscaled
    float st[32], dpt[32];
    hop::bar_sync(1 + wg, 256);
    hop::wgmma_fence();
    issue_two(st, dpt, kd, hop::desc(sm.str0[s]), vd, hop::desc(sm.str1[s]));
    hop::bar_arrive(2 - wg, 256);
    hop::wgmma_wait();
    hop::fence_regs(st);
    hop::fence_regs(dpt);

    // P^T = exp(0.125 s - lse), dS^T = P^T (dP^T - D): bf16 A fragments
    uint32_t pa[16], dsa[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int c = 8 * (i >> 2) + 2 * t;  // the q column of st[i]
      const float2 lc = *reinterpret_cast<const float2*>(&sm.lse[s][c]);
      const float2 dc = *reinterpret_cast<const float2*>(&sm.dd[s][c]);
      const float p0 = hop::ex2(fmaf(st[i], C, -lc.x)), p1 = hop::ex2(fmaf(st[i + 1], C, -lc.y));
      pa[i >> 1] = hop::pack_bf16(p0, p1);
      dsa[i >> 1] = hop::pack_bf16(ds_of(p0, dpt[i], dc.x), ds_of(p1, dpt[i + 1], dc.y));
    }

    // dV += P^T dO, dK += dS^T Q (dO and Q read MN-major)
    hop::bar_sync(1 + wg, 256);
    hop::wgmma_fence();
    issue_ab(dv_acc, pa, sm.str1[s]);
    issue_ab(dk_acc, dsa, sm.str0[s]);
    hop::wgmma_commit();
    // warpgroup 1 leaves its last arrival out, so every barrier ends with
    // as many arrivals as waits
    if (wg == 0 || it + 1 < n_q_tiles) hop::bar_arrive(2 - wg, 256);
    hop::wgmma_wait();
    hop::fence_regs(dv_acc);
    hop::fence_regs(dk_acc);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&sm.empty[s]);
  }

  const int warp = (tid >> 5) & 3;
  const int D = H * DH, row0 = k0 + wg * 64 + warp * 16 + (lane >> 2);
  const size_t base = (size_t)b * T * D + (size_t)h * DH;
  store_rows(dk + base, dk_acc, row0, T, D, SCALE);
  store_rows(dv + base, dv_acc, row0, T, D, 1.f);
}

// (d) dq of one (128 q rows, head, batch row). Maps: q and do with 128-row
// boxes, k and v with 64-row boxes.
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
          const float* __restrict__ lse, const float* __restrict__ dd,
          bf16* __restrict__ dq, int T, int H) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = setup(smem_raw);
  const int tid = threadIdx.x, q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int n_k_tiles = (T + BS - 1) / BS;
  if (tid >= 256) {
    if (tid < 256 + 32) produce(sm, &mq, &mdo, &mk, &mv, q0, n_k_tiles, nullptr, nullptr, T);
    return;
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
  const int row0 = q0 + wg * 64 + warp * 16 + (lane >> 2);  // and row0 + 8
  const size_t bh = ((size_t)b * H + h) * T;
  const float lr0 = row0 < T ? lse[bh + row0] * LOG2E : 0.f;
  const float lr1 = row0 + 8 < T ? lse[bh + row0 + 8] * LOG2E : 0.f;
  const float dr0 = row0 < T ? dd[bh + row0] : 0.f;
  const float dr1 = row0 + 8 < T ? dd[bh + row0 + 8] : 0.f;
  const uint64_t qd = hop::desc(sm.own0, wg * 64 * 128), dod = hop::desc(sm.own1, wg * 64 * 128);
  // Two tensor-core issue slots a key tile (S and dP; dQ), as in dkdv.
  float dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
  hop::mbar_wait(&sm.own_full, 0);
  if (wg == 1) hop::bar_arrive(1, 256);  // warpgroup 0 issues first

  for (int it = 0; it < n_k_tiles; ++it) {
    const int s = it % STAGES, k0 = it * BS;
    hop::mbar_wait(&sm.full[s], (it / STAGES) & 1);

    // S (64 q x 64 keys) = Q K^T and dP = dO V^T, unscaled
    float sc[32], dp[32];
    hop::bar_sync(1 + wg, 256);
    hop::wgmma_fence();
    issue_two(sc, dp, qd, hop::desc(sm.str0[s]), dod, hop::desc(sm.str1[s]));
    hop::bar_arrive(2 - wg, 256);
    hop::wgmma_wait();
    hop::fence_regs(sc);
    hop::fence_regs(dp);

    if (k0 + BS > T) {  // the key tail: p = 0 past T
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= T) sc[i] = -INFINITY;
    }
    // dS = P (dP - D), P = exp(0.125 s - lse): bf16 A fragments
    uint32_t dsa[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float lr = (i & 2) ? lr1 : lr0, dr = (i & 2) ? dr1 : dr0;
      const float p0 = hop::ex2(fmaf(sc[i], C, -lr)), p1 = hop::ex2(fmaf(sc[i + 1], C, -lr));
      dsa[i >> 1] = hop::pack_bf16(ds_of(p0, dp[i], dr), ds_of(p1, dp[i + 1], dr));
    }

    // dQ += dS K (K read MN-major)
    hop::bar_sync(1 + wg, 256);
    hop::wgmma_fence();
    issue_ab(dq_acc, dsa, sm.str0[s]);
    hop::wgmma_commit();
    // warpgroup 1 leaves its last arrival out, so every barrier ends with
    // as many arrivals as waits
    if (wg == 0 || it + 1 < n_k_tiles) hop::bar_arrive(2 - wg, 256);
    hop::wgmma_wait();
    hop::fence_regs(dq_acc);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&sm.empty[s]);
  }

  const int D = H * DH;
  store_rows(dq + (size_t)b * T * D + (size_t)h * DH, dq_acc, row0, T, D, SCALE);
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (B, T, H*64) bf16, contiguous, 16-byte
// aligned; lse: (B, H, T) f32 from packed_flash_fwd; dd: (B, H, T) f32
// scratch. Launches (b), (c), (d) on `stream`; returns the first
// cudaGetLastError() that is not cudaSuccess, a negative code if a tensor
// map could not be encoded, or cudaSuccess.
extern "C" int packed_flash_bwd(const void* q, const void* k, const void* v,
                                const void* o, const void* dout, const void* lse,
                                void* dd, void* dq, void* dk, void* dv, int B,
                                int T, int H, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  // _own: the 128-row boxes a block keeps; _str: the 64-row streamed boxes
  CUtensorMap q_own, do_own, k_own, v_own, q_str, do_str, k_str, v_str;
  int rc;
  if ((rc = hop_host::encode(&q_own, q, B, T, H, BR)) ||
      (rc = hop_host::encode(&do_own, dout, B, T, H, BR)) ||
      (rc = hop_host::encode(&k_own, k, B, T, H, BR)) ||
      (rc = hop_host::encode(&v_own, v, B, T, H, BR)) ||
      (rc = hop_host::encode(&q_str, q, B, T, H, BS)) ||
      (rc = hop_host::encode(&do_str, dout, B, T, H, BS)) ||
      (rc = hop_host::encode(&k_str, k, B, T, H, BS)) ||
      (rc = hop_host::encode(&v_str, v, B, T, H, BS)))
    return rc;
  const int smem = (int)sizeof(Smem) + 1024;  // + the 1024-byte alignment
  // Set on every launch: the attribute is per device, and it is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;

  const size_t threads = (size_t)B * T * H * 8;
  rowdot_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      (const bf16*)dout, (const bf16*)o, (float*)dd, B, T, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  dim3 grid((T + BR - 1) / BR, H, B);
  dkdv_kernel<<<grid, THREADS, smem, st>>>(q_str, k_own, v_own, do_str, (const float*)lse,
                                           (const float*)dd, (bf16*)dk, (bf16*)dv, T, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  dq_kernel<<<grid, THREADS, smem, st>>>(q_own, k_str, v_str, do_own, (const float*)lse,
                                         (const float*)dd, (bf16*)dq, T, H);
  return (int)cudaGetLastError();
}
