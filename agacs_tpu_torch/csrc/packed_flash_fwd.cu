// K1f: packed-layout non-causal multi-head attention, forward (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of agacs_tpu/ops/flash_train.py
// (`packed_flash_mha` -> `_fwd_pallas`), the whisper encoder's
// self-attention. Same math: scores 0.125 q.k^T in float32 (0.125 is a
// power of two, so scaling the f32 sum equals summing the products of
// the exactly scaled bf16 q), max-subtracted exp, the UN-normalized p cast
// to bf16 for the value product with float32 accumulation, division by the
// row sum at the end.
//
// What bounds it here: at the training shape (B=16, T=750, 12 heads of 64)
// a call is 2*2*B*H*T*T*64 = 27.6 GFLOP against 4*B*T*768*2 = 74 MB of
// q/k/v/o: the tensor cores bound it (~0.028 ms at the bf16 peak, against
// ~0.022 ms for the bytes). The TPU kernel kept a head group's whole (T, T)
// score block in VMEM; a Hopper SM has 227 KB of shared memory, so this
// kernel streams key tiles with an online softmax (running f32 max m and
// sum l per row). That reorders the f32 sums relative to the TPU's
// whole-row softmax, which with the bf16 cast of p is why it is compared
// with its plain version under a tolerance.
//
// Design (the shared pieces are in hopper.cuh): one block per (128 q rows,
// head, batch row) with two consumer warpgroups, each owning 64 q rows, and
// one producer warp. The producer loads the q tile once and then 128-key k
// and v tiles through a 2-stage ring with TMA (3D tensor maps over the
// packed (B, T, H*64) layout, box (64, 128, 1) at column h*64, 128-byte
// swizzle), each stage guarded by a full and an empty mbarrier, so the next
// tile is in flight while the tensor cores work on this one. S = q k^T is
// wgmma m64n128k16 with both operands in shared memory and the scores stay
// in the accumulator registers: the row max and sum run there, the four
// lanes of a row reducing with shuffles, and exp is ex2.approx.ftz with
// 0.125 log2(e) folded in. p is packed to bf16 in registers and is the
// register A operand of the P.V wgmma (m64n64k16, v read MN-major). Keys
// past T (TMA fills them with zeros, which would score 0) get -inf before
// the max; rows past T are never stored.
//
// What holds it below the bound: a warp's 64 exponentials a tile take the
// special-function unit (16 a clock per SM) about as long as the tile's
// two products take the tensor cores, and each warpgroup runs its softmax
// between its own products; the two warpgroups overlap only as the
// scheduler interleaves them.
//
// Under autograd the kernel also writes each row's f32 log-sum-exp in
// natural-log units, lse = 0.125 m + log(l), to a (B, H, T) buffer: the row
// statistics that the backward kernels (packed_flash_bwd.cu) recompute p
// from. The serving path passes a null pointer and writes nothing extra.

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 64;                 // head width
constexpr int BQ = 128;                // q rows per block, 64 per warpgroup
constexpr int BK = 128;                // keys per tile
constexpr int STAGES = 2;              // k/v ring depth
constexpr int THREADS = 2 * 128 + 32;  // two consumer warpgroups, a producer warp
constexpr int TILE = 128 * DH * 2;     // bytes of a 128-row tile
constexpr float SCALE = 0.125f;        // 64^-0.5
constexpr float C = SCALE * 1.4426950408889634f;  // scale * log2(e)

struct Smem {
  alignas(1024) bf16 q[BQ * DH];
  alignas(1024) bf16 k[STAGES][BK * DH];
  alignas(1024) bf16 v[STAGES][BK * DH];
  uint64_t q_full, full[STAGES], empty[STAGES];
};

__global__ void __launch_bounds__(THREADS, 1)
packed_flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                        float* __restrict__ lse, int T, int H) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (T + BK - 1) / BK;
  if (tid == 0) {
    hop::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&sm.full[s], 1);
      hop::mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp: one lane issues every load
    if (tid == 256) {
      hop::mbar_expect_tx(&sm.q_full, TILE);
      hop::tma_load(sm.q, &mq, &sm.q_full, h * DH, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        hop::mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&sm.full[s], 2 * TILE);
        hop::tma_load(sm.k[s], &mk, &sm.full[s], h * DH, it * BK, b);
        hop::tma_load(sm.v[s], &mv, &sm.full[s], h * DH, it * BK, b);
      }
    }
    return;
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
  const uint64_t qd = hop::desc(sm.q, wg * 64 * 128);  // this warpgroup's 64 rows
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  // rows g and g + 8 of the warp's 16 (see hopper.cuh's accumulator layout):
  // running max of the unscaled scores and this lane's share of the sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  hop::mbar_wait(&sm.q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, k0 = it * BK;
    hop::mbar_wait(&sm.full[s], (it / STAGES) & 1);

    // S (64 x 128) = q k^T, unscaled
    float sc[64];
    hop::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      hop::wgmma_ss_n128(sc, qd + 2 * kc, hop::desc(sm.k[s]) + 2 * kc, kc);
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(sc);

    if (k0 + BK > T) {  // the key tail: zero-filled keys must not score 0
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= T) sc[i] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, sc[i]);
      else mx0 = fmaxf(mx0, sc[i]);
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // finite: key 0 is in the first tile. The rescale is 0 on that tile.
    const float a0 = hop::ex2((m0 - mx0) * C), a1 = hop::ex2((m1 - mx1) * C);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= (i & 2) ? a1 : a0;

    // p = exp(0.125 (s - m)) into the bf16 A fragments of P.V
    const float mc0 = m0 * C, mc1 = m1 * C;
    uint32_t pa[32];
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const float mc = (i & 2) ? mc1 : mc0;
      const float p0 = hop::ex2(fmaf(sc[i], C, -mc)), p1 = hop::ex2(fmaf(sc[i + 1], C, -mc));
      if (i & 2) l1 += p0 + p1;
      else l0 += p0 + p1;
      pa[i >> 1] = hop::pack_bf16(p0, p1);
    }

    // acc (64 x 64) += p (bf16) v
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hop::wgmma_rs_n64_t(acc, &pa[4 * kk], hop::desc(sm.v[s], kk * 16 * 128));
    hop::wgmma_commit();
    hop::wgmma_wait();
    hop::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const int D = H * DH;
  const size_t base = (size_t)b * T * D + (size_t)h * DH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * half;
    const float l = half ? l1 : l0;
    if (row < T) {
      bf16* dst = o + base + (size_t)row * D + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2 * half] / l, acc[4 * j + 2 * half + 1] / l);
      if (lse != nullptr && t == 0)
        lse[((size_t)b * H + h) * T + row] = (half ? m1 : m0) * SCALE + logf(l);
    }
  }
}

}  // namespace

// q, k, v, o: (B, T, H*64) bf16, contiguous, 16-byte aligned; lse: null,
// or (B, H, T) f32. Returns cudaGetLastError() after the launch, or a
// negative code if a tensor map could not be encoded.
extern "C" int packed_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int T, int H,
                                void* stream) {
  CUtensorMap mq, mk, mv;
  int rc;
  if ((rc = hop_host::encode(&mq, q, B, T, H, BQ)) ||
      (rc = hop_host::encode(&mk, k, B, T, H, BK)) ||
      (rc = hop_host::encode(&mv, v, B, T, H, BK)))
    return rc;
  const int smem = (int)sizeof(Smem) + 1024;  // + the 1024-byte alignment
  // Set on every launch: the attribute is per device, and it is cheap.
  const cudaError_t attr = cudaFuncSetAttribute(
      packed_flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  packed_flash_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      mq, mk, mv, (bf16*)o, (float*)lse, T, H);
  return (int)cudaGetLastError();
}
