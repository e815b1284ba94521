// Shared pieces of the two thin-row int8-weight products (sm_90a): K6
// (w8a16.cu, bf16 x times the int8 weight dequantised) and K8g's thin form
// (int8_gemm.cu, int8 rows times the int8 weight, at most 64 rows).
//
// Both are bound by the int8 weight's bytes (a decode step's 8 rows do 16
// operations per weight byte, the card's ridge is ~295), and both share one
// design:
//   * the swapped product: the weight tile is the mma's A (16 output
//     columns as its rows) and the activation rows are B (n = 8 a tile),
//     so 8 rows fill an mma instead of half of an m16 tile;
//   * a warp owns 32 output columns; thread (g, t) reads 4-byte words of
//     the row-major weight at columns 4g..4g+3, and those four columns are
//     rows g and g + 8 of the warp's two m16 tiles (tile i: rows g and g + 8
//     are columns 4g + 2i and 4g + 2i + 1). The k order inside an mma step
//     is permuted (the same permutation for A and B) so that each thread
//     reads whole consecutive weight rows and one 8-byte activation piece;
//   * a ring of STAGES shared-memory slots filled by cp.async (STAGES - 1
//     copies in flight while one slot is consumed), each slot one k-stage
//     of the weight tile and the activation rows beside it;
//   * a block of 4 warps takes 32 or 128 columns (BN); at 32, the warps
//     split each stage's four mma k-steps between them; K is split over the
//     S blocks of a thread-block cluster (`cudaLaunchKernelEx`, cluster
//     (1, S, 1), S <= 8), whose partials meet in rank 0's shared memory and
//     are added there in rank order, so a call is one launch and its result
//     does not depend on timing.
// The tiling (BN, S) is chosen by the Python wrappers from (M, N, K) alone
// (`int8_serve.thin_tiling`), so every decode step launches one grid.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace thin {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;      // 4 warps
constexpr int STAGES = 4;         // ring slots
constexpr int STEPS = 4;          // mma k-steps a stage
constexpr int A_ROW = 128;        // bytes of an activation row a stage
constexpr int A_LD = 160;         // ... padded: 8-byte B loads without bank conflicts
constexpr int MAX_SPLITS = 8;     // blocks of a cluster: the portable size
constexpr int MAX_NT = 8;         // n8 tiles of activation rows a block (64 rows)
constexpr int MAX_DEVICES = 64;

// Byte offset of weight row r inside a stage's tile of BN columns: after
// every G rows a 32-byte pad, so the rows that the four t lanes of a warp
// read together (G apart) start in four different 8-bank groups.
template <int BN, int G>
__device__ __forceinline__ int wrow(int r) {
  return r * BN + (r / G) * 32;
}

// One 16-byte copy from global to shared memory through L2; zero-filled
// (nothing read) when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's newest groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint2 ld64(const unsigned char* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// Copy one ring stage: rows [k0, k0 + KR) of the weight w (K, N) at
// columns [n0, n0 + BN) into `tile` (layout `wrow`), and the same stage of
// the block's `rows` activation rows (A_ROW bytes each, row stride a_ld
// bytes, `a_end` valid bytes a row) into `act` (stride A_LD). What lies
// past K or N is zero-filled; the slots of rows past `rows` are left as
// they are: they meet only output rows that are never written.
template <int BN, int KR, int G, int NT>
__device__ __forceinline__ void fetch_stage(unsigned char* tile, unsigned char* act,
                                            const int8_t* w, int K, int N, int k0, int n0,
                                            const unsigned char* a, size_t a_ld, int rows,
                                            size_t a_k0, size_t a_end, int tid) {
  constexpr int CH = BN / 16;
  for (int i = tid; i < KR * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 16;
    const bool full = k0 + r < K && n0 + c < N;
    cp_async16(tile + wrow<BN, G>(r) + c,
               full ? w + (size_t)(k0 + r) * N + n0 + c : w, full);
  }
  for (int i = tid; i < min(rows, 8 * NT) * (A_ROW / 16); i += THREADS) {
    const int r = i / (A_ROW / 16), c = (i % (A_ROW / 16)) * 16;
    const bool full = a_k0 + c < a_end;
    cp_async16(act + r * A_LD + c, full ? a + r * a_ld + a_k0 + c : a, full);
  }
}

// The cluster's barriers (decode_attn.cu's pattern): every block arrives
// (relaxed) at its start and waits before its first store into rank 0's
// shared memory, so that store never finds a block that has not started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  typedef float4 type;
  static __device__ __forceinline__ float4 make(float a, float b, float c, float d) {
    return make_float4(a, b, c, d);
  }
};
template <>
struct Vec4<int> {
  typedef int4 type;
  static __device__ __forceinline__ int4 make(int a, int b, int c, int d) {
    return make_int4(a, b, c, d);
  }
};

template <typename V>
__device__ __forceinline__ void add4(V& a, const V& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// After the main loop, with the ring free. A warp's accumulators (tile i
// rows g, g + 8: columns 4g + 2i, 4g + 2i + 1 of its 32; n8 tile j, lane
// t: activation rows 8j + 2t, 8j + 2t + 1) go to red[wk]; the WK warps of a
// column group are added in warp order. S == 1: put(row, col, v4) for the
// block's first `rows` rows, four columns at a time. S > 1: each rank
// pushes those sums into rank 0's recv[rank]; rank 0 adds the S of them in
// rank order and puts them.
template <int BN, int NT, typename T, typename Put>
__device__ __forceinline__ void reduce_put(const T (&acc)[2][NT][4], T* red, T* recv,
                                           int wn, int wk, int rows, int S, int rank,
                                           Put put) {
  typedef typename Vec4<T>::type V;
  constexpr int WK = THREADS / BN, E4 = 8 * NT * BN / 4, C4 = BN / 4;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  V* red4 = reinterpret_cast<V*>(red);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    V* p = red4 + wk * E4 + (8 * j + 2 * t) * C4 + wn * 8 + g;
    p[0] = Vec4<T>::make(acc[0][j][0], acc[0][j][2], acc[1][j][0], acc[1][j][2]);
    p[C4] = Vec4<T>::make(acc[0][j][1], acc[0][j][3], acc[1][j][1], acc[1][j][3]);
  }
  __syncthreads();
  const int n4 = min(rows, 8 * NT) * C4;  // the rows that exist
  auto block_sum = [&](int e) {
    V v = red4[e];
#pragma unroll
    for (int w = 1; w < WK; ++w) add4(v, red4[w * E4 + e]);
    return v;
  };
  if (S == 1) {
    for (int e = tid; e < n4; e += THREADS) put(e / C4, 4 * (e % C4), block_sum(e));
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();
  V* dst = reinterpret_cast<V*>(cluster.map_shared_rank(recv, 0)) + rank * E4;
  for (int e = tid; e < n4; e += THREADS) dst[e] = block_sum(e);
  cluster.sync();
  if (rank == 0) {
    const V* recv4 = reinterpret_cast<const V*>(recv);
    for (int e = tid; e < n4; e += THREADS) {
      V v = recv4[e];
      for (int r = 1; r < S; ++r) add4(v, recv4[r * E4 + e]);
      put(e / C4, 4 * (e % C4), v);
    }
  }
}

// Launch `kern` with K's n_stages split over S ranks of per = ceil(n_stages
// / S) stages (a split with an empty rank is refused; S 1 only at BN 128),
// on grid (tiles, S, z) in clusters of (1, S, 1), per appended as the
// kernel's last argument. Dynamic shared memory: the ring (STAGES slots of
// SB bytes) and, for S > 1, rank 0's S partials of 8 NT x BN accumulators
// of type Acc. The kernel is opted into the most any S of its instance
// takes once per device (`opted`, the kernel's own record). Returns
// cudaGetLastError() after the launch.
template <int BN, int NT, int SB, typename Acc, typename... KArgs, typename... Args>
int launch_split(void (*kern)(KArgs...), bool* opted, int n_stages, int S, int tiles, int z,
                 cudaStream_t stream, Args... args) {
  if (S < 1 || S > MAX_SPLITS || (BN != 32 && S != 1)) return (int)cudaErrorInvalidValue;
  const int per = (n_stages + S - 1) / S;
  if ((S - 1) * per >= n_stages) return (int)cudaErrorInvalidValue;
  constexpr size_t ring = (size_t)STAGES * SB, part = (size_t)8 * NT * BN * sizeof(Acc);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !opted[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(ring + (BN == 32 ? MAX_SPLITS * part : 0)));
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) opted[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, S, z);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = ring + (S > 1 ? S * part : 0);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = S;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args..., per);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace thin
