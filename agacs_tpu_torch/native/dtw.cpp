// Dynamic time warping for word-level timing alignment — the native
// replacement for the reference's Triton DTW kernel
// (whisper/triton_ops.py:13-40 / timing.py:83-106 dtw_cpu).
//
// Monotonic alignment over a (N text, M audio) cost matrix: standard
// three-way DP with traceback. Returns the alignment path.
//
// Build: g++ -O3 -shared -fPIC -o _dtw.so dtw.cpp

#include <cstdint>
#include <vector>

extern "C" {

// x: (N, M) row-major costs. path_i/path_j must hold N+M entries.
// Returns path length, or -1 on error.
long long dtw_path(const float* x, long long n, long long m,
                   int32_t* path_i, int32_t* path_j) {
  if (n <= 0 || m <= 0) return -1;
  const float INF = 1e30f;
  std::vector<float> cost((n + 1) * (m + 1), INF);
  std::vector<int8_t> trace((n + 1) * (m + 1), -1);
  auto C = [&](long long i, long long j) -> float& {
    return cost[i * (m + 1) + j];
  };
  auto T = [&](long long i, long long j) -> int8_t& {
    return trace[i * (m + 1) + j];
  };
  C(0, 0) = 0.0f;
  for (long long j = 1; j <= m; j++) {
    for (long long i = 1; i <= n; i++) {
      float c0 = C(i - 1, j - 1);
      float c1 = C(i - 1, j);
      float c2 = C(i, j - 1);
      float c;
      int8_t t;
      if (c0 < c1 && c0 < c2) { c = c0; t = 0; }
      else if (c1 < c0 && c1 < c2) { c = c1; t = 1; }
      else { c = c2; t = 2; }
      C(i, j) = x[(i - 1) * m + (j - 1)] + c;
      T(i, j) = t;
    }
  }
  // backtrace (timing.py:58-80): borders forced to single-axis moves
  for (long long j = 0; j <= m; j++) T(0, j) = 2;
  for (long long i = 0; i <= n; i++) T(i, 0) = 1;
  long long i = n, j = m, len = 0;
  std::vector<int32_t> ri, rj;
  ri.reserve(n + m);
  rj.reserve(n + m);
  while (i > 0 || j > 0) {
    ri.push_back((int32_t)(i - 1));
    rj.push_back((int32_t)(j - 1));
    int8_t t = T(i, j);
    if (t == 0) { i--; j--; }
    else if (t == 1) i--;
    else j--;
  }
  len = (long long)ri.size();
  for (long long k = 0; k < len; k++) {  // reverse into output
    path_i[k] = ri[len - 1 - k];
    path_j[k] = rj[len - 1 - k];
  }
  return len;
}

}  // extern "C"
