// sclite-compatible weighted Levenshtein alignment.
//
// The reference scores WER/CER/MER by shelling out to SCTK's `sclite`
// (C binary built by tools/installers/install_sctk.sh; used at
// asr.sh:1505-1517 and local/score.sh:25-29). This is the native
// replacement: same dynamic program with sclite's default edit weights
// (correct 0, substitution 4, insertion 3, deletion 3), returning the
// correct/sub/del/ins counts that make up the error-rate tables.
//
// Built as a shared library, called through ctypes (see eval/scoring.py);
// tokens are interned to int32 on the Python side.

#include <cstdint>
#include <vector>

extern "C" {

// out4 = {correct, substitutions, deletions, insertions}
// returns total weighted distance
int32_t align_counts(const int32_t* ref, int32_t nr,
                     const int32_t* hyp, int32_t nh,
                     int32_t* out4) {
  const int32_t W_SUB = 4, W_INS = 3, W_DEL = 3;
  const int32_t stride = nh + 1;
  std::vector<int32_t> cost((nr + 1) * stride);
  std::vector<uint8_t> back((nr + 1) * stride);  // 0=cor,1=sub,2=del,3=ins

  for (int32_t j = 0; j <= nh; ++j) { cost[j] = j * W_INS; back[j] = 3; }
  for (int32_t i = 1; i <= nr; ++i) { cost[i * stride] = i * W_DEL; back[i * stride] = 2; }
  back[0] = 0;

  for (int32_t i = 1; i <= nr; ++i) {
    const int32_t r = ref[i - 1];
    for (int32_t j = 1; j <= nh; ++j) {
      const bool match = (r == hyp[j - 1]);
      int32_t best = cost[(i - 1) * stride + (j - 1)] + (match ? 0 : W_SUB);
      uint8_t op = match ? 0 : 1;
      const int32_t del_c = cost[(i - 1) * stride + j] + W_DEL;
      if (del_c < best) { best = del_c; op = 2; }
      const int32_t ins_c = cost[i * stride + (j - 1)] + W_INS;
      if (ins_c < best) { best = ins_c; op = 3; }
      cost[i * stride + j] = best;
      back[i * stride + j] = op;
    }
  }

  int32_t cor = 0, sub = 0, del = 0, ins = 0;
  int32_t i = nr, j = nh;
  while (i > 0 || j > 0) {
    switch (back[i * stride + j]) {
      case 0: ++cor; --i; --j; break;
      case 1: ++sub; --i; --j; break;
      case 2: ++del; --i; break;
      default: ++ins; --j; break;
    }
  }
  out4[0] = cor; out4[1] = sub; out4[2] = del; out4[3] = ins;
  return cost[nr * stride + nh];
}

}  // extern "C"
