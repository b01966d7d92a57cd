// GF(2^8) device helpers on tables held in shared memory.
//
// Counterpart of libpoporon_tpu/ops/pallas_gf.py.  There a 256-entry
// lookup (`lut256`) is two 128-lane vreg gathers and a select; here it is
// one shared-memory load.  `gf_mul` becomes `mul`; `gf_mul_log`, a
// product of log-form operands, is needed here only with one operand a
// known power of alpha, which is `mul_alpha`; `mod_fs` keeps its name.  Log-domain convention as in gf.c:62-63:
// log[0] = 255 (the sentinel for zero), antilog[255] = 0, and the log of a
// nonzero value lies in [0, 254].
#pragma once

namespace gf8 {

constexpr int kFs = 255;  // field size 2^8 - 1

// x mod 255 for 0 <= x < 2^31: shift-add folding (2^8 = 1 mod 255), the
// reference's gf_mod (common.h:102-110).
__device__ __forceinline__ int mod_fs(int x) {
  while (x > 2 * kFs) x = (x >> 8) + (x & kFs);
  if (x >= kFs) x -= kFs;
  if (x >= kFs) x -= kFs;
  return x;
}

struct Tables {
  const int* log;      // value -> log, log[0] = kFs
  const int* antilog;  // log -> value, antilog[kFs] = 0

  // Normal-domain product.
  __device__ __forceinline__ int mul(int a, int b) const {
    if (a == 0 || b == 0) return 0;
    int s = log[a] + log[b];
    if (s >= kFs) s -= kFs;
    return antilog[s];
  }

  // a * alpha^e for 0 <= e < kFs.
  __device__ __forceinline__ int mul_alpha(int a, int e) const {
    if (a == 0) return 0;
    int s = log[a] + e;
    if (s >= kFs) s -= kFs;
    return antilog[s];
  }
};

}  // namespace gf8
