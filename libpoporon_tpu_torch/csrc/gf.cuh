// GF(2^M) device helpers on tables held in shared memory, M <= 16.
//
// Counterpart of libpoporon_tpu/ops/pallas_gf.py.  There a 256-entry
// lookup (`lut256`) is two 128-lane vreg gathers and a select; here it is
// one shared-memory load.  `gf_mul` becomes `mul`; `gf_mul_log`, a
// product of log-form operands, is needed here only with one operand a
// known power of alpha, which is `mul_alpha`; `mod_fs` keeps its name.
// Log-domain convention as in gf.c:62-63: log[0] = fs (the sentinel for
// zero), antilog[fs] = 0, and the log of a nonzero value lies in
// [0, fs - 1], fs = 2^M - 1.  The kernels instantiate M = 8 (symbols are
// bytes) and M = 10 (symbols are 16-bit words).
#pragma once

#include <cstdint>
#include <type_traits>

namespace galois {

// The field GF(2^M): its size, the length of its tables and the type that
// holds a symbol in memory.
template <int M>
struct Field {
  static constexpr int kFs = (1 << M) - 1;   // field size 2^M - 1, also the log of zero
  static constexpr int kTable = 1 << M;      // entries of a log or antilog table
  using Sym = typename std::conditional<(M <= 8), uint8_t, uint16_t>::type;
};

// x mod fs for 0 <= x < 2^31: shift-add folding (2^M = 1 mod fs), the
// reference's gf_mod (common.h:102-110).
template <int M>
__device__ __forceinline__ int mod_fs(int x) {
  constexpr int kFs = Field<M>::kFs;
  while (x > 2 * kFs) x = (x >> M) + (x & kFs);
  if (x >= kFs) x -= kFs;
  if (x >= kFs) x -= kFs;
  return x;
}

template <int M>
struct Tables {
  static constexpr int kFs = Field<M>::kFs;
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

}  // namespace galois
