// Reed-Solomon decode over GF(2^8), one codeword per thread, for Hopper.
//
// Replaces libpoporon_tpu/models/rs_pallas.py `RSPallasDecoder._kernel`
// in its three modes: plain, erasure and external syndrome (rs_pallas.py
// :158-509; the three `decode_*` entries at :633-663).  It computes what
// the JAX package's XLA path (models/rs.py `_correct`) computes, bit for
// bit, and is held against the plain PyTorch version in
// libpoporon_tpu_torch/models/rs.py.
//
// What bounds it on an H100: at B = 131072 codewords of RS(255,223) the
// kernel moves about 67 MB of HBM (about 20 us at 3.35 TB/s), but each
// codeword needs about 8k GF products for its syndromes alone (nr Horner
// passes over 255 symbols), plus Chien over up to 255 points for rows with
// errors.  Each product is two shared-memory table loads and a few integer
// ops, so shared-memory lookups and integer ALU work bound the kernel, not
// HBM.
//
// Design, simple first:
// - One thread per codeword, 128 threads per block, grid ceil(B / 128);
//   the ragged last block is masked here, so the host pads nothing.
// - The block stages its 128 rows (data, then parity) into shared memory
//   with coalesced byte copies, each thread decodes its own row in place,
//   and the block copies the rows back the same way: the counterpart of
//   the in-kernel transposes at rs_pallas.py:176-187 and 494-505.  Rows are
//   260 bytes apart (65 words), so the threads of a warp reading symbol j
//   of their own rows hit 32 different banks.
// - log, antilog, sec and inv tables sit in shared memory (4 x 256 ints).
// - Per-thread state (syndromes, locator, roots, corrections; nr <= 64)
//   lives in small local arrays.
// - A row without syndrome errors returns untouched as soon as that is
//   known; a row that fails a pre-check returns before Forney.
// - The erasure apply follows the XLA path (rs.py:534-542), not the
//   Pallas kernel: locator slots past the E given positions read position
//   0, and coefficients landing on one position are summed, not XORed.
// Faster designs (a warp per codeword, bit-sliced syndromes on the tensor
// cores, Chien skipped for clean rows ahead of time) wait for a trace.

#include <cstdint>

#include <cuda_runtime.h>

#include "gf8.cuh"

namespace {

using gf8::kFs;

constexpr int kThreads = 128;    // codewords per block
constexpr int kMaxRoots = 64;    // nr limit of the per-thread arrays
constexpr int kRowStride = 260;  // bytes between staged rows

enum Mode { kPlain = 0, kErasure = 1, kExt = 2 };

struct Params {
  const uint8_t* data;      // [B, size]
  const uint8_t* parity;    // [B, nr]
  const int32_t* eras_pos;  // [B, eras_width] (erasure mode)
  const int32_t* eras_cnt;  // [B] (erasure mode)
  int eras_width;
  const int32_t* s_log;     // [B, nr] log-form syndromes (ext mode)
  const int32_t* tables;    // [4, 256]: log, antilog, sec, inv
  uint8_t* data_out;        // [B, size]
  uint8_t* parity_out;      // [B, nr]
  uint8_t* ok_out;          // [B] bool
  int32_t* corrected_out;   // [B]
  int batch, size, nr, fcr, prim, prim_inv;
};

// alpha^{(prim * (fs - 1 - (pos + pad)) mod 2^16) mod fs}, in wrapping
// 32-bit arithmetic (decode.c:34-47, rs.py:294-296).
__device__ __forceinline__ int erasure_term(const gf8::Tables& gf, int pos,
                                            int pad, int prim) {
  const unsigned raw =
      (unsigned)prim * ((unsigned)(kFs - 1 - pad) - (unsigned)pos);
  return gf.antilog[(raw & 0xFFFFu) % kFs];
}

// Position of locator slot t in erasure mode: the caller's t-th position,
// and 0 for slots past the ones given (the XLA path's zero padding).
__device__ __forceinline__ int erasure_slot(const int32_t* pos, int width,
                                            int t) {
  return t < width ? pos[t] : 0;
}

// error_correction_u8 (decode.c:17-230) on the word staged in `word`
// (size data symbols, then nr parity symbols).  Corrects `word` in place
// where the XLA path would, and returns ok; *corrected gets the count.
template <int MODE>
__device__ bool decode_row(const Params& p, const gf8::Tables& gf,
                           const int* sec, const int* inv, const int* va,
                           uint8_t* word, long long row, int* corrected) {
  const int nr = p.nr, size = p.size, n = size + nr;
  const int pad = kFs - n;
  *corrected = 0;

  // 1. Syndromes S_i = sum_j r_j alpha^{va_i (n-1-j)} by Horner, or the
  //    given log-form syndromes (sentinel fs = no error).
  uint8_t S[kMaxRoots];
  bool has_err = false;
  if (MODE == kExt) {
    const int32_t* sl = p.s_log + row * nr;
    for (int i = 0; i < nr; ++i) {
      const int v = sl[i];
      has_err |= v != kFs;
      S[i] = (v >= 0 && v <= kFs) ? gf.antilog[v] : 0;
    }
  } else {
    for (int i = 0; i < nr; ++i) {
      const int a = va[i];
      int s = 0;
      for (int j = 0; j < n; ++j) s = gf.mul_alpha(s, a) ^ word[j];
      S[i] = s;
      has_err |= s != 0;
    }
  }
  if (!has_err) return true;

  // 2. Start locator: 1, or the erasure-locator product.
  uint8_t el[kMaxRoots + 1], bp[kMaxRoots + 1];
  el[0] = 1;
  for (int j = 1; j <= nr; ++j) el[j] = 0;
  int ec = 0;  // erasure count, 8 bits wide as in the XLA path's BM
  const int32_t* pos = nullptr;
  int width = 0;
  if (MODE == kErasure) {
    pos = p.eras_pos + row * p.eras_width;
    width = p.eras_width < nr ? p.eras_width : nr;
    const int cnt = p.eras_cnt[row];
    if (cnt > 0) el[1] = erasure_term(gf, pos[0], pad, p.prim);
    for (int i = 1; i < p.eras_width && i < cnt; ++i) {
      const int term = erasure_term(gf, pos[i], pad, p.prim);
      for (int j = (i + 1 < nr ? i + 1 : nr); j >= 1; --j)
        el[j] ^= gf.mul(term, el[j - 1]);
    }
    ec = cnt & 0xFF;
  }

  // 3. Berlekamp-Massey, nr trips; trips it <= ec are skipped.
  for (int j = 0; j <= nr; ++j) bp[j] = el[j];
  int pd = ec;
  for (int it = 1; it <= nr; ++it) {
    if (MODE == kErasure && it <= ec) continue;
    int disc = 0;
    for (int j = 0; j < it; ++j) disc ^= gf.mul(el[j], S[it - 1 - j]);
    const int it_ec = (it + ec) & 0xFF;
    const bool grow =
        disc != 0 && ((2 * pd) & 0xFF) <= ((it_ec - 1) & 0xFF);
    const int dinv = inv[disc];
    for (int j = nr; j >= 1; --j) {
      const int e = el[j];
      el[j] = e ^ gf.mul(disc, bp[j - 1]);
      bp[j] = grow ? gf.mul(e, dinv) : bp[j - 1];
    }
    bp[0] = grow ? gf.mul(el[0], dinv) : 0;
    if (grow) pd = (it_ec - pd) & 0xFF;
  }

  // 4. Degree.
  int deg = 0;
  for (int j = nr; j >= 1; --j) {
    if (el[j]) {
      deg = j;
      break;
    }
  }
  if (deg == 0) return false;  // fail_deg: word untouched

  // 5. Chien at alpha^i, i = 1..fs; the first deg roots in scan order.
  uint8_t lt[kMaxRoots + 1];  // log(el_j) + j*i mod fs
  for (int j = 1; j <= deg; ++j) lt[j] = gf.log[el[j]];
  uint8_t root[kMaxRoots], loc[kMaxRoots];
  int found = 0;
  bool fail_pad = false;
  for (int i = 1; i <= kFs && found < deg; ++i) {
    int ev = 0;
    for (int j = 1; j <= deg; ++j) {
      int l = lt[j];
      if (l == kFs) continue;
      l += j;
      if (l >= kFs) l -= kFs;
      lt[j] = l;
      ev ^= gf.antilog[l];
    }
    if (ev == 1) {  // el(alpha^i) = 0, since el_0 = 1
      const int k = gf8::mod_fs(i * p.prim_inv + kFs - 1);
      root[found] = i;
      loc[found] = k;
      fail_pad |= k < pad;
      ++found;
    }
  }
  if (found != deg || fail_pad) return false;  // word untouched

  // 6. Omega = S * el mod x^nr, degree < deg.
  uint8_t om[kMaxRoots];
  for (int i = 0; i < deg; ++i) {
    int o = 0;
    for (int j = 0; j <= i; ++j) o ^= gf.mul(el[j], S[i - j]);
    om[i] = o;
  }

  // 7. Forney: num * sec[root] * inv[den], inv[0] = 1.
  uint8_t coef[kMaxRoots];
  int live = 0;
  for (int t = 0; t < deg; ++t) {
    const int r = root[t];
    int num = 0;
    for (int i = 0; i < deg; ++i) num ^= gf.mul_alpha(om[i], (i * r) % kFs);
    int den = 0;
    for (int j = 1; j <= deg; j += 2)
      den ^= gf.mul_alpha(el[j], ((j - 1) * r) % kFs);
    coef[t] = num ? gf.mul(gf.mul(num, sec[r]), inv[den]) : 0;
    live += num != 0;
  }
  *corrected = live;

  // 8. Verify: the syndromes of the correction vector must equal S.
  for (int i = 0; i < nr; ++i) {
    int v = 0;
    for (int t = 0; t < deg; ++t)
      v ^= gf.mul_alpha(coef[t], (va[i] * (kFs - 1 - loc[t])) % kFs);
    if (v != S[i]) return false;  // word untouched, count kept
  }

  // 9. Apply.
  if (MODE == kErasure) {
    // Coefficient t at slot t's position, data region only; the sum of
    // the coefficients landing on one position is XORed in, low byte.
    for (int t = 0; t < deg; ++t) {
      const int pt = erasure_slot(pos, width, t);
      if (pt < 0 || pt >= size) continue;
      bool first = true;
      for (int u = 0; u < t && first; ++u)
        first = erasure_slot(pos, width, u) != pt;
      if (!first) continue;
      int sum = 0;
      for (int u = t; u < deg; ++u)
        if (erasure_slot(pos, width, u) == pt) sum += coef[u];
      word[pt] ^= (uint8_t)sum;
    }
    return true;
  }
  // The C applies in order and stops at the first location outside the
  // word, keeping what it already applied (fail_apply).
  for (int t = 0; t < deg; ++t) {
    const int lp = loc[t] - pad;
    if (lp < 0 || lp >= n) return false;
    word[lp] ^= coef[t];
  }
  return true;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) rs_decode_kernel(const Params p) {
  __shared__ int s_tab[4 * 256];
  __shared__ int s_va[kMaxRoots];
  __shared__ uint8_t s_rows[kThreads * kRowStride];

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kThreads;
  const long long left = p.batch - row0;
  const int rows = left < kThreads ? (int)left : kThreads;
  const int size = p.size, nr = p.nr;

  for (int i = tid; i < 4 * 256; i += kThreads) s_tab[i] = p.tables[i];
  // verify-stage row constants a_i = ((fcr + i) * prim) mod fs
  for (int i = tid; i < nr; i += kThreads) s_va[i] = ((p.fcr + i) * p.prim) % kFs;
  const uint8_t* dsrc = p.data + row0 * size;
  for (int i = tid; i < rows * size; i += kThreads) {
    const int r = i / size;
    s_rows[r * kRowStride + (i - r * size)] = dsrc[i];
  }
  const uint8_t* psrc = p.parity + row0 * nr;
  for (int i = tid; i < rows * nr; i += kThreads) {
    const int r = i / nr;
    s_rows[r * kRowStride + size + (i - r * nr)] = psrc[i];
  }
  __syncthreads();

  if (tid < rows) {
    const gf8::Tables gf{s_tab, s_tab + 256};
    int corrected;
    const bool ok = decode_row<MODE>(p, gf, s_tab + 512, s_tab + 768, s_va,
                                     s_rows + tid * kRowStride, row0 + tid,
                                     &corrected);
    p.ok_out[row0 + tid] = ok;
    p.corrected_out[row0 + tid] = corrected;
  }
  __syncthreads();

  uint8_t* ddst = p.data_out + row0 * size;
  for (int i = tid; i < rows * size; i += kThreads) {
    const int r = i / size;
    ddst[i] = s_rows[r * kRowStride + (i - r * size)];
  }
  uint8_t* pdst = p.parity_out + row0 * nr;
  for (int i = tid; i < rows * nr; i += kThreads) {
    const int r = i / nr;
    pdst[i] = s_rows[r * kRowStride + size + (i - r * nr)];
  }
}

}  // namespace

// Launches the decode on `stream` (a cudaStream_t) of `device`; allocates
// nothing.  mode: 0 plain, 1 erasure (eras_pos, eras_cnt, eras_width),
// 2 external syndrome (s_log).  Returns the launch's cudaError_t.
extern "C" int pp_rs_decode(int mode, const void* data, const void* parity,
                            const void* eras_pos, const void* eras_cnt,
                            int eras_width, const void* s_log,
                            const void* tables, void* data_out,
                            void* parity_out, void* ok_out,
                            void* corrected_out, int batch, int size, int nr,
                            int fcr, int prim, int prim_inv, int device,
                            void* stream) {
  if (batch < 1 || size < 1 || nr < 1 || nr > kMaxRoots || size + nr > kFs)
    return (int)cudaErrorInvalidValue;
  if (mode == kErasure && (eras_width < 1 || eras_width > nr))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;

  Params p;
  p.data = static_cast<const uint8_t*>(data);
  p.parity = static_cast<const uint8_t*>(parity);
  p.eras_pos = static_cast<const int32_t*>(eras_pos);
  p.eras_cnt = static_cast<const int32_t*>(eras_cnt);
  p.eras_width = eras_width;
  p.s_log = static_cast<const int32_t*>(s_log);
  p.tables = static_cast<const int32_t*>(tables);
  p.data_out = static_cast<uint8_t*>(data_out);
  p.parity_out = static_cast<uint8_t*>(parity_out);
  p.ok_out = static_cast<uint8_t*>(ok_out);
  p.corrected_out = static_cast<int32_t*>(corrected_out);
  p.batch = batch;
  p.size = size;
  p.nr = nr;
  p.fcr = fcr;
  p.prim = prim;
  p.prim_inv = prim_inv;

  const dim3 grid((unsigned)((batch + kThreads - 1) / kThreads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPlain:
      rs_decode_kernel<kPlain><<<grid, kThreads, 0, st>>>(p);
      break;
    case kErasure:
      rs_decode_kernel<kErasure><<<grid, kThreads, 0, st>>>(p);
      break;
    case kExt:
      rs_decode_kernel<kExt><<<grid, kThreads, 0, st>>>(p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
