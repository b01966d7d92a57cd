// Reed-Solomon decode over GF(2^8) for Hopper: a syndrome kernel and a
// decode kernel, one codeword per thread in each.
//
// Replaces libpoporon_tpu/models/rs_pallas.py `RSPallasDecoder._kernel`
// in its three modes: plain, erasure and external syndrome (rs_pallas.py
// :158-509; the three `decode_*` entries at :633-663).  It computes what
// the JAX package's XLA path (models/rs.py `_correct`) computes, bit for
// bit, and is held against the plain PyTorch version in
// libpoporon_tpu_torch/models/rs.py.
//
// A plain or erasure decode is two launches: `rs_syndrome_kernel` writes
// the log-form syndromes [B, nr], and `rs_decode_kernel` reads them as the
// external-syndrome mode reads the caller's.  Why apart: the decode
// kernel given the syndromes (ext mode) took 0.740 ms against 2.168 ms
// for the same rows with its old Horner loop (B = 131072, two errors a
// row; H100 80GB HBM3, 700 W), so the syndromes were two thirds of the
// plain decode.
//
// Syndromes, bit-sliced.  S is linear over GF(2) in the word's bits: row
// q*8 + b of G_syn (models/rs.py) is the syndrome contribution of bit b
// (MSB first) of full-length position q.  The wrapper packs those rows
// into a column table [fs][8][W] of 32-bit words (models/rs_cuda.py
// `syndrome_columns`); the block stages it in shared memory, and each
// thread XORs the columns of its word's set bits into W accumulators.
// Every lane of a warp reads the column of the same symbol at once, so the
// 16-byte table loads are broadcasts; there is no serial chain and no
// table gather.  What bounds it: 8W XORs a bit (2,040 bits a codeword),
// integer issue, not HBM (255 + 4 nr bytes a codeword).
//
// Decode, simple first.  What bounds it: for rows with errors, Chien over
// up to 255 points, BM, Forney and verify, each GF product two
// shared-memory table loads and a few integer ops, on state in local
// memory; not HBM (67 to 84 MB at B = 131072, about 0.025 ms).
// - One thread per codeword, 128 threads per block, grid ceil(B / 128);
//   the ragged last block is masked here, so the host pads nothing.
// - The block stages its 128 rows (data, then parity) into shared memory
//   with coalesced 16-byte loads (`stage_rows`, as the syndrome kernel
//   does), each thread decodes its own row in place, and the block copies
//   the rows back with coalesced byte stores: the counterpart of
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
//
// Berlekamp-Massey, bounded by tracked degrees.  The TPU's BM (rs_pallas.py
// `bm_body`; rs.py `_bm_planes`) runs nr fixed trips, each a discrepancy
// over `it` terms and an update of all nr + 1 slots of the locator and of
// the shifted b polynomial, which fits a lane-parallel vector unit.  On a
// thread per codeword that is about 1,600 GF products a row at nr = 32
// whatever the locator's degree L, and after trip 2L every discrepancy is
// zero.  Here the thread keeps both polynomials' degrees, sums the
// discrepancy over L + 1 terms, skips the update when it is zero, updates
// only the slots the b polynomial reaches, and shifts b by a count, not by
// moving it (step 3 says why each cut is exact): about 2 nr (L + 1) +
// 8 L (L + 1) products and sums.  The locator is the fixed loop's, bit for
// bit (tests/test_torch_rs_bm.py emulates this loop against the JAX one).
// Chien, Omega, Forney and verify are as before; the ext mode's time
// (decode kernel alone) is this stage's measure: 0.685 -> 0.28 ms at
// B = 131072, two errors a row (H100 80GB HBM3, 700 W).  ptxas: 80
// registers in both modes, a 528-byte stack frame (the per-thread
// arrays), no spills.

#include <cstdint>

#include <cuda_runtime.h>

#include "gf8.cuh"

namespace {

using gf8::kFs;

constexpr int kThreads = 128;    // codewords per block of the decode kernel
constexpr int kMaxRoots = 64;    // nr limit of the per-thread arrays
constexpr int kRowStride = 260;  // bytes between staged rows

struct Params {
  const uint8_t* data;      // [B, size]
  const uint8_t* parity;    // [B, nr]
  const int32_t* eras_pos;  // [B, eras_width] (erasure mode)
  const int32_t* eras_cnt;  // [B] (erasure mode)
  int eras_width;
  const int32_t* s_log;     // [B, nr] log-form syndromes, fs = zero
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
// (size data symbols, then nr parity symbols), from its log-form
// syndromes.  Corrects `word` in place where the XLA path would, and
// returns ok; *corrected gets the count.
template <bool ERASURE>
__device__ bool decode_row(const Params& p, const gf8::Tables& gf,
                           const int* sec, const int* inv, const int* va,
                           uint8_t* word, long long row, int* corrected) {
  const int nr = p.nr, size = p.size, n = size + nr;
  const int pad = kFs - n;
  *corrected = 0;

  // 1. Syndromes S_i = sum_j r_j alpha^{va_i (n-1-j)}, given in log form
  //    (sentinel fs = no error; a log outside [0, fs] reads as zero).
  uint8_t S[kMaxRoots];
  bool has_err = false;
  const int32_t* sl = p.s_log + row * nr;
  for (int i = 0; i < nr; ++i) {
    const int v = sl[i];
    has_err |= v != kFs;
    S[i] = (v >= 0 && v <= kFs) ? gf.antilog[v] : 0;
  }
  if (!has_err) return true;

  // 2. Start locator: 1, or the erasure-locator product.
  uint8_t el[kMaxRoots + 1], bp[kMaxRoots + 1];
  el[0] = 1;
  for (int j = 1; j <= nr; ++j) el[j] = 0;
  int ec = 0;  // erasure count, 8 bits wide as in the XLA path's BM
  const int32_t* pos = nullptr;
  int width = 0;
  if (ERASURE) {
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

  // 3. Berlekamp-Massey, nr trips; trips it <= ec are skipped.  The fixed
  //    loop's el and bp (each over nr + 1 slots, bp shifted a slot a trip)
  //    are kept bounded by tracked degrees: del and dbp are the highest
  //    nonzero slots of el and of bp as stored, every slot above them is
  //    zero, and the fixed loop's bp is x^s times the stored one.  Exact:
  //    - a discrepancy term el_j S_{it-1-j} with j > del is zero;
  //    - disc = 0 leaves el as it is and never grows, so the trip is
  //      bp's shift alone: s + 1;
  //    - el_j picks up disc bp_{j-1-s} only for s < j <= s + dbp + 1;
  //    - the fixed shift drops bp's slot nr, but the update reads bp only
  //      below slot nr (j - 1 < nr), so that slot never counts;
  //    - a grow stores el_old / disc over the slots up to max(del, top)
  //      >= dbp, which clears the old bp above its new degree, del_old.
  //    The grow test, pd and the skipped trips keep their 8-bit wraps.
  int del = 0;
  for (int j = 1; j <= nr; ++j)
    if (el[j]) del = j;
  for (int j = 0; j <= del; ++j) bp[j] = el[j];
  int dbp = del, s = 0, pd = ec;
  for (int it = 1; it <= nr; ++it) {
    if (ERASURE && it <= ec) continue;
    const int dj = del < it - 1 ? del : it - 1;
    int disc = 0;
    for (int j = 0; j <= dj; ++j) disc ^= gf.mul(el[j], S[it - 1 - j]);
    if (disc == 0) {
      ++s;
      continue;
    }
    const int it_ec = (it + ec) & 0xFF;
    const bool grow = ((2 * pd) & 0xFF) <= ((it_ec - 1) & 0xFF);
    const int top = s + dbp + 1 < nr ? s + dbp + 1 : nr;  // highest el slot bp reaches
    int hi = top;
    if (grow) {
      // descending, so bp[j - 1 - s] is read before this trip writes it
      hi = del > top ? del : top;
      const int dinv = inv[disc];
      for (int j = hi; j >= 0; --j) {
        const int e = el[j];
        if (j > s && j <= top) el[j] = e ^ gf.mul(disc, bp[j - 1 - s]);
        bp[j] = gf.mul(e, dinv);
      }
      dbp = del;
      s = 0;
      pd = (it_ec - pd) & 0xFF;
    } else {
      for (int j = top; j > s; --j) el[j] ^= gf.mul(disc, bp[j - 1 - s]);
      ++s;
    }
    if (hi > del) del = hi;
    while (del > 0 && el[del] == 0) --del;
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
  if (ERASURE) {
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

// Copies `rows` rows of a packed [rows, width] byte matrix at `src` into
// shared rows kRowStride bytes apart, from column `col`, with NT threads:
// coalesced 16-byte loads, each spread over the rows its bytes fall in;
// the bytes before src's first 16-byte boundary and after the last whole
// 16 go one at a time.
template <int NT>
__device__ __forceinline__ void stage_rows(const uint8_t* src, int width, int rows,
                                           uint8_t* dst, int col) {
  const int tid = threadIdx.x;
  const int total = rows * width;
  int head = (int)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15);
  if (head > total) head = total;
  const int vecs = (total - head) >> 4;
  const int tail = head + (vecs << 4);
  for (int i = tid; i < head; i += NT) {
    const int r = i / width;
    dst[r * kRowStride + col + i - r * width] = src[i];
  }
  for (int i = tail + tid; i < total; i += NT) {
    const int r = i / width;
    dst[r * kRowStride + col + i - r * width] = src[i];
  }
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
#pragma unroll 4
  for (int k = tid; k < vecs; k += NT) {
    const uint4 v = vsrc[k];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const int i = head + (k << 4);
    const int r = i / width;
    int c = i - r * width;
    uint8_t* d = dst + r * kRowStride + col;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      d[c] = (uint8_t)(w[e >> 2] >> (8 * (e & 3)));
      if (++c == width) {
        c = 0;
        d += kRowStride;
      }
    }
  }
}

template <bool ERASURE>
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
  stage_rows<kThreads>(p.data + row0 * size, size, rows, s_rows, 0);
  stage_rows<kThreads>(p.parity + row0 * nr, nr, rows, s_rows, size);
  __syncthreads();

  if (tid < rows) {
    const gf8::Tables gf{s_tab, s_tab + 256};
    int corrected;
    const bool ok = decode_row<ERASURE>(p, gf, s_tab + 512, s_tab + 768, s_va,
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

// ---------------------------------------------------------------- syndromes

constexpr int kSynThreads = 128;  // codewords per block of the syndrome kernel

struct SynParams {
  const uint8_t* data;    // [B, size]
  const uint8_t* parity;  // [B, nr]
  const uint4* columns;   // [fs][8][W] 32-bit words (syndrome_columns)
  const int32_t* log;     // [256] value -> log, log[0] = fs
  int32_t* s_log_out;     // [B, nr]
  int batch, size, nr;
};

// XORs into acc the columns of the set bits of the symbol in sym's low
// byte (bit 7 first, as G_syn's rows); `col` is the symbol's [8][W] words.
// Every lane reads the same column: broadcasts.
template <int W>
__device__ __forceinline__ void add_symbol(uint32_t (&acc)[W], const uint4* col,
                                           uint32_t sym) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const uint32_t m = 0u - ((sym >> (7 - b)) & 1u);
#pragma unroll
    for (int v = 0; v < W / 4; ++v) {
      const uint4 t = col[b * (W / 4) + v];
      acc[4 * v] ^= t.x & m;
      acc[4 * v + 1] ^= t.y & m;
      acc[4 * v + 2] ^= t.z & m;
      acc[4 * v + 3] ^= t.w & m;
    }
  }
}

template <int W>
constexpr int syndrome_smem() {
  return kFs * 8 * W * 4 + 256 * 4 + kSynThreads * kRowStride;
}

// One thread per codeword: S = the XOR of the table columns of the word's
// set bits.  Accumulator byte i (little-endian over the W words) is S_i,
// by the table's bit order; thread writes log[S_i] over its staged row,
// and the block copies the rows out.
template <int W>
__global__ void __launch_bounds__(kSynThreads) rs_syndrome_kernel(const SynParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint4* s_col = reinterpret_cast<uint4*>(smem);                // [fs][8][W]
  int* s_logt = reinterpret_cast<int*>(smem + kFs * 8 * W * 4);  // [256]
  uint8_t* s_rows = smem + kFs * 8 * W * 4 + 256 * 4;           // [rows][260]

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kSynThreads;
  const long long left = p.batch - row0;
  const int rows = left < kSynThreads ? (int)left : kSynThreads;
  const int size = p.size, nr = p.nr, n = size + nr;

  for (int i = tid; i < kFs * 2 * W; i += kSynThreads) s_col[i] = p.columns[i];
  for (int i = tid; i < 256; i += kSynThreads) s_logt[i] = p.log[i];
  stage_rows<kSynThreads>(p.data + row0 * size, size, rows, s_rows, 0);
  stage_rows<kSynThreads>(p.parity + row0 * nr, nr, rows, s_rows, size);
  __syncthreads();

  if (tid < rows) {
    const uint8_t* word = s_rows + tid * kRowStride;
    const uint4* col = s_col + (kFs - n) * 2 * W;  // column of symbol 0
    uint32_t acc[W] = {};
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      const uint32_t x = *reinterpret_cast<const uint32_t*>(word + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) add_symbol<W>(acc, col + (j + e) * 2 * W, x >> (8 * e));
    }
    for (; j < n; ++j) add_symbol<W>(acc, col + j * 2 * W, word[j]);
    int32_t* out = reinterpret_cast<int32_t*>(s_rows + tid * kRowStride);
#pragma unroll
    for (int i = 0; i < 4 * W; ++i)
      if (i < nr) out[i] = s_logt[(acc[i >> 2] >> (8 * (i & 3))) & 0xFF];
  }
  __syncthreads();

  // a warp a row, coalesced
  int32_t* dst = p.s_log_out + row0 * nr;
  for (int r = tid >> 5; r < rows; r += kSynThreads / 32) {
    const int32_t* src = reinterpret_cast<const int32_t*>(s_rows + r * kRowStride);
    for (int c = tid & 31; c < nr; c += 32) dst[r * nr + c] = src[c];
  }
}

template <int W>
cudaError_t launch_syndromes(const SynParams& p, cudaStream_t st) {
  constexpr int smem = syndrome_smem<W>();
  const cudaError_t set = cudaFuncSetAttribute(
      rs_syndrome_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid((unsigned)((p.batch + kSynThreads - 1) / kSynThreads));
  rs_syndrome_kernel<W><<<grid, kSynThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Writes the log-form syndromes s_log_out [B, nr] int32 (log[S_i], fs
// where S_i = 0: the decode's s_log) of the rows data [B, size] | parity
// [B, nr] on `stream` (a cudaStream_t) of `device`; allocates nothing.
// `columns` is the [fs][8][words] table of models/rs_cuda.py
// `syndrome_columns` for this nr (words = 4, 8 or 16, at least nr / 4),
// `tables` the decode's [4, 256] (log first).  Returns the launch's
// cudaError_t.
extern "C" int pp_rs_syndrome(const void* data, const void* parity, const void* columns,
                              const void* tables, void* s_log_out, int batch, int size,
                              int nr, int words, int device, void* stream) {
  if (batch < 1 || size < 1 || nr < 1 || nr > kMaxRoots || size + nr > kFs ||
      (words != 4 && words != 8 && words != 16) || 4 * words < nr)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const SynParams p = {static_cast<const uint8_t*>(data),
                       static_cast<const uint8_t*>(parity),
                       static_cast<const uint4*>(columns),
                       static_cast<const int32_t*>(tables),
                       static_cast<int32_t*>(s_log_out),
                       batch, size, nr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 4: return (int)launch_syndromes<4>(p, st);
    case 8: return (int)launch_syndromes<8>(p, st);
    default: return (int)launch_syndromes<16>(p, st);
  }
}

// Launches the decode on `stream` (a cudaStream_t) of `device`; allocates
// nothing.  s_log: the log-form syndromes [B, nr] (pp_rs_syndrome's, or
// the caller's in the external-syndrome path).  erasure: 1 starts BM from
// the erasure locator of eras_pos, eras_cnt (eras_width wide), 0 from 1.
// Returns the launch's cudaError_t.
extern "C" int pp_rs_decode(int erasure, const void* data, const void* parity,
                            const void* eras_pos, const void* eras_cnt,
                            int eras_width, const void* s_log,
                            const void* tables, void* data_out,
                            void* parity_out, void* ok_out,
                            void* corrected_out, int batch, int size, int nr,
                            int fcr, int prim, int prim_inv, int device,
                            void* stream) {
  if (batch < 1 || size < 1 || nr < 1 || nr > kMaxRoots || size + nr > kFs ||
      s_log == nullptr)
    return (int)cudaErrorInvalidValue;
  if (erasure && (eras_width < 1 || eras_width > nr))
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
  if (erasure)
    rs_decode_kernel<true><<<grid, kThreads, 0, st>>>(p);
  else
    rs_decode_kernel<false><<<grid, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}
