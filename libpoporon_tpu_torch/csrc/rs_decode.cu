// Reed-Solomon decode over GF(2^8) for Hopper: a syndrome kernel and a
// decode kernel, one codeword per thread in each, and a stripe kernel
// that rebuilds lost cells of shard-major stripes (last in this file).
// The decode kernel is a template over the field, instantiated for bytes
// (m = 8) and for ten-bit symbols held in 16-bit words (m = 10, plain form
// only); m = 10 has a syndrome kernel of its own (`rs_syndrome_wide_kernel`).
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
// Syndromes, a division by g(x) a byte a step.  S_i = r(b_i), with r(x)
// the row's polynomial and b_i = alpha^((fcr + i) prim) a root of g(x), so
// S_i is also the remainder of r modulo any multiple of x - b_i, evaluated
// at b_i.  The kernel splits the roots into factors of 16 (F = ceil(nr /
// 16)) and divides each row by h_f(x) = x^(16 - r_f) g_f(x), monic of
// degree 16, keeping each remainder in four registers: a step per symbol
// takes the top byte, shifts the words up a byte with the symbol entering
// byte 0 (three funnel shifts and a byte permute) and XORs in T_f[top], one
// 16-byte table load a factor.  Leading zeros leave a remainder as it is,
// so a shortened row costs its own length.  The tail evaluates each
// remainder at its factor's roots from nibble tables (32 lookups a factor)
// and writes log[S_i] (models/rs_cuda.py `syndrome_tables` builds T and
// the tails; tests/test_torch_rs_syndrome.py emulates this loop against
// the JAX syndromes).  What bounds it: integer issue, about 10 ALU
// instructions a step and factor (against 100 a symbol for the bit-sliced
// loop it replaces), issued at half rate, so about 10 cycles an SM a warp
// and symbol at nr = 32; then shared-memory bandwidth, 8 wavefronts a warp
// and symbol (8 KB of T a row); not HBM (255 + 4 nr bytes a codeword).  At
// B = 131072, nr = 32 (H100 80GB HBM3, 700 W): 0.082 ms, from 0.240 for
// the bit-sliced kernel; clock64() stamps split a tile's cycles 74%
// division, 13% tail, 10% logs out.
// - Two factors hold two independent chains a thread (each step's address
//   waits on the last step's load).
// - The lookups of T are data-dependent.  Where they fit (nr <= 32), T
//   holds 8 copies of each entry, lane l of each 8-lane phase of a 16-byte
//   load reading copy l mod 8, so that the eight fall in distinct banks
//   whatever the tops; else one copy.
// - Persistent blocks, one an SM, stage the tables once and take tiles of
//   256 rows in turn.  A tile's rows come in packed, as they lie in device
//   memory, by cp.async into one of two buffers while the block divides
//   the other tile's, and a thread reads its row a word at a time with a
//   funnel shift.  The tile's logs go back over its buffer as bytes, and
//   out as int32 with 16-byte stores.

// Decode.  What bounds it: the instruction rate of BM, Chien over the 255
// points, Forney and verify (each GF product two shared-memory table loads
// and a few integer ops; all a thread a row but Chien, so a warp waits for
// its worst row), on per-row state (el, bp, roots, locations, Omega,
// coefficients) in local memory; not HBM (67 to 84 MB at B = 131072, about
// 0.025 ms).  The design spends the block's shared memory on what the
// kernel reads many times, the syndromes, gives the rest of the SM's 256
// KB to L1, and so holds 9 blocks an SM in place of 6: on Binomial rows
// BM, Chien, Forney and verify are 80% of the cycles.
// - One thread per codeword for every stage but Chien, 128 threads per
//   block, grid ceil(B / 128); the ragged last block is masked here, so
//   the host pads nothing.  56 registers, 9 blocks an SM (the launch bound
//   asks for 8: B = 131072's 1,024 blocks in one wave of 132 SMs).
// - Rows are copied through, never staged (`copy_through`): a warp's 32
//   rows of data are one contiguous range of 32 size bytes, their parity
//   another of 32 nr, each a multiple of 16, and after its Chien sweep the
//   warp copies both to data_out and parity_out with 16-byte loads and
//   stores, a funnel shift where the input lies otherwise than the output
//   modulo 16.  After __syncwarp each owner writes its row's corrections,
//   output byte = input byte XOR coefficient (`finish_row`'s apply): about
//   2 bytes a row.  Copied there, and not by the block before its first
//   barrier, the rows move while other warps compute; with every block of
//   the wave copying at once at the start, the copy was 17% of the cycles
//   on Binomial rows, and 7% here (0.203 against 0.193 ms).  The
//   counterpart of the in-kernel transposes at rs_pallas.py:176-187 and
//   494-505, without a shared copy of the rows.
// - The tile's log-form syndromes, rows x nr int32 in one contiguous
//   range, come in with 16-byte loads and are turned once into bytes in
//   shared memory (`stage_syndromes`), a row every `syndrome_stride(nr)`
//   bytes, an odd count of words, so that the 32 rows of a warp, each
//   thread at its own byte, fall in 32 banks; BM, Omega and the verify
//   read S there.  (Each thread read its own row's 32 logs, 128 bytes
//   apart, so that every warp load touched 32 lines: 13% of the cycles.)
// - log, antilog, sec and inv tables sit in shared memory (4 x 256 ints).
// - What is left of shared memory an SM is L1: the launcher sets the
//   kernel's carveout once a card (`pp_rs_decode_shape`), the least that
//   keeps its blocks an SM (39% at nr = 32).  At nr = 32: 4,608 bytes of
//   syndromes and 4,480 of tables and flags a block, against 37,632 with
//   the rows.  The per-row state stays in local memory (336 bytes a
//   thread, from 416 with S).
// - A row without syndrome errors is left as copied as soon as that is
//   known; a row that fails a pre-check skips Forney.
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
//
// Chien, a warp a row (`chien_sweep`).  A thread scanning its own row
// steps deg logs in local memory a point until its last root, so a warp
// ran as long as its latest root and as deep as its largest degree: under
// Binomial errors a row (2/255 a symbol) a warp's worst row has degree 5.4
// on average, against 2.0 for the mean row, and Chien was half the
// kernel's cycles.  Here the warp sweeps its rows of degree >= 1 one after
// another, the 32 lanes 8 points each, the terms' logs stepped in
// registers, so a row costs 8 deg term-steps a lane whatever the others
// hold; one ballot a step gives the roots in scan order.  What bounds it:
// the antilog gathers (a lane-strided exponent, so 2^k-way bank conflicts
// for even j; a byte-wide table measured no faster) and about five
// integer instructions a term-step.  The roots, their order, found and
// fail_pad are the scan's, bit for bit (tests/test_torch_rs_chien.py
// emulates the sweep against the JAX Chien).
//
// Measured, the decode kernel alone at B = 131072 (ext mode; H100 80GB
// HBM3, 700 W): Binomial rows 0.635 ms with a thread's Chien, 0.302 with
// the warp's and the rows staged in shared memory, 0.193 with the
// syndromes there and the rows copied through; two errors a row 0.190 ->
// 0.116 ms, 32 erasures (both launches) 2.24 -> 1.49 ms.

#include <cstdint>

#include <cuda_runtime.h>

#include "gf.cuh"

namespace {

using galois::Field;

template <int M>
using Sym = typename Field<M>::Sym;

constexpr int kFs = Field<8>::kFs;   // the byte field's size, of the stripe and byte syndrome kernels
constexpr int kThreads = 128;    // codewords per block of the decode kernel
constexpr int kMaxRoots = 64;    // nr limit of the per-thread arrays
constexpr int kSweepSteps = 8;   // Chien points a lane: 32 lanes x 8 >= fs (m = 8), a chunk's past it
constexpr unsigned kFullWarp = 0xffffffffu;

// Bytes between two rows' syndromes in the decode kernel's shared memory:
// the least odd count of words that holds nr bytes (nr symbols of a byte,
// or nr / 2 of two bytes).
__host__ __device__ constexpr int syndrome_stride(int nr) { return 4 * (((nr + 3) / 4) | 1); }

// The decode kernel's dynamic shared bytes a block: its rows' syndromes,
// nr bytes a row.
__host__ __device__ constexpr int decode_smem(int nr) { return kThreads * syndrome_stride(nr); }

template <int M>
struct ParamsT {
  const Sym<M>* data;       // [B, size]
  const Sym<M>* parity;     // [B, nr]
  const int32_t* eras_pos;  // [B, eras_width] (erasure mode)
  const int32_t* eras_cnt;  // [B] (erasure mode)
  int eras_width;
  const int32_t* s_log;     // [B, nr] log-form syndromes, fs = zero
  const int32_t* tables;    // [4, 2^M]: log, antilog, sec, inv
  Sym<M>* data_out;         // [B, size]
  Sym<M>* parity_out;       // [B, nr]
  uint8_t* ok_out;          // [B] bool
  int32_t* corrected_out;   // [B]
  int batch, size, nr, fcr, prim, prim_inv;
};

using Params = ParamsT<8>;

// alpha^{(prim * (fs - 1 - (pos + pad)) mod 2^16) mod fs}, in wrapping
// 32-bit arithmetic (decode.c:34-47, rs.py:294-296).
template <int M>
__device__ __forceinline__ int erasure_term(const galois::Tables<M>& gf, int pos,
                                            int pad, int prim) {
  constexpr int kFs = Field<M>::kFs;
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

// Steps 2 to 4 of error_correction_u8 (decode.c:17-230) for a row with
// syndrome errors: the locator el (nr + 1 slots) from its syndromes S
// (step 1, the caller's, as symbols).  Returns the locator's degree; a row
// of degree 0 ends here, not ok (fail_deg).
template <int M, bool ERASURE>
__device__ __forceinline__ int locate_row(const ParamsT<M>& p, const galois::Tables<M>& gf,
                                          const int* inv, long long row, const Sym<M>* S,
                                          Sym<M>* el) {
  constexpr int kFs = Field<M>::kFs;
  const int nr = p.nr;
  const int pad = kFs - p.size - nr;

  // 2. Start locator: 1, or the erasure-locator product.
  Sym<M> bp[kMaxRoots + 1];
  el[0] = 1;
  for (int j = 1; j <= nr; ++j) el[j] = 0;
  int ec = 0;  // erasure count, 8 bits wide as in the XLA path's BM
  if (ERASURE) {
    const int32_t* pos = p.eras_pos + row * p.eras_width;
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
  for (int j = nr; j >= 1; --j)
    if (el[j]) return j;
  return 0;  // fail_deg: word untouched
}

// 5. Chien at alpha^i, i = 1..fs, a warp a row (m = 8).  Every lane of the
//    warp calls it, those without a locator to sweep (deg 0) too.  The warp
//    takes its rows of degree >= 1 in turn, by the bits of one ballot; the
//    row's owner lane broadcasts its coefficients, and lane l evaluates the
//    points i = l + 1 + 32 s, s < kSweepSteps, each term's log stepped in
//    a register from (log el_j + j i) mod fs by 32 j.  One ballot a step
//    is the set of that step's roots: bit l of hits[s] is the point
//    l + 1 + 32 s, so the bits in order of s, then l, are the roots in
//    scan order, and the owner keeps its row's hits.  All the roots are
//    the scan's first deg: el_0 = 1, so el (degree deg) has at most deg
//    roots among the fs distinct points.
__device__ __forceinline__ void chien_sweep(const Params&, const galois::Tables<8>& gf,
                                            const uint8_t* el, int deg,
                                            uint32_t (&hits)[kSweepSteps]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < kSweepSteps; ++s) hits[s] = 0;
  for (uint32_t todo = __ballot_sync(kFullWarp, deg > 0); todo; todo &= todo - 1) {
    const int owner = __ffs(todo) - 1;
    const int d = __shfl_sync(kFullWarp, deg, owner);
    int ev[kSweepSteps];
#pragma unroll
    for (int s = 0; s < kSweepSteps; ++s) ev[s] = 0;
    for (int j = 1; j <= d; ++j) {
      const int c = __shfl_sync(kFullWarp, lane == owner ? el[j] : 0, owner);
      if (c == 0) continue;  // a zero coefficient, skipped by every lane
      const int step = galois::mod_fs<8>(32 * j);
      int e = galois::mod_fs<8>(gf.log[c] + j * (lane + 1));
#pragma unroll
      for (int s = 0; s < kSweepSteps; ++s) {
        ev[s] ^= gf.antilog[e];
        e += step;
        if (e >= kFs) e -= kFs;
      }
    }
#pragma unroll
    for (int s = 0; s < kSweepSteps; ++s) {
      // el(alpha^i) = 0 where the terms sum to 1 (el_0 = 1); i = 256 is no point
      const uint32_t b = __ballot_sync(kFullWarp, ev[s] == 1 && lane + 1 + 32 * s <= kFs);
      if (lane == owner) hits[s] = b;
    }
  }
}

// The roots the wide sweep gives a row's owner: found of them, each with
// its point's index i in 1..fs and its location in the unshortened word.
template <int M>
struct WideRoots {
  int found;
  Sym<M> root[kMaxRoots], loc[kMaxRoots];
};

// The wide sweep's C steps from location k0 + lane (of lane 0 + 32 s for
// step s) for the row of lane `owner`, of degree d: its roots there added
// to the owner's `out` in the order of s, then lane.
template <int C, int M>
__device__ __forceinline__ void sweep_chunk(const galois::Tables<M>& gf, const Sym<M>* el,
                                            int d, int owner, int k0, int prim,
                                            WideRoots<M>& out) {
  constexpr int kFs = Field<M>::kFs;
  const int lane = threadIdx.x & 31;
  int ev[C];
#pragma unroll
  for (int s = 0; s < C; ++s) ev[s] = 0;
  const int i0 = galois::mod_fs<M>((k0 + lane + 1) * prim);   // the lane's first point
  for (int j = 1; j <= d; ++j) {
    const int c = __shfl_sync(kFullWarp, lane == owner ? el[j] : 0, owner);
    if (c == 0) continue;
    const int step = galois::mod_fs<M>(32 * prim * j);
    int e = galois::mod_fs<M>(gf.log[c] + j * i0);
#pragma unroll
    for (int s = 0; s < C; ++s) {
      ev[s] ^= gf.antilog[e];
      e += step;
      if (e >= kFs) e -= kFs;
    }
  }
#pragma unroll
  for (int s = 0; s < C; ++s) {
    const uint32_t b = __ballot_sync(kFullWarp, ev[s] == 1 && k0 + lane + 32 * s < kFs);
    if (lane == owner) {
      for (uint32_t bits = b; bits; bits &= bits - 1) {
        const int k = k0 + __ffs(bits) - 1 + 32 * s;
        const int i = galois::mod_fs<M>((k + 1) * prim);
        out.root[out.found] = i == 0 ? kFs : i;
        out.loc[out.found] = k;
        ++out.found;
      }
    }
  }
}

// 5. (m > 8) Chien a warp a row over the n locations of the shortened
//    word only, k = pad .. fs - 1, each at its point i = (k + 1) prim mod
//    fs (k = (i prim_inv - 1) mod fs, so each point once): lane l takes
//    the locations pad + l + 32 s, in chunks of 8 steps, then 4, 2 and 1
//    (so that no step is past the word's last 32), each chunk's terms
//    stepped in registers as in the sweep above, and the owner records its
//    roots as the ballots give them.  A row whose found roots fall short
//    of its degree fails, as one with a root in the pad or too few roots
//    does in the full scan, with the same output; where all deg are
//    found they are the scan's roots, in an order that changes nothing
//    (distinct locations, all inside the word).  At n = 544 and fs = 1023
//    that is 17 steps a lane in place of 32.
template <int M>
__device__ __forceinline__ void chien_sweep(const ParamsT<M>& p, const galois::Tables<M>& gf,
                                            const Sym<M>* el, int deg, WideRoots<M>& out) {
  constexpr int kFs = Field<M>::kFs;
  const int pad = kFs - p.size - p.nr;
  const int steps = (p.size + p.nr + 31) >> 5;
  out.found = 0;
  for (uint32_t todo = __ballot_sync(kFullWarp, deg > 0); todo; todo &= todo - 1) {
    const int owner = __ffs(todo) - 1;
    const int d = __shfl_sync(kFullWarp, deg, owner);
    int s0 = 0;
    for (; s0 + kSweepSteps <= steps; s0 += kSweepSteps)
      sweep_chunk<kSweepSteps, M>(gf, el, d, owner, pad + 32 * s0, p.prim, out);
    if ((steps - s0) & 4) {
      sweep_chunk<4, M>(gf, el, d, owner, pad + 32 * s0, p.prim, out);
      s0 += 4;
    }
    if ((steps - s0) & 2) {
      sweep_chunk<2, M>(gf, el, d, owner, pad + 32 * s0, p.prim, out);
      s0 += 2;
    }
    if ((steps - s0) & 1) sweep_chunk<1, M>(gf, el, d, owner, pad + 32 * s0, p.prim, out);
  }
}

// What the sweep leaves a row's owner: the ballot words (m = 8) or the
// roots themselves.
template <int M>
struct SweepOut {
  using type = WideRoots<M>;
};
template <>
struct SweepOut<8> {
  using type = uint32_t[kSweepSteps];
};

// Steps 5 to 9 for a row whose locator el of degree deg >= 1 the warp
// swept into hits: returns ok, gives *corrected the count, and hands each
// correction the XLA path would make to apply(j, c), symbol j of the word
// (size data symbols, then nr parity symbols) XORed with the symbol c.
template <int M, bool ERASURE, class Apply>
__device__ __forceinline__ bool finish_row(const ParamsT<M>& p, const galois::Tables<M>& gf,
                                           const int* sec, const int* inv, const int* va,
                                           const Sym<M>* S, const Sym<M>* el, int deg,
                                           const typename SweepOut<M>::type& hits, long long row,
                                           Apply apply, int* corrected) {
  constexpr int kFs = Field<M>::kFs;
  const int nr = p.nr, size = p.size, n = size + nr;
  const int pad = kFs - n;
  *corrected = 0;

  // 5. (the owner's part) The roots in scan order, their locations, and
  //    fail_pad: a location in the pad region.
  Sym<M> root[kMaxRoots], loc[kMaxRoots];
  int found = 0;
  bool fail_pad = false;
  if constexpr (M == 8) {
#pragma unroll
    for (int s = 0; s < kSweepSteps; ++s) {
      for (uint32_t b = hits[s]; b; b &= b - 1) {
        const int i = __ffs(b) + 32 * s;  // lane + 1 + 32 s
        const int k = galois::mod_fs<M>(i * p.prim_inv + kFs - 1);
        root[found] = i;
        loc[found] = k;
        fail_pad |= k < pad;
        ++found;
      }
    }
  } else {
    // the sweep saw the word's locations alone
    found = hits.found;
    for (int t = 0; t < found && t < deg; ++t) {
      root[t] = hits.root[t];
      loc[t] = hits.loc[t];
    }
  }
  if (found != deg || fail_pad) return false;  // word untouched

  // 6. Omega = S * el mod x^nr, degree < deg.
  Sym<M> om[kMaxRoots];
  for (int i = 0; i < deg; ++i) {
    int o = 0;
    for (int j = 0; j <= i; ++j) o ^= gf.mul(el[j], S[i - j]);
    om[i] = o;
  }

  // 7. Forney: num * sec[root] * inv[den], inv[0] = 1.
  Sym<M> coef[kMaxRoots];
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
    const int32_t* pos = p.eras_pos + row * p.eras_width;
    const int width = p.eras_width < nr ? p.eras_width : nr;
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
      apply(pt, sum & 0xFF);
    }
    return true;
  }
  // The C applies in order and stops at the first location outside the
  // word, keeping what it already applied (fail_apply).
  for (int t = 0; t < deg; ++t) {
    const int lp = loc[t] - pad;
    if (lp < 0 || lp >= n) return false;
    apply(lp, coef[t]);
  }
  return true;
}

// 16-byte loads a thread has in flight at once in the two copies below:
// each batch is loaded whole before any of it is stored, since the
// compiler cannot tell that the stores miss the loads' source.  The rows'
// copy runs beside the per-row state (4 took 69 registers in place of
// 56, and two blocks an SM); the syndromes' before it, where 8 at nr = 32
// is a thread's whole share in one batch.
constexpr int kCopyBatch = 2;
constexpr int kSynBatch = 8;

// Copies bytes [0, total) of src to dst with the block's kThreads threads,
// 16 bytes a load and a store: dst's bytes before its first 16-byte
// boundary and after its last go one at a time, and each 16 bytes of dst
// between is built from the two 16-byte words of src that hold it, by a
// funnel shift where src lies otherwise than dst modulo 16.
template <int NT>
__device__ __forceinline__ void copy_through(const uint8_t* src, uint8_t* dst, int total, int t) {
  int head = (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15);
  if (head > total) head = total;
  const int vecs = (total - head) >> 4;
  const int tail = head + (vecs << 4);
  for (int i = t; i < head; i += NT) dst[i] = src[i];
  for (int i = tail + t; i < total; i += NT) dst[i] = src[i];
  const uintptr_t at = reinterpret_cast<uintptr_t>(src + head);
  const int shift = (int)(at & 15);
  const uint4* vs = reinterpret_cast<const uint4*>(at - shift);
  uint4* vd = reinterpret_cast<uint4*>(dst + head);
  if (shift == 0) {
    for (int k0 = t; k0 < vecs; k0 += kCopyBatch * NT) {
      uint4 v[kCopyBatch];
#pragma unroll
      for (int u = 0; u < kCopyBatch; ++u)
        if (k0 + u * NT < vecs) v[u] = vs[k0 + u * NT];
#pragma unroll
      for (int u = 0; u < kCopyBatch; ++u)
        if (k0 + u * NT < vecs) vd[k0 + u * NT] = v[u];
    }
    return;
  }
  // vd[k] is bytes shift..shift+15 of vs[k], vs[k + 1]: words q..q+4 of
  // the pair, shifted right by sh bits (q uniform, so selects, not an
  // indexed local array)
  const int q = shift >> 2;
  const uint32_t sh = 8 * (shift & 3);
  for (int k0 = t; k0 < vecs; k0 += kCopyBatch * NT) {
    uint4 a[kCopyBatch], b[kCopyBatch];
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int k = k0 + u * NT;
      if (k < vecs) {
        a[u] = vs[k];
        b[u] = vs[k + 1];
      }
    }
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int k = k0 + u * NT;
      if (k >= vecs) continue;
      const uint32_t w[8] = {a[u].x, a[u].y, a[u].z, a[u].w, b[u].x, b[u].y, b[u].z, b[u].w};
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = q == 0 ? w[j] : q == 1 ? w[j + 1] : q == 2 ? w[j + 2] : w[j + 3];
        const uint32_t hi = q == 0 ? w[j + 1] : q == 1 ? w[j + 2] : q == 2 ? w[j + 3] : w[j + 4];
        o[j] = __funnelshift_r(lo, hi, sh);
      }
      vd[k] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// Turns the block's log-form syndromes, rows x nr int32 at src, into
// symbols, row r at syn + r * syndrome_stride(nr * sizeof(Sym)) bytes, with
// 16-byte loads from src's first 16-byte boundary (the ints before it and
// after the last whole 16 bytes one at a time).  Step 1's rules: S_i =
// antilog[v] for a log v in [0, fs] and 0 outside it; err[r] is set for a
// row with any v != fs (the sentinel fs = no error), so that a log outside
// the range still counts as an error.
template <int M>
__device__ __forceinline__ void stage_syndromes(const int32_t* src, int nr, int rows,
                                                const int* antilog, uint8_t* syn,
                                                uint8_t* err) {
  constexpr int kFs = Field<M>::kFs;
  const int tid = threadIdx.x;
  const int total = rows * nr;
  const int stride = syndrome_stride(nr * (int)sizeof(Sym<M>));
  // row of element e < 2^16: (e m) >> 32, m = 2^32 / nr + 1 (exact: e (m nr
  // - 2^32) <= e nr < 2^32)
  const unsigned long long m = (1ull << 32) / (unsigned)nr + 1;
  const auto put = [&](int e, int v) {
    const int r = (int)(((unsigned long long)e * m) >> 32);
    reinterpret_cast<Sym<M>*>(syn + r * stride)[e - r * nr] =
        (Sym<M>)((v >= 0 && v <= kFs) ? antilog[v] : 0);
    if (v != kFs) err[r] = 1;
  };
  int head = (int)(((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) >> 2);
  if (head > total) head = total;
  const int vecs = (total - head) >> 2;
  const int tail = head + (vecs << 2);
  for (int e = tid; e < head; e += kThreads) put(e, src[e]);
  for (int e = tail + tid; e < total; e += kThreads) put(e, src[e]);
  const int4* vs = reinterpret_cast<const int4*>(src + head);
  for (int k0 = tid; k0 < vecs; k0 += kSynBatch * kThreads) {
    int4 v[kSynBatch];
#pragma unroll
    for (int u = 0; u < kSynBatch; ++u)
      if (k0 + u * kThreads < vecs) v[u] = vs[k0 + u * kThreads];
#pragma unroll
    for (int u = 0; u < kSynBatch; ++u) {
      const int k = k0 + u * kThreads;
      if (k >= vecs) continue;
      const int e = head + 4 * k;
      put(e, v[u].x);
      put(e + 1, v[u].y);
      put(e + 2, v[u].z);
      put(e + 3, v[u].w);
    }
  }
}

template <int M, bool ERASURE>
__global__ void __launch_bounds__(kThreads, 8) rs_decode_kernel(const ParamsT<M> p) {
  constexpr int kFs = Field<M>::kFs;
  constexpr int kTable = Field<M>::kTable;
  __shared__ int s_tab[4 * kTable];
  __shared__ int s_va[kMaxRoots];
  __shared__ uint8_t s_err[kThreads];
  extern __shared__ __align__(16) uint8_t s_syn[];  // [kThreads][syndrome_stride(nr * sizeof(Sym))]

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kThreads;
  const long long left = p.batch - row0;
  const int rows = left < kThreads ? (int)left : kThreads;
  const int size = p.size, nr = p.nr;

  for (int i = tid; i < 4 * kTable; i += kThreads) s_tab[i] = p.tables[i];
  // verify-stage row constants a_i = ((fcr + i) * prim) mod fs
  for (int i = tid; i < nr; i += kThreads) s_va[i] = ((p.fcr + i) * p.prim) % kFs;
  s_err[tid] = 0;
  __syncthreads();  // tables in, flags cleared
  stage_syndromes<M>(p.s_log + row0 * nr, nr, rows, s_tab + kTable, s_syn, s_err);
  __syncthreads();  // syndromes in

  // Every thread goes through the Chien sweep, those past the last row
  // too: it is the whole warp's.
  const galois::Tables<M> gf{s_tab, s_tab + kTable};
  const bool live = tid < rows;
  const long long row = row0 + tid;
  const Sym<M>* S = reinterpret_cast<const Sym<M>*>(
      s_syn + tid * syndrome_stride(nr * (int)sizeof(Sym<M>)));
  Sym<M> el[kMaxRoots + 1];
  const bool has_err = live && s_err[tid];
  int deg = 0;
  if (has_err) deg = locate_row<M, ERASURE>(p, gf, s_tab + 3 * kTable, row, S, el);
  typename SweepOut<M>::type hits;
  chien_sweep(p, gf, el, deg, hits);
  // The warp's rows copied through: a warp past the last row has none.
  const int lane = tid & 31;
  const int wrow = tid - lane;
  const int wrows = rows - wrow < 32 ? (rows - wrow > 0 ? rows - wrow : 0) : 32;
  constexpr int kSymBytes = (int)sizeof(Sym<M>);
  copy_through<32>(reinterpret_cast<const uint8_t*>(p.data + (row0 + wrow) * size),
                   reinterpret_cast<uint8_t*>(p.data_out + (row0 + wrow) * size),
                   wrows * size * kSymBytes, lane);
  copy_through<32>(reinterpret_cast<const uint8_t*>(p.parity + (row0 + wrow) * nr),
                   reinterpret_cast<uint8_t*>(p.parity_out + (row0 + wrow) * nr),
                   wrows * nr * kSymBytes, lane);
  __syncwarp();
  if (live) {
    bool ok = !has_err;  // no syndrome errors, or (degree 0) fail_deg
    int corrected = 0;
    if (deg > 0) {
      const Sym<M>* din = p.data + row * size;
      const Sym<M>* pin = p.parity + row * nr;
      Sym<M>* dout = p.data_out + row * size;
      Sym<M>* pout = p.parity_out + row * nr;
      // the input symbol XOR c over the copy, which __syncwarp put before this
      const auto fix = [=](int j, int c) {
        if (j < size)
          dout[j] = din[j] ^ c;
        else
          pout[j - size] = pin[j - size] ^ c;
      };
      ok = finish_row<M, ERASURE>(p, gf, s_tab + 2 * kTable, s_tab + 3 * kTable, s_va, S, el, deg,
                                  hits, row, fix, &corrected);
    }
    p.ok_out[row] = ok;
    p.corrected_out[row] = corrected;
  }
}

// ---------------------------------------------------------------- syndromes

constexpr int kSynThreads = 256;   // codewords a tile, and threads a block, of the syndrome kernel
constexpr int kFactorRoots = 16;   // roots of g(x) a factor: a remainder of 16 bytes
constexpr int kTailEntries = kFactorRoots * 2 * 16;   // the tail's nibble tables, 16 bytes an entry
constexpr int kFactorEntries = 256 + kTailEntries;    // a factor's entries: T, then the tail
constexpr int kCopies = 8;         // copies of T, a lane of each 8-lane phase its own
// A tile's buffer: its data rows, then its parity rows, each packed as in
// device memory from the 16-byte boundary at or below its first byte, with
// room for that head, the last 16 bytes and a word read past a row's end.
constexpr int kSynBuffer = kSynThreads * kFs + 96;

struct SynParams {
  const uint8_t* data;    // [B, size]
  const uint8_t* parity;  // [B, nr]
  const uint4* tables;    // [F][kFactorEntries] (models/rs_cuda.py syndrome_tables)
  const int32_t* log;     // [256] value -> log, log[0] = fs
  int32_t* s_log_out;     // [B, nr]
  int batch, size, nr;
  int copies;             // 1 or kCopies
};

// Dynamic shared bytes of a block: T (copies of each entry), the tails, a
// byte log table, two tile buffers.
constexpr int syndrome_smem(int factors, int copies) {
  return factors * (256 * copies + kTailEntries) * 16 + 256 + 2 * kSynBuffer;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for this thread's copies but those of the last group committed.
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Starts the copy of the 16-byte words that hold src[0, bytes) to dst, a
// word a thread at a time: src[0] lands at dst + (src mod 16).
__device__ __forceinline__ void stage_async(const uint8_t* src, long long bytes, uint8_t* dst) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
  const uintptr_t a1 = (reinterpret_cast<uintptr_t>(src) + bytes + 15) & ~uintptr_t(15);
  const int words = (int)((a1 - a0) >> 4);
  for (int i = threadIdx.x; i < words; i += kSynThreads)
    cp_async16(dst + 16 * i, reinterpret_cast<const void*>(a0 + 16 * i));
}

// Where a tile's parity rows start in its buffer.
__device__ __forceinline__ int parity_base(int size) {
  return (kSynThreads * size + 47) & ~15;
}

// Starts the copy of tile `tile`'s rows into buf.
__device__ __forceinline__ void stage_tile(const SynParams& p, long long tile, uint8_t* buf) {
  const long long row0 = tile * kSynThreads;
  const long long left = p.batch - row0;
  const int rows = left < kSynThreads ? (int)left : kSynThreads;
  stage_async(p.data + row0 * p.size, (long long)rows * p.size, buf);
  stage_async(p.parity + row0 * p.nr, (long long)rows * p.nr, buf + parity_base(p.size));
}

// One step of the division of every factor's remainder R (byte b of the
// four words the coefficient of x^b) by its h_f: R = x R + v - top h_f,
// v the symbol in byte e of x (sel = 0x6540 | e), top R's x^15 byte.  T
// holds top (h_f - x^16) at entry f * 256 + top, `copies` apart.
template <int F>
__device__ __forceinline__ void divide_step(uint32_t (&R)[F][4], const uint4* t, int copies,
                                            uint32_t x, uint32_t sel) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const uint32_t top = R[f][3] >> 24;
    R[f][3] = __funnelshift_l(R[f][2], R[f][3], 8);
    R[f][2] = __funnelshift_l(R[f][1], R[f][2], 8);
    R[f][1] = __funnelshift_l(R[f][0], R[f][1], 8);
    R[f][0] = __byte_perm(x, R[f][0], sel);
    const uint4 v = t[(f * 256 + (int)top) * copies];
    R[f][0] ^= v.x;
    R[f][1] ^= v.y;
    R[f][2] ^= v.z;
    R[f][3] ^= v.w;
  }
}

// Divides by the remainders the `len` symbols at `row` in shared memory
// (any alignment), read a word at a time from the word at or below it.
template <int F>
__device__ __forceinline__ void divide_row(uint32_t (&R)[F][4], const uint4* t, int copies,
                                           const uint8_t* row, int len) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(reinterpret_cast<uintptr_t>(row) & ~uintptr_t(3));
  const uint32_t sh = 8 * (reinterpret_cast<uintptr_t>(row) & 3);
  uint32_t lo = w[0];
  int j = 0;
  for (; j + 4 <= len; j += 4) {
    const uint32_t hi = w[(j >> 2) + 1];
    const uint32_t x = __funnelshift_r(lo, hi, sh);  // row[j .. j + 3]
    lo = hi;
#pragma unroll
    for (int e = 0; e < 4; ++e) divide_step<F>(R, t, copies, x, 0x6540u | e);
  }
  const uint32_t x = __funnelshift_r(lo, w[(j >> 2) + 1], sh);
  for (int e = 0; j < len; ++j, ++e) divide_step<F>(R, t, copies, x >> (8 * e), 0x6540u);
}

// Persistent blocks, one thread a codeword: each block stages the tables
// once, then takes tiles of kSynThreads rows in turn, the next tile's rows
// copied in (cp.async) while this one's are divided.  A thread divides its
// row by the F factors of g(x), a byte a step, then evaluates each
// remainder at the factor's roots with the tail's nibble tables: S_{16f+j}
// is byte j of factor f's sum.  The block then writes the tile's log[S_i]
// as bytes over its buffer and copies them out as int32, 16 bytes a
// thread.
template <int F>
__global__ void __launch_bounds__(kSynThreads, 1) rs_syndrome_kernel(const SynParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int copies = p.copies;
  uint4* s_t = reinterpret_cast<uint4*>(smem);                   // [F][256][copies]
  uint4* s_tail = s_t + F * 256 * copies;                         // [F][16][2][16]
  uint8_t* s_logt = reinterpret_cast<uint8_t*>(s_tail + F * kTailEntries);  // [256]
  uint8_t* s_buf = s_logt + 256;                                  // [2][kSynBuffer]

  const int tid = threadIdx.x;
  const long long tiles = (p.batch + kSynThreads - 1) / kSynThreads;
  if (blockIdx.x < tiles) stage_tile(p, blockIdx.x, s_buf);
  cp_async_commit();
  for (int i = tid; i < F * 256 * copies; i += kSynThreads) {
    const int e = i / copies;  // entry f * 256 + v
    s_t[i] = p.tables[(e >> 8) * kFactorEntries + (e & 255)];
  }
  for (int i = tid; i < F * kTailEntries; i += kSynThreads)
    s_tail[i] = p.tables[(i / kTailEntries) * kFactorEntries + 256 + i % kTailEntries];
  for (int i = tid; i < 256; i += kSynThreads) s_logt[i] = (uint8_t)p.log[i];

  const int size = p.size, nr = p.nr;
  const uint4* t = s_t + (tid & (copies - 1));  // the lane's copy
  int k = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, k ^= 1) {
    uint8_t* buf = s_buf + k * kSynBuffer;
    if (tile + gridDim.x < tiles) stage_tile(p, tile + gridDim.x, s_buf + (k ^ 1) * kSynBuffer);
    cp_async_commit();
    cp_async_wait_all_but_last();
    __syncthreads();  // this tile's rows (and, the first time, the tables) in

    const long long row0 = tile * kSynThreads;
    const long long left = p.batch - row0;
    const int rows = left < kSynThreads ? (int)left : kSynThreads;
    uint32_t L[F][4] = {};  // log[S_{16f + 4q + c}] in byte c of L[f][q]
    if (tid < rows) {
      const int dhead = (int)(reinterpret_cast<uintptr_t>(p.data + row0 * size) & 15);
      const int phead = (int)(reinterpret_cast<uintptr_t>(p.parity + row0 * nr) & 15);
      uint32_t R[F][4] = {};
      divide_row<F>(R, t, copies, buf + dhead + tid * size, size);
      divide_row<F>(R, t, copies, buf + parity_base(size) + phead + tid * nr, nr);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const uint4* tail = s_tail + f * kTailEntries;
        uint32_t acc[4] = {};
#pragma unroll
        for (int b = 0; b < kFactorRoots; ++b) {
          const uint32_t byte = R[f][b >> 2] >> (8 * (b & 3));
          const uint4 lo = tail[2 * b * 16 + (byte & 15)];
          const uint4 hi = tail[(2 * b + 1) * 16 + ((byte >> 4) & 15)];
          acc[0] ^= lo.x ^ hi.x;
          acc[1] ^= lo.y ^ hi.y;
          acc[2] ^= lo.z ^ hi.z;
          acc[3] ^= lo.w ^ hi.w;
        }
#pragma unroll
        for (int c = 0; c < kFactorRoots; ++c)
          L[f][c >> 2] |= (uint32_t)s_logt[(acc[c >> 2] >> (8 * (c & 3))) & 0xFF] << (8 * (c & 3));
      }
    }
    __syncthreads();  // every row read: the buffer takes the logs, [rows][nr] bytes

    if (tid < rows) {
      uint8_t* out = buf + tid * nr;
      if ((nr & 3) == 0) {
#pragma unroll
        for (int q = 0; q < 4 * F; ++q)
          if (4 * q < nr) reinterpret_cast<uint32_t*>(out)[q] = L[q >> 2][q & 3];
      } else {
#pragma unroll
        for (int c = 0; c < 16 * F; ++c)
          if (c < nr) out[c] = (uint8_t)(L[c >> 4][(c >> 2) & 3] >> (8 * (c & 3)));
      }
    }
    __syncthreads();

    // the tile's logs as int32, 16 bytes a thread where the output allows
    int32_t* dst = p.s_log_out + row0 * nr;
    const int total = rows * nr;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      done = total & ~3;
      for (int i = 4 * tid; i < done; i += 4 * kSynThreads) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(buf + i);
        *reinterpret_cast<int4*>(dst + i) =
            make_int4((int)(w & 0xFF), (int)(w >> 8 & 0xFF), (int)(w >> 16 & 0xFF), (int)(w >> 24));
      }
    }
    for (int i = done + tid; i < total; i += kSynThreads) dst[i] = buf[i];
    __syncthreads();  // the buffer read out: the next tile but one may fill it
  }
}

// The syndrome kernel for nr roots: F = ceil(nr / 16) factors.
inline const void* syndrome_kernel(int nr) {
  switch ((nr + kFactorRoots - 1) / kFactorRoots) {
    case 1: return reinterpret_cast<const void*>(rs_syndrome_kernel<1>);
    case 2: return reinterpret_cast<const void*>(rs_syndrome_kernel<2>);
    case 3: return reinterpret_cast<const void*>(rs_syndrome_kernel<3>);
    default: return reinterpret_cast<const void*>(rs_syndrome_kernel<4>);
  }
}

// ----------------------------------------------------------- wide syndromes
//
// The syndromes of rows of 16-bit symbols (m = 10, models/rs_cuda.py
// `WIDE_M`), the byte kernel's division by the factors of g(x) with a
// ten-bit step: factor f divides by h_f(x) = x^(16 - r_f) g_f(x), monic of
// degree 16, keeping the remainder's 16 coefficients packed ten bits each,
// coefficient c at bits 10 c .. 10 c + 9 of five registers.  A step takes
// the top coefficient (bits 150..159), shifts the five words up ten bits
// by funnel shifts with the symbol entering at the bottom, and XORs in
// T_f[top] = top (h_f - x^16).  T_f is GF(2)-linear in top, so for top =
// 32 a + b it is A_f[a] ^ B_f[b], A_f[a] = T_f[32 a] and B_f[b] = T_f[b]:
// two half tables of 32 entries of five words, small enough for a copy a
// lane.  Word q of entry e of lane l's copy of a half lies at word (32 q
// + e) 32 + l, so lane l reads bank l whatever the entries: ten 32-bit
// loads a factor step, one wavefront each, 20 a warp and symbol at nr =
// 30, where one 1,024-entry T of 32-byte entries, too large for lane
// copies, took about 37 conflicted ones; and five 3-input XORs where
// there were eight.  (`kWideLoadWords` = 2 is the other layout: lanes l
// and l + 16 share a copy, entries padded to six words, three 64-bit
// loads a half, conflict-free within each half-warp: 24 wavefronts and
// half the shared memory; chip_smoke.py phase 16 times the two.)  Each
// block builds its lane copies, 40 KB a factor, from the host's compact
// half tables ([F][2][32][5] words, `wide_syndrome_tables`) before its
// first row.  The tail evaluates each remainder at its factor's roots on
// log tables: S_i = XOR_b antilog[log R_b + va_i b], an antilog table
// thrice over whose last third is zero and the log of zero 2 fs, so that
// no term branches.  What bounds it: shared-memory wavefronts, 20 a warp
// and symbol for T; then the step's integer issue, about 16 cycles a warp
// and symbol an SM; then the rows' 16-byte loads and the tail.  At B =
// 131072 KP4 rows (nr = 30; H100 80GB HBM3, 700 W): 0.284 ms, about 33
// cycles a warp and symbol an SM at 1.98 GHz, where the 1,024-entry T
// took 0.47 ms (49 cycles); the 64-bit layout 0.31-0.32 ms.  Each
// thread reads its own row from device memory, 16 bytes at a time where
// aligned; the L1 holds a warp's 32 rows' lines while it divides them, so
// a block asks for two blocks an SM, not three: the launcher sets the
// carveout to the least that holds two (`pp_rs_syndrome_shape`), and the
// rest of the SM's 256 KB is L1.  Where two do not fit (F = 3 and 4,
// nr > 32), the occupancy calculator gives one.  Persistent blocks, one
// thread a row, rows a grid apart.

constexpr int kWideM = 10;
constexpr int kWideFs = Field<kWideM>::kFs;
constexpr int kWideTable = Field<kWideM>::kTable;
constexpr int kWideSynThreads = 256;   // threads a block of the wide syndrome kernel
constexpr int kWideSynBlocks = 2;      // blocks an SM it asks for
constexpr int kWideWords = 5;          // words of a packed remainder or table entry: 16 x 10 bits
constexpr int kWideEntries = 32;       // entries of a half table: a 5-bit half of the top
constexpr int kWideLoadWords = 1;      // words a lane's table load: 1, a copy a lane; 2, a copy a lane pair
constexpr int kWideLoads = (kWideWords + kWideLoadWords - 1) / kWideLoadWords;  // loads an entry
constexpr int kWideCopies = 32 / kWideLoadWords;                  // lane copies of a half table
constexpr int kWideEntryWords = kWideCopies * kWideLoadWords;     // 32: entry e's loads at 32 e
constexpr int kWideLoadStride = kWideEntries * kWideEntryWords;   // 1,024: load l's at 1,024 l
constexpr int kWideHalfWords = kWideLoads * kWideLoadStride;      // a half table's copies

struct WideSynParams {
  const uint16_t* data;    // [B, size]
  const uint16_t* parity;  // [B, nr]
  const uint32_t* tables;  // models/rs_cuda.py wide_syndrome_tables
  int32_t* s_log_out;      // [B, nr]
  int batch, size, nr;
};

// The host's tables: the compact half tables [F][2][32][5] words, then the
// antilog table thrice over and the log table (uint16 each, the log of
// zero 2 fs), and va_i b mod fs [nr][16] (uint16), the tail's.
__host__ __device__ constexpr int wide_half_bytes(int factors) {
  return factors * 2 * kWideEntries * kWideWords * 4;
}
__host__ __device__ constexpr int wide_tail_bytes(int nr) {
  return 4 * kWideTable * 2 + nr * kFactorRoots * 2;
}

// The wide kernel's dynamic shared bytes: the half tables' lane copies
// [F][2][kWideLoads][32 entries][kWideCopies][kWideLoadWords] words, then
// the tail's tables as the host lays them out.
__host__ __device__ constexpr int wide_syndrome_smem(int factors, int nr) {
  return factors * 2 * kWideHalfWords * 4 + wide_tail_bytes(nr);
}

// The five words of a half table's entry from the lane's copy at `at`.
__device__ __forceinline__ void wide_entry(const uint32_t* at,
                                           uint32_t (&w)[kWideLoads * kWideLoadWords]) {
#pragma unroll
  for (int l = 0; l < kWideLoads; ++l) {
    if constexpr (kWideLoadWords == 1) {
      w[l] = at[l * kWideLoadStride];
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(at + l * kWideLoadStride);
      w[2 * l] = u.x;
      w[2 * l + 1] = u.y;
    }
  }
}

// One step of every factor's division: R = x R + v - top h_f.  t is the
// lane's copy of the half tables.
template <int F>
__device__ __forceinline__ void divide_step_wide(uint32_t (&R)[F][kWideWords], const uint32_t* t,
                                                 uint32_t v) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const uint32_t top = R[f][kWideWords - 1] >> (32 - kWideM);  // bits 150..159
#pragma unroll
    for (int q = kWideWords - 1; q > 0; --q) R[f][q] = __funnelshift_l(R[f][q - 1], R[f][q], kWideM);
    R[f][0] = R[f][0] << kWideM | v;
    uint32_t a[kWideLoads * kWideLoadWords], b[kWideLoads * kWideLoadWords];
    wide_entry(t + 2 * f * kWideHalfWords + (int)(top >> 5) * kWideEntryWords, a);
    wide_entry(t + (2 * f + 1) * kWideHalfWords + (int)(top & 31) * kWideEntryWords, b);
#pragma unroll
    for (int q = 0; q < kWideWords; ++q) R[f][q] ^= a[q] ^ b[q];
  }
}

// Divides by the remainders the `len` symbols at src (device memory, 2-byte
// aligned), each cut to its m bits as the plain version's `& fs` does:
// 16 bytes a load from src's first 16-byte boundary, the symbols before it
// and after the last whole 16 bytes one at a time.
template <int F>
__device__ __forceinline__ void divide_row_wide(uint32_t (&R)[F][kWideWords], const uint32_t* t,
                                                const uint16_t* src, int len) {
  int j = 0;
  for (; j < len && (reinterpret_cast<uintptr_t>(src + j) & 15); ++j)
    divide_step_wide<F>(R, t, src[j] & kWideFs);
  const uint4* v = reinterpret_cast<const uint4*>(src + j);
  for (; j + 8 <= len; j += 8, ++v) {
    const uint4 x = __ldg(v);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      divide_step_wide<F>(R, t, w[q] & kWideFs);
      divide_step_wide<F>(R, t, (w[q] >> 16) & kWideFs);
    }
  }
  for (; j < len; ++j) divide_step_wide<F>(R, t, src[j] & kWideFs);
}

// Coefficient b of a packed remainder: bits 10 b .. 10 b + 9.
__device__ __forceinline__ uint32_t wide_coef(const uint32_t (&r)[kWideWords], int b) {
  const int q = kWideM * b / 32, sh = kWideM * b % 32;
  const uint32_t x = sh + kWideM <= 32 ? r[q] >> sh
                                       : __funnelshift_r(r[q], r[q + 1 < kWideWords ? q + 1 : q], sh);
  return x & kWideFs;
}

template <int F>
__global__ void __launch_bounds__(kWideSynThreads, kWideSynBlocks)
    rs_syndrome_wide_kernel(const WideSynParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_t = reinterpret_cast<uint32_t*>(smem);              // the half tables' copies
  uint8_t* s_tail = smem + F * 2 * kWideHalfWords * 4;
  const uint16_t* s_alog = reinterpret_cast<const uint16_t*>(s_tail);  // [3][2^m]
  const uint16_t* s_log = s_alog + 3 * kWideTable;                     // [2^m]
  const uint16_t* s_exp = s_log + kWideTable;                          // [nr][16]

  const int tid = threadIdx.x;
  const int nr = p.nr, size = p.size;
  // word w of copy c of entry e of half h (f's A, then its B) from the
  // compact tables; a layout of two words a load pads entries to six
  for (int i = tid; i < F * 2 * kWideHalfWords; i += kWideSynThreads) {
    const int h = i / kWideHalfWords, r = i % kWideHalfWords;
    const int e = r % kWideLoadStride / kWideEntryWords;
    const int w = r / kWideLoadStride * kWideLoadWords + r % kWideLoadWords;
    s_t[i] = w < kWideWords ? p.tables[(h * kWideEntries + e) * kWideWords + w] : 0u;
  }
  const uint4* tail = reinterpret_cast<const uint4*>(p.tables + wide_half_bytes(F) / 4);
  for (int i = tid; i < wide_tail_bytes(nr) / 16; i += kWideSynThreads)
    reinterpret_cast<uint4*>(s_tail)[i] = tail[i];
  __syncthreads();  // tables in

  const uint32_t* t = s_t + tid % kWideCopies * kWideLoadWords;  // the lane's copy
  for (long long row = (long long)blockIdx.x * kWideSynThreads + tid; row < p.batch;
       row += (long long)gridDim.x * kWideSynThreads) {
    uint32_t R[F][kWideWords] = {};
    divide_row_wide<F>(R, t, p.data + row * size, size);
    divide_row_wide<F>(R, t, p.parity + row * nr, nr);
    int32_t* out = p.s_log_out + row * nr;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      int lr[kFactorRoots];  // log R_b, 2 fs for zero
#pragma unroll
      for (int b = 0; b < kFactorRoots; ++b) lr[b] = s_log[wide_coef(R[f], b)];
      const int roots = nr - kFactorRoots * f < kFactorRoots ? nr - kFactorRoots * f : kFactorRoots;
      for (int j = 0; j < roots; ++j) {
        const uint16_t* ex = s_exp + (kFactorRoots * f + j) * kFactorRoots;
        int acc = 0;
#pragma unroll
        for (int b = 0; b < kFactorRoots; ++b) acc ^= s_alog[lr[b] + ex[b]];
        out[kFactorRoots * f + j] = acc ? s_log[acc] : kWideFs;
      }
    }
  }
}

// The wide syndrome kernel for nr roots: F = ceil(nr / 16) factors.
inline const void* wide_syndrome_kernel(int nr) {
  switch ((nr + kFactorRoots - 1) / kFactorRoots) {
    case 1: return reinterpret_cast<const void*>(rs_syndrome_wide_kernel<1>);
    case 2: return reinterpret_cast<const void*>(rs_syndrome_wide_kernel<2>);
    case 3: return reinterpret_cast<const void*>(rs_syndrome_wide_kernel<3>);
    default: return reinterpret_cast<const void*>(rs_syndrome_wide_kernel<4>);
  }
}

#ifndef PP_RS_STAMPED  // the stamped copy of rs_kernel.py --breakdown times the decode kernel alone

// ------------------------------------------------------------------ stripes
//
// Rebuilds the lost cells of shard-major stripes: cells [n, L], byte t of
// every cell one codeword (column t), with the same e cells lost in every
// column, in one launch (`Codec.reconstruct`).  It computes, column for
// column, what the erasure decode of the rows cells[:, t] with the lost
// cells zeroed and named as erasures computes (models/rs.py
// `_reconstruct`): ok, the count, and the lost cells' bytes of the
// codeword it finds, each coefficient at its own location, parity cells
// as well as data cells.  It
// replaces no TPU kernel: the JAX package has no such entry, and the row
// API would take two transposes of the group and an erasure list a row.
//
// What bounds it: HBM.  A column's n - e surviving bytes are read once
// and e + 2 bytes written; at n = 14 that is a few operations a byte, far
// under the card's integer rate.
//
// - The erasure-only columns take a map fixed by the pattern.  With every
//   error among the erasures, BM leaves the erasure locator as it is (its
//   discrepancies are the Forney syndromes T_r, r = e..nr-1, all zero), so
//   Chien, Forney and the verify give the same roots, the same
//   coefficients as a linear function of the syndromes, and a pass.  The
//   host works that out once a pattern (models/rs_cuda.py
//   `stripe_plan`), checks it on the e unit errors that span such
//   columns, and packs, for each surviving cell, the map from its byte to
//   the nr outputs (the e coefficients, the t-th that of the t-th lost
//   cell named, then T_e..T_{nr-1}) as two 16-entry tables, low and high
//   nibble, of 32-bit words (nr <= 4).  A column's outputs are the XOR of
//   2 (n - e) lookups; a lost cell reads as zero, so its coefficient is
//   its byte.
// - Each block stages the tables once in shared memory, a copy of every
//   entry for each lane, so that the 32 lanes' lookups fall in 32 banks;
//   the blocks are persistent and walk the columns in chunks of 4,096, a
//   thread 16 adjacent columns, read with one 16-byte load a surviving
//   cell (coalesced: adjacent codewords are adjacent bytes) where L and
//   the cells' address allow it, else a byte at a time, 256 columns apart.
// - Any other column (T not zero: errors among the survivors) goes through
//   the decode kernel's own steps, `locate_row`, `chien_sweep` and
//   `finish_row`, on its bytes read again, a column a thread at a time and
//   the warp's lanes together for the sweep, and the coefficients applied
//   at their locations (finish_row's plain form).  So does every column
//   where the plan cannot hold (nr > 4, tables past shared memory, or a
//   pattern the check refuses).
// - `failed` is counted here: a count a block, and the last block to end
//   (by a ticket in `work`, reset by that block) sums them.  No second
//   launch, no host sync.

constexpr int kStripeThreads = 256;
constexpr int kStripeCols = 16;          // columns a thread a chunk
constexpr int kNibbleWords = 16 * 32;    // a nibble table: 16 entries, a copy a lane

struct StripeParams {
  const uint8_t* cells;      // [n, L], shard-major
  const int32_t* lost;       // [e] lost cells, in the caller's order
  const int32_t* surv;       // [n_surv] the other cells, ascending
  const uint32_t* nibbles;   // [n_surv][2][16]: outputs of a low, a high nibble
  const int32_t* tables;     // [4, 256]: log, antilog, sec, inv
  uint8_t* rebuilt;          // [e, L]
  uint8_t* ok_out;           // [L] bool
  uint8_t* corrected_out;    // [L]
  int32_t* failed_out;       // [] columns not ok
  int32_t* work;             // [1 + grid]: the ticket, then a count a block
  long long L;
  int n, e, n_surv, nr, fcr, prim, prim_inv;
  int fast;                  // 1: erasure-only columns take the tables
  uint32_t tmask;            // output bytes e..nr-1: the Forney syndromes
};

// Shared memory before the tables: GF tables, va, lost, survivors, count.
constexpr int kStripeFixedInts = 4 * 256 + 2 * kMaxRoots + 256 + 4;

// The column's byte of slot c: 16 adjacent columns a thread (VEC), or
// every kStripeThreads-th.
template <bool VEC>
__device__ __forceinline__ long long stripe_column(long long base, int c) {
  return VEC ? base + threadIdx.x * kStripeCols + c
             : base + (long long)c * kStripeThreads + threadIdx.x;
}

// acc ^= the outputs of byte x through a survivor's tables (lane's copies).
__device__ __forceinline__ uint32_t nibble_map(const uint32_t* tab, uint32_t x) {
  return tab[(x & 15) << 5] ^ tab[kNibbleWords + ((x >> 4 & 15) << 5)];
}

// The erasure-only map over the chunk's columns: writes their outputs and
// returns the slots whose T is not zero (or whose column lies past L).
template <bool VEC>
__device__ __forceinline__ uint32_t stripe_map(const StripeParams& p, const int* surv,
                                               const uint32_t* nib, long long base) {
  const long long L = p.L;
  uint32_t acc[kStripeCols];
#pragma unroll
  for (int c = 0; c < kStripeCols; ++c) acc[c] = 0;
  uint32_t live = 0;
  if (VEC) {
    const long long col0 = stripe_column<true>(base, 0);
    if (col0 >= L) return 0;  // L is a multiple of 16: the whole group or none
    live = 0xFFFFu;
    const uint8_t* src = p.cells + col0;
    int r = 0;
    for (; r + 4 <= p.n_surv; r += 4) {
      uint4 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = __ldcs(reinterpret_cast<const uint4*>(src + (long long)surv[r + q] * L));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t* tab = nib + (r + q) * 2 * kNibbleWords;
        const uint32_t w[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
        for (int c = 0; c < kStripeCols; ++c) acc[c] ^= nibble_map(tab, w[c >> 2] >> 8 * (c & 3));
      }
    }
    for (; r < p.n_surv; ++r) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(src + (long long)surv[r] * L));
      const uint32_t* tab = nib + r * 2 * kNibbleWords;
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < kStripeCols; ++c) acc[c] ^= nibble_map(tab, w[c >> 2] >> 8 * (c & 3));
    }
  } else {
#pragma unroll
    for (int c = 0; c < kStripeCols; ++c) {
      const long long col = stripe_column<false>(base, c);
      if (col >= L) continue;
      live |= 1u << c;
      for (int r = 0; r < p.n_surv; ++r)
        acc[c] ^= nibble_map(nib + r * 2 * kNibbleWords, p.cells[(long long)surv[r] * L + col]);
    }
  }

  // Outputs of every live slot; those of the slots returned are written
  // again by stripe_errata, later in this thread.
  const uint32_t emask = p.e >= 4 ? 0xFFFFFFFFu : (1u << 8 * p.e) - 1;
  uint32_t todo = 0, count[kStripeCols];
#pragma unroll
  for (int c = 0; c < kStripeCols; ++c) {
    if (acc[c] & p.tmask) todo |= 1u << c;
    const uint32_t y = acc[c] & emask;
    count[c] = __popc((((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y) & 0x80808080u);
  }
  todo &= live;
  if (VEC) {
    const long long col0 = stripe_column<true>(base, 0);
    for (int t = 0; t < p.e; ++t) {
      const uint32_t sel = t | (t + 4) << 4;
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = __byte_perm(__byte_perm(acc[4 * q], acc[4 * q + 1], sel),
                           __byte_perm(acc[4 * q + 2], acc[4 * q + 3], sel), 0x5410);
      __stcs(reinterpret_cast<uint4*>(p.rebuilt + t * L + col0), make_uint4(w[0], w[1], w[2], w[3]));
    }
    uint32_t cw[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cw[q] = count[4 * q] | count[4 * q + 1] << 8 | count[4 * q + 2] << 16 | count[4 * q + 3] << 24;
    __stcs(reinterpret_cast<uint4*>(p.corrected_out + col0), make_uint4(cw[0], cw[1], cw[2], cw[3]));
    const uint32_t one = 0x01010101u;
    __stcs(reinterpret_cast<uint4*>(p.ok_out + col0), make_uint4(one, one, one, one));
  } else {
#pragma unroll
    for (int c = 0; c < kStripeCols; ++c) {
      if (!(live >> c & 1)) continue;
      const long long col = stripe_column<false>(base, c);
      for (int t = 0; t < p.e; ++t) p.rebuilt[t * L + col] = (uint8_t)(acc[c] >> 8 * t);
      p.corrected_out[col] = (uint8_t)count[c];
      p.ok_out[col] = 1;
    }
  }
  return todo;
}

// The columns of `todo` through the decode kernel's steps 1 to 9, one a
// thread at a time: the column's bytes read again, the lost cells as
// zeros, its syndromes as bytes, and `q`, the
// kernel's parameters for a one-row batch of that row with the lost cells
// as its erasures: located from the erasure locator, and corrected at the
// roots' locations (the plain decode's apply), so that each lost cell
// gets its own coefficient.  Every lane of the warp calls it and goes
// round while any lane has a column left: the sweep is the warp's.
// Returns the columns that are not ok.
template <bool VEC>
__device__ int stripe_errata(const StripeParams& p, const galois::Tables<8>& gf, const int* s_tab,
                             const int* va, const int* lost, const int* ecount, uint32_t todo,
                             long long base) {
  const int n = p.n, nr = p.nr, e = p.e;
  const long long L = p.L;
  int failed = 0;
  while (__any_sync(kFullWarp, todo != 0)) {
    const bool have = todo != 0;
    const long long col = stripe_column<VEC>(base, have ? __ffs(todo) - 1 : 0);
    todo &= todo - 1;
    uint8_t word[kFs], syn[kMaxRoots], lam[kMaxRoots + 1];
    bool fine = true;
    int deg = 0;
    Params q;
    if (have) {
      for (int j = 0; j < n; ++j) word[j] = p.cells[j * L + col];
      for (int t = 0; t < e; ++t) word[lost[t]] = 0;
      // 1. S_i = sum_j r_j alpha^{va_i (n-1-j)}
      for (int i = 0; i < nr; ++i) syn[i] = 0;
      for (int j = 0; j < n; ++j) {
        if (!word[j]) continue;
        const int lx = gf.log[word[j]];
        for (int i = 0; i < nr; ++i) syn[i] ^= gf.antilog[galois::mod_fs<8>(lx + va[i] * (n - 1 - j))];
      }
      for (int i = 0; i < nr; ++i) fine &= syn[i] == 0;
      q.eras_pos = lost;
      q.eras_cnt = ecount;
      q.eras_width = e;
      q.size = n - nr;
      q.nr = nr;
      q.fcr = p.fcr;
      q.prim = p.prim;
      q.prim_inv = p.prim_inv;
      if (!fine) deg = locate_row<8, true>(q, gf, s_tab + 768, 0, syn, lam);
    }
    uint32_t hits[kSweepSteps];
    chien_sweep(q, gf, lam, deg, hits);
    if (have) {
      int count = 0;
      if (deg > 0)
        fine = finish_row<8, false>(q, gf, s_tab + 512, s_tab + 768, va, syn, lam, deg, hits, 0,
                                 [&word](int j, int c) { word[j] ^= c; }, &count);
      for (int t = 0; t < e; ++t) p.rebuilt[t * L + col] = word[lost[t]];
      p.ok_out[col] = fine;
      p.corrected_out[col] = (uint8_t)count;
      failed += !fine;
    }
  }
  return failed;
}

template <bool VEC>
__global__ void __launch_bounds__(kStripeThreads, 4) rs_stripe_kernel(const StripeParams p) {
  extern __shared__ __align__(16) int s_mem[];
  int* s_tab = s_mem;                       // [4 * 256]
  int* s_va = s_tab + 4 * 256;              // [kMaxRoots]
  int* s_lost = s_va + kMaxRoots;           // [kMaxRoots]
  int* s_surv = s_lost + kMaxRoots;         // [256]
  int* s_count = s_surv + 256;              // [4]: e, the block's failed, last block
  uint32_t* s_nib = reinterpret_cast<uint32_t*>(s_mem + kStripeFixedInts);  // [n_surv][2][16][32]

  const int tid = threadIdx.x;
  for (int i = tid; i < 4 * 256; i += kStripeThreads) s_tab[i] = p.tables[i];
  for (int i = tid; i < p.nr; i += kStripeThreads) s_va[i] = ((p.fcr + i) * p.prim) % kFs;
  for (int i = tid; i < p.e; i += kStripeThreads) s_lost[i] = p.lost[i];
  for (int i = tid; i < p.n_surv; i += kStripeThreads) s_surv[i] = p.surv[i];
  if (p.fast)
    for (int i = tid; i < p.n_surv * 2 * kNibbleWords; i += kStripeThreads)
      s_nib[i] = p.nibbles[i >> 5];  // entry i >> 5, in lane (i & 31)'s bank
  if (tid == 0) {
    s_count[0] = p.e;
    s_count[1] = 0;
  }
  __syncthreads();

  const galois::Tables<8> gf{s_tab, s_tab + 256};
  const uint32_t* nib = s_nib + (tid & 31);
  const long long per_chunk = (long long)kStripeThreads * kStripeCols;
  const long long chunks = (p.L + per_chunk - 1) / per_chunk;
  int failed = 0;
  for (long long ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const long long base = ch * per_chunk;
    uint32_t todo = 0;
    if (p.fast) {
      todo = stripe_map<VEC>(p, s_surv, nib, base);
    } else {
      for (int c = 0; c < kStripeCols; ++c)
        if (stripe_column<VEC>(base, c) < p.L) todo |= 1u << c;
    }
    failed += stripe_errata<VEC>(p, gf, s_tab, s_va, s_lost, s_count, todo, base);
  }

  // failed: the block's sum, then the last block's sum of the blocks'
  failed = __reduce_add_sync(kFullWarp, failed);
  if ((tid & 31) == 0 && failed) atomicAdd(s_count + 1, failed);
  __syncthreads();
  if (tid == 0) {
    p.work[1 + blockIdx.x] = s_count[1];
    __threadfence();
    s_count[2] = atomicAdd(p.work, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_count[2]) return;
  __threadfence();
  int sum = 0;
  for (int i = tid; i < (int)gridDim.x; i += kStripeThreads)
    sum += reinterpret_cast<volatile int32_t*>(p.work)[1 + i];
  sum = __reduce_add_sync(kFullWarp, sum);
  if (tid == 0) s_count[3] = 0;
  __syncthreads();
  if ((tid & 31) == 0) atomicAdd(s_count + 3, sum);
  __syncthreads();
  if (tid == 0) {
    *p.failed_out = s_count[3];
    p.work[0] = 0;  // the ticket, for the next launch on this stream
  }
}

template <bool VEC>
cudaError_t launch_stripe(const StripeParams& p, int smem, int grid, cudaStream_t st) {
  rs_stripe_kernel<VEC><<<(unsigned)grid, kStripeThreads, smem, st>>>(p);
  return cudaGetLastError();
}

#endif  // PP_RS_STAMPED

}  // namespace

// The carveout, in percent of the SM's shared memory, that holds `blocks`
// blocks of `kern` at `smem` dynamic shared bytes each, rounded up.
static cudaError_t carveout_for(const void* kern, int blocks, int smem, int device, int* pct) {
  cudaFuncAttributes attr;
  int sm_smem = 0, reserved = 0;
  cudaError_t err;
  if ((err = cudaFuncGetAttributes(&attr, kern)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                    device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                                    device)) != cudaSuccess)
    return err;
  const long long need = (long long)blocks * ((long long)attr.sharedSizeBytes + smem + reserved);
  *pct = (int)((100 * need + sm_smem - 1) / sm_smem);
  return cudaSuccess;
}

// Sets the syndrome kernel of m-bit symbols (m = 8 or 10) up on `device`
// for nr roots: writes its copies of T (m = 8: kCopies where they fit a
// block's shared memory, so that the lanes' lookups of T fall in distinct
// banks, else 1; m = 10: the lane copies each block builds of its half
// tables, kWideCopies) to *copies and its dynamic shared bytes a
// block to *smem, lets it use all the device's shared memory (m = 10: as
// much of it as kWideSynBlocks blocks an SM need, the rest left to L1),
// and returns how many of its blocks an SM holds; a negative cudaError_t
// on an error.
extern "C" int pp_rs_syndrome_shape(int m, int nr, int device, int* copies, int* smem) {
  if ((m != 8 && m != kWideM) || nr < 1 || nr > kMaxRoots) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -(int)err;
  const int factors = (nr + kFactorRoots - 1) / kFactorRoots;
  const int threads = m == 8 ? kSynThreads : kWideSynThreads;
  const void* kern = m == 8 ? syndrome_kernel(nr) : wide_syndrome_kernel(nr);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err != cudaSuccess) return -(int)err;
  int pct = cudaSharedmemCarveoutMaxShared;
  if (m == 8) {
    *copies = syndrome_smem(factors, kCopies) <= max_smem ? kCopies : 1;
    *smem = syndrome_smem(factors, *copies);
  } else {
    *copies = kWideCopies;
    *smem = wide_syndrome_smem(factors, nr);
    if ((err = carveout_for(kern, kWideSynBlocks, *smem, device, &pct)) != cudaSuccess)
      return -(int)err;
    if (pct > 100) pct = 100;
  }
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, pct);
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, *smem);
  return err != cudaSuccess ? -(int)err : per_sm;
}

// Writes the log-form syndromes s_log_out [B, nr] int32 (log[S_i], fs
// where S_i = 0: the decode's s_log) of the rows data [B, size] | parity
// [B, nr] of m-bit symbols (bytes for m = 8, 16-bit words for m = 10) on
// `stream` (a cudaStream_t) of `device`, in `grid` blocks of `smem` dynamic
// shared bytes with `copies` copies of T (pp_rs_syndrome_shape first, for
// all three); allocates nothing.  `tables` is models/rs_cuda.py
// `syndrome_tables` for this config (m = 10: `wide_syndrome_tables`),
// `log_tables` the decode's [4, 256] (log first; m = 8 only).  Returns the
// launch's cudaError_t.
extern "C" int pp_rs_syndrome(int m, const void* data, const void* parity, const void* tables,
                              const void* log_tables, void* s_log_out, int batch, int size,
                              int nr, int copies, int grid, int smem, int device, void* stream) {
  const int fs = m == 8 ? kFs : kWideFs;
  const int factors = (nr + kFactorRoots - 1) / kFactorRoots;
  if ((m != 8 && m != kWideM) || batch < 1 || size < 1 || nr < 1 || nr > kMaxRoots ||
      size + nr > fs || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (m == 8 ? (copies != 1 && copies != kCopies) || smem < syndrome_smem(factors, copies)
             : smem < wide_syndrome_smem(factors, nr))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == kWideM) {
    const WideSynParams w = {static_cast<const uint16_t*>(data),
                             static_cast<const uint16_t*>(parity),
                             static_cast<const uint32_t*>(tables),
                             static_cast<int32_t*>(s_log_out), batch, size, nr};
    switch (factors) {
      case 1: rs_syndrome_wide_kernel<1><<<grid, kWideSynThreads, smem, st>>>(w); break;
      case 2: rs_syndrome_wide_kernel<2><<<grid, kWideSynThreads, smem, st>>>(w); break;
      case 3: rs_syndrome_wide_kernel<3><<<grid, kWideSynThreads, smem, st>>>(w); break;
      default: rs_syndrome_wide_kernel<4><<<grid, kWideSynThreads, smem, st>>>(w); break;
    }
    return (int)cudaGetLastError();
  }
  const SynParams p = {static_cast<const uint8_t*>(data),
                       static_cast<const uint8_t*>(parity),
                       static_cast<const uint4*>(tables),
                       static_cast<const int32_t*>(log_tables),
                       static_cast<int32_t*>(s_log_out),
                       batch, size, nr, copies};
  switch (factors) {
    case 1: rs_syndrome_kernel<1><<<grid, kSynThreads, smem, st>>>(p); break;
    case 2: rs_syndrome_kernel<2><<<grid, kSynThreads, smem, st>>>(p); break;
    case 3: rs_syndrome_kernel<3><<<grid, kSynThreads, smem, st>>>(p); break;
    default: rs_syndrome_kernel<4><<<grid, kSynThreads, smem, st>>>(p); break;
  }
  return (int)cudaGetLastError();
}

// The decode kernel of m-bit symbols (8, or 10 in its plain form only),
// in its erasure form or not; nullptr for a form there is none of.
static const void* decode_kernel(int m, int erasure) {
  if (m == 8)
    return erasure ? reinterpret_cast<const void*>(rs_decode_kernel<8, true>)
                   : reinterpret_cast<const void*>(rs_decode_kernel<8, false>);
  if (m == kWideM && !erasure) return reinterpret_cast<const void*>(rs_decode_kernel<kWideM, false>);
  return nullptr;
}

// Sets the decode kernel of m-bit symbols (erasure: its erasure form) up
// on `device` for nr roots: writes its dynamic shared bytes a block to
// *smem, gives it the least shared-memory carveout (a percentage, written
// to *carveout) that keeps as many of its blocks an SM as the largest
// would, so that the rest of the SM's shared memory and L1 is L1, and
// returns how many of its blocks an SM then holds; a negative cudaError_t
// on an error.
extern "C" int pp_rs_decode_shape(int m, int erasure, int nr, int device, int* smem,
                                  int* carveout) {
  const void* kern = decode_kernel(m, erasure);
  if (kern == nullptr || nr < 1 || nr > kMaxRoots) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  *smem = decode_smem(nr * (m == 8 ? 1 : 2));
  const auto per_sm = [&](int pct, int* blocks) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, pct);
    return e != cudaSuccess ? e
                            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, kThreads,
                                                                            *smem);
  };
  int most = 0, pct = 0;
  if ((err = per_sm(cudaSharedmemCarveoutMaxShared, &most)) != cudaSuccess ||
      (err = carveout_for(kern, most, *smem, device, &pct)) != cudaSuccess)
    return -(int)err;
  // the blocks' shared bytes as a share of the SM's, rounded up; the
  // carveout is rounded up again to a size the SM has
  int blocks = 0;
  for (;; ++pct) {
    if ((err = per_sm(pct < 100 ? pct : 100, &blocks)) != cudaSuccess) return -(int)err;
    if (blocks >= most || pct >= 100) break;
  }
  *carveout = pct < 100 ? pct : 100;
  return blocks;
}

// Launches the decode of m-bit symbols (8: bytes; 10: 16-bit words, plain
// form only) on `stream` (a cudaStream_t) of `device`, in the carveout
// pp_rs_decode_shape set (a launch before it runs in the card's default);
// allocates nothing.  s_log: the log-form syndromes [B, nr]
// (pp_rs_syndrome's, or the caller's in the external-syndrome path).
// erasure: 1 starts BM from the erasure locator of eras_pos, eras_cnt
// (eras_width wide), 0 from 1.  Returns the launch's cudaError_t.
extern "C" int pp_rs_decode(int m, int erasure, const void* data, const void* parity,
                            const void* eras_pos, const void* eras_cnt,
                            int eras_width, const void* s_log,
                            const void* tables, void* data_out,
                            void* parity_out, void* ok_out,
                            void* corrected_out, int batch, int size, int nr,
                            int fcr, int prim, int prim_inv, int device,
                            void* stream) {
  const int fs = m == 8 ? kFs : kWideFs;
  if (decode_kernel(m, erasure) == nullptr || batch < 1 || size < 1 || nr < 1 ||
      nr > kMaxRoots || size + nr > fs || s_log == nullptr)
    return (int)cudaErrorInvalidValue;
  if (erasure && (eras_width < 1 || eras_width > nr))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)((batch + kThreads - 1) / kThreads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == kWideM) {
    ParamsT<kWideM> p;
    p.data = static_cast<const uint16_t*>(data);
    p.parity = static_cast<const uint16_t*>(parity);
    p.eras_pos = nullptr;
    p.eras_cnt = nullptr;
    p.eras_width = 0;
    p.s_log = static_cast<const int32_t*>(s_log);
    p.tables = static_cast<const int32_t*>(tables);
    p.data_out = static_cast<uint16_t*>(data_out);
    p.parity_out = static_cast<uint16_t*>(parity_out);
    p.ok_out = static_cast<uint8_t*>(ok_out);
    p.corrected_out = static_cast<int32_t*>(corrected_out);
    p.batch = batch;
    p.size = size;
    p.nr = nr;
    p.fcr = fcr;
    p.prim = prim;
    p.prim_inv = prim_inv;
    rs_decode_kernel<kWideM, false><<<grid, kThreads, decode_smem(2 * nr), st>>>(p);
    return (int)cudaGetLastError();
  }

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

  if (erasure)
    rs_decode_kernel<8, true><<<grid, kThreads, decode_smem(nr), st>>>(p);
  else
    rs_decode_kernel<8, false><<<grid, kThreads, decode_smem(nr), st>>>(p);
  return (int)cudaGetLastError();
}

#ifndef PP_RS_STAMPED

// Sets the stripe kernel (vec: its 16-byte form) up on `device` for the
// nibble tables of n_surv surviving cells (fast 1) or for none (fast 0):
// writes its dynamic shared bytes a block to *smem, lets it use all the
// device's shared memory a block (so that a launch of any shape this
// returned for stays valid), and returns how many of its blocks of *smem
// bytes an SM holds; 0 where *smem passes the device's shared memory a
// block, a negative cudaError_t on an error.
extern "C" int pp_rs_stripe_blocks_per_sm(int n_surv, int fast, int vec, int device,
                                          int* smem) {
  *smem = kStripeFixedInts * 4 + (fast ? n_surv * 2 * kNibbleWords * 4 : 0);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -(int)err;
  if (*smem > max_smem) return 0;
  const void* kern = vec ? reinterpret_cast<const void*>(rs_stripe_kernel<true>)
                         : reinterpret_cast<const void*>(rs_stripe_kernel<false>);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kStripeThreads, *smem);
  return err != cudaSuccess ? -(int)err : per_sm;
}

// Rebuilds the lost cells of the shard-major cells [n, L]
// (models/rs_cuda.py `RSCudaDecoder.reconstruct`) on `stream` (a
// cudaStream_t) of `device`, in `grid` blocks of `smem` dynamic shared
// bytes (pp_rs_stripe_blocks_per_sm first, for both); allocates nothing.  lost [e]
// and surv [n - e] are the lost and the other cells; nibbles [n - e][2][16]
// the plan's tables (read where fast is 1); tables the decode's [4, 256];
// rebuilt [e, L], ok_out [L], corrected_out [L] and failed_out [] the
// outputs; work [1 + grid] int32, zero at the first launch on a stream and
// left so by each.  vec: L is a multiple of 16 and cells and the outputs
// lie on 16 bytes.  Returns the launch's cudaError_t.
extern "C" int pp_rs_stripe(const void* cells, const void* lost, const void* surv,
                            const void* nibbles, const void* tables, void* rebuilt,
                            void* ok_out, void* corrected_out, void* failed_out, void* work,
                            int grid, int smem, long long L, int n, int e, int nr, int fcr,
                            int prim, int prim_inv, int fast, unsigned tmask, int vec,
                            int device, void* stream) {
  const int n_surv = n - e;
  if (L < 1 || nr < 1 || nr > kMaxRoots || n <= nr || n > kFs || e < 1 || e > nr ||
      grid < 1 || (fast && nr > 4) ||
      smem < kStripeFixedInts * 4 + (fast ? n_surv * 2 * kNibbleWords * 4 : 0))
    return (int)cudaErrorInvalidValue;
  const auto misaligned = [](const void* a) { return reinterpret_cast<uintptr_t>(a) % 16 != 0; };
  if (vec && (L % kStripeCols || misaligned(cells) || misaligned(rebuilt) ||
              misaligned(ok_out) || misaligned(corrected_out)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;

  StripeParams p;
  p.cells = static_cast<const uint8_t*>(cells);
  p.lost = static_cast<const int32_t*>(lost);
  p.surv = static_cast<const int32_t*>(surv);
  p.nibbles = static_cast<const uint32_t*>(nibbles);
  p.tables = static_cast<const int32_t*>(tables);
  p.rebuilt = static_cast<uint8_t*>(rebuilt);
  p.ok_out = static_cast<uint8_t*>(ok_out);
  p.corrected_out = static_cast<uint8_t*>(corrected_out);
  p.failed_out = static_cast<int32_t*>(failed_out);
  p.work = static_cast<int32_t*>(work);
  p.L = L;
  p.n = n;
  p.e = e;
  p.n_surv = n_surv;
  p.nr = nr;
  p.fcr = fcr;
  p.prim = prim;
  p.prim_inv = prim_inv;
  p.fast = fast;
  p.tmask = tmask;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch_stripe<true>(p, smem, grid, st)
                   : launch_stripe<false>(p, smem, grid, st));
}

#endif  // PP_RS_STAMPED
