// Binary BCH decode of shortened codes over GF(2^m), m <= 14, on stored bytes.
//
// No TPU kernel decodes BCH: the JAX package runs it through XLA as bit
// matrices, and so does the port's plain version (models/bch.py).  This
// kernel takes the facade's bytes as they are stored, data uint8 [B, nb]
// and parity uint8 [B, pbytes] (big-endian, parity_bits pb of them), and
// writes the corrected data, a verdict and a count a row, in one launch.
//
// The codeword r(x) of n = pb + 8 nb bits is data(x) x^pb + parity(x),
// the first data byte's top bit the highest power.  A block takes a tile
// of `rows` rows (its threads) at a time, persistent over the tiles:
//
// 1. a thread a row divides: R = data(x) x^pb mod g(x) a byte a step, as
//    the encoder's LFSR does (R <- (R x^8 + v x^pb) mod g, the top byte of
//    R and v indexing one table of (u x^pb mod g) a step), then XORs the
//    stored parity in: R = r(x) mod g(x), zero exactly on codewords.  R is
//    held left-aligned in W 32-bit words (its low sh = 32 W - pb bits zero);
// 2. the same thread evaluates R at the t odd roots alpha^1, alpha^3, ..,
//    alpha^(2t-1) from nibble tables (r(alpha^i) = R(alpha^i), g(alpha^i)
//    = 0), takes S_2j = S_j^2, and runs Berlekamp-Massey over the 2t
//    syndromes (models/bch.py `_berlekamp_massey`: Massey's algorithm in
//    2t trips, of which the odd ones, whose discrepancy is zero where
//    S_2j = S_j^2, only shift b); a length past t fails the row there, as
//    does a locator whose degree is short of its length (it cannot have
//    that many roots);
// 3. the locator's roots alpha^-p at the word's own n positions p only.
//    The thread solves a locator of degree 1, 2 or 3 for X = alpha^p, the
//    roots of X^L lambda(1 / X): lambda_1 = X; the quadratic through
//    y^2 + y = lambda_2 / lambda_1^2 (X = lambda_1 y), the cubic, moved to
//    Z^3 + A Z + B (Z = X + lambda_1), through y^3 + y = B / A^(3/2)
//    (Z = A^(1/2) y), each one lookup in a table of the roots for each
//    right-hand side.  A warp sweeps a locator of degree 4 or more (or a
//    cubic with A = 0), lane l at positions l, l + 32, ..: p is a root
//    where sum_j lambda_j alpha^(-j p) = 1, the sweep specialised to the
//    degree and stopped once it has found as many roots.  A root that
//    would lie in the shortened code's pad is never found, so the row
//    fails (lib/bch.c's -EBADMSG);
// 4. a thread a row checks the count (found == length) and the verify
//    (the corrected word's odd syndromes are zero, so all of them are:
//    S_2j = S_j^2 for a binary word), and writes ok and the count;
// 5. a warp a row copies its data through to the output, the found bits
//    flipped where the row is ok, in 16-byte vectors where rows and
//    pointers allow.
//
// Outputs equal the plain version's bit for bit: ok; the data corrected on
// an ok row and as given otherwise; the count of corrected bits, 0 on clean
// and failed rows.
//
// The tables come from the host as one image (models/bch_cuda.py
// `bch_tables`), each section padded to 16 bytes: the division table
// [256][W] words, the nibble tables [t][nq][16] uint16, the log table
// [2^m] (log 0 = fs) and the antilog table [2^m] (antilog fs = 0), which
// each block copies into shared memory, then the quadratic's table [2^m]
// uint16 (a y with y^2 + y = c, 0xFFFF where there is none) and the
// cubic's [2^m][4] uint16 (the three distinct y with y^3 + y = c, then
// 0; 0xFFFF first where there are not three), read from device memory: a
// row reads one entry.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxM = 14;

__host__ __device__ constexpr int pad16(int x) { return (x + 15) & ~15; }

// Byte offsets of the image's sections; `bytes` the part in shared memory,
// the quadratic's table after it.
struct Layout {
  int nib, log, alog, bytes;
  __host__ __device__ Layout(int W, int t, int nq, int m) {
    nib = 256 * W * 4;
    log = nib + pad16(t * nq * 16 * 2);
    alog = log + (1 << m) * 2;
    bytes = alog + pad16((1 << m) * 2);
  }
};

constexpr uint16_t kNoRoot = 0xFFFF;

// Per-row shared state, after the tables: for `lanes` lanes the locator's
// logs (lambda_1..lambda_lanes), the odd syndromes and the roots found,
// then a byte each of state, length and roots found, then the Chien work
// list.
constexpr int row_bytes(int lanes) { return 3 * lanes * 2 + 3 + 2; }

enum : uint8_t { kClean = 0, kFailed = 1, kChien = 2, kApply = 3 };

template <int W>
struct DivEntry;
template <>
struct DivEntry<2> {
  __device__ static void xor_into(uint32_t* w, const uint32_t* tbl, int top) {
    const uint2 e = reinterpret_cast<const uint2*>(tbl)[top];
    w[0] ^= e.x;
    w[1] ^= e.y;
  }
};
template <>
struct DivEntry<4> {
  __device__ static void xor_into(uint32_t* w, const uint32_t* tbl, int top) {
    const uint4 e = reinterpret_cast<const uint4*>(tbl)[top];
    w[0] ^= e.x;
    w[1] ^= e.y;
    w[2] ^= e.z;
    w[3] ^= e.w;
  }
};
template <>
struct DivEntry<8> {
  __device__ static void xor_into(uint32_t* w, const uint32_t* tbl, int top) {
    const uint4 a = reinterpret_cast<const uint4*>(tbl)[2 * top];
    const uint4 b = reinterpret_cast<const uint4*>(tbl)[2 * top + 1];
    w[0] ^= a.x;
    w[1] ^= a.y;
    w[2] ^= a.z;
    w[3] ^= a.w;
    w[4] ^= b.x;
    w[5] ^= b.y;
    w[6] ^= b.z;
    w[7] ^= b.w;
  }
};

// One step of the division by a data byte v.
template <int W>
__device__ __forceinline__ void div_step(uint32_t* w, const uint32_t* tbl, uint32_t v) {
  const int top = (int)((w[W - 1] >> 24) ^ v);
#pragma unroll
  for (int k = W - 1; k > 0; --k) w[k] = __funnelshift_l(w[k - 1], w[k], 8);
  w[0] <<= 8;
  DivEntry<W>::xor_into(w, tbl, top);
}

template <int W>
__device__ __forceinline__ void div_word(uint32_t* w, const uint32_t* tbl, uint32_t x) {
#pragma unroll
  for (int b = 0; b < 4; ++b) div_step<W>(w, tbl, (x >> (8 * b)) & 0xFF);
}

__device__ __forceinline__ int mod_sub(int a, int b, int fs) {   // (a - b) mod fs, 0 <= a, b < fs
  const int d = a - b;
  return d < 0 ? d + fs : d;
}

__device__ __forceinline__ int mod_add(int a, int b, int fs) {   // (a + b) mod fs, 0 <= a, b < fs
  const int s = a + b;
  return s >= fs ? s - fs : s;
}

__device__ __forceinline__ int gf_mul(int a, int b, const uint16_t* s_log, const uint16_t* s_alog,
                                      int fs) {
  return a == 0 || b == 0 ? 0 : s_alog[mod_add(s_log[a], s_log[b], fs)];
}

// A of a cubic locator moved to Z^3 + A Z + B: lambda_1^2 + lambda_2.
__device__ __forceinline__ int cubic_a(const int* c, const uint16_t* s_log,
                                       const uint16_t* s_alog, int fs) {
  return gf_mul(c[1], c[1], s_log, s_alog, fs) ^ c[2];
}

// The roots of a locator c of degree len = 1, 2 or 3 (for 3, A != 0) at
// positions below n, into roots[], from the tables after the shared part
// of the image (quad, then the cubic's); returns their count.  Fewer than
// len distinct roots in the field leave the count short, as a sweep would.
__device__ __forceinline__ int direct_roots(int len, const int* c, const uint16_t* s_log,
                                            const uint16_t* s_alog, const uint16_t* quad, int fs,
                                            int n, uint16_t* roots) {
  int found = 0;
  const int l1 = s_log[c[1]];
  if (len == 1) {                                       // X = lambda_1
    if (l1 < n) roots[found++] = (uint16_t)l1;
  } else if (len == 2) {                                // X = lambda_1 y
    if (l1 == fs) return 0;                             // a double root
    const int l2 = s_log[c[2]];
    const int y = __ldg(quad + s_alog[mod_sub(l2, mod_add(l1, l1, fs), fs)]);
    if (y == kNoRoot) return 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int p = mod_add(l1, s_log[y ^ k], fs);
      if (p < n) roots[found++] = (uint16_t)p;
    }
  } else {                                              // X = A^(1/2) y + lambda_1
    const int a = cubic_a(c, s_log, s_alog, fs);
    const int b = gf_mul(c[1], c[2], s_log, s_alog, fs) ^ c[3];
    if (b == 0) return 0;                               // y (y + 1)^2: a double root
    const int half = (int)((long long)s_log[a] * ((fs + 1) / 2) % fs);   // log A^(1/2)
    const int rhs = s_alog[mod_sub(s_log[b], (3 * half) % fs, fs)];
    const uint2 e = __ldg(reinterpret_cast<const uint2*>(quad + (fs + 1 + 7) / 8 * 8) + rhs);
    if ((e.x & 0xFFFF) == kNoRoot) return 0;
    const int ys[3] = {(int)(e.x & 0xFFFF), (int)(e.x >> 16), (int)(e.y & 0xFFFF)};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int x = s_alog[mod_add(half, s_log[ys[k]], fs)] ^ c[1];
      const int p = s_log[x];
      if (p < n) roots[found++] = (uint16_t)p;
    }
  }
  return found;
}

// A warp's Chien sweep of a locator of degree D (lc: the logs of lambda_1
// .. lambda_D, fs for zero) over positions 0 .. n - 1: the roots' positions
// into roots[0 .. D - 1], in order, and their count (all lanes).
template <int D>
__device__ __forceinline__ int chien_sweep(const uint16_t* s_alog, const int* lc, int lane, int n,
                                           int fs, uint16_t* roots) {
  int e[D], step[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const bool zero = lc[j] == fs;
    e[j] = zero ? fs : mod_sub(lc[j], ((j + 1) * lane) % fs, fs);
    step[j] = zero ? 0 : ((j + 1) * kWarp) % fs;
  }
  int found = 0;
  for (int base = 0; base < n; base += kWarp) {
    int val = 0;
#pragma unroll
    for (int j = 0; j < D; ++j) val ^= s_alog[e[j]];
    const bool root = val == 1 && base + lane < n;
    const unsigned hit = __ballot_sync(0xFFFFFFFFu, root);
    if (hit) {
      if (root) {
        const int k = found + __popc(hit & ((1u << lane) - 1));
        if (k < D) roots[k] = (uint16_t)(base + lane);
      }
      found += __popc(hit);
      if (found >= D) break;
    }
#pragma unroll
    for (int j = 0; j < D; ++j) e[j] = mod_sub(e[j], step[j], fs);
  }
  return found;
}

// chien_sweep for the degree deg, D <= deg <= TMAX.
template <int D, int TMAX>
__device__ __forceinline__ int sweep_degree(int deg, const uint16_t* s_alog, const int* lc,
                                            int lane, int n, int fs, uint16_t* roots) {
  if (deg == D) return chien_sweep<D>(s_alog, lc, lane, n, fs, roots);
  if constexpr (D < TMAX) return sweep_degree<D + 1, TMAX>(deg, s_alog, lc, lane, n, fs, roots);
  return 0;
}

template <int TMAX, int W>
__global__ void __launch_bounds__(256) bch_decode_kernel(
    const uint8_t* __restrict__ data, const uint8_t* __restrict__ parity,
    const uint4* __restrict__ tables, uint8_t* __restrict__ data_out, bool* __restrict__ ok_out,
    int* __restrict__ corrected_out, int batch, int nb, int pbytes, int pb, int t, int m, int q0,
    int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int fs = (1 << m) - 1;
  const int nq = 8 * W - q0;
  const int n = pb + 8 * nb;
  const int sh = 32 * W - pb;
  const Layout lay(W, t, nq, m);
  const int rows = blockDim.x;
  const uint32_t* s_div = reinterpret_cast<const uint32_t*>(smem);
  const uint16_t* s_nib = reinterpret_cast<const uint16_t*>(smem + lay.nib);
  const uint16_t* s_log = reinterpret_cast<const uint16_t*>(smem + lay.log);
  const uint16_t* s_alog = reinterpret_cast<const uint16_t*>(smem + lay.alog);
  const uint16_t* quad =
      reinterpret_cast<const uint16_t*>(reinterpret_cast<const uint8_t*>(tables) + lay.bytes);
  uint16_t* s_clog = reinterpret_cast<uint16_t*>(smem + lay.bytes);   // [rows][TMAX]
  uint16_t* s_syn = s_clog + rows * TMAX;                            // [rows][TMAX]
  uint16_t* s_root = s_syn + rows * TMAX;                            // [rows][TMAX]
  uint8_t* s_state = reinterpret_cast<uint8_t*>(s_root + rows * TMAX);
  uint8_t* s_len = s_state + rows;
  uint8_t* s_found = s_len + rows;
  uint16_t* s_work = reinterpret_cast<uint16_t*>(s_found + rows + (rows & 1));
  __shared__ int s_count, s_next;

  for (int i = threadIdx.x; i < lay.bytes / 16; i += rows)
    reinterpret_cast<uint4*>(smem)[i] = tables[i];
  __syncthreads();

  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int warps = rows / kWarp;
  const int ntiles = (batch + rows - 1) / rows;
  const int r = threadIdx.x;
  const uint32_t top_mask = (pb & 7) ? (1u << (pb & 7)) - 1 : 0xFFu;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    if (r == 0) {
      s_count = 0;
      s_next = 0;
    }
    __syncthreads();
    const long long row = (long long)tile * rows + r;

    // ---- 1 and 2: division, odd syndromes, Berlekamp-Massey (a thread a row)
    uint8_t state = kClean;
    int found = 0;
    if (row < batch) {
      uint32_t w[W];
#pragma unroll
      for (int k = 0; k < W; ++k) w[k] = 0;
      const uint8_t* d = data + row * nb;
      if (vec) {
        const uint4* d4 = reinterpret_cast<const uint4*>(d);
        for (int c = 0; c < nb / 16; ++c) {
          const uint4 x = __ldg(d4 + c);
          div_word<W>(w, s_div, x.x);
          div_word<W>(w, s_div, x.y);
          div_word<W>(w, s_div, x.z);
          div_word<W>(w, s_div, x.w);
        }
      } else {
        for (int b = 0; b < nb; ++b) div_step<W>(w, s_div, __ldg(d + b));
      }
      const uint8_t* p = parity + row * pbytes;
      for (int k = 0; k < pbytes; ++k) {
        uint32_t v = __ldg(p + k);
        if (k == 0) v &= top_mask;
        const int pos = sh + 8 * (pbytes - 1 - k);      // the byte's lowest bit, aligned
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const int s = pos - 32 * j;
          if (s >= 0 && s < 32) w[j] ^= v << s;
          else if (s < 0 && s > -8) w[j] ^= v >> -s;
        }
      }
      uint32_t any = 0;
#pragma unroll
      for (int k = 0; k < W; ++k) any |= w[k];

      if (any) {
        // odd syndromes from the nibble tables; ls[k] = log S_(k+1)
        int ls[2 * TMAX];
#pragma unroll
        for (int i = 0; i < TMAX; ++i) {
          if (i < t) {
            int acc = 0;
            const uint16_t* e = s_nib + i * nq * 16;
#pragma unroll
            for (int q = 0; q < 8 * W; ++q) {
              if (q >= q0) acc ^= e[(q - q0) * 16 + ((w[q >> 3] >> (4 * (q & 7))) & 15)];
            }
            s_syn[r * TMAX + i] = (uint16_t)acc;
            ls[2 * i] = s_log[acc];
          }
        }
#pragma unroll
        for (int k = 1; k < 2 * TMAX; k += 2) {       // S_(k+1) = S_((k+1)/2)^2
          const int h = ls[(k - 1) / 2];
          ls[k] = h == fs ? fs : mod_add(h, h, fs);
        }

        // Berlekamp-Massey: c the locator (values), bl the logs of x^shift b
        int c[TMAX + 1], bl[TMAX + 1];
        c[0] = 1;
        bl[0] = fs;
        bl[1] = 0;
#pragma unroll
        for (int j = 1; j <= TMAX; ++j) c[j] = 0;
#pragma unroll
        for (int j = 2; j <= TMAX; ++j) bl[j] = fs;
        int len = 0, pd_log = 0;
        bool fail = false;
#pragma unroll
        for (int it = 0; it < 2 * TMAX; ++it) {
          if ((it & 1) && it < 2 * t && !fail) {          // a zero discrepancy
#pragma unroll
            for (int j = TMAX; j > 0; --j) bl[j] = bl[j - 1];
            bl[0] = fs;
          } else if (it < 2 * t && !fail) {
            int lc[TMAX + 1];
            lc[0] = 0;
            int disc = ls[it] == fs ? 0 : s_alog[ls[it]];
#pragma unroll
            for (int j = 1; j <= TMAX; ++j) {            // deg c <= len
              lc[j] = j <= len ? s_log[c[j]] : fs;
              if (j <= it && lc[j] != fs && ls[it - j] != fs)
                disc ^= s_alog[mod_add(lc[j], ls[it - j], fs)];
            }
            if (disc != 0) {
              const int dl = s_log[disc];
              const int mult = mod_sub(dl, pd_log, fs);
              const bool grow = 2 * len <= it;
              if (grow && it + 1 - len > t) {
                fail = true;
              } else {
#pragma unroll
                for (int j = 1; j <= TMAX; ++j)
                  if (bl[j] != fs) c[j] ^= s_alog[mod_add(bl[j], mult, fs)];
                if (grow) {
                  len = it + 1 - len;
                  pd_log = dl;
#pragma unroll
                  for (int j = TMAX; j > 0; --j) bl[j] = lc[j - 1];
                  bl[0] = fs;
                  continue;
                }
              }
            }
#pragma unroll
            for (int j = TMAX; j > 0; --j) bl[j] = bl[j - 1];
            bl[0] = fs;
          }
        }
        int deg = 0;
#pragma unroll
        for (int j = 1; j <= TMAX; ++j) {
          const int lj = s_log[c[j]];
          s_clog[r * TMAX + j - 1] = (uint16_t)lj;
          if (lj != fs) deg = j;
        }
        if (fail || deg != len) {
          state = kFailed;
        } else if (len <= 3 && (len < 3 || cubic_a(c, s_log, s_alog, fs) != 0)) {
          state = kChien;                             // the roots solved here
          s_len[r] = (uint8_t)len;
          found = direct_roots(len, c, s_log, s_alog, quad, fs, n, s_root + r * TMAX);
        } else {
          state = kChien;
          s_len[r] = (uint8_t)len;
          s_work[atomicAdd(&s_count, 1)] = (uint16_t)r;
        }
      }
    }
    s_state[r] = state;
    s_found[r] = (uint8_t)found;
    __syncthreads();

    // ---- 3: Chien over the word's positions for the other locators (a warp a row)
    const int count = s_count;
    for (;;) {
      int idx = 0;
      if (lane == 0) idx = atomicAdd(&s_next, 1);
      idx = __shfl_sync(0xFFFFFFFFu, idx, 0);
      if (idx >= count) break;
      const int rr = s_work[idx];
      int lc[TMAX];
#pragma unroll
      for (int j = 0; j < TMAX; ++j) lc[j] = s_clog[rr * TMAX + j];
      const int got = sweep_degree<3, TMAX>(s_len[rr], s_alog, lc, lane, n, fs,
                                            s_root + rr * TMAX);
      if (lane == 0) s_found[rr] = (uint8_t)got;
    }
    __syncthreads();

    // ---- 4: count and verify; ok and the count (a thread a row)
    if (row < batch) {
      bool ok = state == kClean;
      int corrected = 0;
      if (state == kChien) {
        const int len = s_len[r];
        const int found = s_found[r];
        if (found == len) {
          int pk[TMAX], stepk[TMAX];
#pragma unroll
          for (int k = 0; k < TMAX; ++k) {
            pk[k] = k < found ? s_root[r * TMAX + k] % fs : 0;
            stepk[k] = mod_add(pk[k], pk[k], fs);
          }
          bool clean = true;
          for (int i = 0; i < t; ++i) {              // root alpha^(2i+1)
            int acc = s_syn[r * TMAX + i];
#pragma unroll
            for (int k = 0; k < TMAX; ++k) {
              if (k < found) {
                acc ^= s_alog[pk[k]];
                pk[k] = mod_add(pk[k], stepk[k], fs);
              }
            }
            clean = clean && acc == 0;
          }
          if (clean) {
            ok = true;
            corrected = found;
            s_state[r] = kApply;
          }
        }
      }
      ok_out[row] = ok;
      corrected_out[row] = corrected;
    }
    __syncthreads();

    // ---- 5: the data copied through, the found bits flipped (a warp a row)
    for (int lr = warp; lr < rows; lr += warps) {
      const long long orow = (long long)tile * rows + lr;
      if (orow >= batch) break;
      const bool apply = s_state[lr] == kApply;
      const int found = apply ? s_found[lr] : 0;
      const uint8_t* src = data + orow * nb;
      uint8_t* dst = data_out + orow * nb;
      if (vec) {
        for (int ch = lane; ch < nb / 16; ch += kWarp) {
          uint4 x = __ldg(reinterpret_cast<const uint4*>(src) + ch);
          for (int k = 0; k < found; ++k) {
            const int bit = s_root[lr * TMAX + k] - pb;
            if (bit < 0) continue;
            const int byte = nb - 1 - (bit >> 3);
            if ((byte >> 4) != ch) continue;
            const uint32_t flip = 1u << (8 * (byte & 3) + (bit & 7));
            switch ((byte >> 2) & 3) {
              case 0: x.x ^= flip; break;
              case 1: x.y ^= flip; break;
              case 2: x.z ^= flip; break;
              default: x.w ^= flip; break;
            }
          }
          reinterpret_cast<uint4*>(dst)[ch] = x;
        }
      } else {
        for (int b = lane; b < nb; b += kWarp) {
          uint32_t v = __ldg(src + b);
          for (int k = 0; k < found; ++k) {
            const int bit = s_root[lr * TMAX + k] - pb;
            if (bit >= 0 && nb - 1 - (bit >> 3) == b) v ^= 1u << (bit & 7);
          }
          dst[b] = (uint8_t)v;
        }
      }
    }
    __syncthreads();
  }
}

// The kernel's form for t: lanes TMAX >= t, words W with 32 W >= 14 TMAX.
template <int TMAX>
struct Form {
  static constexpr int W = TMAX == 4 ? 2 : TMAX == 8 ? 4 : 8;
};

const void* kernel_for(int t) {
  if (t <= 4) return reinterpret_cast<const void*>(&bch_decode_kernel<4, Form<4>::W>);
  if (t <= 8) return reinterpret_cast<const void*>(&bch_decode_kernel<8, Form<8>::W>);
  return reinterpret_cast<const void*>(&bch_decode_kernel<16, Form<16>::W>);
}

int words_for(int t) { return t <= 4 ? Form<4>::W : t <= 8 ? Form<8>::W : Form<16>::W; }
int lanes_for(int t) { return t <= 4 ? 4 : t <= 8 ? 8 : 16; }

int smem_for(int m, int t, int pb, int threads) {
  const int W = words_for(t);
  const int q0 = (32 * W - pb) / 4;
  const Layout lay(W, t, 8 * W - q0, m);
  return lay.bytes + row_bytes(lanes_for(t)) * threads + 2;
}

bool valid(int m, int t, int pb, int threads) {
  return m >= 3 && m <= kMaxM && t >= 1 && t <= 16 && pb >= 8 && pb <= 32 * words_for(t) &&
         threads >= kWarp && threads <= 256 && threads % kWarp == 0;
}

}  // namespace

// The launch's shape: the dynamic shared bytes a block of `threads` rows
// needs (out), with the kernel's limit raised to the card's; returns the
// blocks an SM holds, or a negative cudaError_t.
extern "C" int pp_bch_decode_shape(int m, int t, int pb, int threads, int device, int* smem) {
  if (!valid(m, t, pb, threads)) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -(int)err;
  const void* kern = kernel_for(t);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return -(int)err;
  *smem = smem_for(m, t, pb, threads);
  if (*smem + (int)attr.sharedSizeBytes > max_smem) return 0;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, *smem);
  return err != cudaSuccess ? -(int)err : per_sm;
}

// One decode of `batch` rows: data uint8 [batch, nb], parity uint8
// [batch, pbytes], tables the image of models/bch_cuda.py `bch_tables`
// (16-byte aligned), outputs data_out uint8 [batch, nb], ok_out bool
// [batch], corrected_out int32 [batch].  vec: nb % 16 == 0 and data and
// data_out 16-byte aligned.  smem from pp_bch_decode_shape.
extern "C" int pp_bch_decode(const void* data, const void* parity, const void* tables,
                             void* data_out, void* ok_out, void* corrected_out, int batch, int nb,
                             int pbytes, int pb, int t, int m, int vec, int threads, int grid,
                             int smem, int device, void* stream) {
  if (!valid(m, t, pb, threads) || nb < 1 || pbytes != (pb + 7) / 8 || batch < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int W = words_for(t);
  const int q0 = (32 * W - pb) / 4;
  auto* d = static_cast<const uint8_t*>(data);
  auto* p = static_cast<const uint8_t*>(parity);
  auto* tb = static_cast<const uint4*>(tables);
  auto* o = static_cast<uint8_t*>(data_out);
  auto* ok = static_cast<bool*>(ok_out);
  auto* c = static_cast<int*>(corrected_out);
  auto s = static_cast<cudaStream_t>(stream);
  if (t <= 4)
    bch_decode_kernel<4, Form<4>::W><<<grid, threads, smem, s>>>(d, p, tb, o, ok, c, batch, nb,
                                                                pbytes, pb, t, m, q0, vec);
  else if (t <= 8)
    bch_decode_kernel<8, Form<8>::W><<<grid, threads, smem, s>>>(d, p, tb, o, ok, c, batch, nb,
                                                                pbytes, pb, t, m, q0, vec);
  else
    bch_decode_kernel<16, Form<16>::W><<<grid, threads, smem, s>>>(d, p, tb, o, ok, c, batch,
                                                                  nb, pbytes, pb, t, m, q0, vec);
  return (int)cudaGetLastError();
}
