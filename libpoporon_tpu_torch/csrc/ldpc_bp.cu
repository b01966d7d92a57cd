// LDPC min-sum belief-propagation decode, one codeword per block, for Hopper.
//
// Replaces libpoporon_tpu/models/ldpc_pallas.py `BPPallasKernel._kernel`
// (:191-522) in all three of its entries: packed hard bytes
// (`bp_packed_hard`, :707), int8 soft LLRs (`bp_llr8_soft`, :736) and
// expanded LLR tensors (`bp`, :765).  It computes what the JAX package's XLA
// path (models/ldpc.py `_bp_loop` and the decode bodies) computes, bit for
// bit, and is held against the plain PyTorch version in
// libpoporon_tpu_torch/models/ldpc.py.
//
// What bounds it on an H100: the inputs are small (33 MB of bytes for a hard
// batch of 131072 codewords of the 128-byte rate-1/2 code, 268 MB of int8
// LLRs for a soft one), and each BP iteration of one codeword reads and
// writes its whole message state (about 25 KB of int16) in shared memory
// and reads the graph's index lists (about 25 KB of uint16) from L1 and L2.
// So shared-memory and L1/L2 index traffic in the edge loops bound the
// kernel, not HBM.
//
// Design, simple first:
// - One block of 256 threads per codeword; the grid has B blocks, so any
//   batch size runs with no host padding.
// - The codeword's message state lives in dynamic shared memory as int16,
//   the reference's domain: v2c and c2v per real edge (check-major, CSR
//   order), the saturated llr per variable, and in soft mode the constant
//   channel per variable.  No padding slots and no fake variable: a fold
//   over a check's real edges gives the m1, m2 and parity that the XLA
//   path's padded planes give, because every |v2c| <= 32000, the start of
//   m2.
// - The graph stays in global memory, read-only and shared by every block:
//   CSR row pointers and column indices, and the CSC column pointers with
//   the CSR edge index of each column entry, all uint16.
// - Each iteration is three passes separated by __syncthreads: the check
//   update (threads over checks), the var update (threads over variables)
//   and the syndrome (threads over checks), whose verdict
//   __syncthreads_or gives every thread.  A block leaves its loop at its
//   codeword's first clean syndrome, the per-codeword freeze of both JAX
//   paths, so a converged codeword costs only its own iterations.
// Faster designs (a warp per codeword, register-resident check rows, packed
// int16 pairs, several codewords sharing one staged graph) wait for a
// trace.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLlrMax = 32000;       // saturation bound (ldpc.h:15-17)
constexpr int kLlrInfinity = 30000;  // hard-decision channel magnitude
constexpr int kLlrScale = 256;       // int8 channel LLR scale (ldpc.c:27)

// Input forms: packed hard bytes (K4), int8 soft LLRs (K5), and expanded
// int16 llr rows without (hard) or with (soft) channel rows (K6).
enum Mode { kHardPacked = 0, kSoftLlr8 = 1, kHardLlr = 2, kSoftLlr = 3 };

struct Params {
  const void* in;          // [B, ceil(V/8)] u8 | [B, V] i8 | [B, V] i16
  const int16_t* chan;     // [B, V] i16 channel (kSoftLlr only)
  const uint16_t* graph;   // row_ptr[P+1], col_idx[E], col_ptr[V+1], var_edge[E]
  const int32_t* src;      // [V] input position of each variable, -1 = gap;
                           // null = identity (packed and int8 modes)
  void* out;               // [B, ceil(V/8)] u8 packed bits | [B, V] i8 bits
  uint8_t* ok_out;         // [B] bool
  int32_t* iters_out;      // [B]
  int V, P, E, max_iter;
};

__device__ __forceinline__ int sat(int x) {
  return min(max(x, -kLlrMax), kLlrMax);
}

// True when every check of the hard decision of `llr` is satisfied; each
// edge counts, so a pair of parallel edges cancels.  Ends in a barrier.
__device__ bool syndrome_clean(const int16_t* llr, const uint16_t* row_ptr,
                               const uint16_t* col_idx, int P) {
  int bad = 0;
  for (int c = threadIdx.x; c < P; c += kThreads) {
    int par = 0;
    for (int e = __ldg(row_ptr + c), e1 = __ldg(row_ptr + c + 1); e < e1; ++e)
      par ^= llr[__ldg(col_idx + e)] < 0;
    bad |= par;
  }
  return !__syncthreads_or(bad);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) ldpc_bp_kernel(const Params p) {
  constexpr bool kSoft = MODE == kSoftLlr8 || MODE == kSoftLlr;
  extern __shared__ int16_t smem[];
  const int V = p.V, P = p.P, E = p.E;
  int16_t* v2c = smem;
  int16_t* c2v = v2c + E;
  int16_t* llr = c2v + E;
  int16_t* chan = llr + V;  // soft modes only
  const uint16_t* row_ptr = p.graph;
  const uint16_t* col_idx = row_ptr + P + 1;
  const uint16_t* col_ptr = col_idx + E;
  const uint16_t* var_edge = col_ptr + V + 1;
  const long long b = blockIdx.x;

  // Initial state: llr_0 per variable and v2c_0 = llr_0 on its edges.
  for (int v = threadIdx.x; v < V; v += kThreads) {
    int l;
    if (MODE == kHardPacked) {
      // MSB-first bit src of the row; a deinterleave gap reads bit 0
      const int s = p.src ? __ldg(p.src + v) : v;
      const uint8_t* row = static_cast<const uint8_t*>(p.in) + b * ((V + 7) / 8);
      const int bit = s >= 0 ? (__ldg(row + (s >> 3)) >> (7 - (s & 7))) & 1 : 0;
      l = bit ? -kLlrInfinity : kLlrInfinity;
    } else if (MODE == kSoftLlr8) {
      // channel w * 256 unclipped (up to +-32512), llr_0 clipped; a gap
      // reads LLR 0 (the zero fill of the JAX deinterleave)
      const int s = p.src ? __ldg(p.src + v) : v;
      const int8_t* row = static_cast<const int8_t*>(p.in) + b * V;
      const int c = s >= 0 ? __ldg(row + s) * kLlrScale : 0;
      chan[v] = (int16_t)c;
      l = sat(c);
    } else {
      l = __ldg(static_cast<const int16_t*>(p.in) + b * V + v);
      if (kSoft) chan[v] = __ldg(p.chan + b * V + v);
    }
    llr[v] = (int16_t)l;
    for (int k = __ldg(col_ptr + v), k1 = __ldg(col_ptr + v + 1); k < k1; ++k)
      v2c[__ldg(var_edge + k)] = (int16_t)l;
  }
  __syncthreads();

  // Hard modes check the syndrome before the first iteration: a clean
  // input reports 0 iterations.  Soft modes do not.
  bool ok = !kSoft && syndrome_clean(llr, row_ptr, col_idx, P);
  int iters = 0;
  for (int t = 1; !ok && t <= p.max_iter; ++t) {
    // Check update: normalized two-minimum min-sum, alpha = 15/16
    // truncating; every edge whose |v2c| equals m1 gets m2.
    for (int c = threadIdx.x; c < P; c += kThreads) {
      const int e0 = __ldg(row_ptr + c), e1 = __ldg(row_ptr + c + 1);
      int m1 = kLlrMax, m2 = kLlrMax, par = 0;
      for (int e = e0; e < e1; ++e) {
        const int x = v2c[e], a = abs(x);
        m2 = min(m2, max(m1, a));
        m1 = min(m1, a);
        par ^= x < 0;
      }
      const int a1 = (m1 * 15) >> 4, a2 = (m2 * 15) >> 4;
      for (int e = e0; e < e1; ++e) {
        const int x = v2c[e];
        const int mag = abs(x) == m1 ? a2 : a1;
        c2v[e] = (int16_t)((par ^ (x < 0)) ? -mag : mag);
      }
    }
    __syncthreads();
    // Var update: total = channel + sum of c2v in int32, unsaturated;
    // llr = sat(total), v2c_e = sat(total - c2v_e).  The hard channel is
    // the previous iteration's saturated llr.
    for (int v = threadIdx.x; v < V; v += kThreads) {
      const int k0 = __ldg(col_ptr + v), k1 = __ldg(col_ptr + v + 1);
      int total = kSoft ? chan[v] : llr[v];
      for (int k = k0; k < k1; ++k) total += c2v[__ldg(var_edge + k)];
      llr[v] = (int16_t)sat(total);
      for (int k = k0; k < k1; ++k) {
        const int e = __ldg(var_edge + k);
        v2c[e] = (int16_t)sat(total - c2v[e]);
      }
    }
    __syncthreads();
    ok = syndrome_clean(llr, row_ptr, col_idx, P);
    iters = t;
  }
  if (!ok) iters = p.max_iter;

  // Outputs: the hard decision of the first clean iteration, or of the
  // last one when the budget ran out.
  if (MODE == kHardLlr || MODE == kSoftLlr) {
    int8_t* bits = static_cast<int8_t*>(p.out) + b * V;
    for (int v = threadIdx.x; v < V; v += kThreads) bits[v] = llr[v] < 0;
  } else {
    const int nbytes = (V + 7) / 8;
    uint8_t* bytes = static_cast<uint8_t*>(p.out) + b * nbytes;
    for (int j = threadIdx.x; j < nbytes; j += kThreads) {
      int acc = 0;
      for (int k = 0; k < 8 && 8 * j + k < V; ++k)
        acc |= (llr[8 * j + k] < 0) << (7 - k);
      bytes[j] = (uint8_t)acc;
    }
  }
  if (threadIdx.x == 0) {
    p.ok_out[b] = ok;
    p.iters_out[b] = iters;
  }
}

template <int MODE>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr bool kSoft = MODE == kSoftLlr8 || MODE == kSoftLlr;
  const size_t smem = sizeof(int16_t) * (2 * (size_t)p.E + (kSoft ? 2 : 1) * (size_t)p.V);
  const cudaError_t set = cudaFuncSetAttribute(
      ldpc_bp_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return set;
  ldpc_bp_kernel<MODE><<<(unsigned)batch, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Launches the decode of `batch` codewords on `stream` (a cudaStream_t) of
// `device`; allocates nothing.  mode: 0 packed hard bytes, 1 int8 soft LLRs,
// 2 expanded hard llr, 3 expanded soft llr plus channel (`chan`).  `graph`
// holds row_ptr, col_idx, col_ptr and var_edge back to back as uint16;
// `src` (modes 0 and 1, may be null) the inner deinterleaver's gather.
// Returns the launch's cudaError_t.
extern "C" int pp_ldpc_bp(int mode, const void* in, const void* chan,
                          const void* graph, const void* src, void* out,
                          void* ok_out, void* iters_out, int batch, int V,
                          int P, int E, int max_iter, int device,
                          void* stream) {
  if (batch < 1 || V < 1 || P < 1 || E < 1 || E > 65535 || V > 65535 ||
      max_iter < 1)
    return (int)cudaErrorInvalidValue;
  if (mode == kSoftLlr && chan == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;

  Params p;
  p.in = in;
  p.chan = static_cast<const int16_t*>(chan);
  p.graph = static_cast<const uint16_t*>(graph);
  p.src = static_cast<const int32_t*>(src);
  p.out = out;
  p.ok_out = static_cast<uint8_t*>(ok_out);
  p.iters_out = static_cast<int32_t*>(iters_out);
  p.V = V;
  p.P = P;
  p.E = E;
  p.max_iter = max_iter;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kHardPacked:
      return (int)launch<kHardPacked>(p, batch, st);
    case kSoftLlr8:
      return (int)launch<kSoftLlr8>(p, batch, st);
    case kHardLlr:
      return (int)launch<kHardLlr>(p, batch, st);
    case kSoftLlr:
      return (int)launch<kSoftLlr>(p, batch, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
