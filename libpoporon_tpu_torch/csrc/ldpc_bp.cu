// LDPC min-sum belief-propagation decode for Hopper: persistent blocks,
// a degree-sorted slot-major check layout, the graph kept on chip.
//
// Replaces libpoporon_tpu/models/ldpc_pallas.py `BPPallasKernel._kernel`
// (:191-522) in all three of its entries: packed hard bytes
// (`bp_packed_hard`, :707), int8 soft LLRs (`bp_llr8_soft`, :736) and
// expanded LLR tensors (`bp`, :765).  It computes what the JAX package's XLA
// path (models/ldpc.py `_bp_loop` and the decode bodies) computes, bit for
// bit, and is held against the plain PyTorch version in
// libpoporon_tpu_torch/models/ldpc.py.
//
// What bounds it on an H100: not device memory (33 MB of packed bytes in a
// hard batch of 131072 codewords of the 128-byte rate-1/2 code, 268 MB of
// int8 LLRs in a soft one), but instruction throughput and latency in the
// per-codeword loops over shared memory: 48 registers, 8 groups of 128
// threads an SM, the check pass 60% of the cycles and the unpack 20%
// (PERF.md section 5).  The one-codeword-per-block kernel before this one
// spent its time (clock64() stamps, PERF.md section 5) a third on fixed
// costs (a block launch, the unpack and a scattered v2c fill), a third on
// its check pass, where a warp ran 32 checks of random degree to the
// longest (1.8x the lane-steps needed) through uint16 index lists in
// L1/L2, and the rest on the var pass and a separate syndrome pass.
//
// Design:
// - Persistent blocks.  The wrapper launches as many blocks as the card
//   holds resident.  A block holds `groups` codeword groups of `threads`
//   threads each; a group takes the next codeword index from a device
//   counter (atomicAdd, one codeword ahead), decodes it, writes its outputs
//   and takes the next, so converged work refills the card while
//   stragglers run.  Each group synchronises on its own named barrier
//   (`bar.sync id, n`) and its early-exit verdict is `bar.red.or.pred`.
// - The layout, built on the host (models/ldpc_cuda.py `kernel_layout`):
//   checks sorted by degree, and within a run of equal degree d and n
//   checks, edge slot k of the run's j-th check at `first + k * n + j`.  A
//   warp's lanes walk 32 checks of one degree and read 32 neighbouring
//   int16: no divergence, no bank conflict and no index list in the check
//   pass.  `vslot[k * V + v]` is the k-th edge of variable v (0xFFFF past
//   its degree); the var pass gathers and scatters through it.
//   Relabelling checks and edges changes no output: the two-minimum fold,
//   the parity and the tie rule are order-free, the variable sum is an
//   exact int32 sum, and parallel edges stay two edges.
// - The graph stays on chip: in the shared form the block stages the
//   layout (runs, vslot and the inner deinterleaver's gather: 12 to 17 KB
//   for the 128-byte codes) in shared memory once and its groups share it;
//   a code whose layout and one codeword's state do not fit together (1024 B
//   rate 1/2) runs the same template with the layout read from global
//   memory (the global form).  The wrapper chooses the form and the group
//   count from the sizes.
// - A codeword's state, in shared memory: v2c and c2v per edge as int16,
//   the reference's domain, with an unsaturated int32 total in the var
//   update (v2c is explicit state: sat(total - c2v) is not recoverable from
//   the saturated llr); per variable the previous saturated llr (the hard
//   channel) or the soft channel (int8 x 256, unclipped); and the hard
//   decision as a bitmap for the output.
// - Two passes an iteration, each ended by the group's barrier: the check
//   pass, which also computes the syndrome of the last hard decision from
//   the signs of v2c + c2v at its own edges (check_pass says why that is
//   exact), and the var pass, which also writes the bitmap.  The unpack
//   writes v2c_0 through vslot.  The iteration-0 syndrome counts in the
//   hard modes only; `iters` is the first clean iteration, or max_iter with
//   the last iteration's bits when the budget runs out (the check pass at
//   the budget only computes the syndrome).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;     // a block: groups x threads
constexpr int kMaxDv = 8;             // MAX_COL_WEIGHT; parity columns have 2
constexpr int kNoEdge = 0xFFFF;       // vslot past a variable's degree
constexpr int kGap = 0xFFFF;          // src of a deinterleave gap
constexpr int kLlrMax = 32000;        // saturation bound (ldpc.h:15-17)
constexpr int kLlrInfinity = 30000;   // hard-decision channel magnitude
constexpr int kLlrScale = 256;        // int8 channel LLR scale (ldpc.c:27)

// Input forms: packed hard bytes (K4), int8 soft LLRs (K5), and expanded
// int16 llr rows without (hard) or with (soft) channel rows (K6).
enum Mode { kHardPacked = 0, kSoftLlr8 = 1, kHardLlr = 2, kSoftLlr = 3 };

struct Params {
  const void* in;          // [B, ceil(V/8)] u8 | [B, V] i8 | [B, V] i16
  const int16_t* chan;     // [B, V] i16 channel (kSoftLlr only)
  const uint8_t* graph;    // layout: runs, vslot, src (graph_bytes)
  void* out;               // [B, ceil(V/8)] u8 packed bits | [B, V] i8 bits
  uint8_t* ok_out;         // [B] bool
  int32_t* iters_out;      // [B]
  int* counter;            // next codeword index, zeroed by the wrapper
  int batch, V, P, E, runs, dv, has_src, max_iter, groups, threads;
};

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// The layout's byte offsets, as models/ldpc_cuda.py packs it: `runs`
// int4 {first check, degree, checks, first edge}, then vslot[dv][V], then,
// for a code with an inner interleaver, src[V] (the input position of each
// variable, kGap for a gap); uint16, each 16-byte aligned.
__host__ __device__ inline int vslot_offset(int runs) { return 16 * runs; }
__host__ __device__ inline int src_offset(int runs, int dv, int V) {
  return align16(vslot_offset(runs) + 2 * dv * V);
}
__host__ __device__ inline int graph_bytes(int runs, int dv, int V, int has_src) {
  return src_offset(runs, dv, V) + (has_src ? align16(2 * V) : 0);
}

// One codeword group's shared state: the next codeword index (16 bytes),
// the hard-decision bitmap, v2c, c2v, and the llr or channel per variable.
__host__ __device__ inline int bitmap_words(int V) { return (V + 31) / 32; }
__host__ __device__ inline int state_bytes(int V, int E) {
  return 16 + align16(4 * bitmap_words(V)) + 2 * align16(2 * E) + align16(2 * V);
}

__host__ __device__ inline int block_smem(const Params& p, bool shared_graph) {
  const int graph =
      shared_graph ? graph_bytes(p.runs, p.dv, p.V, p.has_src) : vslot_offset(p.runs);
  return graph + p.groups * state_bytes(p.V, p.E);
}

__device__ __forceinline__ int sat(int x) {
  return min(max(x, -kLlrMax), kLlrMax);
}

__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// True when any thread of the group passes true; a barrier of the group.
__device__ __forceinline__ bool group_any(bool x, int id, int n) {
  int r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.s32 q, %1, 0;\n\t"
      "bar.red.or.pred p, %2, %3, q;\n\t"
      "selp.s32 %0, 1, 0, p;\n\t}"
      : "=r"(r)
      : "r"((int)x), "r"(id), "r"(n)
      : "memory");
  return r != 0;
}

template <bool kShared>
__device__ __forceinline__ int load_index(const uint16_t* p) {
  if constexpr (kShared) return *p;
  else return __ldg(p);
}

// The run of check c: walks `r` forward over the degree-sorted runs (a
// thread's checks only grow) and returns the edge of slot 0 of check c;
// the run's degree and stride are runs[r].y and runs[r].z.
__device__ __forceinline__ int check_base(const int4* runs, int c, int& r, int4& run) {
  while (c >= run.x + run.z) run = runs[++r];
  return run.w + (c - run.x);
}

// The check pass, fused with the syndrome of the last hard decision.
// Check update (when `update`): normalized two-minimum min-sum, alpha =
// 15/16 truncating; every edge whose |v2c| equals m1 gets m2.  Syndrome:
// true when every check is satisfied; each edge counts, so a pair of
// parallel edges cancels.  The hard decision of an edge's variable is the
// sign of v2c + c2v at that edge (c2v not yet overwritten: the value the
// var pass used): v2c = sat(total - c2v) with |c2v| <= 30000 < 32000, so
// v2c + c2v is total where v2c did not saturate and has total's sign where
// it did.  On the `first` pass, before any c2v, it is the sign of v2c
// (llr_0).  Sign bits are folded by XOR: sx's is the check's parity, sh's
// its syndrome bit.  Ends in the group's barrier.
__device__ bool check_pass(const int4* runs, const int16_t* __restrict__ v2c,
                           int16_t* __restrict__ c2v, bool first, bool update, int P, int gt,
                           int T, int bar) {
  int bad = 0, r = 0;
  int4 run = runs[0];
  for (int c = gt; c < P; c += T) {
    const int e0 = check_base(runs, c, r, run);
    const int d = run.y, n = run.z;
    int m1 = kLlrMax, m2 = kLlrMax, sx = 0, sh = 0;
#pragma unroll 4
    for (int k = 0, e = e0; k < d; ++k, e += n) {
      const int x = v2c[e], a = abs(x);
      sx ^= x;
      sh ^= first ? x : x + c2v[e];
      m2 = min(m2, max(m1, a));
      m1 = min(m1, a);
    }
    bad |= sh;
    if (!update) continue;
    const int a1 = (m1 * 15) >> 4, a2 = (m2 * 15) >> 4;
#pragma unroll 4
    for (int k = 0, e = e0; k < d; ++k, e += n) {
      const int x = v2c[e];
      const int mag = abs(x) == m1 ? a2 : a1;
      c2v[e] = (int16_t)((sx ^ x) < 0 ? -mag : mag);
    }
  }
  return !group_any(bad < 0, bar, T);
}

// DV: vslot rows the var loops unroll (>= p.dv).
template <int MODE, bool kShared, int DV>
__global__ void __launch_bounds__(kMaxThreads, 1) ldpc_bp_kernel(const Params p) {
  constexpr bool kSoft = MODE == kSoftLlr8 || MODE == kSoftLlr;
  extern __shared__ __align__(16) uint8_t smem[];
  const int V = p.V, P = p.P, E = p.E, T = p.threads;

  // Stage the layout (shared form) or only its runs (global form), once.
  const int staged = kShared ? graph_bytes(p.runs, p.dv, V, p.has_src) : vslot_offset(p.runs);
  for (int i = threadIdx.x; i < staged / 16; i += blockDim.x)
    reinterpret_cast<int4*>(smem)[i] = __ldg(reinterpret_cast<const int4*>(p.graph) + i);
  __syncthreads();
  const uint8_t* graph = kShared ? smem : p.graph;
  const int4* runs = reinterpret_cast<const int4*>(smem);
  const uint16_t* vslot = reinterpret_cast<const uint16_t*>(graph + vslot_offset(p.runs));
  const uint16_t* src = p.has_src && (MODE == kHardPacked || MODE == kSoftLlr8)
                            ? reinterpret_cast<const uint16_t*>(graph + src_offset(p.runs, p.dv, V))
                            : nullptr;

  // This thread's group and its state.
  const int grp = threadIdx.x / T, gt = threadIdx.x - grp * T;
  const int bar = 1 + grp, lane = threadIdx.x & 31;
  uint8_t* st = smem + staged + grp * state_bytes(V, E);
  int* next = reinterpret_cast<int*>(st);
  uint32_t* bm = reinterpret_cast<uint32_t*>(st + 16);
  int16_t* v2c = reinterpret_cast<int16_t*>(st + 16 + align16(4 * bitmap_words(V)));
  int16_t* c2v = v2c + align16(2 * E) / 2;
  int16_t* ch = c2v + align16(2 * E) / 2;   // previous llr (hard) | channel (soft)
  const int Vw = 32 * bitmap_words(V);      // var loops run whole warps for the ballots
  const int16_t* in16 = static_cast<const int16_t*>(p.in);

  if (gt == 0) *next = atomicAdd(p.counter, 1);
  group_sync(bar, T);
  int cw = *next;
  while (cw < p.batch) {
    const long long b = cw;
    // Take the group's next codeword now; its latency hides behind this one.
    int taken = 0;
    if (gt == 0) taken = atomicAdd(p.counter, 1);

    // Initial state: the channel per variable, v2c_0 = llr_0 on its edges
    // and the hard decision of llr_0.  A deinterleave gap reads bit 0 or
    // LLR 0 (the zero fill of the JAX deinterleave).
    for (int v = gt; v < Vw; v += T) {
      int l = 0;
      if (v < V) {
        const int s = src ? load_index<kShared>(src + v) : v;
        if (MODE == kHardPacked) {
          // MSB-first bit s of the row
          const uint8_t* row = static_cast<const uint8_t*>(p.in) + b * ((V + 7) / 8);
          const int bit = s != kGap ? (__ldg(row + (s >> 3)) >> (7 - (s & 7))) & 1 : 0;
          l = bit ? -kLlrInfinity : kLlrInfinity;
          ch[v] = (int16_t)l;
        } else if (MODE == kSoftLlr8) {
          // channel w * 256 unclipped (up to +-32512), llr_0 clipped
          const int8_t* row = static_cast<const int8_t*>(p.in) + b * V;
          const int c = s != kGap ? __ldg(row + s) * kLlrScale : 0;
          ch[v] = (int16_t)c;
          l = sat(c);
        } else {
          l = __ldg(in16 + b * V + v);
          ch[v] = kSoft ? __ldg(p.chan + b * V + v) : (int16_t)l;
        }
#pragma unroll
        for (int k = 0; k < DV; ++k) {
          const int e = k < p.dv ? load_index<kShared>(vslot + k * V + v) : kNoEdge;
          if (e != kNoEdge) v2c[e] = (int16_t)l;
        }
      }
      const unsigned word = __ballot_sync(0xffffffffu, l < 0);
      if (lane == 0) bm[v >> 5] = word;
    }
    group_sync(bar, T);

    // Step t: the check pass of iteration t + 1 fused with the syndrome of
    // iteration t's hard decision, then iteration t + 1's var pass.  The
    // hard modes check llr_0 (a clean input reports 0 iterations); the
    // soft modes do not.  At the budget only the syndrome counts.
    bool ok = false;
    int t = 0;
    for (;;) {
      const bool clean =
          check_pass(runs, v2c, c2v, t == 0, t < p.max_iter, P, gt, T, bar);
      if (clean && (t > 0 || !kSoft)) {
        ok = true;
        break;
      }
      if (t == p.max_iter) break;
      ++t;
      // Var pass: total = channel + sum of c2v in int32, unsaturated;
      // llr = sat(total), v2c_e = sat(total - c2v_e).  The hard channel is
      // the previous iteration's saturated llr.
      for (int v = gt; v < Vw; v += T) {
        int e[DV], m[DV];
        int total = v < V ? ch[v] : 0;
#pragma unroll
        for (int k = 0; k < DV; ++k) {
          e[k] = v < V && k < p.dv ? load_index<kShared>(vslot + k * V + v) : kNoEdge;
          m[k] = e[k] != kNoEdge ? c2v[e[k]] : 0;
          total += m[k];
        }
        if (!kSoft && v < V) ch[v] = (int16_t)sat(total);
#pragma unroll
        for (int k = 0; k < DV; ++k)
          if (e[k] != kNoEdge) v2c[e[k]] = (int16_t)sat(total - m[k]);
        const unsigned word = __ballot_sync(0xffffffffu, total < 0);
        if (lane == 0) bm[v >> 5] = word;
      }
      group_sync(bar, T);
    }
    const int iters = t;

    // Outputs: the hard decision of the first clean iteration, or of the
    // last one when the budget ran out.  Bits past V are 0 in the bitmap.
    if (MODE == kHardLlr || MODE == kSoftLlr) {
      int8_t* bits = static_cast<int8_t*>(p.out) + b * V;
      for (int v = gt; v < V; v += T) bits[v] = (bm[v >> 5] >> (v & 31)) & 1;
    } else {
      // byte j holds variables 8j..8j+7, MSB first
      const int nbytes = (V + 7) / 8;
      uint8_t* bytes = static_cast<uint8_t*>(p.out) + b * nbytes;
      for (int j = gt; j < nbytes; j += T)
        bytes[j] = (uint8_t)(__brev(bm[j >> 2]) >> (24 - 8 * (j & 3)));
    }
    if (gt == 0) {
      p.ok_out[b] = ok;
      p.iters_out[b] = iters;
      *next = taken;
    }
    group_sync(bar, T);
    cw = *next;
  }
}

using KernelFn = void (*)(Params);

template <int MODE>
KernelFn kernel_for(bool shared_graph, int dv) {
  if (dv <= 3)
    return shared_graph ? ldpc_bp_kernel<MODE, true, 3> : ldpc_bp_kernel<MODE, false, 3>;
  return shared_graph ? ldpc_bp_kernel<MODE, true, kMaxDv> : ldpc_bp_kernel<MODE, false, kMaxDv>;
}

// The instance for a mode, form and variable degree: the var loops unroll
// 3 slots where every variable has at most 3 edges (column weight 3, the
// presets), else kMaxDv.
KernelFn kernel_for(int mode, bool shared_graph, int dv) {
  switch (mode) {
    case kHardPacked: return kernel_for<kHardPacked>(shared_graph, dv);
    case kSoftLlr8: return kernel_for<kSoftLlr8>(shared_graph, dv);
    case kHardLlr: return kernel_for<kHardLlr>(shared_graph, dv);
    case kSoftLlr: return kernel_for<kSoftLlr>(shared_graph, dv);
    default: return nullptr;
  }
}

// Checks the sizes, selects the device and sets the kernel's shared memory.
cudaError_t prepare(const Params& p, int mode, bool shared_graph, int device,
                    KernelFn* fn, int* smem) {
  if (p.V < 1 || p.P < 1 || p.E < 1 || p.E > 65535 || p.V > 65535 || p.runs < 1 ||
      p.dv < 1 || p.dv > kMaxDv || p.groups < 1 || p.threads < 32 || p.threads % 32 ||
      p.groups * p.threads > kMaxThreads || p.groups > 15)
    return cudaErrorInvalidValue;
  *fn = kernel_for(mode, shared_graph, p.dv);
  if (*fn == nullptr) return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  *smem = block_smem(p, shared_graph);
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(*fn),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

Params make_params(int V, int P, int E, int runs, int dv, int has_src, int groups,
                   int threads) {
  Params p = {};
  p.has_src = has_src;
  p.V = V;
  p.P = P;
  p.E = E;
  p.runs = runs;
  p.dv = dv;
  p.groups = groups;
  p.threads = threads;
  return p;
}

}  // namespace

// Blocks of `groups` x `threads` threads that one SM holds at once, for
// this mode and form (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a
// negative cudaError_t.
extern "C" int pp_ldpc_bp_blocks_per_sm(int mode, int V, int P, int E, int runs, int dv,
                                        int has_src, int shared_graph, int groups,
                                        int threads, int device) {
  const Params p = make_params(V, P, E, runs, dv, has_src, groups, threads);
  KernelFn fn;
  int smem, blocks = 0;
  cudaError_t err = prepare(p, mode, shared_graph != 0, device, &fn, &smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, reinterpret_cast<const void*>(fn), groups * threads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Launches the decode of `batch` codewords on `stream` (a cudaStream_t) of
// `device` as `grid` persistent blocks; allocates nothing.  mode: 0 packed
// hard bytes, 1 int8 soft LLRs, 2 expanded hard llr, 3 expanded soft llr
// plus channel (`chan`).  `graph` is the layout (models/ldpc_cuda.py
// `kernel_layout`): `runs` degree runs, dv slots a variable, and with
// has_src the inner deinterleaver's gather (read in modes 0 and 1);
// `counter` one int32 set to 0.  shared_graph: 1 stages the layout in
// shared memory, 0 reads it from global memory.  Returns the launch's
// cudaError_t.
extern "C" int pp_ldpc_bp(int mode, const void* in, const void* chan, const void* graph,
                          void* out, void* ok_out, void* iters_out, void* counter, int batch,
                          int V, int P, int E, int runs, int dv, int has_src, int max_iter,
                          int shared_graph, int groups, int threads, int grid, int device,
                          void* stream) {
  if (batch < 1 || max_iter < 1 || grid < 1 || counter == nullptr)
    return (int)cudaErrorInvalidValue;
  if (mode == kSoftLlr && chan == nullptr) return (int)cudaErrorInvalidValue;
  Params p = make_params(V, P, E, runs, dv, has_src, groups, threads);
  p.in = in;
  p.chan = static_cast<const int16_t*>(chan);
  p.graph = static_cast<const uint8_t*>(graph);
  p.out = out;
  p.ok_out = static_cast<uint8_t*>(ok_out);
  p.iters_out = static_cast<int32_t*>(iters_out);
  p.counter = static_cast<int*>(counter);
  p.batch = batch;
  p.max_iter = max_iter;
  KernelFn fn;
  int smem;
  const cudaError_t err = prepare(p, mode, shared_graph != 0, device, &fn, &smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  const cudaError_t launched = cudaLaunchKernel(
      reinterpret_cast<const void*>(fn), dim3((unsigned)grid), dim3((unsigned)(groups * threads)),
      args, (size_t)smem, static_cast<cudaStream_t>(stream));
  return (int)(launched != cudaSuccess ? launched : cudaGetLastError());
}
