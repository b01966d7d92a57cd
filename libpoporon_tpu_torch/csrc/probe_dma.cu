// Row-gather and contiguous-copy probes for Hopper: how fast the card moves
// rows of [sub, 128] int32 from device memory (or from L2) into shared memory
// with its bulk-copy engine.
//
// Replaces the three Pallas DMA probes of benchmarks/probe_dma.py:
// `gather_flood` (:43, pallas_call :84), `gather_ring` (:94, :136) and
// `plane_copy` (:146, :161).  Each computes what its Pallas function
// computes, the [8, 128] int32 block `out` (the first 8 sublanes of the
// first gathered row, or src[0:8] for the plane), and also two proofs of
// the copies: a checksum, the wrapping uint32 sum of every word the last
// repeat brought into shared memory, so that a probe which copies nothing
// but row 0 cannot pass; and `landed`, the bytes that the completed
// mbarrier phases of all repeats announced, so that a probe which skips
// repeats cannot pass either.  The plain PyTorch versions are in
// libpoporon_tpu_torch/benchmarks/probe_dma.py.
//
// What bounds it on an H100: bytes.  A call moves repeat * rows * sub * 512
// bytes into shared memory (plus the index list and 4 KB of output) and does
// almost no arithmetic.  Of those, device memory must give its distinct rows
// once and, on each later repeat, all but the 50 MB the L2 can have kept;
// its least time is those bytes over the 3.35 TB/s of HBM.  Where the
// gathered set fits L2 (the JAX shapes, 8 to 32 MB), repeats after the
// first read L2 and no device-memory bound applies.
//
// Design.  The TPU form (one program on one core, a VMEM scratch of
// rows * sub * 512 bytes, DMA semaphores) does not fit an SM, so:
// - The grid has min(items, SMs) blocks of 128 threads.  Block b takes a
//   contiguous share of the rows (of the plane's 4 KB chunks for
//   plane_copy), ragged at the edge, and loops over `repeat` itself.
// - One thread issues each row (or plane piece) as one 1-D bulk copy,
//   cp.async.bulk global -> shared; an mbarrier counts its bytes and plays
//   the DMA semaphore.  Sizes and addresses are multiples of 16 bytes.
// - flood: each wave issues as many rows as the block's slots hold (at most
//   192 KB), all on one mbarrier with one expect_tx, and waits once.
// - ring: `depth` slots with one mbarrier each; start row k, wait row
//   k - depth, the wait's parity flipping per reuse of the slot; drained at
//   the end of every repeat, as the Pallas ring is.
// - plane: the block's share in pieces of up to 96 KB through a ring of two
//   slots, so one piece lands while the next is in flight.
// - Repeats before the last run on the issuing thread alone; in the last
//   one every thread waits for each slot, adds its words to the checksum,
//   and syncs before the slot is written again.  The issuing thread adds
//   the bytes of each wait it passes, in every repeat.  One atomic per block
//   adds the block's sum, one more its bytes.  Source offsets are 64-bit.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSublaneBytes = 128 * 4;      // one sublane of 128 int32
constexpr int kChunkBytes = 8 * kSublaneBytes;  // the [8, 128] block, 4 KB
constexpr int kOutWords = 8 * 128;
constexpr int kSlotBytes = 192 * 1024;      // slot memory of one block
constexpr int kMaxDepth = 32;               // mbarriers of one block's ring

enum Mode { kFlood = 0, kRing = 1, kPlane = 2 };

struct Params {
  const int32_t* idx;      // [rows] source row of each gathered row
  const uint8_t* src;      // [nsrc * sub, 128] int32
  int32_t* out;            // [8, 128]
  uint32_t* checksum;      // low word of a zeroed int64: the uint32 sum
  unsigned long long* landed;  // a zeroed int64: bytes of the passed waits
  long long nsrc;
  int rows, sub, repeat;
  int depth;               // ring slots (ring, plane)
  int nslots;              // rows per wave (flood)
  int slot_bytes;          // bytes of one slot
  int piece_chunks;        // 4 KB chunks per plane piece
};

// A block's contiguous share of the items: rows, or the plane's chunks.
struct Share {
  long long begin, end;
  int n;                   // rows, or plane pieces
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The issuing thread's arrival, announcing `bytes` of copies to come.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* from, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem(dst)), "l"(__cvta_generic_to_global(from)), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// Orders this block's earlier reads of shared memory before the copy
// engine's next writes to it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int MODE>
__device__ Share share_of(const Params& p) {
  const long long total = MODE == kPlane ? (long long)p.rows * p.sub / 8 : p.rows;
  const long long b = blockIdx.x, g = gridDim.x;
  Share s;
  s.begin = total * b / g;
  s.end = total * (b + 1) / g;
  const long long len = s.end - s.begin;
  s.n = (int)(MODE == kPlane ? (len + p.piece_chunks - 1) / p.piece_chunks : len);
  return s;
}

// Size of item k of the block's share.
template <int MODE>
__device__ __forceinline__ uint32_t item_bytes(const Params& p, const Share& s, int k) {
  if (MODE == kPlane) {
    const long long c = s.begin + (long long)k * p.piece_chunks;
    return (uint32_t)(min((long long)p.piece_chunks, s.end - c) * kChunkBytes);
  }
  return (uint32_t)p.sub * kSublaneBytes;
}

// Source and size of item k of the block's share.
template <int MODE>
__device__ const uint8_t* item(const Params& p, const Share& s, int k, uint32_t* bytes) {
  *bytes = item_bytes<MODE>(p, s, k);
  if (MODE == kPlane) return p.src + (size_t)(s.begin + (long long)k * p.piece_chunks) * kChunkBytes;
  const long long j = __ldg(p.idx + s.begin + k);
  assert(j >= 0 && j < p.nsrc);
  return p.src + (size_t)j * p.sub * kSublaneBytes;
}

// This thread's share of the wrapping sum of a slot's words.
__device__ __forceinline__ uint32_t sum_words(const uint8_t* slot, uint32_t bytes) {
  const uint4* v = reinterpret_cast<const uint4*>(slot);
  uint32_t acc = 0;
  for (uint32_t i = threadIdx.x; i < bytes / 16; i += kThreads) {
    const uint4 w = v[i];
    acc += w.x + w.y + w.z + w.w;
  }
  return acc;
}

__device__ __forceinline__ void write_out(const uint8_t* slot, int32_t* out) {
  const int32_t* w = reinterpret_cast<const int32_t*>(slot);
  for (int i = threadIdx.x; i < kOutWords; i += kThreads) out[i] = w[i];
}

// Adds the block's sum of every thread's acc to *checksum, and thread 0's
// count of landed bytes to *landed, with one atomic each.
__device__ void block_add(uint32_t acc, uint32_t* checksum, unsigned long long bytes,
                          unsigned long long* landed) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    atomicAdd(checksum, total);
    atomicAdd(landed, bytes);
  }
}

// K7: waves of up to nslots rows on one mbarrier, one wait per wave.
__global__ void __launch_bounds__(kThreads) flood_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t slots[];
  __shared__ __align__(8) uint64_t bar;
  const Share s = share_of<kFlood>(p);
  const int W = p.nslots, waves = (s.n + W - 1) / W;
  const uint32_t row_bytes = (uint32_t)p.sub * kSublaneBytes;
  if (threadIdx.x == 0) {
    bar_init(&bar);
    bar_fence_init();
  }
  __syncthreads();

  // Issues wave w (thread 0) and waits for it; returns its row count.
  auto wave = [&](int w, long long seq) {
    const int k0 = w * W, m = min(W, s.n - k0);
    if (threadIdx.x == 0) {
      bar_expect(&bar, (uint32_t)m * row_bytes);
      for (int i = 0; i < m; ++i) {
        uint32_t bytes;
        const uint8_t* from = item<kFlood>(p, s, k0 + i, &bytes);
        bulk_copy(slots + (size_t)i * row_bytes, from, bytes, &bar);
      }
    }
    bar_wait(&bar, (uint32_t)(seq & 1));
    return m;
  };

  unsigned long long landed = 0;   // thread 0's count
  if (threadIdx.x == 0)
    for (int r = 0; r + 1 < p.repeat; ++r)
      for (int w = 0; w < waves; ++w)
        landed += (unsigned long long)wave(w, (long long)r * waves + w) * row_bytes;
  __syncthreads();
  uint32_t acc = 0;
  for (int w = 0; w < waves; ++w) {
    const int m = wave(w, (long long)(p.repeat - 1) * waves + w);
    landed += (unsigned long long)m * row_bytes;
    for (int i = 0; i < m; ++i) acc += sum_words(slots + (size_t)i * row_bytes, row_bytes);
    if (blockIdx.x == 0 && w == 0) write_out(slots, p.out);
    __syncthreads();
    if (threadIdx.x == 0) fence_proxy_async();
  }
  block_add(acc, p.checksum, landed, p.landed);
}

// Where a block's ring stands: the slot the next item uses, and the parity
// of each slot's next wait (bit d for slot d).  Item q of the block's
// sequence uses slot q % D for the (q / D)-th time; the cursor keeps the
// divisions off the per-row path.
struct Cursor {
  int slot;
  uint32_t parity;
};

// The cursor at sequence number q, every earlier item complete.
__device__ Cursor cursor_at(long long q, int D) {
  Cursor c;
  c.slot = (int)(q % D);
  c.parity = 0;
  for (int d = 0; d < D; ++d) c.parity |= (uint32_t)(((q - d + D - 1) / D) & 1) << d;
  return c;
}

// K8 (gathered rows) and K9 (plane pieces): a ring of `depth` slots, one
// mbarrier each; start item k, wait item k - depth; drain every repeat.
template <int MODE>
__global__ void __launch_bounds__(kThreads) ring_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t slots[];
  __shared__ __align__(8) uint64_t bars[kMaxDepth];
  const Share s = share_of<MODE>(p);
  const int D = p.depth;
  if (threadIdx.x == 0) {
    for (int d = 0; d < D; ++d) bar_init(&bars[d]);
    bar_fence_init();
  }
  __syncthreads();

  uint32_t acc = 0;
  unsigned long long landed = 0;   // thread 0's count
  // One repeat over the block's items from cursor c (every slot idle);
  // with `last`, every thread takes part and sums each item as it lands.
  // Returns the cursor after it.
  auto pass = [&](Cursor c, bool last) {
    int issue = c.slot, waiting = c.slot;
    uint32_t parity = c.parity;
    auto wait_oldest = [&](int k) {
      const int d = waiting;
      bar_wait(&bars[d], (parity >> d) & 1);
      parity ^= 1u << d;
      if (++waiting == D) waiting = 0;
      landed += item_bytes<MODE>(p, s, k);
      if (last) {
        const uint8_t* slot = slots + (size_t)d * p.slot_bytes;
        acc += sum_words(slot, item_bytes<MODE>(p, s, k));
        if (blockIdx.x == 0 && k == 0) write_out(slot, p.out);
      }
    };
    for (int k = 0; k < s.n; ++k) {
      if (k >= D) {
        wait_oldest(k - D);
        if (last) __syncthreads();
      }
      if (threadIdx.x == 0) {
        if (last) fence_proxy_async();
        uint32_t bytes;
        const uint8_t* from = item<MODE>(p, s, k, &bytes);
        bar_expect(&bars[issue], bytes);
        bulk_copy(slots + (size_t)issue * p.slot_bytes, from, bytes, &bars[issue]);
      }
      if (++issue == D) issue = 0;
    }
    for (int k = max(0, s.n - D); k < s.n; ++k) wait_oldest(k);
    Cursor after;
    after.slot = issue;
    after.parity = parity;
    return after;
  };

  if (threadIdx.x == 0) {
    Cursor c = cursor_at(0, D);
    for (int r = 0; r + 1 < p.repeat; ++r) c = pass(c, false);
  }
  __syncthreads();
  pass(cursor_at((long long)(p.repeat - 1) * s.n, D), true);
  block_add(acc, p.checksum, landed, p.landed);
}

template <class Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int grid, size_t smem_bytes,
                   cudaStream_t stream) {
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (set != cudaSuccess) return set;
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Launches one probe on `stream` (a cudaStream_t) of `device`; allocates
// nothing.  mode: 0 gather_flood, 1 gather_ring (`depth` slots a block),
// 2 plane_copy (`idx` unused).  `src` is [nsrc * sub, 128] int32 and 16-byte
// aligned, `idx` [rows] int32 in [0, nsrc) (the kernel asserts it), `out`
// [8, 128] int32, `checksum` an int64 set to 0 by the caller, whose low 32
// bits receive the wrapping uint32 sum (little-endian), `landed` an int64
// set to 0 that receives the bytes of every completed wait.  sub is a
// multiple of 8, at most 384; rows, repeat >= 1; plane_copy needs
// rows <= nsrc.  Returns the launch's cudaError_t.
extern "C" int pp_probe_dma(int mode, const void* idx, const void* src, void* out,
                            void* checksum, void* landed, long long nsrc, int rows,
                            int sub, int repeat, int depth, int device, void* stream) {
  const long long row_bytes = (long long)sub * kSublaneBytes;
  if (rows < 1 || repeat < 1 || nsrc < 1 || sub < 8 || sub % 8 != 0 ||
      row_bytes > kSlotBytes || src == nullptr || out == nullptr || checksum == nullptr ||
      landed == nullptr)
    return (int)cudaErrorInvalidValue;
  if (mode != kPlane && idx == nullptr) return (int)cudaErrorInvalidValue;
  if (mode == kRing && (depth < 1 || depth > kMaxDepth || depth * row_bytes > kSlotBytes))
    return (int)cudaErrorInvalidValue;
  if (mode == kPlane && rows > nsrc) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  Params p = {};
  p.idx = static_cast<const int32_t*>(idx);
  p.src = static_cast<const uint8_t*>(src);
  p.out = static_cast<int32_t*>(out);
  p.checksum = static_cast<uint32_t*>(checksum);
  p.landed = static_cast<unsigned long long*>(landed);
  p.nsrc = nsrc;
  p.rows = rows;
  p.sub = sub;
  p.repeat = repeat;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kPlane) {
    const long long chunks = (long long)rows * sub / 8;
    const int grid = (int)(chunks < sms ? chunks : sms);
    const long long most = (chunks + grid - 1) / grid;
    const long long cap = kSlotBytes / 2 / kChunkBytes;
    p.piece_chunks = (int)(most < cap ? most : cap);
    p.slot_bytes = p.piece_chunks * kChunkBytes;
    p.depth = 2;
    return (int)launch(ring_kernel<kPlane>, p, grid, 2 * (size_t)p.slot_bytes, st);
  }
  const int grid = rows < sms ? rows : sms;
  p.slot_bytes = (int)row_bytes;
  if (mode == kRing) {
    p.depth = depth;
    return (int)launch(ring_kernel<kRing>, p, grid, (size_t)depth * row_bytes, st);
  }
  if (mode != kFlood) return (int)cudaErrorInvalidValue;
  const int most = (rows + grid - 1) / grid;
  const int fit = (int)(kSlotBytes / row_bytes);
  p.nslots = most < fit ? most : fit;
  return (int)launch(flood_kernel, p, grid, (size_t)p.nslots * row_bytes, st);
}
