// Run-length histogram of a sorted key stream, for Hopper (sm_90a).
//
// Replaces the Pallas kernel fastk_tpu/ops/histker.py:_walk_kernel (launched
// by _run_walk). Input: the run starts of a sorted key batch as a bitmask,
// LSB-first (bit b of word w = start at position 32w + b); bits at and after
// valid_end are ignored, and position 0 always starts a run. Every run begins
// at a start and ends at the next start, or at valid_end for the last run.
// Output: hist[len] += 1 for every run, len clipped at 32767 (hist[0] = 0).
//
// The TPU kernel walked the words in order on the scalar core, carrying the
// previous start from one grid step to the next. Here blocks run in parallel
// and carry nothing, so each run must find its end without a serial walk.
//
// What bounds it on the H100: one read of size/8 bytes of start words (8 MiB
// at 2^26 positions, about 2.5 us at 3.35 TB/s) and a 256 KiB histogram
// written once; the operations, one per run start, are few. The design keeps
// every thread on its own 16 bytes and no run end further than a register:
//
// - Tiles. A block walks contiguous tiles of 1024 words (32768 positions),
//   256 threads each holding 4 words (one 128-bit load). A run that leaves a
//   tile either ends within the next tile or is longer than 32767 and clips,
//   so the start that ends a tile's last run is the next tile's first start,
//   found by the block in parallel (warp 0 reads the next tile's first 128
//   words; only if those hold no start does the rest of the block read the
//   other 896), capped at valid_end and at 65536 tile positions.
// - Run ends by a scan, not a walk. The start after a thread's 128
//   positions is the next lane's first start; where a lane has none, the
//   warp takes a suffix minimum by shuffles, and a lane still without one
//   takes the later warps' first starts (one value a warp in shared memory),
//   else the next tile's. Inside a thread the next start is the next set
//   bit of the same word or the first of its next words, all in registers.
// - Binning by cost. Runs of length 1 (adjacent starts: error k-mers, most
//   runs of a real batch) are counted by popcount and never walked. Where a
//   warp holds many short runs (a lane with three or more starts left in
//   two of its words, as in a random mask), lengths 2-9 are found
//   bit-parallel too: a start whose first end lies d positions on, for d =
//   2..9, by funnel shifts and popcounts. Each lane walks the starts left
//   in two independent chains (words 0-1 and 2-3). Lengths 2-9 are counted
//   in eight-bit fields of one register and summed per warp once a tile
//   (only the lengths the warp saw); lengths 10-2047 go to an 8 KiB shared
//   histogram, whose atomics the compiler aggregates per warp, and longer
//   ones (k-mers seen 2048 times or more, rare) straight to global atomics.
//   The closing flush adds only the nonzero shared bins into the int64
//   output. (Combining equal lengths with __match_any_sync before the
//   atomic cost more than it saved on the H100.)
// - One barrier a tile: the warps' first starts and the next tile's go
//   through shared memory kept by tile parity, so no barrier clears them.
// - Several blocks per SM: the grid is the resident block count (occupancy
//   read once per device) or the tile count, whichever is smaller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNBins = 32768;
constexpr int kHigh = kNBins - 1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileWords = 4 * kThreads;   // 1024 words
constexpr int kTilePos = 32 * kTileWords;  // 32768 positions
constexpr int kCut = 2048;                 // shared bins below this length
constexpr int kSmall = 10;                 // lengths 2..9 in registers
constexpr int kNone = 1 << 30;             // no start
constexpr unsigned kFull = 0xffffffffu;

struct Src {
  const uint32_t* words;
  long long nwords;    // words in the array
  long long nw;        // words holding a position below valid_end
  uint32_t tail_mask;  // the valid bits of word nw - 1
  int vec;             // the array is 16-byte aligned
};

__device__ __forceinline__ uint32_t valid_bits(const Src& s, long long w,
                                               uint32_t x) {
  if (w >= s.nw) return 0u;
  if (w == s.nw - 1) x &= s.tail_mask;
  if (w == 0) x |= 1u;
  return x;
}

// words [w, w + 4), w a multiple of 4, cleared at and after valid_end
__device__ __forceinline__ uint4 load4(const Src& s, long long w) {
  uint4 v;
  if (s.vec && w + 4 <= s.nwords) {
    v = __ldg(reinterpret_cast<const uint4*>(s.words + w));
  } else {
    v.x = w < s.nwords ? __ldg(s.words + w) : 0u;
    v.y = w + 1 < s.nwords ? __ldg(s.words + w + 1) : 0u;
    v.z = w + 2 < s.nwords ? __ldg(s.words + w + 2) : 0u;
    v.w = w + 3 < s.nwords ? __ldg(s.words + w + 3) : 0u;
  }
  if (w == 0 || w + 4 >= s.nw) {
    v.x = valid_bits(s, w, v.x);
    v.y = valid_bits(s, w + 1, v.y);
    v.z = valid_bits(s, w + 2, v.z);
    v.w = valid_bits(s, w + 3, v.w);
  }
  return v;
}

// the first start among 128 positions, or kNone
__device__ __forceinline__ int first_pos(const uint4& v) {
  const uint32_t x = v.x ? v.x : v.y ? v.y : v.z ? v.z : v.w;
  const int base = v.x ? 0 : v.y ? 32 : v.z ? 64 : 96;
  return x ? base + __ffs((int)x) - 1 : kNone;
}

// at least three bits set
__device__ __forceinline__ bool three(uint32_t x) {
  x &= x - 1;
  x &= x - 1;
  return x != 0;
}

__global__ void __launch_bounds__(kThreads, 4)
run_hist_kernel(Src src, long long valid_end, long long ntiles,
                unsigned long long* __restrict__ hist) {
  __shared__ int sh[kCut];
  __shared__ int warp_first[2][kWarps];  // by tile parity: one barrier a tile
  __shared__ int next_first[2];
  __shared__ int rest_first[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kCut; i += kThreads) sh[i] = 0;
  unsigned ones = 0;  // runs of length 1 seen by this thread
  int par = 0;

  for (long long tile = blockIdx.x; tile < ntiles;
       tile += gridDim.x, par ^= 1) {
    const long long w0 = tile * kTileWords;
    const long long rem = valid_end - tile * (long long)kTilePos;
    const int end_rel = (int)min(rem, 2LL * kTilePos);
    const bool look = rem > kTilePos;  // a next tile holds valid positions
    const uint4 v = load4(src, w0 + 4 * tid);
    // warp 0: the first start in the next tile's first 128 words
    int head = kNone;
    if (warp == 0 && look) {
      const int f = first_pos(load4(src, w0 + kTileWords + 4 * lane));
      head = __reduce_min_sync(kFull, f == kNone ? kNone : 128 * lane + f);
    }
    // the first start after this thread's 128 positions: the next lane's
    // first start, else a suffix minimum over the later lanes, else over
    // the later warps' first starts, else the next tile's
    const int f = first_pos(v);
    const int fr = f == kNone ? kNone : 128 * tid + f;
    int after = __shfl_down_sync(kFull, fr, 1);
    if (lane == 31) after = kNone;
    const int wmin = __reduce_min_sync(kFull, fr);
    if (__any_sync(kFull, after == kNone && lane != 31)) {
      int suf = fr;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_down_sync(kFull, suf, off);
        if (lane + off < 32) suf = min(suf, o);
      }
      after = __shfl_down_sync(kFull, suf, 1);
      if (lane == 31) after = kNone;
    }
    if (lane == 0) {
      warp_first[par][warp] = wmin;
      if (warp == 0) next_first[par] = head;
    }
    __syncthreads();
    int nf = next_first[par];
    if (look && nf == kNone) {  // the same for the whole block
      const int g = tid >= 32
          ? first_pos(load4(src, w0 + kTileWords + 4 * tid)) : kNone;
      const int gm = __reduce_min_sync(kFull, g == kNone ? kNone
                                                         : 128 * tid + g);
      if (lane == 0) rest_first[warp] = gm;
      __syncthreads();
      for (int j = 0; j < kWarps; ++j) nf = min(nf, rest_first[j]);
    }
    if (after == kNone) {
      for (int j = warp + 1; j < kWarps; ++j)
        after = min(after, warp_first[par][j]);
    }
    const int tile_next =
        (look && nf != kNone) ? min(kTilePos + nf, end_rel) : end_rel;
    // thread-relative positions from here on
    const int next = min(after, tile_next) - 128 * tid;

    // the positions that end a run: the starts, and the next start (or
    // valid_end) when it lies within 32 positions of this thread's end
    uint32_t t0 = v.x, t1 = v.y, t2 = v.z, t3 = v.w, t4 = 0;
    if (next >= 0 && next < 160) {
      const uint32_t bit = 1u << (next & 31);
      switch (next >> 5) {
        case 0: t0 |= bit; break;
        case 1: t1 |= bit; break;
        case 2: t2 |= bit; break;
        case 3: t3 |= bit; break;
        default: t4 = bit;
      }
    }
    // runs of length 1: a start whose next position ends it
    uint32_t f0 = v.x & __funnelshift_r(t0, t1, 1);
    uint32_t f1 = v.y & __funnelshift_r(t1, t2, 1);
    uint32_t f2 = v.z & __funnelshift_r(t2, t3, 1);
    uint32_t f3 = v.w & __funnelshift_r(t3, t4, 1);
    ones += __popc(f0) + __popc(f1) + __popc(f2) + __popc(f3);

    unsigned long long small = 0;  // lengths 2-9, eight bits each
    // where many starts remain (short runs, dense: a lane holds three or
    // more in both its first and its third word), lengths 2-9 are found
    // bit-parallel: a start whose first end lies d positions on
    const bool dense = three(v.x & ~f0) && three(v.z & ~f2);
    if (__any_sync(kFull, dense)) {
#pragma unroll
      for (int d = 2; d < 10; ++d) {
        const uint32_t h0 = v.x & __funnelshift_r(t0, t1, d) & ~f0;
        const uint32_t h1 = v.y & __funnelshift_r(t1, t2, d) & ~f1;
        const uint32_t h2 = v.z & __funnelshift_r(t2, t3, d) & ~f2;
        const uint32_t h3 = v.w & __funnelshift_r(t3, t4, d) & ~f3;
        f0 |= h0;
        f1 |= h1;
        f2 |= h2;
        f3 |= h3;
        small += (unsigned long long)(__popc(h0) + __popc(h1) + __popc(h2)
                                      + __popc(h3)) << (8 * (d - 2));
      }
    }
    const uint32_t m1 = v.y & ~f1, m2 = v.z & ~f2, m3 = v.w & ~f3;
    // the first start after word i
    const int n3 = next;
    const int n2 = v.w ? 95 + __ffs((int)v.w) : n3;
    const int n1 = v.z ? 63 + __ffs((int)v.z) : n2;
    const int n0 = v.y ? 31 + __ffs((int)v.y) : n1;

    // the other starts, walked by each lane in two independent chains
    // (words 0-1 and words 2-3), a start of each per step
    const auto bin = [&](int len) {
      if (len < kSmall) {  // 2 or more: the runs of 1 are counted above
        small += 1ull << (8 * (len - 2));
      } else if (len < kCut) {
        atomicAdd(&sh[len], 1);
      } else {
        atomicAdd(&hist[len], 1ull);
      }
    };
    uint32_t ma = v.x & ~f0, sa = v.x, mb = m2, sb = v.z;
    int wa = 0, na = n0, wb = 2, nb = n2;
    if (!ma) { ma = m1; sa = v.y; wa = 1; na = n1; }
    if (!mb) { mb = m3; sb = v.w; wb = 3; nb = n3; }
    while (ma | mb) {
      if (ma) {
        const int b = __ffs((int)ma) - 1;
        ma &= ma - 1;
        const uint32_t above = (sa >> b) >> 1;
        bin(above ? __ffs((int)above) : min(na - (32 * wa + b), kHigh));
        if (!ma && wa == 0) { ma = m1; sa = v.y; wa = 1; na = n1; }
      }
      if (mb) {
        const int b = __ffs((int)mb) - 1;
        mb &= mb - 1;
        const uint32_t above = (sb >> b) >> 1;
        bin(above ? __ffs((int)above) : min(nb - (32 * wb + b), kHigh));
        if (!mb && wb == 2) { mb = m3; sb = v.w; wb = 3; nb = n3; }
      }
    }
    // the register counts into the shared bins, only the lengths the warp
    // saw (at most 64 runs of one length a thread and tile: no field
    // overflows)
    const unsigned seen[2] = {
        __reduce_or_sync(kFull, (unsigned)small),
        __reduce_or_sync(kFull, (unsigned)(small >> 32))};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if ((seen[j >> 2] >> (8 * (j & 3))) & 0xffu) {
        const unsigned c = __reduce_add_sync(
            kFull, (unsigned)((small >> (8 * j)) & 0xffu));
        if (lane == 0) atomicAdd(&sh[2 + j], (int)c);
      }
    }
  }

  ones = __reduce_add_sync(kFull, ones);
  if (lane == 0 && ones) atomicAdd(&sh[1], (int)ones);
  __syncthreads();
  for (int i = tid; i < kCut; i += kThreads) {
    const int c = sh[i];
    if (c) atomicAdd(&hist[i], (unsigned long long)c);
  }
}

int g_grid[64];  // resident blocks of the kernel on each device, 0 = unread

}  // namespace

// words: int32 [nwords] on the device; hist: int64 [32768] on the device,
// zeroed here. Launches on `stream` without synchronising. Returns the CUDA
// error of the launch (0 on success).
extern "C" int fk_run_hist(const void* words, long long nwords,
                           long long valid_end, void* hist, void* stream) {
  if (valid_end < 0 || valid_end > nwords * 32)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!g_grid[dev]) {
    int sms = 0, occ = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, run_hist_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    g_grid[dev] = sms * (occ > 0 ? occ : 1);
  }
  cudaStream_t st = (cudaStream_t)stream;
  err = cudaMemsetAsync(hist, 0, kNBins * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  Src src;
  src.words = (const uint32_t*)words;
  src.nwords = nwords;
  src.nw = (valid_end + 31) >> 5;
  const int tail = (int)(valid_end & 31);
  src.tail_mask = tail ? (1u << tail) - 1u : 0xffffffffu;
  src.vec = ((uintptr_t)words & 15) == 0;
  const long long ntiles = (src.nw + kTileWords - 1) / kTileWords;
  long long blocks = ntiles < g_grid[dev] ? ntiles : g_grid[dev];
  if (blocks < 1) blocks = 1;
  run_hist_kernel<<<(int)blocks, kThreads, 0, st>>>(
      src, valid_end, ntiles, (unsigned long long*)hist);
  return (int)cudaGetLastError();
}

// The run-length kernel's resident blocks per SM, for the record (0 when
// the occupancy query fails).
extern "C" int fk_run_hist_blocks_per_sm(void) {
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, run_hist_kernel, kThreads, 0) != cudaSuccess)
    return 0;
  return occ;
}

extern "C" const char* fk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
