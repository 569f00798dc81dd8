// The run-end primitives of the run-length histogram, one kernel each, for
// Hopper (sm_90a): the counterparts of the Mosaic feasibility probes that
// came before the TPU's run-length kernel (benchmarks/_pallas_feas*.py).
// Each asked whether the TPU could do one thing the histogram needs; each
// kernel here does that thing on the H100, at any length, so that its time
// can be read beside its bound.
//
// Every entry point launches on the stream it is given, does not
// synchronise, allocates nothing, and returns the CUDA error of its launch
// (0 on success). The wrappers are fastk_tpu_torch/ops/probes.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDev = 64;

int g_sms[kMaxDev];  // SMs of each device, 0 = unread

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDev) return (int)cudaErrorInvalidDevice;
  if (!g_sms[dev]) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = g_sms[dev];
  return 0;
}

__host__ __device__ inline long long min_ll(long long a, long long b) {
  return a < b ? a : b;
}

// ---------------------------------------------------------------------------
// fk_probe_hist: load, store and accumulate at a dynamic index.
//
// Replaces benchmarks/_pallas_feas.py:42 (P1, 16 bins), _pallas_feas2.py:53
// (P5 and P6, 4096 and 32768 bins in SMEM scratch), _pallas_feas3.py:56
// (P11, the same built from while loops), _pallas_feas4.py:28 kernel D
// (P14-D, 1000 increments of a 1024-bin scratch) and, in store mode,
// _pallas_feas2.py:170 (P10, out[x[i]] = i).
//
// Add mode: out[v] = the number of i with x[i] = v, for v in [0, nbins);
// values outside are skipped. Store mode: out[x[i]] = i, where several i
// share a value the largest (the last in order, as in a sequential loop),
// 0 where no value lands. One kernel serves both, the mode a template
// parameter: store mode keeps maxima where add mode keeps counts (shared
// atomicMax of the value's index, the cluster's max, a global atomicMax),
// so it streams x as add mode does. The launcher zeroes out first.
//
// Bound on the H100: bytes. Each value is read once (4 B) and the histogram
// written once; at 2^26 values that is 256 MiB, 80 us at 3.35 TB/s. A
// 32768-bin histogram fills 128 KiB of shared memory (above the 48 KB a
// block gets without asking: the launcher raises the kernel's limit once a
// device), so an SM holds one block of 1024 threads (fewer bins let two
// share an SM). Three things
// stand between that block and the bound, and the kernel answers each:
// - loads in flight: one 4-byte load a thread keeps 4 KiB in flight an SM,
//   several times too little to stream at 3.35 TB/s. Each thread reads
//   kHistUnroll 16-byte pieces at once (64 B; neighbouring threads on
//   neighbouring pieces), then bins their 16 values with shared atomics.
//   A misaligned view's first values (up to 3, before the first 16-byte
//   boundary) and the last n % 4 take scalar loads.
// - the flush: with every bin of every block nonzero, adding each block's
//   histogram to out is blocks x nbins global atomics onto the same bins.
//   Blocks run as clusters of kHistCluster CTAs (Hopper's thread block
//   clusters): after a cluster barrier, CTA r sums (store mode: takes the
//   max of) its r-th slice of the bins over the cluster's CTAs through
//   distributed shared memory and adds each nonzero result to out, so the
//   flush issues nbins global atomics a cluster, kHistCluster times fewer.
//   Clusters of 2 ran fastest at 2^26 values on the H100: 4 and 8 cut the
//   flush further (the fastest on 2^21 values) but ran 4-6 % slower at
//   2^26, as if on 128 of its 132 SMs.
// - shared-atomic conflicts among a warp's lanes, which stay (uniform
//   values spread them over the banks).
// The grid is the clusters the card holds at once (each block strides over
// x), so no block waits for a second wave.

constexpr int kHistThreads = 1024;
constexpr int kHistUnroll = 4;   // 16-byte loads a thread keeps in flight
constexpr int kHistCluster = 2;  // CTAs a cluster
constexpr int kMaxSmem = 232448;  // the most a block may ask for on sm_90

// bins x[i] = v: add mode counts it, store mode keeps the largest i
template <bool kStore>
__device__ __forceinline__ void bin(int* sh, int v, long long i, int nbins) {
  if ((unsigned)v < (unsigned)nbins) {
    if constexpr (kStore)
      atomicMax(sh + v, (int)i);
    else
      atomicAdd(sh + v, 1);
  }
}

// the four values of a 16-byte piece, the first at index i
template <bool kStore>
__device__ __forceinline__ void bin4(int* sh, int4 v, long long i,
                                     int nbins) {
  bin<kStore>(sh, v.x, i, nbins);
  bin<kStore>(sh, v.y, i + 1, nbins);
  bin<kStore>(sh, v.z, i + 2, nbins);
  bin<kStore>(sh, v.w, i + 3, nbins);
}

template <bool kStore>
__global__ void __cluster_dims__(kHistCluster, 1, 1)
    __launch_bounds__(kHistThreads)
probe_hist_kernel(const int* __restrict__ x, long long n, int nbins,
                  int* __restrict__ out) {
  extern __shared__ int sh[];
  cg::cluster_group cluster = cg::this_cluster();
  for (int j = threadIdx.x; j < nbins; j += kHistThreads) sh[j] = 0;
  __syncthreads();
  const long long nt = (long long)gridDim.x * kHistThreads;
  const long long tid = (long long)blockIdx.x * kHistThreads + threadIdx.x;
  // x is 4-byte aligned: head values reach the first 16-byte boundary
  const long long head =
      min_ll(n, (long long)(((16 - ((uintptr_t)x & 15)) & 15) >> 2));
  const long long nq = (n - head) >> 2;  // whole 16-byte pieces
  const long long tail = head + 4 * nq;  // the last n - tail values
  if (tid < head) bin<kStore>(sh, __ldg(x + tid), tid, nbins);
  if (tid < n - tail)
    bin<kStore>(sh, __ldg(x + tail + tid), tail + tid, nbins);
  const int4* q = (const int4*)(x + head);
  long long i = tid;
  for (; i + (kHistUnroll - 1) * nt < nq; i += kHistUnroll * nt) {
    int4 v[kHistUnroll];
#pragma unroll
    for (int k = 0; k < kHistUnroll; ++k) v[k] = __ldg(q + i + k * nt);
#pragma unroll
    for (int k = 0; k < kHistUnroll; ++k)
      bin4<kStore>(sh, v[k], head + 4 * (i + k * nt), nbins);
  }
  for (; i < nq; i += nt) bin4<kStore>(sh, __ldg(q + i), head + 4 * i, nbins);
  cluster.sync();  // every CTA of the cluster has binned its share
  const int r = (int)cluster.block_rank();
  const int lo = (int)((long long)nbins * r / kHistCluster);
  const int hi = (int)((long long)nbins * (r + 1) / kHistCluster);
  for (int j = lo + threadIdx.x; j < hi; j += kHistThreads) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < kHistCluster; ++k) {
      const int v = cluster.map_shared_rank(sh, k)[j];
      c = kStore ? max(c, v) : c + v;
    }
    if (c) {
      if constexpr (kStore)
        atomicMax(out + j, c);
      else
        atomicAdd(out + j, c);
    }
  }
  cluster.sync();  // no CTA leaves while another reads its bins
}

// per device and mode (add, store): the kernel's shared-memory limit
// raised, and the clusters it holds at once (0 = unread) at the shared
// bytes of the last launch
bool g_hist_smem_set[kMaxDev][2];
int g_hist_clusters[kMaxDev][2];
int g_hist_clusters_smem[kMaxDev][2];

// ---------------------------------------------------------------------------
// fk_probe_loop: a scalar loop with a trip count read from device memory.
//
// Replaces benchmarks/_pallas_feas.py:70 (P2, sum of 0..x[0,0]-1),
// _pallas_feas2.py:111 (P8, 1M iterations of acc += x[i % 8, i % 128]),
// _pallas_feas3.py:84 (P12, the same as a while loop) and
// _pallas_feas4.py:28 kernels A-C (P14-A/B/C, 1000 iterations reading
// x[0, 0], x[i & 7, i & 127] from device memory, and the same from shared
// memory). The TPU probes measured the throughput of a scalar loop; on a
// card of 132 SMs that is a card-wide rate.
//
// out[0] = the sum over steps i in [0, n), n = trips[0] (none when n <= 0),
// of: mode 0, i; mode 1, x[0]; mode 2, x[(i & (rows-1)) * cols + (i &
// (cols-1))] from device memory; mode 3, the same from the block's copy of
// x in shared memory. The arithmetic is unsigned, so the sum wraps as int32
// arithmetic does, in any order.
//
// Bound on the H100: operations. A load step is a 4-byte load and an int32
// add, and an SM issues 32 lanes of loads and 64 of int32 arithmetic a
// clock, so the loads bound the three load modes at 132 x 32 steps a clock
// and the adds bound mode 0 at 132 x 64 (2^30 load steps: 0.128 ms at
// 1980 MHz). The table (4 KiB at 8 x 128) stays in L1. So the kernel is a
// persistent grid, the CTAs the card holds at once whatever n is, each
// thread taking one contiguous run of steps:
// - runs are a multiple of the table's period max(rows, cols) (and of the
//   unroll) long and start at a multiple of it, so the 32 lanes of a warp
//   read one address a step, a broadcast that moves one sector: the warp's
//   load issues at the L1's full rate, and shared mode has no bank
//   conflicts. A thread's steps still walk the table one address after
//   the other, so no load repeats an address in one thread's loop;
// - every step's load is an asm load at an address the compiler cannot
//   prove constant: ptxas hoists a load of one known address out of a loop,
//   an asm load of x[0] included, so mode 1 reaches entry 0 through masks
//   of a kernel argument that is 0. Mode 0's sums pass through an empty
//   asm each step, so no closed form replaces them;
// - kLoopUnroll steps a thread in flight: their loads first, then their
//   adds into kLoopUnroll sums;
// - a step's address is arithmetic on the int32 pipe, which issues at
//   twice the load rate: (i & (rows-1)) * cols + (i & (cols-1)) a step
//   would cost more than the load. A pass of kLoopUnroll steps starts at a
//   multiple of kLoopUnroll, so where kLoopUnroll divides rows and cols
//   (8 x 128) its steps read entries e0 + k (cols + 1), e0 computed once a
//   pass; narrower tables compute each step's entry;
// - a CTA with no steps leaves before it copies the table; the rest reduce
//   by warp shuffles, then across warps in shared memory, and add once a
//   CTA to out (zeroed by the launcher) by an unsigned atomicAdd.
// cuobjdump -sass of each mode's instance (chip_smoke.py's loop_sass, on
// the built library for the H100) shows a load a step: ptxas unrolls two
// passes, 16 LDG.E.CONSTANT (modes 1 and 2) or 16 LDS (mode 3) an
// iteration of the loop over a wide table, and mode 0 adds once a step
// (31 IADD3s and a VIADD an iteration of 32 steps): no load is hoisted and
// no sum folded. Phase 16b fails if a loop holds fewer than kLoopUnroll.

constexpr int kLoopThreads = 256;
constexpr int kLoopUnroll = 8;  // steps a thread keeps in flight
constexpr int kLoopMaxTable = 48 * 1024;  // mode 3's table, in bytes

// step i's table entry
__device__ __forceinline__ int loop_idx(unsigned i, int rm, int cm,
                                        int cols) {
  return (int)((i & rm) * cols + (i & cm));
}

// one step's load of entry e: from x + e in device memory, or from the
// shared address tab + 4 e
template <int kMode>
__device__ __forceinline__ unsigned loop_load(const int* x, unsigned tab,
                                              int e) {
  unsigned v;
  if constexpr (kMode == 3)
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(tab + 4 * e));
  else
    asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(x + e));
  return v;
}

template <int kMode>
__global__ void __launch_bounds__(kLoopThreads)
probe_loop_kernel(const int* __restrict__ x, int rows, int cols, int zero,
                  const int* __restrict__ trips, unsigned* __restrict__ out) {
  extern __shared__ int tab[];
  __shared__ unsigned warp_sum[kLoopThreads / 32];
  const long long n = *trips;
  // a thread's run: n over the grid's threads, rounded up to a multiple of
  // q, the period and the unroll (both powers of two)
  const long long q = max(max(rows, cols), kLoopUnroll);
  const long long nt = (long long)gridDim.x * kLoopThreads;
  const long long run = n > 0 ? ((n + nt - 1) / nt + q - 1) & ~(q - 1) : 0;
  const long long cta_first = (long long)blockIdx.x * kLoopThreads * run;
  if (cta_first >= n) return;  // the whole CTA has no steps
  if constexpr (kMode == 3) {
    for (int j = threadIdx.x; j < rows * cols; j += kLoopThreads)
      tab[j] = x[j];
    __syncthreads();
  }
  const unsigned tabs = (unsigned)__cvta_generic_to_shared(tab);
  // mode 1 reads entry 0 through masks of `zero` (0, a kernel argument, so
  // unknown to the compiler): ptxas hoists a load of an address it knows
  // to be constant out of the loop, the asm load's included
  const int rm = kMode == 1 ? zero : rows - 1;
  const int cm = kMode == 1 ? zero : cols - 1;
  const long long first = cta_first + (long long)threadIdx.x * run;
  const int len = (int)max(0LL, min_ll(first + run, n) - first);
  const int passes = len / kLoopUnroll;
  unsigned i = (unsigned)min_ll(first, n);  // < 2^31, a multiple of q
  unsigned acc[kLoopUnroll] = {};
  if constexpr (kMode == 0) {
    for (int m = passes; m > 0; --m, i += kLoopUnroll) {
#pragma unroll
      for (int k = 0; k < kLoopUnroll; ++k) {
        acc[k] += i + k;
        asm volatile("" : "+r"(acc[k]));
      }
    }
  } else if (kMode == 1 || min(rows, cols) >= kLoopUnroll) {
    // a pass starts at a multiple of kLoopUnroll, which divides rows and
    // cols here: its steps i + k read entries e0 + k (cols + 1), e0 step
    // i's (mode 1: entry 0 every step)
    const int skip = kMode == 1 ? zero : cols + 1;
    for (int m = passes; m > 0; --m, i += kLoopUnroll) {
      const int e0 = loop_idx(i, rm, cm, cols);
      unsigned v[kLoopUnroll];
#pragma unroll
      for (int k = 0; k < kLoopUnroll; ++k)
        v[k] = loop_load<kMode>(x, tabs, e0 + k * skip);
#pragma unroll
      for (int k = 0; k < kLoopUnroll; ++k) acc[k] += v[k];
    }
  } else {  // a table narrower than the unroll: each step's own entry
    for (int m = passes; m > 0; --m, i += kLoopUnroll) {
      unsigned v[kLoopUnroll];
#pragma unroll
      for (int k = 0; k < kLoopUnroll; ++k)
        v[k] = loop_load<kMode>(x, tabs, loop_idx(i + k, rm, cm, cols));
#pragma unroll
      for (int k = 0; k < kLoopUnroll; ++k) acc[k] += v[k];
    }
  }
  for (int m = len % kLoopUnroll; m > 0; --m, ++i) {
    if constexpr (kMode == 0) {
      acc[0] += i;
      asm volatile("" : "+r"(acc[0]));
    } else {
      acc[0] += loop_load<kMode>(x, tabs, loop_idx(i, rm, cm, cols));
    }
  }
  unsigned s = 0;
#pragma unroll
  for (int k = 0; k < kLoopUnroll; ++k) s += acc[k];
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_down_sync(kFull, s, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = threadIdx.x < kLoopThreads / 32 ? warp_sum[threadIdx.x] : 0;
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_down_sync(kFull, s, off);
    if (threadIdx.x == 0 && s) atomicAdd(out, s);
  }
}

// the loop kernel of each mode, and the CTAs of each an SM holds (0 =
// unread) at the shared bytes of its last launch, per device
using LoopKernel = void (*)(const int*, int, int, int, const int*,
                            unsigned*);
const LoopKernel kLoopKernels[4] = {probe_loop_kernel<0>, probe_loop_kernel<1>,
                                    probe_loop_kernel<2>, probe_loop_kernel<3>};
int g_loop_per_sm[kMaxDev][4];
int g_loop_per_sm_smem[kMaxDev][4];

// mode's grid for a rows x cols table (0, or the CUDA error): the CTAs an
// SM holds at its shared bytes, times the SMs
int loop_blocks(int rows, int cols, int mode, int* blocks) {
  if (mode < 0 || mode > 3 || rows < 1 || cols < 1 ||
      (rows & (rows - 1)) || (cols & (cols - 1)) ||
      (mode == 3 && 4LL * rows * cols > kLoopMaxTable))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  int dev = 0;
  cudaGetDevice(&dev);
  const int smem = mode == 3 ? 4 * rows * cols : 0;
  if (!g_loop_per_sm[dev][mode] || g_loop_per_sm_smem[dev][mode] != smem) {
    const void* kernel = (const void*)kLoopKernels[mode];
    if (mode == 3) {  // the table, past 48 KB with the warps' sums
      err = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kLoopMaxTable);
      if (err) return err;
    }
    int b = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, kernel, kLoopThreads, smem);
    if (err) return err;
    if (b < 1) return (int)cudaErrorInvalidConfiguration;
    g_loop_per_sm[dev][mode] = b;
    g_loop_per_sm_smem[dev][mode] = smem;
  }
  *blocks = g_loop_per_sm[dev][mode] * sms;
  return 0;
}

// ---------------------------------------------------------------------------
// fk_probe_bits: clz, the ctz walk over set bits, and packing a mask.
//
// Replaces benchmarks/_pallas_feas.py:88 (P3, clz of 1 << 20),
// _pallas_feas3.py:124 (P13, the sum of the set-bit indices of 1024 words
// by ctz = 31 - clz(w & -w) and w &= w - 1), _pallas_feas4.py:28 kernel E
// (P14-E, the same walk over i | 1 for i < 100) and _pallas_feas2.py:140
// (P9, an (8,128) 0/1 mask packed 16 bits to a word by a matrix product).
//
// Modes: 0 clz, out[i] = __clz(x[i]); 1 walk, out[0] (int64, zeroed by the
// launcher) += the sum over words of the indices of their set bits; 2 pack,
// out[w] = bit b set where mask[width * w + b] != 0, LSB first, width 16 or
// 32 (bit 31 lands in the sign, as in the TPU's int32 words). The walk and
// the pack treat words as unsigned, so bit 31 is index 31 and w - 1 never
// overflows.
//
// Bound: bytes. The walk reads 4 B a word and does one step a set bit, the
// pack reads one byte a mask bit and writes one bit: at 2^21 words, 8 MiB
// (2.5 us at 3.35 TB/s); at 2^26 mask bits, 64 MiB read and 8 MiB written
// (22.5 us). So the walk takes one word a thread, sums its indices by
// __ffs (v &= v - 1, as K1's run-end walk steps through set bits),
// reduces the warp by shuffles and adds once a warp. A one-byte load a
// lane moves one 32-byte sector a warp instruction, so the pack reads 32
// mask bytes a thread as two 16-byte loads, which become the thread's
// 32-bit word (or its two 16-bit words) with SIMD byte arithmetic, stored
// whole. A misaligned mask (a data_ptr() off a 16-byte boundary) and the
// last mask bytes that do not fill 32 take the same steps from scalar
// loads.

constexpr int kBitsThreads = 256;
// A byte's bit 7 after ((b & 0x7f) + 0x7f) | b is set when b != 0 (no carry
// leaves the byte). The product by kGather = 2^0 + 2^7 + 2^14 + 2^21 moves
// bit 8j + 7 of the word to bit 28 + j and its other 12 terms to distinct
// bits outside 28..31, so no carry reaches the top nibble.
constexpr unsigned kLow7 = 0x7f7f7f7fu;
constexpr unsigned kHigh = 0x80808080u;
constexpr unsigned kGather = 0x00204081u;
constexpr int kGatherShift = 28;

// 4 mask bytes (byte j at bits 8j..8j+7) -> 4 bits, bit j = byte j != 0
__device__ __forceinline__ unsigned nib4(unsigned w) {
  return ((((w & kLow7) + kLow7) | w) & kHigh) * kGather >> kGatherShift;
}

__device__ __forceinline__ unsigned pack16(uint4 q) {
  return nib4(q.x) | nib4(q.y) << 4 | nib4(q.z) << 8 | nib4(q.w) << 12;
}

__global__ void __launch_bounds__(kBitsThreads, 2048 / kBitsThreads)
probe_bits_kernel(const void* __restrict__ in, long long n, int mode,
                  int width, void* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (mode == 0) {
    const unsigned* w = (const unsigned*)in;
    int* o = (int*)out;
    for (long long i = first; i < n; i += stride) o[i] = __clz(__ldg(w + i));
    return;
  }
  if (mode == 1) {
    const unsigned* w = (const unsigned*)in;
    unsigned long long s = 0;
    for (long long i = first; i < n; i += stride) {
      unsigned v = __ldg(w + i);
      while (v) {
        s += __ffs(v) - 1;
        v &= v - 1;
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_down_sync(kFull, s, off);
    if ((threadIdx.x & 31) == 0 && s)
      atomicAdd((unsigned long long*)out, s);
    return;
  }
  // pack: 32 mask bytes a thread and step, one 32-bit word
  const unsigned char* m = (const unsigned char*)in;
  int* o = (int*)out;
  const long long nout = n / width;
  const bool vec = ((uintptr_t)in & 15) == 0;
  const bool pair_out = ((uintptr_t)out & 7) == 0;
  for (long long g = first; 32 * g < n; g += stride) {
    const long long i = 32 * g;
    unsigned b = 0;
    if (vec && i + 32 <= n) {
      const uint4* p = (const uint4*)(m + i);
      b = pack16(__ldg(p)) | pack16(__ldg(p + 1)) << 16;
    } else {
      for (int j = 0; j < 32 && i + j < n; ++j)
        b |= (unsigned)(__ldg(m + i + j) != 0) << j;
    }
    if (width == 32) {
      o[g] = (int)b;
    } else if (2 * g + 1 < nout && pair_out) {
      *(int2*)(o + 2 * g) = make_int2((int)(b & 0xffffu), (int)(b >> 16));
    } else {
      o[2 * g] = (int)(b & 0xffffu);
      if (2 * g + 1 < nout) o[2 * g + 1] = (int)(b >> 16);
    }
  }
}

// ---------------------------------------------------------------------------
// fk_probe_carry: a running sum carried from block to block.
//
// Replaces benchmarks/_pallas_feas.py:113 (P4, the running sums of 4 block
// sums, carried in SMEM across a sequential grid) and _pallas_feas2.py:88
// (P7, only the total).
//
// x is [nblocks, blen] int32, read as one flat stream of n = nblocks x blen
// values; out[b] = the sum of its first (b + 1) x blen values, wrapped as
// int32 (the arithmetic is unsigned): the stream's running sum, read at
// each row's end.
//
// Bound: bytes, each value read once and each row's sum written once: at
// 2^14 rows of 1024, 64 MiB (20 us at 3.35 TB/s); one row of 2^26, 256 MiB
// (80 us); 2^26 rows of one value, 256 MiB read and 256 MiB written (160
// us). So the kernel is a single-pass tiled scan of the flat stream with
// decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016), its tiles of kCarryTile values
// whatever blen is, so that the shape no longer decides the parallelism:
// - the grid is the CTAs the card holds at once (an occupancy query, cached
//   a device); each CTA takes tiles in turn by an atomic ticket, so it only
//   ever waits on tiles that running CTAs hold, and the chain cannot
//   deadlock. A CTA takes a ticket only when it is about to load that
//   tile: a tile taken early holds back every later tile's look-back until
//   its CTA comes to it.
// - a tile (32 KiB) goes from device memory to shared memory as one TMA
//   bulk copy (cp.async.bulk, its completion counted on an mbarrier), so
//   the bytes in flight are bounded by shared memory (32 KiB a CTA),
//   not by registers: kept in registers (16 values a thread), the tiles in
//   flight came to 64 KiB an SM whatever their size. The stream starts at
//   the 16-byte boundary at or before x: the first tile of a view off that
//   boundary (x[1:] with an odd blen), which holds up to 3 values before
//   x, and the last tile, which the stream does not fill, take scalar
//   loads instead. A ring of two tiles a CTA, the next ticket taken and
//   its copy started as soon as the current tile's prefix was out, ran
//   slower: the CTAs of an SM already overlap one tile's load with
//   another's scan.
// - a warp owns kCarrySeg consecutive values of the tile and reads them in
//   rounds of 32 x 4 (a 16-byte piece a lane, neighbouring lanes on
//   neighbouring pieces, without bank conflicts): first to sum them, then,
//   once the tile's prefix is known, to scan them (the lane's 4 values, a
//   warp scan by shuffles, the round's total carried to the next). The
//   CTA adds the warps' sums through shared memory and publishes the
//   tile's sum at once. Warp 0 then reads the status words of the 32 tiles
//   before its own at a time, waits until each down to the nearest
//   published prefix carries a flag, adds them, and publishes the tile's
//   inclusive prefix. A status word is 64 bits, the flag in bits 32-33 (1
//   the tile's sum, 2 its inclusive prefix) and the value in bits 0-31.
// - every row end (b + 1) x blen - 1 writes out[b] = the tile's exclusive
//   prefix + the running sum there. With one value a row (out as large as
//   x) a lane's four sums go out as one 16-byte store where they line up;
//   rows of 128 values or more have at most one end a round, which the
//   warp tracks from one division a tile (on the H100 9-13 % less time than
//   a division a lane and round at rows of 128, 1000, 1024 and 2^26);
//   shorter rows take a division a lane and round.
//
// The wrapper sizes the scratch for kCarryTile (ops/probes.py CARRY_TILE).

constexpr int kCarryThreads = 256;
constexpr int kCarryWarps = kCarryThreads / 32;
constexpr int kCarryRounds = 8;  // a warp's 16-byte pieces a lane and tile
constexpr int kCarrySeg = 128 * kCarryRounds;  // values a warp and tile
constexpr long long kCarryTile = (long long)kCarryWarps * kCarrySeg;
constexpr int kCarrySmem = 4 * (int)kCarryTile;  // a tile's bytes
constexpr unsigned long long kAgg = 1ull << 32;
constexpr unsigned long long kPre = 2ull << 32;

// A status word carries its own value, so no other data is ordered by it:
// it is stored relaxed (a release store waits for the thread's earlier
// stores to land) and polled relaxed.
__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// The tile's bulk copy: one thread arms the mbarrier with the bytes to come
// and starts the copy; every thread waits for the barrier's phase.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "fence.proxy.async.shared::cta;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The sum of the tiles before tile t (t > 0), read by warp 0 from their
// status words, 32 tiles at a time (lane i reads tile pred - i) back to the
// nearest inclusive prefix. A window waits until every tile down to that
// prefix carries a flag.
__device__ __forceinline__ unsigned look_back(
    const unsigned long long* status, long long t, int lane) {
  unsigned excl = 0;
  for (long long pred = t - 1;; pred -= 32) {
    const long long j = pred - lane;
    // tiles before the first: a prefix of 0
    unsigned long long st = j >= 0 ? load_relaxed(status + j) : kPre;
    unsigned pre;
    for (;;) {
      pre = __ballot_sync(kFull, (st >> 32) == 2);
      const unsigned wait = __ballot_sync(kFull, (st >> 32) == 0);
      // lanes up to and including the nearest prefix (all 32 without one)
      const unsigned need = pre ? (2u << (__ffs(pre) - 1)) - 1u : kFull;
      if (!(wait & need)) break;
      if ((st >> 32) == 0) st = load_relaxed(status + j);
    }
    const int stop = pre ? __ffs(pre) - 1 : 31;
    unsigned v = lane <= stop ? (unsigned)st : 0u;
#pragma unroll
    for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    excl += v;
    if (pre) return excl;
  }
}

__global__ void __launch_bounds__(kCarryThreads)
probe_carry_kernel(const int* __restrict__ x, long long n, long long blen,
                   int skew, long long ntiles, unsigned long long* status,
                   unsigned long long* ticket, int* __restrict__ out) {
  extern __shared__ int4 tile_v[];  // the tile, kCarryTile values
  __shared__ __align__(8) unsigned long long landed;  // the copy's mbarrier
  __shared__ unsigned warp_sum[kCarryWarps];
  __shared__ unsigned excl_sh;
  __shared__ long long tile_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned bar = (unsigned)__cvta_generic_to_shared(&landed);
  // stream index j is x[j - skew]; xa is x's 16-byte boundary at or before
  const int4* xa = (const int4*)(x - skew);
  const long long end = n + skew;
  const bool dense = blen == 1 && skew == 0 && ((uintptr_t)out & 15) == 0;
  // a whole tile inside the stream goes by one bulk copy
  auto whole = [&](long long t) {
    return t * kCarryTile >= skew && (t + 1) * kCarryTile <= end;
  };
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (unsigned phase = 0;;) {
    __syncthreads();  // every thread is done with the last tile
    if (tid == 0) {
      const long long t = (long long)atomicAdd(ticket, 1ull);
      tile_sh = t;
      if (t < ntiles && whole(t))
        bulk_load((unsigned)__cvta_generic_to_shared(tile_v),
                  xa + t * (kCarryTile / 4), kCarrySmem, bar);
    }
    __syncthreads();
    const long long t = tile_sh;
    if (t >= ntiles) return;
    const long long j0 = t * kCarryTile;  // the tile's first stream index
    if (whole(t)) {
      bulk_wait(bar, phase);
      phase ^= 1;
    } else {
      int* v = (int*)tile_v;
      for (int i = tid; i < kCarryTile; i += kCarryThreads) {
        const long long j = j0 + i;
        v[i] = j >= skew && j < end ? __ldg(x + (j - skew)) : 0;
      }
      // before a later tile's bulk copy writes the same bytes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
    }
    const int4* seg = tile_v + warp * (kCarrySeg / 4);
    // the warp's sum
    unsigned s = 0;
#pragma unroll
    for (int k = 0; k < kCarryRounds; ++k) {
      const int4 v = seg[32 * k + lane];
      s += (unsigned)v.x + (unsigned)v.y + (unsigned)v.z + (unsigned)v.w;
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) warp_sum[warp] = s;
    __syncthreads();
    unsigned base = 0, agg = 0;
    for (int w = 0; w < kCarryWarps; ++w) {
      const unsigned v = warp_sum[w];
      base += w < warp ? v : 0u;
      agg += v;
    }
    // publish the tile's sum at once, then its inclusive prefix
    if (tid == 0) store_status(status + t, (t == 0 ? kPre : kAgg) | agg);
    if (t > 0) {
      if (warp == 0) {
        const unsigned excl = look_back(status, t, lane);
        if (lane == 0) {
          store_status(status + t, kPre | (excl + agg));
          excl_sh = excl;
        }
      }
      __syncthreads();
      base += excl_sh;
    }
    // the warp's values are the stream's [f0, f0 + kCarrySeg)
    const long long f0 = j0 - skew + (long long)warp * kCarrySeg;
    if (f0 >= n) continue;
    // rows of 128 values or more: at most one row end a round, tracked by
    // the warp (row b ends at e)
    long long b = 0, e = 0;
    if (blen >= 128) {
      b = (f0 > 0 ? f0 : 0) / blen;
      e = (b + 1) * blen - 1;
    }
#pragma unroll 2
    for (int k = 0; k < kCarryRounds; ++k) {
      const int4 v = seg[32 * k + lane];
      const unsigned s1 = (unsigned)v.x, s2 = s1 + (unsigned)v.y,
                     s3 = s2 + (unsigned)v.z, s4 = s3 + (unsigned)v.w;
      unsigned inc = s4;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned u = __shfl_up_sync(kFull, inc, off);
        if (lane >= off) inc += u;
      }
      const unsigned pre = base + inc - s4;  // before the lane's 4 values
      base += __shfl_sync(kFull, inc, 31);
      const unsigned sum[4] = {pre + s1, pre + s2, pre + s3, pre + s4};
      const long long f = f0 + 128 * k + 4 * lane;  // the lane's first
      if (blen >= 128) {
        const long long round_end = f0 + 128 * k + 128;
        if (e < round_end && e < n) {  // the round holds row b's end
          const int at = (int)(e - (f0 + 128 * k));
          if (lane == at >> 2)
            out[b] = (int)(at & 2 ? (at & 1 ? sum[3] : sum[2])
                                  : (at & 1 ? sum[1] : sum[0]));
          ++b;
          e += blen;
        }
      } else if (dense && f + 4 <= n) {
        *(int4*)(out + f) = make_int4((int)sum[0], (int)sum[1], (int)sum[2],
                                      (int)sum[3]);
      } else if (f + 4 > 0 && f < n) {
        const long long fc = f > 0 ? f : 0;
        long long r = fc / blen;
        long long at = (r + 1) * blen - 1 - f;  // its offset in sum
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q == at && f + q < n) {
            out[r++] = (int)sum[q];
            at += blen;
          }
        }
      }
    }
  }
}

bool g_carry_smem_set[kMaxDev];
int g_carry_blocks[kMaxDev];  // CTAs of probe_carry_kernel an SM holds

}  // namespace

// x: int32 [n]; out: int32 [nbins] on the device, zeroed here. store != 0
// selects store mode. nbins in [1, 58112].
extern "C" int fk_probe_hist(const void* x, long long n, int nbins, int store,
                             void* out, void* stream) {
  if (n < 0 || nbins < 1 || 4LL * nbins > kMaxSmem || ((uintptr_t)x & 3) ||
      (store && n > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 0 || dev >= kMaxDev) return (int)cudaErrorInvalidDevice;
  cudaStream_t st = (cudaStream_t)stream;
  err = (int)cudaMemsetAsync(out, 0, 4LL * nbins, st);
  if (err) return err;
  if (n == 0) return 0;
  const int m = store ? 1 : 0;
  const void* kernel = store ? (const void*)probe_hist_kernel<true>
                             : (const void*)probe_hist_kernel<false>;
  if (!g_hist_smem_set[dev][m]) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err) return err;
    g_hist_smem_set[dev][m] = true;
  }
  const int smem = 4 * nbins;
  if (!g_hist_clusters[dev][m] || g_hist_clusters_smem[dev][m] != smem) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kHistCluster);
    cfg.blockDim = dim3(kHistThreads);
    cfg.dynamicSmemBytes = smem;
    int clusters = 0;
    err = (int)cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err) return err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    g_hist_clusters[dev][m] = clusters;
    g_hist_clusters_smem[dev][m] = smem;
  }
  // a cluster takes this many values a step of its threads
  const long long per = 4LL * kHistUnroll * kHistThreads * kHistCluster;
  const int grid = (int)min_ll((n + per - 1) / per,
                               (long long)g_hist_clusters[dev][m]) *
                   kHistCluster;
  if (store)
    probe_hist_kernel<true><<<grid, kHistThreads, smem, st>>>(
        (const int*)x, n, nbins, (int*)out);
  else
    probe_hist_kernel<false><<<grid, kHistThreads, smem, st>>>(
        (const int*)x, n, nbins, (int*)out);
  return (int)cudaGetLastError();
}

// x: int32 [rows, cols] (rows, cols powers of two; at most kLoopMaxTable
// bytes in mode 3); trips: int32 [1], the trip count, read by the kernel;
// out: int32 [1], zeroed here. mode 0-3 as above.
extern "C" int fk_probe_loop(const void* x, int rows, int cols,
                             const void* trips, int mode, void* out,
                             void* stream) {
  int blocks = 0;
  int err = loop_blocks(rows, cols, mode, &blocks);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  err = (int)cudaMemsetAsync(out, 0, 4, st);
  if (err) return err;
  kLoopKernels[mode]<<<blocks, kLoopThreads, mode == 3 ? 4 * rows * cols : 0,
                       st>>>((const int*)x, rows, cols, 0, (const int*)trips,
                             (unsigned*)out);
  return (int)cudaGetLastError();
}

// *threads = the threads of fk_probe_loop's grid for these arguments, which
// split the trip count among them
extern "C" int fk_probe_loop_threads(int rows, int cols, int mode,
                                     int* threads) {
  int blocks = 0;
  const int err = loop_blocks(rows, cols, mode, &blocks);
  if (!err) *threads = blocks * kLoopThreads;
  return err;
}

// in: int32 [n] words (modes 0, 1) or uint8 [n] mask bytes (mode 2); out:
// int32 [n] (mode 0), int64 [1] zeroed here (mode 1), int32 [n / width]
// (mode 2, n a multiple of width, width 16 or 32).
extern "C" int fk_probe_bits(const void* in, long long n, int mode, int width,
                             void* out, void* stream) {
  if (n < 0 || mode < 0 || mode > 2 ||
      (mode == 2 && ((width != 16 && width != 32) || n % width)))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 1) {
    err = (int)cudaMemsetAsync(out, 0, 8, st);
    if (err) return err;
  }
  if (n == 0) return 0;
  // a thread and step take 32 mask bytes (pack) or one word
  const long long items = mode == 2 ? (n + 31) / 32 : n;
  const long long blocks =
      min_ll((items + kBitsThreads - 1) / kBitsThreads, 8LL * sms);
  probe_bits_kernel<<<(int)blocks, kBitsThreads, 0, st>>>(in, n, mode, width,
                                                          out);
  return (int)cudaGetLastError();
}

// x: int32 [nblocks, blen], 4-byte aligned; scratch: int64 [ceil((nblocks x
// blen + 3) / kCarryTile) + 1] at least, zeroed here (a status word a tile
// and the ticket); out: int32 [nblocks].
extern "C" int fk_probe_carry(const void* x, long long nblocks,
                              long long blen, void* scratch, void* out,
                              void* stream) {
  if (nblocks < 0 || blen < 0 || ((uintptr_t)x & 3) ||
      (blen && nblocks > (1LL << 62) / blen))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = nblocks * blen;
  if (nblocks == 0) return 0;
  if (n == 0) return (int)cudaMemsetAsync(out, 0, 4 * nblocks, st);
  const int skew = (int)(((uintptr_t)x & 15) >> 2);
  const long long ntiles = (n + skew + kCarryTile - 1) / kCarryTile;
  int err = (int)cudaMemsetAsync(scratch, 0, 8 * (ntiles + 1), st);
  if (err) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err) return err;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!g_carry_smem_set[dev]) {
    err = (int)cudaFuncSetAttribute(
        probe_carry_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kCarrySmem);
    if (err) return err;
    g_carry_smem_set[dev] = true;
  }
  if (!g_carry_blocks[dev]) {
    int blocks = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, probe_carry_kernel, kCarryThreads, kCarrySmem);
    if (err) return err;
    if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
    g_carry_blocks[dev] = blocks;
  }
  unsigned long long* status = (unsigned long long*)scratch;
  const long long grid = min_ll(ntiles, (long long)g_carry_blocks[dev] * sms);
  probe_carry_kernel<<<(int)grid, kCarryThreads, kCarrySmem, st>>>(
      (const int*)x, n, blen, skew, ntiles, status, status + ntiles,
      (int*)out);
  return (int)cudaGetLastError();
}
