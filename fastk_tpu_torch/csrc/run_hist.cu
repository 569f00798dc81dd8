// Run-length histogram of a sorted key stream, for Hopper (sm_90a).
//
// Replaces the Pallas kernel fastk_tpu/ops/histker.py:_walk_kernel (launched
// by _run_walk). Input: the run starts of a sorted key batch as a bitmask,
// LSB-first (bit b of word w = start at position 32w + b), bits at and after
// valid_end clear. Every run begins at a start and ends at the next start, or
// at valid_end for the last run; position 0 always starts a run. Output:
// hist[len] += 1 for every run, with len clipped at 32767 (hist[0] stays 0).
//
// The TPU kernel walked the words in order on the scalar core, carrying the
// previous start from one grid step to the next, and binned lengths below
// 2047 in SMEM with a side list for longer ones. Here blocks run in parallel
// and carry nothing, so each set bit finds its own run's end: the next set
// bit in its word, or failing that the first set bit in the following words,
// scanning no further than valid_end or 32767 positions (a run that long
// bins at 32767 whatever its true length). The scan is therefore bounded at
// about 1025 words even for a run of millions, as a uniform tail makes.
//
// What bounds it on the H100: reading size/8 bytes of start words (8 MiB at
// 2^26 positions, a few microseconds of HBM bandwidth), and the shared-memory
// atomics on the hot low bins: in 50X HiFi data most runs have length 1-3
// (error k-mers) or about 50 (genomic k-mers). The design answer: the whole
// 32768-bin int32 histogram (128 KiB) sits in one block's dynamic shared
// memory, so every bin update is a shared atomic and never a global one;
// length-1 runs, the hottest bin, are counted in a register and added once
// per thread; and there is one block per SM (two 128 KiB histograms do not
// fit in an SM's 228 KB), so the closing flush adds at most 132 histograms
// into the global one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNBins = 32768;
constexpr long long kHigh = kNBins - 1;
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
run_hist_kernel(const uint32_t* __restrict__ words, long long valid_end,
                int* __restrict__ hist) {
  extern __shared__ int sh[];
  for (int i = threadIdx.x; i < kNBins; i += blockDim.x) sh[i] = 0;
  __syncthreads();

  const long long nw = (valid_end + 31) >> 5;  // words holding any position
  const int tail = (int)(valid_end & 31);
  int ones = 0;  // length-1 runs of this thread
  for (long long w = blockIdx.x * (long long)blockDim.x + threadIdx.x; w < nw;
       w += (long long)gridDim.x * blockDim.x) {
    uint32_t bits = words[w];
    if (w == 0) bits |= 1u;
    if (w == nw - 1 && tail) bits &= (1u << tail) - 1u;
    while (bits) {
      const long long p = (w << 5) + (__ffs((int)bits) - 1);
      bits &= bits - 1u;
      long long next;
      if (bits) {
        next = (w << 5) + (__ffs((int)bits) - 1);
      } else {
        const long long limit = min(valid_end, p + kHigh);
        next = limit;
        for (long long q = w + 1; (q << 5) < limit; ++q) {
          const uint32_t x = words[q];
          if (x) {
            next = min(limit, (q << 5) + (__ffs((int)x) - 1));
            break;
          }
        }
      }
      const int len = (int)min(next - p, kHigh);
      if (len == 1) {
        ++ones;
      } else {
        atomicAdd(&sh[len], 1);
      }
    }
  }
  if (ones) atomicAdd(&sh[1], ones);
  __syncthreads();
  for (int i = threadIdx.x; i < kNBins; i += blockDim.x) {
    const int v = sh[i];
    if (v) atomicAdd(&hist[i], v);
  }
}

}  // namespace

// words: int32 [nwords] on the device; hist: int32 [32768], zeroed by the
// caller. Launches on `stream` without synchronising. Returns the CUDA error
// of the launch (0 on success).
extern "C" int fk_run_hist(const void* words, long long nwords,
                           long long valid_end, void* hist, int num_sms,
                           void* stream) {
  if (valid_end < 0 || valid_end > nwords * 32 || num_sms < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = kNBins * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      run_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long nw = (valid_end + 31) >> 5;
  long long blocks = (nw + kThreads - 1) / kThreads;
  if (blocks > num_sms) blocks = num_sms;
  if (blocks < 1) blocks = 1;
  run_hist_kernel<<<(int)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, valid_end, (int*)hist);
  return (int)cudaGetLastError();
}

extern "C" const char* fk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
