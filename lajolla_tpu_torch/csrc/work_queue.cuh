// Persistent warps that take work items from a device counter, shared by
// the fused kernels K1 (path_kernels.cu), K8 (volpath_kernels.cu) and K9
// (volpath_grid_kernels.cu): the launch that fills the card, the fetch of
// one warp, and the optional SIMT counters.
//
// A kernel built on these launches `persistent_blocks` blocks, each lane
// of each warp running one flattened loop: a lane whose path ends writes
// its item's radiance and asks for the next item at the top of the next
// iteration, so no lane waits for the longest path of its warp until the
// queue is empty. Items are handed out in id order from a 64-bit counter
// that the caller zeroes before every launch.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace lj {

constexpr unsigned kFullMask = 0xffffffffu;

// The blocks of a persistent launch of `smem` bytes of dynamic shared
// memory a block: as many as fit on the card at once (occupancy x SM
// count), and no more than `items` threads need.
template <class Kernel>
cudaError_t persistent_blocks(Kernel kernel, int threads, size_t smem,
                              long long items, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1 || items < 1) return cudaErrorInvalidConfiguration;
  const long long need = (items + threads - 1) / threads;
  const long long fill = (long long)per_sm * sms;
  blocks = (int)(need < fill ? need : fill);
  return cudaSuccess;
}

// One fetch for the lanes of a warp that `want` an item: the lowest asking
// lane adds the number of asking lanes to the counter (one atomicAdd for
// the warp), the old value is shuffled to every lane, and asking lane k
// gets `mine` = that base + its rank among the asking lanes. Every lane of
// the warp must call it, at a point the whole warp reaches. Returns the
// counter's value after this warp's add (the same in every lane), or -1
// where no lane asked (no add, `mine` untouched).
__device__ __forceinline__ long long fetch_items(
    unsigned long long* counter, bool want, long long& mine) {
  __syncwarp();
  const unsigned ask = __ballot_sync(kFullMask, want);
  if (ask == 0u) return -1;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(ask) - 1;
  unsigned long long base = 0;
  if (lane == leader)
    base = atomicAdd(counter, (unsigned long long)__popc(ask));
  base = __shfl_sync(kFullMask, base, leader);
  mine = (long long)base + __popc(ask & ((1u << lane) - 1u));
  return (long long)base + __popc(ask);
}

// Per-warp SIMT counters in shared memory, S slots per warp, added to the
// caller's device array at the end of the launch: pairs of slots counting
// the passes of a warp through a stage and the lanes that worked in them,
// and slots of SM cycles a warp spent in a stage. Everything is skipped
// where the array is null (the render path).
template <int W, int S>
struct SimtCounts {
  unsigned long long c[W][S];

  __device__ __forceinline__ void zero(const unsigned long long* out) {
    const int lane = threadIdx.x & 31;
    if (out && lane < S) c[threadIdx.x >> 5][lane] = 0ull;
    __syncwarp();
  }
  // Counts one pass of the warp through stage `slot` / 2 with the lanes
  // of `lanes` working, if any. Every lane of the warp must call it.
  __device__ __forceinline__ void pass(const unsigned long long* out,
                                      int slot, bool working) {
    if (!out) return;
    const unsigned lanes = __ballot_sync(kFullMask, working);
    if ((threadIdx.x & 31) == 0 && lanes) {
      c[threadIdx.x >> 5][slot] += 1ull;
      c[threadIdx.x >> 5][slot + 1] += (unsigned long long)__popc(lanes);
    }
  }
  // The SM clock once the whole warp is here (0 where out is null).
  __device__ __forceinline__ long long stamp(const unsigned long long* out) {
    if (!out) return 0;
    __syncwarp();
    return clock64();
  }
  // Adds the cycles since `t0` (a stamp) to slot `slot`, once the whole
  // warp is here. Every lane of the warp must call it.
  __device__ __forceinline__ void cycles(const unsigned long long* out,
                                        int slot, long long t0) {
    if (!out) return;
    __syncwarp();
    if ((threadIdx.x & 31) == 0)
      c[threadIdx.x >> 5][slot] += (unsigned long long)(clock64() - t0);
  }
  __device__ __forceinline__ void flush(unsigned long long* out) {
    if (!out) return;
    __syncwarp();
    const int lane = threadIdx.x & 31;
    if (lane < S) atomicAdd(out + lane, c[threadIdx.x >> 5][lane]);
  }
};

}  // namespace lj
