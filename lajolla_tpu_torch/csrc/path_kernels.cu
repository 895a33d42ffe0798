// CUDA kernels of the path integrator's main path, with a plain C
// interface for ctypes (lajolla_tpu_torch/kernels.py builds this file
// with nvcc for sm_90a and binds it).
//
// K1 render_fused_kernel replaces lajolla_tpu's Pallas megakernel
//    (lajolla_tpu/integrators/path_megakernel.py `_kernel`, launched by
//    `render_fused`): the whole persistent wavefront for nspp samples of
//    every pixel in one launch.
// K2 advance_kernel replaces the per-bounce Pallas kernel
//    (lajolla_tpu/integrators/path_kernel.py `_kernel`, launched by
//    `advance_kernel_t`): one path vertex for a batch of lanes.
//
// K2 runs lj::advance_vertex (path_advance.cuh) for the active lanes
// only, each on a group of G threads that split its two cast scans
// (lj::CastGroup); a lane with act false is passed through. The first
// design, one thread a lane over all n lanes, ran a whole vertex for
// inactive lanes too, and at the per-bounce driver's small films
// (cbox-96: 9,216 lanes, 72 blocks of 128 threads for 132 SMs) nothing hid
// the latency of each thread's one long chain: 14.1-14.8 us a launch
// against a bound of 0.43 (PERF.md). G is chosen so that a launch fills
// about one wave (advance_group): G = 8 at cbox-96 shortens the scans'
// part of the chain eightfold, G = 1 at 2^18 lanes and above, where many
// waves hide it. A warp takes one chunk of lanes at every n: a persistent
// grid whose warps packed the active lanes of their chunks by ballot
// measured 1.03x slower over a 1920x1080 render, 1.15x at its full pool
// and 1.1x at its tail (PERF.md). K2 moves (3+3+3+3+1+1+3+8+1) floats in
// and 14 out per lane per vertex on top of a vertex's work.
//
// K1 is persistent warps (work_queue.cuh), the design of K8: as
// many blocks as fit on the card, each lane running one flat loop that
// advances one path vertex an iteration. A lane whose path ends writes its
// work item's radiance to a per-item buffer and, at the top of the next
// iteration, takes the next item from a device counter (one atomicAdd a
// warp for all its lanes that ask); items go out in id order s0*n ..
// (s0+nspp)*n - 1, item = pixel + k*n, so the lanes of a warp start on 32
// neighbouring pixels of a row. film_sum_kernel (volpath_kernels.cu) then
// adds each pixel's samples in sample order under the whole-sample
// non-finite rule, as the TPU kernel's per-lane film does, so the film
// does not depend on which thread ran a path or when.
//
// Why not lane == pixel, as the TPU kernel has it: cbox runs Russian
// roulette from the fifth vertex with survival up to 0.95, so paths have
// a long geometric tail, and a pixel's paths have a length of their own
// (a pixel that sees the light or the open front ends early). Nested
// sample and vertex loops a thread (the first design) made a warp wait for
// its longest path of every sample (lockstep proxy 0.481 at 64x64 x 256
// spp, PERF.md); one flat loop a pixel still waits for the pixel with the
// most vertices over all samples (0.815; SIMT 0.904 at 512x512 x 256 spp,
// 48.5 ms); persistent warps keep 99.8% of the lanes busy and took 37.9 ms
// with the film sum (tools/profile_torch_path.py, PERF.md). The per-item
// buffer costs 12 bytes an item written once and read once (805 MB at
// 512x512 x 256 spp, < 0.5 ms at the card's rate).
//
// What bounds it now: per-thread ALU work (the cast scans over the cast
// and occluder tables, two BSDF evaluations a vertex), the latency of the
// per-lane record reads and of the lane state the launch bound spills,
// which many warps an SM hide (kFusedMinBlocks), and divergence inside a
// vertex (material branches, the any-hit scan's early exit). The rows the
// scans walk in a loop whose index every lane shares (cast prims,
// occluders, the light pick's and the staircase's CDFs) each block copies
// once into its shared memory (lj::stage_rows: 1,872 B for the Cornell
// box, under ~26 KB for any scene K1 takes) and reads as broadcast 16-byte
// loads, four a prim in place of 13 scalar loads through L1. Against those
// loads on the H100: the main path's launch 37.73 -> 34.23 ms (0.907x),
// the mesh box's 179 cast prims 0.80x (PERF.md). Optional SIMT counters
// (SimtCounts, null on the render path) count the loop iterations of a
// warp that hold a path and the lanes that advanced a vertex in them.
//
// Every entry returns cudaGetLastError() after its launch; the kernels
// launch on the caller's stream and do not synchronise.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "camera.cuh"
#include "path_advance.cuh"
#include "work_queue.cuh"

namespace {

using lj::Camera;
using lj::primary;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// K1's second launch bound: at least 8 blocks an SM, at most 64 registers
// a thread, ~158 B of the lane's state spilled to local memory (L1); 32
// warps an SM beat 16 at the compiler's own 128 registers by 1.24x and 20
// at 80 by 1.05x (tools/profile_torch_path.py --variants, PERF.md).
constexpr int kFusedMinBlocks = 8;
// K1's SIMT counter slots: loop iterations of a warp with a path in some
// lane, and those lanes (one vertex each).
constexpr int kFusedStats = 2;

__device__ __forceinline__ void vertex_uniforms(uint32_t su, long long item,
                                                int nv, float un[8]) {
  uint32_t hb = lj::pcg_hash((uint32_t)item ^ lj::pcg_hash((uint32_t)nv ^ su));
#pragma unroll
  for (int k = 0; k < 8; ++k)
    un[k] = lj::u01(lj::pcg_hash(hb + (uint32_t)(k + 1) * lj::kGold));
}

// K1: persistent warps over the work items s0*n .. (s0+nspp)*n - 1 (item
// = pixel + k*n), taken in id order from `counter` (one zeroed uint64);
// each lane runs one flat loop, one path vertex an iteration, and writes
// an item's radiance to out[item - s0*n] when its path ends. out: (nspp *
// n, 3); stats: kFusedStats counters to add to, or null. The block first
// copies the scans' rows into its dynamic shared memory (lj::stage_rows),
// and the scans read them there.
template <int MATS, bool QUADS, bool SPH>
__global__ void __launch_bounds__(kThreads, kFusedMinBlocks)
render_fused_kernel(lj::Tables tb, Camera cam, int n, int w, uint32_t su,
                    long long s0, long long total,
                    unsigned long long* __restrict__ counter,
                    float* __restrict__ out,
                    unsigned long long* __restrict__ stats) {
  using namespace lj;
  __shared__ SimtCounts<kWarps, kFusedStats> cnt;
  stage_rows(tb);
  cnt.zero(stats);
  long long c = 0;          // the lane's item, as its row of out
  bool busy = false;        // the lane holds a path
  bool drained = false;     // the counter has passed the last item (warp)
  int nv = 2;
  Lane st;
  for (;;) {
    if (!drained) {
      long long mine = 0;
      const long long next = fetch_items(counter, !busy, mine);
      if (!busy && next >= 0 && mine < total) {
        c = mine;
        const int pixel = (int)(c % n);
        primary(cam, su, s0 * n + c, (float)(pixel % w), (float)(pixel / w),
                st.o, st.d);
        st.prev = st.o;
        st.thr = v3(1.0f, 1.0f, 1.0f);
        st.rad = v3(0.0f, 0.0f, 0.0f);
        st.dir_pdf = 0.0f;
        nv = 2;
        busy = true;
      }
      drained = next >= total;
    }
    if (__ballot_sync(kFullMask, busy) == 0u) {
      if (drained) break;
      continue;
    }
    cnt.pass(stats, 0, busy);
    if (busy) {
      float un[8];
      vertex_uniforms(su, s0 * n + c, nv, un);
      if (advance_vertex<MATS, QUADS, SPH, 1, true>(tb, st, (float)nv,
                                                   un)) {
        st.prev = st.o;
        ++nv;
      } else {
        float* o = out + 3 * c;
        o[0] = st.rad.x;
        o[1] = st.rad.y;
        o[2] = st.rad.z;
        busy = false;
      }
    }
  }
  cnt.flush(stats);
}

// K2's blocks an SM, for the group size's rule: 7, what 72 registers a
// thread allow (ptxas gives the Cornell box's forms 64 at every G, the
// others up to 72). K2 has no bound of its own: one of 7
// blocks an SM took G = 1 to 72 registers and 2^18 lanes 1.1x slower
// (tools/tune_torch_k2.py, PERF.md).
constexpr int kAdvanceBlocksPerSM = 7;

// K2: one vertex for each active lane of n; vectors are (3, n) rows, un
// (8, n). Warp w takes the chunk of 32 / G lanes from w * 32 / G, one lane
// to each group of G threads. Every thread of a group computes the whole
// vertex on the same values (no broadcast), the scans split over the
// group (lj::CastGroup), and the group's first thread writes the lane; a
// lane with act false is written as it was read, alive false.
template <int MATS, bool QUADS, bool SPH, int G>
__global__ void __launch_bounds__(kThreads)
advance_kernel(lj::Tables tb, int n, const float* __restrict__ org,
               const float* __restrict__ dir, const float* __restrict__ thr,
               const float* __restrict__ rad, const float* __restrict__ nv,
               const float* __restrict__ dir_pdf,
               const float* __restrict__ prev, const float* __restrict__ un,
               const bool* __restrict__ act, float* __restrict__ org_o,
               float* __restrict__ dir_o, float* __restrict__ thr_o,
               float* __restrict__ rad_o, float* __restrict__ dp_o,
               bool* __restrict__ alive_o) {
  using namespace lj;
  const int wl = threadIdx.x & 31, g = wl / G, rank = wl % G;
  const long long w = blockIdx.x * (long long)kWarps + (threadIdx.x >> 5);
  const long long n1 = n, n2 = 2 * n1, i = w * (32 / G) + g;
  if (i >= n1) return;
  auto row3 = [&](const float* a) { return v3(a[i], a[n1 + i], a[n2 + i]); };
  auto put3 = [&](float* a, V3 v) {
    a[i] = v.x;
    a[n1 + i] = v.y;
    a[n2 + i] = v.z;
  };
  Lane st;
  st.o = row3(org);
  st.d = row3(dir);
  st.thr = row3(thr);
  st.rad = row3(rad);
  st.prev = row3(prev);
  st.dir_pdf = dir_pdf[i];
  const float nv_i = nv[i];
  float u[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) u[k] = un[k * n1 + i];
  bool alive = false;
  if (act[i]) {
    const CastGroup<G> grp{(0xffffffffu >> (32 - G)) << (g * G), rank};
    alive = advance_vertex<MATS, QUADS, SPH, G>(tb, st, nv_i, u, grp);
  }
  if (rank == 0) {
    put3(org_o, st.o);
    put3(dir_o, st.d);
    put3(thr_o, st.thr);
    put3(rad_o, st.rad);
    dp_o[i] = st.dir_pdf;
    alive_o[i] = alive;
  }
}

// Calls f(M, Q, S) with the kernel specialisation as integral constants.
template <class F>
cudaError_t dispatch(int mats, int quads, int sph, F f) {
  auto by_sph = [&](auto M, auto Q) {
    return sph ? f(M, Q, std::true_type{}) : f(M, Q, std::false_type{});
  };
  auto by_quads = [&](auto M) {
    return quads ? by_sph(M, std::true_type{}) : by_sph(M, std::false_type{});
  };
  switch (mats) {
    case lj::kLambertian:
      return by_quads(std::integral_constant<int, lj::kLambertian>{});
    case lj::kRoughPlastic:
      return by_quads(std::integral_constant<int, lj::kRoughPlastic>{});
    case lj::kLambertian | lj::kRoughPlastic:
      return by_quads(
          std::integral_constant<int, lj::kLambertian | lj::kRoughPlastic>{});
  }
  return cudaErrorInvalidValue;
}

// Calls f(G) with K2's group size as an integral constant.
template <class F>
cudaError_t by_group(int group, F f) {
  switch (group) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
  }
  return cudaErrorInvalidValue;
}

// K2's group size: the largest G of 8, 4 and 2 whose n * G threads fit one
// wave (kAdvanceBlocksPerSM blocks of kThreads threads on each of the
// card's SMs), else 1. On the H100's 132 SMs: G = 8 up to 14,784 lanes
// (cbox-96's 9,216), G = 1 from 59,137 (2^18 lanes, a 1920x1080 film).
// The SM count of each device is read once.
cudaError_t advance_group(long long n, int& g) {
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int sms = dev < kMaxDevices ? sms_of[dev] : 0;
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) sms_of[dev] = sms;
  }
  for (g = 8; g > 1; g >>= 1)
    if (n * g <= (long long)sms * kAdvanceBlocksPerSM * kThreads) break;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// K1. mats: bit 0 Lambertian, bit 1 RoughPlastic; counter: one zeroed
// uint64; out: (nspp * n, 3), summed per pixel by film_sum_kernel
// (volpath_kernels.cu); stats: kFusedStats uint64 counters to add to, or
// null.
int lj_render_fused(const lj::Tables* tb, const lj::Camera* cam, int mats,
                    int quads, int sph, int n, int w, uint32_t su,
                    long long s0, int nspp, unsigned long long* counter,
                    float* out, unsigned long long* stats, void* stream) {
  if (n <= 0 || nspp <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nspp * n;
  const size_t smem = lj::stage_bytes(*tb);
  cudaError_t e = dispatch(mats, quads, sph, [&](auto M, auto Q, auto S) {
    auto kernel = render_fused_kernel<decltype(M)::value, decltype(Q)::value,
                                      decltype(S)::value>;
    int blocks = 0;
    cudaError_t err =
        lj::persistent_blocks(kernel, kThreads, smem, total, blocks);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        *tb, *cam, n, w, su, s0, total, counter, out, stats);
    return cudaGetLastError();
  });
  return (int)e;
}

// K2's group size for n lanes on the current card (advance_group), or a
// negative CUDA error.
int lj_advance_group(int n) {
  int g = 0;
  cudaError_t e = advance_group(n, g);
  return e == cudaSuccess ? g : -(int)e;
}

// K2. group: G (1, 2, 4 or 8), or 0 for advance_group's.
int lj_advance(const lj::Tables* tb, int mats, int quads, int sph, int n,
               int group, const float* org, const float* dir,
               const float* thr, const float* rad, const float* nv,
               const float* dir_pdf, const float* prev, const float* un,
               const bool* act, float* org_o, float* dir_o, float* thr_o,
               float* rad_o, float* dp_o, bool* alive_o, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = group ? cudaSuccess : advance_group(n, group);
  if (e != cudaSuccess) return (int)e;
  e = dispatch(mats, quads, sph, [&](auto M, auto Q, auto S) {
    return by_group(group, [&](auto G) {
      constexpr int kG = decltype(G)::value;
      const long long chunks = ((long long)n + 32 / kG - 1) / (32 / kG);
      const int blocks = (int)((chunks + kWarps - 1) / kWarps);
      advance_kernel<decltype(M)::value, decltype(Q)::value,
                     decltype(S)::value, kG>
          <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
              *tb, n, org, dir, thr, rad, nv, dir_pdf, prev, un, act, org_o,
              dir_o, thr_o, rad_o, dp_o, alive_o);
      return cudaGetLastError();
    });
  });
  return (int)e;
}

}  // extern "C"
