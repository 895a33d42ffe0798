// Kernels K4-K7: the cluster-sweep ray casters of scenes with a BVH (192
// triangles or more), with a plain C interface for ctypes
// (lajolla_tpu_torch/kernels.py builds this file with nvcc for sm_90a and
// binds it).
//
// They replace the four Pallas kernels of lajolla_tpu/ops/intersect_sweep.py:
//   K4 sweep_resolve_kernel    <- `_kernel_resolve` (via `_resolve_hits`)
//   K5 sweep_resident_kernel   <- `_kernel_res`     (via `_call_res`)
//   K6 sweep_list_kernel       <- `_kernel_lane`    (via `_call_list`)
//   K7 sweep_streaming_kernel  <- `_kernel`         (via `_call_streaming`)
// Their plain PyTorch forms are lajolla_tpu_torch/ops/intersect_sweep.py
// `sweep_resolve_plain`, `sweep_resident_plain`, `sweep_list_plain` and
// `sweep_streaming_plain`, which state the rule all of them follow.
//
// The TPU kernels test a whole (rays x triangles) tile per listed cluster,
// because the TPU's vector unit has no per-lane gather or branch.
//
// K4 gives one warp one ray and goes straight to the ray's winning
// cluster (no sort by cluster, no per-block list of distinct clusters):
// lane l tests triangles l, l + 32, l + 64, l + 96 of it, and a shuffle
// reduction on (err, index) picks the serial rule's triangle. In a render
// K4 sees a lane pool of 8192 rays; one thread a ray made that 64 blocks
// of 128 threads, each thread a dependent chain of 128 Woop tests with a
// division each, latency-bound on half the SMs (the first design); one warp
// a ray makes it 1024 blocks of 8 warps, 4 tests a lane, and the lanes
// read neighbouring floats of each row.
//
// K5, K6 and K7 give one warp one ray, and every block is independent. A CUDA
// block of kSweepWarps warps takes kSweepWarps consecutive rays and reads
// the list of the ray block (LIST_B or LANE_R rays) they belong to. The
// warp walks that list front to back in chunks of 32 entries: each lane
// runs the ray's slab test against one entry for the horizon at the start
// of the chunk, and a ballot gives the entries to enter. The horizon only
// falls and the list's distances only rise, so an entry that fails there
// fails later too, and the first entry beyond the horizon ends the ray
// there or sooner; each entry the ballot keeps is tested again, with the
// stop rule and the slab test, for the horizon of the moment before it is
// entered. A cluster it enters is tested by the whole warp
// (warp_cluster_test): lane l takes triangles l, l+32, l+64, ..., reading
// the (16, C) lane block row by row, 32 neighbouring floats a load; a
// shuffle reduction picks the least t and the lowest index among equal t
// (closest hit), or a ballot per round of 32 the lowest index that hits
// (any hit), which is the serial rule's choice.
//
// What bounded the one-thread-per-ray design that came before: in a render
// the lane pool is 8192 (K5) or 16384 (K6) rays, so a launch had 32 blocks
// for 132 SMs, one block an SM and nothing to hide latency with; each
// thread ran a dependent chain of ~45 operations and a division per
// triangle over a cluster's 128 triangles, entered by the whole warp when
// any of its 32 rays passed the slab test; and K6's block of 512 rays
// staged each listed cluster in shared memory behind two barriers, so
// every entry cost the slowest ray's chain. Here a launch of 8192 rays is
// 1024 blocks of 256 threads, a warp's control flow is its one ray's, and
// nothing waits on another ray. What bounds it now: the slab tests and the
// Woop tests themselves (fp32 operations and a division per triangle,
// spread over 32 lanes) and the latency of the rows' loads from the L2.
// K5's table (at most 8 MiB) and K6's (23.5 MB for the 260k-triangle mesh)
// both stay in the 50 MB L2, which is why nothing is staged in shared
// memory: a listed cluster is read by the few warps whose rays enter it,
// not by a whole block.
//
// K7 has no lists: the warp walks the S superclusters in id order, 32 at a
// time. Lane l slab-tests supercluster s0 + l for the horizon at the
// chunk's start and a ballot gives the candidates; the horizon only falls,
// so a box that fails there fails later too, and each candidate is tested
// again, in id order, for the horizon of the moment. The G (<= 32) member
// clusters of an entered supercluster are slab-tested by lanes 0..G-1 the
// same way, each member again when it is entered, and an entered cluster
// is tested by the whole warp over the lane table (warp_cluster_test,
// which skips the triangles past C: K7's cluster size need not be a
// multiple of 128). One thread a ray, the design it replaces, gave a
// render's cast of 8192 rays 64 blocks of 128 threads for 132 SMs, each
// thread a serial chain over 64-triangle clusters read from the
// triangle-major rows (12 floats, 48 bytes apart), entered by the whole
// warp when any of its 32 rays passed a gate.
//
// Numerics: every product that feeds a sum is written with __fmul_rn /
// __fadd_rn, which nvcc never contracts into an FMA, in the order the
// plain forms add them; division is IEEE (no fast math). K5 and K4 share
// one device function, so the t that K4 recomputes equals K5's bit for bit;
// the resolve keeps lajolla_tpu's tolerance all the same.
//
// Every entry returns cudaGetLastError() after its launch; the kernels
// launch on the caller's stream and do not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kSweepWarps = 8;     // K4-K7: rays (warps) per block
constexpr int kLaneRows = 16;      // rows of one cluster in the lane table
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

struct Ray {
  float ox, oy, oz, tn, dx, dy, dz, tf;
  float ix, iy, iz;   // 1 / d, with |d| <= 1e-20 replaced by 1e-20
};

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f);
}

// rays: (Np, 8) [o, tnear, d, tfar], 16-byte aligned
__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        long long i) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(rays) + 2 * i);
  const float4 b = __ldg(reinterpret_cast<const float4*>(rays) + 2 * i + 1);
  Ray r;
  r.ox = a.x; r.oy = a.y; r.oz = a.z; r.tn = a.w;
  r.dx = b.x; r.dy = b.y; r.dz = b.z; r.tf = b.w;
  r.ix = inv_dir(r.dx); r.iy = inv_dir(r.dy); r.iz = inv_dir(r.dz);
  return r;
}

// min(best, tfar) that stays NaN for a NaN tfar, as torch.minimum does:
// such a ray then fails every comparison and hits nothing.
__device__ __forceinline__ float limit(float best, float tf) {
  return tf != tf ? tf : fminf(best, tf);
}

// The ray's slab test against an AABB row [lo3 hi3 . .] (32-byte aligned,
// read as two float4) for [tnear, lim].
__device__ __forceinline__ bool slab(const float* __restrict__ ab,
                                     const Ray& r, float lim) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(ab));      // lo, hi.x
  const float4 b = __ldg(reinterpret_cast<const float4*>(ab) + 1);  // hi.y, hi.z
  float tmin = r.tn, tmax = lim;
  float ta = (a.x - r.ox) * r.ix, tb = (a.w - r.ox) * r.ix;
  tmin = fmaxf(tmin, fminf(ta, tb));
  tmax = fminf(tmax, fmaxf(ta, tb));
  ta = (a.y - r.oy) * r.iy;
  tb = (b.x - r.oy) * r.iy;
  tmin = fmaxf(tmin, fminf(ta, tb));
  tmax = fminf(tmax, fmaxf(ta, tb));
  ta = (a.z - r.oz) * r.iz;
  tb = (b.y - r.oz) * r.iz;
  tmin = fmaxf(tmin, fminf(ta, tb));
  tmax = fminf(tmax, fmaxf(ta, tb));
  return tmin <= tmax;
}

// Where the 12 Woop components and the prim id of triangle c of a cluster
// are in the lane table (rows of C floats).
struct LaneRows {
  const float* base;   // the cluster's (16, C) block
  int C;
  __device__ __forceinline__ float operator()(int j, int c) const {
    return __ldg(base + j * C + c);
  }
  __device__ __forceinline__ float prim(int c) const {
    return __ldg(base + 12 * C + c);
  }
};

// a0*x + a1*y + a2*z, products added left to right, no FMA
template <class Rows>
__device__ __forceinline__ float contract(const Rows& w, int j, int c,
                                          float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, w(j, c)), __fmul_rn(y, w(j + 1, c))),
                   __fmul_rn(z, w(j + 2, c)));
}

// The Woop test of the ray against triangle c, in two steps. First the z
// row: t = -(A_z o + b_z) / (A_z d); true iff |dz| > 1e-12 and t > tnear.
template <class Rows>
__device__ __forceinline__ bool woop_t(const Rows& w, int c, const Ray& r,
                                       float& t) {
  const float oz = __fadd_rn(contract(w, 8, c, r.ox, r.oy, r.oz), w(11, c));
  const float dz = contract(w, 8, c, r.dx, r.dy, r.dz);
  const bool dz_ok = fabsf(dz) > 1e-12f;
  t = -oz / (dz_ok ? dz : 1.0f);
  return dz_ok && t > r.tn;
}

// Then, for a t that passed, u and v from the x and y rows; true iff
// u >= 0, v >= 0 and u + v <= 1.
template <class Rows>
__device__ __forceinline__ bool woop_uv(const Rows& w, int c, const Ray& r,
                                        float t, float& u, float& v) {
  const float ox = __fadd_rn(contract(w, 0, c, r.ox, r.oy, r.oz), w(3, c));
  const float dx = contract(w, 0, c, r.dx, r.dy, r.dz);
  u = __fadd_rn(ox, __fmul_rn(t, dx));
  const float oy = __fadd_rn(contract(w, 4, c, r.ox, r.oy, r.oz), w(7, c));
  const float dy = contract(w, 4, c, r.dx, r.dy, r.dz);
  v = __fadd_rn(oy, __fmul_rn(t, dy));
  return u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f;
}

constexpr int kTriUnroll = 4;  // z rows in flight in a lane's triangle loop
// K7's: two z rows a lane (a 64-triangle cluster in one round), and at
// least 3 blocks an SM (80 registers); measured faster than 4 z rows and
// than no bound or 4 blocks (PERF.md)
constexpr int kStreamUnroll = 2;
constexpr int kStreamMinBlocks = 3;

// The nearest hit of the warp's ray below `lim` among the C triangles of
// the cluster at `base` (a (16, C) lane block), by the serial rule: in
// index order, a later triangle winning only with a strictly smaller t
// (any hit: the first hit). Lane l tests triangles l + 32k, kUnroll z
// rows in flight before any is looked at. K5 and K6 take C a multiple of
// 32 kUnroll; kTail (K7) lets C be any size, a lane testing nothing past
// it. Returns the winner's index in every lane, or -1; t, u and v are the
// winner's in every lane. Call with the whole warp converged.
template <bool kAny, int kUnroll = kTriUnroll, bool kTail = false>
__device__ __forceinline__ int warp_cluster_test(
    const float* __restrict__ base, int C, const Ray& r, float lim, int lane,
    float& bt, float& bu, float& bv) {
  const LaneRows w{base, C};
  float ct = lim, cu = 0.0f, cv = 0.0f;
  int cj = -1;
  for (int c0 = 0; c0 < C; c0 += 32 * kUnroll) {
    float t[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int c = c0 + 32 * k + lane;
      ok[k] = kTail ? c < C && woop_t(w, min(c, C - 1), r, t[k])
                    : woop_t(w, c, r, t[k]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int c = c0 + 32 * k + lane;
      float u, v;
      const bool hit = ok[k] && t[k] < ct && woop_uv(w, c, r, t[k], u, v);
      if (kAny) {
        // the lowest index that hits: the first round with a hit, its
        // lowest lane
        const unsigned m = __ballot_sync(kFull, hit);
        if (m) {
          const int src = __ffs(m) - 1;
          bt = __shfl_sync(kFull, t[k], src);
          bu = bv = 0.0f;
          return c0 + 32 * k + src;
        }
      } else if (hit) {
        ct = t[k];
        cj = c;
        cu = u;
        cv = v;
      }
    }
  }
  if (kAny) return -1;
  // the least (t, index) over the lanes; compares only, so t keeps its bits
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(kFull, ct, off);
    const int oj = __shfl_xor_sync(kFull, cj, off);
    if (oj >= 0 && (cj < 0 || ot < ct || (ot == ct && oj < cj))) {
      ct = ot;
      cj = oj;
    }
  }
  if (cj >= 0) {
    bt = ct;
    bu = __shfl_sync(kFull, cu, cj & 31);
    bv = __shfl_sync(kFull, cv, cj & 31);
  }
  return cj;
}

// The walk of one ray (one warp) over its block's front-to-back list of
// n_it entries: cluster ids, or (members = G) supercluster ids whose G
// member clusters are tested in order. The rule of the plain forms: stop
// at the first entry whose distance exceeds min(best, tfar) (NaN stops),
// at each cluster the ray's own slab test for [tnear, min(best, tfar)],
// and for any hit stop at the first hit. Chunks of 32 (virtual) entries
// are prefiltered with one slab test a lane for the horizon at the
// chunk's start (see the header); G must divide 32, so a chunk holds
// whole supercluster entries. Results (best, the winning cluster and
// triangle, u, v) are the same in every lane.
template <bool kAny>
__device__ __forceinline__ void warp_list_walk(
    const Ray& r, const float* __restrict__ lane_tab,
    const float* __restrict__ aabb, const int* __restrict__ cl,
    const float* __restrict__ tl, int n_it, int members, int C, int lane,
    float& best, int& kwin, int& jwin, float& bu, float& bv) {
  const int n_v = n_it * members;
  bool stop = false;
  int prev = -1;                      // the last entry checked for a stop
  for (int m0 = 0; m0 < n_v && !stop; m0 += 32) {
    const float lim0 = limit(best, r.tf);
    const int m = m0 + lane;
    const bool in = m < n_v;
    const int e = m / members;
    const float te = in ? __ldg(tl + e) : 0.0f;
    const int kid = in ? (members > 1 ? __ldg(cl + e) * members + m % members
                                      : __ldg(cl + e))
                       : 0;
    const unsigned stops = __ballot_sync(kFull, in && !(te <= lim0));
    const int end = stops ? __ffs(stops) - 1 : 32;
    unsigned pass = __ballot_sync(
        kFull, in && lane < end && slab(aabb + 8 * (long long)kid, r, lim0));
    stop = stops != 0;
    while (pass) {                    // warp-uniform: the ballot's bits
      const int src = __ffs(pass) - 1;
      pass &= pass - 1;
      const int ek = __shfl_sync(kFull, e, src);
      const float tk = __shfl_sync(kFull, te, src);
      const int kk = __shfl_sync(kFull, kid, src);
      const float lim = limit(best, r.tf);
      if (ek != prev) {
        prev = ek;
        if (!(tk <= lim)) {
          stop = true;
          break;
        }
      }
      if (!slab(aabb + 8 * (long long)kk, r, lim)) continue;
      float t, u, v;
      const int j = warp_cluster_test<kAny>(
          lane_tab + (long long)kk * kLaneRows * C, C, r, lim, lane, t, u, v);
      if (j >= 0) {
        best = t;
        kwin = kk;
        jwin = j;
        bu = u;
        bv = v;
        if (kAny) {
          stop = true;
          break;
        }
      }
    }
  }
}

// K5. One warp per ray, kSweepWarps rays a block; rays (R * B, 8) in R
// list blocks of B rays; lists of L entries: cluster ids (counts >= 0) or
// supercluster ids (counts < 0, G members each), with the block's
// earliest entry distance beside each.
template <bool kAny>
__global__ void __launch_bounds__(kSweepWarps * 32)
sweep_resident_kernel(const float* __restrict__ rays,
                      const float* __restrict__ lane_tab,
                      const float* __restrict__ aabb,
                      const int* __restrict__ counts,
                      const int* __restrict__ clist,
                      const float* __restrict__ tlist, int B, int L, int C,
                      int G, float* __restrict__ t_out,
                      int* __restrict__ kid_out) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kSweepWarps + threadIdx.x / 32;
  const long long blk = i / B;
  const Ray r = load_ray(rays, i);
  const int cnt = __ldg(counts + blk);
  float best = inf_f(), bu = 0.0f, bv = 0.0f;
  int kwin = -1, jwin = -1;
  warp_list_walk<kAny>(r, lane_tab, aabb, clist + blk * L, tlist + blk * L,
                       cnt < 0 ? -cnt : cnt, cnt < 0 ? G : 1, C, lane, best,
                       kwin, jwin, bu, bv);
  if (lane == 0) {
    t_out[i] = best;
    kid_out[i] = kAny ? -1 : kwin;
  }
}

// K4. One warp per ray, kSweepWarps rays a block: the triangle of the
// ray's winning cluster whose t is nearest t_best (the ray's tfar slot),
// the lowest index on ties, accepted within 1e-4 * max(|t_best|, 1e-6).
// Lane l tests triangles l, l + 32, ... in index order, a later one
// winning only with a strictly smaller err; a shuffle reduction then picks
// the least (err, index) over the lanes (compares only), and u, v come
// from the winner's lane. A ray with no cluster (kid < 0) leaves at once.
__global__ void __launch_bounds__(kSweepWarps * 32)
sweep_resolve_kernel(const float* __restrict__ rays,
                     const int* __restrict__ kid_in,
                     const float* __restrict__ lane_tab, int n, int C,
                     int* __restrict__ p_out, float* __restrict__ u_out,
                     float* __restrict__ v_out) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kSweepWarps + threadIdx.x / 32;
  if (i >= n) return;                       // warp-uniform
  const int kid = __ldg(kid_in + i);
  int prim = -1;
  float bu = 0.0f, bv = 0.0f;
  if (kid >= 0) {                           // warp-uniform
    const Ray r = load_ray(rays, i);
    const float tbest = r.tf;
    const LaneRows w{lane_tab + (long long)kid * kLaneRows * C, C};
    float emin = inf_f(), eu = 0.0f, ev = 0.0f;
    int j = -1;
    for (int c = lane; c < C; c += 32) {
      float t, u, v;
      if (woop_t(w, c, r, t) && woop_uv(w, c, r, t, u, v)) {
        const float err = fabsf(t - tbest);
        if (err < emin) {
          emin = err;
          j = c;
          eu = u;
          ev = v;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float oe = __shfl_xor_sync(kFull, emin, off);
      const int oj = __shfl_xor_sync(kFull, j, off);
      if (oj >= 0 && (j < 0 || oe < emin || (oe == emin && oj < j))) {
        emin = oe;
        j = oj;
      }
    }
    if (j >= 0) {                           // the same j in every lane
      eu = __shfl_sync(kFull, eu, j & 31);
      ev = __shfl_sync(kFull, ev, j & 31);
      const float tol = __fmul_rn(1e-4f, fmaxf(fabsf(tbest), 1e-6f));
      if (emin <= tol) {
        prim = (int)w.prim(j);
        bu = eu;
        bv = ev;
      }
    }
  }
  if (lane == 0) {
    p_out[i] = prim;
    u_out[i] = bu;
    v_out[i] = bv;
  }
}

// K6. The sweep of K5 over full-width lists (no supercluster entries),
// (t, prim, u, v) in one pass: one warp per ray, nothing staged.
template <bool kAny>
__global__ void __launch_bounds__(kSweepWarps * 32)
sweep_list_kernel(const float* __restrict__ rays,
                  const float* __restrict__ lane_tab,
                  const float* __restrict__ aabb,
                  const int* __restrict__ counts,
                  const int* __restrict__ clist,
                  const float* __restrict__ tlist, int B, int L, int C,
                  float* __restrict__ t_out, int* __restrict__ p_out,
                  float* __restrict__ u_out, float* __restrict__ v_out) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kSweepWarps + threadIdx.x / 32;
  const long long blk = i / B;
  const Ray r = load_ray(rays, i);
  float best = inf_f(), bu = 0.0f, bv = 0.0f;
  int kwin = -1, jwin = -1;
  warp_list_walk<kAny>(r, lane_tab, aabb, clist + blk * L, tlist + blk * L,
                       __ldg(counts + blk), 1, C, lane, best, kwin, jwin, bu,
                       bv);
  if (lane == 0) {
    int prim = -1;
    if (jwin >= 0)
      prim = kAny ? 0
                  : (int)LaneRows{lane_tab + (long long)kwin * kLaneRows * C,
                                  C}.prim(jwin);
    t_out[i] = best;
    p_out[i] = prim;
    u_out[i] = kAny || jwin < 0 ? 0.0f : bu;
    v_out[i] = kAny || jwin < 0 ? 0.0f : bv;
  }
}

// K7. No lists: one warp per ray, kSweepWarps rays a block; the warp walks
// the S superclusters in id order, gated by its slab test against the
// supercluster and then against each of its G member clusters, both for
// the running [tnear, min(best, tfar)] (see the header). The rule of
// sweep_streaming_plain: for any hit, stop at the first hit, the lowest
// index of the first cluster that holds one.
template <bool kAny>
__global__ void __launch_bounds__(kSweepWarps * 32, kStreamMinBlocks)
sweep_streaming_kernel(const float* __restrict__ rays,
                       const float* __restrict__ saabb,
                       const float* __restrict__ aabb,
                       const float* __restrict__ lane_tab, int n, int S,
                       int G, int C, float* __restrict__ t_out,
                       int* __restrict__ p_out, float* __restrict__ u_out,
                       float* __restrict__ v_out) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kSweepWarps + threadIdx.x / 32;
  if (i >= n) return;                       // warp-uniform
  const Ray r = load_ray(rays, i);
  float best = inf_f(), bu = 0.0f, bv = 0.0f;
  long long kwin = -1;
  int jwin = -1;
  bool stop = false;
  for (int s0 = 0; s0 < S && !stop; s0 += 32) {
    const int sl = s0 + lane;
    unsigned cand = __ballot_sync(
        kFull, sl < S && slab(saabb + 8 * (long long)sl, r,
                              limit(best, r.tf)));
    while (cand && !stop) {                 // warp-uniform: ballot bits
      const int s = s0 + __ffs(cand) - 1;
      cand &= cand - 1;
      if (!slab(saabb + 8 * (long long)s, r, limit(best, r.tf))) continue;
      const long long k0 = (long long)s * G;
      unsigned mem = __ballot_sync(
          kFull, lane < G && slab(aabb + 8 * (k0 + lane), r,
                                  limit(best, r.tf)));
      while (mem) {
        const long long kid = k0 + __ffs(mem) - 1;
        mem &= mem - 1;
        const float lim = limit(best, r.tf);
        if (!slab(aabb + 8 * kid, r, lim)) continue;
        float t, u, v;
        const int j = warp_cluster_test<kAny, kStreamUnroll, true>(
            lane_tab + kid * kLaneRows * C, C, r, lim, lane, t, u, v);
        if (j >= 0) {
          best = t;
          kwin = kid;
          jwin = j;
          bu = u;
          bv = v;
          if (kAny) {
            stop = true;
            break;
          }
        }
      }
    }
  }
  if (lane == 0) {
    int prim = -1;
    if (jwin >= 0)
      prim = kAny ? 0
                  : (int)LaneRows{lane_tab + kwin * kLaneRows * C, C}.prim(
                        jwin);
    t_out[i] = best;
    p_out[i] = prim;
    u_out[i] = kAny || jwin < 0 ? 0.0f : bu;
    v_out[i] = kAny || jwin < 0 ? 0.0f : bv;
  }
}

// The launch shape of K5 and K6: one warp per ray, kSweepWarps rays a
// block; B a multiple of kSweepWarps, so a block's rays share one list.
bool sweep_shape_ok(int R, int B, int L, int C) {
  return R > 0 && B > 0 && B % kSweepWarps == 0 && L > 0 && C > 0 &&
         C % 128 == 0;
}

}  // namespace

extern "C" {

// rays (R * B, 8); lists (R, L); C a multiple of 128; G divides 32.
int lj_sweep_resident(const float* rays, const float* lane, const float* aabb,
                      const int* counts, const int* clist, const float* tlist,
                      int R, int B, int L, int C, int G, int any_hit, float* t,
                      int* kid, void* stream) {
  if (!sweep_shape_ok(R, B, L, C) || G <= 0 || 32 % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (int)((long long)R * B / kSweepWarps);
  if (any_hit)
    sweep_resident_kernel<true><<<grid, kSweepWarps * 32, 0, s>>>(
        rays, lane, aabb, counts, clist, tlist, B, L, C, G, t, kid);
  else
    sweep_resident_kernel<false><<<grid, kSweepWarps * 32, 0, s>>>(
        rays, lane, aabb, counts, clist, tlist, B, L, C, G, t, kid);
  return (int)cudaGetLastError();
}

int lj_sweep_resolve(const float* rays, const int* kid, const float* lane,
                     int n, int C, int* p, float* u, float* v, void* stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (int)(((long long)n + kSweepWarps - 1) / kSweepWarps);
  sweep_resolve_kernel<<<grid, kSweepWarps * 32, 0, (cudaStream_t)stream>>>(
      rays, kid, lane, n, C, p, u, v);
  return (int)cudaGetLastError();
}

int lj_sweep_list(const float* rays, const float* lane, const float* aabb,
                  const int* counts, const int* clist, const float* tlist,
                  int R, int B, int L, int C, int any_hit, float* t, int* p,
                  float* u, float* v, void* stream) {
  if (!sweep_shape_ok(R, B, L, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (int)((long long)R * B / kSweepWarps);
  if (any_hit)
    sweep_list_kernel<true><<<grid, kSweepWarps * 32, 0, s>>>(
        rays, lane, aabb, counts, clist, tlist, B, L, C, t, p, u, v);
  else
    sweep_list_kernel<false><<<grid, kSweepWarps * 32, 0, s>>>(
        rays, lane, aabb, counts, clist, tlist, B, L, C, t, p, u, v);
  return (int)cudaGetLastError();
}

// rays (n, 8); lane (K, 16, C) with K = S * G; G at most 32.
int lj_sweep_streaming(const float* rays, const float* saabb,
                       const float* aabb, const float* lane, int n, int S,
                       int G, int C, int any_hit, float* t, int* p, float* u,
                       float* v, void* stream) {
  if (n <= 0 || S <= 0 || G <= 0 || G > 32 || C <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (int)(((long long)n + kSweepWarps - 1) / kSweepWarps);
  if (any_hit)
    sweep_streaming_kernel<true><<<grid, kSweepWarps * 32, 0, s>>>(
        rays, saabb, aabb, lane, n, S, G, C, t, p, u, v);
  else
    sweep_streaming_kernel<false><<<grid, kSweepWarps * 32, 0, s>>>(
        rays, saabb, aabb, lane, n, S, G, C, t, p, u, v);
  return (int)cudaGetLastError();
}

}  // extern "C"
