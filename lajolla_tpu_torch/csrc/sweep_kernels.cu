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
// because the TPU's vector unit has no per-lane gather or branch. Here one
// thread owns one ray. It walks its block's front-to-back cluster list (K5,
// K6) or the superclusters in id order (K7), runs its own slab test against
// [tnear, min(best, tfar)] at each cluster, loops over the triangles of a
// cluster it enters, and stops at the first list entry farther than its own
// min(best, tfar). A block ends when its last ray has stopped, which is the
// TPU kernels' block-wide break. K4 goes straight to its ray's winning
// cluster: no sort by cluster, no per-block list of distinct clusters.
//
// What bounds them: per-ray ALU work (about 45 operations and one division
// per triangle tested, 25 per slab test) in a serial loop over a cluster's
// triangles, whose every step waits for its loads and its division (the
// loop keeps four triangles' z rows in flight), over tables that are read
// by every ray that enters a cluster. K5's table (at most 8 MiB) stays in the
// 50 MB L2 and is read through the read-only path, all threads of a warp
// that test the same cluster reading the same words; K6 stages each listed
// cluster (13 rows of C floats) in shared memory once per block; K7 reads
// the row-major (K*C, 12) table through the read-only path. Rays of a
// warp that enter different clusters diverge: sorting the rays (the caller
// does) is what keeps a warp together.
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

constexpr int kRayThreads = 128;   // K4 and K7: threads per block
constexpr int kMaxResident = 256;  // K5: most rays (threads) per block
constexpr int kMaxList = 512;      // K6: most rays (threads) per block
constexpr int kLaneRows = 16;      // rows of one cluster in the lane table
constexpr int kStagedRows = 13;    // of which K6 stages 12 Woop rows + prim

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
// are: the lane table (rows of C floats, in global or shared memory) ...
struct LaneRows {
  const float* base;   // the cluster's (16, C) block
  int C;
  __device__ __forceinline__ float operator()(int j, int c) const {
    return base[j * C + c];
  }
  __device__ __forceinline__ float prim(int c) const {
    return base[12 * C + c];
  }
};

// ... or the row-major (C, 12) block of sw_A with sw_prim beside it.
struct TriRows {
  const float* base;   // the cluster's (C, 12) block
  const float* prims;  // the cluster's (C,) prim ids
  __device__ __forceinline__ float operator()(int j, int c) const {
    return __ldg(base + 12 * c + j);
  }
  __device__ __forceinline__ float prim(int c) const {
    return __ldg(prims + c);
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

constexpr int kTriUnroll = 4;  // z rows in flight in the triangle loop

// The nearest hit of the ray below `lim` among a cluster's C triangles, in
// index order, a later triangle winning only with a strictly smaller t
// (any-hit: the first hit). Returns its index, or -1. The z rows of
// kTriUnroll triangles are computed before any is looked at, so that their
// loads and divisions overlap; the triangles are still taken in index
// order against the running best.
template <bool kAny, class Rows>
__device__ __forceinline__ int cluster_test(const Rows& w, int C,
                                            const Ray& r, float lim,
                                            float& bt, float& bu, float& bv) {
  int j = -1;
  float cur = lim;
  for (int c0 = 0; c0 < C; c0 += kTriUnroll) {
    float t[kTriUnroll];
    bool ok[kTriUnroll];
#pragma unroll
    for (int k = 0; k < kTriUnroll; ++k) {
      const int c = c0 + k;
      ok[k] = woop_t(w, min(c, C - 1), r, t[k]) && c < C;
    }
#pragma unroll
    for (int k = 0; k < kTriUnroll; ++k) {
      float u, v;
      if (ok[k] && t[k] < cur && woop_uv(w, c0 + k, r, t[k], u, v)) {
        cur = t[k];
        j = c0 + k;
        bt = t[k];
        bu = u;
        bv = v;
        if (kAny) return j;
      }
    }
  }
  return j;
}

// K5. One block per ray block, one thread per ray; lists of L entries:
// cluster ids (counts >= 0) or supercluster ids (counts < 0, G members
// each), with the block's earliest entry distance beside each.
template <bool kAny>
__global__ void __launch_bounds__(kMaxResident)
sweep_resident_kernel(const float* __restrict__ rays,
                      const float* __restrict__ lane,
                      const float* __restrict__ aabb,
                      const int* __restrict__ counts,
                      const int* __restrict__ clist,
                      const float* __restrict__ tlist, int L, int C, int G,
                      float* __restrict__ t_out, int* __restrict__ kid_out) {
  const int blk = blockIdx.x;
  const long long i = (long long)blk * blockDim.x + threadIdx.x;
  const Ray r = load_ray(rays, i);
  const int cnt = counts[blk];
  const bool over = cnt < 0;
  const int n_it = over ? -cnt : cnt;
  const int members = over ? G : 1;
  const int* cl = clist + (long long)blk * L;
  const float* tl = tlist + (long long)blk * L;
  float best = inf_f();
  int kwin = -1;
  bool found = false;
  for (int it = 0; it < n_it && !found; ++it) {
    if (!(__ldg(tl + it) <= limit(best, r.tf))) break;
    const int e = __ldg(cl + it);
    for (int g = 0; g < members && !found; ++g) {
      const int kid = over ? e * G + g : e;
      const float lim = limit(best, r.tf);
      if (!slab(aabb + 8 * kid, r, lim)) continue;
      const LaneRows w{lane + (long long)kid * kLaneRows * C, C};
      float t, u, v;
      if (cluster_test<kAny>(w, C, r, lim, t, u, v) >= 0) {
        best = t;
        kwin = kid;
        found = kAny;
      }
    }
  }
  t_out[i] = best;
  kid_out[i] = kAny ? -1 : kwin;
}

// K4. One thread per ray: the triangle of the ray's winning cluster whose t
// is nearest t_best (the ray's tfar slot), the lowest index on ties,
// accepted within 1e-4 * max(|t_best|, 1e-6).
__global__ void __launch_bounds__(kRayThreads)
sweep_resolve_kernel(const float* __restrict__ rays,
                     const int* __restrict__ kid_in,
                     const float* __restrict__ lane, int n, int C,
                     int* __restrict__ p_out, float* __restrict__ u_out,
                     float* __restrict__ v_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int kid = kid_in[i];
  int prim = -1;
  float bu = 0.0f, bv = 0.0f;
  if (kid >= 0) {
    const Ray r = load_ray(rays, i);
    const float tbest = r.tf;
    const LaneRows w{lane + (long long)kid * kLaneRows * C, C};
    float emin = inf_f(), eu = 0.0f, ev = 0.0f;
    int j = -1;
    for (int c = 0; c < C; ++c) {
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
    const float tol = __fmul_rn(1e-4f, fmaxf(fabsf(tbest), 1e-6f));
    if (j >= 0 && emin <= tol) {
      prim = (int)__ldg(w.base + 12 * C + j);
      bu = eu;
      bv = ev;
    }
  }
  p_out[i] = prim;
  u_out[i] = bu;
  v_out[i] = bv;
}

// K6. The sweep of K5 over full-width lists (no supercluster entries), each
// listed cluster staged in shared memory by the block; (t, prim, u, v) in
// one pass. The loop is block-uniform: it ends when no ray of the block is
// still sweeping.
template <bool kAny>
__global__ void __launch_bounds__(kMaxList)
sweep_list_kernel(const float* __restrict__ rays,
                  const float* __restrict__ lane,
                  const float* __restrict__ aabb,
                  const int* __restrict__ counts,
                  const int* __restrict__ clist,
                  const float* __restrict__ tlist, int L, int C,
                  float* __restrict__ t_out, int* __restrict__ p_out,
                  float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ float4 staged4[];
  float* staged = reinterpret_cast<float*>(staged4);
  const int blk = blockIdx.x;
  const long long i = (long long)blk * blockDim.x + threadIdx.x;
  const Ray r = load_ray(rays, i);
  const int n_it = counts[blk];
  const int* cl = clist + (long long)blk * L;
  const float* tl = tlist + (long long)blk * L;
  float best = inf_f(), bu = 0.0f, bv = 0.0f;
  int prim = -1;
  bool active = true;
  for (int it = 0;; ++it) {
    if (active) {
      active = it < n_it && !(kAny && prim >= 0) &&
               __ldg(tl + it) <= limit(best, r.tf);
    }
    // also the barrier between the last iteration's reads and this load
    if (!__syncthreads_or(active)) break;
    const int kid = __ldg(cl + it);
    const float4* src = reinterpret_cast<const float4*>(
        lane + (long long)kid * kLaneRows * C);
    for (int k = threadIdx.x; k < kStagedRows * C / 4; k += blockDim.x)
      staged4[k] = __ldg(src + k);
    __syncthreads();
    if (active) {
      const float lim = limit(best, r.tf);
      if (slab(aabb + 8 * kid, r, lim)) {
        const LaneRows w{staged, C};
        float t, u, v;
        const int j = cluster_test<kAny>(w, C, r, lim, t, u, v);
        if (j >= 0) {
          best = t;
          prim = kAny ? 0 : (int)w.prim(j);
          bu = kAny ? 0.0f : u;
          bv = kAny ? 0.0f : v;
        }
      }
    }
  }
  t_out[i] = best;
  p_out[i] = prim;
  u_out[i] = bu;
  v_out[i] = bv;
}

// K7. No lists: every ray walks the S superclusters in id order, gated by
// its slab test against the supercluster and then against each of the G
// member clusters, both for the running [tnear, min(best, tfar)].
template <bool kAny>
__global__ void __launch_bounds__(kRayThreads)
sweep_streaming_kernel(const float* __restrict__ rays,
                       const float* __restrict__ saabb,
                       const float* __restrict__ aabb,
                       const float* __restrict__ A,
                       const float* __restrict__ prims, int n, int S, int G,
                       int C, float* __restrict__ t_out,
                       int* __restrict__ p_out, float* __restrict__ u_out,
                       float* __restrict__ v_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(rays, i);
  float best = inf_f(), bu = 0.0f, bv = 0.0f;
  int prim = -1;
  for (int s = 0; s < S && !(kAny && prim >= 0); ++s) {
    if (!slab(saabb + 8 * s, r, limit(best, r.tf))) continue;
    for (int g = 0; g < G && !(kAny && prim >= 0); ++g) {
      const long long kid = (long long)s * G + g;
      const float lim = limit(best, r.tf);
      if (!slab(aabb + 8 * kid, r, lim)) continue;
      const TriRows w{A + kid * C * 12, prims + kid * C};
      float t, u, v;
      const int j = cluster_test<kAny>(w, C, r, lim, t, u, v);
      if (j >= 0) {
        best = t;
        prim = kAny ? 0 : (int)w.prim(j);
        bu = kAny ? 0.0f : u;
        bv = kAny ? 0.0f : v;
      }
    }
  }
  t_out[i] = best;
  p_out[i] = prim;
  u_out[i] = bu;
  v_out[i] = bv;
}

int blocks_for(long long n) { return (int)((n + kRayThreads - 1) / kRayThreads); }

}  // namespace

extern "C" {

// rays (R * B, 8); lists (R, L); one block of B threads per ray block.
int lj_sweep_resident(const float* rays, const float* lane, const float* aabb,
                      const int* counts, const int* clist, const float* tlist,
                      int R, int B, int L, int C, int G, int any_hit, float* t,
                      int* kid, void* stream) {
  if (R <= 0 || B <= 0 || B > kMaxResident || L <= 0 || C <= 0 || G <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    sweep_resident_kernel<true><<<R, B, 0, s>>>(rays, lane, aabb, counts,
                                                 clist, tlist, L, C, G, t, kid);
  else
    sweep_resident_kernel<false><<<R, B, 0, s>>>(rays, lane, aabb, counts,
                                                  clist, tlist, L, C, G, t,
                                                  kid);
  return (int)cudaGetLastError();
}

int lj_sweep_resolve(const float* rays, const int* kid, const float* lane,
                     int n, int C, int* p, float* u, float* v, void* stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  sweep_resolve_kernel<<<blocks_for(n), kRayThreads, 0,
                         (cudaStream_t)stream>>>(rays, kid, lane, n, C, p, u,
                                                 v);
  return (int)cudaGetLastError();
}

int lj_sweep_list(const float* rays, const float* lane, const float* aabb,
                  const int* counts, const int* clist, const float* tlist,
                  int R, int B, int L, int C, int any_hit, float* t, int* p,
                  float* u, float* v, void* stream) {
  if (R <= 0 || B <= 0 || B > kMaxList || L <= 0 || C <= 0 || C % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)kStagedRows * C * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (any_hit) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(sweep_list_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
    sweep_list_kernel<true><<<R, B, smem, s>>>(rays, lane, aabb, counts, clist,
                                               tlist, L, C, t, p, u, v);
  } else {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(sweep_list_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
    sweep_list_kernel<false><<<R, B, smem, s>>>(rays, lane, aabb, counts,
                                                clist, tlist, L, C, t, p, u,
                                                v);
  }
  return (int)cudaGetLastError();
}

int lj_sweep_streaming(const float* rays, const float* saabb,
                       const float* aabb, const float* A, const float* prims,
                       int n, int S, int G, int C, int any_hit, float* t,
                       int* p, float* u, float* v, void* stream) {
  if (n <= 0 || S <= 0 || G <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    sweep_streaming_kernel<true><<<blocks_for(n), kRayThreads, 0, s>>>(
        rays, saabb, aabb, A, prims, n, S, G, C, t, p, u, v);
  else
    sweep_streaming_kernel<false><<<blocks_for(n), kRayThreads, 0, s>>>(
        rays, saabb, aabb, A, prims, n, S, G, C, t, p, u, v);
  return (int)cudaGetLastError();
}

}  // extern "C"
