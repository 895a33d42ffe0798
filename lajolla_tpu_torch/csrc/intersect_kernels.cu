// Kernel K3: brute-force ray casts over a small triangle set, with a
// plain C interface for ctypes (lajolla_tpu_torch/kernels.py builds this
// file with nvcc for sm_90a and binds it).
//
// Replaces lajolla_tpu's Pallas kernel lajolla_tpu/ops/intersect_pallas.py
// `_kernel` (launched by `_call` for `intersect_brute_pallas` and
// `occluded_brute_pallas`): the casts of the general engine for scenes
// below BVH_MIN_TRIS (192) triangles. Its plain PyTorch forms are
// lajolla_tpu_torch/ops/intersect.py `_brute_force_batched` and
// `_occluded_batched`.
//
// The TPU kernel computes a (T, 4096) block of (prim, ray) Woop tests in
// lockstep in VMEM and reduces with argmin over the prim axis. Here one
// thread owns one ray: a block first stages the Woop rows (Tc, 12) and
// the quad flags in shared memory (under 10 KB at Tc < 192), then each
// thread loops over the prims in index order and keeps a hit only if its
// t is strictly smaller, which is argmin's first-index rule (it decides
// hits on the shared edge of two coplanar triangles). The any-hit
// variant stops at its first hit.
//
// What bounds it: instruction issue. A Woop test is ~45 fp32 operations
// (no FMA: see Numerics), an IEEE division (a subroutine of ~10
// instructions), the compares and the best's update: ~100 instructions a
// prim and ray. At glass-512's 2^18 rays and 16 prims that is ~13M warp
// instructions, ~14 us at the card's issue rate, where the counted bound
// (the rays' 48 bytes, or 45 operations a test) is 3.8 us. Measured and
// not kept (PERF.md): skipping the division for a prim that cannot give
// t > tnear (exact for tnear >= 0: |dz| <= 1e-12, oz = 0, or -oz and dz
// of opposite signs) or u and v for a t out of range (a warp skips work
// only where all 32 rays do, and the branches cost more); persistent
// blocks (every block of a 2^18 cast fits on the card at once anyway);
// 2 or 4 rays a thread, over this table or over float4 rows (at best
// 0.94x, for a second copy of the test).
//
// Numerics: every product that feeds a sum is written with __fmul_rn /
// __fadd_rn, which nvcc never contracts into an FMA, in the order the
// plain form adds them; division is IEEE (no fast math). So the kernel
// rounds as the plain form does on the card.
//
// Every entry returns cudaGetLastError() after its launch; the kernels
// launch on the caller's stream and do not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPrims = 192;  // lajolla_tpu's BVH_MIN_TRIS

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// a0*x + a1*y + a2*z (+ bias), products added left to right, no FMA
__device__ __forceinline__ float contract(const float* a, float x, float y,
                                          float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], x), __fmul_rn(a[1], y)),
                   __fmul_rn(a[2], z));
}

// The Woop test of one ray against cast prim k: t, u, v and the hit bit.
__device__ __forceinline__ bool woop_test(const float* w, float quad,
                                          float3 o, float3 d, float tn,
                                          float tf, float& t, float& u,
                                          float& v) {
  const float oz = __fadd_rn(contract(w + 8, o.x, o.y, o.z), w[11]);
  const float dz = contract(w + 8, d.x, d.y, d.z);
  const bool dz_ok = fabsf(dz) > 1e-12f;
  t = -oz / (dz_ok ? dz : 1.0f);
  const float ox = __fadd_rn(contract(w, o.x, o.y, o.z), w[3]);
  const float dx = contract(w, d.x, d.y, d.z);
  u = __fadd_rn(ox, __fmul_rn(t, dx));
  const float oy = __fadd_rn(contract(w + 4, o.x, o.y, o.z), w[7]);
  const float dy = contract(w + 4, d.x, d.y, d.z);
  v = __fadd_rn(oy, __fmul_rn(t, dy));
  const float lim = quad > 0.0f ? 1.0f - fmaxf(u, v) : (1.0f - u) - v;
  return dz_ok && u >= 0.0f && v >= 0.0f && lim >= 0.0f && t > tn && t < tf;
}

__device__ __forceinline__ void stage(const float* __restrict__ woop,
                                      const float* __restrict__ quad, int tc,
                                      float* sw, float* sq) {
  for (int k = threadIdx.x; k < tc * 12; k += blockDim.x) sw[k] = woop[k];
  for (int k = threadIdx.x; k < tc; k += blockDim.x) sq[k] = quad[k];
  __syncthreads();
}

__device__ __forceinline__ float3 load3(const float* __restrict__ a,
                                        long long i) {
  return make_float3(a[3 * i], a[3 * i + 1], a[3 * i + 2]);
}

// Closest hit: t, true triangle id (quad back halves remapped to the
// partner triangle, as intersect_brute_pallas does), u, v; on a miss
// t = inf, prim = -1 and u = v = 0.
__global__ void __launch_bounds__(kThreads)
intersect_brute_kernel(const float* __restrict__ woop,
                       const float* __restrict__ quad,
                       const int* __restrict__ cast_src,
                       const int* __restrict__ cast_alt, int tc, int n,
                       const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ tnear,
                       const float* __restrict__ tfar,
                       float* __restrict__ t_out, int* __restrict__ prim_out,
                       float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float sw[kMaxPrims * 12];
  __shared__ float sq[kMaxPrims];
  stage(woop, quad, tc, sw, sq);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float3 ro = load3(o, i), rd = load3(d, i);
  const float tn = tnear[i], tf = tfar[i];
  float best = inf_f(), bu = 0.0f, bv = 0.0f;
  int bk = -1;
  for (int k = 0; k < tc; ++k) {
    float t, u, v;
    if (woop_test(sw + 12 * k, sq[k], ro, rd, tn, tf, t, u, v) && t < best) {
      best = t;
      bk = k;
      bu = u;
      bv = v;
    }
  }
  int prim = -1;
  float ur = 0.0f, vr = 0.0f;
  if (bk >= 0) {
    const float s = __fadd_rn(bu, bv);
    const bool back = sq[bk] > 0.0f && s > 1.0f;
    prim = back ? cast_alt[bk] : cast_src[bk];
    ur = back ? 1.0f - bv : bu;
    vr = back ? s - 1.0f : bv;
  }
  t_out[i] = best;
  prim_out[i] = prim;
  u_out[i] = ur;
  v_out[i] = vr;
}

// Any hit over the occluder subset.
__global__ void __launch_bounds__(kThreads)
occluded_brute_kernel(const float* __restrict__ woop,
                      const float* __restrict__ quad, int tc, int n,
                      const float* __restrict__ o,
                      const float* __restrict__ d,
                      const float* __restrict__ tnear,
                      const float* __restrict__ tfar,
                      bool* __restrict__ occ_out) {
  __shared__ float sw[kMaxPrims * 12];
  __shared__ float sq[kMaxPrims];
  stage(woop, quad, tc, sw, sq);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float3 ro = load3(o, i), rd = load3(d, i);
  const float tn = tnear[i], tf = tfar[i];
  bool occ = false;
  for (int k = 0; k < tc && !occ; ++k) {
    float t, u, v;
    occ = woop_test(sw + 12 * k, sq[k], ro, rd, tn, tf, t, u, v);
  }
  occ_out[i] = occ;
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

int lj_intersect_brute(const float* woop, const float* quad,
                       const int* cast_src, const int* cast_alt, int tc,
                       int n, const float* o, const float* d,
                       const float* tnear, const float* tfar, float* t,
                       int* prim, float* u, float* v, void* stream) {
  if (n <= 0 || tc <= 0 || tc > kMaxPrims) return (int)cudaErrorInvalidValue;
  intersect_brute_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      woop, quad, cast_src, cast_alt, tc, n, o, d, tnear, tfar, t, prim, u,
      v);
  return (int)cudaGetLastError();
}

int lj_occluded_brute(const float* woop, const float* quad, int tc, int n,
                      const float* o, const float* d, const float* tnear,
                      const float* tfar, bool* occ, void* stream) {
  if (n <= 0 || tc <= 0 || tc > kMaxPrims) return (int)cudaErrorInvalidValue;
  occluded_brute_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      woop, quad, tc, n, o, d, tnear, tfar, occ);
  return (int)cudaGetLastError();
}

}  // extern "C"
