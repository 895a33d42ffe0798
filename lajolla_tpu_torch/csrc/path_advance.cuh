// One path vertex for one lane: the device form of
// lajolla_tpu_torch/integrators/path_kernel.py `_advance_core`.
//
// Replaces the per-vertex body of lajolla_tpu's Pallas kernels
// (lajolla_tpu/integrators/path_kernel.py `_advance_core`, shared by
// `_kernel` there and by path_megakernel.py `_kernel`). The TPU form
// computes every lane of a (row, 4096) block in lockstep, resolving the
// closest hit by (T, B) reductions and fetching records by one-hot MXU
// matmuls. Here one thread owns one lane: the casts are loops with an
// early-out-free closest-hit scan and an early-out any-hit scan, and the
// records are plain indexed loads.
//
// What bounds it on Hopper: per-thread ALU work (the cast loops are
// 2 x 18 FLOPs per cast prim per vertex), warp divergence between lanes
// on different materials and path lengths, and register pressure from
// inlining this function into the kernels. The loops whose index is the
// same in every lane (the two cast scans, the light pick's and the
// staircase's CDF scans) read their rows either from tb's arrays through
// the read-only cache, 13 scalar loads a prim (K2, K9), or from a copy
// that each persistent block of K1 and K8 stages once in shared memory,
// four 16-byte broadcast loads a prim (STAGED; "Staged rows" below). The
// per-lane records (the hit's 34 floats, the light's) stay indexed loads
// from device memory. A wavefront redesign that regroups lanes by
// material is later work (ROADMAP; PAPERS.md "Megakernel vs Wavefront GPU
// Path Tracing").
//
// Numerics follow the plain form operation for operation in fp32: IEEE
// division and sqrtf (the library is built without --use_fast_math),
// 1/sqrtf for rsqrt, NaN-propagating max/min like torch.clamp and
// jnp.maximum. nvcc contracts a*b+c into FMAs, so a few paths diverge
// from the plain form where a rounding flips a comparison; the tests
// compare per-pixel medians for that reason.
#pragma once

#include <cstddef>
#include <cstdint>

namespace lj {

constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kFourPi = 12.566370614359172f;
constexpr uint32_t kGold = 0x9E3779B9u;

// Material set bits (template parameter MATS): scene/types.py tags 0, 1.
constexpr int kLambertian = 1;
constexpr int kRoughPlastic = 2;

// Scene tables, all device pointers, in the layout scene/compile.py
// builds them (no repacking on the host).
struct Tables {
  const float* woop;           // (TC, 12) [Ax(4) Ay(4) Az(4)] cast prims
  const float* woop_occ;       // (T_OCC, 12) occluder subset
  const float* tri;            // (40, T) per-triangle record
  const int* cast_src;         // (TC,) rep triangle per cast prim
  const int* cast_alt;         // (TC,) partner triangle (quads)
  const float* cast_quad;      // (TC,) 1 where the cast prim is a quad
  const float* cast_occ_quad;  // (T_OCC,)
  const float* light;          // (16, L) light record
  const float* stair;          // (T,) staircase triangle CDF
  const float* sph;            // (max(S, 1), 24) sphere record
  int tc, t_occ, t, l, s;
  float eps_isect, eps_shadow;
  float shadow_far_scale;      // fp32 of (1 - eps_shadow) taken in fp64
  int max_depth, rr_depth, max_cap;
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// NaN-propagating max/min (jnp.maximum, torch.clamp)
__device__ __forceinline__ float mx(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float mn(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return mn(mx(x, lo), hi);
}

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ V3 norm3(V3 a) {
  float inv = 1.0f / sqrtf(mx(a.x * a.x + a.y * a.y + a.z * a.z, 1e-30f));
  return {a.x * inv, a.y * inv, a.z * inv};
}

// Branch-free Frisvad ONB: t and b of the frame around n.
__device__ __forceinline__ void onb(V3 n, V3& t, V3& b) {
  float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + n.z);
  float bb = n.x * n.y * a;
  t = {1.0f + sign * n.x * n.x * a, sign * bb, -sign * n.x};
  b = {bb, sign + n.y * n.y * a, -n.y};
}

// ---------------------------------------------------------------- RNG
__device__ __forceinline__ uint32_t pcg_hash(uint32_t v) {
  v = v * 747796405u + 2891336453u;
  uint32_t w = ((v >> ((v >> 28u) + 4u)) ^ v) * 277803737u;
  return (w >> 22u) ^ w;
}
__device__ __forceinline__ float u01(uint32_t h) {
  return (float)(h >> 8u) * (1.0f / 16777216.0f);
}

// ---------------------------------------------------------------- casts
// One Woop row set: origin and direction in the triangle's unit space.
struct Woop {
  float oz, dz, ox, dx, oy, dy;
};
__device__ __forceinline__ Woop woop_rows(const float* __restrict__ W, V3 o,
                                          V3 d) {
  Woop r;
  r.ox = W[0] * o.x + W[1] * o.y + W[2] * o.z + W[3];
  r.dx = W[0] * d.x + W[1] * d.y + W[2] * d.z;
  r.oy = W[4] * o.x + W[5] * o.y + W[6] * o.z + W[7];
  r.dy = W[4] * d.x + W[5] * d.y + W[6] * d.z;
  r.oz = W[8] * o.x + W[9] * o.y + W[10] * o.z + W[11];
  r.dz = W[8] * d.x + W[9] * d.y + W[10] * d.z;
  return r;
}

// ---------------------------------------------------------- staged rows
// K1 and K8 copy the rows that a vertex scans in a warp-uniform loop into
// the block's dynamic shared memory once, at the start of every launch
// (stage_rows); their scans then take STAGED = true and read a row as
// broadcast float4 loads. The copy, in float4s:
//   cast prim c       4c .. 4c + 3: Woop rows 0-2, then (quad, 0, 0, 0)
//   occluder c        the same from 4 tc on (woop_occ, cast_occ_quad)
//   staircase CDF     float4s(t) from 4 (tc + t_occ) on
//   light row 0       float4s(l) after it (the light pick's CDF)
// The CDFs are padded with +inf, which no `cdf < key` counts. The values
// are tb's, bit for bit, so a staged scan computes what a global one does.
// K1 and K8 take scenes of fewer than 192 triangles (no BVH), so the copy
// stays under ~26 KB: below the 48 KiB a block may take without an
// opt-in, with 8 blocks an SM (their launch bound) beside it.

// The float4s that hold n floats.
__host__ __device__ constexpr int float4s(int n) { return (n + 3) / 4; }

// Bytes of a block's copy: the launch's dynamic shared memory.
__host__ __device__ inline size_t stage_bytes(const Tables& tb) {
  return 16 * size_t(4 * tb.tc + 4 * tb.t_occ + float4s(tb.t) +
                     float4s(tb.l));
}

__device__ __forceinline__ float4* staged() {
  extern __shared__ float4 lj_staged[];
  return lj_staged;
}

// Every thread of the block calls it once, before any scan.
__device__ __forceinline__ void stage_rows(const Tables& tb) {
  float4* s = staged();
  auto rows = [&](float4* dst, const float* woop, const float* quad, int n) {
    for (int i = threadIdx.x; i < 4 * n; i += blockDim.x) {
      const int c = i >> 2, k = i & 3;
      if (k < 3) {
        const float* w = woop + 12 * c + 4 * k;
        dst[i] = make_float4(__ldg(w), __ldg(w + 1), __ldg(w + 2),
                             __ldg(w + 3));
      } else {
        dst[i] = make_float4(__ldg(quad + c), 0.0f, 0.0f, 0.0f);
      }
    }
  };
  auto cdf = [&](float4* dst, const float* src, int n) {
    float* d = reinterpret_cast<float*>(dst);
    for (int i = threadIdx.x; i < 4 * float4s(n); i += blockDim.x)
      d[i] = i < n ? __ldg(src + i) : inf_f();
  };
  rows(s, tb.woop, tb.cast_quad, tb.tc);
  rows(s + 4 * tb.tc, tb.woop_occ, tb.cast_occ_quad, tb.t_occ);
  cdf(s + 4 * (tb.tc + tb.t_occ), tb.stair, tb.t);
  cdf(s + 4 * (tb.tc + tb.t_occ) + float4s(tb.t), tb.light, tb.l);
  __syncthreads();
}

// The Woop rows of row c of a cast table: `table` (tb.woop or
// tb.woop_occ) in device memory, or the block's copy from float4 `at` on.
template <bool STAGED>
__device__ __forceinline__ Woop row_woop(const float* table, int at, int c,
                                         V3 o, V3 d) {
  if constexpr (STAGED) {
    const float4* r = staged() + at + 4 * c;
    const float4 a = r[0], b = r[1], e = r[2];
    const float W[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, e.x, e.y, e.z, e.w};
    return woop_rows(W, o, d);
  } else {
    return woop_rows(table + 12 * c, o, d);
  }
}

// The quad flag of row c: `flags` (tb.cast_quad or tb.cast_occ_quad), or
// the block's copy from float4 `at` on.
template <bool STAGED>
__device__ __forceinline__ float row_quad(const float* flags, int at,
                                          int c) {
  if constexpr (STAGED)
    return staged()[at + 4 * c + 3].x;
  else
    return __ldg(flags + c);
}

// #(cdf[k] < key) over the n entries of a CDF: `cdf` in device memory, or
// the block's copy from float4 `at` on, four entries a load.
template <bool STAGED>
__device__ __forceinline__ int cdf_count(const float* cdf, int at, int n,
                                         float key) {
  int count = 0;
  if constexpr (STAGED) {
    const float4* r = staged() + at;
    for (int k = 0; k < float4s(n); ++k) {
      const float4 v = r[k];
      count += (v.x < key ? 1 : 0) + (v.y < key ? 1 : 0) +
               (v.z < key ? 1 : 0) + (v.w < key ? 1 : 0);
    }
  } else {
    for (int k = 0; k < n; ++k) count += __ldg(cdf + k) < key ? 1 : 0;
  }
  return count;
}

// The threads that scan one lane's casts together: G aligned lanes of a
// warp, `mask` their lanes, `rank` this thread's place among them; thread
// `rank` tests the prims rank, rank + G, ... of a scan. K1, K8 and K9 scan
// alone (G = 1); K2 splits its scans over up to 8 (path_kernels.cu).
template <int G>
struct CastGroup {
  unsigned mask = 0xffffffffu;
  int rank = 0;
};

// Closest hit over the cast table in (tnear, tfar), or beyond tnear
// where FAR is false: the first prim with the least t. A group's threads
// each scan their share, then reduce by shuffle on (t, index): least t
// first, lowest index among equal t, the serial scan's rule (strict <;
// a NaN t never enters); u, v and the quad flag go with the winner, and
// every thread of the group ends with the same hit. STAGED: the rows from
// the block's copy.
template <bool QUADS, bool FAR, int G = 1, bool STAGED = false>
__device__ __forceinline__ void intersect_range(const Tables& tb, V3 o, V3 d,
                                                float tnear, float tfar,
                                                float& t_best, int& idx,
                                                float& ub, float& vb,
                                                float& qb,
                                                CastGroup<G> grp = {}) {
  t_best = inf_f();
  idx = 0;
  ub = vb = qb = 0.0f;
  for (int c = grp.rank; c < tb.tc; c += G) {
    Woop r = row_woop<STAGED>(tb.woop, 0, c, o, d);
    float t = -r.oz / r.dz;
    float u = r.ox + t * r.dx;
    float v = r.oy + t * r.dy;
    float lim = 1.0f - u - v;
    float q = 0.0f;
    if (QUADS) {
      q = row_quad<STAGED>(tb.cast_quad, 0, c);
      if (q > 0.0f) lim = 1.0f - mx(u, v);
    }
    float m = mn(mn(u, v), lim);
    if (m >= 0.0f && t > tnear && (!FAR || t < tfar) && t < t_best) {
      t_best = t;
      idx = c;
      ub = u;
      vb = v;
      qb = q;
    }
  }
  if constexpr (G > 1) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const float t2 = __shfl_xor_sync(grp.mask, t_best, off);
      const int i2 = __shfl_xor_sync(grp.mask, idx, off);
      const float u2 = __shfl_xor_sync(grp.mask, ub, off);
      const float v2 = __shfl_xor_sync(grp.mask, vb, off);
      const float q2 = __shfl_xor_sync(grp.mask, qb, off);
      if (t2 < t_best || (t2 == t_best && i2 < idx)) {
        t_best = t2;
        idx = i2;
        ub = u2;
        vb = v2;
        qb = q2;
      }
    }
  }
}

// Closest hit over the cast table beyond eps_isect.
template <bool QUADS>
__device__ __forceinline__ void intersect(const Tables& tb, V3 o, V3 d,
                                          float& t_best, int& idx, float& ub,
                                          float& vb, float& qb) {
  intersect_range<QUADS, false>(tb, o, d, tb.eps_isect, 0.0f, t_best, idx,
                                ub, vb, qb);
}

// Any-hit over the occluder subset, division-free (see _occluded). A
// group tests G occluders a round and stops on the group's vote: the
// answer is a boolean, so the order does not matter.
template <bool QUADS, int G = 1, bool STAGED = false>
__device__ __forceinline__ bool occluded(const Tables& tb, V3 o, V3 d,
                                         float tfar,
                                         CastGroup<G> grp = {}) {
  const float tnear = tb.eps_shadow;
  for (int c0 = 0; c0 < tb.t_occ; c0 += G) {
    const int c = c0 + grp.rank;
    bool hit = false;
    if (G == 1 || c < tb.t_occ) {
      Woop r = row_woop<STAGED>(tb.woop_occ, 4 * tb.tc, c, o, d);
      float w = -r.oz;
      float U = r.ox * r.dz + w * r.dx;
      float V = r.oy * r.dz + w * r.dy;
      float limv = (U + V - r.dz) * r.dz;
      if (QUADS && row_quad<STAGED>(tb.cast_occ_quad, 4 * tb.tc, c) > 0.0f)
        limv = mx((U - r.dz) * r.dz, (V - r.dz) * r.dz);
      hit = U * r.dz >= 0.0f && V * r.dz >= 0.0f && limv <= 0.0f &&
            (w - tnear * r.dz) * r.dz > 0.0f &&
            (w - tfar * r.dz) * r.dz < 0.0f;
    }
    if constexpr (G == 1) {
      if (hit) return true;
    } else {
      if (__any_sync(grp.mask, hit)) return true;
    }
  }
  return false;
}

// Stable-quadratic sphere t (misses and padding rows at +inf).
__device__ __forceinline__ float sphere_t(const float* __restrict__ s, V3 o,
                                          V3 d, float tnear, float tfar) {
  float r = s[3];
  float ocx = o.x - s[0], ocy = o.y - s[1], ocz = o.z - s[2];
  float b = 2.0f * (ocx * d.x + ocy * d.y + ocz * d.z);
  float c = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
  float disc = b * b - 4.0f * c;
  float sq = sqrtf(mx(disc, 0.0f));
  float q = -0.5f * (b >= 0.0f ? b + sq : b - sq);
  float t1 = c / (fabsf(q) > 1e-30f ? q : 1e-30f);
  float tlo = mn(q, t1), thi = mx(q, t1);
  bool ok = disc >= 0.0f;
  float t = inf_f();
  if (ok && thi > tnear && thi < tfar) t = thi;
  if (ok && tlo > tnear && tlo < tfar) t = tlo;
  return r > 0.0f ? t : inf_f();
}

// ---------------------------------------------------------------- BSDFs
__device__ __forceinline__ float fresnel_dielectric(float n_dot_i, float eta) {
  float n_dot_t_sq = 1.0f - (1.0f - n_dot_i * n_dot_i) / (eta * eta);
  float n_dot_t = sqrtf(mx(n_dot_t_sq, 0.0f));
  float c = fabsf(n_dot_i);
  float rs = (c - eta * n_dot_t) / (c + eta * n_dot_t);
  float rp = (eta * c - n_dot_t) / (eta * c + n_dot_t);
  float F = 0.5f * (rs * rs + rp * rp);
  return n_dot_t_sq < 0.0f ? 1.0f : F;
}

__device__ __forceinline__ float ggx_d(float n_dot_h, float roughness) {
  float alpha = roughness * roughness;
  float a2 = alpha * alpha;
  float t = n_dot_h * n_dot_h * (a2 - 1.0f) + 1.0f;
  return a2 / mx(kPi * t * t, 1e-20f);
}

__device__ __forceinline__ float smith_g1(float n_dot_v, float roughness) {
  float alpha = roughness * roughness;
  float a2 = alpha * alpha;
  float z2 = n_dot_v * n_dot_v;
  float lam = (-1.0f + sqrtf(1.0f + (1.0f - z2) * a2 / mx(z2, 1e-20f))) / 2.0f;
  return 1.0f / (1.0f + lam);
}

__device__ __forceinline__ float luminance(V3 c) {
  return c.x * 0.212671f + c.y * 0.715160f + c.z * 0.072169f;
}

struct Mat {
  V3 kd, ks;
  float mt, rough, eta;
};

__device__ __forceinline__ void rp_eval_pdf(V3 wi, V3 wo, V3 fn, V3 ng,
                                            const Mat& m, V3& f, float& pdf) {
  bool below = dot3(ng, wi) < 0.0f || dot3(ng, wo) < 0.0f;
  V3 h = norm3(v3(wi.x + wo.x, wi.y + wo.y, wi.z + wo.z));
  float n_dot_h = dot3(fn, h);
  float n_dot_in = dot3(fn, wi);
  float n_dot_out = dot3(fn, wo);
  bool invalid = below || n_dot_out <= 0.0f || n_dot_h <= 0.0f;
  float F_o = fresnel_dielectric(dot3(h, wo), m.eta);
  float D = ggx_d(n_dot_h, m.rough);
  float G_in = smith_g1(n_dot_in, m.rough);
  float G = G_in * smith_g1(n_dot_out, m.rough);
  float spec_s = (G * F_o * D) / mx(4.0f * n_dot_in * n_dot_out, 1e-20f);
  float F_i = fresnel_dielectric(dot3(h, wi), m.eta);
  float diff_s = (1.0f - F_o) * (1.0f - F_i) / kPi;
  f = invalid ? v3(0.0f, 0.0f, 0.0f)
              : v3((m.ks.x * spec_s + m.kd.x * diff_s) * n_dot_out,
                   (m.ks.y * spec_s + m.kd.y * diff_s) * n_dot_out,
                   (m.ks.z * spec_s + m.kd.z * diff_s) * n_dot_out);
  float lS = luminance(m.ks), lR = luminance(m.kd);
  float total = mx(lS + lR, 1e-20f);
  bool invalid_p = invalid || lS + lR <= 0.0f;
  float p = (lS / total) * (G_in * D) / mx(4.0f * n_dot_in, 1e-20f) +
            (1.0f - lS / total) * n_dot_out / kPi;
  pdf = invalid_p ? 0.0f : p;
}

__device__ __forceinline__ V3 cosine_dir(V3 fn, float u0, float u1) {
  float phi = kTwoPi * u0;
  float tmp = sqrtf(clampf(1.0f - u1, 0.0f, 1.0f));
  float lx = cosf(phi) * tmp;
  float ly = sinf(phi) * tmp;
  float lz = sqrtf(clampf(u1, 0.0f, 1.0f));
  V3 t, b;
  onb(fn, t, b);
  return {lx * t.x + ly * b.x + lz * fn.x, lx * t.y + ly * b.y + lz * fn.y,
          lx * t.z + ly * b.z + lz * fn.z};
}

__device__ __forceinline__ V3 rp_sample(V3 wi, V3 fn, const Mat& m, float u0,
                                        float u1, float w, bool& valid) {
  float lS = luminance(m.ks), lR = luminance(m.kd);
  float spec_prob = lS / mx(lS + lR, 1e-20f);
  valid = lS + lR > 0.0f;
  // VNDF half-vector (Heitz 2018, microfacet.h:85-114), local frame
  V3 t, b;
  onb(fn, t, b);
  V3 li = v3(dot3(t, wi), dot3(b, wi), dot3(fn, wi));
  bool flip = li.z < 0.0f;
  li = sel(flip, neg(li), li);
  float alpha = m.rough * m.rough;
  V3 hv = norm3(v3(alpha * li.x, alpha * li.y, li.z));
  float rr = sqrtf(clampf(u0, 0.0f, 1.0f));
  float phi = kTwoPi * u1;
  float t1 = rr * cosf(phi);
  float t2 = rr * sinf(phi);
  float s = 0.5f * (1.0f + hv.z);
  t2 = (1.0f - s) * sqrtf(mx(1.0f - t1 * t1, 0.0f)) + s * t2;
  float dnz = sqrtf(mx(1.0f - t1 * t1 - t2 * t2, 0.0f));
  V3 ft, fb;
  onb(hv, ft, fb);
  V3 hn = v3(t1 * ft.x + t2 * fb.x + dnz * hv.x,
             t1 * ft.y + t2 * fb.y + dnz * hv.y,
             t1 * ft.z + t2 * fb.z + dnz * hv.z);
  V3 hl = norm3(v3(alpha * hn.x, alpha * hn.y, mx(hn.z, 0.0f)));
  hl = sel(flip, neg(hl), hl);
  V3 h = v3(hl.x * t.x + hl.y * b.x + hl.z * fn.x,
            hl.x * t.y + hl.y * b.y + hl.z * fn.y,
            hl.x * t.z + hl.y * b.z + hl.z * fn.z);
  float i_dot_h = dot3(wi, h);
  V3 r = norm3(v3(2.0f * i_dot_h * h.x - wi.x, 2.0f * i_dot_h * h.y - wi.y,
                  2.0f * i_dot_h * h.z - wi.z));
  return w < spec_prob ? r : cosine_dir(fn, u0, u1);
}

template <int MATS>
__device__ __forceinline__ void eval_pdf(V3 wi, V3 wo, V3 fn, V3 ng,
                                         const Mat& m, V3& f, float& pdf) {
  if ((MATS & kRoughPlastic) && (MATS == kRoughPlastic || m.mt == 1.0f)) {
    rp_eval_pdf(wi, wo, fn, ng, m, f, pdf);
    return;
  }
  bool below = dot3(ng, wi) < 0.0f || dot3(ng, wo) < 0.0f;
  float sc = below ? 0.0f : mx(dot3(fn, wo), 0.0f) / kPi;
  f = v3(m.kd.x * sc, m.kd.y * sc, m.kd.z * sc);
  pdf = sc;
}

template <int MATS>
__device__ __forceinline__ V3 sample_dir(V3 wi, V3 fn, V3 ng, const Mat& m,
                                         float u0, float u1, float w,
                                         bool& valid) {
  bool below_in = dot3(ng, wi) < 0.0f;
  V3 dir;
  if ((MATS & kRoughPlastic) && (MATS == kRoughPlastic || m.mt == 1.0f)) {
    dir = rp_sample(wi, fn, m, u0, u1, w, valid);
  } else {
    dir = cosine_dir(fn, u0, u1);
    valid = true;
  }
  valid = valid && !below_in;
  return dir;
}

// Cone pdf toward a sphere in area measure, inside-uniform fallback
// (shapes/sphere.inl:210-230).
__device__ __forceinline__ float cone_pdf_area(V3 c, float r, V3 ref, V3 n,
                                               V3 dl, float dist2) {
  float ex = c.x - ref.x, ey = c.y - ref.y, ez = c.z - ref.z;
  float d2 = ex * ex + ey * ey + ez * ez;
  bool inside = d2 < r * r;
  float uniform = 1.0f / mx(kFourPi * r * r, 1e-20f);
  float cos_el_max = sqrtf(mx(1.0f - r * r / mx(d2, 1e-20f), 0.0f));
  float pdf_solid = 1.0f / mx(kTwoPi * (1.0f - cos_el_max), 1e-20f);
  float pdf_area = pdf_solid * fabsf(dot3(n, dl)) / mx(dist2, 1e-20f);
  return inside ? uniform : pdf_area;
}

// ------------------------------------------------------- shared vertex parts
// The pieces of a vertex that K1/K2 (advance_vertex below) and K8
// (volpath_kernels.cu) compute alike.

// Closest hit over triangles and spheres, with the winning records.
struct Surf {
  float t;             // closest distance, inf on a miss
  bool sph_win;        // a sphere is closer than every triangle
  bool found;          // a triangle is hit
  int prim;            // the hit triangle (found only)
  const float* srow;   // the winning sphere's record (sph_win only)
  float rw[34];        // the triangle record, zero where no triangle is hit
  float ub, vb;        // barycentrics in the record's own triangle
};

// The scan of a closest hit, without its records: what K9 carries from a
// cast across a free flight's tracking steps.
struct HitScan {
  float t;             // closest distance, inf on a miss
  float ub, vb;        // barycentrics in the record's own triangle
  int prim;            // the hit triangle (found only)
  int sph;             // the winning sphere, -1 where no sphere is closer
  bool found;          // a triangle is hit
};

// The scan of the closest hit in (tnear, tfar), or beyond tnear where FAR
// is false.
template <bool QUADS, bool SPH, bool FAR, int G = 1, bool STAGED = false>
__device__ __forceinline__ void closest_scan(const Tables& tb, V3 o, V3 d,
                                             float tnear, float tfar,
                                             HitScan& h,
                                             CastGroup<G> grp = {}) {
  float t_tri, qb;
  int idx;
  intersect_range<QUADS, FAR, G, STAGED>(tb, o, d, tnear, tfar, t_tri, idx,
                                         h.ub, h.vb, qb, grp);
  h.found = t_tri < inf_f();
  h.t = t_tri;
  h.sph = -1;
  if (SPH) {
    float t_sph = inf_f();
    int sidx = 0;
    for (int k = 0; k < tb.s; ++k) {
      float ts = sphere_t(tb.sph + 24 * k, o, d, tnear, FAR ? tfar : inf_f());
      if (ts < t_sph) {
        t_sph = ts;
        sidx = k;
      }
    }
    if (t_sph < t_tri) h.sph = sidx;
    h.t = mn(t_tri, t_sph);
  }
  int prim = tb.cast_src[idx];
  if (QUADS) {
    bool back = qb > 0.0f && h.ub + h.vb > 1.0f;
    if (back) {
      prim = tb.cast_alt[idx];
      float u2 = 1.0f - h.vb, v2 = h.ub + h.vb - 1.0f;
      h.ub = u2;
      h.vb = v2;
    }
  }
  h.prim = prim;
}

// The records of a scanned hit.
__device__ __forceinline__ void surf_of(const Tables& tb, const HitScan& h,
                                        Surf& s) {
  const int T = tb.t;
  s.t = h.t;
  s.sph_win = h.sph >= 0;
  s.found = h.found;
  s.prim = h.prim;
  s.srow = s.sph_win ? tb.sph + 24 * h.sph : nullptr;
  s.ub = h.ub;
  s.vb = h.vb;
  // zero on a miss, like the TPU kernels' one-hot row
#pragma unroll
  for (int k = 0; k < 34; ++k)
    s.rw[k] = h.found ? __ldg(tb.tri + k * T + h.prim) : 0.0f;
}

// The closest hit in (tnear, tfar), or beyond tnear where FAR is false.
template <bool QUADS, bool SPH, bool FAR, int G = 1, bool STAGED = false>
__device__ __forceinline__ void closest_hit_range(const Tables& tb, V3 o,
                                                  V3 d, float tnear,
                                                  float tfar, Surf& s,
                                                  CastGroup<G> grp = {}) {
  HitScan h;
  closest_scan<QUADS, SPH, FAR, G, STAGED>(tb, o, d, tnear, tfar, h, grp);
  surf_of(tb, h, s);
}

template <bool QUADS, bool SPH, int G = 1, bool STAGED = false>
__device__ __forceinline__ void closest_hit(const Tables& tb, V3 o, V3 d,
                                            Surf& s,
                                            CastGroup<G> grp = {}) {
  closest_hit_range<QUADS, SPH, false, G, STAGED>(tb, o, d, tb.eps_isect,
                                                  0.0f, s, grp);
}

// Shading data of the hit at point p: normals (the geometric one turned
// toward the shading one), light and material parameters.
struct Shade {
  V3 ng, sn;
  float h_light, h_pmf;
  float inv_area;      // 1/area of the hit triangle (meaningless on spheres)
  V3 le;
  Mat m;
  V3 sc;               // sphere center and radius (sph_win only)
  float sr;
};

template <bool SPH>
__device__ __forceinline__ void shade(const Surf& s, V3 p, Shade& h) {
  const float* rw = s.rw;
  h.ng = norm3(v3(rw[4] * rw[8] - rw[5] * rw[7], rw[5] * rw[6] - rw[3] * rw[8],
                  rw[3] * rw[7] - rw[4] * rw[6]));
  float wb = 1.0f - s.ub - s.vb;
  V3 sn = v3(wb * rw[9] + s.ub * rw[12] + s.vb * rw[15],
             wb * rw[10] + s.ub * rw[13] + s.vb * rw[16],
             wb * rw[11] + s.ub * rw[14] + s.vb * rw[17]);
  h.sn = norm3(rw[18] > 0.0f ? sn : h.ng);
  if (dot3(h.ng, h.sn) < 0.0f) h.ng = neg(h.ng);
  h.h_light = rw[19];
  h.h_pmf = rw[27];
  h.inv_area = rw[26];
  h.le = v3(rw[23], rw[24], rw[25]);
  h.m.kd = v3(rw[20], rw[21], rw[22]);
  h.m.mt = rw[28];
  h.m.ks = v3(rw[29], rw[30], rw[31]);
  h.m.rough = rw[32];
  h.m.eta = rw[33];
  h.sc = v3(0.0f, 0.0f, 0.0f);
  h.sr = 0.0f;
  if (SPH && s.sph_win) {
    const float* srow = s.srow;
    h.sc = v3(srow[0], srow[1], srow[2]);
    h.sr = srow[3];
    float inv_r = 1.0f / mx(h.sr, 1e-20f);
    h.ng = norm3(v3((p.x - h.sc.x) * inv_r, (p.y - h.sc.y) * inv_r,
                    (p.z - h.sc.z) * inv_r));
    h.sn = h.ng;
    h.h_light = srow[4];
    h.le = v3(srow[15], srow[16], srow[17]);
    h.h_pmf = srow[14];
    h.m.kd = v3(srow[6], srow[7], srow[8]);
    h.m.mt = srow[5];
    h.m.ks = v3(srow[9], srow[10], srow[11]);
    h.m.rough = srow[12];
    h.m.eta = srow[13];
  }
  h.m.rough = clampf(h.m.rough, 0.01f, 1.0f);
}

// A light point for NEE from p: light pick = #(cdf < u2), clamped; mesh
// lights by the staircase triangle pick (u3) and a sqrt-uv barycentric
// point (u0, u1); sphere lights by cone sampling with the inside-uniform
// fallback (shapes/sphere.inl:156-204).
struct LightSample {
  V3 lp;               // the light point
  V3 ln;               // the light point's normal
  V3 l_int;            // radiance
  float l_pmf, p1_area;  // pick pmf, area-measure pdf of the point
  V3 dl;               // normalize(point - p)
  float dist2, dist;   // |point - p|^2 (clamped at 1e-20) and its sqrt
};

template <bool SPH, bool STAGED = false>
__device__ __forceinline__ void sample_light(const Tables& tb, V3 p, float u0,
                                             float u1, float u2, float u3,
                                             LightSample& ls) {
  const int T = tb.t, L = tb.l;
  const int stair_at = 4 * (tb.tc + tb.t_occ);
  int lsel = cdf_count<STAGED>(tb.light, stair_at + float4s(T), L, u2);
  lsel = min(lsel, L - 1);
  auto lr_ = [&](int k) { return __ldg(tb.light + k * L + lsel); };
  ls.l_pmf = lr_(1);
  ls.l_int = v3(lr_(2), lr_(3), lr_(4));
  ls.p1_area = lr_(5);
  float key = lr_(6) + u3;
  int tsel = cdf_count<STAGED>(tb.stair, stair_at, T, key);
  tsel = min(tsel, T - 1);
  float lt[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) lt[k] = __ldg(tb.tri + k * T + tsel);
  float a_s = sqrtf(clampf(u0, 0.0f, 1.0f));
  float b1 = 1.0f - a_s;
  float b2 = a_s * u1;
  V3 lp = v3(lt[0] + b1 * lt[3] + b2 * lt[6], lt[1] + b1 * lt[4] + b2 * lt[7],
             lt[2] + b1 * lt[5] + b2 * lt[8]);
  ls.ln = norm3(v3(lt[4] * lt[8] - lt[5] * lt[7], lt[5] * lt[6] - lt[3] * lt[8],
                   lt[3] * lt[7] - lt[4] * lt[6]));
  bool is_sl = false;
  V3 lc = v3(0.0f, 0.0f, 0.0f);
  float lrad = 0.0f;
  if (SPH) {
    is_sl = lr_(7) > 0.0f;
    if (is_sl) {
      lc = v3(lr_(8), lr_(9), lr_(10));
      lrad = lr_(11);
      float dcx = lc.x - p.x, dcy = lc.y - p.y, dcz = lc.z - p.z;
      float d2c = mx(dcx * dcx + dcy * dcy + dcz * dcz, 1e-20f);
      V3 lns;
      if (d2c < lrad * lrad) {
        float zu = 1.0f - 2.0f * u0;
        float ru = sqrtf(mx(1.0f - zu * zu, 0.0f));
        float phiu = kTwoPi * u1;
        lns = v3(ru * cosf(phiu), ru * sinf(phiu), zu);
      } else {
        V3 tc = norm3(v3(dcx, dcy, dcz));
        V3 ft, fb;
        onb(tc, ft, fb);
        float sin_el_max_sq = lrad * lrad / d2c;
        float cos_el_max = sqrtf(mx(1.0f - sin_el_max_sq, 0.0f));
        float cos_el = (1.0f - u0) + u0 * cos_el_max;
        float sin_el = sqrtf(mx(1.0f - cos_el * cos_el, 0.0f));
        float azim = kTwoPi * u1;
        float dc = sqrtf(d2c);
        float ds = dc * cos_el -
                   sqrtf(mx(lrad * lrad - dc * dc * sin_el * sin_el, 0.0f));
        float cos_a = (dc * dc + lrad * lrad - ds * ds) / mx(2.0f * dc * lrad, 1e-20f);
        float sin_a = sqrtf(mx(1.0f - cos_a * cos_a, 0.0f));
        float ca = cosf(azim), sa = sinf(azim);
        lns = v3(-(sin_a * ca * ft.x + sin_a * sa * fb.x + cos_a * tc.x),
                 -(sin_a * ca * ft.y + sin_a * sa * fb.y + cos_a * tc.y),
                 -(sin_a * ca * ft.z + sin_a * sa * fb.z + cos_a * tc.z));
      }
      lp = v3(lc.x + lrad * lns.x, lc.y + lrad * lns.y, lc.z + lrad * lns.z);
      ls.ln = lns;
    }
  }
  ls.lp = lp;
  float dlx = lp.x - p.x, dly = lp.y - p.y, dlz = lp.z - p.z;
  ls.dist2 = mx(dlx * dlx + dly * dly + dlz * dlz, 1e-20f);
  ls.dl = norm3(v3(dlx, dly, dlz));
  ls.dist = sqrtf(ls.dist2);
  if (SPH && is_sl) ls.p1_area = cone_pdf_area(lc, lrad, p, ls.ln, ls.dl, ls.dist2);
}

// Shadow any-hit over the occluder subset and the spheres, in (eps_shadow,
// tfar).
template <bool QUADS, bool SPH, int G = 1, bool STAGED = false>
__device__ __forceinline__ bool occluded_any(const Tables& tb, V3 p, V3 dl,
                                             float tfar,
                                             CastGroup<G> grp = {}) {
  if (occluded<QUADS, G, STAGED>(tb, p, dl, tfar, grp)) return true;
  if (SPH)
    for (int k = 0; k < tb.s; ++k)
      if (sphere_t(tb.sph + 24 * k, p, dl, tb.eps_shadow, tfar) < inf_f())
        return true;
  return false;
}

// ---------------------------------------------------------------- advance
// Lane state carried from vertex to vertex.
struct Lane {
  V3 o, d, thr, rad;
  float dir_pdf;
  V3 prev;
};

// One path vertex. On return st.o is the hit point, st.d the sampled
// direction, st.thr/st.rad/st.dir_pdf the updated throughput, radiance
// and solid-angle pdf; st.prev is left for the caller. `un` holds the
// vertex's 8 uniforms. Returns alive. A group (grp) splits the two cast
// scans; every thread of it computes the rest on the same values. STAGED:
// the scans read the block's copy of their rows.
template <int MATS, bool QUADS, bool SPH, int G = 1, bool STAGED = false>
__device__ __forceinline__ bool advance_vertex(const Tables& tb, Lane& st,
                                               float nv, const float* un,
                                               CastGroup<G> grp = {}) {
  const V3 o = st.o, d = st.d, thr = st.thr, prev = st.prev;

  // ---- closest hit: triangles + spheres
  Surf s;
  closest_hit<QUADS, SPH, G, STAGED>(tb, o, d, s, grp);
  bool valid = s.t < inf_f();
  float t_eff = valid ? s.t : 0.0f;
  V3 p = v3(o.x + t_eff * d.x, o.y + t_eff * d.y, o.z + t_eff * d.z);
  Shade h;
  shade<SPH>(s, p, h);
  const V3 ng = h.ng;
  const V3 wi = neg(d);

  // ---- emissive hit + MIS (cached-pdf form)
  bool hit_light = valid && h.h_light >= 0.0f;
  V3 le = dot3(ng, wi) > 0.0f ? h.le : v3(0.0f, 0.0f, 0.0f);
  float dpx = p.x - prev.x, dpy = p.y - prev.y, dpz = p.z - prev.z;
  float dist2p = mx(dpx * dpx + dpy * dpy + dpz * dpz, 1e-20f);
  float G2 = fabsf(dot3(d, ng)) / dist2p;
  float p2e = st.dir_pdf * G2;
  float p1e = h.h_pmf * h.inv_area;
  if (SPH && s.sph_win) p1e = h.h_pmf * cone_pdf_area(h.sc, h.sr, prev, ng, d, dist2p);
  float w2 = (p2e * p2e) / mx(p1e * p1e + p2e * p2e, 1e-30f);
  if (nv <= 2.0f) w2 = 1.0f;
  float add = (hit_light ? 1.0f : 0.0f) * w2;
  V3 rad = v3(st.rad.x + thr.x * le.x * add, st.rad.y + thr.y * le.y * add,
              st.rad.z + thr.z * le.z * add);

  bool depth_stop = tb.max_depth != -1 ? nv > (float)tb.max_depth
                                       : nv >= 2.0f + (float)tb.max_cap;
  bool alive = valid && !depth_stop;

  // ---- NEE
  LightSample ls;
  sample_light<SPH, STAGED>(tb, p, un[0], un[1], un[2], un[3], ls);
  const V3 dl = ls.dl;
  bool occ = occluded_any<QUADS, SPH, G, STAGED>(
      tb, p, dl, tb.shadow_far_scale * ls.dist, grp);
  float ln_dl = -dot3(dl, ls.ln);
  float Gn = occ ? 0.0f : mx(ln_dl, 0.0f) / ls.dist2;
  float p1 = ls.l_pmf * ls.p1_area;
  // frame flip for the BSDF (lambertian.inl:10-13)
  V3 fn = dot3(h.sn, wi) < 0.0f ? neg(h.sn) : h.sn;
  V3 f_nee;
  float p2n_sa;
  eval_pdf<MATS>(wi, dl, fn, ng, h.m, f_nee, p2n_sa);
  float p2n = p2n_sa * Gn;
  bool nee_ok = alive && Gn > 0.0f && p1 > 0.0f && ln_dl > 0.0f;
  float w1 = (p1 * p1) / mx(p1 * p1 + p2n * p2n, 1e-30f);
  float c1 = nee_ok ? Gn / mx(p1, 1e-30f) * w1 : 0.0f;
  const V3 l_int = ls.l_int;
  rad = v3(rad.x + thr.x * f_nee.x * l_int.x * c1,
           rad.y + thr.y * f_nee.y * l_int.y * c1,
           rad.z + thr.z * f_nee.z * l_int.z * c1);

  // ---- BSDF sampling
  bool samp_valid;
  V3 dir_out = sample_dir<MATS>(wi, fn, ng, h.m, un[4], un[5], un[6], samp_valid);
  alive = alive && samp_valid;
  V3 f2;
  float p2s;
  eval_pdf<MATS>(wi, dir_out, fn, ng, h.m, f2, p2s);
  alive = alive && p2s > 0.0f;

  // ---- RR
  float tmax = mx(mx(thr.x, thr.y), thr.z);
  float rr = (nv - 1.0f) >= (float)tb.rr_depth ? mn(tmax, 0.95f) : 1.0f;
  alive = alive && un[7] <= rr;
  float inv_p = 1.0f / mx(p2s * rr, 1e-30f);

  st.o = p;
  st.d = dir_out;
  st.thr = v3(thr.x * f2.x * inv_p, thr.y * f2.y * inv_p, thr.z * f2.z * inv_p);
  st.rad = rad;
  st.dir_pdf = p2s;
  return alive;
}

}  // namespace lj
