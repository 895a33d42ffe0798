// Kernel K9: the fused volumetric path tracer for grid media (the hetvol
// class), with a plain C interface for ctypes (lajolla_tpu_torch/kernels.py
// builds this file with nvcc for sm_90a, with -fmad=false, and binds it).
//
// Replaces lajolla_tpu's Pallas kernel
// lajolla_tpu/integrators/volpath_grid_kernel.py `_kernel` (launched by
// `render_fused_grid`, step body `_advance_grid_core`): nspp samples of
// every pixel in one launch, for scenes inside volpath_grid_kernel.supports
// — one heterogeneous medium with a mono density grid and a constant
// albedo, zero supervoxel minorants, Lambertian / RoughPlastic surfaces and
// index-matching interfaces, the camera in vacuum or in the medium. Its
// plain PyTorch form is lajolla_tpu_torch/integrators/volpath_grid_kernel.py
// `render_fused_grid_plain` / `_advance_grid_core`.
//
// The TPU kernel runs the flat event machine in lockstep over a (row,
// 2048) block of lanes: each step makes one cast, K_STEPS tracking steps
// and at most one vertex, because every nesting level of a lockstep loop
// costs the block's longest. It fetches the supervoxel majorants by a
// one-hot MXU matmul and the density by an MXU matmul-gather, since Mosaic
// has no per-lane gather. Here persistent warps fill the card
// (work_queue.cuh) and each lane runs its own flat event machine, one
// stage of its own state an iteration: a cast (the main ray, or a shadow
// segment toward the light point), one tracking step of the current free
// flight (`ff_micro`: a supervoxel DDA step and one trilinear density
// read), or the vertex. Between the stages the lane carries the scan of
// its closest hit (path_advance.cuh HitScan: distance, prim, barycentrics,
// sphere), and shades it at the vertex. A lane whose path ends writes its
// item's radiance to out[item - s0*n_q] and takes the next work item from
// a device counter (one atomicAdd a warp for all its asking lanes). So no
// lane waits for its warp's longest flight, vertex loop or sample; only
// the queue's tail does. The warp's schedule is plain flattening, chosen
// by measurement (tools/tune_torch_vol_schedule.py, PERF.md): every
// iteration runs every stage that holds a lane (the while-while pattern of
// Aila & Laine 2009, the tracking step alone while enough lanes track,
// measured no faster). film_sum_kernel (volpath_kernels.cu) adds each
// pixel's samples in sample order, so the film does not depend on which
// thread ran a path or when. Every draw is a position-independent counter-hash
// cell (the (item, bounce) root hb, the flight's iteration index, the
// segment index), so the machine draws the event machine's numbers. The
// density is an fp32 trilinear read of the (Z*Y, X) grid, its 8 corners
// through the read-only cache, interpolated along x, then y, then z, as
// the plain form does; the (2, R) supervoxel [majorant | empty-skip] table
// (R <= 512) sits in shared memory, loaded once a block.
//
// Work items: the pool of n_q = ceil(n / 2048) * 2048 lanes; item s0*n_q +
// k belongs to lane k mod n_q of the pool, which owns pixel k mod n_q;
// items of lanes >= n are skipped at the fetch (their rows of out are not
// written).
//
// What bounds it: latency (the 8 L2 reads of a tracking step's density,
// the table reads of the casts, the spilled state), which only many warps
// an SM hide (kMinBlocks); fp32 ALU work per thread (the casts over <= 192
// prims, the DDA step, the 8-corner density read, the BSDFs); and
// divergence between the stages that a warp's lanes are in. The bytes are
// a few MB of tables (the 3.3 MB grid of the hetvol class stays in the 50
// MB L2) and 12 bytes an item for the per-item buffer.
//
// Numerics follow the plain form operation for operation in fp32; the file
// is built with -fmad=false so that no multiply-add is contracted (the
// plain form's operations are separate torch kernels), which keeps the
// zero-length tracking steps at supervoxel boundaries where the plain form
// has them. The entry returns cudaGetLastError() after its launch; the
// kernel launches on the caller's stream and does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "camera.cuh"
#include "path_advance.cuh"
#include "volpath_common.cuh"
#include "work_queue.cuh"

namespace lj {

constexpr int kMaxSvoxRows = 512;        // scene/compile.py SVOX_ROWS_MAX

// The class's medium and grid (volpath_grid_kernel.grid_statics). The HG
// constants are the plain form's Python-double expressions rounded to
// fp32: hg_a = g^2 - 1, hg_b = g + 1, hg_c = 1 + g^2, hg_d = 2 g, hg_num =
// (1 - g^2) / (4 pi).
struct GridMedium {
  float pmin[3], pmax[3];
  int res[3];            // grid nodes (X, Y, Z)
  int gres[3];           // supervoxels (X, Y, Z)
  int rows;              // gres product
  float maxval;          // the density's maximum
  float albedo[3];
  float g, hg_a, hg_b, hg_c, hg_d, hg_num;
  int hg_sample;         // HG with |g| >= 1e-3 (else the isotropic pdf)
  int cam_med;
  int max_null;          // RenderOptions.max_null_collisions
  int max_segments;      // volpath.MAX_SHADOW_SEGMENTS
};

}  // namespace lj

namespace {

using lj::Camera;
using lj::GridMedium;
using lj::mn;
using lj::mx;
using lj::u_dim;
using lj::V3;
using lj::v3;
using lj::VolSalts;

constexpr int kThreads = 128;
// At least 10 blocks an SM: at most 48 registers a thread, the rest of the
// flat machine's state spilled to local memory (~950 B, L1-resident). The
// kernel waits on latency, and 40 warps an SM beat 16 with no spills (128
// registers) by 1.4x (tools/tune_torch_vol_schedule.py, PERF.md).
constexpr int kMinBlocks = 10;
constexpr int kWarps = kThreads / 32;
// A lane's stage: waiting for a work item, a cast (main ray or shadow
// segment), a free flight's tracking steps, the vertex.
enum Stage : int { kFetch, kCast, kTrack, kVertex };
// SIMT counter slots, in pairs (warp passes, working lanes): loop
// iterations with a path in some lane; casts; tracking steps; vertices;
// then the SM cycles the warps spent in the cast, tracking and vertex
// stages.
constexpr int kStats = 11;

// volpath_grid_kernel._slab: (t0 clamped at 0, t1) against the grid's box.
__device__ __forceinline__ void slab(const GridMedium& gm, V3 o, V3 d,
                                     float& t0, float& t1) {
  const float oo[3] = {o.x, o.y, o.z}, dd[3] = {d.x, d.y, d.z};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float sd = fabsf(dd[ax]) > 1e-20f ? dd[ax] : 1e-20f;
    const float tn = (gm.pmin[ax] - oo[ax]) / sd;
    const float tf = (gm.pmax[ax] - oo[ax]) / sd;
    const float lo = mn(tn, tf), hi = mx(tn, tf);
    t0 = ax == 0 ? lo : mx(t0, lo);
    t1 = ax == 0 ? hi : mn(t1, hi);
  }
  t0 = mx(t0, 0.0f);
}

__device__ __forceinline__ bool slab_hit(const GridMedium& gm, V3 o, V3 d,
                                         float tfar) {
  float t0, t1;
  slab(gm, o, d, t0, t1);
  return t0 <= mn(t1, tfar);
}

// volpath_grid_kernel._svox_segment: one DDA step over the supervoxel
// majorant grid with the empty skip. sv: the (2, R) table in shared memory.
__device__ __forceinline__ void svox_segment(const GridMedium& gm,
                                             const float* sv, V3 o, V3 d,
                                             float t_cur, float t_hit,
                                             float& maj, float& t_end) {
  float t0, t1;
  slab(gm, o, d, t0, t1);
  const float span = mx(t1 - t0, 1e-20f);
  const float tq = t_cur + 1e-5f * span;
  const float oo[3] = {o.x, o.y, o.z}, dd[3] = {d.x, d.y, d.z};
  float sd[3], clo[3], chi[3], ext[3];
  int cell[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    sd[ax] = fabsf(dd[ax]) > 1e-20f ? dd[ax] : 1e-20f;
    ext[ax] = gm.pmax[ax] - gm.pmin[ax];
    const float pn = (oo[ax] + dd[ax] * tq - gm.pmin[ax]) / mx(ext[ax], 1e-20f);
    const float g = (float)gm.gres[ax];
    const float f = pn * g;
    // the plain form's int64 cast, clamped: out-of-range and NaN values
    // only reach the outside cases, where the cell is unused
    long long c = f == f && fabsf(f) < 1e18f ? (long long)f : 0;
    c = c < 0 ? 0 : (c > gm.gres[ax] - 1 ? gm.gres[ax] - 1 : c);
    cell[ax] = (int)c;
    const float cf = (float)c;
    clo[ax] = gm.pmin[ax] + cf / g * ext[ax];
    chi[ax] = gm.pmin[ax] + (cf + 1.0f) / g * ext[ax];
  }
  int idx = (cell[2] * gm.gres[1] + cell[1]) * gm.gres[0] + cell[0];
  idx = idx < 0 ? 0 : (idx > gm.rows - 1 ? gm.rows - 1 : idx);
  const float maj_cell = sv[idx];
  const float skip = sv[gm.rows + idx];
  float t_exit = 0.0f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float ex = mx(skip - 1.0f, 0.0f) / (float)gm.gres[ax] * ext[ax];
    const float tcn = (clo[ax] - ex - oo[ax]) / sd[ax];
    const float tcf = (chi[ax] + ex - oo[ax]) / sd[ax];
    const float hi = mx(tcn, tcf);
    t_exit = ax == 0 ? hi : mn(t_exit, hi);
  }
  const bool before = t_cur < t0;
  const bool after = t_cur >= t1;
  maj = (before || after || t0 > t1) ? 0.0f : maj_cell;
  const float te = (before && t0 <= t1) ? t0
                   : ((after || t0 > t1) ? lj::inf_f() : mx(t_exit, tq));
  t_end = mn(te, t_hit);
}

// volpath_grid_kernel._density: trilinear mono density at p, 0 outside.
__device__ __forceinline__ float density(const GridMedium& gm,
                                         const float* __restrict__ grid,
                                         V3 p) {
  const float pp[3] = {p.x, p.y, p.z};
  bool inside = true;
  int lo[3], hi[3];
  float fr[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const int nax = gm.res[ax];
    const float pn = (pp[ax] - gm.pmin[ax]) /
                     mx(gm.pmax[ax] - gm.pmin[ax], 1e-20f);
    inside = inside && pn >= 0.0f && pn <= 1.0f;
    const float f = pn * (float)(nax - 1);
    long long c = f == f && fabsf(f) < 1e18f ? (long long)f : 0;
    c = c < 0 ? 0 : (c > nax - 1 ? nax - 1 : c);
    lo[ax] = (int)c;
    fr[ax] = f - (float)c;
    hi[ax] = lo[ax] + 1 > nax - 1 ? nax - 1 : lo[ax] + 1;
  }
  if (!inside) return 0.0f;
  const int X = gm.res[0], Y = gm.res[1];
  auto at = [&](int z, int y, int x) {
    return __ldg(grid + (long long)(z * Y + y) * X + x);
  };
  auto along_x = [&](int z, int y) {
    return at(z, y, lo[0]) * (1.0f - fr[0]) + at(z, y, hi[0]) * fr[0];
  };
  auto along_y = [&](int z) {
    return along_x(z, lo[1]) * (1.0f - fr[1]) + along_x(z, hi[1]) * fr[1];
  };
  const float val = along_y(lo[2]) * (1.0f - fr[2]) + along_y(hi[2]) * fr[2];
  return mx(val, 0.0f);
}

// The carried state of one free flight (main or shadow segment).
struct Flight {
  float t, tr, dp, np;
  int it;
  bool sc, dn;
};

// volpath_grid_kernel._ff_micro: one mono delta (wsc) / ratio tracking
// step of a live flight; rho latches the density at the accepted real
// collision.
__device__ __forceinline__ void ff_micro(const GridMedium& gm,
                                         const float* sv,
                                         const float* __restrict__ grid,
                                         uint32_t it0, bool wsc, V3 o, V3 d,
                                         float t_hit, uint32_t hs, Flight& f,
                                         float& rho_sc) {
  float maj, t_end;
  svox_segment(gm, sv, o, d, f.t, t_hit, maj, t_end);
  const float u0 = lj::u_it(hs, (uint32_t)f.it, 0u, it0);
  const float u1 = lj::u_it(hs, (uint32_t)f.it, 1u, it0);
  const float t = maj > 0.0f ? -logf(mx(1.0f - u0, 1e-20f)) / mx(maj, 1e-20f)
                             : lj::inf_f();
  const float dt = t_end - f.t;
  const float t_next = mn(f.t + t, t_end);
  const bool in_flight = t < dt;
  const bool hit_end = !in_flight && t_end >= t_hit;
  const float rho = density(gm, grid, v3(o.x + d.x * t_next, o.y + d.y * t_next,
                                         o.z + d.z * t_next));
  const float maxden = mx(maj, 1e-20f);
  const float sigma_n = maj * (1.0f - rho / maxden);
  const float real_prob = rho / maxden;
  const float att = expf(-maj * mn(t, 1e30f));
  const float att_dt = expf(-maj * mn(dt, 1e30f));
  const bool is_real = wsc && u1 < real_prob;
  float tr, dp, np;
  if (in_flight) {
    tr = is_real ? f.tr * att / maxden : f.tr * att * sigma_n / maxden;
    dp = is_real ? f.dp * att * maj * real_prob / maxden
                 : f.dp * att * maj * (1.0f - real_prob) / maxden;
    np = is_real ? f.np : f.np * att * maj / maxden;
  } else {
    tr = f.tr * att_dt;
    dp = f.dp * att_dt;
    np = f.np * att_dt;
  }
  const bool sc = f.sc || (in_flight && is_real);
  const bool dn = f.dn || hit_end || (in_flight && is_real) ||
                  (!wsc && tr <= 0.0f) || f.it + 1 >= gm.max_null;
  if (sc && !f.sc) rho_sc = rho;
  f.t = t_next;
  f.it += 1;
  f.tr = tr;
  f.dp = dp;
  f.np = np;
  f.sc = sc;
  f.dn = dn;
}

// A flight from scratch: reset, and the trivial test (the event machine's
// entry); ff_micro then steps it while !f.dn && f.it < max_null.
__device__ __forceinline__ void flight_start(bool trivial, Flight& f) {
  f.t = 0.0f;
  f.it = 0;
  f.tr = f.dp = f.np = 1.0f;
  f.sc = false;
  f.dn = trivial;
}

// A cast's hit with the record fields K9 reads: hit point, shading frame,
// emission, material, the interface's media.
struct Hit {
  lj::Surf s;
  lj::Shade h;
  V3 p;
  bool valid, mat_ok;
  int int_med, ext_med;
};

// The Hit of the cast of (o, d) whose scan is h0.
template <bool SPH>
__device__ __forceinline__ void hit_of(const lj::Tables& tb,
                                       const lj::HitScan& h0, V3 o, V3 d,
                                       Hit& r) {
  const int T = tb.t;
  lj::surf_of(tb, h0, r.s);
  r.valid = r.s.t < lj::inf_f();
  r.p = v3(o.x + r.s.t * d.x, o.y + r.s.t * d.y, o.z + r.s.t * d.z);
  lj::shade<SPH>(r.s, r.p, r.h);
  auto row = [&](int k) {
    return r.s.found ? __ldg(tb.tri + k * T + r.s.prim) : 0.0f;
  };
  float mat = row(34), im = row(35), em = row(36);
  if (SPH && r.s.sph_win) {
    mat = r.s.srow[18];
    im = r.s.srow[19];
    em = r.s.srow[20];
  }
  r.mat_ok = mat > 0.0f;
  r.int_med = (int)im;
  r.ext_med = (int)em;
}

// The medium across the hit's interface, or `cur` where both sides agree.
__device__ __forceinline__ int cross_medium(const Hit& r, V3 d, int cur) {
  if (r.int_med == r.ext_med) return cur;
  return lj::dot3(d, r.h.ng) > 0.0f ? r.ext_med : r.int_med;
}

__device__ __forceinline__ float hg_row(const GridMedium& gm, float c) {
  const float t = mx(gm.hg_c + gm.hg_d * c, 1e-20f);
  return gm.hg_num / mx(t * sqrtf(t), 1e-20f);
}

// K9: persistent warps over the items s0*n_q .. s0*n_q + total - 1; out is
// the (total, 3) radiance of each item of a film lane, in item order.
template <int MATS, bool QUADS, bool SPH, bool HG>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
render_fused_grid_kernel(lj::Tables tb, Camera cam, GridMedium gm,
                         VolSalts salt, const float* __restrict__ svox,
                         const float* __restrict__ grid, int n, int w,
                         long long n_q, uint32_t su, long long s0,
                         long long total,
                         unsigned long long* __restrict__ counter,
                         float* __restrict__ out,
                         unsigned long long* __restrict__ stats) {
  using namespace lj;
  __shared__ float sv[2 * kMaxSvoxRows];
  __shared__ SimtCounts<kWarps, kStats> cnt;
  for (int i = threadIdx.x; i < 2 * gm.rows; i += blockDim.x)
    sv[i] = __ldg(svox + i);
  __syncthreads();
  cnt.zero(stats);
  const float eps_s = tb.eps_shadow;
  const V3 alb = v3(gm.albedo[0], gm.albedo[1], gm.albedo[2]);
  const V3 zero3 = v3(0.0f, 0.0f, 0.0f);
  int stage = kFetch;
  bool shadow = false;      // the cast / flight is a shadow segment
  bool drained = false;     // the counter has passed the last item (warp)
  long long c = 0;          // the lane's item, as its row of out
  // the path
  V3 org = zero3, d = zero3, T = zero3, L = zero3, nee_p = zero3;
  float dir_pdf = 0.0f, mtp = 0.0f;
  float rho_sc = 0.0f;      // the latched density (ff_rho)
  int med = 0, bounces = 0;
  // the free flight: its state, hash root, end and whether it may scatter
  Flight f;
  flight_start(true, f);
  uint32_t f_hs = 0u;
  float f_thit = 0.0f;
  bool f_wsc = false;
  HitScan hm0;              // the scan of the main ray's closest hit
  hm0.t = hm0.ub = hm0.vb = 0.0f;
  hm0.prim = 0;
  hm0.sph = -1;
  hm0.found = false;
  // the shadow chain: segment origin, medium, products, index; the light
  // point and direction, the NEE hash root and the completion's factors
  V3 sh_p = zero3, lp = zero3, dl = zero3, cb = zero3, tsc = zero3;
  int sh_med = 0, seg = 0, sg_mednext = 0;
  float sh_T = 1.0f, sh_pn = 1.0f, sh_pd = 1.0f, pdfb = 0.0f, pdfd = 0.0f;
  uint32_t nb_hs = 0u;
  bool v_active = false, sg_valid = false, sg_blocked = false;

  for (;;) {
    // ---- fetch: lanes without a path take the next items
    if (!drained) {
      long long mine = 0;
      const long long next = fetch_items(counter, stage == kFetch, mine);
      if (stage == kFetch && next >= 0 && mine < total) {
        const long long k = mine % n_q;      // the pool's lane (s0*n_q % n_q == 0)
        if (k < n) {                         // padding lanes are skipped
          c = mine;
          primary(cam, su, s0 * n_q + c, (float)(k % w), (float)(k / w), org,
                  d);
          med = gm.cam_med;
          T = v3(1.0f, 1.0f, 1.0f);
          L = zero3;
          dir_pdf = 0.0f;
          mtp = 1.0f;
          nee_p = org;
          rho_sc = 0.0f;
          bounces = 0;
          shadow = false;
          stage = kCast;
        }
      }
      drained = next >= total;
    }
    const bool live = stage != kFetch;
    if (__ballot_sync(kFullMask, live) == 0u) {
      if (drained) break;
      continue;
    }
    cnt.pass(stats, 0, live);

    // ---- a cast: the main ray, or shadow segment `seg` toward the light
    // point; then the flight's start
    long long t0 = cnt.stamp(stats);
    cnt.pass(stats, 2, stage == kCast);
    if (stage == kCast) {
      const long long item = s0 * n_q + c;
      if (!shadow) {
        const uint32_t hb = pcg_hash((uint32_t)item ^ pcg_hash((uint32_t)bounces ^ su));
        closest_scan<QUADS, SPH, true>(tb, org, d, tb.eps_isect, 1e30f, hm0);
        const bool valid = hm0.t < inf_f();
        f_thit = valid ? hm0.t : inf_f();
        f_wsc = med >= 0;
        f_hs = pcg_hash(hb + salt.ff);
        flight_start(med < 0 || !slab_hit(gm, org, d, f_thit) ||
                         gm.maxval <= 0.0f,
                     f);
      } else {
        const float lx = lp.x - sh_p.x, ly = lp.y - sh_p.y, lz = lp.z - sh_p.z;
        const float dist_l = sqrtf(mx(lx * lx + ly * ly + lz * lz, 1e-20f));
        HitScan h0;
        closest_scan<QUADS, SPH, true>(tb, sh_p, dl, eps_s,
                                       tb.shadow_far_scale * dist_l, h0);
        Hit hs;
        hit_of<SPH>(tb, h0, sh_p, dl, hs);
        const float sg_t = hs.valid ? hs.s.t : dist_l;
        const bool sg_opaque = hs.valid && hs.mat_ok;
        const bool sg_dblock = tb.max_depth != -1 && hs.valid &&
                               (bounces - 1 + seg + 1) >= tb.max_depth;
        sg_mednext = cross_medium(hs, dl, sh_med);
        sg_valid = hs.valid;
        sg_blocked = sg_opaque || sg_dblock;
        f_thit = sg_t;
        f_wsc = false;
        f_hs = pcg_hash(nb_hs ^ pcg_hash((uint32_t)seg + salt.nee_seg));
        flight_start(sh_med < 0 || !slab_hit(gm, sh_p, dl, sg_t) ||
                         gm.maxval <= 0.0f,
                     f);
      }
      stage = kTrack;
    }
    cnt.cycles(stats, 8, t0);

    // ---- one tracking step of the flight; at its end (at once for a
    // trivial flight) the vertex, or the segment's end: the next segment,
    // or the NEE completion
    t0 = cnt.stamp(stats);
    cnt.pass(stats, 4, stage == kTrack && !f.dn && f.it < gm.max_null);
    if (stage == kTrack) {
      if (!f.dn && f.it < gm.max_null)
        ff_micro(gm, sv, grid, salt.it0, f_wsc, shadow ? sh_p : org,
                 shadow ? dl : d, f_thit, f_hs, f, rho_sc);
      if (f.dn || f.it >= gm.max_null) {
        if (!shadow) {
          stage = kVertex;
        } else {
          if (sh_med >= 0) {
            sh_T = sh_T * f.tr;
            sh_pn = sh_pn * f.np;
            sh_pd = sh_pd * f.dp;
          }
          const bool cont = sg_valid && !sg_blocked && seg + 1 < gm.max_segments;
          if (cont) {
            sh_med = sg_mednext;
            sh_p = v3(sh_p.x + f_thit * dl.x, sh_p.y + f_thit * dl.y,
                      sh_p.z + f_thit * dl.z);
            seg += 1;
            stage = kCast;
          } else {
            // NEE completion
            const bool ok = !sg_blocked && sh_T > 0.0f;
            const float pdf_nee = pdfb * sh_pn;
            const float ipn = mx(pdf_nee, 1e-30f);
            const float pdf_dir = pdfd * sh_pd;
            const float wmis = (pdf_nee * pdf_nee) /
                               mx(pdf_nee * pdf_nee + pdf_dir * pdf_dir, 1e-30f);
            const V3 nee_out = ok ? v3(sh_T * cb.x / ipn * wmis,
                                       sh_T * cb.y / ipn * wmis,
                                       sh_T * cb.z / ipn * wmis)
                                  : zero3;
            L = v3(L.x + tsc.x * nee_out.x, L.y + tsc.y * nee_out.y,
                   L.z + tsc.z * nee_out.z);
            if (max3(nee_out) > 0.0f) nee_p = org;
            shadow = false;
            stage = v_active && bounces < tb.max_cap ? kCast : kFetch;
          }
        }
      }
    }
    cnt.cycles(stats, 9, t0);

    // ---- the vertex
    t0 = cnt.stamp(stats);
    cnt.pass(stats, 6, stage == kVertex);
    if (stage == kVertex) {
      const uint32_t hb = pcg_hash((uint32_t)(s0 * n_q + c) ^
                                   pcg_hash((uint32_t)bounces ^ su));
      const bool in_medium = med >= 0;
      Hit hm;
      hit_of<SPH>(tb, hm0, org, d, hm);
      const bool valid = hm.valid;
      const float trans = in_medium ? f.tr : 1.0f;
      const float tdp = in_medium ? f.dp : 1.0f;
      const float tnp_v = in_medium ? f.np : 1.0f;
      const bool scatter = f.sc && in_medium;
      const float mtp_v = in_medium ? mtp * tdp : mtp;
      bool active = true;
      if (!in_medium && !valid) {       // vacuum miss: the path's radiance goes
        L = zero3;
        active = false;
      }
      const V3 new_org = scatter ? v3(org.x + d.x * f.t, org.y + d.y * f.t,
                                      org.z + d.z * f.t)
                                 : (valid ? hm.p : org);
      const float rt = trans / mx(tdp, 1e-30f);
      const V3 T_v = v3(T.x * rt, T.y * rt, T.z * rt);
      const V3 wi = neg(d);
      const V3 ng = hm.h.ng;

      // emission + MIS against the cached NEE origin
      const bool hit_light = active && !scatter && valid && hm.h.h_light >= 0.0f;
      const V3 le = dot3(ng, wi) > 0.0f ? hm.h.le : zero3;
      const float dpx = hm.p.x - nee_p.x, dpy = hm.p.y - nee_p.y,
                  dpz = hm.p.z - nee_p.z;
      const float dist2p = mx(dpx * dpx + dpy * dpy + dpz * dpz, 1e-20f);
      const float jac_e = mx(dot3(d, ng), 0.0f) / dist2p;
      float p1e = hm.h.h_pmf * hm.h.inv_area * tnp_v;
      if (SPH && hm.s.sph_win)
        p1e = hm.h.h_pmf * cone_pdf_area(hm.h.sc, hm.h.sr, nee_p, ng, d, dist2p) *
              tnp_v;
      const float p2e = dir_pdf * mtp_v * jac_e;
      float w_l = (p2e * p2e) / mx(p2e * p2e + p1e * p1e, 1e-30f);
      const bool first = bounces == 0;
      if (first) w_l = 1.0f;
      const float add = hit_light ? w_l : 0.0f;
      L = v3(L.x + T_v.x * le.x * add, L.y + T_v.y * le.y * add,
             L.z + T_v.z * le.z * add);
      active = active && !(hit_light && first);

      // pass-through and the depth limit
      const bool pass_through = active && !scatter && valid && !hm.mat_ok;
      const bool depth_stop = tb.max_depth != -1 && bounces >= tb.max_depth - 1;
      const bool active_work = active && !pass_through && !depth_stop;
      active = active && !(depth_stop && !pass_through);
      active = active && (scatter || valid);
      const bool do_scatter = active_work && scatter;
      const bool do_surface = active_work && !scatter && valid;
      const V3 sigma_s = v3(alb.x * rho_sc, alb.y * rho_sc, alb.z * rho_sc);

      // phase sampling
      const uint32_t hph = pcg_hash(hb + salt.phase);
      const float up0 = u_dim(hph, 0), up1 = u_dim(hph, 1);
      const float zp = 1.0f - 2.0f * up0;
      const float rp = sqrtf(mx(1.0f - zp * zp, 0.0f));
      const float php = kTwoPi * up1;
      V3 pdir = v3(rp * cosf(php), rp * sinf(php), zp);
      float ph_pdf = kInv4Pi;
      V3 thr_sc;
      if (HG && gm.hg_sample) {
        const float tmp = gm.hg_a / (2.0f * up0 * gm.g - gm.hg_b);
        const float cos_el = (tmp * tmp - gm.hg_c) / gm.hg_d;
        const float sin_el = sqrtf(mx(1.0f - cos_el * cos_el, 0.0f));
        const float az = kTwoPi * up1;
        V3 pt, pb;
        onb(wi, pt, pb);
        const float sc_ = sin_el * cosf(az), ssn = sin_el * sinf(az);
        pdir = v3(sc_ * pt.x + ssn * pb.x + cos_el * wi.x,
                  sc_ * pt.y + ssn * pb.y + cos_el * wi.y,
                  sc_ * pt.z + ssn * pb.z + cos_el * wi.z);
        ph_pdf = hg_row(gm, dot3(wi, pdir));
      }
      if (HG) {
        const float r = ph_pdf / mx(ph_pdf, 1e-30f);
        thr_sc = v3(T_v.x * r * sigma_s.x, T_v.y * r * sigma_s.y,
                    T_v.z * r * sigma_s.z);
      } else {
        thr_sc = v3(T_v.x * sigma_s.x, T_v.y * sigma_s.y, T_v.z * sigma_s.z);
      }

      // surface interaction (no transmissive material in the class)
      const V3 fn = dot3(hm.h.sn, wi) < 0.0f ? neg(hm.h.sn) : hm.h.sn;
      const uint32_t hbs = pcg_hash(hb + salt.bsdf);
      bool samp_valid;
      const V3 dir_out = sample_dir<MATS>(wi, fn, ng, hm.h.m, u_dim(hbs, 0),
                                          u_dim(hbs, 1), u_dim(hbs, 2),
                                          samp_valid);
      V3 f2;
      float p2s;
      eval_pdf<MATS>(wi, dir_out, fn, ng, hm.h.m, f2, p2s);
      active = active && !(do_surface && !(samp_valid && p2s > 0.0f));
      const float ip2 = mx(p2s, 1e-30f);
      const V3 thr_sf = v3(T_v.x * f2.x / ip2, T_v.y * f2.y / ip2,
                           T_v.z * f2.z / ip2);

      // NEE set-up: light pick, point and the direction-independent
      // factors, for every lane as the plain form does (a K9 whose lanes
      // skip the samplers and this set-up whose results they drop
      // measured slower: PERF.md)
      const bool with_nee = do_scatter || do_surface;
      const uint32_t hb_eff = do_surface ? pcg_hash(hb + salt.surf_nee) : hb;
      const uint32_t nb_hs_v = pcg_hash(hb_eff + salt.nee);
      LightSample ls;
      sample_light<SPH>(tb, new_org, u_dim(nb_hs_v, 0), u_dim(nb_hs_v, 1),
                        u_dim(nb_hs_v, 2), u_dim(nb_hs_v, 3), ls);
      const float ln_dl = -dot3(ls.dl, ls.ln);
      const float jac_n = mx(ln_dl, 0.0f) / ls.dist2;
      const V3 le3 = ln_dl > 0.0f ? ls.l_int : zero3;
      V3 f_bs;
      float pdf_bs;
      eval_pdf<MATS>(wi, ls.dl, fn, ng, hm.h.m, f_bs, pdf_bs);
      const float ph_nee = (HG && gm.hg_sample) ? hg_row(gm, dot3(wi, ls.dl)) : kInv4Pi;
      const V3 f_sel = do_surface ? (pdf_bs > 0.0f ? f_bs : zero3)
                                  : v3(ph_nee, ph_nee, ph_nee);

      // merge the continuation
      V3 d_next = d;
      if (scatter && do_scatter) d_next = pdir;
      if (do_surface) d_next = dir_out;
      V3 T_n = do_scatter ? thr_sc : (do_surface ? thr_sf : T_v);
      const int medium_n = pass_through ? cross_medium(hm, d, med) : med;
      const float dir_pdf_n = do_scatter ? ph_pdf : dir_pdf;
      const float mtp_n = do_scatter ? 1.0f : mtp_v;

      // russian roulette (eta_scale is 1 in the class)
      const bool do_rr = bounces >= tb.rr_depth && active && !pass_through;
      const float rr_prob = do_rr ? mn(max3(T_n), 0.95f) : 1.0f;
      const float u_rr = u_dim(pcg_hash(hb + salt.rr), 0);
      active = active && !(do_rr && u_rr > rr_prob);
      if (do_rr) {
        const float q = mx(rr_prob, 1e-20f);
        T_n = v3(T_n.x / q, T_n.y / q, T_n.z / q);
      }

      // the shadow chain's start: segment 0 from the new origin in the
      // vertex's medium, toward the light point
      sh_p = new_org;
      sh_med = med;
      sh_T = sh_pn = sh_pd = 1.0f;
      seg = 0;
      lp = ls.lp;
      dl = ls.dl;
      nb_hs = nb_hs_v;
      cb = v3(f_sel.x * le3.x * jac_n, f_sel.y * le3.y * jac_n,
              f_sel.z * le3.z * jac_n);
      pdfb = ls.l_pmf * ls.p1_area;
      pdfd = (do_surface ? pdf_bs : ph_nee) * jac_n;
      tsc = do_scatter ? v3(T_v.x * sigma_s.x, T_v.y * sigma_s.y,
                            T_v.z * sigma_s.z)
                       : T_v;
      v_active = active;

      // apply the vertex
      org = new_org;
      d = d_next;
      T = T_n;
      med = medium_n;
      bounces += 1;
      dir_pdf = dir_pdf_n;
      mtp = mtp_n;
      shadow = with_nee;
      // without NEE: the next bounce (a pass-through) or the path's end
      stage = with_nee || active ? kCast : kFetch;
    }
    cnt.cycles(stats, 10, t0);

    if (live && stage == kFetch) {       // the path ended in this iteration
      float* o = out + 3 * c;
      o[0] = L.x;
      o[1] = L.y;
      o[2] = L.z;
    }
  }
  cnt.flush(stats);
}

// Calls f(M, Q, S, H) with the kernel specialisation as integral constants.
template <class F>
cudaError_t dispatch(int mats, int quads, int sph, int hg, F f) {
  auto by_hg = [&](auto M, auto Q, auto S) {
    return hg ? f(M, Q, S, std::true_type{}) : f(M, Q, S, std::false_type{});
  };
  auto by_sph = [&](auto M, auto Q) {
    return sph ? by_hg(M, Q, std::true_type{}) : by_hg(M, Q, std::false_type{});
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

}  // namespace

extern "C" {

// K9. mats: bit 0 Lambertian, bit 1 RoughPlastic; hg: the medium's phase
// is Henyey-Greenstein (else isotropic). svox: the (2, rows) supervoxel
// [majorant | empty-skip] table; grid: the (Z*Y, X) density; counter: one
// zeroed uint64; out: (nspp * n_q, 3), rows of lanes >= n not written;
// stats: kStats uint64 counters to add to, or null.
int lj_render_fused_grid(const lj::Tables* tb, const lj::Camera* cam,
                         const lj::GridMedium* gm, const lj::VolSalts* salt,
                         int mats, int quads, int sph, int hg,
                         const float* svox, const float* grid, int n, int w,
                         long long n_q, uint32_t su, long long s0, int nspp,
                         unsigned long long* counter,
                         float* out, unsigned long long* stats,
                         void* stream) {
  if (n <= 0 || nspp <= 0 || n_q < n || gm->rows < 1 ||
      gm->rows > lj::kMaxSvoxRows)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)nspp * n_q;
  cudaError_t e = dispatch(mats, quads, sph, hg, [&](auto M, auto Q, auto S,
                                                     auto H) {
    auto kernel = render_fused_grid_kernel<decltype(M)::value,
                                           decltype(Q)::value,
                                           decltype(S)::value,
                                           decltype(H)::value>;
    int blocks = 0;
    cudaError_t err = lj::persistent_blocks(kernel, kThreads, 0, total,
                                            blocks);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        *tb, *cam, *gm, *salt, svox, grid, n, w, n_q, su, s0, total,
        counter, out, stats);
    return cudaGetLastError();
  });
  return (int)e;
}

}  // extern "C"
