// Kernel K8: the fused volumetric path tracer for one uniform homogeneous
// medium, and film_sum_kernel, the ordered film sum of K1, K8 and K9,
// with a plain C interface for ctypes (lajolla_tpu_torch/kernels.py builds
// this file with nvcc for sm_90a and binds it).
//
// Replaces lajolla_tpu's Pallas kernel
// lajolla_tpu/integrators/volpath_kernel.py `_kernel` (launched by
// `render_fused_vol`, per-bounce body `_advance_vol_core`): nspp samples
// of every pixel in one launch, for scenes inside
// volpath_kernel.supports — one homogeneous medium bound to the camera
// and every exterior, opaque Lambertian / RoughPlastic surfaces. Its
// plain PyTorch form is lajolla_tpu_torch/integrators/volpath_kernel.py
// `render_fused_vol_plain` / `_advance_vol_core`.
//
// The TPU kernel advances a (row, 4096) block of lanes in lockstep and
// fetches records by one-hot matmuls. Here persistent warps fill the card
// (work_queue.cuh): each lane runs one flat loop, one path vertex
// (`advance_vol`) an iteration; when its path ends it writes the item's
// radiance to out[item - s0*n] and, at the top of the next iteration,
// takes the next work item from a device counter (one atomicAdd a warp for
// all its lanes that ask). Items go out in id order s0*n .. (s0+nspp)*n -
// 1, pixel = item mod n, so no lane waits at the end of a sample for the
// longest path of its warp; only the queue's tail does. film_sum_kernel
// then adds each pixel's samples in sample order, as the per-pixel loop of
// the plain form does, so the film does not depend on which thread ran a
// path or when. Records are indexed loads; the casts, BSDFs, light
// sampling and camera are K1's (path_advance.cuh, camera.cuh).
//
// What bounds it: per-thread ALU work (two cast scans over the cast and
// occluder tables per vertex, the BSDF evaluated twice), the latency of
// the per-lane record reads and of the spilled lane state, which many
// warps an SM hide (kMinBlocks), and divergence inside a vertex (scatter
// / surface branches, the any-hit scan's early exit). As in K1, each block
// copies the rows of the warp-uniform scans into its shared memory once
// (lj::stage_rows: 2,192 B for 'vol') and reads four broadcast 16-byte
// loads a prim in place of 13 scalar loads. Against those loads on the
// H100: 'vol''s last 64-spp launch 30.76 -> 27.80 ms (0.904x), the mesh
// box in its medium at 179 cast prims 0.81x (PERF.md). The per-item
// buffer is one 12-byte store an item, read once by film_sum_kernel.
//
// Every random number is the counter hash of the plain form: the
// per-bounce root hb = pcg(item ^ pcg(bounces ^ su)) with su =
// pcg(seed ^ 0x701A77E5) passed pre-hashed, and the draw-site salts of
// integrators/volpath.py, passed in VolSalts. The HG lobe's 1.5 power is
// t * sqrtf(t), as lajolla_tpu's kernel writes it.
//
// The entries return cudaGetLastError() after their launch; the kernels
// launch on the caller's stream and do not synchronise.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "camera.cuh"
#include "path_advance.cuh"
#include "volpath_common.cuh"
#include "work_queue.cuh"

namespace lj {

// The class's one medium: sigma_a, sigma_s and the HG asymmetry g.
struct Medium {
  float sa[3], ss[3], g;
};

}  // namespace lj

namespace {

using lj::Camera;
using lj::max3;
using lj::Medium;
using lj::u_dim;
using lj::V3;
using lj::VolSalts;

constexpr int kThreads = 128;
// At least 8 blocks an SM: at most 64 registers a thread, ~206 B of the
// lane's state spilled to local memory (L1-resident); 32 warps an SM beat
// 20 with no spills (96 registers) by 1.07-1.10x
// (tools/tune_torch_vol_schedule.py, PERF.md).
constexpr int kMinBlocks = 8;
constexpr int kWarps = kThreads / 32;
// SIMT counter slots: loop iterations of a warp with a path in some lane,
// and those lanes (one vertex each); fetches, and the lanes they served.
constexpr int kStats = 4;

__device__ __forceinline__ float comp(V3 v, int ch) {
  return ch == 0 ? v.x : (ch == 1 ? v.y : v.z);
}

__device__ __forceinline__ int channel(float u) {
  return min(max((int)(u * 3.0f), 0), 2);
}

__device__ __forceinline__ float hg_lobe(float g, float c) {
  float t = lj::mx(1.0f + g * g + 2.0f * g * c, 1e-20f);
  return lj::kInv4Pi * (1.0f - g * g) / lj::mx(t * sqrtf(t), 1e-20f);
}

// Path state of one lane.
struct VolLane {
  V3 o, d, thr, rad, mtp, nee_p;
  float dir_pdf;
};

// One bounce of the final integrator (volpath_kernel._advance_vol_core).
// hb is the (item, bounce) stream root. Returns alive; st holds the next
// origin, direction, throughput, radiance, pdfs and NEE origin. The
// scans read the block's copy of their rows (lj::stage_rows).
template <int MATS, bool QUADS, bool SPH, bool HG>
__device__ __forceinline__ bool advance_vol(const lj::Tables& tb,
                                            const Medium& med,
                                            const VolSalts& salt,
                                            VolLane& st, int bounces,
                                            uint32_t hb) {
  using namespace lj;
  const V3 o = st.o, d = st.d;
  const V3 sa = v3(med.sa[0], med.sa[1], med.sa[2]);
  const V3 ss = v3(med.ss[0], med.ss[1], med.ss[2]);
  const V3 stt = v3(sa.x + ss.x, sa.y + ss.y, sa.z + ss.z);   // sigma_t
  const float max_maj = mx(max3(stt), 1e-20f);

  // ---- closest hit
  Surf s;
  closest_hit<QUADS, SPH, 1, true>(tb, o, d, s);
  const bool valid = s.t < inf_f();

  // ---- closed-form free flight: one tracking step
  const uint32_t hs_ff = pcg_hash(hb + salt.ff);
  const float st_ch = comp(stt, channel(u_dim(hs_ff, 0)));
  const bool guard = st_ch > 0.0f;
  const uint32_t hsi = pcg_hash(hs_ff ^ pcg_hash(salt.it0));
  const float u0 = u_dim(hsi, 1), u1 = u_dim(hsi, 2);
  const float t_s = guard ? -logf(mx(1.0f - u0, 1e-20f)) / mx(st_ch, 1e-20f)
                          : inf_f();
  const bool in_flight = t_s < s.t;
  const float real_ch = st_ch / mx(st_ch, 1e-20f);
  const bool scatter = guard && in_flight && u1 < real_ch;
  const float t_cl = mn(in_flight ? t_s : s.t, 1e30f);
  const V3 att = v3(expf(-stt.x * t_cl), expf(-stt.y * t_cl),
                    expf(-stt.z * t_cl));
  V3 trans = v3(1.0f, 1.0f, 1.0f), tdp = trans;
  if (guard) {
    trans = in_flight ? v3(att.x / max_maj, att.y / max_maj, att.z / max_maj)
                      : att;
    tdp = in_flight ? v3(att.x * stt.x * real_ch / max_maj,
                         att.y * stt.y * real_ch / max_maj,
                         att.z * stt.z * real_ch / max_maj)
                    : att;
  }
  const V3 mtp = v3(st.mtp.x * tdp.x, st.mtp.y * tdp.y, st.mtp.z * tdp.z);
  const float t_adv = scatter ? t_cl : (valid ? s.t : 0.0f);
  const V3 p = v3(o.x + t_adv * d.x, o.y + t_adv * d.y, o.z + t_adv * d.z);
  const float avg_tdp = mx((tdp.x + tdp.y + tdp.z) / 3.0f, 1e-30f);
  const V3 thr = v3(st.thr.x * trans.x / avg_tdp, st.thr.y * trans.y / avg_tdp,
                    st.thr.z * trans.z / avg_tdp);

  Shade h;
  shade<SPH>(s, p, h);
  const V3 ng = h.ng;
  const V3 wi = neg(d);

  // ---- emissive hit + MIS with the cached NEE-origin pdf
  const bool first = bounces == 0;
  const bool hit_light = !scatter && valid && h.h_light >= 0.0f;
  const V3 le = dot3(ng, wi) > 0.0f ? h.le : v3(0.0f, 0.0f, 0.0f);
  const V3 np = st.nee_p;
  float dpx = p.x - np.x, dpy = p.y - np.y, dpz = p.z - np.z;
  float dist2p = mx(dpx * dpx + dpy * dpy + dpz * dpz, 1e-20f);
  float jac_e = mx(dot3(d, ng), 0.0f) / dist2p;
  float p1e = h.h_pmf * h.inv_area;
  if (SPH && s.sph_win) p1e = h.h_pmf * cone_pdf_area(h.sc, h.sr, np, ng, d, dist2p);
  auto add = [&](float mt) {   // the channel's MIS weight, 0 off a light
    if (!hit_light) return 0.0f;
    if (first) return 1.0f;
    float p2e = st.dir_pdf * mt * jac_e;
    return (p2e * p2e) / mx(p2e * p2e + p1e * p1e, 1e-30f);
  };
  V3 rad = v3(st.rad.x + thr.x * le.x * add(mtp.x),
              st.rad.y + thr.y * le.y * add(mtp.y),
              st.rad.z + thr.z * le.z * add(mtp.z));
  bool active = !(hit_light && first);   // fork quirk: bounce 0 returns

  bool active_work = active;
  if (tb.max_depth != -1 && bounces >= tb.max_depth - 1) {
    active_work = false;
    active = false;
  }
  active = active && (scatter || valid);
  const bool do_scatter = active_work && scatter;
  const bool do_surface = active_work && !scatter && valid;

  // ---- merged NEE: one shadow segment, analytic transmittance. A scatter
  // and a surface take it; a path that ends here skips it, and each
  // sampler below, whose results it would drop (the plain form computes
  // them for every lane)
  const V3 fn = dot3(h.sn, wi) < 0.0f ? neg(h.sn) : h.sn;
  bool nee_hit = false;     // the NEE contribution is positive
  if (do_scatter || do_surface) {
    const uint32_t hb_eff = do_surface ? pcg_hash(hb + salt.surf_nee) : hb;
    const uint32_t hs_n = pcg_hash(hb_eff + salt.nee);
    LightSample ls;
    sample_light<SPH, true>(tb, p, u_dim(hs_n, 0), u_dim(hs_n, 1),
                            u_dim(hs_n, 2), u_dim(hs_n, 3), ls);
    const V3 dl = ls.dl;
    const bool occ = occluded_any<QUADS, SPH, 1, true>(
        tb, p, dl, tb.shadow_far_scale * ls.dist);
    // the segment's NEE free flight reaches its end with trans = pd =
    // exp(-sigma_t dist), pn = 1, unless its sampled channel has sigma_t 0
    const uint32_t hseg = pcg_hash(hs_n ^ pcg_hash(salt.nee_seg));
    const bool seg_guard = comp(stt, channel(u_dim(hseg, 0))) > 0.0f;
    const V3 Tl = seg_guard ? v3(expf(-stt.x * ls.dist), expf(-stt.y * ls.dist),
                                 expf(-stt.z * ls.dist))
                            : v3(1.0f, 1.0f, 1.0f);
    bool ok = !occ && max3(Tl) > 0.0f;
    const float ln_dl = -dot3(dl, ls.ln);
    const float jac = mx(ln_dl, 0.0f) / ls.dist2;
    const float pdf_nee = ls.l_pmf * ls.p1_area;
    V3 f3;
    float pdf_dir_sa;
    if (do_surface) {
      eval_pdf<MATS>(wi, dl, fn, ng, h.m, f3, pdf_dir_sa);
      ok = ok && pdf_dir_sa > 0.0f;
    } else {
      // f == pdf for both phases: 1/4pi, or the HG lobe at dot(wi, dl)
      pdf_dir_sa = HG ? hg_lobe(med.g, dot3(wi, dl)) : kInv4Pi;
      f3 = v3(pdf_dir_sa, pdf_dir_sa, pdf_dir_sa);
    }
    pdf_dir_sa = pdf_dir_sa * jac;
    const V3 le3 = ln_dl > 0.0f ? ls.l_int : v3(0.0f, 0.0f, 0.0f);  // one-sided
    const float avg_nee = mx((pdf_nee + pdf_nee + pdf_nee) / 3.0f, 1e-30f);
    auto nee = [&](float tl, float f, float l) {
      float pd = pdf_dir_sa * tl;
      float w = (pdf_nee * pdf_nee) / mx(pdf_nee * pdf_nee + pd * pd, 1e-30f);
      return ok ? tl * f * l * jac / avg_nee * w : 0.0f;
    };
    const V3 nee_m = v3(nee(Tl.x, f3.x, le3.x), nee(Tl.y, f3.y, le3.y),
                        nee(Tl.z, f3.z, le3.z));
    if (do_scatter)
      rad = v3(rad.x + thr.x * ss.x * nee_m.x, rad.y + thr.y * ss.y * nee_m.y,
               rad.z + thr.z * ss.z * nee_m.z);
    else
      rad = v3(rad.x + thr.x * nee_m.x, rad.y + thr.y * nee_m.y,
               rad.z + thr.z * nee_m.z);
    nee_hit = max3(nee_m) > 0.0f;
  }

  // ---- the NEE cache, then the continuation: a scatter samples the phase
  // function (uniform sphere, or the HG inverse CDF around wi), a surface
  // its BSDF
  st.nee_p = nee_hit ? p : st.nee_p;
  st.o = p;
  st.rad = rad;
  st.mtp = mtp;
  V3 thr_n = thr;
  if (do_scatter) {
    const uint32_t hph = pcg_hash(hb + salt.phase);
    const float up0 = u_dim(hph, 0), up1 = u_dim(hph, 1);
    const float zp = 1.0f - 2.0f * up0;
    const float rp = sqrtf(mx(1.0f - zp * zp, 0.0f));
    const float php = kTwoPi * up1;
    V3 pdir = v3(rp * cosf(php), rp * sinf(php), zp);
    float ph_pdf = kInv4Pi;
    thr_n = v3(thr.x * ss.x, thr.y * ss.y, thr.z * ss.z);
    if (HG) {
      const float g = med.g;
      const float g_safe = fabsf(g) < 1e-3f ? 1.0f : g;
      const float tmp = (g_safe * g_safe - 1.0f) / (2.0f * up0 * g_safe - (g_safe + 1.0f));
      const float cos_el = (tmp * tmp - (1.0f + g_safe * g_safe)) / (2.0f * g_safe);
      const float sin_el = sqrtf(mx(1.0f - cos_el * cos_el, 0.0f));
      const float az = kTwoPi * up1;
      V3 pt, pb;
      onb(wi, pt, pb);
      const float sc = sin_el * cosf(az), ssn = sin_el * sinf(az);
      if (!(fabsf(g) < 1e-3f))
        pdir = v3(sc * pt.x + ssn * pb.x + cos_el * wi.x,
                  sc * pt.y + ssn * pb.y + cos_el * wi.y,
                  sc * pt.z + ssn * pb.z + cos_el * wi.z);
      ph_pdf = hg_lobe(g, dot3(wi, pdir));
      const float r = ph_pdf / mx(ph_pdf, 1e-30f);
      thr_n = v3(thr.x * r * ss.x, thr.y * r * ss.y, thr.z * r * ss.z);
    }
    st.d = pdir;
    st.dir_pdf = ph_pdf;
    st.mtp = v3(1.0f, 1.0f, 1.0f);
  } else if (do_surface) {
    const uint32_t hbs = pcg_hash(hb + salt.bsdf);
    bool samp_valid;
    const V3 dir_out = sample_dir<MATS>(wi, fn, ng, h.m, u_dim(hbs, 0),
                                        u_dim(hbs, 1), u_dim(hbs, 2), samp_valid);
    V3 f2;
    float p2s;
    eval_pdf<MATS>(wi, dir_out, fn, ng, h.m, f2, p2s);
    active = active && samp_valid && p2s > 0.0f;
    st.d = dir_out;
    const float inv = mx(p2s, 1e-30f);
    thr_n = v3(thr.x * f2.x / inv, thr.y * f2.y / inv, thr.z * f2.z / inv);
  }

  // ---- russian roulette
  const bool do_rr = bounces >= tb.rr_depth && active;
  const float rr_prob = do_rr ? mn(max3(thr_n), 0.95f) : 1.0f;
  const float u_rr = u_dim(pcg_hash(hb + salt.rr), 0);
  active = active && !(do_rr && u_rr > rr_prob);
  if (do_rr) {
    const float q = mx(rr_prob, 1e-20f);
    thr_n = v3(thr_n.x / q, thr_n.y / q, thr_n.z / q);
  }
  st.thr = thr_n;
  return active && bounces + 1 < tb.max_cap;
}

// K8: persistent warps over the items s0*n .. s0*n + total - 1; out is
// the (total, 3) radiance of each item, in item order. The block first
// copies the scans' rows into its dynamic shared memory.
template <int MATS, bool QUADS, bool SPH, bool HG>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
render_fused_vol_kernel(lj::Tables tb, Camera cam, Medium med, VolSalts salt,
                        int n, int w, uint32_t su, long long s0,
                        long long total,
                        unsigned long long* __restrict__ counter,
                        float* __restrict__ out,
                        unsigned long long* __restrict__ stats) {
  using namespace lj;
  __shared__ SimtCounts<kWarps, kStats> cnt;
  stage_rows(tb);
  cnt.zero(stats);
  long long c = 0;          // the lane's item, as its row of out
  bool busy = false;        // the lane holds a path
  bool drained = false;     // the counter has passed the last item (warp)
  int bounces = 0;
  VolLane st;
  for (;;) {
    if (!drained) {
      long long mine = 0;
      const long long next = fetch_items(counter, !busy, mine);
      cnt.pass(stats, 2, next >= 0 && !busy);
      if (!busy && next >= 0 && mine < total) {
        c = mine;
        const long long item = s0 * n + c;
        const int pixel = (int)(c % n);
        primary(cam, su, item, (float)(pixel % w), (float)(pixel / w), st.o,
                st.d);
        st.nee_p = st.o;
        st.thr = st.mtp = v3(1.0f, 1.0f, 1.0f);
        st.rad = v3(0.0f, 0.0f, 0.0f);
        st.dir_pdf = 0.0f;
        bounces = 0;
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
      const long long item = s0 * n + c;
      const uint32_t hb = pcg_hash((uint32_t)item ^ pcg_hash((uint32_t)bounces ^ su));
      if (!advance_vol<MATS, QUADS, SPH, HG>(tb, med, salt, st, bounces, hb)) {
        float* o = out + 3 * c;
        o[0] = st.rad.x;
        o[1] = st.rad.y;
        o[2] = st.rad.z;
        busy = false;
      }
      ++bounces;
    }
  }
  cnt.flush(stats);
}

// The film of a per-item buffer: film (3, n) column p sums rows s * stride
// + p, s = 0 .. nspp - 1, of buf (nspp * stride, 3) in sample order,
// dropping a sample with any non-finite channel (render.cpp:140-143). With
// acc set, the sums start from the film's values (a film of earlier
// samples, added onto in place) in place of zero.
__global__ void __launch_bounds__(256)
film_sum_kernel(const float* __restrict__ buf, int n, long long stride,
                int nspp, int acc, float* __restrict__ film) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  if (acc) {
    ax = film[p];
    ay = film[n + p];
    az = film[2 * (long long)n + p];
  }
  for (int s = 0; s < nspp; ++s) {
    const float* v = buf + 3 * ((long long)s * stride + p);
    const float x = __ldg(v), y = __ldg(v + 1), z = __ldg(v + 2);
    if (isfinite(x) && isfinite(y) && isfinite(z)) {
      ax += x;
      ay += y;
      az += z;
    }
  }
  film[p] = ax;
  film[n + p] = ay;
  film[2 * (long long)n + p] = az;
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

// K8. mats: bit 0 Lambertian, bit 1 RoughPlastic; hg: the medium's phase
// is Henyey-Greenstein (else isotropic). counter: one zeroed uint64; out:
// (nspp * n, 3); stats: kStats uint64 counters to add to, or null.
int lj_render_fused_vol(const lj::Tables* tb, const lj::Camera* cam,
                        const lj::Medium* med, const lj::VolSalts* salt,
                        int mats, int quads, int sph, int hg, int n, int w,
                        uint32_t su, long long s0, int nspp,
                        unsigned long long* counter, float* out,
                        unsigned long long* stats, void* stream) {
  if (n <= 0 || nspp <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nspp * n;
  const size_t smem = lj::stage_bytes(*tb);
  cudaError_t e = dispatch(mats, quads, sph, hg, [&](auto M, auto Q, auto S,
                                                     auto H) {
    auto kernel = render_fused_vol_kernel<decltype(M)::value,
                                          decltype(Q)::value,
                                          decltype(S)::value,
                                          decltype(H)::value>;
    int blocks = 0;
    cudaError_t err =
        lj::persistent_blocks(kernel, kThreads, smem, total, blocks);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        *tb, *cam, *med, *salt, n, w, su, s0, total, counter, out, stats);
    return cudaGetLastError();
  });
  return (int)e;
}

// The film sum of K1, K8 and K9: film (3, n) from buf (nspp * stride, 3),
// added onto the film's values where acc is set.
int lj_film_sum(const float* buf, int n, long long stride, int nspp,
                int acc, float* film, void* stream) {
  if (n <= 0 || nspp < 0 || stride < n) return (int)cudaErrorInvalidValue;
  film_sum_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      buf, n, stride, nspp, acc, film);
  return (int)cudaGetLastError();
}

}  // extern "C"
