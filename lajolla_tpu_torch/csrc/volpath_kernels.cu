// Kernel K8: the fused volumetric path tracer for one uniform homogeneous
// medium, with a plain C interface for ctypes (lajolla_tpu_torch/kernels.py
// builds this file with nvcc for sm_90a and binds it).
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
// fetches records by one-hot matmuls. Here one thread owns one pixel, as
// in K1: it walks its pixel's work items pixel + k*n, k = s0 .. s0+nspp-1,
// in order, keeps the path state in registers, regenerates at once when a
// path ends, and sums its own film column in sample order. No atomics,
// no shared-memory film. Records are indexed loads; the casts, BSDFs,
// light sampling and camera are K1's (path_advance.cuh, camera.cuh).
//
// What bounds it: per-thread ALU work (two cast scans over the cast and
// occluder tables per bounce, the BSDF evaluated twice) and divergence
// between the threads of a warp, whose path lengths and scatter/surface
// branches differ; a warp runs until its longest queue ends. Film traffic
// is one (3, n) store. The scene tables (< ~100 KB below 192 triangles)
// stay in L1/L2 through the read-only cache.
//
// Every random number is the counter hash of the plain form: the
// per-bounce root hb = pcg(item ^ pcg(bounces ^ su)) with su =
// pcg(seed ^ 0x701A77E5) passed pre-hashed, and the draw-site salts of
// integrators/volpath.py, passed in VolSalts. The HG lobe's 1.5 power is
// t * sqrtf(t), as lajolla_tpu's kernel writes it.
//
// The entry returns cudaGetLastError() after its launch; the kernel
// launches on the caller's stream and does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "camera.cuh"
#include "path_advance.cuh"
#include "volpath_common.cuh"

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
// origin, direction, throughput, radiance, pdfs and NEE origin.
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
  closest_hit<QUADS, SPH>(tb, o, d, s);
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

  // ---- merged NEE: one shadow segment, analytic transmittance
  const uint32_t hb_eff = do_surface ? pcg_hash(hb + salt.surf_nee) : hb;
  const uint32_t hs_n = pcg_hash(hb_eff + salt.nee);
  LightSample ls;
  sample_light<SPH>(tb, p, u_dim(hs_n, 0), u_dim(hs_n, 1), u_dim(hs_n, 2),
                    u_dim(hs_n, 3), ls);
  const V3 dl = ls.dl;
  const bool occ = occluded_any<QUADS, SPH>(tb, p, dl, tb.shadow_far_scale * ls.dist);
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
  const V3 fn = dot3(h.sn, wi) < 0.0f ? neg(h.sn) : h.sn;
  V3 f_b;
  float pdf_b_sa;
  eval_pdf<MATS>(wi, dl, fn, ng, h.m, f_b, pdf_b_sa);
  ok = ok && (!do_surface || pdf_b_sa > 0.0f);
  // f == pdf for both phases: 1/4pi, or the HG lobe at dot(wi, dl)
  const float ph_nee = HG ? hg_lobe(med.g, dot3(wi, dl)) : kInv4Pi;
  const V3 f3 = do_surface ? f_b : v3(ph_nee, ph_nee, ph_nee);
  const float pdf_dir_sa = (do_surface ? pdf_b_sa : ph_nee) * jac;
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
  else if (do_surface)
    rad = v3(rad.x + thr.x * nee_m.x, rad.y + thr.y * nee_m.y,
             rad.z + thr.z * nee_m.z);

  // ---- phase sampling: uniform sphere, or the HG inverse CDF around wi
  const uint32_t hph = pcg_hash(hb + salt.phase);
  const float up0 = u_dim(hph, 0), up1 = u_dim(hph, 1);
  const float zp = 1.0f - 2.0f * up0;
  const float rp = sqrtf(mx(1.0f - zp * zp, 0.0f));
  const float php = kTwoPi * up1;
  V3 pdir = v3(rp * cosf(php), rp * sinf(php), zp);
  float ph_pdf = kInv4Pi;
  V3 thr_sc = v3(thr.x * ss.x, thr.y * ss.y, thr.z * ss.z);
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
    thr_sc = v3(thr.x * r * ss.x, thr.y * r * ss.y, thr.z * r * ss.z);
  }

  // ---- surface interaction
  const uint32_t hbs = pcg_hash(hb + salt.bsdf);
  bool samp_valid;
  const V3 dir_out = sample_dir<MATS>(wi, fn, ng, h.m, u_dim(hbs, 0),
                                      u_dim(hbs, 1), u_dim(hbs, 2), samp_valid);
  V3 f2;
  float p2s;
  eval_pdf<MATS>(wi, dir_out, fn, ng, h.m, f2, p2s);
  active = active && !(do_surface && !(samp_valid && p2s > 0.0f));

  // ---- NEE cache, then merge the branches
  st.nee_p = (do_scatter || do_surface) && max3(nee_m) > 0.0f ? p : st.nee_p;
  st.o = p;
  st.rad = rad;
  st.mtp = mtp;
  V3 thr_n = thr;
  if (do_scatter) {
    st.d = pdir;
    thr_n = thr_sc;
    st.dir_pdf = ph_pdf;
    st.mtp = v3(1.0f, 1.0f, 1.0f);
  } else if (do_surface) {
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

// K8: one thread per pixel, nspp samples each; film is (3, n).
template <int MATS, bool QUADS, bool SPH, bool HG>
__global__ void __launch_bounds__(kThreads)
render_fused_vol_kernel(lj::Tables tb, Camera cam, Medium med, VolSalts salt,
                        int n, int w, uint32_t su, long long s0, int nspp,
                        float* __restrict__ film) {
  using namespace lj;
  const int pixel = blockIdx.x * blockDim.x + threadIdx.x;
  if (pixel >= n) return;
  const float px = (float)(pixel % w), py = (float)(pixel / w);
  V3 acc = v3(0.0f, 0.0f, 0.0f);
  for (long long k = s0; k < s0 + nspp; ++k) {
    const long long item = pixel + k * n;
    VolLane st;
    primary(cam, su, item, px, py, st.o, st.d);
    st.nee_p = st.o;
    st.thr = st.mtp = v3(1.0f, 1.0f, 1.0f);
    st.rad = v3(0.0f, 0.0f, 0.0f);
    st.dir_pdf = 0.0f;
    for (int bounces = 0;; ++bounces) {
      const uint32_t hb = pcg_hash((uint32_t)item ^ pcg_hash((uint32_t)bounces ^ su));
      if (!advance_vol<MATS, QUADS, SPH, HG>(tb, med, salt, st, bounces, hb)) {
        // whole-sample NaN/Inf exclusion (render.cpp:140-143)
        if (isfinite(st.rad.x) && isfinite(st.rad.y) && isfinite(st.rad.z)) {
          acc.x += st.rad.x;
          acc.y += st.rad.y;
          acc.z += st.rad.z;
        }
        break;
      }
    }
  }
  film[pixel] = acc.x;
  film[n + pixel] = acc.y;
  film[2 * (long long)n + pixel] = acc.z;
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
// is Henyey-Greenstein (else isotropic).
int lj_render_fused_vol(const lj::Tables* tb, const lj::Camera* cam,
                        const lj::Medium* med, const lj::VolSalts* salt,
                        int mats, int quads, int sph, int hg, int n, int w,
                        uint32_t su, long long s0, int nspp, float* film,
                        void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = dispatch(mats, quads, sph, hg, [&](auto M, auto Q, auto S,
                                                     auto H) {
    render_fused_vol_kernel<decltype(M)::value, decltype(Q)::value,
                            decltype(S)::value, decltype(H)::value>
        <<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
            *tb, *cam, *med, *salt, n, w, su, s0, nspp, film);
    return cudaGetLastError();
  });
  return (int)e;
}

}  // extern "C"
