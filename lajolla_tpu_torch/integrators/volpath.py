"""Volumetric path tracer for homogeneous media: the final integrator.

Port of lajolla_tpu/integrators/volpath.py (the reference's
vol_path_tracing.h:503-869 and its NEE helper :299-495): free-flight
sampling with closed-form transmittance, emission MIS against the cached
NEE origin, one merged NEE per bounce whose shadow ray walks through
index-matching interfaces, phase and BSDF sampling, Russian roulette.
Versions 3-5 of the reference delegate to the final integrator, as in
lajolla_tpu.

Two engines, dispatched as lajolla_tpu's `render_volpath` does:
- scenes inside volpath_kernel.supports (one homogeneous medium filling
  the scene, opaque surfaces) with films of whole 4096-pixel blocks take
  the fused kernel K8 (volpath_kernel.render_fused_vol);
- every other homogeneous scene takes the general engine:
  `_advance_vol_lane` (one bounce for a batch of lanes) inside the queue
  `_render_volpath_block`. Its casts are kernel K3 (scene/geometry.py).

Not ported yet (each raises NotImplementedError): heterogeneous media
(grid and constant volumes alike: lajolla_tpu's free flight takes its
tracking loop and supervoxel majorants as soon as one is present) and
the pedagogical versions 1 and 2, which draw threefry keys rather than
the counter hash.

Fork quirks replicated on purpose, as lajolla_tpu does
(vol_path_tracing.h): a bounce-0 emissive hit ends the path; escaping
into vacuum discards all radiance (:634-641); surface bounces do not
refresh dir_pdf / multi_trans_pdf (:785-848).
"""

import numpy as np
import torch

from lajolla_tpu_torch.core.math import (distance, distance_squared, dot,
                                         normalize)
from lajolla_tpu_torch.dtypes import intersection_eps, shadow_eps
from lajolla_tpu_torch.integrators.lights import (LightPoint, emission_area,
                                                  light_pmf,
                                                  pdf_point_on_light,
                                                  sample_light,
                                                  sample_point_on_light)
from lajolla_tpu_torch.integrators.media import (check_homogeneous,
                                                 get_majorant, get_sigma_s,
                                                 med_row, phase_eval,
                                                 phase_pdf, phase_sample,
                                                 update_medium)
from lajolla_tpu_torch.integrators.path import (_GOLD, _M32, _check_items,
                                                _hash_u01, _pcg_hash,
                                                _primary_hash,
                                                _ray_diff_reflect,
                                                _ray_diff_refract)
from lajolla_tpu_torch.materials import (check_supported, eval_bsdf,
                                         pdf_bsdf, sample_bsdf)
from lajolla_tpu_torch.scene.geometry import intersect_scene

INF = float('inf')
MAX_BOUNCES_CAP = 64
MAX_SHADOW_SEGMENTS = 16  # index-matching interfaces along one shadow ray

# Draw-site salts of the counter-hash stream: each random-consuming site
# inside one (item, bounce) cell has its own sub-stream. Defined here
# only; the kernel module and its CUDA source take them from here.
_S_FF = 0x111AA111       # main free flight
_S_NEE = 0x222BB222      # NEE light pick + point sample
_S_NEE_SEG = 0x333CC333  # per-shadow-segment free flight
_S_PHASE = 0x444DD444
_S_BSDF = 0x555EE555
_S_RR = 0x666FF666
_S_SURF_NEE = 7          # surface lanes re-root their NEE stream: hb + 7
_IT0 = 0x9E377969        # inner-iteration mixer of _uit
_SEED_SALT = 0x701A77E5  # the volpath stream root: pcg(seed ^ salt)

VOL_SPP_BLOCK = 4
VOL_LANES = 131072
VOLK_SPP_BLOCK = 64      # samples per pixel in one K8 launch

VERSION_TODO = ("volpath versions 1 and 2 draw threefry keys, not the "
                "counter hash, and are not yet ported (ROADMAP queue 1: "
                "volpath versions 1/2, a bit-exact threefry in torch)")


def _avg(s):
    """Channel mean of (N, 3), summed left to right as jnp.mean sums."""
    return (s[:, 0] + s[:, 1] + s[:, 2]) / 3.0


def _salt(h, s):
    """pcg(h + s) of 32-bit words."""
    return _pcg_hash((h + s) & _M32)


def _u(hs, dim):
    """dim-th U[0,1) of the sub-stream rooted at the 32-bit words hs."""
    return _hash_u01(_salt(hs, dim * _GOLD & _M32))


def _uit(hs, it, k):
    """k-th uniform of inner-loop iteration it."""
    return _u(_pcg_hash(hs ^ _salt(it, _IT0)), k + 1)


def _pick(v, ch):
    """Per-lane component ch ((N,) int64) of (N, 3) v."""
    return v.gather(1, ch[:, None])[:, 0]


# ---------------------------------------------------------------------------
# Free flight (vol_path_tracing.h:554-629 main form; :355-410 NEE form)
# ---------------------------------------------------------------------------

def _free_flight(scene, options, hs, org, d, med_id, t_hit, with_scatter,
                 row=None):
    """Delta tracking along [0, t_hit) in a homogeneous medium, for N
    lanes. hs: (N,) sub-stream roots. Returns (transmittance,
    trans_dir_pdf, trans_nee_pdf, scatter, accum_t, rounds).
    with_scatter=False is the ratio-tracking NEE variant.

    In a homogeneous medium the majorant and the control are both
    sigma_t (the compiler sets meta.svox_ctrl whenever a medium is
    present), so the very first tracking step ends the loop (a real
    collision, or t_hit reached; the NEE variant reaches t_hit at the
    residual rate 0). lajolla_tpu runs that one step under
    lax.cond(maj0_ch > 0); here it runs on every lane and torch.where
    keeps the initial state where maj0_ch is 0."""
    check_homogeneous(scene.meta)
    if row is None:
        row = med_row(scene, med_id)
    majorant = get_majorant(scene, med_id, org, d, t_hit, row=row)
    channel = torch.clamp((_u(hs, 0) * 3).to(torch.int64), 0, 2)
    go = _pick(majorant, channel) > 0

    # one tracking step from accum_t = 0, it = 0, all products 1
    control, t_end = majorant, t_hit
    resid = torch.clamp(majorant - control, min=0.0)
    rate_ch = _pick(majorant if with_scatter else resid, channel)
    max_maj = torch.clamp(majorant.amax(-1), min=1e-20)[:, None]
    max_den = max_maj if with_scatter else \
        torch.clamp(resid.amax(-1), min=1e-20)[:, None]
    u0 = _uit(hs, 0, 0)
    u1 = _uit(hs, 0, 1)
    t = torch.where(rate_ch > 0,
                    -torch.log(torch.clamp(1.0 - u0, min=1e-20)) /
                    torch.clamp(rate_ch, min=1e-20), INF)
    dt = t_end
    t_next = torch.minimum(t, t_end)
    in_flight = (t < dt)[:, None]

    sigma_t = row[:, 8:11] + row[:, 5:8]          # sigma_s + sigma_a
    den = torch.clamp(majorant, min=1e-20)
    sigma_n = majorant * (1.0 - sigma_t / den)
    real_prob = sigma_t / den
    # clamp inf distances: 0 * inf would be NaN where exp(-0 * dt) is 1
    att = torch.exp(-majorant * torch.clamp(t, max=1e30)[:, None])
    att_dt = torch.exp(-majorant * torch.clamp(dt, max=1e30)[:, None])
    att_r = torch.exp(-resid * torch.clamp(t, max=1e30)[:, None])
    att_r_dt = torch.exp(-resid * torch.clamp(dt, max=1e30)[:, None])

    if with_scatter:
        is_real = (u1 < _pick(real_prob, channel))[:, None]
        trans = torch.where(in_flight,
                            torch.where(is_real, att / max_maj,
                                        att * sigma_n / max_maj), att_dt)
        tdp = torch.where(
            in_flight,
            torch.where(is_real, att * majorant * real_prob / max_maj,
                        att * majorant * (1.0 - real_prob) / max_maj),
            att_dt)
        tnp = torch.where(in_flight,
                          torch.where(is_real, 1.0, att_r * resid / max_maj),
                          att_r_dt)
        scatter = in_flight[:, 0] & is_real[:, 0]
    else:
        trans = torch.where(in_flight, att * sigma_n / max_den, att_dt)
        tnp = torch.where(in_flight, att_r * resid / max_den, att_r_dt)
        tdp = torch.where(in_flight,
                          att * majorant * (1.0 - real_prob) / max_den,
                          att_dt)
        scatter = torch.zeros_like(go)

    g3 = go[:, None]
    return (torch.where(g3, trans, 1.0), torch.where(g3, tdp, 1.0),
            torch.where(g3, tnp, 1.0), go & scatter,
            torch.where(go, t_next, 0.0), go.to(torch.int64))


# ---------------------------------------------------------------------------
# Next-event estimation through index-matching interfaces (:299-495)
# ---------------------------------------------------------------------------

def _vol_nee(scene, options, hb, p, med_id, bounces, dir_view, is_surface,
             hit, row=None):
    """One merged NEE sample for N lanes from points p in media med_id:
    light pick and point, a shadow walk of up to MAX_SHADOW_SEGMENTS
    closest-hit casts (each through scene.geometry.intersect_scene, so K3
    on the card) with the NEE free flight per segment, and the BSDF
    (is_surface lanes) or phase factors. Returns (N, 3) radiance."""
    if row is None:
        row = med_row(scene, med_id)
    eps_shadow = shadow_eps(scene.meta.scene_radius)
    hs = _salt(hb, _S_NEE)
    u = torch.stack([_u(hs, 0), _u(hs, 1), _u(hs, 2), _u(hs, 3)], -1)
    light_id = sample_light(scene, u[:, 2])
    lp = sample_point_on_light(scene, light_id, p, u[:, 0:2], u[:, 3])
    dir_light = normalize(lp.position - p)
    p_prime = lp.position
    p_origin = p

    n = p.shape[0]
    Tl = torch.ones((n, 3), device=p.device)
    pn = torch.ones_like(Tl)
    pd = torch.ones_like(Tl)
    done = torch.zeros(n, dtype=torch.bool, device=p.device)
    blocked = torch.zeros_like(done)
    med = med_id
    # lajolla_tpu's while_loop: every live lane takes one segment per
    # round, so a live lane's segment index sb is the round number
    for sb in range(MAX_SHADOW_SEGMENTS):
        live = ~done & ~blocked
        if not bool(live.any()):
            break
        tmax = (1.0 - eps_shadow) * distance(p, p_prime)
        shadow_hit = intersect_scene(scene, p, dir_light, eps_shadow, tmax)
        valid = shadow_hit.valid
        next_t = torch.where(valid, distance(p, shadow_hit.position),
                             distance(p, p_prime))
        if scene.meta.num_media > 0:
            has_med = (live & (med >= 0))[:, None]
            hseg = _pcg_hash(hs ^ _salt(sb, _S_NEE_SEG))
            trans, tdp, tnp, _sc, _at, _rounds = _free_flight(
                scene, options, hseg, p, dir_light, med, next_t,
                with_scatter=False, row=med_row(scene, med))
            Tl = torch.where(has_med, Tl * trans, Tl)
            pn = torch.where(has_med, pn * tnp, pn)
            pd = torch.where(has_med, pd * tdp, pd)

        opaque = valid & (shadow_hit.material_id >= 0)
        depth_block = valid & (options.max_depth != -1) & \
            (bounces + sb + 1 >= options.max_depth)
        blocked_n = blocked | opaque | depth_block
        step = valid & ~blocked_n
        med = torch.where(live & step,
                          update_medium(shadow_hit, dir_light, med), med)
        p = torch.where((live & step)[:, None], p + next_t[:, None] *
                        dir_light, p)
        blocked = torch.where(live, blocked_n, blocked)
        done = done | (live & ~valid)

    ok = ~blocked & (Tl.amax(-1) > 0)
    Le = emission_area(scene, light_id, lp.normal, -dir_light)
    jac = torch.clamp(-dot(dir_light, lp.normal), min=0.0) / \
        torch.clamp(distance_squared(p_origin, p_prime), min=1e-20)
    pdf_nee = (light_pmf(scene, light_id) *
               pdf_point_on_light(scene, light_id, lp, p_origin))[:, None] * pn

    # is_surface selects the BSDF or the phase factors per lane: the
    # shadow walk (the dominant cost) is shared by both kinds of vertex
    mat_id = hit.material_id
    f_b = eval_bsdf(scene, mat_id, dir_view, dir_light, hit)
    pdf_b = pdf_bsdf(scene, mat_id, dir_view, dir_light, hit)
    f_p = phase_eval(scene, med_id, dir_view, dir_light, row=row)
    pdf_p = phase_pdf(scene, med_id, dir_view, dir_light, row=row)
    ok = ok & (~is_surface | (pdf_b > 0))
    f = torch.where(is_surface[:, None], f_b, f_p)
    pdf_dir = (torch.where(is_surface, pdf_b, pdf_p) * jac)[:, None] * pd

    contrib = Tl * f * Le * jac[:, None] / \
        torch.clamp(_avg(pdf_nee), min=1e-30)[:, None]
    w = (pdf_nee * pdf_nee) / torch.clamp(
        pdf_nee * pdf_nee + pdf_dir * pdf_dir, min=1e-30)
    return torch.where(ok[:, None], contrib * w, 0.0)


# ---------------------------------------------------------------------------
# One bounce of the final integrator
# ---------------------------------------------------------------------------

# The fields of general-engine lane state, in _advance_vol_lane's order.
VOL_STATE = ('item', 'org', 'd', 'medium', 'T', 'L', 'bounces', 'dir_pdf',
             'nee_p', 'multi_trans_pdf', 'eta_scale', 'spread', 'radius',
             'done')


def _advance_vol_lane(scene, options, st, su):
    """One bounce of the final integrator for a batch of N lanes
    (lajolla_tpu vmaps a per-lane form). st holds VOL_STATE: item,
    bounces (N,) int64; medium (N,) int32; org, d, T, L, nee_p,
    multi_trans_pdf (N, 3); dir_pdf, eta_scale, spread, radius (N,)
    float; done (N,) bool. su: the pre-hashed stream root. Returns (new
    state, died), died marking the paths that end THIS step."""
    (item, org, d, medium, T, L, bounces, dir_pdf, nee_p,
     multi_trans_pdf, eta_scale, spread, radius, done) = st
    meta = scene.meta
    eps_isect = intersection_eps(meta.scene_radius)
    max_depth = options.max_depth
    active = ~done
    hb = _pcg_hash(item ^ _pcg_hash(bounces ^ su))

    hit = intersect_scene(scene, org, d, eps_isect, INF, radius, spread)
    t_hit = torch.where(hit.valid, hit.t, INF)

    mrow = med_row(scene, medium)   # one wide fetch per bounce
    in_medium = medium >= 0
    im3 = in_medium[:, None]
    if meta.num_media > 0:
        trans, tdp, tnp, scatter, accum_t, _rounds = _free_flight(
            scene, options, _salt(hb, _S_FF), org, d, medium, t_hit,
            with_scatter=True, row=mrow)
        trans = torch.where(im3, trans, 1.0)
        tdp = torch.where(im3, tdp, 1.0)
        tnp = torch.where(im3, tnp, 1.0)
        scatter = scatter & in_medium
        multi_trans_pdf = torch.where(im3, multi_trans_pdf * tdp,
                                      multi_trans_pdf)
        scatter_pos = org + d * accum_t[:, None]
    else:
        trans = tdp = tnp = torch.ones_like(org)
        scatter = torch.zeros_like(done)
        scatter_pos = org
        accum_t = torch.zeros_like(dir_pdf)

    # vacuum miss: the fork discards the path entirely (:634-641)
    vacuum_miss = ~in_medium & ~hit.valid
    L = torch.where((active & vacuum_miss)[:, None], 0.0, L)
    active = active & ~vacuum_miss

    new_org = torch.where(scatter[:, None], scatter_pos,
                          torch.where(hit.valid[:, None], hit.position, org))
    T = T * trans / torch.clamp(_avg(tdp), min=1e-30)[:, None]
    # the footprint grows with the distance travelled
    t_adv = torch.where(scatter, accum_t, torch.where(hit.valid, hit.t, 0.0))
    radius = radius + spread * t_adv

    # ---- emission (:652-711) ---------------------------------------------
    hit_light = active & ~scatter & hit.valid & (hit.light_id >= 0)
    Le = emission_area(scene, hit.light_id, hit.geometry_normal, -d)
    lp2 = LightPoint(position=hit.position, normal=hit.geometry_normal)
    pdf_nee_l = (light_pmf(scene, hit.light_id) * pdf_point_on_light(
        scene, hit.light_id, lp2, nee_p))[:, None] * tnp
    jac = torch.clamp(-dot(-d, hit.geometry_normal), min=0.0) / \
        torch.clamp(distance_squared(nee_p, hit.position), min=1e-20)
    pdf_phase_l = dir_pdf[:, None] * multi_trans_pdf * jac[:, None]
    w_l = (pdf_phase_l * pdf_phase_l) / torch.clamp(
        pdf_phase_l * pdf_phase_l + pdf_nee_l * pdf_nee_l, min=1e-30)
    first = bounces == 0
    L = L + torch.where(hit_light[:, None],
                        T * Le * torch.where(first[:, None], 1.0, w_l), 0.0)
    active = active & ~(hit_light & first)  # :668 returns at bounce 0

    # ---- index-matching pass-through (:716-726) --------------------------
    pass_through = active & ~scatter & hit.valid & (hit.material_id < 0)
    medium_pt = update_medium(hit, d, medium)

    # ---- depth limit (:731-733) ------------------------------------------
    depth_stop = (max_depth != -1) & (bounces >= max_depth - 1)
    active_work = active & ~pass_through & ~depth_stop
    active = active & ~(depth_stop & ~pass_through)
    # lanes that neither scatter nor hit a surface end here
    active = active & (scatter | hit.valid)

    # ---- scatter in the medium (:737-784) --------------------------------
    do_scatter = active_work & scatter & in_medium
    do_surface = active_work & ~scatter & hit.valid
    sigma_s = get_sigma_s(scene, medium, new_org, row=mrow)
    # ONE merged NEE per bounce; surface lanes re-root their stream
    hb_eff = torch.where(do_surface, _salt(hb, _S_SURF_NEE), hb)
    nee_m = _vol_nee(scene, options, hb_eff, new_org, medium, bounces, -d,
                     do_surface, hit, row=mrow)
    L = L + torch.where(do_scatter[:, None], T * sigma_s * nee_m,
                        torch.where(do_surface[:, None], T * nee_m, 0.0))
    hph = _salt(hb, _S_PHASE)
    u_ph = torch.stack([_u(hph, 0), _u(hph, 1)], -1)
    next_dir = phase_sample(scene, medium, -d, u_ph, row=mrow)
    ph_pdf = phase_pdf(scene, medium, -d, next_dir, row=mrow)
    ph_f = phase_eval(scene, medium, -d, next_dir, row=mrow)
    T_scatter = T * (ph_f / torch.clamp(ph_pdf, min=1e-30)[:, None]) * \
        sigma_s

    # ---- surface interaction (:786-848) ----------------------------------
    hbs = _salt(hb, _S_BSDF)
    u_b = torch.stack([_u(hbs, 0), _u(hbs, 1), _u(hbs, 2)], -1)
    rec = sample_bsdf(scene, hit.material_id, -d, hit, u_b[:, 0:2],
                      u_b[:, 2])
    f = eval_bsdf(scene, hit.material_id, -d, rec.dir_out, hit)
    pdf_b = pdf_bsdf(scene, hit.material_id, -d, rec.dir_out, hit)
    bsdf_ok = rec.valid & (pdf_b > 0)
    active = active & ~(do_surface & ~bsdf_ok)
    is_refract = rec.eta != 0.0
    eta_scale = torch.where(
        do_surface & is_refract,
        eta_scale / torch.clamp(rec.eta * rec.eta, min=1e-12), eta_scale)
    medium_sf = torch.where(is_refract,
                            update_medium(hit, rec.dir_out, medium), medium)
    T_surface = T * f / torch.clamp(pdf_b, min=1e-30)[:, None]
    new_spread = torch.where(
        is_refract,
        _ray_diff_refract(spread, radius, hit.mean_curvature,
                          torch.clamp(rec.eta, min=1e-6), rec.roughness),
        _ray_diff_reflect(spread, radius, hit.mean_curvature,
                          rec.roughness))
    spread = torch.where(do_surface, new_spread, spread)

    # nee cache update (:755-760, :806-810)
    nee_valid = (do_scatter | do_surface) & (nee_m.amax(-1) > 0)
    nee_p = torch.where(nee_valid[:, None], new_org, nee_p)

    # ---- merge branch results --------------------------------------------
    sc3, sf3 = do_scatter[:, None], do_surface[:, None]
    d_next = torch.where(sc3, next_dir, torch.where(sf3, rec.dir_out, d))
    T = torch.where(sc3, T_scatter, torch.where(sf3, T_surface, T))
    medium = torch.where(pass_through, medium_pt,
                         torch.where(do_surface, medium_sf, medium))
    dir_pdf = torch.where(do_scatter, ph_pdf, dir_pdf)
    multi_trans_pdf = torch.where(sc3, 1.0, multi_trans_pdf)

    # ---- russian roulette (:851-862) -------------------------------------
    do_rr = (bounces >= options.rr_depth) & active & ~pass_through
    rr_prob = torch.where(
        do_rr, torch.clamp((T / eta_scale[:, None]).amax(-1), max=0.95), 1.0)
    u_rr = _u(_salt(hb, _S_RR), 0)
    active = active & ~(do_rr & (u_rr > rr_prob))
    T = torch.where(do_rr[:, None],
                    T / torch.clamp(rr_prob, min=1e-20)[:, None], T)

    active = active & (bounces + 1 < MAX_BOUNCES_CAP)
    died = ~done & ~active
    nst = (item, new_org, d_next, medium, T, L, bounces + 1, dir_pdf,
           nee_p, multi_trans_pdf, eta_scale, spread, radius, done)
    return nst, died


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def stream_root(seed):
    """The volpath stream root su = pcg(seed ^ 0x701A77E5), handed
    pre-hashed to the camera and to every vertex hash."""
    return _pcg_hash((int(seed) & _M32) ^ _SEED_SALT)


def _render_volpath_block(scene, options, seed, s0, nspp, lanes=None):
    """The general engine's persistent-wavefront queue over (pixel,
    sample) work items [s0·n, (s0 + nspp)·n). Returns (film_sum (n, 3),
    final state, loop iterations).

    The queue has no padded stride: lane k starts at item s0·n + k
    and takes item + lanes when its path ends, and an item belongs to
    pixel item % n — lajolla_tpu's items, so its random numbers. Each
    iteration advances every lane by one bounce; a lane whose path ended
    adds its radiance to its pixel (index_add_; a sample with any
    non-finite channel is dropped whole, render.cpp:140-143) and takes the
    next item. `done.all()` is read back to the host every iteration."""
    meta = scene.meta
    check_homogeneous(meta)
    check_supported(meta)
    w, h = meta.width, meta.height
    n = w * h
    lanes = lanes or n
    su = stream_root(seed)
    end = (s0 + nspp) * n
    _check_items(end)
    dev = scene.med_tab.device
    spread0 = 0.25 / max(w, h)

    def fresh(item):
        _pix, org, dd = _primary_hash(scene, options, item, su)
        k = item.shape[0]
        return (item, org, dd,
                torch.full((k,), meta.camera_medium_id, dtype=torch.int32,
                           device=dev),
                torch.ones((k, 3), device=dev),
                torch.zeros((k, 3), device=dev),
                torch.zeros(k, dtype=torch.int64, device=dev),
                torch.zeros(k, device=dev), org,
                torch.ones((k, 3), device=dev), torch.ones(k, device=dev),
                torch.full((k,), spread0, device=dev),
                torch.zeros(k, device=dev))

    st = fresh(torch.arange(lanes, device=dev) + s0 * n) + (
        torch.zeros(lanes, dtype=torch.bool, device=dev),)
    film = torch.zeros((n, 3), device=dev)
    iters = 0
    while not bool(st[-1].all()):
        nst, died = _advance_vol_lane(scene, options, st, su)
        item, L, done = nst[0], nst[5], nst[-1]
        fin = torch.isfinite(L).all(dim=-1)
        film.index_add_(0, item % n,
                        torch.where((died & fin)[:, None], L, 0.0))

        next_item = item + lanes
        has_more = next_item < end
        regen = died & has_more
        done = done | (died & ~has_more)
        st = tuple(torch.where(regen if f.dim() == 1 else regen[:, None], f,
                               cur)
                   for f, cur in zip(fresh(next_item), nst[:-1])) + (done,)
        iters += 1
    return film, st, iters


def _use_vol_kernel(scene):
    """lajolla_tpu's dispatch without its TPU-backend test: the scene is
    inside volpath_kernel.supports and the film is whole 4096-pixel
    blocks."""
    from lajolla_tpu_torch.integrators import volpath_kernel  # imports us
    n = scene.meta.width * scene.meta.height
    return volpath_kernel.supports(scene.meta) and \
        n % volpath_kernel.BLOCK == 0


def render_volpath(scene, options, seed=0, checkpoint=None, progress=False):
    """Block-accumulating driver of the final integrator on the scene's
    device → (h, w, 3) numpy image. Scenes of _use_vol_kernel take K8 in
    blocks of VOLK_SPP_BLOCK samples per pixel; the rest take the general
    engine in blocks of VOL_SPP_BLOCK with min(VOL_LANES, n) lanes. A
    failing K8 raises: there is no fallback to the general engine.
    `checkpoint` persists (film sum, samples done, seed) after every
    block, as render_path does."""
    from lajolla_tpu_torch.integrators import volpath_kernel  # imports us
    from lajolla_tpu_torch.utils.checkpoint import load_film, save_film
    from lajolla_tpu_torch.utils.progress import ProgressReporter
    if options.vol_path_version in (1, 2):
        raise NotImplementedError(VERSION_TODO)
    check_homogeneous(scene.meta)
    check_supported(scene.meta)
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    spp = options.samples_per_pixel
    lanes = min(VOL_LANES, n)
    use_kernel = _use_vol_kernel(scene)
    spp_block = VOLK_SPP_BLOCK if use_kernel else VOL_SPP_BLOCK

    img, s0 = None, 0
    if checkpoint:
        img, s0 = load_film(checkpoint, seed, (n, 3))
    if img is None:
        img = np.zeros((n, 3), np.float32)
    rep = ProgressReporter(spp, label="volpath", enabled=progress)
    rep.done = s0
    while s0 < spp:
        ns = min(spp_block, spp - s0)
        if use_kernel:
            block = volpath_kernel.render_fused_vol(scene, options, seed, s0,
                                                    ns)
        else:
            block, _, _ = _render_volpath_block(scene, options, seed, s0, ns,
                                                lanes)
        img += block.reshape(n, 3).cpu().numpy()
        s0 += ns
        rep.update(ns)
        if checkpoint:
            save_film(checkpoint, seed, img, s0)
    rep.finish()
    return (img / spp).reshape(h, w, 3)
