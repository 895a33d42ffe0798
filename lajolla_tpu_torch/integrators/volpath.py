"""Volumetric path tracer: the final integrator, for homogeneous and
heterogeneous media.

Port of lajolla_tpu/integrators/volpath.py (the reference's
vol_path_tracing.h:503-869 and its NEE helper :299-495): free-flight
sampling by delta and ratio tracking under piecewise-constant supervoxel
majorants (closed form in homogeneous media), emission MIS against the
cached NEE origin, NEE whose shadow ray walks through index-matching
interfaces, phase and BSDF sampling, Russian roulette. Versions 3-5 of
the reference delegate to the final integrator, as in lajolla_tpu.

Engines, dispatched as lajolla_tpu's `render_volpath` does:
- scenes inside volpath_kernel.supports (one homogeneous medium filling
  the scene, opaque surfaces) with films of whole 4096-pixel blocks take
  the fused kernel K8 (volpath_kernel.render_fused_vol);
- scenes inside volpath_grid_kernel.supports (one heterogeneous medium
  with a mono density grid, a constant albedo and zero supervoxel
  minorants: the hetvol class) take the fused kernel K9
  (volpath_grid_kernel.render_fused_grid);
- every other scene takes a general engine inside the queue
  `_render_volpath_block`: scenes with grid volumes the flat event
  machine `_advance_event` (one cast and K_FF tracking steps per
  iteration), the rest the one-bounce-per-iteration `_advance_vol_lane`,
  whose free flight runs the tracking loop for heterogeneous media of
  constant volumes. Their casts are kernel K3 (scene/geometry.py).

The pedagogical versions 1 and 2 (vol_path_tracing.h:6-147) take none of
these: `_render_volpath_simple_block` traces one single-bounce path a
pixel and sample with `volpath1_trace_one` / `volpath2_trace_one`, whose
random numbers come from threefry keys (core/random.py) folded in per
(pixel, sample), as lajolla_tpu draws them from `jax.random`.

Fork quirks replicated on purpose, as lajolla_tpu does
(vol_path_tracing.h): a bounce-0 emissive hit ends the path; escaping
into vacuum discards all radiance (:634-641); surface bounces do not
refresh dir_pdf / multi_trans_pdf (:785-848).
"""

import torch

from lajolla_tpu_torch.core import random as rnd
from lajolla_tpu_torch.core.random import GOLD, M32, hash_u01, pcg_hash
from lajolla_tpu_torch.core.math import (distance, distance_squared, dot,
                                         normalize)
from lajolla_tpu_torch.dtypes import intersection_eps, shadow_eps
from lajolla_tpu_torch.integrators.lights import (LightPoint, emission_area,
                                                  light_pmf,
                                                  pdf_point_on_light,
                                                  sample_light,
                                                  sample_point_on_light)
from lajolla_tpu_torch.integrators.media import (MT_DLOOK, MT_SA, MT_SOFF,
                                                 MT_SRES, MT_SS, MT_TYPE,
                                                 VL_PMAX, VL_PMIN,
                                                 density_albedo,
                                                 get_majorant, get_sigma_a,
                                                 get_sigma_s,
                                                 has_heterogeneous, med_row,
                                                 phase_eval, phase_pdf,
                                                 phase_sample, update_medium)
from lajolla_tpu_torch.integrators.path import (_check_items, _primary_hash,
                                                _ray_diff_reflect,
                                                _ray_diff_refract)
from lajolla_tpu_torch.materials import eval_bsdf, pdf_bsdf, sample_bsdf
from lajolla_tpu_torch.scene.camera import sample_primary
from lajolla_tpu_torch.scene.geometry import (cast_scene, hit_from_cast,
                                              intersect_scene, occluded)
from lajolla_tpu_torch.scene.types import (MED_HETEROGENEOUS,
                                           MED_HOMOGENEOUS)
from lajolla_tpu_torch.utils import profiling
from lajolla_tpu_torch.utils.film_return import return_film

INF = float('inf')
MAX_BOUNCES_CAP = 64
MAX_SHADOW_SEGMENTS = 16  # index-matching interfaces along one shadow ray

# Draw-site salts of the counter-hash stream: each random-consuming site
# inside one (item, bounce) cell has its own sub-stream. Defined here
# only; the kernel modules and their CUDA sources take them from here.
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
GRID_LANES = 16384       # the event machine's lane pool (grid scenes)
GRIDK_SPP_BLOCK = 32     # samples per pixel in one K9 launch


def _avg(s):
    """Channel mean of (N, 3), summed left to right as jnp.mean sums."""
    return (s[:, 0] + s[:, 1] + s[:, 2]) / 3.0


def _salt(h, s):
    """pcg(h + s) of 32-bit words."""
    return pcg_hash((h + s) & M32)


def _u(hs, dim):
    """dim-th U[0,1) of the sub-stream rooted at the 32-bit words hs."""
    return hash_u01(_salt(hs, dim * GOLD & M32))


def _uit(hs, it, k):
    """k-th uniform of inner-loop iteration it."""
    return _u(pcg_hash(hs ^ _salt(it, _IT0)), k + 1)


def _pick(v, ch):
    """Per-lane component ch ((N,) int64) of (N, 3) v."""
    return v.gather(1, ch[:, None])[:, 0]


def _channel(hs):
    """The free flight's sampled channel: floor(3 u), u the sub-stream's
    first uniform."""
    return torch.clamp((_u(hs, 0) * 3).to(torch.int64), 0, 2)


def _sigmas(scene, row, p):
    """(sigma_s, sigma_a), each (N, 3), at points p from ONE density and
    ONE albedo lookup of the prefetched medium rows."""
    hom_s = row[:, MT_SS:MT_SS + 3]
    hom_a = row[:, MT_SA:MT_SA + 3]
    if not has_heterogeneous(scene.meta):
        return hom_s, hom_a
    density, albedo = density_albedo(scene, row, p)
    is_hom = (row[:, MT_TYPE] == MED_HOMOGENEOUS)[:, None]
    return (torch.where(is_hom, hom_s, density * albedo),
            torch.where(is_hom, hom_a, density * (1.0 - albedo)))


# ---------------------------------------------------------------------------
# Free flight (vol_path_tracing.h:554-629 main form; :355-410 NEE form)
# ---------------------------------------------------------------------------

def _majorant_segment(scene, row, org, d, t_cur, t_hit):
    """Piecewise-constant majorant along the rays: the (N, 3) majorant
    bounding sigma_t over [t_cur, t_end), a (N, 3) control sigma_c <=
    sigma_t over the same span (residual ratio tracking, Novak et al.
    2014), and t_end. Homogeneous media: majorant = control = sigma_t up
    to t_hit. Grid media: one DDA step over the supervoxel majorant /
    minorant grid (scene.svox_data, scene/compile.py) — zero outside the
    grid's box; inside, the current supervoxel's bounds up to its exit,
    extended over an empty run by the cell's empty-skip distance."""
    hom = row[:, MT_SA:MT_SA + 3] + row[:, MT_SS:MT_SS + 3]
    if not has_heterogeneous(scene.meta):
        return hom, hom, t_hit
    pmin = row[:, MT_DLOOK + VL_PMIN:MT_DLOOK + VL_PMIN + 3]
    pmax = row[:, MT_DLOOK + VL_PMAX:MT_DLOOK + VL_PMAX + 3]
    sresf = row[:, MT_SRES:MT_SRES + 3]
    sres = sresf.to(torch.int64)
    safe_d = torch.where(torch.abs(d) > 1e-20, d, 1e-20)
    tn = (pmin - org) / safe_d
    tf = (pmax - org) / safe_d
    t0 = torch.clamp(torch.minimum(tn, tf).amax(dim=-1), min=0.0)
    t1 = torch.maximum(tn, tf).amin(dim=-1)

    # the current supervoxel, nudged off the entry boundary
    span = torch.clamp(t1 - t0, min=1e-20)
    tq = t_cur + 1e-5 * span
    ext = pmax - pmin
    pn = (org + d * tq[:, None] - pmin) / torch.clamp(ext, min=1e-20)
    cell = torch.minimum(torch.clamp((pn * sresf).to(torch.int64), min=0),
                         sres - 1)
    cellf = cell.to(torch.float32)
    clo = pmin + cellf / sresf * ext
    chi = pmin + (cellf + 1.0) / sresf * ext
    idx = row[:, MT_SOFF].to(torch.int64) + \
        (cell[:, 2] * sres[:, 1] + cell[:, 1]) * sres[:, 0] + cell[:, 0]
    # majorant rgb | empty-skip | control rgb: one row gather per step
    rowd = scene.svox_data[torch.clamp(idx, 0,
                                       scene.svox_data.shape[0] - 1)]
    ex = torch.clamp(rowd[:, 3:4] - 1.0, min=0.0) / sresf * ext
    tcn = (clo - ex - org) / safe_d
    tcf = (chi + ex - org) / safe_d
    t_exit = torch.maximum(tcn, tcf).amin(dim=-1)

    before = t_cur < t0
    after = t_cur >= t1
    outside = (before | after | (t0 > t1))[:, None]
    maj_het = torch.where(outside, 0.0, rowd[:, 0:3])
    ctrl_het = torch.where(outside, 0.0, rowd[:, 4:7])
    # forward progress for boundary-sitting lanes (tq's nudge stays inside
    # the supervoxel build's one-node margin)
    t_end_het = torch.where(before & (t0 <= t1), t0,
                            torch.where(after | (t0 > t1), INF,
                                        torch.maximum(t_exit, tq)))
    is_het = row[:, MT_TYPE] == MED_HETEROGENEOUS
    i3 = is_het[:, None]
    return (torch.where(i3, maj_het, hom), torch.where(i3, ctrl_het, hom),
            torch.where(is_het, torch.minimum(t_end_het, t_hit), t_hit))


def _track_step(scene, options, row, hs, channel, org, d, t_hit, wsc, live,
                st):
    """One delta / ratio-tracking step for the lanes where `live`, the
    others unchanged. st = (accum_t, it, trans, tdp, tnp, scatter, done);
    wsc (N,) bool: the distance-sampling (scatter) process, else the NEE
    ratio-tracking one at the residual rate (majorant - control), with the
    control folded in analytically: exp(-m t) = exp(-c t) exp(-(m-c) t).
    meta.svox_ctrl False means every control is 0 (resid == majorant)."""
    (accum_t, it, trans, tdp, tnp, scatter, dn) = st
    majorant, control, t_end = _majorant_segment(scene, row, org, d,
                                                 accum_t, t_hit)
    use_res = scene.meta.svox_ctrl
    resid = torch.clamp(majorant - control, min=0.0) if use_res \
        else majorant
    rate_ch = torch.where(wsc, _pick(majorant, channel),
                          _pick(resid, channel))
    max_maj = torch.clamp(majorant.amax(dim=-1), min=1e-20)
    max_den = torch.where(wsc, max_maj,
                          torch.clamp(resid.amax(dim=-1), min=1e-20))
    u0 = _uit(hs, it, 0)
    u1 = _uit(hs, it, 1)
    t = torch.where(rate_ch > 0,
                    -torch.log(torch.clamp(1.0 - u0, min=1e-20)) /
                    torch.clamp(rate_ch, min=1e-20), INF)
    dt = t_end - accum_t
    t_next = torch.minimum(accum_t + t, t_end)
    in_flight = t < dt
    hit_end = ~in_flight & (t_end >= t_hit)

    sigma_s, sigma_a = _sigmas(scene, row, org + d * t_next[:, None])
    sigma_t = sigma_s + sigma_a
    den = torch.clamp(majorant, min=1e-20)
    sigma_n = majorant * (1.0 - sigma_t / den)
    real_prob = sigma_t / den
    # clamp inf distances: 0 * inf would be NaN where exp(-0 * dt) is 1
    t_c = torch.clamp(t, max=1e30)[:, None]
    dt_c = torch.clamp(dt, max=1e30)[:, None]
    att = torch.exp(-majorant * t_c)
    att_dt = torch.exp(-majorant * dt_c)
    att_r = torch.exp(-resid * t_c) if use_res else att
    att_r_dt = torch.exp(-resid * dt_c) if use_res else att_dt

    is_real = wsc & (u1 < _pick(real_prob, channel))
    md = max_den[:, None]
    f3, r3 = in_flight[:, None], is_real[:, None]
    trans_n = torch.where(f3, torch.where(r3, trans * att / md,
                                          trans * att * sigma_n / md),
                          trans * att_dt)
    tdp_n = torch.where(
        f3, torch.where(r3, tdp * att * majorant * real_prob / md,
                        tdp * att * majorant * (1.0 - real_prob) / md),
        tdp * att_dt)
    tnp_n = torch.where(f3, torch.where(r3, tnp, tnp * att_r * resid / md),
                        tnp * att_r_dt)
    scatter_n = scatter | (in_flight & is_real)
    dn_n = dn | hit_end | (in_flight & is_real) | \
        (~wsc & (trans_n.amax(dim=-1) <= 0)) | \
        (it + 1 >= options.max_null_collisions)
    l3 = live[:, None]
    return (torch.where(live, t_next, accum_t), torch.where(live, it + 1, it),
            torch.where(l3, trans_n, trans), torch.where(l3, tdp_n, tdp),
            torch.where(l3, tnp_n, tnp), torch.where(live, scatter_n, scatter),
            torch.where(live, dn_n, dn))


def _free_flight(scene, options, hs, org, d, med_id, t_hit, with_scatter,
                 row=None, active=None):
    """Delta tracking along [0, t_hit) for N lanes. hs: (N,) sub-stream
    roots. Returns (transmittance, trans_dir_pdf, trans_nee_pdf, scatter,
    accum_t, rounds). with_scatter=False is the ratio-tracking NEE
    variant. `active` (N,) bool, if given, limits the tracking to those
    lanes (the others return the initial state).

    Homogeneous media: majorant == control == sigma_t, so the first step
    ends the flight (a real collision, or t_hit reached); lajolla_tpu runs
    that step under lax.cond(maj0_ch > 0), here it runs on every lane and
    keeps the initial state where maj0_ch is 0. With a heterogeneous
    medium in the scene, lajolla_tpu's while_loop becomes a host loop of
    steps while any lane goes on (maj0_ch > 0, not done, fewer than
    max_null_collisions steps)."""
    if row is None:
        row = med_row(scene, med_id)
    n = org.shape[0]
    dev = org.device
    majorant0 = get_majorant(scene, med_id, org, d, t_hit, row=row)
    channel = _channel(hs)
    go = _pick(majorant0, channel) > 0
    if active is not None:
        go = go & active
    wsc = torch.full((n,), bool(with_scatter), device=dev)
    ones = torch.ones((n, 3), device=dev)
    st = (torch.zeros(n, device=dev),
          torch.zeros(n, dtype=torch.int64, device=dev), ones, ones, ones,
          torch.zeros(n, dtype=torch.bool, device=dev),
          torch.zeros(n, dtype=torch.bool, device=dev))
    if not has_heterogeneous(scene.meta):
        st = _track_step(scene, options, row, hs, channel, org, d, t_hit,
                         wsc, go, st)
    else:
        while True:
            live = go & ~st[6] & (st[1] < options.max_null_collisions)
            if not bool(live.any()):
                break
            st = _track_step(scene, options, row, hs, channel, org, d,
                             t_hit, wsc, live, st)
    accum_t, it, trans, tdp, tnp, scatter, _done = st
    return trans, tdp, tnp, scatter, accum_t, it


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
            seg_med = live & (med >= 0)
            has_med = seg_med[:, None]
            hseg = pcg_hash(hs ^ _salt(sb, _S_NEE_SEG))
            trans, tdp, tnp, _sc, _at, _rounds = _free_flight(
                scene, options, hseg, p, dir_light, med, next_t,
                with_scatter=False, row=med_row(scene, med), active=seg_med)
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
    hb = pcg_hash(item ^ pcg_hash(bounces ^ su))

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
# The flat event machine (grid-media scenes).
#
# The reference integrator is three nested stochastic loops: bounces x
# null collisions x shadow-ray segments, each segment with its own
# null-collision loop. Run over a batch of lanes, every nesting level
# costs the batch's longest loop. The flat machine advances every lane by
# ONE bounded event per iteration — a main-ray cast plus K_FF tracking
# steps, K_FF more steps, a shadow-segment cast plus K_FF steps, or K_FF
# more shadow steps — so the iteration count follows the mean number of
# events per path. Physics, MIS caches and random numbers are those of
# the nested form (the same per-(item, bounce) counter-hash cells).
# ---------------------------------------------------------------------------

PH_CAST = 0    # cast the main ray, start its free flight, step it
PH_FF = 1      # continue the main free flight
PH_SHC = 3     # cast the next shadow segment, start its flight, step it
PH_SHF = 4     # continue the shadow segment's free flight
K_FF = 8       # tracking steps per iteration

# The fields of event-machine lane state, in _advance_event's order
# (VOL_STATE's path fields, then the phase, the cached main cast, the
# free flight's carried products, the shadow chain, the NEE vertex
# factors, the current shadow segment, the vertex's alive bit, done).
EVENT_STATE = VOL_STATE[:-1] + (
    'ph', 'mc_t', 'mc_prim', 'mc_u', 'mc_v', 'mc_sph',
    'ff_hs', 'ff_t', 'ff_it', 'ff_tr', 'ff_dp', 'ff_np', 'ff_sc', 'ff_dn',
    'sh_p', 'sh_dir', 'sh_med', 'sh_seg', 'sh_T', 'sh_pn', 'sh_pd',
    'lp_pos', 'nb_hs', 'cb', 'pdfb', 'pdfd', 'tsc',
    'sg_t', 'sg_valid', 'sg_opaque', 'sg_dblock', 'sg_mednext',
    'v_alive', 'done')


def _ff_steps(scene, options, row, hs, org, d, t_hit, wsc, go, fst):
    """K_FF tracking steps with per-lane wsc (the scatter process, else
    NEE) on the lanes where `go`. fst = (ff_t, it, trans, tdp, tnp,
    scatter, done)."""
    channel = _channel(hs)
    for _ in range(K_FF):
        live = go & ~fst[6] & (fst[1] < options.max_null_collisions)
        fst = _track_step(scene, options, row, hs, channel, org, d, t_hit,
                          wsc, live, fst)
    return fst


def _advance_event(scene, options, st, su):
    """Advance N lanes by one event each (EVENT_STATE; lajolla_tpu vmaps a
    per-lane form). An iteration makes at most one cast per lane — the
    main ray for lanes starting a bounce, the next shadow segment for
    lanes walking an NEE chain — then K_FF tracking steps, then, for lanes
    whose main free flight ended this iteration, the whole vertex
    (emission MIS, NEE set-up, continuation sampling, RR). The vertex is
    the reference bounce body (vol_path_tracing.h:503-869); NEE (:299-495)
    splits into vertex-time factors (cb, pdfb, pdfd, tsc) and the shadow
    walk's products (sh_T, sh_pn, sh_pd), combined when the chain ends.
    Returns (new state, died)."""
    (item, org, d, medium, T, L, bounces, dir_pdf, nee_p, mtp,
     eta_scale, spread, radius, ph,
     mc_t, mc_prim, mc_u, mc_v, mc_sph,
     ff_hs, ff_t, ff_it, ff_tr, ff_dp, ff_np, ff_sc, ff_dn,
     sh_p, sh_dir, sh_med, sh_seg, sh_T, sh_pn, sh_pd, lp_pos,
     nb_hs, cb, pdfb, pdfd, tsc,
     sg_t, sg_valid, sg_opaque, sg_dblock, sg_mednext,
     v_alive, done) = st
    meta = scene.meta
    eps_i = intersection_eps(meta.scene_radius)
    eps_s = shadow_eps(meta.scene_radius)
    max_depth = options.max_depth
    col = lambda m: m[:, None]   # noqa: E731  (N,) mask against (N, 3)
    alive_l = ~done

    in_cast = alive_l & (ph == PH_CAST)
    in_ff = alive_l & (ph == PH_FF)
    in_shc = alive_l & (ph == PH_SHC)
    in_shf = alive_l & (ph == PH_SHF)
    is_sh = in_shc | in_shf

    hb = pcg_hash(item ^ pcg_hash(bounces ^ su))
    mrow = med_row(scene, medium)
    in_medium = medium >= 0

    # ---- one raw cast: the main ray (PH_CAST) or a shadow segment (PH_SHC)
    dist_l = distance(sh_p, lp_pos)
    cast_o = torch.where(col(in_shc), sh_p, org)
    cast_d = torch.where(col(in_shc), sh_dir, d)
    cast_near = torch.where(in_shc, eps_s, eps_i)
    cast_far = torch.where(in_shc, (1.0 - eps_s) * dist_l, INF)
    rt, rprim, rbu, rbv, rsph = cast_scene(scene, cast_o, cast_d, cast_near,
                                           cast_far)
    mc_t = torch.where(in_cast, rt, mc_t)
    mc_prim = torch.where(in_cast, rprim, mc_prim)
    mc_u = torch.where(in_cast, rbu, mc_u)
    mc_v = torch.where(in_cast, rbv, mc_v)
    mc_sph = torch.where(in_cast, rsph, mc_sph)

    # ---- ONE record build: shadow-cast lanes from the fresh cast, the
    # others from the cached main cast (fresh for PH_CAST)
    b_raw = tuple(torch.where(in_shc, r, m) for r, m in zip(
        (rt, rprim, rbu, rbv, rsph), (mc_t, mc_prim, mc_u, mc_v, mc_sph)))
    hit = hit_from_cast(scene, torch.where(col(in_shc), cast_o, org),
                        torch.where(col(in_shc), cast_d, d), b_raw, radius,
                        spread)

    # ---- main free-flight start (PH_CAST) -------------------------------
    hs_ff0 = _salt(hb, _S_FF)
    maj0 = get_majorant(scene, medium, org, d, rt, row=mrow)
    ff_trivial = (medium < 0) | (_pick(maj0, _channel(hs_ff0)) <= 0) | \
        (meta.num_media == 0)

    # ---- shadow-segment set-up (PH_SHC) ---------------------------------
    sg_valid_n = rt < INF
    seg_next_t = torch.where(sg_valid_n, distance(sh_p, hit.position),
                             dist_l)
    sg_opaque_n = sg_valid_n & (hit.material_id >= 0)
    # bounces was incremented at the vertex: the pre-vertex depth is
    # bounces - 1 (the reference's depth check, :437-446)
    sg_dblock_n = sg_valid_n & (max_depth != -1) & \
        (bounces - 1 + sh_seg + 1 >= max_depth)
    sg_mednext_n = update_medium(hit, sh_dir, sh_med)
    sg_t = torch.where(in_shc, seg_next_t, sg_t)
    sg_valid = torch.where(in_shc, sg_valid_n, sg_valid)
    sg_opaque = torch.where(in_shc, sg_opaque_n, sg_opaque)
    sg_dblock = torch.where(in_shc, sg_dblock_n, sg_dblock)
    sg_mednext = torch.where(in_shc, sg_mednext_n, sg_mednext)
    hseg = pcg_hash(nb_hs ^ _salt(sh_seg, _S_NEE_SEG))
    srow = med_row(scene, sh_med)
    smaj0 = get_majorant(scene, sh_med, sh_p, sh_dir, seg_next_t, row=srow)
    sff_trivial = (sh_med < 0) | (_pick(smaj0, _channel(hseg)) <= 0) | \
        (meta.num_media == 0)

    # reset the free-flight slots on entry (shared: the main products are
    # consumed at the vertex before any shadow segment uses them)
    entry = in_cast | in_shc
    ff_hs = torch.where(in_cast, hs_ff0, torch.where(in_shc, hseg, ff_hs))
    ff_t = torch.where(entry, 0.0, ff_t)
    ff_it = torch.where(entry, 0, ff_it)
    ff_tr = torch.where(col(entry), 1.0, ff_tr)
    ff_dp = torch.where(col(entry), 1.0, ff_dp)
    ff_np = torch.where(col(entry), 1.0, ff_np)
    ff_sc = ff_sc & ~entry
    ff_dn = torch.where(in_cast, ff_trivial,
                        torch.where(in_shc, sff_trivial, ff_dn))

    # ---- K_FF tracking steps (all four phases) ---------------------------
    f_row = torch.where(col(is_sh), srow, mrow)
    f_org = torch.where(col(is_sh), sh_p, org)
    f_dir = torch.where(col(is_sh), sh_dir, d)
    f_thit = torch.where(is_sh, sg_t, mc_t)
    go = in_cast | in_ff | is_sh
    wsc = ~is_sh & in_medium
    (ff_t, ff_it, ff_tr, ff_dp, ff_np, ff_sc, ff_dn) = _ff_steps(
        scene, options, f_row, ff_hs, f_org, f_dir, f_thit, wsc, go,
        (ff_t, ff_it, ff_tr, ff_dp, ff_np, ff_sc, ff_dn))

    ph = torch.where((in_cast | in_ff) & ~ff_dn, PH_FF, ph)
    seg_ff_done = is_sh & ff_dn
    ph = torch.where(is_sh & ~ff_dn, PH_SHF, ph)

    # ---- shadow-segment wrap-up ------------------------------------------
    seg_med = col(seg_ff_done & (sh_med >= 0))
    sh_T = torch.where(seg_med, sh_T * ff_tr, sh_T)
    sh_pn = torch.where(seg_med, sh_pn * ff_np, sh_pn)
    sh_pd = torch.where(seg_med, sh_pd * ff_dp, sh_pd)
    blocked = sg_opaque | sg_dblock
    cont_chain = seg_ff_done & sg_valid & ~blocked & \
        (sh_seg + 1 < MAX_SHADOW_SEGMENTS)
    sh_med = torch.where(cont_chain, sg_mednext, sh_med)
    sh_p = torch.where(col(cont_chain), sh_p + sg_t[:, None] * sh_dir, sh_p)
    sh_seg = torch.where(seg_ff_done, sh_seg + 1, sh_seg)
    ph = torch.where(cont_chain, PH_SHC, ph)
    chain_done = seg_ff_done & ~cont_chain

    # ---- NEE completion (chain_done) -------------------------------------
    ok = ~blocked & (sh_T.amax(dim=-1) > 0)
    pdf_nee = pdfb[:, None] * sh_pn
    contrib = sh_T * cb / torch.clamp(_avg(pdf_nee), min=1e-30)[:, None]
    pdf_dir3 = pdfd[:, None] * sh_pd
    wmis = (pdf_nee * pdf_nee) / torch.clamp(
        pdf_nee * pdf_nee + pdf_dir3 * pdf_dir3, min=1e-30)
    nee_out = torch.where(col(ok), contrib * wmis, 0.0)
    L = L + torch.where(col(chain_done), tsc * nee_out, 0.0)
    nee_p = torch.where(col(chain_done & (nee_out.amax(dim=-1) > 0)), org,
                        nee_p)
    cont_ok = v_alive & (bounces < MAX_BOUNCES_CAP)
    died_c = chain_done & ~cont_ok
    ph = torch.where(chain_done & cont_ok, PH_CAST, ph)

    # ---- VERTEX: in the iteration the main free flight ends --------------
    vready = (in_cast | in_ff) & ff_dn
    active = vready
    im3 = col(in_medium)
    trans = torch.where(im3, ff_tr, 1.0)
    tdp = torch.where(im3, ff_dp, 1.0)
    tnp = torch.where(im3, ff_np, 1.0)
    scatter = ff_sc & in_medium
    mtp_v = torch.where(im3, mtp * tdp, mtp)
    scatter_pos = org + d * ff_t[:, None]
    hit_valid = mc_t < INF

    # vacuum miss: the fork discards the path entirely (:634-641)
    vacuum_miss = ~in_medium & ~hit_valid
    L = torch.where(col(active & vacuum_miss), 0.0, L)
    active = active & ~vacuum_miss

    new_org = torch.where(col(scatter), scatter_pos,
                          torch.where(col(hit_valid), hit.position, org))
    T_v = T * trans / torch.clamp(_avg(tdp), min=1e-30)[:, None]
    t_adv = torch.where(scatter, ff_t, torch.where(hit_valid, hit.t, 0.0))
    radius_v = radius + spread * t_adv

    # emission (:652-711)
    hit_light = active & ~scatter & hit_valid & (hit.light_id >= 0)
    Le = emission_area(scene, hit.light_id, hit.geometry_normal, -d)
    lp2 = LightPoint(position=hit.position, normal=hit.geometry_normal)
    pdf_nee_l = (light_pmf(scene, hit.light_id) * pdf_point_on_light(
        scene, hit.light_id, lp2, nee_p))[:, None] * tnp
    jac_l = torch.clamp(-dot(-d, hit.geometry_normal), min=0.0) / \
        torch.clamp(distance_squared(nee_p, hit.position), min=1e-20)
    pdf_phase_l = dir_pdf[:, None] * mtp_v * jac_l[:, None]
    w_l = (pdf_phase_l * pdf_phase_l) / torch.clamp(
        pdf_phase_l * pdf_phase_l + pdf_nee_l * pdf_nee_l, min=1e-30)
    first = bounces == 0
    L = L + torch.where(col(hit_light),
                        T_v * Le * torch.where(col(first), 1.0, w_l), 0.0)
    active = active & ~(hit_light & first)  # :668 returns at bounce 0

    # index-matching pass-through (:716-726)
    pass_through = active & ~scatter & hit_valid & (hit.material_id < 0)
    medium_pt = update_medium(hit, d, medium)

    # depth limit (:731-733)
    depth_stop = (max_depth != -1) & (bounces >= max_depth - 1)
    active_work = active & ~pass_through & ~depth_stop
    active = active & ~(depth_stop & ~pass_through)
    active = active & (scatter | hit_valid)

    # scatter in the medium (:737-784)
    do_scatter = active_work & scatter & in_medium
    sigma_s = get_sigma_s(scene, medium, new_org, row=mrow)
    hph = _salt(hb, _S_PHASE)
    u_ph = torch.stack([_u(hph, 0), _u(hph, 1)], -1)
    next_dir = phase_sample(scene, medium, -d, u_ph, row=mrow)
    ph_pdf = phase_pdf(scene, medium, -d, next_dir, row=mrow)
    ph_f = phase_eval(scene, medium, -d, next_dir, row=mrow)
    T_scatter = T_v * (ph_f / torch.clamp(ph_pdf, min=1e-30)[:, None]) * \
        sigma_s

    # surface interaction (:786-848)
    do_surface = active_work & ~scatter & hit_valid
    hbs = _salt(hb, _S_BSDF)
    u_b = torch.stack([_u(hbs, 0), _u(hbs, 1), _u(hbs, 2)], -1)
    rec = sample_bsdf(scene, hit.material_id, -d, hit, u_b[:, 0:2],
                      u_b[:, 2])
    f_b = eval_bsdf(scene, hit.material_id, -d, rec.dir_out, hit)
    pdf_b = pdf_bsdf(scene, hit.material_id, -d, rec.dir_out, hit)
    bsdf_ok = rec.valid & (pdf_b > 0)
    active = active & ~(do_surface & ~bsdf_ok)
    is_refract = rec.eta != 0.0
    eta_v = torch.where(
        do_surface & is_refract,
        eta_scale / torch.clamp(rec.eta * rec.eta, min=1e-12), eta_scale)
    medium_sf = torch.where(is_refract,
                            update_medium(hit, rec.dir_out, medium), medium)
    T_surface = T_v * f_b / torch.clamp(pdf_b, min=1e-30)[:, None]
    new_spread = torch.where(
        is_refract,
        _ray_diff_refract(spread, radius_v, hit.mean_curvature,
                          torch.clamp(rec.eta, min=1e-6), rec.roughness),
        _ray_diff_reflect(spread, radius_v, hit.mean_curvature,
                          rec.roughness))
    spread_v = torch.where(do_surface, new_spread, spread)

    # NEE set-up (the vertex-time half of :299-495): light pick, point and
    # the direction-independent factors
    with_nee = do_scatter | do_surface
    hb_eff = torch.where(do_surface, _salt(hb, _S_SURF_NEE), hb)
    nb_hs_v = _salt(hb_eff, _S_NEE)
    u_n = torch.stack([_u(nb_hs_v, k) for k in range(4)], -1)
    light_id = sample_light(scene, u_n[:, 2])
    lp = sample_point_on_light(scene, light_id, new_org, u_n[:, 0:2],
                               u_n[:, 3])
    dir_l_v = normalize(lp.position - new_org)
    Le_n = emission_area(scene, light_id, lp.normal, -dir_l_v)
    jac_n = torch.clamp(-dot(dir_l_v, lp.normal), min=0.0) / \
        torch.clamp(distance_squared(new_org, lp.position), min=1e-20)
    pdfb_v = light_pmf(scene, light_id) * \
        pdf_point_on_light(scene, light_id, lp, new_org)
    f_ph = phase_eval(scene, medium, -d, dir_l_v, row=mrow)
    pdf_ph = phase_pdf(scene, medium, -d, dir_l_v, row=mrow)
    f_bs = eval_bsdf(scene, hit.material_id, -d, dir_l_v, hit)
    pdf_bs = pdf_bsdf(scene, hit.material_id, -d, dir_l_v, hit)
    cb_v = torch.where(col(do_surface),
                       torch.where(col(pdf_bs > 0), f_bs, 0.0), f_ph) * \
        Le_n * jac_n[:, None]
    pdfd_v = torch.where(do_surface, pdf_bs, pdf_ph) * jac_n
    tsc_v = torch.where(col(do_scatter), T_v * sigma_s, T_v)

    # merge the continuation, applied now; the chain carries v_alive
    d_next = torch.where(col(do_scatter), next_dir,
                         torch.where(col(do_surface), rec.dir_out, d))
    T_n = torch.where(col(do_scatter), T_scatter,
                      torch.where(col(do_surface), T_surface, T_v))
    medium_n = torch.where(pass_through, medium_pt,
                           torch.where(do_surface, medium_sf, medium))
    dir_pdf_n = torch.where(do_scatter, ph_pdf, dir_pdf)
    mtp_n = torch.where(col(do_scatter), 1.0, mtp_v)

    # russian roulette (:851-862)
    do_rr = (bounces >= options.rr_depth) & active & ~pass_through
    rr_prob = torch.where(
        do_rr, torch.clamp((T_n / eta_v[:, None]).amax(dim=-1), max=0.95),
        1.0)
    u_rr = _u(_salt(hb, _S_RR), 0)
    active = active & ~(do_rr & (u_rr > rr_prob))
    T_n = torch.where(col(do_rr), T_n / torch.clamp(rr_prob, min=1e-20)
                      [:, None], T_n)

    # ---- apply the vertex results ----------------------------------------
    v = vready
    v3 = col(v)
    med_vertex = medium              # the chain walks the VERTEX medium
    org = torch.where(v3, new_org, org)
    d = torch.where(v3, d_next, d)
    T = torch.where(v3, T_n, T)
    medium = torch.where(v, medium_n, medium)
    bounces = torch.where(v, bounces + 1, bounces)
    dir_pdf = torch.where(v, dir_pdf_n, dir_pdf)
    mtp = torch.where(v3, mtp_n, mtp)
    eta_scale = torch.where(v, eta_v, eta_scale)
    spread = torch.where(v, spread_v, spread)
    radius = torch.where(v, radius_v, radius)
    v_alive = torch.where(v, active, v_alive)

    # shadow chain start, or the direct continuation
    start = v & with_nee
    s3 = col(start)
    sh_p = torch.where(s3, new_org, sh_p)
    sh_dir = torch.where(s3, dir_l_v, sh_dir)
    sh_med = torch.where(start, med_vertex, sh_med)
    sh_seg = torch.where(start, 0, sh_seg)
    sh_T = torch.where(s3, 1.0, sh_T)
    sh_pn = torch.where(s3, 1.0, sh_pn)
    sh_pd = torch.where(s3, 1.0, sh_pd)
    lp_pos = torch.where(s3, lp.position, lp_pos)
    nb_hs = torch.where(start, nb_hs_v, nb_hs)
    cb = torch.where(s3, cb_v, cb)
    pdfb = torch.where(start, pdfb_v, pdfb)
    pdfd = torch.where(start, pdfd_v, pdfd)
    tsc = torch.where(s3, tsc_v, tsc)
    ph = torch.where(start, PH_SHC, ph)

    ph = torch.where(v & ~with_nee & active, PH_CAST, ph)  # pass-through
    died_v = v & ~with_nee & ~active

    died = (died_v | died_c) & ~done
    nst = (item, org, d, medium, T, L, bounces, dir_pdf, nee_p, mtp,
           eta_scale, spread, radius, ph,
           mc_t, mc_prim, mc_u, mc_v, mc_sph,
           ff_hs, ff_t, ff_it, ff_tr, ff_dp, ff_np, ff_sc, ff_dn,
           sh_p, sh_dir, sh_med, sh_seg, sh_T, sh_pn, sh_pd, lp_pos,
           nb_hs, cb, pdfb, pdfd, tsc,
           sg_t, sg_valid, sg_opaque, sg_dblock, sg_mednext,
           v_alive, done)
    return nst, died


# ---------------------------------------------------------------------------
# Pedagogical versions 1 and 2 (vol_path_tracing.h:6-147)
# ---------------------------------------------------------------------------

def _uniforms(keys, n):
    """(keys, (N, n) uniforms): split each key, draw n uniforms from the
    second half, keep the first."""
    keys, sub = rnd.split(keys)
    return keys, rnd.uniform(sub, n)


def _primary(scene, options, px, py, keys):
    """(keys, org, d): the camera ray through each pixel from the key's
    first two uniforms."""
    keys, u_pix = _uniforms(keys, 2)
    org, d = sample_primary(scene, options, px.to(torch.float32),
                            py.to(torch.float32), u_pix)
    return keys, org, d


def volpath1_trace_one(scene, options, px, py, keys):
    """Absorption only, a single homogeneous exterior volume (:6-41), for
    lanes of pixels (px, py) ((N,) int64) with threefry keys (N, 2).
    Returns (N, 3) radiance. Le counts only where the hit's exterior
    medium exists."""
    _, org, d = _primary(scene, options, px, py, keys)
    hit = intersect_scene(scene, org, d, 0.0, INF)
    has_med = hit.valid & (hit.exterior_med >= 0)
    sigma_a = get_sigma_a(scene, hit.exterior_med, hit.position)
    # miss lanes carry position = inf; the result is masked by has_med,
    # but exp(-σ·inf) would NaN the σ gradient of diffpath's
    # render_volpath_diff — 0 gives the same film
    t_hit = torch.where(hit.valid, distance(hit.position, org), 0.0)
    transmittance = torch.exp(-sigma_a * t_hit[:, None])
    Le = torch.where((hit.light_id >= 0)[:, None],
                     emission_area(scene, hit.light_id, hit.geometry_normal,
                                   -d), 0.0)
    return torch.where(has_med[:, None], transmittance * Le, 0.0)


def volpath2_trace_one(scene, options, px, py, keys, detach=False):
    """A single monochromatic homogeneous volume, single scattering
    (:46-147), batched as volpath1_trace_one. The free flight samples
    channel 0's sigma_t; one shadow ray a lane.

    detach=True is the volumetric detached-gradient mode (see
    path._advance_lane): the sampled free-flight distance, the sampling
    pdfs and all geometry are detached while the transmittance,
    scattering, phase and emission factors stay attached — unbiased
    gradients with respect to the medium (σ_a, σ_s), phase and emission
    parameters, since the pdfs carry no parameter once detached. The
    film does not change; integrators/diffpath.render_volpath_diff uses
    it."""
    sg = (lambda x: x.detach()) if detach else (lambda x: x)
    eps_shadow = shadow_eps(scene.meta.scene_radius)
    keys, org, d = _primary(scene, options, px, py, keys)
    hit = intersect_scene(scene, org, d, 0.0, INF)
    medium = torch.where(hit.valid, hit.exterior_med,
                         scene.meta.camera_medium_id)
    t_hit = torch.where(hit.valid, sg(distance(hit.position, org)), INF)

    sigma_s = get_sigma_s(scene, medium, sg(hit.position))
    sigma_a = get_sigma_a(scene, medium, sg(hit.position))
    sigma_t = sigma_s + sigma_a

    keys, u = _uniforms(keys, 5)
    t = sg(-torch.log(torch.clamp(1.0 - u[:, 0], min=1e-20)) /
           torch.clamp(sigma_t[:, 0], min=1e-20))

    # scatter before the surface
    trans_pdf_s = sg(torch.exp(-sigma_t * t[:, None]) * sigma_t)
    transmittance_s = torch.exp(-sigma_t * t[:, None])
    p = sg(org + t[:, None] * d)
    light_id = sample_light(scene, u[:, 3])
    lp = sample_point_on_light(scene, light_id, p, u[:, 1:3], u[:, 4])
    if detach:
        lp = LightPoint(*(x.detach() for x in lp))
    dir_light = normalize(lp.position - p)
    rho = phase_eval(scene, medium, -d, dir_light)
    Le = emission_area(scene, light_id, lp.normal, -dir_light)
    dist_l = distance(p, lp.position)
    exp_term = torch.exp(-sigma_t * dist_l[:, None])
    occ = occluded(scene, p, dir_light, eps_shadow,
                   (1.0 - eps_shadow) * dist_l)
    jac = torch.abs(dot(dir_light, lp.normal)) / torch.clamp(
        distance_squared(p, lp.position), min=1e-20) * \
        torch.where(occ, 0.0, 1.0)
    L_s1 = rho * Le * exp_term * jac[:, None]
    L_s1_pdf = sg(light_pmf(scene, light_id) *
                  pdf_point_on_light(scene, light_id, lp, p))
    scatter_contrib = (transmittance_s / trans_pdf_s) * sigma_s * \
        (L_s1 / torch.clamp(L_s1_pdf, min=1e-30)[:, None])

    # reach the surface. In detach mode a miss (t_hit = inf) must not
    # reach exp(-σ·inf): it is the branch not taken, but the σ gradient
    # would be -inf·exp(-inf) = NaN (see _advance_lane's sanitizing
    # note); the branch taken is the same.
    t_hit_e = torch.where(torch.isfinite(t_hit), t_hit, 0.0) \
        if detach else t_hit
    trans_pdf_h = sg(torch.exp(-sigma_t * t_hit_e[:, None]))
    transmittance_h = torch.exp(-sigma_t * t_hit_e[:, None])
    Le_h = torch.where((hit.valid & (hit.light_id >= 0))[:, None],
                       emission_area(scene, hit.light_id,
                                     hit.geometry_normal, -d), 0.0)
    surf_contrib = transmittance_h / torch.clamp(trans_pdf_h, min=1e-30) * \
        Le_h

    return torch.where((t < t_hit)[:, None], scatter_contrib, surf_contrib)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def stream_root(seed):
    """The volpath stream root su = pcg(seed ^ 0x701A77E5), handed
    pre-hashed to the camera and to every vertex hash."""
    return pcg_hash((int(seed) & M32) ^ _SEED_SALT)


def _fresh_state(scene, options, item, su, machine):
    """Lane state of newly (re)generated work items `item`: VOL_STATE
    without `done`, and for the event machine EVENT_STATE's further
    fields (without `done`)."""
    meta = scene.meta
    dev = item.device
    k = item.shape[0]
    _pix, org, dd = _primary_hash(scene, options, item, su)
    ones3 = torch.ones((k, 3), device=dev)
    z3 = torch.zeros((k, 3), device=dev)
    z1 = torch.zeros(k, device=dev)
    zi = torch.zeros(k, dtype=torch.int64, device=dev)
    zm = torch.zeros(k, dtype=torch.int32, device=dev)
    zb = torch.zeros(k, dtype=torch.bool, device=dev)
    path = (item, org, dd,
            torch.full((k,), meta.camera_medium_id, dtype=torch.int32,
                       device=dev),
            ones3, z3, zi, z1, org, ones3, z1 + 1.0,
            torch.full((k,), 0.25 / max(meta.width, meta.height),
                       device=dev), z1)
    if not machine:
        return path
    return path + (
        torch.full((k,), PH_CAST, dtype=torch.int64, device=dev),
        torch.full((k,), INF, device=dev), zm, z1, z1, zb,
        zi, z1, zi, ones3, ones3, ones3, zb, zb,
        org, dd, zm, zi, ones3, ones3, ones3, org,
        zi, z3, z1, z1, ones3,
        z1, zb, zb, zb, zm,
        zb)


def _render_volpath_block(scene, options, seed, s0, nspp, lanes=None):
    """The general engines' persistent-wavefront queue over (pixel,
    sample) work items [s0·n, (s0 + nspp)·n). Returns (film_sum (n, 3),
    final state, loop iterations).

    Scenes with grid volumes advance by the flat event machine
    (_advance_event), the others by one bounce per iteration
    (_advance_vol_lane), as lajolla_tpu selects them. The queue has no
    padded stride: lane k starts at item s0·n + k and takes item + lanes
    when its path ends, and an item belongs to pixel item % n —
    lajolla_tpu's items, so its random numbers. A lane whose path ended
    adds its radiance to its pixel (index_add_; a sample with any
    non-finite channel is dropped whole, render.cpp:140-143) and takes
    the next item. `done.all()` is read back to the host every
    iteration."""
    meta = scene.meta
    n = meta.width * meta.height
    lanes = lanes or n
    su = stream_root(seed)
    end = (s0 + nspp) * n
    _check_items(end)
    dev = scene.med_tab.device
    machine = meta.has_grid_volumes
    advance = _advance_event if machine else _advance_vol_lane

    st = _fresh_state(scene, options, torch.arange(lanes, device=dev) +
                      s0 * n, su, machine) + (
        torch.zeros(lanes, dtype=torch.bool, device=dev),)
    film = torch.zeros((n, 3), device=dev)
    iters = 0
    while not bool(st[-1].all()):
        nst, died = advance(scene, options, st, su)
        item, L, done = nst[0], nst[5], nst[-1]
        fin = torch.isfinite(L).all(dim=-1)
        film.index_add_(0, item % n,
                        torch.where((died & fin)[:, None], L, 0.0))

        next_item = item + lanes
        has_more = next_item < end
        regen = died & has_more
        done = done | (died & ~has_more)
        fresh = _fresh_state(scene, options, next_item, su, machine)
        st = tuple(torch.where(regen if f.dim() == 1 else regen[:, None], f,
                               cur)
                   for f, cur in zip(fresh, nst[:-1])) + (done,)
        iters += 1
    return film, st, iters


_TRACERS = {1: volpath1_trace_one, 2: volpath2_trace_one}


def _simple_pixels(scene, p0, tile):
    """(pixel words, px, py) of pixels p0 .. p0 + tile, the pixel index a
    32-bit word as lajolla_tpu's uint32 index."""
    w = scene.meta.width
    pix = (torch.arange(tile, device=scene.med_tab.device) + p0) & M32
    return pix, pix % w, pix // w


def _render_volpath_simple_block(scene, options, seed, s0, nspp, p0=0,
                                 tile=None):
    """The per-pixel driver of the single-bounce versions 1 and 2: the
    (tile, 3) film sum of samples s0 .. s0 + nspp of pixels p0 .. p0 +
    tile (default: the whole film). A pixel's keys are
    fold_in(prng_key(seed), pixel), a sample's fold_in(pixel keys,
    sample); a non-finite channel of a sample adds 0 (per channel, as
    lajolla_tpu's jnp.where(isfinite(L), L, 0))."""
    tile = tile or scene.meta.width * scene.meta.height
    pix, px, py = _simple_pixels(scene, p0, tile)
    pixel_keys = rnd.fold_in(rnd.prng_key(seed, pix.device), pix)
    tracer = _TRACERS[options.vol_path_version]
    img = torch.zeros((tile, 3), device=pix.device)
    for i in range(nspp):
        keys = rnd.fold_in(pixel_keys, s0 + i)
        L = tracer(scene, options, px, py, keys)
        img = img + torch.where(torch.isfinite(L), L, 0.0)
    return img


def _use_vol_kernel(scene):
    """lajolla_tpu's dispatch without its TPU-backend test: the scene is
    inside volpath_kernel.supports and the film is whole 4096-pixel
    blocks."""
    from lajolla_tpu_torch.integrators import volpath_kernel  # imports us
    n = scene.meta.width * scene.meta.height
    return volpath_kernel.supports(scene.meta) and \
        n % volpath_kernel.BLOCK == 0


def _use_grid_kernel(scene):
    """lajolla_tpu's dispatch without its TPU-backend test: the scene is
    inside volpath_grid_kernel.supports (any film: K9 pads its lane pool
    to whole blocks)."""
    from lajolla_tpu_torch.integrators import volpath_grid_kernel
    return volpath_grid_kernel.supports(scene.meta)


def render_volpath_samples(scene, options, seed, s_begin, s_end, film=None,
                           on_block=None):
    """The film sum (h, w, 3), on the scene's device, of samples s_begin ..
    s_end of every pixel. Versions 1 and 2 take
    _render_volpath_simple_block in blocks of VOL_SPP_BLOCK samples per
    pixel (1 in a scene with grid volumes, as lajolla_tpu sets them); the
    final integrator's scenes of _use_grid_kernel take K9 in blocks of
    GRIDK_SPP_BLOCK samples per pixel, scenes of _use_vol_kernel K8 in
    blocks of VOLK_SPP_BLOCK; the rest take the general engines: grid
    scenes the event machine on min(GRID_LANES, n) lanes one sample per
    pixel at a time, the others min(VOL_LANES, n) lanes in blocks of
    VOL_SPP_BLOCK. A failing K8 or K9 raises: there is no fallback to the
    general engines. Blocks start at s_begin and are added onto `film`
    (default: the first block) in sample order, `on_block(film, samples
    done)` called after each. Every engine keys its random numbers on the
    sample index, so ranges that split [0, spp) draw one render's numbers
    (parallel/mesh.py). Each block is the span `volpath.block`."""
    from lajolla_tpu_torch.integrators import (volpath_grid_kernel,
                                               volpath_kernel)
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    simple = options.vol_path_version in (1, 2)
    grid = scene.meta.has_grid_volumes
    lanes = min(GRID_LANES if grid else VOL_LANES, n)
    use_gridk = not simple and _use_grid_kernel(scene)
    use_kernel = not simple and not use_gridk and _use_vol_kernel(scene)
    spp_block = (GRIDK_SPP_BLOCK if use_gridk else
                 VOLK_SPP_BLOCK if use_kernel else
                 1 if grid else VOL_SPP_BLOCK)
    s0 = s_begin
    while s0 < s_end:
        ns = min(spp_block, s_end - s0)
        with profiling.span('volpath.block'):
            if simple:
                block = _render_volpath_simple_block(scene, options, seed,
                                                     s0, ns)
            elif use_gridk:
                block = volpath_grid_kernel.render_fused_grid(
                    scene, options, seed, s0, ns)
            elif use_kernel:
                block = volpath_kernel.render_fused_vol(scene, options, seed,
                                                        s0, ns)
            else:
                block, _, _ = _render_volpath_block(scene, options, seed, s0,
                                                    ns, lanes)
            block = block.reshape(h, w, 3)
            film = block if film is None else film + block
        s0 += ns
        if on_block is not None:
            on_block(film, s0)
    if film is None:
        film = torch.zeros((h, w, 3), device=scene.med_tab.device)
    return film


def render_volpath(scene, options, seed=0, checkpoint=None, progress=False):
    """Block-accumulating driver of render_volpath_samples on the scene's
    device → (h, w, 3) numpy image. `checkpoint` persists (film sum,
    samples done, seed) after every block, as render_path does. The film's
    return to the host is the spans `render.film_wait` (the device's queued
    work, while the recorder is on) and `render.film_copy`."""
    from lajolla_tpu_torch.utils.checkpoint import load_film, save_film
    from lajolla_tpu_torch.utils.progress import ProgressReporter
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    spp = options.samples_per_pixel
    img, s0 = None, 0
    if checkpoint:
        img, s0 = load_film(checkpoint, seed, (n, 3))
    rep = ProgressReporter(spp, label="volpath", enabled=progress)
    rep.done = s0

    def on_block(film, done):
        rep.update(done - rep.done)
        if checkpoint:
            save_film(checkpoint, seed, film.reshape(n, 3).cpu().numpy(),
                      done)

    film = None if img is None else torch.from_numpy(img).reshape(
        h, w, 3).to(scene.med_tab.device)
    film = render_volpath_samples(scene, options, seed, s0, spp, film,
                                  on_block)
    rep.finish()
    profiling.sync('render.film_wait', film.device)
    with profiling.span('render.film_copy'):
        return return_film(film, spp)
