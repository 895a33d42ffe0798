"""The fused volumetric path tracer for one uniform homogeneous medium
(kernel K8): plain PyTorch form + CUDA kernel.

Port of lajolla_tpu/integrators/volpath_kernel.py. The scene class
(`supports`) is one homogeneous medium bound to the camera and to every
shape's exterior, with opaque surfaces only: the medium never changes
along a path, the free flight is closed-form, and the shadow ray's
transmittance is one exact exponential. One launch renders nspp samples
of every pixel: camera ray, closest hit, free flight, emission MIS with
the cached NEE origin, one merged NEE (shadow any-hit + analytic
transmittance), isotropic or HG phase / BSDF sampling, Russian roulette,
the film add and regeneration from the next work item. Lane == pixel, so
work item i = pixel + k·n belongs to pixel i % n.

The estimator is the general homogeneous engine's
(volpath._advance_vol_lane) with the class facts folded in, drawing the
same counter-hash cells; the fork quirks stay (a bounce-0 emissive hit
ends the path; surface bounces do not refresh dir_pdf / mtp).

`_advance_vol_core` is the plain form, in lajolla_tpu's (row, N) layout:
every quantity a (1, N) row or a (3, N) block, the one-hot `_rows`
gathers of the TPU kernel replaced by index gathers masked to zero on a
miss. It is the reference the CUDA kernel (csrc/volpath_kernels.cu
`render_fused_vol_kernel`) is held against. `render_fused_vol` is the
wrapper: CPU scenes run `render_fused_vol_plain`, CUDA scenes launch the
kernel, and anything else raises.

The kernel runs persistent warps that take work items in id order and
write each item's radiance to a per-item buffer, which
`film_sum_kernel` sums per pixel in sample order (`film_sum_plain` is its
plain form, shared with K9). A path's radiance is a function of its work
item alone (every draw is a counter-hash cell of the item), so the film
does not depend on which lane ran an item or when: `vol_items_plain`
computes the radiance of any list of items, and its sum by
`film_sum_plain` is `render_fused_vol_plain`'s film bit for bit.
"""

import torch

from lajolla_tpu_torch.core.math import normalize3
from lajolla_tpu_torch.core.random import pcg_hash
from lajolla_tpu_torch.integrators.media import (INV_4PI, MT_G, MT_SA,
                                                 MT_SS, TWO_PI)
from lajolla_tpu_torch.integrators.path import _check_items
from lajolla_tpu_torch.integrators.path_kernel import (
    _cone_pdf_area, _dot3, _eval_pdf_dispatch, _intersect, _occluded, _onb,
    _sample_dispatch, _sphere_anyhit, _sphere_closest, _where3, statics)
from lajolla_tpu_torch.integrators.volpath import (MAX_BOUNCES_CAP,
                                                   _S_BSDF, _S_FF, _S_NEE,
                                                   _S_NEE_SEG, _S_PHASE,
                                                   _S_RR, _S_SURF_NEE,
                                                   _salt, _u, _uit,
                                                   stream_root)
from lajolla_tpu_torch.scene.camera import camera_record, sample_primary_t
from lajolla_tpu_torch.scene.types import (MAT_LAMBERTIAN, MAT_ROUGH_PLASTIC,
                                           PHASE_HG, PHASE_ISOTROPIC)

# Films of whole BLOCKs of pixels take this kernel (volpath._use_vol_kernel).
BLOCK = 4096
INF = float('inf')


def supports(meta):
    kernel_mats = {MAT_LAMBERTIAN, MAT_ROUGH_PLASTIC}
    return (meta.uniform_medium and
            set(meta.mat_types_present) <= kernel_mats and
            len(meta.mat_types_present) >= 1 and
            set(meta.phase_types_present) <= {PHASE_ISOTROPIC, PHASE_HG} and
            len(meta.phase_types_present) == 1 and
            not meta.has_envmap and
            not meta.needs_uv and
            not meta.use_bvh and
            meta.num_triangles >= 1 and
            meta.num_lights >= 1)


def medium(scene):
    """(sigma_a (3,), sigma_s (3,), g ()) of the class's one medium, f32
    tensors on the scene's device."""
    row = scene.med_tab[0]
    return row[MT_SA:MT_SA + 3], row[MT_SS:MT_SS + 3], row[MT_G]


def _pick_ch(ch, v3):
    """(1, N) channel -> per-lane component of a (3, N) or (3, 1) block."""
    return torch.where(ch == 0, v3[0:1],
                       torch.where(ch == 1, v3[1:2], v3[2:3]))


def _hg_row(g, c):
    """The Henyey-Greenstein lobe with the 1.5 power as t·sqrt(t), as K8
    writes it (the general engine writes `** 1.5`: ulp-level apart)."""
    t = torch.clamp(1.0 + g * g + 2.0 * g * c, min=1e-20)
    return INV_4PI * (1.0 - g * g) / torch.clamp(t * torch.sqrt(t),
                                                 min=1e-20)


def _avg3(v3):
    return (v3[0:1] + v3[1:2] + v3[2:3]) / 3.0


def _max3(v3):
    return torch.maximum(torch.maximum(v3[0:1], v3[1:2]), v3[2:3])


# ---------------------------------------------------------------------------
# One bounce, row form (mirrors volpath._advance_vol_lane statement by
# statement, with the class facts folded in)
# ---------------------------------------------------------------------------

def _advance_vol_core(scene, o, d, thr, rad, bounces, dir_pdf, mtp, nee_p,
                      act_in, hb, sa3, ss3, g, *, hg, eps_isect, eps_shadow,
                      max_depth, rr_depth, max_cap):
    """o, d, thr, rad, mtp, nee_p: (3, N); bounces (1, N) int64; dir_pdf
    (1, N); act_in (1, N) bool; hb (1, N) per-(item, bounce) stream roots;
    sa3 / ss3 (3, 1) sigma_a / sigma_s; g (1, 1) HG asymmetry, read when
    the static `hg` says the medium's phase is HG. Returns (org', d',
    thr', rad', dir_pdf', mtp', nee_p', alive)."""
    meta = scene.meta
    mats = meta.mat_types_present
    S = meta.num_spheres
    T = scene.fp_tri.shape[1]
    L = scene.fp_light.shape[1]
    tri, light, sph = scene.fp_tri, scene.fp_light, scene.fp_sph
    qf = scene.cast_quad if meta.has_quads else None
    qf_occ = scene.cast_occ_quad if meta.has_quads else None
    st3 = sa3 + ss3                                       # sigma_t (3, 1)
    max_maj = torch.clamp(_max3(st3), min=1e-20)
    ones3 = torch.ones_like(thr)

    # ---- closest hit (triangles + spheres) --------------------------------
    t_tri, idx, found, ub, vb, qb = _intersect(o, d, eps_isect,
                                               scene.fp_woop, qf)
    if S:
        t_sph, srows = _sphere_closest(o, d, eps_isect, sph)
        sph_win = t_sph < t_tri
        t_hit = torch.minimum(t_tri, t_sph)
    else:
        sph_win = torch.zeros_like(found)
        t_hit = t_tri
    valid = t_hit < INF
    prim = scene.cast_src[idx]
    if qf is not None:
        back = (qb > 0.0) & (ub + vb > 1.0)
        prim = torch.where(back, scene.cast_alt[idx], prim)
        ub, vb = (torch.where(back, 1.0 - vb, ub),
                  torch.where(back, ub + vb - 1.0, vb))
    rows = torch.where(found, tri[:, prim[0].long()], 0.0)     # (40, N)

    # ---- closed-form free flight: ONE tracking step ------------------------
    hs_ff = _salt(hb, _S_FF)
    ch = torch.clamp((_u(hs_ff, 0) * 3.0).to(torch.int64), 0, 2)
    st_ch = _pick_ch(ch, st3)
    guard = st_ch > 0.0                  # maj0_ch > 0 loop guard
    u0 = _uit(hs_ff, 0, 0)
    u1 = _uit(hs_ff, 0, 1)
    t_s = torch.where(guard, -torch.log(torch.clamp(1.0 - u0, min=1e-20)) /
                      torch.clamp(st_ch, min=1e-20), INF)
    in_flight = t_s < t_hit              # t_hit may be +inf
    # real_prob of the sampled channel is 1 wherever guard holds
    real_ch = st_ch / torch.clamp(st_ch, min=1e-20)
    is_real = u1 < real_ch
    scatter = guard & in_flight & is_real
    t_cl = torch.clamp(torch.where(in_flight, t_s, t_hit), max=1e30)
    att = torch.exp(-st3 * t_cl)         # (3, N): exp(-sigma_t * advance)
    trans = torch.where(guard, torch.where(in_flight, att / max_maj, att),
                        ones3)
    tdp = torch.where(guard,
                      torch.where(in_flight, att * st3 * real_ch / max_maj,
                                  att), ones3)
    mtp = mtp * tdp                      # always in the medium

    t_adv = torch.where(scatter, t_cl, torch.where(valid, t_hit, 0.0))
    px = o[0:1] + t_adv * d[0:1]
    py = o[1:2] + t_adv * d[1:2]
    pz = o[2:3] + t_adv * d[2:3]
    thr = thr * trans / torch.clamp(_avg3(tdp), min=1e-30)
    active = act_in
    # the vacuum-miss discard is unreachable: always in the medium

    # ---- hit shading data -------------------------------------------------
    ngx = rows[4:5] * rows[8:9] - rows[5:6] * rows[7:8]
    ngy = rows[5:6] * rows[6:7] - rows[3:4] * rows[8:9]
    ngz = rows[3:4] * rows[7:8] - rows[4:5] * rows[6:7]
    ngx, ngy, ngz = normalize3(ngx, ngy, ngz)
    wb = 1.0 - ub - vb
    snx = wb * rows[9:10] + ub * rows[12:13] + vb * rows[15:16]
    sny = wb * rows[10:11] + ub * rows[13:14] + vb * rows[16:17]
    snz = wb * rows[11:12] + ub * rows[14:15] + vb * rows[17:18]
    snx, sny, snz = _where3(rows[18:19] > 0, (snx, sny, snz),
                            (ngx, ngy, ngz))
    snx, sny, snz = normalize3(snx, sny, snz)
    flip_g = _dot3(ngx, ngy, ngz, snx, sny, snz) < 0
    ngx, ngy, ngz = _where3(flip_g, (-ngx, -ngy, -ngz), (ngx, ngy, ngz))
    if S:
        inv_r = 1.0 / torch.clamp(srows[3:4], min=1e-20)
        sng = normalize3((px - srows[0:1]) * inv_r, (py - srows[1:2]) * inv_r,
                     (pz - srows[2:3]) * inv_r)
        ngx, ngy, ngz = _where3(sph_win, sng, (ngx, ngy, ngz))
        snx, sny, snz = _where3(sph_win, sng, (snx, sny, snz))

    def pick(tri_row, sph_row, sph_scale=1.0):
        if not S:
            return rows[tri_row:tri_row + 1]
        return torch.where(sph_win, srows[sph_row:sph_row + 1] * sph_scale,
                           rows[tri_row:tri_row + 1])
    h_light = pick(19, 4)
    le = (pick(23, 15), pick(24, 16), pick(25, 17))
    h_pmf = pick(27, 14)
    h_inv_area = pick(26, 14, 0.0)
    kd = (pick(20, 6), pick(21, 7), pick(22, 8))
    if mats != (MAT_LAMBERTIAN,):
        mt = pick(28, 5)
        ks = (pick(29, 9), pick(30, 10), pick(31, 11))
        rough = torch.clamp(pick(32, 12), 0.01, 1.0)
        eta = pick(33, 13)
    else:
        mt = ks = rough = eta = None

    wi = (-d[0:1], -d[1:2], -d[2:3])

    # ---- emissive hit + MIS with the cached NEE-origin pdf (:652-711) -----
    hit_light = active & ~scatter & valid & (h_light >= 0)
    one_sided = _dot3(ngx, ngy, ngz, *wi) > 0
    le = tuple(torch.where(one_sided, x, 0.0) for x in le)
    dpx = px - nee_p[0:1]
    dpy = py - nee_p[1:2]
    dpz = pz - nee_p[2:3]
    dist2p = torch.clamp(dpx * dpx + dpy * dpy + dpz * dpz, min=1e-20)
    jac_e = torch.clamp(_dot3(d[0:1], d[1:2], d[2:3], ngx, ngy, ngz),
                        min=0.0) / dist2p
    p1e = h_pmf * h_inv_area                           # tnp == 1
    if S:
        p1e_s = h_pmf * _cone_pdf_area(
            (srows[0:1], srows[1:2], srows[2:3]), srows[3:4],
            (nee_p[0:1], nee_p[1:2], nee_p[2:3]), (px, py, pz),
            (ngx, ngy, ngz), (d[0:1], d[1:2], d[2:3]), dist2p)
        p1e = torch.where(sph_win, p1e_s, p1e)
    p2e = dir_pdf * mtp * jac_e                        # (3, N) channel MIS
    w_l = (p2e * p2e) / torch.clamp(p2e * p2e + p1e * p1e, min=1e-30)
    first = bounces == 0
    w_l = torch.where(first, 1.0, w_l)
    add = torch.where(hit_light, w_l, 0.0)
    rad = rad + thr * torch.cat(le, dim=0) * add
    # fork quirk: a bounce-0 emissive hit returns at once (:668)
    active = active & ~(hit_light & first)

    # index-matching pass-through is unreachable: all surfaces opaque
    if max_depth != -1:
        depth_stop = bounces >= (max_depth - 1)
        active_work = active & ~depth_stop
        active = active & ~depth_stop
    else:
        active_work = active
    active = active & (scatter | valid)
    do_scatter = active_work & scatter
    do_surface = active_work & ~scatter & valid

    # ---- merged NEE: ONE shadow segment, analytic transmittance -----------
    hb_eff = torch.where(do_surface, _salt(hb, _S_SURF_NEE), hb)
    hs_n = _salt(hb_eff, _S_NEE)
    un0, un1, un2, un3 = (_u(hs_n, k) for k in range(4))
    lsel = (light[0][:, None] < un2).sum(dim=0).clamp(max=L - 1)
    lrow = light[:, lsel]                              # (16, N)
    l_pmf = lrow[1:2]
    l_int = (lrow[2:3], lrow[3:4], lrow[4:5])
    p1_area = lrow[5:6]
    key = lrow[6:7] + un3
    tsel = (scene.tri_stair_cdf[:, None] < key).sum(dim=0).clamp(max=T - 1)
    lt = tri[:, tsel]                                  # (40, N)
    a_s = torch.sqrt(torch.clamp(un0, 0.0, 1.0))
    b1 = 1.0 - a_s
    b2 = a_s * un1
    lpx = lt[0:1] + b1 * lt[3:4] + b2 * lt[6:7]
    lpy = lt[1:2] + b1 * lt[4:5] + b2 * lt[7:8]
    lpz = lt[2:3] + b1 * lt[5:6] + b2 * lt[8:9]
    lnx = lt[4:5] * lt[8:9] - lt[5:6] * lt[7:8]
    lny = lt[5:6] * lt[6:7] - lt[3:4] * lt[8:9]
    lnz = lt[3:4] * lt[7:8] - lt[4:5] * lt[6:7]
    lnx, lny, lnz = normalize3(lnx, lny, lnz)
    if S:
        # sphere lights: cone sampling with the inside-uniform fallback
        is_sl = lrow[7:8] > 0
        lcx, lcy, lcz = lrow[8:9], lrow[9:10], lrow[10:11]
        lr = lrow[11:12]
        dcx_ = lcx - px
        dcy_ = lcy - py
        dcz_ = lcz - pz
        d2c = torch.clamp(dcx_ * dcx_ + dcy_ * dcy_ + dcz_ * dcz_, min=1e-20)
        inside = d2c < lr * lr
        zu = 1.0 - 2.0 * un0
        ru = torch.sqrt(torch.clamp(1.0 - zu * zu, min=0.0))
        phiu = TWO_PI * un1
        n_in = (ru * torch.cos(phiu), ru * torch.sin(phiu), zu)
        tcx, tcy, tcz = normalize3(dcx_, dcy_, dcz_)
        ftx, fty, ftz, fbx, fby, fbz = _onb(tcx, tcy, tcz)
        sin_el_max_sq = lr * lr / d2c
        cos_el_max = torch.sqrt(torch.clamp(1.0 - sin_el_max_sq, min=0.0))
        cos_el = (1.0 - un0) + un0 * cos_el_max
        sin_el = torch.sqrt(torch.clamp(1.0 - cos_el * cos_el, min=0.0))
        azim = TWO_PI * un1
        dc = torch.sqrt(d2c)
        ds = dc * cos_el - torch.sqrt(torch.clamp(
            lr * lr - dc * dc * sin_el * sin_el, min=0.0))
        cos_a = (dc * dc + lr * lr - ds * ds) / torch.clamp(2.0 * dc * lr,
                                                            min=1e-20)
        sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
        ca = torch.cos(azim)
        sa_ = torch.sin(azim)
        n_out = (-(sin_a * ca * ftx + sin_a * sa_ * fbx + cos_a * tcx),
                 -(sin_a * ca * fty + sin_a * sa_ * fby + cos_a * tcy),
                 -(sin_a * ca * ftz + sin_a * sa_ * fbz + cos_a * tcz))
        lns = _where3(inside, n_in, n_out)
        lpx, lpy, lpz = _where3(is_sl, (lcx + lr * lns[0], lcy + lr * lns[1],
                                        lcz + lr * lns[2]), (lpx, lpy, lpz))
        lnx, lny, lnz = _where3(is_sl, lns, (lnx, lny, lnz))

    dlx = lpx - px
    dly = lpy - py
    dlz = lpz - pz
    dist2 = torch.clamp(dlx * dlx + dly * dly + dlz * dlz, min=1e-20)
    dlx, dly, dlz = normalize3(dlx, dly, dlz)
    dist = torch.sqrt(dist2)
    if S:
        p1_sph = _cone_pdf_area((lcx, lcy, lcz), lr, (px, py, pz),
                                (lpx, lpy, lpz), (lnx, lny, lnz),
                                (dlx, dly, dlz), dist2)
        p1_area = torch.where(is_sl, p1_sph, p1_area)

    sh_o = torch.cat([px, py, pz], dim=0)
    sh_d = torch.cat([dlx, dly, dlz], dim=0)
    sh_far = (1.0 - eps_shadow) * dist
    # media scenes keep the FULL occluder table (scene/compile.py): scatter
    # points can lie outside the geometry's hull
    occ = _occluded(sh_o, sh_d, eps_shadow, sh_far, scene.fp_woop_occ,
                    qf_occ)
    if S:
        occ = occ | _sphere_anyhit(sh_o, sh_d, eps_shadow, sh_far, sph)

    # the segment's NEE free flight: residual rate 0, so it reaches its
    # end with trans = pd = exp(-sigma_t dist), pn = 1 — unless its own
    # sampled channel has sigma_t 0, where the loop guard keeps all at 1
    hseg = pcg_hash(hs_n ^ _salt(0, _S_NEE_SEG))
    seg_ch = torch.clamp((_u(hseg, 0) * 3.0).to(torch.int64), 0, 2)
    seg_guard = _pick_ch(seg_ch, st3) > 0.0
    Tl = torch.where(seg_guard, torch.exp(-st3 * dist), ones3)
    pd_t = Tl                                          # trans_dir_pdf
    ok = ~occ & (_max3(Tl) > 0)

    dl = (dlx, dly, dlz)
    ln_dl = _dot3(*dl, lnx, lny, lnz)
    jac = torch.clamp(-ln_dl, min=0.0) / dist2
    Le_ok = -ln_dl > 0
    pdf_nee = l_pmf * p1_area                          # · pn == 1
    flip_f = _dot3(snx, sny, snz, *wi) < 0
    fn = _where3(flip_f, (-snx, -sny, -snz), (snx, sny, snz))
    ng = (ngx, ngy, ngz)
    f_b, pdf_b_sa = _eval_pdf_dispatch(mats, mt, wi, dl, fn, ng, kd, ks,
                                       rough, eta)
    ok = ok & (~do_surface | (pdf_b_sa > 0))
    # f == pdf for both phases: 1/4pi, or the HG lobe at dot(wi, dl)
    ph_nee = _hg_row(g, _dot3(*wi, *dl)) if hg else INV_4PI
    f3 = torch.cat([torch.where(do_surface, f, ph_nee) for f in f_b], dim=0)
    pdf_dir = torch.where(do_surface, pdf_b_sa, ph_nee) * jac * pd_t
    le3 = torch.where(Le_ok, torch.cat(l_int, dim=0), 0.0)
    contrib = Tl * f3 * le3 * jac / torch.clamp(_avg3(pdf_nee * ones3),
                                                min=1e-30)
    w_n = (pdf_nee * pdf_nee) / torch.clamp(
        pdf_nee * pdf_nee + pdf_dir * pdf_dir, min=1e-30)
    nee_m = torch.where(ok, contrib * w_n, 0.0)
    ss_sel = torch.where(do_scatter, ss3, ones3)
    rad = rad + torch.where(do_scatter | do_surface, thr * ss_sel * nee_m,
                            0.0)

    # ---- phase sampling: uniform sphere, or HG inverse CDF around wi ------
    hph = _salt(hb, _S_PHASE)
    up0 = _u(hph, 0)
    up1 = _u(hph, 1)
    zp = 1.0 - 2.0 * up0
    rp = torch.sqrt(torch.clamp(1.0 - zp * zp, min=0.0))
    php = TWO_PI * up1
    pdir = (rp * torch.cos(php), rp * torch.sin(php), zp)
    if hg:
        g_safe = torch.where(torch.abs(g) < 1e-3, 1.0, g)
        tmp = (g_safe * g_safe - 1.0) / \
            (2.0 * up0 * g_safe - (g_safe + 1.0))
        cos_el = (tmp * tmp - (1.0 + g_safe * g_safe)) / (2.0 * g_safe)
        sin_el = torch.sqrt(torch.clamp(1.0 - cos_el * cos_el, min=0.0))
        az = TWO_PI * up1
        ptx, pty, ptz, pbx, pby, pbz = _onb(*wi)
        sc = sin_el * torch.cos(az)
        ssn = sin_el * torch.sin(az)
        hgd = (sc * ptx + ssn * pbx + cos_el * wi[0],
               sc * pty + ssn * pby + cos_el * wi[1],
               sc * ptz + ssn * pbz + cos_el * wi[2])
        pdir = _where3(torch.abs(g) < 1e-3, pdir, hgd)
        ph_pdf = _hg_row(g, _dot3(*wi, *pdir))
        thr_sc = thr * (ph_pdf / torch.clamp(ph_pdf, min=1e-30)) * ss3
    else:
        ph_pdf = torch.full_like(dir_pdf, INV_4PI)
        thr_sc = thr * ss3                 # f/pdf == 1 for isotropic

    # ---- surface interaction (:786-848) -----------------------------------
    hbs = _salt(hb, _S_BSDF)
    dir_out, samp_valid = _sample_dispatch(mats, mt, wi, fn, ng, kd, ks,
                                           rough, _u(hbs, 0), _u(hbs, 1),
                                           _u(hbs, 2))
    f2, p2s = _eval_pdf_dispatch(mats, mt, wi, dir_out, fn, ng, kd, ks,
                                 rough, eta)
    active = active & ~(do_surface & ~(samp_valid & (p2s > 0)))
    # no transmissive material in the class: eta_scale stays 1
    thr_sf = thr * torch.cat(f2, dim=0) / torch.clamp(p2s, min=1e-30)

    # nee cache (:755-760, :806-810)
    pos3 = torch.cat([px, py, pz], dim=0)
    nee_valid = (do_scatter | do_surface) & (_max3(nee_m) > 0)
    nee_p = torch.where(nee_valid, pos3, nee_p)

    # ---- merge branch results ---------------------------------------------
    d_next = torch.where(do_scatter, torch.cat(pdir, dim=0),
                         torch.where(do_surface, torch.cat(dir_out, dim=0),
                                     d))
    thr = torch.where(do_scatter, thr_sc,
                      torch.where(do_surface, thr_sf, thr))
    dir_pdf = torch.where(do_scatter, ph_pdf, dir_pdf)
    mtp = torch.where(do_scatter, 1.0, mtp)

    # ---- russian roulette (:851-862) --------------------------------------
    do_rr = (bounces >= rr_depth) & active
    rr_prob = torch.where(do_rr, torch.clamp(_max3(thr), max=0.95), 1.0)
    u_rr = _u(_salt(hb, _S_RR), 0)
    active = active & ~(do_rr & (u_rr > rr_prob))
    thr = torch.where(do_rr, thr / torch.clamp(rr_prob, min=1e-20), thr)

    active = active & ((bounces + 1) < max_cap)
    return pos3, d_next, thr, rad, dir_pdf, mtp, nee_p, active


def kernel_statics(scene, options):
    """The static parameters of K8 beside the medium: HG or isotropic, and
    path_kernel.statics."""
    return dict(hg=scene.meta.phase_types_present == (PHASE_HG,),
                **statics(scene, options, MAX_BOUNCES_CAP))


def render_fused_vol_plain(scene, options, seed, s0, nspp):
    """The plain form of kernel K8, on any device: (h, w, 3) film sum of
    samples s0..s0+nspp. One lane per pixel: lane p runs items p + k·n,
    k = s0 .. s0+nspp-1, in order, and sums its own film column in sample
    order, dropping a sample with any non-finite channel."""
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    end = (s0 + nspp) * n
    _check_items(end)
    dev = scene.fp_tri.device
    su = stream_root(seed)
    lane = torch.arange(n, device=dev)
    px, py = (lane % w).float(), (lane // w).float()
    cam = camera_record(scene)
    sa, ss, g = medium(scene)
    sa3, ss3, g = sa[:, None], ss[:, None], g.reshape(1, 1)
    kw = kernel_statics(scene, options)

    def camera(item):
        return sample_primary_t(item, px, py, su, cam, w=w, h=h,
                                filter_type=options.filter_type,
                                filter_param=options.filter_param)

    item = lane + s0 * n
    org, d = camera(item)
    bounces = torch.zeros(n, dtype=torch.int64, device=dev)
    thr = torch.ones((3, n), device=dev)
    rad = torch.zeros((3, n), device=dev)
    dir_pdf = torch.zeros((1, n), device=dev)
    mtp = torch.ones((3, n), device=dev)
    nee_p = org
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    film = torch.zeros((3, n), device=dev)
    while not bool(done.all()):
        act = ~done
        hb = pcg_hash(item ^ pcg_hash(bounces ^ su))
        org2, d2, thr2, rad2, dp2, mtp2, np2, alive = _advance_vol_core(
            scene, org, d, thr, rad, bounces[None], dir_pdf, mtp, nee_p,
            act[None], hb[None], sa3, ss3, g, **kw)
        died = act & ~alive[0]
        fin = torch.isfinite(rad2).all(dim=0)
        film = film + torch.where(died & fin, rad2, 0.0)
        next_item = item + n
        has_more = next_item < end
        regen = died & has_more
        done = done | (died & ~has_more)
        rorg, rd = camera(next_item)
        item = torch.where(regen, next_item, item)
        bounces = torch.where(regen, 0, bounces + 1)
        org = torch.where(regen, rorg, org2)
        d = torch.where(regen, rd, d2)
        thr = torch.where(regen, 1.0, thr2)
        rad = torch.where(regen, 0.0, rad2)
        dir_pdf = torch.where(regen, 0.0, dp2)
        mtp = torch.where(regen, 1.0, mtp2)
        nee_p = torch.where(regen, rorg, np2)
    return film.T.reshape(h, w, 3)


def vol_items_plain(scene, options, seed, items):
    """The radiance (N, 3) of the work items `items` (N,) of K8's layout
    (item = pixel + k*n), each traced from its camera ray to its end in
    its own lane, non-finite values kept. Any order, any subset: a path's
    radiance depends on its item alone."""
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    dev = scene.fp_tri.device
    items = torch.as_tensor(items, dtype=torch.int64, device=dev)
    if items.numel():
        _check_items(int(items.max()) + 1)
    su = stream_root(seed)
    pixel = items % n
    px, py = (pixel % w).float(), (pixel // w).float()
    cam = camera_record(scene)
    sa, ss, g = medium(scene)
    sa3, ss3, g = sa[:, None], ss[:, None], g.reshape(1, 1)
    kw = kernel_statics(scene, options)
    m = items.shape[0]
    org, d = sample_primary_t(items, px, py, su, cam, w=w, h=h,
                              filter_type=options.filter_type,
                              filter_param=options.filter_param)
    bounces = torch.zeros(m, dtype=torch.int64, device=dev)
    thr = torch.ones((3, m), device=dev)
    rad = torch.zeros((3, m), device=dev)
    dir_pdf = torch.zeros((1, m), device=dev)
    mtp = torch.ones((3, m), device=dev)
    nee_p = org
    done = torch.zeros(m, dtype=torch.bool, device=dev)
    out = torch.zeros((3, m), device=dev)
    while not bool(done.all()):
        act = ~done
        hb = pcg_hash(items ^ pcg_hash(bounces ^ su))
        org, d, thr, rad, dir_pdf, mtp, nee_p, alive = _advance_vol_core(
            scene, org, d, thr, rad, bounces[None], dir_pdf, mtp, nee_p,
            act[None], hb[None], sa3, ss3, g, **kw)
        died = act & ~alive[0]
        out = torch.where(died, rad, out)
        done = done | died
        bounces = bounces + 1
    return out.T


def film_sum_plain(buf, n, stride, nspp, film=None):
    """The plain form of film_sum_kernel (csrc/volpath_kernels.cu), shared
    by K1, K8 and K9: the film (3, n) of a per-item buffer buf (nspp*stride,
    3), whose column p sums rows s*stride + p, s = 0 .. nspp-1, in sample
    order, dropping a sample with any non-finite channel. Given `film`
    (3, n), the sums start from its values and it is returned, added onto
    in place."""
    acc = torch.zeros((3, n), device=buf.device) if film is None else film
    for s in range(nspp):
        v = buf[s * stride:s * stride + n].T
        acc = acc + torch.where(torch.isfinite(v).all(dim=0), v, 0.0)
    if film is None:
        return acc
    film.copy_(acc)
    return film


def render_fused_vol(scene, options, seed, s0, nspp, counters=None):
    """Render nspp samples/pixel (sample indices s0..s0+nspp) of the full
    film in one kernel launch (and its film sum). Returns the (h, w, 3)
    film sum. CPU scenes run the plain form; CUDA scenes launch the CUDA
    kernel, and anything else raises. `counters`, a dict, receives the
    kernel's SIMT counters (kernels.VOL_COUNTERS); the plain form has
    none."""
    if scene.fp_tri.device.type == 'cpu':
        if counters is not None:
            raise ValueError("SIMT counters come from the CUDA kernel")
        return render_fused_vol_plain(scene, options, seed, s0, nspp)
    from lajolla_tpu_torch import kernels
    w, h = scene.meta.width, scene.meta.height
    film = kernels.render_fused_vol(
        scene, camera_record(scene), medium(scene), stream_root(seed), s0,
        nspp, w=w, h=h, filter_type=options.filter_type,
        filter_param=options.filter_param, counters=counters,
        **kernel_statics(scene, options))
    return film.T.reshape(h, w, 3)
