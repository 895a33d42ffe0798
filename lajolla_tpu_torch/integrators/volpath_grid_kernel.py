"""The fused volumetric path tracer for grid media, the hetvol class
(kernel K9): plain PyTorch form + CUDA kernel.

Port of lajolla_tpu/integrators/volpath_grid_kernel.py. The scene class
(`supports`) is one heterogeneous medium whose density is a mono grid
and whose albedo is constant, with zero supervoxel minorants
(meta.svox_ctrl False), Lambertian and RoughPlastic surfaces and
index-matching interfaces, one phase type, the camera in vacuum or in
medium 0. sigma_t is then a scalar field: the tracking products (trans,
tdp, tnp, mtp, the MIS pdfs) are mono rows, the channel draws are elided
(every channel picks the same value, and the counter-hash draws are
position-independent, so no other draw moves), the control is 0, and
the density at the accepted real collision is latched for the vertex's
sigma_s.

`_advance_grid_core` is the plain form of one event-machine step in
lajolla_tpu's (row, N) layout, statement by statement the general
engine's volpath._advance_event with those facts folded in: one cast,
K_STEPS tracking micro-steps (`_ff_micro`: a supervoxel DDA step,
`_svox_segment`, and a trilinear density read, `_density`), the vertex,
the NEE shadow chain. lajolla_tpu's one-hot MXU fetch of the supervoxel
row and its MXU matmul-gather of the density are index gathers here, the
density a direct fp32 trilinear read of `fp_grid` (x, then y, then z),
which is what lajolla_tpu computes with GRID_BF16 off.
`render_fused_grid_plain` is the persistent-queue driver of lajolla_tpu's
`_kernel`: lane k of the pool of n_q = ceil(n / BLOCK) * BLOCK lanes owns
pixel k and takes work items k + s * n_q, s = s0 .. s0 + nspp - 1, in
order; lanes k >= n start done. Items stride by n_q, so K9 draws the
general engine's numbers only where n is a multiple of BLOCK.

`render_fused_grid` is the wrapper: CPU scenes run the plain form, CUDA
scenes launch the CUDA kernel (csrc/volpath_grid_kernels.cu
`render_fused_grid_kernel`), and anything else raises. The kernel's
persistent warps take work items in id order and write each item's
radiance to a per-item buffer of n_q rows a sample, which
`film_sum_kernel` sums per pixel in sample order; `grid_items_plain`
computes the radiance of any list of items, and its sum by
volpath_kernel.film_sum_plain is `render_fused_grid_plain`'s film bit for
bit.
"""

import torch

from lajolla_tpu_torch.core.math import normalize3
from lajolla_tpu_torch.core.random import pcg_hash
from lajolla_tpu_torch.integrators.media import (INV_4PI, MT_ALOOK, MT_DLOOK,
                                                 MT_G, MT_MAXVAL, MT_SOFF,
                                                 MT_SRES, TWO_PI, VL_CONST,
                                                 VL_PMAX, VL_PMIN, VL_RES)
from lajolla_tpu_torch.integrators.path import _check_items
from lajolla_tpu_torch.integrators.path_kernel import (
    _cone_pdf_area, _dot3, _eval_pdf_dispatch, _intersect, _onb,
    _sample_dispatch, _sphere_closest, _where3, statics)
from lajolla_tpu_torch.integrators.volpath import (MAX_BOUNCES_CAP,
                                                   MAX_SHADOW_SEGMENTS,
                                                   PH_CAST, PH_FF, PH_SHC,
                                                   PH_SHF, _S_BSDF, _S_FF,
                                                   _S_NEE, _S_NEE_SEG,
                                                   _S_PHASE, _S_RR,
                                                   _S_SURF_NEE, _salt, _u,
                                                   _uit, stream_root)
from lajolla_tpu_torch.integrators.volpath_kernel import _hg_row, _max3
from lajolla_tpu_torch.scene.camera import camera_record, sample_primary_t
from lajolla_tpu_torch.scene.types import (MAT_LAMBERTIAN, MAT_ROUGH_PLASTIC,
                                           PHASE_HG, PHASE_ISOTROPIC)

# Lanes per program instance of lajolla_tpu's kernel: the lane pool is
# padded to whole BLOCKs and work items stride by the padded count, so
# BLOCK decides K9's random numbers (whatever block the CUDA kernel uses).
BLOCK = 2048
K_STEPS = 2         # tracking micro-steps per event-machine step
INF = float('inf')


def supports(meta):
    kernel_mats = {MAT_LAMBERTIAN, MAT_ROUGH_PLASTIC}
    return (meta.grid_kernel_ok and
            not meta.svox_ctrl and
            set(meta.mat_types_present) <= kernel_mats and
            set(meta.phase_types_present) <= {PHASE_ISOTROPIC, PHASE_HG} and
            len(meta.phase_types_present) == 1 and
            not meta.has_envmap and
            not meta.needs_uv and
            not meta.use_bvh and
            meta.num_triangles >= 1 and
            meta.num_lights >= 1 and
            meta.camera_medium_id in (-1, 0))


def grid_statics(scene, options):
    """The class's static parameters, read from medium 0's row: the grid
    box (pmin, pmax, Python floats), its node counts res (X, Y, Z), the
    supervoxel grid gres, the density maximum, the albedo, the HG g and
    whether the phase is HG, plus path_kernel.statics and the tracking
    cap."""
    row = scene.med_tab[0].detach().cpu().double().tolist()
    seg = lambda c, k=3: row[c:c + k]   # noqa: E731
    return dict(
        pmin=tuple(seg(MT_DLOOK + VL_PMIN)), pmax=tuple(seg(MT_DLOOK +
                                                            VL_PMAX)),
        res=tuple(int(v) for v in seg(MT_DLOOK + VL_RES)),
        gres=tuple(int(v) for v in seg(MT_SRES)), maxval=row[MT_MAXVAL],
        albedo=tuple(seg(MT_ALOOK + VL_CONST)), g1=row[MT_G],
        hg=scene.meta.phase_types_present == (PHASE_HG,),
        max_null=int(options.max_null_collisions),
        **statics(scene, options, MAX_BOUNCES_CAP))


def svox_table(scene):
    """(2, R) [majorant | empty-skip] columns of medium 0's supervoxels."""
    row = scene.med_tab[0]
    off = int(row[MT_SOFF])
    gx, gy, gz = (int(v) for v in row[MT_SRES:MT_SRES + 3])
    rows = scene.svox_data[off:off + gx * gy * gz]
    return torch.stack([rows[:, 0], rows[:, 3]]).contiguous()


# ---------------------------------------------------------------------------
# Tracking micro-step pieces ((1, N) rows)
# ---------------------------------------------------------------------------

def _slab(o, d, pmin, pmax):
    """(t0 clamped at 0, t1) of rays (3, N) against the static box."""
    t0 = t1 = None
    for ax in range(3):
        sd = torch.where(torch.abs(d[ax:ax + 1]) > 1e-20, d[ax:ax + 1],
                         1e-20)
        tn = (pmin[ax] - o[ax:ax + 1]) / sd
        tf = (pmax[ax] - o[ax:ax + 1]) / sd
        lo, hi = torch.minimum(tn, tf), torch.maximum(tn, tf)
        t0 = lo if t0 is None else torch.maximum(t0, lo)
        t1 = hi if t1 is None else torch.minimum(t1, hi)
    return torch.clamp(t0, min=0.0), t1


def _slab_hit(o, d, tfar, pmin, pmax):
    """Does the ray meet the grid's box within [0, tfar]? (1, N) bool."""
    t0, t1 = _slab(o, d, pmin, pmax)
    return t0 <= torch.minimum(t1, tfar)


def _svox_segment(o, d, t_cur, t_hit, svox2, *, pmin, pmax, gres):
    """Mono volpath._majorant_segment: one DDA step over the supervoxel
    majorant grid with the empty skip. Returns (maj, t_end), (1, N)."""
    t0, t1 = _slab(o, d, pmin, pmax)
    span = torch.clamp(t1 - t0, min=1e-20)
    tq = t_cur + 1e-5 * span
    cell, clo, chi, sd = [], [], [], []
    for ax in range(3):
        sd.append(torch.where(torch.abs(d[ax:ax + 1]) > 1e-20, d[ax:ax + 1],
                              1e-20))
        ext = pmax[ax] - pmin[ax]
        pn = (o[ax:ax + 1] + d[ax:ax + 1] * tq - pmin[ax]) / max(ext, 1e-20)
        c = torch.clamp((pn * float(gres[ax])).to(torch.int64), 0,
                        gres[ax] - 1)
        cf = c.to(torch.float32)
        cell.append(c)
        clo.append(pmin[ax] + cf / float(gres[ax]) * ext)
        chi.append(pmin[ax] + (cf + 1.0) / float(gres[ax]) * ext)
    idx = (cell[2] * gres[1] + cell[1]) * gres[0] + cell[0]
    rowd = svox2[:, torch.clamp(idx[0], 0, svox2.shape[1] - 1)]
    maj_cell, skip = rowd[0:1], rowd[1:2]
    t_exit = None
    for ax in range(3):
        ex = torch.clamp(skip - 1.0, min=0.0) / float(gres[ax]) * \
            (pmax[ax] - pmin[ax])
        tcn = (clo[ax] - ex - o[ax:ax + 1]) / sd[ax]
        tcf = (chi[ax] + ex - o[ax:ax + 1]) / sd[ax]
        hi = torch.maximum(tcn, tcf)
        t_exit = hi if t_exit is None else torch.minimum(t_exit, hi)
    before = t_cur < t0
    after = t_cur >= t1
    maj = torch.where(before | after | (t0 > t1), 0.0, maj_cell)
    t_end = torch.where(before & (t0 <= t1), t0,
                        torch.where(after | (t0 > t1), INF,
                                    torch.maximum(t_exit, tq)))
    return maj, torch.minimum(t_end, t_hit)


def _density(p, grid, *, pmin, pmax, res):
    """Trilinear mono density at points p (3, N) → (1, N): the 8 corners
    read from the (Z*Y, X) grid, interpolated along x, then y, then z;
    zero outside the box (volume.h:45-52)."""
    X, Y, Z = res
    inside = None
    lo, hi, fr = [], [], []
    for ax, nax in enumerate((X, Y, Z)):
        pn = (p[ax:ax + 1] - pmin[ax]) / max(pmax[ax] - pmin[ax], 1e-20)
        ins = (pn >= 0.0) & (pn <= 1.0)
        inside = ins if inside is None else inside & ins
        f = pn * float(nax - 1)
        c0 = torch.clamp(f.to(torch.int64), 0, nax - 1)
        fr.append(f - c0.to(torch.float32))
        lo.append(c0)
        hi.append(torch.clamp(c0 + 1, max=nax - 1))
    (x0, y0, z0), (x1, y1, z1), (dx, dy, dz) = lo, hi, fr

    def along_x(z, y):
        r = z * Y + y
        return grid[r, x0] * (1.0 - dx) + grid[r, x1] * dx

    def along_y(z):
        return along_x(z, y0) * (1.0 - dy) + along_x(z, y1) * dy

    val = along_y(z0) * (1.0 - dz) + along_y(z1) * dz
    return torch.where(inside, torch.clamp(val, min=0.0), 0.0)


def _ff_micro(go, wsc, forg, fdir, f_thit, hs, st, grid, svox2, *, pmin,
              pmax, gres, res, max_null):
    """ONE mono delta / ratio-tracking micro-step (volpath._track_step
    with control 0 and a scalar sigma_t field). st = (accum_t, it, trans,
    tdp, tnp, scatter, done, rho_sc); rho_sc latches the density at the
    accepted real collision (the vertex's sigma_s, :736-739)."""
    (accum_t, it, trans, tdp, tnp, scatter, dn, rho_sc) = st
    live = go & ~dn & (it < max_null)
    maj, t_end = _svox_segment(forg, fdir, accum_t, f_thit, svox2,
                               pmin=pmin, pmax=pmax, gres=gres)
    u0 = _uit(hs, it, 0)
    u1 = _uit(hs, it, 1)
    t = torch.where(maj > 0, -torch.log(torch.clamp(1.0 - u0, min=1e-20)) /
                    torch.clamp(maj, min=1e-20), INF)
    dt = t_end - accum_t
    t_next = torch.minimum(accum_t + t, t_end)
    in_flight = t < dt
    hit_end = ~in_flight & (t_end >= f_thit)
    rho = _density(forg + fdir * t_next, grid, pmin=pmin, pmax=pmax,
                   res=res)
    maxden = torch.clamp(maj, min=1e-20)
    sigma_n = maj * (1.0 - rho / maxden)
    real_prob = rho / maxden
    att = torch.exp(-maj * torch.clamp(t, max=1e30))
    att_dt = torch.exp(-maj * torch.clamp(dt, max=1e30))
    is_real = wsc & (u1 < real_prob)
    trans_n = torch.where(
        in_flight, torch.where(is_real, trans * att / maxden,
                               trans * att * sigma_n / maxden),
        trans * att_dt)
    tdp_n = torch.where(
        in_flight,
        torch.where(is_real, tdp * att * maj * real_prob / maxden,
                    tdp * att * maj * (1.0 - real_prob) / maxden),
        tdp * att_dt)
    tnp_n = torch.where(in_flight,
                        torch.where(is_real, tnp, tnp * att * maj / maxden),
                        tnp * att_dt)
    scatter_n = scatter | (in_flight & is_real)
    dn_n = dn | hit_end | (in_flight & is_real) | \
        (~wsc & (trans_n <= 0)) | (it + 1 >= max_null)
    rho_n = torch.where(scatter_n & ~scatter, rho, rho_sc)
    sel = lambda a, b: torch.where(live, a, b)   # noqa: E731
    return (sel(t_next, accum_t), sel(it + 1, it), sel(trans_n, trans),
            sel(tdp_n, tdp), sel(tnp_n, tnp), sel(scatter_n, scatter),
            sel(dn_n, dn), sel(rho_n, rho_sc))


# ---------------------------------------------------------------------------
# One event-machine step, row form
# ---------------------------------------------------------------------------

# The fields of K9's lane state, in _advance_grid_core's order (the event
# machine's, mono, without the cached main cast: the main ray is cast
# again on every step, deterministically).
GRID_STATE = ('bounces', 'org', 'd', 'med', 'T', 'L', 'dir_pdf', 'nee_p',
              'mtp', 'ph', 'ff_hs', 'ff_t', 'ff_it', 'ff_tr', 'ff_dp',
              'ff_np', 'ff_sc', 'ff_dn', 'ff_rho', 'sh_p', 'sh_dir',
              'sh_med', 'sh_seg', 'sh_T', 'sh_pn', 'sh_pd', 'lp_pos',
              'nb_hs', 'cb', 'pdfb', 'pdfd', 'tsc', 'sg_t', 'sg_valid',
              'sg_opaque', 'sg_dblock', 'sg_mednext', 'v_alive', 'done')


def _advance_grid_core(scene, st, hb, grid, svox2, *, pmin, pmax, res, gres,
                       maxval, albedo, g1, hg, max_null, eps_isect,
                       eps_shadow, max_depth, rr_depth, max_cap):
    """One event-machine step for N lanes: st holds GRID_STATE as (1, N)
    rows and (3, N) blocks (flags bool, ids and counters int64, hash words
    int64 below 2^32); hb (1, N) the (item, bounce) roots. Returns
    (new state, died (1, N))."""
    (bounces, org, d, med, Tt, Ll, dir_pdf, nee_p, mtp, ph,
     ff_hs, ff_t, ff_it, ff_tr, ff_dp, ff_np, ff_sc, ff_dn, ff_rho,
     sh_p, sh_dir, sh_med, sh_seg, sh_T, sh_pn, sh_pd, lp_pos,
     nb_hs, cb, pdfb, pdfd, tsc,
     sg_t, sg_valid, sg_opaque, sg_dblock, sg_mednext,
     v_alive, done) = st
    meta = scene.meta
    mats = meta.mat_types_present
    S = meta.num_spheres
    T = scene.fp_tri.shape[1]
    L = scene.fp_light.shape[1]
    tri, light, sph = scene.fp_tri, scene.fp_light, scene.fp_sph
    qf = scene.cast_quad if meta.has_quads else None
    box = dict(pmin=pmin, pmax=pmax)
    one1 = torch.ones_like(ff_t)
    alive_l = ~done

    in_cast = alive_l & (ph == PH_CAST)
    in_ff = alive_l & (ph == PH_FF)
    in_shc = alive_l & (ph == PH_SHC)
    in_shf = alive_l & (ph == PH_SHF)
    is_sh = in_shc | in_shf
    in_medium = med >= 0

    # ---- one raw cast: the main ray (CAST / FF re-derive its t_hit) or
    # the shadow segment (SHC) -------------------------------------------
    dl3 = lp_pos - sh_p
    dist_l = torch.sqrt(torch.clamp(dl3[0:1] * dl3[0:1] + dl3[1:2] *
                                    dl3[1:2] + dl3[2:3] * dl3[2:3],
                                    min=1e-20))
    co = torch.where(in_shc, sh_p, org)
    cd = torch.where(in_shc, sh_dir, d)
    cnear = torch.where(in_shc, eps_shadow, eps_isect)
    cfar = torch.where(in_shc, (1.0 - eps_shadow) * dist_l, 1e30)
    t_tri, idx, found, ub, vb, qb = _intersect(co, cd, cnear,
                                               scene.fp_woop, qf, cfar)
    if S:
        t_sph, srows = _sphere_closest(co, cd, cnear, sph)
        t_sph = torch.where(t_sph < cfar, t_sph, INF)
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

    hx = co[0:1] + t_hit * cd[0:1]
    hy = co[1:2] + t_hit * cd[1:2]
    hz = co[2:3] + t_hit * cd[2:3]

    ngx = rows[4:5] * rows[8:9] - rows[5:6] * rows[7:8]
    ngy = rows[5:6] * rows[6:7] - rows[3:4] * rows[8:9]
    ngz = rows[3:4] * rows[7:8] - rows[4:5] * rows[6:7]
    ngx, ngy, ngz = normalize3(ngx, ngy, ngz)
    wbw = 1.0 - ub - vb
    snx = wbw * rows[9:10] + ub * rows[12:13] + vb * rows[15:16]
    sny = wbw * rows[10:11] + ub * rows[13:14] + vb * rows[16:17]
    snz = wbw * rows[11:12] + ub * rows[14:15] + vb * rows[17:18]
    snx, sny, snz = _where3(rows[18:19] > 0, (snx, sny, snz),
                            (ngx, ngy, ngz))
    snx, sny, snz = normalize3(snx, sny, snz)
    flip_g = _dot3(ngx, ngy, ngz, snx, sny, snz) < 0
    ngx, ngy, ngz = _where3(flip_g, (-ngx, -ngy, -ngz), (ngx, ngy, ngz))
    if S:
        inv_r = 1.0 / torch.clamp(srows[3:4], min=1e-20)
        sng = normalize3((hx - srows[0:1]) * inv_r, (hy - srows[1:2]) * inv_r,
                     (hz - srows[2:3]) * inv_r)
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
    mat_ok = pick(34, 18) > 0
    int_med = pick(35, 19).to(torch.int64)
    ext_med = pick(36, 20).to(torch.int64)
    if mats != (MAT_LAMBERTIAN,):
        mt = pick(28, 5)
        ks = (pick(29, 9), pick(30, 10), pick(31, 11))
        rough = torch.clamp(pick(32, 12), 0.01, 1.0)
        eta = pick(33, 13)
    else:
        mt = ks = rough = eta = None

    # update_medium from THIS hit (vol_path_tracing.h:149-163)
    differs = int_med != ext_med
    going_out = _dot3(cd[0:1], cd[1:2], cd[2:3], ngx, ngy, ngz) > 0
    crossed = torch.where(going_out, ext_med, int_med)
    med_cross = torch.where(differs, crossed,
                            torch.where(in_shc, sh_med, med))

    # ---- main free-flight start (PH_CAST) -------------------------------
    hs_ff0 = _salt(hb, _S_FF)
    t_hit_main = torch.where(valid, t_hit, INF)
    ff_trivial = (med < 0) | ~_slab_hit(org, d, t_hit_main, **box) | \
        (maxval <= 0)

    # ---- shadow-segment set-up (PH_SHC) ---------------------------------
    seg_next_t = torch.where(valid, t_hit, dist_l)
    sg_opaque_n = valid & mat_ok
    if max_depth != -1:
        sg_dblock_n = valid & ((bounces - 1 + sh_seg + 1) >= max_depth)
    else:
        sg_dblock_n = torch.zeros_like(valid)
    sg_mednext_n = torch.where(differs, crossed, sh_med)
    sg_t = torch.where(in_shc, seg_next_t, sg_t)
    sg_valid = torch.where(in_shc, valid, sg_valid)
    sg_opaque = torch.where(in_shc, sg_opaque_n, sg_opaque)
    sg_dblock = torch.where(in_shc, sg_dblock_n, sg_dblock)
    sg_mednext = torch.where(in_shc, sg_mednext_n, sg_mednext)
    hseg = pcg_hash(nb_hs ^ _salt(sh_seg, _S_NEE_SEG))
    sff_trivial = (sh_med < 0) | \
        ~_slab_hit(sh_p, sh_dir, seg_next_t, **box) | (maxval <= 0)

    # reset the free-flight slots on entry
    entry = in_cast | in_shc
    ff_hs = torch.where(in_cast, hs_ff0, torch.where(in_shc, hseg, ff_hs))
    ff_t = torch.where(entry, 0.0, ff_t)
    ff_it = torch.where(entry, 0, ff_it)
    ff_tr = torch.where(entry, 1.0, ff_tr)
    ff_dp = torch.where(entry, 1.0, ff_dp)
    ff_np = torch.where(entry, 1.0, ff_np)
    ff_sc = ff_sc & ~entry
    ff_dn = (in_cast & ff_trivial) | (in_shc & sff_trivial) | \
        (~entry & ff_dn)

    # ---- K_STEPS tracking micro-steps (all four phases) ------------------
    f_org = torch.where(is_sh, sh_p, org)
    f_dir = torch.where(is_sh, sh_dir, d)
    f_thit = torch.where(is_sh, sg_t, t_hit_main)
    go = in_cast | in_ff | is_sh
    wsc = ~is_sh & in_medium
    fst = (ff_t, ff_it, ff_tr, ff_dp, ff_np, ff_sc, ff_dn, ff_rho)
    for _ in range(K_STEPS):
        fst = _ff_micro(go, wsc, f_org, f_dir, f_thit, ff_hs, fst, grid,
                        svox2, gres=gres, res=res, max_null=max_null, **box)
    (ff_t, ff_it, ff_tr, ff_dp, ff_np, ff_sc, ff_dn, ff_rho) = fst

    ph = torch.where((in_cast | in_ff) & ~ff_dn, PH_FF, ph)
    seg_ff_done = is_sh & ff_dn
    ph = torch.where(is_sh & ~ff_dn, PH_SHF, ph)

    # ---- shadow-segment wrap-up ------------------------------------------
    seg_med = seg_ff_done & (sh_med >= 0)
    sh_T = torch.where(seg_med, sh_T * ff_tr, sh_T)
    sh_pn = torch.where(seg_med, sh_pn * ff_np, sh_pn)
    sh_pd = torch.where(seg_med, sh_pd * ff_dp, sh_pd)
    blocked = sg_opaque | sg_dblock
    cont_chain = seg_ff_done & sg_valid & ~blocked & \
        (sh_seg + 1 < MAX_SHADOW_SEGMENTS)
    sh_med = torch.where(cont_chain, sg_mednext, sh_med)
    sh_p = torch.where(cont_chain, sh_p + sg_t * sh_dir, sh_p)
    sh_seg = torch.where(seg_ff_done, sh_seg + 1, sh_seg)
    ph = torch.where(cont_chain, PH_SHC, ph)
    chain_done = seg_ff_done & ~cont_chain

    # ---- NEE completion ---------------------------------------------------
    ok = ~blocked & (sh_T > 0)
    pdf_nee = pdfb * sh_pn
    contrib = sh_T * cb / torch.clamp(pdf_nee, min=1e-30)
    pdf_dir3 = pdfd * sh_pd
    wmis = (pdf_nee * pdf_nee) / torch.clamp(
        pdf_nee * pdf_nee + pdf_dir3 * pdf_dir3, min=1e-30)
    nee_out = torch.where(ok, contrib * wmis, 0.0)
    Ll = Ll + torch.where(chain_done, tsc * nee_out, 0.0)
    nee_p = torch.where(chain_done & (_max3(nee_out) > 0), org, nee_p)
    cont_ok = v_alive & (bounces < max_cap)
    died_c = chain_done & ~cont_ok
    ph = torch.where(chain_done & cont_ok, PH_CAST, ph)

    # ---- VERTEX (in the step the main free flight ends) -------------------
    vready = (in_cast | in_ff) & ff_dn
    active = vready
    trans = torch.where(in_medium, ff_tr, one1)
    tdp = torch.where(in_medium, ff_dp, one1)
    tnp_v = torch.where(in_medium, ff_np, one1)
    scatter = ff_sc & in_medium
    mtp_v = torch.where(in_medium, mtp * tdp, mtp)

    vacuum_miss = ~in_medium & ~valid
    Ll = torch.where(active & vacuum_miss, 0.0, Ll)
    active = active & ~vacuum_miss

    hpos = torch.cat([hx, hy, hz], dim=0)
    new_org = torch.where(scatter, org + d * ff_t,
                          torch.where(valid, hpos, org))
    T_v = Tt * (trans / torch.clamp(tdp, min=1e-30))
    wi = (-d[0:1], -d[1:2], -d[2:3])

    # emission + MIS against the cached NEE origin (:652-711)
    hit_light = active & ~scatter & valid & (h_light >= 0)
    one_sided = _dot3(ngx, ngy, ngz, *wi) > 0
    le = tuple(torch.where(one_sided, x, 0.0) for x in le)
    dpx = hx - nee_p[0:1]
    dpy = hy - nee_p[1:2]
    dpz = hz - nee_p[2:3]
    dist2p = torch.clamp(dpx * dpx + dpy * dpy + dpz * dpz, min=1e-20)
    jac_e = torch.clamp(_dot3(d[0:1], d[1:2], d[2:3], ngx, ngy, ngz),
                        min=0.0) / dist2p
    p1e = h_pmf * h_inv_area * tnp_v
    if S:
        p1e_s = h_pmf * _cone_pdf_area(
            (srows[0:1], srows[1:2], srows[2:3]), srows[3:4],
            (nee_p[0:1], nee_p[1:2], nee_p[2:3]), (hx, hy, hz),
            (ngx, ngy, ngz), (d[0:1], d[1:2], d[2:3]), dist2p) * tnp_v
        p1e = torch.where(sph_win, p1e_s, p1e)
    p2e = dir_pdf * mtp_v * jac_e
    w_l = (p2e * p2e) / torch.clamp(p2e * p2e + p1e * p1e, min=1e-30)
    first = bounces == 0
    w_l = torch.where(first, 1.0, w_l)
    add = torch.where(hit_light, w_l, 0.0)
    Ll = Ll + T_v * torch.cat(le, dim=0) * add
    active = active & ~(hit_light & first)

    # index-matching pass-through (:716-726)
    pass_through = active & ~scatter & valid & ~mat_ok
    if max_depth != -1:
        depth_stop = bounces >= (max_depth - 1)
    else:
        depth_stop = torch.zeros_like(active)
    active_work = active & ~pass_through & ~depth_stop
    active = active & ~(depth_stop & ~pass_through)
    active = active & (scatter | valid)

    do_scatter = active_work & scatter
    do_surface = active_work & ~scatter & valid
    sigma_s3 = torch.cat([albedo[0] * ff_rho, albedo[1] * ff_rho,
                          albedo[2] * ff_rho], dim=0)

    # phase sampling (:737-784)
    hph = _salt(hb, _S_PHASE)
    up0 = _u(hph, 0)
    up1 = _u(hph, 1)
    zp = 1.0 - 2.0 * up0
    rp = torch.sqrt(torch.clamp(1.0 - zp * zp, min=0.0))
    php = TWO_PI * up1
    pdir = (rp * torch.cos(php), rp * torch.sin(php), zp)
    if hg and abs(g1) >= 1e-3:
        tmp = (g1 * g1 - 1.0) / (2.0 * up0 * g1 - (g1 + 1.0))
        cos_el = (tmp * tmp - (1.0 + g1 * g1)) / (2.0 * g1)
        sin_el = torch.sqrt(torch.clamp(1.0 - cos_el * cos_el, min=0.0))
        az = TWO_PI * up1
        ptx, pty, ptz, pbx, pby, pbz = _onb(*wi)
        sc_ = sin_el * torch.cos(az)
        ssn = sin_el * torch.sin(az)
        pdir = (sc_ * ptx + ssn * pbx + cos_el * wi[0],
                sc_ * pty + ssn * pby + cos_el * wi[1],
                sc_ * ptz + ssn * pbz + cos_el * wi[2])
        ph_pdf = _hg_row(g1, _dot3(*wi, *pdir))
        thr_sc = T_v * (ph_pdf / torch.clamp(ph_pdf, min=1e-30)) * sigma_s3
    elif hg:
        ph_pdf = INV_4PI * one1
        thr_sc = T_v * (ph_pdf / torch.clamp(ph_pdf, min=1e-30)) * sigma_s3
    else:
        ph_pdf = INV_4PI * one1
        thr_sc = T_v * sigma_s3

    # surface interaction (:786-848); no transmissive material in the class
    flip_f = _dot3(snx, sny, snz, *wi) < 0
    fn = _where3(flip_f, (-snx, -sny, -snz), (snx, sny, snz))
    ng = (ngx, ngy, ngz)
    hbs = _salt(hb, _S_BSDF)
    dir_out, samp_valid = _sample_dispatch(mats, mt, wi, fn, ng, kd, ks,
                                           rough, _u(hbs, 0), _u(hbs, 1),
                                           _u(hbs, 2))
    f2, p2s = _eval_pdf_dispatch(mats, mt, wi, dir_out, fn, ng, kd, ks,
                                 rough, eta)
    active = active & ~(do_surface & ~(samp_valid & (p2s > 0)))
    thr_sf = T_v * torch.cat(f2, dim=0) / torch.clamp(p2s, min=1e-30)

    # NEE set-up: light pick, point and direction-independent factors
    with_nee = do_scatter | do_surface
    hb_eff = torch.where(do_surface, _salt(hb, _S_SURF_NEE), hb)
    nb_hs_v = _salt(hb_eff, _S_NEE)
    un0, un1, un2, un3 = (_u(nb_hs_v, k) for k in range(4))
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
    nox, noy, noz = new_org[0:1], new_org[1:2], new_org[2:3]
    if S:
        # sphere lights: cone sampling with the inside-uniform fallback
        is_sl = lrow[7:8] > 0
        lcx, lcy, lcz = lrow[8:9], lrow[9:10], lrow[10:11]
        lr = lrow[11:12]
        dcx_ = lcx - nox
        dcy_ = lcy - noy
        dcz_ = lcz - noz
        d2c = torch.clamp(dcx_ * dcx_ + dcy_ * dcy_ + dcz_ * dcz_, min=1e-20)
        inside_s = d2c < lr * lr
        zu = 1.0 - 2.0 * un0
        ru = torch.sqrt(torch.clamp(1.0 - zu * zu, min=0.0))
        phiu = TWO_PI * un1
        n_in = (ru * torch.cos(phiu), ru * torch.sin(phiu), zu)
        tcx, tcy, tcz = normalize3(dcx_, dcy_, dcz_)
        ftx, fty, ftz, fbx, fby, fbz = _onb(tcx, tcy, tcz)
        sin_el_max_sq = lr * lr / d2c
        cos_el_max = torch.sqrt(torch.clamp(1.0 - sin_el_max_sq, min=0.0))
        cos_el2 = (1.0 - un0) + un0 * cos_el_max
        sin_el2 = torch.sqrt(torch.clamp(1.0 - cos_el2 * cos_el2, min=0.0))
        azim = TWO_PI * un1
        dcn = torch.sqrt(d2c)
        ds = dcn * cos_el2 - torch.sqrt(torch.clamp(
            lr * lr - dcn * dcn * sin_el2 * sin_el2, min=0.0))
        cos_a = (dcn * dcn + lr * lr - ds * ds) / torch.clamp(
            2.0 * dcn * lr, min=1e-20)
        sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
        ca = torch.cos(azim)
        sa_ = torch.sin(azim)
        n_out = (-(sin_a * ca * ftx + sin_a * sa_ * fbx + cos_a * tcx),
                 -(sin_a * ca * fty + sin_a * sa_ * fby + cos_a * tcy),
                 -(sin_a * ca * ftz + sin_a * sa_ * fbz + cos_a * tcz))
        lns = _where3(inside_s, n_in, n_out)
        lpx, lpy, lpz = _where3(is_sl, (lcx + lr * lns[0], lcy + lr * lns[1],
                                        lcz + lr * lns[2]), (lpx, lpy, lpz))
        lnx, lny, lnz = _where3(is_sl, lns, (lnx, lny, lnz))

    dlx = lpx - nox
    dly = lpy - noy
    dlz = lpz - noz
    dist2 = torch.clamp(dlx * dlx + dly * dly + dlz * dlz, min=1e-20)
    dlx, dly, dlz = normalize3(dlx, dly, dlz)
    if S:
        p1_sph = _cone_pdf_area((lcx, lcy, lcz), lr, (nox, noy, noz),
                                (lpx, lpy, lpz), (lnx, lny, lnz),
                                (dlx, dly, dlz), dist2)
        p1_area = torch.where(is_sl, p1_sph, p1_area)
    dl = (dlx, dly, dlz)
    jac_n = torch.clamp(-_dot3(*dl, lnx, lny, lnz), min=0.0) / dist2
    le3 = torch.where(-_dot3(*dl, lnx, lny, lnz) > 0, torch.cat(l_int, dim=0),
                      0.0)
    pdfb_v = l_pmf * p1_area
    f_bs, pdf_bs = _eval_pdf_dispatch(mats, mt, wi, dl, fn, ng, kd, ks,
                                      rough, eta)
    ph_nee = _hg_row(g1, _dot3(*wi, *dl)) if hg and abs(g1) >= 1e-3 \
        else INV_4PI * one1
    f_sel = torch.cat([torch.where(do_surface,
                                   torch.where(pdf_bs > 0, f, 0.0), ph_nee)
                       for f in f_bs], dim=0)
    cb_v = f_sel * le3 * jac_n
    pdfd_v = torch.where(do_surface, pdf_bs, ph_nee) * jac_n
    tsc_v = torch.where(do_scatter, T_v * sigma_s3, T_v)

    # merge the continuation
    d_next = torch.where(scatter & do_scatter, torch.cat(pdir, dim=0), d)
    d_next = torch.where(do_surface, torch.cat(dir_out, dim=0), d_next)
    T_n = torch.where(do_scatter, thr_sc,
                      torch.where(do_surface, thr_sf, T_v))
    medium_n = torch.where(pass_through, med_cross, med)
    dir_pdf_n = torch.where(do_scatter, ph_pdf, dir_pdf)
    mtp_n = torch.where(do_scatter, one1, mtp_v)

    # russian roulette (:851-862); eta_scale is 1 in the class
    do_rr = (bounces >= rr_depth) & active & ~pass_through
    rr_prob = torch.where(do_rr, torch.clamp(_max3(T_n), max=0.95), 1.0)
    u_rr = _u(_salt(hb, _S_RR), 0)
    active = active & ~(do_rr & (u_rr > rr_prob))
    T_n = torch.where(do_rr, T_n / torch.clamp(rr_prob, min=1e-20), T_n)

    # ---- apply the vertex results ----------------------------------------
    v = vready
    med_vertex = med
    org = torch.where(v, new_org, org)
    d = torch.where(v, d_next, d)
    Tt = torch.where(v, T_n, Tt)
    med = torch.where(v, medium_n, med)
    bounces = torch.where(v, bounces + 1, bounces)
    dir_pdf = torch.where(v, dir_pdf_n, dir_pdf)
    mtp = torch.where(v, mtp_n, mtp)
    v_alive = torch.where(v, active, v_alive)

    start = v & with_nee
    sh_p = torch.where(start, new_org, sh_p)
    sh_dir = torch.where(start, torch.cat(dl, dim=0), sh_dir)
    sh_med = torch.where(start, med_vertex, sh_med)
    sh_seg = torch.where(start, 0, sh_seg)
    sh_T = torch.where(start, 1.0, sh_T)
    sh_pn = torch.where(start, 1.0, sh_pn)
    sh_pd = torch.where(start, 1.0, sh_pd)
    lp_pos = torch.where(start, torch.cat([lpx, lpy, lpz], dim=0), lp_pos)
    nb_hs = torch.where(start, nb_hs_v, nb_hs)
    cb = torch.where(start, cb_v, cb)
    pdfb = torch.where(start, pdfb_v, pdfb)
    pdfd = torch.where(start, pdfd_v, pdfd)
    tsc = torch.where(start, tsc_v, tsc)
    ph = torch.where(start, PH_SHC, ph)

    ph = torch.where(v & ~with_nee & active, PH_CAST, ph)
    died_v = v & ~with_nee & ~active

    died = (died_v | died_c) & ~done
    nst = (bounces, org, d, med, Tt, Ll, dir_pdf, nee_p, mtp, ph,
           ff_hs, ff_t, ff_it, ff_tr, ff_dp, ff_np, ff_sc, ff_dn, ff_rho,
           sh_p, sh_dir, sh_med, sh_seg, sh_T, sh_pn, sh_pd, lp_pos,
           nb_hs, cb, pdfb, pdfd, tsc,
           sg_t, sg_valid, sg_opaque, sg_dblock, sg_mednext,
           v_alive, done)
    return nst, died


# ---------------------------------------------------------------------------
# The persistent-queue driver (lajolla_tpu's `_kernel`) and the wrapper
# ---------------------------------------------------------------------------

def _fresh(org, d, cam_med):
    """GRID_STATE of newly generated paths: org, d (3, N)."""
    k = org.shape[1]
    dev = org.device
    z1 = torch.zeros((1, k), device=dev)
    zi = torch.zeros((1, k), dtype=torch.int64, device=dev)
    zb = torch.zeros((1, k), dtype=torch.bool, device=dev)
    one1 = z1 + 1.0
    ones3 = torch.ones((3, k), device=dev)
    z3 = torch.zeros((3, k), device=dev)
    return (zi, org, d, zi + cam_med, ones3, z3, z1, org, one1, zi + PH_CAST,
            zi, z1, zi, one1, one1, one1, zb, zb, z1,
            org, d, zi, zi, one1, one1, one1, org,
            zi, z3, z1, z1, ones3,
            z1, zb, zb, zb, zi,
            zb, zb)


def padded_lanes(n):
    """The lane pool of an n-pixel film: n rounded up to whole BLOCKs."""
    return -(-n // BLOCK) * BLOCK


def render_fused_grid_plain(scene, options, seed, s0, nspp, stats=None):
    """The plain form of kernel K9, on any device: (h, w, 3) film sum of
    samples s0..s0+nspp. Lane k of the padded pool owns pixel k and runs
    items k + s·n_q in order, summing its own film column and dropping a
    sample with any non-finite channel. `stats`, if a dict, receives the
    event-machine step count and the work the kernel does, per film lane
    ('lane_vertices', 'lane_casts', 'lane_track_steps': (n,) int64; a
    tracking step reads the density once) and summed ('steps',
    'vertices', 'casts', 'track_steps')."""
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    n_q = padded_lanes(n)
    end = (s0 + nspp) * n_q
    _check_items(end)
    dev = scene.fp_tri.device
    su = stream_root(seed)
    kw = grid_statics(scene, options)
    svox2 = svox_table(scene)
    res = kw['res']
    grid = scene.fp_grid
    if tuple(grid.shape) != (res[2] * res[1], res[0]):
        raise ValueError(f"fp_grid {tuple(grid.shape)} is not the (Z*Y, X) "
                         f"grid of a {res} medium")
    lane = torch.arange(n_q, device=dev)
    px, py = (lane % w).float(), (lane // w).float()
    cam = camera_record(scene)
    cam_med = int(scene.meta.camera_medium_id)

    def camera(item):
        return sample_primary_t(item, px, py, su, cam, w=w, h=h,
                                filter_type=options.filter_type,
                                filter_param=options.filter_param)

    item = lane + s0 * n_q
    st = _fresh(*camera(item), cam_med)
    done = lane >= n
    film = torch.zeros((3, n_q), device=dev)
    steps = 0
    lane_work = torch.zeros((3, n_q), dtype=torch.int64, device=dev)
    while not bool(done.all()):
        bounces, ph = st[0], st[9]
        hb = pcg_hash(item[None] ^ pcg_hash(bounces ^ su))
        st_in = st[:-1] + (done[None],)
        nst, died = _advance_grid_core(scene, st_in, hb, grid, svox2, **kw)
        if stats is not None:
            # vertices, casts (the kernel casts the main ray once per
            # bounce, where the plain form casts it again every step),
            # tracking steps
            live = ~done[None]
            it0 = st[12]
            lane_work += torch.cat([
                nst[0] != bounces,
                live & (ph != PH_FF) & (ph != PH_SHF),
                torch.where(nst[12] >= it0, nst[12] - it0, nst[12])])
        steps += 1
        died = died[0]
        L = nst[5]
        fin = torch.isfinite(L).all(dim=0)
        film = film + torch.where(died & fin, L, 0.0)
        next_item = item + n_q
        has_more = next_item < end
        regen = died & has_more
        done = done | (died & ~has_more)
        fr = _fresh(*camera(next_item), cam_med)
        st = tuple(torch.where(regen, f, cur) for f, cur in zip(fr, nst))
        item = torch.where(regen, next_item, item)
    if stats is not None:
        work = lane_work[:, :n]
        stats.update(steps=steps, lane_vertices=work[0], lane_casts=work[1],
                     lane_track_steps=work[2], vertices=int(work[0].sum()),
                     casts=int(work[1].sum()), track_steps=int(work[2].sum()))
    return film[:, :n].T.reshape(h, w, 3)


def grid_items_plain(scene, options, seed, items):
    """The radiance (N, 3) of the work items `items` (N,) of K9's layout
    (item = k + s*n_q, lane k < n of the padded pool), each traced from
    its camera ray to its end in its own lane of the event machine,
    non-finite values kept. Any order, any subset: a path's radiance
    depends on its item alone."""
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    n_q = padded_lanes(n)
    dev = scene.fp_tri.device
    items = torch.as_tensor(items, dtype=torch.int64, device=dev)
    if items.numel():
        _check_items(int(items.max()) + 1)
    lane = items % n_q
    if bool((lane >= n).any()):
        raise ValueError("items of padding lanes (lane >= n) have no pixel")
    su = stream_root(seed)
    kw = grid_statics(scene, options)
    svox2 = svox_table(scene)
    px, py = (lane % w).float(), (lane // w).float()
    st = _fresh(*sample_primary_t(items, px, py, su, camera_record(scene),
                                  w=w, h=h, filter_type=options.filter_type,
                                  filter_param=options.filter_param),
                int(scene.meta.camera_medium_id))
    done = torch.zeros(items.shape[0], dtype=torch.bool, device=dev)
    out = torch.zeros((3, items.shape[0]), device=dev)
    while not bool(done.all()):
        hb = pcg_hash(items[None] ^ pcg_hash(st[0] ^ su))
        st, died = _advance_grid_core(scene, st[:-1] + (done[None],), hb,
                                      scene.fp_grid, svox2, **kw)
        died = died[0]
        out = torch.where(died, st[5], out)
        done = done | died
    return out.T


def render_fused_grid(scene, options, seed, s0, nspp, counters=None):
    """Render nspp samples/pixel (sample indices s0..s0+nspp) of the full
    film in one kernel launch (and its film sum); returns the (h, w, 3)
    film sum. CPU scenes run the plain form; CUDA scenes launch the CUDA
    kernel, and anything else raises. `counters`, a dict, receives the
    kernel's SIMT counters (kernels.GRID_COUNTERS); the plain form has
    none."""
    if scene.fp_tri.device.type == 'cpu':
        if counters is not None:
            raise ValueError("SIMT counters come from the CUDA kernel")
        return render_fused_grid_plain(scene, options, seed, s0, nspp)
    from lajolla_tpu_torch import kernels
    w, h = scene.meta.width, scene.meta.height
    kw = grid_statics(scene, options)
    film = kernels.render_fused_grid(
        scene, camera_record(scene), svox_table(scene), stream_root(seed), s0,
        nspp, n_q=padded_lanes(w * h), w=w, h=h,
        filter_type=options.filter_type, filter_param=options.filter_param,
        counters=counters, **kw)
    return film.T.reshape(h, w, 3)
