"""One path vertex for a block of lanes: plain PyTorch form + CUDA kernel.

Port of lajolla_tpu/integrators/path_kernel.py. One advance takes every
lane by one full path vertex: closest hit (Woop casts over the
quad-merged cast table + stable-quadratic spheres), shading normals,
emissive-hit MIS, next-event estimation (light pick by CDF count,
triangle staircase pick or sphere cone sampling) with a division-free
shadow any-hit over the occluder subset, a static material switch
(Lambertian / RoughPlastic) and Russian roulette.

`_advance_core` is the plain form, in lajolla_tpu's (row, B) layout:
every quantity is a (1, B) row or a (3, B) block. It is the reference
the CUDA kernel (csrc/path_advance.cuh `advance_vertex`) is tested
against, and the form that runs on CPU tensors. lajolla_tpu's one-hot
`_rows` matmul gathers become index gathers, masked to zero where
lajolla_tpu's one-hot row would be all zero (a miss).

`advance_kernel_t` is the wrapper: CPU tensors take `advance_plain_t`,
CUDA tensors launch kernel K2 (csrc/path_kernels.cu `advance_kernel`)
and never fall back.
"""

import torch

from lajolla_tpu_torch.core.math import normalize3
from lajolla_tpu_torch.dtypes import intersection_eps, shadow_eps
from lajolla_tpu_torch.scene.types import MAT_LAMBERTIAN, MAT_ROUGH_PLASTIC

INF = float('inf')
PI = 3.141592653589793


def supports(meta):
    kernel_mats = {MAT_LAMBERTIAN, MAT_ROUGH_PLASTIC}
    return (set(meta.mat_types_present) <= kernel_mats and
            len(meta.mat_types_present) >= 1 and
            not meta.has_envmap and
            meta.num_media == 0 and
            not meta.needs_uv and
            not meta.use_bvh and
            meta.num_triangles >= 1 and
            meta.num_lights >= 1)


def statics(scene, options, max_cap):
    """The scalar parameters of an advance, shared by the plain form and
    the kernels."""
    r = scene.meta.scene_radius
    return dict(eps_isect=intersection_eps(r), eps_shadow=shadow_eps(r),
                max_depth=options.max_depth, rr_depth=options.rr_depth,
                max_cap=max_cap)


# ---------------------------------------------------------------------------
# Helpers ((row, B) layout)
# ---------------------------------------------------------------------------

def _contract(A, vec, with_bias):
    """(T, 4) affine rows x (3, B) vectors -> (T, B)."""
    r = (A[:, 0:1] * vec[0:1] + A[:, 1:2] * vec[1:2] +
         A[:, 2:3] * vec[2:3])
    return r + A[:, 3:4] if with_bias else r


def _woop_rows(o, d, W):
    """W: (T, 12) [Ax Ay Az] Woop table. Returns (oz, dz, ox, dx, oy, dy),
    each (T, B): origin and direction in every triangle's unit space."""
    Ax, Ay, Az = W[:, 0:4], W[:, 4:8], W[:, 8:12]
    return (_contract(Az, o, True), _contract(Az, d, False),
            _contract(Ax, o, True), _contract(Ax, d, False),
            _contract(Ay, o, True), _contract(Ay, d, False))


def _woop_tuv(o, d, W):
    """All-triangle Woop transform. Returns (t, u, v), each (T, B). No
    dz == 0 guard: t becomes ±inf/NaN and every hit test compares false
    on NaN, so degenerate rows never hit."""
    oz, dz, ox, dx, oy, dy = _woop_rows(o, d, W)
    t = -oz / dz
    return t, ox + t * dx, oy + t * dy


def _hit_mask(t, u, v, tnear, qf, tfar=None):
    """qf: (T,) quad flags or None — flagged rows accept the
    parallelogram max(u, v) <= 1 instead of the triangle u + v <= 1.
    tfar None: no far bound."""
    lim = 1.0 - u - v
    if qf is not None:
        lim = torch.where(qf[:, None] > 0.0, 1.0 - torch.maximum(u, v), lim)
    m = torch.minimum(torch.minimum(u, v), lim)
    hit = (m >= 0.0) & (t > tnear)
    return hit if tfar is None else hit & (t < tfar)


def _intersect(o, d, tnear, W, qf, tfar=None):
    """Closest Woop hit over the cast table in (tnear, tfar). Returns
    (t_best, idx, found, ub, vb, qb), each (1, B): idx is the first cast
    prim with the least t, and u, v are in the rep triangle's frame (the
    caller remaps u + v > 1 quad hits). Where nothing is hit, t_best is
    inf and ub, vb, qb are 0, as lajolla_tpu's all-zero one-hot row
    gives."""
    t, u, v = _woop_tuv(o, d, W)
    t = torch.where(_hit_mask(t, u, v, tnear, qf, tfar), t, INF)
    t_best, idx = torch.min(t, dim=0, keepdim=True)
    found = t_best < INF
    ub = torch.where(found, u.gather(0, idx), 0.0)
    vb = torch.where(found, v.gather(0, idx), 0.0)
    qb = (torch.zeros_like(ub) if qf is None else
          torch.where(found, qf[idx], 0.0))
    return t_best, idx, found, ub, vb, qb


def _occluder_hits(o, d, tnear, tfar, W, qf):
    """Which occluder each shadow ray hits, division-free. With U = ox*dz
    - oz*dx and V = oy*dz - oz*dy (so u = U/dz, v = V/dz, t = -oz/dz)
    every hit predicate is a sign test after multiplying through by dz:
      u >= 0        <=>  U*dz >= 0
      u + v <= 1    <=>  (U + V - dz)*dz <= 0
      t > tnear     <=>  (-oz - tnear*dz)*dz > 0
      t < tfar      <=>  (-oz - tfar*dz)*dz < 0
    Returns (T, B) bool."""
    oz, dz, ox, dx, oy, dy = _woop_rows(o, d, W)
    w = -oz
    U = ox * dz + w * dx
    V = oy * dz + w * dy
    if qf is None:
        lim_ok = (U + V - dz) * dz <= 0.0
    else:
        lim_ok = torch.where(qf[:, None] > 0.0,
                             torch.maximum((U - dz) * dz, (V - dz) * dz),
                             (U + V - dz) * dz) <= 0.0
    return ((U * dz >= 0.0) & (V * dz >= 0.0) & lim_ok &
            ((w - tnear * dz) * dz > 0.0) & ((w - tfar * dz) * dz < 0.0))


def _occluded(o, d, tnear, tfar, W, qf):
    """Any-hit shadow cast over the occluders (_occluder_hits). Returns
    occ (1, B) bool."""
    return _occluder_hits(o, d, tnear, tfar, W, qf).any(dim=0, keepdim=True)


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _onb(nx, ny, nz):
    """Branch-free Frisvad ONB (core/math.py coordinate_system)."""
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    tx = 1.0 + sign * nx * nx * a
    ty = sign * b
    tz = -sign * nx
    return tx, ty, tz, b, sign + ny * ny * a, -ny


def _where3(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Sphere leaves (stable quadratic, shapes/sphere.inl:15-38; dirs normalized
# so a == 1)
# ---------------------------------------------------------------------------

def _sphere_tuv(o, d, sph, tnear, tfar=None):
    """All-sphere quadratic. sph: (S, 24) with center in cols 0:3, radius
    col 3. Returns t (S, B) with misses at +inf."""
    cx, cy, cz, r = sph[:, 0:1], sph[:, 1:2], sph[:, 2:3], sph[:, 3:4]
    ocx = o[0:1] - cx
    ocy = o[1:2] - cy
    ocz = o[2:3] - cz
    b = 2.0 * (ocx * d[0:1] + ocy * d[1:2] + ocz * d[2:3])
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * torch.where(b >= 0.0, b + sq, b - sq)
    t1 = c / torch.where(torch.abs(q) > 1e-30, q, 1e-30)
    tlo = torch.minimum(q, t1)
    thi = torch.maximum(q, t1)
    ok = disc >= 0.0

    def in_rng(t):
        m = ok & (t > tnear)
        return m if tfar is None else m & (t < tfar)

    t = torch.where(in_rng(tlo), tlo,
                    torch.where(in_rng(thi), thi, INF))
    # radius 0 = padding row: never hits
    return torch.where(r > 0.0, t, INF)


def _sphere_closest(o, d, tnear, sph):
    """Returns (t_best, srows): srows (24, B) is the winning sphere's
    record, zero where no sphere is hit."""
    t_best, idx = torch.min(_sphere_tuv(o, d, sph, tnear), dim=0,
                            keepdim=True)
    return t_best, torch.where(t_best < INF, sph[idx[0]].T, 0.0)


def _sphere_anyhit(o, d, tnear, tfar, sph):
    return _sphere_tuv(o, d, sph, tnear, tfar).amin(dim=0, keepdim=True) < INF


# ---------------------------------------------------------------------------
# Row-form BSDF math (materials/common.py + materials/roughplastic.py of
# lajolla_tpu → reference microfacet.h / materials/roughplastic.inl)
# ---------------------------------------------------------------------------

def _fresnel_dielectric(n_dot_i, eta):
    """microfacet.h:42-56; eta = n_t/n_i; 1 on TIR."""
    n_dot_t_sq = 1.0 - (1.0 - n_dot_i * n_dot_i) / (eta * eta)
    n_dot_t = torch.sqrt(torch.clamp(n_dot_t_sq, min=0.0))
    c = torch.abs(n_dot_i)
    rs = (c - eta * n_dot_t) / (c + eta * n_dot_t)
    rp = (eta * c - n_dot_t) / (eta * c + n_dot_t)
    F = 0.5 * (rs * rs + rp * rp)
    return torch.where(n_dot_t_sq < 0.0, 1.0, F)


def _ggx_d(n_dot_h, roughness):
    alpha = roughness * roughness
    a2 = alpha * alpha
    t = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(PI * t * t, min=1e-20)


def _smith_g1(n_dot_v, roughness):
    """Isotropic Smith G1 from n·v alone (microfacet.h:75-81)."""
    alpha = roughness * roughness
    a2 = alpha * alpha
    z2 = n_dot_v * n_dot_v
    lam = (-1.0 + torch.sqrt(1.0 + (1.0 - z2) * a2 /
                             torch.clamp(z2, min=1e-20))) / 2.0
    return 1.0 / (1.0 + lam)


def _luminance(r, g, b):
    return r * 0.212671 + g * 0.715160 + b * 0.072169


def _rp_eval_pdf(wi, wo, fn, ng, kd, ks, rough, eta):
    """RoughPlastic eval (f·cos) + sample pdf for direction wo.
    Returns (f 3-tuple, pdf)."""
    below = (_dot3(*ng, *wi) < 0) | (_dot3(*ng, *wo) < 0)
    hx, hy, hz = normalize3(wi[0] + wo[0], wi[1] + wo[1], wi[2] + wo[2])
    n_dot_h = _dot3(*fn, hx, hy, hz)
    n_dot_in = _dot3(*fn, *wi)
    n_dot_out = _dot3(*fn, *wo)
    invalid = below | (n_dot_out <= 0) | (n_dot_h <= 0)
    h_dot_out = _dot3(hx, hy, hz, *wo)
    h_dot_in = _dot3(hx, hy, hz, *wi)
    F_o = _fresnel_dielectric(h_dot_out, eta)
    D = _ggx_d(n_dot_h, rough)
    G_in = _smith_g1(n_dot_in, rough)
    G = G_in * _smith_g1(n_dot_out, rough)
    spec_s = (G * F_o * D) / torch.clamp(4.0 * n_dot_in * n_dot_out,
                                         min=1e-20)
    F_i = _fresnel_dielectric(h_dot_in, eta)
    diff_s = (1.0 - F_o) * (1.0 - F_i) / PI
    f = tuple(torch.where(invalid, 0.0, (s * spec_s + k * diff_s) * n_dot_out)
              for s, k in zip(ks, kd))
    lS = _luminance(*ks)
    lR = _luminance(*kd)
    total = torch.clamp(lS + lR, min=1e-20)
    invalid_p = invalid | (lS + lR <= 0)
    pdf = (lS / total) * (G_in * D) / torch.clamp(4.0 * n_dot_in,
                                                  min=1e-20) + \
        (1.0 - lS / total) * n_dot_out / PI
    return f, torch.where(invalid_p, 0.0, pdf)


def _cosine_dir(fn, u0, u1):
    """Cosine-hemisphere direction around fn (material.cpp:4-11)."""
    phi = 2.0 * PI * u0
    tmp = torch.sqrt(torch.clamp(1.0 - u1, 0.0, 1.0))
    lx = torch.cos(phi) * tmp
    ly = torch.sin(phi) * tmp
    lz = torch.sqrt(torch.clamp(u1, 0.0, 1.0))
    tx, ty, tz, bx, by, bz = _onb(*fn)
    return (lx * tx + ly * bx + lz * fn[0],
            lx * ty + ly * by + lz * fn[1],
            lx * tz + ly * bz + lz * fn[2])


def _rp_sample(wi, fn, kd, ks, rough, u0, u1, w):
    """RoughPlastic direction sampling (roughplastic.inl): Fresnel-weighted
    choice between VNDF-sampled GGX reflection and cosine diffuse; both
    lobes consume the same (u0, u1). Returns (dir_out 3-tuple, valid)."""
    lS = _luminance(*ks)
    lR = _luminance(*kd)
    spec_prob = lS / torch.clamp(lS + lR, min=1e-20)
    valid = lS + lR > 0

    # VNDF half-vector (Heitz 2018, microfacet.h:85-114), local frame
    tx, ty, tz, bx, by, bz = _onb(*fn)
    lix = _dot3(tx, ty, tz, *wi)
    liy = _dot3(bx, by, bz, *wi)
    liz = _dot3(*fn, *wi)
    flip = liz < 0
    lix, liy, liz = _where3(flip, (-lix, -liy, -liz), (lix, liy, liz))
    alpha = rough * rough
    hvx, hvy, hvz = normalize3(alpha * lix, alpha * liy, liz)
    rr_ = torch.sqrt(torch.clamp(u0, 0.0, 1.0))
    phi = 2.0 * PI * u1
    t1 = rr_ * torch.cos(phi)
    t2 = rr_ * torch.sin(phi)
    s = 0.5 * (1.0 + hvz)
    t2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - t1 * t1, min=0.0)) + s * t2
    dnz = torch.sqrt(torch.clamp(1.0 - t1 * t1 - t2 * t2, min=0.0))
    ftx, fty, ftz, fbx, fby, fbz = _onb(hvx, hvy, hvz)
    hnx = t1 * ftx + t2 * fbx + dnz * hvx
    hny = t1 * fty + t2 * fby + dnz * hvy
    hnz = t1 * ftz + t2 * fbz + dnz * hvz
    hlx, hly, hlz = normalize3(alpha * hnx, alpha * hny,
                           torch.clamp(hnz, min=0.0))
    hlx, hly, hlz = _where3(flip, (-hlx, -hly, -hlz), (hlx, hly, hlz))
    # to world
    hx = hlx * tx + hly * bx + hlz * fn[0]
    hy = hlx * ty + hly * by + hlz * fn[1]
    hz = hlx * tz + hly * bz + hlz * fn[2]
    i_dot_h = _dot3(*wi, hx, hy, hz)
    r = normalize3(2.0 * i_dot_h * hx - wi[0],
               2.0 * i_dot_h * hy - wi[1],
               2.0 * i_dot_h * hz - wi[2])
    return _where3(w < spec_prob, r, _cosine_dir(fn, u0, u1)), valid


def _eval_pdf_dispatch(mats, mt, wi, wo, fn, ng, kd, ks, rough, eta):
    """BSDF eval (f·cos) + pdf, switched on the static material set."""
    res = []
    if MAT_LAMBERTIAN in mats:
        below = (_dot3(*ng, *wi) < 0) | (_dot3(*ng, *wo) < 0)
        cos_o = torch.clamp(_dot3(*fn, *wo), min=0.0)
        sc = torch.where(below, 0.0, cos_o / PI)
        res.append((MAT_LAMBERTIAN, (kd[0] * sc, kd[1] * sc, kd[2] * sc), sc))
    if MAT_ROUGH_PLASTIC in mats:
        f, p = _rp_eval_pdf(wi, wo, fn, ng, kd, ks, rough, eta)
        res.append((MAT_ROUGH_PLASTIC, f, p))
    _, f, p = res[0]
    for tag, f2, p2 in res[1:]:
        m = mt == float(tag)
        f = _where3(m, f2, f)
        p = torch.where(m, p2, p)
    return f, p


def _sample_dispatch(mats, mt, wi, fn, ng, kd, ks, rough, u0, u1, w):
    """BSDF direction sampling switched on the static material set.
    Returns (dir_out 3-tuple, valid)."""
    below_in = _dot3(*ng, *wi) < 0
    res = []
    if MAT_LAMBERTIAN in mats:
        res.append((MAT_LAMBERTIAN, _cosine_dir(fn, u0, u1),
                    torch.ones_like(below_in)))
    if MAT_ROUGH_PLASTIC in mats:
        res.append((MAT_ROUGH_PLASTIC,
                    *_rp_sample(wi, fn, kd, ks, rough, u0, u1, w)))
    _, dir_out, valid = res[0]
    for tag, d2, v2 in res[1:]:
        m = mt == float(tag)
        dir_out = _where3(m, d2, dir_out)
        valid = torch.where(m, v2, valid)
    return dir_out, valid & ~below_in


def _cone_pdf_area(c, r, ref, point, n, dl, dist2):
    """Solid-angle cone pdf toward a sphere converted to area measure,
    with the inside-uniform fallback (shapes/sphere.inl:210-230).
    c: center 3-tuple, r radius, ref: the vertex the light was sampled
    from, point/n: the light point and its normal, dl: normalize(point -
    ref), dist2: |point - ref|²."""
    del point
    ex, ey, ez = c[0] - ref[0], c[1] - ref[1], c[2] - ref[2]
    d2 = ex * ex + ey * ey + ez * ez
    inside = d2 < r * r
    uniform = 1.0 / torch.clamp(4.0 * PI * r * r, min=1e-20)
    cos_el_max = torch.sqrt(torch.clamp(
        1.0 - r * r / torch.clamp(d2, min=1e-20), min=0.0))
    pdf_solid = 1.0 / torch.clamp(2.0 * PI * (1.0 - cos_el_max), min=1e-20)
    pdf_area = pdf_solid * torch.abs(_dot3(*n, *dl)) / torch.clamp(
        dist2, min=1e-20)
    return torch.where(inside, uniform, pdf_area)


# ---------------------------------------------------------------------------
# The advance
# ---------------------------------------------------------------------------

def _advance_core(scene, o, d, thr, rad, nv, dir_pdf, prev, un, act_in, *,
                  eps_isect, eps_shadow, max_depth, rr_depth, max_cap):
    """One path-vertex advance on (row, B) tensors. o, d, thr, rad, prev:
    (3, B); nv, dir_pdf: (1, B) float; un: (8, B) uniforms; act_in: (1, B)
    bool. Specializes on the material set, has_quads and the sphere
    count. Returns (org', dir', thr', rad', dir_pdf', alive)."""
    meta = scene.meta
    mats = meta.mat_types_present
    S = meta.num_spheres
    T = scene.fp_tri.shape[1]
    L = scene.fp_light.shape[1]
    tri, light, sph = scene.fp_tri, scene.fp_light, scene.fp_sph
    qf = scene.cast_quad if meta.has_quads else None
    qf_occ = scene.cast_occ_quad if meta.has_quads else None

    # ---- closest hit: triangles + spheres ----------------------------------
    t_tri, idx, found, ub, vb, qb = _intersect(o, d, eps_isect,
                                               scene.fp_woop, qf)
    if S:
        t_sph, srows = _sphere_closest(o, d, eps_isect, sph)   # (24, B)
        sph_win = t_sph < t_tri
        t_best = torch.minimum(t_tri, t_sph)
    else:
        sph_win = torch.zeros_like(found)
        t_best = t_tri
    valid = (t_best < INF) & act_in
    # quad hits with u + v > 1 belong to the partner (B) triangle:
    # attributes from cast_alt, barycentrics remapped exactly
    prim = scene.cast_src[idx]
    if qf is not None:
        back = (qb > 0.0) & (ub + vb > 1.0)
        prim = torch.where(back, scene.cast_alt[idx], prim)
        ub, vb = (torch.where(back, 1.0 - vb, ub),
                  torch.where(back, ub + vb - 1.0, vb))
    rows = torch.where(found, tri[:, prim[0].long()], 0.0)     # (40, B)

    # Sanitize the miss distance: an inf position would turn masked-out
    # downstream products (NaN * 0) into NaNs in the radiance rows.
    t_eff = torch.where(valid, t_best, 0.0)
    px = o[0:1] + t_eff * d[0:1]
    py = o[1:2] + t_eff * d[1:2]
    pz = o[2:3] + t_eff * d[2:3]

    ngx = rows[4:5] * rows[8:9] - rows[5:6] * rows[7:8]   # e1 x e2
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
        # sphere normal (p - c)/r; shading frame == geometric
        # (shapes/sphere.inl:235-260)
        inv_r = 1.0 / torch.clamp(srows[3:4], min=1e-20)
        sng = normalize3((px - srows[0:1]) * inv_r,
                         (py - srows[1:2]) * inv_r,
                     (pz - srows[2:3]) * inv_r)
        ngx, ngy, ngz = _where3(sph_win, sng, (ngx, ngy, ngz))
        snx, sny, snz = _where3(sph_win, sng, (snx, sny, snz))

    # unified per-hit record (light + material parameters)
    def pick(tri_row, sph_row):
        if not S:
            return rows[tri_row:tri_row + 1]
        return torch.where(sph_win, srows[sph_row:sph_row + 1],
                           rows[tri_row:tri_row + 1])
    h_light = pick(19, 4)
    le = (pick(23, 15), pick(24, 16), pick(25, 17))
    h_pmf = pick(27, 14)
    kd = (pick(20, 6), pick(21, 7), pick(22, 8))
    if mats != (MAT_LAMBERTIAN,):
        mt = pick(28, 5)
        ks = (pick(29, 9), pick(30, 10), pick(31, 11))
        rough = torch.clamp(pick(32, 12), 0.01, 1.0)
        eta = pick(33, 13)
    else:
        mt = ks = rough = eta = None

    wi = (-d[0:1], -d[1:2], -d[2:3])                      # dir_view

    # ---- emissive hit + MIS (cached-pdf form) ------------------------------
    hit_light = valid & (h_light >= 0)
    one_sided = _dot3(ngx, ngy, ngz, *wi) > 0
    le = tuple(torch.where(one_sided, x, 0.0) for x in le)
    dpx = px - prev[0:1]
    dpy = py - prev[1:2]
    dpz = pz - prev[2:3]
    dist2p = torch.clamp(dpx * dpx + dpy * dpy + dpz * dpz, min=1e-20)
    G2 = torch.abs(_dot3(d[0:1], d[1:2], d[2:3], ngx, ngy, ngz)) / dist2p
    p2e = dir_pdf * G2
    p1e = h_pmf * rows[26:27]                             # pmf * 1/area
    if S:
        # sphere lights: cone pdf from the previous vertex
        # (shapes/sphere.inl:210-230), not 1/area
        p1e_s = h_pmf * _cone_pdf_area(
            (srows[0:1], srows[1:2], srows[2:3]), srows[3:4],
            (prev[0:1], prev[1:2], prev[2:3]), (px, py, pz),
            (ngx, ngy, ngz), (d[0:1], d[1:2], d[2:3]), dist2p)
        p1e = torch.where(sph_win, p1e_s, p1e)
    w2 = (p2e * p2e) / torch.clamp(p1e * p1e + p2e * p2e, min=1e-30)
    w2 = torch.where(nv <= 2.0, 1.0, w2)                  # from camera
    add = hit_light.float() * w2
    rad = [rad[c:c + 1] + thr[c:c + 1] * le[c] * add for c in range(3)]

    depth_stop = (nv > max_depth) if max_depth != -1 else (
        nv >= 2.0 + max_cap)
    alive = valid & ~depth_stop

    # ---- NEE ---------------------------------------------------------------
    # light pick: idx = #(cdf < u), clamped
    lsel = (light[0][:, None] < un[2:3]).sum(dim=0).clamp(max=L - 1)
    lrow = light[:, lsel]                                 # (16, B)
    l_pmf = lrow[1:2]
    l_int = (lrow[2:3], lrow[3:4], lrow[4:5])
    p1_area = lrow[5:6]                                   # 1/area
    # mesh lights: pick triangle via staircase (shape_id + cdf), then
    # sqrt-uv barycentric point (triangle_mesh.inl:24-38)
    key = lrow[6:7] + un[3:4]
    tsel = (scene.tri_stair_cdf[:, None] < key).sum(dim=0).clamp(max=T - 1)
    lt = tri[:, tsel]                                     # (40, B)
    a_s = torch.sqrt(torch.clamp(un[0:1], 0.0, 1.0))
    b1 = 1.0 - a_s
    b2 = a_s * un[1:2]
    lpx = lt[0:1] + b1 * lt[3:4] + b2 * lt[6:7]
    lpy = lt[1:2] + b1 * lt[4:5] + b2 * lt[7:8]
    lpz = lt[2:3] + b1 * lt[5:6] + b2 * lt[8:9]
    lnx = lt[4:5] * lt[8:9] - lt[5:6] * lt[7:8]
    lny = lt[5:6] * lt[6:7] - lt[3:4] * lt[8:9]
    lnz = lt[3:4] * lt[7:8] - lt[4:5] * lt[6:7]
    lnx, lny, lnz = normalize3(lnx, lny, lnz)

    if S:
        # sphere lights: cone sampling toward the sphere with
        # inside-uniform fallback (shapes/sphere.inl:156-204)
        is_sl = lrow[7:8] > 0
        lcx, lcy, lcz = lrow[8:9], lrow[9:10], lrow[10:11]
        lr = lrow[11:12]
        dcx_ = lcx - px
        dcy_ = lcy - py
        dcz_ = lcz - pz
        d2c = torch.clamp(dcx_ * dcx_ + dcy_ * dcy_ + dcz_ * dcz_, min=1e-20)
        inside = d2c < lr * lr
        # inside: uniform sphere point
        zu = 1.0 - 2.0 * un[0:1]
        ru = torch.sqrt(torch.clamp(1.0 - zu * zu, min=0.0))
        phiu = 2.0 * PI * un[1:2]
        n_in = (ru * torch.cos(phiu), ru * torch.sin(phiu), zu)
        # outside: cone
        tcx, tcy, tcz = normalize3(dcx_, dcy_, dcz_)
        ftx, fty, ftz, fbx, fby, fbz = _onb(tcx, tcy, tcz)
        sin_el_max_sq = lr * lr / d2c
        cos_el_max = torch.sqrt(torch.clamp(1.0 - sin_el_max_sq, min=0.0))
        cos_el = (1.0 - un[0:1]) + un[0:1] * cos_el_max
        sin_el = torch.sqrt(torch.clamp(1.0 - cos_el * cos_el, min=0.0))
        azim = 2.0 * PI * un[1:2]
        dc = torch.sqrt(d2c)
        ds = dc * cos_el - torch.sqrt(torch.clamp(
            lr * lr - dc * dc * sin_el * sin_el, min=0.0))
        cos_a = (dc * dc + lr * lr - ds * ds) / torch.clamp(2.0 * dc * lr,
                                                            min=1e-20)
        sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
        ca = torch.cos(azim)
        sa = torch.sin(azim)
        n_out = (-(sin_a * ca * ftx + sin_a * sa * fbx + cos_a * tcx),
                 -(sin_a * ca * fty + sin_a * sa * fby + cos_a * tcy),
                 -(sin_a * ca * ftz + sin_a * sa * fbz + cos_a * tcz))
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
    # occluder subset: convex-envelope tris can't block an interior
    # shadow segment (scene/compile.py fp_woop_occ)
    occ = _occluded(sh_o, sh_d, eps_shadow, sh_far, scene.fp_woop_occ, qf_occ)
    if S:
        occ = occ | _sphere_anyhit(sh_o, sh_d, eps_shadow, sh_far, sph)

    Gn = torch.clamp(-_dot3(dlx, dly, dlz, lnx, lny, lnz), min=0.0) / dist2
    Gn = torch.where(occ, 0.0, Gn)
    p1 = l_pmf * p1_area
    # frame flip for the BSDF (lambertian.inl:10-13)
    flip_f = _dot3(snx, sny, snz, *wi) < 0
    fn = _where3(flip_f, (-snx, -sny, -snz), (snx, sny, snz))
    ng = (ngx, ngy, ngz)
    f_nee, p2n_sa = _eval_pdf_dispatch(mats, mt, wi, (dlx, dly, dlz), fn, ng,
                                       kd, ks, rough, eta)
    p2n = p2n_sa * Gn
    Le_ok = -_dot3(dlx, dly, dlz, lnx, lny, lnz) > 0     # one-sided
    nee_ok = alive & (Gn > 0) & (p1 > 0)
    w1 = (p1 * p1) / torch.clamp(p1 * p1 + p2n * p2n, min=1e-30)
    c1 = torch.where(nee_ok & Le_ok,
                     Gn / torch.clamp(p1, min=1e-30) * w1, 0.0)
    rad = [rad[c] + thr[c:c + 1] * f_nee[c] * l_int[c] * c1 for c in range(3)]

    # ---- BSDF sampling ------------------------------------------------------
    dir_out, samp_valid = _sample_dispatch(mats, mt, wi, fn, ng, kd, ks,
                                           rough, un[4:5], un[5:6], un[6:7])
    alive = alive & samp_valid
    f2, p2s = _eval_pdf_dispatch(mats, mt, wi, dir_out, fn, ng, kd, ks,
                                 rough, eta)
    alive = alive & (p2s > 0)

    # ---- RR -----------------------------------------------------------------
    tmax = torch.maximum(torch.maximum(thr[0:1], thr[1:2]), thr[2:3])
    do_rr = (nv - 1.0) >= float(rr_depth)
    rr = torch.where(do_rr, torch.clamp(tmax, max=0.95), 1.0)
    alive = alive & (un[7:8] <= rr)
    inv_p = 1.0 / torch.clamp(p2s * rr, min=1e-30)

    return (sh_o, torch.cat(dir_out, dim=0),
            torch.cat([thr[c:c + 1] * f2[c] * inv_p for c in range(3)],
                      dim=0),
            torch.cat(rad, dim=0), p2s, alive)


# ---------------------------------------------------------------------------
# Transposed-layout entry points: vector args (3, N) / (8, N), scalars (N,)
# ---------------------------------------------------------------------------

def advance_plain_t(scene, options, orgT, dirT, thrT, radT, nv, dir_pdf,
                    prevT, uniformsT, active, max_cap):
    """The plain form of kernel K2, on any device. A lane with `active`
    false comes back as it went in, alive false, as the kernel returns it
    (lajolla_tpu's kernel returns a computed vertex there, which no caller
    reads). Returns (orgT', dirT', thrT', radT', dir_pdf', prevT', alive);
    prevT' is orgT'."""
    org, d, thr, rad, dp, alive = _advance_core(
        scene, orgT, dirT, thrT, radT, nv.float()[None], dir_pdf[None],
        prevT, uniformsT, active[None], **statics(scene, options, max_cap))
    new = torch.cat([org, d, thr, rad, dp])
    old = torch.cat([orgT, dirT, thrT, radT, dir_pdf[None]])
    org, d, thr, rad, dp = torch.where(active, new, old).split([3, 3, 3, 3,
                                                                1])
    return org, d, thr, rad, dp[0], org, alive[0]


def advance_kernel_t(scene, options, orgT, dirT, thrT, radT, nv, dir_pdf,
                     prevT, uniformsT, active, max_cap):
    """Batched advance (kernel K2). CPU tensors run the plain form; CUDA
    tensors launch the CUDA kernel, and anything else raises."""
    if orgT.device.type == 'cpu':
        return advance_plain_t(scene, options, orgT, dirT, thrT, radT, nv,
                               dir_pdf, prevT, uniformsT, active, max_cap)
    from lajolla_tpu_torch import kernels
    org, d, thr, rad, dp, alive = kernels.advance(
        scene, orgT, dirT, thrT, radT, nv.float(), dir_pdf, prevT,
        uniformsT, active, **statics(scene, options, max_cap))
    return org, d, thr, rad, dp, org, alive
