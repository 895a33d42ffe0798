"""Participating media and phase functions, batched over lanes.

Port of lajolla_tpu/integrators/media.py (medium.h:22-27,
media/homogeneous.inl, media/heterogeneous.inl,
phase_functions/{isotropic,henyeygreenstein}.inl) and of its grid-volume
trilinear lookup (volume.h:45-95, :114-144). Every property is read from
the scene's wide medium row (`med_tab`, built by scene/compile.py), one
index gather per lane; a grid lookup adds one gather of an octo-packed
`volume_data` row (the 8 corners of the lane's cell). The heterogeneous
branches run only when the scene has a heterogeneous medium, as in
lajolla_tpu.
"""

import torch

from lajolla_tpu_torch.core.math import dot, make_frame, to_world
from lajolla_tpu_torch.scene.types import (MED_HETEROGENEOUS,
                                           MED_HOMOGENEOUS, PHASE_ISOTROPIC,
                                           VOL_GRID)

PI = 3.141592653589793
TWO_PI = 6.283185307179586
INV_4PI = 1.0 / (4.0 * PI)

# wide medium row column offsets (scene.med_tab, built in compile.py)
MT_TYPE, MT_PHASE, MT_G, MT_DVOL, MT_AVOL = 0, 1, 2, 3, 4
MT_SA, MT_SS, MT_MAXVAL = 5, 8, 11
MT_SRES, MT_SOFF = 14, 17
MT_DLOOK, MT_ALOOK = 18, 32      # 14-float volume-lookup sub-rows
# volume-lookup sub-row offsets: [kind, const3, pmin3, pmax3, res3, off]
VL_KIND, VL_CONST, VL_PMIN, VL_PMAX, VL_RES, VL_OFF = 0, 1, 4, 7, 10, 13


def has_heterogeneous(meta):
    return MED_HETEROGENEOUS in meta.med_types_present


def lookup_volume_vrow(scene, vrow, p):
    """Trilinear grid or constant volume lookup → (N, 3) from (N, 14)
    volume sub-rows at points p (N, 3): volume.h:40-81, zero outside the
    grid's box, the scale pre-multiplied at compile."""
    const = vrow[:, VL_CONST:VL_CONST + 3]
    if not scene.meta.has_grid_volumes:
        return const
    pmin = vrow[:, VL_PMIN:VL_PMIN + 3]
    pmax = vrow[:, VL_PMAX:VL_PMAX + 3]
    res = vrow[:, VL_RES:VL_RES + 3].to(torch.int64)
    off = vrow[:, VL_OFF].to(torch.int64)
    pn = (p - pmin) / torch.clamp(pmax - pmin, min=1e-20)
    inside = ((pn >= 0.0) & (pn <= 1.0)).all(dim=-1)
    f = pn * (res - 1).to(torch.float32)
    c0 = torch.minimum(torch.clamp(f.to(torch.int64), min=0), res - 1)
    w1 = f - c0.to(torch.float32)
    w0 = 1.0 - w1
    rx, ry = res[:, 0], res[:, 1]
    # ONE octo-packed row: node (z0, y0, x0) carries its cell's 8 corners
    idx = off + (c0[:, 2] * ry + c0[:, 1]) * rx + c0[:, 0]
    c = scene.volume_data[torch.clamp(idx, 0,
                                      scene.volume_data.shape[0] - 1)]
    wx0, wy0, wz0 = w0[:, 0:1], w0[:, 1:2], w0[:, 2:3]
    wx1, wy1, wz1 = w1[:, 0:1], w1[:, 1:2], w1[:, 2:3]
    val = (c[:, 0:3] * (wx0 * wy0 * wz0) + c[:, 3:6] * (wx1 * wy0 * wz0) +
           c[:, 6:9] * (wx0 * wy1 * wz0) + c[:, 9:12] * (wx1 * wy1 * wz0) +
           c[:, 12:15] * (wx0 * wy0 * wz1) + c[:, 15:18] * (wx1 * wy0 * wz1) +
           c[:, 18:21] * (wx0 * wy1 * wz1) + c[:, 21:24] * (wx1 * wy1 * wz1))
    grid_val = torch.where(inside[:, None], val, 0.0)
    return torch.where((vrow[:, VL_KIND] == VOL_GRID)[:, None], grid_val,
                       const)


def _vrow_from_tables(scene, vol_id):
    """(N, 14) volume sub-rows from the narrow volume tables."""
    v = torch.clamp(vol_id, min=0).long()
    return torch.cat([
        scene.vol_kind[v][:, None].to(torch.float32), scene.vol_const[v],
        scene.vol_pmin[v], scene.vol_pmax[v],
        scene.vol_res[v].to(torch.float32),
        scene.vol_offset[v][:, None].to(torch.float32)], dim=-1)


def lookup_volume(scene, vol_id, p):
    """Trilinear grid or constant volume lookup by volume id → (N, 3)."""
    return lookup_volume_vrow(scene, _vrow_from_tables(scene, vol_id), p)


def volume_aabb_hit_vrow(vrow, o, d, tfar):
    """Slab test of the rays o + t d against the grid's box over
    [0, tfar] (volume.h:114-144); a constant volume always hits.
    → (N,) bool."""
    safe_d = torch.where(torch.abs(d) > 1e-20, d, 1e-20)
    tn = (vrow[:, VL_PMIN:VL_PMIN + 3] - o) / safe_d
    tf = (vrow[:, VL_PMAX:VL_PMAX + 3] - o) / safe_d
    t0 = torch.clamp(torch.minimum(tn, tf).amax(dim=-1), min=0.0)
    t1 = torch.minimum(torch.maximum(tn, tf).amin(dim=-1), tfar)
    return torch.where(vrow[:, VL_KIND] == VOL_GRID, t0 <= t1, True)


def med_row(scene, med_id):
    """(N, 46) wide medium rows; med_id < 0 reads row 0 (callers mask
    vacuum lanes themselves)."""
    return scene.med_tab[torch.clamp(med_id, min=0).long()]


def _row(scene, med_id, row):
    return med_row(scene, med_id) if row is None else row


def _is_hom(row):
    return (row[:, MT_TYPE] == MED_HOMOGENEOUS)[:, None]


def get_majorant(scene, med_id, o, d, tfar, row=None):
    """(N, 3): sigma_t of a homogeneous medium; for a heterogeneous one
    its density grid's maximum where the ray meets the grid's box within
    tfar, else 0."""
    row = _row(scene, med_id, row)
    hom = row[:, MT_SA:MT_SA + 3] + row[:, MT_SS:MT_SS + 3]
    if not has_heterogeneous(scene.meta):
        return hom
    hit = volume_aabb_hit_vrow(row[:, MT_DLOOK:MT_DLOOK + 14], o, d, tfar)
    het = torch.where(hit[:, None], row[:, MT_MAXVAL:MT_MAXVAL + 3], 0.0)
    return torch.where(_is_hom(row), hom, het)


def density_albedo(scene, row, p):
    """(density, albedo), each (N, 3), of the media rows at points p."""
    return (lookup_volume_vrow(scene, row[:, MT_DLOOK:MT_DLOOK + 14], p),
            lookup_volume_vrow(scene, row[:, MT_ALOOK:MT_ALOOK + 14], p))


def get_sigma_s(scene, med_id, p, row=None):
    row = _row(scene, med_id, row)
    hom = row[:, MT_SS:MT_SS + 3]
    if not has_heterogeneous(scene.meta):
        return hom
    density, albedo = density_albedo(scene, row, p)
    return torch.where(_is_hom(row), hom, density * albedo)


def get_sigma_a(scene, med_id, p, row=None):
    row = _row(scene, med_id, row)
    hom = row[:, MT_SA:MT_SA + 3]
    if not has_heterogeneous(scene.meta):
        return hom
    density, albedo = density_albedo(scene, row, p)
    return torch.where(_is_hom(row), hom, density * (1.0 - albedo))


# ---------------------------------------------------------------------------
# Phase functions (phase_functions/*.inl)
# ---------------------------------------------------------------------------

def _hg(g, cos_theta):
    return INV_4PI * (1.0 - g * g) / torch.clamp(
        (1.0 + g * g + 2.0 * g * cos_theta) ** 1.5, min=1e-20)


def phase_pdf(scene, med_id, dir_in, dir_out, row=None):
    """(N,) solid-angle pdf of phase_sample."""
    row = _row(scene, med_id, row)
    typ, g = row[:, MT_PHASE], row[:, MT_G]
    hg = _hg(g, dot(dir_in, dir_out))
    return torch.where(typ == PHASE_ISOTROPIC, INV_4PI, hg)


def phase_eval(scene, med_id, dir_in, dir_out, row=None):
    """(N, 3), constant across channels like the reference."""
    return phase_pdf(scene, med_id, dir_in, dir_out, row)[:, None].expand(
        -1, 3)


def phase_sample(scene, med_id, dir_in, u, row=None):
    """HG inverse CDF with the uniform-sphere fallback for |g| < 1e-3
    (henyeygreenstein.inl:26-46); isotropic = uniform sphere. u: (N, 2).
    Returns (N, 3)."""
    row = _row(scene, med_id, row)
    typ, g = row[:, MT_PHASE], row[:, MT_G]
    u0, u1 = u[:, 0], u[:, 1]

    z = 1.0 - 2.0 * u0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u1
    uniform = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)

    g_safe = torch.where(torch.abs(g) < 1e-3, 1.0, g)
    tmp = (g_safe * g_safe - 1.0) / (2.0 * u0 * g_safe - (g_safe + 1.0))
    cos_el = (tmp * tmp - (1.0 + g_safe * g_safe)) / (2.0 * g_safe)
    sin_el = torch.sqrt(torch.clamp(1.0 - cos_el * cos_el, min=0.0))
    azimuth = TWO_PI * u1
    hg_dir = to_world(make_frame(dir_in), torch.stack(
        [sin_el * torch.cos(azimuth), sin_el * torch.sin(azimuth), cos_el],
        -1))
    use_uniform = (typ == PHASE_ISOTROPIC) | (torch.abs(g) < 1e-3)
    return torch.where(use_uniform[:, None], uniform, hg_dir)


def update_medium(hit, d, medium):
    """Medium transition across an interface (vol_path_tracing.h:149-163):
    the exterior medium when leaving along the normal, the interior when
    entering; unchanged where both sides share a medium."""
    differs = hit.interior_med != hit.exterior_med
    new_med = torch.where(dot(d, hit.geometry_normal) > 0, hit.exterior_med,
                          hit.interior_med)
    return torch.where(differs, new_med, medium)
