"""Participating media and phase functions, batched over lanes.

Port of lajolla_tpu/integrators/media.py (medium.h:22-27,
media/homogeneous.inl, phase_functions/{isotropic,henyeygreenstein}.inl).
Every property is read from the scene's wide medium row (`med_tab`, built
by scene/compile.py), one index gather per lane. Only homogeneous media
are ported: the heterogeneous branches need the grid volumes and their
supervoxel majorant tables, which the port's compiler does not build
yet, so they raise.
"""

import torch

from lajolla_tpu_torch.core.math import dot, make_frame, to_world
from lajolla_tpu_torch.scene.types import (MED_HETEROGENEOUS,
                                           PHASE_ISOTROPIC)

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

HETEROGENEOUS_TODO = ("heterogeneous media are not yet ported: they need "
                      "the grid volumes' supervoxel majorant tables "
                      "(ROADMAP queue 1 item 5: grid media, with K9)")


def check_homogeneous(meta):
    """Raise NotImplementedError for a scene with a heterogeneous medium."""
    if MED_HETEROGENEOUS in meta.med_types_present:
        raise NotImplementedError(HETEROGENEOUS_TODO)


def lookup_volume_vrow(scene, vrow, p):
    """Volume lookup from a 14-float volume sub-row → (N, 3): the constant
    case only (a port scene has no grid volumes)."""
    if scene.meta.has_grid_volumes:
        raise NotImplementedError(HETEROGENEOUS_TODO)
    return vrow[:, VL_CONST:VL_CONST + 3]


def med_row(scene, med_id):
    """(N, 46) wide medium rows; med_id < 0 reads row 0 (callers mask
    vacuum lanes themselves)."""
    return scene.med_tab[torch.clamp(med_id, min=0).long()]


def _row(scene, med_id, row):
    return med_row(scene, med_id) if row is None else row


def get_majorant(scene, med_id, o, d, tfar, row=None):
    check_homogeneous(scene.meta)
    row = _row(scene, med_id, row)
    return row[:, MT_SA:MT_SA + 3] + row[:, MT_SS:MT_SS + 3]


def get_sigma_s(scene, med_id, p, row=None):
    check_homogeneous(scene.meta)
    return _row(scene, med_id, row)[:, MT_SS:MT_SS + 3]


def get_sigma_a(scene, med_id, p, row=None):
    check_homogeneous(scene.meta)
    return _row(scene, med_id, row)[:, MT_SA:MT_SA + 3]


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
