"""Light sampling / pdf / emission, batched over lanes.

Port of lajolla_tpu/integrators/lights.py: the Light variant ops
(light.h:38-70, lights/diffuse_area_light.inl, lights/envmap.inl) and the
shape point sampling they delegate to (shapes/triangle_mesh.inl:24-63,
shapes/sphere.inl:156-230). Light ids, points and uniforms carry a
leading lane axis N.
"""

from typing import NamedTuple

import torch

from lajolla_tpu_torch.core.distribution import sample_alias, sample_cdf
from lajolla_tpu_torch.core.math import (cross, distance_squared, dot,
                                         make_frame, normalize, to_world)
from lajolla_tpu_torch.core.transform import xform_vector
from lajolla_tpu_torch.scene.soa import fetch_light, fetch_shape, fetch_tri
from lajolla_tpu_torch.scene.texeval import image_mip_level, lookup_trilinear
from lajolla_tpu_torch.scene.types import LIGHT_ENVMAP, SHAPE_SPHERE

PI = 3.141592653589793
TWO_PI = 6.283185307179586
INV_PI = 1.0 / PI
INV_TWO_PI = 1.0 / TWO_PI


class LightPoint(NamedTuple):
    position: torch.Tensor  # (N, 3)
    normal: torch.Tensor    # (N, 3); for envmap: direction pointing
                            # outwards from the light (light.h:40-44)


def _c(x):
    return x[:, None]


def sample_light(scene, u):
    """Power-weighted light pick (scene.cpp:48-52, scene.h:85-88)."""
    return sample_cdf(scene.light_cdf, u).to(torch.int32)


def light_pmf(scene, light_id):
    return scene.light_pmf[torch.clamp(light_id, min=0).long()]


def _sphere_index(meta, shape):
    """The sphere row of a light's shape. On the lanes whose light is a
    mesh, prim_start is a triangle id: clamped into the sphere table as
    lajolla_tpu's gathers clamp it (the value is never selected)."""
    return torch.clamp(shape.prim_start, 0, meta.num_spheres - 1)


def _sample_point_on_mesh(scene, shape, uv, w):
    """Area-weighted triangle pick via the per-shape alias table (one row
    gather) + sqrt-uv barycentric point (triangle_mesh.inl:24-38). uv[:, 0]
    doubles as the accept/alias coin and is remapped back to U[0,1)."""
    c = torch.clamp(shape.prim_count, min=1)
    f = w * c.to(torch.float32)
    j = shape.prim_start + torch.minimum(torch.clamp(f.to(torch.int32), min=0),
                                         c - 1)
    row = scene.tri_alias[torch.clamp(j, 0, scene.tri_alias.shape[0] - 1)
                          .long()]
    q = row[:, 0]
    u0 = uv[:, 0]
    take = u0 < q
    tri_id = torch.where(take, j, row[:, 1].to(torch.int32))
    u0 = torch.where(take, u0 / torch.clamp(q, min=1e-12),
                     (u0 - q) / torch.clamp(1.0 - q, min=1e-12))
    tri = fetch_tri(scene, tri_id)
    a = torch.sqrt(torch.clamp(u0, 0.0, 1.0))
    b1 = 1.0 - a
    b2 = a * uv[:, 1]
    return LightPoint(position=tri.p0 + tri.e1 * _c(b1) + tri.e2 * _c(b2),
                      normal=normalize(cross(tri.e1, tri.e2)))


def _sample_point_on_sphere(scene, ref_point, uv, sph_idx):
    """Cone sampling toward the sphere with an inside-uniform fallback
    (sphere.inl:156-204)."""
    center = scene.sph_center[sph_idx.long()]
    r = scene.sph_radius[sph_idx.long()]
    d2 = distance_squared(ref_point, center)
    inside = d2 < r * r

    # inside: uniform sphere
    z = 1.0 - 2.0 * uv[:, 0]
    r_ = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * uv[:, 1]
    off_in = torch.stack([r_ * torch.cos(phi), r_ * torch.sin(phi), z], -1)

    # outside: cone
    dir_to_center = normalize(center - ref_point)
    fr = make_frame(dir_to_center)
    sin_el_max_sq = r * r / torch.clamp(d2, min=1e-20)
    cos_el_max = torch.sqrt(torch.clamp(1.0 - sin_el_max_sq, min=0.0))
    cos_el = (1.0 - uv[:, 0]) + uv[:, 0] * cos_el_max
    sin_el = torch.sqrt(torch.clamp(1.0 - cos_el * cos_el, min=0.0))
    azimuth = uv[:, 1] * TWO_PI
    dc = torch.sqrt(d2)
    ds = dc * cos_el - torch.sqrt(torch.clamp(
        r * r - dc * dc * sin_el * sin_el, min=0.0))
    cos_alpha = (dc * dc + r * r - ds * ds) / torch.clamp(2.0 * dc * r,
                                                          min=1e-20)
    sin_alpha = torch.sqrt(torch.clamp(1.0 - cos_alpha * cos_alpha, min=0.0))
    n_out = -to_world(fr, torch.stack([sin_alpha * torch.cos(azimuth),
                                       sin_alpha * torch.sin(azimuth),
                                       cos_alpha], -1))
    nrm = torch.where(_c(inside), off_in, n_out)
    return LightPoint(position=_c(r) * nrm + center, normal=nrm)


def _pdf_point_on_sphere(scene, sph_idx, point, ref_point):
    """sphere.inl:210-230 (solid-angle cone pdf → area measure)."""
    center = scene.sph_center[sph_idx.long()]
    r = scene.sph_radius[sph_idx.long()]
    d2 = distance_squared(ref_point, center)
    inside = d2 < r * r
    uniform_pdf = 1.0 / (4.0 * PI * r * r)
    sin_el_max_sq = r * r / torch.clamp(d2, min=1e-20)
    cos_el_max = torch.sqrt(torch.clamp(1.0 - sin_el_max_sq, min=0.0))
    pdf_solid = 1.0 / torch.clamp(TWO_PI * (1.0 - cos_el_max), min=1e-20)
    dirv = normalize(point.position - ref_point)
    pdf_area = pdf_solid * torch.abs(dot(point.normal, dirv)) / \
        torch.clamp(distance_squared(ref_point, point.position), min=1e-20)
    return torch.where(inside, uniform_pdf, pdf_area)


def _envmap_uv_from_dir(scene, world_dir):
    """Direction (scene → envmap) → uv (envmap.inl:27-34)."""
    local_dir = xform_vector(scene.env_to_local, world_dir)
    u = torch.atan2(local_dir[:, 0], -local_dir[:, 2]) * INV_TWO_PI
    u = torch.where(u < 0, u + 1.0, u)
    v = torch.arccos(torch.clamp(local_dir[:, 1], -1.0, 1.0)) * INV_PI
    return torch.stack([u, v], -1), local_dir


def sample_point_on_light(scene, light_id, ref_point, uv, w):
    """light.h:47-56. For the envmap the returned normal stores
    -world_dir."""
    light_id = torch.clamp(light_id, min=0)
    light = fetch_light(scene, light_id)
    shape_c = torch.clamp(light.shape_id, min=0)
    shape = fetch_shape(scene, shape_c)
    meta = scene.meta

    # area light on mesh or sphere
    is_sphere = _c(shape.type == SHAPE_SPHERE)
    if meta.num_spheres > 0:
        p_sph = _sample_point_on_sphere(scene, ref_point, uv,
                                        _sphere_index(meta, shape))
    if meta.num_triangles > 0:
        p_mesh = _sample_point_on_mesh(scene, shape, uv, w)
    if meta.num_spheres > 0 and meta.num_triangles > 0:
        p_area = LightPoint(
            position=torch.where(is_sphere, p_sph.position, p_mesh.position),
            normal=torch.where(is_sphere, p_sph.normal, p_mesh.normal))
    elif meta.num_spheres > 0:
        p_area = p_sph
    else:
        p_area = p_mesh

    if not meta.has_envmap:
        return p_area

    # envmap (envmap.inl:7-20): O(1) alias draw over the H*W luminance
    # cells, the same distribution as the reference's binary search
    h, wdt = meta.env_res
    cell, du, dv = sample_alias(scene.env_alias, uv[:, 0], uv[:, 1])
    ue = (torch.remainder(cell, wdt) + du) / wdt
    ve = (torch.div(cell, wdt, rounding_mode='floor') + dv) / h
    azimuth = ue * TWO_PI
    elevation = ve * PI
    local_dir = torch.stack([torch.sin(azimuth) * torch.sin(elevation),
                             torch.cos(elevation),
                             -torch.cos(azimuth) * torch.sin(elevation)], -1)
    world_dir = xform_vector(scene.env_to_world, local_dir)
    is_env = _c(light.type == LIGHT_ENVMAP)
    return LightPoint(
        position=torch.where(is_env, 0.0, p_area.position),
        normal=torch.where(is_env, -world_dir, p_area.normal))


def pdf_point_on_light(scene, light_id, point, ref_point):
    """light.h:59-63: area measure for area lights, solid-angle pdf with
    the envmap Jacobian 1/(2π² sinθ) for envmaps (envmap.inl:22-42)."""
    light_id = torch.clamp(light_id, min=0)
    light = fetch_light(scene, light_id)
    shape_c = torch.clamp(light.shape_id, min=0)
    shape = fetch_shape(scene, shape_c)
    meta = scene.meta

    is_sphere = shape.type == SHAPE_SPHERE
    pdf_mesh = 1.0 / torch.clamp(shape.area, min=1e-20)
    if meta.num_spheres > 0:
        pdf_sph = _pdf_point_on_sphere(scene, _sphere_index(meta, shape),
                                       point, ref_point)
        pdf_area = torch.where(is_sphere, pdf_sph, pdf_mesh)
    else:
        pdf_area = pdf_mesh

    if not meta.has_envmap:
        return pdf_area

    uve, local_dir = _envmap_uv_from_dir(scene, -point.normal)
    h, wdt = meta.env_res
    x = torch.clamp((uve[:, 0] * wdt).to(torch.int32), 0, wdt - 1)
    y = torch.clamp((uve[:, 1] * h).to(torch.int32), 0, h - 1)
    pdf_uv = scene.env_pdf_uv[y.long(), x.long()]
    cos_el = local_dir[:, 1]
    sin_el = torch.sqrt(torch.clamp(1.0 - cos_el * cos_el, 0.0, 1.0))
    pdf_env = torch.where(sin_el <= 0, 0.0, pdf_uv / torch.clamp(
        2.0 * PI * PI * sin_el, min=1e-20))
    return torch.where(light.type == LIGHT_ENVMAP, pdf_env, pdf_area)


def emission_area(scene, light_id, point_normal, view_dir):
    """DiffuseAreaLight one-sided emission (diffuse_area_light.inl:15-20).
    Returns (N, 3)."""
    intensity = fetch_light(scene, torch.clamp(light_id, min=0)).intensity
    return torch.where(_c(dot(point_normal, view_dir) <= 0), 0.0, intensity)


def emission_envmap(scene, emit_dir, view_footprint):
    """Envmap radiance along emit_dir (N, 3), the direction from the scene
    toward the envmap (envmap.inl:44-73). The footprint formula is
    replicated verbatim — including its min() with the negative dv/dwy,
    which pins the lookup to mip level 0 as the reference build does —
    so `view_footprint` is not read."""
    if not scene.meta.has_envmap:
        return torch.zeros_like(emit_dir)
    uve, w = _envmap_uv_from_dir(scene, emit_dir)
    denom = torch.clamp(w[:, 0] * w[:, 0] + w[:, 2] * w[:, 2], min=1e-20)
    dudwx = -w[:, 2] / denom
    dudwz = w[:, 0] / denom
    dvdwy = -1.0 / torch.sqrt(torch.clamp(1.0 - w[:, 1] * w[:, 1],
                                          min=1e-20))
    footprint = torch.minimum(torch.sqrt(dudwx * dudwx + dudwz * dudwz),
                              dvdwy)

    # the envmap texture is an image texture with uvscale 1
    img_id = torch.full((emit_dir.shape[0],), scene.meta.env_image_id,
                        dtype=torch.int32, device=emit_dir.device)
    one = torch.ones(2, dtype=emit_dir.dtype, device=emit_dir.device)
    level = image_mip_level(scene, img_id, one, footprint)
    val = lookup_trilinear(scene, img_id, uve[:, 0], uve[:, 1], level)
    return val * scene.env_scale

