"""Device-side scene intersection producing full hit records, batched over
rays.

Port of lajolla_tpu/scene/geometry.py: intersect()/occluded() +
compute_shading_info (src/intersection.cpp:7-85,
shapes/triangle_mesh.inl:65-157, shapes/sphere.inl:235-260). The
triangle casts of a scene below 192 triangles are kernel K3
(kernels.intersect_brute / kernels.occluded_brute), those of a larger one
the cluster sweeps K4-K7 (ops/intersect_sweep.py): the CUDA kernels for
CUDA tensors, the plain forms for CPU tensors; spheres are brute force in
torch; shading info is gathers. Every function takes (N, 3) rays and returns lane-major fields.
"""

from typing import NamedTuple

import torch

from lajolla_tpu_torch import kernels
from lajolla_tpu_torch.core.math import (coordinate_system, cross, dot,
                                         length, normalize)
from lajolla_tpu_torch.ops.intersect import INF, brute_force_spheres
from lajolla_tpu_torch.ops.intersect_sweep import (intersect_sweep,
                                                   occluded_sweep)
from lajolla_tpu_torch.scene.soa import fetch_shape, fetch_tri

TWO_PI = 6.283185307179586
PI = 3.141592653589793


class Hit(NamedTuple):
    """PathVertex analogue (reference intersection.h:21-37); every field
    has a leading lane axis N."""
    valid: torch.Tensor           # (N,) bool
    t: torch.Tensor               # (N,) distance
    position: torch.Tensor        # (N, 3)
    geometry_normal: torch.Tensor  # (N, 3) flipped toward shading normal
    frame: torch.Tensor           # (N, 3, 3) rows (tangent, bitangent, n)
    uv: torch.Tensor              # (N, 2) texture uv
    st: torch.Tensor              # (N, 2) barycentric / sphere angles
    mean_curvature: torch.Tensor  # (N,)
    inv_uv_size: torch.Tensor     # (N,) max(|dpdu|, |dpdv|)
    footprint: torch.Tensor       # (N,) ray_radius / inv_uv_size
    shape_id: torch.Tensor        # (N,) int32, -1 on a miss
    prim_id: torch.Tensor
    material_id: torch.Tensor
    light_id: torch.Tensor
    interior_med: torch.Tensor
    exterior_med: torch.Tensor


def intersect_triangles(scene, o, d, tnear, tfar):
    """Closest triangle hit (t, prim, u, v) per ray: the cluster sweeps
    (kernels K5 + K4, K6 or K7) for a scene with cluster tables, else
    kernel K3."""
    if scene.meta.use_binned:
        return intersect_sweep(scene, o, d, tnear, tfar)
    return kernels.intersect_brute(scene, o, d, tnear, tfar)


def cast_scene(scene, o, d, tnear, tfar):
    """Raw closest-hit cast → (t, prim, bu, bv, take_sph), each (N,)."""
    t_tri, prim, bu, bv = intersect_triangles(scene, o, d, tnear, tfar)
    if scene.meta.num_spheres > 0:
        t_sph, sph = brute_force_spheres(scene, o, d, tnear, tfar)
    else:
        t_sph = torch.full_like(t_tri, INF)
        sph = torch.full_like(prim, -1)
    take_sph = t_sph < t_tri
    t = torch.where(take_sph, t_sph, t_tri)
    prim = torch.where(take_sph, sph, prim)
    return t, prim, bu, bv, take_sph


def intersect_scene(scene, o, d, tnear, tfar, ray_radius=0.0,
                    ray_spread=0.0, need_aux=False):
    """Closest hit over triangles + spheres → Hit. ray_radius/ray_spread
    are the ray-differential state (ray.h:27-33), (N,) or scalars; the
    hit's texture footprint is (radius + spread·t) / |dp/duv|."""
    raw = cast_scene(scene, o, d, tnear, tfar)
    return hit_from_cast(scene, o, d, raw, ray_radius, ray_spread,
                         need_aux)


def _v(x):
    """A per-lane scalar (N,) as a column, or a 0-d one as is."""
    return x[..., None]


def hit_from_cast(scene, o, d, raw, ray_radius=0.0, ray_spread=0.0,
                  need_aux=False):
    """Build the Hit record from a cast_scene tuple. As in lajolla_tpu,
    uv interpolation, the dp/duv Jacobian, curvature and footprint are
    computed only when the scene needs them statically (needs_uv,
    needs_ray_diff, needs_tangent) or `need_aux`."""
    meta = scene.meta
    need_uv = need_aux or meta.needs_uv
    need_diff = need_aux or meta.needs_ray_diff
    t, prim, bu, bv, take_sph = raw
    n = t.shape[0]
    dev = t.device
    valid = t < INF
    prim_c = torch.clamp(prim, min=0)
    S = meta.num_spheres
    ts = take_sph[:, None]

    # --- triangle record: one wide-row fetch (scene/soa.py) -----------------
    tri = fetch_tri(scene, prim_c)
    p0, p1, p2 = tri.p0, tri.p0 + tri.e1, tri.p0 + tri.e2
    ng_tri = normalize(cross(tri.e1, tri.e2))

    # --- sphere branch -------------------------------------------------------
    sph_c = (torch.where(take_sph, prim_c, 0) if S > 0
             else torch.zeros_like(prim_c)).long()
    center = scene.sph_center[sph_c]
    radius = scene.sph_radius[sph_c]
    pos = o + _v(t) * d
    ng_sph = normalize(pos - center)
    # spherical st (sphere.inl:88-95), y-up
    cart = (pos - center) / _v(torch.clamp(radius, min=1e-20))
    elevation = torch.arccos(torch.clamp(cart[:, 1], -1.0, 1.0))
    azimuth = torch.atan2(cart[:, 2], cart[:, 0])
    st_sph = torch.stack([azimuth / TWO_PI, elevation / PI], -1)

    shape_id = torch.where(take_sph, scene.sph_shape[sph_c] if S > 0
                           else torch.full_like(prim, -1), tri.shape_id)
    shape_id = torch.where(valid, shape_id, -1)
    shape = fetch_shape(scene, torch.clamp(shape_id, min=0))

    st = torch.where(ts, st_sph, torch.stack([bu, bv], -1))
    geometry_normal = torch.where(ts, ng_sph, ng_tri)

    # --- shading normal (triangle: vertex-normal interp,
    # triangle_mesh.inl:125-137) --------------------------------------------
    s0, s1 = st[:, 0], st[:, 1]
    w = 1.0 - s0 - s1
    has_n = (shape.has_normals > 0)[:, None]
    n0, n1, n2 = tri.n0, tri.n1, tri.n2
    sn_interp = normalize(_v(w) * n0 + _v(s0) * n1 + _v(s1) * n2)
    sn_tri = torch.where(has_n, sn_interp, ng_tri)
    sn = torch.where(ts, ng_sph, sn_tri)

    def const_uv(u, v):
        return torch.tensor([u, v], dtype=torch.float32, device=dev)

    need_tangent = need_uv or meta.needs_tangent
    if need_uv:
        # uv interpolation (triangle_mesh.inl:67-83)
        has_uvs = (shape.has_uvs > 0)[:, None]
        uv0 = torch.where(has_uvs, tri.uv0, const_uv(0.0, 0.0))
        uv1 = torch.where(has_uvs, tri.uv1, const_uv(1.0, 0.0))
        uv2 = torch.where(has_uvs, tri.uv2, const_uv(1.0, 1.0))
        uv_tri = _v(w) * uv0 + _v(s0) * uv1 + _v(s1) * uv2
    else:
        uv0 = uv1 = uv2 = None
        uv_tri = st

    if need_tangent:
        # dp/duv from the uv Jacobian (triangle_mesh.inl:84-120)
        if uv0 is None:
            uv0, uv1, uv2 = (const_uv(0.0, 0.0), const_uv(1.0, 0.0),
                             const_uv(1.0, 1.0))
        duvds = uv2 - uv0
        duvdt = uv2 - uv1
        det = duvds[..., 0] * duvdt[..., 1] - duvdt[..., 0] * duvds[..., 1]
        inv_det = torch.where(torch.abs(det) > 1e-8,
                              1.0 / torch.where(det == 0, 1.0, det), 0.0)
        dsdu = duvdt[..., 1] * inv_det
        dtdu = -duvds[..., 1] * inv_det
        dsdv = duvdt[..., 0] * inv_det
        dtdv = -duvds[..., 0] * inv_det
        dpds = p2 - p0
        dpdt = p2 - p1
        dpdu = dpds * _v(dsdu) + dpdt * _v(dtdu)
        dpdv = dpds * _v(dsdv) + dpdt * _v(dtdv)
        degen = _v(torch.abs(det) <= 1e-8)
        t0_cs, t1_cs = coordinate_system(ng_tri)
        dpdu = torch.where(degen, t0_cs, dpdu)
        dpdv = torch.where(degen, t1_cs, dpdv)
        tangent_tri = normalize(dpdu - sn_tri * _v(dot(sn_tri, dpdu)))
        bitangent_tri = normalize(cross(sn_tri, tangent_tri))
    else:
        tangent_tri, bitangent_tri = coordinate_system(sn_tri)

    if need_diff and need_tangent:
        dnds = n2 - n0
        dndt = n2 - n1
        dndu = dnds * _v(dsdu) + dndt * _v(dtdu)
        dndv = dnds * _v(dsdv) + dndt * _v(dtdv)
        curv_tri = torch.where(
            has_n[:, 0],
            (dot(dndu, tangent_tri) + dot(dndv, bitangent_tri)) / 2.0, 0.0)
        inv_uv_tri = torch.maximum(length(dpdu), length(dpdv))
    else:
        curv_tri = torch.zeros(n, device=dev)
        inv_uv_tri = torch.ones(n, device=dev)

    if S > 0:
        # sphere shading frame (sphere.inl:235-260; st treated as angles,
        # replicating the reference verbatim)
        su, sv = s0, s1
        dpdu_s = torch.stack([-radius * torch.sin(su) * torch.sin(sv),
                              radius * torch.cos(su) * torch.sin(sv),
                              torch.zeros_like(su)], -1)
        dpdv_s = torch.stack([radius * torch.cos(su) * torch.cos(sv),
                              radius * torch.sin(su) * torch.cos(sv),
                              -radius * torch.sin(sv)], -1)
        tangent_s = normalize(dpdu_s - ng_sph * _v(dot(ng_sph, dpdu_s)))
        bitangent_s = normalize(cross(ng_sph, tangent_s))
        curv_sph = 1.0 / torch.clamp(radius, min=1e-20)
        inv_uv_sph = (length(dpdu_s) + length(dpdv_s)) / 2.0
        uv = torch.where(ts, st, uv_tri)
        tangent = torch.where(ts, tangent_s, tangent_tri)
        bitangent = torch.where(ts, bitangent_s, bitangent_tri)
        mean_curvature = torch.where(take_sph, curv_sph, curv_tri)
        inv_uv_size = torch.where(take_sph, inv_uv_sph, inv_uv_tri)
    else:
        uv = uv_tri
        tangent = tangent_tri
        bitangent = bitangent_tri
        mean_curvature = curv_tri
        inv_uv_size = inv_uv_tri

    # flip geometry normal toward shading normal (intersection.cpp:59-62)
    geometry_normal = torch.where(_v(dot(geometry_normal, sn) < 0),
                                  -geometry_normal, geometry_normal)

    frame = torch.stack([tangent, bitangent, sn], dim=-2)
    return Hit(
        valid=valid,
        t=t,
        position=pos,
        geometry_normal=geometry_normal,
        frame=frame,
        uv=uv,
        st=st,
        mean_curvature=mean_curvature,
        inv_uv_size=inv_uv_size,
        footprint=(ray_radius + ray_spread * t) /
        torch.clamp(inv_uv_size, min=1e-20),
        shape_id=shape_id,
        prim_id=torch.where(valid, prim, -1),
        material_id=torch.where(valid, shape.material_id, -1),
        light_id=torch.where(valid, shape.light_id, -1),
        interior_med=torch.where(valid, shape.interior_med, -1),
        exterior_med=torch.where(valid, shape.exterior_med, -1),
    )


def occluded(scene, o, d, tnear, tfar):
    """Shadow-ray test (intersection.cpp:67-85): (N,) bool. The triangle
    any-hit is the cluster sweeps' for a scene with cluster tables, else
    kernel K3's."""
    if scene.meta.use_binned:
        occ = occluded_sweep(scene, o, d, tnear, tfar)
    else:
        occ = kernels.occluded_brute(scene, o, d, tnear, tfar)
    if scene.meta.num_spheres > 0:
        _, sph = brute_force_spheres(scene, o, d, tnear, tfar)
        occ = occ | (sph >= 0)
    return occ
