"""Ray-primitive intersection, batched over rays (device side).

Port of lajolla_tpu/ops/intersect.py, the Embree calls behind
intersect()/occluded() (src/intersection.cpp:7-85). Conventions match
Embree's: hit point = (1-u-v)*v0 + u*v1 + v*v2; triangles tested with
Moller-Trumbore; spheres with the numerically stable quadratic
(src/shapes/sphere.inl:15-38).

`_brute_force_batched` and `_occluded_batched` are the plain forms of
kernel K3 (lajolla_tpu/ops/intersect_pallas.py; kernels.intersect_brute
and kernels.occluded_brute): closest hit and any hit over the
quad-merged Woop cast tables. lajolla_tpu contracts the rays with the
Woop rows by one HIGHEST-precision matmul; here the three products and
the bias are added left to right, the order K3 computes them in.
"""

import torch

from lajolla_tpu_torch.core.math import cross, dot

INF = float('inf')


def ray_triangle(o, d, p0, e1, e2, tnear, tfar):
    """Moller-Trumbore, broadcasting over leading axes. Returns
    (t, u, v, hit)."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    # No backface culling (Embree default). Guard near-zero determinant.
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ((torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) &
           (u + v <= 1.0) & (t > tnear) & (t < tfar))
    return t, u, v, hit


def ray_sphere(o, d, center, radius, tnear, tfar):
    """Numerically stable sphere quadratic, broadcasting over leading
    axes; returns (t, hit) for the nearest root in (tnear, tfar)."""
    oc = o - center
    a = dot(d, d)
    b = 2.0 * dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    valid = disc >= 0.0
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * torch.where(b >= 0.0, b + sqrt_disc, b - sqrt_disc)

    def safe(num, den):
        ok = torch.abs(den) > 1e-30
        return torch.where(ok, num / torch.where(ok, den, 1.0), INF)
    t0 = safe(q, a)
    t1 = safe(c, q)
    tlo = torch.minimum(t0, t1)
    thi = torch.maximum(t0, t1)
    t = torch.where((tlo > tnear) & (tlo < tfar), tlo,
                    torch.where((thi > tnear) & (thi < tfar), thi, INF))
    hit = valid & (t < INF)
    return torch.where(hit, t, INF), hit


def _col(x, like):
    """A scalar or (N,) ray bound as an (N, 1) column."""
    if not torch.is_tensor(x):
        return torch.full((like.shape[0], 1), float(x), dtype=like.dtype,
                          device=like.device)
    return x.reshape(-1, 1)


def ray_bounds(o, tnear, tfar):
    """Ray bounds, each a scalar or an (N,) tensor, as (N,) float32 tensors
    on the rays' device."""
    return tuple(x.to(torch.float32) if torch.is_tensor(x) else
                 torch.full((o.shape[0],), float(x), dtype=torch.float32,
                            device=o.device) for x in (tnear, tfar))


def _woop_tuv(o, d, A, b):
    """Rays (N, 3) in every cast prim's unit space: A (3, 3T) Woop rows
    grouped [x | y | z], b (3T,). Returns (t, u, v, dz_ok), each (N, T)."""
    T = A.shape[1] // 3
    op = o[:, 0:1] * A[0] + o[:, 1:2] * A[1] + o[:, 2:3] * A[2] + b
    dp = d[:, 0:1] * A[0] + d[:, 1:2] * A[1] + d[:, 2:3] * A[2]
    ox, oy, oz = op[:, :T], op[:, T:2 * T], op[:, 2 * T:]
    dx, dy, dz = dp[:, :T], dp[:, T:2 * T], dp[:, 2 * T:]
    dz_ok = torch.abs(dz) > 1e-12
    t = -oz / torch.where(dz_ok, dz, 1.0)
    return t, ox + t * dx, oy + t * dy, dz_ok


def _hits(t, u, v, dz_ok, quad, tnear, tfar):
    """Hit predicate over (N, T); quad (T,) flags accept the
    parallelogram max(u, v) <= 1."""
    lim = torch.where(quad[None, :] > 0, 1.0 - torch.maximum(u, v),
                      1.0 - u - v)
    return (dz_ok & (u >= 0.0) & (v >= 0.0) & (lim >= 0.0) &
            (t > tnear) & (t < tfar))


def _brute_force_batched(scene, o, d, tnear, tfar):
    """Closest hit over the quad-merged CAST table (the plain form of K3,
    closest-hit variant). o, d: (N, 3); tnear/tfar: (N,) or scalar.
    Prims flagged in cast_quad accept the full parallelogram
    max(u, v) <= 1; a hit with u + v > 1 lies in the partner triangle
    and maps exactly to its barycentrics (u', v') = (1 - v, u + v - 1).
    Returns (t, prim, u, v), each (N,); prim is a true triangle id, -1 on
    a miss (t = inf)."""
    t, u, v, dz_ok = _woop_tuv(o, d, scene.tri_woop_A, scene.tri_woop_b)
    hit = _hits(t, u, v, dz_ok, scene.cast_quad, _col(tnear, o),
                _col(tfar, o))
    t = torch.where(hit, t, INF)
    i = torch.argmin(t, dim=1)
    rows = torch.arange(o.shape[0], device=o.device)
    t_best = t[rows, i]
    miss = t_best == INF
    ui, vi = u[rows, i], v[rows, i]
    back = (scene.cast_quad[i] > 0) & (ui + vi > 1.0)
    prim = torch.where(back, scene.cast_alt[i], scene.cast_src[i])
    ur = torch.where(back, 1.0 - vi, ui)
    vr = torch.where(back, ui + vi - 1.0, vi)
    return (torch.where(miss, INF, t_best),
            torch.where(miss, -1, prim).to(torch.int32), ur, vr)


def _occluded_batched(scene, o, d, tnear, tfar):
    """Any hit over the OCCLUDER SUBSET (the plain form of K3, any-hit
    variant; convex-envelope tris can never block a shadow segment,
    scene/compile.py tri_woop_*_occ). Returns (N,) bool."""
    t, u, v, dz_ok = _woop_tuv(o, d, scene.tri_woop_A_occ,
                               scene.tri_woop_b_occ)
    hit = _hits(t, u, v, dz_ok, scene.cast_occ_quad, _col(tnear, o),
                _col(tfar, o))
    return hit.any(dim=1)


def brute_force_spheres(scene, o, d, tnear, tfar):
    """Closest hit over all spheres. Returns (t, sphere_idx) per ray;
    sphere_idx -1 on a miss."""
    t, hit = ray_sphere(o[:, None, :], d[:, None, :], scene.sph_center[None],
                        scene.sph_radius[None], _col(tnear, o), _col(tfar, o))
    t = torch.where(hit, t, INF)
    i = torch.argmin(t, dim=1)
    t_best = t[torch.arange(o.shape[0], device=o.device), i]
    miss = t_best == INF
    return (torch.where(miss, INF, t_best),
            torch.where(miss, -1, i).to(torch.int32))
