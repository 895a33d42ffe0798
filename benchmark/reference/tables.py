"""The reference's scene tables, worked out from a configuration file, in
the row layouts the frozen plain form reads (reference/path_vertex.py).

Nothing here reads the program's parser or compiler, nor the XML the
program parses: the geometry, materials, light and camera come from the
configuration itself. Where the program's
compiler fixes a choice that moves random numbers, it is made here again
the same way:

- each quad (p0, p1, p2, p3) splits into (p0, p1, p2), (p0, p2, p3), as
  an OBJ `f a b c d` line does, and the pair becomes one cast primitive:
  the first triangle rotated to (p1, p2, p0), so its Woop transform covers
  the whole parallelogram; a light point is p0 + b1 e1 + b2 e2 of the
  triangle so ordered;
- a light's triangle is picked by the staircase shape id + area CDF;
- vertex normals are the angle-weighted smooth normals of each mesh.

The shadow scans test every cast primitive (the program drops the
convex-envelope walls from them: the same answer on every ray that ends
inside the room).
"""

import types

import numpy as np
import torch

from benchmark.reference.constants import (EPS_CAP, EPS_SCALE, FILTER_BOX,
                                           MAT_LAMBERTIAN, MAX_BOUNCES_CAP, MAX_DEPTH,
                                           RR_DEPTH)
# Parameters a Lambertian row carries in the slots it never reads: the
# program's first texture (its default reflectance 0.5) and eta 1.5.
_LAMBERT_UNUSED = dict(ks=(0.5, 0.5, 0.5), rough=0.5, eta=1.5)


def _smooth_normals(positions, indices):
    """Angle-weighted vertex normals (Nelson Max): each triangle corner
    adds cross(e1, e2) / (|e1|^2 |e2|^2)."""
    normals = np.zeros_like(positions)
    tris = positions[indices]
    for c in range(3):
        p0 = tris[:, c]
        e1 = tris[:, (c + 1) % 3] - p0
        e2 = tris[:, (c + 2) % 3] - p0
        n = np.cross(e1, e2)
        denom = (e1 * e1).sum(-1) * (e2 * e2).sum(-1)
        w = np.where(denom > 0, 1.0 / np.maximum(denom, 1e-300), 0.0)
        np.add.at(normals, indices[:, c], n * w[:, None])
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    return np.where(lens > 0, normals / np.maximum(lens, 1e-300), normals)


def _material_row(mat):
    """(type, kd, ks, roughness, eta) of a configuration's material."""
    if mat['type'] == 'diffuse':
        u = _LAMBERT_UNUSED
        return MAT_LAMBERTIAN, mat['reflectance'], u['ks'], u['rough'], \
            u['eta']
    raise ValueError(f"no reference for material type {mat['type']!r}")


def _camera(cam, width, height):
    """(sample_to_cam, cam_to_world) 4x4 float64 of a perspective camera
    with its fov on the x axis."""
    origin = np.asarray(cam['origin'], np.float64)
    d = np.asarray(cam['target'], np.float64) - origin
    d = d / np.linalg.norm(d)
    up = np.asarray(cam['up'], np.float64)
    right = np.cross(up / np.linalg.norm(up), d)
    right = right / np.linalg.norm(right)
    to_world = np.eye(4)
    to_world[:3, 0] = right
    to_world[:3, 1] = np.cross(d, right)
    to_world[:3, 2] = d
    to_world[:3, 3] = origin
    aspect = width / height
    cot = 1.0 / np.tan(np.deg2rad(float(cam['fov'])) / 2.0)
    persp = np.array([[cot, 0.0, 0.0, 0.0], [0.0, cot, 0.0, 0.0],
                      [0.0, 0.0, 1.0, -1.0], [0.0, 0.0, 1.0, 0.0]])
    scale = np.diag([-0.5, -0.5 * aspect, 1.0, 1.0])
    shift = np.eye(4)
    shift[:3, 3] = (-1.0, -1.0 / aspect, 0.0)
    return np.linalg.inv(scale @ shift @ persp), to_world


def build(config, width, height, device='cpu'):
    """The reference scene of `config` (a configuration file's object) on a
    width x height film: a namespace with the tables and `meta` the plain
    form reads and `statics` (the vertex's scalar parameters)."""
    mats = config['materials']
    shapes = config['shapes']
    # geometry: triangles in shape order, each quad's pair rotated as the
    # cast-merge leaves it
    pos, idx, tri_shape, vnorm = [], [], [], []
    v_off = 0
    for sid, s in enumerate(shapes):
        p = np.concatenate([np.asarray(q, np.float64) for q in s['quads']])
        k = np.arange(len(s['quads']))[:, None] * 4
        mesh_idx = np.concatenate(
            [np.concatenate([k, k + 1, k + 2], 1),
             np.concatenate([k, k + 2, k + 3], 1)], 1).reshape(-1, 3)
        vnorm.append(_smooth_normals(p, mesh_idx))
        rot = mesh_idx.copy()
        rot[0::2] = mesh_idx[0::2][:, [1, 2, 0]]
        pos.append(p)
        idx.append(rot + v_off)
        tri_shape.append(np.full(len(rot), sid))
        v_off += len(p)
    P = np.concatenate(pos)
    N = np.concatenate(vnorm)
    I = np.concatenate(idx)
    t_shape = np.concatenate(tri_shape)
    nt = len(I)
    p0 = P[I[:, 0]]
    e1 = P[I[:, 1]] - p0
    e2 = P[I[:, 2]] - p0
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    shape_area = np.array([area[t_shape == s].sum()
                           for s in range(len(shapes))])

    # Woop rows of the cast primitives (the even, rotated triangles)
    M = np.stack([e1, e2, np.cross(e1, e2)], axis=-1)
    Minv = np.linalg.inv(M)
    bvec = -np.einsum('tij,tj->ti', Minv, p0)
    woop = np.concatenate([Minv[:, 0], bvec[:, 0:1], Minv[:, 1],
                           bvec[:, 1:2], Minv[:, 2], bvec[:, 2:3]], 1)
    cast_src = np.arange(0, nt, 2)

    lights = [(sid, s) for sid, s in enumerate(shapes) if 'emitter' in s]
    if len(lights) != 1:
        raise ValueError("the reference takes one area light")
    light_sid, light = lights[0]
    tri = np.zeros((40, nt))
    tri[0:3], tri[3:6], tri[6:9] = p0.T, e1.T, e2.T
    tri[9:12], tri[12:15], tri[15:18] = (N[I[:, c]].T for c in range(3))
    tri[18] = 1.0
    is_l = t_shape == light_sid
    tri[19] = np.where(is_l, 0, -1)
    stair = np.zeros(nt)
    for sid, s in enumerate(shapes):
        on = t_shape == sid
        typ, kd, ks, rough, eta = _material_row(mats[s['material']])
        tri[20:23, on] = np.asarray(kd, np.float64)[:, None]
        tri[28, on] = typ
        tri[29:32, on] = np.asarray(ks, np.float64)[:, None]
        tri[32, on], tri[33, on] = rough, eta
        tri[34, on] = 1.0
        tri[35, on] = -1
        cdf = np.cumsum(area[on]) / area[on].sum()
        cdf[-1] = 1.0
        stair[on] = sid + cdf
    tri[23:26, is_l] = np.asarray(light['emitter'], np.float64)[:, None]
    tri[26] = 1.0 / np.maximum(shape_area[t_shape], 1e-20)
    tri[27] = is_l
    tri[36] = -1
    fp_light = np.zeros((16, 1))
    fp_light[0:2] = 1.0
    fp_light[2:5, 0] = light['emitter']
    fp_light[5] = 1.0 / shape_area[light_sid]
    fp_light[6] = light_sid

    lo, hi = P.min(0), P.max(0)
    radius = float(np.linalg.norm(hi - 0.5 * (lo + hi)))
    cam = config['camera']
    if cam.get('filter', 'box') != 'box':
        raise ValueError("the reference's camera takes the box filter")
    s2c, c2w = _camera(cam, width, height)
    mat_types = tuple(sorted({int(_material_row(m)[0])
                              for m in mats.values()}))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa
                                    device=device)
    woop32 = f32(woop[cast_src])
    quad = f32(np.ones(len(cast_src)))
    eps = min(EPS_SCALE * radius, EPS_CAP)
    ns = types.SimpleNamespace(
        fp_tri=f32(tri), fp_woop=woop32, fp_woop_occ=woop32,
        cast_src=torch.as_tensor(cast_src, dtype=torch.int32, device=device),
        cast_alt=torch.as_tensor(cast_src + 1, dtype=torch.int32,
                                 device=device),
        cast_quad=quad, cast_occ_quad=quad, fp_light=f32(fp_light),
        tri_stair_cdf=f32(stair), fp_sph=f32(np.zeros((1, 24))),
        cam=torch.cat([f32(s2c).reshape(-1), f32(c2w).reshape(-1)]),
        width=width, height=height, filter_type=FILTER_BOX,
        filter_param=1.0,
        meta=types.SimpleNamespace(
            mat_types_present=mat_types, num_spheres=0, has_quads=True,
            scene_radius=radius,
            phase_types_present=(),
            camera_medium_id=-1),
        statics=dict(eps_isect=eps, eps_shadow=eps, max_depth=MAX_DEPTH,
                     rr_depth=RR_DEPTH, max_cap=MAX_BOUNCES_CAP),
        cast_prims=len(cast_src))
    return ns
