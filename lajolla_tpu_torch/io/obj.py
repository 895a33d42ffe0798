"""Wavefront OBJ loader (host-side numpy).

Behavior replicates the reference's parse_obj (src/parse_obj.cpp):
  - v/vt/vn/f only; 1-based (and negative) indices; each distinct
    (v,vt,vn) triple becomes one output vertex (dedup map,
    parse_obj.cpp:94-135)
  - quads split into two triangles, >4-gons are an error
  - texture v coordinate flipped (1 - t, parse_obj.cpp:166)
  - when the file has no normals, angle-weighted smooth vertex normals
    are computed (Nelson Max's formula, parse_obj.cpp:57-92)
  - to_world applied to positions; normals by inverse-transpose.
"""

import numpy as np


def _compute_smooth_normals(positions, indices):
    """Angle-weighted vertex normals: contribution of each triangle corner
    is cross(e1, e2) / (|e1|^2 |e2|^2) where e1, e2 are the corner's
    adjacent edges (matches the reference's weighting)."""
    normals = np.zeros_like(positions)
    tris = positions[indices]  # (T, 3, 3)
    for c in range(3):
        p0 = tris[:, c]
        e1 = tris[:, (c + 1) % 3] - p0
        e2 = tris[:, (c + 2) % 3] - p0
        n = np.cross(e1, e2)
        l1 = (e1 * e1).sum(-1)
        l2 = (e2 * e2).sum(-1)
        denom = l1 * l2
        w = np.where(denom > 0, 1.0 / np.maximum(denom, 1e-300), 0.0)
        np.add.at(normals, indices[:, c], n * w[:, None])
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    return np.where(lens > 0, normals / np.maximum(lens, 1e-300), normals)


def load_obj(path, to_world=None):
    """Returns dict with positions (V,3), indices (T,3) int32,
    normals (V,3) or None, uvs (V,2) or None. All float64."""
    v_pool, vt_pool, vn_pool = [], [], []
    vertex_map = {}
    positions, normals, uvs, indices = [], [], [], []

    def get_vertex(tok):
        if tok in vertex_map:
            return vertex_map[tok]
        parts = tok.split('/')
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(v_pool) + vi
        ti = ni = None
        if len(parts) > 1 and parts[1]:
            t = int(parts[1])
            ti = t - 1 if t > 0 else len(vt_pool) + t
        if len(parts) > 2 and parts[2]:
            n = int(parts[2])
            ni = n - 1 if n > 0 else len(vn_pool) + n
        idx = len(positions)
        positions.append(v_pool[vi])
        uvs.append(vt_pool[ti] if ti is not None else None)
        normals.append(vn_pool[ni] if ni is not None else None)
        vertex_map[tok] = idx
        return idx

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            tok = line.split()
            if tok[0] == 'v':
                v_pool.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif tok[0] == 'vt':
                # flip v, as the reference does (parse_obj.cpp:166)
                vt_pool.append([float(tok[1]), 1.0 - float(tok[2])])
            elif tok[0] == 'vn':
                vn_pool.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif tok[0] == 'f':
                verts = [get_vertex(t) for t in tok[1:]]
                if len(verts) == 3:
                    indices.append(verts)
                elif len(verts) == 4:
                    indices.append([verts[0], verts[1], verts[2]])
                    indices.append([verts[0], verts[2], verts[3]])
                else:
                    raise ValueError(
                        f"{path}: faces with {len(verts)} vertices unsupported")

    positions = np.asarray(positions, np.float64)
    indices = np.asarray(indices, np.int32).reshape(-1, 3)

    has_uvs = any(u is not None for u in uvs)
    has_normals = any(n is not None for n in normals)
    uv_arr = None
    if has_uvs:
        uv_arr = np.asarray([u if u is not None else [0.0, 0.0] for u in uvs],
                            np.float64)
    n_arr = None
    if has_normals:
        n_arr = np.asarray([n if n is not None else [0.0, 0.0, 0.0]
                            for n in normals], np.float64)

    if to_world is not None:
        m = np.asarray(to_world, np.float64)
        positions = positions @ m[:3, :3].T + m[:3, 3]
        if n_arr is not None:
            inv = np.linalg.inv(m)
            n_arr = n_arr @ inv[:3, :3]
            lens = np.linalg.norm(n_arr, axis=-1, keepdims=True)
            n_arr = np.where(lens > 0, n_arr / np.maximum(lens, 1e-300), n_arr)

    if n_arr is None:
        # Reference computes smooth shading normals when absent
        # (parse_obj.cpp:229-231).
        n_arr = _compute_smooth_normals(positions, indices)

    return dict(positions=positions, indices=indices,
                normals=n_arr, uvs=uv_arr)
