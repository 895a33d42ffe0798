"""Wide-row scene record fetchers, batched over lanes.

Port of lajolla_tpu/scene/soa.py. The scene compiler denormalizes the hot
per-hit lookups into merged wide-row tables (tri_shade, shape_tab,
light_tab, mat_tab, tex_tab); each helper fetches rows with one index
gather and names their columns. lajolla_tpu fetches through one-hot
matmuls (ops/gather.fast_gather), a TPU workaround; an index gather
reads the same values. Integer ids are stored as float32 in these tables,
exact below 2^24.

Indices are (N,) int tensors; every field comes back with a leading N
axis. Negative indices (misses) are clamped to row 0 by the callers, as
lajolla_tpu's are.
"""

from typing import NamedTuple

import torch


def _rows(table, idx):
    # an index past the table (another record kind's id, on a lane where
    # the row is never selected) is clamped, as XLA clamps a gather
    return table[torch.clamp(idx.long(), 0, table.shape[0] - 1)]


def _i(x):
    return x.to(torch.int32)


class TriShade(NamedTuple):
    p0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor
    uv1: torch.Tensor
    uv2: torch.Tensor
    shape_id: torch.Tensor  # int32


def fetch_tri(scene, prim):
    row = _rows(scene.tri_shade, prim)
    return TriShade(
        p0=row[:, 0:3], e1=row[:, 3:6], e2=row[:, 6:9],
        n0=row[:, 9:12], n1=row[:, 12:15], n2=row[:, 15:18],
        uv0=row[:, 18:20], uv1=row[:, 20:22], uv2=row[:, 22:24],
        shape_id=_i(row[:, 24]))


class ShapeRec(NamedTuple):
    material_id: torch.Tensor
    light_id: torch.Tensor
    interior_med: torch.Tensor
    exterior_med: torch.Tensor
    type: torch.Tensor
    prim_start: torch.Tensor
    prim_count: torch.Tensor
    has_normals: torch.Tensor
    has_uvs: torch.Tensor
    area: torch.Tensor


def fetch_shape(scene, shape_id):
    row = _rows(scene.shape_tab, shape_id)
    return ShapeRec(material_id=_i(row[:, 0]), light_id=_i(row[:, 1]),
                    interior_med=_i(row[:, 2]), exterior_med=_i(row[:, 3]),
                    type=_i(row[:, 4]), prim_start=_i(row[:, 5]),
                    prim_count=_i(row[:, 9]), has_normals=_i(row[:, 6]),
                    has_uvs=_i(row[:, 7]), area=row[:, 8])


class LightRec(NamedTuple):
    type: torch.Tensor
    shape_id: torch.Tensor   # image id for envmap rows
    intensity: torch.Tensor  # (N, 3)
    pmf: torch.Tensor


def fetch_light(scene, light_id):
    row = _rows(scene.light_tab, light_id)
    return LightRec(type=_i(row[:, 0]), shape_id=_i(row[:, 1]),
                    intensity=row[:, 2:5], pmf=row[:, 5])


class MatRec(NamedTuple):
    type: torch.Tensor
    eta: torch.Tensor
    tex: torch.Tensor  # (N, NUM_PARAM_SLOTS) int32 texture descriptor ids


def fetch_mat(scene, mat_id):
    row = _rows(scene.mat_tab, mat_id)
    return MatRec(type=_i(row[:, 0]), eta=row[:, 1], tex=_i(row[:, 2:15]))


class TexRec(NamedTuple):
    kind: torch.Tensor
    image_id: torch.Tensor
    const: torch.Tensor     # (N, 3)
    color1: torch.Tensor    # (N, 3)
    uvscale: torch.Tensor   # (N, 2)
    uvoffset: torch.Tensor  # (N, 2)


def fetch_tex(scene, tex_id):
    row = _rows(scene.tex_tab, torch.clamp(tex_id, min=0))
    return TexRec(kind=_i(row[:, 0]), image_id=_i(row[:, 1]),
                  const=row[:, 2:5], color1=row[:, 5:8],
                  uvscale=row[:, 8:10], uvoffset=row[:, 10:12])
