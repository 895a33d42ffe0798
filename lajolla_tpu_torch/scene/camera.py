"""Pinhole camera + pixel-filter importance sampling, batched over lanes.

Two samplers of src/camera.cpp:23-47 with the three pixel filters
(src/filters/{box,tent,gaussian}.inl), each in the rounding order of its
lajolla_tpu original:
- `sample_primary`, the general engines', follows lajolla_tpu's
  scene/camera.py: (N, 3) rays from given filter uniforms, through the
  camera's matrices (core/transform.py);
- `sample_primary_t`, the fused kernels' (K1, K8, K9) and their plain
  forms', follows lajolla_tpu's path_megakernel._primary: (3, N) rays
  whose uniforms it hashes from the work item, through the camera record
  (`camera_record`) with products written out as csrc/camera.cuh takes
  them.
Both stay: each engine is held to lajolla_tpu's in its own sampler's
rounding order, and the two orders differ (matrix transforms and
`normalize` against products written out and `normalize3`).
"""

import torch

from lajolla_tpu_torch.core.math import normalize, normalize3
from lajolla_tpu_torch.core.random import GOLD, M32, hash_u01, pcg_hash
from lajolla_tpu_torch.core.transform import xform_point, xform_vector
from lajolla_tpu_torch.scene.types import (FILTER_BOX, FILTER_GAUSSIAN,
                                           FILTER_TENT)

TWO_PI = 6.283185307179586


def sample_filter(filter_type, filter_param, u):
    """u: (N, 2) uniforms → (N, 2) pixel-space offsets from the pixel
    center."""
    if filter_type == FILTER_BOX:
        return (2.0 * u - 1.0) * (filter_param / 2.0)
    if filter_type == FILTER_TENT:
        h = filter_param / 2.0
        return torch.where(u < 0.5, h * (torch.sqrt(2.0 * u) - 1.0),
                           h * (1.0 - torch.sqrt(torch.clamp(
                               1.0 - 2.0 * (u - 0.5), min=0.0))))
    if filter_type == FILTER_GAUSSIAN:
        r = filter_param * torch.sqrt(
            -2.0 * torch.log(torch.clamp(u[:, 0], min=1e-8)))
        return torch.stack([r * torch.cos(TWO_PI * u[:, 1]),
                            r * torch.sin(TWO_PI * u[:, 1])], -1)
    raise ValueError(f"unknown filter type {filter_type}")


def sample_primary(scene, options, px, py, u_filter):
    """Camera rays through pixels (px, py) ((N,) float) with
    filter-sampled subpixel offsets. Returns (org, dir), each (N, 3)."""
    offset = sample_filter(options.filter_type, options.filter_param,
                           u_filter)
    w = scene.meta.width
    h = scene.meta.height
    x = (px + 0.5 + offset[:, 0]) / w
    y = (py + 0.5 + offset[:, 1]) / h
    pt = xform_point(scene.sample_to_cam,
                     torch.stack([x, y, torch.zeros_like(x)], -1))
    dir_cam = normalize(pt)
    org = scene.cam_to_world[:3, 3].expand(px.shape[0], 3).clone()
    d = normalize(xform_vector(scene.cam_to_world, dir_cam))
    return org, d


def camera_record(scene):
    """The (32,) camera record the fused kernels read (csrc/camera.cuh,
    kernels._camera) and `sample_primary_t` takes: sample_to_cam's 16
    values row-major, then cam_to_world's, on the scene's device."""
    return torch.cat([scene.sample_to_cam.reshape(-1),
                      scene.cam_to_world.reshape(-1)])


def sample_primary_t(item, px, py, su, cam, *, w, h, filter_type,
                     filter_param):
    """Camera ray for work items `item` (int64) of pixels (px, py).
    Mirrors lajolla_tpu path_megakernel._primary (src/camera.cpp:23-47).
    cam: the (32,) `camera_record`. Returns (org, dir), each (3, N)."""
    hp = pcg_hash(item ^ pcg_hash(su ^ 0xCAFEF00D))
    u0 = hash_u01(pcg_hash((hp + GOLD) & M32))
    u1 = hash_u01(pcg_hash((hp + (2 * GOLD & M32)) & M32))
    if filter_type == FILTER_BOX:
        ox = (2.0 * u0 - 1.0) * (filter_param / 2.0)
        oy = (2.0 * u1 - 1.0) * (filter_param / 2.0)
    elif filter_type == FILTER_TENT:
        fh = filter_param / 2.0

        def warp(r):
            return torch.where(
                r < 0.5, fh * (torch.sqrt(2.0 * r) - 1.0),
                fh * (1.0 - torch.sqrt(torch.clamp(1.0 - 2.0 * (r - 0.5),
                                                   min=0.0))))
        ox, oy = warp(u0), warp(u1)
    elif filter_type == FILTER_GAUSSIAN:
        r = filter_param * torch.sqrt(
            -2.0 * torch.log(torch.clamp(u0, min=1e-8)))
        ox = r * torch.cos(TWO_PI * u1)
        oy = r * torch.sin(TWO_PI * u1)
    else:
        raise ValueError(f"unknown filter type {filter_type}")
    x = (px + 0.5 + ox) * (1.0 / w)
    y = (py + 0.5 + oy) * (1.0 / h)
    # pt = sample_to_cam @ [x, y, 0, 1] with homogeneous divide
    rx = cam[0] * x + cam[1] * y + cam[3]
    ry = cam[4] * x + cam[5] * y + cam[7]
    rz = cam[8] * x + cam[9] * y + cam[11]
    rw = cam[12] * x + cam[13] * y + cam[15]
    inv_w = 1.0 / rw
    cx, cy, cz = normalize3(rx * inv_w, ry * inv_w, rz * inv_w)
    dx = cam[16] * cx + cam[17] * cy + cam[18] * cz
    dy = cam[20] * cx + cam[21] * cy + cam[22] * cz
    dz = cam[24] * cx + cam[25] * cy + cam[26] * cz
    d = torch.stack(normalize3(dx, dy, dz))
    org = torch.stack([cam[19], cam[23], cam[27]])[:, None].repeat(
        1, d.shape[1])
    return org, d
