"""Pinhole camera + pixel-filter importance sampling, batched over lanes.

Port of lajolla_tpu/scene/camera.py: sample_primary (src/camera.cpp:23-47)
and the three pixel filters (src/filters/{box,tent,gaussian}.inl), in
lajolla_tpu's rounding order. The general engine samples its camera rays
here; the fused kernels' drivers keep path_megakernel._primary.
"""

import torch

from lajolla_tpu_torch.core.math import normalize
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
