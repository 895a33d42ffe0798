"""DisneySheen: tinted Schlick-retro sheen lobe
(reference: materials/disney_sheen.inl), batched over lanes. Port of
lajolla_tpu/materials/disney_sheen.py."""

import torch

from lajolla_tpu_torch.core.math import dot, luminance, normalize, to_world
from lajolla_tpu_torch.materials import SampleRec, flip_frame_if_needed
from lajolla_tpu_torch.materials.common import (PI, pow5,
                                                sample_cos_hemisphere, tex1,
                                                tex3)
from lajolla_tpu_torch.scene.types import P_BASE_COLOR, P_SHEEN_TINT


def tint(base_color):
    """base_color over its luminance, white where that is not positive
    (the tint of the sheen and of the specular C0)."""
    lum = luminance(base_color)[:, None]
    return torch.where(lum <= 0, 1.0,
                       base_color / torch.clamp(lum, min=1e-20))


def sheen_color(base_color, sheen_tint):
    s = sheen_tint[:, None]
    return (1.0 - s) + s * tint(base_color)


def _below(hit, dir_in, dir_out):
    return (dot(hit.geometry_normal, dir_in) < 0) | \
        (dot(hit.geometry_normal, dir_out) < 0)


def eval(scene, mat_id, dir_in, dir_out, hit, adjoint):
    below = _below(hit, dir_in, dir_out)
    frame = flip_frame_if_needed(hit.frame, dir_in)
    base_color = tex3(scene, mat_id, P_BASE_COLOR, hit)
    sheen_tint = tex1(scene, mat_id, P_SHEEN_TINT, hit)
    h = normalize(dir_in + dir_out)
    n_dot_out = dot(frame[:, 2], dir_out)
    c_sheen = sheen_color(base_color, sheen_tint)
    f = c_sheen * pow5(1.0 - torch.abs(dot(h, dir_out)))[:, None] * \
        torch.abs(n_dot_out)[:, None]
    return torch.where(below[:, None], 0.0, f)


def pdf(scene, mat_id, dir_in, dir_out, hit, adjoint):
    below = _below(hit, dir_in, dir_out)
    frame = flip_frame_if_needed(hit.frame, dir_in)
    p = torch.clamp(dot(frame[:, 2], dir_out), min=0.0) / PI
    return torch.where(below, 0.0, p)


def sample(scene, mat_id, dir_in, hit, u2, w, adjoint):
    below = dot(hit.geometry_normal, dir_in) < 0
    frame = flip_frame_if_needed(hit.frame, dir_in)
    d = to_world(frame, sample_cos_hemisphere(u2))
    zero = torch.zeros_like(w)
    return SampleRec(dir_out=d, eta=zero, roughness=zero + 1.0,
                     valid=~below)
