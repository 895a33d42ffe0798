"""Lambertian BSDF (reference: materials/lambertian.inl), batched over
lanes. Port of lajolla_tpu/materials/lambertian.py."""

import torch

from lajolla_tpu_torch.core.math import dot, to_world
from lajolla_tpu_torch.materials import SampleRec, flip_frame_if_needed
from lajolla_tpu_torch.materials.common import (PI, sample_cos_hemisphere,
                                                tex3)
from lajolla_tpu_torch.scene.types import P_BASE_COLOR


def _below(hit, dir_in, dir_out):
    return (dot(hit.geometry_normal, dir_in) < 0) | \
        (dot(hit.geometry_normal, dir_out) < 0)


def eval(scene, mat_id, dir_in, dir_out, hit, adjoint):
    below = _below(hit, dir_in, dir_out)
    frame = flip_frame_if_needed(hit.frame, dir_in)
    refl = tex3(scene, mat_id, P_BASE_COLOR, hit)
    f = torch.clamp(dot(frame[:, 2], dir_out), min=0.0)[:, None] * refl / PI
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
