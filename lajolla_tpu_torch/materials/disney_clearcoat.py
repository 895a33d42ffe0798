"""DisneyClearcoat: GTR1-style lobe with fixed eta-1.5 Schlick Fresnel
and fixed 0.25-roughness masking (reference:
materials/disney_clearcoat.inl; the masking calls smith_masking_gtr2
with roughness 0.5 → alpha 0.25), batched over lanes. Port of
lajolla_tpu/materials/disney_clearcoat.py."""

import torch

from lajolla_tpu_torch.core.math import (dot, normalize, safe_sqrt,
                                         to_local, to_world)
from lajolla_tpu_torch.materials import SampleRec, flip_frame_if_needed
from lajolla_tpu_torch.materials.common import (PI, TWO_PI, pow5,
                                                smith_masking_gtr2, tex1)
from lajolla_tpu_torch.scene.types import P_CLEARCOAT_GLOSS


def _schlick_f(h, dir_out):
    eta = 1.5
    r0 = (eta - 1.0) ** 2 / (eta + 1.0) ** 2
    return r0 + (1.0 - r0) * pow5(1.0 - torch.abs(dot(h, dir_out)))


def _dc_ref(clearcoat_gloss, hlz2):
    """Verbatim reference formula (disney_clearcoat.inl:10-16)."""
    a = (1.0 - clearcoat_gloss) * 0.1 + clearcoat_gloss * 0.001
    a2 = a * a
    return (a2 - 1.0) / (PI * torch.log(a2) * (1.0 + (a2 - 1.0) * hlz2))


def masking(frame, dir_in, dir_out):
    """The fixed-roughness masking product G."""
    return (smith_masking_gtr2(to_local(frame, dir_in), 0.5) *
            smith_masking_gtr2(to_local(frame, dir_out), 0.5))


def sample_half(gloss, u2, clamp_denominator):
    """The clearcoat half-vector in the shading frame. lajolla_tpu's
    DisneyBSDF clamps the denominator 1 - a^2 at 1e-20, its
    DisneyClearcoat does not."""
    a = (1.0 - gloss) * 0.1 + gloss * 0.001
    a2 = a * a
    den = 1.0 - a2
    if clamp_denominator:
        den = torch.clamp(den, min=1e-20)
    cos_h = safe_sqrt((1.0 - a2 ** (1.0 - u2[:, 0])) / den)
    sin_h = safe_sqrt(1.0 - cos_h * cos_h)
    azimuth = TWO_PI * u2[:, 1]
    return normalize(torch.stack([sin_h * torch.cos(azimuth),
                                  sin_h * torch.sin(azimuth), cos_h], -1))


def _below(hit, dir_in, dir_out):
    return (dot(hit.geometry_normal, dir_in) < 0) | \
        (dot(hit.geometry_normal, dir_out) < 0)


def eval(scene, mat_id, dir_in, dir_out, hit, adjoint):
    below = _below(hit, dir_in, dir_out)
    frame = flip_frame_if_needed(hit.frame, dir_in)
    h = normalize(dir_in + dir_out)
    n_dot_h = dot(frame[:, 2], h)
    n_dot_in = dot(frame[:, 2], dir_in)
    invalid = below | (n_dot_h <= 0)
    gloss = tex1(scene, mat_id, P_CLEARCOAT_GLOSS, hit)
    F = _schlick_f(h, dir_out)
    D = _dc_ref(gloss, n_dot_h * n_dot_h)
    G = masking(frame, dir_in, dir_out)
    val = F * D * G / torch.clamp(4.0 * torch.abs(n_dot_in), min=1e-20)
    return torch.where(invalid[:, None], 0.0,
                       torch.ones_like(dir_in) * val[:, None])


def pdf(scene, mat_id, dir_in, dir_out, hit, adjoint):
    below = _below(hit, dir_in, dir_out)
    frame = flip_frame_if_needed(hit.frame, dir_in)
    h = normalize(dir_in + dir_out)
    n_dot_h = dot(frame[:, 2], h)
    gloss = tex1(scene, mat_id, P_CLEARCOAT_GLOSS, hit)
    D = _dc_ref(gloss, n_dot_h * n_dot_h)
    p = D * torch.abs(n_dot_h) / torch.clamp(
        4.0 * torch.abs(dot(h, dir_out)), min=1e-20)
    return torch.where(below, 0.0, p)


def sample(scene, mat_id, dir_in, hit, u2, w, adjoint):
    below = dot(hit.geometry_normal, dir_in) < 0
    frame = flip_frame_if_needed(hit.frame, dir_in)
    gloss = tex1(scene, mat_id, P_CLEARCOAT_GLOSS, hit)
    h = to_world(frame, sample_half(gloss, u2, clamp_denominator=False))
    reflected = normalize(-dir_in + (2.0 * dot(dir_in, h))[:, None] * h)
    zero = torch.zeros_like(w)
    return SampleRec(dir_out=reflected, eta=zero, roughness=zero + 1.0,
                     valid=~below)
