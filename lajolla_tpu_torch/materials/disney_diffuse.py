"""DisneyDiffuse: Burley diffuse + subsurface mix
(reference: materials/disney_diffuse.inl), batched over lanes. Port of
lajolla_tpu/materials/disney_diffuse.py. NB the fork computes the
Schlick-style weights as (1 - cos^5), not (1 - cos)^5 — replicated
verbatim for output parity."""

import torch

from lajolla_tpu_torch.core.math import dot, normalize, to_world
from lajolla_tpu_torch.materials import SampleRec, flip_frame_if_needed
from lajolla_tpu_torch.materials.common import (PI, pow5,
                                                sample_cos_hemisphere, tex1,
                                                tex3)
from lajolla_tpu_torch.scene.types import (P_BASE_COLOR, P_ROUGHNESS,
                                           P_SUBSURFACE)


def _below(hit, dir_in, dir_out):
    return (dot(hit.geometry_normal, dir_in) < 0) | \
        (dot(hit.geometry_normal, dir_out) < 0)


def _c(x):
    return x[:, None]


def burley(base_color, roughness, subsurface, h_dot_out, n_dot_in,
           n_dot_out):
    """The diffuse + subsurface mix (disney_diffuse.inl), shared with
    disney_bsdf's diffuse lobe, in lajolla_tpu's order of operations.
    (N, 3) base color, (N,) the rest."""
    fd90 = 0.5 + 2.0 * roughness * h_dot_out * h_dot_out
    fd_in = 1.0 + (fd90 - 1.0) * (1.0 - pow5(n_dot_in))
    fd_out = 1.0 + (fd90 - 1.0) * (1.0 - pow5(n_dot_out))
    abs_out = _c(torch.abs(n_dot_out))
    f_d = base_color * _c(fd_in) * _c(fd_out) * abs_out / PI

    fss90 = roughness * h_dot_out * h_dot_out
    fss_in = 1.0 + (fss90 - 1.0) * (1.0 - pow5(n_dot_in))
    fss_out = 1.0 + (fss90 - 1.0) * (1.0 - pow5(n_dot_out))
    f_ss = (1.25 * base_color *
            _c(fss_in * fss_out * (1.0 / torch.clamp(
                torch.abs(n_dot_in) + torch.abs(n_dot_out), min=1e-20) -
                0.5) + 0.5) * abs_out / PI)
    return (1.0 - _c(subsurface)) * f_d + _c(subsurface) * f_ss


def eval(scene, mat_id, dir_in, dir_out, hit, adjoint):
    below = _below(hit, dir_in, dir_out)
    frame = flip_frame_if_needed(hit.frame, dir_in)
    base_color = tex3(scene, mat_id, P_BASE_COLOR, hit)
    roughness = tex1(scene, mat_id, P_ROUGHNESS, hit)
    subsurface = tex1(scene, mat_id, P_SUBSURFACE, hit)
    h = normalize(dir_in + dir_out)
    f = burley(base_color, roughness, subsurface, dot(h, dir_out),
               dot(frame[:, 2], dir_in), dot(frame[:, 2], dir_out))
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
