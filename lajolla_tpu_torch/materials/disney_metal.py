"""DisneyMetal: anisotropic GTR2 + Smith GGX with Schlick base-color
Fresnel (reference: materials/disney_metal.inl), batched over lanes.
Port of lajolla_tpu/materials/disney_metal.py."""

import torch

from lajolla_tpu_torch.core.math import dot, normalize, to_local, to_world
from lajolla_tpu_torch.materials import SampleRec, flip_frame_if_needed
from lajolla_tpu_torch.materials.common import (gtr2_aniso, pow5,
                                                sample_visible_normals_aniso,
                                                smith_g_ggx_aniso, tex1, tex3)
from lajolla_tpu_torch.scene.types import (P_ANISOTROPIC, P_BASE_COLOR,
                                           P_ROUGHNESS)

A_MIN = 1e-4


def aniso_alphas(roughness, anisotropic):
    aspect = torch.sqrt(1.0 - 0.9 * anisotropic)
    ax = torch.clamp(roughness * roughness / aspect, min=A_MIN)
    ay = torch.clamp(roughness * roughness * aspect, min=A_MIN)
    return ax, ay


def _below(hit, dir_in, dir_out):
    return (dot(hit.geometry_normal, dir_in) < 0) | \
        (dot(hit.geometry_normal, dir_out) < 0)


def _alphas(scene, mat_id, hit):
    roughness = torch.clamp(tex1(scene, mat_id, P_ROUGHNESS, hit), 0.01, 1.0)
    anisotropic = tex1(scene, mat_id, P_ANISOTROPIC, hit)
    return (roughness,) + aniso_alphas(roughness, anisotropic)


def eval(scene, mat_id, dir_in, dir_out, hit, adjoint):
    below = _below(hit, dir_in, dir_out)
    frame = flip_frame_if_needed(hit.frame, dir_in)
    base_color = tex3(scene, mat_id, P_BASE_COLOR, hit)
    _, ax, ay = _alphas(scene, mat_id, hit)

    h = normalize(dir_in + dir_out)
    h_dot_out = dot(h, dir_out)
    Fm = base_color + (1.0 - base_color) * \
        pow5(1.0 - torch.abs(h_dot_out))[:, None]
    Dm = gtr2_aniso(to_local(frame, h), ax, ay)
    Gin = smith_g_ggx_aniso(to_local(frame, dir_in), ax, ay)
    Gout = smith_g_ggx_aniso(to_local(frame, dir_out), ax, ay)
    f = Fm * Dm[:, None] * Gin[:, None] * Gout[:, None] / torch.clamp(
        4.0 * torch.abs(dot(dir_in, frame[:, 2])), min=1e-20)[:, None]
    return torch.where(below[:, None], 0.0, f)


def pdf(scene, mat_id, dir_in, dir_out, hit, adjoint):
    below = _below(hit, dir_in, dir_out)
    frame = flip_frame_if_needed(hit.frame, dir_in)
    _, ax, ay = _alphas(scene, mat_id, hit)
    h = normalize(dir_in + dir_out)
    Dm = gtr2_aniso(to_local(frame, h), ax, ay)
    Gin = smith_g_ggx_aniso(to_local(frame, dir_in), ax, ay)
    p = Dm * Gin / torch.clamp(4.0 * torch.abs(dot(dir_in, frame[:, 2])),
                               min=1e-20)
    return torch.where(below, 0.0, p)


def sample(scene, mat_id, dir_in, hit, u2, w, adjoint):
    below = dot(hit.geometry_normal, dir_in) < 0
    frame = flip_frame_if_needed(hit.frame, dir_in)
    roughness, ax, ay = _alphas(scene, mat_id, hit)
    local_h = sample_visible_normals_aniso(to_local(frame, dir_in), ax, ay,
                                           u2)
    h = to_world(frame, local_h)
    reflected = normalize(-dir_in + (2.0 * dot(dir_in, h))[:, None] * h)
    return SampleRec(dir_out=reflected, eta=torch.zeros_like(w),
                     roughness=roughness, valid=~below)
