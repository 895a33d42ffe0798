"""RoughPlastic BSDF: GGX dielectric coat over a Lambertian base
(reference: materials/roughplastic.inl; two-layer model without
interlayer multiple scattering, material.h:16-33), batched over lanes.
Port of lajolla_tpu/materials/roughplastic.py."""

import torch

from lajolla_tpu_torch.core.math import (dot, luminance, normalize,
                                         to_local, to_world)
from lajolla_tpu_torch.materials import SampleRec, flip_frame_if_needed
from lajolla_tpu_torch.materials.common import (PI, fresnel_dielectric,
                                                ggx_d, sample_cos_hemisphere,
                                                sample_visible_normals,
                                                smith_masking_gtr2, tex1,
                                                tex3)
from lajolla_tpu_torch.scene.soa import fetch_mat
from lajolla_tpu_torch.scene.types import (P_AUX_COLOR, P_BASE_COLOR,
                                           P_ROUGHNESS)


def _common(scene, mat_id, dir_in, dir_out, hit):
    below = (dot(hit.geometry_normal, dir_in) < 0) | \
            (dot(hit.geometry_normal, dir_out) < 0)
    frame = flip_frame_if_needed(hit.frame, dir_in)
    h = normalize(dir_in + dir_out)
    n = frame[:, 2]
    n_dot_h = dot(n, h)
    n_dot_in = dot(n, dir_in)
    n_dot_out = dot(n, dir_out)
    invalid = below | (n_dot_out <= 0) | (n_dot_h <= 0)
    return frame, h, n_dot_h, n_dot_in, n_dot_out, invalid


def _roughness(scene, mat_id, hit):
    return torch.clamp(tex1(scene, mat_id, P_ROUGHNESS, hit), 0.01, 1.0)


def eval(scene, mat_id, dir_in, dir_out, hit, adjoint):
    frame, h, n_dot_h, n_dot_in, n_dot_out, invalid = _common(
        scene, mat_id, dir_in, dir_out, hit)
    kd = tex3(scene, mat_id, P_BASE_COLOR, hit)
    ks = tex3(scene, mat_id, P_AUX_COLOR, hit)
    roughness = _roughness(scene, mat_id, hit)
    eta = fetch_mat(scene, mat_id).eta

    F_o = fresnel_dielectric(dot(h, dir_out), eta)
    D = ggx_d(n_dot_h, roughness)
    G = (smith_masking_gtr2(to_local(frame, dir_in), roughness) *
         smith_masking_gtr2(to_local(frame, dir_out), roughness))
    spec = ks * (G * F_o * D)[:, None] / torch.clamp(
        4.0 * n_dot_in * n_dot_out, min=1e-20)[:, None]
    F_i = fresnel_dielectric(dot(h, dir_in), eta)
    diff = kd * (1.0 - F_o)[:, None] * (1.0 - F_i)[:, None] / PI
    f = (spec + diff) * n_dot_out[:, None]
    return torch.where(invalid[:, None], 0.0, f)


def pdf(scene, mat_id, dir_in, dir_out, hit, adjoint):
    frame, h, n_dot_h, n_dot_in, n_dot_out, invalid = _common(
        scene, mat_id, dir_in, dir_out, hit)
    ks = tex3(scene, mat_id, P_AUX_COLOR, hit)
    kd = tex3(scene, mat_id, P_BASE_COLOR, hit)
    lS = luminance(ks)
    lR = luminance(kd)
    total = lS + lR
    invalid = invalid | (total <= 0)
    roughness = _roughness(scene, mat_id, hit)
    spec_prob = lS / torch.clamp(total, min=1e-20)
    diff_prob = 1.0 - spec_prob
    G = smith_masking_gtr2(to_local(frame, dir_in), roughness)
    D = ggx_d(n_dot_h, roughness)
    spec_prob = spec_prob * (G * D) / torch.clamp(4.0 * n_dot_in, min=1e-20)
    diff_prob = diff_prob * n_dot_out / PI
    return torch.where(invalid, 0.0, spec_prob + diff_prob)


def sample(scene, mat_id, dir_in, hit, u2, w, adjoint):
    below = dot(hit.geometry_normal, dir_in) < 0
    frame = flip_frame_if_needed(hit.frame, dir_in)
    ks = tex3(scene, mat_id, P_AUX_COLOR, hit)
    kd = tex3(scene, mat_id, P_BASE_COLOR, hit)
    lS = luminance(ks)
    lR = luminance(kd)
    total = lS + lR
    valid = ~below & (total > 0)
    spec_prob = lS / torch.clamp(total, min=1e-20)
    roughness = _roughness(scene, mat_id, hit)

    local_dir_in = to_local(frame, dir_in)
    alpha = roughness * roughness
    local_h = sample_visible_normals(local_dir_in, alpha, u2)
    h = to_world(frame, local_h)
    reflected = normalize(-dir_in + (2.0 * dot(dir_in, h))[:, None] * h)

    diffuse_dir = to_world(frame, sample_cos_hemisphere(u2))

    take_spec = w < spec_prob
    return SampleRec(
        dir_out=torch.where(take_spec[:, None], reflected, diffuse_dir),
        eta=torch.zeros_like(w),
        roughness=torch.where(take_spec, roughness, 1.0),
        valid=valid)
