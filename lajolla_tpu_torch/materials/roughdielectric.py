"""RoughDielectric: Walter et al. GGX rough glass
(reference: materials/roughdielectric.inl), batched over lanes. Port of
lajolla_tpu/materials/roughdielectric.py: two-sided refraction with the
generalized half-vector, the eta-adjoint correction, and a Fresnel-driven
reflect/refract lobe choice."""

import torch

from lajolla_tpu_torch.core.math import (dot, normalize, safe_sqrt,
                                         to_local, to_world)
from lajolla_tpu_torch.materials import SampleRec
from lajolla_tpu_torch.materials.common import (fresnel_dielectric, ggx_d,
                                                sample_visible_normals,
                                                smith_masking_gtr2, tex1,
                                                tex3)
from lajolla_tpu_torch.scene.soa import fetch_mat
from lajolla_tpu_torch.scene.types import (P_AUX_COLOR, P_BASE_COLOR,
                                           P_ROUGHNESS)


def _c(x):
    return x[:, None]


def _setup(scene, mat_id, dir_in, hit):
    """Shared: two-sided frame flip + directional eta
    (roughdielectric.inl:8-16)."""
    g_dot_in = dot(hit.geometry_normal, dir_in)
    frame = hit.frame
    flip = dot(frame[:, 2], dir_in) * g_dot_in < 0
    frame = torch.where(flip[:, None, None], -frame, frame)
    base_eta = fetch_mat(scene, mat_id).eta
    eta = torch.where(g_dot_in > 0, base_eta, 1.0 / base_eta)
    roughness = torch.clamp(tex1(scene, mat_id, P_ROUGHNESS, hit), 0.01, 1.0)
    return frame, eta, roughness, g_dot_in


def _half_vector(dir_in, dir_out, eta, frame, reflect):
    h_r = normalize(dir_in + dir_out)
    h_t = normalize(dir_in + dir_out * _c(eta))
    h = torch.where(_c(reflect), h_r, h_t)
    return torch.where(_c(dot(h, frame[:, 2]) < 0), -h, h)


def eval(scene, mat_id, dir_in, dir_out, hit, adjoint):
    frame, eta, roughness, g_dot_in = _setup(scene, mat_id, dir_in, hit)
    reflect = g_dot_in * dot(hit.geometry_normal, dir_out) > 0
    ks = tex3(scene, mat_id, P_BASE_COLOR, hit)
    kt = tex3(scene, mat_id, P_AUX_COLOR, hit)
    h = _half_vector(dir_in, dir_out, eta, frame, reflect)

    h_dot_in = dot(h, dir_in)
    F = fresnel_dielectric(h_dot_in, eta)
    D = ggx_d(dot(frame[:, 2], h), roughness)
    G = (smith_masking_gtr2(to_local(frame, dir_in), roughness) *
         smith_masking_gtr2(to_local(frame, dir_out), roughness))
    n_dot_in_abs = torch.abs(dot(frame[:, 2], dir_in))

    f_refl = ks * _c(F * D * G) / _c(torch.clamp(4.0 * n_dot_in_abs,
                                                 min=1e-20))

    # Non-reciprocal eta factor (roughdielectric.inl:57-64): radiance
    # transport (camera→light, the reference's TO_LIGHT default) carries
    # 1/eta^2; the adjoint (importance transport) does not. `adjoint` is a
    # static Python bool.
    ef = 1.0 if adjoint else 1.0 / (eta * eta)
    h_dot_out = dot(h, dir_out)
    sqrt_denom = h_dot_in + eta * h_dot_out
    f_trans = kt * _c(ef * (1.0 - F) * D * G * eta * eta *
                      torch.abs(h_dot_out * h_dot_in)) / \
        _c(torch.clamp(n_dot_in_abs * sqrt_denom * sqrt_denom, min=1e-20))

    return torch.where(_c(reflect), f_refl, f_trans)


def pdf(scene, mat_id, dir_in, dir_out, hit, adjoint):
    frame, eta, roughness, g_dot_in = _setup(scene, mat_id, dir_in, hit)
    reflect = g_dot_in * dot(hit.geometry_normal, dir_out) > 0
    h = _half_vector(dir_in, dir_out, eta, frame, reflect)
    h_dot_in = dot(h, dir_in)
    F = fresnel_dielectric(h_dot_in, eta)
    D = ggx_d(dot(h, frame[:, 2]), roughness)
    G_in = smith_masking_gtr2(to_local(frame, dir_in), roughness)
    n_dot_in = dot(frame[:, 2], dir_in)

    p_refl = (F * D * G_in) / torch.clamp(4.0 * torch.abs(n_dot_in),
                                          min=1e-20)
    h_dot_out = dot(h, dir_out)
    sqrt_denom = h_dot_in + eta * h_dot_out
    dh_dout = eta * eta * h_dot_out / torch.clamp(sqrt_denom * sqrt_denom,
                                                  min=1e-20)
    p_trans = (1.0 - F) * D * G_in * torch.abs(
        dh_dout * h_dot_in / torch.where(n_dot_in == 0, 1.0, n_dot_in))
    return torch.where(reflect, p_refl, p_trans)


def sample(scene, mat_id, dir_in, hit, u2, w, adjoint):
    frame, eta, roughness, g_dot_in = _setup(scene, mat_id, dir_in, hit)
    alpha = roughness * roughness
    local_dir_in = to_local(frame, dir_in)
    local_h = sample_visible_normals(local_dir_in, alpha, u2)
    h = to_world(frame, local_h)
    h = torch.where(_c(dot(h, frame[:, 2]) < 0), -h, h)

    h_dot_in = dot(h, dir_in)
    F = fresnel_dielectric(h_dot_in, eta)

    reflected = normalize(-dir_in + _c(2.0 * dot(dir_in, h)) * h)

    h_dot_out_sq = 1.0 - (1.0 - h_dot_in * h_dot_in) / (eta * eta)
    tir = h_dot_out_sq <= 0
    h_flip = torch.where(_c(h_dot_in < 0), -h, h)
    h_dot_out = safe_sqrt(h_dot_out_sq)
    refracted = -dir_in / _c(eta) + \
        _c(torch.abs(h_dot_in) / eta - h_dot_out) * h_flip

    take_refl = w <= F
    return SampleRec(
        dir_out=torch.where(_c(take_refl), reflected, refracted),
        eta=torch.where(take_refl, 0.0, eta),
        roughness=roughness,
        valid=take_refl | ~tir)
