"""DisneyGlass: anisotropic rough dielectric with base_color /
sqrt(base_color) tint (reference: materials/disney_glass.inl), batched
over lanes. Port of lajolla_tpu/materials/disney_glass.py. NB this
fork's transmission term omits the reference rough-dielectric's
eta^2 & adjoint eta factor (disney_glass.inl:80-84) — replicated
verbatim."""

import torch

from lajolla_tpu_torch.core.math import (dot, normalize, safe_sqrt,
                                         to_local, to_world)
from lajolla_tpu_torch.materials import SampleRec
from lajolla_tpu_torch.materials.common import (fresnel_dielectric,
                                                gtr2_aniso,
                                                sample_visible_normals_aniso,
                                                smith_g_ggx_aniso, tex1, tex3)
from lajolla_tpu_torch.materials.disney_metal import aniso_alphas
from lajolla_tpu_torch.scene.soa import fetch_mat
from lajolla_tpu_torch.scene.types import (P_ANISOTROPIC, P_BASE_COLOR,
                                           P_ROUGHNESS)


def _c(x):
    return x[:, None]


def _setup(scene, mat_id, dir_in, hit):
    g_dot_in = dot(hit.geometry_normal, dir_in)
    frame = hit.frame
    flip = dot(frame[:, 2], dir_in) * g_dot_in < 0
    frame = torch.where(flip[:, None, None], -frame, frame)
    base_eta = fetch_mat(scene, mat_id).eta
    eta = torch.where(g_dot_in > 0, base_eta, 1.0 / base_eta)
    roughness = torch.clamp(tex1(scene, mat_id, P_ROUGHNESS, hit), 0.01, 1.0)
    anisotropic = tex1(scene, mat_id, P_ANISOTROPIC, hit)
    ax, ay = aniso_alphas(roughness, anisotropic)
    return frame, eta, roughness, ax, ay, g_dot_in


def _half(dir_in, dir_out, eta, frame, reflect):
    h = torch.where(_c(reflect), normalize(dir_in + dir_out),
                    normalize(dir_in + dir_out * _c(eta)))
    return torch.where(_c(dot(h, frame[:, 2]) < 0), -h, h)


def glass_eval(base_color, F, D, G, h_dot_in, h_dot_out, eta,
               n_dot_in_abs, reflect):
    """The tinted reflection / transmission value (shared with
    disney_bsdf's glass lobe)."""
    f_refl = base_color * _c(F * D * G) / _c(torch.clamp(
        4.0 * n_dot_in_abs, min=1e-20))
    sqrt_denom = h_dot_in + eta * h_dot_out
    denom = sqrt_denom * sqrt_denom
    f_trans = (safe_sqrt(base_color) * _c(1.0 - F) * _c(D) * _c(G) *
               _c(torch.abs(h_dot_out * h_dot_in)) /
               _c(torch.clamp(n_dot_in_abs * denom, min=1e-20)))
    return torch.where(_c(reflect), f_refl, f_trans)


def glass_pdf(F, D, G_in, h_dot_in, h_dot_out, eta, n_dot_in, reflect):
    """The reflection / transmission pdf (shared with disney_bsdf)."""
    p_refl = (F * D * G_in) / torch.clamp(4.0 * torch.abs(n_dot_in),
                                          min=1e-20)
    sqrt_denom = h_dot_in + eta * h_dot_out
    dh_dout = eta * eta * h_dot_out / torch.clamp(sqrt_denom * sqrt_denom,
                                                  min=1e-20)
    p_trans = (1.0 - F) * D * G_in * torch.abs(
        dh_dout * h_dot_in / torch.where(n_dot_in == 0, 1.0, n_dot_in))
    return torch.where(reflect, p_refl, p_trans)


def sample_glass(frame, dir_in, eta, ax, ay, u2):
    """VNDF half-vector and both outgoing directions: (reflected,
    refracted, F, tir) (shared with disney_bsdf)."""
    local_h = sample_visible_normals_aniso(to_local(frame, dir_in), ax, ay,
                                           u2)
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
    return reflected, refracted, F, tir


def eval(scene, mat_id, dir_in, dir_out, hit, adjoint):
    frame, eta, roughness, ax, ay, g_dot_in = _setup(scene, mat_id, dir_in,
                                                     hit)
    reflect = g_dot_in * dot(hit.geometry_normal, dir_out) > 0
    base_color = tex3(scene, mat_id, P_BASE_COLOR, hit)
    h = _half(dir_in, dir_out, eta, frame, reflect)
    h_dot_in = dot(h, dir_in)
    F = fresnel_dielectric(h_dot_in, eta)
    D = gtr2_aniso(to_local(frame, h), ax, ay)
    G = smith_g_ggx_aniso(to_local(frame, dir_in), ax, ay)
    n_dot_in_abs = torch.abs(dot(frame[:, 2], dir_in))
    return glass_eval(base_color, F, D, G, h_dot_in, dot(h, dir_out), eta,
                      n_dot_in_abs, reflect)


def pdf(scene, mat_id, dir_in, dir_out, hit, adjoint):
    frame, eta, roughness, ax, ay, g_dot_in = _setup(scene, mat_id, dir_in,
                                                     hit)
    reflect = g_dot_in * dot(hit.geometry_normal, dir_out) > 0
    h = _half(dir_in, dir_out, eta, frame, reflect)
    h_dot_in = dot(h, dir_in)
    F = fresnel_dielectric(h_dot_in, eta)
    D = gtr2_aniso(to_local(frame, h), ax, ay)
    G_in = smith_g_ggx_aniso(to_local(frame, dir_in), ax, ay)
    return glass_pdf(F, D, G_in, h_dot_in, dot(h, dir_out), eta,
                     dot(frame[:, 2], dir_in), reflect)


def sample(scene, mat_id, dir_in, hit, u2, w, adjoint):
    frame, eta, roughness, ax, ay, g_dot_in = _setup(scene, mat_id, dir_in,
                                                     hit)
    reflected, refracted, F, tir = sample_glass(frame, dir_in, eta, ax, ay,
                                                u2)
    take_refl = w <= F
    return SampleRec(
        dir_out=torch.where(_c(take_refl), reflected, refracted),
        eta=torch.where(take_refl, 0.0, eta),
        roughness=roughness,
        valid=take_refl | ~tir)
