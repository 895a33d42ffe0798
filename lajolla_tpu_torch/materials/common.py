"""Shared BSDF helpers: frames, cosine hemisphere, microfacet math,
batched over lanes.

Port of lajolla_tpu/materials/common.py: the math of src/microfacet.h
and the anisotropic GGX helpers of the Disney BSDFs
(materials/disney_metal.inl:3-50).
"""

import torch

from lajolla_tpu_torch.core.math import make_frame, normalize, safe_sqrt, \
    to_world
from lajolla_tpu_torch.scene.soa import fetch_mat
from lajolla_tpu_torch.scene.texeval import eval_texture

PI = 3.141592653589793
TWO_PI = 6.283185307179586


def tex3(scene, mat_id, slot, hit):
    """Evaluate a spectrum parameter slot at the hits → (N, 3)."""
    return eval_texture(scene, fetch_mat(scene, mat_id).tex[:, slot], hit.uv,
                        hit.footprint)


def tex1(scene, mat_id, slot, hit):
    return tex3(scene, mat_id, slot, hit)[:, 0]


def sample_cos_hemisphere(u):
    """material.cpp:4-11; u (N, 2) → (N, 3)."""
    phi = TWO_PI * u[:, 0]
    tmp = torch.sqrt(torch.clamp(1.0 - u[:, 1], 0.0, 1.0))
    return torch.stack([torch.cos(phi) * tmp, torch.sin(phi) * tmp,
                        torch.sqrt(torch.clamp(u[:, 1], 0.0, 1.0))], -1)


def pow5(x):
    """x ** 5 as lajolla_tpu's `x ** 5` computes it: XLA's integer_pow
    multiplies by repeated squaring, x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


# --- Fresnel ---------------------------------------------------------------

def schlick_fresnel_scalar(f0, cos_theta):
    """microfacet.h:23-27; f0 (N,) or (N, 3) with cos_theta (N,) or
    (N, 1)."""
    c = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * pow5(c)


def fresnel_dielectric(n_dot_i, eta):
    """Exact dielectric Fresnel; the cosine of the incident angle may be
    negative (microfacet.h:42-56 takes |n_dot_i| into the rs/rp form).
    Relative IOR eta = n_t/n_i. Returns 1 on total internal reflection."""
    n_dot_t_sq = 1.0 - (1.0 - n_dot_i * n_dot_i) / (eta * eta)
    tir = n_dot_t_sq < 0.0
    n_dot_t = safe_sqrt(n_dot_t_sq)
    c = torch.abs(n_dot_i)
    rs = (c - eta * n_dot_t) / (c + eta * n_dot_t)
    rp = (eta * c - n_dot_t) / (eta * c + n_dot_t)
    F = (rs * rs + rp * rp) / 2.0
    return torch.where(tir, 1.0, F)


# --- Isotropic GGX (GTR2) ----------------------------------------------------

def ggx_d(n_dot_h, roughness):
    """GTR2 NDF (microfacet.h:58-67)."""
    alpha = roughness * roughness
    a2 = alpha * alpha
    t = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(PI * t * t, min=1e-20)


def smith_masking_gtr2(v_local, roughness):
    """Smith masking G1 (microfacet.h:75-81); v_local (N, 3) in the
    shading frame."""
    alpha = roughness * roughness
    a2 = alpha * alpha
    v2 = v_local * v_local
    lam = (-1.0 + torch.sqrt(1.0 + (v2[:, 0] * a2 + v2[:, 1] * a2) /
                             torch.clamp(v2[:, 2], min=1e-20))) / 2.0
    return 1.0 / (1.0 + lam)


def sample_visible_normals(local_dir_in, alpha, u):
    """Heitz 2018 VNDF sampling, isotropic (microfacet.h:85-114).
    local_dir_in (N, 3) in the shading frame, alpha (N,), u (N, 2).
    Returns the half-vector in the shading frame."""
    flip = (local_dir_in[:, 2] < 0)[:, None]
    d = torch.where(flip, -local_dir_in, local_dir_in)
    hemi_dir_in = normalize(
        torch.stack([alpha * d[:, 0], alpha * d[:, 1], d[:, 2]], -1))
    r = torch.sqrt(u[:, 0])
    phi = TWO_PI * u[:, 1]
    t1 = r * torch.cos(phi)
    t2 = r * torch.sin(phi)
    s = (1.0 + hemi_dir_in[:, 2]) / 2.0
    t2 = (1.0 - s) * safe_sqrt(1.0 - t1 * t1) + s * t2
    disk_n = torch.stack([t1, t2, safe_sqrt(1.0 - t1 * t1 - t2 * t2)], -1)
    hemi_n = to_world(make_frame(hemi_dir_in), disk_n)
    h = normalize(torch.stack([alpha * hemi_n[:, 0], alpha * hemi_n[:, 1],
                               torch.clamp(hemi_n[:, 2], min=0.0)], -1))
    return torch.where(flip, -h, h)


# --- Anisotropic GGX (disney_metal.inl:3-50) ---------------------------------

def smith_g_ggx_aniso(v_local, ax, ay):
    """Smith G1 of the anisotropic GGX; v_local (N, 3), ax, ay (N,)."""
    v2 = v_local * v_local
    lam = (-1.0 + torch.sqrt(1.0 + (v2[:, 0] * ax * ax + v2[:, 1] * ay * ay) /
                             torch.clamp(v2[:, 2], min=1e-20))) / 2.0
    return 1.0 / (1.0 + lam)


def gtr2_aniso(h_local, ax, ay):
    """Anisotropic GTR2 NDF; h_local (N, 3), ax, ay (N,)."""
    t = (h_local[:, 0] * h_local[:, 0] / (ax * ax) +
         h_local[:, 1] * h_local[:, 1] / (ay * ay) +
         h_local[:, 2] * h_local[:, 2])
    return 1.0 / torch.clamp(PI * ax * ay * t * t, min=1e-20)


def sample_visible_normals_aniso(local_dir_in, ax, ay, u):
    """Heitz VNDF, anisotropic (disney_metal.inl:21-50). local_dir_in
    (N, 3) in the shading frame, ax, ay (N,), u (N, 2). Returns the
    half-vector in the shading frame."""
    flip = (local_dir_in[:, 2] < 0)[:, None]
    d = torch.where(flip, -local_dir_in, local_dir_in)
    hemi_dir_in = normalize(
        torch.stack([ax * d[:, 0], ay * d[:, 1], d[:, 2]], -1))
    r = torch.sqrt(u[:, 0])
    phi = TWO_PI * u[:, 1]
    t1 = r * torch.cos(phi)
    t2 = r * torch.sin(phi)
    s = (1.0 + hemi_dir_in[:, 2]) / 2.0
    t2 = (1.0 - s) * safe_sqrt(1.0 - t1 * t1) + s * t2
    disk_n = torch.stack([t1, t2, safe_sqrt(1.0 - t1 * t1 - t2 * t2)], -1)
    hemi_n = to_world(make_frame(hemi_dir_in), disk_n)
    h = normalize(torch.stack([ax * hemi_n[:, 0], ay * hemi_n[:, 1],
                               torch.clamp(hemi_n[:, 2], min=0.0)], -1))
    return torch.where(flip, -h, h)
