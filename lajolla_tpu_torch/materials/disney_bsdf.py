"""Full DisneyBSDF: 5-lobe combination (diffuse+subsurface, metal with
achromatic-specular C0, anisotropic glass, clearcoat, sheen) with
normalized lobe-weight sampling (reference: materials/disney_bsdf.inl;
lobe weights :211-215, sampling :403-431, inside-surface glass-only
:408-422, mixed pdf :382-386), batched over lanes. Port of
lajolla_tpu/materials/disney_bsdf.py, in its order of operations and
with all of its gates: `outside` zeroes the reflective lobes' values,
`inside` zeroes every lobe weight except glass, `ok` zeroes the pdf and
invalidates the sample of a lane with no lobe, and from inside only the
glass lobe is sampled."""

import torch

from lajolla_tpu_torch.core.math import dot, normalize, to_local, to_world
from lajolla_tpu_torch.materials import SampleRec
from lajolla_tpu_torch.materials.common import (PI, fresnel_dielectric,
                                                gtr2_aniso, pow5,
                                                sample_cos_hemisphere,
                                                sample_visible_normals_aniso,
                                                smith_g_ggx_aniso, tex1, tex3)
from lajolla_tpu_torch.materials.disney_clearcoat import (_dc_ref,
                                                          _schlick_f,
                                                          masking,
                                                          sample_half)
from lajolla_tpu_torch.materials.disney_diffuse import burley
from lajolla_tpu_torch.materials.disney_glass import (glass_eval, glass_pdf,
                                                      sample_glass)
from lajolla_tpu_torch.materials.disney_metal import aniso_alphas
from lajolla_tpu_torch.materials.disney_sheen import sheen_color, tint
from lajolla_tpu_torch.scene import types as T
from lajolla_tpu_torch.scene.soa import fetch_mat


def _c(x):
    return x[:, None]


def _params(scene, mat_id, hit):
    p = {}
    p['base_color'] = tex3(scene, mat_id, T.P_BASE_COLOR, hit)
    for name, slot in [('spec_trans', T.P_SPEC_TRANS),
                       ('metallic', T.P_METALLIC),
                       ('subsurface', T.P_SUBSURFACE),
                       ('specular', T.P_SPECULAR),
                       ('roughness', T.P_ROUGHNESS),
                       ('specular_tint', T.P_SPECULAR_TINT),
                       ('anisotropic', T.P_ANISOTROPIC),
                       ('sheen', T.P_SHEEN),
                       ('sheen_tint', T.P_SHEEN_TINT),
                       ('clearcoat', T.P_CLEARCOAT),
                       ('clearcoat_gloss', T.P_CLEARCOAT_GLOSS)]:
        p[name] = tex1(scene, mat_id, slot, hit)
    p['eta0'] = fetch_mat(scene, mat_id).eta
    return p


def _frames(hit, dir_in):
    g_dot_in = dot(hit.geometry_normal, dir_in)
    fr = hit.frame
    n_dot_in = dot(fr[:, 2], dir_in)
    # reflective lobes
    frame_r = torch.where((n_dot_in < 0)[:, None, None], -fr, fr)
    # glass
    frame_g = torch.where((n_dot_in * g_dot_in < 0)[:, None, None], -fr, fr)
    return frame_r, frame_g, g_dot_in


def _lobe_weights(p, g_dot_in):
    dw = (1.0 - p['metallic']) * (1.0 - p['spec_trans'])
    mw = 1.0 - p['spec_trans'] * (1.0 - p['metallic'])
    gw = (1.0 - p['metallic']) * p['spec_trans']
    cw = 0.25 * p['clearcoat']
    inside = g_dot_in < 0
    dw = torch.where(inside, 0.0, dw)
    mw = torch.where(inside, 0.0, mw)
    cw = torch.where(inside, 0.0, cw)
    gw = torch.where(inside, torch.where(gw > 0, 1.0, 0.0), gw)
    total = dw + mw + gw + cw
    ok = total > 0
    tot = torch.clamp(total, min=1e-20)
    return dw / tot, mw / tot, gw / tot, cw / tot, ok


def _glass_terms(p, frame_g, dir_in, dir_out, g_dot_in, g_dot_out):
    eta = torch.where(g_dot_in > 0, p['eta0'], 1.0 / p['eta0'])
    reflect = g_dot_in * g_dot_out > 0
    rough = torch.clamp(p['roughness'], 0.01, 1.0)
    ax, ay = aniso_alphas(rough, p['anisotropic'])
    h = torch.where(_c(reflect), normalize(dir_in + dir_out),
                    normalize(dir_in + dir_out * _c(eta)))
    h = torch.where(_c(dot(h, frame_g[:, 2]) < 0), -h, h)
    h_dot_in = dot(h, dir_in)
    F = fresnel_dielectric(h_dot_in, eta)
    D = gtr2_aniso(to_local(frame_g, h), ax, ay)
    G_in = smith_g_ggx_aniso(to_local(frame_g, dir_in), ax, ay)
    return eta, reflect, h, h_dot_in, F, D, G_in


def eval(scene, mat_id, dir_in, dir_out, hit, adjoint):
    p = _params(scene, mat_id, hit)
    frame_r, frame_g, g_dot_in = _frames(hit, dir_in)
    g_dot_out = dot(hit.geometry_normal, dir_out)
    outside = (g_dot_in >= 0) & (g_dot_out >= 0)

    base_color = p['base_color']
    rough = torch.clamp(p['roughness'], 0.01, 1.0)

    h_r = normalize(dir_in + dir_out)
    h_dot_out = dot(h_r, dir_out)
    n_dot_in = dot(frame_r[:, 2], dir_in)
    n_dot_out = dot(frame_r[:, 2], dir_out)

    # ---- diffuse (unclamped roughness, like the reference) ---------------
    f_diffuse = burley(base_color, p['roughness'], p['subsurface'],
                       h_dot_out, n_dot_in, n_dot_out)

    # ---- metal with achromatic specular C0 (disney_bsdf.inl:83-91) -------
    r0 = (1.5 - 1.0) ** 2 / (1.5 + 1.0) ** 2
    st = _c(p['specular_tint'])
    ks = (1.0 - st) + st * tint(base_color)
    c0 = (_c(p['specular']) * r0 * _c(1.0 - p['metallic']) * ks +
          _c(p['metallic']) * base_color)
    Fm = c0 + (1.0 - c0) * _c(pow5(1.0 - h_dot_out))
    ax, ay = aniso_alphas(rough, p['anisotropic'])
    Dm = gtr2_aniso(to_local(frame_r, h_r), ax, ay)
    Gin = smith_g_ggx_aniso(to_local(frame_r, dir_in), ax, ay)
    Gout = smith_g_ggx_aniso(to_local(frame_r, dir_out), ax, ay)
    f_metal = Fm * _c(Dm) * _c(Gin) * _c(Gout) / _c(torch.clamp(
        4.0 * torch.abs(n_dot_in), min=1e-20))

    # ---- clearcoat ---------------------------------------------------------
    n_dot_h = dot(frame_r[:, 2], h_r)
    Fc = _schlick_f(h_r, dir_out)
    Dc = _dc_ref(p['clearcoat_gloss'], n_dot_h * n_dot_h)
    Gc = masking(frame_r, dir_in, dir_out)
    f_clearcoat = torch.where(n_dot_h > 0, Fc * Dc * Gc / torch.clamp(
        4.0 * torch.abs(n_dot_in), min=1e-20), 0.0)
    f_clearcoat = torch.ones_like(base_color) * _c(f_clearcoat)

    # ---- sheen -------------------------------------------------------------
    c_sheen = sheen_color(base_color, p['sheen_tint'])
    f_sheen = (c_sheen * _c(pow5(1.0 - torch.abs(h_dot_out))) *
               _c(torch.abs(n_dot_out)))

    # ---- glass (always active, incl. inside) -------------------------------
    eta, reflect, h, h_dot_in, F, D, G_in = _glass_terms(
        p, frame_g, dir_in, dir_out, g_dot_in, g_dot_out)
    # the reference uses only G_in for the glass G (disney lobe)
    f_glass = glass_eval(base_color, F, D, G_in, h_dot_in, dot(h, dir_out),
                         eta, torch.abs(dot(frame_g[:, 2], dir_in)), reflect)

    gate = _c(outside)
    f_diffuse = torch.where(gate & _c(g_dot_in >= 0), f_diffuse, 0.0)
    f_metal = torch.where(gate, f_metal, 0.0)
    f_clearcoat = torch.where(gate, f_clearcoat, 0.0)
    f_sheen = torch.where(gate, f_sheen, 0.0)

    sT, m = _c(p['spec_trans']), _c(p['metallic'])
    return ((1.0 - sT) * (1.0 - m) * f_diffuse
            + (1.0 - m) * _c(p['sheen']) * f_sheen
            + (1.0 - sT * (1.0 - m)) * f_metal
            + 0.25 * _c(p['clearcoat']) * f_clearcoat
            + (1.0 - m) * sT * f_glass)


def pdf(scene, mat_id, dir_in, dir_out, hit, adjoint):
    p = _params(scene, mat_id, hit)
    frame_r, frame_g, g_dot_in = _frames(hit, dir_in)
    g_dot_out = dot(hit.geometry_normal, dir_out)
    reflect = g_dot_in * g_dot_out > 0
    dw, mw, gw, cw, ok = _lobe_weights(p, g_dot_in)

    diffuse_pdf = torch.clamp(dot(frame_r[:, 2], dir_out), min=0.0) / PI

    rough = torch.clamp(p['roughness'], 0.01, 1.0)
    ax, ay = aniso_alphas(rough, p['anisotropic'])
    h_r = normalize(dir_in + dir_out)
    Dm = gtr2_aniso(to_local(frame_r, h_r), ax, ay)
    Gin = smith_g_ggx_aniso(to_local(frame_r, dir_in), ax, ay)
    metal_pdf = Dm * Gin / torch.clamp(
        4.0 * torch.abs(dot(dir_in, frame_r[:, 2])), min=1e-20)

    n_dot_h = dot(frame_r[:, 2], h_r)
    Dc = _dc_ref(p['clearcoat_gloss'], n_dot_h * n_dot_h)
    clearcoat_pdf = Dc * torch.abs(n_dot_h) / torch.clamp(
        4.0 * torch.abs(dot(h_r, dir_out)), min=1e-20)

    eta, _, h, h_dot_in, F, D, G_in = _glass_terms(
        p, frame_g, dir_in, dir_out, g_dot_in, g_dot_out)
    glass = glass_pdf(F, D, G_in, h_dot_in, dot(h, dir_out), eta,
                      dot(frame_g[:, 2], dir_in), reflect)

    total = torch.where(reflect,
                        dw * diffuse_pdf + mw * metal_pdf +
                        cw * clearcoat_pdf + gw * glass,
                        gw * glass)
    return torch.where(ok, total, 0.0)


def sample(scene, mat_id, dir_in, hit, u2, w, adjoint):
    p = _params(scene, mat_id, hit)
    frame_r, frame_g, g_dot_in = _frames(hit, dir_in)
    dw, mw, gw, cw, ok = _lobe_weights(p, g_dot_in)
    rough = torch.clamp(p['roughness'], 0.01, 1.0)
    ax, ay = aniso_alphas(rough, p['anisotropic'])
    eta = torch.where(g_dot_in > 0, p['eta0'], 1.0 / p['eta0'])

    # diffuse
    d_diff = to_world(frame_r, sample_cos_hemisphere(u2))

    # metal
    h_m = to_world(frame_r, sample_visible_normals_aniso(
        to_local(frame_r, dir_in), ax, ay, u2))
    d_metal = normalize(-dir_in + _c(2.0 * dot(dir_in, h_m)) * h_m)

    # glass: w rescaled to the glass lobe's share chooses its branch
    d_glass_r, d_glass_t, F, tir = sample_glass(frame_g, dir_in, eta, ax,
                                                ay, u2)
    rand_new = (w - (dw + mw)) / torch.clamp(gw, min=1e-20)
    glass_refl = rand_new <= F
    d_glass = torch.where(_c(glass_refl), d_glass_r, d_glass_t)

    # clearcoat
    h_c = to_world(frame_r, sample_half(p['clearcoat_gloss'], u2,
                                        clamp_denominator=True))
    d_cc = normalize(-dir_in + _c(2.0 * dot(dir_in, h_c)) * h_c)

    take_diff = w < dw
    take_metal = (~take_diff) & (w < dw + mw)
    take_glass = (~take_diff) & (~take_metal) & (w < dw + mw + gw)
    take_cc = ~(take_diff | take_metal | take_glass)

    dir_out = torch.where(_c(take_diff), d_diff,
                          torch.where(_c(take_metal), d_metal,
                                      torch.where(_c(take_glass), d_glass,
                                                  d_cc)))
    out_eta = torch.where(take_glass & ~glass_refl, eta, 0.0)
    out_rough = torch.where(take_diff | take_cc, 1.0, rough)
    valid = ok & ~(take_glass & ~glass_refl & tir)
    return SampleRec(dir_out=dir_out, eta=out_eta, roughness=out_rough,
                     valid=valid)
