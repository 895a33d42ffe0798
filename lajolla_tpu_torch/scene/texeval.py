"""Device-side texture evaluation (constant / image-mipmap / checkerboard),
batched over lanes.

Port of lajolla_tpu/scene/texeval.py: eval(texture, uv, footprint, pool)
(src/texture.h:108-154) and the mipmap lookups (src/mipmap.h:52-88).
Image lookups are trilinear: two bilinear taps on adjacent mip levels,
each tap one row gather into the quad-packed texdata array
(scene/texture.py). lajolla_tpu picks a level's column of the mip row by
a one-hot sum; here it is an index gather of the same value.
"""

import torch

from lajolla_tpu_torch.scene.soa import fetch_tex
from lajolla_tpu_torch.scene.types import TEX_CHECKERBOARD, TEX_IMAGE


def _mip_row(scene, img_id):
    """(N, 25) mip-metadata rows [off x8 | w x8 | h x8 | nlev]."""
    return scene.mip_tab[torch.clamp(img_id, min=0).long()]


def _lvl(row, base, level):
    """row[:, base + level] per lane."""
    return row.gather(1, (base + level).long()[:, None])[:, 0]


def _bilinear(scene, mrow, level, u, v):
    off = _lvl(mrow, 0, level).to(torch.int32)
    w = _lvl(mrow, 8, level).to(torch.int32)
    h = _lvl(mrow, 16, level).to(torch.int32)
    x = u * w - 0.5
    y = v * h - 0.5
    xf = torch.floor(x).to(torch.int32)
    yf = torch.floor(y).to(torch.int32)
    uo = (x - xf)[:, None]
    vo = (y - yf)[:, None]
    x0 = torch.remainder(xf, w)
    y0 = torch.remainder(yf, h)
    c = scene.texdata[(off + y0 * w + x0).long()]      # quad-packed (N, 12)
    t00, t10, t01, t11 = c[:, 0:3], c[:, 3:6], c[:, 6:9], c[:, 9:12]
    return (t00 * (1 - uo) * (1 - vo) + t01 * (1 - uo) * vo +
            t10 * uo * (1 - vo) + t11 * uo * vo)


def lookup_trilinear(scene, img_id, u, v, level, mrow=None):
    """Trilinear mipmap lookup with fractional level (mipmap.h:76-88).
    img_id, u, v, level: (N,). Returns (N, 3)."""
    mrow = _mip_row(scene, img_id) if mrow is None else mrow
    nlev = mrow[:, 24].to(torch.int32)
    level = torch.clamp(level, min=0.0)
    level = torch.minimum(level, (nlev - 1).to(torch.float32))
    # a NaN level (a lane whose lookup direction is NaN; its value is
    # discarded) reads level 0, and t keeps the result NaN, as
    # lajolla_tpu's all-zero one-hot row does
    fl = torch.floor(torch.nan_to_num(level, nan=0.0)).to(torch.int32)
    cl = torch.minimum(fl + 1, nlev - 1)
    t = (level - fl)[:, None]
    lo = _bilinear(scene, mrow, fl, u, v)
    hi = _bilinear(scene, mrow, cl, u, v)
    return lo * (1 - t) + hi * t


def image_mip_level(scene, img_id, uvscale, footprint, mrow=None):
    """log2 footprint → fractional mip level (texture.h:127-134).
    uvscale: (N, 2) or (2,)."""
    mrow = _mip_row(scene, img_id) if mrow is None else mrow
    scaled = (torch.maximum(mrow[:, 8], mrow[:, 16]) *
              torch.maximum(uvscale[..., 0], uvscale[..., 1]) * footprint)
    return torch.log2(torch.clamp(scaled, min=1e-8))


def eval_texture(scene, tex_id, uv, footprint):
    """Evaluate texture descriptors tex_id (N,) at uv (N, 2) → (N, 3) RGB.
    Scalar params read channel 0. footprint (N,) ≈ du/dx for mip
    selection."""
    tex = fetch_tex(scene, tex_id)
    kind = tex.kind[:, None]
    out = tex.const
    local_uv = torch.remainder(uv * tex.uvscale + tex.uvoffset, 1.0)

    if TEX_CHECKERBOARD in scene.meta.texture_types_present:
        xi = 2 * torch.remainder((local_uv[:, 0] * 2).to(torch.int32), 2) - 1
        yi = 2 * torch.remainder((local_uv[:, 1] * 2).to(torch.int32), 2) - 1
        checker = torch.where((xi * yi == 1)[:, None], tex.const, tex.color1)
        out = torch.where(kind == TEX_CHECKERBOARD, checker, out)

    if scene.meta.has_image_textures:
        img_id = tex.image_id
        mrow = _mip_row(scene, img_id)
        level = image_mip_level(scene, img_id, tex.uvscale, footprint,
                                mrow=mrow)
        img_val = lookup_trilinear(scene, img_id, local_uv[:, 0],
                                   local_uv[:, 1], level, mrow=mrow)
        out = torch.where(kind == TEX_IMAGE, img_val, out)

    return out


def eval_texture_scalar(scene, tex_id, uv, footprint):
    return eval_texture(scene, tex_id, uv, footprint)[:, 0]
