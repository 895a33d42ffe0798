"""Material (BSDF) dispatch, batched over lanes.

Port of lajolla_tpu/materials/__init__.py. The reference's `Material`
variant with std::visit (material.h:102-110, material.cpp:90-123) becomes
integer tags + a static switch over ONLY the material types present in
the scene. lajolla_tpu's `lax.switch` under `vmap` evaluates every
present branch on every lane and selects; here each present type is
evaluated on all lanes and `torch.where` selects it on the lanes of that
type, so no value of another type's branch reaches a lane (a NaN there is
never multiplied in).

API (lanes on the leading axis; hit is a scene.geometry.Hit):
    eval_bsdf(scene, mat_id, dir_in, dir_out, hit)   -> f (N, 3) [BSDF x cos]
    pdf_bsdf(scene, mat_id, dir_in, dir_out, hit)    -> (N,)
    sample_bsdf(scene, mat_id, dir_in, hit, u2, w)   -> SampleRec
All take `adjoint` (TransportDirection, material.h:114-117) as a static
Python bool — radiance transport by default.

All nine material types are ported: Lambertian, RoughPlastic,
RoughDielectric and the six Disney BSDFs.
"""

from typing import NamedTuple

import torch

from lajolla_tpu_torch.core.math import dot
from lajolla_tpu_torch.scene import types as T


class SampleRec(NamedTuple):
    dir_out: torch.Tensor   # (N, 3)
    eta: torch.Tensor       # (N,) 0 = reflection, else relative IOR
    roughness: torch.Tensor  # (N,)
    valid: torch.Tensor     # (N,) bool


def flip_frame_if_needed(frame, dir_in):
    """Flip the shading frame when inconsistent with dir_in (the
    black-fringe guard used by every BSDF, e.g. lambertian.inl:10-13)."""
    flip = dot(frame[:, 2], dir_in) < 0
    return torch.where(flip[:, None, None], -frame, frame)


# The BSDF modules import SampleRec and flip_frame_if_needed from here.
from lajolla_tpu_torch.materials import (  # noqa: E402
    disney_bsdf, disney_clearcoat, disney_diffuse, disney_glass,
    disney_metal, disney_sheen, lambertian, roughdielectric, roughplastic)

_PORTED = {T.MAT_LAMBERTIAN: lambertian,
           T.MAT_ROUGH_PLASTIC: roughplastic,
           T.MAT_ROUGH_DIELECTRIC: roughdielectric,
           T.MAT_DISNEY_DIFFUSE: disney_diffuse,
           T.MAT_DISNEY_METAL: disney_metal,
           T.MAT_DISNEY_GLASS: disney_glass,
           T.MAT_DISNEY_CLEARCOAT: disney_clearcoat,
           T.MAT_DISNEY_SHEEN: disney_sheen,
           T.MAT_DISNEY_BSDF: disney_bsdf}


def _select(mask, a, b):
    """torch.where over a result of any of the three methods."""
    if isinstance(a, SampleRec):
        return SampleRec(*(_select(mask, x, y) for x, y in zip(a, b)))
    m = mask if a.dim() == 1 else mask[:, None]
    return torch.where(m, a, b)


def _dispatch(scene, mat_id, method, args, adjoint):
    present = scene.meta.mat_types_present or (T.MAT_LAMBERTIAN,)
    mat_id_c = torch.clamp(mat_id, min=0)
    results = [getattr(_PORTED[t], method)(scene, mat_id_c, *args, adjoint)
               for t in present]
    if len(present) == 1:
        return results[0]
    mat_type = scene.mat_tab[mat_id_c.long(), 0].to(torch.int32)
    out = results[0]
    for t, res in zip(present[1:], results[1:]):
        out = _select(mat_type == t, res, out)
    return out


def eval_bsdf(scene, mat_id, dir_in, dir_out, hit, adjoint=False):
    """BSDF x |cos| (material.h:126-131). Returns (N, 3)."""
    return _dispatch(scene, mat_id, 'eval', (dir_in, dir_out, hit), adjoint)


def pdf_bsdf(scene, mat_id, dir_in, dir_out, hit, adjoint=False):
    """Solid-angle pdf of sample_bsdf (material.h:161-166)."""
    return _dispatch(scene, mat_id, 'pdf', (dir_in, dir_out, hit), adjoint)


def sample_bsdf(scene, mat_id, dir_in, hit, u2, w, adjoint=False):
    """Importance sample dir_out (material.h:133-154)."""
    return _dispatch(scene, mat_id, 'sample', (dir_in, hit, u2, w), adjoint)
