"""The reference's radiance of any list of work items, and a film's pixels
from them.

A path's radiance depends on its work item alone (item = pixel + s * n),
so the reference traces a seeded sample of a frame's pixels at every one
of their samples, each item from its camera ray to its end in its own
lane, and sums each pixel's samples in sample order, dropping a sample
with any non-finite channel, as the program's film sum does.

`rounding`, where given, is applied to the tables once and to every float
of the path state after each step: the control (benchmark/check.py) passes
a round trip through bfloat16, the precision below the configuration's
float32.
"""

import torch

from benchmark.reference.constants import FILTER_BOX
from benchmark.reference.hashing import (_CAMERA_SALT, _GOLD, _M32,
                                         _hash_u01, _pcg_hash,
                                         surface_root, vertex_uniforms)
from benchmark.reference.path_vertex import _advance_core, _norm3

_TABLES = ('fp_tri', 'fp_woop', 'fp_woop_occ', 'fp_light', 'tri_stair_cdf',
           'cam')


def _same(x):
    return x


def primary(ref, item, px, py, su):
    """Camera rays (org, dir), each (3, N), of work items `item` of
    pixels (px, py): the box filter's jitter from the item's hash, the
    sample-to-camera and camera-to-world transforms."""
    if ref.filter_type != FILTER_BOX:
        raise ValueError("the reference's camera takes the box filter")
    cam, w, h = ref.cam, ref.width, ref.height
    hp = _pcg_hash(item ^ _pcg_hash(su ^ _CAMERA_SALT))
    u0 = _hash_u01(_pcg_hash((hp + _GOLD) & _M32))
    u1 = _hash_u01(_pcg_hash((hp + (2 * _GOLD & _M32)) & _M32))
    ox = (2.0 * u0 - 1.0) * (ref.filter_param / 2.0)
    oy = (2.0 * u1 - 1.0) * (ref.filter_param / 2.0)
    x = (px + 0.5 + ox) * (1.0 / w)
    y = (py + 0.5 + oy) * (1.0 / h)
    rx = cam[0] * x + cam[1] * y + cam[3]
    ry = cam[4] * x + cam[5] * y + cam[7]
    rz = cam[8] * x + cam[9] * y + cam[11]
    rw = cam[12] * x + cam[13] * y + cam[15]
    inv_w = 1.0 / rw
    cx, cy, cz = _norm3(rx * inv_w, ry * inv_w, rz * inv_w)
    dx = cam[16] * cx + cam[17] * cy + cam[18] * cz
    dy = cam[20] * cx + cam[21] * cy + cam[22] * cz
    dz = cam[24] * cx + cam[25] * cy + cam[26] * cz
    d = torch.stack(_norm3(dx, dy, dz))
    org = torch.stack([cam[19], cam[23], cam[27]])[:, None].repeat(
        1, d.shape[1])
    return org, d


def rounded(ref, rounding):
    """A copy of the reference scene with its float tables rounded."""
    out = type(ref)(**vars(ref))
    for name in _TABLES:
        if hasattr(ref, name):
            setattr(out, name, rounding(getattr(ref, name)))
    return out


def path_items(ref, seed, items, rounding=None, stats=None):
    """(N, 3) radiance of the surface estimator's work items `items`
    (item = pixel + s * n), non-finite values kept. `stats`, a dict, gets
    'vertices': the path vertices traced (one advance of one lane)."""
    rnd = rounding or _same
    w, h = ref.width, ref.height
    n = w * h
    dev = ref.fp_tri.device
    items = torch.as_tensor(items, dtype=torch.int64, device=dev)
    su = surface_root(seed)
    pixel = items % n
    orgT, dT = primary(ref, items, (pixel % w).float(), (pixel // w).float(),
                       su)
    orgT, dT = rnd(orgT), rnd(dT)
    m = items.shape[0]
    nv = torch.full((m,), 2, dtype=torch.int64, device=dev)
    thrT = torch.ones((3, m), device=dev)
    radT = torch.zeros((3, m), device=dev)
    dir_pdf = torch.zeros(m, device=dev)
    prevT = orgT
    done = torch.zeros(m, dtype=torch.bool, device=dev)
    out = torch.zeros((3, m), device=dev)
    vertices = 0
    while not bool(done.all()):
        vertices += int((~done).sum())
        uT = vertex_uniforms(items, nv, su)
        new = _advance_core(ref, orgT, dT, thrT, radT, nv.float()[None],
                            dir_pdf[None], prevT, uT, (~done)[None],
                            **ref.statics)
        org, d, thr, rad, dp, alive = (rnd(x) if x.is_floating_point()
                                       else x for x in new)
        # an inactive lane comes back as it went in, alive false
        act = ~done
        orgT = torch.where(act, org, orgT)
        dT = torch.where(act, d, dT)
        thrT = torch.where(act, thr, thrT)
        radT = torch.where(act, rad, radT)
        dir_pdf = torch.where(act, dp[0], dir_pdf)
        prevT = orgT
        alive = alive[0]
        died = act & ~alive
        out = torch.where(died[None], radT, out)
        done = done | died
        nv = nv + 1
    if stats is not None:
        stats['vertices'] = stats.get('vertices', 0) + vertices
    return out.T


def film_pixels(ref, seed, pixels, spp, chunk, rounding=None, stats=None):
    """(P, 3) sum over samples 0 .. spp of the given pixels (P,), in sample
    order, a sample with a non-finite channel dropped. Items go to the
    estimator `chunk` samples at a time."""
    n = ref.width * ref.height
    pixels = torch.as_tensor(pixels, dtype=torch.int64,
                             device=ref.fp_tri.device)
    acc = torch.zeros((pixels.shape[0], 3), device=pixels.device)
    for s0 in range(0, spp, chunk):
        s = torch.arange(s0, min(s0 + chunk, spp), device=pixels.device)
        items = (s[:, None] * n + pixels[None]).reshape(-1)
        L = path_items(ref, seed, items, rounding, stats).reshape(
            len(s), pixels.shape[0], 3)
        for k in range(len(s)):
            fin = torch.isfinite(L[k]).all(dim=1, keepdim=True)
            acc = acc + torch.where(fin, L[k], 0.0)
    return acc
