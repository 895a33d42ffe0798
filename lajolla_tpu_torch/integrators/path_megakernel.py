"""The fused persistent-wavefront path tracer (kernel K1).

Port of lajolla_tpu/integrators/path_megakernel.py. One launch renders
nspp samples of every pixel: counter-hash uniforms, a camera ray with
filter importance sampling (`_primary`), one advance per path vertex
(path_kernel), a film add that drops a whole sample if any channel is
non-finite, and regeneration from the next work item. Lane == pixel, so
work item i = pixel + k·n belongs to pixel i % n and the film is a
per-lane sum.

`render_fused` is the wrapper: CUDA tensors launch the CUDA kernel
(csrc/path_kernels.cu `render_fused_kernel`), CPU tensors run the plain
form `render_fused_plain`, which is the per-bounce driver of path.py
with the plain advance — the same items, random numbers and sums. The
CUDA kernel runs the items in persistent warps, in no fixed lane, and
writes each item's radiance to a buffer that film_sum_kernel sums per
pixel in sample order; `path_items_plain` traces any list of items, the
property that design rests on (tests/test_torch_path_item_order.py).
"""

import torch

from lajolla_tpu_torch.integrators.path import (_GOLD, _M32,
                                                MAX_BOUNCES_CAP,
                                                _check_items, _hash_u01,
                                                _pcg_hash,
                                                _render_block_kernel,
                                                _vertex_uniforms)
from lajolla_tpu_torch.integrators.path_kernel import (_norm3,
                                                       advance_plain_t,
                                                       statics)
from lajolla_tpu_torch.scene.types import (FILTER_BOX, FILTER_GAUSSIAN,
                                           FILTER_TENT)

# Films of more than one BLOCK of pixels take this kernel, whole blocks or
# not (path._render_block); the rest take the per-bounce driver.
BLOCK = 4096
TWO_PI = 6.283185307179586


def _primary(item, px, py, su, cam, *, w, h, filter_type, filter_param):
    """Camera ray for work items `item` (int64) of pixels (px, py).
    Mirrors lajolla_tpu path_megakernel._primary (src/camera.cpp:23-47).
    cam: (32,) [sample_to_cam flat 16, cam_to_world flat 16]. Returns
    (org, dir), each (3, N)."""
    hp = _pcg_hash(item ^ _pcg_hash(su ^ 0xCAFEF00D))
    u0 = _hash_u01(_pcg_hash((hp + _GOLD) & _M32))
    u1 = _hash_u01(_pcg_hash((hp + (2 * _GOLD & _M32)) & _M32))
    if filter_type == FILTER_BOX:
        ox = (2.0 * u0 - 1.0) * (filter_param / 2.0)
        oy = (2.0 * u1 - 1.0) * (filter_param / 2.0)
    elif filter_type == FILTER_TENT:
        fh = filter_param / 2.0

        def warp(r):
            return torch.where(
                r < 0.5, fh * (torch.sqrt(2.0 * r) - 1.0),
                fh * (1.0 - torch.sqrt(torch.clamp(1.0 - 2.0 * (r - 0.5),
                                                   min=0.0))))
        ox, oy = warp(u0), warp(u1)
    elif filter_type == FILTER_GAUSSIAN:
        r = filter_param * torch.sqrt(
            -2.0 * torch.log(torch.clamp(u0, min=1e-8)))
        ox = r * torch.cos(TWO_PI * u1)
        oy = r * torch.sin(TWO_PI * u1)
    else:
        raise ValueError(f"unknown filter type {filter_type}")
    x = (px + 0.5 + ox) * (1.0 / w)
    y = (py + 0.5 + oy) * (1.0 / h)
    # pt = sample_to_cam @ [x, y, 0, 1] with homogeneous divide
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


def render_fused_plain(scene, options, seed, s0, nspp):
    """The plain form of kernel K1, on any device: (h, w, 3) film sum of
    samples s0..s0+nspp."""
    return _render_block_kernel(scene, options, seed, s0, nspp,
                                advance=advance_plain_t)


def path_items_plain(scene, options, seed, items):
    """The radiance (N, 3) of K1's work items `items` (N,) (item = pixel +
    k*n), each traced from its camera ray to its end in its own lane,
    non-finite values kept. Any order, any subset: a path's radiance
    depends on its item alone."""
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    dev = scene.fp_tri.device
    items = torch.as_tensor(items, dtype=torch.int64, device=dev)
    if items.numel():
        _check_items(int(items.max()) + 1)
    su = int(seed) & _M32
    pixel = items % n
    cam = torch.cat([scene.sample_to_cam.reshape(-1),
                     scene.cam_to_world.reshape(-1)])
    orgT, dT = _primary(items, (pixel % w).float(), (pixel // w).float(), su,
                        cam, w=w, h=h, filter_type=options.filter_type,
                        filter_param=options.filter_param)
    m = items.shape[0]
    nv = torch.full((m,), 2, dtype=torch.int64, device=dev)
    thrT = torch.ones((3, m), device=dev)
    radT = torch.zeros((3, m), device=dev)
    dir_pdf = torch.zeros(m, device=dev)
    prevT = orgT
    done = torch.zeros(m, dtype=torch.bool, device=dev)
    out = torch.zeros((3, m), device=dev)
    while not bool(done.all()):
        uT = _vertex_uniforms(items, nv, su)
        orgT, dT, thrT, radT, dir_pdf, prevT, alive = advance_plain_t(
            scene, options, orgT, dT, thrT, radT, nv, dir_pdf, prevT, uT,
            ~done, MAX_BOUNCES_CAP)
        died = ~done & ~alive
        out = torch.where(died[None], radT, out)
        done = done | died
        nv = nv + 1
    return out.T


def render_fused(scene, options, seed, s0, nspp, counters=None):
    """Render nspp samples/pixel (sample indices s0..s0+nspp) of the full
    film in one kernel launch. Returns the (h, w, 3) film sum. CPU scenes
    run the plain form; CUDA scenes launch the CUDA kernel, and anything
    else raises. `counters`, a dict, receives the kernel's SIMT counters
    (kernels.PATH_COUNTERS); the plain form has none."""
    if scene.fp_tri.device.type == 'cpu':
        if counters is not None:
            raise ValueError("SIMT counters come from the CUDA kernel")
        return render_fused_plain(scene, options, seed, s0, nspp)
    from lajolla_tpu_torch import kernels
    w, h = scene.meta.width, scene.meta.height
    cam = torch.cat([scene.sample_to_cam.reshape(-1),
                     scene.cam_to_world.reshape(-1)])
    film = kernels.render_fused(
        scene, cam, int(seed) & _M32, s0, nspp, w=w, h=h,
        filter_type=options.filter_type, filter_param=options.filter_param,
        counters=counters, **statics(scene, options, MAX_BOUNCES_CAP))
    return film.T.reshape(h, w, 3)
