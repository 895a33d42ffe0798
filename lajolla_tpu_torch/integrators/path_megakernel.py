"""The fused persistent-wavefront path tracer (kernel K1).

Port of lajolla_tpu/integrators/path_megakernel.py. One launch renders
nspp samples of every pixel: counter-hash uniforms, a camera ray with
filter importance sampling (camera.sample_primary_t), one advance per
path vertex (path_kernel), a film add that drops a whole sample if any
channel is non-finite, and regeneration from the next work item.
Lane == pixel, so work item i = pixel + k·n belongs to pixel i % n and
the film is a per-lane sum.

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

from lajolla_tpu_torch.core.random import M32
from lajolla_tpu_torch.integrators.path import (MAX_BOUNCES_CAP,
                                                _check_items,
                                                _render_block_kernel,
                                                _vertex_uniforms)
from lajolla_tpu_torch.integrators.path_kernel import (advance_plain_t,
                                                       statics)
from lajolla_tpu_torch.scene.camera import camera_record, sample_primary_t

# Films of more than one BLOCK of pixels take this kernel, whole blocks or
# not (path._render_block); the rest take the per-bounce driver.
BLOCK = 4096


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
    su = int(seed) & M32
    pixel = items % n
    orgT, dT = sample_primary_t(
        items, (pixel % w).float(), (pixel // w).float(), su,
        camera_record(scene), w=w, h=h, filter_type=options.filter_type,
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
    film = kernels.render_fused(
        scene, camera_record(scene), int(seed) & M32, s0, nspp, w=w, h=h,
        filter_type=options.filter_type, filter_param=options.filter_param,
        counters=counters, **statics(scene, options, MAX_BOUNCES_CAP))
    return film.T.reshape(h, w, 3)
