"""Unidirectional surface path tracer — the kernel-route drivers.

Port of the fused-kernel route of lajolla_tpu/integrators/path.py: NEE
with power-heuristic MIS against BSDF sampling, Russian roulette, filter
importance sampling, and a persistent wavefront: a pool of lanes works
through a queue of (pixel, sample) items, and a lane whose path ends
adds its radiance to the film and takes the next item at once.

Every uniform comes from the counter hash of (seed, work item, bounce,
dim), so the port draws lajolla_tpu's random numbers bit for bit and a
render can resume at any sample block.

Scenes outside path_kernel.supports need lajolla_tpu's general engine
(`_advance_lane`, `_render_block_sc`), which is not yet ported: they
raise NotImplementedError.
"""

import torch

from lajolla_tpu_torch.integrators import path_kernel

MAX_BOUNCES_CAP = 64  # absolute safety cap on path length (RR terminates
                      # far earlier; bias at this cap is ~0.75^59)
KERNEL_SPP_BLOCK = 256   # samples per pixel in one render_fused launch

# Counter-based hash RNG (Jarzynski & Olano, "Hash Functions for GPU
# Rendering"): every uniform is a pure function of (seed, work item,
# bounce, dim). Torch has no uint32 `+` or `>>` on CPU, so words are
# int64 tensors (or Python ints) holding values below 2^32, masked after
# every step that can carry.
_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9  # 2^32 / golden ratio: decorrelates dimension streams


def _pcg_hash(v):
    v = (v * 747796405 + 2891336453) & _M32
    w = (((v >> ((v >> 28) + 4)) ^ v) * 277803737) & _M32
    return (w >> 22) ^ w


def _hash_u01(x):
    """32-bit hash word -> U[0,1) float32 (top 24 bits)."""
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _vertex_uniforms(item, nv, su):
    """(8, N) uniforms for bounce nv of work items `item` ((N,) or
    (1, N) int64)."""
    kidx = (torch.arange(1, 9, device=item.device) * _GOLD) & _M32
    hb = _pcg_hash(item ^ _pcg_hash(nv ^ su)).reshape(1, -1)
    return _hash_u01(_pcg_hash((hb + kidx[:, None]) & _M32))


def _use_kernel(scene):
    return path_kernel.supports(scene.meta)


def _not_ported():
    return NotImplementedError(
        "general engine not yet ported (ROADMAP queue 1: general surface "
        "engine): this scene is outside path_kernel.supports")


def _render_block_kernel(scene, options, seed, s0, nspp,
                         advance=path_kernel.advance_kernel_t):
    """Per-bounce wavefront loop over the whole film, one lane per pixel:
    state in the transposed (3, N) layout, one `advance` call per path
    vertex. Returns the (h, w, 3) film sum of samples s0..s0+nspp.

    With advance=path_kernel.advance_plain_t this is also the plain form
    of kernel K1 (path_megakernel.render_fused): lane == pixel, the same
    work items, the same random numbers, the same whole-sample NaN/Inf
    exclusion."""
    from lajolla_tpu_torch.integrators.path_megakernel import _primary
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    end = (s0 + nspp) * n
    if end >= 1 << 31:
        # lajolla_tpu keys its work items in int32
        raise ValueError(f"(s0 + nspp) * n = {end} overflows int32 items")
    dev = scene.fp_tri.device
    su = int(seed) & _M32
    lane = torch.arange(n, device=dev)
    cam = torch.cat([scene.sample_to_cam.reshape(-1),
                     scene.cam_to_world.reshape(-1)])

    def camera(item):
        pixel = item % n
        return _primary(item, (pixel % w).float(), (pixel // w).float(),
                        su, cam, w=w, h=h, filter_type=options.filter_type,
                        filter_param=options.filter_param)

    item = lane + s0 * n
    orgT, dT = camera(item)
    nv = torch.full((n,), 2, dtype=torch.int64, device=dev)
    thrT = torch.ones((3, n), device=dev)
    radT = torch.zeros((3, n), device=dev)
    dir_pdf = torch.zeros(n, device=dev)
    prevT = orgT
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    film = torch.zeros((n, 3), device=dev)

    while not bool(done.all()):
        uT = _vertex_uniforms(item, nv, su)
        orgT, dT, thrT, radT2, dir_pdf, prevT, alive = advance(
            scene, options, orgT, dT, thrT, radT, nv, dir_pdf, prevT, uT,
            ~done, MAX_BOUNCES_CAP)
        died = ~done & ~alive
        nv = nv + 1

        # whole-sample NaN/Inf exclusion (render.cpp:140-143)
        fin = torch.isfinite(radT2).all(dim=0)
        film.index_add_(0, item % n,
                        torch.where((died & fin)[:, None], radT2.T, 0.0))

        next_item = item + n
        has_more = next_item < end
        regen = died & has_more
        done = done | (died & ~has_more)

        rorg, rd = camera(next_item)
        item = torch.where(regen, next_item, item)
        nv = torch.where(regen, 2, nv)
        orgT = torch.where(regen, rorg, orgT)
        dT = torch.where(regen, rd, dT)
        thrT = torch.where(regen, 1.0, thrT)
        radT = torch.where(regen, 0.0, radT2)
        dir_pdf = torch.where(regen, 0.0, dir_pdf)
        prevT = torch.where(regen, rorg, prevT)
    return film.reshape(h, w, 3)


def _render_block(scene, options, seed, s0, nspp):
    """Film sum (h, w, 3) of samples s0..s0+nspp. Films that fill more
    than one 4096-pixel block exactly take the fused kernel K1; the rest
    take the per-bounce driver with kernel K2 (lajolla_tpu's dispatch)."""
    from lajolla_tpu_torch.integrators import path_megakernel
    if not _use_kernel(scene):
        raise _not_ported()
    n = scene.meta.width * scene.meta.height
    if n % path_megakernel.BLOCK == 0 and n > path_megakernel.BLOCK:
        return path_megakernel.render_fused(scene, options, seed, s0, nspp)
    return _render_block_kernel(scene, options, seed, s0, nspp)


def render_path(scene, options, seed=0, checkpoint=None, progress=False):
    """Block-accumulating driver on the scene's device. `checkpoint`
    (optional path) persists (film sum, samples done, seed) after every
    block so an interrupted render resumes exactly — possible because
    the RNG is counter-based per (pixel, sample) work item."""
    from lajolla_tpu_torch.utils.checkpoint import load_film, save_film
    from lajolla_tpu_torch.utils.progress import ProgressReporter

    if not _use_kernel(scene):
        raise _not_ported()
    spp = options.samples_per_pixel
    h, w = scene.meta.height, scene.meta.width
    img, s0 = None, 0
    if checkpoint:
        img, s0 = load_film(checkpoint, seed, (h, w, 3))
    rep = ProgressReporter(spp, enabled=progress)
    rep.done = s0
    while s0 < spp:
        ns = min(KERNEL_SPP_BLOCK, spp - s0)
        block = _render_block(scene, options, seed, s0, ns).cpu().numpy()
        img = block if img is None else img + block
        s0 += ns
        rep.update(ns)
        if checkpoint:
            save_film(checkpoint, seed, img, s0)
    rep.finish()
    return img / spp
