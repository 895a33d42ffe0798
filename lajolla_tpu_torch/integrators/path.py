"""Unidirectional surface path tracer: the kernel-route drivers and the
general engine.

Port of lajolla_tpu/integrators/path.py: NEE with power-heuristic MIS
against BSDF sampling, Russian roulette with eta_scale tracking, filter
importance sampling, and a persistent wavefront: a pool of lanes works
through a queue of (pixel, sample) items, and a lane whose path ends
adds its radiance to the film and takes the next item at once.

Two engines, dispatched as lajolla_tpu's `_render_block` does, but for
one difference:
- scenes inside path_kernel.supports take the fused kernels: K1
  (path_megakernel.render_fused) for films of more than one 4096-pixel
  block, whole blocks or not, otherwise the per-bounce driver
  `_render_block_kernel` with K2. lajolla_tpu's Pallas kernel tiles its
  lanes in (row, 4096) blocks and so takes whole blocks only; K1 takes
  work item pixel + k·n for any n, so a ragged film renders the same
  items, random numbers and sample-ordered sums in one launch;
- every other scene takes the general engine: `_advance_lane` (one path
  vertex for a batch of lanes: hit records, textures, any ported BSDF,
  area and environment lights, ray differentials) inside the queue
  `_render_block_sc`. Its casts are kernel K3 or, for a scene with a
  BVH (192 triangles or more), the cluster sweeps K4-K7
  (scene/geometry.py). Such a scene renders one sample per block with a
  pool of SWEEP_LANES or SWEEP_LANES_BIG lanes (`_schedule`), as in
  lajolla_tpu. lajolla_tpu then stops the queue early, compacts the
  survivors on the host and drains them in smaller pools; the estimator
  does not depend on that (every random number is keyed on the work item
  and the bounce), so here the queue runs to its end on the device.

Every uniform comes from the counter hash (core/random.py) of (seed,
work item, bounce, dim), so the port draws lajolla_tpu's random numbers
bit for bit and a render can resume at any sample block.
"""

import torch

from lajolla_tpu_torch.core.math import distance_squared, dot, normalize
from lajolla_tpu_torch.core.random import GOLD, M32, hash_u01, pcg_hash
from lajolla_tpu_torch.dtypes import intersection_eps, shadow_eps
from lajolla_tpu_torch.integrators import path_kernel
from lajolla_tpu_torch.integrators.lights import (LightPoint, emission_area,
                                                  emission_envmap, light_pmf,
                                                  pdf_point_on_light,
                                                  sample_light,
                                                  sample_point_on_light)
from lajolla_tpu_torch.materials import eval_bsdf, pdf_bsdf, sample_bsdf
from lajolla_tpu_torch.scene.camera import (camera_record, sample_primary,
                                            sample_primary_t)
from lajolla_tpu_torch.scene.geometry import intersect_scene, occluded
from lajolla_tpu_torch.scene.types import LIGHT_ENVMAP
from lajolla_tpu_torch.utils import profiling
from lajolla_tpu_torch.utils.film_return import return_film

INF = float('inf')
MAX_BOUNCES_CAP = 64  # absolute safety cap on path length (RR terminates
                      # far earlier; bias at this cap is ~0.75^59)
KERNEL_SPP_BLOCK = 256   # samples per pixel in one render_fused launch
SPP_BLOCK = 16           # samples per pixel in one general-engine block
# Lane pools of a scene whose casts are the cluster sweeps (one sample per
# block): below 2^17 triangles and from there on (lajolla_tpu's values).
SWEEP_LANES = 8192
SWEEP_LANES_BIG = 16384

def _vertex_uniforms(item, nv, su):
    """(8, N) uniforms for bounce nv of work items `item` ((N,) or
    (1, N) int64)."""
    kidx = (torch.arange(1, 9, device=item.device) * GOLD) & M32
    hb = pcg_hash(item ^ pcg_hash(nv ^ su)).reshape(1, -1)
    return hash_u01(pcg_hash((hb + kidx[:, None]) & M32))


def _use_kernel(scene):
    return path_kernel.supports(scene.meta)


def _check_items(end):
    if end >= 1 << 31:
        # lajolla_tpu keys its work items in int32
        raise ValueError(f"{end} work items overflow int32 items")


def _all_done(done):
    """bool(done.all()): the reduction is issued first, and the readback
    that waits for the device is the span `path.bounce_wait`."""
    pending = done.all()
    with profiling.span('path.bounce_wait'):
        return bool(pending)


def _render_block_kernel(scene, options, seed, s0, nspp,
                         advance=path_kernel.advance_kernel_t):
    """Per-bounce wavefront loop over the whole film, one lane per pixel:
    state in the transposed (3, N) layout, one `advance` call per path
    vertex. Returns the (h, w, 3) film sum of samples s0..s0+nspp.

    With advance=path_kernel.advance_plain_t this is also the plain form
    of kernel K1 (path_megakernel.render_fused): lane == pixel, the same
    work items, the same random numbers, the same whole-sample NaN/Inf
    exclusion. Each iteration of the loop is the span `path.bounce`."""
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    end = (s0 + nspp) * n
    _check_items(end)
    dev = scene.fp_tri.device
    su = int(seed) & M32
    lane = torch.arange(n, device=dev)
    cam = camera_record(scene)

    def camera(item):
        pixel = item % n
        return sample_primary_t(
            item, (pixel % w).float(), (pixel // w).float(), su, cam, w=w,
            h=h, filter_type=options.filter_type,
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

    finished = _all_done(done)
    while not finished:
        with profiling.span('path.bounce'):
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
            finished = _all_done(done)
    return film.reshape(h, w, 3)


# ---------------------------------------------------------------------------
# The general engine
# ---------------------------------------------------------------------------

def _ray_diff_reflect(spread, radius, mean_curvature, roughness):
    """ray.h:45-51."""
    spec = spread + 2.0 * mean_curvature * radius
    return torch.clamp(spec * (1.0 - roughness) + 0.2 * roughness, min=0.0)


def _ray_diff_refract(spread, radius, mean_curvature, eta, roughness):
    """ray.h:54-66."""
    spec = (spread + 2.0 * mean_curvature * radius) / eta
    return torch.clamp(spec * (1.0 - roughness) + 0.2 * roughness, min=0.0)


def _mis(p_this, p_other):
    """Power heuristic (k = 2) weight of the strategy with pdf p_this."""
    return (p_this * p_this) / torch.clamp(p_this * p_this +
                                           p_other * p_other, min=1e-30)


def _finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def _advance_lane(scene, options, st, u, detach=False):
    """One path-vertex step for a batch of lanes (lajolla_tpu vmaps a
    per-lane form; here every field has a leading lane axis N).

    st: (item, nv, org, d, spread, radius, T, L, eta_scale, dir_pdf,
    prev_pos, done) — item, nv (N,) int64; org, d, T, L, prev_pos (N, 3);
    spread, radius, eta_scale, dir_pdf (N,) float; done (N,) bool.
    u: (N, 8) uniforms for this vertex (the driver draws them from the
    counter hash). Returns (new state tuple, died), died marking the
    paths that complete THIS step (radiance ready to splat).

    detach=True is the DETACHED-sampling gradient mode of
    integrators/diffpath.py (reverse- and forward-mode autograd through
    the estimator): geometry (rays, hit records), sampled directions,
    sampling pdfs, MIS weights and the RR probability are detached, while
    BSDF *evaluations* and emission stay attached. Detaching the pdfs in
    denominators is what makes the gradient estimator unbiased for
    eval-side parameters: E[∂θ f(x;θ)/p_detached(x)] = ∂θ ∫f (attaching p
    would add the spurious -∫ f ∂θ p / p term); detaching the sample x
    itself drops only the reparameterization term that moves
    discontinuities (Mitsuba's 'detached' estimator). It rewrites only
    values that no live lane reads, so the film does not change."""
    sg = (lambda x: x.detach()) if detach else (lambda x: x)
    (item, nv, org, d, spread, radius, T, L, eta_scale,
     dir_pdf, prev_pos, done) = st
    org, d, prev_pos = sg(org), sg(d), sg(prev_pos)
    spread, radius = sg(spread), sg(radius)
    dir_pdf = sg(dir_pdf)
    meta = scene.meta
    eps_shadow = shadow_eps(meta.scene_radius)
    eps_isect = intersection_eps(meta.scene_radius)
    max_depth = options.max_depth
    n = item.shape[0]

    hit = intersect_scene(scene, org, d, eps_isect, INF, radius, spread)
    if detach:
        # Detached + SANITIZED: miss records carry t = inf and position =
        # o + inf·d. Forward, every use is masked out; in reverse mode
        # the masked branch's inf/NaN partials multiply the zero gradient
        # into NaN (0·inf), which the film gradient's sum then spreads to
        # every parameter. Zeroing non-finite fields leaves the film as
        # it is and keeps the backward pass finite.
        hit = type(hit)(*(_finite_or_zero(x.detach())
                          if x.is_floating_point() else x for x in hit))
    radius = radius + spread * torch.where(hit.valid, hit.t, 0.0)
    from_camera = nv == 2

    # ---- emission at this vertex (path_tracing.h:58-61 / :264-302) --------
    hit_light = hit.valid & (hit.light_id >= 0)
    Le = emission_area(scene, hit.light_id, hit.geometry_normal, -d)
    G2 = torch.abs(dot(d, hit.geometry_normal)) / \
        torch.clamp(distance_squared(hit.position, prev_pos), min=1e-20)
    p2 = dir_pdf * G2
    lp2 = LightPoint(position=hit.position, normal=hit.geometry_normal)
    p1 = sg(light_pmf(scene, hit.light_id) *
            pdf_point_on_light(scene, hit.light_id, lp2, prev_pos))
    if detach:
        # f32 overflow hygiene for autograd: pdf·geometry products can
        # pass 3.4e38 on near-degenerate lanes; forward, w = inf/inf =
        # NaN samples are dropped by the film's isfinite filter, but the
        # NaN poisons every gradient of the backward pass. Clamping at
        # 1e18 keeps those (discarded) values finite and is exact on
        # every other lane.
        p1, p2 = torch.clamp(p1, max=1e18), torch.clamp(p2, max=1e18)
    w2 = torch.where(from_camera, 1.0, _mis(p2, p1))
    L = L + torch.where(hit_light[:, None], T * Le * w2[:, None], 0.0)

    if meta.has_envmap:
        Lenv = emission_envmap(scene, d, spread)
        env_id = torch.full((n,), meta.envmap_light_id, dtype=torch.int32,
                            device=d.device)
        lpe = LightPoint(position=torch.zeros_like(d), normal=-d)
        p1e = sg(light_pmf(scene, env_id) *
                 pdf_point_on_light(scene, env_id, lpe, prev_pos))
        p2e = dir_pdf  # solid-angle measure; G = 1 for envmaps
        if detach:
            p1e, p2e = torch.clamp(p1e, max=1e18), torch.clamp(p2e, max=1e18)
        w2e = torch.where(from_camera, 1.0, _mis(p2e, p1e))
        L = L + torch.where(~hit.valid[:, None], T * Lenv * w2e[:, None],
                            0.0)

    # path continues only if we hit a non-light-limit vertex
    depth_stop = (nv >= 2 + MAX_BOUNCES_CAP) if max_depth == -1 else \
        (nv > max_depth)
    alive = hit.valid & ~depth_stop

    dir_view = -d
    mat_id = hit.material_id

    # ---- NEE (path_tracing.h:98-207) --------------------------------------
    light_id = sample_light(scene, u[:, 2])
    lp = sample_point_on_light(scene, light_id, hit.position, u[:, 0:2],
                               u[:, 3])
    if detach:
        lp = LightPoint(*(x.detach() for x in lp))
    if meta.has_envmap:
        is_env = scene.light_type[light_id.long()] == LIGHT_ENVMAP
    else:
        is_env = torch.zeros_like(done)
    dir_light_area = normalize(lp.position - hit.position)
    dir_light = torch.where(is_env[:, None], -lp.normal, dir_light_area)
    if detach:
        # degenerate shadow directions (coincident points: normalize
        # returns 0) are masked by nee_ok, but a microfacet BSDF
        # evaluated at wo = 0 has inf partials that NaN the backward
        # pass even under a zero gradient; substitute a benign direction
        dl_ok = dot(dir_light, dir_light) > 0.5
        dir_light = torch.where(dl_ok[:, None], dir_light, hit.frame[:, 2])
    dist2 = distance_squared(lp.position, hit.position)
    tfar = torch.where(is_env, INF, (1.0 - eps_shadow) * torch.sqrt(dist2))
    occ = occluded(scene, hit.position, dir_light, eps_shadow, tfar)
    G_area = torch.clamp(-dot(dir_light, lp.normal), min=0.0) / \
        torch.clamp(dist2, min=1e-20)
    G = torch.where(occ, 0.0, torch.where(is_env, 1.0, G_area))
    if detach:
        # a substituted (originally degenerate) shadow direction must
        # stay masked: the original G was exactly 0 there
        G = torch.where(dl_ok, G, 0.0)
    p1n = sg(light_pmf(scene, light_id) *
             pdf_point_on_light(scene, light_id, lp, hit.position))
    nee_ok = alive & (G > 0) & (p1n > 0)
    f_nee = eval_bsdf(scene, mat_id, dir_view, dir_light, hit)
    L_nee = emission_area(scene, light_id, lp.normal, -dir_light)
    if meta.has_envmap:
        L_nee = torch.where(is_env[:, None],
                            emission_envmap(scene, dir_light, 0.0), L_nee)
    p2n = sg(pdf_bsdf(scene, mat_id, dir_view, dir_light, hit)) * G
    if detach:
        p1n, p2n = torch.clamp(p1n, max=1e18), torch.clamp(p2n, max=1e18)
    w1 = _mis(p1n, p2n)
    # nee_ok-gated denominator: identical where the term is used; masked
    # lanes divide by 1 so their (discarded) values stay finite
    C1 = G[:, None] * f_nee * L_nee / torch.where(
        nee_ok, torch.clamp(p1n, min=1e-30), 1.0)[:, None]
    L = L + torch.where(nee_ok[:, None], T * C1 * w1[:, None], 0.0)

    # ---- BSDF sampling + RR (path_tracing.h:210-322) ----------------------
    rec = sample_bsdf(scene, mat_id, dir_view, hit, u[:, 4:6], u[:, 6])
    if detach:
        rec = type(rec)(*(x.detach() for x in rec))
        # invalid samples can return a zero or non-finite dir_out; the
        # lane is masked (alive &= rec.valid) but the eval / pdf at a
        # degenerate wo has inf partials: NaN through the backward pass
        do = _finite_or_zero(rec.dir_out)
        d_ok = dot(do, do) > 0.5
        rec = rec._replace(dir_out=torch.where(d_ok[:, None], do,
                                               hit.frame[:, 2]))
    f2 = eval_bsdf(scene, mat_id, dir_view, rec.dir_out, hit)
    p2s = sg(pdf_bsdf(scene, mat_id, dir_view, rec.dir_out, hit))
    alive = alive & rec.valid & (p2s > 0)

    do_rr = (nv - 1) >= options.rr_depth
    rr_prob = sg(torch.where(
        do_rr, torch.clamp((T / eta_scale[:, None]).amax(dim=-1), max=0.95),
        1.0))
    alive = alive & (u[:, 7] <= rr_prob)

    is_refract = rec.eta != 0.0
    new_spread = torch.where(
        is_refract,
        _ray_diff_refract(spread, radius, hit.mean_curvature,
                          torch.clamp(rec.eta, min=1e-6), rec.roughness),
        _ray_diff_reflect(spread, radius, hit.mean_curvature, rec.roughness))
    new_eta_scale = torch.where(
        is_refract, eta_scale / torch.clamp(rec.eta * rec.eta, min=1e-12),
        eta_scale)
    # dead lanes carry T = 0 (the queue regenerates them; their radiance
    # was latched at death)
    new_T = torch.where(alive[:, None], T * f2 / torch.clamp(
        p2s * rr_prob, min=1e-30)[:, None], 0.0)
    if detach:
        # overflow hygiene (see the p1 / p2 clamp above): a fireball
        # lane's T must not reach inf — inf·0 NaNs the backward pass
        new_T = torch.clamp(new_T, max=1e18)

    died = ~done & ~alive

    nst = (item, nv + 1, hit.position, rec.dir_out, new_spread, radius,
           new_T, L, new_eta_scale, p2s, hit.position, done)
    return nst, died


def _primary_hash(scene, options, item, seed_u32, nq=None):
    """Camera rays for work items `item` ((N,) int64) with hash-derived
    uniforms, through camera.sample_primary. `nq` >= n is the padded
    queue stride; items with pixel >= n are dummy lanes whose radiance
    is discarded. Returns (pixel, org, dir)."""
    w = scene.meta.width
    n = nq or (w * scene.meta.height)
    pixel = item % n
    px = (pixel % w).to(torch.float32)
    py = (pixel // w).to(torch.float32)
    hp = pcg_hash(item ^ pcg_hash(seed_u32 ^ 0xCAFEF00D))
    u_pix = torch.stack(
        [hash_u01(pcg_hash((hp + GOLD) & M32)),
         hash_u01(pcg_hash((hp + (2 * GOLD & M32)) & M32))], dim=-1)
    org, d = sample_primary(scene, options, px, py, u_pix)
    return pixel, org, d


def _render_block_sc(scene, options, seed, s0, nspp, lanes=None):
    """Render nspp samples/pixel (sample indices s0..s0+nspp) of the full
    film with the general engine's persistent-wavefront queue. Returns
    (film_sum (n_q, 3), final state, loop iterations). `lanes` < n
    shrinks the worker pool; the queue semantics are unchanged.

    Each iteration advances every lane by one vertex; a lane whose path
    ended adds its radiance to its pixel (index_add_; a sample with any
    non-finite channel is dropped whole, render.cpp:140-143) and takes
    the next item, item + lanes. The loop ends when every lane has run
    out of items; `done.all()` is read back to the host every
    iteration."""
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    lanes = lanes or n
    su = int(seed) & M32
    # padded queue stride: item ≡ lane (mod lanes)
    n_q = -(-n // lanes) * lanes
    end = (s0 + nspp) * n_q
    _check_items(end)
    dev = scene.tri_shade.device
    item0 = torch.arange(lanes, device=dev) + s0 * n_q
    _pix, org0, d0 = _primary_hash(scene, options, item0, su, n_q)
    spread0 = 0.25 / max(w, h)
    st = (item0, torch.full((lanes,), 2, device=dev), org0, d0,
          torch.full((lanes,), spread0, device=dev),
          torch.zeros(lanes, device=dev), torch.ones((lanes, 3), device=dev),
          torch.zeros((lanes, 3), device=dev), torch.ones(lanes, device=dev),
          torch.zeros(lanes, device=dev), org0,
          torch.zeros(lanes, dtype=torch.bool, device=dev))
    film = torch.zeros((n_q, 3), device=dev)
    iters = 0

    while not bool(st[11].all()):
        uN = _vertex_uniforms(st[0], st[1], su).T              # (N, 8)
        nst, died = _advance_lane(scene, options, st, uN)
        (item, nv, org, d, spread, radius, T, L, eta_scale,
         dir_pdf, prev_pos, done) = nst

        fin = torch.isfinite(L).all(dim=-1)
        film.index_add_(0, item % n_q,
                        torch.where((died & fin)[:, None], L, 0.0))

        next_item = item + lanes
        has_more = next_item < end
        regen = died & has_more
        done = done | (died & ~has_more)

        _rp, rorg, rd = _primary_hash(scene, options, next_item, su, n_q)
        r1 = regen[:, None]
        st = (torch.where(regen, next_item, item),
              torch.where(regen, 2, nv),
              torch.where(r1, rorg, org),
              torch.where(r1, rd, d),
              torch.where(regen, spread0, spread),
              torch.where(regen, 0.0, radius),
              torch.where(r1, 1.0, T),
              torch.where(r1, 0.0, L),
              torch.where(regen, 1.0, eta_scale),
              torch.where(regen, 0.0, dir_pdf),
              torch.where(r1, rorg, prev_pos),
              done)
        iters += 1
    return film, st, iters


def _schedule(scene):
    """(samples per pixel in one block, lanes) of a render, as
    lajolla_tpu's render_path sets them: a scene whose casts are the
    cluster sweeps takes one sample per block and a small lane pool
    (short launches of the heavy casts); lanes < pixels pads the queue
    stride n_q to a multiple of the pool, which sets every work item and
    so every random number."""
    n = scene.meta.width * scene.meta.height
    if scene.meta.use_binned:
        big = scene.meta.num_triangles >= (1 << 17)
        return 1, min(n, SWEEP_LANES_BIG if big else SWEEP_LANES)
    return (KERNEL_SPP_BLOCK if _use_kernel(scene) else SPP_BLOCK), n


def _render_block(scene, options, seed, s0, nspp, lanes=None):
    """Film sum (h, w, 3) of samples s0..s0+nspp, dispatched as
    lajolla_tpu's `_render_block` (without its TPU-only test): scenes
    inside path_kernel.supports take the fused kernels — K1 for films of
    more than one 4096-pixel block (lajolla_tpu's kernel also asks for a
    whole number of them; K1 does not), else the per-bounce driver with
    K2 — and every other scene the general engine, with a pool of
    `lanes` lanes (default: one per pixel)."""
    from lajolla_tpu_torch.integrators import path_megakernel
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    if not _use_kernel(scene):
        film, _, _ = _render_block_sc(scene, options, seed, s0, nspp, lanes)
        return film[:n].reshape(h, w, 3)
    if n > path_megakernel.BLOCK:
        return path_megakernel.render_fused(scene, options, seed, s0, nspp)
    return _render_block_kernel(scene, options, seed, s0, nspp)


def render_path_samples(scene, options, seed, s_begin, s_end, film=None,
                        on_block=None):
    """The film sum (h, w, 3), on the scene's device, of samples s_begin ..
    s_end of every pixel: blocks of _schedule's size from s_begin, each
    added onto `film` (default: the first block) in sample order, and
    `on_block(film, samples done)` called after each. Work items are keyed
    on (sample, pixel) with a stride that depends only on the film and the
    lane pool, so ranges that split [0, spp) draw the random numbers of one
    render of spp samples, and their sum is its film up to the order of the
    float sums (parallel/mesh.py). Each block is the span `path.block`."""
    spp_block, lanes = _schedule(scene)
    s0 = s_begin
    while s0 < s_end:
        ns = min(spp_block, s_end - s0)
        with profiling.span('path.block'):
            block = _render_block(scene, options, seed, s0, ns, lanes)
            film = block if film is None else film + block
        s0 += ns
        if on_block is not None:
            on_block(film, s0)
    if film is None:
        h, w = scene.meta.height, scene.meta.width
        film = torch.zeros((h, w, 3), device=scene.tri_shade.device)
    return film


def render_path(scene, options, seed=0, checkpoint=None, progress=False):
    """Block-accumulating driver on the scene's device → (h, w, 3) numpy
    image. `checkpoint` (optional path) persists (film sum, samples done,
    seed) after every block so an interrupted render resumes exactly —
    possible because the RNG is counter-based per (pixel, sample) work
    item. The film's return to the host is the spans `render.film_wait`
    (the device's queued work, while the recorder is on) and
    `render.film_copy`."""
    from lajolla_tpu_torch.utils.checkpoint import load_film, save_film
    from lajolla_tpu_torch.utils.progress import ProgressReporter

    spp = options.samples_per_pixel
    h, w = scene.meta.height, scene.meta.width
    img, s0 = None, 0
    if checkpoint:
        img, s0 = load_film(checkpoint, seed, (h, w, 3))
    rep = ProgressReporter(spp, enabled=progress)
    rep.done = s0

    def on_block(film, done):
        rep.update(done - rep.done)
        if checkpoint:
            save_film(checkpoint, seed, film.cpu().numpy(), done)

    film = None if img is None else torch.from_numpy(img).to(
        scene.tri_shade.device)
    film = render_path_samples(scene, options, seed, s0, spp, film, on_block)
    rep.finish()
    profiling.sync('render.film_wait', film.device)
    with profiling.span('render.film_copy'):
        return return_film(film, spp)
