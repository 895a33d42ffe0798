"""Differentiable path tracing in torch autograd.

Port of lajolla_tpu/integrators/diffpath.py. The general engine's vertex
step (`path._advance_lane`) is plain torch, so a fixed-depth loop over it
is a renderer that reverse mode (`loss.backward()`) and forward mode
(`grad_fwd`) differentiate end to end: scene parameters (albedos,
roughness, light intensity, textures, media) get exact
detached-estimator gradients with no code per material.

The estimator is the wavefront estimator with two deviations, both
standard for differentiable rendering:

  1. A fixed bounce budget (`depth` steps, no persistent queue): paths
     still die by Russian roulette; survivors at the budget are
     truncated exactly like a `max_depth = depth` forward render.
  2. Detached sampling (`_advance_lane(detach=True)`): geometry, sampled
     directions, sampling pdfs, MIS weights and RR are detached; BSDF
     evaluations and emission stay attached. Unbiased for eval-side
     parameters; parameters that move visibility discontinuities (vertex
     positions) get the interior term alone.

The films are those of `_render_block_sc` with the same seed and
`max_depth` on a film whose queue needs no padded stride (every scene
without cluster tables): the same counter-hash stream keyed on (seed,
item, bounce).

A parameter is a leaf tensor put into the Scene with
`dataclasses.replace`:

    kd = torch.tensor([0.5, 0.5, 0.5], requires_grad=True)
    def loss(kd):
        tab = scene.tex_tab.clone()
        tab[tid, 2:5] = kd
        img = render_diff(dataclasses.replace(scene, tex_tab=tab),
                          options, spp=4, depth=4)
        return ((img - target) ** 2).mean()
    loss(kd).backward()

The casts (kernels K3-K7 on the card) see detached rays only, so they
need no backward.

Gradient robustness (see also core/math.safe_sqrt and _CtBarrier):
every sqrt-at-clip site uses safe_sqrt (exact value, clamped derivative)
so masked lanes cannot emit inf partials; finished lanes are parked on a
benign unit ray, and a barrier at every step zeroes any non-finite
gradient a lane still carries. lajolla_tpu notes that XLA's optimizer can
still leak a dead lane's inf partial into its reverse-mode sum on
microfacet scenes; eager torch fuses nothing across ops, and grad_fwd
(forward mode) never forms those products.
"""

import torch
import torch.autograd.forward_ad as fwAD
from torch.utils import _pytree as pytree

from lajolla_tpu_torch.core import random as rnd
from lajolla_tpu_torch.core.random import M32
from lajolla_tpu_torch.integrators.path import (_advance_lane, _primary_hash,
                                                _vertex_uniforms)


class _CtBarrier(torch.autograd.Function):
    """Identity in the forward pass and in forward mode; its backward
    zeroes non-finite gradients. Parked (finished) lanes re-run the vertex
    step every iteration, and their zero gradients crossing inf partials
    give NaN (0·inf) in the state chain; sanitizing at every step
    boundary makes a finished lane contribute zero gradient, as it
    contributes zero radiance."""

    @staticmethod
    def forward(x):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return torch.where(torch.isfinite(g), g, 0.0)

    @staticmethod
    def jvp(ctx, t):
        return t.clone()


def _ct_barrier(x):
    return _CtBarrier.apply(x)


def _barrier_state(st):
    return tuple(_ct_barrier(x) if x.is_floating_point() else x for x in st)


def render_diff(scene, options, seed=0, spp=4, depth=6, s0=0):
    """Differentiable render: the (h, w, 3) film MEAN over `spp` samples
    with a fixed `depth`-bounce budget, differentiable with respect to
    any float tensor of `scene` that parameterizes shading or emission.
    One lane a work item, items s0·n + k (k < n·spp): `s0` offsets the
    sample indices, so a render split over the sample axis draws the
    single render's random numbers."""
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    lanes = n * spp
    su = int(seed) & M32
    dev = scene.tri_shade.device
    item0 = torch.arange(lanes, device=dev) + s0 * n    # item % n = pixel
    _pix, org0, d0 = _primary_hash(scene, options, item0, su)
    z = torch.zeros(lanes, device=dev)
    st = (item0, torch.full((lanes,), 2, device=dev), org0, d0,
          torch.full((lanes,), 0.25 / max(w, h), device=dev), z,
          torch.ones((lanes, 3), device=dev),
          torch.zeros((lanes, 3), device=dev),
          torch.ones(lanes, device=dev), z, org0,
          torch.zeros(lanes, dtype=torch.bool, device=dev))
    Lf = torch.zeros((lanes, 3), device=dev)
    unitz = torch.zeros((lanes, 3), device=dev)
    unitz[:, 2] = 1.0
    for _ in range(depth):
        uN = _vertex_uniforms(st[0], st[1], su).T               # (N, 8)
        nst, died = _advance_lane(scene, options, st, uN, detach=True)
        # latch radiance at death (no regeneration: one path a lane)
        Lf = torch.where(died[:, None], nst[7], Lf)
        done = nst[11] | died
        # Park finished lanes on a BENIGN unit ray (origin 0, dir +z,
        # T = L = 0) every step. A dead lane that kept marching would
        # step from degenerate state (zero sampled directions, inf miss
        # positions); its values are masked out forward, but any inf/NaN
        # partial those ops produce (e.g. the GGX cos^4 division of rough
        # materials at wo = 0) would reach the backward pass through the
        # zero-gradient lanes and NaN the WHOLE film gradient. The benign
        # ray keeps every later step finite with finite partials; its
        # (T = 0)-weighted contributions are exact zeros.
        db = done[:, None]
        nst = (nst[0], nst[1],
               torch.where(db, 0.0, nst[2]),             # org
               torch.where(db, unitz, nst[3]),           # dir
               torch.where(done, 0.0, nst[4]),           # spread
               torch.where(done, 0.0, nst[5]),           # radius
               torch.where(db, 0.0, nst[6]),             # T
               torch.where(db, 0.0, nst[7]),             # L
               torch.where(done, 1.0, nst[8]),           # eta_scale
               torch.where(done, 1.0, nst[9]),           # dir_pdf
               torch.where(db, 0.0, nst[10]),            # prev_pos
               done)
        st = _barrier_state(nst)
        Lf = _ct_barrier(Lf)
    # budget-truncated survivors contribute their accumulated radiance
    Lf = torch.where(st[11][:, None], Lf, st[7])
    # whole-sample NaN/Inf exclusion (render.cpp:140-143)
    Lf = torch.where(torch.isfinite(Lf).all(dim=-1, keepdim=True), Lf, 0.0)
    return Lf.reshape(spp, n, 3).sum(0).reshape(h, w, 3) / spp


def grad_fwd(loss_fn, params):
    """FORWARD-mode gradient of a scalar loss with respect to a small
    parameter pytree: one forward-mode pass (torch.autograd.forward_ad
    dual tensors) per scalar parameter. Forward mode never forms the
    products of a zero gradient with an inf partial that reverse mode
    must sanitize, so it suits few-parameter recovery (albedos,
    roughness, sigma) on microfacet scenes; reverse mode suits large
    texture tables. Returns the gradient in the pytree's structure, each
    leaf of its parameter's shape and float dtype (float32 for a Python
    number or an integer tensor)."""
    leaves, spec = pytree.tree_flatten(params)
    leaves = [torch.as_tensor(x).detach() for x in leaves]
    leaves = [x if x.is_floating_point() else x.float() for x in leaves]
    grads = []
    for i, leaf in enumerate(leaves):
        g = torch.zeros(leaf.numel(), dtype=leaf.dtype, device=leaf.device)
        for k in range(leaf.numel()):
            tangent = torch.zeros_like(leaf).reshape(-1)
            tangent[k] = 1.0
            with fwAD.dual_level():
                dual = list(leaves)
                dual[i] = fwAD.make_dual(leaf, tangent.reshape(leaf.shape))
                out = loss_fn(pytree.tree_unflatten(dual, spec))
                dv = fwAD.unpack_dual(out).tangent
            g[k] = 0.0 if dv is None else dv
        grads.append(g.reshape(leaf.shape))
    return pytree.tree_unflatten(grads, spec)


def render_volpath_diff(scene, options, seed=0, spp=4):
    """Differentiable VOLUMETRIC render of the single-scattering
    versions 1 and 2 (options.vol_path_version): the (h, w, 3) film mean,
    differentiable with respect to the medium (σ_a, σ_s), phase and
    emission parameters of the scene. Version 1 is closed form (nothing is
    sampled from a parameter, so plain autograd is exact); version 2 runs
    `volpath2_trace_one(detach=True)`. The keys are those of
    volpath._render_volpath_simple_block, so the film is the forward
    driver's."""
    from lajolla_tpu_torch.integrators.volpath import (_simple_pixels,
                                                       volpath1_trace_one,
                                                       volpath2_trace_one)
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    pix, px, py = _simple_pixels(scene, 0, n)
    pixel_keys = rnd.fold_in(rnd.prng_key(seed, pix.device), pix)
    if options.vol_path_version == 1:
        tracer = volpath1_trace_one
    else:
        def tracer(*a):
            return volpath2_trace_one(*a, detach=True)
    img = torch.zeros((n, 3), device=pix.device)
    for i in range(spp):
        L = tracer(scene, options, px, py, rnd.fold_in(pixel_keys, i))
        img = img + torch.where(torch.isfinite(L), L, 0.0)
    return (img / spp).reshape(h, w, 3)
