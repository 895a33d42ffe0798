"""Differentiable volpath versions 1 and 2 (integrators/diffpath.py
render_volpath_diff; volpath2_trace_one(detach=True)) against the
port's forward driver, central differences and lajolla_tpu on the CPU,
on the 'vol' Cornell box built in code (lajolla_tpu's own gates,
tests/test_diffpath.py, read the reference's volpath_test files).

- The film equals _render_volpath_simple_block's (rtol 1e-4, atol 1e-6)
  for both versions.
- Version 1's gradient on sigma_a against central differences of the
  same stream (rel 5e-3, < 0): nothing is sampled from sigma_a.
- Version 2's detached gradient on (sigma_a, sigma_s) against central
  differences at 16x16 x 128 spp (rel 0.1, != 0): the free flight
  samples from sigma_t, so they agree in expectation only.
- Both gradients against lajolla_tpu's jax.grad of the same loss
  (rel 2e-3).
- The sigma recovery of the example (80 Adam steps from 0.4 at 24x24 x
  16 spp) against lajolla_tpu's with optax.adam on the same loss: both
  drop the loss below 1e-2 of its start, and the port lands within 2e-3
  of lajolla_tpu's scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lajolla_tpu.integrators.diffpath as JD
import lajolla_tpu.scene.compile as JC
from lajolla_tpu.integrators.media import MT_SA
from lajolla_tpu.scene.types import RenderOptions as JOptions
import lajolla_tpu_torch.integrators.volpath as PV
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.examples import inverse_rendering as EX
from lajolla_tpu_torch.integrators import diffpath as PD
from lajolla_tpu_torch.scene.types import RenderOptions

from torch_threads import one_thread  # noqa: F401


def vol_box(res):
    js = JC.compile_scene(PT.cornell_box_builder(res, variant='vol'))
    return js, to_port(js)


def opts(version):
    return (JOptions(integrator='volpath', vol_path_version=version),
            RenderOptions(integrator='volpath', vol_path_version=version))


def losses(js, ps, version, cols, seed, spp):
    """The mean film as a function of a scale on med_tab columns
    MT_SA .. MT_SA + cols (3: sigma_a; 6: sigma_a and sigma_s), in the
    port and in lajolla_tpu."""
    jo, po = opts(version)

    def loss(s):
        med = ps.med_tab.clone()
        med[:, MT_SA:MT_SA + cols] = ps.med_tab[:, MT_SA:MT_SA + cols] * s
        return PD.render_volpath_diff(dataclasses.replace(ps, med_tab=med),
                                      po, seed=seed, spp=spp).mean()

    def jloss(s):
        med = js.med_tab.at[:, MT_SA:MT_SA + cols].mul(s)
        return jnp.mean(JD.render_volpath_diff(
            dataclasses.replace(js, med_tab=med), jo, seed=seed, spp=spp))
    return loss, jloss


def grad_and_fd(loss, eps):
    x = torch.tensor(1.0, requires_grad=True)
    loss(x).backward()
    with torch.no_grad():
        fd = float(loss(torch.tensor(1.0 + eps)) -
                   loss(torch.tensor(1.0 - eps))) / (2 * eps)
    return float(x.grad), fd


@pytest.mark.parametrize('version', [1, 2])
def test_primal_matches_forward_driver(version):
    _, ps = vol_box(32)
    _, po = opts(version)
    with torch.no_grad():
        img = PD.render_volpath_diff(ps, po, seed=3, spp=4).numpy()
    want = PV._render_volpath_simple_block(ps, po, 3, 0, 4).numpy()
    assert np.isfinite(img).all() and img.mean() > 0
    np.testing.assert_allclose(img, want.reshape(32, 32, 3) / 4, rtol=1e-4,
                               atol=1e-6)


def test_version1_gradient():
    js, ps = vol_box(16)
    loss, jloss = losses(js, ps, 1, 3, seed=1, spp=2)
    g, fd = grad_and_fd(loss, 1e-2)
    # a deterministic hit distance: plain autograd is exact, and the
    # central difference errs by O(eps^2)
    assert g == pytest.approx(fd, rel=5e-3) and g < 0, (g, fd)
    jg = float(jax.grad(jloss)(jnp.float32(1.0)))
    assert g == pytest.approx(jg, rel=2e-3), (g, jg)


def test_version2_gradient():
    js, ps = vol_box(16)
    loss, _ = losses(js, ps, 2, 6, seed=1, spp=128)
    g, fd = grad_and_fd(loss, 5e-2)
    assert g == pytest.approx(fd, rel=0.1) and g != 0.0, (g, fd)
    # lajolla_tpu's gradient on the same loss, at 8 spp
    loss, jloss = losses(js, ps, 2, 6, seed=2, spp=8)
    x = torch.tensor(1.0, requires_grad=True)
    loss(x).backward()
    jg = float(jax.grad(jloss)(jnp.float32(1.0)))
    assert float(x.grad) == pytest.approx(jg, rel=2e-3), (float(x.grad), jg)


def test_sigma_recovery():
    """The example's recovery. On this scene it stops above the truth in
    both frameworks (~1.115 after 80 steps): the loss is flat above a
    scale of 1 (more scattering makes up for more absorption), and once
    Adam passes 1 with the momentum of its first steps, its second
    moment, filled by those steps' gradients, leaves steps too small to
    come back. The port is held against lajolla_tpu's run of the same
    recovery."""
    l0, lN, s = EX.recover_sigma('cpu')
    assert lN < 1e-2 * l0, (l0, lN)

    js = JC.compile_scene(PT.cornell_box_builder(24, variant='vol'))
    jo, _ = opts(2)

    def render_with(s):
        med = js.med_tab.at[:, MT_SA:MT_SA + 6].mul(s)
        return JD.render_volpath_diff(dataclasses.replace(js, med_tab=med),
                                      jo, seed=5, spp=16)
    target = render_with(jnp.float32(1.0))

    def loss_and_grad(s):
        return jax.value_and_grad(
            lambda s: jnp.mean((render_with(s) - target) ** 2))(s)

    js_s = jnp.float32(0.4)
    tx = optax.adam(0.05)
    ost = tx.init(js_s)
    jl0 = float(loss_and_grad(js_s)[0])
    for _ in range(80):
        _, g = loss_and_grad(js_s)
        upd, ost = tx.update(g, ost)
        js_s = jnp.clip(js_s + upd, 0.05, 3.0)
    assert float(loss_and_grad(js_s)[0]) < 1e-2 * jl0
    assert float(s) == pytest.approx(float(js_s), abs=2e-3), (float(s),
                                                             float(js_s))
