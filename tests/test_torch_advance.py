"""One path vertex: lajolla_tpu's `_advance_core`, run as plain jnp on
the CPU, against the port's plain `_advance_core` on the same numpy-seeded
lanes and the same compiled tables (carried across by bridge.py).

Gates: lajolla_tpu_torch.testing.assert_advance_agrees, which
chip_smoke.py also applies to the CUDA kernel: alive bits agree on 99.9%
of lanes, and 99.9% of the lanes alive on both sides agree on every
output to rtol 1e-4 / atol 1e-5 (dir_pdf: rtol 1e-2; the reasons are in
that module).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lajolla_tpu.integrators.path_kernel as JK
import lajolla_tpu.scene.compile as JC
import lajolla_tpu.testing as JT
from lajolla_tpu.dtypes import intersection_eps, shadow_eps
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.integrators.path import MAX_BOUNCES_CAP
from lajolla_tpu_torch.integrators.path_kernel import advance_plain_t
from lajolla_tpu_torch.scene.types import RenderOptions

from torch_threads import one_thread  # noqa: F401

LANES = 1 << 15


def jax_advance(js, lanes, options):
    m = js.meta
    core = jax.jit(functools.partial(
        JK._advance_core, T=js.fp_tri.shape[1], TC=js.fp_woop.shape[0],
        T_OCC=js.fp_woop_occ.shape[0], L=js.fp_light.shape[1],
        S=m.num_spheres, mats=m.mat_types_present, has_quads=m.has_quads,
        eps_isect=intersection_eps(m.scene_radius),
        eps_shadow=shadow_eps(m.scene_radius), max_depth=options.max_depth,
        rr_depth=options.rr_depth, max_cap=MAX_BOUNCES_CAP))
    out = core(lanes['org'], lanes['dir'], lanes['thr'], lanes['rad'],
               lanes['nv'].astype(np.float32)[None], lanes['dir_pdf'][None],
               lanes['prev'], lanes['un'], jnp.asarray(lanes['act'])[None],
               JK._woop_mat(js.fp_woop), JK._woop_mat(js.fp_woop_occ),
               js.fp_tri, js.fp_tri[:, js.cast_src],
               js.fp_tri[:, js.cast_alt], js.cast_quad[:, None],
               js.cast_occ_quad[:, None], js.fp_light,
               js.tri_stair_cdf[None, :], js.fp_sph)
    org, d, thr, rad, dp, alive = (np.asarray(x) for x in out)
    return dict(org=org, dir=d, thr=thr, rad=rad, dir_pdf=dp[0]), alive[0]


def _no_quad_cbox(monkeypatch):
    monkeypatch.setattr(JC, 'MERGE_QUADS', False)
    js = JC.compile_scene(PT.cornell_box_builder(32))
    assert not js.meta.has_quads
    return js


FIXTURES = {
    'quad_cbox': lambda mp: JC.compile_scene(PT.cornell_box_builder(32)),
    'no_quad_cbox': _no_quad_cbox,
    'sphere_lights': lambda mp: JC.compile_scene(PT.sphere_light_builder()),
    'roughplastic': lambda mp: JT.make_single_material_scene('roughplastic'),
}


@pytest.mark.parametrize('fixture', list(FIXTURES))
def test_advance_matches_jax(fixture, monkeypatch):
    js = FIXTURES[fixture](monkeypatch)
    ps = to_port(js)
    lanes = PT.random_lanes(ps, LANES, seed=11)
    options = RenderOptions()
    want, want_alive = jax_advance(js, lanes, options)
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    org, d, thr, rad, dp, prev, alive = advance_plain_t(
        ps, options, t['org'], t['dir'], t['thr'], t['rad'], t['nv'],
        t['dir_pdf'], t['prev'], t['un'], t['act'], MAX_BOUNCES_CAP)
    assert prev is org
    got = dict(org=org.numpy(), dir=d.numpy(), thr=thr.numpy(),
               rad=rad.numpy(), dir_pdf=dp.numpy())
    PT.assert_advance_agrees(got, alive.numpy(), want, want_alive)
    # the fixture exercises the kernel: lanes live, die, and gather light
    assert 0.05 < want_alive.mean() < 0.95
    assert (want['rad'] != lanes['rad']).any()
