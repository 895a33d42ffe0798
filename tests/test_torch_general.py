"""The general engine (integrators/path.py `_advance_lane`,
`_render_block_sc`, render(), the CLI) against lajolla_tpu on the CPU.

- One vertex: the port's `_advance_lane` against
  `jax.vmap(_advance_lane)` on numpy-seeded lanes
  (testing.random_general_lanes) of the glass Cornell box (three BSDFs,
  a checkerboard, quad lights), the sphere-light scene (sphere lights and
  hits) and the furnace (an environment map, no triangles). Gates as
  testing.assert_advance_agrees sets them for the kernels: the died bits
  agree on 99.9% of lanes, and 99.9% of the lanes that go on on both
  sides agree on every output to rtol 1e-4 / atol 1e-5 (dir_pdf rtol
  1e-2, next to a GGX peak; the direction atol 1e-4, VERTEX_TOL);
  radiance agrees on 99.9% of all lanes.
- Films: `_render_block_sc` on the glass Cornell box at 64x64 x 4 spp
  against lajolla_tpu's: both draw the same counter-hash random numbers,
  so the gates are lajolla_tpu's own for its kernels — median per-pixel
  relative difference < 1e-4 and film means within 1%.
- The furnace through render(): the mean over the pixels well inside the
  sphere within 3% of albedo x env radiance, every such pixel within 15%
  (64 spp of noise).
- The CLI on the glass Cornell box XML at 32x32.
"""


import jax
import numpy as np
import pytest
import torch

import lajolla_tpu.integrators.path as JPATH
import lajolla_tpu.scene.compile as JC
from lajolla_tpu.scene.types import RenderOptions as JOptions
import lajolla_tpu_torch.integrators.path as PPATH
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch import cli, render
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.io.image import imread3
from lajolla_tpu_torch.scene.types import RenderOptions

from torch_threads import one_thread  # noqa: F401

LANES = 1 << 14


FIXTURES = {
    'glass_cbox': lambda: PT.cornell_box_builder(32, variant='glass'),
    'sphere_lights': lambda: PT.sphere_light_builder(32),
    'furnace': lambda: PT.furnace_builder(),
}

# (rtol, atol) per output of one vertex (see testing.ADVANCE_RTOL). The
# sampled direction gets atol 1e-4: on a sphere it is built in the
# tangent frame, whose last-bit sin/cos differences the projection
# amplifies to ~5e-5 (test_torch_geometry.FRAME_TOL).
VERTEX_TOL = dict(org=(1e-4, 1e-5), d=(1e-4, 1e-4), spread=(1e-4, 1e-5),
                  radius=(1e-4, 1e-5), T=(1e-4, 1e-5),
                  eta_scale=(1e-4, 1e-5), dir_pdf=(1e-2, 1e-5))


@pytest.mark.parametrize('fixture', list(FIXTURES))
def test_advance_lane_matches_jax(fixture):
    js = JC.compile_scene(FIXTURES[fixture]())
    ps = to_port(js)
    lanes = PT.random_general_lanes(ps, LANES, seed=21)
    st = [lanes[k] for k in PT.GENERAL_STATE]
    jst = [x.astype(np.int32) if k in ('item', 'nv') else x
           for k, x in zip(PT.GENERAL_STATE, st)]
    step = jax.jit(jax.vmap(lambda u, *s: JPATH._advance_lane(
        js, JOptions(), s, u)))
    want, want_died = step(lanes['u'], *jst)
    got, got_died = PPATH._advance_lane(
        ps, RenderOptions(), tuple(torch.from_numpy(x) for x in st),
        torch.from_numpy(lanes['u']))
    want = dict(zip(PT.GENERAL_STATE, (np.asarray(x) for x in want)))
    got = dict(zip(PT.GENERAL_STATE, (x.numpy() for x in got)))
    want_died, got_died = np.asarray(want_died), got_died.numpy()

    for k in ('item', 'nv', 'done'):
        assert np.array_equal(got[k], want[k]), k
    assert (got_died == want_died).mean() >= 0.999
    done = lanes['done']
    goes_on = ~done & ~got_died & ~want_died
    assert 0.05 < goes_on.mean() < 0.95
    assert (want_died & ~done).any()
    for k, (rtol, atol) in VERTEX_TOL.items():
        ok = np.isclose(got[k], want[k], rtol=rtol, atol=atol)
        ok = ok.reshape(LANES, -1).all(axis=1)
        assert ok[goes_on].mean() >= 0.999, (k, ok[goes_on].mean())
    ok = np.isclose(got['L'], want['L'], rtol=1e-4, atol=1e-5).all(axis=1)
    assert ok.mean() >= 0.999, ok.mean()
    # the fixture gathers light at this vertex
    assert (want['L'] != lanes['L']).any()


def test_render_block_sc_matches_jax():
    b = PT.cornell_box_builder(64, variant='glass')
    js = JC.compile_scene(b)
    spp = 4
    wf, _, witers = JPATH._render_block_sc(js, JOptions(), 0, 0, spp)
    gf, _, giters = PPATH._render_block_sc(to_port(js), RenderOptions(), 0,
                                           0, spp)
    want, got = np.asarray(wf) / spp, gf.numpy() / spp
    assert np.isfinite(got).all() and np.isfinite(want).all()
    rel = np.abs(got - want) / (want + 1e-3)
    assert np.median(rel) < 1e-4, np.median(rel)
    assert abs(got.mean() - want.mean()) / want.mean() < 0.01
    assert abs(giters - int(witers)) <= 2


def test_render_block_sc_refuses_int32_item_overflow():
    """Work items are int64 here and int32 in lajolla_tpu: a block whose
    items would wrap there raises before any work."""
    scene = PT.make_cornell_box(16, variant='glass')
    with pytest.raises(ValueError, match="int32"):
        PPATH._render_block_sc(scene, RenderOptions(), 0, (1 << 31) // 256,
                               1)


def test_furnace():
    albedo, env = 0.6, 1.0
    img = render(PT.make_furnace_scene(albedo, res=24, env_radiance=env),
                 RenderOptions(samples_per_pixel=64), device='cpu')
    sphere = img[PT.furnace_sphere_mask(24)]
    assert sphere.size > 100 * 3 and np.isfinite(img).all()
    assert abs(sphere.mean() - albedo * env) / (albedo * env) < 0.03
    assert (np.abs(sphere - albedo * env) < 0.15 * albedo * env).all()


def test_cli_renders_glass_cornell_box_xml(tmp_path, monkeypatch):
    xml = PT.write_cornell_box_xml(str(tmp_path), 32, 4, variant='glass')
    calls = []
    real = PPATH._render_block_sc
    monkeypatch.setattr(PPATH, '_render_block_sc',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = str(tmp_path / 'glass.exr')
    assert cli.main([xml, '-o', out, '--device', 'cpu']) == 0
    assert calls
    img = imread3(out)
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert 0.05 < img.mean() < 5.0
