"""volpath versions 1 and 2 (integrators/volpath.py: volpath1_trace_one,
volpath2_trace_one, _render_volpath_simple_block and their route in
render_volpath) against lajolla_tpu on the CPU. Scenes are carried
across through bridge.py, so both sides start from the same tables and
draw the same threefry keys.

- Each tracer against lajolla_tpu's under jax.vmap on the same numpy
  keys and pixels, on the 'vol' Cornell box and the submerged sphere
  lights: >= 99.9% of lanes within rtol 1e-4 / atol 1e-6 (version 2's
  free flight compares a sampled distance with the hit's, which a last
  bit of XLA's log against torch's can flip on a few lanes).
- The block's films at 32x32 x 4 spp from samples 0 and 3: median
  per-pixel relative difference < 1e-4, film means within 1e-3.
- render(device='cpu') for both versions equal to the blocks it sums;
  a checkpointed render resumed equal to an uninterrupted one; the CLI
  on a 'vol' XML with <integer name="version" value="2"/> equal to
  render() within the EXR's half-float rounding (rtol 1e-3).
"""

import jax
import numpy as np
import pytest
import torch

import lajolla_tpu.integrators.volpath as JV
import lajolla_tpu.scene.compile as JC
from lajolla_tpu.scene.types import RenderOptions as JOptions
import lajolla_tpu_torch.integrators.volpath as PV
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch import cli, render
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.io.image import imread3
from lajolla_tpu_torch.scene.types import RenderOptions

from torch_threads import one_thread  # noqa: F401

LANES = 1 << 12
RES = 32


BUILDERS = {'vol': lambda: PT.cornell_box_builder(RES, variant='vol'),
            'submerged': lambda: PT.submerged_sphere_builder(RES)}


@pytest.fixture(scope='module', params=sorted(BUILDERS))
def scenes(request):
    js = JC.compile_scene(BUILDERS[request.param]())
    return request.param, js, to_port(js)


def opts(version, spp=4):
    return (JOptions(integrator='volpath', vol_path_version=version,
                     samples_per_pixel=spp),
            RenderOptions(integrator='volpath', vol_path_version=version,
                          samples_per_pixel=spp))


def close_share(got, want, rtol, atol):
    ok = np.isclose(got, want, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(axis=1).mean()


def film_gates(got, want):
    rel = np.abs(got - want) / (np.abs(want) + 1e-3)
    return float(np.median(rel)), abs(got.mean() - want.mean()) / want.mean()


@pytest.mark.parametrize('version', [1, 2])
def test_tracer_matches_jax(scenes, version):
    name, js, ps = scenes
    rng = np.random.default_rng(10 + version)
    keys = rng.integers(0, 1 << 32, (LANES, 2), dtype=np.uint64)
    px = rng.integers(0, RES, LANES).astype(np.int32)
    py = rng.integers(0, RES, LANES).astype(np.int32)
    jo, po = opts(version)
    tracer = {1: JV.volpath1_trace_one, 2: JV.volpath2_trace_one}[version]
    want = np.asarray(jax.jit(jax.vmap(
        lambda x, y, k: tracer(js, jo, x, y, k)))(
        px, py, keys.astype(np.uint32)))
    got = PV._TRACERS[version](
        ps, po, torch.from_numpy(px.astype(np.int64)),
        torch.from_numpy(py.astype(np.int64)),
        torch.from_numpy(keys.astype(np.int64))).numpy()
    assert np.isfinite(got).all()
    # version 1 lights only the lanes that see the light; version 2 most
    lit = (got > 0).any(axis=1)
    if version == 1:
        assert lit.sum() == (want > 0).any(axis=1).sum() > 0, name
    else:
        assert lit.mean() > 0.2, name
    share = close_share(got, want, 1e-4, 1e-6)
    assert share >= 0.999, (name, version, share)


@pytest.mark.parametrize('version', [1, 2])
@pytest.mark.parametrize('s0', [0, 3])
def test_block_film_matches_jax(scenes, version, s0):
    name, js, ps = scenes
    jo, po = opts(version)
    want = np.asarray(JV._render_volpath_simple_block(js, jo, 7, s0, 4))
    got = PV._render_volpath_simple_block(ps, po, 7, s0, 4).numpy()
    assert got.shape == (RES * RES, 3) and np.isfinite(got).all()
    med, mean_rel = film_gates(got, want)
    assert med < 1e-4 and mean_rel < 1e-3, (name, version, med, mean_rel)


@pytest.mark.parametrize('version', [1, 2])
def test_render_sums_the_blocks(version):
    """render() routes versions 1 and 2 to the simple block, in blocks
    of VOL_SPP_BLOCK samples."""
    scene = PT.make_cornell_box(16, variant='vol')
    _, po = opts(version, spp=2 * PV.VOL_SPP_BLOCK)
    img = render(scene, po, device='cpu', seed=3)
    want = np.zeros((16 * 16, 3), np.float32)
    for s0 in (0, PV.VOL_SPP_BLOCK):
        want += PV._render_volpath_simple_block(
            scene, po, 3, s0, PV.VOL_SPP_BLOCK).numpy()
    want = (want / po.samples_per_pixel).reshape(16, 16, 3)
    assert img.shape == (16, 16, 3) and np.array_equal(img, want)


def test_checkpoint_resume_equals_uninterrupted(tmp_path, monkeypatch):
    monkeypatch.setattr(PV, 'VOL_SPP_BLOCK', 2)
    scene = PT.make_cornell_box(16, variant='vol')
    ck = str(tmp_path / 'ck.npz')
    full = render(scene, opts(2, 6)[1], device='cpu')
    render(scene, opts(2, 2)[1], device='cpu', checkpoint=ck)
    resumed = render(scene, opts(2, 6)[1], device='cpu', checkpoint=ck)
    assert np.array_equal(resumed, full)


def test_cli_renders_version_2_xml(tmp_path):
    xml = PT.write_cornell_box_xml(str(tmp_path), 24, 4, variant='vol',
                                   vol_path_version=2)
    out = str(tmp_path / 'v2.exr')
    assert cli.main([xml, '-o', out, '--device', 'cpu']) == 0
    img = imread3(out)
    scene = PT.make_cornell_box(24, variant='vol')
    want = render(scene, opts(2, 4)[1], device='cpu')
    assert img.shape == (24, 24, 3) and np.isfinite(img).all()
    # the EXR holds half floats: 2^-11 relative rounding
    np.testing.assert_allclose(img, want, rtol=1e-3, atol=1e-6)
