"""The five aux integrators (integrators/aux.py) through render() on the
CPU against lajolla_tpu's `render_aux`, and through the CLI.

Fixtures: the white box (camera inside a closed cube), the textured
sphere-light scene (an image texture: mip levels), the sphere-light
scene (sphere hits), the 'disney' Cornell box (tangent frames of the
anisotropic BSDFs, a checkerboard and an image texture) and the mesh
Cornell box at ~2,000 triangles (its casts take the cluster sweeps'
plain forms, lajolla_tpu's sweeps run in Pallas interpret mode).

Gates are lajolla_tpu's tests/test_aux_parity.py's
(testing.aux_agreement): each value within 2e-3 of the film's largest
magnitude (2e-2 for meanCurvature, whose dn/du chain amplifies fp32
rounding) on >= 99.9% of the film.

The Cornell-box films are 65 x 64: on a square film pixel-centre rays
run exactly along the room's diagonal seams (wall and floor or ceiling
meet on the film's diagonals), where the two walls' t differ in the last
bit only and a last-bit difference of either package picks the other
wall (and lajolla_tpu's interpret-mode sweep misses some of them
outright, where the port hits); one more column puts no pixel centre on
a diagonal.
"""

import jax
import numpy as np
import pytest

import lajolla_tpu.scene.compile as JC
import lajolla_tpu.testing as JT
from lajolla_tpu.integrators.aux import render_aux as jax_render_aux
from lajolla_tpu.scene.types import RenderOptions as JOptions
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch import cli, render
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.io.image import imread3
from lajolla_tpu_torch.scene.types import RenderOptions

from torch_threads import one_thread  # noqa: F401

MODES = ('depth', 'shadingNormal', 'meanCurvature', 'rayDifferential',
         'mipmapLevel')
FILM = (65, 64)


def _wide(b):
    b.camera.width, b.camera.height = FILM
    return JC.compile_scene(b)


FIXTURES = {
    'white_box': lambda: JT.make_white_box_scene(res=64),
    'textured': lambda: _wide(PT.textured_builder(64)),
    'sphere_lights': lambda: _wide(PT.sphere_light_builder(64)),
    'disney_cbox': lambda: JC.compile_scene(
        PT.cornell_box_builder(FILM, variant='disney')),
    'mesh_cbox': lambda: JC.compile_scene(
        PT.cornell_box_builder(FILM, variant='mesh', triangles=2000)),
}
# (fixture, mode) pairs whose film is identically zero in both packages:
# flat or sphere-free geometry has no curvature, and only the textured
# fixture has an image base color
ZERO = {('white_box', 'meanCurvature'), ('disney_cbox', 'meanCurvature'),
        ('white_box', 'mipmapLevel'), ('sphere_lights', 'mipmapLevel'),
        ('disney_cbox', 'mipmapLevel'), ('mesh_cbox', 'mipmapLevel')}

_scenes = {}


def _scene(fixture):
    if fixture not in _scenes:
        js = FIXTURES[fixture]()
        _scenes[fixture] = (js, to_port(js))
    return _scenes[fixture]


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('fixture', list(FIXTURES))
def test_aux_matches_jax(fixture, mode):
    js, ps = _scene(fixture)
    want = np.asarray(jax.jit(jax_render_aux, static_argnames=('options',))(
        js, JOptions(integrator=mode)))
    got = render(ps, RenderOptions(integrator=mode), device='cpu')
    assert got.shape == want.shape == (js.meta.height, js.meta.width, 3)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    if (fixture, mode) in ZERO:
        assert not want.any() and not got.any()
    else:
        assert np.abs(want).max() > 0
    share = PT.aux_agreement(got, want, mode)
    assert share >= 0.999, share


def test_mesh_aux_casts_in_chunks(monkeypatch):
    """A scene with cluster tables casts its pixel rays in chunks of
    SWEEP_LANES_BIG: at a chunk of 1000 rays the film is the same."""
    from lajolla_tpu_torch.integrators import aux
    _, ps = _scene('mesh_cbox')
    opts = RenderOptions(integrator='depth')
    whole = render(ps, opts, device='cpu')
    monkeypatch.setattr(aux, 'SWEEP_LANES_BIG', 1000)
    assert np.array_equal(render(ps, opts, device='cpu'), whole)


def test_cli_renders_an_aux_integrator(tmp_path):
    xml = PT.write_cornell_box_xml(str(tmp_path), FILM, 1, variant='disney',
                                   integrator='shadingNormal')
    out = str(tmp_path / 'normal.exr')
    assert cli.main([xml, '-o', out, '--device', 'cpu']) == 0
    img = imread3(out)
    js, _ = _scene('disney_cbox')
    want = np.asarray(jax.jit(jax_render_aux, static_argnames=('options',))(
        js, JOptions(integrator='shadingNormal')))
    assert img.shape == want.shape
    assert PT.aux_agreement(img, want, 'shadingNormal') >= 0.999


def test_seam_rays_hit_in_the_plain_sweep():
    """The mesh box's seam rays (testing.SEAM_PIXELS, on the 64x64 film's
    diagonals, which lajolla_tpu's interpret-mode sweep misses) hit in the
    port's plain sweep, as in brute force; chip_smoke.py [15] holds K5 +
    K4 on the card to the same count."""
    scene = PT.make_cornell_box(64, 1, 'mesh', triangles=PT.SEAM_TRIANGLES)
    assert scene.meta.use_binned
    depth = render(scene, RenderOptions(integrator='depth'),
                   device='cpu')[..., 0]
    ys, xs = np.array(PT.SEAM_PIXELS).T
    assert ((xs == ys) | (xs == 63 - ys)).all()
    assert (depth[ys, xs] > 0).all(), depth[ys, xs]
