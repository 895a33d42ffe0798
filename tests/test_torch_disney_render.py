"""The Disney slice end to end on the CPU: the 'disney' Cornell box (six
Disney BSDFs, one a surface, a checkerboard base color and a roughness
image; testing.cornell_box_builder) through the general engine against
lajolla_tpu, and through the CLI.

- Tables: the XML that write_cornell_box_xml writes reads the same in
  both parsers, and equals cornell_box_builder's in both compilers.
- One vertex: tests/test_torch_disney_vertex.py (a file of its own:
  lajolla_tpu's jit of the all-lobe switch takes ~30 s in each file).
- Films: `_render_block_sc` at 32x32 x 4 spp against lajolla_tpu's (the
  same counter-hash random numbers): median per-pixel relative
  difference < 1e-4, film means within 1%.
- The CLI at 32x32: a finite EXR, mean luminance in (0.02, 2).
"""

import dataclasses

import numpy as np
import pytest

import lajolla_tpu.integrators.path as JPATH
import lajolla_tpu.scene.compile as JC
import lajolla_tpu.scene.parser as JP
from lajolla_tpu.scene.types import RenderOptions as JOptions
import lajolla_tpu_torch.integrators.path as PPATH
import lajolla_tpu_torch.scene.parser as PP
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch import cli
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.io.image import imread3
from lajolla_tpu_torch.scene import types as T
from lajolla_tpu_torch.scene.types import RenderOptions
from test_torch_compile import _assert_same

from torch_threads import one_thread  # noqa: F401

LUMINANCE = np.array([0.212671, 0.715160, 0.072169])


@pytest.fixture(scope='module')
def disney():
    js = JC.compile_scene(PT.cornell_box_builder(32, variant='disney'))
    return js, to_port(js)


def test_disney_cornell_box_xml(tmp_path):
    xml = PT.write_cornell_box_xml(str(tmp_path), 24, 4, variant='disney')
    js, jopt = JP.parse_scene(xml)
    ps, popt = PP.parse_scene(xml)
    _assert_same(js, ps)
    assert dataclasses.asdict(popt) == dataclasses.asdict(jopt)
    _assert_same(js, PT.make_cornell_box(24, spp=4, variant='disney'))
    meta = ps.meta
    assert meta.mat_types_present == (
        T.MAT_LAMBERTIAN, T.MAT_DISNEY_DIFFUSE, T.MAT_DISNEY_METAL,
        T.MAT_DISNEY_GLASS, T.MAT_DISNEY_CLEARCOAT, T.MAT_DISNEY_SHEEN,
        T.MAT_DISNEY_BSDF)
    assert meta.needs_tangent and meta.has_image_textures and meta.needs_uv
    kinds = set(ps.tex_kind.tolist())
    assert {T.TEX_CHECKERBOARD, T.TEX_IMAGE} <= kinds


def test_render_block_sc_matches_jax(disney):
    js, ps = disney
    spp = 4
    wf, _, witers = JPATH._render_block_sc(js, JOptions(), 0, 0, spp)
    gf, _, giters = PPATH._render_block_sc(ps, RenderOptions(), 0, 0, spp)
    want, got = np.asarray(wf) / spp, gf.numpy() / spp
    assert np.isfinite(got).all() and np.isfinite(want).all()
    rel = np.abs(got - want) / (want + 1e-3)
    assert np.median(rel) < 1e-4, np.median(rel)
    assert abs(got.mean() - want.mean()) / want.mean() < 0.01
    assert abs(giters - int(witers)) <= 2


def test_cli_renders_disney_cornell_box_xml(tmp_path):
    xml = PT.write_cornell_box_xml(str(tmp_path), 32, 4, variant='disney')
    out = str(tmp_path / 'disney.exr')
    assert cli.main([xml, '-o', out, '--device', 'cpu']) == 0
    img = imread3(out)
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert 0.02 < float((img @ LUMINANCE).mean()) < 2.0
