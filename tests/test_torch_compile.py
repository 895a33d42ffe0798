"""The port's scene compiler against lajolla_tpu's: the same builder (or
the same fixture, or the same XML) gives the same tables, byte for byte,
and the same SceneMeta."""

import dataclasses
import hashlib
import os

import numpy as np
import pytest

import lajolla_tpu.scene.compile as JC
import lajolla_tpu.scene.parser as JP
import lajolla_tpu.testing as JT
import lajolla_tpu_torch.scene.compile as PC
import lajolla_tpu_torch.scene.parser as PP
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch.scene.types import Scene

from torch_threads import one_thread  # noqa: F401


def _assert_same(js, ps):
    """Every tensor of the port's Scene equals lajolla_tpu's field."""
    assert dataclasses.asdict(ps.meta) == dataclasses.asdict(js.meta)
    for f in dataclasses.fields(Scene):
        if f.name == 'meta':
            continue
        j = np.asarray(getattr(js, f.name))
        p = getattr(ps, f.name).numpy()
        assert p.dtype == j.dtype and p.shape == j.shape, f.name
        assert np.array_equal(p, j), f.name


@pytest.mark.parametrize('name', ['cornell_box', 'sphere_light'])
def test_builder_fixture(name):
    builder = getattr(PT, f'{name}_builder')
    _assert_same(JC.compile_scene(builder(24)),
                 PC.compile_scene(builder(24)))


@pytest.mark.parametrize('make', [
    lambda T: T.make_white_box_scene(),
    lambda T: T.make_single_material_scene('diffuse'),
    lambda T: T.make_single_material_scene('roughplastic'),
], ids=['white_box', 'diffuse', 'roughplastic'])
def test_ported_fixture(make):
    _assert_same(make(JT), make(PT))


def test_cornell_box_xml(tmp_path):
    """write_cornell_box_xml writes what both parsers read identically,
    and what make_cornell_box builds in code."""
    xml = PT.write_cornell_box_xml(str(tmp_path), 40, 8)
    js, jopt = JP.parse_scene(xml)
    ps, popt = PP.parse_scene(xml)
    _assert_same(js, ps)
    assert dataclasses.asdict(popt) == dataclasses.asdict(jopt)
    assert popt.samples_per_pixel == 8 and ps.meta.width == 40
    built = PT.make_cornell_box(40, spp=8)
    for f in dataclasses.fields(Scene):
        if f.name != 'meta':
            assert np.array_equal(getattr(built, f.name).numpy(),
                                  getattr(ps, f.name).numpy()), f.name


@pytest.mark.parametrize('name', ['furnace', 'textured'])
def test_general_engine_fixture(name):
    builder = getattr(PT, f'{name}_builder')
    _assert_same(JC.compile_scene(builder()), PC.compile_scene(builder()))


def test_furnace_matches_jax_fixture():
    _assert_same(JT.make_furnace_scene(), PT.make_furnace_scene())


def test_glass_cornell_box_xml(tmp_path):
    """write_cornell_box_xml(variant='glass') writes what both parsers
    read identically, and what cornell_box_builder(variant='glass')
    builds in code."""
    xml = PT.write_cornell_box_xml(str(tmp_path), 24, 16, variant='glass')
    js, _ = JP.parse_scene(xml)
    ps, popt = PP.parse_scene(xml)
    _assert_same(js, ps)
    assert popt.samples_per_pixel == 16
    assert ps.meta.mat_types_present == (0, 1, 2) and ps.meta.needs_uv
    _assert_same(js, PT.make_cornell_box(24, spp=16, variant='glass'))


@pytest.mark.parametrize('variant', ['vol', 'vol_hg', 'vol_glass'])
def test_vol_cornell_box_xml(tmp_path, variant):
    """The volumetric variants' XML: both parsers read the same tables,
    media included, and cornell_box_builder builds them in code."""
    xml = PT.write_cornell_box_xml(str(tmp_path), 24, 8, variant=variant)
    js, jopt = JP.parse_scene(xml)
    ps, popt = PP.parse_scene(xml)
    _assert_same(js, ps)
    assert dataclasses.asdict(popt) == dataclasses.asdict(jopt)
    assert popt.integrator == 'volpath'
    assert ps.meta.camera_medium_id == 0
    assert ps.meta.num_media == (2 if variant == 'vol_glass' else 1)
    assert ps.meta.uniform_medium is (variant != 'vol_glass')
    _assert_same(js, PT.make_cornell_box(24, spp=8, variant=variant))


@pytest.mark.parametrize('name', ['submerged_sphere', 'media_zoo'])
def test_media_builder_fixture(name):
    builder = getattr(PT, f'{name}_builder')
    _assert_same(JC.compile_scene(builder()), PC.compile_scene(builder()))


# sha256 over the file names and bytes of write_cornell_box_xml(d, 40, 8)
# and of its 'glass' variant, as they were before the volumetric variants.
CBOX_XML_SHA256 = {
    None: 'f8f4602e05a0660377a6f9e7109b3af4e3f056632099d819062424f848a20713',
    'glass':
        'f6fe673fcf249d52d655f4989a404d24d7e63931674d4439dd3f756eb5f05126',
}


@pytest.mark.parametrize('variant', list(CBOX_XML_SHA256))
def test_surface_cornell_box_xml_unchanged(tmp_path, variant):
    PT.write_cornell_box_xml(str(tmp_path), 40, 8, variant=variant)
    h = hashlib.sha256()
    for name in sorted(os.listdir(tmp_path)):
        h.update(name.encode())
        h.update((tmp_path / name).read_bytes())
    assert h.hexdigest() == CBOX_XML_SHA256[variant]
