"""The reference against the port's plain forms on the CPU: the tables it
works out from a configuration equal the program's compile of the XML the
benchmark writes, and its pixels equal the program's film bit for bit on
a small film (the port's CPU path runs the plain forms): 16 x 12, a film
of one partial block, which takes the per-bounce driver, and 128 x 64,
two whole blocks, which takes the fused kernel's plain form."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import check, harness, kinds

CASES = {'cbox': dict(spp=4)}
FILMS = [(16, 12), (128, 64)]


def _scene(name, tmp_path, w=16, h=12):
    with open(os.path.join(harness.HERE, 'configs', f'{name}.json')) as f:
        cfg = json.load(f)
    kind = kinds.load(cfg)
    xml = kind.write_scene(str(tmp_path), cfg, w, h, CASES[name]['spp'])
    return xml, kind, kind.build(cfg, w, h, device='cpu')


@pytest.mark.parametrize('name', sorted(CASES))
def test_tables_equal_the_programs(name, tmp_path):
    from lajolla_tpu_torch.scene.parser import parse_scene
    xml, _, ref = _scene(name, tmp_path)
    scene, _ = parse_scene(xml)
    for k in ('fp_tri', 'fp_woop', 'tri_stair_cdf', 'fp_light', 'cast_src',
              'cast_alt', 'cast_quad'):
        assert torch.equal(getattr(scene, k).float(),
                           getattr(ref, k).float()), k
    cam = torch.cat([scene.sample_to_cam.reshape(-1),
                     scene.cam_to_world.reshape(-1)])
    assert torch.equal(cam, ref.cam)
    assert scene.meta.scene_radius == ref.meta.scene_radius


@pytest.mark.parametrize('film', FILMS, ids=lambda f: f'{f[0]}x{f[1]}')
@pytest.mark.parametrize('name', sorted(CASES))
def test_pixels_equal_the_programs_film(name, film, tmp_path):
    import lajolla_tpu_torch
    w, h = film
    xml, kind, ref = _scene(name, tmp_path, w, h)
    scene, options = lajolla_tpu_torch.parse_scene(xml, 'cpu')
    spp = CASES[name]['spp']
    seed = check.frame_seed(2 ** 31 + 5, 3)
    img = lajolla_tpu_torch.render(scene, options, device='cpu', seed=seed)
    pixels = check.sample_pixels(9, w * h, 40)
    want = check.reference_pixels(kind, ref, [seed], pixels, spp, chunk=spp)
    got = img.reshape(-1, 3)[pixels][None]
    assert np.array_equal(got, want)
    assert check.compare(got, want, pixels) == \
        dict(block_off=0.0, median_rel=0.0, mean_gap=0.0)
