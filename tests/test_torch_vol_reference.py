"""The homogeneous-medium Cornell box of the benchmark (configuration
`vol`, kind volpath_homogeneous) through the port's normal path, held
against the benchmark's frozen reference of K8's vertex on the CPU.

At 64x64 x 2 spp (one whole 4096-pixel block) render() takes K8's plain
form; on three media drawn from a seed (per-channel sigma_a and sigma_s,
optical depths across the room 0.2-3, a random emitter) its film agrees
with the reference within the cell's limits, and the reference computed
in bfloat16 does not. The configuration's own scene parses into K8's
class at the cell's film, so that a scene that fell to the general engine
fails here."""

import copy
import json
import os

import numpy as np
import pytest

import lajolla_tpu_torch
from benchmark import check
from benchmark.kinds import volpath_homogeneous as kind
from lajolla_tpu_torch.integrators import volpath as PV
from lajolla_tpu_torch.integrators import volpath_kernel as PVK

from torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, SPP = 64, 2
ROOM = 2.0        # the room's width: [-1, 1]^3


def _load(*parts):
    with open(os.path.join(ROOT, 'benchmark', *parts)) as f:
        return json.load(f)


CONFIG = _load('configs', 'vol.json')
LIMITS = _load('cells', 'vol.final-512.json')['limits']


def random_medium(seed):
    """`vol` with a medium and an emitter drawn from `seed`: each
    channel's optical depth across the room in [0.2, 3] and its albedo in
    [0.1, 0.95]; the light's radiance in [1, 30] a channel."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.2, 3.0, 3)
    albedo = rng.uniform(0.1, 0.95, 3)
    sigma_t = depth / ROOM
    cfg = copy.deepcopy(CONFIG)
    cfg['medium'].update(sigma_a=(sigma_t * (1 - albedo)).tolist(),
                         sigma_s=(sigma_t * albedo).tolist(), scale=1.0)
    light, = [s for s in cfg['shapes'] if 'emitter' in s]
    light['emitter'] = rng.uniform(1.0, 30.0, 3).tolist()
    return cfg


def _parse(tmp_path, cfg, res, spp):
    xml = kind.write_scene(str(tmp_path), cfg, res, res, spp)
    return lajolla_tpu_torch.parse_scene(xml, 'cpu')


@pytest.mark.parametrize('medium_seed, render_seed',
                         [(11, 2 ** 31 + 7), (12, 93_518_327),
                          (13, 4_000_000_019)])
def test_render_matches_the_reference(tmp_path, monkeypatch, medium_seed,
                                      render_seed):
    cfg = random_medium(medium_seed)
    scene, opt = _parse(tmp_path, cfg, RES, SPP)
    plain = []

    def counting(*a):
        plain.append(a[3:])
        return real(*a)
    real = PVK.render_fused_vol_plain
    monkeypatch.setattr(PVK, 'render_fused_vol_plain', counting)
    got = lajolla_tpu_torch.render(scene, opt, device='cpu',
                                   seed=render_seed).reshape(-1, 3)
    assert plain == [(0, SPP)], "the film left K8's route"
    ref = kind.build(cfg, RES, RES)
    pixels = np.arange(RES * RES)
    work = {}
    want = check.reference_pixels(kind, ref, [render_seed], pixels, SPP,
                                  SPP, stats=work)
    nums = check.compare(got[None], want, pixels)
    assert check.verdict(nums, LIMITS), nums
    assert want.mean() > 0 and np.isfinite(want).all()
    assert work['vertices'] == work['casts'] >= RES * RES * SPP
    assert work['medium_events'] + work['surface_events'] == \
        work['shadow_tests'] > 0
    low = check.reference_pixels(kind, ref, [render_seed], pixels, SPP, SPP,
                                 rounding=check.bf16_round)
    assert not check.verdict(check.compare(low, want, pixels), LIMITS)


def test_configuration_takes_k8_at_the_cells_film(tmp_path):
    traffic = _load('traffic', 'final-512.json')
    assert traffic['width'] == traffic['height'] == 512
    scene, opt = _parse(tmp_path, CONFIG, 512, traffic['spp'])
    assert scene.meta.uniform_medium
    assert PV._use_vol_kernel(scene) and PVK.supports(scene.meta)
    assert not PV._use_grid_kernel(scene)
    assert opt.integrator == 'volpath' and opt.vol_path_version == 5
    assert opt.max_depth == -1 and opt.samples_per_pixel == 256
    sa, ss, g = PVK.medium(scene)
    ref = kind.build(CONFIG, 512, 512)
    assert np.array_equal(sa.numpy(), ref.sigma_a[:, 0].numpy())
    assert np.array_equal(ss.numpy(), ref.sigma_s[:, 0].numpy())
    assert np.allclose(sa.numpy(), 0.13875) and np.allclose(ss.numpy(),
                                                            0.2775)


@pytest.mark.parametrize('strip', ['sensor', 'exterior'])
def test_a_medium_left_off_leaves_k8(tmp_path, strip):
    """Without the sensor's <ref id> or one shape's exterior, the scene is
    outside K8's class: the test above would see the fall."""
    xml = kind.write_scene(str(tmp_path), CONFIG, 64, 64, 1)
    text = open(xml).read()
    cut = ('<ref id="medium" />' if strip == 'sensor' else
           '<ref name="exterior" id="medium" />')
    assert cut in text
    with open(xml, 'w') as f:
        f.write(text.replace(cut, '', 1))
    scene, _ = lajolla_tpu_torch.parse_scene(xml, 'cpu')
    assert not scene.meta.uniform_medium and not PV._use_vol_kernel(scene)
