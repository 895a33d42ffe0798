"""Which engine path._render_block sends a film to, on the CPU.

Scenes inside path_kernel.supports take K1 (path_megakernel.render_fused)
for films of more than one 4096-pixel block, whole blocks or not, and the
per-bounce driver (_render_block_kernel) with K2 for films of one block or
less; every other scene takes the general engine (_render_block_sc). The
engines are stubbed, so each case records the route alone and the film's
shape. Then render() of a ragged film (the Cornell box at 65x64: 4,160
pixels, one block and 64 pixels more), which takes K1's plain form here,
against lajolla_tpu's render_path of the same builder scene on the same
seed (its per-bounce driver on the TPU, its queue here: the same
estimator on the same (seed, item, bounce, dim) random numbers), with
the gates of tests/test_torch_slice.py: median per-pixel relative
difference below 1e-4, over the film and in its partial block, and film
means within 1%.
"""

import numpy as np
import pytest
import torch

import lajolla_tpu.integrators.path as JPATH
import lajolla_tpu.scene.compile as JC
from lajolla_tpu.scene.types import RenderOptions as JOptions
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch import render
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.integrators import path as PP
from lajolla_tpu_torch.integrators import path_megakernel as PMK
from lajolla_tpu_torch.scene.types import RenderOptions

from torch_threads import one_thread  # noqa: F401


# (width, height, variant, the route _render_block takes)
CASES = [
    (32, 32, None, 'driver'),        # a quarter block
    (64, 64, None, 'driver'),        # one whole block: not more than one
    (65, 64, None, 'k1'),            # one block and 64 pixels
    (96, 96, None, 'k1'),            # 2.25 blocks
    (97, 61, None, 'k1'),            # 5,917 pixels: 1.44 blocks
    (128, 64, None, 'k1'),           # two whole blocks
    (97, 61, 'glass', 'general'),    # outside path_kernel.supports
]


@pytest.mark.parametrize('w, h, variant, route', CASES,
                         ids=[f"{w}x{h}-{v or 'cbox'}"
                              for w, h, v, _ in CASES])
def test_render_block_routes_by_film_size(monkeypatch, w, h, variant,
                                          route):
    scene = PT.make_cornell_box((w, h), variant=variant)
    n = w * h
    calls = []

    def film(name):
        def stub(scene_, *a, **k):
            calls.append(name)
            return torch.zeros((h, w, 3))
        return stub

    def general(scene_, *a, **k):
        calls.append('general')
        return torch.zeros((n, 3)), None, 0
    monkeypatch.setattr(PMK, 'render_fused', film('k1'))
    monkeypatch.setattr(PP, '_render_block_kernel', film('driver'))
    monkeypatch.setattr(PP, '_render_block_sc', general)
    got = PP._render_block(scene, RenderOptions(), 0, 0, 1)
    assert calls == [route]
    assert got.shape == (h, w, 3)


def test_ragged_film_through_k1_matches_jax_render_path(monkeypatch):
    w, h = 65, 64
    js = JC.compile_scene(PT.cornell_box_builder((w, h)))
    want = np.asarray(JPATH.render_path(js, JOptions(samples_per_pixel=2),
                                        seed=7))
    calls = []
    real = PMK.render_fused
    monkeypatch.setattr(PMK, 'render_fused',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = render(to_port(js), RenderOptions(samples_per_pixel=2),
                 device='cpu', seed=7)
    assert calls == [1]
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert 0.05 < want.mean() < 5.0
    rel = (np.abs(got - want) / (want + 1e-3)).reshape(w * h, 3)
    assert np.median(rel) < 1e-4, np.median(rel)
    tail = rel[w * h - w * h % PMK.BLOCK:]          # the partial block
    assert len(tail) == 64 and np.median(tail) < 1e-4, np.median(tail)
    assert abs(got.mean() - want.mean()) / want.mean() < 0.01
