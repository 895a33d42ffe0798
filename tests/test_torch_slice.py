"""The port's main path end to end on the CPU, against lajolla_tpu's fused
kernel run in Pallas interpret mode.

Both sides draw the same (seed, item, bounce, dim) random numbers, so most
pixels agree almost exactly; a path splits only where a last-bit fp
difference flips a comparison. Gates, as tests/test_kernel_engine.py
holds lajolla_tpu's own kernels: median per-pixel relative difference
below 1e-4 and film means within 1%.
"""


import numpy as np
import pytest
import torch

import lajolla_tpu.integrators.path_megakernel as JMK
import lajolla_tpu.scene.compile as JC
from lajolla_tpu.scene.types import RenderOptions as JOptions
import lajolla_tpu_torch.integrators.path as PPATH
import lajolla_tpu_torch.integrators.path_kernel as PK
import lajolla_tpu_torch.integrators.path_megakernel as PMK
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch import cli, render
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.io.image import imread3
from lajolla_tpu_torch.scene import types as T
from lajolla_tpu_torch.scene.types import RenderOptions

from torch_threads import one_thread  # noqa: F401


def jax_fused(js, spp, monkeypatch, block=None):
    monkeypatch.setattr(JMK, 'INTERPRET', True)
    if block:
        monkeypatch.setattr(JMK, 'BLOCK', block)
    return np.asarray(JMK.render_fused(js, JOptions(), 0, 0, spp)) / spp


def assert_films_agree(got, want):
    assert np.isfinite(got).all() and np.isfinite(want).all()
    rel = np.abs(got - want) / (want + 1e-3)
    assert np.median(rel) < 1e-4, np.median(rel)
    assert abs(got.mean() - want.mean()) / want.mean() < 0.01


@pytest.mark.parametrize('builder', ['cornell_box', 'sphere_light'])
def test_render_fused_matches_jax_interpret(builder, monkeypatch):
    js = JC.compile_scene(getattr(PT, f'{builder}_builder')(64))
    want = jax_fused(js, 4, monkeypatch)
    got = PMK.render_fused(to_port(js), RenderOptions(), 0, 0, 4).numpy() / 4
    assert_films_agree(got, want)


def test_render_fused_counters_come_from_the_kernel():
    """K1's SIMT counters are the CUDA kernel's: the plain form, which CPU
    scenes run, refuses a counters dict rather than leave it empty."""
    scene = PT.make_cornell_box(64)
    with pytest.raises(ValueError, match='SIMT counters'):
        PMK.render_fused(scene, RenderOptions(), 0, 0, 1, counters={})


def test_render_entry_point_matches_jax(monkeypatch):
    """render() on a 32x32 film takes the per-bounce driver
    (_render_block_kernel); lajolla_tpu's fused kernel renders the same
    film with its lane block cut to the film."""
    js = JC.compile_scene(PT.cornell_box_builder(32))
    want = jax_fused(js, 4, monkeypatch, block=32 * 32)
    calls = []
    real = PPATH._render_block_kernel
    monkeypatch.setattr(PPATH, '_render_block_kernel',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = render(to_port(js), RenderOptions(samples_per_pixel=4),
                 device='cpu')
    assert calls
    assert_films_agree(got, want)


def test_white_box_analytic():
    """Closed emissive box: L = Le / (1 - rho) = 0.3 / 0.1 = 3.0."""
    img = render(PT.make_white_box_scene(res=8),
                 RenderOptions(samples_per_pixel=256), device='cpu')
    assert abs(img.mean() - 3.0) / 3.0 < 0.03, img.mean()


def test_checkpoint_resume_equals_uninterrupted(tmp_path, monkeypatch):
    monkeypatch.setattr(PPATH, 'KERNEL_SPP_BLOCK', 2)
    scene = PT.make_cornell_box(16)
    ck = str(tmp_path / 'ck.npz')
    full = render(scene, RenderOptions(samples_per_pixel=6), device='cpu')
    render(scene, RenderOptions(samples_per_pixel=2), device='cpu',
           checkpoint=ck)
    resumed = render(scene, RenderOptions(samples_per_pixel=6),
                     device='cpu', checkpoint=ck)
    assert np.array_equal(resumed, full)
    assert np.load(ck)['samples_done'] == 6


def test_cli_renders_cornell_box_xml(tmp_path):
    xml = PT.write_cornell_box_xml(str(tmp_path), 24, 2)
    out = str(tmp_path / 'cbox.exr')
    assert cli.main([xml, '-o', out, '--device', 'cpu']) == 0
    img = imread3(out)
    assert img.shape == (24, 24, 3) and np.isfinite(img).all()
    assert 0.05 < img.mean() < 5.0


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        render(PT.make_cornell_box(8), RenderOptions(samples_per_pixel=1),
               device='cuda')


def test_scene_outside_kernel_support_renders():
    """A scene outside the kernels' support (the Cornell box with a
    Disney-diffuse material) takes the general engine and renders,
    finite, with its mean in range."""
    b = PT.cornell_box_builder(8)
    b.materials[0].type = T.MAT_DISNEY_DIFFUSE
    scene = PT.compile_scene(b)
    assert not PK.supports(scene.meta)
    img = render(scene, RenderOptions(samples_per_pixel=2), device='cpu')
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert 0.05 < img.mean() < 5.0
