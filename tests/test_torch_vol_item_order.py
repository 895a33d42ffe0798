"""The property that kernels K8 and K9 rest on, on the CPU: a path's
radiance is a function of its work item alone (every draw is a
counter-hash cell of the item), so the radiance of any list of items, in
any order and any grouping into lanes, summed per pixel in sample order
by film_sum_kernel's plain form, is the film of the kernels' plain forms
bit for bit. The CUDA kernels take items from a device counter in
persistent warps and rely on exactly this.

- K8: `volpath_kernel.vol_items_plain` over a numpy-shuffled list of a
  film's items, in three uneven batches, scattered to the (nspp*n, 3)
  per-item buffer and summed by `film_sum_plain`, equals
  `render_fused_vol_plain` (torch.equal) on 'vol', 'vol_hg' and the
  submerged sphere lights (24x24 x 3 spp from sample 2).
- K9: `volpath_grid_kernel.grid_items_plain` the same way against
  `render_fused_grid_plain` on 'hetvol' and 'hetvol_hg' (16x16 x 2 spp
  from sample 1, 32x32x16 grids): a film that is not a whole number of
  2048-lane blocks, so the buffer has n_q = 2048 rows a sample, of which
  the padding rows are never written and must never be read.
- film_sum's rules: a sample with one non-finite channel is dropped
  whole, samples are added in index order, and the wrapper
  `kernels.film_sum` takes the plain form for CPU tensors.

The tests run with one torch thread (`one_thread`).
"""

import numpy as np
import pytest
import torch

import lajolla_tpu_torch.integrators.volpath_grid_kernel as PGK
import lajolla_tpu_torch.integrators.volpath_kernel as PVK
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch import kernels
from lajolla_tpu_torch.scene.compile import compile_scene
from lajolla_tpu_torch.scene.types import RenderOptions

from torch_threads import one_thread  # noqa: F401

VOL = RenderOptions(integrator='volpath')
GRID = (32, 32, 16)
# a finite value no radiance reaches: a buffer row that keeps it and is
# read would show in the film
UNWRITTEN = 1e30


def shuffled_radiance(items_fn, items, seed):
    """items_fn over a numpy-shuffled copy of `items`, in three uneven
    batches; returns the radiance (N, 3) in the order of `items`."""
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        items.shape[0]))
    cuts = [0, items.shape[0] // 7, items.shape[0] // 2, items.shape[0]]
    rad = torch.empty((items.shape[0], 3))
    for a, b in zip(cuts[:-1], cuts[1:]):
        rad[perm[a:b]] = items_fn(items[perm[a:b]])
    return rad


def buffer_film(rad, rows, total, n, stride, nspp):
    """film_sum_plain of the per-item buffer whose rows `rows` hold `rad`
    and whose other rows hold UNWRITTEN."""
    buf = torch.full((total, 3), UNWRITTEN)
    buf[rows] = rad
    return PVK.film_sum_plain(buf, n, stride, nspp)


VOL_FIXTURES = {
    'vol': lambda: PT.make_cornell_box(24, 3, 'vol'),
    'vol_hg': lambda: PT.make_cornell_box(24, 3, 'vol_hg'),
    'submerged_sphere': lambda: compile_scene(
        PT.submerged_sphere_builder(24, 3)),
}


@pytest.mark.parametrize('fixture', list(VOL_FIXTURES))
def test_vol_items_in_any_order_sum_to_the_k8_film(fixture):
    scene = VOL_FIXTURES[fixture]()
    seed, s0, nspp = 3, 2, 3
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    want = PVK.render_fused_vol_plain(scene, VOL, seed, s0, nspp)
    items = torch.arange(s0 * n, (s0 + nspp) * n)
    rad = shuffled_radiance(
        lambda it: PVK.vol_items_plain(scene, VOL, seed, it), items, 11)
    film = buffer_film(rad, items - s0 * n, nspp * n, n, n, nspp)
    got = film.T.reshape(h, w, 3)
    assert want.abs().sum() > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize('variant', ['hetvol', 'hetvol_hg'])
def test_grid_items_in_any_order_sum_to_the_k9_film(variant):
    scene = PT.make_cornell_box(16, 2, variant, GRID)
    seed, s0, nspp = 5, 1, 2
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    n_q = PGK.padded_lanes(n)
    assert n_q == 2048 and n % 2048     # padding lanes in every sample
    want = PGK.render_fused_grid_plain(scene, VOL, seed, s0, nspp)
    rows = (torch.arange(nspp)[:, None] * n_q +
            torch.arange(n)[None]).reshape(-1)
    items = rows + s0 * n_q
    rad = shuffled_radiance(
        lambda it: PGK.grid_items_plain(scene, VOL, seed, it), items, 12)
    film = buffer_film(rad, rows, nspp * n_q, n, n_q, nspp)
    got = film.T.reshape(h, w, 3)
    assert want.abs().sum() > 0
    assert torch.equal(got, want)


def test_grid_items_of_padding_lanes_raise():
    scene = PT.make_cornell_box(16, 1, 'hetvol', GRID)
    with pytest.raises(ValueError, match='padding'):
        PGK.grid_items_plain(scene, VOL, 0, torch.tensor([3, 256]))


def test_film_sum_drops_a_sample_with_a_nonfinite_channel():
    nan, inf = float('nan'), float('inf')
    # n = 2 pixels, stride 3 (row 2 of each sample is padding), 3 samples
    buf = torch.tensor([[1.0, 2.0, 3.0], [nan, 5.0, 6.0], [nan, nan, nan],
                        [inf, 1.0, 1.0], [1.0, 1.0, 1.0], [7.0, 7.0, 7.0],
                        [0.5, 0.5, -inf], [2.0, 2.0, 2.0], [inf, inf, inf]])
    want = torch.tensor([[1.0, 3.0], [2.0, 3.0], [3.0, 3.0]])
    assert torch.equal(PVK.film_sum_plain(buf, 2, 3, 3), want)
    assert torch.equal(kernels.film_sum(buf, 2, 3, 3), want)


def test_film_sum_adds_samples_in_index_order():
    # float32 sums of these four samples depend on their order
    vals = np.array([1e8, 1.0, -1e8, 1.0], dtype=np.float32)
    buf = torch.from_numpy(np.repeat(vals, 3).reshape(4, 3))
    acc = np.float32(0.0)
    for v in vals:
        acc = np.float32(acc + v)
    rev = np.float32(0.0)
    for v in vals[::-1]:
        rev = np.float32(rev + v)
    assert acc != rev
    got = PVK.film_sum_plain(buf, 1, 1, 4)
    assert torch.equal(got, torch.full((3, 1), float(acc)))


def test_counters_need_the_cuda_kernels():
    vol = PT.make_cornell_box(8, 1, 'vol')
    het = PT.make_cornell_box(8, 1, 'hetvol', GRID)
    with pytest.raises(ValueError, match='CUDA'):
        PVK.render_fused_vol(vol, VOL, 0, 0, 1, counters={})
    with pytest.raises(ValueError, match='CUDA'):
        PGK.render_fused_grid(het, VOL, 0, 0, 1, counters={})
