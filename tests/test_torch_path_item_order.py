"""The property that kernel K1 rests on, on the CPU: a path's radiance is
a function of its work item alone (every draw is a counter-hash cell of
the item), so the radiance of any list of items, in any order and any
grouping into lanes, summed per pixel in sample order by film_sum_kernel's
plain form, is the film of K1's plain form bit for bit. The CUDA kernel
takes items from a device counter in persistent warps and relies on
exactly this.

`path_megakernel.path_items_plain` over a numpy-shuffled list of a film's
items, in three uneven batches, scattered to the (nspp*n, 3) per-item
buffer and summed by `film_sum_plain`, equals `render_fused_plain`
(torch.equal) on the Cornell box, the Cornell box without merged quads,
and the sphere-light scene (24x24 x 3 spp from sample 2), and on the
Cornell box at 72x60 (4,320 pixels: more than one 4096-pixel block and
not a whole number of them, which render() sends to K1 too; its partial
block's pixels included). The tests run with one torch thread
(`one_thread`).

K1's wrapper splits a launch whose per-item buffer would pass
kernels.PATH_BUFFER_BYTES into launches of whole samples
(`kernels.sample_chunks`), each film sum added onto the last: the chunks
cover the samples in order within the cap, and `film_sum` added onto a
film chunk by chunk is the whole sum bit for bit.
"""

import numpy as np
import pytest
import torch

import lajolla_tpu_torch.integrators.path_megakernel as PMK
import lajolla_tpu_torch.integrators.volpath_kernel as PVK
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch import kernels
from lajolla_tpu_torch.scene import compile as PC
from lajolla_tpu_torch.scene.types import RenderOptions

from torch_threads import one_thread  # noqa: F401


def no_quads(res):
    PC.MERGE_QUADS = False
    try:
        return PT.make_cornell_box(res)
    finally:
        PC.MERGE_QUADS = True


FIXTURES = {
    'cornell_box': lambda: PT.make_cornell_box(24),
    'cornell_box_no_quads': lambda: no_quads(24),
    'sphere_lights': lambda: PT.make_sphere_light_scene(24),
    'cornell_box_ragged': lambda: PT.make_cornell_box((72, 60)),
}


@pytest.mark.parametrize('fixture', list(FIXTURES))
def test_path_items_in_any_order_sum_to_the_k1_film(fixture):
    scene = FIXTURES[fixture]()
    options = RenderOptions()
    seed, s0, nspp = 3, 2, 3
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    want = PMK.render_fused_plain(scene, options, seed, s0, nspp)
    items = torch.arange(s0 * n, (s0 + nspp) * n)
    perm = torch.from_numpy(np.random.default_rng(13).permutation(
        items.shape[0]))
    cuts = [0, items.shape[0] // 7, items.shape[0] // 2, items.shape[0]]
    buf = torch.full((nspp * n, 3), 1e30)    # a row left unwritten shows
    for a, b in zip(cuts[:-1], cuts[1:]):
        rows = perm[a:b]
        buf[rows] = PMK.path_items_plain(scene, options, seed, items[rows])
    got = PVK.film_sum_plain(buf, n, n, nspp).T.reshape(h, w, 3)
    assert want.abs().sum() > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize('nspp, w, h', [(256, 512, 512), (256, 3840, 2160),
                                        (2, 16384, 8192)])
def test_sample_chunks_cover_the_samples_within_the_cap(nspp, w, h):
    n = w * h
    chunks = kernels.sample_chunks(nspp, n)
    assert [k for k, _ in chunks] == list(
        np.cumsum([0] + [m for _, m in chunks[:-1]]))
    assert sum(m for _, m in chunks) == nspp
    assert all(m >= 1 for _, m in chunks)
    if 12 * n <= kernels.PATH_BUFFER_BYTES:
        assert all(12 * n * m <= kernels.PATH_BUFFER_BYTES for _, m in chunks)
        # as few launches as the cap allows
        step = min(nspp, kernels.PATH_BUFFER_BYTES // (12 * n))
        assert len(chunks) == -(-nspp // step)
    else:                                  # one sample passes the cap
        assert all(m == 1 for _, m in chunks)
    if (w, h) == (512, 512):
        assert chunks == [(0, 256)]       # the main path's one launch


def test_film_sum_onto_a_film_chunk_by_chunk_is_the_whole_sum():
    """film_sum of a (nspp*n, 3) buffer, and film_sum of its sample chunks
    (5, 1, 4, 6 samples), each added onto the film of the last in place:
    equal bit for bit, with float32 sums that depend on their order and a
    non-finite channel in every 13th item."""
    n, nspp = 40, 16
    rng = np.random.default_rng(5)
    vals = (rng.standard_normal((nspp * n, 3)) *
            10.0 ** rng.integers(-3, 8, (nspp * n, 1))).astype(np.float32)
    vals[::13, 1] = np.nan
    vals[5::13, 2] = np.inf
    buf = torch.from_numpy(vals)
    want = kernels.film_sum(buf, n, n, nspp)
    film, k = None, 0
    for m in (5, 1, 4, 6):
        chunk = buf[k * n:(k + m) * n]
        got = kernels.film_sum(chunk, n, n, m, film)
        assert film is None or got is film
        film, k = got, k + m
    assert torch.isfinite(want).all()
    assert torch.equal(film, want)
