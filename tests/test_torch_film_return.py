"""The film's return to the host (lajolla_tpu_torch/utils/film_return.py).

On the CPU: the pool's bookkeeping, its blocks ordinary tensors (a held
frame is never written, a released block is reused, a third held frame
takes the pageable copy, a block takes the film's strides, a new shape
drops the blocks) and the CPU device's quotient, numpy's. Marked `cuda`
(skipped without a GPU; on the card:
`python3 -m pytest --noconftest -m cuda tests/test_torch_film_return.py`):
the quotient bit for bit against `film.cpu().numpy() / spp`, render()
through K1 and K8 against the film sums' numpy quotient, and the device
memory a return adds."""

import numpy as np
import pytest
import torch

from lajolla_tpu_torch import kernels, render
from lajolla_tpu_torch import testing as PT
from lajolla_tpu_torch.integrators import path as PP
from lajolla_tpu_torch.integrators import volpath as PV
from lajolla_tpu_torch.scene.types import RenderOptions
from lajolla_tpu_torch.utils import film_return as FR

from torch_threads import one_thread  # noqa: F401

SPPS = [1, 3, 7, 100, 256]


def _pool():
    """A pool of ordinary tensors, and the list of blocks it made."""
    made = []

    def alloc(shape, stride, dtype):
        made.append(torch.empty_strided(shape, stride, dtype=dtype))
        return made[-1]
    return FR.FilmPool(alloc), made


def _film(seed, shape=(6, 5, 3)):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) * 100


def _counts():
    return dict(FR.FILM_RETURNS)


def _added(before):
    return {k: v - before[k] for k, v in FR.FILM_RETURNS.items()}


def test_held_frame_unchanged_after_two_more_returns():
    pool, made = _pool()
    first = pool.return_film(_film(1), 3)
    want = _film(1).numpy() / 3
    view = first[2:, ::2]
    second = pool.return_film(_film(2), 3)
    del first
    third = pool.return_film(_film(3), 3)
    assert np.array_equal(view, want[2:, ::2])
    assert np.array_equal(second, _film(2).numpy() / 3)
    assert np.array_equal(third, _film(3).numpy() / 3)
    assert len(made) == 2


def test_released_block_is_reused_and_counted():
    pool, made = _pool()
    before = _counts()
    first = pool.return_film(_film(1), 7)
    ptr = first.ctypes.data
    assert ptr == made[0].data_ptr()
    del first
    again = pool.return_film(_film(2), 7)
    assert again.ctypes.data == ptr and len(made) == 1
    assert np.array_equal(again, _film(2).numpy() / 7)
    assert _added(before) == {'pinned': 2, 'pageable': 0}


def test_third_held_frame_takes_the_pageable_copy():
    pool, made = _pool()
    before = _counts()
    held = [pool.return_film(_film(k), 100) for k in range(3)]
    assert len(made) == 2
    assert _added(before) == {'pinned': 2, 'pageable': 1}
    assert held[2].ctypes.data not in {t.data_ptr() for t in made}
    for k, img in enumerate(held):
        assert np.array_equal(img, _film(k).numpy() / 100)
    # a frame held as a tensor over its ndarray keeps its block too
    kept = torch.from_numpy(held[0])
    del held[:2]
    again = pool.return_film(_film(5), 100)
    assert again.ctypes.data == made[1].data_ptr()
    assert np.array_equal(kept.numpy(), _film(0).numpy() / 100)


def test_a_film_seen_through_a_transpose_takes_a_block_of_its_strides():
    """K1's and K8's films: their (3, n) sums seen as (h, w, 3)."""
    pool, made = _pool()
    before = _counts()
    film = _film(4, (3, 30)).T.reshape(6, 5, 3)
    assert not film.is_contiguous()
    want = film.numpy() / 3
    got = pool.return_film(film, 3)
    assert np.array_equal(got, want) and got.strides == want.strides
    assert made[0].stride() == film.stride()
    assert _added(before) == {'pinned': 1, 'pageable': 0}


def test_a_film_with_gaps_takes_the_pageable_copy():
    pool, made = _pool()
    before = _counts()
    film = _film(4, (6, 10, 3))[:, ::2]
    want = film.numpy() / 3
    assert np.array_equal(pool.return_film(film, 3), want)
    assert made == [] and _added(before) == {'pinned': 0, 'pageable': 1}


def test_a_new_shape_drops_the_old_blocks():
    pool, made = _pool()
    small = pool.return_film(_film(1), 3)
    pool.return_film(_film(2), 3)
    assert len(made) == 2 and len(pool.blocks) == 2
    big = pool.return_film(_film(3, (8, 5, 3)), 3)
    assert len(made) == 3 and len(pool.blocks) == 1
    assert pool.blocks[0][0] is made[2] and big.shape == (8, 5, 3)
    assert np.array_equal(small, _film(1).numpy() / 3)


@pytest.mark.parametrize('spp', SPPS)
def test_cpu_device_keeps_numpy_quotient(spp):
    film = _film(spp)
    film[0, 0] = torch.tensor([0.0, float('inf'), float('nan')])
    film[0, 1] = torch.tensor([-0.0, -float('inf'), 1e-44])
    copy = film.clone()
    before = _counts()
    got = FR.return_film(film, spp)
    want = copy.numpy() / spp
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert torch.equal(film.view(torch.int32), copy.view(torch.int32))
    assert _added(before) == {'pinned': 0, 'pageable': 0}


# On the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device('cuda')


def _special_film(seed, shape=(96, 128, 3)):
    """Random magnitudes over the whole float32 range, with subnormals,
    zeros of both signs, infinities and NaN."""
    g = np.random.default_rng(seed)
    bits = g.integers(0, 2 ** 32, size=shape, dtype=np.uint64)
    film = bits.astype(np.uint32).view(np.float32).copy()
    flat = film.reshape(-1)
    flat[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -3e-39, 1.17e-38]
    flat[8:64] = g.uniform(0, 4, 56).astype(np.float32)
    return film


def _same(got, want):
    """Bit for bit, where NaN is only NaN: the card's NaN is its own
    canonical one."""
    nan = np.isnan(want)
    return (got.dtype == want.dtype and np.array_equal(np.isnan(got), nan)
            and np.array_equal(got.view(np.uint32)[~nan],
                               want.view(np.uint32)[~nan]))


@pytest.mark.cuda
@pytest.mark.parametrize('spp', SPPS)
def test_cuda_quotient_bit_for_bit(cuda, spp):
    host = _special_film(spp)
    film = torch.from_numpy(host).to(cuda)
    want = film.cpu().numpy() / spp
    before = _counts()
    got = FR.return_film(film, spp)
    assert _added(before) == {'pinned': 1, 'pageable': 0}
    assert _same(got, want)


@pytest.mark.cuda
def test_cuda_render_through_k1_bit_for_bit(cuda):
    scene, spp, seed = PT.make_cornell_box((128, 96), 3), 3, 2 ** 31 + 7
    opt = RenderOptions(samples_per_pixel=spp)
    before, routes = dict(kernels.LAUNCHES), _counts()
    img = render(scene, opt, device=cuda, seed=seed)
    assert kernels.LAUNCHES['render_fused'] == before['render_fused'] + 1
    assert _added(routes) == {'pinned': 1, 'pageable': 0}
    film = PP.render_path_samples(scene.to(cuda), opt, seed, 0, spp)
    want = film.cpu().numpy() / spp
    assert _same(img, want) and img.strides == want.strides


@pytest.mark.cuda
def test_cuda_render_through_k8_bit_for_bit(cuda):
    scene, spp, seed = PT.make_cornell_box(64, 2, 'vol'), 2, 2 ** 31 + 9
    opt = RenderOptions(integrator='volpath', samples_per_pixel=spp)
    before, routes = dict(kernels.LAUNCHES), _counts()
    img = render(scene, opt, device=cuda, seed=seed)
    assert kernels.LAUNCHES['render_fused_vol'] == \
        before['render_fused_vol'] + 1
    assert _added(routes) == {'pinned': 1, 'pageable': 0}
    film = PV.render_volpath_samples(scene.to(cuda), opt, seed, 0, spp)
    want = film.cpu().numpy() / spp
    assert _same(img, want) and img.strides == want.strides


@pytest.mark.cuda
@pytest.mark.parametrize('spp', [5, 6])
def test_cuda_return_adds_at_most_the_divisor(cuda, spp):
    film = torch.rand((1080, 1920, 3), device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.max_memory_allocated(cuda)
    FR.return_film(film, spp)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) - base <= 512
