"""A run on the CPU at a small size, past the harness's look for a GPU,
with the timed path sound and then broken underneath: `correct` comes out
true, and false for each fault a cell can have (a step that returns its
state unchanged, half of the batch left out and the mean taken over the
rest, an answer altered where it is produced, one block of the film, the
tail's or one drawn from the seed, rendered wrong) and for the control,
the reference in bfloat16 put in the program's place. Every workload of
BENCHMARK.json is run, at the small film its cell file gives (`small`:
width, height, spp). At a small film the check's blocks are cut to
SMALL_BLOCK pixels, so the film holds several and a tail; at each cell's
own film the comparison alone is held to a block rendered wrong."""

import dataclasses
import json
import os
import time

import numpy as np
import pytest

from benchmark import check, harness

SEED = 2 ** 31 + 99
with open(os.path.join(harness.ROOT, 'BENCHMARK.json')) as f:
    WORKLOADS = sorted(w['name'] for w in json.load(f)['workloads'])
SMALL_BLOCK = 64


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(check, 'BLOCK', SMALL_BLOCK)


def _spec(workload):
    spec = harness.load_cell(workload)
    spec['traffic'].update(spec['cell']['small'])
    spec['cell'].update(check_block_pixels=24, check_frames=2,
                        trace_frames=0, warm_seconds=0)
    return spec


def _run(workload, wrap=None):
    result, lines = harness.run_single(
        _spec(workload), SEED, 0.5, False, time.perf_counter(),
        device='cpu', render_wrap=wrap)
    assert [ln.split(':')[0] for ln in lines[-len(check.NUMBERS):]] == \
        [f'check {k}' for k in check.NUMBERS]
    assert list(result)[-1] == 'checks'
    return result


def state_unchanged(render):
    first = {}

    def frame(scene, options, device, seed):
        if 'img' not in first:
            first['img'] = render(scene, options, device=device, seed=seed)
        return first['img']
    return frame


def half_batch(render):
    def frame(scene, options, device, seed):
        spp = options.samples_per_pixel
        if spp >= 2:
            half = dataclasses.replace(options, samples_per_pixel=spp // 2)
            return render(scene, half, device=device, seed=seed)
        img = render(scene, options, device=device, seed=seed).copy()
        img[1::2] = img[0::2][:img[1::2].shape[0]]     # rows left out
        return img
    return frame


def answer_altered(render):
    def frame(scene, options, device, seed):
        img = render(scene, options, device=device, seed=seed).copy()
        img *= 1.01
        return img
    return frame


def block_wrong(which):
    """A fault: one block of the film, the tail block or one drawn from
    the seed, 1% off."""
    def wrap(render):
        def frame(scene, options, device, seed):
            img = render(scene, options, device=device, seed=seed).copy()
            flat = img.reshape(-1, 3)
            blocks = -(-flat.shape[0] // check.BLOCK)
            b = blocks - 1 if which == 'tail' else \
                int(np.random.default_rng(SEED).integers(blocks - 1))
            flat[b * check.BLOCK:(b + 1) * check.BLOCK] *= 1.01
            return img
        return frame
    return wrap


def control(workload):
    spec = _spec(workload)
    t, kind = spec['traffic'], spec['kind']
    ref = kind.build(spec['config'], t['width'], t['height'], device='cpu')
    pixels = np.arange(t['width'] * t['height'])

    def wrap(render):
        def frame(scene, options, device, seed):
            return check.reference_pixels(
                kind, ref, [seed], pixels, t['spp'], t['spp'],
                rounding=check.bf16_round)[0].reshape(t['height'],
                                                      t['width'], 3)
        return frame
    return wrap


@pytest.mark.parametrize('workload', WORKLOADS)
def test_sound_run_is_correct(workload):
    result = _run(workload)
    assert result['correct'] and result['failed'] == 0
    assert result['checks']['block_off']['value'] == 0.0


@pytest.mark.parametrize('fault', [state_unchanged, half_batch,
                                   answer_altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize('workload', WORKLOADS)
def test_fault_is_not_correct(workload, fault):
    assert not _run(workload, fault)['correct']


@pytest.mark.parametrize('which', ['tail', 'seeded'])
@pytest.mark.parametrize('workload', WORKLOADS)
def test_block_wrong_is_not_correct(workload, which):
    result = _run(workload, block_wrong(which))
    assert not result['correct']
    # every pixel of the block off but those that are black
    assert result['checks']['block_off']['value'] > 0.5


@pytest.mark.parametrize('workload', WORKLOADS)
def test_control_is_not_correct(workload):
    result = _run(workload, control(workload))
    assert not result['correct']


@pytest.mark.parametrize('which', ['tail', 'seeded', None])
@pytest.mark.parametrize('workload', WORKLOADS)
def test_block_wrong_at_the_cells_film(workload, which, monkeypatch):
    """At the cell's own film and pixels drawn as a run draws them, one
    block 1% off fails the cell's limits, and no block off passes."""
    monkeypatch.setattr(check, 'BLOCK', 4096)
    spec = harness.load_cell(workload)
    t, cell = spec['traffic'], spec['cell']
    n = t['width'] * t['height']
    pixels = check.sample_pixels(SEED, n, cell['check_block_pixels'])
    blocks = -(-n // check.BLOCK)
    assert np.array_equal(np.unique(pixels // check.BLOCK),
                          np.arange(blocks))
    rng = np.random.default_rng(SEED)
    want = rng.uniform(0.05, 2.0, (cell['check_frames'], len(pixels), 3))
    got = want.copy()
    if which is not None:
        b = blocks - 1 if which == 'tail' else int(rng.integers(blocks - 1))
        got[:, pixels // check.BLOCK == b] *= 1.01
    nums = check.compare(got, want, pixels)
    assert check.verdict(nums, cell['limits']) == (which is None)


@pytest.mark.parametrize('seconds', [0, 0.3])
def test_warm_up_comes_before_the_window(seconds):
    """One warm frame, and more until the cell's `warm_seconds` have
    passed, each with a seed of its own and all before the window's first
    frame; the set-up line counts them."""
    seeds = []

    def wrap(render):
        def frame(scene, options, device, seed):
            seeds.append(seed)
            return render(scene, options, device=device, seed=seed)
        return frame
    spec = _spec('cbox.preview-1080')
    spec['cell']['warm_seconds'] = seconds
    result, lines = harness.run_single(
        spec, SEED, 0.2, False, time.perf_counter(), device='cpu',
        render_wrap=wrap)
    warm = seeds.index(check.frame_seed(SEED, 0))
    assert seeds[:warm] == [check.frame_seed(SEED, -k)
                            for k in range(1, warm + 1)]
    assert (warm == 1) == (seconds == 0)
    assert f'warm-up ({warm} frames)' in lines[0]
    assert result['correct'] and result['attempted'] == len(seeds) - warm
