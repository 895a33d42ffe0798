"""The port's small host utilities: tools.rmse / rel_rmse against
lajolla_tpu's on seeded images, the rmse and topng commands, and
device_trace over torch.profiler on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import lajolla_tpu.tools as JTOOLS
from lajolla_tpu_torch import tools
from lajolla_tpu_torch.io.image import imwrite
from lajolla_tpu_torch.utils.profiling import device_trace

from torch_threads import one_thread  # noqa: F401


def _images(seed=0, shape=(24, 32, 3)):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    return a, (a + 0.05 * rng.normal(size=shape)).astype(np.float32)


def test_rmse_matches_jax_package():
    a, b = _images()
    assert tools.rmse(a, b) == JTOOLS.rmse(a, b)
    assert tools.rel_rmse(a, b) == JTOOLS.rel_rmse(a, b)
    assert tools.rmse(a, a) == 0.0
    assert tools.rel_rmse(a, np.zeros_like(a)) == JTOOLS.rel_rmse(
        a, np.zeros_like(a))


def test_rmse_command(tmp_path, capsys):
    a, b = _images(1)
    pa, pb = str(tmp_path / 'a.exr'), str(tmp_path / 'b.pfm')
    imwrite(pa, a)
    imwrite(pb, b)
    assert tools.main(['rmse', pa, pb]) == 0
    out = capsys.readouterr().out
    assert out.startswith('rmse=') and 'rel_rmse=' in out
    assert float(out.split()[0][5:]) == pytest.approx(tools.rmse(a, b),
                                                      abs=1e-6)
    pc = str(tmp_path / 'c.pfm')
    imwrite(pc, a[:8])
    assert tools.main(['rmse', pa, pc]) == 2


def test_topng_command(tmp_path):
    from PIL import Image
    a, _ = _images(2)
    src, dst = str(tmp_path / 'a.pfm'), str(tmp_path / 'a.png')
    imwrite(src, a)
    assert tools.main(['topng', src, dst, '--exposure', '2.0']) == 0
    im = np.asarray(Image.open(dst))
    assert im.shape == (24, 32, 3) and im.dtype == np.uint8
    want = (np.clip(a * 2.0, 0, 1) ** (1 / 2.2) * 255).astype(np.uint8)
    assert np.array_equal(im, want)


def test_device_trace_writes_a_trace(tmp_path):
    d = str(tmp_path / 'trace')
    with device_trace(d):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(d, 'trace.json')) as f:
        events = json.load(f)['traceEvents']
    assert any('mm' in e.get('name', '') for e in events)


def test_device_trace_lets_an_exception_through(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with device_trace(str(tmp_path / 'trace')):
            1 / 0
