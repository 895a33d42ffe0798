"""The port imports no JAX: its entry points load in a fresh interpreter
with no `jax` module, and nothing is built at import."""

import os
import subprocess
import sys

import pytest

from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('module', [
    'lajolla_tpu_torch',
    'lajolla_tpu_torch.cli',
    'lajolla_tpu_torch.testing',
    'lajolla_tpu_torch.bridge',
    'lajolla_tpu_torch.kernels',
    'lajolla_tpu_torch.materials',
    'lajolla_tpu_torch.tools',
    'lajolla_tpu_torch.utils.profiling',
    'lajolla_tpu_torch.core.random',
    'lajolla_tpu_torch.examples.inverse_rendering',
    'lajolla_tpu_torch.integrators.aux',
    'lajolla_tpu_torch.integrators.path',
    'lajolla_tpu_torch.integrators.diffpath',
    'lajolla_tpu_torch.integrators.media',
    'lajolla_tpu_torch.integrators.volpath',
    'lajolla_tpu_torch.integrators.volpath_kernel',
    'lajolla_tpu_torch.integrators.volpath_grid_kernel',
    'lajolla_tpu_torch.ops.bvh',
    'lajolla_tpu_torch.parallel.mesh',
    'lajolla_tpu_torch.parallel.spawn',
    'lajolla_tpu_torch.ops.intersect_binned',
    'lajolla_tpu_torch.ops.intersect_sweep',
    'lajolla_tpu_torch.scene.compile',
    'lajolla_tpu_torch.scene.geometry',
])
def test_import_pulls_in_no_jax(module, tmp_path):
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax')); "
            "assert not any(m.split('.')[0] == 'lajolla_tpu' "
            "for m in sys.modules)")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
