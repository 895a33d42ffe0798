"""A run on a machine with no GPU, or from a directory that holds only the
benchmark's files, exits non-zero and prints no result line: it never
falls back to the CPU."""

import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'cbox.final-512',
         '--seed', str(2 ** 31 + 7), '--seconds', '1', '--trace', '0'],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return proc.returncode != 0 and not (lines and lines[-1].startswith('{'))


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    proc = _run(harness.ROOT, env)
    assert _no_result(proc), proc.stdout
    assert 'torch.cuda.is_available() is False' in proc.stderr


@pytest.fixture
def bare_checkout(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    return tmp_path


def test_bare_directory_no_result(bare_checkout):
    proc = _run(bare_checkout, dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert _no_result(proc), proc.stdout
