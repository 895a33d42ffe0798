"""The one-thread rule (tests/torch_threads.py) holds for every port test
file: each imports the shared fixture and none sets torch's thread count
itself; the fixture gives a module one intra-op thread and restores the
count after it."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from torch_threads import one_thread  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
FILES = sorted(glob.glob(os.path.join(TESTS, 'test_torch_*.py')))


def _imports_one_thread(tree):
    return any(isinstance(node, ast.ImportFrom) and
               node.module == 'torch_threads' and
               [a.name for a in node.names] == ['one_thread']
               for node in tree.body)


def _sets_threads(tree):
    return [node.lineno for node in ast.walk(tree)
            if isinstance(node, ast.Attribute) and
            node.attr in ('set_num_threads', 'set_num_interop_threads')]


@pytest.mark.parametrize('path', FILES, ids=os.path.basename)
def test_file_takes_the_shared_fixture(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    assert _imports_one_thread(tree), \
        "import it: from torch_threads import one_thread  # noqa: F401"
    assert not _sets_threads(tree), \
        f"sets torch's thread count itself at lines {_sets_threads(tree)}"
    assert not any(isinstance(node, ast.FunctionDef) and
                   node.name == 'one_thread' for node in tree.body)


FIRST = """
import torch
torch.set_num_threads(3)
from torch_threads import one_thread  # noqa: F401


def test_inside():
    assert torch.get_num_threads() == 1
"""

SECOND = """
import torch


def test_after():
    assert torch.get_num_threads() == 3
"""


def test_fixture_sets_one_thread_and_restores(tmp_path):
    """Two modules in one process: the first, which takes the fixture,
    runs on one thread; the second, which does not, finds the count the
    first set before the fixture ran. Run without conftest, as the card's
    `--noconftest -m cuda` run is."""
    (tmp_path / 'test_a_first.py').write_text(FIRST)
    (tmp_path / 'test_b_second.py').write_text(SECOND)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [TESTS] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
    r = subprocess.run(
        [sys.executable, '-m', 'pytest', '-q', '--noconftest',
         '-p', 'no:cacheprovider', '-p', 'no:randomly', '-p', 'no:xdist',
         'test_a_first.py', 'test_b_second.py'],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert '2 passed' in r.stdout, r.stdout
