"""Nothing the benchmark runs imports JAX or the JAX package: top-level
module names are compared whole (lajolla_tpu_torch begins with
lajolla_tpu and is the program)."""

import subprocess
import sys
import types

from benchmark import harness

IMPORTS = """
import sys
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.harness, benchmark.check
import benchmark.control, benchmark.scenes, benchmark.stats, benchmark.trace
import benchmark.reference.items, benchmark.reference.tables
import benchmark.kinds, benchmark.metrics
for name in {metrics!r}:
    benchmark.harness.metric_reader(name)
for name in {kinds!r}:
    __import__('benchmark.kinds.' + name)
import lajolla_tpu_torch
from lajolla_tpu_torch import kernels, render
from lajolla_tpu_torch.scene import parser, compile
from lajolla_tpu_torch.integrators import path, path_megakernel
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def test_no_jax_in_what_a_run_imports():
    import json
    import os
    with open(os.path.join(harness.ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    metrics = [m['name'] for m in bench['per_layer']]
    kinds = []
    for c in bench['configs']:
        with open(os.path.join(harness.ROOT, c['file'])) as f:
            kinds.append(json.load(f)['kind'])
    out = subprocess.run(
        [sys.executable, '-c', IMPORTS.format(root=harness.ROOT,
                                              metrics=metrics,
                                              kinds=kinds)],
        capture_output=True, text=True, timeout=300, check=True,
        env={k: v for k, v in os.environ.items()
             if k not in ('JAX_PLATFORMS',)})
    names = set(eval(out.stdout.strip().splitlines()[-1]))  # noqa: S307
    assert 'lajolla_tpu_torch' in names
    assert not names & {'jax', 'jaxlib', 'flax', 'lajolla_tpu'}


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, 'lajolla_tpu_torch_extra',
                        types.ModuleType('lajolla_tpu_torch_extra'))
    assert 'lajolla_tpu' not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'lajolla_tpu.render',
                        types.ModuleType('lajolla_tpu.render'))
    assert 'lajolla_tpu' in harness.forbidden_modules()
