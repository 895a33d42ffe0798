"""A configuration's kind (benchmark/kinds) is the one place where the
harness learns how to write a scene and how to trace its reference. A kind
planted as a module, with a configuration, a traffic mix and a cell of its
own added as new files beside copies of the benchmark's data, is used by
load_cell, run_single and control.py's reference path with no file of the
harness edited; a program render that does not match the planted reference
reads `correct` false. An unknown kind is a BenchError."""

import copy
import json
import os
import shutil
import sys
import time
import types

import pytest

from benchmark import check, control, harness, kinds
from benchmark.kinds import path_diffuse

SEED = 2 ** 31 + 123
KIND = 'planted_dim_white'
WORKLOAD = 'planted.small'
DIM = [0.5, 0.5, 0.5]


def _rgb(v):
    return ', '.join(repr(float(c)) for c in v)


def _dimmed(config):
    """The Cornell box with its white material dimmed: the planted kind's
    scene."""
    out = copy.deepcopy(config)
    out['materials']['white']['reflectance'] = DIM
    return out


def planted_kind(calls, writes_its_scene=True):
    """A kind module that writes the dimmed box (or, where
    `writes_its_scene` is false, the configuration as it is: a program
    that renders another scene than the reference traces) and gives the
    dimmed box's reference; each call is recorded in `calls`."""
    mod = types.ModuleType(f'benchmark.kinds.{KIND}')

    def write_scene(directory, config, width, height, spp):
        calls.append('write_scene')
        scene = _dimmed(config) if writes_its_scene else config
        path = path_diffuse.write_scene(directory, scene, width, height, spp)
        with open(path) as f:
            calls.append(f.read())
        return path

    def build(config, width, height, device):
        calls.append('build')
        return path_diffuse.build(_dimmed(config), width, height,
                                  device=device)

    def film_pixels(ref, seed, pixels, spp, chunk, rounding=None,
                    stats=None):
        calls.append('film_pixels')
        return path_diffuse.film_pixels(ref, seed, pixels, spp, chunk,
                                        rounding, stats)

    def rounded(ref, rounding):
        calls.append('rounded')
        return path_diffuse.rounded(ref, rounding)
    mod.write_scene, mod.build = write_scene, build
    mod.film_pixels, mod.rounded = film_pixels, rounded
    return mod


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    """A copy of the benchmark's data with the planted configuration, its
    traffic mix and its cell added as new files and BENCHMARK.json
    entries; the harness reads it in place of the repository's."""
    here = tmp_path / 'benchmark'
    for d in ('configs', 'traffic', 'cells', 'metrics'):
        shutil.copytree(os.path.join(harness.HERE, d), here / d,
                        ignore=shutil.ignore_patterns('*.py', '__pycache__'))
    with open(os.path.join(harness.HERE, 'configs', 'cbox.json')) as f:
        cfg = json.load(f)
    cfg.update(name='planted', kind=KIND)
    (here / 'configs' / 'planted.json').write_text(json.dumps(cfg))
    (here / 'traffic' / 'planted-small.json').write_text(
        json.dumps(dict(width=16, height=12, spp=4)))
    (here / 'cells' / f'{WORKLOAD}.json').write_text(json.dumps(dict(
        check_frames=2, check_block_pixels=24, check_chunk=4,
        trace_frames=0, small=dict(width=16, height=12, spp=4),
        limits=dict(block_off=0.25, median_rel=1e-4, mean_gap=1e-3))))
    with open(os.path.join(harness.ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    bench['configs'].append(dict(
        name='planted', source='a planted test kind',
        file='benchmark/configs/planted.json', reduced=[], why='tests'))
    bench['workloads'].append(dict(
        name=WORKLOAD, config='planted', traffic='planted-small', chips=1,
        why='tests'))
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    monkeypatch.setattr(harness, 'ROOT', str(tmp_path))
    monkeypatch.setattr(harness, 'HERE', str(here))
    return tmp_path


def _plant(monkeypatch, **kw):
    calls = []
    mod = planted_kind(calls, **kw)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod, calls


def test_planted_kind_is_used_by_a_run(checkout, monkeypatch):
    mod, calls = _plant(monkeypatch)
    spec = harness.load_cell(WORKLOAD)
    assert spec['kind'] is mod
    result, _ = harness.run_single(spec, SEED, 0.3, False,
                                   time.perf_counter(), device='cpu')
    assert [c for c in calls if c in ('write_scene', 'build')] == \
        ['write_scene', 'build']
    assert 'film_pixels' in calls
    assert _rgb(DIM) in calls[1] and _rgb([0.73] * 3) not in calls[1]
    assert result['correct'] and result['failed'] == 0
    assert result['checks']['block_off']['value'] == 0.0


def test_render_of_another_scene_is_not_correct(checkout, monkeypatch):
    """The program renders the box as configured, the planted reference
    traces the dimmed one: `correct` false."""
    mod, calls = _plant(monkeypatch, writes_its_scene=False)
    spec = harness.load_cell(WORKLOAD)
    result, _ = harness.run_single(spec, SEED, 0.3, False,
                                   time.perf_counter(), device='cpu')
    assert 'film_pixels' in calls
    assert not result['correct']
    assert result['checks']['block_off']['value'] > 0.5


def test_control_reads_through_the_planted_kind(checkout, monkeypatch,
                                                tmp_path):
    mod, calls = _plant(monkeypatch)
    out = tmp_path / 'readings.json'
    control.main(['--workload', WORKLOAD, '--seeds', str(SEED),
                  '--control-seeds', str(SEED), '--device', 'cpu',
                  '--out', str(out)])
    assert {'write_scene', 'build', 'film_pixels', 'rounded'} <= set(calls)
    readings = json.loads(out.read_text())
    limits = harness.load_cell(WORKLOAD)['cell']['limits']
    program, = readings['program'].values()
    low, = readings['control'].values()
    assert check.verdict(program, limits) and program['median_rel'] == 0.0
    assert not check.verdict(low, limits)


@pytest.mark.parametrize('kind', ['no_such_kind', None, '../scenes'])
def test_unknown_kind_is_a_bench_error(kind):
    with pytest.raises(harness.BenchError) as err:
        kinds.load(dict(name='x', kind=kind))
    assert repr(kind) in str(err.value)
    assert f'benchmark.kinds.{kind}' in str(err.value)


def test_cell_of_unknown_kind_does_not_load(checkout):
    path = checkout / 'benchmark' / 'configs' / 'planted.json'
    cfg = json.loads(path.read_text())
    cfg['kind'] = 'no_such_kind'
    path.write_text(json.dumps(cfg))
    with pytest.raises(harness.BenchError, match='no_such_kind'):
        harness.load_cell(WORKLOAD)
