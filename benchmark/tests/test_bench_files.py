"""Every configuration, traffic mix, cell and metric that BENCHMARK.json
names loads by name, and the files agree with each other."""

import json
import os

import pytest

from benchmark import check, harness, kinds

with open(os.path.join(harness.ROOT, 'BENCHMARK.json')) as f:
    BENCH = json.load(f)
WORKLOADS = [w['name'] for w in BENCH['workloads']]
METRICS = [m['name'] for m in BENCH['per_layer']]


@pytest.mark.parametrize('workload', WORKLOADS)
def test_cell_loads(workload):
    spec = harness.load_cell(workload)
    assert spec['config']['name'] == spec['workload']['config']
    assert set(spec['traffic']) == {'width', 'height', 'spp'}
    assert set(spec['cell']['limits']) == set(check.NUMBERS)
    assert set(spec['cell']['small']) == {'width', 'height', 'spp'}
    assert spec['cell'].get('warm_seconds', 0) >= 0
    assert spec['kind'] is kinds.load(spec['config'])
    assert spec['workload']['chips'] == 1
    names = {m['name'] for m in spec['end_to_end']}
    assert 'setup_s' in names and len(names) >= 2
    assert spec['per_layer'], "every cell reports a per-layer metric"


@pytest.mark.parametrize('name', METRICS)
def test_metric_reader_loads(name):
    mod = harness.metric_reader(name)
    with open(os.path.join(harness.HERE, 'metrics', f'{name}.json')) as f:
        data = json.load(f)
    assert data['name'] == name and callable(mod.read)


@pytest.mark.parametrize('config', BENCH['configs'], ids=lambda c: c['name'])
def test_config_file(config):
    with open(os.path.join(harness.ROOT, config['file'])) as f:
        cfg = json.load(f)
    assert cfg['name'] == config['name'] and cfg['assumed']
    assert set(config['reduced']) <= set(cfg)
    kind = kinds.load(cfg)
    assert kind.__name__ == f"benchmark.kinds.{cfg['kind']}"
    for fn in ('write_scene', 'build', 'film_pixels', 'rounded'):
        assert callable(getattr(kind, fn)), fn
    if cfg['kind'] == 'path_diffuse':
        assert config['reduced'] == []
        assert cfg['integrator'] == 'path'
        assert {m['type'] for m in cfg['materials'].values()} == {'diffuse'}
        assert sum('emitter' in s for s in cfg['shapes']) == 1


def test_contract_shape():
    assert BENCH['command'] == ['python3', 'benchmark/run.py']
    assert BENCH['paths'] == ['benchmark']
    chips4 = sum(w['chips'] == 4 for w in BENCH['workloads'])
    assert chips4 <= max(1, len(BENCH['workloads']) // 4)
    for m in BENCH['per_layer']:
        moves = {e['name']: e for e in BENCH['end_to_end']}[m['moves']]
        for w in m.get('workloads', []):
            assert w in moves.get('workloads', WORKLOADS)
    for w in WORKLOADS:
        spec = harness.load_cell(w)
        reported = {m['name'] for m in spec['end_to_end']}
        assert all(m['moves'] in reported for m in spec['per_layer'])
