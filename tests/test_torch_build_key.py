"""The build key of the port's CUDA libraries (kernels.unit_tag), with no
nvcc: each library's tag follows its own .cu, the csrc headers it
includes and its nvcc flags, and nothing else, so an edit rebuilds only
the libraries it reaches and a changed flag never reuses a stale one."""

import shutil

import pytest

from lajolla_tpu_torch import kernels

from torch_threads import one_thread  # noqa: F401

# The libraries that read each header, directly or through another.
READERS = {
    'path_advance.cuh': {'path_kernels', 'volpath_kernels',
                         'volpath_grid_kernels'},
    'camera.cuh': {'path_kernels', 'volpath_kernels', 'volpath_grid_kernels'},
    'volpath_common.cuh': {'volpath_kernels', 'volpath_grid_kernels'},
    'work_queue.cuh': {'path_kernels', 'volpath_kernels',
                       'volpath_grid_kernels'},
}


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that the build key reads instead of the package's."""
    copy = tmp_path / 'csrc'
    shutil.copytree(kernels._CSRC, copy)
    monkeypatch.setattr(kernels, '_CSRC', copy)
    return copy


def tags():
    return {u: kernels.unit_tag(u) for u in kernels._UNITS}


def changed(before):
    after = tags()
    return {u for u in before if after[u] != before[u]}


def test_every_source_belongs_to_a_unit():
    read = {f for u in kernels._UNITS for f in kernels.unit_files(u)}
    on_disk = {p.name for p in kernels._CSRC.iterdir()
               if p.suffix in ('.cu', '.cuh')}
    assert read == on_disk
    assert set(READERS) == {f for f in on_disk if f.endswith('.cuh')}


@pytest.mark.parametrize('unit', kernels._UNITS)
def test_an_edit_to_a_unit_changes_its_tag_alone(csrc, unit):
    before = tags()
    with open(csrc / f'{unit}.cu', 'a') as f:
        f.write('\n// edited\n')
    assert changed(before) == {unit}


@pytest.mark.parametrize('header', sorted(READERS))
def test_an_edit_to_a_header_changes_its_readers_tags(csrc, header):
    before = tags()
    with open(csrc / header, 'a') as f:
        f.write('\n// edited\n')
    assert changed(before) == READERS[header]


@pytest.mark.parametrize('unit', kernels._UNITS)
def test_a_unit_flag_changes_that_units_tag_alone(unit, monkeypatch):
    before = tags()
    flags = dict(kernels.UNIT_FLAGS)
    flags[unit] = flags.get(unit, ()) + ('-lineinfo',)
    monkeypatch.setattr(kernels, 'UNIT_FLAGS', flags)
    assert changed(before) == {unit}


def test_dropping_fmad_false_changes_the_grid_kernels_tag(monkeypatch):
    before = tags()
    monkeypatch.setattr(kernels, 'UNIT_FLAGS', {})
    assert changed(before) == {'volpath_grid_kernels'}


def test_a_common_flag_changes_every_tag(monkeypatch):
    before = tags()
    monkeypatch.setattr(kernels, 'NVCC_FLAGS',
                        tuple(f.replace('sm_90a', 'sm_90')
                              for f in kernels.NVCC_FLAGS))
    assert changed(before) == set(kernels._UNITS)


def test_build_log_reads_each_units_log_under_its_tag(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(kernels, 'BUILD_DIR', tmp_path)
    for unit in kernels._UNITS:
        (tmp_path / f'build_{unit}_{kernels.unit_tag(unit)}.log').write_text(
            f'{unit} ok\n')
    (tmp_path / 'build_sweep_kernels_0123456789abcdef.log').write_text(
        'stale\n')
    log = kernels.build_log()
    assert log.splitlines() == [f'{u} ok' for u in kernels._UNITS]
