"""chip_smoke.py without a card: its ptxas summary books each kernel's
registers and spills under that kernel's own name, and the script exits
non-zero, printing no result, where torch.cuda.is_available() is False."""

import importlib.util
import os
import subprocess
import sys

import pytest

from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# An abridged nvcc -Xptxas -v log of five libraries, eleven kernels, two
# instantiations of two of them.
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119render_fused_kernelILi1ELb0ELb0EEEvN2lj6TablesENS0_6CameraEiijxxPyPfS3_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119render_fused_kernelILi1ELb0ELb0EEEvN2lj6TablesENS0_6CameraEiijxxPyPfS3_
    8 bytes stack frame, 44 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 80 registers, used 0 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114advance_kernelILi3ELb1ELb1EEEvN2lj6TablesEiPKfS4_S4_S4_S4_S4_S4_S4_PKbPfS7_S7_S7_S7_Pb' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114advance_kernelILi3ELb1ELb1EEEvN2lj6TablesEiPKfS4_S4_S4_S4_S4_S4_S4_PKbPfS7_S7_S7_S7_Pb
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114advance_kernelILi1ELb0ELb0EEEvN2lj6TablesEiPKfS4_S4_S4_S4_S4_S4_S4_PKbPfS7_S7_S7_S7_Pb' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114advance_kernelILi1ELb0ELb0EEEvN2lj6TablesEiPKfS4_S4_S4_S4_S4_S4_S4_PKbPfS7_S7_S7_S7_Pb
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 60 registers, used 0 barriers
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122intersect_brute_kernelEPKfS1_PKiS3_iiS1_S1_S1_S1_PfPiS4_S4_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122intersect_brute_kernelEPKfS1_PKiS3_iiS1_S1_S1_S1_PfPiS4_S4_
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 29 registers, used 1 barriers, 9984 bytes smem
ptxas info    : Compiling entry function 'plain_c_kernel' for 'sm_90a'
ptxas info    : Used 12 registers, used 0 barriers
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123render_fused_vol_kernelILi3ELb1ELb1ELb1EEEvN2lj6TablesENS1_6CameraENS1_6MediumENS1_8VolSaltsEiijxiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123render_fused_vol_kernelILi3ELb1ELb1ELb1EEEvN2lj6TablesENS1_6CameraENS1_6MediumENS1_8VolSaltsEiijxiPf
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115film_sum_kernelEPKfixiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115film_sum_kernelEPKfixiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 22 registers, used 0 barriers
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124render_fused_grid_kernelILi3ELb1ELb0ELb1EEEvN2lj6TablesENS1_6CameraENS1_10GridMediumENS1_8VolSaltsEPKfS9_ixjxiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124render_fused_grid_kernelILi3ELb1ELb0ELb1EEEvN2lj6TablesENS1_6CameraENS1_10GridMediumENS1_8VolSaltsEPKfS9_ixjxiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 4096 bytes smem
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121sweep_resident_kernelILb0EEEvPKfS2_S2_PKiS4_S2_iiiPfPi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121sweep_resident_kernelILb0EEEvPKfS2_S2_PKiS4_S2_iiiPfPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121sweep_resident_kernelILb1EEEvPKfS2_S2_PKiS4_S2_iiiPfPi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121sweep_resident_kernelILb1EEEvPKfS2_S2_PKiS4_S2_iiiPfPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120sweep_resolve_kernelEPKfPKiS1_iiPiPfS5_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120sweep_resolve_kernelEPKfPKiS1_iiPiPfS5_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117sweep_list_kernelILb0EEEvPKfS2_S2_PKiS4_S2_iiPfPiS5_S5_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117sweep_list_kernelILb0EEEvPKfS2_S2_PKiS4_S2_iiPfPiS5_S5_
    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122sweep_streaming_kernelILb0EEEvPKfS2_S2_S2_S2_iiiiPfPiS3_S3_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122sweep_streaming_kernelILb0EEEvPKfS2_S2_S2_S2_iiiiPfPiS3_S3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers
"""


def test_ptxas_summary_keys_each_kernel():
    summary = _chip_smoke().ptxas_summary(PTXAS_LOG)
    assert summary == (
        "advance_kernel: <= 72 registers, <= 0 B spill stores; "
        "film_sum_kernel: <= 22 registers, <= 0 B spill stores; "
        "intersect_brute_kernel: <= 29 registers, <= 4 B spill stores; "
        "plain_c_kernel: <= 12 registers, <= 0 B spill stores; "
        "render_fused_grid_kernel: <= 128 registers, <= 0 B spill stores; "
        "render_fused_kernel: <= 80 registers, <= 44 B spill stores; "
        "render_fused_vol_kernel: <= 96 registers, <= 8 B spill stores; "
        "sweep_list_kernel: <= 40 registers, <= 12 B spill stores; "
        "sweep_resident_kernel: <= 48 registers, <= 0 B spill stores; "
        "sweep_resolve_kernel: <= 40 registers, <= 0 B spill stores; "
        "sweep_streaming_kernel: <= 48 registers, <= 0 B spill stores")


@pytest.mark.parametrize('symbol,name', [
    ('_ZN12_GLOBAL__N_121occluded_brute_kernelEPKfS1_iiS1_S1_S1_S1_Pb',
     'occluded_brute_kernel'),
    ('_ZN12_GLOBAL__N_123render_fused_vol_kernelILi1ELb0ELb0ELb0EEEvN2lj6'
     'TablesENS1_6CameraENS1_6MediumENS1_8VolSaltsEiijxiPf',
     'render_fused_vol_kernel'),
    ('_ZN12_GLOBAL__N_124render_fused_grid_kernelILi1ELb0ELb0ELb0EEEvN2lj6'
     'TablesENS1_6CameraENS1_10GridMediumENS1_8VolSaltsEPKfS9_ixjxiPf',
     'render_fused_grid_kernel'),
    ('_ZN12_GLOBAL__N_121sweep_resident_kernelILb1EEEvPKfS2_S2_PKiS4_S2_'
     'iiiPfPi', 'sweep_resident_kernel'),
    ('_ZN12_GLOBAL__N_120sweep_resolve_kernelEPKfPKiS1_iiPiPfS5_',
     'sweep_resolve_kernel'),
    ('_ZN12_GLOBAL__N_117sweep_list_kernelILb0EEEvPKfS2_S2_PKiS4_S2_iiPfPi'
     'S5_S5_', 'sweep_list_kernel'),
    ('_ZN12_GLOBAL__N_122sweep_streaming_kernelILb1EEEvPKfS2_S2_S2_S2_iiii'
     'PfPiS3_S3_', 'sweep_streaming_kernel'),
    ('_ZN12_GLOBAL__N_115film_sum_kernelEPKfixiPf', 'film_sum_kernel'),
    ('_Z13simple_kernelPf', 'simple_kernel'),
    ('lj_unmangled', 'lj_unmangled')])
def test_kernel_name_demangles(symbol, name):
    assert _chip_smoke().kernel_name(symbol) == name


@pytest.mark.parametrize('wrapper,body', [
    ('sweep_resolve', '_kernel_resolve'), ('sweep_resident', '_kernel_res'),
    ('sweep_list', '_kernel_lane'), ('sweep_streaming', '_kernel')])
def test_sweep_entries_name_their_tpu_kernels(wrapper, body):
    """The `kernels` line's entries for K4-K7: each `replaces` points at
    the `def` of its Pallas kernel body, each wrapper has its launch
    counter, and the CUDA source holds an entry point of that name."""
    from lajolla_tpu_torch import kernels
    mod = _chip_smoke()
    path, line = mod.SWEEP_REPLACES[wrapper].split(':')
    with open(os.path.join(REPO, path)) as f:
        text = f.readlines()[int(line) - 1]
    assert text.startswith(f'def {body}('), text
    assert kernels.LAUNCHES[wrapper] == 0
    with open(os.path.join(REPO, mod.SWEEP_SOURCE)) as f:
        source = f.read()
    assert f'\n{wrapper}_kernel(' in source
    assert f'int lj_{wrapper}(' in source


def test_film_sum_entry_names_the_film_add_it_replaces():
    """The `kernels` line's film_sum entry: `replaces` points at the film
    add of K8's Pallas kernel, the wrapper has its launch counter, and
    the CUDA source holds the kernel and its C entry."""
    from lajolla_tpu_torch import kernels
    mod = _chip_smoke()
    path, line = mod.FILM_SUM_REPLACES.split(':')
    with open(os.path.join(REPO, path)) as f:
        text = f.readlines()[int(line) - 1]
    assert 'film = film + jnp.where(died & fin' in text, text
    assert kernels.LAUNCHES['film_sum'] == 0
    with open(os.path.join(REPO, mod.K8_SOURCE)) as f:
        source = f.read()
    assert '\nfilm_sum_kernel(' in source
    assert 'int lj_film_sum(' in source


def test_exits_nonzero_without_a_gpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES='')
    r = subprocess.run([sys.executable, os.path.join(REPO, 'chip_smoke.py')],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_kernel_lines_name_launch_counters():
    """Every entry of the `kernels` line is booked by its kernel's name
    less `_kernel`: that name keys kernels.LAUNCHES, from which the
    entry takes its `sharded_launches` ([20])."""
    import re
    from lajolla_tpu_torch import kernels
    with open(os.path.join(REPO, 'chip_smoke.py')) as f:
        names = re.findall(r'line\("(\w+)_kernel"', f.read())
    assert len(names) == 7
    names += list(_chip_smoke().SWEEP_REPLACES)
    assert set(names) == set(kernels.LAUNCHES)
