"""The span recorder of lajolla_tpu_torch.utils.profiling: off by default,
free of clock reads and synchronises while off; render()'s spans, their
nesting and frame ids on the CPU, on the path and the volpath routes (K8's
launch stubbed where its spans are read); a film and an operation sequence
that do not depend on the recorder; scene set-up by phase; spans that
nest, so that self time is a span less its children."""

import contextlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import lajolla_tpu_torch
from lajolla_tpu_torch import kernels, render
from lajolla_tpu_torch import testing as PT
from lajolla_tpu_torch.integrators import path as PP
from lajolla_tpu_torch.integrators import path_kernel
from lajolla_tpu_torch.integrators import volpath as PV
from lajolla_tpu_torch.integrators import volpath_kernel as PVK
from lajolla_tpu_torch.scene.camera import camera_record
from lajolla_tpu_torch.scene.types import RenderOptions
from lajolla_tpu_torch.utils import film_return as FR
from lajolla_tpu_torch.utils import profiling

from torch_threads import one_thread  # noqa: F401

# (20, 10): under one 4096-pixel block, the per-bounce driver; (128, 64):
# two whole blocks, K1's route (its plain form on the CPU).
FILMS = [(20, 10), (128, 64)]


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.disable()
    profiling.take()
    yield
    profiling.disable()
    profiling.take()


def _box(res, spp=2):
    return PT.make_cornell_box(res, spp), RenderOptions(samples_per_pixel=spp)


def _tree(spans):
    """{name: {names of its parents}}."""
    out = {}
    for s in spans:
        out.setdefault(s.name, set()).add(
            None if s.parent is None else spans[s.parent].name)
    return out


def test_recorder_is_off_in_a_new_process():
    code = ("from lajolla_tpu_torch.utils import profiling; "
            "print(profiling.enabled(), profiling.take())")
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.split() == ['False', '[]']


def test_off_records_nothing_and_shares_one_null_context():
    scene, opt = _box((20, 10), 1)
    render(scene, opt, device='cpu', seed=1)
    assert profiling.take() == []
    assert profiling.span('a') is profiling.span('b') is profiling.frame('c')


def test_render_spans_per_bounce_driver():
    scene, opt = _box((20, 10), 2)
    iters = []

    def counting(*a):
        iters.append(1)
        return path_kernel.advance_kernel_t(*a)
    PP._render_block_kernel(scene, opt, 5, 0, 2, advance=counting)
    with profiling.recording() as spans:
        render(scene, opt, device='cpu', seed=5)
    names = [s.name for s in spans]
    assert names[:2] == ['render', 'render.prepare']
    assert names[-2:] == ['render.film_wait', 'render.film_copy']
    assert names.count('path.bounce') == len(iters) > 1
    assert names.count('path.bounce_wait') == len(iters) + 1
    assert _tree(spans) == {
        'render': {None}, 'render.prepare': {'render'},
        'path.block': {'render'}, 'path.bounce': {'path.block'},
        'path.bounce_wait': {'path.block', 'path.bounce'},
        'render.film_wait': {'render'}, 'render.film_copy': {'render'}}
    # the first readback precedes the loop; each bounce ends in its own
    assert spans[names.index('path.bounce_wait')].parent == \
        names.index('path.block')
    assert {s.frame for s in spans} == {spans[0].frame}
    assert spans[0].frame is not None
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_each_render_is_a_frame():
    scene, opt = _box((20, 10), 1)
    with profiling.recording() as spans:
        render(scene, opt, device='cpu', seed=1)
        with profiling.span('between'):
            pass
        render(scene, opt, device='cpu', seed=2)
    roots = [s for s in spans if s.name == 'render']
    assert len(roots) == 2 and roots[0].frame != roots[1].frame
    assert [s.frame for s in spans if s.name == 'between'] == [None]
    for s in spans:
        if s.name != 'between':
            assert s.frame in (roots[0].frame, roots[1].frame)


def _aten_ops(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e.name for e in prof.events() if e.name.startswith('aten::')]


@pytest.mark.parametrize('res', FILMS)
def test_recorder_moves_no_film_bit_op_or_launch(res):
    scene, opt = _box(res, 2)

    def run():
        before = dict(kernels.LAUNCHES)
        img = render(scene, opt, device='cpu', seed=9)
        return img, {k: v - before.get(k, 0)
                     for k, v in kernels.LAUNCHES.items()}
    (off, launches_off), ops_off = _aten_ops(run)
    with profiling.recording() as spans:
        (on, launches_on), ops_on = _aten_ops(run)
    assert spans and np.array_equal(off, on)
    assert launches_off == launches_on
    assert ops_off == ops_on and ops_off


def test_no_synchronise_while_off(monkeypatch):
    calls = []

    class Stream:
        def synchronize(self):
            calls.append('stream')
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, 'synchronize',
                        lambda device=None: calls.append('device'))
    cuda = torch.device('cuda')
    profiling.sync('render.film_wait', cuda)
    scene, opt = _box((20, 10), 1)
    render(scene, opt, device='cpu', seed=1)
    assert calls == [] and profiling.take() == []
    with profiling.recording() as spans:
        profiling.sync('render.film_wait', cuda)
        profiling.sync('render.film_wait', torch.device('cpu'))
    assert calls == ['stream']
    assert [s.name for s in spans] == ['render.film_wait'] * 2


def test_film_copy_spans_on_the_pool_route(monkeypatch):
    """The pool's route, its blocks ordinary tensors and the CPU films sent
    to it as CUDA films are: a frame that finds a free block opens no span
    inside render.film_copy; a third frame rendered while the first two
    are held takes the pageable copy in render.film_copy.pageable. The
    film's wait and copy stay children of render, and every frame is the
    CPU route's film bit for bit."""
    scene, opt = _box((20, 10), 1)
    seeds = (1, 2, 3)
    want = [render(scene, opt, device='cpu', seed=s) for s in seeds]
    pool = FR.FilmPool(lambda shape, stride, dtype: torch.empty_strided(
        shape, stride, dtype=dtype))
    monkeypatch.setattr(FR, '_pool_for', lambda film: pool)
    before = dict(FR.FILM_RETURNS)
    with profiling.recording() as spans:
        held = [render(scene, opt, device='cpu', seed=s) for s in seeds]
    assert all(np.array_equal(g, w) for g, w in zip(held, want))
    assert {k: v - before[k] for k, v in FR.FILM_RETURNS.items()} == {
        'pinned': 2, 'pageable': 1}
    frames = [s.frame for s in spans if s.name == 'render']
    names = [[s.name for s in spans if s.frame == f] for f in frames]
    assert [n[-3:] for n in names] == [
        ['path.bounce_wait', 'render.film_wait', 'render.film_copy']] * 2 + [
        ['render.film_wait', 'render.film_copy', 'render.film_copy.pageable']]
    tree = _tree(spans)
    assert tree['render.film_wait'] == tree['render.film_copy'] == {'render'}
    assert tree['render.film_copy.pageable'] == {'render.film_copy'}


def test_an_exception_closes_its_spans():
    with profiling.recording() as spans:
        with pytest.raises(ZeroDivisionError):
            with profiling.frame('outer'):
                with profiling.span('inner'):
                    1 / 0
        with profiling.span('after'):
            pass
    assert [(s.name, s.parent) for s in spans] == [
        ('outer', None), ('inner', 0), ('after', None)]
    assert all(s.end_ns is not None for s in spans)
    assert spans[2].frame is None


def test_take_drains():
    profiling.enable()
    with profiling.span('a'):
        with pytest.raises(RuntimeError, match="open span 'a'"):
            profiling.take()
    with profiling.span('b'):
        pass
    assert [s.name for s in profiling.take()] == ['a', 'b']
    assert profiling.take() == []
    profiling.disable()
    with profiling.span('c'):
        pass
    assert profiling.take() == []


def test_mesh_compile_records_its_phases():
    with profiling.recording() as spans:
        scene = PT.make_cornell_box((8, 6), 1, 'mesh', triangles=200)
    assert scene.meta.num_triangles >= 192
    assert _tree(spans) == {'scene.compile': {None},
                            'compile.bvh': {'scene.compile'},
                            'compile.clusters': {'scene.compile'},
                            'compile.pack': {'scene.compile'}}
    with profiling.recording() as spans:
        PT.make_cornell_box((8, 6), 1)
    assert [s.name for s in spans] == ['scene.compile']


def test_parse_scene_records_set_up(tmp_path):
    xml = PT.write_cornell_box_xml(str(tmp_path), 16, 1)
    with profiling.recording() as spans:
        lajolla_tpu_torch.parse_scene(xml, 'cpu')
    assert [(s.name, s.parent, s.frame) for s in spans] == [
        ('scene.parse', None, None), ('scene.compile', None, None),
        ('scene.upload', None, None)]
    secs = profiling.seconds_by_name(spans)
    assert set(secs) == {'scene.parse', 'scene.compile', 'scene.upload'}
    assert all(v >= 0.0 for v in secs.values())


def test_children_follow_one_another_inside_their_span():
    """A span's self time is its duration less its children's, which
    holds where the children of one thread never overlap: checked on the
    per-bounce driver's spans, where path.bounce less its one
    path.bounce_wait is the host's time issuing the bounce."""
    scene, opt = _box((20, 10), 2)
    with profiling.recording() as spans:
        render(scene, opt, device='cpu', seed=3)
    children = {}
    for i, s in enumerate(spans):
        if s.parent is not None:
            children.setdefault(s.parent, []).append(i)
    for p, kids in children.items():
        ends = [spans[p].start_ns] + [spans[k].end_ns for k in kids]
        starts = [spans[k].start_ns for k in kids] + [spans[p].end_ns]
        assert all(e <= s for e, s in zip(ends, starts))
        own = (spans[p].end_ns - spans[p].start_ns) - sum(
            spans[k].end_ns - spans[k].start_ns for k in kids)
        assert own == sum(s - e for e, s in zip(ends, starts))
        if spans[p].name == 'path.bounce':
            assert [spans[k].name for k in kids] == ['path.bounce_wait']


def _vol_box(spp):
    """The foggy box on one whole 4096-pixel block: K8's route."""
    return (PT.make_cornell_box(64, spp, 'vol'),
            RenderOptions(integrator='volpath', samples_per_pixel=spp))


def test_volpath_spans_and_film(monkeypatch):
    """K8's route on the CPU (its plain form), two samples a block: a
    volpath.block span a block inside render, the film's wait and copy
    after them, and the film bit for bit the recorder's off film."""
    monkeypatch.setattr(PV, 'VOLK_SPP_BLOCK', 2)
    scene, opt = _vol_box(3)
    assert PV._use_vol_kernel(scene)
    off = render(scene, opt, device='cpu', seed=2 ** 31 + 5)
    assert profiling.take() == []
    with profiling.recording() as spans:
        on = render(scene, opt, device='cpu', seed=2 ** 31 + 5)
    assert np.array_equal(off, on)
    assert [s.name for s in spans] == [
        'render', 'render.prepare', 'volpath.block', 'volpath.block',
        'render.film_wait', 'render.film_copy']
    assert all(s.parent == 0 for s in spans[1:])
    assert {s.frame for s in spans} == {spans[0].frame} != {None}


@pytest.fixture
def k8_stubbed(monkeypatch):
    """kernels.render_fused_vol with its CUDA launch stubbed out (the CPU
    scene's tables stand in for the device's; the launch returns 0 and
    leaves the per-item buffer zero), and volpath_kernel sending a CPU
    scene's K8 blocks through it as it sends a CUDA scene's. Returns the
    launches' arguments and the film sums' (kernels.film_sum runs its
    plain form on the CPU, which kernels.LAUNCHES does not count)."""
    launches, sums = [], []
    real_sum = kernels.film_sum

    def film_sum(buf, n, stride, nspp, film=None):
        sums.append((n, stride, nspp))
        return real_sum(buf, n, stride, nspp, film)
    monkeypatch.setattr(kernels, 'film_sum', film_sum)

    class Lib:
        def lj_render_fused_vol(self, *args):
            launches.append(args)
            return 0
    monkeypatch.setattr(kernels, 'build',
                        lambda: {'volpath_kernels': Lib()})
    monkeypatch.setattr(kernels, '_scene_args', lambda scene, *a: (
        scene.fp_tri.device, kernels._Tables(), 1, 1, 0))
    monkeypatch.setattr(kernels, '_queue', lambda total, device: (
        torch.zeros((total, 3)), torch.zeros(1, dtype=torch.int64)))
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))

    def through_kernels(scene, options, seed, s0, nspp):
        w, h = scene.meta.width, scene.meta.height
        film = kernels.render_fused_vol(
            scene, camera_record(scene), PVK.medium(scene), PV.stream_root(seed), s0, nspp,
            w=w, h=h, filter_type=options.filter_type,
            filter_param=options.filter_param,
            **PVK.kernel_statics(scene, options))
        return film.T.reshape(h, w, 3)
    monkeypatch.setattr(PVK, 'render_fused_vol_plain', through_kernels)
    return launches, sums


def test_k8_spans_and_launches_a_frame(k8_stubbed):
    """A 256-spp frame on K8's route: four launches of 64 samples, each
    with its film sum and no other kernel; each block's k8.args then
    k8.launch inside its volpath.block."""
    scene, opt = _vol_box(256)
    before = dict(kernels.LAUNCHES)
    with profiling.recording() as spans:
        img = render(scene, opt, device='cpu', seed=3)
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    assert launched == {k: 4 if k == 'render_fused_vol' else 0
                        for k in launched}
    launches, sums = k8_stubbed
    block = PV.VOLK_SPP_BLOCK
    assert [a[-6:-4] for a in launches] == [(s0, block)
                                            for s0 in range(0, 256, block)]
    assert sums == [(64 * 64, 64 * 64, block)] * 4
    assert img.shape == (64, 64, 3) and not img.any()
    names = [s.name for s in spans]
    assert names == ['render', 'render.prepare'] + [
        'volpath.block', 'k8.args', 'k8.launch'] * 4 + [
        'render.film_wait', 'render.film_copy']
    assert _tree(spans) == {
        'render': {None}, 'render.prepare': {'render'},
        'volpath.block': {'render'}, 'k8.args': {'volpath.block'},
        'k8.launch': {'volpath.block'}, 'render.film_wait': {'render'},
        'render.film_copy': {'render'}}
