"""The arithmetic that reads the program's spans against a device trace
(benchmark/spans.py) on synthetic spans and device intervals, and a
`--trace 0` run that leaves the program's recorder off."""

import time

import pytest

from benchmark import harness
from benchmark import spans as S
from benchmark.tests.test_bench_faults import SEED, _spec

# Two frames on one clock (ns): render 0..100 (prepare 0..10, block 10..80
# holding two bounces 20..40 and 40..70, each ending in a wait, film_copy
# 82..98), then the caller's own work, then render 120..200.
SPANS = [
    ('render', 0, 100, None, 1),
    ('render.prepare', 0, 10, 0, 1),
    ('path.block', 10, 80, 0, 1),
    ('path.bounce', 20, 40, 2, 1),
    ('path.bounce_wait', 35, 40, 3, 1),
    ('path.bounce', 40, 70, 2, 1),
    ('path.bounce_wait', 60, 70, 5, 1),
    ('render.film_copy', 82, 98, 0, 1),
    ('render', 120, 200, None, 2),
    ('path.block', 125, 190, 8, 2),
    ('path.bounce', 130, 180, 9, 2),
    ('path.bounce_wait', 170, 180, 10, 2),
]


def test_segments_name_the_innermost_span():
    seg = S.render_segments(SPANS)
    assert seg[:8] == [
        (0, 10, 'render.prepare'), (10, 20, 'path.block'),
        (20, 35, 'path.bounce'), (35, 40, 'path.bounce_wait'),
        (40, 60, 'path.bounce'), (60, 70, 'path.bounce_wait'),
        (70, 80, 'path.block'), (80, 82, 'render')]
    assert seg[8:10] == [(82, 98, 'render.film_copy'), (98, 100, 'render')]
    assert sum(b - a for a, b, _ in seg) == 100 + 80


def test_idle_goes_to_the_innermost_span_and_outside():
    device = [('k', 12, 30), ('k', 25, 36), ('copy', 85, 90),
              ('k', 140, 175)]
    assert S.idle_intervals(device, 0, 200) == [
        (0, 12), (36, 85), (90, 140), (175, 200)]
    idle = S.idle_by_span(SPANS, device, 0, 200)
    assert idle == {
        'render.prepare': 10, 'path.block': 2 + 10 + 5 + 10,
        'path.bounce_wait': 4 + 10 + 5, 'path.bounce': 20 + 10,
        'render': 2 + 2 + 5 + 10, 'render.film_copy': 3 + 8,
        S.OUTSIDE: 20}
    assert sum(idle.values()) == 200 - (36 - 12) - 5 - 35
    # clipped to the stretch
    assert S.idle_intervals(device, 100, 130) == [(100, 130)]
    assert S.idle_by_span(SPANS, device, 100, 130) == {S.OUTSIDE: 20,
                                                        'render': 5,
                                                        'path.block': 5}


def test_gap_names_with_and_without_spans():
    device = [('a', 0, 10), ('b', 32, 40), ('c', 105, 118), ('d', 125, 200)]
    got = S.gaps(SPANS, device, 220)
    # 40..105: path.bounce 20, render.film_copy 16, the rest less
    assert got == [
        ['host in path.bounce, before c', 65e-9],
        ['host in path.bounce, before b', 22e-9],
        ['host, before the first and after the last device activity',
         20e-9],
        ['host in render, before d', 7e-9]]
    # no spans: every gap outside render()
    assert [g[0] for g in S.gaps([], device, 200)][:2] == [
        'host outside render(), before c', 'host outside render(), before b']


def test_untraced_frame_medians_and_self_time():
    assert S.self_ns(SPANS)[:3] == [100 - 10 - 70 - 16, 10, 70 - 20 - 30]
    assert S.per_frame_ns(SPANS, [1, 2], 'path.bounce') == {1: 50, 2: 50}
    assert S.per_frame_ns(SPANS, [1, 2], 'path.bounce', own=True) == \
        {1: 15 + 20, 2: 40}
    assert S.per_frame_ns(SPANS, [2], 'render.film_copy') == {2: 0}
    assert S.median_ms(SPANS, [1, 2], 'path.bounce_wait') == 12.5e-6
    assert S.median_ms(SPANS, [1, 2], 'k1.launch') is None
    assert S.render_frames(SPANS) == [1, 2]
    assert S.setup_s(SPANS) is None
    assert S.setup_s([('scene.parse', 0, 10**9, None, None),
                      ('scene.compile', 10**9, 3 * 10**9, None, None),
                      ('kernels.build', 0, 5, None, None)]) == 3.0


def test_clock_pairs():
    spans = [('k1.launch', 100, 150, None, 1),
             ('render.film_wait', 200, 995, None, 1),
             ('render.film_copy', 1000, 2000, None, 1),
             ('k1.launch', 3100, 3150, None, 2),
             ('render.film_wait', 3200, 3990, None, 2),
             ('render.film_copy', 4000, 5000, None, 2)]
    device = [('render_fused_kernel<1>', 130, 900),
              ('Memcpy DtoH (Device -> Pageable)', 120, 121),
              ('Memcpy DtoH (Device -> Pageable)', 1010, 1500),
              ('render_fused_kernel<1>', 3140, 3900),
              ('Memcpy DtoH (Device -> Pageable)', 4020, 4600)]
    assert S.clock_pairs(spans, device) == {
        'k1_start_after_launch': [30, 40],
        'film_copy_start_after_span_start': [10, 20],
        'film_copy_end_after_span_end': [-500, -400],
        'queued_work_end_after_wait_end': [900 - 995, 3900 - 3990]}
    assert S.clock_pairs(spans[:1], device[1:3]) == {}


def _span_stretch(device, lo, hi, frames=2):
    # device intervals given in ns on the realtime clock, kept as the
    # profiler's microseconds from a trace that starts at 0
    st = S.SpanStretch(None)
    st.device = [(n, s / 1e3, e / 1e3) for n, s, e in device]
    st.trace_start_ns, st.lo_ns, st.hi_ns = 0, lo, hi
    st.wall_s, st.frames = (hi - lo) / 1e9, frames
    return st


def test_idle_in_render_reader_sums_the_spans_inside_render():
    device = [('k', 12, 30), ('k', 25, 36), ('copy', 85, 90),
              ('k', 140, 175)]
    st = _span_stretch(device, 0, 200)
    ctx = dict(stretch=st, spans=SPANS, traced_frames=[1, 2])
    # idle 136 ns of the 200, 20 of them outside render(): 116 over 2 frames
    assert harness.read_metric('idle_in_render_ms', ctx) == \
        pytest.approx(116 / 2 / 1e6)
    ctx['stretch'] = _span_stretch([], 0, 200)
    assert harness.read_metric('idle_in_render_ms', ctx) is None


def test_film_return_reader_is_the_untraced_frames_median():
    ctx = dict(spans=SPANS, untraced_frames=[1, 2])
    # film_copy 16 ns in frame 1, none in frame 2
    assert harness.read_metric('film_return_ms', ctx) == \
        pytest.approx(8 / 1e6)
    ctx['untraced_frames'] = [2]
    assert harness.read_metric('film_return_ms', ctx) is None


def test_breakdown_names_gaps_by_span_where_spans_were_recorded():
    device = [('a', 0, 10), ('b', 32, 40), ('c', 105, 118), ('d', 125, 200)]
    st = _span_stretch(device, 0, 220)
    plain = st.breakdown()['idle_gaps']
    assert plain[0] == ['host, before c', pytest.approx(65e-9)]
    st.spans = SPANS
    out = st.breakdown()
    assert out['idle_gaps'] == S.gaps(SPANS, st.device_ns(), 220)
    assert out['idle_gaps'][0] == ['host in path.bounce, before c', 65e-9]
    assert out['device_ops'][0] == ['d', pytest.approx(75e-9)]


@pytest.mark.parametrize('trace', [0])
def test_trace0_run_leaves_the_recorder_off(trace):
    from lajolla_tpu_torch.utils import profiling
    profiling.disable()
    profiling.take()
    result, _ = harness.run_single(_spec('cbox.preview-1080'), SEED, 0.3,
                                   bool(trace), time.perf_counter(),
                                   device='cpu')
    assert result['correct']
    assert not profiling.enabled() and profiling.take() == []


class _HostStretch(S.SpanStretch):
    """A SpanStretch that traces nothing, so that a `--trace 1` run goes
    through on the CPU."""

    def start(self):
        self.lo_ns = time.time_ns()

    def stop(self, frames):
        self.frames, self.wall_s, self.device = frames, 1e-3, []
        self.hi_ns = self.lo_ns + 10 ** 6
        self.trace_start_ns = self.lo_ns


def test_trace1_run_hands_the_window_spans_to_the_readers(monkeypatch):
    from lajolla_tpu_torch.utils import profiling
    monkeypatch.setattr(harness, 'SpanStretch', _HostStretch)
    seen = {}

    def layer_values(spec, ctx):
        seen.update(ctx)
        return {}
    monkeypatch.setattr(harness, 'layer_values', layer_values)
    spec = _spec('cbox.preview-1080')
    spec['cell']['trace_frames'] = 2
    result, _ = harness.run_single(spec, SEED, 0.3, True,
                                   time.perf_counter(), device='cpu')
    assert result['correct'] and not profiling.enabled()
    frames = S.render_frames(seen['spans'])
    assert len(frames) == result['attempted'] >= 3
    assert seen['traced_frames'] == frames[1:3]
    assert seen['untraced_frames'] == frames[3:]
    copies = S.per_frame_ns(seen['spans'], frames, 'render.film_copy')
    assert all(copies.values())
