"""The metric arithmetic on synthetic inputs."""

import types

import pytest

from benchmark import harness, stats
from benchmark.trace import Stretch


def test_window_rate_counts_every_frame_over_the_whole_window():
    # 4 frames of 1e6 paths, window from t = 10 s to the last end, 12 s
    assert stats.window_rate(1e6, [10.5, 11.0, 11.5, 12.0], 10.0) == \
        pytest.approx(4 / 2.0)
    assert stats.window_rate(1e6, [], 10.0) is None


def test_p95_is_over_every_frame():
    frames = list(range(1, 101))           # 1 .. 100 ms
    assert stats.p95(frames) == pytest.approx(95.95)
    assert stats.p95([5.0]) is None


def test_busy_is_the_union_clipped_to_the_stretch():
    iv = [(0, 10), (5, 20), (30, 40), (35, 38), (90, 200)]
    assert stats.busy_seconds(iv) == pytest.approx((20 + 10 + 110) / 1e6)
    assert stats.busy_seconds(iv, 8, 100) == pytest.approx(
        (12 + 10 + 10) / 1e6)


def _stretch(device, wall_s=1e-3, frames=2):
    st = Stretch(None)
    st.device, st.wall_s, st.frames = device, wall_s, frames
    return st


def test_idle_share_from_intervals():
    st = _stretch([('k', 0.0, 300.0), ('k', 200.0, 500.0),
                   ('memcpy', 900.0, 1000.0)])
    assert harness.read_metric('device_idle_pct', dict(stretch=st)) == \
        pytest.approx(40.0)
    assert harness.read_metric('device_idle_pct',
                               dict(stretch=_stretch([]))) is None
    assert harness.read_metric('traced_frame_ms', dict(stretch=st)) == \
        pytest.approx(0.5)


def _ref(cast_prims=16):
    import torch
    t = torch.zeros(1)
    return types.SimpleNamespace(
        cast_prims=cast_prims, fp_woop=t, fp_woop_occ=t, fp_tri=t,
        cast_src=t, cast_alt=t, cast_quad=t, cast_occ_quad=t, fp_light=t,
        tri_stair_cdf=t, fp_sph=t)


def test_k1_roofline_from_counts():
    # 2 frames of 1 ms of K1 each; 3 vertices a path on a 10 x 10 film at
    # 4 spp: 1200 vertices a frame of (16 * 45 + 55 + 420) operations
    st = _stretch([('void render_fused_kernel<1>', 0.0, 1000.0),
                   ('void render_fused_kernel<1>', 1000.0, 2000.0),
                   ('film_sum_kernel', 2000.0, 2010.0)])
    st.launches = {'render_fused': 2}
    ctx = dict(stretch=st,
               work={'vertices': 3.0}, ref=_ref(), width=10, height=10,
               spp=4)
    ops = 1200 * (16 * 45 + 55 + 420)
    want = 100 * max(ops / stats.PEAK_FP32,
                     (10 * 4 + 12 * 100) / stats.PEAK_BYTES) / 1e-3
    assert harness.read_metric('k1_roofline_pct', ctx) == pytest.approx(want)
    ctx['stretch'] = _stretch([('other', 0.0, 1.0)])
    assert harness.read_metric('k1_roofline_pct', ctx) is None


def test_breakdown_names_gaps_by_the_next_activity():
    # a stretch of 1 ms by the host's clock; device busy 0-100 and 600-750
    # us of the trace's clock, so 500 us between and 250 us outside
    st = _stretch([('b', 600.0, 750.0), ('a', 0.0, 100.0)])
    out = st.breakdown()
    assert out['device_ops'] == [['b', 1.5e-4], ['a', 1e-4]]
    assert out['idle_gaps'][0] == ['host, before b', pytest.approx(5e-4)]
    assert out['idle_gaps'][1][1] == pytest.approx(2.5e-4)
    assert st.busy_s() == pytest.approx(2.5e-4)
    assert st.window_s() == 1e-3
