"""One vertex of the general engine on the 'disney' Cornell box (six
Disney BSDFs; testing.cornell_box_builder): the port's `_advance_lane`
against `jax.vmap(_advance_lane)` on numpy-seeded lanes
(testing.random_general_lanes), with tests/test_torch_general.py's gates
(VERTEX_TOL: rtol 1e-4 on each output, dir_pdf 1e-2, directions atol
1e-4; the died bits, and each output on the lanes that go on on both
sides, agree on >= 99.9% of them; radiance on >= 99.9% of all lanes).
At lobe boundaries a last-bit difference in the lobe weights picks
another lobe on a few lanes; the 0.1% admits them.
"""

import jax
import numpy as np
import torch

import lajolla_tpu.integrators.path as JPATH
import lajolla_tpu.scene.compile as JC
from lajolla_tpu.scene.types import RenderOptions as JOptions
import lajolla_tpu_torch.integrators.path as PPATH
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.scene.types import RenderOptions
from test_torch_general import VERTEX_TOL

from torch_threads import one_thread  # noqa: F401

LANES = 1 << 13


def test_advance_lane_matches_jax():
    js = JC.compile_scene(PT.cornell_box_builder(32, variant='disney'))
    ps = to_port(js)
    lanes = PT.random_general_lanes(ps, LANES, seed=23)
    st = [lanes[k] for k in PT.GENERAL_STATE]
    jst = [x.astype(np.int32) if k in ('item', 'nv') else x
           for k, x in zip(PT.GENERAL_STATE, st)]
    step = jax.jit(jax.vmap(lambda u, *s: JPATH._advance_lane(
        js, JOptions(), s, u)))
    want, want_died = step(lanes['u'], *jst)
    got, got_died = PPATH._advance_lane(
        ps, RenderOptions(), tuple(torch.from_numpy(x) for x in st),
        torch.from_numpy(lanes['u']))
    want = dict(zip(PT.GENERAL_STATE, (np.asarray(x) for x in want)))
    got = dict(zip(PT.GENERAL_STATE, (x.numpy() for x in got)))
    want_died, got_died = np.asarray(want_died), got_died.numpy()

    for k in ('item', 'nv', 'done'):
        assert np.array_equal(got[k], want[k]), k
    assert (got_died == want_died).mean() >= 0.999
    goes_on = ~lanes['done'] & ~got_died & ~want_died
    assert 0.05 < goes_on.mean() < 0.95
    for k, (rtol, atol) in VERTEX_TOL.items():
        ok = np.isclose(got[k], want[k], rtol=rtol, atol=atol)
        ok = ok.reshape(LANES, -1).all(axis=1)
        assert ok[goes_on].mean() >= 0.999, (k, ok[goes_on].mean())
    ok = np.isclose(got['L'], want['L'], rtol=1e-4, atol=1e-5).all(axis=1)
    assert ok.mean() >= 0.999, ok.mean()
    assert (want['L'] != lanes['L']).any()
