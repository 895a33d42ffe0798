"""The tie rules of the sweep casters, which kernels K5, K6 and K7 keep
with a warp reduction: among hits at equal t the lowest triangle index of
the first listed cluster wins (closest hit; K7 walks the clusters in id
order), and the lowest index of the first cluster with a hit decides (any
hit).

testing.sweep_tie_fixture (numpy, from a seed) puts identical triangles
at indices 7, 34, 39, 71 and 103 of one cluster of 128 (lanes 7 and 2 of
a warp, rounds of 32 apart; at 64 triangles a cluster, K7's tables, the
copies at 7, 34 and 39, lanes 7, 2 and 7) and one more in a second
cluster that the lists hold first, beside a triangle whose lifted copy
sits at a higher index. Its rays go through lajolla_tpu's
`intersect_sweep` / `occluded_sweep` (INTERPRET = True, as
tests/test_torch_sweep.py runs them) and through the port's plain forms
on CPU tensors, by the routes K5 + K4, K5 with overflowing lists
(supercluster mode), K6 and K7 (the fixture at 64 a cluster). Gates:
prim equal on every ray, and the prim each rule names; t within rtol
3e-4 (XLA may fuse the Woop products into FMAs), u and v within 1e-4;
occlusion equal.

testing.resolve_tie_fixture holds the resolve's own rule, which kernel K4
keeps with a warp reduction on (err, index): two triangles of one cluster
in different lanes of a warp hit at t_best -+ delta (equal err, exact in
fp32), so the lower index must win whichever lane holds it; its rays go
through lajolla_tpu's `_resolve_hits` (INTERPRET = True) and the port's
resolve on CPU tensors (its plain form), which must name the same prims,
bit-equal u and v, and the prim the rule names.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lajolla_tpu.ops.intersect_sweep as JSW
import lajolla_tpu_torch.ops.intersect_sweep as PSW
from lajolla_tpu_torch import testing as PT

from torch_threads import one_thread  # noqa: F401

ROUTES = {  # route: (LIST_LEN, RESIDENT_BYTES, triangles per cluster)
    'resident': (PSW.LIST_LEN, PSW.RESIDENT_BYTES, 128),
    'overflow': (4, PSW.RESIDENT_BYTES, 128),
    'list': (PSW.LIST_LEN, 0, 128),
    'streaming': (PSW.LIST_LEN, PSW.RESIDENT_BYTES, 64),
}


@pytest.fixture(scope='module')
def tie_sets():
    """{C: (lajolla_tpu tables, port tables, rays, region)} of the tie
    fixture at 128 and at 64 triangles a cluster."""
    out = {}
    for C in (128, 64):
        tables, rays, region = PT.sweep_tie_fixture(seed=5, C=C)
        jtables = {**tables, **PT.sweep_rows(tables['sw_lane'])}
        js = types.SimpleNamespace(**{k: jnp.asarray(v)
                                      for k, v in jtables.items()})
        ps = types.SimpleNamespace(**{k: torch.from_numpy(v)
                                      for k, v in tables.items()})
        out[C] = (js, ps, rays, region)
    return out


@pytest.fixture
def ties(tie_sets):
    return tie_sets[128]


@pytest.fixture
def route(request, monkeypatch):
    list_len, resident, C = ROUTES[request.param]
    for mod in (JSW, PSW):
        monkeypatch.setattr(mod, 'LIST_LEN', list_len)
        monkeypatch.setattr(mod, 'RESIDENT_BYTES', resident)
    monkeypatch.setattr(JSW, 'INTERPRET', True)
    return request.param, C


def expected_prims(route, C, region):
    """The prim each tie rule names: a ray on A takes the copy of the
    first listed cluster (cluster 1, index 0: prim C), or cluster 0's
    lowest index where the block sweeps its supercluster's members in id
    order and where K7 walks the clusters in id order; a ray on B the
    nearer, lifted copy."""
    on_a = C if route in ('resident', 'list') else PT.TIE_COPIES_A[0]
    return np.select([region == 0, region == 1], [on_a, PT.TIE_NEAR_B], -1)


def torch_rays(rays):
    return tuple(torch.from_numpy(x) for x in rays)


@pytest.mark.parametrize('route', sorted(ROUTES), indirect=True)
def test_closest_hit_ties_match_pallas_interpret(tie_sets, route):
    route, C = route
    js, ps, rays, region = tie_sets[C]
    t, prim, u, v = (x.numpy() for x in
                     PSW.intersect_sweep(ps, *torch_rays(rays)))
    jt, jprim, ju, jv = (np.asarray(x) for x in JSW.intersect_sweep(
        js, *(jnp.asarray(x) for x in rays)))
    assert (jprim == expected_prims(route, C, region)).all()
    assert (prim == jprim).all()
    np.testing.assert_allclose(np.where(np.isfinite(t), t, 1e9),
                               np.where(np.isfinite(jt), jt, 1e9),
                               rtol=3e-4, atol=3e-5)
    hit = jprim >= 0
    np.testing.assert_allclose(u[hit], ju[hit], atol=1e-4)
    np.testing.assert_allclose(v[hit], jv[hit], atol=1e-4)
    if route == 'overflow':
        counts = PSW.list_inputs(ps, *torch_rays(rays), PSW.LIST_B, 4)[1]
        assert (counts < 0).all()


@pytest.mark.parametrize('route', sorted(ROUTES), indirect=True)
def test_any_hit_ties(tie_sets, route):
    """Occlusion equals lajolla_tpu's; the any-hit t is that of the lowest
    index that hits (a ray on B stops at the copy at z = 0, beyond the
    nearer copy at a higher index), which the kernels return too."""
    js, ps, rays, region = tie_sets[route[1]]
    occ = PSW.occluded_sweep(ps, *torch_rays(rays)).numpy()
    jocc = np.asarray(JSW.occluded_sweep(js, *(jnp.asarray(x)
                                               for x in rays)))
    assert (jocc == (region >= 0)).all()
    assert (occ == jocc).all()
    o, d, tn, tf = torch_rays(rays)
    t_any = PSW._call(ps, o, d, tn, tf, True)[0].numpy()
    t_near = PSW._call(ps, o, d, tn, tf, False)[0].numpy()
    on_a, on_b = region == 0, region == 1
    np.testing.assert_array_equal(t_any[on_a], t_near[on_a])
    assert (t_any[on_b] > t_near[on_b] + 0.05).all()
    assert np.isinf(t_any[region < 0]).all()


def test_resolve_cross_lane_ties_match_pallas_interpret(monkeypatch):
    from lajolla_tpu_torch import kernels
    monkeypatch.setattr(JSW, 'INTERPRET', True)
    tables, rays, kid, want = PT.resolve_tie_fixture(seed=7)
    K = tables['sw_aabb'].shape[0]
    js = types.SimpleNamespace(sw_lane=jnp.asarray(tables['sw_lane']))
    jp, ju, jv = (np.asarray(x) for x in JSW._resolve_hits(
        js, jnp.asarray(rays[:, 0:3]), jnp.asarray(rays[:, 4:7]),
        jnp.asarray(rays[:, 3]), jnp.asarray(rays[:, 7]), jnp.asarray(kid),
        K))
    p, u, v = (x.numpy() for x in kernels.sweep_resolve(
        torch.from_numpy(rays), torch.from_numpy(kid),
        torch.from_numpy(tables['sw_lane'])))
    assert {w for _, w in PT.RESOLVE_PAIRS} <= set(want.tolist())
    assert (jp.astype(np.int32) == want).all()
    assert (p == want).all()
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(v, jv)


def test_tie_fixture_lists_cluster_1_first(ties):
    """The premise of the closest-hit rule's test: every block holding a
    ray on A lists cluster 1 before cluster 0."""
    _, ps, rays, region = ties
    perm = torch.argsort(PSW._sort_keys(ps, *torch_rays(rays[:2])),
                         stable=True).numpy()
    _, counts, clist, _ = PSW.list_inputs(
        ps, *torch_rays(tuple(x[perm] for x in rays)), PSW.LIST_B,
        min(PSW.LIST_LEN, ps.sw_aabb.shape[0]))
    blocks = (region[perm] == 0).reshape(-1, PSW.LIST_B).any(axis=1)
    assert blocks.any()
    for blk in np.nonzero(blocks)[0]:
        listed = list(clist[blk, :counts[blk]].numpy())
        assert listed.index(1) < listed.index(0)
