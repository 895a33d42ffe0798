"""The plain forms of the sweep casters (kernels K4-K7) against
lajolla_tpu's Pallas kernels in interpret mode.

A 1200-triangle soup and 512 rays, made with numpy from a seed, go through
lajolla_tpu's `intersect_sweep` / `occluded_sweep` (INTERPRET = True, as
lajolla_tpu's own tests/test_intersection.py runs them on the CPU) and
through the port's on CPU tensors, by each route: K5 + K4 (the default),
K5 with overflowing lists (LIST_LEN = 4: supercluster mode), K6
(RESIDENT_BYTES = 0) and K7 (tables packed at 64 triangles a cluster,
which only `pack_sweep(aligned=False)` makes). Gates: t within rtol 3e-4 /
atol 3e-5 (XLA may fuse the Woop products into FMAs and the TPU kernels
test a listed cluster for every ray of a block, the port only for rays
whose own slab test passes), prim equal on >= 99.5% of rays, u and v
within 1e-4 where prim agrees, occlusion equal, prim >= 0 exactly where t
is finite.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lajolla_tpu.ops.intersect_sweep as JSW
import lajolla_tpu_torch.ops.bvh as PBVH
import lajolla_tpu_torch.ops.intersect_binned as PIB
import lajolla_tpu_torch.ops.intersect_sweep as PSW
from lajolla_tpu_torch import kernels
from lajolla_tpu_torch import testing as PT

from torch_threads import one_thread  # noqa: F401

ROUTES = {  # route: (LIST_LEN, RESIDENT_BYTES, triangles per cluster)
    'resident': (PSW.LIST_LEN, PSW.RESIDENT_BYTES, 128),
    'overflow': (4, PSW.RESIDENT_BYTES, 128),
    'list': (PSW.LIST_LEN, 0, 128),
    'streaming': (PSW.LIST_LEN, PSW.RESIDENT_BYTES, 64),
}
N = 512


@pytest.fixture(scope='module')
def soup():
    """{C: (lajolla_tpu scene, port scene)} over one tree, and rays."""
    rng = np.random.default_rng(21)
    centers = rng.uniform(-1, 1, size=(1200, 1, 3))
    tri = (centers + rng.normal(scale=0.06, size=(1200, 3, 3))).astype(
        np.float32)
    p0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    b = PBVH.build_bvh(tri.min(axis=1), tri.max(axis=1))
    scenes = {}
    for C in (128, 64):
        cl = PIB.build_clusters(b, p0, e1, e2, max_tris=C)
        cl.pop('n_clusters')
        tabs = {**cl, **PSW.pack_sweep(cl, aligned=False)}
        jtabs = {**tabs, **PT.sweep_rows(tabs['sw_lane'])}
        scenes[C] = (
            types.SimpleNamespace(**{k: jnp.asarray(v)
                                     for k, v in jtabs.items()}),
            types.SimpleNamespace(**{k: torch.from_numpy(v)
                                     for k, v in tabs.items()}))
    o = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tf = np.where(rng.random(N) < 0.5, np.inf,
                  rng.uniform(0.5, 3.0, N)).astype(np.float32)
    return scenes, (o, d, np.full(N, 1e-4, np.float32), tf)


@pytest.fixture
def route(request, monkeypatch):
    list_len, resident, C = ROUTES[request.param]
    for mod in (JSW, PSW):
        monkeypatch.setattr(mod, 'LIST_LEN', list_len)
        monkeypatch.setattr(mod, 'RESIDENT_BYTES', resident)
    monkeypatch.setattr(JSW, 'INTERPRET', True)
    return request.param, C


def counting(monkeypatch):
    """Count the calls of the port's four wrappers."""
    calls = dict.fromkeys(('sweep_resident', 'sweep_resolve', 'sweep_list',
                           'sweep_streaming'), 0)
    for name in calls:
        def wrapped(*a, _f=getattr(kernels, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(kernels, name, wrapped)
    return calls


def jax_rays(rays):
    return tuple(jnp.asarray(x) for x in rays)


def torch_rays(rays):
    return tuple(torch.from_numpy(x) for x in rays)


def assert_hits_agree(got, want, prim_share=0.995):
    t, prim, u, v = (np.asarray(x) for x in got)
    jt, jprim, ju, jv = (np.asarray(x) for x in want)
    np.testing.assert_allclose(np.where(np.isfinite(t), t, 1e9),
                               np.where(np.isfinite(jt), jt, 1e9),
                               rtol=3e-4, atol=3e-5)
    assert (prim == jprim).mean() >= prim_share
    same = (prim == jprim) & (jprim >= 0)
    assert same.any()
    np.testing.assert_allclose(u[same], ju[same], atol=1e-4)
    np.testing.assert_allclose(v[same], jv[same], atol=1e-4)
    assert ((prim >= 0) == np.isfinite(t)).all()


@pytest.mark.parametrize('route', sorted(ROUTES), indirect=True)
def test_closest_hit_matches_pallas_interpret(soup, route, monkeypatch):
    name, C = route
    scenes, rays = soup
    js, ps = scenes[C]
    calls = counting(monkeypatch)
    got = PSW.intersect_sweep(ps, *torch_rays(rays))
    want = JSW.intersect_sweep(js, *jax_rays(rays))
    ran = {k for k, v in calls.items() if v}
    assert ran == {'resident': {'sweep_resident', 'sweep_resolve'},
                   'overflow': {'sweep_resident', 'sweep_resolve'},
                   'list': {'sweep_list'},
                   'streaming': {'sweep_streaming'}}[name]
    assert 0.05 < (np.asarray(want[1]) >= 0).mean() < 0.95
    assert_hits_agree(got, want)
    # and the independent caster, within the port
    assert_hits_agree(got, PIB.intersect_binned(ps, *torch_rays(rays)))


@pytest.mark.parametrize('route', sorted(ROUTES), indirect=True)
def test_occlusion_matches_pallas_interpret(soup, route):
    _, C = route
    scenes, rays = soup
    js, ps = scenes[C]
    got = PSW.occluded_sweep(ps, *torch_rays(rays)).numpy()
    want = np.asarray(JSW.occluded_sweep(js, *jax_rays(rays)))
    assert 0.02 < want.mean() < 0.98
    assert (got == want).all()
    assert (got == PIB.occluded_binned(ps, *torch_rays(rays)).numpy()).all()


def sorted_rays(ps, rays):
    o, d, tn, tf = torch_rays(rays)
    perm = torch.argsort(PSW._sort_keys(ps, o, d), stable=True)
    return tuple(x[perm].numpy() for x in (o, d, tn, tf))


@pytest.mark.parametrize('route', ['resident', 'overflow'], indirect=True)
def test_resident_and_resolve_match_call_res_intermediates(soup, route,
                                                           monkeypatch):
    """K5's (t, kid) against what lajolla_tpu's resident kernel hands its
    resolve, and K4's (prim, u, v) on those very inputs against the
    resolve's outputs."""
    scenes, rays = soup
    js, ps = scenes[128]
    rays = sorted_rays(ps, rays)
    seen = {}
    real = JSW._resolve_hits

    def spy(scene, o, d, tnear, t_best, kid_best, K):
        out = real(scene, o, d, tnear, t_best, kid_best, K)
        seen.update(o=o, d=d, tnear=tnear, t=t_best, kid=kid_best, out=out)
        return out
    monkeypatch.setattr(JSW, '_resolve_hits', spy)
    JSW._call_res(js, *jax_rays(rays), False)
    jt, jkid = np.array(seen['t']), np.array(seen['kid'])

    K = ps.sw_aabb.shape[0]
    packed, counts, clist, tlist = PSW.list_inputs(
        ps, *torch_rays(rays), PSW.LIST_B, min(PSW.LIST_LEN, K))
    if route[0] == 'overflow':
        assert (counts < 0).any()
    else:
        assert (counts >= 0).all()
    t, kid = PSW.sweep_resident_plain(packed, ps.sw_lane, ps.sw_aabb, counts,
                                      clist, tlist, False)
    t, kid = t.numpy(), kid.numpy()
    np.testing.assert_allclose(np.where(np.isfinite(t), t, 1e9),
                               np.where(np.isfinite(jt), jt, 1e9),
                               rtol=3e-4, atol=3e-5)
    assert (kid == jkid).mean() >= 0.995
    assert ((kid >= 0) == np.isfinite(t)).all()

    hits = torch.from_numpy(np.concatenate(
        [np.asarray(seen['o']), np.asarray(seen['tnear'])[:, None],
         np.asarray(seen['d']), jt[:, None]], axis=1))
    p, u, v = PSW.sweep_resolve_plain(hits, torch.from_numpy(jkid),
                                      ps.sw_lane)
    jp, ju, jv = (np.asarray(x) for x in seen['out'])
    assert (p.numpy() == jp.astype(np.int32)).all()
    assert ((p.numpy() >= 0) == np.isfinite(jt)).all()
    np.testing.assert_allclose(u.numpy(), ju, atol=1e-4)
    np.testing.assert_allclose(v.numpy(), jv, atol=1e-4)


@pytest.mark.parametrize('B,L', [(PSW.LIST_B, 16), (PSW.LIST_B, 4),
                                 (PSW.LANE_R, 16)])
def test_lists_match_jax(soup, B, L, monkeypatch):
    """The front-to-back lists, their distances and their counts (the
    overflow rule counts = -(entered superclusters) included), also when
    built in chunks of one block."""
    scenes, rays = soup
    js, ps = scenes[128]
    assert ps.sw_aabb.shape[0] == 16
    o, d, tn, tf = sorted_rays(ps, rays)
    R = N // B
    inv = 1.0 / np.where(np.abs(d) > 1e-20, d, 1e-20)
    want = JSW._build_lists_ftb(js, *jax_rays((o, d, inv, tn, tf)), R, B, L)
    for chunk in (PSW.LIST_CHUNK_ELEMS, 1):
        monkeypatch.setattr(PSW, 'LIST_CHUNK_ELEMS', chunk)
        got = PSW._build_lists_ftb(ps, *torch_rays((o, d, inv, tn, tf)),
                                   R, B, L)
        jcl, jtl, jcn = (np.asarray(x) for x in want)
        cl, tl, cn = (x.numpy() for x in got)
        assert (cn == jcn).all() and cl.dtype == np.int32
        assert ((cn < 0).any()) == (L == 4)
        assert (tl == jtl).all()
        live = np.arange(L)[None, :] < np.abs(cn)[:, None]
        assert (cl[live] == jcl[live]).all()


def test_sort_keys_match_jax(soup):
    scenes, (o, d, _, _) = soup
    js, ps = scenes[128]
    got = PSW._sort_keys(ps, torch.from_numpy(o), torch.from_numpy(d))
    want = np.asarray(JSW._sort_keys(js, jnp.asarray(o), jnp.asarray(d)))
    assert got.dtype == torch.int64
    assert (got.numpy() == want.astype(np.int64)).all()


def test_horizon_clamp_uses_the_cluster_bounds(soup):
    """tfar <- min(tfar, texit * 1.0001 + 1e-5) against the AABB of all
    clusters: a ray that leaves it gets a finite horizon, a padded ray
    keeps its -1."""
    scenes, (o, d, tn, tf) = soup
    _, ps = scenes[128]
    packed, _, _, _ = PSW.list_inputs(ps, *torch_rays((o[:500], d[:500],
                                                       tn[:500], tf[:500])),
                                      PSW.LIST_B, 16)
    assert packed.shape == (512, 8)
    assert (packed[500:, 7] == -1.0).all() and (packed[500:, 4:7] == 1).all()
    lo, hi = ps.cl_lo.amin(0).numpy(), ps.cl_hi.amax(0).numpy()
    inv = 1.0 / np.where(np.abs(d[:500]) > 1e-20, d[:500], 1e-20)
    texit = np.maximum((lo - o[:500]) * inv, (hi - o[:500]) * inv).min(1)
    want = np.minimum(tf[:500], (texit * np.float32(1.0001) +
                                 np.float32(1e-5)).astype(np.float32))
    np.testing.assert_allclose(packed[:500, 7].numpy(), want, rtol=1e-6)
    assert np.isfinite(packed[:500, 7].numpy()).all()


def test_sweep_counters(soup):
    """A sweep's counters: a ray stops on its own horizon and runs its own
    slab tests, so it tests far fewer clusters than its block lists; an
    occluded ray stops at its first hit."""
    scenes, rays = soup
    _, ps = scenes[128]
    packed, counts, clist, tlist = PSW.list_inputs(
        ps, *torch_rays(sorted_rays(ps, rays)), PSW.LIST_B, 16)
    listed = int(counts.sum())
    stats = {False: {}, True: {}}
    for any_hit in stats:
        PSW.sweep_resident_plain(packed, ps.sw_lane, ps.sw_aabb, counts,
                                 clist, tlist, any_hit, stats=stats[any_hit])
        assert 0 < stats[any_hit]['entries'] <= listed
        assert stats[any_hit]['cluster_tests'] < \
            stats[any_hit]['slab_tests'] < listed * PSW.LIST_B
    assert stats[True]['slab_tests'] < stats[False]['slab_tests']


def test_a_nan_horizon_hits_nothing(soup):
    """A ray whose tfar is NaN (a dead lane's shadow ray) stops at once
    and reports a miss; the other rays of its block are untouched."""
    scenes, (o, d, tn, tf) = soup
    _, ps = scenes[128]
    want = PSW.intersect_sweep(ps, *torch_rays((o, d, tn, tf)))
    bad = tf.copy()
    hit = np.nonzero(want[1].numpy() >= 0)[0][:5]
    bad[hit] = np.nan
    got = PSW.intersect_sweep(ps, *torch_rays((o, d, tn, bad)))
    assert (got[1][hit] == -1).all() and torch.isinf(got[0][hit]).all()
    keep = np.setdiff1d(np.arange(N), hit)
    assert (got[1][keep] == want[1][keep]).all()
