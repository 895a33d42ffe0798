"""The port's BVH, cluster and sweep-table build against lajolla_tpu's.

Byte equality is asserted on tables built from the SAME tree, carried
across as numpy: the two packages compile the native SAH build with
different flags, which may pick different (equally valid) trees. The
port's own two builds are held by the tree's invariants. Traversals and the
binned caster are held against lajolla_tpu's on a triangle soup: t within
rtol 2e-4 / atol 2e-5 (the tolerance lajolla_tpu's own oracle test uses;
XLA may contract the products into FMAs), occlusion equal.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lajolla_tpu.ops.bvh as JBVH
import lajolla_tpu.ops.intersect_binned as JIB
import lajolla_tpu.ops.intersect_sweep as JSW
import lajolla_tpu.scene.compile as JC
import lajolla_tpu_torch.ops.bvh as PBVH
import lajolla_tpu_torch.ops.intersect_binned as PIB
import lajolla_tpu_torch.ops.intersect_sweep as PSW
import lajolla_tpu_torch.scene.compile as PC
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch.bridge import scene_from_jax as to_port

from torch_threads import one_thread  # noqa: F401

BUILDS = {'native': PBVH.build_bvh, 'morton': PBVH.build_bvh_morton}
TABLES = {
    'bvh': ('bvh_lo', 'bvh_hi', 'bvh_first', 'bvh_count', 'bvh_skip',
            'bvh_prim', 'bvh_node', 'bvh_leaf_tri'),
    'cl': ('cl_lo', 'cl_hi', 'cl_A', 'cl_b', 'cl_prim'),
    'sw': ('sw_lane', 'sw_aabb', 'sw_saabb'),
}


def soup(n=1200, seed=21, scale=0.06):
    """(p0, e1, e2, lo, hi) of n small random triangles in [-1, 1]^3."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, size=(n, 1, 3))
    tri = (centers + rng.normal(scale=scale, size=(n, 3, 3))).astype(
        np.float32)
    return (tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
            tri.min(axis=1), tri.max(axis=1))


def soup_rays(n=512, seed=22):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize('which', sorted(BUILDS))
def test_both_builds_answer(which):
    """The native build compiles from the repository's own source with
    the host compiler; both builds answer for a soup."""
    if which == 'native':
        assert PBVH._load_libbvh() is not None
    _, _, _, lo, hi = soup(300)
    assert BUILDS[which](lo, hi)['n_nodes'] > 1


@pytest.mark.parametrize('which', sorted(BUILDS))
def test_tree_invariants(which):
    """Skip links point forward, an inner node's first child is the next
    node, children lie inside their parents, every triangle sits in
    exactly one leaf, and a leaf's box holds its triangles."""
    _, _, _, lo, hi = soup()
    b = BUILDS[which](lo, hi)
    n = b['n_nodes']
    idx = np.arange(n)
    assert (b['skip'] > idx).all() and b['skip'].max() == n
    inner = b['count'] == 0
    assert (b['first'][inner] == idx[inner] + 1).all()
    for i in idx[inner]:
        for child in (i + 1, b['skip'][i + 1]):
            assert (b['lo'][child] >= b['lo'][i]).all()
            assert (b['hi'][child] <= b['hi'][i]).all()
    slots = np.concatenate([np.arange(f, f + c) for f, c in
                            zip(b['first'][~inner], b['count'][~inner])])
    assert sorted(slots) == list(range(len(lo)))
    assert sorted(b['prim']) == list(range(len(lo)))
    assert b['count'].max() <= PBVH.LEAF_SIZE
    for f, c, blo, bhi in zip(b['first'][~inner], b['count'][~inner],
                              b['lo'][~inner], b['hi'][~inner]):
        ids = b['prim'][f:f + c]
        assert (lo[ids] >= blo).all() and (hi[ids] <= bhi).all()


@pytest.mark.parametrize('max_tris', [128, 64])
@pytest.mark.parametrize('which', sorted(BUILDS))
def test_clusters_and_sweep_tables_match_jax(which, max_tris):
    p0, e1, e2, lo, hi = soup()
    b = BUILDS[which](lo, hi)
    got = PIB.build_clusters(b, p0, e1, e2, max_tris=max_tris)
    want = JIB.build_clusters(b, p0, e1, e2, max_tris=max_tris)
    assert got['n_clusters'] == want['n_clusters'] > 1
    for k in TABLES['cl']:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    if max_tris % 128:
        with pytest.raises(AssertionError, match='128-aligned'):
            PSW.pack_sweep(got)
        return
    sw, jsw = PSW.pack_sweep(got), JSW.pack_sweep(want)
    # the port keeps the lane table alone: lajolla_tpu's triangle-major
    # rows are rows 0-12 of it
    assert sorted(sw) == sorted(TABLES['sw'])
    for k, x in {**sw, **PT.sweep_rows(sw['sw_lane'])}.items():
        assert x.tobytes() == jsw[k].tobytes(), k


@pytest.fixture(scope='module')
def same_tree_scenes():
    """The mesh Cornell box (462 triangles) compiled by both packages from
    one tree: the port's build_bvh answers for both."""
    trees = []
    real = PBVH.build_bvh

    def build(tri_lo, tri_hi):
        if not trees:
            trees.append(real(tri_lo, tri_hi))
        return {k: np.copy(v) if isinstance(v, np.ndarray) else v
                for k, v in trees[0].items()}
    box = PT.cornell_box_builder((32, 24), 2, 'mesh')
    mp = pytest.MonkeyPatch()
    mp.setattr(JC, 'build_bvh', build)
    mp.setattr(PBVH, 'build_bvh', build)
    try:
        js = JC.compile_scene(box)
        ps = PC.compile_scene(box)
    finally:
        mp.undo()
    assert trees
    return js, ps


@pytest.mark.parametrize('group', sorted(TABLES))
def test_compiled_tables_match_jax(same_tree_scenes, group):
    js, ps = same_tree_scenes
    for k in TABLES[group]:
        want = np.asarray(getattr(js, k))
        got = getattr(ps, k).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k
    if group == 'sw':
        for k, x in PT.sweep_rows(ps.sw_lane.numpy()).items():
            assert x.tobytes() == np.asarray(getattr(js, k)).tobytes(), k


def test_compiled_meta_and_other_tables_match_jax(same_tree_scenes):
    js, ps = same_tree_scenes
    assert ps.meta.use_bvh and ps.meta.use_binned
    assert ps.meta.num_triangles == 462 >= PC.BVH_MIN_TRIS
    assert ps.meta == to_port(js).meta
    for k in ('tri_p0', 'tri_e1', 'tri_e2', 'tri_shade', 'fp_woop',
              'fp_woop_occ', 'cast_src', 'tri_alias'):
        assert getattr(ps, k).numpy().tobytes() == \
            np.asarray(getattr(js, k)).tobytes(), k


def test_small_scene_placeholders_match_jax():
    b = PT.cornell_box_builder(8)
    js, ps = JC.compile_scene(b), PC.compile_scene(b)
    assert not ps.meta.use_bvh and not ps.meta.use_binned
    assert ps.meta.bvh_depth == js.meta.bvh_depth == 1
    for group in TABLES.values():
        for k in group:
            want = np.asarray(getattr(js, k))
            got = getattr(ps, k).numpy()
            assert got.dtype == want.dtype, k
            assert got.tobytes() == want.tobytes(), k


@pytest.fixture(scope='module')
def soup_scenes():
    """(lajolla_tpu namespace, port namespace, rays) of the soup's BVH
    and cluster tables, from one tree."""
    p0, e1, e2, lo, hi = soup()
    b = PBVH.build_bvh(lo, hi)
    tabs = PC.bvh_tables(b, p0, e1, e2, len(p0), True)
    js = types.SimpleNamespace(**{k: jnp.asarray(v)
                                  for k, v in tabs.items()})
    ps = types.SimpleNamespace(**{k: torch.from_numpy(np.array(v))
                                  for k, v in tabs.items()})
    return js, ps, soup_rays()


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(np.where(np.isfinite(got), got, 1e9),
                               np.where(np.isfinite(want), want, 1e9),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize('caster', ['bvh', 'binned'])
def test_closest_hit_matches_jax(soup_scenes, caster):
    js, ps, (o, d) = soup_scenes
    n = o.shape[0]
    tn, tf = np.zeros(n, np.float32), np.full(n, np.inf, np.float32)
    if caster == 'bvh':
        want = jax.vmap(lambda o_, d_: JBVH.bvh_traverse(
            js, o_, d_, 0.0, jnp.inf))(jnp.asarray(o), jnp.asarray(d))
        got = PBVH.bvh_traverse(ps, torch.from_numpy(o), torch.from_numpy(d),
                                0.0, float('inf'))
    else:
        want = JIB.intersect_binned(js, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(tn), jnp.asarray(tf))
        got = PIB.intersect_binned(ps, torch.from_numpy(o),
                                   torch.from_numpy(d), torch.from_numpy(tn),
                                   torch.from_numpy(tf))
    t, prim, u, v = (x.numpy() for x in got)
    jt, jprim, ju, jv = (np.asarray(x) for x in want)
    assert 0.05 < (jprim >= 0).mean() < 0.95
    _close(t, jt)
    assert (prim == jprim).mean() >= 0.995
    same = (prim == jprim) & (jprim >= 0)
    np.testing.assert_allclose(u[same], ju[same], atol=1e-4)
    np.testing.assert_allclose(v[same], jv[same], atol=1e-4)
    assert ((prim >= 0) == np.isfinite(t)).all()


@pytest.mark.parametrize('caster', ['bvh', 'binned'])
def test_occlusion_matches_jax(soup_scenes, caster):
    js, ps, (o, d) = soup_scenes
    n = o.shape[0]
    rng = np.random.default_rng(5)
    tn = np.full(n, 1e-3, np.float32)
    tf = rng.uniform(0.5, 4.0, n).astype(np.float32)
    if caster == 'bvh':
        want = jax.vmap(lambda o_, d_, f_: JBVH.bvh_occluded(
            js, o_, d_, 1e-3, f_))(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tf))
        got = PBVH.bvh_occluded(ps, torch.from_numpy(o), torch.from_numpy(d),
                                1e-3, torch.from_numpy(tf))
    else:
        want = JIB.occluded_binned(js, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tn), jnp.asarray(tf))
        got = PIB.occluded_binned(ps, torch.from_numpy(o),
                                  torch.from_numpy(d), torch.from_numpy(tn),
                                  torch.from_numpy(tf))
    want = np.asarray(want)
    assert 0.02 < want.mean() < 0.98
    assert (got.numpy() == want).all()


def test_casters_agree_within_the_port(soup_scenes):
    """BVH traversal and the binned caster find the same hits."""
    _, ps, (o, d) = soup_scenes
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t, prim, _, _ = PBVH.bvh_traverse(ps, o, d, 0.0, float('inf'))
    bt, bprim, _, _ = PIB.intersect_binned(ps, o, d, 0.0, float('inf'))
    _close(t, bt)
    assert (prim == bprim).float().mean() >= 0.995
