"""The general engine's casts and hit records against lajolla_tpu.

Rays are made with numpy from a seed (testing.random_lanes: origins in
and around each scene, uniform directions). Both sides read the same
compiled tables (bridge.py).

- The port's plain casters (the plain forms of kernel K3, which the
  wrappers run for CPU tensors) against `_brute_force_batched` /
  `_occluded_batched`, and against lajolla_tpu's Pallas kernel
  (`intersect_brute_pallas`, `occluded_brute_pallas`) run in interpret
  mode: prim ids agree on >= 99.9% of rays, and t, u, v to rtol 1e-5
  where they agree on a hit (JAX contracts with a HIGHEST-precision
  matmul, the port with products added left to right: a last-bit
  difference can move a hit on a shared edge).
- The same plain casters against lajolla_tpu's on hand-written Woop rows
  and rays made to sit on the test's edges (adversarial_table /
  adversarial_rays): prims and occlusion equal on every ray.
- `intersect_scene` hit records against `jax.vmap(intersect_scene)`:
  ids agree on >= 99.9% of rays, and where both hit the same prim, every
  float field agrees to rtol / atol 1e-5 (the frame 1e-4, FRAME_TOL) on
  >= 99.9% of them.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import lajolla_tpu.ops.intersect as JI
import lajolla_tpu.ops.intersect_pallas as JIP
import lajolla_tpu.scene.compile as JC
import lajolla_tpu.scene.geometry as JG
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch import kernels
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.ops.intersect import (_brute_force_batched,
                                             _occluded_batched)
from lajolla_tpu_torch.scene import geometry as PG
from lajolla_tpu_torch.scene import types as T

from torch_threads import one_thread  # noqa: F401

RAYS = 4096
EPS = 1e-4


FIXTURES = {
    'glass_cbox': lambda: PT.cornell_box_builder(32, variant='glass'),
    'sphere_lights': lambda: PT.sphere_light_builder(32),
    'furnace': lambda: PT.furnace_builder(),
    'textured': PT.textured_builder,
}


def rays(ps, seed, far=None):
    lanes = PT.random_lanes(ps, RAYS, seed)
    o, d = lanes['org'].T.copy(), lanes['dir'].T.copy()
    rng = np.random.default_rng(seed + 100)
    tfar = (rng.uniform(0.05, 3.0, RAYS) if far else
            np.full(RAYS, np.inf)).astype(np.float32)
    return o, d, np.full(RAYS, EPS, np.float32), tfar


def assert_casts_agree(got, want):
    gt, gp, gu, gv = (np.asarray(x) for x in got)
    wt, wp, wu, wv = (np.asarray(x) for x in want)
    same = gp == wp
    assert same.mean() >= 0.999, same.mean()
    hit = same & (wp >= 0)
    assert hit.mean() > 0.1
    assert np.isinf(gt[same & (wp < 0)]).all()
    for g, w in ((gt, wt), (gu, wu), (gv, wv)):
        np.testing.assert_allclose(g[hit], w[hit], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('fixture', ['glass_cbox', 'sphere_lights'])
def test_plain_casters_match_jax(fixture):
    js = JC.compile_scene(FIXTURES[fixture]())
    ps = to_port(js)
    o, d, tn, tf = rays(ps, 1)
    want = JI._brute_force_batched(js, o, d, tn, tf)
    t = [torch.from_numpy(x) for x in (o, d, tn, tf)]
    got = _brute_force_batched(ps, *t)
    assert_casts_agree(got, want)
    # the wrapper of K3 runs the plain form on CPU tensors
    for g, w in zip(kernels.intersect_brute(ps, *t), got):
        assert torch.equal(g, w)

    o, d, tn, tf = rays(ps, 2, far=True)
    t = [torch.from_numpy(x) for x in (o, d, tn, tf)]
    want = np.asarray(JI._occluded_batched(js, o, d, tn, tf))
    got = _occluded_batched(ps, *t).numpy()
    assert (got == want).mean() >= 0.999
    assert want.any() and not want.all()
    assert torch.equal(kernels.occluded_brute(ps, *t), torch.from_numpy(got))
    assert all(v == 0 for v in kernels.LAUNCHES.values())


@pytest.mark.parametrize('fixture', ['glass_cbox', 'sphere_lights'])
def test_casters_match_pallas_interpret(fixture, monkeypatch):
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    js = JC.compile_scene(FIXTURES[fixture]())
    ps = to_port(js)
    o, d, tn, tf = rays(ps, 3)
    want = JIP.intersect_brute_pallas(js, jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(tn), jnp.asarray(tf))
    got = kernels.intersect_brute(ps, *(torch.from_numpy(x)
                                        for x in (o, d, tn, tf)))
    assert_casts_agree(got, want)

    o, d, tn, tf = rays(ps, 4, far=True)
    want = np.asarray(JIP.occluded_brute_pallas(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tn),
        jnp.asarray(tf)))
    got = kernels.occluded_brute(ps, *(torch.from_numpy(x)
                                       for x in (o, d, tn, tf))).numpy()
    assert (got == want).mean() >= 0.999


def _woop_row(ax, bx, ay, by, az, bz):
    """A prim's 12 Woop entries [x row, bias | y | z]."""
    return [*ax, bx, *ay, by, *az, bz]


# (rows, quad flag): u = x, v = y on the plane z = 0 and its neighbours
ADVERSARIAL_PRIMS = (
    (_woop_row((1, 0, 0), 0, (0, 1, 0), 0, (0, 0, 1), 0), 0),    # x + y <= 1
    (_woop_row((-1, 0, 0), 1, (0, -1, 0), 1, (0, 0, 1), 0), 0),  # x + y >= 1
    (_woop_row((1, 0, 0), -2, (0, 1, 0), 0, (0, 0, 1), -0.5), 1),  # quad
    (_woop_row((0.5, 0, 0), 0.5, (0, 0.5, 0), 0.5, (0, 0, 1), 0.5), 0),
    (_woop_row((1, 0, 0), 0, (0, 1, 0), 0, (0, 0, 1), 0), 0),    # copy of 0
    (_woop_row((1, 0, 0), -1, (0, 1, 0), 0, (0.5, 0, 1), -0.25), 0),  # tilt
    (_woop_row((1, 0, 0), 0, (0, 1, 0), 0, (0, 0, -1), 1.0), 0),  # -z, z 1
)


def adversarial_table():
    """The cast table of ADVERSARIAL_PRIMS (exact entries: two triangles
    of one plane that share an edge, an exact copy of the first, a quad
    whose back half remaps to its partner, planes in front of and behind
    the origins, a tilted plane, a z row of negative sign) as both
    packages' brute forces read it, the occluder table the same."""
    w = np.array([r for r, _ in ADVERSARIAL_PRIMS], np.float32)
    T = len(ADVERSARIAL_PRIMS)
    A = np.concatenate([w[:, 0:3].T, w[:, 4:7].T, w[:, 8:11].T], 1)
    b = np.concatenate([w[:, 3], w[:, 7], w[:, 11]])
    quad = np.array([q for _, q in ADVERSARIAL_PRIMS], np.float32)
    return dict(tri_woop_A=A, tri_woop_b=b, tri_woop_A_occ=A,
                tri_woop_b_occ=b, fp_woop=w, fp_woop_occ=w, cast_quad=quad,
                cast_occ_quad=quad,
                cast_src=np.arange(10, 10 + T, dtype=np.int32),
                cast_alt=np.arange(20, 20 + T, dtype=np.int32))


def adversarial_rays(seed, n=6144):
    """(o, d, tnear, tfar) float32 from `seed`: tnear = 0, -0.0, < 0 (hits
    behind the origin count) and NaN; origins on a plane (oz = 0 exactly);
    dz = 0, -0.0, +-1e-12 and its neighbours; rays straight down onto the
    shared edge; NaN origins and directions."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-0.5, 3.5, n), rng.uniform(-0.5, 1.5, n),
                  rng.choice([-1.0, -0.5, 0.0, 0.25, 0.5, 1.0, 2.0, 0.0],
                             n)], -1)
    free = rng.random(n) < 0.25          # origins off the planes too
    o[free, 2] = rng.uniform(-1.5, 2.5, free.sum())
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tiny = np.float32(1e-12)
    dz = np.array([0.0, -0.0, tiny, -tiny, np.nextafter(tiny, np.float32(1)),
                   -np.nextafter(tiny, np.float32(1)),
                   np.nextafter(tiny, np.float32(0)), 1e-30, -1.0, 1.0],
                  np.float32)
    pick = rng.random(n) < 0.2
    d[pick, 2] = rng.choice(dz, pick.sum())
    # rays straight down onto the shared edge x + y = 1 of prims 0 and 1
    edge = rng.random(n) < 0.1
    x = rng.integers(0, 9, edge.sum()) / 8.0
    o[edge] = np.stack([x, 1.0 - x, np.ones(edge.sum())], -1)
    d[edge] = (0.0, 0.0, -1.0)
    tn = rng.choice(np.array([0.0, -0.0, -1.0, -0.25, 1e-4, 0.3],
                             np.float32), n)
    tf = rng.choice(np.array([np.inf, 0.75, 3.0, 1.0], np.float32), n)
    nan = rng.random(n) < 0.02
    o[nan & (rng.random(n) < 0.5), 1] = np.nan
    d[nan & (rng.random(n) < 0.5), 2] = np.nan
    tn[rng.random(n) < 0.01] = np.nan
    return tuple(x.astype(np.float32) for x in (o, d, tn, tf))


@pytest.mark.parametrize('any_hit', [False, True], ids=['closest', 'any'])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_plain_casters_on_adversarial_rays_match_jax(seed, any_hit):
    """Both packages' brute forces on adversarial_table and
    adversarial_rays: prims (closest hit) or occlusion (any hit) equal on
    every ray, t, u, v to rtol 1e-5 on every hit; the wrapper of K3 runs
    the plain form on CPU tensors. The cases are there: the edge's tie
    won by the lower index, hits behind the origin, quad back halves,
    misses."""
    tab = adversarial_table()
    ps = types.SimpleNamespace(**{k: torch.from_numpy(v)
                                  for k, v in tab.items()})
    js = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in tab.items()})
    rays_ = adversarial_rays(seed)
    t_ = [torch.from_numpy(x) for x in rays_]
    j_ = [jnp.asarray(x) for x in rays_]
    if any_hit:
        got = _occluded_batched(ps, *t_).numpy()
        assert (got == np.asarray(JI._occluded_batched(js, *j_))).all()
        assert got.any() and not got.all()
        assert torch.equal(kernels.occluded_brute(ps, *t_),
                           torch.from_numpy(got))
        return
    got = _brute_force_batched(ps, *t_)
    t, prim, u, v = (x.numpy() for x in got)
    wt, wprim, wu, wv = (np.asarray(x) for x in
                         JI._brute_force_batched(js, *j_))
    assert (prim == wprim).all()
    hit = prim >= 0
    assert np.isinf(t[~hit]).all()
    for g, w in ((t, wt), (u, wu), (v, wv)):
        np.testing.assert_allclose(g[hit], w[hit], rtol=1e-5, atol=1e-6)
    for g, w in zip(kernels.intersect_brute(ps, *t_), got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())  # NaN == NaN
    # an edge ray starts on the z = 1 plane: with tnear < 0 it hits it at
    # t = 0, else prims 0, 1 and 4 at t = 1, where prim 0 wins the tie
    o, d, tn, tf = rays_
    on_edge = (d[:, 2] == -1.0) & (o[:, 2] == 1.0) & (o[:, 0] + o[:, 1] == 1.0)
    on_edge &= (tf > 1.0) & (tn < 1.0)
    assert (prim[on_edge & (tn >= 0)] == 10).all()
    assert (prim[on_edge & (tn < 0)] == 16).all()
    assert (on_edge & (tn >= 0)).any() and (on_edge & (tn < 0)).any()
    assert (hit & (t <= 0.0)).any()
    assert (prim == 20 + 2).any() and (prim == 10 + 2).any()
    assert (~hit).any()


def test_empty_triangle_set_never_hits():
    """The furnace has no triangles: the compiler pads the cast and
    occluder tables with one all-zero row, which must never be hit."""
    ps = PT.make_furnace_scene()
    assert ps.meta.num_triangles == 0 and ps.fp_woop.shape == (1, 12)
    o, d, tn, tf = (torch.from_numpy(x) for x in rays(ps, 5))
    t, prim, _, _ = kernels.intersect_brute(ps, o, d, tn, tf)
    assert torch.isinf(t).all() and (prim == -1).all()
    assert not kernels.occluded_brute(ps, o, d, tn, tf).any()


@pytest.mark.parametrize('wrapper,table', [('intersect_brute', 'fp_woop'),
                                           ('occluded_brute', 'fp_woop_occ')])
def test_k3_wrappers_refuse_tables_off_the_ray_device(wrapper, table):
    """Rays off the CPU with the scene's tables on it: the wrapper names
    the table and raises before it builds or launches anything."""
    ps = PT.make_furnace_scene()
    o = torch.zeros((8, 3), device='meta')
    t = torch.zeros(8, device='meta')
    with pytest.raises(ValueError, match=table):
        getattr(kernels, wrapper)(ps, o, o, t, t)
    assert kernels._libs is None


def test_general_rays_on_the_cpu():
    """testing.general_rays (the rays K3 is held against on the card) at a
    small film: camera, bounce and shadow rays, one per pixel, contiguous
    float32 on the scene's device, unit directions; most paths bounce."""
    ps = PT.make_cornell_box(16, variant='glass')
    rs = PT.general_rays(ps, seed=3)
    assert sorted(rs) == ['bounce', 'camera', 'shadow']
    for o, d, tn, tf in rs.values():
        for x, shape in ((o, (256, 3)), (d, (256, 3)), (tn, (256,)),
                         (tf, (256,))):
            assert x.shape == shape and x.dtype == torch.float32
            assert x.is_contiguous() and x.device.type == 'cpu'
        torch.testing.assert_close(d.norm(dim=-1), torch.ones(256),
                                   rtol=0, atol=1e-5)
        assert (tf > tn).all()
    moved = (rs['bounce'][0] != rs['camera'][0]).any(-1).float().mean()
    assert moved > 0.5


# A sphere's tangent is dp/du projected onto the tangent plane, with
# dp/du from sin/cos of the hit's angles: where dp/du is nearly normal,
# the projection amplifies a last-bit difference between torch's and
# XLA's sin/cos to ~3e-5 (0.3% of sphere hits measured on the CPU).
FRAME_TOL = 1e-4
HIT_FLOATS = ('t', 'position', 'geometry_normal', 'frame', 'uv', 'st',
              'mean_curvature', 'inv_uv_size', 'footprint')
HIT_IDS = ('valid', 'prim_id', 'shape_id', 'material_id', 'light_id',
           'interior_med', 'exterior_med')


@pytest.mark.parametrize('fixture', list(FIXTURES))
def test_intersect_scene_matches_jax(fixture):
    js = JC.compile_scene(FIXTURES[fixture]())
    ps = to_port(js)
    o, d, tn, tf = rays(ps, 6)
    rng = np.random.default_rng(7)
    radius = rng.uniform(0.0, 0.05, RAYS).astype(np.float32)
    spread = rng.uniform(0.0, 0.01, RAYS).astype(np.float32)
    want = jax.jit(jax.vmap(
        lambda o, d, r, s: JG.intersect_scene(js, o, d, EPS, jnp.inf, r, s)))(
        o, d, radius, spread)
    got = PG.intersect_scene(ps, torch.from_numpy(o), torch.from_numpy(d),
                             EPS, float('inf'), torch.from_numpy(radius),
                             torch.from_numpy(spread))
    same = np.ones(RAYS, bool)
    for k in HIT_IDS:
        agree = np.asarray(getattr(want, k)) == getattr(got, k).numpy()
        assert agree.mean() >= 0.999, (k, agree.mean())
        same &= agree
    both = same & np.asarray(want.valid)
    assert both.mean() > 0.1
    ok = np.ones(RAYS, bool)
    for k in HIT_FLOATS:
        g = getattr(got, k).numpy().reshape(RAYS, -1)
        w = np.asarray(getattr(want, k)).reshape(RAYS, -1)
        tol = FRAME_TOL if k == 'frame' else 1e-5
        ok &= np.isclose(g, w, rtol=tol, atol=tol).all(axis=1)
    assert ok[both].mean() >= 0.999, ok[both].mean()


# ---------------------------------------------------------------------------
# The device helpers under the hit records: vector math, samplers, camera
# (same inputs, rtol 1e-5 / atol 1e-6; indices exactly)
# ---------------------------------------------------------------------------

def _vecs(seed, n=4096):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(4, n, 3))
    unit = v / np.linalg.norm(v, axis=-1, keepdims=True)
    return (v.astype(np.float32), unit.astype(np.float32),
            rng.uniform(0.6, 1.8, n).astype(np.float32))


# fn(math module, intersect module, vectors (4, N, 3), unit vectors,
# positive scalars (N,))
MATH = {
    'dot': lambda M, I, v, u, e: M.dot(v[0], v[1]),
    'cross': lambda M, I, v, u, e: M.cross(v[0], v[1]),
    'normalize': lambda M, I, v, u, e: M.normalize(v[0]),
    'coordinate_system': lambda M, I, v, u, e: M.coordinate_system(u[0]),
    'to_local': lambda M, I, v, u, e: M.to_local(M.make_frame(u[0]), v[1]),
    'to_world': lambda M, I, v, u, e: M.to_world(M.make_frame(u[0]), v[1]),
    'reflect': lambda M, I, v, u, e: M.reflect(u[0], u[1]),
    'refract': lambda M, I, v, u, e: M.refract(u[0], u[1], e),
    'luminance': lambda M, I, v, u, e: M.luminance(e[:, None] * u[0]),
    'ray_triangle': lambda M, I, v, u, e: I.ray_triangle(
        v[0], u[1], v[1], v[2], v[3], 1e-4, 10.0),
    'ray_sphere': lambda M, I, v, u, e: I.ray_sphere(v[0], u[1], v[1], e,
                                                     1e-4, 10.0),
}


def _assert_outputs_close(got, want, where=None):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if where is not None:
            g, w = g[where], w[where]
        if w.dtype == bool or w.dtype.kind == 'i':
            assert np.array_equal(g, w)
        else:
            fin = np.isfinite(w)
            assert np.array_equal(fin, np.isfinite(g))
            np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('fn', list(MATH))
def test_vector_math_matches_jax(fn):
    import lajolla_tpu.core.math as JMATH
    import lajolla_tpu_torch.core.math as PMATH
    import lajolla_tpu_torch.ops.intersect as PI
    v, u, e = _vecs(8)
    want = MATH[fn](JMATH, JI, *(jnp.asarray(x) for x in (v, u, e)))
    got = MATH[fn](PMATH, PI, *(torch.from_numpy(x) for x in (v, u, e)))
    where = None
    if fn.startswith('ray_'):
        # t, u, v of a miss are never read (and ill-conditioned where the
        # ray grazes the triangle's plane); the hit bits agree exactly
        assert np.array_equal(got[-1].numpy(), np.asarray(want[-1]))
        where = np.asarray(want[-1])
    _assert_outputs_close(got, want, where)


@pytest.mark.parametrize('sampler,size', [
    ('sample_cdf', 64), ('sample_cdf', 1000), ('sample_segmented', 300),
    ('sample_cdf_2d', 24), ('sample_alias', 500)])
def test_device_samplers_match_jax(sampler, size):
    import lajolla_tpu.core.distribution as JD
    import lajolla_tpu_torch.core.distribution as PD
    rng = np.random.default_rng(9)
    w = rng.random(size) * (rng.random(size) > 0.2)
    u = rng.random((RAYS, 2)).astype(np.float32)
    if sampler == 'sample_cdf':
        tab = (PD.build_cdf_1d(w)[1].astype(np.float32),)
        args, axes = (u[:, 0],), (None, 0)
    elif sampler == 'sample_segmented':
        tab = (PD.build_segmented_cdf(w, [0, 100, 250], [100, 150, 50])[1]
               .astype(np.float32),)
        args = (rng.integers(0, 3, RAYS).astype(np.int32), u[:, 0])
        axes = (None, 0, 0)
    elif sampler == 'sample_cdf_2d':
        d2 = PD.build_cdf_2d(rng.random((size, 2 * size)))
        tab = (d2['marg_cdf'].astype(np.float32),
               d2['cond_cdf'].astype(np.float32))
        args, axes = (u,), (None, None, 0)
    else:
        tab = (PD.build_alias(w),)
        args, axes = (u[:, 0], u[:, 1]), (None, 0, 0)
    want = jax.vmap(getattr(JD, sampler), in_axes=axes)(
        *(jnp.asarray(x) for x in tab), *args)
    got = getattr(PD, sampler)(*(torch.from_numpy(x) for x in tab + args))
    if sampler != 'sample_alias' and sampler != 'sample_cdf_2d':
        got, want = (got.to(torch.int32),), (want,)
    else:
        got = (got[0].to(torch.int32),) + tuple(got[1:])
    _assert_outputs_close(got, tuple(want) if isinstance(want, tuple)
                          else want)


@pytest.mark.parametrize('filter_type,filter_param', [
    (T.FILTER_BOX, 1.0), (T.FILTER_TENT, 2.0), (T.FILTER_GAUSSIAN, 0.5)],
    ids=['box', 'tent', 'gaussian'])
def test_primary_hash_matches_jax(filter_type, filter_param):
    """The general engine's camera rays (camera.sample_primary through
    path._primary_hash)."""
    import lajolla_tpu.integrators.path as JPATH
    from lajolla_tpu.scene.types import RenderOptions as JOptions
    import lajolla_tpu_torch.integrators.path as PPATH
    from lajolla_tpu_torch.scene.types import RenderOptions
    js = JC.compile_scene(PT.cornell_box_builder(48, variant='glass'))
    ps = to_port(js)
    item = np.arange(48 * 48, dtype=np.int64) + 5 * 48 * 48
    kw = dict(filter_type=filter_type, filter_param=filter_param)
    seed = 12345
    want = JPATH._primary_hash(js, JOptions(**kw),
                               jnp.asarray(item.astype(np.int32)),
                               jnp.uint32(seed))
    got = PPATH._primary_hash(ps, RenderOptions(**kw),
                              torch.from_numpy(item), seed)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
