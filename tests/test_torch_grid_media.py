"""Heterogeneous (grid) media in the port against lajolla_tpu on the CPU:
the grid sections of the compiler, the .vol writer, the grid volume
lookups and the supervoxel majorant DDA, the flat event machine
(`volpath._advance_event`) and the general engine's films. The scenes are
testing.cornell_box_builder's heterogeneous variants with a 32x32x16
density grid ('hetvol', 'hetvol_hg': wispy, inside K9's class;
'hetvol_smooth': positive everywhere, so that the supervoxel minorants
are nonzero and the engine takes residual ratio tracking), carried across
through bridge.py, so both sides start from the same tables and draw the
same counter-hash random numbers.

- Compile: every table and the SceneMeta byte for byte, from the builder
  and from the XML (whose grid is a .vol file) through both parsers; the
  supervoxel divisor of the full 128x128x50 grid (256 rows).
- Media: `lookup_volume`, `get_majorant`, `get_sigma_s`, `get_sigma_a`
  and `_majorant_segment` on numpy-seeded points and rays at rtol 1e-6.
- The event machine: one `_advance_event` on testing.random_event_lanes
  through testing.assert_advance_agrees (>= 99.9% of lanes), the discrete
  state equal on >= 99.9% of lanes.
- Films of `_render_volpath_block` at 64x32 x 1 spp: median per-pixel
  relative difference < 1e-4, means within 1%, the same iteration count;
  for 'hetvol', 'hetvol_smooth' and a heterogeneous medium of constant
  volumes (which takes `_advance_vol_lane` and its tracking loop).

The tests run with one torch thread (`one_thread`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lajolla_tpu.integrators.media as JM
import lajolla_tpu.integrators.volpath as JV
import lajolla_tpu.integrators.volpath_grid_kernel as JGK
import lajolla_tpu.io.vol as JVOLIO
import lajolla_tpu.scene.compile as JC
import lajolla_tpu.scene.parser as JP
from lajolla_tpu.scene.types import RenderOptions as JOptions
import lajolla_tpu_torch.integrators.media as PM
import lajolla_tpu_torch.integrators.volpath as PV
import lajolla_tpu_torch.integrators.volpath_grid_kernel as PGK
import lajolla_tpu_torch.scene.compile as PC
import lajolla_tpu_torch.scene.parser as PP
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.io.vol import load_vol
from lajolla_tpu_torch.scene import types as T
from lajolla_tpu_torch.scene.parser import MediumB, VolumeB
from lajolla_tpu_torch.scene.types import RenderOptions, Scene

from torch_threads import one_thread  # noqa: F401

GRID = (32, 32, 16)
FILM = (64, 32)
N = 4096
VOL = RenderOptions(integrator='volpath')
JVOL = JOptions(integrator='volpath')


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close_share(got, want, rtol, atol):
    """Share of lanes (leading axis) whose every component agrees."""
    ok = np.isclose(got, want, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(axis=1).mean()


def builder(variant, film=FILM, grid=GRID):
    return PT.cornell_box_builder(film, 1, variant=variant, grid_res=grid)


@pytest.fixture(scope='module', params=['hetvol', 'hetvol_smooth'])
def het(request):
    js = JC.compile_scene(builder(request.param))
    return request.param, js, to_port(js)


def _assert_same(js, ps):
    """Every tensor of the port's Scene equals lajolla_tpu's field."""
    assert dataclasses.asdict(ps.meta) == dataclasses.asdict(js.meta)
    for f in dataclasses.fields(Scene):
        if f.name == 'meta':
            continue
        j = np.asarray(getattr(js, f.name))
        p = getattr(ps, f.name).numpy()
        assert p.dtype == j.dtype and p.shape == j.shape, f.name
        assert np.array_equal(p, j), f.name


# (svox_ctrl, grid_kernel_ok, K9's class) of each heterogeneous variant
FLAGS = {'hetvol': (False, True, True), 'hetvol_hg': (False, True, True),
         'hetvol_smooth': (True, True, False)}


@pytest.mark.parametrize('variant', list(FLAGS))
def test_hetvol_compiles_as_jax(variant):
    js = JC.compile_scene(builder(variant))
    ps = PC.compile_scene(builder(variant))
    _assert_same(js, ps)
    m = ps.meta
    assert m.has_grid_volumes and m.num_media == 1
    assert (m.svox_ctrl, m.grid_kernel_ok, PGK.supports(m)) == FLAGS[variant]
    assert ps.fp_grid.shape == (GRID[2] * GRID[1], GRID[0])
    assert ps.volume_data.shape == (GRID[0] * GRID[1] * GRID[2], 24)
    # divisor 8 at 32x32x16: 4 x 4 x 2 supervoxels
    assert ps.svox_data.shape == (32, 8)


@pytest.mark.parametrize('variant', ['hetvol', 'hetvol_smooth'])
def test_hetvol_xml(tmp_path, variant):
    """The heterogeneous variants' XML (density.vol beside it): both parsers
    read the same tables, and cornell_box_builder builds them in code."""
    xml = PT.write_cornell_box_xml(str(tmp_path), FILM, 2, variant=variant,
                                   grid_res=GRID)
    assert (tmp_path / 'density.vol').exists()
    js, jopt = JP.parse_scene(xml)
    ps, popt = PP.parse_scene(xml)
    _assert_same(js, ps)
    assert dataclasses.asdict(popt) == dataclasses.asdict(jopt)
    assert popt.integrator == 'volpath' and popt.samples_per_pixel == 2
    assert ps.meta.camera_medium_id == -1
    _assert_same(js, PT.make_cornell_box(FILM, 2, variant, GRID))


def test_full_size_grid_tables_and_divisor():
    """The hetvol-768 grid (128x128x50): the grid tables and flags byte for
    byte, and the divisor search doubles to 16 (8 x 8 x 4 = 256
    supervoxel rows; 8 would give 16 x 16 x 7 = 1792 > 512)."""
    b = lambda: PT.cornell_box_builder(8, 1, variant='hetvol')  # noqa: E731
    js, ps = JC.compile_scene(b()), PC.compile_scene(b())
    for name in ('volume_data', 'svox_data', 'fp_grid', 'med_tab',
                 'vol_res', 'vol_offset', 'vol_pmin', 'vol_pmax',
                 'vol_maxval'):
        j, p = np.asarray(getattr(js, name)), getattr(ps, name).numpy()
        assert p.dtype == j.dtype and np.array_equal(p, j), name
    assert dataclasses.asdict(ps.meta) == dataclasses.asdict(js.meta)
    assert ps.svox_data.shape == (256, 8)
    assert ps.med_tab[0, PM.MT_SRES:PM.MT_SRES + 3].tolist() == [8, 8, 4]
    assert ps.fp_grid.shape == (50 * 128, 128)
    assert ps.meta.grid_kernel_ok and not ps.meta.svox_ctrl
    assert PGK.supports(ps.meta)


@pytest.mark.parametrize('channels', [1, 3])
def test_write_vol_round_trip(tmp_path, channels):
    """testing.write_vol writes what both .vol readers read back exactly."""
    rng = np.random.default_rng(channels)
    shape = (5, 6, 7) if channels == 1 else (5, 6, 7, 3)
    grid = rng.random(shape).astype(np.float32)
    pmin, pmax = (-1.0, -0.5, 0.25), (1.0, 0.5, 2.0)
    path = str(tmp_path / 'g.vol')
    PT.write_vol(path, grid, pmin, pmax)
    for load in (load_vol, JVOLIO.load_vol):
        v = load(path, target_channels=3)
        want = grid if channels == 3 else np.repeat(grid[..., None], 3, -1)
        assert np.array_equal(v['data'], want)
        assert v['res'] == (7, 6, 5)
        assert np.array_equal(v['pmin'], np.float32(pmin).astype(np.float64))
        assert np.array_equal(v['pmax'], np.float32(pmax).astype(np.float64))


@pytest.mark.parametrize('variant,expected', [
    ('hetvol', True), ('hetvol_hg', True), ('hetvol_smooth', False),
    ('vol', False)])
def test_supports(variant, expected):
    scene = PT.compile_scene(builder(variant))
    assert PGK.supports(scene.meta) is expected
    assert JGK.supports(scene.meta) is expected
    assert PV._use_grid_kernel(scene) is expected


def grid_points(rng, n, grow=0.2):
    """Points in the grid's box grown by `grow` of its size per side."""
    pmin, pmax = (np.asarray(x) for x in PT.hetvol_box())
    lo, hi = pmin - grow * (pmax - pmin), pmax + grow * (pmax - pmin)
    return (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)


def unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_grid_lookups_match_jax(het):
    """lookup_volume by volume id (grid density and constant albedo) and
    the medium coefficients, inside and outside the grid's box."""
    _, js, ps = het
    rng = np.random.default_rng(11)
    p = grid_points(rng, N)
    vid = rng.integers(0, 2, N).astype(np.int32)
    want = np.asarray(jax.vmap(lambda v, x: JM.lookup_volume(js, v, x))(
        vid, p))
    got = PM.lookup_volume(ps, t(vid), t(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    dens = got[vid == 0]
    assert (dens == 0).any() and (dens > 0).any()
    ids = np.where(rng.random(N) < 0.1, -1, 0).astype(np.int32)
    d = unit(rng, N)
    tfar = rng.uniform(0.01, 3.0, N).astype(np.float32)
    for name, jf, pf in (
            ('majorant', lambda m, o, dd, tf: JM.get_majorant(js, m, o, dd,
                                                               tf),
             lambda: PM.get_majorant(ps, t(ids), t(p), t(d), t(tfar))),
            ('sigma_s', lambda m, o, dd, tf: JM.get_sigma_s(js, m, o),
             lambda: PM.get_sigma_s(ps, t(ids), t(p))),
            ('sigma_a', lambda m, o, dd, tf: JM.get_sigma_a(js, m, o),
             lambda: PM.get_sigma_a(ps, t(ids), t(p)))):
        want = np.asarray(jax.vmap(jf)(ids, p, d, tfar))
        np.testing.assert_allclose(pf().numpy(), want, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_majorant_segment_matches_jax(het):
    """One supervoxel DDA step from points in and around the box, with the
    empty skip, at rtol 1e-6; majorant, control and t_end."""
    variant, js, ps = het
    rng = np.random.default_rng(12)
    o = grid_points(rng, N, grow=0.5)
    d = unit(rng, N)
    t_cur = rng.uniform(0.0, 1.0, N).astype(np.float32)
    t_hit = np.where(rng.random(N) < 0.2, np.inf,
                     t_cur + rng.uniform(0.0, 2.0, N)).astype(np.float32)
    ids = np.zeros(N, np.int32)
    jrow = jax.vmap(lambda m: JM.med_row(js, m))(ids)
    want = jax.vmap(lambda r, a, b, c, e: JV._majorant_segment(
        js, r, a, b, c, e))(jrow, o, d, t_cur, t_hit)
    got = PV._majorant_segment(ps, PM.med_row(ps, t(ids)), t(o), t(d),
                               t(t_cur), t(t_hit))
    for name, g, w in zip(('majorant', 'control', 't_end'), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    maj, ctrl, t_end = (x.numpy() for x in got)
    assert (maj[:, 0] == 0).any() and (maj[:, 0] > 0).any()
    assert np.isinf(t_end).any() and (t_end < t_hit).any()
    assert bool((ctrl[:, 0] > 0).any()) == (variant == 'hetvol_smooth')


@pytest.mark.parametrize('with_scatter', [True, False])
def test_free_flight_matches_jax(het, with_scatter):
    """The heterogeneous tracking loop of _free_flight (lajolla_tpu's
    while_loop) from points in the room, in the medium or in vacuum."""
    _, js, ps = het
    rng = np.random.default_rng(13)
    org = grid_points(rng, N, grow=0.5)
    d = unit(rng, N)
    hs = rng.integers(0, 1 << 32, N, dtype=np.uint64)
    med = np.where(rng.random(N) < 0.1, -1, 0).astype(np.int32)
    t_hit = np.where(rng.random(N) < 0.2, np.inf,
                     rng.uniform(0.05, 2.0, N)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda h, o, dd, m, th: JV._free_flight(
        js, JVOL, h, o, dd, m, th, with_scatter)))(
        hs.astype(np.uint32), org, d, med, t_hit)
    got = PV._free_flight(ps, VOL, t(hs.astype(np.int64)), t(org), t(d),
                          t(med), t(t_hit), with_scatter)
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    for k, name in enumerate(('trans', 'trans_dir_pdf', 'trans_nee_pdf')):
        assert close_share(got[k], want[k], 1e-4, 1e-6) >= 0.999, name
    assert close_share(got[4], want[4], 1e-4, 1e-6) >= 0.999, 'accum_t'
    for k, name in ((3, 'scatter'), (5, 'rounds')):
        assert (got[k] == want[k]).mean() >= 0.999, name
    assert got[5].max() > 2   # the loop runs several steps
    if with_scatter:
        assert got[3].any() and not got[3].all()


# the state's path outputs under testing.ADVANCE_RTOL's keys
ADVANCE_KEYS = dict(org='org', dir='d', thr='T', rad='L', dir_pdf='dir_pdf')
# The tracking step count and distance agree on >= 99.5% of lanes: a
# last-bit difference in a supervoxel exit distance adds or saves one
# zero-length step at the boundary (0.17% of lanes on 'hetvol_smooth',
# whose every supervoxel is occupied); the products it carries agree.
STEP_SHARE = dict(ff_it=0.995, ff_t=0.995)


def test_advance_event_matches_jax(het):
    _, js, ps = het
    lanes = PT.random_event_lanes(ps, VOL, N, seed=5)
    st = [lanes[k] for k in PV.EVENT_STATE]
    jst = [x.astype(PT.EVENT_STATE_JAX_DTYPES.get(k, x.dtype))
           for k, x in zip(PV.EVENT_STATE, st)]
    su = PV.stream_root(5)
    want, want_died = jax.jit(jax.vmap(lambda *s: JV._advance_event(
        js, JVOL, s, jnp.uint32(su))))(*jst)
    got, got_died = PV._advance_event(ps, VOL, tuple(t(x) for x in st), su)
    want = dict(zip(PV.EVENT_STATE, (np.asarray(x) for x in want)))
    got = dict(zip(PV.EVENT_STATE, (x.numpy() for x in got)))
    want_died, got_died = np.asarray(want_died), got_died.numpy()

    # every phase of the machine occurs in the fixture
    live = ~lanes['done']
    for ph in (PV.PH_CAST, PV.PH_FF, PV.PH_SHC, PV.PH_SHF):
        assert (lanes['ph'][live] == ph).any(), ph
    alive = ~got['done'] & ~got_died
    walive = ~want['done'] & ~want_died
    PT.assert_advance_agrees(
        {k: got[v].T for k, v in ADVANCE_KEYS.items()}, alive,
        {k: want[v].T for k, v in ADVANCE_KEYS.items()}, walive)
    assert (got_died == want_died).mean() >= 0.999
    both = alive & walive
    for k in PV.EVENT_STATE:
        g, w = got[k][both], want[k][both]
        if w.dtype.kind == 'f':
            share = close_share(g, w, 1e-4, 1e-5)
        else:
            share = (g.astype(np.int64) == w.astype(np.int64)).mean()
        assert share >= STEP_SHARE.get(k, 0.999), (k, share)
    assert (want['L'] != lanes['L']).any()
    assert (want['bounces'] != lanes['bounces']).any()


def assert_films_agree(got, want):
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert want.mean() > 1e-3
    rel = np.abs(got - want) / (want + 1e-3)
    assert np.median(rel) < 1e-4, np.median(rel)
    assert abs(got.mean() - want.mean()) / want.mean() < 0.01


def test_event_machine_film_matches_jax(het):
    """The general engine on a grid scene takes the event machine on both
    sides: lajolla_tpu's _render_volpath_block (its 2048 lanes) against the
    port's, 64x32 x 1 spp."""
    _, js, ps = het
    wf, _, witers = JV._render_volpath_block(js, JVOL, 0, 0, 1, None)
    gf, st, giters = PV._render_volpath_block(ps, VOL, 0, 0, 1)
    assert len(st) == len(PV.EVENT_STATE)
    assert_films_agree(gf.numpy(), np.asarray(wf))
    assert giters == int(witers)


def constant_het_builder():
    """The 'vol' Cornell box with its medium made heterogeneous over
    constant volumes (density 0.9, albedo 0.7): no grid volume, so the
    engine takes _advance_vol_lane, whose free flight runs the
    heterogeneous tracking loop under the one global majorant."""
    b = PT.cornell_box_builder(FILM, 1, variant='vol')
    b.volumes += [VolumeB(const=(0.9, 0.9, 0.9)),
                  VolumeB(const=(0.7, 0.7, 0.7))]
    b.media[0] = MediumB(type=T.MED_HETEROGENEOUS, density_vol=0,
                         albedo_vol=1)
    return b


def test_constant_volume_medium_film_matches_jax():
    js = JC.compile_scene(constant_het_builder())
    ps = to_port(js)
    assert not ps.meta.has_grid_volumes
    assert ps.meta.med_types_present == (T.MED_HETEROGENEOUS,)
    wf, _, witers = JV._render_volpath_block(js, JVOL, 0, 0, 1, None)
    gf, st, giters = PV._render_volpath_block(ps, VOL, 0, 0, 1)
    assert len(st) == len(PV.VOL_STATE)
    assert_films_agree(gf.numpy(), np.asarray(wf))
    assert giters == int(witers)
