"""The final volumetric integrator for homogeneous media
(integrators/volpath.py, integrators/volpath_kernel.py) against
lajolla_tpu on the CPU. JAX scenes are carried across through bridge.py,
so both sides start from the same tables and draw the same counter-hash
random numbers.

- Free flight (main and NEE variants) and `_vol_nee` against `jax.vmap`
  of lajolla_tpu's per-lane forms on numpy-seeded lanes of the
  'vol_glass' Cornell box with testing.MEDIA_ZOO appended: >= 99.9% of
  lanes within rtol 1e-4 / atol 1e-6 (1e-5 for radiance), the discrete
  outputs equal on >= 99.9% of lanes.
- One bounce, `_advance_vol_lane`, on testing.random_vol_lanes of 'vol'
  and 'vol_glass': the gates of testing.assert_advance_agrees (died bits
  and every output on >= 99.9% of lanes, rtol 1e-4, dir_pdf rtol 1e-2).
- Films of `_render_volpath_block` (lajolla_tpu's with early_exit=False)
  at 64x64 x 4 spp on 'vol' and 'vol_glass': median per-pixel relative
  difference < 1e-4, means within 1e-3, the same loop iterations.
- The plain form of K8 (`render_fused_vol_plain`) against lajolla_tpu's
  `render_fused_vol` in Pallas interpret mode at 64x64 x 4 spp: 'vol' at
  median < 1e-4 and means within 1e-3; 'vol_hg' and the submerged sphere
  scene at lajolla_tpu's own statistical gates (median < 1e-4, 8x8-block
  RMS difference over the mean < 0.12, means within 1%).
- `supports` on every fixture; render() and the CLI on the CPU;
  versions 1 and 2 render through render(), a heterogeneous medium of
  constant volumes renders.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lajolla_tpu.integrators.volpath as JV
import lajolla_tpu.integrators.volpath_kernel as JVK
import lajolla_tpu.scene.compile as JC
import lajolla_tpu.scene.geometry as JG
from lajolla_tpu.scene.types import RenderOptions as JOptions
import lajolla_tpu_torch.integrators.volpath as PV
import lajolla_tpu_torch.integrators.volpath_kernel as PVK
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch import cli, render
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.dtypes import intersection_eps
from lajolla_tpu_torch.io.image import imread3
from lajolla_tpu_torch.scene import types as T
from lajolla_tpu_torch.scene.geometry import intersect_scene
from lajolla_tpu_torch.scene.parser import MediumB, VolumeB
from lajolla_tpu_torch.scene.types import RenderOptions

from torch_threads import one_thread  # noqa: F401

LANES = 1 << 13
VOL = RenderOptions(integrator='volpath')
JVOL = JOptions(integrator='volpath')


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close_share(got, want, rtol, atol):
    """Share of lanes (leading axis) whose every component agrees."""
    ok = np.isclose(got, want, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(axis=1).mean()


@pytest.fixture(scope='module')
def zoo():
    js = JC.compile_scene(PT.media_zoo_builder())
    return js, to_port(js)


def room_rays(n, seed):
    """Origins inside the Cornell box room and unit directions."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return rng, org, d


def test_bridge_carries_media_fields(zoo):
    """A lajolla_tpu scene carried across bridge.py holds the port's own
    compiled media tables, byte for byte."""
    _, bridged = zoo
    own = PT.compile_scene(PT.media_zoo_builder())
    assert bridged.meta == own.meta
    for name in ('med_tab', 'med_type', 'med_sigma_a', 'med_sigma_s',
                 'med_phase_type', 'med_g', 'med_albedo_vol',
                 'med_density_vol', 'vol_kind', 'vol_const', 'vol_offset',
                 'vol_res', 'vol_pmin', 'vol_pmax', 'vol_maxval',
                 'shape_interior_med', 'shape_exterior_med'):
        a, b = getattr(bridged, name), getattr(own, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert own.med_tab.shape == (2 + len(PT.MEDIA_ZOO), 46)


@pytest.mark.parametrize('with_scatter', [True, False])
def test_free_flight_matches_jax(zoo, with_scatter):
    js, ps = zoo
    rng, org, d = room_rays(LANES, 31)
    hs = rng.integers(0, 1 << 32, LANES, dtype=np.uint64)
    med = rng.integers(-1, ps.meta.num_media, LANES).astype(np.int32)
    t_hit = np.where(rng.random(LANES) < 0.2, np.inf,
                     rng.uniform(0.01, 6.0, LANES)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda h, o, dd, m, th: JV._free_flight(
        js, JVOL, h, o, dd, m, th, with_scatter)))(
        hs.astype(np.uint32), org, d, med, t_hit)
    got = PV._free_flight(ps, VOL, t(hs.astype(np.int64)), t(org), t(d),
                          t(med), t(t_hit), with_scatter)
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    for k, name in enumerate(('trans', 'trans_dir_pdf', 'trans_nee_pdf')):
        assert close_share(got[k], want[k], 1e-4, 1e-6) >= 0.999, name
    for k, name in ((3, 'scatter'), (5, 'rounds')):
        assert (got[k] == want[k]).mean() >= 0.999, name
    assert close_share(got[4], want[4], 1e-4, 1e-6) >= 0.999, 'accum_t'
    # the fixture reaches both outcomes and the zero-majorant guard
    assert (got[5] == 0).any() and (got[5] == 1).any()
    if with_scatter:
        assert got[3].any() and not got[3].all()


@pytest.mark.parametrize('max_depth', [-1, 3])
def test_vol_nee_matches_jax(zoo, max_depth):
    """One merged NEE sample from surface points and medium points, with
    shadow walks through the index-matching short box (the glass tall
    box blocks them)."""
    js, ps = zoo
    rng, org, d = room_rays(LANES, 32)
    eps = intersection_eps(ps.meta.scene_radius)
    radius = np.zeros(LANES, np.float32)
    spread = np.full(LANES, 1e-3, np.float32)
    jhit = jax.jit(jax.vmap(lambda o, dd, r, s: JG.intersect_scene(
        js, o, dd, eps, jnp.inf, r, s)))(org, d, radius, spread)
    phit = intersect_scene(ps, t(org), t(d), eps, float('inf'), t(radius),
                           t(spread))
    valid = phit.valid.numpy()
    assert np.array_equal(valid, np.asarray(jhit.valid))
    is_surface = valid & (rng.random(LANES) < 0.5)
    frac = rng.uniform(0.05, 0.95, LANES).astype(np.float32)
    p = np.where(is_surface[:, None], phit.position.numpy(),
                 org + d * (frac * np.where(valid, phit.t.numpy(), 1.0))
                 [:, None]).astype(np.float32)
    hb = rng.integers(0, 1 << 32, LANES, dtype=np.uint64)
    med = rng.integers(0, 2, LANES).astype(np.int32)
    bounces = rng.integers(0, 4, LANES).astype(np.int32)
    dir_view = -d
    want = np.asarray(jax.jit(jax.vmap(
        lambda h, pp, m, b, dv, s, hit: JV._vol_nee(
            js, JOptions(integrator='volpath', max_depth=max_depth), h, pp,
            m, b, dv, s, hit)))(hb.astype(np.uint32), p, med, bounces,
                               dir_view, is_surface, jhit))
    got = PV._vol_nee(ps, RenderOptions(integrator='volpath',
                                        max_depth=max_depth),
                      t(hb.astype(np.int64)), t(p), t(med),
                      t(bounces.astype(np.int64)), t(dir_view),
                      t(is_surface), phit).numpy()
    assert close_share(got, want, 1e-4, 1e-5) >= 0.999
    lit = want.max(axis=1) > 0
    assert lit[is_surface].mean() > 0.1 and lit[~is_surface].mean() > 0.1


ADVANCE_FIXTURES = ('vol', 'vol_glass')
# (rtol, atol) per output of one bounce (testing.ADVANCE_RTOL's gates).
VOL_TOL = dict(org=(1e-4, 1e-5), d=(1e-4, 1e-4), T=(1e-4, 1e-5),
               nee_p=(1e-4, 1e-5), multi_trans_pdf=(1e-4, 1e-5),
               eta_scale=(1e-4, 1e-5), spread=(1e-4, 1e-5),
               radius=(1e-4, 1e-5), dir_pdf=(1e-2, 1e-5))


@pytest.mark.parametrize('variant', ADVANCE_FIXTURES)
def test_advance_vol_lane_matches_jax(variant):
    js = JC.compile_scene(PT.cornell_box_builder(32, variant=variant))
    ps = to_port(js)
    lanes = PT.random_vol_lanes(ps, LANES, seed=41)
    st = [lanes[k] for k in PV.VOL_STATE]
    jst = [x.astype(np.int32) if k in ('item', 'bounces') else x
           for k, x in zip(PV.VOL_STATE, st)]
    su = PV.stream_root(7)
    want, want_died = jax.jit(jax.vmap(lambda *s: JV._advance_vol_lane(
        js, JVOL, s, jnp.uint32(su))))(*jst)
    got, got_died = PV._advance_vol_lane(ps, VOL, tuple(t(x) for x in st),
                                         su)
    want = dict(zip(PV.VOL_STATE, (np.asarray(x) for x in want)))
    got = dict(zip(PV.VOL_STATE, (x.numpy() for x in got)))
    want_died, got_died = np.asarray(want_died), got_died.numpy()

    for k in ('item', 'bounces', 'done'):
        assert np.array_equal(got[k], want[k]), k
    assert (got['medium'] == want['medium']).mean() >= 0.999
    assert (got_died == want_died).mean() >= 0.999
    done = lanes['done']
    goes_on = ~done & ~got_died & ~want_died
    assert 0.05 < goes_on.mean() < 0.95
    for k, (rtol, atol) in VOL_TOL.items():
        share = close_share(got[k][goes_on], want[k][goes_on], rtol, atol)
        assert share >= 0.999, (k, share)
    assert close_share(got['L'], want['L'], 1e-4, 1e-5) >= 0.999
    assert (want['L'] != lanes['L']).any()
    if variant == 'vol_glass':
        # medium transitions happen: glass refraction, pass-through
        assert (want['medium'] != lanes['medium']).any()
        assert (want['eta_scale'] != lanes['eta_scale']).any()


def assert_films_agree(got, want, mean_tol):
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert want.mean() > 1e-3
    rel = np.abs(got - want) / (want + 1e-3)
    assert np.median(rel) < 1e-4, np.median(rel)
    assert abs(got.mean() - want.mean()) / want.mean() < mean_tol


@pytest.mark.parametrize('variant', ADVANCE_FIXTURES)
def test_render_volpath_block_matches_jax(variant):
    js = JC.compile_scene(PT.cornell_box_builder(64, variant=variant))
    spp = 4
    wf, _, witers = JV._render_volpath_block(js, JVOL, 0, 0, spp, None,
                                             early_exit=False)
    gf, _, giters = PV._render_volpath_block(to_port(js), VOL, 0, 0, spp)
    assert_films_agree(gf.numpy() / spp, np.asarray(wf) / spp, 1e-3)
    assert giters == int(witers)


FUSED_FIXTURES = {
    'vol': lambda: PT.cornell_box_builder(64, variant='vol'),
    'vol_hg': lambda: PT.cornell_box_builder(64, variant='vol_hg'),
    'submerged_sphere': lambda: PT.submerged_sphere_builder(64),
}


@pytest.mark.parametrize('fixture', list(FUSED_FIXTURES))
def test_fused_vol_plain_matches_jax_interpret(fixture):
    js = JC.compile_scene(FUSED_FIXTURES[fixture]())
    spp = 4
    old = JVK.INTERPRET
    JVK.INTERPRET = True
    try:
        want = np.asarray(JVK.render_fused_vol(js, JVOL, 0, 0, spp)) / spp
    finally:
        JVK.INTERPRET = old
    got = PVK.render_fused_vol_plain(to_port(js), VOL, 0, 0, spp).numpy() \
        / spp
    if fixture == 'vol':
        assert_films_agree(got, want, 1e-3)
        return
    assert_films_agree(got, want, 0.01)
    a = got.reshape(8, 8, 8, 8, 3).mean((1, 3))
    b = want.reshape(8, 8, 8, 8, 3).mean((1, 3))
    assert np.sqrt(((a - b) ** 2).mean()) / b.mean() < 0.12


@pytest.mark.parametrize('fixture,expected', [
    ('vol', True), ('vol_hg', True), ('submerged_sphere', True),
    ('vol_glass', False), ('cbox', False), ('glass', False)])
def test_supports(fixture, expected):
    builders = dict(FUSED_FIXTURES,
                    vol_glass=lambda: PT.cornell_box_builder(
                        64, variant='vol_glass'),
                    cbox=lambda: PT.cornell_box_builder(64),
                    glass=lambda: PT.cornell_box_builder(64,
                                                         variant='glass'))
    scene = PT.compile_scene(builders[fixture]())
    assert PVK.supports(scene.meta) is expected
    assert JVK.supports(scene.meta) is expected
    assert PV._use_vol_kernel(scene) is expected


def test_render_routes_and_matches_engines(monkeypatch):
    """render() takes K8's plain form on a film of whole 4096-pixel
    blocks and the general engine otherwise; the two engines agree."""
    calls = []
    for name in ('render_fused_vol', '_render_volpath_block'):
        mod = PVK if name == 'render_fused_vol' else PV
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    opts = RenderOptions(integrator='volpath', samples_per_pixel=2)
    scene = PT.make_cornell_box(64, variant='vol')
    img = render(scene, opts, device='cpu')
    assert calls == ['render_fused_vol']
    engine = PV._render_volpath_block(scene, VOL, 0, 0, 2)[0].numpy()
    assert_films_agree(img.reshape(-1, 3), engine / 2, 1e-3)
    calls.clear()
    small = render(PT.make_cornell_box(24, variant='vol'), opts,
                   device='cpu')
    assert calls == ['_render_volpath_block']
    assert small.shape == (24, 24, 3) and np.isfinite(small).all()


def test_checkpoint_resume_equals_uninterrupted(tmp_path, monkeypatch):
    monkeypatch.setattr(PV, 'VOL_SPP_BLOCK', 2)
    scene = PT.make_cornell_box(16, variant='vol_glass')
    opts = lambda spp: RenderOptions(integrator='volpath',
                                     samples_per_pixel=spp)
    ck = str(tmp_path / 'ck.npz')
    full = render(scene, opts(4), device='cpu')
    render(scene, opts(2), device='cpu', checkpoint=ck)
    resumed = render(scene, opts(4), device='cpu', checkpoint=ck)
    assert np.array_equal(resumed, full)


def test_cli_renders_vol_xml(tmp_path):
    xml = PT.write_cornell_box_xml(str(tmp_path), 64, 4, variant='vol')
    out = str(tmp_path / 'vol.exr')
    assert cli.main([xml, '-o', out, '--device', 'cpu']) == 0
    img = imread3(out)
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    lum = (img @ np.array([0.212671, 0.715160, 0.072169])).mean()
    assert 0.005 < lum < 0.5, lum


@pytest.mark.parametrize('version', [1, 2])
def test_versions_1_and_2_render(version):
    """Versions 1 and 2 render through render() (the simple block;
    tests/test_torch_volpath_simple.py holds them against lajolla_tpu):
    finite, with the foggy room's mean luminance in range (single
    scattering lights it less than the final integrator does)."""
    opts = RenderOptions(integrator='volpath', vol_path_version=version)
    img = render(PT.make_cornell_box(16, variant='vol'), opts, device='cpu')
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    lum = (img @ np.array([0.212671, 0.715160, 0.072169])).mean()
    assert 0.001 < lum < 0.5, lum


def test_heterogeneous_medium_raises():
    """A heterogeneous medium of constant volumes compiles and no longer
    raises: render() takes the general engine, whose free flight runs the
    heterogeneous tracking loop (tests/test_torch_grid_media.py holds its
    films against lajolla_tpu's)."""
    b = PT.cornell_box_builder(8, variant='vol')
    b.volumes += [VolumeB(const=(1.0, 1.0, 1.0)),
                  VolumeB(const=(0.8, 0.8, 0.8))]
    b.media[0] = MediumB(type=T.MED_HETEROGENEOUS, density_vol=0,
                         albedo_vol=1)
    scene = PT.compile_scene(b)
    opts = RenderOptions(integrator='volpath', samples_per_pixel=2)
    img = render(scene, opts, device='cpu')
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    engine = PV._render_volpath_block(scene, opts, 0, 0, 2)[0].numpy()
    assert np.array_equal(img.reshape(-1, 3), engine / 2)
