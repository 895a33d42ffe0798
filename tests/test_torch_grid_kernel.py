"""The fused grid-media kernel K9 (integrators/volpath_grid_kernel.py) on
the CPU, where `render_fused_grid` runs its plain form: against
lajolla_tpu's `render_fused_grid` in Pallas interpret mode with its f32
density (GRID_BF16 off: the port reads an f32 grid), against the port's
own general engine, and through render() and the CLI. The scenes are
testing.cornell_box_builder's heterogeneous variants with a 32x32x16
density grid.

- The films of 'hetvol' at 64x32 x 1 spp (n = 2048, one whole BLOCK, so
  no padding lanes: K9 and the event machine draw the same numbers; the
  density layouts differ in summation order) from four renderers:
  lajolla_tpu's `render_fused_grid` in Pallas interpret mode and its
  `_render_volpath_block`, the port's K9 plain form and its event
  machine. Within a framework the two agree at lajolla_tpu's own gate
  (tests/test_grid_kernel.py): 95th percentile per-pixel relative
  difference < 1e-4, means within 1e-3. Across the frameworks (K9's
  plain form against the interpret-mode K9) the 95th percentile gate
  holds with means within 1%: a few percent of the paths decorrelate.
  XLA's CPU compiler contracts multiply-adds into FMAs, torch on the CPU
  (and K9, built with -fmad=false) rounds the multiply and the add
  apart. The two differ in the last bit from the first vertex on (the
  hit position o + t d: `test_jax_hit_positions_are_fused`), and a
  tracking loop turns a last-bit difference into a different step
  count, which shifts the path's later iteration-indexed draws. Those
  paths move the mean of a 2048-path film by more than 1e-3.
- The padded lane pool (48x48, 2304 pixels, pool 4096): film means within
  10% of the engine's, whose work items stride by n instead.
- render() on the CPU takes K9's plain form for 'hetvol' (the wrapper
  returns the plain form's film, bit for bit) and the event machine for
  'hetvol_smooth'; the CLI renders the 'hetvol' XML.

The tests run with one torch thread (`one_thread`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lajolla_tpu.integrators.volpath as JV
import lajolla_tpu.integrators.volpath_grid_kernel as JGK
import lajolla_tpu.scene.compile as JC
from lajolla_tpu.scene.types import RenderOptions as JOptions
import lajolla_tpu_torch.integrators.volpath as PV
import lajolla_tpu_torch.integrators.volpath_grid_kernel as PGK
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch import cli, render
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.io.image import imread3
from lajolla_tpu_torch.scene.types import RenderOptions

from torch_threads import one_thread  # noqa: F401

GRID = (32, 32, 16)
VOL = RenderOptions(integrator='volpath')
JVOL = JOptions(integrator='volpath')


def builder(variant, film=(64, 32), spp=1):
    return PT.cornell_box_builder(film, spp, variant=variant, grid_res=GRID)


def assert_gate(got, want, mean_tol=1e-3):
    """lajolla_tpu's K9 gate: p95 relative difference < 1e-4, means within
    mean_tol (1e-3)."""
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert want.mean() > 1e-3
    rel = np.abs(got - want) / (want + 1e-3)
    assert np.percentile(rel, 95) < 1e-4, np.percentile(rel, 95)
    assert abs(got.mean() - want.mean()) / want.mean() < mean_tol


@pytest.fixture(scope='module')
def films():
    """'hetvol' at 64x32 x 1 spp, (n, 3) each: lajolla_tpu's interpret
    K9 ('jax_k9') and event machine ('jax_engine'), the port's K9 plain
    form ('k9', with its work counters 'stats') and event machine
    ('engine')."""
    js = JC.compile_scene(builder('hetvol'))
    old = JGK.INTERPRET, JGK.GRID_BF16
    JGK.INTERPRET, JGK.GRID_BF16 = True, False
    try:
        jax_k9 = np.asarray(JGK.render_fused_grid(js, JVOL, 0, 0, 1))
    finally:
        JGK.INTERPRET, JGK.GRID_BF16 = old
    assert jax_k9.shape == (32, 64, 3)
    jax_engine = JV._render_volpath_block(js, JVOL, 0, 0, 1, None)[0]
    scene = to_port(js)
    stats = {}
    k9 = PGK.render_fused_grid_plain(scene, VOL, 0, 0, 1, stats=stats)
    assert k9.shape == (32, 64, 3)
    engine = PV._render_volpath_block(scene, VOL, 0, 0, 1)[0]
    return dict(jax_k9=jax_k9.reshape(-1, 3),
                jax_engine=np.asarray(jax_engine), k9=k9.numpy().reshape(
                    -1, 3), engine=engine.numpy(), stats=stats)


def test_grid_kernel_plain_matches_jax_interpret(films):
    assert_gate(films['k9'], films['jax_k9'], mean_tol=0.01)


def test_jax_grid_kernel_matches_its_engine(films):
    """lajolla_tpu's own pair holds the 1e-3 gate, as the port's does: only
    the cross-framework pairs need the 1% one."""
    assert_gate(films['jax_k9'], films['jax_engine'])


def test_jax_hit_positions_are_fused():
    """Why the gate above holds the means only within 1%: one event of
    lajolla_tpu's jitted event machine and of the port's, from the same
    fresh camera lanes. Each side's first-vertex position o + t d, with
    its own cast distance t: lajolla_tpu's is one FMA (one rounding) on
    every lane, the port's a multiply and an add (two roundings), and the
    two differ on most paths."""
    js = JC.compile_scene(builder('hetvol'))
    ps = to_port(js)
    n, su = 64 * 32, PV.stream_root(0)
    st = PV._fresh_state(ps, VOL, torch.arange(n), su, True) + (
        torch.zeros(n, dtype=torch.bool),)
    jst = [x.numpy() for x in st]
    jst = [x.astype(PT.EVENT_STATE_JAX_DTYPES.get(k, x.dtype))
           for k, x in zip(PV.EVENT_STATE, jst)]
    want = jax.jit(jax.vmap(lambda *s: JV._advance_event(
        js, JVOL, s, jnp.uint32(su))))(*jst)[0]
    got = PV._advance_event(ps, VOL, st, su)[0]
    o, d = st[1].numpy(), st[2].numpy()
    org, mc_t = PV.EVENT_STATE.index('org'), PV.EVENT_STATE.index('mc_t')
    differ = []
    for fused_side, out in ((False, [x.numpy() for x in got]),
                            (True, [np.asarray(x) for x in want])):
        t = out[mc_t]
        hit = np.isfinite(t)
        assert hit.mean() > 0.9
        # f32 * f32 is exact in f64: one rounding, as an FMA rounds
        fused = (o + t[:, None].astype(np.float64) * d).astype(np.float32)
        split = o + t[:, None] * d
        assert np.array_equal(out[org][hit],
                              (fused if fused_side else split)[hit])
        differ.append((fused[hit] != split[hit]).any(1).mean())
    assert min(differ) > 0.5


def test_grid_kernel_plain_matches_engine(films):
    """n = 2048 = BLOCK: K9's items are the engine's, so are its numbers.
    The plain form's counters see every kind of work."""
    assert_gate(films['k9'], films['engine'])
    stats = films['stats']
    assert stats['steps'] > 2
    assert stats['vertices'] >= 64 * 32    # at least one vertex per path
    assert stats['casts'] >= stats['vertices']
    assert stats['track_steps'] > 0


def test_grid_kernel_padded_lane_pool():
    """48x48 = 2304 pixels: a pool of 4096 lanes, 1792 of them padding,
    which start done and whose film rows are dropped. Items stride by the
    padded count, so the numbers differ from the engine's: agreement is
    statistical only (lajolla_tpu's gate)."""
    scene = PT.compile_scene(builder('hetvol', film=(48, 48)))
    assert PGK.padded_lanes(48 * 48) == 2 * PGK.BLOCK
    got = PGK.render_fused_grid_plain(scene, VOL, 0, 0, 1).numpy()
    engine = PV._render_volpath_block(scene, VOL, 0, 0, 1)[0].numpy()
    assert got.shape == (48, 48, 3) and np.isfinite(got).all()
    assert abs(got.mean() - engine.mean()) / engine.mean() < 0.10


def test_render_routes_grid_scenes(monkeypatch):
    """render() on the CPU: 'hetvol_hg' takes K9's wrapper, one launch per
    GRIDK_SPP_BLOCK samples, which returns the plain form's film bit for
    bit; 'hetvol_smooth' (outside K9's class) takes the event machine, one
    sample per pixel per block."""
    calls = []
    for mod, name in ((PGK, 'render_fused_grid'),
                      (PV, '_render_volpath_block')):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    monkeypatch.setattr(PV, 'GRIDK_SPP_BLOCK', 1)
    opts = RenderOptions(integrator='volpath', samples_per_pixel=2)
    scene = PT.make_cornell_box(16, 2, 'hetvol_hg', GRID)
    img = render(scene, opts, device='cpu', seed=3)
    assert calls == ['render_fused_grid'] * 2
    plain = PGK.render_fused_grid_plain(scene, VOL, 3, 0, 2).numpy()
    assert np.array_equal(img, plain / 2)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    calls.clear()
    img = render(PT.make_cornell_box(16, 2, 'hetvol_smooth', GRID), opts,
                 device='cpu')
    assert calls == ['_render_volpath_block'] * 2
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 1e-3


def test_cli_renders_hetvol_xml(tmp_path):
    xml = PT.write_cornell_box_xml(str(tmp_path), 32, 2, variant='hetvol',
                                   grid_res=GRID)
    out = str(tmp_path / 'hetvol.exr')
    assert cli.main([xml, '-o', out, '--device', 'cpu']) == 0
    img = imread3(out)
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    lum = (img @ np.array([0.212671, 0.715160, 0.072169])).mean()
    assert 0.005 < lum < 0.5, lum
