"""Participating media and phase functions (integrators/media.py) against
lajolla_tpu's on the CPU.

- Per function, on numpy-seeded media ids, directions and uniforms of the
  'vol_glass' Cornell box with testing.MEDIA_ZOO appended (isotropic, HG
  g = -0.3, 0.8, -0.7, 5e-4, and a medium with zero red and green
  sigma_t), against `jax.vmap` of lajolla_tpu's per-lane form: the medium
  rows and coefficients bit for bit, the phase values to rtol 1e-5, the
  sampled directions to atol 1e-5, the medium transitions exactly.
- HG normalisation: the phase function integrates to 1 over the sphere
  (quadrature in cos theta), and the directions phase_sample draws fall
  into cos-theta bins as phase_pdf says (each bin within 5 sigma of its
  expected count).
- Heterogeneous media (the 'hetvol' Cornell box's grid medium): the
  coefficients and the volume lookups against lajolla_tpu's.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import lajolla_tpu.integrators.media as JM
import lajolla_tpu.scene.compile as JC
import lajolla_tpu_torch.integrators.media as PM
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.scene import types as T

from torch_threads import one_thread  # noqa: F401

N = 4096


@pytest.fixture(scope='module')
def scenes():
    js = JC.compile_scene(PT.media_zoo_builder())
    return js, to_port(js)


def unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_zoo_scene(scenes):
    _, ps = scenes
    assert ps.meta.num_media == 2 + len(PT.MEDIA_ZOO)
    assert set(ps.meta.phase_types_present) == {T.PHASE_ISOTROPIC,
                                                T.PHASE_HG}
    assert not ps.meta.uniform_medium


def test_coefficients_match_jax(scenes):
    js, ps = scenes
    rng = np.random.default_rng(3)
    ids = rng.integers(-1, ps.meta.num_media, N).astype(np.int32)
    o, d = rng.normal(size=(N, 3)).astype(np.float32), unit(rng, N)
    tfar = rng.uniform(0.1, 5.0, N).astype(np.float32)
    want_row = np.asarray(jax.vmap(lambda m: JM.med_row(js, m))(ids))
    got_row = PM.med_row(ps, t(ids)).numpy()
    assert np.array_equal(got_row, want_row)
    assert np.array_equal(got_row[ids < 0], np.broadcast_to(
        ps.med_tab[0].numpy(), got_row[ids < 0].shape))
    for name, jf, pf in (
            ('majorant', lambda m, o, d, tf: JM.get_majorant(js, m, o, d, tf),
             lambda: PM.get_majorant(ps, t(ids), t(o), t(d), t(tfar))),
            ('sigma_s', lambda m, o, d, tf: JM.get_sigma_s(js, m, o),
             lambda: PM.get_sigma_s(ps, t(ids), t(o))),
            ('sigma_a', lambda m, o, d, tf: JM.get_sigma_a(js, m, o),
             lambda: PM.get_sigma_a(ps, t(ids), t(o)))):
        want = np.asarray(jax.vmap(jf)(ids, o, d, tfar))
        assert np.array_equal(pf().numpy(), want), name


def test_phase_functions_match_jax(scenes):
    js, ps = scenes
    rng = np.random.default_rng(4)
    ids = rng.integers(0, ps.meta.num_media, N).astype(np.int32)
    wi, wo = unit(rng, N), unit(rng, N)
    u = rng.random((N, 2)).astype(np.float32)
    want_pdf = np.asarray(jax.vmap(
        lambda m, a, b: JM.phase_pdf(js, m, a, b))(ids, wi, wo))
    want_f = np.asarray(jax.vmap(
        lambda m, a, b: JM.phase_eval(js, m, a, b))(ids, wi, wo))
    want_dir = np.asarray(jax.vmap(
        lambda m, a, uu: JM.phase_sample(js, m, a, uu))(ids, wi, u))
    got_pdf = PM.phase_pdf(ps, t(ids), t(wi), t(wo)).numpy()
    got_f = PM.phase_eval(ps, t(ids), t(wi), t(wo)).numpy()
    got_dir = PM.phase_sample(ps, t(ids), t(wi), t(u)).numpy()
    np.testing.assert_allclose(got_pdf, want_pdf, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_f, want_f, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_dir, want_dir, rtol=0, atol=1e-5)
    # the prefetched-row form reads the same row
    row = PM.med_row(ps, t(ids))
    assert torch.equal(PM.phase_pdf(ps, t(ids), t(wi), t(wo), row=row),
                       torch.from_numpy(got_pdf))
    # every phase kind of the zoo occurs
    typ = ps.med_tab[:, PM.MT_PHASE].numpy()[ids]
    g = ps.med_tab[:, PM.MT_G].numpy()[ids]
    assert (typ == T.PHASE_ISOTROPIC).any() and (np.abs(g) > 0.5).any()
    assert ((typ == T.PHASE_HG) & (np.abs(g) < 1e-3)).any()


def test_update_medium_matches_jax():
    rng = np.random.default_rng(5)
    interior = rng.integers(-1, 3, N).astype(np.int32)
    exterior = np.where(rng.random(N) < 0.3, interior,
                        rng.integers(-1, 3, N)).astype(np.int32)
    normal, d = unit(rng, N), unit(rng, N)
    medium = rng.integers(-1, 3, N).astype(np.int32)

    def jax_update(i, e, n, dd, m):
        return JM.update_medium(types.SimpleNamespace(
            interior_med=i, exterior_med=e, geometry_normal=n), dd, m)
    want = np.asarray(jax.vmap(jax_update)(interior, exterior, normal, d,
                                           medium))
    hit = types.SimpleNamespace(interior_med=t(interior),
                                exterior_med=t(exterior),
                                geometry_normal=t(normal))
    got = PM.update_medium(hit, t(d), t(medium)).numpy()
    assert np.array_equal(got, want)
    assert (got != medium).any() and (got == medium).any()


def _hg_scene(g):
    """A one-row medium table: HG with asymmetry g (isotropic for None)."""
    row = torch.zeros((1, 46))
    row[0, PM.MT_PHASE] = T.PHASE_ISOTROPIC if g is None else T.PHASE_HG
    row[0, PM.MT_G] = 0.0 if g is None else g
    return types.SimpleNamespace(med_tab=row)


@pytest.mark.parametrize('g', [None, 0.0, 0.4, -0.3, 0.8, -0.7])
def test_phase_normalisation(g):
    """2 pi * integral of phase_pdf over cos theta in [-1, 1] is 1."""
    sc = _hg_scene(g)
    k = 200001
    c = np.linspace(-1.0, 1.0, k)
    wo = np.stack([np.sqrt(1 - c * c), np.zeros(k), c], -1).astype(np.float32)
    wi = np.broadcast_to(np.float32([0, 0, 1]), (k, 3)).copy()
    ids = torch.zeros(k, dtype=torch.int32)
    p = PM.phase_pdf(sc, ids, t(wi), t(wo)).double().numpy()
    integral = 2 * np.pi * np.trapezoid(p, c)
    assert abs(integral - 1.0) < 1e-4, integral
    f = PM.phase_eval(sc, ids, t(wi), t(wo)).double().numpy()
    assert np.array_equal(f, np.repeat(p[:, None], 3, 1))


@pytest.mark.parametrize('g', [None, 0.4, -0.7, 5e-4])
def test_phase_sample_histogram_matches_pdf(g):
    """Sampled directions: unit length, and their cos theta about dir_in
    falls into 40 bins as 2 pi * integral of phase_pdf over each bin
    predicts."""
    sc = _hg_scene(g)
    n = 1 << 18
    rng = np.random.default_rng(6)
    wi = unit(rng, n)
    u = rng.random((n, 2)).astype(np.float32)
    ids = torch.zeros(n, dtype=torch.int32)
    wo = PM.phase_sample(sc, ids, t(wi), t(u)).numpy()
    assert np.allclose(np.linalg.norm(wo, axis=1), 1.0, atol=1e-5)
    cos = np.clip((wi * wo).sum(1), -1.0, 1.0)
    edges = np.linspace(-1.0, 1.0, 41)
    counts, _ = np.histogram(cos, edges)
    fine = np.linspace(-1.0, 1.0, 40 * 200 + 1)
    z = np.zeros_like(fine, dtype=np.float32)
    wo_f = np.stack([np.sqrt(1 - fine * fine), z, fine], -1).astype(
        np.float32)
    wi_f = np.broadcast_to(np.float32([0, 0, 1]), wo_f.shape).copy()
    p = PM.phase_pdf(sc, torch.zeros(len(fine), dtype=torch.int32),
                     t(wi_f), t(wo_f)).double().numpy()
    mass = np.array([2 * np.pi * np.trapezoid(p[i * 200:(i + 1) * 200 + 1],
                                          fine[i * 200:(i + 1) * 200 + 1])
                     for i in range(40)])
    expected = n * mass
    assert np.all(np.abs(counts - expected) < 5 * np.sqrt(expected) + 5), \
        np.abs(counts - expected) / np.sqrt(expected)


def test_heterogeneous_media_raise(scenes):
    """Heterogeneous media no longer raise: on the 'hetvol' Cornell box
    (a 16x16x8 grid medium) the majorant, the coefficients and the raw
    volume sub-row lookup agree with lajolla_tpu's; on a scene with no
    grid volume the lookup is the sub-row's constant."""
    _, ps = scenes
    vrow = torch.arange(14.0)[None]
    assert torch.equal(PM.lookup_volume_vrow(ps, vrow, torch.zeros((1, 3))),
                       vrow[:, PM.VL_CONST:PM.VL_CONST + 3])
    js = JC.compile_scene(PT.cornell_box_builder(8, variant='hetvol',
                                                 grid_res=(16, 16, 8)))
    het = to_port(js)
    assert het.meta.med_types_present == (T.MED_HETEROGENEOUS,)
    rng = np.random.default_rng(7)
    ids = np.where(rng.random(N) < 0.1, -1, 0).astype(np.int32)
    p = rng.uniform(-1.0, 0.2, (N, 3)).astype(np.float32)
    d = unit(rng, N)
    tfar = rng.uniform(0.01, 3.0, N).astype(np.float32)
    for name, jf, pf in (
            ('majorant', lambda m, o, d, tf: JM.get_majorant(js, m, o, d, tf),
             lambda: PM.get_majorant(het, t(ids), t(p), t(d), t(tfar))),
            ('sigma_s', lambda m, o, d, tf: JM.get_sigma_s(js, m, o),
             lambda: PM.get_sigma_s(het, t(ids), t(p))),
            ('sigma_a', lambda m, o, d, tf: JM.get_sigma_a(js, m, o),
             lambda: PM.get_sigma_a(het, t(ids), t(p)))):
        want = np.asarray(jax.vmap(jf)(ids, p, d, tfar))
        got = pf().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
        assert (got > 0).any() and (got == 0).any(), name
    rows = PM.med_row(het, t(ids))[:, PM.MT_DLOOK:PM.MT_DLOOK + 14]
    want = np.asarray(jax.vmap(lambda r, x: JM.lookup_volume_vrow(js, r, x))(
        rows.numpy(), p))
    np.testing.assert_allclose(PM.lookup_volume_vrow(het, rows, t(p)).numpy(),
                               want, rtol=1e-6, atol=1e-7)
