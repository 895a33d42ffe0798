"""BSDFs and textures of the general engine against lajolla_tpu.

Random hit records and directions are made with numpy from a seed and
handed to both packages (lajolla_tpu's functions under jax.vmap), on the
glass Cornell box's tables: Lambertian with a constant and with a
checkerboard texture, RoughPlastic and RoughDielectric, dispatched over
the three present types as the engine dispatches them. Textures: the
constant and checkerboard descriptors of that scene and the image of
testing.textured_builder at random footprints (several mip levels).

Tolerances: rtol 1e-5 (atol 1e-6; 1e-5 for unit directions), except on two ill-conditioned sets of
lanes, which get rtol 1e-2 and must stay under 3% of the lanes:
- eval and pdf of the microfacet BSDFs within cos(n, h) > 0.98 of the
  GGX peak, for the reason testing.ADVANCE_RTOL gives: there D divides by
  a quantity formed by cancellation (~alpha^2), so a last-bit difference
  in the order of fp32 operations grows ~1/alpha^2 (up to 6e-4 relative
  measured on the CPU, on 0.1% of lanes);
- sampled directions with u0 > 0.98, the rim of the VNDF disk, where
  sqrt(1 - t1^2 - t2^2) cancels (up to 4e-4 relative).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lajolla_tpu.materials as JM
import lajolla_tpu.scene.compile as JC
import lajolla_tpu.scene.geometry as JG
import lajolla_tpu.scene.texeval as JTE
import lajolla_tpu_torch.materials as PM
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.scene import geometry as PG
from lajolla_tpu_torch.scene import texeval as PTE
from lajolla_tpu_torch.scene import types as T

from torch_threads import one_thread  # noqa: F401

N = 8192


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _frame(nrm):
    """Rows (t, b, n), the Frisvad basis of core/math.coordinate_system."""
    x, y, z = nrm.T
    sign = np.where(z >= 0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = x * y * a
    t = np.stack([1.0 + sign * x * x * a, sign * b, -sign * x], -1)
    bt = np.stack([b, sign + y * y * a, -y], -1)
    return np.stack([t, bt, nrm], axis=1)


def random_hits(n, seed, mat_id):
    """Hit fields for n lanes: geometric normal, a shading normal tilted
    off it, its frame, uv in [0, 3)^2, footprints over three decades."""
    rng = np.random.default_rng(seed)
    gn = _unit(rng, n)
    sn = gn + 0.2 * rng.normal(size=(n, 3))
    sn /= np.linalg.norm(sn, axis=1, keepdims=True)
    f32, i32 = np.float32, np.int32
    zeros = np.zeros(n, f32)
    ids = np.full(n, -1, i32)
    return dict(
        valid=np.ones(n, bool), t=np.ones(n, f32),
        position=rng.normal(size=(n, 3)).astype(f32),
        geometry_normal=gn.astype(f32), frame=_frame(sn).astype(f32),
        uv=rng.uniform(0.0, 3.0, (n, 2)).astype(f32),
        st=rng.random((n, 2)).astype(f32), mean_curvature=zeros,
        inv_uv_size=np.ones(n, f32),
        footprint=(10.0 ** rng.uniform(-3, 0, n)).astype(f32),
        shape_id=ids, prim_id=ids, material_id=np.full(n, mat_id, i32),
        light_id=ids, interior_med=ids, exterior_med=ids)


def both_hits(h):
    jh = JG.Hit(**{k: jnp.asarray(v) for k, v in h.items()})
    ph = PG.Hit(**{k: torch.from_numpy(v) for k, v in h.items()})
    return jh, ph


@pytest.fixture(scope='module')
def glass():
    js = JC.compile_scene(PT.cornell_box_builder(16, variant='glass'))
    return js, to_port(js)


# material ids of the glass Cornell box (testing.cornell_box_builder)
MATERIALS = {'lambertian': 0, 'checker_lambertian': 3, 'roughplastic': 4,
             'roughdielectric': 5}


def _inputs(mat, seed):
    rng = np.random.default_rng(seed + 1)
    h = random_hits(N, seed, MATERIALS[mat])
    # dir_in mostly on the geometric normal's side, dir_out anywhere
    din = _unit(rng, N) + 0.5 * h['geometry_normal']
    din = (din / np.linalg.norm(din, axis=1, keepdims=True)).astype(
        np.float32)
    dout = _unit(rng, N).astype(np.float32)
    u2 = rng.random((N, 2)).astype(np.float32)
    w = rng.random(N).astype(np.float32)
    return h, din, dout, u2, w


def _near_peak(mat, h, din, dout):
    """Lanes with cos(n, h) > 0.98 for their half vector (the generalized
    one, din + eta dout, for a dielectric's transmission)."""
    if mat not in ('roughplastic', 'roughdielectric'):
        return np.zeros(N, bool)
    gn, n = h['geometry_normal'], h['frame'][:, 2]
    g_in = (din * gn).sum(-1)
    eta = np.where(g_in > 0, 1.5, 1.0 / 1.5)[:, None]
    refl = (g_in * (dout * gn).sum(-1) > 0)[:, None]
    if mat == 'roughplastic':
        refl = np.ones_like(refl)
    hv = np.where(refl, din + dout, din + dout * eta)
    hv /= np.linalg.norm(hv, axis=1, keepdims=True)
    return np.abs((hv * n).sum(-1)) > 0.98


def assert_close(got, want, loose, atol=1e-6):
    """rtol 1e-5 off the `loose` lanes, 1e-2 on them (< 3% of lanes)."""
    assert loose.mean() < 0.03
    np.testing.assert_allclose(got[~loose], want[~loose], rtol=1e-5,
                               atol=atol)
    np.testing.assert_allclose(got[loose], want[loose], rtol=1e-2, atol=atol)


@pytest.mark.parametrize('mat', list(MATERIALS))
def test_eval_and_pdf_match_jax(mat, glass):
    js, ps = glass
    h, din, dout, _, _ = _inputs(mat, 1)
    jh, ph = both_hits(h)
    mid = h['material_id']
    jf = np.asarray(jax.vmap(lambda m, a, b, hh: JM.eval_bsdf(
        js, m, a, b, hh))(mid, din, dout, jh))
    jp = np.asarray(jax.vmap(lambda m, a, b, hh: JM.pdf_bsdf(
        js, m, a, b, hh))(mid, din, dout, jh))
    t = torch.from_numpy
    pf = PM.eval_bsdf(ps, t(mid), t(din), t(dout), ph).numpy()
    pp = PM.pdf_bsdf(ps, t(mid), t(din), t(dout), ph).numpy()
    assert (jf > 0).any() and (jp > 0).any()
    peak = _near_peak(mat, h, din, dout)
    assert_close(pf, jf, peak)
    assert_close(pp, jp, peak)


@pytest.mark.parametrize('mat', list(MATERIALS))
def test_sample_matches_jax(mat, glass):
    js, ps = glass
    h, din, _, u2, w = _inputs(mat, 2)
    jh, ph = both_hits(h)
    mid = h['material_id']
    jr = jax.vmap(lambda m, a, hh, uu, ww: JM.sample_bsdf(
        js, m, a, hh, uu, ww))(mid, din, jh, u2, w)
    t = torch.from_numpy
    pr = PM.sample_bsdf(ps, t(mid), t(din), ph, t(u2), t(w))
    valid = np.asarray(jr.valid)
    assert (pr.valid.numpy() == valid).all()
    assert valid.mean() > 0.3
    rim = u2[valid, 0] > 0.98
    for k in ('dir_out', 'eta', 'roughness'):
        # directions are unit vectors: their small components are held
        # to an absolute 1e-5
        assert_close(getattr(pr, k).numpy()[valid],
                     np.asarray(getattr(jr, k))[valid], rim,
                     atol=1e-5 if k == 'dir_out' else 1e-6)


def _tex_ids(ps, kind):
    ids = np.nonzero(ps.tex_kind.numpy()[:ps.meta.num_textures] == kind)[0]
    assert ids.size
    return ids


@pytest.mark.parametrize('kind', ['constant', 'checkerboard', 'image'])
def test_eval_texture_matches_jax(kind, glass):
    if kind == 'image':
        js = JC.compile_scene(PT.textured_builder())
        ps = to_port(js)
    else:
        js, ps = glass
    code = {'constant': T.TEX_CONSTANT, 'checkerboard': T.TEX_CHECKERBOARD,
            'image': T.TEX_IMAGE}[kind]
    rng = np.random.default_rng(3)
    tex = rng.choice(_tex_ids(ps, code), N).astype(np.int32)
    h = random_hits(N, 4, 0)
    uv, fp = h['uv'], h['footprint']
    want = np.asarray(jax.vmap(lambda i, a, f: JTE.eval_texture(
        js, i, a, f))(tex, uv, fp))
    got = PTE.eval_texture(ps, torch.from_numpy(tex), torch.from_numpy(uv),
                           torch.from_numpy(fp)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.unique(want[:, 0]).size > (1 if kind != 'constant' else 0)
    scalar = PTE.eval_texture_scalar(ps, torch.from_numpy(tex),
                                     torch.from_numpy(uv),
                                     torch.from_numpy(fp)).numpy()
    assert np.array_equal(scalar, got[:, 0])
