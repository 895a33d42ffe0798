"""The six Disney BSDFs of the port against lajolla_tpu's.

Random hit records and directions are made with numpy from a seed and
handed to both packages (lajolla_tpu's functions under jax.vmap): eval,
pdf and sample of each of the eleven material cases of lajolla_tpu's
tests/test_materials.py (`CASES`, as tests/test_torch_material_sampling.py
lists them: among them the anisotropic metal and the all-lobe
DisneyBSDF) on its single-material scene, with directions from outside
and from inside the surface; and the port's dispatch over
the seven material types of the 'disney' Cornell box against
lajolla_tpu's `lax.switch`.

Tolerances: rtol 1e-5 (atol 1e-6; 1e-5 for unit directions), except on
three ill-conditioned sets of lanes, which get rtol 1e-2 and must stay
under 3% of the lanes (test_torch_materials.assert_close):
- eval and pdf within cos(n, h) > 0.98 of a GGX peak (metal, glass and
  the DisneyBSDF's lobes; the generalized half vector for transmission),
  where D divides by a quantity formed by cancellation (~alpha^2);
- eval and pdf at the clearcoat's peak, the same lanes: at clearcoat
  gloss 1 its alpha is 0.001, so a last-bit difference grows ~1e6 there;
- sampled directions with u0 > 0.98, the rim of the VNDF disk and the
  grazing end of the clearcoat's half-vector map, where a square root of
  a difference cancels.
The sample's valid bits must be equal on every lane.

The per-type tests hold lajolla_tpu's functions op by op, as
tests/test_torch_materials.py does. Under jit, XLA fuses the clearcoat's
half-vector map differently: at gloss 1 (alpha 0.001) a sampled half
vector lies next to the normal, sin = sqrt(1 - cos^2) cancels there, and
jitted lajolla_tpu differs from itself op by op on 8.5% of the sampled
directions by up to 4% (the port matches the op-by-op form on all).
"""

import jax
import numpy as np
import pytest
import torch

import lajolla_tpu.materials as JM
import lajolla_tpu.scene.compile as JC
import lajolla_tpu.testing as JT
import lajolla_tpu_torch.materials as PM
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from test_torch_material_sampling import CASES, IDS
from test_torch_materials import _unit, assert_close, both_hits, random_hits

from torch_threads import one_thread  # noqa: F401

N = 8192

_PEAKED = ('roughplastic', 'roughdielectric', 'disneymetal', 'disneyglass',
           'disneyclearcoat', 'disneybsdf')
_TRANSMISSIVE = ('roughdielectric', 'disneyglass', 'disneybsdf')


def _inputs(seed, n=N, mat_id=0):
    """Hits, dir_in (a quarter of the lanes from inside: below the
    geometric normal), dir_out anywhere, uniforms."""
    rng = np.random.default_rng(seed + 1)
    h = random_hits(n, seed, mat_id)
    side = np.where(rng.random(n) < 0.25, -0.5, 0.5)[:, None]
    din = _unit(rng, n) + side * h['geometry_normal']
    din = (din / np.linalg.norm(din, axis=1, keepdims=True)).astype(
        np.float32)
    dout = _unit(rng, n).astype(np.float32)
    u2 = rng.random((n, 2)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    return h, din, dout, u2, w


def _near_peak(mat, h, din, dout, eta=1.5):
    """Lanes with cos(n, h) > 0.98 for their half vector: the generalized
    one (din + eta dout) where a transmissive BSDF transmits."""
    if mat not in _PEAKED:
        return np.zeros(len(din), bool)
    gn, n = h['geometry_normal'], h['frame'][:, 2]
    g_in = (din * gn).sum(-1)
    e = np.where(g_in > 0, eta, 1.0 / eta)[:, None]
    refl = (g_in * (dout * gn).sum(-1) > 0)[:, None]
    if mat not in _TRANSMISSIVE:
        refl = np.ones_like(refl)
    hv = np.where(refl, din + dout, din + dout * e)
    hv /= np.linalg.norm(hv, axis=1, keepdims=True)
    return np.abs((hv * n).sum(-1)) > 0.98


def _scenes(mat, params):
    js = JT.make_single_material_scene(mat, params=params)
    return js, to_port(js)


def _jax_eval_pdf(js, mid, din, dout, jh, jit=False):
    wrap = jax.jit if jit else (lambda f: f)
    f = wrap(jax.vmap(lambda m, a, b, hh: JM.eval_bsdf(
        js, m, a, b, hh)))(mid, din, dout, jh)
    p = wrap(jax.vmap(lambda m, a, b, hh: JM.pdf_bsdf(
        js, m, a, b, hh)))(mid, din, dout, jh)
    return np.asarray(f), np.asarray(p)


def _jax_sample(js, mid, din, jh, u2, w, jit=False):
    wrap = jax.jit if jit else (lambda f: f)
    return wrap(jax.vmap(lambda m, a, hh, uu, ww: JM.sample_bsdf(
        js, m, a, hh, uu, ww)))(mid, din, jh, u2, w)


@pytest.mark.parametrize('mat,params', CASES, ids=IDS)
def test_eval_and_pdf_match_jax(mat, params):
    js, ps = _scenes(mat, params)
    h, din, dout, _, _ = _inputs(1)
    jh, ph = both_hits(h)
    mid = h['material_id']
    jf, jp = _jax_eval_pdf(js, mid, din, dout, jh)
    t = torch.from_numpy
    pf = PM.eval_bsdf(ps, t(mid), t(din), t(dout), ph).numpy()
    pp = PM.pdf_bsdf(ps, t(mid), t(din), t(dout), ph).numpy()
    assert pf.shape == (N, 3) and pp.shape == (N,)
    assert (jf > 0).any() and (jp > 0).any()
    peak = _near_peak(mat, h, din, dout)
    assert_close(pf, jf, peak)
    assert_close(pp, jp, peak)


@pytest.mark.parametrize('mat,params', CASES, ids=IDS)
def test_sample_matches_jax(mat, params):
    js, ps = _scenes(mat, params)
    h, din, _, u2, w = _inputs(2)
    jh, ph = both_hits(h)
    mid = h['material_id']
    jr = _jax_sample(js, mid, din, jh, u2, w)
    t = torch.from_numpy
    pr = PM.sample_bsdf(ps, t(mid), t(din), ph, t(u2), t(w))
    # every field per lane, so the dispatch's selection sees (N,) rows
    assert all(x.shape[0] == N for x in pr)
    valid = np.asarray(jr.valid)
    assert (pr.valid.numpy() == valid).all()
    assert valid.mean() > 0.3
    rim = u2[valid, 0] > 0.98
    for k in ('dir_out', 'eta', 'roughness'):
        assert_close(getattr(pr, k).numpy()[valid],
                     np.asarray(getattr(jr, k))[valid], rim,
                     atol=1e-5 if k == 'dir_out' else 1e-6)


@pytest.fixture(scope='module')
def disney_box():
    js = JC.compile_scene(PT.cornell_box_builder(16, variant='disney'))
    return js, to_port(js)


def test_disney_box_dispatch_matches_jax(disney_box):
    """eval, pdf and sample over the seven material types of the 'disney'
    Cornell box, every lane's material drawn at random: the port's
    torch.where selection against lajolla_tpu's lax.switch, jitted as
    its renders run it (op by op the switch takes ~30 s here)."""
    js, ps = disney_box
    types = ps.mat_tab[:, 0].numpy().astype(int)
    present = ps.meta.mat_types_present
    assert len(present) == 7
    rng = np.random.default_rng(11)
    mids = rng.integers(0, len(types), N).astype(np.int32)
    h, din, dout, u2, w = _inputs(3)
    h['material_id'] = mids
    jh, ph = both_hits(h)
    jf, jp = _jax_eval_pdf(js, mids, din, dout, jh, jit=True)
    jr = _jax_sample(js, mids, din, jh, u2, w, jit=True)
    t = torch.from_numpy
    pf = PM.eval_bsdf(ps, t(mids), t(din), t(dout), ph).numpy()
    pp = PM.pdf_bsdf(ps, t(mids), t(din), t(dout), ph).numpy()
    pr = PM.sample_bsdf(ps, t(mids), t(din), ph, t(u2), t(w))
    names = {v: k for k, v in PT.MATERIAL_XML_TYPES.items()}
    peak = np.zeros(N, bool)
    for m in np.unique(mids):
        lanes = mids == m
        peak[lanes] = _near_peak(names[types[m]], {
            k: v[lanes] for k, v in h.items()}, din[lanes], dout[lanes])
    assert_close(pf, jf, peak)
    assert_close(pp, jp, peak)
    valid = np.asarray(jr.valid)
    assert (pr.valid.numpy() == valid).all()
    rim = u2[valid, 0] > 0.98
    for k in ('dir_out', 'eta', 'roughness'):
        assert_close(getattr(pr, k).numpy()[valid],
                     np.asarray(getattr(jr, k))[valid], rim,
                     atol=1e-5 if k == 'dir_out' else 1e-6)
    # every type was drawn and evaluates to something somewhere
    for m in present:
        lanes = types[mids] == m
        assert lanes.any() and (jf[lanes] > 0).any(), m


def test_aniso_helpers_match_jax():
    """materials.common's anisotropic GGX helpers and Schlick Fresnel
    against lajolla_tpu's on random local vectors and alphas (ax != ay)."""
    import lajolla_tpu.materials.common as JCM
    import lajolla_tpu_torch.materials.common as PCM
    rng = np.random.default_rng(5)
    v = _unit(rng, N).astype(np.float32)
    ax = rng.uniform(1e-3, 1.0, N).astype(np.float32)
    ay = rng.uniform(1e-3, 1.0, N).astype(np.float32)
    u = rng.random((N, 2)).astype(np.float32)
    c = rng.uniform(-1.0, 1.0, N).astype(np.float32)
    f0 = rng.random((N, 3)).astype(np.float32)
    t = torch.from_numpy
    want = [np.asarray(jax.vmap(fn)(*a)) for fn, a in (
        (JCM.smith_g_ggx_aniso, (v, ax, ay)),
        (JCM.gtr2_aniso, (v, ax, ay)),
        (JCM.sample_visible_normals_aniso, (v, ax, ay, u)),
        (JCM.schlick_fresnel_scalar, (f0, c)))]
    got = [PCM.smith_g_ggx_aniso(t(v), t(ax), t(ay)),
           PCM.gtr2_aniso(t(v), t(ax), t(ay)),
           PCM.sample_visible_normals_aniso(t(v), t(ax), t(ay), t(u)),
           PCM.schlick_fresnel_scalar(t(f0), t(c)[:, None])]
    # D at its peak (|h_z| > 0.98) and the VNDF's rim (u0 > 0.98)
    loose = [np.zeros(N, bool), np.abs(v[:, 2]) > 0.98, u[:, 0] > 0.98,
             np.zeros(N, bool)]
    for g, w_, lo in zip(got, want, loose):
        assert_close(g.numpy(), w_, lo, atol=1e-5)
