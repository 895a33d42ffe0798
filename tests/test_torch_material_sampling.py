"""Each ported BSDF's sampler against its own pdf: the cone-mass test of
lajolla_tpu's tests/test_materials.py (`check_sample_pdf_statistical`),
run on the port's `sample_bsdf` / `pdf_bsdf`, with its sample counts and
tolerances.

Around probe directions drawn from the sampler itself, the share of
200,000 samples that fall in a cone must match the pdf integrated over
that cone (Monte Carlo over 50,000 uniform points in the cone), within
rel_tol 0.08 of the larger plus four standard errors of the share. A
sampler and a pdf that drift together from lajolla_tpu's can pass the
against-JAX tests (tests/test_torch_materials.py) within their
tolerance; they cannot pass this one unless they agree with each other.
The uniforms come from numpy; no JAX is needed. The eleven material
cases are lajolla_tpu's `CASES` (tests/test_materials.py:99-112), the
eight Disney ones among them.

`test_eval_pdf_positivity_coupling` mirrors lajolla_tpu's
(tests/test_materials.py:148): wherever a sampled direction has a
positive BSDF value, its pdf must be positive (else the estimator would
be biased).
"""

import numpy as np
import pytest
import torch

import lajolla_tpu_torch.materials as PM
from lajolla_tpu_torch.core.math import make_frame
from lajolla_tpu_torch.scene.geometry import Hit
from lajolla_tpu_torch.scene import types as T
from lajolla_tpu_torch.testing import make_single_material_scene

from torch_threads import one_thread  # noqa: F401

CASES = [
    ('diffuse', None),
    ('roughplastic', None),
    ('roughdielectric', None),
    ('disneydiffuse', None),
    ('disneymetal', None),
    ('disneymetal', {T.P_ANISOTROPIC: 0.8}),
    ('disneyglass', None),
    ('disneyclearcoat', None),
    ('disneysheen', None),
    ('disneybsdf', None),
    ('disneybsdf', {T.P_SPEC_TRANS: 0.7, T.P_METALLIC: 0.2,
                    T.P_CLEARCOAT: 0.8, T.P_SHEEN: 0.5}),
]
IDS = [m + ('-aniso' if p and T.P_ANISOTROPIC in p else
            '-lobes' if p else '') for m, p in CASES]


def make_hit(n):
    """n lanes of lajolla_tpu's test hit: normal +z, uv (0.3, 0.6)."""
    i32 = torch.int32
    nrm = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3)
    z = torch.zeros(n)
    return Hit(valid=torch.ones(n, dtype=torch.bool), t=z + 1.0,
               position=torch.zeros(n, 3), geometry_normal=nrm,
               frame=make_frame(nrm), uv=torch.tensor([[0.3, 0.6]]).expand(
                   n, 2),
               st=torch.zeros(n, 2), mean_curvature=z, inv_uv_size=z + 1.0,
               footprint=z, shape_id=torch.zeros(n, dtype=i32),
               prim_id=torch.zeros(n, dtype=i32),
               material_id=torch.zeros(n, dtype=i32),
               light_id=torch.full((n,), -1, dtype=i32),
               interior_med=torch.full((n,), -1, dtype=i32),
               exterior_med=torch.full((n,), -1, dtype=i32))


def check_sample_pdf_statistical(scene, dir_in, n=200_000, seed=0,
                                 n_probes=8, rel_tol=0.08):
    """lajolla_tpu's cone-mass test on the port's BSDF functions."""
    rng = np.random.default_rng(seed)
    u2 = torch.from_numpy(rng.random((n, 2)).astype(np.float32))
    w = torch.from_numpy(rng.random(n).astype(np.float32))
    din = torch.tensor(dir_in, dtype=torch.float32)
    din = (din / din.norm()).expand(n, 3)
    mat = torch.zeros(n, dtype=torch.int32)
    rec = PM.sample_bsdf(scene, mat, din, make_hit(n), u2, w)
    dirs_v = rec.dir_out[rec.valid].double().numpy()
    assert dirs_v.shape[0] > n // 2

    m = 50_000
    hit_m = make_hit(m)

    def pdf_fn(dirs):
        return PM.pdf_bsdf(scene, torch.zeros(m, dtype=torch.int32),
                           din[:1].expand(m, 3),
                           torch.from_numpy(dirs.astype(np.float32)),
                           hit_m).numpy()

    probe_ids = rng.integers(0, dirs_v.shape[0], n_probes)
    tested = 0
    for pid in probe_ids:
        ctr = dirs_v[pid]
        for delta in (0.08, 0.2, 0.5):
            cosd = np.cos(delta)
            emp = float(((dirs_v @ ctr > cosd).sum()) / n)
            if emp * n > 2000:  # enough mass for a tight comparison
                break
        if emp * n < 500:
            continue  # an isolated sliver (a rare lobe)
        z = rng.uniform(cosd, 1, m)
        phi = rng.uniform(0, 2 * np.pi, m)
        r = np.sqrt(1 - z * z)
        a = np.array([0.0, 1.0, 0.0])
        if abs(ctr @ a) > 0.9:
            a = np.array([1.0, 0.0, 0.0])
        t = np.cross(a, ctr)
        t /= np.linalg.norm(t)
        b = np.cross(ctr, t)
        cone = (r * np.cos(phi))[:, None] * t + \
            (r * np.sin(phi))[:, None] * b + z[:, None] * ctr
        pdfv = pdf_fn(cone)
        assert np.isfinite(pdfv).all() and (pdfv >= 0).all()
        pred = float(pdfv.mean() * 2 * np.pi * (1 - cosd))
        emp_se = np.sqrt(emp * (1 - emp) / n)
        assert abs(emp - pred) < rel_tol * max(emp, pred) + 4 * emp_se, \
            f"cone at {ctr} delta={delta}: empirical={emp} predicted={pred}"
        tested += 1
    assert tested > 0


@pytest.mark.parametrize('mat,params', CASES, ids=IDS)
def test_material_sample_pdf(mat, params):
    scene = make_single_material_scene(mat, params=params)
    check_sample_pdf_statistical(scene, (0.3, -0.2, 0.9))


@pytest.mark.parametrize('mat', ['roughdielectric', 'disneyglass'])
def test_transmissive_from_inside(mat):
    scene = make_single_material_scene(mat)
    check_sample_pdf_statistical(scene, (0.2, 0.1, -0.95))


@pytest.mark.parametrize('mat,params', CASES, ids=IDS)
def test_eval_pdf_positivity_coupling(mat, params):
    scene = make_single_material_scene(mat, params=params)
    n = 2000
    rng = np.random.default_rng(1)
    u2 = torch.from_numpy(rng.random((n, 2)).astype(np.float32))
    w = torch.from_numpy(rng.random(n).astype(np.float32))
    din = torch.tensor((0.3, -0.2, 0.9))
    din = (din / din.norm()).expand(n, 3)
    mat_id = torch.zeros(n, dtype=torch.int32)
    hit = make_hit(n)
    rec = PM.sample_bsdf(scene, mat_id, din, hit, u2, w)
    pdf = PM.pdf_bsdf(scene, mat_id, din, rec.dir_out, hit).numpy()
    f = PM.eval_bsdf(scene, mat_id, din, rec.dir_out, hit).numpy()
    # samplers may produce directions with f = pdf = 0 (e.g. microfacet
    # reflections below the horizon); the integrator rejects them
    nonzero_f = rec.valid.numpy() & (f.max(axis=1) > 1e-9)
    assert nonzero_f.any()
    assert (pdf[nonzero_f] > 0).all()
