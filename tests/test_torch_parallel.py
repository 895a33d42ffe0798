"""Multi-GPU rendering (parallel/mesh.py) on the CPU: R = 2 gloo ranks
started once by parallel.spawn (one module fixture renders every case),
held against the port's one-process renders and against lajolla_tpu's
shard_map renders on a 2-device mesh.

- Every render case: the ranks' films are equal, and equal to the
  one-process render() at spp_pc·R samples (spp_pc = ceil(spp / R), the
  sharded render's divisor): median per-pixel relative difference < 1e-4,
  film means within 1%. Cases: the Cornell box at 128x64 (whole
  4096-pixel blocks: K1's plain form) and at 96x64 (1.5 blocks: K1's
  plain form too), the glass box (the general engine), 'vol' at 64x64
  (K8's plain form) and at 32x32 (the general volumetric engine),
  'hetvol' at 64x64 (K9's plain form), volpath version 2, the mesh
  Cornell box (cluster tables: the sweeps' plain forms, the
  single-device lane schedule), and an odd spp (3 on 2 ranks renders 4
  samples).
- Aux: depth and shadingNormal on a 32x33 film (33 rows on 2 ranks: a
  padding row) equal to render_aux's (rtol 2e-5).
- Gradients: render_diff_sharded's film mean and its gradient with
  respect to a scale on the texture table (reverse mode with
  allreduce_grads) on every rank within rel 1e-4 / 1e-3 of the
  one-process render_diff's; grad_fwd through it equal to reverse mode
  (rel 1e-4).
- Against lajolla_tpu's render_path_sharded, render_volpath_sharded
  (non-grid), render_volpath_simple_sharded (version 2),
  render_aux_sharded and render_diff_sharded on 2 of conftest's virtual
  devices, the scenes carried across by bridge.py: median < 1e-4 and
  means within 1%; aux rtol 2e-5; primal rel 1e-4, gradient rel 1e-3.
  The mesh box only in expectation, at lajolla_tpu's own gate (means
  within 7%, rel RMSE < 0.35, tests/test_parallel.py): lajolla_tpu's
  sharded path runs a lane a pixel there, the port the single-device
  lane pool, so their work items differ.
- default_group from torchrun's environment (one rank, gloo), and spawn
  raising on a failed rank and on ranks past their timeout.
"""

import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import lajolla_tpu.scene.compile as JC
from lajolla_tpu.parallel import mesh as JM
from lajolla_tpu.scene.types import RenderOptions as JOptions
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch import render
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.integrators.aux import render_aux
from lajolla_tpu_torch.integrators.diffpath import render_diff
from lajolla_tpu_torch.parallel import mesh
from lajolla_tpu_torch.parallel.spawn import spawn
from lajolla_tpu_torch.scene.types import RenderOptions

from torch_threads import one_thread  # noqa: F401

R = 2
DIFF_SEED, DIFF_DEPTH = 3, 4


def _opts(integrator, spp, version=None, max_depth=None):
    kw = dict(integrator=integrator, samples_per_pixel=spp)
    if version is not None:
        kw['vol_path_version'] = version
    if max_depth is not None:
        kw['max_depth'] = max_depth
    return RenderOptions(**kw), JOptions(**kw)


# name: (Cornell box builder arguments, integrator, spp, volpath version);
# the cases named in JAX_CASES are compiled by lajolla_tpu and carried
# across, the others compiled by the port.
CASES = {
    'cbox_blocks': (dict(res=(128, 64)), 'path', 4, None),
    'cbox_96x64': (dict(res=(96, 64)), 'path', 4, None),
    'glass': (dict(res=(32, 24), variant='glass'), 'path', 4, None),
    'vol_k8': (dict(res=64, variant='vol'), 'volpath', 4, None),
    'hetvol_k9': (dict(res=64, variant='hetvol', grid_res=(32, 32, 16)),
                  'volpath', 2, None),
    'odd_spp': (dict(res=(32, 24)), 'path', 3, None),
    'path': (dict(res=(32, 24)), 'path', 4, None),
    'volpath': (dict(res=32, variant='vol'), 'volpath', 4, None),
    'volpath_v2': (dict(res=32, variant='vol'), 'volpath', 4, 2),
    'mesh': (dict(res=(32, 24), variant='mesh'), 'path', 2, None),
    'depth': (dict(res=(32, 33)), 'depth', 1, None),
    'shadingNormal': (dict(res=(32, 33)), 'shadingNormal', 1, None),
    'diff': (dict(res=16), 'path', 4, None),
}
JAX_CASES = ('path', 'volpath', 'volpath_v2', 'mesh', 'depth',
             'shadingNormal', 'diff')
RENDERS = [k for k in CASES if k not in ('depth', 'shadingNormal', 'diff')]


@pytest.fixture(scope='module')
def scenes():
    """name → (port scene, lajolla_tpu scene or None, port options,
    lajolla_tpu options)."""
    out = {}
    for name, (kw, integrator, spp, version) in CASES.items():
        depth = DIFF_DEPTH if name == 'diff' else None
        po, jo = _opts(integrator, spp, version, depth)
        if name in JAX_CASES:
            js = JC.compile_scene(PT.cornell_box_builder(spp=spp, **kw))
            out[name] = (to_port(js), js, po, jo)
        else:
            out[name] = (PT.make_cornell_box(spp=spp, **kw), None, po, jo)
    return out


@pytest.fixture(scope='module')
def ranks(scenes):
    """name → [rank 0's result, rank 1's] of testing.sharded_cases, all
    cases rendered by one spawn of R gloo ranks."""
    names = list(CASES)
    cases = [dict(kind='diff' if n == 'diff' else 'render',
                  scene=scenes[n][0], options=scenes[n][2],
                  seed=DIFF_SEED if n == 'diff' else 0, depth=DIFF_DEPTH)
             for n in names]
    out = spawn(PT.sharded_cases, R, cases, timeout=600)
    return {n: [out[r][i] for r in range(R)] for i, n in enumerate(names)}


def film_gates(got, want):
    assert np.isfinite(got).all() and np.isfinite(want).all()
    rel = np.abs(got - want) / (want + 1e-3)
    return (float(np.median(rel)),
            abs(float(got.mean()) - float(want.mean())) / float(want.mean()))


def one_process_spp(spp):
    return -(-spp // R) * R


@pytest.mark.parametrize('name', RENDERS)
def test_sharded_film_equals_one_process_render(scenes, ranks, name):
    scene, _js, po, _jo = scenes[name]
    films = [r['film'] for r in ranks[name]]
    assert all(np.array_equal(films[0], f) for f in films[1:])
    want = render(scene, dataclasses.replace(
        po, samples_per_pixel=one_process_spp(po.samples_per_pixel)),
        device='cpu')
    med, mean_rel = film_gates(films[0], want)
    assert med < 1e-4 and mean_rel < 0.01, (med, mean_rel)


@pytest.mark.parametrize('name', ['depth', 'shadingNormal'])
def test_sharded_aux_equals_render_aux(scenes, ranks, name):
    scene, _js, po, _jo = scenes[name]
    assert scene.meta.height % R != 0       # a padding row
    want = render_aux(scene, po).numpy()
    for r in ranks[name]:
        assert r['film'].shape == want.shape
        np.testing.assert_allclose(r['film'], want, rtol=2e-5, atol=2e-5)


def _scaled(scene, s):
    return dataclasses.replace(scene, tex_tab=scene.tex_tab * s)


def test_sharded_gradients_equal_one_process(scenes, ranks):
    scene, _js, po, _jo = scenes['diff']
    s = torch.tensor(1.0, requires_grad=True)
    loss = render_diff(_scaled(scene, s), po, DIFF_SEED,
                       spp=one_process_spp(po.samples_per_pixel),
                       depth=DIFF_DEPTH).mean()
    loss.backward()
    for r in ranks['diff']:
        assert r['loss'] == pytest.approx(float(loss.detach()), rel=1e-4)
        assert r['grad'] == pytest.approx(float(s.grad), rel=1e-3)
        assert r['grad_fwd'] == pytest.approx(r['grad'], rel=1e-4)
        assert r['grad'] > 0


def jax_mesh():
    return JM.default_mesh(jax.devices()[:R])


@pytest.mark.parametrize('name,fn', [
    ('path', JM.render_path_sharded),
    ('volpath', JM.render_volpath_sharded),
    ('volpath_v2', JM.render_volpath_simple_sharded)])
def test_sharded_film_matches_lajolla_tpu(scenes, ranks, name, fn):
    _ps, js, _po, jo = scenes[name]
    want = np.asarray(fn(js, jo, mesh=jax_mesh()))
    med, mean_rel = film_gates(ranks[name][0]['film'], want)
    assert med < 1e-4 and mean_rel < 0.01, (med, mean_rel)


def test_sharded_mesh_box_matches_lajolla_tpu_in_expectation(scenes, ranks):
    from test_golden import rel_rmse
    ps, js, _po, jo = scenes['mesh']
    assert ps.meta.use_binned
    want = np.asarray(JM.render_path_sharded(js, jo, mesh=jax_mesh()))
    got = ranks['mesh'][0]['film']
    assert abs(got.mean() - want.mean()) < 0.07 * want.mean()
    assert rel_rmse(got, want) < 0.35


@pytest.mark.parametrize('name', ['depth', 'shadingNormal'])
def test_sharded_aux_matches_lajolla_tpu(scenes, ranks, name):
    _ps, js, _po, jo = scenes[name]
    want = np.asarray(JM.render_aux_sharded(js, jo, mesh=jax_mesh()))
    np.testing.assert_allclose(ranks[name][0]['film'], want, rtol=2e-5,
                               atol=2e-5)


def test_sharded_gradients_match_lajolla_tpu(scenes, ranks):
    _ps, js, _po, jo = scenes['diff']

    def loss(s):
        return jnp.mean(JM.render_diff_sharded(
            _scaled(js, s), jo, seed=DIFF_SEED, mesh=jax_mesh(),
            depth=DIFF_DEPTH))

    p, g = jax.value_and_grad(loss)(jnp.float32(1.0))
    for r in ranks['diff']:
        assert r['loss'] == pytest.approx(float(p), rel=1e-4)
        assert r['grad'] == pytest.approx(float(g), rel=1e-3)


def test_default_group_from_torchrun_environment(scenes, monkeypatch):
    """One rank initialised from RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT, as torchrun sets them: gloo for the CPU, and the film of
    render()."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
                     MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    scene, _js, po, _jo = scenes['odd_spp']
    try:
        group = mesh.default_group('cpu')
        assert dist.get_backend(group) == 'gloo'
        assert dist.get_world_size(group) == 1
        got = mesh.render_sharded(scene, po).numpy()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    np.testing.assert_allclose(got, render(scene, po, device='cpu'),
                               rtol=1e-6, atol=0)


def test_spawn_raises_on_a_failed_rank(scenes):
    scene, _js, po, _jo = scenes['odd_spp']
    case = dict(kind='render', scene=scene, seed=0,
                options=dataclasses.replace(po, integrator='nonesuch'))
    with pytest.raises(RuntimeError, match='unknown integrator: nonesuch'):
        spawn(PT.sharded_cases, R, [case], timeout=300)


def test_spawn_raises_past_its_timeout(scenes):
    scene, _js, po, _jo = scenes['glass']
    case = dict(kind='render', scene=scene, seed=0, options=po)
    with pytest.raises(TimeoutError, match='still running'):
        spawn(PT.sharded_cases, R, [case], timeout=1.0)
