"""Counter-hash RNG and the in-kernel camera against lajolla_tpu: the
hash words and uniforms bit for bit, the camera rays of all three pixel
filters to 1e-6, and the layout of the camera record the kernels read."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lajolla_tpu.integrators.path as JPATH
import lajolla_tpu.integrators.path_megakernel as JMK
import lajolla_tpu.scene.compile as JC
import lajolla_tpu_torch.integrators.path as PPATH
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch.core.random import hash_u01, pcg_hash
from lajolla_tpu_torch.scene.camera import camera_record, sample_primary_t
from lajolla_tpu_torch.scene.types import (FILTER_BOX, FILTER_GAUSSIAN,
                                           FILTER_TENT)

from torch_threads import one_thread  # noqa: F401


def test_pcg_hash_and_u01_bit_exact():
    words = np.random.default_rng(7).integers(0, 1 << 32, 100_000,
                                              dtype=np.uint64)
    jh = np.asarray(JPATH._pcg_hash(jnp.asarray(words.astype(np.uint32))))
    ph = pcg_hash(torch.from_numpy(words.astype(np.int64)))
    assert np.array_equal(ph.numpy(), jh.astype(np.int64))
    pu = hash_u01(ph).numpy()
    for ju in (JPATH._hash_u01(jnp.asarray(jh)), JMK._u01(jnp.asarray(jh))):
        assert np.array_equal(pu.view(np.int32),
                              np.asarray(ju).view(np.int32))


def test_vertex_uniforms_bit_exact():
    """The (8, N) per-vertex uniforms of the drivers: hash of (seed, work
    item, bounce, dim) as lajolla_tpu's _render_block_kernel draws them."""
    rng = np.random.default_rng(3)
    item = rng.integers(0, 1 << 31, 4096).astype(np.int64)
    nv = rng.integers(2, 66, 4096).astype(np.int64)
    su = 0xDEADBEEF
    kidx = (jnp.arange(8, dtype=jnp.uint32) * jnp.uint32(JPATH._GOLD) +
            jnp.uint32(JPATH._GOLD))[:, None]
    hb = JPATH._pcg_hash(jnp.asarray(item.astype(np.uint32)) ^
                         JPATH._pcg_hash(jnp.asarray(nv.astype(np.uint32)) ^
                                         jnp.uint32(su)))
    ju = np.asarray(JPATH._hash_u01(JPATH._pcg_hash(hb[None, :] + kidx)))
    pu = PPATH._vertex_uniforms(torch.from_numpy(item),
                                torch.from_numpy(nv), su).numpy()
    assert np.array_equal(pu.view(np.int32), ju.view(np.int32))


@pytest.mark.parametrize('filter_type,filter_param', [
    (FILTER_BOX, 1.0), (FILTER_TENT, 2.0), (FILTER_GAUSSIAN, 0.5)],
    ids=['box', 'tent', 'gaussian'])
def test_primary_rays(filter_type, filter_param):
    js = JC.compile_scene(PT.cornell_box_builder(48))
    w = h = 48
    n = w * h
    s0 = 3
    cam = np.concatenate([np.asarray(js.sample_to_cam).reshape(-1),
                          np.asarray(js.cam_to_world).reshape(-1)])
    lane = np.arange(n)
    item = lane + s0 * n
    px = (lane % w).astype(np.float32)
    py = (lane // w).astype(np.float32)
    seed = 12345
    jo, jd = JMK._primary(
        jnp.asarray(item.astype(np.int32))[None], jnp.asarray(px)[None],
        jnp.asarray(py)[None], jnp.uint32(seed), jnp.asarray(cam), w=w, h=h,
        filter_type=filter_type, filter_param=filter_param)
    po, pd = sample_primary_t(
        torch.from_numpy(item), torch.from_numpy(px), torch.from_numpy(py),
        seed, torch.from_numpy(cam), w=w, h=h, filter_type=filter_type,
        filter_param=filter_param)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_camera_record_layout():
    """The (32,) record: sample_to_cam's 16 values row-major, then
    cam_to_world's, on the scene's device."""
    scene = PT.make_cornell_box((48, 32))
    cam = camera_record(scene)
    assert cam.shape == (32,) and cam.dtype == torch.float32
    assert cam.device == scene.fp_tri.device
    for k, m in enumerate((scene.sample_to_cam, scene.cam_to_world)):
        assert m.shape == (4, 4)
        for r in range(4):
            for c in range(4):
                assert cam[16 * k + 4 * r + c] == m[r, c]
