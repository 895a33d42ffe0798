"""Large-scene casting end to end on the CPU: the mesh Cornell box (a
displaced sphere of 440 triangles in the Cornell box: 462 triangles, so a
BVH, cluster tables and the sweep casters) through the port's `render()`
against lajolla_tpu's `render_path`.

lajolla_tpu off the TPU casts with `intersect_binned` and drains the tail
of each block through its host-side cascade; the port casts with the
plain forms of kernels K5 + K4 and runs the queue to its end. Both draw
the same (seed, item, bounce, dim) random numbers, so the films agree
except where a last-bit difference flips a comparison: median per-pixel
relative difference < 1e-4, means within 1% (the gates of
tests/test_torch_slice.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import lajolla_tpu.integrators.path as JPATH
import lajolla_tpu.scene.compile as JC
from lajolla_tpu.scene.types import RenderOptions as JOptions
import lajolla_tpu_torch.integrators.path as PPATH
import lajolla_tpu_torch.ops.intersect_binned as PIB
import lajolla_tpu_torch.ops.intersect_sweep as PSW
import lajolla_tpu_torch.scene.geometry as PG
import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch import cli, kernels, parse_scene, render
from lajolla_tpu_torch.bridge import scene_from_jax as to_port
from lajolla_tpu_torch.integrators import path_kernel
from lajolla_tpu_torch.io.image import imread3
from lajolla_tpu_torch.scene.types import RenderOptions

from torch_threads import one_thread  # noqa: F401

FILM = (32, 24)


@pytest.fixture(scope='module')
def mesh_scenes():
    """(lajolla_tpu scene, the port's scene from the same bytes)."""
    js = JC.compile_scene(PT.cornell_box_builder(FILM, 2, 'mesh'))
    return js, to_port(js)


def assert_films_agree(got, want):
    assert np.isfinite(got).all() and np.isfinite(want).all()
    rel = np.abs(got - want) / (want + 1e-3)
    assert np.median(rel) < 1e-4, np.median(rel)
    assert abs(got.mean() - want.mean()) / want.mean() < 0.01


def test_render_matches_jax_render_path(mesh_scenes, monkeypatch):
    js, ps = mesh_scenes
    assert ps.meta.use_binned and ps.meta.num_triangles == 462
    assert not path_kernel.supports(ps.meta)
    want = np.asarray(JPATH.render_path(js, JOptions(samples_per_pixel=2)))
    blocks = []
    real = PPATH._render_block_sc

    def spy(scene, options, seed, s0, nspp, lanes=None):
        blocks.append((s0, nspp, lanes))
        return real(scene, options, seed, s0, nspp, lanes)
    monkeypatch.setattr(PPATH, '_render_block_sc', spy)
    got = render(ps, RenderOptions(samples_per_pixel=2), device='cpu')
    # the schedule of lajolla_tpu's render_path: blocks of one sample, a
    # pool of min(n, 8192) lanes
    n = FILM[0] * FILM[1]
    assert blocks == [(0, 1, n), (1, 1, n)]
    stats = JPATH.QUEUE_STATS
    assert stats['lanes'] == n and stats['paths'] == n
    assert 0.05 < want.mean() < 5.0
    assert_films_agree(got, want)


def test_queue_with_a_small_pool_matches_jax(mesh_scenes):
    """lanes < pixels: the padded stride n_q = ceil(n / lanes) * lanes sets
    the work items (dummy items past the film included), so both queues
    must draw the same numbers for the same pool."""
    js, ps = mesh_scenes
    lanes = 320                                   # n = 768 -> n_q = 960
    jfilm, _, jiters = JPATH._render_block_sc(js, JOptions(), 0, 1, 1,
                                              lanes=lanes)
    film, st, iters = PPATH._render_block_sc(ps, RenderOptions(), 0, 1, 1,
                                             lanes=lanes)
    assert film.shape == (960, 3) and bool(st[11].all())
    assert int(jiters) == iters
    n = FILM[0] * FILM[1]
    assert_films_agree(film.numpy()[:n], np.asarray(jfilm)[:n])


def test_schedule_of_scenes_with_cluster_tables(mesh_scenes):
    _, ps = mesh_scenes

    def with_meta(**kw):
        return dataclasses.replace(
            ps, meta=dataclasses.replace(ps.meta, **kw))
    assert PPATH._schedule(ps) == (1, 768)
    assert PPATH._schedule(with_meta(width=683, height=512)) == (1, 8192)
    assert PPATH._schedule(with_meta(width=768, height=575,
                                     num_triangles=1 << 17)) == (1, 16384)
    assert PPATH._schedule(with_meta(width=768, height=575,
                                     num_triangles=(1 << 17) - 1)) == \
        (1, 8192)
    small = PT.make_cornell_box(8)
    assert PPATH._schedule(small) == (PPATH.KERNEL_SPP_BLOCK, 64)
    glass = PT.make_cornell_box(8, variant='glass')
    assert PPATH._schedule(glass) == (PPATH.SPP_BLOCK, 64)


def test_casts_dispatch_on_cluster_tables(mesh_scenes, monkeypatch):
    """A scene with cluster tables casts through the sweeps, a small one
    through K3's wrappers, whatever else the scene holds."""
    _, ps = mesh_scenes
    calls = []
    for name in ('sweep_resident', 'sweep_resolve', 'intersect_brute',
                 'occluded_brute'):
        def wrapped(*a, _f=getattr(kernels, name), _n=name, **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(kernels, name, wrapped)
    rays = PT.general_rays(ps, seed=3)
    calls.clear()
    PG.intersect_triangles(ps, *rays['bounce'])
    PG.occluded(ps, *rays['shadow'])
    assert calls == ['sweep_resident', 'sweep_resolve', 'sweep_resident']
    small = PT.make_cornell_box(FILM, variant='glass')
    rays = PT.general_rays(small, seed=3)
    calls.clear()
    PG.intersect_triangles(small, *rays['bounce'])
    PG.occluded(small, *rays['shadow'])
    assert calls == ['intersect_brute', 'occluded_brute']
    assert not hasattr(PG, '_no_large_scenes')


@pytest.mark.parametrize('kind', ['camera', 'bounce', 'shadow'])
def test_engine_rays_against_the_binned_caster(mesh_scenes, kind):
    """The rays the engine casts (shared mesh edges, shadow rays that end
    on the light) through the sweeps and the independent caster."""
    _, ps = mesh_scenes
    ray = PT.general_rays(ps, seed=13)[kind]
    t, prim, u, v = PSW.intersect_sweep(ps, *ray)
    bt, bprim, bu, bv = PIB.intersect_binned(ps, *ray)
    assert torch.allclose(t, bt, rtol=3e-4, atol=3e-5)
    assert (prim == bprim).float().mean() >= 0.995
    same = (prim == bprim) & (bprim >= 0)
    assert torch.allclose(u[same], bu[same], atol=1e-4)
    assert torch.allclose(v[same], bv[same], atol=1e-4)
    assert ((prim >= 0) == torch.isfinite(t)).all()
    assert (PSW.occluded_sweep(ps, *ray) ==
            PIB.occluded_binned(ps, *ray)).all()


def test_a_block_stops_before_its_list_ends():
    """256 rays from the camera onto the middle of a 3500-triangle sphere:
    the block lists the clusters at the sphere's back and the walls behind
    it, and stops before it reaches them."""
    scene = PT.make_cornell_box(FILM, 1, 'mesh', triangles=3500)
    rng = np.random.default_rng(4)
    eye = np.asarray(PT.CBOX_CAMERA['origin'])
    aim = np.asarray(PT.MESH_SPHERE['center']) + rng.uniform(
        -0.08, 0.08, (PSW.LIST_B, 3))
    d = aim - eye
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = torch.from_numpy(np.broadcast_to(eye, d.shape).astype(np.float32))
    d = torch.from_numpy(d.astype(np.float32))
    tn = torch.full((PSW.LIST_B,), 1e-4)
    tf = torch.full((PSW.LIST_B,), float('inf'))
    K = scene.sw_aabb.shape[0]
    packed, counts, clist, tlist = PSW.list_inputs(scene, o, d, tn, tf,
                                                   PSW.LIST_B, K)
    stats = {}
    t, kid = PSW.sweep_resident_plain(packed, scene.sw_lane, scene.sw_aabb,
                                      counts, clist, tlist, False,
                                      stats=stats)
    assert torch.isfinite(t).all() and (kid >= 0).all()
    assert 0 < stats['entries'] < int(counts.sum())
    assert torch.equal(t, PIB.intersect_binned(scene, o, d, tn, tf)[0])


def test_streaming_route_renders_the_same_film(mesh_scenes, monkeypatch):
    """Tables repacked at 64 triangles a cluster take K7's route through
    render() and give the film of the 128-a-cluster tables."""
    _, ps = mesh_scenes
    ps64 = PT.repack_clusters(ps, 64)
    assert ps64.sw_lane.shape[2] == 64 and ps64.cl_prim.shape[1] == 64
    calls = []
    real = kernels.sweep_streaming
    monkeypatch.setattr(kernels, 'sweep_streaming',
                        lambda *a: calls.append(1) or real(*a))
    opt = RenderOptions(samples_per_pixel=1)
    got = render(ps64, opt, device='cpu')
    assert calls
    assert_films_agree(got, render(ps, opt, device='cpu'))


def test_volpath_engine_reaches_the_sweeps(monkeypatch):
    """The general volumetric engine casts through the same two functions:
    the mesh box under volpath (no media) with the sweeps against it with
    the independent caster."""
    b = PT.cornell_box_builder((16, 12), 1, 'mesh')
    b.options = RenderOptions(integrator='volpath', samples_per_pixel=1)
    scene = PT.compile_scene(b)
    calls = []
    real = kernels.sweep_resident
    monkeypatch.setattr(kernels, 'sweep_resident',
                        lambda *a: calls.append(1) or real(*a))
    got = render(scene, b.options, device='cpu')
    assert calls
    monkeypatch.setattr(PG, 'intersect_sweep', PIB.intersect_binned)
    monkeypatch.setattr(PG, 'occluded_sweep', PIB.occluded_binned)
    assert_films_agree(got, render(scene, b.options, device='cpu'))


def test_cli_renders_the_mesh_box_xml(tmp_path):
    """XML + OBJ written by testing, parsed, compiled, rendered, written:
    the parsed scene is the one
    cornell_box_builder makes."""
    xml = PT.write_cornell_box_xml(str(tmp_path), FILM, 1, variant='mesh')
    assert (tmp_path / 'mesh.obj').exists()
    parsed, opt = parse_scene(xml, 'cpu')
    built = PT.make_cornell_box(FILM, 1, 'mesh')
    assert parsed.meta == built.meta and opt.samples_per_pixel == 1
    for f in dataclasses.fields(built):
        if f.name != 'meta':
            assert torch.equal(getattr(parsed, f.name),
                               getattr(built, f.name)), f.name
    out = str(tmp_path / 'mesh.exr')
    assert cli.main([xml, '-o', out, '--device', 'cpu']) == 0
    img = imread3(out)
    assert img.shape == (FILM[1], FILM[0], 3) and np.isfinite(img).all()
    assert 0.05 < img.mean() < 5.0


@pytest.mark.parametrize('triangles,n', [(440, 11), (3500, 30),
                                         (56000, 119)])
def test_displaced_sphere_is_a_closed_outward_mesh(triangles, n):
    pos, idx, uvs = PT.displaced_sphere(triangles)
    assert idx.shape == (4 * n * (n - 1), 3) and idx.dtype == np.int32
    assert pos.shape == (2 + 2 * n * (n - 1), 3) and uvs.shape[1] == 2
    # every edge is shared by exactly two triangles, once in each sense
    edges = np.concatenate([idx[:, [0, 1]], idx[:, [1, 2]], idx[:, [2, 0]]])
    fwd = {(a, b) for a, b in edges.tolist()}
    assert len(fwd) == len(edges)
    assert all((b, a) in fwd for a, b in fwd)
    tri = pos[idx]
    normal = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    out = tri.mean(axis=1) - np.asarray(PT.MESH_SPHERE['center'])
    assert (np.einsum('ij,ij->i', normal, out) > 0).all()
    assert np.linalg.norm(normal, axis=1).min() > 0
    # the vertices come in the order the faces first name them
    _, first = np.unique(idx.reshape(-1), return_index=True)
    assert (np.argsort(first) == np.arange(len(pos))).all()
    assert pos[:, 1].min() > -1.0 and pos[:, 1].max() < 0.0
