"""Kernel K2's redesign on the CPU: its cast scans split over a group of G
threads a lane, and inactive lanes passed through.

- The split scans' rule (testing.group_closest / group_occluded, the torch
  mirror of csrc/path_advance.cuh intersect_range and occluded over a
  CastGroup) against the serial scans of path_kernel (`_intersect`,
  `_occluded`), bit for bit, for G = 1, 2, 4, 8 on the Cornell box with and without merged quads: numpy-seeded rays
  aimed at the prims' edges and corners (ties between neighbours and
  coplanar prims, the quads' back halves), random directions (misses), NaN
  origins and directions, and the cast table doubled (every hit an exact
  tie between a prim and its copy).
- The pass-through: advance_plain_t returns an inactive lane as it went in
  with alive false and its active lanes bit-equal to `_advance_core`; the
  per-bounce driver's film does not move.
"""

import numpy as np
import pytest
import torch

import lajolla_tpu_torch.testing as PT
from lajolla_tpu_torch.dtypes import intersection_eps, shadow_eps
from lajolla_tpu_torch.integrators.path import (MAX_BOUNCES_CAP,
                                                _render_block_kernel)
from lajolla_tpu_torch.integrators.path_kernel import (_advance_core,
                                                       _intersect,
                                                       _occluded,
                                                       advance_plain_t,
                                                       statics)
from lajolla_tpu_torch.scene import compile as PC
from lajolla_tpu_torch.scene.types import RenderOptions

from torch_threads import one_thread  # noqa: F401

GROUPS = (1, 2, 4, 8)
RAYS = 4096


def _no_quad_cbox(monkeypatch):
    monkeypatch.setattr(PC, 'MERGE_QUADS', False)
    scene = PT.make_cornell_box(16)
    assert not scene.meta.has_quads
    return scene


def _quad_cbox(monkeypatch):
    scene = PT.make_cornell_box(16)
    assert scene.meta.has_quads
    return scene


CBOXES = {'quad_cbox': _quad_cbox, 'no_quad_cbox': _no_quad_cbox}


def _rays(scene, seed):
    """(o, d) (3, RAYS) float32 CPU tensors and the segment lengths to
    each ray's target: origins inside the scene's bounds, a quarter of the
    rays aimed at random points of random triangles, a quarter at points
    on their edges, an eighth at their corners, the rest in random
    directions; 1/32 of the origins and 1/32 of the directions NaN."""
    rng = np.random.default_rng(seed)
    tri = scene.fp_tri.numpy().astype(np.float64)
    p0, e1, e2 = tri[0:3], tri[3:6], tri[6:9]
    pts = np.concatenate([p0, p0 + e1, p0 + e2], axis=1)
    lo, hi = pts.min(axis=1), pts.max(axis=1)
    o = lo[:, None] + (hi - lo)[:, None] * rng.uniform(0.05, 0.95, (3, RAYS))
    k = rng.integers(0, tri.shape[1], RAYS)
    s, r = rng.random(RAYS), rng.random(RAYS)
    inside = np.where(s + r > 1.0, 1.0 - s, s), np.where(s + r > 1.0,
                                                         1.0 - r, r)
    edge = rng.integers(0, 3, RAYS)
    b1 = np.where(edge == 0, s, np.where(edge == 1, 0.0, 1.0 - s))
    b2 = np.where(edge == 0, 0.0, np.where(edge == 1, s, s))
    corner = rng.integers(0, 3, RAYS)
    kind = rng.choice(4, RAYS, p=[0.25, 0.25, 0.125, 0.375])
    b1 = np.where(kind == 0, inside[0], np.where(
        kind == 2, (corner == 1).astype(float), b1))
    b2 = np.where(kind == 0, inside[1], np.where(
        kind == 2, (corner == 2).astype(float), b2))
    target = p0[:, k] + b1 * e1[:, k] + b2 * e2[:, k]
    d = target - o
    dist = np.linalg.norm(d, axis=0)
    rand = rng.normal(size=(3, RAYS))
    d = np.where(kind == 3, rand / np.linalg.norm(rand, axis=0), d / dist)
    dist = np.where(kind == 3, 10.0 * (hi - lo).max(), dist)
    o[:, rng.random(RAYS) < 1 / 32] = np.nan
    d[:, rng.random(RAYS) < 1 / 32] = np.nan
    f32 = np.float32
    return (torch.from_numpy(o.astype(f32)), torch.from_numpy(d.astype(f32)),
            torch.from_numpy(dist.astype(f32)))


@pytest.mark.parametrize('doubled', [False, True], ids=['table', 'doubled'])
@pytest.mark.parametrize('fixture', list(CBOXES))
@pytest.mark.parametrize('G', GROUPS)
def test_group_closest_matches_serial(G, fixture, doubled, monkeypatch):
    scene = CBOXES[fixture](monkeypatch)
    o, d, _ = _rays(scene, seed=5)
    W = scene.fp_woop
    qf = scene.cast_quad if scene.meta.has_quads else None
    if doubled:
        W = torch.cat([W, W])
        qf = None if qf is None else torch.cat([qf, qf])
    tnear = intersection_eps(scene.meta.scene_radius)
    t, idx, found, ub, vb, qb = _intersect(o, d, tnear, W, qf)
    gt, gi, gu, gv, gq = PT.group_closest(o, d, tnear, W, qf, G)
    assert torch.equal(gt, t[0])
    assert torch.equal(gi, idx[0])
    assert torch.equal(gu, ub[0]) and torch.equal(gv, vb[0])
    assert torch.equal(gq, qb[0])
    # the rays reach what the rule decides: hits, misses, ties
    assert 0.3 < found.float().mean() < 0.97
    nan = torch.isnan(o).any(0) | torch.isnan(d).any(0)
    assert nan.any() and not found[0, nan].any()
    if doubled:          # a prim and its copy tie on every hit
        assert (idx[0, found[0]] < scene.fp_woop.shape[0]).all()
    if qf is not None:   # hits on the quads' back halves
        assert ((qb > 0) & (ub + vb > 1.0)).any()


@pytest.mark.parametrize('fixture', list(CBOXES))
@pytest.mark.parametrize('G', GROUPS)
def test_group_occluded_matches_serial(G, fixture, monkeypatch):
    scene = CBOXES[fixture](monkeypatch)
    o, d, dist = _rays(scene, seed=7)
    eps = shadow_eps(scene.meta.scene_radius)
    tfar = (1.0 - eps) * dist
    W = scene.fp_woop_occ
    qf = scene.cast_occ_quad if scene.meta.has_quads else None
    want = _occluded(o, d, eps, tfar, W, qf)[0]
    assert torch.equal(PT.group_occluded(o, d, eps, tfar, W, qf, G), want)
    assert 0.05 < want.float().mean() < 0.95


LANE_SCENES = {
    'quad_cbox': _quad_cbox,
    'no_quad_cbox': _no_quad_cbox,
    'sphere_lights': lambda mp: PT.make_sphere_light_scene(16),
}


@pytest.mark.parametrize('fixture', list(LANE_SCENES))
def test_advance_plain_passes_inactive_lanes_through(fixture, monkeypatch):
    scene = LANE_SCENES[fixture](monkeypatch)
    options = RenderOptions()
    lanes = {k: torch.from_numpy(v)
             for k, v in PT.random_lanes(scene, 4096, seed=3).items()}
    args = [lanes[k] for k in ('org', 'dir', 'thr', 'rad', 'nv', 'dir_pdf',
                               'prev', 'un', 'act')]
    org, d, thr, rad, dp, prev, alive = advance_plain_t(
        scene, options, *args, MAX_BOUNCES_CAP)
    assert prev is org
    act = lanes['act']
    off = ~act
    assert off.any() and act.any()
    for got, x in ((org, 'org'), (d, 'dir'), (thr, 'thr'), (rad, 'rad')):
        assert torch.equal(got[:, off], lanes[x][:, off]), x
    assert torch.equal(dp[off], lanes['dir_pdf'][off])
    assert not alive[off].any()
    core = _advance_core(
        scene, lanes['org'], lanes['dir'], lanes['thr'], lanes['rad'],
        lanes['nv'].float()[None], lanes['dir_pdf'][None], lanes['prev'],
        lanes['un'], act[None], **statics(scene, options, MAX_BOUNCES_CAP))
    for got, want in zip((org, d, thr, rad), core[:4]):
        assert torch.equal(got[:, act], want[:, act])
    assert torch.equal(dp[act], core[4][0, act])
    assert torch.equal(alive, core[5][0])
    assert alive.any()


def _advance_core_t(scene, options, orgT, dirT, thrT, radT, nv, dir_pdf,
                    prevT, uniformsT, active, max_cap):
    """advance_plain_t without the pass-through: `_advance_core`'s vertex
    for every lane, inactive ones included (lajolla_tpu's kernel)."""
    org, d, thr, rad, dp, alive = _advance_core(
        scene, orgT, dirT, thrT, radT, nv.float()[None], dir_pdf[None],
        prevT, uniformsT, active[None], **statics(scene, options, max_cap))
    return org, d, thr, rad, dp[0], org, alive[0]


@pytest.mark.parametrize('fixture', ['cbox_24', 'sphere_lights'])
def test_driver_film_unchanged_by_pass_through(fixture):
    scene = (PT.make_cornell_box(24) if fixture == 'cbox_24' else
             PT.make_sphere_light_scene(16))
    options = RenderOptions()
    films = [_render_block_kernel(scene, options, 0, 0, 2, advance=a)
             for a in (advance_plain_t, _advance_core_t)]
    assert torch.equal(*films)
    assert films[0].sum() > 0
