"""The lockstep proxies of kernel K1's thread mappings
(tools/profile_torch_path.py --proxies), with no card: the proxy
arithmetic on counts whose answer is known by hand, and the plain form's
per-lane, per-sample vertex counts on a small Cornell box, which must add
up to the vertices the plain form advanced."""

import os
import sys

import pytest
import torch

from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import profile_torch_path as TP  # noqa: E402


def test_proxies_by_hand():
    """A 16x4 film, 2 samples: every lane takes 1 vertex a sample except
    pixel (0, 0), which takes 3 in sample 0 and pixel (15, 3), 2 in
    sample 1. Row warps are pixels 0-31 (rows 0-1) and 32-63; tile warps
    the 8x4 tiles at x 0 and x 8."""
    w, h = 16, 4
    c = torch.ones((2, h * w), dtype=torch.int64)
    c[0, 0] = 3
    c[1, h * w - 1] = 2
    p = TP.lockstep_proxies(torch, c, w, h)
    work = 2 * 64 + 2 + 1
    # nested: each warp pays its longest path per sample
    assert p['row']['nested'] == pytest.approx(work / (32 * (3 + 1 + 1 + 2)))
    # flat: each warp pays its lane with the most vertices over the samples
    assert p['row']['flat'] == pytest.approx(work / (32 * (4 + 3)))
    assert p['tile']['nested'] == p['row']['nested']
    assert p['tile']['flat'] == p['row']['flat']


def test_tile_mapping_groups_8x4_pixels():
    """One slow pixel a tile row apart: in rows of 32 two warps hold one
    each, in 8x4 tiles one warp holds both."""
    w, h = 16, 4
    c = torch.ones((1, h * w), dtype=torch.int64)
    c[0, 0] = c[0, 2 * w] = 5          # pixels (0, 0) and (0, 2)
    p = TP.lockstep_proxies(torch, c, w, h)
    work = 64 + 8
    assert p['row']['flat'] == pytest.approx(work / (32 * (5 + 5)))
    assert p['tile']['flat'] == pytest.approx(work / (32 * (5 + 1)))


def test_plain_form_counts_every_vertex(monkeypatch):
    """--proxies on an 8x8 Cornell box at 2 spp: the counts add up to the
    active lanes of every advance the plain form made, each sample of each
    lane takes at least one vertex, and the flat loop's proxy is at least
    the nested one's."""
    from lajolla_tpu_torch.integrators import path_kernel as PK
    active = []
    real = PK.advance_plain_t

    def counting(scene, options, *a):
        active.append(int(a[8].sum()))
        return real(scene, options, *a)
    monkeypatch.setattr(PK, 'advance_plain_t', counting)
    args = type('Args', (), dict(res=8, spp=2))
    out = TP.proxies(args)
    assert out['vertices_per_path'] * 8 * 8 * 2 == sum(active)
    assert out['longest_path'] >= 1
    for mapping in ('row', 'tile'):
        p = out['proxies'][mapping]
        assert 0.0 < p['nested'] <= p['flat'] <= 1.0
