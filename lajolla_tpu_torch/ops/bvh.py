"""BVH: host-side build (numpy) + threaded traversal, batched over rays.

Port of lajolla_tpu/ops/bvh.py, the replacement for Embree's build
(src/intersection.cpp:32,83; scene.cpp:20-27).

* Build (host, at scene compile): the native binned-SAH build when a
  host C++ compiler is there, else Morton-sorted centroids under a
  balanced median-split tree with level-by-level numpy AABBs. The native
  one is the repository's csrc/bvh_builder.cpp, compiled at first
  use into build/lajolla_tpu_torch/ and loaded with ctypes, as the CUDA
  kernels are (kernels.py). It is built without -march=native, so that
  two machines build the same tree from the same triangles.

* Layout: *threaded* (stackless) preorder. Each node stores lo/hi AABB,
  `first` (preorder child index for inner nodes, prim offset for
  leaves), `count` (0 = inner), and `skip` = preorder index of the node
  after its subtree. Traversal is one `while node < N` loop: advance to
  `first` on an AABB hit (inner) or to `skip` otherwise.

`bvh_traverse` / `bvh_occluded` walk that layout for a batch of rays in
lockstep (every live ray takes one node per iteration). They are the
oracle the tests hold the cluster casters against and no path of
`render()`: a scene with a BVH always has the cluster tables, and its
casts go to ops/intersect_sweep.py (scene/geometry.py).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from lajolla_tpu_torch.ops.intersect import INF, ray_bounds, ray_triangle

LEAF_SIZE = 4

_SAH_SOURCE = Path(__file__).resolve().parents[2] / 'csrc' / \
    'bvh_builder.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'lajolla_tpu_torch'
CXX_FLAGS = ('-O3', '-fPIC', '-std=c++17', '-shared')


# ---------------------------------------------------------------------------
# Host build
# ---------------------------------------------------------------------------

def _morton3(x, y, z):
    """Interleave 10-bit x,y,z → 30-bit Morton code (vectorized)."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v
    return spread(x) | (spread(y) << np.uint64(1)) | (spread(z) << np.uint64(2))


_LIBBVH = None   # None: not tried; False: no compiler or no source


def _load_libbvh():
    """ctypes handle to the native binned-SAH build, compiled at first
    use from csrc/bvh_builder.cpp with the host C++ compiler; None where
    there is no compiler or no source (the Morton build serves)."""
    global _LIBBVH
    if _LIBBVH is not None:
        return _LIBBVH or None
    _LIBBVH = False
    cxx = shutil.which(os.environ.get('CXX', 'g++')) or shutil.which('c++')
    if cxx is None or not _SAH_SOURCE.exists():
        return None
    tag = hashlib.sha256(_SAH_SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f'liblj_bvh_{tag}.so'
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f'.liblj_bvh_{tag}.{os.getpid()}.so'
        done = subprocess.run([cxx, *CXX_FLAGS, '-o', str(tmp),
                               str(_SAH_SOURCE)], capture_output=True,
                              text=True, timeout=300)
        if done.returncode != 0:
            raise RuntimeError(f"{cxx} {_SAH_SOURCE.name} failed:\n"
                               f"{done.stderr[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    lib.bvh_build_sah.restype = ctypes.c_int32
    lib.bvh_build_sah.argtypes = [fp, fp, ctypes.c_int32, ctypes.c_int32,
                                  ip, fp, fp, ip, ip, ip]
    _LIBBVH = lib
    return lib


def _build_bvh_sah(tri_lo, tri_hi, leaf_size):
    """Native binned-SAH build → threaded layout (csrc/bvh_builder.cpp)."""
    lib = _load_libbvh()
    if lib is None:
        return None
    T = tri_lo.shape[0]
    cap = 2 * T
    lo = np.ascontiguousarray(tri_lo, np.float32)
    hi = np.ascontiguousarray(tri_hi, np.float32)
    prim = np.zeros(T, np.int32)
    out_lo = np.zeros((cap, 3), np.float32)
    out_hi = np.zeros((cap, 3), np.float32)
    out_first = np.zeros(cap, np.int32)
    out_count = np.zeros(cap, np.int32)
    out_skip = np.zeros(cap, np.int32)
    fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    n = lib.bvh_build_sah(fptr(lo), fptr(hi), T, leaf_size, iptr(prim),
                          fptr(out_lo), fptr(out_hi), iptr(out_first),
                          iptr(out_count), iptr(out_skip))
    return dict(lo=out_lo[:n], hi=out_hi[:n], first=out_first[:n],
                count=out_count[:n], skip=out_skip[:n], prim=prim,
                n_nodes=int(n))


def build_bvh_morton(tri_lo, tri_hi, leaf_size=LEAF_SIZE):
    """The Morton median-split build (T > 0): the same layout as
    build_bvh."""
    T = tri_lo.shape[0]
    centers = 0.5 * (tri_lo + tri_hi)
    cmin, cmax = centers.min(0), centers.max(0)
    ext = np.maximum(cmax - cmin, 1e-12)
    q = np.clip(((centers - cmin) / ext) * 1023.0, 0, 1023).astype(np.uint32)
    codes = _morton3(q[:, 0], q[:, 1], q[:, 2])
    order = np.argsort(codes, kind='stable').astype(np.int32)
    lo_s, hi_s = tri_lo[order], tri_hi[order]

    # --- topology: median split over sorted order, BFS ---------------------
    starts = [0]
    ends = [T]
    left = [-1]
    levels = [[0]]
    while True:
        cur = levels[-1]
        nxt = []
        for n in cur:
            if ends[n] - starts[n] > leaf_size:
                mid = (starts[n] + ends[n]) // 2
                l = len(starts)
                left[n] = l
                starts += [starts[n], mid]
                ends += [mid, ends[n]]
                left += [-1, -1]
                nxt += [l, l + 1]
        if not nxt:
            break
        levels.append(nxt)

    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    left = np.asarray(left, np.int64)
    N = len(starts)
    is_leaf = left < 0

    # --- AABBs --------------------------------------------------------------
    # The full set of leaves tiles [0, T) in sorted order, so one global
    # reduceat computes every leaf AABB; inner nodes then union their
    # children level-by-level bottom-up.
    lo_n = np.empty((N, 3), np.float64)
    hi_n = np.empty((N, 3), np.float64)
    leaf_ids = np.nonzero(is_leaf)[0]
    srt = leaf_ids[np.argsort(starts[leaf_ids])]
    lo_n[srt] = np.minimum.reduceat(lo_s, starts[srt])
    hi_n[srt] = np.maximum.reduceat(hi_s, starts[srt])
    for lvl in levels[::-1]:
        lvl = np.asarray(lvl)
        inner_ids = lvl[~is_leaf[lvl]]
        if inner_ids.size:
            l = left[inner_ids]
            lo_n[inner_ids] = np.minimum(lo_n[l], lo_n[l + 1])
            hi_n[inner_ids] = np.maximum(hi_n[l], hi_n[l + 1])

    # --- preorder threading --------------------------------------------------
    size = np.ones(N, np.int64)
    for lvl in levels[::-1]:
        lvl = np.asarray(lvl)
        inner_ids = lvl[~is_leaf[lvl]]
        if inner_ids.size:
            l = left[inner_ids]
            size[inner_ids] = 1 + size[l] + size[l + 1]
    pre = np.zeros(N, np.int64)
    for lvl in levels:
        lvl = np.asarray(lvl)
        inner_ids = lvl[~is_leaf[lvl]]
        if inner_ids.size:
            l = left[inner_ids]
            pre[l] = pre[inner_ids] + 1
            pre[l + 1] = pre[inner_ids] + 1 + size[l]

    out_lo = np.empty((N, 3), np.float32)
    out_hi = np.empty((N, 3), np.float32)
    out_first = np.empty(N, np.int32)
    out_count = np.empty(N, np.int32)
    out_skip = np.empty(N, np.int32)
    out_lo[pre] = lo_n.astype(np.float32)
    out_hi[pre] = hi_n.astype(np.float32)
    out_first[pre] = np.where(is_leaf, starts,
                              pre[np.maximum(left, 0)]).astype(np.int32)
    out_count[pre] = np.where(is_leaf, ends - starts, 0).astype(np.int32)
    out_skip[pre] = (pre + size).astype(np.int32)

    return dict(lo=out_lo, hi=out_hi, first=out_first, count=out_count,
                skip=out_skip, prim=order, n_nodes=N)


def empty_bvh(num_prims=0):
    """The one-node tree of a scene without a BVH: `prim` is the identity
    over num_prims (at least one) slots."""
    return dict(lo=np.zeros((1, 3), np.float32),
                hi=np.zeros((1, 3), np.float32),
                first=np.zeros(1, np.int32), count=np.zeros(1, np.int32),
                skip=np.ones(1, np.int32),
                prim=np.arange(num_prims, dtype=np.int32), n_nodes=1)


def build_bvh(tri_lo, tri_hi, leaf_size=LEAF_SIZE):
    """Returns dict of numpy arrays: lo (N,3), hi (N,3), first (N,),
    count (N,), skip (N,), prim (T,) — the preorder threaded layout.
    Prefers the native SAH build; falls back to the Morton median-split
    one."""
    T = tri_lo.shape[0]
    if T == 0:
        return empty_bvh()
    tri_lo = np.asarray(tri_lo, np.float32)
    tri_hi = np.asarray(tri_hi, np.float32)
    sah = _build_bvh_sah(tri_lo, tri_hi, leaf_size)
    if sah is not None:
        return sah
    return build_bvh_morton(tri_lo, tri_hi, leaf_size)


# ---------------------------------------------------------------------------
# Traversal, every ray one node per iteration
# ---------------------------------------------------------------------------

def _safe_inv(d):
    tiny = 1e-12
    big = torch.where(d >= 0, 1e12, -1e12)
    ok = torch.abs(d) > tiny
    return torch.where(ok, 1.0 / torch.where(ok, d, 1.0), big)


def _walk(scene, o, d, tnear, tfar, any_hit):
    n_nodes = scene.bvh_node.shape[0]
    max_slot = scene.bvh_leaf_tri.shape[0] - 1
    N = o.shape[0]
    dev = o.device
    tnear, tfar = ray_bounds(o, tnear, tfar)
    inv_d = _safe_inv(d)
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    t_best = torch.clamp(tfar, max=INF)
    prim = torch.full((N,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(N, device=dev)
    bv = torch.zeros(N, device=dev)
    found = torch.zeros(N, dtype=torch.bool, device=dev)
    while True:
        live = node < n_nodes
        if any_hit:
            live = live & ~found
        if not bool(live.any()):
            break
        # torch raises on an index past the end where XLA clamps it
        row = scene.bvh_node[torch.clamp(node, max=n_nodes - 1)]
        lo, hi = row[:, 0:3], row[:, 3:6]
        first = row[:, 6].long()
        count = row[:, 7].long()
        skip = row[:, 8].long()
        t0 = (lo - o) * inv_d
        t1 = (hi - o) * inv_d
        tmin = torch.maximum(torch.minimum(t0, t1).amax(dim=1), tnear)
        tmax = torch.minimum(torch.maximum(t0, t1).amin(dim=1),
                             tfar if any_hit else t_best)
        hit_box = tmin <= tmax
        is_leaf = count > 0
        test = hit_box & is_leaf & live
        for k in range(LEAF_SIZE):
            slot = torch.clamp(first + k, min=0, max=max_slot)
            trow = scene.bvh_leaf_tri[slot]
            t, u, v, h = ray_triangle(o, d, trow[:, 0:3], trow[:, 3:6],
                                      trow[:, 6:9], tnear,
                                      tfar if any_hit else t_best)
            h = h & test & (k < count)
            if any_hit:
                found = found | h
            else:
                t_best = torch.where(h, t, t_best)
                prim = torch.where(h, trow[:, 9].to(torch.int32), prim)
                bu = torch.where(h, u, bu)
                bv = torch.where(h, v, bv)
        nxt = torch.where(hit_box & ~is_leaf, first, skip)
        node = torch.where(live, nxt, node)
    if any_hit:
        return found
    return torch.where(prim < 0, INF, t_best), prim, bu, bv


def bvh_traverse(scene, o, d, tnear, tfar):
    """Closest-hit traversal of (N, 3) rays. Returns (t, prim, u, v), each
    (N,); prim = -1 and t = inf on a miss."""
    return _walk(scene, o, d, tnear, tfar, any_hit=False)


def bvh_occluded(scene, o, d, tnear, tfar):
    """Any-hit traversal with early exit per ray. Returns (N,) bool."""
    return _walk(scene, o, d, tnear, tfar, any_hit=True)
