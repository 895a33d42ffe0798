"""Binned two-level intersector for large scenes: the cluster build, and
the plain reference of the whole cluster caster.

Port of lajolla_tpu/ops/intersect_binned.py. Ray casting as dense
compute over a flat two-level hierarchy:

  build:  cut the SAH tree into treelets ("clusters") of <= C triangles;
          store per-cluster AABBs and dense Woop transform blocks.
  phase A: slab-test every ray against every cluster AABB — a dense
          (N, K) elementwise pass, per axis.
  phase B: ordered rounds. Each round, every ray takes its nearest
          unvisited cluster (argmin over the (N, K) entry distances),
          fetches that cluster's triangle block with one wide gather,
          and intersects all C triangles as a dense batched product.
          Rays whose best hit is already closer than their next
          cluster's entry distance stop contributing; the loop ends
          when no ray can improve, which gives front-to-back early
          termination without any stack.

`build_clusters` runs at scene compile (scene/compile.py).
`intersect_binned` / `occluded_binned` are not a route of `render()`:
they are the independent reference the tests and chip_smoke.py hold the
sweep casters (ops/intersect_sweep.py, kernels K4-K7) against.
"""

import numpy as np
import torch

from lajolla_tpu_torch.ops.intersect import INF, ray_bounds

CLUSTER_TRIS = 256       # C (compile_scene passes 128 for the sweep path)
MAX_ROUNDS = 256         # safety bound on ordered rounds


# ---------------------------------------------------------------------------
# Host build: cut the threaded SAH tree into treelets
# ---------------------------------------------------------------------------

def build_clusters(bvh, tri_p0, tri_e1, tri_e2, max_tris=CLUSTER_TRIS):
    """bvh: threaded arrays from ops.bvh.build_bvh (preorder, skip links).
    Returns dict with cl_lo/cl_hi (K,3), cl_A (K,3,3C), cl_b (K,3C),
    cl_prim (K,C) int32 (-1 pad), n_clusters."""
    first = bvh['first']
    count = bvh['count']
    skip = bvh['skip']
    lo = bvh['lo']
    hi = bvh['hi']
    prim = bvh['prim']
    n = len(first)

    # subtree prim ranges are contiguous in leaf order
    clusters = []

    def subtree_prims(i):
        j = skip[i]
        f = first[i:j]
        c = count[i:j]
        leaf = c > 0
        s = int(f[leaf].min())
        e = int((f[leaf] + c[leaf]).max())
        return s, e - s

    i = 0
    while i < n:
        s, c = subtree_prims(i)
        if c <= max_tris:
            clusters.append((i, s, c))
            i = skip[i]
        else:
            i += 1

    K = len(clusters)
    C = max_tris
    cl_lo = np.zeros((K, 3), np.float32)
    cl_hi = np.zeros((K, 3), np.float32)
    cl_A = np.zeros((K, 3, 3 * C), np.float32)
    cl_b = np.zeros((K, 3 * C), np.float32)
    cl_prim = np.full((K, C), -1, np.int32)

    for ci, (node, s, c) in enumerate(clusters):
        cl_lo[ci] = lo[node]
        cl_hi[ci] = hi[node]
        tri_ids = prim[s:s + c]
        cl_prim[ci, :c] = tri_ids
        p0 = tri_p0[tri_ids]
        e1 = tri_e1[tri_ids]
        e2 = tri_e2[tri_ids]
        nvec = np.cross(e1, e2)
        M = np.stack([e1, e2, nvec], axis=-1)
        dets = np.linalg.det(M)
        ok = np.abs(dets) > 1e-18
        Minv = np.zeros_like(M)
        if ok.any():
            Minv[ok] = np.linalg.inv(M[ok])
        bvec = -np.einsum('tij,tj->ti', Minv, p0)
        for axis in range(3):
            cl_A[ci, :, axis * C:axis * C + c] = Minv[:, axis, :].T
            cl_b[ci, axis * C:axis * C + c] = bvec[:, axis]
    return dict(cl_lo=cl_lo, cl_hi=cl_hi, cl_A=cl_A, cl_b=cl_b,
                cl_prim=cl_prim, n_clusters=K)


# ---------------------------------------------------------------------------
# Query
# ---------------------------------------------------------------------------

def _cluster_entry(scene, o, d, tnear, tfar):
    """(N,) rays → (N, K) cluster AABB entry distances (INF = miss).
    Per-axis; all intermediates (N, K)."""
    safe = torch.where(torch.abs(d) > 1e-20, d, 1e-20)
    inv = 1.0 / safe
    K = scene.cl_lo.shape[0]
    tmin = tnear[:, None].expand(o.shape[0], K)
    tmax = tfar[:, None].expand(o.shape[0], K)
    for ax in range(3):
        t0 = (scene.cl_lo[None, :, ax] - o[:, ax, None]) * inv[:, ax, None]
        t1 = (scene.cl_hi[None, :, ax] - o[:, ax, None]) * inv[:, ax, None]
        tmin = torch.maximum(tmin, torch.minimum(t0, t1))
        tmax = torch.minimum(tmax, torch.maximum(t0, t1))
    return torch.where(tmin <= tmax, tmin, INF)


def _round(scene, o, d, tnear, tfar, st):
    """One ordered round: nearest unvisited cluster per ray, dense test."""
    entry, best_t, best_prim, best_u, best_v = st
    N = o.shape[0]
    C = scene.cl_prim.shape[1]
    rows = torch.arange(N, device=o.device)

    cid = torch.argmin(entry, dim=1)                   # (N,)
    t_ent = entry[rows, cid]
    live = t_ent < best_t                              # can still improve
    entry = entry.clone()
    entry[rows, cid] = INF                             # consume

    A = scene.cl_A[cid]                                # (N, 3, 3C)
    bvec = scene.cl_b[cid]                             # (N, 3C)
    prims = scene.cl_prim[cid]                         # (N, C)
    op_ = (o[:, 0:1] * A[:, 0] + o[:, 1:2] * A[:, 1] + o[:, 2:3] * A[:, 2]
           + bvec)
    dp_ = d[:, 0:1] * A[:, 0] + d[:, 1:2] * A[:, 1] + d[:, 2:3] * A[:, 2]
    ox, oy, oz = op_[:, :C], op_[:, C:2 * C], op_[:, 2 * C:]
    dx, dy, dz = dp_[:, :C], dp_[:, C:2 * C], dp_[:, 2 * C:]
    safe_dz = torch.where(torch.abs(dz) > 1e-12, dz, 1.0)
    t = -oz / safe_dz
    u = ox + t * dx
    v = oy + t * dy
    hit = ((torch.abs(dz) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) &
           (t > tnear[:, None]) &
           (t < torch.minimum(tfar, best_t)[:, None]) &
           (prims >= 0) & live[:, None])
    t = torch.where(hit, t, INF)
    j = torch.argmin(t, dim=1)
    t_new = t[rows, j]
    better = t_new < best_t
    best_t = torch.where(better, t_new, best_t)
    best_prim = torch.where(better, prims[rows, j], best_prim)
    best_u = torch.where(better, u[rows, j], best_u)
    best_v = torch.where(better, v[rows, j], best_v)
    return (entry, best_t, best_prim, best_u, best_v)


def _query(scene, o, d, tnear, tfar, any_hit):
    N = o.shape[0]
    dev = o.device
    entry = _cluster_entry(scene, o, d, tnear, tfar)
    st = (entry, torch.clamp(tfar, max=INF),
          torch.full((N,), -1, dtype=torch.int32, device=dev),
          torch.zeros(N, device=dev), torch.zeros(N, device=dev))
    for _ in range(MAX_ROUNDS):
        entry, best_t, best_prim, _, _ = st
        improvable = entry.amin(dim=1) < best_t
        if any_hit:
            improvable = improvable & (best_prim < 0)
        if not bool(improvable.any()):
            break
        st = _round(scene, o, d, tnear, tfar, st)
    entry, best_t, best_prim, best_u, best_v = st
    miss = best_prim < 0
    return (torch.where(miss, INF, best_t), best_prim, best_u, best_v)


# The ordered-rounds loop is lockstep per chunk: it runs until every ray
# in the chunk is finished, so chunk size trades per-round overhead
# against tail waste from the slowest ray (lajolla_tpu's value).
RAY_CHUNK = 1024


def _chunked(scene, o, d, tnear, tfar, any_hit):
    tnear, tfar = ray_bounds(o, tnear, tfar)
    outs = [_query(scene, o[s:s + RAY_CHUNK], d[s:s + RAY_CHUNK],
                   tnear[s:s + RAY_CHUNK], tfar[s:s + RAY_CHUNK], any_hit)
            for s in range(0, max(o.shape[0], 1), RAY_CHUNK)]
    return tuple(torch.cat(x) for x in zip(*outs))


def intersect_binned(scene, o, d, tnear, tfar):
    """Batched closest hit. Returns (t, prim, u, v) each (N,)."""
    return _chunked(scene, o, d, tnear, tfar, any_hit=False)


def occluded_binned(scene, o, d, tnear, tfar):
    """Any-hit variant (stops a ray's rounds at its first hit)."""
    _, prim, _, _ = _chunked(scene, o, d, tnear, tfar, any_hit=True)
    return prim >= 0
