"""Cluster-sweep casters for big scenes: the casts of every scene with a
BVH (192 triangles or more).

Port of lajolla_tpu/ops/intersect_sweep.py, which replaces the Embree
two-level traversal for large meshes (src/intersection.cpp:15-44). The
SAH tree is cut into clusters of C triangles
(ops/intersect_binned.build_clusters); GROUP consecutive clusters
(spatially local: adjacent subtrees in SAH preorder) form a
"supercluster". Rays are sorted by (origin Morton code, direction bin)
so that a block of consecutive rays is spatially coherent, and each block
gets a front-to-back list of the clusters its rays enter
(`_build_lists_ftb`, dense tensor code); a kernel then sweeps each
block's list and stops where no ray of the block can still improve.

Four kernels (lajolla_tpu_torch/csrc/sweep_kernels.cu, bound in
kernels.py), chosen by `_call` as lajolla_tpu chooses, with its constants:

- K5 `sweep_resident` (tables of at most RESIDENT_BYTES): blocks of
  LIST_B rays, lists of at most LIST_LEN clusters; a block whose list
  overflows sweeps superclusters instead (`counts < 0`). Returns the
  nearest t and the cluster it lies in;
- K4 `sweep_resolve`: the triangle, u and v of each ray's hit, found again
  in the winning cluster;
- K6 `sweep_list` (larger tables): blocks of LANE_R rays, full-width
  lists, (t, prim, u, v) in one pass;
- K7 `sweep_streaming` (cluster size not a multiple of 128): no lists,
  every ray walks the superclusters in id order behind two slab gates,
  over the lane table as K5 and K6 read it.

Each kernel's plain PyTorch form is here (`*_plain`): the same arguments,
the same outputs, the same rule, as batched tensor code with a Python
loop over list entries. CPU tensors, the tests and chip_smoke.py's
comparisons use them; CUDA tensors get the kernels (kernels.py) or an
exception.

One rule for the four, in the kernels and the plain forms alike. A ray
works through its block's list in order and stops at the first entry
whose distance exceeds min(best, tfar) (the list is sorted by the block's
earliest entry, which bounds the ray's own from below), or, for any-hit,
at its first hit. At each cluster it runs its own slab test against
[tnear, min(best, tfar)] and, if that passes, tests the cluster's
triangles in index order, keeping a hit only if t is strictly smaller: the
first listed cluster and the lowest triangle index win ties, as in
lajolla_tpu. lajolla_tpu's TPU kernels test a listed cluster for the whole
block (their vector unit has no per-lane branch) and end the block's sweep
on the largest min(best, tfar) of its rays; a ray's own slab test and stop
skip only clusters that cannot hold a nearer hit, so the results are the
same up to hits that lie on a cluster's bounding box to the last bit.

Padding triangles have all-zero Woop rows -> dz == 0 -> guarded out;
padding clusters have inverted infinite AABBs and hold only such rows.

lajolla_tpu's `_build_lists` (id-ordered lists without distances) has no
caller there and is not ported.
"""

import numpy as np
import torch

from lajolla_tpu_torch import kernels
from lajolla_tpu_torch.ops.intersect import INF, ray_bounds

BLOCK_R = 1024           # rays per streaming block (padding granularity)
LANE_R = 512             # rays per block of the list kernel K6
GROUP = 8                # clusters per supercluster
RESIDENT_BYTES = 8 << 20  # tables up to this size take K5 + K4, larger K6
LIST_B = 256             # rays per block of the resident kernel K5
LIST_LEN = 192           # per-block list capacity of K5 (overflow ->
                         # supercluster sweep for that block)
# Dense (rays, clusters) temporaries of the list build, in elements: the
# build works through the ray blocks in chunks of at most this size.
LIST_CHUNK_ELEMS = 1 << 26


# ---------------------------------------------------------------------------
# Host packing (from ops/intersect_binned.build_clusters output)
# ---------------------------------------------------------------------------

def pack_sweep(cl, group=GROUP, aligned=True):
    """Repack cluster data for the sweep kernels. Returns dict with
    sw_lane (K, 16, C) f32 (rows 0-11 the Woop components [a0x a1x a2x bx
    | ...y | ...z], row 12 the global tri ids as f32 (-1 pad), triangles
    along the last axis), sw_aabb (K, 8) f32 [lo3 hi3 0 0] per cluster,
    sw_saabb (K/group, 8) supercluster AABBs. K is padded to a multiple
    of `group` with clusters of inverted infinite AABBs and zero rows.
    aligned=False lifts the rule that C is a multiple of 128 (such
    tables take the streaming kernel K7; compile_scene never makes
    them)."""
    cl_A, cl_b, cl_prim = cl['cl_A'], cl['cl_b'], cl['cl_prim']
    K0, _, threeC = cl_A.shape
    C = threeC // 3
    # a C off the 128 grid would send every cast of the scene to the
    # streaming kernel
    assert not aligned or C % 128 == 0, \
        f"sweep cluster size {C} must be 128-aligned"
    K = -(-K0 // group) * group
    A = np.zeros((K, 3, 3, C), np.float32)
    A[:K0] = cl_A.reshape(K0, 3, 3, C)
    b = np.zeros((K, 3, C), np.float32)
    b[:K0] = cl_b.reshape(K0, 3, C)
    lane = np.zeros((K, 16, C), np.float32)
    for axis in range(3):
        lane[:, 4 * axis:4 * axis + 3, :] = A[:, :, axis, :]
        lane[:, 4 * axis + 3, :] = b[:, axis, :]
    aabb = np.zeros((K, 8), np.float32)
    aabb[:, 0:3] = INF
    aabb[:, 3:6] = -INF
    aabb[:K0, 0:3] = cl['cl_lo']
    aabb[:K0, 3:6] = cl['cl_hi']
    S = K // group
    saabb = np.zeros((S, 8), np.float32)
    saabb[:, 0:3] = aabb[:, 0:3].reshape(S, group, 3).min(axis=1)
    saabb[:, 3:6] = aabb[:, 3:6].reshape(S, group, 3).max(axis=1)
    prim = np.full((K, C), -1.0, np.float32)
    prim[:K0] = cl_prim.astype(np.float32)
    assert cl_prim.max(initial=0) < (1 << 24), \
        "sweep prim ids stored as f32: exact only below 2^24"
    lane[:, 12, :] = prim
    return dict(sw_lane=lane, sw_aabb=aabb, sw_saabb=saabb)


# ---------------------------------------------------------------------------
# Per-block front-to-back lists (dense tensor code)
# ---------------------------------------------------------------------------

def _build_lists_ftb(scene, o, d, inv, tnear, tfar, R, B, L):
    """Front-to-back per-block lists.

    Returns (clist (R, L) i32, tlist (R, L) f32, counts (R,) i32):
    cluster ids sorted by the block's earliest AABB entry distance, with
    that distance alongside — a sweep stops once every ray's current
    best hit is closer than the next entry distance (the wavefront
    analogue of ordered BVH traversal, src/intersection.cpp:32 via
    Embree).

    A block whose cluster list overflows L degrades to SUPERCLUSTER
    granularity: counts = -(entered superclusters), clist/tlist hold
    supercluster ids + entry distances in the same order, and the kernel
    tests all GROUP members per listed entry. The resident path
    guarantees S = K/GROUP <= 128 <= L, so the coarse list never
    overflows."""
    ab = scene.sw_aabb                                     # (K, 8)
    K = ab.shape[0]
    G = GROUP
    S = K // G
    assert S <= L, f"supercluster list {S} must fit list capacity {L}"
    step = max(1, LIST_CHUNK_ELEMS // (B * K))
    outs = []
    for r0 in range(0, R, step):
        sl = slice(r0 * B, min(r0 + step, R) * B)
        Rc = (sl.stop - sl.start) // B
        oc, ic, tn, tf = o[sl], inv[sl], tnear[sl], tfar[sl]
        tmin = tn[:, None].expand(Rc * B, K)
        tmax = tf[:, None].expand(Rc * B, K)
        for ax in range(3):
            ta = (ab[None, :, ax] - oc[:, ax, None]) * ic[:, ax, None]
            tb = (ab[None, :, ax + 3] - oc[:, ax, None]) * ic[:, ax, None]
            tmin = torch.maximum(tmin, torch.minimum(ta, tb))
            tmax = torch.minimum(tmax, torch.maximum(ta, tb))
        enter = (tmin <= tmax).reshape(Rc, B, K)
        key = torch.where(enter, tmin.reshape(Rc, B, K), INF).amin(dim=1)
        counts_raw = enter.any(dim=1).sum(dim=1)           # (Rc,)
        # stable: clusters at equal entry distance stay in id order, as
        # jnp.argsort leaves them (the order decides ties between hits)
        order = torch.argsort(key, dim=1, stable=True)[:, :L]
        tlist = torch.gather(key, 1, order)
        # supercluster-granularity lists for overflow blocks
        key_s = key.reshape(Rc, S, G).amin(dim=2)          # (Rc, S)
        counts_s = (key_s < INF).sum(dim=1)
        order_s = torch.argsort(key_s, dim=1, stable=True)
        tlist_s = torch.gather(key_s, 1, order_s)
        pad = (0, L - S)
        order_s = torch.nn.functional.pad(order_s, pad)
        tlist_s = torch.nn.functional.pad(tlist_s, pad, value=INF)
        over = counts_raw > L
        outs.append((torch.where(over[:, None], order_s, order),
                     torch.where(over[:, None], tlist_s, tlist),
                     torch.where(over, -torch.clamp(counts_s, min=1),
                                 torch.clamp(counts_raw, max=L))))
    clist, tlist, counts = (torch.cat(x) for x in zip(*outs))
    return (clist.to(torch.int32).contiguous(), tlist.contiguous(),
            counts.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# The plain forms of K4-K7
# ---------------------------------------------------------------------------

def _slab(ab, o, inv, tnear, lim):
    """Rays (..., 3) against their AABB rows ab (..., 8): the enter mask
    for [tnear, lim]."""
    tmin, tmax = tnear, lim
    for ax in range(3):
        ta = (ab[..., ax] - o[..., ax]) * inv[..., ax]
        tb = (ab[..., ax + 3] - o[..., ax]) * inv[..., ax]
        tmin = torch.maximum(tmin, torch.minimum(ta, tb))
        tmax = torch.minimum(tmax, torch.maximum(ta, tb))
    return tmin <= tmax


def _woop(row, o, d, tnear):
    """Rays (..., 3) against their cluster's rows (..., 12+, C): t, u, v
    and the hit mask without the upper bound, each (..., C). Products are
    added left to right, as the kernels add them."""
    def comp(j):
        return row[..., j, :]

    def contract(c0, x, bias):
        r = (x[..., 0:1] * comp(c0) + x[..., 1:2] * comp(c0 + 1) +
             x[..., 2:3] * comp(c0 + 2))
        return r + comp(c0 + 3) if bias else r

    oz = contract(8, o, True)
    dz = contract(8, d, False)
    dz_ok = torch.abs(dz) > 1e-12
    t = -oz / torch.where(dz_ok, dz, 1.0)
    u = contract(0, o, True) + t * contract(0, d, False)
    v = contract(4, o, True) + t * contract(4, d, False)
    hit = (dz_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) &
           (t > tnear[..., None]))
    return t, u, v, hit


def _inv_dir(d):
    return 1.0 / torch.where(torch.abs(d) > 1e-20, d, 1e-20)


def _count(stats, **kw):
    if stats is not None:
        for k, v in kw.items():
            stats[k] = stats.get(k, 0) + int(v)


def _list_sweep(rays, lane, aabb, counts, clist, tlist, any_hit, stats):
    """The list sweep behind sweep_resident_plain and sweep_list_plain:
    (t, kid, prim, u, v), each (Np,)."""
    Np = rays.shape[0]
    R, L = clist.shape
    B = Np // R
    C = lane.shape[2]
    dev = rays.device
    r3 = rays.reshape(R, B, 8)
    o, tnear, d, tfar = r3[..., 0:3], r3[..., 3], r3[..., 4:7], r3[..., 7]
    inv = _inv_dir(d)
    over = counts < 0                                      # (R,)
    n_it = torch.abs(counts).long()
    best = torch.full((R, B), INF, device=dev)
    kid_o = torch.full((R, B), -1, dtype=torch.int32, device=dev)
    prim_o = torch.full((R, B), -1.0, device=dev)
    u_o = torch.zeros((R, B), device=dev)
    v_o = torch.zeros((R, B), device=dev)
    stopped = torch.zeros((R, B), dtype=torch.bool, device=dev)
    any_over = bool(over.any())
    iota = torch.arange(C, device=dev)
    for it in range(int(n_it.max()) if R else 0):
        lim = torch.minimum(best, tfar)
        # `not <=`: a NaN horizon stops its ray, as in the kernels
        stopped = stopped | (it >= n_it)[:, None] | \
            ~(tlist[:, it, None] <= lim)
        if any_hit:
            stopped = stopped | (best < INF)
        if bool(stopped.all()):
            break
        _count(stats, entries=(~stopped).any(dim=1).sum())
        entry = clist[:, it].long()
        for g in range(GROUP if any_over else 1):
            kid = torch.where(over, entry * GROUP + g, entry)   # (R,)
            act = ~stopped & (over | (g == 0))[:, None]
            if any_hit:
                act = act & ~(best < INF)
            lim = torch.minimum(best, tfar)
            enter = act & _slab(aabb[kid][:, None, :], o, inv, tnear, lim)
            _count(stats, slab_tests=act.sum(), cluster_tests=enter.sum())
            t, u, v, hit = _woop(lane[kid][:, None], o, d, tnear)
            hit = hit & (t < lim[..., None]) & enter[..., None]
            t = torch.where(hit, t, INF)
            if any_hit:
                # the first hit in index order, where the kernel stops
                j = torch.where(hit, iota, C).amin(dim=-1)
            else:
                j = torch.argmin(t, dim=-1)        # first index on ties
            got = hit.any(dim=-1)
            j = torch.clamp(j, max=C - 1)[..., None]
            tb = torch.gather(t, -1, j)[..., 0]
            better = got & (tb < best)
            best = torch.where(better, tb, best)
            if not any_hit:
                kid_o = torch.where(better, kid[:, None].to(torch.int32),
                                    kid_o)
                prow = lane[kid][:, 12, :][:, None, :].expand(R, B, C)
                prim_o = torch.where(better,
                                     torch.gather(prow, -1, j)[..., 0],
                                     prim_o)
                u_o = torch.where(better, torch.gather(u, -1, j)[..., 0],
                                  u_o)
                v_o = torch.where(better, torch.gather(v, -1, j)[..., 0],
                                  v_o)
    if any_hit:
        prim_o = torch.where(best < INF, 0.0, -1.0)
    return (best.reshape(Np), kid_o.reshape(Np),
            prim_o.reshape(Np).to(torch.int32), u_o.reshape(Np),
            v_o.reshape(Np))


def sweep_resident_plain(rays, lane, aabb, counts, clist, tlist, any_hit,
                         stats=None):
    """Plain form of K5. rays (Np, 8) [o, tnear, d, tfar], Np a multiple
    of the R blocks of the lists; lane (K, 16, C); aabb (K, 8); counts
    (R,) i32 (negative: supercluster entries); clist (R, L) i32; tlist
    (R, L) f32. Returns (t (Np,) f32, kid (Np,) i32): the nearest hit and
    its cluster (-1: none; always -1 for any-hit, where t is finite iff
    the ray is occluded). `stats`, a dict, collects the executed work:
    `entries` (block, entry) pairs with a ray still sweeping,
    `slab_tests` (ray, cluster) slab tests, `cluster_tests` those that
    passed (C triangle tests each)."""
    t, kid, _, _, _ = _list_sweep(rays, lane, aabb, counts, clist, tlist,
                                  any_hit, stats)
    return t, kid


def sweep_list_plain(rays, lane, aabb, counts, clist, tlist, any_hit,
                     stats=None):
    """Plain form of K6: the arguments of sweep_resident_plain with
    full-width lists. Returns (t, prim i32, u, v), each (Np,); any-hit:
    prim 0 where occluded, else -1, u = v = 0."""
    t, _, prim, u, v = _list_sweep(rays, lane, aabb, counts, clist, tlist,
                                   any_hit, stats)
    return t, prim, u, v


RESOLVE_CHUNK = 1 << 14     # rays per gather of the resolve's plain form


def sweep_resolve_plain(rays, kid, lane):
    """Plain form of K4. rays (Np, 8) [o, tnear, d, t_best]; kid (Np,)
    i32 winning cluster (-1: none). Returns (prim i32, u, v), each (Np,):
    the triangle of the ray's cluster whose t is nearest t_best, accepted
    within 1e-4 * max(|t_best|, 1e-6), the lowest index on ties; prim -1
    and u = v = 0 otherwise."""
    C = lane.shape[2]
    outs = []
    for s in range(0, rays.shape[0], RESOLVE_CHUNK):
        r, k = rays[s:s + RESOLVE_CHUNK], kid[s:s + RESOLVE_CHUNK]
        o, tnear, d, tbest = r[:, 0:3], r[:, 3], r[:, 4:7], r[:, 7]
        row = lane[torch.clamp(k, min=0).long()]           # (n, 16, C)
        t, u, v, hit = _woop(row, o, d, tnear)
        err = torch.where(hit, torch.abs(t - tbest[:, None]), INF)
        j = torch.argmin(err, dim=1, keepdim=True)         # first on ties
        emin = torch.gather(err, 1, j)[:, 0]
        tol = 1e-4 * torch.clamp(torch.abs(tbest), min=1e-6)
        # emin < inf: a t_best of inf leaves tol infinite
        take = (k >= 0) & (emin <= tol) & (emin < INF)
        outs.append((
            torch.where(take, torch.gather(row[:, 12, :], 1, j)[:, 0], -1.0)
            .to(torch.int32),
            torch.where(take, torch.gather(u, 1, j)[:, 0], 0.0),
            torch.where(take, torch.gather(v, 1, j)[:, 0], 0.0)))
    return tuple(torch.cat(x) for x in zip(*outs))


def sweep_streaming_plain(rays, saabb, aabb, lane, any_hit, stats=None):
    """Plain form of K7. rays (Np, 8) [o, tnear, d, tfar]; saabb (S, 8);
    aabb (K, 8); lane (K, 16, C): rows 0-11 the Woop components, row 12
    the prim ids. Every ray walks the superclusters in id order; it
    tests a supercluster's member clusters if its slab test against the
    supercluster passes, and a cluster's triangles if the cluster's
    passes, both against the running
    [tnear, min(best, tfar)]. Returns (t, prim i32, u, v) as
    sweep_list_plain does."""
    Np = rays.shape[0]
    S, K = saabb.shape[0], aabb.shape[0]
    G = K // S
    C = lane.shape[2]
    dev = rays.device
    o, tnear, d, tfar = rays[:, 0:3], rays[:, 3], rays[:, 4:7], rays[:, 7]
    inv = _inv_dir(d)
    prims = lane[:, 12, :]
    best = torch.full((Np,), INF, device=dev)
    prim_o = torch.full((Np,), -1.0, device=dev)
    u_o = torch.zeros(Np, device=dev)
    v_o = torch.zeros(Np, device=dev)
    iota = torch.arange(C, device=dev)
    for s in range(S):
        lim = torch.minimum(best, tfar)
        enter_s = _slab(saabb[s], o, inv, tnear, lim)
        if any_hit:
            enter_s = enter_s & ~(best < INF)
        _count(stats, slab_tests=Np)
        if not bool(enter_s.any()):
            continue
        for g in range(G):
            k = s * G + g
            lim = torch.minimum(best, tfar)
            enter = enter_s & _slab(aabb[k], o, inv, tnear, lim)
            if any_hit:
                enter = enter & ~(best < INF)
            _count(stats, slab_tests=enter_s.sum(),
                   cluster_tests=enter.sum())
            if not bool(enter.any()):
                continue
            t, u, v, hit = _woop(lane[k], o, d, tnear)
            hit = hit & (t < lim[:, None]) & enter[:, None]
            t = torch.where(hit, t, INF)
            if any_hit:
                j = torch.where(hit, iota, C).amin(dim=1)
            else:
                j = torch.argmin(t, dim=1)
            got = hit.any(dim=1)
            j = torch.clamp(j, max=C - 1)[:, None]
            tb = torch.gather(t, 1, j)[:, 0]
            better = got & (tb < best)
            best = torch.where(better, tb, best)
            if not any_hit:
                prim_o = torch.where(better, prims[k][j[:, 0]], prim_o)
                u_o = torch.where(better, torch.gather(u, 1, j)[:, 0], u_o)
                v_o = torch.where(better, torch.gather(v, 1, j)[:, 0], v_o)
    if any_hit:
        prim_o = torch.where(best < INF, 0.0, -1.0)
    return best, prim_o.to(torch.int32), u_o, v_o


# ---------------------------------------------------------------------------
# The callers: padding, horizon clamp, lists, kernel
# ---------------------------------------------------------------------------

def _pad_rays(o, d, tnear, tfar, B):
    """Rays padded to a multiple of B with rays that can hit nothing
    (tfar = -1, d = 1)."""
    pad = (-o.shape[0]) % B
    if pad:
        F = torch.nn.functional.pad
        o = F(o, (0, 0, 0, pad))
        d = F(d, (0, 0, 0, pad), value=1.0)
        tnear = F(tnear, (0, pad))
        tfar = F(tfar, (0, pad), value=-1.0)
    return o, d, tnear, tfar


def _clamp_horizon(scene, o, inv, tfar):
    """Clamp each ray's horizon to its exit from the AABB of all clusters:
    no hit can lie beyond it, and it makes ESCAPING rays (which never get
    a best hit) stop blocking their block's front-to-back break — without
    this, any block containing one miss-bound ray sweeps its whole
    list."""
    lo = scene.cl_lo.amin(dim=0)
    hi = scene.cl_hi.amax(dim=0)
    ta = (lo[None, :] - o) * inv
    tb = (hi[None, :] - o) * inv
    texit = torch.maximum(ta, tb).amin(dim=1)
    return torch.minimum(tfar, texit * 1.0001 + 1e-5)


def _pack_rays(o, tnear, d, tfar):
    return torch.cat([o, tnear[:, None], d, tfar[:, None]],
                     dim=1).contiguous()                   # (Np, 8)


def list_inputs(scene, o, d, tnear, tfar, B, L):
    """(rays (Np, 8), counts, clist, tlist) of sorted rays for blocks of
    B rays and lists of L entries: what `_call_res` (B = LIST_B,
    L = min(LIST_LEN, K)) and `_call_list` (B = LANE_R, L = K) hand their
    kernels."""
    o, d, tnear, tfar = _pad_rays(o, d, tnear, tfar, B)
    inv = _inv_dir(d)
    tfar = _clamp_horizon(scene, o, inv, tfar)
    clist, tlist, counts = _build_lists_ftb(scene, o, d, inv, tnear, tfar,
                                            o.shape[0] // B, B, L)
    return _pack_rays(o, tnear, d, tfar), counts, clist, tlist


def _call_res(scene, o, d, tnear, tfar, any_hit):
    N = o.shape[0]
    K = scene.sw_aabb.shape[0]
    rays, counts, clist, tlist = list_inputs(scene, o, d, tnear, tfar,
                                             LIST_B, min(LIST_LEN, K))
    t, kid = kernels.sweep_resident(rays, scene.sw_lane, scene.sw_aabb,
                                    counts, clist, tlist, any_hit)
    if any_hit:
        z = torch.zeros_like(t[:N])
        return t[:N], torch.where(t[:N] < INF, 0, -1).to(torch.int32), z, z
    hits = torch.cat([rays[:, :7], t[:, None]], dim=1).contiguous()
    p, u, v = kernels.sweep_resolve(hits, kid, scene.sw_lane)
    return t[:N], p[:N], u[:N], v[:N]


def _call_list(scene, o, d, tnear, tfar, any_hit):
    N = o.shape[0]
    K = scene.sw_aabb.shape[0]
    # full-width (L = K) front-to-back lists: no overflow possible
    rays, counts, clist, tlist = list_inputs(scene, o, d, tnear, tfar,
                                             LANE_R, K)
    t, p, u, v = kernels.sweep_list(rays, scene.sw_lane, scene.sw_aabb,
                                    counts, clist, tlist, any_hit)
    return t[:N], p[:N], u[:N], v[:N]


def _call_streaming(scene, o, d, tnear, tfar, any_hit):
    N = o.shape[0]
    o, d, tnear, tfar = _pad_rays(o, d, tnear, tfar, BLOCK_R)
    t, p, u, v = kernels.sweep_streaming(
        _pack_rays(o, tnear, d, tfar), scene.sw_saabb, scene.sw_aabb,
        scene.sw_lane, any_hit)
    return t[:N], p[:N], u[:N], v[:N]


def _call(scene, o, d, tnear, tfar, any_hit):
    C = scene.sw_lane.shape[2]
    if C % 128 == 0:
        if scene.sw_lane.numel() * 4 <= RESIDENT_BYTES:
            return _call_res(scene, o, d, tnear, tfar, any_hit)
        return _call_list(scene, o, d, tnear, tfar, any_hit)
    return _call_streaming(scene, o, d, tnear, tfar, any_hit)


# ---------------------------------------------------------------------------
# Ray sorting (the lever on how many clusters a block's rays share)
# ---------------------------------------------------------------------------

def _sort_keys(scene, o, d):
    """23-bit origin Morton (major) | 3-bits-per-axis direction bin
    (minor), as int64 words: the per-block cluster union is
    origin-dominated."""
    lo = scene.cl_lo.amin(dim=0)
    hi = scene.cl_hi.amax(dim=0)
    q = torch.clamp((o - lo) / torch.clamp(hi - lo, min=1e-20), 0.0, 1.0)
    q = (q * 1023.0).to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    morton = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | \
        (spread(q[:, 2]) << 2)
    db = torch.clamp((d + 1.0) * 3.999, 0.0, 7.0).to(torch.int64)
    dirkey = (db[:, 0] << 6) | (db[:, 1] << 3) | db[:, 2]
    return ((morton >> 7) << 9) | dirkey


def _sorted_call(scene, o, d, tnear, tfar, any_hit):
    tnear, tfar = ray_bounds(o, tnear, tfar)
    # stable, as jnp.argsort is: equal keys keep the rays' order
    perm = torch.argsort(_sort_keys(scene, o, d), stable=True)
    out = _call(scene, o[perm], d[perm], tnear[perm], tfar[perm], any_hit)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return tuple(x[inv] for x in out)


def intersect_sweep(scene, o, d, tnear, tfar):
    """Batched closest hit. Returns (t, prim, u, v) each (N,)."""
    return _sorted_call(scene, o, d, tnear, tfar, any_hit=False)


def occluded_sweep(scene, o, d, tnear, tfar):
    """Any-hit variant. Returns bool (N,)."""
    _, p, _, _ = _sorted_call(scene, o, d, tnear, tfar, any_hit=True)
    return p >= 0
