"""Measure lajolla_tpu_torch's large-scene casting on one CUDA GPU: the
mesh Cornell box at ~56k triangles, 683x512 x 2 spp (`bigmesh-683`: the
resident sweep K5 and the resolve K4) and at ~260k triangles, 768x575 x 1
spp (`hugemesh-768`: the list sweep K6), through render().

usage, from the repository root: python3 tools/profile_torch_sweep.py
    [--runs 2] [--label TEXT] [--out PATH]
    [--k7 [--films PATH] [--against PATH]]

Prints, and writes as JSON to --out, for each of the two cells:
- the card's `nvidia-smi` name and power limit;
- host seconds of the scene's compile (BVH, clusters, packing) and upload;
- render() Mpaths/s over --runs warm runs (wall time, host clock), the
  loop iterations of one render and the launches of each sweep kernel;
- a trace (torch.profiler, CUDA activity only) over one render(): its
  wall time, the device-busy time (the union of kernel and copy
  intervals), the idle share 1 - busy / wall, the device activities per
  loop iteration, and device time by kind of kernel (K4, K5, K6, the
  sorts, the rest: the list build's and the vertex's elementwise passes,
  gathers and reductions cannot be told apart by name);
- the render's own casts: every closest-hit and shadow cast of one
  render() is kept (its rays, and the vertex count `nv` and `done` bit of
  each lane: nv 2 is a camera ray, a done lane has no work left and
  casts its last ray again), sorted and listed as the cast does, and the
  sweep kernel (K5 or K6) timed on each by CUDA events, one launch after
  another: per launch mean, median, largest, and the mean of the first
  and of the later iterations;
- the same rays by bounce: for each nv (and the done lanes) a cast of the
  lane pool's size made of that bucket's rays in the order the render
  cast them, with its share of the render's rays, the list length per
  block (`counts`), the entries a block sweeps, the slab tests and
  clusters tested per ray (the plain forms' counters), the sort, list
  and kernel milliseconds, the whole cast, and the kernel's bound from
  chip_smoke.OPS;
- for bigmesh-683 only, K5 and K6 at 2^18 rays as `chip_smoke.py` [14]
  times them (the bounce and shadow rays of the 56k-triangle mesh box's
  512x512 film; K6 on full-width lists of the same table), with bounds.

With --k7 it measures the streaming sweep K7 alone, in place of all that:
- `mesh-64` (chip_smoke.py [15]: the mesh Cornell box at ~3.5k triangles,
  128x96 x 1 spp, its tables repacked at 64 triangles a cluster): every
  K7 launch of one render() is kept (its inputs and outputs) and replayed,
  and K7's device time a launch over the render's casts (closest and any
  hit apart) in --runs traces (torch.profiler: the mean and median of
  each, so the runs give the spread); the device time of K7's launches in
  a trace of one render() besides;
- 2^18 rays: the bounce (closest hit) and shadow (any hit) rays of the
  56k-triangle mesh box's 512x512 film, repacked at 64, as chip_smoke.py
  [14] times them: device time --runs times, and CUDA events (which at
  render shape time the host's issue rate);
- the ptxas registers and spills of the tree's sweep kernels.
--films PATH saves every output (t, prim, u, v of each launch) and the
rays; --against PATH, a file another tree saved, gives the share of rays
whose outputs are bit-equal between the trees, launch by launch (and
whether the two renders cast the same rays).
Imports no JAX. It reads only what the package has had since K4-K7 were
ported, so a copy of it placed in an older checkout measures that tree:
run it there and here in turns, in one call, to compare two trees.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CELLS = (  # name, triangles asked, film, spp
    ('bigmesh-683', 56000, (683, 512), 2),
    ('hugemesh-768', 260000, (768, 575), 1))
MAX_NV = 8     # bounce buckets nv = 2 .. MAX_NV; deeper lanes pooled


def kind_of(name):
    """Bucket of a device activity's name."""
    for key, kind in (('sweep_resident', 'K5'), ('sweep_resolve', 'K4'),
                      ('sweep_list', 'K6'), ('sweep_streaming', 'K7')):
        if key in name:
            return kind
    low = name.lower()
    if 'sort' in low or 'radix' in low or 'merge' in low:
        return 'sort'
    if 'copy' in low or 'memcpy' in low or 'cat' in low:
        return 'copy/cat'
    return 'other (list build and vertex: elementwise, gather, reduce)'


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', type=int, default=2)
    ap.add_argument('--label', default='')
    ap.add_argument('--out', default=os.path.join(
        REPO, 'chiprun_out', 'profile_torch_sweep.json'))
    ap.add_argument('--k7', action='store_true',
                    help='measure the streaming sweep K7 alone')
    ap.add_argument('--films', help='with --k7: save every output here')
    ap.add_argument('--against',
                    help='with --k7: compare with the outputs saved here')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_sweep: needs one CUDA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import OPS, bound, cuda_ms
    from lajolla_tpu_torch import kernels, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import path as PP
    from lajolla_tpu_torch.ops import intersect_sweep as SW
    from lajolla_tpu_torch.ops.intersect import ray_bounds
    from lajolla_tpu_torch.scene import geometry as PG
    from lajolla_tpu_torch.scene.types import RenderOptions
    from lajolla_tpu_torch.utils import profiling
    from tools.profile_torch_general import busy_seconds

    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    kernels.build()
    out = {'card': card, 'label': args.label, 'repo': REPO,
           'build_s': time.perf_counter() - t0}
    print(f"tree {REPO} ({args.label}); {card}; build + load "
          f"{out['build_s']:.1f} s", flush=True)
    if args.k7:
        out['k7'] = k7_ab(args, torch, dev, card)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
        return

    def nbytes(*tensors):
        return sum(x.numel() * x.element_size() for x in tensors)

    def sweep_of(scene):
        """(kernel, plain form, B, L, bytes a ray writes, name) of the
        sweep a cast of `scene` takes."""
        K = scene.sw_aabb.shape[0]
        if scene.sw_lane.numel() * 4 <= SW.RESIDENT_BYTES:
            return (kernels.sweep_resident, SW.sweep_resident_plain,
                    SW.LIST_B, min(SW.LIST_LEN, K), 8, 'K5')
        return (kernels.sweep_list, SW.sweep_list_plain, SW.LANE_R, K, 16,
                'K6')

    def sort(scene, ray):
        perm = torch.argsort(SW._sort_keys(scene, *ray[:2]), stable=True)
        return tuple(x[perm].contiguous() for x in ray)

    def sweep_row(scene, ray, any_hit, kernel, plain_fn, B, L, out_bytes):
        """Stage times, list and work counts and the bound of one cast."""
        n = ray[0].shape[0]
        C = scene.sw_lane.shape[2]
        srt = sort(scene, ray)
        a = SW.list_inputs(scene, *srt, B, L)
        lists = (scene.sw_lane, scene.sw_aabb, *a[1:])
        stats = {}
        plain_fn(a[0], *lists, any_hit, stats=stats)
        cnt = a[1].abs().float()
        R = cnt.shape[0]
        cast = SW.occluded_sweep if any_hit else SW.intersect_sweep
        row = dict(
            rays=n, block=B, list_len=L, list_blocks=R,
            listed_per_block_mean=float(cnt.mean()),
            listed_per_block_max=int(cnt.max()),
            overflow_blocks=int((a[1] < 0).sum()),
            swept_entries_per_block=stats.get('entries', 0) / R,
            slab_tests_per_ray=stats.get('slab_tests', 0) / n,
            clusters_tested_per_ray=stats.get('cluster_tests', 0) / n,
            sort_ms=cuda_ms(torch, lambda: sort(scene, ray), 10),
            lists_ms=cuda_ms(torch, lambda: SW.list_inputs(
                scene, *srt, B, L), 10),
            kernel_ms=cuda_ms(torch, lambda: kernel(a[0], *lists, any_hit),
                              10),
            whole_cast_ms=cuda_ms(torch, lambda: cast(scene, *ray), 10))
        ops = (stats.get('slab_tests', 0) * OPS['slab_test'] +
               stats.get('cluster_tests', 0) * C *
               OPS['any_test' if any_hit else 'closest_test'])
        row['bound_ms'], row['bound_by'] = bound(
            ops, nbytes(a[0], *lists) + out_bytes * a[0].shape[0])
        return row

    for cell, triangles, size, spp in CELLS:
        t0 = time.perf_counter()
        with profiling.recording() as spans:
            cpu_scene = PT.make_cornell_box(size, spp, 'mesh',
                                            triangles=triangles)
        compile_s = time.perf_counter() - t0
        build = {k[len('compile.'):]: v for k, v in
                 profiling.seconds_by_name(spans).items()
                 if k.startswith('compile.')}
        t0 = time.perf_counter()
        scene = cpu_scene.to(dev)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        opt = RenderOptions(samples_per_pixel=spp)
        paths = size[0] * size[1] * spp
        K, _, C = scene.sw_lane.shape
        kernel, plain_fn, B, L, out_bytes, kname = sweep_of(scene)
        res = out[cell] = dict(
            triangles=scene.meta.num_triangles, clusters=K,
            table_bytes=scene.sw_lane.numel() * 4, compile_s=compile_s,
            build_s=build, upload_s=upload_s,
            schedule=PP._schedule(scene), sweep=kname)
        print(f"{cell}: {res['triangles']} triangles, {K} clusters of {C}, "
              f"table {res['table_bytes']} B ({kname}); compile "
              f"{compile_s:.2f} s (BVH {build['bvh']:.2f}, clusters "
              f"{build['clusters']:.2f}, packing {build['pack']:.2f}), "
              f"upload {upload_s:.3f} s; (spp per block, lanes) "
              f"{res['schedule']}", flush=True)

        def timed_render():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(scene, opt, device=dev)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        timed_render()                                   # warm
        iters = []
        real = PP._render_block_sc

        def counting(*a, **k):
            r = real(*a, **k)
            iters.append(r[2])
            return r
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        with mock.patch.object(PP, '_render_block_sc', counting):
            walls = [timed_render()]
        res['loop_iterations'] = sum(iters)
        res['launches'] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        walls += [timed_render() for _ in range(args.runs - 1)]
        res['render_walls_s'] = walls
        res['render_mpaths_per_s'] = [paths / w / 1e6 for w in walls]
        print(f"{cell}: render() {size[0]}x{size[1]} x {spp} spp, "
              f"{len(walls)} warm runs: walls {walls} s, Mpaths/s "
              f"{res['render_mpaths_per_s']}; {res['loop_iterations']} loop "
              f"iterations, launches {res['launches']}; {card}", flush=True)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = timed_render()
        dev_ev = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        busy = busy_seconds((e.time_range.start, e.time_range.end)
                            for e in dev_ev)
        by_kind = {}
        for e in dev_ev:
            k = by_kind.setdefault(kind_of(e.name), [0, 0.0])
            k[0] += 1
            k[1] += (e.time_range.end - e.time_range.start) / 1e3
        res['trace'] = dict(
            wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
            device_activities=len(dev_ev),
            device_activities_per_iteration=len(dev_ev) /
            res['loop_iterations'],
            device_ms_by_kind={k: {'count': n, 'ms': ms}
                               for k, (n, ms) in sorted(by_kind.items())})
        res['idle_share_estimate_unprofiled'] = \
            1.0 - busy / statistics.median(walls)
        print(f"{cell}: trace: wall {wall:.3f} s, device busy {busy:.3f} s, "
              f"idle share {1.0 - busy / wall:.4f} (against the median "
              f"unprofiled wall: {res['idle_share_estimate_unprofiled']:.4f}"
              f"), {len(dev_ev)} device activities, "
              f"{res['trace']['device_activities_per_iteration']:.0f} per "
              f"iteration; device ms by kind "
              f"{res['trace']['device_ms_by_kind']}", flush=True)

        # ---- the render's own casts
        lane_state = {}
        casts = {'closest': [], 'any': []}
        real_adv = PP._advance_lane

        def advance(scene_, options_, st, uN):
            lane_state.update(nv=st[1].clone(), done=st[11].clone())
            return real_adv(scene_, options_, st, uN)

        def keep(kind, cast):
            def wrapped(scene_, o, d, tnear, tfar):
                tn, tf = ray_bounds(o, tnear, tfar)
                nv = torch.where(lane_state['done'], 0,
                                 lane_state['nv'].clamp(max=MAX_NV + 1))
                casts[kind].append((o.clone(), d.clone(), tn.clone(),
                                    tf.clone(), nv))
                return cast(scene_, o, d, tnear, tfar)
            return wrapped
        with mock.patch.object(PP, '_advance_lane', advance), \
                mock.patch.multiple(
                    PG, intersect_sweep=keep('closest', SW.intersect_sweep),
                    occluded_sweep=keep('any', SW.occluded_sweep)):
            timed_render()
        res['casts'] = {}
        for kind, kept in casts.items():
            any_hit = kind == 'any'
            prepared = []
            for o, d, tn, tf, _ in kept:
                a = SW.list_inputs(scene, *sort(scene, (o, d, tn, tf)), B, L)
                prepared.append((a[0], scene.sw_lane, scene.sw_aabb, *a[1:]))
            for p in prepared[:3]:                       # warm
                kernel(*p, any_hit)
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(prepared) + 1)]
            torch.cuda.synchronize()
            ev[0].record()
            for p, e in zip(prepared, ev[1:]):
                kernel(*p, any_hit)
                e.record()
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
            listed = [float(p[3].abs().float().mean()) for p in prepared]
            first = max(1, len(ms) // 10)
            res['casts'][kind] = dict(
                launches=len(ms), kernel_ms_total=sum(ms),
                kernel_ms_mean=statistics.mean(ms),
                kernel_ms_median=statistics.median(ms),
                kernel_ms_max=max(ms),
                kernel_ms_mean_first_tenth=statistics.mean(ms[:first]),
                kernel_ms_mean_rest=statistics.mean(ms[first:]),
                listed_per_block_mean=statistics.mean(listed),
                listed_per_block_mean_first_tenth=statistics.mean(
                    listed[:first]),
                listed_per_block_mean_rest=statistics.mean(listed[first:]))
            print(f"{cell}: {kname} on the render's own "
                  f"{'shadow' if any_hit else 'closest-hit'} casts: "
                  f"{res['casts'][kind]}; {card}", flush=True)

            # by bounce: pool-sized casts of one bucket's rays
            pool = kept[0][0].shape[0]
            rows = [torch.cat(x) for x in zip(*kept)]
            buckets = {}
            for nv in [0] + list(range(2, MAX_NV + 2)):
                sel = torch.nonzero(rows[4] == nv)[:, 0]
                if sel.numel() < pool // 4:
                    continue
                ray = tuple(x[sel[:pool]] for x in rows[:4])
                name = 'done' if nv == 0 else (
                    f'nv>={nv}' if nv > MAX_NV else f'nv={nv}')
                row = sweep_row(scene, ray, any_hit, kernel, plain_fn, B, L,
                                out_bytes)
                row['share_of_render_rays'] = sel.numel() / rows[4].numel()
                buckets[name] = row
                print(f"{cell}: {kname} {kind}, {name}: {row}; {card}",
                      flush=True)
            res['casts'][kind]['by_bounce'] = buckets
        del casts, rows, prepared

        if cell != 'bigmesh-683':
            continue
        # ---- K5 and K6 at 2^18 rays, as chip_smoke.py [14] times them
        big = PT.make_cornell_box(512, 1, 'mesh', triangles=triangles).to(dev)
        rays = PT.general_rays(big, seed=13, device=dev)
        Kb = big.sw_aabb.shape[0]
        res['rays_2_18'] = {}
        for any_hit, ray in ((False, rays['bounce']), (True, rays['shadow'])):
            kind = 'any' if any_hit else 'closest'
            for name, kern, pf, B2, L2, ob in (
                    ('K5', kernels.sweep_resident, SW.sweep_resident_plain,
                     SW.LIST_B, min(SW.LIST_LEN, Kb), 8),
                    ('K6', kernels.sweep_list, SW.sweep_list_plain, SW.LANE_R,
                     Kb, 16)):
                row = sweep_row(big, ray, any_hit, kern, pf, B2, L2, ob)
                res['rays_2_18'][f'{name} {kind}'] = row
                which = 'shadow' if any_hit else 'bounce'
                print(f"{cell} geometry, 2^18 {which} rays, {name}: {row}; "
                      f"{card}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)


def k7_ab(args, torch, dev, card):
    """The --k7 measurements (see the module docstring); returns them."""
    import inspect

    from chip_smoke import cuda_ms
    from lajolla_tpu_torch import kernels, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.ops import intersect_sweep as SW
    from lajolla_tpu_torch.scene.types import RenderOptions
    from tools.profile_torch_general import (ab_outputs, brief, device_runs,
                                             kernel_registers, trace_ms)

    name = 'sweep_streaming_kernel'
    real = kernels.sweep_streaming
    res = {'registers': kernel_registers(kernels.build_log(), ('sweep_',))}
    saved = {}

    # ---- mesh-64: the render's own launches
    small = PT.make_cornell_box((128, 96), 1, 'mesh', triangles=3500).to(dev)
    mesh64 = PT.repack_clusters(small, 64)
    opt = RenderOptions(samples_per_pixel=1)
    kept = []

    def keep(*a):
        outs = real(*a)
        kept.append((a, tuple(x.clone() for x in outs)))
        return outs
    render(mesh64, opt, device=dev)                      # warm
    with mock.patch.object(kernels, 'sweep_streaming', keep):
        render(mesh64, opt, device=dev)
    torch.cuda.synchronize()
    for a, outs in kept:
        key = 'render any' if a[-1] else 'render closest'
        saved.setdefault(key, []).append(outs)
        saved.setdefault(key + ' rays', []).append((a[0],))
    res['render_launches'] = len(kept)
    res['render_rays_a_launch'] = sorted({a[0].shape[0] for a, _ in kept})
    for any_hit in (False, True):
        calls = [a for a, _ in kept if bool(a[-1]) == any_hit]
        key = 'any' if any_hit else 'closest'
        ms = device_runs(torch, lambda: [real(*a) for a in calls], 3, name,
                         args.runs)
        res[f'render_{key}_launches'] = len(calls)
        res[f'render_{key}_device_ms'] = ms
        print(f"K7 {key} hit on the {len(calls)} launches of a mesh-64 "
              f"render ({res['render_rays_a_launch']} rays a launch), "
              f"device ms a launch, {args.runs} runs: {ms}; {card}",
              flush=True)
    res['render_trace'] = trace_ms(torch, lambda: render(mesh64, opt,
                                                         device=dev), name)
    print(f"K7 in a traced mesh-64 render: {res['render_trace']}", flush=True)

    # ---- 2^18 rays of the 56k-triangle mesh box, as chip_smoke.py [14]
    big = PT.make_cornell_box(512, 1, 'mesh', triangles=56000).to(dev)
    big64 = PT.repack_clusters(big, 64)
    plain = {k: getattr(SW, k + '_plain') for k in (
        'sweep_resident', 'sweep_resolve', 'sweep_list', 'sweep_streaming')}
    with mock.patch.multiple(kernels, **plain):
        rays = PT.general_rays(big, seed=13, device=dev)
    if 'lane' in inspect.signature(real).parameters:
        tabs = (big64.sw_saabb, big64.sw_aabb, big64.sw_lane)
    else:                                   # K7 before it read sw_lane
        tabs = (big64.sw_saabb, big64.sw_aabb, big64.sw_A, big64.sw_prim)
    for any_hit, kind in ((False, 'bounce'), (True, 'shadow')):
        o, d, tn, tf = rays[kind]
        perm = torch.argsort(SW._sort_keys(big, o, d), stable=True)
        o, d, tn, tf = SW._pad_rays(*(x[perm].contiguous()
                                      for x in (o, d, tn, tf)), SW.BLOCK_R)
        pk = SW._pack_rays(o, tn, d, tf)
        key = 'any' if any_hit else 'closest'
        saved[f'2^18 {key}'] = [tuple(x.clone() for x in
                                      real(pk, *tabs, any_hit))]
        saved[f'2^18 {key} rays'] = [(pk,)]
        ms = device_runs(torch, lambda: real(pk, *tabs, any_hit), 5, name,
                         args.runs)
        ev = cuda_ms(torch, lambda: real(pk, *tabs, any_hit), 10)
        res[f'2^18_{key}_device_ms'] = ms
        res[f'2^18_{key}_cuda_event_ms'] = ev
        print(f"K7 {key} hit at 2^18 {kind} rays (56k-triangle mesh box at "
              f"64 a cluster, {big64.sw_aabb.shape[0]} clusters): device ms, "
              f"{args.runs} runs: {ms}; CUDA events {ev:.4f} ms; {card}",
              flush=True)
    res['between_trees'] = ab_outputs(saved, args.films, args.against)
    print(f"K7 registers and spills: {res['registers']}; between trees: "
          f"{brief(res['between_trees'])}", flush=True)
    return res


if __name__ == '__main__':
    main()
