"""Measure lajolla_tpu_torch's large-scene casting on one CUDA GPU: the
mesh Cornell box at ~56k triangles, 683x512 x 2 spp (`bigmesh-683`: the
resident sweep K5 and the resolve K4) and at ~260k triangles, 768x575 x 1
spp (`hugemesh-768`: the list sweep K6), through render().

usage, from the repository root: python3 tools/profile_torch_sweep.py
    [--runs 2] [--out chiprun_out/profile_torch_sweep.json]

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
- one cast of the lane pool's size (8192 or 16384 bounce rays for closest
  hit, shadow rays for any hit) by CUDA events, stage by stage: ray sort,
  padding and list build, the kernel (and K4), and the whole cast;
- from the plain forms' counters on those rays: slab tests and clusters
  tested per ray, and the share of the listed (block, entry) pairs that
  the early break skips.
Imports no JAX.
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

CELLS = (  # name, triangles asked, film, spp, film whose pixels = lanes
    ('bigmesh-683', 56000, (683, 512), 2, (128, 64)),
    ('hugemesh-768', 260000, (768, 575), 1, (128, 128)))


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
    ap.add_argument('--out', default=os.path.join(
        REPO, 'chiprun_out', 'profile_torch_sweep.json'))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_sweep: needs one CUDA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import cuda_ms
    from lajolla_tpu_torch import kernels, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import path as PP
    from lajolla_tpu_torch.ops import intersect_sweep as SW
    from lajolla_tpu_torch.scene import compile as PC
    from lajolla_tpu_torch.scene.types import RenderOptions
    from tools.profile_torch_general import busy_seconds

    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kernels.build()
    out = {'card': card}
    plain = dict(sweep_resident=SW.sweep_resident_plain,
                 sweep_resolve=SW.sweep_resolve_plain,
                 sweep_list=SW.sweep_list_plain,
                 sweep_streaming=SW.sweep_streaming_plain)

    for cell, triangles, size, spp, pool_film in CELLS:
        t0 = time.perf_counter()
        cpu_scene = PT.make_cornell_box(size, spp, 'mesh',
                                        triangles=triangles)
        compile_s = time.perf_counter() - t0
        build = dict(PC.BUILD_SECONDS)
        t0 = time.perf_counter()
        scene = cpu_scene.to(dev)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        opt = RenderOptions(samples_per_pixel=spp)
        paths = size[0] * size[1] * spp
        K, _, C = scene.sw_lane.shape
        res = out[cell] = dict(
            triangles=scene.meta.num_triangles, clusters=K,
            table_bytes=scene.sw_lane.numel() * 4, compile_s=compile_s,
            build_s=build, upload_s=upload_s,
            schedule=PP._schedule(scene))
        print(f"{cell}: {res['triangles']} triangles, {K} clusters of {C}, "
              f"table {res['table_bytes']} B; compile {compile_s:.2f} s "
              f"(BVH {build['bvh']:.2f}, clusters {build['clusters']:.2f}, "
              f"packing {build['pack']:.2f}), upload {upload_s:.3f} s; "
              f"(spp per block, lanes) {res['schedule']}", flush=True)

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

        # one cast of the lane pool's size, stage by stage
        pool = PT.make_cornell_box(pool_film, 1, 'mesh',
                                   triangles=triangles).to(dev)
        with mock.patch.multiple(kernels, **plain):
            rays = PT.general_rays(pool, seed=13, device=dev)
        resident = scene.sw_lane.numel() * 4 <= SW.RESIDENT_BYTES
        B, L = (SW.LIST_B, min(SW.LIST_LEN, K)) if resident else \
            (SW.LANE_R, K)
        res['cast'] = {}
        for any_hit, ray in ((False, rays['bounce']), (True, rays['shadow'])):
            o, d, tn, tf = ray

            def sort():
                perm = torch.argsort(SW._sort_keys(pool, o, d), stable=True)
                return tuple(x[perm] for x in ray)
            srt = sort()
            args_ = SW.list_inputs(pool, *srt, B, L)
            lists = (pool.sw_lane, pool.sw_aabb, *args_[1:])
            if resident:
                def kernel():
                    t, kid = kernels.sweep_resident(args_[0], *lists, any_hit)
                    if not any_hit:
                        hits = torch.cat([args_[0][:, :7], t[:, None]],
                                         dim=1).contiguous()
                        kernels.sweep_resolve(hits, kid, pool.sw_lane)
                plain_fn = SW.sweep_resident_plain
            else:
                def kernel():
                    kernels.sweep_list(args_[0], *lists, any_hit)
                plain_fn = SW.sweep_list_plain
            cast = SW.occluded_sweep if any_hit else SW.intersect_sweep
            stats = {}
            plain_fn(args_[0], *lists, any_hit, stats=stats)
            n = o.shape[0]
            listed = int(args_[1].abs().sum())
            row = dict(
                rays=n, block=B, list_len=L,
                sort_ms=cuda_ms(torch, sort, 10),
                lists_ms=cuda_ms(torch, lambda: SW.list_inputs(
                    pool, *srt, B, L), 10),
                kernel_ms=cuda_ms(torch, kernel, 10),
                whole_cast_ms=cuda_ms(torch, lambda: cast(pool, *ray), 10),
                slab_tests_per_ray=stats['slab_tests'] / n,
                clusters_tested_per_ray=stats['cluster_tests'] / n,
                listed_entries=listed, swept_entries=stats['entries'],
                share_skipped_by_break=1.0 - stats['entries'] / listed,
                overflow_blocks=int((args_[1] < 0).sum()))
            res['cast']['any' if any_hit else 'closest'] = row
            print(f"{cell}: one {'any-hit' if any_hit else 'closest-hit'} "
                  f"cast: {row}; {card}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)


if __name__ == '__main__':
    main()
