"""Measure lajolla_tpu_torch's general engine on one CUDA GPU: the glass
Cornell box at 512x512 x 16 spp (one SPP_BLOCK, the CLI main path's
general-engine run), and kernel K3 against its plain forms.

usage, from the repository root: python3 tools/profile_torch_general.py
    [--runs 5] [--out chiprun_out/profile_torch_general.json]
    [--k3 | --k2 [--label TEXT] [--films PATH] [--against PATH]]

Prints, and writes as JSON to --out:
- the card's `nvidia-smi` name and power limit;
- render() Mpaths/s over --runs warm runs (wall time, host clock);
- the loop iterations of one render (each ends in a `done.all()`
  read-back to the host);
- trace A (torch.profiler, CUDA activity only) over one render(): its
  wall time, the device-busy time (the union of kernel and copy
  intervals), the idle share 1 - busy / wall, the device activities
  launched, and device time by kind of kernel;
- trace B (CPU and CUDA activity) over one render(): the host calls that
  wait on the device (count and host time);
- an estimate, labelled as such, of the idle share of an unprofiled
  render: 1 - trace A's busy time / the median unprofiled wall;
- K3 at 2^18 bounce rays (closest hit) and shadow rays (any hit) of the
  glass Cornell box, and their plain forms, by CUDA events, alternating,
  --runs rounds.

With --k3 it measures the brute-force casts K3 alone, in place of all
that:
- K3 on chip_smoke.py [7]'s rays (the camera, bounce and shadow rays of
  the glass Cornell box and the sphere-light scene at 512x512, 2^18 each),
  closest and any hit; at glass-512's shape (the bounce and shadow rays of
  the glass box: the engine's pool is one lane a pixel, 2^18 lanes) its
  device time in --runs traces (torch.profiler: the mean and median of
  each, so the runs give the spread) and by CUDA events, which there time
  the host's issue rate: what the host-bound engine pays a call;
- every K3 launch of one glass-512 render() (a digest of its outputs), and
  K3's device time a launch in a trace of another;
- the ptxas registers and spills of K3.
With --k2 it measures the per-vertex kernel K2 and its driver alone, on
the Cornell box at 64x64 (cbox-64: one 4096-pixel block, the largest
film render() sends to the per-bounce driver) and 32x32 (cbox-32, a
thumbnail), one lane a pixel, 16 spp each:
- one run with every launch's active lanes counted and its outputs on
  them kept, and the film;
- render() walls over --runs warm runs; up to three traced renders (CPU
  and CUDA activity, the driver's uniform hashing and camera rays in
  ranges of their own): wall, device-busy time, idle share, K2's
  launches and device time a launch, and the driver's other device time
  by part (uniforms, camera, aten::where, aten::index_add_, ...);
- every launch of the render replayed by device time (--runs traces);
- K2's bound a launch from each launch's active lanes (chip_smoke.bound,
  vertex_ops; every lane's bytes and the tables);
- K2 at chip_smoke.py [3]'s 2^18 random lanes, by device time;
- the ptxas registers and spills of K2 and K1, and the group size K2
  picks at each shape where the tree has one (kernels.advance_group).
--films PATH saves the outputs (and digests); --against PATH, a file
another tree saved, gives the share of rays (of launches, for digests;
with --k2 the active lanes of each launch) whose outputs are bit-equal
between the trees.
Imports no JAX. It reads only what the package has had since K3 was
ported, so a copy of it placed in an older checkout measures that tree.
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# Host calls that block on the device.
SYNC_CALLS = ('aten::_local_scalar_dense', 'cudaStreamSynchronize',
              'cudaDeviceSynchronize', 'cudaMemcpyAsync')


def kind_of(name):
    """Bucket of a device activity's name."""
    if 'brute_kernel' in name:
        return 'K3'
    if 'gather' in name or 'index' in name or 'scatter' in name:
        return 'gather/index'
    if 'copy' in name.lower() or 'Memcpy' in name or 'Cat' in name:
        return 'copy/cat'
    if 'reduce' in name:
        return 'reduce'
    if 'elementwise' in name:
        return 'elementwise'
    return 'other'


def busy_seconds(intervals):
    """Length of the union of (start, end) intervals in microseconds, in
    seconds."""
    busy, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e6


def digest(*tensors):
    """A (1, 20) uint8 tensor: the SHA-1 of the tensors' bytes."""
    import torch
    h = hashlib.sha1()
    for x in tensors:
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return torch.tensor(list(h.digest()), dtype=torch.uint8)[None]


def device_runs(torch, fn, reps, name, runs):
    """Device milliseconds a launch of the kernels whose name holds `name`
    over reps calls of fn(), traced `runs` times (after one warm call):
    {'mean': one mean a run, 'median': one median a run, 'launches': the
    launches each trace held}. A trace may miss launches (chip_smoke
    device_ms)."""
    fn()
    out = {'mean': [], 'median': [], 'launches': []}
    for _ in range(runs):
        ms = [x for k in trace_events(torch, lambda: [fn() for _ in
                                                      range(reps)], name)
              .values() for x in k]
        if ms:
            out['mean'].append(statistics.mean(ms))
            out['median'].append(statistics.median(ms))
        out['launches'].append(len(ms))
    return out


def trace_events(torch, fn, name):
    """{kernel: [device milliseconds of each launch]} of the kernels whose
    name holds `name` in a trace of one fn(), keyed by the name up to its
    argument list."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and name in e.name:
            key = e.name[e.name.index(name):].split('(')[0]
            by.setdefault(key, []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    return by


def trace_ms(torch, fn, name):
    """trace_events of one fn() summed up by kernel: launches, mean,
    median, total."""
    return {k: dict(launches=len(v), mean_ms=statistics.mean(v),
                    median_ms=statistics.median(v), total_ms=sum(v))
            for k, v in sorted(trace_events(torch, fn, name).items())}


def kernel_registers(log, names):
    """The ptxas summary (chip_smoke.ptxas_summary) of the kernels whose
    name starts with one of `names`."""
    from chip_smoke import ptxas_summary
    return [x for x in ptxas_summary(log).split('; ') if x.startswith(names)]


def ab_outputs(saved, films, against):
    """Save `saved` ({key: [tuple of tensors a launch]}) to `films`, and
    compare it with the file `against` that another tree saved: for each
    key the launches, the rays (first axis of the first tensor) and the
    share of rays whose every tensor is bit-equal (NaN equal to NaN), or
    None without `against`."""
    import torch
    mine = {k: [tuple(x.detach().cpu() for x in outs) for outs in v]
            for k, v in saved.items()}
    if films:
        os.makedirs(os.path.dirname(os.path.abspath(films)), exist_ok=True)
        torch.save(mine, films)
    if not against:
        return None
    theirs = torch.load(against)
    res = {}
    for key, launches in mine.items():
        other = theirs.get(key, [])
        rays = same = 0
        for a, b in zip(launches, other):
            eq = torch.ones(a[0].shape[0], dtype=torch.bool)
            if len(a) != len(b) or a[0].shape != b[0].shape:
                eq[:] = False
            else:
                for x, y in zip(a, b):
                    e = x == y
                    if x.is_floating_point():
                        e |= x.isnan() & y.isnan()
                    eq &= e.reshape(e.shape[0], -1).all(dim=1)
            rays += eq.numel()
            same += int(eq.sum())
        res[key] = dict(launches=len(launches), their_launches=len(other),
                        rays=rays, bit_equal=same,
                        share=same / rays if rays else None)
    return res


def brief(between):
    """ab_outputs' result as {key: 'bit-equal / rays'}."""
    if between is None:
        return None
    return {k: f"{v['bit_equal']} / {v['rays']}" for k, v in between.items()}


def k3_ab(args, torch, dev, card):
    """The --k3 measurements (see the module docstring); returns them."""
    from chip_smoke import bound, cuda_ms, table_bytes, vertex_ops
    from lajolla_tpu_torch import kernels, parse_scene, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import path as PP
    from lajolla_tpu_torch.integrators import path_kernel as PK
    from lajolla_tpu_torch.scene.types import RenderOptions

    res = {'registers': kernel_registers(
        kernels.build_log(), ('intersect_brute', 'occluded_brute'))}
    saved = {}

    # ---- K3 on chip_smoke.py [7]'s rays; timed at glass-512's shape
    for fixture, scene in (
            ('glass cbox', PT.make_cornell_box(512, variant='glass')),
            ('sphere lights', PT.make_sphere_light_scene(512))):
        scene = scene.to(dev)
        rays = PT.general_rays(scene, seed=13)
        for kind, ray in rays.items():
            saved[f'{fixture} {kind} rays'] = [(digest(*ray),)]
            saved[f'{fixture} {kind} closest'] = [
                kernels.intersect_brute(scene, *ray)]
            saved[f'{fixture} {kind} any'] = [
                (kernels.occluded_brute(scene, *ray),)]
        if fixture != 'glass cbox':
            continue
        for key, fn, name, ray in (
                ('closest', kernels.intersect_brute, 'intersect_brute_kernel',
                 rays['bounce']),
                ('any', kernels.occluded_brute, 'occluded_brute_kernel',
                 rays['shadow'])):
            ms = device_runs(torch, lambda: fn(scene, *ray), 20, name,
                             args.runs)
            ev = cuda_ms(torch, lambda: fn(scene, *ray), 20)
            res[f'2^18_{key}_device_ms'] = ms
            res[f'2^18_{key}_cuda_event_ms'] = ev
            print(f"K3 {key} hit at glass-512's shape (2^18 "
                  f"{'shadow' if key == 'any' else 'bounce'} rays of the "
                  f"glass box, {scene.fp_woop.shape[0]} / "
                  f"{scene.fp_woop_occ.shape[0]} cast prims): device ms, "
                  f"{args.runs} runs: {ms}; CUDA events (the host's issue "
                  f"rate) {ev:.4f} ms; {card}", flush=True)

    # ---- the launches of a glass-512 render
    with tempfile.TemporaryDirectory() as tmp:
        xml = PT.write_cornell_box_xml(os.path.join(tmp, 'glass'), 512, 16,
                                       variant='glass')
        glass, opt = parse_scene(xml, dev)
    real_c, real_a = kernels.intersect_brute, kernels.occluded_brute
    casts = {'render closest digests': [], 'render any digests': []}

    def keep_c(*a):
        out = real_c(*a)
        casts['render closest digests'].append((digest(*out),))
        return out

    def keep_a(*a):
        out = real_a(*a)
        casts['render any digests'].append((digest(out),))
        return out
    render(glass, opt, device=dev)                       # warm
    with mock.patch.multiple(kernels, intersect_brute=keep_c,
                             occluded_brute=keep_a):
        render(glass, opt, device=dev)
    saved.update(casts)
    res['render_launches'] = {k: len(v) for k, v in casts.items()}
    res['render_trace'] = trace_ms(
        torch, lambda: render(glass, opt, device=dev), 'brute_kernel')
    print(f"K3 in a glass-512 render: launches {res['render_launches']}; "
          f"device time in a trace {res['render_trace']}; {card}",
          flush=True)

    res['between_trees'] = ab_outputs(saved, args.films, args.against)
    print(f"K3 registers and spills: {res['registers']}; between "
          f"trees: {brief(res['between_trees'])}", flush=True)
    return res


# K2's bytes a lane, as chip_smoke.py [3] counts them: in (org, dir, thr,
# rad, prev 3 each, nv, dir_pdf, un 8: fp32; act: bool), out (4 x 3 + 1
# fp32, alive: bool).
K2_LANE_BYTES = 4 * (15 + 2 + 8) + 1 + 4 * 13 + 1
# The per-bounce driver's films that --k2 renders at 16 spp, each one lane
# a pixel: render() sends films of one 4096-pixel block or less there.
K2_CELLS = (('cbox-64', 64), ('cbox-32', 32))
K2_SPP = 16


def device_time(e):
    """Self device microseconds of a profiler event (torch before and
    after the rename of cuda to device)."""
    t = getattr(e, 'self_device_time_total', None)
    return t if t is not None else getattr(e, 'self_cuda_time_total', 0.0)


def driver_split(torch, fn):
    """One fn() (a render through the per-bounce driver) traced with CPU
    and CUDA activity, the driver's uniform hashing (path._vertex_uniforms)
    and camera rays (camera.sample_primary_t) each in a range of its own.
    Returns wall seconds, device-busy seconds, idle share, K2's launches
    and device milliseconds of each, and the device milliseconds by part:
    'K2', 'uniforms', 'camera', then each other aten op outside those
    ranges by its name (aten::where, aten::index_add_, ...)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from lajolla_tpu_torch.integrators import path as PP

    def ranged(name, f):
        def g(*a, **k):
            with record_function(f'k2drv::{name}'):
                return f(*a, **k)
        return g
    torch.cuda.synchronize()
    with mock.patch.object(PP, '_vertex_uniforms',
                           ranged('uniforms', PP._vertex_uniforms)), \
            mock.patch.object(PP, 'sample_primary_t',
                              ranged('camera', PP.sample_primary_t)), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # a range also shows on the device as one span over its kernels and
    # the gaps between them: neither device time nor a part of it
    events = [e for e in prof.events() if not e.name.startswith('k2drv::')
              or e.device_type == DeviceType.CPU]
    dev_ev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = busy_seconds((e.time_range.start, e.time_range.end)
                        for e in dev_ev)
    k2 = [(e.time_range.end - e.time_range.start) / 1e3 for e in dev_ev
          if 'advance_kernel' in e.name]
    parts = {'K2': sum(k2)}
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        us = device_time(e)
        # K2 is counted by its kernels' name; runtime calls (cudaLaunch...)
        # hold the device time of the ops around them
        if (not us or 'advance' in e.name or e.name.startswith('cu') or
                e.name.startswith('k2drv::')):
            continue
        part, p = e.name, e.cpu_parent
        while p is not None:
            if p.name.startswith('k2drv::'):
                part = p.name[len('k2drv::'):]
                break
            if p.name.startswith('aten::'):
                part = p.name
            p = p.cpu_parent
        parts[part] = parts.get(part, 0.0) + us / 1e3
    return dict(wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
                k2_launches=len(k2), k2_ms=k2,
                device_ms_by_part=dict(sorted(parts.items(),
                                              key=lambda kv: -kv[1])))


def k2_ab(args, torch, dev, card):
    """The --k2 measurements (see the module docstring); returns them."""
    from chip_smoke import bound, cuda_ms, table_bytes, vertex_ops
    from lajolla_tpu_torch import kernels, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import path as PP
    from lajolla_tpu_torch.integrators import path_kernel as PK
    from lajolla_tpu_torch.scene.types import RenderOptions

    res = {'registers': kernel_registers(kernels.build_log(),
                                         ('advance', 'render_fused'))}
    if hasattr(kernels, 'advance_group'):
        res['group'] = {cell: kernels.advance_group(PT._film(r)[0] *
                                                    PT._film(r)[1])
                        for cell, r in K2_CELLS}
        res['group']['2^18'] = kernels.advance_group(1 << 18)
    saved = {}
    options = RenderOptions(samples_per_pixel=K2_SPP)
    for cell, film_res in K2_CELLS:
        scene = PT.make_cornell_box(film_res, spp=K2_SPP).to(dev)
        w, h = PT._film(film_res)
        n = w * h
        # one capture run: active lanes and the outputs on them, each call
        calls, active, outs = [], [], []

        def capture(scene_, options_, *a):
            out = PK.advance_kernel_t(scene_, options_, *a)
            act = a[8]
            calls.append((scene_, options_, *(
                x.clone() if torch.is_tensor(x) else x for x in a)))
            active.append(int(act.sum()))
            outs.append(tuple(x[:, act].T for x in out[:4]) +
                        (out[4][act], out[6][act]))
            return out
        film = PP._render_block_kernel(scene, options, 0, 0, K2_SPP,
                                       advance=capture)
        saved[f'{cell} K2 active outputs'] = outs
        saved[f'{cell} film'] = [(film.reshape(-1, 3),)]
        nbytes = n * K2_LANE_BYTES + table_bytes(scene)
        bounds = [bound(vertex_ops(scene, a), nbytes)[0] for a in active]

        def timed_render():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(scene, options, device=dev)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        timed_render()                                    # warm
        walls = [timed_render() for _ in range(args.runs)]
        traces = [driver_split(torch, lambda: render(scene, options,
                                                     device=dev))
                  for _ in range(min(args.runs, 3))]
        replay = device_runs(
            torch, lambda: [PK.advance_kernel_t(*c) for c in calls],
            2, 'advance_kernel', args.runs)
        k2_traced = [statistics.median(t['k2_ms']) for t in traces
                     if t['k2_ms']]
        r = dict(lanes=n, launches=len(active),
                 active_lanes_mean=statistics.mean(active),
                 bound_ms_mean=statistics.mean(bounds),
                 bound_ms_total=sum(bounds), render_walls_s=walls,
                 render_mpaths_per_s=[n * K2_SPP / x / 1e6 for x in walls],
                 k2_traced_median_ms=k2_traced,
                 k2_traced_total_ms=[sum(t['k2_ms']) for t in traces],
                 replayed_device_ms=replay,
                 traces=[{k: v for k, v in t.items() if k != 'k2_ms'}
                         for t in traces])
        res[cell] = r
        print(f"K2 at {cell}'s shape ({w}x{h} x {K2_SPP} spp, {n} lanes, "
              f"{len(active)} launches, {r['active_lanes_mean']:.0f} "
              f"active on average): render() walls {walls} s; K2 a launch "
              f"in the traced renders, medians {k2_traced} ms, totals "
              f"{r['k2_traced_total_ms']} ms; every launch replayed: "
              f"{replay}; bound {r['bound_ms_mean']:.5f} ms a launch on "
              f"average; "
              f"{card}", flush=True)
        for t in r['traces']:
            print(f"  traced render(): wall {t['wall_s']:.4f} s, busy "
                  f"{t['device_busy_s']:.4f} s, idle {t['idle_share']:.4f}, "
                  f"K2 launches {t['k2_launches']}; device ms by part "
                  f"{ {k: round(v, 3) for k, v in list(t['device_ms_by_part'].items())[:12]} }",
                  flush=True)
        del calls
        torch.cuda.empty_cache()

    cbox = PT.make_cornell_box(512).to(dev)
    lanes = PT.random_lanes(cbox, 1 << 18, 12)
    args2 = [torch.from_numpy(lanes[k]).to(dev) for k in
             ('org', 'dir', 'thr', 'rad', 'nv', 'dir_pdf', 'prev', 'un',
              'act')]
    act = args2[8]
    fn = lambda: PK.advance_kernel_t(cbox, options, *args2,
                                     PP.MAX_BOUNCES_CAP)
    out = fn()
    saved['2^18 K2 active outputs'] = [
        tuple(x[:, act].T for x in out[:4]) + (out[4][act], out[6][act])]
    res['2^18_k2_device_ms'] = device_runs(torch, fn, 10, 'advance_kernel',
                                           args.runs)
    res['2^18_k2_cuda_event_ms'] = cuda_ms(torch, fn, 10)
    print(f"K2 at 2^18 random lanes (Cornell box): device ms "
          f"{res['2^18_k2_device_ms']}, CUDA events "
          f"{res['2^18_k2_cuda_event_ms']:.4f} ms; {card}", flush=True)
    res['between_trees'] = ab_outputs(saved, args.films, args.against)
    print(f"K2 / K1 registers and spills: {res['registers']}; G "
          f"{res.get('group')}; between trees: "
          f"{brief(res['between_trees'])}", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', type=int, default=5)
    ap.add_argument('--out', default=os.path.join(
        REPO, 'chiprun_out', 'profile_torch_general.json'))
    ap.add_argument('--k3', action='store_true',
                    help='measure K3 and K2 alone')
    ap.add_argument('--k2', action='store_true',
                    help='measure K2 and the per-bounce driver alone')
    ap.add_argument('--label', default='')
    ap.add_argument('--films', help='with --k3 or --k2: save the outputs '
                    'here')
    ap.add_argument('--against', help='with --k3 or --k2: compare with '
                    'the outputs saved here')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_general: needs one CUDA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import cuda_ms
    from lajolla_tpu_torch import kernels, parse_scene, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import path as PP
    from lajolla_tpu_torch.ops.intersect import (_brute_force_batched,
                                                 _occluded_batched)

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
    if args.k3 or args.k2:
        print(f"tree {REPO} ({args.label}); {card}; build + load "
              f"{out['build_s']:.1f} s", flush=True)
        if args.k3:
            out['k3'] = k3_ab(args, torch, dev, card)
        else:
            out['k2'] = k2_ab(args, torch, dev, card)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
        return
    paths = 512 * 512 * 16

    with tempfile.TemporaryDirectory() as tmp:
        xml = PT.write_cornell_box_xml(os.path.join(tmp, 'glass'), 512, 16,
                                       variant='glass')
        scene, opt = parse_scene(xml, dev)

    def timed_render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(scene, opt, device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed_render()                                   # warm
    walls = [timed_render() for _ in range(args.runs)]
    out['render_walls_s'] = walls
    out['render_mpaths_per_s'] = [paths / w / 1e6 for w in walls]
    print(f"render() glass cbox 512x512 x 16 spp, {args.runs} warm runs: "
          f"Mpaths/s {out['render_mpaths_per_s']}; {card}", flush=True)
    _, _, iters = PP._render_block_sc(scene, opt, 0, 0, 16)
    out['loop_iterations'] = iters
    out['done_all_readbacks'] = iters + 1

    # trace A: device activity only
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_a = timed_render()
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_seconds((e.time_range.start, e.time_range.end)
                        for e in dev_ev)
    by_kind = {}
    for e in dev_ev:
        k = by_kind.setdefault(kind_of(e.name), [0, 0.0])
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e3
    out['trace_a'] = dict(
        wall_s=wall_a, device_busy_s=busy, idle_share=1.0 - busy / wall_a,
        device_activities=len(dev_ev),
        device_ms_by_kind={k: {'count': n, 'ms': ms}
                           for k, (n, ms) in sorted(by_kind.items())})
    median_wall = statistics.median(walls)
    out['idle_share_estimate_unprofiled'] = 1.0 - busy / median_wall
    print(f"trace A (CUDA only): wall {wall_a:.3f} s, device busy "
          f"{busy:.3f} s, idle share {1.0 - busy / wall_a:.4f}, "
          f"{len(dev_ev)} device activities; estimate for an unprofiled "
          f"render (busy / median wall {median_wall:.3f} s): idle "
          f"{out['idle_share_estimate_unprofiled']:.4f}", flush=True)

    # trace B: host calls that wait on the device
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_b = timed_render()
    syncs = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in SYNC_CALLS:
            s = syncs.setdefault(e.name, [0, 0.0])
            s[0] += 1
            s[1] += (e.time_range.end - e.time_range.start) / 1e3
    out['trace_b'] = dict(wall_s=wall_b, host_sync_calls={
        k: {'count': n, 'ms': ms} for k, (n, ms) in sorted(syncs.items())})
    print(f"trace B (CPU + CUDA): wall {wall_b:.3f} s; host calls that "
          f"wait on the device {out['trace_b']['host_sync_calls']}",
          flush=True)

    # K3 against its plain forms at 2^18 rays, alternating
    glass = PT.make_cornell_box(512, variant='glass').to(dev)
    rays = PT.general_rays(glass, seed=13)
    bounce, shadow = rays['bounce'], rays['shadow']
    k3 = {'closest_kernel': [], 'closest_plain': [], 'any_kernel': [],
          'any_plain': []}
    for _ in range(args.runs):
        k3['closest_plain'].append(cuda_ms(
            torch, lambda: _brute_force_batched(glass, *bounce), 5))
        k3['closest_kernel'].append(cuda_ms(
            torch, lambda: kernels.intersect_brute(glass, *bounce), 20))
        k3['any_kernel'].append(cuda_ms(
            torch, lambda: kernels.occluded_brute(glass, *shadow), 20))
        k3['any_plain'].append(cuda_ms(
            torch, lambda: _occluded_batched(glass, *shadow), 5))
    out['k3_ms_2e18_rays'] = k3
    print(f"K3 at 2^18 rays (glass cbox), ms per call: {k3}; {card}")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ('trace_a', 'trace_b', 'k3_ms_2e18_rays')}))


if __name__ == '__main__':
    main()
