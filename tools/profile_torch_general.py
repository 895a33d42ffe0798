"""Measure lajolla_tpu_torch's general engine on one CUDA GPU: the glass
Cornell box at 512x512 x 16 spp (one SPP_BLOCK, the CLI main path's
general-engine run), and kernel K3 against its plain forms.

usage, from the repository root: python3 tools/profile_torch_general.py
    [--runs 5] [--out chiprun_out/profile_torch_general.json]
    [--k3 [--label TEXT] [--films PATH] [--against PATH]]

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

With --k3 it measures the brute-force casts K3 and the per-vertex kernel
K2 alone, in place of all that:
- K3 on chip_smoke.py [7]'s rays (the camera, bounce and shadow rays of
  the glass Cornell box and the sphere-light scene at 512x512, 2^18 each),
  closest and any hit; at glass-512's shape (the bounce and shadow rays of
  the glass box: the engine's pool is one lane a pixel, 2^18 lanes) its
  device time in --runs traces (torch.profiler: the mean and median of
  each, so the runs give the spread) and by CUDA events, which there time
  the host's issue rate: what the host-bound engine pays a call;
- every K3 launch of one glass-512 render() (a digest of its outputs), and
  K3's device time a launch in a trace of another;
- K2 at cbox-96's shape: every launch of the per-bounce driver on the
  Cornell box at 96x96 x 16 spp (one lane a pixel, 9,216 lanes) kept and
  replayed, its device time a launch --runs times, with the bound of each
  launch's active lanes (chip_smoke.vertex_ops) averaged; and at
  chip_smoke.py [3]'s 2^18 random lanes;
- the ptxas registers and spills of K3 and K2.
--films PATH saves the outputs (and digests); --against PATH, a file
another tree saved, gives the share of rays (of launches, for digests)
whose outputs are bit-equal between the trees.
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
        kernels.build_log(), ('intersect_brute', 'occluded_brute',
                              'advance'))}
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

    # ---- K2 at cbox-96's shape, and at 2^18 lanes
    options = RenderOptions()
    cbox96 = PT.make_cornell_box(96).to(dev)
    calls = []

    def capture(scene_, options_, *a):
        calls.append((scene_, options_,
                      *(x.clone() if torch.is_tensor(x) else x for x in a)))
        return PK.advance_kernel_t(scene_, options_, *a)
    PP._render_block_kernel(cbox96, options, 0, 0, 16, advance=capture)
    saved['cbox-96 K2 digests'] = [
        (digest(*PK.advance_kernel_t(*c)),) for c in calls]
    n96 = 96 * 96
    bytes96 = n96 * (4 * (15 + 2 + 8) + 1 + 4 * 13 + 1) + table_bytes(cbox96)
    bounds = [bound(vertex_ops(cbox96, int(c[10].sum())), bytes96)[0]
              for c in calls]
    active = [int(c[10].sum()) for c in calls]
    ms = device_runs(torch, lambda: [PK.advance_kernel_t(*c) for c in calls],
                     2, 'advance_kernel', args.runs)
    res['cbox96'] = dict(launches=len(calls), lanes=n96,
                         active_lanes_mean=statistics.mean(active),
                         device_ms=ms, bound_ms_mean=statistics.mean(bounds),
                         bound_ms_total=sum(bounds))
    print(f"K2 at cbox-96's shape (96x96 x 16 spp, {n96} lanes): "
          f"{res['cbox96']}; {card}", flush=True)
    cbox = PT.make_cornell_box(512).to(dev)
    lanes = PT.random_lanes(cbox, 1 << 18, 12)
    args2 = [torch.from_numpy(lanes[k]).to(dev) for k in
             ('org', 'dir', 'thr', 'rad', 'nv', 'dir_pdf', 'prev', 'un',
              'act')]
    from lajolla_tpu_torch.integrators.path import MAX_BOUNCES_CAP
    fn = lambda: PK.advance_kernel_t(cbox, options, *args2, MAX_BOUNCES_CAP)
    saved['2^18 K2 digest'] = [(digest(*fn()),)]
    res['2^18_k2_device_ms'] = device_runs(torch, fn, 10, 'advance_kernel',
                                           args.runs)
    res['2^18_k2_cuda_event_ms'] = cuda_ms(torch, fn, 10)
    print(f"K2 at 2^18 random lanes (Cornell box): device ms "
          f"{res['2^18_k2_device_ms']}, CUDA events "
          f"{res['2^18_k2_cuda_event_ms']:.4f} ms; {card}", flush=True)

    res['between_trees'] = ab_outputs(saved, args.films, args.against)
    print(f"K3 / K2 registers and spills: {res['registers']}; between "
          f"trees: {brief(res['between_trees'])}", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', type=int, default=5)
    ap.add_argument('--out', default=os.path.join(
        REPO, 'chiprun_out', 'profile_torch_general.json'))
    ap.add_argument('--k3', action='store_true',
                    help='measure K3 and K2 alone')
    ap.add_argument('--label', default='')
    ap.add_argument('--films', help='with --k3: save the outputs here')
    ap.add_argument('--against',
                    help='with --k3: compare with the outputs saved here')
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
    if args.k3:
        print(f"tree {REPO} ({args.label}); {card}; build + load "
              f"{out['build_s']:.1f} s", flush=True)
        out['k3'] = k3_ab(args, torch, dev, card)
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
