"""Measure lajolla_tpu_torch's general engine on one CUDA GPU: the glass
Cornell box at 512x512 x 16 spp (one SPP_BLOCK, the CLI main path's
general-engine run), and kernel K3 against its plain forms.

usage, from the repository root: python3 tools/profile_torch_general.py
    [--runs 5] [--out chiprun_out/profile_torch_general.json]

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
Imports no JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', type=int, default=5)
    ap.add_argument('--out', default=os.path.join(
        REPO, 'chiprun_out', 'profile_torch_general.json'))
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
    kernels.build()
    out = {'card': card}
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
