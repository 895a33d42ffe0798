"""Measure lajolla_tpu_torch's grid-media path tracer on one CUDA GPU: the
heterogeneous Cornell box ('hetvol', a 128x128x50 mono density grid in a
BSDF-less cube, the K9 class) at 768x576, the hetvol-768 cell.

usage, from the repository root: python3 tools/profile_torch_hetvol.py
    [--runs 5] [--out chiprun_out/profile_torch_hetvol.json]

Prints, and writes as JSON to --out:
- the card's `nvidia-smi` name and power limit;
- render() Mpaths/s at 32 spp (one K9 launch) over --runs warm runs
  (wall time, host clock), and their median;
- a torch.profiler trace (CUDA activity only) of one such render(): its
  wall time, the device-busy time (the union of kernel and copy
  intervals), the idle share 1 - busy / wall, and device time by name
  (K9's share of the device time);
- K9 alone by CUDA events at 1, 4 and 32 spp per launch (the fixed cost
  per launch), and at 4 spp on 'hetvol_hg' (the HG branch) beside
  'hetvol' at 4 spp;
- path statistics of the same work items at 768x576 x 1 spp, counted on
  the plain form (render_fused_grid_plain's counters): vertices, casts
  and tracking steps (one density read each) per path, and the 32-lane
  lockstep efficiency of a warp's tracking steps and of its vertices:
  the sum of the lanes' counts over 32 x the sum of each warp's largest
  count. K9 runs a pixel's samples in one thread, so a warp runs until
  its busiest lane ends; this is the share of lane-step slots that do
  work.
Imports no JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def lockstep(counts):
    """Share of a 32-lane warp's slots that do work, for per-lane counts
    of a film whose width is a multiple of 32."""
    c = counts.double()
    return float(c.sum() / (32 * c.reshape(-1, 32).amax(dim=1).sum()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', type=int, default=5)
    ap.add_argument('--out', default=os.path.join(
        REPO, 'chiprun_out', 'profile_torch_hetvol.json'))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_hetvol: needs one CUDA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import cuda_ms
    from tools.profile_torch_general import busy_seconds
    from lajolla_tpu_torch import kernels, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import volpath_grid_kernel as PGK
    from lajolla_tpu_torch.scene.types import RenderOptions

    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kernels.build()
    out = {'card': card}
    w, h, spp = 768, 576, 32
    n = w * h
    opts = RenderOptions(integrator='volpath', samples_per_pixel=spp)
    het = PT.make_cornell_box((w, h), spp, 'hetvol').to(dev)

    def timed_render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(het, opts, device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed_render()                                   # warm
    walls = [timed_render() for _ in range(args.runs)]
    out['render_walls_s'] = walls
    out['render_mpaths_per_s'] = [n * spp / t / 1e6 for t in walls]
    out['render_mpaths_per_s_median'] = statistics.median(
        out['render_mpaths_per_s'])
    print(f"render() hetvol {w}x{h} x {spp} spp, {args.runs} warm runs: "
          f"Mpaths/s {out['render_mpaths_per_s']}; {card}", flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = timed_render()
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_seconds((e.time_range.start, e.time_range.end)
                        for e in dev_ev)
    by_name = {}
    for e in dev_ev:
        name = 'render_fused_grid_kernel' if 'render_fused_grid_kernel' in \
            e.name else e.name[:60]
        k = by_name.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e3
    total_ms = sum(ms for _, ms in by_name.values())
    k9_ms = by_name.get('render_fused_grid_kernel', [0, 0.0])[1]
    out['trace'] = dict(
        wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
        k9_share_of_device_time=k9_ms / total_ms if total_ms else None,
        device_ms_by_name={k: {'count': c, 'ms': ms}
                           for k, (c, ms) in sorted(by_name.items())})
    print(f"trace (CUDA only): wall {wall:.4f} s, device busy {busy:.4f} s, "
          f"idle share {1.0 - busy / wall:.4f}, K9 share of device time "
          f"{out['trace']['k9_share_of_device_time']}; by name "
          f"{out['trace']['device_ms_by_name']}", flush=True)

    base = RenderOptions(integrator='volpath')
    k9 = {}
    for s in (1, 4, 32):
        k9[f'hetvol_{s}spp'] = cuda_ms(torch, lambda: PGK.render_fused_grid(
            het, base, 0, 0, s), 3)
    hg = PT.make_cornell_box((w, h), 4, 'hetvol_hg').to(dev)
    k9['hetvol_hg_4spp'] = cuda_ms(torch, lambda: PGK.render_fused_grid(
        hg, base, 0, 0, 4), 3)
    k9['hetvol_4spp_again'] = cuda_ms(torch, lambda: PGK.render_fused_grid(
        het, base, 0, 0, 4), 3)
    out['k9_ms_768x576'] = k9
    print(f"K9 at 768x576, ms per launch: {k9}; {card}", flush=True)

    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    PGK.render_fused_grid_plain(het, base, 0, 0, 1, stats=stats)
    torch.cuda.synchronize()
    out['paths_plain_1spp'] = dict(
        plain_s=time.perf_counter() - t0, event_steps=stats['steps'],
        vertices_per_path=stats['vertices'] / n,
        casts_per_path=stats['casts'] / n,
        track_steps_per_path=stats['track_steps'] / n,
        density_reads_per_path=stats['track_steps'] / n,
        lane_track_steps_max=int(stats['lane_track_steps'].max()),
        lane_vertices_max=int(stats['lane_vertices'].max()),
        warp32_lockstep_track_steps=lockstep(stats['lane_track_steps']),
        warp32_lockstep_vertices=lockstep(stats['lane_vertices']),
        warp32_lockstep_work=lockstep(stats['lane_track_steps'] +
                                      stats['lane_casts']))
    print(f"paths (plain form, {w}x{h} x 1 spp): "
          f"{out['paths_plain_1spp']}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != 'trace'}))
    print(f"median render() Mpaths/s {out['render_mpaths_per_s_median']:.2f}"
          f"; {card}")


if __name__ == '__main__':
    main()
