"""Measure lajolla_tpu_torch's volumetric path tracer on one CUDA GPU:
the volumetric Cornell box ('vol', one homogeneous medium, the K8 class)
at 512x512.

usage, from the repository root: python3 tools/profile_torch_volpath.py
    [--runs 5] [--out chiprun_out/profile_torch_volpath.json]

Prints, and writes as JSON to --out:
- the card's `nvidia-smi` name and power limit;
- render() Mpaths/s at 256 spp (four K8 launches of 64 spp) over --runs
  warm runs (wall time, host clock);
- a torch.profiler trace (CUDA activity only) of one such render(): its
  wall time, the device-busy time (the union of kernel and copy
  intervals), the idle share 1 - busy / wall, and device time by name;
- K8 alone by CUDA events at 1, 4, 16 and 64 spp per launch, and at
  16 spp on 'vol_hg' (the HG branch) and on the submerged sphere-light
  scene (spheres, sphere lights, RoughPlastic);
- path statistics of the same work items, counted on the plain form at
  512x512 x 4 spp (one count per lane and path vertex): vertices per
  path, and the lockstep efficiency of 32-lane warps, the sum of the
  lanes' vertex counts over 32 x the sum of each warp's largest count.
  K8 runs a pixel's samples in one thread, so a warp runs until its
  longest queue ends; this is the share of lane-vertex slots that do
  work, before any divergence inside a vertex.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', type=int, default=5)
    ap.add_argument('--out', default=os.path.join(
        REPO, 'chiprun_out', 'profile_torch_volpath.json'))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_volpath: needs one CUDA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import cuda_ms
    from tools.profile_torch_general import busy_seconds
    from lajolla_tpu_torch import kernels, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import volpath_kernel as PVK
    from lajolla_tpu_torch.scene.types import RenderOptions

    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kernels.build()
    out = {'card': card}
    res, spp = 512, 256
    opts = RenderOptions(integrator='volpath', samples_per_pixel=spp)
    vol = PT.make_cornell_box(res, variant='vol').to(dev)

    def timed_render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(vol, opts, device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed_render()                                   # warm
    walls = [timed_render() for _ in range(args.runs)]
    out['render_walls_s'] = walls
    out['render_mpaths_per_s'] = [res * res * spp / w / 1e6 for w in walls]
    print(f"render() vol 512x512 x {spp} spp, {args.runs} warm runs: "
          f"Mpaths/s {out['render_mpaths_per_s']}; {card}", flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = timed_render()
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_seconds((e.time_range.start, e.time_range.end)
                        for e in dev_ev)
    by_name = {}
    for e in dev_ev:
        name = 'render_fused_vol_kernel' if 'render_fused_vol_kernel' in \
            e.name else e.name[:60]
        k = by_name.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e3
    out['trace'] = dict(
        wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
        device_ms_by_name={k: {'count': n, 'ms': ms}
                           for k, (n, ms) in sorted(by_name.items())})
    print(f"trace (CUDA only): wall {wall:.4f} s, device busy {busy:.4f} s, "
          f"idle share {1.0 - busy / wall:.4f}; by name "
          f"{out['trace']['device_ms_by_name']}", flush=True)

    base = RenderOptions(integrator='volpath')
    k8 = {}
    for n in (1, 4, 16, 64):
        k8[f'vol_{n}spp'] = cuda_ms(torch, lambda: PVK.render_fused_vol(
            vol, base, 0, 0, n), 5)
    for name, scene in (
            ('vol_hg_16spp', PT.make_cornell_box(res, variant='vol_hg')),
            ('submerged_sphere_16spp',
             PT.compile_scene(PT.submerged_sphere_builder(res)))):
        scene = scene.to(dev)
        k8[name] = cuda_ms(torch, lambda: PVK.render_fused_vol(
            scene, base, 0, 0, 16), 5)
    out['k8_ms_512x512'] = k8
    print(f"K8 at 512x512, ms per launch: {k8}; {card}", flush=True)

    counts = torch.zeros(res * res, dtype=torch.int64, device=dev)
    real = PVK._advance_vol_core

    def counting(scene, o, d, thr, rad, bounces, dir_pdf, mtp, nee_p,
                 act_in, *a, **k):
        counts.add_(act_in[0].to(torch.int64))
        return real(scene, o, d, thr, rad, bounces, dir_pdf, mtp, nee_p,
                    act_in, *a, **k)
    plain_spp = 4
    with mock.patch.object(PVK, '_advance_vol_core', counting):
        PVK.render_fused_vol_plain(vol, base, 0, 0, plain_spp)
    c = counts.double()
    warp_max = c.reshape(-1, 32).amax(dim=1)
    out['paths_plain_4spp'] = dict(
        vertices_per_path=float(c.sum()) / (res * res * plain_spp),
        lane_vertices_mean=float(c.mean()), lane_vertices_max=float(c.max()),
        lane_vertices_median=float(c.median()),
        warp32_lockstep_efficiency=float(c.sum() / (32 * warp_max.sum())))
    print(f"paths (plain form, 512x512 x {plain_spp} spp): "
          f"{out['paths_plain_4spp']}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != 'trace'}))
    print(f"median render() Mpaths/s "
          f"{statistics.median(out['render_mpaths_per_s']):.2f}; {card}")


if __name__ == '__main__':
    main()
