"""Measure lajolla_tpu_torch's volumetric path tracer on one CUDA GPU:
the volumetric Cornell box ('vol', one homogeneous medium, the K8 class)
at 512x512, the vol-512 cell. Runs unchanged from an older tree of the
repository (a `git archive` copy), so that one chip call can time two
trees in turns.

usage, from the root of the tree to measure:
    python3 tools/profile_torch_volpath.py [--runs 5] [--label new]
        [--out chiprun_out/profile_torch_volpath.json]
        [--films PATH] [--against PATH] [--proxies]

Prints, and writes as JSON to --out:
- the card's `nvidia-smi` name and power limit;
- render() Mpaths/s at 256 spp (four K8 launches of 64 spp) over --runs
  warm runs (wall time, host clock);
- a torch.profiler trace (CUDA activity only) of one such render(): its
  wall time, the device-busy time (the union of kernel and copy
  intervals), the idle share 1 - busy / wall, and device time by name;
- K8 by CUDA events, one launch through its wrapper (the film sum
  included where the tree has one): 'vol' at 4 and 64 spp, 'vol_hg' and
  the submerged sphere-light scene (spheres, sphere lights, RoughPlastic)
  at 64 spp, the main path's launch (volpath.VOLK_SPP_BLOCK);
- where the tree's K8 has SIMT counters (kernels.VOL_COUNTERS): those of
  'vol' at 64 spp, and the share of a warp's lanes that hold a path in
  its loop iterations;
- --films PATH: K8's films ('vol' at 4 and 64 spp, 'vol_hg' and the
  submerged spheres at 64 spp) saved there (torch.save); --against PATH:
  the share of those films' pixels bit-equal to the ones saved at PATH
  by another tree's run;
- --proxies: the plain form's 32-lane lockstep proxies of a per-thread
  K8 at 512x512 x 4 spp (one count per lane and path vertex): per-lane
  totals (the sum of the lanes' vertex counts over 32 x the sum of each
  warp's largest total: a warp runs until its longest queue of samples
  ends) and per-sample reconvergence (over 32 x the sum, over samples, of
  each warp's longest path: what nested sample and bounce loops pay).
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


def bit_equal_shares(torch, films, path):
    """{name: share of pixels equal in all channels} against the films
    saved at `path`."""
    other = torch.load(path)
    return {k: float((v == other[k]).all(dim=-1).float().mean())
            for k, v in films.items() if k in other}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', type=int, default=5)
    ap.add_argument('--label', default='')
    ap.add_argument('--out', default=os.path.join(
        REPO, 'chiprun_out', 'profile_torch_volpath.json'))
    ap.add_argument('--films')
    ap.add_argument('--against')
    ap.add_argument('--proxies', action='store_true')
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
    from lajolla_tpu_torch.integrators import volpath as PV
    from lajolla_tpu_torch.integrators import volpath_kernel as PVK
    from lajolla_tpu_torch.scene.types import RenderOptions

    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kernels.build()
    out = {'card': card, 'label': args.label, 'tree': REPO}
    tag = f"[{args.label}] " if args.label else ''
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
    out['render_mpaths_per_s_median'] = statistics.median(
        out['render_mpaths_per_s'])
    print(f"{tag}render() vol 512x512 x {spp} spp, {args.runs} warm runs: "
          f"Mpaths/s {out['render_mpaths_per_s']}; {card}", flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = timed_render()
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_seconds((e.time_range.start, e.time_range.end)
                        for e in dev_ev)
    by_name = {}
    for e in dev_ev:
        name = next((k for k in ('render_fused_vol_kernel', 'film_sum_kernel')
                     if k in e.name), e.name[:60])
        k = by_name.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e3
    out['trace'] = dict(
        wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
        device_ms_by_name={k: {'count': n, 'ms': ms}
                           for k, (n, ms) in sorted(by_name.items())})
    print(f"{tag}trace (CUDA only): wall {wall:.4f} s, device busy "
          f"{busy:.4f} s, idle share {1.0 - busy / wall:.4f}; by name "
          f"{out['trace']['device_ms_by_name']}", flush=True)

    base = RenderOptions(integrator='volpath')
    main_spp = PV.VOLK_SPP_BLOCK
    scenes = {'vol': vol,
              'vol_hg': PT.make_cornell_box(res, variant='vol_hg').to(dev),
              'submerged_sphere': PT.compile_scene(
                  PT.submerged_sphere_builder(res)).to(dev)}
    k8, films = {}, {}
    for name, scene, n in (('vol', vol, 4), ('vol', vol, main_spp),
                           ('vol_hg', scenes['vol_hg'], main_spp),
                           ('submerged_sphere', scenes['submerged_sphere'],
                            main_spp)):
        key = f'{name}_{n}spp'
        films[key] = PVK.render_fused_vol(scene, base, 0, 0, n).cpu()
        k8[key] = cuda_ms(torch, lambda: PVK.render_fused_vol(
            scene, base, 0, 0, n), 5)
    out['k8_ms_512x512'] = k8
    print(f"{tag}K8 at 512x512, ms per launch: {k8}; {card}", flush=True)
    if hasattr(kernels, 'VOL_COUNTERS'):
        cnt = {}
        PVK.render_fused_vol(vol, base, 0, 0, main_spp, counters=cnt)
        out['k8_counters_vol_64spp'] = cnt
        out['k8_simt_efficiency'] = cnt['path_lanes'] / (
            32 * cnt['iterations'])
        print(f"{tag}K8 counters, vol 512x512 x {main_spp} spp: {cnt}; SIMT "
              f"efficiency of the loop {out['k8_simt_efficiency']:.4f}",
              flush=True)
    if args.films:
        torch.save(films, args.films)
    if args.against and os.path.exists(args.against):
        out['bit_equal_pixels'] = bit_equal_shares(torch, films,
                                                   args.against)
        print(f"{tag}K8 films, share of pixels bit-equal to "
              f"{args.against}: {out['bit_equal_pixels']}", flush=True)

    if args.proxies:
        plain_spp = 4
        n = res * res
        counts = torch.zeros((plain_spp, n), dtype=torch.int64, device=dev)
        sample = torch.full((n,), -1, dtype=torch.int64, device=dev)
        lane = torch.arange(n, device=dev)
        real = PVK._advance_vol_core

        def counting(scene, o, d, thr, rad, bounces, dir_pdf, mtp, nee_p,
                     act_in, *a, **k):
            act = act_in[0]
            sample.add_((act & (bounces[0] == 0)).to(torch.int64))
            counts.index_put_((sample[act], lane[act]),
                              torch.ones_like(lane[act]), accumulate=True)
            return real(scene, o, d, thr, rad, bounces, dir_pdf, mtp, nee_p,
                        act_in, *a, **k)
        with mock.patch.object(PVK, '_advance_vol_core', counting):
            PVK.render_fused_vol_plain(vol, base, 0, 0, plain_spp)
        c = counts.double()
        total = c.sum(dim=0)
        per_lane = float(total.sum() / (32 * total.reshape(-1, 32).amax(
            dim=1).sum()))
        per_sample = float(c.sum() / (32 * c.reshape(plain_spp, -1, 32).amax(
            dim=2).sum()))
        out['proxies_plain_4spp'] = dict(
            vertices_per_path=float(c.sum()) / (n * plain_spp),
            warp32_lockstep_per_lane_totals=per_lane,
            warp32_lockstep_per_sample=per_sample)
        print(f"{tag}plain-form lockstep proxies (512x512 x {plain_spp} "
              f"spp): {out['proxies_plain_4spp']}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != 'trace'}))
    print(f"{tag}median render() Mpaths/s "
          f"{out['render_mpaths_per_s_median']:.2f}; {card}")


if __name__ == '__main__':
    main()
