"""Measure lajolla_tpu_torch's grid-media path tracer on one CUDA GPU: the
heterogeneous Cornell box ('hetvol', a 128x128x50 mono density grid in a
BSDF-less cube, the K9 class) at 768x576, the hetvol-768 cell. Runs
unchanged from an older tree of the repository (a `git archive` copy), so
that one chip call can time two trees in turns.

usage, from the root of the tree to measure:
    python3 tools/profile_torch_hetvol.py [--runs 5] [--label new]
        [--out chiprun_out/profile_torch_hetvol.json]
        [--films PATH] [--against PATH] [--proxies]

Prints, and writes as JSON to --out:
- the card's `nvidia-smi` name and power limit;
- render() Mpaths/s at 32 spp (one K9 launch) over --runs warm runs
  (wall time, host clock), and their median;
- a torch.profiler trace (CUDA activity only) of one such render(): its
  wall time, the device-busy time (the union of kernel and copy
  intervals), the idle share 1 - busy / wall, and device time by name
  (K9's share of the device time);
- K9 by CUDA events, one launch through its wrapper (the film sum
  included where the tree has one), at 1, 4 and 32 spp on 'hetvol' and
  at 32 spp (the main path's launch) on 'hetvol_hg' (the HG branch);
- where the tree's K9 has SIMT counters (kernels.GRID_COUNTERS): those of
  'hetvol' at 32 spp, and by stage the share of a warp's lanes that work
  in its passes (casts, tracking steps, vertices);
- --films PATH: K9's films ('hetvol' at 4 and 32 spp, 'hetvol_hg' at 32)
  saved there (torch.save); --against PATH: the share of those films'
  pixels bit-equal to the ones saved at PATH by another tree's run;
- --proxies: path statistics of the same work items at 768x576 x 2 spp,
  counted on the plain form: vertices, casts and tracking steps (one
  density read each) per path, and the 32-lane lockstep proxies of a
  per-thread K9's tracking steps: per-lane totals (the sum of the lanes'
  counts over 32 x the sum of each warp's largest total; PERF.md's older
  figure is this at 1 spp) and per-sample reconvergence (over 32 x the
  sum, over samples, of each warp's largest count: what nested sample and
  flight loops pay).
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


def lockstep(counts):
    """Share of a 32-lane warp's slots that do work, for per-lane counts
    (..., n) of a film whose width is a multiple of 32: the counts over
    32 x the sum of each warp's largest count, per leading index."""
    c = counts.double()
    return float(c.sum() / (32 * c.reshape(*c.shape[:-1], -1, 32).amax(
        dim=-1).sum()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', type=int, default=5)
    ap.add_argument('--label', default='')
    ap.add_argument('--out', default=os.path.join(
        REPO, 'chiprun_out', 'profile_torch_hetvol.json'))
    ap.add_argument('--films')
    ap.add_argument('--against')
    ap.add_argument('--proxies', action='store_true')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_hetvol: needs one CUDA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import cuda_ms
    from tools.profile_torch_general import busy_seconds
    from tools.profile_torch_volpath import bit_equal_shares
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
    out = {'card': card, 'label': args.label, 'tree': REPO}
    tag = f"[{args.label}] " if args.label else ''
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
    print(f"{tag}render() hetvol {w}x{h} x {spp} spp, {args.runs} warm "
          f"runs: Mpaths/s {out['render_mpaths_per_s']}; {card}", flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = timed_render()
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_seconds((e.time_range.start, e.time_range.end)
                        for e in dev_ev)
    by_name = {}
    for e in dev_ev:
        name = next((k for k in ('render_fused_grid_kernel',
                                 'film_sum_kernel') if k in e.name),
                    e.name[:60])
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
    print(f"{tag}trace (CUDA only): wall {wall:.4f} s, device busy "
          f"{busy:.4f} s, idle share {1.0 - busy / wall:.4f}, K9 share of "
          f"device time {out['trace']['k9_share_of_device_time']}; by name "
          f"{out['trace']['device_ms_by_name']}", flush=True)

    base = RenderOptions(integrator='volpath')
    hg = PT.make_cornell_box((w, h), 4, 'hetvol_hg').to(dev)
    k9, films = {}, {}
    for name, scene, s in (('hetvol', het, 1), ('hetvol', het, 4),
                           ('hetvol', het, spp), ('hetvol_hg', hg, spp)):
        key = f'{name}_{s}spp'
        if s > 1:
            films[key] = PGK.render_fused_grid(scene, base, 0, 0, s).cpu()
        k9[key] = cuda_ms(torch, lambda: PGK.render_fused_grid(
            scene, base, 0, 0, s), 3)
    out['k9_ms_768x576'] = k9
    print(f"{tag}K9 at 768x576, ms per launch: {k9}; {card}", flush=True)
    if hasattr(kernels, 'GRID_COUNTERS'):
        cnt = {}
        PGK.render_fused_grid(het, base, 0, 0, spp, counters=cnt)
        out['k9_counters_hetvol_32spp'] = cnt
        out['k9_simt_efficiency'] = {
            stage: cnt[lanes] / (32 * cnt[passes]) if cnt[passes] else 0.0
            for stage, passes, lanes in (
                ('loop', 'iterations', 'path_lanes'),
                ('casts', 'cast_passes', 'casts'),
                ('track_steps', 'track_passes', 'track_steps'),
                ('vertices', 'vertex_passes', 'vertices'))}
        print(f"{tag}K9 counters, hetvol {w}x{h} x {spp} spp: {cnt}; SIMT "
              f"efficiency by stage {out['k9_simt_efficiency']}", flush=True)
    if args.films:
        torch.save(films, args.films)
    if args.against and os.path.exists(args.against):
        out['bit_equal_pixels'] = bit_equal_shares(torch, films,
                                                   args.against)
        print(f"{tag}K9 films, share of pixels bit-equal to "
              f"{args.against}: {out['bit_equal_pixels']}", flush=True)

    if args.proxies:
        plain_spp = 2
        n_q = PGK.padded_lanes(n)
        counts = torch.zeros((plain_spp, n_q), dtype=torch.int64,
                             device=dev)
        sample = torch.zeros(n_q, dtype=torch.int64, device=dev)
        lane = torch.arange(n_q, device=dev)
        real = PGK._advance_grid_core

        def counting(scene, st_in, *a, **k):
            nst, died = real(scene, st_in, *a, **k)
            live = ~st_in[-1][0]
            it0, it1 = st_in[12][0], nst[12][0]
            inc = torch.where(it1 >= it0, it1 - it0, it1)
            counts.index_put_((sample[live], lane[live]), inc[live],
                              accumulate=True)
            sample.add_(died[0].to(torch.int64))
            return nst, died
        stats = {}
        t0 = time.perf_counter()
        with mock.patch.object(PGK, '_advance_grid_core', counting):
            PGK.render_fused_grid_plain(het, base, 0, 0, plain_spp,
                                        stats=stats)
        torch.cuda.synchronize()
        c = counts[:, :n]
        paths = n * plain_spp
        out['proxies_plain_2spp'] = dict(
            plain_s=time.perf_counter() - t0, event_steps=stats['steps'],
            vertices_per_path=stats['vertices'] / paths,
            casts_per_path=stats['casts'] / paths,
            track_steps_per_path=stats['track_steps'] / paths,
            lane_track_steps_max=int(stats['lane_track_steps'].max()),
            warp32_lockstep_track_steps_per_lane_totals=lockstep(c.sum(0)),
            warp32_lockstep_track_steps_per_sample=lockstep(c),
            warp32_lockstep_track_steps_per_lane_totals_1st_sample=lockstep(
                c[0]))
        print(f"{tag}plain form ({w}x{h} x {plain_spp} spp): "
              f"{out['proxies_plain_2spp']}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != 'trace'}))
    print(f"{tag}median render() Mpaths/s "
          f"{out['render_mpaths_per_s_median']:.2f}; {card}")


if __name__ == '__main__':
    main()
