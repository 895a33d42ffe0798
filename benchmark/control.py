"""Readings for a cell's limits: the numbers check.compare gives for the
program on many seeds (the lower readings) and for the control, the
reference computed with its tables and path state rounded through
bfloat16 and put in the program's place (the upper readings), at the
cell's own film, samples and compared pixels. The benchmark's runs never
run it.

    python3 benchmark/control.py --workload cbox.final-512 \
        --seeds 11,12,13 [--control-seeds 11,12,13] [--out readings.json]

For each seed it renders the frames a run compares (the first
check_frames frame seeds of that seed) with the program on one GPU, then
the reference at the sampled pixels, and for each control seed the
control at the same pixels; prints one line a reading (the numbers over
all frames, and each one's largest over single frames, `.frame_max`)
and writes them all as JSON.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from benchmark import check, harness
    spec = harness.load_cell(args.workload)
    traffic, cell, kind = spec['traffic'], spec['cell'], spec['kind']
    dev = torch.device(args.device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit("control: no GPU")
    w, h, spp = traffic['width'], traffic['height'], traffic['spp']
    seeds = [int(s) for s in args.seeds.split(',') if s]
    cseeds = [int(s) for s in args.control_seeds.split(',') if s]
    out = dict(workload=args.workload, program={}, control={})

    def numbers(got, want, pixels):
        """The numbers over all frames, and each number's largest over
        the frames one by one (a run's `failed` count judges those)."""
        nums = check.compare(got, want, pixels)
        for k in check.NUMBERS:
            nums[f'{k}.frame_max'] = max(
                check.compare(g[None], r[None], pixels)[k]
                for g, r in zip(got, want))
        return nums
    with tempfile.TemporaryDirectory(prefix='bench_control_') as tmp:
        xml = kind.write_scene(tmp, spec['config'], w, h, spp)
        ref = kind.build(spec['config'], w, h, device=dev)
        if seeds:
            import lajolla_tpu_torch
            from lajolla_tpu_torch import kernels
            if dev.type == 'cuda':
                kernels.build()
            scene, options = lajolla_tpu_torch.parse_scene(xml, dev)
    for seed in sorted(set(seeds) | set(cseeds)):
        pixels = check.sample_pixels(seed, w * h, cell['check_block_pixels'])
        fseeds = [check.frame_seed(seed, k)
                  for k in range(cell['check_frames'])]
        t0 = time.perf_counter()
        want = check.reference_pixels(kind, ref, fseeds, pixels, spp,
                                      cell['check_chunk'])
        t_ref = time.perf_counter() - t0
        if seed in seeds:
            got = np.stack([lajolla_tpu_torch.render(
                scene, options, device=dev, seed=s).reshape(-1, 3)[pixels]
                for s in fseeds])
            nums = numbers(got, want, pixels)
            out['program'][seed] = nums
            print(f"program seed {seed}: {nums} (reference {t_ref:.2f} s)",
                  flush=True)
        if seed in cseeds:
            t0 = time.perf_counter()
            low = check.reference_pixels(kind, ref, fseeds, pixels, spp,
                                         cell['check_chunk'],
                                         rounding=check.bf16_round)
            nums = numbers(low, want, pixels)
            out['control'][seed] = nums
            print(f"control seed {seed}: {nums} "
                  f"({time.perf_counter() - t0:.2f} s)", flush=True)
    for side in ('program', 'control'):
        for k in out[side] and next(iter(out[side].values())):
            vals = [v[k] for v in out[side].values()]
            if vals:
                print(f"{side} {k}: min {min(vals)!r} max {max(vals)!r}")
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)


if __name__ == '__main__':
    main()
