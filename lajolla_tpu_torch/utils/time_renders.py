"""Time render() of lajolla_tpu_torch's cells on one CUDA GPU, warm, and
save their films. Runs unchanged from an older tree of the repository (a
`git archive` copy), so that one chip call can time two trees in turns.

usage, from the root of the tree to measure (copy this file into an
older tree's lajolla_tpu_torch/utils/ to time that tree):
    python3 -m lajolla_tpu_torch.utils.time_renders [--runs 3]
        [--label new] [--cells cbox-512,vol-512,...] [--films PATH]
        [--against PATH] [--out time_renders.json]

Cells (the `testing` Cornell box variants of PERF.md section 4, built in
code): cbox-512 (512x512 x 256 spp, K1), vol-512 (x 256, K8),
hetvol-768 (768x576 x 32, K9), glass-512 (x 16, the general engine),
vol1-512 and vol2-512 ('vol' under volpath versions 1 and 2, x 16).
Each cell is rendered once to warm it, then --runs times; prints, and
writes as JSON to --out, the card's `nvidia-smi` name and power limit
and each cell's render() seconds (host clock around a synchronised
render) and Mpaths/s of the median run. --films PATH saves the films
(numpy, torch.save); --against PATH prints the share of pixels bit-equal
to the films another tree saved there. Imports no JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CELLS = {  # name: (film, spp, variant, integrator, volpath version)
    'cbox-512': (512, 256, None, 'path', None),
    'vol-512': (512, 256, 'vol', 'volpath', None),
    'hetvol-768': ((768, 576), 32, 'hetvol', 'volpath', None),
    'glass-512': (512, 16, 'glass', 'path', None),
    'vol1-512': (512, 16, 'vol', 'volpath', 1),
    'vol2-512': (512, 16, 'vol', 'volpath', 2),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--runs', type=int, default=3)
    ap.add_argument('--label', default='tree')
    ap.add_argument('--cells', default=','.join(CELLS))
    ap.add_argument('--films')
    ap.add_argument('--against')
    ap.add_argument('--out', default='time_renders.json')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("time_renders: needs a CUDA GPU")
    from lajolla_tpu_torch import kernels, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.scene.types import RenderOptions

    dev = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    kernels.build()
    result = dict(label=args.label, device=smi, cells={})
    films = {}
    for name in args.cells.split(','):
        res, spp, variant, integrator, version = CELLS[name]
        scene = PT.make_cornell_box(res, spp, variant).to(dev)
        kw = {} if version is None else dict(vol_path_version=version)
        opts = RenderOptions(integrator=integrator, samples_per_pixel=spp,
                             **kw)
        seconds = []
        for _ in range(args.runs + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            films[name] = render(scene, opts, device=dev)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        seconds = seconds[1:]
        w, h = scene.meta.width, scene.meta.height
        med = statistics.median(seconds)
        result['cells'][name] = dict(seconds=seconds, median_s=med,
                                     mpaths_s=w * h * spp / med / 1e6)
        runs = ', '.join(f'{t:.4f}' for t in seconds)
        print(f"{args.label} {name}: render() {runs} s, "
              f"{w * h * spp / med / 1e6:.3f} Mpaths/s at the median ({smi})",
              flush=True)
    if args.films:
        torch.save(films, args.films)
    if args.against:
        other = torch.load(args.against, weights_only=False)
        for name, film in films.items():
            if name in other:
                same = float((film == other[name]).all(-1).mean())
                result['cells'][name]['bit_equal_pixels'] = same
                print(f"{args.label} {name}: pixels bit-equal to "
                      f"{args.against}: {same:.6f}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)


if __name__ == '__main__':
    main()
