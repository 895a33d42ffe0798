"""Command-line interface, mirroring the reference binary
(src/main.cpp:11-49): `python -m lajolla_tpu_torch.cli [-o out]
[--device cuda] scene.xml...`.

The reference's `-t num_threads` becomes a no-op accepted for
compatibility (parallelism is the GPU kernel here).
"""

import argparse
import dataclasses
import os
import sys
import time

from lajolla_tpu_torch.io.image import imwrite
from lajolla_tpu_torch.render import render
from lajolla_tpu_torch.scene.parser import parse_scene


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lajolla_tpu_torch")
    ap.add_argument("scenes", nargs="+", help="Mitsuba XML scene files")
    ap.add_argument("-o", "--output", default=None,
                    help="output file (.exr/.pfm); default from scene")
    ap.add_argument("-t", "--threads", type=int, default=None,
                    help="accepted for CLI compatibility; unused")
    ap.add_argument("--spp", type=int, default=None,
                    help="override samples per pixel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file; resumes an interrupted render")
    ap.add_argument("--progress", action="store_true",
                    help="print per-block progress")
    args = ap.parse_args(argv)

    for scene_file in args.scenes:
        if not os.path.isfile(scene_file):
            ap.error(f"scene file not found: {scene_file}")
        print(f"Parsing and constructing scene {scene_file}.")
        t0 = time.time()
        scene, options = parse_scene(scene_file)
        if args.spp is not None:
            options = dataclasses.replace(options,
                                          samples_per_pixel=args.spp)
        print(f"Done. Took {time.time() - t0:.5f} seconds.")
        print("Rendering...")
        t0 = time.time()
        img = render(scene, options, device=args.device, seed=args.seed,
                     checkpoint=args.checkpoint, progress=args.progress)
        print(f"Done. Took {time.time() - t0:.5f} seconds.")
        out = args.output or options.output_filename
        imwrite(out, img)
        print(f"Image written to {out}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
