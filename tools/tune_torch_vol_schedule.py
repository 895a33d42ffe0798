"""Time kernels K8 and K9 (csrc/volpath_kernels.cu,
csrc/volpath_grid_kernels.cu) at the main path's shapes on one CUDA GPU,
under several warp schedules and launch shapes.

usage, from the repository root: python3 tools/tune_torch_vol_schedule.py
    [--track-min 24 16 8] [--k8 128:8 128:5 128:10]
    [--k9 128:10 128:4 128:8] [--out PATH]

- K9's warp schedule: the package's kernel is plain flattening (every loop
  iteration runs every stage that holds a lane). A value T of --track-min
  builds a copy of its source with the while-while pattern patched in: an
  iteration runs the tracking step alone while at least T lanes of the
  warp track, else every stage that holds a lane. Each schedule is timed
  by CUDA events on 'hetvol' and 'hetvol_hg' at 768x576 x 32 spp (one
  launch, its film sum included) and counted (its SIMT counters: the share
  of a warp's lanes that work in each stage's passes).
- Launch shapes: a variant T:M of --k8 or --k9 builds a copy of that
  kernel's source with T threads a block (`kThreads`) and at least M
  blocks an SM (`kMinBlocks`, the second argument of `__launch_bounds__`,
  which caps the registers a thread may take); K8 variants are timed on
  'vol' and 'vol_hg' at 512x512 x 64 spp, K9 variants on 'hetvol' and
  'hetvol_hg' at 32 spp.
All copies are built by nvcc at once into build/lajolla_tpu_torch/tune/
with the flags of kernels.py, their ptxas lines printed. Every K9
variant's and every schedule's film must equal the package build's, bit
for bit (neither changes what a path computes); a K8 variant's share of
bit-equal pixels is printed (K8 is built with multiply-adds contracted,
and a launch bound may move a contraction).
Prints the times with the card's `nvidia-smi` name and power limit and,
given --out, writes them there as JSON. Imports no JAX.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

THREADS = 'constexpr int kThreads = 128;'
MIN_BLOCKS = re.compile(r'constexpr int kMinBlocks = \d+;')
UNITS = {'k8': 'volpath_kernels', 'k9': 'volpath_grid_kernels',
         'ww': 'volpath_grid_kernels'}
# K9's stage tests and its loop-pass line, where while_while patches in
# the schedule
STAGE_TESTS = re.compile(
    r'(cnt\.pass\(stats, [26], |if \()stage == (kCast|kVertex)\)')
LOOP_PASS = '    cnt.pass(stats, 0, live);\n'


def while_while(src, track_min):
    """K9's source with the cast and vertex stages held back while at
    least track_min lanes of the warp track (warp-uniform). track_min < 1
    would hold them back for good in a warp with no tracking lane."""
    if track_min < 1:
        raise ValueError(f"track_min {track_min}: at least 1")
    text, k = STAGE_TESTS.subn(r'\1run_all && stage == \2)', src)
    if k != 4 or text.count(LOOP_PASS) != 1:
        raise RuntimeError("K9's four stage tests or its loop-pass line not "
                           "found")
    return text.replace(LOOP_PASS, LOOP_PASS + (
        '    const bool run_all = __popc(__ballot_sync(kFullMask, '
        f'stage == kTrack)) < {track_min};\n'))


def variant_source(key, v, src):
    """The source of variant v of a --k8 / --k9 launch shape or a
    --track-min schedule ('ww')."""
    if key == 'ww':
        return while_while(src, int(v))
    threads, _, blocks = v.partition(':')
    return MIN_BLOCKS.sub(f'constexpr int kMinBlocks = {blocks};',
                          src.replace(THREADS, 'constexpr int '
                                      f'kThreads = {threads};'))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--track-min', nargs='*', default=['24', '16', '8'])
    ap.add_argument('--k8', nargs='*', default=['128:8', '128:5', '128:10'])
    ap.add_argument('--k9', nargs='*', default=['128:10', '128:4', '128:8'])
    ap.add_argument('--out')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("tune_torch_vol_schedule: needs one CUDA GPU")
    from chip_smoke import cuda_ms, ptxas_summary, simt
    from lajolla_tpu_torch import kernels
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import volpath_grid_kernel as PGK
    from lajolla_tpu_torch.integrators import volpath_kernel as PVK
    from lajolla_tpu_torch.scene.types import RenderOptions

    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    base = kernels.build()
    opts = RenderOptions(integrator='volpath')
    out = {'card': card}

    # ---- the variants' builds, all at once
    tune = kernels.BUILD_DIR / 'tune'
    tune.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for key, unit in UNITS.items():
        src = (kernels._CSRC / f'{unit}.cu').read_text()
        if THREADS not in src or len(MIN_BLOCKS.findall(src)) != 1:
            raise RuntimeError(f"'{THREADS}' or one kMinBlocks line not in "
                               f"{unit}.cu")
        for v in getattr(args, 'track_min' if key == 'ww' else key):
            text = variant_source(key, v, src)
            tag = f"{unit}_{key}{v.replace(':', 'm')}"
            cu = tune / f'{tag}.cu'
            cu.write_text(text)
            so = tune / f'lib{tag}.so'
            log = open(tune / f'build_{tag}.log', 'w')
            # the package's headers through -I
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS,
                   *kernels.UNIT_FLAGS.get(unit, ()), '-I', str(kernels._CSRC),
                   '-o', str(so), str(cu)]
            jobs[(key, v)] = (so, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT))
    variants = {}
    for (key, v), (so, log, proc) in jobs.items():
        log.close()
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc for {key} {v} failed: "
                               f"{open(log.name).read()[-4000:]}")
        print(f"{key} {v}: {ptxas_summary(open(log.name).read())}",
              flush=True)
        libs = dict(base)
        libs[UNITS[key]] = ctypes.CDLL(str(so))
        kernels._bind(libs)
        variants[(key, v)] = libs
    kernels._bind(base)

    def timed(fn, reps):
        return cuda_ms(torch, fn, reps)

    # ---- K9's schedules
    het = {v: PT.make_cornell_box((768, 576), 1, v).to(dev)
           for v in ('hetvol', 'hetvol_hg')}
    want9 = {v: PGK.render_fused_grid(s, opts, 0, 0, 4)
             for v, s in het.items()}
    rows = {}
    schedules = [('flat', base)] + [(f'while-while {v}', variants[('ww', v)])
                                    for v in args.track_min]
    for label, libs in schedules:
        with mock.patch.object(kernels, '_libs', libs):
            for v, scene in het.items():
                got = PGK.render_fused_grid(scene, opts, 0, 0, 4)
                if not torch.equal(got, want9[v]):
                    raise AssertionError(f"schedule {label}: {v} film "
                                         "differs")
                ms = timed(lambda: PGK.render_fused_grid(scene, opts, 0, 0,
                                                         32), 3)
                cnt = {}
                PGK.render_fused_grid(scene, opts, 0, 0, 32, counters=cnt)
                eff = {stage: simt(cnt, p, lanes) for stage, p, lanes in (
                    ('loop', 'iterations', 'path_lanes'),
                    ('casts', 'cast_passes', 'casts'),
                    ('track_steps', 'track_passes', 'track_steps'),
                    ('vertices', 'vertex_passes', 'vertices'))}
                rows[f'{v} {label}'] = dict(ms=ms, simt=eff, counters=cnt)
                print(f"K9 {v} 768x576 x 32 spp, schedule {label}: "
                      f"{ms:.3f} ms, SIMT efficiency by stage {eff}; {card}",
                      flush=True)
    out['k9_schedules'] = rows

    # ---- launch shapes
    vol = {v: PT.make_cornell_box(512, 1, v).to(dev)
           for v in ('vol', 'vol_hg')}
    want8 = {v: PVK.render_fused_vol(s, opts, 0, 0, 4)
             for v, s in vol.items()}
    shapes = {}
    for (key, v), libs in variants.items():
        if key == 'ww':
            continue
        cells = vol if key == 'k8' else het
        with mock.patch.object(kernels, '_libs', libs):
            for name, scene in cells.items():
                if key == 'k8':
                    got = PVK.render_fused_vol(scene, opts, 0, 0, 4)
                    # K8 is built with multiply-adds contracted: a launch
                    # bound may move a contraction, so its share is shown
                    same = float((got == want8[name]).all(-1).float().mean())
                    ms = timed(lambda: PVK.render_fused_vol(
                        scene, opts, 0, 0, 64), 5)
                else:
                    got = PGK.render_fused_grid(scene, opts, 0, 0, 4)
                    if not torch.equal(got, want9[name]):
                        raise AssertionError(f"{key} {v}: {name} film "
                                             "differs")
                    same = 1.0
                    ms = timed(lambda: PGK.render_fused_grid(
                        scene, opts, 0, 0, 32), 3)
                shapes[f'{key} {v} {name}'] = dict(ms=ms, bit_equal=same)
                print(f"{key.upper()} variant {v} (threads:min blocks), "
                      f"{name}: {ms:.3f} ms a main-path launch, pixels "
                      f"bit-equal to the package build {same:.6f}; {card}",
                      flush=True)
    out['launch_shapes_ms'] = shapes
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)


if __name__ == '__main__':
    main()
