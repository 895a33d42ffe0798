"""Time kernels K5 and K6 (csrc/sweep_kernels.cu) at several launch shapes
on one CUDA GPU: the rays a block holds, one warp each (`kSweepWarps`),
and the blocks an SM should hold at once (the second argument of
`__launch_bounds__`, which caps the registers a thread may take).

usage, from the repository root: python3 tools/tune_torch_sweep_warps.py
    [--variants 8 4 16 8:4] [--out PATH]

A variant is W or W:M, W rays a block and at least M blocks an SM. For
each it builds a copy of csrc/sweep_kernels.cu with that `kSweepWarps`
and launch bound (nvcc, the flags of kernels.NVCC_FLAGS, all builds at
once, into build/lajolla_tpu_torch/tune/, their ptxas lines printed),
loads it with ctypes and times K5 and K6, closest and any hit, by CUDA
events on:
- render shape: the rays of the closest-hit and the shadow cast of the
  sixth loop iteration of a render of `bigmesh-683` (K5, 8192 rays) and
  `hugemesh-768` (K6, 16384 rays), as chip_smoke.py [15] takes them, and
  of one loop iteration of the render's tail (CELLS);
- 2^18 rays: the bounce and shadow rays of the 56k-triangle mesh box's
  512x512 film (K5, and K6 on full-width lists), as chip_smoke.py [14].
Each variant's outputs must equal those of the package's own build (the
block size changes the launch shape and nothing a ray computes). Prints
the times with the card's `nvidia-smi` name and power limit and, given
--out, writes them there as JSON. Imports no JAX.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEFAULT = 'constexpr int kSweepWarps = 8;'
BOUNDS = '__launch_bounds__(kSweepWarps * 32)'
# name, triangles, film, spp, the casts (by loop iteration, from 0) whose
# rays are timed: an early one, and one of the tail, where lanes that ran
# out of work still cast their last ray
CELLS = (('bigmesh-683', 56000, (683, 512), 2, (5, 400)),
         ('hugemesh-768', 260000, (768, 575), 1, (5, 130)))


class _Enough(Exception):
    """Raised from inside a render once its casts have been kept."""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--variants', nargs='+', default=['8', '4', '16', '8:4'])
    ap.add_argument('--out')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("tune_torch_sweep_warps: needs one CUDA GPU")
    from chip_smoke import cuda_ms, ptxas_summary
    from lajolla_tpu_torch import kernels, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.ops import intersect_sweep as SW
    from lajolla_tpu_torch.ops.intersect import ray_bounds
    from lajolla_tpu_torch.scene import geometry as PG
    from lajolla_tpu_torch.scene.types import RenderOptions

    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kernels.build()

    src = (kernels._CSRC / 'sweep_kernels.cu').read_text()
    if DEFAULT not in src or src.count(BOUNDS) != 2:
        raise RuntimeError(f"'{DEFAULT}' or '{BOUNDS}' (twice) not in "
                           "sweep_kernels.cu")
    tune = kernels.BUILD_DIR / 'tune'
    tune.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for w in args.variants:
        warps, _, blocks = w.partition(':')
        text = src.replace(DEFAULT, f'constexpr int kSweepWarps = {warps};')
        if blocks:
            text = text.replace(BOUNDS, BOUNDS[:-1] + f', {blocks})')
        tag = w.replace(':', 'm')
        cu = tune / f'sweep_kernels_w{tag}.cu'
        cu.write_text(text)
        so = tune / f'libsweep_w{tag}.so'
        log = open(tune / f'build_w{tag}.log', 'w')
        jobs[w] = (so, log, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, '-o', str(so), str(cu)],
            stdout=log, stderr=subprocess.STDOUT))
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for w, (so, log, proc) in jobs.items():
        log.close()
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc for variant {w} failed: "
                               f"{open(log.name).read()[-4000:]}")
        print(f"variant {w}: {ptxas_summary(open(log.name).read())}",
              flush=True)
        lib = ctypes.CDLL(str(so))
        lib.lj_sweep_resident.argtypes = [P] * 6 + [I] * 6 + [P] * 3
        lib.lj_sweep_list.argtypes = [P] * 6 + [I] * 5 + [P] * 5
        lib.lj_sweep_resident.restype = lib.lj_sweep_list.restype = I
        libs[w] = lib

    def launch(lib, resident, a, lane, aabb, any_hit):
        """One launch of K5 or K6 from `lib`; returns its outputs."""
        R, B, L, _, C, ptrs = kernels._sweep_lists(a[0], lane, aabb, *a[1:],
                                                   dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if resident:
            outs = (torch.empty(R * B, device=dev),
                    torch.empty(R * B, dtype=torch.int32, device=dev))
            rc = lib.lj_sweep_resident(*ptrs, R, B, L, C, SW.GROUP,
                                       int(any_hit),
                                       *[x.data_ptr() for x in outs], stream)
        else:
            outs = kernels._hit_outputs(R * B, dev)
            rc = lib.lj_sweep_list(*ptrs, R, B, L, C, int(any_hit),
                                   *[x.data_ptr() for x in outs], stream)
        if rc != 0:
            raise RuntimeError(f"launch: CUDA error {rc}")
        return outs

    def shape_rows(label, scene, ray, resident):
        """Times of every variant on one set of rays, closest and any."""
        K = scene.sw_aabb.shape[0]
        B, L = (SW.LIST_B, min(SW.LIST_LEN, K)) if resident else \
            (SW.LANE_R, K)
        rows = {}
        for kind, r in ray.items():
            any_hit = kind == 'any'
            perm = torch.argsort(SW._sort_keys(scene, *r[:2]), stable=True)
            r = tuple(x[perm].contiguous() for x in r)
            a = SW.list_inputs(scene, *r, B, L)
            ref = (kernels.sweep_resident if resident else
                   kernels.sweep_list)(a[0], scene.sw_lane, scene.sw_aabb,
                                       *a[1:], any_hit)
            for w, lib in libs.items():
                got = launch(lib, resident, a, scene.sw_lane, scene.sw_aabb,
                             any_hit)
                if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                    raise AssertionError(f"variant {w}: {label} {kind} "
                                         "differs")
                rows[f'{kind} {w}'] = cuda_ms(torch, lambda: launch(
                    lib, resident, a, scene.sw_lane, scene.sw_aabb,
                    any_hit), 20)
            print(f"{label} ({'K5' if resident else 'K6'}, {a[0].shape[0]} "
                  f"rays), {kind}: ms by variant "
                  f"{ {w: rows[f'{kind} {w}'] for w in libs} }; {card}",
                  flush=True)
        return rows

    out = {'card': card}
    for cell, triangles, size, spp, calls in CELLS:
        scene = PT.make_cornell_box(size, spp, 'mesh',
                                    triangles=triangles).to(dev)
        casts, seen = {}, {'closest': 0, 'any': 0}

        def keep(kind, cast):
            def wrapped(scene_, o, d, tnear, tfar):
                if seen[kind] in calls:
                    casts.setdefault(seen[kind], {})[kind] = (
                        o.clone(), d.clone(), *ray_bounds(o, tnear, tfar))
                    if len(casts.get(calls[-1], ())) == 2:
                        raise _Enough
                seen[kind] += 1
                return cast(scene_, o, d, tnear, tfar)
            return wrapped
        with mock.patch.multiple(
                PG, intersect_sweep=keep('closest', SW.intersect_sweep),
                occluded_sweep=keep('any', SW.occluded_sweep)):
            try:
                render(scene, RenderOptions(samples_per_pixel=spp),
                       device=dev)
            except _Enough:
                pass
        resident = scene.sw_lane.numel() * 4 <= SW.RESIDENT_BYTES
        for call in calls:
            label = f'{cell} loop iteration {call + 1}'
            out[label] = shape_rows(label, scene, casts[call], resident)
        if cell == 'bigmesh-683':
            big = PT.make_cornell_box(512, 1, 'mesh',
                                      triangles=triangles).to(dev)
            rays = PT.general_rays(big, seed=13, device=dev)
            two18 = {'closest': rays['bounce'], 'any': rays['shadow']}
            for resident in (True, False):
                out[f"2^18 rays {'K5' if resident else 'K6'}"] = shape_rows(
                    '2^18 rays of the 56k mesh', big, two18, resident)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)


if __name__ == '__main__':
    main()
