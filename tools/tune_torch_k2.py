"""Time kernel K2 (csrc/path_kernels.cu `advance_kernel`) at its group
sizes and against variants of its source on one CUDA GPU.

usage, from the repository root: python3 tools/tune_torch_k2.py
    [--variants base minblocks7 ...] [--out PATH]

- The group size G: the package's own build, K2 forced to G = 1, 2, 4
  and 8 (`kernels.advance(..., group=G)`) on every launch of the
  per-bounce driver at cbox-96 (the Cornell box at 96x96 x 16 spp, kept
  and replayed), device time a launch.
- Variants (VARIANTS): copies of csrc/path_kernels.cu with one change
  each, built for the Cornell box's one specialisation (Lambertian,
  merged quads, no spheres; nvcc with the flags of kernels.NVCC_FLAGS,
  all builds at once, into build/lajolla_tpu_torch/tune_k2/, their ptxas
  lines printed), loaded with ctypes and timed in turns (in order, then
  in reverse) by device time a launch: at 2^18 random lanes
  (chip_smoke.py [3]), on cbox-96's launches, on a 1 spp render of a
  1920x1080 film (cbox-1080's shape) and on launches K2_REPLAY of its
  16 spp render (the full pool, its middle and its tail). Each variant's
  outputs at 2^18 must equal the base's.
Prints the times with the card's `nvidia-smi` name and power limit and,
given --out, writes them there as JSON. Imports no JAX.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# The Cornell box's specialisation only: the builds take seconds.
DISPATCH = 'cudaError_t dispatch(int mats, int quads, int sph, F f) {'
ONLY = DISPATCH + '''
  return f(std::integral_constant<int, lj::kLambertian>{}, std::true_type{},
           std::false_type{});
}
template <class F>
cudaError_t dispatch_all(int mats, int quads, int sph, F f) {'''
BOUND = '__global__ void __launch_bounds__(kThreads)\nadvance_kernel('

# name: [(text in csrc/path_kernels.cu, its replacement), ...]
VARIANTS = {
    'base': [],
    # a launch bound of 7 blocks an SM (<= 72 registers)
    'minblocks7': [(BOUND, '__global__ void __launch_bounds__(kThreads, 7)\n'
                           'advance_kernel(')],
}
# Launches of the 16 spp cbox-1080 render replayed (by index).
K2_REPLAY = (0, 40, 60, 80, 100)
LANE_KEYS = ('org', 'dir', 'thr', 'rad', 'nv', 'dir_pdf', 'prev', 'un', 'act')


def build_variants(names, kernels):
    """{name: (ctypes library, ptxas lines of K2)}, built at once."""
    src = open(os.path.join(kernels._CSRC, 'path_kernels.cu')).read()
    root = os.path.join(kernels.BUILD_DIR, 'tune_k2')
    procs = {}
    for name in names:
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(kernels._CSRC, d)
        s = src.replace(DISPATCH, ONLY, 1)
        for old, new in VARIANTS[name]:
            if old not in s:
                raise ValueError(f"variant {name}: source text not found")
            s = s.replace(old, new)
        with open(os.path.join(d, 'path_kernels.cu'), 'w') as f:
            f.write(s)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, '-o',
               os.path.join(d, 'lib.so'), os.path.join(d, 'path_kernels.cu')]
        log = open(os.path.join(d, 'build.log'), 'w')
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log, d)
    out = {}
    for name, (proc, log, d) in procs.items():
        rc = proc.wait()
        log.close()
        text = open(os.path.join(d, 'build.log')).read()
        if rc != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{text[-3000:]}")
        lib = ctypes.CDLL(os.path.join(d, 'lib.so'))
        lib.lj_advance.argtypes = ([ctypes.POINTER(kernels._Tables)] +
                                   [ctypes.c_int] * 5 + [ctypes.c_void_p] * 16)
        lib.lj_advance.restype = ctypes.c_int
        lib.lj_advance_group.argtypes = [ctypes.c_int]
        lib.lj_advance_group.restype = ctypes.c_int
        out[name] = (lib, text)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--variants', nargs='+', default=list(VARIANTS))
    ap.add_argument('--out')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("tune_torch_k2: needs one CUDA GPU")
    from chip_smoke import device_ms, ptxas_summary
    from lajolla_tpu_torch import kernels
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import path_kernel as PK
    from lajolla_tpu_torch.integrators.path import (MAX_BOUNCES_CAP,
                                                    _render_block_kernel)
    from lajolla_tpu_torch.scene.types import RenderOptions

    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    res = {'card': card}
    options = RenderOptions()

    def keep_calls(scene, spp, which=None):
        calls = []

        def keep(scene_, options_, *a):
            if which is None or len(calls) in which:
                calls.append((scene_, options_, *(
                    x.clone() if torch.is_tensor(x) else x for x in a)))
            else:
                calls.append(None)
            return PK.advance_kernel_t(scene_, options_, *a)
        _render_block_kernel(scene, options, 0, 0, spp, advance=keep)
        return [c for c in calls if c is not None]

    # ---- the group size, in the package's own build
    kernels.build()
    cbox96 = PT.make_cornell_box(96).to(dev)
    calls96 = keep_calls(cbox96, 16)
    st = PK.statics(cbox96, options, MAX_BOUNCES_CAP)
    res['group_us'] = {}
    for g in (1, 2, 4, 8):
        fn = lambda: [kernels.advance(c[0], *c[2:6], c[6].float(), *c[7:11],
                                      group=g, **st) for c in calls96]
        res['group_us'][g] = [1e3 * device_ms(torch, fn, 2, 'advance_kernel')
                              for _ in range(3)]
    print(f"K2 at cbox-96's shape by G (its choice: "
          f"{kernels.advance_group(96 * 96)}), us a launch: "
          f"{res['group_us']}; {card}", flush=True)

    # ---- variants of the source, in turns
    libs = build_variants(args.variants, kernels)
    for name, (_, text) in libs.items():
        print(f"{name}: {ptxas_summary(text)}", flush=True)
    cbox = PT.make_cornell_box(512).to(dev)
    lanes = PT.random_lanes(cbox, 1 << 18, 12)
    args18 = [torch.from_numpy(lanes[k]).to(dev) for k in LANE_KEYS]
    cbox1080 = PT.make_cornell_box((1920, 1080)).to(dev)
    with mock.patch.object(kernels, 'build', lambda: {
            'path_kernels': libs[args.variants[0]][0]}):
        calls1080 = keep_calls(cbox1080, 16, K2_REPLAY)
    times = {n: {} for n in args.variants}
    want = None
    for order in (args.variants, args.variants[::-1]):
        for name in order:
            with mock.patch.object(kernels, 'build',
                                   lambda: {'path_kernels': libs[name][0]}):
                fn = lambda: PK.advance_kernel_t(cbox, options, *args18,
                                                 MAX_BOUNCES_CAP)
                out = fn()
                got = [x.cpu() for x in out[:5]] + [out[6].cpu()]
                want = want or got
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name}: outputs differ")
                t = times[name]
                t.setdefault('2^18', []).append(
                    1e3 * device_ms(torch, fn, 10, 'advance_kernel'))
                t.setdefault('cbox-96', []).append(1e3 * device_ms(
                    torch, lambda: [PK.advance_kernel_t(*c) for c in calls96],
                    2, 'advance_kernel'))
                t.setdefault('cbox-1080 1 spp', []).append(1e3 * device_ms(
                    torch, lambda: _render_block_kernel(cbox1080, options, 0,
                                                        0, 1), 1,
                    'advance_kernel'))
                for k, c in zip(K2_REPLAY, calls1080):
                    t.setdefault(f'cbox-1080 launch {k}', []).append(
                        1e3 * device_ms(torch, lambda: PK.advance_kernel_t(*c),
                                        3, 'advance_kernel'))
            print(f"{name}: " + ', '.join(f"{k} {v[-1]:.2f}"
                                           for k, v in t.items()) +
                  f" us a launch; {card}", flush=True)
    res['variants_us'] = times
    res['cbox1080_active'] = {k: int(c[10].sum())
                              for k, c in zip(K2_REPLAY, calls1080)}
    print(json.dumps(res))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(res, f, indent=1)


if __name__ == '__main__':
    main()
