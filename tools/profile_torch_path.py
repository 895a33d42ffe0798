"""Measure lajolla_tpu_torch's fused path kernel K1 on one CUDA GPU at the
main path's shape: the Cornell box at 512x512 x 256 spp (cbox-512, one K1
launch), and, with --k4, the resolve K4 on the casts of one bigmesh-683
render. Runs unchanged from an older tree of the repository (a `git
archive` copy), so that one chip call can time two trees in turns.

usage, from the root of the tree to measure:
    python3 tools/profile_torch_path.py [--runs 5] [--label new]
        [--out chiprun_out/profile_torch_path.json]
        [--films PATH] [--against PATH] [--k4]
        [--variants] [--bounds 1 6 10] [--flat] [--mapping row tile]
        [--flat-bounds 1 8]
    python3 tools/profile_torch_path.py --proxies [--res 64] [--spp 256]

Prints, and writes as JSON to --out:
- the card's `nvidia-smi` name and power limit;
- render() Mpaths/s of cbox-512 over --runs warm runs (wall time, host
  clock), and a torch.profiler trace (CUDA activity only) of one such
  render(): wall, device-busy time (the union of kernel and copy
  intervals), the idle share 1 - busy / wall, device time by name;
- K1 by CUDA events, one launch through its wrapper (the film sum
  included where the tree has one), at 512x512 x 256 and x 4 spp; where
  the tree's K1 has SIMT counters (kernels.PATH_COUNTERS), those of the
  256-spp launch and the share of a warp's lanes that advance a vertex in
  its loop iterations;
- --films PATH: K1's films (256 and 4 spp) saved there (torch.save);
  --against PATH: the share of their pixels bit-equal to the films saved
  at PATH by another tree's run;
- --k4: K4 on the closest-hit casts of one render() of bigmesh-683 (the
  mesh Cornell box of ~56k triangles at 683x512 x 2 spp): every cast's
  rays are kept, sorted and listed as the cast does and swept by K5; K4
  runs once on each cast's K5 hits under torch.profiler, its device time
  per launch read from the trace (mean, median, largest, and the mean
  times the render's casts: a launch of 8192 rays is shorter than the
  host's time to issue one, so CUDA events around back-to-back launches
  would time the host; the trace may miss a launch, 482 of 484 were seen
  on the H100), and each launch's (prim, u, v) is held bit for bit
  against its plain form;
- --variants (this tree's source only): copies of csrc/path_kernels.cu
  built by nvcc at once into build/lajolla_tpu_torch/tune/ with the flags
  of kernels.py, their ptxas lines printed, each timed at 512x512 x 256
  spp in turns with the package's build (package, variant, variant,
  package), its film held bit for bit against the package's, its SIMT
  counters read: --bounds M builds K1 with at least M blocks of 128
  threads an SM (`kFusedMinBlocks`, the second launch bound, which caps
  its registers); --mapping tile hands K1's items out in 8x4 tiles of
  pixels (a sample's queue positions permuted tile by tile) in place of
  id order, whose first 32 fill a warp with 32 pixels of a row;
  --flat appends the design the package did not take:
  one flat vertex loop a pixel, lane == pixel, its film summed in
  registers (no per-item buffer), with warps of 32 consecutive pixels of
  a row or of 8x4 tiles (--mapping), at each of --flat-bounds;
- --proxies (runs on the CPU where no card is found; nothing else runs):
  the plain form's per-lane, per-sample vertex counts of the Cornell box
  at --res x --res x --spp, and from them 32-lane lockstep proxies (the
  vertices the lanes advanced over 32 x the vertices a warp steps
  through) of nested sample and vertex loops (a warp steps through its
  longest path of every sample) and of one flat loop a pixel (through
  its lane with the most vertices over all samples), for the row and the
  tile mapping.
Imports no JAX.
"""

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RES, SPP = 512, 256
BIGMESH = ((683, 512), 2, 56000)   # film, spp, triangles asked

# The second launch bound of the package's K1 (and of the flat loop
# appended to its copies), which a --bounds variant replaces.
MIN_BLOCKS = re.compile(r'constexpr int kFusedMinBlocks = \d+;')

# The body of the flat loop's pixel -> thread map: a warp takes 32
# consecutive pixels of a row, or an 8x4 tile (films of whole tiles:
# w % 8 == h % 4 == 0).
PIXEL_MAPS = {
    'row': 'return t;',
    'tile': ('const int warp = t >> 5, l = t & 31, tiles_x = w >> 3;\n'
             '  return ((warp / tiles_x) * 4 + (l >> 3)) * w +\n'
             '         (warp % tiles_x) * 8 + (l & 7);'),
}

# The package's K1 with its items handed out tile by tile (--mapping tile):
# queue position c takes the item of sample c / n at pixel
# tile_order(c % n), a permutation of the film's pixels.
TILE_ORDER_AT = ('template <int MATS, bool QUADS, bool SPH>\n'
                 '__global__ void __launch_bounds__(kThreads, kFusedMinBlocks)'
                 '\nrender_fused_kernel(')
TILE_ORDER_FN = (
    '__device__ __forceinline__ long long tile_order(long long p, int w) {\n'
    '  const long long warp = p >> 5, l = p & 31, tiles_x = w >> 3;\n'
    '  return ((warp / tiles_x) * 4 + (l >> 3)) * w + (warp % tiles_x) * 8 +'
    '\n         (l & 7);\n}\n\n')
TILE_ORDER_FETCH = ('c = mine;',
                    'c = (mine / n) * n + tile_order(mine % n, w);')

# K1 as one flat vertex loop a pixel (lane == pixel, as the TPU kernel has
# it), for --flat: each thread runs its pixel's nspp samples in one loop
# that advances one vertex an iteration and, where a path ends, adds its
# radiance to the pixel's sum in registers and starts the next sample; a
# thread whose samples are done idles until its warp is done. Appended to
# a copy of path_kernels.cu, whose kernel pieces it uses; PIXEL_MAP is
# replaced by a body of PIXEL_MAPS.
FLAT_KERNEL = r'''
namespace {

__device__ __forceinline__ int flat_pixel_of(int t, int w) {
  PIXEL_MAP
}

template <int MATS, bool QUADS, bool SPH>
__global__ void __launch_bounds__(kThreads, kFusedMinBlocks)
render_flat_kernel(lj::Tables tb, Camera cam, int n, int w, uint32_t su,
                   long long s0, int nspp, float* __restrict__ film,
                   unsigned long long* __restrict__ stats) {
  using namespace lj;
  __shared__ SimtCounts<kWarps, kFusedStats> cnt;
  cnt.zero(stats);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int pixel = t < n ? flat_pixel_of(t, w) : 0;
  const float px = (float)(pixel % w), py = (float)(pixel / w);
  const long long end = s0 + nspp;
  long long k = s0;
  bool busy = t < n && nspp > 0;
  int nv = 2;
  Lane st;
  if (busy) {
    primary(cam, su, pixel + k * n, px, py, st.o, st.d);
    st.prev = st.o;
    st.thr = v3(1.0f, 1.0f, 1.0f);
    st.rad = v3(0.0f, 0.0f, 0.0f);
    st.dir_pdf = 0.0f;
  }
  V3 acc = v3(0.0f, 0.0f, 0.0f);
  while (__ballot_sync(kFullMask, busy) != 0u) {
    cnt.pass(stats, 0, busy);
    if (busy) {
      const long long item = pixel + k * n;
      float un[8];
      vertex_uniforms(su, item, nv, un);
      if (advance_vertex<MATS, QUADS, SPH>(tb, st, (float)nv, un, true)) {
        st.prev = st.o;
        ++nv;
      } else {
        if (isfinite(st.rad.x) && isfinite(st.rad.y) && isfinite(st.rad.z)) {
          acc.x += st.rad.x;
          acc.y += st.rad.y;
          acc.z += st.rad.z;
        }
        if (++k < end) {
          primary(cam, su, item + n, px, py, st.o, st.d);
          st.prev = st.o;
          st.thr = v3(1.0f, 1.0f, 1.0f);
          st.rad = v3(0.0f, 0.0f, 0.0f);
          st.dir_pdf = 0.0f;
          nv = 2;
        } else {
          busy = false;
        }
      }
    }
  }
  cnt.flush(stats);
  if (t < n) {
    film[pixel] = acc.x;
    film[n + pixel] = acc.y;
    film[2 * (long long)n + pixel] = acc.z;
  }
}

}  // namespace

extern "C" int lj_render_fused_flat(
    const lj::Tables* tb, const lj::Camera* cam, int mats, int quads,
    int sph, int n, int w, uint32_t su, long long s0, int nspp, float* film,
    unsigned long long* stats, void* stream) {
  if (n <= 0 || nspp <= 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch(mats, quads, sph, [&](auto M, auto Q, auto S) {
    render_flat_kernel<decltype(M)::value, decltype(Q)::value,
                       decltype(S)::value>
        <<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            *tb, *cam, n, w, su, s0, nspp, film, stats);
    return cudaGetLastError();
  });
}
'''


def bit_equal_shares(torch, films, path):
    """{name: share of pixels equal in all channels} against the films
    saved at `path`."""
    other = torch.load(path)
    return {k: float((v == other[k]).all(dim=-1).float().mean())
            for k, v in films.items() if k in other}


def lockstep_proxies(torch, counts, w, h):
    """32-lane lockstep proxies of (spp, n) per-lane, per-sample vertex
    counts of a w x h film: {mapping: {'nested': ..., 'flat': ...}} for
    warps of 32 consecutive pixels ('row') and of 8x4 tiles ('tile')."""
    spp = counts.shape[0]
    c = counts.double().reshape(spp, h, w)
    tiles = c.reshape(spp, h // 4, 4, w // 8, 8).permute(0, 1, 3, 2, 4)
    out = {}
    for name, lanes in (('row', c.reshape(spp, -1, 32)),
                        ('tile', tiles.reshape(spp, -1, 32))):
        work = float(lanes.sum())
        out[name] = dict(
            nested=work / (32 * float(lanes.amax(dim=2).sum())),
            flat=work / (32 * float(lanes.sum(dim=0).amax(dim=1).sum())))
    return out


def proxies(args):
    """--proxies: the plain form's vertex counts and their proxies."""
    import torch

    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import path as PP
    from lajolla_tpu_torch.integrators import path_kernel as PK
    from lajolla_tpu_torch.scene.types import RenderOptions

    dev = torch.device('cuda' if torch.cuda.is_available() else 'cpu')
    res, spp = args.res, args.spp
    n = res * res
    scene = PT.make_cornell_box(res).to(dev)
    counts = torch.zeros((spp, n), dtype=torch.int64, device=dev)
    sample = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lane = torch.arange(n, device=dev)

    def counting(scene_, options_, *a):   # a[4]: nv, a[8]: the active lanes
        act = a[8]
        sample.add_((act & (a[4] == 2)).to(torch.int64))
        counts.index_put_((sample[act], lane[act]),
                          torch.ones_like(lane[act]), accumulate=True)
        return PK.advance_plain_t(scene_, options_, *a)
    t0 = time.perf_counter()
    PP._render_block_kernel(scene, RenderOptions(), 0, 0, spp,
                            advance=counting)
    seconds = time.perf_counter() - t0
    c = counts.cpu()
    out = dict(device=str(dev), res=res, spp=spp, seconds=seconds,
               vertices_per_path=float(c.sum()) / (n * spp),
               longest_path=int(c.max()),
               proxies=lockstep_proxies(torch, c, res, res))
    print(f"plain-form lockstep proxies, Cornell box {res}x{res} x {spp} "
          f"spp (on {dev}, {seconds:.1f} s): {out}", flush=True)
    return out


def build_variants(kernels, sources):
    """{name: libs} of copies of path_kernels.cu ({name: source}), built
    by nvcc at once and bound as kernels.py binds the package's."""
    from chip_smoke import ptxas_summary
    tune = kernels.BUILD_DIR / 'tune'
    tune.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        cu = tune / f'path_kernels_{name}.cu'
        cu.write_text(text)
        so = tune / f'libpath_kernels_{name}.so'
        log = open(tune / f'build_path_kernels_{name}.log', 'w')
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS,
               *kernels.UNIT_FLAGS.get('path_kernels', ()), '-I',
               str(kernels._CSRC), '-o', str(so), str(cu)]
        jobs[name] = (so, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT))
    base = kernels.build()
    built = {}
    for name, (so, log, proc) in jobs.items():
        rc = proc.wait()
        log.close()
        text = open(log.name).read()
        if rc != 0:
            raise RuntimeError(f"nvcc for variant {name} failed: "
                               f"{text[-4000:]}")
        print(f"variant {name}: {ptxas_summary(text)}", flush=True)
        libs = dict(base)
        libs['path_kernels'] = ctypes.CDLL(str(so))
        kernels._bind(libs)
        built[name] = libs
    kernels._bind(base)
    return built


def flat_render(torch, kernels, lib, scene, options, nspp, counters=None):
    """The --flat design's film (h, w, 3) of samples 0..nspp."""
    from lajolla_tpu_torch.integrators.path import MAX_BOUNCES_CAP
    from lajolla_tpu_torch.integrators.path_kernel import statics
    from lajolla_tpu_torch.scene.camera import camera_record
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    device, tb, mats, quads, sph = kernels._scene_args(
        scene, **statics(scene, options, MAX_BOUNCES_CAP))
    camera = kernels._camera(camera_record(scene), w, h, options.filter_type,
                             options.filter_param)
    film = torch.empty((3, n), dtype=torch.float32, device=device)
    cnt, cnt_ptr = kernels._counters(counters, kernels.PATH_COUNTERS, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.lj_render_fused_flat(
        ctypes.byref(tb), ctypes.byref(camera), mats, quads, sph, n, w, 0, 0,
        nspp, film.data_ptr(), cnt_ptr, stream)
    if rc != 0:
        raise RuntimeError(f"render_flat_kernel launch: CUDA error {rc}")
    kernels._read_counters(counters, cnt, kernels.PATH_COUNTERS)
    return film.T.reshape(h, w, 3)


def variants(args, torch, kernels, cbox, options, card, tag):
    """--variants: each copy timed in turns with the package's K1."""
    from chip_smoke import cuda_ms, simt
    from lajolla_tpu_torch.integrators import path_megakernel as PMK
    src = (kernels._CSRC / 'path_kernels.cu').read_text()
    if len(MIN_BLOCKS.findall(src)) != 1:
        raise RuntimeError("this tree's K1 has no kFusedMinBlocks line")
    package_bound = int(MIN_BLOCKS.search(src).group(0).split()[-1][:-1])

    def bounded(b):
        return MIN_BLOCKS.sub(f'constexpr int kFusedMinBlocks = {b};', src)
    sources = {f'b{b}': bounded(b) for b in args.bounds
               if b != package_bound}
    if 'tile' in args.mapping:
        if src.count(TILE_ORDER_AT) != 1 or \
                src.count(TILE_ORDER_FETCH[0]) != 1:
            raise RuntimeError("K1's kernel head or its fetch line not found")
        sources['tile_order'] = src.replace(
            TILE_ORDER_AT, TILE_ORDER_FN + TILE_ORDER_AT).replace(
            *TILE_ORDER_FETCH)
    if args.flat:
        for m in args.mapping:
            for b in args.flat_bounds:
                sources[f'flat_{m}_b{b}'] = bounded(b) + FLAT_KERNEL.replace(
                    'PIXEL_MAP', PIXEL_MAPS[m])
    built = build_variants(kernels, sources)
    want = PMK.render_fused(cbox, options, 0, 0, SPP)
    rows = {}

    def package():
        return cuda_ms(torch, lambda: PMK.render_fused(
            cbox, options, 0, 0, SPP), args.reps)
    for name, libs in built.items():
        row = {'package_ms': [package()]}
        cnt = {}
        if name.startswith('flat'):
            flib = libs['path_kernels']
            flib.lj_render_fused_flat.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
                ctypes.c_uint32, ctypes.c_longlong, ctypes.c_int] + \
                [ctypes.c_void_p] * 3
            flib.lj_render_fused_flat.restype = ctypes.c_int

            def run(counters=None):
                return flat_render(torch, kernels, flib, cbox, options, SPP,
                                   counters)
        else:
            def run(counters=None):
                with mock.patch.object(kernels, '_libs', libs):
                    return PMK.render_fused(cbox, options, 0, 0, SPP,
                                            counters=counters)
        got = run()
        run(cnt)
        row['ms'] = [cuda_ms(torch, run, args.reps),
                     cuda_ms(torch, run, args.reps)]
        row['package_ms'].append(package())
        row['bit_equal_pixels'] = float((got == want).all(-1).float().mean())
        row['counters'] = cnt
        row['simt_efficiency'] = simt(cnt, 'iterations', 'path_lanes')
        rows[name] = row
        print(f"{tag}variant {name}, cbox 512x512 x {SPP} spp: "
              f"{row['ms']} ms against the package's {row['package_ms']} "
              f"ms (package, variant, variant, package); SIMT efficiency "
              f"{row['simt_efficiency']:.4f}; pixels bit-equal to the "
              f"package's {row['bit_equal_pixels']:.6f}; {card}", flush=True)
    return rows


def device_ms(torch, fn, name):
    """The device time (ms) of each kernel whose name holds `name` that
    fn() launches, from a torch.profiler trace of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.time_range.end - e.time_range.start) / 1e3
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and name in e.name]


def k4_on_render(torch, kernels, dev, card, tag):
    """--k4: K4 on the closest-hit casts of one bigmesh-683 render()."""
    from lajolla_tpu_torch import render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.ops import intersect_sweep as SW
    from lajolla_tpu_torch.ops.intersect import ray_bounds
    from lajolla_tpu_torch.scene import geometry as PG
    from lajolla_tpu_torch.scene.types import RenderOptions

    (w, h), spp, tris = BIGMESH
    scene = PT.make_cornell_box((w, h), spp, 'mesh', triangles=tris).to(dev)
    casts = []
    real = SW.intersect_sweep

    def keep(scene_, o, d, tnear, tfar):
        tn, tf = ray_bounds(o, tnear, tfar)
        casts.append(tuple(x.clone() for x in (o, d, tn, tf)))
        return real(scene_, o, d, tnear, tfar)
    with mock.patch.object(PG, 'intersect_sweep', keep):
        render(scene, RenderOptions(samples_per_pixel=spp), device=dev)
    torch.cuda.synchronize()
    K = scene.sw_aabb.shape[0]
    inputs, hits = [], 0
    for ray in casts:
        perm = torch.argsort(SW._sort_keys(scene, *ray[:2]), stable=True)
        ray = tuple(x[perm].contiguous() for x in ray)
        args = SW.list_inputs(scene, *ray, SW.LIST_B, min(SW.LIST_LEN, K))
        t, kid = kernels.sweep_resident(args[0], scene.sw_lane,
                                        scene.sw_aabb, *args[1:], False)
        rays = torch.cat([args[0][:, :7], t[:, None]], dim=1).contiguous()
        got = kernels.sweep_resolve(rays, kid, scene.sw_lane)
        want = SW.sweep_resolve_plain(rays, kid, scene.sw_lane)
        if not all(bool(torch.equal(a, b)) for a, b in zip(got, want)):
            raise AssertionError("K4 differs from its plain form on a cast "
                                 "of the render")
        inputs.append((rays, kid))
        hits += int((kid >= 0).sum())
    ms = device_ms(torch, lambda: [kernels.sweep_resolve(
        rays, kid, scene.sw_lane) for rays, kid in inputs],
        'sweep_resolve_kernel')
    if not ms:
        raise AssertionError("the trace holds no K4 launch")
    out = dict(casts=len(casts), rays_per_cast=casts[0][0].shape[0],
               hit_share=hits / sum(x[0].shape[0] for x in casts),
               traced=len(ms), ms_mean=statistics.mean(ms),
               ms_median=statistics.median(ms), ms_max=max(ms),
               ms_render=statistics.mean(ms) * len(casts))
    print(f"{tag}K4 on the {len(casts)} closest-hit casts of one bigmesh-683"
          f" render() ({out['rays_per_cast']} rays each, hits "
          f"{out['hit_share']:.3f}; every launch bit-equal to its plain "
          f"form): device time per launch ({len(ms)} in the trace) mean "
          f"{out['ms_mean']:.4f} ms, median {out['ms_median']:.4f}, largest "
          f"{out['ms_max']:.4f}; {out['ms_render']:.2f} ms a render; {card}",
          flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', type=int, default=5)
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--label', default='')
    ap.add_argument('--out', default=os.path.join(
        REPO, 'chiprun_out', 'profile_torch_path.json'))
    ap.add_argument('--films')
    ap.add_argument('--against')
    ap.add_argument('--k4', action='store_true')
    ap.add_argument('--variants', action='store_true')
    ap.add_argument('--bounds', nargs='*', type=int, default=[1, 6, 10])
    ap.add_argument('--flat', action='store_true')
    ap.add_argument('--mapping', nargs='*', default=['row', 'tile'],
                    choices=sorted(PIXEL_MAPS))
    ap.add_argument('--flat-bounds', nargs='*', type=int, default=[1, 8])
    ap.add_argument('--proxies', action='store_true')
    ap.add_argument('--res', type=int, default=64)
    ap.add_argument('--spp', type=int, default=256)
    args = ap.parse_args()

    import torch
    out = proxies(args) if args.proxies else measure(args, torch)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)


def measure(args, torch):
    if not torch.cuda.is_available():
        sys.exit("profile_torch_path: needs one CUDA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import cuda_ms, simt
    from tools.profile_torch_general import busy_seconds
    from lajolla_tpu_torch import kernels, render
    from lajolla_tpu_torch import testing as PT
    from lajolla_tpu_torch.integrators import path_megakernel as PMK
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
    cbox = PT.make_cornell_box(RES).to(dev)
    opts = RenderOptions(samples_per_pixel=SPP)

    def timed_render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(cbox, opts, device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed_render()                                   # warm
    walls = [timed_render() for _ in range(args.runs)]
    out['render_walls_s'] = walls
    out['render_mpaths_per_s'] = [RES * RES * SPP / w / 1e6 for w in walls]
    out['render_mpaths_per_s_median'] = statistics.median(
        out['render_mpaths_per_s'])
    print(f"{tag}render() cbox 512x512 x {SPP} spp, {args.runs} warm runs: "
          f"Mpaths/s {out['render_mpaths_per_s']}; {card}", flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = timed_render()
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_seconds((e.time_range.start, e.time_range.end)
                        for e in dev_ev)
    by_name = {}
    for e in dev_ev:
        name = next((k for k in ('render_fused_kernel', 'film_sum_kernel')
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

    base = RenderOptions()
    films, k1 = {}, {}
    for nspp in (SPP, 4):
        key = f'cbox_{nspp}spp'
        films[key] = PMK.render_fused(cbox, base, 0, 0, nspp).cpu()
        k1[key] = cuda_ms(torch, lambda: PMK.render_fused(
            cbox, base, 0, 0, nspp), args.reps)
    out['k1_ms_512x512'] = k1
    print(f"{tag}K1 at 512x512, ms per launch: {k1}; {card}", flush=True)
    if hasattr(kernels, 'PATH_COUNTERS'):
        cnt = {}
        PMK.render_fused(cbox, base, 0, 0, SPP, counters=cnt)
        out['k1_counters_256spp'] = cnt
        out['k1_simt_efficiency'] = simt(cnt, 'iterations', 'path_lanes')
        print(f"{tag}K1 counters, cbox 512x512 x {SPP} spp: {cnt}; "
              f"{cnt['path_lanes'] / (RES * RES * SPP):.3f} vertices a path;"
              f" SIMT efficiency of the loop {out['k1_simt_efficiency']:.4f}",
              flush=True)
    if args.films:
        torch.save(films, args.films)
    if args.against and os.path.exists(args.against):
        out['bit_equal_pixels'] = bit_equal_shares(torch, films,
                                                   args.against)
        print(f"{tag}K1 films, share of pixels bit-equal to "
              f"{args.against}: {out['bit_equal_pixels']}", flush=True)
    if args.k4:
        out['k4_bigmesh_683'] = k4_on_render(torch, kernels, dev, card, tag)
    if args.variants:
        out['variants'] = variants(args, torch, kernels, cbox, base, card,
                                   tag)
    print(json.dumps({k: v for k, v in out.items() if k != 'trace'}))
    print(f"{tag}median render() Mpaths/s "
          f"{out['render_mpaths_per_s_median']:.2f}; {card}")
    return out


if __name__ == '__main__':
    main()
