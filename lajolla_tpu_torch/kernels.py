"""Build and bind the CUDA kernels (nvcc into shared libraries + ctypes).

At first use, `build()` compiles each csrc/*.cu for sm_90a into its own
library under build/lajolla_tpu_torch/ next to the package, all nvcc
processes started together, and loads them with ctypes. Each library is
keyed on its own tag (`unit_tag`): a hash of its .cu, the csrc headers it
includes and its nvcc flags, so an edit rebuilds only the libraries it
reaches, and a changed flag never reuses a library built without it.
Nothing here runs at import: the module imports on machines with no nvcc
and no GPU.

The wrappers check device, dtype, shape and contiguity, allocate their
outputs with torch.empty, launch on the current stream without
synchronising, raise if the launch reports a CUDA error, and count their
launches in LAUNCHES. They never fall back to the plain forms: K1, K2,
K8 and K9 take CUDA tensors only (their callers run the plain forms for
CPU tensors); K3's wrappers run the plain form for CPU tensors
themselves and launch the kernel for CUDA tensors, and so do the
wrappers of the sweep casters K4-K7 (`sweep_resolve`, `sweep_resident`,
`sweep_list`, `sweep_streaming`; plain forms in ops/intersect_sweep.py).
K9's library is built with -fmad=false (csrc/volpath_grid_kernels.cu
says why). K1, K8 and K9 run persistent warps over a work-item counter
that their wrappers zero before every launch, write a per-item buffer,
and return its film through `film_sum` (film_sum_kernel), whose wrapper
runs the plain form for CPU tensors itself. K1 splits its samples into
launches whose buffer stays within PATH_BUFFER_BYTES, each summed onto
the film of the samples before it. K1 and K8 copy the rows that their cast
and light scans walk into each block's shared memory at the start of a
launch (csrc/path_advance.cuh stage_rows).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

from lajolla_tpu_torch.utils import profiling

_CSRC = Path(__file__).resolve().parent / 'csrc'
_UNITS = ('path_kernels', 'intersect_kernels', 'volpath_kernels',
          'volpath_grid_kernels', 'sweep_kernels')  # one library per .cu
BUILD_DIR = Path(__file__).resolve().parent.parent / 'build' / \
    'lajolla_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
UNIT_FLAGS = {'volpath_grid_kernels': ('-fmad=false',)}

# Kernel launches by kernel name; a wrapper adds one where it launches.
LAUNCHES = {'render_fused': 0, 'advance': 0, 'intersect_brute': 0,
            'occluded_brute': 0, 'render_fused_vol': 0,
            'render_fused_grid': 0, 'sweep_resolve': 0,
            'sweep_resident': 0, 'sweep_list': 0, 'sweep_streaming': 0,
            'film_sum': 0}

# The most bytes of K1's per-item buffer (12 bytes an item): a launch of
# more items is split into launches of whole samples (`sample_chunks`).
# 512x512 x 256 spp, the main path's launch, takes 805 MB, one launch.
PATH_BUFFER_BYTES = 1 << 30

# The SIMT counters of K1, K8 and K9 (csrc/work_queue.cuh SimtCounts), in
# pairs: the passes of a warp through a stage, and the lanes that worked
# in them. K1: loop iterations with a path in some lane and those lanes
# (one vertex each). K8: the same; fetches and the lanes they served. K9: loop
# iterations and the lanes holding a path; casts; tracking steps;
# vertices; then the SM cycles the warps spent in each of those three
# stages (clock64, summed over warps).
PATH_COUNTERS = ('iterations', 'path_lanes')
VOL_COUNTERS = ('iterations', 'path_lanes', 'fetches', 'fetched_lanes')
GRID_COUNTERS = ('iterations', 'path_lanes', 'cast_passes', 'casts',
                 'track_passes', 'track_steps', 'vertex_passes', 'vertices',
                 'cast_cycles', 'track_cycles', 'vertex_cycles')

_libs = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class _Tables(ctypes.Structure):
    """lj::Tables (csrc/path_advance.cuh)."""
    _fields_ = [('woop', _P), ('woop_occ', _P), ('tri', _P),
                ('cast_src', _P), ('cast_alt', _P), ('cast_quad', _P),
                ('cast_occ_quad', _P), ('light', _P), ('stair', _P),
                ('sph', _P),
                ('tc', _I), ('t_occ', _I), ('t', _I), ('l', _I), ('s', _I),
                ('eps_isect', _F), ('eps_shadow', _F),
                ('shadow_far_scale', _F),
                ('max_depth', _I), ('rr_depth', _I), ('max_cap', _I)]


class _Camera(ctypes.Structure):
    """lj::Camera (csrc/camera.cuh)."""
    _fields_ = [('m', _F * 32), ('inv_w', _F), ('inv_h', _F),
                ('fparam', _F), ('fhalf', _F), ('ftype', _I)]


class _Medium(ctypes.Structure):
    """lj::Medium (csrc/volpath_kernels.cu): sigma_a, sigma_s, HG g."""
    _fields_ = [('sa', _F * 3), ('ss', _F * 3), ('g', _F)]


class _VolSalts(ctypes.Structure):
    """lj::VolSalts (csrc/volpath_kernels.cu): the draw-site salts of
    integrators/volpath.py."""
    _fields_ = [(k, ctypes.c_uint32) for k in ('ff', 'nee', 'nee_seg', 'phase', 'bsdf',
                                  'rr', 'surf_nee', 'it0')]


class _GridMedium(ctypes.Structure):
    """lj::GridMedium (csrc/volpath_grid_kernels.cu)."""
    _fields_ = [('pmin', _F * 3), ('pmax', _F * 3), ('res', _I * 3),
                ('gres', _I * 3), ('rows', _I), ('maxval', _F),
                ('albedo', _F * 3), ('g', _F), ('hg_a', _F), ('hg_b', _F),
                ('hg_c', _F), ('hg_d', _F), ('hg_num', _F),
                ('hg_sample', _I), ('cam_med', _I), ('max_null', _I),
                ('max_segments', _I)]


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    return os.path.join(cuda_home, 'bin', 'nvcc')


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def unit_files(unit):
    """The csrc files a unit's build reads: its .cu, then every header it
    includes (`#include "..."`, followed through headers), each once."""
    files, todo = [], [f'{unit}.cu']
    while todo:
        name = todo.pop(0)
        if name not in files:
            files.append(name)
            todo += _INCLUDE.findall((_CSRC / name).read_text())
    return files


def unit_tag(unit):
    """The build key of a unit's library: a hash of the files it reads
    and of its nvcc flags."""
    digest = hashlib.sha256()
    for name in unit_files(unit):
        digest.update(name.encode() + b'\0' + (_CSRC / name).read_bytes())
    digest.update(repr((NVCC_FLAGS, UNIT_FLAGS.get(unit, ()))).encode())
    return digest.hexdigest()[:16]


def _bind(libs):
    path, isect = libs['path_kernels'], libs['intersect_kernels']
    vol = libs['volpath_kernels']
    path.lj_render_fused.argtypes = [ctypes.POINTER(_Tables),
                                     ctypes.POINTER(_Camera), _I, _I, _I, _I,
                                     _I, ctypes.c_uint32, ctypes.c_longlong,
                                     _I, _P, _P, _P, _P]
    path.lj_render_fused.restype = _I
    path.lj_advance.argtypes = ([ctypes.POINTER(_Tables)] + [_I] * 5 +
                                [_P] * 16)
    path.lj_advance.restype = _I
    path.lj_advance_group.argtypes = [_I]
    path.lj_advance_group.restype = _I
    isect.lj_intersect_brute.argtypes = [_P, _P, _P, _P, _I, _I] + [_P] * 9
    isect.lj_intersect_brute.restype = _I
    isect.lj_occluded_brute.argtypes = [_P, _P, _I, _I] + [_P] * 6
    isect.lj_occluded_brute.restype = _I
    vol.lj_render_fused_vol.argtypes = [
        ctypes.POINTER(_Tables), ctypes.POINTER(_Camera),
        ctypes.POINTER(_Medium), ctypes.POINTER(_VolSalts), _I, _I, _I, _I,
        _I, _I, ctypes.c_uint32, ctypes.c_longlong, _I, _P, _P, _P, _P]
    vol.lj_render_fused_vol.restype = _I
    vol.lj_film_sum.argtypes = [_P, _I, ctypes.c_longlong, _I, _I, _P, _P]
    vol.lj_film_sum.restype = _I
    grid = libs['volpath_grid_kernels']
    grid.lj_render_fused_grid.argtypes = [
        ctypes.POINTER(_Tables), ctypes.POINTER(_Camera),
        ctypes.POINTER(_GridMedium), ctypes.POINTER(_VolSalts), _I, _I, _I,
        _I, _P, _P, _I, _I, ctypes.c_longlong, ctypes.c_uint32,
        ctypes.c_longlong, _I, _P, _P, _P, _P]
    grid.lj_render_fused_grid.restype = _I
    sweep = libs['sweep_kernels']
    sweep.lj_sweep_resident.argtypes = [_P] * 6 + [_I] * 6 + [_P] * 3
    sweep.lj_sweep_resolve.argtypes = [_P] * 3 + [_I] * 2 + [_P] * 4
    sweep.lj_sweep_list.argtypes = [_P] * 6 + [_I] * 5 + [_P] * 5
    sweep.lj_sweep_streaming.argtypes = [_P] * 4 + [_I] * 5 + [_P] * 5
    for fn in (sweep.lj_sweep_resident, sweep.lj_sweep_resolve,
               sweep.lj_sweep_list, sweep.lj_sweep_streaming):
        fn.restype = _I


def build():
    """Compile (the libraries whose tag has not been built yet, all nvcc
    processes at once) and load the kernels. Returns {unit: ctypes
    library}; raises if a build fails."""
    if _libs is not None:
        return _libs
    with profiling.span('kernels.build'):
        return _build()


def _build():
    global _libs
    tags = {u: unit_tag(u) for u in _UNITS}
    sos = {u: BUILD_DIR / f'liblj_{u}_{tags[u]}.so' for u in _UNITS}
    jobs = {}
    for unit, so in sos.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f'.liblj_{unit}_{tags[unit]}.{os.getpid()}.so'
        cmd = [_nvcc(), *NVCC_FLAGS, *UNIT_FLAGS.get(unit, ()), '-o',
               str(tmp), str(_CSRC / f'{unit}.cu')]
        log = BUILD_DIR / f'build_{unit}_{tags[unit]}.log'
        with open(log, 'w') as f:          # the child holds its own copy
            f.write(' '.join(cmd) + '\n')
            f.flush()
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        jobs[unit] = (tmp, log, proc)
    failed = []
    for unit, (tmp, log, proc) in jobs.items():
        if proc.wait() != 0:
            failed.append(f"nvcc {unit}.cu failed ({proc.returncode}):\n"
                          f"{log.read_text()[-6000:]}")
        else:
            os.replace(tmp, sos[unit])
    if failed:
        raise RuntimeError('\n'.join(failed))
    libs = {u: ctypes.CDLL(str(so)) for u, so in sos.items()}
    _bind(libs)
    _libs = libs
    return libs


def build_log():
    """The nvcc output (ptxas registers and spills) of the builds of the
    current tags, or '' for a library not built here."""
    logs = [BUILD_DIR / f'build_{u}_{unit_tag(u)}.log' for u in _UNITS]
    return ''.join(log.read_text() for log in logs if log.exists())


def _check(t, name, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def _scene_args(scene, eps_isect, eps_shadow, max_depth, rr_depth, max_cap):
    """(device, lj::Tables, mats bits, has_quads, has_spheres)."""
    device = scene.fp_tri.device
    if device.type != 'cuda':
        raise ValueError(f"scene tables on {device}: the kernels need CUDA")
    f32, i32 = torch.float32, torch.int32
    T = scene.fp_tri.shape[1]
    TC = scene.fp_woop.shape[0]
    T_OCC = scene.fp_woop_occ.shape[0]
    L = scene.fp_light.shape[1]
    S = scene.meta.num_spheres
    tb = _Tables(
        woop=_check(scene.fp_woop, 'fp_woop', (TC, 12), f32, device),
        woop_occ=_check(scene.fp_woop_occ, 'fp_woop_occ', (T_OCC, 12), f32,
                        device),
        tri=_check(scene.fp_tri, 'fp_tri', (40, T), f32, device),
        cast_src=_check(scene.cast_src, 'cast_src', (TC,), i32, device),
        cast_alt=_check(scene.cast_alt, 'cast_alt', (TC,), i32, device),
        cast_quad=_check(scene.cast_quad, 'cast_quad', (TC,), f32, device),
        cast_occ_quad=_check(scene.cast_occ_quad, 'cast_occ_quad', (T_OCC,),
                             f32, device),
        light=_check(scene.fp_light, 'fp_light', (16, L), f32, device),
        stair=_check(scene.tri_stair_cdf, 'tri_stair_cdf', (T,), f32, device),
        sph=_check(scene.fp_sph, 'fp_sph', (max(S, 1), 24), f32, device),
        tc=TC, t_occ=T_OCC, t=T, l=L, s=S,
        eps_isect=eps_isect, eps_shadow=eps_shadow,
        shadow_far_scale=1.0 - eps_shadow,
        max_depth=max_depth, rr_depth=rr_depth, max_cap=max_cap)
    mats = sum(1 << m for m in scene.meta.mat_types_present)
    if mats not in (1, 2, 3):
        raise ValueError(f"material set {scene.meta.mat_types_present} is "
                         "outside the kernels' Lambertian/RoughPlastic switch")
    return device, tb, mats, int(scene.meta.has_quads), int(S > 0)


def _camera(cam, w, h, filter_type, filter_param):
    """lj::Camera from the (32,) camera tensor and the film's filter."""
    cam_f = cam.detach().to('cpu', torch.float32)
    if cam_f.shape != (32,):
        raise ValueError(f"camera: shape {tuple(cam_f.shape)}, expected (32,)")
    return _Camera(m=(_F * 32)(*cam_f.tolist()), inv_w=1.0 / w,
                   inv_h=1.0 / h, fparam=filter_param,
                   fhalf=filter_param / 2.0, ftype=filter_type)


def sample_chunks(nspp, n):
    """K1's launches for nspp samples of n pixels: (first sample, samples)
    in sample order, as many samples a launch as keep its per-item buffer
    (12 bytes an item) within PATH_BUFFER_BYTES, and at least one."""
    step = max(1, min(nspp, PATH_BUFFER_BYTES // (12 * n)))
    return [(k, min(step, nspp - k)) for k in range(0, nspp, step)]


def render_fused(scene, cam, seed_u32, s0, nspp, *, w, h, filter_type,
                 filter_param, eps_isect, eps_shadow, max_depth, rr_depth,
                 max_cap, counters=None):
    """Kernel K1: the (3, w*h) film sum of samples s0..s0+nspp, its items'
    radiance summed by `film_sum`, one launch for each of `sample_chunks`
    (each chunk's sums added onto the last's, so the film is the same bit
    for bit). counters: a dict that receives the launches' SIMT counters
    (PATH_COUNTERS), summed, or None. Spans: `k1.args` (the tables'
    checks and the camera's copy to the host), `k1.launch` (a chunk's
    launch and its film sum)."""
    lib = build()['path_kernels']
    with profiling.span('k1.args'):
        device, tb, mats, quads, sph = _scene_args(
            scene, eps_isect, eps_shadow, max_depth, rr_depth, max_cap)
        camera = _camera(cam, w, h, filter_type, filter_param)
    n = w * h
    chunks = sample_chunks(nspp, n)
    out, counter = _queue(chunks[0][1] * n, device)
    cnt, cnt_ptr = _counters(counters, PATH_COUNTERS, device)
    film = None
    for k, m in chunks:
        with profiling.span('k1.launch'):
            counter.zero_()
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream(device).cuda_stream
                rc = lib.lj_render_fused(
                    ctypes.byref(tb), ctypes.byref(camera), mats, quads, sph,
                    n, w, seed_u32, s0 + k, m, counter.data_ptr(),
                    out.data_ptr(), cnt_ptr, stream)
            if rc != 0:
                raise RuntimeError(
                    f"render_fused_kernel launch: CUDA error {rc}")
            LAUNCHES['render_fused'] += 1
            film = film_sum(out, n, n, m, film)
    _read_counters(counters, cnt, PATH_COUNTERS)
    return film


def _queue(total, device):
    """A per-item buffer (total, 3) and the zeroed work-item counter of a
    persistent launch (int64, read by the kernel as uint64)."""
    return (torch.empty((total, 3), dtype=torch.float32, device=device),
            torch.zeros(1, dtype=torch.int64, device=device))


def _counters(counters, names, device):
    """A zeroed int64 tensor for a kernel's SIMT counters and its pointer,
    or (None, None) where no counters were asked for."""
    if counters is None:
        return None, None
    t = torch.zeros(len(names), dtype=torch.int64, device=device)
    return t, t.data_ptr()


def _read_counters(counters, t, names):
    if counters is not None:
        counters.update(zip(names, (int(v) for v in t.tolist())))


def render_fused_vol(scene, cam, medium, su, s0, nspp, *, w, h, filter_type,
                     filter_param, hg, eps_isect, eps_shadow, max_depth,
                     rr_depth, max_cap, counters=None):
    """Kernel K8: the (3, w*h) film sum of samples s0..s0+nspp of a scene
    inside volpath_kernel.supports, its items' radiance summed by
    `film_sum`. medium: (sigma_a (3,), sigma_s (3,), g ()) of its one
    medium; su: the pre-hashed volpath stream root; counters: a dict that
    receives the launch's SIMT counters (VOL_COUNTERS), or None. Spans:
    `k8.args` (the tables' checks, the medium, the salts and the camera's
    copy to the host), `k8.launch` (the launch and its film sum)."""
    lib = build()['volpath_kernels']
    with profiling.span('k8.args'):
        device, tb, mats, quads, sph = _scene_args(
            scene, eps_isect, eps_shadow, max_depth, rr_depth, max_cap)
        sa, ss, g = (x.detach().to('cpu', torch.float32) for x in medium)
        if sa.shape != (3,) or ss.shape != (3,) or g.shape != ():
            raise ValueError("medium: expected sigma_a (3,), sigma_s (3,), "
                             "g ()")
        med = _Medium(sa=(_F * 3)(*sa.tolist()), ss=(_F * 3)(*ss.tolist()),
                      g=float(g))
        salts = _vol_salts()
        camera = _camera(cam, w, h, filter_type, filter_param)
    n = w * h
    out, counter = _queue(nspp * n, device)
    cnt, cnt_ptr = _counters(counters, VOL_COUNTERS, device)
    with profiling.span('k8.launch'):
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.lj_render_fused_vol(
                ctypes.byref(tb), ctypes.byref(camera), ctypes.byref(med),
                ctypes.byref(salts), mats, quads, sph, int(bool(hg)), n, w,
                su, s0, nspp, counter.data_ptr(), out.data_ptr(), cnt_ptr,
                stream)
        if rc != 0:
            raise RuntimeError(
                f"render_fused_vol_kernel launch: CUDA error {rc}")
        LAUNCHES['render_fused_vol'] += 1
        film = film_sum(out, n, n, nspp)
    _read_counters(counters, cnt, VOL_COUNTERS)
    return film


def film_sum(buf, n, stride, nspp, film=None):
    """film_sum_kernel: the film (3, n) of a per-item buffer buf (at least
    nspp*stride rows of 3) of K1, K8 or K9, whose column p sums rows
    s*stride + p in sample order, dropping a sample with any non-finite
    channel; given `film` (3, n), the film of earlier samples, the sums
    start from its values and it is returned, added onto in place. CPU
    tensors run its plain form (volpath_kernel.film_sum_plain); CUDA
    tensors launch the kernel, and anything else raises."""
    if buf.device.type == 'cpu':
        from lajolla_tpu_torch.integrators.volpath_kernel import \
            film_sum_plain
        return film_sum_plain(buf, n, stride, nspp, film)
    if stride < n:
        raise ValueError(f"stride {stride} shorter than the film ({n})")
    device = buf.device
    if buf.shape[0] < nspp * stride:
        raise ValueError(f"buf: {buf.shape[0]} rows, fewer than "
                         f"{nspp * stride}")
    ptr = _check(buf[:nspp * stride], 'buf', (nspp * stride, 3),
                 torch.float32, device)
    lib = build()['volpath_kernels']
    acc = film is not None
    if acc:
        _check(film, 'film', (3, n), torch.float32, device)
    else:
        film = torch.empty((3, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lj_film_sum(ptr, n, stride, nspp, int(acc), film.data_ptr(),
                             stream)
    if rc != 0:
        raise RuntimeError(f"film_sum_kernel launch: CUDA error {rc}")
    LAUNCHES['film_sum'] += 1
    return film


def _vol_salts():
    from lajolla_tpu_torch.integrators import volpath as V
    return _VolSalts(ff=V._S_FF, nee=V._S_NEE, nee_seg=V._S_NEE_SEG,
                     phase=V._S_PHASE, bsdf=V._S_BSDF, rr=V._S_RR,
                     surf_nee=V._S_SURF_NEE, it0=V._IT0)


def render_fused_grid(scene, cam, svox2, su, s0, nspp, *, n_q, w, h,
                      filter_type, filter_param, pmin, pmax, res, gres,
                      maxval, albedo, g1, hg, max_null, eps_isect,
                      eps_shadow, max_depth, rr_depth, max_cap,
                      counters=None):
    """Kernel K9: the (3, w*h) film sum of samples s0..s0+nspp of a scene
    inside volpath_grid_kernel.supports, item k + s*n_q belonging to lane
    k of the n_q-lane pool, its items' radiance summed by `film_sum`.
    svox2: the (2, R) supervoxel [majorant | empty-skip] table; the
    density is scene.fp_grid; the other keywords are
    volpath_grid_kernel.grid_statics. su: the pre-hashed volpath stream
    root; counters: a dict that receives the launch's SIMT counters
    (GRID_COUNTERS), or None. The supervoxel table sits in the kernel's
    shared memory, sized for compile.SVOX_ROWS_MAX rows (kMaxSvoxRows)."""
    from lajolla_tpu_torch.integrators import volpath as V
    from lajolla_tpu_torch.integrators.media import INV_4PI
    from lajolla_tpu_torch.scene.compile import SVOX_ROWS_MAX
    device, tb, mats, quads, sph = _scene_args(
        scene, eps_isect, eps_shadow, max_depth, rr_depth, max_cap)
    n = w * h
    rows = gres[0] * gres[1] * gres[2]
    if rows > SVOX_ROWS_MAX:
        raise ValueError(f"{rows} supervoxel rows, K9 takes at most "
                         f"{SVOX_ROWS_MAX}")
    if n_q < n:
        raise ValueError(f"lane pool {n_q} smaller than the film ({n})")
    f32 = torch.float32
    sv = _check(svox2, 'svox2', (2, rows), f32, device)
    grid = _check(scene.fp_grid, 'fp_grid', (res[2] * res[1], res[0]), f32,
                  device)
    g = float(g1)
    gm = _GridMedium(
        pmin=(_F * 3)(*pmin), pmax=(_F * 3)(*pmax), res=(_I * 3)(*res),
        gres=(_I * 3)(*gres), rows=rows, maxval=maxval,
        albedo=(_F * 3)(*albedo), g=g, hg_a=g * g - 1.0, hg_b=g + 1.0,
        hg_c=1.0 + g * g, hg_d=2.0 * g, hg_num=INV_4PI * (1.0 - g * g),
        hg_sample=int(bool(hg) and abs(g) >= 1e-3),
        cam_med=int(scene.meta.camera_medium_id), max_null=int(max_null),
        max_segments=V.MAX_SHADOW_SEGMENTS)
    camera = _camera(cam, w, h, filter_type, filter_param)
    salts = _vol_salts()
    lib = build()['volpath_grid_kernels']
    out, counter = _queue(nspp * n_q, device)
    cnt, cnt_ptr = _counters(counters, GRID_COUNTERS, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lj_render_fused_grid(
            ctypes.byref(tb), ctypes.byref(camera), ctypes.byref(gm),
            ctypes.byref(salts), mats, quads, sph, int(bool(hg)), sv, grid,
            n, w, n_q, su, s0, nspp, counter.data_ptr(),
            out.data_ptr(), cnt_ptr, stream)
    if rc != 0:
        raise RuntimeError(f"render_fused_grid_kernel launch: CUDA error {rc}")
    LAUNCHES['render_fused_grid'] += 1
    _read_counters(counters, cnt, GRID_COUNTERS)
    return film_sum(out, n, n_q, nspp)


def advance_group(n):
    """The group size G of threads a lane that K2 takes for n lanes on the
    current card (csrc/path_kernels.cu advance_group)."""
    g = build()['path_kernels'].lj_advance_group(n)
    if g < 0:
        raise RuntimeError(f"advance_group: CUDA error {-g}")
    return g


def advance(scene, org, d, thr, rad, nv, dir_pdf, prev, un, act, *,
            eps_isect, eps_shadow, max_depth, rr_depth, max_cap, group=0):
    """Kernel K2: one vertex for N lanes. Vectors (3, N), un (8, N), nv and
    dir_pdf (N,) float32, act (N,) bool. A lane with act false comes back
    as it went in, alive false. group: the threads a lane (1, 2, 4 or 8),
    or 0 for advance_group's. Returns (org', dir', thr', rad', dir_pdf',
    alive)."""
    if group not in (0, 1, 2, 4, 8):
        raise ValueError(f"group {group}: K2 takes 1, 2, 4 or 8")
    lib = build()['path_kernels']
    device, tb, mats, quads, sph = _scene_args(
        scene, eps_isect, eps_shadow, max_depth, rr_depth, max_cap)
    N = org.shape[1]
    f32 = torch.float32
    ins = [_check(org, 'org', (3, N), f32, device),
           _check(d, 'dir', (3, N), f32, device),
           _check(thr, 'thr', (3, N), f32, device),
           _check(rad, 'rad', (3, N), f32, device),
           _check(nv, 'nv', (N,), f32, device),
           _check(dir_pdf, 'dir_pdf', (N,), f32, device),
           _check(prev, 'prev', (3, N), f32, device),
           _check(un, 'un', (8, N), f32, device),
           _check(act, 'act', (N,), torch.bool, device)]
    outs = [torch.empty((3, N), dtype=f32, device=device) for _ in range(4)]
    outs += [torch.empty(N, dtype=f32, device=device),
             torch.empty(N, dtype=torch.bool, device=device)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lj_advance(ctypes.byref(tb), mats, quads, sph, N, group,
                            *ins,
                            *[o.data_ptr() for o in outs], stream)
    if rc != 0:
        raise RuntimeError(f"advance_kernel launch: CUDA error {rc}")
    LAUNCHES['advance'] += 1
    return tuple(outs)


# K3 stages the cast table in shared memory: at most lajolla_tpu's
# BVH_MIN_TRIS prims (csrc/intersect_kernels.cu kMaxPrims).
MAX_CAST_PRIMS = 192


def _ray_args(o, d, tnear, tfar):
    """Pointers of (N, 3) rays and (N,) bounds; scalar bounds become
    tensors."""
    device, n, f32 = o.device, o.shape[0], torch.float32
    tn, tf = (x if torch.is_tensor(x) else
              torch.full((n,), float(x), dtype=f32, device=device)
              for x in (tnear, tfar))
    return (n, tn, tf, [_check(o, 'o', (n, 3), f32, device),
                        _check(d, 'd', (n, 3), f32, device),
                        _check(tn, 'tnear', (n,), f32, device),
                        _check(tf, 'tfar', (n,), f32, device)])


def _cast_table(woop, quad, name, device):
    """Pointers of a cast table and its quad flags on the rays' device."""
    tc = woop.shape[0]
    if tc > MAX_CAST_PRIMS:
        raise ValueError(f"{name}: {tc} cast prims, K3 takes at most "
                         f"{MAX_CAST_PRIMS}")
    return tc, [_check(woop, name, (tc, 12), torch.float32, device),
                _check(quad, name + ' quad flags', (tc,), torch.float32,
                       device)]


def intersect_brute(scene, o, d, tnear, tfar):
    """Kernel K3, closest hit over the quad-merged cast table
    (scene.fp_woop). o, d: (N, 3); tnear/tfar: (N,) or scalars. Returns
    (t, prim, u, v), each (N,): prim a true triangle id, -1 on a miss.
    CPU tensors run the plain form (ops/intersect._brute_force_batched);
    CUDA tensors launch the kernel, and anything else raises."""
    if o.device.type == 'cpu':
        from lajolla_tpu_torch.ops.intersect import _brute_force_batched
        return _brute_force_batched(scene, o, d, tnear, tfar)
    device = o.device
    tc, table = _cast_table(scene.fp_woop, scene.cast_quad, 'fp_woop',
                            device)
    ids = [_check(scene.cast_src, 'cast_src', (tc,), torch.int32, device),
           _check(scene.cast_alt, 'cast_alt', (tc,), torch.int32, device)]
    n, tn, tf, rays = _ray_args(o, d, tnear, tfar)
    lib = build()['intersect_kernels']
    t = torch.empty(n, dtype=torch.float32, device=device)
    prim = torch.empty(n, dtype=torch.int32, device=device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lj_intersect_brute(*table, *ids, tc, n, *rays,
                                    t.data_ptr(), prim.data_ptr(),
                                    u.data_ptr(), v.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"intersect_brute_kernel launch: CUDA error {rc}")
    LAUNCHES['intersect_brute'] += 1
    return t, prim, u, v


def occluded_brute(scene, o, d, tnear, tfar):
    """Kernel K3, any hit over the occluder subset (scene.fp_woop_occ).
    Returns (N,) bool. CPU tensors run the plain form
    (ops/intersect._occluded_batched); CUDA tensors launch the kernel,
    and anything else raises."""
    if o.device.type == 'cpu':
        from lajolla_tpu_torch.ops.intersect import _occluded_batched
        return _occluded_batched(scene, o, d, tnear, tfar)
    device = o.device
    tc, table = _cast_table(scene.fp_woop_occ, scene.cast_occ_quad,
                            'fp_woop_occ', device)
    n, tn, tf, rays = _ray_args(o, d, tnear, tfar)
    lib = build()['intersect_kernels']
    occ = torch.empty(n, dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lj_occluded_brute(*table, tc, n, *rays, occ.data_ptr(),
                                   stream)
    if rc != 0:
        raise RuntimeError(f"occluded_brute_kernel launch: CUDA error {rc}")
    LAUNCHES['occluded_brute'] += 1
    return occ


# ---------------------------------------------------------------------------
# K4-K7: the cluster-sweep casters (csrc/sweep_kernels.cu)
# ---------------------------------------------------------------------------

def _check16(t, name, shape, device):
    """_check of a float32 tensor that a kernel reads as float4 (rays and
    AABB rows of 8 floats, cluster rows of C floats)."""
    ptr = _check(t, name, shape, torch.float32, device)
    if ptr % 16:
        raise ValueError(f"{name}: not 16-byte aligned")
    return ptr


def _sweep_rays(rays, device):
    """Pointer of (Np, 8) rays [o, tnear, d, tfar]."""
    return _check16(rays, 'rays', (rays.shape[0], 8), device)


def _sweep_lists(rays, lane, aabb, counts, clist, tlist, device):
    """(R, B, L, K, C, pointers) of a list sweep's arguments."""
    f32, i32 = torch.float32, torch.int32
    K, _, C = lane.shape
    R, L = clist.shape
    Np = rays.shape[0]
    if R == 0 or Np % R:
        raise ValueError(f"{Np} rays do not fill {R} blocks")
    if C % 128:
        raise ValueError(f"cluster size {C}: K5 and K6 take multiples of 128")
    ptrs = [_sweep_rays(rays, device),
            _check16(lane, 'sw_lane', (K, 16, C), device),
            _check16(aabb, 'sw_aabb', (K, 8), device),
            _check(counts, 'counts', (R,), i32, device),
            _check(clist, 'clist', (R, L), i32, device),
            _check(tlist, 'tlist', (R, L), f32, device)]
    return R, Np // R, L, K, C, ptrs


def _hit_outputs(n, device):
    """(t, prim, u, v) outputs of n rays."""
    return (torch.empty(n, dtype=torch.float32, device=device),
            torch.empty(n, dtype=torch.int32, device=device),
            torch.empty(n, dtype=torch.float32, device=device),
            torch.empty(n, dtype=torch.float32, device=device))


def sweep_resident(rays, lane, aabb, counts, clist, tlist, any_hit):
    """Kernel K5: the front-to-back list sweep of blocks of rays over a
    cluster table small enough to stay in the L2 cache. Arguments and
    results as ops/intersect_sweep.sweep_resident_plain, which CPU
    tensors run; CUDA tensors launch the kernel, anything else raises.
    Returns (t (Np,) f32, kid (Np,) i32)."""
    if rays.device.type == 'cpu':
        from lajolla_tpu_torch.ops.intersect_sweep import sweep_resident_plain
        return sweep_resident_plain(rays, lane, aabb, counts, clist, tlist,
                                    any_hit)
    from lajolla_tpu_torch.ops.intersect_sweep import GROUP
    device = rays.device
    R, B, L, K, C, ptrs = _sweep_lists(rays, lane, aabb, counts, clist,
                                       tlist, device)
    if K % GROUP:
        raise ValueError(f"{K} clusters are no whole superclusters of {GROUP}")
    lib = build()['sweep_kernels']
    t = torch.empty(R * B, dtype=torch.float32, device=device)
    kid = torch.empty(R * B, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lj_sweep_resident(*ptrs, R, B, L, C, GROUP, int(any_hit),
                                   t.data_ptr(), kid.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sweep_resident_kernel launch: CUDA error {rc}")
    LAUNCHES['sweep_resident'] += 1
    return t, kid


def sweep_resolve(rays, kid, lane):
    """Kernel K4: (prim i32, u, v) of each ray's hit, found again in its
    winning cluster `kid` at the distance in the ray's tfar slot.
    Arguments and results as ops/intersect_sweep.sweep_resolve_plain,
    which CPU tensors run; CUDA tensors launch the kernel."""
    if rays.device.type == 'cpu':
        from lajolla_tpu_torch.ops.intersect_sweep import sweep_resolve_plain
        return sweep_resolve_plain(rays, kid, lane)
    device = rays.device
    n = rays.shape[0]
    K, _, C = lane.shape
    ptrs = [_sweep_rays(rays, device),
            _check(kid, 'kid', (n,), torch.int32, device),
            _check(lane, 'sw_lane', (K, 16, C), torch.float32, device)]
    lib = build()['sweep_kernels']
    _, p, u, v = _hit_outputs(n, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lj_sweep_resolve(*ptrs, n, C, p.data_ptr(), u.data_ptr(),
                                  v.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sweep_resolve_kernel launch: CUDA error {rc}")
    LAUNCHES['sweep_resolve'] += 1
    return p, u, v


def sweep_list(rays, lane, aabb, counts, clist, tlist, any_hit):
    """Kernel K6: the list sweep over a cluster table of any size, one
    warp per ray, (t, prim i32, u, v) in one pass. Arguments and results
    as ops/intersect_sweep.sweep_list_plain, which CPU tensors run; CUDA
    tensors launch the kernel."""
    if rays.device.type == 'cpu':
        from lajolla_tpu_torch.ops.intersect_sweep import sweep_list_plain
        return sweep_list_plain(rays, lane, aabb, counts, clist, tlist,
                                any_hit)
    device = rays.device
    R, B, L, K, C, ptrs = _sweep_lists(rays, lane, aabb, counts, clist,
                                       tlist, device)
    lib = build()['sweep_kernels']
    outs = _hit_outputs(R * B, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lj_sweep_list(*ptrs, R, B, L, C, int(any_hit),
                               *[x.data_ptr() for x in outs], stream)
    if rc != 0:
        raise RuntimeError(f"sweep_list_kernel launch: CUDA error {rc}")
    LAUNCHES['sweep_list'] += 1
    return outs


def sweep_streaming(rays, saabb, aabb, lane, any_hit):
    """Kernel K7: every ray walks the superclusters in id order behind two
    slab gates, one warp a ray, over the lane table (K, 16, C) of any
    cluster size C. Arguments and results as
    ops/intersect_sweep.sweep_streaming_plain, which CPU tensors run; CUDA
    tensors launch the kernel."""
    if rays.device.type == 'cpu':
        from lajolla_tpu_torch.ops.intersect_sweep import \
            sweep_streaming_plain
        return sweep_streaming_plain(rays, saabb, aabb, lane, any_hit)
    device = rays.device
    n = rays.shape[0]
    S = saabb.shape[0]
    K, _, C = lane.shape
    if S == 0 or K % S or K // S > 32 or aabb.shape[0] != K:
        raise ValueError(f"{K} clusters, {S} superclusters, "
                         f"{aabb.shape[0]} boxes: no whole groups of at "
                         "most 32")
    ptrs = [_sweep_rays(rays, device),
            _check16(saabb, 'sw_saabb', (S, 8), device),
            _check16(aabb, 'sw_aabb', (K, 8), device),
            _check(lane, 'sw_lane', (K, 16, C), torch.float32, device)]
    lib = build()['sweep_kernels']
    outs = _hit_outputs(n, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lj_sweep_streaming(*ptrs, n, S, K // S, C, int(any_hit),
                                    *[x.data_ptr() for x in outs], stream)
    if rc != 0:
        raise RuntimeError(f"sweep_streaming_kernel launch: CUDA error {rc}")
    LAUNCHES['sweep_streaming'] += 1
    return outs
