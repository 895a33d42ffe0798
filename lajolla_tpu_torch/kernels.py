"""Build and bind the CUDA kernels (nvcc into a shared library + ctypes).

At first use, `build()` compiles csrc/path_kernels.cu for sm_90a into
build/lajolla_tpu_torch/ next to the package, keyed on a hash of the
sources, and loads it with ctypes. Nothing here runs at import: the
module imports on machines with no nvcc and no GPU.

The wrappers check device, dtype, shape and contiguity, allocate their
outputs with torch.empty, launch on the current stream without
synchronising, raise if the launch reports a CUDA error, and count their
launches in LAUNCHES. They never fall back to the plain forms.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / 'csrc'
_SOURCES = ('path_kernels.cu', 'path_advance.cuh')
BUILD_DIR = Path(__file__).resolve().parent.parent / 'build' / \
    'lajolla_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# Kernel launches by kernel name; a wrapper adds one where it launches.
LAUNCHES = {'render_fused': 0, 'advance': 0}

_lib = None

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
    """Camera (csrc/path_kernels.cu)."""
    _fields_ = [('m', _F * 32), ('inv_w', _F), ('inv_h', _F),
                ('fparam', _F), ('fhalf', _F), ('ftype', _I)]


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    return os.path.join(cuda_home, 'bin', 'nvcc')


def _source_tag():
    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    return digest.hexdigest()[:16]


def build():
    """Compile (if this source hash has no library yet) and load the
    kernels. Returns the ctypes library; raises if the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    tag = _source_tag()
    so = BUILD_DIR / f'liblj_kernels_{tag}.so'
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f'.liblj_kernels_{tag}.{os.getpid()}.so'
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
               str(_CSRC / 'path_kernels.cu')]
        r = subprocess.run(cmd, capture_output=True, text=True)
        (BUILD_DIR / f'build_{tag}.log').write_text(
            ' '.join(cmd) + '\n' + r.stdout + r.stderr)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                               f"{r.stderr[-6000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.lj_render_fused.argtypes = [ctypes.POINTER(_Tables),
                                    ctypes.POINTER(_Camera), _I, _I, _I, _I,
                                    _I, ctypes.c_uint32, ctypes.c_longlong,
                                    _I, _P, _P]
    lib.lj_render_fused.restype = _I
    lib.lj_advance.argtypes = ([ctypes.POINTER(_Tables), _I, _I, _I, _I] +
                               [_P] * 16)
    lib.lj_advance.restype = _I
    _lib = lib
    return lib


def build_log():
    """The nvcc output (ptxas registers and spills) of the build of the
    current sources, or '' if they have not been built here."""
    log = BUILD_DIR / f'build_{_source_tag()}.log'
    return log.read_text() if log.exists() else ''


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


def render_fused(scene, cam, seed_u32, s0, nspp, *, w, h, filter_type,
                 filter_param, eps_isect, eps_shadow, max_depth, rr_depth,
                 max_cap):
    """Kernel K1: the (3, w*h) film sum of samples s0..s0+nspp."""
    lib = build()
    device, tb, mats, quads, sph = _scene_args(
        scene, eps_isect, eps_shadow, max_depth, rr_depth, max_cap)
    n = w * h
    cam_f = cam.detach().to('cpu', torch.float32)
    if cam_f.shape != (32,):
        raise ValueError(f"camera: shape {tuple(cam_f.shape)}, expected (32,)")
    camera = _Camera(m=(_F * 32)(*cam_f.tolist()), inv_w=1.0 / w,
                     inv_h=1.0 / h, fparam=filter_param,
                     fhalf=filter_param / 2.0, ftype=filter_type)
    film = torch.empty((3, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lj_render_fused(ctypes.byref(tb), ctypes.byref(camera),
                                 mats, quads, sph, n, w, seed_u32, s0, nspp,
                                 film.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"render_fused_kernel launch: CUDA error {rc}")
    LAUNCHES['render_fused'] += 1
    return film


def advance(scene, org, d, thr, rad, nv, dir_pdf, prev, un, act, *,
            eps_isect, eps_shadow, max_depth, rr_depth, max_cap):
    """Kernel K2: one vertex for N lanes. Vectors (3, N), un (8, N), nv and
    dir_pdf (N,) float32, act (N,) bool. Returns (org', dir', thr', rad',
    dir_pdf', alive)."""
    lib = build()
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
        rc = lib.lj_advance(ctypes.byref(tb), mats, quads, sph, N, *ins,
                            *[o.data_ptr() for o in outs], stream)
    if rc != 0:
        raise RuntimeError(f"advance_kernel launch: CUDA error {rc}")
    LAUNCHES['advance'] += 1
    return tuple(outs)
