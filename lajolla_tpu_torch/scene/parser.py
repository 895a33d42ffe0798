"""Mitsuba-XML scene parser (host-side).

Replicates the behavior of the reference parser (src/parse_scene.cpp):
same element set, same defaults, same value-parsing quirks (e.g. a
single-entry `<spectrum>` reflectance parses to white, parse_scene.cpp
:117-121; emitter radiance single-entry spectra scale the D65-ish white
point, :941-954). Produces a host `SceneBuilder`, which
`lajolla_tpu_torch.scene.compile.compile_scene` turns into device arrays.
"""

import os
import warnings
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field as dfield
from typing import Any, Dict, List, Optional

import numpy as np

from lajolla_tpu_torch.core import transform as xf
from lajolla_tpu_torch.core.spectrum import (integrate_xyz, xyz_to_rgb,
                                       srgb_to_linear)
from lajolla_tpu_torch.io.image import imread1, imread3
from lajolla_tpu_torch.io.obj import load_obj
from lajolla_tpu_torch.io.serialized import load_serialized
from lajolla_tpu_torch.io.vol import load_vol
from lajolla_tpu_torch.scene import types as T
from lajolla_tpu_torch.scene.texture import TexturePool
from lajolla_tpu_torch.scene.types import RenderOptions
from lajolla_tpu_torch.utils import profiling


# ---------------------------------------------------------------------------
# Host-side builder structures
# ---------------------------------------------------------------------------

@dataclass
class TexDesc:
    kind: int = T.TEX_CONSTANT
    const: Any = (0.0, 0.0, 0.0)
    color1: Any = (0.0, 0.0, 0.0)
    image_id: int = 0
    uscale: float = 1.0
    vscale: float = 1.0
    uoffset: float = 0.0
    voffset: float = 0.0


@dataclass
class MaterialB:
    type: int = T.MAT_LAMBERTIAN
    tex: Dict[int, int] = dfield(default_factory=dict)  # slot -> texdesc id
    eta: float = 1.5


@dataclass
class MeshB:
    positions: Any = None
    indices: Any = None
    normals: Any = None
    uvs: Any = None


@dataclass
class ShapeB:
    type: int = T.SHAPE_MESH
    mesh: Optional[MeshB] = None
    center: Any = (0.0, 0.0, 0.0)
    radius: float = 1.0
    material_id: int = -1
    area_light_id: int = -1
    interior_medium_id: int = -1
    exterior_medium_id: int = -1


@dataclass
class LightB:
    type: int = T.LIGHT_AREA
    shape_id: int = -1
    intensity: Any = (1.0, 1.0, 1.0)
    # envmap
    image_id: int = -1
    to_world: Any = None
    scale: float = 1.0


@dataclass
class VolumeB:
    kind: int = T.VOL_CONSTANT
    const: Any = (0.0, 0.0, 0.0)
    grid: Any = None          # (Z,Y,X,3) float32
    pmin: Any = (0.0, 0.0, 0.0)
    pmax: Any = (1.0, 1.0, 1.0)
    scale: float = 1.0


@dataclass
class MediumB:
    type: int = T.MED_HOMOGENEOUS
    sigma_a: Any = (0.5, 0.5, 0.5)
    sigma_s: Any = (0.5, 0.5, 0.5)
    phase_type: int = T.PHASE_ISOTROPIC
    g: float = 0.0
    albedo_vol: int = -1
    density_vol: int = -1


@dataclass
class CameraB:
    to_world: Any = None
    fov: float = 45.0           # raw scene-file fov (see fov_axis)
    fov_axis: str = 'x'         # x/y/diagonal/smaller/larger
    width: int = 256
    height: int = 256
    medium_id: int = -1


@dataclass
class SceneBuilder:
    camera: CameraB = None
    options: RenderOptions = None
    materials: List[MaterialB] = dfield(default_factory=list)
    shapes: List[ShapeB] = dfield(default_factory=list)
    lights: List[LightB] = dfield(default_factory=list)
    media: List[MediumB] = dfield(default_factory=list)
    volumes: List[VolumeB] = dfield(default_factory=list)
    texdescs: List[TexDesc] = dfield(default_factory=list)
    texture_pool: TexturePool = None
    envmap_light_id: int = -1

    def add_texdesc(self, td):
        self.texdescs.append(td)
        return len(self.texdescs) - 1


# ---------------------------------------------------------------------------
# Value parsers (reference parse_scene.cpp:47-263)
# ---------------------------------------------------------------------------

def parse_vector3(s):
    parts = [p for p in s.replace(',', ' ').split() if p]
    if len(parts) == 1:
        v = float(parts[0])
        return np.array([v, v, v], np.float64)
    if len(parts) == 3:
        return np.array([float(p) for p in parts], np.float64)
    raise ValueError(f"parse_vector3 failed: {s!r}")


def parse_srgb(s):
    s = s.strip()
    if len(s) == 7 and s[0] == '#':
        v = int(s[1:], 16)
        return np.array([(v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF],
                        np.float64) / 255.0
    raise ValueError(f"unknown sRGB format: {s!r}")


def parse_spectrum_pairs(s):
    """Returns list of (wavelength, value); a bare scalar becomes a single
    (-1, v) pair like the reference (parse_scene.cpp:82-98)."""
    parts = [p for p in s.replace(',', ' ').split() if p]
    if len(parts) == 1 and ':' not in parts[0]:
        return [(-1.0, float(parts[0]))]
    out = []
    for p in parts:
        wl, _, v = p.partition(':')
        if not v:
            raise ValueError(f"parse_spectrum failed: {s!r}")
        out.append((float(wl), float(v)))
    return out


def _spectrum_to_rgb(pairs):
    xyz = integrate_xyz([p[0] for p in pairs], [p[1] for p in pairs])
    return xyz_to_rgb(xyz)


def parse_transform(node):
    """Accumulate child ops left-multiplying, as parse_scene.cpp:117-167."""
    m = xf.identity()
    for child in node:
        tag = child.tag.lower()
        if tag == 'scale':
            if 'value' in child.attrib:
                v = parse_vector3(child.get('value'))
            else:
                v = np.array([float(child.get('x', 1.0)),
                              float(child.get('y', 1.0)),
                              float(child.get('z', 1.0))])
            m = xf.scale(v) @ m
        elif tag == 'translate':
            v = np.array([float(child.get('x', 0.0)),
                          float(child.get('y', 0.0)),
                          float(child.get('z', 0.0))])
            m = xf.translate(v) @ m
        elif tag == 'rotate':
            axis = np.array([float(child.get('x', 0.0)),
                             float(child.get('y', 0.0)),
                             float(child.get('z', 0.0))])
            angle = float(child.get('angle', 0.0))
            m = xf.rotate(angle, axis) @ m
        elif tag == 'lookat':
            m = xf.look_at(parse_vector3(child.get('origin')),
                           parse_vector3(child.get('target')),
                           parse_vector3(child.get('up'))) @ m
        elif tag == 'matrix':
            m = xf.parse_matrix_string(child.get('value')) @ m
    return m


def parse_color(node):
    """spectrum/rgb/srgb/float element → linear RGB
    (parse_scene.cpp:180-204). NB: single-entry spectrum parses to WHITE
    here (the reference quirk) — emitters special-case it separately."""
    tag = node.tag
    if tag == 'spectrum':
        pairs = parse_spectrum_pairs(node.get('value'))
        if len(pairs) > 1:
            return _spectrum_to_rgb(pairs)
        if len(pairs) == 1:
            return np.array([1.0, 1.0, 1.0])
        return np.zeros(3)
    if tag == 'rgb':
        return parse_vector3(node.get('value'))
    if tag == 'srgb':
        return srgb_to_linear(parse_srgb(node.get('value')))
    if tag == 'float':
        v = float(node.get('value'))
        return np.array([v, v, v])
    raise ValueError(f"unknown color type: {tag}")


# ---------------------------------------------------------------------------
# Texture parsing
# ---------------------------------------------------------------------------

@dataclass
class ParsedTexture:
    type: str = 'bitmap'   # or 'checkerboard'
    filename: str = ''
    color0: Any = (0.4, 0.4, 0.4)
    color1: Any = (0.2, 0.2, 0.2)
    uscale: float = 1.0
    vscale: float = 1.0
    uoffset: float = 0.0
    voffset: float = 0.0


def parse_texture(node):
    t = ParsedTexture()
    typ = node.get('type')
    if typ == 'bitmap':
        t.type = 'bitmap'
    elif typ == 'checkerboard':
        t.type = 'checkerboard'
        t.color0 = np.array([0.4, 0.4, 0.4])
        t.color1 = np.array([0.2, 0.2, 0.2])
    else:
        raise ValueError(f"unknown texture type: {typ}")
    for child in node:
        name = child.get('name')
        if name == 'filename':
            t.filename = child.get('value')
        elif name == 'color0':
            t.color0 = parse_color(child)
        elif name == 'color1':
            t.color1 = parse_color(child)
        elif name == 'uvscale':
            t.uscale = t.vscale = float(child.get('value'))
        elif name == 'uscale':
            t.uscale = float(child.get('value'))
        elif name == 'vscale':
            t.vscale = float(child.get('value'))
        elif name == 'uoffset':
            t.uoffset = float(child.get('value'))
        elif name == 'voffset':
            t.voffset = float(child.get('value'))
    return t


class _Ctx:
    """Parser context: id maps + builder."""

    def __init__(self):
        self.b = SceneBuilder(camera=CameraB(to_world=xf.identity()),
                              options=RenderOptions(),
                              texture_pool=TexturePool())
        self.material_map = {}
        self.medium_map = {}
        self.texture_map = {}  # id -> ParsedTexture

    # -- texture descriptor helpers ----------------------------------------

    def const_tex(self, rgb):
        rgb = np.broadcast_to(np.asarray(rgb, np.float64), (3,))
        return self.b.add_texdesc(TexDesc(kind=T.TEX_CONSTANT,
                                          const=tuple(rgb)))

    def spectrum_texture(self, node):
        """parse_spectrum_texture (parse_scene.cpp:169-218)."""
        tag = node.tag
        if tag in ('spectrum', 'rgb', 'srgb', 'float'):
            return self.const_tex(parse_color(node))
        if tag == 'ref':
            t = self.texture_map[node.get('id')]
            if t.type == 'bitmap':
                img_id = self.b.texture_pool.insert(
                    node.get('id'), imread3(t.filename))
                return self.b.add_texdesc(TexDesc(
                    kind=T.TEX_IMAGE, image_id=img_id,
                    uscale=t.uscale, vscale=t.vscale,
                    uoffset=t.uoffset, voffset=t.voffset))
            return self.b.add_texdesc(TexDesc(
                kind=T.TEX_CHECKERBOARD, const=tuple(t.color0),
                color1=tuple(t.color1),
                uscale=t.uscale, vscale=t.vscale,
                uoffset=t.uoffset, voffset=t.voffset))
        raise ValueError(f"unknown spectrum texture type: {tag}")

    def float_texture(self, node, transform=None):
        """parse_float_texture (parse_scene.cpp:220-243); `transform`
        optionally maps the loaded image (e.g. sqrt for alpha→roughness)."""
        tag = node.tag
        if tag == 'float':
            v = float(node.get('value'))
            if transform is not None:
                v = transform(v)
            return self.const_tex((v, v, v))
        if tag == 'ref':
            ref_id = node.get('id')
            t = self.texture_map[ref_id]
            img = imread1(t.filename)
            key = ref_id
            if transform is not None:
                img = transform(img)
                key = ref_id + "#xf"
            img_id = self.b.texture_pool.insert(key, img)
            return self.b.add_texdesc(TexDesc(
                kind=T.TEX_IMAGE, image_id=img_id,
                uscale=t.uscale, vscale=t.vscale))
        raise ValueError(f"unknown float texture type: {tag}")


# ---------------------------------------------------------------------------
# BSDF parsing (parse_scene.cpp:558-809)
# ---------------------------------------------------------------------------

def parse_bsdf(node, ctx):
    typ = node.get('type')
    mid = node.get('id', '')
    m = MaterialB()
    P = T

    def children_by_name():
        return [(c.get('name'), c) for c in node]

    if typ == 'diffuse':
        m.type = T.MAT_LAMBERTIAN
        m.tex[P.P_BASE_COLOR] = ctx.const_tex((0.5, 0.5, 0.5))
        for name, c in children_by_name():
            if name == 'reflectance':
                m.tex[P.P_BASE_COLOR] = ctx.spectrum_texture(c)
    elif typ in ('roughplastic', 'plastic'):
        m.type = T.MAT_ROUGH_PLASTIC
        m.tex[P.P_BASE_COLOR] = ctx.const_tex((0.5, 0.5, 0.5))
        m.tex[P.P_AUX_COLOR] = ctx.const_tex((1.0, 1.0, 1.0))
        m.tex[P.P_ROUGHNESS] = ctx.const_tex(
            0.1 if typ == 'roughplastic' else 0.01)
        int_ior, ext_ior = 1.49, 1.000277
        for name, c in children_by_name():
            if name == 'diffuseReflectance':
                m.tex[P.P_BASE_COLOR] = ctx.spectrum_texture(c)
            elif name == 'specularReflectance':
                m.tex[P.P_AUX_COLOR] = ctx.spectrum_texture(c)
            elif name == 'alpha':
                m.tex[P.P_ROUGHNESS] = ctx.float_texture(c, transform=np.sqrt)
            elif name == 'roughness':
                m.tex[P.P_ROUGHNESS] = ctx.float_texture(c)
            elif name == 'intIOR':
                int_ior = float(c.get('value'))
            elif name == 'extIOR':
                ext_ior = float(c.get('value'))
        m.eta = int_ior / ext_ior
    elif typ in ('roughdielectric', 'dielectric'):
        m.type = T.MAT_ROUGH_DIELECTRIC
        m.tex[P.P_BASE_COLOR] = ctx.const_tex((1.0, 1.0, 1.0))
        m.tex[P.P_AUX_COLOR] = ctx.const_tex((1.0, 1.0, 1.0))
        m.tex[P.P_ROUGHNESS] = ctx.const_tex(
            0.1 if typ == 'roughdielectric' else 0.01)
        int_ior, ext_ior = 1.5046, 1.000277
        for name, c in children_by_name():
            if name == 'specularReflectance':
                m.tex[P.P_BASE_COLOR] = ctx.spectrum_texture(c)
            elif name == 'specularTransmittance':
                m.tex[P.P_AUX_COLOR] = ctx.spectrum_texture(c)
            elif name == 'alpha':
                m.tex[P.P_ROUGHNESS] = ctx.float_texture(c, transform=np.sqrt)
            elif name == 'roughness':
                m.tex[P.P_ROUGHNESS] = ctx.float_texture(c)
            elif name == 'intIOR':
                int_ior = float(c.get('value'))
            elif name == 'extIOR':
                ext_ior = float(c.get('value'))
        m.eta = int_ior / ext_ior
    elif typ == 'disneydiffuse':
        m.type = T.MAT_DISNEY_DIFFUSE
        m.tex[P.P_BASE_COLOR] = ctx.const_tex((0.5, 0.5, 0.5))
        m.tex[P.P_ROUGHNESS] = ctx.const_tex(0.5)
        m.tex[P.P_SUBSURFACE] = ctx.const_tex(0.0)
        for name, c in children_by_name():
            if name == 'baseColor':
                m.tex[P.P_BASE_COLOR] = ctx.spectrum_texture(c)
            elif name == 'roughness':
                m.tex[P.P_ROUGHNESS] = ctx.float_texture(c)
            elif name == 'subsurface':
                m.tex[P.P_SUBSURFACE] = ctx.float_texture(c)
    elif typ == 'disneymetal':
        m.type = T.MAT_DISNEY_METAL
        m.tex[P.P_BASE_COLOR] = ctx.const_tex((0.5, 0.5, 0.5))
        m.tex[P.P_ROUGHNESS] = ctx.const_tex(0.5)
        m.tex[P.P_ANISOTROPIC] = ctx.const_tex(0.0)
        for name, c in children_by_name():
            if name == 'baseColor':
                m.tex[P.P_BASE_COLOR] = ctx.spectrum_texture(c)
            elif name == 'roughness':
                m.tex[P.P_ROUGHNESS] = ctx.float_texture(c)
            elif name == 'anisotropic':
                m.tex[P.P_ANISOTROPIC] = ctx.float_texture(c)
    elif typ == 'disneyglass':
        m.type = T.MAT_DISNEY_GLASS
        m.tex[P.P_BASE_COLOR] = ctx.const_tex((0.5, 0.5, 0.5))
        m.tex[P.P_ROUGHNESS] = ctx.const_tex(0.5)
        m.tex[P.P_ANISOTROPIC] = ctx.const_tex(0.0)
        m.eta = 1.5
        for name, c in children_by_name():
            if name == 'baseColor':
                m.tex[P.P_BASE_COLOR] = ctx.spectrum_texture(c)
            elif name == 'roughness':
                m.tex[P.P_ROUGHNESS] = ctx.float_texture(c)
            elif name == 'anisotropic':
                m.tex[P.P_ANISOTROPIC] = ctx.float_texture(c)
            elif name == 'eta':
                m.eta = float(c.get('value'))
    elif typ == 'disneyclearcoat':
        m.type = T.MAT_DISNEY_CLEARCOAT
        m.tex[P.P_CLEARCOAT_GLOSS] = ctx.const_tex(1.0)
        for name, c in children_by_name():
            if name == 'clearcoatGloss':
                m.tex[P.P_CLEARCOAT_GLOSS] = ctx.float_texture(c)
    elif typ == 'disneysheen':
        m.type = T.MAT_DISNEY_SHEEN
        m.tex[P.P_BASE_COLOR] = ctx.const_tex((0.5, 0.5, 0.5))
        m.tex[P.P_SHEEN_TINT] = ctx.const_tex(0.5)
        for name, c in children_by_name():
            if name == 'baseColor':
                m.tex[P.P_BASE_COLOR] = ctx.spectrum_texture(c)
            elif name == 'sheenTint':
                m.tex[P.P_SHEEN_TINT] = ctx.float_texture(c)
    elif typ == 'disneybsdf':
        m.type = T.MAT_DISNEY_BSDF
        defaults = [
            (P.P_BASE_COLOR, (0.5, 0.5, 0.5)), (P.P_SPEC_TRANS, 0.0),
            (P.P_METALLIC, 0.0), (P.P_SUBSURFACE, 0.0), (P.P_SPECULAR, 0.5),
            (P.P_ROUGHNESS, 0.5), (P.P_SPECULAR_TINT, 0.0),
            (P.P_ANISOTROPIC, 0.0), (P.P_SHEEN, 0.0), (P.P_SHEEN_TINT, 0.5),
            (P.P_CLEARCOAT, 0.0), (P.P_CLEARCOAT_GLOSS, 1.0)]
        for slot, v in defaults:
            m.tex[slot] = ctx.const_tex(v)
        m.eta = 1.5
        names = {
            'baseColor': (P.P_BASE_COLOR, 's'),
            'specularTransmission': (P.P_SPEC_TRANS, 'f'),
            'metallic': (P.P_METALLIC, 'f'),
            'subsurface': (P.P_SUBSURFACE, 'f'),
            'specular': (P.P_SPECULAR, 'f'),
            'roughness': (P.P_ROUGHNESS, 'f'),
            'specularTint': (P.P_SPECULAR_TINT, 'f'),
            'anisotropic': (P.P_ANISOTROPIC, 'f'),
            'sheen': (P.P_SHEEN, 'f'),
            'sheenTint': (P.P_SHEEN_TINT, 'f'),
            'clearcoat': (P.P_CLEARCOAT, 'f'),
            'clearcoatGloss': (P.P_CLEARCOAT_GLOSS, 'f'),
        }
        for name, c in children_by_name():
            if name in names:
                slot, k = names[name]
                m.tex[slot] = (ctx.spectrum_texture(c) if k == 's'
                               else ctx.float_texture(c))
            elif name == 'eta':
                m.eta = float(c.get('value'))
    elif typ == 'phong':
        # Not supported by the reference either (it errors,
        # parse_scene.cpp:806); scenes/sponza ships one. We degrade to
        # diffuse with the phong diffuseReflectance and warn.
        warnings.warn("BSDF type 'phong' unsupported; treating as diffuse")
        m.type = T.MAT_LAMBERTIAN
        m.tex[P.P_BASE_COLOR] = ctx.const_tex((0.5, 0.5, 0.5))
        for name, c in children_by_name():
            if name == 'diffuseReflectance':
                m.tex[P.P_BASE_COLOR] = ctx.spectrum_texture(c)
    else:
        raise ValueError(f"unknown BSDF: {typ}")
    return mid, m


# ---------------------------------------------------------------------------
# Media / volumes (parse_scene.cpp:359-457)
# ---------------------------------------------------------------------------

def parse_volume(node, ctx):
    typ = node.get('type')
    if typ == 'constvolume':
        value = np.zeros(3)
        for c in node:
            if c.get('name') == 'value':
                value = parse_color(c)
        v = VolumeB(kind=T.VOL_CONSTANT, const=tuple(value))
    elif typ == 'gridvolume':
        filename = None
        for c in node:
            if c.get('name') == 'filename':
                filename = c.get('value')
        if not filename:
            raise ValueError("empty filename for gridvolume")
        g = load_vol(filename, target_channels=3)
        v = VolumeB(kind=T.VOL_GRID, grid=g['data'],
                    pmin=tuple(g['pmin']), pmax=tuple(g['pmax']))
    else:
        raise ValueError(f"unknown volume type: {typ}")
    ctx.b.volumes.append(v)
    return len(ctx.b.volumes) - 1


def parse_phase(node):
    typ = node.get('type')
    if typ == 'isotropic':
        return T.PHASE_ISOTROPIC, 0.0
    if typ == 'hg':
        g = 0.0
        for c in node:
            if c.get('name') == 'g':
                g = float(c.get('value'))
        return T.PHASE_HG, g
    raise ValueError(f"unrecognized phase function: {typ}")


def parse_medium(node, ctx):
    typ = node.get('type')
    mid = node.get('id', '')
    m = MediumB()
    if typ == 'homogeneous':
        sigma_a = np.array([0.5, 0.5, 0.5])
        sigma_s = np.array([0.5, 0.5, 0.5])
        scale = 1.0
        for c in node:
            name = c.get('name')
            if name == 'sigmaA':
                sigma_a = parse_color(c)
            elif name == 'sigmaS':
                sigma_s = parse_color(c)
            elif name == 'scale':
                scale = float(c.get('value'))
            elif c.tag == 'phase':
                m.phase_type, m.g = parse_phase(c)
        m.type = T.MED_HOMOGENEOUS
        m.sigma_a = tuple(sigma_a * scale)
        m.sigma_s = tuple(sigma_s * scale)
    elif typ == 'heterogeneous':
        m.type = T.MED_HETEROGENEOUS
        albedo_vol = density_vol = None
        scale = 1.0
        for c in node:
            name = c.get('name')
            if name == 'albedo':
                albedo_vol = parse_volume(c, ctx)
            elif name == 'density':
                density_vol = parse_volume(c, ctx)
            elif name == 'scale':
                scale = float(c.get('value'))
            elif c.tag == 'phase':
                m.phase_type, m.g = parse_phase(c)
        if albedo_vol is None:
            ctx.b.volumes.append(VolumeB(kind=T.VOL_CONSTANT,
                                         const=(1.0, 1.0, 1.0)))
            albedo_vol = len(ctx.b.volumes) - 1
        if density_vol is None:
            ctx.b.volumes.append(VolumeB(kind=T.VOL_CONSTANT,
                                         const=(1.0, 1.0, 1.0)))
            density_vol = len(ctx.b.volumes) - 1
        # "scale only applies to density!!" (parse_scene.cpp:448)
        ctx.b.volumes[density_vol].scale = scale
        m.albedo_vol = albedo_vol
        m.density_vol = density_vol
    else:
        raise ValueError(f"unknown medium type: {typ}")
    return mid, m


# ---------------------------------------------------------------------------
# Integrator / sensor / film
# ---------------------------------------------------------------------------

def parse_integrator(node, opts):
    typ = node.get('type')
    kw = {}
    if typ == 'path':
        kw['integrator'] = 'path'
        for c in node:
            name = c.get('name')
            if name == 'maxDepth':
                kw['max_depth'] = int(c.get('value'))
            elif name == 'rrDepth':
                kw['rr_depth'] = int(c.get('value'))
    elif typ == 'volpath':
        kw['integrator'] = 'volpath'
        for c in node:
            name = c.get('name')
            if name == 'maxDepth':
                kw['max_depth'] = int(c.get('value'))
            elif name == 'rrDepth':
                kw['rr_depth'] = int(c.get('value'))
            elif name == 'version':
                kw['vol_path_version'] = int(c.get('value'))
            elif name == 'maxNullCollisions':
                kw['max_null_collisions'] = int(c.get('value'))
    elif typ == 'direct':
        kw['integrator'] = 'path'
        kw['max_depth'] = 2
    elif typ in ('depth', 'shadingNormal', 'meanCurvature',
                 'rayDifferential', 'mipmapLevel'):
        kw['integrator'] = typ
    else:
        raise ValueError(f"unsupported integrator: {typ}")
    return _replace_opts(opts, **kw)


def _replace_opts(opts, **kw):
    import dataclasses
    return dataclasses.replace(opts, **kw)


def parse_film(node):
    width = height = 256
    filename = "image.exr"
    filter_type, filter_param = T.FILTER_BOX, 1.0
    for c in node:
        name = c.get('name')
        if name == 'width':
            width = int(c.get('value'))
        elif name == 'height':
            height = int(c.get('value'))
        elif name == 'filename':
            filename = c.get('value')
        if c.tag == 'rfilter':
            ft = c.get('type')
            if ft == 'box':
                filter_type, filter_param = T.FILTER_BOX, 1.0
                for gc in c:
                    if gc.get('name') == 'width':
                        filter_param = float(gc.get('value'))
            elif ft == 'tent':
                filter_type, filter_param = T.FILTER_TENT, 2.0
                for gc in c:
                    if gc.get('name') == 'width':
                        filter_param = float(gc.get('value'))
            elif ft == 'gaussian':
                filter_type, filter_param = T.FILTER_GAUSSIAN, 0.5
                for gc in c:
                    if gc.get('name') == 'stddev':
                        filter_param = float(gc.get('value'))
    return width, height, filename, filter_type, filter_param


def parse_sensor(node, ctx):
    fov = 45.0
    to_world = xf.identity()
    width = height = 256
    filename = "image.exr"
    filter_type, filter_param = T.FILTER_BOX, 1.0
    fov_axis = 'x'
    sample_count = 4
    medium_id = -1

    if node.get('type') != 'perspective':
        raise ValueError(f"unsupported sensor: {node.get('type')}")
    for c in node:
        name = c.get('name')
        if name == 'fov':
            fov = float(c.get('value'))
        elif name == 'toWorld':
            to_world = parse_transform(c)
        elif name == 'fovAxis':
            fov_axis = c.get('value')
            if fov_axis not in ('x', 'y', 'diagonal', 'smaller', 'larger'):
                raise ValueError(f"unknown fovAxis value: {fov_axis}")
        if c.tag == 'film':
            width, height, filename, filter_type, filter_param = parse_film(c)
        elif c.tag == 'sampler':
            for gc in c:
                if gc.get('name') == 'sampleCount':
                    sample_count = int(gc.get('value'))
        elif c.tag == 'ref':
            medium_id = ctx.medium_map[c.get('id')]
        elif c.tag == 'medium':
            mname, med = parse_medium(c, ctx)
            if mname:
                ctx.medium_map[mname] = len(ctx.b.media)
            medium_id = len(ctx.b.media)
            ctx.b.media.append(med)

    # The fovAxis → fovX conversion (parse_scene.cpp:536-549) depends on
    # the film aspect, so it happens at COMPILE time (compile.py
    # fov_to_fov_x) — tests re-render reference scenes at other film
    # sizes by mutating camera.width/height, and the conversion must see
    # the final size exactly as a reference re-parse would.
    cam = CameraB(to_world=to_world, fov=float(fov), fov_axis=fov_axis,
                  width=width, height=height, medium_id=medium_id)
    return cam, filename, sample_count, filter_type, filter_param


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

def parse_shape(node, ctx):
    b = ctx.b
    material_id = -1
    interior_medium_id = -1
    exterior_medium_id = -1
    for c in node:
        if c.tag == 'ref':
            name_value = c.get('name', '')
            rid = c.get('id')
            if rid is None:
                raise ValueError("material/medium reference id not specified")
            if name_value == 'interior':
                interior_medium_id = ctx.medium_map[rid]
            elif name_value == 'exterior':
                exterior_medium_id = ctx.medium_map[rid]
            else:
                material_id = ctx.material_map[rid]
        elif c.tag == 'bsdf':
            mname, m = parse_bsdf(c, ctx)
            if mname:
                ctx.material_map[mname] = len(b.materials)
            material_id = len(b.materials)
            b.materials.append(m)
        elif c.tag == 'medium':
            mname, med = parse_medium(c, ctx)
            if mname:
                ctx.medium_map[mname] = len(b.media)
            nv = c.get('name')
            if nv == 'interior':
                interior_medium_id = len(b.media)
            elif nv == 'exterior':
                exterior_medium_id = len(b.media)
            else:
                raise ValueError(f"unrecognized medium name: {nv}")
            b.media.append(med)

    shape = ShapeB(material_id=material_id,
                   interior_medium_id=interior_medium_id,
                   exterior_medium_id=exterior_medium_id)
    typ = node.get('type')
    if typ in ('obj', 'serialized'):
        filename = None
        shape_index = 0
        to_world = None
        for c in node:
            name = c.get('name')
            if name == 'filename':
                filename = c.get('value')
            elif name == 'toWorld' and c.tag == 'transform':
                to_world = parse_transform(c)
            elif name == 'shapeIndex':
                shape_index = int(c.get('value'))
        if typ == 'obj':
            mesh = load_obj(filename, to_world)
        else:
            mesh = load_serialized(filename, shape_index, to_world)
        shape.type = T.SHAPE_MESH
        shape.mesh = MeshB(**mesh)
    elif typ == 'sphere':
        center = np.zeros(3)
        radius = 1.0
        for c in node:
            name = c.get('name')
            if name == 'center':
                center = np.array([float(c.get('x')), float(c.get('y')),
                                   float(c.get('z'))])
            elif name == 'radius':
                radius = float(c.get('value'))
        shape.type = T.SHAPE_SPHERE
        shape.center = tuple(center)
        shape.radius = radius
    else:
        raise ValueError(f"unknown shape: {typ}")

    # inline area emitter (parse_scene.cpp:932-968)
    for c in node:
        if c.tag == 'emitter':
            radiance = np.ones(3)
            for gc in c:
                if gc.get('name') == 'radiance':
                    if gc.tag == 'spectrum':
                        pairs = parse_spectrum_pairs(gc.get('value'))
                        if len(pairs) == 1:
                            # single-value spectrum scales the white point
                            # XYZ(0.9505, 1.0, 1.0888) (parse_scene.cpp:941-948)
                            xyz = np.array([0.9505, 1.0, 1.0888]) * pairs[0][1]
                            radiance = xyz_to_rgb(xyz)
                        else:
                            radiance = _spectrum_to_rgb(pairs)
                    elif gc.tag == 'rgb':
                        radiance = parse_vector3(gc.get('value'))
                    elif gc.tag == 'srgb':
                        radiance = srgb_to_linear(parse_srgb(gc.get('value')))
            shape.area_light_id = len(b.lights)
            b.lights.append(LightB(type=T.LIGHT_AREA,
                                   shape_id=len(b.shapes),
                                   intensity=tuple(radiance)))
    return shape


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def parse_scene_xml(root, ctx):
    b = ctx.b
    for child in root:
        tag = child.tag
        if tag == 'integrator':
            b.options = parse_integrator(child, b.options)
        elif tag == 'sensor':
            cam, filename, spp, ftype, fparam = parse_sensor(child, ctx)
            b.camera = cam
            b.options = _replace_opts(b.options, samples_per_pixel=spp,
                                      output_filename=filename,
                                      filter_type=ftype, filter_param=fparam)
        elif tag == 'bsdf':
            mname, m = parse_bsdf(child, ctx)
            if mname:
                ctx.material_map[mname] = len(b.materials)
                b.materials.append(m)
        elif tag == 'shape':
            b.shapes.append(parse_shape(child, ctx))
        elif tag == 'texture':
            tid = child.get('id')
            if tid in ctx.texture_map:
                raise ValueError(f"duplicated texture ID: {tid}")
            ctx.texture_map[tid] = parse_texture(child)
        elif tag == 'emitter':
            typ = child.get('type')
            if typ != 'envmap':
                raise ValueError(f"unknown emitter type: {typ}")
            filename = None
            scale = 1.0
            to_world = xf.identity()
            for gc in child:
                name = gc.get('name')
                if name == 'filename':
                    filename = gc.get('value')
                elif name == 'toWorld':
                    to_world = parse_transform(gc)
                elif name == 'scale':
                    scale = float(gc.get('value'))
            if not filename:
                raise ValueError("filename unspecified for envmap")
            img_id = b.texture_pool.insert("__envmap_texture__",
                                           imread3(filename))
            b.envmap_light_id = len(b.lights)
            b.lights.append(LightB(type=T.LIGHT_ENVMAP, image_id=img_id,
                                   to_world=to_world, scale=scale))
        elif tag == 'medium':
            mname, med = parse_medium(child, ctx)
            if mname:
                ctx.medium_map[mname] = len(b.media)
                b.media.append(med)
    return b


def parse_scene_to_builder(path):
    tree = ET.parse(path)
    root = tree.getroot()
    if root.tag != 'scene':
        root = root.find('scene')
    ctx = _Ctx()
    old_cwd = os.getcwd()
    scene_dir = os.path.dirname(os.path.abspath(path))
    os.chdir(scene_dir)  # relative asset paths, like parse_scene.cpp:1142-1147
    try:
        b = parse_scene_xml(root, ctx)
    finally:
        os.chdir(old_cwd)
    return b


def parse_scene(path):
    """Parse (the span `scene.parse`) + compile (`scene.compile`) to the
    Scene on the CPU. Returns (scene, options)."""
    from lajolla_tpu_torch.scene.compile import compile_scene
    with profiling.span('scene.parse'):
        b = parse_scene_to_builder(path)
    return compile_scene(b), b.options
