"""Scene fixtures built in code (tests, the chip smoke run, examples).

Ports the path-tracing fixtures of lajolla_tpu/testing.py and adds two of
the classes the fused kernels serve: a Cornell box (cbox class: Lambertian
walls, two boxes, one quad area light) and a sphere-light scene (veach
class: RoughPlastic + Lambertian, sphere and mesh lights). Both are also
available as SceneBuilders (`*_builder`), which lajolla_tpu's own
compile_scene accepts as well, so tests can compile one builder with
both packages.

The Cornell box has a "glass" variant for the general engine: the tall
box RoughDielectric, the short box RoughPlastic and a checkerboard floor
(three material types and uv lookups, so outside path_kernel.supports),
and a "disney" variant with the six Disney BSDFs, one a surface
(CBOX_DISNEY_SHAPES), a checkerboard base color and a roughness image.
Its volumetric variants render under the volpath integrator, with one
homogeneous medium bound to the sensor and to every shape's exterior:
"vol" (isotropic) and "vol_hg" (Henyey-Greenstein) lie inside
volpath_kernel.supports (kernel K8); "vol_glass" adds a denser medium
inside a RoughDielectric tall box and inside a short box with no BSDF
(an index-matching interface), over the checkerboard floor, for the
general volumetric engine. Its heterogeneous variants ("hetvol",
"hetvol_hg", "hetvol_smooth") put a grid medium, read from a .vol file
that `write_vol` writes, inside a BSDF-less cube in a vacuum room: the
first two lie inside volpath_grid_kernel.supports (kernel K9), the smooth
one takes the general engine's event machine. Its "mesh" variant replaces
the short box by a RoughPlastic displaced sphere of a chosen triangle
count (`displaced_sphere`, written as mesh.obj by `write_obj`): from 192
triangles on the scene compiles a BVH and cluster tables and its casts go
to the cluster sweeps, kernels K4-K7.
"""

import os
import time

import numpy as np

from lajolla_tpu_torch.core import transform as xf
from lajolla_tpu_torch.io.obj import _compute_smooth_normals
from lajolla_tpu_torch.io.pfm import write_pfm
from lajolla_tpu_torch.scene import types as T
from lajolla_tpu_torch.scene.compile import compile_scene
from lajolla_tpu_torch.scene.parser import (CameraB, LightB, MaterialB,
                                            MediumB, MeshB, SceneBuilder,
                                            ShapeB, TexDesc, VolumeB)
from lajolla_tpu_torch.scene.texture import TexturePool
from lajolla_tpu_torch.scene.types import RenderOptions

MATERIAL_XML_TYPES = {
    'diffuse': T.MAT_LAMBERTIAN,
    'roughplastic': T.MAT_ROUGH_PLASTIC,
    'roughdielectric': T.MAT_ROUGH_DIELECTRIC,
    'disneydiffuse': T.MAT_DISNEY_DIFFUSE,
    'disneymetal': T.MAT_DISNEY_METAL,
    'disneyglass': T.MAT_DISNEY_GLASS,
    'disneyclearcoat': T.MAT_DISNEY_CLEARCOAT,
    'disneysheen': T.MAT_DISNEY_SHEEN,
    'disneybsdf': T.MAT_DISNEY_BSDF,
}


def quad_mesh(z=0.0, half=1.0):
    return MeshB(
        positions=np.array([[-half, -half, z], [half, -half, z],
                            [half, half, z], [-half, half, z]], np.float64),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        normals=np.array([[0, 0, 1]] * 4, np.float64),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64))


def _const_tex(b, v):
    v = np.broadcast_to(np.asarray(v, np.float64), (3,))
    b.texdescs.append(TexDesc(kind=T.TEX_CONSTANT, const=tuple(v)))
    return len(b.texdescs) - 1


def make_white_box_scene(albedo=0.9, emission=0.3, res=8):
    """Camera inside a closed emissive diffuse cube: every wall both
    emits Le and reflects with albedo rho, so the uniform equilibrium
    radiance is analytic, L = Le / (1 - rho) — a deep-path fixture
    (mean path length 1/(1 - rho)) that gates the MAX_BOUNCES_CAP
    truncation bias."""
    b = SceneBuilder(camera=CameraB(to_world=xf.look_at(
        [0, 0, 0], [0, 0, 1], [0, 1, 0]), fov=45.0, width=res, height=res),
        options=RenderOptions(max_depth=-1), texture_pool=TexturePool())
    m = MaterialB(type=T.MAT_LAMBERTIAN)
    m.tex[T.P_BASE_COLOR] = _const_tex(b, (albedo,) * 3)
    b.materials.append(m)
    # 12 triangles wound so geometric normals face INWARD (one-sided area
    # emission toward the camera). Each face owns its 4 vertices + flat
    # normals: shared corners would get smooth (diagonal) normals.
    pos, nrm, idx = [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            u_ax, v_ax = (axis + 1) % 3, (axis + 2) % 3
            quad = []
            for (su, sv) in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3)
                p[axis] = sign
                p[u_ax] = su
                p[v_ax] = sv
                quad.append(p)
            n_in = np.zeros(3)
            n_in[axis] = -sign                 # inward
            fn = np.cross(quad[1] - quad[0], quad[2] - quad[0])
            if np.dot(fn, n_in) < 0:
                quad = quad[::-1]
            base = len(pos)
            pos.extend(quad)
            nrm.extend([n_in] * 4)
            idx.append([base, base + 1, base + 2])
            idx.append([base, base + 2, base + 3])
    mesh = MeshB(positions=np.array(pos, np.float64),
                 indices=np.array(idx, np.int32),
                 normals=np.array(nrm, np.float64))
    b.shapes.append(ShapeB(type=T.SHAPE_MESH, mesh=mesh, material_id=0,
                           area_light_id=0))
    b.lights.append(LightB(type=T.LIGHT_AREA, shape_id=0,
                           intensity=(emission,) * 3))
    return compile_scene(b)


def make_single_material_scene(mat_xml_type, params=None, eta=1.5):
    """One quad with the given material, a white area light quad above,
    camera looking down."""
    b = SceneBuilder(camera=CameraB(to_world=xf.look_at(
        [0, 0, 3], [0, 0, 0], [0, 1, 0]), fov=45.0, width=32, height=32),
        options=RenderOptions(), texture_pool=TexturePool())
    m = MaterialB(type=MATERIAL_XML_TYPES[mat_xml_type], eta=eta)
    defaults = {
        T.P_BASE_COLOR: (0.5, 0.5, 0.5), T.P_AUX_COLOR: (1.0, 1.0, 1.0),
        T.P_ROUGHNESS: 0.25, T.P_SUBSURFACE: 0.0, T.P_METALLIC: 0.0,
        T.P_SPECULAR: 0.5, T.P_SPECULAR_TINT: 0.0, T.P_ANISOTROPIC: 0.0,
        T.P_SHEEN: 0.0, T.P_SHEEN_TINT: 0.5, T.P_CLEARCOAT: 0.0,
        T.P_CLEARCOAT_GLOSS: 1.0, T.P_SPEC_TRANS: 0.0,
    }
    defaults.update(params or {})
    for slot, v in defaults.items():
        m.tex[slot] = _const_tex(b, v)
    b.materials.append(m)
    b.shapes.append(ShapeB(type=T.SHAPE_MESH, mesh=quad_mesh(0.0),
                           material_id=0))
    b.shapes.append(ShapeB(type=T.SHAPE_MESH, mesh=quad_mesh(2.0),
                           material_id=0, area_light_id=0))
    b.lights.append(LightB(type=T.LIGHT_AREA, shape_id=1,
                           intensity=(5.0, 5.0, 5.0)))
    return compile_scene(b)


# ---------------------------------------------------------------------------
# Cornell box
# ---------------------------------------------------------------------------

CBOX_MATERIALS = {'white': (0.73, 0.73, 0.73), 'red': (0.63, 0.065, 0.05),
                  'green': (0.14, 0.45, 0.091)}
CBOX_LIGHT_RADIANCE = (17.0, 12.0, 4.0)
CBOX_CAMERA = dict(origin=(0.0, 0.0, 3.9), target=(0.0, 0.0, 0.0),
                   up=(0.0, 1.0, 0.0), fov=40.0)


def _box_faces(center, half, angle_deg):
    """The 5 outward-wound faces (no bottom) of a box turned about +y."""
    c = np.asarray(center, np.float64)
    hx, hy, hz = half
    R = xf.rotate(angle_deg, [0, 1, 0])[:3, :3]

    def P(x, y, z):
        return c + R @ np.array([x * hx, y * hy, z * hz])
    return [
        [P(-1, 1, -1), P(-1, 1, 1), P(1, 1, 1), P(1, 1, -1)],      # top
        [P(-1, -1, 1), P(1, -1, 1), P(1, 1, 1), P(-1, 1, 1)],      # +z
        [P(1, -1, -1), P(-1, -1, -1), P(-1, 1, -1), P(1, 1, -1)],  # -z
        [P(1, -1, 1), P(1, -1, -1), P(1, 1, -1), P(1, 1, 1)],      # +x
        [P(-1, -1, -1), P(-1, -1, 1), P(-1, 1, 1), P(-1, 1, -1)],  # -x
    ]


def _cbox_shapes():
    """[(name, material, quads, emitter)]: the room [-1, 1]^3 open toward
    +z (walls wound to face inward), two boxes and a ceiling light
    facing down. Each quad is (p0, p1, p2, p3), split (0,1,2) (0,2,3)."""
    q = np.array
    return [
        ('floor', 'white', [q([[-1, -1, -1], [-1, -1, 1], [1, -1, 1],
                               [1, -1, -1]])], False),
        ('ceiling', 'white', [q([[-1, 1, -1], [1, 1, -1], [1, 1, 1],
                                 [-1, 1, 1]])], False),
        ('back', 'white', [q([[-1, -1, -1], [1, -1, -1], [1, 1, -1],
                              [-1, 1, -1]])], False),
        ('left', 'red', [q([[-1, -1, -1], [-1, 1, -1], [-1, 1, 1],
                            [-1, -1, 1]])], False),
        ('right', 'green', [q([[1, -1, -1], [1, -1, 1], [1, 1, 1],
                               [1, 1, -1]])], False),
        ('short_box', 'white',
         _box_faces((0.35, -0.7, 0.3), (0.3, 0.3, 0.3), -17.0), False),
        ('tall_box', 'white',
         _box_faces((-0.35, -0.4, -0.35), (0.3, 0.6, 0.3), 17.0), False),
        ('light', 'white', [q([[-0.25, 0.98, -0.2], [0.25, 0.98, -0.2],
                               [0.25, 0.98, 0.2], [-0.25, 0.98, 0.2]])],
         True),
    ]


def _quads_mesh(quads):
    """Positions and (0,1,2) (0,2,3) triangles, 4 own vertices per quad
    (OBJ `f a b c d` semantics)."""
    pos = np.concatenate([np.asarray(qd, np.float64) for qd in quads])
    idx = []
    for k in range(len(quads)):
        idx += [[4 * k, 4 * k + 1, 4 * k + 2], [4 * k, 4 * k + 2, 4 * k + 3]]
    return pos, np.array(idx, np.int32)


# The glass variant: checkerboard floor, RoughPlastic short box and
# RoughDielectric tall box (eta = intIOR / extIOR = 1.5).
CBOX_CHECKER = dict(color0=(0.75, 0.75, 0.75), color1=(0.25, 0.25, 0.25),
                    uvscale=4.0)
CBOX_PLASTIC = dict(diffuse=(0.2, 0.3, 0.6), roughness=0.15)
CBOX_GLASS_ROUGHNESS = 0.1
CBOX_IOR = (1.5, 1.0)
CBOX_GLASS_SHAPES = {'floor': 'checker', 'short_box': 'plastic',
                     'tall_box': 'glass'}
# The floor's OBJ texture coordinates (`vt` lines); the loader flips v.
CBOX_FLOOR_VT = ((0.0, 0.0), (0.0, 1.0), (1.0, 1.0), (1.0, 0.0))
CBOX_VARIANTS = (None, 'glass', 'vol', 'vol_hg', 'vol_glass', 'hetvol',
                 'hetvol_hg', 'hetvol_smooth', 'mesh', 'disney')
# The Disney variant: one Disney BSDF a surface, the ceiling and the light
# Lambertian as in the box. Each material is its XML type and its
# children in XML order: (name, value), a value being a float, an RGB
# triple, or the id of a texture (CBOX_DISNEY_TEXTURES) for a <ref>.
# 'eta' sets the IOR. The all-lobe DisneyBSDF lies on the floor, whose
# uvs carry its checkerboard base color; the metal's roughness is a
# checkerboard image (a bitmap: neither parser reads a procedural float
# texture).
CBOX_DISNEY_SHAPES = {'floor': 'disneybsdf', 'back': 'disneysheen',
                      'left': 'disneydiffuse', 'right': 'disneyclearcoat',
                      'short_box': 'disneyglass', 'tall_box': 'disneymetal'}
CBOX_DISNEY_MATERIALS = {
    'disneydiffuse': [('baseColor', (0.63, 0.065, 0.05)),
                      ('roughness', 0.6), ('subsurface', 0.5)],
    'disneymetal': [('baseColor', (0.9, 0.75, 0.5)),
                    ('roughness', 'rough_tex'), ('anisotropic', 0.5)],
    'disneyglass': [('baseColor', (0.9, 0.95, 1.0)), ('roughness', 0.2),
                    ('anisotropic', 0.3), ('eta', 1.5)],
    'disneyclearcoat': [('clearcoatGloss', 0.6)],
    'disneysheen': [('baseColor', (0.73, 0.73, 0.73)), ('sheenTint', 0.5)],
    'disneybsdf': [('baseColor', 'checker_tex'),
                   ('specularTransmission', 0.2), ('metallic', 0.3),
                   ('subsurface', 0.4), ('specular', 0.5),
                   ('roughness', 0.35), ('specularTint', 0.3),
                   ('anisotropic', 0.5), ('sheen', 0.6), ('sheenTint', 0.5),
                   ('clearcoat', 0.6), ('clearcoatGloss', 0.7),
                   ('eta', 1.5)],
}
# The roughness image: 8x8 pixels of 0.25 and 0.5 in a checkerboard of
# 2-pixel squares (values whose channel mean is exact, so the image reads
# back bit-equal), written beside the XML as a PFM file, uv scale 2.
CBOX_DISNEY_TEXTURES = {'checker_tex': 'checkerboard',
                        'rough_tex': 'roughness.pfm'}
CBOX_DISNEY_ROUGH_SCALE = 2.0
# The Disney box's mean luminance: 0.0935-0.0939 in the port's CPU films at
# 64x64 x 16 spp (seeds 0, 1) and 96x96 x 8 spp; a finite film of any
# size and spp whose mean lies outside this range is wrong.
CBOX_DISNEY_LUMINANCE = (0.075, 0.115)
# Materials of the floor that carry its texture coordinates
_FLOOR_UV_MATERIALS = ('checker', 'disneybsdf')
# The mesh variant: a displaced sphere ('mesh', RoughPlastic) where the
# short box stands. MESH_TRIANGLES is its default triangle count (the
# nearest count a latitude-longitude grid gives is used).
MESH_TRIANGLES = 440
# The mesh Cornell box at SEAM_TRIANGLES triangles on a 64x64 film: the
# (row, column) pixels whose pixel-centre rays run exactly along a wall
# seam (on the film's diagonals) and that lajolla_tpu's cluster sweep
# misses in Pallas interpret mode, where the port's plain sweep hits
# them (a fault of the reference).
SEAM_TRIANGLES = 2000
SEAM_PIXELS = ((3, 3), (6, 6), (7, 7), (7, 56), (56, 7), (56, 56), (57, 6),
               (60, 3))
MESH_SPHERE = dict(center=(0.35, -0.66, 0.3), radius=0.3, amplitude=0.1,
                   waves=6, seed=77)

# The volumetric variants' medium 0, around and inside the room. Its
# coefficients are chromatic so that the free flight's channel pick and
# the spectral MIS matter; they are this fixture's own.
CBOX_MEDIUM = dict(sigma_a=(0.10, 0.15, 0.20), sigma_s=(0.60, 0.50, 0.40))
CBOX_HG_G = 0.4
# 'vol_glass': medium 1 fills the RoughDielectric tall box and the short
# box, whose surface has no BSDF (an index-matching interface)
CBOX_INNER_MEDIUM = dict(sigma_a=(0.4, 0.6, 0.8), sigma_s=(1.6, 1.4, 1.2),
                         g=-0.3)
CBOX_VOL_GLASS_SHAPES = {'floor': 'checker', 'tall_box': 'glass',
                         'short_box': None}
CBOX_INNER_SHAPES = ('tall_box', 'short_box')
# The heterogeneous variants ('hetvol', 'hetvol_hg', 'hetvol_smooth'): in
# place of the tall box an axis-aligned closed cube with no BSDF (an
# index-matching interface) whose interior is medium 0, a heterogeneous
# medium: a mono density grid read from a .vol file written beside the
# XML, a constant albedo and an isotropic phase (HG g CBOX_HG_G for
# 'hetvol_hg'). Outside the cube and at the camera is vacuum; the short
# box is RoughPlastic. HETVOL_GRID_RES (X, Y, Z) is the hetvol class's
# grid size. The density (hetvol_density) is wispy, so that the scene is
# inside the fused grid kernel's class; 'hetvol_smooth' is positive
# everywhere, for the general engine's residual ratio tracking.
HETVOL_VARIANTS = ('hetvol', 'hetvol_hg', 'hetvol_smooth')
HETVOL_GRID_RES = (128, 128, 50)
HETVOL_CUBE = dict(center=(-0.4, -0.55, -0.4), half=0.4)
HETVOL_ALBEDO = 0.8
HETVOL_SEED = 2024
HETVOL_SHAPES = {'short_box': 'plastic'}


def _checker_material(b, mat_ids):
    """Each material's texture descriptors go in the parser's order (each
    BSDF's defaults first, then its children)."""
    m = MaterialB(type=T.MAT_LAMBERTIAN)
    _const_tex(b, (0.5, 0.5, 0.5))
    b.texdescs.append(TexDesc(
        kind=T.TEX_CHECKERBOARD, const=CBOX_CHECKER['color0'],
        color1=CBOX_CHECKER['color1'], uscale=CBOX_CHECKER['uvscale'],
        vscale=CBOX_CHECKER['uvscale']))
    m.tex[T.P_BASE_COLOR] = len(b.texdescs) - 1
    mat_ids['checker'] = len(b.materials)
    b.materials.append(m)


def _plastic_material(b, mat_ids):
    eta = CBOX_IOR[0] / CBOX_IOR[1]
    m = MaterialB(type=T.MAT_ROUGH_PLASTIC, eta=eta)
    _const_tex(b, (0.5, 0.5, 0.5))
    m.tex[T.P_AUX_COLOR] = _const_tex(b, (1.0, 1.0, 1.0))
    _const_tex(b, 0.1)
    m.tex[T.P_BASE_COLOR] = _const_tex(b, CBOX_PLASTIC['diffuse'])
    m.tex[T.P_ROUGHNESS] = _const_tex(b, CBOX_PLASTIC['roughness'])
    mat_ids['plastic'] = len(b.materials)
    b.materials.append(m)


def _glass_materials(b, mat_ids):
    """Append the glass variant's materials."""
    _checker_material(b, mat_ids)
    _plastic_material(b, mat_ids)
    eta = CBOX_IOR[0] / CBOX_IOR[1]
    m = MaterialB(type=T.MAT_ROUGH_DIELECTRIC, eta=eta)
    m.tex[T.P_BASE_COLOR] = _const_tex(b, (1.0, 1.0, 1.0))
    m.tex[T.P_AUX_COLOR] = _const_tex(b, (1.0, 1.0, 1.0))
    _const_tex(b, 0.1)
    m.tex[T.P_ROUGHNESS] = _const_tex(b, CBOX_GLASS_ROUGHNESS)
    mat_ids['glass'] = len(b.materials)
    b.materials.append(m)


# The parser's parameter slots and defaults of each Disney type
# (scene/parser.py parse_bsdf), in the order it emits the defaults.
_DISNEY_SLOTS = {
    'baseColor': T.P_BASE_COLOR, 'specularTransmission': T.P_SPEC_TRANS,
    'metallic': T.P_METALLIC, 'subsurface': T.P_SUBSURFACE,
    'specular': T.P_SPECULAR, 'roughness': T.P_ROUGHNESS,
    'specularTint': T.P_SPECULAR_TINT, 'anisotropic': T.P_ANISOTROPIC,
    'sheen': T.P_SHEEN, 'sheenTint': T.P_SHEEN_TINT,
    'clearcoat': T.P_CLEARCOAT, 'clearcoatGloss': T.P_CLEARCOAT_GLOSS}
_GRAY = (0.5, 0.5, 0.5)
_DISNEY_DEFAULTS = {
    'disneydiffuse': [('baseColor', _GRAY), ('roughness', 0.5),
                      ('subsurface', 0.0)],
    'disneymetal': [('baseColor', _GRAY), ('roughness', 0.5),
                    ('anisotropic', 0.0)],
    'disneyglass': [('baseColor', _GRAY), ('roughness', 0.5),
                    ('anisotropic', 0.0)],
    'disneyclearcoat': [('clearcoatGloss', 1.0)],
    'disneysheen': [('baseColor', _GRAY), ('sheenTint', 0.5)],
    'disneybsdf': [('baseColor', _GRAY), ('specularTransmission', 0.0),
                   ('metallic', 0.0), ('subsurface', 0.0),
                   ('specular', 0.5), ('roughness', 0.5),
                   ('specularTint', 0.0), ('anisotropic', 0.0),
                   ('sheen', 0.0), ('sheenTint', 0.5), ('clearcoat', 0.0),
                   ('clearcoatGloss', 1.0)],
}


def disney_roughness_image():
    """The Disney variant's roughness image, (8, 8) float32."""
    y, x = np.mgrid[0:8, 0:8]
    return np.where((x // 2 + y // 2) % 2 == 0, 0.25, 0.5).astype(
        np.float32)


def _disney_texture(b, ref):
    """The texture descriptor the parser makes for a <ref> to `ref`."""
    if CBOX_DISNEY_TEXTURES[ref] == 'checkerboard':
        uv = CBOX_CHECKER['uvscale']
        b.texdescs.append(TexDesc(
            kind=T.TEX_CHECKERBOARD, const=CBOX_CHECKER['color0'],
            color1=CBOX_CHECKER['color1'], uscale=uv, vscale=uv))
    else:
        img_id = b.texture_pool.insert(ref, disney_roughness_image())
        b.texdescs.append(TexDesc(
            kind=T.TEX_IMAGE, image_id=img_id,
            uscale=CBOX_DISNEY_ROUGH_SCALE, vscale=CBOX_DISNEY_ROUGH_SCALE))
    return len(b.texdescs) - 1


def _disney_materials(b, mat_ids):
    """Append the Disney variant's materials, each keyed by its type."""
    for typ, children in CBOX_DISNEY_MATERIALS.items():
        m = MaterialB(type=MATERIAL_XML_TYPES[typ])
        for name, v in _DISNEY_DEFAULTS[typ] + children:
            if name == 'eta':
                m.eta = v
            elif isinstance(v, str):
                m.tex[_DISNEY_SLOTS[name]] = _disney_texture(b, v)
            else:
                m.tex[_DISNEY_SLOTS[name]] = _const_tex(b, v)
        mat_ids[typ] = len(b.materials)
        b.materials.append(m)


def _check_variant(variant):
    if variant not in CBOX_VARIANTS:
        raise ValueError(f"unknown Cornell box variant {variant!r}")


def _is_vol(variant):
    return variant in ('vol', 'vol_hg', 'vol_glass') + HETVOL_VARIANTS


def displaced_sphere(triangles=MESH_TRIANGLES):
    """(positions (V, 3), indices (T, 3) int32, uvs (V, 2)) of the mesh
    variant's sphere: a latitude-longitude grid of n rings and 2n
    meridians with shared vertices and one vertex per pole, T = 4n(n - 1)
    triangles with n the count nearest `triangles`, wound outward. Each
    vertex is pushed along its direction by MESH_SPHERE['waves'] plane
    waves over the sphere with numpy-seeded directions, frequencies and
    phases, so the surface is smooth, closed and nowhere flat. Vertices
    are numbered in the order the faces first name them, which is the
    order an OBJ reader gives them."""
    n = max(3, int(round(0.5 + np.sqrt(0.25 + triangles / 4.0))))
    m = 2 * n
    ms = MESH_SPHERE
    rng = np.random.default_rng(ms['seed'])
    k = rng.normal(size=(ms['waves'], 3))
    k *= rng.uniform(2.0, 7.0, ms['waves'])[:, None] / \
        np.linalg.norm(k, axis=1, keepdims=True)
    phase = rng.uniform(0.0, 2.0 * np.pi, ms['waves'])
    theta = np.concatenate([[0.0], np.repeat(np.arange(1, n) * np.pi / n, m),
                            [np.pi]])
    phi = np.concatenate([[0.0], np.tile(np.arange(m) * 2.0 * np.pi / m,
                                         n - 1), [0.0]])
    dirs = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                     np.sin(theta) * np.sin(phi)], axis=1)
    bump = np.sin(dirs @ k.T + phase).mean(axis=1)
    pos = np.asarray(ms['center']) + \
        ms['radius'] * (1.0 + ms['amplitude'] * bump)[:, None] * dirs
    ring = lambda r: 1 + (r - 1) * m + np.arange(m)      # ring r = 1..n-1
    nxt = lambda a: np.roll(a, -1)
    top, bottom = np.zeros(m, np.int64), np.full(m, 1 + (n - 1) * m)
    tris = [np.stack([top, nxt(ring(1)), ring(1)], axis=1)]
    for r in range(1, n - 1):
        a, b = ring(r), ring(r + 1)
        quad = np.stack([np.stack([a, nxt(b), b], axis=1),
                         np.stack([a, nxt(a), nxt(b)], axis=1)], axis=1)
        tris.append(quad.reshape(-1, 3))
    tris.append(np.stack([ring(n - 1), nxt(ring(n - 1)), bottom], axis=1))
    uvs = np.stack([phi / (2.0 * np.pi), theta / np.pi], axis=1)
    idx = np.concatenate(tris).astype(np.int32)
    # number the vertices by first appearance in the faces
    _, first = np.unique(idx.reshape(-1), return_index=True)
    order = idx.reshape(-1)[np.sort(first)]
    rank = np.empty(len(pos), np.int64)
    rank[order] = np.arange(len(order))
    return pos[order], rank[idx].astype(np.int32), uvs[order]


def write_obj(path, positions, indices, uvs=None):
    """Write a triangle mesh as Wavefront OBJ: `v` lines, `vt` lines where
    uvs (V, 2) is given (io/obj.load_obj flips their v), `f` lines of
    1-based `i` or `i/i` corners. Coordinates are written with repr, so
    load_obj reads back the same float64 values; it computes smooth
    normals itself."""
    with open(path, 'w') as f:
        f.write(''.join('v ' + ' '.join(repr(float(x)) for x in p) + '\n'
                        for p in positions))
        if uvs is not None:
            f.write(''.join('vt ' + ' '.join(repr(float(x)) for x in t) +
                            '\n' for t in uvs))
        corner = '{0}/{0}' if uvs is not None else '{0}'
        f.write(''.join('f ' + ' '.join(corner.format(i + 1) for i in tri) +
                        '\n' for tri in indices.tolist()))


def _shape_material(variant, name, mat):
    """The material name of shape `name` in `variant` (None: no BSDF)."""
    if variant == 'glass':
        return CBOX_GLASS_SHAPES.get(name, mat)
    if variant == 'vol_glass':
        return CBOX_VOL_GLASS_SHAPES.get(name, mat)
    if variant in HETVOL_VARIANTS:
        return HETVOL_SHAPES.get(name, mat)
    if variant == 'disney':
        return CBOX_DISNEY_SHAPES.get(name, mat)
    return mat


def _film(res):
    """(width, height) of a film given as one size or a (w, h) pair."""
    return (res, res) if np.isscalar(res) else tuple(res)


def _variant_shapes(variant):
    """_cbox_shapes, with the tall box replaced by the heterogeneous
    variants' closed cube ('cube', no BSDF, six outward-wound faces), or
    the short box by the mesh variant's sphere ('mesh', RoughPlastic,
    quads None: its triangles come from displaced_sphere)."""
    shapes = _cbox_shapes()
    if variant == 'mesh':
        return [('mesh', 'plastic', None, False) if shape[0] == 'short_box'
                else shape for shape in shapes]
    if variant not in HETVOL_VARIANTS:
        return shapes
    c = np.asarray(HETVOL_CUBE['center'], np.float64)
    h = HETVOL_CUBE['half']
    faces = _box_faces(c, (h, h, h), 0.0)
    faces.append([c + h * np.array(p, np.float64) for p in
                  ((-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1))])
    return [('cube', None, faces, False) if name == 'tall_box' else
            (name, mat, quads, emitter)
            for name, mat, quads, emitter in shapes]


def hetvol_box():
    """(pmin, pmax) of the heterogeneous variants' grid: the cube, as the
    float32 bounding box a .vol file stores."""
    c = np.asarray(HETVOL_CUBE['center'], np.float64)
    h = HETVOL_CUBE['half']
    return (tuple(np.float32(c - h).astype(np.float64)),
            tuple(np.float32(c + h).astype(np.float64)))


def hetvol_density(grid_res=HETVOL_GRID_RES, smooth=False,
                   seed=HETVOL_SEED):
    """The heterogeneous variants' mono density, (Z, Y, X) float32, for a
    grid of grid_res = (X, Y, Z) nodes: twelve Gaussian puffs with
    numpy-seeded centres, widths and heights over [0, 1]^3. Wispy (the
    default): the sum less a threshold, clipped at 0, and zero on every
    4th x slice. Smooth: the sum plus a floor, positive everywhere."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = grid_res
    z, y, x = np.meshgrid(np.linspace(0.0, 1.0, nz),
                          np.linspace(0.0, 1.0, ny),
                          np.linspace(0.0, 1.0, nx), indexing='ij')
    d = np.zeros((nz, ny, nx))
    for _ in range(12):
        cx, cy, cz = rng.uniform(0.15, 0.85, 3)
        s = rng.uniform(0.08, 0.2)
        a = rng.uniform(2.0, 8.0)
        d += a * np.exp(-((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) /
                        (2.0 * s * s))
    if smooth:
        return (d + 0.5).astype(np.float32)
    d = np.maximum(d - 1.0, 0.0)
    d[:, :, ::4] = 0.0
    return d.astype(np.float32)


def write_vol(path, grid, pmin, pmax):
    """Write a Mitsuba .vol file, the format io/vol.load_vol reads: grid
    (Z, Y, X) or (Z, Y, X, C) float32 with C 1 or 3, bounding box pmin,
    pmax."""
    g = np.asarray(grid, np.float32)
    if g.ndim == 3:
        g = g[..., None]
    nz, ny, nx, ch = g.shape
    with open(path, 'wb') as f:
        f.write(b'VOL' + bytes([3]))
        f.write(np.array([1, nx, ny, nz, ch], '<i4').tobytes())
        f.write(np.array(list(pmin) + list(pmax), '<f4').tobytes())
        f.write(np.ascontiguousarray(g, '<f4').tobytes())


def _cbox_media(variant):
    """[(sigma_a, sigma_s, g or None for isotropic)] of the variant's
    homogeneous media, in id order."""
    if not _is_vol(variant) or variant in HETVOL_VARIANTS:
        return []
    g = CBOX_HG_G if variant == 'vol_hg' else None
    media = [(CBOX_MEDIUM['sigma_a'], CBOX_MEDIUM['sigma_s'], g)]
    if variant == 'vol_glass':
        m = CBOX_INNER_MEDIUM
        media.append((m['sigma_a'], m['sigma_s'], m['g']))
    return media


def _hetvol_phase(variant):
    """The heterogeneous variants' phase: None for isotropic, else HG g."""
    return CBOX_HG_G if variant == 'hetvol_hg' else None


def _hetvol_medium(b, variant, grid_res):
    """Append the heterogeneous variants' volumes (the density grid, the
    constant albedo) and medium 0, in the parser's order."""
    pmin, pmax = hetvol_box()
    g = hetvol_density(grid_res, smooth=variant == 'hetvol_smooth')
    b.volumes.append(VolumeB(kind=T.VOL_GRID, pmin=pmin, pmax=pmax,
                             grid=np.repeat(g[..., None], 3, axis=-1)))
    b.volumes.append(VolumeB(kind=T.VOL_CONSTANT,
                             const=(HETVOL_ALBEDO,) * 3))
    g_hg = _hetvol_phase(variant)
    b.media.append(MediumB(
        type=T.MED_HETEROGENEOUS, density_vol=0, albedo_vol=1,
        phase_type=T.PHASE_ISOTROPIC if g_hg is None else T.PHASE_HG,
        g=0.0 if g_hg is None else g_hg))


def cornell_box_builder(res, spp=4, variant=None, grid_res=HETVOL_GRID_RES,
                        triangles=MESH_TRIANGLES):
    """The Cornell box as a SceneBuilder — the same scene the parser
    builds from write_cornell_box_xml. res: the film, one size or (width,
    height). variant='glass' gives the glass Cornell box
    (CBOX_GLASS_SHAPES); 'vol', 'vol_hg' and 'vol_glass' the homogeneous
    volumetric variants (CBOX_MEDIUM, CBOX_VOL_GLASS_SHAPES); 'hetvol',
    'hetvol_hg' and 'hetvol_smooth' the heterogeneous ones (HETVOL_*),
    with a density grid of grid_res = (X, Y, Z) nodes; 'mesh' the
    displaced sphere of about `triangles` triangles (MESH_SPHERE);
    'disney' the six Disney BSDFs (CBOX_DISNEY_SHAPES)."""
    _check_variant(variant)
    vol = _is_vol(variant)
    het = variant in HETVOL_VARIANTS
    w, h = _film(res)
    b = SceneBuilder(camera=CameraB(
        to_world=xf.look_at(CBOX_CAMERA['origin'], CBOX_CAMERA['target'],
                            CBOX_CAMERA['up']),
        fov=CBOX_CAMERA['fov'], width=w, height=h,
        medium_id=0 if vol and not het else -1),
        options=RenderOptions(integrator='volpath' if vol else 'path',
                              samples_per_pixel=spp),
        texture_pool=TexturePool())
    if het:
        _hetvol_medium(b, variant, grid_res)
    for sigma_a, sigma_s, g in _cbox_media(variant):
        b.media.append(MediumB(
            sigma_a=sigma_a, sigma_s=sigma_s,
            phase_type=T.PHASE_ISOTROPIC if g is None else T.PHASE_HG,
            g=0.0 if g is None else g))
    mat_ids = {}
    for name, rgb in CBOX_MATERIALS.items():
        m = MaterialB(type=T.MAT_LAMBERTIAN)
        # texture descriptors in the parser's order (its default
        # reflectance first), so every table equals the parsed XML's
        _const_tex(b, (0.5, 0.5, 0.5))
        m.tex[T.P_BASE_COLOR] = _const_tex(b, rgb)
        mat_ids[name] = len(b.materials)
        b.materials.append(m)
    if variant in ('glass', 'vol_glass'):
        _glass_materials(b, mat_ids)
    elif het or variant == 'mesh':
        _plastic_material(b, mat_ids)
    elif variant == 'disney':
        _disney_materials(b, mat_ids)
    for name, mat, quads, emitter in _variant_shapes(variant):
        if quads is None:
            pos, idx, uvs = displaced_sphere(triangles)
        else:
            (pos, idx), uvs = _quads_mesh(quads), None
        mesh = MeshB(positions=pos, indices=idx,
                     normals=_compute_smooth_normals(pos, idx))
        if uvs is not None:     # as load_obj reads write_obj's `vt` lines
            mesh.uvs = np.stack([uvs[:, 0], 1.0 - uvs[:, 1]], axis=1)
        mat = _shape_material(variant, name, mat)
        if mat in _FLOOR_UV_MATERIALS:
            mesh.uvs = np.array([(u, 1.0 - v) for u, v in CBOX_FLOOR_VT])
        shape = ShapeB(type=T.SHAPE_MESH, mesh=mesh,
                       material_id=-1 if mat is None else mat_ids[mat])
        if vol and not het:
            shape.exterior_medium_id = 0
        if variant == 'vol_glass' and name in CBOX_INNER_SHAPES:
            shape.interior_medium_id = 1
        if het and name == 'cube':
            shape.interior_medium_id = 0
        if emitter:
            shape.area_light_id = len(b.lights)
            b.lights.append(LightB(type=T.LIGHT_AREA,
                                   shape_id=len(b.shapes),
                                   intensity=CBOX_LIGHT_RADIANCE))
        b.shapes.append(shape)
    return b


def make_cornell_box(res, spp=4, variant=None, grid_res=HETVOL_GRID_RES,
                     triangles=MESH_TRIANGLES):
    return compile_scene(cornell_box_builder(res, spp, variant, grid_res,
                                             triangles))


def _ior_xml():
    return [f'    <float name="intIOR" value="{CBOX_IOR[0]!r}"/>',
            f'    <float name="extIOR" value="{CBOX_IOR[1]!r}"/>']


def _plastic_xml(fmt):
    """The RoughPlastic <bsdf> element."""
    rgb = lambda v: fmt(repr(float(c)) for c in v)
    return [
        '  <bsdf type="roughplastic" id="plastic">',
        f'    <rgb name="diffuseReflectance" '
        f'value="{rgb(CBOX_PLASTIC["diffuse"])}"/>',
        f'    <float name="roughness" value="{CBOX_PLASTIC["roughness"]!r}"/>',
        *_ior_xml(),
        '  </bsdf>',
    ]


def _glass_xml(fmt):
    """The glass variant's <texture> and <bsdf> elements."""
    rgb = lambda v: fmt(repr(float(c)) for c in v)
    return [
        '  <texture type="checkerboard" id="checker_tex">',
        f'    <rgb name="color0" value="{rgb(CBOX_CHECKER["color0"])}"/>',
        f'    <rgb name="color1" value="{rgb(CBOX_CHECKER["color1"])}"/>',
        f'    <float name="uvscale" value="{CBOX_CHECKER["uvscale"]!r}"/>',
        '  </texture>',
        '  <bsdf type="diffuse" id="checker">',
        '    <ref name="reflectance" id="checker_tex"/>',
        '  </bsdf>',
        *_plastic_xml(fmt),
        '  <bsdf type="roughdielectric" id="glass">',
        f'    <float name="roughness" value="{CBOX_GLASS_ROUGHNESS!r}"/>',
        *_ior_xml(),
        '  </bsdf>',
    ]


def _disney_xml(directory, fmt):
    """The Disney variant's <texture> and <bsdf> elements; writes its
    roughness image into `directory`."""
    write_pfm(os.path.join(directory, CBOX_DISNEY_TEXTURES['rough_tex']),
              disney_roughness_image())
    rgb = lambda v: fmt(repr(float(c)) for c in v)
    lines = [
        '  <texture type="checkerboard" id="checker_tex">',
        f'    <rgb name="color0" value="{rgb(CBOX_CHECKER["color0"])}"/>',
        f'    <rgb name="color1" value="{rgb(CBOX_CHECKER["color1"])}"/>',
        f'    <float name="uvscale" value="{CBOX_CHECKER["uvscale"]!r}"/>',
        '  </texture>',
        '  <texture type="bitmap" id="rough_tex">',
        f'    <string name="filename" '
        f'value="{CBOX_DISNEY_TEXTURES["rough_tex"]}"/>',
        f'    <float name="uvscale" value="{CBOX_DISNEY_ROUGH_SCALE!r}"/>',
        '  </texture>']
    for typ, children in CBOX_DISNEY_MATERIALS.items():
        lines.append(f'  <bsdf type="{typ}" id="{typ}">')
        for name, v in children:
            if isinstance(v, str):
                lines.append(f'    <ref name="{name}" id="{v}"/>')
            elif np.isscalar(v):
                lines.append(f'    <float name="{name}" value="{v!r}"/>')
            else:
                lines.append(f'    <rgb name="{name}" value="{rgb(v)}"/>')
        lines.append('  </bsdf>')
    return lines


def _hetvol_xml(directory, variant, grid_res, fmt):
    """The heterogeneous variants' <medium> element; writes its density
    grid as density.vol into `directory`."""
    pmin, pmax = hetvol_box()
    write_vol(os.path.join(directory, 'density.vol'),
              hetvol_density(grid_res, smooth=variant == 'hetvol_smooth'),
              pmin, pmax)
    lines = ['  <medium type="heterogeneous" id="medium0">',
             '    <volume name="density" type="gridvolume">',
             '      <string name="filename" value="density.vol"/>',
             '    </volume>',
             '    <volume name="albedo" type="constvolume">',
             f'      <rgb name="value" '
             f'value="{fmt(repr(float(HETVOL_ALBEDO)) for _ in range(3))}"/>',
             '    </volume>']
    g = _hetvol_phase(variant)
    if g is not None:
        lines += [f'    <phase type="hg"><float name="g" '
                  f'value="{float(g)!r}"/></phase>']
    return lines + ['  </medium>']


def _media_xml(variant, fmt):
    """The homogeneous variants' top-level <medium> elements (ids medium0,
    medium1)."""
    rgb = lambda v: fmt(repr(float(c)) for c in v)
    lines = []
    for k, (sigma_a, sigma_s, g) in enumerate(_cbox_media(variant)):
        lines += [f'  <medium type="homogeneous" id="medium{k}">',
                  f'    <rgb name="sigmaA" value="{rgb(sigma_a)}"/>',
                  f'    <rgb name="sigmaS" value="{rgb(sigma_s)}"/>']
        if g is not None:
            lines += [f'    <phase type="hg"><float name="g" '
                      f'value="{float(g)!r}"/></phase>']
        lines += ['  </medium>']
    return lines


def write_cornell_box_xml(directory, res, spp, variant=None,
                          grid_res=HETVOL_GRID_RES, triangles=MESH_TRIANGLES,
                          integrator=None, vol_path_version=None):
    """Write the Cornell box as Mitsuba XML (cbox.xml) plus one OBJ file
    per shape into `directory` (and, for the heterogeneous variants, the
    density grid as density.vol; for 'disney' its roughness image);
    returns the XML path. res, variant, grid_res and triangles as
    cornell_box_builder takes them; `integrator` names another
    <integrator> type than the variant's path or volpath (e.g. 'depth');
    `vol_path_version` writes <integer name="version"/> into it (volpath
    versions 1 and 2, the single-scattering estimators)."""
    _check_variant(variant)
    vol = _is_vol(variant)
    het = variant in HETVOL_VARIANTS
    w, h = _film(res)
    integrator = integrator or ('volpath' if vol else 'path')
    os.makedirs(directory, exist_ok=True)
    fmt = ', '.join
    o, t, u = (fmt(repr(float(x)) for x in CBOX_CAMERA[k])
               for k in ('origin', 'target', 'up'))
    lines = [
        '<?xml version="1.0" encoding="utf-8"?>',
        '<scene version="0.5.0">',
        *([f'  <integrator type="{integrator}"/>'] if vol_path_version is None
          else [f'  <integrator type="{integrator}">',
                f'    <integer name="version" value="{vol_path_version}"/>',
                '  </integrator>']),
        *(_hetvol_xml(directory, variant, grid_res, fmt) if het else
          _media_xml(variant, fmt)),
        '  <sensor type="perspective">',
        f'    <float name="fov" value="{CBOX_CAMERA["fov"]!r}"/>',
        '    <transform name="toWorld">',
        f'      <lookat origin="{o}" target="{t}" up="{u}"/>',
        '    </transform>',
        '    <sampler type="independent">',
        f'      <integer name="sampleCount" value="{spp}"/>',
        '    </sampler>',
        '    <film type="hdrfilm">',
        f'      <integer name="width" value="{w}"/>',
        f'      <integer name="height" value="{h}"/>',
        '      <rfilter type="box"/>',
        '    </film>',
        *(['    <ref id="medium0"/>'] if vol and not het else []),
        '  </sensor>',
    ]
    for name, rgb in CBOX_MATERIALS.items():
        lines += [f'  <bsdf type="diffuse" id="{name}">',
                  f'    <rgb name="reflectance" '
                  f'value="{fmt(repr(float(c)) for c in rgb)}"/>',
                  '  </bsdf>']
    if variant in ('glass', 'vol_glass'):
        lines += _glass_xml(fmt)
    elif het or variant == 'mesh':
        lines += _plastic_xml(fmt)
    elif variant == 'disney':
        lines += _disney_xml(directory, fmt)
    for name, mat, quads, emitter in _variant_shapes(variant):
        mat = _shape_material(variant, name, mat)
        uv = mat in _FLOOR_UV_MATERIALS
        obj_path = os.path.join(directory, f'{name}.obj')
        if quads is None:
            write_obj(obj_path, *displaced_sphere(triangles))
        else:
            with open(obj_path, 'w') as f:
                for qd in quads:
                    for p in qd:
                        f.write('v ' + ' '.join(repr(float(x)) for x in p) +
                                '\n')
                if uv:
                    for t in CBOX_FLOOR_VT:
                        f.write('vt ' + ' '.join(repr(x) for x in t) + '\n')
                for k in range(len(quads)):
                    c = range(4 * k + 1, 4 * k + 5)
                    f.write('f ' + ' '.join(f'{i}/{i}' if uv else f'{i}'
                                            for i in c) + '\n')
        lines += ['  <shape type="obj">',
                  f'    <string name="filename" value="{name}.obj"/>']
        if mat is not None:
            lines += [f'    <ref id="{mat}"/>']
        if vol and not het:
            lines += ['    <ref name="exterior" id="medium0"/>']
        if variant == 'vol_glass' and name in CBOX_INNER_SHAPES:
            lines += ['    <ref name="interior" id="medium1"/>']
        if het and name == 'cube':
            lines += ['    <ref name="interior" id="medium0"/>']
        if emitter:
            rad = fmt(repr(float(c)) for c in CBOX_LIGHT_RADIANCE)
            lines += ['    <emitter type="area">',
                      f'      <rgb name="radiance" value="{rad}"/>',
                      '    </emitter>']
        lines += ['  </shape>']
    lines += ['</scene>', '']
    path = os.path.join(directory, 'cbox.xml')
    with open(path, 'w') as f:
        f.write('\n'.join(lines))
    return path


# ---------------------------------------------------------------------------
# Sphere lights (veach class)
# ---------------------------------------------------------------------------

def sphere_light_builder(res=32):
    """A Lambertian floor, a tilted RoughPlastic plate, a Lambertian
    sphere, two emissive spheres of different radii and one small quad
    light: both kernel materials, sphere hits, sphere-light cone
    sampling and the mixed light pick."""
    b = SceneBuilder(camera=CameraB(to_world=xf.look_at(
        [0, 1.5, 4], [0, 0, 0], [0, 1, 0]), fov=45.0, width=res, height=res),
        options=RenderOptions(), texture_pool=TexturePool())
    floor = MaterialB(type=T.MAT_LAMBERTIAN)
    floor.tex[T.P_BASE_COLOR] = _const_tex(b, (0.6, 0.6, 0.6))
    plate = MaterialB(type=T.MAT_ROUGH_PLASTIC, eta=1.5)
    plate.tex[T.P_BASE_COLOR] = _const_tex(b, (0.2, 0.3, 0.6))
    plate.tex[T.P_AUX_COLOR] = _const_tex(b, (1.0, 1.0, 1.0))
    plate.tex[T.P_ROUGHNESS] = _const_tex(b, 0.15)
    ball = MaterialB(type=T.MAT_LAMBERTIAN)
    ball.tex[T.P_BASE_COLOR] = _const_tex(b, (0.7, 0.4, 0.2))
    b.materials += [floor, plate, ball]

    def mesh(quads):
        pos, idx = _quads_mesh(quads)
        return MeshB(positions=pos, indices=idx,
                     normals=_compute_smooth_normals(pos, idx))
    b.shapes.append(ShapeB(type=T.SHAPE_MESH, material_id=0, mesh=mesh(
        [np.array([[-3, -1, -3], [-3, -1, 3], [3, -1, 3], [3, -1, -3]])])))
    b.shapes.append(ShapeB(type=T.SHAPE_MESH, material_id=1, mesh=mesh(
        [np.array([[-1.5, -1, -1], [1.5, -1, -1], [1.5, 0.2, -1.6],
                   [-1.5, 0.2, -1.6]])])))
    b.shapes.append(ShapeB(type=T.SHAPE_SPHERE, center=(0.6, -0.6, 0.4),
                           radius=0.4, material_id=2))
    for center, radius, le in (((-1.2, 1.2, 0.0), 0.1, 40.0),
                               ((1.2, 1.4, -0.3), 0.35, 4.0)):
        b.shapes.append(ShapeB(type=T.SHAPE_SPHERE, center=center,
                               radius=radius, material_id=0,
                               area_light_id=len(b.lights)))
        b.lights.append(LightB(type=T.LIGHT_AREA, shape_id=len(b.shapes) - 1,
                               intensity=(le, le, le)))
    b.shapes.append(ShapeB(type=T.SHAPE_MESH, material_id=0,
                           area_light_id=len(b.lights), mesh=mesh(
        [np.array([[-0.3, 2, -0.3], [0.3, 2, -0.3], [0.3, 2, 0.3],
                   [-0.3, 2, 0.3]])])))
    b.lights.append(LightB(type=T.LIGHT_AREA, shape_id=len(b.shapes) - 1,
                           intensity=(6.0, 6.0, 6.0)))
    return b


def make_sphere_light_scene(res=32):
    return compile_scene(sphere_light_builder(res))


# The sphere-light scene submerged in a thin homogeneous medium bound to
# the camera and to every shape's exterior, as lajolla_tpu's
# tests/test_vol_kernel.py `_SPHERE_SCENE` submerges its sphere (its
# coefficients): sphere hits, sphere lights and both kernel materials
# inside volpath_kernel.supports (K8's SPH branch).
SUBMERGED_MEDIUM = dict(sigma_a=(0.02, 0.03, 0.02),
                        sigma_s=(0.08, 0.06, 0.09))


def submerged_sphere_builder(res=32, spp=4):
    b = sphere_light_builder(res)
    b.options = RenderOptions(integrator='volpath', samples_per_pixel=spp)
    b.media.append(MediumB(**SUBMERGED_MEDIUM))
    b.camera.medium_id = 0
    for shape in b.shapes:
        shape.exterior_medium_id = 0
    return b


# Media for the per-function tests, appended to 'vol_glass' as media 2-5
# (bound to no shape): HG lobes of both signs, one below the |g| < 1e-3
# cut (sampled uniformly), and one whose red and green sigma_t are 0 (the
# free flight's channel guard).
MEDIA_ZOO = (
    dict(sigma_a=(0.3, 0.2, 0.1), sigma_s=(0.5, 0.7, 0.9),
         phase_type=T.PHASE_HG, g=0.8),
    dict(sigma_a=(0.05, 0.05, 0.05), sigma_s=(1.0, 2.0, 0.5),
         phase_type=T.PHASE_HG, g=-0.7),
    dict(sigma_a=(0.2, 0.2, 0.2), sigma_s=(0.2, 0.2, 0.2),
         phase_type=T.PHASE_HG, g=5e-4),
    dict(sigma_a=(0.0, 0.0, 0.3), sigma_s=(0.0, 0.0, 0.6)),
)


def media_zoo_builder(res=16):
    """The 'vol_glass' Cornell box with MEDIA_ZOO appended."""
    b = cornell_box_builder(res, variant='vol_glass')
    b.media += [MediumB(**m) for m in MEDIA_ZOO]
    return b


def textured_builder(res=16):
    """The sphere-light scene with an 8x8 numpy image (seeded) on the
    floor, uv scale (3, 2): image textures switch on uv interpolation,
    ray differentials and mip selection."""
    b = sphere_light_builder(res)
    img = np.random.default_rng(5).random((8, 8, 3)).astype(np.float32)
    img_id = b.texture_pool.insert('floor_image', img)
    b.texdescs.append(TexDesc(kind=T.TEX_IMAGE, image_id=img_id,
                              uscale=3.0, vscale=2.0))
    m = MaterialB(type=T.MAT_LAMBERTIAN)
    m.tex[T.P_BASE_COLOR] = len(b.texdescs) - 1
    b.materials.append(m)
    b.shapes[0].material_id = len(b.materials) - 1
    return b


# ---------------------------------------------------------------------------
# Furnace (envmap class)
# ---------------------------------------------------------------------------

def furnace_builder(albedo=0.6, res=24, env_radiance=1.0):
    """Convex Lambertian sphere in a uniform environment light
    (lajolla_tpu/testing.py make_furnace_scene): every sphere pixel
    converges to albedo * env_radiance, since a convex body never sees
    itself — an end-to-end gate on envmap emission and sampling, MIS and
    BSDF sampling. No triangles at all."""
    b = SceneBuilder(camera=CameraB(to_world=xf.look_at(
        [0, 0, 4], [0, 0, 0], [0, 1, 0]), fov=30.0, width=res, height=res),
        options=RenderOptions(), texture_pool=TexturePool())
    m = MaterialB(type=T.MAT_LAMBERTIAN)
    m.tex[T.P_BASE_COLOR] = _const_tex(b, (albedo,) * 3)
    b.materials.append(m)
    b.shapes.append(ShapeB(type=T.SHAPE_SPHERE, center=(0.0, 0.0, 0.0),
                           radius=1.0, material_id=0))
    img_id = b.texture_pool.insert(
        "__envmap_texture__", np.full((16, 32, 3), env_radiance, np.float32))
    b.envmap_light_id = 0
    b.lights.append(LightB(type=T.LIGHT_ENVMAP, image_id=img_id,
                           to_world=xf.identity(), scale=1.0))
    return b


def make_furnace_scene(albedo=0.6, res=24, env_radiance=1.0):
    return compile_scene(furnace_builder(albedo, res, env_radiance))


def furnace_sphere_mask(res, margin=2.0):
    """(res, res) bool: the pixels of furnace_builder's film that lie
    inside the sphere's silhouette by `margin` pixels (no pixel filter
    sample can reach the background from them)."""
    half = np.tan(np.radians(15.0))             # fov 30 across the film
    r_px = (1.0 / np.sqrt(16.0 - 1.0)) / half * (res / 2.0)
    y, x = np.mgrid[0:res, 0:res] + 0.5 - res / 2.0
    return np.hypot(x, y) < r_px - margin


# ---------------------------------------------------------------------------
# Random advance inputs
# ---------------------------------------------------------------------------

def random_lanes(scene, n, seed=0):
    """Inputs of one advance for n lanes, made with numpy from `seed`:
    origins and previous vertices uniform in the scene's bounding box
    grown by a quarter of its size on every side,
    uniform directions, random throughput, radiance, bounce (2..8),
    cached pdf and uniforms, 95% of lanes active. Returns a dict of
    float32 arrays in the transposed layout ((3, n) / (8, n) / (n,)),
    nv as int64 and act as bool."""
    rng = np.random.default_rng(seed)
    tri = scene.fp_tri.cpu().numpy().astype(np.float64)
    p0 = tri[0:3]
    pts = [p0, p0 + tri[3:6], p0 + tri[6:9]]
    S = scene.meta.num_spheres
    if S:
        sph = scene.fp_sph.cpu().numpy().astype(np.float64)[:S]
        pts += [(sph[:, 0:3] - sph[:, 3:4]).T, (sph[:, 0:3] + sph[:, 3:4]).T]
    allp = np.concatenate(pts, axis=1)
    lo, hi = allp.min(axis=1)[:, None], allp.max(axis=1)[:, None]
    lo, hi = lo - 0.25 * (hi - lo), hi + 0.25 * (hi - lo)
    d = rng.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    f32 = np.float32
    return dict(
        org=(lo + (hi - lo) * rng.random((3, n))).astype(f32),
        dir=d.astype(f32),
        thr=rng.uniform(0.05, 1.0, (3, n)).astype(f32),
        rad=rng.uniform(0.0, 0.5, (3, n)).astype(f32),
        nv=rng.integers(2, 9, n).astype(np.int64),
        dir_pdf=rng.uniform(0.0, 2.0, n).astype(f32),
        prev=(lo + (hi - lo) * rng.random((3, n))).astype(f32),
        un=rng.random((8, n)).astype(f32),
        act=rng.random(n) < 0.95)


def random_general_lanes(scene, n, seed=0):
    """State of one general-engine vertex (integrators/path._advance_lane)
    for n lanes, made with numpy from `seed`, in the lane-major layout
    ((n, 3) vectors, (n,) scalars): positions and directions as
    random_lanes draws them, random work items, bounce 2..8, ray spread
    and radius, throughput, radiance, eta_scale in {1/eta^2, 1, eta^2}
    (eta 1.5), cached pdf, previous vertex, 5% of lanes done, and (n, 8)
    uniforms. Item and nv are int64, done bool, the rest float32."""
    t = random_lanes(scene, n, seed)
    rng = np.random.default_rng(seed + 1)
    f32 = np.float32
    return dict(
        item=rng.integers(0, 1 << 30, n).astype(np.int64),
        nv=t['nv'], org=t['org'].T.copy(), d=t['dir'].T.copy(),
        spread=rng.uniform(0.0, 0.01, n).astype(f32),
        radius=rng.uniform(0.0, 0.05, n).astype(f32),
        T=t['thr'].T.copy(), L=t['rad'].T.copy(),
        eta_scale=rng.choice([1.0 / 2.25, 1.0, 2.25], n).astype(f32),
        dir_pdf=t['dir_pdf'], prev_pos=t['prev'].T.copy(),
        done=rng.random(n) < 0.05,
        u=t['un'].T.copy())


def random_vol_lanes(scene, n, seed=0):
    """State of one bounce of the general volumetric engine
    (integrators/volpath._advance_vol_lane) for n lanes, made with numpy
    from `seed`, keyed by volpath.VOL_STATE in the lane-major layout:
    positions, directions, throughput and radiance as random_lanes draws
    them, the cached NEE origin where it draws the previous vertex, each
    lane in a random medium of the scene or in vacuum (10%, id -1),
    bounce 0..7 (0: the camera vertex), random work items, multi-trans
    pdf, eta_scale in {1/eta^2, 1, eta^2} (eta 1.5), ray spread and
    radius, 5% of lanes done. Item and bounces are int64, medium int32,
    done bool, the rest float32."""
    t = random_lanes(scene, n, seed)
    rng = np.random.default_rng(seed + 2)
    f32 = np.float32
    nm = max(scene.meta.num_media, 1)
    medium = np.where(rng.random(n) < 0.1, -1, rng.integers(0, nm, n))
    return dict(
        item=rng.integers(0, 1 << 30, n).astype(np.int64),
        org=t['org'].T.copy(), d=t['dir'].T.copy(),
        medium=medium.astype(np.int32),
        T=t['thr'].T.copy(), L=t['rad'].T.copy(),
        bounces=rng.integers(0, 8, n).astype(np.int64),
        dir_pdf=t['dir_pdf'], nee_p=t['prev'].T.copy(),
        multi_trans_pdf=rng.uniform(0.05, 1.0, (n, 3)).astype(f32),
        eta_scale=rng.choice([1.0 / 2.25, 1.0, 2.25], n).astype(f32),
        spread=rng.uniform(0.0, 0.01, n).astype(f32),
        radius=rng.uniform(0.0, 0.05, n).astype(f32),
        done=rng.random(n) < 0.05)


# lajolla_tpu's dtypes of the event-machine state fields that differ from
# the port's (the port keeps hash words and counters in int64)
EVENT_STATE_JAX_DTYPES = dict(item=np.int32, bounces=np.int32, ph=np.int32,
                              ff_hs=np.uint32, nb_hs=np.uint32,
                              ff_it=np.int32, sh_seg=np.int32)


def random_event_lanes(scene, options, n, seed=0, max_steps=8):
    """State of the event machine (integrators/volpath._advance_event) for
    n lanes, keyed by volpath.EVENT_STATE, lane-major numpy arrays in the
    port's dtypes: fresh paths of random work items (numpy-seeded from
    `seed`), each advanced by the machine itself a random 0..max_steps-1
    times, so that every phase of the machine occurs with a coherent
    state; a path that ended on the way is marked done. On the CPU."""
    import torch

    from lajolla_tpu_torch.integrators import volpath as V

    scene = scene.to('cpu')
    rng = np.random.default_rng(seed)
    item = torch.from_numpy(rng.integers(0, 1 << 30, n).astype(np.int64))
    steps = torch.from_numpy(rng.integers(0, max_steps, n))
    su = V.stream_root(seed)
    st = V._fresh_state(scene, options, item, su, True) + (
        torch.zeros(n, dtype=torch.bool),)
    for k in range(max_steps - 1):
        nst, died = V._advance_event(scene, options, st, su)
        nst = nst[:-1] + (nst[-1] | died,)
        go = k < steps
        st = tuple(torch.where(go if a.dim() == 1 else go[:, None], a, b)
                   for a, b in zip(nst, st))
    return {k: x.numpy() for k, x in zip(V.EVENT_STATE, st)}


# The fields of general-engine lane state, in _advance_lane's order.
GENERAL_STATE = ('item', 'nv', 'org', 'd', 'spread', 'radius', 'T', 'L',
                 'eta_scale', 'dir_pdf', 'prev_pos', 'done')


def repack_clusters(scene, max_tris):
    """`scene` with its cluster and sweep tables rebuilt from its BVH at
    `max_tris` triangles per cluster. A size off the 128 grid (which
    compile_scene never makes) sends the scene's casts to the streaming
    sweep, kernel K7."""
    import dataclasses

    import torch

    from lajolla_tpu_torch.ops.intersect_binned import build_clusters
    from lajolla_tpu_torch.ops.intersect_sweep import pack_sweep

    def host(x):
        return x.cpu().numpy()
    bvh = {k: host(getattr(scene, 'bvh_' + k))
           for k in ('lo', 'hi', 'first', 'count', 'skip', 'prim')}
    cl = build_clusters(bvh, host(scene.tri_p0), host(scene.tri_e1),
                        host(scene.tri_e2), max_tris=max_tris)
    cl.pop('n_clusters')
    tables = {**cl, **pack_sweep(cl, aligned=False)}
    dev = scene.tri_shade.device
    return dataclasses.replace(scene, **{
        k: torch.from_numpy(v).to(dev) for k, v in tables.items()})


def sweep_rows(sw_lane):
    """The triangle-major sweep rows of a lane table (K, 16, C), as
    lajolla_tpu's sweep tables also hold them: {'sw_A': (K*C, 12) Woop
    rows [a0x a1x a2x bx | ...y | ...z], 'sw_prim': (K*C, 1) f32 prim
    ids}, numpy."""
    lane = np.asarray(sw_lane)
    K, _, C = lane.shape
    return {'sw_A': np.ascontiguousarray(
                lane[:, :12, :].transpose(0, 2, 1)).reshape(K * C, 12),
            'sw_prim': np.ascontiguousarray(lane[:, 12, :]).reshape(
                K * C, 1)}


# Where the tie fixture (`sweep_tie_fixture`) puts its triangles, by index
# in the cluster: lane l of a warp tests indices l + 32k, so the copies of
# triangle A sit in lanes 7 and 2, one and more rounds apart (at 64
# triangles a cluster, the streaming sweep's size, the copies below 64:
# indices 7, 34 and 39, lanes 7, 2 and 7).
TIE_COPIES_A = (7, 34, 39, 71, 103)   # cluster 0; cluster 1 holds one at 0
TIE_FAR_B, TIE_NEAR_B = 9, 40         # cluster 0: B at z = 0 and z = 0.1


def sweep_tie_fixture(seed=0, n=512, C=128):
    """Two clusters of C (128, or 64 for the streaming sweep K7) triangles
    whose hits tie, for holding the sweeps' tie rules, and n rays, all
    made with numpy from `seed`.

    Cluster 0 holds identical copies of a triangle A in the plane z = 0
    (the indices of TIE_COPIES_A below C), a triangle B at z = 0 (index
    TIE_FAR_B) and a copy of B lifted to z = 0.1 (index TIE_NEAR_B);
    cluster 1 holds one more copy of A (index 0). The other slots hold
    small triangles off the rays' paths, cluster 1's reaching z = 0.5, so
    that a block's list holds cluster 1 before cluster 0. Rays come down
    from z ~ 2.5, nearly vertical, onto A (3/8), onto B (3/8) or onto
    nothing (1/4).

    Closest hit: a ray on A gets the copy of the first listed cluster (1,
    its index 0) or, where a block sweeps superclusters (members in id
    order) and in K7's walk in id order, cluster 0's lowest index; a ray
    on B the lifted copy. Any hit: the lowest index of the first cluster
    that holds a hit, so a ray on B stops at the copy at z = 0, not at the
    nearer one.

    Returns (tables, rays, region): tables as `ops.intersect_sweep`'s
    callers read them (cl_* and sw_* numpy arrays; prim ids are C *
    cluster + index), rays (o, d, tnear, tfar) float32 arrays, region (n,)
    0 on A, 1 on B, -1 off both."""
    from lajolla_tpu_torch.ops.intersect_binned import build_clusters
    from lajolla_tpu_torch.ops.intersect_sweep import pack_sweep
    rng = np.random.default_rng(seed)
    tri = np.zeros((2 * C, 3, 3))

    def fillers(k, x0, z0, z1):
        base = np.stack([rng.uniform(x0, x0 + 1, k), rng.uniform(-1, 1, k),
                         rng.uniform(z0, z1, k)], -1)
        return base[:, None, :] + rng.uniform(0, 0.05, (k, 3, 3))
    tri[:C] = fillers(C, 5.0, -0.5, 0.0)
    tri[C:] = fillers(C, -6.0, 0.0, 0.45)
    a = np.array([[-1.0, -1.0, 0.0], [-0.1, -1.0, 0.0], [-1.0, 0.8, 0.0]])
    b = a + [1.3, 0.0, 0.0]
    for c in TIE_COPIES_A:
        if c < C:
            tri[c] = a
    tri[C] = a
    tri[TIE_FAR_B] = b
    tri[TIE_NEAR_B] = b + [0.0, 0.0, 0.1]
    tri = tri.astype(np.float32)
    lo, hi = tri.min(axis=1), tri.max(axis=1)
    # two leaves of 128 under a root: the clusters are the leaves, their
    # triangles in index order
    bvh = dict(first=np.array([0, 0, C]), count=np.array([0, C, C]),
               skip=np.array([3, 2, 3]),
               lo=np.stack([lo.min(0), lo[:C].min(0), lo[C:].min(0)]),
               hi=np.stack([hi.max(0), hi[:C].max(0), hi[C:].max(0)]),
               prim=np.arange(2 * C))
    cl = build_clusters(bvh, tri[:, 0], tri[:, 1] - tri[:, 0],
                        tri[:, 2] - tri[:, 0], max_tris=C)
    assert cl.pop('n_clusters') == 2
    tables = {**cl, **pack_sweep(cl, aligned=C % 128 == 0)}

    region = rng.choice([0, 0, 0, 1, 1, 1, -1, -1], n)
    u = rng.uniform(0.1, 0.8, n)
    v = rng.uniform(0.05, 0.85 - u)
    target = np.stack([-1.0 + 0.9 * u, -1.0 + 1.8 * v, np.zeros(n)], -1)
    target[region == 1, 0] += 1.3
    target[region == -1, 0] += 3.6
    d = np.stack([rng.uniform(-0.03, 0.03, n), rng.uniform(-0.03, 0.03, n),
                  -np.ones(n)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = target - 2.5 * d
    f32 = np.float32
    rays = (o.astype(f32), d.astype(f32), np.full(n, 1e-4, f32),
            np.full(n, np.inf, f32))
    return tables, rays, region


# Where the resolve's tie fixture (`resolve_tie_fixture`) puts its pairs of
# triangles, by index in cluster 0, (index, lane = index % 32) and the
# index each pair must resolve to: equal err, the lower index in the lower
# lane (3 / 40) and in the higher lane (13 / 66), and a strictly smaller
# err at the higher index (100 over 5, lanes 4 and 5).
RESOLVE_PAIRS = (((3, 40), 3), ((66, 13), 13), ((5, 100), 100))
RESOLVE_DELTA = 2.0 ** -16     # a pair's two planes at z = +-delta


def resolve_tie_fixture(seed=0, n=512):
    """Tables and rays that hold the resolve K4's tie rule, all made with
    numpy from `seed`: two clusters of 128 triangles, the second of them
    and most slots of the first small triangles off the rays' paths.

    Cluster 0 holds, for each pair of RESOLVE_PAIRS, two unit right
    triangles over one square of the xy plane: the first listed in the
    plane z = +RESOLVE_DELTA, the second at z = -RESOLVE_DELTA (for the
    third pair at z = +RESOLVE_DELTA / 2). Rays come straight down from z =
    1 onto a pair's square, with t_best = 1 in their tfar slot, so both
    triangles of a pair are hit at t = 1 -+ delta, every value exact in
    fp32: the first two pairs tie at err = delta (the lower index must
    win), the third does not. Some rays name no cluster (kid -1), some
    miss every triangle, some carry a t_best beyond the tolerance.

    Returns (tables, rays (n, 8) [o, tnear, d, t_best], kid (n,) int32,
    want (n,) int32: the prim id each ray must resolve to, -1 for none;
    prim ids are 128 * cluster + index)."""
    from lajolla_tpu_torch.ops.intersect_binned import build_clusters
    from lajolla_tpu_torch.ops.intersect_sweep import pack_sweep
    rng = np.random.default_rng(seed)
    C = 128
    tri = np.stack([rng.uniform(5.0, 6.0, (2 * C, 3)),
                    rng.uniform(-1.0, 1.0, (2 * C, 3)),
                    rng.uniform(-0.5, 0.5, (2 * C, 3))], -1)
    unit = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    squares = []
    for p, ((first, second), _) in enumerate(RESOLVE_PAIRS):
        corner = np.array([-2.0 + 1.5 * p, -1.0, 0.0])
        squares.append(corner[:2])
        far = RESOLVE_DELTA / 2 if p == 2 else -RESOLVE_DELTA
        tri[first] = corner + unit + [0.0, 0.0, RESOLVE_DELTA]
        tri[second] = corner + unit + [0.0, 0.0, far]
    tri = tri.astype(np.float32)
    lo, hi = tri.min(axis=1), tri.max(axis=1)
    bvh = dict(first=np.array([0, 0, C]), count=np.array([0, C, C]),
               skip=np.array([3, 2, 3]),
               lo=np.stack([lo.min(0), lo[:C].min(0), lo[C:].min(0)]),
               hi=np.stack([hi.max(0), hi[:C].max(0), hi[C:].max(0)]),
               prim=np.arange(2 * C))
    cl = build_clusters(bvh, tri[:, 0], tri[:, 1] - tri[:, 0],
                        tri[:, 2] - tri[:, 0], max_tris=C)
    assert cl.pop('n_clusters') == 2
    tables = {**cl, **pack_sweep(cl)}

    # 0-2: a pair's square; 3: no triangle below; 4: no cluster named;
    # 5: a pair's square with t_best beyond the tolerance
    case = rng.choice([0, 0, 1, 1, 2, 2, 3, 4, 5], n)
    pair = np.where(case <= 2, case, rng.integers(0, 3, n))
    uv = rng.uniform(0.05, 0.45, (n, 2))
    xy = np.array(squares)[pair] + uv
    xy[case == 3, 0] += 4.5
    f32 = np.float32
    rays = np.zeros((n, 8), f32)
    rays[:, 0:2] = xy
    rays[:, 2] = 1.0
    rays[:, 3] = 1e-4
    rays[:, 6] = -1.0
    rays[:, 7] = np.where(case == 5, 1.5, 1.0)
    kid = np.where(case == 4, -1, 0).astype(np.int32)
    want = np.where(case <= 2, np.array([w for _, w in RESOLVE_PAIRS])[pair],
                    -1).astype(np.int32)
    return tables, rays, kid, want


def general_rays(scene, seed=0, device='cpu'):
    """The rays the general engine casts on the first vertices of a
    render of `scene` (one per pixel, on the scene's device), for holding
    the casts (kernels K3-K7) against their plain forms: the camera rays of
    sample 0, the bounce rays the first vertex samples (the camera ray
    where that path ended) and shadow rays from the first hits to points
    sampled on the lights (numpy uniforms from `seed`), with their tfar.
    Made on `device` (by default the CPU, where the casts run their plain
    forms) and moved to the scene's device. Returns dict of
    (o, d, tnear, tfar)."""
    import torch

    from lajolla_tpu_torch.dtypes import intersection_eps, shadow_eps
    from lajolla_tpu_torch.integrators import lights
    from lajolla_tpu_torch.integrators import path as P

    dev = scene.tri_shade.device
    scene = scene.to(device)
    on_dev = dict(device=device)
    meta = scene.meta
    n = meta.width * meta.height
    opts = RenderOptions()
    item = torch.arange(n, **on_dev)
    _, org, d = P._primary_hash(scene, opts, item, seed)
    z = torch.zeros(n, **on_dev)
    st = (item, torch.full((n,), 2, **on_dev), org, d, z + 1e-3, z,
          torch.ones((n, 3), **on_dev), torch.zeros((n, 3), **on_dev),
          z + 1.0, z, org, torch.zeros(n, dtype=torch.bool, **on_dev))
    nst, died = P._advance_lane(scene, opts, st,
                                P._vertex_uniforms(item, st[1], seed).T)
    on = ~died[:, None]
    b_org = torch.where(on, nst[2], org)
    b_dir = torch.where(on, nst[3], d)

    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.random((n, 4)).astype(np.float32)).to(device)
    lp = lights.sample_point_on_light(
        scene, lights.sample_light(scene, u[:, 2]), b_org, u[:, 0:2],
        u[:, 3])
    to_l = lp.position - b_org
    dist = torch.sqrt((to_l * to_l).sum(-1))
    eps_s = shadow_eps(meta.scene_radius)
    s_org = torch.where(on, b_org, org)
    s_dir = torch.where(on, to_l / dist[:, None].clamp(min=1e-20), d)
    s_far = torch.where(on[:, 0], (1.0 - eps_s) * dist, float('inf'))
    eps_i = intersection_eps(meta.scene_radius)
    inf = torch.full((n,), float('inf'), **on_dev)
    rays = dict(camera=(org, d, z + eps_i, inf),
                bounce=(b_org, b_dir, z + eps_i, inf),
                shadow=(s_org, s_dir, z + eps_s, s_far))
    return {k: tuple(x.contiguous().to(dev) for x in ray)
            for k, ray in rays.items()}


# ---------------------------------------------------------------------------
# K2's split scans on CPU tensors
# ---------------------------------------------------------------------------

def group_closest(o, d, tnear, W, qf, G):
    """The closest hit of K2's scans split over a group of G threads
    (csrc/path_advance.cuh intersect_range over a CastGroup), on CPU
    tensors: thread r scans the cast prims r, r + G, ... in order with a
    strict < (the least t of its share at its lowest index), then the
    group reduces by xor shuffles on (t, index), least t first, lowest
    index among equal t. o, d (3, B); W, qf as path_kernel._intersect
    takes them. Returns (t, idx, u, v, q), each (B,), as the group's
    threads all end with them (inf, 0, 0, 0, 0 on a miss)."""
    import torch

    from lajolla_tpu_torch.integrators.path_kernel import _hit_mask, _woop_tuv
    t, u, v = _woop_tuv(o, d, W)
    hit = _hit_mask(t, u, v, tnear, qf)
    q = (torch.zeros_like(t) if qf is None else
         qf[:, None].expand_as(t))
    B = t.shape[1]
    best = []
    for r in range(G):
        b = [torch.full((B,), float('inf')), torch.zeros(B, dtype=torch.long),
             torch.zeros(B), torch.zeros(B), torch.zeros(B)]
        for c in range(r, t.shape[0], G):
            take = hit[c] & (t[c] < b[0])
            b = [torch.where(take, x, y) for x, y in
                 zip((t[c], torch.full((B,), c), u[c], v[c], q[c]), b)]
        best.append(b)
    off = G // 2
    while off:
        nxt = []
        for r in range(G):
            a, b = best[r], best[r ^ off]
            take = (b[0] < a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
            nxt.append([torch.where(take, y, x) for x, y in zip(a, b)])
        best, off = nxt, off // 2
    for other in best[1:]:
        assert all(torch.equal(x, y) for x, y in zip(best[0], other))
    return tuple(best[0])


def group_occluded(o, d, tnear, tfar, W, qf, G):
    """The any-hit of K2's split scans (csrc/path_advance.cuh occluded
    over a CastGroup) on CPU tensors: rounds of G occluders, thread r
    testing occluder c0 + r, until the group's vote finds a hit. Returns
    (B,) bool."""
    import torch

    from lajolla_tpu_torch.integrators.path_kernel import _occluder_hits
    hits = _occluder_hits(o, d, tnear, tfar, W, qf)
    occ = torch.zeros(hits.shape[1], dtype=torch.bool)
    for c0 in range(0, hits.shape[0], G):
        occ = occ | hits[c0:c0 + G].any(dim=0)
    return occ


# Tolerances of one advance against its reference, per output: where both
# sides are alive, a lane agrees if every component is within
# rtol / atol 1e-5. dir_pdf gets rtol 1e-2: next to the GGX peak of a
# RoughPlastic lobe the microfacet term divides by t = (n.h)^2 (a^2 - 1)
# + 1 ~ a^2, formed by cancellation, so a last-bit difference in the order
# of fp32 operations grows ~1/a^2 (up to ~3e-3 measured at roughness
# 0.15), and sampled directions aim at the peak.
ADVANCE_RTOL = dict(org=1e-4, dir=1e-4, thr=1e-4, rad=1e-4, dir_pdf=1e-2)


def advance_agreement(got, got_alive, want, want_alive):
    """Compare two advances of the same lanes (dicts of numpy arrays keyed
    as ADVANCE_RTOL, plus alive bits). Returns (share of lanes whose alive
    bits agree, {output: share of both-alive lanes within tolerance},
    largest absolute difference over both-alive lanes)."""
    both = got_alive & want_alive
    shares, max_abs = {}, 0.0
    for k, rtol in ADVANCE_RTOL.items():
        g, w = got[k][..., both], want[k][..., both]
        ok = np.isclose(g, w, rtol=rtol, atol=1e-5)
        shares[k] = float((ok.all(axis=0) if ok.ndim == 2 else ok).mean())
        if g.size:
            max_abs = max(max_abs, float(np.abs(g - w).max()))
    return float((got_alive == want_alive).mean()), shares, max_abs


def aux_agreement(got, want, mode):
    """Share of an aux film's values within lajolla_tpu's aux gate of
    `want` (tests/test_aux_parity.py): 2e-3 of the film's largest
    magnitude, 2e-2 for meanCurvature, whose dn/du chain amplifies fp32
    rounding. The gate asks >= 99.9%."""
    tol = 2e-2 if mode == 'meanCurvature' else 2e-3
    scale = np.abs(want).max() + 1e-9
    return float((np.abs(got - want) / scale <= tol).mean())


def assert_advance_agrees(got, got_alive, want, want_alive):
    """Alive bits agree on >= 99.9% of lanes, and >= 99.9% of both-alive
    lanes agree on every output (ADVANCE_RTOL). Not all: a lane whose
    shadow point lies next to the light, or whose hit lies on an edge,
    turns a last-bit difference into a larger one."""
    assert (got_alive & want_alive).any()
    alive_share, shares, _ = advance_agreement(got, got_alive, want,
                                               want_alive)
    assert alive_share >= 0.999, alive_share
    for k, share in shares.items():
        assert share >= 0.999, (k, share)


# ---------------------------------------------------------------------------
# Sharded renders (parallel/mesh.py), one rank of parallel.spawn
# ---------------------------------------------------------------------------

def _sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _timed_collective(group, film, aux, device):
    """Seconds of one all_reduce (aux: all_gather of the rank's rows) of
    a tensor of the film's size on `device`, the ranks started together."""
    import torch
    import torch.distributed as dist
    ranks = dist.get_world_size(group)
    if aux:
        block = torch.zeros((-(-film.shape[0] // ranks),) + film.shape[1:],
                            device=device)
        parts = [torch.empty_like(block) for _ in range(ranks)]
        call = lambda: dist.all_gather(parts, block, group=group)  # noqa
    else:
        buf = torch.zeros(film.shape, device=device)
        call = lambda: dist.all_reduce(buf, group=group)  # noqa
    dist.barrier(group=group)
    _sync(device)
    t0 = time.perf_counter()
    call()
    _sync(device)
    return time.perf_counter() - t0


def sharded_cases(group, cases, device='cpu'):
    """One rank of tests/test_torch_parallel.py and chip_smoke.py [20]
    (run by parallel.spawn.spawn): each case through parallel.mesh on
    `device`. A case is a dict of 'scene' (compiled, on any device),
    'options', 'seed', 'kind' and 'repeats' (runs, default 1):
    - 'render': render_sharded;
    - 'diff': render_diff_sharded (depth 'depth') of the film mean with
      respect to a scale s on the scene's texture table at s = 1: its
      reverse-mode gradient after allreduce_grads, and grad_fwd's.
    Returns a dict a case: 'film' (numpy, the last run's), 'launches'
    (kernels.LAUNCHES of the first run, counted from 0), 'seconds' (each
    run's wall, the ranks started together and the device synchronised),
    'collective_seconds' (_timed_collective), and for 'diff' also 'loss',
    'grad' and 'grad_fwd' (floats)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from lajolla_tpu_torch import kernels
    from lajolla_tpu_torch.integrators.diffpath import grad_fwd
    from lajolla_tpu_torch.parallel import mesh
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    out = []
    for case in cases:
        scene, options, seed = case['scene'].to(device), case['options'], \
            case['seed']
        diff = case['kind'] == 'diff'

        def scaled(s):
            return dataclasses.replace(scene, tex_tab=scene.tex_tab * s)

        def run():
            if not diff:
                return mesh.render_sharded(scene, options, seed, group), {}
            s = torch.tensor(1.0, device=device, requires_grad=True)
            img = mesh.render_diff_sharded(scaled(s), options, seed, group,
                                           depth=case['depth'])
            loss = img.mean()
            loss.backward()
            mesh.allreduce_grads([s], group)
            return img.detach(), dict(loss=float(loss.detach()),
                                        grad=float(s.grad))

        seconds, launches = [], None
        for _ in range(case.get('repeats', 1)):
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            dist.barrier(group=group)
            _sync(device)
            t0 = time.perf_counter()
            film, more = run()
            _sync(device)
            seconds.append(time.perf_counter() - t0)
            launches = launches or dict(kernels.LAUNCHES)
        if diff:
            more['grad_fwd'] = float(grad_fwd(
                lambda s: mesh.render_diff_sharded(
                    scaled(s), options, seed, group,
                    depth=case['depth']).mean(),
                torch.tensor(1.0, device=device)))
        out.append(dict(
            film=film.cpu().numpy(), launches=launches, seconds=seconds,
            collective_seconds=_timed_collective(
                group, film, options.integrator in mesh._AUX, device),
            **more))
    return out
