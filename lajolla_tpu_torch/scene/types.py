"""Device scene representation.

The reference stores scene objects as C++ `std::variant`s in flat vectors
with integer cross-references (scene.h:58-81). The equivalent here is one
dataclass of flat SoA tensors: every variant becomes an integer tag +
padded parameter rows, every object reference an index. Static facts
(counts, which material types exist, image sizes) live in `SceneMeta`, a
hashable struct the kernels specialize on.
"""

import dataclasses
from dataclasses import dataclass, fields
from typing import Any, Tuple


# Material type tags (reference: the Material variant, material.h:102-110)
MAT_LAMBERTIAN = 0
MAT_ROUGH_PLASTIC = 1
MAT_ROUGH_DIELECTRIC = 2
MAT_DISNEY_DIFFUSE = 3
MAT_DISNEY_METAL = 4
MAT_DISNEY_GLASS = 5
MAT_DISNEY_CLEARCOAT = 6
MAT_DISNEY_SHEEN = 7
MAT_DISNEY_BSDF = 8
NUM_MAT_TYPES = 9

# Texturable parameter slots (superset across material types; each holds a
# texture-descriptor index). Spectrum-valued slots read all 3 channels,
# scalar slots read channel 0.
P_BASE_COLOR = 0       # reflectance / diffuse_reflectance / specular_reflectance / base_color
P_AUX_COLOR = 1        # specular_reflectance (plastic) / specular_transmittance (dielectric)
P_ROUGHNESS = 2
P_SUBSURFACE = 3
P_METALLIC = 4
P_SPECULAR = 5
P_SPECULAR_TINT = 6
P_ANISOTROPIC = 7
P_SHEEN = 8
P_SHEEN_TINT = 9
P_CLEARCOAT = 10
P_CLEARCOAT_GLOSS = 11
P_SPEC_TRANS = 12
NUM_PARAM_SLOTS = 13

# Texture descriptor kinds (reference: the Texture variant, texture.h:108)
TEX_CONSTANT = 0
TEX_IMAGE = 1
TEX_CHECKERBOARD = 2

# Shape types
SHAPE_MESH = 0
SHAPE_SPHERE = 1

# Light types (reference: light.h:34)
LIGHT_AREA = 0
LIGHT_ENVMAP = 1

# Medium types (reference: medium.h:22)
MED_HOMOGENEOUS = 0
MED_HETEROGENEOUS = 1

# Phase function types (reference: phase_function.h:9-16)
PHASE_ISOTROPIC = 0
PHASE_HG = 1

# Volume kinds (reference: volume.h:13-26)
VOL_CONSTANT = 0
VOL_GRID = 1

MAX_MIP_LEVELS = 8  # reference c_max_mipmap_levels (mipmap.h:5)

# Filters (reference: filter.h:31-44)
FILTER_BOX = 0
FILTER_TENT = 1
FILTER_GAUSSIAN = 2


@dataclass(frozen=True)
class SceneMeta:
    """Hashable static scene facts — the kernels specialize on these."""
    num_shapes: int
    num_triangles: int
    num_spheres: int
    num_materials: int
    num_lights: int
    num_media: int
    num_textures: int
    num_images: int
    mat_types_present: Tuple[int, ...]
    phase_types_present: Tuple[int, ...]
    med_types_present: Tuple[int, ...]
    has_envmap: bool
    envmap_light_id: int
    env_image_id: int                 # image id of the envmap texture (-1)
    env_res: Tuple[int, int]          # (H, W) of envmap CDF tables (0,0 if none)
    width: int
    height: int
    camera_medium_id: int
    scene_radius: float
    use_bvh: bool
    bvh_depth: int                    # max traversal iterations bound
    has_image_textures: bool
    texture_types_present: Tuple[int, ...]
    needs_uv: bool = True        # any non-constant texture present
    needs_ray_diff: bool = True  # image textures anywhere (mip selection)
    needs_tangent: bool = True   # anisotropy-capable materials present
    has_grid_volumes: bool = False
    use_binned: bool = False     # binned two-level intersector
    has_quads: bool = False      # any parallelogram-merged cast prims
    # residual ratio tracking pays off (nontrivial supervoxel minorants,
    # or homogeneous lanes sharing the heterogeneous event machine);
    # False lets volpath compile the plain zero-control tracking loop
    svox_ctrl: bool = False
    # ONE homogeneous medium fills the whole scene: camera medium == 0,
    # every shape opaque (material >= 0) with exterior == 0 and no
    # interior. The medium id can never change along any path, so the
    # fused volumetric megakernel (integrators/volpath_kernel.py) bakes
    # it in (the vol_cbox class; vol_path_tracing.h:503-869 with its
    # update_medium calls statically the identity)
    uniform_medium: bool = False
    # ONE heterogeneous grid medium with a monochrome density grid and a
    # constant albedo, supervoxel table small enough for in-kernel
    # one-hot MXU lookups: the fused grid-media megakernel
    # (integrators/volpath_grid_kernel.py) can run the scene (the
    # hetvol class; vol_path_tracing.h:554-629 free flight with the
    # density field resolved by MXU matmul-gather)
    grid_kernel_ok: bool = False


@dataclass(frozen=True)
class RenderOptions:
    """reference scene.h:24-31 + film info."""
    integrator: str = "path"          # depth/shadingNormal/meanCurvature/rayDifferential/mipmapLevel/path/volpath
    samples_per_pixel: int = 4
    max_depth: int = -1
    rr_depth: int = 5
    vol_path_version: int = 0
    max_null_collisions: int = 1000
    filter_type: int = FILTER_BOX
    filter_param: float = 1.0         # width (box/tent) or stddev (gaussian)
    output_filename: str = "image.exr"


@dataclass
class Scene:
    """Compiled scene: every field but `meta` is a torch tensor."""
    # --- geometry ---------------------------------------------------------
    vertices: Any        # (V,3) f32
    normals: Any         # (V,3) f32 shading normals (geometric fallback filled in)
    uvs: Any             # (V,2) f32
    indices: Any         # (T,3) i32
    tri_shape: Any       # (T,) i32 shape id per triangle
    tri_p0: Any          # (T,3) f32 precomputed for Moller-Trumbore
    tri_e1: Any          # (T,3) f32 v1 - v0
    tri_e2: Any          # (T,3) f32 v2 - v0
    tri_woop_A: Any      # (3, 3Tc) f32 Woop transforms, CAST space (quad-merged)
    tri_woop_b: Any      # (3Tc,) f32
    tri_woop_A_occ: Any  # (3, 3T_occ) f32 occluder subset (see fp_woop_occ)
    tri_woop_b_occ: Any  # (3T_occ,) f32
    cast_src: Any        # (Tc,) i32 rep triangle id per cast prim
    cast_alt: Any        # (Tc,) i32 partner tri id (== cast_src if no quad)
    cast_quad: Any       # (Tc,) f32 1.0 where the cast prim is a quad
    cast_occ_quad: Any   # (T_occ,) f32 quad flags of the occluder subset
    sph_center: Any      # (S,3) f32
    sph_radius: Any      # (S,) f32
    sph_shape: Any       # (S,) i32

    # --- BVH over triangles (threaded/stackless layout) --------------------
    bvh_lo: Any          # (N,3) f32 node AABB min
    bvh_hi: Any          # (N,3) f32 node AABB max
    bvh_first: Any       # (N,) i32: inner → hit-link (first child); leaf → first prim
    bvh_count: Any       # (N,) i32: 0 inner, >0 = leaf prim count
    bvh_skip: Any        # (N,) i32 miss-link (next node if AABB missed / leaf done)
    bvh_prim: Any        # (T,) i32 permutation leaf-slot → triangle index
    bvh_node: Any        # (N, 9) f32 merged [lo(3) hi(3) first count skip]
    bvh_leaf_tri: Any    # (T, 10) f32 leaf-order [p0 e1 e2 prim] (Moller data)

    # --- cluster casters (large scenes; ops/intersect_binned, intersect_sweep)
    cl_lo: Any           # (K, 3) f32 cluster AABBs
    cl_hi: Any           # (K, 3) f32
    cl_A: Any            # (K, 3, 3C) f32 dense Woop transform blocks
    cl_b: Any            # (K, 3C) f32
    cl_prim: Any         # (K, C) i32 triangle ids (-1 pad)
    sw_lane: Any         # (K, 16, C) f32 lane-major Woop + prim table (padded)
    sw_aabb: Any         # (K, 8) f32 cluster [lo3 hi3 0 0]
    sw_saabb: Any        # (K/G, 8) f32 supercluster AABBs (sweep gate)

    # --- diffuse fast-path tables (integrators/path_kernel.py) --------------
    fp_woop: Any         # (Tc, 12) f32 [Ax(4) Ay(4) Az(4)], CAST space
    fp_woop_occ: Any     # (T_occ, 12) f32 occluder subset: tris NOT on the
                         # scene's convex envelope (an envelope tri can
                         # never block a shadow segment between two
                         # on/inside-hull points; area/sphere-light NEE
                         # only — envmap and media scenes keep the full
                         # set, since their shadow rays can start outside
                         # the hull)
    fp_tri: Any          # (40, T) f32 packed per-triangle shading+material record
    fp_light: Any        # (16, L) f32 packed light table (incl. sphere rows)
    fp_sph: Any          # (S, 24) f32 packed per-sphere record

    # --- shape table -------------------------------------------------------
    shape_material_id: Any    # (NS,) i32
    shape_light_id: Any       # (NS,) i32  (area light id or -1)
    shape_interior_med: Any   # (NS,) i32
    shape_exterior_med: Any   # (NS,) i32
    shape_type: Any           # (NS,) i32
    shape_prim_start: Any     # (NS,) i32
    shape_prim_count: Any     # (NS,) i32
    shape_area: Any           # (NS,) f32
    shape_has_normals: Any    # (NS,) i32
    shape_has_uvs: Any        # (NS,) i32
    tri_stair_cdf: Any        # (T,) f32 staircase CDF (segment = shape) for triangle pick
    tri_alias: Any            # (T,2) f32 per-shape alias tables (globalized aliases)
    tri_area: Any             # (T,) f32

    # --- materials ----------------------------------------------------------
    mat_type: Any        # (M,) i32
    mat_tex: Any         # (M, NUM_PARAM_SLOTS) i32 texture descriptor ids
    mat_eta: Any         # (M,) f32

    # --- texture descriptors + mipmapped image pool -------------------------
    tex_kind: Any        # (NT,) i32
    tex_const: Any       # (NT,3) f32 (constant value / checker color0)
    tex_color1: Any      # (NT,3) f32 (checker color1)
    tex_image: Any       # (NT,) i32
    tex_uvscale: Any     # (NT,2) f32
    tex_uvoffset: Any    # (NT,2) f32
    texdata: Any         # (TOTAL,12) f32 quad-packed mip texels (texture.py)
    mip_tab: Any         # (NI, 25) f32 [off x8 | w x8 | h x8 | nlev]
    mip_offset: Any      # (NI, MAX_MIP_LEVELS) i32
    mip_w: Any           # (NI, MAX_MIP_LEVELS) i32
    mip_h: Any           # (NI, MAX_MIP_LEVELS) i32
    mip_levels: Any      # (NI,) i32

    # --- lights --------------------------------------------------------------
    light_type: Any      # (L,) i32
    light_shape: Any     # (L,) i32
    light_intensity: Any # (L,3) f32
    light_cdf: Any       # (L,) f32 power-weighted (scene.cpp:48-52)
    light_pmf: Any       # (L,) f32
    env_to_world: Any    # (4,4) f32
    env_to_local: Any    # (4,4) f32
    env_scale: Any       # () f32
    env_cond_cdf: Any    # (H,W) f32
    env_marg_cdf: Any    # (H,) f32
    env_pdf_uv: Any      # (H,W) f32 sampling density over [0,1]^2
    env_alias: Any       # (H*W,2) f32 alias table over envmap cells

    # --- media + volumes ------------------------------------------------------
    med_type: Any        # (NM,) i32
    med_sigma_a: Any     # (NM,3) f32
    med_sigma_s: Any     # (NM,3) f32
    med_phase_type: Any  # (NM,) i32
    med_g: Any           # (NM,) f32
    med_albedo_vol: Any  # (NM,) i32
    med_density_vol: Any # (NM,) i32
    vol_kind: Any        # (NV,) i32
    vol_const: Any       # (NV,3) f32
    vol_offset: Any      # (NV,) i32
    vol_res: Any         # (NV,3) i32  (xres,yres,zres)
    vol_pmin: Any        # (NV,3) f32
    vol_pmax: Any        # (NV,3) f32
    vol_maxval: Any      # (NV,3) f32  (max grid value × scale)
    volume_data: Any     # (TOTALV,24) f32 octo-packed cell corners (compile.py)
    svox_data: Any       # (TOTS,8) f32 per-supervoxel majorant rgb |
                         # empty-skip distance | control (minorant) rgb | pad
    fp_grid: Any         # (Z*Y, X) f32 mono density grid (x scale) of the
                         # fused grid kernel K9 ((1,1) unless
                         # meta.grid_kernel_ok)
    med_tab: Any         # (NM,46) f32 wide medium row (see compile.py)

    # --- merged wide-row tables (lajolla_tpu/scene/soa.py) ----------------------------
    tri_shade: Any       # (T, 25) f32 denormalized per-triangle shading record
    shape_tab: Any       # (NS, 10) f32
    light_tab: Any       # (L, 6) f32
    mat_tab: Any         # (M, 15) f32
    tex_tab: Any         # (NT, 12) f32

    # --- camera ---------------------------------------------------------------
    cam_to_world: Any    # (4,4) f32
    world_to_cam: Any    # (4,4) f32
    sample_to_cam: Any   # (4,4) f32
    cam_to_sample: Any   # (4,4) f32

    # --- static ---------------------------------------------------------------
    meta: SceneMeta = None

    def to(self, device):
        """The same scene with every tensor on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in fields(self) if f.name != 'meta'})
