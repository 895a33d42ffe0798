"""Auxiliary debug integrators: depth / shadingNormal / meanCurvature /
rayDifferential / mipmapLevel (reference render.cpp:12-69), batched over
the pixel grid.

Port of lajolla_tpu/integrators/aux.py: deterministic pixel-centre rays
from scene/camera.sample_primary, one intersect_scene(need_aux=True)
cast (kernel K3, or the cluster sweeps on a scene with cluster tables),
one colour a pixel.
"""

import torch

from lajolla_tpu_torch.core.math import length
from lajolla_tpu_torch.integrators.path import SWEEP_LANES_BIG
from lajolla_tpu_torch.ops.intersect import INF
from lajolla_tpu_torch.scene.camera import sample_primary
from lajolla_tpu_torch.scene.geometry import intersect_scene
from lajolla_tpu_torch.scene.texeval import image_mip_level
from lajolla_tpu_torch.scene.types import P_BASE_COLOR, TEX_IMAGE

def init_ray_diff_spread(w, h):
    """init_ray_differential (ray.h:35-37)."""
    return 0.25 / max(w, h)


def _cast(scene, org, d):
    """The primary hits; a scene with cluster tables casts in chunks of
    SWEEP_LANES_BIG rays (the sweep's list build makes dense rays x
    clusters tensors), a Hit of every chunk's fields concatenated."""
    n = org.shape[0]
    if not scene.meta.use_binned or n <= SWEEP_LANES_BIG:
        return intersect_scene(scene, org, d, 0.0, INF, need_aux=True)
    parts = [intersect_scene(scene, org[i:i + SWEEP_LANES_BIG],
                             d[i:i + SWEEP_LANES_BIG], 0.0, INF,
                             need_aux=True)
             for i in range(0, n, SWEEP_LANES_BIG)]
    return type(parts[0])(*(torch.cat(f) for f in zip(*parts)))


def _pixels(scene, options, px, py, mode):
    """The colours of pixels (px, py) ((N,) int) → (N, 3)."""
    n = px.shape[0]
    org, d = sample_primary(scene, options, px.to(torch.float32),
                            py.to(torch.float32),
                            torch.full((n, 2), 0.5, device=px.device))
    hit = _cast(scene, org, d)
    dist = length(hit.position - org)
    spread = init_ray_diff_spread(scene.meta.width, scene.meta.height)
    radius = spread * dist  # transfer() from radius 0
    ones = torch.ones_like(org)

    if mode == 'depth':
        color = ones * dist[:, None]
    elif mode == 'shadingNormal':
        color = hit.frame[:, 2]
    elif mode == 'meanCurvature':
        color = ones * hit.mean_curvature[:, None]
    elif mode == 'rayDifferential':
        # render.cpp:41 reads ray_diff.radius AFTER intersect() — which
        # never mutates the differential (intersection.cpp:54 stores the
        # transferred radius on the vertex instead), so the reference's
        # radius channel is identically the init value 0. Replicated.
        color = torch.zeros_like(org)
        color[:, 1] = spread
    elif mode == 'mipmapLevel':
        mat = torch.clamp(hit.material_id, min=0).long()
        tex_id = scene.mat_tex[mat, P_BASE_COLOR].long()
        is_img = scene.tex_kind[tex_id] == TEX_IMAGE
        footprint = radius / torch.clamp(hit.inv_uv_size, min=1e-20)
        if scene.meta.has_image_textures:
            level = image_mip_level(scene, scene.tex_image[tex_id],
                                    scene.tex_uvscale[tex_id], footprint)
        else:
            level = torch.zeros_like(footprint)
        color = torch.where(is_img[:, None], ones * level[:, None], 0.0)
    else:
        raise ValueError(mode)
    return torch.where(hit.valid[:, None], color, 0.0)


def render_aux_rows(scene, options, y0, rows):
    """Pixel rows y0 .. y0 + rows of the film of integrator
    options.integrator → (rows, W, 3) float32 tensor on the scene's
    device. Rows past the film's last are computed like any other (their
    camera rays leave the film's frustum); parallel/mesh.py splits a film
    into equal row blocks and drops them."""
    w = scene.meta.width
    dev = scene.cam_to_world.device
    ys, xs = torch.meshgrid(torch.arange(y0, y0 + rows, device=dev),
                            torch.arange(w, device=dev), indexing='ij')
    img = _pixels(scene, options, xs.reshape(-1), ys.reshape(-1),
                  options.integrator)
    return img.reshape(rows, w, 3)


def render_aux(scene, options):
    """The film of integrator options.integrator → (H, W, 3) float32
    tensor on the scene's device."""
    return render_aux_rows(scene, options, 0, scene.meta.height)
