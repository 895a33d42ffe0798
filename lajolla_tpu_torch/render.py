"""Render driver: integrator dispatch + film assembly.

The analogue of render() (src/render.cpp:155-167) and of
lajolla_tpu/render.py. The `path` integrator, `volpath` (the
single-scattering versions 1 and 2, and the final integrator for
homogeneous and heterogeneous media, versions 3-5) and the five aux
integrators are ported.
"""

import numpy as np
import torch

from lajolla_tpu_torch.scene.types import RenderOptions
from lajolla_tpu_torch.utils import profiling

_AUX = ('depth', 'shadingNormal', 'meanCurvature', 'rayDifferential',
        'mipmapLevel')


def render(scene, options=None, *, device, seed=0, checkpoint=None,
           progress=False):
    """Render on `device` → (H, W, 3) float32 numpy image.

    checkpoint: optional path; the film accumulator + sample index are
    persisted after every block, and an interrupted render resumes
    exactly (counter-based RNG makes the remaining samples independent
    of when they are computed).

    Spans (utils/profiling.py, while its recorder is on): `render` around
    the call, one frame; `render.prepare` around the checks, the dispatch
    and the scene's move to `device`.
    """
    with profiling.frame('render'):
        with profiling.span('render.prepare'):
            device = torch.device(device)
            if device.type == 'cuda' and not torch.cuda.is_available():
                raise RuntimeError("render on a CUDA device, but "
                                   "torch.cuda.is_available() is False")
            if options is None:
                options = RenderOptions()
            if options.integrator in _AUX:
                from lajolla_tpu_torch.integrators.aux import \
                    render_aux as driver
            elif options.integrator == 'volpath':
                from lajolla_tpu_torch.integrators.volpath import \
                    render_volpath as driver
            elif options.integrator == 'path':
                from lajolla_tpu_torch.integrators.path import \
                    render_path as driver
            else:
                raise ValueError(f"unknown integrator: {options.integrator}")
            scene = scene.to(device)
        if options.integrator in _AUX:
            return driver(scene, options).cpu().numpy()
        img = driver(scene, options, seed, checkpoint=checkpoint,
                     progress=progress)
        return np.asarray(img, np.float32)
