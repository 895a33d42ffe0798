"""Carry a compiled lajolla_tpu scene into the port.

Tests hand the port the very arrays lajolla_tpu compiled, so both sides
start from the same bytes: the geometry, BVH, cluster and sweep tables,
and the material, light, texture and media tables (`med_tab`, the
`med_*` and `vol_*` arrays) alike. This
module never imports JAX: it reads the lajolla_tpu Scene's fields with
`np.asarray` and its SceneMeta with `dataclasses.asdict`.
"""

import dataclasses

import numpy as np
import torch

from lajolla_tpu_torch.scene.types import Scene, SceneMeta


def scene_from_jax(js, device='cpu'):
    """The port's Scene on `device` from a compiled lajolla_tpu Scene.
    Fields the port's Scene does not hold are ignored; a field the port needs and `js` lacks raises
    AttributeError."""
    tensors = {f.name: torch.from_numpy(np.array(getattr(js, f.name)))
               .to(device)
               for f in dataclasses.fields(Scene) if f.name != 'meta'}
    return Scene(**tensors, meta=SceneMeta(**dataclasses.asdict(js.meta)))
