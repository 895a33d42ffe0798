"""Carry a compiled lajolla_tpu scene into the port.

Tests hand the port the very arrays lajolla_tpu compiled, so both sides
start from the same bytes. The caller takes `np.asarray` of each field
of a lajolla_tpu Scene and `dataclasses.asdict(scene.meta)`: this module
never imports JAX.
"""

import dataclasses

import numpy as np
import torch

from lajolla_tpu_torch.scene.types import Scene, SceneMeta


def scene_from_jax_arrays(fields, meta, device):
    """The port's Scene on `device` from {field name: ndarray} of a
    compiled lajolla_tpu Scene and its SceneMeta as a dict. Fields the
    port's Scene does not hold (BVH, cluster, grid tables) are ignored;
    a missing field raises KeyError."""
    tensors = {f.name: torch.from_numpy(np.array(fields[f.name])).to(device)
               for f in dataclasses.fields(Scene) if f.name != 'meta'}
    return Scene(**tensors, meta=SceneMeta(**meta))
