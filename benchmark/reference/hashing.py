"""The counter-hash random numbers of the port's surface estimator, frozen: every
uniform is a pure function of (seed, work item, vertex, dimension)
(Jarzynski and Olano, "Hash Functions for GPU Rendering"). Words are int64
tensors or Python ints holding values below 2^32, masked after every step
that can carry."""

import torch

_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9        # 2^32 / golden ratio: decorrelates dimensions
_CAMERA_SALT = 0xCAFEF00D


def _pcg_hash(v):
    v = (v * 747796405 + 2891336453) & _M32
    w = (((v >> ((v >> 28) + 4)) ^ v) * 277803737) & _M32
    return (w >> 22) ^ w


def _hash_u01(x):
    """32-bit hash word -> U[0,1) float32 (its top 24 bits)."""
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


def vertex_uniforms(item, nv, su):
    """(8, N) uniforms of path vertex nv of work items `item` (N,) under
    the surface estimator's stream root su."""
    kidx = (torch.arange(1, 9, device=item.device) * _GOLD) & _M32
    hb = _pcg_hash(item ^ _pcg_hash(nv ^ su)).reshape(1, -1)
    return _hash_u01(_pcg_hash((hb + kidx[:, None]) & _M32))


def surface_root(seed):
    """The surface estimator's stream root: the seed's low 32 bits."""
    return int(seed) & _M32

