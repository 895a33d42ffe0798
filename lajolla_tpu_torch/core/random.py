"""The port's random numbers: the counter hash and threefry-2x32.

The counter hash (`pcg_hash`, `hash_u01`) draws every uniform of the
path and volpath engines, of kernels K1, K2, K8 and K9 and of their
plain forms: each is a pure function of (seed, work item, bounce, dim),
as in lajolla_tpu's integrators/path.py. The CUDA side is csrc/
path_advance.cuh `pcg_hash` and `u01`.

Threefry-2x32 keys and uniforms are bit for bit those of `jax.random`.
The pedagogical volpath versions 1 and 2 (integrators/volpath.py) and
the differentiable volumetric render (integrators/diffpath.py) draw their
random numbers from `jax.random` keys in lajolla_tpu, not from the
counter hash of the other engines; this module gives the same bits.
The semantics are those of `jax.random` with `jax_threefry_partitionable`
true (the default of JAX 0.5 and later):
- prng_key(seed) is the key (0, seed mod 2^32);
- fold_in(k, d) is threefry2x32(k, (0, d));
- split(k) is threefry2x32(k, ((0, 0), (0, 1))): key 0 and key 1, as
  `key, sub = jax.random.split(key)` unpacks them;
- uniform(k, n) takes bits = y0 ^ y1 of threefry2x32(k, (0, i)) for
  i < n and maps them to [0, 1) through the float32 bit pattern
  (bits >> 9) | 0x3F800000, less 1.

Torch has no uint32 `+` or `>>` on the CPU, so words are int64 tensors
(or Python ints) holding values below 2^32, masked after every add and
shift that can carry. Every threefry function is batched over a leading
axis of keys, (N, 2).
"""

import torch

M32 = 0xFFFFFFFF
GOLD = 0x9E3779B9  # 2^32 / golden ratio: decorrelates dimension streams
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def pcg_hash(v):
    """The PCG hash of 32-bit words (Jarzynski & Olano, "Hash Functions
    for GPU Rendering")."""
    v = (v * 747796405 + 2891336453) & M32
    w = (((v >> ((v >> 28) + 4)) ^ v) * 277803737) & M32
    return (w >> 22) ^ w


def hash_u01(x):
    """32-bit hash word -> U[0,1) float32 (top 24 bits)."""
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al., "Parallel Random Numbers:
    As Easy as 1, 2, 3"), as `jax.random` computes it. All four words are
    int64 tensors of values below 2^32 that broadcast together; returns
    (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed, device='cpu'):
    """The (1, 2) int64 key of `jax.random.PRNGKey(seed)`."""
    return torch.tensor([[0, int(seed) & M32]], dtype=torch.int64,
                        device=device)


def fold_in(keys, data):
    """`jax.random.fold_in` of each key of `keys` ((N, 2) or (1, 2)) with
    `data` (a Python int or an (N,) int64 tensor of 32-bit words;
    reduced mod 2^32). Returns (N, 2)."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data) & M32, dtype=torch.int64,
                            device=keys.device)
    data = data & M32
    y0, y1 = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def _counters(keys, n):
    """threefry2x32 of each key over the counters (0, i), i < n: (y0, y1),
    each (N, n)."""
    cnt = torch.arange(n, dtype=torch.int64, device=keys.device)
    return threefry2x32(keys[:, 0, None], keys[:, 1, None],
                        torch.zeros_like(cnt), cnt)


def split(keys):
    """`jax.random.split` of each key into two: (key, sub), each (N, 2)."""
    y0, y1 = _counters(keys, 2)
    return (torch.stack([y0[:, 0], y1[:, 0]], -1),
            torch.stack([y0[:, 1], y1[:, 1]], -1))


def uniform(keys, n):
    """(N, n) float32 `jax.random.uniform(key, (n,))` per key."""
    y0, y1 = _counters(keys, n)
    word = ((y0 ^ y1) >> 9) | 0x3F800000
    # the same 32 bits as an int32 (words >= 2^31 wrap to negative) read
    # as float32
    word = ((word + (1 << 31)) & M32) - (1 << 31)
    f = word.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f, min=0.0)
