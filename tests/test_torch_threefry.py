"""The port's threefry-2x32 (lajolla_tpu_torch/core/random.py) against
`jax.random`, bit for bit, on the CPU.

- prng_key, fold_in, split and uniform on numpy-seeded keys and data,
  including seeds and data of 2^31 and above: equal words, and equal
  float32 bits for the uniforms;
- `jax_threefry_partitionable` is true: the semantics the port copies;
- volpath._uniforms and the per-(pixel, sample) key chain of
  _render_volpath_simple_block on a 7x5 film: equal bits against
  lajolla_tpu's under jax.vmap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lajolla_tpu.integrators.volpath as JV
import lajolla_tpu_torch.integrators.volpath as PV
from lajolla_tpu_torch.core import random as R

from torch_threads import one_thread  # noqa: F401

SEEDS = [0, 1, 5, 123456789, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1]


def words(rng, shape):
    """Random 32-bit words with the top bit set on about half, and the
    edge words 0, 2^31 - 1, 2^31 and 2^32 - 1 in front."""
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    flat = w.reshape(-1)
    flat[:edge.size] = edge[:flat.size]
    return w


def t64(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def test_partitionable_mode():
    assert jax.config.jax_threefry_partitionable, (
        "core/random.py copies jax.random with jax_threefry_partitionable "
        "true; this JAX has it false, which changes split and uniform")


@pytest.mark.parametrize('seed', SEEDS)
def test_prng_key(seed):
    want = np.asarray(jax.random.PRNGKey(np.uint32(seed)))
    assert np.array_equal(R.prng_key(seed).numpy()[0],
                          want.astype(np.int64))


def test_fold_in():
    rng = np.random.default_rng(1)
    keys, data = words(rng, (257, 2)), words(rng, 257)
    want = jax.vmap(jax.random.fold_in)(keys, data)
    got = R.fold_in(t64(keys), t64(data))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    # one Python int folded into every key
    want = jax.vmap(jax.random.fold_in, (0, None))(keys, np.uint32(2**31 + 7))
    got = R.fold_in(t64(keys), 2**31 + 7)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_split():
    rng = np.random.default_rng(2)
    keys = words(rng, (257, 2))
    want = np.asarray(jax.vmap(jax.random.split)(keys)).astype(np.int64)
    key, sub = R.split(t64(keys))
    assert np.array_equal(key.numpy(), want[:, 0])
    assert np.array_equal(sub.numpy(), want[:, 1])


@pytest.mark.parametrize('n', [1, 2, 5, 33])
def test_uniform(n):
    rng = np.random.default_rng(3 + n)
    keys = words(rng, (513, 2))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))
    got = R.uniform(t64(keys), n).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert (got >= 0).all() and (got < 1).all()


def test_uniforms_of_volpath():
    rng = np.random.default_rng(4)
    keys = words(rng, (129, 2))
    wk, wu = jax.vmap(lambda k: JV._uniforms(k, 5))(keys)
    gk, gu = PV._uniforms(t64(keys), 5)
    assert np.array_equal(gk.numpy(), np.asarray(wk).astype(np.int64))
    assert np.array_equal(gu.numpy().view(np.int32),
                          np.asarray(wu).view(np.int32))


@pytest.mark.parametrize('seed,s0', [(0, 0), (7, 3), (2**31 + 9, 2**31)])
def test_simple_block_key_chain(seed, s0):
    """The keys of pixel p, sample s0 + i on a 7x5 film, as lajolla_tpu's
    _render_volpath_simple_block derives them."""
    w, h, nspp = 7, 5, 3
    pix = jnp.arange(w * h, dtype=jnp.uint32)
    root = jax.random.PRNGKey(np.uint32(seed))
    pk = jax.vmap(jax.random.fold_in, (None, 0))(root, pix)
    got_pk = R.fold_in(R.prng_key(seed), t64(np.arange(w * h)))
    assert np.array_equal(got_pk.numpy(), np.asarray(pk).astype(np.int64))
    for i in range(nspp):
        want = jax.vmap(jax.random.fold_in, (0, None))(
            pk, (jnp.uint32(s0) + jnp.uint32(i)))
        got = R.fold_in(got_pk, s0 + i)
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
        # and the first draw of each tracer: the subpixel uniforms
        _, wu = jax.vmap(lambda k: JV._uniforms(k, 2))(want)
        _, gu = PV._uniforms(got, 2)
        assert np.array_equal(gu.numpy().view(np.int32),
                              np.asarray(wu).view(np.int32))
