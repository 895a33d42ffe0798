"""The film's return to the host at the end of render_path and
render_volpath: the film sum over the samples a pixel, as a numpy array.

On a CUDA device the film sum, a tensor the driver owns and needs no
more, is divided in place on the device by a cached 0-dim tensor of the
samples: an IEEE division, equal bit for bit to numpy's `/ spp` (torch's
CUDA division by a Python number multiplies by its reciprocal, a bit off
where spp is not a power of two). One asynchronous copy then takes it
into a pinned host block of the film's strides behind the work queued
before it, the host waits on an event, and the block's ndarray is
returned: no host memory is allocated and no host core divides. The
ndarray has the film's strides, as `film.cpu().numpy() / spp` has: K1's
and K8's films are their (3, h*w) sums seen as (h, w, 3).

The pool keeps up to BLOCKS blocks of the latest film's shape, strides,
dtype and device (a new one drops them) and reuses a block only once nothing
outside the pool refers to it: neither the ndarray it returned nor a
view of it. Two blocks let a caller hold the last frame while it renders
the next one. Where both are held, or the film is not dense (not a
permutation of a contiguous tensor), the film takes the pageable copy,
`film.cpu().numpy()` after the same division, in the span
`render.film_copy.pageable`; so pinned memory never passes two films and
a frame a caller holds is never written. FILM_RETURNS counts each CUDA
film's route. On any other device the quotient is numpy's,
`film.cpu().numpy() / spp`, and the film is left as it was. The pool is
one per process and not thread-safe, like the span recorder: the
program's layers run on one host thread."""

import sys

import numpy as np
import torch

from lajolla_tpu_torch.utils import profiling

BLOCKS = 2
# The route of every CUDA film's return.
FILM_RETURNS = {'pinned': 0, 'pageable': 0}


def _pinned(shape, stride, dtype):
    return torch.empty_strided(shape, stride, dtype=dtype, pin_memory=True)


def _dense(film):
    """Whether `film` is a permutation of a contiguous tensor, so that a
    block of its strides takes it in one copy."""
    order = sorted(range(film.dim()), key=film.stride, reverse=True)
    return film.permute(order).is_contiguous()


class _Memory:
    """The base of a block's ndarray: it keeps the block's tensor alive
    and is referred to by nothing else, so that the ndarray's references
    count its holders (a view's base is the ndarray)."""

    def __init__(self, tensor):
        self.tensor = tensor
        self.__array_interface__ = tensor.numpy().__array_interface__


class FilmPool:
    """Host blocks for the films of one shape, strides, dtype and device,
    each a tensor that takes a film's copy and one ndarray over its memory
    that callers get. `alloc(shape, stride, dtype)` makes a block's tensor
    (default: pinned memory)."""

    def __init__(self, alloc=_pinned):
        self.alloc = alloc
        self.key = None
        self.blocks = []
        self.divisor = None

    def _divisor(self, film, spp):
        key = (film.device, film.dtype, spp)
        if self.divisor is None or self.divisor[0] != key:
            self.divisor = (key, torch.tensor(spp, dtype=film.dtype,
                                              device=film.device))
        return self.divisor[1]

    def _free_block(self, film):
        """(tensor, ndarray) of a block of the film's layout that nothing
        outside the pool refers to, made if the pool holds fewer than
        BLOCKS; else None."""
        key = (tuple(film.shape), film.stride(), film.dtype, film.device)
        if key != self.key:
            self.key, self.blocks = key, []
        for block in self.blocks:
            # the ndarray's references: the block's, getrefcount's
            # argument; its base's: the ndarray's, the argument
            if (sys.getrefcount(block[1]) == 2 and
                    sys.getrefcount(block[1].base) == 2):
                return block
        if len(self.blocks) == BLOCKS:
            return None
        tensor = self.alloc(film.shape, film.stride(), film.dtype)
        self.blocks.append((tensor, np.asarray(_Memory(tensor))))
        return self.blocks[-1]

    def return_film(self, film, spp):
        """film / spp as a host ndarray; `film` is divided in place."""
        film.div_(self._divisor(film, spp))
        block = self._free_block(film) if _dense(film) else None
        if block is None:
            FILM_RETURNS['pageable'] += 1
            with profiling.span('render.film_copy.pageable'):
                return film.cpu().numpy()
        FILM_RETURNS['pinned'] += 1
        tensor, array = block
        tensor.copy_(film, non_blocking=True)
        if film.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(film.device))
            done.synchronize()
        return array


_POOL = FilmPool()


def _pool_for(film):
    """The pool that returns `film`, or None where numpy divides."""
    return _POOL if film.device.type == 'cuda' else None


def return_film(film, spp):
    """The film sum `film` (h, w, 3) over `spp` samples a pixel as a host
    ndarray (module docstring)."""
    pool = _pool_for(film)
    if pool is None:
        return film.cpu().numpy() / spp
    return pool.return_film(film, spp)
