"""How a run decides `correct`: the frames the window produced, held pixel
by pixel against the reference (benchmark/reference).

Before the window the run draws from its seed the same number of pixels
from every BLOCK-pixel block of the film (the tail block, where the film
is not a whole number of them, included), and keeps those pixels of every
frame the window renders. After the window, with the program's state
freed, it draws from the seed the frames to compare, and the reference
traces every sample of the kept pixels of each, on the same work items and
random numbers as the program. The numbers compared:

- `block_off`: the largest share, over the film's blocks, of a block's
  compared pixels whose largest channel differs from the reference's by
  more than OFF_REL relatively, |got - want| / (want + 1e-3). A path
  traced in a different float order can take another turn (a roulette
  draw or a hit at an edge), so a few pixels differ in sound runs; a
  wrong estimator, a lower precision, another frame, or one block (the
  tail's) rendered wrong moves most of a block's.
- `median_rel`: the median over pixels and channels of that relative
  difference: sound runs agree to rounding on most pixels, so it sits
  near float32's resolution, where a lower precision, another frame or
  samples left out move it by orders of magnitude.
- `mean_gap`: the relative gap between the pixels' means: a bias, or
  samples left out, moves it.
"""

import hashlib

import numpy as np
import torch

OFF_REL = 1e-3
NUMBERS = ('block_off', 'median_rel', 'mean_gap')
# Pixels of a block: the work-queue block of the port's fused path kernel
# (K1), frozen here.
BLOCK = 4096


def frame_seed(seed, k):
    """The render seed of frame k of a run with --seed `seed`: 31 bits of
    a hash of both, so no two frames of a run draw the same samples."""
    digest = hashlib.sha256(f'{int(seed)}:{int(k)}'.encode()).digest()
    return int.from_bytes(digest[:4], 'little') & 0x7FFFFFFF


def _rng(seed, stream):
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def sample_pixels(seed, n, per_block):
    """`per_block` distinct pixel indices (all, where a block holds fewer)
    of every BLOCK-pixel block of an n-pixel film, sorted, drawn from the
    seed."""
    rng = _rng(seed, 1)
    picks = [start + rng.choice(size, size=min(per_block, size),
                                replace=False)
             for start in range(0, n, BLOCK)
             for size in [min(BLOCK, n - start)]]
    return np.sort(np.concatenate(picks))


def sample_frames(seed, frames, count):
    """`count` distinct frame indices of `frames` finished frames, drawn
    from the seed."""
    return sorted(_rng(seed, 2).choice(frames, size=min(count, frames),
                                       replace=False).tolist())


def compare(got, want, pixels):
    """The numbers compared of the program's pixels `got` against the
    reference's `want`, both (F, P, 3): F frames at the film's pixels
    `pixels` (P,)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if not np.isfinite(got).all():
        return dict(block_off=1.0, median_rel=float('inf'),
                    mean_gap=float('inf'))
    rel = np.abs(got - want) / (np.abs(want) + 1e-3)
    off = (rel.max(axis=2) > OFF_REL).mean(axis=0)          # (P,)
    block = np.asarray(pixels) // BLOCK
    counts = np.bincount(block)
    shares = np.bincount(block, weights=off)[counts > 0] / counts[counts > 0]
    return dict(block_off=float(shares.max()),
                median_rel=float(np.median(rel)),
                mean_gap=float(abs(got.mean() - want.mean()) /
                               max(abs(want.mean()), 1e-12)))


def verdict(numbers, limits):
    """True where every number compared lies within its limit."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)


def bf16_round(x):
    """A float tensor rounded through bfloat16: the control's precision."""
    return x.to(torch.bfloat16).to(x.dtype)


def reference_pixels(kind, ref, frame_seeds, pixels, spp, chunk,
                     rounding=None, stats=None):
    """(F, P, 3): each frame's reference film at the given pixels, the sum
    of its spp samples over spp, as the program divides it, traced by the
    configuration's kind (benchmark/kinds) on its reference scene `ref`."""
    if rounding is not None:
        ref = kind.rounded(ref, rounding)
    return np.stack([(kind.film_pixels(ref, s, pixels, spp, chunk, rounding,
                                       stats) / spp).cpu().numpy()
                     for s in frame_seeds])
