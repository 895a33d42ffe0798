"""Render checkpoint/resume.

State = (film accumulator, samples completed, seed). Sufficient because
the sampler is counter-based — sample s of pixel p is a pure function of
(seed, p, s) — so resuming at sample index s0 reproduces exactly the
render that would have run uninterrupted. (The reference has no
checkpointing; a render runs to completion or dies — SURVEY §5.)
"""

import os

import numpy as np


def save_film(path, seed, film_sum, samples_done):
    tmp = path + ".tmp"
    np.savez(tmp, film_sum=film_sum, samples_done=samples_done, seed=seed)
    os.replace(tmp + ".npz", path)


def load_film(path, seed, shape):
    """Returns (film_sum or None, samples_done)."""
    if not os.path.exists(path):
        return None, 0
    try:
        z = np.load(path)
        if int(z["seed"]) != seed or z["film_sum"].shape != shape:
            return None, 0
        return z["film_sum"], int(z["samples_done"])
    except Exception:
        return None, 0
