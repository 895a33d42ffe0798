"""Discrete sampling distributions.

The reference's TableDist1D/TableDist2D (src/table_dist.h/.cpp) build
pmf/cdf vectors at scene-construction time and binary-search them per
sample. Here: CDFs are built host-side in numpy (float64) and shipped to
the device as fp32 arrays; the samplers that read them live with the
kernels that use them (integrators/path_kernel.py).

Segmented variant: many per-shape triangle-area distributions are packed
into ONE flat array using the "staircase CDF" trick — entry i of segment s
stores  s + cdf_within_segment(i),  so sampling segment s with uniform u is
a single global `searchsorted(flat_cdf, s + u)`. This keeps per-shape
sampling branch-free and shape-count-independent on device.
"""

import numpy as np


# ---------------------------------------------------------------------------
# Host-side builders
# ---------------------------------------------------------------------------

def build_cdf_1d(weights):
    """Normalized inclusive CDF; returns (pmf, cdf) float64.
    cdf[i] = P(X <= i), cdf[-1] == 1. Zero-total weights → uniform."""
    w = np.asarray(weights, np.float64)
    total = w.sum()
    if total <= 0:
        w = np.ones_like(w)
        total = w.sum()
    pmf = w / total
    cdf = np.cumsum(pmf)
    cdf[-1] = 1.0
    return pmf, cdf


def build_segmented_cdf(weights, seg_offsets, seg_counts):
    """Pack per-segment CDFs into one staircase array.

    weights: flat (N,) per-item weights; segment s owns
    weights[seg_offsets[s] : seg_offsets[s]+seg_counts[s]].
    Returns (pmf_flat, stair_cdf_flat) where stair_cdf[i] = s + cdf_in_s(i).
    """
    w = np.asarray(weights, np.float64)
    pmf = np.zeros_like(w)
    stair = np.zeros_like(w)
    for s, (off, cnt) in enumerate(zip(seg_offsets, seg_counts)):
        seg = w[off:off + cnt]
        p, c = build_cdf_1d(seg)
        pmf[off:off + cnt] = p
        stair[off:off + cnt] = s + c
    return pmf, stair


def build_cdf_2d(weights):
    """2D row-conditional + marginal CDFs (reference table_dist.cpp:40-151).

    weights: (H, W). Returns dict of float64 arrays:
      cond_pmf (H,W), cond_cdf (H,W), marg_pmf (H,), marg_cdf (H,),
      total (scalar mean weight, used for pdf normalization).
    """
    w = np.asarray(weights, np.float64)
    h, wdt = w.shape
    row_sums = w.sum(axis=1)
    total = row_sums.sum()
    if total <= 0:
        w = np.ones_like(w)
        row_sums = w.sum(axis=1)
        total = row_sums.sum()
    cond_pmf = w / np.maximum(row_sums[:, None], 1e-300)
    zero_rows = row_sums <= 0
    cond_pmf[zero_rows] = 1.0 / wdt
    cond_cdf = np.cumsum(cond_pmf, axis=1)
    cond_cdf[:, -1] = 1.0
    marg_pmf = row_sums / total
    marg_cdf = np.cumsum(marg_pmf)
    marg_cdf[-1] = 1.0
    return dict(cond_pmf=cond_pmf, cond_cdf=cond_cdf,
                marg_pmf=marg_pmf, marg_cdf=marg_cdf,
                unit_pdf_scale=w * (h * wdt) / total)


# ---------------------------------------------------------------------------
# Alias method (Walker/Vose) — O(1) discrete sampling.
#
# A CDF sampler costs log(N) scalar gathers per lane (and the 2D one
# gathers a whole W-wide conditional row); an alias table needs ONE
# 2-float row gather per sample. The reference uses binary
# CDF search (table_dist.h); the distribution sampled is identical.
# ---------------------------------------------------------------------------

def build_alias(weights):
    """(M,) nonnegative weights -> (M, 2) f32 alias table rows
    [acceptance threshold q_i, alias index]."""
    w = np.asarray(weights, np.float64).ravel()
    M = w.shape[0]
    # Alias indices live in an f32 column: exact only below 2^24.
    assert M < (1 << 24), \
        f"alias table with {M} cells: f32 index column would lose precision"
    total = w.sum()
    alias = np.arange(M)
    if total <= 0 or M == 0:
        return np.stack([np.ones(max(M, 1)),
                         np.arange(max(M, 1))], axis=1).astype(np.float32)
    q = w * (M / total)
    small = [i for i in range(M) if q[i] < 1.0]
    large = [i for i in range(M) if q[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        alias[s] = l
        q[l] -= 1.0 - q[s]
        (small if q[l] < 1.0 else large).append(l)
    for i in small + large:
        q[i] = 1.0
    return np.stack([q, alias.astype(np.float64)], axis=1).astype(
        np.float32)
