"""Discrete sampling distributions.

The reference's TableDist1D/TableDist2D (src/table_dist.h/.cpp) build
pmf/cdf vectors at scene-construction time and binary-search them per
sample. Here: CDFs are built host-side in numpy (float64) and shipped to
the device as fp32 arrays; the device samplers at the end of this module
read them batched over lanes (the fused kernels carry their own).

Segmented variant: many per-shape triangle-area distributions are packed
into ONE flat array using the "staircase CDF" trick — entry i of segment s
stores  s + cdf_within_segment(i),  so sampling segment s with uniform u is
a single global `searchsorted(flat_cdf, s + u)`. This keeps per-shape
sampling branch-free and shape-count-independent on device.
"""

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# Device-side sampling, batched over a leading lane axis
# ---------------------------------------------------------------------------

def sample_cdf(cdf, u):
    """Inverse-CDF sample per lane: smallest i with cdf[i] >= u (u: (N,)).
    Small tables use a dense compare-count, large ones a binary search,
    as lajolla_tpu's sampler does; both agree on a nondecreasing cdf."""
    if cdf.shape[0] <= 512:
        i = (cdf[None, :] < u[:, None]).sum(dim=1)
    else:
        i = torch.searchsorted(cdf, u.contiguous(), side='left')
    return torch.clamp(i, 0, cdf.shape[0] - 1)


def sample_segmented(stair_cdf, seg_id, u):
    """Sample within segment seg_id of a staircase CDF. Returns the global
    flat index per lane."""
    i = torch.searchsorted(stair_cdf, (seg_id.to(stair_cdf.dtype) + u)
                           .contiguous(), side='left')
    return torch.clamp(i, 0, stair_cdf.shape[0] - 1)


def sample_cdf_2d(marg_cdf, cond_cdf, u):
    """u: (N, 2) uniforms. Returns (row, col, u_remap (N, 2)): u_remap are
    the continuous offsets within the chosen cell."""
    row = sample_cdf(marg_cdf, u[:, 1])
    row_cdf = cond_cdf[row]                                   # (N, W)
    col = torch.clamp(torch.searchsorted(
        row_cdf, u[:, 0:1].contiguous(), side='left')[:, 0],
        0, cond_cdf.shape[1] - 1)
    marg_lo = torch.where(row > 0, marg_cdf[torch.clamp(row - 1, min=0)],
                          0.0)
    marg_p = marg_cdf[row] - marg_lo
    dv = torch.where(marg_p > 0, (u[:, 1] - marg_lo) / marg_p, 0.5)
    rows = torch.arange(row.shape[0], device=row.device)
    cond_lo = torch.where(col > 0, row_cdf[rows, torch.clamp(col - 1, min=0)],
                          0.0)
    cond_p = row_cdf[rows, col] - cond_lo
    du = torch.where(cond_p > 0, (u[:, 0] - cond_lo) / cond_p, 0.5)
    return row, col, torch.stack([du, dv], dim=-1)


def sample_alias(table, u0, u1):
    """One O(1) draw per lane from an (M, 2) alias table. Returns
    (idx, du, dv): idx is distributed proportionally to the build
    weights; du, dv are fresh U[0,1) uniforms recovered from the consumed
    ones, so callers need no extra random numbers."""
    M = table.shape[0]
    f = u0 * M
    j = torch.clamp(f.to(torch.int32), 0, M - 1).long()
    du = torch.clamp(f - j.to(f.dtype), 0.0, 1.0)
    row = table[j]
    q = row[:, 0]
    a = row[:, 1].to(torch.int32).long()
    take = u1 < q
    idx = torch.where(take, j, a)
    dv = torch.where(take, u1 / torch.clamp(q, min=1e-12),
                     (u1 - q) / torch.clamp(1.0 - q, min=1e-12))
    return idx, du, torch.clamp(dv, 0.0, 1.0 - 1e-7)
