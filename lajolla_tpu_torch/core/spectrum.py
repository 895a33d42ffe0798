"""Spectral-data → linear RGB conversion (host-side, parse time).

The renderer operates in linear tristimulus RGB, like the reference
(src/spectrum.h:8). Scene files may specify reflectance/radiance as
sampled spectra ("lambda:value" pairs); those are integrated against the
Wyman et al. (JCGT 2013) multi-lobe Gaussian fits of the CIE 1931
observer — the same analytic fit family the reference uses
(src/spectrum.h:44-66) — over 400..700 nm at 1 nm steps
(src/spectrum.h:68-107), so parsed colors agree numerically.

All functions here are vectorized numpy; they run once at scene-compile
time, never on device.
"""

import numpy as np


def _gauss(wl, mu, s1, s2):
    t = (wl - mu) * np.where(wl < mu, s1, s2)
    return np.exp(-0.5 * t * t)


def x_fit_1931(wl):
    wl = np.asarray(wl, np.float64)
    return (0.362 * _gauss(wl, 442.0, 0.0624, 0.0374)
            + 1.056 * _gauss(wl, 599.8, 0.0264, 0.0323)
            - 0.065 * _gauss(wl, 501.1, 0.0490, 0.0382))


def y_fit_1931(wl):
    wl = np.asarray(wl, np.float64)
    return (0.821 * _gauss(wl, 568.8, 0.0213, 0.0247)
            + 0.286 * _gauss(wl, 530.9, 0.0613, 0.0322))


def z_fit_1931(wl):
    wl = np.asarray(wl, np.float64)
    return (1.217 * _gauss(wl, 437.0, 0.0845, 0.0278)
            + 0.681 * _gauss(wl, 459.0, 0.0385, 0.0725))


CIE_Y_INTEGRAL = 106.856895
WL_BEG, WL_END = 400.0, 700.0


def integrate_xyz(wavelengths, values):
    """Integrate a piecewise-linear spectrum against the CIE fits.

    Semantics match the reference integrator (src/spectrum.h:68-107):
    1 nm steps over [400, 700]; inside the data range the spectrum is
    linearly interpolated; at/below the first sample or at/above the last,
    the nearest endpoint value is held.
    """
    wavelengths = np.asarray(wavelengths, np.float64)
    values = np.asarray(values, np.float64)
    if wavelengths.size == 0:
        return np.zeros(3)
    order = np.argsort(wavelengths, kind="stable")
    wavelengths, values = wavelengths[order], values[order]
    grid = np.arange(WL_BEG, WL_END + 0.5, 1.0)
    if wavelengths.size == 1:
        meas = np.full_like(grid, values[0])
    else:
        meas = np.interp(grid, wavelengths, values)
    coeff = np.stack([x_fit_1931(grid), y_fit_1931(grid), z_fit_1931(grid)], axis=-1)
    xyz = (coeff * meas[:, None]).sum(axis=0)
    return xyz / CIE_Y_INTEGRAL


# Rec.709 / sRGB primaries, linear (src/spectrum.h:110-115)
XYZ_TO_RGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311],
])


def xyz_to_rgb(xyz):
    return XYZ_TO_RGB @ np.asarray(xyz, np.float64)


def srgb_to_linear(srgb):
    """sRGB electro-optical transfer (src/spectrum.h:117-125)."""
    srgb = np.asarray(srgb, np.float64)
    return np.where(srgb <= 0.04045, srgb / 12.92,
                    ((np.abs(srgb) + 0.055) / 1.055) ** 2.4)


def spectrum_string_to_rgb(values_str):
    """Parse a Mitsuba 'lambda:v, lambda:v, ...' (or plain scalar/triplet)
    spectrum string into linear RGB, as the scene parser does
    (reference parse_scene.cpp:169-199)."""
    s = values_str.strip()
    if ":" not in s:
        parts = [float(p) for p in s.replace(",", " ").split()]
        if len(parts) == 1:
            return np.array([parts[0]] * 3, np.float64)
        if len(parts) == 3:
            return np.asarray(parts, np.float64)
        raise ValueError(f"bad spectrum literal: {values_str!r}")
    wls, vals = [], []
    for pair in s.split(","):
        pair = pair.strip()
        if not pair:
            continue
        wl, v = pair.split(":")
        wls.append(float(wl))
        vals.append(float(v))
    return xyz_to_rgb(integrate_xyz(wls, vals))
