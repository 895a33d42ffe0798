"""Mitsuba binary `.vol` grid loader (host-side).

Format (replicating src/volume.cpp:6-105): 'VOL' magic, u8 version(3),
i32 type(1 = float32), i32 xres/yres/zres, i32 channels (1 or 3),
f32 bbox (xmin ymin zmin xmax ymax zmax), then xres*yres*zres*channels
float32 values, x fastest.
"""

import numpy as np


def load_vol(path, target_channels=3):
    with open(path, 'rb') as f:
        data = f.read()
    if data[:3] != b'VOL':
        raise ValueError(f"not a .vol file: {path}")
    if data[3] != 3:
        raise ValueError(f"unsupported .vol version {data[3]}")
    typ = int(np.frombuffer(data[4:8], '<i4')[0])
    if typ != 1:
        raise ValueError(f"unsupported .vol data type {typ} (float32 only)")
    xres, yres, zres, channels = np.frombuffer(data[8:24], '<i4')
    if channels not in (1, 3):
        raise ValueError(f".vol must have 1 or 3 channels, got {channels}")
    bbox = np.frombuffer(data[24:48], '<f4').astype(np.float64)
    n = int(xres) * int(yres) * int(zres)
    raw = np.frombuffer(data[48:48 + 4 * n * int(channels)], '<f4')
    grid = raw.reshape(int(zres), int(yres), int(xres), int(channels))
    if target_channels == 1:
        # first channel only, matching load_volume<Real> (volume.cpp:66-79)
        grid = grid[..., :1]
    elif target_channels == 3 and channels == 1:
        grid = np.repeat(grid, 3, axis=-1)
    return dict(data=grid.astype(np.float32),
                pmin=bbox[:3], pmax=bbox[3:],
                res=(int(xres), int(yres), int(zres)))
