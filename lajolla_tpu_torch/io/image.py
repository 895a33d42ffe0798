"""Image read/write dispatch (host-side).

Mirrors the reference's imread1/imread3/imwrite surface
(src/image.h/.cpp): LDR formats (JPG/PNG/TGA/BMP/GIF) decode via Pillow
and are converted to linear with the same gamma-2.2 power curve
stb_image's stbi_loadf applies; .hdr (Radiance RGBE) has a native decoder;
.exr goes through our EXR codec; .pfm through the PFM codec. `imwrite`
emits .pfm (float32) or .exr (fp16 ZIP), like src/image.cpp:135-173.
"""

import os

import numpy as np

from lajolla_tpu_torch.io.exr import read_exr, write_exr
from lajolla_tpu_torch.io.pfm import read_pfm, write_pfm

_LDR_EXTS = {'.jpg', '.jpeg', '.png', '.tga', '.bmp', '.psd', '.gif'}


def _read_hdr(path):
    """Radiance RGBE (.hdr/.pic) decoder."""
    with open(path, 'rb') as f:
        data = f.read()
    if not (data.startswith(b'#?RADIANCE') or data.startswith(b'#?RGBE')):
        raise ValueError(f"not a Radiance HDR file: {path}")
    pos = data.index(b'\n\n') + 2
    eol = data.index(b'\n', pos)
    dims = data[pos:eol].split()
    if dims[0] != b'-Y' or dims[2] != b'+X':
        raise ValueError("unsupported HDR orientation")
    h, w = int(dims[1]), int(dims[3])
    pos = eol + 1
    rgbe = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if w < 8 or w > 0x7FFF or data[pos] != 2 or data[pos + 1] != 2:
            # flat (uncompressed) scanlines
            row = np.frombuffer(data[pos:pos + w * 4], np.uint8)
            rgbe[y] = row.reshape(w, 4)
            pos += w * 4
            continue
        pos += 4  # scanline header
        for c in range(4):
            x = 0
            while x < w:
                count = data[pos]
                pos += 1
                if count > 128:  # run
                    rgbe[y, x:x + count - 128, c] = data[pos]
                    pos += 1
                    x += count - 128
                else:  # literal
                    rgbe[y, x:x + count, c] = np.frombuffer(
                        data[pos:pos + count], np.uint8)
                    pos += count
                    x += count
    exp = rgbe[:, :, 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return rgbe[:, :, :3].astype(np.float32) * scale[:, :, None]


def imread3(path):
    """Read an image as (H, W, 3) linear float32."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext in _LDR_EXTS:
        from PIL import Image
        im = Image.open(path).convert('RGB')
        arr = np.asarray(im, np.float32) / 255.0
        # stb_image's LDR→HDR conversion: pow(x, 2.2) (not the sRGB curve)
        return arr ** 2.2
    if ext in ('.hdr', '.pic'):
        return _read_hdr(path)
    if ext == '.exr':
        img, _ = read_exr(path)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return img[:, :, :3].astype(np.float32)
    if ext == '.pfm':
        img = read_pfm(path)
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        return img
    raise ValueError(f"unsupported image format: {path}")


def imread1(path):
    """Read an image as (H, W) float32 (mean of RGB for EXR, first/gray
    channel for LDR — matching src/image.cpp:28-79)."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext in _LDR_EXTS:
        from PIL import Image
        im = Image.open(path).convert('L')
        arr = np.asarray(im, np.float32) / 255.0
        return arr ** 2.2
    img = imread3(path)
    return img.mean(axis=-1)


def imwrite(path, img):
    img = np.asarray(img, np.float32)
    p = str(path)
    if p.endswith('.pfm'):
        write_pfm(p, img)
    elif p.endswith('.exr'):
        write_exr(p, img)
    else:
        raise ValueError(f"unsupported output format: {path} (use .pfm/.exr)")
