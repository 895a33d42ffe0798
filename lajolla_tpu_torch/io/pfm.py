"""PFM (portable float map) read/write.

Matches the reference's writer byte layout (src/image.cpp:135-151): header
"PF\n{w} {h}\n-1\n" followed by row-major float32 RGB rows, written
top-to-bottom with a negative scale (little-endian). Note the reference
writes rows in image order (top row first) rather than the bottom-up PFM
convention; we mirror that so outputs are byte-comparable.
"""

import numpy as np


def write_pfm(path, img):
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    h, w, c = img.shape
    assert c == 3
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1\n")
        f.write(img.astype("<f4").tobytes())


def read_pfm(path):
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        count = w * h * (3 if magic == b"PF" else 1)
        dt = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(count * 4), dtype=dt).astype(np.float32)
    if magic == b"PF":
        img = data.reshape(h, w, 3)
    else:
        img = data.reshape(h, w)
    return img
