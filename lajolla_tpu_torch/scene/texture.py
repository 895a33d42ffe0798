"""Host-side texture pool and mipmap construction.

Replaces the reference's TexturePool + Mipmap (texture.h:13-63,
mipmap.h:25-48): images load once per name, each gets a 2x2-box-filter
pyramid capped at 8 levels. At compile time all (image, level) planes are
flattened into ONE device array with an offset/size table, so device-side
lookups are two gathers per bilinear tap regardless of texture count.

Scalar (1-channel) textures are stored as replicated 3-channel rows; the
evaluator reads channel 0.
"""

import numpy as np

from lajolla_tpu_torch.scene.types import MAX_MIP_LEVELS


def make_mipmap(img):
    """Build the pyramid exactly like make_mipmap (mipmap.h:25-48):
    num_levels = min(ceil(log2(max(w,h))) + 1, 8), 2x2 box, floor-halved
    dims clamped to >= 1; odd trailing rows/cols are dropped by indexing
    (prev[2x], prev[2x+1]) like the reference does."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    levels = [img]
    size = max(img.shape[0], img.shape[1])
    num_levels = min(int(np.ceil(np.log2(max(size, 1)) + 1)), MAX_MIP_LEVELS)
    for _ in range(1, num_levels):
        prev = levels[-1]
        h, w = prev.shape[:2]
        nw, nh = max(w // 2, 1), max(h // 2, 1)
        # Index pairs (2x, 2x+1) clamped to the source size, as the
        # reference implicitly requires even dims (its scenes use pow2
        # textures); clamping keeps odd sizes safe.
        x0 = np.minimum(2 * np.arange(nw), w - 1)
        x1 = np.minimum(2 * np.arange(nw) + 1, w - 1)
        y0 = np.minimum(2 * np.arange(nh), h - 1)
        y1 = np.minimum(2 * np.arange(nh) + 1, h - 1)
        nxt = (prev[np.ix_(y0, x0)] + prev[np.ix_(y0, x1)] +
               prev[np.ix_(y1, x0)] + prev[np.ix_(y1, x1)]) * 0.25
        levels.append(nxt.astype(np.float32))
    return levels


class TexturePool:
    """name → image id; stores mip pyramids host-side until packing."""

    def __init__(self):
        self.ids = {}
        self.pyramids = []   # list of list-of-(h,w,3) float32

    def insert(self, name, img):
        if name in self.ids:
            return self.ids[name]
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        tid = len(self.pyramids)
        self.ids[name] = tid
        self.pyramids.append(make_mipmap(img))
        return tid

    def image_size(self, tid):
        base = self.pyramids[tid][0]
        return base.shape[1], base.shape[0]  # (w, h)

    def pack(self):
        """Flatten all pyramids → (texdata, mip_offset, mip_w, mip_h,
        mip_levels) numpy arrays. Levels past num_levels repeat the last
        level so clamped lookups stay in-bounds."""
        ni = max(len(self.pyramids), 1)
        mip_offset = np.zeros((ni, MAX_MIP_LEVELS), np.int32)
        mip_w = np.ones((ni, MAX_MIP_LEVELS), np.int32)
        mip_h = np.ones((ni, MAX_MIP_LEVELS), np.int32)
        mip_levels = np.ones(ni, np.int32)
        chunks = []
        offset = 0
        for i, pyr in enumerate(self.pyramids):
            mip_levels[i] = len(pyr)
            last_off = 0
            for l in range(MAX_MIP_LEVELS):
                if l < len(pyr):
                    img = pyr[l]
                    h, w = img.shape[:2]
                    # quad-packed rows: texel (y, x) carries its 2x2
                    # bilinear footprint [t00 t10 t01 t11] (wrap
                    # addressing, mipmap.h:52-66 semantics) so one
                    # bilinear tap is ONE wide gather instead of 4
                    xi = (np.arange(w) + 1) % w
                    yi = (np.arange(h) + 1) % h
                    quad = np.concatenate(
                        [img, img[:, xi], img[yi, :], img[yi][:, xi]],
                        axis=-1)
                    chunks.append(quad.reshape(-1, 12))
                    mip_offset[i, l] = offset
                    mip_w[i, l] = w
                    mip_h[i, l] = h
                    last_off = offset
                    offset += h * w
                else:
                    mip_offset[i, l] = last_off
                    mip_w[i, l] = mip_w[i, l - 1]
                    mip_h[i, l] = mip_h[i, l - 1]
        if not chunks:
            chunks = [np.zeros((1, 12), np.float32)]
        texdata = np.concatenate(chunks, axis=0).astype(np.float32)
        return texdata, mip_offset, mip_w, mip_h, mip_levels
