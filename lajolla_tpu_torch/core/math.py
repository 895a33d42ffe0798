"""Vector math over trailing-axis-3 tensors.

Port of lajolla_tpu/core/math.py: the reference's TVector3/Frame classes
(src/vector.h, src/frame.h) as free functions over `(..., 3)` tensors,
frames as `(..., 3, 3)` with rows (tangent, bitangent, normal). Every
3-wide contraction is written out as products added left to right, the
order lajolla_tpu's elementwise sums take, so no reduction kernel of
either device reassociates it.
"""

import torch


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + \
        a[..., 2] * b[..., 2]


def dotk(a, b):
    """dot with keepdims — convenient for throughput-style broadcasting."""
    return dot(a, b)[..., None]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def length_squared(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length_squared(v))


def normalize(v, eps=0.0):
    l2 = length_squared(v)[..., None]
    return v * torch.rsqrt(torch.clamp(l2, min=eps * eps + 1e-38))


def normalize3(x, y, z):
    """normalize over components given apart (rows of the kernels' plain
    forms), in the CUDA kernels' order: one rsqrt, squares clamped at
    1e-30."""
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-30))
    return x * inv, y * inv, z * inv


class _SafeSqrt(torch.autograd.Function):
    """sqrt(max(x, 0)) whose derivative, in reverse and in forward mode,
    is 0.5 / sqrt(max(x, 1e-12))."""

    @staticmethod
    def forward(x):
        return torch.sqrt(torch.clamp(x, min=0.0))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def _slope(x, t):
        return t * 0.5 / torch.sqrt(torch.clamp(x, min=1e-12))

    @staticmethod
    def backward(ctx, g):
        return _SafeSqrt._slope(ctx.saved_tensors[0], g)

    @staticmethod
    def jvp(ctx, t):
        return _SafeSqrt._slope(ctx.saved_tensors[0], t)


def safe_sqrt(x):
    """sqrt(max(x, 0)) with a CLAMPED derivative 1/(2 sqrt(max(x,
    1e-12))), as lajolla_tpu's custom_jvp gives it. The value is
    torch.sqrt(torch.clamp(x, min=0)) bit for bit. At clip-to-zero sites
    (the VNDF disk rim, Fresnel and refraction cosines) the true
    derivative is inf, and reverse mode turns the zero gradient of a
    masked lane into 0·inf = NaN, which the film gradient's sum then
    spreads to every parameter (integrators/diffpath.py)."""
    return _SafeSqrt.apply(x)


def distance(a, b):
    return length(a - b)


def distance_squared(a, b):
    return length_squared(a - b)


# ---------------------------------------------------------------------------
# Orthonormal frames (reference: src/frame.h)
# ---------------------------------------------------------------------------

def coordinate_system(n):
    """Branch-free Frisvad/Duff ONB from a unit normal. Returns (t, b),
    each shaped like n."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + z)
    b = x * y * a
    t = torch.stack([1.0 + sign * x * x * a, sign * b, -sign * x], -1)
    bt = torch.stack([b, sign + y * y * a, -y], -1)
    return t, bt


def make_frame(n):
    """Frame as a (..., 3, 3) tensor with rows (t, b, n)."""
    t, b = coordinate_system(n)
    return torch.stack([t, b, n], dim=-2)


def to_local(frame, v):
    """World → frame-local. frame: (..., 3, 3) rows (t,b,n); v: (..., 3)."""
    return frame[..., :, 0] * v[..., None, 0] + \
        frame[..., :, 1] * v[..., None, 1] + frame[..., :, 2] * v[..., None, 2]


def to_world(frame, v):
    """Frame-local → world."""
    return frame[..., 0, :] * v[..., 0, None] + \
        frame[..., 1, :] * v[..., 1, None] + frame[..., 2, :] * v[..., 2, None]


# ---------------------------------------------------------------------------
# Reflection / refraction
# ---------------------------------------------------------------------------

def reflect(w, n):
    """Mirror w about n (both pointing away from surface)."""
    return 2.0 * dotk(w, n) * n - w


def refract(w, n, eta):
    """Refract w about n with relative IOR eta = n_inside / n_outside
    (a tensor of w's batch shape). Returns (wt, valid); valid is False on
    total internal reflection."""
    cos_i = dot(w, n)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = sin2_i / (eta * eta)
    valid = sin2_t < 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    wt = -w / eta[..., None] + (cos_i / eta - cos_t)[..., None] * n
    return wt, valid


def luminance(rgb):
    """Rec. 709 luminance (reference: src/spectrum.h:32)."""
    return (rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 +
            rgb[..., 2] * 0.072169)
