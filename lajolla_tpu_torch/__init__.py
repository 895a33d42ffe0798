"""lajolla_tpu_torch — lajolla_tpu ported to PyTorch and CUDA.

The same renderer as lajolla_tpu (same scenes, same counter-hash random
numbers, same films), with the plain tensor code in PyTorch and the TPU
kernels rewritten as hand-written CUDA kernels for Hopper (csrc/). The
JAX package stays beside it as the reference the port is tested against.

Public entry points:
    parse_scene(path, device)          -> (Scene, RenderOptions)
    render(scene, options, device=...) -> film (H, W, 3) float32 numpy
    imwrite(path, img)                 -> .pfm / .exr output

There is no global default device: every entry point names its device.
"""

from lajolla_tpu_torch import dtypes  # noqa: F401  (fp32 policy: TF32 off)
# Bound here, not lazily: importing the submodule `render` later would
# otherwise rebind the package attribute `render` to the module.
from lajolla_tpu_torch.render import render

__version__ = "0.1.0"


def parse_scene(path, device):
    from lajolla_tpu_torch.scene.parser import parse_scene as _p
    from lajolla_tpu_torch.utils import profiling
    scene, options = _p(path)
    with profiling.span('scene.upload'):
        return scene.to(device), options


def imwrite(path, img):
    from lajolla_tpu_torch.io.image import imwrite as _w
    return _w(path, img)
