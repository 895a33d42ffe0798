"""Global numeric policy.

The reference renderer computes in fp64 throughout (src/lajolla.h:23).
The port, like lajolla_tpu, computes in fp32 with numerically-stable
primitives (stable quadratics, offset-from-surface epsilons scaled by
scene extent).

fp32 means full fp32: TF32 is switched off for matrix products and
convolutions. lajolla_tpu learned that reduced-precision products bias
glass chains by +4% (docs/VALIDATION.md:54-74). The render path does no
matrix product today; the flags keep any later one honest.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Matches the reference epsilon policy (src/scene.h:99-105): epsilons are
# proportional to the scene bounding-sphere radius, capped at 0.01.
# fp32 needs a larger relative floor than the reference's fp64 1e-5.
INTERSECT_EPS_SCALE = 1e-4
SHADOW_EPS_SCALE = 1e-4
EPS_CAP = 0.01


def intersection_eps(scene_radius: float) -> float:
    return float(min(INTERSECT_EPS_SCALE * scene_radius, EPS_CAP))


def shadow_eps(scene_radius: float) -> float:
    return float(min(SHADOW_EPS_SCALE * scene_radius, EPS_CAP))
