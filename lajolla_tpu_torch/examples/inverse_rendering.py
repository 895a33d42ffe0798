"""Inverse rendering: recover scene parameters from an image.

Two small recoveries on Cornell boxes built in code
(lajolla_tpu_torch.testing), each from a target render of the true
scene with gradient descent (torch.optim.Adam):
  1. the red wall's diffuse reflectance, by reverse-mode gradients of the
     surface path tracer (integrators/diffpath.render_diff; default 40
     steps at 24x24 x 4 spp, depth 4);
  2. the absorption scale of the foggy 'vol' box's medium (σ_a and σ_s
     scaled together) under volpath version 2, the single-scattering
     estimator (diffpath.render_volpath_diff; default 80 steps at 24x24
     x 16 spp).

Usage:
    python -m lajolla_tpu_torch.examples.inverse_rendering [--device cpu]
        [--res 24] [--steps N]

`--steps` sets both recoveries' step counts. See integrators/diffpath.py
for the estimators (detached sampling, a fixed bounce budget).
"""

import argparse
import dataclasses

import torch

from lajolla_tpu_torch import testing as PT
from lajolla_tpu_torch.integrators.diffpath import (render_diff,
                                                    render_volpath_diff)
from lajolla_tpu_torch.integrators.media import MT_SA
from lajolla_tpu_torch.scene.types import RenderOptions


def red_wall_texture(scene):
    """Texture-table row of the red wall's constant reflectance."""
    tab = scene.tex_tab.cpu()
    red = torch.nonzero(tab[:, 2] > 3.0 * tab[:, 3] + 1e-3)[:, 0]
    if len(red) != 1:
        raise ValueError(f"expected one red texture row, found {len(red)}")
    return int(red[0])


def _fit(render, x0, target, steps, lr, lo, hi, label, every):
    """Adam on the mean squared film error from x0, clamped to [lo, hi]
    after every step. Returns (first loss, last loss, x)."""
    x = x0.clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=lr)
    first = None
    for i in range(steps):
        opt.zero_grad()
        loss = torch.mean((render(x) - target) ** 2)
        loss.backward()
        opt.step()
        with torch.no_grad():
            x.clamp_(lo, hi)
        first = float(loss.detach()) if first is None else first
        if i % every == 0:
            print(f"[{label}] step {i:3d} loss {float(loss.detach()):.3e} "
                  f"x {x.detach().cpu().numpy().round(4)}")
    with torch.no_grad():
        last = float(torch.mean((render(x) - target) ** 2))
    return first, last, x.detach()


def recover_albedo(device, res=24, steps=40, spp=4, depth=4):
    """Recover the red wall's reflectance from 0.5 grey. Returns (first
    loss, last loss, recovered kd, true kd)."""
    scene = PT.make_cornell_box(res).to(device)
    opts = RenderOptions(max_depth=depth)
    tid = red_wall_texture(scene)
    kd_true = scene.tex_tab[tid, 2:5].clone()
    print(f"[albedo] true red-wall kd = {kd_true.cpu().numpy()}")

    def render(kd):
        tab = scene.tex_tab.clone()
        tab[tid, 2:5] = kd
        return render_diff(dataclasses.replace(scene, tex_tab=tab), opts,
                           seed=9, spp=spp, depth=depth)

    with torch.no_grad():
        target = render(kd_true)
    l0, lN, kd = _fit(render, torch.full((3,), 0.5, device=device), target,
                      steps, 0.1, 0.0, 1.0, 'albedo', 10)
    print(f"[albedo] recovered {kd.cpu().numpy().round(4)} (true "
          f"{kd_true.cpu().numpy().round(4)}); loss {l0:.3e} -> {lN:.3e}")
    return l0, lN, kd, kd_true


def recover_sigma(device, res=24, steps=80, spp=16):
    """Recover the 'vol' box's absorption scale (true 1) from 0.4 under
    version 2. Returns (first loss, last loss, recovered scale)."""
    scene = PT.make_cornell_box(res, variant='vol').to(device)
    opts = RenderOptions(integrator='volpath', vol_path_version=2)

    def render(s):
        med = scene.med_tab.clone()
        med[:, MT_SA:MT_SA + 6] = scene.med_tab[:, MT_SA:MT_SA + 6] * s
        return render_volpath_diff(dataclasses.replace(scene, med_tab=med),
                                   opts, seed=5, spp=spp)

    with torch.no_grad():
        target = render(torch.tensor(1.0, device=device))
    l0, lN, s = _fit(render, torch.tensor(0.4, device=device), target,
                     steps, 0.05, 0.05, 3.0, 'sigma', 20)
    print(f"[sigma] recovered absorption scale {float(s):.4f} (true 1.0); "
          f"loss {l0:.3e} -> {lN:.3e}")
    return l0, lN, s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    ap.add_argument("--res", type=int, default=24,
                    help="film width and height (default: 24)")
    ap.add_argument("--steps", type=int, default=None,
                    help="optimizer steps of each recovery (default: 40 "
                         "for the albedo, 80 for sigma)")
    args = ap.parse_args(argv)
    recover_albedo(args.device, args.res, args.steps or 40)
    recover_sigma(args.device, args.res, args.steps or 80)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
