"""Small image utilities: RMSE comparison (the homework-style gate) and
EXR/PFM → PNG tonemapping. Port of lajolla_tpu/tools.py.

    python -m lajolla_tpu_torch.tools rmse a.exr b.exr
    python -m lajolla_tpu_torch.tools topng in.exr out.png [--exposure 1.0]
"""

import argparse
import sys

import numpy as np

from lajolla_tpu_torch.io.image import imread3


def rmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def rel_rmse(a, b):
    """RMSE relative to the reference's RMS magnitude (the '<1% RMSE'
    formulation of the course gate)."""
    b = np.asarray(b, np.float64)
    denom = np.sqrt(np.mean(b ** 2))
    return rmse(a, b) / max(denom, 1e-12)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lajolla_tpu_torch.tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("rmse")
    pr.add_argument("a")
    pr.add_argument("b")
    pt = sub.add_parser("topng")
    pt.add_argument("inp")
    pt.add_argument("out")
    pt.add_argument("--exposure", type=float, default=1.0)
    args = ap.parse_args(argv)

    if args.cmd == "rmse":
        a = imread3(args.a)
        b = imread3(args.b)
        if a.shape != b.shape:
            print(f"shape mismatch: {a.shape} vs {b.shape}")
            return 2
        print(f"rmse={rmse(a, b):.6f} rel_rmse={100 * rel_rmse(a, b):.3f}%")
        return 0
    from PIL import Image
    img = imread3(args.inp) * args.exposure
    ldr = (np.clip(img, 0, 1) ** (1 / 2.2) * 255).astype(np.uint8)
    Image.fromarray(ldr).save(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
