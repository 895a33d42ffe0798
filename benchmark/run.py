"""Run one cell of the benchmark of lajolla_tpu_torch once, and print its
result as the last line of standard output.

    python3 benchmark/run.py --workload cbox.final-512 --seed 7 \
        --seconds 50 --trace 0

from the root of a checkout on a machine with the cell's NVIDIA GPUs.
--trace 0 prints the cell's end-to-end metrics; --trace 1 traces a few
frames inside the window and prints its per-layer metrics. Either way the
frames the window rendered are held against the reference
(benchmark/check.py), each number compared printed beside its limit as
the last lines of standard error and under "checks" in the result line.
A run that cannot be made (no GPU, fewer GPUs than the cell asks for, a
missing file, a module of JAX or of lajolla_tpu loaded) exits non-zero
and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, 'build')


def _cache_dirs():
    """Kernel caches of the program at fixed paths inside the checkout
    (the program's own nvcc libraries live in build/lajolla_tpu_torch)."""
    os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                          os.path.join(BUILD, 'torch_extensions'))
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(BUILD, 'triton'))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness
    try:
        spec = harness.load_cell(args.workload)
        import torch
        chips = spec['workload']['chips']
        if not torch.cuda.is_available():
            raise harness.BenchError("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < chips:
            raise harness.BenchError(
                f"{torch.cuda.device_count()} GPUs, the cell asks for "
                f"{chips}")
        result, lines = harness.run_single(spec, args.seed, args.seconds,
                                           bool(args.trace), T_START)
        found = harness.forbidden_modules()
        if found:
            raise harness.BenchError(f"modules loaded by the run: {found}")
    except Exception:                      # noqa: BLE001 (no result line)
        traceback.print_exc()
        print("benchmark: no result", file=sys.stderr)
        return 1
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
