"""Compare the SASS of two trees' CUDA kernels, instantiation by
instantiation, on a machine with the CUDA toolkit.

usage, from the repository root, after `kernels.build()` has run in both
trees: python3 tools/compare_sass.py OLD_TREE NEW_TREE
    [--units path_kernels volpath_kernels volpath_grid_kernels]
    [--kernels render_fused_kernel ...]

For each unit it disassembles the library that each tree's sources key
(build/lajolla_tpu_torch/liblj_<unit>_<tag>.so, the tag from that tree's
own `kernels.unit_tag`) with `cuobjdump -sass`, strips addresses and
encodings, and prints for each kernel how many of its instantiations are
instruction for instruction the same in both trees (an instantiation is
its mangled name from the kernel's own name on: the prefix before it
holds a hash that nvcc derives from the file's path):
"SASS <kernel>: k of m instantiations identical (N instructions; names
matched m)", for every kernel or those --kernels names. Exits 1 if one
of them differs or is missing in the new tree.
Imports no JAX.
"""

import argparse
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

UNITS = ('path_kernels', 'volpath_kernels', 'volpath_grid_kernels')
_ADDR = re.compile(r'/\*[0-9a-f]{4,}\*/')
_ENC = re.compile(r'/\* 0x[0-9a-f]+ \*/')


def library(tree, unit):
    """The path of `unit`'s library for the sources of `tree`."""
    code = ("from lajolla_tpu_torch import kernels as k; "
            f"print(k.BUILD_DIR / f'liblj_{unit}_{{k.unit_tag('{unit}')}}.so')")
    return subprocess.run([sys.executable, '-c', code], cwd=tree,
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout.strip()


def functions(so):
    """{(kernel, instantiation): [instructions]} of a library's SASS; the
    instantiation is the mangled name from the kernel's own name on."""
    from chip_smoke import kernel_name
    cuobjdump = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                             'bin', 'cuobjdump')
    text = subprocess.run([cuobjdump, '-sass', so], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    out, key = {}, None
    for line in text.splitlines():
        if 'Function :' in line:
            symbol = line.split('Function :')[1].strip()
            name = kernel_name(symbol)
            at = symbol.find(f"{len(name)}{name}")
            key = (name, symbol[at:] if at >= 0 else symbol)
            out[key] = []
        elif key is not None:
            ins = _ENC.sub('', _ADDR.sub('', line)).strip(' ;')
            if ins and not ins.startswith('.'):
                out[key].append(ins)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('old')
    ap.add_argument('new')
    ap.add_argument('--units', nargs='+', default=list(UNITS))
    ap.add_argument('--kernels', nargs='+')
    args = ap.parse_args()
    ok = True
    for unit in args.units:
        old = functions(library(args.old, unit))
        new = functions(library(args.new, unit))
        names = sorted({k for k, _ in old
                        if not args.kernels or k in args.kernels})
        for name in names:
            keys = [key for key in old if key[0] == name]
            same = sum(new.get(key) == old[key] for key in keys)
            print(f"SASS {name}: {same} of {len(keys)} instantiations "
                  f"identical ({sum(len(old[k]) for k in keys)} "
                  f"instructions; names matched "
                  f"{sum(key in new for key in keys)})")
            ok = ok and same == len(keys)
            lost = [key[1] for key in keys if key not in new]
            if lost:
                print(f"  not in the new tree, e.g. {lost[0]}; its own: "
                      f"{[k[1] for k in new if k[0] == name][:1]}")
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()
