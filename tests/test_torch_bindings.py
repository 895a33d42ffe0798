"""The ctypes signatures that kernels._bind gives the C entries of
csrc/*.cu, held against the entries' own parameter lists: a parameter
added or dropped on one side only would reach the card as a shifted
argument, which no CPU test runs. No card is needed: the libraries are
stand-ins that only record what _bind sets."""

import ctypes
import re
import types

import pytest

from lajolla_tpu_torch import kernels

from torch_threads import one_thread  # noqa: F401

_ENTRY = re.compile(r'^int\s+(lj_\w+)\s*\(([^)]*)\)\s*\{', re.MULTILINE)

# A C parameter's type, as ctypes declares it.
_SCALARS = {'int': ctypes.c_int, 'uint32_t': ctypes.c_uint32,
            'long long': ctypes.c_longlong}
_RECORDS = {'lj::Tables': kernels._Tables, 'lj::Camera': kernels._Camera,
            'lj::Medium': kernels._Medium, 'lj::VolSalts': kernels._VolSalts,
            'lj::GridMedium': kernels._GridMedium}


def _entries():
    """{entry: (unit, [C parameter types])} of every `int lj_*(...)`
    definition in the units' .cu files."""
    out = {}
    for unit in kernels._UNITS:
        src = (kernels._CSRC / f'{unit}.cu').read_text()
        for name, params in _ENTRY.findall(src):
            out[name] = (unit, [' '.join(p.split()[:-1])
                                for p in params.split(',')])
    return out


def _ctype(c_type):
    if c_type.endswith('*'):
        record = c_type.removeprefix('const ').removesuffix('*')
        return (ctypes.POINTER(_RECORDS[record]) if record in _RECORDS
                else ctypes.c_void_p)
    return _SCALARS[c_type]


def _bound():
    """{unit: {entry: (argtypes, restype)}} as _bind sets them."""
    libs = {u: types.SimpleNamespace() for u in kernels._UNITS}
    for unit, lib in libs.items():
        for name in _entries():
            setattr(lib, name, types.SimpleNamespace(argtypes=None,
                                                     restype=None))
    kernels._bind(libs)
    return {u: {k: (v.argtypes, v.restype) for k, v in vars(lib).items()
                if v.argtypes is not None}
            for u, lib in libs.items()}


ENTRIES = _entries()


def test_every_entry_is_bound():
    bound = _bound()
    assert {name for lib in bound.values() for name in lib} == set(ENTRIES)
    assert len(ENTRIES) == 12


@pytest.mark.parametrize('name', sorted(ENTRIES))
def test_argtypes_match_the_c_entry(name):
    unit, params = ENTRIES[name]
    argtypes, restype = _bound()[unit][name]
    assert restype is ctypes.c_int
    assert list(argtypes) == [_ctype(p) for p in params]
