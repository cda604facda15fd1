"""The ctypes argument lists of kernels.py against the C entry points of
csrc/*.cu: a call through a list that differs from the C function's
parameters is undefined behaviour that no compiler reports, so every entry
point must be bound, with its parameters' count, order and types."""

import ctypes
import os
import re

import pytest

from hobbyrenderer_tpu_torch import kernels

_CTYPE = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


def _entry_points():
    """{name: (ctypes, ...)} of every `int hr_*(...)` defined in the sources."""
    found = {}
    for src in kernels.SOURCES:
        with open(os.path.join(kernels.CSRC, src)) as f:
            text = f.read()
        for name, params in re.findall(r"^\s*(?:extern \"C\" )?int (hr_\w+)\(([^)]*)\)\s*\{",
                                       text, re.M):
            types = []
            for p in params.split(","):
                p = re.sub(r"\bconst\b", "", p).strip()
                ctype = re.sub(r"\s+\w+$", "", p).replace(" ", "")
                types.append(_CTYPE[ctype])
            found[name] = tuple(types)
    return found


def test_every_entry_point_is_bound():
    assert set(_entry_points()) == set(kernels._SIGNATURES)


@pytest.mark.parametrize("name", sorted(kernels._SIGNATURES))
def test_signature_matches_the_c_parameters(name):
    assert kernels._SIGNATURES[name] == _entry_points()[name]
