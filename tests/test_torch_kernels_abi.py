"""The ctypes table of the port's CUDA library against its C sources, on
the CPU.

``dgl_tpu_torch/_kernels.py`` binds every ``extern "C"`` function of
``dgl_tpu_torch/csrc/*.cu`` with ``ctypes`` and a table of argument types,
``ARGTYPES``. ctypes checks nothing against the compiled function, so a
table that lags behind a changed signature passes wrong values without an
error where the types happen to share a size. This test reads each
signature from the sources and holds the table to it, parameter by
parameter: a pointer is ``c_void_p``, ``int64_t`` is ``c_int64``, ``int``
is ``c_int`` and ``float`` is ``c_float``.
"""
import ctypes
import os
import re

import pytest

from dgl_tpu_torch import _kernels

_C_TYPES = {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
            "float": ctypes.c_float}


def _signatures():
    """Each ``extern "C"`` function of the library's sources: its name, its
    parameters' ctypes types, the source file."""
    out = {}
    for path in _kernels.SOURCES:
        text = open(path).read()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            types = []
            for param in m.group(2).split(","):
                decl = " ".join(param.split())
                if "*" in decl:
                    types.append(ctypes.c_void_p)
                else:
                    types.append(_C_TYPES[decl.rsplit(" ", 1)[0]])
            out[m.group(1)] = (types, os.path.basename(path))
    return out


def test_every_c_function_is_bound():
    """The table names exactly the sources' ``extern "C"`` functions."""
    assert sorted(_signatures()) == sorted(_kernels.ARGTYPES)


@pytest.mark.parametrize("name", sorted(_kernels.ARGTYPES))
def test_argtypes_match_the_source(name):
    types, source = _signatures()[name]
    assert _kernels.ARGTYPES[name] == types, (
        f"{name} ({source}): the table's argument types differ from the "
        "C signature")
