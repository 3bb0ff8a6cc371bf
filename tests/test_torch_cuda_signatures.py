"""Port: the ctypes bindings of ops/_cuda.py against the C entry points of
owlvit_tpu_torch/csrc/*.cu. A binding whose parameters do not match its
prototype passes a pointer as a 32-bit int, or a float as an int, and fails
only on the card; here it fails on the CPU."""

import ctypes
import re

import pytest

from owlvit_tpu_torch.ops import _cuda

# extern "C" <return type> <name>(<parameters>)
_PROTO = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)', re.S)
_KIND = {"int": ctypes.c_int, "float": ctypes.c_float}


def _prototypes():
    """name -> (return type, [parameter declarations]) over csrc/*.cu."""
    out = {}
    for src in sorted(_cuda.CSRC.glob("*.cu")):
        for ret, name, params in _PROTO.findall(src.read_text()):
            out[name] = (ret, [p.strip() for p in params.split(",") if p.strip()])
    return out


PROTOTYPES = _prototypes()


def _kind(decl: str):
    """The ctypes type a parameter declaration needs: a pointer (the stream
    included) is c_void_p, else its base type's."""
    if "*" in decl:
        return ctypes.c_void_p
    return _KIND[decl.replace("const ", "").split()[0]]


def test_every_entry_point_is_bound():
    assert PROTOTYPES, f"no extern \"C\" prototype found under {_cuda.CSRC}"
    assert set(PROTOTYPES) == set(_cuda._SIGNATURES)


@pytest.mark.parametrize("name", sorted(set(PROTOTYPES) | set(_cuda._SIGNATURES)))
def test_binding_matches_prototype(name):
    assert name in PROTOTYPES, f"{name} is bound but has no prototype in csrc/"
    assert name in _cuda._SIGNATURES, f"{name} has a prototype but no binding"
    ret, params = PROTOTYPES[name]
    argtypes = _cuda._SIGNATURES[name]
    assert ret == "int", f"{name} returns {ret}; library() sets restype c_int"
    assert len(argtypes) == len(params), (name, params, argtypes)
    for i, (decl, got) in enumerate(zip(params, argtypes)):
        assert got is _kind(decl), f"{name} parameter {i} `{decl}` bound as {got}"


@pytest.mark.parametrize("name,params", [
    # cost row_mask col4row | B R C | stream
    ("owlvit_jv_assign", 7),
    # boxes classes_in classes_out | B P background | threshold stream
    ("owlvit_propagate_labels", 8)])
def test_matcher_entry_points_are_bound(name, params):
    """The matcher's two kernels (csrc/matcher.cu): a prototype and a
    binding each, with the stream last."""
    assert name in PROTOTYPES and name in _cuda._SIGNATURES
    assert len(_cuda._SIGNATURES[name]) == params
    assert _cuda._SIGNATURES[name][-1] is ctypes.c_void_p
    assert "stream" in PROTOTYPES[name][1][-1]
