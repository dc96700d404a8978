"""Runtime-checkable typing/API layer (replaces the mypy-gated test that
could never run in this image).

Two enforced properties:

1. every type annotation in the package RESOLVES — ``typing.get_type_hints``
   evaluates all stringified annotations, which is the first thing a static
   checker would do and catches renamed/removed types at runtime;
2. the public API surface matches the reference contract
   (``/root/reference/gf2bv/__init__.py:146-408`` + ``crypto/*``): names,
   required parameters, and the documented defaults (``max_dimension=16``,
   ``mode`` in {0, 1}).
"""

import importlib
import inspect
import pkgutil
import typing

import pytest

import gf2bv_tpu
from gf2bv_tpu import (
    AffineSpace,
    BitVec,
    DimensionTooLargeError,
    LinearSystem,
    QuadraticSystem,
)


def _package_modules():
    mods = []
    for info in pkgutil.walk_packages(
        gf2bv_tpu.__path__, prefix="gf2bv_tpu."
    ):
        if "._native" in info.name:
            continue  # ctypes shim; compiles C on import
        mods.append(importlib.import_module(info.name))
    return mods


@pytest.mark.parametrize("mod", _package_modules(), ids=lambda m: m.__name__)
def test_annotations_resolve(mod):
    """All function/method annotations in the package must evaluate."""
    ns = dict(vars(mod))
    for name, obj in list(ns.items()):
        if inspect.isfunction(obj) and obj.__module__ == mod.__name__:
            typing.get_type_hints(obj, globalns=ns)
        elif inspect.isclass(obj) and obj.__module__ == mod.__name__:
            typing.get_type_hints(obj, globalns=ns)
            for _, meth in inspect.getmembers(obj, inspect.isfunction):
                if meth.__module__ == mod.__name__:
                    typing.get_type_hints(meth, globalns=ns)


REFERENCE_SURFACE = {
    # class -> methods that the reference exposes by this exact name
    LinearSystem: [
        "gens", "get_eqs", "solve_one", "solve_all", "solve_raw_one",
        "solve_raw_space", "convert_sol", "evaluate", "get_sage_mat",
        "get_sage_mat_slow",
    ],
    QuadraticSystem: ["mul_bit", "bit_assert", "convert_sol", "solve_one"],
    BitVec: [
        "__xor__", "__rshift__", "__lshift__", "__and__", "__or__",
        "__mod__", "lshift_ext", "rotr", "rotl", "sum", "zeroext",
        "signext", "broadcast", "dup", "concat", "evaluate",
    ],
    AffineSpace: ["get", "__iter__"],
}


def test_reference_api_surface_present():
    for cls, methods in REFERENCE_SURFACE.items():
        for m in methods:
            assert callable(getattr(cls, m, None)), f"{cls.__name__}.{m}"
    for prop in ("dimension", "origin", "basis"):
        assert isinstance(getattr(AffineSpace, prop), property), prop


def test_reference_defaults_and_modes():
    sig = inspect.signature(LinearSystem.solve_all)
    assert sig.parameters["max_dimension"].default == 16
    sig = inspect.signature(QuadraticSystem.solve_one_batch)
    assert sig.parameters["max_dimension"].default == 16
    # m4ri_solve compat shim: positional (equations, cols, mode)
    sig = inspect.signature(gf2bv_tpu.m4ri_solve)
    assert list(sig.parameters)[1:3] == ["cols", "mode"]
    assert issubclass(DimensionTooLargeError, Exception)
    # DimensionTooLargeError must carry .space (reference contract used by
    # examples/nlfsr_ex.py:69-93)
    err = DimensionTooLargeError("x", space=None)
    assert hasattr(err, "space")


def test_crypto_model_surface():
    from gf2bv_tpu.crypto.lfsr import FibonacciLFSR, GaloisLFSR
    from gf2bv_tpu.crypto.mt import MT19937, MersenneTwister
    from gf2bv_tpu.crypto.xoshiro import Xoshiro256starstar

    assert callable(MersenneTwister.getrandbits)
    assert callable(MT19937([0] * 624).to_python_random)
    assert callable(GaloisLFSR(8, 0b10111, 1))
    assert callable(FibonacciLFSR(8, 0b10111, 1))
    assert callable(Xoshiro256starstar([1, 2, 3, 4]).untemper)
