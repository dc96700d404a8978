"""gf2bv_tpu — a GF(2) linear-system engine on JAX accelerators.

Write an ordinary Python function (a hash, an LFSR, a Mersenne Twister) and
run it on symbolic bitvectors; every output bit becomes an affine form over
the unknown input bits; asserted-zero bitvectors become a GF(2) system
``Ax = b`` solved by bit-packed Gauss-Jordan on a GPU (JAX/XLA/Pallas), either
for one solution or the full enumerable affine solution space.  A
QuadraticSystem extension handles degree-2 systems by linearization.

Same capabilities and public API as maple3142/gf2bv (the reference at
``/root/reference``), re-designed for the device: packed coefficient matrices
instead of per-bit big-ints, XLA fori-loop / Pallas panel elimination instead
of M4RI PLUQ, batched + mesh-sharded multi-instance solving, and on-device
affine-space enumeration.
"""

from .core.affine import AffineSpace
from .core.bitvec import BitVec
from .core.capture import CapturedTrace
from .core.system import (
    DimensionTooLargeError,
    LinearSystem,
    QuadraticSystem,
    Zeros,
)
from .ops.incremental import IncrementalSolver

__version__ = "0.3.0"


def m4ri_solve(equations, cols: int, mode: int):
    """Low-level compat shim for the reference's native entry point
    (``/root/reference/gf2bv/_internal.pyi:18-23``): equations are big-int
    masks (bit 0 = const, bits 1..cols = variables); mode 0 returns one
    solution int (or None), mode 1 the AffineSpace (or None).  Solved on
    the default device."""
    from .core import packing
    from .ops import solver

    eqs = packing.ints_to_rows(list(equations), 1 + cols)
    return solver.solve(eqs, cols, mode)


__all__ = [
    "AffineSpace",
    "BitVec",
    "CapturedTrace",
    "DimensionTooLargeError",
    "IncrementalSolver",
    "LinearSystem",
    "QuadraticSystem",
    "Zeros",
    "m4ri_solve",
]
