"""On-device affine-space enumeration and filtering.

Replaces the reference's sequential Gray-code iterator (one row-XOR and one
bigint conversion per point, ``/root/reference/gf2bv/_internal.c:61-175``)
with batched device materialization: a whole chunk of points is computed as
``origin ^ (selector-bits x basis)`` in one fused op, in the reference's
exact enumeration order (Gray for dim <= 64, binary counter above).

Also provides the QuadraticSystem consistency filter as a device kernel so
huge candidate spaces can be filtered without round-tripping Python ints.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core import packing


@functools.partial(jax.jit, static_argnums=(4, 5))
def enumerate_points(
    origin: jnp.ndarray,  # (W32,) uint32
    basis: jnp.ndarray,  # (dim, W32) uint32
    start_lo: jnp.ndarray,  # () uint32 — chunk start index, low 32 bits
    start_hi: jnp.ndarray,  # () uint32 — high 32 bits (dim can exceed 32)
    count: int,
    gray: bool,
):
    """points[i] = origin ^ combo(bits(order(start+i))) for i < count.

    The device paths keep to 32-bit integers, so the enumeration index is carried
    as a (hi, lo) uint32 pair — dims up to 64 enumerate correctly (the
    reference's Gray range, ``_internal.c:101-122``)."""
    dim = basis.shape[0]
    assert dim <= 64, "use the host iterator beyond 64 dims"
    i = lax.broadcasted_iota(jnp.uint32, (count, 1), 0).squeeze(-1)
    lo = start_lo.astype(jnp.uint32) + i
    carry = (lo < i).astype(jnp.uint32)  # uint32 wraparound
    hi = start_hi.astype(jnp.uint32) + carry
    if gray:
        glo = lo ^ ((lo >> jnp.uint32(1)) | (hi << jnp.uint32(31)))
        ghi = hi ^ (hi >> jnp.uint32(1))
        lo, hi = glo, ghi
    out = jnp.broadcast_to(origin, (count, origin.shape[0]))
    if dim == 0:
        return out
    jlow = jnp.arange(min(dim, 32), dtype=jnp.uint32)
    sel = (lo[:, None] >> jlow[None, :]) & 1
    if dim > 32:
        jhigh = jnp.arange(dim - 32, dtype=jnp.uint32)
        sel = jnp.concatenate(
            [sel, (hi[:, None] >> jhigh[None, :]) & 1], axis=1
        )
    mask = (jnp.uint32(0) - sel).astype(jnp.uint32)  # (count, dim)
    # xor-reduce over dim: (count, dim, 1) & (1, dim, W32) -> (count, W32)
    delta = jnp.bitwise_xor.reduce(
        mask[:, :, None] & basis[None, :, :], axis=1
    )
    return out ^ delta


@functools.partial(jax.jit, static_argnums=(1,))
def quad_consistency_mask(points: jnp.ndarray, n: int):
    """For packed solutions over (n linear + n(n-1)/2 quad) bits, return a
    bool mask of points whose quad block equals the outer product of the
    linear block — the device form of the reference's convert_sol filter
    (``/root/reference/gf2bv/__init__.py:370-393``)."""
    count, w32 = points.shape
    nbits = 32 * w32
    bitpos = jnp.arange(nbits, dtype=jnp.uint32)
    bits = (points[:, bitpos >> 5] >> (bitpos & 31)) & 1  # (count, nbits)
    lin = bits[:, :n]
    tri_i, tri_j = np.tril_indices(n, k=-1)
    expected = lin[:, tri_i] & lin[:, tri_j]
    quad = bits[:, n : n + tri_i.size]
    return jnp.all(expected == quad, axis=1)


def enumerate_device(space, start: int, count: int):
    """Device-side chunk of ``space`` in its canonical iteration order.
    Spaces beyond 64 dims must use the host iterator (their canonical order
    is the naive bigint counter anyway)."""
    gray = space.dimension <= 64
    origin32 = jnp.asarray(packing.to_u32(space._origin[None, :])[0])
    basis32 = jnp.asarray(packing.to_u32(space._basis))
    return enumerate_points(
        origin32,
        basis32,
        jnp.uint32(start & 0xFFFFFFFF),
        jnp.uint32(start >> 32),
        count,
        gray,
    )


def iter_quad_filtered(space, lin_size: int, chunk: int = 4096):
    """Yield raw solution ints of ``space`` that pass the quadratic
    consistency filter, filtering whole chunks on device."""
    total = 1 << space.dimension
    done = 0
    while done < total:
        nchunk = min(chunk, total - done)
        pts = enumerate_device(space, done, nchunk)
        mask = np.asarray(quad_consistency_mask(pts, lin_size))
        if mask.any():
            rows = packing.from_u32(np.asarray(pts)[mask])
            yield from packing.rows_to_ints(rows)
        done += nchunk
