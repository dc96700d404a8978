"""Device-side quadratic row construction (the NLFSR hot path).

The reference expands every quadratic product on the host, one O(n^2)
monomial pass per traced output bit (``/root/reference/gf2bv/_internal.c:
538-604``); the round-1 port batched that into host numpy (mul_bits) but
still built ~18 MB of packed rows on the host and uploaded them per solve.

This module moves the expansion itself onto the device: the inputs are the
NARROW per-step tap bitvecs (linear columns only, ~3 words/row), so only
~400 KB crosses the host boundary; the outer-product cross terms, the
linear/constant columns, and the bit packing are one jitted device program;
and the resulting equation matrix stays device-resident for the solver
(ops/solver.solve_packed), eliminating the per-solve upload entirely.

Semantics are mul_bits' (bit-exact, tested): row t of the output is

    XOR_p  a_p[t] * b_p[t]   (quadratic products, linearized monomials)
  ^ XOR_l  l[t]              (linear terms)
  ^ const[t]                 (affine constant)

with the reference's monomial order (i outer, j inner, i > j).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..core import packing
from ..core.bitvec import BitVec


def _unpack_device(words: jnp.ndarray, nbits: int) -> jnp.ndarray:
    """(rows, W32) uint32 -> (rows, nbits) uint8 bits, LSB-first."""
    j = np.arange(nbits)
    w = jnp.asarray(j >> 5)
    s = jnp.asarray((j & 31).astype(np.uint32))
    return ((words[:, w] >> s[None, :]) & 1).astype(jnp.uint8)


def _pack_device(bits: jnp.ndarray, nw32: int) -> jnp.ndarray:
    """(rows, nbits) uint8 -> (rows, nw32) uint32 packed LSB-first."""
    rows, nbits = bits.shape
    pad = nw32 * 32 - nbits
    if pad:
        bits = jnp.concatenate(
            [bits, jnp.zeros((rows, pad), jnp.uint8)], axis=1
        )
    grouped = bits.reshape(rows, nw32, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(grouped << shifts[None, None, :], axis=2, dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _quad_rows_kernel(pairs_a, pairs_b, lin_const, n: int, nw32: int):
    """pairs_a/pairs_b: (P, rows, Wn32) narrow packed operands;
    lin_const: (rows, Wn32) XOR of the linear terms + affine constant.
    Returns (rows, nw32) full-width packed equation rows."""
    npairs, rows, _ = pairs_a.shape

    # constant-index gathers keep the HLO tiny (the per-monomial-block
    # concat formulation produced a ~260-op program whose remote compile
    # took minutes); on device the gathers are cheap, unlike host numpy
    tri_i, tri_j = np.tril_indices(n, k=-1)  # reference monomial order
    gi = jnp.asarray(tri_i + 1)
    gj = jnp.asarray(tri_j + 1)

    head = _unpack_device(lin_const, 1 + n)
    cross = None
    for p in range(npairs):
        abits = _unpack_device(pairs_a[p], 1 + n)
        bbits = _unpack_device(pairs_b[p], 1 + n)
        # constant & x_i^2 = x_i terms: elementwise AND on bits 0..n
        head = head ^ (abits & bbits)
        c = (abits[:, gi] & bbits[:, gj]) ^ (abits[:, gj] & bbits[:, gi])
        cross = c if cross is None else cross ^ c
    out_bits = jnp.concatenate([head, cross], axis=1)
    return _pack_device(out_bits, nw32)


def _narrow32(bv: BitVec, wn32: int, rows: int) -> np.ndarray:
    a32 = packing.to_u32(bv.rows)
    out = np.zeros((rows, wn32), np.uint32)
    out[: a32.shape[0], : a32.shape[1]] = a32
    return out


def quad_rows(
    system,
    pairs,
    linear=(),
    const=0,
) -> jnp.ndarray:
    """Build full-width quadratic equation rows ON DEVICE.

    system: a QuadraticSystem (supplies n and the monomial layout).
    pairs: iterable of (a, b) BitVec pairs, each NARROW (linear columns
    only, equal widths) — e.g. tap streams traced against a plain
    LinearSystem with the same variable layout.
    linear: BitVecs XORed in as linear terms.
    const: int bitmask (bit t = affine constant of row t) or bool array.

    Returns a device (rows, W32) uint32 matrix with bit-exact mul_bits
    semantics, ready for ``solve_packed`` / ``solve_*_packed``.
    """
    pairs = [(a, b) for a, b in pairs]
    assert pairs, "at least one product pair required"
    n = system._lin_size
    rows = len(pairs[0][0])
    for a, b in pairs:
        if len(a) != rows or len(b) != rows:
            raise ValueError("Widths must match")  # as mul_bits raises
    for l_bv in linear:
        if len(l_bv) != rows:
            raise ValueError("Widths must match")
    wn32 = 2 * packing.nwords64(1 + n)
    nw32 = 2 * packing.nwords64(system._nbits)

    pa = np.stack([_narrow32(a, wn32, rows) for a, _ in pairs])
    pb = np.stack([_narrow32(b, wn32, rows) for _, b in pairs])

    lc = np.zeros((rows, wn32), np.uint32)
    for l_bv in linear:
        lc ^= _narrow32(l_bv, wn32, rows)
    if isinstance(const, (int, np.integer)):
        cbits = packing.mask_bits(rows, int(const))
    else:
        cbits = np.asarray(const, dtype=np.uint8)
    lc[:, 0] ^= cbits.astype(np.uint32) & 1

    return _quad_rows_kernel(
        jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(lc), n, nw32
    )


# --------------------------------------------------------------------------
# Batched monomial expansion on the XLA *CPU* backend — the materialize-time
# replacement for QuadraticSystem.mul_bits' numpy loop (core/lazy.
# materialize_many routes here).  Deliberately NOT the accelerator: the
# expansion feeds the
# host-side coefficient assembly, and reading the ~17 MB of product rows
# back from a device would cost more than the whole computation;
# XLA's vectorized CPU code is ~an order of magnitude faster than the numpy
# per-monomial-block loop with zero transfer risk.

_ROW_BUCKETS = (1024, 4096, 16384)  # bounded compile count; larger = chunked


@functools.partial(jax.jit, static_argnums=(2, 3))
def _mul_bits_kernel(a32, b32, n: int, nw32: int):
    """a32/b32: (B, Wn32) narrow packed operands -> (B, nw32) full-width
    packed product rows, mul_bits' monomial order (i outer, j < i inner)."""
    tri_i, tri_j = np.tril_indices(n, k=-1)
    gi = jnp.asarray(tri_i + 1)
    gj = jnp.asarray(tri_j + 1)
    abits = _unpack_device(a32, 1 + n)
    bbits = _unpack_device(b32, 1 + n)
    head = abits & bbits
    cross = (abits[:, gi] & bbits[:, gj]) ^ (abits[:, gj] & bbits[:, gi])
    return _pack_device(jnp.concatenate([head, cross], axis=1), nw32)


def _cpu_device():
    # When the platform list is pinned to an accelerator (e.g.
    # JAX_PLATFORMS=cuda) there is NO cpu backend — and merely asking
    # jax.local_devices(backend="cpu") would initialize the pinned backend
    # first (claiming the accelerator) before raising.  Answer from config
    # alone in that case.
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in str(platforms).split(","):
        return None
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError:  # CPU platform unavailable
        return None


def mul_bits_batch(system, a_rows: np.ndarray, b_rows: np.ndarray):
    """Batched ``mul_bits`` via XLA CPU: (B, Wn64) uint64 narrow operand
    rows -> (B, W64) uint64 full-monomial-width rows, bit-exact with
    ``QuadraticSystem.mul_bits`` (tested).  Rows are padded to a small set
    of bucket sizes (bounded compile count) and oversize batches chunk."""
    n = system._lin_size
    cpu = _cpu_device()
    if cpu is None:
        # No XLA CPU backend (platform pinned to the accelerator).  Running
        # the kernel there would invert this path's whole point — the
        # product rows feed HOST-side coefficient assembly, and shipping
        # ~17 MB back from the device costs more than computing
        # it locally.  Use the vectorized numpy expansion instead.
        return system.mul_bits(
            BitVec(np.ascontiguousarray(a_rows), 1 + n),
            BitVec(np.ascontiguousarray(b_rows), 1 + n),
        ).rows
    nw32 = 2 * packing.nwords64(system._nbits)
    a32 = packing.to_u32(np.ascontiguousarray(a_rows))
    b32 = packing.to_u32(np.ascontiguousarray(b_rows))
    B = a32.shape[0]
    out32 = np.empty((B, nw32), np.uint32)
    cap = _ROW_BUCKETS[-1]
    with jax.default_device(cpu):
        for lo in range(0, B, cap):
            chunk = a32[lo : lo + cap]
            cb = chunk.shape[0]
            bw = next(b for b in _ROW_BUCKETS if b >= cb)
            pad = bw - cb
            ap = np.pad(chunk, ((0, pad), (0, 0)))
            bp = np.pad(b32[lo : lo + cap], ((0, pad), (0, 0)))
            res = _mul_bits_kernel(jnp.asarray(ap), jnp.asarray(bp), n, nw32)
            out32[lo : lo + cb] = np.asarray(res)[:cb]
    return packing.from_u32(out32)
