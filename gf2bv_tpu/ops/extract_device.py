"""On-device solution extraction: never read the RREF matrix back.

Produces the outputs of the reference's ``m4ri_solve`` modes — base
solution and kernel/affine basis (``/root/reference/gf2bv/_internal.c:
436-501``) — from the RREF, on device.

Pulling the ~52 MB reduced matrix to the host (the v1 approach) costs a
device-to-host copy of the whole matrix per solve, while the canonical
outputs are tiny, so compute them on device:

* origin: gather each pivot row's RHS bit by pivot_row_of_col, pack to
  uint32 words -> cols/8 bytes transferred.
* kernel basis: for free column f, ``v_f = e_f + sum_j coeff_jf e_{c_j}``
  with coeff_jf = bit f of pivot row j.  Bits of distinct columns never
  collide inside a word, so the per-word accumulation is an integer
  segment_sum over the pivot rows -> (dim, Wsol) words, still on device.

Shapes are bucketed (rank/dim padded to the next bucket) so jit variants
stay bounded while remaining static-shaped.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..core import packing

_BUCKETS = (16, 64, 256, 1024, 4096, 16384, 65536, 2**18, 2**20)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return n


def _wsol32(cols: int) -> int:
    return 2 * packing.nwords64(cols)


def _pack_u32(bits: jnp.ndarray, nw32: int) -> jnp.ndarray:
    """bits: (nw32*32,) uint32 0/1 -> (nw32,) uint32 packed LSB-first."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(bits.reshape(nw32, 32) << shifts[None, :], axis=1, dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnums=(2,))
def origin_device(rref32: jnp.ndarray, pof: jnp.ndarray, cols: int):
    """Packed particular solution, (Wsol32,) uint32 on device."""
    nw32 = _wsol32(cols)
    prow_safe = jnp.maximum(pof, 0)
    rhs = (rref32[prow_safe, 0] & 1).astype(jnp.uint32)
    x = jnp.where(pof >= 0, rhs, 0)  # (cols,)
    pad = nw32 * 32 - cols
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,), jnp.uint32)])
    return _pack_u32(x, nw32)


# The pivot axis of the basis build is processed in fixed-size chunks: a
# single call bucketed to the full rank compiles a fresh (rankb, dimb)
# gather/segment_sum executable per rank bucket — ~100 s one-time XLA
# compile at the 16384 bucket (NLFSR size).  Chunking caps the compiled
# shape at (_PCHUNK, dimb) forever; partial results combine with XOR on
# device (bits of distinct pivot columns never collide).
_PCHUNK = 4096


@functools.partial(jax.jit, static_argnums=(4,))
def _basis_partial(
    rref32: jnp.ndarray,  # (rows, wp) uint32
    prow: jnp.ndarray,  # (chunk,) int32, padded with 0 + mask via pcol<0
    pcol: jnp.ndarray,  # (chunk,) int32 packed-bit positions, -1 padding
    fcol: jnp.ndarray,  # (dimb,) int32 packed-bit positions, -1 padding
    cols: int,
):
    """Contribution of one pivot chunk: (dimb, Wsol32) uint32 words."""
    nw32 = _wsol32(cols)

    # coeff[j, k] = bit fcol[k] of pivot row prow[j]
    fw = jnp.maximum(fcol, 0) >> 5
    fs = (jnp.maximum(fcol, 0) & 31).astype(jnp.uint32)
    pivrows = rref32[jnp.maximum(prow, 0)]  # (chunk, wp)
    coeff = (pivrows[:, fw] >> fs[None, :]) & 1  # (chunk, dimb) uint32
    valid_p = (pcol >= 0)[:, None]
    valid_f = (fcol >= 0)[None, :]
    coeff = jnp.where(valid_p & valid_f, coeff, 0)

    # pivot contributions: value_jk = coeff << solution-bit-shift(pivot j),
    # accumulated into solution word(pivot j) via segment_sum (bits of
    # distinct columns never collide -> add == or)
    svar = jnp.maximum(pcol - 1, 0)  # solution bit index of pivot col
    sw = (svar >> 5).astype(jnp.int32)
    ss = (svar & 31).astype(jnp.uint32)
    vals = coeff << ss[:, None]  # (chunk, dimb)
    acc = jax.ops.segment_sum(vals, sw, num_segments=nw32)  # (nw32, dimb)
    return acc.T.astype(jnp.uint32)  # (dimb, nw32)


@functools.partial(jax.jit, static_argnums=(2,))
def _basis_onehot(fcol: jnp.ndarray, acc: jnp.ndarray, cols: int):
    """XOR the one-hot free-variable bit into the accumulated basis rows."""
    del cols
    dimb = fcol.shape[0]
    fvar = jnp.maximum(fcol - 1, 0)
    ohw = (fvar >> 5).astype(jnp.int32)
    ohv = jnp.where(fcol >= 0, jnp.uint32(1) << (fvar & 31).astype(jnp.uint32), 0)
    return acc.at[jnp.arange(dimb), ohw].add(ohv)


def _basis_device(rref32, prow, pcol, fcol, cols: int):
    """(dimb, Wsol32) uint32 basis rows, chunked over the pivot axis."""
    rankb = prow.shape[0]
    acc = None
    for c0 in range(0, rankb, _PCHUNK):
        part = _basis_partial(
            rref32, prow[c0 : c0 + _PCHUNK], pcol[c0 : c0 + _PCHUNK], fcol, cols
        )
        acc = part if acc is None else acc ^ part
    return _basis_onehot(fcol, acc, cols)


@jax.jit
def inconsistent_device(rref32: jnp.ndarray) -> jnp.ndarray:
    """Any row reduced to 0*x = 1 (variable bits empty, const bit set)."""
    const_bit = (rref32[:, 0] & 1) == 1
    var_any = (rref32[:, 0] >> 1) != 0
    if rref32.shape[1] > 1:
        var_any = var_any | jnp.any(rref32[:, 1:] != 0, axis=1)
    return jnp.any(const_bit & ~var_any)


@functools.partial(jax.jit, static_argnums=(2,))
def _origin_batch(rref32_b, pof_b, cols: int):
    return jax.vmap(lambda r, p: origin_device(r, p, cols))(rref32_b, pof_b)


def finalize_batch(rref32_b, pof_b, inconsistent_b, cols: int, mode: int):
    """Batched extraction: one device call + one small readback for all the
    origins; per-instance basis construction only in mode 1."""
    inc = np.asarray(inconsistent_b)
    pof_h = np.asarray(pof_b)
    origins32 = np.asarray(_origin_batch(rref32_b, pof_b, cols))
    out = []
    for i in range(origins32.shape[0]):
        if inc[i]:
            out.append(None)
            continue
        origin = packing.from_u32(origins32[i][None, :])[0]
        if mode == 0:
            out.append(origin)
            continue
        out.append(
            (origin, _basis_host_orchestrated(rref32_b[i], pof_h[i], cols))
        )
    return out


def _basis_host_orchestrated(rref32, pof_h, cols: int) -> np.ndarray:
    """Bucketed device basis build for one instance (see finalize)."""
    pivot_mask = pof_h >= 0
    rank = int(pivot_mask.sum())
    dim = cols - rank
    nw64 = packing.nwords64(cols)
    if dim == 0:
        return np.zeros((0, nw64), dtype=np.uint64)
    rankb, dimb = _bucket(max(rank, 1)), _bucket(dim)
    pcol = np.full(rankb, -1, np.int32)
    prow = np.zeros(rankb, np.int32)
    pc = np.nonzero(pivot_mask)[0].astype(np.int32) + 1
    pcol[:rank] = pc
    prow[:rank] = pof_h[pc - 1]
    fcol = np.full(dimb, -1, np.int32)
    fcol[:dim] = np.nonzero(~pivot_mask)[0].astype(np.int32) + 1
    basis32 = np.asarray(
        _basis_device(
            rref32, jnp.asarray(prow), jnp.asarray(pcol), jnp.asarray(fcol), cols
        )[:dim]
    )
    return packing.from_u32(basis32)


def finalize(rref32, pof, inconsistent, cols: int, mode: int):
    """Shared device-side extraction tail for all JAX solver variants.

    rref32/pof/inconsistent are device arrays from an rref kernel.  Returns
    None, packed origin (W64 host array), or (origin, basis).
    """
    import jax

    # dispatch the origin build BEFORE the inconsistency readback so both
    # land in one device_get (each separate readback costs a full RTT)
    origin32, pof_h, inc = jax.device_get(
        (origin_device(rref32, pof, cols), pof, inconsistent)
    )
    if bool(inc):
        return None
    origin = packing.from_u32(origin32[None, :])[0]
    if mode == 0:
        return origin
    return origin, _basis_host_orchestrated(rref32, pof_h, cols)
