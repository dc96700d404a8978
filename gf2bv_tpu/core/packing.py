"""Bit-packing primitives for the GF(2) engine.

The reference (gf2bv) represents a symbolic bit as a Python big-int mask over
the monomial basis (``/root/reference/gf2bv/__init__.py:24-27,151-152``): bit 0
is the affine/constant term, bits ``1..cols`` the linear variables.  Here the
same mask is a **packed word array**: bit ``j`` of the mask lives at word
``j // 64``, bit ``j % 64`` of a little-endian ``uint64`` numpy array.  On
device the same buffer is viewed as ``uint32`` (the device paths keep to
32-bit words), so ``W32 == 2 * W64`` always holds and bit ``j`` is at 32-bit word
``j // 32``, bit ``j % 32``.

All helpers are host-side numpy; they are cheap O(bits) conversions used at
API boundaries (Python ints in/out).  The hot paths never touch Python ints.
"""

from __future__ import annotations

import numpy as np

WORD = 64  # host packing word size
DWORD = 32  # device packing word size


def nwords64(nbits: int) -> int:
    """Number of 64-bit words needed for ``nbits`` bits (minimum 1)."""
    return max(1, (nbits + WORD - 1) // WORD)


def int_to_words(value: int, nbits: int) -> np.ndarray:
    """Pack a non-negative Python int into a little-endian uint64 array.

    Bits at positions >= nbits must be absent (callers mask beforehand).
    """
    nw = nwords64(nbits)
    b = value.to_bytes(nw * 8, "little")
    return np.frombuffer(b, dtype="<u8").astype(np.uint64, copy=False)


def words_to_int(words: np.ndarray) -> int:
    """Inverse of :func:`int_to_words`."""
    return int.from_bytes(np.ascontiguousarray(words, dtype="<u8").tobytes(), "little")


def ints_to_rows(values: list[int], nbits: int) -> np.ndarray:
    """Pack a list of ints into a (len(values), W64) uint64 matrix."""
    nw = nwords64(nbits)
    out = np.empty((len(values), nw), dtype=np.uint64)
    for i, v in enumerate(values):
        out[i] = int_to_words(v, nbits)
    return out


def rows_to_ints(rows: np.ndarray) -> list[int]:
    """Unpack a (n, W64) uint64 matrix into Python ints, one per row."""
    rows = np.ascontiguousarray(rows, dtype="<u8")
    nw = rows.shape[1]
    buf = rows.tobytes()
    return [
        int.from_bytes(buf[i * nw * 8 : (i + 1) * nw * 8], "little")
        for i in range(rows.shape[0])
    ]


def bit_rows(nbits: int, positions: np.ndarray) -> np.ndarray:
    """Rows with a single set bit each: row i has bit ``positions[i]`` set.

    Used to mint fresh variables (the reference's ``basis = [1 << i ...]``,
    ``/root/reference/gf2bv/__init__.py:151-159``).
    """
    positions = np.asarray(positions, dtype=np.int64)
    nw = nwords64(nbits)
    out = np.zeros((len(positions), nw), dtype=np.uint64)
    out[np.arange(len(positions)), positions // WORD] = np.uint64(1) << (
        positions % WORD
    ).astype(np.uint64)
    return out


def mask_bits(nbits: int, mask: int) -> np.ndarray:
    """Unpack ``nbits`` low bits of a Python int into a (nbits,) uint8 array."""
    nw = nwords64(nbits)
    b = (mask & ((1 << (nw * WORD)) - 1)).to_bytes(nw * 8, "little")
    bits = np.unpackbits(np.frombuffer(b, dtype=np.uint8), bitorder="little")
    return bits[:nbits]


def unpack_rows(rows: np.ndarray, nbits: int) -> np.ndarray:
    """Unpack (n, W64) uint64 rows into (n, nbits) uint8 bit matrix."""
    rows = np.ascontiguousarray(rows, dtype="<u8")
    bits = np.unpackbits(rows.view(np.uint8), axis=1, bitorder="little")
    return bits[:, :nbits]


def pack_bits(bits: np.ndarray, nbits: int | None = None) -> np.ndarray:
    """Pack a (..., nbits) uint8/bool bit matrix into (..., W64) uint64 rows."""
    bits = np.asarray(bits, dtype=np.uint8)
    if nbits is None:
        nbits = bits.shape[-1]
    nw = nwords64(nbits)
    pad = nw * WORD - bits.shape[-1]
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), dtype=np.uint8)], axis=-1
        )
    packed = np.packbits(bits, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u8").astype(np.uint64, copy=False)


def to_u32(rows: np.ndarray) -> np.ndarray:
    """View (n, W64) uint64 rows as (n, 2*W64) uint32 (device layout)."""
    return np.ascontiguousarray(rows, dtype="<u8").view("<u4")


def from_u32(rows32: np.ndarray) -> np.ndarray:
    """View (n, W32) uint32 rows back as (n, W32//2) uint64 (host layout)."""
    rows32 = np.ascontiguousarray(rows32, dtype="<u4")
    assert rows32.shape[-1] % 2 == 0
    return rows32.view("<u8")


def split_rows_by_sizes(rows: np.ndarray, sizes) -> list[tuple[int, ...]]:
    """Vectorized solution split: each (W64-packed) row becomes a tuple of
    per-block ints, low bits first, block widths from ``sizes`` — the
    batch form of the reference's ``convert_sol`` loop
    (``/root/reference/gf2bv/__init__.py:242-248``: ``s & mask; s >>= n``).

    Per-int bigint shifting costs O(total_bits^2 / 64) per row (each
    ``>>=`` copies the remaining words); this unpacks all rows to a bit
    matrix once and packs each block column-slice back, O(total_bits) per
    row.  Rows are processed in bounded chunks so huge batches (multi-RHS
    sweeps at B = 32768) don't materialize a GB-scale bit matrix.

    Stray bits above ``sum(sizes)`` raise (the reference asserts the
    solution int is exhausted).
    """
    sizes = list(sizes)
    nbits = sum(sizes)
    rows = np.ascontiguousarray(rows, dtype="<u8")
    n = rows.shape[0]
    if rows.shape[1] * WORD < nbits:
        raise ValueError("rows narrower than sum(sizes)")
    if not sizes:
        # one empty tuple per row (zip(*[]) would collapse to []); rows
        # must still be all-zero, matching the exhausted-bits assert
        if rows.any():
            raise AssertionError("Invalid solution")
        return [() for _ in range(n)]
    out: list[tuple[int, ...]] = []
    chunk = max(1, (64 << 20) // max(1, nbits))  # ~64 MB of unpacked bits
    for c0 in range(0, n, chunk):
        bits = np.unpackbits(
            rows[c0 : c0 + chunk].view(np.uint8), axis=1, bitorder="little"
        )
        if bits.shape[1] > nbits and bits[:, nbits:].any():
            raise AssertionError("Invalid solution")  # ref: exhausted bits
        cols: list[list[int]] = []
        off = 0
        for sz in sizes:
            blk = bits[:, off : off + sz]
            off += sz
            nby = (sz + 7) // 8
            packed = np.packbits(blk, axis=1, bitorder="little")
            nw = (sz + 63) // 64
            if nw * 8 > nby:
                packed = np.pad(packed, ((0, 0), (0, nw * 8 - nby)))
            words = packed.view("<u8")
            if nw == 1:
                cols.append(words[:, 0].tolist())
            else:
                cols.append(rows_to_ints(words))
        out.extend(zip(*cols))
    return out


def popcount_words(words: np.ndarray) -> np.ndarray:
    """Per-element popcount of a uint64 array (vectorized, host)."""
    # numpy >= 2.0 has bitwise_count
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(words)
    v = words.copy()
    c = np.zeros_like(v)
    for _ in range(64):
        c += v & np.uint64(1)
        v >>= np.uint64(1)
    return c


def parity_rows(rows: np.ndarray) -> np.ndarray:
    """GF(2) parity (XOR of all bits) per row of a (n, W) uint64 matrix."""
    return (popcount_words(rows).sum(axis=-1) & 1).astype(np.uint8)


def pad2d(
    a32: np.ndarray, row_align: int = 1, word_align: int = 1, min_rows: int = 0
) -> np.ndarray:
    """Zero-pad a (rows, W32) uint32 matrix so rows is a multiple of
    ``row_align`` (and >= min_rows) and the word count a multiple of
    ``word_align``.  Zero rows/columns are inert in every solver (they never
    pivot and never contribute bits); the single padding helper keeps the
    alignment rules of all solver entries in one place."""
    rows, w32 = a32.shape
    # min_rows participates in the ceil so the row_align contract holds even
    # when min_rows itself is not a multiple of row_align
    want_rows = -(-max(min_rows, row_align, rows) // row_align) * row_align
    want_w = -(-w32 // word_align) * word_align
    if want_rows == rows and want_w == w32:
        return np.ascontiguousarray(a32)
    out = np.zeros((want_rows, want_w), dtype=np.uint32)
    out[:rows, :w32] = a32
    return out
