"""MT19937 symbolic trace as a device program (the flagship fast path).

The generic trace (crypto/mt.py over numpy BitVecs) builds the ~52 MB
packed system on the host and uploads it.  But the symbolic system is pure
structured bit-matrix algebra: the initial state is a one-hot basis,
twist/temper are row masks/shifts/XORs.  So build it directly on the
device under one jit; the only host->device traffic is the concrete
outputs (624 uint32 words, 2.5 KB).

Semantics mirror crypto/mt.py (itself faithful to the reference
``/root/reference/gf2bv/crypto/mt.py``): state tensor S[(i, b)] = packed
affine mask of bit b of state word i; twist linearizes the ``(y & 1) * a``
select as broadcast-bit0 AND a (ref mt.py:33-38); temper is the standard
4-round shift/mask cascade; ``getrandbits(bs)`` for bs <= w takes the top
``bs`` bits of each output word (ref mt.py:56-60).

Exactness is tested against the generic host trace bit-for-bit.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core import packing

# MT19937 parameters (as in crypto/mt.py)
W, N, M, R = 32, 624, 397, 31
A = 0x9908B0DF
U, D = 11, 0xFFFFFFFF
S_, B = 7, 0x9D2C5680
T_, C = 15, 0xEFC60000
L = 18

COLS = W * N  # 19968
_NBITS = 1 + COLS


def _bits32(mask: int) -> np.ndarray:
    return np.array([(mask >> i) & 1 for i in range(32)], dtype=np.uint32)


def _wp(pad_words: int = 128) -> int:
    w32 = 2 * packing.nwords64(_NBITS)
    return -(-w32 // pad_words) * pad_words


def _temper(y: jnp.ndarray) -> jnp.ndarray:
    """Temper a (..., 32, wp) block (vectorized over leading dims)."""

    def sh(v, n, left):
        z = jnp.zeros(v.shape[:-2] + (n, v.shape[-1]), v.dtype)
        if left:
            return jnp.concatenate([z, v[..., :-n, :]], axis=-2)
        return jnp.concatenate([v[..., n:, :], z], axis=-2)

    def mask(v, m):
        bits = jnp.asarray(_bits32(m))[..., :, None]
        return v * bits

    y = y ^ mask(sh(y, U, False), D)
    y = y ^ mask(sh(y, S_, True), B)
    y = y ^ mask(sh(y, T_, True), C)
    y = y ^ sh(y, L, False)
    return y


@functools.partial(jax.jit, static_argnums=(1, 2))
def mt19937_system_device(outs: jnp.ndarray, bs: int, samples: int):
    """Packed equation matrix for MT19937 recovery, built on device.

    outs: the observed getrandbits(bs) values — (samples,) uint32 for
    bs <= 32, or (samples, ceil(bs/32)) uint32 word-split (LSB-first words)
    for larger bs (CPython's multi-word getrandbits, ref mt.py:62-81: every
    word contributes its TOP min(k_left, 32) bits, concatenated LSB-first).
    Returns (rows, wp) uint32: ``samples*bs`` output equations followed by
    the 32 known-MSB equations mt[0] ^ 0x80000000 (examples/mt.py:33).
    """
    assert bs >= 1
    wp = _wp()
    wpc = -(-bs // 32)  # words per getrandbits call
    total_words = samples * wpc
    epochs = -(-total_words // N)
    if outs.ndim == 1:
        outs = outs[:, None]
    assert outs.shape == (samples, wpc)

    # initial symbolic state: S[i, b] has packed bit (1 + 32 i + b) set
    pos = 1 + 32 * lax.broadcasted_iota(jnp.int32, (N, W, 1), 0) + (
        lax.broadcasted_iota(jnp.int32, (N, W, 1), 1)
    )
    warr = lax.broadcasted_iota(jnp.int32, (1, 1, wp), 2)
    state = jnp.where(
        warr == (pos >> 5),
        jnp.uint32(1) << (pos & 31).astype(jnp.uint32),
        jnp.uint32(0),
    )

    umsk_bits = jnp.asarray(_bits32(0x80000000))[None, :, None]
    lmsk_bits = jnp.asarray(_bits32(0x7FFFFFFF))[None, :, None]
    a_bits = jnp.asarray(_bits32(A))[None, :, None]

    # Vectorized twist.  Step i reads st[i], st[(i+1)%N] (pre-step value)
    # and st[(i+M)%N] (pre-step for i < N-M, already-twisted otherwise;
    # i = N-1 also reads the already-twisted st[0]).  Splitting the loop at
    # multiples of N-M makes every chunk's reads refer only to values fixed
    # before the chunk, so each chunk is ONE batched array op: 3 ops per
    # epoch instead of 624 sequential fori_loop steps.
    bounds = list(range(0, N, N - M)) + [N]  # [0, 227, 454, 624]

    def twist_chunk(st, lo, hi):
        c = hi - lo
        idx1 = np.arange(lo + 1, hi + 1) % N
        idxm = (np.arange(lo, hi) + M) % N
        y = st[lo:hi] * umsk_bits ^ st[idx1] * lmsk_bits  # (c, W, wp)
        # y >> 1 on the bit rows, and the linearized (y & 1) * A select
        y_shr = jnp.concatenate(
            [y[:, 1:, :], jnp.zeros((c, 1, wp), y.dtype)], axis=1
        )
        sel = y[:, 0:1, :] * a_bits
        new = st[idxm] ^ y_shr ^ sel
        return lax.dynamic_update_slice(st, new, (lo, 0, 0))

    blocks = []
    for _ in range(epochs):
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            state = twist_chunk(state, lo, hi)
        blocks.append(_temper(state))
    tempered = jnp.concatenate(blocks, axis=0)[:total_words]  # (tw, 32, wp)

    # value bit b of call c comes from tempered word c*wpc + b//32, bit-row
    # (32 - nb) + (b % 32), where nb is the bit count that word contributes
    # (32 for all but the last word of a call; bs - 32*(wpc-1) for the last)
    e = np.arange(samples * bs)
    c = e // bs
    b = e % bs
    j = b // 32
    t = b % 32
    nb = np.where(j < wpc - 1, 32, bs - 32 * (wpc - 1))
    flat_row = (c * wpc + j) * 32 + (32 - nb) + t
    out_rows = tempered.reshape(total_words * 32, wp)[flat_row]
    # XOR the observed constant into the affine column (packed bit 0)
    obit = (outs[c, j] >> t.astype(jnp.uint32)) & 1
    const = jnp.zeros((samples * bs, wp), jnp.uint32)
    const = const.at[:, 0].set(obit)
    eqs = out_rows ^ const

    # known-MSB equations: mt[0] ^ 0x80000000
    msb_pos = 1 + lax.broadcasted_iota(jnp.int32, (W, 1), 0)
    msb = jnp.where(
        warr[0] == (msb_pos >> 5),
        jnp.uint32(1) << (msb_pos & 31).astype(jnp.uint32),
        jnp.uint32(0),
    )
    msb = msb.at[31, 0].set(msb[31, 0] | jnp.uint32(1))  # const bit on bit 31
    return jnp.concatenate([eqs, msb], axis=0)


def solve_mt19937_batch(outs_batch, bs: int = 32):
    """Recover MANY MT19937 states in one device program: the whole
    trace+solve pipeline is chained with ``lax.scan`` so no host round-trip
    happens between instances.

    outs_batch: (B, samples) observed getrandbits(bs) values, bs <= 32.
    Returns a list of B state tuples (or None for unsatisfiable entries).
    """
    import functools

    from ..ops import gauss_blocked

    assert 1 <= bs <= 32, "multi-word bs: loop solve_mt19937 instead"
    outs_b = np.asarray(outs_batch, dtype=np.uint32)
    nbatch, samples = outs_b.shape
    rows = samples * bs + 32
    want = -(-rows // 256) * 256

    @functools.partial(jax.jit, static_argnums=())
    def run(ob):
        def body(carry, outs_i):
            e = mt19937_system_device(outs_i, bs, samples)
            if want != rows:
                e = jnp.concatenate(
                    [e, jnp.zeros((want - rows, e.shape[1]), jnp.uint32)],
                    axis=0,
                )
            origin32, unsat = gauss_blocked.rref_origin_blocked(e, COLS)
            return carry, (origin32, unsat)

        _, res = jax.lax.scan(body, 0, ob)
        return res

    origins, unsats = jax.device_get(run(jnp.asarray(outs_b)))
    out = []
    for i in range(nbatch):
        if bool(unsats[i]):
            out.append(None)
            continue
        s = packing.words_to_int(
            packing.from_u32(np.asarray(origins[i])[None, :])[0]
        )
        sol = []
        for _ in range(N):
            sol.append(s & 0xFFFFFFFF)
            s >>= 32
        out.append(tuple(sol))
    return out


def solve_mt19937(outs, bs: int = 32, samples: int | None = None, mode: int = 0):
    """End-to-end device pipeline: build the system on device and solve it.

    Returns what ``LinearSystem([32]*624).solve_one/solve_raw_space`` would,
    as the 624-tuple of state words (mode 0) or an AffineSpace (mode 1).
    """
    from ..core.affine import AffineSpace
    from ..ops import extract_device, gauss_blocked

    if samples is None:
        samples = len(outs)
    wpc = -(-bs // 32)
    if wpc == 1:
        outs32 = jnp.asarray(np.asarray(outs, dtype=np.uint32))
    else:  # split multi-word values LSB-first
        arr = np.zeros((len(outs), wpc), np.uint32)
        for i, v in enumerate(outs):
            for j in range(wpc):
                arr[i, j] = (int(v) >> (32 * j)) & 0xFFFFFFFF
        outs32 = jnp.asarray(arr)
    eqs = mt19937_system_device(outs32, bs, samples)
    rows = eqs.shape[0]
    want = -(-rows // 256) * 256
    if want != rows:
        eqs = jnp.concatenate(
            [eqs, jnp.zeros((want - rows, eqs.shape[1]), jnp.uint32)], axis=0
        )
    if mode == 0:
        origin32, inconsistent = jax.device_get(
            gauss_blocked.rref_origin_blocked(eqs, COLS)
        )
        if bool(inconsistent):
            return None
        raw = packing.from_u32(np.asarray(origin32)[None, :])[0]
    else:
        rref32, pof, inconsistent = gauss_blocked.rref_blocked(eqs, COLS)
        raw = extract_device.finalize(rref32, pof, inconsistent, COLS, mode)
    if raw is None:
        return None
    if mode == 1:
        return AffineSpace(raw[0], raw[1], COLS)
    s = packing.words_to_int(raw)
    sol = []
    for _ in range(N):
        sol.append(s & 0xFFFFFFFF)
        s >>= 32
    return tuple(sol)
