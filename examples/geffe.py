"""Geffe generator break: guess the short register, batch-solve the rest.

The Geffe generator combines three LFSRs through ``z = x1·x2 ^ (1^x1)·x3``
— a classic CTF/crypto-course target.  Degree-2 linearization alone cannot
finish it (the products only touch a thin slice of the monomial space, so
the linearized solution space stays huge); the structure to exploit is that
CONDITIONED on register 1's stream the keystream is LINEAR in registers 2
and 3.  That conditioning is exactly the shape the device build scales:

1. register 1's output stream is a GF(2)-linear map of its initial state,
   so ALL 2^n1 candidate streams are ONE packed matmul on the device;
2. every candidate yields a linear system whose rows just SELECT between
   two fixed symbolic row sets (reg-2's bit vs reg-3's bit) — a batched
   ``jnp.where`` over the traced coefficient rows;
3. all 2^n1 systems are solved by the vmapped batched Gauss-Jordan in a
   few device dispatches; wrong guesses are overdetermined garbage and come
   back unsatisfiable.

The reference could express step 2's trace (its BitVec algebra) but would
have to run 2^n1 sequential m4ri_solve calls for step 3
(``/root/reference/gf2bv/_internal.c:359``); the batch axis is the new
capability (SURVEY.md §2 parallelism inventory).
"""

import _bootstrap  # noqa: F401  (repo-root imports + persistent compile cache)

import secrets
import time

import numpy as np

import jax.numpy as jnp

from gf2bv_tpu import BitVec, LinearSystem
from gf2bv_tpu.core import packing
from gf2bv_tpu.crypto.lfsr import GaloisLFSR
from gf2bv_tpu.ops import extract_device
from gf2bv_tpu.parallel import batch as pbatch

# register sizes / taps (maximal-length Galois masks)
N1, T1 = 13, 0x1B59
N2, T2 = 19, 0x72EA7
N3, T3 = 23, 0x5C4E55
T = 96  # keystream bits observed (>= n2 + n3 + margin)


def geffe_stream(s1: int, s2: int, s3: int, n: int) -> list[int]:
    r1, r2, r3 = (
        GaloisLFSR(N1, T1, s1),
        GaloisLFSR(N2, T2, s2),
        GaloisLFSR(N3, T3, s3),
    )
    out = []
    for _ in range(n):
        x1, x2, x3 = r1(), r2(), r3()
        out.append((x1 & x2) ^ ((x1 ^ 1) & x3))
    return out


def _trace_rows(lin, reg) -> np.ndarray:
    """(T, W64) packed coefficient rows of a register's first T output bits.
    (A symbolic ``reg()`` is the width-n masked state; bit 0 is the output.)"""
    bits = [reg()[0] for _ in range(T)]
    return BitVec.stack(bits).rows


def attack(keystream: list[int]):
    # symbolic output rows of registers 2 and 3 over a joint 42-var system
    lin = LinearSystem([N2, N3])
    g2, g3 = lin.gens(lazy=False)
    a2 = _trace_rows(lin, GaloisLFSR(N2, T2, g2))
    a3 = _trace_rows(lin, GaloisLFSR(N3, T3, g3))
    z = np.asarray(keystream, dtype=np.uint64)
    a2z = a2.copy()
    a2z[:, 0] ^= z  # affine bit <- z_t
    a3z = a3.copy()
    a3z[:, 0] ^= z

    # register 1: all 2^N1 candidate streams in one packed device matmul
    lin1 = LinearSystem([N1])
    (g1,) = lin1.gens(lazy=False)
    s_rows = _trace_rows(lin1, GaloisLFSR(N1, T1, g1))  # (T, W64)
    s_bits = packing.unpack_rows(s_rows, 1 + N1)[:, 1:]  # (T, N1) 0/1
    guesses = np.arange(1 << N1, dtype=np.uint32)
    gbits = ((guesses[:, None] >> np.arange(N1)[None, :]) & 1).astype(np.uint8)
    x1 = jnp.asarray(gbits) @ jnp.asarray(s_bits.T.astype(np.uint8)) & 1
    # x1: (2^N1, T) — candidate reg-1 output streams

    # per-guess equation rows: select reg2's bit where x1=1, reg3's where 0
    a2d = jnp.asarray(packing.to_u32(a2z))  # (T, W32)
    a3d = jnp.asarray(packing.to_u32(a3z))
    rows_pad = 256  # >= T, the solver's row bucket
    cols = lin.cols

    def sweep():
        eqs = jnp.where(x1[:, :, None] == 1, a2d[None], a3d[None])
        eqs = jnp.pad(eqs, ((0, 0), (0, rows_pad - T), (0, 0)))
        # batched solve of all 2^N1 systems (vmapped per-pivot Gauss-Jordan)
        rref32, pof, inconsistent = pbatch._rref_batched(eqs, cols)
        origins = extract_device._origin_batch(rref32, pof, cols)
        return np.asarray(origins), np.asarray(inconsistent)

    t0 = time.perf_counter()
    origins, bad = sweep()  # first call pays one-time compiles
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    origins, bad = sweep()
    dt = time.perf_counter() - t0
    cands = np.flatnonzero(~bad)
    print(
        f"{len(guesses)} guesses batch-solved in {dt:.2f}s warm "
        f"({len(guesses) / dt:.0f} solves/s; first call incl. compile "
        f"{cold:.1f}s); {len(cands)} satisfiable"
    )

    # verify candidates against the keystream; exactly one should survive
    hits = []
    for g in cands:
        raw = packing.words_to_int(packing.from_u32(origins[g][None, :])[0])
        s2, s3 = lin.convert_sol(raw)
        if geffe_stream(int(guesses[g]), s2, s3, T) == keystream:
            hits.append((int(guesses[g]), s2, s3))
    return hits


if __name__ == "__main__":
    s1 = secrets.randbits(N1) | 1
    s2 = secrets.randbits(N2) | 1
    s3 = secrets.randbits(N3) | 1
    keystream = geffe_stream(s1, s2, s3, T)
    print(f"secret: s1={s1:#x} s2={s2:#x} s3={s3:#x}")

    hits = attack(keystream)
    for h in hits:
        print(f"recovered: s1={h[0]:#x} s2={h[1]:#x} s3={h[2]:#x}")
    assert (s1, s2, s3) in hits, "true state not recovered"
    # the recovered state must predict FUTURE keystream too
    g1, g2, g3 = hits[0]
    assert geffe_stream(g1, g2, g3, 4 * T) == geffe_stream(s1, s2, s3, 4 * T)
    print("ok")
