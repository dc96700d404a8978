"""Multi-RHS solving: ONE elimination, thousands of instances.

The defining property of a captured/lazy trace is that the COEFFICIENT
matrix is shared across instances — only the affine column differs.  The
classical consequence (the reference cannot exploit it: ``m4ri_solve``
factors per call, ``/root/reference/gf2bv/_internal.c:359-502``): solving
``A x = b_k`` for many k needs ONE reduction of ``[A | b_0 .. b_{B-1}]``.

The per-instance affine columns are appended as extra 128-word tiles on
the right of the packed matrix (anything past ``cols`` can never
pivot — the panel scan's validity mask already guarantees it — so the
rank-K updates simply carry the block along).  Up to ``MAX_RHS`` = 32768
instances (8 appended tiles) ride a single blocked RREF for ~one extra
word-tile of phase-2 work per 4096 instances; per-instance origins and
unsatisfiability fall out of the appended block, and in mode 1 all
instances share one kernel basis (same coefficient matrix => same null
space).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..core import packing
from ..core.affine import AffineSpace

# One appended tile = 4096 instances; at most 8 tiles per elimination.
# Both tuned on another machine, to re-measure (ROADMAP S3).
_RHS_TILE = 128
MAX_RHS_TILES = 8
MAX_RHS = 32 * _RHS_TILE * MAX_RHS_TILES  # 32768 instances per elimination


# instance-count buckets: host packs / uploads / extracts only bw words,
# the device pads the appended block to whole _RHS_TILE tiles (static
# shapes per bucket; each bucket compiles its own solver width)
_BW_BUCKETS = (
    1, 8, 32, _RHS_TILE, 2 * _RHS_TILE, 4 * _RHS_TILE,
    MAX_RHS_TILES * _RHS_TILE,
)


def _bw_for(nb: int) -> int:
    for bw in _BW_BUCKETS:
        if nb <= 32 * bw:
            return bw
    raise ValueError(f"multi-RHS supports at most {MAX_RHS} instances per call")


def _tiles_for(bw: int) -> int:
    return -(-bw // _RHS_TILE)


def _pack_rhs(rhs_bits: np.ndarray, rows_pad: int, bw: int) -> np.ndarray:
    """(B, rows) uint8 0/1 -> (rows_pad, bw) uint32: instance k's affine
    bit of row r lands at word k>>5, bit k&31 of row r.

    Packs along the instance axis FIRST (np.packbits, in 512-instance
    chunks so the strided pack stays cache-resident) and only then
    transposes: the shuffled intermediate is B/8 bytes per row instead of
    a (32*bw, rows_pad) bit-per-byte blow-up."""
    nb, rows = rhs_bits.shape
    out8 = np.zeros((rows_pad, 4 * bw), dtype=np.uint8)
    for lo in range(0, nb, 512):
        pk = np.packbits(rhs_bits[lo : lo + 512], axis=0, bitorder="little")
        out8[:rows, lo // 8 : lo // 8 + pk.shape[0]] = pk.T
    # byte k>>3 bit k&7 == uint32 word k>>5 bit k&31 on a little-endian
    # host (all supported hosts and devices are LE)
    return out8.view(np.uint32)


def _pack_rhs_affine_sweep(
    base_aff: np.ndarray, guess_bits: np.ndarray, rows_pad: int, bw: int
) -> np.ndarray:
    """Packed RHS for a guess-sweep chunk WITHOUT materializing the
    (B, rows) bit matrix: every instance shares ``base_aff`` except the
    last G rows, where instance k's bit is ``base ^ guess_bits[k, g]``.

    The shared column packs as a word fill (bit b of every instance word
    equals base_aff[row]) and the guess rows pack from the tiny (G, B)
    candidate matrix — O(rows_pad * bw) words written instead of
    O(B * rows) bytes.

    base_aff: (rows,) uint8 0/1; guess_bits: (nb, G) uint8.  Instances
    beyond nb in the last used word replicate the base column; they are
    phantom instances whose outputs the callers never read."""
    nb, G = guess_bits.shape
    rows = base_aff.shape[0]
    nwu = -(-nb // 32)
    out = np.zeros((rows_pad, bw), np.uint32)
    out[:rows, :nwu] = np.where(
        base_aff, np.uint32(0xFFFFFFFF), np.uint32(0)
    )[:, None]
    if G:
        pk = np.packbits(
            np.ascontiguousarray(guess_bits.T), axis=1, bitorder="little"
        )
        pad = nwu * 4 - pk.shape[1]
        if pad:
            pk = np.pad(pk, ((0, 0), (0, pad)))
        out[rows - G : rows, :nwu] ^= pk.view(np.uint32)
    return out


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _extract_multi(rref32, pof, cols: int, wp: int, bw: int):
    """(origins (32*bw, Wsol32) u32, unsat_words (bw,) u32) — only the
    USED instance-word bucket is processed and read back (not all 4096
    potential origins of a tile).

    origin_k = RHS-column-k bits of the pivot rows; unsat bit k = some row
    with an empty coefficient part still carries instance k's affine bit
    (0*x = 1), the multi-column form of inconsistent_device."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    prow_safe = jnp.maximum(pof, 0)
    # slice the RHS tile BEFORE gathering: the gather then touches only
    # (cols, bw) words instead of full-width rows
    r = rref32[:, wp : wp + bw][prow_safe]  # (cols, bw)
    r = jnp.where((pof >= 0)[:, None], r, 0)
    bits = ((r[:, :, None] >> shifts[None, None, :]) & 1).astype(jnp.uint8)
    bits = bits.reshape(cols, 32 * bw).T  # (32*bw, cols)
    nw32 = 2 * packing.nwords64(cols)
    pad = nw32 * 32 - cols
    if pad:
        bits = jnp.pad(bits, ((0, 0), (0, pad)))
    origins = jnp.sum(
        bits.reshape(32 * bw, nw32, 32).astype(jnp.uint32)
        << shifts[None, None, :],
        axis=2,
        dtype=jnp.uint32,
    )

    coeff0 = rref32[:, 0] & ~jnp.uint32(1)  # ignore the inert bit-0 column
    nonzero = coeff0 != 0
    if wp > 1:
        nonzero = nonzero | jnp.any(rref32[:, 1:wp] != 0, axis=1)
    dead_rhs = jnp.where(nonzero[:, None], 0, rref32[:, wp : wp + bw])
    unsat_words = jnp.bitwise_or.reduce(dead_rhs, axis=0)
    return origins, unsat_words


def solve_multi_rhs_device(
    a_dev,
    cols: int,
    rhs_dev,
    bw: int,
    k_panel: int | None = None,
):
    """Device-side core: augmented elimination + multi-column extraction.

    a_dev: (rows_pad, wp) uint32 device matrix; rhs_dev: (rows_pad, bw)
    uint32 packed per-instance affine columns (``_pack_rhs`` layout).
    Returns DEVICE arrays (rref32, pof, origins32, unsat_words) with no
    host synchronization — callers time/compose this, then device_get what
    they need.  Kept separate from the host wrapper so benchmarks can
    attribute device time apart from host packing and transfers.
    """
    from .gauss_blocked import K_PANEL, rref_blocked

    rows_pad, wp = a_dev.shape
    want = _tiles_for(bw) * _RHS_TILE
    if rhs_dev.shape[1] < want:
        rhs_dev = jnp.pad(rhs_dev, ((0, 0), (0, want - rhs_dev.shape[1])))
    a_aug = jnp.concatenate([a_dev, rhs_dev], axis=1)

    rref32, pof, _ = rref_blocked(a_aug, cols, k_panel or K_PANEL)
    origins32, unsat_words = _extract_multi(rref32, pof, cols, wp, bw)
    return rref32, pof, origins32, unsat_words


def solve_multi_rhs(
    a32,
    cols: int,
    rhs_bits: np.ndarray | None,
    mode: int = 0,
    k_panel: int | None = None,
    basis_cache: dict | None = None,
    rhs_packed: np.ndarray | None = None,
    nb: int | None = None,
):
    """Solve the SAME coefficient matrix for many affine columns at once.

    a32: (rows_pad, wp) uint32 packed matrix, host or device resident
    (its own bit-0 affine column is inert and ignored); rhs_bits:
    (B, rows) uint8 with instance k's affine bit per original row,
    B <= MAX_RHS (32768).  Returns one entry per instance: a raw solution
    int or None (mode 0), or an AffineSpace (mode 1) — all instances
    sharing one basis object (same coefficient matrix => same kernel).

    ``basis_cache``: a caller-held dict; mode-1 callers looping chunks of
    the same matrix pass the same dict so the kernel basis (identical
    across chunks) is built at most once, and not at all when every
    instance is unsatisfiable.

    ``rhs_packed``/``nb``: alternative pre-packed input — a
    (rows_pad, bw) uint32 block in ``_pack_rhs`` layout carrying ``nb``
    instances (pass ``rhs_bits=None``).  Callers whose RHS has structure
    (the guess sweep's shared-base-column form, ``_pack_rhs_affine_sweep``)
    build it directly instead of materializing (B, rows) bits.
    """
    from . import extract_device

    a_dev = jnp.asarray(a32, jnp.uint32)
    rows_pad, wp = a_dev.shape
    if rhs_packed is not None:
        if nb is None:
            raise ValueError("rhs_packed requires nb")
        bw = rhs_packed.shape[1]
        if bw != _bw_for(nb):
            raise ValueError(
                f"rhs_packed width {bw} != bucket {_bw_for(nb)} for nb={nb}"
            )
        rhs_dev = jnp.asarray(rhs_packed)
    else:
        nb = rhs_bits.shape[0]
        bw = _bw_for(nb)
        # upload only the used instance words; the device zero-pads the
        # block to whole 128-word tiles
        rhs_dev = jnp.asarray(
            _pack_rhs(np.asarray(rhs_bits, np.uint8), rows_pad, bw)
        )
    rref32, pof, origins_dev, unsat_dev = solve_multi_rhs_device(
        a_dev, cols, rhs_dev, bw, k_panel
    )
    origins32, unsat_words = jax.device_get((origins_dev, unsat_dev))

    bcache = basis_cache if basis_cache is not None else {}

    def _basis():
        if "basis" not in bcache:
            bcache["basis"] = extract_device._basis_host_orchestrated(
                rref32, np.asarray(pof), cols
            )
        return bcache["basis"]

    out = []
    for k in range(nb):
        if (unsat_words[k >> 5] >> (k & 31)) & 1:
            out.append(None)
            continue
        origin = packing.from_u32(origins32[k][None, :])[0]
        if mode == 0:
            out.append(packing.words_to_int(origin))
        else:
            out.append(AffineSpace(origin, _basis(), cols))
    return out
