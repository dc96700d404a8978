"""Phase-2 rank-K update as one Pallas kernel through Triton (GPU).

Computes what :func:`gauss_blocked.rank_k_update_jnp` does,
``a[i] ^= XOR_{jj : bit jj of s[i]} pf[jj]``, but in ONE pass over each
(TR x TW) tile of ``a``: the tile stays in registers while all K = 32*kw
selector bits are applied, where the jnp form streams the matrix once per
selector word (kw passes per panel).  Operands stay u32; the update is
AND/XOR only (no float product anywhere, so parities are exact).

Trailing mode (``w0`` given, the mode-0 fused solve): column tiles wholly
left of the panel are skipped and keep their old contents, except the
first tile, which holds the const word 0 that the origin extraction
reads.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tile shape and warps: among the fastest of a sweep at the flagship shape
# on an H100 (PERF.md)
TR = 32  # rows per tile
TW = 64  # words per tile


def tiles(shape) -> bool:
    """Whether the kernel tiles a (rows, wp) matrix."""
    rows, wp = shape
    return rows % TR == 0 and wp % TW == 0


def _kernel(w0_ref, s_ref, pf_ref, a_ref, o_ref, *, kw: int, trailing: bool):
    def update():
        acc = a_ref[...]
        for g in range(kw):
            sg = s_ref[:, g]

            def body(b, acc, sg=sg, g=g):
                mask = jnp.uint32(0) - ((sg >> b.astype(jnp.uint32)) & 1)
                row = pf_ref[pl.ds(32 * g + b, 1), :]
                return acc ^ (mask[:, None] & row)

            acc = lax.fori_loop(0, 32, body, acc)
        o_ref[...] = acc

    if trailing:
        j = pl.program_id(1)
        pl.when((j == 0) | ((j + 1) * TW > w0_ref[0]))(update)
    else:
        update()


@functools.partial(jax.jit, static_argnames=("interpret",))
def rank_k_update_triton(a, s, pf, w0=None, interpret: bool = False):
    """a: (rows, wp) u32 with :func:`tiles`; s: (rows, kw) u32 selector
    words; pf: (32*kw, wp) u32; w0: traced word offset of the panel, or
    None for the full-width update.  ``interpret`` is for tests on a
    machine without a GPU."""
    rows, wp = a.shape
    kw = s.shape[1]
    w0a = jnp.asarray(0 if w0 is None else w0, jnp.int32).reshape(1)
    return pl.pallas_call(
        functools.partial(_kernel, kw=kw, trailing=w0 is not None),
        out_shape=jax.ShapeDtypeStruct(a.shape, a.dtype),
        grid=(rows // TR, wp // TW),
        in_specs=[
            pl.BlockSpec((1,), lambda i, j: (0,)),
            pl.BlockSpec((TR, kw), lambda i, j: (i, 0)),
            pl.BlockSpec((32 * kw, TW), lambda i, j: (0, j)),
            pl.BlockSpec((TR, TW), lambda i, j: (i, j)),
        ],
        out_specs=pl.BlockSpec((TR, TW), lambda i, j: (i, j)),
        input_output_aliases={3: 0},
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="rank_k_update_triton",
    )(w0a, s, pf, a)
