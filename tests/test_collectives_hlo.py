"""Mechanical verification of the sharded solvers' communication claims
: compile on the 8-device CPU mesh, dump optimized HLO,
and count collective instructions.

The enforced invariants:

* tournament kernel (``rowshard_tournament.py``): exactly ONE all_gather
  round per panel — 2 all-gather instructions (the pytree gather of
  candidate rows + global ids, one round on the wire), both inside the SAME
  panel-loop body, and ZERO other collectives in the elimination;
* fused-origin tournament: the same, plus exactly 2 all-reduces in the
  mode-0 tail (psum'd origin + pmax'd unsat) OUTSIDE the panel loop;
* blocked row-sharded kernel (``rowshard_blocked.py``): exactly 2
  all-reduces per pivot (pmin election + psum row broadcast) and zero
  all-gathers.

A regression that silently adds a collective (doubling communication) now
fails here instead of passing every bit-exactness test.
"""

import re

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from gf2bv_tpu.parallel import mesh as meshlib
from gf2bv_tpu.parallel import rowshard_blocked as rb
from gf2bv_tpu.parallel import rowshard_tournament as rt

COLLECTIVE_OPS = (
    "all-gather",
    "all-gather-start",
    "all-reduce",
    "all-reduce-start",
    "reduce-scatter",
    "collective-permute",
    "collective-permute-start",
    "all-to-all",
)


def _mesh8():
    if jax.device_count() < 8:
        pytest.skip("needs 8 devices")
    return meshlib.make_mesh(batch=1, rows=8)


def _compiled_hlo(fn, mesh, rows=2048, wp=128):
    a32 = np.zeros((rows, wp), np.uint32)
    sh = NamedSharding(mesh, P(meshlib.ROWS_AXIS, None))
    return fn.lower(jax.device_put(a32, sh)).compile().as_text()


def _collective_lines(txt):
    """{op: [(computation_name, line)]} for every collective instruction."""
    found = {}
    comp = "?"
    for line in txt.splitlines():
        m = re.match(r"\s*(%?[\w./-]+)\s*(\([^)]*\))?\s*->?.*{\s*(//.*)?$", line)
        if ("{" in line) and ("= " not in line) and m:
            comp = m.group(1)
        for op in COLLECTIVE_OPS:
            if re.search(rf"= \S+ {op}\(", line):
                found.setdefault(op, []).append((comp, line.strip()))
    return found


def _counts(found):
    return {op: len(v) for op, v in found.items()}


def test_tournament_one_gather_round_per_panel_no_other_collectives():
    mesh = _mesh8()
    fn = rt._build(mesh, cols=192, k_panel=64)
    found = _collective_lines(_compiled_hlo(fn, mesh))
    counts = _counts(found)

    gathers = found.get("all-gather", []) + found.get("all-gather-start", [])
    # one gather ROUND: the pytree (pf, ids) all_gather is at most 2 HLO
    # instructions, and they must live in the same (panel-loop) computation
    assert 1 <= len(gathers) <= 2, counts
    assert len({c for c, _ in gathers}) == 1, gathers
    for op in COLLECTIVE_OPS:
        if op.startswith("all-gather"):
            continue
        assert counts.get(op, 0) == 0, (op, counts)


def test_tournament_fused_origin_adds_only_the_two_tail_reduces():
    mesh = _mesh8()
    fn = rt._build(mesh, cols=192, k_panel=64, fused_origin=True)
    found = _collective_lines(_compiled_hlo(fn, mesh))
    counts = _counts(found)

    gathers = found.get("all-gather", []) + found.get("all-gather-start", [])
    assert 1 <= len(gathers) <= 2, counts
    gather_comp = {c for c, _ in gathers}
    assert len(gather_comp) == 1, gathers

    reduces = found.get("all-reduce", []) + found.get("all-reduce-start", [])
    # psum'd origin + pmax'd unsat: <= 2 instructions (XLA may combine),
    # and NOT inside the panel loop (they are the mode-0 tail)
    assert 1 <= len(reduces) <= 2, counts
    assert all(c not in gather_comp for c, _ in reduces), (
        "tail reduces leaked into the panel loop",
        reduces,
    )
    assert counts.get("collective-permute", 0) == 0
    assert counts.get("reduce-scatter", 0) == 0


def test_blocked_two_reduces_per_pivot_no_gathers():
    mesh = _mesh8()
    fn = rb._build(mesh, cols=192, k_panel=64)
    found = _collective_lines(_compiled_hlo(fn, mesh))
    counts = _counts(found)

    reduces = found.get("all-reduce", []) + found.get("all-reduce-start", [])
    # pmin election + psum pivot-row broadcast, both in the pivot loop body
    assert len(reduces) == 2, counts
    assert len({c for c, _ in reduces}) == 1, reduces
    for op in COLLECTIVE_OPS:
        if op.startswith("all-reduce"):
            continue
        assert counts.get(op, 0) == 0, (op, counts)


# --------------------------------------------------------------------------
# Communication VOLUME: the count checks above would
# still pass if a layout regression gathered full local row-blocks instead
# of the K candidate rows — per-panel wire bytes would silently inflate
# (rloc/K)x and SCALING.md's latency model would be wrong.  Parse the
# result shapes of every collective and pin them to the documented model:
# tournament = K*wp words + K ids per panel, blocked = wp words + one
# scalar per pivot.
# --------------------------------------------------------------------------

_SHAPE_RE = re.compile(r"= (?:\()?([a-z]+\d+)\[([\d,]*)\]")


def _result_shape(line):
    """(dtype, dims tuple) of a collective instruction's (first) result."""
    m = _SHAPE_RE.search(line)
    assert m, line
    dims = tuple(int(d) for d in m.group(2).split(",") if d)
    return m.group(1), dims


def test_tournament_gather_volume_is_candidates_not_rows():
    mesh = _mesh8()
    naxis, K, wp, rows = 8, 64, 128, 2048
    fn = rt._build(mesh, cols=192, k_panel=K)
    found = _collective_lines(_compiled_hlo(fn, mesh, rows=rows, wp=wp))
    gathers = found.get("all-gather", []) + found.get("all-gather-start", [])
    shapes = sorted(_result_shape(line) for _, line in gathers)
    # gathered result = stacked candidates (naxis, K, wp) + ids (naxis, K):
    # per-shard contribution K*wp words + K ids per panel — NOT the local
    # (rows/naxis, wp) block
    assert shapes == [("s32", (naxis, K)), ("u32", (naxis, K, wp))], shapes
    words_per_panel = K * wp + K
    full_block_words = (rows // naxis) * wp
    assert words_per_panel < full_block_words  # the regression headroom


def test_blocked_reduce_volume_is_one_row_per_pivot():
    mesh = _mesh8()
    wp = 128
    fn = rb._build(mesh, cols=192, k_panel=64)
    found = _collective_lines(_compiled_hlo(fn, mesh, wp=wp))
    reduces = found.get("all-reduce", []) + found.get("all-reduce-start", [])
    shapes = sorted(_result_shape(line) for _, line in reduces)
    # pmin election (scalar) + psum pivot-row broadcast (wp words)
    assert shapes == [("s32", ()), ("u32", (wp,))], shapes


def test_tournament_rounds_independent_of_mesh_size():
    """Weak-scaling invariant: collective ROUNDS per solve depend only on
    the panel count (wp/kw), not on the number of shards — growing the
    mesh must not add gather rounds."""
    if jax.device_count() < 8:
        pytest.skip("needs 8 devices")
    counts = {}
    for n in (4, 8):
        mesh = meshlib.make_mesh(
            batch=1, rows=n, devices=jax.devices()[:n]
        )
        fn = rt._build(mesh, cols=192, k_panel=64)
        found = _collective_lines(_compiled_hlo(fn, mesh))
        counts[n] = len(
            found.get("all-gather", []) + found.get("all-gather-start", [])
        )
    assert counts[4] == counts[8], counts


def test_tournament_pivot_ownership_spreads_across_shards():
    """Load-balance check on a random near-square system: with cols close
    to rows, pivot ownership must reach every shard (min-index election
    saturates early shards first, but none may be starved and the total
    must equal the rank)."""
    mesh = _mesh8()
    rows, cols, naxis = 2048, 2000, 8
    rng = np.random.default_rng(5)
    from gf2bv_tpu.core import packing

    bits = rng.integers(0, 2, size=(rows, 1 + cols)).astype(np.uint8)
    eqs = packing.pack_bits(bits, 1 + cols)
    a32 = packing.pad2d(
        packing.to_u32(eqs), row_align=256 * naxis, word_align=128
    )
    _, pof = jax.device_get(
        rt.rref_rowsharded_tournament(a32, cols, mesh, k_panel=64)
    )
    pof = np.asarray(pof)
    owners = pof[pof >= 0] // (a32.shape[0] // naxis)
    per_shard = np.bincount(owners, minlength=naxis)
    rank = int((pof >= 0).sum())
    assert rank >= cols - 16  # random system: essentially full rank
    assert per_shard.sum() == rank
    # every shard owns a healthy share (256-cap forces spread; 200 is just
    # under the mathematical floor cols - 7*256 = 208 at full rank)
    assert per_shard.min() >= 200, per_shard.tolist()
