"""Mismatch correction: majority-vote polishing of graph edge sequences.

Device-side replacement of the reference's MismatchCorrection stage
(projects/spades/mismatch_correction.cpp:98-420 ``MismatchShallNotPass``,
run under --careful): map all reads onto the graph, accumulate per-base
votes over every edge position in one scatter-add, fold votes across
conjugate edge pairs (a read voting base b at position p of edge e also
witnesses complement(b) at the mirrored position of conj(e)), and rewrite
bases where the read majority disagrees. Folding keeps both strands
identical without a separate mirroring pass; strict-majority fixes are
tie-free and hence conjugate-symmetric.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.graph import Graph, edge_mask
from ..mapping import index as eidx
from ..mapping import mapper
from ..ops import dna


@jax.jit
def _vote(g: Graph, oe, start, mapped, codes, lengths):
    """Per-base votes (FLAT, 4) from one read chunk's mappings."""
    FLAT = g.seq_flat.shape[0]
    R, L = codes.shape
    e = jnp.maximum(oe // 2, 0)
    base_flat = g.seq_start[e]
    elen = g.seq_len[e]

    pos_in_read = jnp.arange(L)[None, :]
    epos = start[:, None] + pos_in_read                    # (R, L)
    in_read = pos_in_read < lengths[:, None]
    in_edge = (epos >= 0) & (epos < elen[:, None])
    ok = mapped[:, None] & in_read & in_edge & (codes < dna.INVALID_CODE)
    flat_pos = jnp.where(ok, base_flat[:, None] + epos, FLAT)

    return jnp.zeros((FLAT, 4), jnp.int32).at[
        flat_pos, codes.astype(jnp.int32)].add(1, mode="drop")


@jax.jit
def _fix(g: Graph, votes):
    FLAT = g.seq_flat.shape[0]
    E = g.capacity
    # conjugate fold: flat slot p of edge E maps to slot
    # seq_start[conj] + (len - 1 - pos_in_edge) with complemented bases.
    m = edge_mask(g)
    from ..graph.graph import slot_owner
    slot_edge = slot_owner(g.seq_start, m, FLAT)
    se = jnp.maximum(slot_edge, 0)
    pie = jnp.arange(FLAT) - g.seq_start[se]
    slot_ok = (slot_edge >= 0) & m[se] & (pie >= 0) & (pie < g.seq_len[se])
    conj_pos = g.seq_start[g.conj[se]] + (g.seq_len[se] - 1 - pie)
    conj_pos = jnp.where(slot_ok, conj_pos, FLAT)
    folded = votes + jnp.where(
        slot_ok[:, None],
        votes[jnp.minimum(conj_pos, FLAT - 1)][:, ::-1],
        0)

    total = jnp.sum(folded, axis=1)
    best = jnp.argmax(folded, axis=1).astype(jnp.uint8)
    vmax = jnp.max(folded, axis=1)
    fix = slot_ok & (vmax * 2 > total) & (total > 0) & (best != g.seq_flat)
    new_flat = jnp.where(fix, best, g.seq_flat)
    return new_flat, jnp.sum(fix.astype(jnp.int32))


def correct_mismatches(g: Graph, codes, lengths,
                       chunk: int = 1 << 16) -> tuple[Graph, int]:
    """One round of read-consensus polishing. Returns (graph, n_fixed).

    Chunked over reads: votes are additive, so each fixed-shape chunk
    maps and scatters its votes into the same (FLAT, 4) accumulator —
    the reference's OpenMP-parallel vote buffers
    (mismatch_correction.cpp:188 CountStatistics) become a chunk loop."""
    k = g.k
    idx = eidx.build_edge_index(g, k + 1)
    codes = jnp.asarray(codes)
    lengths = jnp.asarray(lengths)
    R = codes.shape[0]
    votes = None
    for lo in range(0, R, chunk):
        hi = min(lo + chunk, R)
        c, l = codes[lo:hi], lengths[lo:hi]
        if R > chunk and hi - lo < chunk:
            c = jnp.pad(c, ((0, chunk - (hi - lo)), (0, 0)))
            l = jnp.pad(l, (0, chunk - (hi - lo)))
        m = mapper.map_reads(idx, g.seq_len, c, l, k + 1)
        m = mapper.normalize_mapping(m, g.conj)
        v = _vote(g, m.oriented_edge, m.start, m.mapped, c, l)
        votes = v if votes is None else votes + v
    new_flat, n_fixed = _fix(g, votes)
    n = int(n_fixed)
    if n == 0:
        return g, 0
    return g._replace(seq_flat=new_flat), n
