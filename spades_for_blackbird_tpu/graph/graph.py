"""Condensed de Bruijn graph as flat arrays (the device "GraphCore").

Replaces the reference's pointer-based conjugate multigraph
(``GraphCore``/``PairedVertex``/``PairedEdge`` at
assembler/src/common/assembly_graph/core/graph_core.hpp:116-330) with a
relational edge table:

- every edge is a unitig with an explicit packed sequence (ragged rows in
  one flat code buffer),
- vertices are *oriented k-mer ids*: ``2*vidx + (0 if forward else 1)``
  where ``vidx`` indexes a sorted canonical k-mer table. The conjugate
  vertex of ``2v+s`` is ``2v+(1-s)``; the conjugate edge is stored
  explicitly (``conj`` column), mirroring the reference's conjugate_
  pointers.
- deletion is a boolean ``alive`` mask; compaction happens at
  re-condensation points instead of the reference's ActionHandler
  machinery (core/observable_graph.hpp:21).

All arrays are capacity-padded; ``num_edges`` rows are real.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import dna


@jax.tree_util.register_dataclass
@dataclass
class Graph:
    """Edge-table condensed graph (conjugate-paired).

    seq_flat: (FLAT_CAP,) uint8 base codes; edge e's sequence is
      ``seq_flat[seq_start[e] : seq_start[e] + seq_len[e]]``.
    seq_start: (E_CAP,) int32.
    seq_len: (E_CAP,) int32 — length in bases, >= k+1 for real edges.
    cov: (E_CAP,) float32 — average (k+1)-mer coverage of the edge
      (matches the reference's CoverageIndex semantics, core/coverage.hpp:28).
    start_v / end_v: (E_CAP,) int32 oriented vertex ids.
    conj: (E_CAP,) int32 conjugate edge id.
    alive: (E_CAP,) bool.
    num_edges: () int32.
    k: static metadata (overlap size between adjacent edges) — not a
      pytree leaf, so it stays a Python int through jit boundaries.
    """
    seq_flat: jax.Array
    seq_start: jax.Array
    seq_len: jax.Array
    cov: jax.Array
    start_v: jax.Array
    end_v: jax.Array
    conj: jax.Array
    alive: jax.Array
    num_edges: jax.Array
    k: int = field(metadata=dict(static=True))
    # average coverage of the first min(len-k, FLANKING_RANGE) (k+1)-mers
    # (the reference's FlankingCoverage::CoverageOfStart,
    # graph_support/detail_coverage.hpp:80; the end flank is the
    # conjugate's start flank). None when the graph source has no
    # per-position coverage (GFA input, synthetic graphs) — consumers
    # fall back to whole-edge coverage (RelativeAvgCovHelper,
    # relative_coverage_remover.hpp:167).
    flank: jax.Array | None = None

    @property
    def capacity(self) -> int:
        return self.seq_len.shape[0]

    def _replace(self, **kw) -> "Graph":
        return dataclasses.replace(self, **kw)


# config.info:180 flanking_range
FLANKING_RANGE = 55


def flank_start(g: Graph) -> jax.Array:
    """Local coverage at each edge's start (FlankingCoverage::
    CoverageOfStart); whole-edge coverage when flanks are absent."""
    return g.cov if g.flank is None else g.flank


def flank_end(g: Graph) -> jax.Array:
    """Local coverage at each edge's end = the conjugate's start flank
    (detail_coverage.hpp:86 CoverageOfEnd)."""
    return g.cov if g.flank is None else g.flank[g.conj]


def conj_vertex(v: jax.Array) -> jax.Array:
    return v ^ 1


def edge_mask(g: Graph) -> jax.Array:
    """Alive real edges."""
    return g.alive & (jnp.arange(g.capacity) < g.num_edges)


def slot_owner(seq_start: jax.Array, m: jax.Array,
               flat_cap: int) -> jax.Array:
    """Owning edge of every flat sequence slot: (FLAT,) int32, -1 where
    no alive edge's start precedes the slot.

    Relies on the layout invariant (alive edges' seq_start ascend with
    edge id): a dense-ranked start table + vectorized binary search
    (log2 E gather rounds, the same pattern as
    ops/segments.searchsorted_rows).
    """
    E = seq_start.shape[0]
    idx = jnp.arange(E, dtype=jnp.int32)
    rank = jnp.cumsum(m.astype(jnp.int32)) - 1
    dest = jnp.where(m, rank, E)
    dense_start = jnp.full((E,), flat_cap, jnp.int32).at[dest].set(
        jnp.where(m, seq_start, flat_cap), mode="drop")
    dense_edge = jnp.full((E,), -1, jnp.int32).at[dest].set(
        idx, mode="drop")
    slots = jnp.arange(flat_cap, dtype=jnp.int32)
    lo = jnp.zeros((flat_cap,), jnp.int32)
    hi = jnp.full((flat_cap,), E, jnp.int32)

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        right = dense_start[jnp.minimum(mid, E - 1)] <= slots
        return jnp.where(right, mid + 1, lo), jnp.where(right, hi, mid)

    lo, hi = jax.lax.fori_loop(0, max(1, E.bit_length()), body, (lo, hi))
    j = lo - 1
    return jnp.where(j >= 0, dense_edge[jnp.clip(j, 0, E - 1)], -1)


def degrees(g: Graph, v_space: int) -> tuple[jax.Array, jax.Array]:
    """(out_deg, in_deg) arrays of size v_space over alive edges."""
    m = edge_mask(g)
    one = m.astype(jnp.int32)
    out_deg = jnp.zeros((v_space,), jnp.int32).at[
        jnp.where(m, g.start_v, v_space)].add(one, mode="drop")
    in_deg = jnp.zeros((v_space,), jnp.int32).at[
        jnp.where(m, g.end_v, v_space)].add(one, mode="drop")
    return out_deg, in_deg


def compact_graph(g: Graph) -> tuple["Graph", int]:
    """Pack alive edges to the front and renumber vertices densely.

    Construction leaves the edge table at the (k+1)-mer table's padded
    capacity (graph/condense.py) — orders of magnitude above the unitig
    count — so every downstream pass would scatter into huge arrays and
    every jit graph would compile at those shapes.  Compaction (host-side,
    once per construction) trims capacities to power-of-two buckets so
    pass shapes are small AND stable across similar inputs.

    Conjugate pairing of vertices (v <-> v^1) is preserved by remapping
    vertex PAIRS.  Returns (graph, new_v_space).
    """
    import numpy as np
    import jax.numpy as jnp

    alive = np.asarray(edge_mask(g))
    ids = np.nonzero(alive)[0]
    n = len(ids)
    E2 = 1 << max(3, int(n - 1).bit_length() if n else 3)
    new_of = np.full(g.capacity, E2, np.int64)
    new_of[ids] = np.arange(n)

    start_v = np.asarray(g.start_v)[ids]
    end_v = np.asarray(g.end_v)[ids]
    conj = new_of[np.asarray(g.conj)[ids]]
    # dense vertex renumbering by conjugate pair
    bases = np.unique(np.concatenate([start_v, end_v]) // 2)
    base_rank = {int(b): i for i, b in enumerate(bases)}
    def remap_v(v):
        return np.asarray([2 * base_rank[int(x) // 2] + (int(x) & 1)
                           for x in v], np.int32)
    start_v = remap_v(start_v)
    end_v = remap_v(end_v)
    n_v = 2 * len(bases)
    v_space = 1 << max(3, int(max(n_v - 1, 1)).bit_length())

    lens = np.asarray(g.seq_len)[ids]
    flat = dna.pull_codes_packed(g.seq_flat)
    starts = np.asarray(g.seq_start)[ids]
    total = int(lens.sum())
    FLAT2 = 1 << max(4, int(max(total - 1, 1)).bit_length())
    new_flat = np.zeros(FLAT2, np.uint8)
    new_start = np.zeros(E2, np.int32)
    acc = 0
    for i in range(n):
        new_start[i] = acc
        new_flat[acc:acc + lens[i]] = flat[starts[i]:starts[i] + lens[i]]
        acc += int(lens[i])

    def padded(x, fill, dtype):
        out = np.full(E2, fill, dtype)
        out[:n] = x
        return out

    g2 = Graph(
        seq_flat=jnp.asarray(new_flat),
        seq_start=jnp.asarray(new_start),
        seq_len=jnp.asarray(padded(lens, 0, np.int32)),
        cov=jnp.asarray(padded(np.asarray(g.cov)[ids], 0.0, np.float32)),
        start_v=jnp.asarray(padded(start_v, 0, np.int32)),
        end_v=jnp.asarray(padded(end_v, 0, np.int32)),
        conj=jnp.asarray(padded(conj, 0, np.int32).astype(np.int32)),
        alive=jnp.asarray(np.arange(E2) < n),
        num_edges=jnp.int32(n),
        k=g.k,
        flank=(None if g.flank is None else jnp.asarray(
            padded(np.asarray(g.flank)[ids], 0.0, np.float32))))
    return g2, v_space


def edge_codes_host(g: Graph, e: int):
    """Host-side helper: edge sequence as a numpy code array."""
    import numpy as np
    start = int(g.seq_start[e])
    ln = int(g.seq_len[e])
    return np.asarray(g.seq_flat[start:start + ln])
