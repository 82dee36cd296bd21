"""Edge k-mer index: canonical k-mer -> (edge, offset, strand).

Device-side replacement for the reference's edge-position index
(assembly_graph/index/edge_position_index.hpp ``KmerStoringEdgeIndex`` +
the graph-attached ``EdgeIndex`` handler, modules/alignment/edge_index.hpp:29):
a sorted multi-word-key array over all k-mers of all alive edges, looked up
by binary search instead of a perfect-hash map.

The index stores each *canonical* k-mer once per occurrence with its edge
id, offset (position of the k-mer's first base within the edge sequence),
and whether the canonical orientation matches the edge's orientation.
K-mers occurring in several edges (junction overlaps, repeats beyond
simplification) keep multiple rows; lookup returns the first row of the
run and a count.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..graph.graph import Graph, edge_mask
from ..ops import dna, kmer, segments


class EdgeKmerIndex(NamedTuple):
    kmers: jax.Array    # (N, W) sorted canonical k-mers (all-ones padding)
    edge: jax.Array     # (N,) int32 edge id
    offset: jax.Array   # (N,) int32 first-base offset within edge sequence
    is_fwd: jax.Array   # (N,) bool canonical orientation == edge orientation
    num: jax.Array      # () int32
    k: int

    @property
    def capacity(self) -> int:
        return self.kmers.shape[0]


@functools.partial(jax.jit, static_argnames=("k",))
def build_edge_index(g: Graph, k: int) -> EdgeKmerIndex:
    """Index every k-mer of every alive edge (edge_index_refiller.cpp)."""
    FLAT = g.seq_flat.shape[0]
    E = g.capacity
    m = edge_mask(g)

    # ownership of each flat slot (scan-free binary search over the
    # id-order == position-order layout invariant; graph.py slot_owner)
    from ..graph.graph import slot_owner
    slot_edge = slot_owner(g.seq_start, m, FLAT)
    se = jnp.maximum(slot_edge, 0)
    pos_in_edge = jnp.arange(FLAT) - g.seq_start[se]
    # a k-mer starting at this slot stays within its edge
    valid = (slot_edge >= 0) & m[se] & (pos_in_edge >= 0) & \
        (pos_in_edge + k <= g.seq_len[se])

    flat_codes = g.seq_flat[None, :]  # (1, FLAT) as one giant read
    kmers, kvalid = kmer.extract_kmers(
        flat_codes, jnp.array([FLAT], jnp.int32), k)
    kmers = kmers[0]                    # (FLAT - k + 1, W)
    kvalid = kvalid[0] & valid[:FLAT - k + 1]
    canon, is_fwd = dna.canonicalize_kmers(kmers, k)

    payload_edge = se[:FLAT - k + 1]
    payload_off = pos_in_edge[:FLAT - k + 1]
    skeys, (sedge, soff, sfwd), svalid = segments.sort_by_key_rows(
        canon, (payload_edge, payload_off, is_fwd), kvalid)
    num = jnp.sum(svalid.astype(jnp.int32))
    pad = ~svalid
    skeys = jnp.where(pad[:, None], jnp.uint32(0xFFFFFFFF), skeys)
    return EdgeKmerIndex(skeys, sedge, soff, sfwd, num, k)


def lookup_kmers(index: EdgeKmerIndex, queries: jax.Array
                 ) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Find canonical query k-mers (M, W).

    Returns (row (M,), found (M,), edge (M,), offset (M,)) using the first
    matching row (unique-mapping k-mers have exactly one).
    """
    row = segments.searchsorted_rows(index.kmers, queries)
    found = row < index.num
    safe = jnp.where(found, row, 0)
    return row, found, index.edge[safe], index.offset[safe]
