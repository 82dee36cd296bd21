"""Batch read-to-graph mapping.

Device-side replacement of ``BasicSequenceMapper``/``SequenceMapperNotifier``
(modules/alignment/sequence_mapper.hpp:288,
sequence_mapper_notifier.hpp:25-100): instead of an OpenMP loop handing
each read to listeners, ALL reads map at once — every read k-mer is
binary-searched in the edge k-mer index, giving per-k-mer
(oriented edge, implied read-start offset) votes; a per-read reduction
picks the winning alignment. Consumers (paired info, coverage, gap
closing) are plain array reductions over the result.

Conventions:
- oriented edge id = 2*edge + (0 if the read aligns to the edge's stored
  orientation else 1);
- ``start``: offset of read base 0 in the oriented edge's coordinates
  (may be negative if the read hangs off the edge start).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import dna, kmer, segments
from .index import EdgeKmerIndex


class ReadMapping(NamedTuple):
    """Per-read winning alignment (one (edge, start) per read)."""
    oriented_edge: jax.Array  # (R,) int32; 2*edge + rc-bit
    start: jax.Array          # (R,) int32 read-base-0 offset in oriented edge
    votes: jax.Array          # (R,) int32 supporting k-mer count
    mapped: jax.Array         # (R,) bool


@functools.partial(jax.jit, static_argnames=("k",))
def map_kmers(index: EdgeKmerIndex, codes: jax.Array, lengths: jax.Array,
              k: int):
    """Per-position mapping of every read k-mer.

    Returns (oriented_edge (R, P), start (R, P), found (R, P)).
    """
    kmers, valid = kmer.extract_kmers(codes, lengths, k)
    canon, read_fwd = dna.canonicalize_kmers(kmers, k)
    R, P, W = canon.shape
    flat = canon.reshape(-1, W)
    row = segments.searchsorted_rows(index.kmers, flat).reshape(R, P)
    found = (row < index.num) & valid
    safe = jnp.where(found, row, 0)
    edge = index.edge[safe]
    off = index.offset[safe]
    edge_fwd = index.is_fwd[safe]
    same = read_fwd == edge_fwd  # read orientation matches edge orientation

    # Edge length needed for rc-coordinate transform; fetch via index rows'
    # edge ids — callers pass the graph's seq_len through the closure-free
    # API below instead. Here we return raw (edge, off, same) parts.
    return edge, off, same, found


@jax.jit
def normalize_mapping(m: ReadMapping, conj: jax.Array) -> ReadMapping:
    """Rewrite rc-orientation hits (oid 2e+1) as forward hits on the
    conjugate edge (oid 2*conj[e]): the conjugate edge's sequence IS the
    reverse complement, so offsets carry over unchanged. After this, all
    oriented ids are even and pair-info/path-extension can key on plain
    edge ids."""
    e = m.oriented_edge // 2
    rc = (m.oriented_edge % 2) == 1
    safe_e = jnp.maximum(e, 0)
    e2 = jnp.where(rc, conj[safe_e], e)
    oe = jnp.where(m.oriented_edge >= 0, 2 * e2, -1)
    return m._replace(oriented_edge=oe)


@functools.partial(jax.jit, static_argnames=("k",))
def map_reads(index: EdgeKmerIndex, seq_len: jax.Array, codes: jax.Array,
              lengths: jax.Array, k: int) -> ReadMapping:
    """Winning (oriented edge, start) per read by k-mer majority vote."""
    edge, off, same, found = map_kmers(index, codes, lengths, k)
    R, P = found.shape
    pos = jnp.arange(P)[None, :]

    elen = seq_len[edge]
    # start of read base 0 in oriented-edge coordinates
    start_fwd = off - pos
    start_rc = (elen - index.k - off) - pos
    oedge = 2 * edge + jnp.where(same, 0, 1)
    start = jnp.where(same, start_fwd, start_rc)

    # majority vote per read over (oedge, start) pairs: sort rows of
    # (read, oedge, start) and take the longest run per read.
    read_id = jnp.broadcast_to(jnp.arange(R)[:, None], (R, P))
    keys = jnp.stack([
        read_id.reshape(-1).astype(jnp.uint32),
        oedge.reshape(-1).astype(jnp.uint32),
        (start.reshape(-1) + jnp.int32(1 << 20)).astype(jnp.uint32),
    ], axis=1)
    fvalid = found.reshape(-1)
    skeys, _, svalid = segments.sort_by_key_rows(keys, (), fvalid)
    uniq, counts, gid, num_unique = segments.unique_counts(skeys, svalid)

    # winner per read = unique row with max count
    N = uniq.shape[0]
    urow_read = uniq[:, 0].astype(jnp.int32)
    in_range = jnp.arange(N) < num_unique
    urow_read = jnp.where(in_range, urow_read, R)
    best = jnp.zeros((R,), jnp.int32).at[urow_read].max(
        counts.astype(jnp.int32), mode="drop")
    is_best = in_range & (counts == best[jnp.minimum(urow_read, R - 1)])
    # ambiguity: two distinct placements tie for best (reads fully inside
    # a repeat copy) — such reads must not feed paired info with a
    # spurious placement (the reference maps them as non-unique and its
    # weight counters ignore them)
    n_best = jnp.zeros((R,), jnp.int32).at[
        jnp.where(is_best, urow_read, R)].add(1, mode="drop")
    unambiguous = n_best <= 1
    # deterministic tie-break: first (lexicographically smallest) wins
    first_best = jnp.full((R,), N, jnp.int32).at[
        jnp.where(is_best, urow_read, R)].min(
        jnp.arange(N, dtype=jnp.int32), mode="drop")
    got = first_best < N
    fb = jnp.minimum(first_best, N - 1)
    oe = uniq[fb, 1].astype(jnp.int32)
    st = uniq[fb, 2].astype(jnp.int32) - (1 << 20)
    votes = jnp.where(got, best, 0)
    return ReadMapping(
        oriented_edge=jnp.where(got, oe, -1),
        start=jnp.where(got, st, 0),
        votes=votes,
        mapped=got & (votes > 0) & unambiguous,
    )


class ChainMapping(NamedTuple):
    """Per-read edge CHAIN: up to C placements ordered along the read.

    The multi-edge analogue of the reference's ``MappingPath``
    (sequence_mapper.hpp:288 MapRead().path()): a read spanning a
    junction contributes one placement per traversed edge, in read
    order. Alternatives (placements covering the SAME read range with
    tied votes — reads inside a repeat copy) mark the read ambiguous
    instead of producing a chain.
    """
    oriented_edge: jax.Array  # (R, C) int32; -1 past chain_len
    start: jax.Array          # (R, C) int32 read-base-0 offset
    votes: jax.Array          # (R, C) int32
    chain_len: jax.Array      # (R,) int32
    mapped: jax.Array         # (R,) bool (chain_len>0 and unambiguous)


@functools.partial(jax.jit, static_argnames=("k", "max_placements",
                                             "min_votes"))
def map_reads_multi(index: EdgeKmerIndex, seq_len: jax.Array,
                    codes: jax.Array, lengths: jax.Array, k: int,
                    max_placements: int = 4,
                    min_votes: int = 2) -> ChainMapping:
    """Chain mapping: group per-k-mer votes into placements, order them
    along the read, greedily keep non-overlapping ones.  Groups below
    ``min_votes`` supporting k-mers are noise (single shared k-mers near
    junctions) and are dropped."""
    C = max_placements
    S = 2 * max_placements  # candidate slots per read before the greedy
    edge, off, same, found = map_kmers(index, codes, lengths, k)
    R, P = found.shape
    pos = jnp.arange(P)[None, :]

    elen = seq_len[edge]
    start_fwd = off - pos
    start_rc = (elen - index.k - off) - pos
    oedge = 2 * edge + jnp.where(same, 0, 1)
    start = jnp.where(same, start_fwd, start_rc)

    read_id = jnp.broadcast_to(jnp.arange(R)[:, None], (R, P))
    keys = jnp.stack([
        read_id.reshape(-1).astype(jnp.uint32),
        oedge.reshape(-1).astype(jnp.uint32),
        (start.reshape(-1) + jnp.int32(1 << 20)).astype(jnp.uint32),
    ], axis=1)
    fvalid = found.reshape(-1)
    pos_flat = jnp.broadcast_to(pos, (R, P)).reshape(-1).astype(jnp.int32)
    skeys, (spos,), svalid = segments.sort_by_key_rows(
        keys, (pos_flat,), fvalid)

    # group reduce: (votes, min_p, max_p) per distinct (read, oe, start)
    N = skeys.shape[0]
    new = (~segments.rows_equal_prev(skeys)) & svalid
    gid = jnp.cumsum(new.astype(jnp.int32)) - 1
    gid_s = jnp.where(svalid, jnp.maximum(gid, 0), N)
    num_g = jnp.sum(new.astype(jnp.int32))
    g_votes = jnp.zeros((N,), jnp.int32).at[gid_s].add(1, mode="drop")
    g_minp = jnp.full((N,), jnp.int32(1 << 30)).at[gid_s].min(
        spos, mode="drop")
    g_maxp = jnp.full((N,), jnp.int32(-1)).at[gid_s].max(
        spos, mode="drop")
    take = jnp.where(new, gid, N)
    g_read = jnp.zeros((N,), jnp.uint32).at[take].max(
        skeys[:, 0], mode="drop")
    g_oe = jnp.zeros((N,), jnp.uint32).at[take].max(
        skeys[:, 1], mode="drop")
    g_start = jnp.zeros((N,), jnp.uint32).at[take].max(
        skeys[:, 2], mode="drop")

    in_g = (jnp.arange(N) < num_g) & (g_votes >= min_votes)
    # rank groups per read by votes (desc), tie-break by min_p then key
    rank_keys = jnp.stack([
        jnp.where(in_g, g_read, R),
        (jnp.int32(1 << 30) - g_votes).astype(jnp.uint32),
        g_minp.astype(jnp.uint32),
        g_oe,
    ], axis=1)
    rkeys, (perm2,), _ = segments.sort_by_key_rows(
        rank_keys, (jnp.arange(N, dtype=jnp.int32),), in_g)
    r_read = rkeys[:, 0].astype(jnp.int32)
    first_of_read = jnp.searchsorted(r_read, jnp.arange(R)).astype(
        jnp.int32)
    slot = jnp.arange(N, dtype=jnp.int32) - first_of_read[
        jnp.minimum(r_read, R - 1)]
    ok_slot = (r_read < R) & (slot < S)
    d_r = jnp.where(ok_slot, r_read, R)
    d_s = jnp.where(ok_slot, slot, 0)

    def scat(vals, fill):
        return jnp.full((R, S), fill, vals.dtype).at[d_r, d_s].set(
            vals, mode="drop")

    s_oe = scat(g_oe[perm2].astype(jnp.int32), jnp.int32(-1))
    s_start = scat(g_start[perm2].astype(jnp.int32) - (1 << 20),
                   jnp.int32(0))
    s_votes = scat(g_votes[perm2], jnp.int32(0))
    s_minp = scat(g_minp[perm2], jnp.int32(1 << 30))
    s_maxp = scat(g_maxp[perm2], jnp.int32(-1))

    # ambiguity: another slot ties the top votes while covering an
    # overlapping read range (repeat-interior alternatives)
    top_votes = s_votes[:, 0]
    overlaps0 = (s_minp <= s_maxp[:, :1]) & (s_maxp >= s_minp[:, :1])
    tie = (s_votes == top_votes[:, None]) & overlaps0
    tie = tie.at[:, 0].set(False)
    ambiguous = jnp.any(tie & (s_votes > 0), axis=1)

    # order candidate slots along the read, then greedy non-overlap
    order = jnp.argsort(jnp.where(s_votes > 0, s_minp, jnp.int32(1 << 30)),
                        axis=1)
    o_oe = jnp.take_along_axis(s_oe, order, 1)
    o_start = jnp.take_along_axis(s_start, order, 1)
    o_votes = jnp.take_along_axis(s_votes, order, 1)
    o_minp = jnp.take_along_axis(s_minp, order, 1)
    o_maxp = jnp.take_along_axis(s_maxp, order, 1)

    def greedy(oe_r, st_r, vo_r, mn_r, mx_r):
        def body(carry, x):
            n_taken, last_max = carry
            oe_i, st_i, vo_i, mn_i, mx_i = x
            ok = (vo_i > 0) & (mn_i > last_max) & (n_taken < C)
            out = (jnp.where(ok, oe_i, -1), jnp.where(ok, st_i, 0),
                   jnp.where(ok, vo_i, 0))
            carry2 = (n_taken + ok.astype(jnp.int32),
                      jnp.where(ok, mx_i, last_max))
            return carry2, out
        (n, _), (oes, sts, vos) = jax.lax.scan(
            body, (jnp.int32(0), jnp.int32(-1)),
            (oe_r, st_r, vo_r, mn_r, mx_r))
        return oes, sts, vos, n

    c_oe, c_start, c_votes, c_n = jax.vmap(greedy)(
        o_oe, o_start, o_votes, o_minp, o_maxp)

    # compact accepted entries (scattered across S slots) to the first C
    acc = c_oe >= 0
    dest = jnp.cumsum(acc.astype(jnp.int32), axis=1) - 1
    dest = jnp.where(acc & (dest < C), dest, C)
    rows = jnp.broadcast_to(jnp.arange(R)[:, None], (R, S))
    f_oe = jnp.full((R, C), jnp.int32(-1)).at[rows, dest].set(
        c_oe, mode="drop")
    f_start = jnp.zeros((R, C), jnp.int32).at[rows, dest].set(
        c_start, mode="drop")
    f_votes = jnp.zeros((R, C), jnp.int32).at[rows, dest].set(
        c_votes, mode="drop")

    return ChainMapping(
        oriented_edge=f_oe, start=f_start, votes=f_votes,
        chain_len=jnp.minimum(c_n, C),
        mapped=(c_n > 0) & ~ambiguous)


@jax.jit
def normalize_chain(m: ChainMapping, conj: jax.Array) -> ChainMapping:
    """normalize_mapping for chain arrays: rc hits become forward hits on
    the conjugate edge (offsets carry over unchanged)."""
    e = m.oriented_edge // 2
    rc = (m.oriented_edge % 2) == 1
    safe_e = jnp.maximum(e, 0)
    e2 = jnp.where(rc, conj[safe_e], e)
    oe = jnp.where(m.oriented_edge >= 0, 2 * e2, -1)
    return m._replace(oriented_edge=oe)
