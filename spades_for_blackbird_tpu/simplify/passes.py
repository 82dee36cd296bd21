"""Batch simplification passes: tips, parallel bulges, erroneous connections.

Device-side equivalents of the reference's simplification algorithms
(assembler/src/common/modules/simplification/tip_clipper.hpp:21-277,
bulge_remover.hpp, erroneous_connection_remover.hpp), restructured from
sequential smart-iterator mutation to whole-graph masked passes:

- every pass computes a deletion mask over the edge table in one jit
  region (all candidates evaluated against the *same* graph snapshot),
- conjugate edges are always deleted together (the reference mirrors
  mutations through conjugate pointers),
- chains re-contract afterwards via recondense().

The batch-parallel semantics deviate from the reference's re-queue-on-event
sequential order; iterating pass+recondense to a fixed point recovers the
same cleaning power (SURVEY.md §7 step 4).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..graph.graph import Graph, edge_mask
from ..ops import segments


def _delete(g: Graph, kill: jax.Array) -> Graph:
    """Kill edges and their conjugates."""
    kill = kill | jnp.zeros_like(kill).at[g.conj].max(kill, mode="drop")
    return g._replace(alive=g.alive & ~kill)


def _vertex_tables(g: Graph, v_space: int):
    m = edge_mask(g)
    one = m.astype(jnp.int32)
    vs = jnp.where(m, g.start_v, v_space)
    ve = jnp.where(m, g.end_v, v_space)
    out_deg = jnp.zeros((v_space,), jnp.int32).at[vs].add(one, mode="drop")
    in_deg = jnp.zeros((v_space,), jnp.int32).at[ve].add(one, mode="drop")
    # max coverage among edges leaving / entering each vertex
    out_maxcov = jnp.zeros((v_space,), jnp.float32).at[vs].max(
        jnp.where(m, g.cov, 0.0), mode="drop")
    in_maxcov = jnp.zeros((v_space,), jnp.float32).at[ve].max(
        jnp.where(m, g.cov, 0.0), mode="drop")
    return m, out_deg, in_deg, out_maxcov, in_maxcov


def _seg_max_excl_self(cov: jax.Array, seg: jax.Array,
                       contributing: jax.Array, v_space: int
                       ) -> jax.Array:
    """Per-edge max of ``cov`` over its segment EXCLUDING the edge itself.

    ``seg[e]`` is the segment (vertex) the edge belongs to; only
    ``contributing`` edges count as competitors.  Implements the
    reference's MaxCompetitorCoverage exclusion (tip_clipper.hpp:29-40)
    without a per-edge loop: segment max + segment runner-up + a count of
    max-attaining edges decide each edge's exclusive max.
    """
    segs = jnp.where(contributing, seg, v_space)
    vmax = jnp.full((v_space,), -1.0, jnp.float32).at[segs].max(
        cov, mode="drop")
    seg_c = jnp.minimum(seg, v_space - 1)
    at_max = contributing & (cov >= vmax[seg_c])
    cnt = jnp.zeros((v_space,), jnp.int32).at[
        jnp.where(at_max, seg, v_space)].add(1, mode="drop")
    vmax2 = jnp.zeros((v_space,), jnp.float32).at[
        jnp.where(contributing & ~at_max, seg, v_space)].max(
        cov, mode="drop")
    alone_at_max = at_max & (cnt[seg_c] == 1)
    return jnp.where(alone_at_max, vmax2[seg_c],
                     jnp.maximum(vmax[seg_c], 0.0))


@functools.partial(jax.jit, static_argnames=("v_space",))
def clip_tips(g: Graph, v_space: int, length_bound: jax.Array,
              coverage_bound: jax.Array,
              relative_coverage: jax.Array,
              require: jax.Array | None = None) -> Graph:
    """Remove short dead-end edges (tip_clipper.hpp:71 TipCondition +
    RelativeCoverageTipCondition:21), reference-exact:

    - forward tip: end vertex has in+out degree == 1 (IsTip), and
      out_deg(start) + in_deg(end) > 2 (an alternative exists);
      backward tips are handled by the conjugate edge;
    - length (in k-mers, the reference's g.length()) <= length_bound;
    - cov <= coverage_bound;
    - cov <= relative_coverage * (max competitor coverage + 1), where
      competitors are the OTHER out-edges of start and in-edges of end,
      loops excluded (MaxCompetitorCoverage, tip_clipper.hpp:29-55).
    """
    m, out_deg, in_deg, _, _ = _vertex_tables(g, v_space)
    vss = jnp.minimum(g.start_v, v_space - 1)
    ves = jnp.minimum(g.end_v, v_space - 1)

    dead_end = (out_deg[ves] == 0) & (in_deg[ves] == 1)
    has_alt = (out_deg[vss] + in_deg[ves]) > 2
    contributing = m & (g.start_v != g.end_v)
    comp_out = _seg_max_excl_self(g.cov, g.start_v, contributing, v_space)
    comp_in = _seg_max_excl_self(g.cov, g.end_v, contributing, v_space)
    competitor = jnp.maximum(comp_out, comp_in)
    len_kmers = g.seq_len - g.k
    kill = m & dead_end & has_alt & \
        (len_kmers <= length_bound) & (g.cov <= coverage_bound) & \
        (g.cov <= relative_coverage * (competitor + 1.0))
    if require is not None:
        # extra conjunct (e.g. the rna mmm mismatch-tip condition)
        kill = kill & require
    return _delete(g, kill)


@functools.partial(jax.jit, static_argnames=("v_space",))
def remove_isolated(g: Graph, v_space: int, max_length: jax.Array,
                    max_coverage: jax.Array) -> Graph:
    """Drop isolated edges (both endpoints bare), ala the reference's
    isolated edge remover (graph_simplification.hpp IsolatedEdgeRemover)."""
    m, out_deg, in_deg, _, _ = _vertex_tables(g, v_space)
    vss = jnp.minimum(g.start_v, v_space - 1)
    ves = jnp.minimum(g.end_v, v_space - 1)
    isolated = (in_deg[vss] == 0) & (out_deg[vss] == 1) & \
        (out_deg[ves] == 0) & (in_deg[ves] == 1)
    kill = m & isolated & (g.seq_len - g.k <= max_length) & \
        (g.cov <= max_coverage)
    return _delete(g, kill)


def remove_bulges(g: Graph, v_space: int, max_length: jax.Array,
                  max_relative_delta: jax.Array,
                  max_coverage: jax.Array,
                  protected: jax.Array | None = None) -> Graph:
    """Remove parallel simple bulges; ``protected`` edges (the blackbird
    fork's restricted edge set, stages/simplification.cpp:200-212
    bulge_callback) are never glued away."""
    if protected is None:
        protected = jnp.zeros((g.capacity,), bool)
    return _remove_bulges(g, v_space, max_length, max_relative_delta,
                          max_coverage, protected)


@functools.partial(jax.jit, static_argnames=("v_space",))
def _remove_bulges(g: Graph, v_space: int, max_length: jax.Array,
                   max_relative_delta: jax.Array,
                   max_coverage: jax.Array,
                   protected: jax.Array) -> Graph:
    """Remove parallel simple bulges (bulge_remover.hpp:200
    AlternativesAnalyzer, restricted to single-edge alternatives —
    multi-edge alternatives re-appear as parallel edges after chains
    re-contract, so iterating this pass + recondense covers them).

    Among alive edges sharing (start_v, end_v), keep the strongest by
    (coverage, then length, then min id) and delete the rest when they are
    short (<= max_length), similar in length (within max_relative_delta *
    length of the kept edge) and below max_coverage. The removed coverage
    is projected onto the kept edge (BulgeGluer's coverage projection,
    bulge_remover.hpp:108).
    """
    E = g.capacity
    m = edge_mask(g)
    # group by (start_v, end_v) via sort
    key = jnp.stack([g.start_v.astype(jnp.uint32),
                     g.end_v.astype(jnp.uint32)], axis=1)
    skeys, (perm,), svalid = segments.sort_by_key_rows(
        key, (jnp.arange(E, dtype=jnp.int32),), m)
    same = segments.rows_equal_prev(skeys) & svalid
    gid = jnp.cumsum((~same).astype(jnp.int32)) - 1  # group id per sorted row

    cov_p = g.cov[perm]
    len_p = g.seq_len[perm]
    # strongest edge per group: max coverage, ties broken by the
    # conjugate-invariant id min(e, conj(e)) so that a bulge group and its
    # mirror group (conjugate edges) always elect conjugate winners.
    cid_p = jnp.minimum(perm, g.conj[perm])
    gid_safe = jnp.where(svalid, gid, E)
    best_cov = jnp.full((E,), -jnp.inf, jnp.float32).at[gid_safe].max(
        jnp.where(svalid, cov_p, -jnp.inf), mode="drop")
    is_cand = svalid & (cov_p == best_cov[jnp.minimum(gid, E - 1)])
    best_cid = jnp.full((E,), E, jnp.int32).at[
        jnp.where(is_cand, gid, E)].min(cid_p, mode="drop")
    is_best = is_cand & (cid_p == best_cid[jnp.minimum(gid, E - 1)])
    best_len = jnp.zeros((E,), jnp.int32).at[
        jnp.where(is_best, gid, E)].max(len_p, mode="drop")
    best_edge = jnp.zeros((E,), jnp.int32).at[
        jnp.where(is_best, gid, E)].max(perm, mode="drop")

    blen = best_len[jnp.minimum(gid, E - 1)]
    # delta = max(max_delta=3, rel_delta * len) (CountMaxDifference,
    # bulge_remover.hpp:103); lengths in k-mers like the reference
    delta = jnp.maximum(
        max_relative_delta * (len_p - g.k).astype(jnp.float32), 3.0)
    kill_p = svalid & ~is_best & ~protected[perm] & \
        (len_p - g.k <= max_length) & (cov_p <= max_coverage) & \
        (jnp.abs(len_p - blen).astype(jnp.float32) <= delta)

    # scatter kill + coverage projection back to edge order
    kill = jnp.zeros((E,), bool).at[jnp.where(kill_p, perm, E)].max(
        True, mode="drop")
    proj_tgt = best_edge[jnp.minimum(gid, E - 1)]
    add_cov = jnp.zeros((E,), jnp.float32).at[
        jnp.where(kill_p, proj_tgt, E)].add(cov_p, mode="drop")
    g = g._replace(cov=g.cov + add_cov)
    return _delete(g, kill)


@functools.partial(jax.jit, static_argnames=("v_space",))
def remove_relative_low_coverage(g: Graph, v_space: int,
                                 coverage_gap: jax.Array,
                                 max_length: jax.Array) -> Graph:
    """Relative-coverage erroneous connection/component removal
    (modules/simplification/relative_coverage_remover.hpp, enabled by
    meta's rcc block): short edges whose coverage is ``coverage_gap``
    times below the strongest flanking edges on BOTH sides are chimeric
    inter-species connections and get dropped.
    """
    m, out_deg, in_deg, out_maxcov, in_maxcov = _vertex_tables(g, v_space)
    vss = jnp.minimum(g.start_v, v_space - 1)
    ves = jnp.minimum(g.end_v, v_space - 1)
    # strongest alternative at the start junction (edges INTO start_v or
    # OTHER edges out of it — the candidate itself must not compete,
    # relative_coverage_remover.hpp:220 RelativeCoverageHelper) and
    # symmetric at the end junction
    out_excl = _seg_max_excl_self(g.cov, g.start_v, m, v_space)
    in_excl = _seg_max_excl_self(g.cov, g.end_v, m, v_space)
    start_flank = jnp.maximum(in_maxcov[vss], out_excl)
    end_flank = jnp.maximum(out_maxcov[ves], in_excl)
    kill = m & (g.seq_len <= max_length) & \
        (g.cov * coverage_gap < start_flank) & \
        (g.cov * coverage_gap < end_flank)
    return _delete(g, kill)


@functools.partial(jax.jit, static_argnames=("v_space",))
def remove_erroneous_connections(g: Graph, v_space: int,
                                 max_length: jax.Array,
                                 coverage_threshold: jax.Array) -> Graph:
    """Remove short low-coverage edges whose removal keeps the graph flow
    intact (erroneous_connection_remover.hpp; "alternatively checked"
    condition = both junctions retain alternatives)."""
    m, out_deg, in_deg, _, _ = _vertex_tables(g, v_space)
    vss = jnp.minimum(g.start_v, v_space - 1)
    ves = jnp.minimum(g.end_v, v_space - 1)
    keeps_flow = (out_deg[vss] > 1) & (in_deg[ves] > 1)
    kill = m & keeps_flow & (g.seq_len - g.k <= max_length) & \
        (g.cov < coverage_threshold)
    return _delete(g, kill)
