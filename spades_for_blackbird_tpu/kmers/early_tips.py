"""Pre-graph early tip clipping on the (k+1)-mer table.

Counterpart of the reference's EarlyTipClipperProcessor
(assembly_graph/construction/early_simplification.hpp:37-160), which
clips tips directly on the extension index BEFORE the graph exists so
the error-laden k-mer table shrinks before graph capacity is committed
(Construction's EarlyTipClipper phase, stages/construction.cpp:292-318;
length bound defaults to RL - K).

Device-side formulation: instead of per-junction walks under OpenMP, the
whole (k+1)-mer multiset contracts into unique-in/unique-out chains by
pointer jumping (the same machinery graph condensation uses,
graph/pointer_jump.py), then every chain is classified at once:

- a *branch* is a chain whose first (k+1)-mer hangs off a junction
  vertex (out-degree >= 2), grouped by the oriented junction id;
- a branch is a *tip* iff its terminal (k+1)-mer dead-ends (no outgoing
  extension, unique incoming) within the length bound
  (FindForward, early_simplification.hpp:108-119);
- per junction, tips strictly shorter than the longest branch are
  removed (non-tip branches count as infinite; RemoveTips/RemoveForward,
  early_simplification.hpp:121-150).

Removal happens at the (k+1)-mer row level; the caller rebuilds the
vertex table from the filtered table, which subsumes the reference's
RemoveInconsistentForwardLinks phantom-link cleanup.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..graph import pointer_jump
from ..ops import dna, segments
from . import extension
from .counter import KmerTable


@functools.partial(jax.jit, static_argnames=("k",))
def _tip_kill_mask(kp1_table: KmerTable, vt: extension.VertexTable,
                   k: int, length_bound: jax.Array) -> jax.Array:
    """Per-row kill mask over the (k+1)-mer table."""
    E = kp1_table.capacity
    O = 2 * E
    NONE = jnp.int32(O)

    e_valid = jnp.arange(E) < kp1_table.num
    fwd = kp1_table.kmers
    rev = dna.revcomp_kmers(fwd, k + 1)
    half = jnp.arange(O) // 2
    odd = (jnp.arange(O) % 2) == 1
    ori = jnp.where(odd[:, None], rev[half], fwd[half])
    ovalid = jnp.repeat(e_valid, 2)
    pal = jnp.repeat(jnp.all(fwd == rev, axis=1), 2)
    ovalid = ovalid & ~(pal & odd)

    suffix = dna.drop_first_bases(ori, 1, k + 1)
    prefix = dna.truncate_bases(ori, k + 1, k)

    # suffix-vertex degrees (looking forward out of this instance)
    csuf, sfwd = dna.canonicalize_kmers(suffix, k)
    vidx = segments.searchsorted_rows(vt.kmers, csuf)
    omask = extension.oriented_out_mask(vt, vidx, sfwd)
    imask = extension.oriented_in_mask(vt, vidx, sfwd)
    od = extension.popcount4(omask)
    idg = extension.popcount4(imask)

    # successor link (same rule as graph condensation: the junction
    # between an instance and its follower must be 1-in/1-out)
    link = (od == 1) & (idg == 1) & ovalid
    out_base = jnp.int32(jnp.argmax(
        jnp.stack([(omask >> c) & 1 for c in range(4)], 1), axis=1))
    nxt_kp1 = dna.append_base(suffix, k, jnp.maximum(out_base, 0))
    cn, nfwd = dna.canonicalize_kmers(nxt_kp1, k + 1)
    j2 = segments.searchsorted_rows(kp1_table.kmers, cn)
    link = link & (j2 < kp1_table.num)
    succ = jnp.where(link, 2 * j2 + (1 - nfwd.astype(jnp.int32)), NONE)
    succ = jnp.where(succ == jnp.arange(O), NONE, succ)

    conj_o = jnp.arange(O, dtype=jnp.int32) ^ 1
    chains = pointer_jump.contract_chains(succ, conj_o, ovalid)
    rep, off, is_start = chains.rep, chains.off, chains.is_start
    rep_safe = jnp.where(ovalid, rep, O)

    # chain length + terminal classification (FindForward's stop node)
    chain_len = jnp.zeros((O,), jnp.int32).at[rep_safe].max(off + 1,
                                                            mode="drop")
    is_last = ovalid & (succ == NONE)
    # dead-end terminal: no outgoing extension past the last (k+1)-mer,
    # unique incoming (early_simplification.hpp:115-118)
    tip_end = is_last & (od == 0) & (idg == 1)
    chain_tip_end = jnp.zeros((O,), bool).at[
        jnp.where(tip_end, rep, O)].max(True, mode="drop")

    # prefix junction vertex of each chain start
    cpre, pfwd = dna.canonicalize_kmers(prefix, k)
    pvidx = segments.searchsorted_rows(vt.kmers, cpre)
    p_omask = extension.oriented_out_mask(vt, pvidx, pfwd)
    p_out_deg = extension.popcount4(p_omask)
    ov_start = 2 * pvidx + (1 - pfwd.astype(jnp.int32))
    at_junction = is_start & (p_out_deg >= 2)

    clen = chain_len[jnp.minimum(rep, O - 1)]
    is_tip = chain_tip_end[jnp.minimum(rep, O - 1)] & \
        (clen <= length_bound)

    # per-junction longest branch; non-tip branches count as infinite
    INF = jnp.int32(1 << 30)
    branch_val = jnp.where(is_tip, clen, INF)
    VSP = 2 * vt.capacity
    grp = jnp.where(at_junction, jnp.minimum(ov_start, VSP - 1), VSP)
    grp_max = jnp.zeros((VSP + 1,), jnp.int32).at[grp].max(
        branch_val, mode="drop")
    remove_branch = at_junction & is_tip & \
        (clen < grp_max[jnp.minimum(grp, VSP)])

    # kill every member of a removed chain, at the kp1-row level
    chain_killed = jnp.zeros((O,), bool).at[
        jnp.where(remove_branch, rep, O)].max(True, mode="drop")
    o_kill = ovalid & chain_killed[jnp.minimum(rep, O - 1)]
    row_kill = o_kill[0::2] | o_kill[1::2]
    return row_kill


def clip_early_tips(kp1_table: KmerTable, vt: extension.VertexTable,
                    k: int, length_bound: int
                    ) -> tuple[KmerTable, int]:
    """Remove tip (k+1)-mers; returns (filtered table, rows removed).
    The caller must rebuild the vertex table from the filtered table."""
    from . import counter
    kill = _tip_kill_mask(kp1_table, vt, k,
                          jnp.int32(max(length_bound, 1)))
    n = int(jnp.sum(kill & (jnp.arange(kp1_table.capacity)
                            < kp1_table.num)))
    if n == 0:
        return kp1_table, 0
    keep = ~kill & (jnp.arange(kp1_table.capacity) < kp1_table.num)
    num, (kmers, counts) = segments.compact(
        keep, kp1_table.kmers, kp1_table.counts)
    pad = jnp.arange(kp1_table.capacity) >= num
    kmers = jnp.where(pad[:, None], jnp.uint32(0xFFFFFFFF), kmers)
    return KmerTable(kmers, counts, num), n
