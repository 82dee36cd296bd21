"""Unitig condensation by pointer jumping over oriented (k+1)-mer edges.

Device-side replacement for the reference's serial unitig extraction
(``UnbranchingPathExtractor::ExtractUnbranchingPaths`` at
assembler/src/common/assembly_graph/construction/
debruijn_graph_constructor.hpp:182-388, loop recovery at :306-345, and
``FastGraphFromSequencesConstructor``'s junction linking at :390-520).

Instead of walking each unbranching path with a thread-local cursor, we
build the successor array of the oriented (k+1)-mer edge graph and contract
every chain in O(log N) gather rounds (prefix doubling):

1. every unique (k+1)-mer yields two oriented edge instances (forward id
   ``2j``, reverse-complement ``2j+1``);
2. an oriented edge links to its unique follower iff the k-mer vertex
   between them has in-degree == out-degree == 1 (checked via the
   extension-mask vertex table);
3. cycles (the reference's RecoverCircularLoops) are detected by
   reachability doubling and broken deterministically at their
   minimum-index edge;
4. chains contract by pred-pointer doubling, giving each oriented edge its
   unitig id and offset; sequences, coverage, endpoints and conjugate
   pairing all fall out of segmented scatters.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..kmers.counter import KmerTable
from ..kmers import extension
from ..ops import dna, segments
from . import pointer_jump
from .graph import FLANKING_RANGE, Graph


def _single_bit_index(mask: jax.Array) -> jax.Array:
    """mask in {1,2,4,8} -> bit index 0..3 (undefined otherwise)."""
    m = mask.astype(jnp.int32)
    return (m == 2) + 2 * (m == 4) + 3 * (m == 8)


@functools.partial(jax.jit, static_argnames=("k",))
def build_graph(kp1_table: KmerTable, vt: extension.VertexTable, k: int
                ) -> Graph:
    """Condense the (k+1)-mer multiset into a conjugate-paired unitig graph."""
    E = kp1_table.capacity
    O = 2 * E  # oriented edge instances
    W1 = kp1_table.kmers.shape[1]
    NONE = jnp.int32(O)

    e_valid = jnp.arange(E) < kp1_table.num
    fwd = kp1_table.kmers
    rev = dna.revcomp_kmers(fwd, k + 1)
    # interleave rows 2j=fwd[j], 2j+1=rev[j]: two gathers + select
    half = jnp.arange(O) // 2
    odd = (jnp.arange(O) % 2) == 1
    ori = jnp.where(odd[:, None], rev[half], fwd[half])  # 2j / 2j+1
    ovalid = jnp.repeat(e_valid, 2)
    # Palindromic (k+1)-mers (possible since k+1 is even) are self-reverse-
    # complement: both oriented instances are the same edge, which would
    # break successor injectivity. Collapse to the forward instance; such
    # edges only occur at the center of self-conjugate unitigs (any
    # neighbor pair (Y -> s -> Z) of a palindrome s satisfies Z = rc(Y)),
    # and canonicalization tie-breaks route all traffic to instance 2j.
    pal = jnp.repeat(jnp.all(fwd == rev, axis=1), 2)
    ovalid = ovalid & ~(pal & (jnp.arange(O) % 2 == 1))

    suffix = dna.drop_first_bases(ori, 1, k + 1)   # (O, W) last k bases
    prefix = dna.truncate_bases(ori, k + 1, k)     # (O, W) first k bases

    # ---- successor over the junction vertex between edge o and its follower
    csuf, sfwd = dna.canonicalize_kmers(suffix, k)
    vidx = segments.searchsorted_rows(vt.kmers, csuf)
    omask = extension.oriented_out_mask(vt, vidx, sfwd)
    imask = extension.oriented_in_mask(vt, vidx, sfwd)
    link = (extension.popcount4(omask) == 1) & \
           (extension.popcount4(imask) == 1) & ovalid
    out_base = _single_bit_index(omask)
    nxt_kp1 = dna.append_base(suffix, k, jnp.maximum(out_base, 0))
    cn, nfwd = dna.canonicalize_kmers(nxt_kp1, k + 1)
    j2 = segments.searchsorted_rows(kp1_table.kmers, cn)
    link = link & (j2 < kp1_table.num)
    succ = jnp.where(link, 2 * j2 + (1 - nfwd.astype(jnp.int32)), NONE)
    # self-loop guard: an edge must not succeed itself
    succ = jnp.where(succ == jnp.arange(O), NONE, succ)

    # ---- endpoint vertices (oriented k-mer ids: 2*vidx + (0 fwd / 1 rc))
    cpre, pfwd = dna.canonicalize_kmers(prefix, k)
    pvidx = segments.searchsorted_rows(vt.kmers, cpre)
    ov_start = 2 * pvidx + (1 - pfwd.astype(jnp.int32))
    ov_end = 2 * vidx + (1 - sfwd.astype(jnp.int32))

    o_counts = kp1_table.counts[jnp.arange(O) // 2].astype(jnp.float32)
    return contract_and_materialize(ori, ovalid, succ, o_counts,
                                    ov_start, ov_end, k)


def _scatter_unitig_bases(ori: jax.Array, start_pos: jax.Array, k: int,
                          flat_cap: int) -> jax.Array:
    """Scatter each oriented instance's k+1 bases into the flat sequence
    pool at start_pos[o] + j (dropped where start_pos == flat_cap).

    Single-shot, the (O, k+1) int32 position tensor plus the unpacked
    (O, k+1) codes are the construction peak — 4.7 GB at the 4.6 Mb
    k55 rung (O = 11.8M), on top of the table/vertex arrays already
    resident. Chunking the O axis through a fori_loop caps the
    per-step temporaries at ~the chunk size while writing the same
    bytes (overlapping writes agree, so split order is irrelevant).
    """
    O = ori.shape[0]
    W1 = ori.shape[1]
    out = jnp.zeros((flat_cap,), jnp.uint8)
    CHUNK = 1 << 20
    if O <= CHUNK:
        codes = dna.unpack_kmers(ori, k + 1)
        base_pos = start_pos[:, None] + jnp.arange(k + 1)[None, :]
        base_pos = jnp.where(start_pos[:, None] >= flat_cap, flat_cap,
                             base_pos)
        return out.at[base_pos].set(codes, mode="drop")
    n_chunks = -(-O // CHUNK)
    pad = n_chunks * CHUNK - O
    ori_p = jnp.pad(ori, ((0, pad), (0, 0)))
    start_p = jnp.pad(start_pos, (0, pad), constant_values=flat_cap)

    def body(i, acc):
        o = jax.lax.dynamic_slice(ori_p, (i * CHUNK, 0), (CHUNK, W1))
        s = jax.lax.dynamic_slice(start_p, (i * CHUNK,), (CHUNK,))
        codes = dna.unpack_kmers(o, k + 1)
        pos = s[:, None] + jnp.arange(k + 1)[None, :]
        pos = jnp.where(s[:, None] >= flat_cap, flat_cap, pos)
        return acc.at[pos].set(codes, mode="drop")

    return jax.lax.fori_loop(0, n_chunks, body, out)


def contract_and_materialize(ori: jax.Array, ovalid: jax.Array,
                             succ: jax.Array, o_counts: jax.Array,
                             ov_start: jax.Array, ov_end: jax.Array,
                             k: int) -> Graph:
    """Chain contraction + unitig materialization over per-oriented-
    instance arrays (the second half of build_graph, shared with the
    distributed builder in parallel/condense_dist.py, where the same
    global-index-space program runs GSPMD-sharded over a device mesh).

    ori: (O, W1) oriented (k+1)-mer words; succ: (O,) global successor
    index (O = NONE); o_counts: (O,) multiplicity; ov_start/ov_end:
    (O,) oriented junction-vertex ids of each instance's endpoints.
    """
    O = ori.shape[0]

    # ---- chain contraction (conjugate of oriented instance 2j+s is 2j+1-s)
    conj_o = jnp.arange(O, dtype=jnp.int32) ^ 1
    chains = pointer_jump.contract_chains(succ, conj_o, ovalid)
    rep, off, is_start = chains.rep, chains.off, chains.is_start
    uid_at_start = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    num_unitigs = jnp.sum(is_start.astype(jnp.int32))
    uid = uid_at_start[rep]                      # (O,)
    uid_safe = jnp.where(ovalid, uid, O)

    chain_len = jnp.zeros((O,), jnp.int32).at[uid_safe].max(
        off + 1, mode="drop")
    cov_sum = jnp.zeros((O,), jnp.float32).at[uid_safe].add(
        o_counts, mode="drop")
    # flanking coverage: average multiplicity of the unitig's first
    # FLANKING_RANGE (k+1)-mers (detail_coverage.hpp FlankingCoverage)
    in_flank = off < FLANKING_RANGE
    flank_sum = jnp.zeros((O,), jnp.float32).at[
        jnp.where(in_flank, uid_safe, O)].add(o_counts, mode="drop")

    is_last = ovalid & (off == chain_len[jnp.minimum(uid, O - 1)] - 1)
    last_node = jnp.zeros((O,), jnp.int32).at[
        jnp.where(is_last, uid, O)].max(jnp.arange(O, dtype=jnp.int32),
                                        mode="drop")
    start_node = jnp.zeros((O,), jnp.int32).at[
        jnp.where(is_start, uid, O)].max(jnp.arange(O, dtype=jnp.int32),
                                         mode="drop")

    # conjugate unitig: rc of chain(o0..om) = chain(conj(om)..conj(o0))
    conj = uid[jnp.minimum(last_node ^ 1, O - 1)]

    # ---- sequences: scatter all k+1 bases of every oriented edge at
    # flat position start_flat[uid] + off + j (overlapping writes agree).
    seq_len = jnp.where(jnp.arange(O) < num_unitigs, chain_len + k, 0)
    seq_start = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(seq_len)[:-1]])
    flat_cap = O * (k + 1)
    start_pos = jnp.where(
        ovalid, seq_start[jnp.minimum(uid, O - 1)] + off, flat_cap)
    seq_flat = _scatter_unitig_bases(ori, start_pos, k, flat_cap)

    start_v = ov_start[jnp.minimum(start_node, O - 1)]
    end_v = ov_end[jnp.minimum(last_node, O - 1)]

    real = jnp.arange(O) < num_unitigs
    cov = jnp.where(chain_len > 0, cov_sum / jnp.maximum(chain_len, 1), 0.0)
    flank = flank_sum / jnp.maximum(
        jnp.minimum(chain_len, FLANKING_RANGE), 1).astype(jnp.float32)
    return Graph(
        seq_flat=seq_flat,
        seq_start=seq_start,
        seq_len=seq_len,
        cov=jnp.where(real, cov, 0.0),
        start_v=jnp.where(real, start_v, 0),
        end_v=jnp.where(real, end_v, 0),
        conj=jnp.where(real, conj, 0),
        alive=real,
        num_edges=num_unitigs,
        k=k,
        flank=jnp.where(real, flank, 0.0),
    )
