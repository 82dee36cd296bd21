"""Distributed graph construction: condensation over a device mesh.

Round-1 shipped only GSPMD-sharded chain contraction over a caller-built
successor array; this module now builds the WHOLE unitig graph from the
hash-partitioned (k+1)-mer and vertex tables produced by
kmer_exchange.py / construction.py, with no host gathers of
O(k-mer-space) arrays:

1. **Successor stage** (shard_map + all_to_all): each shard owns a
   contiguous block of oriented (k+1)-mer instances (global id =
   shard * 2L + local). The three table lookups of the single-shard
   builder (suffix junction vertex, prefix vertex, next-edge) become
   *routed queries*: keys go to their hash-owner shard, the
   owner answers its local sorted partition, replies route back on a
   second all_to_all and un-permute to request order. This replaces the
   reference's shared-memory perfect-hash probes
   (debruijn_graph_constructor.hpp:390-520) with the same
   bucket-routing used for counting.
2. **Contraction + materialization** (GSPMD): the per-instance global
   arrays feed the SAME ``contract_and_materialize`` program as the
   single-chip path (graph/condense.py), jitted with inputs sharded
   over the mesh — XLA inserts the collectives for the pointer-jumping
   gathers. Per-round collective payload is O(N) int32; no array ever
   round-trips through the host.

The resulting Graph's unitig numbering depends on the partition layout,
so equality against the single-chip build is checked on the canonical
form (sorted sequences + coverage + conjugate pairing) — see
tests/test_condense_dist.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..graph import condense
from ..graph.pointer_jump import Chains, contract_chains
from ..kmers import extension
from ..ops import dna, segments
from .kmer_exchange import kmer_hash
from .mesh import READS_AXIS

_ONES = jnp.uint32(0xFFFFFFFF)
MISS = jnp.uint32(0xFFFFFFFF)


def contract_chains_sharded(mesh: Mesh, succ, conj, valid) -> Chains:
    """contract_chains with inputs/outputs sharded over the mesh.

    Inputs are (N,) arrays with N a multiple of the mesh size (pad with
    invalid elements: succ == N, valid == False).
    """
    sh = NamedSharding(mesh, P(READS_AXIS))
    succ = jax.device_put(jnp.asarray(succ), sh)
    conj = jax.device_put(jnp.asarray(conj), sh)
    valid = jax.device_put(jnp.asarray(valid), sh)

    fn = jax.jit(contract_chains,
                 out_shardings=Chains(rep=sh, off=sh, is_start=sh,
                                      cyclic=sh))
    return fn(succ, conj, valid)


def _routed_lookup(keys, valid, n_dev, cap, answer_fn, n_ans):
    """Query rows routed to their hash-owner shard and answered there.

    Runs INSIDE shard_map. ``keys``: (N, W) uint32 query rows; owner =
    kmer_hash(row) % n_dev. ``answer_fn(rows (M, W), rvalid (M,)) ->
    (M, n_ans) uint32`` evaluates on the owner against its local
    partition (must emit MISS columns for rvalid=False rows).

    Returns (ans (N, n_ans) uint32 in request order — MISS-filled for
    invalid/dropped queries, dropped count). Two all_to_alls: query out,
    reply back; the reply lands at the same (dest, pos) the query was
    packed into, so un-permuting needs only the local sort permutation.
    """
    N, W = keys.shape
    owner = (kmer_hash(keys) % jnp.uint32(n_dev)).astype(jnp.uint32)
    owner = jnp.where(valid, owner, jnp.uint32(n_dev))
    orig = jnp.arange(N, dtype=jnp.int32)
    skeys, (srows, sorig), svalid = segments.sort_by_key_rows(
        owner[:, None], (keys, orig), valid)
    sowner = skeys[:, 0]
    bucket_start = jnp.searchsorted(
        sowner, jnp.arange(n_dev, dtype=jnp.uint32)).astype(jnp.int32)
    pos = jnp.arange(N, dtype=jnp.int32) - bucket_start[jnp.minimum(
        sowner, jnp.uint32(n_dev - 1)).astype(jnp.int32)]
    dest_ok = svalid & (pos < cap)
    d = jnp.where(dest_ok, sowner.astype(jnp.int32), n_dev)
    p = jnp.where(dest_ok, pos, 0)
    buf = jnp.full((n_dev, cap, W), _ONES)
    buf = buf.at[d, p].set(srows, mode="drop")
    dropped = jnp.sum(svalid.astype(jnp.int32)) - jnp.sum(
        dest_ok.astype(jnp.int32))

    recv = jax.lax.all_to_all(buf, READS_AXIS, split_axis=0,
                              concat_axis=0, tiled=False)
    rec = recv.reshape(-1, W)
    rvalid = ~jnp.all(rec == _ONES, axis=1)
    ans = answer_fn(rec, rvalid).astype(jnp.uint32)   # (n_dev*cap, n_ans)
    ans_buf = ans.reshape(n_dev, cap, n_ans)
    rep = jax.lax.all_to_all(ans_buf, READS_AXIS, split_axis=0,
                             concat_axis=0, tiled=False)
    got = rep[jnp.minimum(d, n_dev - 1), p]           # (N, n_ans) sorted
    got = jnp.where(dest_ok[:, None], got, MISS)
    out = jnp.full((N, n_ans), MISS)
    out = out.at[sorig].set(got, mode="drop")
    return out, dropped


def make_sharded_graph_builder(mesh: Mesh, k: int,
                               capacity_factor: float = 3.0):
    """Returns ``build(kp1_kmers, kp1_counts, kp1_nums, vt_kmers,
    vt_out, vt_in, vt_nums) -> Graph`` over hash-partitioned table
    shards (the outputs of make_sharded_counter /
    make_sharded_vertex_builder), plus a dropped-queries counter.

    The Graph's arrays stay device-sharded over the mesh; only scalars
    (num_edges) are host-visible.
    """
    n_dev = mesh.shape[READS_AXIS]

    def per_shard(kp1_kmers, kp1_counts, kp1_num,
                  vt_kmers, vt_out, vt_in, vt_num):
        L = kp1_kmers.shape[0]      # local (k+1)-mer slots
        LV = vt_kmers.shape[0]      # local vertex slots
        s = jax.lax.axis_index(READS_AXIS).astype(jnp.int32)
        O_glob = 2 * L * n_dev
        NONE = jnp.int32(O_glob)

        e_valid = jnp.arange(L) < kp1_num[0]
        fwd = kp1_kmers
        rev = dna.revcomp_kmers(fwd, k + 1)
        W1 = fwd.shape[1]
        # 2-gather interleave, the same as graph/condense.py
        half = jnp.arange(2 * L) // 2
        odd = (jnp.arange(2 * L) % 2) == 1
        ori = jnp.where(odd[:, None], rev[half], fwd[half])
        ovalid = jnp.repeat(e_valid, 2)
        pal = jnp.repeat(jnp.all(fwd == rev, axis=1), 2)
        ovalid = ovalid & ~(pal & (jnp.arange(2 * L) % 2 == 1))
        g_o = 2 * L * s + jnp.arange(2 * L, dtype=jnp.int32)  # global ids

        suffix = dna.drop_first_bases(ori, 1, k + 1)
        prefix = dna.truncate_bases(ori, k + 1, k)
        csuf, sfwd = dna.canonicalize_kmers(suffix, k)
        cpre, pfwd = dna.canonicalize_kmers(prefix, k)
        cap_q = int(2 * L * capacity_factor / n_dev) + 16

        def vt_answer(qrows, qvalid):
            i = segments.searchsorted_rows(vt_kmers, qrows)
            found = (i < vt_num[0]) & qvalid
            i_safe = jnp.minimum(i, LV - 1)
            return jnp.stack([
                jnp.where(found, i.astype(jnp.uint32), MISS),
                jnp.where(found, vt_out[i_safe].astype(jnp.uint32), 0),
                jnp.where(found, vt_in[i_safe].astype(jnp.uint32), 0),
            ], axis=1)

        suf_ans, drop1 = _routed_lookup(csuf, ovalid, n_dev, cap_q,
                                        vt_answer, 3)
        pre_ans, drop2 = _routed_lookup(cpre, ovalid, n_dev, cap_q,
                                        vt_answer, 3)

        suf_owner = (kmer_hash(csuf) % jnp.uint32(n_dev)).astype(jnp.int32)
        pre_owner = (kmer_hash(cpre) % jnp.uint32(n_dev)).astype(jnp.int32)
        suf_found = suf_ans[:, 0] != MISS
        pre_found = pre_ans[:, 0] != MISS
        suf_vidx = jnp.where(
            suf_found,
            suf_owner * LV + suf_ans[:, 0].astype(jnp.int32), 0)
        pre_vidx = jnp.where(
            pre_found,
            pre_owner * LV + pre_ans[:, 0].astype(jnp.int32), 0)

        omask_raw = suf_ans[:, 1].astype(jnp.uint8)
        imask_raw = suf_ans[:, 2].astype(jnp.uint8)
        omask = jnp.where(sfwd, omask_raw, extension.reverse4(imask_raw))
        imask = jnp.where(sfwd, imask_raw, extension.reverse4(omask_raw))
        link = (extension.popcount4(omask) == 1) & \
               (extension.popcount4(imask) == 1) & ovalid & suf_found
        out_base = condense._single_bit_index(omask)
        nxt_kp1 = dna.append_base(suffix, k, jnp.maximum(out_base, 0))
        cn, nfwd = dna.canonicalize_kmers(nxt_kp1, k + 1)

        def edge_answer(qrows, qvalid):
            j = segments.searchsorted_rows(kp1_kmers, qrows)
            found = (j < kp1_num[0]) & qvalid
            return jnp.where(found, j.astype(jnp.uint32),
                             MISS)[:, None]

        edge_ans, drop3 = _routed_lookup(cn, link, n_dev, cap_q,
                                         edge_answer, 1)
        edge_owner = (kmer_hash(cn) % jnp.uint32(n_dev)).astype(jnp.int32)
        link = link & (edge_ans[:, 0] != MISS)
        # global successor instance: owner's block base + 2*local + bit
        succ = jnp.where(
            link,
            2 * L * edge_owner
            + 2 * edge_ans[:, 0].astype(jnp.int32)
            + (1 - nfwd.astype(jnp.int32)),
            NONE)
        succ = jnp.where(succ == g_o, NONE, succ)  # self-loop guard

        ov_start = 2 * pre_vidx + (1 - pfwd.astype(jnp.int32))
        ov_end = 2 * suf_vidx + (1 - sfwd.astype(jnp.int32))
        o_counts = jnp.repeat(kp1_counts, 2).astype(jnp.float32)
        dropped = (drop1 + drop2 + drop3)[None]
        return (ori, ovalid, succ, o_counts, ov_start, ov_end, dropped)

    sharded = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(READS_AXIS, None), P(READS_AXIS), P(READS_AXIS),
                  P(READS_AXIS, None), P(READS_AXIS), P(READS_AXIS),
                  P(READS_AXIS)),
        out_specs=(P(READS_AXIS, None), P(READS_AXIS), P(READS_AXIS),
                   P(READS_AXIS), P(READS_AXIS), P(READS_AXIS),
                   P(READS_AXIS)),
        check_vma=False)

    sh = NamedSharding(mesh, P(READS_AXIS))
    materialize = jax.jit(
        functools.partial(condense.contract_and_materialize, k=k),
        in_shardings=(NamedSharding(mesh, P(READS_AXIS, None)),
                      sh, sh, sh, sh, sh))

    @jax.jit
    def successor_stage(kp1_kmers, kp1_counts, kp1_nums,
                        vt_kmers, vt_out, vt_in, vt_nums):
        return sharded(kp1_kmers, kp1_counts, kp1_nums,
                       vt_kmers, vt_out, vt_in, vt_nums)

    def build(kp1_kmers, kp1_counts, kp1_nums,
              vt_kmers, vt_out, vt_in, vt_nums):
        (ori, ovalid, succ, o_counts, ov_start, ov_end,
         dropped) = successor_stage(kp1_kmers, kp1_counts, kp1_nums,
                                    vt_kmers, vt_out, vt_in, vt_nums)
        g = materialize(ori, ovalid, succ, o_counts, ov_start, ov_end)
        return g, dropped

    return build
