"""Sharded graph construction: distributed extension-index build.

Extends the sharded counting pipeline (kmer_exchange.py) through the
next construction phase (SURVEY.md §3.2 ExtensionIndexBuilder,
kmer_extension_index_builder.hpp:45-60): every (k+1)-mer shard emits two
(k-mer, mask-bit) records (prefix gets an out bit, suffix an in bit,
both redirected through canonicalization exactly as in
kmers/extension.py); records route to their owner chip by k-mer hash via
``all_to_all``; each owner sort-reduces its partition into a
hash-partitioned canonical VertexTable shard.

The payload rides *inside* the exchanged rows: a record is
(W k-mer words, 1 bit-column word), so the same bucketize/all_to_all
machinery moves keys and payloads together.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import dna, segments
from ..kmers.extension import VertexTable, kplus1_prefix_suffix
from .kmer_exchange import kmer_hash
from .mesh import READS_AXIS

_ONES = jnp.uint32(0xFFFFFFFF)


def _bucketize_rows(rows: jax.Array, valid: jax.Array, n_dev: int,
                    cap: int):
    """Pack rows into (n_dev, cap, C) send buffers, owner = hash of the
    first W = C-1 key words (last column is payload)."""
    N, C = rows.shape
    owner = (kmer_hash(rows[:, :C - 1]) % jnp.uint32(n_dev)
             ).astype(jnp.uint32)
    owner = jnp.where(valid, owner, jnp.uint32(n_dev))
    skeys, (srows,), svalid = segments.sort_by_key_rows(
        owner[:, None], (rows,), valid)
    sowner = skeys[:, 0]
    idx = jnp.arange(N)
    bucket_start = jnp.searchsorted(
        sowner, jnp.arange(n_dev, dtype=jnp.uint32)).astype(jnp.int32)
    pos = idx.astype(jnp.int32) - bucket_start[jnp.minimum(
        sowner, jnp.uint32(n_dev - 1)).astype(jnp.int32)]
    dest_ok = svalid & (pos < cap)
    d = jnp.where(dest_ok, sowner.astype(jnp.int32), n_dev)
    p = jnp.where(dest_ok, pos, 0)
    buf = jnp.full((n_dev, cap, C), _ONES)
    buf = buf.at[d, p].set(srows, mode="drop")
    dropped = jnp.sum(svalid.astype(jnp.int32)) - jnp.sum(
        dest_ok.astype(jnp.int32))
    return buf, dropped


def make_sharded_vertex_builder(mesh: Mesh, k: int,
                                capacity_factor: float = 2.5):
    """Returns ``build(kp1_kmers, kp1_num) -> (vt_kmers, out_mask,
    in_mask, num, dropped)`` with all inputs/outputs sharded over the
    reads axis.  Input: the hash-partitioned (k+1)-mer table from
    ``make_sharded_counter`` (per-shard padded).  Output shard i holds
    the canonical k-mers with ``hash % D == i``, sorted, with extension
    masks."""
    n_dev = mesh.shape[READS_AXIS]

    def per_shard(kp1_kmers, kp1_num):
        N = kp1_kmers.shape[0]
        valid = jnp.arange(N) < kp1_num[0]
        prefix, suffix, first, last = kplus1_prefix_suffix(kp1_kmers, k)
        cpre, pre_fwd = dna.canonicalize_kmers(prefix, k)
        csuf, suf_fwd = dna.canonicalize_kmers(suffix, k)

        # bit-column convention of kmers/extension.py: 0..3 out, 4..7 in
        pre_col = jnp.where(pre_fwd, last.astype(jnp.uint32),
                            4 + (3 - last.astype(jnp.uint32)))
        suf_col = jnp.where(suf_fwd, 4 + first.astype(jnp.uint32),
                            3 - first.astype(jnp.uint32))

        W = cpre.shape[-1]
        rows = jnp.concatenate([
            jnp.concatenate([cpre, pre_col[:, None].astype(jnp.uint32)],
                            axis=1),
            jnp.concatenate([csuf, suf_col[:, None].astype(jnp.uint32)],
                            axis=1)], axis=0)
        rvalid = jnp.concatenate([valid, valid])

        cap = int(rows.shape[0] * capacity_factor / n_dev) + 16
        buf, dropped = _bucketize_rows(rows, rvalid, n_dev, cap)
        recv = jax.lax.all_to_all(buf, READS_AXIS, split_axis=0,
                                  concat_axis=0, tiled=False)
        rec = recv.reshape(-1, W + 1)
        rv = ~jnp.all(rec[:, :W] == _ONES, axis=1)

        # local reduce: unique k-mers + OR of bit columns
        keys = rec[:, :W]
        skeys, (scol,), svalid = segments.sort_by_key_rows(
            keys, (rec[:, W],), rv)
        new = (~segments.rows_equal_prev(skeys)) & svalid
        gid = jnp.cumsum(new.astype(jnp.int32)) - 1
        M = keys.shape[0]
        gid = jnp.where(svalid, jnp.maximum(gid, 0), M)
        num = jnp.sum(new.astype(jnp.int32))

        bits = jnp.zeros((M, 8), jnp.uint8)
        col = jnp.minimum(scol, jnp.uint32(7)).astype(jnp.int32)
        bits = bits.at[gid, col].max(jnp.uint8(1), mode="drop")
        weights = (jnp.uint8(1) << jnp.arange(4, dtype=jnp.uint8))
        out_mask = jnp.sum(bits[:, :4] * weights, axis=1).astype(jnp.uint8)
        in_mask = jnp.sum(bits[:, 4:] * weights, axis=1).astype(jnp.uint8)

        uniq = jnp.full((M, W), _ONES)
        uniq = uniq.at[jnp.where(new, gid, M)].set(skeys, mode="drop")
        return (uniq, out_mask, in_mask, num[None], dropped[None])

    sharded = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(READS_AXIS, None), P(READS_AXIS)),
        out_specs=(P(READS_AXIS, None), P(READS_AXIS), P(READS_AXIS),
                   P(READS_AXIS), P(READS_AXIS)),
        check_vma=False)

    @jax.jit
    def build(kp1_kmers, kp1_num):
        return sharded(kp1_kmers, kp1_num)

    return build


def gather_vertex_table(vt_kmers, out_mask, in_mask, nums, k: int
                        ) -> VertexTable:
    """Host-side: merge per-shard vertex partitions into one sorted
    VertexTable (used where downstream stages are still single-shard)."""
    import numpy as np
    D = len(np.asarray(nums))
    per = vt_kmers.shape[0] // D
    ks, oms, ims = [], [], []
    for i in range(D):
        n = int(np.asarray(nums)[i])
        ks.append(np.asarray(vt_kmers)[i * per:i * per + n])
        oms.append(np.asarray(out_mask)[i * per:i * per + n])
        ims.append(np.asarray(in_mask)[i * per:i * per + n])
    allk = np.concatenate(ks, axis=0)
    om = np.concatenate(oms)
    im = np.concatenate(ims)
    order = np.lexsort(tuple(allk[:, w] for w in
                             range(allk.shape[1] - 1, -1, -1)))
    allk, om, im = allk[order], om[order], im[order]
    N = len(allk)
    pad = np.full((max(N, 1), allk.shape[1]), 0xFFFFFFFF, np.uint32)
    pad[:N] = allk
    return VertexTable(
        kmers=jnp.asarray(pad),
        out_mask=jnp.asarray(np.pad(om, (0, max(N, 1) - N))),
        in_mask=jnp.asarray(np.pad(im, (0, max(N, 1) - N))),
        num=jnp.int32(N))
