"""Sharded k-mer counting: hash-partitioned all-to-all over the mesh.

Device-side replacement for the reference's out-of-core bucket machinery
(``KMerDiskCounter`` hash-segment file buckets,
utils/kmer_mph/kmer_index_builder.hpp:220-366 + kmer_buckets.hpp:15-44):
instead of fanning k-mers into disk files by hash segment, each chip
extracts k-mers from its read shard, routes them to their owner chip by
k-mer hash via ``all_to_all``, and each owner sort-counts its
partition locally. The result is a globally partitioned sorted k-mer
table: shard i holds exactly the k-mers with ``hash % D == i``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import dna, kmer, segments
from ..kmers.counter import KmerTable
from .mesh import READS_AXIS


def kmer_hash(words: jax.Array) -> jax.Array:
    """Cheap multiplicative mix of k-mer words -> uint32 hash."""
    h = jnp.uint32(0x9E3779B9)
    for w in range(words.shape[-1]):
        h = (h ^ words[..., w]) * jnp.uint32(0x85EBCA6B)
        h = h ^ (h >> 13)
    return h * jnp.uint32(0xC2B2AE35)


def _bucketize(canon: jax.Array, valid: jax.Array, n_dev: int, cap: int):
    """Sort local k-mers into (n_dev, cap, W) send buffers by owner."""
    N, W = canon.shape
    owner = (kmer_hash(canon) % jnp.uint32(n_dev)).astype(jnp.uint32)
    owner = jnp.where(valid, owner, jnp.uint32(n_dev))  # invalid -> dropped
    # stable sort by owner packs each bucket contiguously
    skeys, (scanon,), svalid = segments.sort_by_key_rows(
        owner[:, None], (canon,), valid)
    sowner = skeys[:, 0]
    # position within bucket
    idx = jnp.arange(N)
    bucket_start = jnp.searchsorted(sowner, jnp.arange(n_dev, dtype=jnp.uint32)
                                    ).astype(jnp.int32)
    pos = idx.astype(jnp.int32) - bucket_start[jnp.minimum(
        sowner, jnp.uint32(n_dev - 1)).astype(jnp.int32)]
    dest_ok = svalid & (pos < cap)
    d = jnp.where(dest_ok, sowner.astype(jnp.int32), n_dev)
    p = jnp.where(dest_ok, pos, 0)
    buf = jnp.full((n_dev, cap, W), jnp.uint32(0xFFFFFFFF))
    buf = buf.at[d, p].set(scanon, mode="drop")
    sent = jnp.zeros((n_dev,), jnp.int32).at[d].add(
        dest_ok.astype(jnp.int32), mode="drop")
    dropped = jnp.sum(svalid.astype(jnp.int32)) - jnp.sum(sent)
    return buf, sent, dropped


def _local_count(rows: jax.Array, valid: jax.Array) -> KmerTable:
    uniq, counts, num = segments.count_sorted(rows, valid)
    return KmerTable(uniq, counts.astype(jnp.int32), num)


def make_sharded_counter(mesh: Mesh, k: int, capacity_factor: float = 1.5):
    """Build a jit-compiled sharded canonical k-mer counter.

    Returns ``count(codes, lengths) -> KmerTable`` where inputs are
    sharded (R, L)/(R,) over the reads axis and the output table arrays are
    sharded over the same axis: shard i holds the sorted unique k-mers
    whose hash lands in partition i (padded per shard).

    capacity_factor bounds per-destination all_to_all volume relative to
    perfect balance; overflow k-mers are dropped (hash balance makes this
    vanishingly rare at sane factors — callers can assert via the counter's
    dropped counter in tests).
    """
    n_dev = mesh.shape[READS_AXIS]

    def per_shard(codes, lengths):
        canon, valid, _ = kmer.extract_canonical_kmers(codes, lengths, k)
        W = canon.shape[-1]
        flat = canon.reshape(-1, W)
        fvalid = valid.reshape(-1)
        cap = int(flat.shape[0] * capacity_factor / n_dev) + 16
        buf, _, dropped = _bucketize(flat, fvalid, n_dev, cap)
        # (n_dev, cap, W): row j goes to device j
        recv = jax.lax.all_to_all(buf, READS_AXIS, split_axis=0,
                                  concat_axis=0, tiled=False)
        rows = recv.reshape(-1, W)
        rvalid = ~jnp.all(rows == jnp.uint32(0xFFFFFFFF), axis=1)
        table = _local_count(rows, rvalid)
        return table.kmers, table.counts, table.num[None], dropped[None]

    sharded = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(READS_AXIS, None), P(READS_AXIS)),
        out_specs=(P(READS_AXIS, None), P(READS_AXIS), P(READS_AXIS),
                   P(READS_AXIS)),
        check_vma=False)

    @jax.jit
    def count(codes, lengths):
        kmers, counts, nums, dropped = sharded(codes, lengths)
        return kmers, counts, nums, dropped

    return count


def make_sharded_table_merge(mesh: Mesh):
    """Per-shard merge of two hash-partitioned tables (counts add).

    Both inputs must be partitioned by the same hash policy (the output
    of ``make_sharded_counter``), so merging is purely shard-local:
    concat + sort + run-length reduce per shard.  Used to fold
    additional-contig k-mers (the multi-K ``--additional-contigs``
    mechanism) into the read table without leaving the mesh.
    """
    def per_shard(k1, c1, n1, k2, c2, n2):
        kmers = jnp.concatenate([k1, k2], axis=0)
        counts = jnp.concatenate([c1, c2])
        valid = jnp.concatenate([
            jnp.arange(k1.shape[0]) < n1[0],
            jnp.arange(k2.shape[0]) < n2[0]])
        uniq, cnt, num = segments.count_sorted(kmers, valid, counts)
        return uniq, cnt.astype(jnp.int32), num[None]

    sharded = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(READS_AXIS, None), P(READS_AXIS), P(READS_AXIS),
                  P(READS_AXIS, None), P(READS_AXIS), P(READS_AXIS)),
        out_specs=(P(READS_AXIS, None), P(READS_AXIS), P(READS_AXIS)),
        check_vma=False)
    return jax.jit(sharded)


def make_sharded_min_count_filter(mesh: Mesh):
    """Per-shard ``filter_min_count`` (drop k-mers below the coverage
    cutoff) preserving the hash partition and sorted-with-padding-last
    invariant of each shard."""
    def per_shard(kmers, counts, num, minc):
        N = kmers.shape[0]
        keep = (counts >= minc[0]) & (jnp.arange(N) < num[0])
        kept, (km, ct) = segments.compact(keep, kmers, counts)
        pad = jnp.arange(N) >= kept
        km = jnp.where(pad[:, None], jnp.uint32(0xFFFFFFFF), km)
        return km, ct, kept[None]

    sharded = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(READS_AXIS, None), P(READS_AXIS), P(READS_AXIS), P()),
        out_specs=(P(READS_AXIS, None), P(READS_AXIS), P(READS_AXIS)),
        check_vma=False)
    return jax.jit(sharded)
