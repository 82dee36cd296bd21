"""Canonical k-mer counting: reads -> sorted unique (k-mer, count) table.

Device-side equivalent of the reference's disk k-mer counting pipeline
(assembler/src/common/utils/kmer_mph/kmer_index_builder.hpp:220-366 —
bucket-split files, per-bucket sort, loser-tree merge) and its callers
(common/stages/construction.cpp:218-247). One fused jit region: extract,
canonicalize, sort, run-length reduce.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import dna, kmer, segments


class KmerTable(NamedTuple):
    """Sorted unique canonical k-mers with counts (padded ragged).

    kmers: (N, W) uint32, lexicographically sorted; rows >= num scatter to
      all-ones padding.
    counts: (N,) int32.
    num: () int32 number of real rows.
    """
    kmers: jax.Array
    counts: jax.Array
    num: jax.Array

    @property
    def capacity(self) -> int:
        return self.kmers.shape[0]


@functools.partial(jax.jit, static_argnames=("k",))
def count_kmers(codes: jax.Array, lengths: jax.Array, k: int) -> KmerTable:
    """Count canonical k-mers of a read batch (single shard)."""
    # all-ones is unreachable for real k-mers when pad bits exist
    sentinel_safe = (k % dna.BASES_PER_WORD) != 0
    canon, valid, _ = kmer.extract_canonical_kmers(codes, lengths, k)
    W = canon.shape[-1]
    flat = canon.reshape(-1, W)
    flat_valid = valid.reshape(-1)
    uniq, counts, num = segments.count_sorted(
        flat, flat_valid, sentinel_safe=sentinel_safe)
    return KmerTable(uniq, counts.astype(jnp.int32), num)


@functools.partial(jax.jit, static_argnames=())
def filter_min_count(table: KmerTable, min_count: jax.Array) -> KmerTable:
    """Drop k-mers with count < min_count (keeps sort order)."""
    keep = (table.counts >= min_count) & (
        jnp.arange(table.capacity) < table.num)
    num, (kmers, counts) = segments.compact(keep, table.kmers, table.counts)
    # compact() zero-fills; restore all-ones padding so the table stays
    # sorted-with-padding-last for binary search.
    pad = jnp.arange(table.capacity) >= num
    kmers = jnp.where(pad[:, None], jnp.uint32(0xFFFFFFFF), kmers)
    return KmerTable(kmers, counts, num)


@functools.partial(jax.jit, static_argnames=("k",))
def count_kmers_quality(codes: jax.Array, lengths: jax.Array,
                        quals: jax.Array, k: int):
    """Count canonical k-mers with per-k-mer quality mass.

    The BayesHammer counting statistic (projects/hammer kmer_stat.hpp:
    each k-mer instance carries its bases' error probabilities): a
    k-mer's quality weight is the product over its bases of
    (1 - 10^(-phred/10)), summed over instances.  Error k-mers drawn
    from miscalled (low-quality) bases collect far less quality mass
    than their raw count suggests.

    Returns (KmerTable with integer counts, qweight (N,) float32).
    """
    canon, valid, _ = kmer.extract_canonical_kmers(codes, lengths, k)
    R, P, W = canon.shape
    q = jnp.maximum(quals.astype(jnp.float32) - 33.0, 0.0)
    perr = jnp.minimum(jnp.power(10.0, -q / 10.0), 0.75)
    lp = jnp.log1p(-perr)
    cs0 = jnp.concatenate([jnp.zeros((R, 1), jnp.float32),
                           jnp.cumsum(lp, axis=1)], axis=1)
    w = jnp.exp(cs0[:, k:P + k] - cs0[:, :P])        # (R, P)

    flat = canon.reshape(-1, W)
    fvalid = valid.reshape(-1)
    skeys, (sw,), svalid = segments.sort_by_key_rows(
        flat, (w.reshape(-1),), fvalid)
    uniq, counts, gid, num = segments.unique_counts(skeys, svalid)
    N = skeys.shape[0]
    scatter_gid = jnp.where(svalid, gid, N)
    qweight = jnp.zeros((N,), jnp.float32).at[scatter_gid].add(
        sw, mode="drop")
    return KmerTable(uniq, counts.astype(jnp.int32), num), qweight


def trim_table(t: KmerTable) -> KmerTable:
    """Round capacity to the next power of two so merge shapes (and
    their jit compilations) stay bucketed instead of unique per call."""
    cap = 1 << max(1, int(t.num) - 1).bit_length()
    cap = min(cap, t.capacity)
    return KmerTable(t.kmers[:cap], t.counts[:cap], t.num)


def count_kmers_chunked(codes, lengths, k: int,
                        chunk_reads: int | None = None) -> KmerTable:
    """Count k-mers of a batch too large for device memory in one sort.

    The reference splits k-mers into disk bucket files and merges sorted
    runs (kmer_index_builder.hpp:220-366); here each read chunk counts
    on-device and the sorted unique tables merge pairwise (a sorted-run
    merge expressed as concat + re-sort of already-unique rows, which is
    a fraction of the raw stream size). Host RAM holds only the running
    table.
    """
    # slicing and padding happen on the device with traced offsets: one
    # compile for every chunk, and no host round trip per chunk
    from ..ops import chunking
    if chunk_reads is None:
        from ..utils import membudget
        chunk_reads = membudget.count_chunk_reads(
            1 << 20, read_len=int(codes.shape[1]) if hasattr(codes, "shape")
            else 100)
    codes = jnp.asarray(codes)
    lengths = jnp.asarray(lengths)
    R = codes.shape[0]
    if R <= chunk_reads:
        return count_kmers(codes, lengths, k)
    codes_p = chunking.pad_to_multiple(codes, chunk_reads, fill=4)
    lengths_p = chunking.pad_to_multiple(lengths, chunk_reads)
    pow2_trim = trim_table
    table = None
    for lo in range(0, R, chunk_reads):
        c = chunking.dslice(codes_p, lo, chunk_reads)
        l = chunking.dslice(lengths_p, lo, chunk_reads)
        part = pow2_trim(count_kmers(c, l, k))
        table = part if table is None else pow2_trim(
            merge_tables(table, part))
    return table


@jax.jit
def merge_tables(a: KmerTable, b: KmerTable) -> KmerTable:
    """Merge two counted tables (counts add). Capacity = sum of inputs."""
    kmers = jnp.concatenate([a.kmers, b.kmers], axis=0)
    weights = jnp.concatenate([a.counts, b.counts])
    valid = jnp.concatenate([
        jnp.arange(a.capacity) < a.num, jnp.arange(b.capacity) < b.num])
    uniq, counts, num = segments.count_sorted(kmers, valid, weights)
    return KmerTable(uniq, counts.astype(jnp.int32), num)


def lookup(table: KmerTable, queries: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Find query k-mers (M, W) in the table.

    Returns (idx (M,) int32 into table rows, found (M,) bool). Replaces the
    reference's PHM lookup (utils/ph_map/perfect_hash_map.hpp:78).
    """
    idx = segments.searchsorted_rows(table.kmers, queries)
    found = idx < table.num
    return jnp.where(found, idx, 0), found
