"""Hamming-space k-mer clustering for read error correction.

Device-side replacement of BayesHammer's clustering machinery
(projects/hammer/hamcluster.cpp ``KMerHamClusterer``: tau sub-k-mer sorts
feeding a concurrent disjoint-set union, + kmer_cluster.cpp Bayesian
center finding):

- distance-1 neighbor discovery by *masked-variant sorting*: every k-mer
  emits k variants with one position wildcarded; two k-mers at Hamming
  distance exactly 1 share exactly one variant, so sorting the k*N
  variant rows groups all neighbor pairs (replaces the sub-k-mer block
  sort + pairwise check of hamcluster.cpp:140);
- union-find by iterated min-label propagation over variant groups
  (replaces ConcurrentDSU, adt/concurrent_dsu.hpp:28) — O(log N) rounds
  of segmented min + gather;
- center election per cluster: the dominant-count k-mer; members whose
  count is a small fraction of the center are errors (the cheap-prior
  special case of kmer_cluster.cpp's Bayesian subclustering — the
  quality-aware likelihood model is a planned refinement).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import dna, segments


class HammerClusters(NamedTuple):
    rep: jax.Array        # (N,) int32 cluster representative per unique kmer
    is_center: jax.Array  # (N,) bool — kmer is its cluster's center
    solid: jax.Array      # (N,) bool — kmer considered genomic ("good")
    center_of: jax.Array  # (N,) int32 row index of the cluster's center


def _masked_variants(kmers: jax.Array, k: int) -> jax.Array:
    """(N, W) -> (N, k, W): variant i has base i forced to 0, paired with
    the wildcard position baked into a separate key column by the caller."""
    N, W = kmers.shape
    out = jnp.broadcast_to(kmers[:, None, :], (N, k, W)).copy()
    # clear 2 bits of position i in the right word
    pos = jnp.arange(k)
    word = pos // dna.BASES_PER_WORD
    slot = pos % dna.BASES_PER_WORD
    shift = (dna.BASES_PER_WORD - 1 - slot) * 2
    mask = ~(jnp.uint32(3) << shift.astype(jnp.uint32))  # (k,)
    onehot = jax.nn.one_hot(word, W, dtype=jnp.uint32)   # (k, W)
    clear = jnp.where(onehot.astype(bool), mask[:, None],
                      jnp.uint32(0xFFFFFFFF))            # (k, W)
    return out & clear[None, :, :]


@functools.partial(jax.jit, static_argnames=("k", "n_rounds"))
def cluster_kmers(kmers: jax.Array, counts: jax.Array, num: jax.Array,
                  k: int, good_threshold: jax.Array,
                  center_ratio: jax.Array, n_rounds: int = 2
                  ) -> HammerClusters:
    """Cluster unique k-mers (N, W) by Hamming-distance-1 connectivity.

    One wildcard POSITION per loop step (the reference's tau sub-k-mer
    sort passes, hamcluster.cpp): clear position p's 2 bits, sort the
    (N, W) masked keys, and min-propagate labels within equal-key runs.
    Memory stays O(N*W) — materializing all k variants at once is an
    (N, k, W) tensor, k times the table.  Sequential per-position propagation with path
    compression converges in far fewer outer rounds than the batch
    variant (Gauss-Seidel vs Jacobi), so n_rounds=2 suffices.

    Args:
      kmers/counts/num: unique k-mer table (padded ragged).
      good_threshold: counts >= this are solid regardless of clustering.
      center_ratio: a member is an error of its center when
        count * center_ratio <= center_count.
    """
    N, W = kmers.shape
    valid = jnp.arange(N) < num
    owner0 = jnp.arange(N, dtype=jnp.int32)
    bpw = dna.BASES_PER_WORD

    def step(i, rep):
        pos = i % k
        word = pos // bpw
        slot = pos % bpw
        shift = ((bpw - 1 - slot) * 2).astype(jnp.uint32)
        mask = ~(jnp.uint32(3) << shift)
        clear = jnp.where(jnp.arange(W) == word, mask,
                          jnp.uint32(0xFFFFFFFF))       # (W,)
        key = kmers & clear[None, :]                    # (N, W)
        skeys, (sowner,), svalid = segments.sort_by_key_rows(
            key, (owner0,), valid)
        seg_start = (~segments.rows_equal_prev(skeys)) & svalid
        gid = jnp.cumsum(seg_start.astype(jnp.int32)) - 1
        gid = jnp.where(svalid, jnp.maximum(gid, 0), N)
        labels = rep[jnp.minimum(sowner, N - 1)]
        gmin = jnp.full((N,), N, jnp.int32).at[gid].min(
            jnp.where(svalid, labels, N), mode="drop")
        new_label = gmin[jnp.minimum(gid, N - 1)]
        upd = jnp.full((N,), N, jnp.int32).at[
            jnp.where(svalid, sowner, N)].min(new_label, mode="drop")
        rep = jnp.minimum(rep, jnp.where(upd < N, upd, rep))
        # path-compress: follow rep once
        return jnp.minimum(rep, rep[rep])

    rep = jax.lax.fori_loop(0, n_rounds * k, step,
                            jnp.arange(N, dtype=jnp.int32))
    rep = jnp.where(valid, rep, N)

    # center election: max count per cluster, ties to smallest index
    rep_safe = jnp.where(valid, rep, N)
    cmax = jnp.zeros((N,), counts.dtype).at[rep_safe].max(
        jnp.where(valid, counts, 0), mode="drop")
    is_cand = valid & (counts == cmax[jnp.minimum(rep, N - 1)])
    cidx = jnp.full((N,), N, jnp.int32).at[
        jnp.where(is_cand, rep, N)].min(
        jnp.arange(N, dtype=jnp.int32), mode="drop")
    is_center = is_cand & (jnp.arange(N) == cidx[jnp.minimum(rep, N - 1)])

    center_count = cmax[jnp.minimum(rep, N - 1)]
    solid = valid & (
        is_center |
        (counts >= good_threshold) |
        (counts.astype(jnp.float32) * center_ratio >
         center_count.astype(jnp.float32)))
    center_of = jnp.where(valid, cidx[jnp.minimum(rep, N - 1)], N)
    return HammerClusters(rep=rep, is_center=is_center, solid=solid,
                          center_of=center_of)
