"""BayesHammer's statistical core: quality statistics, Bayesian
subclustering and the solid-set expander.

Device-side redesign of projects/hammer's center-finding machinery:

- per-k-mer quality statistics (kmer_stat.hpp KMerStat: ``total_qual``
  = product over instances of the per-instance error probability,
  per-position summed phred capped at 63 like the 6-bit QualBitSet) —
  aggregated here with segmented scatter-adds instead of the
  lock-per-entry Merge (kmer_data.cpp:119-123);
- Bayesian l-means subclustering of each Hamming cluster
  (kmer_cluster.cpp lMeansClustering:125 + SubClusterSingle:261): for
  l = 1..Lmax, centers seeded from the top-count members, EM with a
  per-position quality log-likelihood (ExpandedKMer::logL,
  kmer_stat.hpp:218) and weighted-consensus M step
  (ConsensusWithMask:49), model selection by BIC (ClusterBIC:97,
  nparams = (l-1) + 3lK).  The reference runs this serially per
  cluster under OpenMP; here every cluster's EM runs simultaneously as
  one (N, Lmax, k) masked tensor program;
- good/bad marking per subcluster center (ProcessCluster:455):
  center_quality = 1 - total_qual against bayes_singleton_threshold /
  correct_threshold, cluster quality against
  bayes_nonsingleton_threshold; synthesized consensus centers (no
  member at Hamming distance 0) stay bad, exactly as the reference's
  re-marking does;
- iterative solid-set expansion over reads (expander.cpp:17): a read
  whose every position is covered by some solid k-mer promotes ALL its
  k-mers to solid; batched as a windowed-OR over the (R, P) solidity
  matrix instead of the per-read OpenMP loop, iterated to fixed point.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..kmers import counter
from ..ops import dna, kmer, segments

# reference defaults (configs/hammer/config.info:29-56)
SINGLETON_THRESHOLD = 0.995     # bayes_singleton_threshold
NONSINGLETON_THRESHOLD = 0.9    # bayes_nonsingleton_threshold
CORRECT_THRESHOLD = 0.98        # correct_threshold (correct_use_threshold=1)
QUAL_CAP = 63                   # QualBitSet 6-bit nibble saturation


class KmerQualStats(NamedTuple):
    total_lq: jax.Array    # (N,) float32: sum of log per-instance err prob
    qual_sum: jax.Array    # (N, k) float32: per-position phred sum (cap 63)


class SubClusters(NamedTuple):
    solid: jax.Array         # (N,) bool — k-mer marked good
    is_center: jax.Array     # (N,) bool — k-mer is a subcluster center
    center_bases: jax.Array  # (N, k) uint8 — consensus bases of the
    #                          k-mer's subcluster (its voting target)
    rep: jax.Array           # (N,) int32 Hamming-cluster representative


def _qual_probs(qual_sum: jax.Array):
    """Per-position log-probabilities from summed phred quality
    (main.cpp:103-108: rprob = 0.75 below q=3, else 10^(-q/10))."""
    q = jnp.minimum(qual_sum, float(QUAL_CAP))
    perr = jnp.where(q < 3.0, 0.75, jnp.power(10.0, -q / 10.0))
    lp = jnp.log1p(-perr)                 # log P(base correct)
    lrp = jnp.log(perr) - jnp.log(3.0)    # log P(this wrong base)
    return lp, lrp


@functools.partial(jax.jit, static_argnames=("k",))
def count_kmers_stats(codes: jax.Array, lengths: jax.Array,
                      quals: jax.Array, k: int
                      ) -> tuple[counter.KmerTable, KmerQualStats]:
    """Count canonical k-mers with BayesHammer's quality statistics.

    Replaces KMerDataCounter's locked Merge (kmer_data.cpp:119-155):
    ``total_lq`` accumulates log(1 - prod_i P(base_i correct)) per
    instance; ``qual_sum`` accumulates the phred value of each position
    in canonical orientation (PushKMerRC reverses the quality vector,
    kmer_data.cpp:138-143).
    """
    canon, valid, is_fwd = kmer.extract_canonical_kmers(codes, lengths, k)
    R, P, W = canon.shape
    q = jnp.maximum(quals.astype(jnp.float32) - 33.0, 0.0)
    perr = jnp.where(q < 3.0, 0.75, jnp.power(10.0, -q / 10.0))
    lp = jnp.log1p(-perr)
    cs0 = jnp.concatenate([jnp.zeros((R, 1), jnp.float32),
                           jnp.cumsum(lp, axis=1)], axis=1)
    # per-instance log P(all k bases correct) and log P(erroneous)
    lp_inst = cs0[:, k:P + k] - cs0[:, :P]           # (R, P)
    lq_inst = jnp.log1p(-jnp.minimum(jnp.exp(lp_inst), 1.0 - 1e-12))

    flat = canon.reshape(-1, W)
    fvalid = valid.reshape(-1)
    inst = jnp.arange(R * P, dtype=jnp.int32)
    skeys, (sinst,), svalid = segments.sort_by_key_rows(
        flat, (inst,), fvalid)
    uniq, counts, gid, num = segments.unique_counts(skeys, svalid)
    NR = skeys.shape[0]
    scatter_gid = jnp.where(svalid, gid, NR)
    total_lq = jnp.zeros((NR,), jnp.float32).at[scatter_gid].add(
        lq_inst.reshape(-1)[sinst], mode="drop")

    # per-position quality in canonical orientation
    offs = jnp.arange(k)
    rpos = sinst // P
    ppos = sinst % P
    fwd = is_fwd.reshape(-1)[sinst]                  # (NR,)
    col = jnp.where(fwd[:, None], offs[None, :], (k - 1 - offs)[None, :])
    qv = q[rpos[:, None], ppos[:, None] + col]       # (NR, k)
    qual_sum = jnp.zeros((NR, k), jnp.float32).at[
        scatter_gid[:, None], jnp.broadcast_to(offs[None, :], (NR, k))
    ].add(qv, mode="drop")
    qual_sum = jnp.minimum(qual_sum, float(QUAL_CAP))

    table = counter.KmerTable(uniq, counts.astype(jnp.int32), num)
    return table, KmerQualStats(total_lq=total_lq, qual_sum=qual_sum)


def _trim_stats(table: counter.KmerTable, stats: KmerQualStats):
    """Trim table+stats to pow2 unique capacity (counter.trim_table)."""
    cap = 1 << max(1, int(table.num) - 1).bit_length()
    cap = min(cap, table.capacity)
    return (counter.KmerTable(table.kmers[:cap], table.counts[:cap],
                              table.num),
            KmerQualStats(total_lq=stats.total_lq[:cap],
                          qual_sum=stats.qual_sum[:cap]))


@jax.jit
def _merge_stats_tables(ak, ac, alq, aq, an, bk, bc, blq, bq, bn):
    """Merge two sorted unique k-mer tables with quality statistics:
    counts, total_lq and per-position qual_sum all add per identical
    k-mer (the streamed equivalent of kmer_data.cpp:119 Merge)."""
    kmers = jnp.concatenate([ak, bk], axis=0)
    valid = jnp.concatenate([jnp.arange(ak.shape[0]) < an,
                             jnp.arange(bk.shape[0]) < bn])
    cnt = jnp.concatenate([ac, bc])
    lq = jnp.concatenate([alq, blq])
    qs = jnp.concatenate([aq, bq], axis=0)
    order = jnp.arange(kmers.shape[0], dtype=jnp.int32)
    skeys, (so,), svalid = segments.sort_by_key_rows(kmers, (order,), valid)
    uniq, counts, gid, num = segments.unique_counts(
        skeys, svalid, weights=cnt[so])
    N = skeys.shape[0]
    sg = jnp.where(svalid, gid, N)
    mlq = jnp.zeros((N,), jnp.float32).at[sg].add(lq[so], mode="drop")
    k = qs.shape[1]
    mqs = jnp.zeros((N, k), jnp.float32).at[
        sg[:, None], jnp.broadcast_to(jnp.arange(k)[None, :],
                                      (N, k))].add(qs[so], mode="drop")
    mqs = jnp.minimum(mqs, float(QUAL_CAP))
    return uniq, counts.astype(jnp.int32), mlq, mqs, num


def _spill_to_host(table: counter.KmerTable, stats: KmerQualStats):
    import numpy as np
    n = int(table.num)
    return (np.asarray(table.kmers[:n]), np.asarray(table.counts[:n]),
            np.asarray(stats.total_lq[:n]), np.asarray(stats.qual_sum[:n]))


def _merge_spills_host(spills, k: int):
    """Merge host-side spilled chunk tables: one lexsort over the
    concatenated keys + segment reduceat of the statistics.  The HBM
    analogue of the reference's disk-bucket merge
    (kmer_index_builder.hpp:281-338) — device merges bound peak HBM,
    oversize runs finish on the 100+ GB host."""
    import numpy as np
    kk = np.concatenate([s[0] for s in spills], axis=0)
    cc = np.concatenate([s[1] for s in spills])
    lq = np.concatenate([s[2] for s in spills])
    qs = np.concatenate([s[3] for s in spills], axis=0)
    order = np.lexsort(tuple(kk[:, w] for w in range(kk.shape[1] - 1,
                                                     -1, -1)))
    kk, cc, lq, qs = kk[order], cc[order], lq[order], qs[order]
    new = np.empty(kk.shape[0], bool)
    new[0] = True
    np.any(kk[1:] != kk[:-1], axis=1, out=new[1:])
    starts = np.nonzero(new)[0]
    uniq = kk[starts]
    counts = np.add.reduceat(cc.astype(np.int64), starts).astype(np.int32)
    mlq = np.add.reduceat(lq.astype(np.float64), starts).astype(np.float32)
    mqs = np.minimum(np.add.reduceat(qs.astype(np.float64), starts,
                                     axis=0),
                     float(QUAL_CAP)).astype(np.float32)
    num = uniq.shape[0]
    cap = 1 << max(1, num - 1).bit_length()
    pad = cap - num
    uniq = np.pad(uniq, ((0, pad), (0, 0)),
                  constant_values=np.iinfo(np.uint32).max)
    table = counter.KmerTable(jnp.asarray(uniq),
                              jnp.asarray(np.pad(counts, (0, pad))),
                              jnp.int32(num))
    stats = KmerQualStats(
        total_lq=jnp.asarray(np.pad(mlq, (0, pad))),
        qual_sum=jnp.asarray(np.pad(mqs, ((0, pad), (0, 0)))))
    return table, stats


@functools.partial(jax.jit, static_argnames=("k",),
                   donate_argnums=(5, 6))
def _accum_stats(tkmers, tnum, codes, lengths, quals,
                 total_lq, qual_sum, k: int):
    """Scatter one read chunk's quality statistics into the final-table
    accumulators: canonical extraction + sorted-table lookup + two
    scatter-adds. No sort, no merge — the table already exists."""
    canon, valid, is_fwd = kmer.extract_canonical_kmers(codes, lengths, k)
    R, P, W = canon.shape
    q = jnp.maximum(quals.astype(jnp.float32) - 33.0, 0.0)
    perr = jnp.where(q < 3.0, 0.75, jnp.power(10.0, -q / 10.0))
    lp = jnp.log1p(-perr)
    cs0 = jnp.concatenate([jnp.zeros((R, 1), jnp.float32),
                           jnp.cumsum(lp, axis=1)], axis=1)
    lp_inst = cs0[:, k:P + k] - cs0[:, :P]
    lq_inst = jnp.log1p(-jnp.minimum(jnp.exp(lp_inst), 1.0 - 1e-12))

    flat = canon.reshape(-1, W)
    fvalid = valid.reshape(-1)
    idx = segments.searchsorted_rows(tkmers, flat)
    U = total_lq.shape[0]
    ok = fvalid & (idx < tnum)
    sidx = jnp.where(ok, idx, U)
    total_lq = total_lq.at[sidx].add(lq_inst.reshape(-1), mode="drop")

    offs = jnp.arange(k)
    inst = jnp.arange(R * P, dtype=jnp.int32)
    rpos = inst // P
    ppos = inst % P
    fwd = is_fwd.reshape(-1)
    col = jnp.where(fwd[:, None], offs[None, :], (k - 1 - offs)[None, :])
    qv = q[rpos[:, None], ppos[:, None] + col]          # (R*P, k)
    qual_sum = qual_sum.at[
        sidx[:, None],
        jnp.broadcast_to(offs[None, :], (R * P, k))].add(qv, mode="drop")
    return total_lq, qual_sum


def count_kmers_stats_chunked(codes, lengths, quals, k: int,
                              chunk: int | None = None,
                              device_cap_rows: int | None = None
                              ) -> tuple[counter.KmerTable, KmerQualStats]:
    """`count_kmers_stats` for libraries too large for one device sort,
    as TWO passes (the reference streams disk buckets twice in spirit:
    kmer_data.cpp KMerDataCounter first builds the index, then fills
    per-k-mer statistics under locks, kmer_data.cpp:119-155):

    1. key-only chunked counting (counter.count_kmers_chunked — large
       chunks, cheap (key, count) device merges) builds the final
       sorted unique table;
    2. each read chunk's instances look up their table row (sorted-
       array searchsorted) and scatter-add ``total_lq`` / ``qual_sum``
       into accumulators preallocated at the final size.

    The round-4 design merged (N, k) quality matrices pairwise and
    spilled oversize accumulators to the host; at 4.6 Mb the merge work
    grew O(chunks x table) and every spill was a device->host pull of
    the accumulators. Two passes do O(R)
    scatter work, keep every byte on device, and need no spills until
    the (U, k) accumulator itself exceeds ``device_cap_rows`` rows —
    then the old merge/spill path runs instead."""
    from ..ops import chunking
    from ..utils import membudget
    codes = jnp.asarray(codes)
    lengths = jnp.asarray(lengths)
    quals = jnp.asarray(quals)
    if chunk is None:
        chunk = membudget.stats_chunk_reads(
            1 << 15, read_len=int(codes.shape[1]), k=k)
    if device_cap_rows is None:
        device_cap_rows = membudget.device_cap_rows(1 << 24, k=k)
    R = codes.shape[0]
    if R <= chunk:
        table, stats = count_kmers_stats(codes, lengths, quals, k)
        return _trim_stats(table, stats)
    table = counter.trim_table(
        counter.count_kmers_chunked(codes, lengths, k))
    if table.capacity > device_cap_rows:
        return _count_kmers_stats_chunked_spill(
            codes, lengths, quals, k, chunk, device_cap_rows)
    U = table.capacity
    total_lq = jnp.zeros((U,), jnp.float32)
    qual_sum = jnp.zeros((U, k), jnp.float32)
    codes_p = chunking.pad_to_multiple(codes, chunk, fill=4)
    lengths_p = chunking.pad_to_multiple(lengths, chunk)
    quals_p = chunking.pad_to_multiple(quals, chunk)
    for lo in range(0, R, chunk):
        c = chunking.dslice(codes_p, lo, chunk)
        l = chunking.dslice(lengths_p, lo, chunk)
        q = chunking.dslice(quals_p, lo, chunk)
        total_lq, qual_sum = _accum_stats(
            table.kmers, table.num, c, l, q, total_lq, qual_sum, k)
    qual_sum = jnp.minimum(qual_sum, float(QUAL_CAP))
    return table, KmerQualStats(total_lq=total_lq, qual_sum=qual_sum)


def _count_kmers_stats_chunked_spill(codes, lengths, quals, k: int,
                                     chunk: int, device_cap_rows: int
                                     ) -> tuple[counter.KmerTable,
                                                KmerQualStats]:
    """Round-4 merge/spill fallback for tables beyond HBM capacity."""
    from ..ops import chunking
    R = codes.shape[0]
    codes_p = chunking.pad_to_multiple(codes, chunk, fill=4)
    lengths_p = chunking.pad_to_multiple(lengths, chunk)
    quals_p = chunking.pad_to_multiple(quals, chunk)
    table = stats = None
    spills = []
    for lo in range(0, R, chunk):
        c = chunking.dslice(codes_p, lo, chunk)
        l = chunking.dslice(lengths_p, lo, chunk)
        q = chunking.dslice(quals_p, lo, chunk)
        t, s = count_kmers_stats(c, l, q, k)
        t, s = _trim_stats(t, s)
        if table is None:
            table, stats = t, s
        elif table.capacity + t.capacity > device_cap_rows:
            spills.append(_spill_to_host(table, stats))
            table, stats = t, s
        else:
            uniq, counts, mlq, mqs, num = _merge_stats_tables(
                table.kmers, table.counts, stats.total_lq,
                stats.qual_sum, table.num,
                t.kmers, t.counts, s.total_lq, s.qual_sum, t.num)
            table = counter.KmerTable(uniq, counts, num)
            stats = KmerQualStats(total_lq=mlq, qual_sum=mqs)
            table, stats = _trim_stats(table, stats)
    if spills:
        spills.append(_spill_to_host(table, stats))
        table, stats = _merge_spills_host(spills, k)
    return table, stats


@functools.partial(jax.jit,
                   static_argnames=("k", "max_l", "em_iters"))
def subcluster_kmers(kmers: jax.Array, counts: jax.Array, num: jax.Array,
                     stats: KmerQualStats, rep: jax.Array, k: int,
                     max_l: int = 4, em_iters: int = 4) -> SubClusters:
    """Bayesian subclustering of Hamming clusters (kmer_cluster.cpp).

    ``rep`` assigns each unique k-mer to its Hamming cluster (from
    cluster.cluster_kmers).  For every cluster, l-means with
    quality-aware likelihood runs for l = 1..max_l; BIC selects the
    best l; subcluster centers are quality-marked good/bad.
    """
    N, W = kmers.shape
    valid = jnp.arange(N) < num
    bases = dna.unpack_kmers(kmers, k).astype(jnp.int32)   # (N, k)
    lp, lrp = _qual_probs(stats.qual_sum)                  # (N, k)

    # dense cluster ids + count-descending rank within cluster
    # (clusters sorted in count-decreasing order, kmer_cluster.cpp:624)
    order = jnp.lexsort((jnp.arange(N), -counts,
                         jnp.where(valid, rep, N)))
    srep = jnp.where(valid, rep, N)[order]
    start = jnp.concatenate([jnp.ones((1,), bool),
                             srep[1:] != srep[:-1]])
    cid_sorted = jnp.cumsum(start.astype(jnp.int32)) - 1   # (N,)
    seg_first = jnp.where(start, jnp.arange(N), 0)
    seg_first = jax.lax.associative_scan(jnp.maximum, seg_first)
    rank_sorted = jnp.arange(N) - seg_first
    cid = jnp.zeros((N,), jnp.int32).at[order].set(cid_sorted)
    rank = jnp.zeros((N,), jnp.int32).at[order].set(rank_sorted)
    svalid = valid[order]
    csize = jnp.zeros((N,), jnp.int32).at[
        jnp.where(svalid, cid_sorted, N)].add(1, mode="drop")

    # candidate seed rows: top-max_l members by count (lMeansClustering
    # "we assume that kmers are sorted wrt the count", :154-156)
    cand = jnp.full((N, max_l), N, jnp.int32).at[
        jnp.where(valid & (rank < max_l), cid, N),
        jnp.minimum(rank, max_l - 1)].set(jnp.arange(N, dtype=jnp.int32),
                                          mode="drop")
    cand_safe = jnp.minimum(cand, N - 1)
    seed_bases = bases[cand_safe]                          # (N, max_l, k)

    total_cnt = jnp.zeros((N,), jnp.float32).at[
        jnp.where(valid, cid, N)].add(counts.astype(jnp.float32),
                                      mode="drop")
    log_total = jnp.log(jnp.maximum(total_cnt, 2.0))

    cidx_k = jnp.broadcast_to(jnp.arange(k)[None, :], (N, k))
    countsf = counts.astype(jnp.float32)

    def run_l(l: int):
        act = (jnp.arange(max_l)[None, :] < jnp.minimum(l, csize)[:, None])

        def em(_, centers):
            cb = centers[cid]                              # (N, max_l, k)
            match = cb == bases[:, None, :]
            logl = jnp.sum(jnp.where(match, lp[:, None, :],
                                     lrp[:, None, :]), axis=-1)
            logl = jnp.where(act[cid], logl, -jnp.inf)
            assign = jnp.argmax(logl, axis=-1).astype(jnp.int32)
            # M step: count-weighted per-position consensus
            # (ConsensusWithMask, kmer_cluster.cpp:49)
            scores = jnp.zeros((N, max_l, k, 4), jnp.float32).at[
                jnp.where(valid, cid, N)[:, None], assign[:, None],
                cidx_k, bases].add(countsf[:, None], mode="drop")
            new_c = jnp.argmax(scores, axis=-1).astype(jnp.int32)
            nonempty = scores.sum(axis=-1) > 0             # (N, max_l, k)
            return jnp.where(nonempty, new_c, centers)

        centers = jax.lax.fori_loop(0, em_iters, em, seed_bases)
        # final assignment + BIC
        cb = centers[cid]
        match = cb == bases[:, None, :]
        logl = jnp.sum(jnp.where(match, lp[:, None, :], lrp[:, None, :]),
                       axis=-1)
        logl = jnp.where(act[cid], logl, -jnp.inf)
        assign = jnp.argmax(logl, axis=-1).astype(jnp.int32)
        best = jnp.max(logl, axis=-1)
        wl = jnp.where(valid, countsf * best, 0.0)
        loglik = jnp.zeros((N,), jnp.float32).at[
            jnp.where(valid, cid, N)].add(wl, mode="drop")
        nparams = (l - 1) + 3 * l * k                      # ClusterBIC:112
        bic = loglik - nparams * log_total / 2.0
        # l > cluster size is not a real model
        bic = jnp.where(csize >= l, bic, -jnp.inf)
        return bic, assign, centers

    best_bic, best_assign, best_centers = run_l(1)
    for l in range(2, max_l + 1):
        bic, assign, centers = run_l(l)
        better = bic > best_bic
        best_bic = jnp.where(better, bic, best_bic)
        best_assign = jnp.where(better[cid], assign, best_assign)
        best_centers = jnp.where(better[:, None, None], centers,
                                 best_centers)

    # per-member consensus bases (the voting target)
    cons = best_centers[cid, best_assign]                  # (N, k)
    is_center = valid & jnp.all(cons == bases, axis=-1)
    # subcluster quality (ProcessCluster:513-519): center_quality from
    # the center member's total_qual; cluster_quality from the product
    # of the OTHER members' total_qual
    sub = jnp.where(valid, cid * max_l + best_assign, N * max_l)
    sub_lq = jnp.zeros((N * max_l,), jnp.float32).at[sub].add(
        jnp.where(valid, stats.total_lq, 0.0), mode="drop")
    center_lq = jnp.zeros((N * max_l,), jnp.float32).at[
        jnp.where(is_center, sub, N * max_l)].add(
        stats.total_lq, mode="drop")
    has_center = jnp.zeros((N * max_l,), bool).at[
        jnp.where(is_center, sub, N * max_l)].set(True, mode="drop")
    sub_n = jnp.zeros((N * max_l,), jnp.int32).at[sub].add(
        1, mode="drop")
    rest_lq = sub_lq - jnp.where(has_center, center_lq, 0.0)
    cluster_q = 1.0 - jnp.exp(rest_lq)                     # (N*max_l,)

    center_quality = 1.0 - jnp.exp(stats.total_lq)         # (N,)
    singleton_sub = sub_n[jnp.minimum(sub, N * max_l - 1)] == 1
    clq = jnp.where(singleton_sub, 1.0,
                    cluster_q[jnp.minimum(sub, N * max_l - 1)])
    good = ((center_quality > SINGLETON_THRESHOLD)
            & (clq > NONSINGLETON_THRESHOLD)) | (
        center_quality > CORRECT_THRESHOLD)
    solid = is_center & good
    return SubClusters(solid=solid, is_center=is_center,
                       center_bases=cons.astype(jnp.uint8),
                       rep=jnp.where(valid, rep, N))


@functools.partial(jax.jit, static_argnames=("k", "max_rounds"))
def expand_solid(codes: jax.Array, lengths: jax.Array,
                 table: counter.KmerTable, solid: jax.Array, k: int,
                 max_rounds: int = 8) -> jax.Array:
    """Iterative solid-set expansion (expander.cpp:17-70): every read
    whose positions are all covered by solid k-mers promotes its
    remaining k-mers to solid.  Runs the read loop as one batched
    windowed-OR per round (expand_max_iterations bounds the fixed
    point; coverage saturates in a few rounds on real data)."""
    R, L = codes.shape
    N = table.kmers.shape[0]
    canon, valid, _ = kmer.extract_canonical_kmers(codes, lengths, k)
    P = canon.shape[1]
    row = segments.searchsorted_rows(
        table.kmers, canon.reshape(-1, canon.shape[2])).reshape(R, P)
    found = (row < table.num) & valid
    safe_row = jnp.where(found, row, 0)
    in_read = jnp.arange(L)[None, :] < lengths[:, None]

    def round_(solid):
        good = solid[safe_row] & found                     # (R, P)
        # windowed OR: position t covered iff some good k-mer starts in
        # (t-k, t]; prefix-count difference gives the window sum
        gi = good.astype(jnp.int32)
        cs = jnp.concatenate([jnp.zeros((R, 1), jnp.int32),
                              jnp.cumsum(gi, axis=1)], axis=1)  # (R, P+1)
        t = jnp.arange(L)
        hi = jnp.minimum(t + 1, P)
        lo = jnp.maximum(t - (k - 1), 0)
        covered = (cs[:, hi] - cs[:, lo]) > 0              # (R, L)
        read_ok = jnp.all(covered | ~in_read, axis=1) & (lengths >= k)
        promote = found & read_ok[:, None]
        new_solid = solid.at[
            jnp.where(promote, safe_row, N)].max(promote, mode="drop")
        changed = jnp.sum((new_solid & ~solid).astype(jnp.int32))
        return new_solid, changed

    def cond(state):
        _, changed, it = state
        return (changed > 0) & (it < max_rounds)

    def body(state):
        solid, _, it = state
        new_solid, changed = round_(solid)
        return new_solid, changed, it + 1

    solid, _, _ = jax.lax.while_loop(
        cond, body, (solid, jnp.int32(1), jnp.int32(0)))
    return solid


def subcluster_kmers_chunked(kmers, counts, num, stats: KmerQualStats,
                             rep, k: int, max_l: int = 4,
                             em_iters: int = 4,
                             chunk: int = 1 << 18) -> SubClusters:
    """subcluster_kmers over cluster-aligned row chunks.

    The EM holds (N, max_l, k, 4) scatter-add scores; at multi-Mb scale
    (N ~ 4M unique k-mers) one pass needs tens of GB of device memory,
    and chunks bound it from above.  Subclustering is
    strictly intra-Hamming-cluster, so rows reordered by cluster id can
    split at cluster boundaries and each slice runs the exact same jit
    with bounded shapes — the chunked analogue of the reference
    processing clusters block-wise in parallel (kmer_cluster.cpp:624
    iterating cluster blocks).
    """
    import numpy as np
    from ..ops import chunking
    N = kmers.shape[0]
    if N <= chunk:
        return subcluster_kmers(kmers, counts, num, stats, rep, k,
                                max_l=max_l, em_iters=em_iters)
    n = int(num)
    # cluster-sorted order ON DEVICE (the old path pulled the whole
    # (N, k) quality matrix + keys to the host and pushed padded chunks
    # back — GBs of device<->host traffic at multi-Mb scale; here the
    # only transfers are the chunk boundaries, ~n/chunk ints)
    idx = jnp.arange(N, dtype=jnp.int32)
    valid = idx < n
    repc = jnp.where(valid, rep, jnp.int32(2 ** 30))
    order = jnp.lexsort((idx, -counts, repc))
    srep = repc[order]
    start_mask = jnp.concatenate([valid[:1],
                                  (srep[1:] != srep[:-1]) & (idx[1:] < n)])
    spos = jnp.nonzero(start_mask, size=N, fill_value=N)[0]
    bounds = [0]
    while bounds[-1] < n:
        t = bounds[-1] + chunk
        if t >= n:
            bounds.append(n)
            break
        j = int(jnp.searchsorted(spos, jnp.int32(t), side="right")) - 1
        cut = int(spos[max(j, 0)])             # scalar pull per chunk
        if cut <= bounds[-1]:      # one cluster larger than the chunk
            cut = t
        bounds.append(min(cut, n))

    # gather once into cluster order on device; pad one chunk of tail
    def ordered_padded(a, fill=0):
        out = a[order]
        pad_width = ((0, chunk),) + ((0, 0),) * (a.ndim - 1)
        return jnp.pad(out, pad_width,
                       constant_values=jnp.asarray(fill, dtype=a.dtype))

    kmers_o = ordered_padded(kmers, 0xFFFFFFFF)
    counts_o = ordered_padded(counts)
    lq_o = ordered_padded(stats.total_lq)
    qs_o = ordered_padded(stats.qual_sum)
    rep_o = ordered_padded(jnp.where(valid, rep, 0))
    order_p = jnp.pad(order, (0, chunk), constant_values=N)

    solid = jnp.zeros(N, bool)
    is_center = jnp.zeros(N, bool)
    center_bases = jnp.zeros((N, k), jnp.uint8)
    rep_out = jnp.full(N, N, jnp.int32)

    @functools.partial(jax.jit, static_argnames=(),
                       donate_argnums=(7, 8, 9, 10))
    def run_chunk(ko, co, lo_, qo, ro, op, start, solid, is_center,
                  center_bases, rep_out, m):
        kc = jax.lax.dynamic_slice_in_dim(ko, start, chunk)
        cc = jax.lax.dynamic_slice_in_dim(co, start, chunk)
        lc = jax.lax.dynamic_slice_in_dim(lo_, start, chunk)
        qc = jax.lax.dynamic_slice_in_dim(qo, start, chunk)
        rc = jax.lax.dynamic_slice_in_dim(ro, start, chunk)
        oc = jax.lax.dynamic_slice_in_dim(op, start, chunk)
        sub = subcluster_kmers(
            kc, cc, m, KmerQualStats(total_lq=lc, qual_sum=qc), rc, k,
            max_l=max_l, em_iters=em_iters)
        ok = jnp.arange(chunk) < m
        dest = jnp.where(ok, oc, N)
        solid = solid.at[dest].set(sub.solid, mode="drop")
        is_center = is_center.at[dest].set(sub.is_center, mode="drop")
        center_bases = center_bases.at[dest].set(sub.center_bases,
                                                 mode="drop")
        rep_out = rep_out.at[dest].set(rc, mode="drop")
        return solid, is_center, center_bases, rep_out

    for lo, hi in zip(bounds[:-1], bounds[1:]):
        solid, is_center, center_bases, rep_out = run_chunk(
            kmers_o, counts_o, lq_o, qs_o, rep_o, order_p,
            jnp.int32(lo), solid, is_center, center_bases, rep_out,
            jnp.int32(hi - lo))

    return SubClusters(solid=solid, is_center=is_center,
                       center_bases=center_bases, rep=rep_out)


@functools.partial(jax.jit, static_argnames=("k",))
def _expand_round(codes, lengths, table: counter.KmerTable, solid,
                  k: int):
    """One chunk-pass of the solid expander: per-k-mer promotion mask."""
    R, L = codes.shape
    N = table.kmers.shape[0]
    canon, valid, _ = kmer.extract_canonical_kmers(codes, lengths, k)
    P = canon.shape[1]
    row = segments.searchsorted_rows(
        table.kmers, canon.reshape(-1, canon.shape[2])).reshape(R, P)
    found = (row < table.num) & valid
    safe_row = jnp.where(found, row, 0)
    in_read = jnp.arange(L)[None, :] < lengths[:, None]
    good = solid[safe_row] & found
    gi = good.astype(jnp.int32)
    cs = jnp.concatenate([jnp.zeros((R, 1), jnp.int32),
                          jnp.cumsum(gi, axis=1)], axis=1)
    t = jnp.arange(L)
    hi = jnp.minimum(t + 1, P)
    lo = jnp.maximum(t - (k - 1), 0)
    covered = (cs[:, hi] - cs[:, lo]) > 0
    read_ok = jnp.all(covered | ~in_read, axis=1) & (lengths >= k)
    promote = found & read_ok[:, None]
    return jnp.zeros((N,), bool).at[
        jnp.where(promote, safe_row, N)].max(promote, mode="drop")


def expand_solid_chunked(codes, lengths, table: counter.KmerTable,
                         solid, k: int, max_rounds: int = 8,
                         chunk_reads: int = 1 << 18) -> jax.Array:
    """expand_solid with the read loop chunked (expander.cpp:17-70 run
    over binary read batches): each round streams fixed-shape read
    chunks, ORs their per-k-mer promotions, and stops at the fixed
    point.  Bounded (chunk, P) intermediates instead of (R, P)."""
    from ..ops import chunking
    codes = jnp.asarray(codes)
    lengths = jnp.asarray(lengths)
    R = codes.shape[0]
    if R <= chunk_reads:
        return expand_solid(codes, lengths, table, solid, k,
                            max_rounds=max_rounds)
    solid = jnp.asarray(solid)
    codes_p = chunking.pad_to_multiple(codes, chunk_reads, fill=4)
    lengths_p = chunking.pad_to_multiple(lengths, chunk_reads)
    for _ in range(max_rounds):
        promoted = jnp.zeros_like(solid)
        for lo in range(0, R, chunk_reads):
            c = chunking.dslice(codes_p, lo, chunk_reads)
            l = chunking.dslice(lengths_p, lo, chunk_reads)
            promoted = promoted | _expand_round(c, l, table, solid, k)
        new_solid = solid | promoted
        if not bool(jnp.any(new_solid & ~solid)):
            break
        solid = new_solid
    return solid
