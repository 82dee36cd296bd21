"""Read error correction by solid-k-mer voting (BayesHammer's corrector).

Device-side replacement of projects/hammer's read correction loop
(read_corrector.cpp:19 + expander.cpp:17): every read position gathers
votes from all k-mers covering it — a solid k-mer votes its own bases, an
erroneous k-mer votes its cluster center's bases — and the majority base
wins. The whole read batch corrects in one jit region of gathers and a
(R, L, 4) scatter-add, replacing the per-read OpenMP loop.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kmers import counter, coverage_model
from ..ops import dna, kmer, segments
from ..utils.logger import get_logger
from .cluster import HammerClusters, cluster_kmers

_log = get_logger("Hammer")


class CorrectionResult(NamedTuple):
    codes: jax.Array          # corrected read codes
    changed_bases: jax.Array  # () int32
    solid_kmers: jax.Array    # () int32 number of solid unique kmers


@functools.partial(jax.jit, static_argnames=("k",))
def correct_batch(codes: jax.Array, lengths: jax.Array,
                  table: counter.KmerTable, clusters: HammerClusters,
                  k: int) -> CorrectionResult:
    R, L = codes.shape
    N = table.capacity
    canon, valid, is_fwd = kmer.extract_canonical_kmers(codes, lengths, k)
    P = canon.shape[1]
    W = canon.shape[2]
    flat = canon.reshape(-1, W)
    row = segments.searchsorted_rows(table.kmers, flat).reshape(R, P)
    found = (row < table.num) & valid
    safe_row = jnp.where(found, row, 0)

    solid = clusters.solid[safe_row] & found
    center_row = clusters.center_of[safe_row]
    has_center = found & (center_row < N)
    vote_row = jnp.where(solid, safe_row, jnp.minimum(center_row, N - 1))
    can_vote = solid | has_center

    vk = table.kmers[vote_row]                      # (R, P, W) canonical
    # orient the voting k-mer the way the read runs
    vk_rc = dna.revcomp_kmers(vk, k)
    vk = jnp.where(is_fwd[..., None], vk, vk_rc)
    bases = dna.unpack_kmers(vk, k)                 # (R, P, k)

    pos = jnp.arange(P)[:, None] + jnp.arange(k)[None, :]      # (P, k)
    read_id = jnp.broadcast_to(jnp.arange(R)[:, None, None], (R, P, k))
    votes = jnp.zeros((R, L, 4), jnp.int32)
    scatter_pos = jnp.where(can_vote[..., None], pos[None, :, :], L)
    votes = votes.at[read_id, scatter_pos, bases.astype(jnp.int32)].add(
        1, mode="drop")

    best = jnp.argmax(votes, axis=-1).astype(jnp.uint8)
    vote_total = jnp.sum(votes, axis=-1)
    vote_max = jnp.max(votes, axis=-1)
    # adopt the majority base only with unambiguous support
    decided = (vote_max * 2 > vote_total) & (vote_total > 0)
    in_read = jnp.arange(L)[None, :] < lengths[:, None]
    was_valid = codes < dna.INVALID_CODE
    out = jnp.where(decided & in_read, best, codes)
    out = jnp.where(in_read, out, codes)
    changed = jnp.sum((out != codes) & was_valid & in_read)
    return CorrectionResult(out, changed.astype(jnp.int32),
                            jnp.sum(clusters.solid.astype(jnp.int32)))


@functools.partial(jax.jit, static_argnames=("k",))
def correct_batch_bayes(codes: jax.Array, lengths: jax.Array,
                        table: counter.KmerTable, solid: jax.Array,
                        center_bases: jax.Array, k: int
                        ) -> CorrectionResult:
    """Voting correction driven by the Bayesian subclustering: a solid
    k-mer votes its own bases; a bad k-mer votes its subcluster's
    consensus bases (kmer_cluster.cpp centers) — a bad k-mer that IS
    its own consensus carries no signal and abstains (the reference's
    bad k-mers never vote at all)."""
    R, L = codes.shape
    canon, valid, is_fwd = kmer.extract_canonical_kmers(codes, lengths, k)
    P = canon.shape[1]
    flat = canon.reshape(-1, canon.shape[2])
    row = segments.searchsorted_rows(table.kmers, flat).reshape(R, P)
    found = (row < table.num) & valid
    safe_row = jnp.where(found, row, 0)

    is_solid = solid[safe_row] & found                     # (R, P)
    own = dna.unpack_kmers(canon.reshape(-1, canon.shape[2]),
                           k).reshape(R, P, k)
    cons = center_bases[safe_row]                          # (R, P, k)
    corrects = jnp.any(cons != own, axis=-1)
    vote_canon = jnp.where(is_solid[..., None], own, cons)
    # orient canonical vote bases along the read
    vote_rc = (3 - vote_canon[..., ::-1]) & 3
    bases = jnp.where(is_fwd[..., None], vote_canon, vote_rc)
    can_vote = found & (is_solid | corrects)

    pos = jnp.arange(P)[:, None] + jnp.arange(k)[None, :]
    read_id = jnp.broadcast_to(jnp.arange(R)[:, None, None], (R, P, k))
    votes = jnp.zeros((R, L, 4), jnp.int32)
    scatter_pos = jnp.where(can_vote[..., None], pos[None, :, :], L)
    votes = votes.at[read_id, scatter_pos, bases.astype(jnp.int32)].add(
        1, mode="drop")

    best = jnp.argmax(votes, axis=-1).astype(jnp.uint8)
    vote_total = jnp.sum(votes, axis=-1)
    vote_max = jnp.max(votes, axis=-1)
    decided = (vote_max * 2 > vote_total) & (vote_total > 0)
    in_read = jnp.arange(L)[None, :] < lengths[:, None]
    was_valid = codes < dna.INVALID_CODE
    out = jnp.where(decided & in_read, best, codes)
    out = jnp.where(in_read, out, codes)
    changed = jnp.sum((out != codes) & was_valid & in_read)
    return CorrectionResult(out, changed.astype(jnp.int32),
                            jnp.sum(solid.astype(jnp.int32)))


_CHUNK = 1 << 15  # reads per correction chunk: bounds (R, P, k) scatters


def _run_chunked(fn, codes, lengths, chunk=_CHUNK):
    """Apply a per-read jitted correction over fixed-shape read chunks.

    ``fn(codes_chunk, lengths_chunk) -> CorrectionResult``; votes and
    fixes are per-read, so chunks are independent (the reference's
    OpenMP read loop, read_corrector.cpp:19).  Chunk outputs stay on
    the device (concatenated there), with no host round trip per
    chunk."""
    from ..ops import chunking
    R = codes.shape[0]
    if R <= chunk:
        return fn(codes, lengths)
    # pad once, slice with a traced offset: one compile per shape, not
    # one per chunk offset
    codes_p = chunking.pad_to_multiple(codes, chunk, fill=4)
    lengths_p = chunking.pad_to_multiple(lengths, chunk)
    outs, changed, solid = [], [], 0
    for lo in range(0, R, chunk):
        c = chunking.dslice(codes_p, lo, chunk)
        l = chunking.dslice(lengths_p, lo, chunk)
        res = fn(c, l)
        outs.append(res.codes)
        changed.append(res.changed_bases)
        solid = res.solid_kmers
    total_changed = jnp.sum(jnp.stack(changed)).astype(jnp.int32)
    return CorrectionResult(jnp.concatenate(outs)[:R], total_changed,
                            solid)


def correct_reads(codes, lengths, k: int = 21, max_iterations: int = 2,
                  center_ratio: float = 10.0, quals=None,
                  bayes: bool = True):
    """Iterative BayesHammer-style correction (main loop,
    projects/hammer/main.cpp:55): count -> cluster -> correct until no
    changes or max_iterations.

    With ``quals`` (raw phred+33) and ``bayes`` (the default), the full
    statistical pipeline runs: per-position quality statistics,
    Bayesian l-means subclustering with BIC model selection
    (kmer_cluster.cpp), and the read-driven solid-set expander
    (expander.cpp:17).  Without qualities the count-based center-ratio
    heuristic is the fallback.

    Returns (corrected_codes np.ndarray, stats dict).
    """
    if quals is not None and bayes:
        from ..parallel import mesh as mesh_mod
        mesh = mesh_mod.auto_mesh()
        if mesh is not None:
            # multi-device: data-parallel hammer (the OpenMP analogue,
            # projects/hammer/main.cpp:64) — equality with the single-
            # device path is test-gated (tests/test_hammer_dist.py)
            from ..parallel import hammer_dist
            correct_fn = hammer_dist.make_sharded_hammer(
                mesh, k, max_iterations=max_iterations)
            R = codes.shape[0]
            corrected, stats = correct_fn(codes, lengths, quals)
            return corrected[:R], stats
        return _correct_reads_bayes(codes, lengths, quals, k,
                                    max_iterations)
    import jax as _jax
    codes = jnp.asarray(codes)
    lengths = jnp.asarray(lengths)
    if quals is not None:
        quals = jnp.asarray(quals)
    total_changed = 0
    stats = {}
    for it in range(max_iterations):
        if quals is not None:
            table, qweight = counter.count_kmers_quality(
                codes, lengths, quals, k)
            # trim to pow2 unique capacity: clustering shapes must
            # scale with distinct k-mers, not the R*P raw stream
            cap = counter.trim_table(table).capacity
            qweight = qweight[:cap]
            table = counter.KmerTable(table.kmers[:cap],
                                      table.counts[:cap], table.num)
            cluster_counts = jnp.round(qweight).astype(jnp.int32)
        else:
            table = counter.trim_table(counter.count_kmers(
                codes, lengths, k))
            cluster_counts = table.counts
        ginfo = coverage_model.fit_coverage_model_hist(
            coverage_model.count_spectrum_device(cluster_counts,
                                                 table.num))
        good_thr = max(ginfo.ec_bound, 2.0)
        clusters = cluster_kmers(
            table.kmers, cluster_counts, table.num, k,
            jnp.int32(int(good_thr)), jnp.float32(center_ratio))
        res = _run_chunked(
            lambda c, l: correct_batch(c, l, table, clusters, k),
            codes, lengths)
        changed = int(res.changed_bases)
        total_changed += changed
        stats = {"iterations": it + 1, "changed_bases": total_changed,
                 "solid_kmers": int(res.solid_kmers),
                 "good_threshold": good_thr}
        codes = res.codes
        if changed == 0:
            break
    # stays a device array: downstream stages consume it on device
    return codes, stats


def _correct_reads_bayes(codes, lengths, quals, k: int,
                         max_iterations: int):
    """count -> Hamming cluster -> Bayesian subcluster -> expand ->
    correct, iterated (projects/hammer/main.cpp:118-260 with
    count_do/cluster_do/bayes_do/expand_do/correct_do all on)."""
    from . import bayes
    from ..utils.timetrace import scope as _scope
    codes = jnp.asarray(codes)
    lengths = jnp.asarray(lengths)
    quals = jnp.asarray(quals)
    total_changed = 0
    stats = {}
    for it in range(max_iterations):
        # chunked count: bounded (R*P)-row sorts; trimmed to pow2
        # unique capacity so the subclustering EM's (N, max_l, k, 4)
        # scores scale with distinct k-mers, not the raw stream
        with _scope("hammer_count", it=it):
            table, qstats = bayes.count_kmers_stats_chunked(
                codes, lengths, quals, k)
        with _scope("hammer_cluster", it=it):
            clusters = cluster_kmers(
                table.kmers, table.counts, table.num, k,
                jnp.int32(2 ** 30), jnp.float32(0.0))  # topology only
        with _scope("hammer_subcluster", it=it):
            sub = bayes.subcluster_kmers_chunked(
                table.kmers, table.counts, table.num, qstats,
                clusters.rep, k)
        with _scope("hammer_expand", it=it):
            solid = bayes.expand_solid_chunked(
                codes, lengths, table, sub.solid, k)
        with _scope("hammer_vote", it=it):
            res = _run_chunked(
                lambda c, l: correct_batch_bayes(c, l, table, solid,
                                                 sub.center_bases, k),
                codes, lengths)
        changed = int(res.changed_bases)
        total_changed += changed
        stats = {"iterations": it + 1, "changed_bases": total_changed,
                 "solid_kmers": int(jnp.sum(solid)),
                 "mode": "bayes"}
        _log.debug(f"iteration {it + 1}: {changed} bases changed, "
                   f"{stats['solid_kmers']} solid k-mers")
        codes = res.codes
        if changed == 0:
            break
    # stays a device array: downstream stages consume it on device
    return codes, stats
