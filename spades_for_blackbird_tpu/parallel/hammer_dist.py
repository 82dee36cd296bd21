"""Distributed BayesHammer error correction over a device mesh.

The reference parallelizes hammer with OpenMP inside one shared-memory
node (projects/hammer/main.cpp:64 omp counting, kmer_data.cpp
KMerDataCounter's locked Merge, expander.cpp's parallel read loop). The
device-side equivalent shards the READ axis over the mesh and keeps the
k-mer table replicated:

1. **table**: each shard counts its reads locally (one fused sort),
   pow2-trims, ``all_gather``s the per-shard tables and merges them
   identically on every device — a replicated global sorted table
   (table bytes are ~1% of read bytes);
2. **stats**: each shard scatter-adds its instances' quality stats into
   final-size accumulators via sorted-table lookup (the two-pass design
   of hammer/bayes.py), then one ``psum`` replicates the totals — the
   collectivized form of kmer_data.cpp:119-155 Merge;
3. **cluster/subcluster**: replicated compute on the replicated table
   (identical on every device, no communication);
4. **expand**: per-round promotions are per-shard read scans OR-reduced
   with ``psum`` until the global fixed point (expander.cpp:17-70);
5. **vote/correct**: embarrassingly data-parallel — each shard corrects
   its own reads against the replicated table/solid-set/centers.

Per-device HBM holds reads/D + the full table, matching the
reference's shared-memory model; sharding the table itself (hash-
partitioned, as parallel/kmer_exchange.py does for construction) is
only needed when the table outgrows one device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..hammer import correct as hcorrect
from ..hammer import bayes
from ..hammer.cluster import cluster_kmers
from ..kmers import counter
from ..ops import segments
from . import mesh as mesh_mod

AXIS = mesh_mod.READS_AXIS


def _merge_gathered(allk, allc, allnums):
    """Merge D gathered per-shard sorted tables into one sorted unique
    table (replicated: every device computes the same merge)."""
    D, cap, W = allk.shape
    rows = allk.reshape(D * cap, W)
    weights = allc.reshape(D * cap)
    valid = (jnp.arange(cap)[None, :] < allnums[:, None]).reshape(-1)
    uniq, counts, num = segments.count_sorted(rows, valid, weights)
    return uniq, counts.astype(jnp.int32), num


def make_sharded_hammer(mesh: Mesh, k: int, max_iterations: int = 2):
    """Build ``correct(codes, lengths, quals) -> (codes, stats)`` with
    reads sharded over *mesh* (semantics of hammer/correct.py
    _correct_reads_bayes)."""
    D = mesh.shape[AXIS]
    repl = NamedSharding(mesh, P())

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS)),
        out_specs=(P(), P(), P()), check_vma=False)
    def count_table(codes, lengths):
        # no pow2 trim here: trim needs a concrete num, and shard_map
        # traces — per-shard capacity stays R/D * P (fixed shape)
        t = counter.count_kmers(codes, lengths, k)
        allk = jax.lax.all_gather(t.kmers, AXIS)
        allc = jax.lax.all_gather(t.counts, AXIS)
        alln = jax.lax.all_gather(t.num, AXIS)
        return _merge_gathered(allk, allc, alln)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(AXIS, None), P(AXIS), P(AXIS, None)),
        out_specs=(P(), P()), check_vma=False)
    def stats_psum(tkmers, tnum, codes, lengths, quals):
        U = tkmers.shape[0]
        lq = jnp.zeros((U,), jnp.float32)
        qs = jnp.zeros((U, k), jnp.float32)
        lq, qs = bayes._accum_stats(tkmers, tnum, codes, lengths,
                                    quals, lq, qs, k)
        return (jax.lax.psum(lq, AXIS), jax.lax.psum(qs, AXIS))

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS), P(), P(), P(), P()),
        out_specs=P(), check_vma=False)
    def expand_round(codes, lengths, tkmers, tcounts, tnum, solid):
        table = counter.KmerTable(tkmers, tcounts, tnum)
        promoted = bayes._expand_round(codes, lengths, table, solid, k)
        return jax.lax.psum(promoted.astype(jnp.int32), AXIS) > 0

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS), P(), P(), P(), P(), P()),
        out_specs=(P(AXIS, None), P()), check_vma=False)
    def vote(codes, lengths, tkmers, tcounts, tnum, solid, centers):
        table = counter.KmerTable(tkmers, tcounts, tnum)
        res = hcorrect.correct_batch_bayes(codes, lengths, table,
                                           solid, centers, k)
        return res.codes, jax.lax.psum(res.changed_bases, AXIS)

    def correct(codes, lengths, quals):
        import numpy as np
        R = codes.shape[0]
        codes, lengths = mesh_mod.shard_reads(mesh, codes, lengths)
        pad = codes.shape[0] - R
        if pad:
            quals = np.concatenate(
                [np.asarray(quals),
                 np.zeros((pad, quals.shape[1]), np.asarray(quals).dtype)])
        quals = jax.device_put(
            jnp.asarray(quals), NamedSharding(mesh, P(AXIS, None)))
        total_changed = 0
        stats: dict = {}
        for it in range(max_iterations):
            tkmers, tcounts, tnum = count_table(codes, lengths)
            lq, qs = stats_psum(tkmers, tnum, codes, lengths, quals)
            qs = jnp.minimum(qs, float(bayes.QUAL_CAP))
            qstats = bayes.KmerQualStats(total_lq=lq, qual_sum=qs)
            clusters = cluster_kmers(
                tkmers, tcounts, tnum, k, jnp.int32(2 ** 30),
                jnp.float32(0.0))
            sub = bayes.subcluster_kmers_chunked(
                tkmers, tcounts, tnum, qstats, clusters.rep, k)
            solid = jax.device_put(sub.solid, repl)
            centers = jax.device_put(sub.center_bases, repl)
            for _ in range(8):  # expander.cpp expand_max_iterations
                new_solid = solid | expand_round(
                    codes, lengths, tkmers, tcounts, tnum, solid)
                if not bool(jnp.any(new_solid & ~solid)):
                    break
                solid = new_solid
            codes, changed = vote(codes, lengths, tkmers, tcounts,
                                  tnum, solid, centers)
            changed = int(changed)
            total_changed += changed
            stats = {"iterations": it + 1,
                     "changed_bases": total_changed,
                     "solid_kmers": int(jnp.sum(solid)),
                     "mode": "bayes"}
            if changed == 0:
                break
        return codes, stats

    return correct
