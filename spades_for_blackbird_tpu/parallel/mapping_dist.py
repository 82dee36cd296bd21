"""Sharded read mapping + paired-info fill over a device mesh.

Device-side replacement for the reference's core parallel engine — the
read-processing fan-out of ``SequenceMapperNotifier``
(assembler/src/common/modules/alignment/sequence_mapper_notifier.hpp:25-100:
an OpenMP loop over binary read chunks, per-thread listener buffers,
merge).  Mapping is embarrassingly data-parallel: reads shard over the
mesh's reads axis, the edge k-mer index replicates (it is O(graph), a few
hundred MB at bacterial scale), and each chip maps its shard with the
SAME jitted `map_reads_multi` program as the single-chip path.  The
paired-info "listener merge" is the per-shard sorted unique
(e1, e2, dist, weight) table concatenated and re-reduced — the exact
array analogue of per-thread buffer merging.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..mapping import mapper
from ..paired import pair_info
from .mesh import READS_AXIS


def _shard_pad(mesh: Mesh, codes, lengths):
    """Pad R to a mesh multiple; returns host arrays + original R."""
    D = mesh.shape[READS_AXIS]
    codes = np.asarray(codes)
    lengths = np.asarray(lengths)
    R = codes.shape[0]
    pad = (-R) % D
    if pad:
        codes = np.concatenate(
            [codes, np.full((pad, codes.shape[1]), 4, codes.dtype)])
        lengths = np.concatenate([lengths, np.zeros((pad,), lengths.dtype)])
    return codes, lengths, R


def map_reads_multi_sharded(mesh: Mesh, index, seq_len, conj,
                            codes, lengths, k: int,
                            max_placements: int = 4, min_votes: int = 2
                            ) -> mapper.ChainMapping:
    """Data-parallel `map_reads_multi` + `normalize_chain` over the mesh.

    The index/seq_len/conj close over the shard body and replicate; read
    arrays shard over the reads axis.  Returns host-side ChainMapping
    trimmed to the original R (same interface as mapping/chunked.py).
    """
    codes_h, lengths_h, R = _shard_pad(mesh, codes, lengths)

    def per_shard(c, l):
        ch = mapper.map_reads_multi(index, seq_len, c, l, k,
                                    max_placements=max_placements,
                                    min_votes=min_votes)
        ch = mapper.normalize_chain(ch, conj)
        return (ch.oriented_edge, ch.start, ch.votes, ch.chain_len,
                ch.mapped)

    sharded = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(READS_AXIS, None), P(READS_AXIS)),
        out_specs=(P(READS_AXIS, None), P(READS_AXIS, None),
                   P(READS_AXIS, None), P(READS_AXIS), P(READS_AXIS)),
        check_vma=False)
    from .mesh import shard_reads
    sc, sl = shard_reads(mesh, codes_h, lengths_h)
    oe, st, vo, cl, mp = jax.jit(sharded)(sc, sl)
    return mapper.ChainMapping(
        oriented_edge=jnp.asarray(np.asarray(oe)[:R]),
        start=jnp.asarray(np.asarray(st)[:R]),
        votes=jnp.asarray(np.asarray(vo)[:R]),
        chain_len=jnp.asarray(np.asarray(cl)[:R]),
        mapped=jnp.asarray(np.asarray(mp)[:R]))


def fill_paired_index_sharded(mesh: Mesh, ch1, ch2, is_shift
                              ) -> pair_info.PairedIndex:
    """`fill_paired_index_multi` with read pairs sharded over the mesh.

    Each shard reduces its pairs to a local sorted unique table inside
    shard_map (the per-thread listener buffer); the global index is the
    concat + re-count of the D shard tables (the merge step).  Weights
    stay exact — identical output to the single-device fill.
    """
    D = mesh.shape[READS_AXIS]
    R = ch1.oriented_edge.shape[0]
    pad = (-R) % D

    def padc(ch):
        if pad == 0:
            return ch
        return pair_info._chain_slice(ch, 0, R, R + pad)

    c1, c2 = padc(ch1), padc(ch2)

    def per_shard(oe1, st1, vo1, cl1, mp1, oe2, st2, vo2, cl2, mp2, shift):
        a = mapper.ChainMapping(oe1, st1, vo1, cl1, mp1)
        b = mapper.ChainMapping(oe2, st2, vo2, cl2, mp2)
        pi = pair_info.fill_paired_index_multi(a, b, shift[0])
        return (pi.e1, pi.e2, pi.dist, pi.weight, pi.num[None])

    rspec = P(READS_AXIS, None)
    vspec = P(READS_AXIS)
    sharded = shard_map(
        per_shard, mesh=mesh,
        in_specs=(rspec, rspec, rspec, vspec, vspec,
                  rspec, rspec, rspec, vspec, vspec, P()),
        out_specs=(vspec, vspec, vspec, vspec, vspec),
        check_vma=False)
    from jax.sharding import NamedSharding
    shr = NamedSharding(mesh, P(READS_AXIS, None))
    shv = NamedSharding(mesh, P(READS_AXIS))

    def put(ch):
        return mapper.ChainMapping(
            jax.device_put(ch.oriented_edge, shr),
            jax.device_put(ch.start, shr),
            jax.device_put(ch.votes, shr),
            jax.device_put(ch.chain_len, shv),
            jax.device_put(ch.mapped, shv))

    c1, c2 = put(c1), put(c2)
    shift = jnp.asarray([is_shift], jnp.int32)
    e1, e2, d, w, nums = jax.jit(sharded)(
        c1.oriented_edge, c1.start, c1.votes, c1.chain_len, c1.mapped,
        c2.oriented_edge, c2.start, c2.votes, c2.chain_len, c2.mapped,
        shift)

    # merge the D per-shard unique tables (each sorted + padded locally)
    nums_h = np.asarray(nums)
    per = e1.shape[0] // D
    parts = []
    for i in range(D):
        n = int(nums_h[i])
        sl = slice(i * per, i * per + max(n, 1))
        parts.append(pair_info.PairedIndex(
            e1=jnp.asarray(np.asarray(e1)[sl]),
            e2=jnp.asarray(np.asarray(e2)[sl]),
            dist=jnp.asarray(np.asarray(d)[sl]),
            weight=jnp.asarray(np.asarray(w)[sl]),
            num=jnp.int32(n)))
    return pair_info.merge_paired_indices(parts)
