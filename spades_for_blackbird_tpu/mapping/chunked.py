"""Chunked read-to-graph mapping: fixed-shape chunks, host concatenation.

The reference streams reads through mappers in binary-reader chunks
(common/alignment/sequence_mapper_notifier.hpp:66 ProcessLibrary over
chunked readers); the equivalent here slices the read batch into
fixed-size chunks so each `map_reads` call compiles once and its (R, P)
k-mer-vote intermediates stay bounded regardless of library size —
a 28M-read library must never materialize a 2.8G-row sort.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops import chunking
from . import mapper

# Default chunk: 2^16 reads x ~100bp -> ~6.5M votes per chunk, well
# within one chip's HBM next to the edge index.
DEFAULT_CHUNK = 1 << 16


def map_reads_chunked(index, seq_len, codes, lengths, k: int,
                      chunk: int = DEFAULT_CHUNK) -> mapper.ReadMapping:
    """`mapper.map_reads` over fixed-size chunks; one compile, bounded
    intermediates. Returns host-concatenated per-read fields."""
    codes = jnp.asarray(codes)
    lengths = jnp.asarray(lengths)
    R = codes.shape[0]
    if R <= chunk:
        return mapper.map_reads(index, seq_len, codes, lengths, k)
    # chunk outputs stay on the device (device concat): no per-chunk
    # host round trip of the (R,) result columns
    codes_p = chunking.pad_to_multiple(codes, chunk)
    lengths_p = chunking.pad_to_multiple(lengths, chunk)
    fields = {"oriented_edge": [], "start": [], "votes": [], "mapped": []}
    for lo in range(0, R, chunk):
        c = chunking.dslice(codes_p, lo, chunk)
        l = chunking.dslice(lengths_p, lo, chunk)
        m = mapper.map_reads(index, seq_len, c, l, k)
        for name in fields:
            fields[name].append(getattr(m, name))
    return mapper.ReadMapping(
        **{name: jnp.concatenate(v)[:R] for name, v in fields.items()})


def map_reads_multi_chunked(index, seq_len, codes, lengths, k: int,
                            max_placements: int = 4, min_votes: int = 2,
                            chunk: int = DEFAULT_CHUNK
                            ) -> mapper.ChainMapping:
    """`mapper.map_reads_multi` over fixed-size chunks."""
    codes = jnp.asarray(codes)
    lengths = jnp.asarray(lengths)
    R = codes.shape[0]
    if R <= chunk:
        return mapper.map_reads_multi(index, seq_len, codes, lengths, k,
                                      max_placements=max_placements,
                                      min_votes=min_votes)
    codes_p = chunking.pad_to_multiple(codes, chunk)
    lengths_p = chunking.pad_to_multiple(lengths, chunk)
    fields = {"oriented_edge": [], "start": [], "votes": [],
              "chain_len": [], "mapped": []}
    for lo in range(0, R, chunk):
        c = chunking.dslice(codes_p, lo, chunk)
        l = chunking.dslice(lengths_p, lo, chunk)
        m = mapper.map_reads_multi(index, seq_len, c, l, k,
                                   max_placements=max_placements,
                                   min_votes=min_votes)
        for name in fields:
            fields[name].append(getattr(m, name))
    return mapper.ChainMapping(
        **{name: jnp.concatenate(v)[:R] for name, v in fields.items()})
