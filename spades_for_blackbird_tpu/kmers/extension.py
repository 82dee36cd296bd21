"""Extension index: canonical k-mer vertex table with in/out nucleotide masks.

Device-side equivalent of the reference's ``DeBruijnExtensionIndex`` /
``InOutMask`` (assembler/src/common/utils/extension_index/
kmer_extension_index.hpp:42-200) and its builder
(kmer_extension_index_builder.hpp:19-110): from the unique (k+1)-mer table,
derive the k-mer set and an 8-bit mask per canonical k-mer (low 4 bits =
outgoing nucleotides in canonical orientation, high 4 bits = incoming).

Orientation convention (mirrors the reference's conjugation-by-mask
transform at kmer_extension_index.hpp:19-40): a k-mer traversed in its
non-canonical orientation has out-mask = bit-reversed in-mask of the
canonical record (bit c <-> bit 3-c), and vice versa.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import dna, segments
from .counter import KmerTable


class VertexTable(NamedTuple):
    """Sorted canonical k-mers with extension masks (padded ragged).

    kmers: (N, W) uint32 sorted canonical k-mers (all-ones padding).
    out_mask: (N,) uint8 — bit c set iff canonical k-mer extends right
      with base c.
    in_mask: (N,) uint8 — bit c set iff base c precedes the canonical
      k-mer.
    num: () int32.
    """
    kmers: jax.Array
    out_mask: jax.Array
    in_mask: jax.Array
    num: jax.Array

    @property
    def capacity(self) -> int:
        return self.kmers.shape[0]


def reverse4(mask: jax.Array) -> jax.Array:
    """Reverse a 4-bit nucleotide mask: bit c <-> bit 3-c (== complement)."""
    m = mask.astype(jnp.uint32)
    out = ((m & 1) << 3) | ((m & 2) << 1) | ((m & 4) >> 1) | ((m & 8) >> 3)
    return out.astype(mask.dtype)


def oriented_out_mask(vt: VertexTable, idx: jax.Array, is_fwd: jax.Array
                      ) -> jax.Array:
    """Out-mask of vertex ``idx`` traversed with orientation ``is_fwd``."""
    return jnp.where(is_fwd, vt.out_mask[idx], reverse4(vt.in_mask[idx]))


def oriented_in_mask(vt: VertexTable, idx: jax.Array, is_fwd: jax.Array
                     ) -> jax.Array:
    return jnp.where(is_fwd, vt.in_mask[idx], reverse4(vt.out_mask[idx]))


def popcount4(mask: jax.Array) -> jax.Array:
    m = mask.astype(jnp.int32)
    return (m & 1) + ((m >> 1) & 1) + ((m >> 2) & 1) + ((m >> 3) & 1)


def kplus1_prefix_suffix(kp1: jax.Array, k: int
                         ) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Split packed (k+1)-mers (N, W1) into prefix/suffix k-mers.

    Returns (prefix (N, W), suffix (N, W), first_base (N,), last_base (N,)).
    """
    first = dna.kmer_first_base(kp1, k + 1)
    last = dna.kmer_last_base(kp1, k + 1)
    # word-level bit surgery instead of unpack->slice->repack: the
    # unpacked (N, 16*W1) uint32 intermediates are ~64 bytes/row x two
    # packs — multi-GB device temporaries at multi-Mb (k+1)-mer tables.
    # Layout (ops/dna.pack_kmers): base j of word w at bits
    # (15 - j) * 2 .. +1, base 0 in the high bits, pad bases zero.
    import numpy as np
    W = dna.words_per_kmer(k)
    keep = np.minimum(np.maximum(k - dna.BASES_PER_WORD
                                 * np.arange(W), 0),
                      dna.BASES_PER_WORD)
    mask = jnp.asarray(np.array(
        [0xFFFFFFFF if kp == dna.BASES_PER_WORD
         else ((0xFFFFFFFF << (32 - 2 * int(kp))) & 0xFFFFFFFF)
         for kp in keep], dtype=np.uint32))
    # prefix = first k bases: original words masked to k bases
    prefix = kp1[..., :W] & mask
    # suffix = bases 1..k: 2-bit left shift with cross-word carry
    nxt = jnp.concatenate(
        [kp1[..., 1:],
         jnp.zeros(kp1.shape[:-1] + (1,), jnp.uint32)], axis=-1)
    shifted = ((kp1 << jnp.uint32(2))
               | (nxt >> jnp.uint32(30))).astype(jnp.uint32)
    suffix = shifted[..., :W] & mask
    return prefix, suffix, first, last


@functools.partial(jax.jit, static_argnames=("k",))
def build_vertex_table(kp1_table: KmerTable, k: int) -> VertexTable:
    """(k+1)-mer table -> canonical k-mer vertex table with masks.

    Follows kmer_extension_index_builder.hpp:45-60: every unique (k+1)-mer
    ``s`` contributes out-base s[k] to its prefix k-mer and in-base s[0] to
    its suffix k-mer, redirected through canonicalization.
    """
    E = kp1_table.capacity
    kp1_valid = jnp.arange(E) < kp1_table.num
    prefix, suffix, first, last = kplus1_prefix_suffix(kp1_table.kmers, k)

    cpre, pre_fwd = dna.canonicalize_kmers(prefix, k)
    csuf, suf_fwd = dna.canonicalize_kmers(suffix, k)

    # Unique canonical k-mers from both halves.
    all_k = jnp.concatenate([cpre, csuf], axis=0)
    all_valid = jnp.concatenate([kp1_valid, kp1_valid])
    uniq, _, num = segments.count_sorted(all_k, all_valid)

    # Mask contributions. Column layout of the scatter target: 0..3 = out
    # bits, 4..7 = in bits.
    pre_idx = segments.searchsorted_rows(uniq, cpre)
    suf_idx = segments.searchsorted_rows(uniq, csuf)
    N = uniq.shape[0]

    # prefix rule: canonical -> out bit last; else -> in bit comp(last)
    pre_col = jnp.where(pre_fwd, last.astype(jnp.int32),
                        4 + (3 - last.astype(jnp.int32)))
    # suffix rule: canonical -> in bit first; else -> out bit comp(first)
    suf_col = jnp.where(suf_fwd, 4 + first.astype(jnp.int32),
                        3 - first.astype(jnp.int32))

    bits = jnp.zeros((N, 8), jnp.uint8)
    pre_row = jnp.where(kp1_valid, pre_idx, N)
    suf_row = jnp.where(kp1_valid, suf_idx, N)
    bits = bits.at[pre_row, pre_col].max(jnp.uint8(1), mode="drop")
    bits = bits.at[suf_row, suf_col].max(jnp.uint8(1), mode="drop")

    weights = (jnp.uint8(1) << jnp.arange(4, dtype=jnp.uint8))
    out_mask = jnp.sum(bits[:, :4] * weights, axis=1).astype(jnp.uint8)
    in_mask = jnp.sum(bits[:, 4:] * weights, axis=1).astype(jnp.uint8)
    return VertexTable(uniq, out_mask, in_mask, num)


def trim_vertex_table(vt: VertexTable) -> VertexTable:
    """Trim capacity to pow2(num): build_vertex_table leaves the table
    at 2E rows (both halves of every (k+1)-mer), ~2.6x the real vertex
    count — at the 4.6 Mb k55 rung that is a 33.6M-row table whose
    capacity every downstream oriented-junction array (VSP grouping in
    early tips, binary-search depth) scales with. One host sync, same
    real rows (count_sorted keeps all-ones padding sorted last)."""
    cap = 1 << max(1, int(vt.num) - 1).bit_length()
    cap = min(cap, vt.capacity)
    return VertexTable(vt.kmers[:cap], vt.out_mask[:cap],
                       vt.in_mask[:cap], vt.num)
