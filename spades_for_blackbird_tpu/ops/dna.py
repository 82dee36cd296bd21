"""2-bit DNA primitives: encoding, complement, packed k-mer words.

Device-side replacement for the reference's bit-packed sequence classes
(``Seq<k>`` at assembler/src/common/sequence/seq.hpp:46, ``RtSeq`` at
sequence/rtseq.hpp:35, nucleotide helpers at sequence/nucl.hpp). Instead of
per-object packed integers manipulated by scalar code, DNA lives in dense
device arrays:

- *code arrays*: ``uint8`` tensors of 2-bit codes (A=0, C=1, G=2, T=3),
  with ``INVALID_CODE`` (4) marking N/padding. Shape ``(..., L)``.
- *k-mer word arrays*: ``uint32`` tensors of shape ``(..., W)`` where each
  word packs 16 bases, **first base in the most-significant bits**. This
  layout makes lexicographic comparison of the word tuple equal to
  lexicographic comparison of the DNA string, so XLA's multi-key sort
  sorts k-mers in DNA order directly.

All functions are shape-polymorphic over leading dims and jit-safe (k and
word counts are Python-static).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# 2-bit codes. Complement(x) == 3 - x == x XOR 3 (bitwise NOT in 2 bits).
A, C, G, T = 0, 1, 2, 3
INVALID_CODE = 4  # 'N' or padding
BASES_PER_WORD = 16  # 32-bit words, 2 bits per base

_CHAR_TO_CODE = np.full(256, INVALID_CODE, dtype=np.uint8)
for _ch, _code in (("A", A), ("C", C), ("G", G), ("T", T),
                   ("a", A), ("c", C), ("g", G), ("t", T)):
    _CHAR_TO_CODE[ord(_ch)] = _code
_CODE_TO_CHAR = np.array([ord("A"), ord("C"), ord("G"), ord("T"), ord("N")],
                         dtype=np.uint8)


def words_per_kmer(k: int) -> int:
    """Number of uint32 words needed for a k-mer."""
    return -(-k // BASES_PER_WORD)


# ---------------------------------------------------------------------------
# Host-side string <-> code conversion (NumPy; I/O boundary only).
# ---------------------------------------------------------------------------

def encode_str(s: str) -> np.ndarray:
    """ASCII DNA string -> uint8 code array (host side)."""
    raw = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
    return _CHAR_TO_CODE[raw]


def decode_codes(codes: np.ndarray) -> str:
    """uint8 code array -> ASCII DNA string (host side)."""
    codes = np.asarray(codes, dtype=np.uint8)
    return bytes(_CODE_TO_CHAR[np.minimum(codes, INVALID_CODE)]).decode("ascii")


def encode_reads(seqs: list[str], max_len: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """List of DNA strings -> (codes (R, L) uint8 padded, lengths (R,) int32).

    Replaces the reference's binary read store ingestion
    (io/reads/binary_converter.hpp:25) with a padded dense tensor.
    """
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    L = int(max_len if max_len is not None else (lengths.max() if len(seqs) else 0))
    codes = np.full((len(seqs), L), INVALID_CODE, dtype=np.uint8)
    for i, s in enumerate(seqs):
        n = min(len(s), L)
        codes[i, :n] = encode_str(s[:n])
    return codes, lengths


# ---------------------------------------------------------------------------
# Device-side code-array ops.
# ---------------------------------------------------------------------------

_RC_TABLE = str.maketrans("ACGTacgtN", "TGCAtgcaN")


def pull_codes_packed(flat, n_valid: int | None = None) -> "np.ndarray":
    """Pull a 2-bit code buffer from device to host 4-bases-per-byte.

    Packing on the device quarters the bytes moved.  ``n_valid`` bounds the
    useful prefix (the rest is capacity padding and never transferred
    beyond pow2 rounding).  Returns host uint8 codes of length
    ``n_valid`` (or the full buffer length)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    flat = jnp.asarray(flat)
    n = flat.shape[0] if n_valid is None else int(n_valid)
    cap = 1 << max(1, n - 1).bit_length()
    cap = min(cap, flat.shape[0])
    n = min(n, cap)

    @jax.jit
    def _pack(f):
        pad = (-f.shape[0]) % 4
        f = jnp.pad(f, (0, pad)) & 3
        return (f[0::4] | (f[1::4] << 2) | (f[2::4] << 4)
                | (f[3::4] << 6)).astype(jnp.uint8)

    p = np.asarray(_pack(flat[:cap]))
    out = np.empty(p.shape[0] * 4, np.uint8)
    out[0::4] = p & 3
    out[1::4] = (p >> 2) & 3
    out[2::4] = (p >> 4) & 3
    out[3::4] = (p >> 6) & 3
    return out[:n]


def revcomp_str(seq: str) -> str:
    """Reverse-complement of an ASCII sequence string (host-side)."""
    return seq.translate(_RC_TABLE)[::-1]


def complement_codes(codes: jax.Array) -> jax.Array:
    """Complement 2-bit codes; INVALID stays INVALID."""
    comp = (3 - codes.astype(jnp.int32)).astype(codes.dtype)
    return jnp.where(codes >= INVALID_CODE, codes, comp)


def revcomp_codes(codes: jax.Array, axis: int = -1) -> jax.Array:
    """Reverse-complement along ``axis`` (padding flips to the front)."""
    return jnp.flip(complement_codes(codes), axis=axis)


def revcomp_reads(codes: jax.Array, lengths: jax.Array) -> jax.Array:
    """Reverse-complement a padded read batch (R, L), keeping each read
    left-aligned (padding stays at the end)."""
    L = codes.shape[1]
    rc = jnp.flip(complement_codes(codes), axis=1)
    shift = (L - lengths).astype(jnp.int32)
    col = (jnp.arange(L)[None, :] + shift[:, None]) % L
    return jnp.take_along_axis(rc, col, axis=1)


# ---------------------------------------------------------------------------
# Packed k-mer words.
# ---------------------------------------------------------------------------

def _reverse_bases_in_word(w: jax.Array) -> jax.Array:
    """Reverse the 16 2-bit base slots within each uint32 word."""
    w = ((w & jnp.uint32(0x0000FFFF)) << 16) | ((w & jnp.uint32(0xFFFF0000)) >> 16)
    w = ((w & jnp.uint32(0x00FF00FF)) << 8) | ((w & jnp.uint32(0xFF00FF00)) >> 8)
    w = ((w & jnp.uint32(0x0F0F0F0F)) << 4) | ((w & jnp.uint32(0xF0F0F0F0)) >> 4)
    w = ((w & jnp.uint32(0x33333333)) << 2) | ((w & jnp.uint32(0xCCCCCCCC)) >> 2)
    return w


def pack_kmers(codes: jax.Array, k: int) -> jax.Array:
    """Pack base codes (..., k) -> k-mer words (..., W).

    Caller guarantees codes are valid (0..3); invalid positions must be
    masked out separately.
    """
    W = words_per_kmer(k)
    padded_len = W * BASES_PER_WORD
    pad = padded_len - k
    if pad:
        pad_widths = [(0, 0)] * (codes.ndim - 1) + [(0, pad)]
        codes = jnp.pad(codes, pad_widths)
    c = codes.astype(jnp.uint32) & jnp.uint32(3)
    c = c.reshape(codes.shape[:-1] + (W, BASES_PER_WORD))
    shifts = jnp.arange(BASES_PER_WORD - 1, -1, -1, dtype=jnp.uint32) * 2
    return jnp.sum(c << shifts, axis=-1).astype(jnp.uint32)


def unpack_kmers(words: jax.Array, k: int) -> jax.Array:
    """k-mer words (..., W) -> base codes (..., k)."""
    W = words_per_kmer(k)
    shifts = jnp.arange(BASES_PER_WORD - 1, -1, -1, dtype=jnp.uint32) * 2
    bases = (words[..., :, None] >> shifts) & jnp.uint32(3)
    bases = bases.reshape(words.shape[:-1] + (W * BASES_PER_WORD,))
    return bases[..., :k].astype(jnp.uint8)


def revcomp_kmers(words: jax.Array, k: int) -> jax.Array:
    """Reverse-complement packed k-mers (..., W) -> (..., W).

    Complement = bitwise NOT (2-bit codes); reversal = per-word base
    reversal + word-order reversal + left shift to drop the pad slots.
    """
    W = words_per_kmer(k)
    pad_bits = (W * BASES_PER_WORD - k) * 2
    rev = _reverse_bases_in_word(~words)[..., ::-1]
    if pad_bits == 0:
        return rev
    word_shift, bit_shift = divmod(pad_bits, 32)
    if word_shift:
        zeros = jnp.zeros(rev.shape[:-1] + (word_shift,), dtype=jnp.uint32)
        rev = jnp.concatenate([rev[..., word_shift:], zeros], axis=-1)
    if bit_shift:
        hi = rev << jnp.uint32(bit_shift)
        lo = jnp.concatenate(
            [rev[..., 1:], jnp.zeros(rev.shape[:-1] + (1,), dtype=jnp.uint32)],
            axis=-1) >> jnp.uint32(32 - bit_shift)
        rev = hi | lo
    # Clear pad bits of the last word (left shift filled them with garbage
    # only if k fits oddly; recompute mask for safety).
    last_bases = k - (W - 1) * BASES_PER_WORD
    if last_bases < BASES_PER_WORD:
        mask = jnp.uint32(0xFFFFFFFF) << jnp.uint32((BASES_PER_WORD - last_bases) * 2)
        rev = rev.at[..., W - 1].set(rev[..., W - 1] & mask)
    return rev


def kmer_less(a: jax.Array, b: jax.Array) -> jax.Array:
    """Lexicographic a < b over trailing word axis. Returns bool (...,)."""
    lt = a < b
    eq = a == b
    result = lt[..., -1]
    for w in range(a.shape[-1] - 2, -1, -1):
        result = lt[..., w] | (eq[..., w] & result)
    return result


def canonicalize_kmers(words: jax.Array, k: int
                       ) -> tuple[jax.Array, jax.Array]:
    """Canonical form = min(kmer, revcomp(kmer)).

    Returns (canonical_words (..., W), is_forward (...,) bool) where
    is_forward is True when the input orientation is the canonical one
    (ties, i.e. palindromes, count as forward).
    """
    rc = revcomp_kmers(words, k)
    rc_lt = kmer_less(rc, words)
    canon = jnp.where(rc_lt[..., None], rc, words)
    return canon, ~rc_lt


def truncate_bases(words: jax.Array, k_in: int, k_out: int) -> jax.Array:
    """Keep the first ``k_out`` bases of packed ``k_in``-mers (prefix)."""
    assert k_out <= k_in
    W_out = words_per_kmer(k_out)
    out = words[..., :W_out]
    last_bases = k_out - (W_out - 1) * BASES_PER_WORD
    if last_bases < BASES_PER_WORD:
        mask = jnp.uint32(0xFFFFFFFF) << jnp.uint32(
            (BASES_PER_WORD - last_bases) * 2)
        out = out.at[..., W_out - 1].set(out[..., W_out - 1] & mask)
    return out


def drop_first_bases(words: jax.Array, m: int, k_in: int) -> jax.Array:
    """Drop the first ``m`` bases of packed ``k_in``-mers -> (k_in-m)-mers."""
    k_out = k_in - m
    word_shift, base_shift = divmod(m, BASES_PER_WORD)
    if word_shift:
        zeros = jnp.zeros(words.shape[:-1] + (word_shift,), jnp.uint32)
        words = jnp.concatenate([words[..., word_shift:], zeros], axis=-1)
    if base_shift:
        s = jnp.uint32(base_shift * 2)
        hi = words << s
        lo = jnp.concatenate(
            [words[..., 1:], jnp.zeros(words.shape[:-1] + (1,), jnp.uint32)],
            axis=-1) >> jnp.uint32(32 - base_shift * 2)
        words = hi | lo
    return truncate_bases(words, words.shape[-1] * BASES_PER_WORD, k_out)


def append_base(words: jax.Array, k: int, base: jax.Array) -> jax.Array:
    """Append one base to packed k-mers -> (k+1)-mers.

    ``base`` is broadcastable to ``words.shape[:-1]`` with values 0..3.
    """
    W_out = words_per_kmer(k + 1)
    if W_out > words.shape[-1]:
        zeros = jnp.zeros(words.shape[:-1] + (W_out - words.shape[-1],),
                          jnp.uint32)
        words = jnp.concatenate([words, zeros], axis=-1)
    w0, slot = divmod(k, BASES_PER_WORD)
    shift = jnp.uint32((BASES_PER_WORD - 1 - slot) * 2)
    placed = words[..., w0] | (base.astype(jnp.uint32) << shift)
    return words.at[..., w0].set(placed)


def kmer_last_base(words: jax.Array, k: int) -> jax.Array:
    """Last base code of each packed k-mer (..., W) -> (...,) uint8."""
    W = words_per_kmer(k)
    last_bases = k - (W - 1) * BASES_PER_WORD
    shift = jnp.uint32((BASES_PER_WORD - last_bases) * 2)
    return ((words[..., W - 1] >> shift) & jnp.uint32(3)).astype(jnp.uint8)


def kmer_first_base(words: jax.Array, k: int) -> jax.Array:
    """First base code of each packed k-mer -> (...,) uint8."""
    return ((words[..., 0] >> jnp.uint32(30)) & jnp.uint32(3)).astype(jnp.uint8)
