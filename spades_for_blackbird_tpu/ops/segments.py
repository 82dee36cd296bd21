"""Sorted-multiset machinery: multi-word sort, run-length unique/count, compaction.

This is the device-side replacement for the reference's out-of-core k-mer
counting machine (``KMerDiskCounter`` at
assembler/src/common/utils/kmer_mph/kmer_index_builder.hpp:220-366: hash
bucket files -> per-bucket sort -> loser-tree merge) and its perfect-hash
maps (utils/ph_map/perfect_hash_map.hpp:78). Here the whole dataset lives
in device arrays: counting is one lexicographic sort plus a segmented
reduce, and "index lookup" is binary search into the sorted array.

All shapes are static; variable-size results are returned as padded arrays
plus an element-count scalar ("padded ragged" discipline).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sort_by_key_rows(keys: jax.Array, payloads: tuple[jax.Array, ...] = (),
                     valid: jax.Array | None = None
                     ) -> tuple[jax.Array, tuple[jax.Array, ...], jax.Array | None]:
    """Sort rows of ``keys`` (N, W) lexicographically over the word axis.

    If ``valid`` is given, invalid rows sort after all valid rows. Payloads
    (each shape (N, ...)) are permuted alongside. Returns
    (sorted_keys, sorted_payloads, sorted_valid).
    """
    N, W = keys.shape
    key_cols = [keys[:, w] for w in range(W)]
    if valid is not None:
        key_cols = [(~valid).astype(jnp.uint32)] + key_cols
    perm_src = jnp.arange(N, dtype=jnp.int32)
    out = jax.lax.sort(key_cols + [perm_src], num_keys=len(key_cols),
                       is_stable=True)
    perm = out[-1]
    sorted_words = out[len(key_cols) - W:len(key_cols)]
    sorted_keys = jnp.stack(sorted_words, axis=1)
    sorted_valid = valid[perm] if valid is not None else None
    sorted_payloads = tuple(p[perm] for p in payloads)
    return sorted_keys, sorted_payloads, sorted_valid


def rows_equal_prev(keys: jax.Array) -> jax.Array:
    """(N, W) -> (N,) bool: row equals previous row (row 0 -> False)."""
    eq = jnp.all(keys[1:] == keys[:-1], axis=1)
    return jnp.concatenate([jnp.zeros((1,), bool), eq])


def unique_counts(sorted_keys: jax.Array, sorted_valid: jax.Array,
                  weights: jax.Array | None = None
                  ) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Run-length encode sorted rows.

    Args:
      sorted_keys: (N, W) rows sorted lexicographically, invalid rows last.
      sorted_valid: (N,) bool.
      weights: optional (N,) per-row weights (default 1 per row).

    Returns:
      uniq: (N, W) unique rows packed at the front (padding rows are
        all-ones past ``num_unique``).
      counts: (N,) int32/float per-unique total weight.
      gid: (N,) int32 group id of each input row (valid rows only
        meaningful; invalid rows get gid pointing at a dead slot N-1...
        callers must mask by sorted_valid).
      num_unique: () int32.
    """
    N, W = sorted_keys.shape
    seg_start = (~rows_equal_prev(sorted_keys)) & sorted_valid
    gid = jnp.cumsum(seg_start.astype(jnp.int32)) - 1
    gid = jnp.maximum(gid, 0)
    num_unique = jnp.sum(seg_start.astype(jnp.int32))
    uniq = jnp.full((N, W), jnp.uint32(0xFFFFFFFF))
    scatter_gid = jnp.where(sorted_valid, gid, N)  # drop invalid (OOB)
    uniq = uniq.at[scatter_gid].set(sorted_keys, mode="drop")
    if weights is None:
        weights = jnp.ones((N,), jnp.int32)
    counts = jnp.zeros((N,), weights.dtype).at[scatter_gid].add(
        weights, mode="drop")
    return uniq, counts, gid, num_unique


def count_sorted(keys: jax.Array, valid: jax.Array,
                 weights: jax.Array | None = None,
                 sentinel_safe: bool = False):
    """sort + unique_counts in one call.

    Returns (uniq, counts, num_unique).

    sentinel_safe: caller guarantees no real key row is all-ones (true for
    packed k-mers whenever k % 16 != 0 — the pad bits are always zero).
    The fast path then folds validity into the keys (invalid -> all-ones)
    and sorts W key columns with no extra validity column or permutation
    payload — the hot-path win for the counting engine.
    """
    if sentinel_safe and weights is None:
        N, W = keys.shape
        skeys = jnp.where(valid[:, None], keys, jnp.uint32(0xFFFFFFFF))
        cols = jax.lax.sort([skeys[:, w] for w in range(W)], num_keys=W,
                            is_stable=False)
        skeys = jnp.stack(cols, axis=1)
        svalid = ~jnp.all(skeys == jnp.uint32(0xFFFFFFFF), axis=1)
        uniq, counts, _, num_unique = unique_counts(skeys, svalid, None)
        return uniq, counts, num_unique
    payloads = (weights,) if weights is not None else ()
    skeys, spayloads, svalid = sort_by_key_rows(keys, payloads, valid)
    w = spayloads[0] if weights is not None else None
    uniq, counts, _, num_unique = unique_counts(skeys, svalid, w)
    return uniq, counts, num_unique


def compact(mask: jax.Array, *arrays: jax.Array
            ) -> tuple[jax.Array, tuple[jax.Array, ...]]:
    """Stable-pack rows where ``mask`` is True to the front.

    Returns (num_kept, packed_arrays); slots past num_kept are zero.
    """
    N = mask.shape[0]
    dest = jnp.cumsum(mask.astype(jnp.int32)) - 1
    dest = jnp.where(mask, dest, N)  # OOB -> dropped
    num_kept = jnp.sum(mask.astype(jnp.int32))
    outs = []
    for a in arrays:
        out = jnp.zeros_like(a)
        outs.append(out.at[dest].set(a, mode="drop"))
    return num_kept, tuple(outs)


def searchsorted_rows(haystack: jax.Array, needles: jax.Array) -> jax.Array:
    """Binary search rows of ``needles`` (M, W) in sorted ``haystack`` (N, W).

    Returns (M,) int32 index of the first haystack row == needle, or N if
    absent. This replaces the reference's perfect-hash-map lookups
    (utils/ph_map/perfect_hash_map.hpp:78): instead of an MPH over disk
    buckets, membership is log2(N) gathers over a sorted array.
    """
    N, W = haystack.shape
    M = needles.shape[0]
    lo = jnp.zeros((M,), jnp.int32)
    hi = jnp.full((M,), N, jnp.int32)
    # the [lo, hi) gap starts at N and halves per iteration; it must
    # reach 0 (lo == hi), which takes ceil(log2(N+1)) <= N.bit_length()
    # steps. (N-1).bit_length() is one short exactly when N is a power
    # of two — i.e. for every pow2-trimmed table — leaving a 1-wide gap
    # and a false-negative for needles whose target lands at hi.
    n_iters = max(1, N.bit_length())

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        mid_rows = haystack[mid]
        # haystack[mid] < needle  (lexicographic)
        lt = mid_rows[:, -1] < needles[:, -1]
        for w in range(W - 2, -1, -1):
            lt = (mid_rows[:, w] < needles[:, w]) | (
                (mid_rows[:, w] == needles[:, w]) & lt)
        lo = jnp.where(lt, mid + 1, lo)
        hi = jnp.where(lt, hi, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, n_iters, body, (lo, hi))
    found_rows = haystack[jnp.minimum(lo, N - 1)]
    found = jnp.all(found_rows == needles, axis=1) & (lo < N)
    return jnp.where(found, lo, N)
