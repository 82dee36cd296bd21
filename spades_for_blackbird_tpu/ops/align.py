"""Batched banded alignment kernels.

Device-side replacement for the reference's per-read edit-distance code in
the sensitive long-read aligner (modules/alignment/pacbio/gap_dijkstra.cpp
custom Dijkstra with edit distance, ext/edlib, ext/ssw local alignment):
a whole batch of sequence pairs aligns at once with a
``lax.scan`` over columns of the banded DP matrix — each scan step is a
vector min over the band, so the device sees B*band-wide elementwise ops
instead of scalar DP loops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import dna

_BIG = jnp.int32(1 << 20)


@functools.partial(jax.jit, static_argnames=("band",))
def banded_edit_distance(a: jax.Array, a_len: jax.Array, b: jax.Array,
                         b_len: jax.Array, band: int = 32) -> jax.Array:
    """Levenshtein distance of each pair (a[i], b[i]) within a diagonal band.

    a: (B, La) uint8 codes, a_len: (B,); b: (B, Lb), b_len: (B,).
    Returns (B,) int32 distances (upper bound if the optimum leaves the
    band; pairs whose length difference exceeds the band get >= that
    difference).

    Layout: column j of the DP matrix holds rows i in
    [j + offset - band, j + offset + band] where offset centers the band
    on the main diagonal shifted by (a_len - b_len)/2... we keep the plain
    main diagonal (good for end-to-end alignment of similar-length pairs,
    which is how the gap filler uses it).
    """
    B, La = a.shape
    Lb = b.shape[1]
    if La != Lb:
        raise ValueError("pad a and b to the same width")
    W = 2 * band + 1

    # Column jj of the classical DP keeps rows i = jj + (w - band) for
    # window slot w; init is column 0 (D[i][0] = i).
    row0 = jnp.arange(-band, band + 1)
    init = jnp.where(row0[None, :] >= 0,
                     jnp.abs(row0)[None, :].astype(jnp.int32), _BIG)
    init = jnp.broadcast_to(init, (B, W)).astype(jnp.int32)
    a_pad = jnp.pad(a, ((0, 0), (band + 1, band + 1)),
                    constant_values=dna.INVALID_CODE)

    def col(dp, j):
        jj = j + 1                                    # column being built
        rows = jj + row0[None, :]                     # (1, W) row i per slot
        bj = b[:, j][:, None]                         # b[jj-1]
        ai = jnp.take_along_axis(
            jnp.broadcast_to(a_pad, (B, a_pad.shape[1])),
            jnp.broadcast_to(rows + band, (B, W)), axis=1)  # a[i-1]
        sub_cost = (ai != bj) | (bj >= dna.INVALID_CODE)
        diag = dp                                     # D[i-1][jj-1] slot w
        up = jnp.concatenate(
            [dp[:, 1:], jnp.full((B, 1), _BIG)], axis=1)   # D[i][jj-1]
        new = jnp.minimum(diag + sub_cost.astype(jnp.int32), up + 1)

        # within-column dependency D[i-1][jj] + 1 = new[w-1] + 1
        def left_scan(prev, x):
            cur = jnp.minimum(x, prev + 1)
            return cur, cur
        _, new_scan = jax.lax.scan(left_scan, jnp.full((B,), _BIG), new.T)
        new = new_scan.T
        valid_row = (rows >= 0) & (rows <= a_len[:, None])
        new = jnp.where(valid_row, new, _BIG)
        # freeze once this pair's b is exhausted (jj > b_len)
        new = jnp.where((jj <= b_len)[:, None], new, dp)
        return new, None

    dp, _ = jax.lax.scan(col, init, jnp.arange(Lb))
    # answer at row a_len, column b_len: w = band + a_len - b_len
    w = band + (a_len - b_len)
    w_ok = (w >= 0) & (w < W)
    out = jnp.take_along_axis(dp, jnp.clip(w, 0, W - 1)[:, None],
                              axis=1)[:, 0]
    fallback = jnp.abs(a_len - b_len) + jnp.minimum(a_len, b_len)
    return jnp.where(w_ok, jnp.minimum(out, fallback), fallback)
