"""IonTorrent homopolymer-space read correction (IonHammer equivalent).

Device-side counterpart of projects/ionhammer (8.9k LoC: HKMer counting,
gamma-Poisson run-length model, SW read corrector): IonTorrent's dominant
error mode is homopolymer run-length miscalls, so correction happens in
homopolymer-compressed space:

1. compress each read to (base, run_length) pairs — a segmented
   run-length encoding done entirely with cumsum/scatter array ops (the
   reference's per-read loops in hkmer.hpp become one jit region);
2. count k-mers over the compressed base string and accumulate per-slot
   run-length sufficient statistics (sum, count) with one scatter-add;
3. per (solid k-mer, slot), estimate the true run length with a
   gamma-Poisson MAP (the reference's GammaPoissonModel,
   projects/ionhammer/gamma_poisson_model.cpp, reduced to a conjugate
   Gamma(ALPHA, BETA) prior on the Poisson rate: the posterior mode
   maximizes (S + ALPHA - 1) log l - (n + BETA) l over integer l);
4. rewrite each read's interior run lengths to the consensus where
   solid k-mers agree, then decompress — again one jit region.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import dna

# weak conjugate prior for the run-length Poisson rate (stand-in for the
# reference's trained gamma mixture, gamma_poisson_model.cpp:40)
ALPHA = 1.0
BETA = 0.05


@jax.jit
def _hp_compress(codes: jax.Array, lengths: jax.Array):
    R, L = codes.shape
    pos = jnp.arange(L)[None, :]
    in_read = pos < lengths[:, None]
    ok = in_read & (codes < dna.INVALID_CODE)
    prev = jnp.concatenate(
        [jnp.full((R, 1), 255, codes.dtype), codes[:, :-1]], axis=1)
    new_run = ok & ((codes != prev) | (pos == 0))
    run_id = jnp.cumsum(new_run.astype(jnp.int32), axis=1) - 1  # (R, L)
    run_id = jnp.where(ok, run_id, L)
    rows = jnp.broadcast_to(jnp.arange(R)[:, None], (R, L))
    bases = jnp.full((R, L), dna.INVALID_CODE, codes.dtype).at[
        rows, run_id].min(codes, mode="drop")
    runs = jnp.zeros((R, L), jnp.int32).at[rows, run_id].add(
        1, mode="drop")
    clens = jnp.max(jnp.where(ok, run_id + 1, 0), axis=1)
    return bases, runs, clens


def hp_compress(codes, lengths):
    """(R, L) codes -> (bases (R, L), runs (R, L), comp_lengths (R,)).

    Compressed rows are left-aligned and INVALID-padded."""
    b, r, c = _hp_compress(jnp.asarray(codes), jnp.asarray(lengths))
    return np.asarray(b), np.asarray(r), np.asarray(c)


@functools.partial(jax.jit, static_argnames=("out_width",))
def _hp_decompress(bases: jax.Array, runs: jax.Array, clens: jax.Array,
                   out_width: int):
    R, L = bases.shape
    in_comp = jnp.arange(L)[None, :] < clens[:, None]
    runs = jnp.where(in_comp, runs, 0)
    starts = jnp.cumsum(runs, axis=1) - runs          # (R, L) exclusive
    total = jnp.sum(runs, axis=1)
    # output position t belongs to run j iff starts[j] <= t < starts[j]+runs[j]
    t = jnp.arange(out_width)
    j = jax.vmap(lambda s, tt: jnp.searchsorted(s, tt, side="right"))(
        starts + runs, jnp.broadcast_to(t[None, :], (R, out_width)))
    j = jnp.minimum(j, L - 1)
    out = jnp.take_along_axis(bases, j, axis=1)
    lengths = jnp.minimum(total, out_width)
    out = jnp.where(t[None, :] < lengths[:, None], out,
                    jnp.uint8(dna.INVALID_CODE))
    return out.astype(jnp.uint8), lengths.astype(jnp.int32)


def hp_decompress(bases, runs, clens, out_width: int):
    c, l = _hp_decompress(jnp.asarray(bases), jnp.asarray(runs),
                          jnp.asarray(clens), int(out_width))
    return np.asarray(c), np.asarray(l)


@jax.jit
def _gamma_poisson_map(rl_sum: jax.Array, rl_cnt: jax.Array) -> jax.Array:
    """Integer MAP run length under Poisson(l) observations with a
    Gamma(ALPHA, BETA) prior: argmax over integers of
    (S + ALPHA - 1) log l - (n + BETA) l; the continuous optimum is
    x = (S + ALPHA - 1) / (n + BETA), so compare floor(x) vs ceil(x)."""
    a = rl_sum.astype(jnp.float32) + (ALPHA - 1.0)
    b = rl_cnt.astype(jnp.float32) + BETA
    x = jnp.maximum(a / jnp.maximum(b, 1e-9), 1.0)
    lo = jnp.maximum(jnp.floor(x), 1.0)
    hi = lo + 1.0
    ll_lo = a * jnp.log(lo) - b * lo
    ll_hi = a * jnp.log(hi) - b * hi
    return jnp.where(ll_hi > ll_lo, hi, lo).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k",))
def _stats_and_vote(bases, runs, clens, table_kmers, table_counts,
                    table_num, k: int, min_count: int):
    """One jit region: per-(k-mer, slot) run-length statistics, the
    gamma-Poisson consensus, and per-read run-length votes."""
    from ..kmers import counter  # noqa: F401 (type only)
    from ..ops import kmer as kmer_ops, segments

    R, L = bases.shape
    N = table_kmers.shape[0]
    kmers, valid = kmer_ops.extract_kmers(bases, clens, k)
    canon, is_fwd = dna.canonicalize_kmers(kmers, k)
    P = canon.shape[1]
    row = segments.searchsorted_rows(
        table_kmers, canon.reshape(-1, canon.shape[2])).reshape(R, P)
    found = (row < table_num) & valid
    safe_row = jnp.where(found, row, N)

    # windows of run lengths per placement: (R, P, k)
    offs = jnp.arange(k)
    win = runs[:, :, None][
        jnp.arange(R)[:, None, None],
        jnp.arange(P)[None, :, None] + offs[None, None, :], 0]
    # flank mask: first/last run of a read is boundary-truncated
    pidx = jnp.arange(P)[None, :, None]
    m = jnp.ones((R, P, k), jnp.int32)
    m = jnp.where((pidx == 0) & (offs[None, None, :] == 0), 0, m)
    m = jnp.where((pidx + k == clens[:, None, None])
                  & (offs[None, None, :] == k - 1), 0, m)
    # orient into canonical space
    win_c = jnp.where(is_fwd[..., None], win, win[..., ::-1])
    m_c = jnp.where(is_fwd[..., None], m, m[..., ::-1])

    slot = jnp.broadcast_to(offs[None, None, :], (R, P, k))
    srow = jnp.broadcast_to(safe_row[..., None], (R, P, k))
    rl_sum = jnp.zeros((N + 1, k), jnp.int32).at[srow, slot].add(
        win_c * m_c, mode="drop")[:N]
    rl_cnt = jnp.zeros((N + 1, k), jnp.int32).at[srow, slot].add(
        m_c, mode="drop")[:N]

    consensus = _gamma_poisson_map(rl_sum, rl_cnt)            # (N, k)
    solid = (table_counts >= min_count) & (jnp.min(rl_cnt, axis=1) > 0)

    # votes back onto reads: each found+solid placement votes its
    # consensus (re-oriented) at compressed positions p..p+k-1
    can_vote = found & solid[jnp.minimum(safe_row, N - 1)]
    cons = consensus[jnp.minimum(safe_row, N - 1)]            # (R, P, k)
    cons_r = jnp.where(is_fwd[..., None], cons, cons[..., ::-1])
    vpos = jnp.where(can_vote[..., None],
                     jnp.arange(P)[None, :, None] + offs[None, None, :], L)
    rows3 = jnp.broadcast_to(jnp.arange(R)[:, None, None], (R, P, k))
    vote_sum = jnp.zeros((R, L + 1), jnp.int32).at[rows3, vpos].add(
        cons_r, mode="drop")[:, :L]
    vote_cnt = jnp.zeros((R, L + 1), jnp.int32).at[rows3, vpos].add(
        1, mode="drop")[:, :L]

    interior = (jnp.arange(L)[None, :] >= 1) & \
        (jnp.arange(L)[None, :] < clens[:, None] - 1)
    has = (vote_cnt > 0) & interior
    new_runs = jnp.where(
        has,
        jnp.rint(vote_sum / jnp.maximum(vote_cnt, 1)).astype(jnp.int32),
        runs)
    in_comp = jnp.arange(L)[None, :] < clens[:, None]
    new_runs = jnp.maximum(new_runs, jnp.where(in_comp, 1, 0))
    changed = jnp.sum(((new_runs != runs) & has).astype(jnp.int32))
    return new_runs, changed, jnp.sum(solid.astype(jnp.int32))


def correct_reads_ion(codes, lengths, k: int = 13,
                      min_count: int = 3) -> tuple[np.ndarray, np.ndarray, dict]:
    """Correct homopolymer run lengths by solid-HK-mer gamma-Poisson
    consensus. Returns (codes, lengths, stats) — widths can change since
    run lengths do."""
    from ..kmers import counter

    codes = jnp.asarray(np.asarray(codes))
    lengths = jnp.asarray(np.asarray(lengths))
    bases, runs, clens = _hp_compress(codes, lengths)
    table = counter.trim_table(counter.count_kmers(bases, clens, k))
    new_runs, changed, n_solid = _stats_and_vote(
        bases, runs, clens, table.kmers, table.counts, table.num, k,
        min_count)
    out_width = int(np.asarray(jnp.max(jnp.sum(new_runs, axis=1))))
    out_codes, out_lengths = _hp_decompress(
        bases, new_runs, clens, max(out_width, int(codes.shape[1])))
    return (np.asarray(out_codes), np.asarray(out_lengths),
            {"changed_runs": int(changed), "solid_hkmers": int(n_solid)})
