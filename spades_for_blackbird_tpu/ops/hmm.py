"""Batched profile-HMM Viterbi on the device.

Device-side replacement of the vendored HMMER pipeline used by
biosyntheticSPAdes (``hmmer::HMMMatcher`` in common/hmm/hmmmatcher.cpp
wrapping ext/hmmer, driven by projects/spades/domain_matcher.cpp): a
plan7-style local Viterbi where

- the per-position update is a pure vector op over the model dimension,
- the delete-state chain (the only serial part of a plan7 column) is a
  max-plus prefix scan, computed with ``lax.associative_scan``,
- the sequence dimension is a ``lax.scan`` and the batch dimension a
  ``vmap`` — so one call scores *every translated frame of every contig
  against a model* in one compiled kernel.

Alignment envelopes are recovered without a traceback matrix: each DP
state carries the start position of its best path (selected through the
same max choices), so the per-position outputs (end score, start) give
every candidate domain hit directly.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .aa import NUM_AA, STOP

NEG = -1.0e30


@dataclass(frozen=True)
class HMMProfile:
    """Log-odds profile (natural log, vs background).

    match: (m, 21) match emission scores (col 20 = stop codon, -inf).
    t: dict of (m,) transition score arrays
       tMM/tMI/tMD/tIM/tII/tDM/tDD, where index j is the transition out
       of node j+1 (1-based nodes, trailing entries unused where n/a).
    name/desc/length: model metadata.
    """
    name: str
    match: np.ndarray
    tMM: np.ndarray
    tMI: np.ndarray
    tMD: np.ndarray
    tIM: np.ndarray
    tII: np.ndarray
    tDM: np.ndarray
    tDD: np.ndarray
    desc: str = ""

    @property
    def length(self) -> int:
        return self.match.shape[0]


def hmm_from_consensus(name: str, aa_codes, match_p: float = 0.9,
                       t_stay: float = 0.05) -> HMMProfile:
    """Build a simple profile from a consensus AA sequence (for tests and
    synthetic domain models): each node emits its consensus residue with
    probability ``match_p``, the rest uniform."""
    aa_codes = np.asarray(aa_codes)
    m = len(aa_codes)
    bg = 1.0 / NUM_AA
    other = (1.0 - match_p) / (NUM_AA - 1)
    match = np.full((m, NUM_AA + 1), np.log(other / bg), np.float32)
    match[np.arange(m), aa_codes] = np.log(match_p / bg)
    match[:, STOP] = NEG
    t_go = 1.0 - 2 * t_stay
    z = np.full(m, np.log(t_go), np.float32)
    stay = np.full(m, np.log(t_stay), np.float32)
    return HMMProfile(name=name, match=match,
                      tMM=z, tMI=stay, tMD=stay,
                      tIM=np.full(m, np.log(0.5), np.float32),
                      tII=np.full(m, np.log(0.5), np.float32),
                      tDM=np.full(m, np.log(0.5), np.float32),
                      tDD=np.full(m, np.log(0.5), np.float32))


def _shift1(x, fill):
    return jnp.concatenate([jnp.full((1,), fill, x.dtype), x[:-1]])


@functools.partial(jax.jit, static_argnames=("m",))
def viterbi_ends(match, tMM, tMI, tMD, tIM, tII, tDM, tDD,
                 seqs: jax.Array, lengths: jax.Array, m: int):
    """Local Viterbi over a batch of AA sequences.

    seqs: (B, L) uint8 AA codes (20 = stop), lengths: (B,).
    Returns (end_scores (B, L), end_starts (B, L)): best local-alignment
    score of a path ending at each position, and its start position.
    """
    tBM = jnp.float32(-np.log(m))  # uniform local entry
    cdd = jnp.cumsum(tDD)

    insert_emit = jnp.where(
        jnp.arange(NUM_AA + 1) == STOP, NEG, 0.0).astype(jnp.float32)

    def step(carry, xi):
        VM, VI, VD, SM, SI, SD = carry
        a, i, valid = xi

        me = match[:, a]
        # M update: entry / M->M / I->M / D->M (shifted by one node)
        pm = _shift1(VM + tMM, NEG)
        pi = _shift1(VI + tIM, NEG)
        pd = _shift1(VD + tDM, NEG)
        psm = _shift1(SM, 0)
        psi = _shift1(SI, 0)
        psd = _shift1(SD, 0)
        entry = jnp.full((m,), tBM)
        cands = jnp.stack([entry, pm, pi, pd])              # (4, m)
        starts = jnp.stack([jnp.full((m,), i, jnp.int32), psm, psi, psd])
        which = jnp.argmax(cands, axis=0)
        VMn = me + jnp.take_along_axis(cands, which[None], 0)[0]
        SMn = jnp.take_along_axis(starts, which[None], 0)[0]

        # I update (from previous position, same node)
        im = VM + tMI
        ii = VI + tII
        VIn = insert_emit[a] + jnp.maximum(im, ii)
        SIn = jnp.where(im >= ii, SM, SI)

        # D chain within this position: max-plus prefix scan
        aval = VMn + tMD - cdd
        astart = SMn

        def comb(x, y):
            xs, xi_ = x
            ys, yi_ = y
            take_y = ys >= xs
            return (jnp.where(take_y, ys, xs),
                    jnp.where(take_y, yi_, xi_))

        run_s, run_i = jax.lax.associative_scan(comb, (aval, astart))
        VDn = _shift1(run_s, NEG) + _shift1(cdd, 0.0)
        SDn = _shift1(run_i, 0)

        # local exit: path may end at any match state
        j = jnp.argmax(VMn)
        e_score = jnp.where(valid, VMn[j], NEG)
        e_start = SMn[j]

        keep = lambda new, old: jnp.where(valid, new, old)
        carry2 = (keep(VMn, VM), keep(VIn, VI), keep(VDn, VD),
                  keep(SMn, SM), keep(SIn, SI), keep(SDn, SD))
        return carry2, (e_score, e_start)

    def run_one(seq, ln):
        L = seq.shape[0]
        init = (jnp.full((m,), NEG), jnp.full((m,), NEG),
                jnp.full((m,), NEG),
                jnp.zeros((m,), jnp.int32), jnp.zeros((m,), jnp.int32),
                jnp.zeros((m,), jnp.int32))
        idx = jnp.arange(L, dtype=jnp.int32)
        _, (es, st) = jax.lax.scan(
            step, init, (seq.astype(jnp.int32), idx, idx < ln))
        return es, st

    return jax.vmap(run_one)(seqs, lengths)


def score_batch(profile: HMMProfile, seqs: np.ndarray, lengths: np.ndarray):
    """Convenience wrapper: numpy in, numpy (end_scores, end_starts) out."""
    args = [jnp.asarray(np.asarray(x, np.float32)) for x in (
        profile.match, profile.tMM, profile.tMI, profile.tMD,
        profile.tIM, profile.tII, profile.tDM, profile.tDD)]
    es, st = viterbi_ends(*args, jnp.asarray(np.asarray(seqs, np.uint8)),
                          jnp.asarray(np.asarray(lengths, np.int32)),
                          m=profile.length)
    return np.asarray(es), np.asarray(st)


def find_hits(end_scores: np.ndarray, end_starts: np.ndarray, length: int,
              threshold: float, min_span: int = 1):
    """Greedy non-overlapping hit selection for ONE sequence:
    [(aa_start, aa_end_inclusive, score), ...] sorted by position."""
    es = end_scores[:length]
    order = np.argsort(-es)
    taken: list[tuple[int, int, float]] = []
    for pos in order:
        s = float(es[pos])
        if s < threshold:
            break
        a, b = int(end_starts[pos]), int(pos)
        if b - a + 1 < min_span:
            continue
        if any(not (b < ta or a > tb) for ta, tb, _ in taken):
            continue
        taken.append((a, b, s))
    taken.sort()
    return taken
