"""Gap closing: join dead-end edge pairs supported by read pairs.

Device-side counterpart of the reference's GapClosing stage
(projects/spades/gap_closer.cpp ``GapCloserPairedIndexFiller``:25 +
``GapCloser``:170): mate pairs whose ends map onto two different
dead-end edges witness that the edges are adjacent; the joint is made by
aligning the tip ends for the best overlap, tolerating up to
``hamming_bound`` mismatches (gap_closer.cpp:396 LimitedHammingDistance,
bound=2 at :472) with the reference's low-complexity overlap rejection
(:404-414), and — on an imperfect match — correcting the
lower-coverage tip to the higher-coverage one before merging
(HandlePositiveHammingDistanceCase, :327-355).

The paired evidence comes from the device mapping machinery; the joins
themselves touch a handful of tips and run host-side.
"""

from __future__ import annotations

import numpy as np

from ..graph.graph import Graph, edge_mask
from ..ops import dna


def close_gaps(g: Graph, codes1, lengths1, codes2, lengths2,
               min_support: int = 3, min_overlap: int = 10,
               max_overlap_scan: int = 150,
               hamming_bound: int = 2) -> tuple[Graph, int]:
    """One gap-closing round. Returns (graph, n_joined)."""
    import jax.numpy as jnp
    from ..mapping import index as eidx
    from ..mapping import mapper

    k = g.k
    E = g.capacity
    alive = np.asarray(edge_mask(g))
    start_v = np.asarray(g.start_v)
    end_v = np.asarray(g.end_v)
    conj = np.asarray(g.conj)
    lens = np.asarray(g.seq_len)

    v_space = 4 * E + 2
    out_deg = np.zeros(v_space, np.int64)
    in_deg = np.zeros(v_space, np.int64)
    for e in np.nonzero(alive)[0]:
        out_deg[start_v[e]] += 1
        in_deg[end_v[e]] += 1
    # forward tips: dead ends on the right; acceptors: dead starts
    dead_end = {int(e) for e in np.nonzero(alive)[0]
                if out_deg[end_v[e]] == 0}
    dead_start = {int(e) for e in np.nonzero(alive)[0]
                  if in_deg[start_v[e]] == 0}
    if not dead_end or not dead_start:
        return g, 0

    from ..utils.timetrace import scope as _scope
    with _scope("gc_build_index"):
        idx = eidx.build_edge_index(g, k + 1)
    from ..mapping import chunked
    c2rc = dna.revcomp_reads(jnp.asarray(codes2), jnp.asarray(lengths2))
    with _scope("gc_map_reads"):
        m1 = chunked.map_reads_chunked(idx, g.seq_len, jnp.asarray(codes1),
                                       jnp.asarray(lengths1), k + 1)
        m2 = chunked.map_reads_chunked(idx, g.seq_len, c2rc,
                                       jnp.asarray(lengths2), k + 1)
        m1 = mapper.normalize_mapping(m1, g.conj)
        m2 = mapper.normalize_mapping(m2, g.conj)

    # pair-support filtering ON DEVICE: only the deduplicated
    # (dead-end, dead-start) pairs cross to the host (the raw per-read
    # columns are MBs; the link moves KB/s)
    is_dead_end = np.zeros(E, bool)
    is_dead_end[list(dead_end)] = True
    is_dead_start = np.zeros(E, bool)
    is_dead_start[list(dead_start)] = True

    import jax

    @jax.jit
    def _support_pairs(oe1, oe2, ok1, ok2, de, ds):
        p1 = oe1 // 2
        p2 = oe2 // 2
        ok = ok1 & ok2 & (p1 != p2)
        ok = ok & de[jnp.clip(p1, 0, E - 1)] & ds[jnp.clip(p2, 0, E - 1)]
        key = jnp.where(ok, p1.astype(jnp.int64) * E + p2, -1)
        skey = jnp.sort(key)
        uniq = jnp.concatenate([skey[:1] != skey[:1],
                                skey[1:] != skey[:-1]]) & (skey >= 0)
        uniq = uniq | (jnp.arange(skey.shape[0]) == 0) & (skey >= 0)
        # run-length counts of the sorted keys
        idx = jnp.cumsum(uniq.astype(jnp.int32)) - 1
        n = skey.shape[0]
        counts = jnp.zeros((n,), jnp.int32).at[
            jnp.where(skey >= 0, idx, n - 1)].add(
            (skey >= 0).astype(jnp.int32), mode="drop")
        keys_out = jnp.zeros((n,), jnp.int64).at[
            jnp.where(uniq, idx, n - 1)].max(skey, mode="drop")
        n_uniq = jnp.sum(uniq.astype(jnp.int32))
        return keys_out, counts, n_uniq

    keys_out, counts_out, n_uniq = _support_pairs(
        jnp.asarray(m1.oriented_edge), jnp.asarray(m2.oriented_edge),
        jnp.asarray(m1.mapped), jnp.asarray(m2.mapped),
        jnp.asarray(is_dead_end), jnp.asarray(is_dead_start))
    nu = int(n_uniq)
    kh = np.asarray(keys_out[:max(nu, 1)])[:nu]
    ch = np.asarray(counts_out[:max(nu, 1)])[:nu]
    support = {(int(kk) // E, int(kk) % E): int(cc)
               for kk, cc in zip(kh, ch)}

    flat = dna.pull_codes_packed(g.seq_flat)
    starts = np.asarray(g.seq_start)

    def seq_of(e):
        return flat[starts[e]:starts[e] + lens[e]]

    joins = []
    used = set()
    for (e1, e2), cnt in sorted(support.items(), key=lambda kv: -kv[1]):
        if cnt < min_support:
            continue
        if e1 in used or e2 in used or conj[e1] in used or conj[e2] in used:
            continue
        if e2 == int(conj[e1]):
            continue  # joining an edge to its own conjugate = hairpin
        s1, s2 = seq_of(e1), seq_of(e2)
        scan = min(max_overlap_scan, len(s1), len(s2))
        best_ov, best_mism = 0, None
        for ov in range(scan, min_overlap - 1, -1):
            tail, head = s1[-ov:], s2[:ov]
            mism = np.nonzero(tail != head)[0]
            if len(mism) > hamming_bound:
                continue
            # low-complexity rejection (gap_closer.cpp:404-414): at the
            # shortest overlap forbid near-homopolymer overlaps, relax
            # linearly toward 0.8 identity at the longest
            counts = np.bincount(tail, minlength=4)
            gap = max(k - ov, 1)
            denom = max(k - min_overlap - 1, 1)
            ratio = 0.8 + 0.2 * (gap - 1) / denom
            if counts.max() > ratio * ov:
                break  # reference returns false for the pair
            best_ov, best_mism = ov, mism
            break
        if best_ov == 0:
            continue
        joins.append((int(e1), int(e2), best_ov, best_mism))
        used.update({e1, e2, int(conj[e1]), int(conj[e2])})

    if not joins:
        return g, 0

    # apply joins host-side: rebuild arrays with merged sequences
    new_alive = alive.copy()
    seqs = {}
    covs = np.asarray(g.cov).copy()
    new_start_v = start_v.copy()
    new_end_v = end_v.copy()
    new_conj = conj.copy()
    for e1, e2, ov, mism in joins:
        s1, s2 = seq_of(e1), seq_of(e2)
        if mism is not None and len(mism) > 0 and covs[e2] > covs[e1]:
            # correct the lower-coverage tip (first edge) to the
            # higher-coverage one (gap_closer.cpp:332-340 CorrectLeft)
            s1 = s1.copy()
            s1[len(s1) - ov:] = s2[:ov]
        merged = np.concatenate([s1, s2[ov:]])
        seqs[e1] = merged
        # conjugate join mirrors: conj(e2) + conj(e1)
        ce1, ce2 = int(conj[e1]), int(conj[e2])
        seqs[ce1] = np.asarray(
            dna.revcomp_codes(jnp.asarray(merged)))
        w1, w2 = max(lens[e1] - k, 1), max(lens[e2] - k, 1)
        covs[e1] = covs[ce1] = (covs[e1] * w1 + covs[e2] * w2) / (w1 + w2)
        new_end_v[e1] = end_v[e2]
        new_start_v[ce1] = start_v[ce2]
        new_conj[e1] = ce1
        new_conj[ce1] = e1
        new_alive[e2] = False
        new_alive[ce2] = False

    # repack flat buffer (id order == position order invariant)
    new_lens = lens.copy()
    for e, s in seqs.items():
        new_lens[e] = len(s)
    new_lens[~new_alive] = 0
    new_starts = np.zeros(E, np.int64)
    acc = 0
    needed = int(new_lens[new_alive].sum())
    FLAT = flat.shape[0]
    if needed > FLAT:  # grow to the next power of two; shapes stay static
        FLAT = 1 << max(needed - 1, 1).bit_length()
    new_flat = np.zeros(FLAT, np.uint8)
    for e in range(E):
        if not new_alive[e]:
            continue
        s = seqs.get(e, flat[starts[e]:starts[e] + lens[e]])
        new_starts[e] = acc
        new_flat[acc:acc + len(s)] = s
        acc += len(s)

    import jax.numpy as jnp2
    g2 = g._replace(
        seq_flat=jnp2.asarray(new_flat),
        seq_start=jnp2.asarray(new_starts.astype(np.int32)),
        seq_len=jnp2.asarray(new_lens.astype(np.int32)),
        cov=jnp2.asarray(covs),
        start_v=jnp2.asarray(new_start_v),
        end_v=jnp2.asarray(new_end_v),
        conj=jnp2.asarray(new_conj),
        alive=jnp2.asarray(new_alive),
    )
    return g2, len(joins)
