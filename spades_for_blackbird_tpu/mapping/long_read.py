"""Long-read-to-graph alignment: seed -> diagonal-chain -> edge path.

Device-side replacement of the reference's sensitive long-read aligner
(modules/alignment/pacbio/g_aligner.{hpp,cpp} ``GAligner::GetReadAlignment``
-> ``OneReadMapping``, clustered seed index at pac_index.hpp, gap closing
between seed clusters at gap_dijkstra.cpp): seed k-mer hits for the whole
long-read batch come from one device lookup sweep; per-read diagonal
clustering and cross-edge chaining walk tiny per-read hit lists on the
host (the reference's per-read loop); candidate joins are verified with
the batched banded edit-distance kernel (ops/align.py).

Error tolerance comes from short seeds (default 13): at 10-15% read error
an exact 13-mer occurs every few bases.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..graph.graph import Graph, edge_mask
from ..ops import dna, kmer as kmer_ops, segments
from . import index as eidx


@dataclass
class ChainedHit:
    edge: int          # forward edge id (normalized orientation)
    read_lo: int       # first read position supporting the edge
    read_hi: int       # last read position (seed start) + seed_k
    edge_lo: int       # matching edge interval
    edge_hi: int
    votes: int


@dataclass
class LongReadAlignment:
    read_id: int
    chain: list[ChainedHit] = field(default_factory=list)

    @property
    def edge_path(self) -> list[int]:
        return [h.edge for h in self.chain]


def align_long_reads(g: Graph, codes, lengths, seed_k: int = 13,
                     min_votes: int = 3, diag_slop: int = 40
                     ) -> list[LongReadAlignment]:
    """Align a batch of long reads to the graph."""
    import jax.numpy as jnp
    idx = eidx.build_edge_index(g, seed_k)
    conj = np.asarray(g.conj)
    seq_len = np.asarray(g.seq_len)

    codes = jnp.asarray(codes)
    lengths = jnp.asarray(lengths)
    kmers, valid = kmer_ops.extract_kmers(codes, lengths, seed_k)
    canon, read_fwd = dna.canonicalize_kmers(kmers, seed_k)
    R, P, W = canon.shape
    row = segments.searchsorted_rows(idx.kmers, canon.reshape(-1, W))
    row = row.reshape(R, P)
    found = np.asarray((row < idx.num) & valid)
    rown = np.asarray(jnp.minimum(row, idx.capacity - 1))
    edge = np.asarray(idx.edge)[rown]
    off = np.asarray(idx.offset)[rown]
    efwd = np.asarray(idx.is_fwd)[rown]
    rfwd = np.asarray(read_fwd)

    # normalize: read aligns forward onto fe
    same = rfwd == efwd
    fe = np.where(same, edge, conj[edge])
    fe_len = seq_len[fe]
    epos = np.where(same, off, fe_len - seed_k - off)
    diag = epos - np.arange(P)[None, :]      # implied read-start offset

    out = []
    for r in range(R):
        ok = np.nonzero(found[r])[0]
        if ok.size == 0:
            out.append(LongReadAlignment(r, []))
            continue
        hits = {}
        for p in ok:
            key = int(fe[r, p])
            hits.setdefault(key, []).append((int(p), int(epos[r, p]),
                                             int(diag[r, p])))
        cands = []
        for e, hlist in hits.items():
            hlist.sort()
            # cluster by diagonal into BANDS: a read revisiting the
            # same edge on a different diagonal (tandem copy, or a
            # structural variant between read and graph — the
            # truseq_analysis use case) yields one candidate per band,
            # not just the modal one
            diags = sorted(d for _, _, d in hlist)
            bands = [[diags[0]]]
            for d in diags[1:]:
                if d - bands[-1][-1] > diag_slop:
                    bands.append([d])
                else:
                    bands[-1].append(d)
            for band in bands:
                med = int(np.median(band))
                sel = [h for h in hlist if abs(h[2] - med) <= diag_slop
                       and band[0] <= h[2] <= band[-1]]
                if len(sel) < min_votes:
                    continue
                cands.append(ChainedHit(
                    edge=e,
                    read_lo=sel[0][0],
                    read_hi=sel[-1][0] + seed_k,
                    edge_lo=sel[0][1],
                    edge_hi=sel[-1][1] + seed_k,
                    votes=len(sel)))
        # greedy chain by read coordinate, dropping contained/conflicting
        cands.sort(key=lambda h: (h.read_lo, -h.votes))
        chain: list[ChainedHit] = []
        for h in cands:
            if chain and h.read_hi <= chain[-1].read_hi:
                continue  # contained in previous span
            if chain and h.read_lo < chain[-1].read_hi - 3 * seed_k and \
                    h.votes < chain[-1].votes:
                continue  # heavy overlap with a stronger hit
            chain.append(h)
        out.append(LongReadAlignment(r, chain))
    return out


def _graph_path_fill(g: Graph, e1: int, e2: int, read_fill: np.ndarray,
                     band: int = 48, ed_frac: float = 0.3,
                     max_paths: int = 8) -> np.ndarray | None:
    """Bounded graph-path search between e1's end and e2's start whose
    spelled sequence edit-matches the long read's gap segment
    (gap_dijkstra.cpp DijkstraGapFiller: SearchState over (vertex,
    read position) with an edit-distance bound). Enumerates candidate
    paths within a length window of the read segment, scores them with
    the banded-DP kernel, and returns the best path's sequence when it
    clears the bound — else None (caller falls back to read bases)."""
    import jax.numpy as jnp
    from ..ops import align as align_ops
    from ..path_extend.polisher import _paths_between

    alive = np.asarray(edge_mask(g))
    start_v = np.asarray(g.start_v)
    end_v = np.asarray(g.end_v)
    seq_len = np.asarray(g.seq_len)
    starts = np.asarray(g.seq_start)
    flat = dna.pull_codes_packed(g.seq_flat)
    k = g.k
    out_of: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        out_of.setdefault(int(start_v[e]), []).append(int(e))

    L = len(read_fill)
    cands = _paths_between(out_of, end_v, seq_len, k,
                           int(end_v[e1]), int(start_v[e2]),
                           max_len=L + max(band, int(0.2 * L)) + k,
                           max_paths=max_paths)
    # spell each candidate path's strict interior: every edge
    # contributes seq[k:] (dropping its shared start k-mer, already
    # spelled by the predecessor / by e1's tail), and the final k bases
    # duplicate e2's head k-mer and are dropped too
    seqs = []
    for path in cands:
        if not path:
            continue
        s = np.concatenate([flat[starts[m] + k: starts[m] + seq_len[m]]
                            for m in path])
        if len(s) < k:
            continue
        s = s[:len(s) - k]
        if abs(len(s) - L) <= max(band, int(0.2 * L)):
            seqs.append(s)
    if not seqs:
        return None
    B = len(seqs)
    M = max(max(len(s) for s in seqs), L, 1)
    ac = np.full((B, M), 4, np.uint8)
    bc = np.full((B, M), 4, np.uint8)
    al_ = np.zeros(B, np.int32)
    bl_ = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        ac[i, :len(s)] = s
        al_[i] = len(s)
        bc[i, :L] = read_fill
        bl_[i] = L
    d = np.asarray(align_ops.banded_edit_distance(
        jnp.asarray(ac), al_, jnp.asarray(bc), bl_, band=band))
    best = int(np.argmin(d))
    if d[best] <= ed_frac * max(L, 1):
        return seqs[best]
    return None


def hybrid_close_gaps(g: Graph, codes, lengths, seed_k: int = 13,
                      min_bridges: int = 2, band: int = 48,
                      max_fill: int = 2000) -> tuple[Graph, int]:
    """Join dead-end edge pairs bridged by long reads, filling the gap
    with the bridging read's sequence (the HybridLibrariesAligning stage +
    hybrid gap closer, projects/spades/hybrid_aligning.cpp:143-330 and
    hybrid_gap_closer.hpp). Fill sequences from multiple bridging reads
    are cross-validated with the banded edit-distance kernel.
    """
    import jax.numpy as jnp
    alignments = align_long_reads(g, codes, lengths, seed_k=seed_k)
    codes_np = np.asarray(codes)

    seq_len = np.asarray(g.seq_len)
    conj = np.asarray(g.conj)

    bridges: dict[tuple[int, int], list[np.ndarray]] = {}
    for al in alignments:
        for a, b in zip(al.chain, al.chain[1:]):
            # read segment between the matched intervals = gap fill;
            # clip to where the edges end/start
            tail_a = int(seq_len[a.edge]) - a.edge_hi  # unmatched edge tail
            head_b = b.edge_lo
            lo = a.read_hi + tail_a
            hi = b.read_lo - head_b
            if hi < lo - 3 * seed_k or hi - lo > max_fill:
                continue
            fill = codes_np[al.read_id][max(lo, 0):max(hi, 0)]
            key = (a.edge, b.edge)
            bridges.setdefault(key, []).append(fill)

    flat = dna.pull_codes_packed(g.seq_flat)
    starts = np.asarray(g.seq_start)
    joins = []
    used: set[int] = set()
    for (e1, e2), fills in sorted(bridges.items(),
                                  key=lambda kv: -len(kv[1])):
        if len(fills) < min_bridges or e1 == e2 or e2 == int(conj[e1]):
            continue
        if e1 in used or e2 in used or int(conj[e1]) in used or \
                int(conj[e2]) in used:
            continue
        # cross-validate fills pairwise with banded edit distance
        ref = fills[0]
        agree = 1
        L = max(max(len(f) for f in fills), 1)
        if len(fills) > 1:
            B = len(fills) - 1
            ac = np.full((B, L), 4, np.uint8)
            bc = np.full((B, L), 4, np.uint8)
            al_ = np.zeros(B, np.int32)
            bl_ = np.zeros(B, np.int32)
            for i, f in enumerate(fills[1:]):
                ac[i, :len(ref)] = ref
                al_[i] = len(ref)
                bc[i, :len(f)] = f
                bl_[i] = len(f)
            from ..ops import align as align_ops
            d = np.asarray(align_ops.banded_edit_distance(
                jnp.asarray(ac), jnp.asarray(al_), jnp.asarray(bc),
                jnp.asarray(bl_), band=band))
            agree += int(np.sum(d <= 0.35 * np.maximum(len(ref), bl_)))
        if agree < min_bridges:
            continue
        # graph-path gap search (the GAligner's gap Dijkstra,
        # modules/alignment/pacbio/gap_dijkstra.cpp): if a graph path
        # between the edges spells (within an edit-distance bound) the
        # read's gap segment, fill with the GRAPH sequence — assembled
        # bases instead of the error-prone long-read bases
        path_fill = _graph_path_fill(g, e1, e2, ref, band=band)
        joins.append((e1, e2, ref if path_fill is None else path_fill))
        used.update({e1, e2, int(conj[e1]), int(conj[e2])})

    if not joins:
        return g, 0

    # apply joins (same host-side rebuild as the paired gap closer)
    E = g.capacity
    alive = np.asarray(edge_mask(g)).copy()
    covs = np.asarray(g.cov).copy()
    start_v = np.asarray(g.start_v).copy()
    end_v = np.asarray(g.end_v).copy()
    new_conj = conj.copy()
    lens = seq_len.copy()
    seqs = {}

    def seq_of(e):
        return flat[starts[e]:starts[e] + lens[e]]

    for e1, e2, fill in joins:
        merged = np.concatenate([seq_of(e1), fill, seq_of(e2)])
        ce1, ce2 = int(conj[e1]), int(conj[e2])
        seqs[e1] = merged
        seqs[ce1] = np.asarray(dna.revcomp_codes(jnp.asarray(merged)))
        w1, w2 = max(lens[e1] - g.k, 1), max(lens[e2] - g.k, 1)
        covs[e1] = covs[ce1] = (covs[e1] * w1 + covs[e2] * w2) / (w1 + w2)
        end_v[e1] = end_v[e2]
        start_v[ce1] = start_v[ce2]
        alive[e2] = alive[ce2] = False

    new_lens = lens.copy()
    for e, s in seqs.items():
        new_lens[e] = len(s)
    new_lens[~alive] = 0
    FLAT = flat.shape[0]
    total = int(new_lens[alive].sum())
    new_flat = np.zeros(max(FLAT, total), np.uint8)
    new_starts = np.zeros(E, np.int64)
    acc = 0
    for e in range(E):
        if not alive[e]:
            continue
        s = seqs.get(e, flat[starts[e]:starts[e] + lens[e]])
        new_starts[e] = acc
        new_flat[acc:acc + len(s)] = s
        acc += len(s)

    g2 = g._replace(
        seq_flat=jnp.asarray(new_flat[:max(FLAT, total)]),
        seq_start=jnp.asarray(new_starts.astype(np.int32)),
        seq_len=jnp.asarray(new_lens.astype(np.int32)),
        cov=jnp.asarray(covs),
        start_v=jnp.asarray(start_v),
        end_v=jnp.asarray(end_v),
        conj=jnp.asarray(new_conj),
        alive=jnp.asarray(alive),
    )
    return g2, len(joins)
