"""biosyntheticSPAdes: domain extraction, restricted edges, domain graph.

Device-side counterparts of the bio(synthetic) mode stages:

- :func:`extract_domains` — ``ExtractDomains``
  (projects/spades/extract_domains.cpp + domain_matcher.cpp:36-110):
  translate every contig in 3 frames on both strands, score all frames
  against each profile HMM in one batched Viterbi call (ops/hmm.py), and
  write the hit subsequences to ``temp_anti/restricted_edges.fasta``
  (domain_matcher.cpp:157-172).
- :func:`fill_restricted_edges` — ``RestrictedEdgesFilling``
  (projects/spades/restricted_edges_filling.cpp:16-41, the blackbird
  fork's edge-masking feature): map each restricted sequence onto the
  graph and collect the touched edges (+ conjugates); these edges are
  protected from bulge removal during simplification
  (stages/simplification.cpp:200-212 bulge_callback).
- :func:`build_domain_graph` / :func:`bgc_candidates` —
  ``DomainGraphConstruction`` (projects/spades/domain_graph_construction.cpp,
  domain_graph.cpp): order domain hits along contigs, connect hits
  within ``max_gap``, emit candidate BGC (biosynthetic gene cluster)
  chains and their sequences.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..graph.graph import Graph, edge_mask
from ..ops import aa as aa_ops
from ..ops import hmm as hmm_ops


@dataclass
class DomainHit:
    name: str          # model name
    desc: str
    contig: int        # contig index
    strand: int        # +1 / -1 relative to the contig as given
    nt_start: int      # on the contig's forward strand
    nt_end: int        # exclusive
    score: float
    seq: str           # nucleotide subsequence (forward strand of contig)


_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def _rc(s: str) -> str:
    # tolerate N/lowercase/IUPAC bases in external FASTA (mapped to A,
    # matching dna.encode_reads' tolerant encoding)
    return "".join(_COMP.get(c.upper(), "T") for c in reversed(s))


def extract_domains(contigs: list[str], profiles,
                    score_threshold: float = 20.0,
                    min_model_frac: float = 0.1,
                    output_dir: str | None = None) -> list[DomainHit]:
    """Match every profile against 3 frames x 2 strands of every contig.

    ``min_model_frac``: discard hits spanning less than this fraction of
    the model (domain_matcher.cpp:57 'Fragmented hit' filter uses 1/10).
    """
    frames = []   # (contig_idx, strand, frame, aa_codes)
    for ci, seq in enumerate(contigs):
        for strand, s in ((1, seq), (-1, _rc(seq))):
            dna_codes = np.asarray(
                [_CODE.get(c.upper(), 0) for c in s], np.uint8)
            for fr in range(3):
                aa_codes = aa_ops.translate_codes(dna_codes, fr)
                if len(aa_codes):
                    frames.append((ci, strand, fr, aa_codes))
    if not frames:
        return []
    L = max(len(f[3]) for f in frames)
    B = len(frames)
    seqs = np.full((B, L), aa_ops.STOP, np.uint8)
    lengths = np.zeros(B, np.int32)
    for i, (_, _, _, ac) in enumerate(frames):
        seqs[i, :len(ac)] = ac
        lengths[i] = len(ac)

    hits: list[DomainHit] = []
    for prof in profiles:
        es, st = hmm_ops.score_batch(prof, seqs, lengths)
        min_span = max(1, int(min_model_frac * prof.length))
        for i, (ci, strand, fr, _) in enumerate(frames):
            for a, b, s in hmm_ops.find_hits(es[i], st[i], int(lengths[i]),
                                             score_threshold, min_span):
                nt_a = a * 3 + fr
                nt_b = (b + 1) * 3 + fr
                clen = len(contigs[ci])
                if strand < 0:
                    nt_a, nt_b = clen - nt_b, clen - nt_a
                hits.append(DomainHit(
                    name=prof.name, desc=prof.desc, contig=ci,
                    strand=strand, nt_start=nt_a, nt_end=nt_b,
                    score=float(s), seq=contigs[ci][nt_a:nt_b]))

    if output_dir is not None:
        tdir = os.path.join(output_dir, "temp_anti")
        os.makedirs(tdir, exist_ok=True)
        with open(os.path.join(tdir, "restricted_edges.fasta"), "w") as f:
            for i, h in enumerate(hits):
                f.write(f">{h.name}_{h.contig}_{i}\n{h.seq}\n")
    return hits


def fill_restricted_edges(g: Graph, seqs: list[str]) -> np.ndarray:
    """Edges (bool mask, conjugate-closed) touched by any sequence —
    restricted_edges_filling.cpp:16-41 (MapSequence().simple_path() over
    restricted_edges.fasta, inserting edge + conjugate)."""
    import jax.numpy as jnp
    from ..mapping import index as eidx
    from ..mapping import mapper
    from ..ops import dna

    mask = np.zeros(g.capacity, bool)
    seqs = [s for s in seqs if len(s) > g.k]
    if not seqs:
        return mask
    k = g.k
    idx = eidx.build_edge_index(g, k + 1)
    codes, lengths = dna.encode_reads(seqs)
    edge, _, _, found = mapper.map_kmers(idx, jnp.asarray(codes),
                                         jnp.asarray(lengths), k + 1)
    edge = np.asarray(edge)
    found = np.asarray(found)
    edges = np.unique(edge[found])
    mask[edges] = True
    conj = np.asarray(g.conj)
    mask[conj[edges]] = True
    mask &= np.asarray(edge_mask(g))
    return mask


def load_restricted_fasta(path: str) -> list[str]:
    seqs = []
    if not os.path.exists(path):
        return seqs
    cur = []
    for line in open(path):
        if line.startswith(">"):
            if cur:
                seqs.append("".join(cur))
            cur = []
        else:
            cur.append(line.strip())
    if cur:
        seqs.append("".join(cur))
    return seqs


def build_domain_graph(hits: list[DomainHit], max_gap: int = 10000):
    """Arcs between consecutive domain hits on the same contig+strand
    within ``max_gap`` nt (domain_graph.cpp connectivity, restricted to
    the resolved-path coordinate space where our hits already live)."""
    arcs = []
    by_key: dict[tuple[int, int], list[int]] = {}
    for i, h in enumerate(hits):
        by_key.setdefault((h.contig, h.strand), []).append(i)
    for key, idxs in by_key.items():
        idxs.sort(key=lambda i: hits[i].nt_start)
        for a, b in zip(idxs[:-1], idxs[1:]):
            gap = hits[b].nt_start - hits[a].nt_end
            if gap <= max_gap:
                arcs.append((a, b, gap))
    return arcs


def bgc_candidates(hits: list[DomainHit], arcs) -> list[list[int]]:
    """Chains of connected domain hits (candidate gene clusters)."""
    nxt = {}
    has_prev = set()
    for a, b, _ in arcs:
        nxt.setdefault(a, b)
        has_prev.add(b)
    chains = []
    for i in range(len(hits)):
        if i in has_prev or i not in nxt:
            continue
        chain = [i]
        while chain[-1] in nxt:
            chain.append(nxt[chain[-1]])
        chains.append(chain)
    # singletons that belong to no arc still form 1-domain candidates
    in_chain = {i for c in chains for i in c}
    for i in range(len(hits)):
        if i not in in_chain and i not in has_prev:
            chains.append([i])
    return chains


def write_bgc_outputs(output_dir: str, contigs: list[str],
                      hits: list[DomainHit], chains: list[list[int]],
                      min_domains: int = 1) -> int:
    """gene_clusters.fasta + bgc_statistics.txt + domain_graph.dot
    (biosyntheticSPAdes output surface)."""
    n = 0
    with open(os.path.join(output_dir, "gene_clusters.fasta"), "w") as f, \
            open(os.path.join(output_dir, "bgc_statistics.txt"), "w") as s:
        for chain in chains:
            if len(chain) < min_domains:
                continue
            hs = [hits[i] for i in chain]
            ci = hs[0].contig
            lo = min(h.nt_start for h in hs)
            hi = max(h.nt_end for h in hs)
            seq = contigs[ci][lo:hi]
            n += 1
            names = "+".join(h.name for h in hs)
            f.write(f">cluster_{n}_{names}_len_{len(seq)}\n{seq}\n")
            s.write(f"cluster {n}: contig {ci} [{lo},{hi}) "
                    f"domains {names} strand "
                    f"{'+' if hs[0].strand > 0 else '-'}\n")
    with open(os.path.join(output_dir, "domain_graph.dot"), "w") as d:
        d.write("digraph domain_graph {\n")
        for i, h in enumerate(hits):
            d.write(f'  h{i} [label="{h.name}@{h.contig}:'
                    f'{h.nt_start}-{h.nt_end}"];\n')
        for a, b, gap in build_domain_graph(hits):
            d.write(f'  h{a} -> h{b} [label="{gap}"];\n')
        d.write("}\n")
    return n
