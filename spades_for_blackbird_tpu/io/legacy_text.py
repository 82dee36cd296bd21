"""Loader for the reference's legacy text graph saves.

The reference ships curated graph fragments for its simplification unit
tests in an old ``.grp/.sqn/.cvr/.flcvr`` text format, parsed by a
test-only reader (src/test/debruijn/graphio.cpp:36-266 ``LegacyTextIO``).
This module reads the same format into the relational ``Graph`` so
the reference's fixture-driven simplification tests can run against our
cleaners (simplification_test.cpp:147-340).

Format (all ids are the reference's conjugate-paired integer ids):

- ``.grp``   — header ``V E``, then ``Vertex v ~ conj .`` lines, then
               ``Edge e : u -> w, l = L ~ conj .`` lines (L in k-mers).
- ``.sqn``   — FASTA of edge nucleotide sequences (len = L + k), or the
               old ``E\\n eid SEQ .`` form.
- ``.cvr``   — ``count`` then ``eid avg_cov .`` per edge
               (CoverageIndex::Load sets the average directly,
               core/coverage.hpp:99-103).
- ``.flcvr`` — ``count`` then ``eid raw .`` where the average flank =
               raw / min(length_kmers, averaging_range)
               (detail_coverage.hpp:44-50; GraphPack uses
               averaging_range = 50, pipeline/graph_pack.hpp:21).
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..ops import dna
from ..graph.graph import Graph, compact_graph

_VERTEX_RE = re.compile(r"Vertex\s+(\d+)\s+~\s+(\d+)")
_EDGE_RE = re.compile(
    r"Edge\s+(\d+)\s+:\s+(\d+)\s+->\s+(\d+),\s+l\s+=\s+(\d+)\s+~\s+(\d+)")


def _read_sequences(path: str) -> dict[int, str]:
    """Edge id -> nucleotide string, FASTA or old two-token format."""
    seqs: dict[int, str] = {}
    with open(path) as f:
        text = f.read()
    if text.lstrip().startswith(">"):
        cur = None
        buf: list[str] = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if cur is not None:
                    seqs[cur] = "".join(buf)
                cur = int(line[1:].split()[0])
                buf = []
            else:
                buf.append(line)
        if cur is not None:
            seqs[cur] = "".join(buf)
    else:
        toks = text.split()
        i = 1  # skip leading edge count
        while i + 1 < len(toks):
            eid = int(toks[i])
            seqs[eid] = toks[i + 1]
            i += 3 if i + 2 < len(toks) and toks[i + 2] == "." else 2
    return seqs


def _read_edge_floats(path: str) -> dict[int, float]:
    vals: dict[int, float] = {}
    with open(path) as f:
        toks = f.read().split()
    i = 1  # skip count
    while i + 1 < len(toks):
        vals[int(toks[i])] = float(toks[i + 1])
        i += 3 if i + 2 < len(toks) and toks[i + 2] == "." else 2
    return vals


def load_legacy_graph(prefix: str, averaging_range: int = 50
                      ) -> tuple[Graph, int]:
    """Load ``prefix + .grp/.sqn[/.cvr/.flcvr]`` as (Graph, v_space).

    k is inferred from any edge as len(sequence) - length_kmers
    (the fixtures are all k=55 graphs). Vertex conjugate pairs map to
    oriented ids 2i / 2i+1; edge conjugates are kept explicit, matching
    graphio.cpp:40-135 ``LoadGraph``.
    """
    import jax.numpy as jnp

    with open(prefix + ".grp") as f:
        grp = f.read()
    vertices: list[tuple[int, int]] = [
        (int(a), int(b)) for a, b in _VERTEX_RE.findall(grp)]
    edges = [(int(e), int(u), int(w), int(l), int(c))
             for e, u, w, l, c in _EDGE_RE.findall(grp)]
    if not edges:
        raise ValueError(f"{prefix}.grp: no edges")
    seqs = _read_sequences(prefix + ".sqn")
    cov = _read_edge_floats(prefix + ".cvr") if os.path.exists(
        prefix + ".cvr") else {}
    flraw = _read_edge_floats(prefix + ".flcvr") if os.path.exists(
        prefix + ".flcvr") else {}

    # infer k from sequence length vs k-mer length
    e0, _, _, l0, _ = edges[0]
    k = len(seqs[e0]) - l0
    if k <= 0:
        raise ValueError(f"{prefix}: inconsistent .sqn/.grp lengths")

    # oriented vertex ids: first-seen of each conjugate pair -> 2i
    vmap: dict[int, int] = {}
    nbase = 0
    for a, b in vertices:
        if a in vmap:
            continue
        vmap[a] = 2 * nbase
        vmap[b] = 2 * nbase + 1 if b != a else 2 * nbase
        nbase += 1

    E = len(edges)
    erow = {e: i for i, (e, *_rest) in enumerate(edges)}
    start_v = np.zeros(E, np.int32)
    end_v = np.zeros(E, np.int32)
    conj = np.zeros(E, np.int32)
    lens = np.zeros(E, np.int32)
    covs = np.zeros(E, np.float32)
    flank = np.zeros(E, np.float32)
    flat_parts = []
    seq_start = np.zeros(E, np.int32)
    acc = 0
    for i, (e, u, w, l, c) in enumerate(edges):
        start_v[i] = vmap[u]
        end_v[i] = vmap[w]
        conj[i] = erow[c]
        s = seqs[e]
        if len(s) != l + k:
            raise ValueError(f"{prefix}: edge {e} length mismatch")
        codes = dna.encode_str(s)
        seq_start[i] = acc
        flat_parts.append(codes)
        acc += len(codes)
        lens[i] = len(s)
        covs[i] = cov.get(e, 0.0)
        flank[i] = flraw.get(e, 0.0) / max(min(l, averaging_range), 1)

    g = Graph(
        seq_flat=jnp.asarray(np.concatenate(flat_parts)),
        seq_start=jnp.asarray(seq_start),
        seq_len=jnp.asarray(lens),
        cov=jnp.asarray(covs),
        start_v=jnp.asarray(start_v),
        end_v=jnp.asarray(end_v),
        conj=jnp.asarray(conj),
        alive=jnp.ones(E, bool),
        num_edges=jnp.asarray(E, np.int32),
        k=int(k),
        flank=jnp.asarray(flank) if flraw else None,
    )
    return compact_graph(g)
