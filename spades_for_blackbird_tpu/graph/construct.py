"""End-to-end graph construction: reads -> condensed de Bruijn graph.

Device-side equivalent of the reference Construction stage
(assembler/src/common/stages/construction.cpp:469-484: KMerCounting ->
ExtensionIndexBuilder -> GraphCondenser -> PHMCoverageFiller), fused into
jit regions over device arrays.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..kmers import counter, extension
from . import condense
from .graph import Graph


def graph_from_reads(codes, lengths, k: int, min_count: int = 1) -> Graph:
    """Build the condensed graph from a read batch.

    Args:
      codes: (R, L) uint8 read codes.
      lengths: (R,) int32.
      k: vertex k-mer size (edges are built from (k+1)-mers, matching the
        reference where graph K = k and the extension index counts
        (k+1)-mers, kmer_extension_index_builder.hpp:45).
      min_count: drop (k+1)-mers seen fewer times (the reference's CQF
        coverage filter / hammer handle this; a hard floor of 1 keeps all).
    """
    kp1 = counter.count_kmers(codes, lengths, k + 1)
    if min_count > 1:
        kp1 = counter.filter_min_count(kp1, min_count)
    vt = extension.trim_vertex_table(extension.build_vertex_table(kp1, k))
    return condense.build_graph(kp1, vt, k)


def graph_from_sequences(seqs: list[str], k: int) -> Graph:
    """Trivial graph: one conjugate edge pair per sequence, fresh
    vertices (no gluing).  Used by the standalone corrector, which polishes
    given contigs rather than a de Bruijn graph
    (projects/corrector/dataset_processor.cpp:173 splits contigs and
    processes each independently)."""
    import jax.numpy as jnp
    import numpy as np
    from ..ops import dna as dna_ops
    E = 2 * len(seqs)
    lens = np.zeros(E, np.int32)
    codes = []
    for i, s in enumerate(seqs):
        c = dna_ops.encode_str(s)
        codes.append(c)
        codes.append(np.asarray(dna_ops.revcomp_codes(jnp.asarray(c))))
        lens[2 * i] = lens[2 * i + 1] = len(s)
    flat = np.concatenate(codes) if codes else np.zeros(1, np.uint8)
    starts = np.zeros(E, np.int32)
    acc = 0
    for e in range(E):
        starts[e] = acc
        acc += int(lens[e])
    start_v = np.arange(E, dtype=np.int32) * 2
    end_v = np.arange(E, dtype=np.int32) * 2 + 1
    # conjugate vertex pairing: start(e) conj = end(conj e)
    start_v = np.zeros(E, np.int32)
    end_v = np.zeros(E, np.int32)
    for i in range(len(seqs)):
        start_v[2 * i] = 4 * i
        end_v[2 * i] = 4 * i + 2
        start_v[2 * i + 1] = 4 * i + 3
        end_v[2 * i + 1] = 4 * i + 1
    conj = np.asarray([e ^ 1 for e in range(E)], np.int32)
    return Graph(
        seq_flat=jnp.asarray(flat),
        seq_start=jnp.asarray(starts),
        seq_len=jnp.asarray(lens),
        cov=jnp.zeros(E, jnp.float32),
        start_v=jnp.asarray(start_v),
        end_v=jnp.asarray(end_v),
        conj=jnp.asarray(conj),
        alive=jnp.ones(E, bool),
        num_edges=jnp.int32(E),
        k=k)


def graph_stats(g: Graph) -> dict:
    """Host-side summary stats (edge count, total length, N50-ish)."""
    import numpy as np
    alive = np.asarray(g.alive) & (np.arange(g.capacity) < int(g.num_edges))
    lens = np.asarray(g.seq_len)[alive]
    covs = np.asarray(g.cov)[alive]
    if lens.size == 0:
        return {"edges": 0, "total_len": 0, "max_len": 0, "mean_cov": 0.0}
    slens = np.sort(lens)[::-1]
    half = slens.sum() / 2
    n50 = int(slens[np.cumsum(slens) >= half][0])
    return {
        "edges": int(alive.sum()),
        "total_len": int(lens.sum()),
        "max_len": int(lens.max()),
        "n50": n50,
        "mean_cov": float((covs * lens).sum() / lens.sum()),
    }
