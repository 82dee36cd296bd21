"""Plasmid extraction: iterative chromosome removal + circularity.

Device-side counterpart of plasmidSPAdes' ChromosomeRemover
(common/modules/chromosome_remover.cpp):

- ``run_isolated_pipeline`` — RunIsolatedPipeline (chromosome_remover.cpp:409-432):
  length-weighted-median coverage of long edges, iterated
  RemoveLongGenomicEdges + PlasmidSimplify to fixpoint (<=30 iters),
  then FilterSmallComponents.
- ``run_meta_pipeline`` — RunMetaPipeline (chromosome_remover.cpp:352-407):
  coverage filter at an external rising cutoff (self-loops kept),
  dead-end simplify with the initial tip-end vertices forbidden,
  suspicious-component output, FilterSmallComponents.
- ``metaplasmid_iterate`` — the metaextrachromosomal driver loop
  (projects/spades/pipeline.cpp:85-97 AddMetaplasmidStages): cutoff
  walks cov -> max(cov+additive_step, cov*relative_step) up to 600.

Deletions are alive-mask updates; chains re-merge through the jitted
``recondense`` kernel; connected components are a vectorized union-find
over the edge table instead of the reference's per-edge BFS
(CalculateComponentSize, chromosome_remover.cpp:51-94).

Circular candidate output mirrors contig_output_stage.cpp:213-240.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graph.graph import Graph, compact_graph, edge_mask
from ..ops import dna
from ..utils.logger import get_logger

_log = get_logger("ChromosomeRemover")

# chromosome_remover.cpp:142 — long edges in a small, deadend-free
# component are spared (potential mega-plasmid).
LARGE_COMPONENT_BOUND = 300_000
MAX_ITERATION_COUNT = 30  # chromosome_remover.hpp:41


@dataclass(frozen=True)
class PlasmidParams:
    """configs/debruijn/plasmid_mode.info defaults."""
    long_edge_length: int = 1000
    relative_coverage: float = 0.3
    small_component_size: int = 10_000
    small_component_relative_coverage: float = 1.5
    min_component_length: int = 10_000
    min_isolated_length: int = 1000
    additive_step: int = 5
    relative_step: float = 1.3
    max_coverage_limit: int = 600  # pipeline.cpp:88 max_cov


def _np(g: Graph):
    return (np.asarray(edge_mask(g)), np.asarray(g.seq_len),
            np.asarray(g.cov), np.asarray(g.conj),
            np.asarray(g.start_v), np.asarray(g.end_v))


def _degrees(sv, ev, alive):
    # sized over ALL rows: callers index with dead rows' stale ids too
    n = int(max(sv.max(initial=0), ev.max(initial=0))) + 1
    out_deg = np.bincount(sv[alive], minlength=n)
    in_deg = np.bincount(ev[alive], minlength=n)
    return out_deg, in_deg


class _UF:
    def __init__(self, n):
        self.p = np.arange(n)

    def find(self, x):
        p = self.p
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[max(ra, rb)] = min(ra, rb)


def _components(g: Graph):
    """Per-edge component label + component stats.

    Matches CalculateComponentSize semantics: components include both
    strands (the BFS adds g.conjugate(cur)); ``comp_len`` is the
    both-strand cumulative edge length; ``deadends`` counts dead-start /
    dead-end incidences over the component's edges.

    Returns (comp_of_edge[-1 for dead], comp_len, comp_deadends) where
    the stats arrays are indexed by component root label.
    """
    alive, lens, covs, conj, sv, ev = _np(g)
    E = len(alive)
    uf = _UF(E)
    ids = np.nonzero(alive)[0]
    for e in ids:
        uf.union(e, conj[e])
    # union edges sharing a vertex: sort incidences by vertex
    verts = np.concatenate([sv[ids], ev[ids]])
    edges = np.concatenate([ids, ids])
    order = np.argsort(verts, kind="stable")
    verts, edges = verts[order], edges[order]
    for i in range(1, len(verts)):
        if verts[i] == verts[i - 1]:
            uf.union(edges[i], edges[i - 1])
    comp = np.full(E, -1, np.int64)
    for e in ids:
        comp[e] = uf.find(e)
    out_deg, in_deg = _degrees(sv, ev, alive)
    comp_len = np.zeros(E, np.int64)
    comp_dead = np.zeros(E, np.int64)
    np.add.at(comp_len, comp[ids], lens[ids])
    dead_inc = ((in_deg[sv[ids]] == 0).astype(np.int64)
                + (out_deg[ev[ids]] == 0).astype(np.int64))
    np.add.at(comp_dead, comp[ids], dead_inc)
    return comp, comp_len, comp_dead


def _vertex_component_weights(g: Graph) -> dict[int, int]:
    """Component length per incident vertex (long_vertex_component_)."""
    alive, lens, covs, conj, sv, ev = _np(g)
    comp, comp_len, _ = _components(g)
    ids = np.nonzero(alive)[0]
    w: dict[int, int] = {}
    for e in ids:
        cl = int(comp_len[comp[e]])
        w[int(sv[e])] = cl
        w[int(ev[e])] = cl
    return w


def _weighted_median(cov, length):
    """Length-weighted median coverage
    (CoverageUniformityAnalyzer::CountMedianCoverage)."""
    if len(cov) == 0:
        return 0.0
    order = np.argsort(cov, kind="stable")
    c, w = cov[order], length[order].astype(np.float64)
    cum = np.cumsum(w)
    return float(c[np.searchsorted(cum, cum[-1] / 2.0)])


def _delete(g: Graph, kill: np.ndarray) -> Graph:
    conj = np.asarray(g.conj)
    kill = kill | kill[conj]
    return g._replace(alive=np.asarray(g.alive) & ~kill)


def _compress(g: Graph, v_space: int) -> Graph:
    from ..simplify.recondense import recondense
    return recondense(g, v_space)


def _v_space(g: Graph) -> int:
    """Pow2 upper bound on oriented vertex ids (stable jit shapes)."""
    alive, _, _, _, sv, ev = _np(g)
    hi = int(max(sv[alive].max(initial=0), ev[alive].max(initial=0))) + 1
    return 1 << max(3, (hi - 1).bit_length())


def _num_vertices(g: Graph) -> int:
    alive, _, _, _, sv, ev = _np(g)
    if not alive.any():
        return 0
    return len(np.unique(np.concatenate([sv[alive], ev[alive]])))


def remove_long_genomic_edges(g: Graph, v_space: int,
                              params: PlasmidParams,
                              external_cov: float = 0.0,
                              log=None):
    """RemoveLongGenomicEdges (chromosome_remover.cpp:96-154).

    Deletes long edges whose coverage sits within
    (1 +- relative_coverage) of the chromosomal median, sparing long
    edges inside small deadend-free components (possible mega-plasmids).
    Returns (graph, median_coverage, vertex_component_weights).
    """
    alive, lens, covs, conj, sv, ev = _np(g)
    long_mask = alive & (lens > params.long_edge_length)
    total_len = int(lens[long_mask].sum())
    if total_len == 0:
        if log:
            log("plasmid: no long edges left, stopping detection")
        return g, 0.0, {}
    if external_cov < 1.0:
        median = _weighted_median(covs[long_mask], lens[long_mask])
        lo = median * (1 - params.relative_coverage)
        hi = median * (1 + params.relative_coverage)
        good = long_mask & (covs > lo) & (covs < hi)
        fraction = lens[good].sum() / max(total_len, 1)
        if log and fraction < 0.8:
            log("plasmid: >20% of long-edge bases deviate from the "
                "median coverage — uneven coverage or contamination; "
                "plasmid results may be unreliable")
    else:
        median = external_cov
    comp, comp_len, comp_dead = _components(g)
    weights = {}
    ids = np.nonzero(alive)[0]
    for e in ids:
        cl = int(comp_len[comp[e]])
        weights[int(sv[e])] = cl
        weights[int(ev[e])] = cl
    lo = median * (1 - params.relative_coverage)
    hi = median * (1 + params.relative_coverage)
    kill = long_mask & (covs < hi) & (covs > lo)
    # spare small deadend-free components (chromosome_remover.cpp:142)
    spare = ((comp_len[comp] < LARGE_COMPONENT_BOUND)
             & (comp_dead[comp] == 0))
    kill &= ~spare
    if kill.any():
        g = _compress(_delete(g, kill), v_space)
    return g, median, weights


def plasmid_simplify(g: Graph, v_space: int, long_edge_bound: int,
                     forbidden: set[int] | None = None) -> Graph:
    """PlasmidSimplify (chromosome_remover.cpp:176-196): iterated
    dead-end clipping of edges <= long_edge_bound, with compression,
    skipping edges incident to forbidden vertices."""
    forbidden = forbidden or set()
    for _ in range(10):
        alive, lens, covs, conj, sv, ev = _np(g)
        if not alive.any():
            return g
        out_deg, in_deg = _degrees(sv, ev, alive)
        dead_v = (out_deg * in_deg) == 0  # tip_clipper.hpp:218
        kill = (alive & (lens <= long_edge_bound)
                & (dead_v[sv] | dead_v[ev])
                & ((out_deg[ev] + in_deg[sv]) >= 1))
        if forbidden:
            allowed = ~np.isin(sv, list(forbidden)) \
                & ~np.isin(ev, list(forbidden))
            kill &= allowed
        if not kill.any():
            break
        g = _compress(_delete(g, kill), v_space)
    return g


def coverage_filter(g: Graph, v_space: int, cutoff: float) -> Graph:
    """CoverageFilter (chromosome_remover.cpp:156-174): drop every edge
    below the cutoff except perfect cycles."""
    alive, lens, covs, conj, sv, ev = _np(g)
    kill = alive & (covs < cutoff) & (sv != ev)
    if not kill.any():
        return g
    return _compress(_delete(g, kill), v_space)


def filter_small_components(g: Graph, v_space: int,
                            params: PlasmidParams,
                            chromosome_cov: float,
                            old_weights: dict[int, int],
                            forbidden: set[int] | None = None) -> Graph:
    """FilterSmallComponents (chromosome_remover.cpp:434-505): iterated
    removal of (a) isolated edges split off big components, (b) fake
    small components at chromosomal coverage, (c) short dead-ended
    components, followed by compression + PlasmidSimplify."""
    for _ in range(MAX_ITERATION_COUNT):
        before = _num_vertices(g)
        alive, lens, covs, conj, sv, ev = _np(g)
        if not alive.any():
            return g
        comp, comp_len, comp_dead = _components(g)
        out_deg, in_deg = _degrees(sv, ev, alive)
        small = comp_len[comp] < 2 * params.small_component_size
        oldw = np.asarray([old_weights.get(int(v), 0) for v in sv])
        # (a) isolated edges that used to live in large components
        isolated = (alive & small
                    & (out_deg[ev] == 0) & (in_deg[sv] == 0)
                    & (oldw > comp_len[comp]
                       + 2 * params.long_edge_length))
        # (b) fake small components at ~chromosomal coverage
        rel = params.small_component_relative_coverage
        fake = (alive & small
                & (oldw > 4 * params.small_component_size)
                & (covs < chromosome_cov * (1 + rel))
                & (covs > chromosome_cov * (1 - rel)))
        # (c) short components with dead ends
        keep = ((comp_dead[comp] == 0)
                & (lens > params.min_isolated_length))
        shorty = (alive
                  & (comp_len[comp] < 2 * params.min_component_length)
                  & ~keep)
        kill = isolated | fake | shorty
        if kill.any():
            g = _compress(_delete(g, kill), v_space)
        g = plasmid_simplify(g, v_space, params.long_edge_length,
                             forbidden)
        if _num_vertices(g) == before:
            break
    return g


def run_isolated_pipeline(g: Graph, params: PlasmidParams | None = None,
                          log=None) -> Graph:
    """RunIsolatedPipeline (chromosome_remover.cpp:409-432)."""
    params = params or PlasmidParams()
    log = log or _log.info
    g, v_space = compact_graph(g)
    # old_vertex_weights reflect the INITIAL graph: the reference fills
    # long_vertex_component_ only in the first RemoveLongGenomicEdges
    # call (the external_cov < 1.0 branch, chromosome_remover.cpp:215),
    # so later iterations must not overwrite them
    g, chrom_cov, initial_weights = remove_long_genomic_edges(
        g, v_space, params, log=log)
    g = plasmid_simplify(g, v_space, params.long_edge_length)
    for _ in range(MAX_ITERATION_COUNT):
        before = _num_vertices(g)
        g, _, _ = remove_long_genomic_edges(
            g, v_space, params, external_cov=chrom_cov, log=log)
        g = plasmid_simplify(g, v_space, params.long_edge_length)
        if _num_vertices(g) == before:
            break
    return filter_small_components(g, v_space, params, chrom_cov,
                                   initial_weights)


def tip_end_vertices(g: Graph) -> set[int]:
    """FillForbiddenSet (chromosome_remover.cpp:43-49): vertices that
    are dead starts or dead ends in the *initial* graph."""
    alive, lens, covs, conj, sv, ev = _np(g)
    if not alive.any():
        return set()
    out_deg, in_deg = _degrees(sv, ev, alive)
    forb = set()
    for e in np.nonzero(alive)[0]:
        if in_deg[sv[e]] == 0:
            forb.add(int(sv[e]))
        if out_deg[ev[e]] == 0:
            forb.add(int(ev[e]))
    return forb


def suspicious_components(g: Graph, ext_limit: float,
                          params: PlasmidParams | None = None,
                          used_edges: set[int] | None = None):
    """OutputSuspiciousComponents (chromosome_remover.cpp:273-352):
    mid-size, few-deadend components with uniform coverage comfortably
    above the current cutoff. Returns a list of components, each a list
    of (edge_id, sequence, length, coverage) over canonical edges."""
    params = params or PlasmidParams()
    used_edges = used_edges or set()
    alive, lens, covs, conj, sv, ev = _np(g)
    comp, comp_len, comp_dead = _components(g)
    starts = np.asarray(g.seq_start)
    flat = dna.pull_codes_packed(g.seq_flat)
    out = []
    for root in np.unique(comp[comp >= 0]):
        members = np.nonzero(comp == root)[0]
        comp_size = int(comp_len[root]) // 2  # conjugate, so /2
        if not (1000 < comp_size < 200_000):
            continue
        if comp_dead[root] > 4:
            continue
        total_len = int(lens[members].sum())
        used_len = sum(int(lens[e]) for e in members
                       if int(e) in used_edges
                       or int(conj[e]) in used_edges)
        if 2 * used_len > total_len:
            continue  # already covered by found circular paths
        avg = _weighted_median(covs[members], lens[members])
        good_len = int(lens[members][
            (covs[members] > 0.7 * avg)
            & (covs[members] < 1.3 * avg)].sum())
        if avg < ext_limit * 1.3:
            continue  # component coverage close to current cutoff
        if good_len < 0.8 * total_len:
            continue  # coverage too variable
        records = []
        for e in members:
            if conj[e] < e and alive[conj[e]]:
                continue
            seq = dna.decode_codes(
                flat[starts[e]:starts[e] + lens[e]])
            records.append((int(e), seq, int(lens[e]), float(covs[e])))
        out.append(records)
    return out


def run_meta_pipeline(g: Graph, ext_limit: float,
                      params: PlasmidParams | None = None,
                      forbidden: set[int] | None = None,
                      used_edges: set[int] | None = None,
                      log=None):
    """RunMetaPipeline (chromosome_remover.cpp:352-407) for one
    external coverage cutoff. Expects a *compacted* graph plus its
    v_space-stable forbidden tip-end set; returns
    (graph, suspicious_components)."""
    params = params or PlasmidParams()
    v_space = _v_space(g)  # ids must stay stable vs the forbidden set
    suspicious = suspicious_components(g, ext_limit, params, used_edges)
    weights = _vertex_component_weights(g)
    g = coverage_filter(g, v_space, float(ext_limit))
    g = plasmid_simplify(g, v_space, params.long_edge_length, forbidden)
    g = filter_small_components(g, v_space, params, float(ext_limit),
                                weights, forbidden)
    return g, suspicious


def metaplasmid_iterate(g: Graph, params: PlasmidParams | None = None,
                        log=None):
    """AddMetaplasmidStages loop (projects/spades/pipeline.cpp:85-97):
    cutoffs rise cov -> max(cov + additive_step, cov * relative_step)
    until 600; each round removes sub-cutoff coverage and yields
    (cutoff, graph, suspicious_components)."""
    params = params or PlasmidParams()
    log = log or _log.debug
    g, _ = compact_graph(g)
    forbidden = tip_end_vertices(g)
    cov = params.additive_step
    rounds = []
    # edges already emitted as plasmid candidates: the reference's
    # used_edges container keeps a component found at one cutoff from
    # re-emitting at every later cutoff below its coverage
    # (OutputSuspiciousComponents '2 * used_len > total_len' dedup)
    used_edges: set[int] = set()
    while cov < params.max_coverage_limit:
        g, susp = run_meta_pipeline(g, float(cov), params, forbidden,
                                    used_edges=used_edges, log=log)
        for records in susp:
            for eid, _seq, _len, _cov in records:
                used_edges.add(int(eid))
        rounds.append((int(cov), g, susp))
        if log:
            log(f"metaplasmid cutoff {cov}: "
                f"{len(susp)} suspicious components, "
                f"{_num_vertices(g)} vertices left")
        if not np.asarray(edge_mask(g)).any():
            break
        cov = max(cov + params.additive_step,
                  int(cov * params.relative_step))
    return rounds


def remove_chromosomal(g: Graph, long_edge_threshold: int = 1000,
                       coverage_window: float = 0.3,
                       iterative: bool = True, log=None) -> Graph:
    """plasmidSPAdes chromosome removal entry point.

    ``iterative=True`` runs the reference's full RunIsolatedPipeline;
    ``iterative=False`` keeps the single-shot median-window heuristic
    (round-2 behavior) for callers that only want the coarse filter.
    """
    params = PlasmidParams(long_edge_length=long_edge_threshold,
                           relative_coverage=coverage_window)
    if iterative:
        return run_isolated_pipeline(g, params, log=log)
    alive = np.asarray(edge_mask(g))
    lens = np.asarray(g.seq_len)
    covs = np.asarray(g.cov)
    long_mask = alive & (lens >= long_edge_threshold)
    if not long_mask.any():
        return g
    med = float(np.median(covs[long_mask]))
    lo, hi = med * (1 - coverage_window), med * (1 + coverage_window)
    kill = long_mask & (covs >= lo) & (covs <= hi)
    conj = np.asarray(g.conj)
    kill = kill | kill[conj]
    return g._replace(alive=g.alive & ~np.asarray(kill))


def circular_contigs(g: Graph, min_length: int = 300
                     ) -> list[tuple[str, float, bool]]:
    """Contigs with circularity flags: (sequence, coverage, is_circular).

    An edge whose start and end vertices coincide is a circular component
    (our condensation breaks perfect cycles into one such edge); circular
    sequences are emitted with the k-base wrap overlap trimmed, mirroring
    the reference's cutting of circular paths.
    """
    alive = np.asarray(edge_mask(g))
    conj = np.asarray(g.conj)
    starts = np.asarray(g.seq_start)
    lens = np.asarray(g.seq_len)
    covs = np.asarray(g.cov)
    flat = dna.pull_codes_packed(g.seq_flat)
    start_v = np.asarray(g.start_v)
    end_v = np.asarray(g.end_v)
    k = g.k
    out = []
    for e in np.nonzero(alive)[0]:
        if conj[e] < e and alive[conj[e]]:
            continue
        if lens[e] < min_length:
            continue
        seq = dna.decode_codes(flat[starts[e]:starts[e] + lens[e]])
        circular = bool(start_v[e] == end_v[e]) and lens[e] > k
        if circular:
            seq = seq[:-k]  # trim wrap overlap
        out.append((seq, float(covs[e]), circular))
    out.sort(key=lambda t: (-len(t[0]), t[0]))
    return out


def write_plasmid_fasta(path: str, contigs: list[tuple[str, float, bool]],
                        line_width: int = 60) -> None:
    """plasmidSPAdes naming: circular contigs carry a component suffix
    (contig_output_stage.cpp cuts and names circulars)."""
    with open(path, "w") as f:
        for i, (seq, cov, circ) in enumerate(contigs, start=1):
            suffix = "_circular" if circ else ""
            f.write(f">NODE_{i}_length_{len(seq)}_cov_{cov:.6f}{suffix}\n")
            for j in range(0, len(seq), line_width):
                f.write(seq[j:j + line_width] + "\n")


def write_component_fasta(path: str, ext_limit: int, components,
                          line_width: int = 60) -> None:
    """components_NNNN.fasta naming (chromosome_remover.cpp:338-343)."""
    with open(path, "w") as f:
        for ci, records in enumerate(components, start=1):
            for ei, (eid, seq, length, cov) in enumerate(records, 1):
                f.write(f">CUTOFF_{ext_limit}_COMPONENT_{ci}_EDGE_{ei}"
                        f"_length_{length}_cov_{cov:.6f}_id_{eid}\n")
                for j in range(0, len(seq), line_width):
                    f.write(seq[j:j + line_width] + "\n")
