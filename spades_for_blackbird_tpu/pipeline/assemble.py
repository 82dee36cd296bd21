"""Single-K assembly pipeline: reads -> simplified graph -> contigs.

The in-process analogue of the reference's per-K ``spades-core`` stage list
(assembler/src/projects/spades/pipeline.cpp:213-290): Construction ->
GenomicInfoFiller -> Simplification -> ContigOutput. Multi-K iteration,
gap closing, paired-info/repeat-resolution stages layer on top (SURVEY.md
§7 steps 5-7).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..graph import construct
from ..io import fasta
from ..kmers import counter, coverage_model
from ..simplify import runner
from ..ops import kmer as kmer_ops
from ..ops import dna
from ..utils.timetrace import scope as _scope
from ..utils.logger import get_logger

_log = get_logger("Assembler")


@dataclass
class AssemblyResult:
    contigs: list[tuple[str, float]]
    genomic_info: coverage_model.GenomicInfo
    stats: dict
    graph: object = None  # final simplified Graph (for GFA/FASTG output)


def _windows_from_sequences(seqs: list[str], width: int, k: int):
    """Chop sequences into overlapping windows of ``width`` so every
    k-mer of each sequence appears in EXACTLY one window's extraction:
    a window starting at w yields k-mer starts [w, w+width-k], so the
    stride is width-k+1 (contiguous, non-overlapping start ranges).

    The row count is padded to a power of two (empty rows, length 0):
    otherwise every K iteration presents a unique (R, L) shape and the
    per-K contig counting compiles afresh each time."""
    rows = []
    stride = max(1, width - k + 1)
    for s in seqs:
        if len(s) <= width:
            rows.append(s)
            continue
        for lo in range(0, len(s) - k + 1, stride):
            rows.append(s[lo:lo + width])
    codes, lengths = dna.encode_reads(rows)
    R, L = codes.shape
    if L < width:  # all rows short: stabilize the column count too
        codes = np.pad(codes, ((0, 0), (0, width - L)),
                       constant_values=4)
    R2 = 1 << max(4, (R - 1).bit_length())
    if R2 != R:
        codes = np.pad(codes, ((0, R2 - R), (0, 0)),
                       constant_values=4)
        lengths = np.pad(lengths, (0, R2 - R))
    return codes, lengths


def _kmer_hash_np(words: np.ndarray) -> np.ndarray:
    """NumPy mirror of parallel.kmer_exchange.kmer_hash (uint32 wrap)."""
    h = np.full(words.shape[0], 0x9E3779B9, np.uint32)
    for w in range(words.shape[1]):
        h = (h ^ words[:, w]) * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
    return h * np.uint32(0xC2B2AE35)


def _early_tips_sharded(mesh, kk, cc, nn, k: int, read_length: int):
    """Early tip clipping on the sharded (k+1)-mer table.

    The chain-contraction clip (kmers/early_tips.py, the reference's
    EarlyTipClipper construction phase, construction.cpp:292-318) needs
    the global successor structure, so the hash-partitioned shards are
    gathered to the host, clipped once with the single-device machinery,
    and re-partitioned with the same ownership hash — keeping the
    distributed build's output identical to the single-device path on
    error-bearing reads."""
    import jax.numpy as jnp
    from ..kmers import counter as _counter, early_tips, extension
    from ..parallel import mesh as mesh_mod

    n_dev = mesh.shape[mesh_mod.READS_AXIS]
    kk_h, cc_h, nn_h = np.asarray(kk), np.asarray(cc), np.asarray(nn)
    per = kk_h.shape[0] // n_dev
    rows = np.concatenate([kk_h[i * per:i * per + int(nn_h[i])]
                           for i in range(n_dev)])
    cnts = np.concatenate([cc_h[i * per:i * per + int(nn_h[i])]
                           for i in range(n_dev)])
    order = np.lexsort(tuple(rows[:, w]
                             for w in range(rows.shape[1] - 1, -1, -1)))
    rows, cnts = rows[order], cnts[order]
    num = rows.shape[0]
    cap = 1 << max(1, num - 1).bit_length()
    table = _counter.KmerTable(
        jnp.asarray(np.pad(rows, ((0, cap - num), (0, 0)),
                           constant_values=np.iinfo(np.uint32).max)),
        jnp.asarray(np.pad(cnts, (0, cap - num)).astype(np.int32)),
        jnp.int32(num))
    vt = extension.trim_vertex_table(
        extension.build_vertex_table(table, k))
    table, n_tips = early_tips.clip_early_tips(
        table, vt, k, read_length - k)
    if not n_tips:
        return kk, cc, nn
    num = int(table.num)
    rows = np.asarray(table.kmers[:num])
    cnts = np.asarray(table.counts[:num])
    owner = _kmer_hash_np(rows) % np.uint32(n_dev)
    shard_rows = [rows[owner == d] for d in range(n_dev)]
    shard_cnts = [cnts[owner == d] for d in range(n_dev)]
    new_per = 1 << max(1, max(len(r) for r in shard_rows) - 1).bit_length()
    out_k = np.full((n_dev * new_per, rows.shape[1]),
                    np.iinfo(np.uint32).max, np.uint32)
    out_c = np.zeros(n_dev * new_per, np.int32)
    out_n = np.zeros(n_dev, np.int32)
    for d in range(n_dev):
        m = len(shard_rows[d])
        out_k[d * new_per:d * new_per + m] = shard_rows[d]
        out_c[d * new_per:d * new_per + m] = shard_cnts[d]
        out_n[d] = m
    return jnp.asarray(out_k), jnp.asarray(out_c), jnp.asarray(out_n)


def _construct_distributed(mesh, codes, lengths, k: int,
                           extra_sequences, min_kmer_count,
                           early_tip_clip: bool = True):
    """Sharded construction over the mesh: hash-partitioned all_to_all
    (k+1)-mer count -> distributed extension index -> routed-lookup
    condensation (parallel/{kmer_exchange,construction,condense_dist}).
    The reference's equivalent machinery is the disk-bucket counter +
    shared-memory graph build (kmer_index_builder.hpp:220-366,
    debruijn_graph_constructor.hpp:390-520).  Returns
    (graph, read_kp1_counts_host for the coverage model)."""
    import jax.numpy as jnp
    from ..parallel import condense_dist, construction as pcon
    from ..parallel import kmer_exchange, mesh as mesh_mod

    sc, sl = mesh_mod.shard_reads(mesh, np.asarray(codes),
                                  np.asarray(lengths))
    # hash balance concentrates at scale; tiny shards (dry runs, toy
    # inputs) see large relative imbalance, so the capacity factor
    # adapts to the per-shard row count
    n_dev = mesh.shape[mesh_mod.READS_AXIS]
    rows_per_shard = (int(np.asarray(codes).shape[0])
                      * int(np.asarray(codes).shape[1])) // max(n_dev, 1)
    cap_f = 8.0 if rows_per_shard < (1 << 18) else 3.0
    count = kmer_exchange.make_sharded_counter(mesh, k + 1,
                                               capacity_factor=cap_f)
    kk, cc, nn, dropped = count(sc, sl)
    if int(np.asarray(dropped).sum()) != 0:
        raise RuntimeError(
            "sharded k-mer exchange overflowed its capacity factor; "
            "raise capacity_factor (hash imbalance this large indicates "
            "a pathological input)")

    # coverage model fit on the READ spectrum (before extras/filter),
    # matching the single-device path; the spectrum is reduced on the
    # device, so only HIST_BINS counts cross to the host
    import jax
    per = kk.shape[0] // n_dev

    @jax.jit
    def _shard_spectrum(cc, nn):
        idx = jnp.arange(cc.shape[0])
        valid = ((idx % per) < nn[idx // per]) & (cc > 0)
        b = jnp.clip(cc.astype(jnp.int32), 0,
                     coverage_model.HIST_BINS - 1)
        return jnp.zeros((coverage_model.HIST_BINS,), jnp.int32).at[
            jnp.where(valid, b, 0)].add(valid.astype(jnp.int32))

    read_spectrum = np.asarray(_shard_spectrum(cc, nn)).astype(np.int64)

    if extra_sequences:
        extra = [s for s in extra_sequences if len(s) > k]
        if extra:
            ec, el = _windows_from_sequences(
                extra, int(np.asarray(codes).shape[1]), k + 1)
            ec2, el2 = mesh_mod.shard_reads(mesh, np.asarray(ec),
                                            np.asarray(el))
            ek, ecc, en, edrop = kmer_exchange.make_sharded_counter(
                mesh, k + 1, capacity_factor=cap_f)(ec2, el2)
            if int(np.asarray(edrop).sum()) != 0:
                raise RuntimeError("extra-contig k-mer exchange overflow")
            merge = kmer_exchange.make_sharded_table_merge(mesh)
            kk, cc, nn = merge(kk, cc, nn, ek, ecc, en)
    if min_kmer_count > 1:
        filt = kmer_exchange.make_sharded_min_count_filter(mesh)
        kk, cc, nn = filt(kk, cc, nn,
                          jnp.asarray([min_kmer_count], jnp.int32))

    read_length = int(np.asarray(codes).shape[1])
    if early_tip_clip and read_length > k + 1:
        kk, cc, nn = _early_tips_sharded(mesh, kk, cc, nn, k,
                                         read_length)

    vb = pcon.make_sharded_vertex_builder(mesh, k,
                                          capacity_factor=cap_f)
    vk, om, im, vnums, vdrop = vb(kk, nn)
    if int(np.asarray(vdrop).sum()) != 0:
        raise RuntimeError("sharded vertex exchange overflow")
    gb = condense_dist.make_sharded_graph_builder(mesh, k,
                                                  capacity_factor=cap_f)
    g, qdrop = gb(kk, cc, nn, vk, om, im, vnums)
    if int(np.asarray(qdrop).sum()) != 0:
        raise RuntimeError("routed successor query overflow")
    return g, read_spectrum


def assemble_single_k(codes, lengths, k: int,
                      cfg: runner.SimplifyConfig | None = None,
                      min_contig_length: int | None = None,
                      min_kmer_count: int = 1,
                      extra_sequences: list[str] | None = None,
                      restricted_sequences: list[str] | None = None,
                      uneven_depth: bool = False,
                      early_tip_clip: bool = True) -> AssemblyResult:
    """Assemble one read batch at a single K.

    Args:
      codes/lengths: packed read batch (R, L) uint8 / (R,) int32.
      k: odd k-mer size (vertex size; edges from (k+1)-mers).
      cfg: simplification parameters (defaults mirror the reference).
      min_contig_length: drop contigs shorter than this (default 2k).
      extra_sequences: additional sequences fed into construction (the
        multi-K "--additional-contigs" mechanism,
        spades_pipeline/stages/spades_iteration_stage.py:167-180).

    With more than one visible device the construction phase runs
    sharded over the mesh (hash-partitioned all_to_all count, routed
    condensation) — the pipeline integration of parallel/*.
    """
    if k % 2 == 0:
        raise ValueError(f"k must be odd (reference enforces this, "
                         f"projects/spades/main.cpp:101), got {k}")
    read_length = int(codes.shape[1])
    if cfg is None:
        cfg = runner.SimplifyConfig(read_length=read_length)

    from ..graph.graph import compact_graph
    from ..parallel import mesh as mesh_mod
    mesh = mesh_mod.auto_mesh()
    if mesh is not None:
        # Construction sharded over the device mesh.  The coverage-model
        # fit and cov-cutoff resolution see the same read spectrum as
        # the single-device path below.
        g, read_spectrum = _construct_distributed(
            mesh, codes, lengths, k, extra_sequences,
            1 if min_kmer_count == "auto" else min_kmer_count,
            early_tip_clip=early_tip_clip)
        ginfo = coverage_model.fit_coverage_model_hist(read_spectrum)
        if min_kmer_count == "auto":
            mc = max(2, int(ginfo.ec_bound))
            if mc > 1:  # re-run with the resolved cutoff
                g, _ = _construct_distributed(
                    mesh, codes, lengths, k, extra_sequences, mc,
                    early_tip_clip=early_tip_clip)
        g, v_space = compact_graph(g)
    else:
        # Construction (+ coverage model on the (k+1)-mer spectrum).
        # Trim to pow2(unique) right away: every downstream shape
        # (vertex table, oriented-instance arrays, graph capacity)
        # scales with TABLE CAPACITY, and the single-chunk count path
        # otherwise leaves it at the raw stream bound (R*P rows — a
        # 32 GB vertex-table intermediate at 800k reads).
        with _scope("count_kmers", k=k):
            kp1 = counter.trim_table(
                counter.count_kmers_chunked(codes, lengths, k + 1))
        with _scope("coverage_model_fit", k=k):
            # fit from the on-device spectrum: the counts column is
            # tens of MB at genome scale, the spectrum a few KB
            ginfo = coverage_model.fit_coverage_model_hist(
                coverage_model.count_spectrum_device(kp1.counts, kp1.num))
        if extra_sequences:
            extra = [s for s in extra_sequences if len(s) > k]
            if extra:
                # window-chop contigs to read-shaped rows so the count
                # program compiles once per read shape and its (R, P)
                # intermediates stay bounded
                with _scope("count_extra_contigs", k=k):
                    ec, el = _windows_from_sequences(
                        extra, int(np.asarray(codes).shape[1]), k + 1)
                    kp1 = counter.trim_table(counter.merge_tables(
                        kp1, counter.trim_table(
                            counter.count_kmers_chunked(ec, el, k + 1))))
        if min_kmer_count == "auto":  # --cov-cutoff auto
            min_kmer_count = max(2, int(ginfo.ec_bound))
        if min_kmer_count > 1:
            kp1 = counter.trim_table(
                counter.filter_min_count(kp1, min_kmer_count))
        from ..kmers import extension
        from ..graph import condense
        with _scope("vertex_table", k=k):
            vt = extension.trim_vertex_table(
                extension.build_vertex_table(kp1, k))
        if early_tip_clip and read_length > k + 1:
            # pre-graph tip clipping on the extension index shrinks the
            # error (k+1)-mer table before graph capacity is committed
            # (EarlyTipClipper phase, construction.cpp:292-318; bound
            # defaults to RL - K)
            from ..kmers import early_tips
            with _scope("early_tips", k=k):
                kp1, n_tips = early_tips.clip_early_tips(
                    kp1, vt, k, read_length - k)
                if n_tips:
                    kp1 = counter.trim_table(kp1)
                    vt = extension.trim_vertex_table(
                        extension.build_vertex_table(kp1, k))
        with _scope("condense", k=k):
            g = condense.build_graph(kp1, vt, k)
            # trim the table-capacity-sized graph to compact power-of-two
            # shapes: simplification scatters and their compiles scale
            # with edge capacity, not with the (k+1)-mer table
            g, v_space = compact_graph(g)

    if uneven_depth:
        # meta/MDA: the spectrum mixture fit is unreliable under uneven
        # depth; use the graph-based threshold finder instead
        # (genomic_info_filler.cpp:31-45, ec_threshold_finder.hpp:25)
        from ..simplify import ec_threshold
        import dataclasses
        ginfo = dataclasses.replace(
            ginfo, ec_bound=ec_threshold.uneven_ec_bound(g))

    # Simplification; restricted sequences (blackbird fork /
    # biosyntheticSPAdes, restricted_edges_filling.cpp:16-41) protect
    # their edges from bulge gluing
    protected_fn = None
    if restricted_sequences:
        import jax.numpy as jnp
        from ..models import bio

        def protected_fn(gr):
            return jnp.asarray(
                bio.fill_restricted_edges(gr, restricted_sequences))
    # the static shapes the simplify programs compile for
    _log.info(
        f"simplify entry shapes: E2={g.capacity} "
        f"flat={g.seq_flat.shape[0]} V={v_space} k={k} "
        f"flank={'yes' if g.flank is not None else 'no'} "
        f"ec_bound={float(ginfo.ec_bound):.3f}")
    with _scope("simplify", k=k):
        g = runner.simplify_graph(g, v_space, ginfo.ec_bound, cfg,
                                  protected_fn=protected_fn)

    if min_contig_length is None:
        min_contig_length = 2 * k
    with _scope("graph_contigs", k=k):
        contigs = fasta.graph_contigs(g, min_length=min_contig_length)
    return AssemblyResult(
        contigs=contigs,
        genomic_info=ginfo,
        stats=construct.graph_stats(g),
        graph=g,
    )


# Reference default K ladders (spades_pipeline/options_storage.py:62-77)
K_MERS_SHORT = [21, 33, 55]
K_MERS_150 = [21, 33, 55, 77]
K_MERS_250 = [21, 33, 55, 77, 99, 127]


def default_k_ladder(read_length: int) -> list[int]:
    """Auto K selection from read length (spades_stage.py:41-120)."""
    if read_length >= 250:
        return K_MERS_250
    if read_length >= 150:
        return K_MERS_150
    return K_MERS_SHORT


def repeat_resolution(g, codes1, lengths1, codes2, lengths2,
                      with_scaffolds: bool = False,
                      estimator: str = "simple"):
    """exSPAnder repeat resolution over the final graph using one
    paired library (the RepeatResolution stage,
    projects/spades/repeat_resolving.cpp:62). See
    ``repeat_resolution_multi`` for the per-library model.
    """
    kind = "mp" if estimator == "smoothing" else "pe"
    return repeat_resolution_multi(
        g, [(codes1, lengths1, codes2, lengths2, kind)],
        with_scaffolds=with_scaffolds)


def repeat_resolution_multi(g, libs, with_scaffolds: bool = False,
                            lib_data_out: list | None = None,
                            scaffold_graph_out: dict | None = None,
                            scaffolding_estimator: str | None = None,
                            long_reads=None,
                            paths_out: dict | None = None):
    """Per-library repeat resolution (pair_info_count.cpp:186-230 +
    extenders_logic.cpp per-lib extender construction): each library
    gets its OWN insert-size estimate, paired-index shift and distance
    estimator (simple for PE, multi-peak smoothing for MP,
    distance_estimation.cpp estimator choice per library type), then all
    feed the composite extender.

    ``libs``: list of (codes1, lengths1, codes2, lengths2, kind) with
    kind in {"pe", "mp"}; second mates as read (FR orientation after
    read conversion) — reverse-complemented here to face downstream.
    """
    import jax.numpy as jnp
    from ..mapping import chunked
    from ..mapping import index as eidx
    from ..mapping import mapper
    from ..paired import insert_size, pair_info
    from ..path_extend import resolver

    from ..parallel import mesh as mesh_mod
    mesh = mesh_mod.auto_mesh()

    k = g.k
    idx = eidx.build_edge_index(g, k + 1)

    def chain_map(c, l):
        """Read mapping fan-out: sharded over the mesh when available
        (the sequence_mapper_notifier.hpp:66 engine as shard_map data
        parallelism), chunked single-chip otherwise."""
        if mesh is not None:
            from ..parallel import mapping_dist
            return mapping_dist.map_reads_multi_sharded(
                mesh, idx, g.seq_len, g.conj, c, l, k + 1, min_votes=1)
        ch = chunked.map_reads_multi_chunked(
            idx, g.seq_len, c, l, k + 1, min_votes=1)
        return mapper.normalize_chain(ch, g.conj)

    def pair_fill(ch1, ch2, shift):
        if mesh is not None:
            from ..parallel import mapping_dist
            return mapping_dist.fill_paired_index_sharded(
                mesh, ch1, ch2, shift)
        return pair_info.fill_paired_index_multi_chunked(
            ch1, ch2, jnp.int32(shift))

    def first_placement(ch):
        return mapper.ReadMapping(
            oriented_edge=ch.oriented_edge[:, 0], start=ch.start[:, 0],
            votes=ch.votes[:, 0], mapped=ch.mapped)

    total_bases = sum(
        float(np.asarray(l1).sum() + np.asarray(l2).sum())
        for _, l1, _, l2, _ in libs) or 1.0
    specs = []
    clustered_all = []
    for codes1, lengths1, codes2, lengths2, kind in libs:
        c2rc = dna.revcomp_reads(codes2, lengths2)
        # chain mappings: junction-spanning reads place on EVERY
        # traversed edge (the MappingPath equivalent) — pair filling
        # uses all edge combinations + split-read adjacency pairs.
        # Chunked: big libraries stream through fixed-shape chunks so
        # the (R, P) vote intermediates stay bounded.
        with _scope("rr_map_reads"):
            ch1 = chain_map(codes1, lengths1)
            ch2 = chain_map(c2rc, lengths2)
        m1 = first_placement(ch1)
        m2 = first_placement(ch2)
        stats = insert_size.estimate_insert_size(
            m1, m2, np.asarray(lengths2))
        if lib_data_out is not None:
            # the final.lib_data equivalent (pipeline.cpp:288
            # write_lib_data): estimated per-lib parameters
            lib_data_out.append({
                "kind": kind,
                "read_length": int(max(
                    np.asarray(lengths1).max(initial=0),
                    np.asarray(lengths2).max(initial=0))),
                "insert_size_median": float(stats.median),
                "insert_size_mad": float(stats.mad),
                "pairs_used": int(stats.count),
            })
        if stats.count == 0:
            continue
        mean_l2 = float(np.asarray(lengths2).mean())
        with _scope("rr_pair_fill"):
            pi = pair_fill(ch1, ch2, int(round(stats.median - mean_l2)))
        spread = max(5, int(3 * stats.mad))
        if kind == "mp":
            # mate pairs: broad, multi-modal histograms -> multi-peak
            # smoothing estimator (smoothing_distance_estimation.hpp:19)
            clustered = pair_info.cluster_distances_smoothing(
                pi, jnp.int32(max(spread, 20)), jnp.float32(2.0))
        else:
            clustered = pair_info.cluster_distances(pi, jnp.int32(spread))
            # PairInfoImprover's FillMissing on the clustered PE index
            # (distance_estimation.cpp:161 + pair_info_improver.hpp:215):
            # split-path derivation along forced path suffixes only — a
            # blind transitive join would fabricate cross-repeat links
            clustered = pair_info.split_path_fill(
                g, clustered, float(stats.median),
                float(stats.deviation))
        read_length = int(max(np.asarray(lengths1).max(initial=0),
                              np.asarray(lengths2).max(initial=0)))
        share = float(np.asarray(lengths1).sum()
                      + np.asarray(lengths2).sum()) / total_bases
        specs.append(resolver.LibSpec(
            clustered, is_stats=stats, read_length=read_length,
            kind=kind, coverage_share=share))
        if scaffolding_estimator == "weighted" and stats.histogram:
            # separate scaffolding index: graph-distance snapping with
            # the IS-distribution weight function
            # (estimate_scaffolding_distance,
            # projects/spades/distance_estimation.cpp:100-135)
            clustered_all.append(pair_info.weighted_cluster_distances(
                g, pi, stats.histogram, float(stats.median),
                float(stats.deviation)))
        else:
            clustered_all.append(clustered)

    if long_reads is not None:
        # long reads guide extension too (LongReadsExtensionChooser
        # input from the aligned PathStorage; extenders_logic.cpp:469
        # adds long-read extenders before the paired ones)
        from ..mapping import long_read as lr_mod
        lc, ll = long_reads
        with _scope("rr_align_long_reads"):
            alns = lr_mod.align_long_reads(g, lc, ll)
        lr_paths = [(a.edge_path, 1.0) for a in alns
                    if len(a.edge_path) >= 2]
        if lr_paths:
            specs.append(resolver.LibSpec(
                None, kind="long", read_paths=lr_paths))

    if not specs:
        from ..io import fasta
        rows = fasta.graph_contigs(g, min_length=2 * k, with_edges=True)
        contigs = [(s, c) for s, c, _ in rows]
        if paths_out is not None:
            paths_out["contigs"] = [[e] for _, _, e in rows]
            paths_out["scaffolds"] = [[(e, 0)] for _, _, e in rows]
        return (contigs, contigs) if with_scaffolds else contigs

    with _scope("rr_resolve_paths"):
        ps = resolver.resolve_paths_multi(g, specs)
    # tandem-repeat traversal after extension (launcher.cpp:301
    # TraverseLoops): joins surface as k+100 N gaps in scaffolds
    from ..path_extend import loop_traverser
    loop_joins = loop_traverser.traverse_loops(g, ps)
    crows = resolver.paths_to_contigs(g, ps, with_paths=True)
    contigs = [(s, c) for s, c, _ in crows]
    if paths_out is not None:
        paths_out["contigs"] = [p for _, _, p in crows]
    if not with_scaffolds:
        return contigs
    from ..path_extend import polisher, scaffolder
    merged = pair_info.merge_paired_indices(clustered_all)
    # gap-analysis thresholds scale with the (largest) library IS
    # variation (extenders_logic.cpp:105-107 MakeGapAnalyzer)
    sparams = scaffolder.ScaffoldParams(
        is_variation=max(float(s.is_stats.deviation) for s in specs),
        read_length=max(s.read_length for s in specs))
    chains = scaffolder.scaffold_paths(g, ps, merged, params=sparams,
                                       forced_joins=loop_joins,
                                       sg_out=scaffold_graph_out)
    # gap polishing: unique graph paths replace N runs
    # (scaffolder2015/path_polisher.cpp)
    chains, _ = polisher.polish_scaffolds(g, chains)
    srows = scaffolder.scaffolds_to_contigs(g, chains, with_paths=True)
    scaffolds = [(s, c) for s, c, _ in srows]
    if paths_out is not None:
        paths_out["scaffolds"] = [p for _, _, p in srows]
    return contigs, scaffolds


def assemble_multi_k(codes, lengths, ks: list[int] | None = None,
                     cfg: runner.SimplifyConfig | None = None,
                     min_contig_length: int | None = None
                     ) -> AssemblyResult:
    """Iterative multi-K assembly (the spades.py per-K loop,
    spades.py:533-565): each K's contigs seed the next K's construction."""
    if ks is None:
        ks = [k for k in default_k_ladder(int(codes.shape[1]))
              if k < int(codes.shape[1])]
    result = None
    prev_contigs: list[str] = []
    for k in ks:
        result = assemble_single_k(
            codes, lengths, k, cfg=cfg,
            min_contig_length=min_contig_length,
            extra_sequences=prev_contigs)
        prev_contigs = [s for s, _ in result.contigs]
    return result
