"""Concrete stage list for the main assembly pipeline.

Mirrors ``assemble_genome``'s stage assembly
(projects/spades/pipeline.cpp:213-290): ReadConversion ->
[ErrorCorrection] -> one iteration stage per K (Construction +
GenomicInfoFiller + Simplification fused, common/stages/*) ->
RepeatResolution -> ContigOutput.
"""

from __future__ import annotations

import os

import numpy as np

from .stages import PipelineContext, Stage


def _rc_batch(b):
    """Reverse-complement a read batch in place (mirroring qualities)."""
    import jax.numpy as jnp
    from ..ops import dna
    b.codes = np.asarray(dna.revcomp_reads(
        jnp.asarray(b.codes), jnp.asarray(b.lengths)))
    if b.quals is not None:
        # mirror each row's quality prefix alongside the RC
        L = b.quals.shape[1]
        idx = (b.lengths.astype(np.int64)[:, None] - 1
               - np.arange(L)[None, :])
        b.quals = np.where(
            idx >= 0,
            np.take_along_axis(b.quals, np.maximum(idx, 0), axis=1),
            0).astype(b.quals.dtype)


def _to_fr(b1, b2, orientation: str):
    """Convert a paired library to FR geometry
    (library.hpp orientation FR/RF/FF): RF ("outie") rc's both mates,
    FF rc's the second mate only."""
    if orientation == "rf":
        _rc_batch(b1)
        _rc_batch(b2)
    elif orientation == "ff":
        _rc_batch(b2)


def make_read_conversion(pe_pairs, interlaced, singles, log, mp_pairs=(),
                         pe_orientation: str = "fr",
                         mp_orientation: str = "rf"):
    def run(ctx: PipelineContext):
        from ..io import fastq
        batches = []
        paired_ranges = []
        row = 0
        for p1, p2 in pe_pairs:
            b1, b2 = fastq.load_paired_reads(p1, p2, with_quals=True)
            _to_fr(b1, b2, pe_orientation)
            batches += [b1, b2]
            paired_ranges.append((row, b1.num_reads,
                                  row + b1.num_reads, b2.num_reads, "pe"))
            row += b1.num_reads + b2.num_reads
            log(f"loaded paired library {p1} + {p2}: {b1.num_reads} pairs"
                + (f" ({pe_orientation}->fr)"
                   if pe_orientation != "fr" else ""))
        for p1, p2 in mp_pairs:
            # mate pairs default RF ("outie", library_fwd.hpp MatePairs)
            b1, b2 = fastq.load_paired_reads(p1, p2, with_quals=True)
            _to_fr(b1, b2, mp_orientation)
            batches += [b1, b2]
            paired_ranges.append((row, b1.num_reads,
                                  row + b1.num_reads, b2.num_reads, "mp"))
            row += b1.num_reads + b2.num_reads
            log(f"loaded mate-pair library {p1} + {p2}: "
                f"{b1.num_reads} pairs ({mp_orientation}->fr)")
        for ip in interlaced:
            b = fastq.load_reads(ip, with_quals=True)
            # even rows = first mates, odd = second; split into halves
            half = b.num_reads // 2
            q = b.quals
            ev = fastq.ReadBatch(b.codes[0::2], b.lengths[0::2], None,
                                 q[0::2] if q is not None else None)
            od = fastq.ReadBatch(b.codes[1::2], b.lengths[1::2], None,
                                 q[1::2] if q is not None else None)
            batches += [ev, od]
            paired_ranges.append((row, ev.num_reads,
                                  row + ev.num_reads, od.num_reads, "pe"))
            row += ev.num_reads + od.num_reads
            log(f"loaded interlaced library {ip}: {half} pairs")
        for sp in singles:
            b = fastq.load_reads(sp, with_quals=True)
            batches.append(b)
            row += b.num_reads
            log(f"loaded single library {sp}: {b.num_reads} reads")
        batch = fastq.concat_batches(batches)
        ctx.codes = batch.codes
        ctx.lengths = batch.lengths
        ctx.quals = batch.quals  # None when any library lacks qualities
        ctx.paired_ranges = paired_ranges
        ctx.read_length = int(batch.lengths.max()) if batch.num_reads else 0
        log(f"total reads: {batch.num_reads}, max length {ctx.read_length}")
    return Stage("read_conversion", run)


def make_error_correction(log, k: int = 21, output_dir: str | None = None,
                          write_corrected: bool = False):
    """BayesHammer stage.  ``write_corrected``: dump corrected reads to
    corrected/corrected.fastq.gz like the reference (whose per-K
    processes re-read them).  This in-process pipeline passes the
    corrected batch on-device, so the dump is opt-in — it forces a
    full device->host pull of the read set."""
    def run(ctx: PipelineContext):
        from ..hammer import correct as hammer_correct
        corrected, hstats = hammer_correct.correct_reads(
            ctx.codes, ctx.lengths, k=k,
            quals=getattr(ctx, "quals", None))
        log(f"correction: {hstats}")
        ctx.codes = corrected
        ctx.params["hammer"] = hstats
        if output_dir is not None and write_corrected:
            from ..io import fastq
            cdir = os.path.join(output_dir, "corrected")
            os.makedirs(cdir, exist_ok=True)
            path = os.path.join(cdir, "corrected.fastq.gz")
            fastq.write_reads_fastq(path, np.asarray(ctx.codes),
                                    ctx.lengths)
            log(f"wrote {path}")
    return Stage("error_correction", run)


def make_ion_error_correction(log, output_dir: str | None = None):
    """IonTorrent homopolymer-space correction (projects/ionhammer,
    selected by --iontorrent in spades.py options_storage.py)."""
    def run(ctx: PipelineContext):
        from ..hammer import ionhammer
        codes, lengths, stats = ionhammer.correct_reads_ion(
            ctx.codes, ctx.lengths)
        log(f"ionhammer: {stats}")
        ctx.codes = codes
        ctx.lengths = lengths
        ctx.params["ionhammer"] = stats
        if output_dir is not None:
            from ..io import fastq
            cdir = os.path.join(output_dir, "corrected")
            os.makedirs(cdir, exist_ok=True)
            path = os.path.join(cdir, "corrected.fastq.gz")
            fastq.write_reads_fastq(path, ctx.codes, ctx.lengths)
            log(f"wrote {path}")
    return Stage("error_correction", run)


def make_iteration(k: int, log, min_contig_length=None, simplify_cfg=None,
                   name=None, min_kmer_count=1):
    def run(ctx: PipelineContext):
        from . import assemble
        from ..simplify import runner
        cfg = simplify_cfg
        if cfg is not None and ctx.read_length:
            import dataclasses
            cfg = dataclasses.replace(cfg, read_length=ctx.read_length)
        res = assemble.assemble_single_k(
            ctx.codes, ctx.lengths, k, cfg=cfg,
            min_contig_length=min_contig_length,
            min_kmer_count=min_kmer_count,
            extra_sequences=[s for s, _ in ctx.contigs])
        ctx.contigs = res.contigs
        ctx.graph = res.graph
        ctx.genomic_info = res.genomic_info
        ctx.params.setdefault("ks_done", []).append(k)
        log(f"K={k}: {res.stats}")
    return Stage(name or f"k{k}", run)


def make_chromosome_removal(log, cfg, output_dir=None):
    """ChromosomeRemoval stage (projects/spades/chromosome_removal.cpp).

    plasmid mode runs the iterated isolated pipeline
    (chromosome_remover.cpp RunIsolatedPipeline); metaplasmid/metaviral
    runs the rising-coverage-cutoff loop (pipeline.cpp:85-97) and dumps
    per-cutoff suspicious components (components_NNNN.fasta)."""
    def run(ctx: PipelineContext):
        from ..models import plasmid
        from ..io import fasta
        from ..graph.graph import edge_mask
        from ..ops import dna
        if ctx.graph is None:
            return
        params = plasmid.PlasmidParams(
            long_edge_length=cfg.plasmid_min_edge_length,
            relative_coverage=cfg.plasmid_coverage_uniformity)
        if cfg.mode in ("metaplasmid", "metaviral"):
            rounds = plasmid.metaplasmid_iterate(
                ctx.graph, params, log=log)
            for cov, _, susp in rounds:
                if susp and output_dir:
                    plasmid.write_component_fasta(
                        os.path.join(output_dir,
                                     f"components_{cov:04d}.fasta"),
                        cov, susp)
            # the reference emits plasmid contigs per cutoff (ContigOutput
            # after each ChromosomeRemoval round, pipeline.cpp:85-97), so
            # the final set is the UNION of per-cutoff candidates —
            # low-coverage plasmids eliminated at later cutoffs included —
            # deduplicated by canonical sequence
            g = next((g for _, g, _ in reversed(rounds)
                      if np.asarray(edge_mask(g)).any()),
                     rounds[-1][1] if rounds else ctx.graph)
            ctx.graph = g
            seen = set()
            union: list[tuple[str, float]] = []
            for s, cov_ in fasta.graph_contigs(g, min_length=2 * g.k):
                key = min(s, dna.revcomp_str(s))
                if key not in seen:
                    seen.add(key)
                    union.append((s, cov_))
            for _cut, _, susp in rounds:
                for records in susp:
                    for _eid, s, ln, cov_ in records:
                        if ln < 2 * g.k:
                            continue
                        key = min(s, dna.revcomp_str(s))
                        if key not in seen:
                            seen.add(key)
                            union.append((s, cov_))
            ctx.contigs = union
        else:
            g = plasmid.run_isolated_pipeline(ctx.graph, params, log=log)
            ctx.graph = g
            ctx.contigs = fasta.graph_contigs(g, min_length=2 * g.k)
        log(f"chromosome removal: {len(ctx.contigs)} candidate edges left")
    return Stage("chromosome_removal", run)


def _range_kind(r) -> str:
    return r[4] if len(r) > 4 else "pe"


def _paired_mate_arrays(ctx: PipelineContext):
    # slice on the device: ctx.codes may be a large device array, and a
    # host round trip would copy all of it twice
    import jax.numpy as jnp
    c, l = jnp.asarray(ctx.codes), jnp.asarray(ctx.lengths)
    idx1 = jnp.asarray(np.concatenate(
        [np.arange(r[0], r[0] + r[1]) for r in ctx.paired_ranges]))
    idx2 = jnp.asarray(np.concatenate(
        [np.arange(r[2], r[2] + r[3]) for r in ctx.paired_ranges]))
    return (jnp.take(c, idx1, axis=0), jnp.take(l, idx1),
            jnp.take(c, idx2, axis=0), jnp.take(l, idx2))


def _paired_lib_arrays(ctx: PipelineContext):
    """Per-library mate arrays: [(c1, l1, c2, l2, kind)] — the per-lib
    model (library.hpp SequencingLibrary) replacing pooled mates.
    Device-resident slices (contiguous ranges)."""
    import jax.numpy as jnp
    c, l = jnp.asarray(ctx.codes), jnp.asarray(ctx.lengths)
    libs = []
    for r in ctx.paired_ranges:
        s1, n1, s2, n2 = r[0], r[1], r[2], r[3]
        libs.append((c[s1:s1 + n1], l[s1:s1 + n1],
                     c[s2:s2 + n2], l[s2:s2 + n2],
                     _range_kind(r)))
    return libs


def make_ss_edge_split(ss_orientation: str, log):
    """SSEdgeSplit stage (common/stages/ss_edge_split.cpp:17-59): split
    edges where the transcribed strand flips (strand-specific RNA)."""
    def run(ctx: PipelineContext):
        from ..models import rna
        if ctx.graph is None:
            return
        g, n, _ = rna.split_edges_by_strand(
            ctx.graph, np.asarray(ctx.codes), np.asarray(ctx.lengths),
            ss_orientation=ss_orientation)
        ctx.graph = g
        if n:
            from ..io import fasta
            ctx.contigs = fasta.graph_contigs(g, min_length=2 * g.k)
        log(f"ss edge split ({ss_orientation}): split {n} edges")
    return Stage("ss_edge_split", run)


def make_gap_closing(log):
    def run(ctx: PipelineContext):
        from . import gap_closer
        if not ctx.paired_ranges or ctx.graph is None:
            log("gap closing skipped (no paired libraries)")
            return
        c1, l1, c2, l2 = _paired_mate_arrays(ctx)
        g, joined = gap_closer.close_gaps(ctx.graph, c1, l1, c2, l2)
        ctx.graph = g
        if joined:
            from ..io import fasta
            ctx.contigs = fasta.graph_contigs(
                g, min_length=2 * g.k)
        log(f"closed {joined} gaps")
    return Stage("gap_closing", run)


def make_mismatch_correction(log):
    def run(ctx: PipelineContext):
        from . import mismatch_correction
        if ctx.graph is None:
            return
        g, n = mismatch_correction.correct_mismatches(
            ctx.graph, np.asarray(ctx.codes), np.asarray(ctx.lengths))
        ctx.graph = g
        if n:
            from ..io import fasta
            ctx.contigs = fasta.graph_contigs(g, min_length=2 * g.k)
        log(f"corrected {n} mismatching bases")
    return Stage("mismatch_correction", run)


def make_hybrid_aligning(long_read_files, log, name="hybrid_aligning"):
    def run(ctx: PipelineContext):
        from ..io import fastq
        from ..mapping import long_read
        if ctx.graph is None:
            return
        batches = [fastq.load_reads(p) for p in long_read_files]
        b = fastq.concat_batches(batches)
        # keep the long-read batch for the RR long-read extension
        # chooser (the PathStorage the reference fills here,
        # hybrid_aligning.cpp:143-330)
        ctx.params["long_read_batch"] = (b.codes, b.lengths)
        g, joined = long_read.hybrid_close_gaps(
            ctx.graph, b.codes, b.lengths)
        ctx.graph = g
        if joined:
            from ..io import fasta
            ctx.contigs = fasta.graph_contigs(g, min_length=2 * g.k)
        log(f"hybrid gap closing: {joined} joins from "
            f"{b.num_reads} long reads")
    return Stage(name, run)


def make_extract_domains(hmm_set: str, output_dir: str, log):
    """ExtractDomains stage (projects/spades/extract_domains.cpp): match
    the HMM set against the preliminary contigs, write
    temp_anti/restricted_edges.fasta and stash the hit sequences for the
    second-phase restricted-edge protection."""
    def run(ctx: PipelineContext):
        from ..io import hmmfile
        from ..models import bio
        contig_seqs = [s for s, _ in (ctx.final_contigs or ctx.contigs)]
        profiles = hmmfile.load_hmm_set(hmm_set)
        hits = bio.extract_domains(contig_seqs, profiles,
                                   output_dir=output_dir)
        ctx.params["restricted_seqs"] = [h.seq for h in hits]
        log(f"extracted {len(hits)} domain hits from "
            f"{len(profiles)} models over {len(contig_seqs)} contigs")
    return Stage("extract_domains", run)


def make_domain_graph_construction(hmm_set: str, output_dir: str, log):
    """DomainGraphConstruction stage
    (projects/spades/domain_graph_construction.cpp): re-match the final
    contigs, build the domain graph and emit BGC candidates
    (gene_clusters.fasta, bgc_statistics.txt, domain_graph.dot)."""
    def run(ctx: PipelineContext):
        from ..io import hmmfile
        from ..models import bio
        contig_seqs = [s for s, _ in (ctx.final_contigs or ctx.contigs)]
        profiles = hmmfile.load_hmm_set(hmm_set)
        hits = bio.extract_domains(contig_seqs, profiles)
        arcs = bio.build_domain_graph(hits)
        chains = bio.bgc_candidates(hits, arcs)
        n = bio.write_bgc_outputs(output_dir, contig_seqs, hits, chains)
        log(f"domain graph: {len(hits)} hits, {len(arcs)} arcs, "
            f"{n} BGC candidates")
    return Stage("domain_graph_construction", run)


def make_series_analysis(yaml_path: str, log):
    """SeriesAnalysis stage (projects/spades/series_analysis.cpp): load a
    multi-sample k-mer multiplicity table, profile the graph edges and
    write edges_sqn / edges_mpl / edge_fragments_mpl for the mts binner."""
    def parse_cfg(path):
        cfg = {}
        for line in open(path):
            line = line.split("#")[0].strip()
            if ":" in line:
                key, val = line.split(":", 1)
                cfg[key.strip()] = val.strip().strip('"')
        return cfg

    def run(ctx: PipelineContext):
        from ..mts import abundance
        from ..io import fasta as fasta_io
        if ctx.graph is None:
            return
        cfg = parse_cfg(yaml_path)
        kmers, mult, k = abundance.load_profiles(cfg["kmer_mult"])
        min_len = int(cfg.get("min_len", 0))
        frag_size = int(cfg.get("frag_size", 200))
        seqs = []
        names = []
        for i, (s, cov) in enumerate(
                fasta_io.graph_contigs(ctx.graph, min_length=min_len)):
            seqs.append(s)
            names.append(f"EDGE_{i + 1}_length_{len(s)}_cov_{cov:.6f}")
        prof = abundance.contig_abundance(seqs, kmers, mult, k)
        with open(cfg["edges_sqn"], "w") as f:
            for n, s in zip(names, seqs):
                f.write(f">{n}\n{s}\n")
        with open(cfg["edges_mpl"], "w") as f:
            for n, row in zip(names, prof):
                f.write(n + "\t" + "\t".join(f"{v:.2f}" for v in row)
                        + "\n")
        with open(cfg["edge_fragments_mpl"], "w") as f:
            for n, s in zip(names, seqs):
                fr = abundance.fragment_abundance(s, kmers, mult, k,
                                                  frag_size)
                for j, row in enumerate(fr):
                    f.write(f"{n}_f{j}\t" + "\t".join(
                        f"{v:.2f}" for v in row) + "\n")
        log(f"series analysis: profiled {len(seqs)} edges over "
            f"{mult.shape[1]} samples")
    return Stage("series_analysis", run)


def make_repeat_resolution(log, output_dir=None):
    def run(ctx: PipelineContext):
        from . import assemble
        if not ctx.paired_ranges or ctx.graph is None:
            ctx.final_contigs = list(ctx.contigs)
            log("no paired libraries: RR skipped (contig paths only, "
                "repeat_resolving.cpp:62 'rr disabled' branch)")
            return
        libs = _paired_lib_arrays(ctx)
        lib_data: list = []
        sg_out: dict = {}
        paths_out: dict = {}
        final, scaffolds = assemble.repeat_resolution_multi(
            ctx.graph, libs, with_scaffolds=True, lib_data_out=lib_data,
            scaffold_graph_out=sg_out,
            long_reads=ctx.params.get("long_read_batch"),
            paths_out=paths_out)
        # edge-id paths feed contigs.paths/scaffolds.paths + GFA P
        # records at contig output (contig_output_stage.cpp:105-112)
        ctx.params["contig_paths"] = [
            [[int(e), 0] for e in p] for p in paths_out.get("contigs", [])]
        ctx.params["scaffold_paths"] = [
            [[int(e), int(gap)] for e, gap in p]
            for p in paths_out.get("scaffolds", [])]
        if output_dir is not None and "graph" in sg_out:
            # PrintScaffoldGraph (launcher.cpp:85): .scg dump + dot
            sg = sg_out["graph"]
            with open(os.path.join(output_dir,
                                   "scaffold_graph.scg"), "w") as f:
                f.write(sg.to_tsv())
            with open(os.path.join(output_dir,
                                   "scaffold_graph.dot"), "w") as f:
                f.write(sg.to_dot(ctx.graph))
            log(f"scaffold graph: {sg.vertex_count} vertices, "
                f"{sg.edge_count} connections")
        ctx.final_contigs = final
        ctx.scaffolds = scaffolds
        ctx.params["lib_data"] = lib_data
        for i, ld in enumerate(lib_data):
            log(f"  lib {i} ({ld['kind']}): IS median "
                f"{ld['insert_size_median']:.0f} mad "
                f"{ld['insert_size_mad']:.0f} from {ld['pairs_used']} "
                f"pairs")
        if output_dir is not None:
            # final.lib_data equivalent (pipeline.cpp:288 write_lib_data)
            with open(os.path.join(output_dir, "final.lib_data"),
                      "w") as f:
                for i, ld in enumerate(lib_data):
                    f.write(f"- lib: {i}\n")
                    for key, val in ld.items():
                        f.write(f"  {key}: {val}\n")
        log(f"resolved {len(final)} paths, {len(scaffolds)} scaffolds "
            f"({len(libs)} libs)")
    return Stage("repeat_resolution", run)


def make_contig_output(output_dir: str, log, cfg=None):
    def run(ctx: PipelineContext):
        from ..io import fasta, gfa
        fasta.write_contigs_fasta(
            os.path.join(output_dir, "before_rr.fasta"), ctx.contigs)
        final = ctx.final_contigs or ctx.contigs
        fasta.write_contigs_fasta(
            os.path.join(output_dir, "contigs.fasta"), final)
        fasta.write_contigs_fasta(
            os.path.join(output_dir, "scaffolds.fasta"),
            ctx.scaffolds or final)
        if cfg is not None and cfg.circular_output and ctx.graph is not None:
            from ..models import plasmid
            circ = plasmid.circular_contigs(ctx.graph)
            plasmid.write_plasmid_fasta(
                os.path.join(output_dir, "contigs.circular.fasta"), circ)
            log(f"circular output: {sum(1 for _, _, c in circ if c)} "
                f"circular of {len(circ)} candidates")
            if cfg.plasmid_output_linear:
                # metaviral (metaviral_mode.info output_linear true):
                # linear dead-end-bounded candidates too
                # (contig_output_stage.cpp:231-240 GetTipScaffolds)
                linears = [(s, cv, False) for s, cv, c in circ
                           if not c
                           and len(s) >= cfg.plasmid_min_linear_length]
                plasmid.write_plasmid_fasta(
                    os.path.join(output_dir, "contigs.linears.fasta"),
                    linears)
                log(f"linear viral candidates: {len(linears)}")
        if ctx.graph is not None:
            def named(contig_list, raw_paths):
                # names must match the fasta headers the same list got
                return [(f"NODE_{i}_length_{len(s)}_cov_{c:.6f}",
                         [(int(e), int(gap)) for e, gap in p])
                        for i, ((s, c), p) in enumerate(
                            zip(contig_list, raw_paths), start=1)]
            cpaths = named(final, ctx.params.get("contig_paths", []))
            spaths = named(ctx.scaffolds or final,
                           ctx.params.get("scaffold_paths", []))
            # scaffold paths ride the GFA as P records; the .paths files
            # mirror the FastG edge numbering (contig_output_stage.cpp:
            # 105-112 WritePaths on both writers)
            gfa.write_gfa(
                os.path.join(output_dir,
                             "assembly_graph_with_scaffolds.gfa"),
                ctx.graph, paths=spaths)
            if cpaths:
                gfa.write_paths_file(
                    os.path.join(output_dir, "contigs.paths"),
                    ctx.graph, cpaths)
            if spaths:
                gfa.write_paths_file(
                    os.path.join(output_dir, "scaffolds.paths"),
                    ctx.graph, spaths)
            from ..io import fastg
            fastg.write_fastg(os.path.join(
                output_dir, "assembly_graph.fastg"), ctx.graph)
        log(f"wrote {len(final)} contigs to {output_dir}")
    return Stage("contig_output", run)


def build_stage_list(args, ks, log, cfg=None):
    """pipeline.cpp:250-285 equivalent (mode-aware)."""
    from .config import AssemblyConfig
    if cfg is None:
        cfg = AssemblyConfig()
    pe_pairs = list(zip(args.pe1, args.pe2))
    mp_pairs = list(zip(getattr(args, "mp1", []), getattr(args, "mp2", [])))
    stages = [make_read_conversion(
        pe_pairs, args.interlaced, args.single, log, mp_pairs=mp_pairs,
        pe_orientation=getattr(args, "pe_orientation", "fr"),
        mp_orientation=getattr(args, "mp_orientation", "rf"))]
    if not args.only_assembler and cfg.correction_enabled:
        if getattr(args, "iontorrent", False):
            stages.append(make_ion_error_correction(
                log, output_dir=args.output_dir))
        else:
            stages.append(make_error_correction(
                log, output_dir=args.output_dir,
                write_corrected=args.only_error_correction))
    if getattr(args, "assembly_graph", None):
        # LoadGraph replaces construction (load_graph.cpp:16-36)
        gfa_path = args.assembly_graph

        def load_graph(ctx: PipelineContext):
            from ..graph.from_gfa import graph_from_gfa
            from ..io import fasta
            ctx.graph = graph_from_gfa(gfa_path)
            ctx.contigs = fasta.graph_contigs(ctx.graph,
                                              min_length=2 * ctx.graph.k)
            log(f"loaded graph from {gfa_path}: "
                f"{len(ctx.contigs)} segments, k={ctx.graph.k}")
        stages.append(Stage("load_graph", load_graph))
    else:
        cc = getattr(args, "cov_cutoff", "off")
        min_kc = 1 if cc == "off" else ("auto" if cc == "auto" else int(cc))
        for k in ks:
            stages.append(make_iteration(
                k, log, min_contig_length=args.min_contig_length,
                simplify_cfg=cfg.simplify, min_kmer_count=min_kc))
    if getattr(args, "ss", None) and cfg.strand_specific:
        stages.append(make_ss_edge_split(args.ss, log))
    if pe_pairs or mp_pairs or args.interlaced:
        stages.append(make_gap_closing(log))
    long_reads = (getattr(args, "pacbio", []) +
                  getattr(args, "nanopore", []) +
                  getattr(args, "sanger", []))
    if long_reads:
        # the reference runs HybridLibrariesAligning twice
        # (pipeline.cpp:271-274): once before and once after pair-based
        # cleanup, so second-round joins see the improved graph
        stages.append(make_hybrid_aligning(long_reads, log))
        stages.append(make_hybrid_aligning(long_reads, log,
                                           name="hybrid_aligning_2"))
    if cfg.careful or getattr(args, "careful", False):
        stages.append(make_mismatch_correction(log))
    if cfg.chromosome_removal:
        stages.append(make_chromosome_removal(log, cfg,
                                              output_dir=args.output_dir))
    if getattr(args, "series_analysis", None):
        # before RR (pipeline.cpp:205-206)
        stages.append(make_series_analysis(args.series_analysis, log))
    stages.append(make_repeat_resolution(log, args.output_dir))
    hmm_set = getattr(args, "custom_hmms", None)
    if cfg.two_step_rr:
        if hmm_set:
            # ExtractDomains on the preliminary contigs
            # (pipeline.cpp:145-146)
            stages.append(make_extract_domains(
                hmm_set, args.output_dir, log))

        # meta: SecondPhaseSetup (projects/spades/second_phase_setup.cpp)
        # re-feeds preliminary RR contigs into a final iteration + RR;
        # restricted edges (pipeline.cpp:151-152 RestrictedEdgesFilling)
        # protect domain hits through the second-phase simplification
        def second_phase(ctx: PipelineContext):
            from . import assemble
            if ctx.graph is None or not ctx.final_contigs:
                return
            res = assemble.assemble_single_k(
                ctx.codes, ctx.lengths, ks[-1],
                extra_sequences=[s for s, _ in ctx.final_contigs],
                restricted_sequences=ctx.params.get("restricted_seqs"))
            ctx.graph = res.graph
            ctx.contigs = res.contigs
            log(f"second phase: {res.stats}")
        stages.append(Stage("second_phase_setup", second_phase))
        stages.append(make_repeat_resolution(log, args.output_dir))
        stages[-1] = Stage("repeat_resolution_2", stages[-1].fn)
    stages.append(make_contig_output(args.output_dir, log, cfg))
    if hmm_set:
        # DomainGraphConstruction last (pipeline.cpp:285-286)
        stages.append(make_domain_graph_construction(
            hmm_set, args.output_dir, log))
    return stages
