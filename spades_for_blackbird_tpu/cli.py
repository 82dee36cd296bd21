"""Command-line entry point: the ``spades.py`` surface of the assembler.

Mirrors the reference's top-level orchestration
(assembler/spades.py:593 main, options at
spades_pipeline/options_parser.py, stage checkpointing semantics of
--continue/--restart-from/--stop-after at spades.py:179-418 +
executor_local.py:21): parse libraries, pick the K ladder, run the stage
pipeline (pipeline/spades_stages.py) under the checkpointing
StageManager, writing the reference's output layout (contigs.fasta,
scaffolds.fasta, before_rr.fasta, assembly_graph_with_scaffolds.gfa,
spades.log, saves/).

Usage:
    python -m spades_for_blackbird_tpu -1 left.fq.gz -2 right.fq.gz -o out
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spades_for_blackbird_tpu",
        description="JAX genome assembler (SPAdes-compatible surface)")
    p.add_argument("-1", dest="pe1", action="append", default=[],
                   help="file with forward paired-end reads")
    p.add_argument("-2", dest="pe2", action="append", default=[],
                   help="file with reverse paired-end reads")
    p.add_argument("-s", dest="single", action="append", default=[],
                   help="file with unpaired reads")
    p.add_argument("--12", dest="interlaced", action="append", default=[],
                   help="file with interlaced paired-end reads")
    p.add_argument("--pe-orientation", dest="pe_orientation",
                   choices=["fr", "rf", "ff"], default="fr",
                   help="paired-end library orientation "
                        "(--pe#-fr/rf/ff in the reference)")
    p.add_argument("--mp-orientation", dest="mp_orientation",
                   choices=["rf", "fr", "ff"], default="rf",
                   help="mate-pair library orientation "
                        "(--mp#-rf/fr/ff in the reference)")
    p.add_argument("--mp-1", dest="mp1", action="append", default=[],
                   help="file with forward mate-pair (RF) reads")
    p.add_argument("--mp-2", dest="mp2", action="append", default=[],
                   help="file with reverse mate-pair (RF) reads")
    p.add_argument("--pacbio", action="append", default=[],
                   help="file with PacBio reads (hybrid assembly)")
    p.add_argument("--nanopore", action="append", default=[],
                   help="file with Nanopore reads (hybrid assembly)")
    p.add_argument("--sanger", action="append", default=[],
                   help="file with Sanger reads (hybrid assembly)")
    p.add_argument("--assembly-graph", default=None, metavar="GFA",
                   help="start from an existing assembly graph instead of "
                        "construction (the blackbird-fork LoadGraph path)")
    p.add_argument("-o", dest="output_dir", required=True,
                   help="output directory")
    p.add_argument("-k", dest="k_list", default=None,
                   help="comma-separated odd k values (default: auto)")
    p.add_argument("--only-assembler", action="store_true",
                   help="skip read error correction")
    p.add_argument("--only-error-correction", action="store_true",
                   help="run read error correction only")
    p.add_argument("--careful", action="store_true",
                   help="run the mismatch-correction polishing stage")
    p.add_argument("--meta", action="store_true",
                   help="metagenomic mode (metaSPAdes equivalent)")
    p.add_argument("--plasmid", action="store_true",
                   help="plasmid mode (plasmidSPAdes equivalent)")
    p.add_argument("--metaplasmid", action="store_true",
                   help="metaplasmid/metaviral mode")
    p.add_argument("--rna", action="store_true",
                   help="RNA-seq mode (rnaSPAdes equivalent)")
    p.add_argument("--rnaviral", action="store_true",
                   help="viral RNA mode (rnaviralSPAdes equivalent)")
    p.add_argument("--corona", action="store_true",
                   help="coronaSPAdes mode (rnaviral pipeline + HMM "
                        "domain graph; pass the HMM set via "
                        "--custom-hmms)")
    p.add_argument("--metaviral", action="store_true",
                   help="metaviral mode (circular + linear viral "
                        "candidates from a metagenome)")
    p.add_argument("--moleculo", "--truseq", dest="moleculo",
                   action="store_true",
                   help="truSPAdes barcode-assembly mode "
                        "(moleculo_mode.info)")
    p.add_argument("--large-genome", dest="large_genome",
                   action="store_true",
                   help="large-genome mode (2015 scaffold-graph "
                        "anchoring)")
    p.add_argument("--iontorrent", action="store_true",
                   help="IonTorrent data: homopolymer-space error "
                        "correction (ionhammer)")
    p.add_argument("--sc", action="store_true",
                   help="single-cell (MDA) mode")
    p.add_argument("--series-analysis", dest="series_analysis",
                   default=None, metavar="YAML",
                   help="mts time-series binning hook: profile graph "
                        "edges against a multi-sample k-mer table")
    p.add_argument("--bio", action="store_true",
                   help="biosyntheticSPAdes mode (BGC assembly; needs "
                        "--custom-hmms)")
    p.add_argument("--custom-hmms", dest="custom_hmms", default=None,
                   metavar="PATH",
                   help=".hmm file or directory of domain models for "
                        "--bio mode")
    p.add_argument("--ss", choices=["rf", "fr"], default=None,
                   help="strand-specific RNA library orientation "
                        "(enables the SSEdgeSplit stage in --rna mode)")
    p.add_argument("--test", action="store_true",
                   help="run on the bundled toy dataset")
    p.add_argument("--min-contig-length", type=int, default=None)
    p.add_argument("--cov-cutoff", default="off", metavar="N|auto|off",
                   help="drop (k+1)-mers with count below N before "
                        "construction ('auto' uses the coverage model)")
    p.add_argument("--continue", dest="continue_run", action="store_true",
                   help="resume from the last completed stage")
    p.add_argument("--restart-from", default=None, metavar="STAGE",
                   help="restart from a stage (e.g. k33, repeat_resolution)")
    p.add_argument("--stop-after", default=None, metavar="STAGE",
                   help="stop after the given stage")
    p.add_argument("--checkpoints", choices=["none", "last", "all"],
                   default="last", help="per-stage saves policy")
    p.add_argument("--trace-time", action="store_true",
                   help="emit Chrome-trace JSON of stage/phase timings")
    p.add_argument("--threads", "-t", type=int, default=None,
                   help="accepted for CLI compatibility (device-parallel)")
    p.add_argument("--memory", "-m", type=int, default=None,
                   help="memory budget in GB (spades.py:239 -m): sizes "
                        "counting/correction chunk shapes and the "
                        "hammer spill threshold; stages exceeding it "
                        "log a warning")
    p.add_argument("--log-properties", default=None, metavar="FILE",
                   help="per-component log levels (log.properties format; "
                        "SPADES_TPU_LOG env overlays)")
    return p


TEST_DATASET = "/root/reference/assembler/test_dataset"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.jaxcache import enable_compilation_cache
    enable_compilation_cache()
    if args.memory is not None:
        from .utils import membudget
        membudget.set_budget_gb(args.memory)

    if args.test:
        args.pe1 = [f"{TEST_DATASET}/ecoli_1K_1.fq.gz"]
        args.pe2 = [f"{TEST_DATASET}/ecoli_1K_2.fq.gz"]

    if len(args.pe1) != len(args.pe2):
        print("error: -1/-2 file counts differ", file=sys.stderr)
        return 2
    if len(args.mp1) != len(args.mp2):
        print("error: --mp-1/--mp-2 file counts differ", file=sys.stderr)
        return 2
    if not (args.pe1 or args.single or args.interlaced or args.mp1):
        print("error: no input reads (use -1/-2, -s, --12 or --test)",
              file=sys.stderr)
        return 2

    os.makedirs(args.output_dir, exist_ok=True)
    # leveled per-component logging (utils/logger/logger.hpp:161 +
    # log.properties): console + spades.log writers, in place only for
    # this run; components below their threshold are silenced
    from .utils import logger as logmod
    with open(os.path.join(args.output_dir, "spades.log"), "a") as log_f:

        def _file_writer(line):
            log_f.write(line + "\n")
            log_f.flush()

        with logmod.configured(properties_path=args.log_properties,
                               writers=[lambda line: print(line),
                                        _file_writer]):
            return _run(args, logmod.get_logger("pipeline").info)


def _run(args, log) -> int:
    from .io import fastq
    from .pipeline import assemble, spades_stages
    from .pipeline.stages import PipelineContext, StageManager

    missing = [p for p in (args.pe1 + args.pe2 + args.mp1 + args.mp2 +
                           args.single +
                           args.interlaced + args.pacbio + args.nanopore +
                           args.sanger +
                           ([args.assembly_graph] if args.assembly_graph
                            else []))
               if not os.path.exists(p)]
    if missing:
        print(f"error: input file(s) not found: {missing}", file=sys.stderr)
        return 2

    first_file = (args.pe1 or args.single or args.interlaced
                  or args.mp1)[0]
    read_length = fastq.peek_read_length(first_file)
    if read_length == 0:
        print(f"error: no reads found in {first_file}", file=sys.stderr)
        return 2

    if args.k_list:
        try:
            ks = [int(x) for x in args.k_list.split(",")]
        except ValueError:
            print(f"error: bad -k value {args.k_list!r} "
                  f"(expected comma-separated integers)", file=sys.stderr)
            return 2
        bad = [k for k in ks if k % 2 == 0 or k < 11 or k >= read_length]
        if bad:
            print(f"error: k values must be odd, >= 11 and < read length "
                  f"({read_length}); got {bad}", file=sys.stderr)
            return 2
    else:
        ks = [k for k in assemble.default_k_ladder(read_length)
              if k < read_length]
    log(f"K values: {ks}")

    if args.trace_time:
        from .utils import timetrace
        timetrace.enable()

    from .pipeline.config import config_for_mode
    mode_flags = [m for m in ("meta", "plasmid", "metaplasmid",
                              "metaviral", "rna", "rnaviral", "corona",
                              "sc", "bio", "moleculo", "large_genome")
                  if getattr(args, m)]
    if len(mode_flags) > 1:
        print(f"error: conflicting mode flags: {mode_flags}",
              file=sys.stderr)
        return 2
    mode = mode_flags[0] if mode_flags else "isolate"
    if mode == "bio" and not args.custom_hmms:
        print("error: --bio requires --custom-hmms <file-or-dir of .hmm "
              "models>", file=sys.stderr)
        return 2
    if mode == "corona" and not args.custom_hmms:
        # the reference bundles coronaspades_hmms (options_parser.py:937);
        # the set ships out-of-tree here, so the domain stages are
        # skipped unless a set is supplied
        log("warning: --corona without --custom-hmms: HMM domain-graph "
            "postprocessing skipped (supply the coronavirus HMM set "
            "via --custom-hmms)")
    if args.custom_hmms and not os.path.exists(args.custom_hmms):
        print(f"error: --custom-hmms path not found: {args.custom_hmms}",
              file=sys.stderr)
        return 2
    cfg = config_for_mode(mode, careful=args.careful)
    if cfg.ks is not None and not args.k_list:
        ks = [k for k in cfg.ks if k < read_length]
        log(f"mode {mode}: K values {ks}")
    log(f"mode: {mode}")

    stages = spades_stages.build_stage_list(args, ks, log, cfg)
    if args.only_error_correction:
        stages = [s for s in stages
                  if s.name in ("read_conversion", "error_correction")]
    mgr = StageManager(stages=stages, output_dir=args.output_dir,
                       checkpoints=args.checkpoints, log=log)
    try:
        ctx = mgr.run(PipelineContext(), continue_run=args.continue_run,
                      restart_from=args.restart_from,
                      stop_after=args.stop_after)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    with open(os.path.join(args.output_dir, "params.json"), "w") as f:
        json.dump({"ks": ks, "read_length": read_length,
                   "stages": [s.name for s in stages]}, f)
    if args.trace_time:
        from .utils import timetrace
        trace_path = os.path.join(args.output_dir, "spades_time_trace.json")
        timetrace.dump(trace_path)
        log(f"wrote {trace_path}")
    log("done")
    return 0


def _mode_main(flag: str):
    def entry(argv=None) -> int:
        args = list(sys.argv[1:] if argv is None else argv)
        return main([flag] + args)
    return entry


# mode wrapper entry points (the reference's metaspades.py etc.)
main_meta = _mode_main("--meta")
main_plasmid = _mode_main("--plasmid")
main_metaplasmid = _mode_main("--metaplasmid")
main_metaviral = _mode_main("--metaviral")
main_rna = _mode_main("--rna")
main_rnaviral = _mode_main("--rnaviral")
main_corona = _mode_main("--corona")
main_truspades = _mode_main("--moleculo")


if __name__ == "__main__":
    raise SystemExit(main())
