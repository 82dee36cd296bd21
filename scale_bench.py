"""End-to-end scale benchmark: simulate a multi-Mb genome, assemble it
with the full CLI pipeline, and grade the result against the truth.

Counterpart of the reference's isolate benchmark (SPAdes README: E. coli
MC4100, 28M reads, 42 min / 16 cores) — the real dataset is not
available, so we simulate
Illumina-like reads from a known genome and report wall-clock plus
QUAST-style quality metrics (NG50, genome fraction, misassemblies).

Usage:
  python scale_bench.py --genome-size 1000000 --coverage 40 [--out DIR]

Prints one JSON line with timings and the assessment report.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-size", type=int, default=1_000_000)
    ap.add_argument("--coverage", type=float, default=40.0)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--insert", type=float, default=300.0)
    ap.add_argument("--error-rate", type=float, default=0.002)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=".smoke_work/scale_bench")
    ap.add_argument("--k", default=None, help="comma-separated K list")
    ap.add_argument("--only-assembler", action="store_true")
    ap.add_argument("--no-repeats", action="store_true")
    ap.add_argument("--json-out", default=None,
                    help="also write the result JSON to this file")
    args = ap.parse_args(argv)

    from spades_for_blackbird_tpu.io import fastq
    from spades_for_blackbird_tpu.utils import assess, simulate

    t0 = time.time()
    genome, f1, f2 = simulate.write_paired_library(
        args.out, args.genome_size, coverage=args.coverage,
        read_len=args.read_len, insert=args.insert,
        error_rate=args.error_rate, seed=args.seed,
        repeats=None if args.no_repeats else simulate.SCALE_REPEATS)
    n_pairs = int(args.coverage * args.genome_size / (2 * args.read_len))
    t_sim = time.time() - t0

    from spades_for_blackbird_tpu import cli

    run_dir = os.path.join(args.out, "asm")
    cli_args = ["-1", f1, "-2", f2, "-o", run_dir, "--trace-time"]
    if args.k:
        cli_args += ["-k", args.k]
    if args.only_assembler:
        cli_args += ["--only-assembler"]
    t1 = time.time()
    rc = cli.main(cli_args)
    t_asm = time.time() - t1
    if rc != 0:
        print(json.dumps({"ok": False, "rc": rc}))
        return rc

    contigs = fastq.read_sequences(
        os.path.join(run_dir, "contigs.fasta"))[1]
    scaf_path = os.path.join(run_dir, "scaffolds.fasta")
    report = assess.assess(contigs, genome)
    out = {
        "ok": True,
        "genome_size": args.genome_size,
        "n_read_pairs": n_pairs,
        "coverage": args.coverage,
        "sim_s": round(t_sim, 2),
        "assembly_s": round(t_asm, 2),
        "contigs": report.to_dict(),
    }
    if os.path.exists(scaf_path):
        scaffolds = [s.replace("N", "")
                     for s in fastq.read_sequences(scaf_path)[1]]
        srep = assess.assess(scaffolds, genome)
        out["scaffolds"] = {"n50": srep.n50, "ng50": srep.ng50,
                            "misassemblies": srep.misassemblies}
    try:
        import resource
        out["peak_rss_gb"] = round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / (1 << 20), 2)
    except Exception:
        pass
    trace_path = os.path.join(run_dir, "spades_time_trace.json")
    if os.path.exists(trace_path):
        # per-phase wall-clock totals (self-time excluded is fine here:
        # leaf phases don't nest)
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        phases = {}
        for ev in events:
            name = ev["name"]
            phases[name] = round(phases.get(name, 0.0)
                                 + ev["dur"] / 1e6, 1)
        out["phases_s"] = dict(sorted(phases.items(),
                                      key=lambda kv: -kv[1]))
    blob = json.dumps(out)
    print(blob)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(blob + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
