#!/usr/bin/env python
"""Smoke test of the assembler on an NVIDIA GPU, in one process.

Phases, each printing one JSON line:

1. ``device``: a GPU must be visible (there is no CPU fallback); prints
   the device kind, count, memory limit, the card's name and power limit
   from ``nvidia-smi``, and whether the native FASTQ reader was built.
2. ``kmers``: ``counter.count_kmers`` on 2^20 reads of 150 bp drawn from
   a seeded genome at ~40x, at k+1 = 22, 34 and 56 (two, three and four
   words per key), compared exactly with a plain numpy count.
3. ``assemble``: the CLI (``cli.main``) from FASTQ to contigs, scaffolds
   and GFA on a simulated 1 Mb genome with planted repeats (40x,
   2x100 bp, insert 300, error rate 0.002, seed 7), on the default K
   ladder, graded against the truth genome.

``--multi`` instead runs the four-card path: the sharded-versus-single
device dry run and the assemble phase over every visible card.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failure exits non-zero before that line is printed.

Usage:
    python chip_smoke.py [--genome-size N] [--multi]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))

# quality bars of the 1 Mb default-ladder run (pipeline and reference
# SPAdes both reached genome fraction 0.989, NG50 ~297 kb, 0 misassemblies)
BARS = {"genome_fraction": 0.985, "ng50": 250_000, "misassemblies": 0}

KMER_READS = 1 << 20
KMER_READ_LEN = 150
KMER_SIZES = (22, 34, 56)   # k+1 of the ladder's rungs: 2-, 3- and 4-word keys


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------

def require_gpu(min_count: int = 1):
    """The visible JAX devices; raises unless they are at least
    ``min_count`` GPUs."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU visible to JAX (platform {devs[0].platform!r})")
    if len(devs) < min_count:
        raise RuntimeError(f"{min_count} GPUs needed, {len(devs)} visible")
    return devs


def nvidia_smi_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def device_phase(devs, cache_dir: str) -> None:
    from spades_for_blackbird_tpu import native
    smi = nvidia_smi_lines()
    for line in smi:
        print(line, flush=True)
    emit("device", platform=devs[0].platform, kind=devs[0].device_kind,
         count=len(devs),
         bytes_limit=devs[0].memory_stats()["bytes_limit"],
         nvidia_smi=smi, compile_cache=cache_dir,
         fastq_reader="native" if native.get_lib() is not None
         else "python")


class CompileClock:
    """Sums JAX's compile-duration events (tracing, lowering, backend
    compile or persistent-cache load) and counts persistent-cache hits."""

    _EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
               "/jax/core/compile/jaxpr_to_mlir_module_duration",
               "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax
        self.secs = {e: 0.0 for e in self._EVENTS}
        self.cache_hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event)

    def _duration(self, event, secs, **_):
        if event in self.secs:
            self.secs[event] += secs

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1

    def snapshot(self) -> dict:
        return {"compile_s": sum(self.secs.values()),
                "backend_compile_s": self.secs[self._EVENTS[-1]],
                "cache_hits": self.cache_hits}


def since(clock: CompileClock | None, before: dict | None) -> dict:
    if clock is None:
        return {}
    now = clock.snapshot()
    return {k: now[k] - before[k] for k in now}


# ---------------------------------------------------------------------------
# kmers
# ---------------------------------------------------------------------------

def simulate_kmer_reads(n_reads: int, read_len: int, coverage: float = 40.0,
                        seed: int = 11):
    """(codes (R, L) uint8, lengths (R,) int32) from a random genome, with
    substitutions, a sprinkle of N bases and some short reads so that
    window validity is exercised too."""
    rng = np.random.default_rng(seed)
    g_len = int(n_reads * read_len / coverage)
    genome = rng.integers(0, 4, g_len, dtype=np.uint8)
    starts = rng.integers(0, g_len - read_len, n_reads)
    codes = genome[starts[:, None] + np.arange(read_len)[None, :]]
    err = rng.random(codes.shape) < 0.002
    codes = np.where(err, (codes + rng.integers(1, 4, codes.shape,
                                                dtype=np.uint8)) % 4, codes)
    codes[rng.random(codes.shape) < 1e-4] = 4
    lengths = np.full(n_reads, read_len, np.int32)
    short = rng.random(n_reads) < 0.05
    lengths[short] = rng.integers(read_len // 2, read_len, int(short.sum()))
    codes[np.arange(read_len)[None, :] >= lengths[:, None]] = 4
    return codes.astype(np.uint8), lengths


def _pack_windows(c: np.ndarray, k: int, W: int) -> np.ndarray:
    """(B, L) 2-bit codes -> (B, L-k+1, W) uint32 k-mer words, first base
    in the most significant bits of word 0, bases past k zero."""
    B, L = c.shape
    P = L - k + 1
    padded = np.zeros((B, L + 16), np.uint32)
    padded[:, :L] = c
    words = np.zeros((B, L), np.uint32)     # words[:, i] packs i..i+15
    for j in range(16):
        words |= padded[:, j:j + L] << np.uint32(30 - 2 * j)
    out = np.zeros((B, P, W), np.uint32)
    for w in range(W):
        n = min(16, k - 16 * w)
        out[:, :, w] = words[:, 16 * w:16 * w + P] & np.uint32(
            (0xFFFFFFFF << (32 - 2 * n)) & 0xFFFFFFFF)
    return out


def numpy_kmer_counts(codes: np.ndarray, lengths: np.ndarray, k: int,
                      block: int = 1 << 15):
    """Plain numpy canonical k-mer count: (keys (N, W) uint32 sorted
    lexicographically, counts (N,) int64)."""
    R, L = codes.shape
    P = L - k + 1
    W = -(-k // 16)
    rows = []
    for lo in range(0, R, block):
        cb, lb = codes[lo:lo + block], lengths[lo:lo + block]
        bad = np.concatenate(
            [np.zeros((len(cb), 1), np.int32),
             np.cumsum(cb > 3, axis=1, dtype=np.int32)], axis=1)
        pos = np.arange(P)
        ok = ((bad[:, pos + k] - bad[:, pos]) == 0) & (
            pos[None, :] <= lb[:, None] - k)
        c = cb & np.uint8(3)
        fwd = _pack_windows(c, k, W)
        # reverse complement of window p = forward window L-k-p of the
        # complemented, reversed row
        rc = _pack_windows(np.uint8(3) - c[:, ::-1], k, W)[:, ::-1]
        rc_less = np.zeros(ok.shape, bool)
        decided = np.zeros(ok.shape, bool)
        for w in range(W):
            lt, gt = rc[..., w] < fwd[..., w], rc[..., w] > fwd[..., w]
            rc_less |= lt & ~decided
            decided |= lt | gt
        canon = np.where(rc_less[..., None], rc, fwd)
        rows.append(canon[ok])
    keys = np.concatenate(rows)
    # lexicographic grouping of the two 64-bit halves of each key: the
    # high half alone for up to two words, else through order-preserving
    # ranks of each half combined into one integer
    hi = keys[:, 0].astype(np.uint64) << np.uint64(32)
    if W > 1:
        hi |= keys[:, 1]
    if W <= 2:
        uniq_hi, counts = np.unique(hi, return_counts=True)
        uniq_lo = np.zeros(len(uniq_hi), np.uint64)
    else:
        lo = keys[:, 2].astype(np.uint64) << np.uint64(32)
        if W > 3:
            lo |= keys[:, 3]
        hi_vals, hi_rank = np.unique(hi, return_inverse=True)
        lo_vals, lo_rank = np.unique(lo, return_inverse=True)
        combined, counts = np.unique(
            hi_rank.astype(np.int64) * len(lo_vals) + lo_rank,
            return_counts=True)
        uniq_hi = hi_vals[combined // len(lo_vals)]
        uniq_lo = lo_vals[combined % len(lo_vals)]
    halves = np.stack([uniq_hi >> np.uint64(32), uniq_hi,
                       uniq_lo >> np.uint64(32), uniq_lo], axis=1)
    return halves[:, :W].astype(np.uint32), counts


def _timed_reference(codes, lengths, k):
    t0 = time.perf_counter()
    keys, counts = numpy_kmer_counts(codes, lengths, k)
    return keys, counts, time.perf_counter() - t0


def count_and_compare(codes: np.ndarray, lengths: np.ndarray, k: int,
                      reference=None, with_memory: bool = False) -> dict:
    """Count on the device and compare exactly with the numpy reference
    (``reference``: a callable returning ``_timed_reference``'s result,
    computed here when None); raises on any difference."""
    import jax
    from spades_for_blackbird_tpu.kmers import counter
    dc, dl = jax.device_put(codes), jax.device_put(lengths)
    info = {"k_plus_1": k, "words": -(-k // 16)}
    if with_memory:
        ma = counter.count_kmers.lower(dc, dl, k=k).compile() \
            .memory_analysis()
        info["memory_analysis"] = {
            f: getattr(ma, f) for f in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(ma, f)}
    t0 = time.perf_counter()
    table = jax.block_until_ready(counter.count_kmers(dc, dl, k))
    info["first_call_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = jax.block_until_ready(counter.count_kmers(dc, dl, k))
    info["count_s"] = time.perf_counter() - t0
    num = int(table.num)
    got_keys = np.asarray(table.kmers[:num])
    got_counts = np.asarray(table.counts[:num])
    ref_keys, ref_counts, info["reference_s"] = (
        reference() if reference else _timed_reference(codes, lengths, k))
    info.update(distinct=num, instances=int(ref_counts.sum()))
    if num != len(ref_keys):
        raise AssertionError(
            f"k+1={k}: {num} distinct k-mers, reference has "
            f"{len(ref_keys)}")
    if not np.array_equal(got_keys, ref_keys):
        raise AssertionError(f"k+1={k}: k-mer keys differ from reference")
    if not np.array_equal(got_counts, ref_counts):
        raise AssertionError(f"k+1={k}: counts differ from reference")
    return info


def kmers_phase() -> None:
    codes, lengths = simulate_kmer_reads(KMER_READS, KMER_READ_LEN)
    # the numpy references run in worker processes (numpy only, no JAX)
    # while this process counts on the device
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            len(KMER_SIZES), mp_context=ctx) as pool:
        refs = {k: pool.submit(_timed_reference, codes, lengths, k)
                for k in KMER_SIZES}
        for k in KMER_SIZES:
            emit("kmers", reads=KMER_READS, read_len=KMER_READ_LEN,
                 exact=True, **count_and_compare(
                     codes, lengths, k, reference=refs[k].result,
                     with_memory=True))


# ---------------------------------------------------------------------------
# assemble
# ---------------------------------------------------------------------------

def stage_times(trace_path: str) -> dict:
    """Host wall-clock seconds of each span name in a --trace-time file
    (stage spans contain their phase spans)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out: dict[str, float] = {}
    for ev in events:
        out[ev["name"]] = out.get(ev["name"], 0.0) + ev["dur"] / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def assemble_phase(work_dir: str, genome_size: int, ks: str | None = None,
                   clock: CompileClock | None = None,
                   repeats=None) -> dict:
    """Simulate the scale input (``repeats`` defaults to the scale
    input's planted repeats), assemble it through ``cli.main`` and grade
    contigs and scaffolds against the truth. Returns a report."""
    from spades_for_blackbird_tpu import cli
    from spades_for_blackbird_tpu.io import fastq
    from spades_for_blackbird_tpu.utils import assess, simulate

    shutil.rmtree(work_dir, ignore_errors=True)
    t0 = time.perf_counter()
    genome, f1, f2 = simulate.write_paired_library(
        work_dir, genome_size, repeats=repeats or simulate.SCALE_REPEATS)
    sim_s = time.perf_counter() - t0
    out_dir = os.path.join(work_dir, "asm")
    argv = ["-1", f1, "-2", f2, "-o", out_dir, "--trace-time"]
    if ks:
        argv += ["-k", ks]
    before = clock.snapshot() if clock else None
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main exited {rc}")
    for name in ("contigs.fasta", "scaffolds.fasta",
                 "assembly_graph_with_scaffolds.gfa"):
        if not os.path.getsize(os.path.join(out_dir, name)):
            raise RuntimeError(f"{name} is empty")
    contigs = fastq.read_sequences(os.path.join(out_dir, "contigs.fasta"))[1]
    scaffolds = [s.replace("N", "") for s in fastq.read_sequences(
        os.path.join(out_dir, "scaffolds.fasta"))[1]]
    return {
        "genome_size": genome_size,
        "simulate_s": sim_s,
        "cli_wall_s": wall_s,
        **since(clock, before),
        "contigs": assess.assess(contigs, genome).to_dict(),
        "scaffolds": assess.assess(scaffolds, genome).to_dict(),
        "host_wall_s_by_span": stage_times(
            os.path.join(out_dir, "spades_time_trace.json")),
    }


def check_bars(report: dict) -> None:
    c = report["contigs"]
    failed = [f"genome fraction {c['genome_fraction']:.4f}"
              if c["genome_fraction"] < BARS["genome_fraction"] else "",
              f"NG50 {c['ng50']}" if c["ng50"] < BARS["ng50"] else "",
              f"{c['misassemblies']} misassemblies"
              if c["misassemblies"] > BARS["misassemblies"] else ""]
    failed = [f for f in failed if f]
    if failed:
        raise AssertionError("assembly below the bars: " + ", ".join(failed))


def run_assemble(devs, genome_size: int, clock: CompileClock) -> None:
    work = os.path.join(_ROOT, ".smoke_work", f"g{genome_size}")
    report = assemble_phase(work, genome_size, clock=clock)
    report["peak_bytes_in_use"] = [d.memory_stats()["peak_bytes_in_use"]
                                   for d in devs]
    emit("assemble", devices=len(devs), **report)
    check_bars(report)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-size", type=int, default=1_000_000)
    ap.add_argument("--multi", action="store_true",
                    help="four-card path only: sharded dry run and the "
                         "assemble phase over every visible GPU")
    args = ap.parse_args(argv)

    devs = require_gpu(4 if args.multi else 1)
    from spades_for_blackbird_tpu.utils.jaxcache import (
        enable_compilation_cache)
    cache_dir = enable_compilation_cache()
    clock = CompileClock()
    device_phase(devs, cache_dir)
    if args.multi:
        import __graft_entry__
        t0 = time.perf_counter()
        __graft_entry__.dryrun_multichip(len(devs))
        emit("dryrun_multichip", devices=len(devs), ok=True,
             wall_s=time.perf_counter() - t0)
    else:
        kmers_phase()
    run_assemble(devs, args.genome_size, clock)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
