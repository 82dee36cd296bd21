"""Stage framework with per-stage checkpointing.

Device-side equivalent of the reference's in-process stage pipeline
(common/pipeline/stage.hpp:24-194 ``StageManager``/``AssemblyStage`` +
``SavesPolicy``, driver loop at pipeline/stage.cpp:143-203) and its
``GraphPack`` heterogeneous container (pipeline/graph_pack.hpp:16):

- ``PipelineContext`` holds the shared state (read tensors, graph,
  libraries, genomic info, contigs) and knows how to save/load itself as
  npz + json (replacing io/binary/graph_pack.cpp:26-166);
- ``StageManager.run`` executes stages in order, checkpointing after each
  and resolving ``--continue`` / ``--restart-from`` / ``--stop-after``
  exactly like stage.cpp:49-100 resolves entry points.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np


class PipelineContext:
    """The GraphPack: heterogeneous, checkpointable pipeline state."""

    def __init__(self):
        self.codes: np.ndarray | None = None      # (R, L) uint8
        self.lengths: np.ndarray | None = None    # (R,) int32
        self.quals: np.ndarray | None = None      # (R, L) uint8 phred+33
        self.paired_ranges: list[tuple] = []
        # each: (start1, count1, start2, count2, kind) row ranges into
        # codes; kind is "pe" or "mp" (library.hpp LibraryType)
        self.read_length: int = 0
        self.graph = None                          # graph.graph.Graph
        self.genomic_info = None                   # coverage_model.GenomicInfo
        self.contigs: list[tuple[str, float]] = [] # current contig set
        self.final_contigs: list[tuple[str, float]] = []
        self.scaffolds: list[tuple[str, float]] = []
        self.params: dict = {}                     # misc (ks, is_stats, ...)

    # ---- serialization (io/binary/graph_pack.cpp equivalent) ----

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        arrays = {}
        if self.codes is not None:
            arrays["codes"] = np.asarray(self.codes)
            arrays["lengths"] = np.asarray(self.lengths)
            if self.quals is not None:
                arrays["quals"] = np.asarray(self.quals)
        if self.graph is not None:
            g = self.graph
            for name in ("seq_flat", "seq_start", "seq_len", "cov",
                         "start_v", "end_v", "conj", "alive", "num_edges"):
                arrays[f"graph_{name}"] = np.asarray(getattr(g, name))
            arrays["graph_k"] = np.asarray(g.k)
            if g.flank is not None:
                arrays["graph_flank"] = np.asarray(g.flank)
        np.savez_compressed(os.path.join(directory, "pack.npz"), **arrays)
        meta = {
            "paired_ranges": self.paired_ranges,
            "read_length": self.read_length,
            "contigs": self.contigs,
            "final_contigs": self.final_contigs,
            "scaffolds": self.scaffolds,
            "params": self.params,
            "genomic_info": (vars(self.genomic_info)
                             if self.genomic_info else None),
        }
        with open(os.path.join(directory, "pack.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, directory: str) -> "PipelineContext":
        from ..graph.graph import Graph
        from ..kmers.coverage_model import GenomicInfo
        ctx = cls()
        data = np.load(os.path.join(directory, "pack.npz"))
        if "codes" in data:
            ctx.codes = data["codes"]
            ctx.lengths = data["lengths"]
            if "quals" in data:
                ctx.quals = data["quals"]
        if "graph_seq_flat" in data:
            import jax.numpy as jnp
            ctx.graph = Graph(
                seq_flat=jnp.asarray(data["graph_seq_flat"]),
                seq_start=jnp.asarray(data["graph_seq_start"]),
                seq_len=jnp.asarray(data["graph_seq_len"]),
                cov=jnp.asarray(data["graph_cov"]),
                start_v=jnp.asarray(data["graph_start_v"]),
                end_v=jnp.asarray(data["graph_end_v"]),
                conj=jnp.asarray(data["graph_conj"]),
                alive=jnp.asarray(data["graph_alive"]),
                num_edges=jnp.asarray(data["graph_num_edges"]),
                k=int(data["graph_k"]),
                flank=(jnp.asarray(data["graph_flank"])
                       if "graph_flank" in data else None),
            )
        with open(os.path.join(directory, "pack.json")) as f:
            meta = json.load(f)
        ctx.paired_ranges = [tuple(r) for r in meta["paired_ranges"]]
        ctx.read_length = meta["read_length"]
        ctx.contigs = [tuple(c) for c in meta["contigs"]]
        ctx.final_contigs = [tuple(c) for c in meta["final_contigs"]]
        ctx.scaffolds = [tuple(c) for c in meta.get("scaffolds", [])]
        ctx.params = meta["params"]
        if meta["genomic_info"]:
            ctx.genomic_info = GenomicInfo(**meta["genomic_info"])
        return ctx


@dataclass
class Stage:
    """An assembly stage (stage.hpp:24 AssemblyStage)."""
    name: str
    fn: Callable[[PipelineContext], None]


@dataclass
class StageManager:
    """Runs stages with checkpoint/resume (stage.cpp:143-203).

    checkpoints: "none" | "last" | "all" (SavesPolicy, stage.hpp:156).
    """
    stages: list[Stage]
    output_dir: str
    checkpoints: str = "last"
    log: Callable[[str], None] = print

    @property
    def saves_dir(self) -> str:
        return os.path.join(self.output_dir, "saves")

    def _checkpoint_file(self) -> str:
        return os.path.join(self.saves_dir, "checkpoint.dat")

    def completed_stage(self) -> str | None:
        try:
            with open(self._checkpoint_file()) as f:
                return f.read().strip() or None
        except FileNotFoundError:
            return None

    def run(self, ctx: PipelineContext, continue_run: bool = False,
            restart_from: str | None = None,
            stop_after: str | None = None) -> PipelineContext:
        names = [s.name for s in self.stages]
        start_idx = 0
        if restart_from is not None:
            if restart_from not in names:
                raise ValueError(f"unknown stage {restart_from!r}; "
                                 f"stages: {names}")
            start_idx = names.index(restart_from)
        elif continue_run:
            done = self.completed_stage()
            if done is not None:
                if done == names[-1]:
                    self.log(f"== all stages already complete ({done})")
                    return PipelineContext.load(
                        os.path.join(self.saves_dir, done))
                start_idx = names.index(done) + 1 if done in names else 0

        if start_idx > 0:
            # roll back to the latest stage that still has saves
            # (stage.cpp:146-180 load-or-roll-back behavior)
            load_idx = start_idx - 1
            while load_idx >= 0 and not os.path.exists(os.path.join(
                    self.saves_dir, names[load_idx], "pack.json")):
                load_idx -= 1
            if load_idx < 0:
                self.log("== no usable saves; restarting from scratch")
                start_idx = 0
            else:
                if load_idx != start_idx - 1:
                    self.log(f"== saves for '{names[start_idx - 1]}' "
                             f"missing; rolling back to "
                             f"'{names[load_idx]}'")
                start_idx = load_idx + 1
                prev = names[load_idx]
                self.log(f"== resuming from saves of stage '{prev}'")
                ctx = PipelineContext.load(
                    os.path.join(self.saves_dir, prev))

        from ..utils import timetrace
        for stage in self.stages[start_idx:]:
            t0 = time.time()
            self.log(f"== STAGE {stage.name}")
            with timetrace.scope(f"stage:{stage.name}"):
                stage.fn(ctx)
            # peak RSS per stage like the reference's memory reporting
            # (utils/perf/memory.hpp; the manual's per-stage RAM table,
            # README.md:108-148)
            try:
                import resource
                peak_gb = resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
                mem = f", peak RSS {peak_gb:.2f} GB"
            except Exception:
                peak_gb = None
                mem = ""
            self.log(f"== STAGE {stage.name} done in "
                     f"{time.time()-t0:.1f}s{mem}")
            from ..utils import membudget
            budget = membudget.get_budget_gb()
            if budget and peak_gb and peak_gb > budget:
                # the reference hard-kills on exceeding -m via
                # RLIMIT_AS (utils/memory_limit.hpp:14); here the
                # budget sizes the chunk knobs, so an overrun means
                # the estimate was off — surface it
                self.log(f"== WARNING: stage {stage.name} peak RSS "
                         f"{peak_gb:.2f} GB exceeds --memory "
                         f"{budget:.0f} GB")
            if timetrace.enabled():
                # dump incrementally so a crash mid-pipeline still
                # leaves the phase breakdown on disk
                timetrace.dump(os.path.join(self.output_dir,
                                            "spades_time_trace.json"))
            if self.checkpoints != "none":
                sdir = os.path.join(self.saves_dir, stage.name)
                ctx.save(sdir)
                with open(self._checkpoint_file(), "w") as f:
                    f.write(stage.name)
                if self.checkpoints == "last":
                    # drop older saves except the previous one
                    idx = names.index(stage.name)
                    for old in names[:max(0, idx - 1)]:
                        old_dir = os.path.join(self.saves_dir, old)
                        if os.path.isdir(old_dir):
                            import shutil
                            shutil.rmtree(old_dir)
            if stop_after == stage.name:
                self.log(f"== stopping after stage '{stage.name}'")
                break
        return ctx
