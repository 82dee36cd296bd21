"""Simplification orchestration: iterative tips/bulges/EC to a fixed point.

Device-side counterpart of the reference's GraphSimplifier
(assembler/src/common/stages/simplification.cpp:47-407: InitialCleaning ->
cycle of {tip, bulge, EC} with iterative coverage thresholds x
cycle_iter_count -> PostSimplification), with parameter semantics from
configs/debruijn/simplification.info and the condition parser
(stages/simplification_pipeline/graph_simplification.hpp:85-180):

- tc_lb:   max_tip_length = max(min(k, read_len/2) * tc_lb, read_len)
- cb:      absolute coverage upper bound; "auto" = detected coverage
           bound from the coverage model (genomic_info_filler.cpp)
- rctc:    tip_cov < rctc * max coverage of competing edges
- to_ec_lb: max_ec_length = 2 * tip_length(to_ec_lb) - 1
- icb:     iterative coverage bound, ramped linearly over the cycle
- bulge:   max_bulge_length = coeff * k, relative delta 0.1

Cycle conditions (simplification.info): tc "{tc_lb 1.5, cb 1.5, rctc 2.0}
{tc_lb 2., cb 1.5}"; ec "{to_ec_lb 0.8, icb auto(*1.5 isolate)}";
final_tc "{tc_lb 1.5, cb 3.0, rctc 2.0} {tc_lb 4., cb auto}".
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..graph.graph import Graph
from ..utils.logger import get_logger
from ..utils.timetrace import scope as _scope
from . import passes
from .recondense import recondense

_log = get_logger("Simplification")


@dataclass
class SimplifyConfig:
    read_length: int = 100
    # tip clipper cycle clauses: (tc_lb, cb_absolute_or_None=auto, rctc)
    tip_clauses: tuple = ((1.5, 1.5, 2.0), (2.0, 1.5, None))
    # final tip clipper clauses
    final_tip_clauses: tuple = ((1.5, 3.0, 2.0), (4.0, None, None))
    # rna low-complexity clippers (rna_simplification.hpp: AT edges
    # early, AT tips in post-simplification)
    low_complexity_enabled: bool = False
    # bulge remover (br)
    bulge_length_coeff: float = 3.0
    bulge_len_additive: int = 100   # max_additive_length_coefficient
    bulge_max_coverage: float = 1000.0
    bulge_rel_delta: float = 0.1
    # erroneous connection remover (ec): { to_ec_lb 0.8, icb auto }
    ec_to_lb: float = 0.8
    ec_icb: float = 1.5  # multiplier on the detected bound (isolate mode)
    # when set, max_ec_length = k + ec_lb_additive instead of the
    # tip-originated formula (the "ec_lb N" condition form, used by meta)
    ec_lb_additive: int | None = None
    # bulge remover extras (br block): alternative path must carry at
    # least cov(e)/max_relative_coverage; min_identity 0 = disabled
    bulge_max_rel_coverage: float = 1.1
    bulge_min_identity: float = 0.0
    path_bulge_enabled: bool = True
    # final_br clause (rnaviral_mode.info:29-32 disables it)
    final_br_enabled: bool = True
    # relative-coverage component removal (rcc block; meta/sc enable it;
    # lengths are read_length multiples, relative_coverage_remover.hpp
    # via graph_simplification.hpp:409-440)
    rcc_enabled: bool = False
    rcc_coverage_gap: float = 5.0
    rcc_length_coeff: float = 2.0
    rcc_tip_allowing_coeff: float = 3.0
    rcc_vertex_limit: int = 30
    rcc_max_ec_len_additive: int = 30     # max_ec_length_coefficient
    rcc_max_coverage_coeff: float = 2.0   # <0 = unlimited
    # relative-coverage edge disconnector (red block; meta)
    red_enabled: bool = False
    red_diff_mult: float = 20.0
    red_edge_sum: int = 10000
    red_unconditional_diff_mult: float = 0.0
    # complex tip clipper (complex_tc block; enabled by default upstream)
    complex_tc_enabled: bool = True
    complex_tc_max_edge_len: int = 100
    complex_tc_lb: float = 3.5
    complex_tc_rel_coverage: float = -1.0
    # topology-based EC remover (tec; MDA mode only —
    # topology_simplif_enabled, mda_mode.info:6)
    tec_enabled: bool = False
    tec_max_ec_len_additive: int = 20   # max_ec_length_coefficient
    tec_uniqueness_length: int = 1500
    tec_plausibility_length: int = 200
    # topology+reliability EC remover (trec block,
    # simplification.info:212-217; runs with the MDA topology block)
    trec_max_ec_len_additive: int = 100
    trec_uniqueness_length: int = 1500
    trec_unreliable_coverage: float = 2.5
    # interstrand EC / thorn remover (isec block,
    # simplification.info:220-225)
    isec_max_ec_len_additive: int = 100
    isec_uniqueness_length: int = 1500
    isec_span_distance: int = 15000
    # max-flow EC remover (mfec block, simplification.info:228-234;
    # disabled by default in every reference mode, opt-in)
    mfec_enabled: bool = False
    mfec_max_ec_len_additive: int = 30  # max_ec_length_coefficient
    mfec_uniqueness_length: int = 1500
    mfec_plausibility_length: int = 200
    # hidden-EC removers (her block; sc enables plain, meta the meta kind)
    her_enabled: bool = False
    her_meta: bool = False
    her_uniqueness_length: int = 1500
    her_unreliability_coeff: float = 4.0  # x detected ec bound
    her_relative_threshold: float = 5.0
    # superbubble collapse (rna; superbubble_finder.hpp:21)
    superbubble_enabled: bool = False
    superbubble_max_length: int = 1000
    # cycle (cycle_iter_count)
    rounds: int = 10
    # ier with use_rl_for_max_length_any_cov: isolated edges up to
    # read_length go regardless of coverage
    isolated_max_length: int | None = None
    isolated_max_coverage: float = 1e18


def _tip_length(k: int, read_length: int, lb: float) -> int:
    # LengthThresholdFinder::MaxTipLength (simplification_settings.hpp:16):
    # round(min(k, read_length/2) * coeff); compared against edge length
    # in k-mers (g.length()), like every reference length bound.
    return int(round(min(k, read_length / 2) * lb))


def _clip_tips_clauses(g: Graph, v_space: int, clauses, k: int,
                       read_length: int, auto_cb: float) -> Graph:
    for clause in clauses:
        # 3-tuple (lb, cb, rctc) or 4-tuple with the rna mmm conjunct
        lb, cb, rctc = clause[:3]
        mmm = clause[3] if len(clause) > 3 else None
        length = _tip_length(k, read_length, lb)
        cov_bound = auto_cb if cb is None else cb
        rel = 1e18 if rctc is None else rctc
        require = None
        if mmm is not None:
            from . import advanced
            require = jnp.asarray(
                advanced.mismatch_tip_mask(g, v_space, mmm))
        g = passes.clip_tips(g, v_space, jnp.int32(length),
                             jnp.float32(cov_bound), jnp.float32(rel),
                             require=require)
    return g


def simplify_graph(g: Graph, v_space: int, ec_bound: float,
                   cfg: SimplifyConfig = SimplifyConfig(),
                   protected_fn=None) -> Graph:
    """Run the full simplification cycle. ``ec_bound`` is the detected
    coverage bound from the coverage model (GenomicInfo.ec_bound).

    ``protected_fn(g) -> bool mask``: edges protected from bulge gluing
    (blackbird restricted edges, simplification.cpp:200-212); re-evaluated
    each round because recondensation renumbers edges."""
    k = g.k
    rl = cfg.read_length
    auto_cb = max(ec_bound, 1.0)
    # MaxBulgeLength = max(k*coeff, k + additive) (simplification_settings
    # .hpp:21); compared against edge length in k-mers
    bulge_len = max(int(round(cfg.bulge_length_coeff * k)),
                    k + cfg.bulge_len_additive)
    if cfg.ec_lb_additive is not None:
        ec_len = k + cfg.ec_lb_additive
    else:
        ec_len = 2 * _tip_length(k, rl, cfg.ec_to_lb) - 1
    final_ec_threshold = cfg.ec_icb * auto_cb

    _log.debug(f"simplification cycle: {cfg.rounds} rounds, "
               f"ec_len {ec_len}, final ec threshold "
               f"{final_ec_threshold:.2f}, bulge_len {bulge_len}")
    with _scope("simplify_cycle", rounds=cfg.rounds):
        for i in range(cfg.rounds):
            # iterative threshold ramp (AlgorithmRunningHelper::
            # IterativeThresholdsRun, parallel_processing.hpp:161)
            ec_thr = final_ec_threshold * (i + 1) / cfg.rounds
            g = _clip_tips_clauses(g, v_space, cfg.tip_clauses, k, rl,
                                   auto_cb)
            g = recondense(g, v_space)
            g = passes.remove_bulges(g, v_space, jnp.int32(bulge_len),
                                     jnp.float32(cfg.bulge_rel_delta),
                                     jnp.float32(cfg.bulge_max_coverage),
                                     protected=(protected_fn(g)
                                                if protected_fn else None))
            g = recondense(g, v_space)
            g = passes.remove_erroneous_connections(
                g, v_space, jnp.int32(ec_len), jnp.float32(ec_thr))
            g = recondense(g, v_space)

    # --- post-simplification (PostSimplification order,
    # stages/simplification.cpp:230-330) ---
    from . import advanced

    if cfg.low_complexity_enabled:
        # rna "AT edges" + "AT Tips" (simplification.cpp:113,302)
        g, v_space, n1 = advanced.remove_low_complexity_short_edges(
            g, v_space)
        g, v_space, n2 = advanced.clip_low_complexity_tips(g, v_space)
        if n1 or n2:
            g = recondense(g, v_space)

    if cfg.rcc_enabled:
        # edge-level relative EC pre-pass (rcec-like), then the faithful
        # component remover (relative_coverage_remover.hpp:692)
        g = passes.remove_relative_low_coverage(
            g, v_space, jnp.float32(cfg.rcc_coverage_gap),
            jnp.int32(int(cfg.rcc_length_coeff * rl)))
        g = recondense(g, v_space)
        max_cov = (cfg.rcc_max_coverage_coeff * auto_cb
                   if cfg.rcc_max_coverage_coeff >= 0 else float("inf"))
        g, v_space, n = advanced.remove_rcc_components(
            g, v_space,
            coverage_gap=cfg.rcc_coverage_gap,
            length_bound=int(cfg.rcc_length_coeff * rl),
            tip_allowing_length_bound=int(cfg.rcc_tip_allowing_coeff * rl),
            longest_connecting_path_bound=k + cfg.rcc_max_ec_len_additive,
            max_coverage=max_cov,
            vertex_count_limit=cfg.rcc_vertex_limit)
        if n:
            g = recondense(g, v_space)

    if cfg.red_enabled:
        g, v_space, n = advanced.disconnect_relative_low(
            g, v_space, diff_mult=cfg.red_diff_mult,
            edge_sum=cfg.red_edge_sum,
            unconditional_diff_mult=cfg.red_unconditional_diff_mult)
        if n:
            g = recondense(g, v_space)

    if cfg.complex_tc_enabled:
        with _scope("complex_tips"):
            g, v_space, n = advanced.clip_complex_tips(
                g, v_space, max_edge_len=cfg.complex_tc_max_edge_len,
                max_path_len=_tip_length(k, rl, cfg.complex_tc_lb),
                relative_coverage=cfg.complex_tc_rel_coverage)
        if n:
            g = recondense(g, v_space)

    if cfg.path_bulge_enabled:
        prot = None
        if protected_fn is not None:
            prot = np.asarray(protected_fn(g))
        with _scope("path_bulges"):
            g, v_space, n = advanced.remove_path_bulges(
                g, v_space, max_length=bulge_len,
                max_coverage=cfg.bulge_max_coverage,
                max_relative_coverage=cfg.bulge_max_rel_coverage,
                max_relative_delta=cfg.bulge_rel_delta,
                min_identity=cfg.bulge_min_identity,
                protected=prot)
        if n:
            g = recondense(g, v_space)

    if cfg.superbubble_enabled:
        from .superbubble import collapse_superbubbles
        g, nb = collapse_superbubbles(
            g, max_length=cfg.superbubble_max_length)
        if nb:
            g = recondense(g, v_space)

    # final tip clipper + bulge pass (final_br; rnaviral disables it)
    g = _clip_tips_clauses(g, v_space, cfg.final_tip_clauses, k, rl, auto_cb)
    g = recondense(g, v_space)
    if cfg.final_br_enabled:
        g = passes.remove_bulges(g, v_space, jnp.int32(bulge_len),
                                 jnp.float32(cfg.bulge_rel_delta),
                                 jnp.float32(cfg.bulge_max_coverage),
                                 protected=(protected_fn(g)
                                            if protected_fn else None))
        g = recondense(g, v_space)

    if cfg.tec_enabled:
        # MDA topology simplification block, in the reference's order:
        # tec -> trec -> isec(thorns) -> multiplicity-counting
        # (simplification.cpp:83-87)
        with _scope("topology_block"):
            g, v_space, n = advanced.remove_topology_ec(
                g, v_space,
                max_ec_length=k + cfg.tec_max_ec_len_additive,
                uniqueness_length=cfg.tec_uniqueness_length,
                plausibility_length=cfg.tec_plausibility_length)
            if n:
                g = recondense(g, v_space)
            g, v_space, n = advanced.remove_tr_ec(
                g, v_space,
                max_ec_length=k + cfg.trec_max_ec_len_additive,
                uniqueness_length=cfg.trec_uniqueness_length,
                unreliable_coverage=cfg.trec_unreliable_coverage)
            if n:
                g = recondense(g, v_space)
            g, v_space, n = advanced.remove_thorns(
                g, v_space,
                max_ec_length=k + cfg.isec_max_ec_len_additive,
                uniqueness_length=cfg.isec_uniqueness_length,
                span_distance=cfg.isec_span_distance)
            if n:
                g = recondense(g, v_space)
            g, v_space, n = advanced.remove_multiplicity_ec(
                g, v_space,
                max_ec_length=k + cfg.tec_max_ec_len_additive,
                uniqueness_length=cfg.tec_uniqueness_length,
                plausibility_length=cfg.tec_plausibility_length)
            if n:
                g = recondense(g, v_space)

    if cfg.mfec_enabled:
        # MaxFlowRemoveErroneousEdges (simplification.cpp:87)
        g, v_space, n = advanced.remove_max_flow_ec(
            g, v_space, max_ec_length=k + cfg.mfec_max_ec_len_additive,
            uniqueness_length=cfg.mfec_uniqueness_length,
            plausibility_length=cfg.mfec_plausibility_length)

    if cfg.her_enabled or cfg.her_meta:
        g, v_space, n = advanced.remove_hidden_ec(
            g, v_space,
            uniqueness_length=cfg.her_uniqueness_length,
            unreliability_threshold=cfg.her_unreliability_coeff * auto_cb,
            ec_threshold=auto_cb,
            relative_threshold=cfg.her_relative_threshold,
            meta=cfg.her_meta)
        if n:
            g = recondense(g, v_space)

    iso_len = cfg.isolated_max_length
    if iso_len is None:
        iso_len = rl
    g = passes.remove_isolated(g, v_space, jnp.int32(iso_len),
                               jnp.float32(cfg.isolated_max_coverage))
    if _log.enabled(1):  # DEBUG: SimplificationCleanup-style stats
        _log.debug(f"simplified: {alive_edge_count(g)} edges alive")
    return g


def alive_edge_count(g: Graph) -> int:
    return int(np.asarray(passes.edge_mask(g)).sum())
