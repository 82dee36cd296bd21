"""Advanced simplification: path bulges, relative-coverage components,
disconnection, complex tips, hidden ECs.

Device-side counterparts of the reference's sequential "hard" cleaners:

- path-alternative bulge removal   (modules/simplification/bulge_remover.hpp:200
  ``AlternativesAnalyzer`` + ``MostCoveredSimpleAlternativePathChooser:64``)
- relative-coverage component remover
  (modules/simplification/relative_coverage_remover.hpp:220-745)
- relative-coverage edge disconnector
  (relative_coverage_remover.hpp:281 ``RelativeCovDisconnectionCondition`` +
  assembly_graph/graph_support/edge_removal.hpp:134 ``EdgeDisconnector``)
- complex tip clipper              (modules/simplification/complex_tip_clipper.hpp:19
  + dominated_set_finder.hpp:7)
- hidden-EC removers               (modules/simplification/
  erroneous_connection_remover.hpp:414 ``MetaHiddenECRemover``, :499
  ``HiddenECRemover``)

Design: the heavy whole-graph passes (tips/parallel bulges/EC) run on
device every cycle (simplify/passes.py); these *localized* cleaners walk
tiny bounded neighbourhoods of the already-compacted graph (thousands of
edges, bounded Dijkstra with vertex limits in the reference too), so they
run host-side over a mutable array view, exactly like the reference's
smart-iterator loop — then the device recondense() re-contracts chains.
"""

from __future__ import annotations

import functools

import numpy as np

from ..ops import dna
from ..graph.graph import Graph, edge_mask
from ..utils.logger import get_logger

_log = get_logger("Simplification")


class Range:
    __slots__ = ("start", "end")

    def __init__(self, start: int, end: int):
        self.start, self.end = start, end


class HostGraph:
    """Mutable host-side view of the edge table with adjacency upkeep.

    Plays the role the reference's ObservableGraph + action handlers play
    during sequential simplification (core/observable_graph.hpp:21):
    deletions and disconnections keep the adjacency coherent so later
    candidates see the current graph.
    """

    def __init__(self, g: Graph, v_space: int):
        import jax
        import jax.numpy as jnp
        self.k = g.k
        self.capacity = g.capacity
        # pull only the ALIVE rows: device-side gather of the live rows
        # into a dense block, then one small transfer — the edge table's
        # capacity is mostly dead rows after cleaning
        alive_dev = edge_mask(g)
        n_alive = int(jnp.sum(alive_dev))
        E = g.capacity
        self.alive = np.zeros(E, bool)
        self.start_v = np.zeros(E, np.int64)
        self.end_v = np.zeros(E, np.int64)
        self.conj = np.zeros(E, np.int64)
        self.cov = np.zeros(E, np.float64)
        self.flank = None if g.flank is None else np.zeros(E, np.float64)
        self.seq_start = np.zeros(E, np.int64)
        self.seq_len = np.zeros(E, np.int64)
        if n_alive:
            cap = min(1 << max(1, n_alive - 1).bit_length(), E)

            @functools.partial(jax.jit, static_argnames=("cap",))
            def _gather(alive, sv, ev, cj, cv, fl, ss, sl, cap):
                idx = jnp.nonzero(alive, size=cap, fill_value=0)[0]
                cols = [idx.astype(jnp.int32), sv[idx], ev[idx],
                        cj[idx], ss[idx], sl[idx]]
                fcols = [cv[idx]] + ([] if fl is None else [fl[idx]])
                return (jnp.stack([c.astype(jnp.int32) for c in cols]),
                        jnp.stack(fcols).astype(jnp.float32))

            icols, fcols = _gather(alive_dev, g.start_v, g.end_v,
                                   g.conj, g.cov, g.flank,
                                   g.seq_start, g.seq_len, cap=cap)
            icols = np.asarray(icols)
            fcols = np.asarray(fcols)
            ids = icols[0, :n_alive]
            self.alive[ids] = True
            self.start_v[ids] = icols[1, :n_alive]
            self.end_v[ids] = icols[2, :n_alive]
            self.conj[ids] = icols[3, :n_alive]
            self.seq_start[ids] = icols[4, :n_alive]
            self.seq_len[ids] = icols[5, :n_alive]
            self.cov[ids] = fcols[0, :n_alive]
            if self.flank is not None:
                self.flank[ids] = fcols[1, :n_alive]
        self.seq_flat = g.seq_flat  # immutable here
        self._flat_host = None      # memoized packed pull
        self._g = g
        self.out: dict[int, list[int]] = {}
        self.inc: dict[int, list[int]] = {}
        for e in np.nonzero(self.alive)[0]:
            e = int(e)
            self.out.setdefault(int(self.start_v[e]), []).append(e)
            self.inc.setdefault(int(self.end_v[e]), []).append(e)
        used = [0]
        if self.alive.any():
            ids = np.nonzero(self.alive)[0]
            used.append(int(self.start_v[ids].max()))
            used.append(int(self.end_v[ids].max()))
        self.next_vbase = max(used) // 2 + 1
        self.v_space = v_space
        self.n_changed = 0

    # --- queries ------------------------------------------------------
    def len_k(self, e: int) -> int:
        """Edge length in k-mers (the reference's g.length())."""
        return int(self.seq_len[e]) - self.k

    def flat_host(self) -> np.ndarray:
        """Host copy of the code buffer (packed pull, memoized)."""
        if self._flat_host is None:
            from ..ops import dna as _dna
            self._flat_host = _dna.pull_codes_packed(self.seq_flat)
        return self._flat_host

    def out_edges(self, v: int) -> list[int]:
        return [e for e in self.out.get(v, []) if self.alive[e]]

    def in_edges(self, v: int) -> list[int]:
        return [e for e in self.inc.get(v, []) if self.alive[e]]

    def incident(self, v: int) -> list[int]:
        return self.out_edges(v) + [e for e in self.in_edges(v)
                                    if int(self.start_v[e]) != v]

    def is_dead_end(self, v: int) -> bool:
        return not self.out_edges(v)

    def is_dead_start(self, v: int) -> bool:
        return not self.in_edges(v)

    def local_cov(self, e: int, v: int) -> float:
        """FlankingCoverage::LocalCoverage (detail_coverage.hpp:109):
        flank at whichever end of ``e`` touches ``v``; falls back to the
        whole-edge average when flanks are unavailable."""
        if self.flank is None:
            return float(self.cov[e])
        if int(self.start_v[e]) == v:
            return float(self.flank[e])
        return float(self.flank[self.conj[e]])

    # --- mutations ----------------------------------------------------
    def kill(self, e: int) -> None:
        for x in (e, int(self.conj[e])):
            self.alive[x] = False
        self.n_changed += 1

    def _new_vertex(self) -> int:
        v = 2 * self.next_vbase
        self.next_vbase += 1
        if 2 * self.next_vbase > self.v_space:
            self.v_space *= 2
        return v

    def add_cov(self, e: int, dc: float) -> None:
        for x in {e, int(self.conj[e])}:
            self.cov[x] += dc
            if self.flank is not None:
                self.flank[x] += dc

    def disconnect_start(self, e: int, trim: int = 1) -> None:
        """EdgeDisconnector (edge_removal.hpp:134): remove the first
        ``trim`` (k+1)-mers of ``e``, detaching it from its start vertex
        (the conjugate edge loses its last ``trim``)."""
        e = int(e)
        ec = int(self.conj[e])
        lk = self.len_k(e)
        if lk <= trim or (ec == e and lk <= 2 * trim):
            self.kill(e)
            return
        old_start = int(self.start_v[e])
        v_new = self._new_vertex()
        self.out[old_start].remove(e)
        self.out.setdefault(v_new, []).append(e)
        self.start_v[e] = v_new
        self.seq_start[e] += trim
        self.seq_len[e] -= trim
        if ec == e:
            # self-conjugate: the same physical edge loses both flanks
            self.seq_len[e] -= trim
            self.inc[old_start ^ 1].remove(e)
            self.inc.setdefault(v_new ^ 1, []).append(e)
            self.end_v[e] = v_new ^ 1
        else:
            old_end = int(self.end_v[ec])
            self.inc[old_end].remove(ec)
            self.inc.setdefault(v_new ^ 1, []).append(ec)
            self.end_v[ec] = v_new ^ 1
            self.seq_len[ec] -= trim
        self.n_changed += 1

    def disconnect_all_out(self, e_src_vertex: int) -> None:
        """MetaHiddenECRemover::DisconnectEdges (erroneous_connection_
        remover.hpp:424): disconnect every out-edge until dead end."""
        guard = 0
        while not self.is_dead_end(e_src_vertex) and guard < 64:
            self.disconnect_start(self.out_edges(e_src_vertex)[0],
                                  trim=self.k + 1)
            guard += 1

    # --- output -------------------------------------------------------
    def to_graph(self) -> tuple[Graph, int]:
        import jax.numpy as jnp
        g = self._g
        real = jnp.arange(self.capacity) < g.num_edges
        out = g._replace(
            alive=jnp.asarray(self.alive) & real,
            start_v=jnp.asarray(self.start_v.astype(np.int32)),
            end_v=jnp.asarray(self.end_v.astype(np.int32)),
            cov=jnp.asarray(self.cov.astype(np.float32)),
            seq_start=jnp.asarray(self.seq_start.astype(np.int32)),
            seq_len=jnp.asarray(self.seq_len.astype(np.int32)),
            flank=(None if self.flank is None
                   else jnp.asarray(self.flank.astype(np.float32))),
        )
        return out, self.v_space


# ---------------------------------------------------------------------
# Path-alternative bulge remover
# ---------------------------------------------------------------------

def _avg_cov(hv: HostGraph, path: list[int]) -> float:
    num = sum(hv.cov[p] * hv.len_k(p) for p in path)
    den = sum(hv.len_k(p) for p in path)
    return num / max(den, 1)


def _simple_path_condition(hv: HostGraph, e: int, path: list[int]) -> bool:
    """SimplePathCondition (bulge_remover.hpp:26): no self-conjugate
    candidate, path avoids e/conj(e), no repeated or conjugate-paired
    path edges, no self-conjugate path edges."""
    if int(hv.conj[e]) == e:
        return False
    seen = set()
    for p in path:
        pc = int(hv.conj[p])
        if p == e or pc == e or p == pc or p in seen or pc in seen:
            return False
        seen.add(p)
    return True


def _most_covered_alt_path(hv: HostGraph, e: int, min_len: int,
                           max_len: int, max_edge_cnt: int,
                           vertex_limit: int) -> list[int] | None:
    """Bounded exhaustive path search start(e)->end(e) keeping the most
    covered simple alternative (PathProcessor + MostCoveredSimpleAlternative
    PathChooser, bulge_remover.hpp:64; paths measured in k-mers)."""
    start, end = int(hv.start_v[e]), int(hv.end_v[e])
    best_path: list[int] | None = None
    best_cov = -1.0
    visited = 0
    stack: list[tuple[int, int, tuple[int, ...]]] = [(start, 0, ())]
    while stack:
        v, length, path = stack.pop()
        visited += 1
        if visited > vertex_limit:
            break
        if v == end and path and min_len <= length <= max_len:
            lp = list(path)
            if _simple_path_condition(hv, e, lp):
                c = _avg_cov(hv, lp)
                if c > best_cov:
                    best_cov, best_path = c, lp
        for nxt in hv.out_edges(v):
            if nxt == e or len(path) >= max_edge_cnt:
                continue
            nl = length + hv.len_k(nxt)
            if nl > max_len or nxt in path:
                continue
            stack.append((int(hv.end_v[nxt]), nl, path + (nxt,)))
    return best_path


def _identity(hv: HostGraph, e: int, path: list[int],
              min_identity: float) -> bool:
    """IdentityCondition (bulge_remover.hpp:227): 1 - editdist/len >=
    min_identity between the bulge and the alternative path sequence."""
    if min_identity <= 0.0:
        return True
    flat = hv.flat_host()
    s1 = flat[hv.seq_start[e]:hv.seq_start[e] + hv.seq_len[e]]
    parts = []
    for i, p in enumerate(path):
        seq = flat[hv.seq_start[p]:hv.seq_start[p] + hv.seq_len[p]]
        parts.append(seq if i == 0 else seq[hv.k:])
    s2 = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    n, m = len(s1), len(s2)
    prev = np.arange(m + 1)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, np.int64)
        cur[0] = i
        sub = prev[:-1] + (s2 != s1[i - 1])
        np.minimum(sub, prev[1:] + 1, out=cur[1:])
        for j in range(1, m + 1):  # insertion relaxation
            if cur[j] > cur[j - 1] + 1:
                cur[j] = cur[j - 1] + 1
        prev = cur
    ident = max(0.0, 1.0 - prev[m] / max(n, m, 1))
    return ident >= min_identity


def remove_path_bulges(g: Graph, v_space: int, *,
                       max_length: int,
                       max_coverage: float = 1000.0,
                       max_relative_coverage: float = 1.1,
                       max_delta: int = 3,
                       max_relative_delta: float = 0.1,
                       max_edge_cnt: int = 32,
                       vertex_limit: int = 3000,
                       min_identity: float = 0.0,
                       protected: np.ndarray | None = None
                       ) -> tuple[Graph, int, int]:
    """Glue bulge edges onto their most-covered alternative *path*
    (AlternativesAnalyzer, bulge_remover.hpp:200-290; gluing projects the
    bulge's coverage mass onto the path, BulgeGluer:108).

    Candidates are processed lightest-coverage first (the reference's
    CoverageComparator ordering). Returns (graph, v_space, n_glued).
    """
    hv = HostGraph(g, v_space)
    ids = np.nonzero(hv.alive)[0]
    order = ids[np.argsort(hv.cov[ids], kind="stable")]
    n = 0
    for e in order:
        e = int(e)
        if not hv.alive[e]:
            continue
        if protected is not None and protected[e]:
            continue
        lk = hv.len_k(e)
        if lk > max_length or hv.cov[e] > max_coverage:
            continue
        delta = max(int(np.floor(max_relative_delta * lk)), max_delta)
        path = _most_covered_alt_path(
            hv, e, max(lk - delta, 0), lk + delta, max_edge_cnt,
            vertex_limit)
        if path is None:
            continue
        # BulgeCondition (bulge_remover.hpp:221)
        if _avg_cov(hv, path) * max_relative_coverage < hv.cov[e]:
            continue
        if not _identity(hv, e, path, min_identity):
            continue
        # project coverage mass of e onto the path edges
        path_len = sum(hv.len_k(p) for p in path)
        dc = hv.cov[e] * lk / max(path_len, 1)
        hv.kill(e)
        for p in path:
            hv.add_cov(p, dc)
        n += 1
    gg, vs = hv.to_graph()
    return gg, vs, n


# ---------------------------------------------------------------------
# Relative-coverage component remover (relative_coverage_remover.hpp)
# ---------------------------------------------------------------------

def _max_local(hv: HostGraph, edges, v: int) -> float:
    return max((hv.local_cov(e, v) for e in edges), default=0.0)


def _any_highly_covered_both_sides(hv: HostGraph, v: int, base: float,
                                   gap: float,
                                   exclude: set[int] | None = None
                                   ) -> bool:
    """RelativeCoverageHelper::AnyHighlyCoveredOnBothSides
    (relative_coverage_remover.hpp:258)."""
    exclude = exclude or set()
    ins = [e for e in hv.in_edges(v) if e not in exclude]
    outs = [e for e in hv.out_edges(v) if e not in exclude]
    return (_max_local(hv, ins, v) > base * gap and
            _max_local(hv, outs, v) > base * gap)


class _Component:
    """relative_coverage::Component (relative_coverage_remover.hpp:27)."""

    def __init__(self, hv: HostGraph, e: int):
        self.hv = hv
        self.edges: set[int] = {e}
        self.inner: set[int] = set()
        self.border: set[int] = {int(hv.start_v[e]), int(hv.end_v[e])}
        self.terminating: set[int] = set()
        self.cumm_length = hv.len_k(e)
        self.contains_deadends = False

    def make_inner(self, v: int) -> None:
        hv = self.hv
        if hv.is_dead_end(v) or hv.is_dead_start(v):
            self.contains_deadends = True
        self.inner.add(v)
        for e in hv.incident(v):
            if e not in self.edges:
                self.edges.add(e)
                self.cumm_length += hv.len_k(e)
                other = (int(hv.end_v[e]) if int(hv.start_v[e]) == v
                         else int(hv.start_v[e]))
                if other not in self.inner:
                    self.border.add(other)
        self.border.discard(v)


def _longest_connecting_path(hv: HostGraph, comp: _Component) -> int | None:
    """LongestPathFinder (relative_coverage_remover.hpp:323): longest
    terminating-to-terminating path through the component; None when the
    component contains a cycle or no such path."""
    memo: dict[int, int] = {}
    NEG = -(1 << 60)

    def compute(v: int, stack: set[int]) -> int | None:
        if v in memo:
            return memo[v]
        if v in stack:
            return None  # cycle
        stack.add(v)
        d = NEG
        for e in hv.in_edges(v):
            if e in comp.edges:
                sub = compute(int(hv.start_v[e]), stack)
                if sub is None:
                    return None
                if sub > NEG:
                    d = max(d, sub + hv.len_k(e))
        if v in comp.terminating:
            d = max(d, 0)
        stack.discard(v)
        memo[v] = d
        return d

    best = 0
    for v in comp.terminating:
        d = compute(v, set())
        if d is None:
            return None
        best = max(best, d)
    return best if best > 0 else None


def remove_rcc_components(g: Graph, v_space: int, *,
                          coverage_gap: float,
                          length_bound: int,
                          tip_allowing_length_bound: int,
                          longest_connecting_path_bound: int,
                          max_coverage: float = float("inf"),
                          vertex_count_limit: int = 10
                          ) -> tuple[Graph, int, int]:
    """Remove relatively-low-covered components hemmed in by highly
    covered flanks on every side (RelativeCoverageComponentRemover,
    relative_coverage_remover.hpp:692; component growth = InnerComponent
    Searcher:476, acceptance = ComponentChecker:397).

    Length bounds are in k-mers; local coverage uses edge flanks.
    Returns (graph, v_space, n_removed).
    """
    from . import recondense as _recondense
    n_removed = 0
    # PersistentProcessingAlgorithm re-queues the neighbourhood after
    # every removal event (graph_support/parallel_processing.hpp:130),
    # and the reference's EdgeRemover compresses the locality of every
    # deletion on the spot (edge_removal.hpp:30-45
    # RemoveIsolatedOrCompress) — merged edges carry recomputed
    # length-weighted coverage and flanks, which later seeds see.
    # Expressed here as whole-pass fixpoint iteration in coverage order
    # with a recondense between passes.
    progressed = True
    while progressed:
        progressed = False
        hv = HostGraph(g, v_space)
        ids = np.nonzero(hv.alive)[0]
        order = ids[np.argsort(hv.cov[ids], kind="stable")]
        n_before = n_removed
        for e in order:
            e = int(e)
            if not hv.alive[e]:
                continue
            v = int(hv.start_v[e])
            # outer-cycle guard (RelativeCovComponentFinder::operator():645)
            if not hv.in_edges(v) or len(hv.out_edges(v)) < 2:
                continue
            base = hv.local_cov(e, v)
            if not _any_highly_covered_both_sides(hv, v, base, coverage_gap):
                continue
            comp = _Component(hv, e)
            failed = False
            while comp.border:
                if len(comp.inner) > vertex_count_limit:
                    failed = True
                    break
                bv = min(comp.border)
                # IsTerminateVertex (relative_coverage_remover.hpp:530)
                base_cov = _max_local(
                    hv, [x for x in hv.incident(bv) if x in comp.edges], bv)
                ins = [x for x in hv.in_edges(bv) if x not in comp.edges]
                outs = [x for x in hv.out_edges(bv) if x not in comp.edges]
                terminate = (
                    _max_local(hv, outs, bv) > base_cov * coverage_gap and
                    _max_local(hv, ins, bv) > base_cov * coverage_gap)
                if terminate:
                    comp.terminating.add(bv)
                    comp.border.discard(bv)
                else:
                    comp.make_inner(bv)
                    if bv in comp.terminating:
                        failed = True
                        break
            if failed:
                continue
            # FullCheck (ComponentChecker:442)
            lcp = _longest_connecting_path(hv, comp)
            if lcp is not None and lcp >= longest_connecting_path_bound:
                continue
            if not comp.contains_deadends and comp.cumm_length > length_bound:
                continue
            if comp.cumm_length > tip_allowing_length_bound:
                continue
            if len(comp.inner) > vertex_count_limit:
                continue
            if any(hv.cov[x] > max_coverage for x in comp.edges):
                continue
            for x in list(comp.edges):
                if hv.alive[x]:
                    hv.kill(x)
            n_removed += 1
        progressed = n_removed > n_before
        g, v_space = hv.to_graph()
        if progressed:
            g = _recondense.recondense(g, v_space)
    return g, v_space, n_removed


# ---------------------------------------------------------------------
# Relative-coverage edge disconnector (meta)
# ---------------------------------------------------------------------

def _high_cov_component_length(hv: HostGraph, v: int, bound: float,
                               length_limit: int,
                               edge_limit: int = 1000) -> int:
    """HighCoverageComponentFinder::CumulativeEdgeLength
    (components/splitters.hpp:269): DFS over edges with cov >= bound."""
    seen: set[int] = set()
    total = 0
    stack = list(hv.incident(v))
    while stack:
        e = stack.pop()
        if total >= length_limit or len(seen) > edge_limit:
            break
        if e in seen or int(hv.conj[e]) in seen:
            continue
        if hv.cov[e] < bound:
            continue
        seen.add(e)
        seen.add(int(hv.conj[e]))
        total += hv.len_k(e)
        stack.extend(hv.incident(int(hv.start_v[e])))
        stack.extend(hv.incident(int(hv.end_v[e])))
    return total


def disconnect_relative_low(g: Graph, v_space: int, *,
                            diff_mult: float = 20.0,
                            edge_sum: int = 10000,
                            unconditional_diff_mult: float = 0.0
                            ) -> tuple[Graph, int, int]:
    """RelativeCovDisconnectionCondition + DisconnectionAlgorithm
    (relative_coverage_remover.hpp:281, parallel_processing.hpp:444):
    detach (trim one (k+1)-mer off) edges whose start vertex has much
    higher-covered edges on both sides, when the highly covered
    neighbourhood is long enough to look like real sequence.

    Uses plain average coverage (RelativeAvgCovHelper:167), like the
    reference. Returns (graph, v_space, n_disconnected).
    """
    hv = HostGraph(g, v_space)

    def cond(e: int, mult: float, min_nbr: int) -> bool:
        v = int(hv.start_v[e])
        base = float(hv.cov[e])
        ins = hv.in_edges(v)
        outs = hv.out_edges(v)
        both = (max((hv.cov[x] for x in ins), default=0.0) > base * mult
                and max((hv.cov[x] for x in outs), default=0.0)
                > base * mult)
        if not both:
            return False
        if min_nbr <= 0:
            return True
        return _high_cov_component_length(
            hv, v, base * mult, min_nbr) >= min_nbr

    n = 0
    for e in np.nonzero(hv.alive)[0]:
        e = int(e)
        if not hv.alive[e]:
            continue
        hit = (unconditional_diff_mult > 0.0 and
               cond(e, unconditional_diff_mult, 0)) or \
            cond(e, diff_mult, edge_sum)
        if hit:
            hv.disconnect_start(e, trim=1)
            n += 1
    gg, vs = hv.to_graph()
    return gg, vs, n


# ---------------------------------------------------------------------
# Complex tip clipper
# ---------------------------------------------------------------------

def _fill_dominated(hv: HostGraph, start: int, max_length: int,
                    max_count: int) -> dict[int, Range] | None:
    """DominatedSetFinder::FillDominated (dominated_set_finder.hpp:88)."""
    from collections import deque
    dominated: dict[int, Range] = {start: Range(0, 0)}

    def processable(v: int) -> bool:
        return all(int(hv.start_v[e]) in dominated for e in hv.in_edges(v))

    def push_neighbours(v: int, q) -> None:
        for e in hv.out_edges(v):
            w = int(hv.end_v[e])
            if processable(w):
                q.append(w)

    q = deque()
    push_neighbours(start, q)
    cnt = 1
    while q:
        cnt += 1
        if cnt > max_count:
            return None
        v = q.popleft()
        if v in dominated:
            continue
        lo, hi = 1 << 60, 0
        for e in hv.in_edges(v):
            r = dominated.get(int(hv.start_v[e]))
            if r is None:
                continue
            lo = min(lo, r.start + hv.len_k(e))
            hi = max(hi, r.end + hv.len_k(e))
        if lo > max_length:
            return None
        if any(int(hv.end_v[e]) == start for e in hv.out_edges(v)):
            continue
        dominated[v] = Range(lo, hi)
        push_neighbours(v, q)
    return dominated


def clip_complex_tips(g: Graph, v_space: int, *,
                      max_edge_len: int = 100,
                      max_path_len: int,
                      relative_coverage: float = -1.0,
                      max_count: int = 64
                      ) -> tuple[Graph, int, int]:
    """ComplexTipClipper (complex_tip_clipper.hpp:19): from every dead
    start, grow the dominated vertex set; the component (internal edges +
    exit out-edges) is wiped when every edge is short, it is not a plain
    tip, and its coverage is relatively low. Returns
    (graph, v_space, n_clipped).
    """
    hv = HostGraph(g, v_space)
    n = 0
    roots = sorted({int(v) for v in hv.start_v[hv.alive]})
    for v in roots:
        if hv.in_edges(v) or not hv.out_edges(v):
            continue
        dom = _fill_dominated(hv, v, max_path_len, max_count)
        if dom is None:
            continue
        comp_edges: set[int] = set()
        for u in dom:
            for e in hv.out_edges(u):
                if int(hv.end_v[e]) in dom:
                    comp_edges.add(e)
        ok = True
        for u in dom:
            for e in hv.out_edges(u):
                if int(hv.end_v[e]) not in dom:  # exit edge
                    if dom[u].end + hv.len_k(e) > max_path_len:
                        ok = False
                        break
                    comp_edges.add(e)
            if not ok:
                break
        if not ok or not comp_edges:
            continue
        # ComponentCheck (complex_tip_clipper.hpp:52)
        verts = {v} | {int(hv.end_v[e]) for e in comp_edges} | \
            {int(hv.start_v[e]) for e in comp_edges}
        if len(verts) == 2:
            continue  # plain tip — the simple clipper owns it
        if any(hv.len_k(e) > max_edge_len for e in comp_edges):
            continue
        if relative_coverage >= 0.0:
            tip_cov = min(hv.cov[e] for e in comp_edges)
            outward = 0.0
            for u in verts:
                for e in hv.incident(u):
                    if e not in comp_edges:
                        outward = max(outward, hv.cov[e])
            if outward > 0 and tip_cov / outward >= relative_coverage:
                continue
        for e in list(comp_edges):
            if hv.alive[e]:
                hv.kill(e)
        n += 1
    gg, vs = hv.to_graph()
    return gg, vs, n


# ---------------------------------------------------------------------
# Hidden-EC removers
# ---------------------------------------------------------------------

def _unique_path_len_lower_bound(hv: HostGraph, e: int, bound: int) -> int:
    """UniquePathLengthLowerBound: walk back through unambiguous
    extensions accumulating length (basic_edge_conditions.hpp)."""
    total = hv.len_k(e)
    cur = e
    guard = 0
    while total < bound and guard < 1000:
        v = int(hv.start_v[cur])
        ins = hv.in_edges(v)
        if len(ins) != 1 or len(hv.out_edges(v)) != 1:
            break
        cur = ins[0]
        total += hv.len_k(cur)
        guard += 1
    return total


def _bidir_unique_path_len(hv: HostGraph, e: int, bound: int) -> int:
    """max(forward, backward) cumulative unique-path length through e
    (PathLengthLowerBound + UniquePathFinder,
    topological_edge_conditions.hpp:9-54)."""
    back = _unique_path_len_lower_bound(hv, e, bound)
    total = hv.len_k(e)
    cur = e
    guard = 0
    while total < bound and guard < 1000:
        v = int(hv.end_v[cur])
        outs = hv.out_edges(v)
        if len(outs) != 1 or len(hv.in_edges(v)) != 1:
            break
        cur = outs[0]
        total += hv.len_k(cur)
        guard += 1
    return max(back, total)


def _plausible_path_len(hv: HostGraph, e: int, limit: int,
                        forward: bool) -> int:
    """Longest path length starting with e within ``limit``
    (PlausiblePathFinder, bounded DFS)."""
    best = 0
    stack = [(e, hv.len_k(e))]
    seen = 0
    while stack and seen < 512:
        seen += 1
        cur, ln = stack.pop()
        best = max(best, ln)
        if ln >= limit:
            return best
        v = int(hv.end_v[cur]) if forward else int(hv.start_v[cur])
        nxt = hv.out_edges(v) if forward else hv.in_edges(v)
        for o in nxt:
            stack.append((o, ln + hv.len_k(o)))
    return best


def remove_topology_ec(g: Graph, v_space: int, *,
                       max_ec_length: int,
                       uniqueness_length: int = 1500,
                       plausibility_length: int = 200
                       ) -> tuple[Graph, int, int]:
    """Topology-based erroneous-connection removal
    (TopologyRemoveErroneousEdges, single_cell_simplification.hpp:43-57
    + DefaultUniquenessPlausabilityCondition,
    topological_edge_conditions.hpp:67-162): a short edge is removed
    when, looking from either endpoint, the junction it hangs off has a
    single UNIQUE incoming edge (unique path >= uniqueness_length) and
    some OTHER outgoing edge with a PLAUSIBLE continuation
    (path >= plausibility_length) — i.e. the edge contradicts a
    confidently-unique genomic traversal.  Candidates are processed in
    length order with the alternatives-presence guard; iterates to
    fixpoint with recondense between passes.  Lengths in k-mers.
    Returns (graph, v_space, n_removed)."""
    from . import recondense as _recondense
    n_removed = 0
    progressed = True
    while progressed:
        progressed = False
        hv = HostGraph(g, v_space)
        ids = np.nonzero(hv.alive)[0]
        lens = np.array([hv.len_k(int(e)) for e in ids])
        order = ids[np.argsort(lens, kind="stable")]
        n_before = n_removed
        for e in order:
            e = int(e)
            if not hv.alive[e] or hv.len_k(e) > max_ec_length:
                continue
            vs_, ve_ = int(hv.start_v[e]), int(hv.end_v[e])
            # AddAlternativesPresenceCondition
            if len(hv.out_edges(vs_)) <= 1 or len(hv.in_edges(ve_)) <= 1:
                continue

            def fwd_check():
                ins = hv.in_edges(vs_)
                if len(ins) != 1 or _bidir_unique_path_len(
                        hv, ins[0], uniqueness_length) < uniqueness_length:
                    return False
                return any(
                    _plausible_path_len(hv, o, 2 * plausibility_length,
                                        True) >= plausibility_length
                    for o in hv.out_edges(vs_) if o != e)

            def bwd_check():
                outs = hv.out_edges(ve_)
                if len(outs) != 1 or _bidir_unique_path_len(
                        hv, outs[0], uniqueness_length) < uniqueness_length:
                    return False
                return any(
                    _plausible_path_len(hv, o, 2 * plausibility_length,
                                        False) >= plausibility_length
                    for o in hv.in_edges(ve_) if o != e)

            if fwd_check() or bwd_check():
                hv.kill(e)
                n_removed += 1
        progressed = n_removed > n_before
        g, v_space = hv.to_graph()
        if progressed:
            g = _recondense.recondense(g, v_space)
    return g, v_space, n_removed


def _conj_vertex(hv: HostGraph, v: int) -> int | None:
    """Conjugate vertex id: via any incident edge's conjugate
    (the reference's g.conjugate(VertexId))."""
    for e in hv.out_edges(v):
        return int(hv.end_v[hv.conj[e]])
    for e in hv.in_edges(v):
        return int(hv.start_v[hv.conj[e]])
    return None


def remove_tr_ec(g: Graph, v_space: int, *,
                 max_ec_length: int,
                 uniqueness_length: int = 1500,
                 unreliable_coverage: float = 2.5
                 ) -> tuple[Graph, int, int]:
    """Topology-and-reliable-coverage EC removal
    (TopologyReliabilityRemoveErroneousEdges,
    single_cell_simplification.hpp:99-116 + trec block,
    simplification.info:212-217): a short low-coverage edge hanging off
    a junction whose single incoming edge lies on a unique path >=
    uniqueness_length, with any other outgoing edge present
    (plausibility AlwaysTrue), is removed in length order with the
    alternatives-presence guard.  Returns (graph, v_space, n)."""
    from . import recondense as _recondense
    hv = HostGraph(g, v_space)
    ids = np.nonzero(hv.alive)[0]
    order = ids[np.argsort([hv.len_k(int(e)) for e in ids],
                           kind="stable")]
    n_removed = 0
    for e in order:
        e = int(e)
        if (not hv.alive[e] or hv.len_k(e) > max_ec_length
                or hv.cov[e] >= unreliable_coverage):
            continue
        vs_, ve_ = int(hv.start_v[e]), int(hv.end_v[e])
        if len(hv.out_edges(vs_)) <= 1 or len(hv.in_edges(ve_)) <= 1:
            continue  # AddAlternativesPresenceCondition

        def fwd():
            ins = hv.in_edges(vs_)
            if len(ins) != 1 or _bidir_unique_path_len(
                    hv, ins[0], uniqueness_length) < uniqueness_length:
                return False
            return any(o != e for o in hv.out_edges(vs_))

        def bwd():
            outs = hv.out_edges(ve_)
            if len(outs) != 1 or _bidir_unique_path_len(
                    hv, outs[0], uniqueness_length) < uniqueness_length:
                return False
            return any(o != e for o in hv.in_edges(ve_))

        if fwd() or bwd():
            hv.kill(e)
            n_removed += 1
    g2, vs = hv.to_graph()
    if n_removed:
        g2 = _recondense.recondense(g2, vs)
    return g2, vs, n_removed


def remove_thorns(g: Graph, v_space: int, *,
                  max_ec_length: int,
                  uniqueness_length: int = 1500,
                  span_distance: int = 15000) -> tuple[Graph, int, int]:
    """Interstrand EC ("thorn") removal (RemoveThorns,
    single_cell_simplification.hpp:78-97 + isec block,
    simplification.info:220-225): MDA chimeras connecting a repeat
    instance to the reverse strand.  Candidate short edges are processed
    in coverage order; a thorn must pass
    TopologicalThornCondition (erroneous_connection_remover.hpp:201-251:
    degree pattern 1-in/2-out at start, 2-in/1-out at end, and a path of
    length <= span_distance from start to the conjugate of its end
    vertex) and AdditionalMDAThornCondition (:253-310: a unique long
    flank, or every short incident alternative is >= 15x its coverage).
    Returns (graph, v_space, n)."""
    from . import recondense as _recondense
    hv = HostGraph(g, v_space)
    ids = np.nonzero(hv.alive)[0]
    order = ids[np.argsort([hv.cov[int(e)] for e in ids],
                           kind="stable")]

    def degree_ok(e: int) -> bool:
        vs_, ve_ = int(hv.start_v[e]), int(hv.end_v[e])
        if vs_ == ve_:
            return False
        return (len(hv.out_edges(vs_)) == 2
                and len(hv.in_edges(vs_)) == 1
                and len(hv.out_edges(ve_)) == 1
                and len(hv.in_edges(ve_)) == 2)

    def span_path_exists(e: int) -> bool:
        # bounded BFS EdgeStart(e) -> conjugate(EdgeEnd(e)) within
        # span_distance (ProcessPaths in TopologicalThornCondition)
        vs_ = int(hv.start_v[e])
        target = _conj_vertex(hv, int(hv.end_v[e]))
        if target is None:
            return False
        if vs_ == target:
            return True
        import heapq
        dist = {vs_: 0}
        heap = [(0, vs_)]
        seen = 0
        while heap and seen < 4096:
            seen += 1
            d, v = heapq.heappop(heap)
            if d > dist.get(v, 1 << 60):
                continue
            for o in hv.out_edges(v):
                nd = d + hv.len_k(o)
                if nd > span_distance:
                    continue
                w = int(hv.end_v[o])
                if w == target:
                    return True
                if nd < dist.get(w, 1 << 60):
                    dist[w] = nd
                    heapq.heappush(heap, (nd, w))
        return False

    def unique_flank(e: int) -> bool:
        vs_ = int(hv.start_v[e])
        ins = hv.in_edges(vs_)
        if len(ins) == 1 and hv.len_k(ins[0]) >= uniqueness_length:
            return True
        # CheckUnique(conjugate(EdgeEnd(e))): unique incoming at the
        # conjugate vertex == unique outgoing at the end vertex
        ve_ = int(hv.end_v[e])
        outs = hv.out_edges(ve_)
        return len(outs) == 1 and hv.len_k(outs[0]) >= uniqueness_length

    def ec_around(e: int) -> bool:
        base_cov = max(hv.cov[e], 1e-9)
        for v in (int(hv.start_v[e]), int(hv.end_v[e])):
            for o in hv.incident(v):
                if o == e:
                    continue
                if (hv.len_k(o) < 400
                        and hv.cov[o] / base_cov < 15.0):
                    return False
        return True

    n_removed = 0
    for e in order:
        e = int(e)
        if not hv.alive[e] or hv.len_k(e) > max_ec_length:
            continue
        vs_, ve_ = int(hv.start_v[e]), int(hv.end_v[e])
        if len(hv.out_edges(vs_)) <= 1 or len(hv.in_edges(ve_)) <= 1:
            continue  # alternatives-presence (coverage-order variant)
        if not degree_ok(e):
            continue
        if not (unique_flank(e) or ec_around(e)):
            continue
        # micro-shortcut: conjugate(EdgeStart) == EdgeEnd passes without
        # the path search (erroneous_connection_remover.hpp:238-240)
        if _conj_vertex(hv, vs_) == ve_ or span_path_exists(e):
            hv.kill(e)
            n_removed += 1
    g2, vs = hv.to_graph()
    if n_removed:
        g2 = _recondense.recondense(g2, vs)
    return g2, vs, n_removed


def _multiplicity_count(hv: HostGraph, e: int, start: int,
                        uniqueness_length: int,
                        max_depth: int = 8) -> int:
    """MultiplicityCounter::count
    (topological_edge_conditions.hpp:166-244): balance of unique long
    incoming vs outgoing edges reachable from ``start`` through short
    edges, skipping ``e``; -1 (here: a large sentinel) when undecidable."""
    INVALID = 1 << 30
    result = [0, 0]  # [unique long incoming, unique long outgoing]
    was: set[int] = set()

    def search(a: int, depth: int) -> bool:
        if depth > max_depth:
            return False
        if a in was:
            return True
        was.add(a)
        if not hv.out_edges(a) or not hv.in_edges(a):
            return False
        for o in hv.out_edges(a):
            if o == e:
                if a != start:
                    return False
            elif hv.len_k(o) >= uniqueness_length:
                result[1] += 1
            elif not search(int(hv.end_v[o]), depth + 1):
                return False
        for i in hv.in_edges(a):
            if i == e:
                if a != start:
                    return False
            elif hv.len_k(i) >= uniqueness_length:
                result[0] += 1
            elif not search(int(hv.start_v[i]), depth + 1):
                return False
        return True

    if not search(start, 0):
        return INVALID
    if int(hv.start_v[e]) == start:
        if result[0] < result[1]:
            return INVALID
        return result[0] - result[1]
    if result[0] > result[1]:
        return INVALID
    return result[1] - result[0]


def remove_multiplicity_ec(g: Graph, v_space: int, *,
                           max_ec_length: int,
                           uniqueness_length: int = 1500,
                           plausibility_length: int = 200
                           ) -> tuple[Graph, int, int]:
    """Multiplicity-counting EC removal
    (MultiplicityCountingRemoveErroneousEdges,
    single_cell_simplification.hpp:60-76 + MultiplicityCountingCondition,
    topological_edge_conditions.hpp:247-283): uniqueness of the junction
    flank is judged by counting unique long edges around it (multiplicity
    <= 1) instead of a unique-path length; plausibility is the usual
    bounded plausible-path check.  Length-ordered with the
    alternatives-presence guard.  Returns (graph, v_space, n)."""
    from . import recondense as _recondense
    hv = HostGraph(g, v_space)
    ids = np.nonzero(hv.alive)[0]
    order = ids[np.argsort([hv.len_k(int(e)) for e in ids],
                           kind="stable")]
    n_removed = 0
    for e in order:
        e = int(e)
        if not hv.alive[e] or hv.len_k(e) > max_ec_length:
            continue
        vs_, ve_ = int(hv.start_v[e]), int(hv.end_v[e])
        if len(hv.out_edges(vs_)) <= 1 or len(hv.in_edges(ve_)) <= 1:
            continue

        def plaus(o: int, forward: bool) -> bool:
            return _plausible_path_len(
                hv, o, 2 * plausibility_length,
                forward) >= plausibility_length

        def fwd():
            # CheckUniqueness(in_edge, forward=false): multiplicity is
            # counted from the in-edge's FAR endpoint (EdgeStart)
            ins = hv.in_edges(vs_)
            if len(ins) != 1 or _multiplicity_count(
                    hv, ins[0], int(hv.start_v[ins[0]]),
                    uniqueness_length) > 1:
                return False
            return any(plaus(o, True)
                       for o in hv.out_edges(vs_) if o != e)

        def bwd():
            # CheckUniqueness(out_edge, forward=true): far endpoint =
            # EdgeEnd of the outgoing flank edge
            outs = hv.out_edges(ve_)
            if len(outs) != 1 or _multiplicity_count(
                    hv, outs[0], int(hv.end_v[outs[0]]),
                    uniqueness_length) > 1:
                return False
            return any(plaus(o, False)
                       for o in hv.in_edges(ve_) if o != e)

        if fwd() or bwd():
            hv.kill(e)
            n_removed += 1
    g2, vs = hv.to_graph()
    if n_removed:
        g2 = _recondense.recondense(g2, vs)
    return g2, vs, n_removed


def remove_hidden_ec(g: Graph, v_space: int, *,
                     uniqueness_length: int = 1500,
                     unreliability_threshold: float = 4.0,
                     ec_threshold: float = 1e18,
                     relative_threshold: float = 5.0,
                     meta: bool = False) -> tuple[Graph, int, int]:
    """Hidden-EC removal at suspicious vertices (1 in-edge, 2 out-edges,
    unique long in-path): disconnect the weaker-flank out-edge, or both
    (HiddenECRemover erroneous_connection_remover.hpp:499; meta variant
    :414 requires the two out-edges to be mutually conjugate and ignores
    the unreliability/ec thresholds). Returns (graph, v_space, n)."""
    hv = HostGraph(g, v_space)
    n = 0
    for v in sorted({int(x) for x in hv.start_v[hv.alive]}):
        outs = hv.out_edges(v)
        ins = hv.in_edges(v)
        if len(ins) != 1 or len(outs) != 2:
            continue
        if meta:
            if int(hv.conj[outs[0]]) != outs[1]:
                continue
            if _unique_path_len_lower_bound(
                    hv, ins[0], uniqueness_length) < uniqueness_length:
                continue
        else:
            conj_pair = int(hv.conj[outs[0]]) == outs[1]
            long_enough = hv.len_k(ins[0]) >= uniqueness_length
            if not (conj_pair or long_enough):
                continue
        e1, e2 = sorted(outs, key=lambda x: hv.local_cov(x, v))
        c1, c2 = hv.local_cov(e1, v), hv.local_cov(e2, v)
        if meta:
            if c1 * relative_threshold < c2:
                hv.disconnect_start(e1, trim=hv.k + 1)
            else:
                hv.disconnect_all_out(v)
            n += 1
        else:
            if c2 < unreliability_threshold:
                hv.disconnect_all_out(v)
                n += 1
            elif c1 * relative_threshold < c2 and c1 < ec_threshold:
                hv.disconnect_start(e1, trim=hv.k + 1)
                n += 1
    gg, vs = hv.to_graph()
    return gg, vs, n


def mismatch_tip_mask(g: Graph, v_space: int, max_diff: float
                      ) -> np.ndarray:
    """MismatchTipCondition (tip_clipper.hpp:105-150): edge e (or its
    conjugate) has a LONGER sibling out-edge from the same start vertex
    whose bases agree with e everywhere past the shared k-mer except at
    most ``max_diff`` positions (an absolute count when >= 1, else a
    fraction of e's k-mer length). These tips are sequencing mismatches
    near read ends — the condition rna mode conjoins into its first tip
    clause (rna_mode.info tc condition "mmm 3 ...")."""
    hv = HostGraph(g, v_space)
    flat = dna.pull_codes_packed(g.seq_flat)
    starts = hv.seq_start
    lens = hv.seq_len
    k = hv.k

    def seq(e):
        return flat[starts[e]:starts[e] + lens[e]]

    def inner(e: int) -> bool:
        le = int(lens[e])
        bound = max_diff if max_diff >= 1.0 else max_diff * hv.len_k(e)
        bound = int(round(bound))
        se = None
        for alt in hv.out_edges(int(hv.start_v[e])):
            if alt == e or lens[alt] <= le:
                continue
            if se is None:
                se = seq(e)
            diffs = int(np.sum(se[k:le] != seq(alt)[k:le]))
            if diffs <= bound:
                return True
        return False

    mask = np.zeros(len(hv.alive), bool)
    for e in np.nonzero(hv.alive)[0]:
        e = int(e)
        if inner(e) or inner(int(hv.conj[e])):
            mask[e] = True
    return mask


def _max_base_fraction(flat, start, lo, hi) -> float:
    s = flat[start + lo:start + hi]
    if len(s) == 0:
        return 0.0
    return float(np.bincount(s, minlength=4)[:4].max()) / len(s)


def clip_low_complexity_tips(g: Graph, v_space: int,
                             max_len: int = 200,
                             max_frac: float = 0.8
                             ) -> tuple[Graph, int, int]:
    """LowComplexityTipClipper (rna_simplification.hpp:10): tips of
    length <= max_len whose sequence (minus the shared junction k-mer)
    is dominated by one base (ATCondition(0.8, check_tip=true)) — the
    poly-A/poly-T artifact clipper of rnaSPAdes."""
    hv = HostGraph(g, v_space)
    flat = dna.pull_codes_packed(g.seq_flat)
    n = 0
    for e in np.nonzero(hv.alive)[0]:
        e = int(e)
        if hv.len_k(e) > max_len:
            continue
        lo, hi = 0, int(hv.seq_len[e])
        if not hv.out_edges(int(hv.end_v[e])):
            lo = hv.k
        elif not hv.in_edges(int(hv.start_v[e])):
            hi = hi - hv.k
        else:
            continue
        if _max_base_fraction(flat, int(hv.seq_start[e]), lo, hi) \
                > max_frac:
            hv.kill(e)
            n += 1
    g2, vs = hv.to_graph()
    return g2, vs, n


def remove_low_complexity_short_edges(g: Graph, v_space: int,
                                      max_frac: float = 0.8
                                      ) -> tuple[Graph, int, int]:
    """LowComplexityShortEdgeRemover (rna_simplification.hpp:18):
    1-k-mer edges dominated by one base, tip or not."""
    hv = HostGraph(g, v_space)
    flat = dna.pull_codes_packed(g.seq_flat)
    n = 0
    for e in np.nonzero(hv.alive)[0]:
        e = int(e)
        if hv.len_k(e) > 1:
            continue
        if _max_base_fraction(flat, int(hv.seq_start[e]), 0,
                              int(hv.seq_len[e])) > max_frac:
            hv.kill(e)
            n += 1
    g2, vs = hv.to_graph()
    return g2, vs, n


def remove_max_flow_ec(g: Graph, v_space: int, *,
                       max_ec_length: int,
                       uniqueness_length: int = 1500,
                       plausibility_length: int = 200
                       ) -> tuple[Graph, int, int]:
    """Max-flow erroneous-connection removal (MaxFlowECRemover,
    mf_ec_remover.hpp:357-501; run in the MDA topology block,
    simplification.cpp:87).

    Components hemmed by unique (>= uniqueness_length k-mers) edges are
    modeled as a flow network: every plausible/unique edge entering the
    component sources one unit at its head, every one leaving sinks one
    unit at its tail, and inner non-unique edges carry capacity. When a
    complete flow exists (all source and sink units shipped), suspicious
    short non-tip edges whose endpoints land in different strongly
    connected components of the residual network cannot carry any
    max-flow unit and are removed. Lengths in k-mers; returns
    (graph, v_space, n_removed).
    """
    from collections import defaultdict, deque

    from . import recondense as _recondense

    hv = HostGraph(g, v_space)

    def terminal(v: int) -> bool:
        return len(hv.out_edges(v)) + len(hv.in_edges(v)) == 1

    def is_tip(e: int) -> bool:
        return terminal(int(hv.start_v[e])) or terminal(int(hv.end_v[e]))

    def unique(e: int) -> bool:
        return hv.len_k(e) >= uniqueness_length

    def plausible(e: int) -> bool:
        return hv.len_k(e) >= plausibility_length and not is_tip(e)

    def suspicious(e: int) -> bool:
        return hv.len_k(e) <= max_ec_length and not is_tip(e)

    # LongEdgesExclusiveSplitter: vertex components over non-unique edges
    parent: dict[int, int] = {}

    def find(v: int) -> int:
        r = v
        while parent.setdefault(r, r) != r:
            r = parent[r]
        while parent[v] != r:
            parent[v], v = r, parent[v]
        return r

    ids = [int(e) for e in np.nonzero(hv.alive)[0]]
    for e in ids:
        vs_, ve_ = int(hv.start_v[e]), int(hv.end_v[e])
        find(vs_), find(ve_)
        if not unique(e):
            parent[find(vs_)] = find(ve_)
    comps: dict[int, set[int]] = defaultdict(set)
    for v in list(parent):
        comps[find(v)].add(v)

    S, T = "S", "T"
    n_removed = 0
    for comp in comps.values():
        cap: dict[tuple, int] = defaultdict(int)
        nodes = set(comp) | {S, T}
        src_total = snk_total = 0
        inner = []
        for v in comp:
            for e in hv.out_edges(v):
                head = int(hv.end_v[e])
                if not unique(e) and head in comp:
                    cap[(v, head)] += 10000
                    inner.append(e)
                if plausible(e) or unique(e):
                    cap[(v, T)] += 1  # ProcessSink
                    snk_total += 1
            for e in hv.in_edges(v):
                if plausible(e) or unique(e):
                    cap[(S, int(hv.end_v[e]))] += 1  # ProcessSource
                    src_total += 1
        # zero source/sink capacity still falls through: CheckCompleteFlow
        # passes trivially (0 == 0) and the SCC colouring of the
        # unmodified capacity graph removes acyclic suspicious edges in
        # short-edge-only tangles, as in the reference (mf_ec_remover.hpp)
        if not inner:
            continue

        flow: dict[tuple, int] = defaultdict(int)
        adj: dict = defaultdict(set)
        for (u, v) in cap:
            adj[u].add(v)
            adj[v].add(u)

        def residual(u, v):
            return cap[(u, v)] - flow[(u, v)] + flow[(v, u)]

        total_flow = 0
        while True:  # Edmonds-Karp (BFS augmenting paths)
            prev = {S: None}
            q = deque([S])
            while q and T not in prev:
                u = q.popleft()
                for v in adj[u]:
                    if v not in prev and residual(u, v) > 0:
                        prev[v] = u
                        q.append(v)
            if T not in prev:
                break
            path, v = [], T
            while v is not None:
                path.append(v)
                v = prev[v]
            path.reverse()
            aug = min(residual(a, b) for a, b in zip(path, path[1:]))
            for a, b in zip(path, path[1:]):
                back = min(flow[(b, a)], aug)
                flow[(b, a)] -= back
                flow[(a, b)] += aug - back
            total_flow += aug
        if total_flow != src_total or total_flow != snk_total:
            continue  # CheckCompleteFlow failed: suspicious component

        # SCC colouring of the residual network (iterative Tarjan)
        succ = {u: [v for v in adj[u] if residual(u, v) > 0]
                for u in nodes}
        index: dict = {}
        low: dict = {}
        on_stack: set = set()
        stack: list = []
        colour: dict = {}
        counter = [0]
        ncol = [0]
        for root in nodes:
            if root in index:
                continue
            work = [(root, 0)]
            while work:
                u, pi = work.pop()
                if pi == 0:
                    index[u] = low[u] = counter[0]
                    counter[0] += 1
                    stack.append(u)
                    on_stack.add(u)
                recurse = False
                kids = succ[u]
                for i in range(pi, len(kids)):
                    w = kids[i]
                    if w not in index:
                        work.append((u, i + 1))
                        work.append((w, 0))
                        recurse = True
                        break
                    if w in on_stack:
                        low[u] = min(low[u], index[w])
                if recurse:
                    continue
                if low[u] == index[u]:
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        colour[w] = ncol[0]
                        if w == u:
                            break
                    ncol[0] += 1
                if work:
                    p = work[-1][0]
                    low[p] = min(low[p], low[u])

        for e in inner:
            if not hv.alive[e] or not suspicious(e):
                continue
            if colour[int(hv.start_v[e])] != colour[int(hv.end_v[e])]:
                hv.kill(e)
                n_removed += 1

    g2, vs = hv.to_graph()
    if n_removed:
        g2 = _recondense.recondense(g2, vs)
    return g2, vs, n_removed
