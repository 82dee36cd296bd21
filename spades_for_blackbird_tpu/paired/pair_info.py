"""Paired-info index: (edge1, edge2) -> histogram of (distance, weight).

Device-side replacement of the reference's ``PairedIndex``
(common/paired_info/paired_info.hpp:24-660) and ``LatePairedIndexFiller``
(pair_info_filler.hpp): instead of concurrent hash-map buffers, the whole
unclustered index is one sorted array of (e1, e2, d) observations built by
a single sort + run-length reduction.

Distance convention (matches the reference's left-start to left-start
points, index_point.hpp): an observation from a mate pair says oriented
edge e2's start lies ``d`` bases right of oriented edge e1's start:
d = start1 - start2 + IS_shift, with IS_shift = insert_size - len(r2)
applied by the caller.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..mapping.mapper import ReadMapping
from ..ops import segments


class PairedIndex(NamedTuple):
    """Sorted unique (e1, e2, d) rows with weights (padded ragged).

    ``var`` is the clustered-point distance variance (index_point.hpp:221
    PointT.var): raw/unclustered indices carry None; the distance
    estimators fill it with the weighted spread of the merged
    observations, and downstream lookups widen their distance windows
    by sqrt(var) exactly as the reference widens histogram bounds by
    +-var when merging points (index_point.hpp:244-247).
    """
    e1: jax.Array       # (N,) int32 oriented edge ids
    e2: jax.Array       # (N,) int32
    dist: jax.Array     # (N,) int32
    weight: jax.Array   # (N,) float32
    num: jax.Array      # () int32
    var: jax.Array | None = None  # (N,) float32 clustered variance

    @property
    def capacity(self) -> int:
        return self.e1.shape[0]


_DIST_BIAS = 1 << 24


@jax.jit
def fill_paired_index(m1: ReadMapping, m2rc: ReadMapping,
                      is_shift: jax.Array) -> PairedIndex:
    """Build the unclustered paired index from mapped mate pairs.

    m1: mappings of first mates; m2rc: mappings of reverse-complemented
    second mates (both oriented downstream); is_shift: scalar
    insert_size - read2_len.
    """
    ok = m1.mapped & m2rc.mapped
    e1, e2 = m1.oriented_edge, m2rc.oriented_edge
    d = m1.start - m2rc.start + is_shift.astype(jnp.int32)
    # same-edge pairs carry IS info, not inter-edge info; keep them (d~0
    # self-distance) — the reference stores self-pairs too.
    keys = jnp.stack([
        e1.astype(jnp.uint32), e2.astype(jnp.uint32),
        (d + _DIST_BIAS).astype(jnp.uint32)], axis=1)
    uniq, counts, num = segments.count_sorted(keys, ok)
    return PairedIndex(
        e1=uniq[:, 0].astype(jnp.int32),
        e2=uniq[:, 1].astype(jnp.int32),
        dist=uniq[:, 2].astype(jnp.int32) - _DIST_BIAS,
        weight=counts.astype(jnp.float32),
        num=num,
    )


@jax.jit
def fill_paired_index_multi(m1, m2rc, is_shift: jax.Array) -> PairedIndex:
    """Paired index from CHAIN mappings (mapper.ChainMapping).

    Mirrors the reference's LatePairedIndexFiller over MappingPaths
    (pair_info_filler.hpp: every (edge of path1, edge of path2)
    combination gets a point) plus rnaSPAdes' split-read threading
    (pair_info_count.cpp split-read paths): consecutive placements of
    ONE read are junction-crossing evidence and enter the same index as
    zero-shift pairs.
    """
    R, C = m1.oriented_edge.shape
    ok1 = (m1.oriented_edge >= 0) & m1.mapped[:, None]
    ok2 = (m2rc.oriented_edge >= 0) & m2rc.mapped[:, None]

    rows_e1, rows_e2, rows_d, rows_ok = [], [], [], []

    # cross pairs mate1 x mate2 (C*C per read pair)
    e1x = jnp.broadcast_to(m1.oriented_edge[:, :, None], (R, C, C))
    e2x = jnp.broadcast_to(m2rc.oriented_edge[:, None, :], (R, C, C))
    dx = (m1.start[:, :, None] - m2rc.start[:, None, :]
          + is_shift.astype(jnp.int32))
    okx = ok1[:, :, None] & ok2[:, None, :]
    rows_e1.append(e1x.reshape(-1))
    rows_e2.append(e2x.reshape(-1))
    rows_d.append(dx.reshape(-1))
    rows_ok.append(okx.reshape(-1))

    # split-read chain pairs within each mate (i < j, shift 0)
    for m, ok in ((m1, ok1), (m2rc, ok2)):
        for i in range(C - 1):
            for j in range(i + 1, C):
                rows_e1.append(m.oriented_edge[:, i])
                rows_e2.append(m.oriented_edge[:, j])
                rows_d.append(m.start[:, i] - m.start[:, j])
                rows_ok.append(ok[:, i] & ok[:, j])

    e1 = jnp.concatenate(rows_e1)
    e2 = jnp.concatenate(rows_e2)
    d = jnp.concatenate(rows_d)
    ok = jnp.concatenate(rows_ok)
    keys = jnp.stack([
        e1.astype(jnp.uint32), e2.astype(jnp.uint32),
        (d + _DIST_BIAS).astype(jnp.uint32)], axis=1)
    uniq, counts, num = segments.count_sorted(keys, ok)
    return PairedIndex(
        e1=uniq[:, 0].astype(jnp.int32),
        e2=uniq[:, 1].astype(jnp.int32),
        dist=uniq[:, 2].astype(jnp.int32) - _DIST_BIAS,
        weight=counts.astype(jnp.float32),
        num=num,
    )


def _chain_slice(ch, lo: int, hi: int, chunk: int):
    """Fixed-shape row slice of a ChainMapping (pad tail with unmapped).
    Slicing happens on the device with a traced offset (ops/chunking):
    the chain arrays are (R, P), and this needs neither a host round
    trip nor a compile per offset."""
    from ..ops import chunking
    out = {}
    for name in ("oriented_edge", "start", "votes", "chain_len", "mapped"):
        a = jnp.asarray(getattr(ch, name))
        fill = -1 if name == "oriented_edge" else 0
        a = chunking.pad_rows(a, ((a.shape[0] + chunk - 1) // chunk)
                              * chunk, fill)
        out[name] = chunking.dslice(a, lo, chunk)
    return type(ch)(**out)


@jax.jit
def _merge_raw_pair_tables(a: PairedIndex, b: PairedIndex) -> PairedIndex:
    """Merge two sorted unique raw (e1, e2, d) tables ON DEVICE,
    summing weights of identical rows (counter.merge_tables for paired
    info — a host merge would pull every chunk's columns to the
    host)."""
    keys = jnp.concatenate([
        jnp.stack([a.e1.astype(jnp.uint32), a.e2.astype(jnp.uint32),
                   (a.dist + _DIST_BIAS).astype(jnp.uint32)], axis=1),
        jnp.stack([b.e1.astype(jnp.uint32), b.e2.astype(jnp.uint32),
                   (b.dist + _DIST_BIAS).astype(jnp.uint32)], axis=1)])
    weights = jnp.concatenate([a.weight, b.weight])
    valid = jnp.concatenate([
        jnp.arange(a.e1.shape[0]) < a.num,
        jnp.arange(b.e1.shape[0]) < b.num])
    uniq, wsum, num = segments.count_sorted(keys, valid, weights)
    return PairedIndex(
        e1=uniq[:, 0].astype(jnp.int32),
        e2=uniq[:, 1].astype(jnp.int32),
        dist=uniq[:, 2].astype(jnp.int32) - _DIST_BIAS,
        weight=wsum.astype(jnp.float32),
        num=num,
    )


def _trim_pair_table(idx: PairedIndex) -> PairedIndex:
    """Trim capacity to pow2(num) so accumulator merge shapes bucket."""
    cap = 1 << max(1, int(idx.num) - 1).bit_length()
    cap = min(cap, idx.e1.shape[0])
    return PairedIndex(e1=idx.e1[:cap], e2=idx.e2[:cap],
                       dist=idx.dist[:cap], weight=idx.weight[:cap],
                       num=idx.num,
                       var=idx.var[:cap] if idx.var is not None else None)


def fill_paired_index_multi_chunked(ch1, ch2, is_shift: jax.Array,
                                    chunk: int = 1 << 16) -> PairedIndex:
    """`fill_paired_index_multi` over fixed-size read-pair chunks.

    Each chunk compiles once and bounds the (R*C*C)-row sort; chunk
    results (already unique+counted) merge pairwise ON DEVICE with
    weight summation. This is the out-of-core paired-info path the
    reference gets from its chunked binary readers (pair_info_count.cpp
    processing libraries in streams)."""
    R = ch1.oriented_edge.shape[0]
    if R <= chunk:
        return fill_paired_index_multi(ch1, ch2, is_shift)
    table = None
    for lo in range(0, R, chunk):
        hi = min(lo + chunk, R)
        c1 = _chain_slice(ch1, lo, hi, chunk)
        c2 = _chain_slice(ch2, lo, hi, chunk)
        part = _trim_pair_table(
            fill_paired_index_multi(c1, c2, is_shift))
        table = part if table is None else _trim_pair_table(
            _merge_raw_pair_tables(table, part))
    return table


@jax.jit
def cluster_distances(idx: PairedIndex, max_spread: jax.Array
                      ) -> PairedIndex:
    """Collapse raw observations into per-(e1,e2) distance estimates.

    Simplified analogue of the reference's DistanceEstimator
    (paired_info/distance_estimation.cpp:97 EstimateEdgePairDistances):
    per (e1, e2) group, observations within ``max_spread`` of the weighted
    mode merge into one point at the weighted mean with summed weight;
    observations far from the mode are dropped (contradiction cleaning,
    pair_info_filters.hpp).
    """
    N = idx.capacity
    valid = jnp.arange(N) < idx.num
    # group id per (e1, e2): rows are already sorted by (e1, e2, d)
    keys2 = jnp.stack([idx.e1.astype(jnp.uint32),
                       idx.e2.astype(jnp.uint32)], axis=1)
    seg_start = (~segments.rows_equal_prev(keys2)) & valid
    gid = jnp.cumsum(seg_start.astype(jnp.int32)) - 1
    gid = jnp.where(valid, jnp.maximum(gid, 0), N)
    num_groups = jnp.sum(seg_start.astype(jnp.int32))

    # weighted mode per group
    best_w = jnp.zeros((N,), jnp.float32).at[gid].max(
        jnp.where(valid, idx.weight, 0.0), mode="drop")
    is_mode = valid & (idx.weight == best_w[jnp.minimum(gid, N - 1)])
    mode_d = jnp.full((N,), jnp.int32(1 << 30)).at[
        jnp.where(is_mode, gid, N)].min(idx.dist, mode="drop")

    near = valid & (jnp.abs(idx.dist - mode_d[jnp.minimum(gid, N - 1)])
                    <= max_spread)
    wsum = jnp.zeros((N,), jnp.float32).at[
        jnp.where(near, gid, N)].add(idx.weight, mode="drop")
    dsum = jnp.zeros((N,), jnp.float32).at[
        jnp.where(near, gid, N)].add(
        idx.weight * idx.dist.astype(jnp.float32), mode="drop")
    d2sum = jnp.zeros((N,), jnp.float32).at[
        jnp.where(near, gid, N)].add(
        idx.weight * jnp.square(idx.dist.astype(jnp.float32)),
        mode="drop")
    in_range = jnp.arange(N) < num_groups
    dmean = jnp.where(wsum > 0, dsum / jnp.maximum(wsum, 1e-9), 0.0)
    # clustered-point variance (index_point.hpp:221): weighted spread
    # of the merged observations around the estimated distance
    dvar = jnp.maximum(
        jnp.where(wsum > 0, d2sum / jnp.maximum(wsum, 1e-9), 0.0)
        - jnp.square(dmean), 0.0)

    ge1 = jnp.zeros((N,), jnp.int32).at[
        jnp.where(seg_start, gid, N)].max(idx.e1, mode="drop")
    ge2 = jnp.zeros((N,), jnp.int32).at[
        jnp.where(seg_start, gid, N)].max(idx.e2, mode="drop")
    return PairedIndex(
        e1=jnp.where(in_range, ge1, 0),
        e2=jnp.where(in_range, ge2, 0),
        dist=jnp.where(in_range, jnp.round(dmean).astype(jnp.int32), 0),
        weight=jnp.where(in_range, wsum, 0.0),
        num=num_groups,
        var=jnp.where(in_range, dvar, 0.0),
    )


@jax.jit
def cluster_distances_smoothing(idx: PairedIndex, max_gap: jax.Array,
                                min_weight: jax.Array) -> PairedIndex:
    """Multi-peak distance estimation for wide-insert (mate-pair) data.

    Counterpart of the reference's smoothing estimator
    (paired_info/smoothing_distance_estimation.hpp:19 +
    data_divider.hpp + peak_finder.hpp): within each (e1, e2) group the
    sorted distance observations are divided wherever consecutive
    distances differ by more than ``max_gap`` (DataDivider), and every
    cluster above ``min_weight`` becomes one estimated point at its
    weighted mean (the peak).  Unlike :func:`cluster_distances` this
    keeps several peaks per edge pair — mate-pair histograms are too
    broad and multi-modal for a single mode.
    """
    N = idx.capacity
    valid = jnp.arange(N) < idx.num
    keys2 = jnp.stack([idx.e1.astype(jnp.uint32),
                       idx.e2.astype(jnp.uint32)], axis=1)
    new_group = (~segments.rows_equal_prev(keys2)) & valid
    prev_d = jnp.concatenate([idx.dist[:1], idx.dist[:-1]])
    gap_break = (idx.dist - prev_d) > max_gap
    new_cluster = valid & (new_group | gap_break)
    cid = jnp.cumsum(new_cluster.astype(jnp.int32)) - 1
    cid = jnp.where(valid, jnp.maximum(cid, 0), N)
    num_clusters = jnp.sum(new_cluster.astype(jnp.int32))

    wsum = jnp.zeros((N,), jnp.float32).at[cid].add(
        jnp.where(valid, idx.weight, 0.0), mode="drop")
    dsum = jnp.zeros((N,), jnp.float32).at[cid].add(
        jnp.where(valid, idx.weight * idx.dist.astype(jnp.float32), 0.0),
        mode="drop")
    d2sum = jnp.zeros((N,), jnp.float32).at[cid].add(
        jnp.where(valid,
                  idx.weight * jnp.square(idx.dist.astype(jnp.float32)),
                  0.0), mode="drop")
    ce1 = jnp.zeros((N,), jnp.int32).at[
        jnp.where(new_cluster, cid, N)].max(idx.e1, mode="drop")
    ce2 = jnp.zeros((N,), jnp.int32).at[
        jnp.where(new_cluster, cid, N)].max(idx.e2, mode="drop")
    in_range = (jnp.arange(N) < num_clusters) & (wsum >= min_weight)
    dmean = jnp.where(wsum > 0, dsum / jnp.maximum(wsum, 1e-9), 0.0)
    dvar = jnp.maximum(
        jnp.where(wsum > 0, d2sum / jnp.maximum(wsum, 1e-9), 0.0)
        - jnp.square(dmean), 0.0)

    # compact the surviving clusters to the front (stable order)
    order = jnp.argsort(jnp.where(in_range, jnp.arange(N), N + 1))
    keep_n = jnp.sum(in_range.astype(jnp.int32))
    return PairedIndex(
        e1=jnp.where(jnp.arange(N) < keep_n, ce1[order], 0),
        e2=jnp.where(jnp.arange(N) < keep_n, ce2[order], 0),
        dist=jnp.where(jnp.arange(N) < keep_n,
                       jnp.round(dmean[order]).astype(jnp.int32), 0),
        weight=jnp.where(jnp.arange(N) < keep_n, wsum[order], 0.0),
        num=keep_n,
        var=jnp.where(jnp.arange(N) < keep_n, dvar[order], 0.0),
    )


class _KeySpace:
    """Monotone (e1, e2, d) -> int64 composite keys with data-dependent
    field widths, so edge-id and distance ranges never silently collide
    (meta graphs can exceed 2^20 edges; distances are signed)."""

    def __init__(self, e_max: int, d_min: int, d_max: int):
        self.e_bits = max(int(e_max).bit_length(), 1)
        self.d_off = int(d_min)
        self.d_bits = max(int(d_max - d_min + 1).bit_length(), 1)
        if 2 * self.e_bits + self.d_bits > 62:
            raise ValueError("paired-index key space exceeds 62 bits")

    def key(self, e1, e2, d):
        return (((e1.astype(np.int64) << self.e_bits)
                 | e2.astype(np.int64)) << self.d_bits) \
            | (d.astype(np.int64) - self.d_off)


def _from_arrays(e1, e2, d, w, capacity, var=None):
    n = len(e1)
    cap = max(int(capacity), n)
    E1 = np.zeros(cap, np.int32); E1[:n] = e1
    E2 = np.zeros(cap, np.int32); E2[:n] = e2
    D = np.zeros(cap, np.int32); D[:n] = d
    W = np.zeros(cap, np.float32); W[:n] = w
    V = None
    if var is not None:
        V = np.zeros(cap, np.float32); V[:n] = var
        V = jnp.asarray(V)
    return PairedIndex(e1=jnp.asarray(E1), e2=jnp.asarray(E2),
                       dist=jnp.asarray(D), weight=jnp.asarray(W),
                       num=jnp.int32(n), var=V)


def improve_pair_info(idx: PairedIndex, max_spread: int = 10,
                      weight_coeff: float = 0.5) -> PairedIndex:
    """Aggressive transitive closure: (A,B,d1) + (B,C,d2) implies
    (A,C,d1+d2); missing implied points are added with weight
    ``weight_coeff * min(w1, w2)``, existing nearby points (within
    ``max_spread``) are left alone.

    NOTE: this is NOT the reference improver's FillMissing — that only
    derives points along forced graph paths (see :func:`split_path_fill`,
    which the pipeline uses). Blind transitive joins through a repeat
    edge B fabricate cross-copy links (A -> B(copy1), B(copy2) -> C
    implies a false A -> C) and are only safe on repeat-free graphs.

    Host-side but fully vectorized: the B-join is a sorted-array
    range join (searchsorted + repeat), the near-existing check a
    single searchsorted on the composite (e1,e2,d) key — no Python
    loops, so it survives real-genome-sized clustered indices.
    """
    n = int(idx.num)
    e1 = np.asarray(idx.e1)[:n].astype(np.int64)
    e2 = np.asarray(idx.e2)[:n].astype(np.int64)
    d = np.asarray(idx.dist)[:n].astype(np.int64)
    w = np.asarray(idx.weight)[:n].astype(np.float64)
    if n == 0:
        return idx

    # rows are sorted by (e1, e2, d) already (count_sorted invariant);
    # join i->j on e2[i] == e1[j]
    lo = np.searchsorted(e1, e2, side="left")
    hi = np.searchsorted(e1, e2, side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    if total == 0:
        return idx
    rows_i = np.repeat(np.arange(n), cnt)
    # concatenated ranges lo[i] .. hi[i): offset trick
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    rows_j = (np.arange(total) - np.repeat(starts, cnt)
              + np.repeat(lo, cnt))

    a = e1[rows_i]
    c = e2[rows_j]
    dd = d[rows_i] + d[rows_j]
    ww = weight_coeff * np.minimum(w[rows_i], w[rows_j])
    keep = a != c
    a, c, dd, ww = a[keep], c[keep], dd[keep], ww[keep]
    if len(a) == 0:
        return idx

    # drop candidates with an existing point within max_spread: the
    # first existing row >= (a, c, dd - spread) is within spread iff
    # its composite key <= (a, c, dd + spread)
    ks = _KeySpace(max(int(e1.max()), int(e2.max())),
                   min(int(d.min()), int(dd.min()) - max_spread),
                   max(int(d.max()), int(dd.max()) + max_spread))
    comp_exist = ks.key(e1, e2, d)
    pos = np.searchsorted(comp_exist, ks.key(a, c, dd - max_spread))
    upper = ks.key(a, c, dd + max_spread)
    near = (pos < n) & (comp_exist[np.minimum(pos, n - 1)] <= upper)
    a, c, dd, ww = a[~near], c[~near], dd[~near], ww[~near]
    if len(a) == 0:
        return idx

    # dedup candidates by (a, c, dd), keep max weight
    comp_new = ks.key(a, c, dd)
    order = np.lexsort((-ww, comp_new))
    comp_new, a, c, dd, ww = (comp_new[order], a[order], c[order],
                              dd[order], ww[order])
    first = np.concatenate([[True], comp_new[1:] != comp_new[:-1]])
    a, c, dd, ww = a[first], c[first], dd[first], ww[first]

    E1 = np.concatenate([e1, a])
    E2 = np.concatenate([e2, c])
    D = np.concatenate([d, dd])
    W = np.concatenate([w, ww])
    order = np.argsort(ks.key(E1, E2, D), kind="stable")
    return _from_arrays(E1[order], E2[order], D[order], W[order],
                        idx.capacity)


def split_path_fill(g, idx: PairedIndex, is_mean: float, is_dev: float,
                    max_spread: int = 10,
                    weight_coeff: float = 0.5) -> PairedIndex:
    """Split-path pair-info derivation (the FillMissing half of the
    reference's PairInfoImprover, pair_info_improver.hpp:215 +
    split_path_constructor.hpp:74 ConvertPIToSplitPaths): a point
    (e1, e2, d) implies points (e1, m, d - dist(m..e2)) for every edge
    ``m`` on the common suffix that ALL e1->e2 paths of length ~d must
    traverse. The common suffix is the unique-predecessor chain walked
    back from e2 (bounded by the insert-size path upper bound).

    Host-side over the clustered index (one row per nearby edge pair);
    vectorized dedup/merge via the same machinery as improve_pair_info.
    """
    import numpy as np
    from ..graph.graph import edge_mask

    n = int(idx.num)
    if n == 0:
        return idx
    alive = np.asarray(edge_mask(g))
    start_v = np.asarray(g.start_v)
    end_v = np.asarray(g.end_v)
    seq_len = np.asarray(g.seq_len)
    k = g.k
    len_k = seq_len - k
    in_of: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        in_of.setdefault(int(end_v[e]), []).append(int(e))

    e1 = np.asarray(idx.e1)[:n]
    e2 = np.asarray(idx.e2)[:n]
    d = np.asarray(idx.dist)[:n]
    w = np.asarray(idx.weight)[:n]
    upper = int(is_mean + 2 * max(is_dev, 1.0))  # PairInfoPathLengthUpperBound

    out_of: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        out_of.setdefault(int(start_v[e]), []).append(int(e))

    import heapq
    dij_cache: dict[int, dict[int, int]] = {}

    def reach_from(src_v: int) -> dict[int, int]:
        """Bounded Dijkstra vertex distances from ``src_v`` (the
        reference's CreateBoundedDijkstra run from EdgeEnd(e1))."""
        got = dij_cache.get(src_v)
        if got is not None:
            return got
        best = {src_v: 0}
        q = [(0, src_v)]
        while q:
            dist, v = heapq.heappop(q)
            if dist > best.get(v, 1 << 30):
                continue
            for e in out_of.get(v, []):
                nd = dist + int(len_k[e])
                t = int(end_v[e])
                if nd <= upper and nd < best.get(t, 1 << 30):
                    best[t] = nd
                    heapq.heappush(q, (nd, t))
        dij_cache[src_v] = best
        return best

    add_e1, add_e2, add_d, add_w = [], [], [], []
    for i in range(n):
        a, b, dd, ww = int(e1[i]) // 2, int(e2[i]) // 2, int(d[i]), w[i]
        if dd <= 0 or a == b or dd > upper:
            continue
        # walk back from e2 through the predecessors every a->b path of
        # length ~dd must traverse: candidate predecessors are filtered
        # by reachability from end(e1) (GetCommonPathsEnd semantics)
        reach = reach_from(int(end_v[a]))
        total = 0
        v = int(start_v[b])
        if v not in reach:
            continue
        while True:
            ins = [m for m in in_of.get(v, [])
                   if int(start_v[m]) in reach
                   and reach[int(start_v[m])] + int(len_k[m]) + total
                   <= dd + 2 * int(max(is_dev, 1.0))]
            if len(ins) != 1:
                break
            m = ins[0]
            total += int(len_k[m])
            if total >= dd or m == a:
                break
            add_e1.append(2 * a)
            add_e2.append(2 * m)
            add_d.append(dd - total)
            add_w.append(weight_coeff * ww)
            v = int(start_v[m])
    if not add_e1:
        return idx
    # merge derived points, but never override nearby existing evidence:
    # drop candidates with an existing point within max_spread first
    a = np.asarray(add_e1, np.int64)
    c = np.asarray(add_e2, np.int64)
    dd = np.asarray(add_d, np.int64)
    ww = np.asarray(add_w, np.float64)
    e1a = e1.astype(np.int64)
    e2a = e2.astype(np.int64)
    da = d.astype(np.int64)
    ks = _KeySpace(max(int(e1a.max()), int(e2a.max()), int(a.max()),
                       int(c.max()), 1),
                   min(int(da.min()), int(dd.min()) - max_spread),
                   max(int(da.max()), int(dd.max()) + max_spread))
    comp_exist = ks.key(e1a, e2a, da)
    pos = np.searchsorted(comp_exist, ks.key(a, c, dd - max_spread))
    near = (pos < n) & (comp_exist[np.minimum(pos, n - 1)]
                        <= ks.key(a, c, dd + max_spread))
    a, c, dd, ww = a[~near], c[~near], dd[~near], ww[~near]
    if len(a) == 0:
        return idx
    # dedup derived candidates by (a, c, dd), keep max weight
    comp_new = ks.key(a, c, dd)
    order = np.lexsort((-ww, comp_new))
    comp_new, a, c, dd, ww = (comp_new[order], a[order], c[order],
                              dd[order], ww[order])
    first = np.concatenate([[True], comp_new[1:] != comp_new[:-1]])
    a, c, dd, ww = a[first], c[first], dd[first], ww[first]
    E1 = np.concatenate([e1a, a])
    E2 = np.concatenate([e2a, c])
    D = np.concatenate([da, dd])
    W = np.concatenate([w.astype(np.float64), ww])
    order = np.argsort(ks.key(E1, E2, D), kind="stable")
    return _from_arrays(E1[order], E2[order], D[order], W[order],
                        idx.capacity)


def merge_paired_indices(indices: list[PairedIndex]) -> PairedIndex:
    """Merge clustered indices from multiple libraries into one table,
    summing weights of identical (e1, e2, d) rows (the reference keeps
    ``PairedIndices`` per lib, paired_info.hpp:659; scaffolding joins
    pool evidence across libraries). Vectorized sort + run-length sum."""
    if len(indices) == 1:
        return indices[0]
    parts = [(np.asarray(i.e1)[:int(i.num)], np.asarray(i.e2)[:int(i.num)],
              np.asarray(i.dist)[:int(i.num)],
              np.asarray(i.weight)[:int(i.num)],
              np.asarray(i.var)[:int(i.num)] if i.var is not None
              else np.zeros(int(i.num), np.float32)) for i in indices]
    e1 = np.concatenate([p[0] for p in parts]).astype(np.int64)
    e2 = np.concatenate([p[1] for p in parts]).astype(np.int64)
    d = np.concatenate([p[2] for p in parts]).astype(np.int64)
    w = np.concatenate([p[3] for p in parts]).astype(np.float64)
    v = np.concatenate([p[4] for p in parts]).astype(np.float64)
    cap = max((i.capacity for i in indices), default=1)
    if len(e1) == 0:
        return _from_arrays(e1, e2, d, w, cap, var=v)
    ks = _KeySpace(max(int(e1.max()), int(e2.max()), 1),
                   int(d.min()), int(d.max()))
    comp = ks.key(e1, e2, d)
    order = np.argsort(comp, kind="stable")
    comp, e1, e2 = comp[order], e1[order], e2[order]
    d, w, v = d[order], w[order], v[order]
    first = np.concatenate([[True], comp[1:] != comp[:-1]])
    gid = np.cumsum(first) - 1
    wsum = np.zeros(int(gid[-1]) + 1, np.float64)
    np.add.at(wsum, gid, w)
    # pooled variance of identical-distance points: weight-averaged
    # (the reference widens merged bounds by +-var, index_point.hpp:244)
    vsum = np.zeros(int(gid[-1]) + 1, np.float64)
    np.add.at(vsum, gid, w * v)
    vmerged = vsum / np.maximum(wsum, 1e-9)
    return _from_arrays(e1[first], e2[first], d[first], wsum, cap,
                        var=vmerged)


def weighted_cluster_distances(g, idx: PairedIndex, is_hist: dict,
                               is_mean: float, is_dev: float,
                               max_distance: int | None = None
                               ) -> PairedIndex:
    """Weighted distance estimation with graph-distance snapping.

    The reference's WeightedDistanceEstimator
    (paired_info/weighted_distance_estimation.cpp:8-60) driven the way
    estimate_scaffolding_distance drives its smoothing sibling
    (projects/spades/distance_estimation.cpp:100-135): candidate
    distances between an edge pair are the actual GRAPH path lengths
    (GraphDistanceFinder), each raw observation (d, w) snaps to its
    nearest candidate within ``max_distance``, contributing
    ``w * weight_f(candidate - d)`` where weight_f is the library's
    normalized insert-size distribution (WeightDEWrapper.CountWeight,
    paired_info/pair_info_bounds.hpp).  Pairs with no graph path in
    range keep their plain weighted-mean point (the estimator's
    fallback of emitting the histogram as-is).

    ``idx`` is a RAW (unclustered) index over forward oriented ids.
    Host-side over edge-pair groups; Dijkstra results are cached per
    source vertex like split_path_fill's.
    """
    import heapq
    from ..graph.graph import edge_mask

    n = int(idx.num)
    if n == 0:
        return cluster_distances(idx, jnp.int32(max(5, int(3 * is_dev))))
    if max_distance is None:
        max_distance = max(int(2 * is_dev), 10)

    # normalized IS-shift weight function (WeightDEWrapper): the
    # distribution of (observed distance - expected distance)
    total = float(sum(is_hist.values())) or 1.0
    wf = {int(round(size - is_mean)): cnt / total
          for size, cnt in is_hist.items()}

    def weight_f(delta: int) -> float:
        # nearest-bin lookup with light smearing over +-2
        acc, norm = 0.0, 0
        for o in range(-2, 3):
            acc += wf.get(delta + o, 0.0)
            norm += 1
        return max(acc / norm, 1e-6)

    alive = np.asarray(edge_mask(g))
    start_v = np.asarray(g.start_v)
    end_v = np.asarray(g.end_v)
    len_k = np.asarray(g.seq_len) - g.k
    out_of: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        out_of.setdefault(int(start_v[e]), []).append(int(e))

    e1 = np.asarray(idx.e1)[:n]
    e2 = np.asarray(idx.e2)[:n]
    d = np.asarray(idx.dist)[:n]
    w = np.asarray(idx.weight)[:n]
    upper = int(is_mean + 3 * max(is_dev, 1.0))

    # all path lengths (not just shortest) from a vertex, bounded
    lens_cache: dict[int, dict[int, set]] = {}

    def path_lengths_from(src_v: int) -> dict[int, set]:
        got = lens_cache.get(src_v)
        if got is not None:
            return got
        lens: dict[int, set] = {src_v: {0}}
        q = [(0, src_v)]
        seen = set()
        while q:
            dist, v = heapq.heappop(q)
            if (dist, v) in seen:
                continue
            seen.add((dist, v))
            if len(seen) > 4096:     # state cap for repeat tangles
                break
            for e in out_of.get(v, []):
                nd = dist + int(len_k[e])
                t = int(end_v[e])
                if nd <= upper:
                    s = lens.setdefault(t, set())
                    if nd not in s:
                        s.add(nd)
                        heapq.heappush(q, (nd, t))
        lens_cache[src_v] = lens
        return lens

    # group rows by (e1, e2): rows are sorted already
    E1o, E2o, Do, Wo, Vo = [], [], [], [], []
    i = 0
    while i < n:
        j = i
        while j < n and e1[j] == e1[i] and e2[j] == e2[i]:
            j += 1
        a, b = int(e1[i]) // 2, int(e2[i]) // 2
        ds = d[i:j].astype(np.int64)
        ws = w[i:j].astype(np.float64)
        if a == b:
            forward: list[int] = []
        else:
            lens = path_lengths_from(int(end_v[a]))
            # start-to-start distance = len_k(a) + interior path length
            forward = sorted(int(len_k[a]) + L
                             for L in lens.get(int(start_v[b]), ()))
        minD, maxD = int(ds.min()), int(ds.max())
        forward = [f for f in forward
                   if minD - max_distance <= f <= maxD + max_distance]
        if forward:
            fa = np.asarray(forward, np.int64)
            # nearest candidate per point (EstimateEdgePairDistances'
            # forward-march, distance_estimation.cpp:97-140)
            pos = np.searchsorted(fa, ds)
            left = np.clip(pos - 1, 0, len(fa) - 1)
            right = np.clip(pos, 0, len(fa) - 1)
            pick = np.where(np.abs(fa[right] - ds) < np.abs(ds - fa[left]),
                            right, left)
            snapped = fa[pick]
            ok = np.abs(snapped - ds) <= max_distance
            if ok.any():
                wsnap = ws[ok] * np.asarray(
                    [weight_f(int(dd)) for dd in (snapped - ds)[ok]])
                for f in np.unique(snapped[ok]):
                    sel = snapped[ok] == f
                    wt = float(wsnap[sel].sum())
                    if wt <= 0:
                        continue
                    src_d = ds[ok][sel].astype(np.float64)
                    sw = ws[ok][sel]
                    m = float((src_d * sw).sum() / sw.sum())
                    v = float((sw * (src_d - m) ** 2).sum() / sw.sum())
                    E1o.append(int(e1[i])); E2o.append(int(e2[i]))
                    Do.append(int(f)); Wo.append(wt); Vo.append(v)
                i = j
                continue
        # fallback: plain weighted mean of the group
        m = float((ds * ws).sum() / ws.sum())
        v = float((ws * (ds - m) ** 2).sum() / ws.sum())
        E1o.append(int(e1[i])); E2o.append(int(e2[i]))
        Do.append(int(round(m))); Wo.append(float(ws.sum())); Vo.append(v)
        i = j

    order = np.lexsort((Do, E2o, E1o))
    return _from_arrays(np.asarray(E1o)[order], np.asarray(E2o)[order],
                        np.asarray(Do)[order], np.asarray(Wo)[order],
                        idx.capacity, var=np.asarray(Vo)[order])
