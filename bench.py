#!/usr/bin/env python
"""Benchmark: canonical k-mer counting throughput on one GPU.

Times ``counter.count_kmers`` at k=21 on 2^18 reads of 150 bp, for two
inputs: uniform random reads (almost no repeated k-mers) and reads at
~40x coverage of a random genome. Each rate is k-mer instances over the
median of five timed calls, after one call that compiles. Prints one
JSON line naming the device it ran on. Fails where JAX sees no GPU.

Usage:
    python bench.py
"""

import json
import time

INPUTS = ("uniform", "coverage40x")


def rate(iname: str) -> float:
    """k-mer instances per second of count_kmers on one input."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from spades_for_blackbird_tpu.kmers import counter

    k = 21
    R, L = 262144, 150
    rng = np.random.default_rng(0)
    if iname == "uniform":
        codes_np = rng.integers(0, 4, (R, L), dtype=np.uint8)
    else:
        G = R * L // 40
        genome = rng.integers(0, 4, G, dtype=np.uint8)
        starts = rng.integers(0, G - L, R)
        codes_np = genome[starts[:, None] + np.arange(L)[None, :]]
    codes = jax.device_put(codes_np)
    lengths = jax.device_put(np.full((R,), L, dtype=np.int32))

    @jax.jit
    def step(c, l, salt):
        # salt the input so every call is distinct work
        c = (c + salt.astype(jnp.uint8)) % jnp.uint8(4)
        return counter.count_kmers(c, l, k).num

    int(step(codes, lengths, jnp.int32(0)))  # compile
    times = []
    for i in range(5):
        t0 = time.perf_counter()
        int(step(codes, lengths, jnp.int32(i + 1)))
        times.append(time.perf_counter() - t0)
    return R * (L - k + 1) / sorted(times)[len(times) // 2]


def main() -> None:
    import jax
    from spades_for_blackbird_tpu.utils.jaxcache import (
        enable_compilation_cache)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found "
                         f"{devs[0].platform!r}")
    enable_compilation_cache()
    detail = {f"xla_{iname}": rate(iname) for iname in INPUTS}
    print(json.dumps({
        "metric": "kmer_count_throughput",
        "value": max(detail.values()),
        "unit": "kmers/s",
        "detail": detail,
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
    }))


if __name__ == "__main__":
    main()
