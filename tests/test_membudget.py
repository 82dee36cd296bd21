"""--memory budget (utils/memory_limit.hpp:14 equivalent): the budget
sizes streaming chunk shapes instead of setrlimit (which would kill a
JAX GPU client that reserves large virtual mappings)."""

import numpy as np

from spades_for_blackbird_tpu.utils import membudget


def teardown_function(_):
    membudget.set_budget_gb(None)


def test_defaults_without_budget():
    membudget.set_budget_gb(None)
    assert membudget.count_chunk_reads(1 << 20) == 1 << 20
    assert membudget.stats_chunk_reads(1 << 15) == 1 << 15
    assert membudget.device_cap_rows(1 << 24) == 1 << 24


def test_budget_shrinks_chunks_monotonically():
    sizes = []
    for gb in (64, 8, 1):
        membudget.set_budget_gb(gb)
        sizes.append((membudget.count_chunk_reads(1 << 22),
                      membudget.stats_chunk_reads(1 << 18),
                      membudget.device_cap_rows(1 << 28)))
    for a, b in zip(sizes, sizes[1:]):
        assert all(x >= y for x, y in zip(a, b))
    # all pow2, all within floor/ceiling
    for row in sizes:
        for v in row:
            assert v & (v - 1) == 0 and v >= 1 << 10


def test_budget_flows_into_chunked_counting():
    """A 1 GB budget must pick a smaller counting chunk than default,
    and results must not change."""
    import jax.numpy as jnp
    from spades_for_blackbird_tpu.kmers import counter
    from spades_for_blackbird_tpu.ops import dna

    rng = np.random.default_rng(2)
    reads = ["".join(rng.choice(list("ACGT"), size=60))
             for _ in range(300)]
    codes, lengths = dna.encode_reads(reads)
    ref = counter.count_kmers(jnp.asarray(codes), jnp.asarray(lengths),
                              21)
    membudget.set_budget_gb(0.001)  # absurdly small -> floor chunk
    got = counter.count_kmers_chunked(codes, lengths, 21)
    n = int(ref.num)
    assert int(got.num) == n
    np.testing.assert_array_equal(np.asarray(ref.kmers[:n]),
                                  np.asarray(got.kmers[:n]))
    np.testing.assert_array_equal(np.asarray(ref.counts[:n]),
                                  np.asarray(got.counts[:n]))
