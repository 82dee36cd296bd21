"""Pipeline integration of the distributed path: assemble_single_k and
repeat_resolution over an 8-device mesh must match single-device output.

This is the VERDICT-r2 item 2 gate: the sharded construction
(parallel/{kmer_exchange,construction,condense_dist}) and the sharded
read-mapping fan-out (parallel/mapping_dist — the
sequence_mapper_notifier.hpp:66 equivalent) wired into pipeline/assemble
and exercised through the SAME entry points the CLI uses.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from spades_for_blackbird_tpu.pipeline import assemble
from spades_for_blackbird_tpu.utils import simulate
from spades_for_blackbird_tpu.ops import dna

pytestmark = pytest.mark.slow  # full-pipeline run


def _reads(seed=11, genome_len=6000, n_pairs=900, read_len=60,
           insert=180.0):
    genome = simulate.random_genome(genome_len, seed=seed,
                                    repeats=[(200, 2)])
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, n_pairs, read_len=read_len, insert_mean=insert,
        insert_sd=12.0, error_rate=0.0, seed=seed + 1)
    c1, l1 = dna.encode_reads(r1)
    c2, l2 = dna.encode_reads(r2)
    return genome, (c1, l1, c2, l2)


def _canon_contigs(items):
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    return sorted(
        (min(s, s.encode().translate(comp)[::-1].decode()), round(c, 3))
        for s, c in items)


def _single_device(fn):
    os.environ["SFB_FORCE_SINGLE_DEVICE"] = "1"
    try:
        return fn()
    finally:
        del os.environ["SFB_FORCE_SINGLE_DEVICE"]


def test_assemble_single_k_sharded_matches():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    _, (c1, l1, c2, l2) = _reads()
    codes = jnp.concatenate([c1, c2])
    lengths = jnp.concatenate([l1, l2])

    res_dist = assemble.assemble_single_k(codes, lengths, 21)
    res_single = _single_device(
        lambda: assemble.assemble_single_k(codes, lengths, 21))
    assert _canon_contigs(res_dist.contigs) == \
        _canon_contigs(res_single.contigs)


def test_assemble_single_k_sharded_extras_and_cutoff():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    genome, (c1, l1, c2, l2) = _reads(seed=23)
    codes = jnp.concatenate([c1, c2])
    lengths = jnp.concatenate([l1, l2])
    extras = [genome[1000:1500], genome[2000:2300]]

    kw = dict(min_kmer_count=2, extra_sequences=extras)
    res_dist = assemble.assemble_single_k(codes, lengths, 21, **kw)
    res_single = _single_device(
        lambda: assemble.assemble_single_k(codes, lengths, 21, **kw))
    assert _canon_contigs(res_dist.contigs) == \
        _canon_contigs(res_single.contigs)


def test_repeat_resolution_sharded_matches():
    """Sharded mapping + paired fill (mapping_dist) must produce the
    same resolved contigs as the chunked single-device path."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    _, (c1, l1, c2, l2) = _reads(seed=37, genome_len=5000, n_pairs=800)
    codes = jnp.concatenate([c1, c2])
    lengths = jnp.concatenate([l1, l2])

    # same graph in both arms (sharded construction permutes edge ids;
    # RR tie-breaks on ids, so isolate the mapping/fill comparison)
    res = _single_device(
        lambda: assemble.assemble_single_k(codes, lengths, 21))

    def run():
        return assemble.repeat_resolution(res.graph, c1, l1, c2, l2)

    contigs_dist = run()
    contigs_single = _single_device(run)
    assert sorted(s for s, _ in contigs_dist) == \
        sorted(s for s, _ in contigs_single)
