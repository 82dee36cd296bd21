"""End-to-end single-K assembly of the bundled toy E. coli 1K dataset.

The equivalent of ``spades.py --test`` (reference
assembler/test_dataset/, wiring at spades_pipeline/options_parser.py:1007):
assembling at K=33 must reproduce the 1000 bp reference fragment exactly
(single contig, up to strand).
"""

import os

import pytest

DATASET = "/root/reference/assembler/test_dataset"

pytestmark = [pytest.mark.slow, pytest.mark.skipif(
    not os.path.isdir(DATASET), reason="toy dataset unavailable")]


def test_assemble_ecoli_1k_k33_exact():
    from spades_for_blackbird_tpu.io import fastq
    from spades_for_blackbird_tpu.pipeline import assemble

    b1, b2 = fastq.load_paired_reads(
        f"{DATASET}/ecoli_1K_1.fq.gz", f"{DATASET}/ecoli_1K_2.fq.gz")
    batch = fastq.concat_batches([b1, b2])
    res = assemble.assemble_single_k(batch.codes, batch.lengths, 33)

    _, seqs = fastq.read_sequences(f"{DATASET}/reference_1K.fa.gz")
    ref = seqs[0]
    import naive_debruijn as nd
    assert len(res.contigs) == 1
    top = res.contigs[0][0]
    assert top in (ref, nd.rc(ref))


def test_assemble_ecoli_1k_k55_break_is_real():
    """At K=55 the reads have zero coverage of genomic 56-mers around
    positions 838-862, so the assembly must break into exactly two
    reference-consistent contigs (multi-K / repeat resolution closes this
    in the full pipeline)."""
    from spades_for_blackbird_tpu.io import fastq
    from spades_for_blackbird_tpu.pipeline import assemble
    import naive_debruijn as nd

    b1, b2 = fastq.load_paired_reads(
        f"{DATASET}/ecoli_1K_1.fq.gz", f"{DATASET}/ecoli_1K_2.fq.gz")
    batch = fastq.concat_batches([b1, b2])
    res = assemble.assemble_single_k(batch.codes, batch.lengths, 55)

    _, seqs = fastq.read_sequences(f"{DATASET}/reference_1K.fa.gz")
    ref = seqs[0]
    both = ref + "#" + nd.rc(ref)
    assert 1 <= len(res.contigs) <= 3
    for s, _ in res.contigs:
        assert s in both or nd.rc(s) in both
