"""Side-by-side against ACTUAL reference-SPAdes output.

The reference (SPAdes 3.15.4, /root/reference) was built from source in
this image and run on its own bundled toy dataset
(assembler/test_dataset/ecoli_1K_{1,2}.fq.gz, truth reference_1K.fa.gz)
through the full pipeline (BayesHammer + K21,33,55 + repeat resolution);
its contigs/scaffolds are committed under
tests/goldens/reference_spades_1k/ (see PROVENANCE.txt).

These tests assert this assembler MATCHES OR BEATS the stored
reference output on the same reads by the assessment metrics that
matter (genome fraction, largest contig, misassembly-free placement) —
the "matching-or-beating" criterion of BASELINE.md made executable.
For the record: the reference emits 3 contigs (622 + 433 + 58 bp) on
this dataset; this pipeline reconstructs the full 1000 bp fragment
as a single contig.
"""

import gzip
import os

import pytest

pytestmark = pytest.mark.slow  # full-pipeline run

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens",
                          "reference_spades_1k")
TEST_DATASET = "/root/reference/assembler/test_dataset"


def read_fasta(path):
    seqs, cur = [], []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                cur = []
            else:
                cur.append(line.strip())
    if cur:
        seqs.append("".join(cur))
    return seqs


def rc(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def genome_fraction(contigs, truth, min_len=56):
    """Fraction of truth covered by exact contig placements."""
    covered = [False] * len(truth)
    doubled = truth + truth  # tolerate boundary-wrapping placements
    for s in contigs:
        if len(s) < min_len:
            continue
        for cand in (s, rc(s)):
            pos = doubled.find(cand)
            if pos >= 0:
                for i in range(pos, min(pos + len(cand), len(truth))):
                    covered[i] = True
                break
    return sum(covered) / len(truth)


@pytest.fixture(scope="module")
def truth():
    return read_fasta(os.path.join(TEST_DATASET, "reference_1K.fa.gz"))[0]


@pytest.fixture(scope="module")
def our_contigs(tmp_path_factory):
    from spades_for_blackbird_tpu import cli
    out = tmp_path_factory.mktemp("vs_ref")
    code = cli.main([
        "-1", os.path.join(TEST_DATASET, "ecoli_1K_1.fq.gz"),
        "-2", os.path.join(TEST_DATASET, "ecoli_1K_2.fq.gz"),
        "-o", str(out)])
    assert code == 0
    return read_fasta(str(out / "contigs.fasta"))


def test_reference_goldens_present(truth):
    ref = read_fasta(os.path.join(GOLDEN_DIR, "contigs.fasta"))
    assert ref, "reference golden contigs missing"
    assert len(truth) == 1000


def test_matches_or_beats_reference_contigs(our_contigs, truth):
    ref = read_fasta(os.path.join(GOLDEN_DIR, "contigs.fasta"))
    ref_gf = genome_fraction(ref, truth)
    our_gf = genome_fraction(our_contigs, truth)
    assert our_gf >= ref_gf - 1e-9, \
        f"genome fraction {our_gf:.4f} < reference {ref_gf:.4f}"
    assert max(map(len, our_contigs)) >= max(map(len, ref)), \
        "largest contig shorter than the reference's"
    # every contig we emit places exactly on the truth (0 misassemblies)
    doubled = truth + truth
    for s in our_contigs:
        assert s in doubled or rc(s) in doubled, \
            f"contig of length {len(s)} does not place on the truth"


def test_beats_reference_contiguity(our_contigs, truth):
    """The reference leaves the 1 kb fragment in 3 pieces; this
    pipeline reconstructs it whole — strictly better contiguity."""
    assert max(map(len, our_contigs)) >= 1000 - 2  # full fragment
