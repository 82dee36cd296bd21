"""CPU checks of chip_smoke.py: its numpy k-mer reference, its device
gate, and its assemble phase at a tiny size. The ``gpu`` test repeats
the k-mer comparison at 2^18 reads of 150 bp and runs only where JAX
sees a GPU:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import collections
import json

import numpy as np
import pytest

import chip_smoke

_COMP = {0: 3, 1: 2, 2: 1, 3: 0}


def _naive_counts(codes, lengths, k):
    """Canonical k-mers as base tuples, counted one window at a time."""
    out = collections.Counter()
    for row, n in zip(codes, lengths):
        for p in range(int(n) - k + 1):
            fwd = tuple(int(b) for b in row[p:p + k])
            if max(fwd) > 3:
                continue
            rc = tuple(_COMP[b] for b in reversed(fwd))
            out[min(fwd, rc)] += 1
    return out


def _unpack(keys, k):
    shifts = np.arange(30, -2, -2, dtype=np.uint32)
    bases = ((keys[:, :, None] >> shifts) & 3).reshape(len(keys), -1)
    return [tuple(int(b) for b in r[:k]) for r in bases]


@pytest.mark.parametrize("k", [22, 34, 56])
def test_numpy_reference_matches_naive_count(k):
    codes, lengths = chip_smoke.simulate_kmer_reads(64, 150, coverage=4.0)
    keys, counts = chip_smoke.numpy_kmer_counts(codes, lengths, k, block=16)
    naive = _naive_counts(codes, lengths, k)
    got = dict(zip(_unpack(keys, k), counts.tolist()))
    assert got == dict(naive)
    assert _unpack(keys, k) == sorted(naive)


@pytest.mark.parametrize("k", [22, 34, 56])
def test_count_kmers_matches_numpy_reference(k):
    codes, lengths = chip_smoke.simulate_kmer_reads(2048, 150)
    info = chip_smoke.count_and_compare(codes, lengths, k, with_memory=True)
    assert info["distinct"] > 0 and info["instances"] >= info["distinct"]
    assert info["memory_analysis"]["argument_size_in_bytes"] > 0


def test_kmers_phase_checks_every_size_in_worker_processes(
        monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "KMER_READS", 512)
    chip_smoke.kmers_phase()
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["k_plus_1"] for l in lines] == list(chip_smoke.KMER_SIZES)
    assert all(l["phase"] == "kmers" and l["exact"] for l in lines)


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu()


def test_main_fails_without_gpu_and_prints_no_result(capsys):
    with pytest.raises(RuntimeError):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_assemble_phase_tiny_genome(tmp_path):
    report = chip_smoke.assemble_phase(
        str(tmp_path / "g20k"), 20_000, ks="21,33",
        clock=chip_smoke.CompileClock(), repeats=[(300, 2)])
    c = report["contigs"]
    assert c["genome_fraction"] >= 0.95, c
    assert c["misassemblies"] == 0, c
    assert c["ng50"] >= 2_000, c
    assert report["scaffolds"]["genome_fraction"] >= 0.95
    assert report["compile_s"] > 0
    assert any(name.startswith("stage:k33")
               for name in report["host_wall_s_by_span"])
    json.dumps(report)


def test_check_bars_rejects_a_misassembly():
    report = {"contigs": {"genome_fraction": 0.99, "ng50": 300_000,
                          "misassemblies": 1}}
    with pytest.raises(AssertionError, match="misassemblies"):
        chip_smoke.check_bars(report)
    report["contigs"]["misassemblies"] = 0
    chip_smoke.check_bars(report)


@pytest.mark.gpu
@pytest.mark.parametrize("k", chip_smoke.KMER_SIZES)
def test_count_kmers_on_gpu(k):
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU")
    codes, lengths = chip_smoke.simulate_kmer_reads(
        1 << 18, chip_smoke.KMER_READ_LEN)
    chip_smoke.count_and_compare(codes, lengths, k)
