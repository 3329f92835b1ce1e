"""``chip_smoke.py``'s own parts, on the CPU: the seeded records, their
FASTA, and the plain reference table the main path is held against on
the card. Exact integer tables: the tolerance is zero."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dna_kmeres_parallel_tpu_torch as port
from dna_kmeres_parallel_tpu.models import oracle
from dna_kmeres_parallel_tpu.utils import codec

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def records():
    # Two records of 200-300 kbase, so one separator is crossed.
    return chip_smoke.smoke_records(400_000)


def record_strings(stream, starts, lengths) -> list[str]:
    letters = np.frombuffer(b"ACGTN", np.uint8)
    return [
        letters[np.minimum(stream[s : s + n], 4)].tobytes().decode()
        for s, n in zip(starts, lengths)
    ]


def test_records_layout(records):
    stream, starts, lengths = records
    assert lengths.size == 2 and np.all((lengths >= 200_000) & (lengths <= 300_000))
    assert stream.size == lengths.sum() + lengths.size - 1
    assert stream[starts[1] - 1] == chip_smoke.INVALID
    assert 0 < int((stream == chip_smoke.INVALID).sum()) < stream.size // 100


@pytest.mark.parametrize("k,canonical", [(21, False), (21, True), (11, True)])
def test_reference_table_matches_oracle(records, k, canonical):
    # The first 20 kbase of each record, joined by one separator: the
    # pure-Python oracle is slow.
    stream, starts, _ = records
    n = 20_000
    small = np.concatenate(
        [stream[starts[0] : starts[0] + n], [chip_smoke.INVALID],
         stream[starts[1] : starts[1] + n]]
    ).astype(np.uint8)
    codes, counts = chip_smoke.reference_table(small, k, canonical, CPU)
    want = oracle.count_table_any_k(
        record_strings(small, [0, n + 1], [n, n]), k, canonical
    )
    assert codes.dtype == np.uint64 and counts.dtype == np.int64
    assert np.all(codes[1:] > codes[:-1])
    got = {codec.code_to_kmer(int(c), k): int(m) for c, m in zip(codes, counts)}
    assert got == want


def test_fasta_counts_through_port_equal_reference(records, tmp_path):
    path = tmp_path / "smoke.fasta"
    chip_smoke.write_fasta(path, *records)
    assert max(len(l) for l in path.read_bytes().splitlines()) == 80
    res = port.count_file(str(path), k=21, device="cpu")
    codes, counts = chip_smoke.reference_table(records[0], 21, False, CPU)
    assert res.n_seqs == 2 and res.total_bases == int(records[2].sum())
    assert np.array_equal(res.codes, codes) and np.array_equal(res.counts, counts)


def test_script_imports_only_the_port():
    text = (REPO / "chip_smoke.py").read_text()
    imports = re.findall(r"^\s*(?:import|from)\s+(\S+)", text, re.M)
    assert imports, "no imports found"
    for name in imports:
        assert not name.startswith("jax"), name
        assert not re.match(r"dna_kmeres_parallel_tpu(\.|$)", name), name
