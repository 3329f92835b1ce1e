"""Files with a lone CR: where the JAX package reads records in Python
(``kmer-tpu``, ``KmerEngine.distance_file``, the multi-host distances), a
lone CR ends a line; the port's native parser
counts such lines (``ParsedFasta.lone_cr``) and those entries then read
the records of ``utils/fasta.parse_fasta`` (``native.parse_fasta_text``).
The counting entries keep the native reading, as the JAX package's do.

Records, CSV bytes and tables against the JAX package: the tolerance is
zero."""

import json

import numpy as np
import pytest

from dna_kmeres_parallel_tpu import cli as jax_cli
from dna_kmeres_parallel_tpu.models.engine import KmerEngine as JaxEngine
from dna_kmeres_parallel_tpu.parallel import multihost as jax_multihost
from dna_kmeres_parallel_tpu.utils import fasta as jax_fasta
from dna_kmeres_parallel_tpu.utils.config import KmerConfig as JaxConfig
from dna_kmeres_parallel_tpu_torch import KmerConfig, cli, native
from dna_kmeres_parallel_tpu_torch import count_file
from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine
from dna_kmeres_parallel_tpu_torch.parallel import multihost

CR_ONLY = b">x\rACGTACGT\r>y\rACGTTT\r>z\rGGGACGT\r"
#: lone CRs in other places: inside a sequence line, ending a header
#: before LF lines, doubled, a CR-only header line between records
CR_MIXED = (b">a one\rACGTAC\nGTTGCA\rAACC\r\n>b\r\rTTTT\r\nACGA\n"
            b"\r>c\nGATTACA\rGATTACA\n")


@pytest.fixture(autouse=True)
def _no_calibration(monkeypatch, tmp_path):
    monkeypatch.setenv("KMER_GPU_CAL_DIR", str(tmp_path / "no_cal"))
    for name in ("KMER_GPU_CALIBRATION_FILE", "KMER_GPU_DIST_UNION", "KMER_GPU_DIST_THRESHOLD",
                 "KMER_GPU_THRESHOLD_CMAX"):
        monkeypatch.delenv(name, raising=False)


def write(tmp_path, data: bytes, name: str = "cr.fasta") -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("data", [CR_ONLY, CR_MIXED])
def test_text_parse_reads_the_python_records(tmp_path, data):
    path = write(tmp_path, data)
    want = jax_fasta.parse_fasta(path)
    raw = native.parse_fasta_native(path)
    assert raw.lone_cr > 0
    got = native.parse_fasta_text(path)
    assert got.ids == [r.id for r in want]
    assert [got.sequence_codes(i).tobytes() for i in range(got.n_seqs)] == [
        _codes(r.seq) for r in want]
    assert got.total_bases == sum(len(r.seq) for r in want)
    assert got.offsets[-1] == got.stream.size
    # two records at most: max_seqs as parse_fasta takes it
    assert native.parse_fasta_text(path, max_seqs=2).ids == [r.id for r in want[:2]]


def _codes(seq: str) -> bytes:
    lut = np.full(256, 0xFF, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    return lut[np.frombuffer(seq.encode(), np.uint8)].tobytes()


def test_without_a_lone_cr_the_native_parse_stands(tmp_path):
    path = write(tmp_path, b">a\r\nACGT\r\nAC\n>b\nGG\r\r\n")
    raw = native.parse_fasta_native(path)
    assert raw.lone_cr == 0
    got = native.parse_fasta_text(path)
    assert got.ids == raw.ids and np.array_equal(got.stream, raw.stream)


def run(main, argv, capsys):
    rc = main([str(a) for a in argv])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else None


@pytest.mark.parametrize("data", [CR_ONLY, CR_MIXED])
@pytest.mark.parametrize("cmd", [["distance", "--k", 3], ["count", "--k", 3],
                                 ["count", "--k", 21]])
def test_command_lines_write_the_jax_bytes(tmp_path, capsys, data, cmd):
    path = write(tmp_path, data)
    jo, po = tmp_path / "jax.csv", tmp_path / "port.csv"
    jrc, jr = run(jax_cli.main, [*cmd, path, "-o", jo], capsys)
    prc, pr = run(cli.main, [cmd[0], "--device", "cpu", *cmd[1:], path, "-o", po], capsys)
    assert jrc == prc == 0
    assert po.read_bytes() == jo.read_bytes() and po.stat().st_size > 0
    assert pr["n_seqs"] == jr["n_seqs"] == (3 if data == CR_ONLY else len(
        jax_fasta.parse_fasta(path)))


@pytest.mark.parametrize("data", [CR_ONLY, CR_MIXED])
def test_distance_file_reads_the_jax_records(tmp_path, data):
    path = write(tmp_path, data)
    want = JaxEngine(JaxConfig(k=3)).distance_file(path)
    got = KmerEngine(KmerConfig(k=3), device="cpu").distance_file(path)
    assert got.ids == want.ids and got.n == want.n
    assert np.array_equal(got.packed.view(np.uint32), np.asarray(want.packed).view(np.uint32))


@pytest.mark.parametrize("k", [3, 21])
def test_multihost_distances_write_the_jax_bytes(tmp_path, k):
    path = write(tmp_path, CR_ONLY + CR_MIXED)
    jo, po = tmp_path / "jax.csv", tmp_path / "port.csv"
    jax_multihost.distance_file_multihost_resumable(path, JaxConfig(k=k), str(jo), panel_rows=2)
    report = multihost.distance_file_multihost_resumable(path, KmerConfig(k=k), str(po),
                                                         panel_rows=2, device="cpu")
    assert report["all_complete"] and po.read_bytes() == jo.read_bytes()
    assert report["n_pairs"] == len(jax_fasta.parse_fasta(path)) * (
        len(jax_fasta.parse_fasta(path)) - 1) // 2


def test_count_file_keeps_the_native_reading(tmp_path):
    # ">h\nAC\rGT\n": ACGT in Python, ACNGT natively; count_file reads the
    # latter, as the JAX engine's native count does.
    path = write(tmp_path, b">h\nAC\rGT\n")
    parsed = native.parse_fasta_native(path)
    assert parsed.stream.tolist() == [0, 1, 0xFF, 2, 3] and parsed.lone_cr == 1
    hist = count_file(path, k=2, device="cpu").hist
    assert {int(c): int(hist[c]) for c in np.flatnonzero(hist)} == {1: 1, 11: 1}  # AC, GT
    assert [r.seq for r in jax_fasta.parse_fasta(path)] == ["ACGT"]
