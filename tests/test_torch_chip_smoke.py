"""``chip_smoke.py``'s own parts, on the CPU: the seeded records, their
FASTA, the plain reference table the counting path is held against on
the card, and rehearsals of the dense counting path, the streaming path,
the distance path, the bucketed path and the device-sort path at a small
size (the kernels' plain versions standing in for the kernels, counted as
they would be). Exact integers and float32 bits: the tolerance is zero."""

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


@pytest.mark.parametrize("k,canonical,bins", [(3, False, None), (8, True, None), (6, False, 3000)])
def test_reference_hist_matches_oracle(records, k, canonical, bins):
    stream, starts, _ = records
    n = 20_000
    small = np.concatenate(
        [stream[starts[0] : starts[0] + n], [chip_smoke.INVALID],
         stream[starts[1] : starts[1] + n]]
    ).astype(np.uint8)
    hist = chip_smoke.reference_hist(small, k, canonical, CPU, bins)
    seqs = record_strings(small, [0, n + 1], [n, n])
    want = sum(oracle.count_vector(s, k, canonical).astype(np.int64) for s in seqs)
    assert hist.dtype == np.int64 and np.array_equal(hist, want[: bins or 4**k])


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


@pytest.fixture
def counted_plain_versions(monkeypatch):
    """Route the distance path's kernel wrappers to their plain versions
    on the CPU, each adding to its kernel's launch count as the kernel
    would."""
    from dna_kmeres_parallel_tpu_torch.ops import distance, distance_cuda, histogram_cuda

    plain_counts = histogram_cuda.counts_matrix_reference
    tri, rect = distance_cuda.min_sum_matrix_tri, distance_cuda.min_sum_matrix_rect

    def counts(*a, **kw):
        histogram_cuda.COUNTS_LAUNCHES += 1
        return plain_counts(*a, **kw)

    def counted_tri(c):
        distance_cuda.TRI_LAUNCHES += 1
        return tri(c)

    def counted_rect(a, b):
        distance_cuda.RECT_LAUNCHES += 1
        return rect(a, b)

    monkeypatch.setattr(histogram_cuda, "counts_matrix_reference", counts)
    monkeypatch.setattr(distance_cuda, "min_sum_matrix_tri", counted_tri)
    monkeypatch.setattr(distance_cuda, "min_sum_matrix_rect", counted_rect)
    monkeypatch.setattr(distance_cuda, "min_sum_tri_cuda", distance.min_sum_matrix)
    monkeypatch.setattr(distance_cuda, "min_sum_rect_cuda", distance.min_sum_matrix)


def test_distance_records_layout():
    stream, starts, lengths = chip_smoke.distance_records(50)
    assert np.all((lengths >= 1000) & (lengths <= 2000))
    assert stream.size == lengths.sum() + 49
    assert np.all(stream[starts[1:] - 1] == chip_smoke.INVALID)


def test_reference_counts_and_distances_match_oracle():
    records = chip_smoke.distance_records(12)
    seqs = chip_smoke.record_strings(*records)
    for k, canonical in ((3, False), (5, True)):
        counts = chip_smoke.reference_counts(*records, k, canonical, CPU).numpy()
        for s, row in zip(seqs, counts):
            assert np.array_equal(row, oracle.count_vector(s, k, canonical))
    for k in (3, 8):  # the broadcast route and the threshold-product route
        counts = chip_smoke.reference_counts(*records, k, False, CPU)
        sums = chip_smoke.reference_min_sums(counts, counts).numpy()
        packed = chip_smoke.reference_packed(sums, records[2], records[2], k)
        assert chip_smoke.same_bits(packed, oracle.distance_matrix_packed(seqs, k))


def test_check_csv_catches_a_wrong_line(tmp_path):
    want = np.array([0.25, 0.5, 1.0 / 3.0], np.float32)
    path = tmp_path / "d.csv"
    path.write_bytes(b"0.250000\n0.500000\n0.333333\n")
    assert chip_smoke.check_csv(path, want) == 3
    path.write_bytes(b"0.250000\n0.500001\n0.333333\n")
    with pytest.raises(AssertionError, match="line 1"):
        chip_smoke.check_csv(path, want)


def test_distance_path_rehearsal(tmp_path, monkeypatch, counted_plain_versions):
    # 70 records with the path's row counts cut to fit: (a) 40, (b) 20
    # records, (c) panels of 16 rows.
    monkeypatch.setattr(chip_smoke, "DIST_ROWS_A", 40)
    monkeypatch.setattr(chip_smoke, "DIST_ROWS_B", 20)
    monkeypatch.setattr(chip_smoke, "PANEL_ROWS", 16)
    records = chip_smoke.distance_records(70)
    path = tmp_path / "dist.fasta"
    chip_smoke.write_fasta(path, *records)
    launches = chip_smoke.phase_distance_path(records, path, CPU, "cpu")
    assert [key[:3] for key in launches] == ["(a)", "(b)", "(c)"]
    assert {n: c for n, c in launches["(c)"].items() if c} == {"counts_matrix": 1, "min_sum_rect": 1}
    assert not (tmp_path / "dist.csv").exists()


@pytest.fixture
def counted_dense_plain_versions(monkeypatch):
    """Route the dense path's kernel entries to their plain versions on the
    CPU, each adding to the launch count of the kernel the card would run
    (``u8_route`` for a u8 stream; K1 for the planes' encode, K9 for the
    u8 stream's)."""
    from dna_kmeres_parallel_tpu_torch.ops import encode_cuda, histogram_cuda

    counters = {"small": "SMALL_LAUNCHES", "u8": "U8_LAUNCHES", "any": "ANY_LAUNCHES"}
    plain_encode = encode_cuda.encode_packed_reference

    def planes(*a, **kw):
        histogram_cuda.PLANES_LAUNCHES += 1
        return histogram_cuda.hist_planes_reference(*a, **kw)

    def stream(bases, n_own, k, bins, canonical=False, acc=None):
        name = counters[histogram_cuda.u8_route(bins)]
        setattr(histogram_cuda, name, getattr(histogram_cuda, name) + 1)
        return histogram_cuda.hist_u8_reference(bases, n_own, k, bins, canonical, acc)

    def encode(*a, **kw):
        encode_cuda.LAUNCHES += 1
        return plain_encode(*a, **kw)

    plain_stream_encode = encode_cuda.encode_stream_reference

    def stream_encode(*a, **kw):
        encode_cuda.STREAM_LAUNCHES += 1
        return plain_stream_encode(*a, **kw)

    monkeypatch.setattr(histogram_cuda, "histogram_planes", planes)
    monkeypatch.setattr(histogram_cuda, "histogram_stream", stream)
    monkeypatch.setattr(encode_cuda, "encode_packed_reference", encode)
    monkeypatch.setattr(encode_cuda, "encode_stream_reference", stream_encode)


def test_dense_path_rehearsal(records, tmp_path, counted_dense_plain_versions):
    # The main path's two records (about 500 kbase: one batch per run).
    path = tmp_path / "smoke.fasta"
    chip_smoke.write_fasta(path, *records)
    launches = chip_smoke.phase_dense_path(records, path, CPU, "cpu")
    names = [run[0] for run in chip_smoke.DENSE_RUNS] + [chip_smoke.ANY_RUN[0]]
    assert list(launches) == names
    for (name, *_, kernel) in chip_smoke.DENSE_RUNS:
        assert {n: c for n, c in launches[name].items() if c} == {kernel: 1}, name
    assert {n: c for n, c in launches[chip_smoke.ANY_RUN[0]].items() if c} == {"hist_u8_any": 1}
    assert set(chip_smoke.DENSE_MAIN.values()) <= set(launches)


def test_stream_path_rehearsal(records, tmp_path, monkeypatch, counted_dense_plain_versions):
    # The main path's two records in 32 kbase batches (16 per run), a
    # checkpoint every two batches; the killed child runs on the CPU too.
    monkeypatch.setattr(chip_smoke, "STREAM_BATCH_BASES", 1 << 15)
    monkeypatch.setattr(chip_smoke, "STREAM_CKPT_BASES", 1 << 16)
    path = tmp_path / "smoke.fasta"
    chip_smoke.write_fasta(path, *records)
    refs: dict = {}
    launches = chip_smoke.phase_stream_path(records, path, CPU, "cpu", refs)
    n = -(-records[0].size // (1 << 15))
    assert n >= 8 and len(launches) == 8
    fired = {name: {k: c for k, c in got.items() if c} for name, got in launches.items()}
    assert fired[chip_smoke.STREAM_MAIN] == {"encode_stream": n}
    assert fired["StreamingCounter(k=21, compact=device)"] == {"encode_packed": n}
    assert fired["StreamingCounter(k=21, compact=host)"] == {}
    assert fired["count_file(k=21, pack_input=False)"] == {"encode_stream": n}
    # One reference per (kind, k, canonical): the k=11 histogram is the
    # densified k=11 table.
    assert set(refs) == {("table", 21, False), ("table", 11, True), ("hist", 8, False)}
    assert not list(tmp_path.glob("*.npz*"))


@pytest.fixture
def counted_bucket_plain_versions(monkeypatch):
    """Route the bucketed path's kernels to their plain versions on the
    CPU, each adding to the launch count of the kernel the card would run:
    K1, or K1m with a minimizer plane, for the planes' encode; K10; P1."""
    from dna_kmeres_parallel_tpu_torch.ops import encode_cuda, sort_cuda

    plain_encode = encode_cuda.encode_packed_reference
    plain_segments = sort_cuda.owner_segments_reference
    plain_roll = sort_cuda.row_roll_reference

    def encode(*a, **kw):
        if (a[5] if len(a) > 5 else kw.get("minimizer_m")) is None:
            encode_cuda.LAUNCHES += 1
        else:
            encode_cuda.MIN_LAUNCHES += 1
        return plain_encode(*a, **kw)

    def segments(*a, **kw):
        sort_cuda.OWNER_LAUNCHES += 1
        return plain_segments(*a, **kw)

    def roll(*a, **kw):
        sort_cuda.ROLL_LAUNCHES += 1
        return plain_roll(*a, **kw)

    monkeypatch.setattr(encode_cuda, "encode_packed_reference", encode)
    monkeypatch.setattr(sort_cuda, "owner_segments_reference", segments)
    monkeypatch.setattr(sort_cuda, "row_roll_reference", roll)
    monkeypatch.setattr(sort_cuda, "_PROBED", set())


def test_bucket_path_rehearsal(records, tmp_path, monkeypatch, counted_bucket_plain_versions):
    # The main path's two records (about 500 kbase) for config 5 and its
    # variants; the smaller runs on their first 64 kbase; a 1-rank gloo
    # process group in place of NCCL.
    monkeypatch.setattr(chip_smoke, "BUCKET_SMALL_BASES", 1 << 16)
    path = tmp_path / "smoke.fasta"
    chip_smoke.write_fasta(path, *records)
    refs: dict = {}
    launches = chip_smoke.phase_bucket_path(records, path, CPU, "cpu", refs)
    fired = {name: {k: c for k, c in got.items() if c} for name, got in launches.items()}
    D = chip_smoke.BUCKET_D
    names = list(fired)
    assert len(names) == 10 and names[0] == chip_smoke.BUCKET_MAIN
    assert fired[names[0]] == {"encode_packed_minimizer": D, "owner_segments": D, "row_roll": 1}
    assert fired[names[1]] == {"encode_packed_minimizer": D, "owner_segments": D}
    assert fired[names[2]] == {"encode_packed": D, "owner_segments": D}
    assert fired[names[3]] == fired[names[4]] == {"encode_packed_minimizer": D}
    assert fired[names[5]] == {} and "super" in names[5]
    assert fired[names[7]] == {"encode_packed_minimizer": 5, "owner_segments": 5}
    assert fired[names[8]] == {"encode_packed_minimizer": 3 * D, "owner_segments": D}
    assert fired[names[9]] == {"encode_packed_minimizer": 1, "owner_segments": 1}
    assert set(refs) == {("table", 31, False), ("table", 31, True), ("small", 31, False),
                         ("small", 21, False), ("skew", 31, False)}


def test_sort_rows_input_layout():
    x = chip_smoke.sort_rows_input(9, 128, 1, CPU)
    assert x.dtype == torch.int32 and x.shape == (9, 128)
    assert x[0, :4].tolist() == [0, -1, 2**31 - 1, -(2**31)]
    assert (x[4] == -1).all() and (x[3, -42:] == -1).all()
    assert (x < 0).any() and (x > 0).any()


def test_dup_records_repeat_the_first_records(records):
    stream, starts, lengths = chip_smoke.dup_records(records, 1000, 3)
    assert lengths.size == 3 and stream.size == 3 * lengths[0] + 2
    first = records[0][: records[2][0]]
    for s in starts:
        assert np.array_equal(stream[s : s + lengths[0]], first)
    assert np.all(stream[starts[1:] - 1] == chip_smoke.INVALID)


@pytest.fixture
def counted_sort_plain_versions(monkeypatch):
    """Route the device-sort path's kernels to their plain versions on the
    CPU, each adding to the launch count of the kernel the card would run:
    K1 for the planes' encode, K11 for the row sort."""
    from dna_kmeres_parallel_tpu_torch.ops import encode_cuda, sort_cuda

    plain_encode = encode_cuda.encode_packed_reference
    plain_sort = sort_cuda.row_sort_u32_reference

    def encode(*a, **kw):
        encode_cuda.LAUNCHES += 1
        return plain_encode(*a, **kw)

    def row_sort(x):
        sort_cuda.ROW_SORT_LAUNCHES += 1
        return plain_sort(x)

    monkeypatch.setattr(encode_cuda, "encode_packed_reference", encode)
    monkeypatch.setattr(sort_cuda, "row_sort_u32_reference", row_sort)


def test_sort_path_rehearsal(records, tmp_path, monkeypatch, counted_sort_plain_versions):
    # The main path's two records (about 500 kbase) in 64 kbase batches;
    # the duplicated inputs are the first record three times and twice.
    monkeypatch.setattr(chip_smoke, "SORT_BATCH_BASES", 1 << 16)
    monkeypatch.setattr(chip_smoke, "SORT_DUPS", ((1 << 16, 3), (1, 2)))
    monkeypatch.setattr(chip_smoke, "SORT_SMALL_BASES", 1 << 16)
    path = tmp_path / "smoke.fasta"
    chip_smoke.write_fasta(path, *records)
    refs: dict = {}
    launches = chip_smoke.phase_sort_path(records, path, CPU, "cpu", refs)
    fired = {name: {k: c for k, c in got.items() if c} for name, got in launches.items()}
    n = -(-records[0].size // (1 << 16))
    names = list(fired)
    assert len(names) == 10 and names[5] == chip_smoke.SORT_MAIN
    assert fired[chip_smoke.SORT_MAIN] == {"encode_packed": n, "row_sort": n}
    for name in names[:5]:
        assert fired[name] == {"encode_packed": n}, name
    assert fired[names[6]] == {"encode_packed": n}
    for name, copies in zip(names[7:9], (3, 2)):
        dup_batches = -(-(copies * (int(records[2][0]) + 1) - 1) // (1 << 16))
        assert fired[name] == {"encode_packed": dup_batches}, name
    assert fired[names[9]] == {"encode_packed": 1}
    assert set(refs) == {("table", 21, False), ("table", 11, True), ("dup", 1 << 16, 3),
                         ("dup", 1, 2), ("small", 13, False)}
    assert not (tmp_path / "dup.fasta").exists()
