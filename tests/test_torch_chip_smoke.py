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


def test_shard_shape_of_the_records(records):
    # K1 and K1m are timed at one config-5 shard before the records are
    # made: the shard's bases follow from the record lengths alone.
    stream = records[0]
    shard = chip_smoke.smoke_shard_bases(400_000)
    assert shard == -(-stream.size // chip_smoke.BUCKET_D)
    T = chip_smoke.shard_windows(shard)
    assert T % 16 == 0 and shard + chip_smoke.BUCKET_K - 1 <= T < shard + chip_smoke.BUCKET_K + 15


def test_min_cases_reach_every_window_length():
    # K1m's check runs every ladder depth and combine offset: each window
    # length L = k - m + 1 from 2 to 31, at every hi width, and one-base
    # streams where every m-mer ties.
    cases = chip_smoke.MIN_CASES
    assert all(1 <= m < min(k, 16) <= k <= 31 for k, m in cases)
    assert {k - m + 1 for k, m in cases} == set(range(2, 32))
    assert {(k > 15) + (k > 23) for k, _ in cases} == {0, 1, 2}
    assert {b for b, _, _ in chip_smoke.MIN_ONE_BASE} == {0, 1, 2, 3}
    assert all(1 <= m < min(k, 16) for _, k, m in chip_smoke.MIN_ONE_BASE)


def test_max_abs_err_skips_a_plane_absent_from_both():
    lo = torch.tensor([1, -1, 5], dtype=torch.int32)
    assert chip_smoke.max_abs_err((None, lo), (None, lo + 2)) == 2
    with pytest.raises(AssertionError, match="absent"):
        chip_smoke.max_abs_err((None, lo), (lo, lo))
    with pytest.raises(AssertionError, match="int16"):
        chip_smoke.max_abs_err((lo,), (lo.to(torch.int16),))


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
    finish = distance_cuda.finish_upper_packed

    def counts(grid, k, bins, canonical=False):
        histogram_cuda.COUNTS_LAUNCHES += 1
        histogram_cuda.COUNTS_GLOBAL_LAUNCHES += int(bins > histogram_cuda.MAX_BINS)
        return plain_counts(grid, k, bins, canonical)

    def counted_tri(c):
        distance_cuda.TRI_LAUNCHES += 1
        return tri(c)

    def counted_rect(a, b):
        distance_cuda.RECT_LAUNCHES += 1
        return rect(a, b)

    def counted_finish(*args):
        out = finish(*args)
        distance_cuda.FINISH_LAUNCHES += int(out.numel() > 0)
        return out

    monkeypatch.setattr(histogram_cuda, "counts_matrix_reference", counts)
    monkeypatch.setattr(distance_cuda, "min_sum_matrix_tri", counted_tri)
    monkeypatch.setattr(distance_cuda, "min_sum_matrix_rect", counted_rect)
    monkeypatch.setattr(distance_cuda, "finish_upper_packed", counted_finish)
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


def test_panel_shapes_of_the_reference_workload():
    # 54,018 records in panels of 2,048 rows: rows 0..54,016 have partners.
    panels = chip_smoke.panel_shapes(54_018, 2048)
    assert len(panels) == 27
    assert panels[0] == (0, 2048) and panels[-1] == (53_248, 54_017)
    assert panels[-1][1] - panels[-1][0] == 769
    assert sum(54_018 - r0 for r0, _ in panels) == 739_638
    assert chip_smoke.panel_shapes(70, 16)[-1] == (64, 69)
    assert chip_smoke.panel_shapes(1, 16) == []


@pytest.mark.parametrize("B", chip_smoke.ROUTE_BINS)
@pytest.mark.parametrize("rows", chip_smoke.ROUTE_ROWS)
def test_route_counts_meet_their_route(rows, B):
    from dna_kmeres_parallel_tpu_torch.ops import distance_cuda

    def bound(kind):
        c = chip_smoke.route_counts(rows, B, kind, rows + B)
        assert c.dtype == np.int32 and c.shape == (rows, B) and c.min() >= 0
        return c, distance_cuda.check_counts(torch.from_numpy(c))[0]

    small, top = bound("small")
    assert top == 65535 and small[0].sum() == 65535
    wide, top = bound("wide")
    assert top == 65536 and wide[0].sum() == 65536
    big, top = bound("big")
    assert (big.max(1) >= 1 << 16).all() and top < 1 << 31
    for ka, kc, route in chip_smoke.ROUTE_KINDS:
        a = {"small": small, "wide": wide, "big": big}[ka]
        c = {"small": small, "wide": wide, "big": big}[kc]
        bounds = distance_cuda.check_counts(torch.from_numpy(a), torch.from_numpy(c))
        assert distance_cuda.product_route(*bounds) == route


def test_min_sum_bound_counts_pairs_and_bytes():
    # K4's first panel and K3 at (a)'s 16,384 records, as PR 6 reported.
    rect = chip_smoke.min_sum_bound([(2048, 54_018)], 64)
    assert rect[1] == "operations"
    assert rect[0] == pytest.approx(2 * 64 * 2048 * 54_018 / 67e12 * 1e3)
    tri = chip_smoke.min_sum_bound([(16_384, 16_384)], 64, symmetric=True)
    assert tri[1] == "bytes"
    assert tri[0] == pytest.approx((16_384 * 64 + 16_384**2) * 4 / 3.35e12 * 1e3)
    two = chip_smoke.min_sum_bound([(2048, 54_018), (769, 770)], 64)
    assert two[0] > rect[0]


SASS = """
\tFunction : _ZN12_GLOBAL__N_119min_sum_rect_kernelILb1EEEvPKilS2_lllPi
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   VIMNMX.U16x2 R3, R4, R5, PT ;
        /*0030*/                   VIMNMX.U16x2 R8, R4, R6, PT ;
        /*0040*/                   IADD3 R9, R9, R3, R8 ;
        /*0050*/              @!P0 BRA 0x10 ;
        /*0060*/                   BRA 0x60;
\tFunction : _ZN12_GLOBAL__N_118min_sum_tri_kernelILb0EEEvPKilllPi
        /*0000*/                   VIMNMX R3, R4, R5, PT ;
        /*0010*/                   EXIT ;
"""


def test_sass_loop_report_finds_the_stage_loop():
    funcs = chip_smoke.sass_functions(SASS)
    rect = next(f for f in funcs if "min_sum_rect_kernelILb1E" in f)
    rep = chip_smoke.sass_loop_report(funcs[rect], outputs=2, bins=1)
    assert rep["loop"] and rep["instructions"] == 5
    assert rep["ops"] == {"VIMNMX.U16x2": 2, "LDS.128": 1, "IADD3": 1, "BRA": 1}
    assert rep["per_pair_bin"] == 2.5
    tri = next(f for f in funcs if "min_sum_tri_kernel" in f)
    assert chip_smoke.sass_loop_report(funcs[tri], 1, 1) == {"loop": False}


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
    assert {n: c for n, c in launches["(c)"].items() if c} == {
        "counts_matrix": 1, "min_sum_rect": 1, "finish_upper": 1}
    assert not (tmp_path / "dist.csv").exists()


@pytest.fixture
def counted_dense_plain_versions(monkeypatch):
    """Route the dense path's kernel entries to their plain versions on the
    CPU, each adding to the launch count of the kernel the card would run
    (``u8_route`` for a u8 stream; K7's packed entry for the packed batch;
    K1, or K1m with a minimizer plane, for the planes' encode, K9 for the
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

    def packed(*a, **kw):
        histogram_cuda.PACKED_LAUNCHES += 1
        return histogram_cuda.hist_packed_small_reference(*a, **kw)

    def encode(*a, **kw):
        if (a[5] if len(a) > 5 else kw.get("minimizer_m")) is None:
            encode_cuda.LAUNCHES += 1
        else:
            encode_cuda.MIN_LAUNCHES += 1
        return plain_encode(*a, **kw)

    plain_stream_encode = encode_cuda.encode_stream_reference

    def stream_encode(*a, **kw):
        encode_cuda.STREAM_LAUNCHES += 1
        return plain_stream_encode(*a, **kw)

    monkeypatch.setattr(histogram_cuda, "histogram_planes", planes)
    monkeypatch.setattr(histogram_cuda, "histogram_stream", stream)
    monkeypatch.setattr(histogram_cuda, "histogram_packed", packed)
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


def test_main_path_rehearsal(records, tmp_path, monkeypatch, counted_sort_plain_versions):
    # the card's table build admitted on the CPU, as its gate admits the
    # main path's calls on a card; the host route's runs beside it
    from dna_kmeres_parallel_tpu_torch.models import sparse_engine

    monkeypatch.setattr(sparse_engine, "card_table_fits", lambda *a: True)
    path = tmp_path / "smoke.fasta"
    chip_smoke.write_fasta(path, *records)
    refs: dict = {}
    assert chip_smoke.phase_main_path(records, path, CPU, "cpu", refs) == 1
    assert set(refs) == {("table", 21, False), ("table", 21, True), ("table", 11, True)}


def test_read_set_draws_reads_from_one_genome():
    stream, starts, lengths = chip_smoke.read_set(60, 5000)
    assert np.all((lengths >= 1000) & (lengths <= 2000))
    assert stream.size == lengths.sum() + 59
    assert np.all(stream[starts[1:] - 1] == chip_smoke.INVALID)
    seqs = chip_smoke.record_strings(stream, starts, lengths)
    # about 1,000 windows of each read occur in another read (shared
    # genome), far more than random reads would share
    tables = [set(s[i : i + 21] for i in range(len(s) - 20)) for s in seqs[:2]]
    assert all(len(t) > 900 for t in tables)


def test_long_records_layout():
    stream, starts, lengths = chip_smoke.long_records(3, 5000, 6000)
    assert np.all((lengths >= 5000) & (lengths <= 6000)) and lengths.size == 3
    assert np.all(stream[starts[1:] - 1] == chip_smoke.INVALID)
    sub = chip_smoke.first_records((stream, starts, lengths), 2)
    assert sub[0].size == starts[1] + lengths[1] and sub[2].size == 2


@pytest.mark.parametrize("canonical", [False, True])
def test_reference_pair_tables_and_distances_match_oracle(canonical):
    from dna_kmeres_parallel_tpu.models import sparse_engine as jax_sparse

    records = chip_smoke.read_set(12, 3000)
    seqs = chip_smoke.record_strings(*records)
    tables = chip_smoke.reference_pair_tables(*records, 21, canonical, CPU)
    want = jax_sparse.build_pair_tables(seqs, 21, canonical)
    assert all(np.array_equal(g, w) for g, w in zip(tables, want))
    packed = oracle.distance_matrix_packed_sparse(seqs, 21, canonical=canonical)
    idx = np.array([0, 1, 10, 11, 37, packed.size - 1])
    got = chip_smoke.reference_pair_distances(tables, records[2], 21, idx)
    assert chip_smoke.same_bits(got, packed[idx])
    rows, cols = chip_smoke.pair_rows(np.arange(packed.size), 12)
    assert np.array_equal(rows, np.triu_indices(12, 1)[0])
    assert np.array_equal(cols, np.triu_indices(12, 1)[1])


@pytest.mark.parametrize("B", [65_536, 131_072])
def test_wide_counts_meet_their_route(B):
    from dna_kmeres_parallel_tpu_torch.ops import distance_cuda

    for kind, route in (("small", "u16x2"), ("wide", "i32")):
        c = chip_smoke.wide_counts(64, B, kind, B)
        assert c.dtype == np.int32 and c.shape == (64, B) and c.min() >= 0
        assert (np.count_nonzero(c, axis=1)[1:] > 1500).all()
        bounds = distance_cuda.check_counts(torch.from_numpy(c))
        assert distance_cuda.product_route(*bounds) == route
    assert chip_smoke.wide_counts(64, B, "wide", B)[0].sum() == 65536


def test_sparse_and_midk_path_rehearsal(tmp_path, monkeypatch, counted_plain_versions,
                                        counted_dense_plain_versions):
    # Phases (d)-(g) at a small size with the plain versions counted as
    # launches: 40 reads of a 3,000-base genome in panels of 8 rows, 30
    # records in panels of 4 (a child killed after 2 checkpoints), 3 long
    # records over a lowered table threshold, and 12 and 6 records at k=9
    # and 10.
    from dna_kmeres_parallel_tpu_torch.models import sparse_engine

    for name, value in (("READ_COUNT", 40), ("READ_GENOME_BASES", 3000), ("READ_PANEL_ROWS", 8),
                        ("PAIR_SAMPLE", 300), ("HOST_RECORDS", 30), ("HOST_PANEL_ROWS", 4),
                        ("LONG_RECORDS", 3), ("LONG_BASES", (3000, 4000)), ("MIDK_ROWS", 12),
                        ("MIDK_STREAM_ROWS", 6)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(sparse_engine, "_TPU_TABLE_MIN_BASES", 2001)

    def fired(launches):
        return {n: c for n, c in launches.items() if c}

    union = chip_smoke.phase_union_path(CPU, "cpu", tmp_path)
    launches = union["launches"]
    assert fired(launches["(d) union=on"]) == {"min_sum_tri": 1}
    assert fired(launches[chip_smoke.SPARSE_OFF]) == {"min_sum_tri": 1}
    assert fired(launches["(d) union=off"]) == fired(launches["(d) union=auto"]) == {}
    stream = next(n for key, n in launches.items() if key.startswith("(d) stream"))
    assert fired(stream) == {"min_sum_rect": 5}
    assert union["n_pairs"] == 780 and union["host_min_sum_s"] >= 0
    records = chip_smoke.distance_records(40)
    host = chip_smoke.phase_host_path(records, CPU, "cpu", tmp_path)
    assert [fired(n) for n in host.values()] == [{}]
    long = chip_smoke.phase_long_path(CPU, "cpu")
    assert [fired(n) for n in long.values()] == [{"encode_packed": 3}]
    midk = chip_smoke.phase_midk_path(records, CPU, "cpu", tmp_path)
    assert fired(midk[chip_smoke.MIDK_MAIN]) == {
        "counts_matrix": 1, "counts_matrix_global": 1, "min_sum_tri": 1, "finish_upper": 1}
    assert fired(midk["(g) k=10 stream"]) == fired(midk[chip_smoke.MIDK_STREAM_OFF]) == {
        "counts_matrix": 1, "counts_matrix_global": 1, "min_sum_rect": 1, "finish_upper": 1}
    assert not list(tmp_path.iterdir())


def test_follow_route_moves_the_products_to_the_threshold_route():
    want = {"counts_matrix": 1, "min_sum_rect": 4}
    assert chip_smoke.follow_route(want, "minplus") == want
    assert chip_smoke.follow_route(want, "union/cuda") == want
    assert chip_smoke.follow_route(want, "threshold") == {
        "counts_matrix": 1, "min_sum_threshold": 4}
    assert chip_smoke.follow_route({"min_sum_tri": 1}, "union/threshold") == {
        "min_sum_threshold": 1}
    # by the launch counts, where the run reports no route
    assert chip_smoke.follow_route(want, got={"min_sum_threshold": 0}) == want
    assert chip_smoke.follow_route(want, got={"min_sum_threshold": 4}) == {
        "counts_matrix": 1, "min_sum_threshold": 4}


def test_threshold_bound_takes_the_larger_time():
    # (d)'s square: 2048 x 2048 x 111,940 MACs at bucket 1 over 9.9e14
    ms, by = chip_smoke.threshold_bound(2048, 2048, 111_940, 1, True)
    assert by == "operations" and ms == pytest.approx(2048 * 2048 * 111_940 / 9.9e14 * 1e3)
    # (g) k=10's panel: 2 GiB of counts read, 1 GiB of planes
    ms, by = chip_smoke.threshold_bound(256, 256, 4**10, 2, False)
    want = (512 * 4**10 * 4 + 2 * 512 * 4**10 * 2 + 256 * 256 * 4) / 3.35e12 * 1e3
    assert by == "bytes" and ms == pytest.approx(want)


def test_threshold_phase_rehearsal(counted_plain_versions):
    # The threshold phase on the CPU at small shapes: the route (its plain
    # version here) held to K3/K4's plain versions and the plain product,
    # timed by the host clock, the gate's choices recorded (auto plans
    # nothing off the card).
    from dna_kmeres_parallel_tpu_torch.models import sparse_engine
    from dna_kmeres_parallel_tpu_torch.ops import distance_cuda

    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(0, 4, (20, 64)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 3, (9, 64)).astype(np.int32))
    seen = []

    def choose(rates):
        seen.append(rates)
        return None

    cases = [
        chip_smoke.threshold_case("sym", a, None, lambda: distance_cuda.min_sum_matrix_tri(a),
                                  choose),
        chip_smoke.threshold_case("rect", b, a, lambda: distance_cuda.min_sum_matrix_rect(b, a),
                                  choose, minplus_ms=1.0, cdist_ms=2.0),
    ]
    rates = sparse_engine.DistanceRates(threshold_macs_per_sec=1.0)
    records = chip_smoke.phase_threshold(CPU, "cpu", cases, rates, sparse_engine.DistanceRates())
    assert [r["shape"] for r in records] == ["sym", "rect"]
    assert [r["bucket"] for r in records] == [4, 4] and records[0]["dims"] == [20, 20, 64]
    assert records[1]["dims"] == [9, 20, 64] and records[1]["minplus_ms"] == 1.0
    assert all(r["max_abs_err"] == 0 and r["gate"] == "minplus" for r in records)
    assert seen == [rates, sparse_engine.DistanceRates()] * 2


def test_threshold_phase_catches_a_wrong_product():
    from dna_kmeres_parallel_tpu_torch.models import sparse_engine

    a = torch.from_numpy(np.random.default_rng(3).integers(0, 4, (8, 16)).astype(np.int32))
    wrong = chip_smoke.threshold_case("x", a, None, lambda: torch.zeros(8, 8, dtype=torch.int32),
                                      lambda rates: None)
    with pytest.raises(AssertionError, match="max_abs_err"):
        chip_smoke.phase_threshold(CPU, "cpu", [wrong], sparse_engine.DistanceRates(),
                                   sparse_engine.DistanceRates())


def test_table_csv_check_catches_a_wrong_line(tmp_path):
    from dna_kmeres_parallel_tpu_torch.utils import io

    codes = np.array([1, 7, 4**20, 4**21 - 1], np.uint64)
    counts = np.array([1, 12, 9, 1000], np.int64)
    path = tmp_path / "t.csv"
    io.write_count_codes_csv(path, 21, codes, counts)
    assert chip_smoke.check_table_csv(path, 21, codes, counts, 10) == 4
    bad = counts.copy()
    bad[2] = 8
    with pytest.raises(AssertionError, match="line 3"):
        chip_smoke.check_table_csv(path, 21, codes, bad, 10)
    with pytest.raises(AssertionError, match="bytes"):
        chip_smoke.check_table_csv(path, 21, codes[:3], counts[:3], 10)
    other = tmp_path / "u.csv"
    other.write_bytes(path.read_bytes())
    assert chip_smoke.same_file(path, other)
    other.write_bytes(path.read_bytes()[:-2] + b"2\n")
    assert not chip_smoke.same_file(path, other)
    other.write_bytes(path.read_bytes() + b"\n")
    assert not chip_smoke.same_file(path, other)


def test_cli_path_rehearsal(records, tmp_path, monkeypatch, counted_plain_versions,
                            counted_dense_plain_versions):
    # Phase 10 at a small size with the plain versions counted as
    # launches: the main path's two records, 40 distance records (30 in
    # the k=3 runs, panels of 8, 6 in the selftests), 40 reads of a
    # 3,000-base genome, and a bench of 64 kbase.
    from dna_kmeres_parallel_tpu_torch.models import sparse_engine

    for name, value in (("CLI_DIST_ROWS", 30), ("CLI_PANEL_ROWS", 8), ("CLI_SELFTEST_ROWS", 6),
                        ("CLI_STREAM_EVERY", "16K"), ("CLI_BENCH", ("64K", "16K")),
                        ("CLI_TABLE_SAMPLE", 300), ("MIDK_ROWS", 12)):
        monkeypatch.setattr(chip_smoke, name, value)
    stream = records[0]
    main_fasta = tmp_path / "smoke.fasta"
    chip_smoke.write_fasta(main_fasta, *records)
    main_table = chip_smoke.reference_table(stream, 21, False, CPU)
    hists = {(3, False): chip_smoke.reference_hist(stream, 3, False, CPU),
             (8, True): chip_smoke.reference_hist(stream, 8, True, CPU)}
    dist = chip_smoke.distance_records(40)
    dist_fasta = tmp_path / "dist.fasta"
    chip_smoke.write_fasta(dist_fasta, *dist)
    reads = chip_smoke.read_set(40, 3000)
    seqs = chip_smoke.record_strings(*reads)
    S = reads[2].size
    idx = np.sort(chip_smoke.sample_lines(S * (S - 1) // 2, 300))
    ref = chip_smoke.reference_pair_tables(*reads, 21, False, CPU)
    union = {"records": reads, "tables": sparse_engine.build_pair_tables(seqs, 21, False, CPU),
             "sample": (idx, chip_smoke.reference_pair_distances(ref, reads[2], 21, idx))}
    work = tmp_path / "work"
    work.mkdir()
    launches = chip_smoke.phase_cli(main_fasta, main_table, hists, 1, dist_fasta, dist, union,
                                    {}, CPU, "cpu", work)

    def fired(name):
        return {n: c for n, c in launches[name].items() if c}

    assert fired(chip_smoke.CLI_MAIN) == {"encode_packed": 1}
    assert fired("kmer-gpu count --k 3") == {"hist_packed_small": 1}
    assert fired("kmer-gpu count --k 8 --canonical") == {"hist_planes": 1}
    assert fired("kmer-gpu distance --k 3") == {
        "counts_matrix": 1, "min_sum_tri": 1, "finish_upper": 1}
    assert fired("kmer-gpu distance --k 3 --stream-panel 8 --checkpoint") == {
        "counts_matrix": 2, "min_sum_rect": 4, "finish_upper": 4}
    assert fired("kmer-gpu distance --k 21") == {}  # the CPU: the host route
    assert sorted(p.name for p in work.iterdir()) == ["cal"]


def test_mesh_count_rehearsal(records, tmp_path, monkeypatch, counted_dense_plain_versions):
    # Phase 11's counting on the main path's two records in 64 kbase
    # batches (a checkpoint every two), the super-k-mer runs on the first
    # record (the auto run in 32 kbase batches); K11's plain version
    # counted as its launches.
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda

    plain_sort = sort_cuda.row_sort_u32_reference

    def row_sort(x):
        sort_cuda.ROW_SORT_LAUNCHES += 1
        return plain_sort(x)

    monkeypatch.setattr(sort_cuda, "row_sort_u32_reference", row_sort)
    for name, value in (("STREAM_BATCH_BASES", 1 << 16), ("STREAM_CKPT_BASES", 1 << 17),
                        ("SUPER_RECORDS", 1), ("SUPER_AUTO_BATCH", 1 << 15)):
        monkeypatch.setattr(chip_smoke, name, value)
    path = tmp_path / "smoke.fasta"
    chip_smoke.write_fasta(path, *records)
    refs: dict = {}
    launches = chip_smoke.phase_mesh_count(records, path, CPU, "cpu", refs)
    fired = {name: {k: c for k, c in got.items() if c} for name, got in launches.items()}
    D, n = chip_smoke.MESH_D, -(-records[0].size // (1 << 16))
    names = list(fired)
    assert len(names) == 11 and names[0] == chip_smoke.MESH_MAIN
    assert fired[names[0]] == {"encode_packed": D * n}
    assert fired[names[1]] == {"encode_stream": D * n}
    assert fired[names[2]] == {"encode_packed": D * n, "row_sort": D * n}
    assert fired[names[3]] == {"hist_u8_small": D * n}
    assert fired[names[4]] == {"hist_u8": D * n}
    assert fired[names[5]] == {"hist_u8_any": D}
    assert fired[names[6]] == {"hist_u8": D * n}
    assert fired[names[7]] == {"hist_planes": n - 4}  # resumed on one device
    assert fired[names[8]] == fired[names[9]] == {}  # the super-k-mer records
    assert set(fired[names[10]]) <= {"encode_packed"}
    assert not list(tmp_path.glob("*.npz")) and not (tmp_path / "super.fasta").exists()


def test_mesh_distance_rehearsal(tmp_path, monkeypatch, counted_plain_versions,
                                 counted_dense_plain_versions):
    # Phase 11's distances at a small size: 40 distance records ((a) 30,
    # (c) panels of 16), 40 reads of a 3,000-base genome in panels of 8,
    # the command line on 30 records; a 1-rank gloo group in place of NCCL.
    from dna_kmeres_parallel_tpu_torch.models import sparse_engine
    from dna_kmeres_parallel_tpu_torch.utils import io

    for name, value in (("DIST_ROWS_A", 30), ("DIST_ROWS_B", 20), ("PANEL_ROWS", 16),
                        ("READ_PANEL_ROWS", 8), ("CLI_MESH_ROWS", 30), ("CLI_DIST_ROWS", 30)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setenv("KMER_GPU_CAL_DIR", str(tmp_path / "no_cal"))
    dist = chip_smoke.distance_records(40)
    path = tmp_path / "dist.fasta"
    chip_smoke.write_fasta(path, *dist)
    keep: dict = {}
    chip_smoke.phase_distance_path(dist, path, CPU, "cpu", keep)
    assert set(keep) == {"(a)", "(c)"} and keep["(c)"].exists()
    reads = chip_smoke.read_set(40, 3000)
    one_shot = tmp_path / "one_shot.csv"
    io.write_distances_csv(one_shot, sparse_engine.distance_sparse_packed(
        chip_smoke.record_strings(*reads), chip_smoke.SPARSE_K, device="cpu", union="on"))
    union = {"records": reads, "csv": one_shot.read_bytes()}
    work = tmp_path / "work"
    work.mkdir()
    launches = chip_smoke.phase_mesh_distance(path, dist, keep, union, CPU, "cpu", work)
    fired = {name: {k: c for k, c in got.items() if c} for name, got in launches.items()}
    names = list(fired)
    assert len(names) == 9
    for i, D in ((0, chip_smoke.MESH_D), (3, chip_smoke.MESH_D_ODD)):
        assert fired[names[i]] == fired[names[i + 1]] == {
            "counts_matrix": 1, "min_sum_rect": D, "finish_upper": 1}
        assert fired[names[i + 2]] == {"min_sum_rect": D * 5}  # 40 reads, panels of 8
    assert fired[names[6]] == fired[names[7]] == {"encode_packed": chip_smoke.MESH_D}
    assert fired[names[8]] == {
        "counts_matrix": 1, "min_sum_rect": chip_smoke.MESH_D, "finish_upper": 1}
    assert not list(work.iterdir())


def test_multihost_rehearsal(records, tmp_path, monkeypatch, counted_plain_versions,
                             counted_dense_plain_versions):
    # Phase 12 at a small size: the main path's two records (64 kbase
    # steps of the dense count, the bucketed runs over the first 128
    # kbase), 30 distance records in panels of 16, 40 reads of a 3,000-base
    # genome in panels of 8; the children (two gloo ranks on the CPU) over
    # the first record in 64 kbase steps and the distances in panels of 4.
    # A 1-rank gloo group stands in for NCCL; the children's plain versions
    # count no launch.
    from dna_kmeres_parallel_tpu_torch.models import sparse_engine
    from dna_kmeres_parallel_tpu_torch.utils import io

    for name, value in (("MULTIHOST_BATCH", 1 << 16), ("MULTIHOST_BUCKET_BASES", 1 << 17),
                        ("MULTIHOST_CHILD_BASES", 1 << 16), ("MULTIHOST_CHILD_BATCH", 1 << 16),
                        ("MULTIHOST_DIST_ROWS", 30), ("MULTIHOST_CHILD_PANEL", 4),
                        ("PANEL_ROWS", 16), ("READ_PANEL_ROWS", 8)):
        monkeypatch.setattr(chip_smoke, name, value)
    main_fasta = tmp_path / "smoke.fasta"
    chip_smoke.write_fasta(main_fasta, *records)
    hists = {(3, False): chip_smoke.reference_hist(records[0], 3, False, CPU),
             (8, True): chip_smoke.reference_hist(records[0], 8, True, CPU)}
    head = chip_smoke.head_records(records, 1 << 17)
    assert head[0].size >= 1 << 17
    reads = chip_smoke.read_set(40, 3000)
    one_shot = tmp_path / "one_shot.csv"
    io.write_distances_csv(one_shot, sparse_engine.distance_sparse_packed(
        chip_smoke.record_strings(*reads), chip_smoke.SPARSE_K, device="cpu", union="on"))
    union = {"records": reads, "csv": one_shot.read_bytes()}
    work = tmp_path / "work"
    work.mkdir()
    launches = chip_smoke.phase_multihost(main_fasta, hists, head, chip_smoke.distance_records(40),
                                          union, CPU, "cpu", work)
    fired = {name: {k: c for k, c in got.items() if c} for name, got in launches.items()}
    names = list(fired)
    n = -(-records[0].size // (1 << 16))
    steps = -(-head[0].size // (1 << 16))
    assert names[0] == chip_smoke.MULTIHOST_MAIN and fired[names[0]] == {"hist_u8": 1}
    assert fired[names[1]] == {"hist_u8_small": chip_smoke.MULTIHOST_STOP_STEPS}
    assert fired[names[2]] == {"hist_u8_small": n - chip_smoke.MULTIHOST_STOP_STEPS}
    assert fired[names[3]] == {"encode_packed_minimizer": steps}
    assert fired[names[4]] == {"encode_packed": steps}
    assert fired[names[5]] == {  # 29 rows, panels of 16
        "counts_matrix": 1, "min_sum_rect": 2, "finish_upper": 2}
    assert fired[names[6]] == {}  # the CPU takes the host route at k=21
    assert len(names) == 7 + 2 * 5 and not any(fired[name] for name in names[7:])
    assert all("rank 0" in name or "rank 1" in name for name in names[7:])
    assert not list(work.iterdir())
