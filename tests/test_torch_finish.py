"""The float32 distance finish on the CPU: the host finish, the plain
PyTorch version of the card's finish kernel
(``ops/distance.finish_upper_plain``, the kernel's spec, with its NumPy
forms ``finish_upper`` and ``finish_packed``), against NumPy's float32
formula over the whole panel (``ops/distance.finish_distances_panel``),
and the entry that picks between the kernel and the host finish by the
sums' device.

Every comparison is bit for bit (uint32 views): the finish is one
correctly rounded division and subtraction, and a NaN carries NumPy's
bits on x86, 0xFFC00000. The file imports no JAX."""

import numpy as np
import pytest
import torch

import dna_kmeres_parallel_tpu_torch as port
from dna_kmeres_parallel_tpu_torch.models import engine, oracle
from dna_kmeres_parallel_tpu_torch.ops import distance, distance_cuda
from dna_kmeres_parallel_tpu_torch.utils import profiling

SIZES = [0, 1, 2, 3, 17, 300]
#: (r0, base) of a layout, from S: the square, a panel as the dense CSV
#: stream passes it (base = r0), a panel whose columns start before its
#: rows (base < r0), and one whose columns start after them (every row
#: keeps all its columns at first)
LAYOUTS = {
    "square": lambda S: (0, 0),
    "panel": lambda S: (S // 3, S // 3),
    "behind": lambda S: (S // 2, S // 5),
    "ahead": lambda S: (0, S // 4 + 2),
}
NUMPY_NAN = np.uint32(0xFFC00000)


def finish_case(S: int, layout: str, lengths: str, k: int, seed: int = 0):
    """(sums [R, C] int32, lengths of the rows, of the columns, r0, base)
    of one case: a square's symmetric min-sums and the panel the layout
    cuts from it. ``lengths`` "short" holds records of k - 1 (0 / 0: NaN),
    below it (x / negative: 1.0 where s = 0) and up to 3k; "huge" records
    past 2^24 bases (the float32 denominator rounds) and past 2^31."""
    rng = np.random.default_rng([seed, S, k, len(layout), len(lengths)])
    if lengths == "short":
        L = rng.integers(0, 3 * k + 1, S)
        L[: min(S, 3)] = [k - 1, max(k - 2, 0), 0][: min(S, 3)]
    else:
        L = rng.integers(1 << 24, 1 << 26, S)
        L[: min(S, 3)] = [(1 << 24) + 1, (1 << 25) + 3, (1 << 33) + 5][: min(S, 3)]
    L = rng.permutation(L).astype(np.int64)
    sums = rng.integers(0, 1 << 31, (S, S), dtype=np.int64)
    sums[: S // 2] %= 4 * k + 1  # small sums beside ones past 2^24
    sums = np.minimum(sums, sums.T).astype(np.int32)
    empty = L < k  # a record with no k-mer shares none
    sums[empty, :] = 0
    sums[:, empty] = 0
    r0, base = LAYOUTS[layout](S)
    r1 = min(S, r0 + max(1, S // 2))
    return sums[r0:r1, base:], L[r0:r1], L[base:], r0, base


def assert_same_bits(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.all(got.view(np.uint32)[np.isnan(got)] == NUMPY_NAN)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def numpy_finish(sums, lr, lc, k, r0, base) -> np.ndarray:
    """NumPy's float32 finish of the whole panel, its kept columns taken
    row by row: row i keeps the columns from i + r0 + 1 - base on."""
    R, C = sums.shape
    with np.errstate(divide="ignore", invalid="ignore"):
        full = distance.finish_distances_panel(sums, lr, lc, k)
    keep = np.arange(C)[None, :] >= (np.arange(R) + r0 + 1 - base)[:, None]
    return full[keep]


@pytest.mark.parametrize("k", [3, 21])
@pytest.mark.parametrize("lengths", ["short", "huge"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("S", SIZES)
def test_plain_finish_matches_numpy_finish_bit_for_bit(S, layout, lengths, k):
    sums, lr, lc, r0, base = finish_case(S, layout, lengths, k)
    want = numpy_finish(sums, lr, lc, k, r0, base)
    got = distance.finish_upper_plain(torch.from_numpy(sums), torch.from_numpy(lr),
                                      torch.from_numpy(lc), k, r0, base)
    assert got.numel() == distance.packed_upper_size(*sums.shape, r0, base)
    assert_same_bits(got.numpy(), want)
    assert_same_bits(distance.finish_upper(sums, lr, lc, k, r0, base), want)
    if lengths == "short" and S >= 17 and layout == "square":
        assert np.isnan(want).any() and (want == 1.0).any()


def test_plain_finish_reads_strided_rows_in_row_blocks(monkeypatch):
    """A panel whose rows lie apart (the mesh's sliced square) and row
    blocks of a few rows each give the same bits."""
    monkeypatch.setattr(distance, "_FINISH_BLOCK_ELEMS", 50)
    sums, lr, lc, r0, base = finish_case(40, "panel", "short", 3)
    wide = torch.zeros(sums.shape[0], sums.shape[1] + 3, dtype=torch.int32)
    wide[:, : sums.shape[1]] = torch.from_numpy(sums)
    view = wide[:, : sums.shape[1]]
    assert not view.is_contiguous()
    got = distance_cuda.finish_upper_packed(view, torch.from_numpy(lr), torch.from_numpy(lc),
                                            3, r0, base)
    assert_same_bits(got.numpy(), numpy_finish(sums, lr, lc, 3, r0, base))


@pytest.mark.parametrize("bad", ["sums_dtype", "rows_len", "cols_dtype", "cols_device"])
def test_finish_entry_refuses_what_the_kernel_does_not_take(bad):
    sums = torch.zeros(4, 5, dtype=torch.int32)
    lr, lc = torch.arange(4), torch.arange(5)
    args = {
        "sums_dtype": (sums.to(torch.int64), lr, lc),
        "rows_len": (sums, lr[:3], lc),
        "cols_dtype": (sums, lr, lc.to(torch.int32)),
        "cols_device": (sums, lr, lc.to("meta")),
    }[bad]
    with pytest.raises(ValueError):
        distance_cuda.finish_upper_packed(*args, 3)
    with pytest.raises(ValueError, match="card"):
        distance_cuda.finish_upper_cuda(sums, lr, lc, 3)


def test_cpu_engine_distances_equal_the_oracle_with_a_record_shorter_than_k():
    """The engine on the CPU (the plain finish), records of k - 1 bases (no
    k-mer: NaN against each other and every longer record) and of fewer
    (1.0), against the port's NumPy oracle; its finish span counts no
    pairs finished on a card."""
    seqs = ["ACGTTGCAAGGCTTACG" * 3, "AC", "GATTACAGATTACA", "A", "AC", "TTTACGACG" * 4]
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = port.distance_sequences(seqs, k=3, device="cpu")
    finish = [r for r in profiling.records() if r["name"] == "finish"]
    want = oracle.distance_matrix_packed(seqs, 3)
    assert np.isnan(want).any() and (want == 1.0).any()
    assert_same_bits(got.packed, want)
    assert [r["counters"] for r in finish] == [{"device_pairs": 0}]
    assert got.phases["finish"] > 0 and set(got.phases) == set(engine.DIST_PHASES)


def test_cpu_engine_finishes_its_square_through_finish_packed(monkeypatch):
    """On the CPU the all-pairs square goes through ``finish_packed``, the
    host finish of a square, and its answer is the engine's: a distance
    altered there is altered in the result."""
    seqs = ["ACGTTGCAAGGCTTACG" * 3, "GATTACAGATTACA", "TTTACGACG" * 4]
    real = distance.finish_packed
    calls = []

    def altered(sums, lengths, k):
        calls.append(sums.shape)
        out = real(sums, lengths, k).copy()
        out[0] += np.float32(0.25)
        return out

    monkeypatch.setattr(distance, "finish_packed", altered)
    got = port.distance_sequences(seqs, k=3, device="cpu").packed
    want = oracle.distance_matrix_packed(seqs, 3)
    assert calls == [(3, 3)]
    assert got[0] == want[0] + np.float32(0.25) and np.array_equal(got[1:], want[1:])


def test_distance_matrix_packed_finishes_on_the_counts_device():
    seqs = ["ACGTTGCAAGGCTTACG" * 3, "AC", "GATTACAGATTACA", "TTTACGACG" * 4]
    counts = engine.KmerEngine(port.KmerConfig(k=3), device="cpu").counts_matrix(seqs)
    got = distance.distance_matrix_packed(torch.from_numpy(counts), [len(s) for s in seqs], 3)
    assert_same_bits(got, oracle.distance_matrix_packed(seqs, 3))


def kernel_model(storage: np.ndarray, offset: int, R: int, C: int, ld: int,
                 lr: np.ndarray, lc: np.ndarray, k: int, r0: int, base: int) -> np.ndarray:
    """A NumPy model of ``csrc/finish.cu``'s index arithmetic, row by row:
    the row's place in the output from the closed-form prefix, a scalar
    head up to the output's next 16-byte boundary (the output starts
    aligned), 16-byte words of the input read at their aligned address and
    shifted by the row's misalignment (the storage starts aligned), and a
    scalar tail. Asserts that every word read holds a value the row needs.
    Each value is then finished as NumPy does, NaN as 0xFFC00000."""
    d = r0 + 1 - base
    out = np.full(distance.packed_upper_size(R, C, r0, base), np.nan, np.float32)
    values = np.zeros(out.size, np.int32)
    cols = np.zeros(out.size, np.int64)
    rows = np.zeros(out.size, np.int64)
    for i in range(R):
        f = min(max(i + d, 0), C)
        n = C - f
        if n == 0:
            continue
        src = offset + i * ld + f
        at = i * C - (distance._skipped(i + d, C) - distance._skipped(d, C))
        head = min(-at & 3, n)
        body = (n - head) >> 2
        s = src + head
        mis = s & 3
        w = s - mis
        idx = np.arange(n)
        got = storage[src + idx].copy()  # head and tail, scalar
        if body:
            lo = w + 4 * np.arange(body)[:, None] + np.arange(4)  # word v
            hi = lo + 4  # word v + 1
            words = np.concatenate([storage[lo], storage[hi]], axis=1) if mis else storage[lo]
            got[head : head + 4 * body] = words[:, mis : mis + 4].reshape(-1)
            last = (hi if mis else lo)[-1]
            assert last[0] <= s + 4 * body - 1  # the last word holds a needed value
        assert (at + head) % 4 == 0 or head == n
        values[at : at + n] = got
        cols[at : at + n] = f + idx
        rows[at : at + n] = i
    den = np.minimum(lr[rows], lc[cols]) - k + 1
    with np.errstate(divide="ignore", invalid="ignore"):
        out[:] = np.float32(1.0) - values.astype(np.float32) / den.astype(np.float32)
    out.view(np.uint32)[np.isnan(out)] = NUMPY_NAN
    return out


@pytest.mark.parametrize("offset,pad", [(0, 0), (1, 0), (2, 3), (3, 1), (0, 5)])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("S", [1, 3, 17, 300])
def test_kernel_index_model_matches_plain_finish(S, layout, offset, pad):
    """Every row start and stride the kernel can meet: the storage offset
    and the padding of the row stride move the input's alignment against
    the output's."""
    sums, lr, lc, r0, base = finish_case(S, layout, "short", 3)
    R, C = sums.shape
    ld = C + pad
    storage = np.full(offset + R * ld + 8, -1, np.int32)
    for i in range(R):
        storage[offset + i * ld : offset + i * ld + C] = sums[i]
    got = kernel_model(storage, offset, R, C, ld, lr, lc, 3, r0, base)
    assert_same_bits(got, numpy_finish(sums, lr, lc, 3, r0, base))


def test_closed_form_row_starts_equal_the_running_sum():
    for R, C, d in [(0, 5, 1), (7, 7, 1), (5, 9, -3), (9, 4, 2), (40, 13, -60), (6, 6, 9)]:
        counts = [C - min(max(i + d, 0), C) for i in range(R)]
        starts = [i * C - (distance._skipped(i + d, C) - distance._skipped(d, C))
                  for i in range(R + 1)]
        assert starts == [0, *np.cumsum(counts, dtype=np.int64).tolist()]
        assert distance.packed_upper_size(R, C, d - 1, 0) == sum(counts)
