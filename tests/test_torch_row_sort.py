"""K11, the row sort: its plain version against the JAX kernel
``row_sort_pallas_u32`` in Pallas interpret mode, its argument checks, its
dispatch by device, and the gate that sends the device-sort route's rows
to it. The kernel itself runs only on the card (tests/test_torch_cuda.py).

u32 words: every comparison is exact (tolerance zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu.ops.sort_pallas import row_sort_pallas_u32
from dna_kmeres_parallel_tpu_torch.ops import sort_cuda
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops


def u32_rows(R: int, m: int, seed: int) -> np.ndarray:
    """Random u32 rows with the bias-order extremes in row 0 and a
    sentinel tail in every other row (the cases of tests/test_pallas.py)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, (R, m), dtype=np.uint64).astype(np.uint32)
    x[0, :4] = [0, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000000]
    x[1::2, m - m // 3 :] = 0xFFFFFFFF
    return x


@pytest.mark.parametrize("R,m", [(8, 128), (16, 512), (8, 2048)])
def test_plain_version_equals_the_jax_kernel(R, m):
    x = u32_rows(R, m, R + m)
    want = np.asarray(row_sort_pallas_u32(jnp.asarray(x), interpret=True))
    got = sort_cuda.row_sort_u32(torch.from_numpy(x.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (R, m)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(want, np.sort(x, axis=1))


@pytest.mark.parametrize("R,m", [(1, 128), (3, 256), (5, 32768)])
def test_plain_version_sorts_unsigned(R, m):
    # Row counts that are not a multiple of 8 (the TPU kernel's sublane
    # tiling is not carried over), up to the widest row K11 takes.
    x = u32_rows(R, m, m)
    got = sort_cuda.row_sort_u32_reference(torch.from_numpy(x.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), np.sort(x, axis=1))


@pytest.mark.parametrize(
    "shape,dtype",
    [((4, 100), torch.int32), ((4, 192), torch.int32), ((4, 64), torch.int32),
     ((4, 65536), torch.int32), ((0, 128), torch.int32), ((128,), torch.int32),
     ((2, 2, 128), torch.int32), ((4, 128), torch.int64), ((4, 128), torch.uint8)],
)
def test_argument_checks(shape, dtype):
    x = torch.zeros(shape, dtype=dtype)
    for fn in (sort_cuda.row_sort_u32, sort_cuda.row_sort_u32_reference,
               sort_cuda.row_sort_u32_cuda):
        with pytest.raises(ValueError):
            fn(x)


def test_cuda_wrapper_refuses_a_cpu_tensor():
    launches = sort_cuda.ROW_SORT_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        sort_cuda.row_sort_u32_cuda(torch.zeros((8, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="no row sort"):
        sort_cuda.row_sort_u32(torch.zeros((8, 128), dtype=torch.int32, device="meta"))
    assert sort_cuda.ROW_SORT_LAUNCHES == launches


@pytest.mark.parametrize(
    "m,fits", [(64, False), (128, True), (192, False), (256, True), (2048, True),
               (32768, True), (65536, False), (0, False)],
)
def test_row_sort_fits(m, fits):
    assert sort_cuda.row_sort_fits(m) is fits


@pytest.fixture
def k11_calls(monkeypatch):
    """Count the calls that reach K11's dispatch (``row_sort_u32``)."""
    calls = []
    real = sort_cuda.row_sort_u32

    def spy(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(sort_cuda, "row_sort_u32", spy)
    return calls


@pytest.mark.parametrize(
    "k,row_len,pallas_sort,n,reaches",
    [(13, 128, True, 1000, True), (11, 2048, True, 5000, True), (15, 512, True, 3 * 512, True),
     (1, 128, True, 300, True), (13, 128, False, 1000, False), (16, 128, True, 1000, False),
     (21, 2048, True, 5000, False), (13, 192, True, 1000, False), (13, 64, True, 1000, False),
     (13, 65536, True, 1000, False)],
)
def test_gate_sends_single_word_rows_to_k11(k11_calls, k, row_len, pallas_sort, n, reaches):
    # The JAX gate, without its rows % 8 == 0: single-word keys, a row
    # length K11 takes, and pallas_sort; everything else sorts with
    # torch.sort, and both give the same rows.
    rng = np.random.default_rng(n + k)
    b = torch.from_numpy(rng.integers(0, 4, n + k - 1).astype(np.uint8))
    got = sparse_ops.sort_words_rows(b, n, k, False, row_len=row_len, pallas_sort=pallas_sort)
    rows = -(-n // row_len)
    assert k11_calls == ([(rows, row_len)] if reaches else [])
    plain = sparse_ops.sort_words_rows(b, n, k, False, row_len=row_len, pallas_sort=False)
    assert all(torch.equal(g, p) for g, p in zip(got, plain, strict=True))


def passes_by_bytes(x: np.ndarray) -> list[int]:
    """Per row, the bytes in which its words other than 0xFFFFFFFF differ."""
    out = []
    for row in x:
        real = row[row != 0xFFFFFFFF]
        out.append(len({b for b in range(4) if len(set((real >> (8 * b)) & 0xFF)) > 1}))
    return out


@pytest.mark.parametrize("m", [128, 2048])
def test_digit_passes(m):
    # K11 runs one 8-bit pass per byte in which a row's non-sentinel words
    # differ: 4 for random words, none for equal words or sentinels only,
    # one for words that differ in one byte.
    rng = np.random.default_rng(m)
    x = rng.integers(0, 1 << 32, (8, m), dtype=np.uint64).astype(np.uint32)
    x[1] = 0xFFFFFFFF
    x[2] = 77
    x[3, : m // 2] = 0xFFFFFFFF
    x[3, m // 2 :] = 0x80000001
    x[4] = 0x11223344 & ~0xFF00 | (rng.integers(0, 256, m).astype(np.uint32) << 8)
    x[5, 0] = 0xFFFFFFFE
    x[6] = rng.integers(0, 1 << 22, m)
    x[6, 5] = 0xFFFFFFFF
    got = sort_cuda.row_sort_digit_passes(torch.from_numpy(x.view(np.int32)))
    assert got.tolist() == passes_by_bytes(x)
    assert got[:5].tolist() == [4, 0, 0, 0, 1] and got[6] == 3


def test_k11_words_take_at_most_three_passes():
    # K1's k=11 words (22 bits) with their sentinels: at most 3 passes.
    rng = np.random.default_rng(11)
    b = torch.from_numpy(rng.integers(0, 5, 8 * 2048 + 10).astype(np.uint8))
    words = sparse_ops.encode_words(b, 8 * 2048, 11, True)[0]
    x = words[: 8 * 2048].reshape(8, 2048)
    assert int(sort_cuda.row_sort_digit_passes(x).max()) <= 3
