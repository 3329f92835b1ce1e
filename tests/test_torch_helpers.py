"""The JAX package's public helpers and their counterparts in the port, on
the same seeded inputs: ``utils/codec`` (``BITS_PER_BASE``,
``pack_bases``, ``unpack_bases``), ``utils/triangular``
(``packed_index_reference``, ``unpack_indices``, ``packed_to_square``,
``square_to_packed``), ``ops/encode`` (``ascii_to_bases``,
``unpack_2bit``, ``unpack_mask``), ``native`` (``ParsedFasta
.sequence_codes``, ``count_dense_native``, ``unpack_2bit_native``),
and ``ops/distance.distance_matrix_square``.

Integers and float32 bits: the tolerance is zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu import native as jax_native
from dna_kmeres_parallel_tpu.ops import distance as jax_distance
from dna_kmeres_parallel_tpu.ops import encode as jax_encode
from dna_kmeres_parallel_tpu.utils import codec as jax_codec
from dna_kmeres_parallel_tpu.utils import triangular as jax_triangular
from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.ops import distance, encode
from dna_kmeres_parallel_tpu_torch.utils import codec, triangular


def bases(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, n).astype(np.uint8)
    b[rng.random(n) < 0.05] = 0xFF
    return b


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 9, 1000, 1003])
def test_pack_and_unpack_bases_match_jax(n):
    assert codec.BITS_PER_BASE == jax_codec.BITS_PER_BASE == 2
    b = bases(n, n)
    got, want = codec.pack_bases(b), jax_codec.pack_bases(b)
    assert got[2] == want[2] == n
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == np.uint8 and np.array_equal(g, w)
    back = codec.unpack_bases(*got)
    assert np.array_equal(back, jax_codec.unpack_bases(*want)) and np.array_equal(back, b)
    # the native packer's format
    data, mask, _ = native.pack_2bit_native(b)
    assert np.array_equal(data, got[0]) and np.array_equal(mask, got[1])


@pytest.mark.parametrize("n", [1, 2, 5, 17])
def test_triangular_helpers_match_jax(n):
    for i in range(n):
        for j in range(i + 1, n):
            got = triangular.packed_index_reference(i + 1, j - i, n)
            assert got == jax_triangular.packed_index_reference(i + 1, j - i, n)
            assert got == triangular.packed_index(i, j, n)
    rows, cols = triangular.unpack_indices(n)
    want_rows, want_cols = jax_triangular.unpack_indices(n)
    assert rows.dtype == want_rows.dtype and np.array_equal(rows, want_rows)
    assert np.array_equal(cols, want_cols)
    packed = np.random.default_rng(n).random(n * (n - 1) // 2).astype(np.float32)
    sq = triangular.packed_to_square(packed, n, diag=-1.0)
    want = jax_triangular.packed_to_square(packed, n, diag=-1.0)
    assert sq.dtype == want.dtype and np.array_equal(sq, want)
    assert np.array_equal(triangular.square_to_packed(sq), jax_triangular.square_to_packed(want))
    assert np.array_equal(triangular.square_to_packed(sq), packed)


def test_encode_helpers_match_jax():
    rng = np.random.default_rng(0)
    ascii_ = rng.integers(0, 256, 4096).astype(np.uint8)
    ascii_[::3] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, ascii_[::3].size)]
    got = encode.ascii_to_bases(torch.from_numpy(ascii_))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(jax_encode.ascii_to_bases(jnp.asarray(ascii_))))
    assert np.array_equal(got.numpy(), codec.encode_bases(ascii_))
    packed = rng.integers(0, 256, (3, 40)).astype(np.uint8)  # leading axes kept
    for port_fn, jax_fn in ((encode.unpack_2bit, jax_encode.unpack_2bit),
                            (encode.unpack_mask, jax_encode.unpack_mask)):
        g = port_fn(torch.from_numpy(packed)).numpy()
        w = np.asarray(jax_fn(jnp.asarray(packed)))
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("n", [0, 5, 1000, 1001])
def test_unpack_2bit_native_matches_jax(n):
    b = bases(n + 7, n)
    data, mask, _ = native.pack_2bit_native(b)
    got = native.unpack_2bit_native(data, mask, n)
    assert np.array_equal(got, jax_native.unpack_2bit_native(data, mask, n))
    assert np.array_equal(got, b)
    with pytest.raises(ValueError, match="cannot hold"):
        native.unpack_2bit_native(data, mask, n + 8)


@pytest.mark.parametrize("k", [1, 3, 7, 12, 15])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("n_own", [None, 0, 333])
def test_count_dense_native_matches_jax(k, canonical, n_own):
    b = bases(k, 2000)
    got = native.count_dense_native(b, k, n_own, canonical)
    want = jax_native.count_dense_native(b, k, n_own, canonical)
    assert got.dtype == want.dtype == np.int64 and np.array_equal(got, want)
    with pytest.raises(ValueError, match="k <= 15"):
        native.count_dense_native(b, 16)


def test_sequence_codes_match_jax(tmp_path):
    path = tmp_path / "in.fasta"
    path.write_text(">a\nACGTNNAC\n>b\n\n>c\nGGTTacgtA\nTT\n")
    got, want = native.parse_fasta_native(path), jax_native.parse_fasta_native(str(path))
    assert got.n_seqs == want.n_seqs == 3
    for i in range(3):
        assert np.array_equal(got.sequence_codes(i), want.sequence_codes(i))


@pytest.mark.parametrize("k", [3, 4])
def test_distance_matrix_square_matches_jax(k):
    rng = np.random.default_rng(k)
    S, B = 13, 4**k
    counts = rng.integers(0, 6, (S, B)).astype(np.int32)
    lengths = (counts.sum(1) + k - 1 + rng.integers(0, 5, S)).astype(np.int32)
    want = np.asarray(jax_distance.distance_matrix_square(
        jnp.asarray(counts), jnp.asarray(lengths), k))
    got = distance.distance_matrix_square(torch.from_numpy(counts), lengths, k)
    assert got.dtype == torch.float32 and got.shape == (S, S)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
