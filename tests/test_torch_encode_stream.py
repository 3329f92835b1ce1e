"""K9, the u8-stream window encoder: the port's plain version (the CPU
route of ``sparse.encode_words``) against the JAX package's plain encode
and its Pallas kernel in interpret mode. The CUDA kernel is held against
the plain version in test_torch_cuda.py.

Integer codes: every comparison is exact (tolerance zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu.ops import sparse as jax_sparse
from dna_kmeres_parallel_tpu.ops.encode_pallas import rolling_codes_split_pallas
from dna_kmeres_parallel_tpu_torch.ops import encode_cuda
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops

from test_torch_encode import KS, T, make_stream, unsigned

# The JAX plain encode, jitted so each (k, canonical) compiles once.
_jax_plain = jax.jit(
    jax_sparse._encode_words, static_argnames=("k", "canonical", "pallas")
)


def port_words(bases: np.ndarray, n_own: int, k: int, canonical: bool):
    return sparse_ops.encode_words(torch.from_numpy(bases), n_own, k, canonical)


@pytest.mark.parametrize("kind", ["nrich", "homopolymer", "n_own"])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_encode_words_matches_jax_plain(k, canonical, kind):
    bases, n_own = make_stream(kind, k)
    got = unsigned(port_words(bases, n_own, k, canonical))
    ref = [
        np.asarray(w)
        for w in _jax_plain(
            jnp.asarray(bases), jnp.int32(n_own), k=k, canonical=canonical,
            pallas=None,
        )
    ]
    n = T - k + 1
    assert len(got) == len(ref) == sparse_ops.key_words(k)
    for g, r in zip(got, ref, strict=True):
        assert g.shape == (T,) and g.dtype == r.dtype
        assert np.array_equal(g[:n], r)
        assert (g[n:] == np.iinfo(g.dtype).max).all()


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_encode_words_matches_jax_kernel_slot_for_slot(k, canonical):
    # The TPU kernel in interpret mode returns T rounded up to its tile
    # span: its first T slots equal the port's, and the rest are sentinels.
    bases, _ = make_stream("n_own", k)
    bases[1000:1064] = 3
    for n_own in (0, 1, T // 2, T - k + 1):
        got = unsigned(port_words(bases, n_own, k, canonical))
        hi, lo = rolling_codes_split_pallas(
            jnp.asarray(bases), jnp.int32(n_own), k, canonical, interpret=True
        )
        ref = [np.asarray(lo)] if hi is None else [np.asarray(hi), np.asarray(lo)]
        assert len(got) == len(ref)
        for g, r in zip(got, ref, strict=True):
            assert r.shape[0] >= T and g.dtype == r.dtype
            assert np.array_equal(g, r[:T]), n_own
            assert (r[T:] == np.iinfo(r.dtype).max).all()


@pytest.mark.parametrize("n", [0, 1, 20, 21, 22])
def test_encode_words_short_streams(n):
    # Streams shorter than k hold no window; every slot is a sentinel.
    bases = np.full(n, 2, np.uint8)
    hi, lo = unsigned(port_words(bases, n, 21, True))
    assert hi.shape == lo.shape == (n,)
    valid = lo != 0xFFFFFFFF
    assert valid.sum() == max(0, n - 20)
    assert (hi[~valid] == 0xFFFF).all()


def test_encode_stream_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        encode_cuda.encode_stream(torch.zeros(64, dtype=torch.uint8), 64, 21)


@pytest.mark.parametrize(
    "bad",
    [
        lambda b: b.to(torch.int32),
        lambda b: b.to(torch.int64),
        lambda b: b.to(torch.float32),
        lambda b: b.reshape(2, -1),
    ],
    ids=["int32", "int64", "float32", "rank"],
)
def test_encode_words_refuses_unsupported_input(bad):
    b = torch.from_numpy(make_stream("nrich", 21)[0])
    with pytest.raises(ValueError, match="uint8"):
        sparse_ops.encode_words(bad(b), T, 21)


@pytest.mark.parametrize("k", [0, 32])
def test_encode_words_refuses_bad_k(k):
    with pytest.raises(ValueError, match="k must be"):
        sparse_ops.encode_words(torch.zeros(64, dtype=torch.uint8), 64, k)
