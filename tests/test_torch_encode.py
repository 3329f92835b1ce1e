"""K1, the packed-plane window encoder: the port's plain version (the CPU
route of ``encode_words_planes``) against the JAX package. The CUDA
kernel is held against the plain version in test_torch_cuda.py.

Integer codes: every comparison is exact (tolerance zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu.ops import sparse as jax_sparse
from dna_kmeres_parallel_tpu.utils import codec
from dna_kmeres_parallel_tpu_torch.models import engine
from dna_kmeres_parallel_tpu_torch.ops import encode_cuda
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops

KS = [1, 11, 13, 15, 16, 21, 23, 24, 31]
T = 2048

# The JAX plain encode, jitted so each (k, canonical) compiles once.
_jax_plain = jax.jit(
    jax_sparse._encode_words, static_argnames=("k", "canonical", "pallas")
)


def make_stream(kind: str, k: int) -> tuple[np.ndarray, int]:
    """(u8 base stream [T], n_own) for one input kind."""
    rng = np.random.default_rng(KS.index(k) * 7 + len(kind))
    b = rng.integers(0, 4, T).astype(np.uint8)
    n_own = T - k + 1
    if kind == "nrich":
        b[rng.random(T) < 0.1] = codec.INVALID_BASE
        b[700:760] = codec.INVALID_BASE
    elif kind == "homopolymer":
        b[rng.random(T) < 0.01] = codec.INVALID_BASE
        b[1000:1064] = 3  # all-T: at k=16, lo == 0xFFFFFFFF and hi == 0
    elif kind == "n_own":
        b[rng.random(T) < 0.02] = codec.INVALID_BASE
        n_own = T - 300
    b[-3:] = codec.INVALID_BASE
    return b, n_own


def port_words(bases: np.ndarray, n_own: int, k: int, canonical: bool):
    planes = engine.stage_batch_planes(bases, torch.device("cpu"))
    return sparse_ops.encode_words_planes(*planes, n_own, k, canonical)


def unsigned(words) -> list[np.ndarray]:
    out = []
    for w in words:
        a = w.numpy()
        out.append(a.view(np.uint16 if a.dtype == np.int16 else np.uint32))
    return out


def codes64(words) -> np.ndarray:
    """Sorted u64 codes of the valid windows of an unsigned word tuple."""
    words = [np.asarray(w) for w in words]
    if len(words) == 1:
        lo = words[0]
        return np.sort(lo[lo != 0xFFFFFFFF].astype(np.uint64))
    hi, lo = words
    m = hi != np.iinfo(hi.dtype).max
    return np.sort((hi[m].astype(np.uint64) << np.uint64(32)) | lo[m])


@pytest.mark.parametrize("kind", ["nrich", "homopolymer", "n_own"])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_encode_matches_jax_plain(k, canonical, kind):
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
        assert g.shape == (T,)
        assert g.dtype == r.dtype
        assert np.array_equal(g[:n], r)
        assert (g[n:] == np.iinfo(g.dtype).max).all()
    if kind == "homopolymer" and k == 16:
        # The all-T 16-mer: lo is all-ones, and only hi == 0 marks it valid
        # (canonical folds it onto all-A, code 0).
        win = np.lib.stride_tricks.sliding_window_view(bases, 16)
        all_t = (win == 3).all(axis=1)
        if canonical:
            want = (all_t | (win == 0).all(axis=1)).sum()
            lo_val = 0
        else:
            want = all_t.sum()
            lo_val = 0xFFFFFFFF
        assert want >= 64 - 16 + 1
        assert ((got[1] == lo_val) & (got[0] == 0)).sum() == want


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_encode_matches_jax_kernel_multiset(k, canonical):
    bases, n_own = make_stream("n_own", k)
    bases[1000:1064] = 3
    got = port_words(bases, n_own, k, canonical)
    hi_dt = sparse_ops.hi_dtype(k)
    if hi_dt is None:
        assert len(got) == 1 and jax_sparse.hi_dtype(k) is None
    else:
        assert got[0].dtype == hi_dt
        assert got[0].element_size() == np.dtype(jax_sparse.hi_dtype(k)).itemsize
    assert got[-1].dtype == torch.int32
    planes = engine.pack_planes_np(bases)
    ref = jax_sparse.encode_words_planes(
        *(jnp.asarray(p) for p in planes), jnp.int32(n_own), k, canonical,
        interpret=True,
    )
    assert np.array_equal(codes64(unsigned(got)), codes64(ref))


def test_encode_packed_refuses_cpu_tensors():
    planes = engine.stage_batch_planes(
        make_stream("nrich", 21)[0], torch.device("cpu")
    )
    with pytest.raises(ValueError, match="CUDA"):
        encode_cuda.encode_packed(*planes, T, 21)


@pytest.mark.parametrize(
    "bad",
    [
        lambda w, iv: (w.to(torch.int64), iv),
        lambda w, iv: (w, iv[:-1]),
        lambda w, iv: (w.reshape(2, -1), iv.reshape(2, -1)),
    ],
    ids=["dtype", "shape", "rank"],
)
def test_encode_rejects_malformed_planes(bad):
    planes = engine.stage_batch_planes(
        make_stream("nrich", 13)[0], torch.device("cpu")
    )
    with pytest.raises(ValueError):
        sparse_ops.encode_words_planes(*bad(*planes), T, 13)
