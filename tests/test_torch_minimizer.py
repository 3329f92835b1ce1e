"""K1m, K1 with its minimizer plane: the port's plain version (the CPU
route of ``encode_words_planes(..., minimizer_m=m)``) against the JAX
package's positional minimizer scan and its packed kernel in interpret
mode. The CUDA kernel is held against the plain version in
test_torch_cuda.py.

Integer codes: every comparison is exact (tolerance zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu.ops.encode_pallas import rolling_codes_split_packed_pallas
from dna_kmeres_parallel_tpu.parallel import bucketed as jax_bucketed
from dna_kmeres_parallel_tpu.utils import codec
from dna_kmeres_parallel_tpu_torch.models import engine
from dna_kmeres_parallel_tpu_torch.ops import encode_cuda
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops

T = 2048
INT32_MAX = 2**31 - 1
#: (k, m): every m of {7, 11, 15} below k, for k in {17, 21, 31}
CASES = [(k, m) for k in (17, 21, 31) for m in (7, 11, 15) if m < k]


def make_stream(seed: int) -> np.ndarray:
    """Seeded u8 stream [T]: 3% N, two N runs, an all-A and an all-T run
    (ties between equal m-mers), and an N tail."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, T).astype(np.uint8)
    b[rng.random(T) < 0.03] = codec.INVALID_BASE
    b[400:450] = codec.INVALID_BASE
    b[1200:1203] = codec.INVALID_BASE
    b[700:790] = 0
    b[1500:1560] = 3
    b[-5:] = codec.INVALID_BASE
    return b


def port_planes(bases):
    return engine.stage_batch_planes(bases, torch.device("cpu"))


@pytest.mark.parametrize("n_own", [T, T - 333, 1])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,m", CASES)
def test_minimizers_match_jax_positional_scan(k, m, canonical, n_own):
    bases = make_stream(k * 31 + m)
    hi, lo, mins = encode_cuda.encode_packed_reference(
        *port_planes(bases), n_own, k, canonical, minimizer_m=m
    )
    assert mins.dtype == torch.int32 and mins.shape == (T,)
    mini, _, vwin = jax_bucketed.window_minimizers_pos(jnp.asarray(bases), k, m)
    n = T - k + 1
    want_valid = np.asarray(vwin) & (np.arange(n) < n_own)
    valid = (hi != -1).numpy()
    assert np.array_equal(valid[:n], want_valid) and not valid[n:].any()
    got = mins.numpy()
    # The forward minimizer at every valid window, canonical or not.
    assert np.array_equal(got[:n][want_valid], np.asarray(mini)[want_valid])
    # The port's convention: INT32_MAX at every invalid or unowned window.
    assert (got[:n][~want_valid] == INT32_MAX).all() and (got[n:] == INT32_MAX).all()
    if n_own == T:
        assert want_valid.sum() > 500


def triples(hi, lo, mins) -> np.ndarray:
    """Sorted (code, minimizer) pairs of the valid windows, as u64 rows."""
    hi, lo, mins = (np.asarray(a) for a in (hi, lo, mins))
    valid = hi != np.iinfo(hi.dtype).max
    code = (hi[valid].astype(np.uint64) << np.uint64(32)) | lo[valid].astype(np.uint64)
    rows = np.stack([code, mins[valid].astype(np.uint64)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,m", CASES)
def test_minimizers_match_jax_kernel_multiset(k, m, canonical):
    # The JAX kernel emits a residue-permuted order padded to its tile:
    # compare the multisets of (code, minimizer) at valid windows.
    bases = make_stream(k + m)
    n_own = T - 100
    hi, lo, mins = encode_cuda.encode_packed_reference(
        *port_planes(bases), n_own, k, canonical, minimizer_m=m
    )
    planes = engine.pack_planes_np(bases)
    jhi, jlo, jmins = rolling_codes_split_packed_pallas(
        *(jnp.asarray(p) for p in planes), jnp.int32(n_own), k, canonical,
        interpret=True, words_le=True, minimizer_m=m,
    )
    got = triples(hi.numpy().view(np.uint16 if k <= 23 else np.uint32),
                  lo.numpy().view(np.uint32), mins.numpy())
    want = triples(np.asarray(jhi), np.asarray(jlo), np.asarray(jmins))
    assert got.shape[0] > 500 and np.array_equal(got, want)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [16, 21, 23, 31])
def test_minimizer_plane_leaves_the_words_alone(k, canonical):
    planes = port_planes(make_stream(k))
    words = sparse_ops.encode_words_planes(*planes, T - 7, k, canonical)
    words_m, mins = sparse_ops.encode_words_planes(*planes, T - 7, k, canonical, minimizer_m=7)
    assert len(words) == len(words_m) == 2 and mins.dtype == torch.int32
    for a, b in zip(words, words_m, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("k,m", [(21, 0), (21, 16), (31, 16), (13, 13), (13, 14), (1, 1)])
def test_minimizer_m_is_checked_like_jax(k, m):
    planes = port_planes(make_stream(3))
    with pytest.raises(ValueError, match="minimizer_m"):
        encode_cuda.encode_packed_reference(*planes, T, k, minimizer_m=m)
    with pytest.raises(ValueError, match="minimizer_m"):
        sparse_ops.encode_words_planes(*planes, T, k, minimizer_m=m)
    with pytest.raises(ValueError, match="minimizer_m"):
        rolling_codes_split_packed_pallas(
            *(jnp.asarray(p) for p in engine.pack_planes_np(make_stream(3))),
            jnp.int32(T), k, interpret=True, words_le=True, minimizer_m=m,
        )


def test_minimizer_kernel_refuses_cpu_tensors():
    planes = port_planes(make_stream(4))
    with pytest.raises(ValueError, match="CUDA"):
        encode_cuda.encode_packed(*planes, T, 21, minimizer_m=7)


def test_minimizer_single_word_band():
    # k <= 15: no hi plane; validity from lo's sentinel.
    bases = make_stream(5)
    (lo,), mins = sparse_ops.encode_words_planes(*port_planes(bases), T, 13, minimizer_m=5)
    mini, _, vwin = jax_bucketed.window_minimizers_pos(jnp.asarray(bases), 13, 5)
    n = T - 12
    valid = np.asarray(vwin)
    assert np.array_equal((lo != -1).numpy()[:n], valid)
    assert np.array_equal(mins.numpy()[:n][valid], np.asarray(mini)[valid])
