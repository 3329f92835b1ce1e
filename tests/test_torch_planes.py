"""The port's host plane staging is bit-identical to the JAX package's, so
both packages encode from the same planes."""

import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu.models import engine as jax_engine
from dna_kmeres_parallel_tpu.ops import encode_pallas as jax_enc
from dna_kmeres_parallel_tpu.utils import codec
from dna_kmeres_parallel_tpu_torch.models import engine
from dna_kmeres_parallel_tpu_torch.ops import encode_cuda


def padded_stream(rng, length: int) -> np.ndarray:
    """N-rich u8 stream of `length` bases padded with INVALID_BASE to a
    multiple of 16 (the engine pads batches the same way)."""
    b = rng.integers(0, 4, length).astype(np.uint8)
    b[rng.random(length) < 0.1] = codec.INVALID_BASE
    if length > 40:
        b[length // 3 : length // 3 + 25] = codec.INVALID_BASE
    out = np.full(-(-length // 16) * 16, codec.INVALID_BASE, np.uint8)
    out[:length] = b
    return out


@pytest.mark.parametrize("length", [1, 17, 333, 1001, 4095, 5003])
def test_host_planes_match_jax(length):
    rng = np.random.default_rng(length)
    data, mask, _ = codec.pack_bases(padded_stream(rng, length))
    got = encode_cuda.host_planes_from_packfmt(data, mask)
    ref = jax_enc.host_planes_from_packfmt(data, mask)
    for g, r in zip(got, ref, strict=True):
        assert g.dtype == r.dtype == np.uint32
        assert np.array_equal(g, r)


@pytest.mark.parametrize("length", [17, 1001, 5003])
def test_pack_planes_np_matches_jax(length):
    padded = padded_stream(np.random.default_rng(7 + length), length)
    got = engine.pack_planes_np(padded)
    ref = jax_engine.pack_planes_np(padded)
    for g, r in zip(got, ref, strict=True):
        assert g.dtype == r.dtype
        assert np.array_equal(g, r)


def test_rev16_digits_matches_jax():
    x = np.random.default_rng(3).integers(0, 1 << 32, 4096, dtype=np.uint64)
    x = x.astype(np.uint32)
    got = encode_cuda.rev16_digits_np(x)
    assert got.dtype == np.uint32
    assert np.array_equal(got, jax_enc._rev16_digits_np(x))
    assert np.array_equal(encode_cuda.rev16_digits_np(got), x)


def test_stage_batch_planes_cpu_holds_the_plane_bits():
    padded = padded_stream(np.random.default_rng(11), 2048)
    w, iv = engine.stage_batch_planes(padded, torch.device("cpu"))
    ref = jax_engine.pack_planes_np(padded)
    for t, r in zip((w, iv), ref, strict=True):
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        assert np.array_equal(t.numpy().view(np.uint32), r)
