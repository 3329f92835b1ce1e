"""K7's packed entry on the CPU: the plain version of
``histogram_cuda.hist_packed_small_cuda`` (the 2-bit packed batch ->
histogram, bins <= 64) against the JAX program it replaces on the card
(``models/engine._count_batch_acc_packed``: the unpack, then the bit-plane
Pallas kernel in interpret mode), its routing entry ``histogram_packed``,
the dense counters' packed k <= 3 route against the JAX package, and
Python models of the kernels' window arithmetic and of K5's 16-bit halves.
The kernels themselves are held against the plain version in
test_torch_cuda.py.

Integer counts: every comparison is exact (tolerance zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dna_kmeres_parallel_tpu as jax_pkg
import dna_kmeres_parallel_tpu_torch as port
from dna_kmeres_parallel_tpu.models import engine as jax_engine
from dna_kmeres_parallel_tpu.models.pipeline import StreamingCounter as JaxStreamingCounter
from dna_kmeres_parallel_tpu.utils import fasta
from dna_kmeres_parallel_tpu.utils.config import KmerConfig as JaxKmerConfig
from dna_kmeres_parallel_tpu_torch import KmerConfig, native
from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter
from dna_kmeres_parallel_tpu_torch.ops import encode as encode_ops
from dna_kmeres_parallel_tpu_torch.ops import histogram_cuda
from dna_kmeres_parallel_tpu_torch.utils import codec


def batch(kind: str) -> np.ndarray:
    """Seeded u8 streams whose lengths are multiples of 8 (the packed
    format's mask bytes) and not of 16."""
    if kind == "nrich":
        rng = np.random.default_rng(5)
        b = rng.integers(0, 4, 2056).astype(np.uint8)
        b[rng.random(b.size) < 0.15] = codec.INVALID_BASE
        b[600:640] = codec.INVALID_BASE
        return b
    if kind == "homopolymer":
        b = np.full(1048, 3, np.uint8)  # all T, then all A from 500 on
        b[500:] = 0
        return b
    return np.full(520, codec.INVALID_BASE, np.uint8)  # all invalid


@pytest.mark.parametrize("kind", ["nrich", "homopolymer", "invalid"])
@pytest.mark.parametrize("own", ["zero", "one", "T-k", "T"])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_plain_packed_matches_jax_packed_program(k, canonical, own, kind):
    bases = batch(kind)
    T = bases.size
    n_own = {"zero": 0, "one": 1, "T-k": T - k, "T": T}[own]
    data, mask, _ = native.pack_2bit_native(bases)
    acc = np.arange(4**k, dtype=np.int32)  # both add into an accumulator
    got = histogram_cuda.histogram_packed(
        torch.from_numpy(data), torch.from_numpy(mask), n_own, k, 4**k, canonical,
        torch.from_numpy(acc.copy()),
    )
    ref = jax_engine._count_batch_acc_packed(
        jnp.asarray(acc), jnp.asarray(data), jnp.asarray(mask), jnp.int32(n_own), k, 4**k,
        canonical, pallas="interpret",
    )
    assert got.dtype == torch.int32 and got.shape == (4**k,)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert int(got.sum()) - int(acc.sum()) <= min(n_own, T - k + 1)


def test_plain_packed_drops_codes_past_bins():
    # bins below 4^k keep codes < bins only, as the u8 entry does.
    bases = batch("nrich")
    data, mask, _ = native.pack_2bit_native(bases)
    got = histogram_cuda.histogram_packed(torch.from_numpy(data), torch.from_numpy(mask),
                                          bases.size, 3, 37)
    want = histogram_cuda.hist_u8_reference(torch.from_numpy(bases), bases.size, 3, 37)
    assert got.shape == (37,) and torch.equal(got, want)


def test_histogram_packed_routes_by_device():
    bases = batch("nrich")
    data, mask, _ = native.pack_2bit_native(bases)
    d, m = torch.from_numpy(data), torch.from_numpy(mask)
    launches = histogram_cuda.PACKED_LAUNCHES
    got = histogram_cuda.histogram_packed(d, m, bases.size, 3, 64)
    assert histogram_cuda.PACKED_LAUNCHES == launches  # the plain version ran
    assert torch.equal(got, histogram_cuda.hist_packed_small_reference(d, m, bases.size, 3, 64))
    with pytest.raises(ValueError, match="no histogram for device meta"):
        histogram_cuda.histogram_packed(d.to("meta"), m.to("meta"), bases.size, 3, 64)


def test_packed_wrappers_refuse_what_the_kernel_does_not_take():
    d, m = torch.zeros(16, dtype=torch.uint8), torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        histogram_cuda.hist_packed_small_cuda(d, m, 64, 3, 64)
    with pytest.raises(ValueError, match="mask bytes"):
        histogram_cuda.histogram_packed(d, m[:7], 64, 3, 64)
    with pytest.raises(ValueError, match="bins"):
        histogram_cuda.histogram_packed(d, m, 64, 4, 256)
    with pytest.raises(ValueError, match="uint8"):
        histogram_cuda.histogram_packed(d.to(torch.int32), m, 64, 3, 64)
    with pytest.raises(ValueError, match="acc"):
        histogram_cuda.histogram_packed(d, m, 64, 3, 64, acc=torch.zeros(63, dtype=torch.int32))


@pytest.fixture
def fasta_records(tmp_path, make_dna):
    records = [(f">r{i}", make_dna(700 + 97 * i, invalid_frac=0.03)) for i in range(5)]
    path = tmp_path / "in.fasta"
    fasta.write_fasta(path, records)
    return str(path), [s for _, s in records]


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_dense_counters_packed_route_match_jax(fasta_records, k, canonical):
    # KmerEngine (count_file) and StreamingCounter on the packed k <= 3
    # route, several batches, against the JAX package's.
    path, _ = fasta_records
    kw = dict(k=k, canonical=canonical, pack_input=True, batch_bases=512)
    got = port.count_file(path, device="cpu", **kw)
    ref = jax_pkg.count_file(path, **kw)
    assert np.array_equal(got.hist, np.asarray(ref.hist, np.int64))
    streamed = StreamingCounter(KmerConfig(**kw), device="cpu").run(path)
    jax_streamed = JaxStreamingCounter(JaxKmerConfig(**kw)).run(path)
    assert streamed.hist.dtype == np.int64
    assert np.array_equal(streamed.hist, np.asarray(jax_streamed.hist, np.int64))
    assert np.array_equal(streamed.hist, got.hist)


# ---------------------------------------------------------------------------
# The kernels' window arithmetic (csrc/histogram.cu count16, digits4,
# valid4), modelled bit for bit in Python integers
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def digit_rev32(x: int) -> int:
    return sum(((x >> (2 * j)) & 3) << (30 - 2 * j) for j in range(16))


def digits4(w: int) -> int:
    return (((w & 0x03030303) * 0x01041040) & M32) >> 24


def valid4(w: int) -> int:
    eq = sum(0xFF << (8 * i) for i in range(4) if (w >> (8 * i)) & 0xFC == 0)  # __vcmpeq4
    return (((eq & 0x01010101) * 0x01020408) & M32) >> 24


def count16_keys(d: int, v: int, k: int, canonical: bool) -> list:
    """(start, key) of each valid window of a run of 16 starts, as count16
    computes them (without the range and bins tests)."""
    dlo, dhi = d & M32, d >> 32
    rhi, rlo = digit_rev32(dlo), digit_rev32(dhi)
    wv = v
    for t in range(1, k):
        wv &= v >> t
    mask = (1 << (2 * k)) - 1
    out = []
    for j in range(16):
        key = ((((rhi << 32) | rlo) << (2 * j)) >> 32 & M32) >> (32 - 2 * k)
        if canonical:
            key = min(key, ~(((dhi << 32) | dlo) >> (2 * j)) & M32 & mask)
        if (wv >> j) & 1:
            out.append((j, key))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_window_arithmetic_model(seed):
    # 32 u8 bases -> digits4 / valid4 -> count16's keys equal the plain
    # version's rolling codes of the windows starting at 0..15, at every k.
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, 32).astype(np.uint8)
    bases[rng.random(32) < 0.1] = rng.choice([4, 0x7F, 0xFF, 0xFC])
    words = [int.from_bytes(bases[4 * i : 4 * i + 4].tobytes(), "little") for i in range(8)]
    d = sum(digits4(w) << (8 * i) for i, w in enumerate(words))
    v = sum(valid4(w) << (4 * i) for i, w in enumerate(words))
    assert d == sum(int(b & 3) << (2 * i) for i, b in enumerate(bases))
    assert v == sum(1 << i for i, b in enumerate(bases) if b < 4)
    t = torch.from_numpy(bases)
    for k in range(1, 16):
        codes, valid = encode_ops.rolling_codes(t, k)
        for canonical in (False, True):
            c = encode_ops.canonicalize(codes, k) if canonical else codes
            want = [(j, int(c[j])) for j in range(16) if valid[j]]
            assert count16_keys(d, v, k, canonical) == want, (k, canonical)


def valid16(inval_be: int) -> int:
    x = digit_rev32(inval_be)
    x = (x | (x >> 1)) & 0x55555555
    for shift, keep in ((1, 0x33333333), (2, 0x0F0F0F0F), (4, 0x00FF00FF), (8, 0x0000FFFF)):
        x = (x | (x >> shift)) & keep
    return ~x & 0xFFFF


@pytest.mark.parametrize("seed", range(4))
def test_plane_validity_model(seed):
    # K5's validity bits from an inval_be word of the encoder's planes.
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, 16).astype(np.uint8)
    bases[rng.random(16) < 0.3] = codec.INVALID_BASE
    _, inval_be = engine_planes(bases)
    want = sum(1 << j for j in range(16) if bases[j] < 4)
    assert valid16(int(inval_be[0]) & M32) == want


def engine_planes(bases: np.ndarray):
    from dna_kmeres_parallel_tpu_torch.models.engine import pack_planes_np

    return pack_planes_np(bases)


# ---------------------------------------------------------------------------
# K5's 16-bit halves at k = 8 (csrc/histogram.cu HalfHist), modelled
# ---------------------------------------------------------------------------

#: windows a block adds between two spills: kHalfRoundSteps steps of its
#: 1,024 threads x 16 windows
HALF_ROUND = 2 * 1024 * 16


def half_hist_model(adds) -> dict:
    """The counts that HalfHist leaves in acc for one block: ``adds`` is
    the block's (code, n) adds, in rounds of at most HALF_ROUND windows.
    Asserts that no half passes 2^16 - 1 (a carry into its neighbour)."""
    halves: dict = {}
    acc: dict = {}
    taken = 0
    for code, n in adds:
        assert 1 <= n <= 16
        if taken + n > HALF_ROUND:  # the round ends: spill at the barrier
            for c, h in halves.items():
                if h & 0x8000:
                    acc[c] = acc.get(c, 0) + 0x8000
                    halves[c] = h & 0x7FFF
            taken = 0
        halves[code] = halves.get(code, 0) + n
        assert halves[code] <= 0xFFFF, (code, halves[code])
        taken += n
    for c, h in halves.items():  # the flush widens what is left
        acc[c] = acc.get(c, 0) + h
    return acc


@pytest.mark.parametrize("kind", ["one code", "both halves of a word", "two words", "random"])
def test_half_hist_spill_model(kind):
    # Whatever a block adds, the spill every HALF_ROUND windows keeps each
    # half below 2^16 and the counts exact, also where one bin takes every
    # window of many rounds.
    rng = np.random.default_rng(3)
    n_adds = 40 * HALF_ROUND // 16
    if kind == "one code":
        codes = np.full(n_adds, 40961)
    elif kind == "both halves of a word":
        codes = np.where(np.arange(n_adds) % 3 == 0, 2, 3)
    elif kind == "two words":
        codes = rng.choice([10, 65535], n_adds, p=[0.9, 0.1])
    else:
        codes = rng.integers(0, 8, n_adds)
    ns = rng.integers(1, 17, n_adds)
    want: dict = {}
    for c, n in zip(codes.tolist(), ns.tolist()):
        want[c] = want.get(c, 0) + n
    assert half_hist_model(zip(codes.tolist(), ns.tolist())) == want
