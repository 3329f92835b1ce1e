"""The device-sort route (``device_sort=True``, ``sort_row_len``,
``compact="device-rle"``) on the CPU, where the kernels' plain versions
stand in for K1, K9 and K11: the host compactors against their JAX twins
on the same host arrays, the sort programs' rows (sorted, and holding the
windows' multiset), and ``SparseKmerEngine`` and ``StreamingCounter``
tables against the JAX package, the oracle and a resume.

The port's encoders emit windows in natural order and the TPU kernels a
residue-permuted one, so rows are compared as bags and tables exactly.
Integer codes: the tolerance is zero."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu.models import oracle
from dna_kmeres_parallel_tpu.models import sparse_engine as jse
from dna_kmeres_parallel_tpu.models.pipeline import StreamingCounter as JaxStreamingCounter
from dna_kmeres_parallel_tpu.ops import sparse as jsparse
from dna_kmeres_parallel_tpu.utils import codec, fasta
from dna_kmeres_parallel_tpu.utils.config import KmerConfig as JaxKmerConfig
from dna_kmeres_parallel_tpu_torch import KmerConfig
from dna_kmeres_parallel_tpu_torch.models import sparse_engine as pse
from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter
from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseKmerEngine
from dna_kmeres_parallel_tpu_torch.ops import sparse as psparse

KS = (1, 11, 13, 15, 16, 21, 23, 24, 31)
BATCH = 2048


def seqs_for(k: int) -> list[str]:
    """Four N-rich records, about 5.1 kbase (three 2,048-base batches):
    one repeats a stretch of another, and one holds an all-T run (at k=16
    the all-T k-mer's lo word is all ones, like the sentinel)."""
    rng = np.random.default_rng(200 + k)
    alphabet = np.array(list("ACGTN"))
    out = []
    for n in (1100, 1500, 2100):
        out.append("".join(alphabet[rng.choice(5, size=n, p=[0.24] * 4 + [0.04])]))
    out.append(out[1][200:500] + "T" * 40 + out[0][:60])
    return out


@functools.cache
def jax_table(k: int, canonical: bool) -> tuple[np.ndarray, np.ndarray]:
    """The JAX package's table of seqs_for(k), by its own device-sort route."""
    cfg = JaxKmerConfig(k=k, canonical=canonical, batch_bases=BATCH, device_sort=True)
    res = jse.SparseKmerEngine(cfg).count_sequences(seqs_for(k))
    return res.codes, res.counts


@functools.cache
def fasta_for(tmp_dir, k: int) -> str:
    path = tmp_dir / f"k{k}.fasta"
    fasta.write_fasta(path, [(f">r{i}", s) for i, s in enumerate(seqs_for(k))])
    return str(path)


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("device_sort")


def same(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def host(words) -> tuple[np.ndarray, ...]:
    """Port word planes -> the unsigned NumPy words they hold."""
    return pse.fetch_words(words)


def stream_for(k: int, n: int = 3000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + k)
    b = rng.integers(0, 4, n).astype(np.uint8)
    b[rng.random(n) < 0.03] = codec.INVALID_BASE
    b[500:800] = 0  # a run of duplicates
    b[900:940] = 3  # all-T k-mers
    return b


# ---------------------------------------------------------------------------
# The host half against the JAX package's, on the same host arrays


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("k", KS)
def test_compact_table_equals_jax(k, rows):
    b = stream_for(k)
    if rows:
        words = jsparse.sort_words_rows(jnp.asarray(b), jnp.int32(2900), k, row_len=128,
                                        pallas_sort=False)
    else:
        words = jsparse.sort_words(jnp.asarray(b), jnp.int32(2900), k)
    words = tuple(np.asarray(w) for w in words)
    assert words[-1].ndim == (2 if rows else 1)
    want = jse.compact_table(words)
    assert want[0].size > 0 and same(pse.compact_table(words), want)


@pytest.mark.parametrize("k", KS)
def test_compact_starts_and_rle_equal_jax(k):
    b = stream_for(k)
    words, starts = jsparse.sort_unique_starts(jnp.asarray(b), jnp.int32(2900), k, True)
    words = tuple(np.asarray(w) for w in words)
    want = jse.compact_starts(words, np.asarray(starts))
    assert same(pse.compact_starts(words, np.asarray(starts)), want)
    hi, lo, counts, starts = (np.asarray(a) for a in jsparse.sort_unique_counts(
        jnp.asarray(b), jnp.int32(2900), k, True))
    got = pse.compact_rle(hi, lo, counts, starts)
    assert same(got, jse.compact_rle(hi, lo, counts, starts)) and same(got, want)
    # The port's own programs give the same table through the same compactors.
    bt = torch.from_numpy(b)
    words, starts = psparse.sort_unique_starts(bt, 2900, k, True)
    assert same(pse.compact_starts(host(words), starts.numpy()), want)
    hi, lo, counts, starts = psparse.sort_unique_counts(bt, 2900, k, True)
    got = pse.compact_rle(hi.numpy().view(np.uint32), lo.numpy().view(np.uint32),
                          counts.numpy(), starts.numpy())
    assert same(got, want)


@pytest.mark.parametrize("k", KS)
def test_table_from_rle_equals_jax(k):
    b = stream_for(k)
    words_c, counts, n_distinct = jsparse.sort_words_rle(jnp.asarray(b), jnp.int32(2900), k)
    want = jse.table_from_rle(words_c, counts, n_distinct)

    def t(a):
        a = np.asarray(a)
        return torch.from_numpy(a.view(np.int16 if a.dtype == np.uint16 else np.int32).copy())

    got = pse.table_from_rle(tuple(t(w) for w in words_c), t(counts), t(n_distinct))
    assert want[0].size > 0 and same(got, want)


def test_table_from_rle_all_invalid():
    flat = torch.full((300,), codec.INVALID_BASE, dtype=torch.uint8)
    for k in (11, 21, 31):
        words_c, counts, n_distinct = psparse.sort_words_rle(flat, 300, k)
        assert int(n_distinct) == 0
        codes, cnts = pse.table_from_rle(words_c, counts, n_distinct)
        assert codes.size == 0 and cnts.size == 0 and codes.dtype == np.uint64


# ---------------------------------------------------------------------------
# The sort programs: each row ascending (unsigned), sentinels last, and the
# rows together hold the encoder's multiset of windows


def unsigned_codes(words) -> np.ndarray:
    """Word planes -> one u64 code per window (all ones where invalid)."""
    h = host(words)
    if len(h) == 1:
        return h[0].astype(np.uint64)
    return jsparse.merged_code64(h[0], h[1])


@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("row_len", [0, 128, 2048])
@pytest.mark.parametrize("k", KS)
def test_sort_programs_rows_are_sorted_bags(k, row_len, planes):
    b = stream_for(k, 4096)
    n_own = 4000
    if planes:
        staged = tuple(torch.from_numpy(p.view(np.int32)) for p in
                       pse.stage_words(b, True))
        enc = psparse.encode_words_planes(*staged, n_own, k, True)
        got = (psparse.sort_words_rows_planes(*staged, n_own, k, True, row_len=row_len,
                                              pallas_sort=True)
               if row_len else psparse.sort_words_planes(*staged, n_own, k, True))
    else:
        bt = torch.from_numpy(b)
        enc = psparse.encode_words(bt, n_own, k, True)
        got = (psparse.sort_words_rows(bt, n_own, k, True, row_len=row_len, pallas_sort=True)
               if row_len else psparse.sort_words(bt, n_own, k, True))
    codes = unsigned_codes(got)
    sentinel = np.uint64(0xFFFFFFFF if k <= 15 else
                         (0xFFFF << 32 | 0xFFFFFFFF) if k <= 23 else 2**64 - 1)
    if row_len:
        assert codes.shape == (-(-n_own // row_len), row_len)
    else:
        assert codes.shape == (n_own,)
        codes = codes[None]
    # Each row ascends, and its invalid windows are the sentinel tail.
    for r in codes:
        assert np.array_equal(r, np.sort(r))
        tail = r == sentinel
        assert not tail.any() or tail[np.argmax(tail):].all()
    # The rows hold the owned windows' multiset, padded with sentinels.
    full = np.sort(codes.reshape(-1))
    assert np.array_equal(full[:n_own], np.sort(unsigned_codes(enc)[:n_own]))
    assert (full[n_own:] == sentinel).all()


# ---------------------------------------------------------------------------
# The engines against the JAX package


@pytest.mark.parametrize("pallas_sort", [False, True])
@pytest.mark.parametrize("pack_input", [True, False])
@pytest.mark.parametrize("row_len", [0, 128, 2048])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_engine_device_sort_equals_jax(k, canonical, row_len, pack_input, pallas_sort):
    cfg = KmerConfig(k=k, canonical=canonical, batch_bases=BATCH, device_sort=True,
                     sort_row_len=row_len, pack_input=pack_input)
    res = SparseKmerEngine(cfg, device="cpu", pallas_sort=pallas_sort).count_sequences(
        seqs_for(k))
    assert same((res.codes, res.counts), jax_table(k, canonical))
    assert res.phases["sort"] >= 0.0


@pytest.mark.parametrize("pallas_sort", [False, True])
@pytest.mark.parametrize("row_len", [0, 128, 2048])
@pytest.mark.parametrize("k", KS)
def test_streaming_device_sort_equals_jax(tmp_dir, k, row_len, pallas_sort):
    canonical = k % 2 == 1
    cfg = KmerConfig(k=k, canonical=canonical, batch_bases=BATCH, device_sort=True,
                     sort_row_len=row_len, pack_input=k % 4 != 1, compact="device",
                     dense_bins_limit=1)
    res = StreamingCounter(cfg, device="cpu", pallas_sort=pallas_sort).run(fasta_for(tmp_dir, k))
    assert same((res.codes, res.counts), jax_table(k, canonical))


def test_device_sort_none_and_false_do_not_sort(monkeypatch):
    # The port always has its native compactor, so None (and False) keep
    # the unsorted route.
    calls = []
    monkeypatch.setattr(psparse, "sort_encoded", lambda *a, **kw: calls.append(1))
    for device_sort in (None, False):
        cfg = KmerConfig(k=21, batch_bases=BATCH, device_sort=device_sort)
        res = SparseKmerEngine(cfg, device="cpu").count_sequences(seqs_for(21))
        assert same((res.codes, res.counts), jax_table(21, False))
    assert calls == []


@pytest.mark.parametrize("k", [11, 21, 31])
@pytest.mark.parametrize("pack_input", [True, False])
def test_device_rle_equals_jax_and_oracle_on_duplicated_input(tmp_path, k, pack_input):
    rng = np.random.default_rng(k)
    core = "".join(rng.choice(list("ACGT"), size=200))
    records = [(f">r{i}", core) for i in range(6)]
    records.append((">x", "".join(rng.choice(list("ACGTN"), size=333))))
    path = tmp_path / "dup.fasta"
    fasta.write_fasta(path, records)
    kw = dict(k=k, batch_bases=512, compact="device-rle", pack_input=pack_input)
    got = StreamingCounter(KmerConfig(**kw, dense_bins_limit=1), device="cpu").run(str(path))
    want = JaxStreamingCounter(JaxKmerConfig(**kw, dense_bins_limit=1)).run(str(path))
    assert same((got.codes, got.counts), (want.codes, want.counts))
    assert got.table() == oracle.count_table_any_k([s for _, s in records], k)
    assert int(got.counts.max()) >= 6


def test_device_rle_all_invalid(tmp_path):
    path = tmp_path / "n.fasta"
    fasta.write_fasta(path, [(">a", "N" * 700), (">b", "ACG"), (">c", "N" * 900)])
    res = StreamingCounter(KmerConfig(k=21, batch_bases=512, compact="device-rle"),
                           device="cpu").run(str(path))
    assert res.codes.size == 0 and res.counts.size == 0 and res.n_seqs == 3


# ---------------------------------------------------------------------------
# Stop and resume on the device-sort and rle arms


@pytest.mark.parametrize("stop", [1, 2])
@pytest.mark.parametrize(
    "kw", [{"device_sort": True}, {"device_sort": True, "sort_row_len": 0},
           {"compact": "device-rle"}, {"device_sort": True, "pack_input": False}],
)
@pytest.mark.parametrize("k", [13, 21, 31])
def test_stop_and_resume(tmp_dir, tmp_path, k, kw, stop):
    cfg = KmerConfig(k=k, batch_bases=BATCH, dense_bins_limit=1,
                     **{"compact": "device", **kw})
    ckpt = str(tmp_path / "c.npz")
    path = fasta_for(tmp_dir, k)
    first = StreamingCounter(cfg, device="cpu", checkpoint_path=ckpt, max_batches=stop,
                             pallas_sort=True)
    first.run(path)
    assert first.metrics.counters["batches"] == stop
    sc = StreamingCounter(cfg, device="cpu", checkpoint_path=ckpt, pallas_sort=True)
    res = sc.run(path)
    assert sc.metrics.counters["resumed_from_base"] == stop * BATCH
    assert same((res.codes, res.counts), jax_table(k, False))
