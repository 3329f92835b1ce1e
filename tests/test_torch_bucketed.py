"""The bucket-sharded count: the port on a local mesh of 8 CPU shards
against the JAX package on its 8-device virtual CPU mesh, case by case as
tests/test_bucketed.py has them: the aggregated, raw (row and global
routes, prefix and minimizer owners, staged planes and u8 shards),
super-k-mer and auto exchanges, their overflow decisions and fallbacks,
non-power-of-two meshes, the k=16 lo-owner band, empty inputs, the
helpers that decide owners and capacities, and a 2-process gloo process
group.

The port emits windows in natural order where the JAX kernels emit a
residue-permuted one, so received planes are compared as per-owner
multisets and tables exactly. Integer codes: the tolerance is zero."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu.models import oracle
from dna_kmeres_parallel_tpu.ops import sparse as jax_sparse
from dna_kmeres_parallel_tpu.parallel import bucketed as jb
from dna_kmeres_parallel_tpu.parallel import sharded_sparse as jax_sharded
from dna_kmeres_parallel_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dna_kmeres_parallel_tpu.utils import codec
from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseKmerEngine
from dna_kmeres_parallel_tpu_torch.parallel import bucketed as pb
from dna_kmeres_parallel_tpu_torch.parallel.mesh import (
    LocalMesh,
    ProcessGroupMesh,
    make_mesh,
)
from dna_kmeres_parallel_tpu_torch.parallel.sharded_sparse import stage_shard_planes
from dna_kmeres_parallel_tpu_torch.utils.config import KmerConfig

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jmesh8():
    return jax_make_mesh(8)


@pytest.fixture(scope="module")
def mesh8():
    return LocalMesh(8, "cpu")


def _flat(seqs):
    return codec.concat_with_sentinels(seqs)


def same(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def as_dict(table, k):
    return {codec.code_to_kmer(int(c), k): int(n) for c, n in zip(*table)}


def host_table(flat, k, canonical=False):
    return native.count_sparse_host_native(flat, k, canonical)


# ---------------------------------------------------------------------------
# Helpers that decide owners and capacities


def test_owner_bits_and_capacities_equal_jax():
    for D in range(1, 10):
        for k in range(1, 32):
            assert pb._owner_bits(k, D) == jb._owner_bits(k, D), (k, D)
            for m in range(1, k):
                for n in (1, 777, 1 << 20):
                    assert pb._superkmer_capacity(n, D, k, m) == jb._superkmer_capacity(
                        n, D, k, m)
        for canonical in (False, True):
            for n in (1, 63, 1000, 12345, 1 << 24):
                assert pb._capacity(n, D, canonical) == jb._capacity(n, D, canonical)
            for row_len in (256, 512, 2048, 16384):
                row_len = max(row_len, 64 * D)
                cap_mult = 4 if canonical else 2
                want = min(jb._round_up(-(-cap_mult * row_len // D), 128), row_len)
                assert pb.row_capacity(row_len, D, canonical) == want


def test_hash_and_prefix_owners_equal_jax():
    rng = np.random.default_rng(1)
    mini = rng.integers(0, 1 << 30, 5000).astype(np.int32)
    mini[:3] = [0, 2**31 - 1, 4**15 - 1]
    for D in range(1, 10):
        assert np.array_equal(pb._hash_owner(torch.from_numpy(mini), D).numpy(),
                              np.asarray(jb._hash_owner(jnp.asarray(mini), D)))
    for k in (8, 13, 15, 16, 17, 21, 23, 24, 31):
        n = 3000
        lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        hi_dt = jax_sparse.hi_dtype(k)
        hi = None if hi_dt is None else rng.integers(
            0, 1 << max(2 * (k - 16), 1), n).astype(np.dtype(hi_dt))
        valid = rng.random(n) < 0.9
        for D in range(1, 10):
            shift, t_bits, use_hi = jb._owner_bits(k, D)
            want = np.asarray(jb._route_owner(
                None, None if hi is None else jnp.asarray(hi), jnp.asarray(lo),
                jnp.asarray(valid), k, D, "prefix", 7, shift, t_bits, use_hi))
            thi = None if hi is None else torch.from_numpy(
                hi.view(np.int16 if hi.dtype == np.uint16 else np.int32))
            got = pb._route_owner(None, thi, torch.from_numpy(lo.view(np.int32)),
                                  torch.from_numpy(valid), k, D, "prefix", 7, shift,
                                  t_bits, use_hi)
            assert np.array_equal(got.numpy(), want), (k, D)


@pytest.mark.parametrize("D", [1, 5, 8])
@pytest.mark.parametrize("total_own", [None, 500])
def test_shard_stream_with_halo_equals_jax(make_dna, D, total_own):
    flat = _flat([make_dna(700, invalid_frac=0.02), make_dna(90)])
    got = pb.shard_stream_with_halo(flat, 21, LocalMesh(D, "cpu"), total_own)
    want = jb.shard_stream_with_halo(flat, 21, jax_make_mesh(D), total_own=total_own)
    assert all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want))
    empty = pb.shard_stream_with_halo(np.zeros(0, np.uint8), 21, LocalMesh(D, "cpu"))
    jempty = jb.shard_stream_with_halo(np.zeros(0, np.uint8), 21, jax_make_mesh(D))
    assert all(np.array_equal(g, w) for g, w in zip(empty, jempty))
    shards, _ = got
    assert all(np.array_equal(g, w) for g, w in zip(
        stage_shard_planes(shards), jax_sharded.stage_shard_planes(shards)))


def test_window_minimizers_equal_jax(make_dna):
    s = make_dna(400, invalid_frac=0.02) + "A" * 40 + make_dna(50)
    b = codec.encode_bases(s)
    for k, m in ((21, 7), (31, 15)):
        got = pb.window_minimizers_pos(torch.from_numpy(b), k, m)
        want = jb.window_minimizers_pos(jnp.asarray(b), k, m)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), (k, m)
        assert np.array_equal(pb.window_minimizers(torch.from_numpy(b), k, m).numpy(),
                              np.asarray(want[0]))


def test_window_minimizers_property(make_dna):
    # The minimizer is the min m-mer code over the window, computed apart.
    s = make_dna(200)
    k, m = 21, 7
    mini = pb.window_minimizers(torch.from_numpy(codec.encode_bases(s)), k, m).numpy()
    for i in range(0, len(s) - k + 1, 13):
        window = s[i : i + k]
        assert mini[i] == min(codec.kmer_to_code(window[j : j + m]) for j in range(k - m + 1))


# ---------------------------------------------------------------------------
# Meshes


def test_local_mesh_exchange_is_the_transpose():
    D, cap = 5, 3
    mesh = LocalMesh(D, "cpu")

    def shard_fn(s):
        # Row d, slot c of source s holds 100 s + 10 d + c.
        v = torch.arange(D)[:, None] * 10 + torch.arange(cap) + 100 * s
        return (v.to(torch.int32), v.to(torch.int16)), torch.tensor(s == 3)

    (a, b), flags = mesh.exchange(shard_fn)
    assert a.shape == (D, D * cap) and a.dtype == torch.int32 and b.dtype == torch.int16
    for d in range(D):
        for s in range(D):
            assert a[d, s * cap : (s + 1) * cap].tolist() == [100 * s + 10 * d + c
                                                                for c in range(cap)]
    assert torch.equal(a, b.to(torch.int32))
    assert mesh.max_reduce(flags) and not mesh.max_reduce(flags[:3])
    assert mesh.gather(["x"]) == ["x"] and mesh.local_shards == list(range(D))


def test_make_mesh():
    assert isinstance(make_mesh(4, "cpu"), LocalMesh) and make_mesh(4, "cpu").size == 4
    assert make_mesh(None, "cpu").size == 1
    with pytest.raises(ValueError):
        LocalMesh(0, "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        ProcessGroupMesh("cpu")


# ---------------------------------------------------------------------------
# The aggregated exchange


def port_agg(flat, k, mesh, canonical=False, owner_mode="prefix", staged=False):
    shards, n_own = pb.shard_stream_with_halo(flat, k, mesh)
    inputs = stage_shard_planes(shards) if staged else shards
    *out, overflow = pb.count_bucket_sharded(inputs, n_own, k, canonical, mesh, owner_mode,
                                             staged_planes=staged)
    return out, overflow


def jax_agg(flat, k, jmesh, canonical=False, owner_mode="prefix"):
    shards, n_own = jb.shard_stream_with_halo(flat, k, jmesh)
    *out, overflow = jb.count_bucket_sharded(jnp.asarray(shards), jnp.asarray(n_own), k,
                                             canonical, jmesh, owner_mode=owner_mode)
    return out, bool(overflow)


def check_agg(flat, k, mesh, jmesh, canonical=False, owner_mode="prefix", staged=(False, True)):
    """The port's aggregated exchange (u8 shards and staged planes) equals
    the JAX one owner by owner; returns the merged table."""
    jout, jov = jax_agg(flat, k, jmesh, canonical, owner_mode)
    assert not jov
    want_rows = [jb.gather_table(*(np.asarray(x)[d : d + 1] for x in jout))
                 for d in range(mesh.size)]
    for st in staged:
        out, ov = port_agg(flat, k, mesh, canonical, owner_mode, st)
        assert not ov
        for d in range(mesh.size):
            assert same(pb.gather_table(*(x[d : d + 1] for x in out)), want_rows[d]), (st, d)
        table = pb.gather_table(*out)
        assert same(table, jb.gather_table(*jout))
    return table


@pytest.mark.parametrize("k", [16, 17, 21, 31])
def test_aggregated_matches_jax(make_dna, mesh8, jmesh8, k):
    seqs = [make_dna(300 + 17 * i, invalid_frac=0.02) for i in range(4)]
    table = check_agg(_flat(seqs), k, mesh8, jmesh8)
    assert as_dict(table, k) == oracle.count_table_any_k(seqs, k)


def test_aggregated_canonical(make_dna, mesh8, jmesh8):
    seqs = [make_dna(500)]
    table = check_agg(_flat(seqs), 21, mesh8, jmesh8, canonical=True)
    assert as_dict(table, 21) == oracle.count_table_any_k(seqs, 21, canonical=True)


def test_aggregated_globally_sorted(make_dna, mesh8):
    # Prefix owners are the code's top bits: the owners' tables, in shard
    # order, concatenate to a globally sorted table.
    out, _ = port_agg(_flat([make_dna(800)]), 21, mesh8)
    codes = np.concatenate([pb.gather_table(*(x[d : d + 1] for x in out))[0]
                            for d in range(8)])
    assert np.all(np.diff(codes.view(np.int64)) > 0)


def test_aggregated_shard_boundary_halo(mesh8, jmesh8):
    table = check_agg(_flat(["A" * 1000]), 17, mesh8, jmesh8)
    assert table[0].shape == (1,) and int(table[1][0]) == 1000 - 17 + 1


def test_aggregated_matches_single_host_engine(make_dna, mesh8):
    seqs = [make_dna(400) for _ in range(3)]
    out, _ = port_agg(_flat(seqs), 21, mesh8, staged=True)
    single = SparseKmerEngine(KmerConfig(k=21), device="cpu").count_sequences(seqs)
    assert same(pb.gather_table(*out), (single.codes, single.counts))


@pytest.mark.parametrize("k", [17, 21, 31])
def test_aggregated_minimizer_matches_jax(make_dna, mesh8, jmesh8, k):
    seqs = [make_dna(300 + 11 * i, invalid_frac=0.02) for i in range(4)]
    table = check_agg(_flat(seqs), k, mesh8, jmesh8, owner_mode="minimizer")
    assert as_dict(table, k) == oracle.count_table_any_k(seqs, k)


def test_aggregated_minimizer_skewed_input(mesh8, jmesh8):
    # A homopolymer: every window shares one minimizer, hence one owner,
    # but the pre-aggregation collapses them to one pair: no overflow.
    table = check_agg(_flat(["A" * 2000]), 21, mesh8, jmesh8, owner_mode="minimizer")
    assert table[0].shape == (1,) and int(table[1][0]) == 2000 - 21 + 1


@pytest.mark.parametrize("n_dev,k", [(6, 21), (5, 24)])
def test_aggregated_non_pow2_devices(make_dna, n_dev, k):
    s = make_dna(900, invalid_frac=0.02)
    table = check_agg(codec.encode_bases(s), k, LocalMesh(n_dev, "cpu"), jax_make_mesh(n_dev))
    assert as_dict(table, k) == oracle.count_table_any_k([s], k)


def test_aggregated_k16_lo_owner_band(make_dna, mesh8, jmesh8):
    # k=16: hi has no bits; owners come from lo.
    assert pb._owner_bits(16, 8)[2] is False
    s = make_dna(600, invalid_frac=0.02)
    table = check_agg(codec.encode_bases(s), 16, mesh8, jmesh8)
    assert as_dict(table, 16) == oracle.count_table_any_k([s], 16)


def test_aggregated_non_pow2_no_overflow_at_scale(make_dna):
    s = make_dna(20000)
    table = check_agg(codec.encode_bases(s), 24, LocalMesh(5, "cpu"), jax_make_mesh(5),
                      staged=(True,))
    assert same(table, host_table(codec.encode_bases(s), 24))


# ---------------------------------------------------------------------------
# The raw exchange


def valid_codes(words, row) -> np.ndarray:
    """Sorted u64 codes of the valid words of one received row (port int
    tensors or JAX unsigned arrays)."""
    ws = [np.asarray(w.numpy() if isinstance(w, torch.Tensor) else w)[row] for w in words]
    ws = [w.view(np.uint16 if w.dtype in (np.int16, np.uint16) else np.uint32) for w in ws]
    if len(ws) == 1:
        lo = ws[0]
        return np.sort(lo[lo != 0xFFFFFFFF].astype(np.uint64))
    hi, lo = ws
    keep = hi != np.iinfo(hi.dtype).max
    return np.sort((hi[keep].astype(np.uint64) << np.uint64(32)) | lo[keep])


@pytest.mark.parametrize("k,canonical,owner_mode", [
    (13, False, "prefix"),
    (21, False, "prefix"),
    (21, True, "prefix"),
    (21, False, "minimizer"),
    (31, False, "prefix"),
    (31, False, "minimizer"),
])
def test_raw_exchange_matches_jax_and_oracle(make_dna, mesh8, jmesh8, k, canonical,
                                             owner_mode):
    # Every route of the port (staged planes or u8 shards, row or global)
    # gives the JAX package's table.
    seqs = [make_dna(140 + 29 * i, invalid_frac=0.02) for i in range(4)]
    flat = _flat(seqs)
    want = jb.count_bucket_sharded_raw(flat, k, canonical, jmesh8, owner_mode=owner_mode,
                                       pallas=None)
    assert as_dict(want, k) == oracle.count_table_any_k(seqs, k, canonical)
    for staged in (True, False):
        for row in (True, False):
            got = pb.count_bucket_sharded_raw(flat, k, canonical, mesh8, owner_mode=owner_mode,
                                              staged_planes=staged, row_partition=row,
                                              row_len=256)
            assert same(got, want), (staged, row)


_OWNER_CASES = [
    (13, False, "prefix"),   # single-word band: owners from lo's top bits
    (16, False, "minimizer"),  # u16 hi band: widened and narrowed again
    (21, True, "prefix"),
    (23, False, "minimizer"),
    (31, False, "prefix"),
    (31, True, "minimizer"),
]


@pytest.mark.parametrize(
    "k,canonical,owner_mode,staged,route",
    # Staged planes on both routes, u8 shards on the global route; the u8
    # row route (interpret-mode cost) at k=31.
    [(*case, True, route) for case in _OWNER_CASES for route in ("row", "global")]
    + [(*case, False, "global") for case in _OWNER_CASES]
    + [(*case, False, "row") for case in _OWNER_CASES if case[0] == 31],
)
def test_raw_exchange_per_owner_multisets_equal_jax(make_dna, mesh8, jmesh8, monkeypatch,
                                                    k, canonical, owner_mode, staged, route):
    # The received words of every owner, as multisets, against the JAX
    # exchange (its kernels in interpret mode wherever it runs them).
    monkeypatch.setenv("KMER_TPU_ROW_PARTITION_LEN", "256")
    seqs = [make_dna(150 + 31 * i, invalid_frac=0.02) for i in range(4)]
    flat = _flat(seqs)
    shards, n_own = pb.shard_stream_with_halo(flat, k, mesh8)
    row = route == "row"
    if staged:
        planes = stage_shard_planes(shards)
        jin = tuple(jnp.asarray(p) for p in planes)
        pin = planes
    else:
        jin, pin = jnp.asarray(shards), shards
    jwords, jov = jb.exchange_words_bucket_sharded(
        jin, jnp.asarray(n_own), k, canonical, jmesh8, owner_mode=owner_mode,
        pallas="interpret" if (staged or row) else None, staged_planes=staged,
        row_partition=row,
    )
    words, ov = pb.exchange_words_bucket_sharded(
        pin, n_own, k, canonical, mesh8, owner_mode=owner_mode, staged_planes=staged,
        row_partition=row, row_len=256,
    )
    assert not ov and not bool(jov)
    assert len(words) == len(jwords) == jax_sparse.key_words(k)
    if k > 15:
        assert words[0].dtype == (torch.int16 if k <= 23 else torch.int32)
    total = 0
    for d in range(8):
        got = valid_codes(words, d)
        assert np.array_equal(got, valid_codes(jwords, d)), d
        total += got.size
    assert total == sum(oracle.count_table_any_k(seqs, k, canonical).values())


def test_raw_matches_aggregated(make_dna, mesh8):
    flat = _flat([make_dna(600, invalid_frac=0.01)])
    raw = pb.count_bucket_sharded_raw(flat, 21, False, mesh8)
    out, ov = port_agg(flat, 21, mesh8, staged=True)
    assert not ov and same(raw, pb.gather_table(*out))


@pytest.mark.parametrize("staged", [True, False])
def test_raw_overflow_on_skew(mesh8, jmesh8, staged):
    # A homopolymer routes every window to one owner: the raw exchange's
    # window-denominated capacity overflows detectably. The global route
    # (the JAX package's without Pallas) holds 189 windows per owner of a
    # 500-window shard; the row route gives a shard this small one row of
    # 512 slots per owner, in the JAX package too, and overflows at 5,000.
    flat = codec.encode_bases("A" * 4000)
    with pytest.raises(OverflowError, match="raw exchange"):
        pb.count_bucket_sharded_raw(flat, 21, False, mesh8, staged_planes=staged,
                                    row_partition=False)
    with pytest.raises(OverflowError, match="raw exchange"):
        jb.count_bucket_sharded_raw(flat, 21, False, jmesh8, pallas=None)
    assert pb.count_bucket_sharded_raw(flat, 21, False, mesh8, staged_planes=staged)[1].tolist() \
        == [4000 - 20]
    with pytest.raises(OverflowError, match="raw exchange"):
        pb.count_bucket_sharded_raw(codec.encode_bases("A" * 40000), 21, False, mesh8,
                                    staged_planes=staged)


@pytest.mark.parametrize("k", [8, 13, 21, 31])
def test_raw_prefix_fast_matches_engine(make_dna, k):
    # 80 kbase with an all-T tail: at k >= 16 lo == 0xFFFFFFFF on valid
    # windows, which must still sort below the hi sentinel.
    flat = codec.encode_bases(make_dna(80_000, invalid_frac=0.01) + "T" * 40)
    got = pb.count_bucket_sharded_raw(flat, k, False, LocalMesh(8, "cpu"))
    want = SparseKmerEngine(KmerConfig(k=k), device="cpu").count_stream(flat, flat.size, 1)
    assert same(got, (want.codes, want.counts))
    assert same(got, jb.count_bucket_sharded_raw(flat, k, False, jax_make_mesh(8),
                                                 pallas=None))


def spy_exchange(monkeypatch, module):
    calls = []
    real = module.exchange_words_bucket_sharded

    def spy(*a, **kw):
        calls.append(kw.get("row_partition"))
        return real(*a, **kw)

    monkeypatch.setattr(module, "exchange_words_bucket_sharded", spy)
    return calls


def test_raw_positional_run_spreads_over_rows(make_dna, mesh8, monkeypatch):
    # A same-owner positional run (a homopolymer inside random data) does
    # not overflow the row route: row r holds windows r, r + n_rows, ...,
    # so the run spreads over every row of its shard. No degradation.
    seqs = [make_dna(30_000), "A" * 600, make_dna(30_000)]
    flat = _flat(seqs)
    calls = spy_exchange(monkeypatch, pb)
    got = pb.count_bucket_sharded_raw(flat, 21, False, mesh8, row_len=256)
    assert calls == [True]
    assert same(got, host_table(flat, 21))


def test_raw_tiny_shard_run_decision(make_dna, mesh8, jmesh8, monkeypatch):
    # JAX's own positional-run case: shards of ~251 windows, 251 of one
    # owner. The JAX row route pads each shard to its encoder tile (16,384
    # slots here), so its rows hold few real windows and it passes; the
    # port's one real row per shard overflows its 128 slots, and so does
    # the shard's global capacity (127): the raw exchange raises, and auto
    # falls back. The tables agree.
    monkeypatch.setenv("KMER_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("KMER_TPU_ROW_PARTITION", "1")
    monkeypatch.setenv("KMER_TPU_ROW_PARTITION_LEN", "256")
    seqs = [make_dna(700), "A" * 600, make_dna(700)]
    flat = _flat(seqs)
    jcalls = spy_exchange(monkeypatch, jb)
    want = jb.count_bucket_sharded_raw(flat, 21, False, jmesh8)
    assert jcalls == [None]
    calls = spy_exchange(monkeypatch, pb)
    with pytest.raises(OverflowError):
        pb.count_bucket_sharded_raw(flat, 21, False, mesh8, row_len=256)
    assert calls == [True, False]
    assert same(pb.count_bucket_auto(flat, 21, False, mesh8, row_len=256), want)
    assert as_dict(want, 21) == oracle.count_table_any_k(seqs, 21)


def test_raw_row_overflow_retries_global_then_raises(make_dna, mesh8, jmesh8, monkeypatch):
    # Value skew past every margin (~5,000 owner-0 windows per shard): both
    # packages try the row route, degrade once to the global route, then
    # raise.
    monkeypatch.setenv("KMER_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("KMER_TPU_ROW_PARTITION", "1")
    monkeypatch.setenv("KMER_TPU_ROW_PARTITION_LEN", "256")
    flat = _flat([make_dna(2000), "A" * 40000, make_dna(2000)])
    jcalls = spy_exchange(monkeypatch, jb)
    with pytest.raises(OverflowError):
        jb.count_bucket_sharded_raw(flat, 21, False, jmesh8)
    calls = spy_exchange(monkeypatch, pb)
    with pytest.raises(OverflowError):
        pb.count_bucket_sharded_raw(flat, 21, False, mesh8, row_len=256)
    assert jcalls == [None, False] and calls == [True, False]


def test_raw_phases_are_recorded(make_dna, mesh8):
    phases = {}
    pb.count_bucket_sharded_raw(_flat([make_dna(3000)]), 31, False, mesh8,
                                owner_mode="minimizer", phases=phases)
    assert set(phases) == set(pb.PHASES) and all(v >= 0 for v in phases.values())


# ---------------------------------------------------------------------------
# The super-k-mer exchange


@pytest.mark.parametrize(
    "k,m,canonical",
    [(16, 9, False), (21, 7, False), (21, 11, True), (31, 7, False), (31, 15, True)],
)
def test_superkmer_matches_jax(make_dna, mesh8, jmesh8, k, m, canonical):
    seqs = [make_dna(250 + 19 * i, invalid_frac=0.03) for i in range(4)]
    flat = _flat(seqs)
    got = pb.count_bucket_sharded_super(flat, k, canonical, mesh8, minimizer_m=m)
    assert same(got, jb.count_bucket_sharded_super(flat, k, canonical, jmesh8, minimizer_m=m))
    assert as_dict(got, k) == oracle.count_table_any_k(seqs, k, canonical=canonical)
    # Owner by owner, the received records expand to the same streams.
    shards, n_own = pb.shard_stream_with_halo(flat, k, mesh8)
    planes, meta, ov = pb.exchange_superkmers_bucket_sharded(shards, n_own, k, mesh8, m)
    jplanes, jmeta, jov = jb.exchange_superkmers_bucket_sharded(
        jnp.asarray(shards), jnp.asarray(n_own), k, jmesh8, minimizer_m=m)
    assert not ov and not bool(jov) and len(planes) == len(jplanes)
    for d in range(8):
        a = pb.expand_superkmers([p[d].numpy() for p in planes], meta[d].numpy(), k, m)
        b = jb.expand_superkmers([np.asarray(p)[d] for p in jplanes], np.asarray(jmeta)[d],
                                 k, m)
        assert np.array_equal(a, b), d


def test_superkmer_matches_aggregated(make_dna, mesh8):
    flat = _flat([make_dna(700, invalid_frac=0.01)])
    out, ov = port_agg(flat, 21, mesh8)
    assert not ov and same(pb.count_bucket_sharded_super(flat, 21, False, mesh8),
                           pb.gather_table(*out))


def test_superkmer_run_structure(make_dna):
    # Leftmost-tie positions never decrease, and runs of one position stay
    # within k-m+1 windows: the bound the record format relies on.
    k, m = 21, 7
    b = torch.from_numpy(codec.encode_bases(make_dna(400, invalid_frac=0.02)))
    _, pos, vwin = pb.window_minimizers_pos(b, k, m)
    pos, vwin = pos.numpy(), vwin.numpy()
    run = 1
    for i in range(1, pos.size):
        if vwin[i] and vwin[i - 1]:
            assert pos[i] >= pos[i - 1]
            run = run + 1 if pos[i] == pos[i - 1] else 1
            assert run <= k - m + 1
        else:
            run = 1


def test_superkmer_expand_roundtrip(make_dna):
    k, m = 21, 7
    seqs = [make_dna(300), make_dna(150, invalid_frac=0.05)]
    flat = _flat(seqs)
    mesh1 = LocalMesh(1, "cpu")
    shards, n_own = pb.shard_stream_with_halo(flat, k, mesh1)
    planes, meta, ov = pb.exchange_superkmers_bucket_sharded(shards, n_own, k, mesh1, m)
    assert not ov
    stream = pb.expand_superkmers([p[0].numpy() for p in planes], meta[0].numpy(), k, m)
    _, valid = codec.kmer_codes(stream, k)
    assert int(valid.sum()) == sum(oracle.count_table_any_k(seqs, k).values())


def test_superkmer_overflow_on_pathological_runs(mesh8, jmesh8):
    flat = _flat(["A" * 60000])
    with pytest.raises(OverflowError, match="super-k-mer"):
        pb.count_bucket_sharded_super(flat, 21, False, mesh8)
    with pytest.raises(OverflowError, match="super-k-mer"):
        jb.count_bucket_sharded_super(flat, 21, False, jmesh8)


def test_superkmer_compression_ratio(make_dna, mesh8, jmesh8):
    # Random sequence: >= 2.5x less exchange volume than the raw words
    # (about 5.4x at k=31, m=7); the record count equals JAX's.
    k, m = 31, 7
    flat = _flat([make_dna(8000)])
    shards, n_own = pb.shard_stream_with_halo(flat, k, mesh8)
    _, meta, ov = pb.exchange_superkmers_bucket_sharded(shards, n_own, k, mesh8, m)
    _, jmeta, _ = jb.exchange_superkmers_bucket_sharded(
        jnp.asarray(shards), jnp.asarray(n_own), k, jmesh8, minimizer_m=m)
    n_records = int((meta > 0).sum())
    assert not ov and n_records == int((np.asarray(jmeta) > 0).sum())
    _, W = pb.superkmer_geometry(k, m)
    assert n_records * (W + 1) * 4 * 2.5 < int(n_own.sum()) * 8


def test_superkmer_geometry_checks_m():
    assert pb.superkmer_geometry(31, 7) == jb.superkmer_geometry(31, 7) == (55, 4)
    for m in (0, 21, 30):
        with pytest.raises(ValueError, match="1 <= m < k"):
            pb.superkmer_geometry(21, m)


@pytest.mark.parametrize("exchange", ["auto", "raw", "agg", "super"])
def test_empty_and_all_invalid_inputs(mesh8, exchange):
    for flat in (np.full(300, codec.INVALID_BASE, np.uint8), np.zeros(0, np.uint8)):
        codes, counts = pb.count_bucket_auto(flat, 21, False, mesh8, exchange=exchange)
        assert codes.size == 0 and counts.size == 0
        assert codes.dtype == np.uint64 and counts.dtype == np.int64


@pytest.mark.parametrize("k,m", [(21, 7), (31, 11), (16, 15)])
def test_superkmer_records_device_equals_jax(make_dna, k, m):
    b = codec.encode_bases(make_dna(900, invalid_frac=0.02))
    n_own = b.size - 40
    planes, meta, n_rec = pb.superkmer_records_device(torch.from_numpy(b), n_own, k, m)
    jplanes, jmeta, jn = jb.superkmer_records_device(jnp.asarray(b), jnp.int32(n_own), k, m)
    assert int(n_rec) == int(jn) > 0
    assert np.array_equal(meta.numpy(), np.asarray(jmeta))
    for p, jp in zip(planes, jplanes, strict=True):
        r = int(n_rec)
        assert np.array_equal(p.numpy()[:r].view(np.uint32), np.asarray(jp)[:r])
    for canonical in (False, True):
        got = pb.table_from_superkmers(planes, meta, n_rec, k, m, canonical)
        assert same(got, jb.table_from_superkmers(jplanes, jmeta, jn, k, m, canonical))
        assert same(got, host_table(b[: n_own + k - 1], k, canonical))


# ---------------------------------------------------------------------------
# The policy entry


@pytest.mark.parametrize("exchange", ["auto", "raw", "agg", "super"])
def test_bucket_auto_matches_jax(make_dna, mesh8, jmesh8, exchange):
    seqs = [make_dna(160 + 13 * i, invalid_frac=0.02) for i in range(4)]
    flat = _flat(seqs)
    got = pb.count_bucket_auto(flat, 21, False, mesh8, exchange=exchange)
    assert same(got, jb.count_bucket_auto(flat, 21, False, jmesh8, exchange=exchange,
                                          pallas=None))
    assert as_dict(got, 21) == oracle.count_table_any_k(seqs, 21)


@pytest.mark.parametrize("owner_mode", ["prefix", "minimizer"])
def test_bucket_auto_falls_back_on_skew(mesh8, jmesh8, monkeypatch, owner_mode):
    # The raw exchange overflows on a homopolymer; auto falls back to the
    # aggregated exchange and gets the exact table. The global route at
    # 4,096 bases (the JAX package's without Pallas), then the default
    # row route at 40,000.
    flat = codec.encode_bases("A" * 4096)
    with pytest.raises(OverflowError):
        pb.count_bucket_sharded_raw(flat, 21, False, mesh8, owner_mode=owner_mode,
                                    row_partition=False)
    with pytest.raises(OverflowError):
        jb.count_bucket_sharded_raw(flat, 21, False, jmesh8, owner_mode=owner_mode,
                                    pallas=None)
    agg_calls = []
    real = pb.count_bucket_sharded
    monkeypatch.setattr(pb, "count_bucket_sharded",
                        lambda *a, **kw: agg_calls.append(1) or real(*a, **kw))
    got = pb.count_bucket_auto(flat, 21, False, mesh8, owner_mode=owner_mode,
                               row_partition=False)
    assert got[0].tolist() == [0] and got[1].tolist() == [4096 - 21 + 1]
    assert same(got, jb.count_bucket_auto(flat, 21, False, jmesh8, owner_mode=owner_mode,
                                          pallas=None))
    flat = codec.encode_bases("A" * 40000)
    got = pb.count_bucket_auto(flat, 21, False, mesh8, owner_mode=owner_mode)
    assert got[0].tolist() == [0] and got[1].tolist() == [40000 - 21 + 1]
    assert agg_calls == [1, 1]
    with pytest.raises(OverflowError):
        pb.count_bucket_auto(flat, 21, False, mesh8, owner_mode=owner_mode, exchange="raw")


def test_bucket_auto_rejects_an_unknown_exchange(mesh8):
    with pytest.raises(ValueError, match="unknown exchange"):
        pb.count_bucket_auto(np.zeros(10, np.uint8), 21, False, mesh8, exchange="fast")


def test_bucket_auto_total_own(make_dna, mesh8, jmesh8):
    # Only windows starting before total_own are owned (the streaming
    # batch rule).
    flat = _flat([make_dna(900, invalid_frac=0.01)])
    got = pb.count_bucket_auto(flat, 31, False, mesh8, owner_mode="minimizer", total_own=600)
    assert same(got, jb.count_bucket_auto(flat, 31, False, jmesh8, owner_mode="minimizer",
                                          total_own=600, pallas=None))
    assert same(got, host_table(flat[: 600 + 30], 31))


# ---------------------------------------------------------------------------
# A process group of two ranks (gloo)

_WORKER = r"""
import sys
import numpy as np
import torch.distributed as dist

sys.path.insert(0, sys.argv[1])
from dna_kmeres_parallel_tpu_torch.parallel import bucketed
from dna_kmeres_parallel_tpu_torch.parallel.mesh import ProcessGroupMesh

root, init, rank, seed, out = sys.argv[1:6]
dist.init_process_group("gloo", init_method=init, rank=int(rank), world_size=2)
try:
    rng = np.random.default_rng(int(seed))
    flat = rng.integers(0, 4, 6000).astype(np.uint8)
    flat[rng.random(flat.size) < 0.02] = 0xFF
    mesh = ProcessGroupMesh("cpu")
    tables = {
        "raw21": bucketed.count_bucket_sharded_raw(flat, 21, False, mesh),
        "raw31m": bucketed.count_bucket_sharded_raw(flat, 31, True, mesh,
                                                    owner_mode="minimizer"),
        "agg": bucketed.count_bucket_auto(flat, 23, False, mesh, exchange="agg"),
        "super": bucketed.count_bucket_auto(flat, 31, False, mesh, exchange="super"),
        "skew": bucketed.count_bucket_auto(np.zeros(3000, np.uint8), 21, False, mesh),
    }
finally:
    dist.destroy_process_group()
np.savez(out, **{f"{n}_{i}": t[i] for n, t in tables.items() for i in range(2)})
"""


def test_process_group_mesh_two_ranks_equals_local_mesh(tmp_path):
    init = f"file://{tmp_path / 'pg'}"
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(REPO), init, str(r), "11", str(outs[r])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for r in range(2)
    ]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("process-group workers timed out")
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-3000:]}"
    rng = np.random.default_rng(11)
    flat = rng.integers(0, 4, 6000).astype(np.uint8)
    flat[rng.random(flat.size) < 0.02] = 0xFF
    mesh = LocalMesh(2, "cpu")
    want = {
        "raw21": pb.count_bucket_sharded_raw(flat, 21, False, mesh),
        "raw31m": pb.count_bucket_sharded_raw(flat, 31, True, mesh, owner_mode="minimizer"),
        "agg": pb.count_bucket_auto(flat, 23, False, mesh, exchange="agg"),
        "super": pb.count_bucket_auto(flat, 31, False, mesh, exchange="super"),
        "skew": pb.count_bucket_auto(np.zeros(3000, np.uint8), 21, False, mesh),
    }
    assert same(want["raw21"], host_table(flat, 21))
    assert want["skew"][1].tolist() == [3000 - 20]
    for out in outs:
        got = np.load(out)
        for name, table in want.items():
            assert same((got[f"{name}_0"], got[f"{name}_1"]), table), name
