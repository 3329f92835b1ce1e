"""The port's streaming counter (``models/pipeline.StreamingCounter``) on
the CPU route, against the JAX package's ``StreamingCounter`` on the same
file and against the oracle: dense and sparse arms, k = 9..12 through the
sparse arm, checkpoint and resume (within the port, across the two
packages, and after a real SIGKILL), the compact routes and the 'auto'
race, retries, metrics.

Integer counts: every comparison is exact (tolerance zero)."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from dna_kmeres_parallel_tpu.models import oracle
from dna_kmeres_parallel_tpu.models.pipeline import StreamingCounter as JaxStreamingCounter
from dna_kmeres_parallel_tpu.utils import checkpoint as jax_ckpt
from dna_kmeres_parallel_tpu.utils import fasta
from dna_kmeres_parallel_tpu.utils.config import KmerConfig as JaxKmerConfig
from dna_kmeres_parallel_tpu_torch import KmerConfig, native
from dna_kmeres_parallel_tpu_torch.models import pipeline, sparse_engine
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops
from dna_kmeres_parallel_tpu_torch.utils import checkpoint as ckpt_mod

REPO = Path(__file__).resolve().parents[1]


class FakeInternalError(Exception):
    """A transient runtime failure (its name matches the retry filter)."""


def counter(cfg: KmerConfig, **kw) -> pipeline.StreamingCounter:
    return pipeline.StreamingCounter(cfg, device="cpu", **kw)


def oracle_hist(seqs, k: int, canonical: bool = False) -> np.ndarray:
    return sum(
        (oracle.count_vector(s, k, canonical).astype(np.int64) for s in seqs),
        np.zeros(4**k, np.int64),
    )


def same_result(a, b) -> bool:
    if hasattr(a, "hist"):
        return a.hist.dtype == np.int64 and np.array_equal(a.hist, b.hist)
    return np.array_equal(a.codes, b.codes) and np.array_equal(a.counts, b.counts)


@pytest.fixture
def fasta_file(tmp_path, make_dna):
    records = [(f">r{i}", make_dna(400 + 31 * i, invalid_frac=0.02)) for i in range(6)]
    path = tmp_path / "in.fasta"
    fasta.write_fasta(path, records)
    return str(path), [s for _, s in records]


@pytest.mark.parametrize("pack_input", [True, False])
@pytest.mark.parametrize("k,canonical", [(5, False), (5, True), (21, False), (21, True)])
def test_run_matches_jax_and_oracle(fasta_file, k, canonical, pack_input):
    path, seqs = fasta_file
    kw = dict(k=k, canonical=canonical, pack_input=pack_input, batch_bases=512)
    got = counter(KmerConfig(**kw)).run(path)
    ref = JaxStreamingCounter(JaxKmerConfig(**kw)).run(path)
    assert same_result(got, ref)
    assert (got.n_seqs, got.total_bases) == (ref.n_seqs, ref.total_bases)
    if k == 5:
        assert np.array_equal(got.hist, oracle_hist(seqs, 5, canonical))
    else:
        assert got.table() == oracle.count_table_any_k(seqs, 21, canonical)


@pytest.mark.parametrize("pack_input", [True, False])
def test_k9_routes_sparse(tmp_path, make_dna, pack_input):
    # k = 9..12 go through the sparse arm and are densified at the end.
    records = [(f">r{i}", make_dna(400, invalid_frac=0.02)) for i in range(4)]
    path = tmp_path / "m.fasta"
    fasta.write_fasta(path, records)
    sc = counter(KmerConfig(k=9, batch_bases=512, pack_input=pack_input))
    result = sc.run(str(path))
    assert result.hist.shape == (1 << 18,)
    assert np.array_equal(result.hist, oracle_hist([s for _, s in records], 9))
    ref = JaxStreamingCounter(JaxKmerConfig(k=9, batch_bases=512)).run(str(path))
    assert np.array_equal(result.hist, ref.hist)
    assert "compact" in sc.metrics.phase_seconds


def test_metrics_populated(fasta_file):
    path, seqs = fasta_file
    sc = counter(KmerConfig(k=4, batch_bases=256))
    sc.run(path)
    rep = sc.metrics.report()
    assert rep["counters"]["bases"] >= sum(len(s) for s in seqs)
    assert rep["counters"]["batches"] > 1
    assert rep["phase_seconds"]["device"] > 0
    assert rep["phase_seconds"]["parse"] > 0
    assert "bases_per_sec_device" in rep
    json.loads(sc.metrics.json())


def test_list_of_sources_and_max_seqs(tmp_path, make_dna):
    # Several files: one separator between them; max_seqs spans them.
    seqs = [make_dna(300 + 40 * i, invalid_frac=0.02) for i in range(5)]
    paths = []
    for i, chunk in enumerate((seqs[:2], seqs[2:3], seqs[3:])):
        p = tmp_path / f"f{i}.fasta"
        fasta.write_fasta(p, [(f">s{i}_{j}", s) for j, s in enumerate(chunk)])
        paths.append(str(p))
    res = counter(KmerConfig(k=21, batch_bases=256)).run(paths)
    assert res.table() == oracle.count_table_any_k(seqs, 21)
    assert (res.n_seqs, res.total_bases) == (5, sum(map(len, seqs)))
    res = counter(KmerConfig(k=5, max_seqs=3)).run(paths)
    assert np.array_equal(res.hist, oracle_hist(seqs[:3], 5)) and res.n_seqs == 3


def test_checkpoint_roundtrip_reads_the_jax_format(tmp_path):
    path = str(tmp_path / "c.npz")
    ck = ckpt_mod.CountCheckpoint(
        k=5, canonical=True, cursor=1234, total_bases=999,
        hist=np.arange(4**5, dtype=np.int64),
    )
    ckpt_mod.save_checkpoint(path, ck)
    back = jax_ckpt.load_checkpoint(path)
    assert (back.k, back.canonical, back.cursor, back.total_bases) == (5, True, 1234, 999)
    assert np.array_equal(back.hist, ck.hist)
    jax_ckpt.save_checkpoint(path, jax_ckpt.CountCheckpoint(
        k=21, canonical=False, cursor=7, total_bases=99,
        sparse_codes=np.array([3, 9], np.uint64), sparse_counts=np.array([4, 5], np.int64),
    ))
    back = ckpt_mod.load_checkpoint(path)
    assert not back.dense and back.cursor == 7
    assert back.sparse_codes.tolist() == [3, 9] and back.sparse_counts.tolist() == [4, 5]


@pytest.mark.parametrize("k,stop", [(5, 3), (21, 2)])
def test_crash_resume(fasta_file, tmp_path, k, stop):
    path, seqs = fasta_file
    cfg = KmerConfig(k=k, batch_bases=256)
    ckpt = str(tmp_path / "resume.npz")
    # "Crash" after `stop` batches: progress checkpointed at the boundary.
    counter(cfg, checkpoint_path=ckpt, max_batches=stop).run(path)
    saved = ckpt_mod.load_checkpoint(ckpt)
    assert saved.cursor == stop * 256 and saved.dense == (k == 5)
    sc = counter(cfg, checkpoint_path=ckpt, checkpoint_every_bases=1 << 40)
    result = sc.run(path)
    assert sc.metrics.counters.get("resumed_from_base") == saved.cursor
    assert same_result(result, counter(cfg).run(path))
    if k == 5:
        assert np.array_equal(result.hist, oracle_hist(seqs, 5))
    else:
        assert result.table() == oracle.count_table_any_k(seqs, 21)


def test_mismatched_checkpoint_ignored(fasta_file, tmp_path):
    path, seqs = fasta_file
    ckpt = str(tmp_path / "wrongk.npz")
    ckpt_mod.save_checkpoint(ckpt, ckpt_mod.CountCheckpoint(
        k=7, canonical=False, cursor=50, total_bases=10, hist=np.zeros(4**7, np.int64),
    ))
    sc = counter(KmerConfig(k=5), checkpoint_path=ckpt)
    result = sc.run(path)  # k mismatch: a fresh count, which then overwrites it
    assert np.array_equal(result.hist, oracle_hist(seqs, 5))
    assert "resumed_from_base" not in sc.metrics.counters
    assert ckpt_mod.load_checkpoint(ckpt).k == 5


@pytest.mark.parametrize("k,stop", [(5, 3), (21, 2)])
def test_jax_checkpoint_resumes_in_the_port(fasta_file, tmp_path, k, stop):
    path, seqs = fasta_file
    ckpt = str(tmp_path / "jax.npz")
    JaxStreamingCounter(
        JaxKmerConfig(k=k, batch_bases=256), checkpoint_path=ckpt, max_batches=stop
    ).run(path)
    sc = counter(KmerConfig(k=k, batch_bases=256), checkpoint_path=ckpt)
    result = sc.run(path)
    assert sc.metrics.counters["resumed_from_base"] == stop * 256
    want = (oracle_hist(seqs, 5) if k == 5 else oracle.count_table_any_k(seqs, 21))
    assert (np.array_equal(result.hist, want) if k == 5 else result.table() == want)


@pytest.mark.parametrize("k,stop", [(5, 3), (21, 2)])
def test_port_checkpoint_resumes_in_jax(fasta_file, tmp_path, k, stop):
    path, seqs = fasta_file
    ckpt = str(tmp_path / "port.npz")
    counter(KmerConfig(k=k, batch_bases=256), checkpoint_path=ckpt, max_batches=stop).run(path)
    sc = JaxStreamingCounter(JaxKmerConfig(k=k, batch_bases=256), checkpoint_path=ckpt)
    result = sc.run(path)
    assert sc.metrics.counters["resumed_from_base"] == stop * 256
    want = (oracle_hist(seqs, 5) if k == 5 else oracle.count_table_any_k(seqs, 21))
    assert (np.array_equal(result.hist, want) if k == 5 else result.table() == want)


_KILLED_CHILD = r"""
import os, signal, sys
from dna_kmeres_parallel_tpu_torch import KmerConfig
from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter
from dna_kmeres_parallel_tpu_torch.utils import checkpoint

path, ckpt, k = sys.argv[1], sys.argv[2], int(sys.argv[3])
save = checkpoint.save_checkpoint
published = []

def save_then_die(*a, **kw):
    save(*a, **kw)
    published.append(1)
    if len(published) == 2:
        os.kill(os.getpid(), signal.SIGKILL)

checkpoint.save_checkpoint = save_then_die
StreamingCounter(KmerConfig(k=k, batch_bases=256), device="cpu", checkpoint_path=ckpt,
                 checkpoint_every_bases=512).run(path)
"""


@pytest.mark.parametrize("k", [5, 21])
def test_sigkill_after_second_checkpoint_resumes_exactly(fasta_file, tmp_path, k):
    path, seqs = fasta_file
    ckpt = tmp_path / "killed.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, "-c", _KILLED_CHILD, path, str(ckpt), str(k)],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    saved = ckpt_mod.load_checkpoint(ckpt)
    assert saved.cursor == 1024  # the second checkpoint: 2 x 512 bases
    assert not list(tmp_path.glob("*.tmp"))
    sc = counter(KmerConfig(k=k, batch_bases=256), checkpoint_path=str(ckpt))
    result = sc.run(path)
    assert sc.metrics.counters["resumed_from_base"] == 1024
    assert same_result(result, counter(KmerConfig(k=k, batch_bases=256)).run(path))
    if k == 21:
        assert result.table() == oracle.count_table_any_k(seqs, 21)


@pytest.mark.parametrize("compact", ["host", "device"])
def test_sparse_compact_modes_match_oracle(fasta_file, compact):
    path, seqs = fasta_file
    sc = counter(KmerConfig(k=21, batch_bases=512, compact=compact))
    result = sc.run(path)
    assert result.table() == oracle.count_table_any_k(seqs, 21)
    host = sc.metrics.phase_seconds.get("host_count", 0) > 0
    assert host == (compact == "host")
    assert ("compact" in sc.metrics.phase_seconds) == (compact == "device")


def test_sparse_compact_auto_races_and_decides(fasta_file):
    # 'auto' host-counts exactly one probe batch before it decides (the
    # decision itself depends on the machine's load).
    path, seqs = fasta_file
    sc = counter(KmerConfig(k=21, batch_bases=256, compact="auto"))
    result = sc.run(path)
    assert result.table() == oracle.count_table_any_k(seqs, 21)
    rep = sc.metrics.report()
    assert rep["counters"]["batches"] >= 5
    assert "compact_host_selected" in rep["counters"]
    assert rep["phase_seconds"].get("host_count", 0) > 0


def test_sparse_compact_auto_switches_to_host_when_device_slow(fasta_file, monkeypatch):
    # A slow fetch of the words makes the device route lose the race.
    real_fetch = sparse_engine.fetch_words

    def slow_fetch(words):
        time.sleep(0.05)
        return real_fetch(words)

    monkeypatch.setattr(sparse_engine, "fetch_words", slow_fetch)
    path, seqs = fasta_file
    sc = counter(KmerConfig(k=21, batch_bases=128, compact="auto"))
    result = sc.run(path)
    assert result.table() == oracle.count_table_any_k(seqs, 21)
    assert sc.metrics.counters["compact_host_selected"] == 1


def test_sparse_compact_auto_flips_when_route_degrades_midstream(fasta_file, monkeypatch):
    # The device drain is slowed so the host wins the race; then the host
    # route degrades from its 3rd call on, and the periodic loser probe
    # must flip back. The table stays exact across the flips.
    real_fetch = sparse_engine.fetch_words
    real_host = native.count_sparse_host_native
    calls = {"n": 0}

    def slow_fetch(words):
        if calls["n"] < 3:
            time.sleep(0.05)
        return real_fetch(words)

    def degrading(seg, k, canonical):
        calls["n"] += 1
        if calls["n"] >= 3:
            time.sleep(0.3)
        return real_host(seg, k, canonical)

    monkeypatch.setattr(sparse_engine, "fetch_words", slow_fetch)
    monkeypatch.setattr(native, "count_sparse_host_native", degrading)
    monkeypatch.setattr(pipeline, "_COMPACT_RECHECK", 4)
    path, seqs = fasta_file
    sc = counter(KmerConfig(k=21, batch_bases=128, compact="auto"))
    result = sc.run(path)
    assert result.table() == oracle.count_table_any_k(seqs, 21)
    assert sc.metrics.counters["compact_host_selected"] == 1
    assert sc.metrics.counters["compact_mode_flips"] >= 1


def test_sparse_compact_auto_exact_on_coverage_data(tmp_path, make_dna):
    # 30x-coverage reads: many repeated windows per batch.
    genome = make_dna(300)
    rng = np.random.default_rng(7)
    reads = []
    for i in range(60):
        s = int(rng.integers(0, len(genome) - 150))
        reads.append((f">r{i}", genome[s : s + 150]))
    path = tmp_path / "cov.fasta"
    fasta.write_fasta(path, reads)
    result = counter(KmerConfig(k=21, batch_bases=1024, compact="auto")).run(str(path))
    assert result.table() == oracle.count_table_any_k([s for _, s in reads], 21)


@pytest.mark.parametrize("kw,item", [({"compact": "device-super"}, "11")])
def test_unported_sparse_routes_raise(fasta_file, kw, item):
    path, _ = fasta_file
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        counter(KmerConfig(k=21, **kw)).run(path)


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        counter(KmerConfig(k=21, mesh_shape=(4,)))


def test_compact_device_super_rejects_small_k():
    with pytest.raises(ValueError, match="device-super"):
        KmerConfig(k=3, compact="device-super")
    KmerConfig(k=9, compact="device-super")


def test_transient_failures_retried(fasta_file, monkeypatch):
    path, seqs = fasta_file
    real = pipeline._count_batch
    fails = {"n": 2}  # within max_retries=2 for the first batch

    def flaky(*a, **kw):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise FakeInternalError("Internal: transient DMA failure (injected)")
        return real(*a, **kw)

    monkeypatch.setattr(pipeline, "_count_batch", flaky)
    sc = counter(KmerConfig(k=4, batch_bases=256), max_retries=2)
    result = sc.run(path)
    assert np.array_equal(result.hist, oracle_hist(seqs, 4))
    assert sc.metrics.counters["batch_retries"] == 2


@pytest.mark.parametrize("pack_input", [True, False])
def test_transient_encode_failures_retried(fasta_file, monkeypatch, pack_input):
    # The sparse arm's device call (K1 from planes, K9 from bases).
    path, seqs = fasta_file
    name = "encode_words_planes" if pack_input else "encode_words"
    real = getattr(sparse_ops, name)
    fails = {"n": 2}

    def flaky(*a, **kw):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise RuntimeError("UNAVAILABLE: Unavailable device (injected)")
        return real(*a, **kw)

    monkeypatch.setattr(sparse_ops, name, flaky)
    sc = counter(KmerConfig(k=21, batch_bases=256, compact="device", pack_input=pack_input),
                 max_retries=2)
    result = sc.run(path)
    assert result.table() == oracle.count_table_any_k(seqs, 21)
    assert sc.metrics.counters["batch_retries"] == 2


def test_fatal_failures_surface(fasta_file, monkeypatch):
    path, _ = fasta_file

    def broken(*a, **kw):
        raise ValueError("deterministic bug: must not be retried")

    monkeypatch.setattr(pipeline, "_count_batch", broken)
    sc = counter(KmerConfig(k=4), max_retries=5)
    with pytest.raises(ValueError):
        sc.run(path)
    assert "batch_retries" not in sc.metrics.counters


def test_retries_exhausted(fasta_file, monkeypatch):
    path, _ = fasta_file

    def always_transient(*a, **kw):
        raise FakeInternalError("Internal: persistent failure")

    monkeypatch.setattr(pipeline, "_count_batch", always_transient)
    sc = counter(KmerConfig(k=4), max_retries=2)
    with pytest.raises(FakeInternalError):
        sc.run(path)
    assert sc.metrics.counters["batch_retries"] == 2


def test_trace_dir_writes_a_trace(fasta_file, tmp_path):
    path, seqs = fasta_file
    out = tmp_path / "trace"
    res = counter(KmerConfig(k=21, batch_bases=1024), trace_dir=str(out)).run(path)
    assert res.table() == oracle.count_table_any_k(seqs, 21)
    assert (out / "trace.json").stat().st_size > 0
