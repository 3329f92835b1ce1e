"""The count's table built from the call's keys (``SparseKmerEngine``'s
card route: one sort and run-length of every window, no merge) on the
CPU, where its functions run on CPU tensors with the plain ``torch.sort``:
its tables against the host route (per-batch ``compact_unsorted`` and a
``MergeLadder``) and the JAX package's sparse engine; the gate
``card_table_fits`` under a patched ``torch.cuda.mem_get_info`` and
device; and the spans and counters the benchmark reads (the root's
``table_on_card``, one ``compact`` span's ``words`` and ``rows``, no merge,
``merge_passes`` 0, ``table_on_card_pct``).

Integer tables: every comparison is exact (tolerance zero)."""

import collections
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dna_kmeres_parallel_tpu.models.sparse_engine import (
    SparseKmerEngine as JaxSparseKmerEngine,
)
from dna_kmeres_parallel_tpu.utils.config import KmerConfig as JaxKmerConfig
from dna_kmeres_parallel_tpu_torch import KmerConfig
from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models import sparse_engine as pse
from dna_kmeres_parallel_tpu_torch.ops import sparse as psparse
from dna_kmeres_parallel_tpu_torch.utils import codec, profiling

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from benchmark import run as bench_run  # noqa: E402
from benchmark import spans, trace  # noqa: E402
from benchmark.gen import fasta as bench_fasta  # noqa: E402

BATCH = 2048
CUDA = torch.device("cuda")


@pytest.fixture(autouse=True)
def empty_log():
    profiling.clear()
    yield
    profiling.clear()


def random_seq(rng, n: int, n_frac: float = 0.0) -> str:
    s = np.array(list("ACGT"))[rng.integers(0, 4, n)]
    if n_frac:
        s[rng.random(n) < n_frac] = "N"
    return "".join(s)


def inputs(kind: str) -> list[str]:
    """The records of one case:

    - ``n_runs``: three N-sprinkled records and runs of 30-200 N, several
      batches, the last one short;
    - ``short``: one record, far shorter than one batch;
    - ``repeats``: one 1,500-base record four times and its start once
      more, so equal codes fall in every batch;
    - ``all_n``: records of N only (an empty table);
    - ``reads``: 240 reads of 150 bases from both strands of a 4 kbase
      genome at 9x, with substitutions and a few N (repeats across
      batches, the canonical fold's case)."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "n_runs":
        a, b, c = (random_seq(rng, n, 0.02) for n in (1900, 2500, 1300))
        return [a + "N" * 200 + b, "N" * 30 + c + "N" * 45, random_seq(rng, 700)]
    if kind == "short":
        return [random_seq(rng, 300, 0.01)]
    if kind == "repeats":
        s = random_seq(rng, 1500)
        return [s] * 4 + [s[:400]]
    if kind == "all_n":
        return ["N" * 700, "N" * 1600, "N" * 40]
    genome = random_seq(rng, 4000)
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for _ in range(240):
        i = int(rng.integers(0, len(genome) - 150))
        r = np.array(list(genome[i : i + 150]))
        sub = rng.random(150) < 0.004
        r[sub] = np.array(list("ACGT"))[rng.integers(0, 4, int(sub.sum()))]
        r[rng.random(150) < 0.002] = "N"
        r = "".join(r)
        reads.append(r.translate(comp)[::-1] if rng.random() < 0.5 else r)
    return reads


def write(path: Path, seqs: list[str], fastq: bool) -> Path:
    if fastq:
        path.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(seqs)))
    else:
        path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    return path


def count(monkeypatch, cfg: KmerConfig, source, on_card: bool):
    """``count_file`` (a path) or ``count_sequences`` on the CPU, with the
    gate admitting the call to the card's route or refusing it."""
    monkeypatch.setattr(pse, "card_table_fits", lambda *a: on_card)
    eng = pse.SparseKmerEngine(cfg, device="cpu")
    return eng.count_file(str(source)) if isinstance(source, Path) else eng.count_sequences(source)


CASES = [  # (kind, k, canonical, FASTQ, batch_bases)
    ("n_runs", 21, False, False, BATCH),
    ("n_runs", 21, True, False, BATCH),
    ("reads", 21, False, True, BATCH),
    ("reads", 21, True, True, BATCH),
    ("short", 21, False, False, 1 << 24),
    ("short", 21, True, True, 1 << 24),
    ("repeats", 21, False, False, BATCH),
    ("repeats", 21, True, False, BATCH),
    ("all_n", 21, False, False, BATCH),
    ("n_runs", 11, True, False, BATCH),
    ("repeats", 16, False, False, BATCH),
    ("reads", 31, True, True, BATCH),
]


@pytest.mark.parametrize("kind, k, canonical, fastq, batch", CASES)
def test_card_route_table_is_the_host_routes_and_the_jax_engines(
    tmp_path, monkeypatch, kind, k, canonical, fastq, batch
):
    seqs = inputs(kind)
    path = write(tmp_path / ("in.fq" if fastq else "in.fa"), seqs, fastq)
    cfg = KmerConfig(k=k, canonical=canonical, batch_bases=batch)
    card = count(monkeypatch, cfg, path, True)
    host = count(monkeypatch, cfg, path, False)
    monkeypatch.setenv("KMER_TPU_PALLAS_INTERPRET", "1")
    ref = JaxSparseKmerEngine(JaxKmerConfig(k=k, canonical=canonical, batch_bases=batch)
                              ).count_sequences(seqs)
    assert card.table_on_card and not host.table_on_card
    assert card.codes.dtype == np.uint64 and card.counts.dtype == np.int64
    for other in (host, ref):
        assert np.array_equal(card.codes, other.codes)
        assert np.array_equal(card.counts, other.counts)
    assert (card.n_seqs, card.total_bases) == (len(seqs), sum(map(len, seqs)))
    total = sum(len(s) + 1 for s in seqs) - 1
    n_batches = -(-total // pse.batch_plan(total, k, batch)[0])
    assert (n_batches == 1) == (kind == "short")
    assert n_batches == 1 or total % batch  # a short last batch
    if kind == "all_n":
        assert card.codes.size == 0
    if kind in ("repeats", "reads"):
        assert card.counts.max() > 1
    assert card.phases["merge"] == 0.0 and set(card.phases) == set(pse.PHASES)


@pytest.mark.parametrize("k", [11, 16, 21, 31])
@pytest.mark.parametrize("n_own", [1, 777, 4096])
def test_route_functions_on_cpu_tensors(k, n_own):
    # one staged batch's owned windows as keys, sorted, run-length and
    # fetched: the host radix compaction's table of the same words
    rng = np.random.default_rng(k * 10_000 + n_own)
    T = 4096 + 128
    padded = np.full(T, codec.INVALID_BASE, np.uint8)
    body = rng.integers(0, 4, 4096).astype(np.uint8)
    body[rng.random(4096) < 0.02] = codec.INVALID_BASE
    body[2048:3072] = body[:1024]  # codes that repeat
    padded[:4096] = body
    staged = tuple(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
                   for a in pse.stage_words(padded, True))
    words = pse.encode_staged(staged, n_own, k, False)
    key = psparse._sort_key(tuple(w[:n_own] for w in words))
    assert key.dtype == psparse.key_dtype(k)
    (keys_c,), runs, n_distinct = psparse.rle_keys(torch.sort(key).values)
    codes, counts = pse.fetch_table(keys_c, runs, int(n_distinct))
    want = pse.compact_unsorted(pse.fetch_words(tuple(w[:n_own] for w in words)), k)
    assert np.array_equal(codes, want[0]) and np.array_equal(counts, want[1])
    assert int(n_distinct) == want[0].size and counts.sum() == (key != psparse.key_sentinel(
        key.dtype)).sum()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_rle_keys_of_sentinels_only_is_empty(dtype):
    key = torch.full((50,), psparse.key_sentinel(dtype), dtype=dtype)
    (_,), _, n_distinct = psparse.rle_keys(key)
    assert int(n_distinct) == 0


def test_codes_of_keys_undo_the_key():
    # a single word's key is its word biased by INT32_MIN; two words' key
    # is the 64-bit code itself
    lo = torch.tensor([0, 1, (1 << 30) - 1, 12345], dtype=torch.int32)
    key = psparse._sort_key((lo,))
    assert psparse.codes_of_keys(key).tolist() == lo.tolist()
    hi = torch.tensor([0, 3, (1 << 14) - 1], dtype=torch.int16)
    lo = torch.tensor([5, -1, -2], dtype=torch.int32)  # u32 words 5, 2^32-1, 2^32-2
    key = psparse._sort_key((hi, lo))
    want = psparse.merged_code64(hi.numpy().view(np.uint16), lo.numpy().view(np.uint32))
    assert np.array_equal(psparse.codes_of_keys(key).numpy().view(np.uint64), want)


# ---------------------------------------------------------------- the gate


@pytest.fixture
def card_memory(monkeypatch):
    """Patch what the gate reads of the card: free memory, and what
    PyTorch's allocator holds reserved and allocated."""
    state = {"free": 0, "reserved": 0, "allocated": 0}
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (state["free"], 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: state["reserved"])
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: state["allocated"])
    return state


@pytest.mark.parametrize("key_bytes", [4, 8])
def test_gate_admits_a_call_its_free_memory_holds(card_memory, key_bytes):
    windows = 256_000_000
    need = pse.card_table_bytes(windows, key_bytes)
    card_memory["free"] = need
    assert pse.card_table_fits(CUDA, windows, key_bytes)
    card_memory["free"] = need - 1
    assert not pse.card_table_fits(CUDA, windows, key_bytes)
    # what the allocator holds unused counts as free
    card_memory.update(reserved=10 << 30, allocated=(10 << 30) - 1)
    assert pse.card_table_fits(CUDA, windows, key_bytes)


def test_gate_reserves_the_peak_the_build_took_on_the_card():
    # the build's device peak, the key buffer included, measured on an H100
    # at 257,520,887 windows: 48.22 B a window with int64 keys (k=21),
    # 37.00 with int32 keys (k=11)
    windows = 257_520_887
    assert pse.card_table_bytes(windows, 8) >= 12_418_247_096
    assert pse.card_table_bytes(windows, 4) >= 9_528_274_396


@pytest.mark.parametrize("windows", [1 << 31, (1 << 31) + 5, 1 << 33])
def test_gate_refuses_2_to_the_31_windows_or_more(card_memory, windows):
    card_memory["free"] = 1 << 50
    assert not pse.card_table_fits(CUDA, windows, 8)
    assert pse.card_table_fits(CUDA, (1 << 31) - 1, 8)


def test_gate_refuses_a_cpu_device(card_memory):
    card_memory["free"] = 1 << 50
    assert not pse.card_table_fits(torch.device("cpu"), 1000, 8)


def seqs_small():
    rng = np.random.default_rng(9)
    return [random_seq(rng, n, 0.01) for n in (900, 1700, 2600)]


@pytest.mark.parametrize("free_gb, device_sort, on_card", [
    (80, None, True),      # the default on a card that holds the call
    (0, None, False),      # too large for the reported free memory
    (80, False, False),    # the host route asked for
    (80, True, False),     # the per-batch device sort and the host compactor
])
def test_engine_routes_by_the_gate_and_device_sort(monkeypatch, card_memory, free_gb,
                                                   device_sort, on_card):
    # the gate sees a card with the patched memory; the tensors stay on
    # the CPU
    gate = pse.card_table_fits
    monkeypatch.setattr(pse, "card_table_fits", lambda dev, *a: gate(CUDA, *a))
    card_memory["free"] = free_gb << 30
    seqs = seqs_small()
    cfg = KmerConfig(k=21, batch_bases=BATCH, device_sort=device_sort)
    with profile(activities=[ProfilerActivity.CPU]):
        res = pse.SparseKmerEngine(cfg, device="cpu").count_sequences(seqs)
    assert res.table_on_card is on_card
    (root,) = [r for r in profiling.records() if r["parent"] is None]
    assert root["counters"]["table_on_card"] == int(on_card)
    monkeypatch.setattr(pse, "card_table_fits", lambda *a: False)
    want = pse.SparseKmerEngine(cfg.replace(device_sort=False), device="cpu").count_sequences(seqs)
    assert np.array_equal(res.codes, want.codes) and np.array_equal(res.counts, want.counts)


# ------------------------------------------------------ spans and counters


def window(n_calls: int) -> bench_run.Run:
    """A traced window whose calls cover every record of the log."""
    inp = bench_fasta.InputFile(0, "x", bench_fasta.Records(
        np.zeros(8, np.uint8), np.array([0]), np.array([8])))

    class Cell:
        config = {"args": {"k": 21}}

    calls = [bench_run.Call(inp, -1e9, 1e9, 1e4, {}) for _ in range(n_calls)]
    tr = trace.Trace(device=[dict(ph="X", cat="kernel", name="k", ts=0, dur=1)])
    return bench_run.Run(Cell(), calls, 20.0, 5.0, tr)


def table_on_card_pct(run, records):
    reader = bench_run.load_module(REPO / "benchmark" / "metrics" / "table_on_card_pct.py")
    orig = spans.log
    spans.log = lambda: list(records)
    try:
        return reader.read(run)
    finally:
        spans.log = orig


@pytest.mark.parametrize("on_card", [True, False])
def test_spans_of_each_route(tmp_path, monkeypatch, on_card):
    seqs = inputs("n_runs")
    path = write(tmp_path / "in.fa", seqs, False)
    with profile(activities=[ProfilerActivity.CPU]):
        res = count(monkeypatch, KmerConfig(k=21, batch_bases=BATCH), path, on_card)
    recs = profiling.records()
    names = collections.Counter((r["name"], r["parent"]) for r in recs)
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "count_file"
    assert root["counters"] == {"rows": res.codes.size, "table_on_card": int(on_card)}
    compacts = [r["counters"] for r in recs if r["name"] == "compact"]
    total = sum(len(s) + 1 for s in seqs) - 1
    n_batches = -(-total // BATCH)
    assert names[("staging", "count_file")] == n_batches > 1
    if on_card:
        # one table build for the call: every owned window in, the
        # distinct rows out; one copy of 16 bytes a row; no merge
        assert compacts == [{"words": total, "rows": res.codes.size}]
        (copy,) = [r for r in recs if r["name"] == "d2h.copy"]
        assert copy["counters"] == {"bytes": 16 * res.codes.size}
        assert not any(r["name"] in ("merge", "merge.pair") for r in recs)
        assert names[("d2h", "count_file")] == n_batches + 1
    else:
        assert len(compacts) == n_batches
        assert names[("merge.pair", "merge")] == n_batches - 1
    passes = spans.merge_passes(window(1), recs)
    assert passes == 0.0 if on_card else passes > 1
    assert table_on_card_pct(window(1), recs) == (100.0 if on_card else 0.0)


def test_table_on_card_pct_reads_the_share_of_calls_and_nothing_without_the_counter():
    def root(call, counters):
        return {"call": call, "name": "count_file", "parent": None, "t0": 0.0, "t1": 1.0,
                "sys_s": 0.0, "counters": counters}

    recs = [root(1, {"rows": 5, "table_on_card": 1}), root(2, {"rows": 5, "table_on_card": 0}),
            root(3, {"rows": 5, "table_on_card": 1}), root(4, {"rows": 5, "table_on_card": 1})]
    assert table_on_card_pct(window(4), recs) == 75.0
    # a program whose roots keep no such counter (the parent's) reads nothing
    assert table_on_card_pct(window(2), [root(1, {"rows": 5}), root(2, {"rows": 5})]) is None
    assert table_on_card_pct(window(2), []) is None


def test_host_route_keeps_the_native_compactor_and_the_ladder(monkeypatch):
    # device_sort=False on a card the gate admits: per-batch radix
    # compaction and a merge of the batch tables, as before
    calls = collections.Counter()
    compact, merge = native.compact_unsorted_native, native.merge_tables_native

    def counted_compact(*a):
        calls["compact"] += 1
        return compact(*a)

    def counted_merge(*a):
        calls["merge"] += 1
        return merge(*a)

    monkeypatch.setattr(native, "compact_unsorted_native", counted_compact)
    monkeypatch.setattr(native, "merge_tables_native", counted_merge)
    seqs = inputs("n_runs")
    count(monkeypatch, KmerConfig(k=21, batch_bases=BATCH, device_sort=False), seqs, True)
    total = sum(len(s) + 1 for s in seqs) - 1
    assert calls["compact"] == -(-total // BATCH) and calls["merge"] >= 1
    calls.clear()
    count(monkeypatch, KmerConfig(k=21, batch_bases=BATCH), seqs, True)
    assert calls == {}
