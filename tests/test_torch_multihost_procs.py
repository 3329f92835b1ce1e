"""The port's multi-host layer over real process groups: two and three
gloo ranks on the CPU (``ProcessGroupMesh``), each a subprocess with a
120 s limit, against the JAX package's single-process ``multihost``
results computed here (no JAX process is spawned).

Two launches of two ranks share one seeded file whose first range is the
longest, so its slab would sit flush against the second rank's head
without the trailing INVALID: the first launch counts, runs the
``_shard_input`` repair's check, stops the bucketed count and the
distances after two steps or panels, and kills rank 1 by SIGKILL in the
dense count's third step, before its save (rank 0 saves that step); the
second resumes each. A third launch runs three ranks over a one-record
file (two empty ranges). Histograms, tables and CSV bytes: the tolerance
is zero."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dna_kmeres_parallel_tpu.models import oracle
from dna_kmeres_parallel_tpu.parallel import multihost as jmh
from dna_kmeres_parallel_tpu.parallel.mesh import make_mesh as jax_mesh
from dna_kmeres_parallel_tpu.utils.config import KmerConfig as JaxConfig
from dna_kmeres_parallel_tpu_torch.models.sparse_engine import merge_sparse_tables
from dna_kmeres_parallel_tpu_torch.parallel import multihost
from dna_kmeres_parallel_tpu_torch.utils import fasta

REPO = Path(__file__).resolve().parents[1]
BATCH = 512

_WORKER = r"""
import json
import os
import signal
import sys

import numpy as np
import torch.distributed as dist

sys.path.insert(0, sys.argv[1])
from dna_kmeres_parallel_tpu_torch import KmerConfig
from dna_kmeres_parallel_tpu_torch.parallel import bucketed, multihost
from dna_kmeres_parallel_tpu_torch.parallel.mesh import ProcessGroupMesh
from dna_kmeres_parallel_tpu_torch.parallel.sharded_sparse import stage_shard_planes
from dna_kmeres_parallel_tpu_torch.utils import checkpoint

root, init, rank, world, out, path, jobs = sys.argv[1:8]
rank, world = int(rank), int(world)
dev = multihost.init_distributed(init, world, rank, device="cpu")
mesh = ProcessGroupMesh(dev)
got = {}


def die_before_save(cursor):
    # SIGKILL this rank after the collective of the step that ends at
    # `cursor`, before its checkpoint reaches the disk.
    real = checkpoint.save_checkpoint

    def save(p, ck):
        if ck.cursor == cursor:
            os.kill(os.getpid(), signal.SIGKILL)
        real(p, ck)

    checkpoint.save_checkpoint = save


for job in json.loads(jobs):
    name, kind = job.pop("name"), job.pop("kind")
    cfg = KmerConfig(k=job.pop("k"), canonical=job.pop("canonical", False))
    if job.get("kill_rank") == rank:
        die_before_save(job["kill_cursor"])
    if kind == "count":
        hist, total, n = multihost.count_file_multihost(path, cfg, mesh)
        got[name] = hist
        got[name + ".seqs"] = np.array([total, n])
    elif kind == "dense":
        hist, total, n, done, steps = multihost.count_file_multihost_resumable(
            path, cfg, mesh, job["ckpt"], job["batch"], job.get("max_steps"))
        got[name] = hist
        got[name + ".steps"] = np.array([done, steps])
    elif kind == "bucket":
        codes, counts, total, n, done, steps = multihost.count_file_bucketed_multihost_resumable(
            path, cfg, mesh, job["ckpt"], job["batch"], job.get("max_steps"), job["owner_mode"])
        got[name + ".codes"], got[name + ".counts"] = codes, counts
        got[name + ".steps"] = np.array([done, steps])
    elif kind == "shard_row":
        # The bucketed exchange fed every shard's rows, then this rank's
        # own row alone: the same received tables.
        flat, _, _ = multihost.encode_range_stream(path, 0, os.path.getsize(path))
        shards, n_own = bucketed.shard_stream_with_halo(flat, cfg.k, mesh)
        planes = stage_shard_planes(shards)
        for label, inputs, own in (("global", planes, n_own),
                                   ("local", tuple(p[rank : rank + 1] for p in planes),
                                    n_own[rank : rank + 1])):
            hi, lo, cnt, starts, overflow = bucketed.count_bucket_sharded(
                inputs, own, cfg.k, False, mesh, staged_planes=True)
            got[f"{name}.{label}"] = np.stack([t.numpy() for t in (hi, lo, cnt, starts)])
            assert not overflow
    elif kind == "dist":
        report = multihost.distance_file_multihost_resumable(
            path, cfg, job["csv"], job["ckpt"], panel_rows=2,
            max_panels=job.get("max_panels"), device="cpu")
        got[name] = np.array([report["completed"], report["all_complete"], *report["rows"]])
        got[name + ".regime"] = np.array(report["regime"])
dist.destroy_process_group()
np.savez(out, **got)
"""


def launch(tmp: Path, tag: str, path: Path, world: int, jobs: list, killed: int | None = None):
    """Run ``jobs`` on ``world`` gloo ranks; returns each rank's results
    (None for the rank killed by SIGKILL)."""
    init = f"file://{tmp / f'pg_{tag}'}"
    outs = [tmp / f"{tag}_rank{r}.npz" for r in range(world)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR")}
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, str(REPO), init, str(r), str(world),
                          str(outs[r]), str(path), json.dumps(jobs)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)
    ]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{tag}: process-group workers timed out")
    for r, p in enumerate(procs):
        want = -signal.SIGKILL if r == killed else 0
        assert p.returncode == want, f"{tag} rank {r} exited {p.returncode}:\n{logs[r][-3000:]}"
    return [None if r == killed else dict(np.load(o)) for r, o in enumerate(outs)]


def seeded_records(seed: int, n: int) -> list[tuple[str, str]]:
    # Longest first: the first rank's range holds the most bases.
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    records = []
    for i in range(n):
        m = 700 - 25 * i
        codes = np.where(rng.random(m) < 0.01, 4, rng.integers(0, 4, m))
        records.append((f">r{i}", letters[codes].tobytes().decode()))
    return records


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh2")
    records = seeded_records(21, 16)
    path = tmp / "two.fasta"
    fasta.write_fasta(path, records, width=73)
    ck = {name: str(tmp / name) for name in ("dense", "bucket", "dist3", "dist21")}
    csv = {k: str(tmp / f"d{k}.csv") for k in (3, 21)}
    first = launch(tmp, "first", path, 2, [
        {"name": "bucket", "kind": "bucket", "k": 21, "owner_mode": "minimizer",
         "ckpt": ck["bucket"], "batch": BATCH, "max_steps": 2},
        {"name": "dist3", "kind": "dist", "k": 3, "csv": csv[3], "ckpt": ck["dist3"],
         "max_panels": 2},
        {"name": "dist21", "kind": "dist", "k": 21, "csv": csv[21], "ckpt": ck["dist21"],
         "max_panels": 2},
        {"name": "dense", "kind": "dense", "k": 4, "ckpt": ck["dense"], "batch": BATCH,
         "max_steps": 3,
         "kill_rank": 1, "kill_cursor": 3 * BATCH},
    ], killed=1)
    stitched_early = {k: os.path.exists(csv[k]) for k in (3, 21)}
    second = launch(tmp, "second", path, 2, [
        {"name": "count5", "kind": "count", "k": 5},
        {"name": "count8c", "kind": "count", "k": 8, "canonical": True},
        {"name": "shard_row", "kind": "shard_row", "k": 21},
        {"name": "dense_one", "kind": "dense", "k": 4, "ckpt": ck["dense"], "batch": BATCH,
         "max_steps": 1},
        {"name": "dense", "kind": "dense", "k": 4, "ckpt": ck["dense"], "batch": BATCH},
        {"name": "bucket", "kind": "bucket", "k": 21, "owner_mode": "minimizer",
         "ckpt": ck["bucket"], "batch": BATCH},
        {"name": "dist3", "kind": "dist", "k": 3, "csv": csv[3], "ckpt": ck["dist3"]},
        {"name": "dist21", "kind": "dist", "k": 21, "csv": csv[21], "ckpt": ck["dist21"]},
    ])
    return {"path": path, "seqs": [s for _, s in records], "first": first, "second": second,
            "csv": csv, "stitched_early": stitched_early, "tmp": tmp}


def test_first_range_is_the_longest(two_ranks):
    path = str(two_ranks["path"])
    lengths = [multihost.encode_range_stream(path, a, b)[0].size
               for a, b in multihost.split_fasta_byte_ranges(path, 2)]
    assert lengths[0] > lengths[1] > 0


@pytest.mark.parametrize("name,k,canonical", [("count5", 5, False), ("count8c", 8, True)])
def test_count_file_multihost_two_ranks(two_ranks, name, k, canonical):
    path, seqs = str(two_ranks["path"]), two_ranks["seqs"]
    want, _, _ = jmh.count_file_multihost(path, JaxConfig(k=k, canonical=canonical),
                                          jax_mesh(2))
    assert np.array_equal(want, sum(oracle.count_vector(s, k, canonical) for s in seqs))
    got = two_ranks["second"]
    for r in range(2):
        assert np.array_equal(got[r][name], want)
    # each rank's own records and bases; together the file's
    assert (got[0][name + ".seqs"] + got[1][name + ".seqs"]).tolist() == [
        sum(map(len, seqs)), len(seqs)]


def test_bucket_rows_of_one_rank_equal_the_global_rows(two_ranks):
    for got in two_ranks["second"]:
        assert np.array_equal(got["shard_row.global"], got["shard_row.local"])
        assert got["shard_row.local"].shape[1] == 1  # this rank's row alone
    assert not np.array_equal(two_ranks["second"][0]["shard_row.local"],
                              two_ranks["second"][1]["shard_row.local"])


def test_dense_resumable_killed_one_step_apart(two_ranks):
    path, tmp = str(two_ranks["path"]), two_ranks["tmp"]
    first, second = two_ranks["first"], two_ranks["second"]
    n_steps = int(first[0]["dense.steps"][1])
    assert first[1] is None and first[0]["dense.steps"][0] == 3 < n_steps
    # rank 0 saved steps 2 and 3, rank 1 steps 1 and 2: the common step is 2
    assert second[0]["dense_one.steps"][0] == second[1]["dense_one.steps"][0] == 3
    want, *_ = jmh.count_file_multihost_resumable(path, JaxConfig(k=4), jax_mesh(2),
                                                  batch_bases=BATCH)
    for r in range(2):
        assert second[r]["dense.steps"].tolist() == [n_steps, n_steps]
        assert np.array_equal(second[r]["dense"], want)
    assert sorted(p.name for p in tmp.glob("dense.p*")) == [
        f"dense.p{r}.g{g}.npz" for r in range(2) for g in range(2)]


def test_bucketed_resumable_killed_and_resumed(two_ranks):
    path = str(two_ranks["path"])
    first, second = two_ranks["first"], two_ranks["second"]
    assert first[0]["bucket.steps"][0] == 2 < first[0]["bucket.steps"][1]
    tables = [(second[r]["bucket.codes"], second[r]["bucket.counts"]) for r in range(2)]
    assert not set(tables[0][0].tolist()) & set(tables[1][0].tolist())  # owners are disjoint
    codes, counts = merge_sparse_tables(tables)
    want = jmh.count_file_bucketed_multihost_resumable(
        path, JaxConfig(k=21), jax_mesh(2), batch_bases=BATCH, owner_mode="minimizer")
    assert np.array_equal(codes, want[0]) and np.array_equal(counts, want[1])


@pytest.mark.parametrize("k", [3, 21])
def test_distances_killed_and_stitched(two_ranks, k):
    path, tmp = str(two_ranks["path"]), two_ranks["tmp"]
    first, second = two_ranks["first"], two_ranks["second"]
    name = f"dist{k}"
    assert not two_ranks["stitched_early"][k]
    assert [bool(first[0][name][i]) for i in range(2)] == [False, False]
    S = len(two_ranks["seqs"])
    rows = [second[r][name][2:].tolist() for r in range(2)]
    assert rows[0][0] == 0 and rows[0][1] == rows[1][0] and rows[1][1] == S - 1
    for r in range(2):
        assert bool(second[r][name][0]) and bool(second[r][name][1])
        assert str(second[r][name + ".regime"]) == ("dense" if k == 3 else "sparse")
    want = tmp / f"jax{k}.csv"
    jmh.distance_file_multihost_resumable(path, JaxConfig(k=k), str(want), panel_rows=2)
    assert Path(two_ranks["csv"][k]).read_bytes() == want.read_bytes()


def test_three_ranks_over_one_record(tmp_path):
    # Two of the three ranges are empty: those ranks still run every step
    # of every collective, with all-INVALID slabs.
    path = tmp_path / "tiny.fasta"
    seq = "ACGTACGTTGCAGGATCCATNACGTTTGACCAGT" * 3
    fasta.write_fasta(path, [(">a", seq)])
    assert multihost.split_fasta_byte_ranges(str(path), 3)[1:] == [(path.stat().st_size,) * 2] * 2
    got = launch(tmp_path, "three", path, 3, [
        {"name": "count", "kind": "count", "k": 3},
        {"name": "dense", "kind": "dense", "k": 2, "ckpt": str(tmp_path / "d"), "batch": BATCH},
        {"name": "bucket", "kind": "bucket", "k": 21, "owner_mode": "prefix",
         "ckpt": str(tmp_path / "b"), "batch": BATCH},
    ])
    want3 = oracle.count_vector(seq, 3)
    want2 = oracle.count_vector(seq, 2)
    table = oracle.count_table_any_k([seq], 21)
    codes, counts = merge_sparse_tables([(g["bucket.codes"], g["bucket.counts"]) for g in got])
    assert len(codes) == len(table) and int(counts.sum()) == sum(table.values())
    for r, g in enumerate(got):
        assert np.array_equal(g["count"], want3) and np.array_equal(g["dense"], want2)
        assert g["count.seqs"].tolist() == ([len(seq), 1] if r == 0 else [0, 0])
        assert g["dense.steps"].tolist() == [1, 1]
