"""The port's data-parallel layer (``parallel/mesh`` collectives,
``parallel/sharded_count``, ``parallel/sharded_sparse``, ``graft_entry``)
on ``LocalMesh(D, "cpu")``, against the JAX package's
``parallel/sharded_count`` and ``parallel/sharded_sparse`` on its virtual
CPU mesh, on the same seeded inputs; and a two-rank gloo
``ProcessGroupMesh`` against ``LocalMesh(2)``.

Integer histograms, min-sums and tables: the tolerance is zero."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from dna_kmeres_parallel_tpu.models import oracle
from dna_kmeres_parallel_tpu.parallel import sharded_count as jsc
from dna_kmeres_parallel_tpu.parallel import sharded_sparse as jss
from dna_kmeres_parallel_tpu.parallel.mesh import DATA_AXIS
from dna_kmeres_parallel_tpu.parallel.mesh import make_mesh as jax_mesh
from dna_kmeres_parallel_tpu_torch import graft_entry
from dna_kmeres_parallel_tpu_torch.parallel import sharded_count as sc
from dna_kmeres_parallel_tpu_torch.parallel import sharded_sparse as ss
from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh
from dna_kmeres_parallel_tpu_torch.ops import distance_cuda

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def mesh8():
    return LocalMesh(8, "cpu")


@pytest.fixture(scope="module")
def jmesh8():
    return jax_mesh(8)


def stream(seed: int, n: int, invalid: float = 0.03) -> np.ndarray:
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 4, n).astype(np.uint8)
    flat[rng.random(n) < invalid] = 0xFF
    return flat


def same(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("k", [1, 3, 8, 12])
def test_halo_exchange_matches_jax(mesh8, jmesh8, k):
    # Each shard followed by the next one's first k-1 bases (INVALID after
    # the last); at k=12 the 8-base shards hand over all they have.
    flat = stream(k, 64)
    fn = shard_map(lambda b: jsc.halo_exchange(b, k), mesh=jmesh8, in_specs=P(DATA_AXIS),
                   out_specs=P(DATA_AXIS), check_vma=False)
    want = np.asarray(fn(jnp.asarray(flat))).reshape(8, -1)
    got = sc.halo_exchange(torch.from_numpy(flat.reshape(8, -1)), k, mesh8).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("own", [None, 0, 1, 777, 2399])
def test_count_sharded_matches_jax(mesh8, jmesh8, k, canonical, own):
    # n_own is GLOBAL: windows whose start in the whole stream is below it.
    flat = stream(10 * k + canonical, 8 * 300)
    bins = 4**k
    acc = np.arange(bins, dtype=np.int32) if own is not None else None
    want = jsc.count_sharded(jsc.device_put_sharded_stream(flat, jmesh8), k, bins, canonical,
                             jmesh8, n_own=own,
                             acc=None if acc is None else jnp.asarray(acc))
    got = sc.count_sharded(sc.shard_stream(flat, mesh8), k, bins, canonical, mesh8, n_own=own,
                           acc=None if acc is None else torch.from_numpy(acc.copy()))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))
    if own is None:
        assert np.array_equal(got.numpy(), oracle.count_vector(flat, k, canonical))


def test_count_sharded_at_3000_bins(mesh8, jmesh8):
    # Bins that are no power of two (K8 per shard on the card). The JAX
    # package's K8 drops bins above 2,048 that are not a power of two
    # (ROADMAP queue 3), so its plain jnp route is the reference here.
    flat = stream(5, 8 * 400)
    got = sc.count_sharded(sc.shard_stream(flat, mesh8), 6, 3000, False, mesh8, n_own=3000)
    want = jsc.count_sharded(jsc.device_put_sharded_stream(flat, jmesh8), 6, 3000, False, jmesh8,
                             n_own=3000)
    assert got.shape == (3000,) and np.array_equal(got.numpy(), np.asarray(want))


def test_count_sharded_flat_and_rows_agree_and_refuse_ragged(mesh8):
    flat = stream(6, 8 * 50)
    by_rows = sc.count_sharded(sc.shard_stream(flat, mesh8), 3, 64, False, mesh8)
    by_flat = sc.count_sharded(torch.from_numpy(flat), 3, 64, False, mesh8)
    assert np.array_equal(by_rows.numpy(), by_flat.numpy())
    with pytest.raises(ValueError, match="divisible"):
        sc.count_sharded(torch.from_numpy(flat[:-1]), 3, 64, False, mesh8)


def test_shard_stream_pads_with_invalid(mesh8, jmesh8):
    flat = stream(7, 8 * 20 + 3)
    rows = sc.shard_rows(flat, mesh8)
    assert rows.shape == (8, 21) and (rows.reshape(-1)[flat.size:] == 0xFF).all()
    assert np.array_equal(rows.reshape(-1),
                          np.asarray(jsc.device_put_sharded_stream(flat, jmesh8)))


def counts_rows(seed: int, n: int, k: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGTN"), size=int(rng.integers(20, 90))))
            for _ in range(n)]
    return oracle.counts_matrix(seqs, k).astype(np.int32)


def test_min_sum_matrix_sharded_matches_jax(mesh8, jmesh8):
    counts = counts_rows(1, 24)
    want = np.asarray(jsc.min_sum_matrix_sharded(jnp.asarray(counts), jmesh8))
    got = sc.min_sum_matrix_sharded(torch.from_numpy(counts), mesh8)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="divisible"):
        sc.min_sum_matrix_sharded(torch.from_numpy(counts[:20]), mesh8)


@pytest.mark.parametrize("D", [3, 8])
def test_min_sum_panel_sharded_matches_jax(D):
    panel, other = counts_rows(2, 6), counts_rows(3, 24)
    want = np.asarray(jsc.min_sum_panel_sharded(jnp.asarray(panel), jnp.asarray(other),
                                                jax_mesh(D)))
    got = sc.min_sum_panel_sharded(torch.from_numpy(panel), torch.from_numpy(other),
                                   LocalMesh(D, "cpu"))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", [3, 8])
def test_min_sum_panel_mesh_pads_partners_and_keeps_either_route(D):
    # 2,048 partners at D=8, 29 at D=3 (not a multiple of D). The panel
    # and the last partner block hold a row summing past 2^16, so that
    # block takes the i32 route and the others (and the padding's zero
    # rows) the packed one: the sums equal the unsharded product.
    from dna_kmeres_parallel_tpu_torch.models.engine import min_sum_panel_mesh

    rng = np.random.default_rng(D)
    S2 = 2048 if D == 8 else 29
    other = rng.integers(0, 9, (S2, 16)).astype(np.int32)
    other[-1, 0] = 70_000
    panel = np.concatenate([other[-3:], rng.integers(0, 9, (2, 16)).astype(np.int32)])
    got = min_sum_panel_mesh(torch.from_numpy(panel), torch.from_numpy(other),
                             LocalMesh(D, "cpu"))
    want = np.minimum(panel[:, None, :], other[None, :, :]).sum(-1)
    assert got.shape == (5, S2) and np.array_equal(got.numpy(), want)
    pad = -(-S2 // D) * D - S2
    blocks = np.concatenate([other, np.zeros((pad, 16), np.int32)]).reshape(D, -1, 16)
    routes = {distance_cuda.product_route(*distance_cuda.check_counts(
        torch.from_numpy(panel), torch.from_numpy(b))) for b in blocks}
    assert routes == {distance_cuda.PACKED, distance_cuda.WIDE}


@pytest.mark.parametrize("device_sort", [False, True])
@pytest.mark.parametrize("pack_input", [False, True])
@pytest.mark.parametrize("k,canonical", [(13, False), (21, True)])
def test_count_sparse_sharded_routes_match_jax(mesh8, jmesh8, device_sort, pack_input, k,
                                               canonical):
    flat = stream(20 + k, 3000)
    got = ss.count_sparse_sharded(flat, k, canonical, mesh8, row_len=128,
                                  device_sort=device_sort, pack_input=pack_input,
                                  pallas_sort=k <= 15)
    want = jss.count_sparse_sharded(flat, k, canonical, jmesh8, row_len=128,
                                    device_sort=device_sort, pallas=None)
    assert same(got, want)


def test_count_sparse_sharded_device_count_invariant_and_total_own(jmesh8):
    flat = stream(8, 2500)
    tables = [ss.count_sparse_sharded(flat, 21, False, LocalMesh(d, "cpu"), row_len=128)
              for d in (1, 2, 3, 5, 8)]
    assert all(same(t, tables[0]) for t in tables)
    got = ss.count_sparse_sharded(flat, 21, False, LocalMesh(8, "cpu"), total_own=1700,
                                  device_sort=False)
    want = jss.count_sparse_sharded(flat, 21, False, jmesh8, total_own=1700,
                                    device_sort=False, pallas=None)
    assert same(got, want) and int(got[1].sum()) < int(tables[0][1].sum())


def test_sharded_counters_empty_stream(mesh8):
    flat = np.zeros(0, np.uint8)
    for device_sort in (False, True):
        codes, counts = ss.count_sparse_sharded(flat, 21, False, mesh8, row_len=64,
                                                device_sort=device_sort)
        assert codes.size == 0 and counts.size == 0


def test_dryrun_multichip_on_the_cpu(capsys):
    out = graft_entry.dryrun_multichip(8, device="cpu")
    assert out["min_sums"] == (16, 16) and out["panel"] == (4, 16)
    assert "equal the oracle" in capsys.readouterr().out


def test_entry_forward_step_matches_the_jax_entry():
    import __graft_entry__ as jax_entry

    fn, args = graft_entry.entry("cpu")
    hist, square = fn(*args)
    jfn, jargs = jax_entry.entry()
    jhist, jsquare = jfn(*jargs)
    assert np.array_equal(args[0].numpy(), np.asarray(jargs[0]))
    assert np.array_equal(hist.numpy(), np.asarray(jhist))
    assert square.dtype == torch.float32
    assert np.array_equal(square.numpy().view(np.uint32), np.asarray(jsquare).view(np.uint32))


# ---------------------------------------------------------------------------
# A process group of two ranks (gloo)

_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, sys.argv[1])
from dna_kmeres_parallel_tpu_torch.parallel import sharded_count as sc
from dna_kmeres_parallel_tpu_torch.parallel.mesh import ProcessGroupMesh

root, init, rank, out = sys.argv[1:5]
rank = int(rank)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
try:
    rng = np.random.default_rng(12)
    flat = rng.integers(0, 4, 2 * 150 + 1).astype(np.uint8)
    flat[rng.random(flat.size) < 0.03] = 0xFF
    counts = rng.integers(0, 5, (10, 16)).astype(np.int32)
    mesh = ProcessGroupMesh("cpu")
    rows = sc.shard_stream(flat, mesh)
    acc = torch.arange(64, dtype=torch.int32)
    got = {
        "halo": sc.halo_exchange(rows, 5, mesh).numpy(),
        "count3": sc.count_sharded(rows, 3, 64, False, mesh, n_own=200, acc=acc).numpy(),
        "count8": sc.count_sharded(rows, 8, 4**8, True, mesh).numpy(),
        "panel": sc.min_sum_panel_sharded(torch.from_numpy(counts[:3]),
                                          torch.from_numpy(counts[5 * rank : 5 * rank + 5]),
                                          mesh).numpy(),
        "matrix": sc.min_sum_matrix_sharded(torch.from_numpy(counts[5 * rank : 5 * rank + 5]),
                                            mesh).numpy(),
    }
finally:
    dist.destroy_process_group()
np.savez(out, **got)
"""


def test_process_group_mesh_two_ranks_equals_local_mesh(tmp_path):
    init = f"file://{tmp_path / 'pg'}"
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, str(REPO), init, str(r), str(outs[r])],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)
    ]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("process-group workers timed out")
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-3000:]}"
    rng = np.random.default_rng(12)
    flat = rng.integers(0, 4, 2 * 150 + 1).astype(np.uint8)
    flat[rng.random(flat.size) < 0.03] = 0xFF
    counts = rng.integers(0, 5, (10, 16)).astype(np.int32)
    mesh = LocalMesh(2, "cpu")
    rows = sc.shard_stream(flat, mesh)
    halo = sc.halo_exchange(rows, 5, mesh).numpy()
    count3 = sc.count_sharded(rows, 3, 64, False, mesh, n_own=200,
                              acc=torch.arange(64, dtype=torch.int32)).numpy()
    count8 = sc.count_sharded(rows, 8, 4**8, True, mesh).numpy()
    panel = sc.min_sum_panel_sharded(torch.from_numpy(counts[:3]), torch.from_numpy(counts),
                                     mesh).numpy()
    matrix = sc.min_sum_matrix_sharded(torch.from_numpy(counts), mesh).numpy()
    assert np.array_equal(count8, oracle.count_vector(flat, 8, True))
    for r, out in enumerate(outs):
        got = np.load(out)
        assert np.array_equal(got["halo"], halo[r : r + 1])
        assert np.array_equal(got["count3"], count3)
        assert np.array_equal(got["count8"], count8)
        assert np.array_equal(got["panel"], panel[:, 5 * r : 5 * r + 5])
        assert np.array_equal(got["matrix"], matrix[5 * r : 5 * r + 5])
