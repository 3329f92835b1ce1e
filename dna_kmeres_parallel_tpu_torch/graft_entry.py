"""The port's counterparts of the repository's ``__graft_entry__.py``.

entry()                -> (fn, example_args): the k=3 forward step of the
                          distance workload (the per-sequence counts, K2;
                          their histogram; the (min,+) product, K3; the
                          float32 finish on the host) and its example
                          tensors on the device.
dryrun_multichip(n)    -> one data-parallel step on a mesh of n shards,
                          each result held against the port's oracle:
                          ``count_sharded`` (halos, the summed histogram),
                          ``min_sum_matrix_sharded`` (rows sharded against
                          the gathered matrix) and ``min_sum_panel_sharded``
                          (partner rows sharded, no collective).
"""

from __future__ import annotations

import numpy as np
import torch

_K = 3
_BINS = 1 << (2 * _K)


def _forward(bases_grid: torch.Tensor, lengths: np.ndarray):
    """[S, L] uint8 base codes (INVALID past a row's end) and [S] lengths
    -> (the summed histogram, int32 [bins], on the grid's device; the
    float32 [S, S] distance matrix, on the host)."""
    from dna_kmeres_parallel_tpu_torch.ops import distance as dist_ops
    from dna_kmeres_parallel_tpu_torch.ops import distance_cuda, histogram_cuda

    counts = histogram_cuda.counts_matrix_grid(bases_grid, _K, _BINS)
    hist = counts.sum(0, dtype=torch.int32)
    sums = distance_cuda.min_sum_matrix_tri(counts).cpu().numpy()
    return hist, torch.from_numpy(dist_ops.finish_distances(sums, lengths, _K))


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): ``_forward`` and 8 random records of 256 bases
    on ``device`` (the card unless the caller asks for the CPU)."""
    from dna_kmeres_parallel_tpu_torch.ops import runtime

    dev = runtime.resolve_device(device)
    S, L = 8, 256
    rng = np.random.default_rng(0)
    grid = torch.from_numpy(rng.integers(0, 4, size=(S, L)).astype(np.uint8)).to(dev)
    lengths = np.full(S, L, dtype=np.int64)
    return _forward, (grid, lengths)


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> dict:
    """One sharded counting and distance step on a ``LocalMesh`` of
    ``n_devices`` shards on ``device``, on tiny shapes; every result must
    equal the oracle's, or AssertionError. Returns what was checked."""
    from dna_kmeres_parallel_tpu_torch.models import oracle
    from dna_kmeres_parallel_tpu_torch.parallel import sharded_count as sc
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh
    from dna_kmeres_parallel_tpu_torch.utils import codec

    mesh = LocalMesh(n_devices, device)

    # sharded counting over a flat stream of 6 records of 97 bases
    rng = np.random.default_rng(1)
    seqs = ["".join(rng.choice(list("ACGT"), size=97)) for _ in range(6)]
    stream = sc.shard_stream(codec.concat_with_sentinels(seqs), mesh)
    hist = sc.count_sharded(stream, _K, _BINS, False, mesh).cpu().numpy()
    want = oracle.counts_matrix(seqs, _K).sum(axis=0)
    assert np.array_equal(hist.astype(np.int64), want), "sharded count != oracle"

    # row-sharded and partner-sharded (min,+) products
    S = 2 * n_devices
    counts = oracle.counts_matrix(
        ["".join(rng.choice(list("ACGT"), size=64)) for _ in range(S)], _K
    ).astype(np.int32)
    want_sums = np.minimum(counts[:, None, :], counts[None, :, :]).sum(-1)
    counts_dev = torch.from_numpy(counts).to(mesh.device)
    sums = sc.min_sum_matrix_sharded(counts_dev, mesh).cpu().numpy()
    assert np.array_equal(sums, want_sums), "sharded min-sum != oracle"
    panel = sc.min_sum_panel_sharded(counts_dev[:4], counts_dev, mesh).cpu().numpy()
    assert np.array_equal(panel, want_sums[:4]), "partner-sharded panel != oracle"
    print(f"dryrun_multichip({n_devices}): sharded count ({int(hist.sum())} windows), "
          f"{S}x{S} min-sums and a [4, {S}] panel equal the oracle on {mesh}")
    return {"windows": int(hist.sum()), "min_sums": sums.shape, "panel": panel.shape}
