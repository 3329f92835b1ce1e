"""dna_kmeres_parallel_tpu_torch — the PyTorch and CUDA port of the JAX
package ``dna_kmeres_parallel_tpu``.

It imports ``torch`` and never ``jax``, and nothing of the JAX package: it
keeps its own copies of the host code it needs (``utils``, and the C++
host library under ``native``). The JAX package stays the reference every
part of the port is held against, in the tests.

Layout (module names follow the JAX package's, so each counterpart is
easy to find)
------
- ``ops/``     the split-word encode (``sparse``), the plain dense encode
               and 2-bit unpack (``encode``), histograms and counts
               matrices (``histogram``), the (min,+)
               product and the distance finish (``distance``); the
               hand-written CUDA kernels' wrappers beside their plain
               PyTorch versions (``encode_cuda``, ``histogram_cuda``,
               ``distance_cuda``, ``sort_cuda``); the threshold (min,+)
               route on int8 tensor cores (``threshold_cuda``); the kernel build
               (``kernels``) and device resolution (``runtime``).
- ``csrc/``    CUDA C++ sources for Hopper (``sm_90a``), built with nvcc at
               first use.
- ``parallel/`` meshes (``mesh``: D shards on one device, or one per rank
               of a ``torch.distributed`` group, with their
               collectives), data-parallel dense counting and
               distances (``sharded_count``) and sparse counting
               (``sharded_sparse``), and the bucket-sharded count
               (``bucketed``).
- ``models/``  batch staging and the dense counting and distance engine
               (``engine``),
               the sparse counting engine and the sparse-table
               distances (``sparse_engine``), the
               resumable streaming counter (``pipeline``) and the
               resumable distance-CSV writer (``distance_stream``).
- ``native/``  the C++ host library (parse, pack, radix compaction, merge,
               ``%f`` formatting), built with g++ at first use.
- ``utils/``   codec, configuration, FASTA parsing, packed-triangle
               indexing, CSV writers, the checkpoint files, run metrics,
               profiler traces.

What is ported: exact k-mer counting, k = 1..31, canonical or not, as a
dense histogram where 4^k <= dense_bins_limit (k <= 12 by default) and as
a sorted sparse table above, in one shot or streamed with checkpoint and
resume (``models.pipeline.StreamingCounter``, data parallel over a mesh
with ``mesh_shape``), and bucket-sharded over a mesh
(``parallel.bucketed.count_bucket_auto``); pairwise k-mer
distances at k = 1..31, in memory or streamed to the reference's CSV: from
dense counts (``KmerEngine``, k <= 15 where the [S, 4^k] matrix fits the
memory gate) and from sparse per-sequence tables
(``models.sparse_engine.distance_sparse_packed`` and
``distance_sparse_stream_to_csv``). Every public entry takes an explicit
``device``:
``"cuda"`` runs the hand-written kernels and raises where CUDA is missing;
``"cpu"`` runs the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"

from dna_kmeres_parallel_tpu_torch.utils.config import KmerConfig  # noqa: F401


def _engine(k: int, canonical: bool, device, kw):
    """The engine ``count_file`` / ``count_sequences`` use, as the JAX
    package routes: the dense engine where 4^k <= dense_bins_limit (k <= 12
    by default), the sparse engine above."""
    cfg = KmerConfig(k=k, canonical=canonical, **kw)
    if cfg.dense:
        from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine

        return KmerEngine(cfg, device=device)
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseKmerEngine

    return SparseKmerEngine(cfg, device=device)


def count_file(path, k: int = 21, canonical: bool = False, device="cuda", **kw):
    """Count k-mers in a FASTA file -> CountResult (dense int64 histogram,
    k <= 12 by default) or SparseCountResult (sorted table, larger k)."""
    return _engine(k, canonical, device, kw).count_file(path)


def count_sequences(
    seqs, k: int = 21, canonical: bool = False, device="cuda", **kw
):
    """Count k-mers over in-memory sequences (list of ACGT strings)."""
    return _engine(k, canonical, device, kw).count_sequences(list(seqs))


def distance_file(path, k: int = 3, canonical: bool = False, device="cuda", **kw):
    """Packed pairwise k-mer distances of the records of a FASTA file ->
    DistanceResult, from dense counts: k <= 15 where the [S, 4^k] counts
    matrix fits ``sparse_engine.dense_distance_feasible``; otherwise it
    raises, and ``sparse_engine.distance_sparse_packed`` serves the k."""
    from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine

    cfg = KmerConfig(k=k, canonical=canonical, **kw)
    return KmerEngine(cfg, device=device).distance_file(path)


def distance_sequences(
    seqs, k: int = 3, canonical: bool = False, device="cuda", ids=None, **kw
):
    """Packed pairwise k-mer distances of in-memory sequences (list of
    ACGT strings) -> DistanceResult, from dense counts, as
    ``distance_file``."""
    from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine

    cfg = KmerConfig(k=k, canonical=canonical, **kw)
    return KmerEngine(cfg, device=device).distance_sequences(list(seqs), ids=ids)


__all__ = [
    "KmerConfig",
    "__version__",
    "count_file",
    "count_sequences",
    "distance_file",
    "distance_sequences",
]
