"""dna_kmeres_parallel_tpu_torch — the PyTorch and CUDA port of
``dna_kmeres_parallel_tpu``.

It imports ``torch`` and never ``jax``. From the JAX package it uses only
the jax-free modules: ``utils`` (codec, config, fasta, datagen), the C++
host library ``native`` and ``models.oracle``. The JAX package stays the
reference every part of the port is held against.

Layout (module names follow the JAX package's, so each counterpart is
easy to find)
------
- ``ops/``     the split-word encode (``sparse``), its hand-written CUDA
               kernel's wrapper and plain PyTorch version (``encode_cuda``),
               the kernel build (``kernels``) and device resolution
               (``runtime``).
- ``csrc/``    CUDA C++ sources for Hopper (``sm_90a``), built with nvcc at
               first use.
- ``models/``  host plane staging (``engine``) and the sparse counting
               engine (``sparse_engine``).

What is ported: exact sparse k-mer counting, k = 1..31, canonical or not.
Every public entry takes an explicit ``device``: ``"cuda"`` runs the
hand-written kernel and raises where CUDA is missing; ``"cpu"`` runs the
kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

from dna_kmeres_parallel_tpu.utils.config import KmerConfig  # noqa: F401


def _sparse_config(k: int, canonical: bool, kw) -> KmerConfig:
    cfg = KmerConfig(k=k, canonical=canonical, **kw)
    if cfg.dense:
        raise NotImplementedError(
            f"k={k} counts on the dense route (4^k <= dense_bins_limit="
            f"{cfg.dense_bins_limit}), which is not ported yet (ROADMAP "
            "item 6); SparseKmerEngine counts any k directly"
        )
    return cfg


def count_file(path, k: int = 21, canonical: bool = False, device="cuda", **kw):
    """Count k-mers in a FASTA file -> SparseCountResult (sorted table)."""
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseKmerEngine

    cfg = _sparse_config(k, canonical, kw)
    return SparseKmerEngine(cfg, device=device).count_file(path)


def count_sequences(
    seqs, k: int = 21, canonical: bool = False, device="cuda", **kw
):
    """Count k-mers over in-memory sequences (list of ACGT strings)."""
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseKmerEngine

    cfg = _sparse_config(k, canonical, kw)
    return SparseKmerEngine(cfg, device=device).count_sequences(list(seqs))


__all__ = ["KmerConfig", "__version__", "count_file", "count_sequences"]
