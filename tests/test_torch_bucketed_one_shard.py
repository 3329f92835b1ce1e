"""The bucket-sharded count on a one-shard mesh: every exchange at every k
and canonical, against the host counter (the JAX package and
``native.count_sparse_host_native`` agree on these inputs), and the
aggregated exchange against the JAX package itself.

At D=1 the prefix owner of every window is 0. The aggregated exchange
routed single-word windows (k <= 15) by their lo word, so it kept only
the code-0 windows; it now routes by hi widened to zeros, as the JAX path
does. Integer tables: the tolerance is zero."""

import numpy as np
import pytest

from dna_kmeres_parallel_tpu.parallel import bucketed as jb
from dna_kmeres_parallel_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.parallel import bucketed as pb
from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh

EXCHANGES = ("agg", "raw", "super", "auto")


def one_shard_stream() -> np.ndarray:
    """5,000 seeded bases with an N run and a homopolymer."""
    b = np.random.default_rng(0).integers(0, 4, 5000).astype(np.uint8)
    b[100:130] = 0xFF
    b[2000:2100] = 3
    return b


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", range(1, 32))
def test_one_shard_mesh_every_exchange(k, canonical):
    flat = one_shard_stream()
    want = native.count_sparse_host_native(flat, k, canonical)
    for exchange in EXCHANGES:
        run = lambda: pb.count_bucket_auto(flat, k, canonical, LocalMesh(1, "cpu"),  # noqa: E731
                                           exchange=exchange)
        if exchange == "super" and k <= 7:
            # The records need a minimizer m=7 below k, as in the JAX package.
            with pytest.raises(ValueError, match="1 <= m < k"):
                run()
            continue
        got = run()
        assert np.array_equal(got[0], want[0]), (exchange, got[0].size, want[0].size)
        assert np.array_equal(got[1], want[1]), exchange


@pytest.mark.parametrize("k,canonical", [(1, False), (5, True), (8, False), (13, False),
                                         (15, True), (16, False), (21, True), (31, False)])
def test_one_shard_agg_equals_jax(k, canonical):
    flat = one_shard_stream()
    got = pb.count_bucket_auto(flat, k, canonical, LocalMesh(1, "cpu"), exchange="agg")
    want = jb.count_bucket_auto(flat, k, canonical, jax_make_mesh(1), exchange="agg")
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert np.array_equal(got[1], np.asarray(want[1]))
