"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card: K1 (encode) and its minimizer plane K1m, K2 (counts matrix), K3
and K4 ((min,+) products), K5-K8 (dense histograms), K9 (u8 encode), K10
(owner segments), P1 (row roll) and K11 (row sort); and the paths that
run them.
Every test here needs an NVIDIA card and skips without one.

The file imports no JAX, so it also runs where JAX is not installed (as on
the machine with the card), without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Integer codes: every comparison is exact (tolerance zero)."""

import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu_torch.models import engine
from dna_kmeres_parallel_tpu_torch.ops import (
    distance,
    distance_cuda,
    encode_cuda,
    histogram_cuda,
)
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops
from dna_kmeres_parallel_tpu_torch.utils import codec

KS = [1, 11, 13, 15, 16, 21, 23, 24, 31]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def stream(n: int, seed: int) -> np.ndarray:
    """Seeded u8 stream of n bases (a multiple of 16): 3% N, one N run and
    an all-T stretch where the length allows."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, n).astype(np.uint8)
    b[rng.random(n) < 0.03] = codec.INVALID_BASE
    if n >= 2048:
        b[300:340] = codec.INVALID_BASE
        b[1000:1064] = 3
    return b


def kernel_and_plain(bases, n_own, k, canonical, dev):
    planes = engine.stage_batch_planes(bases, dev)
    launches = encode_cuda.LAUNCHES
    got = sparse_ops.encode_words_planes(*planes, n_own, k, canonical)
    assert encode_cuda.LAUNCHES == launches + 1
    ref = sparse_ops.narrow_words(
        *encode_cuda.encode_packed_reference(*planes, n_own, k, canonical), k
    )
    torch.cuda.synchronize()
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_kernel_matches_plain_on_card(cuda_device, k, canonical):
    bases = stream(4096, k)
    got, ref = kernel_and_plain(bases, 4096 - 200, k, canonical, cuda_device)
    for g, r in zip(got, ref, strict=True):
        assert g.device.type == "cuda" and g.dtype == r.dtype
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,n_own,k",
    [(16, 16, 1), (16, 16, 16), (16, 16, 31), (32, 5, 21), (48, 48, 31),
     (48, 0, 13), (4096, 10**9, 24)],
)
def test_kernel_edges_on_card(cuda_device, n, n_own, k):
    # One- to three-word planes (windows past the plane are invalid),
    # nothing owned, and n_own past the end.
    got, ref = kernel_and_plain(stream(n, n + k), n_own, k, True, cuda_device)
    for g, r in zip(got, ref, strict=True):
        assert torch.equal(g, r)
    valid = int((got[0] != -1).sum())
    assert valid <= max(0, min(n_own, n - k + 1))


def base_grid(S: int, L: int, seed: int) -> np.ndarray:
    """Seeded u8 grid [S, L]: 3% N, an N run, rows of every length from 0
    up (0xFF past a row's end), so some rows are shorter than k."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, (S, L)).astype(np.uint8)
    g[rng.random((S, L)) < 0.03] = codec.INVALID_BASE
    if L > 40:
        g[0, 10:30] = codec.INVALID_BASE
    for r, n in enumerate(rng.integers(0, L + 1, S)):
        g[r, n:] = codec.INVALID_BASE
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize(
    "S,L,k,bins",
    [(1, 1, 3, 64), (5, 2, 3, 64), (37, 300, 3, 64), (64, 513, 5, 1024),
     (9, 2000, 8, 65536), (3, 40, 1, 4), (16, 200, 10, 65536), (2, 0, 3, 64)],
)
def test_counts_matrix_kernel_matches_plain(cuda_device, S, L, k, bins, canonical):
    # k=10 keeps only the codes below 65,536 (the rest are dropped, as in
    # the plain version); L=0 and L=2 hold no window.
    grid = torch.from_numpy(base_grid(S, L, S * 7 + L)).to(cuda_device)
    launches = histogram_cuda.COUNTS_LAUNCHES
    got = histogram_cuda.counts_matrix_grid(grid, k, bins, canonical)
    assert histogram_cuda.COUNTS_LAUNCHES == launches + 1
    ref = histogram_cuda.counts_matrix_reference(grid, k, bins, canonical)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (S, bins)
    assert torch.equal(got, ref)


def counts(S: int, B: int, seed: int, dev, cmax: int = 9) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cmax + 1, (S, B)).astype(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "S,B", [(1, 1), (1, 64), (2, 3), (63, 64), (64, 64), (65, 300), (130, 1024), (200, 33)]
)
def test_min_sum_tri_kernel_matches_plain(cuda_device, S, B):
    a = counts(S, B, S + B, cuda_device)
    launches = distance_cuda.TRI_LAUNCHES
    got = distance_cuda.min_sum_matrix_tri(a)
    assert distance_cuda.TRI_LAUNCHES == launches + 1
    ref = distance.min_sum_matrix(a)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (S, S)
    assert torch.equal(got, ref)
    assert torch.equal(got, got.T)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "S,S2,B", [(1, 1, 1), (1, 200, 64), (70, 1, 64), (129, 65, 300), (64, 128, 1024), (5, 77, 65536)]
)
def test_min_sum_rect_kernel_matches_plain(cuda_device, S, S2, B):
    a = counts(S, B, S, cuda_device)
    b = counts(S2, B, S2 + 1, cuda_device, cmax=3)
    launches = distance_cuda.RECT_LAUNCHES
    got = distance_cuda.min_sum_matrix_rect(a, b)
    assert distance_cuda.RECT_LAUNCHES == launches + 1
    ref = distance.min_sum_matrix(a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (S, S2)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_min_sum_refuses_rows_summing_to_2_31(cuda_device):
    # One row sums to exactly 2^31: its min-sum with itself would not fit
    # int32. Both kernels refuse before launching; one below passes.
    a = torch.zeros(3, 4, dtype=torch.int32, device=cuda_device)
    a[1, 0] = a[1, 1] = 1 << 30
    tri, rect = distance_cuda.TRI_LAUNCHES, distance_cuda.RECT_LAUNCHES
    with pytest.raises(ValueError, match="2\\^31"):
        distance_cuda.min_sum_matrix_tri(a)
    with pytest.raises(ValueError, match="2\\^31"):
        distance_cuda.min_sum_matrix_rect(a[:1], a)
    assert (distance_cuda.TRI_LAUNCHES, distance_cuda.RECT_LAUNCHES) == (tri, rect)
    a[1, 1] -= 1
    got = distance_cuda.min_sum_matrix_tri(a)
    assert int(got[1, 1]) == (1 << 31) - 1


# ---------------------------------------------------------------------------
# K5-K8: dense histograms, added into an accumulator
# ---------------------------------------------------------------------------

DENSE_KS = [1, 2, 3, 4, 6, 7, 8]


def own_cases(n: int) -> list[int]:
    return [0, 1, n // 2 + 3, n, 10**12]


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", DENSE_KS)
def test_hist_planes_kernel_matches_plain(cuda_device, k, canonical):
    # K5 from the planes of an N-rich stream with a homopolymer run, for
    # several n_own, added into one accumulator that starts at 7.
    bases = stream(8192, 100 + k)
    planes = engine.stage_batch_planes(bases, cuda_device)
    acc = torch.full((4**k,), 7, dtype=torch.int32, device=cuda_device)
    ref = acc.clone()
    for n_own in own_cases(8192):
        launches = histogram_cuda.PLANES_LAUNCHES
        out = histogram_cuda.histogram_planes(*planes, n_own, k, canonical, acc)
        assert out is acc and histogram_cuda.PLANES_LAUNCHES == launches + 1
        histogram_cuda.hist_planes_reference(*planes, n_own, k, canonical, ref)
        torch.cuda.synchronize()
        assert torch.equal(acc, ref), n_own


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", DENSE_KS)
def test_hist_u8_kernels_match_plain(cuda_device, k, canonical):
    # K7 at k <= 3 and K6 at every k (4^k bins is a power of two), from an
    # N-rich stream with a homopolymer run.
    b = torch.from_numpy(stream(8192, 200 + k)).to(cuda_device)
    kernels = [("U8_LAUNCHES", histogram_cuda.hist_u8_cuda)]
    if k <= 3:
        kernels.append(("SMALL_LAUNCHES", histogram_cuda.hist_u8_small_cuda))
    for counter, fn in kernels:
        for n_own in own_cases(8192):
            launches = getattr(histogram_cuda, counter)
            got = fn(b, n_own, k, 4**k, canonical)
            assert getattr(histogram_cuda, counter) == launches + 1
            ref = histogram_cuda.hist_u8_reference(b, n_own, k, 4**k, canonical)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and torch.equal(got, ref), (fn.__name__, n_own)


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,bins", [(5, 1000), (6, 3000), (8, 40000), (11, 4**11), (12, 4**12), (3, 5)])
def test_hist_u8_any_kernel_matches_plain(cuda_device, k, bins, canonical):
    # K8 at bins that are not powers of two (one and three shared slices)
    # and above 65,536 (atomics into device memory); codes >= bins dropped.
    b = torch.from_numpy(stream(20000, k + bins % 97)).to(cuda_device)
    launches = histogram_cuda.ANY_LAUNCHES
    got = histogram_cuda.hist_u8_any_cuda(b, 19000, k, bins, canonical)
    assert histogram_cuda.ANY_LAUNCHES == launches + 1
    ref = histogram_cuda.hist_u8_reference(b, 19000, k, bins, canonical)
    torch.cuda.synchronize()
    assert got.shape == (bins,) and torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 16, 300])
def test_hist_kernels_short_streams(cuda_device, n):
    # Streams shorter than, equal to and just past k = 8; every kernel
    # launches (and counts) even when no window is counted.
    bases = stream(max(16, -(-n // 16) * 16), n)
    planes = engine.stage_batch_planes(bases, cuda_device)
    got = histogram_cuda.hist_planes_cuda(*planes, n, 8)
    ref = histogram_cuda.hist_planes_reference(*planes, n, 8)
    assert torch.equal(got, ref)
    b = torch.from_numpy(bases[:n].copy()).to(cuda_device)
    for fn, k, bins in ((histogram_cuda.hist_u8_cuda, 8, 4**8),
                        (histogram_cuda.hist_u8_small_cuda, 3, 64),
                        (histogram_cuda.hist_u8_any_cuda, 10, 4**10)):
        got = fn(b, n, k, bins)
        ref = histogram_cuda.hist_u8_reference(b, n, k, bins)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8])
def test_hist_kernels_homopolymer(cuda_device, k):
    # All 32 lanes of every warp on one bin: all-T, then all-A.
    b = torch.full((1 << 20,), 3, dtype=torch.uint8, device=cuda_device)
    b[1 << 19 :] = 0
    n = (1 << 20) - k + 1
    got = histogram_cuda.histogram_stream(b, n, k, 4**k)
    assert int(got[4**k - 1]) == (1 << 19) - k + 1 and int(got[0]) == (1 << 19) - k + 1
    assert int(got.sum()) == n
    planes = engine.stage_batch_planes(b.cpu().numpy(), cuda_device)
    assert torch.equal(histogram_cuda.hist_planes_cuda(*planes, n, k), got)


@pytest.mark.cuda
def test_dense_count_on_card_equals_cpu(cuda_device):
    # The engine end to end on the card against its CPU route: each route
    # (K5 planes, K7 packed, K6 and K7 from u8, K1 + densify) over several
    # batches.
    import dna_kmeres_parallel_tpu_torch as port

    rng = np.random.default_rng(9)
    seqs = ["".join(rng.choice(list("ACGTN"), size=n, p=[0.24] * 4 + [0.04]))
            for n in (5000, 3, 12000, 700)]
    for k, canonical, pack in ((8, False, True), (6, True, True), (3, False, True),
                               (5, True, False), (2, False, False), (9, False, True)):
        kw = dict(k=k, canonical=canonical, pack_input=pack, batch_bases=4096)
        got = port.count_sequences(seqs, device="cuda", **kw)
        want = port.count_sequences(seqs, device="cpu", **kw)
        assert np.array_equal(got.hist, want.hist), (k, canonical, pack)


# ---------------------------------------------------------------------------
# K9: the u8-stream encoder, and the streaming counter on the card
# ---------------------------------------------------------------------------


def stream_kernel_and_plain(b: torch.Tensor, n_own: int, k: int, canonical: bool):
    launches = encode_cuda.STREAM_LAUNCHES
    got = sparse_ops.encode_words(b, n_own, k, canonical)
    assert encode_cuda.STREAM_LAUNCHES == launches + 1
    ref = sparse_ops.narrow_words(
        *encode_cuda.encode_stream_reference(b, n_own, k, canonical), k
    )
    torch.cuda.synchronize()
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_stream_kernel_matches_plain_on_card(cuda_device, k, canonical):
    # 3% N, an N run and a 64-base all-T run; T not a multiple of the
    # kernel's tile; several n_own.
    b = torch.from_numpy(stream(8192, 300 + k)[:7001]).to(cuda_device)
    for n_own in (0, 1, 7001 // 2, 7001 - k + 1, 10**12):
        got, ref = stream_kernel_and_plain(b, n_own, k, canonical)
        assert len(got) == sparse_ops.key_words(k)
        for g, r in zip(got, ref, strict=True):
            assert g.device.type == "cuda" and g.dtype == r.dtype and g.shape == (7001,)
            assert torch.equal(g, r), n_own


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,k", [(1, 1), (5, 21), (20, 21), (21, 21), (2048, 16), (2049, 31), (4097, 13)]
)
def test_stream_kernel_edges_on_card(cuda_device, n, k):
    # Streams shorter than k, exactly k, and one past a tile; an unaligned
    # view of a longer stream takes the byte loads.
    full = torch.from_numpy(stream(max(16, -(-(n + 3) // 16) * 16), n + k)).to(cuda_device)
    for b in (full[:n], full[3 : n + 3]):
        got, ref = stream_kernel_and_plain(b, n, k, True)
        for g, r in zip(got, ref, strict=True):
            assert torch.equal(g, r)
        assert int((got[-1] != -1).sum()) <= max(0, n - k + 1)


@pytest.mark.cuda
def test_stream_kernel_all_t_16mer(cuda_device):
    # k=16: the all-T window has lo == 0xFFFFFFFF and is valid (hi == 0);
    # canonical folds it onto all-A.
    b = torch.full((100,), 3, dtype=torch.uint8, device=cuda_device)
    hi, lo = sparse_ops.encode_words(b, 100, 16, False)
    assert int((lo[:85] == -1).sum()) == 85 and int((hi[:85] == 0).sum()) == 85
    assert int((hi[85:] == -1).sum()) == 15
    hi, lo = sparse_ops.encode_words(b, 100, 16, True)
    assert int((lo[:85] == 0).sum()) == 85


@pytest.mark.cuda
def test_stream_kernel_refuses_bad_input(cuda_device):
    b = torch.zeros(64, dtype=torch.uint8, device=cuda_device)
    launches = encode_cuda.STREAM_LAUNCHES
    for bad in (b.to(torch.int32), b[::2], b[:0], b.reshape(8, 8)):
        with pytest.raises(ValueError):
            encode_cuda.encode_stream(bad, 64, 21)
    assert encode_cuda.STREAM_LAUNCHES == launches


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,canonical,pack,compact",
    [(21, False, False, "device"), (21, True, True, "device"), (21, False, False, "auto"),
     (11, True, False, "device"), (9, False, True, "auto"), (8, False, True, "auto"),
     (5, True, False, "auto"), (3, False, True, "auto")],
)
def test_streaming_counter_on_card_equals_cpu(cuda_device, tmp_path, k, canonical, pack, compact):
    # The streaming counter end to end on the card against its CPU route,
    # over several batches, with a checkpoint every two batches.
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter

    rng = np.random.default_rng(k)
    path = tmp_path / "s.fasta"
    with open(path, "w") as f:
        for i, n in enumerate((5000, 3, 12000, 700, 9000)):
            s = "".join(rng.choice(list("ACGTN"), size=n, p=[0.24] * 4 + [0.04]))
            f.write(f">r{i}\n{s}\n")
    cfg = KmerConfig(k=k, canonical=canonical, pack_input=pack, compact=compact,
                     batch_bases=2048)
    out = {}
    for dev in ("cuda", "cpu"):
        sc = StreamingCounter(cfg, device=dev, checkpoint_path=str(tmp_path / f"{dev}.npz"),
                              checkpoint_every_bases=4096)
        out[dev] = sc.run(str(path))
        assert sc.metrics.counters["checkpoints"] >= 5
    if hasattr(out["cpu"], "hist"):
        assert np.array_equal(out["cuda"].hist, out["cpu"].hist)
    else:
        assert np.array_equal(out["cuda"].codes, out["cpu"].codes)
        assert np.array_equal(out["cuda"].counts, out["cpu"].counts)


@pytest.mark.cuda
def test_streaming_counter_trace_shows_the_kernel(cuda_device, tmp_path):
    # trace_dir: the torch.profiler trace holds K9's launches on the card.
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter

    path = tmp_path / "t.fasta"
    path.write_text(">r\n" + "ACGTTGCAAC" * 3000 + "\n")
    cfg = KmerConfig(k=21, pack_input=False, compact="device", batch_bases=4096)
    sc = StreamingCounter(cfg, device="cuda", trace_dir=str(tmp_path / "trace"))
    res = sc.run(str(path))
    assert res.total_kmers == 30000 - 20
    assert "encode_stream_kernel" in (tmp_path / "trace" / "trace.json").read_text()


# ---------------------------------------------------------------------------
# The bucketed exchange: K1m (K1's minimizer plane), K10, P1, and the path


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,m", [(13, 7), (17, 7), (17, 11), (17, 15), (21, 7), (21, 11),
                                 (21, 15), (24, 9), (31, 7), (31, 11), (31, 15)])
def test_minimizer_kernel_matches_plain_on_card(cuda_device, k, m, canonical):
    planes = engine.stage_batch_planes(stream(4096, 500 + k), cuda_device)
    for n_own in (0, 1, 2048, 4096 - 200, 10**9):
        launches = (encode_cuda.LAUNCHES, encode_cuda.MIN_LAUNCHES)
        got = encode_cuda.encode_packed(*planes, n_own, k, canonical, minimizer_m=m)
        assert (encode_cuda.LAUNCHES, encode_cuda.MIN_LAUNCHES) == (launches[0], launches[1] + 1)
        ref = encode_cuda.encode_packed_reference(*planes, n_own, k, canonical, minimizer_m=m)
        plain = encode_cuda.encode_packed(*planes, n_own, k, canonical)
        torch.cuda.synchronize()
        assert len(got) == 3
        for g, r in zip(got, ref, strict=True):
            if r is None:
                assert g is None
                continue
            assert g.device.type == "cuda" and g.dtype == r.dtype and torch.equal(g, r), n_own
        for g, p in zip(got[:2], plain, strict=True):
            assert (g is None and p is None) or torch.equal(g, p)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(16, 16, 7), (32, 21, 11), (48, 31, 15), (16, 13, 1)])
def test_minimizer_kernel_edges_on_card(cuda_device, n, k, m):
    planes = engine.stage_batch_planes(stream(n, n + k), cuda_device)
    got = encode_cuda.encode_packed(*planes, n, k, True, minimizer_m=m)
    ref = encode_cuda.encode_packed_reference(*planes, n, k, True, minimizer_m=m)
    torch.cuda.synchronize()
    assert torch.equal(got[2], ref[2]) and torch.equal(got[1], ref[1])


def sorted_rows_on(dev, n_rows, row_w, D, seed):
    """Row-sorted int32 planes [n_rows, row_w] (2) grouped by owner and
    their starts [n_rows, D+1]: row 0 one owner, row 1 all sentinels."""
    g = torch.Generator().manual_seed(seed)
    owner = torch.randint(0, D, (n_rows, row_w), generator=g)
    owner[0] = D - 1
    owner[1] = D
    owner[2:, ::7] = D
    words = torch.randint(-(2**31), 2**31 - 1, (2, n_rows, row_w), generator=g,
                          dtype=torch.int64).to(torch.int32)
    key, order = torch.sort(owner, dim=1)
    planes = tuple(w.gather(1, order).contiguous().to(dev) for w in words)
    starts = torch.stack([(key < d).sum(1) for d in range(D + 1)], 1).to(torch.int32)
    return planes, starts.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n_planes", [1, 2])
@pytest.mark.parametrize("D,row_w,row_cap", [(1, 2048, 2048), (4, 2048, 1024), (4, 2048, 2048),
                                             (5, 2048, 896), (8, 2048, 512), (8, 300, 128)])
def test_owner_segments_kernel_matches_plain_on_card(cuda_device, D, row_w, row_cap, n_planes):
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda

    planes, starts = sorted_rows_on(cuda_device, 333, row_w, D, D * row_cap)
    planes = planes[:n_planes]
    launches = sort_cuda.OWNER_LAUNCHES
    got = sort_cuda.extract_owner_segments(planes, starts, row_cap, D)
    assert sort_cuda.OWNER_LAUNCHES == launches + 1
    ref = sort_cuda.owner_segments_reference(planes, starts, row_cap, D)
    torch.cuda.synchronize()
    assert len(got) == n_planes
    for g, r in zip(got, ref, strict=True):
        assert g.shape == (333, D * row_cap) and torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("R,W", [(8, 256), (333, 1000), (4096, 2048), (1, 1)])
def test_row_roll_kernel_matches_plain_on_card(cuda_device, R, W):
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda

    g = torch.Generator().manual_seed(R + W)
    x = torch.randint(-(2**31), 2**31 - 1, (R, W), generator=g, dtype=torch.int64)
    x = x.to(torch.int32).to(cuda_device)
    s = torch.randint(-3 * W, 3 * W, (R,), generator=g).to(torch.int32).to(cuda_device)
    launches = sort_cuda.ROLL_LAUNCHES
    got = sort_cuda.row_roll(x, s)
    assert sort_cuda.ROLL_LAUNCHES == launches + 1
    torch.cuda.synchronize()
    assert torch.equal(got, sort_cuda.row_roll_reference(x, s))


def bucket_stream(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, n).astype(np.uint8)
    b[rng.random(n) < 0.01] = codec.INVALID_BASE
    b[n // 3 : n // 3 + 50] = codec.INVALID_BASE
    return b


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,canonical,owner_mode,exchange,D",
    [(31, False, "minimizer", "auto", 4), (31, True, "minimizer", "auto", 4),
     (31, False, "prefix", "raw", 4), (21, False, "prefix", "auto", 5),
     (16, True, "prefix", "raw", 8), (23, False, "minimizer", "raw", 3),
     (13, False, "prefix", "raw", 4), (21, True, "minimizer", "agg", 4),
     (31, False, "minimizer", "super", 4)],
)
def test_bucketed_on_card_equals_cpu(cuda_device, k, canonical, owner_mode, exchange, D):
    from dna_kmeres_parallel_tpu_torch import native
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda
    from dna_kmeres_parallel_tpu_torch.parallel import bucketed
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh

    flat = bucket_stream(300_000, k * D)
    want = native.count_sparse_host_native(flat, k, canonical)
    out = {}
    for dev in ("cuda", "cpu"):
        launches = (sort_cuda.OWNER_LAUNCHES, encode_cuda.MIN_LAUNCHES)
        out[dev] = bucketed.count_bucket_auto(flat, k, canonical, LocalMesh(D, dev),
                                              owner_mode=owner_mode, exchange=exchange)
        if dev == "cuda" and exchange in ("auto", "raw"):
            # No fallback: one K10 launch per shard where the row route
            # runs, and one K1m per shard in minimizer mode.
            row = owner_mode == "minimizer" or k <= 15 or bucketed._owner_bits(k, D)[2]
            assert sort_cuda.OWNER_LAUNCHES == launches[0] + (D if row else 0)
            mins = D if owner_mode == "minimizer" else 0
            assert encode_cuda.MIN_LAUNCHES == launches[1] + mins
    for got in out.values():
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.cuda
def test_bucketed_skew_falls_back_on_card(cuda_device):
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda
    from dna_kmeres_parallel_tpu_torch.parallel import bucketed
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh

    flat = np.zeros(40_000, np.uint8)
    mesh = LocalMesh(4, cuda_device)
    with pytest.raises(OverflowError):
        bucketed.count_bucket_sharded_raw(flat, 21, False, mesh)
    launches = (encode_cuda.LAUNCHES, sort_cuda.OWNER_LAUNCHES)
    codes, counts = bucketed.count_bucket_auto(flat, 21, False, mesh)
    # Row route, global route, then the aggregated exchange.
    assert (encode_cuda.LAUNCHES - launches[0], sort_cuda.OWNER_LAUNCHES - launches[1]) == (12, 4)
    assert codes.tolist() == [0] and counts.tolist() == [40_000 - 20]


@pytest.mark.cuda
def test_bucketed_nccl_one_rank_equals_local_mesh(cuda_device, tmp_path):
    import torch.distributed as dist

    from dna_kmeres_parallel_tpu_torch.parallel import bucketed
    from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh, ProcessGroupMesh

    flat = bucket_stream(200_000, 7)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1)
    try:
        got = bucketed.count_bucket_auto(flat, 31, False, ProcessGroupMesh("cuda"),
                                         owner_mode="minimizer")
    finally:
        dist.destroy_process_group()
    want = bucketed.count_bucket_auto(flat, 31, False, LocalMesh(1, "cuda"),
                                      owner_mode="minimizer")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The device-sort route: K11 (the row sort) and the path


def row_sort_input(R: int, m: int, seed: int) -> torch.Tensor:
    """int32 [R, m] of random u32 bits, the bias-order extremes in row 0,
    a sentinel tail in every third row and one row all sentinels."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-(2**31), 2**31, (R, m), generator=g, dtype=torch.int64).to(torch.int32)
    x[0, :4] = torch.tensor([0, -1, 2**31 - 1, -(2**31)], dtype=torch.int32)
    x[::3, m // 2 :] = -1
    x[R // 2] = -1
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("m", [128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768])
@pytest.mark.parametrize("R", [1, 9, 37])
def test_row_sort_kernel_matches_plain_on_card(cuda_device, R, m):
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda

    x = row_sort_input(R, m, R * m).to(cuda_device)
    launches = sort_cuda.ROW_SORT_LAUNCHES
    got = sort_cuda.row_sort_u32(x)
    assert sort_cuda.ROW_SORT_LAUNCHES == launches + 1
    torch.cuda.synchronize()
    want = sort_cuda.row_sort_u32_reference(x)
    assert torch.equal(got, want)
    assert torch.equal(want.cpu(), sort_cuda.row_sort_u32(x.cpu()))
    assert int(got[0, -1]) == -1  # the all-ones sentinel sorts last


@pytest.mark.cuda
def test_row_sort_kernel_refuses_bad_input(cuda_device):
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda

    for shape in ((4, 100), (4, 192), (4, 65536), (0, 128), (128,)):
        with pytest.raises(ValueError):
            sort_cuda.row_sort_u32(torch.zeros(shape, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        sort_cuda.row_sort_u32(torch.zeros((4, 128), dtype=torch.int64, device=cuda_device))
    flat = torch.zeros(4 * 128 + 1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        sort_cuda.row_sort_u32_cuda(flat[1:].view(4, 128))
    with pytest.raises(ValueError, match="CUDA"):
        sort_cuda.row_sort_u32_cuda(torch.zeros((4, 128), dtype=torch.int32))


def sort_fasta(path, seed: int) -> None:
    """Five records of about 27 kbase (4% N) with a duplicated stretch."""
    rng = np.random.default_rng(seed)
    core = "".join(rng.choice(list("ACGT"), size=3000))
    with open(path, "w") as f:
        for i, n in enumerate((5000, 3, 12000, 700, 9000)):
            s = "".join(rng.choice(list("ACGTN"), size=n, p=[0.24] * 4 + [0.04]))
            f.write(f">r{i}\n{s}{core}\n")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,canonical,pack,row_len,pallas_sort",
    [(11, True, True, 2048, True), (13, False, False, 128, True), (15, False, True, 512, True),
     (13, False, True, 2048, False), (16, False, True, 2048, True), (21, False, False, 2048, True),
     (24, True, True, 128, False), (31, False, False, 0, False), (11, False, True, 0, True)],
)
def test_device_sort_on_card_equals_cpu(cuda_device, tmp_path, k, canonical, pack, row_len,
                                        pallas_sort):
    # The device-sort route on the card against its CPU route, through both
    # entries: K11 runs once per batch where its gate holds (single-word
    # keys, a row length it takes), and never otherwise.
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseKmerEngine
    from dna_kmeres_parallel_tpu_torch.ops import sort_cuda

    path = tmp_path / "s.fasta"
    sort_fasta(path, k)
    cfg = KmerConfig(k=k, canonical=canonical, pack_input=pack, device_sort=True,
                     sort_row_len=row_len, batch_bases=8192, compact="device",
                     dense_bins_limit=1)
    gate = pallas_sort and k <= 15 and row_len >= 128
    out = {}
    for dev in ("cuda", "cpu"):
        launches = sort_cuda.ROW_SORT_LAUNCHES
        one = SparseKmerEngine(cfg, device=dev, pallas_sort=pallas_sort).count_file(str(path))
        sc = StreamingCounter(cfg, device=dev, pallas_sort=pallas_sort)
        out[dev] = (one, sc.run(str(path)))
        if dev == "cuda":
            batches = sc.metrics.counters["batches"]
            assert batches >= 5
            assert sort_cuda.ROW_SORT_LAUNCHES - launches == (2 * batches if gate else 0)
    for a, b in zip(*out.values()):
        assert np.array_equal(a.codes, b.codes) and np.array_equal(a.counts, b.counts)
    assert np.array_equal(out["cpu"][0].codes, out["cpu"][1].codes)


@pytest.mark.cuda
@pytest.mark.parametrize("k,pack", [(11, True), (21, False), (31, True)])
def test_device_rle_on_card_equals_cpu(cuda_device, tmp_path, k, pack):
    from dna_kmeres_parallel_tpu_torch import KmerConfig
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter

    path = tmp_path / "s.fasta"
    sort_fasta(path, k)
    cfg = KmerConfig(k=k, pack_input=pack, compact="device-rle", batch_bases=8192,
                     dense_bins_limit=1)
    got = StreamingCounter(cfg, device="cuda").run(str(path))
    want = StreamingCounter(cfg.replace(compact="host"), device="cpu").run(str(path))
    assert np.array_equal(got.codes, want.codes) and np.array_equal(got.counts, want.counts)
