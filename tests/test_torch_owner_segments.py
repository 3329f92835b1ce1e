"""K10 (owner-segment extraction) and P1 (the per-row dynamic roll): the
port's plain versions against the JAX kernel in interpret mode and the
probe's own definition. The CUDA kernels are held against the plain
versions in test_torch_cuda.py.

Integer words: every comparison is exact (tolerance zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dna_kmeres_parallel_tpu.ops import sort_pallas
from dna_kmeres_parallel_tpu_torch.ops import sort_cuda


def sorted_rows(n_rows: int, row_w: int, D: int, n_planes: int, seed: int):
    """Seeded row-sorted u32 planes [n_rows, row_w] by owner (planes[0]
    holds the owner in its top bits, so sorting by it groups owners) and
    starts [n_rows, D+1]: row 0 one owner for the whole row (truncated at
    row_cap), row 1 all sentinels (every segment empty), the rest random
    owners with some owners missing."""
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, D, (n_rows, row_w))
    owner[0] = D - 1
    owner[1] = D  # all invalid
    owner[2:, :: 7] = D
    if D > 2:
        owner[3][owner[3] == 1] = 0  # owner 1 empty in row 3
    words = [
        np.where(owner == D, 0xFFFFFFFF,
                 (owner.astype(np.uint64) << np.uint64(28))
                 | rng.integers(0, 1 << 28, owner.shape).astype(np.uint64)).astype(np.uint32)
    ]
    words += [rng.integers(0, 1 << 32, owner.shape, dtype=np.uint64).astype(np.uint32)
              for _ in range(n_planes - 1)]
    order = np.argsort(words[0], axis=1, kind="stable")
    words = [np.take_along_axis(w, order, axis=1) for w in words]
    owner_s = np.take_along_axis(owner, order, axis=1)
    starts = np.stack([(owner_s < d).sum(axis=1) for d in range(D + 1)], axis=1)
    return words, starts.astype(np.int32)


def port_planes(words):
    return tuple(torch.from_numpy(w.view(np.int32)) for w in words)


@pytest.mark.parametrize("n_planes", [1, 2])
@pytest.mark.parametrize("D,row_w,row_cap", [(1, 256, 128), (1, 256, 256), (5, 256, 128),
                                             (8, 512, 128), (8, 256, 256)])
def test_owner_segments_match_jax_kernel(D, row_w, row_cap, n_planes):
    words, starts = sorted_rows(16, row_w, D, n_planes, D * 100 + row_w)
    lens = np.diff(starts, axis=1)
    assert (lens == 0).any() and (lens[0] == [0] * (D - 1) + [row_w]).all()
    got = sort_cuda.extract_owner_segments(port_planes(words), torch.from_numpy(starts),
                                           row_cap, D)
    want = sort_pallas.extract_owner_segments(
        tuple(jnp.asarray(w) for w in words), jnp.asarray(starts), row_cap, D,
        interpret=True,
    )
    assert len(got) == len(want) == n_planes
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32 and g.shape == (16, D * row_cap)
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))
    # Truncation at row_cap: row 0's whole-row segment fills its slots.
    last = got[0][0, (D - 1) * row_cap :].numpy().view(np.uint32)
    assert (last[: min(row_w, row_cap)] == words[0][0, : min(row_w, row_cap)]).all()


def test_owner_segments_wrap_like_the_roll():
    # A segment that runs past the row end wraps around it, as the TPU
    # kernel's roll does (sorted rows never produce one).
    x = torch.arange(8 * 256, dtype=torch.int32).reshape(8, 256)
    starts = torch.tensor([[200, 256]] + [[0, 0]] * 7, dtype=torch.int32)
    (got,) = sort_cuda.extract_owner_segments((x,), starts, 128, 1)
    want = sort_pallas.extract_owner_segments(
        (jnp.asarray(x.numpy().view(np.uint32)),), jnp.asarray(starts.numpy()), 128, 1,
        interpret=True,
    )
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want[0]))
    assert got[0, :56].tolist() == list(range(200, 256)) and (got[0, 56:] == -1).all()


@pytest.mark.parametrize(
    "bad,match",
    [
        (dict(row_cap=100), "row_cap"),
        (dict(row_cap=0), "row_cap"),
        (dict(D=0), "D must"),
        (dict(planes=3), "1 or 2 planes"),
        (dict(dtype=torch.int64), "int32"),
        (dict(starts_cols=3), "starts_full"),
    ],
)
def test_owner_segments_refuse_bad_arguments(bad, match):
    words, starts = sorted_rows(8, 256, 4, 2, 1)
    planes = port_planes(words)
    if "planes" in bad:
        planes = planes + planes[:1]
    if "dtype" in bad:
        planes = tuple(p.to(bad["dtype"]) for p in planes)
    st = torch.from_numpy(starts)
    if "starts_cols" in bad:
        st = st[:, : bad["starts_cols"]].contiguous()
    with pytest.raises(ValueError, match=match):
        sort_cuda.extract_owner_segments(planes, st, bad.get("row_cap", 128), bad.get("D", 4))


def test_jax_kernel_refuses_a_row_cap_off_the_lane():
    words, starts = sorted_rows(8, 256, 4, 1, 2)
    with pytest.raises(ValueError, match="row_cap"):
        sort_pallas.extract_owner_segments((jnp.asarray(words[0]),), jnp.asarray(starts),
                                           100, 4, interpret=True)


def test_owner_segment_kernel_refuses_cpu_tensors():
    words, starts = sorted_rows(8, 256, 4, 1, 3)
    with pytest.raises(ValueError, match="CUDA"):
        sort_cuda.owner_segments_cuda(port_planes(words), torch.from_numpy(starts), 128, 4)


def test_row_roll_matches_the_probe():
    # scripts/dynroll_probe.py: x = arange(8*256), shift 3r + 1, want
    # np.roll(x[r], -(3r + 1)).
    x = np.arange(8 * 256, dtype=np.int32).reshape(8, 256)
    s = np.arange(8, dtype=np.int32) * 3 + 1
    got = sort_cuda.row_roll(torch.from_numpy(x), torch.from_numpy(s))
    want = np.stack([np.roll(x[r], -(3 * r + 1)) for r in range(8)])
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("R,W", [(8, 256), (37, 129), (1, 1), (64, 2048)])
def test_row_roll_any_shift(R, W):
    rng = np.random.default_rng(R * W)
    x = rng.integers(-(2**31), 2**31, (R, W), dtype=np.int64).astype(np.int32)
    s = rng.integers(-3 * W, 3 * W, R).astype(np.int32)
    s[0] = 0
    got = sort_cuda.row_roll_reference(torch.from_numpy(x), torch.from_numpy(s))
    want = np.stack([np.roll(x[r], -int(s[r])) for r in range(R)])
    assert np.array_equal(got.numpy(), want)


def test_row_roll_refusals():
    x = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="shifts"):
        sort_cuda.row_roll(x, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        sort_cuda.row_roll(x.long(), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        sort_cuda.row_roll_cuda(x, torch.zeros(4, dtype=torch.int32))


def test_row_roll_probe_runs_once_and_raises_on_a_wrong_roll(monkeypatch):
    monkeypatch.setattr(sort_cuda, "_PROBED", set())
    calls = []
    real = sort_cuda.row_roll_reference
    monkeypatch.setattr(sort_cuda, "row_roll_reference",
                        lambda x, s: calls.append(1) or real(x, s))
    sort_cuda.probe_row_roll(torch.device("cpu"))
    sort_cuda.probe_row_roll(torch.device("cpu"))
    assert calls == [1] and "cpu" in sort_cuda._PROBED
    monkeypatch.setattr(sort_cuda, "_PROBED", set())
    monkeypatch.setattr(sort_cuda, "row_roll_reference", lambda x, s: x)
    with pytest.raises(RuntimeError, match="probe failed"):
        sort_cuda.probe_row_roll(torch.device("cpu"))
