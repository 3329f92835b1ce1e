"""Bucket-sharded sparse counting: each shard owns a share of the codes.

The port of ``dna_kmeres_parallel_tpu/parallel/bucketed.py``, the JAX
package's scale-out count (BASELINE config 5: k=31 over a bucket-sharded
4^31 keyspace, minimizer owners, an all-to-all exchange). The stream is
cut into D shards with (k-1)-base halos; each shard encodes its windows,
routes every window to the shard that owns its code, and sends it there
over a fixed-capacity all_to_all; each owner then counts what it received,
and the host merges the owners' sorted tables.

Owners: 'prefix' takes a multiply-shift range partition of the code's top
bits (``_owner_bits``); 'minimizer' a Fibonacci hash of the window's
minimizer m-mer (``_hash_owner``), from K1's minimizer plane when planes
are staged, else from a positional scan of the bases. Both are copied
exactly from the JAX package, with the send capacities (``_capacity``,
``row_capacity``, ``_superkmer_capacity``): they decide which shard holds
each k-mer and when a run overflows and degrades.

Exchanges:

- raw (``exchange_words_bucket_sharded``, ``count_bucket_sharded_raw``):
  every window's split words cross the exchange unsorted, and each owner's
  words are radix-compacted on the host. Its default route partitions each
  shard's windows into rows of ``row_len``, sorts every row by its routing
  key (``torch.sort``), finds each row's owner segments by searching the
  owners' edges, and copies them into fixed [D, row_cap] send slots with
  K10 (``ops/sort_cuda.extract_owner_segments``). Row r holds windows r,
  r + n_rows, r + 2 n_rows, ... of the shard, so a run of windows with one
  owner (a homopolymer, a repeat) spreads over every row, as the TPU
  kernel's residue-permuted window order spreads it. A row-route overflow
  retries the shard-wide sort (the global route) once, then raises.
- aggregated (``count_bucket_sharded``): each shard collapses equal
  (owner, code) pairs first, so only distinct codes and their counts
  travel; skew-proof on duplicated data.
- super-k-mer (``exchange_superkmers_bucket_sharded``,
  ``count_bucket_sharded_super``): runs of windows sharing a minimizer
  position travel as one record of packed bases; the host expands and
  counts them.

``count_bucket_auto`` runs the raw exchange and falls back to the
aggregated one on overflow. Where the JAX entries take ``pallas``, the
port takes the device of the mesh: the kernels on the card, their plain
versions on the CPU. The JAX package reads its row-route switch and row
length from the environment; here they are the arguments
``row_partition`` (default on) and ``row_len`` (default 2048, at least
64 D). Planes are int32/int16 tensors holding the unsigned words, with
all-ones (-1) sentinels; orders of u32 words compare biased keys
(``x ^ 0x80000000``), since torch compares int32 as signed.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models.engine import host_to_device
from dna_kmeres_parallel_tpu_torch.models.sparse_engine import (
    compact_unsorted,
    fetch_words,
    merge_sparse_tables,
)
from dna_kmeres_parallel_tpu_torch.ops import encode as encode_ops
from dna_kmeres_parallel_tpu_torch.ops import runtime, sort_cuda
from dna_kmeres_parallel_tpu_torch.ops import sparse as sparse_ops
from dna_kmeres_parallel_tpu_torch.parallel.sharded_sparse import stage_shard_planes

#: the all-ones word as an int32 or int16 plane holds it
SENTINEL = -1
#: int32 0x80000000: ``x ^ _BIAS`` orders u32 bits as signed int32
_BIAS = -(1 << 31)
_INT32_MAX = 2**31 - 1
_INT64_MAX = 2**63 - 1
#: the row route's row length before the 64-per-owner floor (the JAX
#: package's KMER_TPU_ROW_PARTITION_LEN default)
ROW_LEN = 2048
#: seconds an entry adds to its ``phases`` dict, in the order they run
PHASES = ("staging", "device", "d2h", "compact", "merge")

_EXCHANGES = ("auto", "raw", "agg", "super")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _owner_bits(k: int, n_dev: int) -> tuple[int, int, bool]:
    """(shift, t_bits, use_hi): owner = ((word >> shift) * D) >> t_bits — a
    balanced multiply-shift range partition over t_bits = d_bits + 4 top
    bits of hi (use_hi) or, where hi has fewer bits than d_bits, of lo."""
    d_bits = max(n_dev - 1, 1).bit_length() if n_dev > 1 else 0
    nlo = sparse_ops._lo_bases(k)
    hi_bits = 2 * (k - nlo)
    if hi_bits >= d_bits:
        t = min(hi_bits, d_bits + 4)
        return hi_bits - t, t, True
    lo_bits = 2 * nlo
    t = min(lo_bits, d_bits + 4)
    return lo_bits - t, t, False


def _prefix_edges(D: int, shift: int, t_bits: int) -> list[int]:
    """Owner d's first routing-word value: owner d owns top values in
    [ceil(d 2^t / D), ceil((d+1) 2^t / D)) (the partition's inverse)."""
    return [((d << t_bits) + D - 1) // D << shift for d in range(D)]


def _unsigned(x: torch.Tensor) -> torch.Tensor:
    """int16/int32 bits -> the unsigned words they hold, in int64."""
    return x.to(torch.int64) & (0xFFFF if x.dtype == torch.int16 else 0xFFFFFFFF)


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def window_minimizers(bases: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """Minimizer m-mer code of every k-window: [T] uint8 -> [T-k+1] int32
    (INT32_MAX where a window touches invalid bases)."""
    return window_minimizers_pos(bases, k, m)[0]


def window_minimizers_pos(
    bases: torch.Tensor, k: int, m: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(minimizer code, minimizer POSITION, window validity) per k-window.

    The position is the absolute base index of the leftmost minimal m-mer
    (ties break leftmost, so a sliding window's position never decreases
    and windows sharing one form runs of at most k-m+1: the super-k-mers).
    Validity is the AND of the k-m+1 m-mer validities, not derivable from
    the minimizer value (invalid m-mers carry INT32_MAX, which the min
    hides). Plain torch, as the JAX package computes it in XLA."""
    mcodes, mvalid = encode_ops.rolling_codes(bases, m)
    mcodes = torch.where(mvalid, mcodes, _INT32_MAX)
    n = bases.shape[0] - k + 1
    dev = bases.device
    mini = torch.full((n,), _INT32_MAX, dtype=torch.int32, device=dev)
    pos = torch.zeros(n, dtype=torch.int32, device=dev)
    vwin = torch.ones(n, dtype=torch.bool, device=dev)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    for j in range(k - m + 1):
        cand = mcodes[j : j + n]
        take = cand < mini  # strict: the leftmost occurrence wins ties
        mini = torch.where(take, cand, mini)
        pos = torch.where(take, idx + j, pos)
        vwin &= mvalid[j : j + n]
    return mini, pos, vwin


def _capacity(n_windows: int, D: int, canonical: bool) -> int:
    """Fixed all_to_all send capacity per owner. Canonical folding
    concentrates the code space in its lower half (~2x skew: double the
    slack); +64 fixed slack covers binomial tails on small shards."""
    cap_mult = 4 if canonical else 2
    return min(-(-cap_mult * n_windows // D) + 64, n_windows)


def row_capacity(row_len: int, D: int, canonical: bool) -> int:
    """The row route's send slots per (row, owner): the same 2x/4x margin
    as ``_capacity``, rounded up to a 128 multiple (which decides when a
    row overflows, so it is kept from the TPU layout), at most a row."""
    cap_mult = 4 if canonical else 2
    return min(_round_up(-(-cap_mult * row_len // D), 128), row_len)


def _hash_owner(mini: torch.Tensor, D: int) -> torch.Tensor:
    """Fibonacci hash of a minimizer value, range-partitioned by
    multiply-shift: the u32 products of the JAX function, in int64."""
    h32 = ((mini.to(torch.int64) & 0xFFFFFFFF) * 0x9E3779B1) & 0xFFFFFFFF
    return (((h32 >> 16) * D) >> 16).to(torch.int32)


def _route_owner(b, hi, lo, valid, k, D, owner_mode, minimizer_m,
                 shift, t_bits, use_hi, mins=None):
    """Owner id per window (D for invalid), shared by every exchange so
    they route identically. mins: K1's minimizer plane (minimizer mode
    with staged planes); without it minimizers come from a positional
    scan of the base stream b."""
    if owner_mode == "minimizer":
        if mins is None:
            mins = window_minimizers(b, k, minimizer_m)
        owner = _hash_owner(mins, D)
        if owner.shape[0] < valid.shape[0]:
            # K9's plane has T slots, the scan T-k+1: the tail is invalid.
            tail = torch.full((valid.shape[0] - owner.shape[0],), D,
                              dtype=torch.int32, device=owner.device)
            owner = torch.cat([owner, tail])
    else:
        # hi is None in the single-word band, where use_hi arises only at
        # D=1 and every owner must be 0. A caller that reads the owners
        # passes hi widened to zeros there (_agg_shard); with hi None the
        # owner falls back to lo, which is right only where the owners are
        # not read (the raw exchange's prefix routes cut by the word).
        owner_src = hi if (use_hi and hi is not None) else lo
        owner = (((_unsigned(owner_src) >> shift) * D) >> t_bits).to(torch.int32)
    return torch.where(valid, owner, D)


def _encode_shard_words(b, n_own, k, canonical):
    """One u8 shard -> (hi, lo, valid): K9 on the card, its plain version
    on the CPU (``sparse.encode_words``); hi None for k <= 15."""
    words = sparse_ops.encode_words(b, n_own, k, canonical)
    if len(words) == 1:
        return None, words[0], words[0] != SENTINEL
    hi, lo = words
    return hi, lo, hi != SENTINEL


def _encode_shard_planes(w, iv, n_own, k, canonical, owner_mode, minimizer_m):
    """One shard's staged planes -> (hi, lo, valid, mins): K1, or K1m with
    its minimizer plane in minimizer mode (``sparse.encode_words_planes``)."""
    mm = minimizer_m if owner_mode == "minimizer" else None
    out = sparse_ops.encode_words_planes(w, iv, n_own, k, canonical, minimizer_m=mm)
    words, mins = out if mm is not None else (out, None)
    if len(words) == 1:
        return None, words[0], words[0] != SENTINEL, mins
    hi, lo = words
    return hi, lo, hi != SENTINEL, mins


def _encode_shard(inp, n_own, k, canonical, owner_mode, minimizer_m):
    """(b, hi, lo, valid, mins) of one shard: staged planes (2 tensors) or
    a u8 shard (1 tensor, b kept for the positional minimizer scan)."""
    if len(inp) == 2:
        return (None, *_encode_shard_planes(*inp, n_own, k, canonical, owner_mode,
                                            minimizer_m))
    b = inp[0]
    return (b, *_encode_shard_words(b, n_own, k, canonical), None)


def _shard_input(inputs, s: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Shard s of each [D, ...] host input array, on the device."""
    return tuple(host_to_device(np.ascontiguousarray(a[s]), device) for a in inputs)


def _shift1(x: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device), x[:-1]])


def _rcummin(x: torch.Tensor) -> torch.Tensor:
    """Reverse cumulative min."""
    return torch.cummin(x.flip(0), 0).values.flip(0)


def _rle(keys, valid: torch.Tensor, cnt: torch.Tensor):
    """Sorted keys (a list of int64 tensors, lexicographic) with per-element
    counts -> (run starts, totals): totals[i] sums cnt over the run that
    starts at i (garbage off the starts). Valid entries precede invalid
    ones."""
    m = valid.shape[0]
    change = torch.zeros(m, dtype=torch.bool, device=valid.device)
    for key in keys:
        change |= key != _shift1(key, -1)
    run_starts = change & valid
    idx = torch.arange(m, device=valid.device)
    nxt = _rcummin(torch.where(run_starts | ~valid, idx, m))
    after = torch.cat([nxt[1:], torch.full((1,), m, device=valid.device)])
    csum = torch.cumsum(cnt, 0)
    totals = csum[(after - 1).clamp(0, max(m - 1, 0))] - (csum - cnt)
    return run_starts, totals


def _segments(sorted_vals, starts, seg_len, cap: int, fill):
    """[D, cap] send slots: each owner's first min(seg_len, cap) values from
    its segment of the sorted planes, ``fill`` elsewhere."""
    col = torch.arange(cap, device=starts.device)
    in_seg = col < seg_len.clamp(max=cap)[:, None]
    idx = starts[:, None].long() + col
    out = []
    for v, f in zip(sorted_vals, fill, strict=True):
        padded = torch.cat([v, torch.full((cap,), f, dtype=v.dtype, device=v.device)])
        out.append(torch.where(in_seg, padded[idx], f))
    return tuple(out)


# ---------------------------------------------------------------------------
# The raw exchange
# ---------------------------------------------------------------------------


def _row_partition(payl32, owner, D, prefix_fast, shift, t_bits, row_len, canonical):
    """The row route: per-row sort, starts by searching the owners' edges,
    K10 into [n_rows, D*row_cap] slots, regrouped to [D, n_rows*row_cap]."""
    row_cap = row_capacity(row_len, D, canonical)
    n = payl32[0].shape[0]
    n_rows = -(-n // row_len)
    dev = payl32[0].device
    sort_cuda.probe_row_roll(dev)

    def rows(p, fill):
        # Row r holds windows r, r + n_rows, ...: runs spread over the rows.
        full = torch.full((n_rows * row_len,), fill, dtype=p.dtype, device=dev)
        full[:n] = p
        return full.reshape(row_len, n_rows).t().contiguous()

    if prefix_fast:
        # The owner is monotone in the routing word (payloads[0]): sort rows
        # by it alone, segments from the owners' code edges; column D is
        # the first sentinel.
        key, order = torch.sort(rows(payl32[0], SENTINEL) ^ _BIAS, dim=1)
        sorted_rows = (key ^ _BIAS,) + tuple(
            rows(p, SENTINEL).gather(1, order) for p in payl32[1:]
        )
        thresholds = [e + _BIAS for e in _prefix_edges(D, shift, t_bits)] + [_INT32_MAX]
    else:
        # Minimizer owners are not monotone in any word: sort rows by the
        # owner itself (invalid windows are owner D, past every segment).
        key, order = torch.sort(rows(owner, D), dim=1)
        sorted_rows = tuple(rows(p, SENTINEL).gather(1, order) for p in payl32)
        thresholds = list(range(D + 1))
    del order
    th = torch.tensor(thresholds, dtype=torch.int32, device=dev)
    starts_full = torch.searchsorted(
        key, th.expand(n_rows, D + 1).contiguous(), out_int32=True
    )
    overflow = (starts_full[:, 1:] - starts_full[:, :-1] > row_cap).any()
    send = sort_cuda.extract_owner_segments(sorted_rows, starts_full, row_cap, D)
    return tuple(
        sp.reshape(n_rows, D, row_cap).transpose(0, 1).reshape(D, n_rows * row_cap)
        for sp in send
    ), overflow


def _global_sort(payl32, owner, D, prefix_fast, shift, t_bits, cap):
    """The global route: one sort of the shard by its routing key, owner
    segments by search, the first ``cap`` of each into [D, cap] slots."""
    dev = payl32[0].device
    if prefix_fast:
        key, order = torch.sort(payl32[0] ^ _BIAS)
        payl_s = (key ^ _BIAS,) + tuple(p[order] for p in payl32[1:])
        edges = torch.tensor([e + _BIAS for e in _prefix_edges(D, shift, t_bits)],
                             dtype=torch.int32, device=dev)
        end_edges = torch.cat([edges[1:], torch.full((1,), _INT32_MAX, dtype=torch.int32,
                                                     device=dev)])
        starts = torch.searchsorted(key, edges)
        ends = torch.searchsorted(key, end_edges)
    else:
        key, order = torch.sort(owner)
        payl_s = tuple(p[order] for p in payl32)
        targets = torch.arange(D, dtype=torch.int32, device=dev)
        starts = torch.searchsorted(key, targets)
        ends = torch.searchsorted(key, targets, right=True)
    del order
    seg_len = ends - starts
    send = _segments(payl_s, starts, seg_len, cap, (SENTINEL,) * len(payl_s))
    return send, (seg_len > cap).any()


def _raw_shard(inp, n_own, *, k, canonical, D, owner_mode, minimizer_m,
               row_partition, row_len, cap):
    """One shard's raw-exchange program: encode, route, sort, send slots.
    Returns (send planes, each [D, cap_s] in the words' native width;
    overflow flag)."""
    shift, t_bits, use_hi = _owner_bits(k, D)
    single = k <= sparse_ops.MAX_SINGLE_WORD_K
    b, hi, lo, valid, mins = _encode_shard(inp, n_own, k, canonical, owner_mode,
                                           minimizer_m)
    owner = _route_owner(b, hi, lo, valid, k, D, owner_mode, minimizer_m,
                         shift, t_bits, use_hi, mins=mins)
    del b, mins, valid
    payloads = (lo,) if single else (hi, lo)
    # int16 -> int32 sign-extends the u16 sentinel 0xFFFF to 0xFFFFFFFF,
    # which sorts past every segment; valid hi (< 2^14) keep their value.
    payl32 = tuple(p.to(torch.int32) for p in payloads)
    # Prefix mode with the owner from the routing word's top bits: the
    # owner is monotone in that word, so the word itself is the sort key.
    # Minimizer mode and the mid band where owners come from lo sort by
    # the owner.
    prefix_fast = owner_mode != "minimizer" and (use_hi or single)
    if row_partition and (prefix_fast or owner_mode == "minimizer"):
        send, overflow = _row_partition(payl32, owner, D, prefix_fast, shift, t_bits,
                                        row_len, canonical)
    else:
        send, overflow = _global_sort(payl32, owner, D, prefix_fast, shift, t_bits, cap)
    # Narrow back: the low 16 bits of a widened hi, the sentinel included.
    return tuple(sp.to(p.dtype) for sp, p in zip(send, payloads)), overflow


def raw_shard_fn(n_windows: int, k: int, canonical: bool, D: int, owner_mode: str = "prefix",
                 minimizer_m: int = 7, row_partition: bool = True, row_len: int = ROW_LEN):
    """The raw exchange's program for one shard of a D-shard mesh whose
    shards hold ``n_windows`` window slots each: ``fn(inputs, n_own) ->
    (send planes, overflow flag)``, inputs being the shard's staged planes
    (2 tensors) or u8 bases (1 tensor) on the device. It adds no
    synchronize, so CUDA events around it time the device alone."""
    return functools.partial(
        _raw_shard, k=k, canonical=canonical, D=D, owner_mode=owner_mode,
        minimizer_m=minimizer_m, row_partition=row_partition,
        row_len=max(row_len, 64 * D), cap=_capacity(n_windows, D, canonical),
    )


def _n_windows(inputs, k: int, staged: bool) -> int:
    return inputs[0].shape[1] * (16 if staged else 1) - k + 1


def exchange_words_bucket_sharded(
    bases,
    n_own_per_shard,
    k: int,
    canonical: bool,
    mesh,
    owner_mode: str = "prefix",
    minimizer_m: int = 7,
    staged_planes: bool = False,
    row_partition: bool = True,
    row_len: int = ROW_LEN,
):
    """The raw exchange over ``mesh``.

    bases: [D, T + k - 1] uint8 shards (``shard_stream_with_halo``), or,
    with staged_planes, the (words_le, inval_be) [D, Tw] u32 planes of
    ``stage_shard_planes``. n_own_per_shard: [D] windows each shard owns.
    The row route runs when ``row_partition`` is set and the owner is a
    sort key (prefix mode with owners from the routing word, or minimizer
    mode); rows hold max(row_len, 64 D) windows.

    Returns (words, overflow): words is the adaptive tuple ((lo,) for
    k <= 15, else (hi, lo)) of received planes, each [local shards,
    D * cap_s] with all-ones sentinels in unused slots (row i: the words
    owned by local shard i); overflow is True when a send bucket of any
    shard overflowed (the words are then incomplete)."""
    inputs = tuple(bases) if staged_planes else (bases,)
    shard_fn = raw_shard_fn(_n_windows(inputs, k, staged_planes), k, canonical, mesh.size,
                            owner_mode, minimizer_m, row_partition, row_len)

    def run(s):
        return shard_fn(_shard_input(inputs, s, mesh.device), int(n_own_per_shard[s]))

    words, flags = mesh.exchange(run)
    return words, mesh.max_reduce(flags)


def _stage_exchange_inputs(shards: np.ndarray, staged_planes: bool):
    """The exchanges' inputs: host-built u32 planes for K1 (the JAX
    package's route when its v2 encoder is active, its default), else the
    u8 shards themselves (K9, positional minimizers)."""
    return stage_shard_planes(shards) if staged_planes else shards


def _lap(phases, name: str, t: float) -> float:
    now = time.perf_counter()
    if phases is not None:
        phases[name] = phases.get(name, 0.0) + now - t
    return now


def count_bucket_sharded_raw(
    flat: np.ndarray,
    k: int,
    canonical: bool,
    mesh,
    owner_mode: str = "prefix",
    minimizer_m: int = 7,
    total_own=None,
    staged_planes: bool = True,
    row_partition: bool = True,
    row_len: int = ROW_LEN,
    phases: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host entry of the raw exchange: shard with halos, stage, exchange
    unsorted words, radix-compact each owner's words on the host, merge.
    A row-route overflow retries the global route once; an overflow there
    raises ``OverflowError``. Adds its seconds to ``phases`` (PHASES):
    ``device`` is the device timeline from the first shard's copy to the
    end of the exchange, ``d2h`` the rest of the host wall until the
    words are on the host."""
    t = time.perf_counter()
    shards, n_own = shard_stream_with_halo(flat, k, mesh, total_own)
    inputs = _stage_exchange_inputs(shards, staged_planes)
    del shards
    t = _lap(phases, "staging", t)
    kw = dict(owner_mode=owner_mode, minimizer_m=minimizer_m, staged_planes=staged_planes,
              row_len=row_len)
    m0 = runtime.mark(mesh.device)
    words, overflow = exchange_words_bucket_sharded(
        inputs, n_own, k, canonical, mesh, row_partition=row_partition, **kw)
    if overflow and row_partition:
        # The row route's capacity is per (row, owner), tighter than the
        # global route's per-shard capacity: degrade once before raising.
        del words
        words, overflow = exchange_words_bucket_sharded(
            inputs, n_own, k, canonical, mesh, row_partition=False, **kw)
    m1 = runtime.mark(mesh.device)
    if overflow:
        raise OverflowError(
            "bucketed raw exchange: an owner's window share exceeded the "
            "send capacity (skewed data) — use the aggregated exchange "
            "(count_bucket_sharded) or owner_mode='minimizer'"
        )
    host = fetch_words(words)  # waits for the device
    del words
    if phases is not None:
        device = runtime.span_s(m0, m1)
        phases["device"] = phases.get("device", 0.0) + device
        phases["d2h"] = phases.get("d2h", 0.0) - device
    t = _lap(phases, "d2h", t)
    tables = [compact_unsorted(tuple(w[i] for w in host), k)
              for i in range(host[0].shape[0])]
    del host
    t = _lap(phases, "compact", t)
    out = merge_sparse_tables(mesh.gather(tables))
    _lap(phases, "merge", t)
    return out


# ---------------------------------------------------------------------------
# The aggregated exchange
# ---------------------------------------------------------------------------


def _agg_shard(inp, n_own, *, k, canonical, D, owner_mode, minimizer_m, cap):
    """One shard's aggregated-exchange program: encode, route, collapse
    equal (owner, code) pairs, send each owner's first ``cap`` distinct
    (hi, lo, count) entries. Returns ((hi, lo, cnt) [D, cap] int32;
    overflow flag)."""
    shift, t_bits, use_hi = _owner_bits(k, D)
    b, hi_n, lo, valid, mins = _encode_shard(inp, n_own, k, canonical, owner_mode,
                                             minimizer_m)
    # Route by hi widened to zeros in the single-word band, as the JAX
    # path does: at D=1 the prefix owner of every window is then 0.
    hi = torch.zeros_like(lo) if hi_n is None else hi_n
    owner = _route_owner(b, hi, lo, valid, k, D, owner_mode, minimizer_m,
                         shift, t_bits, use_hi, mins=mins)
    code = torch.where(valid, (_unsigned(hi) << 32) | _unsigned(lo), _INT64_MAX)
    del b, hi_n, hi, lo, mins
    # Group by (owner, code): sort by code, then stably by owner. Invalid
    # windows (owner D) sort last.
    code_s, order = torch.sort(code)
    owner_s, order2 = torch.sort(owner[order], stable=True)
    code_s = code_s[order2]
    del order, order2, code, owner
    valid_s = code_s != _INT64_MAX
    ones = torch.ones_like(code_s)
    starts_mask, totals = _rle([owner_s.long(), code_s], valid_s, ones)
    pos = torch.nonzero(starts_mask).squeeze(1)
    d_owner = owner_s[pos].long()
    seg_len = torch.bincount(d_owner, minlength=D)[:D]
    first = torch.cumsum(seg_len, 0) - seg_len
    d_code = code_s[pos]
    send = _segments(
        (_i32(d_code >> 32), _i32(d_code & 0xFFFFFFFF), totals[pos].to(torch.int32)),
        first, seg_len, cap, (SENTINEL, SENTINEL, 0),
    )
    return send, (seg_len > cap).any()


def _merge_received(hi, lo, cnt):
    """Per received row: sort the <= D pre-aggregated tables by (hi, lo) and
    sum their counts -> (hi2, lo2, counts, run starts), each the row's
    shape; counts hold the run totals at the starts."""
    out = [[], [], [], []]
    for h, l, c in zip(hi, lo, cnt):
        valid = h != SENTINEL
        code = torch.where(valid, (_unsigned(h) << 32) | _unsigned(l), _INT64_MAX)
        code_s, order = torch.sort(code)
        cnt_s = c[order].long()
        valid_s = code_s != _INT64_MAX
        run_starts, counts = _rle([code_s], valid_s, cnt_s)
        hi2 = torch.where(valid_s, _i32(code_s >> 32), SENTINEL)
        lo2 = torch.where(valid_s, _i32(code_s & 0xFFFFFFFF), SENTINEL)
        for acc, v in zip(out, (hi2, lo2, torch.where(run_starts, counts, 0), run_starts)):
            acc.append(v)
    return tuple(torch.stack(v) for v in out)


def count_bucket_sharded(
    bases,
    n_own_per_shard,
    k: int,
    canonical: bool,
    mesh,
    owner_mode: str = "prefix",
    minimizer_m: int = 7,
    staged_planes: bool = False,
):
    """The aggregated exchange over ``mesh`` (inputs as in
    ``exchange_words_bucket_sharded``). Capacity is in DISTINCT codes per
    owner, so skewed data (few codes, many copies) cannot overflow on
    multiplicity.

    Returns (hi, lo, counts, starts, overflow): hi/lo/counts/starts [local
    shards, D * cap] masked run-length tables (row i: the codes local
    shard i owns, sorted; ``gather_table`` reads them); overflow True when
    any send bucket overflowed."""
    inputs = tuple(bases) if staged_planes else (bases,)
    D = mesh.size
    shard_fn = functools.partial(
        _agg_shard, k=k, canonical=canonical, D=D, owner_mode=owner_mode,
        minimizer_m=minimizer_m,
        cap=_capacity(_n_windows(inputs, k, staged_planes), D, canonical),
    )

    def run(s):
        return shard_fn(_shard_input(inputs, s, mesh.device), int(n_own_per_shard[s]))

    (hi, lo, cnt), flags = mesh.exchange(run)
    overflow = mesh.max_reduce(flags)
    return (*_merge_received(hi, lo, cnt), overflow)


def gather_table(hi, lo, counts, starts) -> tuple[np.ndarray, np.ndarray]:
    """Host compaction of the masked run-length outputs of
    ``count_bucket_sharded`` into one sorted (codes_u64, counts_i64) table
    (owners partition the code space, so a merge of the rows is exact)."""
    hi = np.asarray(torch.as_tensor(hi).cpu()).view(np.uint32)
    lo = np.asarray(torch.as_tensor(lo).cpu()).view(np.uint32)
    counts = np.asarray(torch.as_tensor(counts).cpu())
    starts = np.asarray(torch.as_tensor(starts).cpu())
    tables = []
    for d in range(hi.shape[0]):
        idx = np.flatnonzero(starts[d])
        code = (hi[d][idx].astype(np.uint64) << np.uint64(32)) | lo[d][idx].astype(np.uint64)
        tables.append((code, counts[d][idx].astype(np.int64)))
    return merge_sparse_tables(tables)


def count_bucket_auto(
    flat: np.ndarray,
    k: int,
    canonical: bool,
    mesh,
    owner_mode: str = "prefix",
    minimizer_m: int = 7,
    total_own=None,
    exchange: str = "auto",
    staged_planes: bool = True,
    row_partition: bool = True,
    row_len: int = ROW_LEN,
    phases: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Policy entry of the bucket-sharded count: route through the
    cheapest exchange that fits.

    exchange='auto' runs the raw exchange and falls back to the aggregated
    one if a raw send bucket overflows (after the raw entry's own retry
    on the global route); 'raw', 'agg' and 'super' force one exchange.
    Returns the sorted (codes_u64, counts_i64) table. ``phases`` collects
    the raw entry's seconds."""
    if exchange not in _EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r}")
    if exchange == "super":
        return count_bucket_sharded_super(flat, k, canonical, mesh, minimizer_m, total_own)
    if exchange in ("auto", "raw"):
        try:
            return count_bucket_sharded_raw(
                flat, k, canonical, mesh, owner_mode, minimizer_m, total_own,
                staged_planes=staged_planes, row_partition=row_partition,
                row_len=row_len, phases=phases,
            )
        except OverflowError:
            if exchange == "raw":
                raise
    # Aggregated fallback (or exchange='agg'): pre-aggregation bounds an
    # owner's share by its DISTINCT codes.
    shards, n_own = shard_stream_with_halo(flat, k, mesh, total_own)
    hi, lo, counts, starts, overflow = count_bucket_sharded(
        _stage_exchange_inputs(shards, staged_planes), n_own, k, canonical, mesh,
        owner_mode, minimizer_m, staged_planes=staged_planes,
    )
    if overflow:
        raise OverflowError(
            "bucketed aggregated exchange: an owner's distinct-code share "
            "exceeded the send capacity — split the stream into smaller "
            "batches (capacity scales with windows per shard)"
        )
    return merge_sparse_tables(mesh.gather([gather_table(hi, lo, counts, starts)]))


# ---------------------------------------------------------------------------
# The super-k-mer exchange
# ---------------------------------------------------------------------------


def superkmer_geometry(k: int, m: int) -> tuple[int, int]:
    """(max record bases, u32 words per record): a run holds at most
    k-m+1 windows, i.e. 2k-m bases, packed 16 per word (2 bits each,
    little-endian within the word)."""
    if not 1 <= m < k:
        raise ValueError(f"minimizer m must satisfy 1 <= m < k, got m={m} k={k}")
    skmax = 2 * k - m
    return skmax, -(-skmax // 16)


def _superkmer_capacity(n_windows: int, D: int, k: int, m: int) -> int:
    """Records-per-owner send capacity: expected records = 2/(k-m+2) per
    window (the super-k-mer density of random sequence), x2 slack for
    routing variance, +64 for binomial tails on small shards."""
    exp_per_owner = -(-2 * n_windows // ((k - m + 2) * D))
    return min(2 * exp_per_owner + 64, max(n_windows, 1))


def _superkmer_records(b: torch.Tensor, n_own: int, k: int, m: int):
    """(mini, run_start, run_len, planes) per window of a u8 stream: runs
    break where the minimizer position moves or validity flips; each
    window's record is its 2k-m bases from the window start, packed into
    W int32 words (bases past a run's true extent are masked by its
    length on the host)."""
    n = b.shape[0] - k + 1
    skmax, W = superkmer_geometry(k, m)
    mini, pos, vwin = window_minimizers_pos(b, k, m)
    idx = torch.arange(n, dtype=torch.int32, device=b.device)
    valid = vwin & (idx < n_own)
    brk = (pos != _shift1(pos, -1)) | (valid != _shift1(valid, False))
    run_start = brk & valid
    nxt = _rcummin(torch.where(brk, idx, n))
    after = torch.cat([nxt[1:], torch.full((1,), n, dtype=torch.int32, device=b.device)])
    run_len = after - idx
    bp = torch.cat([b, torch.full((k - m,), encode_ops.INVALID, dtype=torch.uint8,
                                  device=b.device)])
    b2 = (bp & 3).to(torch.int64)
    planes = []
    for w in range(W):
        acc = torch.zeros(n, dtype=torch.int64, device=b.device)
        for t in range(min(16, skmax - 16 * w)):
            j = 16 * w + t
            acc |= b2[j : j + n] << (2 * t)
        planes.append(_i32(acc))
    return mini, run_start, run_len, planes


def _super_shard(inp, n_own, *, k, D, minimizer_m, cap):
    """One shard's super-k-mer program: records at run starts, sorted by
    owner (a stable sort), each owner's first ``cap`` into [D, cap] slots.
    Returns ((*planes, meta); overflow flag); meta is the run length in
    windows, 0 in unused slots."""
    mini, run_start, run_len, planes = _superkmer_records(inp[0], n_own, k, minimizer_m)
    owner = _hash_owner(mini, D)
    meta = torch.where(run_start, run_len, 0)
    owner_rec = torch.where(run_start, owner, D)
    owner_s, order = torch.sort(owner_rec, stable=True)
    targets = torch.arange(D, dtype=torch.int32, device=owner_s.device)
    starts = torch.searchsorted(owner_s, targets)
    seg_len = torch.searchsorted(owner_s, targets, right=True) - starts
    send = _segments([p[order] for p in planes] + [meta[order]], starts, seg_len, cap,
                     [0] * (len(planes) + 1))
    return send, (seg_len > cap).any()


def exchange_superkmers_bucket_sharded(
    bases, n_own_per_shard, k: int, mesh, minimizer_m: int = 7
):
    """The super-k-mer exchange over ``mesh``: [D, T + k - 1] uint8 shards
    -> (planes, meta, overflow). planes: W int32 tensors [local shards,
    D*cap] of packed record bases (u32 bits); meta: int32 [local shards,
    D*cap] run lengths in windows (0 = unused slot)."""
    D = mesh.size
    superkmer_geometry(k, minimizer_m)  # raises unless 1 <= m < k, before the capacity
    shard_fn = functools.partial(
        _super_shard, k=k, D=D, minimizer_m=minimizer_m,
        cap=_superkmer_capacity(bases.shape[1] - k + 1, D, k, minimizer_m),
    )

    def run(s):
        return shard_fn(_shard_input((bases,), s, mesh.device), int(n_own_per_shard[s]))

    recv, flags = mesh.exchange(run)
    return recv[:-1], recv[-1], mesh.max_reduce(flags)


def expand_superkmers(planes, meta, k: int, m: int) -> np.ndarray:
    """Received super-k-mer records -> a sentinel-separated u8 base stream:
    each record with run length r > 0 gives its r+k-1 bases and one
    INVALID separator, so a rolling scan of the stream sees exactly r
    windows per record."""
    skmax, W = superkmer_geometry(k, m)
    meta = np.asarray(meta).reshape(-1)
    sel = meta > 0
    r = meta[sel].astype(np.int64)
    if r.size and int(r.max()) > k - m + 1:
        raise AssertionError(f"super-k-mer run length {int(r.max())} exceeds k-m+1={k-m+1}")
    out = np.empty((r.size, skmax + 1), np.uint8)
    out[:, skmax] = encode_ops.INVALID
    for j in range(skmax):
        w, t = divmod(j, 16)
        plane = np.asarray(planes[w]).reshape(-1).view(np.uint32)[sel]
        out[:, j] = ((plane >> np.uint32(2 * t)) & np.uint32(3)).astype(np.uint8)
    cols = np.arange(skmax + 1, dtype=np.int64)[None, :]
    out[cols >= (r + k - 1)[:, None]] = encode_ops.INVALID
    return out.reshape(-1)


def _count_stream_host(stream: np.ndarray, k: int, canonical: bool):
    """Sorted-unique (codes_u64, counts_i64) of a sentinel-separated base
    stream, by the native host counter."""
    return native.count_sparse_host_native(stream, k, canonical)


def count_bucket_sharded_super(
    flat: np.ndarray,
    k: int,
    canonical: bool,
    mesh,
    minimizer_m: int = 7,
    total_own=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host entry of the super-k-mer exchange: shard with halos, route
    minimizer runs, expand each owner's records on the host, count them
    with the native host counter, merge. Raises ``OverflowError`` on a
    send-capacity overflow (pathological run density)."""
    shards, n_own = shard_stream_with_halo(flat, k, mesh, total_own)
    planes, meta, overflow = exchange_superkmers_bucket_sharded(
        shards, n_own, k, mesh, minimizer_m
    )
    if overflow:
        raise OverflowError(
            "super-k-mer exchange: an owner's record share exceeded the "
            "send capacity (pathological minimizer-run density) — use the "
            "aggregated exchange (count_bucket_sharded)"
        )
    planes = [p.cpu().numpy() for p in planes]
    meta = meta.cpu().numpy()
    tables = [
        _count_stream_host(expand_superkmers([p[i] for p in planes], meta[i], k,
                                             minimizer_m), k, canonical)
        for i in range(meta.shape[0])
    ]
    return merge_sparse_tables(mesh.gather(tables))


def superkmer_records_device(bases: torch.Tensor, n_own: int, k: int,
                             minimizer_m: int = 7):
    """Single-device super-k-mer compaction: a u8 stream [T] -> (planes
    tuple [W] of int32 [n], meta int32 [n], n_records); the records
    (consecutive windows sharing a minimizer position, as one record)
    occupy the first n_records entries in stream order, zeros behind, so
    the host fetches only that prefix."""
    n = bases.shape[0] - k + 1
    _, run_start, run_len, planes = _superkmer_records(bases, n_own, k, minimizer_m)
    meta = torch.where(run_start, run_len, 0)
    idx = torch.arange(n, dtype=torch.int32, device=bases.device)
    key = torch.where(run_start, idx, n)
    _, order = torch.sort(key, stable=True)
    return tuple(p[order] for p in planes), meta[order], run_start.sum().to(torch.int32)


def table_from_superkmers(planes, meta, n_records, k: int, minimizer_m: int,
                          canonical: bool) -> tuple[np.ndarray, np.ndarray]:
    """``superkmer_records_device``'s output -> sorted (codes, counts):
    fetches only the record prefix (a power-of-two bucket of at least 128),
    expands it, counts it on the host."""
    m = int(n_records)
    if m == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    n = int(meta.shape[0])
    mp = min(max(1 << (m - 1).bit_length(), 128), n)
    meta_h = meta[:mp].cpu().numpy()[:m]
    planes_h = [p[:mp].cpu().numpy()[:m] for p in planes]
    stream = expand_superkmers(planes_h, meta_h, k, minimizer_m)
    return _count_stream_host(stream, k, canonical)


# ---------------------------------------------------------------------------
# Host feeder
# ---------------------------------------------------------------------------


def shard_stream_with_halo(
    flat: np.ndarray, k: int, mesh, total_own=None
) -> tuple[np.ndarray, np.ndarray]:
    """Split a flat stream into [D, T + k - 1] shards with per-shard halos
    (tail windows completed by the next shard's head) and the per-shard
    owned-window counts; pads with INVALID. Only windows starting before
    ``total_own`` (default: the whole stream) are owned. An empty stream
    still gives k-wide all-INVALID shards (an empty table)."""
    D = mesh.size
    total = flat.shape[0]
    if total_own is None:
        total_own = total
    T = max(-(-total // D), 1)
    halo = k - 1
    out = np.full((D, T + halo), encode_ops.INVALID, dtype=np.uint8)
    n_own = np.zeros(D, dtype=np.int32)
    for d in range(D):
        start = d * T
        end = min(start + T + halo, total)
        if start < total:
            seg = flat[start:end]
            out[d, : seg.shape[0]] = seg
            n_own[d] = max(min(T, total_own - start), 0)
    return out, n_own
