"""The port's command line, ``kmer-gpu``.

The port of ``dna_kmeres_parallel_tpu/cli.py`` (``kmer-tpu``): the same
subcommands, flags, JSON reports, output bytes and exit codes, with two
changes: ``--engine {gpu,oracle,native}`` (``gpu`` in place of ``tpu``)
and ``--device {cuda,cpu}`` (default ``cuda``, which exits with an error
where CUDA is missing; ``cpu`` runs the kernels' plain versions).

  kmer-gpu count    --k 4 in.fasta -o table.csv
  kmer-gpu distance --k 3 in.fasta -o distances.csv [--tsv min_distances.csv]
  kmer-gpu selftest --k 3 in.fasta       # engine vs oracle vs C++ host engine
  kmer-gpu bench    --k 21 --bases 64M   # device-program microbench
  kmer-gpu calibrate                     # the distance gates' rates, persisted

Routing follows ``kmer-tpu``: ``count`` dense up to k=12 and sparse above;
``distance`` dense where k <= 15 and ``sparse_engine
.dense_distance_preferred`` holds, else the sparse tables (the union
route or the host two-pointer, in one shot or streamed in panels); the
(min,+) products of the dense and union routes take K3/K4 or the
threshold route (``sparse_engine.threshold_plan``). The gates read the
rates ``ops/calibrate`` persisted for this card and host.

Plain FASTA, FASTQ and gzip paths with the modern record semantics are
read by the native parser; the reference's record splitters
(``--parser blank_line|no_blank_line``) by ``utils/fasta``.

This module, and nothing else in the port, reads the environment:

- ``KMER_GPU_DIST_UNION``: the union route, "auto" (default), "on"/"1"
  or "off"/"0";
- ``KMER_GPU_DIST_THRESHOLD``: the threshold (min,+) route on int8
  tensor cores, in the dense engine and the union route, "auto"
  (default), "on"/"1" or "off"/"0" (``KMER_TPU_DIST_MXU``'s
  counterpart); ``KMER_GPU_THRESHOLD_CMAX``: its cap on cmax's bucket
  (default 64), which when set skips the cost comparison
  (``KMER_TPU_MXU_CMAX``'s counterpart);
- ``KMER_GPU_DENSE_DIST_BUDGET``, ``KMER_GPU_UNION_DIST_BUDGET``: the
  memory budgets, in bytes, of the dense counts matrix and of the union
  route;
- ``KMER_GPU_CALIBRATION_FILE``: the calibration file to read and write;
  else ``calibration_<fingerprint>.json`` in ``KMER_GPU_CAL_DIR`` (default
  ``build/calibration/`` beside the package).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np


class DeviceUnavailable(Exception):
    """The device a subcommand was asked to run on does not exist here."""


def _parse_size(s: str) -> int:
    s = s.strip().upper()
    for suffix, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30)):
        if s.endswith(suffix):
            return int(float(s[:-1]) * m)
    return int(s)


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--k", type=int, default=3, help="k-mer length")
    p.add_argument(
        "--canonical",
        action="store_true",
        help="fold reverse complements (min(code, rc))",
    )
    p.add_argument(
        "--max-seqs", type=int, default=None, help="ingest cap (reference: 100)"
    )
    p.add_argument(
        "--parser",
        choices=("modern", "blank_line", "no_blank_line"),
        default="modern",
        help="record-splitting semantics (reference emulation variants)",
    )
    p.add_argument(
        "--engine",
        choices=("gpu", "oracle", "native"),
        default="gpu",
        help="gpu = the port's engines (CUDA kernels, or their plain "
        "versions with --device cpu), oracle = NumPy golden engine, "
        "native = C++ host engine (count command, any k <= 31)",
    )
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the gpu engine runs: cuda (the hand-written kernels; "
        "an error without CUDA) or cpu (their plain PyTorch versions)",
    )
    p.add_argument(
        "--mesh",
        type=int,
        default=None,
        metavar="N",
        help="run over a mesh of N shards on the --device: data-parallel "
        "counting (count and stream: per-shard partials merged exactly) and "
        "partner-sharded distances (distance, incl. --stream-panel: dense "
        "panels always, sparse panels when the union route runs); "
        "bit-identical output at any N",
    )
    p.add_argument(
        "--device-sort",
        choices=("auto", "on", "off"),
        default="auto",
        help="sparse path (k >= 13): whether the device sorts window words. "
        "auto (default): count builds the table on the card where it fits "
        "(one sort and run-length of the call's windows), else as off; "
        "stream and count --mesh take it as off. on: the device sorts each "
        "batch and the host compacts sorted words. off: the native radix "
        "compactor takes unsorted words",
    )
    p.add_argument(
        "--compact",
        choices=("auto", "device", "host", "device-rle", "device-super"),
        default="auto",
        help="sparse streamed path: build batch tables from device-shipped "
        "words ('auto', the default, and 'device'), from the host-resident "
        "stream with the native engine ('host'), or have the device sort "
        "and collapse runs and ship only distinct (code, count) pairs "
        "('device-rle'), or ship super-k-mer records, about 1.5-2 B a "
        "window instead of 6-8 ('device-super')",
    )


def _build_config(args):
    from dna_kmeres_parallel_tpu_torch.utils.config import KmerConfig

    ds = getattr(args, "device_sort", "auto")
    return KmerConfig(
        k=args.k,
        canonical=args.canonical,
        max_seqs=args.max_seqs,
        parser_variant=args.parser,
        mesh_shape=(args.mesh,) if getattr(args, "mesh", None) else (),
        device_sort=None if ds == "auto" else ds == "on",
        compact=getattr(args, "compact", "auto"),
    )


def _device(args):
    """The torch device of the gpu engine, resolved once per run."""
    from dna_kmeres_parallel_tpu_torch.ops import runtime

    try:
        return runtime.resolve_device(args.device)
    except RuntimeError as e:
        raise DeviceUnavailable(str(e)) from e


def _env_bytes(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if not value else int(value)


def _route_mode(name: str) -> str:
    """A route's switch from the environment variable ``name``: auto
    (the default), on/1 or off/0."""
    value = os.environ.get(name, "auto").strip().lower()
    modes = {"0": "off", "1": "on", "off": "off", "on": "on", "auto": "auto"}
    if value not in modes:
        raise ValueError(f"{name} must be auto, on/1 or off/0, got {value!r}")
    return modes[value]


def _threshold_cap() -> int | None:
    value = os.environ.get("KMER_GPU_THRESHOLD_CMAX")
    return int(value) if value else None


def _calibration_file(dev):
    from dna_kmeres_parallel_tpu_torch.ops import calibrate

    explicit = os.environ.get("KMER_GPU_CALIBRATION_FILE")
    if explicit:
        return explicit
    return calibrate.calibration_path(dev, os.environ.get("KMER_GPU_CAL_DIR") or None)


def _gates(dev) -> dict:
    """The distance gates' arguments: the calibrated rates of this card and
    host, the union and threshold switches, the threshold route's cap and
    the budgets."""
    from dna_kmeres_parallel_tpu_torch.models import sparse_engine
    from dna_kmeres_parallel_tpu_torch.ops import calibrate

    return {
        "rates": calibrate.load_rates(_calibration_file(dev)),
        "union": _route_mode("KMER_GPU_DIST_UNION"),
        "threshold": _route_mode("KMER_GPU_DIST_THRESHOLD"),
        "threshold_cap": _threshold_cap(),
        "union_budget_bytes": _env_bytes(
            "KMER_GPU_UNION_DIST_BUDGET", sparse_engine.UNION_DIST_BUDGET),
        "dense_budget_bytes": _env_bytes(
            "KMER_GPU_DENSE_DIST_BUDGET", sparse_engine.DENSE_DIST_BUDGET),
    }


def _threshold_kw(gates: dict) -> dict:
    """The threshold route's switch and cap, as the engines take them."""
    return {"threshold": gates["threshold"], "threshold_cap": gates["threshold_cap"]}


def _expand_inputs(inputs) -> list[str]:
    """Expand globs; several paths are read in order."""
    import glob as globmod

    if isinstance(inputs, (str, os.PathLike)):
        inputs = [inputs]
    paths: list[str] = []
    for item in inputs:
        s = str(item)
        if any(ch in s for ch in "*?["):
            matches = sorted(globmod.glob(s))
            if not matches:
                raise FileNotFoundError(s)
            paths.extend(matches)
        else:
            paths.append(s)
    return paths


@dataclass
class Records:
    """The records of a run's inputs: one flat u8 stream (base codes, a
    single 0xFF between records), each record's length and header line."""

    stream: np.ndarray
    lengths: np.ndarray
    ids: list[str]

    @property
    def n_seqs(self) -> int:
        return len(self.ids)

    @property
    def total_bases(self) -> int:
        return int(self.lengths.sum())

    @property
    def invalid_bases(self) -> int:
        """Characters outside {A, C, G, T} (the separators not counted)."""
        return int(np.count_nonzero(self.stream == 0xFF)) - max(self.n_seqs - 1, 0)

    def seqs(self) -> list[str]:
        """The records as strings, every invalid character as 'N' (what
        counting and distances read of a record is the same)."""
        letters = np.frombuffer(b"ACGTN", dtype=np.uint8)
        starts = np.cumsum(self.lengths + 1) - (self.lengths + 1)
        chars = letters[np.minimum(self.stream, 4)]
        return [chars[s : s + n].tobytes().decode("ascii")
                for s, n in zip(starts.tolist(), self.lengths.tolist())]


def _load_records(args) -> Records:
    """Every input's records, at most ``--max-seqs`` over all inputs: the
    native parser for the modern record semantics (``parse_fasta_text``:
    the records ``kmer-tpu`` reads in Python, also where a lone CR ends a
    line), ``utils/fasta`` for the reference's splitters."""
    from dna_kmeres_parallel_tpu_torch import native
    from dna_kmeres_parallel_tpu_torch.utils import codec, fasta

    parts: list[np.ndarray] = []
    lengths: list[np.ndarray] = []
    ids: list[str] = []
    for path in _expand_inputs(args.input):
        remaining = None if args.max_seqs is None else args.max_seqs - len(ids)
        if remaining is not None and remaining <= 0:
            break
        if args.parser == "modern":
            parsed = native.parse_fasta_text(path, max_seqs=remaining)
            stream, lens, names = parsed.stream, parsed.lengths, parsed.ids
        else:
            recs = fasta.parse_fasta_reference(path, variant=args.parser, max_seqs=remaining)
            stream = codec.concat_with_sentinels([r.seq for r in recs])
            lens = np.array([len(r.seq) for r in recs], dtype=np.int64)
            names = [r.id for r in recs]
        if not names:
            continue
        if ids:
            parts.append(np.array([codec.INVALID_BASE], dtype=np.uint8))
        parts.append(stream)
        lengths.append(lens)
        ids.extend(names)
    return Records(
        stream=np.concatenate(parts) if parts else np.zeros(0, np.uint8),
        lengths=np.concatenate(lengths) if lengths else np.zeros(0, np.int64),
        ids=ids,
    )


def _write_table(path, result, k: int) -> None:
    """A count result (dense or sparse) as the ``kmer,count`` CSV."""
    from dna_kmeres_parallel_tpu_torch.utils import io

    if hasattr(result, "hist"):
        codes = np.flatnonzero(result.hist)
        io.write_count_codes_csv(path, k, codes.astype(np.uint64), result.hist[codes])
    else:
        io.write_count_codes_csv(path, k, result.codes, result.counts)


def cmd_count(args) -> int:
    from dna_kmeres_parallel_tpu_torch.models import oracle
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseCountResult
    from dna_kmeres_parallel_tpu_torch.utils import codec, io

    sparse = args.k > 12  # beyond the dense 4^k-bins band
    mesh_stream = bool(getattr(args, "mesh", None)) and args.engine == "gpu"
    if mesh_stream:
        # The streaming counter parses the files itself.
        records = None
        total_bases = None
    else:
        records = _load_records(args)
        total_bases = records.total_bases
    npz = bool(args.output) and str(args.output).endswith(".npz")
    result = None
    table = None
    t0 = time.perf_counter()
    if args.engine == "oracle":
        seqs = records.seqs()
        table = oracle.count_table_any_k(seqs, args.k, args.canonical)
        total_kmers = sum(table.values())
        distinct = len(table)
        if npz:
            codes = np.sort(np.array([codec.kmer_to_code(m) for m in table], dtype=np.uint64))
            counts = np.array(
                [table[codec.code_to_kmer(int(c), args.k)] for c in codes], dtype=np.int64)
            result = SparseCountResult(
                k=args.k, canonical=args.canonical, codes=codes, counts=counts,
                n_seqs=len(seqs), total_bases=total_bases,
            )
    elif args.engine == "native":
        # The C++ host engine: rolling encoder fused into the radix
        # compactor; its tables equal the device route's.
        from dna_kmeres_parallel_tpu_torch import native

        codes, counts = native.count_sparse_host_native(
            records.stream, args.k, args.canonical)
        result = SparseCountResult(
            k=args.k, canonical=args.canonical, codes=codes, counts=counts,
            n_seqs=records.n_seqs, total_bases=total_bases,
        )
    elif mesh_stream:
        # `count --mesh N` is `stream --mesh N` without a checkpoint.
        from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter

        inputs = _expand_inputs(args.input)
        result = StreamingCounter(_build_config(args), device=_device(args)).run(
            inputs if len(inputs) > 1 else inputs[0])
        total_bases = result.total_bases
    elif sparse:
        from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseKmerEngine

        result = SparseKmerEngine(_build_config(args), device=_device(args)).count_stream(
            records.stream, total_bases, records.n_seqs)
    else:
        from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine

        result = KmerEngine(_build_config(args), device=_device(args)).count_stream(
            records.stream, total_bases, records.n_seqs)
    if result is not None and table is None:
        total_kmers, distinct = result.total_kmers, result.distinct_kmers
    elapsed = time.perf_counter() - t0

    kept = None
    if args.min_count > 1:
        # KMC-style -ci: drop below-threshold k-mers from the OUTPUT (the
        # stats above report the whole table).
        if result is not None and hasattr(result, "codes"):
            keep = result.counts >= args.min_count
            result = dataclasses.replace(
                result, codes=result.codes[keep], counts=result.counts[keep])
            kept = int(result.codes.shape[0])
        elif table is not None:
            table = {m: c for m, c in table.items() if c >= args.min_count}
            kept = len(table)
        elif result is not None:
            hist = result.hist.copy()
            hist[hist < args.min_count] = 0
            result = dataclasses.replace(result, hist=hist)
            kept = int(np.count_nonzero(hist))

    if args.output and npz and result is not None:
        io.write_count_npz(args.output, result)
    elif args.output and table is not None:
        io.write_count_table_csv(args.output, table)
    elif args.output:
        _write_table(args.output, result, args.k)
    report = {
        "k": args.k,
        "canonical": args.canonical,
        "engine": args.engine + ("/sparse" if sparse and args.engine == "gpu" else ""),
        "n_seqs": result.n_seqs if mesh_stream else records.n_seqs,
        "total_bases": total_bases,
        "total_kmers": total_kmers,
        "distinct_kmers": distinct,
        "elapsed_s": round(elapsed, 4),
        "bases_per_sec": round(total_bases / max(elapsed, 1e-9), 1),
        "output": args.output,
    }
    if kept is not None:
        report["min_count"] = args.min_count
        report["distinct_kept"] = kept
    print(json.dumps(report))
    return 0


def _stream_report(report: dict, **extra) -> dict:
    """A streamed distance run's report with the keys ``kmer-tpu`` prints
    (the port's writer also returns its phase split, left out here)."""
    for key in ("write_s", "phases"):
        report.pop(key, None)
    report.update(extra)
    report["elapsed_s"] = round(report["elapsed_s"], 4)
    return report


def cmd_distance(args) -> int:
    from dna_kmeres_parallel_tpu_torch.models import oracle, sparse_engine
    from dna_kmeres_parallel_tpu_torch.ops.encode import MAX_DENSE_K
    from dna_kmeres_parallel_tpu_torch.utils import io

    if args.engine == "native":
        print(
            "error: --engine native serves the count command only "
            "(distances run on gpu or oracle)",
            file=sys.stderr,
        )
        return 2
    records = _load_records(args)
    seqs = records.seqs()
    t0 = time.perf_counter()
    dev = gates = None
    gate_kw = {}
    if args.engine != "oracle":
        dev = _device(args)
        gates = _gates(dev)
        gate_kw = {"budget_bytes": gates["dense_budget_bytes"], "rates": gates["rates"]}
    dense = args.k <= MAX_DENSE_K and sparse_engine.dense_distance_preferred(
        len(seqs), args.k, records.lengths, **gate_kw)
    if not dense:
        # Sparse per-sequence tables: every k > 15, and mid k wherever the
        # dense [S, 4^k] matrix is over its budget or predicted slower.
        route_info: dict = {}
        sparse_kw = {} if gates is None else {
            "device": dev, "union": gates["union"], "rates": gates["rates"],
            "union_budget_bytes": gates["union_budget_bytes"], "info": route_info,
            **_threshold_kw(gates)}
        if args.engine != "oracle" and args.stream_panel and args.output:
            mesh = None
            if getattr(args, "mesh", None) and args.mesh > 1:
                from dna_kmeres_parallel_tpu_torch.parallel.mesh import make_mesh

                mesh = make_mesh(args.mesh, dev)
            report = sparse_engine.distance_sparse_stream_to_csv(
                seqs, args.k, args.output, args.canonical,
                panel_rows=args.stream_panel,
                checkpoint_path=getattr(args, "checkpoint", None),
                mesh=mesh, **sparse_kw,
            )
            print(json.dumps(_stream_report(
                report, k=args.k, engine=route_info.get("route", "host/sparse"),
                streamed=True)))
            return 0
        if args.engine == "oracle":
            packed = oracle.distance_matrix_packed_sparse(seqs, args.k, args.canonical)
        else:
            packed = sparse_engine.distance_sparse_packed(
                seqs, args.k, args.canonical, **sparse_kw)
        elapsed = time.perf_counter() - t0
        if args.output:
            io.write_distances_csv(args.output, packed)
        if args.tsv:
            io.write_min_distances_tsv(args.tsv, packed, len(seqs))
        print(json.dumps({
            "k": args.k,
            "engine": ("oracle" if args.engine == "oracle"
                       else route_info.get("route", "host/sparse")),
            "n_seqs": len(seqs),
            "n_pairs": int(packed.shape[0]),
            "elapsed_s": round(elapsed, 4),
            "output": args.output,
        }))
        return 0
    from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine

    if args.engine != "oracle" and args.stream_panel and args.output:
        # The [S, S] matrix never exists: panels of packed rows append to
        # the CSV (resumable with --checkpoint).
        report = KmerEngine(_build_config(args), device=dev, rates=gates["rates"],
                            **_threshold_kw(gates)).distance_stream_to_csv(
            seqs, args.output, panel_rows=args.stream_panel,
            checkpoint_path=getattr(args, "checkpoint", None),
        )
        print(json.dumps(_stream_report(report, k=args.k, engine=args.engine, streamed=True)))
        return 0
    if args.engine == "oracle":
        packed = oracle.distance_matrix_packed(seqs, args.k, args.canonical)
    else:
        packed = KmerEngine(_build_config(args), device=dev, rates=gates["rates"],
                            **_threshold_kw(gates)).distance_sequences(seqs).packed
    elapsed = time.perf_counter() - t0

    if args.output:
        io.write_distances_csv(args.output, packed)
    if args.tsv:
        io.write_min_distances_tsv(args.tsv, packed, len(seqs))
    print(json.dumps({
        "k": args.k,
        "engine": args.engine,
        "n_seqs": len(seqs),
        "n_pairs": int(packed.shape[0]),
        "elapsed_s": round(elapsed, 4),
        "output": args.output,
    }))
    return 0


def cmd_query(args) -> int:
    """Look up k-mer counts in a saved table (.npz)."""
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseCountResult
    from dna_kmeres_parallel_tpu_torch.utils import io

    k, canonical, codes, counts = io.read_count_npz(args.table)
    result = SparseCountResult(
        k=k, canonical=canonical, codes=codes, counts=counts, n_seqs=0, total_bases=0,
    )
    out = {}
    for kmer in args.kmers:
        q = kmer.upper()
        if len(q) != k or any(c not in "ACGT" for c in q):
            print(f"error: {kmer!r} is not a valid {k}-mer over ACGT", file=sys.stderr)
            return 2
        out[kmer] = result.count_of(q)
    print(json.dumps({"k": k, "canonical": canonical, "counts": out}))
    return 0


def cmd_selftest(args) -> int:
    """Three-way differential: the port's engine, the NumPy oracle and the
    C++ host engine, on the same records. rc 0 when all agree."""
    from dna_kmeres_parallel_tpu_torch import native
    from dna_kmeres_parallel_tpu_torch.models import oracle
    from dna_kmeres_parallel_tpu_torch.utils import codec

    records = _load_records(args)
    seqs = records.seqs()
    dev = _device(args)
    codes, counts = native.count_sparse_host_native(records.stream, args.k, args.canonical)
    native_tbl = {codec.code_to_kmer(int(c), args.k): int(n) for c, n in zip(codes, counts)}
    if args.k > 12:
        from dna_kmeres_parallel_tpu_torch.models import sparse_engine

        got = sparse_engine.SparseKmerEngine(_build_config(args), device=dev).count_sequences(seqs)
        want = oracle.count_table_any_k(seqs, args.k, args.canonical)
        verdict = {
            "engine": "sparse",
            "counts_equal": got.table() == want,
            "native_counts_equal": native_tbl == want,
            "n_seqs": len(seqs),
            "total_kmers": sum(want.values()),
        }
        if len(seqs) >= 2:
            gates = _gates(dev)
            d_got = sparse_engine.distance_sparse_packed(
                seqs, args.k, args.canonical, device=dev, union=gates["union"],
                union_budget_bytes=gates["union_budget_bytes"], rates=gates["rates"],
                **_threshold_kw(gates))
            d_want = oracle.distance_matrix_packed_sparse(seqs, args.k, args.canonical)
            verdict["distances_equal"] = bool(np.array_equal(d_got, d_want))
        print(json.dumps(verdict))
        ok = (verdict["counts_equal"] and verdict["native_counts_equal"]
              and verdict.get("distances_equal", True))
        return 0 if ok else 1
    from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine

    gates = _gates(dev)
    verdict = KmerEngine(_build_config(args), device=dev, rates=gates["rates"],
                         **_threshold_kw(gates)).verify_against_oracle(seqs)
    verdict["native_counts_equal"] = native_tbl == oracle.count_table_any_k(
        seqs, args.k, args.canonical)
    print(json.dumps(verdict))
    ok = verdict["counts_equal"] and verdict["distances_equal"]
    return 0 if ok and verdict["native_counts_equal"] else 1


def cmd_stream(args) -> int:
    """Resumable streaming count with metrics and checkpointing."""
    if args.engine == "native":
        print(
            "error: --engine native serves the count command only "
            "(use `count --engine native` for the C++ host engine)",
            file=sys.stderr,
        )
        return 2
    from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter
    from dna_kmeres_parallel_tpu_torch.utils import io

    sc = StreamingCounter(
        _build_config(args),
        device=_device(args),
        checkpoint_path=args.checkpoint,
        checkpoint_every_bases=_parse_size(args.checkpoint_every),
    )
    inputs = _expand_inputs(args.input)
    result = sc.run(inputs if len(inputs) > 1 else inputs[0])
    if args.output:
        if str(args.output).endswith(".npz"):
            io.write_count_npz(args.output, result)
        else:
            _write_table(args.output, result, args.k)
    print(json.dumps({
        "k": args.k,
        "canonical": args.canonical,
        "n_seqs": result.n_seqs,
        "total_bases": result.total_bases,
        "total_kmers": result.total_kmers,
        "distinct_kmers": result.distinct_kmers,
        "elapsed_s": round(result.elapsed_s, 4),
        "metrics": sc.metrics.report(),
        "checkpoint": args.checkpoint,
        "output": args.output,
    }))
    return 0


def _table_set_op(ca, na, cb, nb, op):
    """Set operations on sorted-unique tables (KMC-tools semantics):
    intersect keeps the codes present in both with the smaller count;
    subtract takes B's counts off A's and drops what is not positive."""
    if cb.shape[0] == 0:
        if op == "intersect":
            return ca[:0], na[:0].astype(np.int64)
        return ca, na.astype(np.int64)
    idx_c = np.minimum(np.searchsorted(cb, ca), cb.shape[0] - 1)
    match = cb[idx_c] == ca
    other = np.where(match, nb[idx_c], 0)
    if op == "intersect":
        keep = match
        counts = np.minimum(na, other)
    else:  # subtract
        counts = na - other
        keep = counts > 0
    return ca[keep], counts[keep].astype(np.int64)


def _read_tables(paths):
    """Count tables from .npz files -> (k, canonical, [(codes, counts)]);
    raises ValueError naming the first file whose k or canonical differs."""
    from dna_kmeres_parallel_tpu_torch.utils import io

    tables = []
    k = canonical = None
    for path in paths:
        tk, tc, codes, counts = io.read_count_npz(path)
        if k is None:
            k, canonical = tk, tc
        elif (tk, tc) != (k, canonical):
            raise _Mismatch(path, f"({tk},{tc}) != ({k},{canonical})")
        tables.append((codes, counts))
    return k, canonical, tables


class _Mismatch(Exception):
    """Count tables of different k or canonical."""

    def __init__(self, path, detail: str):
        super().__init__(f"{path}: k/canonical mismatch {detail}")
        self.path = path


def cmd_merge(args) -> int:
    """Merge count-table npz files into one exact table (sum), or fold
    them left with intersect or subtract."""
    from dna_kmeres_parallel_tpu_torch.models.sparse_engine import (
        SparseCountResult,
        merge_sparse_tables,
    )
    from dna_kmeres_parallel_tpu_torch.utils import io

    try:
        k, canonical, tables = _read_tables(_expand_inputs(args.input))
    except _Mismatch as e:
        print(json.dumps({"error": str(e)}), file=sys.stderr)
        return 2
    if args.op == "sum":
        codes, counts = merge_sparse_tables(tables)
    else:
        codes, counts = tables[0]
        for cb, nb in tables[1:]:
            codes, counts = _table_set_op(codes, counts, cb, nb, args.op)
    result = SparseCountResult(
        k=k, canonical=canonical, codes=codes, counts=counts, n_seqs=0, total_bases=0,
    )
    if str(args.output).endswith(".npz"):
        io.write_count_npz(args.output, result)
    else:
        io.write_count_codes_csv(args.output, k, codes, counts)
    print(json.dumps({
        "k": k,
        "canonical": canonical,
        "inputs": len(tables),
        "total_kmers": result.total_kmers,
        "distinct_kmers": result.distinct_kmers,
        "output": args.output,
    }))
    return 0


def cmd_histo(args) -> int:
    """The k-mer spectrum: line i holds the number of distinct k-mers seen
    i times (the KMC/Gerbil ``histogram`` report)."""
    inputs = _expand_inputs(args.input)
    npz_inputs = [p for p in inputs if str(p).endswith(".npz")]
    if npz_inputs and len(npz_inputs) != len(inputs):
        print(json.dumps({"error": "histo inputs must be all .npz or all FASTA/FASTQ"}),
              file=sys.stderr)
        return 2
    if npz_inputs:
        from dna_kmeres_parallel_tpu_torch.models.sparse_engine import merge_sparse_tables

        try:
            k, canonical, tables = _read_tables(npz_inputs)
        except _Mismatch as e:
            print(json.dumps({"error": f"{e.path}: k/canonical mismatch"}), file=sys.stderr)
            return 2
        _, counts = merge_sparse_tables(tables)
    else:
        records = _load_records(args)
        k, canonical = args.k, args.canonical
        if args.engine == "oracle":
            from dna_kmeres_parallel_tpu_torch.models import oracle

            table = oracle.count_table_any_k(records.seqs(), args.k, args.canonical)
            counts = np.fromiter(table.values(), dtype=np.int64, count=len(table))
        elif args.engine == "native":
            from dna_kmeres_parallel_tpu_torch import native

            _, counts = native.count_sparse_host_native(
                records.stream, args.k, args.canonical)
        elif args.k > 12:
            from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseKmerEngine

            counts = SparseKmerEngine(_build_config(args), device=_device(args)).count_stream(
                records.stream, records.total_bases, records.n_seqs).counts
        else:
            from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine

            r = KmerEngine(_build_config(args), device=_device(args)).count_stream(
                records.stream, records.total_bases, records.n_seqs)
            counts = r.hist[r.hist > 0]

    cap = args.max_count
    spectrum = np.bincount(np.minimum(counts, cap).astype(np.int64), minlength=cap + 1)
    if args.output:
        with open(args.output, "w", encoding="ascii") as f:
            for i in range(1, cap + 1):
                f.write(f"{i}\t{int(spectrum[i])}\n")
    print(json.dumps({
        "k": k,
        "canonical": canonical,
        "distinct_kmers": int(counts.shape[0]),
        "total_kmers": int(counts.sum()),
        "max_count": int(counts.max()) if counts.size else 0,
        "spectrum_head": [int(x) for x in spectrum[1:11]],
        "output": args.output,
    }))
    return 0


def cmd_info(args) -> int:
    """Per-sequence stats of the inputs."""
    records = _load_records(args)
    lengths = records.lengths.tolist()
    report = {
        "n_seqs": records.n_seqs,
        "total_bases": records.total_bases,
        "min_len": min(lengths, default=0),
        "max_len": max(lengths, default=0),
        "invalid_bases": records.invalid_bases,
        "ids": records.ids[:20],
    }
    if args.verbose:
        report["lengths"] = lengths
    print(json.dumps(report))
    return 0


def cmd_calibrate(args) -> int:
    """Measure this card's and host's rates and persist them for the
    distance gates (``ops/calibrate``): the link always, the compute rates
    unless --link-only. Keys measured before and not now are kept."""
    from dna_kmeres_parallel_tpu_torch.ops import calibrate

    dev = _device(args)
    path = _calibration_file(dev)
    cal = calibrate.load_calibration(path)
    cal.update(calibrate.calibrate(dev, link_only=args.link_only))
    path = calibrate.save_calibration(cal, path)
    print(json.dumps({"calibration_file": str(path), **cal}))
    return 0


def cmd_bench(args) -> int:
    from dna_kmeres_parallel_tpu_torch.models.benchmarks import run_count_bench, run_sparse_bench
    from dna_kmeres_parallel_tpu_torch.utils.config import KmerConfig

    # As the counters route: the dense kernels up to k=8, the sparse
    # path's device program (no device sort by default) above.
    if args.k <= 8:
        report = run_count_bench(
            k=args.k, canonical=args.canonical, total_bases=_parse_size(args.bases),
            batch_bases=_parse_size(args.batch), device=_device(args),
        )
    else:
        cfg = KmerConfig(k=args.k, canonical=args.canonical)
        report = run_sparse_bench(
            k=args.k, canonical=args.canonical, total_bases=_parse_size(args.bases),
            batch_bases=_parse_size(args.batch), device_sort=bool(cfg.device_sort),
            row_len=cfg.sort_row_len, device=_device(args),
        )
    print(json.dumps(report))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kmer-gpu")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("count", help="k-mer frequency table for a FASTA file")
    _add_common(p)
    p.add_argument("input", nargs="+", help="FASTA path(s) or glob(s)")
    p.add_argument("-o", "--output", default=None, help="count table CSV path")
    p.add_argument(
        "--min-count", type=int, default=1, metavar="N",
        help="exclude k-mers seen fewer than N times from the output "
        "(KMC-style -ci; stats still report the full table)",
    )
    p.set_defaults(fn=cmd_count)

    p = sub.add_parser("query", help="look up k-mer counts in a saved .npz table")
    p.add_argument("table", help="count table .npz (from count/merge -o)")
    p.add_argument("kmers", nargs="+", help="k-mer string(s) to look up")
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser("distance", help="pairwise k-mer distance matrix")
    _add_common(p)
    p.add_argument("input", nargs="+", help="FASTA path(s) or glob(s)")
    p.add_argument(
        "-o", "--output", default=None, help="packed distances CSV (%%f per line)"
    )
    p.add_argument(
        "--tsv", default=None, help="ragged lower-triangle TSV (printMinDistances format)"
    )
    p.add_argument(
        "--stream-panel", type=int, default=None, metavar="ROWS",
        help="stream the distance matrix to CSV in ROWS-row panels "
        "(bounded memory for large sequence counts)",
    )
    p.add_argument(
        "--checkpoint", default=None,
        help="streamed-path checkpoint JSON (resume if present; the "
        "resumed CSV is byte-identical to a single-shot run)",
    )
    p.set_defaults(fn=cmd_distance)

    p = sub.add_parser("selftest", help="engine vs oracle vs C++ host engine")
    _add_common(p)
    p.add_argument("input", nargs="+", help="FASTA path(s) or glob(s)")
    p.set_defaults(fn=cmd_selftest)

    p = sub.add_parser("merge", help="merge count-table npz files into one exact table")
    p.add_argument("input", nargs="+", help="count npz path(s) or glob(s)")
    p.add_argument("-o", "--output", required=True, help="merged table (.npz or .csv)")
    p.add_argument(
        "--op", choices=("sum", "intersect", "subtract"), default="sum",
        help="sum = exact additive merge (default); intersect = codes in "
        "ALL inputs with min counts; subtract = left table minus the "
        "others' counts, non-positives dropped (KMC-tools semantics)",
    )
    p.set_defaults(fn=cmd_merge)

    p = sub.add_parser("histo", help="k-mer spectrum (count-of-counts histogram)")
    _add_common(p)
    p.add_argument("input", nargs="+", help="FASTA/FASTQ path(s) or a count .npz")
    p.add_argument("-o", "--output", default=None, help="spectrum TSV path")
    p.add_argument(
        "--max-count", type=int, default=10000,
        help="clip spectrum at this multiplicity (last bin absorbs the tail)",
    )
    p.set_defaults(fn=cmd_histo)

    p = sub.add_parser("info", help="per-sequence stats for a FASTA file")
    _add_common(p)
    p.add_argument("input", nargs="+", help="FASTA path(s) or glob(s)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("stream", help="resumable streaming count (checkpoint/resume, metrics)")
    _add_common(p)
    p.add_argument("input", nargs="+", help="FASTA path(s) or glob(s)")
    p.add_argument("-o", "--output", default=None, help="count table CSV path")
    p.add_argument("--checkpoint", default=None, help="checkpoint .npz path (resume if present)")
    p.add_argument(
        "--checkpoint-every", default="256M", help="bases between checkpoints (e.g. 64M, 1G)"
    )
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("bench", help="single-card device-program microbenchmark")
    p.add_argument("--k", type=int, default=11)
    p.add_argument("--canonical", action="store_true")
    p.add_argument("--bases", default="64M", help="total bases (e.g. 64M, 1G)")
    p.add_argument("--batch", default="8M", help="bases per device batch")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "calibrate",
        help="measure this card's and host's link and route rates and "
        "persist them for the distance gates (ops/calibrate)",
    )
    p.add_argument(
        "--link-only", action="store_true",
        help="measure only H2D/D2H/roundtrip (no (min,+) or two-pointer probes)",
    )
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.set_defaults(fn=cmd_calibrate)

    args = parser.parse_args(argv)
    if hasattr(args, "k"):
        kmax = 31
        if not (1 <= args.k <= kmax):
            parser.error(
                f"--k {args.k} out of range for '{args.command}': "
                f"supported 1 <= k <= {kmax}"
            )
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: cannot open input: {e.filename or e}", file=sys.stderr)
        return 2
    except (ValueError, NotImplementedError, DeviceUnavailable) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
