"""The port's command line (``kmer-gpu``, ``--device cpu``) against the
JAX package's (``kmer-tpu``) on the same seeded files, both called
in-process through ``main(argv)``: output files byte for byte (``.npz``:
equal arrays and metadata), JSON reports equal apart from the times, the
rates and the engine's name, and the same exit codes."""

import gzip
import json

import numpy as np
import pytest

from dna_kmeres_parallel_tpu import cli as jax_cli
from dna_kmeres_parallel_tpu.models import distance_stream as jax_distance_stream
from dna_kmeres_parallel_tpu.models import oracle
from dna_kmeres_parallel_tpu_torch import cli
from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.models import distance_stream
from dna_kmeres_parallel_tpu_torch.utils import fasta

#: report keys that hold times or rates
TIMED = ("elapsed_s", "bases_per_sec", "metrics")


def fasta_text(seed: int, n: int = 9) -> str:
    """Seeded records of 0-420 bases: N runs, soft-masked spans, a CR line
    end, one record shorter than every k and one empty record."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(150, 420))
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)].copy()
        a = int(rng.integers(0, L - 20))
        seq[a : a + int(rng.integers(1, 15))] = ord("N")
        b = int(rng.integers(0, L - 20))
        seq[b : b + 6] += 32  # lowercase: invalid
        s = seq.tobytes().decode()
        if i == 2:
            s = "ACGTA"
        if i == 5:
            s = ""
        end = "\r\n" if i == 3 else "\n"
        out.append(f">rec{i} seeded{end}" + "".join(
            s[j : j + 60] + end for j in range(0, len(s), 60)))
    return "".join(out)


@pytest.fixture(autouse=True)
def _no_calibration(monkeypatch, tmp_path):
    # The port's gates run on DistanceRates' defaults here, whatever
    # calibration file the checkout holds.
    monkeypatch.setenv("KMER_GPU_CAL_DIR", str(tmp_path / "no_cal"))
    for name in ("KMER_GPU_CALIBRATION_FILE", "KMER_GPU_DIST_UNION",
                 "KMER_GPU_DENSE_DIST_BUDGET", "KMER_GPU_UNION_DIST_BUDGET"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_inputs")
    paths = {"fa": d / "in.fasta", "fb": d / "other.fasta"}
    paths["fa"].write_text(fasta_text(1))
    paths["fb"].write_text(fasta_text(2, 5))
    records = fasta.parse_fasta(str(paths["fa"]))
    fq = d / "reads.fq"
    fq.write_text("".join(f"@r{i}\n{r.seq}\n+\n{'I' * len(r.seq)}\n"
                          for i, r in enumerate(records) if r.seq))
    paths["fq"] = fq
    gz = d / "in.fasta.gz"
    gz.write_bytes(gzip.compress(paths["fa"].read_bytes()))
    paths["gz"] = gz
    blank = d / "blank.fasta"  # the reference splitters' layout
    blank.write_text("".join(f">b{i}\nACGTTGCA{'AC' * i}\nGGTACCAT\n\n" for i in range(6)))
    paths["blank"] = blank
    return paths


def call(main, argv, capsys):
    """(rc, the JSON report on stdout or None, stderr)."""
    rc = main([str(a) for a in argv])
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err


def both(argv_jax, argv_port, capsys):
    """Run one command line through both packages: (rc, report) each."""
    jax_rc, jax_report, _ = call(jax_cli.main, argv_jax, capsys)
    port_rc, port_report, err = call(cli.main, argv_port, capsys)
    assert port_rc == jax_rc, err
    return jax_report, port_report


def untimed(report, engine: bool = True):
    if report is None:
        return None
    out = {k: v for k, v in report.items() if k not in TIMED}
    if engine and isinstance(out.get("engine"), str):
        out["engine"] = out["engine"].replace("tpu", "gpu")
    if not engine:
        out.pop("engine", None)
        out.pop("route", None)
    return out


def same_npz(a, b) -> bool:
    with np.load(a) as za, np.load(b) as zb:
        return sorted(za.files) == sorted(zb.files) and all(
            za[f].dtype == zb[f].dtype and np.array_equal(za[f], zb[f]) for f in za.files)


def same_output(a, b) -> bool:
    if str(a).endswith(".npz"):
        return same_npz(a, b)
    return a.read_bytes() == b.read_bytes()


def run_both(cmd, tmp_path, capsys, *args, out_name=None, engine=True, port_args=()):
    """``cmd args`` through both packages (the port with ``--device cpu``
    where the subcommand takes it), each writing its own ``-o`` file."""
    jo = po = None
    jargs, pargs = list(args), list(args) + list(port_args)
    if out_name:
        jo, po = tmp_path / f"jax_{out_name}", tmp_path / f"port_{out_name}"
        jargs += ["-o", jo]
        pargs += ["-o", po]
    dev = [] if cmd in ("query", "merge") else ["--device", "cpu"]
    jr, gr = both([cmd, *jargs], [cmd, *dev, *pargs], capsys)
    if jr is not None:
        for key in ("output", "calibration_file"):
            if key in jr:
                jr[key] = gr[key] = None
    assert untimed(gr, engine) == untimed(jr, engine)
    if out_name:
        assert same_output(jo, po), out_name
    return jr, gr


# ---------------------------------------------------------------------------
# count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [3, 4, 8, 13, 21, 31])
def test_count_matches_jax(inputs, tmp_path, capsys, k, canonical):
    flags = ["--k", k] + (["--canonical"] if canonical else [])
    for out in ("t.csv", "t.npz"):
        run_both("count", tmp_path, capsys, *flags, inputs["fa"], out_name=out)


@pytest.mark.parametrize("extra", [
    ["--k", 5, "--min-count", 2],
    ["--k", 21, "--min-count", 2],
    ["--k", 4, "--max-seqs", 3],
    ["--k", 21, "--max-seqs", 4],
    ["--k", 3, "--parser", "blank_line", "--max-seqs", 4],
    ["--k", 17, "--parser", "no_blank_line"],
    ["--k", 21, "--device-sort", "on"],
    ["--k", 13, "--engine", "oracle"],
    ["--k", 6, "--engine", "oracle", "--min-count", 2],
    ["--k", 21, "--engine", "native"],
    ["--k", 7, "--canonical", "--engine", "native", "--min-count", 2],
    ["--k", 21, "--mesh", 1],
    ["--k", 5, "--mesh", 1, "--canonical"],
])
@pytest.mark.parametrize("out", ["t.csv", "t.npz"])
def test_count_flags_match_jax(inputs, tmp_path, capsys, extra, out):
    path = inputs["blank"] if "--parser" in extra else inputs["fa"]
    dense_filtered_csv = (out == "t.csv" and "--min-count" in extra and "--engine" not in extra
                          and extra[1] <= 12)
    if not dense_filtered_csv:
        run_both("count", tmp_path, capsys, *extra, path, out_name=out)
        return
    # kmer-tpu writes no CSV for a dense table filtered by --min-count (a
    # fault of the JAX command line, ROADMAP queue 3): the port's CSV is
    # held against the JAX oracle engine's, and the reports as before.
    jo, po, ref = tmp_path / "j.csv", tmp_path / "p.csv", tmp_path / "ref.csv"
    jr, gr = both(["count", *extra, path, "-o", jo],
                  ["count", "--device", "cpu", *extra, path, "-o", po], capsys)
    assert not jo.exists()
    jr["output"] = gr["output"] = None
    assert untimed(gr) == untimed(jr)
    assert call(jax_cli.main, ["count", *extra, "--engine", "oracle", path, "-o", ref],
                capsys)[0] == 0
    assert po.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("src", ["fq", "gz"])
@pytest.mark.parametrize("k", [4, 21])
def test_count_fastq_and_gzip_match_jax(inputs, tmp_path, capsys, src, k):
    run_both("count", tmp_path, capsys, "--k", k, inputs[src], out_name="t.csv")


def test_count_several_inputs_and_globs_match_jax(inputs, tmp_path, capsys):
    run_both("count", tmp_path, capsys, "--k", 21, "--max-seqs", 11, inputs["fa"],
             inputs["fb"], out_name="t.csv")
    glob = str(inputs["fa"].parent / "*.fasta")
    run_both("count", tmp_path, capsys, "--k", 6, glob, out_name="t.npz")
    assert call(cli.main, ["count", "--device", "cpu", "--k", 4,
                           str(inputs["fa"].parent / "*.fa")], capsys)[0] == 2


def test_native_parser_records_equal_parse_fasta(inputs, tmp_path):
    # The port reads modern-semantics paths with the native parser: the
    # records (ids, N runs and soft masks, the empty record, CR line ends,
    # --max-seqs, FASTQ and gzip) are those of utils/fasta.parse_fasta.
    for src in ("fa", "fb", "fq", "gz"):
        for max_seqs in (None, 0, 1, 4, 100):
            recs = fasta.parse_fasta(str(inputs[src]), max_seqs=max_seqs)
            args = type("A", (), {"input": [str(inputs[src])], "max_seqs": max_seqs,
                                  "parser": "modern"})
            got = cli._load_records(args)
            assert got.ids == [r.id for r in recs], (src, max_seqs)
            want = [r.seq for r in recs]
            letters = np.frombuffer(b"ACGTN", np.uint8)
            norm = [letters[np.minimum(native_codes(s), 4)].tobytes().decode() for s in want]
            assert got.seqs() == norm, (src, max_seqs)
            assert got.invalid_bases == sum(sum(c not in "ACGT" for c in s) for s in want)
    assert any(r.seq == "" for r in fasta.parse_fasta(str(inputs["fa"])))


def native_codes(s: str) -> np.ndarray:
    from dna_kmeres_parallel_tpu_torch.utils import codec

    return codec.encode_bases(s)


def test_count_without_cuda_exits_nonzero(inputs, capsys):
    # The default device is the card: no quiet fall back to the CPU.
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, report, err = call(cli.main, ["count", "--k", 21, inputs["fa"]], capsys)
    assert rc != 0 and report is None and "CUDA" in err


@pytest.mark.parametrize("argv,out", [
    (["count", "--k", 21, "--mesh", 8], "t.csv"),
    (["stream", "--k", 21, "--mesh", 8], "s.npz"),
    (["distance", "--k", 3, "--mesh", 8], "d.csv"),
    (["stream", "--k", 21, "--compact", "device-super"], "s.npz"),
])
def test_mesh_and_super_flags_match_jax(inputs, tmp_path, capsys, argv, out):
    # kmer-tpu's mesh runs on its 8 virtual CPU devices, kmer-gpu's on a
    # LocalMesh of 8 shards on the CPU: the same outputs and reports.
    run_both(argv[0], tmp_path, capsys, *argv[1:], inputs["fa"], out_name=out)


@pytest.mark.parametrize("compact", ["device-rle", "device-super"])
def test_mesh_with_a_d2h_mode_gives_rc2_as_jax(inputs, capsys, compact):
    argv = ["stream", "--k", 21, "--mesh", 4, "--compact", compact, inputs["fa"]]
    jax_rc, _, jax_err = call(jax_cli.main, argv, capsys)
    rc, report, err = call(cli.main, [argv[0], "--device", "cpu", *argv[1:]], capsys)
    assert rc == jax_rc == 2 and report is None
    assert err == jax_err and "single-chip D2H mode" in err


@pytest.mark.parametrize("argv", [
    ["count", "--k", 0],
    ["count", "--k", 32],
    ["distance", "--k", 40],
])
def test_k_out_of_range_is_a_parser_error(inputs, capsys, argv):
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main([str(a) for a in argv] + [str(inputs["fa"])])
        assert e.value.code == 2
        assert "out of range" in capsys.readouterr().err


def test_missing_input_and_native_distance_give_rc2(inputs, tmp_path, capsys):
    for main, dev in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        assert call(main, ["count", *dev, "--k", 4, tmp_path / "absent.fasta"], capsys)[0] == 2
        assert call(main, ["distance", *dev, "--engine", "native", inputs["fa"]], capsys)[0] == 2
        assert call(main, ["stream", *dev, "--engine", "native", inputs["fa"]], capsys)[0] == 2


# ---------------------------------------------------------------------------
# distance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["gpu", "oracle"])
@pytest.mark.parametrize("k", [3, 9, 21])
def test_distance_matches_jax(inputs, tmp_path, capsys, k, engine):
    jax_engine = "tpu" if engine == "gpu" else engine
    jt, pt = tmp_path / "j.tsv", tmp_path / "p.tsv"
    jo, po = tmp_path / "j.csv", tmp_path / "p.csv"
    jr, gr = both(
        ["distance", "--k", k, "--engine", jax_engine, inputs["fa"], "-o", jo, "--tsv", jt],
        ["distance", "--device", "cpu", "--k", k, "--engine", engine, inputs["fa"], "-o", po,
         "--tsv", pt], capsys)
    # The routes may differ (each package's gates, each with its rates):
    # the bytes may not.
    assert untimed(gr, engine=False) == {**untimed(jr, engine=False), "output": str(po)}
    assert jo.read_bytes() == po.read_bytes() and jt.read_bytes() == pt.read_bytes()


def _stop_after_one_panel(monkeypatch, module):
    """The first call of the module's CSV writer stops after one panel, as
    a killed run would; later calls run to the end."""
    writer = module.stream_panels_to_csv
    calls = []

    def once(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            kw["max_panels"] = 1
        return writer(*a, **kw)

    monkeypatch.setattr(module, "stream_panels_to_csv", once)


@pytest.mark.parametrize("k", [3, 21])
def test_distance_stream_stopped_and_resumed_matches_jax(inputs, tmp_path, capsys,
                                                         monkeypatch, k):
    _stop_after_one_panel(monkeypatch, jax_distance_stream)
    _stop_after_one_panel(monkeypatch, distance_stream)
    reports = {}
    for name, main, dev in (("jax", jax_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        out, ck = tmp_path / f"{name}.csv", tmp_path / f"{name}.json"
        argv = ["distance", *dev, "--k", k, "--stream-panel", 2, "--checkpoint", ck,
                inputs["fa"], "-o", out]
        rc, first, _ = call(main, argv, capsys)
        assert rc == 0 and first["completed"] is False and ck.exists()
        rc, second, _ = call(main, argv, capsys)
        assert rc == 0 and second["resumed"] and second["completed"]
        reports[name] = [untimed(first, engine=False), untimed(second, engine=False)]
        for r in reports[name]:
            r["output"] = None
    assert reports["port"] == reports["jax"]
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    seqs = [r.seq for r in fasta.parse_fasta(str(inputs["fa"]))]
    want = (oracle.distance_matrix_packed(seqs, k) if k <= 8
            else oracle.distance_matrix_packed_sparse(seqs, k))
    assert (tmp_path / "port.csv").read_bytes() == "".join("%f\n" % v for v in want).encode()


# ---------------------------------------------------------------------------
# stream, histo, info, query, merge, selftest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,compact", [(5, "auto"), (21, "host"), (21, "device"), (13, "auto")])
def test_stream_matches_jax(inputs, tmp_path, capsys, k, compact):
    for out in ("s.csv", "s.npz"):
        jr, gr = run_both("stream", tmp_path, capsys, "--k", k, "--compact", compact,
                          "--checkpoint-every", "1K", inputs["fa"], out_name=out)
        assert set(gr["metrics"]) >= {"counters", "phase_seconds", "wall_seconds"}


@pytest.mark.parametrize("argv", [
    ["--k", 5],
    ["--k", 21, "--canonical", "--max-count", 3],
    ["--k", 13, "--engine", "native"],
    ["--k", 7, "--engine", "oracle"],
])
def test_histo_matches_jax(inputs, tmp_path, capsys, argv):
    run_both("histo", tmp_path, capsys, *argv, inputs["fa"], out_name="h.tsv")


def test_info_matches_jax(inputs, tmp_path, capsys):
    for path in ("fa", "fq", "gz"):
        run_both("info", tmp_path, capsys, "-v", inputs[path])
    run_both("info", tmp_path, capsys, "--parser", "no_blank_line", inputs["blank"])


@pytest.fixture
def tables(inputs, tmp_path, capsys):
    """Count tables written by either package: k=21 of both files, k=4
    dense, and a canonical k=21 table."""
    out = {}
    for name, main, dev in (("jax", jax_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        for tag, args in (("a", ["--k", 21, inputs["fa"]]), ("b", ["--k", 21, inputs["fb"]]),
                          ("d", ["--k", 4, inputs["fa"]]),
                          ("c", ["--k", 21, "--canonical", inputs["fa"]])):
            path = tmp_path / f"{name}_{tag}.npz"
            assert call(main, ["count", *dev, *args, "-o", path], capsys)[0] == 0
            out[name, tag] = path
    return out


@pytest.mark.parametrize("op", ["sum", "intersect", "subtract"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_merge_matches_jax_on_either_packages_tables(tables, tmp_path, capsys, op, writer):
    a, b = tables[writer, "a"], tables[writer, "b"]
    for out in ("m.csv", "m.npz"):
        run_both("merge", tmp_path, capsys, "--op", op, a, b, a, out_name=out)
    # k or canonical differ: rc 2 from both
    jr, gr = both(["merge", a, tables[writer, "c"], "-o", tmp_path / "x.npz"],
                  ["merge", a, tables[writer, "c"], "-o", tmp_path / "y.npz"], capsys)
    assert jr is None and gr is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_query_and_histo_read_either_packages_tables(tables, tmp_path, capsys, writer):
    codes = np.load(tables[writer, "a"])["codes"][:3]
    from dna_kmeres_parallel_tpu_torch.utils import codec

    kmers = [codec.code_to_kmer(int(c), 21) for c in codes] + ["A" * 21]
    run_both("query", tmp_path, capsys, tables[writer, "a"], *kmers)
    run_both("query", tmp_path, capsys, tables[writer, "c"], codec.revcomp_str(kmers[0]))
    run_both("query", tmp_path, capsys, tables[writer, "d"], "ACGT", "TTTT")
    assert call(cli.main, ["query", tables[writer, "a"], "ACGN"], capsys)[0] == 2
    run_both("histo", tmp_path, capsys, tables[writer, "a"], tables[writer, "b"],
             out_name="h.tsv")
    run_both("histo", tmp_path, capsys, tables[writer, "d"], out_name="h.tsv")
    jr, gr = both(["histo", tables[writer, "a"], tables[writer, "c"]],
                  ["histo", "--device", "cpu", tables[writer, "a"], tables[writer, "c"]], capsys)
    assert jr is None and gr is None


@pytest.mark.parametrize("k", [3, 8, 21])
def test_selftest_passes(inputs, capsys, k):
    rc, verdict, _ = call(cli.main, ["selftest", "--device", "cpu", "--k", k, inputs["fa"]],
                          capsys)
    assert rc == 0
    assert verdict["counts_equal"] and verdict["native_counts_equal"]
    assert verdict["distances_equal"]


@pytest.mark.parametrize("k", [3, 21])
def test_selftest_fails_when_the_engine_miscounts(inputs, capsys, monkeypatch, k):
    from dna_kmeres_parallel_tpu_torch.ops import histogram_cuda, sparse

    if k <= 8:
        plain = histogram_cuda.hist_packed_small_reference

        def miscount(*a, **kw):
            out = plain(*a, **kw)
            out[0] += 1
            return out

        monkeypatch.setattr(histogram_cuda, "hist_packed_small_reference", miscount)
    else:
        plain = sparse.encode_words_planes

        def drop_one(*a, **kw):
            words = plain(*a, **kw)
            for w in words:
                w[0] = -1  # the first window becomes a sentinel
            return words

        monkeypatch.setattr(sparse, "encode_words_planes", drop_one)
    rc, verdict, _ = call(cli.main, ["selftest", "--device", "cpu", "--k", k, inputs["fa"]],
                          capsys)
    assert rc == 1 and verdict["counts_equal"] is False
    assert verdict["native_counts_equal"] is True


def test_count_csv_formats_any_table_as_the_python_writer(tmp_path):
    # The native table writer against write_count_table_csv's dict route.
    from dna_kmeres_parallel_tpu_torch.utils import codec, io

    rng = np.random.default_rng(7)
    for k in (1, 2, 12, 21, 31):
        codes = np.unique(rng.integers(0, 1 << (2 * k), 3000, dtype=np.uint64))
        counts = rng.integers(1, 10**15, codes.size)
        io.write_count_codes_csv(tmp_path / "a.csv", k, codes, counts)
        io.write_count_table_csv(tmp_path / "b.csv", {
            codec.code_to_kmer(int(c), k): int(n) for c, n in zip(codes, counts)})
        assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes(), k
    assert bytes(native.format_count_lines(np.zeros(0, np.uint64), np.zeros(0, np.int64), 5)) == b""
    with pytest.raises(ValueError):
        native.format_count_lines(np.zeros(1, np.uint64), np.zeros(1, np.int64), 32)
    # every digit count, 0, negatives and the int64 extremes, as %lld
    edge = np.array([0, 1, 9, 10, 99, 100, 10**18, 2**63 - 1, -1, -10, -(2**63)], np.int64)
    codes = np.arange(edge.size, dtype=np.uint64)
    buf = np.empty(64 * edge.size + 7, np.uint8)
    got = bytes(native.format_count_lines(codes, edge, 3, buf))
    assert got == "".join("%s,%d\n" % (codec.code_to_kmer(int(c), 3), n)
                          for c, n in zip(codes, edge)).encode()
    with pytest.raises(ValueError, match="out"):
        native.format_count_lines(codes, edge, 3, np.empty(64, np.uint8))


def test_module_runs_as_a_script(inputs, tmp_path):
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "dna_kmeres_parallel_tpu_torch.cli", "info", str(inputs["fa"])],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["n_seqs"] == len(fasta.parse_fasta(str(inputs["fa"])))
