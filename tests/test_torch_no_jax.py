"""The port runs without JAX and without the JAX package: it imports
neither, keeping its own copies of the host code it needs."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dna_kmeres_parallel_tpu_torch as port
from dna_kmeres_parallel_tpu.models import oracle

PKG = Path(port.__file__).resolve().parent
REPO = PKG.parent

_NO_JAX_RUN = r"""
import json
import sys

class RefuseJax:
    # Refuse jax, jaxlib and the JAX package (not the port, whose name
    # only begins like it).
    def find_spec(self, name, path=None, target=None):
        if (
            name == "jax"
            or name.startswith(("jax.", "jaxlib"))
            or name == "dna_kmeres_parallel_tpu"
            or name.startswith("dna_kmeres_parallel_tpu.")
        ):
            raise ImportError(f"import refused: {name}")
        return None

sys.meta_path.insert(0, RefuseJax())

import dna_kmeres_parallel_tpu_torch as port
from dna_kmeres_parallel_tpu_torch.utils import io

seqs = json.loads(sys.argv[1])
res = port.count_sequences(seqs, k=21, device="cpu")
dense = {
    str(k): port.count_sequences(seqs, k=k, device="cpu", pack_input=pack).table()
    for k, pack in ((2, True), (3, False), (5, True), (6, False), (9, True))
}
dist = port.distance_sequences(seqs, k=3, device="cpu")
io.write_distances_csv(sys.argv[2], dist.packed)

# The streaming counter (its metrics, trace and checkpoint) and K9's
# plain version, through pack_input=False.
from dna_kmeres_parallel_tpu_torch.models.pipeline import StreamingCounter

fasta_path, ckpt, trace_dir = sys.argv[3:6]
streamed = {}
for k, kw in ((5, {}), (21, {"pack_input": False, "compact": "device"}),
              (21, {"compact": "host"}), (21, {"compact": "auto"})):
    sc = StreamingCounter(port.KmerConfig(k=k, batch_bases=128, **kw), device="cpu",
                          checkpoint_path=ckpt, trace_dir=trace_dir)
    streamed[f"{k} {sorted(kw.items())}"] = sc.run(fasta_path).table()
    assert sc.metrics.counters["checkpoints"] >= 1
    json.loads(sc.metrics.json())
# The bucketed exchange on a local mesh of 4 CPU shards: the raw exchange
# with minimizer owners (K1m's, K10's and P1's plain versions), then the
# aggregated and super-k-mer exchanges.
from dna_kmeres_parallel_tpu_torch.parallel import bucketed
from dna_kmeres_parallel_tpu_torch.parallel.mesh import LocalMesh
from dna_kmeres_parallel_tpu_torch.utils import codec

flat = codec.concat_with_sentinels(seqs)
bucket = {}
for name, kw in (("raw", {"owner_mode": "minimizer", "exchange": "raw"}),
                 ("agg", {"exchange": "agg"}), ("super", {"exchange": "super"})):
    codes, counts = bucketed.count_bucket_auto(flat, 21, False, LocalMesh(4, "cpu"), **kw)
    bucket[name] = {codec.code_to_kmer(int(c), 21): int(n) for c, n in zip(codes, counts)}
# The device-sort route: rows through K11's plain version (k=13 with
# pallas_sort), rows and one flat sort through torch.sort (k=21), and the
# streamed device-rle arm.
from dna_kmeres_parallel_tpu_torch.models.sparse_engine import SparseKmerEngine

device_sort = {}
for name, k, kw, pallas_sort in (("k13 rows K11", 13, {"sort_row_len": 128}, True),
                                 ("k21 rows", 21, {}, False),
                                 ("k21 flat", 21, {"sort_row_len": 0}, False)):
    cfg = port.KmerConfig(k=k, batch_bases=128, device_sort=True, **kw)
    eng = SparseKmerEngine(cfg, device="cpu", pallas_sort=pallas_sort)
    device_sort[name] = eng.count_sequences(seqs).table()
sc = StreamingCounter(port.KmerConfig(k=21, batch_bases=128, compact="device-rle"),
                      device="cpu")
device_sort["k21 rle"] = sc.run(fasta_path).table()
# Distances past the dense band: the sparse tables at k=21 on the host
# route and the union route (K3's and K4's plain versions), streamed, and
# the dense engine at k=9 (K2's plain version above 65,536 bins).
from dna_kmeres_parallel_tpu_torch.models import sparse_engine
from dna_kmeres_parallel_tpu_torch.models.engine import KmerEngine

sparse = {}
for union in ("off", "on"):
    packed = sparse_engine.distance_sparse_packed(seqs, 21, device="cpu", union=union)
    sparse[union] = packed.view("u4").tolist()
    out = sys.argv[2] + f".{union}.csv"
    sparse_engine.distance_sparse_stream_to_csv(seqs, 21, out, panel_rows=1, device="cpu",
                                                union=union)
    sparse[union + " csv"] = open(out, "rb").read().decode()
sparse["k9"] = KmerEngine(port.KmerConfig(k=9), device="cpu").distance_sequences(
    seqs).packed.view("u4").tolist()
# The threshold route forced on (its plain version): the dense engine,
# the union route, and the JAX package's public helpers' counterparts.
thr = KmerEngine(port.KmerConfig(k=3), device="cpu", threshold="on", threshold_cap=256
                 ).distance_sequences(seqs)
assert thr.route == "threshold"
sparse["threshold3"] = thr.packed.view("u4").tolist()
sparse["threshold21"] = sparse_engine.distance_sparse_packed(
    seqs, 21, device="cpu", union="on", threshold="on").view("u4").tolist()
import numpy as np
import torch

from dna_kmeres_parallel_tpu_torch import native
from dna_kmeres_parallel_tpu_torch.ops import distance as dist_ops, encode
from dna_kmeres_parallel_tpu_torch.utils import triangular

packed, mask, n = codec.pack_bases(flat)
assert (codec.unpack_bases(packed, mask, n) == flat).all()
assert (native.unpack_2bit_native(packed, mask, n) == flat).all()
assert (encode.unpack_2bit(torch.from_numpy(packed)).numpy()[:n] == np.where(flat < 4, flat, 0)
        ).all()
sparse["dense3"] = native.count_dense_native(flat, 3).tolist()
dist_ops.distance_matrix_square(
    torch.from_numpy(np.stack([codec.encode_bases("ACGTACGT")] * 2).astype(np.int32) % 4),
    [8, 8], 1)
assert triangular.square_to_packed(triangular.packed_to_square(np.arange(3), 3)).tolist() == [
    0, 1, 2]
# The data-parallel layer on a local mesh of 4 CPU shards: the streaming
# counter's dense and sparse mesh arms, its super-k-mer route, the
# partner-sharded distances of both engines, and the port's dry run.
from dna_kmeres_parallel_tpu_torch import graft_entry
from dna_kmeres_parallel_tpu_torch.parallel import sharded_count, sharded_sparse

meshed = {}
for name, k, kw in (("dense5", 5, {"mesh_shape": (4,)}), ("sparse21", 21, {"mesh_shape": (4,)}),
                    ("super21", 21, {"compact": "device-super"})):
    sc = StreamingCounter(port.KmerConfig(k=k, batch_bases=128, **kw), device="cpu")
    meshed[name] = sc.run(fasta_path).table()
mesh4 = LocalMesh(4, "cpu")
hist = sharded_count.count_sharded(sharded_count.shard_stream(flat, mesh4), 3, 64, False, mesh4)
meshed["count_sharded3"] = hist.tolist()
codes, counts = sharded_sparse.count_sparse_sharded(flat, 21, False, mesh4, row_len=64)
meshed["sparse_sharded21"] = {codec.code_to_kmer(int(c), 21): int(n) for c, n in zip(codes, counts)}
meshed["distance3"] = KmerEngine(port.KmerConfig(k=3, mesh_shape=(4,)), device="cpu"
                                 ).distance_sequences(seqs).packed.view("u4").tolist()
out = sys.argv[2] + ".mesh.csv"
sparse_engine.distance_sparse_stream_to_csv(seqs, 21, out, panel_rows=1, device="cpu",
                                            union="on", mesh=mesh4)
meshed["sparse csv"] = open(out, "rb").read().decode()
graft_entry.dryrun_multichip(4, device="cpu")
# The multi-host layer in one process: byte ranges, the dense and bucketed
# counts on a local mesh, the row-sharded distances with their stitch.
from dna_kmeres_parallel_tpu_torch.parallel import multihost

hist, _, _ = multihost.count_file_multihost(fasta_path, port.KmerConfig(k=3), mesh4)
meshed["multihost3"] = hist.tolist()
codes, counts, *_ = multihost.count_file_bucketed_multihost_resumable(
    fasta_path, port.KmerConfig(k=21), LocalMesh(2, "cpu"), batch_bases=128,
    owner_mode="minimizer")
meshed["multihost21"] = {codec.code_to_kmer(int(c), 21): int(n) for c, n in zip(codes, counts)}
out = sys.argv[2] + ".multihost.csv"
multihost.distance_file_multihost_resumable(fasta_path, port.KmerConfig(k=3), out, device="cpu")
meshed["multihost csv"] = open(out, "rb").read().decode()
banned = [
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "dna_kmeres_parallel_tpu")
]
assert not banned, banned
print(json.dumps({"table": res.table(), "dense": dense, "streamed": streamed,
                  "bucket": bucket, "device_sort": device_sort, "sparse": sparse,
                  "meshed": meshed, "bits": dist.packed.view("u4").tolist()}))
"""

SEQS = ["ACGTTGCANNACGTACGTTTTTTTTTTTTTTTTTTTTTTTTGCA" * 7, "GATTACA" * 40, "ACGTAC"]


def test_port_runs_with_jax_refused(tmp_path):
    # jax and the JAX package are both refused in the subprocess.
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    csv = tmp_path / "d.csv"
    fasta_path = tmp_path / "in.fasta"
    fasta_path.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(SEQS)))
    args = [str(csv), str(fasta_path), str(tmp_path / "c.npz"), str(tmp_path / "trace")]
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN, json.dumps(SEQS), *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["table"] == oracle.count_table_any_k(SEQS, 21)
    for k, table in out["dense"].items():
        assert table == oracle.count_table_any_k(SEQS, int(k)), k
    assert len(out["streamed"]) == 4
    for key, table in out["streamed"].items():
        assert table == oracle.count_table_any_k(SEQS, int(key.split()[0])), key
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert len(out["bucket"]) == 3
    for name, table in out["bucket"].items():
        assert table == oracle.count_table_any_k(SEQS, 21), name
    assert len(out["device_sort"]) == 4
    for name, table in out["device_sort"].items():
        assert table == oracle.count_table_any_k(SEQS, int(name[1:3])), name
    want = oracle.distance_matrix_packed(SEQS, 3)
    assert out["bits"] == want.view(np.uint32).tolist()
    assert csv.read_bytes() == "".join("%f\n" % v for v in want).encode()
    sparse = oracle.distance_matrix_packed_sparse(SEQS, 21)
    text = "".join("%f\n" % v for v in sparse)
    for union in ("off", "on"):
        assert out["sparse"][union] == sparse.view(np.uint32).tolist(), union
        assert out["sparse"][union + " csv"] == text, union
    assert out["sparse"]["k9"] == oracle.distance_matrix_packed(SEQS, 9).view(np.uint32).tolist()
    assert out["sparse"]["threshold3"] == want.view(np.uint32).tolist()
    assert out["sparse"]["threshold21"] == sparse.view(np.uint32).tolist()
    assert out["sparse"]["dense3"] == sum(oracle.count_vector(s, 3) for s in SEQS).tolist()
    meshed = out["meshed"]
    assert meshed["dense5"] == oracle.count_table_any_k(SEQS, 5)
    for name in ("sparse21", "super21", "sparse_sharded21"):
        assert meshed[name] == oracle.count_table_any_k(SEQS, 21), name
    flat_hist = sum(oracle.count_vector(s, 3) for s in SEQS)
    assert meshed["count_sharded3"] == flat_hist.tolist()
    assert meshed["distance3"] == want.view(np.uint32).tolist()
    assert meshed["sparse csv"] == text
    assert meshed["multihost3"] == flat_hist.tolist()
    assert meshed["multihost21"] == oracle.count_table_any_k(SEQS, 21)
    assert meshed["multihost csv"] == "".join("%f\n" % v for v in want)


_NO_JAX_CLI = r"""
import contextlib
import io as _io
import json
import sys

class RefuseJax:
    def find_spec(self, name, path=None, target=None):
        if (
            name == "jax"
            or name.startswith(("jax.", "jaxlib"))
            or name == "dna_kmeres_parallel_tpu"
            or name.startswith("dna_kmeres_parallel_tpu.")
        ):
            raise ImportError(f"import refused: {name}")
        return None

sys.meta_path.insert(0, RefuseJax())

from dna_kmeres_parallel_tpu_torch import cli
from dna_kmeres_parallel_tpu_torch.models import benchmarks, oracle
from dna_kmeres_parallel_tpu_torch.utils import datagen, fasta

work = sys.argv[1]
datagen.random_fasta(work + "/in.fasta", 5, (200, 400), seed=3, invalid_frac=0.01)
datagen.realistic_fasta(work + "/reads.fasta", genome_len=2000, coverage=2.0, seed=3)
out = {}
for name, argv in (
    ("count21", ["count", "--k", "21", "in.fasta", "-o", "t21.csv"]),
    ("count4", ["count", "--k", "4", "in.fasta", "-o", "t4.npz"]),
    ("distance3", ["distance", "--k", "3", "in.fasta", "-o", "d3.csv"]),
    ("distance21", ["distance", "--k", "21", "reads.fasta", "-o", "d21.csv"]),
    ("selftest3", ["selftest", "--k", "3", "in.fasta"]),
    ("selftest21", ["selftest", "--k", "21", "in.fasta"]),
    ("calibrate", ["calibrate", "--link-only"]),
):
    argv = [a if not a.endswith((".fasta", ".csv", ".npz")) else work + "/" + a for a in argv]
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv[:1] + ["--device", "cpu"] + argv[1:])
    out[name] = [rc, json.loads(buf.getvalue().strip().splitlines()[-1])]
seqs = [r.seq for r in fasta.parse_fasta(work + "/in.fasta")]
out["oracle21"] = len(oracle.count_table_any_k(seqs, 21))
out["bench"] = benchmarks.run_sparse_bench(k=21, total_bases=4096, batch_bases=2048,
                                           device="cpu")["windows_counted"]
banned = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dna_kmeres_parallel_tpu")]
assert not banned, banned
print(json.dumps(out))
"""


def test_cli_runs_with_jax_refused(tmp_path):
    # kmer-gpu's count, distance, selftest and calibrate, the oracle, the
    # data generator and the benchmarks, with jax and the JAX package
    # refused; the outputs against the JAX package's oracle here.
    from dna_kmeres_parallel_tpu.utils import fasta as jax_fasta

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    env["KMER_GPU_CAL_DIR"] = str(tmp_path / "cal")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_CLI, str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(v[0] == 0 for v in out.values() if isinstance(v, list))
    seqs = [r.seq for r in jax_fasta.parse_fasta(str(tmp_path / "in.fasta"))]
    table = oracle.count_table_any_k(seqs, 21)
    assert out["oracle21"] == len(table) == out["count21"][1]["distinct_kmers"]
    lines = (tmp_path / "t21.csv").read_text().splitlines()
    assert lines[0] == "kmer,count" and len(lines) == len(table) + 1
    assert (tmp_path / "d3.csv").read_bytes() == "".join(
        "%f\n" % v for v in oracle.distance_matrix_packed(seqs, 3)).encode()
    reads = [r.seq for r in jax_fasta.parse_fasta(str(tmp_path / "reads.fasta"))]
    assert (tmp_path / "d21.csv").read_bytes() == "".join(
        "%f\n" % v for v in oracle.distance_matrix_packed_sparse(reads, 21)).encode()
    for name in ("selftest3", "selftest21"):
        assert out[name][1]["counts_equal"] and out[name][1]["distances_equal"]
    assert out["calibrate"][1]["calibration_file"].startswith(str(tmp_path / "cal"))
    assert out["bench"] == 2 * (2048 - 20)


#: an import of jax, or any mention of the JAX package as a module
#: (``dna_kmeres_parallel_tpu`` followed by a dot, a space or a quote)
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+jax(?:lib)?\b"
    r"|^\s*(?:import|from)\s+dna_kmeres_parallel_tpu\b"
    r"|dna_kmeres_parallel_tpu[. \"']",
    re.M,
)


@pytest.mark.parametrize(
    "src",
    sorted(
        p.relative_to(REPO).as_posix()
        for p in [*PKG.rglob("*.py"), *PKG.rglob("*.cpp"), *PKG.rglob("*.cu")]
    ),
)
def test_source_imports_nothing_of_jax(src):
    text = (REPO / src).read_text()
    assert not _FORBIDDEN.findall(text), src


def test_forbidden_pattern_catches_the_jax_package():
    for line in (
        "import jax",
        "from jax import numpy",
        "from dna_kmeres_parallel_tpu.utils import codec",
        "import dna_kmeres_parallel_tpu",
        "from dna_kmeres_parallel_tpu import native",
        'importlib.import_module("dna_kmeres_parallel_tpu.native")',
    ):
        assert _FORBIDDEN.search(line), line
    for line in (
        "from dna_kmeres_parallel_tpu_torch.utils import codec",
        "import dna_kmeres_parallel_tpu_torch as port",
        "# replaces dna_kmeres_parallel_tpu/ops/distance_pallas.py",
    ):
        assert not _FORBIDDEN.search(line), line


def test_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.count_sequences(["ACGT" * 10], k=21, device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        port.count_sequences(["ACGT" * 10], k=21, device="meta")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.distance_sequences(["ACGT" * 10], k=3, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.count_sequences(["ACGT" * 10], k=6, device="cuda")
