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
banned = [
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "dna_kmeres_parallel_tpu")
]
assert not banned, banned
print(json.dumps({"table": res.table(), "dense": dense, "streamed": streamed,
                  "bucket": bucket, "device_sort": device_sort,
                  "bits": dist.packed.view("u4").tolist()}))
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
