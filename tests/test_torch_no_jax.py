"""The port runs without JAX: it imports none of it, and none of the JAX
package's modules that import it."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dna_kmeres_parallel_tpu_torch as port

PKG = Path(port.__file__).resolve().parent
REPO = PKG.parent

_NO_JAX_RUN = r"""
import sys

class RefuseJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError(f"jax import refused: {name}")
        return None

sys.meta_path.insert(0, RefuseJax())

import dna_kmeres_parallel_tpu_torch as port
from dna_kmeres_parallel_tpu.models import oracle

seqs = ["ACGTTGCANNACGTACGTTTTTTTTTTTTTTTTTTTTTTTTGCA" * 7, "GATTACA" * 40]
res = port.count_sequences(seqs, k=21, device="cpu")
assert res.table() == oracle.count_table_any_k(seqs, 21), "table mismatch"
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
print("NO_JAX_OK", res.distinct_kmers)
"""


def test_port_runs_with_jax_refused():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import jax|from jax)"
    r"|dna_kmeres_parallel_tpu\.(ops|parallel|models\.engine|models\.sparse_engine)\b"
    r"|from dna_kmeres_parallel_tpu(\.models)? import .*\b(ops|parallel|engine|sparse_engine)\b",
    re.M,
)


@pytest.mark.parametrize(
    "src", sorted(p.relative_to(REPO).as_posix() for p in PKG.rglob("*.py"))
)
def test_source_imports_nothing_of_jax(src):
    text = (REPO / src).read_text()
    assert not _FORBIDDEN.findall(text), src


def test_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.count_sequences(["ACGT" * 10], k=21, device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        port.count_sequences(["ACGT" * 10], k=21, device="meta")
