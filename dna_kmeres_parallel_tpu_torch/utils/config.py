"""Runtime configuration of the port's engines.

The fields are those of the JAX package's ``KmerConfig`` that the port
reads; routes the port does not have raise where they are asked for.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

_COMPACT_MODES = ("auto", "device", "host", "device-rle", "device-super")


@dataclass(frozen=True)
class KmerConfig:
    """Configuration of counting and distance runs.

    Attributes:
      k: k-mer length, 1..31.
      canonical: fold each k-mer with its reverse complement
         (min(code, revcomp(code))).
      max_seqs: optional cap on the records read from a file.
      batch_bases: bases per device batch of the counters (inputs shorter
         than one batch use a power-of-two batch).
      dense_bins_limit: largest 4^k counted as a dense histogram; above it
         the sparse (sorted-table) counter applies.
      parser_variant: "modern" | "blank_line" | "no_blank_line" (the
         reference's record splitting, see utils/fasta.py).
      pack_input: dense counter: ship each batch 2-bit packed (0.5 B per
         base: the encoder's u32 planes for k = 4..8, counted by K5; the
         packed bytes and validity bits for k <= 3, unpacked on the
         device) instead of 1 B per base (K6, K7).
      sort_row_len: sparse counter with ``device_sort=True``: sort each
         batch's window words as independent rows of this length (the
         host's native row compactor merges the rows); 0 sorts them as one
         flat array.
      device_sort: sparse counter: whether the device sorts the window
         words. None (the default): in the one-shot engine
         (``SparseKmerEngine``, ``count_file``) the card builds the call's
         table where it fits (one sort and run-length of the call's
         windows on the card, ``sparse_engine.card_table_fits``),
         elsewhere (a CPU device, a call too large for the card's free
         memory) as False; the streaming counter takes it as False.
         False: no device sort, the native radix compactor builds each
         batch's table from unsorted words and the host merges them.
         True: the device sorts each batch (``sort_row_len``) and the host
         compacts sorted words.
      compact: streaming sparse counter (``models/pipeline.py``): where
         every batch's table is built, fixed for the run. "auto" and
         "device" (encode on the card, words to the host, radix compaction
         there, or with ``device_sort=True`` the compactor of sorted
         words), "host" (the native engine counts the host-resident
         stream; nothing crosses the link), "device-rle" (the card sorts
         each batch and collapses its runs; only the distinct (code,
         count) pairs come back) and "device-super" (the card cuts each
         batch into super-k-mer records; the host expands and counts
         them). A mesh refuses "device-rle" and "device-super". The
         one-shot engines ignore it, as the JAX package's do.
      mesh_shape: a mesh of the product of these shards on the run's
         device (``parallel/mesh.LocalMesh``): the streaming counter runs
         each batch data parallel over it, and the dense and sparse
         distance panels are partner-sharded; () or a product of 1 is
         one device.
    """

    k: int = 3
    canonical: bool = False
    max_seqs: int | None = None
    batch_bases: int = 1 << 24
    dense_bins_limit: int = 1 << 24
    parser_variant: str = "modern"
    pack_input: bool = True
    sort_row_len: int = 2048
    device_sort: bool | None = None
    compact: str = "auto"
    mesh_shape: tuple[int, ...] = ()

    def __post_init__(self):
        if not (1 <= self.k <= 31):
            raise ValueError(f"k must be in [1, 31], got {self.k}")
        if self.parser_variant not in ("modern", "blank_line", "no_blank_line"):
            raise ValueError(f"bad parser_variant {self.parser_variant!r}")
        if self.compact == "device-super" and self.k < 9:
            # compact modes serve the streamed sparse path (k >= 9); a
            # dense k <= 8 run would ignore the setting silently.
            raise ValueError(
                f"compact='device-super' serves the sparse stream "
                f"(k >= 9), got k={self.k}"
            )
        if self.compact not in _COMPACT_MODES:
            raise ValueError(f"bad compact {self.compact!r}")
        if self.sort_row_len < 0:
            raise ValueError(f"sort_row_len must be >= 0, got {self.sort_row_len}")

    @property
    def bins(self) -> int:
        return 1 << (2 * self.k)

    @property
    def dense(self) -> bool:
        """Whether the dense histogram representation applies."""
        return self.bins <= self.dense_bins_limit

    def replace(self, **kw) -> "KmerConfig":
        return dataclasses.replace(self, **kw)
