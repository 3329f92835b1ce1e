"""Meshes: where the shards of a sharded program run, and how they talk.

The counterpart of ``dna_kmeres_parallel_tpu/parallel/mesh.py``'s
``make_mesh``. The JAX package runs one program per device under
``shard_map``, with XLA collectives over the chips' links. The port writes
each shard's program once, as a function of the shard index that returns
the shard's send buffers ([D, cap] per plane, row d bound for shard d) and
its overflow flag, and a mesh runs it:

- ``LocalMesh``: D shards on one device, in one process. The shards run in
  turn, and the all_to_all is the transpose of the stacked [D_src, D_dst,
  cap] send buffers, written straight into the [D_dst, D_src, cap] receive
  buffer as each shard finishes, so only one shard's buffers and
  temporaries exist beside it. It is what the CPU tests run at D = 8, as
  the JAX tests run on 8 virtual devices, and what one card runs at
  D = 4 or 5.
- ``ProcessGroupMesh``: one shard per rank of a ``torch.distributed``
  process group (NCCL on cards, gloo on the CPU), the all_to_all an
  ``all_to_all_single`` and the overflow flag an ``all_reduce(MAX)``.
  A gloo group whose shards run on a card (several ranks sharing one
  card, where NCCL refuses a second rank) moves each collective's
  operand through host memory: gloo has no all_to_all and no all_gather
  of CUDA tensors. The kernels' inputs and outputs stay on the card.

Every mesh has ``size`` (D), ``device``, ``local_shards`` (the shard
indices this process runs), ``exchange`` (run the shard program, all_to_all
its planes), ``max_reduce`` (the overflow flags, over every shard) and
``gather`` (one object per local shard -> every shard's, in shard order),
and the collectives that ``shard_map`` gives the JAX package's
data-parallel programs (``parallel/sharded_count``,
``parallel/sharded_sparse``):

- ``run``: map the shard program over the local shards, no exchange;
- ``sum_reduce``: the integer ``psum`` of the shards' histograms into a
  caller's int32 accumulator;
- ``all_gather``: the rows of every shard, in shard order;
- ``halo``: each shard receives the next shard's head (a ``ppermute`` to
  the left neighbour); the last shard receives INVALID bases.

A sharded operand is given as the rows of the local shards, stacked: on a
``LocalMesh`` the whole operand, on a ``ProcessGroupMesh`` the rank's
block.
"""

from __future__ import annotations

import torch

from dna_kmeres_parallel_tpu_torch.ops import runtime
from dna_kmeres_parallel_tpu_torch.ops.encode import INVALID


class LocalMesh:
    """D shards on one device in one process."""

    def __init__(self, size: int, device: str | torch.device = "cuda"):
        if size < 1:
            raise ValueError(f"a mesh needs at least one shard, got {size}")
        self.size = size
        self.device = runtime.resolve_device(device)

    @property
    def local_shards(self) -> list[int]:
        return list(range(self.size))

    def exchange(self, shard_fn) -> tuple[tuple[torch.Tensor, ...], list[torch.Tensor]]:
        """Run ``shard_fn(s) -> (planes, overflow)`` for every shard, each
        plane [D, cap] with row d bound for shard d. Returns the received
        planes, each [D, D*cap] (row d: what shard d received, source s at
        columns [s*cap, (s+1)*cap)), and the shards' overflow flags."""
        D = self.size
        recv: list[torch.Tensor] = []
        flags = []
        for s in range(D):
            planes, overflow = shard_fn(s)
            if not recv:
                recv = [
                    torch.empty((D, D) + p.shape[1:], dtype=p.dtype, device=p.device)
                    for p in planes
                ]
            for r, p in zip(recv, planes, strict=True):
                r[:, s] = p
            flags.append(overflow)
            del planes
        return tuple(r.reshape(D, -1) for r in recv), flags

    def max_reduce(self, flags) -> bool:
        """Whether any shard's flag is set."""
        return bool(torch.stack([torch.as_tensor(f) for f in flags]).any())

    def gather(self, items: list) -> list:
        return list(items)

    def run(self, shard_fn) -> list:
        """``[shard_fn(s) for s in local_shards]``: each shard's result."""
        return [shard_fn(s) for s in range(self.size)]

    def sum_reduce(self, shard_fn, acc: torch.Tensor) -> torch.Tensor:
        """``shard_fn(s, acc)`` adds shard s's partial histogram into the
        int32 accumulator ``acc``; every shard adds into the same one, so
        the sum costs no collective. Returns ``acc``."""
        for s in range(self.size):
            shard_fn(s, acc)
        return acc

    def all_gather(self, local: torch.Tensor) -> torch.Tensor:
        """The rows of every shard: here the local rows are all of them."""
        return local

    def halo(self, heads: torch.Tensor) -> torch.Tensor:
        """heads: [D, n], row s the first n bases of shard s. Returns [D, n]:
        row s is shard s+1's head, the last row INVALID."""
        return torch.cat([heads[1:], torch.full_like(heads[:1], INVALID)])

    def __repr__(self) -> str:
        return f"LocalMesh(size={self.size}, device={str(self.device)!r})"


class ProcessGroupMesh:
    """One shard per rank of a ``torch.distributed`` process group: shard
    index = rank. The group must exist (``init_process_group``); its
    backend must serve ``device`` (NCCL for a card, gloo for the CPU)."""

    def __init__(self, device: str | torch.device = "cuda", group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupMesh needs an initialized process group")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = runtime.resolve_device(device)
        #: gloo on a card: every collective's operand goes through the host
        self.via_host = self.device.type == "cuda" and dist.get_backend(group) == "gloo"

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """A collective's operand as the backend takes it."""
        return t.cpu() if self.via_host else t

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        """A collective's result on the mesh's device."""
        return t.to(self.device) if self.via_host else t

    @property
    def local_shards(self) -> list[int]:
        return [self.rank]

    def exchange(self, shard_fn) -> tuple[tuple[torch.Tensor, ...], list[torch.Tensor]]:
        """Run ``shard_fn(rank)``, then one ``all_to_all_single`` per plane
        (each sent as bytes, so any dtype crosses any backend). Returns the
        received planes, each [1, D*cap], and this shard's flag."""
        import torch.distributed as dist

        planes, overflow = shard_fn(self.rank)
        recv = []
        for p in planes:
            p = self._wire(p.contiguous())
            out = torch.empty_like(p)
            dist.all_to_all_single(
                out.view(torch.uint8), p.view(torch.uint8), group=self.group
            )
            recv.append(self._back(out).reshape(1, -1))
        return tuple(recv), [overflow]

    def max_reduce(self, flags) -> bool:
        import torch.distributed as dist

        flag = torch.stack([torch.as_tensor(f) for f in flags]).any().to(torch.int32)
        flag = self._wire(flag.reshape(1).to(self.device))
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        return bool(flag.item())

    def gather(self, items: list) -> list:
        import torch.distributed as dist

        out: list = [None] * self.size
        dist.all_gather_object(out, items[0], group=self.group)
        return out

    def run(self, shard_fn) -> list:
        return [shard_fn(self.rank)]

    def sum_reduce(self, shard_fn, acc: torch.Tensor) -> torch.Tensor:
        """``shard_fn(rank, part)`` adds this rank's partial histogram into
        a zeroed ``part``; one ``all_reduce(SUM)`` of ``part``, then ``acc +=
        part``. The running accumulator itself is never summed: over D
        ranks that would count it D times."""
        import torch.distributed as dist

        part = torch.zeros_like(acc)
        shard_fn(self.rank, part)
        part = self._wire(part)
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=self.group)
        acc += self._back(part)
        return acc

    def all_gather(self, local: torch.Tensor) -> torch.Tensor:
        """This rank's rows -> every rank's, in rank order
        (``all_gather_into_tensor``; every rank holds as many rows)."""
        import torch.distributed as dist

        local = self._wire(local.contiguous())
        out = local.new_empty((self.size * local.shape[0], *local.shape[1:]))
        dist.all_gather_into_tensor(out, local, group=self.group)
        return self._back(out)

    def halo(self, heads: torch.Tensor) -> torch.Tensor:
        """heads: [1, n], this rank's first n bases. One ``all_gather`` of
        the D heads (gloo and NCCL alike); returns [1, n], the next rank's
        head, or INVALID bases on the last rank."""
        every = self.all_gather(heads)
        if self.rank == self.size - 1:
            return torch.full_like(heads, INVALID)
        return every[self.rank + 1 : self.rank + 2]

    def __repr__(self) -> str:
        return f"ProcessGroupMesh(size={self.size}, rank={self.rank}, device={str(self.device)!r})"


def make_mesh(n_devices: int | None = None, device: str | torch.device = "cuda"):
    """A mesh of ``n_devices`` shards: a ``LocalMesh`` on ``device`` (one
    card, or the CPU), or, with ``n_devices=None`` inside an initialized
    process group, a ``ProcessGroupMesh`` over its ranks."""
    if n_devices is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return ProcessGroupMesh(device)
        n_devices = 1
    return LocalMesh(n_devices, device)
