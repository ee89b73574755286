"""Process groups and the helpers the sharded paths share.

Port of ``posendf_tpu/parallel/mesh.py``. The JAX package runs one program
over a ``jax.sharding.Mesh`` of devices; the port follows PyTorch's idiom
instead: one process a device, a ``torch.distributed`` process group, and
the collectives written out where the JAX package lets XLA insert them.

  * :func:`init_distributed` creates the group from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) or from explicit arguments: ``nccl`` for the card,
    ``gloo`` for the CPU;
  * :func:`make_mesh` returns a :class:`Mesh` (group, rank, size, axis
    name, device). Without a group its size is 1 and every helper below is
    the identity;
  * :func:`shard_batch` takes this rank's contiguous rows of each leading
    dimension, :func:`replicated` broadcasts tensors from rank 0,
    :func:`all_reduce_sum` / :func:`all_reduce_mean` reduce a flat buffer,
    :func:`gather_rows` all-gathers rows back in rank order,
    :func:`sum_across` is an all-reduce sum that autograd passes through
    (every rank holds the same loss of the reduced value).

``gloo`` reads and writes the memory of a tensor as host memory, so on a
group of ``gloo`` ranks that hold CUDA tensors (two ranks on one card,
which NCCL refuses) every operation stages its tensors through the host.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "init_distributed", "make_mesh", "shard_rows", "shard_batch", "replicated",
           "all_reduce_sum", "all_reduce_mean", "gather_rows", "sum_across", "barrier",
           "broadcast_object"]

_BOUND: Dict[str, torch.device] = {}   # the device init_distributed bound this process to

_ENV = ("RANK", "WORLD_SIZE")


@dataclass(frozen=True)
class Mesh:
    """A one-axis mesh of processes: ``size`` ranks, this process ``rank``
    on ``device``. ``group`` is None for the one-process mesh."""

    group: Optional[object]
    rank: int
    size: int
    axis: str
    device: torch.device
    backend: Optional[str] = None

    @property
    def staged(self) -> bool:
        """Whether collectives stage CUDA tensors through the host (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def init_distributed(*, backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     device: Optional[str] = None, timeout_s: Optional[float] = None) -> int:
    """Create the default process group; returns this process's rank.

    The group comes from the arguments (``init_method`` such as
    ``tcp://localhost:29500`` or ``file:///path``, ``world_size``, ``rank``)
    or, when they are absent, from ``torchrun``'s environment. With neither
    it returns 0 and creates no group (one process). Idempotent: a second
    call returns the rank of the group that exists.

    ``device``: ``"cuda"`` (the default) binds this process to
    ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` from the environment, else the
    rank, modulo the cards there are) and takes ``nccl``; ``"cpu"`` takes
    ``gloo``.
    ``backend`` overrides the choice (``gloo`` with ``cuda``: several ranks
    on one card).

    A failed initialization re-raises whenever a distributed setup was
    asked for, by the arguments or by the environment: a process that
    quietly trains alone would train the whole data and race the others on
    the checkpoint paths.
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    explicit = init_method is not None or world_size is not None or rank is not None
    if not explicit and not all(k in os.environ for k in _ENV):
        return 0
    dev_type = torch.device(device or "cuda").type
    local_rank = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') asked for, but "
                               "torch.cuda.is_available() is false; pass device='cpu'")
        bound = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(bound)
    else:
        bound = torch.device("cpu")
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if explicit:
        kw.update(init_method=init_method or "env://", world_size=world_size, rank=rank)
    dist.init_process_group(backend=backend, **kw)
    _BOUND["device"] = bound
    return dist.get_rank()


def make_mesh(axes: Tuple[str, ...] = ("data",), device=None) -> Mesh:
    """The mesh over every rank of the default group, along ``axes[0]``
    (one axis: the port shards batches, queries or frames, one at a time).

    ``device``: where this rank's tensors live; by default the device
    :func:`init_distributed` bound, and the card without a group.
    """
    if len(axes) != 1:
        raise ValueError(f"the port's mesh has one axis, got {axes!r}")
    from posendf_torch.field import resolve_device

    if dist.is_available() and dist.is_initialized():
        dev = resolve_device(device if device is not None else
                             _BOUND.get("device", "cuda"))
        if dev.type == "cuda" and dev.index is None:   # the card this rank is bound to
            dev = _BOUND.get("device", torch.device("cuda", torch.cuda.current_device()))
        return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), axes[0], dev,
                    dist.get_backend())
    return Mesh(None, 0, 1, axes[0], resolve_device(device if device is not None else "cuda"))


def _grouped(mesh: Optional[Mesh]) -> bool:
    # a group of one rank still runs its collectives (NCCL's copy of one
    # rank's buffer is exact), so the sharded path is the path that ran
    return mesh is not None and mesh.group is not None


def shard_rows(mesh: Optional[Mesh], n: int, even: bool = False) -> slice:
    """This rank's contiguous rows of ``n``: the first ``n % size`` ranks
    take one row more. ``even``: raise unless ``size`` divides ``n``."""
    if mesh is None or mesh.size == 1:
        return slice(0, n)
    if even and n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} ranks, and this path "
                         "needs equal shards")
    q, r = divmod(n, mesh.size)
    start = mesh.rank * q + min(mesh.rank, r)
    return slice(start, start + q + (mesh.rank < r))


def shard_batch(mesh: Optional[Mesh], batch, even: bool = False):
    """This rank's contiguous rows of each leading dimension of a tensor,
    an array, or a dict / list / tuple of them."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, even) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v, even) for v in batch)
    return batch[shard_rows(mesh, len(batch), even)]


def _run(mesh: Mesh, tensors: List[torch.Tensor], op) -> None:
    """``op(host_or_device_tensors)`` in place, staging CUDA tensors
    through the host on a gloo group."""
    if not mesh.staged:
        op(tensors)
        return
    host = [t.cpu() for t in tensors]
    op(host)
    for t, h in zip(tensors, host):
        t.copy_(h)


def replicated(mesh: Optional[Mesh], tensors: Iterable[torch.Tensor]) -> None:
    """Broadcast ``tensors`` from rank 0 to every rank, in place."""
    if not _grouped(mesh):
        return
    tensors = list(tensors)
    with torch.no_grad():
        for t in tensors:
            _run(mesh, [t.data], lambda ts: dist.broadcast(ts[0], src=0, group=mesh.group))


def all_reduce_sum(mesh: Optional[Mesh], buf: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of a flat buffer (a new tensor; the identity
    without a group)."""
    if not _grouped(mesh):
        return buf
    out = buf.detach().clone()
    _run(mesh, [out], lambda ts: dist.all_reduce(ts[0], group=mesh.group))
    return out


def all_reduce_mean(mesh: Optional[Mesh], buf: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of a flat buffer: the sum divided by the world
    size (a mean of the ranks' means, the global mean only for equal
    shards)."""
    if not _grouped(mesh):
        return buf
    return all_reduce_sum(mesh, buf) / mesh.size


class _SumAcross(torch.autograd.Function):
    """All-reduce sum whose backward passes the cotangent through: every
    rank computes the same loss of the reduced value, so each rank's share
    of the sum gets that loss's cotangent unchanged (summing the ranks'
    cotangents, as ``torch.distributed.nn`` does, would count it
    ``size`` times)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_across(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``x``, differentiable (see :class:`_SumAcross`)."""
    if not _grouped(mesh):
        return x
    return _SumAcross.apply(x, mesh)


def gather_rows(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` concatenated in rank order, on every rank
    (ranks may hold different row counts)."""
    if not _grouped(mesh):
        return x
    x = x.detach().contiguous()
    counts = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    sizes = [torch.zeros_like(counts) for _ in range(mesh.size)]
    _run(mesh, [counts] + sizes, lambda ts: dist.all_gather(ts[1:], ts[0], group=mesh.group))
    sizes = [int(s) for s in sizes]
    most = max(sizes)
    pad = x.new_zeros((most,) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in range(mesh.size)]
    _run(mesh, [pad] + parts, lambda ts: dist.all_gather(ts[1:], ts[0], group=mesh.group))
    return torch.cat([p[:n] for p, n in zip(parts, sizes)])


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (the other ranks' wait while rank 0 writes)."""
    if _grouped(mesh):
        if mesh.backend == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


def broadcast_object(mesh: Optional[Mesh], obj):
    """Rank 0's ``obj`` (any picklable value) on every rank."""
    if not _grouped(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group,
                               device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]
