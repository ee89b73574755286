"""Frame-sharded temporal stencils: the 1-frame halo exchange.

Port of ``posendf_tpu/parallel/halo.py``. The workload's only coupling
across frames is the adjacent-frame temporal loss of sequence optimization
(``vertices[:-1] - vertices[1:]``). With a clip's frames split over ranks
in contiguous blocks, each rank needs one frame of its right neighbour: the
first frame of rank r + 1 is the "t + 1" of rank r's last frame.

Each rank sends its first frame to its left neighbour with
``torch.distributed`` point-to-point (``batch_isend_irecv``). Rank 0's first
frame has no left neighbour and the last rank receives nothing, so the last
rank's block has one difference fewer: the ranks' results concatenated in
rank order are the unsharded ``x[:-1] - x[1:]``, (T - 1, ...), where the
JAX package's cyclic ``ppermute`` masks the wrapped difference instead. The
exchange is a ``torch.autograd.Function`` whose backward sends the halo's
cotangent back to the rank that owns that frame (``ppermute``'s
transpose), where it joins the first frame's gradient.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from posendf_torch.parallel.mesh import Mesh, sum_across

__all__ = ["adjacent_difference_sharded", "temporal_loss_sharded"]


def _exchange(mesh: Mesh, send: Optional[torch.Tensor], to: int, recv: Optional[torch.Tensor],
              frm: int) -> None:
    """Send ``send`` to rank ``to`` and receive ``recv`` from rank ``frm``
    (either may be None), in one batch; through the host on gloo."""
    if mesh.staged:
        send = send.cpu() if send is not None else None
        host = recv.cpu() if recv is not None else None
    else:
        host = recv
    ops: List[dist.P2POp] = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to, mesh.group))
    if host is not None:
        ops.append(dist.P2POp(dist.irecv, host, frm, mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if recv is not None and host is not recv:
        recv.copy_(host)


class _Halo(torch.autograd.Function):
    """The next rank's first frame (1, ...) along dim 0, (0, ...) on the
    last rank."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.shape = x.shape
        r, n = mesh.rank, mesh.size
        halo = x.new_empty((1 if r < n - 1 else 0,) + tuple(x.shape[1:]))
        _exchange(mesh, x[:1].detach() if r > 0 else None, r - 1,
                  halo if r < n - 1 else None, r + 1)
        return halo

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        r, n = mesh.rank, mesh.size
        gx = g.new_zeros(ctx.shape)
        first = g.new_empty((1,) + tuple(ctx.shape[1:])) if r > 0 else None
        # the halo's cotangent goes back to its owner, rank r + 1
        _exchange(mesh, g.contiguous() if r < n - 1 else None, r + 1, first, r - 1)
        if first is not None:
            gx[:1] = first
        return gx, None


def adjacent_difference_sharded(x: torch.Tensor, mesh: Optional[Mesh],
                                dim: int = 0) -> torch.Tensor:
    """This rank's rows of ``x[:-1] - x[1:]`` along the frame axis ``dim``
    of the clip whose contiguous frames each rank holds: t rows on every
    rank but the last, t - 1 there. Without a group, the unsharded
    difference."""
    if mesh is not None and mesh.group is not None:
        halo = _Halo.apply(x.movedim(dim, 0), mesh).movedim(0, dim)
        x = torch.cat([x, halo], dim=dim)
    n = x.shape[dim] - 1
    return x.narrow(dim, 0, n) - x.narrow(dim, 1, n)


def temporal_loss_sharded(verts: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Mean adjacent-frame vertex displacement of the clip, on every rank:
    ``mean(sqrt(sum((v[:-1] - v[1:])^2, -1) + 1e-12))`` of the unsharded
    (T, V, 3) clip, from each rank's (t, V, 3) frames, one halo frame and
    one all-reduce (differentiable through both)."""
    d = adjacent_difference_sharded(verts, mesh)
    norm = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    if mesh is None or mesh.group is None:
        return norm.mean()
    count = torch.tensor(float(norm.numel()), dtype=torch.float64, device=norm.device)
    total = float(sum_across(mesh, count))
    return sum_across(mesh, norm.mean() * (norm.numel() / total))
