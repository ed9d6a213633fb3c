"""The collectives of the port's parallel paths, over ``torch.distributed``.

One process per rank; a mesh is a ``DeviceMesh`` with named dims, and each
function here works on one dim's group. Every collective goes through
``dist.<name>`` looked up at call time, so a caller (a test) can count them.

The transport is the process group's backend, which the caller chose when
it initialised the world (``parallel.multihost_init``): NCCL moves CUDA
tensors card to card; gloo moves host memory. In a gloo world (several
ranks that share one card, which NCCL refuses) the all-reduce and the
all-gather take CUDA tensors as they are, and gloo copies them through the
host itself; a halo exchange (``shift``, gloo's point-to-point) is staged
through a page-locked host buffer on its way out and copied back to the
card after. Nothing here switches backend or device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A page-locked copy of ``t``, complete when this returns (gloo reads
    it from its own thread)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The ``op`` of ``t`` over ``group``, as a new tensor on ``t``'s device."""
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``[group size, *t.shape]``: every rank's ``t``, stacked in rank order
    of the group, on ``t``'s device."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    return torch.stack(outs)


def shift(t: torch.Tensor, mesh, axis: str, step: int) -> torch.Tensor:
    """One halo exchange along ``axis``: every rank sends ``t`` to its
    neighbour ``step`` places on (``step=-1``: to the left, as the JAX
    package's ``ppermute`` with ``perm=[(i + 1, i)]``) and receives the
    ``t`` of its neighbour ``step`` places back. The rank with no such
    neighbour receives zeros. Sends and receives go in one
    ``dist.batch_isend_irecv``, so neighbours never wait on each other's
    order; ``t`` has the same shape on every rank."""
    ranks = mesh[axis].mesh.tolist()
    me = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    dst, src = me + step, me - step
    has_dst, has_src = 0 <= dst < len(ranks), 0 <= src < len(ranks)
    if not has_dst and not has_src:
        return torch.zeros_like(t)
    staged = _staged(t, group)
    send = _to_host(t) if staged else t.contiguous()
    recv = torch.empty(t.shape, dtype=t.dtype, device=send.device, pin_memory=staged)
    ops = []
    if has_dst:
        ops.append(dist.P2POp(dist.isend, send, ranks[dst], group))
    if has_src:
        ops.append(dist.P2POp(dist.irecv, recv, ranks[src], group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if not has_src:
        return torch.zeros_like(t)
    return recv.to(t.device, non_blocking=True) if staged else recv


class ReduceFromGroup(torch.autograd.Function):
    """Megatron's "g": the sum of the partial results over ``group`` in the
    forward pass; the gradient passes through unchanged (each rank's
    partial contributes to the sum with weight one)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class CopyToGroup(torch.autograd.Function):
    """Megatron's "f": the identity in the forward pass; in the backward
    pass the gradient is summed over ``group``, since each rank's sharded
    consumer gives only its own part of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None
