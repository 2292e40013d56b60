"""The collective layer of the sharded paths: the only place their bodies touch
`torch.distributed`.

A `Comm` is one axis of a mesh (its process group) seen from this rank. It
offers the three collectives of the JAX package's `shard_map` bodies:

  psum            the sum over the axis, complex values as a real pair
                  (`_psum_c`, srsran_ce_tpu/parallel/subcarrier.py:205);
  all_gather      the axis' blocks concatenated along one dimension (tiled);
  halo_exchange   (left, right): the left neighbour's last h entries and the
                  right neighbour's first h along the last dimension, zeros
                  at the outermost shards (`_halo_exchange`, :212-223).

The sums are taken over an all_gather, in rank order, never through the
backend's ring or tree all_reduce: the operands are a few scalars or rows, and
the result is then the same on NCCL and gloo and from run to run (and over one
rank it is the operand itself, bit for bit).

The halo exchange (the JAX `ppermute`) has two routes, both pure data
movement with bit-identical results: "p2p" (`dist.batch_isend_irecv`) on NCCL
and on gloo with CPU tensors, and "all_gather" (an all_gather of every rank's
two edge blocks) on gloo with CUDA tensors, whose send/recv gloo does not take.
`halo_routes` counts the exchanges by route. A collective the backend refuses
raises: nothing here moves a tensor to the host for a collective (gloo stages
a CUDA tensor through the host itself, inside the backend).
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

#: halo exchanges made by this process, by route ("p2p", "all_gather", "local"
#: for an axis of one rank)
halo_routes: "collections.Counter" = collections.Counter()


#: all_gather into one tensor (named all_gather_single from torch 2.13 on)
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _real(x: torch.Tensor) -> torch.Tensor:
    """A real, contiguous view of x (complex as a trailing real pair)."""
    x = x.contiguous()
    return torch.view_as_real(x) if x.is_complex() else x


class Comm:
    """One mesh axis (a process group) as seen from this rank: `rank` and
    `size` within the axis, the axis' backend, and its collectives."""

    def __init__(self, group, name: str = "axis"):
        self.group = group
        self.name = name
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self._peers = [dist.get_global_rank(group, r) for r in range(self.size)]

    def __repr__(self) -> str:
        return f"Comm({self.name!r}, rank {self.rank} of {self.size}, {self.backend})"

    def halo_route(self, device) -> str:
        """The route a halo exchange of tensors on `device` takes."""
        if self.size == 1:
            return "local"
        if self.backend == "nccl" or torch.device(device).type == "cpu":
            return "p2p"
        return "all_gather"

    def _stack(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's x, in rank order."""
        xr = _real(x)
        flat = xr.reshape(-1)
        if flat.dtype == torch.bool:
            flat = flat.view(torch.uint8)
        out = flat.new_empty((self.size * flat.numel(),))  # gloo wants the ranks concatenated
        _gather_into(out, flat, group=self.group)
        out = out.view(xr.dtype).reshape((self.size,) + tuple(xr.shape))
        return torch.view_as_complex(out) if x.is_complex() else out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the axis, taken in rank order."""
        g = self._stack(x)
        acc = g[0]
        for r in range(1, self.size):
            acc = acc + g[r]
        return acc

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' x concatenated along `dim`, in rank order."""
        return torch.cat(list(self._stack(x).unbind(0)), dim=dim)

    def halo_exchange(self, x: torch.Tensor, h: int, route: str = None):
        """(left, right), each x[..., :h]-shaped: the left neighbour's last h
        entries (zeros on the first rank) and the right neighbour's first h
        (zeros on the last rank), along the last dimension. `route` forces
        one ("p2p" or "all_gather"; a test holds them to each other)."""
        route = route or self.halo_route(x.device)
        if self.size == 1:
            route = "local"
        halo_routes[route] += 1
        head = x[..., :h].contiguous()
        tail = x[..., x.shape[-1] - h:].contiguous()
        first, last = self.rank == 0, self.rank == self.size - 1
        if route == "local":
            return torch.zeros_like(tail), torch.zeros_like(head)
        if route == "all_gather":
            g = self._stack(torch.stack([head, tail]))  # (size, 2, ..., h)
            left = torch.zeros_like(tail) if first else g[self.rank - 1, 1]
            right = torch.zeros_like(head) if last else g[self.rank + 1, 0]
            return left, right
        left, right = torch.zeros_like(tail), torch.zeros_like(head)
        ops = []
        if not first:
            peer = self._peers[self.rank - 1]
            ops += [dist.P2POp(dist.isend, _real(head), peer, self.group),
                    dist.P2POp(dist.irecv, _real(left), peer, self.group)]
        if not last:
            peer = self._peers[self.rank + 1]
            ops += [dist.P2POp(dist.isend, _real(tail), peer, self.group),
                    dist.P2POp(dist.irecv, _real(right), peer, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return left, right
