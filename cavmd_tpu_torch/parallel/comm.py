"""The collectives of the slab domain pipeline, over ``torch.distributed``.

The JAX package's domain step runs under ``shard_map`` and communicates
with ``ppermute`` (the halo) and ``psum`` (scalars and the PPPM grid). Here
each slab is one process; :class:`Communicator` gives the step the same
three operations:

- ``halo(last, first)``: each rank sends its last own x-layer to its right
  neighbour and its first to its left neighbour, and receives the left
  neighbour's last layer and the right neighbour's first (one exchange of
  2 x (H, 3) rows);
- ``sum(t)`` / ``sum_many(ts)``: all-reduce sums; ``sum_many`` packs the
  tensors into one flat buffer in a fixed order, so the force stage costs
  one collective;
- ``all_gather(t)``: the rows of every rank, rank by rank (the scatter-out
  of a chunk);
- ``broadcast(t)``: rank 0's tensor on every rank (a value computed
  alike on every rank whose bits may still differ, such as a sum of
  floating-point atomics on different cards, is made replicated so).

At world size 1 the halo is a local copy (the JAX self-``ppermute``) and
the sums are the identity, so S = 1 runs exactly the S > 1 program.
Otherwise the operations go through a process group: gloo for CPU
tensors, NCCL for CUDA tensors. A sum returns the same bits on every rank,
so values built from sums stay replicated.
"""

from __future__ import annotations

import torch


class Communicator:
    """Rank ``rank`` of ``world_size`` slabs; ``group`` is the
    ``torch.distributed`` process group (None: the default group). Nothing
    here is global: a world-size-1 communicator needs no process group."""

    def __init__(self, rank: int = 0, world_size: int = 1, group=None):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world size {world_size}")
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.group = group

    @staticmethod
    def from_process_group(group=None) -> "Communicator":
        """The communicator of this process in ``group`` (None: the
        default group, which must be initialised)."""
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "torch.distributed is not initialised: call "
                "init_process_group first (or launch with "
                "python -m torch.distributed.run)")
        return Communicator(dist.get_rank(group), dist.get_world_size(group),
                            group)

    def _global(self, r: int) -> int:
        """The default-group rank of rank ``r`` of this group."""
        import torch.distributed as dist

        return (r if self.group is None
                else dist.get_global_rank(self.group, r))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The all-reduce sum of ``t`` over the ranks (``t`` unchanged)."""
        if self.world_size == 1:
            return t
        import torch.distributed as dist

        out = t.reshape(-1).clone()
        dist.all_reduce(out, group=self.group)
        return out.reshape(t.shape)

    def sum_many(self, tensors):
        """The sums of ``tensors`` (one dtype), in one all-reduce of one
        flat buffer."""
        if self.world_size == 1:
            return list(tensors)
        flat = self.sum(torch.cat([t.reshape(-1) for t in tensors]))
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return out

    def halo(self, last: torch.Tensor, first: torch.Tensor):
        """(left, right): the left neighbour's ``last`` rows and the right
        neighbour's ``first`` rows, on the x ring of slabs."""
        if self.world_size == 1:
            return last, first
        import torch.distributed as dist

        S, r = self.world_size, self.rank
        right_peer = self._global((r + 1) % S)
        left_peer = self._global((r - 1) % S)
        left = torch.empty_like(last)
        right = torch.empty_like(first)
        # tags tell the two messages apart when both neighbours are one
        # rank (S = 2)
        ops = [dist.P2POp(dist.isend, last.contiguous(), right_peer,
                          self.group, 0),
               dist.P2POp(dist.isend, first.contiguous(), left_peer,
                          self.group, 1),
               dist.P2POp(dist.irecv, left, left_peer, self.group, 0),
               dist.P2POp(dist.irecv, right, right_peer, self.group, 1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return left, right

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0, in rank order."""
        if self.world_size == 1:
            return t
        import torch.distributed as dist

        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank."""
        if self.world_size == 1:
            return t
        import torch.distributed as dist

        out = t.contiguous().clone()
        dist.broadcast(out, self._global(0), group=self.group)
        return out

    def barrier(self) -> None:
        if self.world_size > 1:
            import torch.distributed as dist

            dist.barrier(group=self.group)
