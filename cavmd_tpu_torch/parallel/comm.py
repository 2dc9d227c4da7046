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
  of a chunk; a row split's forces);
- ``stack(t)``: every rank's tensor on a new leading axis, through CPU
  copies (the replica axis's end-of-run gather);
- ``broadcast(t)``: rank 0's tensor on every rank (a value computed
  alike on every rank whose bits may still differ, such as a sum of
  floating-point atomics on different cards, is made replicated so).

The atom group of a row split (``parallel/shard.py``) uses two of them a
step, ``sum`` (the partial PPPM meshes) and ``all_gather`` (the rows'
forces). Over NCCL they take CUDA tensors, one card a rank. Over gloo a
CUDA tensor goes through a host copy and comes back to its card, so S
ranks can share one card (as the replica axis lets R ranks share one);
the compute stays on the card.

At world size 1 the halo is a local copy (the JAX self-``ppermute``) and
the sums are the identity, so S = 1 runs exactly the S > 1 program.
Otherwise the operations go through a process group: gloo for CPU
tensors, NCCL for CUDA tensors. A sum returns the same bits on every rank,
so values built from sums stay replicated.

:func:`grid_communicators` cuts a world of R x S ranks into R replicas of
S slabs (the JAX package's 2-D ('replica', 'atoms') mesh): the slab
communicator of a rank holds the S ranks of its replica, its replica
communicator the R ranks of its slab index. The replica axis carries
small host arrays only (clocks once a chunk, the states and observables
at the end of a run), so it is a gloo group and takes CPU tensors, and R
ranks can share one card; the slab axis keeps the world's backend.
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

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the device the group's backend takes: a CPU tensor on
        an NCCL group goes to the current card, a CUDA tensor on a gloo
        group to the host."""
        import torch.distributed as dist

        nccl = dist.get_backend(self.group) == "nccl"
        if t.device.type == "cpu" and nccl:
            return t.to(torch.device("cuda", torch.cuda.current_device()))
        if t.device.type == "cuda" and not nccl:
            return t.cpu()
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The all-reduce sum of ``t`` over the ranks (``t`` unchanged),
        back on ``t``'s device (through a copy where the backend takes
        another device, ``_staged``)."""
        if self.world_size == 1:
            return t
        import torch.distributed as dist

        out = self._staged(t.reshape(-1)).clone()
        dist.all_reduce(out, group=self.group)
        return out.to(t.device).reshape(t.shape)

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
        """Every rank's ``t`` concatenated along dim 0, in rank order, on
        ``t``'s device (staged as for ``sum``)."""
        if self.world_size == 1:
            return t
        import torch.distributed as dist

        src = self._staged(t.contiguous())
        parts = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts).to(t.device)

    def stack(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked on a new leading axis, in rank order
        (``t[None]`` at world size 1). The exchange goes through CPU
        copies, as the replica axis's gloo group takes them; the result
        is on ``t``'s device."""
        if self.world_size == 1:
            return t[None]
        return self.all_gather(t.detach().cpu()[None]).to(t.device)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank (staged as for ``sum``)."""
        if self.world_size == 1:
            return t
        import torch.distributed as dist

        out = self._staged(t.contiguous()).clone()
        dist.broadcast(out, self._global(0), group=self.group)
        return out.to(t.device)

    def barrier(self) -> None:
        if self.world_size > 1:
            import torch.distributed as dist

            dist.barrier(group=self.group)


def grid_communicators(n_replicas: int, n_slabs: int):
    """(replica, slab) communicators of this rank in the default process
    group cut into ``n_replicas`` x ``n_slabs`` ranks: world rank g is
    replica g // S, slab g % S. Every rank creates every subgroup, in the
    same order, as ``new_group`` requires. An axis of size 1 needs no
    group (a world-size-1 communicator). Raises ``ValueError`` when the
    world size is not R x S."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised: a grid of "
            f"{n_replicas} replicas x {n_slabs} slabs needs "
            f"{n_replicas * n_slabs} ranks in a process group")
    R, S = int(n_replicas), int(n_slabs)
    world = dist.get_world_size()
    if world != R * S:
        raise ValueError(f"{R} replicas x {S} slabs need {R * S} ranks; "
                         f"the process group has {world}")
    g = dist.get_rank()
    r, s = divmod(g, S)
    replica = slab = None
    if R > 1:  # the replica axis: gloo, CPU tensors
        for j in range(S):
            grp = dist.new_group([i * S + j for i in range(R)],
                                 backend="gloo")
            if j == s:
                replica = Communicator(r, R, grp)
    if S > 1:  # the slab axis: the world's backend
        for i in range(R):
            grp = dist.new_group([i * S + j for j in range(S)])
            if i == r:
                slab = Communicator(s, S, grp)
    return (replica if replica is not None else Communicator(),
            slab if slab is not None else Communicator())
