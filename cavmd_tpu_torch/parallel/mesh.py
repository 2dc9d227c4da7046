"""The (replica, atoms) process grid of atom sharding by rows, and ghost
padding.

Port of ``cavmd_tpu/parallel/mesh.py``. The JAX package lays its devices
out as a 2-D ``jax.sharding.Mesh`` with axes ('replica', 'atoms'); here a
mesh is R x S processes (``parallel/comm.py:grid_communicators``): the
replica communicator of a rank holds the R ranks of its atom shard, its
atom communicator the S ranks of its replica group. ``state_shardings``
names, with the JAX package's rules, which ``MDState`` fields a mesh
splits; the row path (``parallel/shard.py``) splits the work of those
rows and keeps the fields themselves replicated on the S ranks.

``pad_snapshot_to`` pads N to a multiple of S with inert ghost rows, as
the JAX package does: the row path needs N divisible by S.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cavmd_tpu_torch.core.snapshot import GHOST_TYPE
from cavmd_tpu_torch.parallel.comm import Communicator, grid_communicators

GHOST_MASS = 1e30


class Mesh(NamedTuple):
    """This rank's place in an R x S grid: ``replica`` (the R ranks of its
    atom shard, gloo: small host arrays) and ``atoms`` (the S ranks of its
    replica group, the world's backend: the row split's collectives)."""

    replica: Communicator
    atoms: Communicator

    @property
    def shape(self) -> tuple:
        return (self.replica.world_size, self.atoms.world_size)

    @property
    def axis_names(self) -> tuple:
        return ("replica", "atoms")


def make_mesh(n_replica: int = 1, n_atoms_shards: int | None = None,
              devices=None) -> Mesh:
    """The (replica, atoms) grid of this rank over the default process
    group: ``n_replica`` x ``n_atoms_shards`` ranks (None: the world size
    over ``n_replica``). A 1 x 1 grid needs no process group. ``devices``
    is the JAX signature's; ranks are processes here, so it must be None.
    Raises ``ValueError`` when the world is not R x S ranks."""
    import torch.distributed as dist

    if devices is not None:
        raise ValueError("make_mesh: the ranks are processes; pass no "
                         "devices (launch R x S ranks instead)")
    R = int(n_replica)
    if n_atoms_shards is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        n_atoms_shards = world // R
    S = int(n_atoms_shards)
    if R * S == 1 and not dist.is_initialized():
        return Mesh(Communicator(), Communicator())
    return Mesh(*grid_communicators(R, S))


# MDState fields of (.., N, 3) rows and of (.., N) rows, as the JAX rules
# name them
_ROW_FIELDS_3 = ("position", "image", "velocity", "forces", "cell_anchor")
_ROW_FIELDS_1 = ("mass", "charge", "typeid")


def state_shardings(mesh: Mesh, state, *, batched: bool) -> dict:
    """The partition spec of every tensor field of ``state`` (an
    ``MDState``), by the JAX package's rules: particle arrays over
    'atoms' (and 'replica' first when ``batched``), every other field
    replicated over 'atoms' (over 'replica' too for the shared topology).
    A spec is a tuple with one entry an axis: an axis name or None. The
    row path splits the work of the 'atoms' rows and keeps the fields
    themselves on every rank of the replica group."""
    r = ("replica",) if batched else ()
    per_replica = set()
    if batched:
        from cavmd_tpu_torch.parallel.replicas import PER_REPLICA

        per_replica = set(PER_REPLICA) | {"cell_anchor"}
    specs = {}
    for f in dataclasses.fields(state):
        leaf = getattr(state, f.name)
        if not isinstance(leaf, torch.Tensor):
            continue
        lead = r if f.name in per_replica else ()
        core = leaf.dim() - len(lead)
        if f.name in _ROW_FIELDS_3 and core == 2:
            specs[f.name] = lead + ("atoms", None)
        elif f.name in _ROW_FIELDS_1 and core == 1:
            specs[f.name] = lead + ("atoms",)
        else:
            specs[f.name] = lead + (None,) * core
    return specs


def pad_snapshot_to(snapshot, multiple: int):
    """Pad the particle arrays so that N divides ``multiple``; returns
    (snapshot, number of ghost rows).

    The ghosts are rows of a type of their own, ``'__ghost__'`` (no LJ
    pair, so pair-inert), with zero charge and mass 1e30 (pinned: velocity
    0, and a force would not move them), appended after every real row so
    bond indices stay valid. They are spread along the box diagonal, not
    put far away: under periodic boundaries nothing is out of range, and
    no two may coincide (an r = 0 pair would poison a masked pair kernel
    with 0 * inf). A snapshot that holds ghosts already, and would need
    more, raises ``ValueError``."""
    n = snapshot.N
    pad = (-n) % multiple
    if pad == 0:
        return snapshot, 0
    if GHOST_TYPE in snapshot.types:
        # a second block of ghosts would be a type of its own, taken for
        # real rows (and could sit on the first block's ghosts)
        raise ValueError("the snapshot is ghost-padded already: pad the "
                         "unpadded one once, to a multiple of every count "
                         "that needs it")
    dtype = snapshot.position.dtype
    dev = snapshot.device
    frac = (torch.arange(pad, dtype=dtype, device=dev)[:, None] + 0.5) / pad
    ghost_pos = (frac - 0.5) * snapshot.box_L[None, :].to(dtype)
    return snapshot.replace(
        position=torch.cat([snapshot.position, ghost_pos]),
        image=torch.cat([snapshot.image, torch.zeros(
            (pad, 3), dtype=torch.int32, device=dev)]),
        velocity=torch.cat([snapshot.velocity, torch.zeros(
            (pad, 3), dtype=dtype, device=dev)]),
        mass=torch.cat([snapshot.mass, torch.full(
            (pad,), GHOST_MASS, dtype=snapshot.mass.dtype, device=dev)]),
        charge=torch.cat([snapshot.charge, torch.zeros(
            (pad,), dtype=snapshot.charge.dtype, device=dev)]),
        diameter=torch.cat([snapshot.diameter, torch.ones(
            (pad,), dtype=snapshot.diameter.dtype, device=dev)]),
        typeid=torch.cat([snapshot.typeid, torch.full(
            (pad,), len(snapshot.types), dtype=torch.int32, device=dev)]),
        types=tuple(snapshot.types) + (GHOST_TYPE,),
    ), pad
