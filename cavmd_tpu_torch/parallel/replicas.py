"""Replica batching: a population of trajectories as one batched state.

Port of ``cavmd_tpu/parallel/replicas.py``. The reference fans replicas out
as a SLURM array, one task a replica (``examples/submit.sh``); the JAX
package ``vmap``s its step over a leading replica axis. Here the batch is
written out instead: one ``MDState`` whose per-replica leaves carry a
leading axis B (``integrate/integrator.py``), advanced by the ordinary step
function, whose operations all run over the last two axes. Each hand
kernel (K1-K5; in cell and zcol mode the cell kernel or K9 with its hull
in place of K1) then runs once a step for all B replicas, so a batch costs
the host the launches of one replica. ``torch.func.vmap`` cannot batch the
kernels (ctypes launches), and a Python loop over replicas would multiply
the launches by B.

The replicas share one topology (N, types, charges, masses, bonds) and one
box, checked here once, on the host, and one force field in any pair mode.
Each replica has its own positions, velocities, clock, adaptive dt,
reservoirs and MTTK (xi, eta), and in cell and zcol mode its own carried
list and anchor (the batched ``CellList`` of ``ops/neighbor.py``), rebuilt when one of its own
particles has moved past half the skin. An overflow in any replica sets
that replica's ``cell_overflow``; the caller re-plans the whole batch
(``drivers/advanced_run.py:run_vmapped_replicas``). After an overflow the
carried lists and start forces of the chunk are not to be trusted: a
retry rebuilds both from the chunk's start positions. The step draws each random stream once
for the whole batch (one ``torch.Generator`` a stream, shaped (B, ...)),
so replica r's noise is not the stream of a one-replica run at seed + r;
its initial thermal velocities are (``init_replica_states``).

A slice of a batch (replicas over ranks: ``--shard-replicas``, and
``make_domain_runner(n_replicas=)``) is rows ``[k, k + b)`` of the full
batch: ``init_replica_states(..., first_replica=k)`` thermalizes and
seeds them as the full batch does, and ``StreamNoise(full_batch, rows)``
(``integrate/integrator.py``) draws the full batch's shapes from the
batch's generators and keeps the slice's rows, so R ranks holding R
slices step as the one-rank batch does. The MTTK and Berendsen baths
take each replica's own kinetic energy, temperature and factor, (B,)
tensors broadcast over (B, N, 3), as ``jax.vmap`` of the JAX step does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from cavmd_tpu_torch.core.snapshot import Snapshot
from cavmd_tpu_torch.integrate.forcefield import ForceField
from cavmd_tpu_torch.integrate.integrator import (
    MDState,
    carries_cell_list,
    init_state,
    run_steps,
    thermal_velocities,
)

# leaves of MDState that carry the replica axis; the others are shared
PER_REPLICA = ("position", "image", "velocity", "forces", "dt", "time_au",
               "time_comp", "timestep", "bussi_reservoir",
               "bussi_instantaneous", "langevin_reservoir", "mttk_xi",
               "mttk_eta", "error_tolerance")
_TOPOLOGY = ("typeid", "charge", "mass", "bond_group", "bond_typeid")


def _host(t):
    return t.detach().cpu().numpy()


def _check_replicas(snaps: Sequence[Snapshot]) -> None:
    """Raise ``ValueError`` unless every snapshot has replica 0's topology
    (N, typeid, charge, mass, bonds) and box. The box check is the port of
    the JAX package's same-box guard (``cavmd_tpu/ops/pppm.py:569-580``,
    which poisons a mixed-box batch with NaN): no ported method changes
    the box, so one check before the run holds for all of it."""
    ref = snaps[0]
    for r, s in enumerate(snaps[1:], 1):
        if s.N != ref.N or not all(
                np.array_equal(_host(getattr(s, k)), _host(getattr(ref, k)))
                for k in _TOPOLOGY):
            raise ValueError(
                f"replica {r} has another topology than replica 0 (N, "
                "types, charges, masses or bonds): a replica batch shares "
                "one ForceField")
        if not np.array_equal(_host(s.box_L), _host(ref.box_L)):
            raise ValueError(
                f"replica {r}'s box {_host(s.box_L).tolist()} differs from "
                f"replica 0's {_host(ref.box_L).tolist()}: the replicas of a "
                "batch share one box (one PPPM influence table)")


def _stack(states: Sequence[MDState], seed: int, ff: ForceField) -> MDState:
    """One batched ``MDState`` from one-replica states of one topology:
    the per-replica leaves stacked on a new leading axis, the shared ones
    taken from the first, the host step from the first (they must agree),
    fresh generators from ``seed``, and in cell and zcol mode the batched
    list built from the stacked positions (each replica's equal to its
    own state's)."""
    steps = {s.step for s in states}
    if len(steps) != 1:
        raise ValueError(f"replica states at different steps {sorted(steps)}")
    first = states[0]
    batch = first.replace(
        **{k: torch.stack([getattr(s, k) for s in states])
           for k in PER_REPLICA},
        seed=seed, generators={}, cell_list=None, cell_anchor=None)
    if carries_cell_list(ff):
        batch = batch.replace(
            cell_list=ff.build_cells(batch.position, batch.box_L),
            cell_anchor=batch.position)
    return batch


def init_replica_states(
    snapshots: Snapshot | Sequence[Snapshot],
    ff: ForceField,
    *,
    n_replicas: int | None = None,
    dt: float,
    seed: int = 0,
    kT: float | None = None,
    error_tolerance: float = 0.0,
    device=None,
    first_replica: int = 0,
) -> MDState:
    """A batched ``MDState`` with a leading replica axis.

    Either one snapshot replicated ``n_replicas`` times, or a sequence of
    per-replica snapshots (for example frames of an input trajectory, the
    reference's replica = frame convention). With ``kT``, replica r's
    velocities are the thermalization ``Simulation.thermalize`` gives at
    seed ``seed + first_replica + r`` (molecules with their drift removed,
    the photon drawn apart). Each replica's forces come from its own
    ``init_state``. The batch's step streams are seeded from ``seed``.
    ``first_replica`` makes the batch rows ``[first_replica,
    first_replica + B)`` of a larger batch built from ``seed``, bit for
    bit (a rank's slice; step it with ``StreamNoise(full_batch, rows)``).
    ``device``: where the state lives (None: the snapshots' device). In
    cell and zcol mode the state carries the batched list. Raises
    ``ValueError`` for replicas of another topology or box.
    """
    if isinstance(snapshots, Snapshot):
        if n_replicas is None:
            raise ValueError("give n_replicas with a single snapshot")
        snaps = [snapshots] * n_replicas
    else:
        snaps = list(snapshots)
    if not snaps:
        raise ValueError("no replicas")
    _check_replicas(snaps)
    dev = snaps[0].device if device is None else torch.device(device)
    states = []
    for r, snap in enumerate(snaps, first_replica):
        snap = snap.to(dev)
        if kT is not None:
            snap = snap.replace(velocity=thermal_velocities(
                snap.mass, snap.typeid, ff.l_typeid, kT, seed + r,
                ghost_typeid=ff.ghost_typeid))
        states.append(init_state(snap, ff, dt=dt, seed=seed + r,
                                 error_tolerance=error_tolerance))
    return _stack(states, seed, ff)


def replica_rows(state: MDState, rows) -> MDState:
    """Rows ``rows`` of a batched state: a slice, or an int for one
    replica squeezed to a one-replica state. The per-replica leaves are
    indexed; generators, seed and host step are the batch's. A carried
    cell list is dropped: the slab runner, which takes such rows, builds
    its own lists."""
    return state.replace(**{k: getattr(state, k)[rows] for k in PER_REPLICA},
                         cell_list=None, cell_anchor=None)


def make_replica_step(step_fn):
    """The step of a replica batch: ``step_fn`` itself, whose operations
    run over the last two axes in every pair mode (the JAX package wraps
    its step in ``jax.vmap``)."""
    return step_fn


def run_replica_steps(step_fn, batched_state: MDState, n_steps: int):
    """Run the batch ``n_steps`` steps; the observables gain a
    (steps, replicas) shape."""
    return run_steps(make_replica_step(step_fn), batched_state, n_steps)


def split_replica_obs(obs, n_replicas: int):
    """Per-replica observable dicts (for per-replica trackers writing
    per-replica files): column r of every (steps, B, ...) array."""
    return [{k: np.asarray(v)[:, r] for k, v in obs.items()}
            for r in range(n_replicas)]
