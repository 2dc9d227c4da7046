"""Atom sharding by rows: the port's counterpart of the JAX package's GSPMD
atom sharding, for what the slab path does not take.

The JAX package jits its unchanged step with the particle arrays sharded
over a mesh axis 'atoms', and XLA inserts the collectives
(``cavmd_tpu/parallel/shard.py``). A Python step cannot be partitioned, so
here only the work that costs is split, by rows, and the rest stays
replicated on the S ranks of the atom group:

- each rank owns the contiguous row block ``[s N/S, (s + 1) N/S)`` (N must
  be divisible by S: ``pad_snapshot_to``) and computes, on its rows only,
  the pair pass (K1 in dense mode; K6/K8, the cell kernel, in cell mode;
  K9, the zcol pair kernel, in zcol mode, over a column list and hull
  built replicated), the PPPM spread (K2) into a partial mesh and the
  interpolation (K3) from the mesh potential;
- two collectives a step: the sum of the partial meshes before the FFT,
  and the all-gather of the rows' forces with the pair-energy shares in
  the same message (``integrate/forcefield.py:ForceField.bind_rows``);
- the state, the integration tail (K4/K5 or the eager tail) and the cheap
  O(N) terms (bonds, the exclusion correction, the self energy, the
  cavity, custom forces) run replicated on every rank, each energy counted
  once. So every method, every ``extra_obs`` callable and every custom
  force runs unchanged, and as the generators are seeded alike on every
  rank, a sharded run draws the unsharded run's noise draw for draw.

The state stays replicated: the collectives give every rank the same bits,
so the ranks' states stay equal.

``make_sharded_step`` and ``make_sharded_runner`` take the JAX package's
arguments: a step of ``make_step_fn`` (or ``make_adaptive_step`` of one),
a mesh (``parallel/mesh.py:make_mesh``) and a template state; the step is
rebuilt around the row-split force field (``step.rebind``). With
``batched=True`` the state is a replica batch: rank (r, s) of an R x S
mesh steps rows ``[r B/R, (r + 1) B/R)`` of the batch of B
(``shard_state`` cuts them), drawing those rows of the full batch's noise
(``StreamNoise(B, rows)``) unless the step was given a noise source of its
own.
"""

from __future__ import annotations

from cavmd_tpu_torch.integrate.integrator import (
    MDState,
    StreamNoise,
    run_steps,
)
from cavmd_tpu_torch.parallel.mesh import Mesh


def _replica_rows(mesh: Mesh, state_template: MDState, batched: bool):
    """(full batch, this rank's slice of it) of a batched template on the
    mesh's replica axis (None, None unbatched)."""
    if not batched:
        return None, None
    B = state_template.batch_shape[0]
    R, r = mesh.replica.world_size, mesh.replica.rank
    if B % R:
        raise ValueError(f"{B} replicas not divisible by the mesh's {R} "
                         "replica ranks")
    return B, slice(r * B // R, (r + 1) * B // R)


def make_sharded_step(step_fn, mesh: Mesh, state_template: MDState, *,
                      batched: bool = False):
    """``step_fn`` with its force field split by rows over the mesh's atom
    group (the module note). ``step_fn`` is a step of ``make_step_fn``, or
    ``make_adaptive_step`` of one (it must have ``rebind``). The returned
    step advances this rank's state (``shard_state``)."""
    rebind = getattr(step_fn, "rebind", None)
    if rebind is None:
        raise TypeError("make_sharded_step takes a step of make_step_fn "
                        "(or make_adaptive_step of one): it rebuilds the "
                        "step around a row-split force field")
    atoms = mesh.atoms
    kw = {}
    if atoms.world_size > 1:
        kw["ff"] = step_fn.force_field.bind_rows(atoms)
    B, rows = _replica_rows(mesh, state_template, batched)
    noise = step_fn.noise
    if rows is not None and mesh.replica.world_size > 1 and (
            type(noise) is StreamNoise and noise.rows is None):
        kw["noise"] = StreamNoise(B, rows)
    return rebind(**kw) if kw else step_fn


def make_sharded_runner(step_fn, mesh: Mesh, state_template: MDState, *,
                        batched: bool = False):
    """A chunk runner of the row-split step: ``run(state, n_steps) ->
    (state, obs)`` on this rank's state (``shard_state``), the
    observables those of ``run_steps``."""
    step = make_sharded_step(step_fn, mesh, state_template, batched=batched)

    def runner(state: MDState, n_steps: int):
        return run_steps(step, state, n_steps)

    return runner


def shard_state(state: MDState, mesh: Mesh, *,
                batched: bool = False) -> MDState:
    """This rank's state on the mesh: the whole state (replicated over the
    atom group; the start forces are made rank 0's, as the slab path makes
    them), and with ``batched`` its replica rows of the batch."""
    _, rows = _replica_rows(mesh, state, batched)
    if rows is not None and mesh.replica.world_size > 1:
        from cavmd_tpu_torch.parallel.replicas import replica_rows

        state = replica_rows(state, rows)
    return state.replace(forces=mesh.atoms.broadcast(state.forces))
