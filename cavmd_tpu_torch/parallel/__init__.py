"""Scale-out: replica batches on one device, replicas over ranks, the slab
domain pipeline across processes.

``replicas`` batches a population of trajectories into one state with a
leading replica axis (``init_replica_states``, ``run_replica_steps``); a
rank's slice of a batch is ``init_replica_states(first_replica=)``
stepped with ``integrate.StreamNoise(full_batch, rows)``.

``comm.Communicator`` carries the collectives (``grid_communicators``
cuts R x S ranks into replicas and slabs); ``domain`` plans the slabs,
rebuilds the residency layout and runs the slab step
(``make_domain_runner``: one replica, or a batch over slabs with each
kernel once a step for the batch; with ``n_replicas=R`` over R x S
ranks).
``launch.run_ranks`` runs a function on local processes over gloo (the
CPU dry runs).

``shard`` is atom sharding by rows, for what the slab path does not take
(the JAX package's GSPMD fallback): ``make_mesh`` cuts R x S ranks into a
(replica, atoms) grid, ``pad_snapshot_to`` pads N to a multiple of S with
inert ghosts, and ``make_sharded_step`` / ``make_sharded_runner`` /
``shard_state`` run a step with its pair pass and PPPM split by rows over
the atom group and the rest replicated.
"""

from cavmd_tpu_torch.parallel.comm import Communicator, grid_communicators
from cavmd_tpu_torch.parallel.domain import (
    DomainPlan,
    make_domain_runner,
    plan_domain,
)
from cavmd_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    pad_snapshot_to,
    state_shardings,
)
from cavmd_tpu_torch.parallel.replicas import (
    init_replica_states,
    make_replica_step,
    run_replica_steps,
    split_replica_obs,
)
from cavmd_tpu_torch.parallel.shard import (
    make_sharded_runner,
    make_sharded_step,
    shard_state,
)

__all__ = ["Communicator", "grid_communicators", "DomainPlan",
           "make_domain_runner", "plan_domain",
           "init_replica_states", "make_replica_step", "run_replica_steps",
           "split_replica_obs", "Mesh", "make_mesh", "pad_snapshot_to",
           "state_shardings", "make_sharded_runner", "make_sharded_step",
           "shard_state"]
