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
"""

from cavmd_tpu_torch.parallel.comm import Communicator, grid_communicators
from cavmd_tpu_torch.parallel.domain import (
    DomainPlan,
    make_domain_runner,
    plan_domain,
)
from cavmd_tpu_torch.parallel.replicas import (
    init_replica_states,
    make_replica_step,
    run_replica_steps,
    split_replica_obs,
)

__all__ = ["Communicator", "grid_communicators", "DomainPlan",
           "make_domain_runner", "plan_domain",
           "init_replica_states", "make_replica_step", "run_replica_steps",
           "split_replica_obs"]
