"""Scale-out: replica batches on one device, the slab domain pipeline
across processes.

``replicas`` batches a population of trajectories into one state with a
leading replica axis (``init_replica_states``, ``run_replica_steps``).

``comm.Communicator`` carries the collectives; ``domain`` plans the slabs,
rebuilds the residency layout and runs the slab step
(``make_domain_runner``). ``launch.run_ranks`` runs a function on S local
processes over gloo (the CPU dry run of an S-slab program).
"""

from cavmd_tpu_torch.parallel.comm import Communicator
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

__all__ = ["Communicator", "DomainPlan", "make_domain_runner", "plan_domain",
           "init_replica_states", "make_replica_step", "run_replica_steps",
           "split_replica_obs"]
