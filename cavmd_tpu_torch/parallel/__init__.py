"""Scale-out across processes: the slab domain pipeline.

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

__all__ = ["Communicator", "DomainPlan", "make_domain_runner", "plan_domain"]
