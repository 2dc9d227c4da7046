"""cavmd_tpu_torch: the PyTorch + CUDA port of the cavity-QED MD framework.

Mirrors the layout of the JAX package (``core/ ops/ integrate/ observe/
io/ utils/ drivers/ simulation.py``) and keeps its public names, so each
port module has one reference module. Plain tensor code is PyTorch; the
dense pair pass, the PPPM spread/interpolation and the fused integrator
tail run in hand-written CUDA kernels (``csrc/*.cu``, built with ``nvcc``
for ``sm_90a`` at first use) whenever their inputs live on a CUDA device,
and in plain PyTorch twins on the CPU. Entry points put their tensors on
the CUDA device unless the caller passes ``device="cpu"``.

TF32 is switched off at import: on the TPU, bf16 rounding of
position-carrying products heated NVE from 100 K to 6000 K, and TF32 keeps
the same 10-bit mantissa.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from cavmd_tpu_torch.version import __version__  # noqa: E402
from cavmd_tpu_torch.core import (  # noqa: E402
    Box,
    PhysicalConstants,
    Snapshot,
    add_cavity_particle,
    make_diatomic_system,
    unwrap_positions,
    wrap_positions,
)
from cavmd_tpu_torch.integrate import (  # noqa: E402
    ForceField,
    MDState,
    MethodSpec,
    init_state,
    make_step_fn,
    potential_energy,
    resolve_methods,
    run_steps,
    universe_energy,
)
from cavmd_tpu_torch.io.checkpoint import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
)
from cavmd_tpu_torch.simulation import Simulation  # noqa: E402

__all__ = [
    "__version__",
    "PhysicalConstants",
    "Box",
    "Snapshot",
    "unwrap_positions",
    "wrap_positions",
    "add_cavity_particle",
    "make_diatomic_system",
    "ForceField",
    "MDState",
    "MethodSpec",
    "init_state",
    "make_step_fn",
    "potential_energy",
    "resolve_methods",
    "run_steps",
    "universe_energy",
    "Simulation",
    "save_checkpoint",
    "load_checkpoint",
]
