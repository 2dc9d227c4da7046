from cavmd_tpu_torch.core.units import PhysicalConstants
from cavmd_tpu_torch.core.box import (
    Box,
    unwrap_positions,
    wrap_positions,
    rewrap,
    minimum_image,
)
from cavmd_tpu_torch.core.snapshot import Snapshot, add_cavity_particle
from cavmd_tpu_torch.core.system import make_diatomic_system, reference_box_for

__all__ = [
    "PhysicalConstants",
    "Box",
    "unwrap_positions",
    "wrap_positions",
    "rewrap",
    "minimum_image",
    "Snapshot",
    "add_cavity_particle",
    "make_diatomic_system",
    "reference_box_for",
]
