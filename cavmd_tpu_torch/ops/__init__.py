from cavmd_tpu_torch.ops.bonds import (
    harmonic_bond_force,
    harmonic_bond_force_strided,
)
from cavmd_tpu_torch.ops.cavity import CavityParams, cavity_force
from cavmd_tpu_torch.ops.ewald import (
    auto_kappa,
    ewald_exclusion_correction,
    ewald_exclusion_correction_strided,
    ewald_kspace_exact,
    ewald_self_energy,
)
from cavmd_tpu_torch.ops.lj import (
    LJPairMatrices,
    bond_exclusion_mask,
    fused_pair_force,
    lj_pair_tables,
)
from cavmd_tpu_torch.ops.pair_kernels import dense_pair_force
from cavmd_tpu_torch.ops.pppm import PPPMParams, pppm_force_and_energy
from cavmd_tpu_torch.ops.pppm_kernels import interpolate_grad, spread_grid

__all__ = [
    "harmonic_bond_force",
    "harmonic_bond_force_strided",
    "CavityParams",
    "cavity_force",
    "auto_kappa",
    "ewald_exclusion_correction",
    "ewald_exclusion_correction_strided",
    "ewald_kspace_exact",
    "ewald_self_energy",
    "LJPairMatrices",
    "bond_exclusion_mask",
    "fused_pair_force",
    "lj_pair_tables",
    "dense_pair_force",
    "PPPMParams",
    "pppm_force_and_energy",
    "interpolate_grad",
    "spread_grid",
]
