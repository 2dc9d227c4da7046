"""The large-N workload builder.

Port of ``cavmd_tpu/drivers/workloads.py``: the same scene, force mix,
methods and time step. The JAX builder returns a jitted chunk runner and
its state; this one returns a ``Simulation``, whose ``run`` is the port's
chunk runner (with the cell-list overflow retry).
"""

from __future__ import annotations


def build_large_n(n_mol=50_000, *, mesh=(32, 32, 32), pair_mode="cell",
                  seed=0, dt_fs=0.25, device=None):
    """The large-N stress workload: ``n_mol`` diatomics + the cavity
    photon at the reference density, the full force mix (cavity + bonds +
    LJ + Ewald short + PPPM) in ``pair_mode`` ('cell' or 'zcol'), Bussi
    molecular bath + Langevin cavity bath (both tau 5 ps, 100 K), float32.
    Returns ``(sim, snap, ff)``; the Simulation's generators are seeded
    with 7, as the JAX builder seeds its state. ``device=None`` is the CUDA
    device.

    At ``n_mol=50_000`` (N = 100,001, box 269.01 bohr) the cell grid is
    17^3 with bucket capacity 45; the zcol grid 17 x 17 columns of
    capacity 512 with a visit window of 8 blocks.
    """
    import torch

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.core import add_cavity_particle, make_diatomic_system
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.integrate import ForceField, MethodSpec
    from cavmd_tpu_torch.simulation import Simulation

    snap = make_diatomic_system(
        n_mol, box_L=reference_box_for(n_mol), temperature_K=100.0,
        seed=seed, dtype=torch.float64, device=device,
    )
    snap = add_cavity_particle(snap, coupling=1e-3, freq_cm1=2000.0,
                               temperature_K=100.0, seed=seed + 1)
    snap = snap.astype(torch.float32)
    ff = ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                           dtype=torch.float32, pair_mode=pair_mode,
                           pppm_mesh=tuple(mesh))
    kT = PC.kT_from_kelvin(100.0)
    methods = (
        MethodSpec(kind="bussi", group="molecular", kT=kT,
                   tau=PC.ps_to_atomic_units(5.0)),
        MethodSpec(kind="langevin", group="cavity", kT=kT,
                   gamma=PC.gamma_from_tau_ps(5.0)),
    )
    sim = Simulation(snap, ff, methods, dt=PC.fs_to_atomic_units(dt_fs),
                     seed=7)
    return sim, snap, ff
