#!/usr/bin/env python3
"""Polariton physics validation on the PyTorch/CUDA port: vacuum Rabi
splitting of a single molecular vibration resonantly coupled to the
cavity mode.

This is the phenomenon the whole framework exists to simulate
(vibrational strong coupling): at resonance the photon and the molecular
vibration hybridize into upper and lower polaritons split by

    Omega_R ~ g q_c / (sqrt(mu m_ph) * omega)

The script runs one O-O 'molecule' (partial charges +-q) resonant with
the cavity in NVE (float64), Fourier-transforms the photon trajectory,
and reports the two polariton peaks against the analytic splitting. With
g = 0 the spectrum collapses to a single line at the bare frequency. LJ
and Coulomb are off, so no pair kernel runs; the spectral resolution is
the bare frequency over ``n_periods``.

    python examples/07_polariton_rabi_splitting_torch.py [--device CPU]
        [--n-periods 800]
"""

import argparse

import numpy as np
import torch

from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.core.device import resolve_device
from cavmd_tpu_torch.core.snapshot import Snapshot, add_cavity_particle
from cavmd_tpu_torch.integrate import (
    ForceField,
    MethodSpec,
    init_state,
    make_step_fn,
    resolve_methods,
    run_steps,
)
from cavmd_tpu_torch.observe import spectrum_from_signal

M_O = 15.999 * 1822.888486
K_BOND = 2 * 0.36602
R0 = 2.281655158


def photon_spectrum_peaks(g, q_charge=0.35, n_periods=800, threshold=0.1,
                          device=None):
    """Run the resonant one-molecule system; returns a dict: ``peaks``
    (the photon spectrum's peaks above ``threshold`` of its maximum,
    cm^-1), ``qx`` (the photon's x a step), ``freqs`` and ``spectrum``,
    ``omega_mol`` (a.u.) and ``freq_cm1`` (the bare frequency)."""
    dev = resolve_device(device)
    mu = M_O / 2
    omega_mol = np.sqrt(K_BOND / mu)
    freq_cm1 = omega_mol * PC.HARTREE_TO_CM_MINUS1

    pos = np.array([[-R0 / 2, 0, 0], [R0 / 2, 0, 0]])
    snap = Snapshot.create(
        position=pos, box_L=[60.0, 60.0, 60.0], mass=[M_O, M_O],
        charge=[q_charge, -q_charge], typeid=[0, 0], types=("O", "N"),
        bond_group=[[0, 1]], bond_typeid=[0], bond_types=("O-O",),
        device=dev,
    )
    snap = add_cavity_particle(
        snap, coupling=0.0, freq_cm1=freq_cm1, temperature_K=10.0, seed=1
    )

    # photon at its finite-q equilibrium for the static bond dipole, then a
    # small kick (large offsets drive the |r| bond nonlinearity)
    p = snap.position.cpu().numpy()
    d_static = q_charge * p[0, 0] - q_charge * p[1, 0]
    K = omega_mol**2
    p[-1] = [-g * d_static / K + 0.02, 0.0, 0.0]
    p[1, 0] += 0.005
    snap = snap.replace(position=torch.as_tensor(p, device=dev))

    ff = ForceField.create(
        snap, coupling=g, freq_cm1=freq_cm1,
        enable_coulomb=False, enable_lj=False,
    )
    methods = resolve_methods(
        snap, (MethodSpec(kind="nve", group="all"),), ff.l_typeid
    )
    step = make_step_fn(ff, methods)

    dt = (2 * np.pi / omega_mol) / 80
    n = 80 * n_periods
    state = init_state(snap, ff, dt=dt, seed=0)

    def step_q(st):
        ns, obs = step(st)
        obs["qx"] = ns.position[-1, 0]
        return ns, obs

    _, obs = run_steps(step_q, state, n)
    qx = obs["qx"]
    # library spectrum route (observe/spectra.py); dt is atomic units
    freqs, spec = spectrum_from_signal(qx, float(dt) * PC.TIME_PS_CONVERSION)

    mask = spec > threshold * spec.max()
    peaks, i = [], 0
    while i < len(mask):
        if mask[i]:
            j = i
            while j < len(mask) and mask[j]:
                j += 1
            seg = slice(i, j)
            peaks.append(float(freqs[seg][np.argmax(spec[seg])]))
            i = j
        else:
            i += 1
    return dict(peaks=peaks, qx=qx, freqs=freqs, spectrum=spec,
                omega_mol=omega_mol, freq_cm1=freq_cm1)


def main(n_periods=800, device=None):
    """Run the example; returns its figures: ``bare_cm1``, the peaks at
    g = 0 and at g = 1e-3 (``peaks_g0``, ``peaks``, cm^-1), the photon
    series of both runs (``qx_g0``, ``qx``), ``splitting_cm1`` (None
    unless two peaks), ``analytic_cm1`` and ``bin_cm1`` (the spectrum's
    resolution)."""
    g = 1e-3
    q_c = 0.35
    bare = photon_spectrum_peaks(0.0, n_periods=n_periods, device=device)
    coupled = photon_spectrum_peaks(g, n_periods=n_periods, device=device)
    mu = M_O / 2
    rabi_analytic = ((g * q_c / np.sqrt(mu) / bare["omega_mol"])
                     * PC.HARTREE_TO_CM_MINUS1)
    peaks = coupled["peaks"]
    out = dict(bare_cm1=bare["freq_cm1"], peaks_g0=bare["peaks"],
               peaks=peaks, qx_g0=bare["qx"], qx=coupled["qx"],
               splitting_cm1=peaks[1] - peaks[0] if len(peaks) == 2
               else None,
               analytic_cm1=rabi_analytic,
               bin_cm1=float(coupled["freqs"][1] - coupled["freqs"][0]))
    print(f"bare resonance: {out['bare_cm1']:.1f} cm^-1")
    print(f"g = 0      -> peaks {bare['peaks']}")
    print(f"g = {g}    -> peaks {peaks}")
    if out["splitting_cm1"] is not None:
        print(f"Rabi splitting: {out['splitting_cm1']:.1f} cm^-1 "
              f"(analytic ~{rabi_analytic:.1f})")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("GPU", "CPU"), default="GPU")
    ap.add_argument("--n-periods", type=int, default=800)
    args = ap.parse_args()
    main(n_periods=args.n_periods,
         device="cpu" if args.device == "CPU" else None)
