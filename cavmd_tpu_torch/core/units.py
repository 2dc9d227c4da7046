"""Unit system: Hartree atomic units with experiment-friendly conversions.

Parity with reference ``src/cavitymd/utils.py:9-65`` (PhysicalConstants) —
the framework works internally in Hartree atomic units (energy = Hartree,
length = Bohr, time = atomic time unit, mass = electron mass); user-facing
inputs are Kelvin, cm^-1, picoseconds, femtoseconds.
"""

from __future__ import annotations


class PhysicalConstants:
    """Conversion table between Hartree atomic units and laboratory units.

    The numeric values match reference ``src/cavitymd/utils.py:12-18`` to the
    last digit (a parity contract: K -> kT, cm^-1 -> omega_c, and ps -> a.u.
    conversions must reproduce the reference workflow's parameters exactly).
    """

    HARTREE_TO_CM_MINUS1 = 219474.63
    KB_HARTREE_PER_K = 3.167e-6  # Boltzmann constant in Hartree/K
    ENERGY_JOULES = 4.35974e-18  # Hartree to Joules
    LENGTH_METERS = 5.29177210544e-11  # Bohr to meters
    MASS_KG = 9.1093837139e-31  # Electron mass in kg
    TIME_SECONDS = 2.418884e-17  # Atomic time unit to seconds
    TIME_PS_CONVERSION = 2.418884e-5  # a.u. to picoseconds

    @classmethod
    def ps_to_atomic_units(cls, time_ps):
        """Convert time from picoseconds to atomic units."""
        return time_ps / cls.TIME_PS_CONVERSION

    @classmethod
    def atomic_units_to_ps(cls, time_au):
        """Convert time from atomic units to picoseconds."""
        return time_au * cls.TIME_PS_CONVERSION

    @classmethod
    def fs_to_atomic_units(cls, time_fs):
        """Convert time from femtoseconds to atomic units."""
        return cls.ps_to_atomic_units(time_fs / 1000.0)

    @classmethod
    def atomic_units_to_fs(cls, time_au):
        """Convert time from atomic units to femtoseconds."""
        return cls.atomic_units_to_ps(time_au) * 1000.0

    @classmethod
    def gamma_from_tau_ps(cls, tau_ps):
        """Langevin damping coefficient gamma = 1/tau, with tau given in ps.

        Parity: reference ``src/cavitymd/utils.py:46-65`` including the
        positivity check (overdamped tau -> 0 requires Brownian dynamics).
        """
        if tau_ps <= 0.0:
            raise ValueError(
                f"Langevin time constant tau_ps={tau_ps} is not a positive "
                "number; the damping rate is its reciprocal, which only exists "
                "for tau > 0. A vanishing tau means the overdamped limit — "
                "switch the method to Brownian dynamics rather than forcing "
                "an infinite gamma here."
            )
        tau_au = cls.ps_to_atomic_units(tau_ps)
        return 1.0 / tau_au

    @classmethod
    def kT_from_kelvin(cls, temperature_K):
        """Thermal energy kT in Hartree for a temperature in Kelvin."""
        return cls.KB_HARTREE_PER_K * temperature_K

    @classmethod
    def omega_from_cm1(cls, freq_cm1):
        """Angular frequency in a.u. from a wavenumber in cm^-1.

        Parity: reference ``examples/05_advanced_run.py:562``
        (``omegac = freq / HARTREE_TO_CM_MINUS1``).
        """
        return freq_cm1 / cls.HARTREE_TO_CM_MINUS1
