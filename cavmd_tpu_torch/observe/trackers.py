"""Trackers: host-side consumers of the per-chunk observable columns.

Port of ``cavmd_tpu/observe/trackers.py`` (the port's own copy; NumPy
only). The step computes everything on the device and the host receives
small per-step arrays once per chunk. Output files keep the JAX package's
names, header lines and number formats, so downstream analysis scripts
read either package's output. ``EnergyTracker`` formats each chunk's rows
through the native library (``io/native.py:format_table``) and in Python
only where there is no ``g++``, as the JAX package does; both give the
same bytes.
"""

from __future__ import annotations

import datetime
import time

import numpy as np

from cavmd_tpu_torch.core.units import PhysicalConstants


def _time_ps(obs):
    return np.asarray(obs["time_au"]) * PhysicalConstants.TIME_PS_CONVERSION


class BaseTracker:
    """Common infrastructure: output throttling by step period
    (parity: analysis.py:104-143)."""

    def __init__(self, output_prefix="tracker", output_period_steps=1000):
        self.output_prefix = output_prefix
        self.output_period_steps = output_period_steps
        self.last_output_step = 0

    def _output_rows(self, timesteps):
        """Indices of chunk rows that pass the step-period throttle."""
        rows = []
        last = self.last_output_step
        for i, ts in enumerate(np.asarray(timesteps)):
            if ts - last >= self.output_period_steps:
                rows.append(i)
                last = int(ts)
        if rows:
            self.last_output_step = last
        return rows

    def consume(self, obs):  # pragma: no cover - interface
        raise NotImplementedError


class EnergyTracker(BaseTracker):
    """The energy audit — writes ``{prefix}_energy_tracker.txt`` with the
    reference's exact column set (analysis.py:626-677, 997-1043), including
    the conserved universe energy = system + reservoirs. The energies of
    custom forces (``custom_<i>``) count in ``total_potential_energy`` and
    so in the system and universe columns, as ``universe_energy`` counts
    them; the JAX tracker leaves them out, so with a custom force its
    universe column is not the conserved quantity. Without custom forces
    the file is the JAX tracker's, byte for byte."""

    COLUMNS = (
        "time(ps) timestep harmonic_energy lj_energy ewald_short_energy "
        "ewald_long_energy cavity_harmonic_energy cavity_coupling_energy "
        "cavity_dipole_self_energy cavity_total_potential_energy "
        "molecular_kinetic_energy cavity_kinetic_energy total_kinetic_energy "
        "total_potential_energy system_total_energy "
        "molecular_reservoir_energy cavity_reservoir_energy "
        "total_reservoir_energy universe_total_energy temperature"
    )

    def __init__(
        self,
        output_prefix="energy",
        output_period_steps=1,
        max_time_ps=None,
        n_molecular_dof=None,
        compute_temperature=True,
    ):
        super().__init__(output_prefix, output_period_steps)
        self.max_time_ps = max_time_ps
        self.n_molecular_dof = n_molecular_dof
        self.compute_temperature = compute_temperature
        self.output_stopped = False
        self.path = f"{self.output_prefix}_energy_tracker.txt"
        # latest values for logging (parity: @hoomd.logging.log properties)
        self.current = {}
        with open(self.path, "w") as f:
            f.write("# Energy tracking (cavmd_tpu)\n")
            f.write(f"# Output period: {self.output_period_steps} steps\n")
            if self.max_time_ps:
                f.write(f"# Max time: {self.max_time_ps} ps\n")
            f.write("# All energies in Hartree (atomic units)\n")
            f.write(
                "#   universe_total_energy: system + reservoir [CONSERVED]\n"
            )
            f.write(self.COLUMNS + "\n")

    def consume(self, obs):
        if self.output_stopped:
            return
        t_ps = _time_ps(obs)
        ts = np.asarray(obs["timestep"])
        rows = self._output_rows(ts)
        if not rows:
            return

        e = {k: np.asarray(v) for k, v in obs.items()}
        cavity_total = (
            e["cavity_harmonic"] + e["cavity_coupling"] + e["cavity_dipole_self"]
        )
        total_kin = e["kinetic_molecular"] + e["kinetic_cavity"]
        total_pot = (
            e["harmonic"] + e["lj"] + e["ewald_short"] + e["ewald_long"]
            + cavity_total
        )
        # the custom forces' energies count, as in universe_energy (the
        # JAX tracker leaves them out of both columns)
        for k in e:
            if k.startswith("custom_"):
                total_pot = total_pot + e[k]
        mol_res = e["bussi_reservoir_molecular"] + e["langevin_reservoir_molecular"]
        cav_res = e["bussi_reservoir_cavity"] + e["langevin_reservoir_cavity"]
        system_total = total_pot + total_kin
        universe = system_total + mol_res + cav_res
        if self.n_molecular_dof:
            temperature = (
                2.0 * e["kinetic_molecular"]
                / (self.n_molecular_dof * PhysicalConstants.KB_HARTREE_PER_K)
            )
        else:
            temperature = np.zeros_like(total_kin)

        if self.max_time_ps is not None:
            kept = [i for i in rows if t_ps[i] <= self.max_time_ps]
            if len(kept) < len(rows):
                self.output_stopped = True
            rows = kept
        if not rows:
            return
        idx = np.asarray(rows)
        table = np.column_stack([
            t_ps[idx], ts[idx].astype(float),
            e["harmonic"][idx], e["lj"][idx],
            e["ewald_short"][idx], e["ewald_long"][idx],
            e["cavity_harmonic"][idx], e["cavity_coupling"][idx],
            e["cavity_dipole_self"][idx], cavity_total[idx],
            e["kinetic_molecular"][idx], e["kinetic_cavity"][idx],
            total_kin[idx], total_pot[idx], system_total[idx],
            mol_res[idx], cav_res[idx], (mol_res + cav_res)[idx],
            universe[idx], temperature[idx],
        ])
        # the whole chunk in one pass of the native formatter
        from cavmd_tpu_torch.io.native import format_table

        text = format_table(table, decimals=6, int_col=1)
        if text is None:
            lines = []
            for row in table:
                lines.append(
                    " ".join(
                        str(int(v)) if j == 1 else f"{v:.6f}"
                        for j, v in enumerate(row)
                    )
                )
            text = "\n".join(lines) + "\n"
        with open(self.path, "a") as f:
            f.write(text)
        # retain the last row for logger integration
        i = rows[-1]
        self.current = dict(
            total_energy=float(system_total[i]),
            universe_total_energy=float(universe[i]),
            total_potential_energy=float(total_pot[i]),
            kinetic_energy=float(total_kin[i]),
            total_reservoir_energy=float(mol_res[i] + cav_res[i]),
            temperature=float(temperature[i]),
        )


class CavityModeTracker(BaseTracker):
    """Photon-mode observable file ``{prefix}_cavity_mode.txt``
    (parity: analysis.py:1285-1418)."""

    def __init__(self, output_prefix="cavity_mode", output_period_steps=1000):
        super().__init__(output_prefix, output_period_steps)
        self.path = f"{self.output_prefix}_cavity_mode.txt"
        self.current = {}
        with open(self.path, "w") as f:
            f.write("# Cavity mode tracking\n")
            f.write(f"# Output period: {self.output_period_steps} steps\n")
            f.write(
                "# timestep time(ps) cavity_kinetic_energy "
                "cavity_potential_energy cavity_total_energy cavity_temperature\n"
            )

    def consume(self, obs):
        t_ps = _time_ps(obs)
        ts = np.asarray(obs["timestep"])
        ke = np.asarray(obs["kinetic_cavity"])
        pe = np.asarray(obs["cavity_harmonic"])
        total = ke + pe
        temp = (2.0 / 3.0) * ke / PhysicalConstants.KB_HARTREE_PER_K
        rows = self._output_rows(ts)
        if not rows:
            return
        with open(self.path, "a") as f:
            for i in rows:
                f.write(
                    f"{int(ts[i])} {t_ps[i]:.6f} {ke[i]:.6f} {pe[i]:.6f} "
                    f"{total[i]:.6f} {temp[i]:.6f}\n"
                )
        i = rows[-1]
        self.current = dict(
            cavity_kinetic_energy=float(ke[i]),
            cavity_potential_energy_harmonic=float(pe[i]),
            cavity_total_energy=float(total[i]),
            cavity_temperature=float(temp[i]),
        )


class AutocorrelationTracker(BaseTracker):
    """C(t) = O(0).O(t) for simple observables, new reference every 10000
    steps (parity: analysis.py:152-253). Requires the observable stream in
    obs under ``self.key`` (e.g. 'dipole')."""

    def __init__(self, key="dipole", output_prefix=None, output_period_steps=1000,
                 new_reference_every=10000):
        output_prefix = output_prefix or f"{key}_autocorr"
        super().__init__(output_prefix, output_period_steps)
        self.key = key
        self.new_reference_every = new_reference_every
        self.reference_value = None
        self.reference_step = 0
        self.output_file_number = 0
        self.current_autocorr = 0.0

    def _path(self):
        return f"{self.output_prefix}_{self.output_file_number}.txt"

    def _write_header(self, timestep, t_ps, c0):
        with open(self._path(), "w") as f:
            f.write(f"# {self.key.capitalize()} autocorrelation data\n")
            f.write(f"# Reference number: {self.output_file_number}\n")
            f.write(f"# Output period: {self.output_period_steps} steps\n")
            f.write("# timestep t(ps) C(t)\n")
            f.write(f"{timestep} {t_ps:.6f} {c0:.6f}\n")

    def consume(self, obs):
        vals = np.asarray(obs[self.key])  # (n, d)
        ts = np.asarray(obs["timestep"])
        t_ps = _time_ps(obs)
        lines = []
        for i in range(len(ts)):
            if self.reference_value is None:
                self.reference_value = vals[i]
                self.reference_step = int(ts[i])
                c0 = float(vals[i] @ vals[i])
                self.current_autocorr = c0
                self._write_header(int(ts[i]), t_ps[i], c0)
                continue
            c = float(self.reference_value @ vals[i])
            self.current_autocorr = c
            if ts[i] - self.last_output_step >= self.output_period_steps:
                lines.append((self._path(), f"{int(ts[i])} {t_ps[i]:.6f} {c:.6f}\n"))
                self.last_output_step = int(ts[i])
                # Rotate on elapsed steps since the last reference (the
                # reference rotates on counter >= threshold,
                # analysis.py:213-222); an exact-modulo check would never
                # fire when the output period doesn't divide the interval.
                if ts[i] - self.reference_step >= self.new_reference_every:
                    self.output_file_number += 1
                    self.reference_value = vals[i]
                    self.reference_step = int(ts[i])
                    c0 = float(vals[i] @ vals[i])
                    self._write_header(int(ts[i]), t_ps[i], c0)
        # group writes per file
        by_file = {}
        for path, line in lines:
            by_file.setdefault(path, []).append(line)
        for path, ls in by_file.items():
            with open(path, "a") as f:
                f.writelines(ls)


class DipoleAutocorrelation(AutocorrelationTracker):
    """Convenience alias (parity: analysis.py:1424-1446)."""

    def __init__(self, output_prefix="dipole_autocorr", output_period_steps=1000):
        super().__init__("dipole", output_prefix, output_period_steps)


class FieldAutocorrelationTracker(BaseTracker):
    """F(k,t) multi-reference field autocorrelation
    (parity: analysis.py:260-418). Consumes the 'rho_k_re'/'rho_k_im'
    streams; references rotate on a time interval (preferred under adaptive
    dt) up to ``max_references``, each with its own ``{prefix}_ref{n}.txt``."""

    def __init__(
        self,
        output_prefix="density_correlation_field_autocorr",
        output_period_steps=1,
        reference_interval_ps=1.0,
        max_references=10,
    ):
        super().__init__(output_prefix, output_period_steps)
        self.reference_interval_ps = reference_interval_ps
        self.max_references = max_references
        self.references = []  # list of dicts
        self.last_reference_time_ps = 0.0
        self.current_autocorr = 0.0

    def _new_reference(self, field, timestep, t_ps):
        n = len(self.references)
        path = f"{self.output_prefix}_ref{n}.txt"
        self.references.append(
            dict(number=n, filename=path, timestep=int(timestep), time=float(t_ps),
                 field=field)
        )
        self.last_reference_time_ps = float(t_ps)
        with open(path, "w") as f:
            f.write("# Density_correlation field autocorrelation\n")
            f.write(f"# Reference {n} at t={t_ps:.6f} ps\n")
            f.write(f"# Output period: {self.output_period_steps} steps\n")
            f.write("# timestep lag_time(ps) field_autocorr\n")

    def consume(self, obs):
        re = np.asarray(obs["rho_k_re"])
        im = np.asarray(obs["rho_k_im"])
        ts = np.asarray(obs["timestep"])
        t_ps = _time_ps(obs)
        buffered = {}
        for i in range(len(ts)):
            field = re[i] + 1j * im[i]
            if not self.references:
                self._new_reference(field, ts[i], t_ps[i])
                continue
            should_output = ts[i] - self.last_output_step >= self.output_period_steps
            for ref in self.references:
                c = float(np.mean(np.real(ref["field"] * np.conj(field))))
                if ref["number"] == 0:
                    self.current_autocorr = c
                if should_output:
                    lag = t_ps[i] - ref["time"]
                    buffered.setdefault(ref["filename"], []).append(
                        f"{int(ts[i])} {lag:.6f} {c:.6f}\n"
                    )
            if should_output:
                self.last_output_step = int(ts[i])
            if (
                len(self.references) < self.max_references
                and t_ps[i] - self.last_reference_time_ps >= self.reference_interval_ps
            ):
                self._new_reference(field, ts[i], t_ps[i])
        for path, lines in buffered.items():
            with open(path, "a") as f:
                f.writelines(lines)


class ElapsedTimeTracker:
    """Physical elapsed time accumulator + runtime termination signal
    (parity: analysis.py:1219-1264 — but instead of ``sys.exit(0)`` inside
    the step loop, the Simulation's chunked runner polls ``done``)."""

    def __init__(self, runtime_ps):
        self.runtime_ps = runtime_ps
        self.elapsed_time = 0.0  # ps

    def consume(self, obs):
        self.elapsed_time = float(_time_ps(obs)[-1])

    @property
    def done(self):
        return self.elapsed_time >= self.runtime_ps


class TimestepFormatter:
    """dt in femtoseconds for logging (parity: analysis.py:1267-1282)."""

    def __init__(self):
        self.dt_fs = 0.0

    def consume(self, obs):
        self.dt_fs = float(
            np.asarray(obs["dt"])[-1] * PhysicalConstants.TIME_PS_CONVERSION * 1000.0
        )


class Status:
    """Status monitor: ETA / ns-per-day / dt strings for logging
    (parity: reference analysis.py:1119-1216). Wraps a Simulation and an
    optional ElapsedTimeTracker."""

    def __init__(self, simulation, runtime_ps, time_tracker=None):
        self.sim = simulation
        self.runtime_ps = runtime_ps
        self.time_tracker = time_tracker
        self.start = datetime.datetime.now()

    def _elapsed_ps(self):
        if self.time_tracker is not None:
            return self.time_tracker.elapsed_time
        return self.sim.elapsed_ps

    @property
    def seconds_remaining(self):
        done = self._elapsed_ps()
        wall = (datetime.datetime.now() - self.start).total_seconds()
        if done <= 0:
            return 0
        return max(0.0, (self.runtime_ps / done) * wall - wall)

    @property
    def etr(self):
        return str(datetime.timedelta(seconds=int(self.seconds_remaining)))

    @property
    def nsd(self):
        wall = (datetime.datetime.now() - self.start).total_seconds()
        if wall <= 0:
            return "0.0"
        return str(round(self._elapsed_ps() / wall / 1000.0 * 86400.0, 6))

    @property
    def elapsed(self):
        return str(datetime.datetime.now() - self.start)


class PerformanceTracker:
    """ns/day + ETA from wall clock (parity: 05_advanced_run.py:88-139 and
    Status, analysis.py:1119-1216)."""

    def __init__(self, runtime_ps):
        self.runtime_ps = runtime_ps
        self.start_time = time.time()
        self.ns_per_day = 0.0
        self.eta_remaining = ""
        self.steps_done = 0
        self.tps = 0.0

    def consume(self, obs):
        sim_ps = float(_time_ps(obs)[-1])
        self.steps_done = int(np.asarray(obs["timestep"])[-1])
        wall = time.time() - self.start_time
        if wall > 0:
            self.tps = self.steps_done / wall
            self.ns_per_day = sim_ps / wall / 1000.0 * 86400.0
            if sim_ps > 0:
                remaining = (self.runtime_ps / sim_ps) * wall - wall
                self.eta_remaining = str(
                    datetime.timedelta(seconds=max(0, int(remaining)))
                )
