"""Console table writer: port of ``cavmd_tpu/io/text.py`` (parity:
``hoomd.write.Table`` restricted to performance/time metrics, reference
05_advanced_run.py:1268-1282)."""

from __future__ import annotations

import numpy as np

from cavmd_tpu_torch.core.units import PhysicalConstants


class TableWriter:
    """Prints timestep/tps/elapsed/ns-per-day/eta/dt rows periodically."""

    def __init__(self, performance_tracker, output_period_ps=1.0, file=None):
        self.perf = performance_tracker
        self.output_period_ps = output_period_ps
        self.last_output_ps = -1e30
        self.file = file
        self._header_written = False

    def _emit(self, line):
        if self.file is not None:
            self.file.write(line + "\n")
            self.file.flush()
        else:
            print(line, flush=True)

    def consume(self, obs, sim):
        t_ps = float(np.asarray(obs["time_au"])[-1]) * PhysicalConstants.TIME_PS_CONVERSION
        if t_ps - self.last_output_ps < self.output_period_ps:
            return
        self.last_output_ps = t_ps
        if not self._header_written:
            self._emit(
                f"{'timestep':>12} {'tps':>12} {'elapsed_ps':>12} "
                f"{'ns_per_day':>12} {'eta':>12} {'dt_fs':>10}"
            )
            self._header_written = True
        dt_fs = float(np.asarray(obs["dt"])[-1]) * PhysicalConstants.TIME_PS_CONVERSION * 1000
        self._emit(
            f"{int(np.asarray(obs['timestep'])[-1]):>12} {self.perf.tps:>12.1f} "
            f"{t_ps:>12.4f} {self.perf.ns_per_day:>12.3f} "
            f"{self.perf.eta_remaining:>12} {dt_fs:>10.4f}"
        )
