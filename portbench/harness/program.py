"""The one module that talks to the program under test
(``cavmd_tpu_torch``): it builds the configuration's force field,
methods, replica batch and chunk runner through the program's public
entries, and runs a chunk with the overflow retry of the program's
facade and CLI (``Simulation._grow_cell_capacity``,
``run_vmapped_replicas``): a chunk whose list overflowed is re-planned
and run again from its start, and each re-plan is counted.

Path modes: 'cell' and 'zcol' run ``run_replica_steps(make_step_fn(ff,
methods), state, n)`` on the unsharded batch; 'slab' runs
``make_domain_runner(ff, methods, plan, rebuild_every=k)`` over one slab.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_RETRIES = 4
# the program's random streams (cavmd_tpu_torch/integrate/rng.py) and the
# index of each bath in the methods tuple built below
BUSSI_STREAM = (1, 0)
LANGEVIN_STREAM = (2, 1)


def units(cfg):
    u, p = cfg["units"], cfg["physics"]
    to_au = 1.0 / float(u["ps_per_au"])
    kT = float(u["kB_hartree_per_K"]) * float(p["temperature_K"])
    return dict(kT=kT, dt=float(p["dt_fs"]) * 1e-3 * to_au,
                tau=float(p["bussi_tau_ps"]) * to_au,
                gamma=1.0 / (float(p["langevin_tau_ps"]) * to_au))


class Program:
    """The configuration's system under test on ``device``, with a
    replica batch of ``replicas`` built from the scene and velocities."""

    def __init__(self, cfg: dict, scene: dict, velocity, replicas: int,
                 seed: int, device):
        from cavmd_tpu_torch.core.snapshot import Snapshot
        from cavmd_tpu_torch.integrate import ForceField, MethodSpec
        from cavmd_tpu_torch.integrate.integrator import resolve_methods
        from cavmd_tpu_torch.parallel.replicas import init_replica_states

        phys, path = cfg["physics"], cfg["path"]
        dtype = getattr(torch, phys["dtype"])
        self.mode = path["mode"]
        self.snap = Snapshot.create(
            position=scene["position"], box_L=scene["box"],
            image=scene["image"], mass=scene["mass"], charge=scene["charge"],
            typeid=scene["typeid"], types=scene["types"],
            bond_group=scene["bond_group"],
            bond_typeid=scene["bond_typeid"],
            bond_types=scene["bond_types"], dtype=dtype, device=device)
        lj = {tuple(k.split("-")): dict(v) for k, v in phys["lj"].items()}
        ff = ForceField.create(
            self.snap, coupling=float(phys["coupling"]),
            freq_cm1=float(phys["freq_cm1"]),
            phmass=float(cfg["scene"]["photon_mass"]), lj_params=lj,
            bond_params={k: dict(v) for k, v in phys["bonds"].items()},
            r_cut=float(phys["r_cut"]), pppm_mesh=tuple(phys["pppm_mesh"]),
            pppm_order=int(phys["pppm_order"]),
            ewald_accuracy=float(phys["ewald_accuracy"]), kappa_mode="erfc",
            pair_mode="zcol" if self.mode == "zcol" else "cell",
            cell_skin=float(path["skin"]), cell_cap=path.get("cap"),
            dtype=dtype, device=device)
        if self.mode == "zcol" and "window" in path:
            ff.zcol_W = int(path["window"])
        self.ff = ff
        u = units(cfg)
        self.methods = resolve_methods(self.snap, (
            MethodSpec(kind="bussi", group="molecular", kT=u["kT"],
                       tau=u["tau"]),
            MethodSpec(kind="langevin", group="cavity", kT=u["kT"],
                       gamma=u["gamma"])), ff.l_typeid)
        state = init_replica_states(self.snap, ff, n_replicas=replicas,
                                    dt=u["dt"], seed=seed)
        self.state = state.replace(velocity=velocity.to(dtype))
        self.replans = 0
        self.plan = self.step = None
        if self.mode == "slab":
            from cavmd_tpu_torch.parallel.domain import plan_domain

            self.plan = plan_domain(self.snap, ff, 1,
                                    skin=float(path["skin"]),
                                    cap=path.get("cap"))
            for k in ("nb_cap", "ns_cap"):
                if k in path and getattr(self.plan, k) != int(path[k]):
                    raise ValueError(
                        f"the program plans {k}={getattr(self.plan, k)}, "
                        f"the configuration fixes {path[k]}: the work "
                        "is not the configuration's")
            self.rebuild_every = int(path["rebuild_every"])
            self.state = self.state.replace(cell_list=None, cell_anchor=None)
        self._build()

    def _build(self):
        if self.mode == "slab":
            from cavmd_tpu_torch.parallel.domain import make_domain_runner

            self._run = make_domain_runner(self.ff, self.methods, self.plan,
                                           rebuild_every=self.rebuild_every)
        else:
            from cavmd_tpu_torch.integrate import make_step_fn
            from cavmd_tpu_torch.parallel.replicas import run_replica_steps

            self.step = make_step_fn(self.ff, self.methods)
            self._run = lambda st, n: run_replica_steps(self.step, st, n)

    def plan_text(self) -> str:
        if self.plan is not None:
            p = self.plan
            return (f"cap={p.cap} nb_cap={p.nb_cap} ns_cap={p.ns_cap} "
                    f"rebuild_every={self.rebuild_every}")
        w = "" if self.ff.zcol_W is None else f" window={self.ff.zcol_W}"
        return f"cap={self.ff.cell_cfg.cap}{w}"

    def _replan(self, obs):
        """Grow what the overflow points at: the facade's rule."""
        self.replans += 1
        if self.plan is not None:
            cap_flag = obs.get("domain_capacity_overflow")
            if cap_flag is not None and cap_flag.any():
                self.plan = self.plan.grow_cap()
            else:
                self.rebuild_every = max(1, self.rebuild_every // 2)
        else:
            cap = self.ff.cell_cfg.cap
            self.ff = self.ff.with_cell_capacity(max(cap + 4, 2 * cap))
        self._build()

    def generator_states(self) -> dict:
        return {k: g.get_state() for k, g in self.state.generators.items()}

    def run_chunk(self, n: int):
        """Run ``n`` steps of the batch with the overflow retry. Returns
        (the chunk's start state, its generator states, the observables,
        whether the chunk had to be run again)."""
        from cavmd_tpu_torch.simulation import retry_state

        start = self.state
        rng = self.generator_states()
        retried = False
        for attempt in range(MAX_RETRIES + 1):
            state, obs = self._run(start if attempt == 0 else self.state, n)
            if not np.any(obs["cell_overflow"]):
                self.state = state
                return start, rng, obs, retried
            if attempt == MAX_RETRIES:
                raise RuntimeError(f"overflow persists after {MAX_RETRIES} "
                                   f"re-plans ({self.plan_text()})")
            retried = True
            self._replan(obs)
            self.state = retry_state(self.ff, start, rng)
        raise AssertionError("unreachable")
