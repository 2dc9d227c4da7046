"""The comparison that decides ``correct``.

What is judged is what the window's timed path produced:

- the trajectory: sampled replicas (one from each half of the batch,
  drawn from the seed) are followed by the reference through the
  window's last chunk, from the program's own state at that chunk's start
  and with the same random draws (the program's generator states at that
  start), and the program's final positions and velocities are compared
  with the reference's (``dx_bohr``, ``dv_rel``);
- the forces and energies the last step computed, on the final positions
  of the sampled replicas (``f_rel``, ``e_rel``);
- the start: the forces the set-up computed on the scene's positions
  (``f0_rel``).

The reference can only follow from the program's state: the chunks before
the last run the same call, and the start is checked by itself.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from portbench.harness.scene import seed_words
from portbench.reference.integrate import Bath, follow
from portbench.reference.physics import ENERGY_KEYS, Forces, Topology

NUMBERS = ("dx_bohr", "dv_rel", "f_rel", "e_rel", "f0_rel")
CHECKS = Path(__file__).resolve().parents[1] / "checks"


def limits(workload: str) -> dict:
    return json.loads((CHECKS / f"{workload}.json").read_text())


def followed_rows(seed: int, replicas: int) -> list:
    """One replica from each half of the batch, drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence(seed_words(seed, 3)))
    half = max(1, replicas // 2)
    rows = [int(rng.integers(0, half))]
    if replicas > 1:
        rows.append(int(rng.integers(half, replicas)))
    return rows


class Capture:
    """What the check needs of the program's run, copied out of its
    state so the program can be freed first."""

    def __init__(self, start, rng: dict, final, obs: dict, rows: list,
                 f0, streams: tuple):
        def take(x):
            return x[rows].detach().clone()

        self.rows = rows
        self.replicas = start.position.shape[0]
        self.steps = len(obs["timestep"])
        self.a_pos, self.a_img, self.a_vel = (take(start.position),
                                              take(start.image),
                                              take(start.velocity))
        self.a_res = {"bussi": take(start.bussi_reservoir[:, 0]),
                      "langevin": take(start.langevin_reservoir[:, 1])}
        self.gens = {"bussi": rng[streams[0]].clone(),
                     "langevin": rng[streams[1]].clone()}
        self.x, self.img, self.v, self.f = (take(final.position),
                                            take(final.image),
                                            take(final.velocity),
                                            take(final.forces))
        self.e = {k: torch.as_tensor(np.asarray(obs[k])[-1, rows])
                  for k in ENERGY_KEYS}
        self.f0 = f0.detach().clone()


class CapturedNoise:
    """The program's draws, from copies of its generators: the Bussi
    (2, B) and photon Langevin (B, 1, 3) draws of each step, each drawn
    for the whole batch in the program's dtype, the sampled rows kept."""

    def __init__(self, cap: Capture, device):
        self.rows = cap.rows
        self.B = cap.replicas
        self.dtype = cap.a_pos.dtype
        self.device = device
        self.g = {}
        for k, s in cap.gens.items():
            g = torch.Generator(device=device)
            g.set_state(s)
            self.g[k] = g

    def bussi(self, R):
        d = torch.randn((2, self.B), generator=self.g["bussi"],
                        dtype=self.dtype, device=self.device)
        return d[0, self.rows], d[1, self.rows]

    def langevin(self, R):
        d = torch.randn((self.B, 1, 3), generator=self.g["langevin"],
                        dtype=self.dtype, device=self.device)
        return d[self.rows]


def _rms(x):
    return torch.sqrt(torch.mean(torch.sum(x * x, dim=-1)))


class Judge:
    """The float64 reference's readings of one run's outputs."""

    def __init__(self, cfg: dict, scene: dict, device, dtype=torch.float64):
        self.cfg, self.scene, self.device = cfg, scene, device
        self.top = Topology(cfg, scene, dtype, device)
        self.bath = Bath(cfg, self.top)
        self.dtype = dtype
        self._f0_ref = None

    def start_forces(self):
        if self._f0_ref is None:
            p = torch.as_tensor(self.scene["position"], dtype=self.dtype,
                                device=self.device)[None]
            img = torch.as_tensor(self.scene["image"],
                                  device=self.device)[None].long()
            self._f0_ref = Forces(self.top)(p, img)[0][0]
        return self._f0_ref

    def followed(self, cap: Capture):
        """The reference's positions and velocities after the last chunk."""
        d = self.dtype
        x, _, v, _, _ = follow(
            self.top, Forces(self.top), self.bath, cap.a_pos.to(d),
            cap.a_img.long(), cap.a_vel.to(d),
            {k: t.to(d) for k, t in cap.a_res.items()},
            CapturedNoise(cap, self.device), cap.steps)
        return x, v

    def numbers(self, out: dict, cap: Capture) -> dict:
        """The compared numbers of outputs ``out`` (x, img, v, f, e, f0)
        of the stretch ``cap`` describes."""
        d = self.dtype
        x_ref, v_ref = self.followed(cap)
        box = self.top.box
        dx = out["x"].to(d) - x_ref
        dx = dx - box * torch.round(dx / box)
        dx_max = float(torch.sqrt((dx * dx).sum(-1)).max())
        thermal = torch.sqrt(self.bath.kT / self.top.mass)
        dv = float((torch.sqrt(((out["v"].to(d) - v_ref) ** 2).sum(-1))
                    / thermal).max())
        f_ref, e_ref = Forces(self.top)(out["x"].to(d), out["img"].long())
        f_rel = float(max(torch.sqrt(((out["f"][r].to(d) - f_ref[r]) ** 2)
                                     .sum(-1)).max() / _rms(f_ref[r])
                          for r in range(len(cap.rows))))
        scale = sum(torch.abs(e_ref[k]) for k in ENERGY_KEYS)
        e_rel = float(max(torch.max(torch.abs(
            out["e"][k].to(self.device, d) - e_ref[k]) / scale)
            for k in ENERGY_KEYS))
        f0 = self.start_forces()
        f0_rel = float(torch.sqrt(((out["f0"].to(d) - f0) ** 2).sum(-1)).max()
                       / _rms(f0))
        return dict(dx_bohr=dx_max, dv_rel=dv, f_rel=f_rel, e_rel=e_rel,
                    f0_rel=f0_rel)


def program_outputs(cap: Capture) -> dict:
    return dict(x=cap.x, img=cap.img, v=cap.v, f=cap.f, e=cap.e, f0=cap.f0)


def control_outputs(cfg: dict, scene: dict, cap: Capture, device,
                    work=torch.bfloat16) -> dict:
    """The reference put in the program's place with its force arithmetic
    in ``work`` precision (the state carried in the program's float32: in
    bfloat16 the box's coordinates are 1-2 bohr apart, atoms merge and
    the run gives no number): the same stretch followed, its forces and
    energies, its start forces."""
    dtype = cap.a_pos.dtype
    top = Topology(cfg, scene, dtype, device, work)
    x, img, v, f, obs = follow(
        top, Forces(top), Bath(cfg, top), cap.a_pos.to(dtype),
        cap.a_img.long(), cap.a_vel.to(dtype),
        {k: t.to(dtype) for k, t in cap.a_res.items()},
        CapturedNoise(cap, device), cap.steps)
    p0 = torch.as_tensor(scene["position"], dtype=dtype, device=device)[None]
    i0 = torch.as_tensor(scene["image"], device=device)[None].long()
    f0 = Forces(top)(p0, i0)[0][0]
    return dict(x=x, img=img, v=v, f=f,
                e={k: obs[k] for k in ENERGY_KEYS}, f0=f0)


def verdict(numbers: dict, lim: dict) -> tuple:
    """(correct, {name: [number, limit]}): correct when every number is
    finite and at most its limit."""
    table = {k: [numbers[k], lim[k]] for k in NUMBERS}
    ok = all(math.isfinite(v) and v <= m for v, m in table.values())
    return ok, table
