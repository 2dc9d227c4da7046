"""Energy minimization (displacement-capped FIRE).

Port of ``cavmd_tpu/utils/minimize.py``: the generated replacement scene
is relaxed before production MD. Every branch of FIRE is a
``torch.where`` on device tensors, so the loop never reads back from the
device; it runs a fixed number of steps, as the JAX package does.
"""

from __future__ import annotations

import torch

from cavmd_tpu_torch.core.box import rewrap
from cavmd_tpu_torch.core.snapshot import Snapshot


def fire_minimize(snapshot: Snapshot, ff, *, n_steps: int = 500,
                  dt: float = 4.0, max_disp: float = 0.1,
                  f_alpha: float = 0.99, exclude_types: tuple = ("L",)):
    """FIRE minimization of the force-field energy. Returns a new Snapshot.

    Particles whose type is in ``exclude_types`` (the photon) are frozen.
    """
    dtype = snapshot.position.dtype
    frozen = torch.zeros(snapshot.N, dtype=torch.bool,
                         device=snapshot.device)
    for t in exclude_types:
        if t in snapshot.types:
            frozen = frozen | (snapshot.typeid == snapshot.types.index(t))
    mobile = (~frozen)[:, None].to(dtype)
    tiny = torch.finfo(dtype).tiny

    pos, image = snapshot.position, snapshot.image
    vel = torch.zeros_like(pos)
    alpha = torch.full((), 0.1, dtype=dtype, device=snapshot.device)
    dt_cur = torch.full((), dt, dtype=dtype, device=snapshot.device)
    with torch.no_grad():
        for _ in range(n_steps):
            f, _ = ff(pos, image, snapshot.box_L, snapshot.charge,
                      snapshot.typeid)
            f = f * mobile
            # FIRE velocity mixing
            power = torch.sum(f * vel)
            fnorm = torch.sqrt(torch.sum(f * f)) + tiny
            vnorm = torch.sqrt(torch.sum(vel * vel))
            vel = (1.0 - alpha) * vel + alpha * vnorm * f / fnorm
            # reset on uphill
            downhill = power > 0
            vel = torch.where(downhill, vel, torch.zeros_like(vel))
            alpha = torch.where(downhill, alpha * f_alpha,
                                torch.full_like(alpha, 0.1))
            dt_cur = torch.where(
                downhill, torch.clamp_max(dt_cur * 1.1, dt * 4.0),
                dt_cur * 0.5)
            vel = vel + dt_cur * f  # unit-mass descent dynamics
            disp = dt_cur * vel
            # cap the displacement per step
            dmax = torch.sqrt(torch.max(torch.sum(disp * disp, dim=1)))
            scale = torch.clamp_max(
                max_disp / torch.clamp_min(dmax, 1e-30), 1.0)
            pos, image = rewrap(pos + disp * scale * mobile, image,
                                snapshot.box_L)
    return snapshot.replace(position=pos, image=image)
