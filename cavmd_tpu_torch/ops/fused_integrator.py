"""Fused integrator tail: CUDA kernels K4/K5 and their plain twins.

Port of ``cavmd_tpu/ops/fused_integrator.py``. Two kernels bracket the
force pass (``csrc/fused_integrator.cu``):

- ``pre_force_apply`` (K4, replaces ``_pre_force_kernel``): the Bussi
  half-step on the molecules (group KE -> alpha with the 2009 A8 sign fix
  -> rescale, reservoir delta), the first velocity-Verlet kick, the drift
  and the periodic rewrap with image update;
- ``post_force_apply`` (K5, replaces ``_post_force_kernel``): the second
  kick, the exact-OU Langevin update of the single photon row, the two
  group kinetic energies and the Langevin reservoir delta.

The random draws stay outside the kernels, drawn by the step exactly as
the unfused path draws them. The kernels read every scalar that changes
during a run (dt, the Bussi ``c``, the draws, the OU coefficients) through
device pointers, so a step never reads a value back to the host.

Each wrapper runs its plain twin only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises. The source note in the ``.cu``
file says what bounds the kernels on the H100 and how the design answers
it.

Supported method pattern (as in the JAX package): exactly one ``bussi`` on
the molecular group, plus at most one ``langevin`` on the cavity group with
one static member index.
"""

from __future__ import annotations

import ctypes

import torch

from cavmd_tpu_torch.ops import _cuda

_V = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    **{f"cavmd_fused_pre_force_{s}": [_V] * 11 + [_D, _D, _I] + [_V] * 5
       + [_I, _V]
       for s in ("f32", "f64")},
    **{f"cavmd_fused_post_force_{s}": [_V] * 5 + [_I] + [_V] * 3 + [_I]
       + [_V] * 3
       for s in ("f32", "f64")},
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
PRE_FORCE_THREADS = 512  # csrc/fused_integrator.cu kPreThreads


class FusedIntegratorPlan:
    """The static half of the fused step (built once per ``make_step_fn``):
    which methods it runs, their indices and the photon row."""

    def __init__(self, ff, methods, n: int, dtype):
        if dtype not in _SUFFIX:
            raise ValueError("fused integrator is f32/f64-only")
        bussi = [m for m in methods if m.kind == "bussi"]
        langevin = [m for m in methods if m.kind == "langevin"]
        others = [m for m in methods
                  if m.kind not in ("bussi", "langevin", "nve")]
        if (len(bussi) != 1 or bussi[0].group != "molecular"
                or len(langevin) > 1 or others
                or (langevin and (langevin[0].group != "cavity"
                                  or not langevin[0].indices
                                  or len(langevin[0].indices) != 1))):
            raise ValueError(
                "fused integrator supports exactly (bussi molecular "
                "[+ langevin cavity on one photon])"
            )
        if bussi[0].dof is None or bussi[0].dof <= 0.0:
            raise ValueError("fused integrator needs bussi dof > 0")
        self.bussi = bussi[0]
        self.langevin = langevin[0] if langevin else None
        self.i_bussi = list(methods).index(self.bussi)
        self.i_langevin = (
            list(methods).index(self.langevin) if langevin else -1
        )
        self.photon = (int(self.langevin.indices[0])
                       if self.langevin is not None else -1)


def pre_force_apply_plain(plan, position, image, velocity, forces, mass,
                          mol_mask, box_L, dt, c, kT: float, r1, r_gamma):
    """Plain twin of K4. Returns (position', image', velocity',
    bussi_reservoir_delta)."""
    dof = float(plan.bussi.dof)
    w = torch.where(mol_mask, mass, torch.zeros_like(mass))
    K = 0.5 * torch.sum(w[:, None] * velocity * velocity)
    vfac = kT / (2.0 * K)
    term1 = vfac * (1.0 - c) * (r_gamma + r1 * r1)
    term2 = 2.0 * r1 * torch.sqrt(vfac * (1.0 - c) * c)
    alpha_mag = torch.sqrt(c + term1 + term2)
    K_bar = kT * dof / 2.0
    sign_term = r1 + torch.sqrt(c * dof * K / ((1.0 - c) * K_bar))
    alpha = torch.where(sign_term >= 0.0, alpha_mag, -alpha_mag)
    v1 = torch.where(mol_mask[:, None], alpha * velocity, velocity)
    v1 = v1 + (0.5 * dt) * forces / mass[:, None]
    pos1 = position + dt * v1
    L = box_L.to(position.dtype)
    shift = torch.floor((pos1 + 0.5 * L) / L)
    return (pos1 - shift * L, image + shift.to(torch.int32), v1,
            K * (1.0 - alpha * alpha))


def post_force_apply_plain(plan, velocity, forces, mass, mol_mask, dt, c_ou,
                           sig_ou, noise3):
    """Plain twin of K5. Returns (velocity', ke_mol, ke_cav,
    langevin_reservoir_delta)."""
    v = velocity + (0.5 * dt) * forces / mass[:, None]
    dres = torch.zeros((), dtype=v.dtype, device=v.device)
    if plan.photon >= 0:
        p = plan.photon
        m = mass[p]
        before = 0.5 * torch.sum(m * v[p] * v[p])
        row = c_ou * v[p] + sig_ou * noise3.reshape(3)
        v = v.clone()
        v[p] = row
        dres = before - 0.5 * torch.sum(m * row * row)
    w = mass[:, None] * v * v
    ke_mol = 0.5 * torch.sum(torch.where(mol_mask[:, None], w, 0.0))
    ke_cav = 0.5 * torch.sum(torch.where(mol_mask[:, None], 0.0, w))
    return v, ke_mol, ke_cav, dres


def _check(what, tensors, dtype, n):
    for name, (t, want, shape) in tensors.items():
        want = dtype if want is None else want
        shape = tuple(n if s == "n" else s for s in shape)
        if not t.is_cuda or t.dtype != want or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a contiguous CUDA {want} tensor of "
                f"shape {shape}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def _kernel_suffix(position, what):
    if position.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {position.device}")
    if position.dtype not in _SUFFIX:
        raise TypeError(f"{what}: no kernel for {position.dtype}")
    return _SUFFIX[position.dtype]


def pre_force_apply(plan, position, image, velocity, forces, mass, mol_mask,
                    box_L, dt, c, kT: float, r1, r_gamma):
    """Returns (position', image', velocity', bussi_reservoir_delta): K4 on
    CUDA, the plain twin on the CPU. ``dt``, ``c``, ``r1`` and ``r_gamma``
    are 0-d tensors on the particles' device; ``kT`` is a host number."""
    if position.device.type == "cpu":
        return pre_force_apply_plain(plan, position, image, velocity, forces,
                                     mass, mol_mask, box_L, dt, c, kT, r1,
                                     r_gamma)
    sfx = _kernel_suffix(position, "pre_force_apply")
    dtype, n = position.dtype, position.shape[0]
    _check("pre_force_apply", dict(
        position=(position, None, ("n", 3)), image=(image, torch.int32,
                                                   ("n", 3)),
        velocity=(velocity, None, ("n", 3)), forces=(forces, None, ("n", 3)),
        mass=(mass, None, ("n",)), mol_mask=(mol_mask, torch.bool, ("n",)),
        box_L=(box_L, None, (3,)), dt=(dt, None, ()), c=(c, None, ()),
        r1=(r1, None, ()), r_gamma=(r_gamma, None, ())), dtype, n)
    pos_out = torch.empty_like(position)
    img_out = torch.empty_like(image)
    vel_out = torch.empty_like(velocity)
    dres = torch.empty((), dtype=dtype, device=position.device)
    # one kinetic-energy partial per block of the grid, which is at most
    # one block per PRE_FORCE_THREADS particles
    n_partial = -(-n // PRE_FORCE_THREADS)
    partial = torch.empty(n_partial, dtype=dtype, device=position.device)
    p = _cuda.ptr
    lib = _cuda.load("fused_integrator", _SIGNATURES)
    rc = getattr(lib, f"cavmd_fused_pre_force_{sfx}")(
        p(velocity), p(position), p(image), p(forces), p(mass), p(mol_mask),
        p(box_L), p(dt), p(c), p(r1), p(r_gamma), float(kT),
        float(plan.bussi.dof), n, p(vel_out), p(pos_out), p(img_out),
        p(dres), p(partial), n_partial, _cuda.stream_ptr(position.device))
    _cuda.check(rc, "fused_pre_force")
    _cuda.count_launch("fused_pre_force")
    return pos_out, img_out, vel_out, dres


def post_force_apply(plan, velocity, forces, mass, mol_mask, dt, c_ou, sig_ou,
                     noise3):
    """Returns (velocity', ke_mol, ke_cav, langevin_reservoir_delta): K5 on
    CUDA, the plain twin on the CPU. ``dt``, ``c_ou``, ``sig_ou`` (0-d) and
    ``noise3`` (3 values) are tensors on the particles' device; with no
    Langevin method (``plan.photon < 0``) the last three are unused and may
    be None."""
    if velocity.device.type == "cpu":
        return post_force_apply_plain(plan, velocity, forces, mass, mol_mask,
                                      dt, c_ou, sig_ou, noise3)
    sfx = _kernel_suffix(velocity, "post_force_apply")
    dtype, n = velocity.dtype, velocity.shape[0]
    tensors = dict(
        velocity=(velocity, None, ("n", 3)), forces=(forces, None, ("n", 3)),
        mass=(mass, None, ("n",)), mol_mask=(mol_mask, torch.bool, ("n",)),
        dt=(dt, None, ()))
    ou = (None, None, None)  # the kernel reads them only for a photon row
    if plan.photon >= 0:
        noise3 = noise3.reshape(3)
        tensors.update(c_ou=(c_ou, None, ()), sig_ou=(sig_ou, None, ()),
                       noise3=(noise3, None, (3,)))
        ou = (_cuda.ptr(c_ou), _cuda.ptr(sig_ou), _cuda.ptr(noise3))
    _check("post_force_apply", tensors, dtype, n)
    vel_out = torch.empty_like(velocity)
    out = torch.empty(3, dtype=dtype, device=velocity.device)
    p = _cuda.ptr
    lib = _cuda.load("fused_integrator", _SIGNATURES)
    rc = getattr(lib, f"cavmd_fused_post_force_{sfx}")(
        p(velocity), p(forces), p(mass), p(mol_mask), p(dt), plan.photon,
        *ou, n, p(vel_out), p(out), _cuda.stream_ptr(velocity.device))
    _cuda.check(rc, "fused_post_force")
    _cuda.count_launch("fused_post_force")
    return vel_out, out[0], out[1], out[2]
