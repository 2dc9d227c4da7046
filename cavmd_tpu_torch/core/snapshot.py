"""Snapshot: structure-of-arrays scene description as a dataclass of tensors.

Port of ``cavmd_tpu/core/snapshot.py``: particles (position, image,
velocity, mass, charge, diameter, typeid, types), bonds (group, typeid,
types) and an orthorhombic box. Integer fields are int32, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cavmd_tpu_torch.core.box import Box, unwrap_positions
from cavmd_tpu_torch.core.device import resolve_device

# the type of the inert rows that ``parallel.pad_snapshot_to`` appends
GHOST_TYPE = "__ghost__"


def ghost_typeid_of(types) -> int:
    """The type id of the ghost rows in ``types`` (-1: none)."""
    return types.index(GHOST_TYPE) if GHOST_TYPE in types else -1


def real_rows(typeid, ghost_typeid: int) -> int:
    """The number of rows of ``typeid`` (a tensor or an array) that are
    not ghosts; the ghosts are a tail after every real row."""
    if ghost_typeid < 0:
        return len(typeid)
    return int((typeid != ghost_typeid).sum())


def _tensor(x, dtype, device=None):
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Structure-of-arrays particle + topology scene."""

    position: torch.Tensor  # (N, 3)
    image: torch.Tensor  # (N, 3) int32
    velocity: torch.Tensor  # (N, 3)
    mass: torch.Tensor  # (N,)
    charge: torch.Tensor  # (N,)
    diameter: torch.Tensor  # (N,)
    typeid: torch.Tensor  # (N,) int32
    bond_group: torch.Tensor  # (Nb, 2) int32
    bond_typeid: torch.Tensor  # (Nb,) int32
    box_L: torch.Tensor  # (3,)
    types: Tuple[str, ...] = ()
    bond_types: Tuple[str, ...] = ()

    @property
    def N(self) -> int:
        return self.position.shape[0]

    @property
    def n_bonds(self) -> int:
        return self.bond_group.shape[0]

    @property
    def device(self) -> torch.device:
        return self.position.device

    @property
    def box(self) -> Box:
        return Box(self.box_L)

    def type_index(self, name: str) -> int:
        """Integer typeid for a named particle type (HOOMD
        ``getTypeByName``)."""
        return self.types.index(name)

    def unwrapped_positions(self):
        """``position + image * box_L``, (N, 3)."""
        return unwrap_positions(self.position, self.image, self.box_L)

    def replace(self, **kwargs) -> "Snapshot":
        return dataclasses.replace(self, **kwargs)

    def strip_tail(self, n_real: int) -> "Snapshot":
        """The first ``n_real`` particles, without the trailing ghost rows
        that ``parallel.pad_snapshot_to`` appends after every real row (so
        bond indices stay valid), and without the ghost type."""
        if n_real >= self.N:
            return self
        return self.replace(
            position=self.position[:n_real], image=self.image[:n_real],
            velocity=self.velocity[:n_real], mass=self.mass[:n_real],
            charge=self.charge[:n_real], diameter=self.diameter[:n_real],
            typeid=self.typeid[:n_real],
            types=tuple(t for t in self.types if t != GHOST_TYPE))

    def _map(self, float_fn, int_fn) -> "Snapshot":
        fields = {}
        for f in dataclasses.fields(self):
            x = getattr(self, f.name)
            if isinstance(x, torch.Tensor):
                x = float_fn(x) if x.is_floating_point() else int_fn(x)
            fields[f.name] = x
        return Snapshot(**fields)

    def astype(self, dtype) -> "Snapshot":
        """Cast all floating-point fields to ``dtype`` (int fields untouched)."""
        return self._map(lambda x: x.to(dtype), lambda x: x)

    def to(self, device) -> "Snapshot":
        """Move every tensor field to ``device``."""
        return self._map(lambda x: x.to(device), lambda x: x.to(device))

    @staticmethod
    def create(
        position,
        box_L,
        *,
        velocity=None,
        image=None,
        mass=None,
        charge=None,
        diameter=None,
        typeid=None,
        types=("A",),
        bond_group=None,
        bond_typeid=None,
        bond_types=(),
        dtype=None,
        device=None,
    ) -> "Snapshot":
        """Build a snapshot from (possibly partial) NumPy arrays or tensors.

        ``device=None`` keeps a tensor ``position`` where it lies; NumPy data
        goes to the CUDA device (``core/device.py:resolve_device``)."""
        if dtype is None:
            dtype = (position.dtype if isinstance(position, torch.Tensor)
                     else torch.float64)
        if device is None and not isinstance(position, torch.Tensor):
            device = resolve_device()
        position = _tensor(position, dtype, device)
        device = position.device
        n = position.shape[0]

        def arr(x, default, shape, dt=dtype):
            if x is None:
                return torch.full(shape, default, dtype=dt, device=device)
            return _tensor(x, dt, device).reshape(shape)

        if bond_group is None:
            bond_group = torch.zeros((0, 2), dtype=torch.int32, device=device)
        else:
            bond_group = _tensor(bond_group, torch.int32, device).reshape(-1, 2)
        nb = bond_group.shape[0]
        return Snapshot(
            position=position,
            image=arr(image, 0, (n, 3), torch.int32),
            velocity=arr(velocity, 0.0, (n, 3)),
            mass=arr(mass, 1.0, (n,)),
            charge=arr(charge, 0.0, (n,)),
            diameter=arr(diameter, 1.0, (n,)),
            typeid=arr(typeid, 0, (n,), torch.int32),
            bond_group=bond_group,
            bond_typeid=arr(bond_typeid, 0, (nb,), torch.int32),
            box_L=_tensor(box_L, dtype, device),
            types=tuple(types),
            bond_types=tuple(bond_types),
        )


def add_cavity_particle(
    snapshot: Snapshot,
    *,
    coupling: float,
    freq_cm1: float,
    temperature_K: float,
    finite_q: bool = False,
    phmass: float = 1.0,
    seed: int = 0,
) -> Snapshot:
    """Inject the photon pseudo-particle (type ``'L'``) into a molecular scene.

    Same host-side NumPy draws as ``cavmd_tpu.core.add_cavity_particle``, so
    the photon's bits are identical: it starts at the origin (or at the
    displaced equilibrium ``-g d / omega_c^2`` with z zeroed, ``finite_q``),
    with thermal noise of width ``sqrt(kT / omega_c^2)`` when the coupling is
    non-zero. Charge 0, mass ``phmass``, diameter 1, typeid = index of 'L'.
    """
    from cavmd_tpu_torch.core.units import PhysicalConstants

    rng = np.random.default_rng(seed)
    box_L = snapshot.box_L.detach().cpu().numpy()
    pos = snapshot.position.detach().cpu().numpy()
    img = snapshot.image.detach().cpu().numpy()
    charge = snapshot.charge.detach().cpu().numpy()

    unwrapped = pos + img * box_L[None, :]
    dipmom = np.einsum("i,ij->j", charge, unwrapped)

    omegac = PhysicalConstants.omega_from_cm1(freq_cm1)
    kT = PhysicalConstants.kT_from_kelvin(temperature_K)

    if finite_q:
        newpos = -dipmom * coupling / omegac**2
        newpos[-1] = 0.0
    else:
        newpos = np.zeros(3)
    if coupling != 0.0:
        sigma = np.sqrt(kT / omegac**2)
        newpos = rng.normal(loc=newpos, scale=sigma, size=3)

    image_flags = np.floor((newpos + box_L / 2) / box_L)
    newpos = newpos - image_flags * box_L

    types = snapshot.types if "L" in snapshot.types else snapshot.types + ("L",)
    l_typeid = types.index("L")
    dtype = snapshot.position.dtype
    dev = snapshot.device

    def row(values, dt):
        return torch.as_tensor(np.asarray(values), dtype=dt, device=dev)

    return snapshot.replace(
        position=torch.cat([snapshot.position, row([newpos], dtype)]),
        image=torch.cat([snapshot.image, row([image_flags], torch.int32)]),
        velocity=torch.cat([snapshot.velocity, row(np.zeros((1, 3)), dtype)]),
        mass=torch.cat([snapshot.mass, row([phmass], dtype)]),
        charge=torch.cat([snapshot.charge, row([0.0], dtype)]),
        diameter=torch.cat([snapshot.diameter, row([1.0], dtype)]),
        typeid=torch.cat([snapshot.typeid, row([l_typeid], torch.int32)]),
        types=types,
    )
