"""Orthorhombic periodic box: the ``Box`` container and
wrap/unwrap/minimum-image on tensors.

Port of ``cavmd_tpu/core/box.py``. Only orthorhombic boxes are supported
(the reference workflow never uses tilt factors). Positions and
displacements are (..., 3): a (3,) box broadcasts over (N, 3) and over a
replica batch (B, N, 3) alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cavmd_tpu_torch.core.device import resolve_device


class Box(NamedTuple):
    """Orthorhombic periodic box with edge lengths ``L = (Lx, Ly, Lz)``, a
    (3,) tensor."""

    L: torch.Tensor

    @property
    def volume(self):
        return torch.prod(self.L)

    @staticmethod
    def cubic(L, dtype=torch.float64, device=None):
        """A cube of edge ``L`` on ``device`` (None: the CUDA device)."""
        return Box.from_lengths(L, L, L, dtype=dtype, device=device)

    @staticmethod
    def from_lengths(Lx, Ly, Lz, dtype=torch.float64, device=None):
        """Edges ``(Lx, Ly, Lz)`` on ``device`` (None: the CUDA device)."""
        return Box(torch.tensor([Lx, Ly, Lz], dtype=dtype,
                                device=resolve_device(device)))


def unwrap_positions(positions, images, box_L):
    """``r_unwrapped = r + image * L`` for wrapped ``positions`` (..., 3)."""
    return positions + images.to(positions.dtype) * box_L.to(positions.dtype)


def wrap_positions(positions, box_L):
    """Wrap into the primary box centred at the origin.

    Returns ``(wrapped, image_flags)`` with ``image = floor((x + L/2) / L)``
    and ``wrapped = x - image * L``.
    """
    box_L = box_L.to(positions.dtype)
    image = torch.floor((positions + 0.5 * box_L) / box_L)
    return positions - image * box_L, image.to(torch.int32)


def rewrap(positions, images, box_L):
    """Re-wrap drifted positions, accumulating the overflow into the
    existing image flags."""
    wrapped, delta_img = wrap_positions(positions, box_L)
    return wrapped, images + delta_img


def minimum_image(dr, box_L):
    """Minimum-image convention on displacements ``dr``.

    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    box_L = box_L.to(dr.dtype)
    return dr - box_L * torch.round(dr / box_L)
