"""The port's device rule: entry points run on the GPU unless told otherwise.

``resolve_device(None)`` is ``torch.device("cuda")``; with no CUDA device it
raises instead of carrying on on the CPU. A caller who wants the CPU passes
``device="cpu"`` (the CPU tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA device, and
    raises ``RuntimeError`` when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "cavmd_tpu_torch runs on the GPU by default, and "
            "torch.cuda.is_available() is False: pass device='cpu' to run "
            "on the CPU")
    return torch.device("cuda")
