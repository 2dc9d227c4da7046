"""Explicit random generators: one ``torch.Generator`` per stream.

Port of the stream layout of ``cavmd_tpu/integrate/rng.py``: each
(seed, stream, instance) triple — instance is the method index — gets its
own generator on the state's device, seeded from a hash of the triple, so
streams are independent of each other and of the order in which they are
used. JAX's threefry bits cannot be reproduced in PyTorch; tests that need
identical noise inject the JAX draws (see ``integrator.make_step_fn``).
"""

from __future__ import annotations

import numpy as np
import torch

from cavmd_tpu_torch.core.device import resolve_device

# stream identifiers (same values as the JAX package)
STREAM_BUSSI = 1
STREAM_LANGEVIN = 2
STREAM_MTTK = 3
STREAM_THERMALIZE = 4
STREAM_BROWNIAN = 5


def stream_seed(seed: int, stream: int, instance: int = 0) -> int:
    """63-bit generator seed for (seed, stream, instance)."""
    state = np.random.SeedSequence([seed, stream, instance]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def make_generator(seed: int, stream: int, instance: int = 0,
                   device=None) -> torch.Generator:
    """A fresh generator on ``device`` (None: the CUDA device) for
    (seed, stream, instance)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(stream_seed(seed, stream, instance))
    return gen
