"""Counter-based RNG discipline.

The port's counterpart of ``surgical_tpu/core/rng.py``. The reference keeps
augmentation in step across a clip by reseeding Python's global RNG with a
shared counter (data_process.py:77,92,106-108). Here every random draw comes
from an explicit ``torch.Generator`` whose seed is derived from integer
coordinates (seed, epoch, step, ...) and a purpose name, so the same
coordinates give the same draws on any worker, and different coordinates
give independent ones. Nothing reads or advances a global RNG.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def derive_seed(seed: int, *coords: int, purpose: str | None = None) -> int:
    """A 63-bit seed derived from (seed, *coords, purpose)."""
    ent = [int(seed) & 0xFFFFFFFF] + [int(c) & 0xFFFFFFFF for c in coords]
    if purpose is not None:
        # crc32, not hash(): str hashing is salted per process
        ent.append(zlib.crc32(purpose.encode()) & 0x7FFFFFFF)
    state = np.random.SeedSequence(ent).generate_state(2, np.uint32)
    return (int(state[0]) << 31 | int(state[1]) >> 1) & 0x7FFFFFFFFFFFFFFF


def generator(seed: int, *coords: int, purpose: str | None = None,
              device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the coordinates, e.g.
    ``generator(42, epoch, step, purpose="augment")``."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, *coords, purpose=purpose))
    return g


def host_rng(seed: int, *coords: int) -> np.random.Generator:
    """A numpy Generator for host-side shuffles (epoch orders), derived from
    (seed, *coords) exactly as the JAX package's ``host_rng(jax.random.key(seed),
    *coords)`` derives it: the key's two 32-bit words, then the coordinates."""
    words = [(int(seed) >> 32) & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF]
    return np.random.default_rng(words + [int(c) & 0xFFFFFFFF for c in coords])
