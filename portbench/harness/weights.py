"""Seeded weights, made on the device in a few large calls.

Every floating-point entry of a state dict is one slice of a single
``torch.randn`` draw on the device, scaled and shifted by a rule of its key:
products and convolutions at the standard deviation of PyTorch's default
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), which the temporal models' own
initialisation uses (a wider draw lets the Mamba stack's dt * x * B
products overflow on some seeds), norm scales about 1, biases small,
the Mamba blocks' A_log, D and dt bias as that model's own initialisation
sets them. The same seed and tag give the same tensors on
every run; the program and the reference are handed the same ones.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one model (``tag``) of a run's ``seed``."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, zlib.crc32(tag.encode())]
    s = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(s[0]) << 31 | int(s[1]) >> 1) & 0x7FFFFFFFFFFFFFFF


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, tag))
    return g


def _rule(key: str, shape) -> tuple[float, float]:
    """(scale, offset) applied to the key's standard-normal draw."""
    last = key.rsplit(".", 1)[-1]
    if last in ("A_log", "running_var") or key.endswith("dt_proj.bias"):
        return 1.0, 0.0  # set from the draw below
    if len(shape) >= 2:
        return 1.0 / math.sqrt(3 * math.prod(shape[1:])), 0.0
    if last == "running_mean":
        return 0.1, 0.0
    if last in ("weight", "D"):
        return 0.1, 1.0  # norm scales; the Mamba skip
    return 0.02, 0.0  # biases


def draw_state(shapes: dict, seed: int, tag: str, device) -> dict:
    """{key: tensor} for ``shapes`` ({key: (shape, dtype)}): floating
    entries from one draw, integer ones (BatchNorm's counters) zero."""
    floats = [(k, tuple(s)) for k, (s, dt) in shapes.items() if dt.is_floating_point]
    sizes = [math.prod(s) for _, s in floats]
    flat = torch.randn(sum(sizes), generator=generator(seed, tag, device), device=device)
    rules = np.array([_rule(k, s) for k, s in floats], dtype=np.float32).reshape(-1, 2)
    counts = torch.tensor(sizes, device=device)
    scale = torch.repeat_interleave(torch.from_numpy(rules[:, 0]).to(device), counts)
    offset = torch.repeat_interleave(torch.from_numpy(rules[:, 1]).to(device), counts)
    flat = flat * scale + offset
    out, at = {}, 0
    for (k, s), n in zip(floats, sizes):
        t = flat[at:at + n].view(s)
        at += n
        last = k.rsplit(".", 1)[-1]
        if last == "A_log":  # S4D-real: A = -(1, 2, ..., N) per channel
            t = torch.log(torch.arange(1, s[-1] + 1, dtype=torch.float32, device=device)
                          ).expand(s).contiguous()
        elif last == "running_var":
            t = torch.exp(0.2 * t)
        elif k.endswith("dt_proj.bias"):  # softplus^-1 of log-uniform dt in [1e-3, 0.1]
            u = 0.5 * (1.0 + torch.erf(t / math.sqrt(2.0)))
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp_min(1e-4)
            t = dt + torch.log(-torch.expm1(-dt))
        out[k] = t
    for k, (s, dt) in shapes.items():
        if not dt.is_floating_point:
            out[k] = torch.zeros(s, dtype=dt, device=device)
    return {k: out[k] for k in shapes}


def build(constructor, args: tuple, seed: int, tag: str, device):
    """The program's module built on the meta device (no host-side init),
    given storage on ``device`` and the seeded state: (module, state dict).
    The state dict is the benchmark's, kept apart for the reference."""
    with torch.device("meta"):
        model = constructor(*args, device="meta")
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}
    sd = draw_state(shapes, seed, tag, device)
    model.to_empty(device=device)
    model.load_state_dict(sd)
    model.eval()
    return model, sd
